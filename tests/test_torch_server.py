"""The port's online decode server end to end on the CPU
(kaldi_aslp_tpu_torch/cli/online_tools.py, online/server.py) against the
JAX package's: the same model zip, LUT, TLG and words files feed both
session factories, the same PCM streams through a loopback
``OnlineTcpServer`` of each, and the events and per-chunk acoustic
scores are compared (scores atol=1e-4).  A subprocess with ``jax``
blocked shows the port runs where JAX is absent."""

import asyncio
import json
import os
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

import jax

from kaldi_aslp_tpu.cli.online_tools import (
    ServerFlags as JaxServerFlags,
    _build_session_factory as jax_build_session_factory,
)
from kaldi_aslp_tpu.fst import Lang, Lexicon, make_unigram_grammar
from kaldi_aslp_tpu.fst.ctc_graph import ctc_lut, make_ctc_decode_graph
from kaldi_aslp_tpu.models import Nnet as JaxNnet
from kaldi_aslp_tpu.models.recurrent import (
    BLstmProjectedStreams as JaxBLstm,
)
from kaldi_aslp_tpu.models.simple import AffineTransform as JaxAffine
from kaldi_aslp_tpu.online.server import (
    OnlineServerOptions as JaxServerOptions,
    OnlineTcpServer as JaxTcpServer,
)
from kaldi_aslp_tpu_torch.cli.__main__ import main as cli_main
from kaldi_aslp_tpu_torch.cli.online_tools import (
    audio_provider_client,
    session_factory_from_argv,
)
from kaldi_aslp_tpu_torch.online.server import (
    OnlineServerOptions,
    OnlineTcpServer,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BINS = 23


def _write_files(tmp_path):
    """Model zip (written by the JAX package; output width = the CTC
    inventory of the test lexicon), LUT, TLG and words, as text files."""
    lang = Lang.build(Lexicon.from_text("YES Y\nNO N\n<SIL> SIL\n"))
    tlg = make_ctc_decode_graph(
        lang, make_unigram_grammar({"YES": 0.5, "NO": 0.5}, lang.words))
    V = len(lang.phones)
    net = JaxNnet()
    net.add(JaxBLstm(BINS, 16, cell_dim=12))
    net.add(JaxBLstm(16, 16, cell_dim=12))
    net.add(JaxAffine(16, V, param_stddev=0.5, bias_mean=0.0,
                      bias_range=0.0))
    paths = [str(tmp_path / n) for n in
             ("model.zip", "tid2pdf.txt", "TLG.txt", "words.txt")]
    net.save(paths[0], net.init(jax.random.PRNGKey(0)))
    np.savetxt(paths[1], ctc_lut(V), fmt="%d")
    with open(paths[2], "w") as f:
        f.write(tlg.to_text())
    with open(paths[3], "w") as f:
        f.write(lang.words.to_text())
    return paths


def _pcm(seed=0):
    """Quiet, a loud 300 Hz tone, quiet: int16-LE bytes."""
    rs = np.random.RandomState(seed)
    sr = 16000
    quiet = 10 * rs.randn(sr // 2)
    loud = 5000 * np.sin(2 * np.pi * 300 * np.arange(sr) / sr)
    wave_ = np.concatenate([quiet, loud, quiet])
    return np.clip(wave_, -32768, 32767).astype("<i2").tobytes()


async def _stream(server, pcm, chunk_bytes=8000):
    port = await server.start()
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        for i in range(0, len(pcm), chunk_bytes):
            writer.write(pcm[i:i + chunk_bytes])
            await writer.drain()
        writer.write_eof()
        events = []
        while True:
            line = await reader.readline()
            if not line:
                break
            events.append(json.loads(line))
        writer.close()
        return events
    finally:
        await server.stop()


def _recording(make_session, log):
    """Wrap each session's acoustic_fn to keep the per-chunk scores."""
    def make():
        session = make_session()
        inner = session.acoustic_fn

        def acoustic_fn(frames):
            out = inner(frames)
            log.append(np.array(out))
            return out
        session.acoustic_fn = acoustic_fn
        return session
    return make


def test_port_server_matches_jax_server(tmp_path):
    paths = _write_files(tmp_path)
    pcm = _pcm()
    jax_scores, port_scores = [], []
    jax_factory = jax_build_session_factory(
        JaxServerFlags(num_mel_bins=BINS, chunk_frames=16), paths,
        use_energy_vad=False)
    want = asyncio.run(_stream(JaxTcpServer(
        _recording(jax_factory, jax_scores), JaxServerOptions(port=0)), pcm))
    port_factory = session_factory_from_argv(
        ["--device=cpu", f"--num-mel-bins={BINS}", "--chunk-frames=16",
         *paths])
    got = asyncio.run(_stream(OnlineTcpServer(
        _recording(port_factory, port_scores), OnlineServerOptions(port=0)),
        pcm))
    assert [e["type"] for e in got] == [e["type"] for e in want]
    assert [e["text"] for e in got] == [e["text"] for e in want]
    assert got[-1]["type"] == "final" and got[0]["type"] == "partial"
    assert len(port_scores) == len(jax_scores) > 5
    for g, w in zip(port_scores, jax_scores):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


_NO_JAX_SCRIPT = r"""
import asyncio, importlib, importlib.abc, json, pkgutil, sys


class BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name} is blocked in this process")
        return None


sys.meta_path.insert(0, BlockJax())
import kaldi_aslp_tpu_torch
for mod in pkgutil.walk_packages(kaldi_aslp_tpu_torch.__path__,
                                 "kaldi_aslp_tpu_torch."):
    importlib.import_module(mod.name)
from kaldi_aslp_tpu_torch.cli.online_tools import session_factory_from_argv
from kaldi_aslp_tpu_torch.online.server import (
    OnlineServerOptions, OnlineTcpServer)

make_session = session_factory_from_argv(
    ["--device=cpu", "--num-mel-bins=23"] + sys.argv[2:])
pcm = open(sys.argv[1], "rb").read()


async def run():
    server = OnlineTcpServer(make_session, OnlineServerOptions(port=0))
    port = await server.start()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(pcm)
    await writer.drain()
    writer.write_eof()
    events = [json.loads(line) async for line in reader]
    writer.close()
    await server.stop()
    return events


events = asyncio.run(run())
# the serving modules ported with the VAD servers and batching: loaded,
# and the energy-VAD factory's session driven on the same PCM
import numpy as np
NEW = ["kaldi_aslp_tpu_torch." + m for m in (
    "vad.vad", "online.vad_pipeline", "online.vad_session",
    "online.punctuation", "online.batching", "ops.crf", "decoder.batched",
    "entry")]
missing = [m for m in NEW if m not in sys.modules]
energy = session_factory_from_argv(
    ["--device=cpu", "--num-mel-bins=23"] + sys.argv[2:],
    use_energy_vad=True)()
samples = np.frombuffer(pcm, "<i2").astype(np.float32)
energy_events = energy.accept_samples(samples) + [energy.finalize()]
shared = sorted({m.split(".")[1] for m in sys.modules
                 if m.startswith("kaldi_aslp_tpu.")})
print(json.dumps({"events": events, "jax": "jax" in sys.modules,
                  "shared": shared, "missing": missing,
                  "energy_events": energy_events}))
"""


def test_port_serves_with_jax_blocked(tmp_path):
    paths = _write_files(tmp_path)
    pcm_path = tmp_path / "pcm.raw"
    pcm_path.write_bytes(_pcm(1))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_SCRIPT, str(pcm_path), *paths],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["jax"] is False
    assert out["shared"] == []
    assert out["missing"] == []
    types = [e["type"] for e in out["events"]]
    assert "partial" in types and types[-1] == "final"
    assert out["energy_events"][-1]["type"] == "final"


def test_cli_vad_nnet_is_not_silently_ignored(tmp_path):
    """--vad-nnet builds an NN-gated session whose VAD net runs on the
    session's audio (the JAX server loads it and never runs it)."""
    from kaldi_aslp_tpu_torch.models import (
        AffineTransform,
        Nnet,
        Sigmoid,
        Softmax,
    )
    from kaldi_aslp_tpu_torch.online import VadDecodeSession
    from kaldi_aslp_tpu_torch.vad import NnetVad

    paths = _write_files(tmp_path)
    vad = Nnet()
    for comp in (AffineTransform(BINS, 32), Sigmoid(32, 32),
                 AffineTransform(32, 2), Softmax(2, 2)):
        vad.add(comp)
    vad.reset_parameters(torch.Generator().manual_seed(0))
    vad_zip = str(tmp_path / "vad.zip")
    vad.save(vad_zip)
    factory = session_factory_from_argv(
        ["--device=cpu", f"--num-mel-bins={BINS}", f"--vad-nnet={vad_zip}",
         "--sil-threshold=0.3", *paths])
    session = factory()
    assert isinstance(session, VadDecodeSession)
    gate = session.vad.vad
    assert isinstance(gate, NnetVad) and gate.net is factory.vad_net
    assert gate.opts.sil_posterior_threshold == 0.3
    samples = np.frombuffer(_pcm(), "<i2").astype(np.float32)
    for i in range(0, len(samples), 4000):
        session.accept_samples(samples[i:i + 4000])
    session.finalize()
    assert gate.num_forwards == len(range(0, len(samples), 4000))
    with pytest.raises(FileNotFoundError):
        session_factory_from_argv(
            ["--device=cpu", "--vad-nnet=no-such-vad.zip", *paths])


def test_cli_cuda_device_never_drops_to_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the check is for one without")
    paths = _write_files(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        session_factory_from_argv(paths)   # --device defaults to cuda


def test_cli_dispatcher(capsys):
    assert cli_main(["--help"]) == 1
    err = capsys.readouterr().err
    assert "aslp-online-nnet-vad-server" in err
    assert "aslp-online-energy-vad-server" in err
    assert cli_main(["no-such-tool"]) == 1


def test_audio_provider_client_against_port_server(tmp_path, capsys):
    paths = _write_files(tmp_path)
    wav_path = str(tmp_path / "utt.wav")
    with wave.open(wav_path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(_pcm(2))
    make_session = session_factory_from_argv(
        ["--device=cpu", f"--num-mel-bins={BINS}", *paths])

    async def run():
        server = OnlineTcpServer(make_session, OnlineServerOptions(port=0))
        port = await server.start()
        try:
            return await asyncio.get_running_loop().run_in_executor(
                None, audio_provider_client,
                [f"--port={port}", "--chunk-ms=100", wav_path])
        finally:
            await server.stop()

    assert asyncio.run(run()) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("partial:")
    assert lines[-1].startswith("final:")
