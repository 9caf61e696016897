"""Online serving CLI mains.

Port of kaldi_aslp_tpu/cli/online_tools.py (``online_nnet_vad_server``
without VAD, ``audio_provider_client``; reference:
src/aslp-onlinebin/aslp-online-nnet-vad-server.cc:33-130,
aslp-audio-provider-client.cc).  The socket protocol is the JAX
package's: int16-LE PCM in, one JSON object per line out
(online/server.py).

The server takes ``--device`` (default ``cuda``); on a machine without
CUDA, ``--device=cuda`` raises rather than running on the CPU.  The VAD
options (``--vad-nnet``, the energy-VAD server) are a later slice:
``--vad-nnet`` raises ``NotImplementedError``."""

from __future__ import annotations

import asyncio
import dataclasses
import json
import wave
from typing import Sequence, Tuple

import numpy as np

from kaldi_aslp_tpu_torch.utils.config import Config, parse_options
from kaldi_aslp_tpu_torch.utils.log import get_logger

logger = get_logger("online-cli")

SERVER_USAGE = ("aslp-online-nnet-vad-server [--device=cuda] nnet-model "
                "tid2pdf.txt HCLG.txt words.txt")


@dataclasses.dataclass
class ServerFlags(Config):
    port: int = 5010
    device: str = "cuda"
    feature_type: str = "fbank"
    num_mel_bins: int = 23
    chunk_frames: int = 16
    acoustic_scale: float = 1.0
    class_frame_counts: str = ""   # pdf prior counts file (optional)
    no_softmax: bool = False
    vad_nnet: str = ""             # VAD nnet model: not ported yet


class SessionFactory:
    """Loads the model, LUT, graph and words named by ``args`` onto
    ``flags.device``; each call makes a decode session
    (kaldi_aslp_tpu/cli/online_tools.py:_build_session_factory)."""

    def __init__(self, flags: ServerFlags, args: Sequence[str]):
        from kaldi_aslp_tpu_torch.fst.fst import Fst, SymbolTable
        from kaldi_aslp_tpu_torch.decoder.decodable import (
            NnetForwardOptions,
            PdfPrior,
        )
        from kaldi_aslp_tpu_torch.decoder.viterbi import PackedGraph
        from kaldi_aslp_tpu_torch.models import Nnet
        from kaldi_aslp_tpu_torch.online.feature_pipeline import (
            OnlineFeatureOptions,
        )
        from kaldi_aslp_tpu_torch.utils.device import resolve_device

        if flags.vad_nnet:
            raise NotImplementedError(
                "--vad-nnet is not ported yet; run without VAD")
        self.flags = flags
        self.device = resolve_device(flags.device)
        self.net, _ = Nnet.load(args[0], self.device)
        self.net.eval()
        self.lut = np.loadtxt(args[1], dtype=np.int64).reshape(-1)
        with open(args[2]) as f:
            self.graph = PackedGraph.from_fst(Fst.from_text(f.read()))
        with open(args[3]) as f:
            self.words = SymbolTable.from_text(f.read())
        self.prior = None
        if flags.class_frame_counts:
            self.prior = PdfPrior(
                np.loadtxt(flags.class_frame_counts).reshape(-1))
        self.forward_opts = NnetForwardOptions(no_softmax=flags.no_softmax)
        self.feat_opts = OnlineFeatureOptions(
            feature_type=flags.feature_type,
            num_mel_bins=flags.num_mel_bins)

    def acoustic_fn(self, frames: np.ndarray) -> np.ndarray:
        from kaldi_aslp_tpu_torch.decoder.decodable import nnet_forward

        return self.flags.acoustic_scale * nnet_forward(
            self.net, np.asarray(frames, np.float32), self.forward_opts,
            prior=self.prior)

    def __call__(self):
        from kaldi_aslp_tpu_torch.decoder.online import OnlineViterbiDecoder
        from kaldi_aslp_tpu_torch.online.feature_pipeline import (
            OnlineFeaturePipeline,
        )
        from kaldi_aslp_tpu_torch.online.server import DecodeSession

        # no VAD: endpoint-rule session
        return DecodeSession(
            OnlineFeaturePipeline(self.feat_opts, device=self.device),
            OnlineViterbiDecoder(self.graph, self.lut, acoustic_scale=1.0,
                                 device=self.device),
            self.acoustic_fn, self.words,
            chunk_frames=self.flags.chunk_frames)


def session_factory_from_argv(argv: Sequence[str]) -> SessionFactory:
    """Parse the server's command line into a :class:`SessionFactory`."""
    flags = ServerFlags()
    args = parse_options(argv, [flags], SERVER_USAGE, 4, 4)
    return SessionFactory(flags, args)


def _serve(flags: ServerFlags, make_session: SessionFactory) -> int:
    from kaldi_aslp_tpu_torch.online.server import (
        OnlineServerOptions,
        OnlineTcpServer,
    )

    async def run():
        server = OnlineTcpServer(
            make_session,
            OnlineServerOptions(port=flags.port))
        port = await server.start()
        print(f"listening on port {port}", flush=True)
        try:
            await asyncio.Event().wait()
        finally:
            await server.stop()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    return 0


def online_nnet_vad_server(argv):
    """NN-decode server (reference:
    aslp-onlinebin/aslp-online-nnet-vad-server.cc), without VAD."""
    make_session = session_factory_from_argv(argv)
    return _serve(make_session.flags, make_session)


def read_pcm16_wave(path: str) -> Tuple[np.ndarray, int]:
    """(int16 samples of the first channel, sample rate) of a 16-bit PCM
    wav file."""
    with wave.open(path, "rb") as w:
        if w.getsampwidth() != 2:
            raise ValueError(f"{path}: only 16-bit PCM wav is supported")
        data = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        return (data.reshape(-1, w.getnchannels())[:, 0].copy(),
                w.getframerate())


def audio_provider_client(argv):
    """Stream a wav file to the online server and print result events
    (reference: aslp-onlinebin/aslp-audio-provider-client.cc — sends
    PCM chunks, prints partial/final results until EOS)."""
    @dataclasses.dataclass
    class Flags(Config):
        host: str = "127.0.0.1"
        port: int = 5010
        chunk_ms: int = 250
        realtime: bool = False   # sleep chunk_ms between sends

    flags = Flags()
    args = parse_options(
        argv, [flags], "aslp-audio-provider-client wav-file", 1, 1)
    samples, rate = read_pcm16_wave(args[0])
    pcm = samples.astype("<i2").tobytes()
    chunk_bytes = 2 * int(rate * flags.chunk_ms / 1000.0)

    async def run():
        reader, writer = await asyncio.open_connection(flags.host,
                                                       flags.port)

        async def pump():
            for i in range(0, len(pcm), chunk_bytes):
                writer.write(pcm[i:i + chunk_bytes])
                await writer.drain()
                if flags.realtime:
                    await asyncio.sleep(flags.chunk_ms / 1000.0)
            writer.write_eof()

        async def results():
            while True:
                line = await reader.readline()
                if not line:
                    break
                event = json.loads(line)
                print(f"{event['type']}: {event.get('text', '')}",
                      flush=True)

        await asyncio.gather(pump(), results())
        writer.close()

    asyncio.run(run())
    return 0
