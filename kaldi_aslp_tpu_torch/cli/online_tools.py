"""Online serving CLI mains.

Port of kaldi_aslp_tpu/cli/online_tools.py (``online_nnet_vad_server``,
``online_energy_vad_server``, ``audio_provider_client``; reference:
src/aslp-onlinebin/aslp-online-nnet-vad-server.cc:33-130,
aslp-online-energy-vad-server.cc, aslp-audio-provider-client.cc).  The
socket protocol is the JAX package's: int16-LE PCM in, one JSON object
per line out (online/server.py).

The servers take ``--device`` (default ``cuda``); on a machine without
CUDA, ``--device=cuda`` raises rather than running on the CPU.  The VAD
net of ``--vad-nnet`` loads onto the same device and gates the session
by its silence posteriors (online/vad_pipeline.py); where the JAX server
loads that net and never runs it, the port runs it, and a net that
fails to load or to run fails the session.  As in the JAX package, the
CLI serves each session on its own; cross-session batching
(online/batching.py) is the library's, through
:meth:`SessionFactory.batched_session`."""

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

SERVER_USAGE = ("aslp-online-nnet-vad-server [--device=cuda] "
                "[--vad-nnet=m] nnet-model tid2pdf.txt HCLG.txt words.txt")
ENERGY_SERVER_USAGE = ("aslp-online-energy-vad-server [--device=cuda] "
                       "nnet-model tid2pdf.txt HCLG.txt words.txt")


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
    vad_nnet: str = ""             # VAD nnet model (nnet server)
    sil_threshold: float = 0.5     # the VAD net's silence posterior limit
    energy_threshold: float = 9.0  # the energy gate's margin (energy server)


class SessionFactory:
    """Loads the model, LUT, graph and words named by ``args`` (and the
    VAD net of ``--vad-nnet``) onto ``flags.device``; each call makes a
    decode session (kaldi_aslp_tpu/cli/online_tools.py:
    _build_session_factory): energy-gated with ``use_energy_vad``,
    NN-gated with a VAD net, else endpoint-ruled."""

    def __init__(self, flags: ServerFlags, args: Sequence[str],
                 use_energy_vad: bool = False):
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

        if use_energy_vad and flags.vad_nnet:
            raise ValueError(
                "--vad-nnet gates aslp-online-nnet-vad-server; "
                "aslp-online-energy-vad-server gates on energy")
        self.flags = flags
        self.use_energy_vad = use_energy_vad
        self.device = resolve_device(flags.device)
        self.net, _ = Nnet.load(args[0], self.device)
        self.net.eval()
        self.vad_net = None
        if flags.vad_nnet:
            self.vad_net, _ = Nnet.load(flags.vad_nnet, self.device)
            self.vad_net.eval()
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

    def batched_acoustic_fn(self, feats: np.ndarray,
                            mask: np.ndarray) -> np.ndarray:
        """[B, T, D] frames, [B, T] mask -> [B, T, P] scores: one forward
        of the model for the batch (an ``AcousticBatcher``'s forward)."""
        from kaldi_aslp_tpu_torch.decoder.decodable import (
            nnet_forward_batched,
        )

        return self.flags.acoustic_scale * nnet_forward_batched(
            self.net, feats, mask, self.forward_opts, prior=self.prior)

    def decoder(self):
        from kaldi_aslp_tpu_torch.decoder.online import OnlineViterbiDecoder

        return OnlineViterbiDecoder(self.graph, self.lut, acoustic_scale=1.0,
                                    device=self.device)

    def __call__(self):
        from kaldi_aslp_tpu_torch.online.feature_pipeline import (
            OnlineFeaturePipeline,
        )
        from kaldi_aslp_tpu_torch.online.server import DecodeSession
        from kaldi_aslp_tpu_torch.online.vad_pipeline import (
            OnlineVadFeaturePipeline,
        )
        from kaldi_aslp_tpu_torch.online.vad_session import VadDecodeSession
        from kaldi_aslp_tpu_torch.vad import EnergyVad, NnetVad, VadOptions

        flags = self.flags
        if self.use_energy_vad:
            vad = EnergyVad(VadOptions(
                energy_threshold=flags.energy_threshold), device=self.device)
        elif self.vad_net is not None:
            vad = NnetVad(VadOptions(
                sil_posterior_threshold=flags.sil_threshold),
                net=self.vad_net)
        else:
            # no VAD: endpoint-rule session
            return DecodeSession(
                OnlineFeaturePipeline(self.feat_opts, device=self.device),
                self.decoder(), self.acoustic_fn, self.words,
                chunk_frames=flags.chunk_frames)
        return VadDecodeSession(
            OnlineVadFeaturePipeline(self.feat_opts, vad=vad,
                                     device=self.device),
            self.decoder(), self.acoustic_fn, self.words,
            chunk_frames=flags.chunk_frames)

    def batched_session(self, batcher, punctuation=None):
        """An endpoint-rule session whose chunks go through ``batcher``
        (an ``AcousticBatcher``, typically over
        :meth:`batched_acoustic_fn`), shared with the other sessions."""
        from kaldi_aslp_tpu_torch.online.batching import BatchedDecodeSession
        from kaldi_aslp_tpu_torch.online.feature_pipeline import (
            OnlineFeaturePipeline,
        )

        return BatchedDecodeSession(
            OnlineFeaturePipeline(self.feat_opts, device=self.device),
            self.decoder(), batcher.compute, self.words,
            chunk_frames=self.flags.chunk_frames, punctuation=punctuation)


def session_factory_from_argv(argv: Sequence[str],
                              use_energy_vad: bool = False
                              ) -> SessionFactory:
    """Parse a server's command line into a :class:`SessionFactory`: the
    NN server's, or with ``use_energy_vad`` the energy-VAD server's."""
    flags = ServerFlags()
    usage = ENERGY_SERVER_USAGE if use_energy_vad else SERVER_USAGE
    args = parse_options(argv, [flags], usage, 4, 4)
    return SessionFactory(flags, args, use_energy_vad)


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
    """NN-decode server with (optional) NN VAD gating (reference:
    aslp-onlinebin/aslp-online-nnet-vad-server.cc)."""
    make_session = session_factory_from_argv(argv)
    return _serve(make_session.flags, make_session)


def online_energy_vad_server(argv):
    """NN-decode server with energy-VAD gating (reference:
    aslp-onlinebin/aslp-online-energy-vad-server.cc)."""
    make_session = session_factory_from_argv(argv, use_energy_vad=True)
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
