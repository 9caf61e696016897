"""Online decoding TCP server.

Port of kaldi_aslp_tpu/online/server.py (``DecodeSession``,
``OnlineTcpServer``; reference: src/aslp-online/tcp-server.h:19,
decode-thread.cc:162, aslp-onlinebin/aslp-online-nnet-vad-server.cc).

asyncio serves the connections; each runs a session that streams int16
PCM in and newline-delimited JSON results out
(``{"type": "partial"|"final", "text": ...}``).  The network forward and
the Viterbi advance run per chunk of ``chunk_frames`` frames; a session
that has ``accept_samples_async`` / ``finalize_async`` (the
cross-session batched one, online/batching.py) is awaited instead.  VAD
sessions are online/vad_session.py."""

from __future__ import annotations

import asyncio
import dataclasses
import json
from typing import Callable, List, Optional

import numpy as np

from kaldi_aslp_tpu_torch.decoder.online import OnlineViterbiDecoder
from kaldi_aslp_tpu_torch.online.endpoint import (
    OnlineEndpointConfig,
    endpoint_detected,
)
from kaldi_aslp_tpu_torch.online.feature_pipeline import (
    OnlineFeaturePipeline,
)
from kaldi_aslp_tpu_torch.utils.config import Config
from kaldi_aslp_tpu_torch.utils.log import get_logger

logger = get_logger("online-server")


@dataclasses.dataclass
class OnlineServerOptions(Config):
    port: int = 5010


class DecodeSession:
    """One utterance-stream session (reference: decode-thread.cc:162)."""

    def __init__(
        self,
        feature_pipeline: OnlineFeaturePipeline,
        decoder: OnlineViterbiDecoder,
        acoustic_fn: Callable[[np.ndarray], np.ndarray],
        word_syms,
        endpoint_config: Optional[OnlineEndpointConfig] = None,
        sil_tids: Optional[np.ndarray] = None,
        chunk_frames: int = 32,
        punctuation=None,
    ):
        # optional CRF punctuation on final results (reference:
        # decode-thread.cc applies PunctuationProcessor before
        # WriteFinalReslut)
        self.punctuation = punctuation
        self.features = feature_pipeline
        self.decoder = decoder
        self.acoustic_fn = acoustic_fn
        self.word_syms = word_syms
        self.endpoint_config = endpoint_config or OnlineEndpointConfig()
        self.sil_tids = (np.asarray(sil_tids)
                         if sil_tids is not None else np.zeros(0))
        self.chunk_frames = chunk_frames
        self._pending = np.zeros((0, feature_pipeline.dim), np.float32)
        self.finals: List[str] = []

    def _words_to_text(self, words: List[int]) -> str:
        return " ".join(self.word_syms.sym(w) for w in words)

    def accept_samples(self, samples: np.ndarray) -> List[dict]:
        """Feed PCM; returns result events (partial/final dicts)."""
        events = []
        frames = self.features.accept_waveform(samples)
        if len(frames):
            self._pending = np.concatenate([self._pending, frames])
        while len(self._pending) >= self.chunk_frames:
            chunk = self._pending[:self.chunk_frames]
            self._pending = self._pending[self.chunk_frames:]
            self.decoder.advance_decoding(self.acoustic_fn(chunk))
            partial = self.decoder.get_partial_path()
            events.append({"type": "partial",
                           "text": self._words_to_text(partial)})
            trailing = self.decoder.trailing_silence_frames(self.sil_tids)
            if endpoint_detected(
                self.endpoint_config, self.decoder.num_frames_decoded,
                trailing,
                final_relative_cost=self.decoder.final_relative_cost(),
            ):
                events.append(self.finalize())
        return events

    def finalize(self) -> dict:
        """End of utterance: final result + decoder reset
        (reference: FinalizeDecoding + WriteFinalReslut + ResetDecoder)."""
        if len(self._pending):
            self.decoder.advance_decoding(self.acoustic_fn(self._pending))
            self._pending = np.zeros((0, self.features.dim), np.float32)
        return self.finalize_sync()

    def finalize_sync(self) -> dict:
        """The final result of what was decoded, then the resets; pending
        frames stay pending (the batched sessions' endpoint, as JAX's)."""
        if self.decoder.num_frames_decoded == 0:
            return {"type": "final", "text": ""}
        words, _, _ = self.decoder.finalize_decoding()
        text = self._words_to_text(words)
        if self.punctuation is not None:
            text = self.punctuation.process(text)
        self.finals.append(text)
        self.decoder.reset()
        self.features.reset()
        return {"type": "final", "text": text}


class OnlineTcpServer:
    """(reference: tcp-server.h + server main).  Protocol:
    client sends int16-LE PCM chunks; EOF finalizes.
    Server sends one JSON object per line."""

    def __init__(self, session_factory: Callable[[], DecodeSession],
                 opts: Optional[OnlineServerOptions] = None):
        self.opts = opts or OnlineServerOptions()
        self.session_factory = session_factory
        self._server: Optional[asyncio.AbstractServer] = None

    async def handle_client(self, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
        session = self.session_factory()
        try:
            while True:
                data = await reader.read(4096)
                if not data:
                    break
                samples = np.frombuffer(data, dtype="<i2").astype(
                    np.float32)
                if hasattr(session, "accept_samples_async"):
                    events = await session.accept_samples_async(samples)
                else:
                    events = session.accept_samples(samples)
                for event in events:
                    writer.write((json.dumps(event) + "\n").encode())
                    await writer.drain()
            if hasattr(session, "finalize_async"):
                final = await session.finalize_async()
            else:
                final = session.finalize()
            writer.write((json.dumps(final) + "\n").encode())
            await writer.drain()
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()

    async def start(self) -> int:
        self._server = await asyncio.start_server(
            self.handle_client, "127.0.0.1", self.opts.port)
        port = self._server.sockets[0].getsockname()[1]
        logger.info("online server listening on %d", port)
        return port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
