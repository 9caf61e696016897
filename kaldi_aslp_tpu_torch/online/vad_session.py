"""VAD-segmented decode session.

Port of kaldi_aslp_tpu/online/vad_session.py (reference:
src/aslp-online/decode-thread.cc:162-254 NnetVadDecodeThread - the VAD
gates features, speech segments stream into the decoder, and a
speech->silence boundary finalizes the utterance and resets the decoder
for the next one)."""

from __future__ import annotations

from typing import Callable, List

import numpy as np

from kaldi_aslp_tpu_torch.decoder.online import OnlineViterbiDecoder
from kaldi_aslp_tpu_torch.online.vad_pipeline import OnlineVadFeaturePipeline


class VadDecodeSession:
    """accept_samples(pcm) -> list of result events; silence segments
    never reach the decoder."""

    def __init__(
        self,
        vad_pipeline: OnlineVadFeaturePipeline,
        decoder: OnlineViterbiDecoder,
        acoustic_fn: Callable[[np.ndarray], np.ndarray],
        word_syms,
        chunk_frames: int = 16,
    ):
        self.vad = vad_pipeline
        self.decoder = decoder
        self.acoustic_fn = acoustic_fn
        self.word_syms = word_syms
        self.chunk_frames = chunk_frames
        self._pending = np.zeros((0, vad_pipeline.dim), np.float32)
        self.finals: List[str] = []

    def _text(self, words) -> str:
        return " ".join(self.word_syms.sym(w) for w in words)

    def accept_samples(self, samples: np.ndarray) -> List[dict]:
        events: List[dict] = []
        speech, boundary = self.vad.accept_waveform(samples)
        if len(speech):
            self._pending = np.concatenate([self._pending, speech])
        while len(self._pending) >= self.chunk_frames:
            chunk = self._pending[:self.chunk_frames]
            self._pending = self._pending[self.chunk_frames:]
            self.decoder.advance_decoding(self.acoustic_fn(chunk))
            events.append({
                "type": "partial",
                "text": self._text(self.decoder.get_partial_path()),
            })
        if boundary and self.decoder.num_frames_decoded > 0:
            events.append(self.finalize())
        return events

    def finalize(self) -> dict:
        if len(self._pending):
            self.decoder.advance_decoding(self.acoustic_fn(self._pending))
            self._pending = np.zeros((0, self.vad.dim), np.float32)
        if self.decoder.num_frames_decoded == 0:
            return {"type": "final", "text": ""}
        words, _, _ = self.decoder.finalize_decoding()
        text = self._text(words)
        self.finals.append(text)
        self.decoder.reset()
        return {"type": "final", "text": text}
