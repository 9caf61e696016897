"""VAD boundary accuracy.

Port of kaldi_aslp_tpu/vad/boundary.py (reference:
src/aslp-vad/boundary-tool.h BoundaryTool, driven by
aslp-vadbin/aslp-eval-vad-boundary.cc and aslp-eval-nn-vad-boundary.cc).
Scores how precisely a VAD hypothesis places the start and end of the
one speech segment of each utterance: frames in an asymmetric window
around each true boundary are compared, weighted 1 outside a
[-context, 0) dead zone, where the reference tolerates early triggering
for free.  Host numpy on 0/1 masks."""

from __future__ import annotations

import numpy as np


class BoundaryTool:
    """Accumulates per-utterance start/end boundary accuracies.

    ``label`` is the true 0/1 silence/speech mask; ``hyp`` the VAD
    decision.  Utterances must run sil -> speech -> sil (one segment);
    others are rejected, as in the reference."""

    def __init__(self, context: int = 10):
        if context <= 0:
            raise ValueError("context must be positive")
        self.context = int(context)
        self.num_sentence = 0
        self.start_acc = 0.0
        self.end_acc = 0.0

    def _weight(self, i: int) -> float:
        # mirror of BoundaryTool::Weight (boundary-tool.h:22-30)
        c = self.context
        if 0 <= i < c:
            return 1.0
        if -c <= i < 0:
            return 0.0
        if -2 * c <= i < -c:
            return 1.0
        raise ValueError(f"invalid boundary-relative index {i}")

    def add_data(self, label: np.ndarray, hyp: np.ndarray) -> bool:
        label = np.asarray(label).astype(np.int32)
        hyp = np.asarray(hyp).astype(np.int32)
        if len(label) != len(hyp):
            raise ValueError("label/hyp length mismatch")
        n = len(label)
        if n == 0 or not (label > 0).any():
            return False
        start = int(np.argmax(label > 0))
        end = n - 1 - int(np.argmax(label[::-1] > 0))
        if start == 0 or end == n - 1 or start >= end:
            return False  # must start and end with silence
        c = self.context
        # start boundary window [start-2c, start+c)
        sb_begin = max(start - 2 * c, 0)
        sb_end = min(start + c, end)
        corr = tot = 0.0
        for i in range(sb_begin, sb_end):
            w = self._weight(i - start)
            if label[i] == hyp[i]:
                corr += w
            tot += w
        self.start_acc += corr / tot if tot > 0 else 0.0
        # end boundary window [end-c, end+2c)
        eb_begin = max(end - c, start)
        eb_end = min(end + 2 * c, n)
        corr = tot = 0.0
        for i in range(eb_begin, eb_end):
            w = self._weight(end - i - 1)
            if label[i] == hyp[i]:
                corr += w
            tot += w
        self.end_acc += corr / tot if tot > 0 else 0.0
        self.num_sentence += 1
        return True

    def report(self) -> str:
        n = max(self.num_sentence, 1)
        return (f"sentences {self.num_sentence} "
                f"start_boundary_acc {self.start_acc / n:.4f} "
                f"end_boundary_acc {self.end_acc / n:.4f}")
