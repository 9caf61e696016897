"""Alignment conversion between systems.

A copy of kaldi_aslp_tpu/hmm/convert_ali.py (numpy; the port imports
nothing of the JAX package).  Reference:
src/aslp-bin/aslp-convert-ali.cc / bin/convert-ali.cc — re-express a
transition-id alignment from one (topology, tree) system in another's
transition ids without re-running Viterbi.

Works at the phone-segmentation level: the old alignment's phone
segments are kept, each segment's frames are re-emitted through the new
model's topology states (proportional occupancy, self-loops + forward
arcs), with pdfs from the new tree when context-dependent."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from kaldi_aslp_tpu_torch.hmm.transition_model import TransitionModel


def phone_segments(tm: TransitionModel, ali: np.ndarray
                   ) -> List[Tuple[int, int, int]]:
    """[(phone, start, length)] from a tid alignment."""
    segs = []
    prev_phone = None
    start = 0
    for i, tid in enumerate(np.asarray(ali)):
        ph = tm.tid_to_phone(int(tid))
        new_seg = (ph != prev_phone
                   or (tm.states[tm.tid_to_state(int(tid))].hmm_state == 0
                       and not tm.is_self_loop(int(tid))
                       and i > start))
        if prev_phone is None:
            prev_phone, start = ph, i
        elif ph != prev_phone:
            segs.append((prev_phone, start, i - start))
            prev_phone, start = ph, i
    if prev_phone is not None:
        segs.append((prev_phone, start, len(ali) - start))
    return segs


def _emit_phone(tm: TransitionModel, phone: int, num_frames: int,
                pdf_of_state) -> List[int]:
    """tid sequence occupying the phone's emitting states for
    num_frames (even split; (k-1) self-loops + forward per state)."""
    entry = tm.topo.entry(phone)
    n_emit = entry.num_emitting
    n_states = min(n_emit, num_frames)
    base = num_frames // n_states
    extra = num_frames % n_states
    out: List[int] = []
    for i in range(n_states):
        count = base + (1 if i < extra else 0)
        pdf = pdf_of_state(phone, entry.states[i].pdf_class)
        ts = tm.transition_state(phone, i, pdf)
        self_tid = fwd_tid = None
        for ai, (dest, _p) in enumerate(tm.arcs_of(ts)):
            tid = tm.pair_to_tid(ts, ai)
            if dest == i:
                self_tid = tid
            elif fwd_tid is None:
                fwd_tid = tid
        out.extend([self_tid] * (count - 1))
        out.append(fwd_tid if fwd_tid is not None else self_tid)
    return out


def convert_alignment(
    ali: np.ndarray,
    old_tm: TransitionModel,
    new_tm: TransitionModel,
    tree=None,
    context_width: int = 3,
    central_position: int = 1,
) -> np.ndarray:
    """Old-system tid alignment → new-system tid alignment.

    tree: ContextDependency for CD targets (None = monophone new
    system, pdf from the new tm's unique (phone, pdf_class))."""
    segs = phone_segments(old_tm, ali)
    phones = [p for p, _, _ in segs]
    out: List[int] = []
    for si, (phone, start, length) in enumerate(segs):
        if tree is not None:
            window = []
            for off in range(-central_position,
                             context_width - central_position):
                j = si + off
                window.append(phones[j] if 0 <= j < len(phones) else 0)
            window = tuple(window)
            pdf_of_state = lambda ph, pc: tree.compute(window, pc)
        else:
            def pdf_of_state(ph, pc, _tm=new_tm):
                ts = _tm.transition_state_of(ph, pc)
                return _tm.states[ts].pdf
        out.extend(_emit_phone(new_tm, phone, length, pdf_of_state))
    return np.asarray(out, np.int32)
