"""Roofline share of the CTC pair (csrc/ctc_alpha_beta.cu: the alpha and
beta recursions in one C entry).

Per call, over each stream's valid frames and its 2U+1 expanded states:
about 12 float32 operations a state and recursion step (the three-way
log-sum-exp and the emission), len - 1 steps each way; the bytes of the
emission scores and skip flags read once and of alphas and betas written
once, over those frames and states.  Over the device time of the kernels
the C entry launched."""

import numpy as np

from portbench.harness import flops

ENTRY = ("ctc_alpha_beta",
         ["kaldi_aslp_tpu_torch.ops.ctc_recursions:ctc_alpha_beta"])
OPS_PER_STATE = 12


def work(lengths, label_lengths):
    lengths = np.asarray(lengths, np.int64)
    states = 2 * np.asarray(label_lengths, np.int64) + 1
    steps = 2 * np.maximum(lengths - 1, 0)
    ops = OPS_PER_STATE * int((steps * states).sum())
    cells = int((lengths * states).sum())
    nbytes = 4 * (3 * cells + int(states.sum()) + 2 * len(lengths))
    return ops, nbytes


def read(records):
    return flops.entry_roofline(
        records, ENTRY[0], records["config"],
        lambda c: work(c["context"]["input_lengths"],
                       c["context"]["label_lengths"]))
