"""Roofline share of the inference kernel (csrc/lstmp_forward.cu: both
directions of a BLSTMP layer in one C entry).

Per call, over the call's valid frames: the FLOPs of both directions'
r_prev W_r^T and m W_rm^T; the bytes of both input projections, the mask,
both directions' weights and the initial state read once, and of ys and
the final state written once, all float32.  Over the device time of the
kernels the C entry launched; the peak is the configuration's (bf16 for
blstm_ctc, whose eval path computes in float32)."""

from portbench.harness import flops

ENTRY = ("blstmp_forward",
         ["kaldi_aslp_tpu_torch.ops.lstmp:blstmp_forward",
          "kaldi_aslp_tpu_torch.models.recurrent:blstmp_forward"])


def work(shapes, valid):
    """(FLOPs, bytes) of one call: xg_f [S, T, G], r0 [S, P] (arguments
    0 and 6)."""
    (S, T, G), (_, P) = shapes[0], shapes[6]
    C = G // 4
    ops = 2 * 2 * valid * (G * P + P * C)
    nbytes = 4 * (2 * valid * G + S * T + 2 * (G * P + P * C + 3 * C)
                  + 2 * S * (C + P) + valid * 2 * P)
    return ops, nbytes


def read(records):
    return flops.entry_roofline(
        records, ENTRY[0], records["config"],
        lambda c: work(c["shapes"], c["context"]["valid_frames"]))
