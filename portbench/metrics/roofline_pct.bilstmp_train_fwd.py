"""Roofline share of the x-fused training forward (csrc/bilstmp_train.cu:
the hoisted input GEMM and both directions' sweeps in one C entry).

Per call, over the step's valid frames: the FLOPs of both directions'
x W_x^T, r_prev W_r^T and m W_rm^T products on bf16 operands; the bytes
of x, the bf16 weights, mask, peepholes, bias and the initial state read
once, and of ys, the stored gates, cells and r_prev (bf16) and the final
state written once.  Over the device time of the kernels the C entry
launched."""

from portbench.harness import flops

ENTRY = ("bilstmp_train_fwd",
         ["kaldi_aslp_tpu_torch.ops.bilstmp_train:bilstmp_train_fwd"])


def work(shapes, valid):
    """(FLOPs, bytes) of one call: x [S, T, D], wr [2, G, P],
    wrm [2, P, C] (arguments 0, 3, 4)."""
    (S, T, D), (_, G, P), (_, _, C) = shapes[0], shapes[3], shapes[4]
    ops = 2 * 2 * valid * (G * D + G * P + P * C)
    nbytes = (2 * (valid * D + 2 * (G * D + G * P + P * C))
              + 4 * (S * T + 2 * (3 * C + G) + 2 * S * (C + P))
              + 2 * (valid * 2 * P + 2 * valid * (G + C + P)))
    return ops, nbytes


def read(records):
    return flops.entry_roofline(
        records, ENTRY[0], records["config"],
        lambda c: work(c["shapes"], c["context"]["valid_frames"]))
