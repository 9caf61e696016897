"""Roofline share of the x-fused training backward (csrc/bilstmp_train.cu:
both directions' reverse sweeps, dx and the weight-gradient GEMMs in one
C entry).

Per call, over the step's valid frames: the FLOPs of both directions'
sweep products (dr_new W_rm, dgates W_r) and of dx, dW_x, dW_r, dW_rm on
bf16 operands; the bytes of dy, x, the stored gates, cells and r_prev,
the bf16 weights, mask, peepholes and the states read once, and of dx,
the state gradients and the float32 weight gradients written once.  Over
the device time of the kernels the C entry launched."""

from portbench.harness import flops

ENTRY = ("bilstmp_train_bwd",
         ["kaldi_aslp_tpu_torch.ops.bilstmp_train:bilstmp_train_bwd"])


def work(shapes, valid):
    """(FLOPs, bytes) of one call: x [S, T, D], wr [2, G, P],
    wrm [2, P, C] (arguments 2, 7, 8)."""
    (S, T, D), (_, G, P), (_, _, C) = shapes[2], shapes[7], shapes[8]
    weights = G * D + G * P + P * C
    ops = 2 * 2 * valid * (2 * P * C + 2 * G * P + 2 * G * D)
    nbytes = (2 * (valid * 2 * P + valid * D + 2 * valid * (G + C + P)
                   + 2 * weights + valid * D)
              + 4 * (S * T + 2 * 3 * C + S * C + 2 * S * (C + P)
                     + 2 * (weights + G + 3 * C)))
    return ops, nbytes


def read(records):
    return flops.entry_roofline(
        records, ENTRY[0], records["config"],
        lambda c: work(c["shapes"], c["context"]["valid_frames"]))
