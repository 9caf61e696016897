"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions,
and the host-side ops beside them (``ForwardMaxMatch``)."""

from kaldi_aslp_tpu_torch.ops.segment import ForwardMaxMatch
