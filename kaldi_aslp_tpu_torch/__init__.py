"""kaldi_aslp_tpu_torch — the PyTorch and CUDA port of kaldi_aslp_tpu.

The JAX package ``kaldi_aslp_tpu`` beside it is the reference this port
is held against.  Plain tensor code here is PyTorch; every kernel the
JAX package wrote in Pallas for the TPU becomes a kernel written by hand
for Hopper, with its CUDA sources in ``csrc/``.  The module names mirror
the JAX package's (``models/``, ``ops/``, ``feats/``, ``decoder/``,
``online/``, ``train/``, ``data/``, ``fst/``, ``io/``, ``recipes/``,
``cli/``, ``utils/``) so each counterpart is easy to find.

The port never imports ``jax``, nor any module of ``kaldi_aslp_tpu``,
not even a numpy-only one: it keeps its own copy of what it needs."""

__version__ = "0.1.0"
