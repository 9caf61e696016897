"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions,
and the host-side ops beside them; exports the JAX package's names (the
CTC loss and decode, edit distance and scoring, ``ForwardMaxMatch``).
``ctc_alpha_beta`` is JAX's function (ops/ctc.py); the kernel's module
is ``ops.ctc_recursions``."""

from kaldi_aslp_tpu_torch.ops.ctc import (
    ctc_loss,
    ctc_alpha_beta,
    expand_labels,
    ctc_greedy_decode,
    collapse_ctc_path,
)
from kaldi_aslp_tpu_torch.ops.edit_distance import (
    edit_distance,
    align_errors,
    score_utterances,
    ErrorStats,
)
from kaldi_aslp_tpu_torch.ops.segment import ForwardMaxMatch
