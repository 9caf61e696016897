"""GMM acoustic models (port of kaldi_aslp_tpu/gmm/diag_gmm.py and
mono.py): the diagonal GMM with its statistics and updates, and the
monophone trainer.  The triphone, SAT, EBW and full-covariance trainers
wait for a later slice."""

from kaldi_aslp_tpu_torch.gmm.diag_gmm import (
    AmDiagGmm,
    GmmStats,
    corpus_loglikes,
    gmm_loglikes,
    mle_update,
    split_gaussians,
)
from kaldi_aslp_tpu_torch.gmm.mono import MonophoneTrainer, MonoTrainOptions
