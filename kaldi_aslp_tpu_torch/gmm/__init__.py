"""GMM acoustic models (port of kaldi_aslp_tpu/gmm/): the diagonal GMM
with its statistics and updates, the monophone and triphone (deltas)
trainers, SAT with fMLLR, EBW, full-covariance and global GMMs."""

from kaldi_aslp_tpu_torch.gmm.diag_gmm import (
    AmDiagGmm,
    GmmStats,
    corpus_loglikes,
    gmm_loglikes,
    mle_update,
    split_gaussians,
)
from kaldi_aslp_tpu_torch.gmm.mono import MonophoneTrainer, MonoTrainOptions
from kaldi_aslp_tpu_torch.gmm.deltas import (
    DeltasTrainer,
    DeltasTrainOptions,
    make_cd_decode_graph,
)
from kaldi_aslp_tpu_torch.gmm.sat import (
    SatOptions,
    SatTrainer,
    apply_speaker_transforms,
    estimate_speaker_transforms,
)
from kaldi_aslp_tpu_torch.gmm.ebw import (
    EbwOptions,
    accumulate_denominator_stats,
    accumulate_numerator_stats,
    ebw_update,
)
from kaldi_aslp_tpu_torch.gmm.full_gmm import (
    AmFullGmm,
    full_gmm_accumulate,
    full_gmm_loglikes,
    full_gmm_mle_update,
)
from kaldi_aslp_tpu_torch.gmm.global_gmm import (
    GlobalGmm,
    avg_loglike,
    global_gmm_loglikes,
    init_from_feats,
)
