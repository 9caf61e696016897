"""Training: the SGD update, the CTC trainer and the truncated-BPTT
trainer (port of kaldi_aslp_tpu/train/)."""

from kaldi_aslp_tpu_torch.train.sgd import (
    NnetTrainOptions,
    init_velocity,
    make_sgd_update,
)
from kaldi_aslp_tpu_torch.train.trainer import CtcTrainer, LstmStreamsTrainer
