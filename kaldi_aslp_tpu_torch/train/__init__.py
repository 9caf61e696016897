"""Training: the SGD update, the CTC trainer, the truncated-BPTT
trainer, the newbob schedule, the CTC saddle detector and checkpoints
(port of kaldi_aslp_tpu/train/)."""

from kaldi_aslp_tpu_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from kaldi_aslp_tpu_torch.train.newbob import (
    NewbobOptions,
    NewbobScheduler,
    NewbobState,
)
from kaldi_aslp_tpu_torch.train.saddle import SaddleDetector, SaddleOptions
from kaldi_aslp_tpu_torch.train.sgd import (
    NnetTrainOptions,
    init_velocity,
    make_sgd_update,
)
from kaldi_aslp_tpu_torch.train.trainer import CtcTrainer, LstmStreamsTrainer
