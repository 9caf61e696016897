"""Training: the SGD update, the frame trainer, the CTC trainer, the
truncated-BPTT trainer, layer-wise pretraining, the newbob schedule, the
CTC saddle detector and checkpoints (port of kaldi_aslp_tpu/train/)."""

from kaldi_aslp_tpu_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from kaldi_aslp_tpu_torch.train.newbob import (
    NewbobOptions,
    NewbobScheduler,
    NewbobState,
)
from kaldi_aslp_tpu_torch.train.pretrain import (
    insert_components,
    last_updatable_index,
    pretrain_layerwise,
)
from kaldi_aslp_tpu_torch.train.saddle import SaddleDetector, SaddleOptions
from kaldi_aslp_tpu_torch.train.sgd import (
    NnetTrainOptions,
    init_velocity,
    make_sgd_update,
)
from kaldi_aslp_tpu_torch.train.trainer import (
    CtcTrainer,
    FrameTrainer,
    LstmStreamsTrainer,
)
