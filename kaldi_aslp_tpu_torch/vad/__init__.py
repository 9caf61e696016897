"""Voice activity detection (port of kaldi_aslp_tpu/vad/): the frame FSM,
the energy, NN and GMM detectors, the frame-selection helpers, ROC / AUC
/ EER, TextGrid rendering and boundary accuracy."""

from kaldi_aslp_tpu_torch.vad.vad import (
    Vad,
    VadOptions,
    EnergyVad,
    NnetVad,
    select_frames,
    ali_to_sil_targets,
)
from kaldi_aslp_tpu_torch.vad.roc import RocPoint, roc_curve, auc, eer
from kaldi_aslp_tpu_torch.vad.gmm_vad import GmmVad, train_gmm_vad
from kaldi_aslp_tpu_torch.vad.textgrid import (
    intervals_to_textgrid,
    parse_interval_file,
)
