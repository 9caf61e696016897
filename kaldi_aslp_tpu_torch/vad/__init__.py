"""Voice activity detection (port of kaldi_aslp_tpu/vad/): the frame FSM,
the energy, NN and GMM detectors and the frame-selection helpers.  ROC,
TextGrid and boundary tools wait for the VAD CLI."""

from kaldi_aslp_tpu_torch.vad.vad import (
    Vad,
    VadOptions,
    EnergyVad,
    NnetVad,
    select_frames,
    ali_to_sil_targets,
)
from kaldi_aslp_tpu_torch.vad.gmm_vad import GmmVad, train_gmm_vad
