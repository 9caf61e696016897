"""Voice activity detection (port of kaldi_aslp_tpu/vad/): the frame FSM,
the energy and NN detectors and the frame-selection helpers.  The GMM
detector waits for the GMM port; ROC, TextGrid and boundary tools for
the VAD CLI."""

from kaldi_aslp_tpu_torch.vad.vad import (
    Vad,
    VadOptions,
    EnergyVad,
    NnetVad,
    select_frames,
    ali_to_sil_targets,
)
