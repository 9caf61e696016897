"""Feature front end (port of kaldi_aslp_tpu/feats/): fbank, MFCC, PLP and
the spectrogram, pitch, deltas, CMVN and sliding-window CMN, the bucketed
batch extractor, the feature pipeline, feature-space transforms,
resampling and Kaldi's dither RNG.  Exports the JAX package's names."""

from kaldi_aslp_tpu_torch.feats.window import (
    FrameExtractionOptions,
    num_frames,
    window_function,
    extract_frames,
    process_window,
    compute_power_spectrum,
)
from kaldi_aslp_tpu_torch.feats.mel import MelBanksOptions, mel_banks_matrix
from kaldi_aslp_tpu_torch.feats.fbank import Fbank, FbankOptions
from kaldi_aslp_tpu_torch.feats.mfcc import (
    Mfcc,
    MfccOptions,
    dct_matrix,
    lifter_coeffs,
)
from kaldi_aslp_tpu_torch.feats.functions import (
    DeltaFeaturesOptions,
    add_deltas,
    splice_frames,
    acc_cmvn_stats,
    apply_cmvn,
    SlidingWindowCmnOptions,
    sliding_window_cmn,
)
from kaldi_aslp_tpu_torch.feats.pipeline import (
    FeaturePipeline,
    FeaturePipelineOptions,
    compute_cmvn_stats_per_spk,
)
from kaldi_aslp_tpu_torch.feats.transforms import (
    LdaStats,
    estimate_lda,
    MlltStats,
    estimate_mllt,
    FmllrStats,
    estimate_fmllr,
    apply_transform,
    gmm_gammas_for_alignment,
)
from kaldi_aslp_tpu_torch.feats.plp import Plp, PlpOptions, Spectrogram
from kaldi_aslp_tpu_torch.feats.resample import resample_waveform, add_noise
from kaldi_aslp_tpu_torch.feats.pitch import (
    PitchOptions,
    compute_pitch,
    postprocess_pitch,
)
