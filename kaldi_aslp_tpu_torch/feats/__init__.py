"""Feature front end (port of kaldi_aslp_tpu/feats/): fbank, MFCC, PLP and
the spectrogram, pitch, deltas, CMVN and sliding-window CMN, the bucketed
batch extractor, the feature pipeline, feature-space transforms,
resampling and Kaldi's dither RNG."""
