"""Feature front end (port of kaldi_aslp_tpu/feats/): fbank, MFCC, deltas,
CMVN and the bucketed batch extractor."""
