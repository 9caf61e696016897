"""Feature front end (port of kaldi_aslp_tpu/feats/): fbank only so far."""
