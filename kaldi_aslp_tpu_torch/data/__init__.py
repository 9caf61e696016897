"""Training data feed (port of kaldi_aslp_tpu/data/): CTC stream batches."""
