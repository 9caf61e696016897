"""Training data feed (port of kaldi_aslp_tpu/data/): truncated-BPTT
chunks and CTC stream batches."""
