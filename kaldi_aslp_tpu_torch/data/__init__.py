"""Training data feed (port of kaldi_aslp_tpu/data/): truncated-BPTT
chunks, CTC stream batches and the frame randomizer."""
