"""Command-line tools (port of kaldi_aslp_tpu/cli/)."""
