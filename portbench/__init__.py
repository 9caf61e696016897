"""The benchmark of kaldi_aslp_tpu_torch: run.py is its command."""
