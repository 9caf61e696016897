"""Config, logging and device helpers (port of kaldi_aslp_tpu/utils/)."""
