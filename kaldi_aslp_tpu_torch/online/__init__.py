"""Online serving: streaming features, endpointing, the TCP decode
server (port of kaldi_aslp_tpu/online/)."""
