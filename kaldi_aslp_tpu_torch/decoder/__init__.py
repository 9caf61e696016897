"""Decoding (port of kaldi_aslp_tpu/decoder/): the acoustic-score
bridge, the exact dense Viterbi (whole-utterance and online) and the
beam decoder's best-path decode."""
