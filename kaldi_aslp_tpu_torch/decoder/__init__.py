"""Decoding (port of kaldi_aslp_tpu/decoder/): the acoustic-score
bridge and the exact dense Viterbi, whole-utterance and online."""
