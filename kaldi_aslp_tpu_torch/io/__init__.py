"""Kaldi ark/scp tables of matrices and integer vectors
(port of the part of kaldi_aslp_tpu/io/ the trainer uses)."""

from kaldi_aslp_tpu_torch.io.kaldi_io import KaldiIOError
from kaldi_aslp_tpu_torch.io.table import (
    int_vector_writer,
    matrix_writer,
    random_access_int_vector_reader,
    sequential_matrix_reader,
)
