"""Kaldi ark/scp tables of matrices, integer vectors and lattices
(port of the part of kaldi_aslp_tpu/io/ the trainers, the decoders and
the lattice tools use)."""

from kaldi_aslp_tpu_torch.io.kaldi_io import KaldiIOError
from kaldi_aslp_tpu_torch.io.lattice_io import (
    compact_lattice_writer,
    lattice_writer,
    random_access_lattice_reader,
    sequential_lattice_reader,
)
from kaldi_aslp_tpu_torch.io.table import (
    int_vector_writer,
    matrix_writer,
    random_access_int_vector_reader,
    sequential_matrix_reader,
)
