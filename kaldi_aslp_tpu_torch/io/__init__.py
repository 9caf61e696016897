"""Kaldi ark/scp tables of matrices, vectors, integer vectors,
posteriors and lattices, wave and HTK files and data dirs (port of
kaldi_aslp_tpu/io/)."""

from kaldi_aslp_tpu_torch.io.datadir import DataDir, split_data_dir
from kaldi_aslp_tpu_torch.io.htk import HtkHeader, read_htk, write_htk
from kaldi_aslp_tpu_torch.io.kaldi_io import (
    KaldiIOError,
    read_int_vector,
    read_matrix,
    read_posterior,
    read_vector,
    write_int_vector,
    write_matrix,
    write_posterior,
    write_vector,
)
from kaldi_aslp_tpu_torch.io.lattice_io import (
    CompactLatticeHolder,
    LatticeHolder,
    compact_lattice_writer,
    lattice_writer,
    random_access_lattice_reader,
    read_lattice_binary,
    read_lattice_text,
    sequential_lattice_reader,
    write_lattice_binary,
    write_lattice_text,
)
from kaldi_aslp_tpu_torch.io.table import (
    RandomAccessTableReader,
    SequentialTableReader,
    TableWriter,
    int_vector_writer,
    matrix_writer,
    posterior_writer,
    random_access_int_vector_reader,
    random_access_matrix_reader,
    random_access_posterior_reader,
    random_access_vector_reader,
    sequential_int_vector_reader,
    sequential_matrix_reader,
    sequential_posterior_reader,
    sequential_vector_reader,
    vector_writer,
)
from kaldi_aslp_tpu_torch.io.wave import WaveData, read_wave, write_wave
