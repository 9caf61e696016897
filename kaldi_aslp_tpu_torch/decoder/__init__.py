"""Decoding (port of kaldi_aslp_tpu/decoder/): the acoustic-score
bridge, the exact dense Viterbi (whole-utterance, online and batched)
and the forced alignment over per-utterance training graphs
(``align_batched``, ``equal_align``), the beam decoder (one utterance or
a lock-step batch) with its lattices, the Kaldi lattice shapes and their
operations, MBR and N-best."""

from kaldi_aslp_tpu_torch.decoder.viterbi import (
    DecodeError,
    PackedGraph,
    ViterbiDecoder,
    align_batched,
    equal_align,
)
from kaldi_aslp_tpu_torch.decoder.beam import (
    BatchedBeamDecoder,
    BeamSearchDecoder,
    CsrGraph,
)
from kaldi_aslp_tpu_torch.decoder.batched import BatchedViterbiDecoder
from kaldi_aslp_tpu_torch.decoder.lattice import (
    Lattice,
    LatticeError,
    generate_lattice,
    lattice_best_path,
    score_lmwt_sweep,
)
from kaldi_aslp_tpu_torch.decoder.compact import (
    CompactLattice,
    StateLattice,
    compact_lattice_best_path,
    compact_lattice_lmrescore,
    DeterminizeFailed,
    determinize_lattice,
    determinize_lattice_pruned,
    lattice_to_state,
    scale_lattice,
    state_lattice_best_path,
    state_to_lattice,
)
from kaldi_aslp_tpu_torch.decoder.mbr import (
    lattice_arc_posteriors,
    minimum_bayes_risk,
)
from kaldi_aslp_tpu_torch.decoder.online import OnlineViterbiDecoder
from kaldi_aslp_tpu_torch.decoder.decodable import (
    PdfPrior,
    NnetForwardOptions,
    nnet_forward,
    nnet_forward_batched,
)
from kaldi_aslp_tpu_torch.decoder.nbest import (
    NBestEntry,
    lattice_nbest,
    lm_score_words,
    rescore_nbest,
)
