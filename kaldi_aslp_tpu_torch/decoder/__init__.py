"""Decoding (port of kaldi_aslp_tpu/decoder/): the acoustic-score
bridge, the exact dense Viterbi (whole-utterance and online), the beam
decoder with its lattices, the Kaldi lattice shapes and their
operations, MBR and N-best.  The JAX package's ``equal_align``,
``BatchedViterbiDecoder`` and ``BatchedBeamDecoder`` are not ported yet
(ROADMAP queue 1 items 4 and 10)."""

from kaldi_aslp_tpu_torch.decoder.viterbi import (
    DecodeError,
    PackedGraph,
    ViterbiDecoder,
)
from kaldi_aslp_tpu_torch.decoder.beam import BeamSearchDecoder, CsrGraph
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
)
from kaldi_aslp_tpu_torch.decoder.nbest import (
    NBestEntry,
    lattice_nbest,
    lm_score_words,
    rescore_nbest,
)
