"""Graph building (the port's own copy of what it uses of
kaldi_aslp_tpu/fst/): plain Python and numpy, no torch."""

from kaldi_aslp_tpu_torch.fst.ctc_graph import (
    ctc_lut,
    expand_ctc,
    make_ctc_decode_graph,
)
from kaldi_aslp_tpu_torch.fst.context import ContextWindows, compose_context
from kaldi_aslp_tpu_torch.fst.determinize import (
    NonDeterminizableError,
    determinize,
    minimize_encoded,
)
from kaldi_aslp_tpu_torch.fst.fst import EPS, Arc, Fst, SymbolTable
from kaldi_aslp_tpu_torch.fst.hclg import (
    TrainingGraphCompiler,
    expand_hmm,
    expand_hmm_cd,
    make_decode_graph,
    triples_from_tree,
)
from kaldi_aslp_tpu_torch.fst.lang import (
    Lang,
    Lexicon,
    arpa_to_fst,
    make_lexicon_fst,
    make_linear_acceptor,
    make_unigram_grammar,
    parse_arpa,
)

__all__ = ["EPS", "Arc", "Fst", "SymbolTable", "Lang", "Lexicon",
           "make_lexicon_fst", "make_unigram_grammar", "parse_arpa",
           "arpa_to_fst", "determinize",
           "minimize_encoded", "ctc_lut", "expand_ctc",
           "make_ctc_decode_graph", "make_linear_acceptor", "expand_hmm",
           "make_decode_graph", "TrainingGraphCompiler", "ContextWindows",
           "compose_context", "expand_hmm_cd", "triples_from_tree",
           "NonDeterminizableError"]
