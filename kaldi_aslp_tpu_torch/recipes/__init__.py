"""Recipes (port of kaldi_aslp_tpu/recipes/): the phone-CTC recipe, the
hard synthetic corpus it trains on, and the hard ladder's CTC stage
(``hard_ladder``, ``decode_budget_sweep``)."""

from kaldi_aslp_tpu_torch.recipes.ctc import CtcRecipe, CtcRecipeOptions
from kaldi_aslp_tpu_torch.recipes.hard_corpus import (
    HardCorpusOptions,
    build_corpus,
    extract_mfcc_deltas_cmvn,
    pruned_bigram_arpa,
    synthesize_corpus,
)
