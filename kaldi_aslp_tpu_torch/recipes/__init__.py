"""Recipes (port of kaldi_aslp_tpu/recipes/): the phone-CTC recipe and
the hard synthetic corpus it trains on."""

from kaldi_aslp_tpu_torch.recipes.ctc import CtcRecipe, CtcRecipeOptions
from kaldi_aslp_tpu_torch.recipes.hard_corpus import (
    HardCorpusOptions,
    build_corpus,
    extract_mfcc_deltas_cmvn,
    pruned_bigram_arpa,
    synthesize_corpus,
)
