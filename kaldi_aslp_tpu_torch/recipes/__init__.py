"""Recipes (port of kaldi_aslp_tpu/recipes/): the phone-CTC recipe, the
hybrid NN-HMM recipe (``hybrid``), the hard synthetic corpus they train
on, the hard ladder's stages and the frontier-budget sweeps
(``hard_ladder``, ``decode_budget_sweep``), the lattice decode-and-score
helper (``score_util``), the synthetic-corpus recipes (``ls_synth``,
``rm_synth``, ``timit_synth``, ``yesno``, the tonal syllable-CTC
``hkust_synth`` on the syllable units of ``syllable``) and the runner
for Kaldi data dirs (``corpus``)."""

from kaldi_aslp_tpu_torch.recipes.ctc import CtcRecipe, CtcRecipeOptions
from kaldi_aslp_tpu_torch.recipes.hard_corpus import (
    HardCorpusOptions,
    build_corpus,
    extract_mfcc_deltas_cmvn,
    pruned_bigram_arpa,
    synthesize_corpus,
)
