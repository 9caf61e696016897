"""Corpus-level recipe runner: Kaldi data dirs on disk → trained system.

Port of kaldi_aslp_tpu/recipes/corpus.py, the user-facing entry for real
corpora (reference: the aslp_scripts run_*.sh chain over egs/<corpus>/s5
data dirs): reads wav.scp/text/utt2spk, extracts fbank features with
per-speaker CMVN, and runs the CTC or hybrid pipeline.  Corpora are not
downloadable here, so the tests drive the same path on synthesized
yes/no data dirs.

What differs from the JAX runner, and why:
  - the features and the pipeline run on ``device`` (``--device``; the
    card unless the caller asks for the CPU);
  - ``--dither`` other than 0 is refused: the JAX runner passes the
    option to its extractor without a key, so it never dithers, and the
    port does not ignore a flag quietly.

Usage:
    python -m kaldi_aslp_tpu_torch.recipes.corpus \
        --pipeline=ctc --lexicon=lexicon.txt [--device=cpu] \
        data/train data/test exp/ctc
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from kaldi_aslp_tpu_torch.feats.fbank import Fbank, FbankOptions
from kaldi_aslp_tpu_torch.feats.functions import acc_cmvn_stats, apply_cmvn
from kaldi_aslp_tpu_torch.feats.mel import MelBanksOptions
from kaldi_aslp_tpu_torch.feats.window import FrameExtractionOptions
from kaldi_aslp_tpu_torch.fst import Lang, Lexicon
from kaldi_aslp_tpu_torch.io import DataDir, read_wave
from kaldi_aslp_tpu_torch.utils.config import Config, parse_options
from kaldi_aslp_tpu_torch.utils.device import resolve_device
from kaldi_aslp_tpu_torch.utils.log import get_logger

logger = get_logger("corpus")


@dataclasses.dataclass
class CorpusRecipeOptions(Config):
    pipeline: str = "ctc"        # ctc | hybrid
    lexicon: str = ""            # lexicon.txt path (WORD ph1 ph2 ...)
    num_mel_bins: int = 40
    dither: float = 0.0
    norm_vars: bool = True
    max_utts: int = 0            # 0 = all (debug subsetting)
    device: str = "cuda"


def extract_features(d: DataDir, opts: CorpusRecipeOptions
                     ) -> Dict[str, np.ndarray]:
    """fbank + per-speaker CMVN for every utterance in a data dir
    (steps/make_fbank.sh + compute_cmvn_stats.sh + apply-cmvn), on
    ``opts.device``; the features return as float32 numpy arrays."""
    if opts.dither:
        raise ValueError(f"--dither={opts.dither}: the runner extracts "
                         f"undithered features only (the JAX runner ignores "
                         f"the option); pass --dither=0")
    device = resolve_device(opts.device)
    utts = sorted(d.wav_scp)
    if opts.max_utts:
        utts = utts[: opts.max_utts]
    fbank: Optional[Fbank] = None
    raw: Dict[str, torch.Tensor] = {}
    stats: Dict[str, torch.Tensor] = {}
    for utt in utts:
        wav = read_wave(d.wav_scp[utt])
        if fbank is None:
            fbank = Fbank(
                FrameExtractionOptions(samp_freq=wav.samp_freq,
                                       dither=opts.dither),
                MelBanksOptions(num_bins=opts.num_mel_bins),
                FbankOptions(), device=device)
        feats = fbank(wav.data[0])
        raw[utt] = feats
        spk = d.utt2spk.get(utt, utt)
        stats[spk] = acc_cmvn_stats(feats, stats.get(spk))
    return {utt: apply_cmvn(feats, stats[d.utt2spk.get(utt, utt)],
                            norm_vars=opts.norm_vars).cpu().numpy()
            for utt, feats in raw.items()}


def run_corpus(train_dir: str, test_dir: str, work_dir: str,
               opts: Optional[CorpusRecipeOptions] = None,
               pipeline_opts=None):
    """Returns the final ErrorStats; the pipeline's recipe object stays
    in ``run_corpus.recipe``."""
    opts = opts or CorpusRecipeOptions()
    t0 = time.perf_counter()
    train = DataDir.load(train_dir)
    test = DataDir.load(test_dir)
    for p in train.validate() + test.validate():
        logger.warning("data-dir issue: %s", p)

    with open(opts.lexicon) as f:
        lang = Lang.build(Lexicon.from_text(f.read()))

    logger.info("extracting features (%d train / %d test utts)",
                len(train.wav_scp), len(test.wav_scp))
    train_feats = extract_features(train, opts)
    test_feats = extract_features(test, opts)
    train_texts = {u: t.split() for u, t in train.text.items()
                   if u in train_feats}
    test_texts = {u: t.split() for u, t in test.text.items()
                  if u in test_feats}

    if opts.pipeline == "ctc":
        from kaldi_aslp_tpu_torch.recipes.ctc import (
            CtcRecipe,
            CtcRecipeOptions,
        )
        recipe = CtcRecipe(lang, pipeline_opts or CtcRecipeOptions(),
                           device=opts.device)
    elif opts.pipeline == "hybrid":
        from kaldi_aslp_tpu_torch.recipes.hybrid import (
            HybridRecipe,
            HybridRecipeOptions,
        )
        recipe = HybridRecipe(lang, pipeline_opts or HybridRecipeOptions(),
                              device=opts.device)
    else:
        raise ValueError(f"unknown pipeline {opts.pipeline!r}")
    stats = recipe.run(train_feats, train_texts, test_feats, test_texts,
                       work_dir=work_dir)
    run_corpus.recipe = recipe
    logger.info("%s [total %.1fs]", stats.report(), time.perf_counter() - t0)
    return stats


def main(argv=None) -> int:
    opts = CorpusRecipeOptions()
    args = parse_options(
        argv if argv is not None else sys.argv[1:], [opts],
        "python -m kaldi_aslp_tpu_torch.recipes.corpus --pipeline=ctc "
        "--lexicon=lex.txt [--device=cpu] data/train data/test exp/dir",
        3, 3,
    )
    stats = run_corpus(args[0], args[1], args[2], opts)
    print(stats.report())
    return 0 if stats.wer < 100.0 else 1


if __name__ == "__main__":
    sys.exit(main())
