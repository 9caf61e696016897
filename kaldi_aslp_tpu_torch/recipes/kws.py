"""KWS recipe: synthesize keyword / filler audio, train a phone DNN,
spot the keyword, sweep the ROC.

Port of kaldi_aslp_tpu/recipes/kws.py (reference: the aslp_scripts/kws
chain: run_dnn_one_keyword.sh (align + merge + DNN train + spot),
simulate.sh + generate_simulation_ali.py (noise-perturbed copies reuse
the clean alignments), gen_text_fst.py (the keyword-filler graph) and
evaluation_roc.py scoring).

The waveforms are the JAX recipe's, bit for bit (the same
``np.random.RandomState`` draws in the same order: seeds 777 and 778,
the simulation's 1, the batch order's 0).  On ``device`` (the card
unless the caller asks for the CPU): fbank, the phone DNN's
``FrameTrainer`` steps and its posteriors, once a test utterance.  Host
numpy: the spotter's DP (kws/kws.py), AUC and the ROC sweep.

The initial DNN parameters are ``init_params`` (a state dict in the
port's format; a test carries JAX's ``PRNGKey(0)`` draws across through
models/interop.py) or, without it, draws from a ``torch.Generator``
seeded 0 (not JAX's numbers: the two generators differ).  What the run
made stays in ``run.artifacts``.

Run: python -m kaldi_aslp_tpu_torch.recipes.kws [workdir] [--device=cpu]
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.feats.fbank import Fbank
from kaldi_aslp_tpu_torch.feats.window import FrameExtractionOptions
from kaldi_aslp_tpu_torch.kws import KeywordSpotter, KwsOptions
from kaldi_aslp_tpu_torch.kws.state_map import roc_sweep
from kaldi_aslp_tpu_torch.kws.text_fst import (
    build_keyword_filler_text_fst,
    simulation_ali,
)
from kaldi_aslp_tpu_torch.models.nnet import Nnet
from kaldi_aslp_tpu_torch.models.simple import (
    AffineTransform,
    Sigmoid,
    Softmax,
)
from kaldi_aslp_tpu_torch.recipes.vad import (
    featurize,
    frame_batches,
    init_net,
    posteriors,
)
from kaldi_aslp_tpu_torch.train import (
    FrameTrainer,
    NnetTrainOptions,
    init_velocity,
)
from kaldi_aslp_tpu_torch.utils.device import resolve_device
from kaldi_aslp_tpu_torch.utils.log import get_logger
from kaldi_aslp_tpu_torch.vad import auc

logger = get_logger("kws_recipe")

SAMP_FREQ = 8000.0
HIDDEN = 64

# tonal pseudo-phones: id -> (f0, harmonic weight profile)
PHONES = ["sil", "aa", "ee", "ii", "oo", "uu"]
PHONE_F0 = {"aa": 130.0, "ee": 200.0, "ii": 300.0, "oo": 430.0,
            "uu": 600.0}
KEYWORD = "niho"
KEYWORD_PHONES = ["ee", "ii", "oo"]


def _phone_wave(phone: str, dur: float, rng) -> np.ndarray:
    n = int(dur * SAMP_FREQ)
    if phone == "sil":
        return np.zeros(n)
    t = np.arange(n) / SAMP_FREQ
    f0 = PHONE_F0[phone]
    return np.hanning(n) * sum(
        (3000 / (k + 1)) * np.sin(2 * np.pi * f0 * (k + 1) * t
                                  + rng.rand())
        for k in range(3))


def synthesize(num_utts: int, keyword_prob: float, seed: int):
    """Returns (waves, frame phone-labels, has_keyword flags)."""
    rng = np.random.RandomState(seed)
    shift = int(SAMP_FREQ * 0.01)
    wlen = int(SAMP_FREQ * 0.025)
    speech_phones = [p for p in PHONES if p != "sil"]
    waves, labels, flags = [], [], []

    def contains_kw(seq: List[str]) -> bool:
        k = len(KEYWORD_PHONES)
        return any(seq[i:i + k] == KEYWORD_PHONES
                   for i in range(len(seq) - k + 1))

    for _ in range(num_utts):
        has_kw = rng.rand() < keyword_prob
        body: List[str] = []
        while True:
            body = [speech_phones[rng.randint(len(speech_phones))]
                    for _ in range(rng.randint(2, 5))]
            if not contains_kw(body):
                break
        seq = ["sil"]
        if has_kw:
            pos = rng.randint(len(body) + 1)
            body = body[:pos] + KEYWORD_PHONES + body[pos:]
        for p in body:
            seq.append(p)
        seq.append("sil")
        chunks, lab = [], []
        for p in seq:
            dur = (0.15 + 0.1 * rng.rand() if p != "sil"
                   else 0.2 + 0.1 * rng.rand())
            w = _phone_wave(p, dur, rng)
            chunks.append(w)
            lab.append(np.full(len(w), PHONES.index(p), np.int32))
        wave = np.concatenate(chunks) + 30 * rng.randn(
            sum(len(c) for c in chunks))
        sample_lab = np.concatenate(lab)
        n_frames = max(0, (len(wave) - wlen) // shift + 1)
        fl = np.array([
            np.bincount(sample_lab[i * shift:i * shift + wlen],
                        minlength=len(PHONES)).argmax()
            for i in range(n_frames)], np.int32)
        waves.append(wave.astype(np.float32))
        labels.append(fl)
        flags.append(int(has_kw))
    return waves, labels, flags


def build_net(dim: int) -> Nnet:
    """The phone DNN: Affine to 64, Sigmoid, Affine to the 6 phones,
    Softmax (run_dnn_one_keyword.sh's train stage)."""
    V = len(PHONES)
    net = Nnet()
    net.add(AffineTransform(dim, HIDDEN))
    net.add(Sigmoid(HIDDEN, HIDDEN))
    net.add(AffineTransform(HIDDEN, V))
    net.add(Softmax(V, V))
    return net


def run(root: str = "exp_kws", num_train: int = 30, num_test: int = 20,
        simulate: bool = True,
        init_params: Optional[Mapping[str, torch.Tensor]] = None,
        device: Union[str, torch.device] = "cuda") -> Dict[str, float]:
    """Trains the phone DNN on the training utterances (and their
    simulated copies), spots the keyword in each test utterance, writes
    ``keyword.fst.txt`` and ``roc.txt`` under ``root``; returns
    ``kws_auc`` and ``kws_best_acc``."""
    os.makedirs(root, exist_ok=True)
    device = resolve_device(device)
    train_w, train_l, _ = synthesize(num_train, keyword_prob=0.5,
                                     seed=777)
    test_w, test_l, test_flags = synthesize(num_test, keyword_prob=0.5,
                                            seed=778)

    # keyword-filler text FST artifact (gen_text_fst.py role)
    fst_text = build_keyword_filler_text_fst({KEYWORD: KEYWORD_PHONES})
    with open(os.path.join(root, "keyword.fst.txt"), "w") as f:
        f.write(fst_text)

    fo = FrameExtractionOptions(samp_freq=SAMP_FREQ, dither=0.0)
    fbank = Fbank(frame_opts=fo, device=device)
    train_f, train_l = featurize(fbank, train_w, train_l)
    test_f, _ = featurize(fbank, test_w, test_l)

    # simulation stage (simulate.sh): noise-perturbed copies of train
    # utterances reuse the clean alignment via generate_simulation_ali
    if simulate:
        rng = np.random.RandomState(1)
        clean_ali = {"utt%d" % i: l for i, l in enumerate(train_l)}
        sim_keys = ["simulation_0_utt%d" % i for i in range(len(train_w))]
        sim_ali = simulation_ali(clean_ali, sim_keys)
        sim_feats = []
        for i, w in enumerate(train_w):
            noisy = w + 150 * rng.randn(len(w)).astype(np.float32)
            f = fbank(noisy).cpu().numpy()
            key = "simulation_0_utt%d" % i
            n = min(len(f), len(sim_ali[key]))
            sim_feats.append(f[:n])
            sim_ali[key] = sim_ali[key][:n]
        train_f = train_f + sim_feats
        train_l = train_l + [np.asarray(sim_ali[k], np.int32)
                             for k in sim_keys]

    tr_x = np.concatenate(train_f)
    tr_y = np.concatenate(train_l)
    cmn = tr_x.mean(axis=0)

    # phone DNN (run_dnn_one_keyword.sh train stage)
    net = build_net(tr_x.shape[1])
    init_net(net, init_params)
    net.to(device)
    velocity = init_velocity(net)
    trainer = FrameTrainer(net, NnetTrainOptions(momentum=0.9))
    rng = np.random.RandomState(0)
    order = rng.permutation(len(tr_x))
    xs, ys = (tr_x - cmn)[order], tr_y[order]
    for epoch in range(8):
        velocity, rep = trainer.train_epoch(
            velocity, frame_batches(xs, ys), 0.1)
        logger.info("epoch %d %s", epoch + 1,
                    rep.report().replace("\n", " "))

    # spot (aslp-kws-score role): confidence per test utterance
    kw_cols = [PHONES.index(p) for p in KEYWORD_PHONES]
    spotter = KeywordSpotter({KEYWORD: kw_cols},
                             KwsOptions(confidence_threshold=0.0))
    scores, labels = {}, {}
    for i, f in enumerate(test_f):
        hits = spotter.spot(posteriors(net, f - cmn, device))
        scores["utt%d" % i] = hits[0].confidence if hits else 0.0
        labels["utt%d" % i] = test_flags[i]

    sc = np.array([scores[k] for k in sorted(scores)])
    lb = np.array([labels[k] for k in sorted(labels)])
    results = {"kws_auc": auc(sc, lb)}
    roc = roc_sweep(scores, labels)
    with open(os.path.join(root, "roc.txt"), "w") as f:
        for p in roc:
            f.write("%s\n" % (p,))
    # best detection accuracy over the swept thresholds
    # (evaluation_roc.py reports the whole sweep; the headline number
    # is the best operating point)
    results["kws_best_acc"] = float(max(r[1] for r in roc))
    run.artifacts = dict(net=net, cmn=cmn, test_feats=test_f,
                         test_flags=test_flags, scores=scores,
                         train_feats=train_f, train_labels=train_l)
    for k, v in sorted(results.items()):
        logger.info("%s = %.4f", k, v)
    return results


if __name__ == "__main__":
    argv = sys.argv[1:]
    dev = next((a.split("=", 1)[1] for a in argv
                if a.startswith("--device=")), "cuda")
    pos = [a for a in argv if not a.startswith("--")]
    print("RESULT", run(pos[0] if pos else "exp_kws", device=dev))
