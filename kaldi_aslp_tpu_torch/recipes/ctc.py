"""Phone-CTC training recipe: the aslp_scripts/ctc chain.

Port of kaldi_aslp_tpu/recipes/ctc.py:45-364 (reference:
aslp_scripts/ctc/prepare_mono_phone_ctc.sh — phone labels shifted so
blank=0; train_scheduler_ctc.sh per-epoch CTC training with newbob;
make_ctc_graph.sh TLG; Eesen-style decode with prior division).  Labels
come straight from word transcripts through the lexicon.

What differs from the JAX recipe, and why:
  - ``CtcTrainer`` trains the net in place, so the recipe keeps ``best``
    as a cloned state dict and loads it before every epoch, as the JAX
    loop starts every epoch from ``best``; the one velocity dict is
    carried across epochs, rejected ones too, as there;
  - the JAX recipe's epoch cache (data/device_cache.py, not ported) is
    not only a cache: from the second epoch on it replays the batches in
    an order shuffled by ``random.Random(777)``, one shuffle an epoch
    (:99-103).  The recipe keeps that order, without the cache;
  - the blank probe, the cross-validation pass and the posteriors run in
    ``eval()`` mode under ``no_grad``, on the recipe's device (the card
    unless the caller asks for the CPU); the posteriors of an utterance
    are one unpadded forward, where the JAX recipe pads to
    ``bucket_time`` for XLA's compile cache (the mask makes the padding
    a no-op there);
  - the dev selection of (acoustic_scale, prior_scale) stays on the
    recipe (``self.acoustic_scale``, ``self.prior_scale``); the JAX
    recipe writes it into the caller's options (recipes/ctc.py:297-298);
  - a ``transport`` other than "f32" raises (data/transport.py and the
    epoch cache are not ported, by design).

``decode_beam > 0`` decodes with the beam-pruned decoder
(decoder/beam.py) at ``decode_max_active`` tokens, as the JAX recipe
does; the default 0 keeps the exact dense Viterbi."""

from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.data.sequence import CtcBatcher, CtcBatcherOptions
from kaldi_aslp_tpu_torch.decoder.beam import BeamSearchDecoder, CsrGraph
from kaldi_aslp_tpu_torch.decoder.viterbi import (
    DecodeError,
    PackedGraph,
    ViterbiDecoder,
)
from kaldi_aslp_tpu_torch.fst import (
    Lang,
    ctc_lut,
    make_ctc_decode_graph,
    make_unigram_grammar,
)
from kaldi_aslp_tpu_torch.fst.fst import Fst
from kaldi_aslp_tpu_torch.models import AffineTransform, BLstm, Lstm, Nnet
from kaldi_aslp_tpu_torch.ops.edit_distance import (
    ErrorStats,
    score_utterances,
)
from kaldi_aslp_tpu_torch.train import (
    CtcTrainer,
    NewbobOptions,
    NewbobScheduler,
    NnetTrainOptions,
    SaddleDetector,
    SaddleOptions,
    init_velocity,
    save_checkpoint,
)
from kaldi_aslp_tpu_torch.train.trainer import upload
from kaldi_aslp_tpu_torch.utils.config import Config
from kaldi_aslp_tpu_torch.utils.device import resolve_device
from kaldi_aslp_tpu_torch.utils.log import get_logger

logger = get_logger("ctc-recipe")


@dataclasses.dataclass
class CtcRecipeOptions(Config):
    model_type: str = "blstm"   # lstm | blstm
    hidden_dim: int = 64
    num_layers: int = 2
    learn_rate: float = 0.01
    momentum: float = 0.9
    max_iters: int = 12
    keep_lr_iters: int = 0   # static hold (legacy; auto_saddle replaces)
    # automatic blank-saddle crossing (train/saddle.py): hold the lr
    # while greedy output is all-blank, escalate it if the saddle does
    # not yield, hand control to newbob after crossing
    auto_saddle: bool = True
    saddle_blank_thresh: float = 0.90
    saddle_escalate_iters: int = 4
    saddle_lr_factor: float = 2.0
    saddle_max_lr: float = 0.8
    num_streams: int = 8
    acoustic_scale: float = 1.0
    # Eesen-style decode: divide posteriors by their training-set
    # average (reference: aslp-nnet-forward --class-frame-counts +
    # --scale-blank roles); 0 disables
    prior_scale: float = 1.0
    # feature bytes over the host->device link: only "f32" is ported
    transport: str = "f32"
    # > 0: decode with the beam-pruned decoder at this beam instead of
    # the exact dense DP (mandatory when the TLG outgrows the dense
    # [T, S] table)
    decode_beam: float = 0.0
    decode_max_active: int = 2048
    # low frame rate: take every k-th frame in training AND decode
    # (reference: the --skip-width of aslp-nnet-train-ctc-streams)
    lfr_skip: int = 1
    # batch shape bucketing (CtcBatcher padding of T and U)
    bucket_time: int = 64
    bucket_labels: int = 16


class CtcRecipe:
    """Trains a BLSTM (or LSTM) CTC model with newbob, saddle holds and
    cross-validation, then decodes the test set through the CTC TLG and
    scores it; ``run`` returns the test ErrorStats."""

    def __init__(self, lang: Lang, opts: Optional[CtcRecipeOptions] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.lang = lang
        self.opts = opts or CtcRecipeOptions()
        if self.opts.transport != "f32":
            raise ValueError(
                f"transport={self.opts.transport!r}: only 'f32' is ported "
                "(data/transport.py and the epoch cache are not ported, "
                "by design)")
        self.device = resolve_device(device)
        # CTC inventory: blank=0, outputs 1..N = phone ids
        self.num_outputs = len(lang.phones) + 1

    def phone_labels(self, words: List[str]) -> np.ndarray:
        """Transcript -> phone-id label sequence (blank-0 convention)."""
        seq: List[int] = []
        for w in words:
            pron = self.lang.lexicon.prons[w][0]
            seq.extend(self.lang.phones.id(p) for p in pron)
        return np.asarray(seq, np.int32)

    def batches(self, feats: Dict[str, np.ndarray],
                texts: Dict[str, List[str]]) -> Tuple[list, list]:
        """(training batches, cross-validation batches): the first tenth
        of the sorted utterances (at least one) cross-validates."""
        opts = self.opts
        utts = sorted(feats)
        cv_utts = utts[: max(1, len(utts) // 10)]

        def batched(utt_list):
            src = ((u, feats[u], self.phone_labels(texts[u]))
                   for u in utt_list)
            return list(CtcBatcher(
                src, CtcBatcherOptions(num_streams=opts.num_streams,
                                       skip_width=opts.lfr_skip,
                                       bucket_time=opts.bucket_time,
                                       bucket_labels=opts.bucket_labels)))

        return batched(utts[len(cv_utts):]), batched(cv_utts)

    def run(
        self,
        train_feats: Dict[str, np.ndarray],
        train_texts: Dict[str, List[str]],
        test_feats: Dict[str, np.ndarray],
        test_texts: Dict[str, List[str]],
        grammar: Optional[Fst] = None,
        work_dir: str = "exp_ctc",
        dev_feats: Optional[Dict[str, np.ndarray]] = None,
        dev_texts: Optional[Dict[str, List[str]]] = None,
    ) -> ErrorStats:
        """With a dev set, (acoustic_scale, prior_scale) are swept on it
        and the test set is decoded once at the selection; without one
        the options' values apply.  ``self.epochs`` records each epoch
        (its batches, losses, blank fraction, decision and seconds)."""
        opts = self.opts
        V = self.num_outputs
        dim = next(iter(train_feats.values())).shape[1]
        net = self._build_net(dim, V)
        self._init_params(net)
        net.to(self.device)
        trainer = CtcTrainer(net, NnetTrainOptions(momentum=opts.momentum))
        velocity = init_velocity(net)
        # the recipe checkpoints no per-iteration model, so a newbob
        # schedule resumed from a dead run would drive a fresh init with
        # a stale iter/lr/halving state: always start clean
        stale = os.path.join(work_dir, "newbob_state.json")
        if os.path.exists(stale):
            logger.warning("removing stale newbob state %s (no model "
                           "checkpoint to resume with)", stale)
            os.remove(stale)
        sched = NewbobScheduler(
            work_dir, initial_lr=opts.learn_rate,
            opts=NewbobOptions(max_iters=opts.max_iters,
                               keep_lr_iters=opts.keep_lr_iters))

        tr_batches, cv_batches = self.batches(train_feats, train_texts)
        saddle = SaddleDetector(SaddleOptions(
            enabled=opts.auto_saddle,
            blank_thresh=opts.saddle_blank_thresh,
            escalate_iters=opts.saddle_escalate_iters,
            lr_factor=opts.saddle_lr_factor,
            max_lr=opts.saddle_max_lr))
        probe = [upload(b, self.device) for b in cv_batches[:2]]

        @torch.no_grad()
        def blank_fraction() -> float:
            net.eval()
            blanks = frames = 0.0
            for feats, _, _, _, mask in probe:
                y, _ = net(feats, mask=mask)
                blanks += float(((y.argmax(-1) == 0) * mask).sum())
                frames += float(mask.sum())
            return blanks / max(frames, 1.0)

        def snapshot() -> Dict[str, torch.Tensor]:
            return {k: v.detach().clone()
                    for k, v in net.state_dict().items()}

        best = snapshot()
        self.epochs: List[Dict] = []
        replay_rng = random.Random(777)
        while not sched.done:
            t0 = time.perf_counter()
            lr = sched.learn_rate
            order = list(range(len(tr_batches)))
            if self.epochs:
                replay_rng.shuffle(order)
            net.load_state_dict(best)
            velocity, rep = trainer.train_epoch(
                velocity, [tr_batches[i] for i in order], lr)
            cv = trainer.evaluate(cv_batches)
            blank = blank_fraction()
            hold = (saddle.update(blank, cv.avg_loss, sched)
                    if opts.auto_saddle else False)
            accepted = sched.report(cv.avg_loss, hold=hold)
            decision = "HOLD" if hold else (
                "ACCEPT" if accepted else "REJECT")
            logger.info("iter %d lr %.5f tr %.4f cv %.4f %s",
                        sched.state.iter, sched.learn_rate,
                        rep.avg_loss, cv.avg_loss, decision)
            if accepted:
                best = snapshot()
            self.epochs.append({
                "iter": sched.state.iter, "learn_rate": lr,
                "next_learn_rate": sched.learn_rate,
                "train_loss": rep.avg_loss, "cv_loss": cv.avg_loss,
                "blank_fraction": blank, "decision": decision,
                "train_batches": len(tr_batches),
                "cv_batches": len(cv_batches),
                "seconds": time.perf_counter() - t0})
        net.load_state_dict(best)
        net.eval()

        if grammar is None:
            words = sorted({w for t in train_texts.values() for w in t})
            grammar = make_unigram_grammar(
                {w: 1.0 / len(words) for w in words}, self.lang.words)
        tlg = make_ctc_decode_graph(self.lang, grammar)
        # acoustic_scale lives outside the decoder (the loglike matrix is
        # scaled instead), so one decoder serves the whole dev sweep
        if opts.decode_beam > 0:
            dec = BeamSearchDecoder(
                CsrGraph.from_packed(PackedGraph.from_fst(tlg)),
                ctc_lut(V), acoustic_scale=1.0, beam=opts.decode_beam,
                max_active=opts.decode_max_active, device=self.device)
        else:
            dec = ViterbiDecoder(PackedGraph.from_fst(tlg), ctc_lut(V),
                                 acoustic_scale=1.0, device=self.device)

        @torch.no_grad()
        def posteriors(feats: np.ndarray) -> np.ndarray:
            x = torch.from_numpy(np.ascontiguousarray(
                feats[:: opts.lfr_skip], np.float32))[None]
            y, _ = net(x.to(self.device))
            return torch.log_softmax(y[0], dim=-1).cpu().numpy()

        def decode_words(loglikes: np.ndarray, what: str) -> List[str]:
            try:
                words_out, _, _ = dec.decode(loglikes)
            except DecodeError as e:
                logger.warning("%s decode failed: %s", what, e)
                words_out = []
            return [self.lang.words.sym(w) for w in words_out]

        # posterior priors over the training set for Eesen-style
        # prior-divided decoding (unscaled base; the applied prior is
        # prior_scale * base, with prior_scale dev-swept when possible)
        prior_base = np.zeros(V, np.float32)
        if opts.prior_scale > 0 or dev_feats:
            acc = np.zeros(V, np.float64)
            n = 0
            for u in sorted(train_feats)[:200]:
                p = np.exp(posteriors(train_feats[u]))
                acc += p.sum(0)
                n += len(p)
            prior_base = np.log(
                np.maximum(acc / n, 1e-10)).astype(np.float32)

        chosen_a, chosen_p = opts.acoustic_scale, opts.prior_scale
        self.dev_wer = float("nan")
        if dev_feats:
            dev_logp = {u: posteriors(f) for u, f in dev_feats.items()}
            best_cfg = None
            for a_s in (0.7, 0.9, 1.1):
                for p_s in (0.5, 1.0):
                    hyps = {u: decode_words(
                        a_s * (dev_logp[u] - p_s * prior_base),
                        f"dev {u} (a={a_s:.1f} p={p_s:.1f})")
                        for u in sorted(dev_logp)}
                    st = score_utterances(dev_texts, hyps)
                    logger.info("dev sweep acoustic %.1f prior %.1f: "
                                "WER %.2f", a_s, p_s, st.wer)
                    if best_cfg is None or st.wer < best_cfg[0]:
                        best_cfg = (st.wer, a_s, p_s)
            self.dev_wer, chosen_a, chosen_p = best_cfg
            logger.info("dev-selected acoustic_scale %.1f prior_scale "
                        "%.1f (dev WER %.2f)", chosen_a, chosen_p,
                        self.dev_wer)
        self.acoustic_scale, self.prior_scale = chosen_a, chosen_p
        log_priors = (chosen_p * prior_base).astype(np.float32)

        # greedy CTC phone error rate first: a model-quality signal
        # independent of the decode graph and the LM
        hyp_ph, ref_ph = {}, {}
        test_logp = {}
        for u, feats in test_feats.items():
            logp = posteriors(feats)
            test_logp[u] = logp
            col = [int(x) for x in logp.argmax(-1)]
            dedup = [x for i, x in enumerate(col)
                     if x != 0 and (i == 0 or x != col[i - 1])]
            hyp_ph[u] = [str(x) for x in dedup]
            ref_ph[u] = [str(x) for x in self.phone_labels(test_texts[u])]
        per = score_utterances(ref_ph, hyp_ph)
        self.greedy_per = per.wer
        logger.info("greedy CTC PER %.2f%%", per.wer)

        hyps = {u: decode_words(chosen_a * (test_logp[u] - log_priors),
                                f"test {u}")
                for u in sorted(test_feats)}
        stats = score_utterances(test_texts, hyps)
        logger.info("%s", stats.report())
        # the trained system, for follow-on probes without retraining
        self.best_params = best
        self.net = net
        self.log_priors = log_priors
        self.tlg = tlg
        self.posteriors = posteriors
        # the final model persists (the reference keeps $dir/final.nnet);
        # newbob only checkpoints its own schedule state
        os.makedirs(work_dir, exist_ok=True)
        save_checkpoint(os.path.join(work_dir, "final.ckpt"), best,
                        model_states={"log_priors": log_priors},
                        meta={"greedy_per": float(per.wer),
                              "wer": float(stats.wer)})
        return stats

    def _build_net(self, input_dim: int, num_outputs: int) -> Nnet:
        opts = self.opts
        net = Nnet()
        dim = input_dim
        for _ in range(opts.num_layers):
            if opts.model_type == "blstm":
                net.add(BLstm(dim, 2 * opts.hidden_dim))
                dim = 2 * opts.hidden_dim
            else:
                net.add(Lstm(dim, opts.hidden_dim))
                dim = opts.hidden_dim
        net.add(AffineTransform(dim, num_outputs, param_stddev=0.04,
                                bias_mean=0.0, bias_range=0.0))
        return net

    def _init_params(self, net: Nnet) -> None:
        """Draw the initial parameters on the host from a generator
        seeded 777, the seed of the JAX recipe's ``PRNGKey(777)`` (the
        numbers differ: the two packages' generators are not the
        same)."""
        net.reset_parameters(torch.Generator().manual_seed(777))
