"""Hybrid NN-HMM training recipe: the run_dnn.sh / run_lstm.sh chain.

Port of kaldi_aslp_tpu/recipes/hybrid.py (reference:
aslp_scripts/aslp_nnet/run_dnn.sh, run_lstm.sh: prepare_feats_ali.sh
targets -> proto -> train_scheduler.sh newbob loop -> decode.sh with
aslp-nnet-forward | latgen-faster-mapped -> score_basic.sh).

Operates on in-memory (feats, transcripts) dicts + a Lang; stages:
  1. GMM bootstrap (mono) for alignments          [train_mono.sh]
  2. targets = ali->pdf, priors = analyze-counts  [prepare_feats_ali.sh]
  3. NN training with newbob accept/reject        [train_scheduler.sh]
  4. decode: nnet_forward - priors -> Viterbi/HCLG [decode.sh]
  5. WER                                           [score_basic.sh]

What differs from the JAX recipe, and why:
  - the GMM bootstrap, the network and the decoders run on ``device``
    (the card unless the caller asks for the CPU);
  - ``FrameTrainer`` trains the net in place, so the recipe keeps
    ``best`` as a cloned state dict and loads it before every epoch, as
    the JAX loop starts every epoch from ``best``; the cross-validation
    scores the epoch's new parameters and ``best`` moves only on
    acceptance, in the JAX order (:196-211);
  - the initial parameters come from a ``torch.Generator`` seeded 777,
    the seed of the JAX recipe's ``PRNGKey(777)`` (the numbers differ);
  - ``model_type="lstm"``: the JAX recipe hands its LSTM the
    randomizer's [N, D] frames, which the LSTM cannot unpack, so that
    route fails at its first step.  The port trains the LSTM on
    one-frame streams (``FrameTrainer``) and decodes it the same way,
    each frame a stream of its own, so training and decoding see the
    same network.

The run keeps what it trained for follow-on probes: ``net``, ``prior``,
``scores(feats)`` (an utterance's prior-subtracted log-posteriors),
``batches(utts, seed)``, the split ``tr_utts`` / ``cv_utts``, the
targets, the graph and ``epochs`` (each epoch's losses, decision and
seconds)."""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.data.randomizer import (
    FrameRandomizer,
    RandomizerOptions,
)
from kaldi_aslp_tpu_torch.decoder.beam import BeamSearchDecoder, CsrGraph
from kaldi_aslp_tpu_torch.decoder.decodable import (
    NnetForwardOptions,
    PdfPrior,
    nnet_forward,
    nnet_forward_batched,
)
from kaldi_aslp_tpu_torch.decoder.lattice import (
    generate_lattice,
    score_lmwt_sweep,
)
from kaldi_aslp_tpu_torch.decoder.viterbi import PackedGraph, ViterbiDecoder
from kaldi_aslp_tpu_torch.feats.functions import splice_frames
from kaldi_aslp_tpu_torch.fst import (
    Lang,
    make_decode_graph,
    make_unigram_grammar,
)
from kaldi_aslp_tpu_torch.fst.fst import Fst
from kaldi_aslp_tpu_torch.gmm.mono import MonophoneTrainer, MonoTrainOptions
from kaldi_aslp_tpu_torch.models import AffineTransform, Lstm, Nnet, Sigmoid
from kaldi_aslp_tpu_torch.ops.edit_distance import (
    ErrorStats,
    score_utterances,
)
from kaldi_aslp_tpu_torch.train import (
    FrameTrainer,
    NewbobOptions,
    NewbobScheduler,
    NnetTrainOptions,
    init_velocity,
    load_checkpoint,
    pretrain_layerwise,
    save_checkpoint,
)
from kaldi_aslp_tpu_torch.utils.config import Config
from kaldi_aslp_tpu_torch.utils.device import resolve_device
from kaldi_aslp_tpu_torch.utils.log import get_logger

logger = get_logger("hybrid")


@dataclasses.dataclass
class HybridRecipeOptions(Config):
    model_type: str = "dnn"      # dnn | lstm
    hidden_dim: int = 128
    num_layers: int = 2
    splice_context: int = 2      # DNN input splicing (frames each side)
    learn_rate: float = 0.008
    momentum: float = 0.9
    minibatch_size: int = 256
    max_iters: int = 10
    acoustic_scale: float = 0.2
    mono_iters: int = 8
    mono_totgauss: int = 100
    # lattice scoring sweep (reference: score_basic.sh LMWT grid);
    # empty = 1-best at acoustic_scale only
    lmwt_sweep: str = ""         # e.g. "1 2 4 7 10"
    lattice_beam: float = 8.0
    # layer-wise discriminative pretraining (pretrain.sh): epochs to
    # train at each depth before growing; 0 = off (random full-depth
    # init).  DNN only.
    pretrain_iters: int = 0
    pretrain_learn_rate: float = 0.008
    # > 0: decode with the beam-pruned lattice decoder at this beam
    # instead of the exact dense DP (the latgen-faster-mapped role)
    decode_beam: float = 0.0
    decode_max_active: int = 2048


class HybridRecipe:
    def __init__(self, lang: Lang,
                 opts: Optional[HybridRecipeOptions] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.lang = lang
        self.opts = opts or HybridRecipeOptions()
        self.device = resolve_device(device)

    def run(
        self,
        train_feats: Dict[str, np.ndarray],
        train_texts: Dict[str, List[str]],
        test_feats: Dict[str, np.ndarray],
        test_texts: Dict[str, List[str]],
        grammar: Optional[Fst] = None,
        work_dir: str = "exp_hybrid",
        bootstrap: Optional[tuple] = None,
        dev_feats: Optional[Dict[str, np.ndarray]] = None,
        dev_texts: Optional[Dict[str, List[str]]] = None,
    ) -> ErrorStats:
        """``bootstrap`` (pdf_targets, num_pdfs, hclg, lut) injects
        externally-produced alignments + decode graph (the reference
        trains its hybrid DNN on triphone alignments and decodes over the
        triphone HCLG, run_dnn.sh on exp/tri* ali dirs).

        ``dev_feats``/``dev_texts``: with ``lmwt_sweep``, the LMWT grid
        is swept on the dev set and the test set is scored once at the
        dev-selected LMWT; without them the sweep selects on test, which
        is what score_basic.sh itself does."""
        opts = self.opts
        hclg = lut = None
        self.last_dev_wer = float("nan")
        if bootstrap is not None:
            pdf_targets, num_pdfs, hclg, lut = bootstrap
            logger.info("external alignments: %d pdfs", num_pdfs)
        else:
            # 1. GMM bootstrap -> alignments
            mono = MonophoneTrainer(
                self.lang, opts=MonoTrainOptions(
                    num_iters=opts.mono_iters, totgauss=opts.mono_totgauss,
                    realign_iters=" ".join(
                        str(i) for i in range(1, opts.mono_iters))),
                device=self.device)
            am, tm = mono.train(train_feats, train_texts)
            alis = mono.align(am, train_feats, train_texts)
            logger.info("GMM bootstrap done: %d pdfs", tm.num_pdfs)
            num_pdfs = tm.num_pdfs
            pdf_targets = {u: tm.alignment_to_pdfs(a)
                           for u, a in alis.items()}
        self.pdf_targets, self.num_pdfs = pdf_targets, num_pdfs

        # 2. priors
        prior = PdfPrior.from_alignments(pdf_targets, num_pdfs)

        # 3. NN training
        dim = self._nn_feats(next(iter(train_feats.values()))[:1]).shape[1]
        utts = sorted(u for u in train_feats if u in pdf_targets)
        cv_utts = utts[: max(1, len(utts) // 10)]
        tr_utts = utts[len(cv_utts):]

        def batches(utt_list, seed):
            r = FrameRandomizer(RandomizerOptions(
                minibatch_size=opts.minibatch_size, randomizer_seed=seed))
            for u in utt_list:
                feats = self._nn_feats(train_feats[u])
                n = min(len(feats), len(pdf_targets[u]))
                r.feed(feats[:n], pdf_targets[u][:n])
                if r.full():
                    yield from r.iterate_minibatches()
            yield from r.flush()

        if (opts.pretrain_iters > 0 and opts.model_type == "dnn"
                and opts.num_layers > 1):
            net = self._pretrain(dim, num_pdfs, batches, tr_utts)
        else:
            net = self._build_net(dim, num_pdfs)
            net.reset_parameters(torch.Generator().manual_seed(777))
            net.to(self.device)
        velocity = init_velocity(net)
        trainer = FrameTrainer(net, NnetTrainOptions(momentum=opts.momentum))
        # a schedule state without its best-model checkpoint cannot be
        # resumed (fresh params + stale lr/halving state): drop it and
        # start clean
        stale = os.path.join(work_dir, "newbob_state.json")
        if os.path.exists(stale) and not os.path.exists(
                os.path.join(work_dir, "nnet_best.knet")):
            logger.warning("removing stale newbob state %s (no model "
                           "checkpoint to resume with)", stale)
            os.remove(stale)
        sched = NewbobScheduler(work_dir, initial_lr=opts.learn_rate,
                                opts=NewbobOptions(max_iters=opts.max_iters))

        def snapshot() -> Dict[str, torch.Tensor]:
            return {k: v.detach().clone()
                    for k, v in net.state_dict().items()}

        best = snapshot()
        # resume: the scheduler restores its state from work_dir marker
        # files; the accepted model comes back with it (the reference
        # reloads $dir/.mlp_best, train_scheduler.sh:96)
        if os.path.exists(sched.best_model_path):
            best, vel_ck, _, _ = load_checkpoint(sched.best_model_path)
            if vel_ck is not None:
                velocity = {k: v.to(self.device) for k, v in vel_ck.items()}
            logger.info("resumed best model from %s", sched.best_model_path)
        self.epochs: List[Dict] = []
        while not sched.done:
            t0 = time.perf_counter()
            lr = sched.learn_rate
            net.load_state_dict(best)
            velocity, rep = trainer.train_epoch(
                velocity, batches(tr_utts, sched.state.iter), lr)
            cv = trainer.evaluate(batches(cv_utts, 0))
            accepted = sched.report(cv.avg_loss)
            logger.info("iter %d lr %.5f tr %.4f cv %.4f acc %.1f%% %s",
                        sched.state.iter, sched.learn_rate, rep.avg_loss,
                        cv.avg_loss, cv.frame_accuracy,
                        "ACCEPT" if accepted else "REJECT")
            if accepted:
                best = snapshot()
                save_checkpoint(sched.best_model_path, best, velocity)
            self.epochs.append({
                "iter": sched.state.iter, "learn_rate": lr,
                "train_loss": rep.avg_loss, "train_frames": rep.frames,
                "cv_loss": cv.avg_loss, "cv_accuracy": cv.frame_accuracy,
                "decision": "ACCEPT" if accepted else "REJECT",
                "seconds": time.perf_counter() - t0})
        net.load_state_dict(best)
        net.eval()
        self.net, self.prior, self.batches = net, prior, batches
        self.tr_utts, self.cv_utts = tr_utts, cv_utts

        # 4. decode
        if hclg is None:
            if grammar is None:
                words = sorted({w for t in train_texts.values()
                                for w in t})
                grammar = make_unigram_grammar(
                    {w: 1.0 / len(words) for w in words}, self.lang.words)
            hclg = make_decode_graph(self.lang, grammar, tm)
            lut = tm.alignment_to_pdfs(np.arange(tm.num_transition_ids + 1))
        self.hclg, self.lut = hclg, lut
        packed = PackedGraph.from_fst(hclg)
        bdec = None
        if opts.decode_beam > 0:
            bdec = BeamSearchDecoder(
                CsrGraph.from_packed(packed), lut,
                acoustic_scale=opts.acoustic_scale, beam=opts.decode_beam,
                max_active=opts.decode_max_active, device=self.device)
        if opts.lmwt_sweep:
            return self._sweep(packed, lut, bdec, test_feats, test_texts,
                               dev_feats, dev_texts)
        dec = bdec or ViterbiDecoder(packed, lut,
                                     acoustic_scale=opts.acoustic_scale,
                                     device=self.device)
        hyps = {}
        for u, feats in test_feats.items():
            words_out, _, _ = dec.decode(self.scores(feats))
            hyps[u] = [self.lang.words.sym(w) for w in words_out]
        stats = score_utterances(test_texts, hyps)
        logger.info("%s", stats.report())
        return stats

    def _sweep(self, packed, lut, bdec, test_feats, test_texts, dev_feats,
               dev_texts) -> ErrorStats:
        """Lattice generation + LMWT grid (score_basic.sh), the LMWT
        selected on dev when a dev set is given."""
        opts = self.opts

        def lat_set(feats_set, texts_set):
            lats, refs = {}, {}
            for u, feats in feats_set.items():
                scores = self.scores(feats)
                if bdec is not None:
                    _, _, _, lats[u] = bdec.decode_lattice(
                        scores, lattice_beam=opts.lattice_beam)
                else:
                    lats[u] = generate_lattice(
                        packed, scores, lut,
                        acoustic_scale=opts.acoustic_scale,
                        beam=opts.lattice_beam, device=self.device)
                refs[u] = [self.lang.words.id(w) for w in texts_set[u]]
            return lats, refs

        lmwt_grid = [int(x) for x in opts.lmwt_sweep.split()]
        lats, refs = lat_set(test_feats, test_texts)
        if dev_feats:
            dev_lats, dev_refs = lat_set(dev_feats, dev_texts)
            dev_sweep = score_lmwt_sweep(dev_lats, dev_refs,
                                         lmwt_range=lmwt_grid,
                                         acoustic_scale_base=1.0)
            best_lmwt = min(dev_sweep, key=lambda k: dev_sweep[k].wer)
            self.last_dev_wer = dev_sweep[best_lmwt].wer
            logger.info("dev-selected LMWT %d (dev WER %.2f)", best_lmwt,
                        self.last_dev_wer)
            lmwt_grid = [best_lmwt]
        sweep = score_lmwt_sweep(lats, refs, lmwt_range=lmwt_grid,
                                 acoustic_scale_base=1.0)
        for lmwt, st in sweep.items():
            logger.info("LMWT %d: %s", lmwt, st.report())
        stats = min(sweep.values(), key=lambda st: st.wer)
        logger.info("best: %s", stats.report())
        return stats

    def scores(self, feats: np.ndarray) -> np.ndarray:
        """One utterance's decoder scores [T, P] from the trained net:
        log-posteriors minus log-priors (aslp-nnet-forward with
        --class-frame-counts).  An LSTM runs each frame as a stream of
        its own, as it trained."""
        x = self._nn_feats(feats)
        if self.opts.model_type == "lstm":
            return nnet_forward_batched(
                self.net, x[:, None], np.ones((len(x), 1), np.float32),
                NnetForwardOptions(), self.prior)[:, 0]
        return nnet_forward(self.net, x, NnetForwardOptions(), self.prior)

    def _pretrain(self, input_dim: int, num_pdfs: int, batches,
                  tr_utts) -> Nnet:
        """Layer-wise discriminative pretraining (reference:
        aslp_scripts/aslp_nnet/pretrain.sh: momentum 0, fixed lr, grow
        one [Affine, Sigmoid] block before the output layer per epoch
        with the output affine re-randomized)."""
        opts = self.opts

        def hidden_block(in_dim: int) -> List:
            return [AffineTransform(in_dim, opts.hidden_dim,
                                    param_stddev=0.1, bias_mean=0.0,
                                    bias_range=0.0),
                    Sigmoid(opts.hidden_dim, opts.hidden_dim)]

        initial = Nnet()
        for comp in hidden_block(input_dim):
            initial.add(comp)
        initial.add(AffineTransform(opts.hidden_dim, num_pdfs,
                                    param_stddev=0.04, bias_mean=0.0,
                                    bias_range=0.0))

        def hidden_factory(depth: int) -> Nnet:
            h = Nnet()
            for comp in hidden_block(opts.hidden_dim):
                h.add(comp)
            return h

        def train_fn(net: Nnet, depth: int) -> Nnet:
            net.to(self.device)
            trainer = FrameTrainer(net, NnetTrainOptions(momentum=0.0))
            velocity = init_velocity(net)
            for it in range(opts.pretrain_iters):
                velocity, rep = trainer.train_epoch(
                    velocity, batches(tr_utts, 1000 * depth + it),
                    opts.pretrain_learn_rate)
                logger.info("pretrain depth %d iter %d tr %.4f", depth, it,
                            rep.avg_loss)
            return net

        return pretrain_layerwise(initial, hidden_factory, opts.num_layers,
                                  train_fn,
                                  generator=torch.Generator().manual_seed(777))

    def _build_net(self, input_dim: int, num_pdfs: int) -> Nnet:
        opts = self.opts
        net = Nnet()
        dim = input_dim
        if opts.model_type == "dnn":
            for _ in range(opts.num_layers):
                net.add(AffineTransform(dim, opts.hidden_dim,
                                        param_stddev=0.1, bias_mean=0.0,
                                        bias_range=0.0))
                net.add(Sigmoid(opts.hidden_dim, opts.hidden_dim))
                dim = opts.hidden_dim
        elif opts.model_type == "lstm":
            for _ in range(opts.num_layers):
                net.add(Lstm(dim, opts.hidden_dim))
                dim = opts.hidden_dim
        else:
            raise ValueError(opts.model_type)
        net.add(AffineTransform(dim, num_pdfs, param_stddev=0.04,
                                bias_mean=0.0, bias_range=0.0))
        return net

    def _nn_feats(self, feats: np.ndarray) -> np.ndarray:
        """DNN input splicing (run_dnn.sh splice context), on the host."""
        if self.opts.model_type != "dnn" or not self.opts.splice_context:
            return feats
        c = self.opts.splice_context
        return splice_frames(torch.from_numpy(
            np.ascontiguousarray(feats, np.float32)), c, c).numpy()
