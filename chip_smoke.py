#!/usr/bin/env python3
"""Smoke run of the PyTorch port (kaldi_aslp_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits nonzero:
  1. device   - fail without CUDA; print the card, its power limit and
                the torch / CUDA versions;
  2. build    - compile the five CUDA sources of csrc/ with nvcc
                (sm_90a), one nvcc each, all at once;
  3. kernel   - hold the LSTMP inference kernel against its plain PyTorch
                version on the card at the flagship's widths (C=512,
                P=320) and the shapes of the served chunk, an offline
                utterance and a training batch, and at the LSTM hybrid's
                (C=800, P=512) and the shapes of its cross-validation
                run; the two-direction call (a BLSTMP layer in one
                launch) at the flagship's shapes too, which must equal two
                one-direction calls bit for bit; every call twice for the
                same bits; time each with CUDA events beside its plain
                version and beside the per-step kernels under a plan made
                here (the planned path must not be slower), and up to 4
                streams beside the few-stream sweep's barrier exchange;
                the plan and the sweeps' registers (from the -Xptxas -v
                log); a torch.profiler split of one call at the served
                chunk and at the hybrid's CV chunk, which must show one
                persistent sweep and no per-frame kernel; an
                earlier_times line with the per-step kernels' recorded
                time;
  4. slice    - serve the flagship BLSTM-CTC (3 x BLSTMP, C=512, P=320,
                40 fbank inputs, 72 CTC targets; random weights from a
                numpy seed; its CTC TLG built by the port's own graph
                builders, timed) through the port's online server, built by its
                CLI session factory with --device=cuda: 2 requests one
                after the other, then 2 at the same time; each must give
                partial events and one final event, and every chunk's
                network forward must have launched the kernel's
                two-direction entry 3 times (once a layer), on a
                persistent sweep and never the per-step kernels; then one
                warm session's 16-frame chunk timed by part (fbank + CMN,
                acoustic forward, Viterbi advance, backtrace);
  5. check    - one request's per-chunk acoustic scores from the card
                against the port on the CPU (plain versions);
 5b. serve-batched - 8 clients at once (the 4 serving utterances, each
                twice) through BatchedDecodeSessions sharing one
                AcousticBatcher at JAX's defaults over the flagship's
                batched eval forward: fewer calls than requests, every
                call 3 two-direction launches (S = B, persistent sweep),
                each final the unbatched server's for the same audio, one
                call's rows against their S = 1 forward (1e-4); the
                batched forward at B = 1..16 chunks of 16 frames (padded to
                32) timed beside B sequential S = 1 calls, and the kernel
                alone at S = B beside its plain version, its plan and its
                bound;
 5c. vad      - [silence, tone, silence, tone, silence] through the
                energy-VAD server's factory and the NN-VAD server's
                (--vad-nnet: a VAD net of the JAX recipe's topology, hand
                weights from a numpy seed, a JAX-format zip), both
                --device=cuda: at least 2 non-empty finals each, the VAD
                net run at least once a chunk with frames; its posteriors
                (1e-5) and speech masks (equal) on the card against the
                CPU's, and one utterance's online MFCC (1e-4);
 5d. punctuation - a CRF punctuation processor trained on the card; its
                log-likelihoods (1e-5) and Viterbi tags (equal) against
                the CPU; a punctuation= session's final against the
                processor's output on the unpunctuated final;
 5e. entry    - kaldi_aslp_tpu_torch.entry.entry() once: a finite
                [8, 200, 72] output from 3 launches, per_step 0;
  6. train-kernels - hold the BLSTMP training kernels (forward and
                backward) against their plain versions at C=512, P=320
                with ragged masks, a nonzero initial state and nonzero
                final-state cotangents, at (S, T, D) = (16, 200, 40),
                (16, 200, 640) and (128, 400, 640); time each beside its
                plain version; the CTC pair (alpha and beta in one launch)
                at (S, T, U, V) = (128, 400, 40, 72) with ragged lengths
                against its plain versions, twice for the same bits, timed
                by CUDA events, by torch.profiler (one warp kernel a call)
                and by its wrapper's host time, beside the wide kernel on
                the same inputs, and the port's whole ctc_loss forward and
                backward beside F.ctc_loss's (the library yardstick, both
                from the logits); then, at (128, 400, 640): the forward
                and backward run
                twice must give the same bits; the hoisted GEMM
                (bilstmp_gemm_bf16) at the five shapes of its products
                against its plain version, timed with its TFLOP/s beside
                torch.matmul on the same bf16 operands; each x-fused
                kernel's time split into its persistent sweep and its
                GEMMs by torch.profiler; the sweeps' launch plan and
                registers (from the -Xptxas -v log);
 6b. xg-train-kernels - hold the xg-fed BLSTMP training kernels (forward
                and backward) against their plain versions at C=512,
                P=320, (S, T) = (16, 200) and (128, 400), ragged masks, a
                nonzero initial state and final-state cotangents, with
                bf16 and with float32 products; at (128, 400) in both
                modes also: the forward and backward run twice must give
                the same bits, the per-step kernels timed beside the
                sweeps, each kernel's time split by torch.profiler into
                its persistent sweep (one launch a call), GEMMs (the
                backward's two, on the TMA kernel) and the rest, and the
                sweeps' plan and registers; then the per-direction
                x-fused backward for d = 0 and 1 at the shapes of phase 6,
                and the two halves against the fused backward on the same
                inputs (largest difference 0); time each beside its plain
                version;
  7. train    - write a Kaldi ark/scp corpus (16 utterances of 200-400
                frames and 10-40 labels, each 4 times) and train the bf16
                flagship on it through the CLI, aslp-nnet-train-ctc-streams
                --device=cuda, momentum 0.9: 4 steps on one batch of 16
                streams; every step must launch the BLSTMP training
                kernels 3 times each and the CTC pair once (on its warp
                kernel, never the wide one), the
                loss must be finite and fall, and the model it writes
                must load again;
  8. train-check - one step's loss and parameter gradients on the card
                against the port on the CPU (plain versions), 4 streams;
  9. step-split - one flagship train step at the bench's shape (S=128,
                T=400, U=40; bench.py:44) split into forward, loss,
                backward and update by CUDA events;
 9b. train-switches, train-switches-check, step-split again - phases 7,
                8 and 9 once under each of the JAX package's LSTM switches
                (KALDI_ASLP_LSTM_NO_XFUSE, _MXU_FP32, _SPLIT_BWD, set in
                os.environ around the run): each CLI step must launch the
                kernels of that switch's path (TRAIN_RUNS) and no other
                training kernel, on the persistent sweeps (no per-step
                kernel); a step_split_paths line puts the four paths'
                steps side by side;
 10. lstm-train-kernels - hold the unidirectional LSTMP training kernels
                (forward and backward) against their plain versions at the
                LSTM hybrid's widths (C=800, P=512) with ragged masks, a
                nonzero initial state and nonzero final-state cotangents:
                float32 at (S, T) = (16, 20), (100, 20), (128, 400), bf16
                at (100, 20), (128, 400), and bf16 storage with float32
                products (KALDI_ASLP_LSTM_MXU_FP32) at (100, 20), held
                strictly; time each beside its plain version; at
                (100, 20) float32 also: the forward and backward run
                twice must give the same bits, each kernel's time split
                by torch.profiler into its persistent sweep (one launch a
                call, no per-step kernel) and the rest (the backward's
                weight-gradient reductions), an earlier_times line with
                the per-step kernels' recorded times, and the sweeps'
                launch plan and registers (from the -Xptxas -v log); then
                the bf16 rounding check on one frame at
                (S, T) = (100, 1): the kernel's float32 outputs to the
                float32 tolerance, and few stored bf16 values that differ
                at all;
 11. bptt-train - write an ark/scp corpus of frame targets (a function of
                the features) and train the full-width LSTM hybrid (2 x
                LSTMP, C=800, P=512, 40 inputs, 3019 pdfs, float32; random
                weights from a numpy seed) through the CLI,
                aslp-nnet-train-lstm-streams --device=cuda, 16 streams of
                20-frame chunks, targets delay 5, momentum 0.9: every step
                must launch each training kernel twice (once per layer),
                on the persistent sweeps and never the per-step kernels,
                and the inference kernel never, the loss must be finite
                and its last quarter's mean below its first quarter's, and
                the model it writes must load again and differ from the
                initial one; then --cross-validate=true must leave the
                parameters unchanged, print FRAME_ACCURACY and launch the
                inference kernel twice per chunk, on a persistent sweep;
 12. bptt-check - one chunk's loss and parameter gradients on the card
                against the port on the CPU (plain versions), the same
                chunk's eval() outputs and loss (the cross-validation
                forward, on the inference kernel), and one float32 BLSTMP
                layer's gradients;
 13. bptt-step-split - one LSTM hybrid step at the reference's defaults
                (S=100, T=20) split into forward, loss, backward and
                update by CUDA events, with frames/s and peak memory;
 14. ctc-recipe - the phone-CTC recipe end to end on the card: the hard
                corpus at the ladder's "small" size (RECIPE_CORPUS,
                RECIPE_SIZES) synthesized on the host, its MFCC + deltas
                + per-speaker CMVN on the card (the test set held
                against the CPU), the bigram G from its ARPA text; the
                recipe at the ladder's full-scale model (3 x BLstm,
                C=320 a direction, 39 inputs, float32) and options, the
                beam decoder at beam 32 and 2048 tokens included, cut to
                2 iterations (RECIPE_OPTS): every loss evaluation
                (training step or CV batch) must launch the CTC pair once
                and nothing else a hand kernel, the second epoch's
                training loss must be below the first's, decoding the
                test set again must give the same WER, and final.ckpt
                must load with the best parameters; one step at the
                corpus's longest batch split by CUDA events with its
                kernel launches by torch.profiler; that step and one
                utterance's posteriors on the card against the CPU;
 15. beam     - the recipe's dev and test sets (BEAM_SETS) decoded by the beam
                decoder at the ladder's settings (beam 32, K=2048) on the
                card, each utterance held to the same decode on the CPU
                (the same words and alignment, the score within 1e-3
                relative) and timed; the test set at a wide beam with K
                past the graph's states held to the dense Viterbi's words
                on the card, both timed; one utterance's kernel launches
                a frame and device time by torch.profiler; no hand kernel
                may launch;
 15b. batched-decode - DECODE_BATCH_UTTS of the beam phase's utterances
                in batches of 8
                through BatchedBeamDecoder (beam 32, K=2048) and
                BatchedViterbiDecoder on the card, each utterance held to
                its single decode (words, alignment, score 1e-3), each
                batch timed beside the sequential decodes; one beam
                batch's launches a frame and busy share by torch.profiler;
                no hand kernel may launch;
 16. budget-sweep - the port's nn_budget_sweep on the same recipe (dev
                WER at K = 2048 and 256), each K timed;
 17. latgen   - Kaldi's offline chain on the flagship through the port's
                CLI, in process: 40-dim fbank of the 4 serving utterances,
                aslp-nnet-forward on the card (3 blstmp_forward launches an
                utterance, none per-step; the loglikes within 1e-3 of the
                CPU's), latgen-faster-mapped at its defaults (K = 7000,
                beam 16, lattice beam 8) on each utterance's first
                LATGEN_FRAMES frames, timed by part (frame loop, record
                prune, host build), its lattices equal to the CPU's to the
                bit, one decode's launches a frame and device busy share
                by torch.profiler; lattice-copy to text, lattice-scale,
                lattice-best-path (equal to latgen's words) and compute-wer
                against the dense Viterbi's words; lattice-determinize on
                the first DET_FRAMES frames, timed;
 18. lattice-score - decode_wer_dev_test on the first SCORE_UTTS of the
                beam phase's dev and test sets at the ladder's decode
                settings (beam 32, K = 2048, lattice beam 8, LMWT 4..15)
                on the card: the same lattices and WER at every LMWT as
                the CPU's, every lattice holding the decoder's best path,
                one decode's launches a frame.
                Both lattice phases run their CPU side in a child process
                beside the card's (lattice_cpu_child).
 19. hybrid   - the hybrid HMM/NN path on the card, no hand kernel
                launched in the whole phase: (a) the ladder's mono stage
                (hard_ladder --stages=mono at the small scale: 8
                iterations, 400 gaussians, realigned on 1 2 3 4 6) on
                phase 14's corpus (GMM_SETS of its test set, here and in
                20), its test and dev WER in JAX's band
                (10, 95), pruning_sensitivity on the first PRUNING_UTTS
                test utterances degraded >= healthy + 1, its final
                alignments equal frame for frame to the same run on the
                CPU in a child process (gmm_cpu_child, which goes on to
                the tri stage), one utterance's GMM loglikes within 1e-4
                relative of the CPU, one re-estimation's statistics the
                same bits twice, train, realignment, re-estimation and
                decode timed, one realignment pass profiled; (b)
                aslp-nnet-train-simple --device=cuda at build_dnn_hybrid's
                widths (440 inputs, 4 x 1024 Sigmoid, 3019 pdfs, random
                weights from a numpy seed) on an ark/scp corpus of frame
                targets, minibatch 256, pool 32768, one epoch: the loss's
                last quarter below its first, the written model loads and
                moved, --cross-validate=true moves nothing and prints
                FRAME_ACCURACY; one step split by CUDA events.
 20. tri      - the ladder's tri and dnn stages and the rest of the GMM
                family on the card, no hand kernel launched in the whole
                phase: (a) hard_ladder.train_tri on (19)'s mono system at
                the full preset's options (12 iterations, 4000 gaussians
                and 400 leaves asked, realigned on 2 4 6 8 10), its CD
                HCLG, dev and test decoded at beam 96, K = 8192, LMWT
                selected on dev, the WERs in JAX's band; its tree, its
                training and decode triples and its final alignments
                equal to the CPU child's; tree, training, realignment,
                re-estimation, graph and decode timed, one realignment
                pass profiled; (b) HybridRecipe on (a)'s final alignments
                and CD HCLG (bootstrap=, the ladder's dnn stage), the
                ladder's full-scale DNN (4 x 512 Sigmoid, 351 spliced
                inputs) and dnn-stage options (lr 0.2, acoustic scale
                0.1, LMWT sweep on dev, beam 32), 6 newbob iterations:
                the second epoch's loss below the first's, one
                minibatch's loss and gradients and one utterance's
                prior-subtracted scores within 1e-4 of the CPU, the test
                and dev WER in JAX's band, one epoch profiled; (c) the
                GMM family card against CPU (FAMILY_TOL) at the tri
                system's size: LDA + MLLT from the tri alignments,
                applied; one SAT outer iteration with the corpus's
                speakers (transforms, re-estimated means, the SAT
                objective raised); one EBW update; full-GMM loglikes of
                from_diag(tri model); a global GMM's init_from_feats +
                EM; the GMM VAD trained and run on (13)'s two-burst
                signal (two segments).
 21. ls_synth - the LibriSpeech-shaped recipe's own run() on the card at
                the flagship's full widths in bf16 (3 x BLSTMP, C=512,
                P=320, 64 streams, bucket 192, LFR 3): the x-fused pair
                3 launches each a training step and the CTC pair one a
                loss evaluation, blstmp_forward 3 a posteriors call and
                a CV batch, no per-step or wide kernel and no other hand
                kernel; newbob accepts an iteration after the first and
                the CV loss falls; one step's loss and gradients against
                the CPU's plain versions (the whole first batch), one
                utterance's posteriors within CROSS_CHECK_ATOL, the first
                test utterances' lattices equal to the CPU's decode of
                the card's loglikes (LS_DECODE_UTTS of the 100 test
                utterances are decoded and rescored, LS_SYNTH's newbob
                iterations of 48); the LS_SYNTH numbers, one step
                by part with its launches and device busy share;
 22. synth_recipes - the GMM-side recipes on the card at their small
                sizes: rm_synth, timit_synth (kmeans, TIMIT_TEST_UTTS test
                utterances), the GMM budget sweep on (14)'s corpus
                (SWEEP_SETS) at two K, yesno on YESNO_UTTS of
                its 60 utterances (its WER in JAX's band), rm_synth on
                RM_TEST_UTTS of its 15 test utterances, and the data-dir
                runner's hybrid pipeline on
                yesno's data dirs, each timed; every monophone training
                of the phase gives a CPU child's final alignments; no
                hand kernel launches.
 23. hkust_frontend - (a) the tonal syllable-CTC recipe's run() on the
                card at the medium preset's widths (1000 words, 24
                training speakers, harmonic source, MFCC + pitch + deltas
                = 48 inputs, a BLSTM of 160 cells a direction in 3
                layers, stock torch ops), cut in depth (HKUST): the CTC
                pair once a loss evaluation and no other hand kernel; its
                units, TLG, WER, greedy SER and seconds by part; (b) the
                first training utterances' features, one step on the
                whole first batch (loss 1e-4, gradients 1e-3) and
                compute_pitch_batched, Plp, Spectrogram, FeaturePipeline
                and sliding_window_cmn on corpus waves, card against CPU;
                (c) the feature CLI chain (MFCC, CMVN stats, CMVN,
                deltas, splice, feat-to-dim, fbank, copy, pitch,
                spectrum) on the card against --device=cpu; one step by
                part in a process started before the run.
 24. nnet-zoo - the latency-controlled BLSTM hybrid at the flagship's
                widths (3 x BLstmProjectedStreamsLC, C=512, P=320, chunk
                64, 40 inputs, float32, 3019 pdfs) from a proto through
                aslp-nnet-init, about 10 BPTT steps of
                aslp-nnet-train-blstm-streams-lc at the reader's 100
                streams x 20 frames (each step 6 lstmp_train_fwd and 6
                lstmp_train_bwd launches, per_step 0; a falling, finite
                loss; the model reloads), one step's loss and gradients
                against the CPU (the reader's first chunk), one step by
                part with its launches and busy share, and again with
                every layer's chunk at T (the same outputs without the
                backward direction's 44 pad frames: the padding's cost)
                (in a process started at the phase's start), and
                aslp-nnet-forward-blstm-lc on LC_FORWARD_UTTS utterances
                (6 lstmp_forward launches each, per_step 0, within
                LC_LL_ATOL of --device=cpu, ms an utterance); then a DAG
                of every other new component (zoo_net) forward and
                backward against the CPU and 2 steps of
                aslp-nnet-train-frame-mimo on it, with finite losses.
 25. kws-vad  - the VAD recipe (24 training and 8 test utterances: the
                energy VAD's frame scores, the GMM VAD's 16-gaussian
                float64 EM, the DNN VAD's 3 FrameTrainer epochs, the
                segments and TextGrid) and the KWS recipe (30 training
                utterances and their 30 simulated copies, 20 test
                utterances: a 64-wide phone DNN, 8 epochs, the spotter)
                at the JAX defaults on the card, initial weights from a
                numpy seed, against the same runs on the CPU in a child
                process started at the phase's start (apps_cpu_child):
                results and KWS confidences within APP_TOL, the GMM VAD's
                masks equal, segment.info, u0.TextGrid and keyword.fst.txt
                byte for byte; then the application CLI on their outputs,
                each tensor tool with --device=cuda against --device=cpu
                (aslp-nnet-forward on both nets, gmm-global-init-from-feats
                for silence and speech, aslp-apply-gmm-vad,
                aslp-eval-gmm-vad, aslp-apply-energy-vad) and the host
                tools against the recipes (aslp-kws-score,
                aslp-kws-evaluation-roc, aslp-apply-nn-vad,
                -nn-vad-segment, aslp-eval-vad, -vad-boundary,
                aslp-gen-textgrid, aslp-kws-gen-text-fst, aslp-fst-init,
                -info, -to-dot through a symbol table,
                aslp-kws-convert-phone-ali); aslp-kws-gen-state-map on
                phase 20's pickled tri model and tree (its files equal to
                the CPU child's); aslp-log-analyse on the run's training
                log (capture_progress: every ProgressLoss line of the
                earlier phases); one frame-training step of the KWS net
                by CUDA events and torch.profiler.
 26. distributed - two ranks in one group spawned by
                kaldi_aslp_tpu_torch/parallel/launch.py, sharing the card
                over gloo (the backend rule: NCCL refuses two ranks on one
                card), each loading phase 2's libraries: (a) the bf16
                flagship of phase 7 under BSP at DIST_STREAMS streams a
                rank (together the bench's S = 128, T = 400, U = 40) for
                DIST_STEPS steps, each rank launching bilstmp_train_fwd and
                _bwd 3 times a step and the CTC pair once (never wide), the
                two ranks' parameters the same bits after every step, the
                step-1 loss and gradients within CROSS_LOSS_RTOL /
                CROSS_GRAD_RTOL of one rank on all 128 streams here, then
                one BMUF round over 2 blocks x 1 rank of DIST_BMUF_INNER
                inner steps; each rank's step ms and one gloo all-reduce of
                the gradients (staged through the host: not a multi-card
                NCCL figure); (b) the full-width LSTM hybrid of phase 11
                through aslp-nnet-train-lstm-stream-worker run in each
                rank, once a worker type (bsp, sod with a momentum
                server optimizer, bmuf, easgd, asgd, masgd) on phase 11's
                corpus at DIST_WORKER_ARGS: exit 0,
                lstmp_train_fwd / _bwd launches on every rank with
                per_step 0, the written model reloads and moved, and its
                CV loss (aslp-nnet-train-simple --cross-validate) is
                finite and below the initial model's; (c) a small BN net
                with axis_name "data" under BSP, each rank's rows of the
                outputs and the averaged gradients against one rank on the
                whole batch (DIST_BN_RTOL); (d) the convergence task
                (make_hard_frame_task, seed 0) built on the card, then
                PARITY_ROUNDS rounds of bsp and asgd on PARITY_RANKS card
                ranks and, at the same time, on as many CPU ranks, both
                from the task built here and JAX's shipped initial
                parameters: the 11 held-out losses of each, their largest
                relative gap, which must lie within the CPU test's bound
                against JAX (PARITY_RTOL); then each subpackage imported
                and its count of public names.  The ranks' launches of
                (a)-(c) go into the kernels' records (runs "distributed"
                and "distributed_workers"); (d) runs no hand kernel.
The last lines are the kernels' JSON record (each kernel's launches in
the CLI runs, its error, its time and its plain version's, the least
time the card could take for its work and what binds it, and a PyTorch
call's time where one computes the same function), the card's name and
power limit as nvidia-smi prints them, and the result line.

Imports nothing of JAX and nothing of kaldi_aslp_tpu."""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from kaldi_aslp_tpu_torch.parallel.steps import (
    kernel_wrappers,
    train_kernel_wrappers,
)

KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)   # float32 both sides, summation
#                                          order differs, contractive cell
CROSS_CHECK_ATOL = 1e-3                    # log-domain scores, card vs CPU
C, P, FEAT_DIM, TARGETS, LAYERS = 512, 320, 40, 72, 3
# the LSTM hybrid (kaldi_aslp_tpu/models/flagship.py:build_lstm_hybrid)
HYBRID_C, HYBRID_P, HYBRID_PDFS, HYBRID_LAYERS = 800, 512, 3019, 2
# (S, T, D, C, P): the flagship's served chunk, an offline utterance of 4 s
# and training batches, then the hybrid's cross-validation chunks (16 and
# 100 streams of 20 frames, both layers' input widths)
KERNEL_SHAPES = [(1, 16, 40, C, P), (1, 16, 640, C, P), (1, 400, 640, C, P),
                 (8, 200, 640, C, P), (128, 400, 640, C, P)] + [
    (S, 20, D, HYBRID_C, HYBRID_P) for S in (16, 100)
    for D in (FEAT_DIM, HYBRID_P)]
# the rows at which both directions of a BLSTMP layer also run in one call
BI_KERNEL_SHAPES = [(1, 16, 640, C, P), (1, 400, 640, C, P),
                    (8, 200, 640, C, P), (128, 400, 640, C, P)]
# the rows whose call is profiled: one persistent sweep, no per-frame kernel
PROFILED_SHAPES = [(1, 16, 640, C, P), (100, 20, HYBRID_P, HYBRID_C, HYBRID_P)]
# one direction at the served chunk (S, T = 1, 16) with the earlier per-step
# kernels, two launches a frame, as PERF.md section 6 records it (an H100
# 80GB HBM3 at 700 W): logged beside this run's times, never in the kernel
# records
MS_PER_STEP_LSTMP_FORWARD = 0.2067
# training kernels: bf16 streams and products on both sides, summed in
# another order, so a stored bf16 value may land one step (2^-8 of
# itself) away and carry that through the recurrence; held relative to
# the largest |value| of each output
TRAIN_KERNEL_RTOL = 2e-2
TRAIN_SHAPES = [(16, 200, 40), (16, 200, 640), (128, 400, 640)]
CTC_SHAPE = (128, 400, 40, 72)        # S, T, U, V (bench.py:44)
CTC_TOL = dict(rtol=1e-4, atol=1e-4)  # float32 recursions
# the port's summed CTC loss against F.ctc_loss's on the same logits:
# float32 recursions on both sides, summed in another order
CTC_LOSS_RTOL = 1e-4
TRAIN_STREAMS, TRAIN_STEPS = 16, 4
# card vs CPU, one step: loss relative; gradients relative to each
# parameter's largest |gradient| (bf16 products through three layers)
CROSS_LOSS_RTOL, CROSS_GRAD_RTOL = 1e-3, 5e-2
SAMPLE_RATE = 16000
CHUNK_BYTES = 2 * SAMPLE_RATE // 4        # 250 ms of int16 PCM
# (S, T, bf16): float32 at the CLI's, the reference's default and the
# bench's shape, bf16 at the last two
LSTM_TRAIN_SHAPES = [(16, 20, False), (100, 20, False), (128, 400, False),
                     (100, 20, True), (128, 400, True)]
# relative to each output's largest |value|: float32 mode, TF32 off,
# summed in another order; bf16 mode as TRAIN_KERNEL_RTOL
LSTM_F32_RTOL, LSTM_BF16_RTOL = 1e-4, 2e-2
# The bf16 rounding check, on one frame: the kernel's float32 outputs
# (d_init_c, d_init_r) to LSTM_F32_RTOL, and at most LSTM_BF16_SHARE of a
# bf16 output's values may differ at all.  Over many frames it cannot
# hold: where the two sides' float32 sums differ in the last bit, a bf16
# product operand rounds the other way, and the recurrence spreads that.
# The weight reductions (LSTM_REDUCTIONS) are the same torch code on both
# sides, fed the stored bf16 dxg, so one such flip moves them by a bf16
# step of one term: they keep LSTM_BF16_RTOL.  On one frame a version
# that skips the bf16 rounding of the product operands lands 1.7e-3 or
# more away in d_init_c and d_init_r and changes 9-27 % of the stored
# values (the plain version with that fault, on the CPU)
LSTM_ROUNDING_SHAPE, LSTM_BF16_SHARE = (100, 1), 1e-2
LSTM_REDUCTIONS = ("d_w_gifo_r", "d_w_r_m", "dpeep")
BPTT_STREAMS, BPTT_UTTS = 16, 48
BPTT_ARGS = [f"--num-streams={BPTT_STREAMS}", "--batch-size=20",
             "--targets-delay=5"]
# card vs CPU, one float32 chunk: loss relative; gradients relative to
# each parameter's largest |gradient|; the eval() outputs relative to
# their largest |value|
BPTT_LOSS_RTOL, BPTT_GRAD_RTOL, BPTT_EVAL_RTOL = 1e-4, 1e-3, 1e-4
BPTT_SPLIT_SHAPE = (100, 20)   # the reference's num_stream, batch_size
# the JAX package's LSTM switches (kaldi_aslp_tpu_torch/ops/switches.py)
SWITCHES = ("KALDI_ASLP_LSTM_NO_XFUSE", "KALDI_ASLP_LSTM_MXU_FP32",
            "KALDI_ASLP_LSTM_SPLIT_BWD")
# the CTC CLI's launches per step on each path (None: no switch set);
# every other training kernel launches no time, the CTC pair once
TRAIN_RUNS = {
    None: {"bilstmp_train_fwd": LAYERS, "bilstmp_train_bwd": LAYERS},
    SWITCHES[0]: {"bilstmp_xg_train_fwd": LAYERS,
                  "bilstmp_xg_train_bwd": LAYERS},
    SWITCHES[1]: {"bilstmp_xg_train_fwd": LAYERS,
                  "bilstmp_xg_train_bwd": LAYERS},
    SWITCHES[2]: {"bilstmp_train_fwd": LAYERS,
                  "bilstmp_train_bwd_dir": 2 * LAYERS}}
# the xg-fed kernels at TRAIN_SHAPES without D (they never see x)
XG_SHAPES = sorted({(S, T) for S, T, _ in TRAIN_SHAPES})
# the bench's shape, where the xg-fed sweeps are profiled, run twice for
# the same bits and timed beside the per-step kernels
XG_SWEEP_SHAPE = XG_SHAPES[-1]
# the per-step kernels of the xg-fed and unidirectional training pairs
PER_STEP_KERNELS = ("fwd_cell_kernel", "fwd_proj_kernel", "bwd_cell_kernel",
                    "bwd_dr_kernel")
# With float32 products only the storage rounds to bf16 and no rounded
# value feeds the recurrence, so a stored value differs only where the
# float32 sums (summed in another order) put it on a rounding boundary:
# bf16 values within one bf16 step of the largest value (2^-8 < 4e-3) and
# at most XG_BF16_SHARE of them differing at all, the kernel's float32
# outputs within LSTM_F32_RTOL, the dW_r / dW_rm reductions fed those
# bf16 streams within 1e-3.  A kernel that rounded its product operands
# to bf16 lands about 1e-2 away.
XG_F32_RTOL = {"bf16": 4e-3, "kernel_f32": LSTM_F32_RTOL, "reduction": 1e-3}
XG_BF16_SHARE = 1e-2
# bf16 storage with float32 products for the unidirectional kernels
# (KALDI_ASLP_LSTM_MXU_FP32 on a bf16 LSTMP), held as the rounding check
LSTM_F32_PRODUCTS_SHAPE = (100, 20)
# Published peaks of one H100 SXM at its full 700 W power limit (NVIDIA's
# data sheet, dense): bf16 tensor-core products, float32 FMA outside the
# tensor cores, HBM3 bandwidth
PEAK_BF16, PEAK_F32, HBM_BYTES_PER_S = 989e12, 67e12, 3.35e12
# the hoisted GEMM against its plain version: exact bf16 products, float32
# sums over K up to S * T = 51,200 in another order; relative to the
# largest |value|
GEMM_RTOL = 1e-4
# the x-fused kernels' times at (128, 400, 640) with their earlier
# per-step kernels, as PERF.md section 6 records them (an H100 80GB HBM3 at
# 700 W): logged on a line of their own beside the times this run measures,
# never in the kernel records
MS_PER_STEP_KERNELS = {"bilstmp_train_fwd": 83.11,
                       "bilstmp_train_bwd": 160.2,
                       "bilstmp_train_bwd_dir": 91.88}
# the unidirectional pair's times at (S, T) = (100, 20) float32 with its
# earlier per-step kernels (two launches a frame each way), as PERF.md
# section 6 records them (an H100 80GB HBM3 at 700 W): logged beside this
# run's times, never in the kernel records
MS_PER_STEP_LSTM = {"lstmp_train_fwd": 2.509, "lstmp_train_bwd": 4.406}
# the CTC recipe (phase 14): the hard corpus at the ladder's "small" size
# (kaldi_aslp_tpu/recipes/hard_ladder.py:82-87) and its BLSTM-CTC model at
# full scale (:130-132) with the ladder's options (:298-303, the beam
# decoder at beam 32 and the recipe's 2048 tokens), cut to 2 iterations
RECIPE_CORPUS = dict(num_words=100, num_train_speakers=8,
                     num_test_speakers=3, num_dev_speakers=3)
RECIPE_SIZES = dict(num_train=60, num_test=20, num_dev=12, lm_pool_mult=8)
RECIPE_OPTS = dict(model_type="blstm", hidden_dim=320, num_layers=3,
                   learn_rate=0.06, auto_saddle=True, lfr_skip=3,
                   num_streams=16, acoustic_scale=0.9, max_iters=2,
                   decode_beam=32.0, decode_max_active=2048)
# the beam phases (15, 16): the card's decode against the CPU's, the score
# relative (float32 adds in the same order on both sides); the wide beam
# that holds the beam decoder to the dense Viterbi; the sweep's budgets,
# the largest and the smallest of kaldi_aslp_tpu/recipes/
# decode_budget_sweep.py:97's (1024 and 512 cut for phase 20's time)
BEAM_SCORE_RTOL = 1e-3
WIDE_BEAM = 1e9
BUDGETS = (2048, 256)
# the lattice phases (17, 18): the flagship chain's utterances (the serving
# phase's synthesized audio, forwarded whole), the frames of each that
# latgen-faster-mapped and the lattice tools take (random weights give
# nearly flat posteriors: about 7,000 lattice arcs a frame at the tool's
# defaults, and the host build, text copy and CPU check cost about 0.3 s
# a frame on the CPU), and the frames lattice-determinize takes (the
# subset construction's states grow exponentially with the frames: 8,531
# at 8 frames on a random-posterior lattice); the recipe's lattice beam
# and LMWT sweep
LATGEN_UTTS = 4
LATGEN_FRAMES = 32
DET_FRAMES = 6
LATTICE_BEAM = 8.0
LMWT_RANGE = range(4, 16)
# utterances of each set (by name) the lattice-score phase decodes: 8 of
# dev's 12 and of test's 20 (all of them cut for phase 20's time), then 4
# for phase 23's, then 2 for phase 25's
SCORE_UTTS = 2
# card vs CPU: MFCC + deltas + CMVN as the fbank tests hold them; a
# training step's loss relative and gradients relative to each
# parameter's largest |gradient| (float32, TF32 off); log posteriors
RECIPE_FEAT_TOL = dict(rtol=1e-4, atol=1e-4)
RECIPE_LOSS_RTOL, RECIPE_GRAD_RTOL, RECIPE_POST_ATOL = 1e-4, 1e-3, 1e-4
RECIPE_SPLIT_REPS = 5
# phase 26 (distributed): two ranks share the card over gloo; the flagship
# under BSP at DIST_STREAMS streams a rank (the bench's S = 128 over the
# two) for DIST_STEPS steps, then one BMUF round of DIST_BMUF_INNER inner
# steps; the LSTM hybrid through aslp-nnet-train-lstm-stream-worker, each
# worker type on phase 11's corpus (48 utterances, 5,000-odd frames) at
# DIST_WORKER_ARGS (a sync every 2 minibatches) with its own extra flags;
# a small BN net with axis_name "data" (DIST_BN widths, DIST_BN_FRAMES
# rows) under BSP.  Card against one rank on the whole batch: the flagship
# at the CTC bf16 step bounds (CROSS_LOSS_RTOL, CROSS_GRAD_RTOL), the BN
# net's outputs and gradients at DIST_BN_RTOL (float32, TF32 off, sums in
# another order), relative to each tensor's largest |value|
DIST_RANKS, DIST_STREAMS, DIST_STEPS, DIST_BMUF_INNER = 2, 64, 2, 2
DIST_WORKER_ARGS = ["--minibatch-size=256", "--sync-period=512",
                    "--learn-rate=0.02"]
DIST_WORKERS = {"bsp": [], "sod": ["--server-optimizer=momentum"],
                "bmuf": [], "easgd": [], "asgd": [],
                "masgd": ["--masgd-momentum=0.5"]}
DIST_BN = (FEAT_DIM, 64, 8)
DIST_BN_FRAMES, DIST_BN_RTOL = 256, 1e-4
# (d): the held-out losses of PARITY_ROUNDS rounds, card ranks against CPU
# ranks, within tests/test_torch_convergence_jax.py's bound against JAX:
# 1e-5 relative, and for ASGD (a server that adds the W workers' deltas in
# turn) 1e-5 + R W u, u = 2^-24
PARITY_RANKS, PARITY_ROUNDS = 2, 10
PARITY_RTOL = {"bsp": 1e-5,
               "asgd": 1e-5 + PARITY_ROUNDS * PARITY_RANKS * 2.0 ** -24}


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def uniform(rs, *shape, scale=0.1):
    """The LSTMP init distribution (uniform in [-param_scale, param_scale],
    kaldi_aslp_tpu/models/recurrent.py:init_params)."""
    return (scale * (2.0 * rs.rand(*shape) - 1.0)).astype(np.float32)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


@contextlib.contextmanager
def switch_env(switch):
    """A context in which one of SWITCHES is set (None: none is), the
    environment restored after."""
    saved = {k: os.environ.pop(k) for k in SWITCHES if k in os.environ}
    if switch:
        os.environ[switch] = "1"
    try:
        yield
    finally:
        for k in SWITCHES:
            os.environ.pop(k, None)
        os.environ.update(saved)


# -- the least time the card could take ---------------------------------------
#
# bound_ms is the larger of the operations over the card's peak rate for
# their operand type and the bytes over its memory rate, counting each
# input the function takes read once and each output it returns written
# once (the roofline).  Below, G = 4C; FLOP
# counts two per multiply-add of the products; the cell's elementwise
# math is left out (a few tens of operations per cell and frame).

def bound(ops, nbytes):
    """(ms, "operations" or "bytes") for ``ops`` [(flop, peak), ...]."""
    ops_s = sum(f / peak for f, peak in ops)
    bytes_s = nbytes / HBM_BYTES_PER_S
    return (1e3 * max(ops_s, bytes_s),
            "operations" if ops_s >= bytes_s else "bytes")


def lstmp_forward_bound(S, T, C, P, directions=1, valid=None):
    # per direction in: xg [S, T, G], W_r [G, P], W_rm [P, C], peep [3, C];
    # out: its columns of ys [S, T, P]; once: mask, c0, r0 in, c_T, r_T
    # out; all float32.  Per direction, valid frame and stream r_prev .
    # W_r^T and m . W_rm^T: 2 (GP + PC) float32 FLOP; ``valid`` is the
    # mask's count of valid stream-frames (S T when None): a padded frame
    # only holds the carry
    G = 4 * C
    valid = S * T if valid is None else valid
    nbytes = 4 * (directions * (S * T * (G + P) + G * P + P * C + 3 * C)
                  + S * T + 2 * S * (C + P))
    return bound([(directions * 2 * valid * (G * P + P * C), PEAK_F32)],
                 nbytes)


def bilstmp_fwd_bound(S, T, D, C, P):
    # in: x [S, T, D], W_x [2, G, D], W_r [2, G, P], W_rm [2, P, C] bf16,
    # mask, peep [2, 3, C], bias [2, G], init_c, init_r f32; out: ys
    # [S, T, 2P], gates [2, S, T, G], cs [2, S, T, C], rprev [2, S, T, P]
    # bf16, c_T, r_T f32.  Per direction, frame and stream x . W_x^T,
    # r_prev . W_r^T, m . W_rm^T: 2 (GD + GP + PC) FLOP on bf16 operands
    G = 4 * C
    nbytes = (2 * (S * T * D + 2 * (G * D + G * P + P * C))
              + 4 * (S * T + 2 * (3 * C + G) + 2 * S * (C + P))
              + 2 * (S * T * 2 * P + 2 * S * T * (G + C + P)))
    return bound([(2 * 2 * S * T * (G * D + G * P + P * C), PEAK_BF16)],
                 nbytes)


def bilstmp_bwd_bound(S, T, D, C, P, dirs=2):
    # in (per direction but x, mask and the state cotangents): dy
    # [S, T, P], x [S, T, D], gates [S, T, G], cs [S, T, C], rprev
    # [S, T, P], W_x, W_r, W_rm bf16, mask, peep, init_c, d_c_T, d_r_T
    # f32; out: dx [S, T, D] bf16, d_init_c, d_init_r, dW_x, dW_r, dW_rm,
    # dbias, dpeep f32.  Per direction, frame and stream the sweep's
    # dr_new . W_rm and dgates . W_r, then dx, dW_x, dW_r, dW_rm:
    # 2 (PC + GP + 2GD + GP + PC) FLOP on bf16 operands
    G = 4 * C
    nbytes = (2 * (dirs * S * T * (P + G + C + P) + S * T * D
                   + dirs * (G * D + G * P + P * C) + S * T * D)
              + 4 * (S * T + dirs * 3 * C + 2 * S * C + S * P
                     + S * (C + P)
                     + dirs * (G * D + G * P + P * C + G + 3 * C)))
    flop = dirs * 2 * S * T * (2 * P * C + 2 * G * P + 2 * G * D)
    return bound([(flop, PEAK_BF16)], nbytes)


def xg_fwd_bound(S, T, C, P, mxu_bf16):
    # in: xgf, xgb [S, T, G] bf16, mask, W_r [2, G, P], W_rm [2, P, C],
    # peep, bias, init_c, init_r f32; out: ys, gates, cs, rprev bf16, c_T,
    # r_T f32.  Per direction, frame and stream 2 (GP + PC) FLOP on bf16
    # or float32 operands
    G = 4 * C
    nbytes = (2 * 2 * S * T * G
              + 4 * (S * T + 2 * (G * P + P * C + 3 * C + G)
                     + 2 * S * (C + P))
              + 2 * (S * T * 2 * P + 2 * S * T * (G + C + P)))
    return bound([(2 * 2 * S * T * (G * P + P * C),
                   PEAK_BF16 if mxu_bf16 else PEAK_F32)], nbytes)


def xg_bwd_bound(S, T, C, P, mxu_bf16):
    # in: dy [S, T, 2P], gates, cs, rprev bf16, mask, W_r, W_rm, peep,
    # init_c, d_c_T, d_r_T f32; out: dxg [2, S, T, G] bf16, d_init_c,
    # d_init_r, dW_r, dW_rm, dbias, dpeep f32.  Per direction, frame and
    # stream the sweep's 2 (PC + GP) FLOP on bf16 or float32 operands and
    # the dW_r, dW_rm reductions' 2 (GP + PC) on bf16 values
    G = 4 * C
    nbytes = (2 * (S * T * 2 * P + 2 * S * T * (G + C + P))
              + 4 * (S * T + 2 * (G * P + P * C + 3 * C) + 2 * S * C
                     + S * P)
              + 2 * 2 * S * T * G
              + 4 * (S * C + S * P + 2 * (G * P + P * C + G + 3 * C)))
    flop = 2 * 2 * S * T * (P * C + G * P)
    return bound([(flop, PEAK_BF16 if mxu_bf16 else PEAK_F32),
                  (flop, PEAK_BF16)], nbytes)


def lstmp_train_bound(kind, S, T, C, P, bf16):
    # fwd in: xg [S, T, G], mask, W_r, W_rm, peep, init_c, init_r; out:
    # gates [T, S, G], cs, rs.  bwd in: dy [S, T, P], mask, gates, cs, rs,
    # W_r, W_rm, peep, init_c, init_r, d_c_T, d_r_T; out: dxg, d_init_c,
    # d_init_r, dW_r, dW_rm, dpeep.  Streams in the storage type (4 or 2
    # bytes), the rest f32.  fwd: 2 (GP + PC) FLOP per frame and stream;
    # bwd: the sweep's 2 (PC + GP) and the reductions' 2 (GP + PC)
    G, st = 4 * C, 2 if bf16 else 4
    peak = PEAK_BF16 if bf16 else PEAK_F32
    weights = 4 * (G * P + P * C + 3 * C)
    flop = 2 * S * T * (G * P + P * C)
    if kind == "fwd":
        nbytes = (st * S * T * (2 * G + C + P) + 4 * S * T + weights
                  + 4 * S * (C + P))
        return bound([(flop, peak)], nbytes)
    nbytes = (st * S * T * (P + 2 * G + C + P) + 4 * S * T + 2 * weights
              + 4 * 2 * S * (C + P) + 4 * S * (C + P))
    return bound([(flop, peak), (flop, peak)], nbytes)


def ctc_bound(T, S, Up, input_lengths):
    # the pair in one launch.  in: lp_t [T, S, U'] and skip_ok [S, U'] f32,
    # the two length vectors; out: alphas and betas [T, S, U'] f32.  Per
    # recursion step of a stream (len - 1 of them each way) and state a
    # three-way log-sum-exp plus the emission: about 12 float32 operations
    steps = 2 * int(np.maximum(np.asarray(input_lengths) - 1, 0).sum())
    return bound([(12 * steps * Up, PEAK_F32)],
                 4 * (3 * T * S * Up + S * Up + 2 * S))


# -- phase 3 -----------------------------------------------------------------

def kernel_phase(dev):
    import dataclasses

    from kaldi_aslp_tpu_torch.ops import build
    from kaldi_aslp_tpu_torch.ops import lstmp as lp
    from kaldi_aslp_tpu_torch.ops import sweep_plan as sp

    results = []
    for S, T, D, C_, P_ in KERNEL_SHAPES:
        rs = np.random.RandomState(S * 1000 + T + D + C_)

        def t(a):
            return torch.from_numpy(a).to(dev)
        x = t(rs.randn(S, T, D).astype(np.float32))
        lens = np.full(S, T)
        if S > 1:
            lens = rs.randint(T // 4, T + 1, size=S)
            lens[0] = T
        mask = t((np.arange(T)[None, :] < lens[:, None]).astype(np.float32))
        xgs, weights = [], []
        for _ in range(2):      # direction f, then b
            w_x, bias = t(uniform(rs, 4 * C_, D)), t(uniform(rs, 4 * C_))
            xgs.append((torch.matmul(x, w_x.t()) + bias).contiguous())
            weights.append((t(uniform(rs, 4 * C_, P_)),
                            t(uniform(rs, P_, C_)), t(uniform(rs, 3, C_))))
        c0 = t(uniform(rs, S, C_, scale=0.5))
        r0 = t(uniform(rs, S, P_, scale=0.5))
        one = (xgs[0], mask, *weights[0], c0, r0)
        two = (*xgs, mask, *weights, c0, r0)
        calls = [(1, lambda: lp.lstmp_forward(*one),
                  lambda: lp.lstmp_forward_reference(*one))]
        if (S, T, D, C_, P_) in BI_KERNEL_SHAPES:
            calls.append((2, lambda: lp.blstmp_forward(*two),
                          lambda: lp.blstmp_forward_reference(*two)))
        for directions, kernel, plain in calls:
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
            for name, g, w in zip(("ys", "c_T", "r_T"), got, want):
                if not torch.isfinite(g).all():
                    raise RuntimeError(
                        f"kernel {name} not finite at {S, T, D, directions}")
                torch.testing.assert_close(g, w, **KERNEL_TOL)
            again = kernel()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise RuntimeError(
                    f"two runs differ at {S, T, D, directions}")
            if directions == 2:
                # the same bits as two one-direction calls and the flips
                y_f, c_f, r_f = lp.lstmp_forward(*one)
                y_b, _, _ = lp.lstmp_forward(
                    torch.flip(xgs[1], (1,)).contiguous(),
                    torch.flip(mask, (1,)).contiguous(), *weights[1],
                    torch.zeros_like(c0), torch.zeros_like(r0))
                torch.cuda.synchronize()
                halves = (torch.cat([y_f, torch.flip(y_b, (1,))], dim=-1),
                          c_f, r_f)
                if not all(torch.equal(a, b) for a, b in zip(got, halves)):
                    raise RuntimeError(
                        "the two-direction call differs from two "
                        f"one-direction calls at {S, T, D}")
            del got, want, again
            plan = lp.plan_for(S, C_, P_, directions, dev)
            if not plan.persistent:
                raise RuntimeError(f"{S, C_, P_, directions} took the "
                                   f"per-step kernels: {plan.reason}")
            launch_args = (xgs[:directions], mask, weights[:directions], c0,
                           r0, 50.0)
            # the same C entry under other plans, made here: the per-step
            # kernels, and up to FEW_TAG_STREAMS streams the few-stream
            # sweep's barrier exchange
            per_step = sp.lstmp_infer_per_step(
                S, C_, P_, directions, "timed beside the planned path")
            others = {"per_step": per_step}
            if plan.exchange == sp.TAGS:
                others["barrier"] = dataclasses.replace(
                    plan, exchange=sp.BARRIER)
            for other in others.values():
                alt = lp._launch(other, *launch_args)
                ref = plain()
                torch.cuda.synchronize()
                for g, w in zip(alt, ref):
                    torch.testing.assert_close(g, w, **KERNEL_TOL)
                del alt, ref
            reps = 20 if S * T <= 3200 else 5
            ms = cuda_ms(kernel, reps)
            other_ms = {k: cuda_ms(lambda: lp._launch(other, *launch_args),
                                   reps) for k, other in others.items()}
            plain_ms = cuda_ms(plain, 3, 1)
            bound_ms, bound_by = lstmp_forward_bound(S, T, C_, P_, directions)
            row = {"S": S, "T": T, "D": D, "C": C_, "P": P_,
                   "directions": directions, "max_abs_err": max(errs),
                   "ms": ms, "plain_ms": plain_ms,
                   "per_step_ms": other_ms["per_step"],
                   "barrier_exchange_ms": other_ms.get("barrier"),
                   "us_per_frame": 1e3 * ms / T, "bound_ms": bound_ms,
                   "bound_by": bound_by, "regime": plan.regime,
                   "exchange": plan.exchange,
                   "blocks": directions * plan.blocks_per_dir,
                   "cells_per_block": plan.cells_per_block,
                   "cols_per_block": plan.cols_per_block,
                   "ring_stages": plan.stages, "smem_bytes": plan.smem}
            results.append(row)
            log("kernel", name="lstmp_forward" if directions == 1
                else "blstmp_forward", **row, err_ys=errs[0], err_c=errs[1],
                err_r=errs[2], tol=KERNEL_TOL, identical_twice=True)
            if ms > other_ms["per_step"]:
                raise RuntimeError(
                    f"the planned path ({ms} ms) is slower than the "
                    f"per-step kernels ({other_ms['per_step']} ms) at "
                    f"{S, T, D, C_, P_, directions}")
            if (S, T, D, C_, P_) in PROFILED_SHAPES:
                # one call is one persistent kernel
                counts = {}
                by_kernel = device_ms_by_kernel(kernel, counts)
                sweeps = sum(n for k, n in counts.items()
                             if "sweep_kernel" in k)
                per_frame = [k for k in counts if "step_cell_kernel" in k
                             or "step_proj_kernel" in k]
                log("kernel_profile", S=S, T=T, C=C_, P=P_,
                    directions=directions, by_kernel_ms=by_kernel,
                    launches=counts)
                if sweeps != 1 or per_frame:
                    raise RuntimeError(
                        f"a call at {S, T, C_, P_, directions} is not one "
                        f"persistent sweep: {counts}")
    served = {r["directions"]: r["ms"] for r in results
              if (r["S"], r["T"], r["D"]) == (1, 16, 2 * P)}
    log("earlier_times", recorded_in="PERF.md section 6, the earlier "
        "per-step kernels through the wrapper of that time, not measured "
        "in this run", S=1, T=16, one_direction_ms=MS_PER_STEP_LSTMP_FORWARD,
        measured_ms={"one_direction": served[1], "two_directions": served[2]})
    log_text = build.library_path(lp.SOURCE).with_suffix(".log").read_text()
    log("infer_sweeps", threads=sp.FWD_THREADS, registers={
        k: ptxas_registers_all(log_text, k)
        for k in ("lstmp_few_sweep_kernel", "lstmp_infer_sweep_kernel")})
    call_split(dev)
    return results


def call_split(dev):
    """Where a served call's time goes, for one direction and two at
    S = 1, C = 512, P = 320: the sweep's device time at T = 16 and at T = 1
    (the launch, the weight fill and one frame: the call's fixed part on
    the card) by torch.profiler, and the host's time (host clock, the card
    idle before each call, median) in the whole wrapper, in its argument
    checks and in the C entry alone (the counters' memset and the
    cooperative launch)."""
    from kaldi_aslp_tpu_torch.ops import lstmp as lp

    rs = np.random.RandomState(5)

    def t(a):
        return torch.from_numpy(a).to(dev)

    weights = [(t(uniform(rs, 4 * C, P)), t(uniform(rs, P, C)),
                t(uniform(rs, 3, C))) for _ in range(2)]
    c0, r0 = t(uniform(rs, 1, C, scale=0.5)), t(uniform(rs, 1, P, scale=0.5))
    for directions in (1, 2):
        out = {}
        for T in (16, 1):
            xgs = [t(rs.randn(1, T, 4 * C).astype(np.float32))
                   for _ in range(directions)]
            mask = torch.ones((1, T), device=dev)
            plan = lp.plan_for(1, C, P, directions, dev)

            def call():
                if directions == 1:
                    return lp.lstmp_forward(xgs[0], mask, *weights[0], c0, r0)
                return lp.blstmp_forward(*xgs, mask, *weights, c0, r0)
            by_kernel = device_ms_by_kernel(call)
            out[f"device_sweep_us_T{T}"] = 1e3 * sum(
                ms for k, ms in by_kernel.items() if "sweep_kernel" in k)
            if T == 1:
                continue
            out["host_call_us"] = host_us(call)
            out["host_checks_us"] = host_us(lambda: (
                lp._check(xgs, mask, weights[:directions], c0, r0),
                lp.refuse_autograd(*xgs, mask, c0, r0)))
            out["host_launch_us"] = host_us(lambda: lp._launch(
                plan, xgs, mask, weights[:directions], c0, r0, 50.0))
            out["events_ms"] = cuda_ms(call, 20)
        frames = 15
        out["device_us_per_frame"] = (out["device_sweep_us_T16"]
                                      - out["device_sweep_us_T1"]) / frames
        log("call_split", S=1, T=16, C=C, P=P, directions=directions, **out)


def ptxas_registers_all(log_text: str, kernel: str):
    """Registers of every instance of ``kernel`` in an -Xptxas -v log, in
    the log's order."""
    lines = log_text.splitlines()
    found = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            for later in lines[i + 1:i + 4]:
                if "Used" in later and "registers" in later:
                    found.append(int(later.split("Used")[1].split()[0]))
    return found


# -- phase 4 -----------------------------------------------------------------

def write_model_and_graph(workdir: str):
    """Flagship zip (port's Nnet.save, JAX zip format), tid2pdf LUT, a
    CTC TLG over 71 phones + blank and 200 words, and the word table."""
    from kaldi_aslp_tpu_torch.fst import (
        Lang,
        Lexicon,
        ctc_lut,
        make_ctc_decode_graph,
        make_unigram_grammar,
    )
    from kaldi_aslp_tpu_torch.models.flagship import build_blstm_ctc
    from kaldi_aslp_tpu_torch.models.interop import params_from_jax

    rs = np.random.RandomState(1234)
    net = build_blstm_ctc(FEAT_DIM, LAYERS, P, C, TARGETS)
    tree = {}
    for name, p in net.state_dict().items():
        node = tree
        for part in name.split(".")[1:-1]:
            node = node.setdefault(part, {})
        if name.endswith(".w"):        # the output layer's gaussian init
            node["w"] = (0.04 * rs.randn(*p.shape)).astype(np.float32)
        elif name.endswith(".b"):
            node["b"] = np.zeros(p.shape, np.float32)
        else:
            node[name.rsplit(".", 1)[1]] = uniform(rs, *p.shape)
    net.load_state_dict(params_from_jax(tree))
    paths = [f"{workdir}/{n}" for n in
             ("flagship.zip", "tid2pdf.txt", "TLG.txt", "words.txt")]
    net.save(paths[0])

    phones = [f"P{i:02d}" for i in range(70)]     # + SIL = 71 phones
    words = {f"W{i:03d}": " ".join(rs.choice(phones, rs.randint(2, 6)))
             for i in range(200)}
    lex = "\n".join(f"{w} {p}" for w, p in words.items()) + "\n<SIL> SIL\n"
    lang = Lang.build(Lexicon.from_text(lex))
    if len(lang.phones) != TARGETS:
        raise RuntimeError(f"{len(lang.phones)} CTC outputs, want {TARGETS}")
    t0 = time.perf_counter()
    tlg = make_ctc_decode_graph(
        lang, make_unigram_grammar({w: 1 / len(words) for w in words},
                                   lang.words))
    log("graph", states=tlg.num_states, arcs=tlg.num_arcs,
        build_s=time.perf_counter() - t0)
    if (tlg.num_states, tlg.num_arcs) != SERVING_TLG:
        raise RuntimeError(f"serving TLG {tlg.num_states} states, "
                           f"{tlg.num_arcs} arcs; want {SERVING_TLG}")
    np.savetxt(paths[1], ctc_lut(TARGETS), fmt="%d")
    with open(paths[2], "w") as f:
        f.write(tlg.to_text())
    with open(paths[3], "w") as f:
        f.write(lang.words.to_text())
    return paths


def synth_pcm(seed: int, seconds: float) -> bytes:
    """Speech-like int16 PCM: voiced bursts of harmonics over noise,
    separated by short pauses."""
    rs = np.random.RandomState(seed)
    n = int(seconds * SAMPLE_RATE)
    t = np.arange(n) / SAMPLE_RATE
    f0 = 110 + 40 * np.sin(2 * np.pi * 0.7 * t + rs.rand() * 6)
    phase = 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE
    voiced = sum(np.sin(k * phase) / k for k in range(1, 8))
    envelope = (np.sin(2 * np.pi * 2.5 * t + rs.rand() * 6) > -0.3)
    wave = 3000 * voiced * envelope + 200 * rs.randn(n)
    return np.clip(wave, -32768, 32767).astype("<i2").tobytes()


def serving_pcms():
    """The four serving utterances, 3.0-3.75 s each."""
    return [synth_pcm(i, 3.0 + 0.25 * i) for i in range(4)]


async def request(port: int, pcm: bytes) -> dict:
    """Send ``pcm`` in 250 ms chunks while reading events; time the final
    event from the last byte sent."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    events = []
    t_first = time.perf_counter()
    t_last_byte = None

    async def pump():
        nonlocal t_last_byte
        for i in range(0, len(pcm), CHUNK_BYTES):
            writer.write(pcm[i:i + CHUNK_BYTES])
            await writer.drain()
        writer.write_eof()
        t_last_byte = time.perf_counter()

    async def results():
        async for line in reader:
            events.append((time.perf_counter(), json.loads(line)))

    await asyncio.gather(pump(), results())
    writer.close()
    await writer.wait_closed()
    types = [e["type"] for _, e in events]
    if "partial" not in types or types.count("final") != 1 \
            or types[-1] != "final":
        raise RuntimeError(f"bad event sequence {types}")
    t_final = events[-1][0]
    audio_s = len(pcm) / 2 / SAMPLE_RATE
    return {"audio_s": audio_s, "partials": types.count("partial"),
            "final_text": events[-1][1]["text"],
            "final_text_words": len(events[-1][1]["text"].split()),
            "latency_ms_last_byte_to_final": 1e3 * (t_final - t_last_byte),
            "audio_s_per_s": audio_s / (t_final - t_first)}


def slice_phase(paths, device: str):
    from kaldi_aslp_tpu_torch.cli.online_tools import session_factory_from_argv
    from kaldi_aslp_tpu_torch.online.server import (
        OnlineServerOptions,
        OnlineTcpServer,
    )
    from kaldi_aslp_tpu_torch.ops.lstmp import blstmp_forward, lstmp_forward

    factory = session_factory_from_argv(
        [f"--device={device}", f"--num-mel-bins={FEAT_DIM}", *paths])
    bad = [n for n, p in factory.net.state_dict().items()
           if p.device.type != device]
    if bad:
        raise RuntimeError(f"model tensors not on {device}: {bad}")
    calls = []
    recorded = []   # (frames, scores) of every chunk of the first session

    def make_session():
        session = factory()
        index = len(calls)
        calls.append(0)
        inner = session.acoustic_fn

        def acoustic_fn(frames):
            scores = inner(frames)
            calls[index] += 1
            if index == 0:
                recorded.append((np.array(frames), np.array(scores)))
            if scores.shape != (len(frames), TARGETS) \
                    or not np.isfinite(scores).all():
                raise RuntimeError(f"bad acoustic scores {scores.shape}")
            return scores
        session.acoustic_fn = acoustic_fn
        return session

    pcms = serving_pcms()

    async def serve():
        server = OnlineTcpServer(make_session, OnlineServerOptions(port=0))
        port = await server.start()
        try:
            out = [await request(port, pcms[0]), await request(port, pcms[1])]
            t0 = time.perf_counter()
            out += await asyncio.gather(request(port, pcms[2]),
                                        request(port, pcms[3]))
            concurrent_s = time.perf_counter() - t0
            return out, concurrent_s
        finally:
            await server.stop()

    for wrapper in (blstmp_forward, lstmp_forward):
        wrapper.launches = wrapper.per_step = 0
    stats, concurrent_s = asyncio.run(serve())
    # a BLSTMP layer is one launch of the two-direction entry
    launches, per_step = blstmp_forward.launches, blstmp_forward.per_step
    for i, st in enumerate(stats):
        log("request", index=i, concurrent=i >= 2, acoustic_fn_calls=calls[i],
            **st)
    if launches != LAYERS * sum(calls) or launches == 0 or per_step \
            or lstmp_forward.launches:
        raise RuntimeError(
            f"{launches} two-direction LSTMP launches ({per_step} on the "
            f"per-step kernels) and {lstmp_forward.launches} one-direction "
            f"for {sum(calls)} acoustic_fn calls")
    log("slice", requests=len(stats), acoustic_fn_calls=sum(calls),
        blstmp_launches=launches, per_step=per_step,
        concurrent_pair_audio_s_per_s=(
            (stats[2]["audio_s"] + stats[3]["audio_s"]) / concurrent_s))
    chunk_split(factory, pcms[0])
    return launches, recorded, [st["final_text"] for st in stats]


def chunk_split(factory, pcm: bytes, chunks: int = 8):
    """One warm session's 16-frame chunks timed by part, each part a
    synchronised call between two CUDA events (every part ends on the host:
    the events' span is the part's wall time on the card's clock): the
    median over ``chunks`` chunks after 1 s of audio through the session.
    Then the same chunks' acoustic forward with the inference kernel on its
    per-step kernels (the plan replaced here, for this reading only), as the
    path ran before the persistent sweep: the same run's yardstick."""
    from kaldi_aslp_tpu_torch.ops import lstmp as lp
    from kaldi_aslp_tpu_torch.ops import sweep_plan as sp

    session = factory()
    samples = np.frombuffer(pcm, dtype="<i2").astype(np.float32)
    warm = SAMPLE_RATE
    session.accept_samples(samples[:warm])
    frames_per_chunk = session.chunk_frames
    step = frames_per_chunk * SAMPLE_RATE // 100      # 10 ms frames

    def timed(fn):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    parts = {"fbank_cmn": [], "acoustic_forward": [], "viterbi_advance": [],
             "backtrace": []}
    pending = np.zeros((0, session.features.dim), np.float32)
    timed_chunks = []
    for i in range(chunks):
        piece = samples[warm + i * step: warm + (i + 1) * step]
        frames, ms = timed(lambda: session.features.accept_waveform(piece))
        parts["fbank_cmn"].append(ms)
        pending = np.concatenate([pending, frames])
        if len(pending) < frames_per_chunk:
            raise RuntimeError(f"{len(pending)} frames from {len(piece)} "
                               "samples: no whole chunk")
        chunk, pending = (pending[:frames_per_chunk],
                          pending[frames_per_chunk:])
        scores, ms = timed(lambda: session.acoustic_fn(chunk))
        parts["acoustic_forward"].append(ms)
        timed_chunks.append(chunk)
        _, ms = timed(lambda: session.decoder.advance_decoding(scores))
        parts["viterbi_advance"].append(ms)
        _, ms = timed(lambda: (
            session.decoder.get_partial_path(),
            session.decoder.trailing_silence_frames(session.sil_tids)))
        parts["backtrace"].append(ms)
    med = {k: float(np.median(v)) for k, v in parts.items()}
    planned = lp.plan_for
    lp.plan_for = lambda S, C_, P_, directions, device: \
        sp.lstmp_infer_per_step(S, C_, P_, directions, "the yardstick")
    try:
        session.acoustic_fn(timed_chunks[0])
        per_step = [timed(lambda: session.acoustic_fn(c))[1]
                    for c in timed_chunks]
    finally:
        lp.plan_for = planned
    log("chunk_split", frames=frames_per_chunk, chunks=chunks,
        **{f"{k}_ms": v for k, v in med.items()},
        chunk_ms=sum(med.values()),
        acoustic_forward_on_per_step_kernels_ms=float(np.median(per_step)),
        clock="CUDA events around a synchronised call, median")


# -- phase 5 -----------------------------------------------------------------

def cross_check(paths, recorded):
    from kaldi_aslp_tpu_torch.cli.online_tools import session_factory_from_argv

    cpu = session_factory_from_argv(
        ["--device=cpu", f"--num-mel-bins={FEAT_DIM}", *paths])
    worst = 0.0
    for frames, scores in recorded:
        worst = max(worst, float(np.abs(cpu.acoustic_fn(frames)
                                        - scores).max()))
    log("cross_check", chunks=len(recorded), max_abs_err=worst,
        atol=CROSS_CHECK_ATOL)
    if not recorded or worst > CROSS_CHECK_ATOL:
        raise RuntimeError(f"card vs CPU scores differ by {worst}")


# -- phase 6 -----------------------------------------------------------------

def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-6))


def hold(name: str, got, want, names, rtol: float):
    """Max absolute and relative errors of ``got`` against ``want``;
    raises past ``rtol`` or on a value that is not finite."""
    rel, worst = {}, 0.0
    for n, g, w in zip(names, got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise RuntimeError(f"{name} {n}: {g.dtype} {tuple(g.shape)} vs "
                               f"plain {w.dtype} {tuple(w.shape)}")
        if not torch.isfinite(g.float()).all():
            raise RuntimeError(f"{name} {n} not finite")
        rel[n] = rel_err(g, w)
        worst = max(worst, float((g.float() - w.float()).abs().max()))
        if rel[n] > rtol:
            raise RuntimeError(f"{name} {n}: relative error {rel[n]} > "
                               f"{rtol}")
    return worst, rel


def train_kernel_phase(dev):
    from kaldi_aslp_tpu_torch.ops import bilstmp_train as bt

    bf16 = torch.bfloat16
    results = {"fwd": [], "bwd": []}
    for S, T, D in TRAIN_SHAPES:
        rs = np.random.RandomState(S * 1000 + T + D + 1)

        def t(a):
            return torch.from_numpy(a).to(dev)
        lens = rs.randint(T // 4, T + 1, size=S)
        lens[0] = T
        mask = t((np.arange(T)[None, :] < lens[:, None]).astype(np.float32))
        fwd_args = (t(rs.randn(S, T, D).astype(np.float32)).to(bf16), mask,
                    t(uniform(rs, 2, 4 * C, D)).to(bf16),
                    t(uniform(rs, 2, 4 * C, P)).to(bf16),
                    t(uniform(rs, 2, P, C)).to(bf16), t(uniform(rs, 2, 3, C)),
                    t(uniform(rs, 2, 4 * C)), t(uniform(rs, S, C, scale=0.5)),
                    t(uniform(rs, S, P, scale=0.5)))
        x, _, wx, wr, wrm, peep, _, init_c, _ = fwd_args
        got = bt.bilstmp_train_fwd(*fwd_args)
        want = bt.bilstmp_train_fwd_reference(*fwd_args)
        torch.cuda.synchronize()
        err_f, rel_f = hold("bilstmp_train_fwd", got, want,
                            ("ys", "gates", "cs", "rprev", "c_T", "r_T"),
                            TRAIN_KERNEL_RTOL)
        _, gates, cs, rprev, _, _ = want
        bwd_args = (t(rs.randn(S, T, 2 * P).astype(np.float32)).to(bf16),
                    mask, x, gates, cs, rprev, wx, wr, wrm, peep, init_c,
                    t(rs.randn(S, C).astype(np.float32)),
                    t(rs.randn(S, P).astype(np.float32)))
        got = bt.bilstmp_train_bwd(*bwd_args)
        want = bt.bilstmp_train_bwd_reference(*bwd_args)
        torch.cuda.synchronize()
        err_b, rel_b = hold("bilstmp_train_bwd", got, want,
                            ("dx", "d_init_c", "d_init_r", "dwx", "dwr",
                             "dwrm", "dbias", "dpeep"), TRAIN_KERNEL_RTOL)
        del got, want
        reps = 3 if S * T > 10000 else 5
        times = {
            "fwd": (cuda_ms(lambda: bt.bilstmp_train_fwd(*fwd_args), reps, 1),
                    cuda_ms(lambda: bt.bilstmp_train_fwd_reference(
                        *fwd_args), 2, 1)),
            "bwd": (cuda_ms(lambda: bt.bilstmp_train_bwd(*bwd_args), reps, 1),
                    cuda_ms(lambda: bt.bilstmp_train_bwd_reference(
                        *bwd_args), 2, 1))}
        for kind, err, rel in (("fwd", err_f, rel_f), ("bwd", err_b, rel_b)):
            ms, plain_ms = times[kind]
            results[kind].append({"S": S, "T": T, "D": D, "max_abs_err": err,
                                  "ms": ms, "plain_ms": plain_ms})
            log("train_kernel", name=f"bilstmp_train_{kind}", S=S, T=T, D=D,
                C=C, P=P, rel_err=rel, rtol=TRAIN_KERNEL_RTOL, ms=ms,
                plain_ms=plain_ms)

    results["redesign"] = x_fused_phase(dev, fwd_args, bwd_args)

    results["ctc"] = ctc_phase(dev)
    return results


def finite_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| where ``want`` is finite (where it is -inf,
    assert_close has held ``got`` to the same)."""
    finite = torch.isfinite(want)
    return float((got[finite] - want[finite]).abs().max())


def host_us(fn, reps=100):
    """Median host microseconds of ``fn`` with the card idle before each
    call."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e6 * float(np.median(times))


def ctc_case(dev):
    """The CTC inputs at CTC_SHAPE with ragged lengths: (logits, labels,
    input lengths, label lengths, the recursions' arguments)."""
    from kaldi_aslp_tpu_torch.ops.ctc import ctc_emissions

    S, T, U, V = CTC_SHAPE
    rs = np.random.RandomState(7)
    lab_lens = rs.randint(U // 4, U + 1, size=S).astype(np.int32)
    in_lens = rs.randint(T // 2, T + 1, size=S).astype(np.int32)
    lab_lens[0], in_lens[0] = U, T
    in_lens = np.maximum(in_lens, 2 * lab_lens + 1).astype(np.int32)
    logits = torch.from_numpy(rs.randn(S, T, V).astype(np.float32)).to(dev)
    labels = torch.from_numpy(
        rs.randint(1, V, (S, U)).astype(np.int32)).to(dev)
    in_lens_d = torch.from_numpy(in_lens).to(dev)
    lab_lens_d = torch.from_numpy(lab_lens).to(dev)
    lp_t, skip_ok, _, _, exp_lens = ctc_emissions(
        torch.log_softmax(logits, -1), labels, lab_lens_d)
    return logits, labels, in_lens_d, lab_lens_d, (lp_t, skip_ok, in_lens_d,
                                                   exp_lens)


@contextlib.contextmanager
def ctc_wide():
    """A context in which the CTC pair runs on its wide kernel (its plan in
    place of plan_for)."""
    from kaldi_aslp_tpu_torch.ops import ctc_recursions as cab

    planned = cab.plan_for
    cab.plan_for = cab.wide_plan
    try:
        yield
    finally:
        cab.plan_for = planned


def ctc_profile_child():
    """In a fresh process: the CTC pair's device time by kernel name and
    launches by kernel at CTC_SHAPE, on its planned (warp) kernel and on
    the wide one, printed as one JSON line {"warp" | "wide": [ms by
    kernel, launches by kernel]}."""
    from kaldi_aslp_tpu_torch.ops import ctc_recursions as cab

    args = ctc_case(torch.device("cuda"))[-1]
    out = {}
    for name, context in (("warp", contextlib.nullcontext),
                          ("wide", ctc_wide)):
        with context():
            counts = {}
            by_kernel = device_ms_by_kernel(
                lambda: cab.ctc_alpha_beta(*args), counts)
            out[name] = [by_kernel, counts]
    print(json.dumps(out), flush=True)


def ctc_phase(dev):
    """The CTC pair at CTC_SHAPE with ragged lengths: one launch for both
    recursions against the plain versions and twice for the same bits;
    its time by CUDA events, its device time by torch.profiler (in a
    process of its own; one kernel a call) and its wrapper's host time;
    the wide kernel at the same inputs as the same run's yardstick; then
    the port's whole ctc_loss forward and backward beside F.ctc_loss's on
    the same logits."""
    from kaldi_aslp_tpu_torch.ops import ctc_recursions as cab
    from kaldi_aslp_tpu_torch.ops.ctc import ctc_loss

    S, T, U, V = CTC_SHAPE
    logits, labels, in_lens_d, lab_lens_d, args = ctc_case(dev)
    in_lens = in_lens_d.cpu().numpy()
    Up = args[0].shape[2]
    plan = cab.plan_for(Up)
    if plan.wide:
        raise RuntimeError(f"U' = {Up} planned on the wide kernel")

    def pair():
        return cab.ctc_alpha_beta(*args)

    def plain():
        return cab.ctc_alpha_beta_reference(*args)

    def held():
        got, want = pair(), plain()
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **CTC_TOL)
        return got, max(finite_err(g, w) for g, w in zip(got, want))

    got, err = held()
    again = pair()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise RuntimeError("two runs of the CTC pair differ")
    del got, again
    ms = cuda_ms(pair, 20)
    plain_ms = cuda_ms(plain, 3, 1)
    host_call_us = host_us(pair)
    host_checks_us = host_us(lambda: cab._check(*args))
    wide_before = cab.ctc_alpha_beta.wide
    with ctc_wide():
        _, wide_err = held()
        wide_ms = cuda_ms(pair, 20)
    if cab.ctc_alpha_beta.wide == wide_before:
        raise RuntimeError("the forced wide plan launched no wide kernel")

    # the profiles in a process of their own, as xg_sweep_phase's: late in
    # this one the profiler saw no kernel of the call
    child = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; "
         "chip_smoke.ctc_profile_child()"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if child.returncode != 0:
        raise RuntimeError(f"profile process failed: {child.stderr[-2000:]}")
    profiles = json.loads(child.stdout.strip().splitlines()[-1])
    (by_kernel, counts), (wide_by_kernel, wide_counts) = (
        profiles["warp"], profiles["wide"])
    for want, seen in (("ctc_warp_kernel", counts),
                       ("ctc_wide_kernel", wide_counts)):
        if sum(seen.values()) != 1 or not all(want in k for k in seen):
            raise RuntimeError(f"a CTC pair call is not one {want}: {seen}")

    # the port's whole loss beside F.ctc_loss, both from the logits:
    # log-softmax, the recursions and the gradient to the logits
    lg = logits.detach().requires_grad_()
    lengths = (in_lens_d.long(), lab_lens_d.long())

    def port_loss():
        lg.grad = None
        loss = ctc_loss(lg, labels, in_lens_d, lab_lens_d).sum()
        loss.backward()
        return loss.detach()

    def library():
        lg.grad = None
        loss = torch.nn.functional.ctc_loss(
            torch.log_softmax(lg, -1).transpose(0, 1), labels.long(),
            *lengths, reduction="sum")
        loss.backward()
        return loss.detach()
    port_value, port_grad = float(port_loss()), lg.grad.clone()
    lib_value = float(library())
    loss_rel = abs(port_value - lib_value) / abs(lib_value)
    grad_err = float((lg.grad - port_grad).abs().max())
    if not loss_rel <= CTC_LOSS_RTOL:
        raise RuntimeError(f"ctc_loss {port_value} vs F.ctc_loss "
                           f"{lib_value}")
    loss_ms = cuda_ms(port_loss, 10)
    library_ms = cuda_ms(library, 10)
    bound_ms, bound_by = ctc_bound(T, S, Up, in_lens)
    out = {"S": S, "T": T, "U": U, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "device_ms": sum(by_kernel.values()),
           "host_call_us": host_call_us, "host_checks_us": host_checks_us,
           "wide_ms": wide_ms, "wide_device_ms": sum(wide_by_kernel.values()),
           "wide_max_abs_err": wide_err, "loss_ms": loss_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by}
    log("ctc_pair", V=V, states_per_lane=plan.states_per_lane,
        tol=CTC_TOL, identical_twice=True, launches_by_kernel=counts,
        by_kernel_ms=by_kernel, wide_by_kernel_ms=wide_by_kernel,
        time_split_source="torch.profiler, in a process of its own",
        wide_threads=cab.wide_plan(Up).wide_threads, **out)
    log("ctc_loss", S=S, T=T, U=U, V=V, port_ms=loss_ms,
        library_ms=library_ms, loss=port_value, library_loss=lib_value,
        loss_rel=loss_rel, grad_max_abs_diff=grad_err,
        note="forward and backward from the logits: log-softmax, the "
        "recursions and the gradient to the logits, on both sides")
    return out


# cycles of the spin that device_ms_by_kernel queues a profiled call
# behind (about 10 ms on an H100)
PROFILE_SPIN_CYCLES = 20_000_000


def device_ms_by_kernel(fn, counts=None, tries: int = 3) -> dict:
    """Device milliseconds of one call of ``fn`` by kernel name, from
    torch.profiler (empty if the profiler saw no device time in ``tries``
    profiles); with a dict ``counts``, each kernel's number of launches
    goes into it.  Inside the profiled window the call queues behind a
    spin kernel (dropped from the result): late in a long process the
    profiler dropped the first kernels of a short call, or all of them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out, seen = {}, {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(PROFILE_SPIN_CYCLES)
            fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0)
            # kernels only: an operator's device time is its kernels'
            if (us and str(getattr(e, "device_type", "")).endswith("CUDA")
                    and "spin_kernel" not in e.key):
                out[e.key] = out.get(e.key, 0.0) + us / 1e3
                seen[e.key] = seen.get(e.key, 0) + e.count
        if out:
            break
    if counts is not None:
        counts.update(seen)
    return out


def ptxas_registers(log_text: str, kernel: str):
    """Registers ptxas gave the kernel whose mangled name holds
    ``kernel``, from an -Xptxas -v log."""
    found = ptxas_registers_all(log_text, kernel)
    return found[0] if found else None


def x_fused_phase(dev, fwd_args, bwd_args):
    """At the bench shape: the determinism check, the hoisted GEMM at its
    five shapes beside torch.matmul, each x-fused kernel's time split into
    sweep and GEMMs, and the sweeps' plan and registers."""
    from kaldi_aslp_tpu_torch.ops import bilstmp_train as bt
    from kaldi_aslp_tpu_torch.ops import build

    x, mask, wx, wr, wrm, peep, bias, init_c, init_r = fwd_args
    S, T, D = x.shape
    G, R, bf16 = 4 * C, S * T, torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    # two runs, the same bits
    runs = []
    for _ in range(2):
        f = bt.bilstmp_train_fwd(*fwd_args)
        runs.append((*f, *bt.bilstmp_train_bwd(*bwd_args)))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    log("determinism", S=S, T=T, D=D, C=C, P=P, outputs=len(runs[0]),
        identical=same)
    if not same:
        raise RuntimeError("two runs of the x-fused kernels differ")
    del runs

    # the hoisted GEMM at the shapes of the products (random bf16 operands
    # in the layouts the kernels pass): xg = x . W_x^T; dx = dgates . W_x;
    # dW_x = dgates^T . x; dW_r = dgates^T . r_prev; dW_rm = dr_new^T . m
    rs = np.random.RandomState(11)

    def randn(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(
            dev).to(bf16)
    dg, m, drn, rp = randn(2, R, G), randn(2, R, C), randn(2, R, P), \
        randn(2, R, P)
    xs = x.reshape(1, R, D).expand(2, -1, -1)
    products = {"xg": (xs, wx.transpose(1, 2)), "dx": (dg, wx),
                "dwx": (dg.transpose(1, 2), xs),
                "dwr": (dg.transpose(1, 2), rp),
                "dwrm": (drn.transpose(1, 2), m)}
    gemm = {}
    for name, (a, b) in products.items():
        got = bt.bilstmp_gemm_bf16(a, b)
        want = bt.bilstmp_gemm_bf16_reference(a, b)
        torch.cuda.synchronize()
        err, rel = hold(f"bilstmp_gemm_bf16 {name}", [got], [want], [name],
                        GEMM_RTOL)
        del got, want
        batch, M, K = a.shape
        N = b.shape[2]
        flop = 2 * batch * M * N * K
        ms = cuda_ms(lambda: bt.bilstmp_gemm_bf16(a, b), 10)
        library_ms = cuda_ms(lambda: torch.matmul(a, b), 10)
        gemm[name] = {"batch": batch, "M": M, "N": N, "K": K,
                      "max_abs_err": err, "ms": ms, "tflops": flop / ms / 1e9,
                      "library_ms": library_ms,
                      "ratio": ms / library_ms}
        log("gemm", name=f"bilstmp_gemm_bf16 {name}", **gemm[name],
            rel_err=rel[name], rtol=GEMM_RTOL,
            splits=bt.gemm_splits(M, N, K, sms))
    del dg, m, drn, rp, products

    # each kernel's time by its kernels' names: sweep, GEMMs, the rest
    dy, _, _, gates, cs, rprev, *_, dc, dr = bwd_args
    dir_args = (0, dy, mask, x, gates[0], cs[0], rprev[0], wx[0], wr[0],
                wrm[0], peep[0], init_c, dc, dr)
    split = {}
    for name, fn, gemms in (
            ("bilstmp_train_fwd", lambda: bt.bilstmp_train_fwd(*fwd_args),
             ("xg",)),
            ("bilstmp_train_bwd", lambda: bt.bilstmp_train_bwd(*bwd_args),
             ("dx", "dwx", "dwr", "dwrm")),
            ("bilstmp_train_bwd_dir",
             lambda: bt.bilstmp_train_bwd_dir(*dir_args), ())):
        by_kernel = device_ms_by_kernel(fn)
        total = cuda_ms(fn, 3, 1)
        parts = {"sweep": 0.0, "gemm": 0.0, "other": 0.0}
        for key, ms in by_kernel.items():
            part = ("sweep" if "sweep_kernel" in key else
                    "gemm" if "gemm_" in key or "splitk_reduce" in key
                    else "other")
            parts[part] += ms
        if by_kernel:
            source = "torch.profiler"
            # every hoisted product at these aligned widths takes TMA
            names = " ".join(by_kernel)
            if "gemm_tma_kernel" not in names or "gemm_bf16_kernel" in names:
                raise RuntimeError(
                    f"{name}: the hoisted products did not all run in "
                    f"gemm_tma_kernel: {sorted(by_kernel)}")
        else:
            # no device time in the profile: the GEMM entry's own times
            source = "kernel time less the GEMM entry's"
            parts["gemm"] = sum(gemm[k]["ms"] for k in gemms)
            parts["sweep"] = total - parts["gemm"]
        split[name] = {"ms": total, "source": source,
                       **{f"{k}_ms": v for k, v in parts.items()},
                       "gemm_library_ms": sum(gemm[k]["library_ms"]
                                              for k in gemms) or None,
                       "by_kernel": by_kernel}
        log("time_split", name=name, S=S, T=T, D=D, **split[name])
    log("earlier_times", recorded_in="PERF.md section 6, the earlier "
        "per-step kernels, not measured in this run", S=S, T=T, D=D,
        ms=MS_PER_STEP_KERNELS,
        measured_ms={k: v["ms"] for k, v in split.items()})

    # the sweeps' plan and what ptxas gave them
    plan = bt.sweep_plan(S, C, P, sms)
    log_text = build.library_path(bt.SOURCE).with_suffix(".log").read_text()
    sweeps = {}
    for kernel, backward in (("fwd_sweep_kernel", False),
                             ("bwd_sweep_kernel", True)):
        nbd, cpb, ppb, stages, smem = plan.kernel_args(backward)
        sweeps[kernel] = {"blocks": 2 * nbd, "threads": 256,
                          "cells_per_block": cpb, "cols_per_block": ppb,
                          "ring_stages": stages, "smem_bytes": smem,
                          "registers": ptxas_registers(log_text, kernel)}
        log("sweep_plan", kernel=kernel, S=S, C=C, P=P, **sweeps[kernel])
    return {"gemm": gemm, "split": split, "sweeps": sweeps}


def hold_xg(name, got, want, names, mxu_bf16):
    """:func:`hold` at TRAIN_KERNEL_RTOL with bf16 products; with float32
    products the tighter bounds of XG_F32_RTOL and XG_BF16_SHARE."""
    if mxu_bf16:
        return hold(name, got, want, names, TRAIN_KERNEL_RTOL)
    worst, rel = 0.0, {}
    for n, g, w in zip(names, got, want):
        kind = ("bf16" if g.dtype == torch.bfloat16 else
                "reduction" if n in ("dwr", "dwrm") else "kernel_f32")
        err, r = hold(name, [g], [w], [n], XG_F32_RTOL[kind])
        worst, rel[n] = max(worst, err), r[n]
        share = float((g != w).float().mean())
        if kind == "bf16" and share > XG_BF16_SHARE:
            raise RuntimeError(f"{name} {n}: {share} of the bf16 values "
                               f"differ, more than {XG_BF16_SHARE}")
    return worst, rel


# -- phase 6b ----------------------------------------------------------------

def ragged_mask(rs, S, T, dev):
    lens = rs.randint(T // 4, T + 1, size=S)
    lens[0] = T
    return torch.from_numpy(
        (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)).to(dev)


def xg_case(dev, S, T, mxu):
    """The xg-fed pair's inputs at (S, T) and the flagship's widths, from
    a numpy seed: the forward's arguments, and the backward's dy and
    final-state cotangents."""
    rs = np.random.RandomState(S * 1000 + T + 2 + mxu)
    G = 4 * C

    def t(a):
        return torch.from_numpy(a).to(dev)
    mask = ragged_mask(rs, S, T, dev)
    fwd_args = (t(rs.randn(S, T, G).astype(np.float32)).to(torch.bfloat16),
                t(rs.randn(S, T, G).astype(np.float32)).to(torch.bfloat16),
                mask, t(uniform(rs, 2, G, P)), t(uniform(rs, 2, P, C)),
                t(uniform(rs, 2, 3, C)), t(uniform(rs, 2, G)),
                t(uniform(rs, S, C, scale=0.5)),
                t(uniform(rs, S, P, scale=0.5)), 50.0, mxu)
    cots = (t(rs.randn(S, T, 2 * P).astype(np.float32)).to(torch.bfloat16),
            t(rs.randn(S, C).astype(np.float32)),
            t(rs.randn(S, P).astype(np.float32)))
    return fwd_args, cots


def xg_bwd_args(fwd_args, streams, cots):
    """The backward's arguments, fed the forward's stored ``streams``
    (ys, gates, cs, rprev, ...)."""
    _, _, mask, wr, wrm, peep, _, init_c, _, clip, mxu = fwd_args
    _, gates, cs, rprev, *_ = streams
    dy, dc, dr = cots
    return (dy, mask, gates, cs, rprev, wr, wrm, peep, init_c, dc, dr, clip,
            mxu)


def xg_train_kernel_phase(dev):
    from kaldi_aslp_tpu_torch.ops import bilstmp_train as bt
    from kaldi_aslp_tpu_torch.ops import bilstmp_xg_train as xt

    bf16, G = torch.bfloat16, 4 * C
    results = {"fwd": [], "bwd": [], "bwd_dir": []}

    def t(a):
        return torch.from_numpy(a).to(dev)

    for S, T in XG_SHAPES:
        cases = {}
        for mxu in (True, False):
            fwd_args, cots = xg_case(dev, S, T, mxu)
            got = xt.bilstmp_xg_train_fwd(*fwd_args)
            want = xt.bilstmp_xg_train_fwd_reference(*fwd_args)
            torch.cuda.synchronize()
            err_f, rel_f = hold_xg("bilstmp_xg_train_fwd", got, want,
                                   ("ys", "gates", "cs", "rprev", "c_T",
                                    "r_T"), mxu)
            bwd_args = xg_bwd_args(fwd_args, want, cots)
            got = xt.bilstmp_xg_train_bwd(*bwd_args)
            want = xt.bilstmp_xg_train_bwd_reference(*bwd_args)
            torch.cuda.synchronize()
            err_b, rel_b = hold_xg("bilstmp_xg_train_bwd", got, want,
                                   ("dxg", "d_init_c", "d_init_r", "dwr",
                                    "dwrm", "dbias", "dpeep"), mxu)
            del got, want
            cases[mxu] = (fwd_args, bwd_args)
            reps = 3 if S * T > 10000 else 5
            times = {
                "fwd": (cuda_ms(lambda: xt.bilstmp_xg_train_fwd(*fwd_args),
                                reps, 1),
                        cuda_ms(lambda: xt.bilstmp_xg_train_fwd_reference(
                            *fwd_args), 2, 1)),
                "bwd": (cuda_ms(lambda: xt.bilstmp_xg_train_bwd(*bwd_args),
                                reps, 1),
                        cuda_ms(lambda: xt.bilstmp_xg_train_bwd_reference(
                            *bwd_args), 2, 1))}
            plan = xt.plan_for(S, C, P, mxu, dev)
            for kind, err, rel in (("fwd", err_f, rel_f),
                                   ("bwd", err_b, rel_b)):
                ms, plain_ms = times[kind]
                results[kind].append({"S": S, "T": T, "mxu_bf16": mxu,
                                      "max_abs_err": err, "ms": ms,
                                      "plain_ms": plain_ms,
                                      "path": plan.path})
                log("xg_train_kernel", name=f"bilstmp_xg_train_{kind}", S=S,
                    T=T, C=C, P=P, mxu_bf16=mxu, path=plan.path, rel_err=rel,
                    rtol=TRAIN_KERNEL_RTOL if mxu else XG_F32_RTOL, ms=ms,
                    plain_ms=plain_ms)
        if (S, T) == XG_SWEEP_SHAPE:
            results["redesign"] = xg_sweep_phase(dev, cases)

    names = ("dx", "d_init_c", "d_init_r", "dwx", "dwr", "dwrm", "dbias",
             "dpeep")
    for S, T, D in TRAIN_SHAPES:
        rs = np.random.RandomState(S * 1000 + T + D + 3)
        mask = ragged_mask(rs, S, T, dev)
        fwd_args = (t(rs.randn(S, T, D).astype(np.float32)).to(bf16), mask,
                    t(uniform(rs, 2, G, D)).to(bf16),
                    t(uniform(rs, 2, G, P)).to(bf16),
                    t(uniform(rs, 2, P, C)).to(bf16), t(uniform(rs, 2, 3, C)),
                    t(uniform(rs, 2, G)), t(uniform(rs, S, C, scale=0.5)),
                    t(uniform(rs, S, P, scale=0.5)))
        x, _, wx, wr, wrm, peep, _, init_c, _ = fwd_args
        _, gates, cs, rprev, _, _ = bt.bilstmp_train_fwd(*fwd_args)
        dy = t(rs.randn(S, T, 2 * P).astype(np.float32)).to(bf16)
        dc = t(rs.randn(S, C).astype(np.float32))
        dr = t(rs.randn(S, P).astype(np.float32))
        fused = bt.bilstmp_train_bwd(dy, mask, x, gates, cs, rprev, wx, wr,
                                     wrm, peep, init_c, dc, dr)
        zc, zr = torch.zeros_like(dc), torch.zeros_like(dr)
        dir_args, halves, err, rel = [], [], 0.0, {}
        for d in range(2):
            args = (d, dy, mask, x, gates[d], cs[d], rprev[d], wx[d], wr[d],
                    wrm[d], peep[d], init_c if d == 0 else zc,
                    dc if d == 0 else zc, dr if d == 0 else zr)
            got = bt.bilstmp_train_bwd_dir(*args)
            want = bt.bilstmp_train_bwd_dir_reference(*args)
            torch.cuda.synchronize()
            e, r = hold(f"bilstmp_train_bwd_dir[{d}]", got, want, names,
                        TRAIN_KERNEL_RTOL)
            err, rel[d] = max(err, e), r
            dir_args.append(args)
            halves.append(got)
        split = [(halves[0][0].float() + halves[1][0].float()).to(bf16),
                 halves[0][1], halves[0][2],
                 *(torch.stack([h[k] for h in halves]) for k in range(3, 8))]
        vs_fused = max(float((g.float() - w.float()).abs().max())
                       for g, w in zip(split, fused))
        del fused, halves, split, got, want
        reps = 3 if S * T > 10000 else 5
        ms = cuda_ms(lambda: bt.bilstmp_train_bwd_dir(*dir_args[0]), reps, 1)
        plain_ms = cuda_ms(
            lambda: bt.bilstmp_train_bwd_dir_reference(*dir_args[0]), 2, 1)
        results["bwd_dir"].append({"S": S, "T": T, "D": D,
                                   "max_abs_err": err, "ms": ms,
                                   "plain_ms": plain_ms,
                                   "vs_fused_max_abs": vs_fused})
        log("xg_train_kernel", name="bilstmp_train_bwd_dir", S=S, T=T, D=D,
            C=C, P=P, rel_err=rel, rtol=TRAIN_KERNEL_RTOL,
            split_vs_fused_max_abs=vs_fused, ms_d0=ms, plain_ms_d0=plain_ms)
        if vs_fused != 0.0:
            raise RuntimeError(f"the split backward's halves differ from the "
                               f"fused backward by {vs_fused} at {S, T, D}")
    return results


def xg_sweep_phase(dev, cases):
    """At the bench's shape, for each product mode ({mxu_bf16: (fwd_args,
    bwd_args)}): two runs must give the same bits; the per-step kernels
    timed beside the sweeps; each wrapper's time split by torch.profiler
    into its persistent sweep (one launch a call, no per-step kernel),
    GEMMs (the backward's dW_r and dW_rm, in gemm_tma_kernel) and the
    rest; the sweeps' plan and registers."""
    from kaldi_aslp_tpu_torch.ops import bilstmp_xg_train as xt
    from kaldi_aslp_tpu_torch.ops import build

    S, T = XG_SWEEP_SHAPE
    fns = {}
    for mxu, (fwd_args, bwd_args) in cases.items():
        runs = []
        for _ in range(2):
            runs.append((*xt.bilstmp_xg_train_fwd(*fwd_args),
                         *xt.bilstmp_xg_train_bwd(*bwd_args)))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        log("xg_determinism", S=S, T=T, C=C, P=P, mxu_bf16=mxu,
            outputs=len(runs[0]), identical=same)
        if not same:
            raise RuntimeError(f"two runs of the xg-fed kernels differ "
                               f"(mxu_bf16={mxu})")
        del runs
        fns[mxu] = {
            kind: (lambda f=fn, a=args: f(*a),
                   lambda f=fn, a=args: on_xg_per_step(lambda: f(*a)))
            for kind, fn, args in (("fwd", xt.bilstmp_xg_train_fwd, fwd_args),
                                   ("bwd", xt.bilstmp_xg_train_bwd, bwd_args))}

    # the profiles in a process of their own, as lstm_sweep_phase's
    child = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; "
         "chip_smoke.xg_profile_child()"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if child.returncode != 0:
        raise RuntimeError(f"profile process failed: {child.stderr[-2000:]}")
    profiles = json.loads(child.stdout.strip().splitlines()[-1])
    split = {}
    for mxu in cases:
        for kind in ("fwd", "bwd"):
            name = f"bilstmp_xg_train_{kind}"
            by_kernel, counts, per_step = profiles[f"{kind}-{int(mxu)}"]
            parts = {"sweep": [], "gemm": [], "other": []}
            for key in by_kernel:
                parts["sweep" if "sweep_kernel" in key else
                      "gemm" if "gemm_" in key or "splitk_reduce" in key
                      else "other"].append(key)
            sweeps = sum(counts[k] for k in parts["sweep"])
            stepped = [k for k in by_kernel
                       if any(n in k for n in PER_STEP_KERNELS)]
            gemm_ok = kind == "fwd" or (
                sum(counts[k] for k in parts["gemm"] if "gemm_tma" in k) == 2
                and not any("gemm_bf16_kernel" in k for k in by_kernel))
            if sweeps != 1 or stepped or per_step or not gemm_ok:
                raise RuntimeError(
                    f"{name} (mxu_bf16={mxu}): not one persistent sweep "
                    f"(and in the backward two TMA GEMMs) a call: {counts}, "
                    f"per_step {per_step}")
            sweep_fn, per_step_fn = fns[mxu][kind]
            split[kind, mxu] = {
                "ms": cuda_ms(sweep_fn, 3, 1),
                "per_step_ms": cuda_ms(per_step_fn, 1, 1),
                "source": "torch.profiler", "sweep_launches": sweeps,
                **{f"{k}_ms": sum(by_kernel[n] for n in v)
                   for k, v in parts.items()},
                "by_kernel": by_kernel}
            log("time_split", name=name, S=S, T=T, C=C, P=P, mxu_bf16=mxu,
                **split[kind, mxu])

    # the sweeps' plans and what ptxas gave them
    log_text = build.library_path(xt.SOURCE).with_suffix(".log").read_text()
    for mxu in cases:
        plan = xt.plan_for(S, C, P, mxu, dev)
        if not plan.persistent:
            raise RuntimeError(f"the bench's shape took the per-step "
                               f"kernels: {plan.reason}")
        for kind, backward in (("fwd", False), ("bwd", True)):
            # the tensor-core sweeps by their mangled names' length prefix
            kernel = (f"16{kind}_sweep_kernel" if mxu else
                      f"xg_fma_{kind}_sweep_kernel")
            nbd, cpb, ppb, stages, smem = plan.kernel_args(backward)
            log("sweep_plan", kernel=kernel[2:] if mxu else kernel, mxu_bf16=mxu, S=S,
                C=C, P=P, path=plan.path, blocks=2 * nbd, threads=256,
                cells_per_block=cpb, cols_per_block=ppb, ring_stages=stages,
                smem_bytes=smem, registers=ptxas_registers(log_text, kernel))
    return split


def on_xg_per_step(fn):
    """fn() with the xg-fed wrappers planned onto their per-step kernels,
    as chunk_split puts lstmp_forward's per-step plan in place."""
    from kaldi_aslp_tpu_torch.ops import bilstmp_xg_train as xt
    from kaldi_aslp_tpu_torch.ops import sweep_plan as sp

    planned = xt.plan_for
    xt.plan_for = lambda S, C_, P_, mxu_bf16, device: \
        sp.bilstmp_xg_per_step(S, C_, P_, mxu_bf16, "the yardstick")
    try:
        return fn()
    finally:
        xt.plan_for = planned


def xg_profile_child():
    """In a fresh process: the xg-fed kernels' device time by kernel name,
    launch counts and per-step calls at XG_SWEEP_SHAPE in both product
    modes, printed as one JSON line {"kind-mode": [ms by kernel, launches
    by kernel, per_step]}."""
    from kaldi_aslp_tpu_torch.ops import bilstmp_xg_train as xt

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {}
    for mxu in (True, False):
        fwd_args, cots = xg_case(dev, *XG_SWEEP_SHAPE, mxu)
        bwd_args = xg_bwd_args(fwd_args, xt.bilstmp_xg_train_fwd(*fwd_args),
                               cots)
        for kind, fn in (
                ("fwd", lambda: xt.bilstmp_xg_train_fwd(*fwd_args)),
                ("bwd", lambda: xt.bilstmp_xg_train_bwd(*bwd_args))):
            wrapper = getattr(xt, f"bilstmp_xg_train_{kind}")
            counts, before = {}, wrapper.per_step
            by_kernel = device_ms_by_kernel(fn, counts)
            out[f"{kind}-{int(mxu)}"] = [by_kernel, counts,
                                         wrapper.per_step - before]
    print(json.dumps(out), flush=True)


# -- phase 7 -----------------------------------------------------------------

def write_train_files(workdir: str):
    """The bf16 flagship as bench.py:_build_flagship lays it out (model's
    init from numpy seed 4321) and a corpus of 16 utterances written 4
    times over, so each batch of 16 streams holds the same utterances."""
    from kaldi_aslp_tpu_torch.io import int_vector_writer, matrix_writer
    from kaldi_aslp_tpu_torch.models import (
        AffineTransform,
        BLstmProjectedStreams,
        Nnet,
    )

    rs = np.random.RandomState(4321)
    net = Nnet()
    dim = FEAT_DIM
    for _ in range(LAYERS):
        net.add(BLstmProjectedStreams(dim, 2 * P, cell_dim=C, bf16=True))
        dim = 2 * P
    net.add(AffineTransform(dim, TARGETS, param_stddev=0.04, bias_mean=0.0,
                            bias_range=0.0))
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(torch.from_numpy(
                (0.04 * rs.randn(*p.shape)).astype(np.float32)
                if name.endswith(".w") else np.zeros(p.shape, np.float32)
                if name.endswith(".b") else uniform(rs, *p.shape)))
    model = f"{workdir}/flagship_bf16.zip"
    net.save(model)
    utts = [(rs.randn(rs.randint(200, 401), FEAT_DIM).astype(np.float32),
             rs.randint(1, TARGETS, rs.randint(10, 41)).astype(np.int32))
            for _ in range(TRAIN_STREAMS)]
    with matrix_writer(f"ark,scp:{workdir}/feats.ark,{workdir}/feats.scp") \
            as fw, int_vector_writer(f"ark:{workdir}/labels.ark") as lw:
        for rep in range(TRAIN_STEPS):
            for i, (feats, labels) in enumerate(utts):
                fw[f"utt{i:02d}-{rep}"] = feats
                lw[f"utt{i:02d}-{rep}"] = labels
    return model, f"scp:{workdir}/feats.scp", f"ark:{workdir}/labels.ark"


def train_phase(model, feats, labels, workdir, switch=None):
    """The CTC CLI's run, with ``switch`` set (None: no switch)."""
    from kaldi_aslp_tpu_torch.cli.__main__ import main as cli_main
    from kaldi_aslp_tpu_torch.models import Nnet
    from kaldi_aslp_tpu_torch.ops.lstmp import lstmp_forward
    from kaldi_aslp_tpu_torch.train.trainer import CtcTrainer

    wrappers = train_kernel_wrappers()
    per_step_want = {n: TRAIN_RUNS[switch].get(n, 0) for n in wrappers}
    per_step_want.update(ctc_alpha_beta=1)
    steps = []
    inner = CtcTrainer.step

    def step(self, velocity, batch, learn_rate):
        before = {n: w.launches for n, w in wrappers.items()}
        t0 = time.perf_counter()
        loss, aux = inner(self, velocity, batch, learn_rate)
        loss = float(loss)   # syncs the card
        steps.append({"loss": loss, "s": time.perf_counter() - t0,
                      "streams": int(batch[0].shape[0]),
                      "frames": int(aux["frames"]),
                      "launches": {n: w.launches - before[n]
                                   for n, w in wrappers.items()}})
        return torch.tensor(loss), aux

    out = f"{workdir}/trained-{switch or 'default'}.zip"
    CtcTrainer.step = step
    try:
        with switch_env(switch):
            for w in (*wrappers.values(), lstmp_forward):
                w.launches = 0
                for counter in ("per_step", "wide"):
                    if hasattr(w, counter):
                        setattr(w, counter, 0)
            rc = cli_main(["aslp-nnet-train-ctc-streams", "--device=cuda",
                           "--momentum=0.9", f"--num-streams={TRAIN_STREAMS}",
                           feats, labels, model, out])
            launches = {n: w.launches for n, w in wrappers.items()}
            # the persistent sweeps, never the per-step kernels
            per_step = {n: w.per_step for n, w in wrappers.items()
                        if hasattr(w, "per_step")}
            # the CTC pair on its warp kernel, never the wide one
            wide = wrappers["ctc_alpha_beta"].wide
    finally:
        CtcTrainer.step = inner
    for i, st in enumerate(steps):
        log("train_step", switch=switch, index=i, **st)
    if rc != 0 or len(steps) < TRAIN_STEPS:
        raise RuntimeError(f"trainer exit {rc}, {len(steps)} steps")
    for st in steps:
        if st["launches"] != per_step_want or st["streams"] != TRAIN_STREAMS:
            raise RuntimeError(f"step launched {st['launches']} on "
                               f"{st['streams']} streams, want "
                               f"{per_step_want} on {TRAIN_STREAMS}")
    if any(per_step.values()):
        raise RuntimeError(f"training took the per-step kernels: {per_step}")
    if wide:
        raise RuntimeError(f"the CTC pair took the wide kernel {wide} times")
    losses = [st["loss"] for st in steps]
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise RuntimeError(f"loss did not fall: {losses}")
    if lstmp_forward.launches:
        raise RuntimeError("training launched the inference kernel")
    before, _ = Nnet.load(model, "cpu")
    after, _ = Nnet.load(out, "cpu")
    moved = 0.0
    for (name, p), q in zip(after.state_dict().items(),
                            before.state_dict().values()):
        if not torch.isfinite(p).all():
            raise RuntimeError(f"trained {name} not finite")
        moved = max(moved, float((p - q).abs().max()))
    if moved == 0.0:
        raise RuntimeError("the written model equals the initial one")
    log("train", switch=switch, steps=len(steps), losses=losses,
        launches=launches, per_step_kernel_calls=per_step,
        ctc_wide_kernel_calls=wide, max_param_change=moved)
    return launches


# -- phase 8 -----------------------------------------------------------------

def train_cross_check(model, feats, labels, switch=None):
    from kaldi_aslp_tpu_torch.cli.train_tools import ctc_source
    from kaldi_aslp_tpu_torch.data.sequence import (
        CtcBatcher,
        CtcBatcherOptions,
    )
    from kaldi_aslp_tpu_torch.models import Nnet
    from kaldi_aslp_tpu_torch.models.losses import ctc_batch_loss
    from kaldi_aslp_tpu_torch.train.trainer import upload

    batch = next(iter(CtcBatcher(ctc_source(feats, labels),
                                 CtcBatcherOptions(num_streams=4))))
    out = {}
    for device in ("cuda", "cpu"):
        net, _ = Nnet.load(model, device)
        net.train()
        dev_batch = upload(batch, torch.device(device))
        with switch_env(switch):
            y, _ = net(dev_batch[0], mask=dev_batch[4])
            loss, _ = ctc_batch_loss(y, *dev_batch[1:4])
            loss.backward()
        out[device] = (float(loss.detach()), {n: p.grad.cpu() for n, p in
                                     net.named_parameters()})
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    grad_rel = {n: rel_err(g, out["cpu"][1][n])
                for n, g in out["cuda"][1].items()}
    worst = max(grad_rel, key=grad_rel.get)
    log("train_check", switch=switch, streams=4,
        frames=int(batch.input_lengths.sum()),
        loss_cuda=out["cuda"][0], loss_cpu=out["cpu"][0], loss_rel=loss_rel,
        worst_grad=worst, worst_grad_rel=grad_rel[worst],
        tol={"loss": CROSS_LOSS_RTOL, "grad": CROSS_GRAD_RTOL})
    if loss_rel > CROSS_LOSS_RTOL or grad_rel[worst] > CROSS_GRAD_RTOL:
        raise RuntimeError(f"card vs CPU: loss {loss_rel}, {worst} "
                           f"{grad_rel[worst]}")


# -- phase 9 -----------------------------------------------------------------

def step_split(model, dev, switch=None):
    """One flagship step at the bench's shape, split by CUDA events, with
    ``switch`` set (None: no switch)."""
    with switch_env(switch):
        return _step_split(model, dev, switch)


def _step_split(model, dev, switch):
    from kaldi_aslp_tpu_torch.models import Nnet
    from kaldi_aslp_tpu_torch.models.losses import ctc_batch_loss
    from kaldi_aslp_tpu_torch.train import CtcTrainer, init_velocity
    from kaldi_aslp_tpu_torch.train.sgd import NnetTrainOptions

    S, T, U, V = CTC_SHAPE
    rs = np.random.RandomState(0)
    feats = torch.from_numpy(rs.randn(S, T, FEAT_DIM).astype(np.float32)
                             ).to(dev)
    labels = torch.from_numpy(rs.randint(1, V, (S, U)).astype(np.int32)
                              ).to(dev)
    in_lens = torch.full((S,), T, dtype=torch.int32, device=dev)
    lab_lens = torch.full((S,), U, dtype=torch.int32, device=dev)
    mask = torch.ones((S, T), device=dev)
    net, _ = Nnet.load(model, dev)
    trainer = CtcTrainer(net, NnetTrainOptions(learn_rate=1e-4,
                                               momentum=0.9))
    velocity = init_velocity(net)
    batch = (feats, labels, in_lens, lab_lens, mask)
    trainer.step(velocity, batch, 1e-4)      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    splits = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        for p in net.parameters():
            p.grad = None
        ev[0].record()
        y, _ = net(feats, mask=mask)
        ev[1].record()
        loss, _ = ctc_batch_loss(y, labels, in_lens, lab_lens)
        ev[2].record()
        loss.backward()
        ev[3].record()
        trainer._update(velocity, 1e-4)
        ev[4].record()
        torch.cuda.synchronize()
        splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)])
    med = np.median(np.asarray(splits), axis=0)
    step_ms = float(med.sum())
    reading = {"forward_ms": float(med[0]), "loss_ms": float(med[1]),
               "backward_ms": float(med[2]), "update_ms": float(med[3]),
               "step_ms": step_ms,
               "audio_s_per_s": S * T * 0.01 / (step_ms / 1e3),
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log("step_split", switch=switch, S=S, T=T, U=U, **reading)
    return reading


# -- phase 10 ----------------------------------------------------------------

def lstm_train_kernel_phase(dev):
    from kaldi_aslp_tpu_torch.ops import lstmp_train as lt

    results = {"fwd": [], "bwd": []}
    # (S, T, bf16 storage, bf16 products, strict check)
    rows = [(S, T, bf16, bf16, False) for S, T, bf16 in LSTM_TRAIN_SHAPES]
    rows.append((*LSTM_F32_PRODUCTS_SHAPE, True, False, True))
    for S, T, bf16, mxu, strict in rows:
        fwd_args, bwd_args, (err_f, rel_f, share_f), (err_b, rel_b, share_b) \
            = lstm_train_kernel_check(dev, S, T, bf16, strict, mxu)
        if (S, T, bf16) == (*BPTT_SPLIT_SHAPE, False):
            results["redesign"] = lstm_sweep_phase(dev, fwd_args, bwd_args)
        reps = 3 if T > 100 else 10
        times = {
            "fwd": (cuda_ms(lambda: lt.lstmp_train_fwd(*fwd_args), reps, 1),
                    cuda_ms(lambda: lt.lstmp_train_fwd_reference(*fwd_args),
                            max(reps // 3, 2), 1)),
            "bwd": (cuda_ms(lambda: lt.lstmp_train_bwd(*bwd_args), reps, 1),
                    cuda_ms(lambda: lt.lstmp_train_bwd_reference(*bwd_args),
                            max(reps // 3, 2), 1))}
        for kind, err, rel, share in (("fwd", err_f, rel_f, share_f),
                                      ("bwd", err_b, rel_b, share_b)):
            ms, plain_ms = times[kind]
            results[kind].append({"S": S, "T": T, "bf16": bf16,
                                  "mxu_bf16": mxu, "max_abs_err": err,
                                  "ms": ms, "plain_ms": plain_ms})
            log("lstm_train_kernel", name=f"lstmp_train_{kind}", S=S, T=T,
                C=HYBRID_C, P=HYBRID_P, bf16=bf16, mxu_bf16=mxu,
                strict=strict, rel_err=rel, differing_share=share,
                rtol=LSTM_BF16_RTOL if bf16 else LSTM_F32_RTOL, ms=ms,
                plain_ms=plain_ms)
    S, T = LSTM_ROUNDING_SHAPE
    *_, (err_f, rel_f, share_f), (err_b, rel_b, share_b) = \
        lstm_train_kernel_check(dev, S, T, True, strict=True)
    log("lstm_rounding_check", S=S, T=T, C=HYBRID_C, P=HYBRID_P,
        rel_err={**rel_f, **rel_b}, differing_share={**share_f, **share_b},
        tol={"f32": LSTM_F32_RTOL, "bf16": LSTM_BF16_RTOL,
             "bf16_share": LSTM_BF16_SHARE})
    for kind, err in (("fwd", err_f), ("bwd", err_b)):
        results[kind].append({"S": S, "T": T, "bf16": True,
                              "max_abs_err": err})
    return results


def lstm_sweep_phase(dev, fwd_args, bwd_args):
    """At the reference's BPTT chunk in float32: two runs must give the
    same bits; each kernel's time split by torch.profiler into its
    persistent sweep (which must be one launch a call) and the rest (the
    wrapper's copies; in the backward the weight-gradient reductions); the
    earlier per-step kernels' recorded times; the plan and registers."""
    from kaldi_aslp_tpu_torch.ops import build
    from kaldi_aslp_tpu_torch.ops import lstmp_train as lt

    S, T, G = fwd_args[0].shape
    C_, P_ = G // 4, fwd_args[3].shape[0]
    runs = []
    for _ in range(2):
        gates, cs, rs = lt.lstmp_train_fwd(*fwd_args)
        runs.append((gates, cs, rs, *lt.lstmp_train_bwd(*bwd_args)))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    log("lstm_determinism", S=S, T=T, C=C_, P=P_, outputs=len(runs[0]),
        identical=same)
    if not same:
        raise RuntimeError("two runs of the unidirectional kernels differ")
    del runs

    # the profiles in a process of their own: late in this one,
    # torch.profiler dropped the persistent sweep and every kernel before
    # it from its records
    child = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; "
         "chip_smoke.lstm_profile_child()"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if child.returncode != 0:
        raise RuntimeError(f"profile process failed: {child.stderr[-2000:]}")
    profiles = json.loads(child.stdout.strip().splitlines()[-1])
    split = {}
    for kind, fn in (("fwd", lambda: lt.lstmp_train_fwd(*fwd_args)),
                     ("bwd", lambda: lt.lstmp_train_bwd(*bwd_args))):
        by_kernel, counts = profiles[kind]
        sweep = [k for k in by_kernel if "sweep_kernel" in k]
        per_step = [k for k in by_kernel
                    if any(n in k for n in PER_STEP_KERNELS)]
        launches = sum(counts[k] for k in sweep)
        if launches != 1 or per_step:
            raise RuntimeError(f"lstmp_train_{kind}: not one persistent "
                               f"sweep a call: {counts}")
        split[kind] = {
            "ms": cuda_ms(fn, 10, 1), "source": "torch.profiler",
            "sweep_ms": sum(by_kernel[k] for k in sweep),
            "rest_ms": sum(v for k, v in by_kernel.items() if k not in sweep),
            "sweep_launches": launches, "by_kernel": by_kernel}
        log("lstm_time_split", name=f"lstmp_train_{kind}", S=S, T=T, C=C_,
            P=P_, **split[kind])
    log("earlier_times", recorded_in="PERF.md section 6, the earlier "
        "per-step kernels, not measured in this run", S=S, T=T,
        ms=MS_PER_STEP_LSTM,
        measured_ms={f"lstmp_train_{k}": v["ms"] for k, v in split.items()})

    plan = lt.plan_for(S, C_, P_, dev)
    log_text = build.library_path(lt.SOURCE).with_suffix(".log").read_text()
    for kernel, backward in (("lstmp_fwd_sweep_kernel", False),
                             ("lstmp_bwd_sweep_kernel", True)):
        nb, cpb, stages, smem = plan.kernel_args(backward)
        log("sweep_plan", kernel=kernel, S=S, C=C_, P=P_, path=plan.path,
            blocks=nb, threads=256, cells_per_block=cpb, ring_stages=stages,
            smem_bytes=smem, registers=ptxas_registers(log_text, kernel))
    if not plan.persistent:
        raise RuntimeError(f"the BPTT chunk took the per-step kernels: "
                           f"{plan.reason}")
    return split


def lstm_profile_child():
    """In a fresh process: the unidirectional kernels' device time by
    kernel name and launch counts at the reference's BPTT chunk in float32,
    printed as one JSON line {kind: [ms by kernel, launches by kernel]}."""
    from kaldi_aslp_tpu_torch.ops import lstmp_train as lt

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    fwd_args, bwd_args, _, _ = lstm_train_kernel_check(
        dev, *BPTT_SPLIT_SHAPE, False)
    out = {}
    for kind, fn in (("fwd", lambda: lt.lstmp_train_fwd(*fwd_args)),
                     ("bwd", lambda: lt.lstmp_train_bwd(*bwd_args))):
        counts = {}
        out[kind] = [device_ms_by_kernel(fn, counts), counts]
    print(json.dumps(out), flush=True)


def lstm_train_kernel_check(dev, S, T, bf16, strict=False, mxu_bf16=None):
    """Both training kernels against their plain versions at the LSTM
    hybrid's widths, ragged masks, a nonzero initial state and nonzero
    final-state cotangents, bf16 storage or not, with the products
    ``mxu_bf16`` picks (None: the storage's own): (fwd_args, bwd_args, fwd
    reading, bwd reading), each reading as :func:`hold_lstm` returns
    it."""
    from kaldi_aslp_tpu_torch.ops import lstmp_train as lt

    C_, P_ = HYBRID_C, HYBRID_P
    rs = np.random.RandomState(S * 1000 + T + bf16)
    st = torch.bfloat16 if bf16 else torch.float32

    def t(a):
        return torch.from_numpy(a).to(dev)
    lens = rs.randint(T // 4, T + 1, size=S)
    lens[0] = T
    mask = t((np.arange(T)[None, :] < lens[:, None]).astype(np.float32))
    fwd_args = (t(rs.randn(S, T, 4 * C_).astype(np.float32)).to(st),
                mask, t(uniform(rs, 4 * C_, P_)), t(uniform(rs, P_, C_)),
                t(uniform(rs, 3, C_)), t(uniform(rs, S, C_, scale=0.5)),
                t(uniform(rs, S, P_, scale=0.5)), 50.0, mxu_bf16)
    got = lt.lstmp_train_fwd(*fwd_args)
    want = lt.lstmp_train_fwd_reference(*fwd_args)
    torch.cuda.synchronize()
    fwd = hold_lstm("lstmp_train_fwd", got, want, ("gates", "cs", "rs"),
                    bf16, strict)
    _, mask, w_r, w_rm, peep, c0, r0, *_ = fwd_args
    bwd_args = (t(rs.randn(S, T, P_).astype(np.float32)).to(st), mask,
                *want, w_r, w_rm, peep, c0, r0,
                t(rs.randn(S, C_).astype(np.float32)),
                t(rs.randn(S, P_).astype(np.float32)), 50.0, mxu_bf16)
    got = lt.lstmp_train_bwd(*bwd_args)
    want = lt.lstmp_train_bwd_reference(*bwd_args)
    torch.cuda.synchronize()
    bwd = hold_lstm("lstmp_train_bwd", got, want,
                    ("dxg", "d_init_c", "d_init_r", "d_w_gifo_r", "d_w_r_m",
                     "dpeep"), bf16, strict)
    return fwd_args, bwd_args, fwd, bwd


def hold_lstm(name: str, got, want, names, bf16: bool, strict: bool):
    """:func:`hold` at LSTM_F32_RTOL in float32 and LSTM_BF16_RTOL in
    bf16; ``strict`` in bf16 storage, the rounding check instead (see
    LSTM_BF16_SHARE): on one frame with bf16 products, or on any number
    of frames with float32 products, where no rounding feeds the
    recurrence.  Returns the largest absolute error, and each output's
    relative error and share of differing elements."""
    worst, rel, share = 0.0, {}, {}
    for n, g, w in zip(names, got, want):
        bf16_valued = g.dtype == torch.bfloat16
        kernel_f32 = not bf16_valued and n not in LSTM_REDUCTIONS
        rtol = LSTM_BF16_RTOL if bf16 and not (strict and kernel_f32) \
            else LSTM_F32_RTOL
        err, r = hold(name, [g], [w], [n], rtol)
        worst, rel[n] = max(worst, err), r[n]
        share[n] = float((g != w).float().mean())
        if strict and bf16_valued and share[n] > LSTM_BF16_SHARE:
            raise RuntimeError(f"{name} {n}: {share[n]} of the bf16 values "
                               f"differ, more than {LSTM_BF16_SHARE}")
    return worst, rel, share


# -- phase 11 ----------------------------------------------------------------

def write_bptt_files(workdir: str):
    """The full-width LSTM hybrid at the model's init (numpy seed 2468) and
    a corpus of BPTT_UTTS utterances of 80-160 frames whose frame targets
    are a function of the features: one of 32 pdfs, picked by the argmax
    of a fixed projection of the frame."""
    from kaldi_aslp_tpu_torch.io import int_vector_writer, matrix_writer
    from kaldi_aslp_tpu_torch.models.flagship import build_lstm_hybrid

    rs = np.random.RandomState(2468)
    net = build_lstm_hybrid(FEAT_DIM, HYBRID_LAYERS, HYBRID_P, HYBRID_C,
                            HYBRID_PDFS)
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(torch.from_numpy(
                (0.04 * rs.randn(*p.shape)).astype(np.float32)
                if name.endswith(".w") else np.zeros(p.shape, np.float32)
                if name.endswith(".b") else uniform(rs, *p.shape)))
    model = f"{workdir}/lstm_hybrid.zip"
    net.save(model)
    proj = rs.randn(FEAT_DIM, 32)
    pdfs = rs.choice(HYBRID_PDFS, 32, replace=False).astype(np.int32)
    with matrix_writer(f"ark,scp:{workdir}/bptt_feats.ark,"
                       f"{workdir}/bptt_feats.scp") as fw, \
            int_vector_writer(f"ark:{workdir}/bptt_ali.ark") as tw:
        for i in range(BPTT_UTTS):
            feats = rs.randn(rs.randint(80, 161), FEAT_DIM).astype(np.float32)
            fw[f"utt{i:02d}"] = feats
            tw[f"utt{i:02d}"] = pdfs[np.argmax(feats @ proj, axis=1)]
    return (model, f"scp:{workdir}/bptt_feats.scp",
            f"ark:{workdir}/bptt_ali.ark")


def bptt_counts():
    from kaldi_aslp_tpu_torch.ops.lstmp import lstmp_forward
    from kaldi_aslp_tpu_torch.ops.lstmp_train import (
        lstmp_train_bwd,
        lstmp_train_fwd,
    )
    return {"lstmp_train_fwd": lstmp_train_fwd,
            "lstmp_train_bwd": lstmp_train_bwd,
            "lstmp_forward": lstmp_forward}


def run_cli(argv):
    """The CLI's exit code and what it printed (echoed here too)."""
    import contextlib
    import io

    from kaldi_aslp_tpu_torch.cli.__main__ import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    print(out.getvalue(), end="", flush=True)
    return rc, out.getvalue()


def bptt_train_phase(model, feats, targets, workdir):
    from kaldi_aslp_tpu_torch.models import Nnet
    from kaldi_aslp_tpu_torch.train.trainer import LstmStreamsTrainer

    wrappers = bptt_counts()
    per_step_want = {"lstmp_train_fwd": HYBRID_LAYERS,
                     "lstmp_train_bwd": HYBRID_LAYERS, "lstmp_forward": 0}
    steps = []
    inner_step = LstmStreamsTrainer.step

    def step(self, velocity, states, chunk, learn_rate):
        before = {n: w.launches for n, w in wrappers.items()}
        t0 = time.perf_counter()
        states, loss, aux = inner_step(self, velocity, states, chunk,
                                       learn_rate)
        loss = float(loss)   # syncs the card
        steps.append({"loss": loss, "s": time.perf_counter() - t0,
                      "frames": int(aux["frames"]),
                      "launches": {n: w.launches - before[n]
                                   for n, w in wrappers.items()}})
        return states, torch.tensor(loss), aux

    out = f"{workdir}/lstm_hybrid_trained.zip"
    LstmStreamsTrainer.step = step
    try:
        for n, w in wrappers.items():
            w.launches = 0
            if n.startswith("lstmp_train"):
                w.per_step = 0
        rc, printed = run_cli(["aslp-nnet-train-lstm-streams",
                               "--device=cuda", "--momentum=0.9", *BPTT_ARGS,
                               feats, targets, model, out])
        launches = {n: w.launches for n, w in wrappers.items()}
        # every training launch took the persistent sweeps
        per_step = {n: w.per_step for n, w in wrappers.items()
                    if n.startswith("lstmp_train")}
    finally:
        LstmStreamsTrainer.step = inner_step
    losses = [st["loss"] for st in steps]
    log("bptt_steps", steps=len(steps), losses=losses,
        frames=[st["frames"] for st in steps],
        step_s=[st["s"] for st in steps])
    if rc != 0 or len(steps) < 8 or "FRAME_ACCURACY" not in printed:
        raise RuntimeError(f"trainer exit {rc}, {len(steps)} steps")
    for st in steps:
        if st["launches"] != per_step_want:
            raise RuntimeError(f"step launched {st['launches']}, want "
                               f"{per_step_want}")
    q = len(losses) // 4
    first, last = float(np.mean(losses[:q])), float(np.mean(losses[-q:]))
    if not np.isfinite(losses).all() or not last < first:
        raise RuntimeError(f"loss did not fall: {losses}")
    before, _ = Nnet.load(model, "cpu")
    after, _ = Nnet.load(out, "cpu")
    moved = 0.0
    for (name, p), q_ in zip(after.state_dict().items(),
                             before.state_dict().values()):
        if not torch.isfinite(p).all():
            raise RuntimeError(f"trained {name} not finite")
        moved = max(moved, float((p - q_).abs().max()))
    if moved == 0.0:
        raise RuntimeError("the written model equals the initial one")
    log("bptt_train", steps=len(steps), first_quarter_loss=first,
        last_quarter_loss=last, launches=launches, max_param_change=moved,
        per_step_kernel_calls=per_step)
    if any(per_step.values()):
        raise RuntimeError(f"the BPTT run took the per-step kernels: "
                           f"{per_step}")

    # cross-validation: eval() forward on the inference kernel, no update
    seen = {}
    inner_eval = LstmStreamsTrainer.evaluate

    def evaluate(self, chunks, num_streams, reporter=None):
        params = {k: v.clone() for k, v in self.net.state_dict().items()}
        seen["chunks"] = 0

        def counted():
            for chunk in chunks:
                seen["chunks"] += 1
                yield chunk
        rep = inner_eval(self, counted(), num_streams, reporter)
        seen["unchanged"] = all(torch.equal(v, params[k]) for k, v in
                                self.net.state_dict().items())
        return rep

    LstmStreamsTrainer.evaluate = evaluate
    try:
        for w in wrappers.values():
            w.launches = w.per_step = 0
        rc, printed = run_cli(["aslp-nnet-train-lstm-streams",
                               "--device=cuda", "--cross-validate=true",
                               *BPTT_ARGS, feats, targets, out])
        cv_launches = {n: w.launches for n, w in wrappers.items()}
        cv_per_step = wrappers["lstmp_forward"].per_step
    finally:
        LstmStreamsTrainer.evaluate = inner_eval
    want = {"lstmp_train_fwd": 0, "lstmp_train_bwd": 0,
            "lstmp_forward": HYBRID_LAYERS * seen.get("chunks", -1)}
    log("bptt_cv", chunks=seen.get("chunks"), launches=cv_launches,
        per_step=cv_per_step, params_unchanged=seen.get("unchanged"))
    if rc != 0 or "FRAME_ACCURACY" not in printed or cv_launches != want \
            or cv_per_step or not seen.get("unchanged") \
            or not seen["chunks"]:
        raise RuntimeError(f"cross-validation: exit {rc}, {cv_launches} "
                           f"({cv_per_step} on the per-step kernels), want "
                           f"{want}, {seen}")
    launches["lstmp_forward_cv"] = cv_launches["lstmp_forward"]
    return launches


# -- phase 12 ----------------------------------------------------------------

def bptt_cross_check(model, feats, targets):
    from kaldi_aslp_tpu_torch.cli.train_tools import frame_source
    from kaldi_aslp_tpu_torch.data.sequence import (
        SequenceDataReader,
        SequenceReaderOptions,
    )
    from kaldi_aslp_tpu_torch.models import BLstmProjectedStreams, Nnet
    from kaldi_aslp_tpu_torch.models.losses import xent_loss
    from kaldi_aslp_tpu_torch.train.trainer import upload_chunk

    chunk = next(iter(SequenceDataReader(
        frame_source(feats, targets),
        SequenceReaderOptions(num_streams=BPTT_STREAMS))))
    rs = np.random.RandomState(3)
    carried = {str(i): {"c": uniform(rs, BPTT_STREAMS, HYBRID_C, scale=0.5),
                        "r": uniform(rs, BPTT_STREAMS, HYBRID_P, scale=0.5)}
               for i in range(HYBRID_LAYERS)}
    out, evals = {}, {}
    for device in ("cuda", "cpu"):
        dev = torch.device(device)
        net, _ = Nnet.load(model, dev)
        x, tgt, mask, _ = upload_chunk(chunk, dev)
        states = {k: {kk: torch.from_numpy(vv).to(dev)
                      for kk, vv in v.items()} for k, v in carried.items()}
        # the cross-validation forward: eval(), the inference kernel
        net.eval()
        with torch.no_grad():
            y, _ = net(x, states, mask=mask)
            loss, _ = xent_loss(y, tgt, mask)
        evals[device] = (float(loss), y.cpu())
        net.train()
        y, _ = net(x, states, mask=mask)
        loss, _ = xent_loss(y, tgt, mask)
        loss.backward()
        out[device] = (float(loss.detach()),
                       {n: p.grad.cpu() for n, p in net.named_parameters()})
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    grad_rel = {n: rel_err(g, out["cpu"][1][n])
                for n, g in out["cuda"][1].items()}
    eval_loss_rel = abs(evals["cuda"][0] - evals["cpu"][0]) / abs(
        evals["cpu"][0])
    eval_out_rel = rel_err(evals["cuda"][1], evals["cpu"][1])
    if not torch.isfinite(evals["cuda"][1]).all():
        raise RuntimeError("eval() outputs on the card are not finite")

    # one float32 BLSTMP layer: each direction through the training core
    S, T = BPTT_STREAMS, 20
    lens = rs.randint(T // 4, T + 1, size=S)
    lens[0] = T
    arrays = {"x": rs.randn(S, T, FEAT_DIM).astype(np.float32),
              "mask": (np.arange(T)[None, :] < lens[:, None]).astype(
                  np.float32),
              "w": rs.randn(S, T, 2 * HYBRID_P).astype(np.float32)}
    comp = BLstmProjectedStreams(FEAT_DIM, 2 * HYBRID_P, cell_dim=HYBRID_C)
    with torch.no_grad():
        for p in comp.parameters():
            p.copy_(torch.from_numpy(uniform(rs, *p.shape)))
    bi = {}
    for device in ("cuda", "cpu"):
        comp.to(device).train()
        comp.zero_grad()
        t = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
        ys, _ = comp(t["x"], mask=t["mask"])
        (ys * t["w"]).sum().backward()
        bi[device] = {n: p.grad.cpu() for n, p in comp.named_parameters()}
    bi_rel = {n: rel_err(g, bi["cpu"][n]) for n, g in bi["cuda"].items()}
    worst = max(grad_rel, key=grad_rel.get)
    bi_worst = max(bi_rel, key=bi_rel.get)
    log("bptt_check", streams=S, frames=int(chunk.frame_mask.sum()),
        loss_cuda=out["cuda"][0], loss_cpu=out["cpu"][0], loss_rel=loss_rel,
        worst_grad=worst, worst_grad_rel=grad_rel[worst],
        eval_loss_cuda=evals["cuda"][0], eval_loss_rel=eval_loss_rel,
        eval_out_rel=eval_out_rel,
        blstmp_worst_grad=bi_worst, blstmp_worst_grad_rel=bi_rel[bi_worst],
        tol={"loss": BPTT_LOSS_RTOL, "grad": BPTT_GRAD_RTOL,
             "eval_out": BPTT_EVAL_RTOL})
    if loss_rel > BPTT_LOSS_RTOL or grad_rel[worst] > BPTT_GRAD_RTOL \
            or bi_rel[bi_worst] > BPTT_GRAD_RTOL \
            or eval_loss_rel > BPTT_LOSS_RTOL \
            or eval_out_rel > BPTT_EVAL_RTOL:
        raise RuntimeError(f"card vs CPU: loss {loss_rel}, {worst} "
                           f"{grad_rel[worst]}, {bi_worst} {bi_rel[bi_worst]}"
                           f", eval loss {eval_loss_rel}, eval outputs "
                           f"{eval_out_rel}")


# -- phase 13 ----------------------------------------------------------------

def bptt_step_split(model, dev):
    """One LSTM hybrid step at S=100, T=20, split by CUDA events."""
    from kaldi_aslp_tpu_torch.models import Nnet
    from kaldi_aslp_tpu_torch.models.losses import xent_loss
    from kaldi_aslp_tpu_torch.train import LstmStreamsTrainer, init_velocity
    from kaldi_aslp_tpu_torch.train.sgd import NnetTrainOptions

    S, T = BPTT_SPLIT_SHAPE
    rs = np.random.RandomState(0)
    feats = torch.from_numpy(rs.randn(S, T, FEAT_DIM).astype(np.float32)
                             ).to(dev)
    targets = torch.from_numpy(
        rs.randint(0, HYBRID_PDFS, (S, T)).astype(np.int32)).to(dev)
    mask = torch.ones((S, T), device=dev)
    flags = torch.zeros((S,), dtype=torch.int32, device=dev)
    net, _ = Nnet.load(model, dev)
    trainer = LstmStreamsTrainer(net, NnetTrainOptions(learn_rate=1e-4,
                                                       momentum=0.9))
    velocity = init_velocity(net)
    states = trainer.init_state(S)
    states, _, _ = trainer.step(velocity, states,
                                (feats, targets, mask, flags), 1e-4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    splits = []
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        for p in net.parameters():
            p.grad = None
        ev[0].record()
        y, new_states = net(feats, states, mask=mask)
        ev[1].record()
        loss, _ = xent_loss(y, targets, mask)
        ev[2].record()
        loss.backward()
        ev[3].record()
        trainer._update(velocity, 1e-4)
        ev[4].record()
        torch.cuda.synchronize()
        states = {k: {kk: vv.detach() for kk, vv in v.items()}
                  for k, v in new_states.items()}
        splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)])
    med = np.median(np.asarray(splits), axis=0)
    step_ms = float(med.sum())
    log("bptt_step_split", S=S, T=T, C=HYBRID_C, P=HYBRID_P,
        pdfs=HYBRID_PDFS, forward_ms=float(med[0]), loss_ms=float(med[1]),
        backward_ms=float(med[2]), update_ms=float(med[3]), step_ms=step_ms,
        frames_per_s=S * T / (step_ms / 1e3),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


# -- phase 14: the CTC recipe --------------------------------------------------

def recipe_corpus_phase():
    """Build the hard corpus with its front end on the card; synthesize it
    again (the same seeds), time each set's front end alone and hold the
    test set's features against the port on the CPU."""
    from kaldi_aslp_tpu_torch.feats.batch import compute_batched
    from kaldi_aslp_tpu_torch.feats.mel import MelBanksOptions
    from kaldi_aslp_tpu_torch.feats.mfcc import Mfcc, MfccOptions
    from kaldi_aslp_tpu_torch.feats.window import FrameExtractionOptions
    from kaldi_aslp_tpu_torch.recipes import hard_corpus as hc

    opts = hc.HardCorpusOptions(**RECIPE_CORPUS)
    t0 = time.perf_counter()
    corpus = hc.build_corpus(opts, device="cuda", **RECIPE_SIZES)
    build_s = time.perf_counter() - t0
    syn = hc.synthesize_corpus(opts, **RECIPE_SIZES)
    splits = ("train", "dev", "test")
    extract_ms, audio_s = {}, {}
    for split in splits:
        waves = syn[f"{split}_waves"]
        audio_s[split] = sum(len(w) for w in waves.values()) / hc.SAMP_FREQ
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hc.extract_mfcc_deltas_cmvn(waves, syn[f"{split}_utt2spk"],
                                    device="cuda")
        extract_ms[split] = 1e3 * (time.perf_counter() - t0) / len(waves)
    waves = syn["test_waves"]
    want = hc.extract_mfcc_deltas_cmvn(waves, syn["test_utt2spk"],
                                       device="cpu")
    feat_err = 0.0
    for u, f in want.items():
        got = corpus["test_feats"][u]
        np.testing.assert_allclose(got, f, **RECIPE_FEAT_TOL)
        feat_err = max(feat_err, float(np.abs(got - f).max()))
    mfcc = Mfcc(FrameExtractionOptions(samp_freq=hc.SAMP_FREQ, dither=0.0),
                MelBanksOptions(num_bins=23), MfccOptions())
    mfcc_ms = cuda_ms(lambda: compute_batched(mfcc, waves), reps=5)
    frames = [len(f) for split in splits
              for f in corpus[f"{split}_feats"].values()]
    log("corpus", utterances={s: len(corpus[f"{s}_feats"]) for s in splits},
        audio_s=audio_s, frames=[min(frames), max(frames)],
        feature_dim=next(iter(corpus["train_feats"].values())).shape[1],
        phones=len(corpus["lang"].phones) - 1,
        extract_ms_per_utt=extract_ms,
        mfcc_ms_per_utt=mfcc_ms / len(waves), mfcc_utts_timed=len(waves),
        feat_max_abs_err=feat_err, feat_tol=RECIPE_FEAT_TOL,
        build_s=build_s)
    return corpus


def recipe_phase(corpus, workdir):
    """The recipe end to end on the card: train, cross-validate, decode,
    score, checkpoint; every loss evaluation is one CTC pair launch and
    no other hand kernel runs."""
    from kaldi_aslp_tpu_torch.decoder.beam import BeamSearchDecoder, CsrGraph
    from kaldi_aslp_tpu_torch.decoder.viterbi import DecodeError, PackedGraph
    from kaldi_aslp_tpu_torch.fst import arpa_to_fst, ctc_lut
    from kaldi_aslp_tpu_torch.ops.edit_distance import score_utterances
    from kaldi_aslp_tpu_torch.ops.lstmp import blstmp_forward, lstmp_forward
    from kaldi_aslp_tpu_torch.recipes import CtcRecipe, CtcRecipeOptions
    from kaldi_aslp_tpu_torch.train import load_checkpoint

    lang = corpus["lang"]
    t0 = time.perf_counter()
    G = arpa_to_fst(corpus["arpa"], lang.words)
    log("grammar", states=G.num_states, arcs=G.num_arcs,
        seconds=time.perf_counter() - t0)
    wrappers = train_kernel_wrappers()
    others = (lstmp_forward, blstmp_forward)
    for w in (*wrappers.values(), *others):
        w.launches = 0
    wrappers["ctc_alpha_beta"].wide = 0
    rec = CtcRecipe(lang, CtcRecipeOptions(**RECIPE_OPTS))
    work = os.path.join(workdir, "ctc_recipe")
    t0 = time.perf_counter()
    stats = rec.run(corpus["train_feats"], corpus["train_texts"],
                    corpus["test_feats"], corpus["test_texts"], grammar=G,
                    work_dir=work, dev_feats=corpus["dev_feats"],
                    dev_texts=corpus["dev_texts"])
    run_s = time.perf_counter() - t0
    launches = {n: w.launches for n, w in wrappers.items()}
    wide = wrappers["ctc_alpha_beta"].wide
    inference = {w.__name__: w.launches for w in others}
    for e in rec.epochs:
        log("recipe_epoch", **e)
    evaluations = sum(e["train_batches"] + e["cv_batches"]
                      for e in rec.epochs)
    if launches["ctc_alpha_beta"] != evaluations:
        raise RuntimeError(f"{launches['ctc_alpha_beta']} CTC pair launches "
                           f"for {evaluations} loss evaluations")
    stray = {n: k for n, k in {**launches, **inference}.items()
             if k and n != "ctc_alpha_beta"}
    if stray:
        raise RuntimeError(f"the recipe launched other kernels: {stray}")
    losses = [e["train_loss"] for e in rec.epochs]
    if not np.isfinite(losses).all() or not losses[1] < losses[0]:
        raise RuntimeError(f"training loss did not fall: {losses}")
    # decode the test set again, timed, from the recipe's own system with
    # the recipe's decoder settings
    V = rec.num_outputs
    dec = BeamSearchDecoder(
        CsrGraph.from_packed(PackedGraph.from_fst(rec.tlg)), ctc_lut(V),
        beam=RECIPE_OPTS["decode_beam"],
        max_active=RECIPE_OPTS["decode_max_active"])
    post_s = dec_s = 0.0
    hyps = {}
    for u in sorted(corpus["test_feats"]):
        t0 = time.perf_counter()
        logp = rec.posteriors(corpus["test_feats"][u])
        t1 = time.perf_counter()
        try:
            words, _, _ = dec.decode(rec.acoustic_scale
                                     * (logp - rec.log_priors))
        except DecodeError:
            words = []
        dec_s += time.perf_counter() - t1
        post_s += t1 - t0
        hyps[u] = [lang.words.sym(w) for w in words]
    again = score_utterances(corpus["test_texts"], hyps)
    if again.wer != stats.wer:
        raise RuntimeError(f"decoding again gave WER {again.wer}, the "
                           f"recipe {stats.wer}")
    n = len(hyps)
    log("recipe_decode", acoustic_scale=rec.acoustic_scale,
        prior_scale=rec.prior_scale, dev_wer=rec.dev_wer,
        greedy_per=rec.greedy_per, wer=stats.wer, report=stats.report(),
        posteriors_ms_per_utt=1e3 * post_s / n,
        decode_ms_per_utt=1e3 * dec_s / n, utts=n,
        graph_states=rec.tlg.num_states, graph_arcs=rec.tlg.num_arcs,
        run_s=run_s)
    params, _, states, meta = load_checkpoint(os.path.join(work,
                                                           "final.ckpt"))
    if sorted(params) != sorted(rec.best_params) or any(
            not torch.equal(params[k], rec.best_params[k].cpu())
            for k in params):
        raise RuntimeError("final.ckpt does not hold the best parameters")
    if (not np.array_equal(states["log_priors"].numpy(), rec.log_priors)
            or meta["wer"] != stats.wer):
        raise RuntimeError(f"final.ckpt states or meta wrong: {meta}")
    log("recipe", loss_evaluations=evaluations, launches=launches,
        ctc_wide_kernel_calls=wide, inference_kernel_calls=inference,
        checkpoint_keys=len(params), checkpoint_meta=meta)
    return rec, launches, wide


def recipe_ctc_check(rec, corpus):
    """The CTC pair at each of the recipe's batches (its training and
    cross-validation batches, on the trained net's emissions): one launch
    a batch, on the kernel its plan names, against the plain recursions
    on the same tensors."""
    from kaldi_aslp_tpu_torch.ops import ctc_recursions as cab
    from kaldi_aslp_tpu_torch.ops.ctc import ctc_emissions
    from kaldi_aslp_tpu_torch.train.trainer import upload

    pair = cab.ctc_alpha_beta
    train, cv = rec.batches(corpus["train_feats"], corpus["train_texts"])
    rec.net.eval()
    rows = []
    for batch in train + cv:
        feats, labels, in_lens, lab_lens, mask = upload(
            batch, torch.device("cuda"))
        with torch.no_grad():
            y, _ = rec.net(feats, mask=mask)
            lp_t, skip_ok, _, _, exp_lens = ctc_emissions(
                torch.log_softmax(y.float(), -1), labels, lab_lens)
        args = (lp_t, skip_ok, in_lens.to(torch.int32), exp_lens)
        plan = cab.plan_for(lp_t.shape[2])
        before = (pair.launches, pair.wide)
        got = pair(*args)
        want = cab.ctc_alpha_beta_reference(*args)
        torch.cuda.synchronize()
        ran = (pair.launches - before[0], pair.wide - before[1])
        if ran != (1, int(plan.wide)):
            raise RuntimeError(f"U' = {lp_t.shape[2]}: (launches, wide) "
                               f"{ran}, plan {plan}")
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **CTC_TOL)
        rows.append({"S": lp_t.shape[1], "T": lp_t.shape[0],
                     "ctc_states": lp_t.shape[2],
                     "states_per_lane": plan.states_per_lane,
                     "wide": plan.wide,
                     "max_abs_err": max(finite_err(g, w)
                                        for g, w in zip(got, want))})
    log("recipe_ctc_pair", batches=rows, tol=CTC_TOL)
    return {"batches": len(rows),
            "ctc_states": sorted({r["ctc_states"] for r in rows}),
            "states_per_lane": sorted({r["states_per_lane"] for r in rows}),
            "max_abs_err": max(r["max_abs_err"] for r in rows)}


def recipe_batch(rec, corpus):
    """The corpus's longest training batch as the recipe batches it."""
    from kaldi_aslp_tpu_torch.data.sequence import (
        CtcBatcher,
        CtcBatcherOptions,
    )
    o = rec.opts
    src = ((u, f, rec.phone_labels(corpus["train_texts"][u]))
           for u, f in sorted(corpus["train_feats"].items()))
    batches = list(CtcBatcher(src, CtcBatcherOptions(
        num_streams=o.num_streams, skip_width=o.lfr_skip,
        bucket_time=o.bucket_time, bucket_labels=o.bucket_labels)))
    return max(batches, key=lambda b: b.feats.shape[1])


def recipe_step_split(rec, batch):
    """One training step of the recipe's net at its longest batch, split
    by CUDA events, and its kernel launches by torch.profiler."""
    from kaldi_aslp_tpu_torch.models.losses import ctc_batch_loss
    from kaldi_aslp_tpu_torch.ops.ctc_recursions import plan_for
    from kaldi_aslp_tpu_torch.train import (
        CtcTrainer,
        NnetTrainOptions,
        init_velocity,
    )
    from kaldi_aslp_tpu_torch.train.trainer import upload

    net = rec._build_net(batch.feats.shape[2], rec.num_outputs).cuda()
    net.load_state_dict(rec.best_params)
    trainer = CtcTrainer(net, NnetTrainOptions(momentum=0.9))
    velocity = init_velocity(net)
    feats, labels, in_lens, lab_lens, mask = upload(batch,
                                                    torch.device("cuda"))
    lr = RECIPE_OPTS["learn_rate"]
    trainer.step(velocity, (feats, labels, in_lens, lab_lens, mask), lr)
    torch.cuda.synchronize()
    splits = []
    for _ in range(RECIPE_SPLIT_REPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        for p in net.parameters():
            p.grad = None
        t0 = time.perf_counter()
        ev[0].record()
        y, _ = net(feats, mask=mask)
        ev[1].record()
        loss, _ = ctc_batch_loss(y, labels, in_lens, lab_lens)
        ev[2].record()
        loss.backward()
        ev[3].record()
        trainer._update(velocity, lr)
        ev[4].record()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
                      + [1e3 * host_s])
    med = np.median(np.asarray(splits), axis=0)
    step_ms = float(med[:4].sum())
    counts = {}
    by_kernel = device_ms_by_kernel(
        lambda: trainer.step(velocity, (feats, labels, in_lens, lab_lens,
                                        mask), lr), counts)
    kernels = {k: c for k, c in counts.items()
               if not k.startswith(("Memcpy", "Memset"))}
    device_ms = sum(v for k, v in by_kernel.items() if k in kernels)
    S, T, D = batch.feats.shape
    Up = 2 * batch.labels.shape[1] + 1
    log("recipe_step_split", S=S, T=T, D=D, C=RECIPE_OPTS["hidden_dim"],
        layers=RECIPE_OPTS["num_layers"], U=batch.labels.shape[1],
        ctc_states=Up, ctc_plan=vars(plan_for(Up)),
        forward_ms=float(med[0]), loss_ms=float(med[1]),
        backward_ms=float(med[2]), update_ms=float(med[3]),
        step_ms=step_ms, host_step_ms=float(med[4]),
        audio_s_per_s=float(batch.input_lengths.sum()) * 0.01
        * RECIPE_OPTS["lfr_skip"] / (step_ms / 1e3),
        kernel_launches_per_step=sum(kernels.values()),
        kernels_by_name=len(kernels), device_busy_ms=device_ms,
        device_busy_share=device_ms / step_ms,
        top_kernels=dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:6]),
        reps=RECIPE_SPLIT_REPS)


def recipe_cross_check(rec, batch, corpus):
    """One step of the recipe's full-width net on the card and on the CPU
    from the same parameters; one utterance's posteriors."""
    from kaldi_aslp_tpu_torch.models.losses import ctc_batch_loss
    from kaldi_aslp_tpu_torch.train.trainer import upload

    out = {}
    for device in ("cuda", "cpu"):
        dev = torch.device(device)
        net = rec._build_net(batch.feats.shape[2], rec.num_outputs).to(dev)
        net.load_state_dict(rec.best_params)
        net.train()
        feats, labels, in_lens, lab_lens, mask = upload(batch, dev)
        y, _ = net(feats, mask=mask)
        loss, _ = ctc_batch_loss(y, labels, in_lens, lab_lens)
        loss.backward()
        u = sorted(corpus["test_feats"])[0]
        x = torch.from_numpy(np.ascontiguousarray(
            corpus["test_feats"][u][::RECIPE_OPTS["lfr_skip"]]))[None]
        net.eval()
        with torch.no_grad():
            post = torch.log_softmax(net(x.to(dev))[0][0], dim=-1).cpu()
        out[device] = (float(loss.detach()), {
            n: p.grad.cpu() for n, p in net.named_parameters()}, post)
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    grad_rel = {n: rel_err(g, out["cpu"][1][n])
                for n, g in out["cuda"][1].items()}
    worst = max(grad_rel, key=grad_rel.get)
    post_err = float((out["cuda"][2] - out["cpu"][2]).abs().max())
    log("recipe_check", S=batch.feats.shape[0], T=batch.feats.shape[1],
        loss_cuda=out["cuda"][0], loss_cpu=out["cpu"][0], loss_rel=loss_rel,
        worst_grad=worst, worst_grad_rel=grad_rel[worst],
        posteriors_frames=out["cpu"][2].shape[0],
        posteriors_max_abs_err=post_err,
        tol={"loss": RECIPE_LOSS_RTOL, "grad": RECIPE_GRAD_RTOL,
             "posteriors": RECIPE_POST_ATOL})
    if (loss_rel > RECIPE_LOSS_RTOL or grad_rel[worst] > RECIPE_GRAD_RTOL
            or post_err > RECIPE_POST_ATOL):
        raise RuntimeError(f"recipe card vs CPU: loss {loss_rel}, {worst} "
                           f"{grad_rel[worst]}, posteriors {post_err}")


def ctc_recipe_phase(workdir):
    corpus = recipe_corpus_phase()
    rec, launches, wide = recipe_phase(corpus, workdir)
    ctc_check = recipe_ctc_check(rec, corpus)
    batch = recipe_batch(rec, corpus)
    recipe_step_split(rec, batch)
    recipe_cross_check(rec, batch, corpus)
    return launches, wide, ctc_check, rec, corpus


def timed_decode(dec, loglikes):
    """(words, alignment, score) of one decode, or None where the graph
    holds no path, and its wall ms to the result on the host."""
    from kaldi_aslp_tpu_torch.decoder.viterbi import DecodeError
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out = dec.decode(loglikes)
    except DecodeError:
        out = None
    return out, 1e3 * (time.perf_counter() - t0)


def beam_phase(rec, corpus):
    """The recipe's dev and test sets through the beam decoder at the
    ladder's settings on the card, each held to the CPU's decode; the
    test set at a wide beam held to the dense Viterbi; one utterance's
    launches a frame by torch.profiler."""
    from kaldi_aslp_tpu_torch.decoder.beam import BeamSearchDecoder, CsrGraph
    from kaldi_aslp_tpu_torch.decoder.viterbi import (
        PackedGraph,
        ViterbiDecoder,
    )
    from kaldi_aslp_tpu_torch.fst import ctc_lut

    packed = PackedGraph.from_fst(rec.tlg)
    csr = CsrGraph.from_packed(packed)
    lut = ctc_lut(rec.num_outputs)
    settings = dict(beam=RECIPE_OPTS["decode_beam"],
                    max_active=RECIPE_OPTS["decode_max_active"])
    card = BeamSearchDecoder(csr, lut, **settings)
    cpu = BeamSearchDecoder(csr, lut, device="cpu", **settings)
    loglikes = {}
    for split in ("dev", "test"):
        for u in sorted(corpus[f"{split}_feats"]):
            logp = rec.posteriors(corpus[f"{split}_feats"][u])
            loglikes[split, u] = (rec.acoustic_scale
                                  * (logp - rec.log_priors))
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    card_ms, cpu_ms, frames, worst, failed = [], [], 0, 0.0, 0
    singles = {}
    for key, m in loglikes.items():
        got, ms = timed_decode(card, m)
        want, ms_cpu = timed_decode(cpu, m)
        singles[key] = got
        card_ms.append(ms)
        cpu_ms.append(ms_cpu)
        frames += len(m)
        if (got is None) != (want is None):
            raise RuntimeError(f"{key}: card decode {got}, CPU {want}")
        if got is None:
            failed += 1
            continue
        rel = abs(got[2] - want[2]) / abs(want[2])
        worst = max(worst, rel)
        if (got[0] != want[0] or not np.array_equal(got[1], want[1])
                or rel > BEAM_SCORE_RTOL):
            raise RuntimeError(f"{key}: card {got[0]} {got[2]}, CPU "
                               f"{want[0]} {want[2]}")
    stray = {n: w.launches for n, w in wrappers.items() if w.launches}
    if stray:
        raise RuntimeError(f"the beam decoder launched hand kernels: {stray}")
    # wide: every state fits the frontier and every arc the budgets, so
    # nothing is pruned and the best path is the dense Viterbi's
    K_wide = 1 << (packed.num_states - 1).bit_length()
    wide = BeamSearchDecoder(csr, lut, beam=WIDE_BEAM, max_active=K_wide)
    dense = ViterbiDecoder(packed, lut)
    wide_ms, dense_ms = [], []
    for key, m in loglikes.items():
        if key[0] != "test":
            continue
        got, ms = timed_decode(wide, m)
        want, ms_dense = timed_decode(dense, m)
        wide_ms.append(ms)
        dense_ms.append(ms_dense)
        if got is None or want is None or got[0] != want[0] or abs(
                got[2] - want[2]) > BEAM_SCORE_RTOL * abs(want[2]):
            raise RuntimeError(f"{key}: wide beam {got}, dense {want}")
    # one utterance, the longest test one: launches a frame, device time
    key = max((k for k in loglikes if k[0] == "test"),
              key=lambda k: len(loglikes[k]))
    counts = {}
    by_kernel = device_ms_by_kernel(lambda: card.decode(loglikes[key]),
                                    counts)
    kernels = {k: c for k, c in counts.items()
               if not k.startswith(("Memcpy", "Memset"))}
    _, one_ms = timed_decode(card, loglikes[key])
    T = len(loglikes[key])
    device_ms = sum(v for k, v in by_kernel.items() if k in kernels)
    n = len(card_ms)
    log("beam", utts=n, frames=frames, decode_failures=failed,
        K=card.K, A=card.A, A_em=card.A_em, eps_rounds=card.eps_rounds,
        beam=card.beam, graph_states=packed.num_states,
        graph_arcs=len(packed.src),
        card_ms_per_utt=float(np.mean(card_ms)),
        card_ms_per_frame=float(np.sum(card_ms)) / frames,
        cpu_ms_per_utt=float(np.mean(cpu_ms)),
        worst_score_rel=worst, score_rtol=BEAM_SCORE_RTOL,
        wide={"K": K_wide, "A": wide.A, "A_em": wide.A_em,
              "utts": len(wide_ms), "beam_ms_per_utt": float(
                  np.mean(wide_ms)),
              "dense_ms_per_utt": float(np.mean(dense_ms))},
        profiled={"T": T, "ms": one_ms,
                  "kernel_launches": sum(kernels.values()),
                  "launches_per_frame": sum(kernels.values()) / T,
                  "device_busy_ms": device_ms,
                  "device_busy_share": device_ms / one_ms,
                  "top_kernels": dict(sorted(
                      kernels.items(), key=lambda kv: -kv[1])[:6])})
    return loglikes, singles


def budget_sweep_phase(rec, corpus):
    """The port's nn_budget_sweep on the trained recipe, each K timed."""
    from kaldi_aslp_tpu_torch.recipes.decode_budget_sweep import (
        nn_budget_sweep,
    )
    wer, seconds = {}, {}
    for K in BUDGETS:
        t0 = time.perf_counter()
        wer.update(nn_budget_sweep(rec, corpus["dev_feats"],
                                   corpus["dev_texts"], budgets=[K]))
        seconds[K] = time.perf_counter() - t0
    if sorted(wer) != sorted(BUDGETS) or not all(
            np.isfinite(v) for v in wer.values()):
        raise RuntimeError(f"budget sweep gave {wer}")
    log("budget_sweep", dev_wer=wer, seconds=seconds,
        total_s=sum(seconds.values()), dev_utts=len(corpus["dev_feats"]),
        acoustic_scale=rec.acoustic_scale, recipe_dev_wer=rec.dev_wer)


def timed_methods(cls, names):
    """Wrap the methods ``names`` of ``cls`` so each call's wall ms (after
    a card sync on both sides) is appended to ``times[name]``; returns
    (times, undo)."""
    times = {n: [] for n in names}
    saved = {n: getattr(cls, n) for n in names}

    def wrap(name, fn):
        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0))
            return out
        return timed

    for n, fn in saved.items():
        setattr(cls, n, wrap(n, fn))

    def undo():
        for n, fn in saved.items():
            setattr(cls, n, fn)
    return times, undo


def lattice_arcs(lat):
    """A lattice's arc set with its costs, for exact comparison."""
    return sorted((a.t, a.src, a.dst, a.tid, a.words, a.graph_cost,
                   a.acoustic_cost) for a in lat.arcs)


def decode_summary(words, ali, score, lat):
    """One lattice decode as JSON values: words, alignment, the score's
    bits, the lattice's arc count and a digest of its arcs and finals
    with their costs (equal digests: equal lattices to the bit)."""
    digest = hashlib.sha256(repr((lattice_arcs(lat), sorted(
        lat.final_costs.items()))).encode()).hexdigest()
    return {"words": list(words), "ali": np.asarray(ali).tolist(),
            "score": float(score).hex(), "arcs": len(lat.arcs),
            "lattice": digest}


def read_ints(path):
    """{key: [ints]} of a text int-vector ark."""
    out = {}
    with open(path) as f:
        for line in f:
            key, *vals = line.split()
            out[key] = [int(v) for v in vals]
    return out


def save_packed(path, g):
    np.savez(path, src=g.src, dst=g.dst, ilabel=g.ilabel, olabel=g.olabel,
             weight=g.weight, final=g.final,
             meta=np.asarray([g.start, g.num_states, g.eps_diameter]))


def load_packed(path):
    from kaldi_aslp_tpu_torch.decoder import PackedGraph

    z = np.load(path)
    start, num_states, eps_diameter = (int(v) for v in z["meta"])
    return PackedGraph(src=z["src"], dst=z["dst"], ilabel=z["ilabel"],
                       olabel=z["olabel"], weight=z["weight"],
                       final=z["final"], start=start,
                       num_states=num_states, eps_diameter=eps_diameter)


def scored_lattices(device, packed, lut, sets, kw):
    """decode_wer_dev_test on ``device`` with each decode's lattice and
    best path, and each LMWT sweep's WERs, kept in call order."""
    from kaldi_aslp_tpu_torch.decoder import BeamSearchDecoder
    from kaldi_aslp_tpu_torch.recipes import score_util

    lats, sweeps = [], []
    cls = BeamSearchDecoder
    decode_lattice, sweep = cls.decode_lattice, score_util._sweep_with_failures

    def keep(self, *a, **k):
        out = decode_lattice(self, *a, **k)
        lats.append(out)
        return out

    def keep_sweep(*a):
        out = sweep(*a)
        sweeps.append({str(k): v.wer for k, v in out.items()})
        return out
    cls.decode_lattice, score_util._sweep_with_failures = keep, keep_sweep
    try:
        t0 = time.perf_counter()
        test_wer, dev_wer, lmwt = score_util.decode_wer_dev_test(
            packed, lut, *sets["dev"], *sets["test"], device=device, **kw)
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        cls.decode_lattice, score_util._sweep_with_failures = decode_lattice, \
            sweep
    return {"test_wer": test_wer, "dev_wer": dev_wer, "lmwt": lmwt,
            "seconds": seconds, "sweeps": sweeps, "results": lats,
            "decodes": [decode_summary(*r) for r in lats]}


def lattice_cpu_child(job):
    """In a process of its own, beside the card's run: the CPU side of
    the lattice phases from the job file's inputs, printed as one JSON
    line.  ``latgen``: the CPU's forward of the utterances (saved beside
    the job) and its lattice decode of the card's cut loglikes; ``score``:
    decode_wer_dev_test on the CPU."""
    from kaldi_aslp_tpu_torch.decoder import (
        BeamSearchDecoder,
        CsrGraph,
        nnet_forward,
    )
    from kaldi_aslp_tpu_torch.io import sequential_matrix_reader
    from kaldi_aslp_tpu_torch.models import Nnet

    torch.set_num_threads(4)
    with open(job) as f:
        spec = json.load(f)
    t0 = time.perf_counter()
    if spec["kind"] == "latgen":
        net, _ = Nnet.load(spec["model"], "cpu")
        feats = dict(sequential_matrix_reader(f"ark:{spec['feats']}"))
        np.savez(spec["forward_out"],
                 **{k: nnet_forward(net, x) for k, x in feats.items()})
        dec = BeamSearchDecoder(
            CsrGraph.from_packed(load_packed(spec["graph"])),
            np.loadtxt(spec["tid2pdf"], dtype=np.int64), device="cpu",
            **spec["decoder"])
        out = {"decodes": [decode_summary(*dec.decode_lattice(
            x, lattice_beam=spec["lattice_beam"])) for _, x in
            sequential_matrix_reader(f"ark:{spec['loglikes']}")],
            "last_record_drops": dec.last_record_drops}
    else:
        z = np.load(spec["loglikes"])
        sets = {}
        for split in ("dev", "test"):
            ll = {k.split("/", 1)[1]: z[k] for k in z.files
                  if k.startswith(split + "/")}
            sets[split] = (ll, spec["refs"][split])
        out = scored_lattices("cpu", load_packed(spec["graph"]),
                              np.asarray(spec["lut"]), sets, spec["kw"])
        del out["results"]
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


def start_cpu_child(workdir, spec):
    """The CPU side of a lattice phase in a child process (joined by
    ``cpu_child_result``)."""
    job = os.path.join(workdir, f"cpu_{spec['kind']}.json")
    with open(job, "w") as f:
        json.dump(spec, f)
    return subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; "
         f"chip_smoke.lattice_cpu_child({job!r})"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))


def cpu_child_result(child):
    out, err = child.communicate(timeout=600)
    if child.returncode != 0:
        raise RuntimeError(f"the CPU process failed: {err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def latgen_phase(paths, workdir):
    """Kaldi's offline chain on the flagship through the port's CLI, in
    process: aslp-nnet-forward on the card, latgen-faster-mapped at its
    defaults, lattice-copy to text, lattice-scale, lattice-best-path and
    compute-wer against the dense Viterbi's words; lattice-determinize on
    each utterance's first DET_FRAMES frames.  The CPU's forward and
    lattices, from a child process running beside the card's, must equal
    the card's.  Returns the forward's blstmp_forward launches."""
    from kaldi_aslp_tpu_torch.decoder import (
        BeamSearchDecoder,
        PackedGraph,
        ViterbiDecoder,
        nnet_forward,
    )
    from kaldi_aslp_tpu_torch.feats.fbank import Fbank
    from kaldi_aslp_tpu_torch.feats.mel import MelBanksOptions
    from kaldi_aslp_tpu_torch.feats.window import FrameExtractionOptions
    from kaldi_aslp_tpu_torch.fst.fst import Fst
    from kaldi_aslp_tpu_torch.io import (
        matrix_writer,
        sequential_lattice_reader,
        sequential_matrix_reader,
    )
    from kaldi_aslp_tpu_torch.models import Nnet
    from kaldi_aslp_tpu_torch.ops.lstmp import blstmp_forward, lstmp_forward

    model, tid2pdf, tlg, _words = paths
    work = os.path.join(workdir, "latgen")
    os.makedirs(work)

    def at(name):
        return os.path.join(work, name)

    fbank = Fbank(FrameExtractionOptions(dither=0.0),
                  MelBanksOptions(num_bins=FEAT_DIM))
    feats = {}
    pcms = serving_pcms()
    for i in range(LATGEN_UTTS):
        pcm = np.frombuffer(pcms[i], "<i2")
        feats[f"utt{i}"] = fbank(pcm.astype(np.float32)).cpu().numpy()
    with matrix_writer(f"ark:{at('feats.ark')}") as w:
        for k, v in feats.items():
            w[k] = v
    frames = sum(len(v) for v in feats.values())

    # aslp-nnet-forward on the card: 3 BLSTMP launches an utterance
    for wrapper in (blstmp_forward, lstmp_forward):
        wrapper.launches = wrapper.per_step = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc, _ = run_cli(["aslp-nnet-forward", model, f"ark:{at('feats.ark')}",
                     f"ark:{at('ll.ark')}"])
    torch.cuda.synchronize()
    forward_cli_s = time.perf_counter() - t0
    launches = blstmp_forward.launches
    if rc != 0 or launches != LAYERS * LATGEN_UTTS or blstmp_forward.per_step \
            or lstmp_forward.launches:
        raise RuntimeError(
            f"aslp-nnet-forward exited {rc} with {launches} two-direction "
            f"launches ({blstmp_forward.per_step} per-step, "
            f"{lstmp_forward.launches} one-direction) for {LATGEN_UTTS} "
            "utterances")
    ll_full = dict(sequential_matrix_reader(f"ark:{at('ll.ark')}"))
    # latgen and the lattice tools on each utterance's first LATGEN_FRAMES
    ll = {k: x[:LATGEN_FRAMES] for k, x in ll_full.items()}
    with matrix_writer(f"ark:{at('ll_cut.ark')}") as w:
        for k, x in ll.items():
            w[k] = x
    with open(tlg) as f:
        packed = PackedGraph.from_fst(Fst.from_text(f.read()))
    save_packed(at("graph.npz"), packed)
    child = start_cpu_child(work, {
        "kind": "latgen", "model": model, "feats": at("feats.ark"),
        "forward_out": at("cpu_forward.npz"), "graph": at("graph.npz"),
        "tid2pdf": tid2pdf, "loglikes": at("ll_cut.ark"),
        "decoder": {"acoustic_scale": 0.1, "beam": 16.0,
                    "max_active": 7000}, "lattice_beam": 8.0})
    # the forward warm, by utterance
    net, _ = Nnet.load(model, "cuda")
    fwd_ms = []
    for x in feats.values():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nnet_forward(net, x)
        torch.cuda.synchronize()
        fwd_ms.append(1e3 * (time.perf_counter() - t0))

    # latgen-faster-mapped at its defaults on the card, timed by part;
    # each utterance's result kept for the CPU check
    cls = BeamSearchDecoder
    times, undo = timed_methods(cls, ("_record_forward",
                                      "_prune_records_device",
                                      "_build_lattice", "decode_lattice"))
    results, planes, card_decoders = [], [], []
    decode_lattice, record_forward = cls.decode_lattice, cls._record_forward

    def keep(self, *a, **k):
        card_decoders.append(self)
        out = decode_lattice(self, *a, **k)
        results.append(out)
        return out

    def keep_planes(self, *a, **k):
        out = record_forward(self, *a, **k)
        planes.append((out[4].shape, out[5].shape))
        return out
    cls.decode_lattice, cls._record_forward = keep, keep_planes
    try:
        t0 = time.perf_counter()
        rc, _ = run_cli(["latgen-faster-mapped", tid2pdf, tlg,
                         f"ark:{at('ll_cut.ark')}", f"ark:{at('lat.ark')}",
                         f"ark,t:{at('words.txt')}"])
        latgen_cli_s = time.perf_counter() - t0
    finally:
        cls.decode_lattice, cls._record_forward = decode_lattice, \
            record_forward
        undo()
    if rc != 0 or len(results) != LATGEN_UTTS:
        raise RuntimeError(f"latgen-faster-mapped exited {rc}, "
                           f"{len(results)} lattices")
    card = card_decoders[0]
    if card.device.type != "cuda" or (card.K, card.beam, card.acoustic_scale) \
            != (7000, 16.0, 0.1):
        raise RuntimeError(f"latgen decoded on {card.device} at K={card.K}")
    drops = card.last_record_drops
    # one utterance's launches a frame and device busy share
    key = max(ll, key=lambda k: len(ll[k]))
    counts = {}
    by_kernel = device_ms_by_kernel(
        lambda: card.decode_lattice(ll[key], lattice_beam=8.0), counts)
    kernels = {n: c for n, c in counts.items()
               if not n.startswith(("Memcpy", "Memset"))}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card.decode_lattice(ll[key], lattice_beam=8.0)
    torch.cuda.synchronize()
    one_ms = 1e3 * (time.perf_counter() - t0)
    device_ms = sum(v for n, v in by_kernel.items() if n in kernels)

    # the lattice tools, and the dense Viterbi's words as the reference
    steps = [["lattice-copy", f"ark:{at('lat.ark')}", f"ark,t:{at('lat.txt')}"],
             ["lattice-scale", "--acoustic-scale=0.1",
              f"ark,t:{at('lat.txt')}", f"ark:{at('scaled.ark')}"],
             ["lattice-best-path", f"ark:{at('scaled.ark')}",
              f"ark,t:{at('tra.txt')}"]]
    tool_s = {}
    for argv in steps:
        t0 = time.perf_counter()
        rc, _ = run_cli(argv)
        tool_s[argv[0]] = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"{argv[0]} exited {rc}")
    lut = np.loadtxt(tid2pdf, dtype=np.int64)
    dense = ViterbiDecoder(packed, lut, acoustic_scale=0.1)
    with open(at("ref.txt"), "w") as f:
        for k, x in ll.items():
            f.write(" ".join([k] + [str(w) for w in dense.decode(x)[0]])
                    + "\n")
    rc, report = run_cli(["compute-wer", f"ark:{at('ref.txt')}",
                          f"ark:{at('tra.txt')}"])
    best = read_ints(at("tra.txt"))
    latgen_words = read_ints(at("words.txt"))
    if rc != 0 or best != latgen_words or best != read_ints(at("ref.txt")):
        raise RuntimeError(f"lattice best paths {best}, latgen's words "
                           f"{latgen_words}, dense {read_ints(at('ref.txt'))}")

    # lattice-determinize on each utterance's first DET_FRAMES frames
    with matrix_writer(f"ark:{at('ll_det.ark')}") as w:
        for k, x in ll.items():
            w[k] = x[:DET_FRAMES]
    det_steps = [["latgen-faster-mapped", tid2pdf, tlg,
                  f"ark:{at('ll_det.ark')}", f"ark:{at('lat_cut.ark')}",
                  f"ark,t:{at('words_cut.txt')}"],
                 ["lattice-scale", "--acoustic-scale=0.1",
                  f"ark:{at('lat_cut.ark')}", f"ark:{at('scaled_cut.ark')}"],
                 ["lattice-determinize", f"ark:{at('scaled_cut.ark')}",
                  f"ark:{at('det_cut.ark')}"],
                 ["lattice-best-path", f"ark:{at('det_cut.ark')}",
                  f"ark,t:{at('tra_cut.txt')}"]]
    for argv in det_steps:
        t0 = time.perf_counter()
        rc, _ = run_cli(argv)
        tool_s[argv[0] + ("_cut" if argv[0] == "latgen-faster-mapped"
                          else "")] = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"{argv[0]} exited {rc}")
    if read_ints(at("tra_cut.txt")) != read_ints(at("words_cut.txt")):
        raise RuntimeError("the determinized lattices' best paths are not "
                           "latgen's words")
    det_states = sum(c.num_states for _, c in sequential_lattice_reader(
        f"ark:{at('det_cut.ark')}"))

    # the CPU's forward and lattices, from the child
    t0 = time.perf_counter()
    cpu = cpu_child_result(child)
    cpu_wait_s = time.perf_counter() - t0
    cpu_ll = np.load(at("cpu_forward.npz"))
    worst = 0.0
    for k, got in ll_full.items():
        want = cpu_ll[k]
        if got.shape != want.shape or not np.isfinite(got).all():
            raise RuntimeError(f"{k}: bad loglikes {got.shape}")
        worst = max(worst, float(np.abs(got - want).max()))
    if worst > CROSS_CHECK_ATOL:
        raise RuntimeError(f"card loglikes {worst} from the CPU's")
    mine = [decode_summary(*r) for r in results]
    if mine != cpu["decodes"] or drops != cpu["last_record_drops"]:
        raise RuntimeError(f"card lattices {mine} are not the CPU's "
                           f"{cpu['decodes']} (drops {drops}, "
                           f"{cpu['last_record_drops']})")

    arcs = [len(r[3].arcs) for r in results]
    em_shape, eps_shape = planes[0]
    n = LATGEN_UTTS
    log("latgen", utts=n, frames=frames, latgen_frames=LATGEN_FRAMES,
        blstmp_launches_per_utt=launches / n, per_step=0,
        forward_ms_per_utt=float(np.mean(fwd_ms)),
        forward_cli_s=forward_cli_s, loglikes_max_abs_err_vs_cpu=worst,
        K=card.K, A=card.A, A_em=card.A_em, eps_rounds=card.eps_rounds,
        decode_lattice_ms_per_utt=float(np.mean(times["decode_lattice"])),
        split_ms_per_utt={
            "forward_loop": float(np.mean(times["_record_forward"])),
            "prune": float(np.mean(times["_prune_records_device"])),
            "host_build": float(np.mean(times["_build_lattice"]))},
        latgen_cli_s=latgen_cli_s,
        record_bytes_per_frame=4 * (int(np.prod(em_shape[1:]))
                                    + int(np.prod(eps_shape[1:]))),
        record_planes=[list(em_shape), list(eps_shape)],
        lattice_arcs_per_frame=sum(arcs) / sum(len(x) for x in ll.values()),
        last_record_drops=drops, rec_budget=card.rec_budget,
        cpu_process_s=cpu["seconds"], cpu_wait_s=cpu_wait_s,
        card_lattices_equal_cpu=True,
        profiled={"T": len(ll[key]), "ms": one_ms,
                  "kernel_launches": sum(kernels.values()),
                  "launches_per_frame": sum(kernels.values()) / len(ll[key]),
                  "device_busy_ms": device_ms,
                  "device_busy_share": device_ms / one_ms},
        tool_s=tool_s, compute_wer=report.strip().splitlines(),
        best_path_words=sum(len(v) for v in best.values()),
        det_frames=DET_FRAMES, det_states=det_states,
        determinize_s=tool_s["lattice-determinize"])
    return launches


def lattice_score_phase(rec, corpus, workdir):
    """decode_wer_dev_test on the recipe's dev and test sets at the
    ladder's decode settings on the card, and on the CPU in a child
    process beside it: the same lattices and the same WER at every LMWT;
    every lattice holds the decoder's best path."""
    from kaldi_aslp_tpu_torch.decoder import (
        BeamSearchDecoder,
        PackedGraph,
        lattice_best_path,
    )
    from kaldi_aslp_tpu_torch.fst import ctc_lut

    packed = PackedGraph.from_fst(rec.tlg)
    lut = ctc_lut(rec.num_outputs)
    sets = {}
    for split in ("dev", "test"):
        utts = sorted(corpus[f"{split}_feats"])[:SCORE_UTTS]
        ll = {u: rec.posteriors(corpus[f"{split}_feats"][u]) - rec.log_priors
              for u in utts}
        refs = {u: [rec.lang.words.id(w) for w in corpus[f"{split}_texts"][u]]
                for u in utts}
        sets[split] = (ll, refs)
    kw = dict(acoustic_scale=rec.acoustic_scale, lmwt_range=LMWT_RANGE,
              beam=RECIPE_OPTS["decode_beam"],
              max_active=RECIPE_OPTS["decode_max_active"],
              lattice_beam=LATTICE_BEAM)
    work = os.path.join(workdir, "lattice_score")
    os.makedirs(work)
    save_packed(os.path.join(work, "graph.npz"), packed)
    np.savez(os.path.join(work, "ll.npz"),
             **{f"{split}/{u}": x for split, (ll, _) in sets.items()
                for u, x in ll.items()})
    child = start_cpu_child(work, {
        "kind": "score", "graph": os.path.join(work, "graph.npz"),
        "loglikes": os.path.join(work, "ll.npz"), "lut": lut.tolist(),
        "refs": {split: refs for split, (_, refs) in sets.items()},
        "kw": {**kw, "lmwt_range": list(LMWT_RANGE)}})
    card = scored_lattices("cuda", packed, lut, sets, kw)
    t0 = time.perf_counter()
    cpu = cpu_child_result(child)
    cpu_wait_s = time.perf_counter() - t0
    fields = ("test_wer", "dev_wer", "lmwt", "sweeps", "decodes")
    if any(card[f] != cpu[f] for f in fields):
        bad = [f for f in fields if card[f] != cpu[f]]
        raise RuntimeError(f"card {bad} not the CPU's: "
                           f"{[(card[f], cpu[f]) for f in bad][:1]}")
    # every lattice holds the decoder's best path
    for words, _ali, score, lat in card["results"]:
        got, cost = lattice_best_path(lat, acoustic_scale=rec.acoustic_scale)
        if got != words or abs(-cost - score) > BEAM_SCORE_RTOL * abs(score):
            raise RuntimeError(f"lattice best path {got} {-cost}, decoder "
                               f"{words} {score}")
    # one utterance's launches a frame
    dec = BeamSearchDecoder(packed, lut, acoustic_scale=rec.acoustic_scale,
                            beam=RECIPE_OPTS["decode_beam"],
                            max_active=RECIPE_OPTS["decode_max_active"])
    test_ll = sets["test"][0]
    key = max(test_ll, key=lambda u: len(test_ll[u]))
    counts = {}
    device_ms_by_kernel(lambda: dec.decode_lattice(
        test_ll[key], lattice_beam=LATTICE_BEAM), counts)
    kernels = sum(c for n, c in counts.items()
                  if not n.startswith(("Memcpy", "Memset")))
    utts = len(card["decodes"])
    frames = sum(len(x) for ll, _ in sets.values() for x in ll.values())
    log("lattice_score", utts=utts, frames=frames,
        dev_wer=card["dev_wer"], test_wer=card["test_wer"],
        lmwt_selected_on_dev=card["lmwt"], lmwt_range=list(LMWT_RANGE),
        dev_sweep=card["sweeps"][0], lattice_beam=LATTICE_BEAM,
        card_ms_per_utt=1e3 * card["seconds"] / utts,
        cpu_ms_per_utt=1e3 * cpu["seconds"] / utts,
        card_s=card["seconds"], cpu_process_s=cpu["seconds"],
        cpu_wait_s=cpu_wait_s,
        lattice_arcs_per_frame=sum(d["arcs"] for d in card["decodes"])
        / frames, launches_per_frame=kernels / len(test_ll[key]),
        card_lattices_equal_cpu=True, lattices_hold_best_path=True)


# -- serve-batched: cross-session acoustic batching --------------------------

BATCH_SIZES = (1, 2, 4, 8, 16)   # chunks a batched call, timed
BATCH_ROW_ATOL = 1e-4            # a batched row against its S = 1 forward
BATCHED_CLIENTS = 8              # the four serving utterances, each twice


def serve_batched_phase(paths, finals):
    """Eight clients at once through ``BatchedDecodeSession``s sharing one
    ``AcousticBatcher`` (JAX's defaults) over the flagship's batched eval
    forward on the card (``SessionFactory.batched_acoustic_fn``): every
    batched call one ``blstmp_forward`` launch a layer at S = B on a
    persistent sweep, fewer calls than requests, each client's final the
    unbatched server's for the same audio (``finals``, phase 4), one
    call's rows against the S = 1 forward of their frames; then the
    batched forward timed at B = 1..16 chunks beside B sequential S = 1
    calls, and the kernel alone at S = B beside its bound."""
    from kaldi_aslp_tpu_torch.cli.online_tools import session_factory_from_argv
    from kaldi_aslp_tpu_torch.online.batching import AcousticBatcher
    from kaldi_aslp_tpu_torch.online.server import (
        OnlineServerOptions,
        OnlineTcpServer,
    )
    from kaldi_aslp_tpu_torch.ops import lstmp as lp
    from kaldi_aslp_tpu_torch.ops.lstmp import blstmp_forward, lstmp_forward

    factory = session_factory_from_argv(
        ["--device=cuda", f"--num-mel-bins={FEAT_DIM}", *paths])
    batcher = AcousticBatcher(factory.batched_acoustic_fn)
    shapes, bad, sample = [], [], {}

    def counted(x, mask):
        before = (blstmp_forward.launches, blstmp_forward.per_step)
        out = factory.batched_acoustic_fn(x, mask)
        shapes.append(x.shape)
        after = (blstmp_forward.launches, blstmp_forward.per_step)
        if after != (before[0] + LAYERS, before[1]):
            bad.append((x.shape, before, after))
        if len(x) > 1 and not sample:
            sample.update(x=x.copy(), mask=mask.copy(), out=out.copy())
        return out
    batcher.batched_forward = counted
    pcms = (serving_pcms() * 2)[:BATCHED_CLIENTS]

    async def serve():
        server = OnlineTcpServer(lambda: factory.batched_session(batcher),
                                 OnlineServerOptions(port=0))
        port = await server.start()
        try:
            t0 = time.perf_counter()
            out = await asyncio.gather(*[request(port, p) for p in pcms])
            return out, time.perf_counter() - t0
        finally:
            await server.stop()

    for wrapper in (blstmp_forward, lstmp_forward):
        wrapper.launches = wrapper.per_step = 0
    stats, wall_s = asyncio.run(serve())
    launches, per_step = blstmp_forward.launches, blstmp_forward.per_step
    if bad or per_step or lstmp_forward.launches or not shapes:
        raise RuntimeError(f"batched calls off their launches: {bad[:3]}, "
                           f"per_step {per_step}, one-direction "
                           f"{lstmp_forward.launches}")
    if launches != LAYERS * batcher.num_batches:
        raise RuntimeError(f"{launches} launches for {batcher.num_batches} "
                           "batched calls")
    if not batcher.num_batches < batcher.num_requests:
        raise RuntimeError(f"no coalescing: {batcher.num_batches} calls for "
                           f"{batcher.num_requests} requests")
    texts = [st["final_text"] for st in stats]
    want = [finals[i % len(finals)] for i in range(len(pcms))]
    if texts != want:
        raise RuntimeError(f"batched finals {texts}, unbatched {want}")
    if not sample:
        raise RuntimeError(f"no batched call held two chunks: {shapes}")
    worst = 0.0
    for i, row in enumerate(sample["out"]):
        n = int(sample["mask"][i].sum())
        alone = factory.acoustic_fn(sample["x"][i, :n])
        worst = max(worst, float(np.abs(row[:n] - alone).max()))
    if worst > BATCH_ROW_ATOL:
        raise RuntimeError(f"batched rows differ from S = 1 by {worst}")
    sizes = [s[0] for s in shapes]
    log("serve_batched", clients=len(pcms), requests=batcher.num_requests,
        batched_calls=batcher.num_batches, blstmp_launches=launches,
        per_step=per_step, batch_sizes=dict(sorted(
            {b: sizes.count(b) for b in set(sizes)}.items())),
        padded_T=sorted({s[1] for s in shapes}),
        finals_equal_unbatched=True, finals_nonempty=sum(map(bool, texts)),
        row_check_B=len(sample["out"]), row_max_abs_err=worst,
        row_atol=BATCH_ROW_ATOL,
        audio_s_per_s=sum(st["audio_s"] for st in stats) / wall_s,
        latency_ms_last_byte_to_final=[
            st["latency_ms_last_byte_to_final"] for st in stats],
        defaults={"max_batch": batcher.max_batch,
                  "max_wait_ms": 1e3 * batcher.max_wait_s,
                  "t_bucket": batcher.t_bucket})

    # the batched forward at B chunks of 16 frames (padded to 32) beside B
    # sequential S = 1 forwards of the same chunks, and the kernel alone
    rs = np.random.RandomState(11)
    frames = factory.flags.chunk_frames
    Tp = batcher.t_bucket
    dev = factory.device
    timings = []
    for B in BATCH_SIZES:
        chunks = rs.randn(B, frames, FEAT_DIM).astype(np.float32)
        x = np.zeros((B, Tp, FEAT_DIM), np.float32)
        x[:, :frames] = chunks
        mask = np.zeros((B, Tp), np.float32)
        mask[:, :frames] = 1.0
        batched_ms = cuda_ms(lambda: factory.batched_acoustic_fn(x, mask), 20)
        seq_ms = cuda_ms(lambda: [factory.acoustic_fn(c) for c in chunks], 10)
        xgs = [torch.from_numpy(uniform(rs, B, Tp, 4 * C, scale=1.0)).to(dev)
               for _ in range(2)]
        weights = [tuple(torch.from_numpy(uniform(rs, *shape)).to(dev)
                         for shape in ((4 * C, P), (P, C), (3, C)))
                   for _ in range(2)]
        m = torch.from_numpy(mask).to(dev)
        zeros = (torch.zeros((B, C), device=dev),
                 torch.zeros((B, P), device=dev))
        kernel_ms = cuda_ms(lambda: lp.blstmp_forward(
            *xgs, m, *weights, *zeros), 50)
        plain_ms = cuda_ms(lambda: lp.blstmp_forward_reference(
            *xgs, m, *weights, *zeros), 3)
        got = lp.blstmp_forward(*xgs, m, *weights, *zeros)[0]
        ref = lp.blstmp_forward_reference(*xgs, m, *weights, *zeros)[0]
        err = float((got - ref).abs().max())
        if not torch.allclose(got, ref, **KERNEL_TOL):
            raise RuntimeError(f"blstmp_forward at S={B} off by {err}")
        bound_ms, bound_by = lstmp_forward_bound(
            B, Tp, C, P, directions=2, valid=int(mask.sum()))
        plan = lp.plan_for(B, C, P, 2, dev)
        timings.append(dict(
            B=B, T=Tp, valid_frames=frames, batched_forward_ms=batched_ms,
            sequential_ms=seq_ms, batched_per_chunk_ms=batched_ms / B,
            kernel_ms=kernel_ms, plain_ms=plain_ms, max_abs_err=err,
            bound_ms=bound_ms, bound_by=bound_by, regime=plan.regime,
            persistent=plan.persistent))
        log("serve_batched_timing", **timings[-1],
            clock="CUDA events, median", card=smi_name_and_power())
    return launches, timings


# -- vad: the energy- and NN-gated servers ------------------------------------

VAD_NET_HIDDEN = 32              # recipes/vad.py:141-145's topology
VAD_POST_ATOL = 1e-5             # the VAD net's posteriors, card vs CPU
MFCC_TOL = dict(rtol=1e-4, atol=1e-4)   # online MFCC, card vs CPU
VAD_WORD_BIAS = 12.0             # output bias lifting one phone (below)


def two_bursts(seed: int = 7) -> np.ndarray:
    """[silence, tone, silence, tone, silence] (1, 0.5, 1, 0.5, 1 s;
    tests/test_vad_session_convert.py:48-53's shape), noise under the
    tones; int16 range floats."""
    rs = np.random.RandomState(seed)
    t = np.arange(SAMPLE_RATE // 2) / SAMPLE_RATE
    tone = 5000 * np.sin(2 * np.pi * 300 * t) + 20 * rs.randn(len(t))
    quiet = 2 * rs.randn(SAMPLE_RATE)
    return np.concatenate([quiet, tone, quiet, tone, quiet])


def write_vad_files(paths, workdir):
    """The VAD servers' files: the flagship zip with one phone's output
    bias raised (``VAD_WORD_BIAS``), a CTC TLG over 70 one-phone words on
    the flagship's 71 phones + blank, its LUT and words; and the VAD net
    (recipes/vad.py's Affine(D->32), Sigmoid, Affine(32->2), Softmax at
    the server's feature dimension), its weights set by hand from a numpy
    seed to read the mean log-mel value, written as a JAX zip.  On random
    weights the flagship decodes every segment to the lifted phone's
    word, so the servers' finals count the segments the VAD cut."""
    from kaldi_aslp_tpu_torch.fst import (
        Lang,
        Lexicon,
        ctc_lut,
        make_ctc_decode_graph,
        make_unigram_grammar,
    )
    from kaldi_aslp_tpu_torch.models import (
        AffineTransform,
        Nnet,
        Sigmoid,
        Softmax,
    )

    words = {f"V{i:02d}": f"P{i:02d}" for i in range(70)}
    lex = "\n".join(f"{w} {p}" for w, p in words.items()) + "\n<SIL> SIL\n"
    lang = Lang.build(Lexicon.from_text(lex))
    if len(lang.phones) != TARGETS:
        raise RuntimeError(f"{len(lang.phones)} CTC outputs, want {TARGETS}")
    tlg = make_ctc_decode_graph(
        lang, make_unigram_grammar({w: 1 / len(words) for w in words},
                                   lang.words))
    out = [f"{workdir}/vad_{n}" for n in
           ("am.zip", "tid2pdf.txt", "TLG.txt", "words.txt", "net.zip")]
    net, _ = Nnet.load(paths[0], "cpu")
    with torch.no_grad():
        net.nodes[-1].b[lang.phones.id("P00")] += VAD_WORD_BIAS
    net.save(out[0])
    np.savetxt(out[1], ctc_lut(TARGETS), fmt="%d")
    with open(out[2], "w") as f:
        f.write(tlg.to_text())
    with open(out[3], "w") as f:
        f.write(lang.words.to_text())
    rs = np.random.RandomState(21)
    H = VAD_NET_HIDDEN
    vad = Nnet()
    for comp in (AffineTransform(FEAT_DIM, H), Sigmoid(H, H),
                 AffineTransform(H, 2), Softmax(2, 2)):
        vad.add(comp)
    with torch.no_grad():
        vad.nodes[0].w.copy_(torch.from_numpy(
            (2.0 / FEAT_DIM + 0.01 * rs.randn(H, FEAT_DIM)).astype(
                np.float32)))
        vad.nodes[0].b.copy_(torch.from_numpy(
            (-1.0 + 0.01 * rs.randn(H)).astype(np.float32)))
        vad.nodes[2].w.copy_(torch.tensor([[-0.5] * H, [0.5] * H]))
        vad.nodes[2].b.copy_(torch.tensor([8.0, -8.0]))
    vad.save(out[4])
    return out


async def stream_events(port: int, pcm: bytes) -> list:
    """One client's events for ``pcm`` sent in 250 ms pieces."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    for i in range(0, len(pcm), CHUNK_BYTES):
        writer.write(pcm[i:i + CHUNK_BYTES])
        await writer.drain()
    writer.write_eof()
    events = [json.loads(line) async for line in reader]
    writer.close()
    await writer.wait_closed()
    return events


def serve_one(make_session, pcm: bytes) -> list:
    from kaldi_aslp_tpu_torch.online.server import (
        OnlineServerOptions,
        OnlineTcpServer,
    )

    async def run():
        server = OnlineTcpServer(make_session, OnlineServerOptions(port=0))
        port = await server.start()
        try:
            return await stream_events(port, pcm)
        finally:
            await server.stop()
    return asyncio.run(run())


def vad_phase(paths, workdir):
    """The two-burst audio through the energy-VAD server's factory, then
    the NN-VAD server's (--vad-nnet), both --device=cuda: at least 2
    non-empty finals each, the VAD net run at least once a chunk that
    had frames; the VAD net's posteriors and speech masks on the card
    against the CPU's, and one utterance's online MFCC on the card
    against the CPU's."""
    from kaldi_aslp_tpu_torch.cli.online_tools import session_factory_from_argv
    from kaldi_aslp_tpu_torch.models import Nnet
    from kaldi_aslp_tpu_torch.online.feature_pipeline import (
        OnlineFeatureOptions,
        OnlineFeaturePipeline,
    )
    from kaldi_aslp_tpu_torch.ops.lstmp import blstmp_forward
    from kaldi_aslp_tpu_torch.vad import NnetVad, VadOptions

    am, lut, tlg, words, vad_zip = write_vad_files(paths, workdir)
    audio = two_bursts()
    pcm = np.clip(audio, -32768, 32767).astype("<i2").tobytes()
    argv = ["--device=cuda", f"--num-mel-bins={FEAT_DIM}"]
    blstmp_forward.launches = blstmp_forward.per_step = 0
    results, factories = {}, {}
    for name, extra, energy in (("energy", [], True),
                                ("nnet", [f"--vad-nnet={vad_zip}"], False)):
        factory = session_factory_from_argv(argv + extra + [am, lut, tlg,
                                                            words],
                                            use_energy_vad=energy)
        sessions, frame_calls = [], []

        def make():
            session = factory()
            sessions.append(session)
            inner = session.vad.features.accept_waveform

            def counted(samples):
                out = inner(samples)
                frame_calls.append(len(out) > 0)
                return out
            session.vad.features.accept_waveform = counted
            return session

        t0 = time.perf_counter()
        events = serve_one(make, pcm)
        seconds = time.perf_counter() - t0
        finals = [e["text"] for e in events if e["type"] == "final"]
        gate = sessions[0].vad.vad
        forwards = getattr(gate, "num_forwards", None)
        results[name] = dict(
            finals=finals, nonempty_finals=sum(map(bool, finals)),
            partials=sum(e["type"] == "partial" for e in events),
            chunks_with_frames=sum(frame_calls), vad_net_forwards=forwards,
            gate=type(gate).__name__, seconds=seconds)
        if sum(map(bool, finals)) < 2:
            raise RuntimeError(f"{name} VAD server: finals {finals}")
        if not energy and (forwards is None or forwards < sum(frame_calls)
                           or forwards == 0):
            raise RuntimeError(f"VAD net ran {forwards} times for "
                               f"{sum(frame_calls)} chunks with frames")
        factories[name] = factory
    # the VAD net on the card against the CPU, on the utterance's frames
    cpu_feats = OnlineFeaturePipeline(OnlineFeatureOptions(
        num_mel_bins=FEAT_DIM), device="cpu")
    frames = cpu_feats.accept_waveform(audio.astype(np.float32))
    card_vad = NnetVad(VadOptions(), net=factories["nnet"].vad_net)
    cpu_vad = NnetVad(VadOptions(), net=Nnet.load(vad_zip, "cpu")[0])
    post_card, post_cpu = (card_vad.posteriors(frames),
                           cpu_vad.posteriors(frames))
    post_err = float(np.abs(post_card - post_cpu).max())
    masks_equal = bool(np.array_equal(
        card_vad.detect_from_posteriors(post_card),
        cpu_vad.detect_from_posteriors(post_cpu)))
    speech_share = float(card_vad.detect_from_posteriors(post_card).mean())
    if post_err > VAD_POST_ATOL or not masks_equal:
        raise RuntimeError(f"VAD net card vs CPU: posteriors {post_err}, "
                           f"masks equal {masks_equal}")
    # online MFCC, card vs CPU, chunk by chunk
    opts = OnlineFeatureOptions(feature_type="mfcc")
    card_mfcc = OnlineFeaturePipeline(opts, device="cuda")
    cpu_mfcc = OnlineFeaturePipeline(opts, device="cpu")
    samples = np.frombuffer(serving_pcms()[0], "<i2").astype(np.float32)
    mfcc_err, n = 0.0, 0
    step = CHUNK_BYTES // 2
    for i in range(0, len(samples), step):
        a = card_mfcc.accept_waveform(samples[i:i + step])
        b = cpu_mfcc.accept_waveform(samples[i:i + step])
        if a.shape != b.shape or not np.allclose(a, b, **MFCC_TOL):
            raise RuntimeError(f"online MFCC card vs CPU at sample {i}")
        if len(a):
            mfcc_err = max(mfcc_err, float(np.abs(a - b).max()))
        n += len(a)
    launches = blstmp_forward.launches
    if blstmp_forward.per_step:
        raise RuntimeError("the VAD servers took the per-step kernels")
    log("vad", audio_s=len(audio) / SAMPLE_RATE, **{
        f"{k}_server": v for k, v in results.items()},
        vad_posteriors_max_abs_err=post_err, posteriors_atol=VAD_POST_ATOL,
        vad_masks_equal=masks_equal, vad_speech_share=speech_share,
        mfcc_frames=n, mfcc_dim=card_mfcc.dim, mfcc_max_abs_err=mfcc_err,
        mfcc_tol=MFCC_TOL, blstmp_launches=launches)
    return launches, (am, lut, tlg, words)


# -- punctuation: CRF on the card, a punctuated session -----------------------

PUNCT_CORPUS = 60                 # tests/test_crf_punctuation.py's toy size
PUNCT_EPOCHS = 12
CRF_ATOL = 1e-5


def toy_punct_corpus(n: int, seed: int = 0):
    """tests/test_crf_punctuation.py:_toy_corpus: 'huh' takes a question
    mark, 'stop' ends a sentence with a period."""
    rs = np.random.RandomState(seed)
    vocab = ["alpha", "beta", "gamma", "delta"]
    corpus = []
    for _ in range(n):
        tokens = [vocab[rs.randint(len(vocab))]
                  for _ in range(rs.randint(2, 5))]
        tags = ["N"] * len(tokens)
        if rs.rand() < 0.5:
            tokens.append("huh")
            tags.append("W")
        corpus.append((tokens + ["stop"], tags + ["J"]))
    return corpus


def punctuation_phase(vad_paths):
    """A punctuation processor trained on the card; its CRF scores and
    tags on the card against the CPU; one request served through a
    ``punctuation=`` session on the card: its final is the processor's
    output on the same session's final without punctuation."""
    from kaldi_aslp_tpu_torch.cli.online_tools import session_factory_from_argv
    from kaldi_aslp_tpu_torch.online.feature_pipeline import (
        OnlineFeaturePipeline,
    )
    from kaldi_aslp_tpu_torch.online.punctuation import (
        PunctuationProcessor,
        token_features,
    )
    from kaldi_aslp_tpu_torch.online.server import DecodeSession
    from kaldi_aslp_tpu_torch.ops.crf import (
        _pad,
        crf_log_likelihood,
        crf_viterbi,
    )
    from kaldi_aslp_tpu_torch.utils.device import resolve_device

    corpus = toy_punct_corpus(PUNCT_CORPUS)
    t0 = time.perf_counter()
    proc = PunctuationProcessor.train(corpus, num_epochs=PUNCT_EPOCHS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    card_p = proc.params
    if card_p.emission.device.type != resolve_device("cuda").type:
        raise RuntimeError("the processor trained off the card")
    cpu_p = card_p.to("cpu")
    tag_ids = {t: i for i, t in enumerate("NDJGW")}
    worst, tags_equal = 0.0, True
    for tokens, tags in corpus[:12] + [(["gamma"] * 40, ["N"] * 40)]:
        feats = token_features(tokens)
        ids = np.array([tag_ids[t] for t in tags])
        lls, best = [], []
        for p in (card_p, cpu_p):
            fi, tg, m = _pad(feats, ids, 32, p.emission.device)
            with torch.no_grad():
                lls.append(float(crf_log_likelihood(p, fi, tg, m)))
            best.append(crf_viterbi(p, fi, m).cpu().numpy()[:len(tokens)])
        worst = max(worst, abs(lls[0] - lls[1]) / max(1.0, abs(lls[1])))
        tags_equal &= bool(np.array_equal(*best))
    if worst > CRF_ATOL or not tags_equal:
        raise RuntimeError(f"CRF card vs CPU: {worst}, tags equal "
                           f"{tags_equal}")
    learned = proc.tag(["alpha", "beta", "huh", "stop"])
    factory = session_factory_from_argv(
        ["--device=cuda", f"--num-mel-bins={FEAT_DIM}", *vad_paths])
    pcm = np.clip(two_bursts(), -32768, 32767).astype("<i2").tobytes()

    def make(punctuation):
        return lambda: DecodeSession(
            OnlineFeaturePipeline(factory.feat_opts, device=factory.device),
            factory.decoder(), factory.acoustic_fn, factory.words,
            chunk_frames=factory.flags.chunk_frames, punctuation=punctuation)
    plain = [e["text"] for e in serve_one(make(None), pcm)
             if e["type"] == "final"]
    punct = [e["text"] for e in serve_one(make(proc), pcm)
             if e["type"] == "final"]
    want = [proc.process(t) for t in plain]
    if punct != want or not any(plain):
        raise RuntimeError(f"punctuated finals {punct}, want {want}")
    log("punctuation", corpus=len(corpus), epochs=PUNCT_EPOCHS,
        train_s_on_card=train_s, crf_ll_max_rel_err=worst, atol=CRF_ATOL,
        viterbi_tags_equal=tags_equal, learned_tags=learned,
        finals=punct, finals_unpunctuated=plain)


# -- batched-decode: lock-step batches on the card ----------------------------

DECODE_BATCH = 8
# of the beam phase's utterances, those batched (by name; 32 until phase
# 23 needed the time, 16 until phase 25)
DECODE_BATCH_UTTS = 8
# the sets later phases decode, cut to their first utterances by name for
# phase 23's time: the beam phase (and so the batched decode) 6 of phase
# 14's 12 dev and 10 of its 20 test utterances; the GMM and DNN stages of
# phases 19-20 6 test utterances (10 until phase 24 needed the time; all
# 12 dev, for their LMWT choice); phase 22's GMM budget sweep 6 dev
# utterances and timit_synth 10 of its 20 test utterances.  For phase 25
# (whole runs took 1,121.5 and 1,225.4 s with it, on hosts up to 16 %
# slower than a 1,053.7 s run without it; phase 25 8.5-12.7 s): the beam
# phase's test set 6, the budget sweep 3 dev, timit_synth 5 test
# utterances (and ls_synth's decodes, hkust's iterations, the
# lattice-score utterances and the batched decode above and below).  For
# phase 26's room on slow hosts (a whole run took 948.9 s on one host and
# 1,223.0 s on another, 29 % slower in every host-bound phase): the GMM
# and DNN stages 4 test utterances, timit_synth 3 (and hkust's and
# rm_synth's decodes below)
BEAM_SETS = dict(dev=6, test=6)
GMM_SETS = dict(test=4)
SWEEP_SETS = dict(dev=3)
TIMIT_TEST_UTTS = 3


def first_utts(corpus, **sizes):
    """``corpus`` with each named set ({split: n}) cut to its first n
    utterances by name; every other entry as it is."""
    out = dict(corpus)
    for split, n in sizes.items():
        keep = sorted(corpus[f"{split}_feats"])[:n]
        for key in ("feats", "texts", "utt2spk"):
            if f"{split}_{key}" in corpus:
                out[f"{split}_{key}"] = {u: corpus[f"{split}_{key}"][u]
                                         for u in keep}
    return out


def batched_decode_phase(rec, loglikes, singles):
    """The first DECODE_BATCH_UTTS of the beam phase's utterances (by
    name) in batches of 8 through
    ``BatchedBeamDecoder`` (beam 32, K=2048) and ``BatchedViterbiDecoder``
    on the card, each utterance held to its single decode on the card (the
    beam phase's, ``singles``; the dense decoder's here), each batch timed
    beside the same utterances decoded one by one; one beam batch's
    launches a frame and busy share by torch.profiler; no hand kernel may
    launch."""
    from kaldi_aslp_tpu_torch.decoder import (
        BatchedBeamDecoder,
        BatchedViterbiDecoder,
        BeamSearchDecoder,
        CsrGraph,
        PackedGraph,
        ViterbiDecoder,
    )
    from kaldi_aslp_tpu_torch.fst import ctc_lut

    packed = PackedGraph.from_fst(rec.tlg)
    csr = CsrGraph.from_packed(packed)
    lut = ctc_lut(rec.num_outputs)
    settings = dict(beam=RECIPE_OPTS["decode_beam"],
                    max_active=RECIPE_OPTS["decode_max_active"])
    keys = [k for k in sorted(loglikes)
            if singles[k] is not None][:DECODE_BATCH_UTTS]
    batches = [keys[i:i + DECODE_BATCH]
               for i in range(0, len(keys), DECODE_BATCH)]
    on_card = {k: torch.from_numpy(np.asarray(loglikes[k], np.float32)).cuda()
               for k in keys}
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = {}
    for kind, batched, single in (
            ("beam", BatchedBeamDecoder(csr, lut, **settings),
             BeamSearchDecoder(csr, lut, **settings)),
            ("dense", BatchedViterbiDecoder(packed, lut),
             ViterbiDecoder(packed, lut))):
        rows, worst = [], 0.0
        for batch in batches:
            if kind == "beam":
                args = [on_card[k] for k in batch]
            else:
                args = [loglikes[k] for k in batch]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = batched.decode_batch(args)
            batch_ms = 1e3 * (time.perf_counter() - t0)
            seq_ms = 0.0
            for key, g, a in zip(batch, got, args):
                want, ms = timed_decode(single, a)
                seq_ms += ms
                rel = abs(g[2] - want[2]) / abs(want[2])
                worst = max(worst, rel)
                if (g[0] != want[0] or not np.array_equal(g[1], want[1])
                        or rel > BEAM_SCORE_RTOL):
                    raise RuntimeError(f"{kind} {key}: batched {g[0]} {g[2]}"
                                       f", single {want[0]} {want[2]}")
            rows.append({"B": len(batch),
                         "frames": sum(len(loglikes[k]) for k in batch),
                         "T_max": max(len(loglikes[k]) for k in batch),
                         "batch_ms": batch_ms, "sequential_ms": seq_ms})
        out[kind] = {"batches": rows, "worst_score_rel": worst,
                     "batch_ms": sum(r["batch_ms"] for r in rows),
                     "sequential_ms": sum(r["sequential_ms"] for r in rows)}
    stray = {n: w.launches for n, w in wrappers.items() if w.launches}
    if stray:
        raise RuntimeError(f"the batched decoders launched hand kernels: "
                           f"{stray}")
    # one beam batch profiled: launches a frame, device busy share
    beam_dec = BatchedBeamDecoder(csr, lut, **settings)
    batch = [on_card[k] for k in batches[0]]
    counts = {}
    by_kernel = device_ms_by_kernel(lambda: beam_dec.decode_batch(batch),
                                    counts)
    kernels = {k: c for k, c in counts.items()
               if not k.startswith(("Memcpy", "Memset"))}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    beam_dec.decode_batch(batch)
    one_ms = 1e3 * (time.perf_counter() - t0)
    T_max = max(len(x) for x in batch)
    device_ms = sum(v for k, v in by_kernel.items() if k in kernels)
    K = settings["max_active"]
    log("batched_decode", utts=len(keys), batch=DECODE_BATCH, **out,
        plane_bytes=2 * T_max * (1 + beam_dec.eps_rounds) * len(batch)
        * K * 4,
        plane_bytes_B8_T400_2stages_K2048=2 * 400 * 2 * 8 * 2048 * 4,
        profiled={"B": len(batch), "T_max": T_max, "ms": one_ms,
                  "kernel_launches": sum(kernels.values()),
                  "launches_per_frame": sum(kernels.values()) / T_max,
                  "device_busy_ms": device_ms,
                  "device_busy_share": device_ms / one_ms,
                  "top_kernels": dict(sorted(
                      kernels.items(), key=lambda kv: -kv[1])[:6])},
        card=smi_name_and_power())


# -- entry: the port's entry() on the card ------------------------------------

def entry_phase():
    """``kaldi_aslp_tpu_torch.entry.entry()`` once on the card: a finite
    [8, 200, 72] output from 3 ``blstmp_forward`` launches, per_step 0;
    then timed."""
    from kaldi_aslp_tpu_torch.entry import entry
    from kaldi_aslp_tpu_torch.ops.lstmp import blstmp_forward, lstmp_forward

    fwd, args = entry()
    for wrapper in (blstmp_forward, lstmp_forward):
        wrapper.launches = wrapper.per_step = 0
    out = fwd(*args)
    torch.cuda.synchronize()
    launches, per_step = blstmp_forward.launches, blstmp_forward.per_step
    if (tuple(out.shape) != (8, 200, TARGETS) or not torch.isfinite(out).all()
            or out.device.type != "cuda"):
        raise RuntimeError(f"entry() gave {tuple(out.shape)} on {out.device}")
    if launches != LAYERS or per_step or lstmp_forward.launches:
        raise RuntimeError(f"entry(): {launches} launches, {per_step} "
                           "per-step")
    log("entry", shape=list(out.shape), finite=True, blstmp_launches=launches,
        per_step=per_step, forward_ms=cuda_ms(lambda: fwd(*args), 10),
        clock="CUDA events, median", card=smi_name_and_power())
    return launches


# -- phase 19: the hybrid HMM/NN path ------------------------------------------

# (a) the ladder's mono stage at the small scale (hard_ladder._Scale
# "small".mono: 8 iterations, 400 gaussians, realigned on 1 2 3 4 6) on
# the CTC recipe's corpus; JAX's band for its WER
# (tests/test_hard_ladder.py:93-101) and pruning sensitivity
MONO_WER_BAND = (10.0, 95.0)
MONO_LL_RTOL = 1e-4
# phase 20 (b) HybridRecipe on the tri stage's alignments and CD HCLG at
# the ladder's full-scale dnn stage (hard_ladder.dnn_options of the full
# preset: 4 x 512 Sigmoid, kaldi_aslp_tpu/recipes/hard_ladder.py:131,
# :264-270), cut to DNN_ITERS of 14 newbob iterations (at 2 the 400-pdf
# DNN decodes at 98.7 % WER on the CPU, outside JAX's band); card vs CPU:
# the loss relative, each gradient against its tensor's largest
# magnitude, the prior-subtracted scores absolute (float32, TF32 off)
DNN_ITERS = 6
HYBRID_TOL = 1e-4
# (c) aslp-nnet-train-simple at build_dnn_hybrid's widths (440 inputs,
# 4 x 1024 Sigmoid, 3019 pdfs) on SIMPLE_UTTS utterances of frame
# targets, the tool's default minibatch and pool
SIMPLE_UTTS = 64
# test utterances the pruning sensitivity decodes twice (of the 20; 8
# until phase 23 needed the time)
PRUNING_UTTS = 4
# phase 20 (tri): JAX's WER band again; the GMM family's card-vs-CPU holds
# against each array's largest magnitude (float64 on both sides, float32
# out; the fMLLR and MLLT row solves and EM's iterations amplify rounding),
# on FAMILY_FRAMES frames where a statistic is per gaussian and frame, and
# a global GMM of GLOBAL_GAUSS gaussians grown over GLOBAL_ITERS iterations
TRI_WER_BAND = MONO_WER_BAND
FAMILY_TOL = 1e-4
FAMILY_FRAMES = 1000
GLOBAL_GAUSS = 64
GLOBAL_ITERS = 10
SIMPLE_TARGETS = 64
SIMPLE_ARGS = ["--minibatch-size=256", "--randomizer-size=32768",
               "--learn-rate=0.2", "--momentum=0.9"]
# the graphs the recipes built before the graph builders caught only
# NonDeterminizableError (this script's graph and hybrid_mono lines then,
# on an NVIDIA H100 80GB HBM3 at 700 W): the serving TLG and phase 19's
# mono HCLG, (states, arcs)
SERVING_TLG = (1853, 8949)
MONO_HCLG = (6851, 14989)


def hand_kernel_launches():
    """Every hand kernel wrapper's launch count, by name."""
    return {n: w.launches for n, w in kernel_wrappers().items()}


def tree_nodes(tree):
    """A decision tree, JSON-able: each root's nodes in pre-order, a
    split as [key_pos, question], a leaf as its pdf."""
    def walk(node):
        if node.key_pos is None:
            return int(node.pdf)
        return [[int(node.key_pos), sorted(int(p) for p in node.question)],
                walk(node.yes), walk(node.no)]
    return [[int(p), int(pc), walk(n)]
            for (p, pc), n in sorted(tree.roots.items())]


def tm_triples(tm):
    """A transition model's (phone, hmm state, pdf) triples, in id order."""
    return [[s.phone, s.hmm_state, s.pdf] for s in tm.states[1:]]


def gmm_cpu_child(job):
    """In a process of its own, beside the card's run: the ladder's GMM
    chain on the CPU from the job's pickled corpus and options, the mono
    stage's training (its final alignments into the job's npz, a JSON
    line), then the tri stage's (``hard_ladder.train_tri``: its final
    alignments into the second npz, a JSON line with its tree and its
    training and decode triples)."""
    import pickle

    from kaldi_aslp_tpu_torch.fst import arpa_to_fst
    from kaldi_aslp_tpu_torch.gmm.mono import MonophoneTrainer
    from kaldi_aslp_tpu_torch.recipes import hard_ladder

    torch.set_num_threads(4)
    with open(job, "rb") as f:
        spec = pickle.load(f)
    lang, feats, texts = spec["lang"], spec["feats"], spec["texts"]
    t0 = time.perf_counter()
    mono = MonophoneTrainer(lang, opts=spec["opts"], device="cpu")
    am, tm = mono.train(feats, texts)
    np.savez(spec["out"], **mono._final_alignments)
    print(json.dumps({"stage": "mono", "seconds": time.perf_counter() - t0,
                      "gaussians": int(am.num_gauss_per_pdf.sum())}),
          flush=True)
    t0 = time.perf_counter()
    art = hard_ladder.train_tri(lang, arpa_to_fst(spec["arpa"], lang.words),
                                mono, am, tm, feats, texts, spec["tri_opts"],
                                "cpu")
    np.savez(spec["tri_out"], **art["tri"]._final_alignments)
    print(json.dumps({"stage": "tri", "seconds": time.perf_counter() - t0,
                      "gaussians": int(art["am1"].num_gauss_per_pdf.sum()),
                      "tree": tree_nodes(art["tri"].tree),
                      "train_triples": tm_triples(art["tm1"]),
                      "decode_triples": tm_triples(art["tm1d"])}),
          flush=True)


def gmm_child_line(child, stage):
    """The GMM CPU process's JSON line for ``stage`` (read as it comes);
    raises, with its errors, if the process ends first."""
    for line in child.stdout:
        if line.startswith("{"):
            out = json.loads(line)
            if out.get("stage") == stage:
                return out
    child.wait()
    with open(child.err_path) as f:
        err = f.read()
    raise RuntimeError(f"the GMM CPU process ended (exit {child.returncode}) "
                       f"before its {stage} line: {err[-3000:]}")


def hybrid_mono_part(corpus, workdir):
    """The ladder's mono stage on the card: its WER in JAX's band, pruning
    sensitivity, the final alignments equal to a CPU run's, one
    utterance's loglikes against the CPU, one re-estimation's statistics
    the same bits twice; each part timed."""
    import pickle

    from kaldi_aslp_tpu_torch.gmm import diag_gmm
    from kaldi_aslp_tpu_torch.gmm.mono import MonophoneTrainer
    from kaldi_aslp_tpu_torch.recipes import hard_ladder

    sc = hard_ladder._Scale("small")
    work = os.path.join(workdir, "hybrid")
    os.makedirs(work)
    job = os.path.join(work, "gmm_cpu.pkl")
    with open(job, "wb") as f:
        pickle.dump({"lang": corpus["lang"], "opts": sc.mono,
                     "tri_opts": tri_options(), "arpa": corpus["arpa"],
                     "feats": corpus["train_feats"],
                     "texts": corpus["train_texts"],
                     "out": os.path.join(work, "mono_cpu.npz"),
                     "tri_out": os.path.join(work, "tri_cpu.npz")}, f)
    err_path = os.path.join(work, "gmm_cpu.err")
    with open(err_path, "w") as err:
        child = subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; "
             f"chip_smoke.gmm_cpu_child({job!r})"],
            stdout=subprocess.PIPE, stderr=err, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    child.err_path = err_path
    times, undo = timed_methods(MonophoneTrainer,
                                ["train", "_align_all", "_reestimate"])
    decode_ms = []
    inner_decode = hard_ladder.decode_wer_dev_test

    def decode(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner_decode(*a, **k)
        decode_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    hard_ladder.decode_wer_dev_test = decode
    t0 = time.perf_counter()
    try:
        results = hard_ladder.run(os.path.join(work, "ladder"),
                                  scale="small", stages=["mono"],
                                  corpus=corpus, device="cuda")
    finally:
        undo()
        hard_ladder.decode_wer_dev_test = inner_decode
    stage_s = time.perf_counter() - t0
    art = hard_ladder.run.artifacts
    wer, dev_wer = results["mono"], hard_ladder.run.dev_results["mono"]
    t0 = time.perf_counter()
    healthy, degraded = hard_ladder.pruning_sensitivity(
        art, max_utts=PRUNING_UTTS)
    sensitivity_s = time.perf_counter() - t0
    lo, hi = MONO_WER_BAND
    if not (lo < wer < hi and lo < dev_wer < hi):
        raise RuntimeError(f"mono WER test {wer} dev {dev_wer} outside "
                           f"{MONO_WER_BAND}")
    if not degraded >= healthy + 1.0:
        raise RuntimeError(f"pruning sensitivity: degraded {degraded}, "
                           f"healthy {healthy}")
    mono, am0 = art["mono"], art["am0"]
    # the final alignments against the CPU's run of the same stage
    t0 = time.perf_counter()
    cpu = gmm_child_line(child, "mono")
    cpu_wait_s = time.perf_counter() - t0
    z = np.load(os.path.join(work, "mono_cpu.npz"))
    card_ali = mono._final_alignments
    if sorted(z.files) != sorted(card_ali):
        raise RuntimeError("the CPU run aligned other utterances")
    differ = {u: int((z[u] != card_ali[u]).sum()) for u in z.files
              if not np.array_equal(z[u], card_ali[u])}
    frames = sum(len(a) for a in card_ali.values())
    if differ:
        raise RuntimeError(f"mono alignments differ from the CPU's in "
                           f"{len(differ)} utterances: {differ}")
    # one utterance's loglikes, card against CPU
    u = max(corpus["test_feats"], key=lambda k: len(corpus["test_feats"][k]))
    feats = torch.from_numpy(corpus["test_feats"][u])
    card_ll = diag_gmm.gmm_loglikes(feats.cuda(), *am0.pack("cuda")).cpu()
    cpu_ll = diag_gmm.gmm_loglikes(feats, *am0.pack("cpu"))
    ll_rel = float(((card_ll - cpu_ll).abs() / cpu_ll.abs()).max())
    if not ll_rel <= MONO_LL_RTOL:
        raise RuntimeError(f"GMM loglikes card vs CPU {ll_rel}")
    # one re-estimation's statistics, twice on the card
    utts = list(card_ali)
    tm = mono.trans_model
    F = np.concatenate([corpus["train_feats"][k] for k in utts])
    pdfs = np.concatenate([tm.alignment_to_pdfs(card_ali[k]) for k in utts])

    def stats_once():
        s = diag_gmm.GmmStats(am0, "cuda")
        s.accumulate(am0.pack("cuda"), F, pdfs)
        return s

    runs = [stats_once() for _ in range(2)]
    same = all(torch.equal(getattr(runs[0], k), getattr(runs[1], k))
               for k in ("occ", "mean_acc", "var_acc"))
    if not same:
        raise RuntimeError("GMM statistics differ between two runs")
    stats_ms = cuda_ms(stats_once, reps=5)
    # one realignment pass on the card: device busy share
    graphs = {k: mono.compiler.compile(corpus["train_texts"][k])
              for k in utts}
    counts = {}
    t0 = time.perf_counter()
    mono._align_all(am0, graphs, corpus["train_feats"], utts)
    torch.cuda.synchronize()
    align_ms = 1e3 * (time.perf_counter() - t0)
    by_kernel = device_ms_by_kernel(
        lambda: mono._align_all(am0, graphs, corpus["train_feats"], utts),
        counts)
    device_ms = sum(v for k, v in by_kernel.items()
                    if not k.startswith(("Memcpy", "Memset")))
    launches = sum(c for k, c in counts.items()
                   if not k.startswith(("Memcpy", "Memset")))
    T_max = max(len(corpus["train_feats"][k]) for k in utts)
    out = {"test_wer": wer, "dev_wer": dev_wer, "pruning_healthy": healthy,
           "pruning_degraded": degraded, "pdfs": am0.num_pdfs,
           "gaussians": int(am0.num_gauss_per_pdf.sum()),
           "train_utts": len(utts), "train_frames": frames,
           "stage_s": stage_s, "train_ms": times["train"][0],
           "realign_ms": times["_align_all"],
           "reestimate_ms": times["_reestimate"],
           "decode_dev_test_ms": decode_ms[0],
           "pruning_sensitivity_s": sensitivity_s,
           "cpu_train_s": cpu["seconds"], "cpu_wait_s": cpu_wait_s,
           "alignments_equal_cpu": True, "loglikes_rel_err": ll_rel,
           "stats_same_bits_twice": True, "stats_ms": stats_ms,
           "realign_pass_ms": align_ms,
           "realign_launches_per_frame": launches / T_max,
           "realign_device_busy_share": device_ms / align_ms,
           "graph_states": art["packed0"].num_states,
           "graph_arcs": len(art["packed0"].src)}
    log("hybrid_mono", **out, card=smi_name_and_power())
    if (out["graph_states"], out["graph_arcs"]) != MONO_HCLG:
        raise RuntimeError(f"mono HCLG {out['graph_states']} states, "
                           f"{out['graph_arcs']} arcs; want {MONO_HCLG}")
    return art, child, out


def hybrid_dnn_part(corpus, tri_art, workdir):
    """The ladder's dnn stage: HybridRecipe on the tri stage's final
    alignments (pdfs of its training transition model) and its CD HCLG
    through ``bootstrap=``: the second epoch's loss below the first's,
    one minibatch's loss and gradients and one utterance's scores against
    the CPU, the WER, each part timed."""
    import copy

    from kaldi_aslp_tpu_torch.decoder.decodable import (
        NnetForwardOptions,
        nnet_forward,
    )
    from kaldi_aslp_tpu_torch.fst import arpa_to_fst
    from kaldi_aslp_tpu_torch.recipes import hard_ladder
    from kaldi_aslp_tpu_torch.recipes.hybrid import HybridRecipe
    from kaldi_aslp_tpu_torch.train import (
        FrameTrainer,
        NnetTrainOptions,
        init_velocity,
    )
    from kaldi_aslp_tpu_torch.train.trainer import upload_frames

    lang, tm1 = corpus["lang"], tri_art["tm1"]
    targets = {u: tm1.alignment_to_pdfs(a)
               for u, a in tri_art["tri"]._final_alignments.items()}
    G = arpa_to_fst(corpus["arpa"], lang.words)
    opts = dataclasses.replace(
        hard_ladder.dnn_options(hard_ladder._Scale("full")),
        max_iters=DNN_ITERS)
    rec = HybridRecipe(lang, opts)
    times, undo = timed_methods(HybridRecipe, ["_sweep"])
    t0 = time.perf_counter()
    try:
        stats = rec.run(corpus["train_feats"], corpus["train_texts"],
                        corpus["test_feats"], corpus["test_texts"],
                        grammar=G, work_dir=os.path.join(workdir, "hybrid",
                                                         "dnn"),
                        bootstrap=(targets, tm1.num_pdfs, tri_art["hclg1"],
                                   tri_art["lut1"]),
                        dev_feats=corpus["dev_feats"],
                        dev_texts=corpus["dev_texts"])
    finally:
        undo()
    run_s = time.perf_counter() - t0
    for e in rec.epochs:
        log("hybrid_epoch", **e)
    losses = [e["train_loss"] for e in rec.epochs]
    if not np.isfinite(losses).all() or not losses[1] < losses[0]:
        raise RuntimeError(f"DNN training loss did not fall: {losses}")
    lo, hi = TRI_WER_BAND
    if not (lo < stats.wer < hi and lo < rec.last_dev_wer < hi):
        raise RuntimeError(f"dnn WER test {stats.wer} dev {rec.last_dev_wer} "
                           f"outside {TRI_WER_BAND}")
    # one minibatch's loss and gradients, card against CPU, from the
    # trained parameters
    cpu_net = copy.deepcopy(rec.net).to("cpu")
    batch = next(iter(rec.batches(rec.tr_utts, 0)))
    got = {}
    for name, net in (("card", copy.deepcopy(rec.net)),
                      ("cpu", copy.deepcopy(cpu_net))):
        trainer = FrameTrainer(net, NnetTrainOptions(momentum=0.9))
        loss, _ = trainer.step(init_velocity(net),
                               upload_frames(batch, trainer.device),
                               opts.learn_rate)
        got[name] = (float(loss), {k: p.grad.cpu()
                                   for k, p in net.named_parameters()})
    loss_rel = abs(got["card"][0] - got["cpu"][0]) / abs(got["cpu"][0])
    grad_rel = max(float((got["card"][1][k] - g).abs().max()
                         / g.abs().max()) for k, g in got["cpu"][1].items())
    # one utterance's scores (log-posteriors minus log-priors)
    u = max(corpus["test_feats"], key=lambda k: len(corpus["test_feats"][k]))
    card_scores = rec.scores(corpus["test_feats"][u])
    cpu_scores = nnet_forward(cpu_net, rec._nn_feats(corpus["test_feats"][u]),
                              NnetForwardOptions(), rec.prior)
    score_err = float(np.abs(card_scores - cpu_scores).max())
    if not (loss_rel <= HYBRID_TOL and grad_rel <= HYBRID_TOL
            and score_err <= HYBRID_TOL):
        raise RuntimeError(f"DNN card vs CPU: loss {loss_rel}, gradients "
                           f"{grad_rel}, scores {score_err}")
    # one training epoch on a copy, profiled: device busy share
    net = copy.deepcopy(rec.net)
    trainer = FrameTrainer(net, NnetTrainOptions(momentum=0.9))
    velocity = init_velocity(net)

    def epoch():
        trainer.train_epoch(velocity, rec.batches(rec.tr_utts, 1), 1e-3)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch()
    torch.cuda.synchronize()
    epoch_ms = 1e3 * (time.perf_counter() - t0)
    by_kernel = device_ms_by_kernel(epoch)
    device_ms = sum(v for k, v in by_kernel.items()
                    if not k.startswith(("Memcpy", "Memset")))
    out = {"test_wer": stats.wer, "dev_wer": rec.last_dev_wer,
           "report": stats.report(), "pdfs": rec.num_pdfs,
           "input_dim": rec.net.nodes[0].input_dim,
           "train_frames": rec.epochs[0]["train_frames"],
           "losses": losses, "run_s": run_s,
           "epoch_s": [e["seconds"] for e in rec.epochs],
           "decode_sweep_ms": times["_sweep"][0],
           "loss_rel_err": loss_rel, "grad_rel_err": grad_rel,
           "scores_max_abs_err": score_err, "tol": HYBRID_TOL,
           "epoch_ms": epoch_ms, "epoch_device_busy_share":
           device_ms / epoch_ms}
    log("hybrid_dnn", **out, card=smi_name_and_power())
    return out


def tri_options():
    """The tri stage's options: the ladder's full preset
    (kaldi_aslp_tpu/recipes/hard_ladder.py:124-126: 12 iterations, 4000
    gaussians and 400 leaves asked, realigned on 2 4 6 8 10, tree_min_gain
    20)."""
    from kaldi_aslp_tpu_torch.recipes import hard_ladder

    return hard_ladder._Scale("full").tri


def tri_part(corpus, art, child, workdir):
    """The ladder's tri stage on the card from phase 19's mono system
    (``hard_ladder.train_tri`` at ``tri_options``, ``score_gmm_stage`` at
    the full preset's K = 8192, beam 96): its WER in JAX's band; its tree,
    training and decode triples and final alignments equal to the GMM CPU
    process's; one realignment pass timed and profiled."""
    from kaldi_aslp_tpu_torch.decoder.viterbi import PackedGraph
    from kaldi_aslp_tpu_torch.fst import arpa_to_fst, expand_hmm_cd
    from kaldi_aslp_tpu_torch.gmm.deltas import DeltasTrainer
    from kaldi_aslp_tpu_torch.recipes import hard_ladder

    lang = corpus["lang"]
    feats, texts = corpus["train_feats"], corpus["train_texts"]
    G = arpa_to_fst(corpus["arpa"], lang.words)
    times, undo = timed_methods(DeltasTrainer, [
        "build_tree_from_alignments", "train", "_align_all", "_reestimate"])
    graph_ms = []
    inner_graph = hard_ladder.make_cd_decode_graph

    def graph(*a, **k):
        t0 = time.perf_counter()
        out = inner_graph(*a, **k)
        graph_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    hard_ladder.make_cd_decode_graph = graph
    t0 = time.perf_counter()
    try:
        tri_art = hard_ladder.train_tri(lang, G, art["mono"], art["am0"],
                                        art["tm0"], feats, texts,
                                        tri_options(), "cuda")
    finally:
        undo()
        hard_ladder.make_cd_decode_graph = inner_graph
    stage_s = time.perf_counter() - t0
    tri, am1, tm1 = tri_art["tri"], tri_art["am1"], tri_art["tm1"]
    hclg1 = tri_art["hclg1"]
    t0 = time.perf_counter()
    packed1 = PackedGraph.from_fst(hclg1)
    wer, dev_wer, _, _ = hard_ladder.score_gmm_stage(
        packed1, tri_art["lut1"], am1.pack("cuda"), corpus, art["refs"],
        art["dev_refs"], hard_ladder.GMM_MAX_ACTIVE, "cuda")
    decode_s = time.perf_counter() - t0
    lo, hi = TRI_WER_BAND
    if not (lo < wer < hi and lo < dev_wer < hi):
        raise RuntimeError(f"tri WER test {wer} dev {dev_wer} outside "
                           f"{TRI_WER_BAND}")
    # the tree, the triples and the final alignments against the CPU's
    t0 = time.perf_counter()
    cpu = gmm_child_line(child, "tri")
    child.wait(timeout=60)
    cpu_wait_s = time.perf_counter() - t0
    if child.returncode != 0:
        raise RuntimeError(f"the GMM CPU process exited {child.returncode}")
    if tree_nodes(tri.tree) != cpu["tree"]:
        raise RuntimeError("the tri tree differs from the CPU's")
    if tm_triples(tm1) != cpu["train_triples"] or \
            tm_triples(tri_art["tm1d"]) != cpu["decode_triples"]:
        raise RuntimeError("the tri triples differ from the CPU's")
    z = np.load(os.path.join(workdir, "hybrid", "tri_cpu.npz"))
    card_ali = tri._final_alignments
    if sorted(z.files) != sorted(card_ali):
        raise RuntimeError("the CPU's tri run aligned other utterances")
    differ = {u: int((z[u] != card_ali[u]).sum()) for u in z.files
              if not np.array_equal(z[u], card_ali[u])}
    if differ:
        raise RuntimeError(f"tri alignments differ from the CPU's in "
                           f"{len(differ)} utterances: {differ}")
    # one realignment pass over the training graphs: launches, busy share
    utts = sorted(card_ali)
    graphs = {u: expand_hmm_cd(tri.compiler.compile_clg(texts[u]), tm1,
                               tri.windows, tri.tree) for u in utts}
    lut = tm1.alignment_to_pdfs(np.arange(tm1.num_transition_ids + 1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = tri._align_all(am1, graphs, feats, utts, lut)
    torch.cuda.synchronize()
    align_ms = 1e3 * (time.perf_counter() - t0)
    counts = {}
    by_kernel = device_ms_by_kernel(
        lambda: tri._align_all(am1, graphs, feats, utts, lut), counts)
    device_ms = sum(v for k, v in by_kernel.items()
                    if not k.startswith(("Memcpy", "Memset")))
    launches = sum(c for k, c in counts.items()
                   if not k.startswith(("Memcpy", "Memset")))
    T_max = max(len(feats[u]) for u in utts)
    out = {"test_wer": wer, "dev_wer": dev_wer, "leaves": tri.tree.num_pdfs,
           "leaves_asked": tri.opts.num_leaves,
           "gaussians": int(am1.num_gauss_per_pdf.sum()),
           "gaussians_asked": tri.opts.totgauss,
           "max_gauss_per_pdf": am1.max_gauss,
           "windows": len(tri.windows), "transition_ids":
           tm1.num_transition_ids,
           "decode_transition_ids": tri_art["tm1d"].num_transition_ids,
           "hclg_states": packed1.num_states, "hclg_arcs": len(packed1.src),
           "stage_s": stage_s, "tree_ms": times[
               "build_tree_from_alignments"][0],
           "train_ms": times["train"][0], "realign_ms": times["_align_all"],
           "reestimate_ms": times["_reestimate"], "cd_graph_ms": graph_ms[0],
           "decode_dev_test_s": decode_s, "max_active":
           hard_ladder.GMM_MAX_ACTIVE, "beam": hard_ladder.GMM_BEAM,
           "cpu_train_s": cpu["seconds"], "cpu_wait_s": cpu_wait_s,
           "tree_equal_cpu": True, "triples_equal_cpu": True,
           "alignments_equal_cpu": True,
           "realign_same_as_final": all(np.array_equal(again[u],
                                                       card_ali[u])
                                        for u in utts),
           "realign_pass_ms": align_ms,
           "realign_launches_per_frame": launches / T_max,
           "realign_device_busy_share": device_ms / align_ms}
    log("tri", **out, card=smi_name_and_power())
    return tri_art, out


def sat_objective(trainer, am, feats, texts, transforms, utt2spk, device):
    """The SAT objective: the features through their speakers'
    transforms, realigned by the trainer, the aligned pdfs'
    log-likelihood plus log |det A| a frame, per frame."""
    from kaldi_aslp_tpu_torch.gmm.diag_gmm import corpus_loglikes
    from kaldi_aslp_tpu_torch.gmm.sat import apply_speaker_transforms

    adapted = apply_speaker_transforms(feats, transforms, utt2spk, device)
    tm = trainer.trans_model
    alis = trainer.align(am, adapted, texts)
    lls = corpus_loglikes(adapted, sorted(alis), am.pack(device))
    total = frames = 0.0
    for u, a in alis.items():
        pdfs = tm.alignment_to_pdfs(a)
        A = transforms[utt2spk[u]][:, :-1].astype(np.float64)
        total += float(lls[u][np.arange(len(pdfs)), pdfs].astype(
            np.float64).sum()) + len(pdfs) * np.log(abs(np.linalg.det(A)))
        frames += len(pdfs)
    return total / frames


def family_err(card, cpu):
    """The largest difference against the CPU array's largest
    magnitude."""
    card, cpu = np.asarray(card, np.float64), np.asarray(cpu, np.float64)
    return float(np.abs(card - cpu).max() / max(np.abs(cpu).max(), 1e-30))


def gmm_family_part(corpus, tri_art):
    """The rest of the GMM family on the card against the CPU at the tri
    system's size: LDA + MLLT from the tri alignments, one SAT outer
    iteration over the tri system with the corpus's speakers, one EBW
    update, full-GMM loglikes from ``from_diag`` of the tri model, a
    global GMM's ``init_from_feats`` + EM, and the GMM VAD on phase 13's
    two-burst signal; each timed on the card."""
    import copy

    from kaldi_aslp_tpu_torch.feats import transforms as tr
    from kaldi_aslp_tpu_torch.feats.mel import MelBanksOptions
    from kaldi_aslp_tpu_torch.feats.mfcc import Mfcc, MfccOptions
    from kaldi_aslp_tpu_torch.feats.window import FrameExtractionOptions
    from kaldi_aslp_tpu_torch.gmm import diag_gmm, ebw, full_gmm, global_gmm
    from kaldi_aslp_tpu_torch.gmm.sat import SatOptions, SatTrainer
    from kaldi_aslp_tpu_torch.vad import VadOptions, train_gmm_vad

    tri, am1, tm1 = tri_art["tri"], tri_art["am1"], tri_art["tm1"]
    feats, texts = corpus["train_feats"], corpus["train_texts"]
    utts = sorted(tri._final_alignments)
    pdfs = {u: tm1.alignment_to_pdfs(tri._final_alignments[u]) for u in utts}
    F = np.concatenate([feats[u] for u in utts])
    Pd = np.concatenate([pdfs[u] for u in utts])
    D = F.shape[1]
    errs, ms, out = {}, {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        ms[name] = 1e3 * (time.perf_counter() - t0)
        return res

    # LDA over the tri pdfs, then MLLT from the tri model's gammas
    lda_stats = tr.LdaStats(am1.num_pdfs, D)
    lda_stats.accumulate(F, Pd)
    lda = tr.estimate_lda(lda_stats, D)
    y = timed("lda_apply", lambda: tr.apply_transform(F, lda, "cuda"))
    errs["lda_apply"] = family_err(y.cpu(), tr.apply_transform(F, lda, "cpu"))
    n = FAMILY_FRAMES
    gam = {dev: tr.gmm_gammas_for_alignment(am1, F[:n], Pd[:n], dev)
           for dev in ("cuda", "cpu")}
    timed("gammas", lambda: tr.gmm_gammas_for_alignment(
        am1, F[:n], Pd[:n], "cuda"))
    errs["gammas"] = family_err(gam["cuda"][0], gam["cpu"][0])
    mllt = {}
    for dev, (g, mu, iv) in gam.items():
        st = tr.MlltStats(D)
        st.accumulate(F[:n], mu, iv, g)
        mllt[dev] = tr.estimate_mllt(st)
    errs["mllt"] = family_err(mllt["cuda"], mllt["cpu"])
    errs["mllt_apply"] = family_err(
        tr.apply_transform(F, mllt["cuda"], "cuda").cpu(),
        tr.apply_transform(F, mllt["cuda"], "cpu"))
    out["mllt_logdet"] = float(np.log(abs(np.linalg.det(mllt["cuda"]))))
    # one SAT outer iteration with the corpus's speakers, card and CPU
    utt2spk = corpus["train_utt2spk"]
    cpu_tri = copy.copy(tri)
    cpu_tri.device = torch.device("cpu")
    sat = {}
    for dev, base in (("cuda", tri), ("cpu", cpu_tri)):
        t0 = time.perf_counter()
        sat[dev] = SatTrainer(base, SatOptions(num_outer_iters=1)).train(
            am1, feats, texts, utt2spk)
        ms[f"sat_{dev}"] = 1e3 * (time.perf_counter() - t0)
    spks = sorted(sat["cpu"][1])
    errs["sat_transforms"] = max(family_err(sat["cuda"][1][k],
                                            sat["cpu"][1][k]) for k in spks)
    errs["sat_means"] = family_err(sat["cuda"][0].means, sat["cpu"][0].means)
    identity = {k: np.eye(D, D + 1, dtype=np.float32) for k in spks}
    before = sat_objective(tri, am1, feats, texts, identity, utt2spk, "cuda")
    after = sat_objective(tri, sat["cuda"][0], feats, texts, sat["cuda"][1],
                          utt2spk, "cuda")
    if not after > before:
        raise RuntimeError(f"SAT lowered the adapted likelihood: {before} "
                           f"-> {after}")
    out.update(sat_speakers=len(spks), sat_objective_before=before,
               sat_objective_after=after)
    # one EBW update on FAMILY_FRAMES frames
    num = {dev: ebw.accumulate_numerator_stats(am1, F[:n], Pd[:n], dev)
           for dev in ("cuda", "cpu")}
    den = {dev: ebw.accumulate_denominator_stats(am1, F[:n], device=dev)
           for dev in ("cuda", "cpu")}
    timed("ebw_den", lambda: ebw.accumulate_denominator_stats(
        am1, F[:n], device="cuda"))
    errs["ebw_num"] = max(family_err(a, b) for a, b in zip(num["cuda"],
                                                           num["cpu"]))
    errs["ebw_den"] = max(family_err(a, b) for a, b in zip(den["cuda"],
                                                           den["cpu"]))
    new = {dev: ebw.ebw_update(am1, num[dev], den[dev])
           for dev in ("cuda", "cpu")}
    errs["ebw_means"] = family_err(new["cuda"].means, new["cpu"].means)
    out["ebw_mean_change"] = float(np.abs(new["cuda"].means
                                          - am1.means).max())
    # full-GMM loglikes of the tri model, against its diagonal loglikes
    full = full_gmm.AmFullGmm.from_diag(am1)
    u = max(corpus["test_feats"], key=lambda k: len(corpus["test_feats"][k]))
    x = corpus["test_feats"][u]
    packed = {dev: full.pack(dev) for dev in ("cuda", "cpu")}
    fl = timed("full_loglikes", lambda: full_gmm.full_gmm_loglikes(
        x, *packed["cuda"])).cpu()
    errs["full_loglikes"] = family_err(fl, full_gmm.full_gmm_loglikes(
        x, *packed["cpu"]))
    out["full_vs_diag"] = family_err(fl, diag_gmm.gmm_loglikes(
        torch.from_numpy(x), *am1.pack("cpu")))
    # a global GMM grown from the training frames, card and CPU
    glob = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        glob[dev] = global_gmm.init_from_feats(F, GLOBAL_GAUSS,
                                               num_iters=GLOBAL_ITERS,
                                               device=dev)
        ms[f"global_{dev}"] = 1e3 * (time.perf_counter() - t0)
    if glob["cuda"].num_gauss != glob["cpu"].num_gauss:
        raise RuntimeError("the global GMMs grew apart")
    errs["global_means"] = family_err(glob["cuda"].means, glob["cpu"].means)
    out["global_gauss"] = glob["cuda"].num_gauss
    out["global_avg_loglike"] = global_gmm.avg_loglike(glob["cuda"], F,
                                                       "cuda")
    # the GMM VAD on the two-burst signal (tones at 1-1.5 s and 2.5-3 s)
    mfcc = Mfcc(FrameExtractionOptions(samp_freq=SAMPLE_RATE, dither=0.0),
                MelBanksOptions(num_bins=23), MfccOptions(), device="cpu")
    vf = mfcc(two_bursts().astype(np.float32)).numpy()
    t_mid = (np.arange(len(vf)) * 10 + 12.5) / 1000.0
    targets = (((t_mid >= 1.0) & (t_mid < 1.5))
               | ((t_mid >= 2.5) & (t_mid < 3.0))).astype(np.int32)
    vad = {dev: train_gmm_vad(vf, targets, num_gauss=4, num_iters=8,
                              opts=VadOptions(), device=dev)
           for dev in ("cuda", "cpu")}
    masks = {dev: v.detect(vf) for dev, v in vad.items()}
    errs["vad_scores"] = family_err(vad["cuda"].frame_scores(vf),
                                    vad["cpu"].frame_scores(vf))
    if not np.array_equal(masks["cuda"], masks["cpu"]):
        raise RuntimeError("the GMM VAD's masks differ card vs CPU")
    m = masks["cuda"].astype(np.int8)
    out.update(vad_frames=len(vf), vad_agree=float(
        (masks["cuda"] == targets.astype(bool)).mean()),
        vad_segments=int((np.diff(np.concatenate([[0], m, [0]])) == 1).sum()))
    if out["vad_segments"] != 2 or out["vad_agree"] < 0.9:
        raise RuntimeError(f"GMM VAD: {out['vad_segments']} segments, "
                           f"{out['vad_agree']} of frames agree")
    bad = {k: v for k, v in errs.items() if not v <= FAMILY_TOL}
    if bad:
        raise RuntimeError(f"GMM family card vs CPU beyond {FAMILY_TOL}: "
                           f"{bad}")
    out.update(errs=errs, tol=FAMILY_TOL, ms=ms, frames=n)
    log("gmm_family", **out, card=smi_name_and_power())
    return out


def write_simple_files(workdir):
    """build_dnn_hybrid's full widths at random weights (numpy seed 1357:
    N(0, 0.1) hidden and N(0, 0.04) output weights, zero biases) and a
    corpus of SIMPLE_UTTS utterances of 400-600 frames whose frame targets
    are a function of the features: one of SIMPLE_TARGETS pdfs, picked
    by the argmax of a fixed projection of the frame."""
    from kaldi_aslp_tpu_torch.io import int_vector_writer, matrix_writer
    from kaldi_aslp_tpu_torch.models.flagship import build_dnn_hybrid

    rs = np.random.RandomState(1357)
    net = build_dnn_hybrid()
    last = len(net.nodes) - 1
    with torch.no_grad():
        for name, p in net.named_parameters():
            scale = 0.04 if name.startswith(f"nodes.{last}.") else 0.1
            p.copy_(torch.from_numpy(
                (scale * rs.randn(*p.shape)).astype(np.float32)
                if name.endswith(".w") else np.zeros(p.shape, np.float32)))
    model = f"{workdir}/dnn_hybrid.zip"
    net.save(model)
    D, V = net.nodes[0].input_dim, net.output_dim
    proj = rs.randn(D, SIMPLE_TARGETS)
    pdfs = rs.choice(V, SIMPLE_TARGETS, replace=False).astype(np.int32)
    frames = 0
    with matrix_writer(f"ark,scp:{workdir}/simple_feats.ark,"
                       f"{workdir}/simple_feats.scp") as fw, \
            int_vector_writer(f"ark:{workdir}/simple_ali.ark") as tw:
        for i in range(SIMPLE_UTTS):
            feats = rs.randn(rs.randint(400, 601), D).astype(np.float32)
            fw[f"utt{i:02d}"] = feats
            tw[f"utt{i:02d}"] = pdfs[np.argmax(feats @ proj, axis=1)]
            frames += len(feats)
    return (model, f"scp:{workdir}/simple_feats.scp",
            f"ark:{workdir}/simple_ali.ark", frames)


def hybrid_cli_part(workdir):
    """aslp-nnet-train-simple --device=cuda at the DNN hybrid's full
    widths: the loss falls, the model it writes loads and moved;
    --cross-validate=true moves nothing and prints FRAME_ACCURACY; one
    step split by CUDA events."""
    from kaldi_aslp_tpu_torch.models import Nnet
    from kaldi_aslp_tpu_torch.train import (
        FrameTrainer,
        NnetTrainOptions,
        init_velocity,
    )

    model, feats, targets, frames = write_simple_files(workdir)
    steps = []
    inner_step = FrameTrainer.step

    def step(self, velocity, batch, learn_rate):
        loss, aux = inner_step(self, velocity, batch, learn_rate)
        steps.append(float(loss))   # syncs the card
        return loss, aux

    out = f"{workdir}/dnn_hybrid_trained.zip"
    FrameTrainer.step = step
    t0 = time.perf_counter()
    try:
        rc, printed = run_cli(["aslp-nnet-train-simple", "--device=cuda",
                               *SIMPLE_ARGS, feats, targets, model, out])
    finally:
        FrameTrainer.step = inner_step
    train_s = time.perf_counter() - t0
    q = len(steps) // 4
    first, last = float(np.mean(steps[:q])), float(np.mean(steps[-q:]))
    if rc != 0 or q < 2 or not np.isfinite(steps).all() or not last < first:
        raise RuntimeError(f"train-simple exit {rc}, losses {steps}")
    before, _ = Nnet.load(model, "cpu")
    after, _ = Nnet.load(out, "cpu")
    moved = max(float((p - q_).abs().max()) for p, q_ in zip(
        after.state_dict().values(), before.state_dict().values()))
    if moved == 0.0 or not all(torch.isfinite(p).all()
                               for p in after.state_dict().values()):
        raise RuntimeError(f"the written model: change {moved}")
    seen = {}
    inner_eval = FrameTrainer.evaluate

    def evaluate(self, batches, reporter=None):
        params = {k: v.clone() for k, v in self.net.state_dict().items()}
        rep = inner_eval(self, batches, reporter)
        seen["unchanged"] = all(torch.equal(v, params[k]) for k, v in
                                self.net.state_dict().items())
        return rep

    FrameTrainer.evaluate = evaluate
    t0 = time.perf_counter()
    try:
        rc, cv_printed = run_cli(["aslp-nnet-train-simple", "--device=cuda",
                                  "--cross-validate=true", feats, targets,
                                  out])
    finally:
        FrameTrainer.evaluate = inner_eval
    cv_s = time.perf_counter() - t0
    if rc != 0 or "FRAME_ACCURACY" not in cv_printed or \
            not seen.get("unchanged"):
        raise RuntimeError(f"cross-validation: exit {rc}, {seen}")
    # one step at the tool's minibatch, split by CUDA events
    net, _ = Nnet.load(model, "cuda")
    dev = next(net.parameters()).device
    trainer = FrameTrainer(net, NnetTrainOptions(momentum=0.9))
    velocity = init_velocity(net)
    rs = np.random.RandomState(0)
    N = 256
    x = torch.from_numpy(rs.randn(N, net.nodes[0].input_dim).astype(
        np.float32)).to(dev)
    t = torch.from_numpy(rs.randint(0, net.output_dim, N)).to(dev)
    w = torch.ones(N, device=dev)
    trainer.step(velocity, (x, t, w), 1e-4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    splits = []
    for _ in range(RECIPE_SPLIT_REPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        for p in net.parameters():
            p.grad = None
        net.train()
        ev[0].record()
        y = trainer.forward(x)
        ev[1].record()
        loss, _ = trainer.loss(y, t, w)
        ev[2].record()
        loss.backward()
        ev[3].record()
        trainer._update(velocity, 1e-4)
        ev[4].record()
        torch.cuda.synchronize()
        splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)])
    med = np.median(np.asarray(splits), axis=0)
    step_ms = float(med.sum())
    out = {"frames": frames, "steps": len(steps),
           "first_quarter_loss": first, "last_quarter_loss": last,
           "max_param_change": moved, "train_s": train_s, "cv_s": cv_s,
           "cv_params_unchanged": True,
           "report": printed.strip().splitlines()[0],
           "cv_report": cv_printed.strip().splitlines(),
           "step_split": {"N": N, "forward_ms": float(med[0]),
                          "loss_ms": float(med[1]),
                          "backward_ms": float(med[2]),
                          "update_ms": float(med[3]), "step_ms": step_ms,
                          "frames_per_s": N / (step_ms / 1e3),
                          "peak_mem_gib": torch.cuda.max_memory_allocated()
                          / 2 ** 30}}
    log("hybrid_cli", **out, card=smi_name_and_power())
    return out


def hybrid_phase(corpus, workdir):
    """Phase 19: the mono stage and the frame trainer's CLI, with no hand
    kernel launched anywhere in it.  Returns the ladder's artifacts and
    the GMM CPU process, which goes on to the tri stage."""
    for w in kernel_wrappers().values():
        w.launches = 0
    t0 = time.perf_counter()
    art, child, mono = hybrid_mono_part(corpus, workdir)
    cli = hybrid_cli_part(workdir)
    launches = hand_kernel_launches()
    seconds = time.perf_counter() - t0
    log("hybrid", mono_test_wer=mono["test_wer"],
        mono_dev_wer=mono["dev_wer"],
        pruning=[mono["pruning_healthy"], mono["pruning_degraded"]],
        mono_stage_s=mono["stage_s"], cli_train_s=cli["train_s"],
        dnn_step_ms=cli["step_split"]["step_ms"],
        realign_device_busy_share=mono["realign_device_busy_share"],
        hand_kernel_launches=launches, seconds=seconds,
        card=smi_name_and_power())
    if any(launches.values()):
        raise RuntimeError(f"the hybrid phase launched hand kernels: "
                           f"{launches}")
    return art, child


def tri_phase(corpus, art, child, workdir):
    """Phase 20: the ladder's tri stage on phase 19's mono system, its dnn
    stage on the tri alignments and CD graph, and the rest of the GMM
    family, with no hand kernel launched anywhere in it."""
    for w in kernel_wrappers().values():
        w.launches = 0
    t0 = time.perf_counter()
    try:
        tri_art, tri = tri_part(corpus, art, child, workdir)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    dnn = hybrid_dnn_part(corpus, tri_art, workdir)
    family = gmm_family_part(corpus, tri_art)
    launches = hand_kernel_launches()
    seconds = time.perf_counter() - t0
    log("tri_phase", tri_test_wer=tri["test_wer"], tri_dev_wer=tri["dev_wer"],
        dnn_test_wer=dnn["test_wer"], dnn_dev_wer=dnn["dev_wer"],
        leaves=tri["leaves"], gaussians=tri["gaussians"],
        hclg=[tri["hclg_states"], tri["hclg_arcs"]], tri_stage_s=tri["stage_s"],
        tri_decode_s=tri["decode_dev_test_s"], dnn_run_s=dnn["run_s"],
        realign_device_busy_share=tri["realign_device_busy_share"],
        dnn_epoch_device_busy_share=dnn["epoch_device_busy_share"],
        family_ms=family["ms"], hand_kernel_launches=launches,
        seconds=seconds, card=smi_name_and_power())
    if any(launches.values()):
        raise RuntimeError(f"the tri phase launched hand kernels: "
                           f"{launches}")
    # the tri system's transition model and tree, pickled as the port's
    # tools write them, for phase 25's aslp-kws-gen-state-map
    import pickle

    out = {"lang": corpus["lang"], "mdl": f"{workdir}/tri.mdl",
           "tree": f"{workdir}/tri.tree",
           "num_transition_ids": tri_art["tm1"].num_transition_ids}
    for key, obj in (("mdl", tri_art["tm1"]), ("tree", tri_art["tri"].tree)):
        with open(out[key], "wb") as f:
            pickle.dump(obj, f)
    return out


# -- phase 21: ls_synth ------------------------------------------------------

# the recipe's default corpus and schedule at the flagship's widths
# (kaldi_aslp_tpu/recipes/ls_synth.py:95-104); cut only in depth, in the
# order decoded test utterances, newbob iterations, training utterances
# (PERF.md section 4 lists each cut)
# cut for the script's time: 20 of the 100 test utterances decoded and
# rescored, then 24 of the 48 newbob iterations (a proof run took 1,146.8
# s of the 1,200 with 40 decodes, 19.7 s, and 48 iterations, 35.2 s);
# then, for phase 23's room, 10 decodes and 12 iterations; 5 decodes for
# phase 25's
LS_SYNTH = dict(num_words=1000, num_train=1200, num_test=100, max_iters=12)
LS_DECODE_UTTS = 5       # test utterances decoded and rescored (by name)
LS_LATTICE_UTTS = 3      # of them, decoded on the CPU too
LS_SPLIT_REPS = 5


def ls_synth_launches(art, calls, launches, counters):
    """The launches a run of the recipe must make: the x-fused pair 3
    times a training step, the CTC pair once a loss evaluation,
    blstmp_forward 3 times a posteriors call and a CV batch; none else,
    none per step or wide."""
    epochs = len(art["epochs"])
    steps, evals = (epochs * len(art[k]) for k in ("tr_batches",
                                                    "cv_batches"))
    layers = sum(1 for _ in art["net"].nodes) - 1
    want = {"bilstmp_train_fwd": layers * steps,
            "bilstmp_train_bwd": layers * steps,
            "ctc_alpha_beta": steps + evals,
            "blstmp_forward": layers * (evals + calls)}
    got = {n: launches[n] for n in want}
    stray = {n: k for n, k in launches.items() if k and n not in want}
    if got != want or stray or any(counters.values()):
        raise RuntimeError(f"ls_synth launches {got}, want {want}; other "
                           f"kernels {stray}; per-step or wide {counters}")
    return dict(train_steps=steps, cv_evaluations=evals,
                posteriors_calls=calls, layers=layers)


def ls_synth_check(art):
    """The run's net on the card and on the CPU (plain versions, bf16
    as on the card) from the same parameters: one training step on the
    whole first batch (64 streams, 192 frames: the x-fused pair at D = 40
    and 640 and the CTC pair at the shapes the run gave them), one test
    utterance's posteriors; then the first LS_LATTICE_UTTS test
    utterances' loglikes decoded on the card again (the run's lattices)
    and on the CPU (the same decodes)."""
    from kaldi_aslp_tpu_torch.decoder.beam import BeamSearchDecoder, CsrGraph
    from kaldi_aslp_tpu_torch.fst import ctc_lut
    from kaldi_aslp_tpu_torch.models.losses import ctc_batch_loss
    from kaldi_aslp_tpu_torch.recipes import ls_synth
    from kaldi_aslp_tpu_torch.train.trainer import upload

    net = art["net"]
    state = {k: v.detach().cpu() for k, v in net.state_dict().items()}
    batch = art["tr_batches"][0]
    utt = sorted(art["test_feats"])[0]
    V = len(art["lang"].phones) + 1
    cell = net.nodes[0].fwd
    out, step_s = {}, {}
    for device, dev in (("card", art["trainer"].device),
                        ("cpu", torch.device("cpu"))):
        copy = ls_synth.build_net(net.nodes[0].input_dim, V, len(net.nodes) - 1,
                                  cell.proj_dim, cell.cell_dim, bf16=True)
        copy.load_state_dict(state)
        copy.to(dev).train()
        t0 = time.perf_counter()
        feats, labels, in_lens, lab_lens, mask = upload(batch, dev)
        y, _ = copy(feats, mask=mask)
        loss, _ = ctc_batch_loss(y, labels, in_lens, lab_lens)
        loss.backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        step_s[device] = time.perf_counter() - t0
        post = ls_synth.make_posteriors(copy, ls_synth.BUCKET_T, 3, dev)(
            art["test_feats"][utt])
        out[device] = (float(loss.detach()), {
            k: p.grad.cpu() for k, p in copy.named_parameters()}, post)
    loss_rel = abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    grad_rel = {k: rel_err(g, out["cpu"][1][k])
                for k, g in out["card"][1].items()}
    worst = max(grad_rel, key=grad_rel.get)
    post_err = float(np.abs(out["card"][2] - out["cpu"][2]).max())
    run_post_err = float(np.abs(art["posteriors"](art["test_feats"][utt])
                                - out["cpu"][2]).max())
    if (loss_rel > CROSS_LOSS_RTOL or grad_rel[worst] > CROSS_GRAD_RTOL
            or max(post_err, run_post_err) > CROSS_CHECK_ATOL):
        raise RuntimeError(f"ls_synth card vs CPU: loss {loss_rel}, {worst} "
                           f"{grad_rel[worst]}, posteriors {post_err} "
                           f"{run_post_err}")
    # lattices: the card's decoder again (the run's lattices) and the
    # CPU's, on the card's loglikes
    utts = sorted(art["test_ll"])[:LS_LATTICE_UTTS]
    cpu_dec = BeamSearchDecoder(CsrGraph.from_packed(art["packed"]),
                                ctc_lut(V), acoustic_scale=1.0, beam=14.0,
                                max_active=2048, chunk=128, device="cpu")
    card, cpu = [], []
    t0 = time.perf_counter()
    for u in utts:
        got = art["decoder"].decode_lattice(art["test_ll"][u],
                                            lattice_beam=8.0)
        if lattice_arcs(got[3]) != lattice_arcs(art["lats"][u]):
            raise RuntimeError(f"{u}: decoding again changed the lattice")
        card.append(decode_summary(*got))
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for u in utts:
        cpu.append(decode_summary(*cpu_dec.decode_lattice(
            art["test_ll"][u], lattice_beam=8.0)))
    cpu_s = time.perf_counter() - t0
    if card != cpu:
        raise RuntimeError(f"ls_synth lattices: card {card[:1]} CPU "
                           f"{cpu[:1]}")
    log("ls_synth_check", streams=int(batch.feats.shape[0]),
        T=int(batch.feats.shape[1]), U=int(batch.labels.shape[1]),
        card_step_s=step_s["card"], cpu_step_s=step_s["cpu"],
        loss_cuda=out["card"][0], loss_cpu=out["cpu"][0], loss_rel=loss_rel,
        worst_grad=worst, worst_grad_rel=grad_rel[worst],
        posteriors_frames=int(out["cpu"][2].shape[0]),
        posteriors_max_abs_err=post_err,
        run_posteriors_max_abs_err=run_post_err,
        lattice_utts=len(utts), lattice_arcs=[d["arcs"] for d in card],
        card_lattices_equal_cpu=True, card_decode_s=card_s,
        cpu_decode_s=cpu_s,
        tol={"loss": CROSS_LOSS_RTOL, "grad": CROSS_GRAD_RTOL,
             "posteriors": CROSS_CHECK_ATOL})


def ls_step_process():
    """The process ls_synth_step_split takes its step in, started before
    the recipe's run so that its imports and the card's context are ready
    when the step's job comes."""
    return subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; "
         "chip_smoke.ls_step_child()"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))


def ls_synth_step_split(art, workdir, child):
    """One training step of the run's net at its first batch (64 streams,
    192 frames), in the fresh process ``child`` (late in this one the
    profiler dropped kernels of the step): its parts by CUDA events, its
    kernel launches and device busy share by torch.profiler."""
    job = os.path.join(workdir, "ls_step.pt")
    net = art["net"]
    cell = net.nodes[0].fwd
    torch.save(dict(
        state={k: v.detach().cpu() for k, v in net.state_dict().items()},
        batch=art["tr_batches"][0], lr=art["epochs"][-1]["learn_rate"],
        dims=(net.nodes[0].input_dim, len(art["lang"].phones) + 1,
              len(net.nodes) - 1, cell.proj_dim, cell.cell_dim)), job)
    t0 = time.perf_counter()
    stdout, stderr = child.communicate(job + "\n", timeout=300)
    if child.returncode != 0:
        raise RuntimeError(f"step process failed: {stderr[-2000:]}")
    out = json.loads(stdout.strip().splitlines()[-1])
    log("ls_synth_step_split", **out, process_s=time.perf_counter() - t0)
    return out


def ls_step_child():
    """In a fresh process: the card's context, the kernels' libraries and
    the profiler made ready, then the step of ls_synth_step_split on the
    net, batch and learning rate of the job named on standard input,
    printed as one JSON line.  The profile must hold each layer's two
    sweeps and the CTC pair's kernel, else it is taken again (at most 3
    times) and then refused."""
    from torch.profiler import ProfilerActivity, profile

    from kaldi_aslp_tpu_torch.models.losses import ctc_batch_loss
    from kaldi_aslp_tpu_torch.ops import bilstmp_train, ctc_recursions
    from kaldi_aslp_tpu_torch.recipes import ls_synth
    from kaldi_aslp_tpu_torch.train import (
        CtcTrainer,
        NnetTrainOptions,
        init_velocity,
    )
    from kaldi_aslp_tpu_torch.train.trainer import upload

    for m in (bilstmp_train, ctc_recursions):
        m.build()
    ones = torch.ones(64, 64, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        ones.matmul(ones)
        torch.cuda.synchronize()
    job = sys.stdin.readline().strip()
    spec = torch.load(job, weights_only=False)
    dim, V, layers, proj, cell = spec["dims"]
    net = ls_synth.build_net(dim, V, layers, proj, cell, bf16=True)
    net.load_state_dict(spec["state"])
    net.to("cuda")
    trainer = CtcTrainer(net, NnetTrainOptions(momentum=0.9))
    batch, lr = spec["batch"], spec["lr"]
    feats, labels, in_lens, lab_lens, mask = dev_batch = upload(
        batch, trainer.device)
    velocity = init_velocity(net)
    trainer.step(velocity, dev_batch, lr)
    torch.cuda.synchronize()
    splits = []
    for _ in range(LS_SPLIT_REPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        for p in net.parameters():
            p.grad = None
        net.train()
        t0 = time.perf_counter()
        ev[0].record()
        y, _ = net(feats, mask=mask)
        ev[1].record()
        loss, _ = ctc_batch_loss(y, labels, in_lens, lab_lens)
        ev[2].record()
        loss.backward()
        ev[3].record()
        trainer._update(velocity, lr)
        ev[4].record()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
                      + [1e3 * host_s])
    med = np.median(np.asarray(splits), axis=0)
    step_ms = float(med[:4].sum())
    want = {"fwd_sweep_kernel": layers, "bwd_sweep_kernel": layers,
            "ctc_warp_kernel": 1}
    for profile in range(1, 4):
        counts = {}
        by_kernel = device_ms_by_kernel(
            lambda: trainer.step(velocity, dev_batch, lr), counts)
        seen = {w: sum(c for k, c in counts.items() if w in k)
                for w in want}
        if seen == want:
            break
    else:
        raise RuntimeError(f"the step's profile holds {seen} of the "
                           f"kernels, want {want}")
    kernels = {k: c for k, c in counts.items()
               if not k.startswith(("Memcpy", "Memset"))}
    device_ms = sum(v for k, v in by_kernel.items() if k in kernels)
    S, T, D = batch.feats.shape
    print(json.dumps(dict(
        S=S, T=T, D=D, U=int(batch.labels.shape[1]),
        forward_ms=float(med[0]), loss_ms=float(med[1]),
        backward_ms=float(med[2]), update_ms=float(med[3]),
        step_ms=step_ms, host_step_ms=float(med[4]),
        audio_s_per_s=float(batch.input_lengths.sum()) * 0.01 * 3
        / (step_ms / 1e3),
        kernel_launches_per_step=sum(kernels.values()),
        device_busy_ms=device_ms, device_busy_share=device_ms / step_ms,
        profiles_taken=profile, sweeps_and_ctc_in_profile=seen,
        top_kernels=dict(sorted(kernels.items(),
                                key=lambda kv: -kv[1])[:6]),
        reps=LS_SPLIT_REPS)), flush=True)


def ls_synth_phase(workdir):
    """The recipe's run() on the card (LS_SYNTH, the first LS_DECODE_UTTS
    test utterances decoded), its launches counted from 0 just before it
    and read just after; then its checks and one step by part.  Returns
    the x-fused pair's and the CTC pair's launches by name, and
    blstmp_forward's."""
    from kaldi_aslp_tpu_torch.recipes import ls_synth

    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
        if hasattr(w, "per_step"):
            w.per_step = 0
    wrappers["ctc_alpha_beta"].wide = 0
    calls = [0]
    inner = ls_synth.make_posteriors

    def counted(*a, **k):
        fn = inner(*a, **k)

        def posteriors(feats):
            calls[0] += 1
            return fn(feats)
        return posteriors
    ls_synth.make_posteriors = counted
    child = ls_step_process()
    try:
        return ls_synth_run_and_check(workdir, wrappers, calls, child)
    finally:
        ls_synth.make_posteriors = inner
        if child.poll() is None:
            child.kill()
            child.wait()


def ls_synth_run_and_check(workdir, wrappers, calls, child):
    """ls_synth_phase's run, its launches read, its checks and its step
    in ``child``."""
    from kaldi_aslp_tpu_torch.recipes import ls_synth

    t0 = time.perf_counter()
    out = ls_synth.run(os.path.join(workdir, "ls_synth"),
                       num_decode=LS_DECODE_UTTS, device="cuda", **LS_SYNTH)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {n: w.launches for n, w in wrappers.items()}
    counters = {f"{n}.per_step": w.per_step for n, w in wrappers.items()
                if hasattr(w, "per_step")}
    counters["ctc_alpha_beta.wide"] = wrappers["ctc_alpha_beta"].wide
    art = ls_synth.run.artifacts
    counts = ls_synth_launches(art, calls[0], launches, counters)
    epochs = art["epochs"]
    for e in epochs:
        log("ls_synth_epoch", **e)
    accepted = [e for e in epochs[1:] if e["decision"] == "ACCEPT"]
    best_cv = min(e["cv_loss"] for e in epochs if e["decision"] == "ACCEPT")
    if not accepted or not best_cv < epochs[0]["cv_loss"]:
        raise RuntimeError(f"newbob accepted {len(accepted)} iterations "
                           f"after the first; CV {epochs[0]['cv_loss']} -> "
                           f"{best_cv}")
    # a lattice the rescoring could not determinize within its budget
    # keeps the small LM's best path: from a trained model, a sign of a
    # lattice fault
    if art["skipped"]:
        raise RuntimeError(f"ls_synth rescoring skipped {art['skipped']}")
    log("ls_synth", **out, **counts, launches={
        n: k for n, k in launches.items() if k},
        epochs=len(epochs), accepted_after_first=len(accepted),
        cv_first=epochs[0]["cv_loss"], cv_best=best_cv,
        train_batches=len(art["tr_batches"]),
        cv_batches=len(art["cv_batches"]),
        decoded_utts=len(art["test_ll"]), best_lmwt=art["best_lmwt"],
        best_lmwt_large=art["best_big"],
        tlg=[art["tlg"].num_states, art["tlg"].num_arcs],
        train_audio_s=art["train_audio_s"], features_s=art["feats_s"],
        train_s=art["train_s"], decode_s=art["decode_s"],
        rescore_s=art["rescore_s"], run_s=run_s, **LS_SYNTH,
        decode_utts_asked=LS_DECODE_UTTS, card=smi_name_and_power())
    ls_synth_check(art)
    ls_synth_step_split(art, workdir, child)
    return ({n: launches[n] for n in train_kernel_wrappers()},
            launches["blstmp_forward"])


# -- phase 22: synth_recipes -------------------------------------------------

# JAX's recorded rows beside the port's (STATUS.md): the timit medium
# kmeans row, the mono budget sweep at medium; yesno's band is JAX's own
# __main__ check (kaldi_aslp_tpu/recipes/yesno.py:238-239)
YESNO_WER_BAND = (0.0, 5.0)
# cut for the script's time: yesno on 20 of its 60 utterances (10 test;
# the whole recipe took 39.8 s in a first card call, most of it decoding,
# and 26.8 s on 30), rm_synth on 10 of its 15 test utterances, then for
# phase 23's room on 5, for phase 26's on 3
YESNO_UTTS = 20
RM_TEST_UTTS = 3
JAX_ROWS = {"timit_kmeans_medium_test_wer": 43.49,
            "budget_sweep_medium_dev_wer": {"2048": 32.32, "256": 40.78}}
SYNTH_BUDGETS = [2048, 256]


def synth_mono_child(job):
    """In a process of its own: one monophone training on the CPU from
    the job's pickled inputs, its final alignments into the job's npz."""
    import pickle

    from kaldi_aslp_tpu_torch.gmm.mono import MonophoneTrainer

    torch.set_num_threads(1)
    with open(job, "rb") as f:
        spec = pickle.load(f)
    t0 = time.perf_counter()
    mono = MonophoneTrainer(spec["lang"], topo=spec["topo"],
                            opts=spec["opts"], device="cpu")
    mono.train(spec["feats"], spec["texts"])
    np.savez(spec["out"], **mono._final_alignments)
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)


def synth_recipes_phase(corpus, workdir):
    """rm_synth, timit_synth, the GMM budget sweep on (14)'s corpus,
    yesno and the data-dir runner's hybrid pipeline on the card, each
    timed; every monophone training also runs on the CPU in a child
    process started as the card's ends, and its final alignments must
    equal the card's; no hand kernel may launch."""
    import pickle

    from kaldi_aslp_tpu_torch.gmm.mono import MonophoneTrainer
    from kaldi_aslp_tpu_torch.recipes import corpus as corpus_recipe
    from kaldi_aslp_tpu_torch.recipes import (
        decode_budget_sweep,
        rm_synth,
        timit_synth,
        yesno,
    )

    work = os.path.join(workdir, "synth")
    os.makedirs(work)
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    monos = []
    recipe = [None]
    inner_train = MonophoneTrainer.train

    def train(self, feats, texts):
        out = inner_train(self, feats, texts)
        k = len(monos)
        job = os.path.join(work, f"mono{k}.pkl")
        with open(job, "wb") as f:
            pickle.dump({"lang": self.lang, "topo": self.topo,
                         "opts": self.opts, "feats": feats, "texts": texts,
                         "out": os.path.join(work, f"mono{k}.npz")}, f)
        child = subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; "
             f"chip_smoke.synth_mono_child({job!r})"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        monos.append((recipe[0], dict(self._final_alignments), child,
                       os.path.join(work, f"mono{k}.npz")))
        return out

    results, seconds = {}, {}

    def timed(name, fn):
        recipe[0] = name
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[name] = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0

    timit_scale = timit_synth._Scale

    class TimitCut(timit_scale):
        """timit_synth's preset with TIMIT_TEST_UTTS test utterances."""

        def __init__(self, name):
            super().__init__(name)
            self.num_test = TIMIT_TEST_UTTS

    MonophoneTrainer.train = train
    try:
        timed("rm_synth", lambda: rm_synth.run(
            os.path.join(work, "rm"), num_words=20, num_train=40,
            num_test=RM_TEST_UTTS, device="cuda"))
        timit_synth._Scale = TimitCut
        timed("timit_synth", lambda: timit_synth.run(
            os.path.join(work, "timit"), scale="small", methods=["kmeans"],
            device="cuda"))
        timit_synth._Scale = timit_scale
        timed("budget_sweep", lambda: decode_budget_sweep.run(
            "small", list(SYNTH_BUDGETS),
            corpus=first_utts(corpus, **SWEEP_SETS), device="cuda"))
        timed("yesno", lambda: yesno.run(os.path.join(work, "yesno"),
                                         num_utts=YESNO_UTTS, device="cuda"))
        dirs = yesno.run.artifacts["dirs"]
        lexicon = os.path.join(work, "yesno_lexicon.txt")
        with open(lexicon, "w") as f:
            f.write(yesno.load_task_inputs()[0])
        timed("corpus_hybrid", lambda: corpus_recipe.run_corpus(
            dirs["train_yesno"].path, dirs["test_yesno"].path,
            os.path.join(work, "corpus"), corpus_recipe.CorpusRecipeOptions(
                pipeline="hybrid", lexicon=lexicon, num_mel_bins=23,
                device="cuda")).wer)
    finally:
        MonophoneTrainer.train = inner_train
        timit_synth._Scale = timit_scale
    launched = {n: w.launches for n, w in wrappers.items() if w.launches}
    if launched:
        raise RuntimeError(f"the GMM-side recipes launched {launched}")
    lo, hi = YESNO_WER_BAND
    if not lo <= results["yesno"] < hi:
        raise RuntimeError(f"yesno WER {results['yesno']} outside "
                           f"{YESNO_WER_BAND}")
    t0 = time.perf_counter()
    alignments = {}
    for name, card, child, path in monos:
        out, err = child.communicate(timeout=900)
        if child.returncode != 0:
            raise RuntimeError(f"{name}'s CPU mono failed: {err[-3000:]}")
        cpu = dict(np.load(path))
        if sorted(cpu) != sorted(card) or any(
                not np.array_equal(cpu[u], card[u]) for u in card):
            raise RuntimeError(f"{name}: the card's mono alignments are not "
                               "the CPU's")
        alignments.setdefault(name, []).append(len(card))
    log("synth_recipes", wer={k: (v if isinstance(v, float) else
                                  {str(a): b for a, b in v.items()})
                              for k, v in results.items()},
        seconds=seconds, jax_rows=JAX_ROWS, yesno_band=YESNO_WER_BAND,
        budgets=SYNTH_BUDGETS, budget_sweep_s={
            str(k): v for k, v in decode_budget_sweep.run.seconds.items()},
        mono_trainings=alignments, mono_alignments_equal_cpu=True,
        cpu_wait_s=time.perf_counter() - t0, hand_kernel_launches=0,
        card=smi_name_and_power())


# -- phase 23: hkust_frontend -------------------------------------------------

# hkust_synth at its default (medium) preset's widths: 1000 words, 24
# training speakers, a BLSTM of 160 cells a direction in 3 layers on 48
# MFCC + pitch inputs.  Depth cut for the script's time (PERF.md §4): the
# newbob iterations (80 in the preset), the decoded test utterances (100)
# and the training utterances (500); 4 decodes and 1 iteration since
# phase 25 (6 decodes took 28.4 s of a proof run's 102.5, an iteration
# 12.7 s), 2 decodes since phase 26 (4 took 22.6-32.8 s).
HKUST = dict(max_iters=1, num_decode=2, num_train=160)
HKUST_FEAT_UTTS = 16     # training utterances' features, card vs CPU
HKUST_WAVES = 4          # corpus waves for the front-end and CLI checks
HKUST_SPLIT_REPS = 3
PITCH_TOL = dict(nccf=1e-5, score_rtol=1e-5, pov=1e-5, logp=1e-6)


def log_spectra_close(card, cpu) -> bool:
    """Spectrogram rows [log energy, log power bins] card against CPU: the
    energy within 1e-4, each bin within 1e-4 plus twice the float32 FFT's
    error bound in the log domain, 2 eps log2(nfft) sqrt(the frame's
    power / the bin's), as the CPU tests hold it against JAX."""
    power = np.exp(cpu[:, 1:].astype(np.float64))
    allowed = 1e-4 + 1e-4 * np.abs(cpu)
    allowed[:, 1:] += 4 * float(np.finfo(np.float32).eps) * np.log2(
        2 * (cpu.shape[1] - 1)) * np.sqrt(power.sum(1, keepdims=True) / power)
    return bool((np.abs(card - cpu) <= allowed).all())


def pitch_path_check(card, cpu, local, cost, lags, samp_freq):
    """The pitch contract, card against CPU on one utterance: the lag
    path equal on every frame, or where a frame differs both paths' total
    scores under the CPU's local grid within 1e-5 relative; POV within
    1e-5 and log-pitch within 1e-6 on equal frames.  Returns the frames
    that differ."""
    table = np.log(samp_freq / lags.astype(np.float64))

    def path(f):
        return np.abs(f[:, 1:2].astype(np.float64) - table[None]).argmin(1)
    got, want = path(card), path(cpu)
    differ = got != want
    if differ.any():
        loc, c = np.asarray(local, np.float64), np.asarray(cost, np.float64)

        def score(p):
            return loc[np.arange(len(p)), p].sum() - c[p[:-1], p[1:]].sum()
        if abs(score(got) - score(want)) > PITCH_TOL["score_rtol"] * abs(
                score(want)):
            raise RuntimeError(f"pitch paths part: {int(differ.sum())} "
                               f"frames, scores {score(got)} {score(want)}")
    eq = ~differ
    err = (float(np.abs(card[eq, 0] - cpu[eq, 0]).max(initial=0.0)),
           float(np.abs(card[eq, 1] - cpu[eq, 1]).max(initial=0.0)))
    if err[0] > PITCH_TOL["pov"] or err[1] > PITCH_TOL["logp"]:
        raise RuntimeError(f"pitch POV / log-pitch card vs CPU {err}")
    return int(differ.sum()), err


def hkust_frontend_check(waves, workdir):
    """The front end's modules on the card against the CPU on a few
    corpus waves (8 kHz): compute_pitch_batched (the path contract),
    Plp, Spectrogram, FeaturePipeline (fbank, MFCC) and
    sliding_window_cmn; each card call timed beside the CPU's, and the
    lag-Viterbi's frames and the batched call's launches."""
    from kaldi_aslp_tpu_torch.feats import pitch as tp
    from kaldi_aslp_tpu_torch.feats.functions import (
        SlidingWindowCmnOptions,
        acc_cmvn_stats,
        sliding_window_cmn,
    )
    from kaldi_aslp_tpu_torch.feats.pipeline import (
        FeaturePipeline,
        FeaturePipelineOptions,
    )
    from kaldi_aslp_tpu_torch.feats.plp import Plp, Spectrogram
    from kaldi_aslp_tpu_torch.feats.window import FrameExtractionOptions

    sr = 8000.0
    opts = tp.PitchOptions(samp_freq=sr)
    g = tp._Geometry(opts)
    out, seconds = {}, {}

    def timed(name, fn):
        for dev in ("cuda", "cpu"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name, dev] = fn(dev)
            torch.cuda.synchronize()
            seconds[f"{name}_{dev}_s"] = time.perf_counter() - t0

    frames0 = tp.lag_viterbi.frames
    timed("pitch", lambda d: {u: f.cpu().numpy() for u, f in
                              tp.compute_pitch_batched(waves, opts,
                                                       device=d).items()})
    viterbi_frames = (tp.lag_viterbi.frames - frames0) // 2
    cost = opts.penalty_factor * np.asarray(
        (g.log_lags[:, None] - g.log_lags[None]) ** 2, np.float32)
    differ, pitch_err = {}, [0.0, 0.0]
    for u, w in waves.items():
        n = -(-len(w) // int(sr)) * int(sr)
        arr = np.zeros((1, n), np.float32)
        arr[0, :len(w)] = w
        local = tp._local_score(tp.batched_nccf(
            torch.from_numpy(arr), torch.tensor([float(len(w))]), opts),
            g, opts)[0].numpy()
        T = len(out["pitch", "cpu"][u])
        differ[u], err = pitch_path_check(
            out["pitch", "cuda"][u], out["pitch", "cpu"][u], local[:T], cost,
            g.lags, sr)
        pitch_err = [max(a, b) for a, b in zip(pitch_err, err)]
    frame = FrameExtractionOptions(samp_freq=sr, dither=0.0)
    errs = {}
    timed("plp", lambda d: [Plp(frame, device=d)(w) for w in waves.values()])
    timed("spectrogram", lambda d: [Spectrogram(frame, device=d)(w).cpu()
                                    .numpy() for w in waves.values()])
    for kind in ("fbank", "mfcc"):
        popts = FeaturePipelineOptions(feature_type=kind, samp_freq=sr,
                                       num_bins=23, delta_order=2,
                                       splice_left=2, splice_right=2)

        def pipe(d):
            p = FeaturePipeline(popts, device=d)
            base = {u: p.compute_base(w) for u, w in waves.items()}
            return [p.post_process(base[u], acc_cmvn_stats(base[u]))
                    .cpu().numpy() for u in waves]
        timed(f"pipeline_{kind}", pipe)
    feats = [f for f in out["pipeline_mfcc", "cpu"]]
    cmn_opts = SlidingWindowCmnOptions(cmn_window=100, min_window=20,
                                       normalize_variance=True)
    timed("sliding_cmn", lambda d: [sliding_window_cmn(
        torch.from_numpy(f).to(d), cmn_opts).cpu().numpy() for f in feats])
    for name in ("plp", "pipeline_fbank", "pipeline_mfcc", "sliding_cmn"):
        for a, b in zip(out[name, "cuda"], out[name, "cpu"]):
            if not np.allclose(a, b, **RECIPE_FEAT_TOL):
                raise RuntimeError(f"{name} card vs CPU "
                                   f"{np.abs(a - b).max()}")
        errs[name] = max(float(np.abs(a - b).max()) for a, b in
                         zip(out[name, "cuda"], out[name, "cpu"]))
    for a, b in zip(out["spectrogram", "cuda"], out["spectrogram", "cpu"]):
        if not log_spectra_close(a, b):
            raise RuntimeError("spectrogram card vs CPU "
                               f"{np.abs(a - b).max()}")
    errs["spectrogram"] = max(float(np.abs(a - b).max()) for a, b in
                              zip(out["spectrogram", "cuda"],
                                  out["spectrogram", "cpu"]))
    # one batched pitch call's launches on the card
    counts = {}
    device_ms = sum(device_ms_by_kernel(
        lambda: tp.compute_pitch_batched(waves, opts, device="cuda"),
        counts).values())
    return dict(pitch_frames_differ=differ, pitch_max_err=pitch_err,
                pitch_viterbi_frames=viterbi_frames,
                pitch_call_launches=sum(c for k, c in counts.items()
                                        if not k.startswith("Mem")),
                pitch_call_device_ms=device_ms, max_abs_err=errs,
                seconds=seconds)


def hkust_cli_check(waves, workdir):
    """The feature CLI on a wav.scp of corpus waves, on the card and with
    --device=cpu: compute-mfcc-feats -> compute-cmvn-stats -> apply-cmvn ->
    add-deltas -> splice-feats -> feat-to-dim, compute-fbank-feats,
    copy-feats, compute-kaldi-pitch-feats (the pitch contract on its raw
    output, the post-processed output within 1e-4 where no path parts)
    and aslp-compute-spectrum-feats.  Each card tool reads the CPU
    chain's input and its table is held against the CPU tool's: within
    1e-4 (the MFCCs before liftering; the CMVN stats 1e-5 relative), the
    copies equal, the spectrogram as the CPU tests hold it."""
    from kaldi_aslp_tpu_torch.cli.__main__ import main as cli
    from kaldi_aslp_tpu_torch.feats import pitch as tp
    from kaldi_aslp_tpu_torch.feats.mfcc import lifter_coeffs
    from kaldi_aslp_tpu_torch.io import (
        WaveData,
        sequential_matrix_reader,
        write_wave,
    )

    d = os.path.join(workdir, "hkust_cli")
    os.makedirs(d)
    scp = os.path.join(d, "wav.scp")
    with open(scp, "w") as f:
        for u, w in waves.items():
            write_wave(os.path.join(d, f"{u}.wav"), WaveData(8000.0, w[None]))
            f.write(f"{u} {os.path.join(d, u + '.wav')}\n")
    sr = "--sample-frequency=8000"
    chain = [("mfcc", ["compute-mfcc-feats", sr, f"scp:{scp}"]),
             ("fbank", ["compute-fbank-feats", sr, f"scp:{scp}"]),
             ("stats", ["compute-cmvn-stats", "ark:{mfcc}"]),
             ("cmvn", ["apply-cmvn", "--norm-vars=true", "ark:{stats}",
                       "ark:{mfcc}"]),
             ("deltas", ["add-deltas", "ark:{cmvn}"]),
             ("splice", ["splice-feats", "ark:{deltas}"]),
             ("copy", ["copy-feats", "ark:{splice}"]),
             ("pitch_raw", ["compute-kaldi-pitch-feats",
                            "--post-process=false", f"scp:{scp}"]),
             ("pitch", ["compute-kaldi-pitch-feats", f"scp:{scp}"]),
             ("spectrum", ["aslp-compute-spectrum-feats", f"scp:{scp}"])]
    tables, seconds, inputs = {}, {}, {}
    for dev in ("cpu", "cuda"):
        paths = {}
        t0 = time.perf_counter()
        for name, argv in chain:
            paths[name] = os.path.join(d, f"{name}_{dev}.ark")
            # each card tool reads the CPU chain's input, as the CPU tool
            args = [a.format(**(inputs or paths)) for a in argv[1:]]
            if cli([argv[0], f"--device={dev}", *args,
                    f"ark:{paths[name]}"]) != 0:
                raise RuntimeError(f"{argv[0]} --device={dev} failed")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli(["feat-to-dim", f"--device={dev}",
                 f"ark:{(inputs or paths)['splice']}"])
        seconds[dev] = time.perf_counter() - t0
        tables[dev] = {n: dict(sequential_matrix_reader(f"ark:{p}"))
                       for n, p in paths.items()}
        tables[dev]["dim"] = int(buf.getvalue().split()[0])
        inputs = dict(paths)
    card, cpu = tables["cuda"], tables["cpu"]
    if card["dim"] != cpu["dim"] or card["dim"] != 13 * 3 * 9:
        raise RuntimeError(f"feat-to-dim {card['dim']} {cpu['dim']}")
    errs, differ = {}, {}
    opts = tp.PitchOptions(samp_freq=8000.0)
    g = tp._Geometry(opts)
    ll = g.log_lags.astype(np.float32)
    cost = np.float32(opts.penalty_factor) * (ll[:, None] - ll[None]) ** 2
    for u, w in waves.items():
        local = tp._local_score(tp.nccf_grid(torch.from_numpy(w), opts)[0],
                                g, opts).numpy()
        differ[u], _ = pitch_path_check(card["pitch_raw"][u],
                                        cpu["pitch_raw"][u], local, cost,
                                        g.lags, 8000.0)
    # the cepstra before liftering (the lifter multiplies c11, c12 by
    # about 12; a quiet frame's float32 log-mel rounding moved c12 by
    # 2.1e-4 in a first card call)
    lifter = lifter_coeffs(22.0, 13)
    for name in ("mfcc", "fbank", "stats", "cmvn", "deltas", "splice",
                 "copy", "pitch", "spectrum"):
        if name == "pitch" and any(differ.values()):
            continue
        for u in cpu[name]:
            a, b = card[name][u], cpu[name][u]
            if name == "spectrum":
                ok = log_spectra_close(a, b)
            elif name in ("splice", "copy"):
                ok = np.array_equal(a, b)
            else:
                if name == "mfcc":
                    a, b = a / lifter, b / lifter
                ok = a.shape == b.shape and np.allclose(
                    a, b, rtol=1e-5 if name == "stats" else 1e-4,
                    atol=0.0 if name == "stats" else 1e-4)
            if not ok:
                raise RuntimeError(f"{name} {u}: card vs CPU "
                                   f"{np.abs(a - b).max()}")
        errs[name] = max(float(np.abs(card[name][u] - cpu[name][u]).max())
                         for u in cpu[name])
    return dict(tools=[c[1][0] for c in chain] + ["feat-to-dim"],
                utts=len(waves), dim=card["dim"], max_abs_err=errs,
                pitch_frames_differ=differ, card_s=seconds["cuda"],
                cpu_s=seconds["cpu"])


def hkust_step_process():
    """The process hkust_step_split takes its step in, started before the
    recipe's run."""
    return subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; "
         "chip_smoke.hkust_step_child()"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))


def hkust_step_child():
    """In a fresh process: the CTC pair's library and the profiler made
    ready, then one training step of the recipe's BLSTM (stock torch ops)
    on the job's batch, by part with CUDA events, its kernel launches and
    device busy share by torch.profiler, printed as one JSON line."""
    from torch.profiler import ProfilerActivity, profile

    from kaldi_aslp_tpu_torch.models.losses import ctc_batch_loss
    from kaldi_aslp_tpu_torch.ops import ctc_recursions
    from kaldi_aslp_tpu_torch.recipes.ctc import CtcRecipe, CtcRecipeOptions
    from kaldi_aslp_tpu_torch.train import (
        CtcTrainer,
        NnetTrainOptions,
        init_velocity,
    )
    from kaldi_aslp_tpu_torch.train.trainer import upload

    ctc_recursions.build()
    ones = torch.ones(64, 64, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        ones.matmul(ones)
        torch.cuda.synchronize()
    spec = torch.load(sys.stdin.readline().strip(), weights_only=False)
    rec = CtcRecipe.__new__(CtcRecipe)
    rec.opts = CtcRecipeOptions(**spec["opts"])
    net = rec._build_net(spec["dim"], spec["V"])
    net.load_state_dict(spec["state"])
    net.to("cuda")
    trainer = CtcTrainer(net, NnetTrainOptions(momentum=0.9))
    batch, lr = spec["batch"], spec["lr"]
    feats, labels, in_lens, lab_lens, mask = dev_batch = upload(
        batch, trainer.device)
    velocity = init_velocity(net)
    trainer.step(velocity, dev_batch, lr)
    torch.cuda.synchronize()
    splits = []
    for _ in range(HKUST_SPLIT_REPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        for p in net.parameters():
            p.grad = None
        net.train()
        t0 = time.perf_counter()
        ev[0].record()
        y, _ = net(feats, mask=mask)
        ev[1].record()
        loss, _ = ctc_batch_loss(y, labels, in_lens, lab_lens)
        ev[2].record()
        loss.backward()
        ev[3].record()
        trainer._update(velocity, lr)
        ev[4].record()
        torch.cuda.synchronize()
        splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
                      + [1e3 * (time.perf_counter() - t0)])
    med = np.median(np.asarray(splits), axis=0)
    for attempt in range(1, 4):
        counts = {}
        by_kernel = device_ms_by_kernel(
            lambda: trainer.step(velocity, dev_batch, lr), counts)
        if any("ctc_warp_kernel" in k for k in counts):
            break
    else:
        raise RuntimeError("the hkust step's profile holds no CTC pair")
    kernels = {k: c for k, c in counts.items()
               if not k.startswith(("Memcpy", "Memset"))}
    device_ms = sum(v for k, v in by_kernel.items() if k in kernels)
    S, T, D = batch.feats.shape
    print(json.dumps(dict(
        S=S, T=T, D=D, U=int(batch.labels.shape[1]),
        forward_ms=float(med[0]), loss_ms=float(med[1]),
        backward_ms=float(med[2]), update_ms=float(med[3]),
        step_ms=float(med[:4].sum()), host_step_ms=float(med[4]),
        kernel_launches_per_step=sum(kernels.values()),
        device_busy_ms=device_ms,
        device_busy_share=device_ms / float(med[:4].sum()),
        profiles_taken=attempt,
        top_kernels={k[:72]: c for k, c in sorted(
            kernels.items(), key=lambda kv: -kv[1])[:6]},
        reps=HKUST_SPLIT_REPS)), flush=True)


def hkust_step_send(rec, batch, workdir, child):
    """Hand ``child`` its job: one training step of the recipe's net at
    its first batch, from the recipe's initial parameters (a step of
    stock ops does the same work whatever their values)."""
    job = os.path.join(workdir, "hkust_step.pt")
    net = rec._build_net(int(batch.feats.shape[2]), rec.num_outputs)
    rec._init_params(net)
    torch.save(dict(state=net.state_dict(), batch=batch,
                    lr=rec.opts.learn_rate,
                    opts=dataclasses.asdict(rec.opts),
                    dim=int(batch.feats.shape[2]), V=rec.num_outputs), job)
    child.stdin.write(job + "\n")
    child.stdin.flush()
    return time.perf_counter()


def hkust_step_split(child, sent):
    """The step's parts, launches and busy share from ``child``."""
    stdout, stderr = child.communicate(timeout=300)
    if child.returncode != 0:
        raise RuntimeError(f"hkust step process failed: {stderr[-2000:]}")
    out = json.loads(stdout.strip().splitlines()[-1])
    log("hkust_step_split", **out, process_s=time.perf_counter() - sent)
    return out


def hkust_step_check(rec, batch):
    """One training step on the whole first batch on the card and on the
    CPU from the same parameters: the loss within 1e-4 relative and each
    gradient within 1e-3 of its tensor's largest magnitude (PERF.md §2's
    float32 BPTT rows)."""
    from kaldi_aslp_tpu_torch.models.losses import ctc_batch_loss
    from kaldi_aslp_tpu_torch.train.trainer import upload

    out, seconds = {}, {}
    for device in ("cuda", "cpu"):
        dev = torch.device(device)
        net = rec._build_net(batch.feats.shape[2], rec.num_outputs).to(dev)
        net.load_state_dict(rec.best_params)
        net.train()
        t0 = time.perf_counter()
        feats, labels, in_lens, lab_lens, mask = upload(batch, dev)
        y, _ = net(feats, mask=mask)
        loss, _ = ctc_batch_loss(y, labels, in_lens, lab_lens)
        loss.backward()
        if device == "cuda":
            torch.cuda.synchronize()
        seconds[device] = time.perf_counter() - t0
        out[device] = (float(loss.detach()), {
            n: p.grad.cpu() for n, p in net.named_parameters()})
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    grad_rel = {n: rel_err(g, out["cpu"][1][n])
                for n, g in out["cuda"][1].items()}
    worst = max(grad_rel, key=grad_rel.get)
    if loss_rel > RECIPE_LOSS_RTOL or grad_rel[worst] > RECIPE_GRAD_RTOL:
        raise RuntimeError(f"hkust step card vs CPU: loss {loss_rel}, "
                           f"{worst} {grad_rel[worst]}")
    return dict(S=int(batch.feats.shape[0]), T=int(batch.feats.shape[1]),
                U=int(batch.labels.shape[1]), loss_cuda=out["cuda"][0],
                loss_cpu=out["cpu"][0], loss_rel=loss_rel, worst_grad=worst,
                worst_grad_rel=grad_rel[worst], card_step_s=seconds["cuda"],
                cpu_step_s=seconds["cpu"],
                tol={"loss": RECIPE_LOSS_RTOL, "grad": RECIPE_GRAD_RTOL})


def hkust_phase(workdir):
    """(a) hkust_synth's run() on the card at the medium preset's widths
    (HKUST's cuts), its launches counted from 0 just before it and read
    just after: the CTC pair once a loss evaluation, no other hand kernel
    and no wide kernel; its corpus, feature, pitch, training, decode and
    total seconds, its units and TLG; (b) the first HKUST_FEAT_UTTS
    training utterances' MFCC + pitch features, one step on the whole
    first batch and the front end's modules, card against CPU; (c) the
    feature CLI on the card against --device=cpu; and one step by part in
    a fresh process, its job handed over while the run builds its TLG on
    the host (the card is idle then).  Returns the training kernels'
    launches in the run, by name."""
    from kaldi_aslp_tpu_torch.feats import pitch as tp
    from kaldi_aslp_tpu_torch.recipes import ctc as ctc_recipe
    from kaldi_aslp_tpu_torch.recipes import hard_corpus as hc
    from kaldi_aslp_tpu_torch.recipes import hkust_synth as hk

    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
        if hasattr(w, "per_step"):
            w.per_step = 0
    wrappers["ctc_alpha_beta"].wide = 0
    seconds = {"corpus": 0.0, "features": 0.0, "pitch": 0.0, "tlg": 0.0,
               "units_and_g": 0.0}
    captured = {}
    inner = {"extract": hc.extract_mfcc_deltas_cmvn,
             "pitch": hc.compute_pitch_batched,
             "tlg": ctc_recipe.make_ctc_decode_graph,
             "corpus": hk.build_hkust_corpus,
             "units": hk.prepare_syllable_units, "g": hk.arpa_to_fst}

    def extract(waves, utt2spk, *a, **k):
        captured.setdefault("waves", {}).update(waves)
        captured.setdefault("utt2spk", {}).update(utt2spk)
        t0 = time.perf_counter()
        out = inner["extract"](waves, utt2spk, *a, **k)
        seconds["features"] += time.perf_counter() - t0
        return out

    def pitch(*a, **k):
        t0 = time.perf_counter()
        out = inner["pitch"](*a, **k)
        torch.cuda.synchronize()
        seconds["pitch"] += time.perf_counter() - t0
        return out

    def timer(name, key):
        def fn(*a, **k):
            t0 = time.perf_counter()
            out = inner[name](*a, **k)
            seconds[key] += time.perf_counter() - t0
            return out
        return fn

    def batches(rec, *a, **k):
        captured["rec"] = rec
        captured["batches"] = inner["batches"](rec, *a, **k)
        return captured["batches"]

    def tlg(*a, **k):
        # the TLG is host work: the step's process takes the card now
        captured["sent"] = hkust_step_send(
            captured["rec"], captured["batches"][0][0], workdir, child)
        return timer("tlg", "tlg")(*a, **k)

    child = hkust_step_process()
    inner["batches"] = ctc_recipe.CtcRecipe.batches
    ctc_recipe.CtcRecipe.batches = batches
    hc.extract_mfcc_deltas_cmvn, hc.compute_pitch_batched = extract, pitch
    ctc_recipe.make_ctc_decode_graph = tlg
    hk.build_hkust_corpus = timer("corpus", "corpus")
    hk.prepare_syllable_units = timer("units", "units_and_g")
    hk.arpa_to_fst = timer("g", "units_and_g")
    frames0 = tp.lag_viterbi.frames
    try:
        t0 = time.perf_counter()
        out = hk.run(os.path.join(workdir, "hkust"), "medium", device="cuda",
                     **HKUST)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {n: w.launches for n, w in wrappers.items()}
        counters = {f"{n}.per_step": w.per_step for n, w in wrappers.items()
                    if hasattr(w, "per_step")}
        counters["ctc_alpha_beta.wide"] = wrappers["ctc_alpha_beta"].wide
    finally:
        hc.extract_mfcc_deltas_cmvn = inner["extract"]
        hc.compute_pitch_batched = inner["pitch"]
        ctc_recipe.make_ctc_decode_graph = inner["tlg"]
        ctc_recipe.CtcRecipe.batches = inner["batches"]
        hk.build_hkust_corpus = inner["corpus"]
        hk.prepare_syllable_units, hk.arpa_to_fst = inner["units"], inner["g"]
    try:
        return hkust_run_and_check(out, run_s, launches, counters, seconds,
                                   captured, tp.lag_viterbi.frames - frames0,
                                   workdir, child)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()


def hkust_run_and_check(out, run_s, launches, counters, seconds, captured,
                        viterbi_frames, workdir, child):
    """hkust_phase's checks of the run, then (b), (c) and the step."""
    from kaldi_aslp_tpu_torch.recipes import hard_corpus as hc
    from kaldi_aslp_tpu_torch.recipes import hkust_synth as hk

    art = hk.run.artifacts
    rec, corpus = art["recipe"], art["corpus"]
    tr_batches, cv_batches = rec.batches(corpus["train_feats"],
                                         corpus["train_texts"])
    epochs = rec.epochs
    steps, evals = (len(epochs) * len(b) for b in (tr_batches, cv_batches))
    stray = {n: k for n, k in launches.items()
             if k and n != "ctc_alpha_beta"}
    if launches["ctc_alpha_beta"] != steps + evals or stray or any(
            counters.values()):
        raise RuntimeError(f"hkust launches {launches}, want "
                           f"{steps + evals} CTC pair; per-step or wide "
                           f"{counters}")
    if not np.isfinite(out["ctc"]) or not all(
            np.isfinite(e["cv_loss"]) for e in epochs):
        raise RuntimeError(f"hkust run not finite: {out}")
    dims = {f.shape[1] for f in corpus["train_feats"].values()}
    if dims != {48}:
        raise RuntimeError(f"hkust features of dims {dims}, want 48")
    train_s = sum(e["seconds"] for e in epochs)
    for e in epochs:
        log("hkust_epoch", **e)
    log("hkust", wer=out["ctc"], greedy_ser=out["greedy_ser"],
        units=len(art["units"].syllable_ids),
        raw_syllables=len(art["units"].syllable_table),
        tone_bound=art["n_bound"], words=len(corpus["words"]),
        train_utts=len(corpus["train_feats"]),
        test_utts=len(corpus["test_feats"]), decoded_utts=len(art["test_utts"]),
        train_audio_s=corpus["train_audio_s"], feat_dim=48,
        tlg=[rec.tlg.num_states, rec.tlg.num_arcs],
        model=dict(type="blstm", hidden=rec.opts.hidden_dim,
                   layers=rec.opts.num_layers, lfr=rec.opts.lfr_skip,
                   outputs=rec.num_outputs),
        epochs=len(epochs), train_batches=len(tr_batches),
        cv_batches=len(cv_batches), ctc_pair_launches=steps + evals,
        launches={n: k for n, k in launches.items() if k},
        corpus_s=seconds["corpus"],
        synthesis_s=seconds["corpus"] - seconds["features"],
        features_s=seconds["features"], pitch_s=seconds["pitch"],
        pitch_viterbi_frames=viterbi_frames,
        units_and_g_s=seconds["units_and_g"], train_s=train_s,
        tlg_s=seconds["tlg"],
        decode_s=run_s - seconds["corpus"] - seconds["units_and_g"]
        - train_s - seconds["tlg"],
        run_s=run_s, cuts=HKUST, card=smi_name_and_power())
    # (b) the first training utterances' features, card vs CPU
    utts = sorted(u for u in captured["waves"] if u.startswith("tr"))[
        :HKUST_FEAT_UTTS]
    waves = {u: captured["waves"][u] for u in utts}
    u2s = {u: captured["utt2spk"][u] for u in utts}
    feats = {d: hc.extract_mfcc_deltas_cmvn(waves, u2s, use_pitch=True,
                                            device=d) for d in ("cuda", "cpu")}
    feat_err = max(float(np.abs(feats["cuda"][u] - feats["cpu"][u]).max())
                   for u in utts)
    for u in utts:
        if not np.allclose(feats["cuda"][u], feats["cpu"][u],
                           **RECIPE_FEAT_TOL):
            raise RuntimeError(f"hkust features {u} card vs CPU {feat_err}")
    step = hkust_step_check(rec, tr_batches[0])
    few = {u: waves[u] for u in utts[:HKUST_WAVES]}
    frontend = hkust_frontend_check(few, workdir)
    cli = hkust_cli_check(few, workdir)
    log("hkust_check", feature_utts=len(utts), feature_max_abs_err=feat_err,
        feature_tol=RECIPE_FEAT_TOL, step=step, frontend=frontend, cli=cli,
        pitch_tol=PITCH_TOL)
    hkust_step_split(child, captured["sent"])
    return {n: launches[n] for n in train_kernel_wrappers()}


# -- phase 24: the nnet zoo ----------------------------------------------------

LC_CHUNK = 64            # kaldi_aslp_tpu/models/recurrent.py:541-543
# the sequence reader's defaults (reference: data-reader.h:58-60)
LC_STREAMS, LC_FRAMES = 100, 20
LC_UTTS = 64             # of 224-400 frames: about 20 steps at 100 x 20
LC_ARGS = [f"--num-streams={LC_STREAMS}", f"--batch-size={LC_FRAMES}",
           "--targets-delay=5", "--momentum=0.9"]
LC_FORWARD_UTTS = 4      # of 200-400 frames through the forward CLI
LC_LL_ATOL = 1e-4        # log-likelihoods, card vs --device=cpu
LC_SPLIT_REPS = 5
ZOO_TOL = 1e-4           # the zoo net's outputs and gradients, card vs CPU
ZOO_MIMO_BATCH = 256     # the MIMO trainer's minibatch: 2 steps
ZOO_STREAMS, ZOO_FRAMES = 8, 64


def lc_proto() -> str:
    """The LC-BLSTM hybrid: the flagship's BLSTMP stack (3 layers, C=512,
    P=320 a direction, 40 inputs) with the latency-controlled layer, then
    the LSTM hybrid's 3019-pdf output layer, float32."""
    lines, din = ["<NnetProto>"], FEAT_DIM
    for _ in range(LAYERS):
        lines.append(f"<BLstmProjectedStreamsLC> <InputDim> {din} "
                     f"<OutputDim> {2 * P} <CellDim> {C} "
                     f"<ChunkSize> {LC_CHUNK}")
        din = 2 * P
    lines.append(f"<AffineTransform> <InputDim> {din} <OutputDim> "
                 f"{HYBRID_PDFS} <ParamStddev> 0.04 <BiasMean> 0.0 "
                 "<BiasRange> 0.0")
    return "\n".join(lines + ["</NnetProto>"]) + "\n"


def write_lc_files(workdir: str):
    """The LC proto and a corpus of LC_UTTS utterances whose frame targets
    are one of 32 pdfs, picked by the argmax of a fixed projection of the
    frame (write_bptt_files's), plus LC_FORWARD_UTTS test utterances."""
    from kaldi_aslp_tpu_torch.io import int_vector_writer, matrix_writer

    rs = np.random.RandomState(1357)
    proto = f"{workdir}/lc.proto"
    with open(proto, "w") as f:
        f.write(lc_proto())
    proj = rs.randn(FEAT_DIM, 32)
    pdfs = rs.choice(HYBRID_PDFS, 32, replace=False).astype(np.int32)
    with matrix_writer(f"ark,scp:{workdir}/lc_feats.ark,"
                       f"{workdir}/lc_feats.scp") as fw, \
            int_vector_writer(f"ark:{workdir}/lc_ali.ark") as tw:
        for i in range(LC_UTTS):
            feats = rs.randn(rs.randint(224, 401), FEAT_DIM).astype(
                np.float32)
            fw[f"utt{i:02d}"] = feats
            tw[f"utt{i:02d}"] = pdfs[np.argmax(feats @ proj, axis=1)]
    with matrix_writer(f"ark:{workdir}/lc_test.ark") as fw:
        for i in range(LC_FORWARD_UTTS):
            fw[f"test{i}"] = rs.randn(rs.randint(200, 401), FEAT_DIM).astype(
                np.float32)
    return (proto, f"scp:{workdir}/lc_feats.scp", f"ark:{workdir}/lc_ali.ark",
            f"ark:{workdir}/lc_test.ark")


def lc_train_run(model, feats, targets, out):
    """aslp-nnet-train-blstm-streams-lc on the card, its launches counted
    from 0 just before it and read just after, and each step's."""
    from kaldi_aslp_tpu_torch.train.trainer import LstmStreamsTrainer

    wrappers = bptt_counts()
    want = {"lstmp_train_fwd": 2 * LAYERS, "lstmp_train_bwd": 2 * LAYERS,
            "lstmp_forward": 0}
    steps = []
    inner_step = LstmStreamsTrainer.step

    def step(self, velocity, states, chunk, learn_rate):
        before = {n: w.launches for n, w in wrappers.items()}
        t0 = time.perf_counter()
        states, loss, aux = inner_step(self, velocity, states, chunk,
                                       learn_rate)
        loss = float(loss)   # syncs the card
        steps.append({"loss": loss, "s": time.perf_counter() - t0,
                      "launches": {n: w.launches - before[n]
                                   for n, w in wrappers.items()}})
        return states, torch.tensor(loss), aux

    LstmStreamsTrainer.step = step
    try:
        for w in wrappers.values():
            w.launches = w.per_step = 0
        t0 = time.perf_counter()
        rc, printed = run_cli(["aslp-nnet-train-blstm-streams-lc",
                               "--device=cuda", *LC_ARGS, feats, targets,
                               model, out])
        seconds = time.perf_counter() - t0
        launches = {n: w.launches for n, w in wrappers.items()}
        per_step = {n: w.per_step for n, w in wrappers.items()}
    finally:
        LstmStreamsTrainer.step = inner_step
    losses = [st["loss"] for st in steps]
    if rc != 0 or len(steps) < 8 or "FRAME_ACCURACY" not in printed:
        raise RuntimeError(f"LC trainer exit {rc}, {len(steps)} steps")
    for st in steps:
        if st["launches"] != want:
            raise RuntimeError(f"an LC step launched {st['launches']}, "
                               f"want {want}")
    if any(per_step.values()):
        raise RuntimeError(f"the LC run took the per-step kernels: "
                           f"{per_step}")
    q = max(len(losses) // 4, 1)
    first, last = float(np.mean(losses[:q])), float(np.mean(losses[-q:]))
    if not np.isfinite(losses).all() or not last < first:
        raise RuntimeError(f"the LC loss did not fall: {losses}")
    return {"steps": len(steps), "losses": losses, "seconds": seconds,
            "step_s": [st["s"] for st in steps], "launches": launches,
            "first_quarter_loss": first, "last_quarter_loss": last}


def lc_train_check(model, feats, targets):
    """One LC step's loss and parameter gradients on the card against the
    CPU's plain versions, on the reader's first chunk at the tool's
    LC_STREAMS x LC_FRAMES (the backward direction's kernels at
    S = LC_STREAMS x n_chunks), from a nonzero carried state."""
    from kaldi_aslp_tpu_torch.cli.train_tools import frame_source
    from kaldi_aslp_tpu_torch.data.sequence import (
        SequenceDataReader,
        SequenceReaderOptions,
    )
    from kaldi_aslp_tpu_torch.models import Nnet
    from kaldi_aslp_tpu_torch.models.losses import xent_loss
    from kaldi_aslp_tpu_torch.train.trainer import upload_chunk

    chunk = next(iter(SequenceDataReader(
        frame_source(feats, targets),
        SequenceReaderOptions(num_streams=LC_STREAMS,
                              batch_size=LC_FRAMES))))
    rs = np.random.RandomState(5)
    carried = {str(i): {"fwd": {
        "c": uniform(rs, LC_STREAMS, C, scale=0.5),
        "r": uniform(rs, LC_STREAMS, P, scale=0.5)}}
        for i in range(LAYERS)}
    out = {}
    for device in ("cuda", "cpu"):
        dev = torch.device(device)
        net, _ = Nnet.load(model, dev)
        x, tgt, mask, _ = upload_chunk(chunk, dev)
        states = {k: {"fwd": {kk: torch.from_numpy(vv).to(dev)
                              for kk, vv in v["fwd"].items()}}
                  for k, v in carried.items()}
        net.train()
        t0 = time.perf_counter()
        y, _ = net(x, states, mask=mask)
        loss, _ = xent_loss(y, tgt, mask)
        loss.backward()
        out[device] = (float(loss.detach()),
                       {n: p.grad.cpu() for n, p in net.named_parameters()},
                       time.perf_counter() - t0)
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    grad_rel = {n: rel_err(g, out["cpu"][1][n])
                for n, g in out["cuda"][1].items()}
    worst = max(grad_rel, key=grad_rel.get)
    result = dict(streams=LC_STREAMS,
                  frames=int(chunk.frame_mask.sum()),
                  loss_cuda=out["cuda"][0], loss_cpu=out["cpu"][0],
                  loss_rel=loss_rel, worst_grad=worst,
                  worst_grad_rel=grad_rel[worst], cpu_step_s=out["cpu"][2],
                  tol={"loss": BPTT_LOSS_RTOL, "grad": BPTT_GRAD_RTOL})
    if loss_rel > BPTT_LOSS_RTOL or grad_rel[worst] > BPTT_GRAD_RTOL:
        raise RuntimeError(f"LC step card vs CPU: {result}")
    return result


def lc_forward_run(model, test):
    """aslp-nnet-forward-blstm-lc with --device=cuda, each utterance's
    launches and ms, then the same tool with --device=cpu: the
    log-likelihoods within LC_LL_ATOL."""
    from kaldi_aslp_tpu_torch.decoder import decodable
    from kaldi_aslp_tpu_torch.io import sequential_matrix_reader
    from kaldi_aslp_tpu_torch.ops.lstmp import lstmp_forward

    calls = []
    inner = decodable.nnet_forward

    def timed(net, feats, opts=None, prior=None):
        before = lstmp_forward.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(net, feats, opts, prior)
        calls.append({"frames": len(feats),
                      "ms": 1e3 * (time.perf_counter() - t0),
                      "launches": lstmp_forward.launches - before})
        return out

    lls = {}
    for device in ("cuda", "cpu"):
        lstmp_forward.launches = lstmp_forward.per_step = 0
        decodable.nnet_forward = timed if device == "cuda" else inner
        try:
            ll = model.replace(".zip", f"_{device}.ark")
            t0 = time.perf_counter()
            rc, _ = run_cli(["aslp-nnet-forward-blstm-lc",
                             f"--device={device}", model, test, f"ark:{ll}"])
            seconds = time.perf_counter() - t0
        finally:
            decodable.nnet_forward = inner
        if rc != 0:
            raise RuntimeError(f"forward CLI --device={device}: exit {rc}")
        lls[device] = (dict(sequential_matrix_reader(f"ark:{ll}")), seconds)
        if device == "cuda":
            launches, per_step = lstmp_forward.launches, \
                lstmp_forward.per_step
    cuda, cpu = lls["cuda"][0], lls["cpu"][0]
    err = max(float(np.abs(cuda[u] - cpu[u]).max()) for u in cpu)
    result = dict(utterances=len(calls), frames=[c["frames"] for c in calls],
                  ms=[c["ms"] for c in calls],
                  ms_per_utterance=float(np.median([c["ms"] for c in
                                                    calls])),
                  launches_per_utterance=[c["launches"] for c in calls],
                  launches=launches, per_step=per_step, max_abs_err=err,
                  cuda_s=lls["cuda"][1], cpu_s=lls["cpu"][1],
                  finite=all(np.isfinite(v).all() for v in cuda.values()))
    if (len(calls) != LC_FORWARD_UTTS or sorted(cuda) != sorted(cpu)
            or any(c["launches"] != 2 * LAYERS for c in calls) or per_step
            or err > LC_LL_ATOL or not result["finite"]):
        raise RuntimeError(f"LC forward: {result}")
    return result


def zoo_step_process():
    """The process zoo_step_split takes its step in, started at the
    phase's start so that its imports are done when the job comes (late
    in this process the profiler dropped kernels, PERF.md section 6)."""
    return subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; "
         "chip_smoke.zoo_step_child()"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))


def zoo_step_child():
    """In a fresh process: one LC-BLSTM hybrid step at S=100, T=20 on the
    model named on standard input, by part with CUDA events, then its
    kernel launches and device busy share by torch.profiler (the profile
    must hold 6 forward and 6 backward LSTMP sweeps, else it is taken
    again, at most 3 times), then the padding's cost: at T = 20 below the
    chunk the backward direction sweeps 64 frames, 44 of them masked
    no-ops, and with every layer's chunk set to T the same outputs come
    without them (held equal here); printed as one JSON line."""
    from torch.profiler import ProfilerActivity, profile

    from kaldi_aslp_tpu_torch.models import BLstmProjectedStreamsLC, Nnet
    from kaldi_aslp_tpu_torch.models.losses import xent_loss
    from kaldi_aslp_tpu_torch.ops import lstmp_train
    from kaldi_aslp_tpu_torch.train import LstmStreamsTrainer, init_velocity
    from kaldi_aslp_tpu_torch.train.sgd import NnetTrainOptions

    lstmp_train.build()
    ones = torch.ones(64, 64, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        ones.matmul(ones)
        torch.cuda.synchronize()
    torch.backends.cuda.matmul.allow_tf32 = False
    model = sys.stdin.readline().strip()
    dev = torch.device("cuda")
    S, T = LC_STREAMS, LC_FRAMES
    rs = np.random.RandomState(0)
    feats = torch.from_numpy(rs.randn(S, T, FEAT_DIM).astype(np.float32)
                             ).to(dev)
    targets = torch.from_numpy(
        rs.randint(0, HYBRID_PDFS, (S, T)).astype(np.int64)).to(dev)
    mask = torch.ones((S, T), device=dev)
    flags = torch.zeros((S,), dtype=torch.int32, device=dev)
    net, _ = Nnet.load(model, dev)
    trainer = LstmStreamsTrainer(net, NnetTrainOptions(learn_rate=1e-4,
                                                       momentum=0.9))
    velocity = init_velocity(net)
    states = trainer.init_state(S)
    batch = (feats, targets, mask, flags)
    states, _, _ = trainer.step(velocity, states, batch, 1e-4)
    torch.cuda.synchronize()

    def split():
        """The step's parts (ms, median of LC_SPLIT_REPS) and its host
        ms, from the carried states; no update of the parameters' values
        between the two layouts' splits changes their shapes."""
        rows = []
        for _ in range(LC_SPLIT_REPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            for p in net.parameters():
                p.grad = None
            t0 = time.perf_counter()
            ev[0].record()
            y, _ = net(feats, states, mask=mask)
            ev[1].record()
            loss, _ = xent_loss(y, targets, mask)
            ev[2].record()
            loss.backward()
            ev[3].record()
            trainer._update(velocity, 1e-4)
            ev[4].record()
            torch.cuda.synchronize()
            rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
                        + [1e3 * (time.perf_counter() - t0)])
        return np.median(np.asarray(rows), axis=0)

    med = split()
    step_ms = float(med[:4].sum())
    want = {"lstmp_fwd_sweep_kernel": 2 * LAYERS,
            "lstmp_bwd_sweep_kernel": 2 * LAYERS}
    for taken in range(1, 4):
        counts = {}
        by_kernel = device_ms_by_kernel(
            lambda: trainer.step(velocity, states, batch, 1e-4), counts)
        seen = {w: sum(c for k, c in counts.items() if w in k)
                for w in want}
        if seen == want:
            break
    else:
        raise RuntimeError(f"the LC step's profile holds {seen} of the "
                           f"sweeps, want {want}")
    kernels = {k: c for k, c in counts.items()
               if not k.startswith(("Memcpy", "Memset"))}
    device_ms = sum(v for k, v in by_kernel.items() if k in kernels)
    sweep_ms = sum(v for k, v in by_kernel.items()
                   if any(w in k for w in want))

    layers = [c for c in net.nodes if isinstance(c, BLstmProjectedStreamsLC)]
    with torch.no_grad():
        padded, _ = net(feats, states, mask=mask)
        for comp in layers:
            comp.chunk_size = T
        unpadded, _ = net(feats, states, mask=mask)
    pad_err = float((padded - unpadded).abs().max())
    if pad_err > BPTT_EVAL_RTOL * float(padded.abs().max()):
        raise RuntimeError(f"chunk {T} parts from chunk {LC_CHUNK} at T = "
                           f"{T} by {pad_err}")
    med_unpadded = split()
    unpadded_ms = float(med_unpadded[:4].sum())
    print(json.dumps(dict(
        S=S, T=T, C=C, P=P, chunk=LC_CHUNK, pdfs=HYBRID_PDFS,
        forward_ms=float(med[0]), loss_ms=float(med[1]),
        backward_ms=float(med[2]), update_ms=float(med[3]),
        step_ms=step_ms, host_step_ms=float(med[4]),
        frames_per_s=S * T / (step_ms / 1e3),
        kernel_launches_per_step=sum(kernels.values()),
        device_busy_ms=device_ms, device_busy_share=device_ms / step_ms,
        sweep_device_ms=sweep_ms, profiles_taken=taken, sweeps=seen,
        top_kernels=dict(sorted(kernels.items(),
                                key=lambda kv: -kv[1])[:6]),
        unpadded_step_ms=unpadded_ms,
        unpadded_forward_ms=float(med_unpadded[0]),
        unpadded_backward_ms=float(med_unpadded[2]),
        padding_ms=step_ms - unpadded_ms,
        padding_share=(step_ms - unpadded_ms) / step_ms,
        unpadded_max_abs_diff=pad_err, reps=LC_SPLIT_REPS)), flush=True)


def zoo_net(retention: float = 0.8):
    """A two-input, two-output DAG of every new component besides the LC
    layer: a 40-wide fbank and a 3-wide pitch stream joined in a BN,
    spliced (-1..1) into a frequency CNN (8 patches of 8 bins every 5, 8
    filters), max-pooled, a projection, cFSMN and RowConvolution
    memories, CIFG and GRU branches added, shift, scale, Tanh, a Pnorm and
    a Maxout half spliced and copied back, LengthNorm, ReLU, Dropout,
    Transmit, Sigmoid, and two heads: a BlockSoftmax over 4:6 and a plain
    output of 7."""
    from kaldi_aslp_tpu_torch import models as M

    net = M.Nnet(num_inputs=2)
    # BN first: after a biased layer it would cancel that bias's gradient
    # to rounding noise, which no two summation orders agree on
    bn = net.add(M.BatchNormalization(43, 43), [("in:0", 0), ("in:1", 40)])
    sp = net.add(M.Splice(43, 129, build_vector="-1:1"), [(bn, 0)])
    cv = net.add(M.ConvolutionalComponent(
        129, 64, patch_dim=8, patch_step=5, patch_stride=43,
        param_stddev=0.05), [(sp, 0)])
    mp = net.add(M.MaxPoolingComponent(64, 32, pool_size=2, pool_step=2,
                                       pool_stride=8), [(cv, 0)])
    lin = net.add(M.LinearTransform(32, 64), [(mp, 0)])
    fs = net.add(M.CompactFsmn(64, 64, l_order=6, r_order=3, l_stride=2),
                 [(lin, 0)])
    rc = net.add(M.RowConvolution(64, 64, future_ctx=2), [(fs, 0)])
    cf = net.add(M.LstmCifgProjectedStreams(64, 48, cell_dim=96), [(rc, 0)])
    gr = net.add(M.GruStreams(64, 48), [(rc, 0)])
    sh = net.add(M.AddShift(48, 48), [(cf, 0), (gr, 0)])
    sc = net.add(M.Rescale(48, 48), [(sh, 0)])
    th = net.add(M.Tanh(48, 48), [(sc, 0)])
    pn = net.add(M.Pnorm(48, 24, p=2.0), [(th, 0)])
    mx = net.add(M.Maxout(48, 24), [(th, 0)])
    cp = net.add(M.CopyComponent(48, 48, build_vector="24:47 0:23"),
                 [(pn, 0), (mx, 24)])
    ln = net.add(M.LengthNorm(48, 48), [(cp, 0)])
    rl = net.add(M.ReLU(48, 48), [(ln, 0)])
    dr = net.add(M.Dropout(48, 48, dropout_retention=retention), [(rl, 0)])
    tr = net.add(M.Transmit(48, 48), [(dr, 0)])
    sg = net.add(M.Sigmoid(48, 48), [(tr, 0)])
    head = net.add(M.AffineTransform(48, 10), [(sg, 0)])
    net.add(M.BlockSoftmax(10, 10, block_dims="4:6"), [(head, 0)])
    net.add(M.AffineTransform(48, 7), [(tr, 0)])
    g = torch.Generator().manual_seed(24)
    net.reset_parameters(g)
    with torch.no_grad():
        # off the constant inits (shift 0, scale 1, gamma 1, beta 0)
        for p in net.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g))
    return net


def xent_heads(net):
    """``zoo_net``'s components with the BlockSoftmax head's logits as
    the first output, as a frame trainer's xent takes them."""
    from kaldi_aslp_tpu_torch.models import Nnet

    out = Nnet(num_inputs=2, output_ids=[len(net.nodes) - 3,
                                         len(net.nodes) - 1])
    for comp, edges in zip(net.nodes, net.node_inputs):
        out.add(comp, edges)
    return out


def zoo_check(workdir):
    """The zoo net's forward (eval and train) and backward on the card
    against the CPU, then 2 steps of aslp-nnet-train-frame-mimo on the
    card (the BlockSoftmax head's logits and the plain head, xent and
    mse) with finite losses."""
    from kaldi_aslp_tpu_torch.io import (
        int_vector_writer,
        matrix_writer,
    )
    from kaldi_aslp_tpu_torch.models import Nnet, simple

    rs = np.random.RandomState(24)
    S, T = ZOO_STREAMS, ZOO_FRAMES
    xs = [rs.randn(S, T, 40).astype(np.float32),
          rs.randn(S, T, 3).astype(np.float32)]
    lens = rs.randint(T // 4, T + 1, S)
    lens[0] = T
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    cots = [rs.randn(S, T, 10).astype(np.float32),
            rs.randn(S, T, 7).astype(np.float32)]
    net = zoo_net()
    # training's Dropout keeps one mask, drawn here, on both devices: the
    # card's generator draws other masks than the CPU's
    keep = torch.from_numpy(np.random.RandomState(25).rand(S, T, 48) < 0.8)
    draw = simple.dropout_keep
    simple.dropout_keep = lambda shape, ret, gen, dev: keep.to(dev)
    try:
        errs = {}
        for train in (False, True):
            runs = {}
            for device in ("cuda", "cpu"):
                net.to(device).train(train)
                net.zero_grad()
                t = [torch.from_numpy(x).to(device).requires_grad_(True)
                     for x in xs]
                ys, _ = net(t, mask=torch.from_numpy(mask).to(device),
                            generator=torch.Generator(device))
                sum((y * torch.from_numpy(c).to(device)).sum()
                    for y, c in zip(ys, cots)).backward()
                got = {f"y{i}": y.detach().cpu() for i, y in enumerate(ys)}
                got.update({n: p.grad.cpu() for n, p in net.named_parameters()
                            if p.grad is not None})
                got.update({f"dx{i}": x.grad.cpu() for i, x in enumerate(t)})
                runs[device] = got
            mode = "train" if train else "eval"
            errs[mode] = {k: rel_err(v, runs["cpu"][k])
                          for k, v in runs["cuda"].items()}
            if not all(torch.isfinite(v).all() for v in runs["cuda"].values()):
                raise RuntimeError(f"zoo net ({mode}) not finite on the card")
    finally:
        simple.dropout_keep = draw
    worst = {m: max(e, key=e.get) for m, e in errs.items()}
    result = dict(components=len(net.nodes),
                  tokens=sorted({c.token for c in net.nodes}),
                  worst={m: [w, errs[m][w]] for m, w in worst.items()},
                  tol=ZOO_TOL)
    if any(errs[m][w] > ZOO_TOL for m, w in worst.items()):
        raise RuntimeError(f"zoo net card vs CPU: {result}")

    model = f"{workdir}/zoo.zip"
    xent_heads(net.cpu()).save(model)
    frames = 2 * ZOO_MIMO_BATCH
    names = [f"{workdir}/zoo_{n}.ark" for n in ("f1", "f2", "t1", "t2")]
    with matrix_writer(f"ark:{names[0]}") as w1, \
            matrix_writer(f"ark:{names[1]}") as w2, \
            int_vector_writer(f"ark:{names[2]}") as wt1, \
            matrix_writer(f"ark:{names[3]}") as wt2:
        for u, n in enumerate((frames // 2, frames - frames // 2)):
            w1[f"u{u}"] = rs.randn(n, 40).astype(np.float32)
            w2[f"u{u}"] = rs.randn(n, 3).astype(np.float32)
            wt1[f"u{u}"] = rs.randint(0, 10, n).astype(np.int32)
            wt2[f"u{u}"] = rs.randn(n, 7).astype(np.float32)
    t0 = time.perf_counter()
    rc, printed = run_cli(["aslp-nnet-train-frame-mimo", "--device=cuda",
                           "--objective-function=xent:mse",
                           f"--minibatch-size={ZOO_MIMO_BATCH}",
                           "--learn-rate=0.01",
                           *[f"ark:{n}" for n in names], model,
                           f"{workdir}/zoo_trained.zip"])
    losses = [float(ln.split()[3]) for ln in printed.splitlines()
              if "AvgLoss" in ln]
    trained, _ = Nnet.load(f"{workdir}/zoo_trained.zip", "cpu")
    result.update(mimo_steps=frames // ZOO_MIMO_BATCH, mimo_losses=losses,
                  mimo_s=time.perf_counter() - t0)
    if rc != 0 or len(losses) != 2 or not np.isfinite(losses).all() or \
            not all(torch.isfinite(p).all() for p in trained.parameters()):
        raise RuntimeError(f"MIMO trainer on the card: exit {rc}, {result}")
    return result


def zoo_phase(workdir):
    """Phase 24: the LC-BLSTM hybrid at the flagship's widths through
    aslp-nnet-init, -train-blstm-streams-lc and -forward-blstm-lc on the
    card, its step against the CPU and by part, and the rest of the zoo.
    Returns {kernel wrapper: launches} of the training and forward runs."""
    t_phase = time.perf_counter()
    child = zoo_step_process()
    proto, feats, targets, test = write_lc_files(workdir)
    model = f"{workdir}/lc.zip"
    rc, _ = run_cli(["aslp-nnet-init", "--device=cuda", proto, model])
    if rc != 0:
        raise RuntimeError(f"aslp-nnet-init: exit {rc}")
    t0 = time.perf_counter()
    out = f"{workdir}/lc_trained.zip"
    train = lc_train_run(model, feats, targets, out)
    from kaldi_aslp_tpu_torch.models import Nnet
    trained, _ = Nnet.load(out, "cpu")
    if not all(torch.isfinite(p).all() for p in trained.parameters()):
        raise RuntimeError("the trained LC model is not finite")
    log("lc_train", **{k: v for k, v in train.items()},
        reloads=True, train_s=time.perf_counter() - t0)
    stdout, stderr = child.communicate(model + "\n", timeout=300)
    if child.returncode != 0:
        raise RuntimeError(f"LC step process failed: {stderr[-2000:]}")
    split = json.loads(stdout.strip().splitlines()[-1])
    log("lc_step_split", **split)
    check = lc_train_check(model, feats, targets)
    log("lc_check", **check)
    forward = lc_forward_run(out, test)
    log("lc_forward", **forward)
    zoo = zoo_check(workdir)
    log("zoo", **zoo)
    log("zoo_phase", seconds=time.perf_counter() - t_phase, smi=smi_name_and_power(),
        train_s=train["seconds"], step_ms=split["step_ms"],
        ms_per_utterance=forward["ms_per_utterance"])
    return {"lc_train": train["launches"],
            "lc_forward": {"lstmp_forward": forward["launches"]}}


# -- phase 25: kws-vad ---------------------------------------------------------

APP_TOL = 1e-4            # KWS confidences, AUC and EER, card vs CPU
APP_FMT_TOL = 5.1e-5      # a value printed to 4 decimals against its own
APP_POST_ATOL = 1e-5      # the nets' posteriors through aslp-nnet-forward
APP_GMM_RTOL = 1e-5       # gmm-global-init-from-feats' files, card vs CPU
APP_FBANK_DIM = 23        # the recipes' fbank (23 mel bins, no energy)
APP_SEEDS = {"vad": 25, "kws": 26}   # numpy seeds of the initial weights
APP_STEP_REPS = 50
# ProgressLoss lines every 6 minutes of 10 ms frames (the reporter's
# default is an hour, which none of the script's training runs reaches),
# so the earlier phases' training log carries lines for aslp-log-analyse
PROGRESS_FRAMES = 36_000


def capture_progress(workdir):
    """The training log of the whole run: the reporters' ProgressLoss
    lines into ``workdir/train_progress.log`` (and on to stderr as
    before), one every PROGRESS_FRAMES frames."""
    import logging

    from kaldi_aslp_tpu_torch.models.losses import LossReporter
    from kaldi_aslp_tpu_torch.utils.log import get_logger

    LossReporter.PROGRESS_STEP = PROGRESS_FRAMES
    path = os.path.join(workdir, "train_progress.log")
    get_logger("nnet-loss").addHandler(logging.FileHandler(path))
    return path


def app_init(name):
    """A recipe's initial DNN weights (the port's state dict) from the
    numpy seed APP_SEEDS[name], uniform in [-0.1, 0.1]."""
    from kaldi_aslp_tpu_torch.recipes import kws, vad

    net = {"vad": vad, "kws": kws}[name].build_net(APP_FBANK_DIM)
    rs = np.random.RandomState(APP_SEEDS[name])
    return {k: torch.from_numpy(uniform(rs, *v.shape))
            for k, v in net.state_dict().items()}


def app_recipes(root, device):
    """Both recipes at the JAX defaults on ``device``: their results, the
    KWS confidences an utterance, the GMM VAD's test masks, seconds."""
    from kaldi_aslp_tpu_torch.recipes import kws, vad

    out = {}
    t0 = time.perf_counter()
    out["vad"] = vad.run(f"{root}/vad", init_params=app_init("vad"),
                         device=device)
    out["vad_s"] = time.perf_counter() - t0
    art = vad.run.artifacts
    out["gmm_masks"] = [art["gmm_vad"].detect(f - art["cmn"]).tolist()
                        for f in art["test_feats"]]
    t0 = time.perf_counter()
    out["kws"] = kws.run(f"{root}/kws", init_params=app_init("kws"),
                         device=device)
    out["kws_s"] = time.perf_counter() - t0
    out["kws_scores"] = dict(kws.run.artifacts["scores"])
    return out


def apps_cpu_child(job):
    """In a process of its own, beside the card's run: both recipes on the
    CPU with the card's initial weights, and aslp-kws-gen-state-map on
    the card run's pickles; one JSON line."""
    from kaldi_aslp_tpu_torch.cli.__main__ import main as cli_main

    torch.set_num_threads(4)
    with open(job) as f:
        spec = json.load(f)
    t0 = time.perf_counter()
    out = app_recipes(spec["root"], "cpu")
    out["state_map_rc"] = cli_main(spec["state_map_args"])
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


def quiet_cli(argv):
    """The CLI's stdout, not echoed; raises on a nonzero exit."""
    from kaldi_aslp_tpu_torch.cli.__main__ import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    if rc != 0:
        raise RuntimeError(f"{argv[0]}: exit {rc}")
    return out.getvalue()


def int_table(path):
    from kaldi_aslp_tpu_torch.io import sequential_int_vector_reader
    return {k: v.tolist() for k, v in
            sequential_int_vector_reader(f"ark:{path}")}


def mat_table(path):
    from kaldi_aslp_tpu_torch.io import sequential_matrix_reader
    return dict(sequential_matrix_reader(f"ark:{path}"))


def both_devices(tool, args, outs):
    """``tool`` with --device=cuda and --device=cpu on the same inputs;
    ``outs`` are the positions in ``args`` of output paths, given a
    ``{dev}`` to fill.  Returns ({dev: stdout}, {dev: [paths]}, seconds
    of the card run)."""
    stdout, paths, card_s = {}, {}, 0.0
    for dev in ("cuda", "cpu"):
        filled = [a.format(dev=dev) for a in args]
        t0 = time.perf_counter()
        stdout[dev] = quiet_cli([tool, f"--device={dev}"] + filled)
        if dev == "cuda":
            card_s = time.perf_counter() - t0
        paths[dev] = [filled[i].split(":", 1)[-1] for i in outs]
    return stdout, paths, card_s


def write_app_files(d, vad_art, kws_art):
    """The tables the CLI chain reads: features less the recipes' CMN,
    labels, waves, the VAD train set's sil / speech masks, the KWS phone
    alignments, the nets as model zips."""
    from kaldi_aslp_tpu_torch.io import (
        WaveData,
        int_vector_writer,
        matrix_writer,
        write_wave,
    )

    os.makedirs(d, exist_ok=True)
    with matrix_writer(f"ark:{d}/vad_test.ark") as fw, \
            int_vector_writer(f"ark:{d}/vad_ref.ark") as lw:
        for i, (f, lab) in enumerate(zip(vad_art["test_feats"],
                                         vad_art["test_labels"])):
            fw[f"utt{i}"] = f - vad_art["cmn"]
            lw[f"utt{i}"] = lab
    with matrix_writer(f"ark:{d}/vad_train.ark") as fw, \
            int_vector_writer(f"ark:{d}/speech.ark") as sw, \
            int_vector_writer(f"ark:{d}/sil.ark") as nw:
        for i, (f, lab) in enumerate(zip(vad_art["train_feats"],
                                         vad_art["train_labels"])):
            fw[f"utt{i}"] = f - vad_art["cmn"]
            sw[f"utt{i}"], nw[f"utt{i}"] = lab, 1 - lab
    lines = []
    for i, w in enumerate(vad_art["test_wavs"]):
        write_wave(f"{d}/utt{i}.wav", WaveData(8000.0, w[None]))
        lines.append(f"utt{i} {d}/utt{i}.wav")
    with open(f"{d}/wav.scp", "w") as f:
        f.write("\n".join(lines) + "\n")
    with matrix_writer(f"ark:{d}/kws_test.ark") as fw:
        for i, f in enumerate(kws_art["test_feats"]):
            fw[f"utt{i}"] = f - kws_art["cmn"]
    # the clean training utterances' frame phone labels, 1-based
    with int_vector_writer(f"ark:{d}/phone_ali.ark") as w:
        for i, lab in enumerate(kws_art["train_labels"][:len(
                kws_art["train_labels"]) // 2]):
            w[f"utt{i}"] = lab + 1
    vad_art["net"].save(f"{d}/vad.zip")
    kws_art["net"].save(f"{d}/kws.zip")
    with open(f"{d}/kw.txt", "w") as f:
        f.write("niho ee ii oo\n")


def app_kws_chain(d, kws_art, recipe_root):
    """aslp-nnet-forward (the KWS net) -> aslp-kws-score ->
    aslp-kws-evaluation-roc, on the card and on the CPU; the keyword
    tools (text FST, fst-init / -info / -to-dot through a symbol table,
    convert-phone-ali)."""
    from kaldi_aslp_tpu_torch.fst.fst import SymbolTable
    from kaldi_aslp_tpu_torch.kws import roc_sweep
    from kaldi_aslp_tpu_torch.recipes import kws

    out = {}
    fwd = ["--no-softmax=true", "--apply-log=false", f"{d}/kws.zip",
           f"ark:{d}/kws_test.ark", "ark:" + d + "/kws_post_{dev}.ark"]
    _, paths, out["kws_forward_s"] = both_devices("aslp-nnet-forward",
                                                  fwd, [4])
    card, cpu = (mat_table(paths[k][0]) for k in ("cuda", "cpu"))
    out["kws_post_err"] = max(float(np.abs(card[u] - cpu[u]).max())
                              for u in cpu)
    if out["kws_post_err"] > APP_POST_ATOL or list(card) != list(cpu):
        raise RuntimeError(f"KWS posteriors, card vs CPU: {out}")
    cols = ",".join(str(kws.PHONES.index(p)) for p in kws.KEYWORD_PHONES)
    scored = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        scored[dev] = quiet_cli([
            "aslp-kws-score", f"--keywords={kws.KEYWORD}:{cols}",
            "--confidence-threshold=0", f"ark:{paths[dev][0]}"])
        out[f"kws_score_{dev}_s"] = time.perf_counter() - t0
    if scored["cuda"] != scored["cpu"]:
        raise RuntimeError("aslp-kws-score differs, card vs CPU")
    conf = {ln.split()[0]: float(ln.split()[2])
            for ln in scored["cuda"].splitlines()}
    out["kws_score_err"] = max(abs(conf.get(u, 0.0) - s)
                               for u, s in kws_art["scores"].items())
    if out["kws_score_err"] > APP_FMT_TOL:
        raise RuntimeError(f"aslp-kws-score against the recipe: {out}")
    with open(f"{d}/score.txt", "w") as f:
        f.writelines(f"{u} {c:.4f}\n" for u, c in conf.items())
    labels = {f"utt{i}": y for i, y in enumerate(kws_art["test_flags"])}
    with open(f"{d}/label.txt", "w") as f:
        f.writelines(f"{u} {y}\n" for u, y in labels.items())
    roc = quiet_cli(["aslp-kws-evaluation-roc", f"{d}/score.txt",
                     f"{d}/label.txt"])
    want = "".join(f"thresh {t:f} acc {a:f} false_reject {r:f} "
                   f"false_alarm {fa:f}\n" for t, a, r, fa in roc_sweep(
                       {u: float(f"{c:.4f}") for u, c in conf.items()},
                       labels))
    if roc != want:
        raise RuntimeError("aslp-kws-evaluation-roc differs from roc_sweep")
    # the keyword-filler FST: the tool's text is the recipe's; its symbol
    # names compiled to integer labels for the FST tools
    quiet_cli(["aslp-kws-gen-text-fst", f"{d}/kw.txt", f"{d}/kw.fst.txt"])
    with open(f"{d}/kw.fst.txt") as f, \
            open(f"{recipe_root}/kws/keyword.fst.txt") as g:
        text = f.read()
        if text != g.read():
            raise RuntimeError("aslp-kws-gen-text-fst differs from the "
                               "recipe's keyword.fst.txt")
    isyms, osyms = SymbolTable(), SymbolTable()
    lines = []
    for ln in text.splitlines():
        p = ln.split()
        if len(p) == 4:
            p[2], p[3] = str(isyms.add(p[2])), str(osyms.add(p[3]))
        lines.append(" ".join(p))
    with open(f"{d}/kw.fst.int", "w") as f:
        f.write("\n".join(lines) + "\n")
    quiet_cli(["aslp-fst-init", f"{d}/kw.fst.int", f"{d}/kw.fst"])
    info = quiet_cli(["aslp-fst-info", f"{d}/kw.fst"])
    quiet_cli(["aslp-fst-to-dot", f"{d}/kw.fst", f"{d}/kw.dot"])
    with open(f"{d}/kw.dot") as f:
        dot = f.read()
    n_arcs = len(lines) - 1
    if (f"num-states {3 + len(kws.KEYWORD_PHONES)}\nnum-arcs {n_arcs}\n"
            "num-final 1\nstart 0\n") not in info or \
            dot.count("->") != n_arcs:
        raise RuntimeError(f"the keyword FST's tools: {info!r}")
    # convert-phone-ali: sil, the keyword phones, the rest as filler
    ids = {p: i + 1 for i, p in enumerate(kws.PHONES)}
    new = {p: (1 if p == "sil" else 3 + kws.KEYWORD_PHONES.index(p)
               if p in kws.KEYWORD_PHONES else 2) for p in kws.PHONES}
    with open(f"{d}/phone.map", "w") as f:
        f.writelines(f"{ids[p]} {new[p]}\n" for p in kws.PHONES)
    quiet_cli(["aslp-kws-convert-phone-ali", f"{d}/phone.map",
               f"ark:{d}/phone_ali.ark", f"ark:{d}/kws_ali.ark"])
    lut = np.array([0] + [new[p] for p in kws.PHONES])
    if int_table(f"{d}/kws_ali.ark") != {
            u: lut[np.asarray(a)].tolist()
            for u, a in int_table(f"{d}/phone_ali.ark").items()}:
        raise RuntimeError("aslp-kws-convert-phone-ali")
    out["kws_fst"] = info.split()[1::2][:2]
    return out


def app_vad_chain(d, vad_art, vad_results, recipe_root):
    """The VAD tools: aslp-nnet-forward (the VAD net) ->
    aslp-apply-nn-vad-segment / aslp-apply-nn-vad -> aslp-eval-vad,
    aslp-eval-vad-boundary; aslp-gen-textgrid on the recipe's
    segment.info; aslp-apply-energy-vad; gmm-global-init-from-feats
    (silence and speech) -> aslp-apply-gmm-vad -> aslp-eval-gmm-vad; the
    tensor tools on the card and on the CPU."""
    from kaldi_aslp_tpu_torch.io import matrix_writer
    from kaldi_aslp_tpu_torch.recipes import vad
    from kaldi_aslp_tpu_torch.vad import NnetVad, VadOptions

    out = {}
    fwd = ["--no-softmax=true", "--apply-log=false", f"{d}/vad.zip",
           f"ark:{d}/vad_test.ark", "ark:" + d + "/vad_post_{dev}.ark"]
    _, paths, out["vad_forward_s"] = both_devices("aslp-nnet-forward",
                                                  fwd, [4])
    card, cpu = (mat_table(paths[k][0]) for k in ("cuda", "cpu"))
    out["vad_post_err"] = max(float(np.abs(card[u] - cpu[u]).max())
                              for u in cpu)
    if out["vad_post_err"] > APP_POST_ATOL:
        raise RuntimeError(f"VAD posteriors, card vs CPU: {out}")
    post = f"ark:{paths['cuda'][0]}"
    quiet_cli(["aslp-apply-nn-vad-segment", post, f"{d}/segments.txt"])
    quiet_cli(["aslp-apply-nn-vad", post, f"ark:{d}/nn_mask.ark"])
    masks = int_table(f"{d}/nn_mask.ark")
    nvad = NnetVad(VadOptions(sil_pdf_ids="0"))
    for i, p in enumerate(vad_art["test_posteriors"]):
        if masks[f"utt{i}"] != nvad.detect_from_posteriors(p).astype(
                np.int32).tolist():
            raise RuntimeError(f"aslp-apply-nn-vad, utt{i}")
    with open(f"{d}/segments.txt") as f:
        seg0 = [tuple(int(x) for x in ln.split()[1:]) for ln in f
                if ln.startswith("utt0 ")]
    if seg0 != vad.mask_to_intervals(np.asarray(masks["utt0"])):
        raise RuntimeError("aslp-apply-nn-vad-segment against the mask")
    with matrix_writer(f"ark:{d}/vad_scores.ark") as w:
        for u, m in card.items():
            w[u] = m[:, 1:2]
    ev = quiet_cli(["aslp-eval-vad", f"ark:{d}/nn_mask.ark",
                    f"ark:{d}/vad_ref.ark", f"ark:{d}/vad_scores.ark"])
    auc_, eer_ = (float(x) for x in ev.split()[-3::2])
    out["eval_vad"] = ev.split()
    if abs(auc_ - vad_results["dnn_auc"]) > APP_FMT_TOL or \
            abs(eer_ - vad_results["dnn_eer"]) > APP_FMT_TOL:
        raise RuntimeError(f"aslp-eval-vad against the recipe: {ev!r}")
    # exits 1 (raises here) if no utterance could be scored
    out["boundary"] = quiet_cli(["aslp-eval-vad-boundary",
                                 f"ark:{d}/vad_ref.ark",
                                 f"ark:{d}/nn_mask.ark"]).split()
    quiet_cli(["aslp-gen-textgrid", f"{recipe_root}/vad/segment.info",
               f"{d}/u0.TextGrid"])
    with open(f"{d}/u0.TextGrid", "rb") as f, \
            open(f"{recipe_root}/vad/u0.TextGrid", "rb") as g:
        if f.read() != g.read():
            raise RuntimeError("aslp-gen-textgrid differs from the "
                               "recipe's u0.TextGrid")
    _, paths, out["energy_vad_s"] = both_devices(
        "aslp-apply-energy-vad", [f"scp:{d}/wav.scp",
                                  "ark:" + d + "/energy_{dev}.ark"], [1])
    if int_table(paths["cuda"][0]) != int_table(paths["cpu"][0]):
        raise RuntimeError("aslp-apply-energy-vad, card vs CPU")
    for cls in ("sil", "speech"):
        quiet_cli(["aslp-select-frames", f"ark:{d}/vad_train.ark",
                   f"ark:{d}/{cls}.ark", f"ark:{d}/{cls}_feats.ark"])
        _, paths, out[f"gmm_init_{cls}_s"] = both_devices(
            "gmm-global-init-from-feats",
            ["--num-gauss=16", "--num-iters=10",
             f"ark:{d}/{cls}_feats.ark", d + "/" + cls + "_{dev}.npz"], [3])
        card, cpu = (np.load(paths[k][0]) for k in ("cuda", "cpu"))
        for k in cpu.files:
            err = float(np.abs(card[k] - cpu[k]).max() /
                        np.abs(cpu[k]).max())
            if card[k].shape != cpu[k].shape or err > APP_GMM_RTOL:
                raise RuntimeError(f"{cls} GMM {k}, card vs CPU: {err}")
    models = [d + "/sil_{dev}.npz", d + "/speech_{dev}.npz"]
    _, paths, out["apply_gmm_vad_s"] = both_devices(
        "aslp-apply-gmm-vad", models + [f"ark:{d}/vad_test.ark",
                                        "ark:" + d + "/gmm_{dev}.ark"], [3])
    if int_table(paths["cuda"][0]) != int_table(paths["cpu"][0]):
        raise RuntimeError("aslp-apply-gmm-vad, card vs CPU")
    evals, _, out["eval_gmm_vad_s"] = both_devices(
        "aslp-eval-gmm-vad", models + [f"ark:{d}/vad_test.ark",
                                       f"ark:{d}/vad_ref.ark"], [])
    if evals["cuda"] != evals["cpu"]:
        raise RuntimeError("aslp-eval-gmm-vad, card vs CPU")
    out["eval_gmm_vad"] = evals["cuda"].split()
    return out


def app_state_map_args(d, tri):
    """aslp-kws-gen-state-map's arguments on phase 20's pickled tri model
    and tree: the lang's phones and two of its words as keywords."""
    lang = tri["lang"]
    with open(f"{d}/phones.txt", "w") as f:
        f.write(lang.phones.to_text() + "\n")
    words = [(w, p[0]) for w, p in sorted(lang.lexicon.prons.items())
             if w != "<SIL>" and len(p[0]) >= 2][:2]
    with open(f"{d}/keyword.lexicon", "w") as f:
        f.writelines(f"{w} {' '.join(p)}\n" for w, p in words)
    sil = lang.phones.sym(lang.sil_phone_id)
    return [["aslp-kws-gen-state-map", f"--silence={sil}",
             f"{d}/phones.txt", f"{d}/keyword.lexicon", tri["mdl"],
             tri["tree"], f"{d}/{tag}_tid.map", f"{d}/{tag}_states.txt"]
            for tag in ("card", "cpu")]


def app_frame_step():
    """One frame-training step of the KWS recipe's phone DNN at its
    minibatch (256 frames) on the card: ms by CUDA events, launches and
    device ms by torch.profiler."""
    from kaldi_aslp_tpu_torch.recipes import kws
    from kaldi_aslp_tpu_torch.train import (
        FrameTrainer,
        NnetTrainOptions,
        init_velocity,
    )

    net = kws.build_net(APP_FBANK_DIM)
    net.load_state_dict(app_init("kws"))
    net.to("cuda")
    trainer = FrameTrainer(net, NnetTrainOptions(momentum=0.9))
    velocity = init_velocity(net)
    rs = np.random.RandomState(25)
    x = rs.randn(256, APP_FBANK_DIM).astype(np.float32)
    y = rs.randint(0, net.output_dim, 256).astype(np.int32)
    batch = trainer._upload((x, y), torch.device("cuda"))
    step = lambda: trainer.step(velocity, batch, 0.1)
    ms = cuda_ms(step, APP_STEP_REPS)
    counts = {}
    dev_ms = sum(device_ms_by_kernel(step, counts).values())
    return {"step_ms": ms, "launches": sum(counts.values()),
            "device_ms": dev_ms, "device_busy_share": dev_ms / ms}


def apps_phase(workdir, tri, progress_log):
    """Phase 25: the KWS and VAD recipes at the JAX defaults on the card
    against a CPU run in a child process, then the application CLI chain
    on their outputs (tensor tools on the card against --device=cpu), a
    frame-training step, and aslp-log-analyse on the run's training
    log."""
    t_phase = time.perf_counter()
    d = f"{workdir}/apps"
    os.makedirs(d, exist_ok=True)
    state_map_args = app_state_map_args(d, tri)
    job = f"{d}/cpu_job.json"
    with open(job, "w") as f:
        json.dump({"root": f"{d}/cpu_run", "state_map_args":
                   state_map_args[1]}, f)
    child = subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; "
         f"chip_smoke.apps_cpu_child({job!r})"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    from kaldi_aslp_tpu_torch.recipes import kws, vad

    card = app_recipes(f"{d}/card_run", "cuda")
    vad_art, kws_art = vad.run.artifacts, kws.run.artifacts
    if {next(a["net"].parameters()).device.type
            for a in (vad_art, kws_art)} != {"cuda"}:
        raise RuntimeError("a recipe's net is not on the card")
    t0 = time.perf_counter()
    write_app_files(d, vad_art, kws_art)
    chain = app_kws_chain(d, kws_art, f"{d}/card_run")
    chain.update(app_vad_chain(d, vad_art, card["vad"], f"{d}/card_run"))
    quiet_cli(state_map_args[0])
    with open(f"{d}/card_tid.map") as f:
        chain["state_map_tids"] = len(f.read().splitlines())
    with open(f"{d}/card_states.txt") as f:
        chain["state_map_states"] = len(f.read().splitlines()) - 1
    if chain["state_map_tids"] != tri["num_transition_ids"]:
        raise RuntimeError("the state map's transition ids")
    logged = quiet_cli(["aslp-log-analyse", "--sum=1000000", "--stride=1",
                        progress_log]).split()
    with open(progress_log) as f:
        progress_lines = sum("ProgressLoss[" in ln for ln in f)
    if not progress_lines or len(logged) != progress_lines or \
            not all(np.isfinite(float(v)) for v in logged):
        raise RuntimeError(f"aslp-log-analyse read {len(logged)} of "
                           f"{progress_lines} ProgressLoss lines")
    chain_s = time.perf_counter() - t0
    step = app_frame_step()
    cpu = cpu_child_result(child)
    # card against CPU
    errs = {k: abs(card[r][k] - cpu[r][k]) for r in ("vad", "kws")
            for k in card[r]}
    conf_err = max(abs(card["kws_scores"][u] - cpu["kws_scores"][u])
                   for u in cpu["kws_scores"])
    if max(errs.values()) > APP_TOL or conf_err > APP_TOL:
        raise RuntimeError(f"the recipes, card vs CPU: {errs}, "
                           f"confidences {conf_err}")
    if card["gmm_masks"] != cpu["gmm_masks"]:
        raise RuntimeError("the GMM VAD's masks, card vs CPU")
    pairs = [(f"{d}/card_run/{name}", f"{d}/cpu_run/{name}") for name in (
        "vad/segment.info", "vad/u0.TextGrid", "kws/keyword.fst.txt")]
    pairs += [(f"{d}/card_{name}", f"{d}/cpu_{name}")
              for name in ("tid.map", "states.txt")]
    for a, b in pairs:
        with open(a, "rb") as f, open(b, "rb") as g:
            if f.read() != g.read():
                raise RuntimeError(f"{a}, card vs CPU")
    if cpu["state_map_rc"] != 0:
        raise RuntimeError("aslp-kws-gen-state-map on the CPU")
    log("apps_check", vad=card["vad"], kws=card["kws"],
        max_err_results=max(errs.values()), max_err_confidence=conf_err,
        gmm_masks_equal=True, files_equal=True,
        progress_lines=progress_lines, cpu_seconds=cpu["seconds"],
        **{k: v for k, v in chain.items()})
    log("apps_step", **step, batch=256, widths=[APP_FBANK_DIM, 64, 6])
    log("apps_phase", seconds=time.perf_counter() - t_phase,
        vad_recipe_s=card["vad_s"], kws_recipe_s=card["kws_s"],
        cli_chain_s=chain_s, step_ms=step["step_ms"],
        step_launches=step["launches"], kws_auc=card["kws"]["kws_auc"],
        kws_best_acc=card["kws"]["kws_best_acc"],
        dnn_auc=card["vad"]["dnn_auc"], dnn_eer=card["vad"]["dnn_eer"],
        gmm_auc=card["vad"]["gmm_auc"], gmm_eer=card["vad"]["gmm_eer"],
        energy_auc=card["vad"]["energy_auc"],
        energy_eer=card["vad"]["energy_eer"], smi=smi_name_and_power())


NO_LIBRARY = ("no PyTorch call computes a peephole LSTMP with cell "
              "clipping (torch.nn.LSTM with proj_size has neither)")


# -- phase 26: distributed training ----------------------------------------

def write_bn_model(workdir: str) -> str:
    """Linear (no bias: a bias before BN has a gradient of rounding noise),
    BatchNormalization with axis_name "data", Sigmoid, Affine at DIST_BN's
    widths, weights from numpy seed 9753."""
    from kaldi_aslp_tpu_torch.models import (
        AffineTransform,
        BatchNormalization,
        LinearTransform,
        Nnet,
        Sigmoid,
    )

    D, H, V = DIST_BN
    rs = np.random.RandomState(9753)
    net = Nnet()
    net.add(LinearTransform(D, H))
    net.add(BatchNormalization(H, H, axis_name="data"))
    net.add(Sigmoid(H, H))
    net.add(AffineTransform(H, V))
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith(".w"):
                p.copy_(torch.from_numpy(
                    (0.3 * rs.randn(*p.shape)).astype(np.float32)))
    path = f"{workdir}/bn_dist.zip"
    net.save(path)
    return path


def rel_max(got, want) -> float:
    """Largest |got - want| over the largest |want| (numpy)."""
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def cv_loss(feats, targets, model, device) -> float:
    rc, out = run_cli(["aslp-nnet-train-simple", "--cross-validate=true",
                       f"--device={device}", feats, targets, model])
    if rc:
        raise RuntimeError(f"cross-validation of {model} failed: {rc}")
    return float(out.split("AvgLoss: ")[1].split()[0])


def distributed_phase(flagship_model, hybrid, workdir, device="cuda"):
    """Phase 26: DIST_RANKS ranks in one spawned group sharing the card
    (gloo), each running (a) the flagship under BSP and one BMUF round,
    (b) the six worker types of aslp-nnet-train-lstm-stream-worker on the
    LSTM hybrid, (c) the BN net under BSP; then the checks against one
    rank on the whole batch here.  Returns the ranks' launches:
    ({train kernel: launches in (a)}, {wrapper: launches in (b)})."""
    from kaldi_aslp_tpu_torch.models import Nnet
    from kaldi_aslp_tpu_torch.parallel.launch import RankContext, spawn
    from kaldi_aslp_tpu_torch.parallel.mesh import choose_backend
    from kaldi_aslp_tpu_torch.parallel.steps import train_rank, train_ranks

    t_phase = time.perf_counter()
    hybrid_model, feats, targets = hybrid
    rs = np.random.RandomState(8642)
    S, (T, U) = DIST_RANKS * DIST_STREAMS, CTC_SHAPE[1:3]
    batch = {"feats": rs.randn(S, T, FEAT_DIM).astype(np.float32),
             "labels": rs.randint(1, TARGETS, (S, U)).astype(np.int64),
             "in_lens": np.full(S, T, np.int64),
             "lab_lens": np.full(S, U, np.int64),
             "mask": np.ones((S, T), np.float32)}
    flag = dict(model=flagship_model, batch=batch, learn_rate=0.008,
                momentum=0.9, steps=DIST_STEPS, strategy="bsp")
    bmuf = dict(flag, strategy="bmuf", steps=1, blocks=DIST_RANKS,
                inner_steps=DIST_BMUF_INNER)
    outs = {t: f"{workdir}/dist_{t}.zip" for t in DIST_WORKERS}
    workers = {"cli": [
        ["aslp-nnet-train-lstm-stream-worker", f"--worker-type={t}",
         f"--device={device}", *DIST_WORKER_ARGS, *extra, feats, targets,
         hybrid_model, outs[t]] for t, extra in DIST_WORKERS.items()]}
    D, _, V = DIST_BN
    bn = dict(model=write_bn_model(workdir), strategy="bsp", steps=1,
              learn_rate=0.1, momentum=0.9,
              batch={"x": rs.randn(DIST_BN_FRAMES, D).astype(np.float32),
                     "y": rs.randint(0, V, DIST_BN_FRAMES).astype(np.int64)})
    t0 = time.perf_counter()
    ranks = spawn(train_ranks, DIST_RANKS, args=([flag, bmuf, workers, bn],),
                  device_type=device, run_timeout_s=600)
    group_s = time.perf_counter() - t0
    rk_flag, rk_bmuf, rk_cli, rk_bn = zip(*ranks)

    # (a) the flagship: finite, the same bits on both ranks after every
    # step, every kernel launched where it should be; one rank on all
    # the streams for the step-1 loss and gradients
    names = list(rk_flag[0]["params"][0])
    for r in rk_flag + rk_bmuf:
        if not np.isfinite(r["losses"]).all():
            raise RuntimeError(f"distributed flagship loss {r['losses']}")
    for i in range(DIST_STEPS):
        for k in names:
            if not all(np.array_equal(r["params"][i][k],
                                      rk_flag[0]["params"][i][k])
                       for r in rk_flag):
                raise RuntimeError(f"ranks differ after BSP step {i + 1} "
                                   f"in {k}")
    for k in names:
        if not all(np.array_equal(r["params"][0][k],
                                  rk_bmuf[0]["params"][0][k])
                   for r in rk_bmuf):
            raise RuntimeError(f"ranks differ after the BMUF round in {k}")
    want = {"bilstmp_train_fwd": LAYERS, "bilstmp_train_bwd": LAYERS,
            "ctc_alpha_beta": 1}
    for what, rows, steps in (("bsp", rk_flag, DIST_STEPS),
                              ("bmuf", rk_bmuf, DIST_BMUF_INNER)):
        for r in rows:
            got = {n: r["launches"][n]["launches"] for n in want}
            if got != {n: c * steps for n, c in want.items()} or \
                    r["launches"]["ctc_alpha_beta"]["wide"]:
                raise RuntimeError(f"{what} launches {r['launches']}")
    one = train_rank(RankContext(0, 1, torch.device(device), "none"),
                     dict(flag, steps=1))
    loss_err = abs(rk_flag[0]["losses"][0] - one["losses"][0]) / abs(
        one["losses"][0])
    grad_err = max(rel_max(rk_flag[0]["grads"][k], one["grads"][k])
                   for k in names)
    if loss_err > CROSS_LOSS_RTOL or grad_err > CROSS_GRAD_RTOL:
        raise RuntimeError(f"BSP step against one rank: loss {loss_err}, "
                           f"gradients {grad_err}")
    log("distributed", ranks=DIST_RANKS, backend=choose_backend(
            device, DIST_RANKS, torch.cuda.device_count()
            if device == "cuda" else 0),
        streams_a_rank=DIST_STREAMS, T=T, U=U, group_s=group_s,
        bsp_losses=rk_flag[0]["losses"], bmuf_loss=rk_bmuf[0]["losses"],
        one_rank_loss=one["losses"][0], loss_rel_err=loss_err,
        grad_rel_err=grad_err, ranks_equal_bits=True,
        step_ms=[r["step_ms"] for r in rk_flag],
        bmuf_round_ms=[r["step_ms"] for r in rk_bmuf],
        one_rank_step_ms=one["step_ms"],
        allreduce_ms_gloo_through_host_staging_one_card=[
            r["allreduce_ms"] for r in rk_flag],
        allreduce_note="gloo all-reduce of the flagship's float32 "
        "gradients between two processes on one card, staged through the "
        "host: not a multi-card NCCL figure",
        launches=[{n: r["launches"][n] for n in want} for r in rk_flag])

    # (b) the worker types: every rank's run exits 0 on the LSTMP sweeps
    # (never the per-step kernels), the written model reloads and moved,
    # and the CV loss falls
    cv0 = cv_loss(feats, targets, hybrid_model, device)
    net0, _ = Nnet.load(hybrid_model, device)
    p0 = {k: v.detach() for k, v in net0.named_parameters()}
    per_type, worker_launches = {}, {}
    for i, t in enumerate(DIST_WORKERS):
        runs = [rc["cli"][i] for rc in rk_cli]
        for r in runs:
            lc = r["launches"]
            if (r["rc"] or not lc["lstmp_train_fwd"]["launches"]
                    or lc["lstmp_train_fwd"]["launches"]
                    != lc["lstmp_train_bwd"]["launches"]
                    or lc["lstmp_train_fwd"]["per_step"]
                    or lc["lstmp_train_bwd"]["per_step"]):
                raise RuntimeError(f"worker {t}: rc {r['rc']}, {lc}")
        net, _ = Nnet.load(outs[t], device)
        moved = max(float((p.detach() - p0[k]).abs().max())
                    for k, p in net.named_parameters())
        cv1 = cv_loss(feats, targets, outs[t], device)
        if not (np.isfinite(cv1) and cv1 < cv0 and moved > 0):
            raise RuntimeError(f"worker {t}: CV {cv0} -> {cv1}, moved "
                               f"{moved}")
        for name in ("lstmp_train_fwd", "lstmp_train_bwd"):
            worker_launches[name] = worker_launches.get(name, 0) + sum(
                r["launches"][name]["launches"] for r in runs)
        per_type[t] = {"cv_loss": cv1, "seconds": [r["seconds"]
                                                   for r in runs],
                       "report": runs[0]["stdout"].strip(),
                       "lstmp_train_fwd": [r["launches"]["lstmp_train_fwd"]
                                           ["launches"] for r in runs]}
    log("distributed_workers", cv_loss_initial=cv0, workers=per_type,
        args=DIST_WORKER_ARGS)

    # (c) BN with axis_name: the ranks' rows of the outputs and their
    # averaged gradients against one rank on the whole batch
    one_bn = train_rank(RankContext(0, 1, torch.device(device), "none"), bn)
    out_err = rel_max(np.concatenate([r["outputs"] for r in rk_bn]),
                      one_bn["outputs"])
    bn_grad_err = max(rel_max(r["grads"][k], one_bn["grads"][k])
                      for r in rk_bn for k in one_bn["grads"])
    if out_err > DIST_BN_RTOL or bn_grad_err > DIST_BN_RTOL:
        raise RuntimeError(f"BN axis_name: outputs {out_err}, gradients "
                           f"{bn_grad_err}")
    log("distributed_bn", output_rel_err=out_err, grad_rel_err=bn_grad_err,
        frames=DIST_BN_FRAMES)
    convergence_parity(device)
    log("distributed_phase", seconds=time.perf_counter() - t_phase)
    train_launches = {n: sum(r["launches"][n]["launches"]
                             for r in rk_flag + rk_bmuf)
                      for n in train_kernel_wrappers()}
    return train_launches, worker_launches


def convergence_parity(device="cuda"):
    """Phase 26 (d): the convergence task built on ``device``, then bsp
    and asgd for PARITY_ROUNDS rounds on ranks of ``device`` and on CPU
    ranks at once, from JAX's shipped initial parameters; fails when the
    held-out losses part by more than PARITY_RTOL.  Then every subpackage
    of the port imported, with its count of public names."""
    import importlib
    import pkgutil

    import kaldi_aslp_tpu_torch
    from kaldi_aslp_tpu_torch.parallel.convergence import (
        make_hard_frame_task,
        run_convergence_comparison,
    )

    t0 = time.perf_counter()
    task = make_hard_frame_task(seed=0, device=device)
    task_s = time.perf_counter() - t0
    kw = dict(n_rounds=PARITY_ROUNDS, learn_rate=1.0, per_device_batch=8,
              strategies=tuple(PARITY_RTOL), task="hard_blstm",
              task_data=task, init_params="jax", run_timeout_s=300)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        on_device = pool.submit(run_convergence_comparison, PARITY_RANKS,
                                device=device, **kw)
        on_cpu = pool.submit(run_convergence_comparison, PARITY_RANKS,
                             device="cpu", threads=1, **kw)
        got, want = on_device.result(), on_cpu.result()
    gaps = {s: max(abs(a - b) / abs(b) for a, b in zip(got[s], want[s]))
            for s in PARITY_RTOL}
    log("convergence_parity", ranks=PARITY_RANKS, rounds=PARITY_ROUNDS,
        device=device, task_s=task_s, runs_s=time.perf_counter() - t0,
        train_shape=list(task[0].shape), num_pdfs=task[4],
        **{f"{s}_{where}": traj for s in PARITY_RTOL
           for where, traj in (("card", got[s]), ("cpu", want[s]))},
        max_rel_gap=gaps, bound=PARITY_RTOL)
    bad = {s: g for s, g in gaps.items() if not g <= PARITY_RTOL[s]}
    if bad:
        raise RuntimeError(f"card against CPU ranks: held-out losses part "
                           f"by {bad}, bounds {PARITY_RTOL}")
    names = {}
    for m in sorted(pkgutil.iter_modules(kaldi_aslp_tpu_torch.__path__),
                    key=lambda m: m.name):
        mod = importlib.import_module(f"kaldi_aslp_tpu_torch.{m.name}")
        names[m.name] = len([n for n in vars(mod) if not n.startswith("_")])
    log("surface", public_names=names)


def kernel_record(name, source, replaces, runs, rows, timed, bound_at,
                  library_ms=None, library_note=NO_LIBRARY, **extra):
    """The kernel's JSON entry: its launches summed over the CLI runs
    ``runs`` ({run: launches}, each run's counts set to 0 just before it
    and read just after), the largest error over ``rows``, the times of
    ``timed`` and the bound ``bound_at`` = (ms, what binds it) at the
    same shape."""
    return {"name": name, "route": "cuda",
            "source": "kaldi_aslp_tpu_torch/csrc/" + source,
            "replaces": "kaldi_aslp_tpu/ops/" + replaces,
            "launches": sum(runs.values()), "launches_by_run": runs,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": bound_at[0], "bound_by": bound_at[1],
            "library_ms": library_ms,
            **({} if library_ms is not None
               else {"library_note": library_note}), **extra}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = smi_name_and_power()
    print(smi, flush=True)
    log("device", torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 reference
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from kaldi_aslp_tpu_torch.ops import (
        bilstmp_train,
        bilstmp_xg_train,
        build,
        ctc_recursions,
        lstmp,
        lstmp_train,
    )

    t0 = time.perf_counter()
    modules = (lstmp, bilstmp_train, ctc_recursions, lstmp_train,
               bilstmp_xg_train)
    with ThreadPoolExecutor(len(modules)) as pool:
        for future in [pool.submit(m.build) for m in modules]:
            future.result()
    log("build", seconds=time.perf_counter() - t0,
        libraries=[build.library_path(m.SOURCE).name for m in modules])

    kernel_results = kernel_phase(dev)
    with tempfile.TemporaryDirectory() as workdir:
        progress_log = capture_progress(workdir)
        paths = write_model_and_graph(workdir)
        launches, recorded, finals = slice_phase(paths, "cuda")
        cross_check(paths, recorded)
        t0 = time.perf_counter()
        batched_launches, batched_timings = serve_batched_phase(paths, finals)
        vad_launches, vad_paths = vad_phase(paths, workdir)
        punctuation_phase(vad_paths)
        entry_launches = entry_phase()
        log("serving_phases", seconds=time.perf_counter() - t0)
        train_results = train_kernel_phase(dev)
        xg_results = xg_train_kernel_phase(dev)
        model, feats, labels = write_train_files(workdir)
        flagship_model = model
        runs = {"default": train_phase(model, feats, labels, workdir)}
        train_cross_check(model, feats, labels)
        steps = {"default": step_split(model, dev)}
        for switch in SWITCHES:
            runs[switch] = train_phase(model, feats, labels, workdir, switch)
        for switch in SWITCHES:
            train_cross_check(model, feats, labels, switch)
        for switch in SWITCHES:
            steps[switch] = step_split(model, dev, switch)
        log("step_split_paths", S=CTC_SHAPE[0], T=CTC_SHAPE[1],
            step_ms={k: v["step_ms"] for k, v in steps.items()},
            forward_ms={k: v["forward_ms"] for k, v in steps.items()},
            backward_ms={k: v["backward_ms"] for k, v in steps.items()})
        lstm_results = lstm_train_kernel_phase(dev)
        model, feats, targets = write_bptt_files(workdir)
        hybrid = (model, feats, targets)
        bptt_launches = bptt_train_phase(model, feats, targets, workdir)
        bptt_cross_check(model, feats, targets)
        bptt_step_split(model, dev)
        (runs["ctc_recipe"], recipe_wide, recipe_ctc, rec,
         corpus) = ctc_recipe_phase(workdir)
        loglikes, singles = beam_phase(rec, first_utts(corpus, **BEAM_SETS))
        t0 = time.perf_counter()
        batched_decode_phase(rec, loglikes, singles)
        log("batched_decode_phase", seconds=time.perf_counter() - t0)
        budget_sweep_phase(rec, corpus)
        t0 = time.perf_counter()
        latgen_launches = latgen_phase(paths, workdir)
        log("latgen_phase", seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        lattice_score_phase(rec, corpus, workdir)
        log("lattice_score_phase", seconds=time.perf_counter() - t0)
        gmm_corpus = first_utts(corpus, **GMM_SETS)
        art, child = hybrid_phase(gmm_corpus, workdir)
        tri = tri_phase(gmm_corpus, art, child, workdir)
        t0 = time.perf_counter()
        runs["ls_synth"], ls_synth_forward = ls_synth_phase(workdir)
        log("ls_synth_phase", seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        synth_recipes_phase(corpus, workdir)
        log("synth_recipes_phase", seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        runs["hkust"] = hkust_phase(workdir)
        log("hkust_phase", seconds=time.perf_counter() - t0)
        zoo_launches = zoo_phase(workdir)
        apps_phase(workdir, tri, progress_log)
        runs["distributed"], dist_workers = distributed_phase(
            flagship_model, hybrid, workdir)
    serving_runs = {"serving": launches, "serve_batched": batched_launches,
                    "vad": vad_launches, "entry": entry_launches,
                    "ls_synth": ls_synth_forward}
    records = kernel_records(serving_runs, runs, bptt_launches,
                             kernel_results, train_results, xg_results,
                             lstm_results, recipe_wide, recipe_ctc,
                             latgen_launches, batched_timings, zoo_launches,
                             dist_workers)
    log("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def kernel_records(serving_runs, runs, bptt_launches, kernel_results,
                   train_results, xg_results, lstm_results, recipe_wide,
                   recipe_ctc, latgen_launches, batched_timings,
                   zoo_launches, dist_workers):
    """The ten kernels' JSON entries from the phases' results."""
    def launched(name):
        return {run: n[name] for run, n in runs.items() if n[name]}

    # the served chunk: a BLSTMP layer is one two-direction call; the
    # one-direction call at the same shape beside it
    served = {r["directions"]: r for r in kernel_results
              if (r["S"], r["T"], r["D"]) == (1, 16, 2 * P)}
    S, T, D = TRAIN_SHAPES[-1]
    split = train_results["redesign"]["split"]

    def redesigned(name):
        """A redesigned kernel's split into sweep and GEMMs."""
        sp = split[name]
        return {"sweep_ms": sp["sweep_ms"], "gemm_ms": sp["gemm_ms"],
                "gemm_library_ms": sp["gemm_library_ms"],
                "time_split_source": sp["source"]}
    xg = {(kind, r["mxu_bf16"]): r for kind in ("fwd", "bwd")
          for r in xg_results[kind] if (r["S"], r["T"]) == (S, T)}
    ctc = train_results["ctc"]
    ctc_extra = dict(
        library_call="F.ctc_loss forward and backward from the logits at "
        "CTC_SHAPE (log-softmax, recursions, gradient): the same loss and "
        "gradient as the port's ctc_loss, whose time is loss_ms",
        entry="ctc_alpha_beta (C entry ctc_alpha_beta_f32): one launch for "
        "both recursions, the same figures in both rows",
        ctc_recipe_wide_kernel_calls=recipe_wide,
        ctc_recipe_shapes=recipe_ctc,
        **{k: ctc[k] for k in ("device_ms", "host_call_us", "wide_ms",
                               "wide_device_ms", "loss_ms")})
    records = [
        kernel_record("lstmp_forward", "lstmp_forward.cu",
                      "lstm_pallas.py:43",
                      {**serving_runs,
                       "bptt_cv": bptt_launches["lstmp_forward_cv"],
                       "latgen": latgen_launches,
                       "lc_forward":
                           zoo_launches["lc_forward"]["lstmp_forward"]},
                      kernel_results, served[2],
                      (served[2]["bound_ms"], served[2]["bound_by"]),
                      timed_at="S, T = 1, 16, both directions of a BLSTMP "
                      "layer in one launch (the served chunk's call)",
                      one_direction={k: served[1][k] for k in
                                     ("ms", "plain_ms", "bound_ms",
                                      "per_step_ms")},
                      per_step_ms=served[2]["per_step_ms"],
                      batched_serving=[
                          {k: t[k] for k in ("B", "T", "kernel_ms",
                                             "plain_ms", "bound_ms",
                                             "bound_by", "max_abs_err",
                                             "regime", "batched_forward_ms",
                                             "sequential_ms")}
                          for t in batched_timings]),
        kernel_record("bilstmp_train_fwd", "bilstmp_train.cu",
                      "lstm_pallas.py:1037", launched("bilstmp_train_fwd"),
                      train_results["fwd"], train_results["fwd"][-1],
                      bilstmp_fwd_bound(S, T, D, C, P),
                      **redesigned("bilstmp_train_fwd")),
        kernel_record("bilstmp_train_bwd", "bilstmp_train.cu",
                      "lstm_pallas.py:1261", launched("bilstmp_train_bwd"),
                      train_results["bwd"], train_results["bwd"][-1],
                      bilstmp_bwd_bound(S, T, D, C, P),
                      **redesigned("bilstmp_train_bwd")),
        kernel_record("ctc_alpha_beta/alpha", "ctc_alpha_beta.cu",
                      "ctc_pallas.py:44", launched("ctc_alpha_beta"),
                      [ctc, recipe_ctc],
                      ctc, (ctc["bound_ms"], ctc["bound_by"]),
                      ctc["library_ms"], **ctc_extra),
        kernel_record("ctc_alpha_beta/beta", "ctc_alpha_beta.cu",
                      "ctc_pallas.py:65", launched("ctc_alpha_beta"),
                      [ctc, recipe_ctc],
                      ctc, (ctc["bound_ms"], ctc["bound_by"]),
                      ctc["library_ms"], **ctc_extra),
    ]
    for kind, line in (("fwd", 198), ("bwd", 234)):
        rows = lstm_results[kind]
        # timed at the reference's default chunk, float32 as the model
        timed = next(r for r in rows if (r["S"], r["T"], r["bf16"]) ==
                     (*BPTT_SPLIT_SHAPE, False))
        sp = lstm_results["redesign"][kind]
        records.append(kernel_record(
            f"lstmp_train_{kind}", "lstmp_train.cu", f"lstm_pallas.py:{line}",
            {"bptt": bptt_launches[f"lstmp_train_{kind}"],
             "lc_train": zoo_launches["lc_train"][f"lstmp_train_{kind}"],
             "distributed_workers": dist_workers[f"lstmp_train_{kind}"]},
            rows, timed,
            lstmp_train_bound(kind, *BPTT_SPLIT_SHAPE, HYBRID_C, HYBRID_P,
                              False),
            sweep_ms=sp["sweep_ms"], rest_ms=sp["rest_ms"],
            time_split_source=sp["source"]))
    for kind, line, fn in (("fwd", 561, xg_fwd_bound),
                           ("bwd", 618, xg_bwd_bound)):
        # timed at the bench's shape with bf16 products (NO_XFUSE's mode);
        # the float32-products figures (MXU_FP32's) beside them
        f32 = xg[kind, False]
        tc, fma = (xg_results["redesign"][kind, m] for m in (True, False))
        records.append(kernel_record(
            f"bilstmp_xg_train_{kind}", "bilstmp_xg_train.cu",
            f"lstm_pallas.py:{line}", launched(f"bilstmp_xg_train_{kind}"),
            xg_results[kind], xg[kind, True], fn(S, T, C, P, True),
            sweep_ms=tc["sweep_ms"], gemm_ms=tc["gemm_ms"],
            per_step_ms=tc["per_step_ms"], time_split_source=tc["source"],
            ms_f32_products=f32["ms"], plain_ms_f32_products=f32["plain_ms"],
            bound_ms_f32_products=fn(S, T, C, P, False)[0],
            sweep_ms_f32_products=fma["sweep_ms"],
            per_step_ms_f32_products=fma["per_step_ms"]))
    records.append(kernel_record(
        "bilstmp_train_bwd_dir", "bilstmp_train.cu", "lstm_pallas.py:1154",
        launched("bilstmp_train_bwd_dir"), xg_results["bwd_dir"],
        xg_results["bwd_dir"][-1], bilstmp_bwd_bound(S, T, D, C, P, dirs=1),
        **redesigned("bilstmp_train_bwd_dir")))
    missing = [r["name"] for r in records if not r["launches"]]
    if missing:
        raise RuntimeError(f"no CLI run launched {missing}")
    return records


if __name__ == "__main__":
    sys.exit(main())
