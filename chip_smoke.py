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
 15. beam     - the recipe's dev and test sets decoded by the beam
                decoder at the ladder's settings (beam 32, K=2048) on the
                card, each utterance held to the same decode on the CPU
                (the same words and alignment, the score within 1e-3
                relative) and timed; the test set at a wide beam with K
                past the graph's states held to the dense Viterbi's words
                on the card, both timed; one utterance's kernel launches
                a frame and device time by torch.profiler; no hand kernel
                may launch;
 16. budget-sweep - the port's nn_budget_sweep on the same recipe (dev
                WER at K = 2048, 1024, 512, 256), each K timed;
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
 18. lattice-score - decode_wer_dev_test on the beam phase's dev and test
                sets at the ladder's decode settings (beam 32, K = 2048,
                lattice beam 8, LMWT 4..15) on the card: the same lattices
                and WER at every LMWT as the CPU's, every lattice holding
                the decoder's best path, one decode's launches a frame.
                Both lattice phases run their CPU side in a child process
                beside the card's (lattice_cpu_child).
The last lines are the kernels' JSON record (each kernel's launches in
the CLI runs, its error, its time and its plain version's, the least
time the card could take for its work and what binds it, and a PyTorch
call's time where one computes the same function), the card's name and
power limit as nvidia-smi prints them, and the result line.

Imports nothing of JAX and nothing of kaldi_aslp_tpu."""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

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
# that holds the beam decoder to the dense Viterbi; the sweep's budgets
# (kaldi_aslp_tpu/recipes/decode_budget_sweep.py:97)
BEAM_SCORE_RTOL = 1e-3
WIDE_BEAM = 1e9
BUDGETS = (2048, 1024, 512, 256)
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
# card vs CPU: MFCC + deltas + CMVN as the fbank tests hold them; a
# training step's loss relative and gradients relative to each
# parameter's largest |gradient| (float32, TF32 off); log posteriors
RECIPE_FEAT_TOL = dict(rtol=1e-4, atol=1e-4)
RECIPE_LOSS_RTOL, RECIPE_GRAD_RTOL, RECIPE_POST_ATOL = 1e-4, 1e-3, 1e-4
RECIPE_SPLIT_REPS = 5


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


def lstmp_forward_bound(S, T, C, P, directions=1):
    # per direction in: xg [S, T, G], W_r [G, P], W_rm [P, C], peep [3, C];
    # out: its columns of ys [S, T, P]; once: mask, c0, r0 in, c_T, r_T
    # out; all float32.  Per direction, frame and stream r_prev . W_r^T and
    # m . W_rm^T: 2 (GP + PC) float32 FLOP
    G = 4 * C
    nbytes = 4 * (directions * (S * T * (G + P) + G * P + P * C + 3 * C)
                  + S * T + 2 * S * (C + P))
    return bound([(directions * 2 * S * T * (G * P + P * C), PEAK_F32)],
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

    pcms = [synth_pcm(i, 3.0 + 0.25 * i) for i in range(4)]

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
    return launches, recorded


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
    from kaldi_aslp_tpu_torch.ops import ctc_alpha_beta as cab

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
    from kaldi_aslp_tpu_torch.ops import ctc_alpha_beta as cab

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
    from kaldi_aslp_tpu_torch.ops import ctc_alpha_beta as cab
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


def train_counts():
    """Every training kernel's wrapper, by name."""
    from kaldi_aslp_tpu_torch.ops import (
        bilstmp_train,
        bilstmp_xg_train,
        ctc_alpha_beta,
        lstmp_train,
    )
    return {"bilstmp_train_fwd": bilstmp_train.bilstmp_train_fwd,
            "bilstmp_train_bwd": bilstmp_train.bilstmp_train_bwd,
            "bilstmp_train_bwd_dir": bilstmp_train.bilstmp_train_bwd_dir,
            "bilstmp_xg_train_fwd": bilstmp_xg_train.bilstmp_xg_train_fwd,
            "bilstmp_xg_train_bwd": bilstmp_xg_train.bilstmp_xg_train_bwd,
            "lstmp_train_fwd": lstmp_train.lstmp_train_fwd,
            "lstmp_train_bwd": lstmp_train.lstmp_train_bwd,
            "ctc_alpha_beta": ctc_alpha_beta.ctc_alpha_beta}


def train_phase(model, feats, labels, workdir, switch=None):
    """The CTC CLI's run, with ``switch`` set (None: no switch)."""
    from kaldi_aslp_tpu_torch.cli.__main__ import main as cli_main
    from kaldi_aslp_tpu_torch.models import Nnet
    from kaldi_aslp_tpu_torch.ops.lstmp import lstmp_forward
    from kaldi_aslp_tpu_torch.train.trainer import CtcTrainer

    wrappers = train_counts()
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
    wrappers = train_counts()
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
    from kaldi_aslp_tpu_torch.ops import ctc_alpha_beta as cab
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
    from kaldi_aslp_tpu_torch.ops.ctc_alpha_beta import plan_for
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


def hand_kernel_wrappers():
    """Every hand kernel's wrapper, by name."""
    from kaldi_aslp_tpu_torch.ops.lstmp import blstmp_forward, lstmp_forward
    return {**train_counts(), "lstmp_forward": lstmp_forward,
            "blstmp_forward": blstmp_forward}


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
    wrappers = hand_kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    card_ms, cpu_ms, frames, worst, failed = [], [], 0, 0.0, 0
    for key, m in loglikes.items():
        got, ms = timed_decode(card, m)
        want, ms_cpu = timed_decode(cpu, m)
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
    for i in range(LATGEN_UTTS):
        pcm = np.frombuffer(synth_pcm(i, 3.0 + 0.25 * i), "<i2")
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
        ll = {u: rec.posteriors(x) - rec.log_priors
              for u, x in corpus[f"{split}_feats"].items()}
        refs = {u: [rec.lang.words.id(w) for w in t]
                for u, t in corpus[f"{split}_texts"].items()}
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


NO_LIBRARY = ("no PyTorch call computes a peephole LSTMP with cell "
              "clipping (torch.nn.LSTM with proj_size has neither)")


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
        ctc_alpha_beta,
        lstmp,
        lstmp_train,
    )

    t0 = time.perf_counter()
    modules = (lstmp, bilstmp_train, ctc_alpha_beta, lstmp_train,
               bilstmp_xg_train)
    with ThreadPoolExecutor(len(modules)) as pool:
        for future in [pool.submit(m.build) for m in modules]:
            future.result()
    log("build", seconds=time.perf_counter() - t0,
        libraries=[build.library_path(m.SOURCE).name for m in modules])

    kernel_results = kernel_phase(dev)
    with tempfile.TemporaryDirectory() as workdir:
        paths = write_model_and_graph(workdir)
        launches, recorded = slice_phase(paths, "cuda")
        cross_check(paths, recorded)
        train_results = train_kernel_phase(dev)
        xg_results = xg_train_kernel_phase(dev)
        model, feats, labels = write_train_files(workdir)
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
        bptt_launches = bptt_train_phase(model, feats, targets, workdir)
        bptt_cross_check(model, feats, targets)
        bptt_step_split(model, dev)
        (runs["ctc_recipe"], recipe_wide, recipe_ctc, rec,
         corpus) = ctc_recipe_phase(workdir)
        beam_phase(rec, corpus)
        budget_sweep_phase(rec, corpus)
        t0 = time.perf_counter()
        latgen_launches = latgen_phase(paths, workdir)
        log("latgen_phase", seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        lattice_score_phase(rec, corpus, workdir)
        log("lattice_score_phase", seconds=time.perf_counter() - t0)
    records = kernel_records(launches, runs, bptt_launches, kernel_results,
                             train_results, xg_results, lstm_results,
                             recipe_wide, recipe_ctc, latgen_launches)
    log("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def kernel_records(serving_launches, runs, bptt_launches, kernel_results,
                   train_results, xg_results, lstm_results, recipe_wide,
                   recipe_ctc, latgen_launches):
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
                      {"serving": serving_launches,
                       "bptt_cv": bptt_launches["lstmp_forward_cv"],
                       "latgen": latgen_launches},
                      kernel_results, served[2],
                      (served[2]["bound_ms"], served[2]["bound_by"]),
                      timed_at="S, T = 1, 16, both directions of a BLSTMP "
                      "layer in one launch (the served chunk's call)",
                      one_direction={k: served[1][k] for k in
                                     ("ms", "plain_ms", "bound_ms",
                                      "per_step_ms")},
                      per_step_ms=served[2]["per_step_ms"]),
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
            {"bptt": bptt_launches[f"lstmp_train_{kind}"]}, rows, timed,
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
