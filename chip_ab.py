#!/usr/bin/env python3
"""Compare two checkouts of this repository on one NVIDIA card, in turns.

    python3 chip_ab.py TREE_A TREE_B [ROUNDS]

Each tree is a directory holding ``chip_smoke.py`` and the port's package
(for example two ``git archive`` unpackings).  For ROUNDS rounds (default
4) and each tree in turn (A B, then B A, ...), a fresh process in that
tree builds the unidirectional LSTMP training kernels, times them at the
LSTM hybrid's BPTT chunk (S=100, T=20, C=800, P=512, float32; CUDA
events, median of 20) and splits three BPTT steps by phase
(``chip_smoke.bptt_step_split``);
then builds the x-fused BLSTMP training kernels and times them at the CTC
bench's shape (S=128, T=400, D=640, C=512, P=320, ragged mask; CUDA
events, median of 10), with their outputs' SHA-256 digests, which must
agree between two trees whose kernels give the same bits; then the CTC
loss at the bench's shape (S=128, T=400, U=40, V=72, ragged lengths):
``ops/ctc.py:ctc_alpha_beta`` (the emission gather and both recursions)
and ``ctc_loss`` forward and backward, by CUDA events (median of 20),
through each tree's own CTC kernels.
One JSON line a reading.  The step is partly host-bound and a shared
host drifts, so two versions compare only like this: on one card, in one
process tree, alternating.

    python3 chip_ab.py --decode TREE_A TREE_B [ROUNDS]

compares the decoders instead.  Each reading builds the serving model and
graph (``chip_smoke.write_model_and_graph``) and splits a warm session's
16-frame chunks three times (``chip_smoke.chunk_split``, the served
chunk's dense Viterbi among its parts); then decodes the CTC recipe's dev
and test posteriors (the first reading trains the recipe as the beam
phase does, ``chip_smoke.recipe_phase``, and keeps its graph and
posteriors for every later reading, so both trees decode the same
inputs) one utterance at a time with the beam decoder at the ladder's
settings and with the dense Viterbi (host wall ms after a synchronise,
mean over the utterances), with the results' SHA-256 (equal between two
trees whose decoders give the same words, alignments and scores) and the
launches a frame of the longest test utterance by torch.profiler.

Imports nothing of JAX and nothing of kaldi_aslp_tpu."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

CHILD = r'''
import json, sys, tempfile
import torch
import chip_smoke as cs
from kaldi_aslp_tpu_torch.ops import lstmp_train as lt

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
fwd_args, bwd_args, _, _ = cs.lstm_train_kernel_check(
    dev, *cs.BPTT_SPLIT_SHAPE, False)
cs.log("ab_kernels",
       lstmp_train_fwd_ms=cs.cuda_ms(
           lambda: lt.lstmp_train_fwd(*fwd_args), 20, 2),
       lstmp_train_bwd_ms=cs.cuda_ms(
           lambda: lt.lstmp_train_bwd(*bwd_args), 20, 2))
with tempfile.TemporaryDirectory() as workdir:
    model, _, _ = cs.write_bptt_files(workdir)
    for _ in range(3):
        cs.bptt_step_split(model, dev)

import hashlib
import numpy as np
from kaldi_aslp_tpu_torch.ops import bilstmp_train as bt

S, T, D = cs.TRAIN_SHAPES[-1]
C, P, G, bf16 = cs.C, cs.P, 4 * cs.C, torch.bfloat16
rs = np.random.RandomState(S * 1000 + T + D)
def t(a):
    return torch.from_numpy(a).to(dev)
lens = rs.randint(T // 4, T + 1, size=S)
lens[0] = T
mask = t((np.arange(T)[None, :] < lens[:, None]).astype(np.float32))
fwd_args = (t(rs.randn(S, T, D).astype(np.float32)).to(bf16), mask,
            t(cs.uniform(rs, 2, G, D)).to(bf16),
            t(cs.uniform(rs, 2, G, P)).to(bf16),
            t(cs.uniform(rs, 2, P, C)).to(bf16), t(cs.uniform(rs, 2, 3, C)),
            t(cs.uniform(rs, 2, G)), t(cs.uniform(rs, S, C, scale=0.5)),
            t(cs.uniform(rs, S, P, scale=0.5)))
x, _, wx, wr, wrm, peep, _, init_c, _ = fwd_args
fwd = bt.bilstmp_train_fwd(*fwd_args)
_, gates, cs_, rprev, _, _ = fwd
bwd_args = (t(rs.randn(S, T, 2 * P).astype(np.float32)).to(bf16), mask, x,
            gates, cs_, rprev, wx, wr, wrm, peep, init_c,
            t(rs.randn(S, C).astype(np.float32)),
            t(rs.randn(S, P).astype(np.float32)))
bwd = bt.bilstmp_train_bwd(*bwd_args)
digest = hashlib.sha256()
for out in (*fwd, *bwd):
    digest.update(out.contiguous().view(torch.uint8).cpu().numpy().tobytes())
cs.log("ab_x_fused", S=S, T=T, D=D, outputs_sha256=digest.hexdigest(),
       bilstmp_train_fwd_ms=cs.cuda_ms(
           lambda: bt.bilstmp_train_fwd(*fwd_args), 10, 2),
       bilstmp_train_bwd_ms=cs.cuda_ms(
           lambda: bt.bilstmp_train_bwd(*bwd_args), 10, 2))

from kaldi_aslp_tpu_torch.ops import ctc

S, T, U, V = cs.CTC_SHAPE
rs = np.random.RandomState(7)
lab_lens = rs.randint(U // 4, U + 1, size=S).astype(np.int32)
in_lens = rs.randint(T // 2, T + 1, size=S).astype(np.int32)
lab_lens[0], in_lens[0] = U, T
in_lens = np.maximum(in_lens, 2 * lab_lens + 1).astype(np.int32)
logits = t(rs.randn(S, T, V).astype(np.float32)).requires_grad_()
labels, in_lens, lab_lens = (t(a) for a in (
    rs.randint(1, V, (S, U)).astype(np.int32), in_lens, lab_lens))
log_probs = torch.log_softmax(logits.detach(), -1)
def loss():
    logits.grad = None
    ctc.ctc_loss(logits, labels, in_lens, lab_lens).sum().backward()
cs.log("ab_ctc", S=S, T=T, U=U, V=V,
       ctc_alpha_beta_ms=cs.cuda_ms(lambda: ctc.ctc_alpha_beta(
           log_probs, labels, in_lens, lab_lens), 20, 2),
       ctc_loss_ms=cs.cuda_ms(loss, 20, 2))
'''

DECODE_CHILD = r'''
import dataclasses, hashlib, os, tempfile
import numpy as np
import torch
import chip_smoke as cs
from kaldi_aslp_tpu_torch.cli.online_tools import session_factory_from_argv
from kaldi_aslp_tpu_torch.decoder.beam import BeamSearchDecoder, CsrGraph
from kaldi_aslp_tpu_torch.decoder.viterbi import PackedGraph, ViterbiDecoder
from kaldi_aslp_tpu_torch.fst import ctc_lut

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
data = os.environ["CHIP_AB_DECODE_DATA"]
with tempfile.TemporaryDirectory() as workdir:
    factory = session_factory_from_argv(
        ["--device=cuda", f"--num-mel-bins={cs.FEAT_DIM}",
         *cs.write_model_and_graph(workdir)])
    pcm = cs.synth_pcm(0, 3.0)
    for _ in range(3):
        cs.chunk_split(factory, pcm)
    if not os.path.exists(data):
        corpus = cs.recipe_corpus_phase()
        rec = cs.recipe_phase(corpus, workdir)[0]
        test = sorted(corpus["test_feats"])
        np.savez(data, num_outputs=rec.num_outputs, n_test=len(test),
                 **dataclasses.asdict(PackedGraph.from_fst(rec.tlg)),
                 **{f"ll{i}": rec.acoustic_scale * (
                     rec.posteriors(feats[u]) - rec.log_priors)
                    for i, (feats, u) in enumerate(
                        [(corpus["dev_feats"], u)
                         for u in sorted(corpus["dev_feats"])]
                        + [(corpus["test_feats"], u) for u in test])})
z = np.load(data)
packed = PackedGraph(**{f.name: z[f.name] for f in
                        dataclasses.fields(PackedGraph)})
packed.start, packed.num_states, packed.eps_diameter = (
    int(packed.start), int(packed.num_states), int(packed.eps_diameter))
lut = ctc_lut(int(z["num_outputs"]))
loglikes = [z[f"ll{i}"] for i in range(sum(k.startswith("ll") for k in z))]
longest = max(loglikes[-int(z["n_test"]):], key=len)
decoders = {
    "beam": BeamSearchDecoder(
        CsrGraph.from_packed(packed), lut,
        beam=cs.RECIPE_OPTS["decode_beam"],
        max_active=cs.RECIPE_OPTS["decode_max_active"]),
    "dense": ViterbiDecoder(packed, lut)}
frames = sum(len(m) for m in loglikes)
for name, dec in decoders.items():
    cs.timed_decode(dec, loglikes[0])
    digest, ms = hashlib.sha256(), []
    for m in loglikes:
        out, t = cs.timed_decode(dec, m)
        ms.append(t)
        if out is not None:
            digest.update(repr((out[0], out[1].tolist(), out[2])).encode())
    counts = {}
    cs.device_ms_by_kernel(lambda: dec.decode(longest), counts)
    launches = sum(n for k, n in counts.items()
                   if not k.startswith(("Memcpy", "Memset")))
    cs.log("ab_decode", decoder=name, utts=len(ms), frames=frames,
           ms_per_utt=float(np.mean(ms)), ms_per_frame=sum(ms) / frames,
           results_sha256=digest.hexdigest(), profiled_T=len(longest),
           launches_per_frame=launches / len(longest),
           card=cs.smi_name_and_power())
'''


def main(argv) -> int:
    child_code = CHILD
    if len(argv) > 1 and argv[1] == "--decode":
        child_code, argv = DECODE_CHILD, argv[:1] + argv[2:]
    if len(argv) not in (3, 4):
        print(__doc__, file=sys.stderr)
        return 2
    trees, rounds = argv[1:3], int(argv[3]) if len(argv) == 4 else 4
    data = tempfile.TemporaryDirectory()
    env = dict(os.environ,
               CHIP_AB_DECODE_DATA=os.path.join(data.name, "decode.npz"))
    for round_ in range(rounds):
        # A B, B A, A B, ...: neither tree always runs first
        for tree in trees[::-1] if round_ % 2 else trees:
            child = subprocess.run([sys.executable, "-c", child_code],
                                   cwd=tree, env=env, capture_output=True,
                                   text=True)
            if child.returncode != 0:
                print(child.stderr[-2000:], file=sys.stderr)
                return child.returncode
            for line in child.stdout.splitlines():
                if line.startswith("{"):
                    reading = json.loads(line)
                    print(json.dumps({"tree": tree, "round": round_,
                                      **reading}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
