#!/usr/bin/env python3
"""Compare two checkouts of this repository on one NVIDIA card, in turns.

    python3 chip_ab.py TREE_A TREE_B [ROUNDS]

Each tree is a directory holding ``chip_smoke.py`` and the port's package
(for example two ``git archive`` unpackings).  For ROUNDS rounds (default
4) and each tree in turn, a fresh process in that tree builds the
unidirectional LSTMP training kernels, times them at the LSTM hybrid's
BPTT chunk (S=100, T=20, C=800, P=512, float32; CUDA events, median of
20) and splits three BPTT steps by phase (``chip_smoke.bptt_step_split``);
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

Imports nothing of JAX and nothing of kaldi_aslp_tpu."""

from __future__ import annotations

import json
import subprocess
import sys

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


def main(argv) -> int:
    if len(argv) not in (3, 4):
        print(__doc__, file=sys.stderr)
        return 2
    trees, rounds = argv[1:3], int(argv[3]) if len(argv) == 4 else 4
    for round_ in range(rounds):
        for tree in trees:
            child = subprocess.run([sys.executable, "-c", CHILD], cwd=tree,
                                   capture_output=True, text=True)
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
