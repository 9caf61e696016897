"""Batched CTC loss: log-space alpha-beta over expanded label sequences.

Port of kaldi_aslp_tpu/ops/ctc.py (reference: src/aslp-nnet/ctc-loss.cc:115
EvalParallel, label expansion at :134-149).  Blank id 0 by default.

  - ``expand_labels`` and ``_transition_mask`` build the expanded label
    sequence l' (U' = 2U + 1) and the states a skip may enter;
  - ``ctc_alpha_beta`` gathers the emission scores and runs the two
    recursions through ops/ctc_recursions.py: on a CUDA tensor one launch
    of the hand CUDA kernel for both (a warp per stream and recursion,
    the state in registers), on a CPU tensor the plain loops over T (the
    equations of the JAX scan, ops/ctc.py:63-159, ``_lse3`` included);
  - ``CtcLoss`` is the ``torch.autograd.Function`` counterpart of the JAX
    custom VJP: its backward is the occupancy formula
    dL/dlogit = softmax(logit) - gamma (ops/ctc.py:229-255), plain torch
    ops, as the JAX package computes it outside any kernel;
  - ``ctc_greedy_decode`` and ``collapse_ctc_path`` are the best-path
    decode (ops/ctc.py:261-277): argmax frames on the device, repeats and
    blanks removed on the host."""

from __future__ import annotations

from typing import Iterable, List

import torch

from kaldi_aslp_tpu_torch.ops import ctc_recursions as recursions
from kaldi_aslp_tpu_torch.ops.ctc_recursions import NEG_INF


def expand_labels(labels: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """[S, U] -> [S, 2U+1] with blanks interleaved
    (reference: ctc-loss.cc:134-149)."""
    S, U = labels.shape
    exp = torch.full((S, 2 * U + 1), blank, dtype=labels.dtype,
                     device=labels.device)
    exp[:, 1::2] = labels
    return exp


def _transition_mask(exp_labels: torch.Tensor, blank: int) -> torch.Tensor:
    """[S, U'] mask: 1 where the skip transition u-2 -> u is allowed
    (l'_u != blank and l'_u != l'_{u-2})."""
    prev2 = torch.nn.functional.pad(exp_labels[:, :-2], (2, 0), value=-1)
    return ((exp_labels != blank) & (exp_labels != prev2)).float()


def ctc_emissions(log_probs: torch.Tensor, labels: torch.Tensor,
                  label_lengths: torch.Tensor, blank: int = 0):
    """The recursions' inputs: (lp_t [T, S, U'] emission scores, NEG_INF
    past each stream's expanded length; skip_ok [S, U'] masked to the
    valid states; exp_labels [S, U']; valid_u [S, U']; exp_lens [S]
    int32)."""
    S, T, V = log_probs.shape
    exp_labels = expand_labels(labels, blank)
    Up = exp_labels.shape[1]
    exp_lens = (2 * label_lengths + 1).to(torch.int32)
    u_idx = torch.arange(Up, device=log_probs.device)[None, :]
    valid_u = (u_idx < exp_lens[:, None]).float()
    skip_ok = (_transition_mask(exp_labels, blank) * valid_u).contiguous()
    lp = torch.gather(log_probs, 2,
                      exp_labels.long()[:, None, :].expand(S, T, Up))
    lp = torch.where(valid_u[:, None, :] > 0, lp, NEG_INF)
    return lp.transpose(0, 1).contiguous(), skip_ok, exp_labels, valid_u, \
        exp_lens


def ctc_alpha_beta(log_probs: torch.Tensor, labels: torch.Tensor,
                   input_lengths: torch.Tensor,
                   label_lengths: torch.Tensor, blank: int = 0):
    """Returns (neg_log_p [S], alphas [T, S, U'], betas [T, S, U'],
    lp_t [T, S, U'], exp_labels [S, U'], valid_u [S, U'])."""
    S, T, V = log_probs.shape
    lp_t, skip_ok, exp_labels, valid_u, exp_lens = ctc_emissions(
        log_probs, labels, label_lengths, blank)
    in_lens = input_lengths.to(torch.int32)
    u_idx = torch.arange(lp_t.shape[2], device=log_probs.device)[None, :]
    alphas, betas = recursions.ctc_alpha_beta(lp_t, skip_ok, in_lens,
                                              exp_lens)
    last_t = (in_lens.long() - 1).clamp(0, T - 1)
    alpha_last = alphas[last_t, torch.arange(S, device=log_probs.device)]
    at_end = torch.where((u_idx == exp_lens[:, None] - 1)
                         | (u_idx == exp_lens[:, None] - 2),
                         alpha_last, NEG_INF)
    nll = -torch.logsumexp(at_end, dim=1)
    return nll, alphas, betas, lp_t, exp_labels, valid_u


class CtcLoss(torch.autograd.Function):
    """Per-sequence CTC negative log-likelihood of raw network outputs
    ``logits [S, T, V]`` (softmax applied inside, as the reference
    trainer feeds pre-softmax activations to Ctc::EvalParallel)."""

    @staticmethod
    def forward(ctx, logits, labels, input_lengths, label_lengths,
                blank=0):
        log_probs = torch.log_softmax(logits.float(), dim=-1)
        nll, alphas, betas, lp_t, exp_labels, valid_u = ctc_alpha_beta(
            log_probs, labels, input_lengths, label_lengths, blank)
        ctx.save_for_backward(log_probs, alphas, betas, lp_t, exp_labels,
                              valid_u, input_lengths, nll)
        return nll

    @staticmethod
    def backward(ctx, g):
        (log_probs, alphas, betas, lp_t, exp_labels, valid_u,
         input_lengths, nll) = ctx.saved_tensors
        S, T, V = log_probs.shape
        # occupancy gamma_t(u) = exp(alpha + beta - lp - logp)
        occ = alphas + betas - lp_t + nll[None, :, None]
        occ = torch.where(valid_u[None] > 0, occ, NEG_INF)
        gamma_u = torch.exp(occ.transpose(0, 1))                 # [S,T,U']
        # fold label occupancies into the vocabulary, as a one-hot
        # product like the JAX package (padded u carry gamma = 0)
        one_hot = torch.nn.functional.one_hot(
            exp_labels.long(), V).to(log_probs.dtype)             # [S,U',V]
        gamma_v = torch.bmm(gamma_u, one_hot)
        grad = torch.exp(log_probs) - gamma_v
        t_mask = (torch.arange(T, device=log_probs.device)[None, :]
                  < input_lengths[:, None])
        grad = grad * t_mask[:, :, None] * g[:, None, None]
        return grad, None, None, None, None


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor,
             input_lengths: torch.Tensor, label_lengths: torch.Tensor,
             blank: int = 0) -> torch.Tensor:
    """Per-sequence CTC negative log-likelihood [S]."""
    return CtcLoss.apply(logits, labels, input_lengths, label_lengths, blank)



def ctc_greedy_decode(logits: torch.Tensor, input_lengths=None,
                      blank: int = 0) -> torch.Tensor:
    """Best-path frames (reference: ctc-loss.cc:346 ErrorRate path):
    [S, T, V] -> [S, T] argmax (the first maximum at a tie, as
    ``jnp.argmax``); :func:`collapse_ctc_path` turns a row into labels."""
    return torch.argmax(logits, dim=-1)


def collapse_ctc_path(path: Iterable, length, blank: int = 0) -> List[int]:
    """The labels of a best path's first ``length`` frames: repeats
    merged, then blanks removed (host-side, any sequence of ints)."""
    out = []
    prev = None
    for v in list(path)[: int(length)]:
        v = int(v)
        if v != prev and v != blank:
            out.append(v)
        prev = v
    return out
