"""Linear-chain CRF: forward-algorithm training + Viterbi tagging.

Port of kaldi_aslp_tpu/ops/crf.py (``CrfParams``, ``init_crf``,
``crf_log_likelihood``, ``crf_viterbi``, ``crf_train``, ``crf_tag``;
the reference binds CRF++, src/aslp-online/punctuation-processor.{h,cc},
gated by HAVE_CRF in src/aslp.mk:9-12).  Hashed window features index an
emission table, a [Y, Y] transition matrix links the tags, the exact
log-likelihood comes from the forward recursion (a loop over frames
with the masked carry), so training is autograd and plain SGD, and
Viterbi decoding is a second loop.  Sequences are padded to 32-frame
buckets and masked as in JAX; the padding's result is a no-op.

``init_crf`` draws from a ``torch.Generator`` where JAX takes a key, so
the two packages start from different parameters;
:func:`crf_params_from_jax` carries JAX's ``CrfParams`` (as numpy) over."""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.utils.device import resolve_device

NEG = -1e30     # JAX's "minus infinity" of a score (kaldi_aslp_tpu/ops/crf.py)


@dataclasses.dataclass
class CrfParams:
    emission: torch.Tensor    # [F, Y] hashed-feature weights
    transition: torch.Tensor  # [Y, Y] from -> to
    start: torch.Tensor       # [Y]
    end: torch.Tensor         # [Y]

    def fields(self) -> Tuple[torch.Tensor, ...]:
        return (self.emission, self.transition, self.start, self.end)

    def to(self, device: Union[str, torch.device]) -> "CrfParams":
        return CrfParams(*(p.to(device) for p in self.fields()))

    def numpy(self) -> dict:
        """The four arrays as numpy, keyed by field name (the
        punctuation model's file, online/punctuation.py)."""
        return {f.name: getattr(self, f.name).detach().cpu().numpy()
                for f in dataclasses.fields(self)}


def crf_params_from_jax(params: Union[Mapping, object],
                        device: Union[str, torch.device] = "cuda"
                        ) -> CrfParams:
    """JAX ``CrfParams`` (or a dict of its four arrays, numpy or
    anything ``np.asarray`` takes) -> the port's, float32 on ``device``."""
    dev = resolve_device(device)

    def get(name):
        val = (params[name] if isinstance(params, Mapping)
               else getattr(params, name))
        return torch.from_numpy(np.array(val, np.float32)).to(dev)

    return CrfParams(*(get(f.name) for f in dataclasses.fields(CrfParams)))


def init_crf(num_features: int, num_tags: int,
             generator: Optional[torch.Generator] = None,
             device: Union[str, torch.device] = "cuda") -> CrfParams:
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    emission = 0.01 * torch.randn((num_features, num_tags),
                                  generator=generator)
    transition = 0.01 * torch.randn((num_tags, num_tags),
                                    generator=generator)
    return CrfParams(emission, transition, torch.zeros(num_tags),
                     torch.zeros(num_tags)).to(resolve_device(device))


def _emissions(params: CrfParams, feat_ids: torch.Tensor) -> torch.Tensor:
    """[T, K] hashed feature ids (-1 = absent) -> [T, Y] scores."""
    w = params.emission[feat_ids.clamp(min=0)]          # [T, K, Y]
    w = torch.where((feat_ids >= 0)[:, :, None], w, 0.0)
    return w.sum(dim=1)


def crf_log_likelihood(params: CrfParams, feat_ids: torch.Tensor,
                       tags: torch.Tensor, mask: torch.Tensor
                       ) -> torch.Tensor:
    """Exact sequence log-likelihood (masked frames are no-ops)."""
    em = _emissions(params, feat_ids)                   # [T, Y]
    T = em.shape[0]
    tags = tags.long()
    mask = mask.to(em.dtype)

    # score of the reference path
    tag_scores = em[torch.arange(T, device=em.device), tags] * mask
    trans_scores = (params.transition[tags[:-1], tags[1:]]
                    * mask[1:] * mask[:-1])
    path = params.start[tags[0]] + tag_scores.sum() + trans_scores.sum()
    last = (mask.sum().to(torch.long) - 1).clamp(min=0)
    path = path + params.end[tags[last]]

    # partition function
    alpha = params.start + em[0]
    valid = (mask > 0).unbind(0)
    for t in range(1, T):
        new = torch.logsumexp(alpha[:, None] + params.transition,
                              dim=0) + em[t]
        alpha = torch.where(valid[t], new, alpha)
    logz = torch.logsumexp(alpha + params.end, dim=0)
    return path - logz


@torch.no_grad()
def crf_viterbi(params: CrfParams, feat_ids: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Best tag sequence [T] (entries beyond the mask are arbitrary).
    ``argmax`` takes the first maximum, as ``jnp.argmax`` does."""
    em = _emissions(params, feat_ids)
    T, Y = em.shape
    ident = torch.arange(Y, device=em.device)
    valid = (mask > 0).unbind(0)
    alpha = params.start + em[0]
    bps = []
    for t in range(1, T):
        scores = alpha[:, None] + params.transition     # [from, to]
        best, bp = scores.amax(dim=0), scores.argmax(dim=0)
        alpha = torch.where(valid[t], best + em[t], alpha)
        bps.append(torch.where(valid[t], bp, ident))
    tag = torch.argmax(alpha + params.end)
    out = [tag]
    for bp in reversed(bps):
        tag = bp[tag]
        out.append(tag)
    return torch.stack(out[::-1])


def _pad(feat_ids: np.ndarray, tags: Optional[np.ndarray], bucket: int,
         device: torch.device):
    """(feat_ids, tags, mask) padded to a multiple of ``bucket`` frames,
    as tensors on ``device``."""
    T = len(feat_ids)
    Tp = max(bucket, int(np.ceil(T / bucket)) * bucket)
    fi = np.full((Tp, feat_ids.shape[1]), -1, np.int64)
    fi[:T] = feat_ids
    tg = np.zeros(Tp, np.int64)
    if tags is not None:
        tg[:T] = tags
    m = np.zeros(Tp, np.float32)
    m[:T] = 1.0
    return tuple(torch.from_numpy(a).to(device) for a in (fi, tg, m))


def crf_loss(params: CrfParams, feat_ids: torch.Tensor, tags: torch.Tensor,
             mask: torch.Tensor, l2: float = 1e-4) -> torch.Tensor:
    """The training objective: -log-likelihood + l2 (|E|^2 + |W|^2)."""
    ll = crf_log_likelihood(params, feat_ids, tags, mask)
    reg = l2 * ((params.emission ** 2).sum()
                + (params.transition ** 2).sum())
    return -ll + reg


def crf_train(
    corpus: Sequence[Tuple[np.ndarray, np.ndarray]],
    num_features: int,
    num_tags: int,
    num_epochs: int = 30,
    learn_rate: float = 0.5,
    l2: float = 1e-4,
    bucket: int = 32,
    seed: int = 0,
    device: Union[str, torch.device] = "cuda",
) -> CrfParams:
    """SGD on the exact negative log-likelihood, one sequence a step.

    ``corpus``: list of (feat_ids [T, K] int32 with -1 padding, tags [T]
    int32).  The epochs visit the corpus in a ``RandomState(seed)``
    shuffle, the learning rate decays as learn_rate / (1 + 0.3 epoch),
    as in JAX; the initial parameters come from a generator seeded
    ``seed``."""
    dev = resolve_device(device)
    params = init_crf(num_features, num_tags,
                      torch.Generator().manual_seed(seed), dev)
    for p in params.fields():
        p.requires_grad_(True)
    batches = [_pad(f, t, bucket, dev) for f, t in corpus]
    rng = np.random.RandomState(seed)
    order = np.arange(len(corpus))
    for epoch in range(num_epochs):
        rng.shuffle(order)
        lr = learn_rate / (1.0 + 0.3 * epoch)
        for idx in order:
            loss = crf_loss(params, *batches[idx], l2=l2)
            grads = torch.autograd.grad(loss, params.fields())
            with torch.no_grad():
                for p, g in zip(params.fields(), grads):
                    p.sub_(lr * g)
    return CrfParams(*(p.detach() for p in params.fields()))


def crf_tag(params: CrfParams, feat_ids: np.ndarray,
            bucket: int = 32) -> np.ndarray:
    """[T, K] feature ids -> [T] tags, on the parameters' device."""
    T = len(feat_ids)
    fi, _, m = _pad(np.asarray(feat_ids), None, bucket,
                    params.emission.device)
    return crf_viterbi(params, fi, m).cpu().numpy()[:T].astype(np.int32)
