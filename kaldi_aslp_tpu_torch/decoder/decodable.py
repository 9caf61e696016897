"""Acoustic-score bridge: network outputs -> decoder log-likelihoods.

Port of kaldi_aslp_tpu/decoder/decodable.py (``PdfPriorOptions``,
``PdfPrior`` with ``from_alignments``, ``NnetForwardOptions``,
``nnet_forward``; reference:
src/aslp-nnet/nnet-decodable.{h,cc}, nnet-pdf-prior.{h,cc},
src/aslp-nnetbin/aslp-nnet-forward.cc).  The network runs once over
[1, T, D] on the device its parameters live on; log-softmax and the
prior are plain torch ops.

``nnet_forward_batched`` is the span ``aslp.infer.call`` (utils/profile.py,
recorded only while a record is on), its parts ``.upload``, ``.forward``,
``.scores``, ``.wait`` and ``.to_host``; the bytes up and down are
counted in ``aslp.infer.upload.bytes`` and ``aslp.infer.to_host.bytes``."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from kaldi_aslp_tpu_torch.models.nnet import Nnet
from kaldi_aslp_tpu_torch.utils.config import Config
from kaldi_aslp_tpu_torch.utils.profile import count, recording, span


@dataclasses.dataclass
class PdfPriorOptions(Config):
    class_frame_counts: str = ""
    prior_scale: float = 1.0
    prior_floor: float = 1e-10


class PdfPrior:
    """log-prior subtraction (reference: nnet-pdf-prior.h:57-63)."""

    def __init__(self, counts: np.ndarray, prior_scale: float = 1.0,
                 prior_floor: float = 1e-10):
        counts = np.asarray(counts, np.float64)
        rel = counts / max(counts.sum(), 1.0)
        # zero/low-count pdfs get a huge POSITIVE log-prior so the
        # subtraction drives their pseudo-loglike to -inf, removing them
        # from the search (reference: nnet-pdf-prior.cc sets 1e10)
        self.log_priors = np.where(
            rel < prior_floor, 1e10,
            np.log(np.maximum(rel, prior_floor)) * prior_scale,
        ).astype(np.float32)

    @classmethod
    def from_alignments(cls, alignments: Dict[str, np.ndarray],
                        num_pdfs: int, **kw) -> "PdfPrior":
        """analyze-counts equivalent (reference: bin/analyze-counts.cc):
        the prior from the pdf counts of ``alignments`` (utt -> pdf
        ids)."""
        counts = np.zeros(num_pdfs, np.float64)
        for ali in alignments.values():
            np.add.at(counts, np.asarray(ali), 1.0)
        return cls(counts, **kw)

    def subtract(self, log_post: torch.Tensor) -> torch.Tensor:
        return log_post - torch.from_numpy(self.log_priors).to(
            log_post.device)


@dataclasses.dataclass
class NnetForwardOptions(Config):
    apply_log: bool = True
    no_softmax: bool = False   # model output is already log-likelihood-ish
    blank_scale: float = 1.0   # CTC blank posterior scaling (--scale-blank)
    time_shift: int = 0
    skip_width: int = 1        # frame skipping, copy mode


@torch.inference_mode()
def nnet_forward(
    net: Nnet,
    feats: np.ndarray,
    opts: Optional[NnetForwardOptions] = None,
    prior: Optional[PdfPrior] = None,
) -> np.ndarray:
    """aslp-nnet-forward equivalent: [T, D] -> [T, P] scores for
    decoding, on the device of ``net``'s parameters.

    Returns log-posteriors minus log-priors (scaled pseudo
    log-likelihoods)."""
    opts = opts or NnetForwardOptions()
    device = next(net.parameters()).device
    T = len(feats)
    x = np.asarray(feats, np.float32)
    if opts.skip_width > 1:
        # copy mode: evaluate every k-th frame, replicate scores
        x = x[np.arange(0, T, opts.skip_width)]
    if opts.time_shift:
        x = np.concatenate(
            [x[opts.time_shift:], np.repeat(x[-1:], opts.time_shift, 0)])
    y = _eval_forward(net, torch.from_numpy(np.array(x[None])).to(device))
    out = _scores(y[0], opts, prior).cpu().numpy()
    if opts.skip_width > 1:
        out = np.repeat(out, opts.skip_width, axis=0)[:T]
    return out


@torch.inference_mode()
def nnet_forward_batched(
    net: Nnet,
    feats: np.ndarray,
    mask: np.ndarray,
    opts: Optional[NnetForwardOptions] = None,
    prior: Optional[PdfPrior] = None,
) -> np.ndarray:
    """:func:`nnet_forward` over a padded batch: ``feats`` [B, T, D] and
    ``mask`` [B, T] (1 = valid) -> [B, T, P] scores, one network forward
    for the batch on the device of ``net``'s parameters (the batched
    forward of online/batching.py:AcousticBatcher).  The mask holds each
    recurrent layer's carry through a row's padding, so a row's valid
    frames score as they do alone.  Frame skipping and time shift are
    per-utterance options and are refused here.

    While a span record is on, ``aslp.infer.wait`` waits for the current
    stream, so ``aslp.infer.to_host`` times the scores' copy alone; with
    the record off the copy waits at the same point."""
    opts = opts or NnetForwardOptions()
    if opts.skip_width > 1 or opts.time_shift:
        raise ValueError("nnet_forward_batched takes no skip_width or "
                         "time_shift")
    with span("aslp.infer.call"):
        device = next(net.parameters()).device
        with span("aslp.infer.upload"):
            x = torch.from_numpy(np.ascontiguousarray(feats, np.float32)).to(
                device)
            m = torch.from_numpy(np.ascontiguousarray(mask, np.float32)).to(
                device)
        with span("aslp.infer.forward"):
            y = _eval_forward(net, x, m)
        with span("aslp.infer.scores"):
            scores = _scores(y, opts, prior)
        with span("aslp.infer.wait"):
            if recording() and scores.is_cuda:
                torch.cuda.current_stream(scores.device).synchronize()
        with span("aslp.infer.to_host"):
            out = scores.cpu().numpy()
        if recording():
            count("aslp.infer.upload.bytes", x.nbytes + m.nbytes)
            count("aslp.infer.to_host.bytes", out.nbytes)
        return out


def _eval_forward(net: Nnet, x: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The inference path, as the JAX package calls apply(train=False)."""
    was_training = net.training
    net.eval()
    try:
        y, _ = net(x, mask=mask)
    finally:
        net.train(was_training)
    return y


def _scores(y: torch.Tensor, opts: NnetForwardOptions,
            prior: Optional[PdfPrior]) -> torch.Tensor:
    """Network outputs [..., P] -> decoder scores."""
    if not opts.no_softmax:
        y = torch.log_softmax(y, dim=-1)
    elif opts.apply_log:
        y = torch.log(torch.clamp(y, min=1e-20))
    if opts.blank_scale != 1.0:
        y[..., 0] += float(np.log(opts.blank_scale))
    if prior is not None:
        y = prior.subtract(y)
    return y
