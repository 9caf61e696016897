"""The flagship's forward step on the card, counterpart of
``__graft_entry__.entry`` (__graft_entry__.py:14-31).

    forward, args = entry()
    log_probs = forward(*args)      # [8, 200, 72]

The flagship BLSTM-CTC (3 x BLSTMP, cell 512, projection 320 a
direction, 40 inputs, 72 targets) is built on ``device`` with parameters
drawn from a ``torch.Generator`` seeded ``seed`` (JAX draws from
``PRNGKey(0)``: the two start from different weights; carry JAX's over
with ``models/interop.py:params_from_jax``).  ``forward(net, feats,
mask)`` is the eval forward, each BLSTMP layer one ``blstmp_forward``
launch, then a log-softmax; its arguments are JAX's: the net where JAX
passes its params, [S, T, 40] features from ``RandomState(0)`` and an
all-ones mask."""

from __future__ import annotations

from typing import Callable, Tuple, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.models.flagship import build_blstm_ctc
from kaldi_aslp_tpu_torch.models.nnet import Nnet
from kaldi_aslp_tpu_torch.utils.device import resolve_device


@torch.inference_mode()
def forward(net: Nnet, feats: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """[S, T, 40] features, [S, T] mask -> [S, T, 72] log-probabilities."""
    net.eval()
    logits, _ = net(feats, mask=mask)
    return torch.log_softmax(logits, dim=-1)


def entry(device: Union[str, torch.device] = "cuda", seed: int = 0,
          S: int = 8, T: int = 200) -> Tuple[Callable, tuple]:
    """(forward, (net, feats, mask)) on ``device``."""
    dev = resolve_device(device)
    net = build_blstm_ctc(input_dim=40, num_layers=3, proj_dim=320,
                          cell_dim=512, num_targets=72)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    net.to(dev).eval()
    rs = np.random.RandomState(0)
    feats = torch.from_numpy(rs.randn(S, T, 40).astype(np.float32)).to(dev)
    mask = torch.ones((S, T), dtype=torch.float32, device=dev)
    return forward, (net, feats, mask)
