"""Recurrent components: LSTMP and bidirectional LSTMP, inference only.

Port of kaldi_aslp_tpu/models/recurrent.py (``LstmProjectedStreams``
:103-225 and ``_Bidirectional`` / ``BLstmProjectedStreams`` :398-514;
reference: src/aslp-nnet/nnet-lstm-projected-streams.h:46,
nnet-blstm-projected-streams.h).

Semantics kept from the JAX package:
  - layout [S, T, D]; the input projection ``x W_gifo_x^T + b`` is one
    float32 matmul hoisted out of the time loop, and the recurrence runs
    in ops/lstmp.py (the CUDA kernel on the card, its plain version on
    the CPU), as the TPU path runs ``_lstmp_kernel``;
  - gate order g, i, f, o; the i and f peepholes act on c_prev, the o
    peephole on the new, clipped c;
  - the mask blends the carry, so right-padding is a no-op, and masked
    frames output 0;
  - the backward direction runs on the time-flipped input and mask from
    a zero state; only the forward direction's state is returned.

Training (the custom-VJP Pallas cores) and the other cells (LSTM, CIFG,
GRU, LC-BLSTM) are later slices."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from kaldi_aslp_tpu_torch.models.component import Component, register
from kaldi_aslp_tpu_torch.ops.lstmp import lstmp_forward


@register
class LstmProjectedStreams(Component):
    """Peephole LSTM with recurrent projection
    (reference: nnet-lstm-projected-streams.h:46).

    Params: w_gifo_x [4C, D], w_gifo_r [4C, P], bias [4C],
    peephole_{i,f,o}_c [C], w_r_m [P, C]."""

    token = "<LstmProjectedStreams>"
    recurrent = True

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        self.cell_dim = int(attrs.get("cell_dim", output_dim))
        self.proj_dim = int(output_dim)
        self.cell_clip = float(attrs.get("cell_clip", 50.0))
        D, C, P = self.input_dim, self.cell_dim, self.proj_dim
        self.w_gifo_x = nn.Parameter(torch.zeros(4 * C, D))
        self.w_gifo_r = nn.Parameter(torch.zeros(4 * C, P))
        self.bias = nn.Parameter(torch.zeros(4 * C))
        self.peephole_i_c = nn.Parameter(torch.zeros(C))
        self.peephole_f_c = nn.Parameter(torch.zeros(C))
        self.peephole_o_c = nn.Parameter(torch.zeros(C))
        self.w_r_m = nn.Parameter(torch.zeros(P, C))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        # uniform in [-param_scale, param_scale] (reference:
        # nnet-lstm-projected-streams.h InitData)
        scale = float(self.attrs.get("param_scale", 0.1))
        for p in self.parameters(recurse=False):
            p.copy_(scale * (2.0 * torch.rand(p.shape, generator=generator)
                             - 1.0))

    def init_state(self, num_streams, device):
        return {
            "c": torch.zeros((num_streams, self.cell_dim), device=device),
            "r": torch.zeros((num_streams, self.proj_dim), device=device),
        }

    def forward(self, x, state=None, mask=None):
        """x: [S, T, D]; mask: [S, T] (1 = valid); state: carried {c, r}."""
        S, T, _ = x.shape
        if state is None:
            state = self.init_state(S, x.device)
        if mask is None:
            mask = torch.ones((S, T), device=x.device)
        xg = torch.matmul(x, self.w_gifo_x.t()) + self.bias
        peep = torch.stack([self.peephole_i_c, self.peephole_f_c,
                            self.peephole_o_c])
        ys, c, r = lstmp_forward(
            xg.contiguous(), mask.contiguous(), self.w_gifo_r, self.w_r_m,
            peep, state["c"].contiguous(), state["r"].contiguous(),
            cell_clip=self.cell_clip)
        return ys, {"c": c, "r": r}


class _Bidirectional(Component):
    """Run a cell forward and backward, concatenate the outputs
    (kaldi_aslp_tpu/models/recurrent.py:_Bidirectional).

    The backward pass flips x and the mask in time; the masked carry
    makes the flipped-to-front padding a no-op."""

    recurrent = True
    cell_cls: type = None  # type: ignore

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        if output_dim % 2:
            raise ValueError("bidirectional output dim must be even")
        self.fwd = self.cell_cls(input_dim, output_dim // 2, **attrs)
        self.bwd = self.cell_cls(input_dim, output_dim // 2, **attrs)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.fwd.reset_parameters(generator)
        self.bwd.reset_parameters(generator)

    def init_state(self, num_streams, device):
        # only the forward direction carries streaming state; the
        # backward direction needs the future and restarts per chunk
        return {"fwd": self.fwd.init_state(num_streams, device)}

    def forward(self, x, state: Optional[Dict] = None, mask=None):
        S, T, _ = x.shape
        if state is None:
            state = self.init_state(S, x.device)
        if mask is None:
            mask = torch.ones((S, T), device=x.device)
        y_f, s_f = self.fwd(x, state["fwd"], mask=mask)
        y_b, _ = self.bwd(torch.flip(x, (1,)), None,
                          mask=torch.flip(mask, (1,)))
        y_b = torch.flip(y_b, (1,))
        return torch.cat([y_f, y_b], dim=-1), {"fwd": s_f}


@register
class BLstmProjectedStreams(_Bidirectional):
    """(reference: nnet-blstm-projected-streams.h)."""

    token = "<BLstmProjectedStreams>"
    cell_cls = LstmProjectedStreams
