"""Plain reference of the ``blstm_ctc`` configuration: a stack of
bidirectional peephole LSTMP layers, an affine output layer, CTC
training with momentum SGD, and the eval-mode scores (log-softmax minus
a log prior).

The backward direction of a layer reads the frames and the mask
reversed in time from a zero state, and its outputs are reversed back;
the two directions' outputs are concatenated, forward first.  The loss
is the summed CTC negative log-likelihood over the summed input lengths
(``F.ctc_loss``, blank 0), on the log-softmax of the outputs."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import common

DIRECTIONS = ("fwd", "bwd")
CELL_LEAVES = ("w_gifo_x", "w_gifo_r", "bias", "peephole_i_c",
               "peephole_f_c", "peephole_o_c", "w_r_m")


def leaves(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every parameter in a fixed order; init is
    ``uniform`` (the LSTMP's +-param_scale), ``normal`` (the output
    weights' stddev) or ``zeros``."""
    D, C, P = cfg["input_dim"], cfg["cell_dim"], cfg["proj_dim"]
    out: List[Tuple[str, Tuple[int, ...], str]] = []
    dim = D
    for layer in range(cfg["num_layers"]):
        for d in DIRECTIONS:
            shapes = {"w_gifo_x": (4 * C, dim), "w_gifo_r": (4 * C, P),
                      "bias": (4 * C,), "peephole_i_c": (C,),
                      "peephole_f_c": (C,), "peephole_o_c": (C,),
                      "w_r_m": (P, C)}
            out += [(f"layers.{layer}.{d}.{n}", shapes[n], "uniform")
                    for n in CELL_LEAVES]
        dim = 2 * P
    out.append(("out.w", (cfg["num_targets"], dim), "normal"))
    out.append(("out.b", (cfg["num_targets"],), "zeros"))
    return out


def _stacked(params: Dict[str, torch.Tensor], layer: int, name: str):
    return torch.stack([params[f"layers.{layer}.{d}.{name}"]
                        for d in DIRECTIONS])


def forward(params: Dict[str, torch.Tensor], cfg: dict, feats: torch.Tensor,
            mask: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    """Outputs [S, T, V] of the stack for ``feats`` [S, T, D] under
    ``mask`` [S, T] (1 = a valid frame)."""
    S, T, _ = feats.shape
    C, P = cfg["cell_dim"], cfg["proj_dim"]
    mask2 = torch.stack([mask, torch.flip(mask, (1,))])
    x = feats
    for layer in range(cfg["num_layers"]):
        x2 = torch.stack([x, torch.flip(x, (1,))]).reshape(2, S * T, -1)
        w_x = _stacked(params, layer, "w_gifo_x")
        xg = common.matmul(x2, w_x.transpose(1, 2), precision).reshape(
            2, S, T, 4 * C) + _stacked(params, layer, "bias")[:, None, None]
        peep = torch.stack([_stacked(params, layer, n) for n in
                            ("peephole_i_c", "peephole_f_c",
                             "peephole_o_c")], dim=1)
        zeros_c = feats.new_zeros((2, S, C))
        zeros_r = feats.new_zeros((2, S, P))
        ys, _, _ = common.lstmp_sweep(
            xg, mask2, _stacked(params, layer, "w_gifo_r"),
            _stacked(params, layer, "w_r_m"), peep, zeros_c, zeros_r,
            cfg["cell_clip"], precision)
        x = torch.cat([ys[0], torch.flip(ys[1], (1,))], dim=-1)
    return common.matmul(x, params["out.w"].t(), precision) + params["out.b"]


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor,
             input_lengths: torch.Tensor, label_lengths: torch.Tensor,
             blank: int) -> torch.Tensor:
    """Summed CTC negative log-likelihood over the summed input lengths."""
    log_probs = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    nll = F.ctc_loss(log_probs, labels.long(), input_lengths.long(),
                     label_lengths.long(), blank=blank, reduction="sum",
                     zero_infinity=False)
    return nll / input_lengths.sum().clamp(min=1)


def train(params0: Dict[str, torch.Tensor], cfg: dict,
          batches: Sequence[Dict[str, torch.Tensor]], precision: str,
          keep_streams: Optional[int] = None) -> dict:
    """``len(batches)`` SGD steps from ``params0`` (copied, not changed).
    Each batch holds feats, mask, labels, input_lengths, label_lengths on
    the device.  ``keep_streams`` computes each loss over that many
    leading streams only (the planted fault of a step that leaves part of
    its batch out).  Returns the losses, the frames each averaged
    over, the first step's gradients and
    the parameters after the last step."""
    opts = cfg["train"]
    params = {k: v.detach().clone() for k, v in params0.items()}
    velocity = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, frames, first_grads = [], [], None
    with common.exact_float32():
        for batch in batches:
            for p in params.values():
                p.requires_grad_(True)
            s = slice(0, keep_streams)
            logits = forward(params, cfg, batch["feats"][s],
                             batch["mask"][s], precision)
            loss = ctc_loss(logits, batch["labels"][s],
                            batch["input_lengths"][s],
                            batch["label_lengths"][s], cfg["blank"])
            names = list(params)
            grads = dict(zip(names, torch.autograd.grad(
                loss, [params[n] for n in names])))
            del logits
            for p in params.values():
                p.requires_grad_(False)
            if first_grads is None:
                first_grads = {k: g.clone() for k, g in grads.items()}
            losses.append(float(loss.detach()))
            frames.append(float(batch["input_lengths"][s].sum()))
            common.sgd_step(params, grads, velocity, opts["learn_rate"],
                            opts["momentum"])
    return {"losses": losses, "frames": frames,
            "first_grads": first_grads, "params": params}


@torch.no_grad()
def scores(params: Dict[str, torch.Tensor], cfg: dict, feats: torch.Tensor,
           mask: torch.Tensor, counts: torch.Tensor,
           precision: str = "float32") -> torch.Tensor:
    """Eval-mode decoder scores [S, T, V]: the log-softmax of the outputs
    minus the log of the prior ``counts`` over their sum."""
    with common.exact_float32():
        logits = forward(params, cfg, feats, mask, precision)
        counts = counts.double()
        log_prior = torch.log(counts / counts.sum()).float()
        return torch.log_softmax(logits, dim=-1) - log_prior
