"""Plain PyTorch pieces that the configurations' references share.

Nothing here imports the program under test: the equations are written
from the layer descriptions (the peephole LSTM with a recurrent
projection of kaldi-aslp's nnet-lstm-projected-streams.h, its masked
carry and cell clip, and the momentum SGD of its NnetTrainOptions).

Every matrix product goes through :func:`matmul`, which rounds its
operands to a stated precision first.  At ``float32`` nothing is rounded
and TF32 is switched off, so the reference is the float32 computation.
The lower precisions make the benchmark's controls: the same reference
computed as a tempting lower-precision program would compute it."""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Tuple

import torch

FP8_MAX = 448.0   # the largest finite float8 e4m3 value


def round_operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` rounded to ``precision`` and widened back to float32: fp8 is
    e4m3 under a per-tensor scale that maps the largest |x| to 448, as
    scaled fp8 training rounds a tensor."""
    if precision == "float32":
        return x
    if precision == "fp8":
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = FP8_MAX / amax
        return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    raise ValueError(f"unknown precision {precision!r}")


class _RoundedMatmul(torch.autograd.Function):
    """a @ b with both operands rounded, and the backward's two products
    with their operands (the incoming gradient included) rounded the
    same way."""

    @staticmethod
    def forward(ctx, a, b, precision):
        qa, qb = round_operand(a, precision), round_operand(b, precision)
        ctx.save_for_backward(qa, qb)
        ctx.precision = precision
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = round_operand(g, ctx.precision)
        da = torch.matmul(qg, qb.transpose(-1, -2))
        db = torch.matmul(qa.transpose(-1, -2), qg)
        # a broadcast operand (a weight under a batched product) sums
        # over the broadcast dimensions
        while db.dim() > qb.dim():
            db = db.sum(0)
        while da.dim() > qa.dim():
            da = da.sum(0)
        return da, db, None


def matmul(a: torch.Tensor, b: torch.Tensor,
           precision: str = "float32") -> torch.Tensor:
    if precision == "float32":
        return torch.matmul(a, b)
    return _RoundedMatmul.apply(a, b, precision)


@contextlib.contextmanager
def exact_float32() -> Iterator[None]:
    """TF32 off for the matmuls and convolutions inside, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def lstmp_sweep(xg: torch.Tensor, mask: torch.Tensor, w_r: torch.Tensor,
                w_rm: torch.Tensor, peep: torch.Tensor, c0: torch.Tensor,
                r0: torch.Tensor, clip: float, precision: str = "float32"
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The peephole LSTMP recurrence over ``xg`` [K, S, T, 4C] (the input
    projection with its bias; K independent directions side by side, each
    with its own weights w_r [K, 4C, P], w_rm [K, P, C], peep [K, 3, C]
    and state c0 [K, S, C], r0 [K, S, P]).  Gate order g, i, f, o; the i
    and f peepholes act on the previous cell, the o peephole on the new,
    clipped one; a frame whose ``mask`` [K, S, T] is 0 keeps the state
    and outputs 0.  Returns (ys [K, S, T, P], c_T, r_T)."""
    K, S, T, G = xg.shape
    C = G // 4
    w_r_t, w_rm_t = w_r.transpose(1, 2), w_rm.transpose(1, 2)
    p_if = torch.cat([peep[:, 0], peep[:, 1]], dim=-1)[:, None, :]
    p_o = peep[:, 2][:, None, :]
    valid = (mask > 0)[..., None]
    c, r = c0, r0
    rs: List[torch.Tensor] = []
    for t in range(T):
        gates = xg[:, :, t] + matmul(r, w_r_t, precision)
        i, f = torch.sigmoid(torch.addcmul(
            gates[..., C:3 * C], p_if, c.repeat(1, 1, 2))).split(C, dim=-1)
        c_new = torch.addcmul(f * c, i, torch.tanh(gates[..., :C]))
        if clip > 0:
            c_new = torch.clamp(c_new, -clip, clip)
        o = torch.sigmoid(torch.addcmul(gates[..., 3 * C:], p_o, c_new))
        r_new = matmul(o * torch.tanh(c_new), w_rm_t, precision)
        v = valid[:, :, t]
        c = torch.where(v, c_new, c)
        r = torch.where(v, r_new, r)
        rs.append(r)
    return torch.stack(rs, dim=2) * valid, c, r


def sgd_step(params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor],
             velocity: Dict[str, torch.Tensor], learn_rate: float,
             momentum: float) -> None:
    """v = momentum v - learn_rate g; p = p + v, in place (kaldi-aslp's
    momentum form, not torch.optim.SGD's)."""
    with torch.no_grad():
        for name, p in params.items():
            v = velocity[name]
            v.mul_(momentum).sub_(learn_rate * grads[name])
            p.add_(v)
