"""Component base and the registry by model-file token.

Port of kaldi_aslp_tpu/models/component.py (reference:
src/aslp-nnet/nnet-component.h:45, MarkerToType at :50-103).  Where the
JAX component is functional (hyperparameters on the object, parameters
in a pytree), a port component is an ``nn.Module`` that owns its
parameters under the JAX keys (``w_gifo_x``, ``w``, ``b`` ...), so a
state-dict key such as ``nodes.0.fwd.w_gifo_x`` maps one to one to the
JAX key ``['params']['0']['fwd']['w_gifo_x']`` (models/interop.py).

Data layout is the JAX package's: sequence components take [S, T, D]
(streams, time, feature); frame-level components accept any [..., D].
Recurrent components thread an explicit ``state`` and take a ``mask``
[S, T] (1 = valid frame)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Type

import torch
from torch import nn


class Component(nn.Module):
    """Base component (reference: nnet-component.h:45)."""

    token: str = "<Component>"
    updatable: bool = False   # has parameters the trainer updates
    recurrent: bool = False   # takes a mask [S, T] and threads a state

    def __init__(self, input_dim: int, output_dim: int, **attrs):
        super().__init__()
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        # every attr the model file carries is kept and written back on
        # save, including those the port does not read (e.g. ``pallas``,
        # ``bf16``, init scales)
        self.attrs = attrs

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw the parameters (counterpart of ``init_params(key)``)."""

    def init_state(self, num_streams: int, device: torch.device) -> Any:
        return None

    def lr_coefs(self) -> Dict[str, float]:
        """Learning-rate multipliers by top-level parameter name; absent
        names take 1.0 (train/sgd.py)."""
        return {}

    def forward(self, x: torch.Tensor, state: Any = None,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Any]:
        raise NotImplementedError

    def extra_repr(self) -> str:
        return f"in={self.input_dim}, out={self.output_dim}"


_REGISTRY: Dict[str, Type[Component]] = {}


def register(cls: Type[Component]) -> Type[Component]:
    _REGISTRY[cls.token] = cls
    # tolerate case-insensitive lookup like the reference's MarkerToType
    _REGISTRY[cls.token.lower()] = cls
    return cls


def component_from_token(token: str) -> Type[Component]:
    try:
        return (_REGISTRY[token] if token in _REGISTRY
                else _REGISTRY[token.lower()])
    except KeyError:
        raise ValueError(
            f"unknown component token {token!r} (the port has "
            f"{known_tokens()})") from None


def known_tokens() -> List[str]:
    return sorted({c.token for c in _REGISTRY.values()})
