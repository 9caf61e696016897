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
[S, T] (1 = valid frame).

``parse_proto_line`` / ``build_component`` read the reference's
<NnetProto> lines (``<AffineTransform> <InputDim> 40 <OutputDim> 512
...``; reference: Component::Init, nnet-component.cc), as
kaldi_aslp_tpu/models/component.py:107-165 does."""

from __future__ import annotations

import shlex
from typing import Any, Dict, List, Optional, Tuple, Type

import torch
from torch import nn


class Component(nn.Module):
    """Base component (reference: nnet-component.h:45)."""

    token: str = "<Component>"
    updatable: bool = False   # has parameters the trainer updates
    recurrent: bool = False   # takes a mask [S, T] and threads a state
    masked: bool = False      # takes the mask without being recurrent
    draws: bool = False       # takes a ``generator`` in training

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

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

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

    @classmethod
    def from_config(cls, input_dim: int, output_dim: int,
                    attrs: Dict[str, Any]) -> "Component":
        return cls(input_dim, output_dim, **attrs)

    def config_attrs(self) -> Dict[str, Any]:
        """Attrs to serialize."""
        return dict(self.attrs)

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


# -- proto lines (reference: Component::Init, nnet-component.cc) -------------

def parse_proto_line(line: str) -> Tuple[Type[Component], Dict[str, Any]]:
    """Parse one ``<Token> <Key> value ...`` proto line.

    Returns (component class, attrs with ``input_dim`` / ``output_dim``
    and the other keys in snake case: ``<ParamStddev> 0.1`` gives
    ``param_stddev=0.1``; a key with no value is ``True``)."""
    toks = shlex.split(line)
    if not toks or not toks[0].startswith("<"):
        raise ValueError(f"bad proto line: {line!r}")
    cls = component_from_token(toks[0])
    attrs: Dict[str, Any] = {}
    i = 1
    while i < len(toks):
        key = toks[i]
        if not (key.startswith("<") and key.endswith(">")):
            raise ValueError(f"expected <Key> in proto line, got {key!r}")
        name = _snake(key[1:-1])
        if i + 1 < len(toks) and not toks[i + 1].startswith("<"):
            attrs[name] = _auto(toks[i + 1])
            i += 2
        else:
            attrs[name] = True
            i += 1
    return cls, attrs


def _snake(camel: str) -> str:
    out = []
    for i, c in enumerate(camel):
        if c.isupper() and i > 0 and (not camel[i - 1].isupper()):
            out.append("_")
        out.append(c.lower())
    return "".join(out)


def _camel(snake: str) -> str:
    return "".join(p.capitalize() for p in snake.split("_"))


def _auto(s: str):
    """A proto value as int, float, bool or, failing those, the string."""
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    return s


def build_component(line: str) -> Component:
    """The component of one proto line, its parameters not yet drawn
    (``reset_parameters`` draws them)."""
    cls, attrs = parse_proto_line(line)
    input_dim = attrs.pop("input_dim")
    output_dim = attrs.pop("output_dim")
    return cls.from_config(input_dim, output_dim, attrs)
