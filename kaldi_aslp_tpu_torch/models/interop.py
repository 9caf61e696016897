"""Parameters between the JAX package's pytree and the port's state dict.

The JAX package keeps a network's parameters as a nested dict keyed by
node id, then by the component's own keys
(``{'0': {'fwd': {'w_gifo_x': array}}}``; kaldi_aslp_tpu/models/nnet.py).
The port's ``Nnet`` holds its components in ``nodes`` (an
``nn.ModuleList``) under the same names, so the two map one to one:
``['0']['fwd']['w_gifo_x']`` <-> ``nodes.0.fwd.w_gifo_x``."""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

PREFIX = "nodes"


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays (numpy or anything ``np.asarray`` takes) ->
    flat state dict of CPU tensors."""
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, node: Mapping[str, Any]) -> None:
        for key, val in node.items():
            name = f"{prefix}.{key}"
            if isinstance(val, Mapping):
                walk(name, val)
            else:
                out[name] = torch.from_numpy(np.array(val))

    walk(PREFIX, tree)
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]
                  ) -> Dict[str, Any]:
    """Inverse of :func:`params_from_jax`: flat state dict -> nested
    dict of numpy arrays."""
    tree: Dict[str, Any] = {}
    for name, tensor in state_dict.items():
        parts = name.split(".")
        if parts[0] != PREFIX or len(parts) < 3:
            raise ValueError(f"not an Nnet parameter name: {name!r}")
        node = tree
        for part in parts[1:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = tensor.detach().cpu().numpy()
    return tree
