"""Parameters between the JAX package's pytree and the port's state dict.

The JAX package keeps a network's parameters as a nested dict keyed by
node id, then by the component's own keys
(``{'0': {'fwd': {'w_gifo_x': array}}}``; kaldi_aslp_tpu/models/nnet.py).
The port's ``Nnet`` holds its components in ``nodes`` (an
``nn.ModuleList``) under the same names, so the two map one to one:
``['0']['fwd']['w_gifo_x']`` <-> ``nodes.0.fwd.w_gifo_x``.

A GMM acoustic model crosses as its numpy arrays: the JAX
``AmDiagGmm``'s ``weights``, ``means`` and ``vars`` and its transition
model's ``log_probs`` (``gmm_from_jax`` / ``gmm_to_jax``)."""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, Mapping

import numpy as np
import torch

if TYPE_CHECKING:
    from kaldi_aslp_tpu_torch.gmm.diag_gmm import AmDiagGmm
    from kaldi_aslp_tpu_torch.hmm.transition_model import TransitionModel

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


def gmm_from_jax(am: Any, log_probs: np.ndarray,
                 trans_model: "TransitionModel") -> "AmDiagGmm":
    """A JAX ``AmDiagGmm`` (any object with numpy ``weights`` [P, M],
    ``means`` and ``vars`` [P, M, D]) and its transition model's
    ``log_probs`` -> the port's ``AmDiagGmm``; the log-probabilities are
    copied into ``trans_model``, a port transition model of the same
    topology (the same transition ids)."""
    from kaldi_aslp_tpu_torch.gmm.diag_gmm import AmDiagGmm

    if len(log_probs) != trans_model.num_transition_ids + 1:
        raise ValueError(f"{len(log_probs)} log-probabilities for "
                         f"{trans_model.num_transition_ids} transition ids")
    trans_model.log_probs = np.array(log_probs, np.float32)
    return AmDiagGmm(*(np.array(getattr(am, k), np.float32)
                       for k in ("weights", "means", "vars")))


def gmm_to_jax(am: "AmDiagGmm", trans_model: "TransitionModel"
               ) -> Dict[str, np.ndarray]:
    """Inverse of :func:`gmm_from_jax`: copies of the model's
    ``weights``, ``means``, ``vars`` (the JAX ``AmDiagGmm``'s fields)
    and the transition model's ``log_probs``."""
    return {"weights": am.weights.copy(), "means": am.means.copy(),
            "vars": am.vars.copy(),
            "log_probs": trans_model.log_probs.copy()}
