"""Parameters between the JAX package's pytree and the port's state dict.

The JAX package keeps a network's parameters as a nested dict keyed by
node id, then by the component's own keys
(``{'0': {'fwd': {'w_gifo_x': array}}}``; kaldi_aslp_tpu/models/nnet.py).
The port's ``Nnet`` holds its components in ``nodes`` (an
``nn.ModuleList``) under the same names, so the two map one to one:
``['0']['fwd']['w_gifo_x']`` <-> ``nodes.0.fwd.w_gifo_x``.  The
carried state (a recurrent layer's ``c`` / ``r`` / ``h``, an LC-BLSTMP's
``fwd`` subtree, ``BatchNormalization``'s ``sum`` / ``sumsq`` /
``count``) is the same nesting of node id and key on both sides, numpy
arrays there and tensors here (``states_from_jax`` / ``states_to_jax``).

A GMM acoustic model crosses as its numpy arrays: the JAX
``AmDiagGmm``'s ``weights``, ``means`` and ``vars`` and its transition
model's ``log_probs`` (``gmm_from_jax`` / ``gmm_to_jax``); a full or
global GMM as its arrays (``full_gmm_*``, ``global_gmm_*``); a decision
tree (``ContextDependency``) node by node (``tree_from_jax`` /
``tree_to_jax``)."""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, Mapping

import numpy as np
import torch

if TYPE_CHECKING:
    from kaldi_aslp_tpu_torch.gmm.diag_gmm import AmDiagGmm
    from kaldi_aslp_tpu_torch.gmm.full_gmm import AmFullGmm
    from kaldi_aslp_tpu_torch.gmm.global_gmm import GlobalGmm
    from kaldi_aslp_tpu_torch.hmm.transition_model import TransitionModel
    from kaldi_aslp_tpu_torch.tree.build_tree import ContextDependency

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


def states_from_jax(tree: Mapping[str, Any],
                    device: torch.device) -> Dict[str, Any]:
    """A JAX state pytree (nested dicts of arrays) -> the same nesting of
    tensors, in the arrays' dtypes, on ``device``."""
    if isinstance(tree, Mapping):
        return {k: states_from_jax(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)


def states_to_jax(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`states_from_jax`: tensors -> numpy arrays."""
    if isinstance(tree, Mapping):
        return {k: states_to_jax(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


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


FULL_GMM_FIELDS = ("weights", "means", "covars")
GLOBAL_GMM_FIELDS = ("weights", "means", "vars")


def full_gmm_from_jax(am: Any) -> "AmFullGmm":
    """A JAX ``AmFullGmm`` (numpy ``weights`` [P, M], ``means`` [P, M, D],
    ``covars`` [P, M, D, D]) -> the port's."""
    from kaldi_aslp_tpu_torch.gmm.full_gmm import AmFullGmm

    return AmFullGmm(*(np.array(getattr(am, k), np.float32)
                       for k in FULL_GMM_FIELDS))


def full_gmm_to_jax(am: "AmFullGmm") -> Dict[str, np.ndarray]:
    """Copies of the port's full GMM arrays, the JAX ``AmFullGmm``'s
    fields (``AmFullGmm(**full_gmm_to_jax(am))`` there)."""
    return {k: getattr(am, k).copy() for k in FULL_GMM_FIELDS}


def global_gmm_from_jax(gmm: Any) -> "GlobalGmm":
    """A JAX ``GlobalGmm`` (numpy ``weights`` [M], ``means``, ``vars``
    [M, D]) -> the port's."""
    from kaldi_aslp_tpu_torch.gmm.global_gmm import GlobalGmm

    return GlobalGmm(*(np.array(getattr(gmm, k), np.float32)
                       for k in GLOBAL_GMM_FIELDS))


def global_gmm_to_jax(gmm: "GlobalGmm") -> Dict[str, np.ndarray]:
    """Copies of the port's global GMM arrays, the JAX ``GlobalGmm``'s
    fields."""
    return {k: getattr(gmm, k).copy() for k in GLOBAL_GMM_FIELDS}


def _copy_node(node: Any, node_cls) -> Any:
    if node.key_pos is None:
        return node_cls(pdf=int(node.pdf))
    return node_cls(pdf=int(node.pdf), key_pos=int(node.key_pos),
                    question=frozenset(int(p) for p in node.question),
                    yes=_copy_node(node.yes, node_cls),
                    no=_copy_node(node.no, node_cls))


def _copy_tree(tree: Any, tree_cls, node_cls) -> Any:
    out = tree_cls(tree.context_width, tree.central_position)
    out.num_pdfs = int(tree.num_pdfs)
    out.roots = {(int(p), int(pc)): _copy_node(node, node_cls)
                 for (p, pc), node in tree.roots.items()}
    return out


def tree_from_jax(tree: Any) -> "ContextDependency":
    """A JAX ``ContextDependency`` (``context_width``,
    ``central_position``, ``num_pdfs`` and ``roots``: (phone, pdf-class)
    -> ``TreeNode`` with ``pdf``, ``key_pos``, ``question``, ``yes``,
    ``no``) -> the port's, each node copied."""
    from kaldi_aslp_tpu_torch.tree.build_tree import (
        ContextDependency,
        TreeNode,
    )

    return _copy_tree(tree, ContextDependency, TreeNode)


def tree_to_jax(tree: "ContextDependency", tree_cls, node_cls) -> Any:
    """The port's tree rebuilt node by node from the caller's classes:
    the JAX package's ``ContextDependency`` and ``TreeNode`` (the port
    imports nothing of that package)."""
    return _copy_tree(tree, tree_cls, node_cls)
