"""Training checkpoint and resume, in the JAX package's file format.

Port of kaldi_aslp_tpu/train/checkpoint.py:43-76: a zip holding
``meta.json`` and ``arrays.npz``, the arrays keyed by the JAX keystr of
their path under ``params``, ``velocity`` or ``states``
(``params['0']['fwd']['w_gifo_x']``), so a checkpoint written by either
package loads in the other.  The port's parameters and velocity are flat
``Nnet`` state dicts (``nodes.0.fwd.w_gifo_x``), mapped to the JAX tree
by models/interop.py; model states are nested dicts of tensors or
arrays."""

from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from kaldi_aslp_tpu_torch.models.interop import (
    params_from_jax,
    params_to_jax,
)


def _flatten(tree: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key in sorted(tree):
        val = tree[key]
        name = f"{prefix}[{key!r}]"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name))
        elif isinstance(val, torch.Tensor):
            out[name] = val.detach().cpu().numpy()
        else:
            out[name] = np.asarray(val)
    return out


def _unflatten(arrays: Mapping[str, np.ndarray], prefix: str
               ) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, arr in arrays.items():
        if not key.startswith(prefix + "["):
            continue
        keys = [k.strip("'\"") for k in
                key[len(prefix):].replace("]", "").split("[") if k]
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return out


def _to_tensors(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _to_tensors(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def save_checkpoint(
    path: str,
    params: Mapping[str, torch.Tensor],
    velocity: Optional[Mapping[str, torch.Tensor]] = None,
    model_states: Optional[Mapping[str, Any]] = None,
    meta: Optional[Dict] = None,
) -> None:
    """Write ``params`` and ``velocity`` (state dicts of an ``Nnet``),
    ``model_states`` and ``meta`` to ``path``, atomically."""
    arrays = _flatten(params_to_jax(params), "params")
    if velocity is not None:
        arrays.update(_flatten(params_to_jax(velocity), "velocity"))
    if model_states is not None:
        arrays.update(_flatten(model_states, "states"))
    tmp = path + ".tmp"
    with zipfile.ZipFile(tmp, "w") as z:
        z.writestr("meta.json", json.dumps(meta or {}))
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        z.writestr("arrays.npz", buf.getvalue())
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor],
                                        Optional[Dict[str, torch.Tensor]],
                                        Optional[Dict[str, Any]], Dict]:
    """Returns (params, velocity, model_states, meta): the first two as
    state dicts of CPU tensors, the states as a nested dict of CPU
    tensors; velocity and states are None where the file has none."""
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        npz = np.load(io.BytesIO(z.read("arrays.npz")))
        arrays = {k: npz[k] for k in npz.files}
    velocity = _unflatten(arrays, "velocity")
    states = _unflatten(arrays, "states")
    return (params_from_jax(_unflatten(arrays, "params")),
            params_from_jax(velocity) if velocity else None,
            _to_tensors(states) if states else None, meta)
