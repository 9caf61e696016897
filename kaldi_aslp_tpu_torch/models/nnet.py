"""Graph network container: a DAG of components.

Port of kaldi_aslp_tpu/models/nnet.py (reference:
src/aslp-nnet/nnet-nnet.{h,cc}, multi-io Propagate at :70-106).  The
container holds the components in ``nodes`` (an ``nn.ModuleList``) and,
per node, its input edges: ``(source, column offset)`` where a source is
a component id or ``"in:k"``, the k-th network input.  Edges with the
same offset add; disjoint offsets splice.  ``graph()`` gives them as
JAX's ``Node`` (component, edges) list.

``save``/``load`` read and write the JAX package's native format
exactly (nnet.py:193-247): a zip holding ``topology.json`` and
``arrays.npz`` keyed by JAX keystr paths (``['params']['0']['w']``,
``['states']['2']['sum']``), so a model written by either package loads
in the other.  ``from_proto`` builds a chain from <NnetProto> text;
``info`` and ``to_dot`` print the JAX package's text."""

from __future__ import annotations

import dataclasses
import io
import json
import zipfile
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from kaldi_aslp_tpu_torch.models.component import (
    Component,
    build_component,
    component_from_token,
)
from kaldi_aslp_tpu_torch.models.interop import (
    params_from_jax,
    params_to_jax,
    states_from_jax,
    states_to_jax,
)

Source = Union[int, str]  # component id or "in:k"


@dataclasses.dataclass
class Node:
    """A component and its input edges, (source, column offset into the
    input buffer), as JAX's ``Nnet.nodes`` holds them."""
    comp: Component
    inputs: List[Tuple[Source, int]]


def _keystr(path: Sequence[str]) -> str:
    """The JAX keystr of a path of dict keys: ``['params']['0']``."""
    return "".join(f"[{k!r}]" for k in path)


def _flatten(tree: Dict[str, Any], path: Tuple[str, ...] = ()):
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _flatten(val, path + (key,))
        else:
            yield path + (key,), val


class Nnet(nn.Module):
    def __init__(self, num_inputs: int = 1,
                 output_ids: Optional[List[int]] = None):
        super().__init__()
        self.nodes = nn.ModuleList()
        self.node_inputs: List[List[Tuple[Source, int]]] = []
        self.num_inputs = num_inputs
        self._output_ids = output_ids

    # -- construction -------------------------------------------------------
    def add(self, comp: Component,
            inputs: Optional[List[Tuple[Source, int]]] = None) -> int:
        """Append a component; default input = previous node (chain),
        mirroring the reference's AutoComplete (nnet-nnet.cc:534)."""
        if inputs is None:
            src: Source = "in:0" if not len(self.nodes) else len(self.nodes) - 1
            inputs = [(src, 0)]
        self.nodes.append(comp)
        self.node_inputs.append([tuple(e) for e in inputs])
        return len(self.nodes) - 1

    @classmethod
    def from_proto(cls, proto: str) -> "Nnet":
        """A chain of the components of <NnetProto> text, one a line
        (reference: nnet-nnet.cc:561 Init); their parameters are not yet
        drawn (``reset_parameters``)."""
        net = cls()
        for line in proto.strip().splitlines():
            line = line.strip()
            if not line or line in ("<NnetProto>", "</NnetProto>"):
                continue
            net.add(build_component(line))
        return net

    # -- shape bookkeeping --------------------------------------------------
    @property
    def input_dim(self) -> int:
        return self.nodes[0].input_dim if len(self.nodes) else 0

    @property
    def output_dim(self) -> int:
        return sum(self.nodes[i].output_dim for i in self.output_ids())

    def output_ids(self) -> List[int]:
        if self._output_ids is not None:
            return self._output_ids
        consumed = {s for edges in self.node_inputs for (s, _) in edges
                    if isinstance(s, int)}
        outs = [i for i in range(len(self.nodes)) if i not in consumed]
        return outs or [len(self.nodes) - 1]

    def num_components(self) -> int:
        return len(self.nodes)

    def graph(self) -> List[Node]:
        """Every node as JAX's ``Node``: the component and its edges."""
        return [Node(c, list(e)) for c, e in zip(self.nodes,
                                                  self.node_inputs)]

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # -- params / state -----------------------------------------------------
    def reset_parameters(self, generator: torch.Generator) -> None:
        for comp in self.nodes:
            comp.reset_parameters(generator)

    def init_state(self, num_streams: int,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Dict[str, Any]:
        """Zero carried state of every recurrent node, keyed by node id
        (kaldi_aslp_tpu/models/nnet.py:108), on ``device``, by default
        the device of the net's parameters (a net without parameters has
        no recurrent node, so no state to place)."""
        if device is None:
            device = next((p.device for p in self.parameters()), "cpu")
        out = {}
        for i, comp in enumerate(self.nodes):
            s = comp.init_state(num_streams, torch.device(device))
            if s is not None:
                out[str(i)] = s
        return out

    # -- forward ------------------------------------------------------------
    def forward(self, inputs: Union[torch.Tensor, Sequence[torch.Tensor]],
                states: Optional[Dict[str, Any]] = None,
                mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """Run the DAG (reference: Propagate nnet-nnet.cc:70-106).

        ``mask`` [S, T] goes to every recurrent component and to
        ``BatchNormalization``, ``CompactFsmn`` and ``RowConvolution``
        (the ``masked`` ones), as kaldi_aslp_tpu/models/nnet.py:155-158
        rules.  ``generator`` goes to every component that draws in
        training (``Dropout``), one after another where JAX splits one
        key a node.  Training threads through ``nn.Module.train()`` /
        ``.eval()``: each component reads ``self.training``, where the
        JAX package passes ``train=``.  Returns (outputs, new_states):
        outputs is a single tensor if the net has one output, else a
        list."""
        input_list = (list(inputs) if isinstance(inputs, (list, tuple))
                      else [inputs])
        if len(input_list) != self.num_inputs:
            raise ValueError(
                f"expected {self.num_inputs} inputs, got {len(input_list)}")
        states = dict(states or {})
        outputs: Dict[int, torch.Tensor] = {}
        new_states: Dict[str, Any] = {}
        for i, comp in enumerate(self.nodes):
            x = self._gather_input(i, input_list, outputs)
            kwargs: Dict[str, Any] = {}
            if comp.recurrent or comp.masked:
                kwargs["mask"] = mask
            if comp.draws:
                kwargs["generator"] = generator
            y, s = comp(x, states.get(str(i)), **kwargs)
            outputs[i] = y
            if s is not None:
                new_states[str(i)] = s
        outs = [outputs[i] for i in self.output_ids()]
        return (outs[0] if len(outs) == 1 else outs), new_states

    def _gather_input(self, i: int, input_list, outputs) -> torch.Tensor:
        """Sum edge sources into the node's input buffer at column offsets
        (reference: nnet-nnet.cc:70-106)."""
        srcs = []
        for (src, off) in self.node_inputs[i]:
            val = (input_list[int(str(src).split(":")[1])]
                   if isinstance(src, str) else outputs[src])
            srcs.append((val, off))
        width = self.nodes[i].input_dim
        if len(srcs) == 1 and srcs[0][1] == 0 and (
                srcs[0][0].shape[-1] == width):
            return srcs[0][0]
        base = srcs[0][0]
        buf = base.new_zeros(base.shape[:-1] + (width,))
        for val, off in srcs:
            buf[..., off:off + val.shape[-1]] += val
        return buf

    # -- serialization (the JAX package's zip of JSON topology + npz) -------
    def save(self, path: str,
             states: Optional[Dict[str, Any]] = None) -> None:
        topo = {
            "num_inputs": self.num_inputs,
            "output_ids": self._output_ids,
            "nodes": [
                {
                    "token": n.comp.token,
                    "input_dim": n.comp.input_dim,
                    "output_dim": n.comp.output_dim,
                    "attrs": n.comp.attrs,
                    "inputs": [[s, o] for (s, o) in n.inputs],
                }
                for n in self.graph()
            ],
        }
        tree = {"params": params_to_jax(self.state_dict()),
                "states": states_to_jax(states or {})}
        arrays = {_keystr(p): np.asarray(v) for p, v in _flatten(tree)}
        with zipfile.ZipFile(path, "w") as z:
            z.writestr("topology.json", json.dumps(topo))
            buf = io.BytesIO()
            np.savez(buf, **arrays)
            z.writestr("arrays.npz", buf.getvalue())

    @classmethod
    def load(cls, path: str, device: Union[str, torch.device]):
        """Returns (nnet on ``device``, states)."""
        with zipfile.ZipFile(path) as z:
            topo = json.loads(z.read("topology.json"))
            npz = np.load(io.BytesIO(z.read("arrays.npz")))
            arrays = {k: npz[k] for k in npz.files}
        net = cls(num_inputs=topo["num_inputs"],
                  output_ids=topo["output_ids"])
        for nd in topo["nodes"]:
            comp_cls = component_from_token(nd["token"])
            net.add(comp_cls(nd["input_dim"], nd["output_dim"],
                             **nd["attrs"]),
                    [tuple(e) for e in nd["inputs"]])
        trees: Dict[str, Dict[str, Any]] = {"params": {}, "states": {}}
        for keystr, arr in arrays.items():
            keys = [k.strip("'\"")
                    for k in keystr.replace("]", "").split("[") if k]
            node = trees["params" if keys[0] == "params" else "states"]
            for k in keys[1:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = arr
        net.load_state_dict(params_from_jax(trees["params"]), strict=True)
        net.to(device)
        states = states_from_jax(trees["states"], torch.device(device))
        return net, states

    # -- diagnostics --------------------------------------------------------
    def info(self, with_params: bool = False) -> str:
        """Human-readable summary (reference: aslp-nnet-info), the JAX
        package's ``info(params)`` text with ``with_params``, else its
        ``info()``."""
        lines = [f"num-components {len(self.nodes)}",
                 f"input-dim {self.input_dim}",
                 f"output-dim {self.output_dim}"]
        total = 0
        for i, node in enumerate(self.graph()):
            comp, edges = node.comp, node.inputs
            extra = ""
            if with_params:
                cnt = sum(p.numel() for p in comp.parameters())
                total += cnt
                extra = f", {cnt} params"
            lines.append(f"component {i} : {comp.token} "
                         f"{comp.input_dim}->{comp.output_dim}"
                         f" inputs={list(edges)}{extra}")
        if with_params:
            lines.append(f"number-of-parameters {total}")
        return "\n".join(lines)

    def to_dot(self) -> str:
        """Graphviz dump (reference: WriteDotFile nnet-nnet.h:148)."""
        lines = ["digraph nnet {"]
        for k in range(self.num_inputs):
            lines.append(f'  "in:{k}" [shape=box];')
        for i, node in enumerate(self.graph()):
            label = node.comp.token.strip("<>")
            lines.append(f'  n{i} [label="{i}:{label}"];')
            for (src, off) in node.inputs:
                name = f'"{src}"' if isinstance(src, str) else f"n{src}"
                lines.append(f'  {name} -> n{i} [label="{off}"];')
        lines.append("}")
        return "\n".join(lines)
