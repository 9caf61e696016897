"""The reference's .nnet model files: read graph and standard nets, write
standard ones.

Port of kaldi_aslp_tpu/models/kaldi_import.py (reference:
src/aslp-nnet/nnet-nnet.cc Nnet::Read/Write at :606+; per-component
framing Component::Write nnet-component.cc:328-343: token, out-dim,
in-dim, optional <Name>, id, input int-vector, offset int-vector, then
the component's data; the plain nnet1 "standard" chain, WriteStandard,
has no id, inputs or offsets).

Payloads read (formats from the reference headers):
  AffineTransform  <LearnRateCoef> <BiasLearnRateCoef> [<MaxNorm>] M V
                   (nnet-affine-transform.h:145)
  LinearTransform  <LearnRateCoef> M          (nnet-linear-transform.h:99)
  LstmProjectedStreams  <CellDim> <ClipGradient> M M V V V V M
                   (nnet-lstm-projected-streams.h:161)
  BLstmProjectedStreams the same twice, fwd then bwd
                   (nnet-blstm-projected-streams.h:233)
  LstmCifgProjectedStreams  LSTMP's payload, as the writer below (and
                   the JAX package's) writes it; the JAX reader refuses
                   the token, so a CIFG net it exports does not read back
  Splice           int-vector of frame offsets   (nnet-various.h:125)
  Copy             int-vector of 1-based indices (nnet-various.h:279)
  ScaleLayer       <Scale> float, read as a ``Rescale``
  InputLayer / OutputLayer and the activations: no payload.

The gate order of an imported LSTMP is g, i, f, o, the port's, so its
matrices are the port's parameters as they stand."""

from __future__ import annotations

from typing import Any, BinaryIO, Dict, List, Optional, Tuple

import numpy as np
import torch

from kaldi_aslp_tpu_torch.io import kaldi_io
from kaldi_aslp_tpu_torch.io.kaldi_io import KaldiIOError
from kaldi_aslp_tpu_torch.models import recurrent as R
from kaldi_aslp_tpu_torch.models import simple as S
from kaldi_aslp_tpu_torch.models.component import Component
from kaldi_aslp_tpu_torch.models.nnet import Nnet

_ACTIVATIONS = {
    "<Sigmoid>": S.Sigmoid,
    "<Tanh>": S.Tanh,
    "<Softmax>": S.Softmax,
    "<ReLU>": S.ReLU,
    "<LengthNormComponent>": S.LengthNorm,
    "<Transmit>": S.Transmit,
}


def _peek(f: BinaryIO) -> bytes:
    pos = f.tell()
    b = f.read(1)
    f.seek(pos)
    return b


def _skip_space(f: BinaryIO) -> None:
    while _peek(f) in b" \t\n\r":
        f.read(1)


def read_kaldi_nnet(path_or_file) -> Nnet:
    """The net of a binary .nnet file (graph or standard format), on the
    CPU with its parameters loaded."""
    if hasattr(path_or_file, "read"):
        return _read_nnet(path_or_file)
    with open(path_or_file, "rb") as f:
        return _read_nnet(f)


def _read_nnet(f: BinaryIO) -> Nnet:
    if not kaldi_io.peek_binary_marker(f):
        raise KaldiIOError("only binary .nnet files supported")
    kaldi_io.expect_token(f, "<Nnet>")
    comps: List[Tuple[Component, Optional[int], Optional[List[int]],
                      Optional[List[int]], str]] = []
    while True:
        _skip_space(f)
        token = kaldi_io.read_token(f)
        if token == "</Nnet>":
            break
        dim_out = kaldi_io.read_basic_int32(f)
        dim_in = kaldi_io.read_basic_int32(f)
        # graph format: optional <Name>, then the id and the input and
        # offset vectors; the standard format's payload follows at once
        # (a '<' tag, an 'FM' / 'FV' token or a Splice's int vector), so
        # try the graph header and go back on failure
        pos = f.tell()
        comp_id = inputs = offsets = None
        try:
            _skip_space(f)
            if _peek(f) == b"<":
                tok_pos = f.tell()
                if kaldi_io.read_token(f) == "<Name>":
                    kaldi_io.read_token(f)
                else:
                    f.seek(tok_pos)
                    raise KaldiIOError("standard format")
            comp_id = kaldi_io.read_basic_int32(f)
            inputs = list(kaldi_io.read_int_vector(f))
            offsets = list(kaldi_io.read_int_vector(f))
        except Exception:
            f.seek(pos)
            comp_id = inputs = offsets = None
        comp = _read_component(f, token, dim_in, dim_out)
        comps.append((comp, comp_id, inputs, offsets, token))

    # graph-format <InputLayer>s are the net's inputs (reference:
    # nnet-io.h:19,40, Nnet::InitInputOutput): the k-th becomes a
    # Transmit node fed from network input k
    input_ordinal: Dict[int, int] = {}
    for _c, cid, _i, _o, tok in comps:
        if tok == "<InputLayer>" and cid is not None:
            input_ordinal[cid] = len(input_ordinal)
    net = Nnet(num_inputs=max(1, len(input_ordinal)))
    id_to_index = {cid: idx for idx, (_c, cid, _i, _o, _t) in
                   enumerate(comps) if cid is not None}
    for comp, cid, inputs, offsets, tok in comps:
        if tok == "<InputLayer>" and cid in input_ordinal:
            edge = [(f"in:{input_ordinal[cid]}", 0)]
        elif inputs is None or not inputs or inputs[0] == -1:
            edge = None   # the chain's default, or the network input
        else:
            edge = [(id_to_index.get(src, src), off)
                    for src, off in zip(inputs, offsets)]
        net.add(comp, inputs=edge)
    return net


@torch.no_grad()
def _set(comp: torch.nn.Module, params: Dict[str, Any]) -> None:
    for name, val in params.items():
        if isinstance(val, dict):
            _set(getattr(comp, name), val)
        else:
            getattr(comp, name).copy_(torch.from_numpy(
                np.asarray(val, np.float32)))


def _read_component(f: BinaryIO, token: str, dim_in: int,
                    dim_out: int) -> Component:
    if token in _ACTIVATIONS:
        return _ACTIVATIONS[token](dim_in, dim_out)
    if token in ("<InputLayer>", "<OutputLayer>"):
        return S.Transmit(dim_in, dim_out)
    if token == "<ScaleLayer>":
        kaldi_io.expect_token(f, "<Scale>")
        comp = S.Rescale(dim_in, dim_out)
        _set(comp, {"s": np.full((dim_in,), kaldi_io.read_basic_float(f))})
        return comp
    if token == "<AffineTransform>":
        kaldi_io.expect_token(f, "<LearnRateCoef>")
        lrc = kaldi_io.read_basic_float(f)
        kaldi_io.expect_token(f, "<BiasLearnRateCoef>")
        blrc = kaldi_io.read_basic_float(f)
        _skip_space(f)
        mn = 0.0
        if _peek(f) == b"<":
            kaldi_io.expect_token(f, "<MaxNorm>")
            mn = kaldi_io.read_basic_float(f)
        comp = S.AffineTransform(dim_in, dim_out, learn_rate_coef=lrc,
                                 bias_learn_rate_coef=blrc, max_norm=mn)
        _set(comp, {"w": kaldi_io.read_matrix(f),
                    "b": kaldi_io.read_vector(f)})
        return comp
    if token == "<LinearTransform>":
        kaldi_io.expect_token(f, "<LearnRateCoef>")
        comp = S.LinearTransform(dim_in, dim_out,
                                 learn_rate_coef=kaldi_io.read_basic_float(f))
        _set(comp, {"w": kaldi_io.read_matrix(f)})
        return comp
    if token == "<Splice>":
        return S.Splice(dim_in, dim_out,
                        build_vector=[int(v) for v in
                                      kaldi_io.read_int_vector(f)])
    if token == "<Copy>":
        return S.CopyComponent(dim_in, dim_out, build_vector=[
            int(i) - 1 for i in kaldi_io.read_int_vector(f)])
    if token in ("<LstmProjectedStreams>", "<LstmCifgProjectedStreams>",
                 "<BLstmProjectedStreams>"):
        kaldi_io.expect_token(f, "<CellDim>")
        cell = kaldi_io.read_basic_int32(f)
        kaldi_io.expect_token(f, "<ClipGradient>")
        kaldi_io.read_basic_float(f)
        if token != "<BLstmProjectedStreams>":
            cls = (R.LstmProjectedStreams if token == "<LstmProjectedStreams>"
                   else R.LstmCifgProjectedStreams)
            comp = cls(dim_in, dim_out, cell_dim=cell)
            _set(comp, _read_lstmp_params(f))
        else:
            comp = R.BLstmProjectedStreams(dim_in, dim_out, cell_dim=cell)
            _set(comp, {"fwd": _read_lstmp_params(f),
                        "bwd": _read_lstmp_params(f)})
        return comp
    raise KaldiIOError(f"unsupported component {token!r} in .nnet import")


_LSTMP_FIELDS = (("w_gifo_x", "M"), ("w_gifo_r", "M"), ("bias", "V"),
                 ("peephole_i_c", "V"), ("peephole_f_c", "V"),
                 ("peephole_o_c", "V"), ("w_r_m", "M"))


def _read_lstmp_params(f: BinaryIO) -> Dict[str, np.ndarray]:
    return {name: (kaldi_io.read_matrix(f) if kind == "M"
                   else kaldi_io.read_vector(f))
            for name, kind in _LSTMP_FIELDS}


def _write_lstmp_params(f: BinaryIO, cell: R.LstmProjectedStreams) -> None:
    for name, kind in _LSTMP_FIELDS:
        val = getattr(cell, name).detach().cpu().numpy()
        if kind == "M":
            kaldi_io.write_matrix(f, val)
        else:
            kaldi_io.write_vector(f, val)


def write_kaldi_nnet_standard(path_or_file, net: Nnet) -> None:
    """``net`` as a standard-format (WriteStandard) binary .nnet, byte for
    byte what the JAX package writes; a component the format has no
    payload for raises ``KaldiIOError``."""
    if hasattr(path_or_file, "write"):
        _write_standard(path_or_file, net)
    else:
        with open(path_or_file, "wb") as f:
            _write_standard(f, net)


def _write_standard(f: BinaryIO, net: Nnet) -> None:
    f.write(kaldi_io.BINARY_MARKER)
    kaldi_io.write_token(f, "<Nnet>")
    for comp in net.nodes:
        kaldi_io.write_token(f, comp.token)
        kaldi_io.write_basic_int32(f, comp.output_dim)
        kaldi_io.write_basic_int32(f, comp.input_dim)
        if isinstance(comp, S.AffineTransform):
            kaldi_io.write_token(f, "<LearnRateCoef>")
            kaldi_io.write_basic_float(
                f, float(comp.attrs.get("learn_rate_coef", 1.0)))
            kaldi_io.write_token(f, "<BiasLearnRateCoef>")
            kaldi_io.write_basic_float(
                f, float(comp.attrs.get("bias_learn_rate_coef", 1.0)))
            kaldi_io.write_token(f, "<MaxNorm>")
            kaldi_io.write_basic_float(f, comp.max_norm)
            kaldi_io.write_matrix(f, comp.w.detach().cpu().numpy())
            kaldi_io.write_vector(f, comp.b.detach().cpu().numpy())
        elif isinstance(comp, S.LinearTransform):
            kaldi_io.write_token(f, "<LearnRateCoef>")
            kaldi_io.write_basic_float(
                f, float(comp.attrs.get("learn_rate_coef", 1.0)))
            kaldi_io.write_matrix(f, comp.w.detach().cpu().numpy())
        elif isinstance(comp, S.Splice):
            kaldi_io.write_int_vector(f, np.asarray(comp.offsets, np.int32))
        elif isinstance(comp, R.BLstmProjectedStreams):
            kaldi_io.write_token(f, "<CellDim>")
            kaldi_io.write_basic_int32(f, comp.fwd.cell_dim)
            kaldi_io.write_token(f, "<ClipGradient>")
            kaldi_io.write_basic_float(f, 5.0)
            _write_lstmp_params(f, comp.fwd)
            _write_lstmp_params(f, comp.bwd)
        elif isinstance(comp, R.LstmProjectedStreams):
            # a CIFG cell too, under its own token, as in the JAX writer
            kaldi_io.write_token(f, "<CellDim>")
            kaldi_io.write_basic_int32(f, comp.cell_dim)
            kaldi_io.write_token(f, "<ClipGradient>")
            kaldi_io.write_basic_float(f, 5.0)
            _write_lstmp_params(f, comp)
        elif type(comp) not in _ACTIVATIONS.values():
            raise KaldiIOError(
                f"cannot export component {comp.token} to .nnet")
    kaldi_io.write_token(f, "</Nnet>")
