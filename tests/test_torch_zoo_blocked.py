"""The nnet zoo, the .nnet import and the 17 CLI names of the zoo slice in
a process with ``jax`` blocked: at tiny sizes on the CPU each runs to its
result without loading a module of the JAX package (kaldi_aslp_tpu/)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(os.path.dirname(__file__)))

_NO_JAX_ZOO = r"""
import importlib.abc, io, os, pickle, sys


class BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name} is blocked in this process")
        return None


sys.meta_path.insert(0, BlockJax())
import numpy as np
import torch
torch.set_num_threads(1)
from kaldi_aslp_tpu_torch.cli.__main__ import main as cli
from kaldi_aslp_tpu_torch.hmm import HmmTopology, TransitionModel
from kaldi_aslp_tpu_torch.io import int_vector_writer, matrix_writer
from kaldi_aslp_tpu_torch import models as M
from kaldi_aslp_tpu_torch.models import kaldi_import
from kaldi_aslp_tpu_torch.ops.ctc import collapse_ctc_path, ctc_greedy_decode

root = sys.argv[1]
j = lambda name: os.path.join(root, name)
D = "--device=cpu"
rs = np.random.RandomState(0)
proto = "\n".join([
    "<Splice> <InputDim> 4 <OutputDim> 12 <BuildVector> -1:1",
    "<ConvolutionalComponent> <InputDim> 12 <OutputDim> 8 <PatchDim> 2 "
    "<PatchStep> 2 <PatchStride> 4",
    "<MaxPoolingComponent> <InputDim> 8 <OutputDim> 4 <PoolSize> 2 "
    "<PoolStride> 2",
    "<BatchNormalization> <InputDim> 4 <OutputDim> 4",
    "<LinearTransform> <InputDim> 4 <OutputDim> 6",
    "<CompactFsmn> <InputDim> 6 <OutputDim> 6 <LOrder> 2 <ROrder> 1",
    "<RowConvolution> <InputDim> 6 <OutputDim> 6 <FutureCtx> 1",
    "<LstmCifgProjectedStreams> <InputDim> 6 <OutputDim> 4 <CellDim> 5",
    "<GruStreams> <InputDim> 4 <OutputDim> 6",
    "<BLstmProjectedStreamsLC> <InputDim> 6 <OutputDim> 8 <CellDim> 5 "
    "<ChunkSize> 3",
    "<Pnorm> <InputDim> 8 <OutputDim> 4",
    "<Dropout> <InputDim> 4 <OutputDim> 4",
    "<AffineTransform> <InputDim> 4 <OutputDim> 3"])
open(j("zoo.proto"), "w").write(proto)
with matrix_writer("ark:" + j("f.ark")) as fw, \
        int_vector_writer("ark:" + j("a.ark")) as aw:
    for u in range(4):
        fw[f"u{u}"] = rs.randn(7 + u, 4).astype(np.float32)
        aw[f"u{u}"] = rs.randint(0, 3, 7 + u).astype(np.int32)
F, A = "ark:" + j("f.ark"), "ark:" + j("a.ark")
rcs = [cli(["aslp-nnet-init", D, j("zoo.proto"), j("zoo.zip")]),
       cli(["aslp-nnet-info", D, j("zoo.zip")]),
       cli(["aslp-nnet-copy", D, j("zoo.zip"), j("copy.zip")]),
       cli(["aslp-nnet-dot", D, j("zoo.zip"), j("zoo.dot")]),
       cli(["aslp-nnet-train-blstm-streams-lc", D, "--num-streams=2",
            "--batch-size=5", F, A, j("zoo.zip"), j("trained.zip")]),
       cli(["aslp-nnet-forward-blstm-lc", D, j("trained.zip"), F,
            "ark:" + j("ll.ark")]),
       cli(["aslp-nnet-forward-mimo", D, j("trained.zip"), F,
            "ark:" + j("mimo.ark")]),
       cli(["aslp-nnet-train-frame-mimo", D, "--minibatch-size=8", F, A,
            j("zoo.zip"), j("mimo.zip")]),
       cli(["aslp-nnet-convert-to-standard", D, j("zoo.zip"),
            j("std.zip")])]
open(j("h.proto"), "w").write(
    "<AffineTransform> <InputDim> 4 <OutputDim> 4\n<Tanh> <InputDim> 4 "
    "<OutputDim> 4")
rcs += [cli(["aslp-nnet-init", D, j("h.proto"), j("h.zip")]),
        cli(["aslp-nnet-insert", D, j("zoo.zip"), j("h.zip"),
             j("ins.zip")])]
tm = TransitionModel(HmmTopology.default([1, 2, 3], sil_phones=[3]),
                     lambda p, c: p - 1)
pickle.dump(tm, open(j("tm.pkl"), "wb"))
rcs += [cli(["aslp-extract-transition-to-pdf", j("tm.pkl"), j("lut.txt")])]
with int_vector_writer("ark:" + j("tid.ark")) as w:
    w["u0"] = np.arange(1, tm.num_transition_ids + 1, dtype=np.int32)
rcs += [cli([t, j("lut.txt"), "ark:" + j("tid.ark"), "ark:" + j("p.ark")])
        for t in ("ali-to-pdf", "aslp-ali-to-pdf")]
rcs += [cli(["aslp-ali-minus-one", "ark:" + j("tid.ark"),
             "ark:" + j("m1.ark")]),
        cli(["analyze-counts", A, j("counts.txt")]),
        cli(["aslp-ali-to-matrix", "--dict-size=3", A, "ark:" + j("oh.ark")]),
        cli(["aslp-matrix-to-txt", "ark:" + j("oh.ark"), j("oh.txt")])]
# aslp-txt-to-matrix reads blocks separated by blank lines
open(j("blocks.txt"), "w").write("k0\n1 2\n3 4\n\nk1\n5 6\n")
rcs += [cli(["aslp-txt-to-matrix", j("blocks.txt"), "ark:" + j("back.ark")]),
        cli(["aslp-copy-vector-from-matrix", "--column=1",
             "ark:" + j("oh.ark"), "ark:" + j("col.ark")])]
net, _ = M.Nnet.load(j("trained.zip"), "cpu")
std = M.Nnet()
std.add(M.AffineTransform(4, 3))
std.add(M.Softmax(3, 3))
buf = io.BytesIO()
kaldi_import.write_kaldi_nnet_standard(buf, std)
back = kaldi_import.read_kaldi_nnet(io.BytesIO(buf.getvalue()))
path = ctc_greedy_decode(torch.randn(1, 6, 3))
collapse_ctc_path(path[0], 6)
shared = sorted({m.split(".")[1] for m in sys.modules
                 if m.startswith("kaldi_aslp_tpu.")})
print("RESULT", rcs, len(net.nodes), len(back.nodes),
      "jax" in sys.modules, shared)
"""


def test_zoo_and_nnet_tools_run_with_jax_blocked(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_ZOO, str(tmp_path)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RESULT [" + ", ".join(["0"] * 20) + "] 13 2 False []" in \
        proc.stdout, proc.stdout[-2000:]
    assert "number-of-parameters" in proc.stdout
    assert proc.stdout.count("AvgLoss") == 2
