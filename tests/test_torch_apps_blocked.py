"""The application layer of the port (kws/, vad/ scoring, ops/segment.py,
utils/profile.py, the KWS and VAD recipes and the 28 CLI names of this
slice) in a process with ``jax`` blocked: at tiny sizes on the CPU each
runs to its result without loading a module of the JAX package
(kaldi_aslp_tpu/)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(os.path.dirname(__file__)))

_NO_JAX_APPS = r"""
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
from kaldi_aslp_tpu_torch.io import (WaveData, int_vector_writer,
                                     matrix_writer, write_wave)
from kaldi_aslp_tpu_torch.models.losses import LossReporter
from kaldi_aslp_tpu_torch.ops import ForwardMaxMatch
from kaldi_aslp_tpu_torch.recipes import kws, vad
from kaldi_aslp_tpu_torch.tree.build_tree import build_tree
from kaldi_aslp_tpu_torch.tree.cluster import GaussStats
from kaldi_aslp_tpu_torch.utils.profile import AccuProfiler, trace

root = sys.argv[1]
j = lambda name: os.path.join(root, name)
D = "--device=cpu"
r_kws = kws.run(j("kws"), num_train=4, num_test=4, device="cpu")
r_vad = vad.run(j("vad"), num_train=4, num_test=2, device="cpu")
art = vad.run.artifacts
lines = []
with matrix_writer("ark:" + j("f.ark")) as fw, \
        int_vector_writer("ark:" + j("ref.ark")) as lw, \
        matrix_writer("ark:" + j("post.ark")) as pw:
    for i, (f, lab, w, p) in enumerate(zip(
            art["test_feats"], art["test_labels"], art["test_wavs"],
            art["test_posteriors"])):
        fw[f"u{i}"], lw[f"u{i}"], pw[f"u{i}"] = f, lab, p
        write_wave(j(f"u{i}.wav"), WaveData(8000.0, w[None]))
        lines.append(f"u{i} " + j(f"u{i}.wav"))
open(j("wav.scp"), "w").write("\n".join(lines) + "\n")
F, R, P = "ark:" + j("f.ark"), "ark:" + j("ref.ark"), "ark:" + j("post.ark")
rcs = [cli(["aslp-apply-energy-vad", D, "scp:" + j("wav.scp"),
            "ark:" + j("e.ark")])]
for name in ("aslp-apply-nn-vad", "aslp-apply-nn-vad-frame",
             "aslp-apply-nnet-vad"):
    rcs.append(cli([name, P, "ark:" + j("m.ark")]))
rcs += [cli(["aslp-apply-nn-vad-segment", P, j("seg.txt")]),
        cli(["aslp-ali-to-sil", R, "ark:" + j("sil.ark")]),
        cli(["aslp-select-frames", F, R, "ark:" + j("speech.ark")])]
with int_vector_writer("ark:" + j("inv.ark")) as w:
    for i, lab in enumerate(art["test_labels"]):
        w[f"u{i}"] = 1 - lab
rcs += [cli(["aslp-select-frames", F, "ark:" + j("inv.ark"),
             "ark:" + j("silf.ark")])]
for name in ("aslp-eval-vad", "aslp-eval-energy-vad", "aslp-eval-nn-vad"):
    rcs.append(cli([name, "ark:" + j("m.ark"), R]))
for name in ("aslp-eval-vad-boundary", "aslp-eval-nn-vad-boundary"):
    rcs.append(cli([name, R, "ark:" + j("m.ark")]) in (0, 1))
rcs += [cli(["gmm-global-init-from-feats", D, "--num-gauss=2",
             "--num-iters=2", "ark:" + j(c + ".ark"), j(c + ".npz")])
        for c in ("silf", "speech")]
rcs += [cli(["aslp-apply-gmm-vad", D, j("silf.npz"), j("speech.npz"), F,
             "ark:" + j("g.ark")]),
        cli(["aslp-eval-gmm-vad", D, j("silf.npz"), j("speech.npz"), F, R])]
open(j("topo.txt"), "w").write("0 1 1 10 0.5\n1 2 2 20\n2\n")
rcs += [cli(["aslp-fst-init", j("topo.txt"), j("fst.txt")]),
        cli(["aslp-fst-info", j("fst.txt")]),
        cli(["aslp-fst-to-dot", j("fst.txt"), j("fst.dot")]),
        cli(["aslp-kws-score", "--keywords=sp:0,1", P])]
open(j("kw.txt"), "w").write("niho ee ii oo\n")
rcs += [cli(["aslp-kws-gen-text-fst", j("kw.txt"), j("kw.fst")])]
ids = {"sil": 1, "a": 2, "b": 3}
rs = np.random.RandomState(0)
stats = {((0, p, 0), c): GaussStats.from_frames(rs.randn(20, 2) + p + c)
         for p in ids.values() for c in range(3)}
tree = build_tree(stats, list(ids.values()), {p: 3 for p in ids.values()},
                  min_gain=1e9)
tm = TransitionModel(HmmTopology.default(list(ids.values())), triples=[
    (p, s, tree.compute((0, p, 0), s)) for p in ids.values()
    for s in range(3)])
pickle.dump(tm, open(j("tm.pkl"), "wb"))
pickle.dump(tree, open(j("tree.pkl"), "wb"))
open(j("phones.txt"), "w").write("<eps> 0\nsil 1\na 2\nb 3\n")
open(j("kw.lex"), "w").write("ab a b\n")
rcs += [cli(["aslp-kws-gen-state-map", j("phones.txt"), j("kw.lex"),
             j("tm.pkl"), j("tree.pkl"), j("tid.map"), j("states.txt")])]
open(j("phone.map"), "w").write("1 1\n2 2\n3 2\n")
with int_vector_writer("ark:" + j("pali.ark")) as w:
    w["u0"] = np.array([1, 2, 3, 3], np.int32)
rcs += [cli(["aslp-kws-convert-phone-ali", j("phone.map"),
             "ark:" + j("pali.ark"), "ark:" + j("kali.ark")])]
open(j("score.txt"), "w").write("u0 0.9\nu1 0.2\n")
open(j("label.txt"), "w").write("u0 1\nu1 0\n")
rcs += [cli(["aslp-kws-evaluation-roc", j("score.txt"), j("label.txt")]),
        cli(["aslp-gen-textgrid", j("vad/segment.info"), j("u0.TextGrid")])]
sys.stdin = io.StringIO("u0 1 2\n")
open(j("sim.scp"), "w").write("simulation_0_u0 x.wav\n")
rcs += [cli(["aslp-kws-generate-simulation-ali", j("sim.scp")])]
rep = LossReporter("xent", progress_step=10)
import logging
logging.getLogger("nnet-loss").addHandler(logging.FileHandler(j("tr.log")))
for k in range(4):
    rep.update({"frames": torch.tensor(11.0), "loss_sum": torch.tensor(5.0)})
rep.frames
os.makedirs(j("logs"))
os.rename(j("tr.log"), j("logs/iter1.tr.log"))
rcs += [cli(["aslp-log-analyse", j("logs/iter1.tr.log")]),
        cli(["aslp-log-analyse-ctc", j("logs/iter1.tr.log")]),
        cli(["aslp-mpi-log-analyse", j("logs")])]
prof = AccuProfiler()
with prof.region("x", sync=torch.ones(1)):
    with trace(j("prof")):
        torch.ones(4) + 1
seg = ForwardMaxMatch(["ab", "abc"]).segment("abcab")
shared = sorted({m.split(".")[1] for m in sys.modules
                 if m.startswith("kaldi_aslp_tpu.")})
print("RESULT", rcs, sorted(r_kws), sorted(r_vad), seg,
      os.path.exists(j("prof/trace.json")), "jax" in sys.modules, shared)
"""


def test_apps_run_with_jax_blocked(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_APPS, str(tmp_path)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = ("RESULT [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, True, True, 0, 0, 0, "
            "0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0] "
            "['kws_auc', 'kws_best_acc'] "
            "['dnn_auc', 'dnn_eer', 'energy_auc', 'energy_eer', 'gmm_auc', "
            "'gmm_eer', 'num_segments'] ['abc', 'ab'] True False []")
    assert want in proc.stdout, proc.stdout[-3000:]
    assert "num-states 3" in proc.stdout
    assert "simulation_0_u0 1 2" in proc.stdout
