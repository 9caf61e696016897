"""The synthetic-corpus recipes, the GMM budget sweep, the data-dir runner
and the tree tools in a process with ``jax`` blocked: at tiny sizes on
the CPU they run to their results without loading a module of the JAX
package (kaldi_aslp_tpu/), as the port's other jax-blocked tests show
for its earlier slices."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX_SYNTH = r"""
import importlib.abc, sys


class BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name} is blocked in this process")
        return None


sys.meta_path.insert(0, BlockJax())
import os
import torch
torch.set_num_threads(1)
sys.path.insert(0, os.path.join(sys.argv[2], "tests"))
import test_torch_ladder as t
from kaldi_aslp_tpu_torch.cli.__main__ import main as cli
from kaldi_aslp_tpu_torch.recipes import (
    corpus, decode_budget_sweep, ls_synth, rm_synth, timit_synth, yesno)
root = sys.argv[1]
ls = ls_synth.run(os.path.join(root, "ls"), num_words=10, num_train=16,
                  num_test=3, layers=1, proj=8, cell=12, num_streams=4,
                  max_iters=2, rescore_text_mult=4, lm_text_mult=2,
                  bucket_t=64, max_len=4, lattice_beam=1.0,
                  learn_rate=0.06, keep_lr=45, num_decode=2, device="cpu")
decoded = sorted(ls_synth.run.artifacts["lats"])
wer = yesno.run(os.path.join(root, "yesno"), num_utts=6, device="cpu")
dirs = yesno.run.artifacts["dirs"]
lex = os.path.join(root, "lexicon.txt")
with open(lex, "w") as f:
    f.write("<SIL> SIL\nYES Y\nNO N\n")
from kaldi_aslp_tpu_torch.recipes.hybrid import HybridRecipeOptions
st = corpus.run_corpus(
    dirs["train_yesno"].path, dirs["test_yesno"].path,
    os.path.join(root, "corpus"),
    corpus.CorpusRecipeOptions(pipeline="hybrid", lexicon=lex,
                               num_mel_bins=23, device="cpu"),
    HybridRecipeOptions(hidden_dim=16, num_layers=1, max_iters=2,
                        mono_iters=3, mono_totgauss=20))
decode_budget_sweep._Scale = t.tiny_scale
sweep = decode_budget_sweep.run("small", [64], corpus=t.tiny_corpus(),
                                device="cpu")
rc = cli(["aslp-cluster-kmeans-cd-phone-test"])
shared = sorted({m.split(".")[1] for m in sys.modules
                 if m.startswith("kaldi_aslp_tpu.")})
print("RESULT", sorted(ls), decoded, wer >= 0, st.wer >= 0, list(sweep), rc,
      "jax" in sys.modules, shared)
"""


def test_synth_recipes_and_tree_tools_run_with_jax_blocked(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_SYNTH, str(tmp_path), REPO],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert ("RESULT ['per', 'rtf', 'train_tput', 'wer_large', 'wer_small'] "
            "['utt0000', 'utt0001'] True True [64] 0 False []"
            ) in proc.stdout, proc.stdout[-2000:]
    assert "LS_SYNTH per=" in proc.stdout


_NO_JAX_HKUST = r"""
import importlib.abc, io, os, sys


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
from kaldi_aslp_tpu_torch.io import WaveData, write_wave
from kaldi_aslp_tpu_torch.recipes import hard_corpus as hc, hkust_synth as hk


class Tiny:
    def __init__(self, name):
        self.num_words = 12
        self.corpus = hc.HardCorpusOptions(
            num_words=12, num_train_speakers=2, num_test_speakers=1)
        self.num_train, self.num_test, self.lm_mult = 24, 4, 2
        self.hidden, self.layers, self.iters = 8, 1, 2
        self.bind_thresh = 3
        self.learn_rate = 0.06


hk._Scale = Tiny
root = sys.argv[1]
out = hk.run(os.path.join(root, "hkust"), "tiny", device="cpu")
corpus = hk.run.artifacts["corpus"]
lines = []
for i, t in enumerate(sorted(corpus["test_texts"])[:2]):
    f = np.random.RandomState(i).randn(8000).astype(np.float32) * 300
    path = os.path.join(root, f"w{i}.wav")
    write_wave(path, WaveData(8000.0, f[None]))
    lines.append(f"w{i} {path}")
scp = os.path.join(root, "wav.scp")
open(scp, "w").write("\n".join(lines) + "\n")
j = lambda name: os.path.join(root, name)
D = "--device=cpu"
rcs = [
    cli(["compute-mfcc-feats", D, "--sample-frequency=8000", f"scp:{scp}",
         f"ark:{j('m.ark')}"]),
    cli(["compute-fbank-feats", D, "--sample-frequency=8000", f"scp:{scp}",
         f"ark:{j('f.ark')}"]),
    cli(["copy-feats", D, f"ark:{j('m.ark')}", f"ark:{j('c.ark')}"]),
    cli(["compute-cmvn-stats", D, f"ark:{j('m.ark')}", f"ark:{j('s.ark')}"]),
    cli(["apply-cmvn", D, f"ark:{j('s.ark')}", f"ark:{j('m.ark')}",
         f"ark:{j('n.ark')}"]),
    cli(["add-deltas", D, f"ark:{j('n.ark')}", f"ark:{j('d.ark')}"]),
    cli(["splice-feats", D, f"ark:{j('d.ark')}", f"ark:{j('p.ark')}"]),
    cli(["feat-to-dim", D, f"ark:{j('p.ark')}"]),
    cli(["compute-kaldi-pitch-feats", D, f"scp:{scp}", f"ark:{j('k.ark')}"]),
    cli(["aslp-compute-spectrum-feats", D, f"scp:{scp}",
         f"ark:{j('sp.ark')}"]),
]
open(j("lex.txt"), "w").write("".join(
    ln + "\n" for ln in corpus["lexicon_text"].splitlines()
    if not ln.startswith("<SIL>")))
rcs.append(cli(["aslp-convert-lexicon-to-syllable", j("lex.txt"),
                j("syl.txt")]))
open(j("counts.txt"), "w").write("ba1 9\nba2 1\n")
rcs.append(cli(["aslp-bind-syllable", "--thresh=3", j("counts.txt")]))
open(j("bind.txt"), "w").write("ba1 ba1\nba2 ba1\n")
open(j("syl2.txt"), "w").write("W ba2 ba1\n")
rcs.append(cli(["aslp-bind-lexicon", j("bind.txt"), j("syl2.txt")]))
open(j("phones.txt"), "w").write("b 1\na1 2\na2 3\n")
open(j("sylls.txt"), "w").write("ba1 1\n")
sys.stdin = io.StringIO("u 1 1 3 3\n")
rcs.append(cli(["aslp-ali-to-syllable", j("phones.txt"), j("sylls.txt"),
                j("bind.txt")]))
rcs.append(cli(["aslp-wav-noise", f"scp:{scp}", j("noisy")]))
shared = sorted({m.split(".")[1] for m in sys.modules
                 if m.startswith("kaldi_aslp_tpu.")})
print("RESULT", sorted(out), len(rcs), rcs, "jax" in sys.modules, shared,
      sorted(os.listdir(j("noisy"))))
"""


def test_hkust_recipe_and_feature_tools_run_with_jax_blocked(tmp_path):
    """hkust_synth at a tiny preset and the 15 feature, pitch, spectrum,
    syllable and noise tools, with ``jax`` blocked."""
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_HKUST, str(tmp_path), REPO],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert ("RESULT ['ctc', 'greedy_ser'] 15 [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, "
            "0, 0, 0, 0, 0] False [] ['w0.wav', 'w1.wav']") in proc.stdout, \
        proc.stdout[-2000:]
    assert "HKUST_SYLLABLE_CTC_WER" in proc.stdout
    assert "u 1 1 1 1" in proc.stdout and "W ba1 ba1" in proc.stdout
