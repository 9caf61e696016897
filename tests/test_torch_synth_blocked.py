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
