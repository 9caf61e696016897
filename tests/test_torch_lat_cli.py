"""Kaldi's offline decode-and-score chain through the port's CLI on the
CPU, in a subprocess where JAX cannot be imported, against the JAX
package's tools on the same inputs:

    aslp-nnet-forward model feats -> loglikes
      -> latgen-faster-mapped tid2pdf TLG -> lattices + words
      -> lattice-copy (to text) -> lattice-scale -> lattice-determinize
      -> lattice-lmrescore (-1 x the old G, +1 x a new G)
      -> lattice-best-path -> compute-wer

Inputs (made from seeds with numpy and torch): a BLSTMP CTC model at
tiny widths saved in the JAX zip format, three utterances of 5-dim
features, the yes/no CTC TLG of tests/test_lattice_io.py and its
grammar.  Tolerances: the forward's log-likelihoods within 1e-5 of
JAX's (float32 recurrences in a different order); from there on both
chains read the port's log-likelihoods, and every file they write
(lattices binary and text, transcripts, alignments) and compute-wer's
report are byte-equal.  JAX's tools run in this process with its numpy
lattice build (see tests/test_torch_lattice.py)."""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu import native as jax_native
from kaldi_aslp_tpu.cli import lat_tools as jax_lat_tools
from kaldi_aslp_tpu.cli import nnet_tools as jax_nnet_tools
from kaldi_aslp_tpu.fst import Lang as JaxLang, Lexicon as JaxLexicon
from kaldi_aslp_tpu.fst import make_unigram_grammar as jax_unigram
from kaldi_aslp_tpu.fst.ctc_graph import (
    ctc_lut as jax_ctc_lut,
    make_ctc_decode_graph as jax_ctc_graph,
)
from kaldi_aslp_tpu_torch.io import matrix_writer, sequential_matrix_reader
from kaldi_aslp_tpu_torch.models.flagship import build_blstm_ctc

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORWARD_TOL = 1e-5
FEAT_DIM = 5

# the chain: (tool, arguments), paths relative to a work directory
CHAIN = [
    ("aslp-nnet-forward", ["model.zip", "ark:feats.ark", "ark:ll.ark"]),
    ("aslp-nnet-forward-skip", ["--skip-width=2", "model.zip",
                                "ark:feats.ark", "ark:ll_skip.ark"]),
    ("latgen-faster-mapped", ["--max-active=64", "tid2pdf.txt", "TLG.txt",
                              "ark:LL", "ark:lat.ark", "ark,t:words.txt"]),
    ("lattice-copy", ["ark:lat.ark", "ark,t:lat.txt"]),
    ("lattice-scale", ["--acoustic-scale=0.1", "ark,t:lat.txt",
                       "ark:scaled.ark"]),
    ("lattice-determinize", ["ark:scaled.ark", "ark:det.ark"]),
    ("lattice-determinize", ["--beam=4.0", "ark:scaled.ark",
                             "ark,t:det_pruned.txt"]),
    ("lattice-lmrescore", ["--lm-scale=-1.0", "ark:det.ark", "G.txt",
                           "ark:no_g.ark"]),
    ("lattice-lmrescore", ["ark:no_g.ark", "G_new.txt", "ark:resc.ark"]),
    ("lattice-best-path", ["ark:resc.ark", "ark,t:tra.txt",
                           "ark,t:ali.txt"]),
    ("lattice-best-path", ["--acoustic-scale=0.1", "ark:lat.ark",
                           "ark,t:tra_raw.txt"]),
    ("compute-wer", ["ark:words.txt", "ark:tra.txt"]),
]
DEVICE_TOOLS = ("aslp-nnet-forward", "aslp-nnet-forward-skip",
                "latgen-faster-mapped")
OUTPUTS = ["lat.ark", "words.txt", "lat.txt", "scaled.ark", "det.ark",
           "det_pruned.txt", "no_g.ark", "resc.ark", "tra.txt", "ali.txt",
           "tra_raw.txt"]

_NO_JAX_CHAIN = r"""
import importlib.abc
import json
import os
import sys


class BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name} is blocked in this process")
        return None


sys.meta_path.insert(0, BlockJax())
import io
from contextlib import redirect_stdout
import torch
torch.set_num_threads(1)
from kaldi_aslp_tpu_torch.cli.__main__ import main
os.chdir(sys.argv[1])
reports = []
for tool, args in json.loads(sys.argv[2]):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main([tool] + args)
    if rc != 0:
        raise SystemExit(f"{tool} exited {rc}")
    reports.append(out.getvalue())
shared = sorted({m.split(".")[1] for m in sys.modules
                 if m.startswith("kaldi_aslp_tpu.")})
print("RESULT", "jax" in sys.modules, shared)
print("REPORT", json.dumps(reports[-1]))
"""


def _write_inputs(work):
    lang = JaxLang.build(JaxLexicon.from_text("YES Y\nNO N\n<SIL> SIL\n"))
    V = len(lang.phones)
    tlg = jax_ctc_graph(lang, jax_unigram({"YES": 0.6, "NO": 0.4},
                                          lang.words))
    (work / "TLG.txt").write_text(tlg.to_text())
    np.savetxt(work / "tid2pdf.txt", jax_ctc_lut(V), fmt="%d")
    (work / "G.txt").write_text(
        jax_unigram({"YES": 0.6, "NO": 0.4}, lang.words).to_text())
    (work / "G_new.txt").write_text(
        jax_unigram({"YES": 0.3, "NO": 0.7}, lang.words).to_text())
    net = build_blstm_ctc(FEAT_DIM, 1, 4, 6, V)
    net.reset_parameters(torch.Generator().manual_seed(5))
    net.save(str(work / "model.zip"))
    rng = np.random.RandomState(31)
    with matrix_writer(f"ark:{work}/feats.ark") as w:
        for i, T in enumerate((9, 14, 11)):
            w[f"utt{i}"] = rng.randn(T, FEAT_DIM).astype(np.float32)


def _chain(device_flag, ll_file):
    out = []
    for tool, args in CHAIN:
        args = [a.replace("ark:LL", f"ark:{ll_file}") for a in args]
        if device_flag and tool in DEVICE_TOOLS:
            args = [device_flag] + args
        out.append((tool, args))
    return out


JAX_TOOLS = {
    "aslp-nnet-forward": jax_nnet_tools.nnet_forward_cli,
    "aslp-nnet-forward-skip": jax_nnet_tools.nnet_forward_cli,
    "latgen-faster-mapped": jax_lat_tools.latgen_faster_mapped_cli,
    "lattice-copy": jax_lat_tools.lattice_copy_cli,
    "lattice-scale": jax_lat_tools.lattice_scale_cli,
    "lattice-determinize": jax_lat_tools.lattice_determinize_cli,
    "lattice-lmrescore": jax_lat_tools.lattice_lmrescore_cli,
    "lattice-best-path": jax_lat_tools.lattice_best_path_cli,
    "compute-wer": jax_nnet_tools.compute_wer,
}


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    port = tmp_path_factory.mktemp("port")
    _write_inputs(port)
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_CHAIN, str(port),
         json.dumps(_chain("--device=cpu", "ll.ark"))],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    # the JAX tools on the same inputs, reading the port's loglikes
    jax_dir = tmp_path_factory.mktemp("jax")
    for name in ("TLG.txt", "tid2pdf.txt", "G.txt", "G_new.txt",
                 "model.zip", "feats.ark"):
        (jax_dir / name).write_bytes((port / name).read_bytes())
    (jax_dir / "port_ll.ark").write_bytes((port / "ll.ark").read_bytes())
    cwd = os.getcwd()
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "lattice_build", lambda *a, **k: None)
    try:
        os.chdir(jax_dir)
        for tool, args in _chain(None, "port_ll.ark"):
            out = io.StringIO()
            with redirect_stdout(out):
                assert JAX_TOOLS[tool](args) == 0, tool
        jax_report = out.getvalue()
    finally:
        os.chdir(cwd)
        mp.undo()
    return dict(port=port, jax=jax_dir, lines=lines, jax_report=jax_report)


def test_chain_runs_with_jax_blocked(chains):
    assert "RESULT False []" in chains["lines"], chains["lines"][-5:]
    for name in OUTPUTS:
        assert (chains["port"] / name).stat().st_size > 0, name


@pytest.mark.parametrize("name", ["ll.ark", "ll_skip.ark"])
def test_forward_matches_jax(chains, name):
    got = dict(sequential_matrix_reader(f"ark:{chains['port']}/{name}"))
    want = dict(sequential_matrix_reader(f"ark:{chains['jax']}/{name}"))
    assert sorted(got) == sorted(want) == ["utt0", "utt1", "utt2"]
    for k in got:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=FORWARD_TOL)
    if name == "ll_skip.ark":
        # copy mode: every second frame's scores, each twice
        full = dict(sequential_matrix_reader(
            f"ark:{chains['port']}/ll.ark"))
        assert not np.array_equal(got["utt0"][1], full["utt0"][1])
        np.testing.assert_array_equal(got["utt0"][1], got["utt0"][0])


@pytest.mark.parametrize("name", OUTPUTS)
def test_outputs_are_jax_bytes(chains, name):
    got = (chains["port"] / name).read_bytes()
    assert got == (chains["jax"] / name).read_bytes()


def test_compute_wer_report_matches_jax(chains):
    report = next(l for l in chains["lines"] if l.startswith("REPORT "))
    got = json.loads(report[len("REPORT "):])
    assert got == chains["jax_report"]
    assert got.startswith("%WER ") and "%SER " in got


def test_device_tools_default_to_the_card(tmp_path):
    """Without --device the forward and the lattice generator ask for
    the card, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from kaldi_aslp_tpu_torch.cli.__main__ import main
    _write_inputs(tmp_path)
    for tool, args in _chain(None, "ll.ark")[:3:2]:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([tool] + [a if ":" in a or a.startswith("--") else
                           str(tmp_path / a) for a in args])
