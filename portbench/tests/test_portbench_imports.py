"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's),
and the references load nothing of the port."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness import cells, runner

FILES = sorted(cells.BENCH_DIR.rglob("*.py"))
REFERENCE = sorted((cells.BENCH_DIR / "reference").glob("*.py"))


def _imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_file_imports_jax(path):
    assert not set(_imported_tops(path)) & set(runner.FORBIDDEN)


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    assert "kaldi_aslp_tpu_torch" not in set(_imported_tops(path))


def _run(code: str) -> str:
    proc = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_a_dry_run_loads_no_jax():
    """Every cell, cut to the CPU's size, run untraced and traced in one
    process, then the forbidden names looked up in sys.modules."""
    out = _run(
        "import sys\n"
        "from portbench.tests import tiny\n"
        "from portbench.harness import runner\n"
        "for name in ['blstm_ctc.train', 'blstm_ctc.posteriors',\n"
        "             'blstm_ctc.train_long']:\n"
        "    for traced in (False, True):\n"
        "        runner.run(tiny.found(name, profile_steps=1), 7, 0.05,\n"
        "                   traced, 'cpu')\n"
        "print('LOADED', runner.forbidden_modules())\n"
        "print('PORT', 'kaldi_aslp_tpu_torch' in sys.modules)\n")
    assert "LOADED []" in out
    assert "PORT True" in out


def test_the_references_load_nothing_of_the_port():
    modules = ", ".join(f"portbench.reference.{p.stem}" for p in REFERENCE
                        if p.stem != "__init__")
    out = _run(
        "import sys\n"
        f"import {modules}\n"
        "print(sorted(n for n in sys.modules\n"
        "             if n.split('.')[0].startswith('kaldi_aslp')))\n")
    assert out.strip() == "[]"
