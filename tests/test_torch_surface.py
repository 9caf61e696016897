"""The JAX package's public surface in the port, read from source by AST
(no import): kaldi_aslp_tpu/ against kaldi_aslp_tpu_torch/.

For every module of the JAX package the port must have the module; every
public top-level name it defines (a ``def``, ``class`` or assignment),
every name an ``__init__`` re-exports, and the few names the JAX modules
take from a sibling that the port keeps there too (``REACHED``); every
public method of every public class; and every parameter name of those
functions and methods.  Names a module imports only for its own use are
not surface.  Each departure is an entry of ``EXCEPTIONS`` with its
reason: a module, ``module:name``, ``module:Class.method``, a parameter
``module:function(param)``, or ``*`` for a name, method or parameter in
every module.  An exception that no longer matches a difference fails
too, so the list stays the list of what differs.

Also: the port's ``ops.ctc_alpha_beta`` is JAX's function, not the
kernel module, after every submodule of ``ops`` has been imported; the
``Fst`` algebra, ``Config`` helpers, ``read_matrix(binary=False)`` and
``ContextDependency.pdf_map`` against JAX's; and a process in which
``jax`` and the JAX package are unimportable imports every subpackage of
the port."""

import ast
import importlib
import io
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.abspath(os.path.dirname(__file__)))
JAX_ROOT = os.path.join(REPO, "kaldi_aslp_tpu")
PORT_ROOT = os.path.join(REPO, "kaldi_aslp_tpu_torch")

MODULE_IDIOM = ("the nn.Module idiom: a port component owns its parameters "
                "and runs in forward(); reset_parameters(generator) draws "
                "them")
PARAMS_ARG = ("the nn.Module idiom: modules own their parameters, so no "
              "params pytree is passed")
KEY_ARG = "a JAX PRNG key becomes a torch.Generator (generator=)"
SHARDING = ("XLA sharding and shape bucketing: the port shards by process "
            "group (mesh.shard_batch) and runs ragged shapes as they are")
TUNNEL = "serves the TPU tunnel, which the port does not port (ROADMAP)"

EXCEPTIONS = {
    "data.transport": TUNNEL,
    "data.device_cache": TUNNEL + "; the recipe keeps its batch order",
    "data.prefetch": TUNNEL + "; the trainers copy one batch ahead",
    "native.__init__": "C++ host helpers with pure-Python fallbacks; the "
                       "port runs the Python paths",
    "ops.lstm_pallas": "TPU kernels, ported as csrc/*.cu",
    "ops.ctc_pallas": "TPU kernels, ported as csrc/ctc_alpha_beta.cu",
    "tree.build_tree:acc_tree_stats": "a JAX stub that raises "
                                      "NotImplementedError",
    "gmm.diag_gmm:gmm_loglikes_bucketed": SHARDING,
    "decoder.online:OnlineViterbiDecoder.__init__(chunk_bucket)": SHARDING,
    "parallel.__init__:data_sharding": SHARDING,
    "parallel.__init__:replicated": SHARDING,
    "parallel.mesh:data_sharding": SHARDING,
    "parallel.mesh:replicated": SHARDING,
    "parallel.mesh:make_mesh(devices)": SHARDING,
    "parallel.bsp:make_bsp_train_step(batch_spec)": SHARDING,
    "parallel.ps:make_ps_round_step(mesh)": SHARDING,
    "parallel.ps:make_ps_round_step(axis)": SHARDING,
    "parallel.ps:make_ps_round_step(opts)": "the server's options live on "
                                            "the round's state (PsState)",
    "parallel.ps:tmap": "an alias of jax.tree_util.tree_map",
    "parallel.mesh:initialize_distributed(coordinator)":
        "torch.distributed takes an init_method, world size and rank",
    "parallel.mesh:initialize_distributed(num_processes)":
        "torch.distributed takes an init_method, world size and rank",
    "parallel.mesh:initialize_distributed(process_id)":
        "torch.distributed takes an init_method, world size and rank",
    "parallel.convergence:run_comparison_subprocess":
        "the port's run_comparison_groups: one process group a strategy",
    "parallel.convergence:run_convergence_comparison(n_devices)":
        "ranks, not devices of one process: n_workers",
    "train.trainer:CtcTrainer.__init__(transport)": TUNNEL,
    "train.trainer:CtcTrainer.make_cache": TUNNEL,
    "train.trainer:CtcTrainer.train_epoch(cache)": TUNNEL,
    "train.trainer:logger": "JAX's trainer module defines a logger it "
                            "never uses",
    "recipes.yesno:REF_INPUT_DIR": "a fixed reference checkout path; the "
                                   "port reads KALDI_ASLP_REFERENCE "
                                   "(task_input_dir)",
    "online.batching:BatchedSessionMixin.finalize_sync":
        "defined once on the port's DecodeSession, which the batched "
        "sessions inherit",
    "io.table:Specifier.__init__(for_write)": "the port parses a "
                                              "specifier the same way "
                                              "for reading and writing",
    "*:apply": MODULE_IDIOM,
    "*:init_params": MODULE_IDIOM,
    "*:init": MODULE_IDIOM,
    "*:param_list": MODULE_IDIOM,
    "*:feedforward": MODULE_IDIOM,
    "*(params)": PARAMS_ARG,
    "*(base_params)": PARAMS_ARG,
    "*(ins_params)": PARAMS_ARG,
    "*(key)": KEY_ARG,
}

# names a JAX module takes from a sibling module, kept there in the port
REACHED = {
    "feats.mfcc": ("compute_power_spectrum", "extract_frames",
                   "process_window"),
    "decoder.batched": ("NEG_INF",),
    "recipes.ls_synth": ("PHONES",),
}


def modules(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), root)[:-3]
                out[rel.replace(os.sep, ".")] = os.path.join(d, f)
    return out


def params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def surface(path, is_init):
    """({public name}, {"Class.method": [params]} and {"fn": [params]},
    {every name bound at top level})."""
    tree = ast.parse(open(path).read())
    names, sigs, bound = set(), {}, set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            bound.add(node.name)
            if not node.name.startswith("_"):
                names.add(node.name)
                sigs[node.name] = params(node)
        elif isinstance(node, ast.ClassDef):
            bound.add(node.name)
            names.add(node.name)
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and (not m.name.startswith("_")
                             or m.name == "__init__"):
                    sigs[f"{node.name}.{m.name}"] = params(m)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name):
                    bound.add(t.id)
                    names.add(t.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                name = (a.asname or a.name).split(".")[0]
                bound.add(name)
                if is_init:
                    names.add(name)
    return {n for n in names if not n.startswith("_")}, sigs, bound


def excepted(mod, item):
    """The reason ``item`` of ``mod`` may differ, or None."""
    for key in (mod, f"{mod}:{item}"):
        if key in EXCEPTIONS:
            return key
    base = item.split("(")[0].split(".")[-1]
    if "(" in item:
        key = "*(" + item.split("(")[1]
    else:
        key = f"*:{base}"
    return key if key in EXCEPTIONS else None


def surface_differences():
    """[(exception key or None, "module:item")] of every JAX name,
    method or parameter the port lacks."""
    jax_mods, port_mods = modules(JAX_ROOT), modules(PORT_ROOT)
    out = []
    for mod in sorted(jax_mods):
        if mod not in port_mods:
            out.append((excepted(mod, ""), mod))
            continue
        init = mod.endswith("__init__") or mod == "__init__"
        jnames, jsigs, _ = surface(jax_mods[mod], init)
        pnames, psigs, pbound = surface(port_mods[mod], init)
        items = sorted(jnames - pbound)
        items += [n for n in REACHED.get(mod, ()) if n not in pbound]
        for name, jparams in sorted(jsigs.items()):
            cls = name.split(".")[0]
            if "." in name and cls not in pbound:
                continue                    # the class itself is reported
            if name not in psigs:
                if "." in name:     # a missing function is in ``items``
                    items.append(name)
                continue
            items += [f"{name}({p})" for p in jparams
                      if p not in psigs[name]]
        out += [(excepted(mod, i), f"{mod}:{i}") for i in items]
    return out


def test_port_has_the_jax_packages_surface():
    diffs = surface_differences()
    missing = [item for key, item in diffs if key is None]
    assert not missing, missing
    used = {key for key, _ in diffs}
    stale = sorted(set(EXCEPTIONS) - used)
    assert not stale, f"exceptions that match no difference: {stale}"


def test_the_reached_names_are_jax_sibling_imports():
    """Each ``REACHED`` name is one the JAX module imports from a module
    of its own subpackage."""
    for mod, names in REACHED.items():
        tree = ast.parse(open(modules(JAX_ROOT)[mod]).read())
        sub = "kaldi_aslp_tpu." + mod.rsplit(".", 1)[0] + "."
        got = {a.asname or a.name for n in tree.body
               if isinstance(n, ast.ImportFrom) and n.module
               and n.module.startswith(sub) for a in n.names}
        assert set(names) <= got, (mod, set(names) - got)


def test_package_names_import():
    from kaldi_aslp_tpu_torch.feats import Fbank
    from kaldi_aslp_tpu_torch.ops import ctc_alpha_beta, ctc_loss
    from kaldi_aslp_tpu_torch.utils import Config, ThroughputMeter
    from kaldi_aslp_tpu_torch.utils.log import Timer, verbose_level, vlog

    assert callable(ctc_alpha_beta) and callable(ctc_loss)
    assert Fbank.__module__ == "kaldi_aslp_tpu_torch.feats.fbank"
    assert issubclass(ThroughputMeter, object) and Config.to_dict
    assert verbose_level() >= 0 and vlog and Timer().elapsed() >= 0.0


def test_ctc_alpha_beta_stays_the_function():
    """After every submodule of ``ops`` is imported, ``ops.ctc_alpha_beta``
    is JAX's function (ops/ctc.py) and the kernel's module is
    ``ops.ctc_recursions``; ``ops.edit_distance`` is the function too, as
    in JAX's package."""
    import kaldi_aslp_tpu_torch.ops as ops

    for m in pkgutil.iter_modules(ops.__path__):
        importlib.import_module(f"kaldi_aslp_tpu_torch.ops.{m.name}")
    from kaldi_aslp_tpu_torch.ops import ctc, ctc_recursions

    assert ops.ctc_alpha_beta is ctc.ctc_alpha_beta
    assert ops.edit_distance.__module__.endswith("ops.edit_distance")
    assert callable(ops.edit_distance)
    assert ctc_recursions.ctc_alpha_beta.launches >= 0


def test_host_helpers_read_torchrun(monkeypatch):
    from kaldi_aslp_tpu_torch.parallel import mesh

    monkeypatch.delenv("GROUP_WORLD_SIZE", raising=False)
    monkeypatch.delenv("GROUP_RANK", raising=False)
    assert (mesh.num_hosts(), mesh.host_index()) == (1, 0)
    monkeypatch.setenv("GROUP_WORLD_SIZE", "3")
    monkeypatch.setenv("GROUP_RANK", "2")
    assert (mesh.num_hosts(), mesh.host_index()) == (3, 2)


def random_fst(Fst, Arc, rs, num_states=5, num_arcs=9, labels=4):
    f = Fst()
    for _ in range(num_states):
        f.add_state()
    f.set_start(0)
    for _ in range(num_arcs):
        s, t = rs.randint(num_states, size=2)
        il, ol = rs.randint(labels, size=2)
        f.add_arc(int(s), Arc(int(il), int(ol),
                              float(np.round(rs.rand(), 3)), int(t)))
    for s in rs.choice(num_states, 2, replace=False):
        f.set_final(int(s), float(np.round(rs.rand(), 3)))
    return f


@pytest.mark.parametrize("seed", range(6))
def test_fst_algebra_matches_jax(seed):
    """concat, union, closure and linear of small random FSTs: the same
    text as JAX's after ``connect``; ``is_final`` state by state."""
    from kaldi_aslp_tpu.fst.fst import Arc as JArc, Fst as JFst
    from kaldi_aslp_tpu_torch.fst.fst import Arc, Fst

    def pair(rs_seed):
        return (random_fst(JFst, JArc, np.random.RandomState(rs_seed)),
                random_fst(Fst, Arc, np.random.RandomState(rs_seed)))

    (ja, pa), (jb, pb) = pair(2 * seed), pair(2 * seed + 1)
    for op in ("concat", "union"):
        want = getattr(ja, op)(jb).connect().to_text()
        assert getattr(pa, op)(pb).connect().to_text() == want, op
    assert pa.closure().connect().to_text() == \
        ja.closure().connect().to_text()
    assert [pa.is_final(s) for s in range(pa.num_states)] == \
        [ja.is_final(s) for s in range(ja.num_states)]
    rs = np.random.RandomState(seed)
    pairs = [tuple(int(v) for v in rs.randint(5, size=2)) for _ in range(4)]
    weights = [float(w) for w in np.round(rs.rand(4), 3)]
    for w in (None, weights):
        assert Fst.linear(pairs, w).to_text() == \
            JFst.linear(pairs, w).to_text()


def test_linear_acceptor_goes_through_fst_linear():
    from kaldi_aslp_tpu.fst.lang import make_linear_acceptor as jax_acc
    from kaldi_aslp_tpu_torch.fst.lang import make_linear_acceptor

    assert make_linear_acceptor([3, 1, 4]).to_text() == \
        jax_acc([3, 1, 4]).to_text()


def test_config_helpers_match_jax():
    from kaldi_aslp_tpu.feats import FrameExtractionOptions as JOpts
    from kaldi_aslp_tpu_torch.feats import FrameExtractionOptions as Opts

    a, b = Opts(samp_freq=8000.0), JOpts(samp_freq=8000.0)
    assert a.flag_names() == b.flag_names()
    assert a.to_dict() == b.to_dict()


def test_text_matrix_round_trip_from_jax_writer():
    """A text matrix JAX's writer produced reads back row by row; JAX's
    own reader puts every value in one row (ROADMAP queue 3), the same
    values in the same order."""
    from kaldi_aslp_tpu.io import kaldi_io as jax_io
    from kaldi_aslp_tpu_torch.io import kaldi_io

    mat = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    buf = io.BytesIO()
    jax_io.write_matrix(buf, mat, binary=False)
    text = buf.getvalue()
    got = kaldi_io.read_matrix(io.BytesIO(text), binary=False)
    np.testing.assert_array_equal(got, mat)
    jax_read = jax_io.read_matrix(io.BytesIO(text), binary=False)
    np.testing.assert_array_equal(got.ravel(), jax_read.ravel())
    back = io.BytesIO()
    kaldi_io.write_matrix(back, got, binary=False)
    assert back.getvalue() == text
    buf = io.BytesIO()
    jax_io.write_matrix(buf, np.zeros((0, 2), np.float32), binary=False)
    assert kaldi_io.read_matrix(io.BytesIO(buf.getvalue()),
                                binary=False).size == 0


def test_pdf_map_refuses_as_jax():
    from kaldi_aslp_tpu.tree.build_tree import ContextDependency as JCd
    from kaldi_aslp_tpu_torch.tree.build_tree import ContextDependency

    with pytest.raises(TypeError) as want:
        JCd().pdf_map()
    with pytest.raises(TypeError, match="context windows") as got:
        ContextDependency().pdf_map()
    assert str(got.value) == str(want.value)


_IMPORT_ALL_BLOCKED = r"""
import importlib, importlib.abc, pkgutil, sys


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "kaldi_aslp_tpu"):
            raise ImportError(f"{name} is blocked in this process")
        return None


sys.meta_path.insert(0, Block())
import kaldi_aslp_tpu_torch as port

names = {}
for m in sorted(pkgutil.iter_modules(port.__path__), key=lambda m: m.name):
    mod = importlib.import_module(f"kaldi_aslp_tpu_torch.{m.name}")
    names[m.name] = len([n for n in vars(mod) if not n.startswith("_")])
from kaldi_aslp_tpu_torch.feats import Fbank
from kaldi_aslp_tpu_torch.ops import ctc_alpha_beta, ctc_loss
print("RESULT", sorted(names.items()),
      sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "kaldi_aslp_tpu")))
"""


def test_every_subpackage_imports_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL_BLOCKED], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT")][-1]
    assert line.endswith(" []"), line
    for sub in ("feats", "ops", "utils", "io", "hmm", "models", "parallel",
                "decoder", "fst", "gmm", "recipes", "cli"):
        assert f"('{sub}', " in line, (sub, line)
