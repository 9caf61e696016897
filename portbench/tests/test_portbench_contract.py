"""BENCHMARK.json against the benchmark's contract, and the harness's
look-up by name: every workload resolves to its configuration, driver
and metrics, and a new cell or metric is found from new files and new
entries alone."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench.harness import cells

BENCH = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def test_top_level_keys_and_size():
    assert set(BENCH) == KEYS
    assert len((cells.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][:2] == ["python3", "portbench/run.py"]


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_units_and_lines(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert LINE.match(e[key]), (e["name"], key)
        for key in e.get("reduced", ()):
            assert NAME.match(key)


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_setup_and_its_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for w in BENCH["workloads"]:
        reported = {m["name"] for m in cells.end_to_end(BENCH, w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        assert cells.per_layer(BENCH, w["name"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", ()):
            reported = {x["name"] for x in cells.end_to_end(BENCH, cell)}
            assert m["moves"] in reported, (m["name"], cell)
        if m["unit"] == "%" and ("roofline" in m["name"]):
            assert m["name"].startswith("roofline_pct.")


def test_configurations_files_and_cuts():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert c["file"] not in files
        files.add(c["file"])
        cfg = cells.load_config(c["name"])
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["source"] == c["source"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    found = cells.resolve(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert found["cell"]["why"] == entry["why"]
    assert found["config"]["name"] == entry["config"]
    assert hasattr(found["driver"], "Driver")
    assert set(found["end_to_end"]) >= {"setup_s"}
    for name, mod in found["metrics"].items():
        assert callable(mod.read)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_files_agree_with_the_entries(metric):
    """A metric's file holds its reader and what the reader needs; its
    unit, layer, the metric it moves and its cells are the entry's alone,
    so adding a cell to a metric edits no file."""
    mod = cells.load_metric(metric)
    assert callable(mod.read)
    for restated in ("UNIT", "LAYER", "MOVES", "WORKLOADS"):
        assert not hasattr(mod, restated), (metric, restated)
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    for cell in entry.get("workloads", ()):
        assert metric in cells.resolve(cell)["metrics"]
        assert cells.resolve(cell)["units"][metric] == entry["unit"]


def test_every_workload_file_names_its_files():
    for path in sorted((cells.BENCH_DIR / "workloads").glob("*.json")):
        cell = cells.load_cell(path.stem)
        cells.load_config(cell["config"])
        assert hasattr(cells.load_driver(cell["driver"]), "Driver")


def test_layers_are_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def _copy(tmp_path):
    shutil.copytree(cells.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return json.loads((cells.ROOT / "BENCHMARK.json").read_text())


def _write(tmp_path, rel: str, text: str) -> None:
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def test_a_new_cell_and_metric_need_only_new_files(tmp_path):
    """Copy the benchmark, add a workload file and a metric file and their
    entries, and find both by name."""
    bench = _copy(tmp_path)
    cell = json.loads((cells.BENCH_DIR / "workloads" /
                       "blstm_ctc.train.json").read_text())
    cell.update(name="blstm_ctc.train_wide", traffic="train_wide")
    cell["traffic_params"]["streams"] = 64
    _write(tmp_path, "portbench/workloads/blstm_ctc.train_wide.json",
           json.dumps(cell))
    _write(tmp_path, "portbench/metrics/frames_per_step.train.py",
           "def read(records):\n"
           "    w = records['window']\n"
           "    return w['valid_frames'] / w['steps']\n")
    bench["workloads"].append({"name": "blstm_ctc.train_wide",
                               "config": "blstm_ctc", "traffic": "train_wide",
                               "chips": 1, "why": "a wider cell"})
    bench["end_to_end"][0]["workloads"].append("blstm_ctc.train_wide")
    bench["per_layer"].append({"name": "frames_per_step.train",
                               "unit": "frames", "better": "higher",
                               "source": "program_counter",
                               "layer": "device",
                               "moves": "train_audio_s_per_s",
                               "workloads": ["blstm_ctc.train_wide"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    found = cells.resolve("blstm_ctc.train_wide", root=tmp_path)
    assert found["cell"]["traffic_params"]["streams"] == 64
    assert set(found["metrics"]) == {"frames_per_step.train"}
    assert found["units"]["frames_per_step.train"] == "frames"
    assert found["end_to_end"] == ["train_audio_s_per_s", "setup_s"]
    records = {"window": {"valid_frames": 300, "steps": 3}}
    assert found["metrics"]["frames_per_step.train"].read(records) == 100


def test_a_new_configuration_traffic_kind_and_cell_need_only_new_files(
        tmp_path):
    """In a copy of the benchmark, a new configuration (its sizes, a new
    architecture module and its reference), a new traffic kind and a
    new cell that uses them, each a new file, and entries in
    BENCHMARK.json that also add the cell to existing metrics; then a
    CPU run of the cell, untraced and traced, from the copy."""
    bench = _copy(tmp_path)
    cfg = dict(cells.load_config("blstm_ctc"), name="blstm_alt",
               architecture="blstmp_alt", cell_dim=32, proj_dim=16,
               num_targets=12, num_layers=2, out_param_stddev=1.0)
    _write(tmp_path, "portbench/configs/blstm_alt.json", json.dumps(cfg))
    _write(tmp_path, "portbench/architectures/blstmp_alt.py",
           "from portbench.architectures.blstmp_ctc import (  # noqa\n"
           "    build, forward_flops_per_frame, port_name)\n")
    _write(tmp_path, "portbench/reference/blstm_alt.py",
           "from portbench.reference.blstm_ctc import (  # noqa\n"
           "    forward, leaves, scores, train)\n")
    _write(tmp_path, "portbench/generators/two_lengths.py",
           "import numpy as np\n"
           "from portbench.generators import utterance_batches\n\n\n"
           "def generate(p, rng, feat_dim, num_targets):\n"
           "    p = dict(p, length_min=p['short'], length_max=p['long'])\n"
           "    return utterance_batches.generate(p, rng, feat_dim,\n"
           "                                      num_targets)\n")
    cell = json.loads((cells.BENCH_DIR / "workloads" /
                       "blstm_ctc.train.json").read_text())
    cell.update(name="blstm_alt.train", config="blstm_alt",
                traffic_params={"kind": "two_lengths", "streams": 4,
                                "short": 20, "long": 40, "pad_time_to": 8,
                                "frames_per_label": 10, "label_min": 1,
                                "pad_labels_to": 16, "batches": 3},
                profile_steps=1)
    _write(tmp_path, "portbench/workloads/blstm_alt.train.json",
           json.dumps(cell))
    bench["configs"].append({"name": "blstm_alt", "source": "a test",
                             "file": "portbench/configs/blstm_alt.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "blstm_alt.train",
                               "config": "blstm_alt", "traffic": "train",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("blstm_alt.train")
    for m in bench["per_layer"]:
        if m["name"] in ("forward_ms.train", "step_mfu.train"):
            m["workloads"].append("blstm_alt.train")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = ("import json\n"
            "from portbench.harness import cells, runner\n"
            "found = cells.resolve('blstm_alt.train')\n"
            "assert cells.ROOT.samefile('.'), cells.ROOT\n"
            "plain = runner.run(found, 2 ** 31 + 3, 0.2, False, 'cpu')\n"
            "traced = runner.run(found, 2 ** 31 + 3, 0.2, True, 'cpu')\n"
            "print(json.dumps({'plain': plain['metrics'],\n"
            "                  'traced': traced['metrics'],\n"
            "                  'correct': [plain['correct'],\n"
            "                              traced['correct']]}))\n")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(tmp_path), str(cells.ROOT)]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] == [True, True]
    assert set(out["plain"]) == {"train_audio_s_per_s", "setup_s"}
    assert set(out["traced"]) == {"forward_ms.train", "step_mfu.train"}
    assert out["traced"]["step_mfu.train"]["unit"] == "%"


@pytest.mark.parametrize("bad", ["../x", "a/b", ".hidden", "x" * 65, "a b"])
def test_names_cannot_leave_their_folder(bad):
    with pytest.raises(ValueError):
        cells.check_name(bad)
