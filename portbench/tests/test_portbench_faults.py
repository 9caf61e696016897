"""The check fails what it must: at a size the CPU holds, a run whose
timed path is broken underneath, and the control (the reference in the
configuration's lower control precision put in the program's place),
come out not correct against each cell's own limits.

The card's part of the same checks (the control at the cells' own
sizes, on three seeds) is ``portbench/calibrate.py``; the test marked
``cuda`` runs a cell end to end on the card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import kaldi_aslp_tpu_torch.train.trainer as trainer_module
from kaldi_aslp_tpu_torch.decoder import decodable
from portbench.harness import cells, compare, runner
from portbench.tests import tiny

CPU = torch.device("cpu")
TRAIN = ["blstm_ctc.train", "blstm_ctc.train_long"]


def _run(name: str, seed: int = 2 ** 31 + 77) -> dict:
    return runner.run(tiny.found(name), seed, 1.0, False, "cpu")


@pytest.mark.parametrize("name", TRAIN + ["blstm_ctc.posteriors"])
def test_a_sound_run_is_correct(name):
    assert _run(name)["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_a_step_that_leaves_its_state_unchanged_fails(name, monkeypatch):
    monkeypatch.setattr(trainer_module, "make_sgd_update",
                        lambda net, opts: (lambda velocity, lr: None))
    result = _run(name)
    assert not result["correct"]
    assert result["numbers"]["change_norm_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_a_step_on_half_its_batch_fails(name, monkeypatch):
    orig = trainer_module.ctc_batch_loss
    monkeypatch.setattr(
        trainer_module, "ctc_batch_loss",
        lambda y, lab, il, ll, blank=0: orig(
            *(a[:len(y) // 2] for a in (y, lab, il, ll)), blank))
    assert not _run(name)["correct"]


def test_an_answer_altered_where_it_is_produced_fails(monkeypatch):
    orig = decodable.nnet_forward_batched

    def altered(*args, **kwargs):
        out = orig(*args, **kwargs)
        out[0, 0, 1] += 0.5
        return out
    monkeypatch.setattr(decodable, "nnet_forward_batched", altered)
    assert not _run("blstm_ctc.posteriors")["correct"]


def test_every_call_with_a_score_not_finite_counts_as_failed(monkeypatch):
    orig = decodable.nnet_forward_batched
    calls = []

    def spoiled(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls.append(len(calls))
        if len(calls) % 3 == 0:
            out[-1, -1, -1] = np.nan
        return out
    monkeypatch.setattr(decodable, "nnet_forward_batched", spoiled)
    found = tiny.found("blstm_ctc.posteriors")
    result = runner.run(found, 2 ** 31 + 77, 1.0, False, "cpu")
    warm = found["cell"]["warm_calls"]
    window = len(calls) - warm
    assert result["attempted"] == window
    assert result["failed"] == sum((i + 1) % 3 == 0
                                   for i in range(warm, len(calls)))


def test_half_a_batch_of_answers_left_out_fails(monkeypatch):
    orig = decodable.nnet_forward_batched

    def half(net, feats, mask, **kwargs):
        h = len(feats) // 2
        out = orig(net, feats[:h], mask[:h], **kwargs)
        return np.concatenate([out, np.zeros_like(out)])[:len(feats)]
    monkeypatch.setattr(decodable, "nnet_forward_batched", half)
    assert not _run("blstm_ctc.posteriors")["correct"]


@pytest.mark.parametrize("name", TRAIN)
def test_the_control_fails_a_training_cell(name):
    found = tiny.found(name)
    driver = found["driver"].Driver(found["config"], found["cell"], 5, CPU)
    driver.setup()
    driver.release()
    ref = driver.reference_run()
    ctl = driver.reference_run(precision=found["config"]["control_precision"])
    numbers = compare.training_numbers(ctl, ref, driver.weights)
    correct, _ = compare.judge(numbers, found["cell"]["check"]["limits"])
    assert not correct, numbers


def test_the_control_fails_the_posteriors_cell():
    found = tiny.found("blstm_ctc.posteriors")
    driver = found["driver"].Driver(found["config"], found["cell"], 5, CPU)
    driver.setup()
    item = driver.items[0]
    ref = driver.reference_scores(item)
    ctl = driver.reference_scores(item, found["config"]["control_precision"])
    gap = compare.score_gap(ctl, ref, torch.from_numpy(item["mask"]))
    correct, _ = compare.judge({"score_gap": gap},
                               found["cell"]["check"]["limits"])
    assert not correct, gap


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  cells.load_benchmark()["workloads"]])
def test_a_cell_runs_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    result = runner.run(cells.resolve(name), 2 ** 31 + 5, 2.0, False, "cuda")
    assert result["correct"], result["checks"]
