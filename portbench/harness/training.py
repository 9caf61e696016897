"""What the training drivers share: set-up with the first steps that
the check follows, the window through the trainer's own ``train_epoch``,
the traced window and the profiled steps through the same parts that
the trainer's ``step`` calls, and the check against the reference.

A driver names its trainer, how a host item becomes the trainer's input
and how it is sent to the device, its split step and its reference."""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch

from kaldi_aslp_tpu_torch.models.losses import LossReporter
from kaldi_aslp_tpu_torch.train import init_velocity
from kaldi_aslp_tpu_torch.train.sgd import NnetTrainOptions
from kaldi_aslp_tpu_torch.train.trainer import device_batches
from portbench.harness import compare, model, traffic, weights
from portbench.harness.trace import PartTimer

PARTS = ("forward", "loss", "backward", "update")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup_parts(marks) -> Dict[str, float]:
    """Seconds between consecutive (name, time) marks, under the later
    mark's name."""
    return {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}


class StepReporter(LossReporter):
    """The port's loss reporter, which also keeps each step's
    (loss_sum, frames) tensors and calls ``after(n)`` after the n-th."""

    def __init__(self, name: str,
                 after: Optional[Callable[[int], None]] = None):
        super().__init__(name)
        self.steps: List[tuple] = []
        self.after = after

    def update(self, aux: Dict[str, torch.Tensor]) -> None:
        self.steps.append((aux["loss_sum"], aux["frames"]))
        super().update(aux)
        if self.after is not None:
            self.after(len(self.steps))


class TrainDriver:
    """The training window and its check; subclasses give ``trainer_cls``,
    ``reporter_name``, ``send``, ``to_port``, ``epoch``, ``split_step``,
    and ``reference_inputs``."""

    trainer_cls: Any = None
    reporter_name = "loss"
    send: Callable = None  # type: ignore
    parts = PARTS

    def __init__(self, cfg: dict, cell: dict, seed: int,
                 device: torch.device):
        self.cfg, self.cell, self.seed = cfg, cell, seed
        self.device = torch.device(device)
        self.check_steps = cell["check"]["steps"]

    # -- set-up -------------------------------------------------------------
    def setup(self) -> None:
        cfg = self.cfg
        marks = [("start", time.monotonic())]
        self.items = traffic.generate(self.cell["traffic_params"], self.seed,
                                      cfg["input_dim"], cfg["num_targets"])
        marks.append(("inputs", time.monotonic()))
        self.weights = weights.draw(cfg, self.seed, self.device)
        self.net = model.build(cfg, self.weights, self.device)
        sync(self.device)
        marks.append(("weights", time.monotonic()))
        self.lr = cfg["train"]["learn_rate"]
        self.trainer = self.trainer_cls(self.net, NnetTrainOptions(
            learn_rate=self.lr, momentum=cfg["train"]["momentum"]))
        self.velocity = init_velocity(self.net)
        snap: Dict[str, Dict[str, torch.Tensor]] = {}
        n = self.check_steps

        def after(k: int) -> None:
            if k == 1:
                snap["velocity"] = {name: v.clone()
                                    for name, v in self.velocity.items()}
            if k == n:
                snap["params"] = {name: p.detach().clone() for name, p
                                  in self.net.named_parameters()}

        self.check_reporter = StepReporter(self.reporter_name, after)
        self.check_out = self.epoch(iter(self.to_port(it) for it in
                                         self.items[:n]),
                                    self.check_reporter)
        self.snap = snap
        self.next = n % len(self.items)
        self.warm_steps = n
        sync(self.device)
        marks.append(("first_steps", time.monotonic()))
        self.setup_parts = setup_parts(marks)

    # -- the window ---------------------------------------------------------
    def _cycle(self, taken: List[int], deadline: Optional[float] = None,
               count: Optional[int] = None) -> Iterator[Any]:
        while True:
            if deadline is not None and time.perf_counter() >= deadline:
                return
            if count is not None and len(taken) >= count:
                return
            i = self.next
            self.next = (i + 1) % len(self.items)
            taken.append(i)
            yield self.to_port(self.items[i])

    def _frames(self, taken: List[int]) -> int:
        return sum(traffic.valid_frames(self.items[i]) for i in taken)

    def window(self, seconds: float) -> dict:
        """Untraced: ``train_epoch`` over the items, cycled until
        ``seconds`` have passed; every step it took ends in the window,
        which closes on a synchronize."""
        taken: List[int] = []
        rep = StepReporter(self.reporter_name)
        sync(self.device)
        t0 = time.perf_counter()
        self.epoch(self._cycle(taken, deadline=t0 + seconds), rep)
        sync(self.device)
        t1 = time.perf_counter()
        losses = [float(s) for s, _ in rep.steps]
        return {"seconds": t1 - t0, "steps": len(taken),
                "valid_frames": self._frames(taken),
                "attempted": len(taken),
                "failed": sum(not math.isfinite(v) for v in losses)}

    def _split_steps(self, taken: List[int], timer: Optional[PartTimer],
                     context: Optional[Any], **cycle) -> None:
        it = self._cycle(taken, **cycle)
        for j, batch in enumerate(device_batches(it, self.device,
                                                 self.send)):
            if context is not None:
                context.context = self.context(self.items[taken[j]])
            if timer is None:
                self.split_step(batch, lambda part: None)
            else:
                with timer.step() as mark:
                    self.split_step(batch, mark)

    def traced_window(self, seconds: float) -> dict:
        """The window driven through the parts of the trainer's step with
        CUDA events between them."""
        timer = PartTimer(self.parts, self.device)
        taken: List[int] = []
        sync(self.device)
        t0 = time.perf_counter()
        self._split_steps(taken, timer, None, deadline=t0 + seconds)
        sync(self.device)
        t1 = time.perf_counter()
        return {"seconds": t1 - t0, "steps": len(taken),
                "valid_frames": self._frames(taken),
                "attempted": len(taken), "failed": 0,
                "parts_ms": timer.mean_ms()}

    def profile_steps(self, steps: int, entries):
        """(warm, run, out) for the profiler: one step, then ``steps``
        more, each with its inputs in ``entries.context``; ``out`` gets
        the steps and their valid frames."""
        out = {}

        def warm():
            self._split_steps([], None, entries, count=1)

        def run():
            taken: List[int] = []
            self._split_steps(taken, PartTimer(self.parts, self.device), entries,
                              count=steps)
            out.update(steps=len(taken), valid_frames=self._frames(taken))
        return warm, run, out

    def context(self, item: dict) -> dict:
        return {"valid_frames": traffic.valid_frames(item)}

    # -- the check ----------------------------------------------------------
    def program_result(self) -> dict:
        cfg, n = self.cfg, self.check_steps
        names = {leaf: model.port_name(cfg, leaf) for leaf in self.weights}
        v1, p_n = self.snap["velocity"], self.snap["params"]
        return {
            "losses": [float(s) / float(f)
                       for s, f in self.check_reporter.steps[:n]],
            "frames": [float(f) for _, f in self.check_reporter.steps[:n]],
            "first_grads": {leaf: -v1[port] / self.lr
                            for leaf, port in names.items()},
            "params": {leaf: p_n[port] for leaf, port in names.items()}}

    def release(self) -> None:
        """Drop the program's state, keeping what the check reads."""
        self.result = self.program_result()
        for attr in ("net", "trainer", "velocity", "check_out"):
            setattr(self, attr, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_run(self, precision: str = "float32",
                      keep_streams: Optional[int] = None) -> dict:
        ref = weights.reference(self.cfg)
        inputs = [self.reference_inputs(item)
                  for item in self.items[:self.check_steps]]
        return ref.train(self.weights, self.cfg, inputs, precision,
                         keep_streams)

    def numbers(self) -> Dict[str, float]:
        return compare.training_numbers(self.result, self.reference_run(),
                                        self.weights)

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device, dtype)
