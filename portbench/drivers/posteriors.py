"""Batch posteriors: ``decoder/decodable.py:nnet_forward_batched`` call
after call over padded utterance batches, with a prior, its scores
handed to the host as numpy.  Every call whose scores hold a value that
is not finite counts as failed, as it returns.  The outputs of calls
drawn from the seed are kept and, once the window has closed, held
against the reference's scores of the same inputs."""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from kaldi_aslp_tpu_torch.decoder import decodable
from portbench.harness import compare, model, traffic, weights
from portbench.harness.training import setup_parts, sync

END_TO_END = "infer_audio_s_per_s"


class Driver:
    def __init__(self, cfg: dict, cell: dict, seed: int,
                 device: torch.device):
        self.cfg, self.cell, self.seed = cfg, cell, seed
        self.device = torch.device(device)
        check = cell["check"]
        rng = np.random.default_rng([seed, 1])
        self.sample = set(int(i) for i in rng.choice(
            check["sample_from"], check["sample_calls"], replace=False))
        self.counts = rng.integers(1, 1000, cfg["num_targets"])

    def setup(self) -> None:
        cfg = self.cfg
        marks = [("start", time.monotonic())]
        self.items = traffic.generate(self.cell["traffic_params"], self.seed,
                                      cfg["input_dim"], cfg["num_targets"])
        marks.append(("inputs", time.monotonic()))
        self.weights = weights.draw(cfg, self.seed, self.device)
        self.net = model.build(cfg, self.weights, self.device)
        self.net.eval()
        sync(self.device)
        marks.append(("weights", time.monotonic()))
        self.prior = decodable.PdfPrior(self.counts)
        self.calls = 0
        self.kept: Dict[int, np.ndarray] = {}
        self.warm_steps = self.cell["warm_calls"]
        for i in range(self.warm_steps):
            self._call(self.items[i % len(self.items)])
        sync(self.device)
        marks.append(("first_calls", time.monotonic()))
        self.setup_parts = setup_parts(marks)

    def _call(self, item: dict) -> np.ndarray:
        return decodable.nnet_forward_batched(self.net, item["feats"],
                                              item["mask"], prior=self.prior)

    def _calls(self, deadline=None, count=None, entries=None) -> dict:
        frames, n, failed = 0, 0, 0
        while True:
            if deadline is not None and time.perf_counter() >= deadline:
                break
            if count is not None and n >= count:
                break
            item = self.items[self.calls % len(self.items)]
            if entries is not None:
                entries.context = {"valid_frames": traffic.valid_frames(item)}
            out = self._call(item)
            # min and max carry any NaN or infinity, and allocate nothing
            failed += not (np.isfinite(out.min()) and np.isfinite(out.max()))
            if self.calls in self.sample:
                self.kept[self.calls] = out
            frames += traffic.valid_frames(item)
            self.calls += 1
            n += 1
        return {"steps": n, "valid_frames": frames, "attempted": n,
                "failed": failed}

    def window(self, seconds: float) -> dict:
        """Calls until ``seconds`` have passed; each returns its scores on
        the host, so the window ends with the last."""
        self.calls = 0
        sync(self.device)
        t0 = time.perf_counter()
        stats = self._calls(deadline=t0 + seconds)
        sync(self.device)
        stats["seconds"] = time.perf_counter() - t0
        return stats

    traced_window = window

    def profile_steps(self, steps: int, entries):
        out = {}

        def warm():
            self._calls(count=1)

        def run():
            out.update(self._calls(count=steps, entries=entries))
        return warm, run, out

    def end_to_end(self, stats: dict) -> dict:
        return {END_TO_END: stats["valid_frames"] * self.cfg["frame_shift_s"]
                / stats["seconds"]}

    def release(self) -> None:
        self.net = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_scores(self, item: dict, precision: str = "float32"
                         ) -> torch.Tensor:
        ref = weights.reference(self.cfg)
        return ref.scores(self.weights, self.cfg,
                          torch.from_numpy(item["feats"]).to(self.device),
                          torch.from_numpy(item["mask"]).to(self.device),
                          torch.from_numpy(self.counts).to(self.device),
                          precision)

    def numbers(self) -> Dict[str, float]:
        """The widest score gap over the kept calls' valid frames (each
        distinct input's reference computed once)."""
        if not self.kept:
            return {"score_gap": math.nan}
        gaps: List[float] = []
        by_item: Dict[int, List[int]] = {}
        for i in self.kept:
            by_item.setdefault(i % len(self.items), []).append(i)
        for k, calls in by_item.items():
            item = self.items[k]
            ref = self.reference_scores(item)
            mask = torch.from_numpy(item["mask"]).to(self.device)
            for i in calls:
                prog = torch.from_numpy(self.kept[i]).to(self.device)
                gaps.append(compare.score_gap(prog, ref, mask))
        return {"score_gap": max(gaps), "compared_calls": len(self.kept)}
