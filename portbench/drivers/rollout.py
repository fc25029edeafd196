"""The ``rollout`` kind: test-set rollouts of FLUID-LLM on the port.

As ``inference.test_generate`` runs them: the test split's windows (fixed
start) batched by the port's ``make_batches`` without shuffling, and each
batch rolled out by ``rollout.generate.gen_seq`` from ``start_state``
context frames for ``pred_steps`` steps, the model prepared for inference
(adapters merged, bf16 weights).  Set-up makes and locates the test
trajectories, builds the test set's batches once onto the card, on the
host's clock (building them takes the host 1-4 s a batch, as long as a
rollout, and its speed swings with the host's load, so the window measures
the rollouts and the batch building is the data layer's own metric),
builds the model and rolls one batch out (every shape of the window warmed
up).  The window rolls the
test set out pass after pass; a rollout started before the deadline runs
to its end and counts.  Two rollouts of the window, one drawn from the
seed and the last, keep a few trajectories each, drawn from the seed, for
the reference to judge.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from fluid_llm_tpu_torch.data.pipeline import make_batches
from fluid_llm_tpu_torch.rollout.generate import gen_seq

from portbench.inputs import weights
from portbench.lib import counts, port
from portbench.lib import device as dev
from portbench.reference import check
from portbench.reference.data import Data
from portbench.reference.model import Arith, Model



class Run:
    def __init__(self, cell, seed: int, device: torch.device, log):
        self.cell, self.seed, self.device, self.log = cell, int(seed), device, log
        self.conf, self.traffic = cell.config, cell.traffic
        self.geo = weights.geometry(self.conf)
        self.dims = counts.dims_of(self.conf, self.geo)
        self.batch_size = self.traffic["batch_size"]
        self.steps = self.traffic["pred_steps"]
        fl = self.conf["fluid_llm"]
        self.window_frames = fl["autoreg_seq_len"] - 1 + int(fl["see_init_state"])
        self.measure: dict = {}
        self.traced_steps = 0
        self.attempted = self.failed = 0
        rng = np.random.default_rng([self.seed, 11])
        self.keep_at = int(rng.integers(0, self.traffic["check_rollout_within"]))
        self.keep_rows = rng.choice(self.batch_size, self.traffic["check_trajectories"],
                                    replace=False).tolist()
        self.kept: dict[str, list] = {}

    def part_seed(self, k: int) -> int:
        return (self.seed * 1_000_003 + k) % (2 ** 62)

    def setup(self) -> None:
        t0 = time.perf_counter()
        cfg = port.port_config(self.conf, self.traffic, self.seed)
        self.cfg = cfg
        self.ds = port.BenchDataset(self.conf, self.traffic, self.seed, "test")
        for i in range(len(self.ds)):
            self.ds.get_trajectory(i)
        t_data = time.perf_counter()
        self.model = port.build_model(self.conf, cfg, port.rollout_props(self.ds, cfg),
                                      self.part_seed(1), self.device)
        self.model.prepare_inference_params()
        self.model.eval()
        t_model = time.perf_counter()
        self.test_batches = list(make_batches(self.ds, self.batch_size, shuffle=False,
                                              device=self.device))
        t_batches = time.perf_counter()
        self.build = dict(seconds=t_batches - t_model, batches=len(self.test_batches))
        self.finite: list[torch.Tensor] = []
        self.rollouts = 0
        self.passes = self.test_set()
        self.rollout()  # the warm-up: every shape of the window
        self.rollouts, self.finite = 0, []
        self.log(f"[setup] trajectories {t_data - t0:.2f} s, model {t_model - t_data:.2f} s, "
                 f"test batches {t_batches - t_model:.2f} s, warm-up rollout "
                 f"{time.perf_counter() - t_batches:.2f} s")

    def test_set(self):
        """(batch index, batch) of the test set, pass after pass."""
        while True:
            yield from enumerate(self.test_batches)

    def rollout(self) -> None:
        with torch.profiler.record_function("portbench.data"):
            b, batch = next(self.passes)
        with torch.profiler.record_function("portbench.rollout"):
            states, _ = gen_seq(self.model, batch, self.steps,
                                start_state=self.traffic["start_state"])
        self.finite.append(torch.isfinite(states).all())
        if self.rollouts == self.keep_at:
            self.kept["drawn"] = self.rows_of(b, states)
        self.rollouts += 1
        self.latest = (b, states)

    def rows_of(self, b: int, states: torch.Tensor) -> list:
        """(trajectory, its states) of the kept rows of batch ``b``."""
        return [(b * self.batch_size + r, states[r].detach().clone()) for r in self.keep_rows
                if r < states.shape[0]]

    def window(self, seconds: float) -> dict:
        before = port.launches()
        t0 = time.perf_counter()
        while True:
            self.rollout()
            if time.perf_counter() - t0 >= seconds:
                break
        dev.sync(self.device)
        wall = time.perf_counter() - t0
        after = port.launches()
        self.kept["last"] = self.rows_of(*self.latest)
        n = self.rollouts
        frames = n * self.batch_size * self.steps
        self.measure = dict(rollouts=n, wall_s=wall, rollout_ops=counts.rollout_ops(
            self.dims, self.batch_size, self.steps, self.window_frames))
        self.log(f"[window] {n} rollouts of {self.batch_size} x {self.steps} frames in "
                 f"{wall:.4f} s; launches a step: " + ", ".join(
                     f"{k} {(after[k] - before[k]) / (n * self.steps):g}" for k in after))
        return {"rollout_frames_per_s": frames / wall}

    def traced(self) -> None:
        self.rollout()
        dev.sync(self.device)
        self.traced_steps = self.steps

    def finish(self) -> None:
        self.passes.close()
        ok = torch.stack(self.finite).cpu().tolist() if self.finite else []
        self.attempted, self.failed = len(ok), ok.count(False)
        del self.model, self.finite, self.latest, self.test_batches

    def picks(self) -> list:
        return [p for key in ("drawn", "last") for p in self.kept.get(key, [])]

    def references(self) -> tuple[Model, Model]:
        """The reference in float32 and rounded to bfloat16, adapters merged."""
        models = []
        for ar in (Arith(), Arith(bf16=True)):
            m = Model(self.conf, self.geo, weights.make(self.conf, self.part_seed(1), self.device),
                      ar)
            m.merge()
            models.append(m)
        return models[0], models[1]

    def check(self) -> dict:
        ref, rounded = self.references()
        data = Data(self.conf, self.traffic, self.seed, "test")
        return check.rollout_numbers(ref, rounded, data, self.picks(), self.window_frames,
                                     self.traffic["window_start"], self.device,
                                     self.traffic["reference_rows"])
