"""The ``train`` kind: FLUID-LLM training steps on the port, as a user runs them.

Set-up makes the train split's trajectories from the seed and locates them
(the first pass of an epoch does that), the model with the seed's weights,
and the ``Trainer`` (AdamW at the configuration's rate, dropout drawn from a
seeded generator on the card).  The batches come from the port's
``make_batches`` over ``PatchDataset`` with the configuration's worker
threads, shuffled by the seed: set-up builds the first ``pool_batches`` of
that feed onto the card, epoch after epoch, on the host's clock (the data
layer's own metric; its speed swings with the host's load, so the window
does not wait on it).  Set-up then drives the trainer through its first
``check_steps`` steps on the pool: they are the warm-up, and what the
reference is compared with.  The window runs on the same trainer and
steps through the pool again and again.
"""

from __future__ import annotations

import itertools
import math
import time

import torch

from fluid_llm_tpu_torch.data.pipeline import make_batches
from fluid_llm_tpu_torch.train.trainer import Trainer

from portbench.inputs import weights
from portbench.lib import counts, port
from portbench.lib import device as dev
from portbench.reference import check
from portbench.reference.data import Data



class Run:
    def __init__(self, cell, seed: int, device: torch.device, log):
        self.cell, self.seed, self.device, self.log = cell, int(seed), device, log
        self.conf, self.traffic = cell.config, cell.traffic
        self.geo = weights.geometry(self.conf)
        self.dims = counts.dims_of(self.conf, self.geo)
        self.batch_size = self.traffic["batch_size"]
        self.frames = self.traffic["seq_len"] - 1 + int(self.conf["fluid_llm"]["see_init_state"])
        self.measure: dict = {}
        self.traced_steps = 0
        self.attempted = self.failed = 0

    # seeds of the parts, all from the run's seed
    def part_seed(self, k: int) -> int:
        return (self.seed * 1_000_003 + k) % (2 ** 62)

    def setup(self) -> None:
        t0 = time.perf_counter()
        cfg = port.port_config(self.conf, self.traffic, self.seed)
        self.cfg = cfg
        self.ds = port.BenchDataset(self.conf, self.traffic, self.seed, "train")
        for i in range(len(self.ds)):
            self.ds.get_trajectory(i)
        t_data = time.perf_counter()
        self.model = port.build_model(self.conf, cfg, self.ds.ds_props(), self.part_seed(1),
                                      self.device)
        t_build = time.perf_counter()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.part_seed(2))
        self.trainer = Trainer(self.model, generator=gen)
        t_model = time.perf_counter()
        self.mode = self.traffic["mode"]
        feed = self.batches()
        self.pool = list(itertools.islice(feed, self.traffic["pool_batches"]))
        feed.close()
        t_pool = time.perf_counter()
        self.build = dict(seconds=t_pool - t_model, batches=len(self.pool))
        self.stream = itertools.cycle(self.pool)
        self.losses: list[torch.Tensor] = []
        named = [(n, p) for n, p in self.model.named_parameters() if p.requires_grad]
        init = {n: p.detach().clone() for n, p in named}
        beta1 = self.trainer.opt.param_groups[0]["betas"][0]
        prog = dict(losses=[], grad_norms={}, deltas={})
        self.check_rows, ticket = [], 0
        for step in range(self.traffic["check_steps"]):
            batch = next(self.stream)
            rows = batch[0].shape[0]  # its tickets are the next ``rows``, in order
            self.check_rows.append([self.ds.rows[k] for k in range(ticket, ticket + rows)])
            ticket += rows
            metrics = self.trainer.train_step(batch, self.mode)
            prog["losses"].append(metrics["loss"])
            if step == 0:  # the first gradient, from AdamW's first moment
                st = self.trainer.opt.state
                prog["grad_norms"] = {n: (st[p]["exp_avg"] / (1 - beta1)).norm()
                                      for n, p in named if "exp_avg" in st.get(p, {})}
        prog["deltas"] = {n: (p.detach() - init[n]).norm() for n, p in named}
        self.prog = {k: ([float(x) for x in v] if isinstance(v, list)
                         else {n: float(x) for n, x in v.items()}) for k, v in prog.items()}
        del init
        self.log(f"[setup] trajectories {t_data - t0:.2f} s, model {t_build - t_data:.2f} s, "
                 f"trainer {t_model - t_build:.2f} s, {self.build['batches']} batches "
                 f"{self.build['seconds']:.2f} s, "
                 f"{len(self.check_rows)} checked steps {time.perf_counter() - t_pool:.2f} s")

    def batches(self):
        """The port's batches, epoch after epoch, as ``train.loop`` makes them."""
        for epoch in itertools.count():
            yield from make_batches(self.ds, self.batch_size, shuffle=True,
                                    seed=self.part_seed(100 + epoch), device=self.device,
                                    num_workers=self.cfg.num_workers)

    def step(self) -> None:
        """One timed step, on the pool's next batch."""
        batch = next(self.stream)
        with torch.profiler.record_function("portbench.train_step"):
            self.losses.append(self.trainer.train_step(batch, self.mode)["loss"])

    def window(self, seconds: float) -> dict:
        before = port.launches()
        steps = 0
        t0 = time.perf_counter()
        while True:
            self.step()
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        dev.sync(self.device)
        wall = time.perf_counter() - t0
        after = port.launches()
        self.measure = dict(steps=steps, wall_s=wall,
                            step_ops=counts.train_step_ops(self.dims, self.batch_size, self.frames))
        self.log(f"[window] {steps} steps in {wall:.4f} s; launches a step: " + ", ".join(
            f"{k} {(after[k] - before[k]) / steps:g}" for k in after))
        return {"train_samples_per_s": steps * self.batch_size / wall}

    def traced(self) -> None:
        n = self.traffic["trace_steps"]
        for _ in range(n):
            self.step()
        dev.sync(self.device)
        self.traced_steps = n

    def finish(self) -> None:
        """Count the steps whose loss is not finite, and free the program's state."""
        losses = self.prog["losses"] + (torch.stack(self.losses).float().cpu().tolist()
                                        if self.losses else [])
        self.attempted = len(losses)
        self.failed = sum(not math.isfinite(x) for x in losses)
        del self.trainer, self.model, self.losses, self.stream, self.pool

    def reference(self, control: bool = False) -> dict:
        """The reference's steps over the same rows (``control``: in the
        precision below the configuration's)."""
        W = weights.make(self.conf, self.part_seed(1), self.device)
        data = Data(self.conf, self.traffic, self.seed, "train",
                    torch.bfloat16 if control else torch.float32)
        return check.reference_train(self.conf, self.traffic, self.geo, W, data, self.check_rows,
                                     self.part_seed(2), self.device, control=control,
                                     chunk=self.traffic["reference_rows"])

    def check(self) -> dict:
        return check.train_numbers(self.prog, self.reference())
