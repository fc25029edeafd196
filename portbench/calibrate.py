"""Readings that a cell's limits are set from: the program, the control, the faults.

    python3 portbench/calibrate.py --workload <cell> --seeds 11 12 ... \\
        [--control 3] [--faults 3] [--seconds 3] [--out readings.json]

On the card, at the cell's own size, in one process: for each seed a short
window of the timed path and the comparison with the reference (the
program's reading); for the first ``--control`` seeds the control, the
reference computed in the precision below the configuration's (float8
products, bfloat16 data) put in the program's place and judged alike; for
the first ``--faults`` seeds each fault of ``lib/faults.py`` that the cell
can have.  Each row is judged by the cell's limits (``limits/<cell>.json``)
as a run is, and prints ``correct`` beside its numbers: the program's rows
have to read true, the control's and the faults' false.  The benchmark's
own runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench.inputs import weights  # noqa: E402
from portbench.lib import device as dev_mod  # noqa: E402
from portbench.lib import faults, spec  # noqa: E402
from portbench.reference import check  # noqa: E402
from portbench.reference.data import Data  # noqa: E402
from portbench.reference.model import Arith, Model  # noqa: E402


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def twins():
    """A second witness: the port's plain PyTorch twins in place of its kernels."""
    from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM

    build = FluidLLM.build.__func__
    return faults.patched(FluidLLM, "build", classmethod(
        lambda cls, *a, **k: build(cls, *a, **dict(k, kernels=False))))


def program(cell, seed, device, seconds, fault=None):
    run = cell.driver.Run(cell, seed, device, log)
    if fault is None:
        run.setup()
        run.window(seconds)
    else:
        patch = twins() if fault == "twins" else faults.FAULTS[cell.traffic["kind"]][fault]()
        with patch:
            run.setup()
            run.window(seconds)
    run.finish()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return run


@torch.no_grad()
def control_rollout(run, device) -> dict:
    """The control in the program's place: the reference in float8 rolls
    out the kept trajectories from its bfloat16 data; the float32 reference
    judges each step."""
    conf, traffic, geo = run.conf, run.traffic, run.geo
    ctl = Model(conf, geo, weights.make(conf, run.part_seed(1), device), Arith(control=True))
    ctl.merge()
    data_c = Data(conf, traffic, run.seed, "test", torch.bfloat16)
    picks = []
    for idx, _ in run.picks():
        img, mask = data_c.frames(idx, traffic["window_start"], 1)
        states = [img[0].to(device)]
        mask = mask.to(device)
        for i in range(traffic["pred_steps"]):
            lo = max(0, i + 1 - run.window_frames)
            window = torch.stack(states[lo:i + 1])[None]
            states.append(states[i] + check.reference_step_diffs(ctl, window, mask[None])[0])
        picks.append((idx, torch.stack(states)))
    del ctl
    ref, rounded = run.references()
    data = Data(conf, traffic, run.seed, "test")
    return check.rollout_numbers(ref, rounded, data, picks, run.window_frames,
                                 traffic["window_start"], device, traffic["reference_rows"])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--twins", type=int, default=0,
                   help="seeds also run through the port's plain twins (a second witness)")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = spec.load_cell(ROOT, args.workload)
    device = dev_mod.require_cuda(cell.chips)
    log(f"[device] {dev_mod.info(device, cell.chips)}; {dev_mod.smi()}")
    kind = cell.traffic["kind"]
    limits = cell.limits["limits"]
    rows = []

    def emit(row):
        row["correct"] = all(math.isfinite(row.get(k, math.inf)) and row[k] <= lim
                             for k, lim in limits.items())
        rows.append(row)
        print(json.dumps(row), flush=True)

    for k, seed in enumerate(args.seeds):
        t = time.time()
        run = program(cell, seed, device, args.seconds)
        emit(dict(seed=seed, side="program", **run.check(), attempted=run.attempted,
                  failed=run.failed, seconds=time.time() - t))
        if k < args.control:
            if kind == "train":
                ref = run.reference()
                nums = check.train_numbers(run.reference(control=True), ref)
            else:
                nums = control_rollout(run, device)
            emit(dict(seed=seed, side="control", **nums))
        del run
        gc.collect()
        if k < args.twins:
            run = program(cell, seed, device, args.seconds, "twins")
            emit(dict(seed=seed, side="twins", **run.check()))
            del run
            gc.collect()
        if k < args.faults:
            for fault in faults.FAULTS[kind]:
                if fault in ("state_unchanged", "frames_unchanged"):
                    continue  # reads 1 by construction; the CPU tests show it
                run = program(cell, seed, device, args.seconds, fault)
                emit(dict(seed=seed, side=f"fault:{fault}", **run.check()))
                del run
                gc.collect()
    summary = {}
    for side in sorted({r["side"] for r in rows}):
        of_side = [r for r in rows if r["side"] == side]
        summary[f"{side} correct"] = dict(n=len(of_side), correct=sum(r["correct"] for r in of_side))
        for key in limits:
            vals = [r[key] for r in of_side if key in r]
            if vals:
                summary[f"{side} {key}"] = dict(min=min(vals), max=max(vals), n=len(vals),
                                                limit=limits[key])
    for k, v in summary.items():
        log(f"[summary] {k}: {v}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(workload=args.workload, rows=rows,
                                                  summary=summary, smi=dev_mod.smi()), indent=1))
    return 0 if all(r["correct"] == (r["side"] in ("program", "twins")) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
