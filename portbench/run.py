"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The steps: set-up (imports, the kernel
library, inputs and weights from the seed, warm-up: ``setup_s`` ends at the
first timed step), the measured window of ``--seconds``, with ``--trace 1``
a traced sub-window after it, then the comparison with the plain reference
(``reference/``) once the program's state is freed, and last the result:
each compared number beside its limit as the last lines on standard error,
and one JSON object as the last line of standard output.  With ``--trace
0`` its metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones.

Exits non-zero without a result when there is no card (or fewer than the
cell asks for), or when JAX or the JAX package was loaded.  Caches go to
fixed folders inside the checkout (``.portbench_cache/``), the trace to
``.portbench_out/``.
"""

from __future__ import annotations

import time

_T0 = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
OUT = ROOT / ".portbench_out"


def checkout_env() -> None:
    """Caches at fixed folders inside the checkout; the checkout importable
    (a script's own folder, ``portbench/``, is not a package root)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
        sys.path.pop(0)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


class Context:
    """What a per-layer reader sees."""

    def __init__(self, run, trace, device):
        self.run, self.trace, self.device = run, trace, device


def parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def traced(run, device, path: Path):
    """The driver's traced sub-window under ``torch.profiler``; its trace."""
    import torch

    from portbench.lib.trace import WINDOW, read_trace

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    path.parent.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            run.traced()
    prof.export_chrome_trace(str(path))
    trace = read_trace(str(path))
    log(f"[trace] {path.stat().st_size} bytes; {len(trace.device)} device events; busy "
        f"{trace.busy_s!r} s of {trace.window_s!r} s")
    return trace


def run_cell(args, root: Path = ROOT, device=None, t0: float = _T0) -> tuple[int, dict | None]:
    """One run: (exit code, result).  ``device`` None looks for the card
    (and fails without one); tests hand a CPU device in."""
    from portbench.lib import device as dev_mod
    from portbench.lib import imports, spec

    cell = spec.load_cell(root, args.workload)
    if device is None:
        try:
            device = dev_mod.require_cuda(cell.chips)
        except dev_mod.NoDevice as e:
            log(f"[error] {e}")
            return 2, None
    import torch

    log(f"[setup] imports {time.time() - t0:.2f} s")
    log(f"[device] {dev_mod.info(device, cell.chips)}; nvidia-smi: {dev_mod.smi()}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run = cell.driver.Run(cell, args.seed, device, log)
    run.setup()
    setup_s = time.time() - t0
    log(f"[setup] {setup_s!r} s")
    e2e = run.window(args.seconds)
    log(f"[device] after the window: nvidia-smi: {dev_mod.smi()}")
    out = Path(root) / OUT.relative_to(ROOT)
    trace = traced(run, device, out / f"trace-{cell.name}.json") if args.trace else None
    peak = dev_mod.memory_peak(device)
    log(f"[memory] peak allocated {peak} bytes (torch.cuda.max_memory_allocated)")
    run.finish()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.time()
    numbers = run.check()
    log(f"[check] reference in {time.time() - t_ref:.2f} s; {numbers.pop('_where', '')}")

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if args.trace:
        ctx = Context(run, trace, device)
        values = {m["name"]: cell.readers[m["name"]].read(ctx) for m in cell.per_layer}
    else:
        values = dict(e2e, setup_s=setup_s)
    metrics = {k: {"value": v, "unit": units[k]} for k, v in values.items()
               if k in units and v is not None}
    limits = cell.limits["limits"]
    compared = {k: {"value": numbers.get(k, math.inf), "limit": lim} for k, lim in limits.items()}
    correct = bool(run.attempted > 0 and run.failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values()))
    info = dict(dev_mod.info(device, cell.chips), memory_peak_bytes=peak)
    if trace is not None:
        info.update(busy_s=trace.busy_s, window_s=trace.window_s)
    result = dict(correct=correct, attempted=run.attempted, failed=run.failed, metrics=metrics,
                  device=info)
    if trace is not None:
        result["breakdown"] = {"device_ops": trace.top_ops(10),
                               "idle_gaps": trace.idle_by_host(10)}
    result["compared"] = compared
    found = imports.forbidden()
    if found:
        log(f"[error] the run loaded {', '.join(found)}: no result")
        return 3, None
    for k, c in compared.items():
        log(f"compared {k} {c['value']!r} limit {c['limit']!r}")
    return 0, result


def main(argv=None) -> int:
    checkout_env()
    args = parse(argv)
    code, result = run_cell(args)
    if result is not None:
        sys.stdout.flush()
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
