"""Device time per op and per category from a ``torch.profiler`` trace.

Counterpart of ``fluid_llm_tpu/tools/profiling.py`` (``summarize_xplane``).
``torch.profiler`` exports a Chrome trace (``train/loop._profiler`` writes
``<dir>/trace.json``); :func:`summarize_trace` reads the newest one under a
folder and rolls the device's events (kernels, memcpy, memset) up per op
and per category: the kernel's name without return type, namespaces,
template arguments or arguments (:func:`category`).  Used by
``baselines_cli --profile_dir`` and by ``tools/rollout_profile.py`` and
``tools/train_profile.py``.

:func:`span` marks the port's layers in such a trace: ``fluid.train_step``
(its ``fluid.encoder``, ``fluid.backbone``, ``fluid.decoder``,
``fluid.loss``, ``fluid.backward`` and ``fluid.optimizer``),
``fluid.rollout`` (a ``fluid.rollout_step`` a step, each holding encoder,
backbone and decoder) and ``fluid.data.build`` (one batch built on the
profiled thread: ``torch.profiler`` records no other thread).
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import re
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler records,
    else one shared no-op context (a ``record_function`` costs ~12 us a
    call even with no profiler running; the check ~0.2 us).  The span lands
    in the profiler's Chrome trace beside the device events, nested by
    thread; on a thread the profiler does not record (it records the one
    that started it) the check is false and nothing is recorded."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def category(name: str) -> str:
    """``void at::native::foo_kernel<4, F>(int, ...)`` -> ``foo_kernel``;
    ``Memcpy HtoD (Pageable -> Device)`` -> ``Memcpy HtoD``."""
    s = re.sub(r"^void |\(anonymous namespace\)::", "", name).split("(")[0]
    while True:  # template arguments, innermost first
        t = re.sub(r"<[^<>]*>", "", s)
        if t == s:
            break
        s = t
    return s.split("::")[-1].strip() or name


def newest_trace(trace_dir: str) -> str | None:
    paths = [p for pat in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(trace_dir, "**", pat), recursive=True)]
    return max(paths, key=os.path.getmtime) if paths else None


def device_events(path: str) -> list[dict]:
    """The complete device events of a Chrome trace (``dur`` in us)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f).get("traceEvents", [])
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and "dur" in e]


def summarize_trace(trace_dir: str, divisor: float = 1.0, top: int = 25):
    """Print the device busy time, the categories and the top ops of the
    newest trace under ``trace_dir``; return ``{category: ms}`` with the
    total under ``"_total"``.  ``divisor``: the steps the trace holds (the
    per-step figure).  Returns ``None`` when the trace holds no device
    events (a CPU trace)."""
    path = newest_trace(trace_dir)
    if path is None:
        print(f"no Chrome trace under {trace_dir}")
        return None
    per_op, per_cat = defaultdict(float), defaultdict(float)
    total = 0.0
    for ev in device_events(path):
        dur = float(ev["dur"]) * 1e3  # ns
        per_op[ev["name"][:130]] += dur
        per_cat[category(ev["name"])] += dur
        total += dur
    if not total:
        print(f"no device events in {path} (CPU trace?)")
        return None
    print(f"device busy: {total / 1e6:.2f} ms ({total / 1e6 / max(divisor, 1e-9):.3f} ms/step)")
    print("== categories ==")
    for k, v in sorted(per_cat.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {v / 1e6:8.2f} ms  {v / total * 100:5.1f}%  {k}")
    print("== top ops ==")
    for k, v in sorted(per_op.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {v / 1e6:8.2f} ms  {k}")
    out = {k: v / 1e6 for k, v in per_cat.items()}
    out["_total"] = total / 1e6
    return out
