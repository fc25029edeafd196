"""Device time by the port's layer: the ``fluid.*`` spans of the traced window.

The port marks its layers with ``record_function`` spans while a profiler
records (``fluid_llm_tpu_torch/tools/profiling.span``): ``fluid.encoder``,
``fluid.backbone``, ``fluid.decoder``, ``fluid.loss`` and
``fluid.optimizer`` inside ``fluid.train_step``; ``fluid.rollout`` and a
``fluid.rollout_step`` a step, whose own ops are the window's glue.  This
module reads the Chrome trace that ``run.py`` writes for the ``--trace 1``
run (``<root>/.portbench_out/trace-<cell>.json``), once a process, and
gives each device event (kernel, copy, set) of the ``portbench.window``
annotation to a layer:

- its launch is the host event (``cuda_runtime`` or ``cuda_driver``) with
  the same ``correlation`` (on the H100 every device event of both cells'
  traces had one);
- a launch inside an ``autograd::engine::evaluate_function: ...`` op is a
  backward one: it goes to the span of the forward op that carries the
  same ``Sequence number`` (the last such op to start, the one whose
  autograd node it is), and to ``backward`` where none does;
- any other launch goes to the innermost ``fluid.*`` span around it on its
  thread, and to ``none`` outside every span.

A span's layer is its name less ``fluid.``; ``fluid.rollout`` and
``fluid.rollout_step`` are the ``window`` layer.  Durations are summed
(the port runs one stream).  Where the trace holds no ``fluid.*`` span (a
program without them) or no device event, nothing is read: the readers
return None, never 0.
"""

from __future__ import annotations

import os
import sys
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

from portbench.lib import trace as tr

PREFIX = "fluid."
BACKWARD_OP = "autograd::engine::evaluate_function:"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW_LAYER = {"fluid.rollout": "window", "fluid.rollout_step": "window"}
# the layers a metric reads; the rest (``train_step``'s own ops, backward
# ops no forward op claims, ``none``) is unattributed
LAYERS = ("encoder", "backbone", "decoder", "loss", "optimizer", "window")

_CACHE: dict = {}


def layer_of(span: str | None) -> str:
    if span is None:
        return "none"
    return WINDOW_LAYER.get(span, span[len(PREFIX):])


@dataclass
class Split:
    """Device seconds and device ops by layer over the traced window."""

    seconds: dict = field(default_factory=lambda: defaultdict(float))
    ops: dict = field(default_factory=lambda: defaultdict(int))
    kernels: dict = field(default_factory=lambda: defaultdict(float))  # (layer, kernel) -> s
    spans: int = 0  # ``fluid.*`` spans in the trace

    @property
    def attributed_s(self) -> float:
        return sum(self.seconds[k] for k in LAYERS)

    def top(self, layers, n: int) -> list:
        """The ``n`` kernels of most device seconds in ``layers``."""
        per = defaultdict(float)
        for (layer, kernel), s in self.kernels.items():
            if layer in layers:
                per[kernel] += s
        return sorted(per.items(), key=lambda kv: -kv[1])[:n]

    def unattributed(self, n: int = 5) -> list:
        return self.top(set(self.seconds) - set(LAYERS), n)


def innermost(points, events, want) -> dict:
    """For each point ``(t, key)`` on one thread, the innermost event
    ``(start, end, name, seq)`` for which ``want(name)`` holds that covers
    ``t`` (one thread's events nest); ``{key: event}``, the points no such
    event covers left out."""
    evs = sorted((e for e in events if want(e[2])), key=lambda e: (e[0], -e[1]))
    out, stack, i = {}, [], 0
    for t, key in sorted(points, key=lambda p: p[0]):
        while i < len(evs) and evs[i][0] <= t:
            while stack and stack[-1][1] < evs[i][0]:
                stack.pop()
            stack.append(evs[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            out[key] = stack[-1]
    return out


def is_span(name: str) -> bool:
    return name.startswith(PREFIX)


def is_backward(name: str) -> bool:
    return name.startswith(BACKWARD_OP)


def split(events: list[dict]) -> Split | None:
    """The layers of the device events in the ``WINDOW`` annotation; None
    without a device event or a ``fluid.*`` span there."""
    marks = [e for e in events if e.get("ph") == "X" and e.get("name") == tr.WINDOW
             and e.get("cat") == "user_annotation"]
    if not marks:
        return None
    lo = float(marks[0]["ts"])
    hi = lo + float(marks[0]["dur"])
    device = [e for e in tr.device_events(events) if e["ts"] < hi and e["ts"] + e["dur"] > lo]
    host = [e for e in events if e.get("ph") == "X" and "dur" in e
            and e.get("cat") in ("cpu_op", "user_annotation") + LAUNCH_CATS]
    n_spans = sum(1 for e in host if is_span(e["name"]))
    if not device or not n_spans:
        return None

    threads = defaultdict(list)  # (pid, tid) -> [(start, end, name, sequence number)]
    launch = {}  # correlation -> (thread, time)
    fwd = {}  # sequence number -> (start, thread, time) of the last forward op to start
    for e in host:
        th = (e.get("pid"), e.get("tid"))
        s, d = float(e["ts"]), float(e["dur"])
        args = e.get("args") or {}
        if e["cat"] in LAUNCH_CATS:
            if "correlation" in args:
                launch[args["correlation"]] = (th, s + d / 2)
            continue
        seq = args.get("Sequence number")
        threads[th].append((s, s + d, e["name"], seq))
        if e["cat"] == "cpu_op" and seq is not None and not args.get("Fwd thread id") \
                and not e["name"].startswith("autograd::") and (seq not in fwd or s >= fwd[seq][0]):
            fwd[seq] = (s, th, s + d / 2)

    points = defaultdict(list)  # thread -> [(launch time, device event index)]
    for i, d in enumerate(device):
        at = launch.get((d.get("args") or {}).get("correlation"))
        if at is not None:
            points[at[0]].append((at[1], i))
    fpoints = defaultdict(list)  # thread -> [(forward op time, sequence number)]
    for seq, (_, th, t) in fwd.items():
        fpoints[th].append((t, seq))
    span_at, bwd_at, fwd_span = {}, {}, {}
    for th, pts in points.items():
        span_at.update(innermost(pts, threads[th], is_span))
        bwd_at.update(innermost(pts, threads[th], is_backward))
    for th, pts in fpoints.items():
        fwd_span.update(innermost(pts, threads[th], is_span))

    out = Split(spans=n_spans)
    for i, d in enumerate(device):
        if i in bwd_at:
            owner = fwd_span.get(bwd_at[i][3])
            layer = layer_of(owner[2]) if owner else "backward"
        else:
            layer = layer_of(span_at[i][2]) if i in span_at else "none"
        dur = float(d["dur"]) / 1e6
        out.seconds[layer] += dur
        out.ops[layer] += 1
        out.kernels[(layer, tr.category(d["name"]))] += dur
    return out


def trace_path(ctx) -> Path:
    """Where ``run.py`` wrote the cell's trace (its ``OUT`` folder)."""
    cell = ctx.run.cell
    return Path(cell.root) / ".portbench_out" / f"trace-{cell.name}.json"


def report(sp: Split, steps: int, busy_s: float, log) -> None:
    log(f"[spans] {sp.spans} fluid.* spans; device ms and ops a step by layer (of {steps}):")
    for k in sorted(sp.seconds, key=lambda k: -sp.seconds[k]):
        log(f"[spans]   {k:<10} {1e3 * sp.seconds[k] / steps:10.4f} ms "
            f"{sp.ops[k] / steps:9.2f} ops; " + ", ".join(
                f"{n} {1e3 * v / steps:.4f}" for n, v in sp.top({k}, 4)))
    share = 100.0 * sp.attributed_s / busy_s if busy_s > 0 else float("nan")
    log(f"[spans] attributed to {', '.join(LAYERS)}: {1e3 * sp.attributed_s / steps:.4f} ms a "
        f"step, {share:.2f} % of traced busy ({1e3 * busy_s / steps:.4f} ms a step)")
    log("[spans] top unattributed kernels: " + (", ".join(
        f"{k} {1e3 * v / steps:.4f} ms" for k, v in sp.unattributed()) or "none"))


def read(ctx) -> Split | None:
    """The split of the cell's traced window, read once a process (per
    trace file as written); None without a trace or without spans."""
    if ctx.trace is None or not getattr(ctx.run, "traced_steps", 0):
        return None
    path = trace_path(ctx)
    try:
        st = os.stat(path)
    except OSError:
        return None
    key = (str(path), st.st_mtime_ns, st.st_size)
    if key not in _CACHE:
        sp = split(tr.load_events(str(path)))
        if sp is not None:
            report(sp, ctx.run.traced_steps, ctx.trace.busy_s,
                   lambda m: print(m, file=sys.stderr, flush=True))
        _CACHE.clear()
        _CACHE[key] = sp
    return _CACHE[key]


def device_ms(ctx, layer: str):
    """Device ms a traced step in ``layer``; None where nothing is read."""
    sp = read(ctx)
    return None if sp is None else 1e3 * sp.seconds.get(layer, 0.0) / ctx.run.traced_steps
