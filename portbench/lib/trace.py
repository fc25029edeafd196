"""Read a ``torch.profiler`` Chrome trace: device events, busy time, idle gaps.

``device_events`` and ``category`` are copies of the port's
``tools/profiling.py`` (kept here so the yardstick does not move with the
program).  The busy time is the union of the device events' intervals inside
the traced window, taken from the trace's own timeline (not a sum of
durations, which counts overlapping kernels twice); the window is the span of
the harness's annotation ``WINDOW`` on the host.
"""

from __future__ import annotations

import gzip
import json
import re
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
WINDOW = "portbench.window"


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


def load_events(path: str) -> list[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def device_events(events: list[dict]) -> list[dict]:
    """The complete device events (``dur`` in us)."""
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and "dur" in e]


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Merge overlapping ``(start, end)`` intervals, sorted."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def gaps(busy: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle intervals of ``[lo, hi]`` between the merged ``busy`` ones."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


@dataclass
class Trace:
    """What the readers see of one traced sub-window."""

    window_us: tuple[float, float]
    device: list[dict]  # device events inside the window
    busy: list[tuple[float, float]]  # merged device intervals, clipped to the window
    host: list[dict] = field(default_factory=list)  # host events of the harness's thread

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    def kernel_seconds(self, names) -> float:
        """Device seconds of the events whose category is in ``names``."""
        names = set(names)
        return sum(e["dur"] for e in self.device if category(e["name"]) in names) / 1e6

    def top_ops(self, n: int = 10) -> list[list]:
        per = defaultdict(float)
        for e in self.device:
            per[category(e["name"])] += e["dur"] / 1e6
        return [[k, v] for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, n: int = 10) -> list[list]:
        """Idle device time by what the harness's thread was doing: each gap
        is named after the harness's span (``portbench.*``) and the innermost
        host event that cover its middle (``idle`` where none does), and the
        seconds summed by name."""
        per = defaultdict(float)
        # one thread's events nest: a sweep keeps the open ones on a stack,
        # whose top is the innermost event covering a point
        spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                        for e in self.host), key=lambda t: (t[0], -t[1]))
        stack, i = [], 0
        for s, e in sorted(gaps(self.busy, *self.window_us), key=lambda g: g[0] + g[1]):
            mid = (s + e) / 2
            while i < len(spans) and spans[i][0] <= mid:
                while stack and stack[-1][1] < spans[i][0]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            outer = next((x[2] for x in stack if x[2].startswith("portbench.")
                          and x[2] != WINDOW and x[1] >= mid), None)
            inner = stack[-1][2] if stack else "idle"
            per[inner if outer in (None, inner) else f"{outer}/{inner}"] += (e - s) / 1e6
        return [[k, v] for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:n]]


def read_trace(path: str) -> Trace:
    """The sub-window that the ``WINDOW`` annotation spans in the trace at
    ``path``: its device events, their merged intervals and the host events
    of the annotation's thread."""
    events = load_events(path)
    marks = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise ValueError(f"no {WINDOW} annotation in {path}")
    mark = marks[0]
    lo, hi = float(mark["ts"]), float(mark["ts"]) + float(mark["dur"])
    dev = [e for e in device_events(events) if e["ts"] < hi and e["ts"] + e["dur"] > lo]
    busy = clip(union([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev]), lo, hi)
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
            and e.get("tid") == mark.get("tid") and e.get("pid") == mark.get("pid")
            and "dur" in e and e["ts"] < hi and e["ts"] + e["dur"] > lo and e is not mark]
    return Trace(window_us=(lo, hi), device=dev, busy=busy, host=host)
