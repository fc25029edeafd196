"""The port's ``fluid.*`` spans and its data-layer counter, on the CPU.

- a training step under ``torch.profiler`` holds ``fluid.train_step`` and,
  nested in it on one thread, the encoder, backbone, decoder, loss,
  backward and optimizer spans, inside an outer ``record_function``;
- ``gen_seq`` holds one ``fluid.rollout`` and a ``fluid.rollout_step`` a
  step, each with its encoder, backbone and decoder;
- with no profiler ``span`` never enters ``record_function`` and returns
  one shared no-op;
- ``make_batches.stats`` counts every sample, serial and threaded, loses
  no update under contention, and a
  serial build is a ``fluid.data.build`` span a batch (``torch.profiler``
  records the thread that started it, so worker threads' builds are
  counted, not traced);
- a backward op of the CPU trace carries the ``Sequence number`` of its
  forward op, which the benchmark's reader joins them by.

Tiny models (2 layers, d 64, resolution 64) on the plain twins.
"""

import json
import sys
import threading

import pytest
import torch

from fluid_llm_tpu_torch.data import pipeline
from fluid_llm_tpu_torch.data.pipeline import make_batches
from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
from fluid_llm_tpu_torch.rollout.generate import gen_seq
from fluid_llm_tpu_torch.tools import profiling, rollout_profile, train_profile

torch.set_num_threads(2)

TINY = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, dropout=0.0)
CPU = torch.device("cpu")
MODEL = ("fluid.encoder", "fluid.backbone", "fluid.decoder")


def traced(fn, tmp_path):
    """Run ``fn`` inside ``record_function("outer")`` under the profiler;
    the complete host events of the exported Chrome trace."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("outer"):
            fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and "dur" in e]


def named(events, name):
    return [e for e in events if e["name"] == name]


def inside(e, outer) -> bool:
    return (e["tid"] == outer["tid"] and e["ts"] >= outer["ts"]
            and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"])


def test_train_step_spans_nest(tmp_path):
    trainer, batch = train_profile.build(CPU, resolution=64, batch_size=2, **TINY)
    events = traced(lambda: trainer.train_step(batch), tmp_path)
    (outer,) = named(events, "outer")
    (step,) = named(events, "fluid.train_step")
    assert inside(step, outer)
    for name in MODEL + ("fluid.loss", "fluid.backward", "fluid.optimizer"):
        spans = named(events, name)
        assert spans and all(inside(s, step) for s in spans), name
    # the loss follows the model's forward and comes before the backward
    (loss,), (bwd,) = named(events, "fluid.loss"), named(events, "fluid.backward")
    assert max(s["ts"] for s in named(events, "fluid.decoder")) < loss["ts"] < bwd["ts"]
    # the optimizer's zero_grad before the forward, its step after the backward
    opt = sorted(s["ts"] for s in named(events, "fluid.optimizer"))
    assert opt[0] < loss["ts"] and opt[-1] > bwd["ts"]


def test_gen_seq_spans_a_step_each(tmp_path):
    model, batch = rollout_profile.build(CPU, resolution=64, **TINY)
    n = 3
    events = traced(lambda: gen_seq(model, batch, n), tmp_path)
    (outer,) = named(events, "outer")
    (roll,) = named(events, "fluid.rollout")
    assert inside(roll, outer)
    steps = named(events, "fluid.rollout_step")
    assert len(steps) == n and all(inside(s, roll) for s in steps)
    for name in MODEL:
        spans = named(events, name)
        assert len(spans) == n, name
        assert all(sum(inside(s, st) for s in spans) == 1 for st in steps), name


def test_span_without_profiler_is_the_shared_noop(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("fluid.a"), profiling.span("fluid.b")
    assert a is b is profiling._NO_SPAN
    with a, b:  # reentrant
        pass
    trainer, batch = train_profile.build(CPU, resolution=64, batch_size=2, **TINY)
    assert torch.isfinite(trainer.train_step(batch)["loss"])  # every span off


@pytest.mark.parametrize("workers", [0, 3])
def test_make_batches_counts_every_sample(workers):
    ds = SyntheticCylinderDataset(n_trajectories=5, resolution=32, seq_len=3, mode="train")
    before = dict(make_batches.stats)
    batches = list(make_batches(ds, 2, shuffle=True, seed=1, num_workers=workers))
    after = make_batches.stats
    assert sum(b[0].shape[0] for b in batches) == len(ds) == 5
    assert after["samples"] - before["samples"] == len(ds)
    assert after["build_s"] - before["build_s"] > 0.0


def test_stats_lose_no_update_across_threads():
    n_threads, n = 32, 2000
    before = dict(make_batches.stats)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [pipeline._count(1, 0.5) for _ in range(n)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    after = make_batches.stats
    assert after["samples"] - before["samples"] == n_threads * n
    assert after["build_s"] - before["build_s"] == pytest.approx(0.5 * n_threads * n)


def test_serial_build_spans_each_batch(tmp_path):
    ds = SyntheticCylinderDataset(n_trajectories=4, resolution=32, seq_len=3, mode="train")
    events = traced(lambda: list(make_batches(ds, 2, shuffle=False)), tmp_path)
    builds = named(events, "fluid.data.build")
    assert len(builds) == 2
    # each holds its batch's five stacks, one a field
    stacks = named(events, "aten::stack")
    assert all(sum(inside(s, b) for s in stacks) >= 5 for b in builds)


def test_backward_op_carries_its_forward_sequence_number(tmp_path):
    lin = torch.nn.Linear(8, 8)
    x = torch.randn(4, 8)

    def step():
        with profiling.span("fluid.a"):
            y = torch.tanh(lin(x))
        y.sum().backward()

    events = traced(step, tmp_path)
    fwd = {e["args"]["Sequence number"]: e for e in events if e["name"] == "aten::tanh"
           and "Sequence number" in e.get("args", {})}
    (bwd,) = [e for e in events
              if e["name"] == "autograd::engine::evaluate_function: TanhBackward0"]
    seq = bwd["args"]["Sequence number"]
    assert seq in fwd
    (span,) = named(events, "fluid.a")
    assert inside(fwd[seq], span)
