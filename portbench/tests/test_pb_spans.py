"""The readers of the port's ``fluid.*`` spans on a hand-built Chrome trace.

A forward kernel goes to the innermost span around its launch, a backward
one through its autograd node's sequence number to its forward op's span,
one launched outside every span stays unattributed; every reader is None
on a trace without a span; the trace file is parsed once for all readers.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench.lib import data_stats, spans, spec
from portbench.lib import trace as tr

METRICS = Path(__file__).resolve().parent.parent / "metrics"
DEVICE_MS = ["encoder_device_ms.train", "backbone_device_ms.train", "decoder_device_ms.train",
             "loss_device_ms.train", "optimizer_device_ms.train", "encoder_device_ms.rollout",
             "backbone_device_ms.rollout", "decoder_device_ms.rollout",
             "window_device_ms.rollout"]
MAIN, AUTOGRAD = 7, 8  # the harness's thread, the autograd engine's


def host(name, ts, dur, tid=MAIN, cat="user_annotation", **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def launch(ts, corr, tid=MAIN):
    return host("cudaLaunchKernel", ts, 0.5, tid, "cuda_runtime", correlation=corr)


def kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 0,
            "args": {"correlation": corr}}


def events(with_spans: bool = True) -> list:
    """Two steps in the window (0, 200): the same layout each, 100 us apart."""
    ev = [host(tr.WINDOW, 0, 200)]
    for k in range(2):
        t = 100 * k
        n = 10 * k
        if with_spans:
            ev += [host("fluid.train_step", t + 1, 80),
                   host("fluid.encoder", t + 2, 8),
                   host("fluid.backbone", t + 10, 20),
                   host("fluid.loss", t + 32, 6),
                   host("fluid.optimizer", t + 70, 10)]
        ev += [
            # encoder: an op of sequence number n + 1 launches kernel n + 1
            host("aten::add", t + 3, 2, cat="cpu_op", **{"Sequence number": n + 1,
                                                          "Fwd thread id": 0}),
            launch(t + 4, n + 1),
            # backbone: the mm of sequence number n + 2
            host("aten::mm", t + 11, 3, cat="cpu_op", **{"Sequence number": n + 2,
                                                         "Fwd thread id": 0}),
            launch(t + 12, n + 2),
            launch(t + 34, n + 3),  # loss
            # backward, on the engine's thread: the mm's node, one node of no forward op
            host("autograd::engine::evaluate_function: MmBackward0", t + 40, 10, AUTOGRAD,
                 "cpu_op", **{"Sequence number": n + 2, "Fwd thread id": 1}),
            host("aten::mm", t + 41, 5, AUTOGRAD, "cpu_op"),
            launch(t + 42, n + 4, AUTOGRAD),
            host("autograd::engine::evaluate_function: torch::autograd::AccumulateGrad", t + 52,
                 4, AUTOGRAD, "cpu_op"),
            launch(t + 53, n + 5, AUTOGRAD),
            launch(t + 75, n + 6),  # optimizer
            launch(t + 90, n + 7),  # outside every span
            kernel("void enc_kernel<4>(int)", t + 5, 2, n + 1),
            kernel("mm_kernel", t + 15, 10, n + 2),
            kernel("loss_kernel", t + 36, 3, n + 3),
            kernel("mm_bwd_kernel", t + 44, 20, n + 4),
            kernel("accumulate_kernel", t + 65, 1, n + 5),
            kernel("adam_kernel", t + 76, 4, n + 6),
            kernel("stray_kernel", t + 92, 5, n + 7),
        ]
    return ev


def test_forward_to_the_innermost_span_backward_by_sequence_number():
    sp = spans.split(events())
    us = {k: v * 1e6 for k, v in sp.seconds.items()}
    assert us["encoder"] == pytest.approx(2 * 2)
    assert us["backbone"] == pytest.approx(2 * (10 + 20))  # its forward kernel and its backward
    assert us["loss"] == pytest.approx(2 * 3)
    assert us["optimizer"] == pytest.approx(2 * 4)
    assert us["backward"] == pytest.approx(2 * 1)  # a node of no forward op
    assert us["none"] == pytest.approx(2 * 5)  # launched outside every span
    assert sp.ops["backbone"] == 4 and sp.ops["none"] == 2
    assert sp.unattributed() == [("stray_kernel", pytest.approx(10e-6)),
                                 ("accumulate_kernel", pytest.approx(2e-6))]
    assert sp.top({"backbone"}, 1) == [("mm_bwd_kernel", pytest.approx(40e-6))]
    assert sp.attributed_s == pytest.approx((4 + 60 + 6 + 8) * 1e-6)


def test_rollout_spans_are_the_window_layer():
    ev = [host(tr.WINDOW, 0, 50), host("fluid.rollout", 1, 45), host("fluid.rollout_step", 2, 40),
          host("fluid.decoder", 20, 10), launch(5, 1), launch(22, 2), launch(44, 3),
          kernel("cat_kernel", 6, 2, 1), kernel("slot_kernel", 25, 3, 2),
          kernel("stack_kernel", 46, 1, 3)]
    sp = spans.split(ev)
    assert sp.seconds["window"] == pytest.approx(3e-6)  # the step's own op and the rollout's
    assert sp.seconds["decoder"] == pytest.approx(3e-6)


def write_root(tmp_path, ev, cell="opt125m.train_b64") -> Path:
    out = tmp_path / ".portbench_out"
    out.mkdir()
    (out / f"trace-{cell}.json").write_text(json.dumps({"traceEvents": ev}))
    return out / f"trace-{cell}.json"


def ctx_of(tmp_path, path, cell="opt125m.train_b64", steps=2):
    run = SimpleNamespace(cell=SimpleNamespace(root=tmp_path, name=cell), traced_steps=steps)
    return SimpleNamespace(run=run, trace=tr.read_trace(str(path)), device=None)


def readers():
    return {m: spec.load_module(METRICS / f"{m}.py", f"metric.{m}") for m in DEVICE_MS}


def test_every_reader_none_without_spans(tmp_path, monkeypatch):
    ctx = ctx_of(tmp_path, write_root(tmp_path, events(with_spans=False)))
    assert all(r.read(ctx) is None for r in readers().values())
    # a program without the data counter
    monkeypatch.delattr(data_stats.pipeline.make_batches, "stats")
    for c in ("train", "rollout"):
        r = spec.load_module(METRICS / f"sample_build_ms.{c}.py", f"metric.sample_build_ms.{c}")
        assert r.read(ctx) is None


def test_the_trace_is_parsed_once(tmp_path, monkeypatch, capsys):
    ctx = ctx_of(tmp_path, write_root(tmp_path, events()))
    calls = []
    real = tr.load_events
    monkeypatch.setattr(tr, "load_events", lambda p: calls.append(p) or real(p))
    monkeypatch.setattr(spans, "_CACHE", {})
    got = {m: r.read(ctx) for m, r in readers().items()}
    assert len(calls) == 1
    assert got["encoder_device_ms.train"] == pytest.approx(0.002)  # ms a step
    assert got["backbone_device_ms.train"] == pytest.approx(0.030)
    assert got["window_device_ms.rollout"] == pytest.approx(0.0)
    err = capsys.readouterr().err
    assert "% of traced busy" in err and "stray_kernel" in err


def test_sample_build_ms_reads_the_counter(monkeypatch):
    monkeypatch.setattr(data_stats.pipeline.make_batches, "stats",
                        {"samples": 64, "build_s": 1.28})
    r = spec.load_module(METRICS / "sample_build_ms.train.py", "metric.sample_build_ms.train")
    assert r.read(None) == pytest.approx(20.0)
