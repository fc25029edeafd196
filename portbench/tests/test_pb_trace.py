"""The trace arithmetic: union of device intervals, idle share, gaps by host activity."""

import json

import pytest

from portbench.lib import trace as tr


def test_union_merges_overlaps_and_touching():
    assert tr.union([(5, 7), (0, 2), (1, 3), (3, 4), (10, 11)]) == [(0, 4), (5, 7), (10, 11)]
    assert tr.union([]) == []


def test_gaps_and_clip():
    busy = tr.union([(2, 4), (3, 5), (7, 8)])
    assert tr.gaps(busy, 0, 10) == [(0, 2), (5, 7), (8, 10)]
    assert tr.clip([(0, 3), (5, 12)], 1, 10) == [(1, 3), (5, 10)]


def write_trace(path, device, host, window=(0.0, 100.0)):
    events = [{"ph": "X", "cat": "user_annotation", "name": tr.WINDOW, "ts": window[0],
               "dur": window[1] - window[0], "pid": 1, "tid": 7}]
    for name, ts, dur in device:
        events.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
                       "pid": 0, "tid": 0})
    for name, ts, dur in host:
        events.append({"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur,
                       "pid": 1, "tid": 7})
    # a worker thread's event is not the harness's
    events.append({"ph": "X", "cat": "cpu_op", "name": "worker", "ts": 0, "dur": 100,
                   "pid": 1, "tid": 9})
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_busy_is_the_union_not_the_sum(tmp_path):
    # two overlapping kernels on (10, 30) and (20, 40), one at (60, 70), one outside
    path = write_trace(tmp_path / "t.json",
                       [("void a_kernel<4>(int)", 10, 20), ("b_kernel", 20, 20),
                        ("void a_kernel<8>(float)", 60, 10), ("late", 150, 10)], [])
    t = tr.read_trace(path)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(40e-6)  # (10, 40) and (60, 70), not 20 + 20 + 10
    assert 1 - t.busy_s / t.window_s == pytest.approx(0.6)
    assert t.kernel_seconds(["a_kernel"]) == pytest.approx(30e-6)
    assert t.top_ops(2) == [["a_kernel", pytest.approx(30e-6)], ["b_kernel", pytest.approx(20e-6)]]


def test_idle_gaps_named_by_the_host(tmp_path):
    path = write_trace(tmp_path / "t.json", [("k", 10, 30), ("k", 60, 10)],
                       [("portbench.data", 0, 12), ("aten::fill_", 2, 6),
                        ("portbench.step", 40, 60), ("aten::mm", 45, 10)])
    t = tr.read_trace(path)
    gaps = dict((k, v) for k, v in t.idle_by_host())
    # (0, 10) mid 5: inside the data span's fill; (40, 60) mid 50: the step's mm;
    # (70, 100) mid 85: the step span alone
    assert gaps["portbench.data/aten::fill_"] == pytest.approx(10e-6)
    assert gaps["portbench.step/aten::mm"] == pytest.approx(20e-6)
    assert gaps["portbench.step"] == pytest.approx(30e-6)
    assert "worker" not in str(gaps)


def test_category_names():
    assert tr.category("void at::native::foo_kernel<4, F<2>>(int, float)") == "foo_kernel"
    assert tr.category("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"
    assert tr.category("void (anonymous namespace)::grid_slot_fwd_kernel<T, 8, 2>(T*)") \
        == "grid_slot_fwd_kernel"
