"""The operation and byte counts against shapes worked out by hand."""

import json
from pathlib import Path

import pytest

from portbench.inputs.weights import geometry
from portbench.lib import counts, peaks

BENCH = Path(__file__).resolve().parent.parent


def dims(name):
    conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    return counts.dims_of(conf, geometry(conf))


def test_geometry_of_the_published_grid():
    conf = json.loads((BENCH / "configs" / "opt125m.json").read_text())
    g = geometry(conf)
    # 238 x int(238 * 0.41 / 1.6) = 238 x 60, padded to 240 x 64: 15 x 4 patches of 16 x 16
    assert g["grid"] == (238, 60) and g["padded"] == (240, 64)
    assert (g["nx"], g["ny"], g["n_patch"]) == (15, 4, 60)
    assert g["pad_x"] == (1, 1) and g["pad_y"] == (2, 2)
    assert g["t_table"] == 10


def test_pairs():
    assert counts.causal_pairs(1) == 1
    assert counts.causal_pairs(601) == 601 * 602 // 2
    # the last 60 of 661 causal tokens: keys 602..661 each
    assert counts.tail_pairs(661, 60) == sum(range(602, 662))
    assert counts.tail_pairs(5, 5) == counts.causal_pairs(5)


def test_train_step_of_opt125m_by_hand():
    d = dims("opt125m")
    B, F, N = 32, 10, 60
    T = B * (F * N + 1)  # 19 232 tokens
    assert T == 19232
    enc = 2 * B * F * N * (768 * 512 + 512 * 768)
    enc_first = 2 * B * F * N * 768 * 512
    layer = 2 * T * (4 * 768 * 768 + 2 * 768 * 3072)
    lora = 2 * T * 2 * (768 * 16 + 16 * 768)
    dora = 2 * (2 * 768 * 768 * 16 + 2 * 16 * 768 * 16 + 2 * 16 * 16 * 768)
    frames = B * F
    dec = 2 * frames * N * (768 * 512 + 512 * 256 * 32) \
        + 2 * 2 * frames * 15360 * (32 * 48 + 48 * 48 + 48 * 3)
    attn = 4 * 768 * B * (601 * 602 // 2)
    fwd = enc + 12 * (layer + lora + dora + attn) + dec
    bwd_in = (enc - enc_first) + 12 * (layer + lora + 2 * attn) + dec
    bwd_w = enc + 12 * lora + dec
    assert counts.train_step_ops(d, B, F) == pytest.approx(fwd + bwd_in + bwd_w, rel=1e-12)
    assert 7.5e12 < counts.train_step_ops(d, B, F) < 8.5e12


def test_rollout_step_of_opt350m_by_hand():
    d = dims("opt350m")
    assert d.projected and d.d_embed == 512 and d.d_model == 1024
    B = 32
    # step 20: the window holds 10 frames, the duplicate and BOS: 661 tokens
    assert counts.window_tokens(d, 20, 10) == (10, 661)
    assert counts.window_tokens(d, 0, 10) == (1, 121)
    n, q = 661, 60
    enc = 2 * B * 11 * 60 * (768 * 512 + 512 * 512)
    full = 23 * (2 * B * n * (4 * 1024 * 1024 + 2 * 1024 * 4096)
                 + 4 * 1024 * B * (n * (n + 1) // 2))
    last = 2 * B * n * 1024 * 2048 + 2 * B * q * 1024 * 2048 + 2 * B * q * 1024 * 8192 \
        + 4 * 1024 * B * counts.tail_pairs(n, q)
    proj = 2 * B * n * 512 * 1024 + 2 * B * q * 1024 * 512
    dec = 2 * B * 60 * (512 * 512 + 512 * 8192) + 2 * 2 * B * 15360 * (32 * 48 + 48 * 48 + 48 * 3)
    assert counts.rollout_step_ops(d, B, 20, 10) == pytest.approx(enc + full + last + proj + dec,
                                                                  rel=1e-12)


def test_attention_and_slot_work_by_hand():
    d = dims("opt125m")
    nbytes, ops, kind = counts.attention_fwd_work(d, 8, 601, lse=True)
    rows = 8 * 601
    assert nbytes == 4 * rows * 768 * 2 + rows * 4 + rows * 12 * 4
    assert ops == 4 * 768 * 8 * (601 * 602 // 2) and kind == "bf16"
    nbytes, ops, _ = counts.attention_bwd_work(d, 8, 601)
    assert nbytes == 7 * rows * 768 * 2 + 2 * rows * 12 * 4 + rows * 4
    assert ops == 10 * 768 * 8 * (601 * 602 // 2)
    nbytes, ops, kind = counts.slot_fwd_work(80, 240 * 64, 48, 2)
    n = 80 * 240 * 64 * 48
    assert (nbytes, ops, kind) == (3 * n * 2 + 48 * 4, 35 * n, "f32")
    nbytes, ops, _ = counts.slot_bwd_work(80, 240 * 64, 48, 2)
    assert (nbytes, ops) == (5 * n * 2 + 2 * 48 * 4, 70 * n)
    assert counts.slot_channels(d) == [48, 48, 3]


def test_bound_takes_the_larger_side():
    # 3.35 GB at 3.35 TB/s is 1 ms; 989 GFLOP at 989 TFLOP/s is 1 ms
    assert peaks.bound_s(3.35e9, 0.0, "bf16") == pytest.approx(1e-3)
    assert peaks.bound_s(0.0, 989e9, "bf16") == pytest.approx(1e-3)
    assert peaks.bound_s(3.35e9, 2 * 989e9, "bf16") == pytest.approx(2e-3)
