"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, roll out, train, stream, serve.

    python3 chip_smoke.py [--seed 1234] [--out results.json]

Phases, each printing one line per result; any failure exits nonzero:

1. device   -- needs CUDA (never continues on the CPU); prints the card's
               name and power limit, nvcc's and torch's versions;
2. build    -- compiles the CUDA kernels from ``fluid_llm_tpu_torch/csrc``;
3. kernels  -- each kernel against its plain PyTorch twin in bf16, at the
               rollout's shapes (exact attention, slot attention), the
               training step's (flash forward, dq, dk/dv at (8, 601, 768);
               slot attention and its backward at 80 frames), the streaming
               step's (slab decode attention over 11 slots of 64 rows,
               H 12: a wrapped ring, the first decode with 9 slots
               unwritten, the 61-token prefill) and the serving linears'
               (int8 matmul w8a8 at the flagship's 60 and 61 rows and
               OPT's 661, w8a16 at OPT's 661 and 60 with its biases and at
               the flagship's 60), the stacked streaming step's (indexed
               linear at its five (M, K, N), M 60 and 61, layers 0 and 11
               of 12) and ``attn_impl="short"``'s (short attention at the
               training step's (8, 601, 768) and the rollout's (1, 661,
               768) with 7 of 10 window frames invalid): relative
               L2 error (bound REL_TOL) and device time per call, kernel,
               plain and the PyTorch library call that computes the same
               function (``library_ms``: ``scaled_dot_product_attention``
               with the same mask; its backward as device time, captured in
               a CUDA graph, with the backend that served it, beside dq +
               dk/dv; ``torch._int_mm`` on the
               quantised activations; bf16 ``F.linear`` on the weight
               already dequantised, or on the host-indexed view ``w[li]``),
               beside ``bound_ms``: the larger of the
               bytes moved over 3.35 TB/s and the operations over the peak
               of their type (989 bf16, 1,979 int8, 67 f32 T/s; H100 SXM);
               exact attention, the flash forward (its lse within
               LSE_TOL), the slab decode, the indexed linear, w8a8, w8a16,
               short attention, the flash dq and dk/dv, the slot-attention
               backward and the segment kernels also repeated bit for bit,
               all but the last with their launch geometry, and the segment
               sum equal bit for bit to a CPU walk of its CSR (each row's
               edges ascending, added in f32 from 0); then ("[plans]"
               lines) every launch plan of the indexed linear (column tile,
               K split) at the stacked streaming step's four shapes (M 60),
               of w8a16 (token tile, K split) at its six main-path shapes,
               of w8a8 (column tile, K split) at its nine above (each equal
               to the twin, beside ``_int_mm`` and w8a16) and of short
               attention (64 or 128 query rows a block) at its two, each
               against the twin and timed (w8a16 and the indexed linear
               beside the library call): the tables
               ``indexed_linear.plan``, ``quant_matmul.plan``,
               ``quant_matmul.w8a8_plan`` and ``short_attention.plan`` are
               read from;
4. slice    -- ``configs/training1.yaml`` (OPT-125m at full width and depth,
               DoRA r16 merged, BOS, see-init, MLPGNN, bf16) with seeded
               random weights on ``synthetic:1`` at seq_len 253, through
               ``inference.test_generate``: 251 rollout steps.  The launch
               counters must read 11x251 (exact attention, layers 0..10)
               and 3x251 (slot attention, 3 GATv2 convs); outputs finite;
               prints mean N-RMSE, wall time, peak device memory and
               rollout steps/s through the kernels and the twins in turns;
5. agreement -- a 10-step rollout through the kernels against the same
               rollout through the plain twins (selected explicitly):
               relative error of the diffs per step, step 1 <= REL_TOL;
               then the device profile of a 20-step rollout (idle share);
6. train    -- the same configuration as published (DoRA unmerged, every
               configured dropout) on ``synthetic:8``, seed 1234: autoreg
               steps through ``Trainer`` on one repeated batch of 8, in
               turns through the kernels and through the twins.  Launches
               per kernel step must read 12 (flash forward, dq, dk/dv: 12
               layers) and 3 (slot attention forward and backward: 3
               convs); losses finite and the last below the first; every
               trainable group gets gradient.  Prints the median step ms of
               each, peak device memory and the device's idle share;
7. train agreement -- one step's loss and trainable gradient through the
               kernels against the twins, same weights, batch and dropout
               seed: loss within REL_TOL, gradient within GRAD_TOL;
8. entry points -- ``main`` for 2 epochs (checkpoints in a temporary
               folder), ``continue_train`` for 1 more, ``inference.main
               --checkpoint_dir`` rolls out from the last checkpoint:
               finite N-RMSE;
9. streaming -- phases 4 and 5 for ``configs/flagship_llama.yaml`` as
               published (the ``fluid/llama-125m`` backbone, 12 layers at
               d 768, rope_abs, absolute time, DoRA r16 merged, MLPGNN,
               bf16) through ``test_generate(streaming=True)``: 251 steps of
               the KV-cache rollout.  Launches must read 12x251 + 12 (slab
               decode attention, every layer of every step and of the
               prefill), 3x251 (slot attention) and 0 (exact attention);
10. flagship entry points -- ``main`` trains a copy of
               ``flagship_llama.yaml`` for 1 epoch on ``synthetic:8``;
               ``inference.main --streaming --checkpoint_dir`` serves 25
               steps from its checkpoint, then the exact ``inference.main``
               from the same checkpoint (LLaMA through the exact-window
               kernel), launches of each shown and checked;
11. serve   -- ``tools.serve.load_engine(quant="int8", qmm_mode="w8a8")``
               on phase 10's checkpoint (adapters merged, every backbone
               linear int8; w8a8 is the opt-in, w8a16 the default as in the
               JAX package; streaming auto-selected), ``serve`` on 127.0.0.1 in a
               thread, ``warmup``; three 251-step ``POST /v1/rollout`` and
               one of 50 steps from 3 context frames, ``GET /v1/stats``.
               Launches over one 251-step request must read 7x12x252
               (w8a8: q, k, v, o, gate, up, down of every layer of every
               step and of the prefill), 12x252 (slab decode), 3x251 (slot
               attention), 0 elsewhere; outputs finite, in physical units;
               10 steps kernels vs twins on the same int8 weights (step 1
               <= REL_TOL); int8 vs dense engines of the checkpoint over 3
               steps (mean |diff| / mean |dense| < 0.05); prints latency,
               steps/s, p50, peak memory, the backbone's weight bytes dense
               vs int8, and for 50-step requests of the int8 and the dense
               engine in turns the wall time, device time, device ops and
               idle share of each;
12. serve exact -- ``load_engine(quant="int8", qmm_mode="w8a16",
               streaming="off")`` on phase 8's ``training1.yaml``
               checkpoint (DoRA unmerged there): one 25-step request; w8a16
               launches 72 a step (6 linears x 12 layers), exact attention
               11 a step, w8a8 0; finite; 10 steps kernels vs twins on the
               same int8 weights (step 1 <= REL_TOL); the device time a
               step and idle share of a profiled 10-step rollout;
13. graph baselines -- ``baselines_cli.main`` at the EAGLE geometry
               (synthetic 84x42 mesh: 3 529 node rows and 20 480 edge rows a
               graph, batch 4, 15 blocks at width 128): MeshGraphNet for 2
               epochs of one step, validation, the 101-step eval of 4 test
               trajectories (N-RMSE, CSV, checkpoint), then GAT (4 heads) for
               1 epoch.  The segment gather and sum launches of each run
               must equal the count from the code (MeshGraphNet: 188 and 180
               a train step, 3 200 and 1 500 a 101-step trajectory); on one
               batch, a step's launches, step ms through the kernels and the
               twins in turns, the device profile, one step's loss and
               gradient kernels vs twins (f32, TF32 off; GRAPH_LOSS_TOL,
               GRAPH_GRAD_TOL) and the twins against themselves, and the
               segment sum repeated bit for bit (the kernels' whole step
               too, shown).  Phase 3 holds both kernels
               to their twins at these shapes (the gather bit for bit);
14. stacked streaming -- phase 9 with the weights prepared in the
               stacked-layer layout (``FLUID_SCAN_LAYERS=1``): launches must
               read 5x12x252 (indexed linear: qkv, o, gate, up, down of
               every layer of every step and of the prefill), 12x252 (slab
               decode), 3x251 (slot attention), 0 elsewhere; step 1 against
               the twins and against the unrolled layout of the same
               weights, each <= REL_TOL; the two layouts' steps/s in turns
               and each one's device and host profile;
15. short train -- phases 6 and 7 with the backbone built with
               ``attn_impl="short"``: 12 short-attention launches a step (the
               backward recomputes the twin), 0 flash, 3 and 3 slot;
16. short rollout -- phase 4 with ``attn_impl="short"`` on the stacked
               layout: 11x251 short-attention launches, 0 exact, 0 indexed
               linear (the stacked forward reads weight slices); step 1
               against the twins and the unrolled layout, the layouts timed
               in turns as in phase 14.

Phases 8 to 13 share one temporary folder, removed at the end.  Phases 14
to 16 roll out three turns each (kernels, twins, kernels).  An
exception inside a phase is recorded as a failure of that phase and the
run goes on; every failure is printed on stdout and stderr at the end, and
the run then exits 1 without a result.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
``nvidia-smi`` name and power limit; before that one JSON line of kernel
results.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from unittest import mock

import torch

# Relative L2 bound, kernel vs twin, bf16.  The kernels keep scores, softmax
# weights and sums in f32 and round once; the twins round intermediates to
# bf16 (2^-8 ~ 3.9e-3 relative per rounding: attention probabilities, GATv2
# logits and weights).  Observed <= 6e-3 at these shapes (H100).
REL_TOL = 1e-2
# Relative L2 bound on the whole trainable gradient of one step, kernels vs
# twins: both run bf16 activations through 12 layers, and round attention
# differently (the twin its probabilities, the kernels p and ds as bf16
# tensor-core operands), so per-layer differences of a few 1e-3 compound
# through the backward over 12 layers and the decoder.
GRAD_TOL = 5e-2
# Absolute bound on the flash forward's row logsumexp against the twin's
# (f32 statistics on both sides; the kernel's exp2-domain max and log of the
# sum differ from torch.logsumexp by rounding only; observed ~1e-6).
LSE_TOL = 1e-4
STEPS = 251
ROLLOUT_TOKENS = 11 * 60 + 1  # 10-frame window + see-init frame, 60 patches each, + BOS
TRAIN_BS = 8
TRAIN_TOKENS = 10 * 60 + 1  # 9 input frames + the see-init duplicate, 60 patches each, + BOS


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def device_ms(fn, inner: int = 10, n: int = 25, stream=None) -> float:
    """Device time of one call: ``inner`` calls captured in a CUDA graph,
    replayed ``n`` times between CUDA events; the median over ``inner``.
    The graph removes the host's launch gaps, which would otherwise be
    counted for kernels shorter than their launch overhead.  The warm-up
    and the capture run on ``stream`` (a new side stream by default)."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(inner):
            fn()
    graph.replay()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def event_ms(fn, n: int = 10) -> float:
    """Device time of one call between CUDA events, averaged over ``n``
    calls after a warm-up; for calls a CUDA graph cannot capture (a host
    synchronisation inside), launch gaps included."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def sdpa_backward_ms(q, k, v, mask, dout, n_heads: int) -> tuple[float, str]:
    """Device time of the library's backward beside dq and dk/dv: autograd
    through one ``scaled_dot_product_attention`` call (the same mask),
    timed by :func:`device_ms`.  Autograd runs a backward on its forward's
    stream, so the forward, the warm-up and the capture share one side
    stream.  Returns the time and the SDPA backend that served it
    (``torch._fused_sdp_choice``) with the backward's largest device
    kernels (profiler, one call)."""
    from torch.nn.attention import SDPBackend

    heads = lambda t: t.unflatten(-1, (n_heads, -1)).transpose(1, 2)  # noqa: E731
    choice = torch._fused_sdp_choice(heads(q), heads(k), heads(v), attn_mask=mask)
    backend = next((b.name for b in SDPBackend.__members__.values() if int(b) == choice),
                   str(choice))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out, grad = sdpa(*leaves, mask, n_heads), heads(dout)
    step = lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True)  # noqa: E731
    ms = device_ms(step, stream=side)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.cuda.stream(side):
            step()
        side.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    return ms, f"{backend}: {', '.join(_short(e.key) for e in kernels[:3])}"


# H100 SXM (NVIDIA data sheet, dense rates): HBM bytes/s and peak operations/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def bound(n_bytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take: the larger of ``n_bytes`` (each
    input read once, each output written once) over the memory rate and
    ``ops`` over the peak rate of their type; which of the two bounds it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind]
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def sdpa(q, k, v, mask, n_heads: int):
    """The library call beside the attention kernels: packed (bs, L, H*hd)
    heads as (bs, H, L, hd) views, a boolean mask broadcast over heads."""
    heads = lambda t: t.unflatten(-1, (n_heads, -1)).transpose(1, 2)  # noqa: E731
    return torch.nn.functional.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                                            attn_mask=mask)


def run(cmd: list[str]) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    return (res.stdout + res.stderr).strip()


def phase_device() -> dict:
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {smi}")
    from fluid_llm_tpu_torch.ops import _build

    print(f"[device] nvcc: {run([_build._nvcc(), '--version']).splitlines()[-1]}")
    print(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}")
    return {"smi": smi, "name": torch.cuda.get_device_name(0)}


def phase_build() -> float:
    from fluid_llm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    secs = time.perf_counter() - t0
    print(f"[build] {path.name} in {secs:.2f} s")
    name = "?"
    for line in path.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _kernel_name(m.group(1))
        elif "spill" in line or "registers" in line:
            print(f"[build] ptxas {name}: {line.split(':', 1)[-1].strip()}")
    return secs


def _kernel_name(mangled: str) -> str:
    """``name<template args>`` of a mangled ``*_kernel`` entry: the source
    name that its length prefix spells out."""
    for d in re.finditer(r"\d+", mangled):
        for j in range(len(d.group())):  # "118slab...": the length may be "18"
            name = mangled[d.end():d.end() + int(d.group()[j:])]
            if name.endswith("_kernel"):
                args = re.match(r"I(\w+?)EE", mangled[d.end() + len(name):])
                return f"{name}<{args.group(1)}>" if args else name
    return mangled


def _slab_case(dev, state: str, g: torch.Generator):
    """Queries and a random 12-layer bf16 slab cache at the flagship's
    streaming shapes (R 10 frames of 60 tokens + 61 sinks: 11 slots of 64
    rows, H 12 x hd 64), read at layer 5.  ``wrapped``: 14 frames written,
    slot order != position order; ``first``: the first decode, ring slot 0
    and the sinks written; ``prefill``: the 61 sinks querying themselves,
    every ring slot unwritten."""
    from fluid_llm_tpu_torch.models import backbone as bb
    from fluid_llm_tpu_torch.ops import decode_attention as da

    cfg = bb.preset("fluid/llama-125m").replace(dtype=torch.bfloat16)
    R, frame, n_sink = 10, 60, 61
    cache = bb.init_streaming_cache(cfg, 1, n_sink, R, frame, device=dev)
    for name in ("k", "v"):
        cache[name].copy_((torch.randn(cache[name].shape, generator=g) * 0.5))
    base = lambda f: n_sink + f * frame  # noqa: E731
    ring = [-1] * R
    n_written = {"wrapped": R + 4, "first": 1, "prefill": 0}[state]
    for f in range(n_written):
        ring[f % R] = base(f)
    q0, P = (base(n_written - 1), frame) if n_written else (0, n_sink)
    cache["ring_pos"].copy_(torch.tensor(ring, dtype=torch.int32))
    cache["sink_pos"].copy_(torch.arange(n_sink, dtype=torch.int32))
    key_pos = da.pad_key_pos(bb.slab_key_positions(cache, frame))
    # q as the streaming step hands it over: rope'd heads, contiguous
    q = (torch.randn(1, P, cfg.d_model, generator=g) * 0.5).to(dev, torch.bfloat16)
    return q, cache, key_pos, torch.tensor([q0], dtype=torch.int32, device=dev), 5


def _allowed_causal(valid: torch.Tensor) -> torch.Tensor:
    """(bs, L, L) bool: ``backbone.make_masks``' rule, the kernels' mask."""
    L = valid.shape[1]
    causal = torch.ones(L, L, dtype=torch.bool, device=valid.device).tril()
    eye = torch.eye(L, dtype=torch.bool, device=valid.device)
    return (causal[None] & (valid != 0)[:, None, :]) | eye[None]


# the serving linears (mode, M, K, N, bias, on the mode's main path): the
# flagship's bias-free LLaMA linears (q/k/v/o 768x768, gate/up 768->2048,
# down 2048->768) at the streaming step's 60 rows and the prefill's 61;
# OPT-125m's biased ones (768x768, fc1 768->3072, fc2 3072->768) at the
# exact rollout's 661 rows and the sliced last block's 60 (q, o, fc1, fc2)
QMM_CASES = [
    ("w8a8", 60, 768, 768, False, True), ("w8a8", 60, 768, 2048, False, True),
    ("w8a8", 60, 2048, 768, False, True), ("w8a8", 61, 768, 768, False, True),
    ("w8a8", 61, 768, 2048, False, True), ("w8a8", 61, 2048, 768, False, True),
    ("w8a8", 661, 768, 768, True, False), ("w8a8", 661, 768, 3072, True, False),
    ("w8a8", 661, 3072, 768, True, False),
    ("w8a16", 661, 768, 768, True, True), ("w8a16", 661, 768, 3072, True, True),
    ("w8a16", 661, 3072, 768, True, True), ("w8a16", 60, 768, 768, True, True),
    ("w8a16", 60, 768, 3072, True, True), ("w8a16", 60, 3072, 768, True, True),
    ("w8a16", 60, 768, 2048, False, False), ("w8a16", 60, 2048, 768, False, False),
]


def phase_kernels(dev, failures: list) -> list[dict]:
    import torch.nn.functional as F

    from fluid_llm_tpu_torch.ops import _build
    from fluid_llm_tpu_torch.ops import decode_attention as da
    from fluid_llm_tpu_torch.ops import exact_attention as xa
    from fluid_llm_tpu_torch.ops import flash_attention as fa
    from fluid_llm_tpu_torch.ops import grid_gnn_fused as gf
    from fluid_llm_tpu_torch.ops import quant
    from fluid_llm_tpu_torch.ops import quant_matmul as qmm

    g = torch.Generator().manual_seed(0)
    rows = []
    for L, H, hd, n_invalid in [(ROLLOUT_TOKENS, 12, 64, 0), (ROLLOUT_TOKENS, 12, 64, 181),
                                (300, 16, 32, 37), (300, 6, 128, 0)]:
        D = H * hd
        # q/k/v as the backbone hands them over: column slices of one fused qkv
        qkv = (torch.randn(1, L, 3 * D, generator=g) * 0.5).to(dev, torch.bfloat16)
        q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
        valid = (torch.arange(L)[None] >= n_invalid).int().to(dev)
        out = xa.causal_attention(q, k, v, valid, H, hd)
        ref = xa.causal_attention_ref(q, k, v, valid, H, hd)
        again = xa.causal_attention(q, k, v, valid, H, hd)
        twin_again = xa.causal_attention_ref(q, k, v, valid, H, hd)
        allowed = _allowed_causal(valid)
        torch.cuda.synchronize()
        rows.append(dict(
            kernel="exact_attention", shape=f"(1,{L},{D}) H{H} hd{hd} invalid{n_invalid}",
            main_path=(L == ROLLOUT_TOKENS), rel=rel_err(out, ref),
            max_abs_err=(out.float() - ref.float()).abs().max().item(),
            deterministic=bool(torch.equal(again, out)),
            twin_deterministic=bool(torch.equal(twin_again, ref)),
            geometry=f"{H} heads x 1 batch x {len(xa.query_tiles(L))} query tiles of "
                     f"{xa.TILE} rows",
            ms=device_ms(lambda: xa.causal_attention(q, k, v, valid, H, hd)),
            plain_ms=device_ms(lambda: xa.causal_attention_ref(q, k, v, valid, H, hd)),
            library_ms=device_ms(lambda: sdpa(q, k, v, allowed[:, None], H)),
            **bound(nbytes(q, k, v, valid, out), 4 * D * allowed.sum().item(), "bf16"),
        ))
    # the rollout's frame, and the training step's 80 (8 samples x 10 frames)
    for Bf, H, C in [(1, 1, 48), (1, 1, 3), (4, 2, 24), (TRAIN_BS * 10, 1, 48)]:
        xl, xr = (torch.randn(Bf, 240, 64, H * C, generator=g).to(dev, torch.bfloat16)
                  for _ in range(2))
        att = torch.randn(H, C, generator=g).to(dev, torch.bfloat16)
        out = gf.fused_slot_attention(xl, xr, att, H, C)
        ref = gf.slot_attention_ref(xl, xr, att, H, C)
        torch.cuda.synchronize()
        rows.append(dict(
            kernel="grid_slot_attention", shape=f"({Bf},240,64,{H * C}) H{H} C{C}",
            main_path=(C == 48 and H == 1), rel=rel_err(out, ref),
            max_abs_err=(out.float() - ref.float()).abs().max().item(),
            ms=device_ms(lambda: gf.fused_slot_attention(xl, xr, att, H, C)),
            plain_ms=device_ms(lambda: gf.slot_attention_ref(xl, xr, att, H, C)),
            # per (pixel, channel): 5 slots of add, leaky relu, logit, weight
            library_ms=None, **bound(nbytes(xl, xr, att, out), 35 * xl.numel(), "f32"),
        ))
    for bs, L, n_invalid in [(TRAIN_BS, TRAIN_TOKENS, 0), (TRAIN_BS, TRAIN_TOKENS, 181)]:
        H, hd = 12, 64
        D = H * hd
        # training hands over q/k/v as three separate projection outputs
        q, k, v = ((torch.randn(bs, L, D, generator=g) * 0.5).to(dev, torch.bfloat16)
                   for _ in range(3))
        dout = torch.randn(bs, L, D, generator=g).to(dev, torch.bfloat16)
        valid = (torch.arange(L)[None] >= n_invalid).expand(bs, L).int().contiguous().to(dev)
        out, lse = fa.flash_forward(q, k, v, valid, H, hd)
        ref_out, ref_lse = fa.flash_forward_ref(q, k, v, valid, H, hd)
        fwd_again, twin_fwd_again = (fa.flash_forward(q, k, v, valid, H, hd),
                                     fa.flash_forward_ref(q, k, v, valid, H, hd))
        dq, dk, dv = fa.flash_backward(q, k, v, valid, out, lse, dout, H, hd)
        rq, rk, rv = fa.flash_backward_ref(q, k, v, valid, out, lse, dout, H, hd)
        again = fa.flash_backward(q, k, v, valid, out, lse, dout, H, hd)
        twin_again = fa.flash_backward_ref(q, k, v, valid, out, lse, dout, H, hd)
        torch.cuda.synchronize()
        delta = fa.row_delta(out, dout, H, hd)
        shape = f"({bs},{L},{D}) H{H} hd{hd} invalid{n_invalid}"
        plain_bwd = device_ms(lambda: fa.flash_backward_ref(q, k, v, valid, out, lse, dout, H, hd))
        allowed = _allowed_causal(valid)[:, None]
        pairs = allowed.sum().item()
        lib_bwd, backend = sdpa_backward_ms(q, k, v, allowed, dout, H)
        rows.append(dict(
            kernel="flash_attention_fwd", shape=shape, main_path=(n_invalid == 0),
            rel=rel_err(out, ref_out), max_abs_err=(out.float() - ref_out.float()).abs().max().item(),
            lse_max_abs_err=(lse - ref_lse).abs().max().item(),
            deterministic=bool(torch.equal(fwd_again[0], out) and torch.equal(fwd_again[1], lse)),
            twin_deterministic=bool(torch.equal(twin_fwd_again[0], ref_out)
                                    and torch.equal(twin_fwd_again[1], ref_lse)),
            geometry=f"{H} heads x {bs} batch x {len(fa.query_tiles(L))} query tiles of "
                     f"{fa.TILE} rows",
            ms=device_ms(lambda: fa.flash_forward(q, k, v, valid, H, hd)),
            plain_ms=device_ms(lambda: fa.flash_forward_ref(q, k, v, valid, H, hd)),
            library_ms=device_ms(lambda: sdpa(q, k, v, allowed, H)),
            **bound(nbytes(q, k, v, valid, out, lse), 4 * D * pairs, "bf16"),
        ))
        rows.append(dict(
            kernel="flash_attention_dq", shape=shape, main_path=(n_invalid == 0),
            rel=rel_err(dq, rq), max_abs_err=(dq.float() - rq.float()).abs().max().item(),
            deterministic=bool(torch.equal(again[0], dq)),
            twin_deterministic=bool(torch.equal(twin_again[0], rq)),
            geometry=f"{H} heads x {bs} batch x {len(fa.query_tiles(L))} query tiles of "
                     f"{fa.TILE} rows",
            ms=device_ms(lambda: fa.flash_dq(q, k, v, dout, lse, delta, valid, H, hd)),
            plain_ms=plain_bwd, library_ms=lib_bwd, library_backend=backend,
            **bound(nbytes(q, k, v, dout, lse, delta, valid, dq), 6 * D * pairs, "bf16"),
        ))
        rows.append(dict(
            kernel="flash_attention_dkv", shape=shape, main_path=(n_invalid == 0),
            rel=max(rel_err(dk, rk), rel_err(dv, rv)),
            max_abs_err=max((dk.float() - rk.float()).abs().max().item(),
                            (dv.float() - rv.float()).abs().max().item()),
            deterministic=bool(torch.equal(again[1], dk) and torch.equal(again[2], dv)),
            twin_deterministic=bool(torch.equal(twin_again[1], rk)
                                    and torch.equal(twin_again[2], rv)),
            geometry=f"{H} heads x {bs} batch x {len(fa.key_tiles(L))} key tiles of "
                     f"{fa.TILE} rows",
            ms=device_ms(lambda: fa.flash_dkv(q, k, v, dout, lse, delta, valid, H, hd)),
            plain_ms=plain_bwd, library_ms=lib_bwd, library_backend=backend,
            **bound(nbytes(q, k, v, dout, lse, delta, valid, dk, dv), 8 * D * pairs, "bf16"),
        ))
        pair_ms = rows[-2]["ms"] + rows[-1]["ms"]
        print(f"[kernels] flash backward {shape}: dq {rows[-2]['ms']:.4f} + dk/dv "
              f"{rows[-1]['ms']:.4f} = {pair_ms:.4f} ms against one SDPA backward {lib_bwd:.4f} "
              f"ms ({backend}; device time) and the plain backward {plain_bwd:.4f} ms: "
              f"{pair_ms / lib_bwd:.2f}x the library")
    for Bf, H, C in [(TRAIN_BS * 10, 1, 48), (TRAIN_BS * 10, 1, 3)]:
        xl, xr, gout = (torch.randn(Bf, 240, 64, H * C, generator=g).to(dev, torch.bfloat16)
                        for _ in range(3))
        att = torch.randn(H, C, generator=g).to(dev, torch.bfloat16)
        got = gf.slot_attention_bwd(xl, xr, att, gout, H, C)
        want = gf.slot_attention_bwd_ref(xl, xr, att, gout, H, C)
        again = gf.slot_attention_bwd(xl, xr, att, gout, H, C)
        twin_again = gf.slot_attention_bwd_ref(xl, xr, att, gout, H, C)
        torch.cuda.synchronize()
        ytile, stages, group = gf.bwd_plan(64, H, C, xl.element_size())
        n_blocks = gf.bwd_blocks(Bf, 240, 64, ytile)
        rows.append(dict(
            kernel="grid_slot_attention_bwd", shape=f"({Bf},240,64,{H * C}) H{H} C{C}",
            main_path=(C == 48), rel=max(rel_err(a, b) for a, b in zip(got, want)),
            max_abs_err=max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want)),
            deterministic=all(torch.equal(a, b) for a, b in zip(again, got)),
            twin_deterministic=all(torch.equal(a, b) for a, b in zip(twin_again, want)),
            geometry=f"{n_blocks} blocks ({Bf} frames x {len(gf.strips(240))} strips of "
                     f"{gf.STRIP} rows x {-(-64 // ytile)} column tiles of {ytile}), a ring of "
                     f"{stages} row units, {gf.bwd_threads(ytile, H, C)} threads ({group} a "
                     "(pixel, head)); then datt: "
                     f"{H * C} blocks of {gf.DATT_THREADS} threads (2 launches a call)",
            ms=device_ms(lambda: gf.slot_attention_bwd(xl, xr, att, gout, H, C)),
            plain_ms=device_ms(lambda: gf.slot_attention_bwd_ref(xl, xr, att, gout, H, C)),
            library_ms=None,  # twice the forward's work per (pixel, channel)
            **bound(nbytes(xl, xr, att, gout, *got), 70 * xl.numel(), "f32"),
        ))
    for state in ("wrapped", "first", "prefill"):
        q, cache, key_pos, q0, li = _slab_case(dev, state, g)
        out = da.slab_decode(q, cache["k"], cache["v"], key_pos, q0, li, 64)
        ref = da.slab_decode_ref(q, cache["k"], cache["v"], key_pos, q0, li, 64)
        again = da.slab_decode(q, cache["k"], cache["v"], key_pos, q0, li, 64)
        twin_again = da.slab_decode_ref(q, cache["k"], cache["v"], key_pos, q0, li, 64)
        P, D = q.shape[1:]
        tot = cache["k"].shape[2] * cache["k"].shape[3]
        n_splits, split_keys = da.split_plan(tot, D // 64, -(-P // da.QUERY_TILE), 1,
                                             _build.sm_count(q.device))
        allowed = key_pos[0, :tot][None] <= q0 + torch.arange(P, device=dev)[:, None]
        n_visible = allowed.any(0).sum().item()  # keys some query may see
        k_l, v_l = (cache[n][li].reshape(1, tot, D) for n in ("k", "v"))
        torch.cuda.synchronize()
        rows.append(dict(
            kernel="slab_decode_attention",
            shape=f"{state}: q {tuple(q.shape)}, cache {tuple(cache['k'].shape)} layer {li}",
            main_path=True, rel=rel_err(out, ref),
            max_abs_err=(out.float() - ref.float()).abs().max().item(),
            finite=bool(torch.isfinite(out).all()),
            deterministic=bool(torch.equal(again, out)),
            twin_deterministic=bool(torch.equal(twin_again, ref)),
            geometry=f"{n_splits} key splits of {split_keys} keys x {D // 64} heads x "
                     f"{-(-P // da.QUERY_TILE)} query tile = {n_splits * D // 64} blocks",
            ms=device_ms(lambda: da.slab_decode(q, cache["k"], cache["v"], key_pos, q0, li, 64)),
            plain_ms=device_ms(
                lambda: da.slab_decode_ref(q, cache["k"], cache["v"], key_pos, q0, li, 64)),
            library_ms=device_ms(lambda: sdpa(q, k_l, v_l, allowed[None, None], 12)),
            **bound(nbytes(q, out, key_pos[0, :tot]) + 2 * n_visible * D * 2,
                    4 * D * allowed.sum().item(), "bf16"),
        ))
    for mode, M, K, N, has_bias, main in QMM_CASES:
        qp = quant.quantize_weight(torch.randn(N, K, generator=g) * 0.02)
        q, scale = qp["q"].to(dev), qp["scale"].to(dev)
        x = torch.randn(M, K, generator=g).to(dev, torch.bfloat16)
        b = (torch.randn(N, generator=g) * 0.1).to(dev) if has_bias else None
        out = qmm.int8_matmul(x, q, scale, b, mode)
        ref = qmm.int8_matmul_ref(x, q, scale, b, mode)
        # the launch plan, and a repeat bit for bit
        extra = dict(
            deterministic=bool(torch.equal(qmm.int8_matmul(x, q, scale, b, mode), out)),
            twin_deterministic=bool(torch.equal(qmm.int8_matmul_ref(x, q, scale, b, mode), ref)))
        if mode == "w8a16":
            tile, k_split = qmm.plan(M, K, N, _build.sm_count(x.device))
            w_tiles = -(-N // qmm.W16_ROWS)
            extra["geometry"] = (f"{w_tiles} weight-row tiles of {qmm.W16_ROWS} x "
                                 f"{-(-M // tile)} token tiles of {tile} x K split {k_split} = "
                                 f"{w_tiles * -(-M // tile) * k_split} blocks")
        else:
            n_tile, k_split = qmm.w8a8_plan(M, K, N, _build.sm_count(x.device))
            extra["geometry"] = (f"{-(-N // n_tile)} column tiles of {n_tile} x "
                                 f"{-(-M // qmm.W8_ROWS)} token tiles of {qmm.W8_ROWS} x K split "
                                 f"{k_split} = {-(-N // n_tile) * -(-M // qmm.W8_ROWS) * k_split} "
                                 "blocks")
        if mode == "w8a8":  # the yardstick: the int32 product of the quantised operands
            xq, qt = qmm.quantize_act(x)[0], q.t().contiguous()
            library = lambda: torch._int_mm(xq, qt)  # noqa: E731
        else:  # bf16 F.linear on the weight already dequantised
            w = quant.dequantize_weight(q, scale, torch.bfloat16)
            b16 = b.to(torch.bfloat16) if has_bias else None
            library = lambda: F.linear(x, w, b16)  # noqa: E731
        torch.cuda.synchronize()
        rows.append(dict(
            kernel=f"quant_matmul_{mode}",
            shape=f"M {M} K {K} N {N} {'bias' if has_bias else 'no bias'}", main_path=main,
            rel=rel_err(out, ref), max_abs_err=(out.float() - ref.float()).abs().max().item(),
            finite=bool(torch.isfinite(out).all()),
            exact=bool(torch.equal(out, ref)) if mode == "w8a8" else None, **extra,
            ms=device_ms(lambda: qmm.int8_matmul(x, q, scale, b, mode)),
            plain_ms=device_ms(lambda: qmm.int8_matmul_ref(x, q, scale, b, mode)),
            library_ms=device_ms(library),
            **bound(nbytes(x, q, scale, b, out), 2 * M * N * K,
                    "int8" if mode == "w8a8" else "bf16"),
        ))
    rows += _indexed_linear_rows(dev, g) + _short_attention_rows(dev, g)
    rows += _segment_rows(dev, g)
    for r in rows:
        ok = (r["rel"] <= r.get("rel_tol", REL_TOL) and r.get("finite", True)
              and r.get("lse_max_abs_err", 0.0) <= LSE_TOL
              and r.get("exact") is not False and r.get("deterministic") is not False)
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        notes = "" if r.get("exact") is None else \
            f", equal to {r.get('exact_to', 'the twin')} {r['exact']}"
        if r.get("deterministic") is not None:
            notes += (f", repeat bit-equal {r['deterministic']} (twin "
                      f"{r['twin_deterministic']})")
        if r.get("lse_max_abs_err") is not None:
            notes += f", lse max_abs {r['lse_max_abs_err']:.3e} (bound {LSE_TOL})"
        if r.get("geometry"):
            notes += f", launch: {r['geometry']}"
        print(f"[kernels] {r['kernel']} {r['shape']}: rel {r['rel']:.3e} "
              f"max_abs {r['max_abs_err']:.3e}{notes} "
              f"{'ok' if ok else 'FAIL'}; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}) (device time per "
              "call, median of 25 graph replays of 10 calls; the plain and library times of dq "
              "and dk/dv are the whole backward's)")
        if not ok:
            failures.append(f"kernel {r['kernel']} {r['shape']} rel {r['rel']} "
                            f"lse {r.get('lse_max_abs_err')} exact {r.get('exact')} "
                            f"deterministic {r.get('deterministic')}")
    return rows


# (M, K, N) of the stacked streaming step's linears (fluid/llama-125m, q/k/v
# packed): qkv, o, gate and up, down at the decode's 60 rows, and the
# prefill's 61 (the sinks and no frame, 61 tokens)
INDEXED_CASES = [(60, 768, 2304), (60, 768, 768), (60, 768, 2048), (60, 2048, 768),
                 (61, 768, 2304), (61, 768, 768), (61, 768, 2048), (61, 2048, 768)]


def _indexed_linear_rows(dev, g: torch.Generator) -> list[dict]:
    """The indexed linear against its twin at the stacked streaming step's
    shapes, at the first and the last of 12 layers; the library call is
    ``F.linear`` on the host-indexed view ``w[li]`` (cuBLAS, no copy)."""
    import torch.nn.functional as F

    from fluid_llm_tpu_torch.ops import _build
    from fluid_llm_tpu_torch.ops import indexed_linear as il

    rows, index = [], torch.arange(12, dtype=torch.int32, device=dev)
    weights = {}
    for M, K, N in INDEXED_CASES:
        if (K, N) not in weights:
            weights[K, N] = (torch.randn(12, N, K, generator=g) * 0.02).to(dev, torch.bfloat16)
        w = weights[K, N]
        x = torch.randn(M, K, generator=g).to(dev, torch.bfloat16)
        block_n, k_split = il.plan(M, K, N, _build.sm_count(x.device))
        for li in (0, 11):
            out = il.indexed_linear(x, w, None, index[li])
            ref = il.indexed_linear_ref(x, w, None, index[li])
            again = il.indexed_linear(x, w, None, index[li])
            twin_again = il.indexed_linear_ref(x, w, None, index[li])
            wl = w[li]
            torch.cuda.synchronize()
            rows.append(dict(
                kernel="indexed_linear", shape=f"M {M} K {K} N {N}, layer {li} of 12",
                main_path=True, rel=rel_err(out, ref),
                max_abs_err=(out.float() - ref.float()).abs().max().item(),
                finite=bool(torch.isfinite(out).all()),
                deterministic=bool(torch.equal(again, out)),
                twin_deterministic=bool(torch.equal(twin_again, ref)),
                geometry=f"{-(-M // il.ROW_TILE)} row x {N // block_n} column tiles of "
                         f"{block_n} x K split {k_split} (clusters of {k_split}) = "
                         f"{-(-M // il.ROW_TILE) * N // block_n * k_split} blocks",
                ms=device_ms(lambda: il.indexed_linear(x, w, None, index[li])),
                plain_ms=device_ms(lambda: il.indexed_linear_ref(x, w, None, index[li])),
                library_ms=device_ms(lambda: F.linear(x, wl)),
                **bound(nbytes(x, wl, out), 2 * M * N * K, "bf16"),
            ))
    return rows


def _indexed_linear_plans(dev, failures: list) -> list[dict]:
    """Every plan of the indexed linear (column tile, K split) at the
    stacked streaming step's four (M 60) shapes, layer 5 of 12: agreement
    with the twin (each plan sums K in its own order) and device time, the
    plan ``indexed_linear.plan`` takes marked, beside ``F.linear``."""
    import torch.nn.functional as F

    from fluid_llm_tpu_torch.ops import _build
    from fluid_llm_tpu_torch.ops import indexed_linear as il

    g = torch.Generator().manual_seed(7)
    index = torch.arange(12, dtype=torch.int32, device=dev)[5]
    sms = _build.sm_count(dev)
    res = []
    for M, K, N in INDEXED_CASES[:4]:
        w = (torch.randn(12, N, K, generator=g) * 0.02).to(dev, torch.bfloat16)
        x = torch.randn(M, K, generator=g).to(dev, torch.bfloat16)
        ref = il.indexed_linear_ref(x, w, None, index)
        chosen = il.plan(M, K, N, sms)
        timed = []
        for blocks, block_n, k_split in il.plans(M, K, N):
            if blocks > 2 * sms:
                continue
            with mock.patch.object(il, "plan", lambda *a, p=(block_n, k_split): p):
                out = il.indexed_linear(x, w, None, index)
                ms = device_ms(lambda: il.indexed_linear(x, w, None, index))
            torch.cuda.synchronize()
            rel = rel_err(out, ref)
            timed.append(dict(block_n=block_n, k_split=k_split, blocks=blocks, ms=ms, rel=rel,
                              chosen=(block_n, k_split) == chosen))
            if not rel <= REL_TOL:
                failures.append(f"indexed_linear plan ({block_n}, {k_split}) at M {M} K {K} "
                                f"N {N}: rel {rel}")
        library = device_ms(lambda: F.linear(x, w[5]))
        timed.sort(key=lambda r: r["ms"])
        print(f"[plans] indexed_linear M {M} K {K} N {N}: F.linear {library:.4f} ms; "
              + "; ".join(f"({r['block_n']}, {r['k_split']}) {r['blocks']} blocks "
                          f"{r['ms']:.4f}{' (plan)' if r['chosen'] else ''}" for r in timed)
              + f"; max rel {max(r['rel'] for r in timed):.1e}")
        res.append(dict(M=M, K=K, N=N, library_ms=library, plans=timed))
    return res


# (M, K, N) of the w8a16 kernel's main path (OPT-125m's exact rollout, with
# bias): q/k/v/o, fc1, fc2 at 661 rows and the sliced last block's 60
W8A16_SHAPES = [(661, 768, 768), (661, 768, 3072), (661, 3072, 768),
                (60, 768, 768), (60, 768, 3072), (60, 3072, 768)]


def _w8a16_plans(dev, failures: list) -> list[dict]:
    """Every plan of the w8a16 kernel (token tile, K split; up to four
    blocks an SM) at its main path's six shapes, with bias: agreement with
    the twin and device time, ``quant_matmul.plan``'s choice marked,
    beside bf16 ``F.linear`` on the dequantised weight."""
    import torch.nn.functional as F

    from fluid_llm_tpu_torch.ops import _build
    from fluid_llm_tpu_torch.ops import quant
    from fluid_llm_tpu_torch.ops import quant_matmul as qmm

    g = torch.Generator().manual_seed(8)
    sms = _build.sm_count(dev)
    res = []
    for M, K, N in W8A16_SHAPES:
        qp = quant.quantize_weight(torch.randn(N, K, generator=g) * 0.02)
        q, scale = qp["q"].to(dev), qp["scale"].to(dev)
        x = torch.randn(M, K, generator=g).to(dev, torch.bfloat16)
        b = (torch.randn(N, generator=g) * 0.1).to(dev)
        ref = qmm.int8_matmul_ref(x, q, scale, b, "w8a16")
        chosen = qmm.plan(M, K, N, sms)
        timed = []
        for blocks, *p in qmm.plans(M, K, N):
            if blocks > 4 * sms:
                continue
            with mock.patch.object(qmm, "plan", lambda *a, p=tuple(p): p):
                out = qmm.qmm_w8a16(x, q, scale, b)
                ms = device_ms(lambda: qmm.qmm_w8a16(x, q, scale, b))
            torch.cuda.synchronize()
            rel = rel_err(out, ref)
            timed.append(dict(plan=tuple(p), blocks=blocks, ms=ms, rel=rel,
                              chosen=tuple(p) == chosen))
            if not rel <= REL_TOL:
                failures.append(f"w8a16 plan {tuple(p)} at M {M} K {K} N {N}: rel {rel}")
        w, b16 = quant.dequantize_weight(q, scale, torch.bfloat16), b.to(torch.bfloat16)
        library = device_ms(lambda: F.linear(x, w, b16))
        timed.sort(key=lambda r: r["ms"])
        print(f"[plans] quant_matmul_w8a16 M {M} K {K} N {N}: F.linear {library:.4f} ms; "
              + "; ".join(f"{r['plan']} {r['blocks']} blocks "
                          f"{r['ms']:.4f}{' (plan)' if r['chosen'] else ''}" for r in timed)
              + f"; max rel {max(r['rel'] for r in timed):.1e}")
        res.append(dict(M=M, K=K, N=N, library_ms=library, plans=timed))
    return res


# (M, K, N, bias) of phase 3's w8a8 rows (QMM_CASES): the flagship's
# bias-free linears at 60 and 61 rows, OPT-125m's biased ones at 661
W8A8_SHAPES = [case[1:5] for case in QMM_CASES if case[0] == "w8a8"]


def _w8a8_plans(dev, failures: list) -> list[dict]:
    """Every plan of the w8a8 kernel (column tile, K split; up to four blocks
    an SM) at phase 3's nine shapes: equal to the twin bit for bit (the
    int32 sums and the row maxima are exact in any order) and device time,
    ``quant_matmul.w8a8_plan``'s choice marked, beside ``torch._int_mm``
    on the quantised operands and w8a16's plan at the same shape."""
    from fluid_llm_tpu_torch.ops import _build
    from fluid_llm_tpu_torch.ops import quant
    from fluid_llm_tpu_torch.ops import quant_matmul as qmm

    g = torch.Generator().manual_seed(10)
    sms = _build.sm_count(dev)
    res = []
    for M, K, N, has_bias in W8A8_SHAPES:
        qp = quant.quantize_weight(torch.randn(N, K, generator=g) * 0.02)
        q, scale = qp["q"].to(dev), qp["scale"].to(dev)
        x = torch.randn(M, K, generator=g).to(dev, torch.bfloat16)
        b = (torch.randn(N, generator=g) * 0.1).to(dev) if has_bias else None
        ref = qmm.int8_matmul_ref(x, q, scale, b, "w8a8")
        chosen = qmm.w8a8_plan(M, K, N, sms)
        timed = []
        for blocks, *p in qmm.w8a8_plans(M, K, N):
            if blocks > 4 * sms:
                continue
            with mock.patch.object(qmm, "w8a8_plan", lambda *a, p=tuple(p): p):
                out = qmm.qmm_w8a8(x, q, scale, b)
                ms = device_ms(lambda: qmm.qmm_w8a8(x, q, scale, b))
            torch.cuda.synchronize()
            exact = bool(torch.equal(out, ref))
            timed.append(dict(plan=tuple(p), blocks=blocks, ms=ms, exact=exact,
                              chosen=tuple(p) == chosen))
            if not exact:
                failures.append(f"w8a8 plan {tuple(p)} at M {M} K {K} N {N}: not equal to "
                                "the twin")
        xq, qt = qmm.quantize_act(x)[0], q.t().contiguous()
        library = device_ms(lambda: torch._int_mm(xq, qt))
        w8a16 = device_ms(lambda: qmm.qmm_w8a16(x, q, scale, b))
        timed.sort(key=lambda r: r["ms"])
        print(f"[plans] quant_matmul_w8a8 M {M} K {K} N {N}: _int_mm {library:.4f} ms, w8a16 "
              f"{w8a16:.4f} ms; " + "; ".join(f"{r['plan']} {r['blocks']} blocks "
                                           f"{r['ms']:.4f}{' (plan)' if r['chosen'] else ''}"
                                           for r in timed)
              + f"; all equal to the twin {all(r['exact'] for r in timed)}")
        res.append(dict(M=M, K=K, N=N, library_ms=library, w8a16_ms=w8a16, plans=timed))
    return res


def _short_attention_plans(dev, failures: list) -> list[dict]:
    """Both plans of the short-attention kernel (64 or 128 query rows a
    block) at the training step's and the rollout's shapes: agreement with
    the twin over valid rows and device time, ``short_attention.plan``'s
    choice marked."""
    from fluid_llm_tpu_torch.ops import _build
    from fluid_llm_tpu_torch.ops import short_attention as sa

    g = torch.Generator().manual_seed(9)
    H, hd = 12, 64
    D = H * hd
    res = []
    for bs, L, valid in [(TRAIN_BS, TRAIN_TOKENS, None), (1, ROLLOUT_TOKENS, rollout_valid(3))]:
        q, k, v = ((torch.randn(bs, L, D, generator=g) * 0.5).to(dev, torch.bfloat16)
                   for _ in range(3))
        valid = (torch.ones(bs, L, dtype=torch.int32) if valid is None else valid).to(dev)
        keep = valid[0].bool()
        ref = sa.short_attention_ref(q, k, v, valid, H, hd)
        chosen = sa.plan(bs, L, H, hd, _build.sm_count(dev))
        timed = []
        for q_rows in sa.QUERY_ROWS:
            with mock.patch.object(sa, "plan", lambda *a, p=q_rows: p):
                out = sa.short_attention_fwd(q, k, v, valid, H, hd)
                ms = device_ms(lambda: sa.short_attention_fwd(q, k, v, valid, H, hd))
            torch.cuda.synchronize()
            rel = rel_err(out[:, keep], ref[:, keep])
            blocks = H * bs * len(sa.query_tiles(L, q_rows))
            timed.append(dict(q_rows=q_rows, blocks=blocks, ms=ms, rel=rel,
                              chosen=q_rows == chosen))
            if not rel <= REL_TOL:
                failures.append(f"short attention plan {q_rows} at ({bs}, {L}): rel {rel}")
        timed.sort(key=lambda r: r["ms"])
        print(f"[plans] short_attention ({bs}, {L}, {D}) H{H}: "
              + "; ".join(f"{r['q_rows']} query rows a block, {r['blocks']} blocks "
                          f"{r['ms']:.4f}{' (plan)' if r['chosen'] else ''}" for r in timed)
              + f"; max rel {max(r['rel'] for r in timed):.1e}")
        res.append(dict(bs=bs, L=L, plans=timed))
    return res


def phase_plans(dev, failures: list) -> dict:
    """Every launch plan of the kernels that choose one per shape, timed at
    their main path's shapes: the tables ``indexed_linear.plan``,
    ``quant_matmul.plan``, ``quant_matmul.w8a8_plan`` and
    ``short_attention.plan`` are read from."""
    return dict(indexed_linear=_indexed_linear_plans(dev, failures),
                quant_matmul_w8a16=_w8a16_plans(dev, failures),
                quant_matmul_w8a8=_w8a8_plans(dev, failures),
                short_attention=_short_attention_plans(dev, failures))


def rollout_valid(n_valid_frames: int, frame: int = 60, window: int = 10) -> torch.Tensor:
    """(1, 661) int32 validity of the exact rollout's window with
    ``n_valid_frames`` frames filled: BOS and the see-init frame, then the
    window's invalid frames at the front, then its valid ones."""
    n_invalid = (window - n_valid_frames) * frame
    t = torch.arange(1 + (window + 1) * frame)
    return ((t < 1 + frame) | (t >= 1 + frame + n_invalid)).int()[None]


def _short_attention_rows(dev, g: torch.Generator) -> list[dict]:
    """The short-attention kernel against its twin at the training step's
    (8, 601, 768), every token valid, q/k/v three projection outputs, and
    the rollout's (1, 661, 768) with 7 of 10 window frames invalid, q/k/v
    column slices of one fused projection; the error over valid query rows
    (the forced-diagonal rows are checked finite).  The library call is
    ``scaled_dot_product_attention`` with the same mask."""
    from fluid_llm_tpu_torch.ops import _build
    from fluid_llm_tpu_torch.ops import short_attention as sa

    rows, H, hd = [], 12, 64
    D = H * hd
    for bs, L in [(TRAIN_BS, TRAIN_TOKENS), (1, ROLLOUT_TOKENS)]:
        if L == TRAIN_TOKENS:
            q, k, v = ((torch.randn(bs, L, D, generator=g) * 0.5).to(dev, torch.bfloat16)
                       for _ in range(3))
            valid = torch.ones(bs, L, dtype=torch.int32, device=dev)
        else:
            qkv = (torch.randn(bs, L, 3 * D, generator=g) * 0.5).to(dev, torch.bfloat16)
            q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
            valid = rollout_valid(3).to(dev)
        out = sa.short_attention_fwd(q, k, v, valid, H, hd)
        ref = sa.short_attention_ref(q, k, v, valid, H, hd)
        again = sa.short_attention_fwd(q, k, v, valid, H, hd)
        twin_again = sa.short_attention_ref(q, k, v, valid, H, hd)
        allowed = _allowed_causal(valid)
        keep = valid[0].bool()
        q_rows = sa.plan(bs, L, H, hd, _build.sm_count(q.device))
        torch.cuda.synchronize()
        rows.append(dict(
            kernel="short_attention",
            shape=f"({bs},{L},{D}) H{H} hd{hd}, {int((valid == 0).sum()) // bs} invalid tokens",
            main_path=True, rel=rel_err(out[:, keep], ref[:, keep]),
            max_abs_err=(out[:, keep].float() - ref[:, keep].float()).abs().max().item(),
            finite=bool(torch.isfinite(out).all()),
            deterministic=bool(torch.equal(again, out)),
            twin_deterministic=bool(torch.equal(twin_again, ref)),
            geometry=f"{H} heads x {bs} batch x {len(sa.query_tiles(L, q_rows))} query tiles of "
                     f"{q_rows} rows = {H * bs * len(sa.query_tiles(L, q_rows))} blocks",
            ms=device_ms(lambda: sa.short_attention_fwd(q, k, v, valid, H, hd)),
            plain_ms=device_ms(lambda: sa.short_attention_ref(q, k, v, valid, H, hd)),
            library_ms=device_ms(lambda: sdpa(q, k, v, allowed[:, None], H)),
            **bound(nbytes(q, k, v, valid, out), 4 * D * allowed.sum().item(), "bf16"),
        ))
    return rows


# the EAGLE geometry of the graph baselines (BENCHMARKS.md:676-680): a
# synthetic 84x42 mesh has 3 528 nodes and 20 348 directed edges, collated
# to 3 529 and 20 480; batch 4
EAGLE_MESH, EAGLE_BS, EAGLE_BLOCKS = "84x42", 4, 15
# f32 sums in another order than the twin's atomics (observed: a few 1e-8)
SEGMENT_REL_TOL = 1e-6
# (kernel, edge column, F, on MeshGraphNet's path): MGN sums edge rows into
# the senders (forward) and into the receivers (backward of the receivers
# gather) at F 128 and gathers node rows (F 128) and positions (F 2); GAT
# sums a head's 32 channels and its attention weights (F 1)
SEGMENT_CASES = [
    ("segment_sum", 0, 128, True), ("segment_sum", 1, 128, True),
    ("segment_sum", 0, 32, False), ("segment_sum", 0, 1, False),
    ("segment_gather", 0, 128, True), ("segment_gather", 1, 128, True),
    ("segment_gather", 0, 2, True), ("segment_gather", 0, 1, False),
]


def eagle_edges(dev) -> torch.Tensor:
    """(4, 20480, 2) int32 edge ids of one collated batch at the EAGLE
    geometry, RCM-relabeled as ``baselines_cli`` does."""
    from fluid_llm_tpu_torch.data.eagle_mesh import collate_graphs
    from fluid_llm_tpu_torch.data.reorder import reorder_sample
    from fluid_llm_tpu_torch.data.synthetic import SyntheticGraphDataset

    ds = SyntheticGraphDataset(n_trajectories=EAGLE_BS, mode="train", window_length=2,
                               mesh_nodes=tuple(int(v) for v in EAGLE_MESH.split("x")))
    samples = [reorder_sample(ds[i], "rcm") for i in range(EAGLE_BS)]
    batch = collate_graphs(samples, max(s.mesh_pos.shape[1] for s in samples),
                           max(s.edges.shape[0] for s in samples))
    return torch.from_numpy(batch["edges"][:, 0]).to(dev)


def _segment_rows(dev, g: torch.Generator) -> list[dict]:
    """The segment sum and row gather against their twins at MeshGraphNet's
    and GAT's shapes; the library calls are ``index_add`` and
    ``index_select`` on the same ids (all in range here)."""
    from fluid_llm_tpu_torch.ops import segment_ops as so

    edges = eagle_edges(dev)
    B, E = edges.shape[:2]
    n = int(edges.max()) + 1  # the ghost slot is the last node row
    rows = []
    for kernel, col, F, main in SEGMENT_CASES:
        index = so.SegmentIndex(edges[..., col], n)
        index.csr()
        ids = index.ids.long()
        walk = None
        if kernel == "segment_sum":
            x = torch.randn(B * E, F, generator=g).to(dev)
            zeros = torch.zeros(index.n_rows, F, device=dev)
            fn, twin = (lambda: so.segment_sum(x, index)), (lambda: so.segment_sum_ref(x, index))
            library = lambda: torch.index_add(zeros, 0, ids, x)  # noqa: E731
            n_out, ops = index.n_rows * F, x.numel()
        else:
            x = torch.randn(B * n, F, generator=g).to(dev)
            fn, twin = (lambda: so.segment_gather(x, index)), (lambda: so.gather_ref(x, index))
            library = lambda: torch.index_select(x, 0, ids)  # noqa: E731
            n_out, ops = B * E * F, 0
        out, ref = fn(), twin()
        again, twin_again = fn(), twin()
        torch.cuda.synchronize()
        if kernel == "segment_sum":  # the kernel's order of additions, on the CPU
            walk = so.csr_walk(x.cpu(), so.SegmentIndex(edges[..., col].cpu(), n))
        rows.append(dict(
            kernel=kernel, shape=f"{'edges' if kernel == 'segment_sum' else 'nodes'} "
            f"{tuple(x.shape)} by edges[..., {col}] -> {tuple(out.shape)}", main_path=main,
            rel=rel_err(out, ref), rel_tol=SEGMENT_REL_TOL,
            max_abs_err=(out - ref).abs().max().item(),
            exact=bool(torch.equal(out, ref) if walk is None else torch.equal(out.cpu(), walk)),
            exact_to="the twin" if walk is None else "the CPU CSR walk",
            deterministic=bool(torch.equal(again, out)),
            twin_deterministic=bool(torch.equal(twin_again, ref)),
            ms=device_ms(fn), plain_ms=device_ms(twin), library_ms=device_ms(library),
            **bound(nbytes(x, index.ids) + 4 * n_out, ops, "f32"),
        ))
    return rows


CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "training1.yaml")
FLAGSHIP = os.path.join(os.path.dirname(CONFIG), "flagship_llama.yaml")


def _counters():
    from fluid_llm_tpu_torch.ops import decode_attention as da
    from fluid_llm_tpu_torch.ops import exact_attention as xa
    from fluid_llm_tpu_torch.ops import flash_attention as fa
    from fluid_llm_tpu_torch.ops import grid_gnn_fused as gf
    from fluid_llm_tpu_torch.ops import indexed_linear as il
    from fluid_llm_tpu_torch.ops import quant_matmul as qmm
    from fluid_llm_tpu_torch.ops import segment_ops as so
    from fluid_llm_tpu_torch.ops import short_attention as sa

    return {"exact_attention": xa.causal_attention, "grid_slot_attention": gf.fused_slot_attention,
            "grid_slot_attention_bwd": gf.slot_attention_bwd,
            "flash_attention_fwd": fa.flash_forward, "flash_attention_dq": fa.flash_dq,
            "flash_attention_dkv": fa.flash_dkv, "slab_decode_attention": da.slab_decode,
            "quant_matmul_w8a8": qmm.qmm_w8a8, "quant_matmul_w8a16": qmm.qmm_w8a16,
            "segment_sum": so.segment_sum, "segment_gather": so.segment_gather,
            "indexed_linear": il.indexed_linear, "short_attention": sa.short_attention_fwd}


def reset_launches() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def phase_rollout(dev, seed: int, failures: list, *, streaming: bool, stacked: bool = False,
                  attn_impl: str = "auto", tag: str = "",
                  turns: tuple = (True, False, False, True, True, False)) -> dict:
    """A 251-step rollout of one configuration with seeded random weights on
    ``synthetic:1`` at seq_len 253: the main path through the entry point
    (launch counts), steps/s through the kernels and the twins in ``turns``,
    a 10-step agreement and a device profile.  ``streaming``: the flagship's
    KV-cache rollout; otherwise the OPT-125m exact rollout.  ``stacked``:
    the weights prepared in the stacked-layer layout (``FLUID_SCAN_LAYERS=1``),
    also held against the unrolled layout of the same weights;
    ``attn_impl``: the backbone's (``"short"``: the short-attention kernel)."""
    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch import inference
    from fluid_llm_tpu_torch.data import get_dataset, make_batches
    from fluid_llm_tpu_torch.models.backbone import StackedLayers
    from fluid_llm_tpu_torch.rollout.generate import gen_seq, generate
    from fluid_llm_tpu_torch.rollout.streaming import gen_seq_streaming, generate_streaming

    tag = tag or ("streaming" if streaming else "slice")
    roll, gen = (gen_seq_streaming, generate_streaming) if streaming else (gen_seq, generate)
    cfg = Config.from_yaml(FLAGSHIP if streaming else CONFIG).replace(load_dir="synthetic:1")
    overrides = {} if attn_impl == "auto" else {"attn_impl": attn_impl}
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, {"FLUID_SCAN_LAYERS": "1" if stacked else "0"}):
        model = inference.build_seeded_model(cfg, seed, dev, **overrides)
    if isinstance(model.backbone.layers, StackedLayers) != stacked:
        failures.append(f"{tag}: layers {type(model.backbone.layers).__name__}, stacked {stacked}")
    test_ds = get_dataset(cfg.replace(seq_len=STEPS + 2), mode="test")
    batch = next(make_batches(test_ds, 1, shuffle=False, device=dev))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    bcfg = model.backbone_cfg
    print(f"[{tag}] {cfg.llm_backbone}: {bcfg.n_layers} layers, d {bcfg.d_model}, "
          f"{bcfg.n_heads} heads, {bcfg.norm}, {bcfg.pos} positions, {bcfg.dtype}, attn_impl "
          f"{bcfg.attn_impl}, layers {type(model.backbone.layers).__name__}; "
          f"{cfg.pos_embedding_params.pos_embedding_type} embeddings, absolute time "
          f"{cfg.absolute_time_ids}; window or ring of {model.max_ctx_len} frames; "
          f"set-up {setup_s:.1f} s")

    # the main path, through the entry point a user calls
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    per_step, mean = inference.test_generate(model, test_ds, batch_size=1, pred_steps=STEPS,
                                             streaming=streaming)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    want = dict.fromkeys(launches, 0)  # no gradient: no training kernel runs
    want["grid_slot_attention"] = cfg.decoder_params.gnn_layers * STEPS
    if streaming:  # every layer of every step, and of the prefill
        want["slab_decode_attention"] = bcfg.n_layers * (STEPS + 1)
        if stacked:  # and each of its linears (qkv, o, gate, up, down)
            lys = model.backbone.layers
            want["indexed_linear"] = (len(lys.attn) + len(lys.mlp)) * bcfg.n_layers * (STEPS + 1)
    else:  # layers 0..10; the sliced last block is plain
        attention = "short_attention" if attn_impl == "short" else "exact_attention"
        want[attention] = (bcfg.n_layers - 1) * STEPS
    print(f"[{tag}] test_generate(streaming={streaming}): {STEPS} steps in {wall:.3f} s (incl. "
          f"batch build); mean N-RMSE {mean:.5f}; peak device memory {peak_mib:.1f} MiB; "
          f"launches {launches} (want {want})")
    if launches != want:
        failures.append(f"{tag} launch counts {launches} != {want}")
    if per_step.shape != (STEPS,) or not bool(torch.isfinite(torch.from_numpy(per_step)).all()):
        failures.append(f"{tag} N-RMSE not finite or wrong length")

    # steady-state rate on a prepared batch, kernels and plain twins in turns
    rates = {True: [], False: []}
    want_shape = (1, STEPS + 1, 3, *model.ds_props.out_tot_size)
    for kernels in turns:
        model.kernels = kernels
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, _ = roll(model, batch, STEPS)
        torch.cuda.synchronize()
        rates[kernels].append(STEPS / (time.perf_counter() - t0))
        if tuple(states.shape) != want_shape or not bool(torch.isfinite(states).all()):
            failures.append(f"{tag} states {tuple(states.shape)} (want {want_shape}) or not "
                            f"finite (kernels {kernels})")
    steps_per_s, plain_steps_per_s = (statistics.median(rates[k]) for k in (True, False))
    print(f"[{tag}] {roll.__name__}: {steps_per_s:.2f} steps/s through the kernels (median; "
          f"runs {', '.join(f'{r:.2f}' for r in rates[True])}); plain twins "
          f"{plain_steps_per_s:.2f} (median; runs {', '.join(f'{r:.2f}' for r in rates[False])})")

    states, _, _, bc_mask, position_ids = batch
    out = {}
    for kernels in (True, False):
        model.kernels = kernels
        out[kernels] = gen(model, states[:, :1], bc_mask, position_ids, 10)[1]
    model.kernels = True
    errs = [rel_err(out[True][:, i], out[False][:, i]) for i in range(10)]
    ok = errs[0] <= REL_TOL
    print(f"[{tag} agreement] diffs rel err per step, kernels vs plain twins: "
          f"{', '.join(f'{e:.3e}' for e in errs)} (step 1 {'ok' if ok else 'FAIL'})")
    if not ok:
        failures.append(f"{tag} agreement step 1 rel {errs[0]}")
    # device time of a 20-step rollout against its unprofiled wall time
    n_prof = 20
    busy_ms, n_ops, idle, top = device_profile(
        lambda: gen(model, states[:, :1], bc_mask, position_ids, n_prof), 1,
        n_prof * 1e3 / steps_per_s, f"{tag} 20 steps")

    layout = None
    if stacked:  # the same weights in the unrolled layout, through its own kernels
        unrolled = inference.build_seeded_model(cfg, seed, dev, **overrides)
        ref = gen(unrolled, states[:, :1], bc_mask, position_ids, 10)[1]
        layout_errs = [rel_err(out[True][:, i], ref[:, i]) for i in range(10)]
        ok = layout_errs[0] <= REL_TOL
        print(f"[{tag} agreement] diffs rel err per step, stacked vs unrolled layout: "
              f"{', '.join(f'{e:.3e}' for e in layout_errs)} (step 1 {'ok' if ok else 'FAIL'})")
        if not ok:
            failures.append(f"{tag} stacked vs unrolled step 1 rel {layout_errs[0]}")
        # the layouts' wall time in turns, kernels on: the stacked views' host cost
        rates_by = {"stacked": [], "unrolled": []}
        for name in ("stacked", "unrolled", "unrolled", "stacked"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            roll(model if name == "stacked" else unrolled, batch, STEPS)
            torch.cuda.synchronize()
            rates_by[name].append(STEPS / (time.perf_counter() - t0))
        med = {k: statistics.median(v) for k, v in rates_by.items()}
        print(f"[{tag} layouts] {roll.__name__} in turns: stacked {med['stacked']:.2f} steps/s "
              f"(runs {', '.join(f'{r:.2f}' for r in rates_by['stacked'])}); unrolled "
              f"{med['unrolled']:.2f} (runs {', '.join(f'{r:.2f}' for r in rates_by['unrolled'])})")
        u_busy, u_ops, u_idle, u_top = device_profile(
            lambda: gen(unrolled, states[:, :1], bc_mask, position_ids, n_prof), 1,
            n_prof * 1e3 / med["unrolled"], f"{tag} unrolled layout 20 steps")
        del unrolled
        layout = dict(rel_err=layout_errs, steps_per_s_runs=rates_by, steps_per_s=med,
                      unrolled_profile=dict(steps=n_prof, device_busy_ms=u_busy,
                                            device_ops=u_ops, idle_share=u_idle,
                                            top_device_ms=u_top))
    return dict(setup_s=setup_s, test_generate_s=wall, mean_n_rmse=mean, peak_mem_mib=peak_mib,
                steps_per_s=steps_per_s, steps_per_s_runs=rates[True],
                plain_steps_per_s=plain_steps_per_s, plain_steps_per_s_runs=rates[False],
                launches=launches, agreement_rel_err=errs, layout=layout,
                profile=dict(steps=n_prof, device_busy_ms=busy_ms, device_ops=n_ops,
                             idle_share=idle, top_device_ms=top))


TRAINABLE_PROBES = ("lora.layers.0.attn.q.A", "lora.layers.0.attn.q.B", "lora.layers.0.attn.v.m",
                    "input_emb.patch.mlp.0.weight", "decoder.gnn.convs.0.att",
                    "decoder.gnn.out.att", "bos")


def phase_train(dev, seed: int, failures: list, attn_impl: str = "auto", per_turn: int = 3):
    """Autoreg steps through ``Trainer`` on one repeated batch, in turns
    through the kernels and the twins; the training path's launch counts.
    ``attn_impl="short"``: the backbone's attention forward through the
    short-attention kernel (its backward the twin, recomputed)."""
    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch.data import get_dataset, make_batches
    from fluid_llm_tpu_torch.main import build_model_and_trainer

    tag = "train" if attn_impl == "auto" else f"{attn_impl} train"
    overrides = {} if attn_impl == "auto" else {"attn_impl": attn_impl}
    cfg = Config.from_yaml(CONFIG).replace(load_dir=f"synthetic:{TRAIN_BS}", seed=seed)
    t0 = time.perf_counter()
    train_ds = get_dataset(cfg.replace(seq_len=cfg.autoreg_seq_len), mode="train")
    trainer = build_model_and_trainer(cfg, train_ds.ds_props(), dev, **overrides)
    model = trainer.model
    batch = next(make_batches(train_ds, TRAIN_BS, shuffle=True, seed=0, device=dev))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    params = dict(model.named_parameters())
    n_train = sum(p.numel() for p in params.values() if p.requires_grad)
    n_frozen = sum(p.numel() for p in params.values() if not p.requires_grad)
    bcfg = model.backbone_cfg
    print(f"[{tag}] {cfg.llm_backbone}: {bcfg.n_layers} layers, {bcfg.dtype}, attn_impl "
          f"{bcfg.attn_impl}, DoRA r"
          f"{cfg.lora_config.r} unmerged, dropout {bcfg.dropout}/{cfg.lora_config.lora_dropout}/"
          f"{cfg.pos_embedding_params.input_emb_layer_dropout} (backbone/adapter/embedding); "
          f"batch {tuple(batch[0].shape)}, {TRAIN_TOKENS} tokens; {n_train} trainable, "
          f"{n_frozen} frozen parameters; set-up {setup_s:.1f} s")

    turns = (True, False, False, True)
    step_ms = {True: [], False: []}
    losses, peak_mib = [], 0.0
    reset_launches()  # the training path, driven from here
    for kernels in turns:
        model.kernels = kernels
        torch.cuda.reset_peak_memory_stats()
        for _ in range(per_turn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = trainer.train_step(batch)["loss"].item()
            step_ms[kernels].append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
        if kernels:
            peak_mib = max(peak_mib, torch.cuda.max_memory_allocated() / 2**20)
    launches = read_launches()
    model.kernels = True
    n_kernel_steps = per_turn * turns.count(True)
    convs = cfg.decoder_params.gnn_layers
    per_step = dict.fromkeys(launches, 0)
    per_step.update(grid_slot_attention=convs, grid_slot_attention_bwd=convs)
    if attn_impl == "short":  # the forward only: the backward is the twin
        per_step.update(short_attention=bcfg.n_layers)
    else:
        per_step.update(flash_attention_fwd=bcfg.n_layers, flash_attention_dq=bcfg.n_layers,
                        flash_attention_dkv=bcfg.n_layers)
    want = {k: v * n_kernel_steps for k, v in per_step.items()}
    med_k, med_t = statistics.median(step_ms[True]), statistics.median(step_ms[False])
    print(f"[{tag}] {len(losses)} autoreg steps on one batch (turns kernels/twins "
          f"{'/'.join('k' if t else 't' for t in turns)}, {per_turn} each): loss "
          f"{', '.join(f'{x:.5f}' for x in losses)}")
    print(f"[{tag}] step ms through the kernels: median {med_k:.2f} (runs "
          f"{', '.join(f'{x:.2f}' for x in step_ms[True])}); through the twins: median "
          f"{med_t:.2f} (runs {', '.join(f'{x:.2f}' for x in step_ms[False])}); peak device "
          f"memory over the kernel steps {peak_mib:.1f} MiB")
    print(f"[{tag}] launches over {n_kernel_steps} kernel steps {launches} (want {want}; "
          f"per step {per_step})")
    if launches != want:
        failures.append(f"{tag} launch counts {launches} != {want}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        failures.append(f"{tag} losses not finite or not falling: {losses}")
    no_grad = [n for n in TRAINABLE_PROBES
               if params[n].grad is None or not bool(params[n].grad.abs().sum() > 0)]
    if no_grad or any(p.grad is not None for p in params.values() if not p.requires_grad):
        failures.append(f"trainable parameters without gradient {no_grad}, or frozen with one")
    print(f"[{tag}] non-zero gradient on {', '.join(TRAINABLE_PROBES)}: "
          f"{'ok' if not no_grad else 'FAIL ' + str(no_grad)}")

    # device busy time per kernel step (profiler), against the unprofiled step
    busy_ms, n_ops, idle, top = device_profile(
        lambda: trainer.train_step(batch)["loss"].item(), 2, med_k, tag)
    return trainer, batch, dict(
        setup_s=setup_s, losses=losses, step_ms=step_ms[True], plain_step_ms=step_ms[False],
        median_step_ms=med_k, plain_median_step_ms=med_t, peak_mem_mib=peak_mib,
        launches=launches, launches_per_step=per_step, device_busy_ms=busy_ms,
        device_ops_per_step=n_ops, idle_share=idle, top_device_ms=top,
    )


def device_profile(fn, n: int, wall_ms: float, tag: str, track: tuple[str, ...] = ()):
    """Device busy ms per call of ``fn`` (profiler over ``n`` calls), device
    ops per call, the idle share against the unprofiled ``wall_ms`` per
    call, and the 8 largest device-time entries, then any other entry whose
    name contains one of ``track``; printed under ``tag``, with the host's
    side: the operators' self CPU time and count per call (the rest of the
    wall time is Python between them) and the 5 largest."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3 / n
    n_ops = sum(e.count for e in device) / n
    idle = 1.0 - busy_ms / wall_ms if busy_ms > 0 else None
    ranked = sorted(device, key=lambda e: -e.self_device_time_total)
    ranked = ranked[:8] + [e for e in ranked[8:] if any(t in e.key for t in track)]
    top = [(_short(e.key), e.self_device_time_total / 1e3 / n) for e in ranked]
    host = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU]
    host_ms = sum(e.self_cpu_time_total for e in host) / 1e3 / n
    host_top = sorted(host, key=lambda e: -e.self_cpu_time_total)[:5]
    print(f"[{tag}] device busy {busy_ms:.3f} ms per call in {n_ops:.0f} device ops (profiler, "
          f"{n} calls) of {wall_ms:.3f} ms: idle share "
          f"{'not measured' if idle is None else f'{idle:.3f}'}; top: "
          + "; ".join(f"{k} {t:.3f} ms" for k, t in top))
    print(f"[{tag}] host (profiled): operators' self CPU {host_ms:.3f} ms in "
          f"{sum(e.count for e in host) / n:.0f} operators per call; top: "
          + "; ".join(f"{e.key} {e.self_cpu_time_total / 1e3 / n:.3f} ms ({e.count / n:.0f})"
                      for e in host_top))
    return busy_ms, n_ops, idle, top


def _short(key: str) -> str:
    """A profiler event's name without return type, namespaces or arguments."""
    return re.sub(r"^void |\(anonymous namespace\)::|at::native::", "", key).split("(")[0][:60]


def phase_train_agreement(trainer, batch, seed: int, failures: list,
                          tag: str = "train agreement") -> dict:
    """One step's loss and trainable gradient, kernels vs twins, from the
    same weights, batch and dropout seed (no optimizer step)."""
    model = trainer.model
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    res = {}
    for kernels in (True, False):
        model.kernels = kernels
        model.zero_grad(set_to_none=True)
        trainer.generator.manual_seed(seed)
        loss, _ = trainer.mode_loss(batch, "autoreg")
        loss.backward()
        res[kernels] = (loss.item(), {n: p.grad.detach().float().flatten() for n, p in named})
    model.kernels = True
    model.zero_grad(set_to_none=True)
    (lk, gk), (lt, gt) = res[True], res[False]
    loss_rel = abs(lk - lt) / abs(lt)
    grad_rel = rel_err(torch.cat(list(gk.values())), torch.cat(list(gt.values())))
    groups = {}
    for prefix in ("lora", "input_emb", "decoder", "bos"):
        names = [n for n in gk if n.split(".")[0] == prefix]
        groups[prefix] = rel_err(torch.cat([gk[n] for n in names]), torch.cat([gt[n] for n in names]))
    ok = loss_rel <= REL_TOL and grad_rel <= GRAD_TOL
    print(f"[{tag}] loss {lk:.6f} (kernels) vs {lt:.6f} (twins): rel {loss_rel:.3e} "
          f"(bound {REL_TOL}); trainable gradient rel L2 {grad_rel:.3e} (bound {GRAD_TOL}); by "
          f"group {', '.join(f'{k} {v:.3e}' for k, v in groups.items())} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{tag} loss rel {loss_rel}, gradient rel {grad_rel}")
    return dict(loss_kernels=lk, loss_twins=lt, loss_rel=loss_rel, grad_rel=grad_rel,
                grad_rel_by_group=groups)


def phase_entry_points(dev, seed: int, failures: list, tmp: str) -> dict:
    """``main`` (2 epochs) -> ``continue_train`` (1 epoch) -> ``inference.main
    --checkpoint_dir``, on the card, checkpoints under ``tmp/runs``."""
    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch import continue_train, inference
    from fluid_llm_tpu_torch import main as train_main
    from fluid_llm_tpu_torch.train import checkpoint as ckpt

    res = {}
    os.makedirs(tmp, exist_ok=True)
    runs = os.path.join(tmp, "runs")
    cfg_path = os.path.join(tmp, "training.yaml")
    Config.from_yaml(CONFIG).replace(load_dir=f"synthetic:{TRAIN_BS}", seed=seed, num_epochs=2,
                                     checkpoint_save_path=runs).to_yaml(cfg_path)
    jl = os.path.join(tmp, "metrics.jsonl")
    t0 = time.perf_counter()
    train_main.main(["--config_path", cfg_path, "--device", str(dev), "--metrics_jsonl", jl])
    res["main_s"] = time.perf_counter() - t0
    run = ckpt.get_save_folder(runs, -1)
    res["steps_after_main"] = sorted(d for d in os.listdir(run)
                                     if os.path.isdir(os.path.join(run, d)))
    ckpt.load_config(run).replace(num_epochs=1).to_yaml(os.path.join(run, "config.yaml"))
    t0 = time.perf_counter()
    continue_train.main(["--checkpoint_dir", runs, "--device", str(dev), "--metrics_jsonl", jl])
    res["continue_s"] = time.perf_counter() - t0
    with open(jl) as f:
        logs = [json.loads(line) for line in f]
    t0 = time.perf_counter()
    mean = inference.main(["--checkpoint_dir", runs, "--device", str(dev), "--load_dir",
                           "synthetic:1", "--seq_len", "27", "--pred_steps", "25"])
    res["inference_s"] = time.perf_counter() - t0
    res.update(epochs=[m["epoch"] for m in logs],
               train_loss=[m["train/Autoreg/loss"] for m in logs],
               val_n_rmse=[m.get("val/Gen/N_RMSE") for m in logs], inference_mean_n_rmse=mean)
    # validation runs every 3rd epoch of a run: main's first and continue_train's
    ok = (res["epochs"] == [0, 1, 1] and all(math.isfinite(x) for x in res["train_loss"])
          and [x is not None for x in res["val_n_rmse"]] == [True, False, True]
          and all(math.isfinite(x) for x in res["val_n_rmse"] if x is not None)
          and math.isfinite(mean))
    print(f"[entry points] main 2 epochs in {res['main_s']:.1f} s (checkpoints "
          f"{res['steps_after_main']}), continue_train 1 epoch in {res['continue_s']:.1f} s, "
          f"epochs logged {res['epochs']}, train loss {res['train_loss']}, val N-RMSE "
          f"{res['val_n_rmse']}; inference from the checkpoint, 25 steps in "
          f"{res['inference_s']:.1f} s: mean N-RMSE {mean:.5f} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"entry points: {res}")
    return res


def phase_flagship_entry_points(dev, seed: int, failures: list, tmp: str) -> dict:
    """``main`` trains a copy of the flagship config for 1 epoch
    (checkpoints under ``tmp/runs``); from its checkpoint ``inference.main
    --streaming`` and the exact ``inference.main`` each roll out 25 steps;
    the launches of each run."""
    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch import inference
    from fluid_llm_tpu_torch import main as train_main

    cfg = Config.from_yaml(FLAGSHIP)
    n_layers, convs, n_steps = 12, cfg.decoder_params.gnn_layers, 25
    res = {}
    os.makedirs(tmp, exist_ok=True)
    runs = os.path.join(tmp, "runs")
    cfg_path = os.path.join(tmp, "flagship.yaml")
    cfg.replace(load_dir=f"synthetic:{TRAIN_BS}", seed=seed, num_epochs=1,
                checkpoint_save_path=runs).to_yaml(cfg_path)
    reset_launches()
    t0 = time.perf_counter()
    train_main.main(["--config_path", cfg_path, "--device", str(dev)])
    res["main_s"] = time.perf_counter() - t0
    res["main_launches"] = read_launches()
    for streaming in (True, False):
        reset_launches()
        t0 = time.perf_counter()
        mean = inference.main(["--checkpoint_dir", runs, "--device", str(dev), "--load_dir",
                               "synthetic:1", "--seq_len", str(n_steps + 2), "--pred_steps",
                               str(n_steps)] + (["--streaming"] if streaming else []))
        key = "streaming" if streaming else "exact"
        res[f"{key}_s"], res[f"{key}_n_rmse"] = time.perf_counter() - t0, mean
        res[f"{key}_launches"] = read_launches()
    want_stream = dict.fromkeys(res["streaming_launches"], 0)
    want_stream.update(slab_decode_attention=n_layers * (n_steps + 1),
                       grid_slot_attention=convs * n_steps)
    want_exact = dict.fromkeys(res["exact_launches"], 0)
    want_exact.update(exact_attention=(n_layers - 1) * n_steps, grid_slot_attention=convs * n_steps)
    trained = res["main_launches"]
    ok = (res["streaming_launches"] == want_stream and res["exact_launches"] == want_exact
          and trained["flash_attention_fwd"] > 0 and trained["flash_attention_dkv"] > 0
          and trained["slab_decode_attention"] == 0
          and math.isfinite(res["streaming_n_rmse"]) and math.isfinite(res["exact_n_rmse"]))
    print(f"[flagship entry points] main 1 epoch of flagship_llama.yaml on synthetic:{TRAIN_BS} "
          f"in {res['main_s']:.1f} s, launches {trained}; inference --streaming from its "
          f"checkpoint, {n_steps} steps in {res['streaming_s']:.1f} s: N-RMSE "
          f"{res['streaming_n_rmse']:.5f}, launches {res['streaming_launches']} (want "
          f"{want_stream}); exact inference, {n_steps} steps in {res['exact_s']:.1f} s: N-RMSE "
          f"{res['exact_n_rmse']:.5f}, launches {res['exact_launches']} (want {want_exact}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"flagship entry points: {res}")
    return res


def _client_frames(ds, n: int):
    """The first ``n`` raw grid frames and the mask of test trajectory 0, as
    a client holds them (physical units, the dataset's own grid)."""
    import numpy as np

    from fluid_llm_tpu_torch.core.interp import resample_to_grid

    src = ds.get_trajectory(0)
    grid = resample_to_grid(torch.from_numpy(src.node_states[:n]), torch.from_numpy(src.vert_idx),
                            torch.from_numpy(src.weights), torch.from_numpy(src.mask))
    return grid.numpy(), np.asarray(src.mask, np.uint8)


def _post(base: str, states, mask, pred_steps: int):
    """One ``POST /v1/rollout``: (prediction, response, wall seconds)."""
    import urllib.request

    from fluid_llm_tpu_torch.tools import serve as srv

    body = json.dumps({"states": srv._b64(states), "shape": list(states.shape),
                       "mask": srv._b64(mask), "pred_steps": pred_steps}).encode()
    req = urllib.request.Request(f"{base}/v1/rollout", data=body,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        out = json.load(r)
    wall = time.perf_counter() - t0
    return srv._unb64(out["states"], out["shape"], "float32"), out, wall


def _linear_bytes(backbone) -> int:
    """Bytes of the backbone's stored linear weights (int8 q and f32 scales,
    or the float weights)."""
    from fluid_llm_tpu_torch.ops.quant import QuantLinear

    return sum(nbytes(m.q, m.scale) if isinstance(m, QuantLinear) else nbytes(m.weight)
               for m in backbone.modules() if isinstance(m, (QuantLinear, torch.nn.Linear)))


def phase_serve(dev, failures: list, runs: str) -> dict:
    """The int8 serving daemon on the flagship checkpoint of phase 10, over
    HTTP on 127.0.0.1: launches of one 251-step request, agreement of the
    int8 kernels with their twins, int8 against dense, latency and memory."""
    import threading
    import urllib.request

    import numpy as np

    from fluid_llm_tpu_torch.rollout.streaming import generate_streaming
    from fluid_llm_tpu_torch.tools import serve as srv

    res = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = srv.load_engine(runs, buckets=(50, STEPS), quant="int8", qmm_mode="w8a8",
                          device=str(dev))
    res["load_s"] = time.perf_counter() - t0
    bcfg, model = eng.model.backbone_cfg, eng.model
    httpd = srv.serve(eng, "127.0.0.1", 0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        t0 = time.perf_counter()
        eng.warmup()
        res["warmup_s"] = time.perf_counter() - t0
        grid, mask = _client_frames(eng.dataset, 3)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        pred, out, wall = _post(base, grid[:1], mask, STEPS)
        launches = read_launches()
        res["peak_mem_mib"] = torch.cuda.max_memory_allocated() / 2**20
        lat = [wall]
        for _ in range(2):
            lat.append(_post(base, grid[:1], mask, STEPS)[2])
        pred3, _, wall3 = _post(base, grid, mask, 50)
        with urllib.request.urlopen(f"{base}/v1/stats", timeout=60) as r:
            stats = json.load(r)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join()
    convs = eng.cfg.decoder_params.gnn_layers
    want = dict.fromkeys(launches, 0)
    want.update(quant_matmul_w8a8=7 * bcfg.n_layers * (STEPS + 1),
                slab_decode_attention=bcfg.n_layers * (STEPS + 1),
                grid_slot_attention=convs * STEPS)
    inside = ~mask.astype(bool)
    in_units = abs(pred[0, 0][inside].mean() - grid[0, 0][inside].mean()) < 10 * (
        abs(grid[0, 0][inside].mean()) + 1)
    ok = (launches == want and pred.shape == (STEPS, 3, *grid.shape[-2:])
          and pred3.shape == (50, 3, *grid.shape[-2:]) and bool(np.isfinite(pred).all())
          and bool(np.isfinite(pred3).all()) and in_units and eng.streaming
          and stats["requests"] == 4 and stats["errors"] == 0)
    print(f"[serve] load_engine(quant=int8, w8a8) of {runs}: streaming {eng.streaming}, "
          f"{bcfg.n_layers} layers at d {bcfg.d_model}, loaded in {res['load_s']:.1f} s, warm-up "
          f"(buckets 50 and {STEPS}) {res['warmup_s']:.1f} s; 3 requests of {STEPS} steps in "
          f"{', '.join(f'{x:.3f}' for x in lat)} s ({', '.join(f'{STEPS / x:.2f}' for x in lat)} "
          f"steps/s, over HTTP incl. the response); 50 steps from 3 context frames in "
          f"{wall3:.3f} s; /v1/stats latency {stats.get('latency_ms')}, by program "
          f"{stats['by_program']}; launches over one {STEPS}-step request {launches} (want "
          f"{want}); peak device memory {res['peak_mem_mib']:.1f} MiB; outputs "
          f"{pred.shape} finite and in physical units {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"serve: launches {launches} (want {want}), shapes {pred.shape} "
                        f"{pred3.shape}, in units {in_units}, stats {stats}")

    # kernels against twins on the same int8 weights, 10 steps
    batch = eng.build_batch(grid[:1], mask.astype(bool), 10)
    diffs = {}
    for kernels in (True, False):
        model.kernels = kernels
        diffs[kernels] = generate_streaming(model, *batch, 10)[1]
    model.kernels = True
    errs = [rel_err(diffs[True][:, i], diffs[False][:, i]) for i in range(10)]
    agree = errs[0] <= REL_TOL

    # int8 against dense serving of the same checkpoint: 50-step requests in
    # turns (wall time, then one profiled request each: device time, ops,
    # idle share), and the outputs over 3 steps
    dense = srv.load_engine(runs, buckets=(3, 50), device=str(dev))
    dense.warmup()
    engines = {"int8": eng, "dense": dense}
    walls = {k: [] for k in engines}
    for _ in range(3):
        for k, e in engines.items():
            t0 = time.perf_counter()
            e.request(grid[:1], mask, 50)
            walls[k].append((time.perf_counter() - t0) * 1e3)
    prof = {}
    for k, e in engines.items():
        wall50 = statistics.median(walls[k])
        busy_ms, n_ops, idle, top = device_profile(lambda: e.request(grid[:1], mask, 50), 1,
                                                   wall50, f"serve 50-step request, {k}")
        prof[k] = dict(steps=50, wall_ms=wall50, wall_ms_runs=walls[k], device_busy_ms=busy_ms,
                       device_ops=n_ops, idle_share=idle, top_device_ms=top)
    print(f"[serve] 50-step requests in turns, median wall ms per step: int8 "
          f"{prof['int8']['wall_ms'] / 50:.3f} (runs {', '.join(f'{x:.2f}' for x in walls['int8'])} "
          f"ms), dense {prof['dense']['wall_ms'] / 50:.3f} (runs "
          f"{', '.join(f'{x:.2f}' for x in walls['dense'])} ms); device ops a step int8 "
          f"{prof['int8']['device_ops'] / 50:.1f}, dense {prof['dense']['device_ops'] / 50:.1f}; "
          f"device busy ms a step int8 {prof['int8']['device_busy_ms'] / 50:.4f}, dense "
          f"{prof['dense']['device_busy_ms'] / 50:.4f}")
    quant_pred = eng.predict(grid[:1], mask, 3)
    dense_pred = dense.predict(grid[:1], mask, 3)
    int8_bytes = _linear_bytes(model.backbone)
    dense_bytes = _linear_bytes(dense.model.backbone)
    del eng, model, httpd, dense, engines
    q_vs_d = float(np.abs(quant_pred - dense_pred).mean() / (np.abs(dense_pred).mean() + 1e-6))
    close = q_vs_d < 0.05
    print(f"[serve agreement] diffs rel err per step, int8 kernels vs twins: "
          f"{', '.join(f'{e:.3e}' for e in errs)} (step 1 {'ok' if agree else 'FAIL'}); int8 vs "
          f"dense engines, 3 steps: mean |diff| / mean |dense| {q_vs_d:.4e} (bound 0.05) "
          f"{'ok' if close else 'FAIL'}; backbone linear weights {dense_bytes} bytes dense (bf16) "
          f"vs {int8_bytes} int8 (q + f32 scales)")
    if not agree or not close:
        failures.append(f"serve agreement step 1 {errs[0]}, int8 vs dense {q_vs_d}")
    res.update(launches=launches, request_s=lat, steps_per_s=[STEPS / x for x in lat],
               ctx3_50_steps_s=wall3, stats=stats, agreement_rel_err=errs,
               int8_vs_dense=q_vs_d, weight_bytes_dense=dense_bytes, weight_bytes_int8=int8_bytes,
               profile=prof["int8"], dense_profile=prof["dense"])
    return res


def phase_serve_exact(dev, failures: list, runs: str) -> dict:
    """The daemon's exact rollout with int8 weights in w8a16, on phase 8's
    ``training1.yaml`` checkpoint (OPT-125m, DoRA merged at load): one
    25-step request and its launches; 10 steps kernels vs twins on the same
    int8 weights."""
    import numpy as np

    from fluid_llm_tpu_torch.rollout.generate import generate
    from fluid_llm_tpu_torch.tools import serve as srv

    n_steps = 25
    t0 = time.perf_counter()
    eng = srv.load_engine(runs, buckets=(n_steps,), streaming="off", quant="int8",
                          qmm_mode="w8a16", device=str(dev))
    load_s = time.perf_counter() - t0
    grid, mask = _client_frames(eng.dataset, 1)
    eng.warmup()
    reset_launches()
    t0 = time.perf_counter()
    pred = eng.request(grid, mask, n_steps)
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_layers, convs = eng.model.backbone_cfg.n_layers, eng.cfg.decoder_params.gnn_layers
    want = dict.fromkeys(launches, 0)
    want.update(quant_matmul_w8a16=6 * n_layers * n_steps,
                exact_attention=(n_layers - 1) * n_steps, grid_slot_attention=convs * n_steps)

    # kernels against twins on the same int8 weights, 10 steps
    model = eng.model
    batch = eng.build_batch(grid, mask.astype(bool), 10)
    diffs = {}
    for kernels in (True, False):
        model.kernels = kernels
        diffs[kernels] = generate(model, *batch, 10)[1]
    model.kernels = True
    errs = [rel_err(diffs[True][:, i], diffs[False][:, i]) for i in range(10)]
    # device time a step of the w8a16 rollout against its unprofiled wall time
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate(model, *batch, 10)
    torch.cuda.synchronize()
    wall10 = (time.perf_counter() - t0) * 1e3
    busy_ms, n_ops, idle, top = device_profile(lambda: generate(model, *batch, 10), 1, wall10,
                                               "serve exact 10 steps")
    print(f"[serve exact] device time a step {busy_ms / 10:.3f} ms in {n_ops / 10:.0f} device "
          f"ops (profiler); wall {wall10 / 10:.3f} ms a step; idle share "
          f"{'not measured' if idle is None else f'{idle:.3f}'}")
    ok = (launches == want and not eng.streaming and pred.shape == (n_steps, 3, *grid.shape[-2:])
          and bool(np.isfinite(pred).all()) and errs[0] <= REL_TOL)
    print(f"[serve exact] load_engine(quant=int8, w8a16, streaming off) of {runs}: "
          f"{eng.cfg.llm_backbone}, loaded in {load_s:.1f} s; one {n_steps}-step request in "
          f"{wall:.3f} s ({n_steps / wall:.2f} steps/s); launches {launches} (want {want}); "
          f"output {pred.shape} finite; diffs rel err per step, kernels vs twins: "
          f"{', '.join(f'{e:.3e}' for e in errs)} (step 1 bound {REL_TOL}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"serve exact: launches {launches} (want {want}), shape {pred.shape}, "
                        f"agreement step 1 {errs[0]}")
    return dict(load_s=load_s, request_s=wall, launches=launches, agreement_rel_err=errs,
                profile=dict(steps=10, wall_ms=wall10, device_busy_ms=busy_ms, device_ops=n_ops,
                             idle_share=idle, top_device_ms=top))


# per rollout step of a window: (gathers, sums) forward, and what the
# backward adds (each gather of the blocks' node rows is summed back, each
# sum gathered back; the mesh-position gathers take no gradient)
def graph_launches_per_step(model: str, n_processor: int, n_heads: int):
    P, HP = n_processor, n_heads * n_processor
    if model == "mgn":  # 2 position gathers; senders, receivers, one sum a block
        return (2 + 2 * P, P), (P, 2 * P)
    return (2 + 2 * HP, 2 * HP), (2 * HP, 2 * HP)  # GAT: per head of each block


# One f32 MeshGraphNet step, kernels vs twins: the loss within 1e-5; the
# gradient within 1e-3 rel L2.  The twins' index_add_ adds with atomics in
# another order each run, which moves the forward's last bits and with
# them ReLUs whose pre-activation lies within rounding of 0: two runs of
# the twins themselves differed by up to 1.7e-4 (H100), the kernels and
# the twins by 2.5e-5 - 8.8e-5.  The kernels repeat bit for bit.
GRAPH_LOSS_TOL, GRAPH_GRAD_TOL = 1e-5, 1e-3


def _nonzero(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


def phase_graph_baselines(dev, seed: int, failures: list, tmp: str) -> dict:
    """``baselines_cli.main`` at the EAGLE geometry (synthetic 84x42 mesh,
    batch 4, 15 blocks at width 128): MeshGraphNet for 2 epochs of one
    step on 4 trajectories, validation, the 101-step eval of 4 test
    trajectories, checkpoint and CSV; GAT (4 heads) for 1 epoch.  The
    segment launches of each run must match the count from the code.  Then,
    on one MeshGraphNet batch: the launches of one train step, step ms
    through the kernels and the twins in turns, the device profile, and one
    step's loss and gradient kernels vs twins; the segment sum kernel
    repeated bit for bit on the batch's receivers."""
    from fluid_llm_tpu_torch import baselines_cli as cli
    from fluid_llm_tpu_torch.data.eagle_mesh import iterate_graph_batches
    from fluid_llm_tpu_torch.models.baselines.mgn import mgn_loss
    from fluid_llm_tpu_torch.ops import segment_ops as so

    common = ["--dataset_path", "synthetic", "--mesh_nodes", EAGLE_MESH,
              "--batch_size", str(EAGLE_BS), "--n_processor", str(EAGLE_BLOCKS),
              "--n_traj", "4", "--device", str(dev), "--save_dir", os.path.join(tmp, "baselines")]
    res = {}
    for name, epochs in (("mgn", 2), ("gat", 1)):
        argv = ["--model", name, "--epoch", str(epochs)] + common
        args = cli.parse_args(argv)
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = cli.main(argv)
        wall = time.perf_counter() - t0
        launches = read_launches()
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        fwd, bwd = graph_launches_per_step(name, args.n_processor, args.n_heads)
        train = out["train_steps"] * (args.horizon_train - 1)
        val = math.ceil(args.n_traj / args.batch_size) * args.epoch * (args.horizon_val - 1)
        evals = out["n_test"] * (args.horizon_eval - 1)
        want = dict.fromkeys(launches, 0)
        want.update(segment_gather=train * (fwd[0] + bwd[0]) + (val + evals) * fwd[0],
                    segment_sum=train * (fwd[1] + bwd[1]) + (val + evals) * fwd[1])
        with open(out["csv"]) as f:
            csv_rows = f.read().splitlines()
        n_rmse = out["n_rmse"]
        ok = (launches == want and os.path.exists(out["checkpoint"])
              and len(csv_rows) == args.horizon_eval + 1 and n_rmse.shape == (args.horizon_eval,)
              and bool(torch.isfinite(torch.from_numpy(n_rmse)).all())
              and all(math.isfinite(x) for x in out["val_loss"] + out["train_loss"]))
        eval_rate = out["eval_steps"] / out["eval_s"]
        print(f"[graph baselines] baselines_cli --model {name} --mesh_nodes {EAGLE_MESH} "
              f"--batch_size {EAGLE_BS} --n_processor {EAGLE_BLOCKS} --epoch {epochs} in "
              f"{wall:.1f} s: "
              f"{out['train_steps']} train steps (loss {out['train_loss']}; epochs "
              f"{', '.join(f'{x:.2f}' for x in out['epoch_s'])} s), val loss {out['val_loss']}; "
              f"eval of {out['n_test']} trajectories x {args.horizon_eval - 1} steps at "
              f"{eval_rate:.1f} steps/s, N-RMSE mean {float(n_rmse.mean()):.5f}, CSV "
              f"{len(csv_rows) - 1} rows; peak device memory {peak_mib:.1f} MiB; launches "
              f"{_nonzero(launches)} (want {_nonzero(want)}, every other kernel 0: per "
              f"rollout step forward {fwd}, backward {bwd} (gathers, sums)) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"graph baselines {name}: launches {launches} (want {want}), "
                            f"summary {out}")
        res[name] = dict(wall_s=wall, peak_mem_mib=peak_mib, launches=launches,
                         eval_steps_per_s=eval_rate, mean_n_rmse=float(n_rmse.mean()),
                         **{k: v for k, v in out.items() if k != "n_rmse"})

    # one MeshGraphNet batch: a step's launches, step ms, profile, agreement
    args = cli.parse_args(["--model", "mgn"] + common)
    model, norm = cli.build_model(args, dev)
    ds = cli.build_dataset(args, "train", args.horizon_train)
    batch = cli.to_device(next(iterate_graph_batches(ds, args.batch_size, shuffle=False,
                                                     reorder=cli.ORDER)), dev)
    opt = cli.make_optimizer(model, args.lr)
    noise = torch.Generator(device=dev).manual_seed(seed)

    def step():
        return cli.train_step(args, model, norm, opt, batch, args.lr, noise)[1].item()

    reset_launches()
    step()
    step_launches = read_launches()
    fwd, bwd = graph_launches_per_step("mgn", args.n_processor, args.n_heads)
    n_steps = args.horizon_train - 1
    want = dict.fromkeys(step_launches, 0)
    want.update(segment_gather=n_steps * (fwd[0] + bwd[0]), segment_sum=n_steps * (fwd[1] + bwd[1]))
    step_ms = {True: [], False: []}
    for kernels in (True, False, False, True):
        model.kernels = kernels
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            step_ms[kernels].append((time.perf_counter() - t0) * 1e3)
    model.kernels = True
    med_k, med_t = (statistics.median(step_ms[k]) for k in (True, False))
    print(f"[graph baselines] MeshGraphNet train step (batch {tuple(batch['state'].shape)}, "
          f"edges {tuple(batch['edges'].shape)}): launches {_nonzero(step_launches)} (want "
          f"{_nonzero(want)}, every other kernel 0); step ms through the kernels median "
          f"{med_k:.2f} (runs {', '.join(f'{x:.2f}' for x in step_ms[True])}), through the "
          f"twins median {med_t:.2f} (runs {', '.join(f'{x:.2f}' for x in step_ms[False])})")
    if step_launches != want:
        failures.append(f"graph baselines step launches {step_launches} != {want}")
    busy_ms, n_ops, idle, top = device_profile(step, 2, med_k, "graph baselines train step",
                                               track=("segment_",))

    state = {k: v.clone() for k, v in model.state_dict().items()}
    runs = []
    for kernels in (True, False, True, False):
        model.load_state_dict(state)
        model.kernels = kernels
        model.zero_grad(set_to_none=True)
        noise.manual_seed(seed)
        _, oh, tgt, _ = cli.apply_model(args, model, norm, batch, train=True, generator=noise)
        loss = mgn_loss(oh, tgt, batch["mask"], w_pressure=args.w_pressure)
        loss.backward()
        runs.append((loss.item(), torch.cat([p.grad.flatten() for p in model.parameters()])))
    model.kernels = True
    (lk, gk), (lt, gt), (lk2, gk2), (_, gt2) = runs
    loss_rel, grad_rel = abs(lk - lt) / abs(lt), rel_err(gk, gt)
    step_repeat = lk == lk2 and bool(torch.equal(gk, gk2))
    twin_repeat_rel = rel_err(gt2, gt)  # the twins' atomics add in another order each run
    n = batch["mesh_pos"].shape[2]
    receivers = batch["edges"][:, 0, :, 1]
    index = so.SegmentIndex(receivers, n)
    values = torch.randn(index.ids.shape[0], 128, device=dev, generator=noise)
    sum_repeat = bool(torch.equal(so.segment_sum(values, index), so.segment_sum(values, index)))
    index_ms = event_ms(lambda: so.SegmentIndex(receivers, n).csr())
    ok = loss_rel <= GRAPH_LOSS_TOL and grad_rel <= GRAPH_GRAD_TOL and sum_repeat
    print(f"[graph baselines agreement] one step, kernels vs twins: loss {lk:.7f} vs {lt:.7f} "
          f"(rel {loss_rel:.3e}, bound {GRAPH_LOSS_TOL}), gradient rel L2 {grad_rel:.3e} "
          f"(bound {GRAPH_GRAD_TOL}; the "
          f"twins against themselves {twin_repeat_rel:.3e}); the "
          f"kernels' step repeated bit for bit: {step_repeat}; segment sum on the receivers "
          f"(F 128) repeated bit for bit: {sum_repeat}; one segment index (flatten, stable "
          f"sort, search) {index_ms:.4f} ms {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"graph baselines agreement: loss rel {loss_rel}, gradient rel "
                        f"{grad_rel}, step repeat {step_repeat}, segment sum repeat "
                        f"{sum_repeat}")
    res.update(launches=res["mgn"]["launches"], step_launches=step_launches,
               step_ms=step_ms[True], plain_step_ms=step_ms[False], median_step_ms=med_k,
               plain_median_step_ms=med_t, device_busy_ms=busy_ms, device_ops_per_step=n_ops,
               idle_share=idle, top_device_ms=top, loss_rel=loss_rel, grad_rel=grad_rel,
               twin_repeat_grad_rel=twin_repeat_rel,
               step_repeat_bit_equal=step_repeat, sum_repeat_bit_equal=sum_repeat,
               index_ms=index_ms)
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--out", default=None,
                        help="also write every measurement of the run to this JSON file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing runs on the CPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 matmuls in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    failures: list[str] = []

    def phase(name: str, fn, *a, **kw):
        """``fn``'s result, or None after recording its exception as a
        failure of the phase (the run goes on, and exits 1)."""
        try:
            return fn(*a, **kw)
        except Exception as e:  # noqa: BLE001 -- each phase reports, the run goes on
            traceback.print_exc()
            failures.append(f"phase {name} raised {type(e).__name__}: {e}")
            print(f"[{name}] FAIL: raised {type(e).__name__}: {e}")
            return None

    device = phase("device", phase_device)
    build_s = phase("build", phase_build)
    rows = phase("kernels", phase_kernels, dev, failures) or []
    plans = phase("plans", phase_plans, dev, failures)
    slice_res = phase("slice", phase_rollout, dev, args.seed, failures, streaming=False)
    trained = phase("train", phase_train, dev, args.seed, failures)
    train_res = train_agree = None
    if trained is not None:
        trainer, train_batch, train_res = trained
        train_agree = phase("train agreement", phase_train_agreement, trainer, train_batch,
                            args.seed, failures)
        del trainer, train_batch, trained
    with tempfile.TemporaryDirectory() as tmp:  # phases 8-13: checkpoints, served again
        opt_dir, flagship_dir = os.path.join(tmp, "training1"), os.path.join(tmp, "flagship")
        entry_res = phase("entry points", phase_entry_points, dev, args.seed, failures, opt_dir)
        stream_res = phase("streaming", phase_rollout, dev, args.seed, failures, streaming=True)
        flagship_res = phase("flagship entry points", phase_flagship_entry_points, dev,
                             args.seed, failures, flagship_dir)
        serve_res = phase("serve", phase_serve, dev, failures, os.path.join(flagship_dir, "runs"))
        serve_exact_res = phase("serve exact", phase_serve_exact, dev, failures,
                                os.path.join(opt_dir, "runs"))
        graph_res = phase("graph baselines", phase_graph_baselines, dev, args.seed, failures,
                          tmp)
    stacked_res = phase("stacked streaming", phase_rollout, dev, args.seed, failures,
                        streaming=True, stacked=True, tag="stacked streaming",
                        turns=(True, False, True))
    short_train = short_agree = None
    trained = phase("short train", phase_train, dev, args.seed, failures, attn_impl="short",
                    per_turn=2)
    if trained is not None:
        trainer, train_batch, short_train = trained
        short_agree = phase("short train agreement", phase_train_agreement, trainer, train_batch,
                            args.seed, failures, "short train agreement")
        del trainer, train_batch, trained
    short_res = phase("short rollout", phase_rollout, dev, args.seed, failures, streaming=False,
                      stacked=True, attn_impl="short", tag="short rollout",
                      turns=(True, False, True))

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(device=device, build_s=build_s, kernel_checks=rows, plans=plans,
                           slice=slice_res, train=train_res,
                           train_agreement=train_agree, entry_points=entry_res,
                           streaming=stream_res, flagship_entry_points=flagship_res,
                           serve=serve_res, serve_exact=serve_exact_res,
                           graph_baselines=graph_res, stacked_streaming=stacked_res,
                           short_train=short_train, short_train_agreement=short_agree,
                           short_rollout=short_res, failures=failures),
                      f, indent=1, default=str)
    if failures:
        for failure in failures:
            print(f"chip_smoke FAILED: {failure}")
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1

    # (source, TPU kernel it replaces, the main path whose run counts it)
    sources = {
        "exact_attention": ("fluid_llm_tpu_torch/csrc/exact_attention.cu",
                            "fluid_llm_tpu/ops/exact_attention.py:52", slice_res),
        "grid_slot_attention": ("fluid_llm_tpu_torch/csrc/grid_slot_attention.cu",
                                "fluid_llm_tpu/ops/grid_gnn_pallas.py:122", slice_res),
        "grid_slot_attention_bwd": ("fluid_llm_tpu_torch/csrc/grid_slot_attention.cu",
                                    "fluid_llm_tpu/ops/grid_gnn_pallas.py:161", train_res),
        "flash_attention_fwd": ("fluid_llm_tpu_torch/csrc/exact_attention.cu",
                                "fluid_llm_tpu/ops/flash_attention.py:55", train_res),
        "flash_attention_dq": ("fluid_llm_tpu_torch/csrc/flash_attention.cu",
                               "fluid_llm_tpu/ops/flash_attention.py:190", train_res),
        "flash_attention_dkv": ("fluid_llm_tpu_torch/csrc/flash_attention.cu",
                                "fluid_llm_tpu/ops/flash_attention.py:230", train_res),
        "slab_decode_attention": ("fluid_llm_tpu_torch/csrc/decode_attention.cu",
                                  "fluid_llm_tpu/ops/decode_attention.py:50", stream_res),
        "quant_matmul_w8a8": ("fluid_llm_tpu_torch/csrc/quant_matmul.cu",
                              "fluid_llm_tpu/ops/quant_matmul.py:113", serve_res),
        "quant_matmul_w8a16": ("fluid_llm_tpu_torch/csrc/quant_matmul.cu",
                               "fluid_llm_tpu/ops/quant_matmul.py:91", serve_exact_res),
        "segment_sum": ("fluid_llm_tpu_torch/csrc/segment_ops.cu",
                        "fluid_llm_tpu/ops/segment_sum_pallas.py:123", graph_res),
        "segment_gather": ("fluid_llm_tpu_torch/csrc/segment_ops.cu",
                           "fluid_llm_tpu/ops/segment_sum_pallas.py:142", graph_res),
        "indexed_linear": ("fluid_llm_tpu_torch/csrc/indexed_linear.cu",
                           "fluid_llm_tpu/ops/indexed_linear.py:35", stacked_res),
        "short_attention": ("fluid_llm_tpu_torch/csrc/short_attention.cu",
                            "fluid_llm_tpu/ops/short_attention.py:38", short_res),
    }
    kernels = []
    for name, (source, replaces, path_res) in sources.items():
        main_rows = [r for r in rows if r["kernel"] == name and r["main_path"]]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=path_res["launches"][name],
            max_abs_err=max(r["max_abs_err"] for r in main_rows),
            ms=main_rows[0]["ms"], plain_ms=main_rows[0]["plain_ms"],
            bound_ms=main_rows[0]["bound_ms"], bound_by=main_rows[0]["bound_by"],
            library_ms=main_rows[0]["library_ms"],
        ))
    print(json.dumps({"kernels": kernels}))
    print(device["smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["name"],
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
