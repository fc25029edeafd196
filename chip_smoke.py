"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, roll out, train, stream.

    python3 chip_smoke.py [--seed 1234] [--out results.json]

Phases, each printing one line per result; any failure exits nonzero:

1. device   -- needs CUDA (never continues on the CPU); prints the card's
               name and power limit, nvcc's and torch's versions;
2. build    -- compiles the CUDA kernels from ``fluid_llm_tpu_torch/csrc``;
3. kernels  -- each kernel against its plain PyTorch twin in bf16, at the
               rollout's shapes (exact attention, slot attention), the
               training step's (flash forward, dq, dk/dv at (8, 601, 768);
               slot-attention backward at 80 frames) and the streaming
               step's (slab decode attention over 11 slots of 64 rows,
               H 12: a wrapped ring, the first decode with 9 slots
               unwritten, the 61-token prefill): relative L2 error (bound
               REL_TOL) and device time per call, kernel and plain;
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
               kernel), launches of each shown and checked.

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
import time

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
STEPS = 251
ROLLOUT_TOKENS = 11 * 60 + 1  # 10-frame window + see-init frame, 60 patches each, + BOS
TRAIN_BS = 8
TRAIN_TOKENS = 10 * 60 + 1  # 9 input frames + the see-init duplicate, 60 patches each, + BOS


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def device_ms(fn, inner: int = 10, n: int = 25) -> float:
    """Device time of one call: ``inner`` calls captured in a CUDA graph,
    replayed ``n`` times between CUDA events; the median over ``inner``.
    The graph removes the host's launch gaps, which would otherwise be
    counted for kernels shorter than their launch overhead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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
        m = re.search(r"Compiling entry function '\w*?\d([a-z_]+_kernel)I(\w+?)EE", line)
        if m:
            name = f"{m.group(1)}<{m.group(2)}>"
        elif "spill" in line or "registers" in line:
            print(f"[build] ptxas {name}: {line.split(':', 1)[-1].strip()}")
    return secs


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


def phase_kernels(dev, failures: list) -> list[dict]:
    from fluid_llm_tpu_torch.ops import decode_attention as da
    from fluid_llm_tpu_torch.ops import exact_attention as xa
    from fluid_llm_tpu_torch.ops import flash_attention as fa
    from fluid_llm_tpu_torch.ops import grid_gnn_fused as gf

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
        torch.cuda.synchronize()
        rows.append(dict(
            kernel="exact_attention", shape=f"(1,{L},{D}) H{H} hd{hd} invalid{n_invalid}",
            main_path=(L == ROLLOUT_TOKENS), rel=rel_err(out, ref),
            max_abs_err=(out.float() - ref.float()).abs().max().item(),
            ms=device_ms(lambda: xa.causal_attention(q, k, v, valid, H, hd)),
            plain_ms=device_ms(lambda: xa.causal_attention_ref(q, k, v, valid, H, hd)),
        ))
    for Bf, H, C in [(1, 1, 48), (1, 1, 3), (4, 2, 24)]:
        xl, xr = (torch.randn(Bf, 240, 64, H * C, generator=g).to(dev, torch.bfloat16)
                  for _ in range(2))
        att = torch.randn(H, C, generator=g).to(dev, torch.bfloat16)
        out = gf.fused_slot_attention(xl, xr, att, H, C)
        ref = gf.slot_attention_ref(xl, xr, att, H, C)
        torch.cuda.synchronize()
        rows.append(dict(
            kernel="grid_slot_attention", shape=f"({Bf},240,64,{H * C}) H{H} C{C}",
            main_path=(Bf == 1), rel=rel_err(out, ref),
            max_abs_err=(out.float() - ref.float()).abs().max().item(),
            ms=device_ms(lambda: gf.fused_slot_attention(xl, xr, att, H, C)),
            plain_ms=device_ms(lambda: gf.slot_attention_ref(xl, xr, att, H, C)),
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
        dq, dk, dv = fa.flash_backward(q, k, v, valid, out, lse, dout, H, hd)
        rq, rk, rv = fa.flash_backward_ref(q, k, v, valid, out, lse, dout, H, hd)
        torch.cuda.synchronize()
        delta = (dout.float() * out.float()).reshape(bs, L, H, hd).sum(-1)
        shape = f"({bs},{L},{D}) H{H} hd{hd} invalid{n_invalid}"
        plain_bwd = device_ms(lambda: fa.flash_backward_ref(q, k, v, valid, out, lse, dout, H, hd))
        rows.append(dict(
            kernel="flash_attention_fwd", shape=shape, main_path=(n_invalid == 0),
            rel=rel_err(out, ref_out), max_abs_err=(out.float() - ref_out.float()).abs().max().item(),
            lse_max_abs_err=(lse - ref_lse).abs().max().item(),
            ms=device_ms(lambda: fa.flash_forward(q, k, v, valid, H, hd)),
            plain_ms=device_ms(lambda: fa.flash_forward_ref(q, k, v, valid, H, hd)),
        ))
        rows.append(dict(
            kernel="flash_attention_dq", shape=shape, main_path=(n_invalid == 0),
            rel=rel_err(dq, rq), max_abs_err=(dq.float() - rq.float()).abs().max().item(),
            ms=device_ms(lambda: fa.flash_dq(q, k, v, dout, lse, delta, valid, H, hd)),
            plain_ms=plain_bwd,
        ))
        rows.append(dict(
            kernel="flash_attention_dkv", shape=shape, main_path=(n_invalid == 0),
            rel=max(rel_err(dk, rk), rel_err(dv, rv)),
            max_abs_err=max((dk.float() - rk.float()).abs().max().item(),
                            (dv.float() - rv.float()).abs().max().item()),
            ms=device_ms(lambda: fa.flash_dkv(q, k, v, dout, lse, delta, valid, H, hd)),
            plain_ms=plain_bwd,
        ))
    for Bf, H, C in [(TRAIN_BS * 10, 1, 48), (TRAIN_BS * 10, 1, 3)]:
        xl, xr, gout = (torch.randn(Bf, 240, 64, H * C, generator=g).to(dev, torch.bfloat16)
                        for _ in range(3))
        att = torch.randn(H, C, generator=g).to(dev, torch.bfloat16)
        got = gf.slot_attention_bwd(xl, xr, att, gout, H, C)
        want = gf.slot_attention_bwd_ref(xl, xr, att, gout, H, C)
        torch.cuda.synchronize()
        rows.append(dict(
            kernel="grid_slot_attention_bwd", shape=f"({Bf},240,64,{H * C}) H{H} C{C}",
            main_path=(C == 48), rel=max(rel_err(a, b) for a, b in zip(got, want)),
            max_abs_err=max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want)),
            ms=device_ms(lambda: gf.slot_attention_bwd(xl, xr, att, gout, H, C)),
            plain_ms=device_ms(lambda: gf.slot_attention_bwd_ref(xl, xr, att, gout, H, C)),
        ))
    for state in ("wrapped", "first", "prefill"):
        q, cache, key_pos, q0, li = _slab_case(dev, state, g)
        out = da.slab_decode(q, cache["k"], cache["v"], key_pos, q0, li, 64)
        ref = da.slab_decode_ref(q, cache["k"], cache["v"], key_pos, q0, li, 64)
        torch.cuda.synchronize()
        rows.append(dict(
            kernel="slab_decode_attention",
            shape=f"{state}: q {tuple(q.shape)}, cache {tuple(cache['k'].shape)} layer {li}",
            main_path=True, rel=rel_err(out, ref),
            max_abs_err=(out.float() - ref.float()).abs().max().item(),
            finite=bool(torch.isfinite(out).all()),
            ms=device_ms(lambda: da.slab_decode(q, cache["k"], cache["v"], key_pos, q0, li, 64)),
            plain_ms=device_ms(
                lambda: da.slab_decode_ref(q, cache["k"], cache["v"], key_pos, q0, li, 64)),
        ))
    for r in rows:
        ok = r["rel"] <= REL_TOL and r.get("finite", True)
        print(f"[kernels] {r['kernel']} {r['shape']}: rel {r['rel']:.3e} "
              f"max_abs {r['max_abs_err']:.3e} {'ok' if ok else 'FAIL'}; "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms "
              "(device time per call, median of 25 graph replays of 10 calls; the plain "
              "time of dq and dk/dv is the whole plain backward's)")
        if not ok:
            failures.append(f"kernel {r['kernel']} {r['shape']} rel {r['rel']}")
    return rows


CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "training1.yaml")
FLAGSHIP = os.path.join(os.path.dirname(CONFIG), "flagship_llama.yaml")


def _counters():
    from fluid_llm_tpu_torch.ops import decode_attention as da
    from fluid_llm_tpu_torch.ops import exact_attention as xa
    from fluid_llm_tpu_torch.ops import flash_attention as fa
    from fluid_llm_tpu_torch.ops import grid_gnn_fused as gf

    return {"exact_attention": xa.causal_attention, "grid_slot_attention": gf.fused_slot_attention,
            "grid_slot_attention_bwd": gf.slot_attention_bwd,
            "flash_attention_fwd": fa.flash_forward, "flash_attention_dq": fa.flash_dq,
            "flash_attention_dkv": fa.flash_dkv, "slab_decode_attention": da.slab_decode}


def reset_launches() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def phase_rollout(dev, seed: int, failures: list, *, streaming: bool) -> dict:
    """A 251-step rollout of one configuration with seeded random weights on
    ``synthetic:1`` at seq_len 253: the main path through the entry point
    (launch counts), steps/s through the kernels and the twins in turns, a
    10-step agreement and a device profile.  ``streaming``: the flagship's
    KV-cache rollout; otherwise the OPT-125m exact rollout."""
    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch import inference
    from fluid_llm_tpu_torch.data import get_dataset, make_batches
    from fluid_llm_tpu_torch.rollout.generate import gen_seq, generate
    from fluid_llm_tpu_torch.rollout.streaming import gen_seq_streaming, generate_streaming

    tag = "streaming" if streaming else "slice"
    roll, gen = (gen_seq_streaming, generate_streaming) if streaming else (gen_seq, generate)
    cfg = Config.from_yaml(FLAGSHIP if streaming else CONFIG).replace(load_dir="synthetic:1")
    t0 = time.perf_counter()
    model = inference.build_seeded_model(cfg, seed, dev)
    test_ds = get_dataset(cfg.replace(seq_len=STEPS + 2), mode="test")
    batch = next(make_batches(test_ds, 1, shuffle=False, device=dev))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    bcfg = model.backbone_cfg
    print(f"[{tag}] {cfg.llm_backbone}: {bcfg.n_layers} layers, d {bcfg.d_model}, "
          f"{bcfg.n_heads} heads, {bcfg.norm}, {bcfg.pos} positions, {bcfg.dtype}; "
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
    else:  # layers 0..10; the sliced last block is plain
        want["exact_attention"] = (bcfg.n_layers - 1) * STEPS
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
    for kernels in (True, False, False, True, True, False):
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
    return dict(setup_s=setup_s, test_generate_s=wall, mean_n_rmse=mean, peak_mem_mib=peak_mib,
                steps_per_s=steps_per_s, steps_per_s_runs=rates[True],
                plain_steps_per_s=plain_steps_per_s, plain_steps_per_s_runs=rates[False],
                launches=launches, agreement_rel_err=errs,
                profile=dict(steps=n_prof, device_busy_ms=busy_ms, device_ops=n_ops,
                             idle_share=idle, top_device_ms=top))


TRAINABLE_PROBES = ("lora.layers.0.attn.q.A", "lora.layers.0.attn.q.B", "lora.layers.0.attn.v.m",
                    "input_emb.patch.mlp.0.weight", "decoder.gnn.convs.0.att",
                    "decoder.gnn.out.att", "bos")


def phase_train(dev, seed: int, failures: list):
    """Autoreg steps through ``Trainer`` on one repeated batch, in turns
    through the kernels and the twins; the training path's launch counts."""
    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch.data import get_dataset, make_batches
    from fluid_llm_tpu_torch.main import build_model_and_trainer

    cfg = Config.from_yaml(CONFIG).replace(load_dir=f"synthetic:{TRAIN_BS}", seed=seed)
    t0 = time.perf_counter()
    train_ds = get_dataset(cfg.replace(seq_len=cfg.autoreg_seq_len), mode="train")
    trainer = build_model_and_trainer(cfg, train_ds.ds_props(), dev)
    model = trainer.model
    batch = next(make_batches(train_ds, TRAIN_BS, shuffle=True, seed=0, device=dev))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    params = dict(model.named_parameters())
    n_train = sum(p.numel() for p in params.values() if p.requires_grad)
    n_frozen = sum(p.numel() for p in params.values() if not p.requires_grad)
    bcfg = model.backbone_cfg
    print(f"[train] {cfg.llm_backbone}: {bcfg.n_layers} layers, {bcfg.dtype}, DoRA r"
          f"{cfg.lora_config.r} unmerged, dropout {bcfg.dropout}/{cfg.lora_config.lora_dropout}/"
          f"{cfg.pos_embedding_params.input_emb_layer_dropout} (backbone/adapter/embedding); "
          f"batch {tuple(batch[0].shape)}, {TRAIN_TOKENS} tokens; {n_train} trainable, "
          f"{n_frozen} frozen parameters; set-up {setup_s:.1f} s")

    turns, per_turn = (True, False, False, True), 3
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
    per_step = dict(exact_attention=0, grid_slot_attention=convs, grid_slot_attention_bwd=convs,
                    flash_attention_fwd=bcfg.n_layers, flash_attention_dq=bcfg.n_layers,
                    flash_attention_dkv=bcfg.n_layers, slab_decode_attention=0)
    want = {k: v * n_kernel_steps for k, v in per_step.items()}
    med_k, med_t = statistics.median(step_ms[True]), statistics.median(step_ms[False])
    print(f"[train] {len(losses)} autoreg steps on one batch (turns kernels/twins "
          f"{'/'.join('k' if t else 't' for t in turns)}, {per_turn} each): loss "
          f"{', '.join(f'{x:.5f}' for x in losses)}")
    print(f"[train] step ms through the kernels: median {med_k:.2f} (runs "
          f"{', '.join(f'{x:.2f}' for x in step_ms[True])}); through the twins: median "
          f"{med_t:.2f} (runs {', '.join(f'{x:.2f}' for x in step_ms[False])}); peak device "
          f"memory over the kernel steps {peak_mib:.1f} MiB")
    print(f"[train] launches over {n_kernel_steps} kernel steps {launches} (want {want}; "
          f"per step {per_step})")
    if launches != want:
        failures.append(f"train launch counts {launches} != {want}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        failures.append(f"train losses not finite or not falling: {losses}")
    no_grad = [n for n in TRAINABLE_PROBES
               if params[n].grad is None or not bool(params[n].grad.abs().sum() > 0)]
    if no_grad or any(p.grad is not None for p in params.values() if not p.requires_grad):
        failures.append(f"trainable parameters without gradient {no_grad}, or frozen with one")
    print(f"[train] non-zero gradient on {', '.join(TRAINABLE_PROBES)}: "
          f"{'ok' if not no_grad else 'FAIL ' + str(no_grad)}")

    # device busy time per kernel step (profiler), against the unprofiled step
    busy_ms, n_ops, idle, top = device_profile(
        lambda: trainer.train_step(batch)["loss"].item(), 2, med_k, "train")
    return trainer, batch, dict(
        setup_s=setup_s, losses=losses, step_ms=step_ms[True], plain_step_ms=step_ms[False],
        median_step_ms=med_k, plain_median_step_ms=med_t, peak_mem_mib=peak_mib,
        launches=launches, launches_per_step=per_step, device_busy_ms=busy_ms,
        device_ops_per_step=n_ops, idle_share=idle, top_device_ms=top,
    )


def device_profile(fn, n: int, wall_ms: float, tag: str):
    """Device busy ms per call of ``fn`` (profiler over ``n`` calls), device
    ops per call, the idle share against the unprofiled ``wall_ms`` per
    call, and the 8 largest device-time entries; printed under ``tag``."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3 / n
    n_ops = sum(e.count for e in device) / n
    idle = 1.0 - busy_ms / wall_ms if busy_ms > 0 else None
    top = [(_short(e.key), e.self_device_time_total / 1e3 / n)
           for e in sorted(device, key=lambda e: -e.self_device_time_total)[:8]]
    print(f"[{tag}] device busy {busy_ms:.3f} ms per call in {n_ops:.0f} device ops (profiler, "
          f"{n} calls) of {wall_ms:.3f} ms: idle share "
          f"{'not measured' if idle is None else f'{idle:.3f}'}; top: "
          + "; ".join(f"{k} {t:.3f} ms" for k, t in top))
    return busy_ms, n_ops, idle, top


def _short(key: str) -> str:
    """A profiler event's name without return type, namespaces or arguments."""
    return re.sub(r"^void |\(anonymous namespace\)::|at::native::", "", key).split("(")[0][:60]


def phase_train_agreement(trainer, batch, seed: int, failures: list) -> dict:
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
    print(f"[train agreement] loss {lk:.6f} (kernels) vs {lt:.6f} (twins): rel {loss_rel:.3e} "
          f"(bound {REL_TOL}); trainable gradient rel L2 {grad_rel:.3e} (bound {GRAD_TOL}); by "
          f"group {', '.join(f'{k} {v:.3e}' for k, v in groups.items())} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"train agreement loss rel {loss_rel}, gradient rel {grad_rel}")
    return dict(loss_kernels=lk, loss_twins=lt, loss_rel=loss_rel, grad_rel=grad_rel,
                grad_rel_by_group=groups)


def phase_entry_points(dev, seed: int, failures: list) -> dict:
    """``main`` (2 epochs) -> ``continue_train`` (1 epoch) -> ``inference.main
    --checkpoint_dir``, on the card, checkpoints in a temporary folder."""
    import tempfile

    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch import continue_train, inference
    from fluid_llm_tpu_torch import main as train_main
    from fluid_llm_tpu_torch.train import checkpoint as ckpt

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
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


def phase_flagship_entry_points(dev, seed: int, failures: list) -> dict:
    """``main`` trains a copy of the flagship config for 1 epoch; from its
    checkpoint ``inference.main --streaming`` and the exact ``inference.main``
    each roll out 25 steps; the launches of each run."""
    import tempfile

    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch import inference
    from fluid_llm_tpu_torch import main as train_main

    cfg = Config.from_yaml(FLAGSHIP)
    n_layers, convs, n_steps = 12, cfg.decoder_params.gnn_layers, 25
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
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

    device = phase_device()
    build_s = phase_build()
    rows = phase_kernels(dev, failures)
    slice_res = phase_rollout(dev, args.seed, failures, streaming=False)
    trainer, train_batch, train_res = phase_train(dev, args.seed, failures)
    train_agree = phase_train_agreement(trainer, train_batch, args.seed, failures)
    del trainer, train_batch
    entry_res = phase_entry_points(dev, args.seed, failures)
    stream_res = phase_rollout(dev, args.seed, failures, streaming=True)
    flagship_res = phase_flagship_entry_points(dev, args.seed, failures)

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
    }
    kernels = []
    for name, (source, replaces, path_res) in sources.items():
        main_rows = [r for r in rows if r["kernel"] == name and r["main_path"]]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=path_res["launches"][name],
            max_abs_err=max(r["max_abs_err"] for r in main_rows),
            ms=main_rows[0]["ms"], plain_ms=main_rows[0]["plain_ms"],
        ))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(device=device, build_s=build_s, kernel_checks=rows,
                           slice=slice_res, train=train_res,
                           train_agreement=train_agree, entry_points=entry_res,
                           streaming=stream_res, flagship_entry_points=flagship_res,
                           failures=failures), f, indent=1, default=str)
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(device["smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["name"],
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
