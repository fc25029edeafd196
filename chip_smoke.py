"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, roll out.

    python3 chip_smoke.py [--seed 1234] [--out results.json]

Phases, each printing one line per result; any failure exits nonzero:

1. device   -- needs CUDA (never continues on the CPU); prints the card's
               name and power limit, nvcc's and torch's versions;
2. build    -- compiles the CUDA kernels from ``fluid_llm_tpu_torch/csrc``;
3. kernels  -- each kernel against its plain PyTorch twin at the rollout's
               shapes in bf16: relative L2 error (bound REL_TOL) and the
               median time of >= 20 runs (CUDA events), kernel and plain;
4. slice    -- ``configs/training1.yaml`` (OPT-125m at full width and depth,
               DoRA r16 merged, BOS, see-init, MLPGNN, bf16) with seeded
               random weights on ``synthetic:1`` at seq_len 253, through
               ``inference.test_generate``: 251 rollout steps.  The launch
               counters must read 11x251 (exact attention, layers 0..10)
               and 3x251 (slot attention, 3 GATv2 convs); outputs finite;
               prints mean N-RMSE, wall time, peak device memory and
               rollout steps/s;
5. agreement -- a 10-step rollout through the kernels against the same
               rollout through the plain twins (selected explicitly):
               relative error of the diffs per step, step 1 <= REL_TOL.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
``nvidia-smi`` name and power limit; before that one JSON line of kernel
results.
"""

from __future__ import annotations

import argparse
import json
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
STEPS = 251
ROLLOUT_TOKENS = 11 * 60 + 1  # 10-frame window + see-init frame, 60 patches each, + BOS


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


def phase_kernels(dev, failures: list) -> list[dict]:
    from fluid_llm_tpu_torch.ops import exact_attention as xa
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
    for r in rows:
        ok = r["rel"] <= REL_TOL
        print(f"[kernels] {r['kernel']} {r['shape']}: rel {r['rel']:.3e} "
              f"max_abs {r['max_abs_err']:.3e} {'ok' if ok else 'FAIL'}; "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms "
              "(device time per call, median of 25 graph replays of 10 calls)")
        if not ok:
            failures.append(f"kernel {r['kernel']} {r['shape']} rel {r['rel']}")
    return rows


def phase_slice(dev, seed: int, failures: list):
    from fluid_llm_tpu.config import Config
    from fluid_llm_tpu_torch import inference
    from fluid_llm_tpu_torch.data import get_dataset, make_batches
    from fluid_llm_tpu_torch.ops import exact_attention as xa
    from fluid_llm_tpu_torch.ops import grid_gnn_fused as gf
    from fluid_llm_tpu_torch.rollout.generate import gen_seq

    cfg = Config.from_yaml(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                        "configs", "training1.yaml"))
    cfg = cfg.replace(load_dir="synthetic:1")
    t0 = time.perf_counter()
    model = inference.build_seeded_model(cfg, seed, dev)
    test_ds = get_dataset(cfg.replace(seq_len=STEPS + 2), mode="test")
    batch = next(make_batches(test_ds, 1, shuffle=False, device=dev))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    bcfg = model.backbone_cfg
    print(f"[slice] {cfg.llm_backbone}: {bcfg.n_layers} layers, d {bcfg.d_model}, "
          f"{bcfg.n_heads} heads, {bcfg.dtype}; window {ROLLOUT_TOKENS} tokens; "
          f"set-up {setup_s:.1f} s")

    # the main path, through the entry point a user calls
    xa.causal_attention.launches = 0
    gf.fused_slot_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    per_step, mean = inference.test_generate(model, test_ds, batch_size=1, pred_steps=STEPS)
    wall = time.perf_counter() - t0
    launches = {"exact_attention": xa.causal_attention.launches,
                "grid_slot_attention": gf.fused_slot_attention.launches}
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    want = {"exact_attention": (bcfg.n_layers - 1) * STEPS,
            "grid_slot_attention": cfg.decoder_params.gnn_layers * STEPS}
    print(f"[slice] test_generate: {STEPS} steps in {wall:.3f} s (incl. batch build); "
          f"mean N-RMSE {mean:.5f}; peak device memory {peak_mib:.1f} MiB; "
          f"launches {launches} (want {want})")
    if launches != want:
        failures.append(f"launch counts {launches} != {want}")
    if per_step.shape != (STEPS,) or not bool(torch.isfinite(torch.from_numpy(per_step)).all()):
        failures.append("N-RMSE not finite or wrong length")

    # steady-state rollout rate on a prepared batch (gen_seq alone), through
    # the kernels and through the plain twins, in turns
    rates = {True: [], False: []}
    want_shape = (1, STEPS + 1, 3, *model.ds_props.out_tot_size)
    for kernels in (True, False, False, True, True, False):
        model.kernels = kernels
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, _ = gen_seq(model, batch, STEPS)
        torch.cuda.synchronize()
        rates[kernels].append(STEPS / (time.perf_counter() - t0))
        if kernels and (tuple(states.shape) != want_shape or not bool(torch.isfinite(states).all())):
            failures.append(f"rollout states {tuple(states.shape)} (want {want_shape}) or not finite")
    model.kernels = True
    steps_per_s = statistics.median(rates[True])
    print(f"[slice] gen_seq: {steps_per_s:.2f} rollout steps/s through the kernels (median; "
          f"runs {', '.join(f'{r:.2f}' for r in rates[True])}); plain twins "
          f"{', '.join(f'{r:.2f}' for r in rates[False])}; states {tuple(states.shape)} finite")
    return model, batch, dict(setup_s=setup_s, test_generate_s=wall, mean_n_rmse=mean,
                              peak_mem_mib=peak_mib,
                              steps_per_s=steps_per_s, steps_per_s_runs=rates[True],
                              plain_steps_per_s_runs=rates[False], launches=launches)


def phase_agreement(model, batch, failures: list) -> list[float]:
    from fluid_llm_tpu_torch.rollout.generate import generate

    states, _, _, bc_mask, position_ids = batch
    out = {}
    for kernels in (True, False):
        model.kernels = kernels
        out[kernels] = generate(model, states[:, :1], bc_mask, position_ids, 10)[1]
    model.kernels = True
    errs = [rel_err(out[True][:, i], out[False][:, i]) for i in range(10)]
    ok = errs[0] <= REL_TOL
    print(f"[agreement] diffs rel err per step, kernels vs plain twins: "
          f"{', '.join(f'{e:.3e}' for e in errs)} (step 1 {'ok' if ok else 'FAIL'})")
    if not ok:
        failures.append(f"slice agreement step 1 rel {errs[0]}")
    return errs


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
    model, batch, slice_res = phase_slice(dev, args.seed, failures)
    errs = phase_agreement(model, batch, failures)

    sources = {"exact_attention": ("fluid_llm_tpu_torch/csrc/exact_attention.cu",
                                   "fluid_llm_tpu/ops/exact_attention.py:52"),
               "grid_slot_attention": ("fluid_llm_tpu_torch/csrc/grid_slot_attention.cu",
                                       "fluid_llm_tpu/ops/grid_gnn_pallas.py:122")}
    kernels = []
    for name, (source, replaces) in sources.items():
        main_rows = [r for r in rows if r["kernel"] == name and r["main_path"]]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=slice_res["launches"][name],
            max_abs_err=max(r["max_abs_err"] for r in main_rows),
            ms=main_rows[0]["ms"], plain_ms=main_rows[0]["plain_ms"],
        ))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(device=device, build_s=build_s, kernel_checks=rows,
                           slice=slice_res, agreement_rel_err=errs, failures=failures),
                      f, indent=1)
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
