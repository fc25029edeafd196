"""N-stream serving bench: serial bs=1 rollouts vs one coalesced bs=N rollout.

Counterpart of ``fluid_llm_tpu/tools/serving_bench.py``, with flags in
place of its ``FLUID_BENCH_*`` variables.  It drives
``serve.RolloutEngine`` itself (the coalescing worker, padding, bucket
dispatch) with N concurrent requests carrying N distinct trajectory
contexts, each with its own trajectory's mask, in each mode, and prints one
JSON line per mode:

    {"mode": "serial"|"batched", "n_streams": N, "bucket": ..., "warmup_s": ...,
     "wall_s_per_burst": ..., "aggregate_steps_per_sec": ...,
     "latency_s": {"mean": ..., "max": ...}, "coalesced_groups": ...}

The model is the flagship geometry (``fluid/llama-125m``, rope_abs,
absolute time, bf16, resolution 238) with seeded random weights.

    python -m fluid_llm_tpu_torch.tools.serving_bench [--streams 8] [--bucket 251] \\
        [--reps 5] [--modes serial,batched]
"""

from __future__ import annotations

import argparse
import json
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def build_engine_parts(bucket: int, n_streams: int, device):
    """Full serving geometry, random weights from seed 0, prepared on ``device``."""
    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
    from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM

    cfg = Config(
        llm_backbone="fluid/llama-125m", half_precision=True, use_lora=False, batch_size=1,
        autoreg_seq_len=10, seq_len=10, resolution=238, flash_attention=True,
        pos_embedding_params={"pos_embedding_type": "rope_abs", "input_emb_layer_dropout": 0.0},
        absolute_time_ids=True,
    )
    # model window from the training-shaped dataset; the serving dataset's
    # window covers the bucket (``serve.load_engine``'s probe/serve split)
    probe = SyntheticCylinderDataset(n_trajectories=1, resolution=238, seq_len=10,
                                     mode="valid", absolute_time=True)
    model = FluidLLM.build(cfg, probe.ds_props())
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(device).prepare_inference_params()
    serve_ds = SyntheticCylinderDataset(n_trajectories=n_streams, resolution=238,
                                        seq_len=bucket + 1, mode="test", max_steps=600,
                                        absolute_time=True)
    return cfg, model.eval(), serve_ds


def client_contexts(ds, n_streams: int) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """N distinct raw-grid single-frame contexts and each one's own mask
    (uint8, 1 outside the mesh): every trajectory has its own mesh."""
    from fluid_llm_tpu_torch.core.interp import resample_to_grid

    frames, masks = [], []
    for i in range(n_streams):
        src = ds.get_trajectory(i)
        grid = resample_to_grid(torch.from_numpy(src.node_states[:1]),
                                torch.from_numpy(src.vert_idx), torch.from_numpy(src.weights),
                                torch.from_numpy(src.mask))
        frames.append(grid.numpy().astype(np.float32))
        masks.append(np.asarray(src.mask, np.uint8))
    return frames, masks


def run_mode(mode: str, cfg, model, ds, bucket: int, frames, masks, reps: int,
             streaming: bool = True) -> dict:
    """One engine in ``mode`` ("serial": bs=1 rollouts; "batched": every
    burst coalesced into one bs=N rollout), ``reps`` bursts of N concurrent
    requests; the first burst is discarded as warm-in."""
    from fluid_llm_tpu_torch.tools.serve import RolloutEngine

    n = len(frames)
    t0 = time.monotonic()
    eng = RolloutEngine(cfg, model, ds, buckets=[bucket], streaming=streaming,
                        max_batch=(n if mode == "batched" else 1),
                        # every stream fires at once: a generous window
                        # guarantees full coalescing
                        batch_window_ms=1000.0)
    eng.warmup()
    warmup_s = time.monotonic() - t0

    walls, lats = [], []
    for _ in range(reps):
        lat = [None] * n
        t0 = time.monotonic()

        def one(i):
            ts = time.monotonic()
            out = eng.request(frames[i], masks[i], bucket, 0)
            lat[i] = time.monotonic() - ts
            return out

        with ThreadPoolExecutor(n) as pool:
            outs = list(pool.map(one, range(n)))
        walls.append(time.monotonic() - t0)
        lats.append(lat)
        for o in outs:
            if o.shape[0] != bucket or not np.isfinite(o).all():
                raise RuntimeError(f"serving_bench: output {o.shape} not finite or short")
    walls, lats = walls[1:] or walls, lats[1:] or lats
    wall = float(np.mean(walls))
    flat = [x for burst in lats for x in burst]
    rec = {
        "mode": mode, "n_streams": n, "bucket": bucket, "warmup_s": round(warmup_s, 1),
        "wall_s_per_burst": round(wall, 3),
        "aggregate_steps_per_sec": round(n * bucket / wall, 1),
        "latency_s": {"mean": round(float(np.mean(flat)), 3), "max": round(float(np.max(flat)), 3)},
        "coalesced_groups": eng.stats().get("coalesced_groups", 0),
    }
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--streams", type=int, default=8)
    parser.add_argument("--bucket", type=int, default=251)
    parser.add_argument("--reps", type=int, default=5, help="bursts; the first is warm-in")
    parser.add_argument("--modes", default="serial,batched")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    from fluid_llm_tpu_torch.utils import get_device

    cfg, model, ds = build_engine_parts(args.bucket, args.streams, get_device(args.device))
    frames, masks = client_contexts(ds, args.streams)
    for mode in args.modes.split(","):
        run_mode(mode, cfg, model, ds, args.bucket, frames, masks, args.reps)


if __name__ == "__main__":
    main()
