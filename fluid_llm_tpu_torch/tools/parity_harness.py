"""One-command N-RMSE / throughput parity harness against the reference stack.

Counterpart of ``fluid_llm_tpu/tools/parity_harness.py``.  The real-dataset
251-step comparison (the reference's ``src/inference.py:85-87``,
BASELINE.md's 1e-3 N-RMSE target) needs the DeepMind ``cylinder_flow``
pickles, trained or pretrained weights, and a checkout of the reference's
own torch stack.  This harness packages the protocol so the comparison is
one command wherever those exist:

    python -m fluid_llm_tpu_torch.tools.parity_harness \\
        --reference /path/to/FLUID-LLM \\
        --ref_checkpoint_dir /path/ckpts \\
        --checkpoint_dir model_checkpoints --load_no -1 \\
        --out BASELINE_MEASURED.json [--device cuda]

Each half that can run contributes its section.  ``run_ours`` runs the
port's ``inference.test_generate`` on ``--device`` (the card unless the
caller asks for the CPU).  The ``--synthetic`` mode dry-runs the whole
plumbing on generated data with a seeded random model (no checkpoint).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

logger = logging.getLogger("fluid_llm_tpu_torch.parity_harness")


def run_ours(args) -> dict:
    """The port's 251-step protocol on ``args.device``; the metrics section."""
    from fluid_llm_tpu_torch.inference import load_checkpoint_model, test_generate
    from fluid_llm_tpu_torch.utils import get_device, set_seed

    device = get_device(args.device)
    set_seed()
    if args.synthetic:
        from fluid_llm_tpu_torch.config import Config
        from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
        from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM

        cfg = Config(
            llm_backbone="facebook/opt-125m",
            llm_layers=args.synthetic_layers,
            half_precision=True,
            use_lora=False,
            batch_size=1,
            autoreg_seq_len=10,
            seq_len=args.pred_steps + 2,
            resolution=args.synthetic_resolution,
            flash_attention=False,
        )
        # test mode samples from the reference's fixed step 100
        # (``data/pipeline.py``): the trajectory must cover 100 + seq_len
        ds = SyntheticCylinderDataset(
            n_trajectories=1, resolution=cfg.resolution,
            seq_len=cfg.seq_len, mode="test",
            max_steps=args.pred_steps + 110,
        )
        model = FluidLLM.build(cfg, ds.ds_props())
        model.init_weights(torch.Generator().manual_seed(0))
        model.to(device)
        model.prepare_inference_params()
        model.eval()
    else:
        from fluid_llm_tpu_torch.data import get_dataset
        from fluid_llm_tpu_torch.train import checkpoint as ckpt

        load_path = ckpt.get_save_folder(args.checkpoint_dir, args.load_no)
        model = load_checkpoint_model(load_path, ckpt.latest_step(load_path), device)
        ds = get_dataset(model.cfg.replace(seq_len=args.pred_steps + 2), mode="test")

    t0 = time.time()
    per_step, mean = test_generate(model, ds, batch_size=1, pred_steps=args.pred_steps,
                                   ctx_states=1)
    wall = time.time() - t0
    n50 = float(np.mean(per_step[:50])) if len(per_step) >= 50 else None
    return {
        "n_rmse_mean": float(mean),
        "n_rmse_50": n50,
        "per_step_head": [float(v) for v in per_step[:10]],
        "wall_s": round(wall, 2),
        "steps_per_sec_incl_compile": round(args.pred_steps / wall, 2),
        "device": str(device),
        "note": "wall time includes the first call's kernel build",
    }


def run_reference(args) -> dict | None:
    """Run the reference's ``src/inference.py`` (torch/CUDA) and parse its
    N-RMSE output.  Returns None (with a reason logged) when it cannot run
    here: no reference checkout, or no CUDA."""
    ref = args.reference
    if not ref or not os.path.isdir(ref):
        logger.warning("reference checkout not provided/found: skipping")
        return None
    if not torch.cuda.is_available():
        logger.warning("the reference stack needs CUDA (flash-attn): skipping")
        return None

    cmd = [sys.executable, os.path.join(ref, "src", "inference.py")]
    if args.ref_args:
        cmd += args.ref_args.split()
    env = dict(os.environ)
    if args.ref_checkpoint_dir:
        env["CHECKPOINT_DIR"] = args.ref_checkpoint_dir
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=ref, env=env, capture_output=True, text=True, timeout=7200)
    wall = time.time() - t0
    out = proc.stdout + proc.stderr
    # the reference logs "Standard N_RMSE: [...] , Mean: X"
    m = re.search(r"Mean:?\s*([0-9.eE+-]+)", out)
    return {
        "returncode": proc.returncode,
        "wall_s": round(wall, 2),
        "n_rmse_mean": float(m.group(1)) if m else None,
        "log_tail": out[-2000:],
    }


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reference", default=None, help="path to a FLUID-LLM reference checkout")
    p.add_argument("--ref_checkpoint_dir", default=None)
    p.add_argument("--ref_args", default=None,
                   help="extra CLI args forwarded to the reference inference")
    p.add_argument("--checkpoint_dir", default="model_checkpoints")
    p.add_argument("--load_no", type=int, default=-1)
    p.add_argument("--pred_steps", type=int, default=251)
    p.add_argument("--out", default="BASELINE_MEASURED.json")
    p.add_argument("--device", default="cuda")
    p.add_argument("--synthetic", action="store_true",
                   help="dry-run on generated data with a seeded random model")
    p.add_argument("--synthetic_layers", type=int, default=2)
    p.add_argument("--synthetic_resolution", type=int, default=64)
    args = p.parse_args(argv)

    record: dict = {
        "protocol": {
            "pred_steps": args.pred_steps, "ctx_states": 1, "batch_size": 1,
            "source": "reference src/inference.py:85-87",
        },
        "synthetic": bool(args.synthetic),
    }
    record["ours"] = run_ours(args)
    ref = run_reference(args)
    record["reference"] = ref
    if ref and ref.get("n_rmse_mean") is not None and ref["wall_s"]:
        record["rollout_steps_per_sec"] = round(args.pred_steps / ref["wall_s"], 2)
        if record["ours"]["n_rmse_mean"] and ref["n_rmse_mean"]:
            record["n_rmse_abs_diff"] = abs(record["ours"]["n_rmse_mean"] - ref["n_rmse_mean"])
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    logger.info("wrote %s", args.out)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
