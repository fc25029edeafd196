"""Profile the anchor training step and print a per-op device time table.

Counterpart of ``fluid_llm_tpu/tools/train_profile.py``: the configuration
of its ``run_trace`` (OPT-125m, DoRA, batch 8, resolution 238, bf16, flash
attention; random weights from the config's seed), one warm autoreg step,
then 3 steps under ``torch.profiler`` (CPU and CUDA activities), summarised
per op and category (``tools/profiling.summarize_trace``).

    python -m fluid_llm_tpu_torch.tools.train_profile [trace_dir] [--device cuda]

Without ``trace_dir`` the trace goes to a temporary folder, removed
afterwards.  ``--device cpu`` runs the plain twins (a test of the tool).
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import tempfile

import torch

TRACED_STEPS = 3


def build(device: torch.device, resolution: int = 238, batch_size: int = 8, **overrides):
    """The anchor trainer on ``device`` and one batch of the synthetic
    validation split."""
    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch.data.pipeline import make_batches
    from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
    from fluid_llm_tpu_torch.main import build_model_and_trainer

    cfg = Config(llm_backbone="facebook/opt-125m", half_precision=True, use_lora=True,
                 batch_size=batch_size, autoreg_seq_len=10, seq_len=10, resolution=resolution,
                 flash_attention=True)
    ds = SyntheticCylinderDataset(n_trajectories=batch_size, resolution=resolution, seq_len=10,
                                  mode="valid")
    trainer = build_model_and_trainer(cfg, ds.ds_props(), device, pretrained=False, **overrides)
    batch = next(make_batches(ds, cfg.batch_size, shuffle=False, device=device))
    return trainer, batch


def run_trace(trace_dir: str, device: torch.device, **build_kw) -> list[float]:
    """One warm step, then TRACED_STEPS under the profiler; the losses."""
    from fluid_llm_tpu_torch.train.loop import _profiler

    trainer, batch = build(device, **build_kw)
    losses = [float(trainer.train_step(batch)["loss"])]
    with _profiler(trace_dir, device):
        ms = [trainer.train_step(batch) for _ in range(TRACED_STEPS)]
        losses += [float(m["loss"]) for m in ms]
    if not all(torch.isfinite(torch.tensor(losses))):
        raise RuntimeError(f"train_profile: losses not finite: {losses}")
    return losses


def main(argv=None):
    from fluid_llm_tpu_torch.tools.profiling import summarize_trace

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("trace_dir", nargs="?", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_profile: CUDA is not available (pass --device cpu to run the "
                         "plain twins on the CPU)")
    with contextlib.ExitStack() as stack:
        trace_dir = args.trace_dir or stack.enter_context(tempfile.TemporaryDirectory())
        losses = run_trace(trace_dir, device)
        print(f"trace of {TRACED_STEPS} steps in {trace_dir}; losses {losses}")
        return summarize_trace(trace_dir, divisor=TRACED_STEPS, top=40)


if __name__ == "__main__":
    main(sys.argv[1:])
