"""Exact-rollout traces on the card.

Counterpart of ``fluid_llm_tpu/tools/rollout_profile.py``.  Two modes,
each over the serving protocol's rollout (``BENCH_ROLLOUT_STEPS``, default
251, from one state of a 10-frame window at resolution 238, bs 1, bf16,
random weights from seed 0):

    python -m fluid_llm_tpu_torch.tools.rollout_profile [trace] [--trace_dir D]
        One OPT-125m rollout under ``torch.profiler`` (CPU and CUDA
        activities), summarised per op and category
        (``tools/profiling.summarize_trace``).  The trace carries the
        port's ``fluid.*`` spans (``tools/profiling.span``), which split a
        step by layer.

    python -m fluid_llm_tpu_torch.tools.rollout_profile trace_stream
        The same for the streaming rollout of the flagship LLaMA-125m
        (``rope_abs``, absolute time; ``rollout/streaming.py``).

``--device cpu`` runs the plain twins on the CPU (a test of the tool, not a
measurement).  Without ``--trace_dir`` the trace goes to a temporary
folder, removed afterwards.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile
import time

import torch

SEQ_LEN = 10
PRED_STEPS = int(os.environ.get("BENCH_ROLLOUT_STEPS", 251))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _config(streaming: bool, resolution: int):
    from fluid_llm_tpu_torch.config import Config

    kw = dict(llm_backbone="facebook/opt-125m", freeze_llm=False)
    if streaming:
        kw = dict(llm_backbone="fluid/llama-125m", absolute_time_ids=True,
                  pos_embedding_params={"pos_embedding_type": "rope_abs",
                                        "input_emb_layer_dropout": 0.0})
    return Config(half_precision=True, use_lora=False, batch_size=1, autoreg_seq_len=SEQ_LEN,
                  seq_len=SEQ_LEN, resolution=resolution, flash_attention=True, **kw)


def build(device: torch.device, streaming: bool = False, resolution: int = 238, **overrides):
    """The prepared model (seed 0) and the first window of one synthetic
    test trajectory on ``device``; ``overrides`` replace backbone fields."""
    from fluid_llm_tpu_torch.data.pipeline import make_batches
    from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
    from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM

    cfg = _config(streaming, resolution)
    ds = SyntheticCylinderDataset(n_trajectories=1, resolution=resolution, seq_len=SEQ_LEN,
                                  mode="test", max_steps=600, absolute_time=streaming)
    model = FluidLLM.build(cfg, ds.ds_props(), **overrides)
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(device)
    model.prepare_inference_params()
    model.eval()
    batch = next(make_batches(ds, 1, shuffle=False, device=device))
    return model, batch


def _roll(model, batch, streaming: bool, steps: int):
    from fluid_llm_tpu_torch.rollout.generate import generate
    from fluid_llm_tpu_torch.rollout.streaming import generate_streaming

    states, _, _, bc_mask, pos = batch
    fn = generate_streaming if streaming else generate
    return lambda: fn(model, states[:, :1], bc_mask, pos, steps)


def timed_roll(model, batch, tag: str, n_rep: int = 6, streaming: bool = False,
               steps: int = PRED_STEPS) -> tuple[float, object]:
    """Seconds a step over ``n_rep`` rollouts after a warm one; and the
    rollout as a function of nothing."""
    device = batch[0].device
    roll = _roll(model, batch, streaming, steps)
    t0 = time.perf_counter()
    st, _ = roll()
    _sync(device)
    print(f"{tag}: first rollout {time.perf_counter() - t0:.1f}s", file=sys.stderr, flush=True)
    if not torch.isfinite(st.float()).all():
        raise RuntimeError(f"{tag}: the rollout is not finite")
    t0 = time.perf_counter()
    for _ in range(n_rep):
        roll()
    _sync(device)
    dt = (time.perf_counter() - t0) / n_rep
    print(f"{tag}: {steps / dt:.1f} steps/s  ({dt / steps * 1e3:.3f} ms/step)", flush=True)
    return dt / steps, roll


def trace(device: torch.device, streaming: bool = False, trace_dir: str | None = None,
          resolution: int = 238, steps: int = PRED_STEPS, **overrides):
    """One rollout under ``torch.profiler`` after a timed warm one; the
    summary of ``tools/profiling.summarize_trace`` (None without device
    events, as on the CPU)."""
    from fluid_llm_tpu_torch.tools.profiling import summarize_trace
    from fluid_llm_tpu_torch.train.loop import _profiler

    model, batch = build(device, streaming=streaming, resolution=resolution, **overrides)
    tag = "streaming" if streaming else "traced"
    _, roll = timed_roll(model, batch, tag, n_rep=1, streaming=streaming, steps=steps)
    with contextlib.ExitStack() as stack:
        if trace_dir is None:
            trace_dir = stack.enter_context(tempfile.TemporaryDirectory())
        with _profiler(trace_dir, device):
            roll()
            _sync(device)
        print(f"trace of one {steps}-step rollout in {trace_dir}")
        return summarize_trace(trace_dir, divisor=steps, top=30)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("mode", nargs="?", default="trace", choices=["trace", "trace_stream"])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--trace_dir", default=None)
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("rollout_profile: CUDA is not available (pass --device cpu to run "
                         "the plain twins on the CPU)")
    return trace(device, streaming=args.mode == "trace_stream", trace_dir=args.trace_dir)


if __name__ == "__main__":
    main(sys.argv[1:])
