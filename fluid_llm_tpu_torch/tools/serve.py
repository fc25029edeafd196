"""HTTP serving daemon: load a checkpoint once, serve trajectory rollouts on the card.

Counterpart of ``fluid_llm_tpu/tools/serve.py``.  One process owns the
card; the checkpoint is restored once (optionally with the backbone stored
as int8 or nf4, ``--quant``: a MoE backbone's expert banks int8 either way,
its router float; a run trained over an nf4 frozen backbone restores into
nf4 storage and merges its adapters); each request is one rollout of the
pred-steps bucket it falls in.  PyTorch runs eagerly, so there is nothing
to compile: a (bucket, ctx) pair is a "program" only for the statistics.

Request contract (``POST /v1/rollout``, JSON), as the JAX daemon's:

    {
      "states":     base64 float32 little-endian, shape (ctx, 3, H, W)
                    RAW grid frames (physical units, not normalized);
                    every context frame conditions the rollout
                    (``start_state=ctx``); 1 <= ctx <= the model window
                    (rejected with 400 otherwise),
      "shape":      [ctx, 3, H, W],
      "mask":       base64 uint8, shape (H, W) -- 1 outside the mesh,
      "pred_steps": int,
      "start_step": int (default 0) -- trajectory step of frame 0; only
                    meaningful for ``absolute_time_ids`` models,
    }

Response: ``{"states": b64 f32, "shape": [pred, 3, H, W], "latency_s",
"steps_per_s"}`` -- predictions denormalized to physical units on the
client's grid (the patch padding cropped; a ``flip_y`` dataset's frames
flipped back; a ``trim_patches`` one's served on the model grid, as its
geometry changed).  The rollout runs to the
bucket's length and the first ``pred_steps`` come back, so a request's
output equals the JAX engine's.  ``GET /v1/info`` publishes the geometry,
``GET /healthz`` is the liveness probe, ``GET /v1/stats`` reports request
and error counters, per-program call counts and latency percentiles (last
1024 requests).  Device work is serialized with a lock (one card).

The dataset's airfoil switches (y flip, patch trim, masked normalisation)
apply to requests as to training windows, and ``/v1/info`` publishes them.

    python -m fluid_llm_tpu_torch.tools.serve --checkpoint_dir model_checkpoints \\
        --load_no -1 --port 8474 --buckets 50,251 --quant int8 [--qmm_mode w8a8]
"""

from __future__ import annotations

import argparse
import base64
import json
import logging
import queue
import sys
import threading
import time
from collections import deque
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

logger = logging.getLogger("fluid_llm_tpu_torch.serve")


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode("ascii")


def _unb64(data: str, shape, dtype) -> np.ndarray:
    raw = base64.b64decode(data)
    arr = np.frombuffer(raw, dtype=dtype)
    expect = int(np.prod(shape))
    if arr.size != expect:
        raise ValueError(f"payload has {arr.size} elements, shape {shape} needs {expect}")
    return arr.reshape(shape)


class RolloutEngine:
    """A prepared model and its rollout, one "program" per (bucket, ctx).

    ``model`` is a prepared ``FluidLLM`` (``prepare_inference_params``) on
    its device; the batches go there.  ``max_batch > 1`` adds request
    coalescing: a worker thread drains the queue for up to
    ``batch_window_ms`` after the first request and runs one batched rollout
    per (bucket, ctx) group, padded to ``max_batch`` (``serve.py:303-339``).
    """

    def __init__(self, cfg, model, dataset, buckets, streaming: bool, max_batch: int = 1,
                 batch_window_ms: float = 10.0):
        self.cfg = cfg
        self.model = model
        self.dataset = dataset
        self.streaming = streaming
        self.buckets = sorted(set(int(b) for b in buckets))
        self.max_batch = int(max_batch)
        self.batch_window_s = batch_window_ms / 1e3
        self.device = next(model.parameters()).device
        self.pad_x, self.pad_y, self.nx, self.ny = dataset._probe()
        self.grid_hw = tuple(dataset.get_trajectory(0).mask.shape)
        self._lock = threading.Lock()  # one card: serialize device work
        self._rollouts = {}
        self._stats_lock = threading.Lock()
        self._counters = {"requests": 0, "errors": 0, "device_calls": 0,
                          "device_ms_total": 0.0, "coalesced_groups": 0, "padded_rows": 0}
        self._by_program: dict[str, int] = {}
        self._lat_ms = deque(maxlen=1024)

        if streaming:
            from fluid_llm_tpu_torch.rollout.streaming import generate_streaming as gen
        else:
            from fluid_llm_tpu_torch.rollout.generate import generate as gen
        self._gen = gen
        for b in self.buckets:
            self._get_rollout(b, 1)

        self._queue = None
        if self.max_batch > 1:
            self._queue = queue.Queue()
            threading.Thread(target=self._batch_worker, daemon=True).start()

    def _get_rollout(self, bucket: int, ctx: int):
        """The rollout of a (bucket, ctx) pair: the compact batch -> (states,
        diffs) as images.  Registered for the statistics on first use."""
        key = (bucket, ctx)
        prog = self._rollouts.get(key)
        if prog is None:
            from fluid_llm_tpu_torch.ops.patching import patch_to_img

            def prog(batch, _b=bucket):
                init, bcm, pos = batch
                st, df = self._gen(self.model, init, bcm, pos, _b)
                props = self.model.ds_props
                return patch_to_img(st, props), patch_to_img(df, props)

            with self._stats_lock:
                prog = self._rollouts.setdefault(key, prog)
        return prog

    # -- batch construction ---------------------------------------------

    def build_batch(self, grid_states: np.ndarray, grid_mask: np.ndarray, bucket: int,
                    start_step: int = 0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Raw grid context frames -> the compact serving batch
        ``(init_states (1, ctx, ...), bc_mask (1, 1, ...), pos (1, 1, ...))``
        on the engine's device.

        Both rollouts read exactly the ctx context frames, one
        time-invariant bc_mask frame (indexed with a clamped step) and
        position-id frame 0, so only those are built: on the CPU with the
        dataset pipeline, then moved to the device once."""
        from fluid_llm_tpu_torch.data.pipeline import position_ids, window_to_patches

        ds = self.dataset
        # a (ctx+1)-frame window yields exactly the ctx real input states;
        # the repeated last frame only feeds the unread next/diff targets
        small = np.concatenate([grid_states, grid_states[-1:]], axis=0).astype(np.float32)
        input_states, _, _, bc_mask = window_to_patches(
            torch.from_numpy(small), torch.from_numpy(np.asarray(grid_mask, bool)), ds.means,
            ds.stds, patch=ds.patch_size, pad_x=self.pad_x, pad_y=self.pad_y, flip_y=ds.flip_y,
            trim=ds.trim_patches, masked_norm=ds.masked_norm)
        pos = position_ids(1, self.nx, self.ny,
                           t_base=start_step if ds.absolute_time else 0,
                           t_step=ds.seq_interval if ds.absolute_time else 1)
        return tuple(t[None].contiguous().to(self.device)
                     for t in (input_states, bc_mask[:1], pos))

    # -- inference --------------------------------------------------------

    def pick_bucket(self, pred_steps: int) -> int:
        for b in self.buckets:
            if pred_steps <= b:
                return b
        raise ValueError(f"pred_steps {pred_steps} exceeds largest bucket {self.buckets[-1]}")

    def _validate(self, grid_states: np.ndarray, grid_mask: np.ndarray) -> None:
        if grid_states.shape[1:] != (3, *self.grid_hw):
            raise ValueError(f"states shape {grid_states.shape} != (ctx, 3, {self.grid_hw[0]}, "
                             f"{self.grid_hw[1]})")
        ctx = grid_states.shape[0]
        max_ctx = self.model.max_ctx_len
        if not 1 <= ctx <= max_ctx:
            raise ValueError(f"context length {ctx} not in [1, {max_ctx}] (the model's window; "
                             "all context frames condition the rollout)")
        if grid_mask.shape != self.grid_hw:
            raise ValueError(f"mask shape {grid_mask.shape} != {self.grid_hw}")

    def _device_rollout(self, bucket: int, ctx: int, batch) -> np.ndarray:
        """One (possibly batched) rollout -> (bs, ctx+bucket, 3, H, W)."""
        rollout = self._get_rollout(bucket, ctx)
        with self._lock:
            t0 = time.monotonic()
            pred_states, _ = rollout(batch)
            out = pred_states.float().cpu().numpy()  # waits for the device
        dt_ms = (time.monotonic() - t0) * 1e3
        key = f"bucket={bucket} ctx={ctx} bs={out.shape[0]}"
        with self._stats_lock:
            self._counters["device_calls"] += 1
            self._counters["device_ms_total"] += dt_ms
            self._by_program[key] = self._by_program.get(key, 0) + 1
        return out

    def predict(self, grid_states: np.ndarray, grid_mask: np.ndarray, pred_steps: int,
                start_step: int = 0) -> np.ndarray:
        """(ctx, 3, H, W) raw grid frames -> (pred_steps, 3, H, W) raw preds."""
        self._validate(grid_states, grid_mask)
        bucket = self.pick_bucket(pred_steps)
        ctx = grid_states.shape[0]
        batch = self.build_batch(grid_states, grid_mask.astype(bool), bucket, start_step)
        pred_states = self._device_rollout(bucket, ctx, batch)
        # [ctx context frames ... preds]: keep pred_steps of the bucket's
        return self._to_client_grid(pred_states[0, ctx:ctx + pred_steps])

    # -- request coalescing (max_batch > 1) --------------------------------

    def request(self, grid_states: np.ndarray, grid_mask: np.ndarray, pred_steps: int,
                start_step: int = 0) -> np.ndarray:
        """Public request path: coalesced when batching is enabled."""
        t0 = time.monotonic()
        try:
            if self._queue is None:
                out = self.predict(grid_states, grid_mask, pred_steps, start_step)
            else:
                fut = Future()
                self._validate(grid_states, grid_mask)  # fail fast on the caller thread
                self._queue.put((grid_states, grid_mask, pred_steps, start_step, fut))
                out = fut.result()
        except Exception:
            with self._stats_lock:
                self._counters["requests"] += 1
                self._counters["errors"] += 1
            raise
        with self._stats_lock:
            self._counters["requests"] += 1
            self._lat_ms.append((time.monotonic() - t0) * 1e3)
        return out

    def _batch_worker(self) -> None:
        while True:
            group = [self._queue.get()]
            deadline = time.monotonic() + self.batch_window_s
            while len(group) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    group.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                self._run_group(group)
            except Exception as e:  # pragma: no cover - every future gets an answer
                for *_ignored, fut in group:
                    if not fut.done():
                        fut.set_exception(e)

    def _run_group(self, group) -> None:
        """Partition by (bucket, ctx), one batched rollout per part; groups of
        1 < n < max_batch are padded to ``max_batch`` with the first sample
        and the results sliced, so only batch sizes {1, max_batch} run."""
        by_key: dict[tuple[int, int], list] = {}
        for req in group:
            states, _mask, pred_steps, _start, fut = req
            try:
                key = (self.pick_bucket(pred_steps), states.shape[0])
                by_key.setdefault(key, []).append(req)
            except ValueError as e:
                fut.set_exception(e)
        for (bucket, ctx), reqs in by_key.items():
            try:
                parts = [self.build_batch(s, m.astype(bool), bucket, st)
                         for s, m, _p, st, _f in reqs]
                n = len(parts)
                if 1 < n < self.max_batch:
                    parts = parts + [parts[0]] * (self.max_batch - n)
                with self._stats_lock:
                    if n > 1:
                        self._counters["coalesced_groups"] += 1
                    self._counters["padded_rows"] += len(parts) - n
                batch = tuple(torch.cat(axis_parts, dim=0) for axis_parts in zip(*parts))
                preds = self._device_rollout(bucket, ctx, batch)
                for i, (_s, _m, pred_steps, _st, fut) in enumerate(reqs):
                    fut.set_result(self._to_client_grid(preds[i, ctx:ctx + pred_steps]))
            except Exception as e:
                for *_ignored, fut in reqs:
                    if not fut.done():
                        fut.set_exception(e)

    def _to_client_grid(self, pred: np.ndarray) -> np.ndarray:
        """Undo the model grid's transforms (y flip; the pad crop, unless
        trimmed: trim changes the geometry, so the model grid is served) and
        denormalize to physical units."""
        ds = self.dataset
        if ds.flip_y:
            pred = pred[..., ::-1]
        if not ds.trim_patches:
            (x0, x1), (y0, y1) = self.pad_x, self.pad_y
            H, W = pred.shape[-2:]
            pred = pred[..., x0:H - x1, y0:W - y1]
        means, stds = ds.means.numpy(), ds.stds.numpy()
        return pred * stds[None, :, None, None] + means[None, :, None, None]

    def warmup(self) -> None:
        """Run every (bucket, batch size) a request can reach once: ctx 1 at
        batch sizes {1, max_batch} (first launches load the kernel library
        and allocate the caches)."""
        zeros = np.zeros((1, 3, *self.grid_hw), np.float32)
        mask = np.zeros(self.grid_hw, bool)
        for b in self.buckets:
            for bs in sorted({1, self.max_batch}):
                t0 = time.monotonic()
                batch = tuple(t.repeat(bs, *([1] * (t.dim() - 1)))
                              for t in self.build_batch(zeros, mask, b))
                self._device_rollout(b, 1, batch)
                logger.info("warm bucket %d bs=%d ran in %.1fs", b, bs, time.monotonic() - t0)

    def stats(self) -> dict:
        """``GET /v1/stats``: request/error counters, call counts per
        program, request latency percentiles over the last 1024 requests."""
        with self._stats_lock:
            c = dict(self._counters)
            lat = sorted(self._lat_ms)
            by_prog = dict(self._by_program)
            prog_keys = list(self._rollouts)
        out = {**c, "device_ms_total": round(c["device_ms_total"], 1), "by_program": by_prog,
               "compiled_programs": sorted(f"bucket={b} ctx={x}" for b, x in prog_keys)}
        if lat:
            q = lambda p: round(lat[min(len(lat) - 1, int(p * len(lat)))], 1)  # noqa: E731
            out["latency_ms"] = {"count": len(lat), "mean": round(sum(lat) / len(lat), 1),
                                 "p50": q(0.50), "p95": q(0.95), "p99": q(0.99)}
        return out

    def info(self) -> dict:
        ds = self.dataset
        return {
            "backbone": self.cfg.llm_backbone,
            "streaming": self.streaming,
            "buckets": self.buckets,
            "max_batch": self.max_batch,
            "max_ctx": self.model.max_ctx_len,
            "grid_hw": list(self.grid_hw),
            "patch_size": list(ds.patch_size),
            "n_patch": self.nx * self.ny,
            "absolute_time_ids": ds.absolute_time,
            "means": [float(m) for m in ds.means],
            "stds": [float(s) for s in ds.stds],
            "trim_patches": ds.trim_patches,
            "flip_y": ds.flip_y,
        }


def load_engine(checkpoint_dir: str, load_no: int = -1, step: int | None = None,
                buckets=(50, 251), streaming: str = "auto", max_batch: int = 1,
                batch_window_ms: float = 10.0, quant: str | None = None,
                qmm_mode: str = "w8a16", device: str | torch.device = "cuda") -> RolloutEngine:
    """Restore a run's checkpoint (``train/checkpoint.py``) into a serving
    engine on ``device``.

    ``quant`` ("int8" | "nf4") stores the backbone's linears quantized
    after the adapters are merged (``FluidLLM.prepare_inference_params``);
    int8 linears run the ``qmm_mode`` kernel: "w8a16" (the default: bf16
    activations, as the JAX package's default ``FLUID_QMM=auto`` path,
    ``x @ dequant(q)``) or "w8a8" (opt-in: activations quantised to int8 a
    row, the JAX kernel's ``FLUID_QMM_MODE=w8a8`` under
    ``FLUID_QMM=pallas``).  ``streaming`` "auto" serves rope
    backbones with ``rope_abs`` embeddings and absolute time through the
    KV-cache rollout, others through the exact one; "on" / "off" force it.
    """
    from fluid_llm_tpu_torch.data import get_dataset
    from fluid_llm_tpu_torch.inference import load_checkpoint_model
    from fluid_llm_tpu_torch.train import checkpoint as ckpt
    from fluid_llm_tpu_torch.utils import get_device, set_seed

    set_seed()
    load_path = ckpt.get_save_folder(checkpoint_dir, load_no)
    step = step if step is not None else ckpt.latest_step(load_path)
    logger.info("serving %s step_%s", load_path, step)
    model = load_checkpoint_model(load_path, step, get_device(device), quant, qmm_mode)
    if quant:
        logger.info("backbone weights stored as %s (int8 matmul %s)", quant, qmm_mode)
    cfg = model.cfg
    if streaming == "auto":
        use_streaming = (model.backbone_cfg.pos == "rope"
                         and cfg.pos_embedding_params.pos_embedding_type == "rope_abs"
                         and cfg.absolute_time_ids)
    else:
        use_streaming = streaming in ("1", "true", "yes", "on")
    # the serving dataset provides geometry and stats only; its window covers
    # the largest bucket
    serve_ds = get_dataset(cfg.replace(seq_len=max(buckets) + 1), mode="test")
    return RolloutEngine(cfg, model, serve_ds, buckets, use_streaming, max_batch=max_batch,
                         batch_window_ms=batch_window_ms)


class _Handler(BaseHTTPRequestHandler):
    engine: RolloutEngine = None  # set by serve()

    def log_message(self, fmt, *args):  # route through logging, not stderr
        logger.info("%s %s", self.address_string(), fmt % args)

    def _send(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            self._send(200, {"status": "ok"})
        elif self.path == "/v1/info":
            self._send(200, self.engine.info())
        elif self.path == "/v1/stats":
            self._send(200, self.engine.stats())
        else:
            self._send(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        if self.path != "/v1/rollout":
            self._send(404, {"error": f"unknown path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length))
            shape = req["shape"]
            states = _unb64(req["states"], shape, np.float32)
            mask = _unb64(req["mask"], shape[-2:], np.uint8)
            pred_steps = int(req["pred_steps"])
            start_step = int(req.get("start_step", 0))
            t0 = time.monotonic()
            pred = self.engine.request(states, mask, pred_steps, start_step)
            dt = time.monotonic() - t0
            self._send(200, {"states": _b64(pred.astype(np.float32)), "shape": list(pred.shape),
                             "latency_s": round(dt, 4), "steps_per_s": round(pred_steps / dt, 2)})
        except (KeyError, ValueError, json.JSONDecodeError) as e:
            self._send(400, {"error": str(e)})
        except Exception as e:  # keep the daemon alive on a bad request
            logger.exception("rollout failed")
            self._send(500, {"error": f"{type(e).__name__}: {e}"})


def serve(engine: RolloutEngine, host: str = "127.0.0.1", port: int = 8474) -> ThreadingHTTPServer:
    """An HTTP server for ``engine`` (not yet serving: call ``serve_forever``)."""
    handler = type("Handler", (_Handler,), {"engine": engine})
    httpd = ThreadingHTTPServer((host, port), handler)
    logger.info("serving on http://%s:%d (buckets %s, streaming=%s)", host,
                httpd.server_address[1], engine.buckets, engine.streaming)
    return httpd


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Serve a FluidLLM checkpoint over HTTP on the card.")
    parser.add_argument("--checkpoint_dir", default="model_checkpoints")
    parser.add_argument("--load_no", type=int, default=-1)
    parser.add_argument("--step", type=int, default=None)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8474)
    parser.add_argument("--buckets", default="50,251", help="pred-steps rollout sizes")
    parser.add_argument("--streaming", default="auto", choices=["auto", "on", "off"],
                        help="KV-cache serving (rope backbones; auto-detected)")
    parser.add_argument("--max_batch", type=int, default=1,
                        help="coalesce up to N concurrent requests per rollout")
    parser.add_argument("--batch_window_ms", type=float, default=10.0,
                        help="how long to wait for co-batchable requests")
    parser.add_argument("--quant", default=None, choices=["int8", "nf4"],
                        help="store backbone weights quantized (adapters are merged first)")
    parser.add_argument("--qmm_mode", default="w8a16", choices=["w8a8", "w8a16"],
                        help="int8 matmul kernel: bf16 activations (w8a16, the default, as "
                             "the reference's) or int8 ones (w8a8, opt-in)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--no_warmup", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[%(name)s:%(levelname)s] %(message)s")

    buckets = [int(b) for b in args.buckets.split(",")]
    engine = load_engine(args.checkpoint_dir, args.load_no, args.step, buckets=buckets,
                         streaming=args.streaming, max_batch=args.max_batch,
                         batch_window_ms=args.batch_window_ms, quant=args.quant,
                         qmm_mode=args.qmm_mode, device=args.device)
    if not args.no_warmup:
        engine.warmup()
    httpd = serve(engine, args.host, args.port)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down")
        httpd.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
