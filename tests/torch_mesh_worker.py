"""Ranks of the port's CPU mesh tests: one process each, over gloo.

    python tests/torch_mesh_worker.py SPEC.pt RANK

``SPEC.pt`` (``torch.save``) holds ``{"task", "world", "dir", ...}``; the
rank joins a process group through ``file://<dir>/init`` (no ports, so
test workers running side by side never meet), runs the task, and rank 0
saves its result to ``<dir>/result.pt``; then every rank meets the others
at a barrier and destroys its process group (:func:`finish`) before it
exits.  :func:`spawn` starts the ranks and waits for them with a timeout
of its own; a rank that raises, aborts or hangs fails the test, with the
first bad rank's output, every rank's exit code and whether ``result.pt``
was saved.  This module imports no JAX: the tests hold its results
against the JAX package in their own process.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import traceback

import torch

WORKER = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(WORKER))


def spawn(task: str, world: int, tmp_dir: str, timeout: float = 300.0, **spec) -> dict:
    """Run ``task`` on ``world`` ranks; rank 0's result.  ``timeout``: the
    join's, for all the ranks' work (a spawn runs every mesh of a test file,
    ~40 s on 8 idle cores; the suite runs 6 test workers beside it)."""
    os.makedirs(tmp_dir, exist_ok=True)
    path = os.path.join(tmp_dir, "spec.pt")
    torch.save({"task": task, "world": world, "dir": tmp_dir, **spec}, path)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", PYTHONFAULTHANDLER="1")  # a rank that aborts shows its stacks
    procs = [subprocess.Popen([sys.executable, WORKER, path, str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"{task}: a rank did not finish within {timeout} s")
    bad = [(r, p.returncode, o) for r, (p, o) in enumerate(zip(procs, outs)) if p.returncode]
    if bad:
        r, rc, out = bad[0]
        done = os.path.exists(os.path.join(tmp_dir, "result.pt"))
        raise AssertionError(f"{task}: rank {r} exited {rc} (ranks' codes "
                             f"{[p.returncode for p in procs]}, result.pt saved: {done}):\n"
                             f"{out[-6000:]}")
    return torch.load(os.path.join(tmp_dir, "result.pt"), weights_only=False)


def start(spec: dict, rank: int) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{spec['dir']}/init",
                            world_size=spec["world"], rank=rank,
                            timeout=datetime.timedelta(seconds=120))  # a collective's wait


# -- tasks ----------------------------------------------------------------------


def _model(spec: dict, parallel: dict, v: dict | None = None):
    """The model of ``spec`` (``cfg``, ``tiny``, ``state``), each
    replaced or updated by the variant ``v``'s, on the mesh ``parallel``."""
    from fluid_llm_tpu_torch.config import Config
    from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
    from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM

    v = v or {}
    cfg = Config(**{**spec["cfg"], **v.get("cfg", {}), "parallel": parallel})
    props = SyntheticCylinderDataset(n_trajectories=1, resolution=64,
                                     seq_len=cfg.autoreg_seq_len).ds_props()
    model = FluidLLM.build(cfg, props, **{**spec["tiny"], **v.get("tiny", {})})
    keys = model.state_dict().keys()  # a full fine-tune has no adapters
    model.load_state_dict({k: t for k, t in v.get("state", spec["state"]).items() if k in keys})
    if v.get("quant"):  # the frozen backbone stored quantized, from those weights
        from fluid_llm_tpu_torch.ops.quant import quantize_backbone

        quantize_backbone(model.backbone, v["quant"])
    return model


def _grads(model) -> dict:
    from fluid_llm_tpu_torch.parallel.mesh import _owner, _pipe_join, full_tensor

    out = {}
    for name, p in model.named_parameters():
        if p.grad is not None:
            mod, leaf = _owner(model, name)
            out[name] = full_tensor(mod, leaf, p.grad)
    return _pipe_join(model.mesh, out)


def task_steps(spec: dict, rank: int) -> dict:
    """Each variant: the model on its mesh, ``steps`` train steps on the
    batch; the losses, N-RMSE, the last step's gradients, the trainable
    parameters and the optimizer state, gathered whole.  A variant with
    ``save``: a checkpoint after its steps; with ``restore``: its model
    and optimizer restored from one first."""
    from fluid_llm_tpu_torch.parallel.mesh import (full_optimizer_state, full_state_dict,
                                                    make_mesh, shard_batch, shard_model)
    from fluid_llm_tpu_torch.train import checkpoint as ckpt
    from fluid_llm_tpu_torch.train.trainer import Trainer

    import torch.distributed as dist

    results = []
    for v in spec["variants"]:
        model = _model(spec, v["parallel"], v)
        shard_model(model, make_mesh(model.cfg.parallel))
        trainer = Trainer(model)
        if v.get("restore"):
            ckpt.restore_checkpoint(v["restore"], 0, model, trainer.opt)
        losses, nrmse, aux = [], [], []
        for _ in range(v.get("steps", 1)):
            batch = v.get("batch", spec["batch"])
            m = trainer.train_step(shard_batch(batch, model.mesh), v.get("mode", "autoreg"))
            losses.append(m["loss"].item())
            nrmse.append(m["N_RMSE"])
            if "moe_aux" in m:
                aux.append(m["moe_aux"].item())
        res = dict(losses=losses, n_rmse=nrmse, aux=aux, grads=_grads(model),
                   params={n: t for n, t in full_state_dict(model).items()
                           if n in model.trainable_names},
                   opt=full_optimizer_state(trainer.opt, model), mesh=model.mesh.shape)
        banks = {n: tuple(t.shape) for n, t in model.state_dict().items() if ".experts." in n}
        if banks:  # what each rank's expert banks hold
            res["held"] = [None] * dist.get_world_size()
            dist.all_gather_object(res["held"], (model.mesh.coords, banks))
        if v.get("val"):
            res["val"] = trainer.val_step(shard_batch(v.get("batch", spec["batch"]), model.mesh))
        if v.get("save"):
            ckpt.save_checkpoint(v["save"], 0, model, trainer.opt, 0, model.cfg)
        results.append(res)
    return results


QUANT_LEAVES = ("q", "scale", "codes", "absmax_q", "absmax_scale", "absmax_offset")


def task_forward(spec: dict, rank: int) -> list:
    """Each variant: the model on its mesh (``quant``: stored so before it
    is cut; ``prepare``: then served as ``prepare_inference_params(prepare)``
    prepares it, merge, quantize, cut), its forward over this rank's rows
    of the batch (``stream``: that many steps of the streaming rollout
    instead, from one state), every row gathered; the quantized storage of
    every rank with its mesh coordinates, and each rank's blocks and (when
    streaming) its cache's layers."""
    import torch.distributed as dist

    from fluid_llm_tpu_torch.parallel import comm
    from fluid_llm_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_model
    from fluid_llm_tpu_torch.models.backbone import own_layers
    from fluid_llm_tpu_torch.rollout.streaming import gen_seq_streaming, streaming_cache

    results = []
    for v in spec["variants"]:
        model = _model(spec, v["parallel"], v)
        shard_model(model, make_mesh(model.cfg.parallel))
        if "prepare" in v:
            model.prepare_inference_params(v["prepare"])
        model.eval()
        batch = shard_batch(v.get("batch", spec["batch"]), model.mesh)
        with torch.no_grad():
            if v.get("stream"):
                y = gen_seq_streaming(model, batch, v["stream"])[0]
            else:
                y = model.forward(batch[0], batch[4])
        with comm.batch_axes(model.mesh.batch):
            y = comm.batch_rows(y)
        storage = {n: t.clone() for n, t in model.state_dict().items()
                   if n.rsplit(".", 1)[-1] in QUANT_LEAVES}
        held = [None] * dist.get_world_size()
        dist.all_gather_object(held, (model.mesh.coords, storage))
        blocks = [None] * dist.get_world_size()  # each rank's blocks and its cache's layers
        cache = streaming_cache(model, batch[0][:, :1]) if v.get("stream") else None
        dist.all_gather_object(blocks, (model.mesh.coords, len(own_layers(model.backbone)),
                                        None if cache is None else cache["k"].shape[0]))
        results.append(dict(out=y, held=held, mesh=model.mesh.shape, blocks=blocks,
                            heads=model.backbone.parallel.cfg.n_heads))
    return results


def _client(spec: dict, results: list) -> None:
    """Rank 0's client of the daemon it runs: wait for ``/healthz``, read
    ``/v1/info``, post each request of ``spec["requests"]`` (its status,
    reply and seconds kept), then interrupt the daemon (its stop reaches
    every rank); with ``spec["down"]``, wait instead for the daemon to stop
    answering (the seconds that took kept)."""
    import json
    import signal
    import time
    import urllib.error
    import urllib.request

    base = f"http://127.0.0.1:{spec['port']}"

    def alive() -> bool:
        try:
            urllib.request.urlopen(base + "/healthz", timeout=5).read()
            return True
        except OSError:
            return False

    try:
        deadline = time.monotonic() + 120
        while not alive():
            if time.monotonic() > deadline:
                raise TimeoutError("the daemon did not answer /healthz")
            time.sleep(0.2)
        results.append(("info", 200, json.loads(urllib.request.urlopen(base + "/v1/info").read())))
        for body in spec["requests"]:
            req = urllib.request.Request(base + "/v1/rollout", data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            t0 = time.monotonic()
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    results.append(("rollout", r.status, json.loads(r.read()),
                                    time.monotonic() - t0))
            except urllib.error.HTTPError as e:
                results.append(("rollout", e.code, json.loads(e.read()), time.monotonic() - t0))
        if spec.get("down"):
            t0 = time.monotonic()
            while alive() and time.monotonic() < t0 + 120:
                time.sleep(0.2)
            results.append(("gone", not alive(), time.monotonic() - t0))
    finally:
        if not spec.get("down"):
            signal.raise_signal(signal.SIGINT)


def task_serve(spec: dict, rank: int) -> list:
    """``python -m fluid_llm_tpu_torch.tools.serve`` with ``--distributed``
    and the three flags: rank 0 answers :func:`_client` (its results are the
    task's); on the other ranks the ``fail_at``-th rollout fails where
    ``spec["fail_in"]`` says: "place" (its batch does not reach the device,
    the default) or "rollout" (an error raised inside the rollout, before
    its first collective).  With ``spec["down"]`` every rank expects the
    daemon's error: rank 0 adds it to its results, the others write it to
    ``<dir>/down_<rank>.txt``."""
    import threading

    from fluid_llm_tpu_torch.tools import serve

    if rank != 0:
        calls = []
        name = {"place": "_place", "rollout": "_rollout_host"}[spec.get("fail_in", "place")]
        inner = getattr(serve.RolloutEngine, name)

        def failing(self, *a, **kw):
            calls.append(1)
            if len(calls) == spec["fail_at"]:
                raise RuntimeError(f"{name} failed on this rank (a test's fault)")
            return inner(self, *a, **kw)

        setattr(serve.RolloutEngine, name, failing)
    results: list = []
    client = threading.Thread(target=_client, args=(spec, results), daemon=True)
    if rank == 0:
        client.start()
    argv = spec["argv"] + ["--port", str(spec["port"]), "--distributed",
                           "--coordinator_address", f"file://{spec['dir']}/init",
                           "--num_processes", str(spec["world"]), "--process_id", str(rank),
                           "--device", "cpu"]
    try:
        serve.main(argv)
    except RuntimeError as e:
        if not spec.get("down") or "every rank stops" not in str(e):
            raise
        if rank == 0:
            client.join(150)  # the client's entries first: its requests, then the daemon gone
            results.append(("down", str(e)))
        else:
            with open(os.path.join(spec["dir"], f"down_{rank}.txt"), "w") as f:
                f.write(str(e))
    if rank == 0:
        client.join(150)
    return results


def task_train_run(spec: dict, rank: int) -> list:
    """``train_run`` for ``cfg``'s epochs on the synthetic dataset: the logs."""
    from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
    from fluid_llm_tpu_torch.parallel.mesh import make_mesh, shard_model
    from fluid_llm_tpu_torch.train.loop import train_run
    from fluid_llm_tpu_torch.train.trainer import Trainer

    model = _model(spec, spec["parallel"])
    shard_model(model, make_mesh(model.cfg.parallel))
    ds = SyntheticCylinderDataset(n_trajectories=8, resolution=64,
                                  seq_len=model.cfg.autoreg_seq_len, mode="valid")
    logs = []
    train_run(model.cfg, Trainer(model), ds, ds, log_fn=lambda m, e: logs.append(m))
    return logs


def _stage(cfg, state, n_pipe: int, n_mb: int):
    """A bare backbone as this rank's pipeline stage over ``n_pipe``."""
    from fluid_llm_tpu_torch.config import ParallelConfig
    from fluid_llm_tpu_torch.models import backbone as bb
    from fluid_llm_tpu_torch.parallel.mesh import make_mesh
    from fluid_llm_tpu_torch.parallel.pipeline import Elsewhere, Stages, stage_layers

    g = make_mesh(ParallelConfig(pipe_axis=n_pipe)).group("pipe")
    stage = bb.Backbone(cfg)
    stage.load_state_dict(state)
    own = stage_layers(cfg.n_layers, g.size, g.index)
    for i in range(cfg.n_layers):
        if i not in own:
            stage.layers[i] = Elsewhere()
    stage.parallel = bb.BackboneParallel(cfg=cfg, pipe=Stages(g, own, n_mb))
    return stage, g


def task_backbone(spec: dict, rank: int) -> dict:
    """A bare backbone as a pipeline (``pipes``: (stages, microbatches)),
    its output and the gradients of ``sum(out * cot)`` (layers, input),
    gathered whole; ``bf16``: a bf16 pipeline's forward and backward, whether
    finite; ``ring``: ring attention's output and the gradients of a masked
    quadratic loss over the model axis of every rank; ``uneven``: the
    refusal of a token count the ring does not divide."""
    import torch.distributed as dist

    from fluid_llm_tpu_torch.config import ParallelConfig
    from fluid_llm_tpu_torch.models import backbone as bb
    from fluid_llm_tpu_torch.parallel import comm
    from fluid_llm_tpu_torch.parallel.mesh import make_mesh

    out_all = {}
    cfg = bb.BackboneConfig(**spec["bcfg"])
    for n_pipe, n_mb in spec.get("pipes", ()):
        stage, g = _stage(cfg, spec["state"], n_pipe, n_mb)
        xx = spec["x"].clone().requires_grad_(True)
        out = stage(xx, spec["valid"], kernels=False)
        (out * spec["cot"]).sum().backward()
        grads = {n: p.grad for n, p in stage.named_parameters() if p.grad is not None}
        parts = [None] * g.size
        dist.all_gather_object(parts, grads, group=g.pg)
        joined = {}
        for part in parts:
            joined.update(part)
        out_all[(n_pipe, n_mb)] = dict(out=out.detach(), grads=joined, dx=xx.grad)
    if spec.get("bf16"):
        b = spec["bf16"]
        stage, _ = _stage(bb.BackboneConfig(**b["bcfg"]), b["state"], 2, 2)
        out = stage(b["x"], None, kernels=False)
        (out.float() ** 2).sum().backward()
        out_all["bf16"] = bool(torch.isfinite(out.float()).all()) and all(
            bool(torch.isfinite(p.grad.float()).all()) for p in stage.parameters()
            if p.grad is not None)
    if spec.get("ring"):
        from fluid_llm_tpu_torch.parallel.ring_attention import ring_attention

        g = make_mesh(ParallelConfig(model_axis=spec["world"])).group("model")
        ring = {}
        for name, (q, k, v, valid, w) in spec["ring"].items():
            qkv = [comm.chunk(t, g, 1).detach().clone().requires_grad_(True) for t in (q, k, v)]
            out = ring_attention(*qkv, comm.chunk(valid, g, 1), g)
            ((out * comm.chunk(w, g, 1)) ** 2).sum().backward()
            ring[name] = dict(out=comm.all_gather(out.detach(), g, 1),
                              grads=[comm.all_gather(t.grad, g, 1) for t in qkv])
        try:
            ring_attention(*(comm.chunk(t, g, 1) for t in spec["uneven"]), None, g)
        except ValueError as e:  # the refusal is the result
            ring["uneven"] = str(e)
        out_all["ring"] = ring
    return out_all


def task_jobs(spec: dict, rank: int) -> list:
    """Several tasks in one process group: ``jobs`` a list of
    ``(task, spec)``; their results in order."""
    return [globals()[f"task_{task}"]({**spec, **sub}, rank) for task, sub in spec["jobs"]]


def task_entry(spec: dict, rank: int):
    """An entry point's ``main`` with ``--distributed`` and the three flags."""
    import importlib

    mod = importlib.import_module(f"fluid_llm_tpu_torch.{spec['entry']}")
    argv = spec["argv"] + ["--distributed", "--coordinator_address",
                           f"file://{spec['dir']}/init", "--num_processes", str(spec["world"]),
                           "--process_id", str(rank), "--device", "cpu"]
    return mod.main(argv)


def finish() -> None:
    """Every rank past its last collective, then every group torn down.  A
    gloo worker thread may still hold a finished collective's tensors when
    its rank's ``wait`` returns; should that rank's interpreter already be
    shutting down when the thread lets them go, freeing their Python objects
    takes the GIL after finalisation, and the process aborts with
    "terminate called without an active exception".  Destroying the groups
    joins those threads while the interpreter is alive."""
    import torch.distributed as dist

    if dist.is_initialized():  # an entry point has torn down its own
        dist.barrier()
        dist.destroy_process_group()


def main() -> None:
    path, rank = sys.argv[1], int(sys.argv[2])
    torch.set_num_threads(1)
    spec = torch.load(path, weights_only=False)
    try:
        if spec["task"] not in ("entry", "serve"):  # an entry point starts its own
            start(spec, rank)
        result = globals()[f"task_{spec['task']}"](spec, rank)
        if rank == 0:
            torch.save(result, os.path.join(spec["dir"], "result.pt"))
        finish()
    except BaseException:
        traceback.print_exc()
        sys.exit(1)


if __name__ == "__main__":
    main()
