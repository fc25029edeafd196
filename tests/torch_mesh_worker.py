"""Ranks of the port's CPU mesh tests: one process each, over gloo.

    python tests/torch_mesh_worker.py SPEC.pt RANK

``SPEC.pt`` (``torch.save``) holds ``{"task", "world", "dir", ...}``; the
rank joins a process group through ``file://<dir>/init`` (no ports, so
test workers running side by side never meet), runs the task, and rank 0
saves its result to ``<dir>/result.pt``.  :func:`spawn` starts the ranks
and waits for them with a timeout of its own; a rank that raises or hangs
fails the test.  This module imports no JAX: the tests hold its results
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
               OMP_NUM_THREADS="1")
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
        raise AssertionError(f"{task}: rank {r} exited {rc}:\n{out[-6000:]}")
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

    results = []
    for v in spec["variants"]:
        model = _model(spec, v["parallel"], v)
        shard_model(model, make_mesh(model.cfg.parallel))
        trainer = Trainer(model)
        if v.get("restore"):
            ckpt.restore_checkpoint(v["restore"], 0, model, trainer.opt)
        losses, nrmse = [], []
        for _ in range(v.get("steps", 1)):
            batch = v.get("batch", spec["batch"])
            m = trainer.train_step(shard_batch(batch, model.mesh), v.get("mode", "autoreg"))
            losses.append(m["loss"].item())
            nrmse.append(m["N_RMSE"])
        res = dict(losses=losses, n_rmse=nrmse, grads=_grads(model),
                   params={n: t for n, t in full_state_dict(model).items()
                           if n in model.trainable_names},
                   opt=full_optimizer_state(trainer.opt, model), mesh=model.mesh.shape)
        if v.get("val"):
            res["val"] = trainer.val_step(shard_batch(v.get("batch", spec["batch"]), model.mesh))
        if v.get("save"):
            ckpt.save_checkpoint(v["save"], 0, model, trainer.opt, 0, model.cfg)
        results.append(res)
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


def main() -> None:
    path, rank = sys.argv[1], int(sys.argv[2])
    torch.set_num_threads(1)
    spec = torch.load(path, weights_only=False)
    try:
        if spec["task"] != "entry":  # an entry point starts its own
            start(spec, rank)
        result = globals()[f"task_{spec['task']}"](spec, rank)
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
    if rank == 0:
        torch.save(result, os.path.join(spec["dir"], "result.pt"))


if __name__ == "__main__":
    main()
