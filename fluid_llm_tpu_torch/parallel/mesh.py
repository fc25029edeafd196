"""The rank mesh, and what each rank holds of the batch and the parameters.

Counterpart of ``fluid_llm_tpu/parallel/mesh.py``.  One process drives one
device, so where the JAX package lays devices on a ``jax.sharding.Mesh``
the port lays ranks of ``torch.distributed`` on a grid with the same axis
names ("data", "fsdp", "model", and "pipe" or "expert" last) and makes a
process group for each axis and for "data" with each combination of the
other batch axes, "fsdp" and "expert" (:class:`Mesh`).

The rule that runs through it: a mesh run is the one-process run.  Every
rank builds the same seeded model and global batch and keeps its part
(:func:`shard_model`, :func:`shard_batch`); every reduction is over the
global batch (``comm.batch_sum``), and the gradients are summed over the
ranks that hold a part of them and averaged over those that compute them
whole, so that replicas stay equal (:func:`sync_grads`).  A mesh of one rank
changes nothing.

What a rank holds of each parameter (:func:`param_specs`, the JAX
``backbone_param_specs``/``_fit``/``param_specs`` in the ``nn.Linear``
orientation, ``(out, in)``): the Megatron column split of q/k/v and
fc1/gate/up over "model" (their output features), the row split of o and
fc2/down (their input features), the other dimension of every backbone
matrix over "fsdp" (gathered on use: ``parallel/tensor.full``), int8 ``q``
like its weight and its ``scale`` with the output dimension, the learned
positions' rows over "fsdp"; a MoE expert bank's leading ``E`` axis over
"expert" and its other two dims like the dense linear's (int8 ``q`` and
``scale`` alike; the JAX ``expert_spec``), the router whole; nf4 storage,
norms, the encoder, the decoder, BOS and LoRA replicated; a stacked layer
axis over "pipe".
:func:`placements` is what the port places, which differs where the
computation needs it: an adapter follows its linear's Megatron split
(``models/lora.py``); ``project_in``/``project_out`` (OPT-350m) act
outside the blocks' Megatron pairs and keep their model dimension whole;
under ring attention the model axis carries tokens and the backbone is
whole over it; a pipeline rank holds its stage's blocks only.
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from fluid_llm_tpu_torch.config import ParallelConfig
from fluid_llm_tpu_torch.parallel import comm
from fluid_llm_tpu_torch.parallel.tensor import TP

AXES = ("data", "fsdp", "model")
BATCH_AXES = ("data", "fsdp", "expert")  # the batch rows split over these (those in the mesh)
COL = ("q", "k", "v", "qkv", "fc1", "gate", "up")
ROW = ("o", "fc2", "down")


def mesh_shape(n_devices: int, cfg: Optional[ParallelConfig] = None) -> tuple[int, int, int]:
    """Resolve the (data, fsdp, model) axis sizes for ``n_devices``
    (after the optional ``pipe``/``expert`` axes have been divided out)."""
    cfg = cfg or ParallelConfig()
    model = max(1, cfg.model_axis)
    fsdp = max(1, cfg.fsdp_axis)
    pipe = max(1, cfg.pipe_axis)
    expert = max(1, cfg.expert_axis)
    if pipe > 1 and expert > 1:
        raise ValueError("pipe and expert axes cannot be combined (MoE uses "
                         "the per-layer layout; pipeline uses stacked layers)")
    if n_devices % (pipe * expert) != 0:
        raise ValueError(f"{n_devices} devices not divisible by pipe={pipe} * expert={expert}")
    n_devices //= pipe * expert
    if n_devices % (model * fsdp) != 0:
        raise ValueError(f"{n_devices} devices not divisible by model={model} * fsdp={fsdp}")
    data = n_devices // (model * fsdp) if cfg.data_axis == -1 else cfg.data_axis
    if data * fsdp * model != n_devices:
        raise ValueError(f"mesh {data}x{fsdp}x{model} != {n_devices} devices")
    return data, fsdp, model


def multihost_device_order(devices, data: int, fsdp: int, model: int) -> np.ndarray:
    """Arrange the ranks as a (data, fsdp, model) array such that ``fsdp``
    and ``model`` stay WITHIN a node and only ``data`` spans nodes (the
    gradient all-reduce is the one collective between nodes: the
    reference's DDP topology).  ``devices``: objects with ``process_index``
    (the node) and ``id`` (the rank); :func:`node_ranks` makes them from
    torchrun's ``LOCAL_WORLD_SIZE``.  Pure arithmetic."""
    by_proc: dict[int, list] = {}
    for d in devices:
        by_proc.setdefault(getattr(d, "process_index", 0), []).append(d)
    counts = {len(v) for v in by_proc.values()}
    if len(counts) != 1:
        raise ValueError(f"uneven devices per process: { {k: len(v) for k, v in by_proc.items()} }")
    per = counts.pop()
    n_proc = len(by_proc)
    if (fsdp * model) > per or per % (fsdp * model) != 0:
        raise ValueError(f"fsdp*model={fsdp * model} must divide the {per} devices of each "
                         f"process (model/fsdp collectives must not cross nodes)")
    local_data = per // (fsdp * model)
    if data != n_proc * local_data:
        raise ValueError(f"data axis {data} != n_processes {n_proc} * local data {local_data}")
    arr = np.empty((data, fsdp, model), dtype=object)
    for pi, pidx in enumerate(sorted(by_proc)):
        local = sorted(by_proc[pidx], key=lambda d: getattr(d, "id", 0))
        block = np.empty(len(local), dtype=object)
        block[:] = local
        arr[pi * local_data:(pi + 1) * local_data] = block.reshape(local_data, fsdp, model)
    return arr


class RankSlot:
    """A rank as :func:`multihost_device_order` reads a device."""

    def __init__(self, process_index: int, id: int):
        self.process_index, self.id = process_index, id

    def __repr__(self) -> str:
        return f"node{self.process_index}rank{self.id}"


def node_ranks(world: int, local_world: int) -> list[RankSlot]:
    """The ranks of ``world`` by node: torchrun numbers ranks node by node,
    ``local_world`` to a node (``LOCAL_WORLD_SIZE``)."""
    if world % local_world:
        raise ValueError(f"{world} ranks do not fill nodes of {local_world}")
    return [RankSlot(r // local_world, r) for r in range(world)]


class Mesh:
    """``grid``: the global ranks laid out along ``axis_names``; ``rank``
    this process's; ``batch_axes`` the axes the batch rows split over
    (those of ``BATCH_AXES`` in the mesh, in that order, as the JAX
    ``batch_sharding``); one :class:`comm.Group` per axis and for "data"
    with each combination of the batch axes a tensor may be cut over: the
    groups a gradient is summed over (``shard_model``'s ``grad_axes``), the
    batch axes all together among them (made by every rank, in the same
    order, as ``torch.distributed.new_group`` needs; ``timeout``: their
    collectives' wait, torch's default if None)."""

    def __init__(self, grid: np.ndarray, axis_names: tuple[str, ...], rank: int,
                 backend: Optional[str] = None, timeout: Optional[datetime.timedelta] = None):
        self.grid = np.asarray(grid, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.grid.shape))
        self.rank = rank
        self.coords = dict(zip(self.axis_names, (int(c) for c in np.argwhere(self.grid == rank)[0])))
        self.batch_axes = tuple(a for a in BATCH_AXES if a in self.axis_names)
        cut = self.batch_axes[1:]  # "data" leads: the others may cut a tensor
        joint = [("data",) + tuple(a for i, a in enumerate(cut) if bits >> i & 1)
                 for bits in range(1, 2 ** len(cut))]
        self.timeout = timeout
        self.groups: dict[tuple[str, ...], comm.Group] = {}
        for axes in [(a,) for a in self.axis_names] + joint:
            self.groups[axes] = self._make_group(axes, backend)

    def _make_group(self, axes: tuple[str, ...], backend: Optional[str]) -> comm.Group:
        others = [a for a in self.axis_names if a not in axes]
        perm = [self.axis_names.index(a) for a in others + list(axes)]
        size = math.prod(self.shape[a] for a in axes)
        mine = None
        for row in self.grid.transpose(perm).reshape(-1, size):
            ranks = [int(r) for r in row]
            pg = dist.new_group(ranks, timeout=self.timeout) \
                if size > 1 and dist.is_initialized() else None
            if self.rank in ranks:
                mine = comm.Group(ranks, self.rank, pg, backend)
        return mine

    def group(self, *axes: str) -> comm.Group:
        return self.groups[tuple(axes)]

    def size(self, *axes: str) -> int:
        return math.prod(self.shape.get(a, 1) for a in axes)

    @property
    def batch(self) -> comm.Group:
        return self.groups[self.batch_axes]

    @property
    def world(self) -> int:
        return int(self.grid.size)

    def rows(self, total: int) -> tuple[int, int, int]:
        """``(start, stop, total)``: this rank's rows of a global batch."""
        n = self.batch.size
        if total % n:
            raise ValueError(f"batch {total} not divisible by the {n} ranks of "
                             f"{'*'.join(self.batch_axes)}")
        per = total // n
        return self.batch.index * per, (self.batch.index + 1) * per, total

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords})"


def make_mesh(cfg: Optional[ParallelConfig] = None, world: Optional[int] = None,
              rank: Optional[int] = None, local_world: Optional[int] = None,
              timeout: Optional[datetime.timedelta] = None) -> Mesh:
    """The mesh of ``cfg`` over the ranks of the default process group
    (``world``, ``rank``: given, for a mesh without one; ``local_world``:
    the ranks of a node, default torchrun's ``LOCAL_WORLD_SIZE``, else all;
    ``timeout``: the wait of its groups' collectives, :class:`Mesh`).
    "pipe" is the last axis, so consecutive ranks are consecutive stages;
    so is "expert" (``fluid_llm_tpu/parallel/mesh.py:117-122``), so an
    expert group is consecutive ranks.  Across nodes only "data" may span
    them (:func:`multihost_device_order`); pipe stages and expert groups
    stay within one."""
    cfg = cfg or ParallelConfig()
    if dist.is_initialized():
        world = dist.get_world_size() if world is None else world
        rank = dist.get_rank() if rank is None else rank
        backend = dist.get_backend()
    else:
        world, rank, backend = world or 1, rank or 0, None
    pipe, expert = max(1, cfg.pipe_axis), max(1, cfg.expert_axis)
    data, fsdp, model = mesh_shape(world, cfg)
    local_world = local_world or int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local_world < world:
        if pipe > 1:
            raise NotImplementedError("pipe stages must stay within a host (the hops ride "
                                      "NVLink); use pipe_axis=1 across hosts")
        if expert > 1:
            raise NotImplementedError("expert dispatch all-to-alls must stay within a host "
                                      "(they ride NVLink); use expert_axis=1 across hosts")
        arr = multihost_device_order(node_ranks(world, local_world), data, fsdp, model)
        grid = np.vectorize(lambda d: d.id, otypes=[np.int64])(arr)
        return Mesh(grid, AXES, rank, backend, timeout)
    if pipe > 1:
        return Mesh(np.arange(world).reshape(data, fsdp, model, pipe), AXES + ("pipe",), rank,
                    backend, timeout)
    if expert > 1:
        return Mesh(np.arange(world).reshape(data, fsdp, model, expert), AXES + ("expert",),
                    rank, backend, timeout)
    return Mesh(np.arange(world).reshape(data, fsdp, model), AXES, rank, backend, timeout)


def shard_batch(batch: tuple, mesh: Optional[Mesh]) -> tuple:
    """This rank's contiguous rows of every tensor of the global ``batch``
    (rows over the batch axes jointly: (data, fsdp), and "expert" where the
    mesh has one), the JAX ``shard_batch``'s
    ``make_array_from_process_local_data``."""
    if mesh is None or mesh.batch.size == 1:
        return batch
    start, stop, _ = mesh.rows(batch[0].shape[0])
    return tuple(x[start:stop] for x in batch)


# -- what each rank holds ----------------------------------------------------


def _linear_spec(kind: str, f, m, leaf: str) -> tuple:
    """The spec of one leaf of a linear (``weight``/``q`` (out, in),
    ``bias``/``scale`` (out,), nf4 leaves whole), torch orientation."""
    if leaf in ("weight", "q"):
        spec = (m, f) if kind == "col" else (f, m)
    elif leaf == "bias":
        spec = (m,) if kind == "col" else (None,)
    elif leaf == "scale":
        spec = (m,) if kind == "col" else (f,)
    else:  # nf4 codes and absmax chains: replicated
        spec = ()
    return spec


def param_specs(model: nn.Module, parallel: ParallelConfig) -> dict[str, tuple]:
    """The JAX ``param_specs`` for every tensor of ``model.state_dict()``:
    a tuple with a mesh axis (or None) for each leading dim, in the
    ``nn.Linear`` orientation (the JAX ``P("fsdp", "model")`` of q's
    ``(in, out)`` is ``("model", "fsdp")`` here); dims past the tuple are
    whole."""
    f = "fsdp" if parallel.fsdp_axis > 1 else None
    m = "model" if parallel.model_axis > 1 else None
    e = "expert" if parallel.expert_axis > 1 else None
    lead = "pipe" if parallel.pipe_axis > 1 else None
    specs = {}
    for name, t in model.state_dict().items():
        parts = name.split(".")
        spec: tuple = ()
        if parts[0] == "backbone" and parts[1] == "layers":
            stacked = not parts[2].isdigit()
            rest = parts[2:] if stacked else parts[3:]
            if len(rest) >= 3 and rest[0] in ("attn", "mlp") and rest[1] in COL + ROW:
                spec = _linear_spec("col" if rest[1] in COL else "row", f, m, rest[-1])
            elif len(rest) == 4 and rest[:2] == ["mlp", "experts"] \
                    and rest[-1] in ("weight", "q", "bias", "scale"):
                # an expert bank (E, out, in): E over "expert", the rest as
                # the dense linear's (an nf4 bank would stay whole, as JAX's)
                spec = (e,) + _linear_spec("row" if rest[2] in ROW else "col", f, m, rest[-1])
            if stacked:
                spec = (lead,) + spec
        elif parts[0] == "backbone" and parts[1] == "pos_embed":
            spec = (f,)
        elif parts[0] == "backbone" and parts[1] in ("project_in", "project_out"):
            spec = _linear_spec("col" if parts[1] == "project_in" else "row", f, m, parts[-1])
        specs[name] = tuple(spec)[:t.dim()]
    return specs


def _adapter_specs(model: nn.Module, m) -> dict[str, tuple]:
    """An adapter follows its linear's Megatron split: ``B`` (r, out) and
    ``m`` (out,) cut with a column-parallel target's output rows, ``A``
    (in, r) with a row-parallel one's input rows."""
    out = {}
    for name, _ in model.state_dict().items():
        parts = name.split(".")
        if parts[0] != "lora" or m is None:
            continue
        target, leaf = parts[-2], parts[-1]
        if target in COL:
            out[name] = {"B": (None, m), "m": (m,)}.get(leaf, ())
        elif target in ROW:
            out[name] = {"A": (m, None)}.get(leaf, ())
    return out


def placements(model: nn.Module, parallel: ParallelConfig) -> dict[str, tuple]:
    """What the port places of each tensor (module docstring)."""
    ring = parallel.ring_attention
    m = "model" if parallel.model_axis > 1 and not ring else None
    specs = param_specs(model, parallel)
    out = {}
    for name, spec in specs.items():
        parts = name.split(".")
        if ring or (parts[0] == "backbone" and parts[1] in ("project_in", "project_out")):
            spec = tuple(None if a == "model" else a for a in spec)
        out[name] = spec
    out.update(_adapter_specs(model, m))
    return out


def _owner(model: nn.Module, name: str) -> tuple[nn.Module, str]:
    *path, leaf = name.split(".")
    return model.get_submodule(".".join(path)), leaf


def _check_heads(bcfg, m: int) -> None:
    if bcfg.n_heads % m or bcfg.kv_heads % m:
        raise ValueError(f"n_heads={bcfg.n_heads} and n_kv_heads={bcfg.kv_heads} must divide "
                         f"evenly over parallel.model_axis={m} (attention heads shard over the "
                         "model axis)")
    if bcfg.d_ff % m:
        raise ValueError(f"d_ff={bcfg.d_ff} must divide evenly over parallel.model_axis={m}")


@torch.no_grad()
def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Cut ``model`` (a ``FluidLLM`` built whole, as one process builds it)
    to what this rank holds, in place, and mark it (``parallel/tensor.py``,
    ``Backbone.parallel``, ``model.mesh``).  A mesh of one rank leaves every
    tensor whole."""
    from fluid_llm_tpu_torch.models.backbone import BackboneParallel, MoEMLP
    from fluid_llm_tpu_torch.ops import quant_matmul as qmm
    from fluid_llm_tpu_torch.ops.quant import NF4Linear, QuantLinear
    from fluid_llm_tpu_torch.parallel.pipeline import (Elsewhere, Stages, check_stackable,
                                                        stage_layers)

    par = model.cfg.parallel
    bb = model.backbone
    bcfg = bb.cfg
    m = mesh.size("model")
    ring = par.ring_attention and m > 1
    tp = m > 1 and not ring
    if par.ring_attention and not (par.seq_sharded_acts and m > 1):
        raise ValueError("parallel.ring_attention needs tokens sharded over the model axis: "
                         "set seq_sharded_acts: true and model_axis > 1")
    if tp:
        _check_heads(bcfg, m)
    model.trainable_names = [n for n, p in model.named_parameters() if p.requires_grad]
    model.full_shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}

    specs = placements(model, par)
    for name, spec in specs.items():
        axes = [(d, a) for d, a in enumerate(spec) if a is not None and mesh.size(a) > 1]
        if not axes:
            continue
        mod, leaf = _owner(model, name)
        t = getattr(mod, leaf)
        marks = []
        for d, a in axes:
            g = mesh.group(a)
            t = comm.chunk(t, g, d)
            marks.append((d, a, g))
        t = t.contiguous().clone()
        if leaf in mod._parameters:
            mod._parameters[leaf].data = t
        else:
            mod._buffers[leaf] = t
        mod.shards = {**getattr(mod, "shards", {}), leaf: tuple(marks)}

    lcfg = bcfg
    if tp:
        g = mesh.group("model")
        lcfg = bcfg.replace(n_heads=bcfg.n_heads // m, n_kv_heads=bcfg.kv_heads // m,
                            d_model=bcfg.d_model // m, d_ff=bcfg.d_ff // m)
        for layer in bb.layers:
            if isinstance(layer.mlp, MoEMLP):  # a bank's Megatron pair is in moe_mlp
                for name, bank in layer.mlp.experts.items():
                    bank.tp = TP("col" if name in COL else "row", g)
            for group in ("attn", "mlp"):
                if isinstance(getattr(layer, group), MoEMLP):
                    continue
                for name, lin in getattr(layer, group).items():
                    kind = "col" if name in COL else "row"
                    lin.tp = TP(kind, g, narrow=isinstance(lin, NF4Linear))
                    if isinstance(lin, (nn.Linear, QuantLinear)):
                        full_sup = isinstance(lin, QuantLinear) and qmm.supported(
                            lin.in_features, lin.out_features)
                        if kind == "col":
                            lin.out_features //= m
                        else:
                            lin.in_features //= m
                        if full_sup and not qmm.supported(lin.in_features, lin.out_features):
                            raise ValueError(
                                f"int8 {group}.{name}: the w8a16 kernel takes the whole "
                                f"({lin.out_features * (m if kind == 'col' else 1)}, "
                                f"{lin.in_features * (m if kind == 'row' else 1)}) weight but "
                                f"not this rank's ({lin.out_features}, {lin.in_features})")
    pipe = None
    if mesh.size("pipe") > 1:
        check_stackable(bb)
        pg = mesh.group("pipe")
        own = stage_layers(bcfg.n_layers, pg.size, pg.index)
        for i in range(bcfg.n_layers):
            if i not in own:
                bb.layers[i] = Elsewhere()
        pipe = Stages(pg, own, par.pipe_microbatches)
    if mesh.size("expert") > 1:  # the all-to-all of moe_mlp
        for layer in bb.layers:
            if isinstance(layer.mlp, MoEMLP):
                layer.mlp.ep = mesh.group("expert")
    seq = mesh.group("model") if par.seq_sharded_acts and m > 1 else None
    bb.parallel = BackboneParallel(cfg=lcfg, seq=seq, ring=ring, pipe=pipe)

    model.grad_axes = {}
    for name, p in model.named_parameters():
        spec = specs.get(name, ())
        # (axes, mean): summed over the batch axes but those that cut the
        # tensor (an fsdp chunk's gradient comes reduce-scattered over
        # "fsdp"; an expert bank's holds every token its expert group sent
        # it, so it is not summed over "expert"); summed over "model" where
        # each model rank holds a part, averaged where each computed it whole
        # (replicas kept equal bit for bit though a kernel sums in another
        # order on each); averaged over "pipe" outside the stages
        axes = [(tuple(a for a in mesh.batch_axes if a not in spec), False)]
        if "model" not in spec:
            axes.append((("model",), not _partial_over_model(name, par, ring, tp)))
        if pipe is not None and not name.startswith("backbone.layers."):
            axes.append((("pipe",), True))
        model.grad_axes[name] = tuple(a for a in axes if mesh.size(*a[0]) > 1)
        p.mesh_dims = {d: mesh.group(a) for d, a in enumerate(spec)
                       if a is not None and mesh.size(a) > 1}
        p.full_shape = model.full_shapes[name]
    model.mesh = mesh
    return model


def _partial_over_model(name: str, par: ParallelConfig, ring: bool, tp: bool) -> bool:
    """Whether each model rank's gradient of ``name`` holds only its part
    (its tokens or its output rows), so that they sum over the axis."""
    parts = name.split(".")
    if ring:  # tokens over the model axis: every block and adapter
        return parts[0] == "lora" or (parts[0] == "backbone" and parts[1] == "layers")
    if not tp:
        return False
    if parts[0] == "lora":
        target, leaf = parts[-2], parts[-1]
        return (target in COL and leaf == "A") or (target in ROW and leaf == "B")
    if par.seq_sharded_acts and parts[0] == "backbone" and parts[1] == "layers":
        # the norms and the row-parallel biases act on this rank's tokens
        return parts[3] in ("ln1", "ln2") or (parts[4] in ROW and parts[-1] == "bias")
    return False


def sync_grads(model: nn.Module) -> None:
    """Reduce each trainable gradient over the ranks that share it
    (``model.grad_axes``): summed where they hold parts of it, averaged
    where each computed it whole; one all-reduce per axis and bucket."""
    mesh = getattr(model, "mesh", None)
    if mesh is None:
        return
    buckets: dict[Any, list[torch.Tensor]] = {}
    for name, p in model.named_parameters():
        if p.grad is not None and model.grad_axes.get(name):
            buckets.setdefault((model.grad_axes[name], p.grad.dtype), []).append(p.grad)
    for (axes, _), grads in buckets.items():
        flat = torch.cat([g.reshape(-1) for g in grads])
        for a, mean in axes:
            flat = comm.all_reduce(flat, mesh.group(*a))
            if mean:
                flat = flat / mesh.size(*a)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


# -- whole tensors back (checkpoints) ---------------------------------------


def full_tensor(mod: nn.Module, leaf: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` (``mod.leaf`` or a tensor cut like it) with every chunk gathered."""
    for d, _, g in reversed(getattr(mod, "shards", {}).get(leaf, ())):
        t = comm.all_gather(t.contiguous(), g, d)
    return t


def local_tensor(mod: nn.Module, leaf: str, t: torch.Tensor) -> torch.Tensor:
    """This rank's chunk of a whole tensor ``t`` of ``mod.leaf``."""
    for d, _, g in getattr(mod, "shards", {}).get(leaf, ()):
        t = comm.chunk(t, g, d)
    return t.contiguous()


def local_state_dict(model: nn.Module, full: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A one-process ``state_dict`` cut to what this rank of a sharded
    ``model`` holds (the blocks of other pipeline stages left out)."""
    out = {}
    for name in model.state_dict():
        mod, leaf = _owner(model, name)
        out[name] = local_tensor(mod, leaf, full[name])
    return out


def _pipe_join(mesh: Mesh, mine: dict) -> dict:
    """Every pipe rank's entries joined (on every pipe rank)."""
    if mesh.size("pipe") == 1:
        return mine
    g = mesh.group("pipe")
    parts = [None] * g.size
    dist.all_gather_object(parts, {k: v.cpu() for k, v in mine.items()}, group=g.pg)
    out = {}
    for part in parts:
        out.update(part)
    return out


def full_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """The one-process ``state_dict`` of a sharded ``model``, on every rank
    (collectives: call on every rank)."""
    mesh = model.mesh
    out = {}
    for name, t in model.state_dict().items():
        mod, leaf = _owner(model, name)
        out[name] = full_tensor(mod, leaf, t)
    if mesh.size("pipe") > 1:
        device = next(iter(out.values())).device
        out = {k: v.to(device) for k, v in _pipe_join(mesh, out).items()}
        out = {n: out[n] for n in model.full_shapes}
    return out


def _state_dims(key: str, p: torch.nn.Parameter, s: torch.Tensor) -> dict:
    """The cut dims of optimizer state ``s`` of parameter ``p`` (``s``
    whole or this rank's chunk): like the parameter's, or for Adafactor's
    factored ``v_row``/``v_col`` (one dim of the parameter reduced) shifted
    past it."""
    if s.dim() == 0 or not p.mesh_dims:
        return {}
    if s.dim() == p.dim():
        return dict(p.mesh_dims)
    from fluid_llm_tpu_torch.train.optim import factored_dims

    d1, d0 = factored_dims(torch.Size(p.full_shape))
    gone = d0 if key == "v_row" else d1  # v_row = mean over d0, v_col over d1
    return {d - (d > gone): g for d, g in p.mesh_dims.items() if d != gone}


def _inner(opt):
    return getattr(opt, "inner", opt)


def full_optimizer_state(opt, model: nn.Module) -> dict:
    """The one-process ``optimizer.state_dict()`` of an optimizer over a
    sharded model's parameters: every state tensor gathered, indexed in the
    one-process order of the trainable parameters (``model.trainable_names``)."""
    mesh = model.mesh
    inner = _inner(opt)
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for group in inner.param_groups for p in group["params"]]
    local = inner.state_dict()
    mine = {}
    for i, p in enumerate(params):
        st = {}
        for key, s in local["state"].get(i, {}).items():
            for d, g in sorted(_state_dims(key, p, s).items(), reverse=True):
                s = comm.all_gather(s.contiguous(), g, d)
            st[key] = s
        mine[names[id(p)]] = st
    if inner is not opt:  # MultiSteps: its running means too
        for p, acc in zip(params, opt.acc):
            for d, g in sorted(p.mesh_dims.items(), reverse=True):
                acc = comm.all_gather(acc.contiguous(), g, d)
            mine[names[id(p)]]["__acc__"] = acc
    if mesh.size("pipe") > 1:
        g = mesh.group("pipe")
        parts = [None] * g.size
        dist.all_gather_object(parts, {n: {k: v.cpu() for k, v in st.items()}
                                       for n, st in mine.items()}, group=g.pg)
        for part in parts:
            for n, st in part.items():
                mine.setdefault(n, st)
    trainable = model.trainable_names
    state = {}
    for i, n in enumerate(trainable):
        st = {k: v for k, v in mine[n].items() if k != "__acc__"}
        if st:
            state[i] = st
    groups = [{**{k: v for k, v in local["param_groups"][0].items() if k != "params"},
               "params": list(range(len(trainable)))}]
    sd = {"state": state, "param_groups": groups}
    if inner is not opt:
        return {"inner": sd, "mini_step": opt.mini_step,
                "acc": [mine[n]["__acc__"] for n in trainable]}
    return sd


def load_optimizer_state(opt, model: nn.Module, sd: dict) -> None:
    """Load a one-process optimizer state dict (:func:`full_optimizer_state`,
    or a one-process run's) into an optimizer over ``model``'s sharded
    parameters: each state tensor cut like its parameter."""
    inner = _inner(opt)
    inner_sd = sd["inner"] if inner is not opt else sd
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for group in inner.param_groups for p in group["params"]]
    index = {n: i for i, n in enumerate(model.trainable_names)}
    state = {}
    for i, p in enumerate(params):
        st = inner_sd["state"].get(index[names[id(p)]], {})
        cut = {}
        for key, s in st.items():
            if torch.is_tensor(s):
                for d, g in _state_dims(key, p, s).items():
                    s = comm.chunk(s, g, d)
                s = s.contiguous()
            cut[key] = s
        if cut:
            state[i] = cut
    groups = [{**{k: v for k, v in inner_sd["param_groups"][0].items() if k != "params"},
               "params": list(range(len(params)))}]
    local = {"state": state, "param_groups": groups}
    if inner is not opt:
        accs = []
        for p in params:
            acc = sd["acc"][index[names[id(p)]]]
            for d, g in p.mesh_dims.items():
                acc = comm.chunk(acc, g, d)
            accs.append(acc.contiguous())
        opt.load_state_dict({"inner": local, "mini_step": sd["mini_step"], "acc": accs})
    else:
        inner.load_state_dict(local)

