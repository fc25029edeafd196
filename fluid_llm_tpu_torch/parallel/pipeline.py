"""GPipe pipeline parallelism over the ``pipe`` mesh axis.

Counterpart of ``fluid_llm_tpu/parallel/pipeline.py``.  The backbone's
blocks split into ``S = pipe_axis`` contiguous stages; pipe rank ``s``
holds the blocks of stage ``s`` only (``parallel.mesh.shard_model`` puts a
:class:`Elsewhere` in the others' places).  The schedule streams ``M``
microbatches (``pipe_microbatches``, default ``2 S``) through the stages:
stage ``s`` works on microbatch ``j`` at tick ``s + j`` of ``M + S - 1``,
receiving its input from stage ``s - 1`` and handing its output to stage
``s + 1`` by one point-to-point hop a tick (``comm.send``/``comm.recv``);
the last stage's outputs are then broadcast to every pipe rank (JAX sums
them in f32, ``:166-174``).  The work before the stages (``project_in``,
the learned positions) and after them (final norm, ``project_out``, the
decoder and the loss) runs on every pipe rank alike.

JAX gets the backward from ``ppermute``'s transpose; here
:class:`_Pipeline` writes it out: the mirrored schedule, the last stage
starting from its own gradient of the outputs (each pipe rank's is the
same, as every rank computes the same loss: summing them would make it
``S`` times too large), each stage's input gradient sent back to the
previous stage, and stage 0's broadcast to every pipe rank for the
replicated work before the stages.  With ``remat`` a stage keeps only its
inputs and recomputes its blocks in the backward.

The JAX guards, with their messages: LoRA trees and in-backbone dropout
refused (``Backbone._pipelined``, ``fluid_llm.py:160-165, 254-264``);
layers not divisible by stages, batch not divisible by microbatches
(``:85-96``); MoE (``config.check_moe``); layers that do not stack
(``main.py:112-124``, :func:`check_stackable`).  The port's stacked layout
holds no gradient, so a stage keeps its blocks as modules; a layer list
that would not stack is refused all the same.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from fluid_llm_tpu_torch.parallel import comm


class Elsewhere(nn.Module):
    """The place of a block another pipe rank holds."""

    def forward(self, *args, **kwargs):
        raise RuntimeError("this block belongs to another pipeline stage")


def stage_layers(n_layers: int, n_stages: int, stage: int) -> range:
    """The blocks of ``stage``: a contiguous run of ``n_layers / n_stages``."""
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible by {n_stages} stages")
    per = n_layers // n_stages
    return range(stage * per, (stage + 1) * per)


def check_stackable(backbone: nn.Module) -> None:
    """JAX restacks the layers after the import and quantization and
    refuses a list that will not stack (``main.py:112-124``): the same
    structure test as ``backbone.stack_layers``."""
    from fluid_llm_tpu_torch.models.backbone import StackedLayers

    layers = backbone.layers
    if isinstance(layers, StackedLayers):
        return

    def structure(layer):
        return ([(n, type(m), getattr(m, "mode", None)) for n, m in layer.named_modules()],
                [(n, p.shape, p.dtype) for n, p in layer.named_parameters()],
                [(n, b.shape, b.dtype) for n, b in layer.named_buffers()])

    if any(structure(m) != structure(layers[0]) for m in layers[1:]):
        raise ValueError("pipeline parallelism needs homogeneous stackable layers: the "
                         "loaded/quantized backbone could not be stacked (quantized storage "
                         "with mixed shapes does not stack; serve quantized models without "
                         "pipe_axis)")


class Stages:
    """This rank's stage: ``group`` the pipe axis, ``layers`` the indices of
    its blocks, ``n_microbatches`` (0: ``2 S``)."""

    def __init__(self, group: comm.Group, layers: range, n_microbatches: int = 0):
        self.group, self.layers = group, layers
        self.n_microbatches = n_microbatches or 2 * group.size

    def microbatches(self, bs: int) -> int:
        M = self.n_microbatches
        if bs % M == 0:
            return M
        if torch.is_grad_enabled():
            raise ValueError(f"batch {bs} not divisible by {M} microbatches")
        return math.gcd(bs, M)  # a rollout's batch of one: its rows whole

    def apply(self, backbone, x: torch.Tensor, valid: torch.Tensor, kernels: bool,
              remat: bool) -> torch.Tensor:
        """The blocks over ``x`` (bs, L, d), every pipe rank's result the
        last stage's."""
        M = self.microbatches(x.shape[0])
        run = _StageRun(backbone, self.layers, valid, M, kernels)
        if not torch.is_grad_enabled():
            return _schedule(x, run, self.group, M, keep=False)[0]
        params = [p for i in self.layers for p in backbone.layers[i].parameters()
                  if p.requires_grad]
        return _Pipeline.apply(x, run, self.group, M, remat, *params)


class _StageRun:
    """The stage's blocks on microbatch ``j``'s rows."""

    def __init__(self, backbone, layers: range, valid: torch.Tensor, M: int, kernels: bool):
        from fluid_llm_tpu_torch.models.backbone import make_masks, rope_tables

        self.backbone, self.layers, self.kernels = backbone, layers, kernels
        cfg = backbone.cfg
        positions, _ = make_masks(valid)
        self.valid = valid.to(torch.int32).contiguous().chunk(M)
        self.rope = None
        if cfg.pos == "rope":
            tables = rope_tables(positions, cfg)
            self.rope = list(zip(*(t.chunk(M) for t in tables)))

    def __call__(self, x: torch.Tensor, j: int) -> torch.Tensor:
        bb = self.backbone
        cfg = bb.parallel.cfg
        attend = bb._attend(x.shape[1], self.kernels, x.device)
        rope = None if self.rope is None else self.rope[j]
        for i in self.layers:
            x, _ = bb.layers[i](x, cfg, self.valid[j], attend, None, None, None, rope,
                                self.kernels)
        return x


def _schedule(x, run, g: comm.Group, M: int, keep: bool, remat: bool = False):
    """The forward ticks; returns (the outputs on every pipe rank, what the
    backward needs: each microbatch's input, and with ``keep`` and no
    ``remat`` its output's graph)."""
    S, s = g.size, g.index
    xs = x.chunk(M)
    outs, saved = [], []
    for j in range(M):
        x_in = xs[j] if s == 0 else comm.recv(xs[j], g, s - 1)
        if keep and not remat:
            x_in = x_in.detach().requires_grad_(True)
            with torch.enable_grad():
                y = run(x_in, j)
            saved.append((x_in, y))
        else:
            with torch.no_grad():
                y = run(x_in, j)
            saved.append((x_in.detach(), None))
        if s < S - 1:
            comm.send(y.detach(), g, s + 1)
        else:
            outs.append(y.detach())
    out = torch.cat(outs) if s == S - 1 else torch.empty_like(x)
    return comm.broadcast(out, g, S - 1), saved


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, run, g, M, remat, *params):
        out, saved = _schedule(x, run, g, M, keep=True, remat=remat)
        ctx.run, ctx.g, ctx.M, ctx.remat, ctx.saved = run, g, M, remat, saved
        ctx.like = x.detach()
        return out

    @staticmethod
    def backward(ctx, dout):
        g, M, run = ctx.g, ctx.M, ctx.run
        S, s = g.size, g.index
        dys = dout.chunk(M)
        dxs = [None] * M
        for j in reversed(range(M)):
            dy = dys[j] if s == S - 1 else comm.recv(dys[j], g, s + 1)
            x_in, y = ctx.saved[j]
            if y is None:  # remat: the stage again, from its saved input
                x_in = x_in.detach().requires_grad_(True)
                with torch.enable_grad():
                    y = run(x_in, j)
            torch.autograd.backward(y, dy)
            dx = x_in.grad
            if s > 0:
                comm.send(dx, g, s - 1)
            else:
                dxs[j] = dx
        ctx.saved = None
        dx = torch.cat(dxs) if s == 0 else torch.empty_like(ctx.like)
        return (comm.broadcast(dx, g, 0), None, None, None, None,
                *([None] * (len(ctx.needs_input_grad) - 5)))
