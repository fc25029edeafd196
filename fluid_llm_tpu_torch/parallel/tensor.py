"""What a module holds of a sharded tensor, and the linears' Megatron split.

``parallel.mesh.shard_model`` cuts the model's tensors in place and leaves
two marks on the modules that own them (module attributes, which
``Module.to`` keeps):

- ``mod.shards``: ``{tensor name: ((dim, axis, group), ...)}``, the dims of
  the tensor cut over a mesh axis (this rank holds chunk ``group.index``);
  :func:`full` gathers the ``fsdp`` ones on use (ZeRO-3: the gradient of a
  trainable one is reduce-scattered back), never the ``model`` ones, which
  the computation keeps local;
- ``lin.tp``: a :class:`TP` on each linear of a block under tensor
  parallelism: ``col`` (q/k/v, fc1/gate/up: output features cut) or
  ``row`` (o, fc2/down: input features cut).  :func:`enter` and
  :func:`leave` put the Megatron pair around it: the column one's input
  through ``comm.copy_to`` and the row one's partial output through
  ``comm.reduce_from``; under sequence parallelism (``comm.tokens_sharded``)
  the tokens are gathered before the column one and reduce-scattered after
  the row one instead.  A row-parallel bias is added once, after.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fluid_llm_tpu_torch.parallel import comm


class TP:
    """A linear's place in the Megatron split over ``group`` (the model
    axis).  ``narrow``: the storage is whole on every rank (nf4 codes, whose
    absmax blocks span rows), so the weight is cut to this rank's features
    at use."""

    def __init__(self, kind: str, group: comm.Group, narrow: bool = False):
        if kind not in ("col", "row"):
            raise ValueError(kind)
        self.kind, self.group, self.narrow = kind, group, narrow

    def cut(self, w: torch.Tensor) -> torch.Tensor:
        """This rank's features of a whole ``(out, in)`` weight."""
        if not self.narrow:
            return w
        return comm.chunk(w, self.group, w.dim() - 2 if self.kind == "col" else w.dim() - 1)


def tp_of(lin: nn.Module) -> Optional[TP]:
    return getattr(lin, "tp", None)


def full(mod: nn.Module, name: str) -> Optional[torch.Tensor]:
    """``mod``'s tensor ``name`` with its fsdp chunks gathered (its model
    chunk kept local)."""
    t = getattr(mod, name)
    for dim, axis, g in getattr(mod, "shards", {}).get(name, ()):
        if axis == "fsdp":
            t = comm.gather_rs(t, g, dim)
    return t


def enter(lin: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The input of ``lin`` as its split needs it."""
    tp = tp_of(lin)
    if tp is None or tp.kind == "row":
        return x
    seq = comm.token_group()
    return comm.gather_rs(x, seq, 1) if seq is not None else comm.copy_to(x, tp.group)


def leave(lin: nn.Module, y: torch.Tensor) -> torch.Tensor:
    """The output of ``lin`` (before its bias) made whole."""
    tp = tp_of(lin)
    if tp is None or tp.kind == "col":
        return y
    seq = comm.token_group()
    return comm.scatter_ag(y, seq, 1) if seq is not None else comm.reduce_from(y, tp.group)


def row_bias(lin: nn.Module) -> bool:
    """Whether ``lin``'s bias waits until after :func:`leave`."""
    tp = tp_of(lin)
    return tp is not None and tp.kind == "row"
