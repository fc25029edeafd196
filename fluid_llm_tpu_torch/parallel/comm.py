"""The port's collectives over one axis of the rank mesh.

The JAX package has no counterpart: XLA emits its collectives from sharding
annotations.  Here each is an explicit call on a :class:`Group` (one mesh
axis, or the batch axes together, as this rank sees it), and those a
gradient passes through are ``torch.autograd.Function``s:

- the Megatron pair: :func:`copy_to` (identity forward, all-reduce
  backward) before a column-parallel linear, :func:`reduce_from`
  (all-reduce forward, identity backward) after a row-parallel one;
- :func:`gather_rs` (all-gather forward, reduce-scatter backward): an fsdp
  weight gathered on use, the tokens before a column-parallel linear under
  sequence parallelism; :func:`scatter_ag` (reduce-scatter forward,
  all-gather backward) after a row-parallel one there;
- :func:`split_gather` / :func:`gather_split`: a replicated tensor cut to
  this rank's chunk (all-gather backward), and the chunks joined again
  for a replicated consumer (this rank's chunk of the gradient back);
- point-to-point hops (:func:`send`, :func:`recv`, :func:`exchange`) for
  the pipeline and the ring;
- :func:`all_to_all` (its backward the reverse all-to-all): a MoE layer's
  tokens sent to the rank of their expert over the expert axis, and the
  expert outputs back.

Every function returns its input untouched on a group of one rank, so a
mesh of one rank computes exactly the one-process step.

A group on the gloo backend stages CUDA tensors through host memory for
every collective (gloo has no CUDA path for most of them): the choice is
keyed on the group's backend, fixed when the group is made
(``Group.staged``); a nccl group never copies through the host.  Gloo has
no reduce-scatter: it is an all-reduce and this rank's chunk there.  Sums
of 16-bit floats run in f32 and round once (as the JAX pipeline's psum).

The loss's reductions over the batch rows (:func:`batch_sum`,
:func:`batch_mean`) act on the group made active by :func:`batch_axes`
(the trainer's step); outside it they are the plain sums and means.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import torch
import torch.distributed as dist


class Group:
    """``ranks``: the global ranks along the axis, in axis order; ``pg`` the
    process group over them (None for a single rank); ``index`` this rank's
    place; ``staged``: collectives go through host memory (gloo)."""

    def __init__(self, ranks: list[int], rank: int, pg=None, backend: Optional[str] = None):
        self.ranks, self.pg = list(ranks), pg
        self.size = len(self.ranks)
        self.index = self.ranks.index(rank)
        self.staged = backend == "gloo"

    def __repr__(self) -> str:
        return f"Group(ranks={self.ranks}, index={self.index}, staged={self.staged})"

    def _in(self, t: torch.Tensor) -> torch.Tensor:
        """A contiguous copy the collective may write: on the host if staged."""
        return t.detach().to("cpu" if self.staged else t.device, copy=True).contiguous()


def trivial(g: Optional[Group]) -> bool:
    return g is None or g.size == 1


# -- plain collectives (no autograd) -----------------------------------------


def _wide(h: torch.Tensor) -> torch.Tensor:
    """16-bit floats are summed in f32 (and rounded once, after)."""
    return h.float() if h.dtype in (torch.bfloat16, torch.float16) else h


def all_reduce(t: torch.Tensor, g: Optional[Group]) -> torch.Tensor:
    """The sum of ``t`` over the group."""
    if trivial(g):
        return t
    h = _wide(g._in(t))
    dist.all_reduce(h, group=g.pg)
    return h.to(device=t.device, dtype=t.dtype)


def all_gather(t: torch.Tensor, g: Optional[Group], dim: int) -> torch.Tensor:
    """The group's tensors joined along ``dim``, in axis order."""
    if trivial(g):
        return t
    h = g._in(t)
    parts = [torch.empty_like(h) for _ in range(g.size)]
    dist.all_gather(parts, h, group=g.pg)
    return torch.cat(parts, dim).to(t.device)


def reduce_scatter(t: torch.Tensor, g: Optional[Group], dim: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of ``t`` over the group."""
    if trivial(g):
        return t
    if g.staged:
        h = _wide(g._in(t))
        dist.all_reduce(h, group=g.pg)
        return h.chunk(g.size, dim)[g.index].contiguous().to(device=t.device, dtype=t.dtype)
    h = _wide(t.movedim(dim, 0)).contiguous()
    out = h.new_empty((h.shape[0] // g.size, *h.shape[1:]))
    dist.reduce_scatter_tensor(out, h, group=g.pg)
    return out.movedim(0, dim).to(t.dtype).contiguous()


def chunk(t: torch.Tensor, g: Optional[Group], dim: int) -> torch.Tensor:
    """This rank's chunk of ``t`` along ``dim`` (equal chunks)."""
    if trivial(g):
        return t
    if t.shape[dim] % g.size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)}: {t.shape[dim]} not divisible by "
                         f"{g.size} ranks")
    return t.chunk(g.size, dim)[g.index]


def broadcast(t: torch.Tensor, g: Optional[Group], src: int) -> torch.Tensor:
    """``t`` of the group's rank ``src`` (an index along the axis) on every rank."""
    if trivial(g):
        return t
    h = g._in(t)
    dist.broadcast(h, g.ranks[src], group=g.pg)
    return h.to(t.device)


def exchange_chunks(t: torch.Tensor, g: Optional[Group], split: int, cat: int) -> torch.Tensor:
    """``t`` cut into ``g.size`` equal chunks along ``split``, chunk ``j``
    sent to the group's rank ``j``; the chunks received joined along ``cat``
    in axis order.  Every rank's ``t`` has the same shape.  The chunks move
    as bytes, so any dtype crosses any backend unchanged: one send and one
    receive a peer, in one batch, on every backend (gloo has no all-to-all
    on every PyTorch; nccl's is grouped sends and receives itself), and
    this rank's own chunk copied."""
    if trivial(g):
        return t
    if t.shape[split] % g.size:
        raise ValueError(f"all-to-all of {tuple(t.shape)}: dim {split} not divisible by "
                         f"{g.size} ranks")
    parts = [c.contiguous() for c in t.chunk(g.size, split)]
    shape = parts[0].shape
    send_ = [g._in(c).reshape(-1).view(torch.uint8) for c in parts]
    recv_ = [torch.empty_like(s) for s in send_]
    recv_[g.index] = send_[g.index]
    _p2p([dist.P2POp(op, buf, g.ranks[j], group=g.pg)
          for j in range(g.size) if j != g.index
          for op, buf in ((dist.isend, send_[j]), (dist.irecv, recv_[j]))])
    got = [r.view(t.dtype).view(shape) for r in recv_]
    return torch.cat(got, cat).to(t.device)


def _p2p(ops: list) -> None:
    for work in dist.batch_isend_irecv(ops):
        work.wait()


def send(t: torch.Tensor, g: Group, dst: int) -> None:
    """Send ``t`` to the group's rank ``dst`` (an index along the axis)."""
    _p2p([dist.P2POp(dist.isend, g._in(t), g.ranks[dst], group=g.pg)])


def recv(like: torch.Tensor, g: Group, src: int) -> torch.Tensor:
    """A tensor shaped like ``like`` from the group's rank ``src``."""
    h = torch.empty(like.shape, dtype=like.dtype, device="cpu" if g.staged else like.device)
    _p2p([dist.P2POp(dist.irecv, h, g.ranks[src], group=g.pg)])
    return h.to(like.device)


def exchange(t: torch.Tensor, g: Group, dst: int, src: int) -> torch.Tensor:
    """Send ``t`` to rank ``dst`` and receive the tensor rank ``src`` sends
    (shaped like ``t``) in one batch: the ring's hop."""
    h = g._in(t)
    r = torch.empty_like(h)
    _p2p([dist.P2POp(dist.isend, h, g.ranks[dst], group=g.pg),
          dist.P2POp(dist.irecv, r, g.ranks[src], group=g.pg)])
    return r.to(t.device)


# -- autograd pairs ----------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy, ctx.g), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return all_reduce(x, g)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherRS(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return all_gather(x, g, dim)

    @staticmethod
    def backward(ctx, dy):
        return reduce_scatter(dy, ctx.g, ctx.dim), None, None


class _ScatterAG(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return reduce_scatter(x, g, dim)

    @staticmethod
    def backward(ctx, dy):
        return all_gather(dy, ctx.g, ctx.dim), None, None


class _GatherSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return all_gather(x, g, dim)

    @staticmethod
    def backward(ctx, dy):
        return chunk(dy, ctx.g, ctx.dim).contiguous(), None, None


class _SplitGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return chunk(x, g, dim).contiguous()

    @staticmethod
    def backward(ctx, dy):
        return all_gather(dy, ctx.g, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, split, cat):
        ctx.g, ctx.split, ctx.cat = g, split, cat
        return exchange_chunks(x, g, split, cat)

    @staticmethod
    def backward(ctx, dy):
        return exchange_chunks(dy, ctx.g, ctx.cat, ctx.split), None, None, None


def all_to_all(x, g, split: int, cat: int):
    """:func:`exchange_chunks`, its gradient sent back by the reverse
    exchange (each chunk of the gradient to the rank it came from)."""
    return x if trivial(g) else _AllToAll.apply(x, g, split, cat)


def copy_to(x, g):
    """Identity forward, gradient summed over ``g``: the input of a
    column-parallel linear."""
    return x if trivial(g) else _CopyTo.apply(x, g)


def reduce_from(x, g):
    """Sum over ``g`` forward, identity backward: after a row-parallel linear."""
    return x if trivial(g) else _ReduceFrom.apply(x, g)


def gather_rs(x, g, dim: int):
    """All-gather along ``dim``, reduce-scatter of the gradient."""
    return x if trivial(g) else _GatherRS.apply(x, g, dim)


def scatter_ag(x, g, dim: int):
    """Reduce-scatter along ``dim``, all-gather of the gradient."""
    return x if trivial(g) else _ScatterAG.apply(x, g, dim)


def gather_split(x, g, dim: int):
    """All-gather along ``dim`` for a consumer every rank runs alike: each
    rank keeps its own chunk of the (equal) gradient."""
    return x if trivial(g) else _GatherSplit.apply(x, g, dim)


def split_gather(x, g, dim: int):
    """This rank's chunk of a tensor every rank holds alike; the gradient
    chunks are gathered back."""
    return x if trivial(g) else _SplitGather.apply(x, g, dim)


# -- the loss's reductions over the batch rows ------------------------------

_BATCH: list[Optional[Group]] = []
_TOKENS: list[Optional[Group]] = []


@contextmanager
def batch_axes(g: Optional[Group]):
    """Within the block, :func:`batch_sum` and :func:`batch_mean` reduce over
    ``g``'s ranks, each of which holds its own rows of the global batch."""
    _BATCH.append(g)
    try:
        yield
    finally:
        _BATCH.pop()


def batch_group() -> Optional[Group]:
    return _BATCH[-1] if _BATCH else None


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """A local sum made global: summed over the batch group forward, its
    gradient passed to each rank's own rows (the loss is then the global
    one on every rank, and the parameters' gradients sum over the group)."""
    return reduce_from(t, batch_group())


def batch_mean(t: torch.Tensor) -> torch.Tensor:
    """``t.mean()`` over the global batch (``t`` holds this rank's rows)."""
    g = batch_group()
    if trivial(g):
        return t.mean()
    return reduce_from(t.sum(), g) / (t.numel() * g.size)


def batch_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``t`` joined in batch order (no gradient)."""
    return all_gather(t.detach(), batch_group(), 0)


@contextmanager
def tokens_sharded(g: Optional[Group]):
    """Within the block the residual stream holds this rank's chunk of the
    tokens over ``g`` (sequence parallelism): the column-parallel linears
    gather them, the row-parallel ones scatter."""
    _TOKENS.append(g)
    try:
        yield
    finally:
        _TOKENS.pop()


def token_group() -> Optional[Group]:
    return _TOKENS[-1] if _TOKENS else None
