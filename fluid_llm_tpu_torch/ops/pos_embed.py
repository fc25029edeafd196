"""The learned positions' add, ``h + x[ix] + y[iy] + t[it]``, and its gradient.

``models/embeddings.PosEmbed`` adds three learned per-axis tables (x, y
and time) to every token of the patch encoder's output.  The kernels are
in ``csrc/pos_embed.cu`` (CUDA C++ for ``sm_90a``); they replace no TPU
kernel: the JAX package leaves the gathers, and the scatter-adds of their
transpose, to XLA (``fluid_llm_tpu/models/embeddings.py``, ``pos_embed``).

- :func:`pos_embed_add` ``(h (..., d), x (nx, d), y (ny, d), t (nt, d),
  ids (..., 3)) -> (..., d)``: ``h + ((x[ix] + y[iy]) + t[it])``.

:class:`PosEmbedAdd` is the ``torch.autograd.Function`` over the two
kernels.  Its backward is one read of the incoming gradient into all three
table gradients (:func:`pos_embed_grad`); the gradient of ``h`` is the
incoming gradient itself.  Autograd through the plain indexing instead runs
one ``index_put_(accumulate=True)`` a table, which sorts the ids and walks
each run of equal ids row after row on one warp: at the training step's
42 240 rows into 30 ids, a few runs of up to 10 560 rows.

CUDA f32 tensors launch the kernels, and any other dtype there raises;
CPU tensors, and ``kernels=False``, take the plain twin
:func:`pos_embed_ref`, the model's indexing code, whose gradient autograd
gives.  Ids are taken as they come (int64 on the device of ``h``; another
integer type or device is cast or moved once); a negative id counts from its table's end and an id outside
``[-n, n)`` raises, on the twin's terms (on the card a device-side assert,
as the twin's index kernel).  The forward is the twin bit for bit (the
same f32 adds in the same order).  The backward is deterministic (no
atomics): rows are summed in chunks, each chunk's rows in ascending order
from 0, then the chunks' partials in chunk order from 0 -- the order
:func:`grad_walk` spells out -- so it repeats bit for bit and differs from
the twin's sums only by f32 rounding.

Bound and design, in short (the source's header has the detail): both are
bytes bound -- forward ``h`` read and the output written once, backward
the gradient read once (129.8 MB at the training shape, ~0.04 ms at 3.35
TB/s).  The backward's parallelism is over rows, not over distinct ids:
block (chunk, slab) sums a chunk of rows of one column slab into a
shared-memory accumulator of every table row, one thread a column, and
writes the chunk's partial sums; a second launch sums the partials.
:func:`grad_plan` narrows the slab until the accumulator fits its
shared-memory budget, and takes as many chunks as fill the card's SMs once.
"""

from __future__ import annotations

import torch

from fluid_llm_tpu_torch.ops import _build

GRAD_SMEM = 64 * 1024  # bytes of a pass-1 block's accumulator, where one vector column allows
SMEM_MAX = 232448  # dynamic shared memory a block may have (H100; csrc/pos_embed.cu)
SMEM_SM = 233472  # shared memory of one SM (H100)
ID_TILE = 128  # rows whose ids a pass-1 block stages at once (csrc/pos_embed.cu)
MAX_WIDTH = 128  # vector columns (threads) of a pass-1 slab at most
MIN_CHUNK_ROWS = 32  # rows a chunk, where fewer chunks than fill the card would do
BLOCKS_PER_SM = 4  # pass-1 blocks an SM the chunks aim at, at most


def pos_embed_ref(h: torch.Tensor, x: torch.Tensor, y: torch.Tensor, t: torch.Tensor,
                  ids: torch.Tensor) -> torch.Tensor:
    """Plain twin: the three tables indexed and added, then added to ``h``."""
    e = x[ids[..., 0]] + y[ids[..., 1]] + t[ids[..., 2]]
    return h + e.to(h.dtype)


def vector(d: int, *tensors) -> int:
    """Floats a load moves: 4 (16 bytes) where ``d`` is a multiple of 4 and
    every pointer lies on 16 bytes, else 1."""
    return 4 if d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors) else 1


def grad_plan(R: int, d: int, n_tab: int, vec: int, sms: int) -> tuple[int, int]:
    """``(width, rows)`` of the backward: ``width`` vector columns a slab (the
    threads of a pass-1 block), ``rows`` rows a chunk.  The slab is at most
    :data:`MAX_WIDTH` vectors and narrows until the block's ``n_tab x
    width`` accumulator fits :data:`GRAD_SMEM` (or is one vector wide); a
    table too long for even that in :data:`SMEM_MAX` raises.  The chunks
    are as many as give each of ``sms`` SMs the blocks that fit it, at most
    :data:`BLOCKS_PER_SM`, and no more than ``R`` / :data:`MIN_CHUNK_ROWS`
    (rounded up)."""
    nv = d // vec
    slabs = -(-nv // MAX_WIDTH)
    while -(-nv // slabs) > 1 and n_tab * -(-nv // slabs) * vec * 4 > GRAD_SMEM:
        slabs += 1
    width = -(-nv // slabs)
    slabs = -(-nv // width)
    smem = grad_smem(n_tab, width, vec)
    if smem > SMEM_MAX:
        raise ValueError(f"pos_embed_grad: {n_tab} table rows need {smem} bytes of shared "
                         f"memory at one column, more than {SMEM_MAX}")
    per_sm = max(1, min(BLOCKS_PER_SM, SMEM_SM // smem, 2048 // (32 * -(-width // 32))))
    chunks = max(1, min(-(-R // MIN_CHUNK_ROWS), -(-sms * per_sm // slabs)))
    return width, max(1, -(-R // chunks))


def grad_smem(n_tab: int, width: int, vec: int) -> int:
    """Bytes of shared memory a pass-1 block takes: the accumulator and the
    staged ids."""
    return n_tab * width * vec * 4 + ID_TILE * 3 * 4


def table_rows(ids2: torch.Tensor, nx: int, ny: int, nt: int) -> torch.Tensor:
    """``(R, 3)`` ids -> each id's row in the stacked ``(nx + ny + nt)``
    accumulator, negative ids counted from their table's end."""
    n = ids2.new_tensor([nx, ny, nt])
    if bool(((ids2 < -n) | (ids2 >= n)).any()):
        raise IndexError(f"pos_embed: an id outside its table of {nx}, {ny} or {nt} rows")
    return torch.where(ids2 < 0, ids2 + n, ids2) + ids2.new_tensor([0, nx, nx + ny])


def grad_walk(g2: torch.Tensor, rows3: torch.Tensor, n_tab: int, rows: int) -> torch.Tensor:
    """The backward's additions on any device: ``g2 (R, d)``, ``rows3 (R, 3)``
    (:func:`table_rows`) -> ``(n_tab, d)``.  Step j adds row j of every chunk
    of ``rows`` rows to the chunk's partial sums from 0; then the partials
    are summed in chunk order from 0."""
    R, d = g2.shape
    chunks = -(-R // rows)
    partial = g2.new_zeros(chunks, n_tab, d)
    chunk = torch.arange(chunks, device=g2.device)
    for j in range(min(rows, R)):
        r = chunk * rows + j
        live = r < R
        c, r = chunk[live], r[live]
        for axis in range(3):  # distinct accumulator rows: the order is immaterial
            k = rows3[r, axis]
            partial[c, k] = partial[c, k] + g2[r]
    out = g2.new_zeros(n_tab, d)
    for c in range(chunks):
        out = out + partial[c]
    return out


def _check(name: str, h2: torch.Tensor, tables, ids2: torch.Tensor) -> None:
    if h2.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {h2.device}")
    for tensor in (h2, *tables):
        if tensor.dtype != torch.float32 or tensor.dim() != 2 or tensor.shape[1] != h2.shape[1] \
                or tensor.device != h2.device:
            raise ValueError(f"{name}: f32 (rows, {h2.shape[1]}) on {h2.device} expected, got "
                             f"{tensor.dtype} {tuple(tensor.shape)} on {tensor.device}")
    if ids2.dtype != torch.int64 or ids2.shape != (h2.shape[0], 3) or ids2.device != h2.device:
        raise ValueError(f"{name}: int64 ids ({h2.shape[0]}, 3) on {h2.device} expected, got "
                         f"{ids2.dtype} {tuple(ids2.shape)} on {ids2.device}")
    if h2.shape[0] >= 2**31:
        raise ValueError(f"{name}: more than 2**31 rows")


def pos_embed_fwd(h2: torch.Tensor, x: torch.Tensor, y: torch.Tensor, t: torch.Tensor,
                  ids2: torch.Tensor) -> torch.Tensor:
    """The forward kernel on CUDA tensors: h f32 (R, d), ids int64 (R, 3)
    -> h + ((x[ix] + y[iy]) + t[it]) (R, d)."""
    h2, x, y, t, ids2 = (a.contiguous() for a in (h2, x, y, t, ids2))
    _check("pos_embed_fwd", h2, (x, y, t), ids2)
    R, d = h2.shape
    out = torch.empty_like(h2)
    with torch.cuda.device(h2.device):
        err = _build.load().pos_embed_fwd(
            h2.data_ptr(), x.data_ptr(), y.data_ptr(), t.data_ptr(), ids2.data_ptr(),
            out.data_ptr(), R, d, x.shape[0], y.shape[0], t.shape[0], vector(d, h2, x, y, t, out),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "pos_embed_fwd")
    pos_embed_fwd.launches += 1
    return out


def pos_embed_grad(g2: torch.Tensor, ids2: torch.Tensor, nx: int, ny: int,
                   nt: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels on CUDA tensors: g f32 (R, d), ids int64 (R, 3)
    -> the tables' gradients (nx, d), (ny, d), (nt, d).  Two launches."""
    g2, ids2 = g2.contiguous(), ids2.contiguous()
    R, d = g2.shape
    outs = [g2.new_zeros(n, d) if R == 0 else g2.new_empty(n, d) for n in (nx, ny, nt)]
    _check("pos_embed_grad", g2, outs, ids2)
    if R == 0:
        return tuple(outs)
    vec = vector(d, g2, *outs)
    width, rows = grad_plan(R, d, nx + ny + nt, vec, _build.sm_count(g2.device))
    partial = g2.new_empty(-(-R // rows), nx + ny + nt, d)
    with torch.cuda.device(g2.device):
        err = _build.load().pos_embed_grad(
            g2.data_ptr(), ids2.data_ptr(), partial.data_ptr(), *(o.data_ptr() for o in outs),
            R, d, nx, ny, nt, vec, width, rows, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "pos_embed_grad")
    pos_embed_grad.launches += 1
    return tuple(outs)


pos_embed_fwd.launches = 0  # kernel launches in this process
pos_embed_grad.launches = 0  # calls of the two-launch backward


class PosEmbedAdd(torch.autograd.Function):
    """h (..., d), tables, ids (..., 3) -> (..., d) through the kernels;
    backward: dh the incoming gradient, the tables' by :func:`pos_embed_grad`."""

    @staticmethod
    def forward(ctx, h, x, y, t, ids):
        d = h.shape[-1]
        ids2 = ids.reshape(-1, 3)
        ctx.save_for_backward(ids2)
        ctx.sizes = (x.shape[0], y.shape[0], t.shape[0])
        return pos_embed_fwd(h.reshape(-1, d), x, y, t, ids2).reshape(h.shape)

    @staticmethod
    def backward(ctx, g):
        (ids2,) = ctx.saved_tensors
        dx = dy = dt = None
        if any(ctx.needs_input_grad[1:4]):
            dx, dy, dt = pos_embed_grad(g.reshape(-1, g.shape[-1]), ids2, *ctx.sizes)
        return g, dx, dy, dt, None


def pos_embed_add(h: torch.Tensor, x: torch.Tensor, y: torch.Tensor, t: torch.Tensor,
                  ids: torch.Tensor, kernels: bool = True) -> torch.Tensor:
    """``h + x[ids[..., 0]] + y[ids[..., 1]] + t[ids[..., 2]]``: the kernels
    on CUDA tensors with ``kernels``, else the plain twin."""
    if h.device.type == "cpu" or not kernels:
        return pos_embed_ref(h, x, y, t, ids)
    if h.device.type != "cuda":
        raise ValueError(f"pos_embed_add: unsupported device {h.device}")
    if any(a.dtype != torch.float32 for a in (h, x, y, t)):
        raise ValueError("pos_embed_add: the kernels take f32 h and tables, got "
                         f"{[a.dtype for a in (h, x, y, t)]}")
    if ids.shape != h.shape[:-1] + (3,):
        raise ValueError(f"pos_embed_add: ids {tuple(ids.shape)} against h {tuple(h.shape)}")
    return PosEmbedAdd.apply(h, x, y, t, ids.to(h.device, torch.int64))
