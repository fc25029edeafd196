"""Batched segment sum and row gather for mesh-graph message passing.

Counterpart of ``fluid_llm_tpu/ops/segment_ops.py`` and
``ops/segment_sum_pallas.py``.  The kernels are in ``csrc/segment_ops.cu``
(CUDA C++ for ``sm_90a``); they replace the TPU kernels
``fluid_llm_tpu/ops/segment_sum_pallas.py:_scatter_kernel`` (through
``_scatter_call``) and ``:_expand_kernel`` (through ``_expand_call``).

- :func:`segment_sum_nodes` ``(values (..., E, *F), idx (..., E), N) ->
  (..., N, *F)``: each node row is the sum of the edge rows whose id names
  it; ids outside ``[0, N)`` are dropped (``jax.ops.segment_sum``).
- :func:`gather_nodes` ``(V (..., N, F), idx (..., E)) -> (..., E, F)``:
  ``torch.gather`` along the node axis, except that an id outside
  ``[0, N)`` gives a zero row (the transpose of the sum's dropping).

Ids flatten batch-major with per-element offsets, and an id outside its
own element's range maps to -1, never into the next element's row 0
(``segment_sum_pallas.py:270-282``).  :class:`SegmentIndex` holds that
flattening, and for the sum kernel a CSR of it (a stable sort of the ids),
so that one index serves every call by the same ids: the gathers and sums
of all message-passing blocks, and the backward of each.

Each operation is a ``torch.autograd.Function`` whose backward is the other
one by the same ids, as the JAX package's ``custom_vjp`` pair
(``segment_ops.py:107-155``): d(segment sum)/dvalues is a gather, d(gather)/
dnodes a segment sum.  No double backward, as there.

CUDA tensors launch the kernels (:func:`segment_sum`, :func:`segment_gather`
in f32; :func:`segment_sum_bf16`, :func:`segment_gather_bf16` in bf16) or
raise, also for any other dtype; CPU tensors, and ``kernels=False``, take the
plain twins :func:`segment_sum_ref` (``index_add_`` into zeros) and
:func:`gather_ref` (``index_select`` and a mask).  The kernels take int32
ids; the sum is deterministic (no atomics; the twin's ``index_add_`` on CUDA
is not).  bf16 values are summed in f32 and rounded once to bf16, as the TPU
kernel's one MXU pass with f32 accumulation (``segment_sum_pallas.py:
79-82``), and the twins do the same on the values upcast to f32; a bf16
gather stays bf16 (``:204``).  The gradient keeps the forward's dtype.
The TPU kernels' window machinery (``windowed``, ``window``,
``WINDOW_CHOICES``, ``_chunk_row0``, ``host_kernel_ok``, ``min_window``, the
``lax.cond`` predicate, the bf16 value limbs) answers the TPU's serialized
scatter and is not carried over: the CUDA kernels take any ids.

Bound and design, in short (the source's header has the detail): both are
bytes bound at MeshGraphNet's F 128 (~50 MB a call, one add per element);
at GAT's F 1 only latency is left, and the longest chain of dependent loads
(each graph's 132-edge ghost row) sets the time.  Each output element of
the sum is one thread's f32 sum of its row's edges, added in ascending edge
order from 0 -- the order :func:`csr_walk` spells out and the CPU twin's
``index_add_`` follows, so the kernel equals both bit for bit.  What
differs with F is how the loads are issued (:func:`sum_walk`): below
:data:`WIDE` columns a warp stages the contiguous stretch of perm its rows
own, and the values, in shared memory, chunk after chunk
(:func:`narrow_chunks`); from :data:`WIDE` on a row's threads walk its run
in rounds of :data:`ROUND` edges, every value load of a round in flight
before the first add and the next round's rows prefetched, the rows with
more than one round first (:meth:`SegmentIndex.long_first`).  bf16 rows of
whole 16-byte vectors from :data:`WIDE` on go through a ring of bulk
copies instead: a warp's lanes copy whole edge rows (runs of consecutive
ones as one copy) into shared memory, :func:`sum_plan`'s stages in flight,
and add them from there in the same order (:func:`ring_walk`); the first
rows of the long-first order each take a block whose rings are one.  The
gather keeps its ids and rows in flight: a warp takes its tile's ids in
coalesced loads, and each lane issues :func:`gather_plan`'s ``depth`` row
loads before its first store -- whole rows a lane where a row is one 4-,
8- or 16-byte vector (F 1, 2 and 4), 16-byte pieces of a 32-edge tile's
rows, the ids handed round by shuffles, where it is wider (F 128).
"""

from __future__ import annotations

import math

import torch

from fluid_llm_tpu_torch.ops import _build


class SegmentIndex:
    """The ids of one ``(..., E)`` id tensor over ``num_nodes`` rows per
    batch element, flattened: ``ids`` int32 ``(M,)`` with ``M = prod(...) *
    E``, ``idx + b * num_nodes`` for an id in ``[0, num_nodes)`` and -1
    otherwise.  :meth:`csr` sorts them once for the sum kernel."""

    def __init__(self, idx: torch.Tensor, num_nodes: int):
        if idx.dim() < 1 or idx.is_floating_point():
            raise ValueError(f"SegmentIndex: integer ids (..., E), got {idx.dtype} "
                             f"{tuple(idx.shape)}")
        self.batch_shape = tuple(idx.shape[:-1])
        self.n_edges = idx.shape[-1]
        self.num_nodes = int(num_nodes)
        b = math.prod(self.batch_shape)
        self.n_rows = b * self.num_nodes
        if max(self.n_rows, b * self.n_edges) >= 2**31:
            raise ValueError("SegmentIndex: more than 2**31 rows or edges")
        idx2 = idx.reshape(b, self.n_edges).long()
        ok = (idx2 >= 0) & (idx2 < self.num_nodes)
        off = torch.arange(b, device=idx.device)[:, None] * self.num_nodes
        self.ids = torch.where(ok, idx2 + off, -1).to(torch.int32).reshape(-1)
        self._csr: tuple[torch.Tensor, torch.Tensor] | None = None
        self._order: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.ids.device

    def csr(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(perm, row_ptr)``, int32: node row r's edges, ascending, are
        ``perm[row_ptr[r]:row_ptr[r + 1]]``; dropped ids sort past the last
        row.  Built on the first call (a stable sort and a search, outside
        the kernel, as the TPU package computes ``_chunk_row0`` in XLA)."""
        if self._csr is None:
            key = torch.where(self.ids >= 0, self.ids, self.n_rows)
            sorted_key, perm = torch.sort(key, stable=True)
            bounds = torch.arange(self.n_rows + 1, dtype=key.dtype, device=key.device)
            row_ptr = torch.searchsorted(sorted_key, bounds, out_int32=True)
            self._csr = (perm.to(torch.int32), row_ptr)
        return self._csr

    def long_first(self) -> torch.Tensor:
        """int32 ``(n_rows,)``: the rows whose run is longer than one of the
        wide sum's rounds (:data:`ROUND` edges), then the others, each in
        row order -- the order in which the wide sum starts them.  A stable
        partition of the CSR's run lengths, built once (no sort, no host
        synchronisation)."""
        if self._order is None:
            row_ptr = self.csr()[1]
            long = (row_ptr[1:] - row_ptr[:-1]) > ROUND
            n_long = long.sum()
            pos = torch.where(long, long.cumsum(0) - 1, n_long + (~long).cumsum(0) - 1)
            rows = torch.arange(self.n_rows, dtype=torch.int32, device=row_ptr.device)
            self._order = torch.empty_like(rows).scatter_(0, pos, rows)
        return self._order


WIDE = 32  # F from which the sum kernel walks a row in rounds
RING_SLICE = 1024  # bytes of a row one task of the bf16 ring covers at most
RING_WARPS = 16  # the bf16 ring's warps a block at most
LONG_BLOCKS = 16  # the bf16 ring's blocks of one long row each
SMEM_MAX = 232448  # dynamic shared memory a block may have (H100; csrc/hopper.cuh)
GATHER_DEPTH = 16  # a gathering lane's loads in flight at most
GATHER_DEPTHS = (1, 2, 4, 8, GATHER_DEPTH)  # the depths the gather kernel is built for
ROUND = 8  # edges of a wide row's round
CHUNK_EDGES, CHUNK_FLOATS = 512, 1024  # a narrow warp's staged edges and their values


def narrow_chunks(row_ptr: list[int], F: int, warp: int) -> list[range]:
    """The chunks of perm positions that narrow warp ``warp`` (F < WIDE:
    slots (row, column) ``32 warp`` .. ``32 warp + 31`` in row-major order)
    stages one after another: the stretch its rows own, in steps of at most
    ``CHUNK_EDGES`` edges and ``CHUNK_FLOATS`` values."""
    n_rows, t0 = len(row_ptr) - 1, 32 * warp
    first, last = t0 // F, min((t0 + 31) // F, n_rows - 1)
    per = min(CHUNK_EDGES, CHUNK_FLOATS // F)
    s0, s1 = row_ptr[first], row_ptr[last + 1]
    return [range(cs, min(cs + per, s1)) for cs in range(s0, s1, per)]


def sum_walk(row_ptr: list[int], F: int, r: int, c: int) -> list[range]:
    """The perm positions the sum kernel adds into element (r, c), in
    order, one range for each set of loads in flight together: the row's
    part of each chunk its narrow warp stages, or its rounds of ROUND edges
    (f32, and bf16 rows that are not whole 16-byte vectors; the others take
    the ring, :func:`ring_walk`, in the same order)."""
    a, b = row_ptr[r], row_ptr[r + 1]
    if F >= WIDE:
        return [range(j, min(j + ROUND, b)) for j in range(a, b, ROUND)]
    chunks = narrow_chunks(row_ptr, F, (r * F + c) // 32)
    runs = (range(max(a, k.start), min(b, k.stop)) for k in chunks)
    return [run for run in runs if len(run)]


def ring_smem(F: int, plan: tuple[int, int, int, int]) -> int:
    """Bytes of shared memory a block of the bf16 ring takes under ``plan``
    ``(K, S, R, W)``: W warps' S stages of K slice rows and S mbarriers."""
    K, S, _, W = plan
    return W * S * (K * min(2 * F, RING_SLICE) + 8)


def sum_plan(F: int) -> tuple[int, int, int, int]:
    """``(K, S, R, W)`` of the bf16 ring (rows of F >= WIDE whole 16-byte
    vectors): K edge rows a stage, S stages a warp, R rows a warp, W warps a
    block, whose W S K rows also hold a ghost row's 132 edges in each of the
    LONG_BLOCKS blocks of one long row -- among the leaders of a sweep of
    K 4-32, S 2-4, R 2-16 and W 2-16 at MeshGraphNet's F 128, by senders
    and by receivers, and GraphViT's F 512 (``chip_smoke.py``'s ``[plans]``
    check it and the plans one step from it)."""
    K, S, R, W = (16, 2, 8, 8) if 2 * F <= 256 else (4, 2, 8, 16)
    while K > 1 and ring_smem(F, (K, S, R, W)) > SMEM_MAX:
        K //= 2
    return K, S, R, W


def ring_walk(row_ptr: list[int], order: list[int], F: int,
              plan: tuple[int, int, int, int]) -> list[list[tuple[int, int, list[int]]]]:
    """The bf16 ring's warps walked in Python: for each warp that has work,
    its tasks in the order it adds them, each ``(row, slice, perm
    positions)``.  Task t is the ``t % slices``-th RING_SLICE-byte slice of
    row ``order[t // slices]``; tasks 0 .. LONG_BLOCKS - 1 each have a block
    of their own, and warp g of the other G takes tasks LONG_BLOCKS + g,
    LONG_BLOCKS + g + G, ... (at most R); a warp's stream is its tasks'
    edges one after another."""
    K, S, R, W = plan
    B = LONG_BLOCKS
    slices = -(-2 * F // min(2 * F, RING_SLICE))
    tasks = len(order) * slices
    G = -(-max(tasks - B, 0) // R)

    def task(t):
        row = order[t // slices]
        return row, t % slices, list(range(row_ptr[row], row_ptr[row + 1]))

    return ([[task(t)] for t in range(min(B, tasks))]
            + [[task(t) for t in range(B + g, tasks, G)][:R] for g in range(G)])


def _sum_dtype(values2: torch.Tensor) -> torch.dtype:
    """f32 for bf16 (and f32) values; f64 stays f64 (the CPU tests)."""
    return torch.promote_types(values2.dtype, torch.float32)


def csr_walk(values2: torch.Tensor, index: SegmentIndex) -> torch.Tensor:
    """The sum kernel's additions on any device: round k adds each row's
    k-th edge (ascending) to its f32 sum, from 0, so every row is summed
    in the kernel's order; bf16 values are widened to f32 and the sums
    rounded once.  values (M, F) -> (n_rows, F)."""
    perm, row_ptr = index.csr()
    start, degree = row_ptr[:-1].long(), (row_ptr[1:] - row_ptr[:-1]).long()
    wide = values2.to(_sum_dtype(values2))
    out = wide.new_zeros(index.n_rows, values2.shape[1])
    for k in range(int(degree.max()) if index.n_rows else 0):
        rows = (degree > k).nonzero().flatten()
        out[rows] = out[rows] + wide[perm[start[rows] + k].long()]
    return out.to(values2.dtype)


def segment_sum_ref(values2: torch.Tensor, index: SegmentIndex) -> torch.Tensor:
    """Plain twin of the sum kernel: values (M, F) -> (n_rows, F), bf16
    summed in f32 and cast once; dropped ids land in an extra row that is
    cut off."""
    rows = torch.where(index.ids >= 0, index.ids, index.n_rows).long()
    wide = values2.to(_sum_dtype(values2))
    out = wide.new_zeros(index.n_rows + 1, values2.shape[1])
    return out.index_add_(0, rows, wide)[:index.n_rows].to(values2.dtype)


def gather_ref(nodes2: torch.Tensor, index: SegmentIndex) -> torch.Tensor:
    """Plain twin of the gather kernel: nodes (n_rows, F) -> (M, F), zero
    rows for dropped ids."""
    rows = nodes2.index_select(0, index.ids.clamp(min=0).long())
    return torch.where((index.ids >= 0)[:, None], rows, 0.0)


def _check(name: str, x: torch.Tensor, index: SegmentIndex, rows: int,
           dtype: torch.dtype) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {x.device}")
    if x.dtype != dtype or x.dim() != 2 or x.shape[0] != rows:
        raise ValueError(f"{name}: {dtype} ({rows}, F) expected, got {x.dtype} {tuple(x.shape)}")
    if index.device != x.device:
        raise ValueError(f"{name}: ids on {index.device}, values on {x.device}")
    return x.contiguous()


def _vectorized(*tensors) -> int:
    """Rows of whole 16-byte vectors (F a multiple of 4 in f32, of 8 in
    bf16) and every pointer 16-byte aligned."""
    return int(all(t.shape[1] * t.element_size() % 16 == 0 and t.data_ptr() % 16 == 0
                   for t in tensors))


def _launch_sum(entry: str, values2: torch.Tensor, index: SegmentIndex,
                dtype: torch.dtype) -> torch.Tensor:
    values2 = _check(entry, values2, index, index.ids.shape[0], dtype)
    perm, row_ptr = index.csr()
    order = index.long_first()
    F = values2.shape[1]
    out = torch.empty(index.n_rows, F, dtype=dtype, device=values2.device)
    plan = sum_plan(F) if dtype == torch.bfloat16 else ()
    with torch.cuda.device(values2.device):
        err = getattr(_build.load(), entry)(
            values2.data_ptr(), perm.data_ptr(), row_ptr.data_ptr(), order.data_ptr(),
            out.data_ptr(), index.n_rows, F, _vectorized(values2, out), *plan,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, entry)
    return out


def segment_sum(values2: torch.Tensor, index: SegmentIndex) -> torch.Tensor:
    """The sum kernel on CUDA tensors: values f32 (M, F) -> (n_rows, F)."""
    out = _launch_sum("segment_sum_f32", values2, index, torch.float32)
    segment_sum.launches += 1
    return out


def segment_sum_bf16(values2: torch.Tensor, index: SegmentIndex) -> torch.Tensor:
    """The sum kernel on CUDA tensors: values bf16 (M, F) -> (n_rows, F),
    each element summed in f32 and rounded once."""
    out = _launch_sum("segment_sum_bf16", values2, index, torch.bfloat16)
    segment_sum_bf16.launches += 1
    return out


def gather_vec(F: int, *tensors) -> int:
    """Elements a load of the gather moves: a 16-byte vector (4 f32, 8
    bf16) where F allows it and every pointer lies on 16 bytes, else 8
    bytes likewise, then 4, else one element."""
    size = tensors[0].element_size()
    return next(v for v in (16 // size, 8 // size, 4 // size, 1)
                if v >= 1 and F % v == 0 and all(t.data_ptr() % (size * v) == 0 for t in tensors))


def gather_tiles(M: int, nv: int, depth: int) -> int:
    """Warp tiles of the gather: ``32 * depth`` edges each where a row is one
    vector (``nv`` 1: a lane owns ``depth`` rows), else 32 edges."""
    return -(-M // (32 * depth if nv == 1 else 32))


def gather_plan(M: int, F: int, vec: int) -> tuple[int, int, int]:
    """``(depth, warps, blocks)`` of the gather kernel, one tile a warp: where
    a row is one vector (F 1 and 2), 2 rows a lane in blocks of 8 warps;
    else up to 8 of a lane's vectors in flight (``depth`` of
    :data:`GATHER_DEPTHS`) in blocks of 2 warps -- the sweep's leaders at
    MeshGraphNet's and GAT's shapes (``chip_smoke.py``'s ``[plans]``)."""
    nv = F // vec
    depth, warps = (2, 8) if nv == 1 else (next(d for d in GATHER_DEPTHS if d >= min(nv, 8)), 2)
    return depth, warps, max(1, -(-gather_tiles(M, nv, depth) // warps))


def _launch_gather(entry: str, nodes2: torch.Tensor, index: SegmentIndex,
                   dtype: torch.dtype) -> torch.Tensor:
    nodes2 = _check(entry, nodes2, index, index.n_rows, dtype)
    M, F = index.ids.shape[0], nodes2.shape[1]
    out = torch.empty(M, F, dtype=dtype, device=nodes2.device)
    vec = gather_vec(F, nodes2, out)
    depth, warps, blocks = gather_plan(M, F, vec)
    with torch.cuda.device(nodes2.device):
        err = getattr(_build.load(), entry)(
            nodes2.data_ptr(), index.ids.data_ptr(), out.data_ptr(), M, index.n_rows, F, vec,
            depth, warps, blocks, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, entry)
    return out


def segment_gather(nodes2: torch.Tensor, index: SegmentIndex) -> torch.Tensor:
    """The gather kernel on CUDA tensors: nodes f32 (n_rows, F) -> (M, F)."""
    out = _launch_gather("segment_gather_f32", nodes2, index, torch.float32)
    segment_gather.launches += 1
    return out


def segment_gather_bf16(nodes2: torch.Tensor, index: SegmentIndex) -> torch.Tensor:
    """The gather kernel on CUDA tensors: nodes bf16 (n_rows, F) -> (M, F)."""
    out = _launch_gather("segment_gather_bf16", nodes2, index, torch.bfloat16)
    segment_gather_bf16.launches += 1
    return out


segment_sum.launches = 0  # kernel launches in this process
segment_gather.launches = 0
segment_sum_bf16.launches = 0
segment_gather_bf16.launches = 0
SUM_KERNELS = {torch.float32: segment_sum, torch.bfloat16: segment_sum_bf16}
GATHER_KERNELS = {torch.float32: segment_gather, torch.bfloat16: segment_gather_bf16}


def _route(x: torch.Tensor, kernels: bool, table: dict, twin):
    if x.device.type == "cpu" or not kernels:
        return twin
    if x.device.type != "cuda":
        raise ValueError(f"segment ops: unsupported device {x.device}")
    if x.dtype not in table:
        raise ValueError(f"segment ops: no kernel for {x.dtype} (f32 and bf16 only)")
    return table[x.dtype]


def _sum2d(values2, index, kernels: bool):
    return _route(values2, kernels, SUM_KERNELS, segment_sum_ref)(values2, index)


def _gather2d(nodes2, index, kernels: bool):
    return _route(nodes2, kernels, GATHER_KERNELS, gather_ref)(nodes2, index)


class SegmentSum(torch.autograd.Function):
    """values (M, F) -> (n_rows, F); backward: a gather by the same ids."""

    @staticmethod
    def forward(ctx, values2, index: SegmentIndex, kernels: bool):
        ctx.index, ctx.kernels = index, kernels
        return _sum2d(values2, index, kernels)

    @staticmethod
    def backward(ctx, g):
        return _gather2d(g.contiguous(), ctx.index, ctx.kernels), None, None


class GatherNodes(torch.autograd.Function):
    """nodes (n_rows, F) -> (M, F); backward: a segment sum by the same ids."""

    @staticmethod
    def forward(ctx, nodes2, index: SegmentIndex, kernels: bool):
        ctx.index, ctx.kernels = index, kernels
        return _gather2d(nodes2, index, kernels)

    @staticmethod
    def backward(ctx, g):
        return _sum2d(g.contiguous(), ctx.index, ctx.kernels), None, None


def as_index(idx, num_nodes: int) -> SegmentIndex:
    """``idx`` itself if it is a :class:`SegmentIndex` over ``num_nodes``,
    else a new one over the id tensor."""
    if isinstance(idx, SegmentIndex):
        if idx.num_nodes != num_nodes:
            raise ValueError(f"SegmentIndex over {idx.num_nodes} nodes, {num_nodes} given")
        return idx
    return SegmentIndex(idx, num_nodes)


def segment_sum_nodes(values: torch.Tensor, idx, num_nodes: int,
                      kernels: bool = True) -> torch.Tensor:
    """values (..., E, *F); idx (..., E) ids or their :class:`SegmentIndex`
    -> (..., N, *F) summed per node."""
    index = as_index(idx, num_nodes)
    lead = index.batch_shape + (index.n_edges,)
    if tuple(values.shape[:len(lead)]) != lead:
        raise ValueError(f"segment_sum_nodes: values {tuple(values.shape)} against ids {lead}")
    feat = values.shape[len(lead):]
    out = SegmentSum.apply(values.reshape(-1, math.prod(feat)), index, kernels)
    return out.reshape(*index.batch_shape, index.num_nodes, *feat)


def gather_nodes(V: torch.Tensor, idx, kernels: bool = True) -> torch.Tensor:
    """V (..., N, F); idx (..., E) ids or their :class:`SegmentIndex` ->
    (..., E, F); zero rows for ids outside ``[0, N)``."""
    index = as_index(idx, V.shape[-2])
    if tuple(V.shape[:-2]) != index.batch_shape:
        raise ValueError(f"gather_nodes: V {tuple(V.shape)} against ids {index.batch_shape}")
    out = GatherNodes.apply(V.reshape(-1, V.shape[-1]), index, kernels)
    return out.reshape(*index.batch_shape, index.n_edges, V.shape[-1])
