"""Fused five-slot grid GATv2 attention, forward and backward.

Counterpart of ``fluid_llm_tpu/ops/grid_gnn_pallas.py``.  The kernels are
in ``csrc/grid_slot_attention.cu`` (CUDA C++ for ``sm_90a``); they replace
the TPU kernels ``fluid_llm_tpu/ops/grid_gnn_pallas.py:_fwd_kernel`` and
``:_bwd_kernel``.  :class:`SlotAttention` is the ``torch.autograd.Function``
over the two (the JAX package's ``custom_vjp``, :318-337).

Math (per frame, pixel p and head; slots s in {self, -x, +x, -y, +y};
v_s = x_l[n_s(p)]):

    u_s   = leaky_relu(x_r[p] + v_s, 0.2)
    logit = u_s . att          (masked at frame edges)
    a     = softmax_s(logit)
    out   = sum_s a_s v_s

Bound and design, in short (the source's header has the detail): the
operation is memory bound -- one read of x_l and x_r and one write of the
output is the floor -- and the plain formulation makes ~25 passes over
(frames, X, Y, F) tensors.  The kernel walks a strip of x-rows of one frame
in the public channels-last layout: a producer warp bulk-copies units of
one or more rows of x_l and x_r (x_r one row behind) into a ring, and each
step writes a unit's rows from the units holding x_l rows ``i - 1 .. i +
1``, so every x_l row is read once a strip plus two halo rows.  A pixel's
channels are split across a thread group (:func:`channel_group`, the
backward's rule too), the logits (``0.6 sum a u + 0.4 sum a |u|``) summed
by xor shuffles; logits, softmax and accumulator stay in registers and the
output is written once.  :func:`fwd_plan` picks the strip (short enough
that the rollout's one frame fills the card), the column tile, the ring's
depth, the group and the rows a unit (several where rows are narrow, so
that they travel in fewer copies); ``tests/test_torch_kernel_plans.py``
walks the same plan on the CPU.  The TPU kernel's channels-first
transpose, 128-lane padding and F-chunk loops have no purpose on the card
and are not carried over.

Backward (``grid_gnn_pallas.py:17-21``; g = dL/dout):

    dlogit_s = a_s (g.v_s - sum_t a_t g.v_t)
    dxr[p]   = sum_s dlogit_s att * lrelu'(u_s)
    dxl[q]  += a_s g + dlogit_s att * lrelu'(u_s)   for every (p, s) reading q
    datt     = sum over frames, pixels and slots of dlogit_s leaky_relu(u_s)

On the card it is two launches (the source's header has the detail).
One block walks a strip of :data:`STRIP` x-rows of one frame row by row: a
producer warp copies each row's contiguous ``Y * F`` run of xl, xr and g
(TMA bulk copies; unit j holds xl row ``x0 - 2 + j`` and xr, g row
``x0 - 3 + j``) into a ring of row units, and for each row the consumers
compute alpha and dlogit into a three-row ring in shared memory, write that
row's dxr, add its share of datt into registers, and write dxl of the row
behind it, gathered from the stats of its +-x rows and +-y neighbours.  No
alpha/dlogit scratch reaches device memory; only the halo stat rows at a
strip's ends are computed twice.  datt is each block's partial, summed by a
second launch in a fixed order.  No atomics, so the result is the same from
run to run.  :func:`bwd_plan` picks the column tile (the whole row where
the ring fits), the ring's depth and the threads a (pixel, head);
``tests/test_torch_kernel_plans.py`` walks the same plan on the CPU.
"""

from __future__ import annotations

import torch

from fluid_llm_tpu_torch.ops import _build

NEG_SLOPE = 0.2
# slot order: self, -x, +x, -y, +y
SHIFTS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))


def _slot_mask(X: int, Y: int, dx: int, dy: int, device) -> torch.Tensor:
    m = torch.ones(X, Y, dtype=torch.bool, device=device)
    if dx == 1:
        m[-1, :] = False
    elif dx == -1:
        m[0, :] = False
    if dy == 1:
        m[:, -1] = False
    elif dy == -1:
        m[:, 0] = False
    return m


def slot_logits(xl, xr, att, heads: int, cdim: int):
    """The five slots made explicit (``grid_gnn.py:124-135``): logits
    (..., X, Y, S, H) f32, off-grid slots at -inf, and values
    (..., X, Y, S, H, C).  xl/xr: (..., X, Y, heads*cdim); att: (heads, cdim)."""
    lead = xl.shape[:-1]
    xr_h = xr.reshape(*lead, heads, cdim)
    X, Y = xl.shape[-3], xl.shape[-2]
    logits, values, masks = [], [], []
    for dx, dy in SHIFTS:
        vh = torch.roll(xl, (-dx, -dy), dims=(-3, -2)).reshape(*lead, heads, cdim)
        e = torch.nn.functional.leaky_relu(xr_h + vh, NEG_SLOPE)
        logits.append(torch.einsum("...hc,hc->...h", e, att.to(e.dtype)))
        values.append(vh)
        masks.append(_slot_mask(X, Y, dx, dy, xl.device))
    logits = torch.stack(logits, dim=-2).float()  # (..., X, Y, S, H)
    mask = torch.stack(masks, dim=-1)[..., :, None]  # (X, Y, S, 1)
    return torch.where(mask, logits, -torch.inf), torch.stack(values, dim=-3)


def slot_attention_ref(xl, xr, att, heads: int, cdim: int) -> torch.Tensor:
    """Plain PyTorch twin: a port of ``_xla_slot_attention``
    (``fluid_llm_tpu/ops/grid_gnn_pallas.py:287-307``).

    xl/xr: (..., X, Y, heads*cdim); att: (heads, cdim) -> like xl.
    """
    logits, values = slot_logits(xl, xr, att, heads, cdim)
    alpha = torch.softmax(logits, dim=-2).to(xl.dtype)
    out = torch.einsum("...shc,...sh->...hc", values, alpha)
    return out.reshape(*xl.shape[:-1], heads * cdim)


def fused_slot_attention(xl, xr, att, heads: int, cdim: int) -> torch.Tensor:
    """xl/xr: (Bf, X, Y, heads*cdim); att: (heads, cdim) -> (Bf, X, Y, heads*cdim).

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`slot_attention_ref`.  bf16 or f32; ``att`` in the same dtype.
    On CUDA it raises when autograd would need a backward (grad enabled and
    an input that requires grad): that goes through :func:`slot_attention`;
    it needs heads*cdim <= 256 there.
    """
    if xl.device.type == "cpu":
        return slot_attention_ref(xl, xr, att, heads, cdim)
    _check_cuda("fused_slot_attention", xl, xr, att, heads, cdim)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xl, xr, att)):
        raise RuntimeError("fused_slot_attention: forward only; under autograd use "
                           "ops.grid_gnn_fused.slot_attention")
    Bf, X, Y, _ = xl.shape
    att32 = att.float().contiguous()
    out = torch.empty_like(xl)  # new storage: on 16 bytes
    plan = fwd_plan(Bf, X, Y, heads, cdim, xl.element_size(), _build.sm_count(xl.device))
    lib = _build.load()
    with torch.cuda.device(xl.device):
        err = lib.grid_slot_attention_fwd(
            xl.data_ptr(), xr.data_ptr(), att32.data_ptr(), out.data_ptr(),
            Bf, X, Y, heads, cdim, *plan, int(xl.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "grid_slot_attention_fwd")
    fused_slot_attention.launches += 1
    return out


def _check_cuda(name: str, xl, xr, att, heads: int, cdim: int) -> None:
    if xl.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {xl.device}")
    if xl.dim() != 4 or xl.shape[-1] != heads * cdim or xr.shape != xl.shape:
        raise ValueError(
            f"{name}: xl {tuple(xl.shape)}, xr {tuple(xr.shape)}, heads {heads} x {cdim}"
        )
    if att.shape != (heads, cdim):
        raise ValueError(f"{name}: att {tuple(att.shape)}, expected {(heads, cdim)}")
    if heads * cdim > 256:
        raise ValueError(f"{name}: heads*cdim {heads * cdim} > 256")
    if xl.dtype not in (torch.bfloat16, torch.float32) or xr.dtype != xl.dtype or att.dtype != xl.dtype:
        raise ValueError(f"{name}: bf16 or f32, got {xl.dtype}/{xr.dtype}/{att.dtype}")
    if not (xr.device == att.device == xl.device):
        raise ValueError(f"{name}: all inputs must be on one device")
    if not (xl.is_contiguous() and xr.is_contiguous()):
        raise ValueError(f"{name}: xl and xr must be contiguous")


def slot_attention_bwd_ref(xl, xr, att, g, heads: int, cdim: int):
    """Plain twin of the backward: the math of ``grid_gnn_pallas.py:17-21``
    written out, in f32.

    xl/xr/g: (..., X, Y, heads*cdim); att: (heads, cdim).  Returns (dxl like
    xl, dxr like xr, datt f32 (heads, cdim) summed over every leading dim).
    """
    lead = xl.shape[:-1]
    X, Y = xl.shape[-3], xl.shape[-2]
    xl32 = xl.float()
    xr_h = xr.float().reshape(*lead, heads, cdim)
    g_h = g.float().reshape(*lead, heads, cdim)
    att32 = att.float()
    vs, us, logits, gvs, masks = [], [], [], [], []
    for dx, dy in SHIFTS:
        vh = torch.roll(xl32, (-dx, -dy), dims=(-3, -2)).reshape(*lead, heads, cdim)
        u = xr_h + vh
        e = torch.where(u > 0, u, NEG_SLOPE * u)
        vs.append(vh)
        us.append(u)
        logits.append((e * att32).sum(-1))  # (..., X, Y, H)
        gvs.append((g_h * vh).sum(-1))
        masks.append(_slot_mask(X, Y, dx, dy, xl.device)[:, :, None])
    logits = torch.stack([torch.where(m, lg, -torch.inf) for lg, m in zip(logits, masks)])
    alpha = torch.softmax(logits, dim=0)  # (S, ..., X, Y, H); 0 on masked slots
    gbar = (alpha * torch.stack(gvs)).sum(0)
    dxr = torch.zeros_like(xr_h)
    dxl = torch.zeros_like(xl32)
    datt = torch.zeros_like(att32)
    for s, (dx, dy) in enumerate(SHIFTS):
        dl = (alpha[s] * (gvs[s] - gbar))[..., None]  # (..., X, Y, H, 1)
        du = torch.where(us[s] > 0, 1.0, NEG_SLOPE)
        chain = dl * att32 * du
        dxr = dxr + chain
        contrib = (alpha[s][..., None] * g_h + chain).reshape(*lead, heads * cdim)
        dxl = dxl + torch.roll(contrib, (dx, dy), dims=(-3, -2))  # back to the source pixel
        e = torch.where(us[s] > 0, us[s], NEG_SLOPE * us[s])
        datt = datt + (dl * e).reshape(-1, heads, cdim).sum(0)
    return dxl.to(xl.dtype), dxr.reshape(*lead, heads * cdim).to(xr.dtype), datt


# The kernels' plans (csrc/grid_slot_attention.cu; the constants are the
# source's, tests/test_torch_kernel_plans.py reads them from it)
STRIP = 30  # x-rows a backward block owns; the longest forward strip
BWD_THREADS = 256  # consumers of a backward block at most (one more warp issues the copies)
FWD_THREADS = 256  # the same for a forward block
STAT_RING = 3  # rows of alpha/dlogit a block keeps
LIVE_UNITS = 3  # row units a step reads; the ring holds more than this many
DATT_THREADS = 256  # threads of datt's reducing launch, one block a channel
SMEM_MAX = 232448  # dynamic shared memory a block may have (H100)
SMEM_SHARED = 115712  # a block's share where two blocks share an SM


def channel_group(cdim: int) -> tuple[int, int, int]:
    """``(vec, group, chunks)`` of both kernels: channels a load (4 where C
    allows it, else 1), threads a (pixel, head) (a power of two, at most 32,
    so that each takes at most 4 chunks where it can) and the chunks each
    takes (a chunk is ``vec`` channels; thread ``sub`` takes chunks ``sub +
    group k``)."""
    vec = 4 if cdim % 4 == 0 else 1
    n = cdim // vec
    group = 1
    while group < 32 and -(-n // group) > 4:
        group *= 2
    return vec, group, -(-n // group)


def fwd_threads(ytile: int, heads: int, group: int, rows: int = 1) -> int:
    """Consumer threads of a forward block: ``rows`` rows at a time, each a
    row's pixels x heads x ``group`` in whole warps, at most
    :data:`FWD_THREADS` (``row_threads`` in the source)."""
    return rows * min(FWD_THREADS, -(-ytile * heads * group // 32) * 32)


def fwd_smem(ytile: int, stages: int, heads: int, cdim: int, elem: int, rows: int = 1) -> int:
    """Shared memory of a forward block (``FwdSmem`` in the source): the ring
    of ``stages`` units of two buffers of ``rows`` rows (xl, xr; a unit of
    one row keeps ``ytile + 2`` pixels a row after a pad that puts the
    tile's first pixel on 16 bytes, a unit of several whole rows back to
    back), att in f32, a pixel of zeros, the mbarriers, 128 bytes of
    alignment slack."""
    F = heads * cdim
    pad = (16 - F * elem % 16) % 16 if rows == 1 else 0
    row = (ytile + 2 if rows == 1 else ytile) * F
    buf = -(-(pad + rows * row * elem) // 16) * 16
    return stages * 2 * buf + -(-F * 4 // 16) * 16 + -(-F * elem // 16) * 16 + 16 * stages + 128


def fwd_plan(Bf: int, X: int, Y: int, heads: int, cdim: int, elem: int,
             sms: int = _build.H100_SMS) -> tuple[int, int, int, int, int]:
    """``(strip, ytile, stages, group, rows)`` of the forward kernel: the
    whole row as the column tile where a ring of 4 one-row units fits a
    block, else the widest tile whose ring does; the longest strip, up to
    :data:`STRIP` rows, that still gives two blocks to each of ``sms`` SMs
    (one row a block where even that falls short); over whole rows, units
    of as many rows as :data:`FWD_THREADS` consumers write at a time (at
    most the strip's), so that narrow rows travel in fewer, longer copies;
    then the deepest ring of 6, 5 or 4 units in half an SM's shared memory
    (two blocks an SM), else in all of it."""
    X, Y = max(X, 1), max(Y, 1)
    group = channel_group(cdim)[1]
    ytile = Y if fwd_smem(Y, 4, heads, cdim, elem) <= SMEM_MAX else max(
        t for t in range(1, Y + 1) if fwd_smem(t, 4, heads, cdim, elem) <= SMEM_MAX)
    strip = max(1, min(STRIP, Bf * X * -(-Y // ytile) // (2 * sms)))
    rows = max(1, min(strip, FWD_THREADS // fwd_threads(ytile, heads, group))) \
        if ytile == Y else 1
    stages = next(st for budget in (SMEM_SHARED, SMEM_MAX) for st in (6, 5, 4)
                  if fwd_smem(ytile, st, heads, cdim, elem, rows) <= budget)
    return strip, ytile, stages, group, rows


def fwd_blocks(Bf: int, X: int, Y: int, strip: int, ytile: int) -> int:
    """Blocks of the forward: frames x strips x column tiles."""
    return Bf * len(strips(X, strip)) * -(-Y // ytile)


def bwd_threads(ytile: int, heads: int, cdim: int) -> int:
    """Consumer threads of a backward block: a row's stat pixels x heads x
    ``group``, in whole warps, at most :data:`BWD_THREADS`."""
    return min(BWD_THREADS, -(-(ytile + 2) * heads * channel_group(cdim)[1] // 32) * 32)


def bwd_smem(ytile: int, stages: int, heads: int, cdim: int, elem: int) -> int:
    """Shared memory of a backward block (``BwdSmem`` in the source): the
    ring of ``stages`` units of three row buffers (``ytile + 4`` pixels of
    xl, xr, g after a pad that puts the tile's first pixel on 16 bytes) or
    the datt partials that reuse it, the alpha/dlogit ring, att in f32, a
    pixel of zeros (what a slot off the grid reads), the mbarriers, 128
    bytes of alignment slack."""
    F = heads * cdim
    pad = (16 - 2 * F * elem % 16) % 16
    buf = -(-(pad + (ytile + 4) * F * elem) // 16) * 16
    red = BWD_THREADS // (heads * channel_group(cdim)[1]) * F * 4
    ring = max(stages * 3 * buf, red)
    stats = -(-STAT_RING * (ytile + 2) * heads * 10 * 4 // 16) * 16
    return ring + stats + -(-F * 4 // 16) * 16 + -(-F * elem // 16) * 16 + 16 * stages + 128


def bwd_plan(Y: int, heads: int, cdim: int, elem: int) -> tuple[int, int, int]:
    """``(ytile, stages, group)`` of the backward kernel: the whole row as
    the column tile with a ring of 6 or 5 units, in half an SM's shared
    memory where that fits (two blocks an SM), else in all of it; else the
    widest column tile whose ring of 5 units fits."""
    group = channel_group(cdim)[1]
    for budget in (SMEM_SHARED, SMEM_MAX):
        for stages in (6, 5):
            if bwd_smem(Y, stages, heads, cdim, elem) <= budget:
                return Y, stages, group
    ytile = max(t for t in range(1, Y + 1) if bwd_smem(t, 5, heads, cdim, elem) <= SMEM_MAX)
    return ytile, 5, group


def strips(X: int, strip: int = STRIP) -> list[tuple[int, int]]:
    """The x-rows ``[x0, x1)`` of each strip of a frame, in block order."""
    return [(x0, min(x0 + strip, X)) for x0 in range(0, X, strip)]


def bwd_blocks(Bf: int, X: int, Y: int, ytile: int) -> int:
    """Blocks of the backward's first launch: frames x strips x column tiles."""
    return Bf * len(strips(X)) * -(-Y // ytile)


def slot_attention_bwd(xl, xr, att, g, heads: int, cdim: int):
    """(dxl, dxr, datt f32 (heads, cdim)) for ``g = dL/dout``.

    CUDA tensors launch the backward kernels (two launches) or raise; CPU
    tensors take :func:`slot_attention_bwd_ref`.  Shapes and dtypes as
    :func:`fused_slot_attention`; needs heads*cdim <= 256 on the card.
    """
    if xl.device.type == "cpu":
        return slot_attention_bwd_ref(xl, xr, att, g, heads, cdim)
    _check_cuda("slot_attention_bwd", xl, xr, att, heads, cdim)
    g = g.to(xl.dtype).contiguous()
    Bf, X, Y, F = xl.shape
    att32 = att.float().contiguous()
    dxl, dxr = torch.empty_like(xl), torch.empty_like(xr)
    datt = torch.empty(heads, cdim, dtype=torch.float32, device=xl.device)
    ytile, stages, group = bwd_plan(Y, heads, cdim, xl.element_size())
    partial = torch.empty(bwd_blocks(Bf, X, Y, ytile), F, dtype=torch.float32, device=xl.device)
    lib = _build.load()
    with torch.cuda.device(xl.device):
        err = lib.grid_slot_attention_bwd(
            xl.data_ptr(), xr.data_ptr(), att32.data_ptr(), g.data_ptr(), dxl.data_ptr(),
            dxr.data_ptr(), datt.data_ptr(), partial.data_ptr(), Bf, X, Y, heads, cdim,
            ytile, stages, group, int(xl.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "grid_slot_attention_bwd")
    slot_attention_bwd.launches += 1
    return dxl, dxr, datt


class SlotAttention(torch.autograd.Function):
    """Slot attention whose backward is the backward kernels
    (``grid_gnn_pallas.py:318-337``).  Saves (xl, xr, att)."""

    @staticmethod
    def forward(ctx, xl, xr, att, heads: int, cdim: int):
        ctx.save_for_backward(xl, xr, att)
        ctx.heads = (heads, cdim)
        return fused_slot_attention(xl, xr, att, heads, cdim)

    @staticmethod
    def backward(ctx, g):
        xl, xr, att = ctx.saved_tensors
        dxl, dxr, datt = slot_attention_bwd(xl, xr, att, g, *ctx.heads)
        return dxl, dxr, datt.to(att.dtype), None, None


def slot_attention(xl, xr, att, heads: int, cdim: int) -> torch.Tensor:
    """:func:`fused_slot_attention` with a gradient."""
    return SlotAttention.apply(xl, xr, att, heads, cdim)


fused_slot_attention.launches = 0  # kernel launches in this process
slot_attention_bwd.launches = 0
