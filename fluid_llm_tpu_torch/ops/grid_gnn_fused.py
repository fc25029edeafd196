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
(frames, X, Y, F) tensors.  The kernel runs one thread per (frame, pixel,
head) in the public channels-last layout, keeps logits, softmax and
accumulator in registers and writes once.  The TPU kernel's channels-first
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


def slot_attention_ref(xl, xr, att, heads: int, cdim: int) -> torch.Tensor:
    """Plain PyTorch twin: a port of ``_xla_slot_attention``
    (``fluid_llm_tpu/ops/grid_gnn_pallas.py:287-307``).

    xl/xr: (..., X, Y, heads*cdim); att: (heads, cdim) -> like xl.
    """
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
    values = torch.stack(values, dim=-3)  # (..., X, Y, S, H, C)
    mask = torch.stack(masks, dim=-1)[..., :, None]  # (X, Y, S, 1)
    logits = torch.where(mask, logits, -torch.inf)
    alpha = torch.softmax(logits, dim=-2).to(xl.dtype)
    out = torch.einsum("...shc,...sh->...hc", values, alpha)
    return out.reshape(*lead, heads * cdim)


def fused_slot_attention(xl, xr, att, heads: int, cdim: int) -> torch.Tensor:
    """xl/xr: (Bf, X, Y, heads*cdim); att: (heads, cdim) -> (Bf, X, Y, heads*cdim).

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`slot_attention_ref`.  bf16 or f32; ``att`` in the same dtype.
    On CUDA it raises when autograd would need a backward (grad enabled and
    an input that requires grad): that goes through :func:`slot_attention`.
    """
    if xl.device.type == "cpu":
        return slot_attention_ref(xl, xr, att, heads, cdim)
    _check_cuda("fused_slot_attention", xl, xr, att, heads, cdim)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xl, xr, att)):
        raise RuntimeError("fused_slot_attention: forward only; under autograd use "
                           "ops.grid_gnn_fused.slot_attention")
    Bf, X, Y, _ = xl.shape
    att32 = att.float().contiguous()
    out = torch.empty_like(xl)
    lib = _build.load()
    with torch.cuda.device(xl.device):
        err = lib.grid_slot_attention_fwd(
            xl.data_ptr(), xr.data_ptr(), att32.data_ptr(), out.data_ptr(),
            Bf, X, Y, heads, cdim, int(xl.dtype == torch.bfloat16),
            int(_vectorized(cdim, xl, xr, out, att32)),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "grid_slot_attention_fwd")
    fused_slot_attention.launches += 1
    return out


def _vectorized(cdim: int, *tensors) -> bool:
    """16-byte channel loads: C a multiple of 16 bytes' worth, every pointer
    16-byte aligned."""
    return cdim % (16 // tensors[0].element_size()) == 0 and \
        all(t.data_ptr() % 16 == 0 for t in tensors)


def _check_cuda(name: str, xl, xr, att, heads: int, cdim: int) -> None:
    if xl.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {xl.device}")
    if xl.dim() != 4 or xl.shape[-1] != heads * cdim or xr.shape != xl.shape:
        raise ValueError(
            f"{name}: xl {tuple(xl.shape)}, xr {tuple(xr.shape)}, heads {heads} x {cdim}"
        )
    if att.shape != (heads, cdim):
        raise ValueError(f"{name}: att {tuple(att.shape)}, expected {(heads, cdim)}")
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


# The backward kernel's plan (csrc/grid_slot_attention.cu; the constants are
# the source's, tests/test_torch_kernel_plans.py reads them from it)
STRIP = 30  # x-rows a block owns
BWD_THREADS = 256  # consumer threads of a block at most (one more warp issues the copies)
STAT_RING = 3  # rows of alpha/dlogit a block keeps
LIVE_UNITS = 3  # row units a step reads; the ring holds more than this many
DATT_THREADS = 256  # threads of datt's reducing launch, one block a channel
SMEM_MAX = 232448  # dynamic shared memory a block may have (H100)
SMEM_SHARED = 115712  # a block's share where two blocks share an SM


def bwd_group(cdim: int) -> tuple[int, int, int]:
    """``(vec, group, chunks)``: channels a load (4 where C allows it, else
    1), threads a (pixel, head) (a power of two, at most 32, so that each
    takes at most 4 chunks where it can) and the chunks each takes (a chunk
    is ``vec`` channels; thread ``sub`` takes chunks ``sub + group k``)."""
    vec = 4 if cdim % 4 == 0 else 1
    n = cdim // vec
    group = 1
    while group < 32 and -(-n // group) > 4:
        group *= 2
    return vec, group, -(-n // group)


def bwd_threads(ytile: int, heads: int, cdim: int) -> int:
    """Consumer threads of a backward block: a row's stat pixels x heads x
    ``group``, in whole warps, at most :data:`BWD_THREADS`."""
    return min(BWD_THREADS, -(-(ytile + 2) * heads * bwd_group(cdim)[1] // 32) * 32)


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
    red = BWD_THREADS // (heads * bwd_group(cdim)[1]) * F * 4
    ring = max(stages * 3 * buf, red)
    stats = -(-STAT_RING * (ytile + 2) * heads * 10 * 4 // 16) * 16
    return ring + stats + -(-F * 4 // 16) * 16 + -(-F * elem // 16) * 16 + 16 * stages + 128


def bwd_plan(Y: int, heads: int, cdim: int, elem: int) -> tuple[int, int, int]:
    """``(ytile, stages, group)`` of the backward kernel: the whole row as
    the column tile with a ring of 6 or 5 units, in half an SM's shared
    memory where that fits (two blocks an SM), else in all of it; else the
    widest column tile whose ring of 5 units fits."""
    group = bwd_group(cdim)[1]
    for budget in (SMEM_SHARED, SMEM_MAX):
        for stages in (6, 5):
            if bwd_smem(Y, stages, heads, cdim, elem) <= budget:
                return Y, stages, group
    ytile = max(t for t in range(1, Y + 1) if bwd_smem(t, 5, heads, cdim, elem) <= SMEM_MAX)
    return ytile, 5, group


def strips(X: int) -> list[tuple[int, int]]:
    """The x-rows ``[x0, x1)`` of each strip of a frame, in block order."""
    return [(x0, min(x0 + STRIP, X)) for x0 in range(0, X, STRIP)]


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
    if heads * cdim > 256:
        raise ValueError(f"slot_attention_bwd: heads*cdim {heads * cdim} > 256")
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
