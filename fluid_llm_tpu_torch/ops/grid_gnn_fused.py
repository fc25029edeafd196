"""Fused five-slot grid GATv2 attention, forward only.

Counterpart of ``fluid_llm_tpu/ops/grid_gnn_pallas.py``.  The kernel is
``csrc/grid_slot_attention.cu`` (CUDA C++ for ``sm_90a``); it replaces the
TPU kernel ``fluid_llm_tpu/ops/grid_gnn_pallas.py:_fwd_kernel``.

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
and are not carried over.  The backward (``_bwd_kernel``) comes with
training.
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
    """
    if xl.device.type == "cpu":
        return slot_attention_ref(xl, xr, att, heads, cdim)
    if xl.device.type != "cuda":
        raise ValueError(f"fused_slot_attention: unsupported device {xl.device}")
    if xl.dim() != 4 or xl.shape[-1] != heads * cdim or xr.shape != xl.shape:
        raise ValueError(
            f"fused_slot_attention: xl {tuple(xl.shape)}, xr {tuple(xr.shape)}, "
            f"heads {heads} x {cdim}"
        )
    if att.shape != (heads, cdim):
        raise ValueError(f"fused_slot_attention: att {tuple(att.shape)}, expected {(heads, cdim)}")
    if xl.dtype not in (torch.bfloat16, torch.float32) or xr.dtype != xl.dtype or att.dtype != xl.dtype:
        raise ValueError(f"fused_slot_attention: bf16 or f32, got {xl.dtype}/{xr.dtype}/{att.dtype}")
    if not (xr.device == att.device == xl.device):
        raise ValueError("fused_slot_attention: all inputs must be on one device")
    if not (xl.is_contiguous() and xr.is_contiguous()):
        raise ValueError("fused_slot_attention: xl and xr must be contiguous")
    Bf, X, Y, _ = xl.shape
    att32 = att.float().contiguous()
    out = torch.empty_like(xl)
    vec = 16 // xl.element_size()
    vectorized = cdim % vec == 0 and all(t.data_ptr() % 16 == 0 for t in (xl, xr, out, att32))
    lib = _build.load()
    with torch.cuda.device(xl.device):
        err = lib.grid_slot_attention_fwd(
            xl.data_ptr(), xr.data_ptr(), att32.data_ptr(), out.data_ptr(),
            Bf, X, Y, heads, cdim, int(xl.dtype == torch.bfloat16), int(vectorized),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "grid_slot_attention_fwd")
    fused_slot_attention.launches += 1
    return out


fused_slot_attention.launches = 0  # kernel launches in this process
