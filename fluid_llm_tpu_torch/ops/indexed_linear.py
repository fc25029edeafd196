"""Indexed linear: ``y = x @ w[li] + b[li]`` from a stacked weight, ``li`` on the device.

Counterpart of ``fluid_llm_tpu/ops/indexed_linear.py``.  The kernel is
``csrc/indexed_linear.cu`` (CUDA C++ for ``sm_90a``); it replaces the TPU
kernel ``fluid_llm_tpu/ops/indexed_linear.py:_kernel`` (launched by
``_call``).  The stacked layout (``backbone.stack_layers``) keeps every
layer's linear at one place of the block in one ``(n_layers, N, K)``
weight (the ``nn.Linear`` orientation; the JAX leaf is ``(n_layers, K,
N)``), and the stacked streaming step (``backbone.apply_streaming``) runs
each of its linears through :func:`indexed_linear` with the layer index as
a device int32 scalar, the counterpart of the scan's traced index.

On the TPU the kernel removed a dynamic-slice copy that XLA made before the
matmul.  In PyTorch ``w[li]`` with a host index is a view, not a copy, so
the kernel's one structural advantage here is that the index stays on the
device: the host never reads it (a CUDA-graphed step could keep its layer
counter there).  At the streaming step's 60 rows the call is bound by the
weight bytes and by each block's chain (the layer index, the weight's
first trip from HBM, the products, the reduction): the kernel is one
warpgroup a block running ``wgmma`` on tiles that TMA copies into a ring
of shared-memory stages on mbarriers, and splits K across the blocks of a
thread-block cluster, reduced in rank order through distributed shared
memory (deterministic); :func:`plan` picks the column tile and the K split
per shape (the source's header has the detail).

Forward only, as the TPU kernel by design (``indexed_linear.py:18-22``): on
CUDA the wrapper raises under autograd.  The bias is added outside the
kernel, in the activation dtype, as ``indexed_linear.py:126-130``.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from fluid_llm_tpu_torch.ops import _build

TILE = 128  # K and N must be multiples of it (the TPU kernel's lane rule)
ROW_TILE = 64  # rows of the kernel's block tile
K_STEP = 64  # depth of the kernel's K step: a K split takes whole steps
COLUMN_TILES = (64, 32, 16)  # the kernel's column tiles (wgmma's N), widest first
MAX_K_SPLIT = 8  # blocks of a cluster, the portable limit
SMEM_BYTES = 232448  # dynamic shared memory a block may have (H100)


def ring_steps(block_n: int) -> int:
    """K steps the kernel's ring holds at a column tile: as many 64-deep
    x and weight tiles as fit beside the split's f32 slots (``Smem`` in
    ``csrc/indexed_linear.cu``, the same sum), at most 16."""
    slots = 4 * (ROW_TILE * block_n + 4 * MAX_K_SPLIT)
    stage = (ROW_TILE + block_n) * K_STEP * 2
    return min(16, (SMEM_BYTES - 1024 - slots - 8 * 16) // stage)


def plans(M: int, K: int, N: int) -> list[tuple[int, int, int]]:
    """Every ``(blocks, block_n, k_split)`` the kernel takes for ``x (M, K) @
    w (N, K)^T``: a column tile dividing N and a K split (a cluster of that
    many blocks, each a contiguous run of whole 64-deep K steps), with its
    grid of ``ceil(M / 64) x N / block_n x k_split`` blocks."""
    m_tiles, steps = -(-M // ROW_TILE), K // K_STEP
    return [(m_tiles * N // block_n * k_split, block_n, k_split)
            for block_n in COLUMN_TILES if N % block_n == 0
            for k_split in range(1, MAX_K_SPLIT + 1) if steps % k_split == 0]


@functools.lru_cache(maxsize=None)
def plan(M: int, K: int, N: int, sms: int = _build.H100_SMS) -> tuple[int, int]:
    """``(block_n, k_split)`` for ``x (M, K) @ w (N, K)^T``, of :func:`plans`
    whose grid does not pass ``sms`` (a block takes most of an SM's shared
    memory, so a second wave runs after the first).  Without a K split
    where a block's whole K run fits its ring: the narrowest column tile,
    the most blocks (the split's reduction through the cluster costs more
    than the x bytes it saves).  Else the largest grid, the wider tile on a
    tie (fewer re-reads of x).  Where every plan passes ``sms`` (many rows),
    the widest tile without a split.  ``chip_smoke.py`` times every plan at
    the streaming step's shapes.  K and N multiples of 128."""
    steps = K // K_STEP
    fits = [p for p in plans(M, K, N) if p[0] <= sms]
    whole = [p for p in fits if p[2] == 1 and steps <= ring_steps(p[1])]
    if whole or fits:
        return max(whole or fits)[1:]
    return COLUMN_TILES[0], 1


def _pick(t: torch.Tensor, li: torch.Tensor) -> torch.Tensor:
    """Layer ``li`` of a stacked tensor, read through the device index."""
    return t.index_select(0, li.reshape(1)).squeeze(0)


def indexed_linear_ref(x, w, b, li) -> torch.Tensor:
    """Plain twin, a port of ``_xla_indexed_linear`` (``indexed_linear.py:86-91``):
    x (..., K); w (n_layers, N, K); b (n_layers, N) or None; li an int32
    tensor of one element on x's device -> (..., N) in x's dtype."""
    y = F.linear(x, _pick(w, li).to(x.dtype))
    if b is not None:
        y = y + _pick(b, li).to(y.dtype)
    return y


def supported(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Shapes the kernel takes (``indexed_linear.py:94-111`` without its TPU
    memory budget): K and N multiples of 128, x in the weight's dtype."""
    K, N = w.shape[2], w.shape[1]
    return K % TILE == 0 and N % TILE == 0 and x.dtype == w.dtype


def indexed_linear(x, w, b, li) -> torch.Tensor:
    """``x (..., K) @ w[li] (N, K)^T + b[li] -> (..., N)``.

    CUDA tensors launch the kernel or raise; CPU tensors take
    :func:`indexed_linear_ref`.  ``li``: int32 tensor of one element on x's
    device (a view into ``torch.arange(n_layers)`` will do)."""
    if x.device.type == "cpu":
        return indexed_linear_ref(x, w, b, li)
    if x.device.type != "cuda":
        raise ValueError(f"indexed_linear: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, b)):
        raise RuntimeError("indexed_linear: the kernel is forward only")
    if w.dim() != 3 or not w.is_contiguous() or w.dtype != torch.bfloat16:
        raise ValueError(f"indexed_linear: w must be contiguous bf16 (n_layers, N, K), got "
                         f"{w.dtype} {tuple(w.shape)}")
    n_layers, N, K = w.shape
    if x.shape[-1] != K or not supported(x, w):
        raise ValueError(f"indexed_linear: x {x.dtype} {tuple(x.shape)} against w "
                         f"{tuple(w.shape)} (K and N multiples of {TILE}, x in w's dtype)")
    if li.dtype != torch.int32 or li.numel() != 1:
        raise ValueError(f"indexed_linear: li must be one int32, got {li.dtype} {tuple(li.shape)}")
    for t, name in ((w, "w"), (b, "b"), (li, "li")):
        if t is not None and t.device != x.device:
            raise ValueError(f"indexed_linear: {name} on {t.device}, x on {x.device}")
    x2 = x.reshape(-1, K)
    if x2.stride(1) != 1 or x2.stride(0) % 8 or x2.data_ptr() % 16:
        x2 = x2.contiguous()  # the kernel reads rows in 16-byte vectors
    M = x2.shape[0]
    block_n, k_split = plan(M, K, N, _build.sm_count(x.device))
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.load().indexed_linear_bf16(
            x2.data_ptr(), x2.stride(0), w.data_ptr(), li.data_ptr(), n_layers, out.data_ptr(),
            M, N, K, block_n, k_split, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "indexed_linear_bf16")
    indexed_linear.launches += 1
    if b is not None:
        out = out + _pick(b, li).to(out.dtype)
    return out.reshape(*x.shape[:-1], N)


indexed_linear.launches = 0  # kernel launches in this process
