"""Decode attention over the streaming slab KV cache, read in place.

Counterpart of ``fluid_llm_tpu/ops/decode_attention.py``.  The kernel is
``csrc/decode_attention.cu`` (CUDA C++ for ``sm_90a``); it replaces the TPU
kernel ``fluid_llm_tpu/ops/decode_attention.py:_kernel`` (``slab_decode``).

What it computes: ``P`` new rope'd queries ``(bs, P, H*hd)`` against layer
``li`` of the stacked cache ``(L, bs, slots, P̂, H*hd)`` (``backbone.
init_streaming_cache``), keys in slab order, with one int32 key-position
row: ``allowed[i, j] = key_pos[j] <= q0 + i`` (INT32_MAX marks slab pad
rows and unwritten slots).  Scores and softmax in f32, probabilities
rounded to bf16 for the PV product, f32 sums.  Forward only.

Bound and design, in short (the source's header has the detail): one
layer's K/V at the flagship shape (11 slots x 64 rows x 768, bs 1) is
~2.2 MB and the step is ~12 x 60 x 704 x 64 x 4 ~= 130 MFLOP, so the
kernel is latency bound: what counts is how many SMs work at once.  It
splits the keys across blocks (split-KV decoding): grid (key split, head,
64-query tile x batch), each split a contiguous run of 64-key tiles
(:func:`split_plan`: 11 splits x 12 heads = 132 blocks at the flagship
shape), read in place from layer ``li`` of the stacked buffer, with an
online softmax that skips tiles no query of the block may see (unwritten
ring slots, every ring slot in the prefill) and prefetches the next
visible tile.  The splits' f32 partials are combined in the same launch,
in split order (deterministic), by the block that takes the last ticket
of a counter the kernel resets itself.  What bounds it now is each
block's chain of round trips: q and K/V in, the partials out, the ticket,
the combine's reads from L2.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fluid_llm_tpu_torch.ops import _build
from fluid_llm_tpu_torch.ops.exact_attention import HEAD_DIMS, row_stride

INT32_MAX = torch.iinfo(torch.int32).max
KEY_TILE = 64  # the kernel's key tile: the key-position row is padded to it
QUERY_TILE = 64  # the kernel's query tile
MAX_SPLITS = 32  # the kernel's combine keeps every split's row statistics in one score tile


@functools.lru_cache(maxsize=None)
def split_plan(n_keys: int, n_heads: int, q_tiles: int, bs: int,
               sms: int = _build.H100_SMS) -> tuple[int, int]:
    """``(n_splits, split_keys)``: the keys' 64-key tiles cut into
    ``n_splits`` contiguous runs of ``split_keys`` keys (the last may be
    shorter, none is empty).  Takes the fewest splits whose grid
    (splits x heads x query tiles x batch) fills a wave of ``sms`` blocks,
    or as many splits as there are tiles (at most ``MAX_SPLITS``)."""
    n_tiles = -(-n_keys // KEY_TILE)
    base = n_heads * q_tiles * bs
    per_min = -(-n_tiles // MAX_SPLITS)  # tiles a split must take at least
    per = next((p for p in range(n_tiles, per_min - 1, -1) if -(-n_tiles // p) * base >= sms),
               per_min)
    return -(-n_tiles // per), per * KEY_TILE


_tickets: dict[torch.device, list[torch.Tensor]] = {}


def _tickets_for(device: torch.device, n: int) -> torch.Tensor:
    """The combine's counters on ``device``, at least ``n``: zeroed once
    here, and every launch leaves them zero.  Launches on one device share
    them, so they must not run concurrently on two streams.  A larger set
    takes over from a smaller one, which stays allocated: a CUDA graph
    captured earlier still points at it."""
    held = _tickets.setdefault(device, [])
    if not held or held[-1].numel() < n:
        held.append(torch.zeros(max(n, 1024), dtype=torch.int32, device=device))
    return held[-1]


def pad_key_pos(kp_row: torch.Tensor) -> torch.Tensor:
    """(slots*P̂,) int32 -> (1, kpad) padded with INT32_MAX to a multiple of
    the kernel's 64-key tile (the TPU kernel padded to its 128 lanes)."""
    pad = (-kp_row.shape[0]) % KEY_TILE
    if pad:
        kp_row = torch.cat([kp_row, kp_row.new_full((pad,), INT32_MAX)])
    return kp_row[None]


def supported(cfg) -> bool:
    """Shape gate (``decode_attention.py:148-155``): full-head attention (no
    grouped-query repeat in the kernel), heads of 32, 64 or 128, bf16.  The
    TPU gate's 128-lane head groups were its tiling and do not apply."""
    return cfg.kv_heads == cfg.n_heads and cfg.head_dim in HEAD_DIMS \
        and cfg.dtype == torch.bfloat16


def slab_decode_ref(q, k_cache, v_cache, key_pos, q0, li: int, head_dim: int) -> torch.Tensor:
    """Plain PyTorch twin: the math of ``_kernel`` and of
    ``backbone._attention_slabs`` (f32 scores and softmax, probabilities in
    the value dtype before PV).

    q: (bs, P, H*hd); k/v_cache: (L, bs, slots, P̂, H*hd); key_pos: (1, kpad)
    int32 with kpad >= slots*P̂; q0: int32 tensor whose first element is the
    first query's position.  Returns (bs, P, H*hd).
    """
    bs, P, D = q.shape
    H = D // head_dim
    slots, pp = k_cache.shape[2:4]
    tot = slots * pp
    k = k_cache[li].reshape(bs, tot, H, head_dim)
    v = v_cache[li].reshape(bs, tot, H, head_dim)
    qpos = q0.reshape(-1)[:1] + torch.arange(P, device=q.device)
    allowed = key_pos[0, :tot][None, :] <= qpos[:, None]  # (P, tot)
    lg = torch.einsum("bqhd,bkhd->bhqk", q.reshape(bs, P, H, head_dim).float(), k.float())
    lg = torch.where(allowed, lg * head_dim ** -0.5, torch.finfo(torch.float32).min)
    p = torch.softmax(lg, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(bs, P, D)


def slab_decode(q, k_cache, v_cache, key_pos, q0, li: int, head_dim: int) -> torch.Tensor:
    """One layer's attention of new queries over the slab cache.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`slab_decode_ref`.  ``q`` may be a column slice of a fused
    projection (any row stride); the caches must be contiguous and are read
    at layer ``li`` in place.  Forward only: on CUDA it raises when autograd
    would need a backward.
    """
    if q.device.type == "cpu":
        return slab_decode_ref(q, k_cache, v_cache, key_pos, q0, li, head_dim)
    if q.device.type != "cuda":
        raise ValueError(f"slab_decode: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k_cache, v_cache)):
        raise RuntimeError("slab_decode: the decode-attention kernel is forward only")
    bs, P, D = q.shape
    if head_dim not in HEAD_DIMS or D % head_dim:
        raise ValueError(f"slab_decode: D {D}, head_dim {head_dim}")
    n_layers, cbs, slots, pp, Dk = k_cache.shape
    if cbs != bs or Dk != D or v_cache.shape != k_cache.shape or not 0 <= li < n_layers:
        raise ValueError(f"slab_decode: q {tuple(q.shape)}, cache {tuple(k_cache.shape)}/"
                         f"{tuple(v_cache.shape)}, layer {li} (full heads only)")
    if not (q.dtype == k_cache.dtype == v_cache.dtype == torch.bfloat16):
        raise ValueError(f"slab_decode: bf16 only, got {q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("slab_decode: the caches must be contiguous")
    n_keys = slots * pp
    for t, name in ((k_cache, "k_cache"), (v_cache, "v_cache"), (key_pos, "key_pos"),
                    (q0, "q0")):
        if t.device != q.device:
            raise ValueError(f"slab_decode: {name} on {t.device}, q on {q.device}")
    if key_pos.dtype != torch.int32 or key_pos.dim() != 2 or key_pos.shape[0] != 1 \
            or key_pos.shape[1] < n_keys or not key_pos.is_contiguous():
        raise ValueError(f"slab_decode: key_pos must be contiguous int32 (1, >= {n_keys})")
    if q0.dtype != torch.int32 or q0.numel() < 1:
        raise ValueError("slab_decode: q0 must be an int32 tensor")
    q_rs = row_stride(q, "q", bs, P, D)
    H, q_tiles = D // head_dim, -(-P // QUERY_TILE)
    n_splits, split_keys = split_plan(n_keys, H, q_tiles, bs, _build.sm_count(q.device))
    out = torch.empty((bs, P, D), dtype=q.dtype, device=q.device)
    part_o = part_ml = tickets = None
    if n_splits > 1:  # the splits' f32 partials: O (64 x hd), then m and l rows
        groups = bs * q_tiles * H
        part = torch.empty(groups * n_splits * QUERY_TILE * (head_dim + 2),
                           dtype=torch.float32, device=q.device)
        part_o, part_ml = part.split([groups * n_splits * QUERY_TILE * head_dim,
                                      groups * n_splits * QUERY_TILE * 2])
        tickets = _tickets_for(q.device, groups)
    lib = _build.load()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(q.device):
        err = lib.slab_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), key_pos.data_ptr(),
            q0.data_ptr(), out.data_ptr(), ptr(part_o), ptr(part_ml), ptr(tickets), bs, P, H,
            head_dim, n_keys, li, q_rs, D, ctypes.c_float(head_dim ** -0.5), n_splits,
            split_keys, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "slab_decode_attention")
    slab_decode.launches += 1
    return out


slab_decode.launches = 0  # kernel launches in this process
