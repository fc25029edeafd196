"""Ring attention: context parallelism over the model axis.

Counterpart of ``fluid_llm_tpu/parallel/ring_attention.py``.  Each rank
keeps the queries of its chunk of the tokens while the K/V chunks and their
validity travel around the ring, one point-to-point hop per step
(``comm.exchange``), and the exact softmax accumulates online in f32 under
the backbone's mask (``backbone.make_masks``: key-valid AND index-causal
over global token indices, the diagonal always on; ``ring_attention.py:
80-111``).  As in the JAX package each hop is plain einsums, not a kernel.

The backward (:class:`RingAttention`, a ``torch.autograd.Function``) runs
the ring again from the saved log-sum-exp: each hop adds to this rank's
dq, and dK and dV travel with their K/V chunk, arriving home after the
last hop.

``FluidLLM.forward`` with ``parallel.ring_attention`` (which needs
``seq_sharded_acts`` and ``model_axis > 1``) pads the tokens to a multiple
of the axis with invalid ones and runs every block on its chunk
(``Backbone._chunk_tokens``); the model axis then carries tokens, so the
backbone is whole on each rank and its gradients sum over the axis.
"""

from __future__ import annotations

import torch

from fluid_llm_tpu_torch.parallel import comm


def _allowed(me: int, src: int, Lq: int, Lk: int, valid_k: torch.Tensor) -> torch.Tensor:
    """(bs, 1, Lq, Lk): the queries of chunk ``me`` against the keys of
    chunk ``src`` (``valid_k`` their (bs, Lk) validity)."""
    gq = me * Lq + torch.arange(Lq, device=valid_k.device)
    gk = src * Lk + torch.arange(Lk, device=valid_k.device)
    causal = gq[:, None] >= gk[None, :]
    diag = gq[:, None] == gk[None, :]
    return ((causal[None] & valid_k.bool()[:, None, :]) | diag[None])[:, None]


class RingAttention(torch.autograd.Function):
    """q, k, v (bs, L/n, H, hd) of this rank's chunk, valid (bs, L/n)
    int32 -> (bs, L/n, H, hd) in q's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, valid, g: comm.Group):
        n, me = g.size, g.index
        bs, Lq, H, hd = q.shape
        scale = hd ** -0.5
        qf = q.float()
        m = q.new_full((bs, H, Lq), float("-inf"), dtype=torch.float32)
        l = torch.zeros_like(m)
        acc = q.new_zeros((bs, H, Lq, hd), dtype=torch.float32)
        kc, vc, valc, src = k, v, valid, me
        for step in range(n):
            s = torch.einsum("bqhd,bkhd->bhqk", qf, kc.float()) * scale
            s = s.masked_fill(~_allowed(me, src, Lq, kc.shape[1], valc), float("-inf"))
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
            p = torch.exp(s - m_safe[..., None])
            coef = torch.where(torch.isfinite(m), torch.exp(m - m_safe), torch.zeros_like(m))
            l = l * coef + p.sum(-1)
            acc = acc * coef[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vc.float())
            m = m_new
            if step < n - 1:
                nxt, prv = (me + 1) % n, (me - 1) % n
                kc, vc = comm.exchange(kc, g, nxt, prv), comm.exchange(vc, g, nxt, prv)
                valc = comm.exchange(valc, g, nxt, prv)
                src = (src - 1) % n
        out = acc / l.clamp_min(1e-37)[..., None]
        lse = m + torch.log(l)  # every row keeps its diagonal: finite
        ctx.save_for_backward(q, k, v, valid, out, lse)
        ctx.g = g
        return out.transpose(1, 2).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, valid, out, lse = ctx.saved_tensors
        g = ctx.g
        n, me = g.size, g.index
        bs, Lq, H, hd = q.shape
        scale = hd ** -0.5
        qf = q.float()
        do = dout.float().transpose(1, 2)  # (bs, H, Lq, hd)
        delta = (do * out).sum(-1)
        dq = torch.zeros_like(out)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        kc, vc, valc, src = k, v, valid, me
        for step in range(n):
            s = torch.einsum("bqhd,bkhd->bhqk", qf, kc.float()) * scale
            s = s.masked_fill(~_allowed(me, src, Lq, kc.shape[1], valc), float("-inf"))
            p = torch.exp(s - lse[..., None])
            dv = dv + torch.einsum("bhqk,bhqd->bkhd", p, do)
            ds = p * (torch.einsum("bhqd,bkhd->bhqk", do, vc.float()) - delta[..., None])
            dq = dq + torch.einsum("bhqk,bkhd->bhqd", ds, kc.float()) * scale
            dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
            nxt, prv = (me + 1) % n, (me - 1) % n
            if step < n - 1:
                kc, vc = comm.exchange(kc, g, nxt, prv), comm.exchange(vc, g, nxt, prv)
                valc = comm.exchange(valc, g, nxt, prv)
                src = (src - 1) % n
            # dK and dV travel with their chunk: after the n-th hop they are home
            dk, dv = comm.exchange(dk, g, nxt, prv), comm.exchange(dv, g, nxt, prv)
        return (dq.transpose(1, 2).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None)


def ring_attention(q, k, v, valid, g: comm.Group) -> torch.Tensor:
    """Exact causal attention of this rank's token chunk over ``g``'s ring:
    q/k/v (bs, L/n, H, hd), valid (bs, L/n) -> (bs, L/n, H, hd).  On a
    group of one rank, the whole sequence."""
    return RingAttention.apply(q, k, v, valid.to(torch.int32), g)


def ring_attend(g: comm.Group, dtype: torch.dtype):
    """The blocks' attention (packed (bs, L/n, H*hd) heads) over the ring."""
    def attend(q, k, v, valid_i32, n_heads: int, head_dim: int) -> torch.Tensor:
        bs, Lq, D = q.shape
        shape = (bs, Lq, n_heads, head_dim)
        out = ring_attention(q.reshape(shape), k.reshape(shape), v.reshape(shape), valid_i32, g)
        return out.to(dtype).reshape(bs, Lq, D)
    return attend


def moe_mlp(h, mlp, cfg, valid_full, capacity_tokens, g: comm.Group):
    """A MoE MLP under the ring: routing and capacity couple the tokens of a
    sequence, so every rank routes the whole sequence (the chunks gathered;
    their gradient reduce-scattered back) and keeps its chunk's output.
    The balance loss, computed alike on every rank, enters the sum over the
    axis once (each rank's share ``1/n``)."""
    from fluid_llm_tpu_torch.models.backbone import moe_mlp as dense_moe

    out, aux = dense_moe(comm.gather_rs(h, g, 1), mlp, cfg, valid_full, capacity_tokens)
    return comm.chunk(out, g, 1), comm.reduce_from(aux / g.size, g)
