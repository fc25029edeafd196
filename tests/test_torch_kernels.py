"""Plain twins of the port's CUDA kernels against the Pallas kernels.

The Pallas kernels run in interpret mode on the CPU (as in
``tests/test_exact_attention.py`` and ``tests/test_grid_gnn.py``); the
port's wrappers take their plain PyTorch twins for CPU tensors.  The CUDA
kernels themselves are held against the twins on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid_llm_tpu.ops import exact_attention as jxa
from fluid_llm_tpu.ops.grid_gnn_pallas import _call_bwd as jax_slot_bwd
from fluid_llm_tpu.ops.grid_gnn_pallas import fused_slot_attention as jax_fused_slot_attention
from fluid_llm_tpu_torch.ops import exact_attention as xa
from fluid_llm_tpu_torch.ops import grid_gnn_fused as gf

torch.set_num_threads(2)


@pytest.mark.parametrize("n_invalid", [0, 37])
def test_causal_attention_ref_matches_pallas_interpret(n_invalid):
    """Twin == the Pallas kernel (interpret), f32, with and without invalid
    front tokens, L=300 (uneven query blocks).  atol 2e-5 as the JAX test:
    f32 sums in another order."""
    bs, L, H, hd = 2, 300, 4, 32
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(bs, L, H * hd)).astype(np.float32) * 0.5 for _ in range(3))
    valid = np.broadcast_to((np.arange(L)[None, :] >= n_invalid), (bs, L)).astype(np.int32)
    ref = jxa.causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(valid), H, hd, True)
    got = xa.causal_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), torch.from_numpy(valid), H, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


def test_causal_attention_cpu_takes_twin_and_reads_packed_slices():
    """On CPU tensors the wrapper is the twin and launches nothing; column
    slices of one fused qkv output (row stride 3D) give the same result as
    contiguous copies (exactly: same arithmetic)."""
    bs, L, H, hd = 1, 70, 2, 64
    D = H * hd
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(bs, L, 3 * D, generator=g)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    valid = (torch.arange(L)[None] >= 9).int()
    before = xa.causal_attention.launches
    got = xa.causal_attention(q, k, v, valid, H, hd)
    want = xa.causal_attention_ref(q.contiguous(), k.contiguous(), v.contiguous(), valid, H, hd)
    assert xa.causal_attention.launches == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_slot_attention_ref_matches_pallas_interpret(rng):
    """Twin == the fused Pallas kernel (interpret) at (2, 8, 8, 2x4), f32,
    atol 2e-5 as ``tests/test_grid_gnn.py``."""
    Bf, X, Y, H, C = 2, 8, 8, 2, 4
    xl = rng.normal(size=(Bf, X, Y, H * C)).astype(np.float32)
    xr = rng.normal(size=(Bf, X, Y, H * C)).astype(np.float32)
    att = rng.normal(size=(H, C)).astype(np.float32)
    ref = jax_fused_slot_attention(jnp.asarray(xl), jnp.asarray(xr), jnp.asarray(att), H, C, True)
    got = gf.slot_attention_ref(torch.from_numpy(xl), torch.from_numpy(xr),
                                torch.from_numpy(att), H, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("C", [3, 48])
def test_fused_slot_attention_cpu_takes_twin(rng, C):
    """The wrapper on CPU tensors is the twin (both decoder widths, C 3 and
    48) and launches nothing."""
    xl = torch.from_numpy(rng.normal(size=(1, 12, 6, C)).astype(np.float32))
    xr = torch.from_numpy(rng.normal(size=(1, 12, 6, C)).astype(np.float32))
    att = torch.from_numpy(rng.normal(size=(1, C)).astype(np.float32))
    before = gf.fused_slot_attention.launches
    got = gf.fused_slot_attention(xl, xr, att, 1, C)
    assert gf.fused_slot_attention.launches == before
    torch.testing.assert_close(got, gf.slot_attention_ref(xl, xr, att, 1, C), rtol=0, atol=0)


def test_slot_attention_bwd_ref_matches_pallas_interpret(rng):
    """Backward twin == the fused Pallas backward (interpret) at
    (2, 8, 8, 2x4), f32: dxl, dxr and datt (summed over frames).  atol
    2e-5 as ``tests/test_grid_gnn.py``."""
    Bf, X, Y, H, C = 2, 8, 8, 2, 4
    xl, xr, g = (rng.normal(size=(Bf, X, Y, H * C)).astype(np.float32) for _ in range(3))
    att = rng.normal(size=(H, C)).astype(np.float32)
    ref = jax_slot_bwd(*map(jnp.asarray, (xl, xr, att, g)), H, C, True)
    got = gf.slot_attention_bwd_ref(*map(torch.from_numpy, (xl, xr, att, g)), H, C)
    for t, j, name in zip(got, ref, ("dxl", "dxr", "datt")):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-5, err_msg=name)


@pytest.mark.parametrize("Bf,X,Y,H,C", [(2, 7, 5, 2, 3), (1, 12, 6, 1, 48)])
def test_slot_attention_function_matches_autograd_through_twin(rng, Bf, X, Y, H, C):
    """``SlotAttention`` on CPU tensors (forward twin, explicit backward
    twin) == autograd through ``slot_attention_ref``, f32, odd grid sizes,
    multi-head and the decoder's C 48; atol 1e-5 (sums of five slots in
    another order).  Launches nothing."""
    arrays = [rng.normal(size=(Bf, X, Y, H * C)).astype(np.float32) for _ in range(3)]
    att = rng.normal(size=(H, C)).astype(np.float32)
    grads = []
    counts = (gf.fused_slot_attention.launches, gf.slot_attention_bwd.launches)
    for fn in (gf.slot_attention, gf.slot_attention_ref):
        xl, xr, a = (torch.from_numpy(x).requires_grad_() for x in (arrays[0], arrays[1], att))
        (fn(xl, xr, a, H, C) * torch.from_numpy(arrays[2])).sum().backward()
        grads.append([xl.grad, xr.grad, a.grad])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    assert (gf.fused_slot_attention.launches, gf.slot_attention_bwd.launches) == counts


def test_wrappers_reject_unsupported_devices():
    """No silent fallback: a non-CPU, non-CUDA tensor raises."""
    q = torch.zeros(1, 4, 64, device="meta")
    with pytest.raises(ValueError):
        xa.causal_attention(q, q, q, torch.ones(1, 4, dtype=torch.int32, device="meta"), 1, 64)
    x = torch.zeros(1, 4, 4, 8, device="meta")
    with pytest.raises(ValueError):
        gf.fused_slot_attention(x, x, torch.zeros(1, 8, device="meta"), 1, 8)
    with pytest.raises(ValueError):
        gf.slot_attention_bwd(x, x, torch.zeros(1, 8, device="meta"), x, 1, 8)
