"""The port's CUDA kernels against their plain twins, on the card.

Needs an NVIDIA GPU with ``nvcc``; every test here is marked ``cuda`` and
skips elsewhere.  This file imports no jax, so it runs on a machine without
it (the repository's ``conftest.py`` does import jax, hence ``--noconftest``):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance: relative L2 error <= 1e-2 in bf16.  The kernels keep scores,
softmax and sums in f32 and round once; the twins round intermediates to
bf16 (attention probabilities, GATv2 logits and weights), which alone gives
relative errors of a few 1e-3.
"""

import pytest
import torch

from fluid_llm_tpu_torch.ops import exact_attention as xa
from fluid_llm_tpu_torch.ops import grid_gnn_fused as gf

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda
REL_TOL = 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.parametrize("L,H,hd,n_invalid", [
    (661, 12, 64, 0), (661, 12, 64, 181), (300, 4, 32, 37), (300, 4, 128, 0), (5, 1, 64, 2),
])
def test_exact_attention_kernel_matches_twin(dev, L, H, hd, n_invalid):
    D = H * hd
    g = torch.Generator().manual_seed(L + hd)
    qkv = (torch.randn(1, L, 3 * D, generator=g) * 0.5).to(dev, torch.bfloat16)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    valid = (torch.arange(L)[None] >= n_invalid).int().to(dev)
    before = xa.causal_attention.launches
    out = xa.causal_attention(q, k, v, valid, H, hd)
    torch.cuda.synchronize()
    assert xa.causal_attention.launches == before + 1
    assert _rel(out, xa.causal_attention_ref(q, k, v, valid, H, hd)) <= REL_TOL


def test_exact_attention_kernel_rejects_f32(dev):
    q = torch.zeros(1, 8, 64, device=dev)
    with pytest.raises(ValueError):
        xa.causal_attention(q, q, q, torch.ones(1, 8, dtype=torch.int32, device=dev), 1, 64)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Bf,X,Y,H,C", [
    (1, 240, 64, 1, 48), (1, 240, 64, 1, 3), (4, 240, 64, 2, 24), (2, 8, 8, 2, 4),
])
def test_slot_attention_kernel_matches_twin(dev, dtype, Bf, X, Y, H, C):
    g = torch.Generator().manual_seed(X + C)
    xl, xr = (torch.randn(Bf, X, Y, H * C, generator=g).to(dev, dtype) for _ in range(2))
    att = torch.randn(H, C, generator=g).to(dev, dtype)
    before = gf.fused_slot_attention.launches
    out = gf.fused_slot_attention(xl, xr, att, H, C)
    torch.cuda.synchronize()
    assert gf.fused_slot_attention.launches == before + 1
    tol = REL_TOL if dtype == torch.bfloat16 else 1e-5
    assert _rel(out, gf.slot_attention_ref(xl, xr, att, H, C)) <= tol
