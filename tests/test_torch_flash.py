"""The training attention's plain twins against the Pallas flash kernels.

The Pallas kernels run in interpret mode on the CPU (as in
``tests/test_flash.py``), in f32; the port's twins take the same numpy
inputs in the packed ``(bs, L, H*hd)`` layout.  Tolerances: atol 2e-5 on
outputs and 1e-5 on the logsumexp (f32, sums in another order, as the JAX
test), 1e-4 on gradients (sums over up to L terms of products of
unit-scale values).  The CUDA kernels are held against the twins on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid_llm_tpu.ops.flash_attention import _flash_backward, _flash_forward_lse
from fluid_llm_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

CASES = [
    (2, 200, 4, 64, (150, 200)),  # one partially valid batch row
    (1, 128, 2, 64, (1,)),  # only the first token valid
    (2, 300, 3, 64, (0, 37)),  # a fully invalid row: the diagonal alone
    (1, 601, 2, 64, (421,)),  # the training window's length, 181 invalid
]


def _inputs(rng, bs, L, H, hd, starts):
    q, k, v, g = (rng.normal(size=(bs, L, H, hd)).astype(np.float32) for _ in range(4))
    valid = np.stack([np.arange(L) < s for s in starts])
    return q, k, v, g, valid


def _packed(x):
    return torch.from_numpy(x.reshape(x.shape[0], x.shape[1], -1))


@pytest.mark.parametrize("bs,L,H,hd,starts", CASES)
def test_flash_twins_match_pallas_interpret(rng, bs, L, H, hd, starts):
    """Forward (every row, invalid ones included: the forced diagonal makes
    them deterministic) and the row logsumexp; then the backward from the
    same saved state."""
    q, k, v, g, valid = _inputs(rng, bs, L, H, hd, starts)
    jq, jk, jv, jg, jvalid = map(jnp.asarray, (q, k, v, g, valid))
    jout, jlse = _flash_forward_lse(jq, jk, jv, jvalid, interpret=True)
    out, lse = fa.flash_forward_ref(_packed(q), _packed(k), _packed(v),
                                    torch.from_numpy(valid).int(), H, hd)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout).reshape(bs, L, -1), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse).reshape(bs, H, -1)[..., :L],
                               atol=1e-5)

    jdq, jdk, jdv = _flash_backward(jq, jk, jv, jvalid, jout, jlse, jg, interpret=True)
    got = fa.flash_backward_ref(_packed(q), _packed(k), _packed(v),
                                torch.from_numpy(valid).int(), out, lse, _packed(g), H, hd)
    for t, j, name in zip(got, (jdq, jdk, jdv), "qkv"):
        np.testing.assert_allclose(t.numpy(), np.asarray(j).reshape(bs, L, -1), atol=1e-4,
                                   err_msg=f"d{name}")


def test_flash_function_cpu_matches_autograd_through_twin(rng):
    """``FlashAttention`` on CPU tensors (its twins, its own backward)
    equals autograd through the forward twin, and launches nothing."""
    bs, L, H, hd = 2, 97, 3, 32
    q, k, v, g, valid = _inputs(rng, bs, L, H, hd, (97, 60))
    valid = torch.from_numpy(valid).int()
    counts = (fa.flash_forward.launches, fa.flash_dq.launches, fa.flash_dkv.launches)
    grads = []
    for use_fn in (True, False):
        ts = [_packed(x).requires_grad_() for x in (q, k, v)]
        if use_fn:
            out = fa.flash_attention(*ts, valid, H, hd)
        else:
            out = fa.flash_forward_ref(*ts, valid, H, hd)[0]
        (out * _packed(g)).sum().backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    assert (fa.flash_forward.launches, fa.flash_dq.launches, fa.flash_dkv.launches) == counts


def test_flash_twin_masked_rows_stay_finite():
    """No valid key at all: every row keeps its diagonal, lse is finite."""
    q = torch.randn(1, 64, 128)
    out, lse = fa.flash_forward_ref(q, q, q, torch.zeros(1, 64, dtype=torch.int32), 2, 64)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()


def test_flash_kernels_reject_unsupported_devices():
    """No silent fallback: the kernel entry points raise off CUDA."""
    q = torch.zeros(1, 4, 64, device="meta")
    valid = torch.ones(1, 4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        fa.flash_forward(q, q, q, valid, 1, 64)
    lse = torch.zeros(1, 1, 4, device="meta")
    with pytest.raises(ValueError):
        fa.flash_dq(q, q, q, q, lse, lse.reshape(1, 4, 1), valid, 1, 64)
