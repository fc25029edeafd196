"""The port's CUDA kernels against their plain twins, on the card.

Needs an NVIDIA GPU with ``nvcc``; every test here is marked ``cuda`` and
skips elsewhere.  This file imports no jax, so it runs on a machine without
it (the repository's ``conftest.py`` does import jax, hence ``--noconftest``):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance: relative L2 error <= 1e-2 in bf16.  The kernels keep scores,
softmax and sums in f32 and round once; the twins round intermediates to
bf16 (attention probabilities, GATv2 logits and weights), which alone gives
relative errors of a few 1e-3.  The same bound holds the gradients: the
flash backward rounds p and ds to bf16 once each as tensor-core operands
and its outputs once (each ~2^-9 relative); the backward twins compute in
f32 and round their outputs only.  Autograd through the Functions is held
against autograd through the forward twins on f32 copies of the inputs.
"""

import pytest
import torch

from fluid_llm_tpu_torch.ops import exact_attention as xa
from fluid_llm_tpu_torch.ops import flash_attention as fa
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


@pytest.mark.parametrize("bs,L,H,hd,n_invalid", [
    (8, 601, 12, 64, 0), (8, 601, 12, 64, 181), (2, 70, 2, 32, 13), (1, 300, 4, 128, 37),
    (1, 5, 1, 64, 2),
])
def test_flash_kernels_match_twins(dev, bs, L, H, hd, n_invalid):
    """Forward (out, lse) and backward (dq, dk, dv from the kernel's saved
    state) at the training shape and odd ones: tails past a 64-row tile,
    invalid front tokens, every head width."""
    D = H * hd
    g = torch.Generator().manual_seed(L + hd)
    q, k, v = ((torch.randn(bs, L, D, generator=g) * 0.5).to(dev, torch.bfloat16) for _ in range(3))
    dout = torch.randn(bs, L, D, generator=g).to(dev, torch.bfloat16)
    valid = (torch.arange(L)[None] >= n_invalid).expand(bs, L).int().contiguous().to(dev)
    before = (fa.flash_forward.launches, fa.flash_dq.launches, fa.flash_dkv.launches)
    out, lse = fa.flash_forward(q, k, v, valid, H, hd)
    grads = fa.flash_backward(q, k, v, valid, out, lse, dout, H, hd)
    torch.cuda.synchronize()
    assert (fa.flash_forward.launches, fa.flash_dq.launches, fa.flash_dkv.launches) == \
        tuple(n + 1 for n in before)
    ref_out, ref_lse = fa.flash_forward_ref(q, k, v, valid, H, hd)
    assert _rel(out, ref_out) <= REL_TOL
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    for got, want in zip(grads, fa.flash_backward_ref(q, k, v, valid, out, lse, dout, H, hd)):
        assert _rel(got, want) <= REL_TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Bf,X,Y,H,C", [
    (80, 240, 64, 1, 48), (80, 240, 64, 1, 3), (4, 240, 64, 2, 24), (2, 8, 8, 2, 4),
])
def test_slot_attention_bwd_kernel_matches_twin(dev, dtype, Bf, X, Y, H, C):
    """dxl, dxr, datt at the training decoder's shapes (80 frames); the
    result is the same bit for bit on a second call (no atomics)."""
    g = torch.Generator().manual_seed(X + C)
    xl, xr, dout = (torch.randn(Bf, X, Y, H * C, generator=g).to(dev, dtype) for _ in range(3))
    att = torch.randn(H, C, generator=g).to(dev, dtype)
    before = gf.slot_attention_bwd.launches
    got = gf.slot_attention_bwd(xl, xr, att, dout, H, C)
    again = gf.slot_attention_bwd(xl, xr, att, dout, H, C)
    torch.cuda.synchronize()
    assert gf.slot_attention_bwd.launches == before + 2
    tol = REL_TOL if dtype == torch.bfloat16 else 1e-5
    for a, b, w in zip(got, again, gf.slot_attention_bwd_ref(xl, xr, att, dout, H, C)):
        assert torch.equal(a, b)
        assert _rel(a, w) <= tol


def test_exact_kernels_raise_under_autograd(dev):
    """The forward-only kernels refuse inputs that need a gradient when
    grad is enabled (the gradient would stop there silently); under
    no_grad, or on inputs without grad, they run."""
    q = torch.randn(1, 70, 128, device=dev, dtype=torch.bfloat16, requires_grad=True)
    valid = torch.ones(1, 70, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="forward only"):
        xa.causal_attention(q, q, q, valid, 2, 64)
    xl = torch.randn(1, 8, 8, 8, device=dev, requires_grad=True)
    att = torch.randn(1, 8, device=dev)
    with pytest.raises(RuntimeError, match="forward only"):
        gf.fused_slot_attention(xl, xl, att, 1, 8)
    with torch.no_grad():
        xa.causal_attention(q, q, q, valid, 2, 64)
        gf.fused_slot_attention(xl, xl, att, 1, 8)
    xa.causal_attention(q.detach(), q.detach(), q.detach(), valid, 2, 64)


def test_functions_match_autograd_through_twins(dev):
    """Gradients through ``FlashAttention`` and ``SlotAttention`` (their
    kernels) against autograd through the forward twins run in f32 on the
    same bf16 inputs."""
    g = torch.Generator().manual_seed(7)
    bs, L, H, hd = 2, 130, 4, 64
    base = [(torch.randn(bs, L, H * hd, generator=g) * 0.5).to(dev, torch.bfloat16)
            for _ in range(3)]
    valid = (torch.arange(L)[None] >= torch.tensor([[0], [40]])).int().contiguous().to(dev)
    w = torch.randn(bs, L, H * hd, generator=g).to(dev)
    ts = [t.clone().requires_grad_() for t in base]
    (fa.flash_attention(*ts, valid, H, hd).float() * w).sum().backward()
    refs = [t.float().requires_grad_() for t in base]
    (fa.flash_forward_ref(*refs, valid, H, hd)[0] * w).sum().backward()
    for t, r in zip(ts, refs):
        assert _rel(t.grad, r.grad) <= REL_TOL

    xs = [torch.randn(80, 240, 64, 48, generator=g).to(dev, torch.bfloat16) for _ in range(2)]
    att = torch.randn(1, 48, generator=g).to(dev, torch.bfloat16)
    w = torch.randn(80, 240, 64, 48, generator=g).to(dev)
    ts = [t.clone().requires_grad_() for t in (*xs, att)]
    (gf.slot_attention(*ts, 1, 48).float() * w).sum().backward()
    refs = [t.float().requires_grad_() for t in (*xs, att)]
    (gf.slot_attention_ref(*refs, 1, 48) * w).sum().backward()
    for t, r in zip(ts, refs):
        assert _rel(t.grad, r.grad) <= REL_TOL


@pytest.mark.parametrize("mode", ["autoreg", "gen"])
def test_train_steps_on_card(dev, mode):
    """A small bf16 model (2 layers, hd 64, DoRA, dropout on, MLPGNN) takes
    two train steps of each mode on the card: the loss is finite, every
    training kernel launched, and ``gen``'s guide rollout (no grad) ran
    through the forward-only kernels."""
    from fluid_llm_tpu.config import Config
    from fluid_llm_tpu_torch.data import make_batches
    from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
    from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
    from fluid_llm_tpu_torch.train.trainer import Trainer

    cfg = Config(llm_backbone="gpt2", llm_layers=2, half_precision=True, batch_size=2,
                 autoreg_seq_len=5, resolution=64, flash_attention=True,
                 lora_config={"r": 4, "lora_alpha": 16, "use_dora": True},
                 decoder_params={"type": "MLPGNN", "gnn_dim": 8, "gnn_hid_dim": 16,
                                 "gnn_layers": 2, "mlp_hid_dim": 32},
                 encoder_params={"type": "MLP", "num_layers": 2, "hidden_dim": 32})
    ds = SyntheticCylinderDataset(n_trajectories=2, resolution=64, seq_len=5, mode="valid")
    model = FluidLLM.build(cfg, ds.ds_props(), d_model=128, n_heads=2, d_ff=256)
    model.init_weights(torch.Generator().manual_seed(0))
    trainer = Trainer(model.to(dev))
    batch = next(make_batches(ds, 2, shuffle=False, device=dev))
    counters = (fa.flash_forward, fa.flash_dq, fa.flash_dkv, gf.fused_slot_attention,
                gf.slot_attention_bwd, xa.causal_attention)
    before = [fn.launches for fn in counters]
    losses = [trainer.train_step(batch, mode)["loss"].item() for _ in range(2)]
    torch.cuda.synchronize()
    ran = [fn.launches - b for fn, b in zip(counters, before)]
    assert all(torch.isfinite(torch.tensor(losses)))
    assert ran[:3] == [4, 4, 4] and ran[4] == 4  # 2 layers, 2 convs, 2 steps
    # gen: 3-step guide rollouts through the exact kernel (layer 0 of 2)
    assert ran[5] == (6 if mode == "gen" else 0)
