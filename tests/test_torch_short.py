"""``attn_impl="short"`` and the ``llm_4bit_loading`` guard against the JAX package.

- ``ops/short_attention``: the plain twin, the wrapper on CPU tensors and
  the ``ShortAttention`` Function against the JAX Pallas kernel in
  interpret mode (``tests/test_short_attention.py``'s shapes: invalid
  tokens at the front, as in the right-aligned rollout window), valid rows
  at the stated tolerance and the forced-diagonal rows equal to their own
  value; the Function's gradient against the JAX ``custom_vjp``'s;
- a tiny ``training1.yaml``-shaped model (OPT layout, 2 layers, d 128,
  DoRA, BOS, see-init, MLPGNN, f32) built with ``attn_impl="short"``: one
  autoreg train step's loss and trainable gradients against JAX's
  ``Trainer`` with the same override (on the CPU JAX's ``_sdpa`` falls
  back to its XLA path, the same function), every layer's attention
  through ``ShortAttention``; the stacked exact rollout against JAX's
  stacked one;
- ``llm_4bit_loading`` with adapters or a frozen backbone: the model
  builds and ``main.build_model_and_trainer`` stores its backbone as nf4
  (``tests/test_torch_quant_train.py`` holds that training to JAX's).

Tolerances (f32): atol 2e-5 on attention outputs and 2e-4 on its gradient
(``tests/test_short_attention.py``); 1e-5 relative on the loss and 1e-4 of
each tensor's largest entry on gradients, as ``tests/test_torch_train.py``;
1e-4 absolute on rollouts.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fluid_llm_tpu.config import Config
from fluid_llm_tpu.data.pipeline import make_batches as jmake_batches
from fluid_llm_tpu.data.synthetic import SyntheticCylinderDataset as JSynthetic
from fluid_llm_tpu.models.fluid_llm import FluidLLM as JFluidLLM
from fluid_llm_tpu.ops import short_attention as jsa
from fluid_llm_tpu.rollout.generate import generate as jgenerate
from fluid_llm_tpu.train.trainer import Trainer as JTrainer
from fluid_llm_tpu_torch.data import make_batches
from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
from fluid_llm_tpu_torch.models import backbone as bb
from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
from fluid_llm_tpu_torch.ops import short_attention as sa
from fluid_llm_tpu_torch.rollout.generate import generate
from fluid_llm_tpu_torch.train.trainer import Trainer
from fluid_llm_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

SEQ_LEN = 5
TINY = dict(n_layers=2, d_model=128, n_heads=2, d_ff=256, max_pos=128, dropout=0.0)
TRAINING1 = os.path.join(os.path.dirname(__file__), "..", "configs", "training1.yaml")


def _close(got, want, atol, rtol=0.0, name=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=rtol,
                               err_msg=name)


def _qkv(seed, bs, L, H, hd, n_invalid):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(bs, L, H, hd)).astype(np.float32) for _ in range(3))
    valid = np.broadcast_to(np.arange(L)[None, :] >= n_invalid, (bs, L)).copy()
    return q, k, v, valid


def _packed(t):
    return torch.from_numpy(t.reshape(*t.shape[:2], -1))


@pytest.mark.parametrize("n_invalid", [0, 7, 61])
@pytest.mark.parametrize("L", [61, 64, 128])
def test_short_attention_matches_pallas_interpret(L, n_invalid):
    """The twin, the wrapper and the Function (CPU tensors) against the JAX
    kernel in interpret mode: valid query rows within 2e-5; each invalid
    row (all its earlier keys invalid) sees only its own key, so equals its
    value row: the forced diagonal."""
    bs, H, hd = 2, 3, 64
    q, k, v, valid = _qkv(0, bs, L, H, hd, n_invalid)
    want = np.asarray(jsa.short_attention(*map(jnp.asarray, (q, k, v, valid)), True))
    want = want.reshape(bs, L, H * hd)
    args = (_packed(q), _packed(k), _packed(v), torch.from_numpy(valid).int(), H, hd)
    rows = torch.from_numpy(valid[0])
    for fn in (sa.short_attention_ref, sa.short_attention_fwd, sa.short_attention):
        got = fn(*args)
        assert got.shape == (bs, L, H * hd) and bool(torch.isfinite(got).all())
        _close(got[:, rows], want[:, valid[0]], 2e-5, name=fn.__name__)
        assert torch.equal(got[:, ~rows], _packed(v)[:, ~rows])


@pytest.mark.parametrize("n_invalid", [0, 5])
def test_short_attention_gradient_matches_jax(n_invalid):
    """``ShortAttention``'s backward (the twin recomputed) against JAX's
    ``custom_vjp`` backward (its XLA reference recomputed) of sum(out^2)."""
    bs, L, H, hd = 1, 33, 2, 64
    q, k, v, valid = _qkv(1, bs, L, H, hd, n_invalid)
    jgrads = jax.grad(lambda a, b, c: jnp.sum(jsa.short_attention(a, b, c, valid, True) ** 2),
                      argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_packed(t).requires_grad_() for t in (q, k, v))
    out = sa.short_attention(tq, tk, tv, torch.from_numpy(valid).int(), H, hd)
    (out ** 2).sum().backward()
    for t, j, name in zip((tq, tk, tv), jgrads, "qkv"):
        _close(t.grad, np.asarray(j).reshape(bs, L, H * hd), 2e-4, name=name)


def test_short_supported_and_attn_impl_values():
    assert sa.supported(1536, 64) and sa.supported(661, 128)
    assert not sa.supported(1537, 64) and not sa.supported(601, 80)
    assert bb.BackboneConfig(family="opt", n_layers=1, d_model=64, n_heads=1, d_ff=64,
                             attn_impl="short").attn_impl == "short"
    with pytest.raises(ValueError, match="attn_impl"):
        bb.BackboneConfig(family="opt", n_layers=1, d_model=64, n_heads=1, d_ff=64,
                          attn_impl="flash")


# -- the model -------------------------------------------------------------------


def _training1(**changes) -> Config:
    """``configs/training1.yaml`` at a small size: 64-pixel grid, 5-frame
    windows, narrow encoder and decoder, dropouts off, f32."""
    with open(TRAINING1) as f:
        raw = yaml.safe_load(f)
    raw.update(half_precision=False, resolution=64, batch_size=2, autoreg_seq_len=SEQ_LEN,
               seq_len=SEQ_LEN, val_seq_len=SEQ_LEN, load_dir="synthetic:2",
               lora_config={**raw["lora_config"], "r": 4, "lora_dropout": 0.0},
               pos_embedding_params={**raw["pos_embedding_params"],
                                     "input_emb_layer_dropout": 0.0},
               encoder_params={**raw["encoder_params"], "hidden_dim": 32},
               decoder_params={**raw["decoder_params"], "gnn_dim": 8, "gnn_hid_dim": 12,
                               "gnn_layers": 2, "mlp_hid_dim": 32},
               **changes)
    return Config.from_dict(raw)


@pytest.fixture(scope="module")
def pair():
    cfg = _training1()
    jds = JSynthetic(n_trajectories=2, resolution=64, seq_len=SEQ_LEN, mode="valid")
    tds = SyntheticCylinderDataset(n_trajectories=2, resolution=64, seq_len=SEQ_LEN, mode="valid")
    jmodel = JFluidLLM.build(cfg, jds.ds_props(), attn_impl="short", **TINY)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    for layer in params["lora"]["layers"]:
        for leaf in layer["attn"].values():
            leaf["B"] = jnp.asarray(rng.normal(size=leaf["B"].shape).astype(np.float32) * 0.05)
    model = FluidLLM.build(cfg, tds.ds_props(), attn_impl="short", **TINY)
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, params, jds, model, tds


def _count_short(monkeypatch) -> list:
    calls, real = [], sa.short_attention_fwd
    monkeypatch.setattr(sa, "short_attention_fwd", lambda *a: calls.append(a[0].shape) or real(*a))
    return calls


def test_short_train_step_matches_jax(pair, monkeypatch):
    """One autoreg step: the loss and every trainable gradient (DoRA,
    encoder, decoder, BOS) against ``jax.value_and_grad`` of
    ``Trainer._mode_loss``; each layer's attention went through
    ``ShortAttention`` once."""
    jmodel, params, jds, model, tds = pair
    assert jmodel.backbone_cfg.attn_impl == model.backbone_cfg.attn_impl == "short"
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: JTrainer(jmodel)._mode_loss(p, b, jax.random.PRNGKey(1), "autoreg"),
        has_aux=True))
    (jloss, _), jgrads = fn(params, next(jmake_batches(jds, 2, shuffle=False)))
    calls = _count_short(monkeypatch)
    model.zero_grad(set_to_none=True)
    loss, _ = Trainer(model).mode_loss(next(make_batches(tds, 2, shuffle=False)), "autoreg")
    loss.backward()
    assert len(calls) == TINY["n_layers"]
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads))
    trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    assert {n.split(".")[0] for n, _ in trainable} == {"lora", "input_emb", "decoder", "bos"}
    for n, p in trainable:
        w = want[n].numpy()
        _close(p.grad, w, 1e-4 * max(np.abs(w).max(), 1e-30), name=n)


def test_short_stacked_exact_rollout_matches_jax(pair, monkeypatch):
    """The exact rollout through the window's fill and slide, both sides
    prepared with ``FLUID_SCAN_LAYERS=1`` (stacked) under ``attn_impl=
    "short"``; the port's full blocks attend through ``ShortAttention``
    (the sliced last block stays plain)."""
    jmodel, params, jds, model, tds = pair
    monkeypatch.setenv("FLUID_SCAN_LAYERS", "1")
    jprepared = jmodel.prepare_inference_params(params)
    prepared = FluidLLM.build(model.cfg, tds.ds_props(), attn_impl="short", **TINY)
    prepared.load_state_dict(model.state_dict())
    prepared.prepare_inference_params()
    assert isinstance(prepared.backbone.layers, bb.StackedLayers)
    n_steps = prepared.max_ctx_len + 1
    states, _, _, bc_mask, pos = next(jmake_batches(jds, 2, shuffle=False))
    want_s, want_d = jax.jit(lambda p, s, m, q: jgenerate(
        jmodel, p, s, m, q, n_steps))(jprepared, states[:, :1], bc_mask, pos)
    calls = _count_short(monkeypatch)
    tb = next(make_batches(tds, 2, shuffle=False))
    got_s, got_d = generate(prepared, tb[0][:, :1], tb[3], tb[4], n_steps)
    assert len(calls) == (TINY["n_layers"] - 1) * n_steps
    _close(got_s, want_s, 1e-4)
    _close(got_d, want_d, 1e-4)


def test_kernels_off_takes_the_short_twin(pair, monkeypatch):
    """``FluidLLM.kernels = False`` selects the plain twin under "short":
    the Function is not called, and the rollout is the same."""
    _, _, _, model, tds = pair
    tb = next(make_batches(tds, 1, shuffle=False))
    with_fn = generate(model, tb[0][:, :1], tb[3], tb[4], 2)[0]
    calls = _count_short(monkeypatch)
    model.kernels = False
    try:
        twin = generate(model, tb[0][:, :1], tb[3], tb[4], 2)[0]
    finally:
        model.kernels = True
    assert calls == []
    assert torch.equal(with_fn, twin)


@pytest.mark.parametrize("adapters", [dict(use_lora=True), dict(use_lora=False, freeze_llm=True)])
def test_build_refuses_4bit_loading(adapters, tmp_path, monkeypatch):
    """``llm_4bit_loading`` with adapters or a frozen backbone trains over
    packed nf4 in the JAX package (``main.py:103-110``), and now in the
    port: the model builds, and ``build_model_and_trainer`` stores every
    backbone linear as nf4 after drawing the weights, frozen (buffers: no
    optimizer state) beside the float trainable parameters."""
    from fluid_llm_tpu_torch.main import build_model_and_trainer
    from fluid_llm_tpu_torch.ops.quant import NF4Linear

    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))  # an empty cache: the draw stays
    cfg = _training1(llm_4bit_loading=True, **adapters)
    props = SyntheticCylinderDataset(n_trajectories=1, resolution=64, seq_len=SEQ_LEN).ds_props()
    FluidLLM.build(cfg, props, **TINY)
    trainer = build_model_and_trainer(cfg, props, torch.device("cpu"), **TINY)
    layers = trainer.model.backbone.layers
    assert all(isinstance(m, NF4Linear) for layer in layers
               for g in (layer.attn, layer.mlp) for m in g.values())
    assert not any(p.requires_grad for p in trainer.model.backbone.parameters())
    opt = {id(p) for g in trainer.opt.param_groups for p in g["params"]}
    assert opt == {id(p) for p in trainer.model.parameters() if p.requires_grad}


@pytest.mark.parametrize("changes", [dict(llm_4bit_loading=False),
                                     dict(llm_4bit_loading=True, use_lora=False)])
def test_build_accepts_4bit_loading_off_or_full_finetune(changes):
    """Off, or in full fine-tuning (where the JAX package quantizes
    nothing), the key changes nothing: the model builds."""
    cfg = _training1(**changes)
    props = SyntheticCylinderDataset(n_trajectories=1, resolution=64, seq_len=SEQ_LEN).ds_props()
    model = FluidLLM.build(cfg, props, **TINY)
    assert all(type(m) is torch.nn.Linear for m in model.backbone.layers[0].attn.values())
