"""Training over quantized storage, and quantized MoE and stacked layers,
against the JAX package on the CPU.

- ``quant_matmul.Int8Matmul`` (w8a16 and w8a8): dx and dscale against the
  JAX ``custom_vjp`` of ``int8_matmul`` (its kernel in interpret mode),
  1e-4 of each tensor's largest entry;
- ``llm_4bit_loading`` (the tiny GPT-2 layout of ``tests/test_model.py``,
  DoRA r 4 on q/v with non-zero ``B``, f32): the port's nf4 storage equals
  the JAX ``quantize_backbone``'s bit for bit; the loss (1e-5) and every
  adapter gradient (1e-4 relative) against ``jax.value_and_grad`` of
  ``Trainer._mode_loss`` over the JAX trainable partition; after a real
  step only the trainable parameters moved, the frozen uint8/int8/f32
  storage is bit-identical, and a checkpoint restores it bit for bit,
  dtypes included; ``main`` -> ``continue_train`` -> ``inference`` runs;
- ``frozen_bf16``: the frozen backbone in bf16, quantized storage skipped
  whole; a train step against the JAX one (loss 1e-5, gradients 1e-4);
- int8 expert banks (both storage modes) equal ``fluid_llm_tpu/ops/quant.py``
  bit for bit, the router left float; the MoE MLP over them against the
  JAX one (1e-5);
- stacked quantized layers (int8 and nf4): stacked like the JAX
  ``stack_layers`` (the bridge of its tree loads), the stacked forward and
  streaming equal to the unrolled ones bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fluid_llm_tpu.config import Config as JConfig
from fluid_llm_tpu.data.pipeline import make_batches as jmake_batches
from fluid_llm_tpu.data.synthetic import SyntheticCylinderDataset as JSynthetic
from fluid_llm_tpu.models import backbone as jbb
from fluid_llm_tpu.models.fluid_llm import FluidLLM as JFluidLLM
from fluid_llm_tpu.ops import quant as jquant
from fluid_llm_tpu.ops import quant_matmul as jqmm
from fluid_llm_tpu.train.optim import combine, partition
from fluid_llm_tpu.train.trainer import Trainer as JTrainer
from fluid_llm_tpu.train.trainer import cast_frozen_bf16 as jcast_frozen_bf16
from fluid_llm_tpu_torch import continue_train, inference
from fluid_llm_tpu_torch import main as tmain
from fluid_llm_tpu_torch.config import Config
from fluid_llm_tpu_torch.data import make_batches
from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
from fluid_llm_tpu_torch.models import backbone as bb
from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
from fluid_llm_tpu_torch.ops import quant
from fluid_llm_tpu_torch.ops import quant_matmul as qmm
from fluid_llm_tpu_torch.train import checkpoint as ckpt
from fluid_llm_tpu_torch.train.trainer import Trainer, cast_frozen_bf16
from fluid_llm_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

SEQ_LEN = 4
TINY = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, max_pos=128, dropout=0.0)
CFG = dict(
    llm_backbone="gpt2", half_precision=False, use_lora=True, batch_size=2,
    autoreg_seq_len=SEQ_LEN, seq_len=SEQ_LEN, resolution=64, flash_attention=False,
    lora_config={"r": 4, "lora_alpha": 16, "use_dora": True, "lora_dropout": 0.0},
    pos_embedding_params={"input_emb_layer_dropout": 0.0},
    decoder_params={"type": "MLP", "num_layers": 2, "hidden_dim": 32,
                    "activation": "leakyrelu", "zero_last_layer": False},
    encoder_params={"type": "MLP", "num_layers": 2, "hidden_dim": 32, "activation": "leakyrelu"},
)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got: torch.Tensor, want, rel: float, name: str = "") -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().float().numpy(), want.astype(np.float32), rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30), err_msg=name)


def _frozen_state(model) -> dict:
    params = dict(model.named_parameters())
    return {n: t.detach().clone() for n, t in model.state_dict().items()
            if n not in params or not params[n].requires_grad}


# -- the int8 matmul under autograd --------------------------------------------


@pytest.mark.parametrize("mode", ["w8a16", "w8a8"])
def test_int8_matmul_backward_matches_jax_custom_vjp(rng, mode):
    """dx = g (q s) in g's dtype, the true dscale in f32, and dbias; the
    forward is the twin (on the CPU) against the JAX kernel."""
    M, K, N = 24, 256, 128
    x = rng.normal(size=(2, M // 2, K)).astype(np.float32)
    w = rng.normal(size=(K, N)).astype(np.float32) * 0.05
    qp = jquant.quantize_weight(jnp.asarray(w))
    g = rng.normal(size=(2, M // 2, N)).astype(np.float32)
    y, vjp = jax.vjp(lambda x, s: jqmm.int8_matmul(x, qp["q"], s, True, mode),
                     jnp.asarray(x), qp["scale"])
    jdx, jds = vjp(jnp.asarray(g))

    q = torch.from_numpy(np.asarray(qp["q"]).T.copy())
    scale = torch.from_numpy(np.asarray(qp["scale"]).copy()).requires_grad_()
    bias = torch.zeros(N, requires_grad=True)
    tx = torch.from_numpy(x).requires_grad_()
    out = qmm.int8_matmul(tx, q, scale, bias, mode)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "Int8MatmulBackward"
    (out * torch.from_numpy(g)).sum().backward()
    _close(out, y, 1e-4, "y")
    _close(tx.grad, jdx, 1e-4, "dx")
    _close(scale.grad, jds, 1e-4, "dscale")
    _close(bias.grad, g.sum((0, 1)), 1e-5, "dbias")
    with torch.no_grad():  # without a gradient the product is the same
        assert torch.equal(qmm.int8_matmul(tx, q, scale, bias, mode), out)


# -- training over a packed-nf4 frozen backbone --------------------------------


def _jax_pair(**cfg_kw):
    """The JAX model, its params with non-zero ``B`` (float backbone) and
    the port model holding them (float), for ``CFG`` updated."""
    raw = dict(CFG, **cfg_kw)
    jds = JSynthetic(n_trajectories=2, resolution=64, seq_len=SEQ_LEN, mode="valid")
    tds = SyntheticCylinderDataset(n_trajectories=2, resolution=64, seq_len=SEQ_LEN, mode="valid")
    jmodel = JFluidLLM.build(JConfig(**raw), jds.ds_props(), **TINY)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    for layer in params["lora"]["layers"]:
        for leaf in layer["attn"].values():
            leaf["B"] = jnp.asarray(rng.normal(size=leaf["B"].shape).astype(np.float32) * 0.05)
    model = FluidLLM.build(Config(**raw), tds.ds_props(), **TINY)
    model.load_state_dict(from_jax_params(_np(params)))
    return jmodel, params, jds, model, tds


def _jax_step_grads(jmodel, params, batch, frozen_bf16=False):
    tr, fr = partition(params, jmodel.trainable_mask(params))
    if frozen_bf16:
        fr = jcast_frozen_bf16(fr)
    jtrainer = JTrainer(jmodel)
    fn = jax.jit(jax.value_and_grad(lambda t, b: jtrainer._mode_loss(
        combine(t, fr), b, jax.random.PRNGKey(1), "autoreg"), has_aux=True))
    return fn(tr, batch)


def test_nf4_dora_train_step_matches_jax(tmp_path):
    """``test_quant.py::test_quantized_frozen_backbone_train_step`` on the
    port, held to the JAX step: the JAX package quantizes after its init
    (``main.py:103-110``), the port in ``FluidLLM.quantize_frozen``; DoRA's
    ``m`` is the float weight's norm, its divisor the dequantised one's."""
    jmodel, params, jds, model, tds = _jax_pair(llm_4bit_loading=True)
    jparams = dict(params, backbone=jquant.quantize_backbone(params["backbone"], mode="nf4"))
    assert model.quantize_frozen()
    q = model.backbone.layers[1].attn["q"]
    assert isinstance(q, quant.NF4Linear) and isinstance(model.backbone.layers[0].mlp["fc2"],
                                                         quant.NF4Linear)
    sd = from_jax_params(_np(jparams["backbone"]))
    for n, t in model.backbone.state_dict().items():  # the storage, bit for bit
        assert t.dtype == sd[n].dtype and torch.equal(t, sd[n]), n
    (jloss, jaux), jgrads = _jax_step_grads(jmodel, jparams,
                                            next(jmake_batches(jds, 2, shuffle=False)))

    batch = next(make_batches(tds, 2, shuffle=False))
    trainer = Trainer(model)
    loss, aux = trainer.mode_loss(batch, "autoreg")
    loss.backward()
    _close(loss, jloss, 1e-5, "loss")
    want = from_jax_params(_np(jgrads))
    trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
    assert sorted(trainable) == sorted(want)
    assert not any(n.startswith("backbone.") for n in trainable)
    for n, p in trainable.items():
        _close(p.grad, want[n].numpy(), 1e-4, n)

    # a real step: adapters move, the frozen storage does not
    frozen = _frozen_state(model)
    lora = {n: p.detach().clone() for n, p in trainable.items() if n.startswith("lora.")}
    out = trainer.train_step(batch)
    assert np.isfinite(float(out["loss"]))
    assert any(not torch.equal(p, dict(model.named_parameters())[n]) for n, p in lora.items())
    for n, t in _frozen_state(model).items():
        assert t.dtype == frozen[n].dtype and torch.equal(t, frozen[n]), n
    assert {t.dtype for t in frozen.values()} >= {torch.uint8, torch.int8, torch.float32}

    # checkpoint round trip into a template of other values, same structure
    ckpt.save_checkpoint(str(tmp_path), 1, model, trainer.opt, 1, model.cfg)
    other = FluidLLM.build(model.cfg, tds.ds_props(), **TINY)
    other.init_weights(torch.Generator().manual_seed(7))
    other.quantize_frozen()
    t2 = Trainer(other)
    assert ckpt.restore_checkpoint(str(tmp_path), 1, other, t2.opt) == 1
    for (n, a), (_, b) in zip(model.state_dict().items(), other.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), n


def test_nf4_main_continue_train_inference(tmp_path, monkeypatch):
    """The entry points over an nf4 frozen backbone: ``main`` quantizes
    after the draw, ``continue_train`` restores the nf4 storage into its
    own nf4 template, ``inference`` merges the adapters into the
    dequantised weights and rolls out.  An empty HF cache: the draw stays."""
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    runs = tmp_path / "runs"
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(dict(
        CFG, llm_4bit_loading=True, llm_layers=2, load_dir="synthetic:2", num_epochs=1,
        save_model_each=1, val_seq_len=SEQ_LEN, checkpoint_save_path=str(runs))))
    assert tmain.main(["--config_path", str(cfg_path), "--device", "cpu"]) == 1
    run = runs / "000"
    payload = torch.load(run / "step_0" / ckpt.STATE_FILE, weights_only=True)
    assert payload["frozen"]["backbone.layers.0.attn.q.codes"].dtype == torch.uint8
    saved = yaml.safe_load((run / "config.yaml").read_text())
    (run / "config.yaml").write_text(yaml.safe_dump(dict(saved, num_epochs=2)))
    assert continue_train.main(["--checkpoint_dir", str(runs), "--device", "cpu"]) == 2
    mean = inference.main(["--checkpoint_dir", str(runs), "--device", "cpu",
                           "--seq_len", str(SEQ_LEN), "--pred_steps", "3"])
    assert np.isfinite(mean)


# -- frozen_bf16 ---------------------------------------------------------------


def test_frozen_bf16_step_matches_jax():
    """``cast_frozen_bf16`` over the frozen backbone (the JAX casts of
    ``trainer.py:44-60``: every f32 leaf of the frozen backbone), then an
    autoreg step: loss and adapter gradients against the JAX step."""
    jmodel, params, jds, model, tds = _jax_pair(frozen_bf16=True)
    (jloss, _), jgrads = _jax_step_grads(jmodel, params,
                                         next(jmake_batches(jds, 2, shuffle=False)),
                                         frozen_bf16=True)
    trainer = Trainer(model)
    for n, p in model.named_parameters():
        assert p.dtype == (torch.float32 if p.requires_grad else torch.bfloat16), n
    loss, _ = trainer.mode_loss(next(make_batches(tds, 2, shuffle=False)), "autoreg")
    loss.backward()
    _close(loss, jloss, 1e-5, "loss")
    want = from_jax_params(_np(jgrads))
    for n, p in model.named_parameters():
        if p.requires_grad:
            _close(p.grad, want[n].numpy(), 1e-4, n)


def test_cast_frozen_bf16_skips_quantized_storage():
    """Quantized linears pass through whole (int8 ``q`` and f32 ``scale`` as
    in ``test_moe.py::test_cast_frozen_bf16_skips_quantized_storage``; the
    nf4 chain and the f32 biases too); float frozen leaves go bf16; the
    trainable ones and the modules outside the backbone keep f32."""
    _, _, _, model, _ = _jax_pair()
    quant.quantize_backbone(model.backbone, "int8")
    model.backbone.layers[1].attn["o"] = quant.NF4Linear.from_linear(
        torch.nn.Linear(64, 64))
    before = {n: t.clone() for n, t in model.backbone.state_dict().items()}
    cast_frozen_bf16(model)
    for n, t in model.backbone.state_dict().items():
        if n.endswith((".q", ".scale", ".codes", ".absmax_q", ".absmax_scale",
                       ".absmax_offset")) or ".attn." in n or ".mlp." in n:
            assert t.dtype == before[n].dtype and torch.equal(t, before[n]), n
        else:
            assert t.dtype == torch.bfloat16, n
    assert model.backbone.layers[0].attn["q"].q.dtype == torch.int8
    assert model.backbone.layers[0].attn["q"].scale.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.lora.parameters())
    assert all(p.dtype == torch.float32 for p in model.decoder.parameters())


# -- int8 expert banks ---------------------------------------------------------


def _moe_backbone(family: str):
    kw = dict(family=family, n_layers=2, d_model=128, n_heads=2, d_ff=256, dropout=0.0,
              moe_experts=4, moe_top_k=2, moe_capacity_factor=1.25)
    if family == "llama":
        kw.update(act="silu", norm="rmsnorm", pos="rope")
    else:
        kw.update(pos_offset=2)
    jcfg = jbb.BackboneConfig(**kw)
    params = jbb.init_params(jax.random.PRNGKey(0), jcfg)
    model = bb.Backbone(bb.BackboneConfig(**kw))
    model.load_state_dict(from_jax_params(_np(params)))
    return jcfg, params, model


@pytest.mark.parametrize("family", ["opt", "llama"])
@pytest.mark.parametrize("mode", ["int8", "nf4"])
def test_int8_expert_banks_identical_to_jax(family, mode):
    """Both storage modes quantize the banks to int8, a scale per expert
    and output column, bit for bit the JAX ``quantize_backbone``'s (the
    router stays f32); the MoE layer over them against the JAX one; and
    ``dequantize_backbone`` gives the banks back as ``ExpertBank``s."""
    jcfg, params, model = _moe_backbone(family)
    jq = jquant.quantize_backbone(params, mode=mode)
    quant.quantize_backbone(model, mode)
    mlp = model.layers[1].mlp
    assert type(mlp.router) is torch.nn.Linear and mlp.router.weight.dtype == torch.float32
    for name, bank in mlp.experts.items():
        want = jq["layers"][1]["mlp"]["experts"][name]["w"]
        assert isinstance(bank, quant.QuantLinear) and bank.q.shape[0] == 4
        np.testing.assert_array_equal(bank.q.numpy(), np.swapaxes(np.asarray(want["q"]), 1, 2))
        np.testing.assert_array_equal(bank.scale.numpy(), np.asarray(want["scale"]))
    sd = from_jax_params(_np(jq))
    assert sorted(sd) == sorted(model.state_dict())
    h = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (2, 9, 128), jnp.float32))
    want, _ = jbb._moe_mlp(jnp.asarray(h), jq["layers"][1]["mlp"], jcfg)
    with torch.no_grad():
        got, _ = bb.moe_mlp(torch.from_numpy(h.copy()), mlp, model.cfg)
    _close(got, want, 1e-5)
    assert quant.quantization_error(model) == 0.0  # no float 2-D linear left
    quant.dequantize_backbone(model, torch.float32)
    assert all(isinstance(b, bb.ExpertBank) for b in mlp.experts.values())
    np.testing.assert_array_equal(
        mlp.experts["up" if family == "llama" else "fc1"].weight.detach().numpy(),
        np.swapaxes(np.asarray(jquant.dequantize_weight(
            jq["layers"][1]["mlp"]["experts"]["up" if family == "llama" else "fc1"]["w"],
            jnp.float32)), 1, 2))


# -- stacked quantized layers --------------------------------------------------


def _dense_backbone(family: str, seed: int = 0):
    kw = dict(family=family, n_layers=3, d_model=128, n_heads=2, d_ff=256, dropout=0.0)
    if family == "llama":
        kw.update(act="silu", norm="rmsnorm", pos="rope", max_pos=512)
    else:
        kw.update(pos_offset=2)
    jcfg = jbb.BackboneConfig(**kw)
    params = jbb.init_params(jax.random.PRNGKey(seed), jcfg)
    model = bb.Backbone(bb.BackboneConfig(**kw))
    model.load_state_dict(from_jax_params(_np(params)))
    return jcfg, params, model


@pytest.mark.parametrize("family", ["opt", "llama"])
@pytest.mark.parametrize("mode", ["int8", "nf4"])
def test_stacked_quantized_forward_equals_unrolled(family, mode):
    """Layers quantized alike stack (``backbone.py:308-337``): the stacked
    storage equals the JAX stacked quantized tree through the bridge, the
    stacked forward equals the unrolled one bit for bit, and unstacking
    gives the layers back bit for bit."""
    jcfg, params, model = _dense_backbone(family)
    quant.quantize_backbone(model, mode)
    unrolled = {n: t.clone() for n, t in model.state_dict().items()}
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 21, 128)).astype(np.float32))
    valid = torch.arange(21)[None].expand(2, -1) >= 4
    with torch.no_grad():
        want = model(x, valid)
        bb.stack_layers(model)
        assert isinstance(model.layers, bb.StackedLayers)
        kind = quant.NF4Linear if mode == "nf4" else quant.QuantLinear
        assert isinstance(model.layers.attn["q"], kind)
        got = model(x, valid)
    assert torch.equal(got, want)
    jstacked = jbb.stack_layers(jquant.quantize_backbone(params, mode=mode))
    assert not isinstance(jstacked["layers"], list)
    sd = from_jax_params(_np(jstacked))
    for n, t in model.state_dict().items():
        assert t.dtype == sd[n].dtype and torch.equal(t, sd[n]), n
    bb.unstack_layers(model)
    for n, t in model.state_dict().items():
        assert torch.equal(t, unrolled[n]), n


def test_stacked_int8_streaming_equals_unrolled():
    """The LLaMA layout stored int8 streams 4 frames stacked and unrolled:
    equal bit for bit (the stacked layer's int8 linears read their slice
    through ``models.common.linear``, not the float-only indexed linear)."""
    _, _, model = _dense_backbone("llama")
    quant.quantize_backbone(model, "int8")
    frame, n_sink = 12, 5
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, n_sink + 4 * frame, 128)).astype(np.float32))
    outs = {}
    for stacked in (False, True):
        if stacked:
            bb.stack_layers(model)
        cache = bb.init_streaming_cache(model.cfg, 1, n_sink, 3, frame)
        pos = torch.arange(x.shape[1])
        ys = []
        with torch.no_grad():
            bb.apply_streaming(model, x[:, :n_sink], pos[:n_sink], cache, 0, prefill=True)
            for f in range(4):
                lo = n_sink + f * frame
                ys.append(bb.apply_streaming(model, x[:, lo:lo + frame], pos[lo:lo + frame],
                                             cache, f % 3)[0])
        outs[stacked] = torch.cat(ys, 1)
    assert isinstance(model.layers, bb.StackedLayers)
    assert torch.equal(outs[True], outs[False])


def test_stack_keeps_layers_quantized_differently():
    """One layer int8 in another matmul mode, or float: the list stays."""
    _, _, model = _dense_backbone("opt")
    quant.quantize_backbone(model, "int8")
    model.layers[2].attn["q"].mode = "w8a8"
    bb.stack_layers(model)
    assert isinstance(model.layers, torch.nn.ModuleList)
    model.layers[2].attn["q"] = torch.nn.Linear(128, 128)
    bb.stack_layers(model)
    assert isinstance(model.layers, torch.nn.ModuleList)
