"""int8 / nf4 weight storage and the int8-weight matmul of the port against the JAX package.

Same numpy-seeded inputs on both sides, on the CPU.  The JAX Pallas kernel
runs in interpret mode (``int8_matmul(..., interpret=True)``, or
``FLUID_QMM=interpret`` through ``monkeypatch``), as
``tests/test_quant_matmul.py`` runs it; ``FLUID_QMM=xla`` selects its
dequantise-then-matmul path.

Tolerances:
- quantisation: ``q``/``scale`` and the nf4 leaves bit-identical;
  dequantisation within 1e-6;
- the matmul twin against the JAX kernel at ``test_quant_matmul.py``'s
  shapes: w8a8 in f32 rtol 1e-6 (the same int8 rounding and exact
  integer sum; XLA may associate the two scale products differently, one
  f32 rounding apart); w8a16 in f32 rtol 1e-5 of each
  entry plus 1e-5 of the largest (the JAX kernel scales after the sum, the
  twin before it); in bf16 the JAX test's atol 0.08 (w8a16) / 0.25 (w8a8),
  rtol 0.03;
- models (2 layers, d 128, f32): w8a16 against the JAX dequant path rtol
  1e-4 and 1e-4 absolute (continuous math, summed in another order); w8a8
  against the JAX kernel at ``test_quant_matmul.py:172``'s atol 2e-2, rtol
  1e-2: activations that differ by an ulp upstream (norms, matmuls of
  another library) can round to the neighbouring int8 step, a jump of
  ~1e-3 of an output, which no tighter bound survives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid_llm_tpu.config import Config as JConfig
from fluid_llm_tpu.data.pipeline import make_batches as jmake_batches
from fluid_llm_tpu.data.synthetic import SyntheticCylinderDataset as JSynthetic
from fluid_llm_tpu.models import backbone as jbb
from fluid_llm_tpu.models import lora as jlora
from fluid_llm_tpu.models.fluid_llm import FluidLLM as JFluidLLM
from fluid_llm_tpu.ops import quant as jquant
from fluid_llm_tpu.ops.quant_matmul import int8_matmul as jint8_matmul
from fluid_llm_tpu.rollout.generate import generate as jgenerate
from fluid_llm_tpu.rollout.streaming import generate_streaming as jgenerate_streaming
from fluid_llm_tpu_torch.config import Config
from fluid_llm_tpu_torch.data import make_batches
from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
from fluid_llm_tpu_torch.models import backbone as bb
from fluid_llm_tpu_torch.models.common import linear
from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
from fluid_llm_tpu_torch.ops import quant
from fluid_llm_tpu_torch.ops import quant_matmul as qmm
from fluid_llm_tpu_torch.rollout.generate import generate
from fluid_llm_tpu_torch.rollout.streaming import generate_streaming
from fluid_llm_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

SEQ_LEN = 5
# 2 layers at d 128, SwiGLU/FFN 256: every linear is one the kernels take
TINY = dict(n_layers=2, d_model=128, n_heads=4, d_ff=256, max_pos=512, dropout=0.0)
COMMON = dict(
    half_precision=False, use_lora=True, batch_size=2, autoreg_seq_len=SEQ_LEN,
    seq_len=SEQ_LEN, resolution=64, flash_attention=False,
    lora_config={"r": 4, "lora_alpha": 16, "use_dora": True, "lora_dropout": 0.0},
    decoder_params={"type": "MLPGNN", "gnn_dim": 8, "gnn_hid_dim": 12, "gnn_layers": 2,
                    "gnn_heads": 1, "mlp_hid_dim": 32, "dropout": 0.0},
    encoder_params={"type": "MLP", "num_layers": 2, "hidden_dim": 32, "activation": "leakyrelu"},
)
MODELS = {
    "llama": dict(llm_backbone="fluid/llama-125m", absolute_time_ids=True,
                  pos_embedding_params={"pos_embedding_type": "rope_abs",
                                        "input_emb_layer_dropout": 0.0}),
    "opt": dict(llm_backbone="facebook/opt-125m",
                pos_embedding_params={"pos_embedding_type": "pos",
                                      "input_emb_layer_dropout": 0.0}),
}
W8A8_TOL = dict(atol=2e-2, rtol=1e-2)
W8A16_TOL = dict(atol=1e-4, rtol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# -- storage -----------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 32), (128, 384), (768, 96)])
def test_quantize_weight_bit_identical_to_jax(rng, shape):
    """(in, out) JAX weights, their transpose here; a zero column takes the
    scale-1 branch."""
    w = (rng.normal(size=shape) * 0.05).astype(np.float32)
    w[:, 3] = 0.0
    want = jquant.quantize_weight(jnp.asarray(w))
    got = quant.quantize_weight(torch.from_numpy(w.T.copy()))
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]).T)
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    assert got["scale"][3] == 1.0
    deq = quant.dequantize_weight(got["q"], got["scale"], torch.float32)
    np.testing.assert_allclose(deq.numpy(), np.asarray(jquant.dequantize_weight(
        want, jnp.float32)).T, atol=1e-6, rtol=0)


def test_quantize_weight_refuses_expert_banks(rng):
    """MoE expert banks are ported: a 3-D ``(E, in, out)`` JAX bank and its
    ``(E, out, in)`` transpose here quantize per expert and output column,
    bit for bit (``quant.py:44-51``; zero columns take scale 1)."""
    w = (rng.normal(size=(3, 64, 32)) * 0.05).astype(np.float32)
    w[1, :, 5] = 0.0
    want = jquant.quantize_weight(jnp.asarray(w))
    got = quant.quantize_weight(torch.from_numpy(np.swapaxes(w, 1, 2).copy()))
    assert got["q"].shape == (3, 32, 64) and got["scale"].shape == (3, 32)
    np.testing.assert_array_equal(got["q"].numpy(), np.swapaxes(np.asarray(want["q"]), 1, 2))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"]))
    assert got["scale"][1, 5] == 1.0
    np.testing.assert_array_equal(
        quant.dequantize_weight(got["q"], got["scale"], torch.float32).numpy(),
        np.swapaxes(np.asarray(jquant.dequantize_weight(want, jnp.float32)), 1, 2))


@pytest.mark.parametrize("shape", [(64, 128), (256, 96), (48, 32)])
def test_nf4_leaves_identical_to_jax(rng, shape):
    w = (rng.normal(size=shape) * 0.05).astype(np.float32)
    want = jquant.quantize_weight_nf4(jnp.asarray(w))
    got = quant.quantize_weight_nf4(torch.from_numpy(w.T.copy()))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    deq = quant.dequantize_weight_nf4(got["codes"], got["absmax_q"], got["absmax_scale"],
                                      got["absmax_offset"], torch.float32)
    np.testing.assert_allclose(deq.numpy(), np.asarray(jquant.dequantize_weight_nf4(
        want, jnp.float32)), atol=1e-6, rtol=0)


# -- the matmul ----------------------------------------------------------------

SHAPES = [(60, 768, 768), (61, 768, 2304), (128, 3072, 768), (5, 768, 3072), (488, 384, 128)]


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(k, n)) * 0.02).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    qp = jquant.quantize_weight(jnp.asarray(w))
    q, scale = torch.from_numpy(np.asarray(qp["q"]).T.copy()), torch.from_numpy(
        np.asarray(qp["scale"]))
    return x, qp, q, scale


@pytest.mark.parametrize("mode", ["w8a8", "w8a16"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_twin_matches_jax_kernel_f32(m, k, n, mode):
    x, qp, q, scale = _operands(m, k, n)
    assert qmm.supported(k, n)
    want = np.asarray(jint8_matmul(jnp.asarray(x), qp["q"], qp["scale"], True, mode))
    got = qmm.int8_matmul(torch.from_numpy(x), q, scale, mode=mode).numpy()
    assert got.dtype == np.float32 and got.shape == (m, n)
    if mode == "w8a8":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("mode,atol", [("w8a16", 0.08), ("w8a8", 0.25)])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_twin_matches_jax_kernel_bf16(m, k, n, mode, atol):
    x, qp, q, scale = _operands(m, k, n)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jint8_matmul(xb, qp["q"], qp["scale"], True, mode).astype(jnp.float32))
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    got = qmm.int8_matmul(xt, q, scale, mode=mode)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), want, atol=atol, rtol=0.03)


def test_w8a8_exact_on_integer_grids():
    """``test_quant_matmul.py:59-75``: integer activations whose row absmax
    is 127 quantise exactly (sx == 1), so the twin equals ``(x @ q) * scale``
    and the JAX kernel."""
    rng = np.random.default_rng(7)
    w = rng.integers(-3, 4, size=(128, 128)).astype(np.float32)
    qp = jquant.quantize_weight(jnp.asarray(w))
    xi = rng.integers(-126, 127, size=(8, 128))
    xi[:, 0] = 127
    x = xi.astype(np.float32)
    q, scale = torch.from_numpy(np.asarray(qp["q"]).T.copy()), torch.from_numpy(
        np.asarray(qp["scale"]))
    got = qmm.int8_matmul_ref(torch.from_numpy(x), q, scale, mode="w8a8").numpy()
    ref = (x @ np.asarray(qp["q"], np.float32)) * np.asarray(qp["scale"])[None, :]
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    np.testing.assert_array_equal(
        got, np.asarray(jint8_matmul(jnp.asarray(x), qp["q"], qp["scale"], True, "w8a8")))


@pytest.mark.parametrize("mode", ["w8a8", "w8a16"])
def test_leading_axes_and_bias(monkeypatch, mode):
    """Leading axes are flattened; the bias is added after the cast, as
    ``backbone._linear`` adds it (``test_quant_matmul.py:147``'s leaf,
    through the JAX kernel for w8a8 and the dequant path for w8a16)."""
    rng = np.random.default_rng(3)
    w = (rng.normal(size=(128, 384)) * 0.1).astype(np.float32)
    b = rng.normal(size=(384,)).astype(np.float32)
    h = rng.normal(size=(2, 7, 128)).astype(np.float32)
    p = {"w": jquant.quantize_weight(jnp.asarray(w)), "b": jnp.asarray(b)}
    lin = quant.QuantLinear(128, 384, True, mode)
    lin.load_state_dict(from_jax_params({"w": _np(p["w"]), "b": b}))
    got = qmm.int8_matmul(torch.from_numpy(h), lin.q, lin.scale, lin.bias, mode)
    assert got.shape == (2, 7, 384)
    flat = qmm.int8_matmul(torch.from_numpy(h.reshape(14, 128)), lin.q, lin.scale, lin.bias, mode)
    np.testing.assert_array_equal(got.reshape(14, 384).numpy(), flat.numpy())
    monkeypatch.setenv("FLUID_QMM", "interpret" if mode == "w8a8" else "xla")
    monkeypatch.setenv("FLUID_QMM_MODE", "w8a8")
    want = jbb._linear(jnp.asarray(h), p)
    np.testing.assert_allclose(_f32(linear(torch.from_numpy(h), lin)), np.asarray(want),
                               **W8A16_TOL)


def test_linear_routes_by_supported_shape():
    """A kernel shape goes through ``int8_matmul`` (w8a8 quantises the
    activations); one the kernels refuse (K 64) through the dequantised
    weight; an nf4 linear through its dequantised weight."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 128, generator=g)
    for k, n in ((128, 256), (64, 32)):
        lin = torch.nn.Linear(k, n)
        qlin = quant.QuantLinear.from_linear(lin, "w8a8")
        plain = torch.nn.functional.linear(x[:, :k], qlin.dequantize(torch.float32), qlin.bias)
        got = linear(x[:, :k], qlin)
        if qmm.supported(k, n):
            assert not torch.equal(got, plain)
            assert torch.equal(got, qmm.int8_matmul_ref(x[:, :k], qlin.q, qlin.scale, qlin.bias))
        else:
            assert torch.equal(got, plain)
        nlin = quant.NF4Linear.from_linear(lin)
        torch.testing.assert_close(linear(x[:, :k], nlin), torch.nn.functional.linear(
            x[:, :k], nlin.dequantize(torch.float32), lin.bias), rtol=0, atol=0)
    assert not qmm.supported(768, 100) and not qmm.supported(100, 768)


def test_linear_cols_takes_float_linears_only():
    """``cols`` (the packed qkv's q or k|v) computes those output columns
    of an ``nn.Linear`` exactly; a quantized module refuses it."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 128, generator=g)
    lin = torch.nn.Linear(128, 384)
    full = linear(x, lin)
    for cols in (slice(0, 128), slice(128, None)):
        assert torch.equal(linear(x, lin, cols=cols), full[:, cols])
    for qlin in (quant.QuantLinear.from_linear(lin, "w8a8"), quant.NF4Linear.from_linear(lin)):
        with pytest.raises(ValueError, match="cols"):
            linear(x, qlin, cols=slice(0, 128))


# -- backbone storage ------------------------------------------------------------


@pytest.mark.parametrize("mode", ["int8", "nf4"])
def test_from_jax_params_on_a_quantized_backbone(mode):
    """Every quantized leaf of a JAX backbone lands on the port's quantized
    modules (int8 ``q`` transposed, the rest as they are), strictly."""
    cfg_kw = dict(family="opt", act="relu", pos_offset=2, **TINY)
    jparams = jquant.quantize_backbone(jbb.init_params(jax.random.PRNGKey(0),
                                                       jbb.BackboneConfig(**cfg_kw)), mode)
    model = bb.Backbone(bb.BackboneConfig(**cfg_kw))
    quant.quantize_backbone(model, mode)
    model.load_state_dict(from_jax_params(_np(jparams)))
    jq = jparams["layers"][1]["mlp"]["fc1"]["w"]
    mod = model.layers[1].mlp["fc1"]
    if mode == "int8":
        np.testing.assert_array_equal(mod.q.numpy(), np.asarray(jq["q"]).T)
        np.testing.assert_array_equal(mod.scale.numpy(), np.asarray(jq["scale"]))
    else:
        assert isinstance(mod, quant.NF4Linear)
        np.testing.assert_array_equal(mod.codes.numpy(), np.asarray(jq["codes"]))
        np.testing.assert_array_equal(mod.absmax_offset.numpy(), np.asarray(jq["absmax_offset"]))
    np.testing.assert_array_equal(model.layers[1].mlp["fc1"].bias.numpy(),
                                  np.asarray(jparams["layers"][1]["mlp"]["fc1"]["b"]))


def test_dequantize_backbone_and_error():
    cfg = bb.BackboneConfig(family="opt", act="relu", pos_offset=2, **TINY)
    model = bb.Backbone(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    w0 = model.layers[0].attn["q"].weight.detach().clone()
    assert quant.quantization_error(model) <= 0.5 / 127 + 1e-6
    quant.quantize_backbone(model, "int8")
    assert quant.quantization_error(model) == 0.0  # no float linear left
    quant.dequantize_backbone(model, torch.float32)
    w1 = model.layers[0].attn["q"].weight
    assert isinstance(model.layers[0].attn["q"], torch.nn.Linear) and w1.shape == w0.shape
    assert (w1 - w0).abs().max() <= w0.abs().amax(1).max() / 127 * 0.5 + 1e-7


# -- the model, prepared for serving ----------------------------------------------


def _model_pair(kind: str):
    cfg_kw = {**COMMON, **MODELS[kind]}
    abs_t = kind == "llama"
    jds = JSynthetic(n_trajectories=2, resolution=64, seq_len=SEQ_LEN, mode="valid",
                     absolute_time=abs_t)
    tds = SyntheticCylinderDataset(n_trajectories=2, resolution=64, seq_len=SEQ_LEN,
                                   mode="valid", absolute_time=abs_t)
    jcfg = JConfig(**cfg_kw)
    jmodel = JFluidLLM.build(jcfg, jds.ds_props(), **TINY)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    for layer in params["lora"]["layers"]:
        for leaf in layer["attn"].values():
            leaf["B"] = jnp.asarray(rng.normal(size=leaf["B"].shape).astype(np.float32) * 0.05)
    model = FluidLLM.build(Config(**cfg_kw), tds.ds_props(), **TINY)
    model.load_state_dict(from_jax_params(_np(params)))
    return jmodel, params, jds, model, tds


def _jax_serving_params(jmodel, params):
    """``serve.load_engine``'s order: merge and drop the adapters, quantize,
    then ``prepare_inference_params`` (packing skips quantized q/k/v)."""
    p = dict(params)
    p["backbone"] = jlora.merge_lora(p["backbone"], p["lora"], jmodel.cfg.lora_config)
    del p["lora"]
    p["backbone"] = jquant.quantize_backbone(p["backbone"], mode="int8")
    return jmodel.prepare_inference_params(p)


@pytest.fixture(scope="module", params=["llama", "opt"])
def served(request):
    """(kind, JAX model, its serving params, JAX dataset, port model prepared
    with int8 storage and then holding the JAX int8 weights, port dataset)."""
    jmodel, params, jds, model, tds = _model_pair(request.param)
    jserved = _jax_serving_params(jmodel, params)
    model.prepare_inference_params("int8", "w8a8")
    own = {k: v.clone() for k, v in model.state_dict().items()}
    model.load_state_dict(from_jax_params(_np(jserved)))
    return request.param, jmodel, jserved, jds, model.eval(), tds, own


def test_prepared_quantized_structure(served):
    """q/k/v stay unpacked, scales and biases stay f32; the port's own
    merge-then-quantize agrees with the JAX package's storage (q within one
    int8 step where the merged f32 weights round differently, scales to
    f32 rounding)."""
    kind, _, jserved, _, model, _, own = served
    for layer in model.backbone.layers:
        assert "qkv" not in layer.attn and set(layer.attn) == {"q", "k", "v", "o"}
        for lin in list(layer.attn.values()) + list(layer.mlp.values()):
            assert isinstance(lin, quant.QuantLinear) and lin.mode == "w8a8"
            assert lin.scale.dtype == torch.float32
            assert lin.bias is None if kind == "llama" else lin.bias.dtype == torch.float32
    mine = from_jax_params(_np(jserved))
    for name, t in mine.items():
        if name.endswith(".q"):
            diff = (own[name].int() - t.int()).abs()
            assert diff.max() <= 1 and (diff > 0).float().mean() < 1e-3, name
        elif name.endswith(".scale") and name.startswith("backbone.layers"):
            np.testing.assert_allclose(own[name].numpy(), t.numpy(), rtol=1e-5, err_msg=name)


def _set_mode(model, mode):
    for mod in model.modules():
        if isinstance(mod, quant.QuantLinear):
            mod.mode = mode


@pytest.mark.parametrize("mode", ["w8a8", "w8a16"])
def test_quantized_forward_matches_jax(served, monkeypatch, mode):
    """``FluidLLM.forward`` on a batch (exact window, every frame decoded)."""
    _, jmodel, jserved, jds, model, tds, _ = served
    monkeypatch.setenv("FLUID_QMM", "interpret" if mode == "w8a8" else "xla")
    monkeypatch.setenv("FLUID_QMM_MODE", "w8a8")
    states, _, _, _, pos = next(jmake_batches(jds, 2, shuffle=False))
    want = jmodel.forward(jserved, states, pos)
    tb = next(make_batches(tds, 2, shuffle=False))
    _set_mode(model, mode)
    try:
        with torch.no_grad():
            got = model(tb[0], tb[4])
    finally:
        _set_mode(model, "w8a8")
    np.testing.assert_allclose(_f32(got), np.asarray(want),
                               **(W8A8_TOL if mode == "w8a8" else W8A16_TOL))


@pytest.mark.parametrize("mode", ["w8a8", "w8a16"])
def test_quantized_rollouts_match_jax(served, monkeypatch, mode):
    """The exact rollout (both models) and the streaming rollout (LLaMA),
    3 steps from one context state."""
    kind, jmodel, jserved, jds, model, tds, _ = served
    monkeypatch.setenv("FLUID_QMM", "interpret" if mode == "w8a8" else "xla")
    monkeypatch.setenv("FLUID_QMM_MODE", "w8a8")
    states, _, _, bc_mask, pos = next(jmake_batches(jds, 2, shuffle=False))
    tb = next(make_batches(tds, 2, shuffle=False))
    tol = W8A8_TOL if mode == "w8a8" else W8A16_TOL
    rollouts = [(jgenerate, generate)] + ([(jgenerate_streaming, generate_streaming)]
                                          if kind == "llama" else [])
    _set_mode(model, mode)
    try:
        for jgen, gen in rollouts:
            want, _ = jgen(jmodel, jserved, states[:, :1], bc_mask, pos, 3)
            got, _ = gen(model, tb[0][:, :1], tb[3], tb[4], 3)
            np.testing.assert_allclose(_f32(got), np.asarray(want), err_msg=gen.__name__, **tol)
    finally:
        _set_mode(model, "w8a8")


def test_kernels_flag_selects_the_twin_on_cpu(served):
    """``kernels=False`` routes the int8 linears to the twin explicitly; on
    CPU tensors the wrapper takes the twin too, so both agree exactly."""
    _, _, _, _, model, tds, _ = served
    tb = next(make_batches(tds, 1, shuffle=False))
    outs = []
    for kernels in (True, False):
        model.kernels = kernels
        outs.append(generate(model, tb[0][:, :1], tb[3], tb[4], 2)[1])
    model.kernels = True
    assert torch.equal(outs[0], outs[1])


# -- the default int8 path: w8a16, as the JAX package's default ----------------


def _modes(model):
    return {m.mode for m in model.modules() if isinstance(m, quant.QuantLinear)}


def test_defaults_build_w8a16_quant_linears(tmp_path):
    """``QuantLinear``, ``quantize_backbone``, ``prepare_inference_params``
    and ``serve.load_engine`` (through ``inference.load_checkpoint_model``)
    store int8 weights applied in w8a16 unless a caller asks for w8a8: the
    JAX package's default (``FLUID_QMM`` unset, ``auto``) multiplies bf16
    activations by the dequantised weight and quantises no activation."""
    from fluid_llm_tpu_torch.tools import serve as srv
    from fluid_llm_tpu_torch.train import checkpoint as ckpt

    assert quant.QuantLinear(128, 16, False).mode == "w8a16"
    assert quant.QuantLinear.from_linear(torch.nn.Linear(128, 16)).mode == "w8a16"
    cfg = Config(**{**COMMON, **MODELS["llama"], "llm_layers": 1})
    tds = SyntheticCylinderDataset(n_trajectories=2, resolution=64, seq_len=SEQ_LEN,
                                   mode="valid", absolute_time=True)
    model = FluidLLM.build(cfg, tds.ds_props())
    model.init_weights(torch.Generator().manual_seed(0))
    run = ckpt.make_save_folder(str(tmp_path / "runs"))
    ckpt.save_checkpoint(run, 1, model, torch.optim.SGD(model.parameters(), lr=0.0), 0, cfg)
    eng = srv.load_engine(str(tmp_path / "runs"), buckets=(3,), quant="int8", device="cpu")
    assert _modes(eng.model) == {"w8a16"}
    opted = srv.load_engine(str(tmp_path / "runs"), buckets=(3,), quant="int8",
                            qmm_mode="w8a8", device="cpu")
    assert _modes(opted.model) == {"w8a8"}
    bare = FluidLLM.build(cfg, tds.ds_props())
    quant.quantize_backbone(bare.backbone, "int8")
    assert _modes(bare) == {"w8a16"}


@pytest.mark.parametrize("kind", ["llama", "opt"])
def test_default_quantized_forward_matches_jax_default(kind, monkeypatch):
    """``prepare_inference_params("int8")`` at its default mode, holding the
    JAX package's int8 weights, against the JAX forward on its default path
    (``FLUID_QMM`` and ``FLUID_QMM_MODE`` unset): equal within W8A16_TOL;
    so is each prepared MLP linear against ``backbone._linear`` on the
    same activations (at this size the model's output moves by only ~4e-6
    when the activations are quantised, one linear's by ~5e-3)."""
    jmodel, params, jds, model, tds = _model_pair(kind)
    jserved = _jax_serving_params(jmodel, params)
    model.prepare_inference_params("int8")
    assert _modes(model) == {"w8a16"}
    model.load_state_dict(from_jax_params(_np(jserved)))
    monkeypatch.delenv("FLUID_QMM", raising=False)
    monkeypatch.delenv("FLUID_QMM_MODE", raising=False)
    states, _, _, _, pos = next(jmake_batches(jds, 2, shuffle=False))
    want = jmodel.forward(jserved, states, pos)
    tb = next(make_batches(tds, 2, shuffle=False))
    with torch.no_grad():
        got = model.eval()(tb[0], tb[4])
    np.testing.assert_allclose(_f32(got), np.asarray(want), **W8A16_TOL)
    h = np.random.default_rng(7).normal(size=(2, 5, 128)).astype(np.float32)
    for name, d_in in (("fc1" if kind == "opt" else "gate", 128), ("fc2" if kind == "opt" else "down", 256)):
        x = np.resize(h, (2, 5, d_in))
        want = jbb._linear(jnp.asarray(x), jserved["backbone"]["layers"][0]["mlp"][name])
        with torch.no_grad():
            got = linear(torch.from_numpy(x), model.backbone.layers[0].mlp[name])
        np.testing.assert_allclose(_f32(got), np.asarray(want), err_msg=name, **W8A16_TOL)
