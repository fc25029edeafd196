"""The stacked-layer layout and the indexed linear against the JAX package.

- ``ops/indexed_linear``: the plain twin and the wrapper on CPU tensors
  against the JAX Pallas kernel in interpret mode (``tests/test_indexed_linear.py``'s
  pattern), at the streaming step's 60 and 61 rows, the first and the last
  layer, with and without a bias;
- ``stack_layers``/``unstack_layers``: the round trip bit for bit, the
  no-op on layers that differ, layers quantized alike stacked (their
  storage with the leading axis), and the weight bridge from JAX's stacked
  tree;
- the stacked ``forward`` (dense and ``decode_slice``) against JAX
  ``apply`` on the stacked tree; the stacked ``apply_streaming`` through
  the prefill, decode and ring eviction against JAX's stacked scan; the
  stacked ``generate_streaming`` and ``generate`` of a model against JAX's,
  both stacked by ``FLUID_SCAN_LAYERS=1`` (set with monkeypatch), and
  ``inference.main --streaming`` reaching the stacked layout through it.

Same weights on both sides (the JAX init, bridged by
``weights.from_jax_params``), the same numpy-seeded inputs, f32, on the CPU.
Tolerances: f32 atol 2e-5 / rtol 1e-5 on single calls (sums in another
order); 1e-4 absolute on rollouts (several chained steps through the
decoder), as ``tests/test_torch_streaming.py``.
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
from fluid_llm_tpu.models import backbone as jbb
from fluid_llm_tpu.models.fluid_llm import FluidLLM as JFluidLLM
from fluid_llm_tpu.ops import indexed_linear as jil
from fluid_llm_tpu.rollout.generate import generate as jgenerate
from fluid_llm_tpu.rollout.streaming import generate_streaming as jgenerate_streaming
from fluid_llm_tpu_torch import inference
from fluid_llm_tpu_torch.data import make_batches
from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
from fluid_llm_tpu_torch.models import backbone as bb
from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
from fluid_llm_tpu_torch.ops import indexed_linear as il
from fluid_llm_tpu_torch.ops.quant import quantize_backbone
from fluid_llm_tpu_torch.rollout.generate import generate
from fluid_llm_tpu_torch.rollout.streaming import generate_streaming
from fluid_llm_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

SEQ_LEN = 5
# backbone-level: 3 layers, d 128 (K and N multiples of 128 for the kernel)
TINY_BB = dict(n_layers=3, d_model=128, n_heads=2, d_ff=256, max_pos=4096, dropout=0.0)
FAMILIES = {
    "opt": dict(family="opt", act="relu", pos_offset=2),
    "llama": dict(family="llama", act="silu", norm="rmsnorm", pos="rope", ln_eps=1e-6),
    "opt_postln": dict(family="opt", act="relu", pos_offset=2, d_embed=64, pre_ln=False,
                       final_ln=False),
}
# model-level: the flagship's shape cut to 2 layers, d 64
TINY = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, max_pos=4096, dropout=0.0)
CFG = dict(
    llm_backbone="fluid/llama-125m", half_precision=False, use_lora=True, batch_size=2,
    autoreg_seq_len=SEQ_LEN, seq_len=SEQ_LEN, resolution=64, flash_attention=True,
    absolute_time_ids=True,
    lora_config={"r": 4, "lora_alpha": 16, "use_dora": True, "lora_dropout": 0.0},
    pos_embedding_params={"pos_embedding_type": "rope_abs", "input_emb_layer_dropout": 0.0},
    decoder_params={"type": "MLPGNN", "gnn_dim": 8, "gnn_hid_dim": 12, "gnn_layers": 2,
                    "gnn_heads": 1, "mlp_hid_dim": 32, "dropout": 0.0},
    encoder_params={"type": "MLP", "num_layers": 2, "hidden_dim": 32,
                    "activation": "leakyrelu"},
)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, atol=2e-5, rtol=1e-5, name=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=rtol,
                               err_msg=name)


# -- the indexed linear --------------------------------------------------------


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("li", [0, 3])
@pytest.mark.parametrize("M", [60, 61])
def test_indexed_linear_matches_pallas_interpret(M, li, bias):
    """``x @ w[li] + b[li]`` at the streaming step's rows, layers 0 and
    ``n_layers - 1``: the twin and the wrapper (CPU tensors) against the
    JAX kernel in interpret mode; the index a device int32 element."""
    rng = np.random.default_rng(M + li)
    nl, K, N = 4, 256, 384
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(nl, K, N)) * 0.05).astype(np.float32)
    b = rng.normal(size=(nl, N)).astype(np.float32) if bias else None
    want = jil.indexed_linear(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
                              jnp.int32(li), interpret=True)
    tw = torch.from_numpy(w).transpose(1, 2).contiguous()  # (nl, N, K)
    tb = None if b is None else torch.from_numpy(b)
    index = torch.arange(nl, dtype=torch.int32)[li]
    assert il.supported(torch.from_numpy(x), tw)
    for fn in (il.indexed_linear_ref, il.indexed_linear):
        _close(fn(torch.from_numpy(x), tw, tb, index), want, name=fn.__name__)


def test_indexed_linear_leading_axes_and_supported():
    """(bs, L, K) in, (bs, L, N) out; ``supported`` wants K and N multiples
    of 128 and x in the weight's dtype."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 5, 128)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 256, 128)).astype(np.float32))
    got = il.indexed_linear(x, w, None, torch.tensor([2], dtype=torch.int32))
    _close(got, (x @ w[2].T).numpy())
    assert not il.supported(x, w[:, :200])
    assert not il.supported(x[..., :64], w[..., :64])
    assert not il.supported(x.to(torch.bfloat16), w)


# -- stacking ------------------------------------------------------------------


def _bb_pair(family, **kw):
    cfg_kw = {**TINY_BB, **FAMILIES[family], **kw}
    jcfg = jbb.BackboneConfig(**cfg_kw)
    params = jbb.init_params(jax.random.PRNGKey(0), jcfg)
    model = bb.Backbone(bb.BackboneConfig(**cfg_kw))
    model.load_state_dict(from_jax_params(_np(params)))
    return jcfg, params, model


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("family", ["opt", "llama"])
def test_stack_unstack_round_trip_bit_for_bit(family, packed):
    _, _, model = _bb_pair(family)
    if packed:
        bb.pack_qkv_params(model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    bb.stack_layers(model)
    assert isinstance(model.layers, bb.StackedLayers) and len(model.layers) == 3
    names = {n for n, _ in model.named_parameters()}
    assert "layers.ln1.weight" in names
    assert ("layers.attn.qkv.weight" in names) == packed
    w = model.layers.mlp["fc1" if family == "opt" else "gate"].weight
    assert w.shape == (3, 256, 128)
    for li in range(3):
        key = f"layers.{li}.mlp.{'fc1' if family == 'opt' else 'gate'}.weight"
        assert torch.equal(w[li], before[key])
    bb.stack_layers(model)  # a no-op on a stacked backbone
    bb.unstack_layers(model)
    assert isinstance(model.layers, torch.nn.ModuleList)
    assert all(type(m) is torch.nn.Linear for layer in model.layers
               for g in (layer.attn, layer.mlp) for m in g.values())
    after = model.state_dict()
    assert after.keys() == before.keys()
    for k in before:
        assert torch.equal(after[k], before[k]) and after[k].dtype == before[k].dtype, k
    bb.unstack_layers(model)  # a no-op on the list


def test_stack_leaves_layers_that_differ_and_refuses_quantized():
    """Layers that differ keep the list; layers quantized alike (int8 here)
    stack now, as JAX's ``stack_layers`` does: their storage gains the
    leading axis, and the round trip is bit for bit."""
    _, _, model = _bb_pair("opt")
    bb.pack_qkv_params(model)
    model.layers[1] = bb.Block(model.cfg)  # q/k/v unpacked in one layer only
    bb.stack_layers(model)
    assert isinstance(model.layers, torch.nn.ModuleList)
    _, _, model = _bb_pair("llama")
    quantize_backbone(model, "int8", "w8a16")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    bb.stack_layers(model)
    assert isinstance(model.layers, bb.StackedLayers)
    assert model.layers.mlp["down"].q.shape == (3, 128, 256)
    assert model.layers.mlp["down"].mode == "w8a16"
    bb.unstack_layers(model)
    after = model.state_dict()
    assert after.keys() == before.keys()
    assert all(torch.equal(after[k], before[k]) for k in before)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_from_jax_params_loads_the_stacked_tree(family):
    """JAX ``stack_layers(pack_qkv_params(p))`` through the bridge into a
    stacked port backbone: every tensor equals its JAX leaf (transposed for
    linears)."""
    _, params, model = _bb_pair(family)
    jstacked = jbb.stack_layers(jbb.pack_qkv_params(params))
    bb.pack_qkv_params(model)
    bb.stack_layers(model)
    sd = from_jax_params(_np(jstacked))
    model.load_state_dict(sd)  # strict: the same names and shapes
    lys = jstacked["layers"]
    np.testing.assert_array_equal(model.layers.attn["qkv"].weight.detach().numpy(),
                                  np.swapaxes(np.asarray(lys["attn"]["qkv"]["w"]), 1, 2))
    np.testing.assert_array_equal(model.layers.ln2.weight.detach().numpy(),
                                  np.asarray(lys["ln2"]["scale"]))
    if family != "llama":
        np.testing.assert_array_equal(model.layers.attn["o"].bias.detach().numpy(),
                                      np.asarray(lys["attn"]["o"]["b"]))
        np.testing.assert_array_equal(model.layers.ln1.bias.detach().numpy(),
                                      np.asarray(lys["ln1"]["bias"]))


def _window(d, L=157, n_invalid=41, bs=2, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bs, L, d)).astype(np.float32) * 0.5
    valid = np.broadcast_to(np.arange(L)[None, :] >= n_invalid, (bs, L)).copy()
    return x, valid


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_stacked_forward_matches_jax(family):
    """The stacked ``forward`` (layers read as slices), dense and with
    ``decode_slice``, against JAX ``apply`` on the stacked tree, and equal
    to the port's own unrolled forward."""
    jcfg, params, model = _bb_pair(family)
    jstacked = jbb.stack_layers(jbb.pack_qkv_params(params))
    x, valid = _window(model.cfg.embed_dim)
    start, n = 97, 60
    ref = jax.jit(lambda p, x, v: jbb.apply(p, jcfg, x, v))(jstacked, x, valid)
    ref_s = jax.jit(lambda p, x, v: jbb.apply(
        p, jcfg, x, v, decode_slice=(jnp.asarray(start, jnp.int32), n)))(jstacked, x, valid)
    bb.pack_qkv_params(model)
    tx, tv = torch.from_numpy(x), torch.from_numpy(valid)
    with torch.no_grad():
        unrolled = model(tx, tv, decode_slice=(start, n))
        bb.stack_layers(model)
        got, got_s = model(tx, tv), model(tx, tv, decode_slice=(start, n))
    assert isinstance(model.layers, bb.StackedLayers)
    _close(got, ref)
    _close(got_s, ref_s)
    assert torch.equal(got_s, unrolled)


def test_stacked_forward_refuses_adapters_and_dropout():
    """Inference-only, as JAX's stacked branch: a LoRA tree, a dropout
    generator and, under autograd, parameters that want a gradient (the
    layer views carry none) raise."""
    _, _, model = _bb_pair("opt")
    bb.stack_layers(model)
    x = torch.zeros(1, 4, 128)
    with pytest.raises(ValueError, match="LoRA"):
        model(x, lora=object())
    with pytest.raises(ValueError, match="inference-only"):
        model(x, generator=torch.Generator())
    with pytest.raises(ValueError, match="no gradient"):
        model(x)
    model.requires_grad_(False)
    assert model(x).shape == (1, 4, 128)


def test_stacked_views_follow_the_parameters():
    """The layer views are made once: ``load_state_dict`` (in place) reaches
    them, and so does a ``Module.to`` that moves the parameters (the views
    are made anew); the stacked forward equals the unrolled one of the
    weights loaded last, bit for bit."""
    _, _, model = _bb_pair("llama")
    _, _, weights_a = _bb_pair("llama")
    weights_b = bb.Backbone(model.cfg)
    weights_b.reset_parameters(torch.Generator().manual_seed(7))
    x, valid = _window(128, L=37, n_invalid=5)
    tx, tv = torch.from_numpy(x), torch.from_numpy(valid)
    with torch.no_grad():
        bb.stack_layers(model)
        for ref in (weights_b, weights_a):
            bb.stack_layers(ref)
            model.load_state_dict(ref.state_dict())
            bb.unstack_layers(ref)
            assert torch.equal(model(tx, tv), ref(tx, tv))
            model.to(torch.float64).to(torch.float32)  # new storage, the same values
    view = model.layers.views[True][2]
    assert view.mlp["up"].weight.data_ptr() == model.layers.mlp["up"].weight[2].data_ptr()
    assert view.index.data_ptr() == model.layers.index[2].data_ptr()


N_SINK, FRAME, R = 11, 10, 3


def test_stacked_apply_streaming_past_eviction_matches_jax(monkeypatch):
    """Sinks prefilled, then 5 frames into a ring of 3 (frames 3 and 4
    evict 0 and 1) on the stacked LLaMA backbone, every linear through
    ``indexed_linear`` (its twin on CPU tensors), at each layer's index:
    each step's output and the final cache against JAX's stacked scan."""
    jcfg, params, model = _bb_pair("llama")
    jstacked = jbb.stack_layers(jbb.pack_qkv_params(params))
    bb.pack_qkv_params(model)
    bb.stack_layers(model)
    n_frames, bs = 5, 2
    rng = np.random.default_rng(3)
    x = rng.normal(size=(bs, N_SINK + n_frames * FRAME, 128)).astype(np.float32) * 0.5
    positions = np.arange(x.shape[1], dtype=np.int32)
    jstep = jax.jit(lambda p, x, pos, c, slot: jbb.apply_streaming(p, jcfg, x, pos, c, slot))
    jcache = jbb.init_streaming_cache(jcfg, bs, N_SINK, R, FRAME)
    _, jcache = jbb.apply_streaming(jstacked, jcfg, x[:, :N_SINK], positions[:N_SINK], jcache, 0,
                                    prefill=True)
    cache = bb.init_streaming_cache(model.cfg, bs, N_SINK, R, FRAME)
    calls, real = [], il.indexed_linear_ref
    monkeypatch.setattr(il, "indexed_linear_ref",  # the wrapper's CPU path, counted
                        lambda *a: calls.append(int(a[3])) or real(*a))
    _, cache = bb.apply_streaming(model, torch.from_numpy(x[:, :N_SINK]),
                                  torch.from_numpy(positions[:N_SINK]), cache, 0, prefill=True)
    for f in range(n_frames):
        lo = N_SINK + f * FRAME
        want, jcache = jstep(jstacked, x[:, lo:lo + FRAME], positions[lo:lo + FRAME], jcache,
                             f % R)
        got, cache = bb.apply_streaming(model, torch.from_numpy(x[:, lo:lo + FRAME]),
                                        torch.from_numpy(positions[lo:lo + FRAME]), cache, f % R)
        _close(got, want, name=f"frame {f}")
    # 5 linears (qkv, o, gate, up, down) x 3 layers x (prefill + 5 frames)
    assert calls == [li for _ in range(6) for li in range(3) for _ in range(5)]
    for name in ("sink_pos", "ring_pos"):
        np.testing.assert_array_equal(cache[name].numpy(), np.asarray(jcache[name]))
    for name in ("k", "v"):
        _close(cache[name], jcache[name], name=name)


# -- the stacked model ---------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    cfg = Config(**CFG)
    jds = JSynthetic(n_trajectories=2, resolution=64, seq_len=SEQ_LEN, mode="valid",
                     absolute_time=True)
    tds = SyntheticCylinderDataset(n_trajectories=2, resolution=64, seq_len=SEQ_LEN,
                                   mode="valid", absolute_time=True)
    jmodel = JFluidLLM.build(cfg, jds.ds_props(), **TINY)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    for layer in params["lora"]["layers"]:
        for leaf in layer["attn"].values():
            leaf["B"] = jnp.asarray(rng.normal(size=leaf["B"].shape).astype(np.float32) * 0.05)
    model = FluidLLM.build(cfg, tds.ds_props(), **TINY)
    model.load_state_dict(from_jax_params(_np(params)))
    return jmodel, params, jds, model, tds


def _stacked(pair, monkeypatch):
    """JAX's prepared params and a prepared port model, both stacked by
    ``FLUID_SCAN_LAYERS=1``."""
    jmodel, params, jds, model, tds = pair
    monkeypatch.setenv("FLUID_SCAN_LAYERS", "1")
    jprepared = jmodel.prepare_inference_params(params)
    assert not isinstance(jprepared["backbone"]["layers"], list)
    prepared = FluidLLM.build(model.cfg, tds.ds_props(), **TINY)
    prepared.load_state_dict(model.state_dict())
    prepared.prepare_inference_params()
    assert isinstance(prepared.backbone.layers, bb.StackedLayers) and prepared.lora is None
    return jprepared, prepared


def test_stacked_generate_streaming_matches_jax(pair, monkeypatch):
    """3 streaming steps of the stacked model (the JAX stacked scan's
    oracle, ``tests/test_streaming.py:368-388``), and then past eviction
    (``max_ctx_len + 2`` steps) against the port's unrolled model."""
    jmodel, _, jds, model, tds = pair
    jprepared, prepared = _stacked(pair, monkeypatch)
    states, _, _, bc_mask, pos = next(jmake_batches(jds, 2, shuffle=False))
    want_s, want_d = jax.jit(lambda p, s, m, q: jgenerate_streaming(
        jmodel, p, s, m, q, 3))(jprepared, states[:, :1], bc_mask, pos)
    tb = next(make_batches(tds, 2, shuffle=False))
    got_s, got_d = generate_streaming(prepared, tb[0][:, :1], tb[3], tb[4], 3)
    _close(got_s, want_s, atol=1e-4, rtol=0)
    _close(got_d, want_d, atol=1e-4, rtol=0)
    n_steps = prepared.max_ctx_len + 2
    monkeypatch.delenv("FLUID_SCAN_LAYERS")
    unrolled = FluidLLM.build(model.cfg, tds.ds_props(), **TINY)
    unrolled.load_state_dict(model.state_dict())
    unrolled.prepare_inference_params()
    assert isinstance(unrolled.backbone.layers, torch.nn.ModuleList)
    ref_s, _ = generate_streaming(unrolled, tb[0][:, :1], tb[3], tb[4], n_steps)
    got_s, _ = generate_streaming(prepared, tb[0][:, :1], tb[3], tb[4], n_steps)
    _close(got_s, ref_s.numpy(), atol=1e-5, rtol=0)


def test_stacked_exact_rollout_matches_jax(pair, monkeypatch):
    """The exact (re-encoding) rollout on the stacked layout, through the
    window's fill and slide, against JAX's stacked ``apply`` scan."""
    jmodel, _, jds, _, tds = pair
    jprepared, prepared = _stacked(pair, monkeypatch)
    n_steps = prepared.max_ctx_len + 1
    states, _, _, bc_mask, pos = next(jmake_batches(jds, 2, shuffle=False))
    want_s, want_d = jax.jit(lambda p, s, m, q: jgenerate(
        jmodel, p, s, m, q, n_steps))(jprepared, states[:, :1], bc_mask, pos)
    tb = next(make_batches(tds, 2, shuffle=False))
    got_s, got_d = generate(prepared, tb[0][:, :1], tb[3], tb[4], n_steps)
    _close(got_s, want_s, atol=1e-4, rtol=0)
    _close(got_d, want_d, atol=1e-4, rtol=0)


def test_prepare_unstacks_first_and_stacks_on_request(pair):
    """``prepare_inference_params(stack_layers=True)`` stacks; preparing a
    stacked model again unstacks, merges nothing new and stacks again,
    bit for bit."""
    _, _, _, model, tds = pair
    prepared = FluidLLM.build(model.cfg, tds.ds_props(), **TINY)
    prepared.load_state_dict(model.state_dict())
    prepared.prepare_inference_params(stack_layers=True)
    assert isinstance(prepared.backbone.layers, bb.StackedLayers)
    before = {k: v.clone() for k, v in prepared.state_dict().items()}
    prepared.prepare_inference_params()
    assert isinstance(prepared.backbone.layers, torch.nn.ModuleList)
    prepared.prepare_inference_params(stack_layers=True)
    for k, v in prepared.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_inference_main_streaming_stacked_on_cpu(tmp_path, monkeypatch):
    """``inference.main --streaming`` reaches the stacked layout through
    ``FLUID_SCAN_LAYERS=1`` unchanged: the same N-RMSE as the unrolled run
    of the same seeded weights."""
    with open(os.path.join(os.path.dirname(__file__), "..", "configs", "flagship_llama.yaml")) as f:
        flagship = yaml.safe_load(f)
    flagship.update(llm_layers=2, half_precision=False, resolution=64, load_dir="synthetic:1",
                    decoder_params=CFG["decoder_params"])
    path = tmp_path / "flagship_small.yaml"
    path.write_text(yaml.safe_dump(flagship))
    argv = ["--config_path", str(path), "--device", "cpu", "--streaming", "--seq_len",
            str(SEQ_LEN), "--pred_steps", "3"]
    unrolled = inference.main(argv)
    monkeypatch.setenv("FLUID_SCAN_LAYERS", "1")
    stacked = inference.main(argv)
    assert np.isfinite(stacked) and abs(stacked - unrolled) <= 1e-5 * abs(unrolled)
