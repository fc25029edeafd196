"""The LLaMA / rope_abs / streaming slice of the port against the JAX package.

Same weights on both sides (the JAX init, bridged by
``weights.from_jax_params``; DoRA ``B`` made non-zero so merging matters),
the same numpy-seeded inputs, f32, on the CPU.  The shapes are those of
``tests/test_streaming.py``: 2 layers, d 64 or 128, 4 heads.  The JAX
Pallas decode kernel runs in interpret mode, as that file runs it.

Tolerances: 2e-5 absolute / 1e-5 relative on single forwards (f32 matmuls
and softmax summed in another order); 1e-4 absolute on rollouts (f32,
several chained steps through the decoder); 1e-5 relative on the loss and
1e-4 of each tensor's largest entry on gradients, as
``tests/test_torch_train.py``; exact equality for integer position ids.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fluid_llm_tpu.config import Config, DecoderConfig, LoraConfig
from fluid_llm_tpu.data import pipeline as jpipe
from fluid_llm_tpu.data.pipeline import make_batches as jmake_batches
from fluid_llm_tpu.data.synthetic import SyntheticCylinderDataset as JSynthetic
from fluid_llm_tpu.models import backbone as jbb
from fluid_llm_tpu.models import embeddings as jemb
from fluid_llm_tpu.models import lora as jlora
from fluid_llm_tpu.models.fluid_llm import FluidLLM as JFluidLLM
from fluid_llm_tpu.ops import decode_attention as jda
from fluid_llm_tpu.rollout.generate import generate as jgenerate
from fluid_llm_tpu.rollout.streaming import generate_streaming as jgenerate_streaming
from fluid_llm_tpu.train.trainer import Trainer as JTrainer
from fluid_llm_tpu_torch import inference
from fluid_llm_tpu_torch.data import make_batches
from fluid_llm_tpu_torch.data import pipeline as pipe
from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
from fluid_llm_tpu_torch.models import backbone as bb
from fluid_llm_tpu_torch.models import embeddings as emb
from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
from fluid_llm_tpu_torch.models.lora import Lora, merge_lora
from fluid_llm_tpu_torch.ops import decode_attention as da
from fluid_llm_tpu_torch.rollout import streaming
from fluid_llm_tpu_torch.rollout.generate import generate
from fluid_llm_tpu_torch.train.trainer import Trainer
from fluid_llm_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

SEQ_LEN = 5
LLAMA = dict(family="llama", act="silu", norm="rmsnorm", pos="rope", ln_eps=1e-6, dropout=0.0)
# backbone-level: 2 layers, d 128, 4 heads of 32 (the JAX decode kernel's
# smallest shape: hd >= 32 and 128-lane head groups)
TINY_BB = dict(n_layers=2, d_model=128, n_heads=4, d_ff=256, max_pos=4096)
# model-level: 2 layers, d 64, 4 heads (``tests/test_streaming.py``)
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


# -- data -------------------------------------------------------------------


@pytest.mark.parametrize("t_base,t_step", [(0, 1), (100, 1), (37, 3)])
def test_position_ids_absolute_time_match_jax(t_base, t_step):
    got = pipe.position_ids(7, 5, 4, t_base=t_base, t_step=t_step)
    np.testing.assert_array_equal(got.numpy(), jpipe.position_ids(7, 5, 4, t_base, t_step))


def test_absolute_time_dataset_matches_jax():
    """Each frame labelled with its raw trajectory step (valid: step 100,
    stride ``seq_interval``); the rest of the sample unchanged."""
    kw = dict(n_trajectories=1, resolution=64, seq_len=SEQ_LEN, seq_interval=2, mode="valid",
              absolute_time=True)
    got, want = SyntheticCylinderDataset(**kw)[0], JSynthetic(**kw)[0]
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert got[4][:, 0, 2].tolist() == [100, 102, 104, 106]
    for t, j in zip(got[:4], want[:4]):
        _close(t, j, atol=1e-6)


# -- embeddings ---------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rope", "rope_abs"])
def test_rotary3d_ladders_match_jax(rng, kind):
    x = rng.normal(size=(2, 3, 20, 66)).astype(np.float32)
    pos = np.stack([rng.integers(0, 5, (2, 3, 20)), rng.integers(0, 4, (2, 3, 20)),
                    rng.integers(90, 360, (2, 3, 20))], axis=-1)
    if kind == "rope":
        want = jemb.rotary3d_apply(jnp.asarray(x), jnp.asarray(pos), 66)
        got = emb.rotary3d_apply(torch.from_numpy(x), torch.from_numpy(pos))
    else:
        want = jemb.rotary3d_abs_apply(jnp.asarray(x), jnp.asarray(pos), (5, 4))
        got = emb.rotary3d_abs_apply(torch.from_numpy(x), torch.from_numpy(pos), (5, 4))
    _close(got, want, atol=1e-5)


# -- backbone ----------------------------------------------------------------


def _bb_pair(**kw):
    cfg_kw = {**TINY_BB, **LLAMA, **kw}
    jcfg = jbb.BackboneConfig(**cfg_kw)
    params = jbb.init_params(jax.random.PRNGKey(0), jcfg)
    model = bb.Backbone(bb.BackboneConfig(**cfg_kw))
    model.load_state_dict(from_jax_params(_np(params)))
    return jcfg, params, model


def _window(d, L=157, n_invalid=41, bs=2, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bs, L, d)).astype(np.float32) * 0.5
    valid = np.broadcast_to(np.arange(L)[None, :] >= n_invalid, (bs, L)).copy()
    return x, valid


@pytest.mark.parametrize("n_kv_heads", [None, 2])
def test_llama_backbone_matches_jax(n_kv_heads):
    """RMSNorm, rope, SwiGLU, no biases; grouped k/v heads repeated on the
    plain path.  A masked window, dense and with ``decode_slice``."""
    jcfg, params, model = _bb_pair(n_kv_heads=n_kv_heads)
    x, valid = _window(jcfg.d_model)
    start, n = 97, 60
    ref = jax.jit(lambda p, x, v: jbb.apply(p, jcfg, x, v))(params, x, valid)
    ref_s = jax.jit(lambda p, x, v: jbb.apply(
        p, jcfg, x, v, decode_slice=(jnp.asarray(start, jnp.int32), n)))(params, x, valid)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(valid))
        got_s = model(torch.from_numpy(x), torch.from_numpy(valid), decode_slice=(start, n))
    assert model.pos_embed is None and all(
        lin.bias is None for layer in model.layers for g in (layer.attn, layer.mlp)
        for lin in g.values())
    _close(got, ref)
    _close(got_s, ref_s)


def test_llama_merge_then_pack_bias_free():
    """DoRA merge on the bias-free q/v, then q/k/v packing into one
    bias-free linear of d + 2 kv_dim outputs (grouped heads), as the JAX
    transforms; the packed backbones agree, also through ``decode_slice``."""
    jcfg, params, model = _bb_pair(n_kv_heads=2)
    lcfg = LoraConfig(r=4, lora_alpha=16, use_dora=True)
    ltree = jlora.init_lora(jax.random.PRNGKey(3), params, lcfg)
    rng = np.random.default_rng(7)
    for layer in ltree["layers"]:
        for leaf in layer["attn"].values():
            leaf["B"] = jnp.asarray(rng.normal(size=leaf["B"].shape).astype(np.float32) * 0.1)
    jpacked = jbb.pack_qkv_params(jlora.merge_lora(params, ltree, lcfg))
    lora = Lora(model, lcfg)
    lora.load_state_dict(from_jax_params(_np(ltree)))
    merge_lora(model, lora)
    bb.pack_qkv_params(model)
    for li, layer in enumerate(model.layers):
        qkv = layer.attn["qkv"]
        assert qkv.bias is None and qkv.out_features == 128 + 2 * 64
        _close(qkv.weight, np.asarray(jpacked["layers"][li]["attn"]["qkv"]["w"]).T, atol=1e-6)
    x, valid = _window(jcfg.d_model)
    ref = jax.jit(lambda p, x, v: jbb.apply(
        p, jcfg, x, v, decode_slice=(jnp.asarray(97, jnp.int32), 60)))(jpacked, x, valid)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(valid), decode_slice=(97, 60))
    _close(got, ref)


# -- decode attention --------------------------------------------------------

N_SINK, FRAME, R = 11, 10, 3  # slab height 16: 6 pad rows per slab


def _cache_state(state: str):
    """(ring_pos, sink_pos, q0) of a cache with R ring slots: the first
    decode (slot 0 written, 2 unwritten), the prefill (sinks only, queries
    are the sinks themselves), or a wrapped ring (frame 4 in slot 1, slot
    order != position order)."""
    sinks = np.arange(N_SINK, dtype=np.int32)
    base = lambda f: N_SINK + f * FRAME  # noqa: E731
    if state == "first":
        return np.array([base(0), -1, -1], np.int32), sinks, base(0)
    if state == "prefill":
        return np.full(R, -1, np.int32), sinks, 0
    return np.array([base(3), base(4), base(2)], np.int32), sinks, base(4)


@pytest.mark.parametrize("state", ["first", "prefill", "wrapped"])
def test_slab_decode_ref_matches_pallas_and_slab_attention(rng, state):
    """The twin against the JAX kernel in interpret mode and against
    ``_attention_slabs`` on the same cache: unwritten slots, pad rows and a
    wrapped ring, keys read at layer 1 of the stacked buffer."""
    cfg = bb.BackboneConfig(**TINY_BB, **LLAMA)
    ring_pos, sink_pos, q0 = _cache_state(state)
    bs, P = 2, (N_SINK if state == "prefill" else FRAME)
    cache = bb.init_streaming_cache(cfg, bs, N_SINK, R, FRAME)
    cache["k"].copy_(torch.from_numpy(rng.normal(size=cache["k"].shape).astype(np.float32)))
    cache["v"].copy_(torch.from_numpy(rng.normal(size=cache["v"].shape).astype(np.float32)))
    cache["ring_pos"].copy_(torch.from_numpy(ring_pos))
    cache["sink_pos"].copy_(torch.from_numpy(sink_pos))
    q = rng.normal(size=(bs, P, 128)).astype(np.float32)
    kp_row = bb.slab_key_positions(cache, FRAME)
    k, v = cache["k"].numpy(), cache["v"].numpy()

    want = jda.slab_decode(q, k, v, jda.pad_key_pos(jnp.asarray(kp_row.numpy())),
                           jnp.full((1, 1), q0, jnp.int32), 1, 32, interpret=True)
    key_pos = da.pad_key_pos(kp_row)
    assert key_pos.shape == (1, 64) and key_pos.dtype == torch.int32
    got = da.slab_decode(torch.from_numpy(q), cache["k"], cache["v"], key_pos,
                         torch.tensor([q0], dtype=torch.int32), 1, 32)
    _close(got, want)
    qpos = q0 + torch.arange(P)
    allowed = (kp_row[None, :] <= qpos[:, None])[None, None]
    plain = bb._attention_slabs(torch.from_numpy(q).reshape(bs, P, 4, 32), cache["k"][1],
                                cache["v"][1], allowed, cfg)
    _close(got, plain.reshape(bs, P, 128))


# -- streaming backbone ------------------------------------------------------


@pytest.mark.parametrize("packed", [False, True])
def test_apply_streaming_past_eviction_matches_jax(packed):
    """Sinks prefilled, then 5 frames into a ring of 3 (frames 3 and 4
    evict 0 and 1): every step's output and the final cache contents
    (K/V slabs, sink and ring positions) equal the JAX ``apply_streaming``'s."""
    jcfg, params, model = _bb_pair()
    if packed:
        params = jbb.pack_qkv_params(params)
        bb.pack_qkv_params(model)
    n_frames, bs = 5, 2
    rng = np.random.default_rng(3)
    x = rng.normal(size=(bs, N_SINK + n_frames * FRAME, 128)).astype(np.float32) * 0.5
    positions = np.arange(x.shape[1], dtype=np.int32)
    jstep = jax.jit(lambda p, x, pos, c, slot: jbb.apply_streaming(p, jcfg, x, pos, c, slot))
    jcache = jbb.init_streaming_cache(jcfg, bs, N_SINK, R, FRAME)
    _, jcache = jbb.apply_streaming(params, jcfg, x[:, :N_SINK], positions[:N_SINK], jcache, 0,
                                    prefill=True)
    cache = bb.init_streaming_cache(model.cfg, bs, N_SINK, R, FRAME)
    _, cache = bb.apply_streaming(model, torch.from_numpy(x[:, :N_SINK]),
                                  torch.from_numpy(positions[:N_SINK]), cache, 0, prefill=True)
    for f in range(n_frames):
        lo = N_SINK + f * FRAME
        want, jcache = jstep(params, x[:, lo:lo + FRAME], positions[lo:lo + FRAME], jcache, f % R)
        got, cache = bb.apply_streaming(model, torch.from_numpy(x[:, lo:lo + FRAME]),
                                        torch.from_numpy(positions[lo:lo + FRAME]), cache, f % R)
        _close(got, want, name=f"frame {f}")
    for name in ("sink_pos", "ring_pos"):
        np.testing.assert_array_equal(cache[name].numpy(), np.asarray(jcache[name]))
    for name in ("k", "v"):
        _close(cache[name], jcache[name], name=name)


def test_apply_streaming_kernel_twin_equals_slab_attention_bf16():
    """In bf16 (the dtype the kernel takes) ``apply_streaming`` on CPU
    tensors goes through ``slab_decode``'s twin when ``kernels`` is set and
    through ``_attention_slabs`` otherwise: both give the same frame."""
    _, _, model = _bb_pair()
    model.cfg = model.cfg.replace(dtype=torch.bfloat16)
    bb.cast_matmul_params(model, torch.bfloat16)
    assert da.supported(model.cfg)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(1, N_SINK + 2 * FRAME, 128)).astype(np.float32))
    pos = torch.arange(x.shape[1], dtype=torch.int32)
    outs = []
    for kernels in (True, False):
        cache = bb.init_streaming_cache(model.cfg, 1, N_SINK, R, FRAME)
        bb.apply_streaming(model, x[:, :N_SINK + FRAME], pos[:N_SINK + FRAME], cache, 0,
                           prefill=True, frame_tokens=FRAME, kernels=kernels)
        outs.append(bb.apply_streaming(model, x[:, N_SINK + FRAME:], pos[N_SINK + FRAME:],
                                       cache, 1, kernels=kernels)[0])
    assert torch.equal(outs[0], outs[1])


# -- the streaming rollout ---------------------------------------------------


def _model_pair(**cfg_kw):
    cfg = Config(**{**CFG, **cfg_kw})
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


@pytest.fixture(scope="module")
def pair():
    return _model_pair()


def test_generate_streaming_matches_jax_through_eviction(pair):
    """``max_ctx_len + 2`` steps (the ring wraps and rewrites slot 0) from
    one context state; the JAX side merges its adapters on the fly, the
    port is prepared (adapters merged, qkv packed).  The port served from a
    model still carrying adapters merges a copy and gives the same states."""
    jmodel, params, jds, model, tds = pair
    n_steps = model.max_ctx_len + 2
    states, _, _, bc_mask, pos = next(jmake_batches(jds, 2, shuffle=False))
    want_s, want_d = jax.jit(lambda p, s, m, q: jgenerate_streaming(
        jmodel, p, s, m, q, n_steps))(params, states[:, :1], bc_mask, pos)
    tb = next(make_batches(tds, 2, shuffle=False))
    raw_s, _ = streaming.generate_streaming(model, tb[0][:, :1], tb[3], tb[4], n_steps)
    assert model.lora is not None  # the caller's model is left as it was
    prepared = FluidLLM.build(model.cfg, tds.ds_props(), **TINY)
    prepared.load_state_dict(model.state_dict())
    prepared.prepare_inference_params()
    got_s, got_d = streaming.generate_streaming(prepared, tb[0][:, :1], tb[3], tb[4], n_steps)
    assert got_s.shape == (2, 1 + n_steps) + tuple(tb[0].shape[2:])
    _close(got_s, want_s, atol=1e-4, rtol=0)
    _close(got_d, want_d, atol=1e-4, rtol=0)
    _close(raw_s, got_s.numpy(), atol=1e-5, rtol=0)


def test_generate_streaming_context_prefill_matches_jax(pair):
    """Three context states: the prefill writes the sinks and two frames."""
    jmodel, params, jds, model, tds = pair
    states, _, _, bc_mask, pos = next(jmake_batches(jds, 2, shuffle=False))
    want_s, _ = jax.jit(lambda p, s, m, q: jgenerate_streaming(
        jmodel, p, s, m, q, 3))(params, states[:, :3], bc_mask, pos)
    tb = next(make_batches(tds, 2, shuffle=False))
    got_s, _ = streaming.generate_streaming(model, tb[0][:, :3], tb[3], tb[4], 3)
    _close(got_s, want_s, atol=1e-4, rtol=0)


def test_llama_exact_rollout_absolute_time_matches_jax(pair):
    """The exact (re-encoding) rollout of the same model with absolute time
    ids, through the window's fill and slide."""
    jmodel, params, jds, model, tds = pair
    states, _, _, bc_mask, pos = next(jmake_batches(jds, 2, shuffle=False))
    n_steps = model.max_ctx_len + 1
    want_s, want_d = jax.jit(lambda p, s, m, q: jgenerate(
        jmodel, p, s, m, q, n_steps))(params, states[:, :1], bc_mask, pos)
    tb = next(make_batches(tds, 2, shuffle=False))
    got_s, got_d = generate(model, tb[0][:, :1], tb[3], tb[4], n_steps)
    _close(got_s, want_s, atol=1e-4, rtol=0)
    _close(got_d, want_d, atol=1e-4, rtol=0)


@pytest.mark.parametrize("change,match", [
    (dict(llm_backbone="gpt2", absolute_time_ids=False,
          pos_embedding_params={"pos_embedding_type": "pos"}), "rotary-position backbone"),
    (dict(absolute_time_ids=False, pos_embedding_params={"pos_embedding_type": "rope"}),
     "cache-stable input embeddings"),
    (dict(decoder_params={"type": "CNN"}), "CNN patch decoder"),
    (dict(absolute_time_ids=False), "absolute_time_ids"),
    ({}, "exceeds the ring capacity"),
])
def test_streaming_rejects_what_a_cache_cannot_serve(change, match):
    """The four configurations of ``_check_streaming_compat``, and a context
    longer than the ring."""
    cnn = change.pop("decoder_params", None)  # the CNN decoder is not ported: set it after
    cfg = Config(**{**CFG, "use_lora": False, **change})
    tds = SyntheticCylinderDataset(n_trajectories=1, resolution=64, seq_len=SEQ_LEN,
                                   mode="valid", absolute_time=True)
    model = FluidLLM.build(cfg, tds.ds_props(), **TINY)
    if cnn is not None:
        model.cfg = cfg.replace(decoder_params=DecoderConfig(**cnn))
        change = cnn
    states, _, _, bc_mask, pos = next(make_batches(tds, 1, shuffle=False))
    init = states[:, :1] if change else states[:, :1].expand(
        1, model.max_ctx_len + 1, *states.shape[2:])
    with pytest.raises(ValueError, match=match):
        streaming.generate_streaming(model, init, bc_mask, pos, 2)


def test_inference_main_streaming_on_cpu(tmp_path):
    """``inference.main --streaming`` end to end: a flagship-shaped config
    (LLaMA, rope_abs, absolute time, DoRA, MLPGNN) cut to 2 layers, seeded
    random weights, finite N-RMSE."""
    with open(os.path.join(os.path.dirname(__file__), "..", "configs", "flagship_llama.yaml")) as f:
        flagship = yaml.safe_load(f)
    flagship.update(llm_layers=2, half_precision=False, resolution=64, load_dir="synthetic:1",
                    decoder_params=CFG["decoder_params"])
    path = tmp_path / "flagship_small.yaml"
    path.write_text(yaml.safe_dump(flagship))
    mean = inference.main(["--config_path", str(path), "--device", "cpu", "--streaming",
                           "--seq_len", str(SEQ_LEN), "--pred_steps", "3"])
    assert np.isfinite(mean)


# -- training ----------------------------------------------------------------


def test_llama_autoreg_train_step_matches_jax():
    """One autoreg step of the LLaMA model: the loss and every trainable
    gradient (DoRA, encoder, decoder, BOS) against ``jax.value_and_grad`` of
    ``Trainer._mode_loss``.  The port's attention is the ``FlashAttention``
    Function (its twins on CPU tensors) on rope'd heads."""
    jmodel, params, jds, model, tds = _model_pair()
    jbatch = next(jmake_batches(jds, 2, shuffle=False))
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: JTrainer(jmodel)._mode_loss(p, b, jax.random.PRNGKey(1), "autoreg"),
        has_aux=True))
    (jloss, _), jgrads = fn(params, jbatch)
    loss, _ = Trainer(model).mode_loss(next(make_batches(tds, 2, shuffle=False)), "autoreg")
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = from_jax_params(_np(jgrads))
    trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    assert {n.split(".")[0] for n, _ in trainable} == {"lora", "input_emb", "decoder", "bos"}
    for n, p in trainable:
        w = want[n].numpy()
        _close(p.grad, w, atol=1e-4 * max(np.abs(w).max(), 1e-30), rtol=0, name=n)
