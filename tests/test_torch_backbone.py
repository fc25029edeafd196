"""The port's backbone and adapter merge against the JAX package's.

Same weights on both sides (JAX init, bridged by ``weights.from_jax_params``)
and the same numpy-seeded inputs, in f32.  Tolerance atol 2e-5 / rtol 1e-5
unless stated: f32 matmuls and softmax summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid_llm_tpu.config import LoraConfig
from fluid_llm_tpu.models import backbone as jbb
from fluid_llm_tpu.models import lora as jlora
from fluid_llm_tpu_torch.models import backbone as bb
from fluid_llm_tpu_torch.models.lora import Lora, merge_lora
from fluid_llm_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

# tiny OPT (2 layers, d 128, 2 heads of 64) and its GPT-2 / post-LN
# (OPT-350m-style project_in/out, no final norm) variants
TINY = dict(n_layers=2, d_model=128, n_heads=2, d_ff=256, max_pos=512, dropout=0.0)
VARIANTS = {
    "opt": dict(family="opt", act="relu", pos_offset=2),
    "gpt2": dict(family="gpt2", act="gelu_new"),
    "opt_postln": dict(family="opt", act="relu", pos_offset=2, d_embed=64,
                       pre_ln=False, final_ln=False),
}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(variant):
    kw = {**TINY, **VARIANTS[variant]}
    jcfg = jbb.BackboneConfig(**kw)
    params = jbb.init_params(jax.random.PRNGKey(0), jcfg)
    model = bb.Backbone(bb.BackboneConfig(**kw))
    model.load_state_dict(from_jax_params(_numpy_tree(params)))
    return jcfg, params, model


def _japply(cfg, **kw):
    """``backbone.apply`` jitted: one compile instead of one per op."""
    return jax.jit(lambda p, x, v: jbb.apply(p, cfg, x, v, **kw))


def _window(d, L=157, n_invalid=41, bs=2, seed=1):
    """A rollout-like window: invalid tokens at the front."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bs, L, d)).astype(np.float32) * 0.5
    valid = np.broadcast_to(np.arange(L)[None, :] >= n_invalid, (bs, L)).copy()
    return x, valid


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_apply_masked_window(variant):
    jcfg, params, model = _pair(variant)
    x, valid = _window(jcfg.embed_dim)
    ref = _japply(jcfg)(params, jnp.asarray(x), jnp.asarray(valid))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_apply_decode_slice(variant):
    """The sliced final block == the JAX one (and == the dense rows)."""
    jcfg, params, model = _pair(variant)
    x, valid = _window(jcfg.embed_dim)
    start, n = 97, 60
    ref = _japply(jcfg, decode_slice=(jnp.asarray(start, jnp.int32), n))(
        params, jnp.asarray(x), jnp.asarray(valid))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(valid), decode_slice=(start, n))
        dense = model(torch.from_numpy(x), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), dense[:, start:start + n].numpy(), atol=2e-5, rtol=1e-5)


def test_make_masks_matches_jax():
    valid = np.zeros((2, 23), bool)
    valid[0, 5:] = True
    valid[1, :] = True
    jpos, jallowed = jbb.make_masks(jnp.asarray(valid))
    pos, allowed = bb.make_masks(torch.from_numpy(valid))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(allowed.numpy(), np.asarray(jallowed))


def test_merge_lora_dora_then_pack_qkv():
    """DoRA merge then q/k/v packing == the JAX transforms (weights to 1e-6,
    f32 rounding of the norm), and the packed backbones agree."""
    jcfg, params, model = _pair("opt")
    lcfg = LoraConfig(r=4, lora_alpha=16, use_dora=True)
    ltree = jlora.init_lora(jax.random.PRNGKey(3), params, lcfg)
    rng = np.random.default_rng(7)
    for layer in ltree["layers"]:  # B is zero at init: make the merge non-trivial
        for leaf in layer["attn"].values():
            leaf["B"] = jnp.asarray(rng.normal(size=leaf["B"].shape).astype(np.float32) * 0.1)
            leaf["m"] = leaf["m"] * jnp.asarray(rng.uniform(0.5, 1.5, leaf["m"].shape), jnp.float32)
    jpacked = jbb.pack_qkv_params(jlora.merge_lora(params, ltree, lcfg))

    lora = Lora(model, lcfg)
    lora.load_state_dict(from_jax_params(_numpy_tree(ltree)))
    merge_lora(model, lora)
    bb.pack_qkv_params(model)
    for li, layer in enumerate(model.layers):
        jqkv = jpacked["layers"][li]["attn"]["qkv"]
        np.testing.assert_allclose(layer.attn["qkv"].weight.detach().numpy(),
                                   np.asarray(jqkv["w"]).T, atol=1e-6)
        np.testing.assert_allclose(layer.attn["qkv"].bias.detach().numpy(),
                                   np.asarray(jqkv["b"]), atol=0)

    x, valid = _window(jcfg.embed_dim)
    ref = _japply(jcfg)(jpacked, jnp.asarray(x), jnp.asarray(valid))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


def test_cast_matmul_params_keeps_norms_f32():
    _, _, model = _pair("opt")
    bb.pack_qkv_params(model)
    bb.cast_matmul_params(model, torch.bfloat16)
    layer = model.layers[0]
    assert layer.attn["qkv"].weight.dtype == torch.bfloat16
    assert layer.mlp["fc1"].bias.dtype == torch.bfloat16
    assert layer.ln1.weight.dtype == torch.float32
    assert model.pos_embed.dtype == torch.float32
