"""The port's input embeddings, grid GATv2 stack and patch decoders against
the JAX package's.

Same weights (JAX init, bridged) and numpy-seeded inputs, f32.  On CPU the
port's slot attention is the kernel's plain twin; the JAX side runs its
unfused two-pass formulation.  atol 1e-5: f32 sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid_llm_tpu.config import DecoderConfig, EncoderConfig, PosEmbeddingConfig
from fluid_llm_tpu.data.ds_props import DSProps as JDSProps
from fluid_llm_tpu.models.decoders import patch_decoder_apply, patch_decoder_init
from fluid_llm_tpu.models.embeddings import input_embeddings_apply, input_embeddings_init
from fluid_llm_tpu.ops.grid_gnn import grid_gat_stack_apply, grid_gat_stack_init
from fluid_llm_tpu_torch.data.ds_props import DSProps
from fluid_llm_tpu_torch.models.decoders import PatchDecoder
from fluid_llm_tpu_torch.models.embeddings import InputEmbeddings
from fluid_llm_tpu_torch.ops.grid_gnn import GridGATStack
from fluid_llm_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)


def _load(module, tree):
    module.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, tree)))
    return module


@pytest.mark.parametrize("num_layers,heads", [(3, 1), (3, 2), (1, 1)])
def test_gat_stack_matches_jax(rng, num_layers, heads):
    in_dim, hid, out = 8, 12, 3
    params = grid_gat_stack_init(jax.random.PRNGKey(2), in_dim, hid, out, num_layers, heads)
    stack = _load(GridGATStack(in_dim, hid, out, num_layers, heads), params)
    x = rng.normal(size=(2, 10, 6, in_dim)).astype(np.float32)
    ref = jax.jit(lambda p, v: grid_gat_stack_apply(p, v, hid, out, heads))(params, jnp.asarray(x))
    with torch.no_grad():
        got = stack(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("kind", ["MLPGNN", "MLP"])
def test_patch_decoder_matches_jax(rng, kind):
    cfg = DecoderConfig(type=kind, gnn_dim=8, gnn_hid_dim=12, gnn_layers=3, gnn_heads=1,
                        mlp_hid_dim=32, hidden_dim=32)
    geom = dict(Nx_patch=3, Ny_patch=2, patch_size=(4, 4), seq_len=2)
    params = patch_decoder_init(jax.random.PRNGKey(4), 16, JDSProps(**geom), cfg)
    dec = _load(PatchDecoder(16, DSProps(**geom), cfg), params)
    tokens = rng.normal(size=(2, 1, 6, 16)).astype(np.float32)
    ref = jax.jit(lambda p, t: patch_decoder_apply(p, t, JDSProps(**geom), cfg))(params, jnp.asarray(tokens))
    with torch.no_grad():
        got = dec(torch.from_numpy(tokens))
    assert got.shape == (2, 1, 12, 8, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("ln_eps", [None, 1e-5])
def test_input_embeddings_match_jax(rng, ln_eps):
    """MLP patch encoder + learned 3-axis positions (+ optional LayerNorm)."""
    enc = EncoderConfig(hidden_dim=32)
    emb = PosEmbeddingConfig(in_emb_ln_eps=ln_eps)
    params = input_embeddings_init(jax.random.PRNGKey(6), 3 * 4 * 4, 16, (3, 2, 5), enc, emb)
    module = _load(InputEmbeddings(3 * 4 * 4, 16, (3, 2, 5), enc, emb), params)
    x = rng.normal(size=(2, 4, 6, 3, 4, 4)).astype(np.float32)
    pos = np.stack(np.broadcast_arrays(rng.integers(0, 3, (2, 4, 6)), rng.integers(0, 2, (2, 4, 6)),
                                       rng.integers(0, 5, (2, 4, 6))), axis=-1)
    ref = jax.jit(lambda p, a, b: input_embeddings_apply(p, a, b, enc, emb))(
        params, jnp.asarray(x), jnp.asarray(pos))
    with torch.no_grad():
        got = module(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
