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


def _pos_case(R: int, d: int, sizes: tuple[int, int, int], seed: int, dtype=torch.float32):
    """h (2, R/2, d), the three tables, and ids (2, R/2, 3): repeated,
    unsorted, different in each batch element, negative ones included where
    a table has more than one row."""
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(2, R // 2, d, generator=g, dtype=dtype)
    tables = [torch.randn(n, d, generator=g, dtype=dtype) for n in sizes]
    ids = torch.stack([torch.randint(-n if n > 1 else 0, n, (2, R // 2), generator=g)
                       for n in sizes], dim=-1)
    return h, tables, ids


@pytest.mark.parametrize("R,d,sizes", [(120, 16, (15, 4, 11)), (64, 12, (1, 1, 1)),
                                       (90, 8, (3, 1, 7))])
@pytest.mark.parametrize("kernels", [True, False])
def test_pos_embed_add_twin_matches_autograd_through_indexing(R, d, sizes, kernels):
    """On the CPU, ``pos_embed_add`` (kernels or not) is the plain indexing:
    the output, dh and each table's gradient equal autograd through it."""
    from fluid_llm_tpu_torch.ops.pos_embed import pos_embed_add

    h, tables, ids = _pos_case(R, d, sizes, seed=R + d)
    g = torch.randn(h.shape, generator=torch.Generator().manual_seed(1))
    leaves = [a.clone().requires_grad_() for a in (h, *tables)]
    out = pos_embed_add(*leaves, ids, kernels=kernels)
    out.backward(g)
    want = [a.clone().requires_grad_() for a in (h, *tables)]
    hh, x, y, t = want
    ref = hh + (x[ids[..., 0]] + y[ids[..., 1]] + t[ids[..., 2]])
    ref.backward(g)
    assert torch.equal(out, ref)
    for got, exp in zip(leaves, want):
        assert torch.equal(got.grad, exp.grad)


@pytest.mark.parametrize("R,d,sizes,vec", [(42240 // 64, 48, (15, 4, 11), 4),
                                           (301, 13, (1, 1, 1), 1), (33, 8, (600, 300, 700), 4),
                                           (5, 16, (15, 4, 11), 4)])
def test_pos_embed_grad_walk_matches_index_put(R, d, sizes, vec):
    """The backward kernel's order of additions (:func:`grad_walk` under the
    card's plan) against autograd through the indexing (``index_put_``
    accumulating): f32 sums of up to ~300 rows in another order, so within
    a few f32 roundings of the sum: rtol 2e-6, atol 1e-5."""
    from fluid_llm_tpu_torch.ops import pos_embed as pe

    h, tables, ids = _pos_case(2 * (R // 2) or 2, d, sizes, seed=d)
    ids2 = ids.reshape(-1, 3)
    g2 = torch.randn(ids2.shape[0], d, generator=torch.Generator().manual_seed(2))
    leaves = [a.clone().requires_grad_() for a in tables]
    pe.pos_embed_ref(h.reshape(-1, d), *leaves, ids2).backward(g2)
    width, rows = pe.grad_plan(ids2.shape[0], d, sum(sizes), vec, 132)
    got = pe.grad_walk(g2, pe.table_rows(ids2, *sizes), sum(sizes), rows)
    torch.testing.assert_close(got, torch.cat([a.grad for a in leaves]), atol=1e-5, rtol=2e-6)
    assert pe.grad_smem(sum(sizes), width, vec) <= pe.SMEM_MAX


@pytest.mark.parametrize("R,d,n_tab,vec,want", [
    (42240, 768, 30, 4, (96, 160)),     # the training step: 2 slabs, 264 chunks
    (21120, 1024, 30, 4, (128, 107)),   # the 350m rollout's shape: 2 slabs, 198 chunks
    (42240, 767, 30, 1, (128, 480)),    # d off the vector: 6 slabs of scalars, one short
    (42240, 768, 1600, 4, (2, 7040)),   # long tables: the slab narrows to fit 64 KB
    (40, 768, 30, 4, (96, 20)),         # few rows: R / MIN_CHUNK_ROWS chunks, rounded up
])
def test_pos_embed_grad_plan(R, d, n_tab, vec, want):
    """Slabs of at most MAX_WIDTH vectors, narrowed until the accumulator
    fits GRAD_SMEM; chunks that fill 132 SMs once, no more than R /
    MIN_CHUNK_ROWS (rounded up); every row and column covered."""
    from fluid_llm_tpu_torch.ops import pos_embed as pe

    width, rows = pe.grad_plan(R, d, n_tab, vec, 132)
    assert (width, rows) == want
    assert width <= pe.MAX_WIDTH and -(-R // rows) * rows >= R
    assert pe.grad_smem(n_tab, width, vec) <= max(pe.GRAD_SMEM + pe.ID_TILE * 12,
                                                  pe.grad_smem(n_tab, 1, vec))


def test_pos_embed_grad_plan_refuses_tables_too_long_for_shared_memory():
    from fluid_llm_tpu_torch.ops import pos_embed as pe

    with pytest.raises(ValueError, match="shared memory"):
        pe.grad_plan(100, 768, 20000, 4, 132)


def test_pos_embed_ids_wrap_and_raise_on_the_twins_terms():
    """A negative id counts from its table's end; one outside [-n, n) raises
    IndexError, in the twin and in the walk's id map alike."""
    from fluid_llm_tpu_torch.ops import pos_embed as pe

    h, (x, y, t), ids = _pos_case(8, 4, (3, 2, 5), seed=3)
    wrapped = torch.where(ids < 0, ids + torch.tensor([3, 2, 5]), ids)
    assert torch.equal(pe.pos_embed_add(h, x, y, t, ids), pe.pos_embed_add(h, x, y, t, wrapped))
    assert torch.equal(pe.table_rows(ids.reshape(-1, 3), 3, 2, 5),
                       wrapped.reshape(-1, 3) + torch.tensor([0, 3, 5]))
    for bad in (3, -4):
        ids_bad = ids.clone()
        ids_bad[1, 2, 0] = bad
        with pytest.raises(IndexError):
            pe.pos_embed_add(h, x, y, t, ids_bad)
        with pytest.raises(IndexError):
            pe.table_rows(ids_bad.reshape(-1, 3), 3, 2, 5)


def test_input_embeddings_kernels_flag_keeps_the_twin_on_cpu():
    """``InputEmbeddings(..., kernels=...)`` and ``FluidLLM.kernels``: on CPU
    tensors both settings run the twin, so the results are equal."""
    from fluid_llm_tpu_torch.config import EncoderConfig as TEnc, PosEmbeddingConfig as TEmb

    torch.manual_seed(0)
    module = InputEmbeddings(3 * 4 * 4, 16, (3, 2, 5), TEnc(hidden_dim=32), TEmb())
    module.reset_parameters(torch.Generator().manual_seed(5))
    x = torch.randn(2, 4, 6, 3, 4, 4)
    pos = torch.stack([torch.randint(0, n, (2, 4, 6)) for n in (3, 2, 5)], dim=-1)
    with torch.no_grad():
        assert torch.equal(module(x, pos, kernels=True), module(x, pos, kernels=False))
