"""The port's segment sum and row gather (``fluid_llm_tpu_torch/ops/
segment_ops.py``) against the JAX package's, on the CPU.

The JAX side runs its Pallas kernels in interpret mode
(``FLUID_SEGSUM=interpret``, as ``tests/test_segment_sum_pallas.py`` does)
through ``segment_ops.segment_sum_nodes`` / ``gather_nodes`` with the
static window promise, which every id stream here keeps (sorted,
RCM-banded, ghosted).  The port's side is its plain twins (CPU tensors)
behind the same autograd Functions the kernels use on the card.

Tolerances (f32): the sum within atol 1e-5, rtol 1e-6 (the JAX test's own
bound: the TPU kernel sums bf16 limbs of the values in another order); the
gather equal bit for bit (a copy on both sides); gradients within atol 1e-5,
rtol 1e-6 (the backward of each is the other operation).  The CSR the sum
kernel walks is held to the twin bit for bit on the CPU: a sequential sum in
ascending edge order per row is exactly what ``index_add_`` computes there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid_llm_tpu.ops import segment_ops as jso
from fluid_llm_tpu_torch.ops import segment_ops as so

torch.set_num_threads(2)

B, E, N = 2, 384, 150
FEATS = [(1,), (2,), (32,), (128,)]


def make_ids(kind: str, rng) -> np.ndarray:
    """(B, E) int32 ids, or (E,) for ``single``."""
    if kind in ("sorted", "single"):
        ids = np.sort(rng.integers(0, N, size=(B, E)), axis=1)
        return ids[0].astype(np.int32) if kind == "single" else ids.astype(np.int32)
    trend = np.sort(rng.integers(0, N, size=(B, E)), axis=1)
    ids = np.clip(trend + rng.integers(-40, 40, size=(B, E)), 0, N - 1)
    if kind == "banded":
        assert np.any(np.diff(ids, axis=1) < 0)  # genuinely unsorted
        return ids.astype(np.int32)
    # ghosts: per-element id == N (the collate's ghost slot seen from a
    # graph of N nodes), beyond N, and negative -- all dropped / zero rows
    ids[:, -37:] = N
    ids[0, 5:9] = N + 7
    ids[1, 11] = -3
    return ids.astype(np.int32)


KINDS = ["sorted", "banded", "ghosts", "single"]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("FLUID_SEGSUM", "interpret")


def _values(rng, lead, feat):
    return rng.normal(size=lead + feat).astype(np.float32)


@pytest.mark.parametrize("feat", FEATS, ids=str)
@pytest.mark.parametrize("kind", KINDS)
def test_segment_sum_matches_jax_kernel(interpret, kind, feat):
    rng = np.random.default_rng(10 * KINDS.index(kind) + feat[0])
    ids = make_ids(kind, rng)
    vals = _values(rng, ids.shape, feat)
    want = jso.segment_sum_nodes(jnp.asarray(vals), jnp.asarray(ids), N, windowed=True)
    got = so.segment_sum_nodes(torch.from_numpy(vals), torch.from_numpy(ids), N)
    assert got.shape == want.shape == ids.shape[:-1] + (N,) + feat
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("feat", FEATS, ids=str)
@pytest.mark.parametrize("kind", KINDS)
def test_gather_matches_jax_kernel_bit_for_bit(interpret, kind, feat):
    rng = np.random.default_rng(1000 + 10 * KINDS.index(kind) + feat[0])
    ids = make_ids(kind, rng)
    V = _values(rng, ids.shape[:-1] + (N,), feat)
    want = jso.gather_nodes(jnp.asarray(V), jnp.asarray(ids), windowed=True)
    got = so.gather_nodes(torch.from_numpy(V), torch.from_numpy(ids))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    dropped = (ids < 0) | (ids >= N)
    assert dropped.any() == (kind == "ghosts")
    assert np.all(got.numpy()[dropped] == 0)


@pytest.mark.parametrize("feat", [(1,), (128,)], ids=str)
@pytest.mark.parametrize("kind", ["banded", "ghosts"])
def test_gradients_match_jax_custom_vjp(interpret, kind, feat):
    """d(sum)/dvalues is a gather, d(gather)/dnodes a segment sum, by the
    same ids, through the autograd Functions and the custom_vjp pair."""
    rng = np.random.default_rng(2000 + 10 * KINDS.index(kind) + feat[0])
    ids = make_ids(kind, rng)
    vals = _values(rng, ids.shape, feat)
    V = _values(rng, ids.shape[:-1] + (N,), feat)
    w_sum = _values(rng, ids.shape[:-1] + (N,), feat)
    w_gat = _values(rng, ids.shape, feat)
    jids = jnp.asarray(ids)

    def jloss(v, nodes):
        s = jso.segment_sum_nodes(v, jids, N, windowed=True)
        g = jso.gather_nodes(nodes, jids, windowed=True)
        return (s * w_sum).sum() + (g * w_gat).sum()

    jdv, jdV = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(vals), jnp.asarray(V))
    tv = torch.from_numpy(vals).requires_grad_()
    tV = torch.from_numpy(V).requires_grad_()
    index = so.SegmentIndex(torch.from_numpy(ids), N)  # one index for both, as the models
    loss = (so.segment_sum_nodes(tv, index, N) * torch.from_numpy(w_sum)).sum() \
        + (so.gather_nodes(tV, index) * torch.from_numpy(w_gat)).sum()
    loss.backward()
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jdv), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(tV.grad.numpy(), np.asarray(jdV), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("kind", ["banded", "ghosts"])
def test_csr_walk_is_the_twin_bit_for_bit(kind):
    """The sum kernel's algorithm on the CPU: each row's edges from the CSR,
    in ascending order, added one by one in f32 -- equal to the twin."""
    rng = np.random.default_rng(7)
    ids = torch.from_numpy(make_ids(kind, rng))
    vals = torch.from_numpy(_values(rng, tuple(ids.shape), (8,))).reshape(-1, 8)
    index = so.SegmentIndex(ids, N)
    perm, row_ptr = index.csr()
    assert perm.dtype == row_ptr.dtype == torch.int32
    assert row_ptr.shape == (index.n_rows + 1,) and int(row_ptr[0]) == 0
    assert int(row_ptr[-1]) == int((index.ids >= 0).sum())
    walked = torch.zeros(index.n_rows, 8)
    for r in range(index.n_rows):
        edges = perm[row_ptr[r]:row_ptr[r + 1]].long()
        assert torch.all(edges[1:] > edges[:-1]) and torch.all(index.ids[edges] == r)
        acc = torch.zeros(8)
        for e in edges:
            acc = acc + vals[e]
        walked[r] = acc
    assert torch.equal(walked, so.segment_sum_ref(vals, index))


@pytest.mark.parametrize("feat", FEATS, ids=str)
@pytest.mark.parametrize("kind", KINDS)
def test_csr_walk_function_is_the_twin_bit_for_bit(kind, feat):
    """``segment_ops.csr_walk``, the kernel's order vectorised over rows,
    equals the twin bit for bit on the CPU, a row of 20 edges (three of the
    kernel's batches) included."""
    rng = np.random.default_rng(11)
    ids = make_ids(kind, rng)
    ids[..., 40:60] = 3
    vals = torch.from_numpy(_values(rng, tuple(ids.shape), feat)).reshape(ids.size, -1)
    index = so.SegmentIndex(torch.from_numpy(ids), N)
    assert torch.equal(so.csr_walk(vals, index), so.segment_sum_ref(vals, index))


def test_index_flattens_with_per_element_offsets():
    """An id outside its own element's [0, N) is -1, never the next
    element's row (``segment_sum_pallas.py:270-282``)."""
    ids = torch.tensor([[0, 4, 5, -1], [5, 2, 0, 4]])
    index = so.SegmentIndex(ids, 5)
    assert index.ids.tolist() == [0, 4, -1, -1, -1, 7, 5, 9]
    assert index.n_rows == 10 and index.batch_shape == (2,) and index.n_edges == 4


def test_wrong_index_or_shapes_raise():
    ids = torch.zeros(2, 8, dtype=torch.int32)
    index = so.SegmentIndex(ids, 5)
    with pytest.raises(ValueError):
        so.segment_sum_nodes(torch.zeros(2, 8, 3), index, 6)
    with pytest.raises(ValueError):
        so.segment_sum_nodes(torch.zeros(2, 7, 3), index, 5)
    with pytest.raises(ValueError):
        so.gather_nodes(torch.zeros(3, 5, 3), index)
    with pytest.raises(ValueError):
        so.SegmentIndex(torch.zeros(2, 8), 5)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernels are reached only for CUDA tensors; called directly on
    CPU tensors they refuse before building or launching anything."""
    index = so.SegmentIndex(torch.zeros(1, 4, dtype=torch.int32), 3)
    before = (so.segment_sum.launches, so.segment_gather.launches)
    with pytest.raises(ValueError):
        so.segment_sum(torch.zeros(4, 2), index)
    with pytest.raises(ValueError):
        so.segment_gather(torch.zeros(3, 2), index)
    assert (so.segment_sum.launches, so.segment_gather.launches) == before
