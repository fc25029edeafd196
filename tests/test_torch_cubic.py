"""The port's cubic mesh->grid interpolation (``core/cubic.py``) against the
JAX package's, on the CPU.

The host side (element construction, the ``user``/``geom``/``min_E``
gradient estimators, the per-pixel weights, ``to_grid_cubic`` and
``resample_sequence_cubic``) is the same numpy in both, so it is held
within 1e-12 absolute (f64; the grids come out f32 and are compared
exactly).  Both locate pixels with the NumPy locator: the JAX module's
``locate_triangles`` prefers matplotlib's trifinder, so the test points it
at its ``_locate_numpy`` with monkeypatch.  The torch
``resample_to_grid_cubic`` (a gather and a 9-term FMA) is held to JAX's
einsum at f32 tolerance (rtol 1e-5, atol 1e-6), masked pixels exactly 0,
and in f64 to the host evaluation within 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid_llm_tpu.core import cubic as jcubic
from fluid_llm_tpu.core import triangulation as jtri
from fluid_llm_tpu_torch.core import cubic
from fluid_llm_tpu_torch.core.triangulation import grid_pos
from fluid_llm_tpu_torch.data.synthetic import analytic_flow, make_cylinder_mesh

from test_interp import make_mesh

torch.set_num_threads(2)

ATOL = 1e-12


@pytest.fixture(autouse=True)
def numpy_locator(monkeypatch):
    monkeypatch.setattr(jtri, "locate_triangles", jtri._locate_numpy)


@pytest.fixture(scope="module")
def mesh():
    rng = np.random.default_rng(7)
    pos, faces = make_mesh(rng, nx=9, ny=6)
    z = np.sin(pos[:, 0]) * np.cos(2 * pos[:, 1]) + 0.1 * rng.normal(size=len(pos))
    dz = (np.cos(pos[:, 0]) * np.cos(2 * pos[:, 1]),
          -2 * np.sin(pos[:, 0]) * np.sin(2 * pos[:, 1]))
    gx, gy = grid_pos(float(pos[:, 0].min()), float(pos[:, 0].max()),
                      float(pos[:, 1].min()), float(pos[:, 1].max()), 48)
    return pos, faces, z, dz, gx, gy


@pytest.mark.parametrize("kind", ["user", "geom", "min_E"])
def test_interpolator_matches_jax(mesh, kind):
    pos, faces, z, dz, _, _ = mesh
    kw = {"dz": dz} if kind == "user" else {}
    mine = cubic.CubicTriInterpolator(pos, faces, z, kind=kind, **kw)
    ref = jcubic.CubicTriInterpolator(pos, faces, z, kind=kind, **kw)
    np.testing.assert_allclose(mine.ords, ref.ords, atol=ATOL, rtol=0)
    rng = np.random.default_rng(1)
    tri_idx = rng.integers(0, len(faces), 64)
    w = rng.dirichlet(np.ones(3), 64)
    pts = np.einsum("mk,mkd->md", w, pos[faces[tri_idx]])
    np.testing.assert_allclose(mine.evaluate(tri_idx, pts[:, 0], pts[:, 1]),
                               ref.evaluate(tri_idx, pts[:, 0], pts[:, 1]), atol=ATOL, rtol=0)
    for a, b in zip(cubic.estimate_gradients(pos, faces, z, kind, kw.get("dz")),
                    jcubic.estimate_gradients(pos, faces, z, kind, kw.get("dz"))):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


def test_pixel_weights_match_jax(mesh):
    pos, faces, _, _, gx, gy = mesh
    mine = cubic.get_cubic_mesh_interpolation(pos, faces, gx, gy)
    ref = jcubic.get_cubic_mesh_interpolation(pos, faces, gx, gy)
    np.testing.assert_array_equal(mine.vert_idx, ref.vert_idx)
    np.testing.assert_array_equal(mine.mask, ref.mask)
    for field in ("wf", "wgx", "wgy"):
        np.testing.assert_allclose(getattr(mine, field), getattr(ref, field), atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", ["user", "geom", "min_E"])
def test_to_grid_cubic_matches_jax(mesh, kind):
    pos, faces, z, dz, gx, gy = mesh
    kw = {"dz": dz} if kind == "user" else {}
    data, mask = cubic.to_grid_cubic(z, pos, faces, gx, gy, kind=kind, **kw)
    jdata, jmask = jcubic.to_grid_cubic(z, pos, faces, gx, gy, kind=kind, **kw)
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_allclose(data, jdata, atol=ATOL, rtol=0)
    assert data.dtype == np.float32 and (data[mask] == 0).all()


def test_resample_sequence_cubic_on_the_cylinder_mesh():
    """A 2-frame, 3-channel window of the synthetic flow on the cylinder
    mesh (pixels inside the hole masked)."""
    pos, faces = make_cylinder_mesh(0, 16, 8)
    states = analytic_flow(pos, 2, 0)  # (T, 3, N)
    gx, gy = grid_pos(float(pos[:, 0].min()), float(pos[:, 0].max()),
                      float(pos[:, 1].min()), float(pos[:, 1].max()), 40)
    out, mask = cubic.resample_sequence_cubic(states, pos, faces, gx, gy, kind="geom")
    jout, jmask = jcubic.resample_sequence_cubic(states, pos, faces, gx, gy, kind="geom")
    np.testing.assert_array_equal(mask, jmask)
    assert mask.any() and out.shape == (2, 3) + mask.shape
    np.testing.assert_allclose(out, jout, atol=ATOL, rtol=0)


def test_device_resample_matches_jax(mesh):
    pos, faces, z, _, gx, gy = mesh
    interp = cubic.get_cubic_mesh_interpolation(pos, faces, gx, gy)
    rng = np.random.default_rng(3)
    vals = rng.normal(size=(2, 3, len(pos))).astype(np.float32)
    dx = rng.normal(size=vals.shape).astype(np.float32)
    dy = rng.normal(size=vals.shape).astype(np.float32)
    tables = (interp.vert_idx, interp.wf, interp.wgx, interp.wgy, interp.mask)
    got = cubic.resample_to_grid_cubic(*map(torch.from_numpy, (vals, dx, dy)), *tables)
    want = jcubic.resample_to_grid_cubic(*map(jnp.asarray, (vals, dx, dy)), *tables)
    assert got.dtype == torch.float32 and got.shape == (2, 3) + interp.mask.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert (got[..., torch.from_numpy(interp.mask)] == 0).all()
    # f64 on the tables as tensors: the host evaluation
    gx64, gy64 = cubic.estimate_gradients(pos, faces, z, "min_E")
    got64 = cubic.resample_to_grid_cubic(
        *(torch.from_numpy(np.asarray(a, np.float64)) for a in (z, gx64, gy64)),
        *(torch.from_numpy(np.asarray(t)) for t in tables))
    host = cubic._host_cubic_eval(interp, z, gx64, gy64)
    np.testing.assert_allclose(got64.numpy().astype(np.float32), host, atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        got64.numpy(), np.where(interp.mask, 0.0, np.einsum(
            "hwk,hwk->hw", z[interp.vert_idx], interp.wf) + np.einsum(
            "hwk,hwk->hw", gx64[interp.vert_idx], interp.wgx) + np.einsum(
            "hwk,hwk->hw", gy64[interp.vert_idx], interp.wgy)), atol=ATOL, rtol=0)
