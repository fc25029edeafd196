"""The port's native point locator (``core/_native.py``) against the JAX
package's, on the CPU.

Both compile the same ``meshcore.cpp`` with the same g++ flags (the port's
copy is ``fluid_llm_tpu_torch/csrc/meshcore.cpp``), so their triangle
indices are held equal bit for bit.  Against the port's NumPy locator the
two may differ only where a pixel lies on a triangle edge, so that
comparison runs on jittered meshes with every pixel at least 1e-6 (in
barycentric terms) inside its triangle's edges, outer boundary aside, and
is exact too.  ``FLUID_LLM_TPU_NATIVE_LOCATOR=1`` (the JAX package's
switch) must give the same ``MeshInterp`` bit for bit; an asked-for native
locator whose build fails raises.
"""

import shutil

import numpy as np
import pytest

from fluid_llm_tpu.core import _native as jnative
from fluid_llm_tpu_torch.core import _native
from fluid_llm_tpu_torch.core import triangulation as tri
from fluid_llm_tpu_torch.data.synthetic import make_cylinder_mesh

from test_interp import make_mesh

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is not installed")

MESHES = [("jittered 14x9 at 120", 14, 9, 120, 11), ("jittered 30x12 at 238", 30, 12, 238, 3)]


def _interior_margin(pos, faces, gx, gy, found) -> float:
    """The least barycentric coordinate of each located pixel in its
    triangle, over pixels off the mesh's outer boundary."""
    v = faces[found[found >= 0]]
    px = gx[found >= 0].astype(np.float64)
    py = gy[found >= 0].astype(np.float64)
    a, b, c = pos[v[:, 0]], pos[v[:, 1]], pos[v[:, 2]]
    d = (b[:, 1] - c[:, 1]) * (a[:, 0] - c[:, 0]) + (c[:, 0] - b[:, 0]) * (a[:, 1] - c[:, 1])
    w0 = ((b[:, 1] - c[:, 1]) * (px - c[:, 0]) + (c[:, 0] - b[:, 0]) * (py - c[:, 1])) / d
    w1 = ((c[:, 1] - a[:, 1]) * (px - c[:, 0]) + (a[:, 0] - c[:, 0]) * (py - c[:, 1])) / d
    w = np.stack([w0, w1, 1 - w0 - w1], 1)
    lo, hi = pos.min(0), pos.max(0)
    inner = (px > lo[0]) & (px < hi[0]) & (py > lo[1]) & (py < hi[1])
    return float(w[inner].min())


@pytest.mark.parametrize("name,nx,ny,res,seed", MESHES, ids=[m[0] for m in MESHES])
def test_native_equals_jax_native_and_numpy(name, nx, ny, res, seed):
    pos, faces = make_mesh(np.random.default_rng(seed), nx=nx, ny=ny)
    gx, gy = tri.grid_pos(*map(float, (pos[:, 0].min(), pos[:, 0].max(), pos[:, 1].min(),
                                       pos[:, 1].max())), res)
    ours = _native.locate(pos, faces, gx, gy)
    assert ours.dtype == np.int32 and ours.shape == gx.shape
    np.testing.assert_array_equal(ours, jnative.locate(pos, faces, gx, gy))
    np.testing.assert_array_equal(_native.locate(pos, faces, gx, gy, n_threads=1), ours)
    assert _interior_margin(pos, faces, gx, gy, ours) > 1e-6  # no pixel on an inner edge
    np.testing.assert_array_equal(ours, tri._locate_numpy(pos, faces, gx, gy))
    assert (ours >= 0).mean() > 0.9


def test_native_on_the_cylinder_mesh():
    """The synthetic cylinder mesh (a hole in it) at 238, against JAX's
    native locator bit for bit; inside the hole both give -1."""
    pos, faces = make_cylinder_mesh(0, 24, 10)
    interp = tri.get_mesh_interpolation(pos, faces, 238)
    ours = _native.locate(pos, faces, interp.grid_x, interp.grid_y)
    np.testing.assert_array_equal(ours, jnative.locate(pos, faces, interp.grid_x,
                                                       interp.grid_y))
    agree = (ours == interp.tri_index).mean()
    assert agree > 0.999 and (ours == -1).sum() > 0


def test_switch_gives_the_same_mesh_interp(monkeypatch):
    pos, faces = make_mesh(np.random.default_rng(11), nx=14, ny=9)
    monkeypatch.delenv("FLUID_LLM_TPU_NATIVE_LOCATOR", raising=False)
    plain = tri.get_mesh_interpolation(pos, faces, 120)
    monkeypatch.setenv("FLUID_LLM_TPU_NATIVE_LOCATOR", "1")
    calls = []
    real = _native.locate
    monkeypatch.setattr(_native, "locate", lambda *a: calls.append(1) or real(*a))
    native = tri.get_mesh_interpolation(pos, faces, 120)
    assert calls == [1]
    for field in ("vert_idx", "weights", "mask", "grid_x", "grid_y", "tri_index"):
        np.testing.assert_array_equal(getattr(native, field), getattr(plain, field))


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that is not there: the build raises, and so does the
    asked-for native locator (no slide to the numpy one)."""
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    pos, faces = make_mesh(np.random.default_rng(0), nx=5, ny=4)
    gx, gy = tri.grid_pos(0.0, 2.0, 0.0, 1.0, 20)
    with pytest.raises(RuntimeError, match="cannot run"):
        _native.locate(pos, faces, gx, gy)
    monkeypatch.setenv("FLUID_LLM_TPU_NATIVE_LOCATOR", "1")
    with pytest.raises(RuntimeError, match="native locator"):
        tri.locate_triangles(pos, faces, gx, gy)
    monkeypatch.setenv("CXX", "g++")
    monkeypatch.setattr(_native, "CXXFLAGS", _native.CXXFLAGS + ("--no-such-flag",))
    with pytest.raises(RuntimeError, match="failed"):
        _native.build()
