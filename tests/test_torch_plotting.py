"""The port's figure helpers and whole-window resamplers against the JAX
package's: ``tools/plotting`` (``plot_patches``, ``plot_full_patches``,
``plot_mesh``, ``plot_field``, ``assemble_grid``) and ``core/interp``
(``to_grid``, ``resample_sequence``).

Both sides make the same matplotlib calls on the Agg backend in one
process, so each figure is held to JAX's pixel for pixel.  Without
matplotlib (the card's machine) every helper raises ``ImportError`` and
writes nothing."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fluid_llm_tpu.core import interp as jinterp
from fluid_llm_tpu.tools import plotting as jplotting
from fluid_llm_tpu_torch.core import interp
from fluid_llm_tpu_torch.core import triangulation as tri
from fluid_llm_tpu_torch.data.synthetic import analytic_flow, make_cylinder_mesh
from fluid_llm_tpu_torch.tools import plotting

torch.set_num_threads(2)

HELPERS = ["plot_patches", "plot_full_patches", "plot_mesh", "plot_field", "assemble_grid"]


def _args(name: str, tmp_path, rng) -> tuple:
    """``name``'s arguments before the output path, and after it (keywords),
    from the seeded ``rng`` as ``tests/test_tools.py`` draws them."""
    if name in ("plot_patches", "plot_full_patches"):
        return (rng.normal(size=(6, 8, 8)), (3, 2)), {}
    if name == "plot_mesh":
        pos, faces = make_cylinder_mesh(0, 10, 6)
        return (pos, faces, rng.normal(size=len(pos))), {}
    if name == "plot_field":
        return (rng.normal(size=(40, 12)),), {}
    frame = str(tmp_path / "frame.png")  # assemble_grid: prerendered frames, one missing
    jplotting.plot_field(rng.normal(size=(40, 12)), frame)
    paths = [[frame, frame], [frame, str(tmp_path / "missing.png")]]
    return (paths,), dict(row_labels=["a", "b"], col_labels=["t0", "t1"])


@pytest.mark.parametrize("name", HELPERS)
def test_figure_equals_jax_pixel_for_pixel(name, tmp_path, rng):
    args, kw = _args(name, tmp_path, rng)
    want, got = tmp_path / "jax.png", tmp_path / "port.png"
    getattr(jplotting, name)(*args, str(want), **kw)
    getattr(plotting, name)(*args, str(got), **kw)
    want_px, got_px = (np.asarray(Image.open(p)) for p in (want, got))
    assert got_px.shape == want_px.shape and got_px.size > 0
    np.testing.assert_array_equal(got_px, want_px)


@pytest.mark.parametrize("name", HELPERS)
def test_figure_without_matplotlib_raises(name, monkeypatch, tmp_path, rng):
    """Where matplotlib is missing, the helper raises and writes no file."""
    args, kw = _args(name, tmp_path, rng)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "out.png"
    with pytest.raises(ImportError, match="matplotlib"):
        getattr(plotting, name)(*args, str(out), **kw)
    assert not out.exists()


@pytest.fixture(scope="module")
def flow():
    """The cylinder mesh at 64 and a 10-frame window of its analytic flow."""
    pos, faces = make_cylinder_mesh(21234)
    mi = tri.get_mesh_interpolation(pos, faces, 64)
    assert mi.mask.any()
    return mi, analytic_flow(pos, 10, 21234)  # (10, 3, N)


def test_resample_sequence_matches_jax(flow):
    """(10, 3, N) -> (10, 3, H, W) within 1e-6 of JAX's (the three
    barycentric terms may be summed in another order), masked pixels 0."""
    mi, states = flow
    got = interp.resample_sequence(torch.from_numpy(states), torch.from_numpy(mi.vert_idx),
                                   torch.from_numpy(mi.weights), torch.from_numpy(mi.mask))
    want = np.asarray(jinterp.resample_sequence(jnp.asarray(states), jnp.asarray(mi.vert_idx),
                                                jnp.asarray(mi.weights), jnp.asarray(mi.mask)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (10, 3) + mi.mask.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert (got[..., torch.from_numpy(mi.mask)] == 0).all()


@pytest.mark.parametrize("as_tensor", [True, False], ids=["tensor", "numpy"])
def test_to_grid_matches_jax(flow, as_tensor):
    """One (3, N) frame: JAX's data within 1e-6, its mask, f32, masked
    pixels 0, and the frame of ``resample_sequence`` bit for bit."""
    mi, states = flow
    val = torch.from_numpy(states[4]) if as_tensor else states[4]
    data, mask = interp.to_grid(val, mi)
    jdata, jmask = jinterp.to_grid(states[4], mi)
    np.testing.assert_array_equal(mask, np.asarray(jmask))
    assert mask is mi.mask
    assert data.dtype == torch.float32 and tuple(data.shape) == (3,) + mi.mask.shape
    np.testing.assert_allclose(data.numpy(), np.asarray(jdata), atol=1e-6, rtol=0)
    assert (data[:, torch.from_numpy(mask)] == 0).all()
    seq = interp.resample_sequence(torch.from_numpy(states), torch.from_numpy(mi.vert_idx),
                                   torch.from_numpy(mi.weights), torch.from_numpy(mi.mask))
    assert torch.equal(data, seq[4])
