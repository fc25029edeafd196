"""The port's host data path against the JAX package's: point location,
resampling, patch samples, patch algebra and the N-RMSE metric."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid_llm_tpu.core import triangulation as jtri
from fluid_llm_tpu.data import pipeline as jpipe
from fluid_llm_tpu.data.ds_props import DSProps as JDSProps
from fluid_llm_tpu.data.synthetic import make_cylinder_mesh as jmesh
from fluid_llm_tpu.ops import patching as jpatch
from fluid_llm_tpu.train.metrics import calc_n_rmse as jcalc_n_rmse
from fluid_llm_tpu_torch.core import triangulation as tri
from fluid_llm_tpu_torch.data import pipeline as pipe
from fluid_llm_tpu_torch.data.ds_props import DSProps
from fluid_llm_tpu_torch.data.synthetic import analytic_flow, make_cylinder_mesh
from fluid_llm_tpu_torch.ops import patching
from fluid_llm_tpu_torch.train.metrics import calc_n_rmse

torch.set_num_threads(2)

GEOM = dict(Nx_patch=3, Ny_patch=2, patch_size=(4, 5), seq_len=2)


@pytest.mark.parametrize("res", [64, 238])
def test_locate_numpy_equals_jax(res):
    """Same mesh generator, same grid, same locator: exactly equal."""
    pos, faces = make_cylinder_mesh(11234)
    jpos, jfaces = jmesh(11234)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(faces, jfaces)
    lo, hi = pos.min(0), pos.max(0)
    gx, gy = tri.grid_pos(float(lo[0]), float(hi[0]), float(lo[1]), float(hi[1]), res)
    np.testing.assert_array_equal(
        tri._locate_numpy(pos, faces, gx, gy), jtri._locate_numpy(pos, faces, gx, gy)
    )


class _OneTrajectory:
    """Mixin: a dataset of one trajectory from a given MeshInterp."""

    def __init__(self, src, **kw):
        super().__init__(**kw)
        self._src = src

    def num_trajectories(self):
        return 1

    def get_trajectory(self, idx):
        return self._src


class _JaxDS(_OneTrajectory, jpipe.PatchDataset):
    pass


class _TorchDS(_OneTrajectory, pipe.PatchDataset):
    pass


def test_patch_sample_from_same_mesh_interp_matches():
    """A PatchDataset sample from one MeshInterp: identical on both sides
    (atol 1e-6: the 3-term barycentric sum may associate differently)."""
    pos, faces = make_cylinder_mesh(21234)
    interp = tri.get_mesh_interpolation(pos, faces, 64)
    states = analytic_flow(pos, 140, 21234)
    kw = dict(resolution=64, patch_size=(16, 16), seq_len=6, mode="test",
              means=(0.8, 0.0, 0.05), stds=(0.275, 0.275, 0.275))
    jsrc = jpipe.TrajectorySource(interp.vert_idx, interp.weights, interp.mask, states)
    tsrc = pipe.TrajectorySource(interp.vert_idx, interp.weights, interp.mask, states)
    want = _JaxDS(jsrc, **kw)[0]
    got = _TorchDS(tsrc, **kw)[0]
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_patching_round_trip_matches_jax(rng):
    props, jprops = DSProps(**GEOM), JDSProps(**GEOM)
    img = rng.normal(size=(2, 3, 3, 12, 10)).astype(np.float32)
    patches = patching.img_to_patch(torch.from_numpy(img), props)
    np.testing.assert_array_equal(patches.numpy(),
                                  np.asarray(jpatch.img_to_patch(jnp.asarray(img), jprops)))
    np.testing.assert_array_equal(patching.patch_to_img(patches, props).numpy(), img)
    feats = rng.normal(size=(2, 6, 4 * 5 * 7)).astype(np.float32)
    np.testing.assert_array_equal(
        patching.fold_features(torch.from_numpy(feats), props, 7).numpy(),
        np.asarray(jpatch.fold_features(jnp.asarray(feats), jprops, 7)),
    )


def test_calc_n_rmse_matches_jax(rng):
    preds, target = (rng.normal(size=(2, 4, 3, 12, 10)).astype(np.float32) for _ in range(2))
    mask = rng.uniform(size=(2, 4, 3, 12, 10)) < 0.2
    got = calc_n_rmse(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(mask))
    want = jcalc_n_rmse(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_position_ids_match_jax():
    np.testing.assert_array_equal(pipe.position_ids(4, 15, 4).numpy(),
                                  jpipe.position_ids(4, 15, 4))
