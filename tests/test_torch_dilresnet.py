"""The ported DilResNet, its grid-image data and GATNet against the JAX
package, on the CPU.

- ``GridImageDataset`` windows and masks over the synthetic cylinder
  trajectories (train, with a crop, and test), ``EagleImageDataset`` on
  small ``states.npy`` / ``pixel_type.npy`` files written by the test and
  ``iterate_image_batches``: equal to JAX's, the resampled grids within
  1e-6 (one gather and a 3-term weighted sum in another order);
- DilResNet at a small size (2 blocks of 7 dilated convs at width 8; 16x12
  grid, batch 2, window 3; weights bridged strictly, HWIO -> OIHW) against
  ``dilresnet_apply`` / ``dilresnet_loss``: states, deltas and targets
  within 1e-5 of each tensor's largest entry, the loss within rtol 1e-5,
  each gradient leaf within 1e-4 relative L2 (f32 sums of 72-term convs in
  another order, through 16 convs a step);
- GATNet (the default configuration: 3 layers at width 32, 2 heads) on a
  collated synthetic mesh: the forward within 1e-5 of its largest entry
  and each gradient leaf within 1e-4 relative L2, against ``gatnet_apply``,
  a leaf's norm floored at 1e-3 of the whole gradient's (``att_dst``'s
  gradient is 0 in exact arithmetic: a destination's term is the same on
  all its incoming edges, and the softmax cancels it; what is left is
  rounding); the bridge strict;
- ``baselines_cli --model dilresnet`` for one epoch on ``--device cpu``,
  then ``--epoch 0`` reloading the checkpoint.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid_llm_tpu.data import grid_images as jgi
from fluid_llm_tpu.data.synthetic import SyntheticCylinderDataset as JSyntheticCylinderDataset
from fluid_llm_tpu.models.baselines import dilresnet as jdrn
from fluid_llm_tpu.models.baselines import gatnet as jgat
from fluid_llm_tpu_torch import baselines_cli
from fluid_llm_tpu_torch.data import eagle_mesh as em
from fluid_llm_tpu_torch.data import grid_images as gi
from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset, SyntheticGraphDataset
from fluid_llm_tpu_torch.models.baselines.dilresnet import DilResNet, dilresnet_loss
from fluid_llm_tpu_torch.models.baselines.gatnet import GATNet
from fluid_llm_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# -- grid images ---------------------------------------------------------------------


@pytest.mark.parametrize("mode,crop", [("train", 3), ("test", 0)])
def test_grid_image_windows_match_jax(mode, crop):
    kw = dict(n_trajectories=2, resolution=24, mode=mode, max_steps=120)
    jds = jgi.GridImageDataset(JSyntheticCylinderDataset(**kw), window_length=4, mode=mode,
                               crop=crop)
    ds = gi.GridImageDataset(SyntheticCylinderDataset(**kw), window_length=4, mode=mode,
                             crop=crop)
    jb = list(jgi.iterate_image_batches(jds, 2, shuffle=True, seed=3))
    tb = list(gi.iterate_image_batches(ds, 2, shuffle=True, seed=3))
    assert len(jb) == len(tb) == 1
    (js, jm), (ts, tm) = jb[0], tb[0]
    side = 24 - 2 * crop
    assert ts.shape[:2] == (2, 4) and ts.shape[-1] == 3 and tm.shape == ts.shape[:-1]
    assert side in ts.shape[2:4]
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(ts, js, atol=1e-6, rtol=0)


def test_eagle_image_dataset_matches_jax(tmp_path, rng):
    for i in range(2):
        d = tmp_path / f"traj{i}"
        d.mkdir()
        np.save(d / "states.npy", rng.normal(size=(600, 6, 5, 3)).astype(np.float32))
        np.save(d / "pixel_type.npy", rng.integers(0, 2, size=(6, 5)).astype(bool))
    for mode in ("train", "test"):
        jds = jgi.EagleImageDataset(str(tmp_path), mode=mode, window_length=4)
        ds = gi.EagleImageDataset(str(tmp_path), mode=mode, window_length=4)
        for i in range(2):
            (js, jm), (ts, tm) = jds[i], ds[i]
            np.testing.assert_array_equal(ts, js)
            np.testing.assert_array_equal(tm, jm)
    with pytest.raises(FileNotFoundError):
        gi.EagleImageDataset(str(tmp_path / "traj0" / "none"))


# -- DilResNet -----------------------------------------------------------------------


def _dilresnet(seed=0):
    params = jdrn.dilresnet_init(jax.random.PRNGKey(seed), channels=3, n_block=2, hidden=8)
    model = DilResNet(3, n_block=2, hidden=8)
    model.load_state_dict(from_jax_params(jax.device_get(params)), strict=True)
    return params, model


def test_dilresnet_forward_loss_and_gradient_match_jax(rng):
    params, model = _dilresnet()
    state = rng.normal(size=(2, 3, 16, 12, 3)).astype(np.float32)
    mask = rng.random(size=(2, 3, 16, 12)) < 0.2

    def jloss(p):
        return jdrn.dilresnet_loss(*jdrn.dilresnet_apply(p, jnp.asarray(state),
                                                         jnp.asarray(mask))[1:])

    jout = jax.jit(jdrn.dilresnet_apply)(params, jnp.asarray(state), jnp.asarray(mask))
    jl, jgrad = jax.jit(jax.value_and_grad(jloss))(params)
    out = model.apply(torch.from_numpy(state), torch.from_numpy(mask))
    for got, want in zip(out, jout):
        _close(got.detach().numpy(), np.asarray(want), 1e-5)
    assert torch.equal(out[0][:, 1:][torch.from_numpy(mask[:, 1:])],
                       torch.from_numpy(state[:, 1:][mask[:, 1:]]))  # forced boundary
    loss = dilresnet_loss(*out[1:])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    want = from_jax_params(jax.device_get(jgrad))
    assert set(want) == {n for n, _ in model.named_parameters()}
    for n, p in model.named_parameters():
        assert _rel(p.grad, want[n]) <= 1e-4, n


def test_bridge_loads_dilresnet_init_strictly():
    params, model = _dilresnet(seed=2)
    sd = from_jax_params(jax.device_get(params))
    assert set(sd) == set(model.state_dict())
    w = np.asarray(params["blocks"][1][3]["w"])  # HWIO
    assert sd["blocks.1.3.weight"].shape == (8, 8, 3, 3)
    np.testing.assert_array_equal(sd["blocks.1.3.weight"].numpy(), w.transpose(3, 2, 0, 1))
    assert model.blocks[1][3].dilation == (8, 8) and model.blocks[1][3].padding == (8, 8)


# -- GATNet --------------------------------------------------------------------------


def test_gatnet_forward_and_gradient_match_jax(rng):
    ds = SyntheticGraphDataset(n_trajectories=2, mode="valid", window_length=2)
    samples = [ds[i] for i in range(2)]
    b = em.collate_graphs(samples, max(s.mesh_pos.shape[1] for s in samples),
                          max(s.edges.shape[0] for s in samples))
    edges = b["edges"][:, 0]
    N, Ne = b["mesh_pos"].shape[2], edges.shape[1]
    vert = rng.normal(size=(2, N, 13)).astype(np.float32)
    edge_in = rng.normal(size=(2, Ne, 3)).astype(np.float32)
    params = jgat.gatnet_init(jax.random.PRNGKey(1), 13, 3, 4)
    model = GATNet(13, 3, 4)
    sd = from_jax_params(jax.device_get(params))
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    jin = (jnp.asarray(vert), jnp.asarray(edge_in), jnp.asarray(edges))

    def jloss(p):
        return (jgat.gatnet_apply(p, *jin, 4) ** 2).mean()

    want = jax.jit(functools.partial(jgat.gatnet_apply, out_dim=4))(params, *jin)
    jgrad = from_jax_params(jax.device_get(jax.jit(jax.grad(jloss))(params)))
    got = model(torch.from_numpy(vert), torch.from_numpy(edge_in), torch.from_numpy(edges))
    assert got.shape == (2, N, 4)
    _close(got.detach().numpy(), np.asarray(want), 1e-5)
    (got ** 2).mean().backward()
    floor = 1e-3 * np.sqrt(sum(np.linalg.norm(g) ** 2 for g in jgrad.values()))
    for n, p in model.named_parameters():
        err = np.linalg.norm(p.grad.numpy().astype(np.float64) - jgrad[n].numpy())
        assert err <= 1e-4 * max(np.linalg.norm(jgrad[n]), floor), n


# -- the CLI -------------------------------------------------------------------------


def test_cli_dilresnet_epoch_then_reload(tmp_path):
    common = ["--model", "dilresnet", "--device", "cpu", "--resolution", "24",
              "--horizon_eval", "7", "--save_dir", str(tmp_path), "--n_traj", "2",
              "--batch_size", "2", "--max_steps", "120"]
    first = baselines_cli.main(common + ["--epoch", "1"])
    ckpt = tmp_path / "dilresnet" / "run.pt"
    assert first["checkpoint"] == str(ckpt) and ckpt.exists()
    assert first["train_steps"] == 1 and np.isfinite(first["train_loss"]).all()
    lines = (tmp_path / "dilresnet" / "run_nrmse.csv").read_text().splitlines()
    assert lines[0] == "step,n_rmse" and len(lines) == 1 + 7
    assert list(first["probes"]) == [5] and first["n_test"] == 2
    assert first["n_rmse"][0] == 0.0 and np.isfinite(first["n_rmse"]).all()  # step 0 is given
    again = baselines_cli.main(common + ["--epoch", "0"])
    assert again["train_steps"] == 0
    np.testing.assert_array_equal(again["n_rmse"], first["n_rmse"])
    assert baselines_cli.parse_args(["--model", "dilresnet"]).horizon_eval == 101
