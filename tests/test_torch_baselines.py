"""The ported graph baselines (MeshGraphNet, GAT, ``baselines_cli``)
against the JAX package, on the CPU.

- data: ``faces_to_edges``, ``SyntheticGraphDataset``, ``reorder_sample``,
  ``collate_graphs`` and ``iterate_graph_batches`` give equal arrays;
- the running-stat normalizer over several updates, across its 1e7 cap;
- MGN and GAT at a small size (mesh 24x10, batch 2, window 3, 2-3 blocks;
  weights bridged by ``weights.from_jax_params`` / ``from_jax_norm``): the
  forward with ``train=True`` and the noise off (the two frameworks'
  random streams differ), the MGN loss and every gradient against
  ``jax.value_and_grad``, and two ``baselines_cli`` train steps against the
  JAX CLI's ``make_graph_step`` with optax's Adam;
- ``get_nrmse``; the bridge loading both inits strictly; one epoch of
  ``baselines_cli --device cpu`` writing its checkpoint and CSV, and
  ``--epoch 0`` reloading it.

The JAX segment ops take their XLA path on the CPU (as in
``tests/test_baselines.py``), the port its plain twins.  Tolerances: rtol
1e-5 on the loss; 1e-4 relative to each tensor's largest entry on outputs,
normalizer states and gradients (sums over nodes and edges in another
order, through 2-3 blocks and LayerNorms); parameters after two Adam steps
within 1e-4 (each step moves a parameter by at most ~lr = 1e-4).  The
forward runs in f32.  Gradients and the Adam steps run in f64 on both
sides: in f32 a ReLU pre-activation within rounding of 0 (one at 1.4e-8
at this size) takes the other branch in one framework and moves one row
of a weight gradient by ~3e-3 of its largest entry, and Adam moves every
parameter by about lr whatever its gradient's size, so a tiny gradient
entry whose sign differs moves a parameter by 2 lr.
"""

import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fluid_llm_tpu import baselines_cli as jcli
from fluid_llm_tpu.data import eagle_mesh as jem
from fluid_llm_tpu.data.reorder import reorder_sample as jreorder_sample
from fluid_llm_tpu.data.synthetic import SyntheticGraphDataset as JSyntheticGraphDataset
from fluid_llm_tpu.models.baselines import base as jbase
from fluid_llm_tpu.models.baselines.gat import gat_apply, gat_init
from fluid_llm_tpu.models.baselines.mgn import mgn_apply, mgn_init, mgn_loss as jmgn_loss
from fluid_llm_tpu.train.eagle_eval import get_nrmse as jget_nrmse
from fluid_llm_tpu_torch import baselines_cli
from fluid_llm_tpu_torch.data import eagle_mesh as em
from fluid_llm_tpu_torch.data.reorder import reorder_sample
from fluid_llm_tpu_torch.data.synthetic import SyntheticGraphDataset
from fluid_llm_tpu_torch.models.baselines import base
from fluid_llm_tpu_torch.models.baselines.gat import GAT
from fluid_llm_tpu_torch.models.baselines.mgn import MGN, mgn_loss
from fluid_llm_tpu_torch.train.eagle_eval import get_nrmse
from fluid_llm_tpu_torch.weights import from_jax_norm, from_jax_params

torch.set_num_threads(2)

ARRAYS = ("mesh_pos", "edges", "state", "node_type", "mask", "cluster", "cluster_mask")


def _close(got, want, tol=1e-4):
    """Within ``tol`` relative to the largest entry of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


def _samples(mode="valid", window=3, n=2, reorder=True):
    jds = JSyntheticGraphDataset(n_trajectories=n, mode=mode, window_length=window)
    ds = SyntheticGraphDataset(n_trajectories=n, mode=mode, window_length=window)
    js, ts = [jds[i] for i in range(n)], [ds[i] for i in range(n)]
    if reorder:
        js, ts = [jreorder_sample(s, "rcm") for s in js], [reorder_sample(s, "rcm") for s in ts]
    return js, ts


@pytest.fixture(scope="module")
def batch():
    """One collated batch (numpy), the same in both packages."""
    _, ts = _samples()
    n = max(s.mesh_pos.shape[1] for s in ts)
    e = max(s.edges.shape[0] for s in ts)
    return em.collate_graphs(ts, n, e, 1, ghost_type_value=1)


# -- data ----------------------------------------------------------------------


def test_faces_to_edges_matches_jax(rng):
    faces = rng.integers(0, 60, size=(90, 3))
    np.testing.assert_array_equal(em.faces_to_edges(faces), jem.faces_to_edges(faces))


@pytest.mark.parametrize("mode", ["train", "valid", "test"])
def test_synthetic_graph_dataset_matches_jax(mode):
    js, ts = _samples(mode=mode, window=4, n=3, reorder=False)
    for j, t in zip(js, ts):
        for f in ("mesh_pos", "edges", "state", "node_type", "faces"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
        assert t.cluster is None and j.cluster is None


def test_reorder_sample_matches_jax():
    js, ts = _samples(reorder=True)
    for j, t in zip(js, ts):
        for f in ("mesh_pos", "edges", "state", "node_type", "faces"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)


def test_collate_matches_jax():
    js, ts = _samples(window=3, n=2)
    n = max(s.mesh_pos.shape[1] for s in ts)
    e = max(s.edges.shape[0] for s in ts)
    got = em.collate_graphs(ts, n, e, 1, ghost_type_value=1)
    want = jem.collate_graphs(js, n, e, 1, ghost_type_value=1)
    assert set(got) == set(ARRAYS)
    assert got["edges"].shape[2] % 256 == 0 and got["mesh_pos"].shape[2] == n + 1
    for k in ARRAYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_iterate_graph_batches_matches_jax():
    jds = JSyntheticGraphDataset(n_trajectories=3, mode="train", window_length=3)
    ds = SyntheticGraphDataset(n_trajectories=3, mode="train", window_length=3)
    jb = list(jem.iterate_graph_batches(jds, 2, shuffle=True, seed=5, reorder="rcm"))
    tb = list(em.iterate_graph_batches(ds, 2, shuffle=True, seed=5, reorder="rcm"))
    assert len(tb) == len(jb) == 2
    for t, j in zip(tb, jb):
        for k in ARRAYS:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


# -- normalizer ------------------------------------------------------------------


def test_normalizer_matches_jax_across_the_cap(rng):
    """Five updates from a count just below 1e7: two below the cap, then
    the stored mean/std freeze while ``acc`` stops growing."""
    jstate = jbase.normalizer_init(3)
    jstate["count"] = jnp.float32(1e7 - 5)
    tstate = from_jax_norm({"n": jstate})["n"]
    for i in range(5):
        x = rng.normal(size=(2, 5, 3)).astype(np.float32) * (i + 1) + i
        jout, jstate = jbase.normalizer_apply(jstate, jnp.asarray(x), update=True)
        tout, tstate = base.normalizer_apply(tstate, torch.from_numpy(x), update=True)
        _close(tout, jout, 1e-5)
        for k in jstate:
            _close(tstate[k], jstate[k], 1e-5)
    assert float(tstate["count"]) == float(jstate["count"]) == 1e7 + 1
    x = rng.normal(size=(4, 3)).astype(np.float32)
    _close(base.normalizer_apply(tstate, torch.from_numpy(x), update=False)[0],
           jbase.normalizer_apply(jstate, jnp.asarray(x), update=False)[0], 1e-5)
    _close(base.normalizer_inverse(tstate, torch.from_numpy(x)),
           jbase.normalizer_inverse(jstate, jnp.asarray(x)), 1e-5)


# -- models ----------------------------------------------------------------------


def _bridged(kind: str, n_processor: int):
    if kind == "mgn":
        params, norm = mgn_init(jax.random.PRNGKey(0), 4, n_processor)
        model = MGN(4, n_processor)
    else:
        params, norm = gat_init(jax.random.PRNGKey(0), 4, n_processor, 4)
        model = GAT(4, n_processor, 4)
    model.load_state_dict(from_jax_params(jax.device_get(params)))
    return params, norm, model


def _inputs(b, torch_side: bool):
    keys = ("mesh_pos", "edges", "state", "node_type")
    if torch_side:
        return [torch.from_numpy(b[k]) for k in keys]
    return [jnp.asarray(b[k]) for k in keys]


@pytest.mark.parametrize("kind,n_processor", [("mgn", 3), ("gat", 2)])
def test_forward_matches_jax(batch, kind, n_processor):
    params, norm, model = _bridged(kind, n_processor)
    japply = mgn_apply if kind == "mgn" else gat_apply
    jout = jax.jit(functools.partial(japply, train=True))(params, norm, *_inputs(batch, False))
    with torch.no_grad():
        tout = model.apply(from_jax_norm(norm), *_inputs(batch, True), train=True)
    for got, want in zip(tout[:3], jout[:3]):
        _close(got, want)
    for name in ("nodes", "edges", "output"):
        for k in jbase.normalizer_init(1):
            _close(tout[3][name][k], jout[3][name][k])
    assert tout[0].shape == batch["state"].shape


def _f64(tree):
    """Floating leaves (numpy, JAX arrays or tensors) as float64."""
    def cast(a):
        if isinstance(a, torch.Tensor):
            return a.double() if a.is_floating_point() else a
        a = np.asarray(a)
        return a.astype(np.float64) if np.issubdtype(a.dtype, np.floating) else a
    return jax.tree_util.tree_map(cast, tree)


def test_mgn_loss_and_gradients_match_jax(batch):
    params, norm, model = _bridged("mgn", 3)
    b64 = _f64(dict(batch))
    with jax.enable_x64(True):
        @jax.jit
        def jloss(p):
            _, oh, tgt, _ = mgn_apply(p, _f64(norm), *_inputs(b64, False), train=True)
            return jmgn_loss(oh, tgt, jnp.asarray(b64["mask"]))

        jl, jg = jax.value_and_grad(jloss)(_f64(params))
        jl, jg = float(jl), jax.device_get(jg)
    model.double()
    _, oh, tgt, _ = model.apply(_f64(from_jax_norm(norm)), *_inputs(b64, True), train=True)
    loss = mgn_loss(oh, tgt, torch.from_numpy(b64["mask"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), jl, rtol=1e-5)
    want = from_jax_params(jg)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for n in want:
        _close(got[n], want[n])


def _cli_args(**kw):
    args = argparse.Namespace(model="mgn", dtype="f32", noise_std=0.0, w_pressure=0.1,
                              lr=1e-4, n_processor=2, n_heads=4)
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def test_two_cli_train_steps_match_jax_make_graph_step(batch):
    """``baselines_cli.train_step`` (Adam in torch) against the JAX CLI's
    ``make_graph_step`` (optax ``scale_by_adam``, lr outside) from the same
    bridged weights, on the same batch twice (f64): the parameters after
    each step, the losses and the normalizer state."""
    args = _cli_args()
    params, norm = mgn_init(jax.random.PRNGKey(0), 4, args.n_processor)
    model = MGN(4, args.n_processor)
    model.load_state_dict(from_jax_params(jax.device_get(params)))
    model.double()
    tnorm = _f64(from_jax_norm(norm))
    b64 = _f64(dict(batch))
    opt = baselines_cli.make_optimizer(model, args.lr)
    tb = baselines_cli.to_device(b64, torch.device("cpu"))
    with jax.enable_x64(True):
        step = jcli.make_graph_step(
            args, mgn_apply, functools.partial(jmgn_loss, w_pressure=args.w_pressure), True)
        params, norm = _f64(params), _f64(norm)
        opt_state = optax.scale_by_adam().init(params)
        for _ in range(2):
            jb = {k: jnp.asarray(v) for k, v in b64.items()}
            params, norm, opt_state, jl = step(params, norm, opt_state, jb,
                                               jax.random.PRNGKey(3), jnp.float64(args.lr))
            tnorm, tl = baselines_cli.train_step(args, model, tnorm, opt, tb, args.lr, None)
            np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
            want = from_jax_params(jax.device_get(params))
            for n, p in model.state_dict().items():
                np.testing.assert_allclose(p.numpy(), want[n], atol=1e-4, rtol=0, err_msg=n)
            for name in ("nodes", "edges", "output"):
                for k in norm[name]:
                    _close(tnorm[name][k], jax.device_get(norm[name][k]))


def test_get_nrmse_matches_jax(rng):
    ds = SyntheticGraphDataset(n_trajectories=1, mode="test", window_length=4)
    s = ds[0]
    true = s.state[None]
    pred = true + rng.normal(size=true.shape).astype(np.float32) * 0.05
    got = get_nrmse(true, pred, s.mesh_pos[0], s.faces, resolution=48)
    want = jget_nrmse(true, pred, s.mesh_pos[0], s.faces, resolution=48)
    assert got.shape == (1, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(get_nrmse(true, true, s.mesh_pos[0], s.faces, resolution=48),
                               0.0, atol=1e-7)


@pytest.mark.parametrize("kind", ["mgn", "gat"])
def test_bridge_loads_jax_inits_strictly(kind):
    if kind == "mgn":
        params, norm = mgn_init(jax.random.PRNGKey(2), 4, 3)
        model = MGN(4, 3)
    else:
        params, norm = gat_init(jax.random.PRNGKey(2), 4, 3, 4)
        model = GAT(4, 3, 4)
    sd = from_jax_params(jax.device_get(params))
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    loaded = base.load_norm(model.init_norm(), from_jax_norm(jax.device_get(norm)))
    np.testing.assert_array_equal(loaded["output"]["std"], np.ones(4, np.float32))
    bad = from_jax_norm(jax.device_get(norm))
    bad["edges"]["mean"] = torch.zeros(4)
    with pytest.raises(ValueError):
        base.load_norm(model.init_norm(), bad)
    if kind == "gat":  # the heads' bias-free f_edge
        assert "processor.0.heads.3.f_edge.bias" not in sd
        w = np.asarray(params["processor"][0]["heads"][3]["f_edge"]["w"])
        np.testing.assert_array_equal(sd["processor.0.heads.3.f_edge.weight"].numpy(), w.T)


def test_cli_epoch_then_reload(tmp_path):
    common = ["--model", "mgn", "--device", "cpu", "--n_processor", "2", "--horizon_eval", "6",
              "--resolution", "48", "--save_dir", str(tmp_path), "--n_traj", "2",
              "--batch_size", "2"]
    first = baselines_cli.main(common + ["--epoch", "1"])
    ckpt = tmp_path / "mgn" / "run.pt"
    csv_path = tmp_path / "mgn" / "run_nrmse.csv"
    assert first["checkpoint"] == str(ckpt) and ckpt.exists() and csv_path.exists()
    assert first["train_steps"] == 1 and np.isfinite(first["val_loss"]).all()
    lines = csv_path.read_text().splitlines()
    assert lines[0] == "step,n_rmse" and len(lines) == 1 + 6
    again = baselines_cli.main(common + ["--epoch", "0", "--prefetch", "0"])
    assert again["train_steps"] == 0
    np.testing.assert_array_equal(again["n_rmse"], first["n_rmse"])
    assert np.isfinite(first["n_rmse"]).all() and first["eval_steps"] == 2 * 5
