"""The ported GraphViT, its cluster tables and ``--dtype bf16`` against the
JAX package, on the CPU.

- ``tools/clusterize``: the same constrained k-means tables from the same
  seed; ``SyntheticGraphDataset(n_cluster > 0)`` equal to JAX's;
- GRU and multi-head attention within 1e-5 (f32);
- GraphViT (mesh 24x10, batch 2, window 3, ``w_size`` 32, 2 GNN blocks, 2
  attention blocks, clusters of 10; weights bridged strictly by
  ``weights.from_jax_params``) against ``graphvit_apply`` / ``graphvit_loss``
  in f32 on the JAX f32 path (``cluster_window`` 0: ghost member slots read
  the ghost node's row and the scatter sets): states, outputs and targets
  on the real rows within 1e-5 of each tensor's largest entry (the two
  paths differ on the ghost node's row only, which the loss masks), the
  loss within rtol 1e-5, every gradient leaf within 1e-4 relative L2
  (observed 9e-6: sums over nodes, edges and members in another order
  through LayerNorms and a GRU);
- one ``--dtype bf16`` train step of MeshGraphNet and of GraphViT against
  the JAX CLI's ``make_graph_step`` under ``--dtype bf16`` (cluster-major
  node order, ``cluster_window`` set as the JAX CLI does): the loss within
  rtol 2e-2; the whole gradient within 5e-2 relative L2 of JAX's through
  the same cast, and each leaf within twice the distance of JAX's own bf16
  gradient from its f32 one (bf16 keeps 8 significant bits, 2^-8 ~ 4e-3 a
  rounding, and the two frameworks round at other places: the JAX CPU path
  adds the segment sums in bf16, the port in f32; observed: MeshGraphNet's
  worst leaf 5.7e-2 against JAX's own 6.1e-2, the whole gradient 2.8e-2);
  after the Adam step every parameter within 2 lr of JAX's and at least 90
  % of them within lr / 2 (the first Adam step moves an entry by about lr
  times the sign of its gradient, so only entries whose gradient is within
  rounding of 0 -- the attention's key bias, for one -- take the other
  sign);
- the bf16 twins' rounding (f32 sums in ascending edge order, one cast)
  against the JAX package's segment kernels on bf16 values in interpret
  mode (one MXU pass with f32 accumulation, one cast): equal bit for bit;
  against its XLA path (bf16 adds) within the bf16 rounding of each add
  (2^-8 of the row's sum of magnitudes an add), the twin within one;
  the bf16 gather equal bit for bit;
- ``baselines_cli --model graphvit`` and ``--dtype bf16`` (MeshGraphNet,
  GAT, GraphViT) for one epoch on ``--device cpu``, then ``--epoch 0``
  reloading the checkpoint.
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
from fluid_llm_tpu.data.synthetic import SyntheticGraphDataset as JSyntheticGraphDataset
from fluid_llm_tpu.models.baselines import graphvit as jg
from fluid_llm_tpu.models.baselines.mgn import mgn_apply, mgn_init, mgn_loss as jmgn_loss
from fluid_llm_tpu.ops import segment_ops as jso
from fluid_llm_tpu.tools import clusterize as jclusterize
from fluid_llm_tpu_torch import baselines_cli
from fluid_llm_tpu_torch.data import eagle_mesh as em
from fluid_llm_tpu_torch.data.reorder import reorder_sample
from fluid_llm_tpu_torch.data.synthetic import SyntheticGraphDataset, make_cylinder_mesh
from fluid_llm_tpu_torch.models.baselines.graphvit import (
    GRU,
    GraphViT,
    MultiheadAttention,
    graphvit_loss,
    member_index,
)
from fluid_llm_tpu_torch.models.baselines.mgn import MGN
from fluid_llm_tpu_torch.ops import segment_ops as so
from fluid_llm_tpu_torch.tools import clusterize
from fluid_llm_tpu_torch.weights import from_jax_norm, from_jax_params

torch.set_num_threads(2)

W_SIZE, N_ATT, N_GN, HEADS = 32, 2, 2, 4
KEYS = ("mesh_pos", "edges", "state", "node_type", "cluster", "cluster_mask")


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _batch(order: str, mode="valid", n=2, window=3):
    ds = SyntheticGraphDataset(n_trajectories=n, mode=mode, window_length=window, n_cluster=10)
    samples = [reorder_sample(ds[i], order) for i in range(n)]
    return em.collate_graphs(samples, max(s.mesh_pos.shape[1] for s in samples),
                             max(s.edges.shape[0] for s in samples),
                             max(s.cluster.shape[1] for s in samples), ghost_type_value=2)


@pytest.fixture(scope="module")
def batch():
    return _batch("rcm")


def _bridged(seed=0):
    params = jg.graphvit_init(jax.random.PRNGKey(seed), 4, W_SIZE, N_ATT, N_GN, HEADS)
    model = GraphViT(4, W_SIZE, N_ATT, N_GN, HEADS)
    model.load_state_dict(from_jax_params(jax.device_get(params)), strict=True)
    return params, model


# -- cluster tables ------------------------------------------------------------------


@pytest.mark.parametrize("nodes,size", [((24, 10), 10), ((40, 16), 7)])
def test_constrained_kmeans_matches_jax(nodes, size):
    pos, _ = make_cylinder_mesh(5, *nodes)
    got = clusterize.constrained_kmeans(pos, size, seed=11)
    np.testing.assert_array_equal(got, jclusterize.constrained_kmeans(pos, size, seed=11))
    members = got[got >= 0]
    assert got.shape[1] == size and np.array_equal(np.sort(members), np.arange(len(pos)))


def test_clusterize_pkl_dir_writes_the_jax_tables(tmp_path):
    """The CLI's pickle walk writes the tables the JAX one writes."""
    import pickle

    pos, _ = make_cylinder_mesh(3, 12, 6)
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
        with open(tmp_path / d / "traj0.pkl", "wb") as f:
            pickle.dump({"mesh_pos": pos}, f)
    got = clusterize.clusterize_pkl_dir(str(tmp_path / "a"), 6)
    want = jclusterize.clusterize_pkl_dir(str(tmp_path / "b"), 6)
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want] \
        == ["constrained_kmeans_6_traj0.npy"]
    np.testing.assert_array_equal(np.load(got[0]), np.load(want[0]))


@pytest.mark.parametrize("mode", ["train", "test"])
def test_synthetic_graph_dataset_clusters_match_jax(mode):
    jds = JSyntheticGraphDataset(n_trajectories=2, mode=mode, window_length=3, n_cluster=10)
    ds = SyntheticGraphDataset(n_trajectories=2, mode=mode, window_length=3, n_cluster=10)
    for i in range(2):
        j, t = jds[i], ds[i]
        for f in ("mesh_pos", "edges", "state", "node_type", "faces", "cluster"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
        assert t.cluster.shape[0] == 3 and t.cluster.shape[2] == 10


# -- pieces --------------------------------------------------------------------------


def test_gru_matches_jax(rng):
    p = jg.gru_init(jax.random.PRNGKey(4), 12, 16)
    gru = GRU(12, 16)
    gru.load_state_dict(from_jax_params(jax.device_get(p)), strict=True)
    x = rng.normal(size=(5, 7, 12)).astype(np.float32)
    want = jax.jit(functools.partial(jg.gru_scan, hidden_size=16))(p, jnp.asarray(x))
    with torch.no_grad():
        got = gru(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_mha_matches_jax(rng):
    p = jg.mha_init(jax.random.PRNGKey(6), 32)
    mha = MultiheadAttention(32)
    mha.load_state_dict(from_jax_params(jax.device_get(p)), strict=True)
    x = rng.normal(size=(2, 9, 32)).astype(np.float32)
    ghost = np.zeros((2, 9), bool)
    ghost[1, 6:] = True
    mask = ghost[:, None, :] & ~np.eye(9, dtype=bool)[None]
    want = jax.jit(functools.partial(jg.mha_apply, n_heads=4))(p, jnp.asarray(x),
                                                               jnp.asarray(mask))
    with torch.no_grad():
        got = mha(torch.from_numpy(x), torch.from_numpy(mask), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_member_index_drops_ghost_slots():
    cluster = torch.tensor([[[0, 2, 5], [1, 5, 5]]])
    mask = torch.tensor([[[1.0, 1.0, 0.0], [1.0, 0.0, 0.0]]])
    index = member_index(cluster, mask, 5)
    assert index.ids.tolist() == [0, 2, -1, 1, -1, -1]
    V = torch.arange(10.0).reshape(1, 5, 2)
    assert so.gather_nodes(V, index)[0, 2].tolist() == [0.0, 0.0]


# -- the model -----------------------------------------------------------------------


def test_forward_loss_and_gradient_match_jax_f32_path(batch):
    params, model = _bridged()
    jin = [jnp.asarray(batch[k]) for k in KEYS]
    tin = [torch.from_numpy(batch[k]) for k in KEYS]
    jmask = jnp.asarray(batch["mask"])

    def jloss(p):
        _, oh, tgt = jg.graphvit_apply(p, *jin, n_heads=HEADS)
        return jg.graphvit_loss(oh, tgt, jmask, alpha=0.3)

    jout = jax.jit(functools.partial(jg.graphvit_apply, n_heads=HEADS))(params, *jin)
    jl, jgrad = jax.jit(jax.value_and_grad(jloss))(params)
    state_hat, out_hat, target = model.apply(*tin)
    real = batch["mask"][:, :, :, None] > 0
    for got, want, rows in ((state_hat, jout[0], real), (out_hat, jout[1], real[:, 1:]),
                            (target, jout[2], real[:, 1:])):
        assert got.shape == want.shape
        _close(np.where(rows, got.detach().numpy(), 0), np.where(rows, np.asarray(want), 0), 1e-5)
    loss = graphvit_loss(out_hat, target, torch.from_numpy(batch["mask"]), alpha=0.3)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    want = from_jax_params(jax.device_get(jgrad))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for n in want:
        assert _rel(got[n], want[n]) <= 1e-4, n


def test_window_builds_one_member_index_for_a_broadcast_table(batch, monkeypatch):
    """A cluster table broadcast over the window (as ``baselines_cli.
    to_device`` sends one) gives one member index for every step, with the
    same rollout."""
    from fluid_llm_tpu_torch.models.baselines import graphvit

    _, model = _bridged()
    built = []
    real = graphvit.member_index
    monkeypatch.setattr(graphvit, "member_index", lambda *a: built.append(1) or real(*a))
    tb = baselines_cli.to_device(batch, torch.device("cpu"))
    assert tb["cluster"].stride(1) == 0 and tb["cluster_mask"].stride(1) == 0
    with torch.no_grad():
        once = model.apply(*(tb[k] for k in KEYS))
        assert len(built) == 1
        each = model.apply(*(torch.from_numpy(batch[k]) for k in KEYS))
        assert len(built) == 1 + batch["state"].shape[1] - 1
    for a, b in zip(once, each):
        assert torch.equal(a, b)


def test_bridge_loads_graphvit_init_strictly():
    params, model = _bridged(seed=3)
    sd = from_jax_params(jax.device_get(params))
    assert set(sd) == set(model.state_dict())
    gru = params["pool_gru"]
    np.testing.assert_array_equal(sd["pool_gru.w_ih"].numpy(), np.asarray(gru["w_ih"]))
    mha = params["attention"][1]["mha"]
    np.testing.assert_array_equal(sd["attention.1.mha.in_w"].numpy(), np.asarray(mha["in_w"]))
    np.testing.assert_array_equal(sd["attention.1.mha.out.weight"].numpy(),
                                  np.asarray(mha["out"]["w"]).T)
    np.testing.assert_array_equal(sd["final_mlp.2.weight"].numpy(),
                                  np.asarray(params["final_mlp"][2]["w"]).T)
    np.testing.assert_array_equal(sd["encoder_gn.1.f_node.ln.weight"].numpy(),
                                  np.asarray(params["encoder_gn"][1]["f_node"]["ln"]["scale"]))
    del sd["pool_gru.b_hh"]
    with pytest.raises(RuntimeError):
        model.load_state_dict(sd, strict=True)


# -- --dtype bf16 --------------------------------------------------------------------


def _bf16_args(model: str):
    return argparse.Namespace(model=model, dtype="bf16", noise_std=0.0, w_pressure=0.1,
                              alpha=0.1, lr=1e-4)


@pytest.mark.parametrize("kind", ["mgn", "graphvit"])
def test_bf16_train_step_matches_jax_make_graph_step(kind):
    args = _bf16_args(kind)
    b = _batch(baselines_cli.order_mode(args))
    if kind == "mgn":
        params, norm = mgn_init(jax.random.PRNGKey(0), 4, 2)
        model, tnorm = MGN(4, 2), from_jax_norm(norm)
        apply_fn, loss_fn = mgn_apply, functools.partial(jmgn_loss, w_pressure=args.w_pressure)
    else:
        params, norm = jg.graphvit_init(jax.random.PRNGKey(0), 4, W_SIZE, N_ATT, N_GN, HEADS), {}
        model, tnorm = GraphViT(4, W_SIZE, N_ATT, N_GN, HEADS), {}
        # cluster-major ids satisfy the window promise; on the CPU the JAX
        # package then drops the ghost member slots on its XLA path
        apply_fn = functools.partial(jg.graphvit_apply, n_heads=HEADS, cluster_window=512)
        loss_fn = functools.partial(jg.graphvit_loss, alpha=args.alpha)
    model.load_state_dict(from_jax_params(jax.device_get(params)), strict=True)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    grad = functools.partial(_jax_grad, apply_fn=apply_fn, loss_fn=loss_fn,
                             stateful=kind == "mgn", params=params, norm=norm, jb=jb)
    jgrad = from_jax_params(grad(args))
    jgrad32 = from_jax_params(grad(argparse.Namespace(**dict(vars(args), dtype="f32"))))
    step = jcli.make_graph_step(args, apply_fn, loss_fn, kind == "mgn")
    new_params, _, _, jl = step(params, norm, optax.scale_by_adam().init(params), jb,
                                jax.random.PRNGKey(3), jnp.float32(args.lr))
    want = from_jax_params(jax.device_get(new_params))

    opt = baselines_cli.make_optimizer(model, args.lr)
    tb = baselines_cli.to_device(b, torch.device("cpu"))
    _, tl = baselines_cli.train_step(args, model, tnorm, opt, tb, args.lr, None)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=2e-2)
    assert tl.dtype == torch.float32
    names = [n for n, _ in model.named_parameters()]
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        assert _rel(p.grad, jgrad[n]) <= 2 * _rel(jgrad[n], jgrad32[n]), n
        assert np.abs(p.detach().numpy() - want[n].numpy()).max() <= 2 * args.lr + 1e-6, n
    flat = lambda tree: np.concatenate([np.asarray(tree[n]).ravel() for n in names])  # noqa: E731
    assert _rel(flat({n: p.grad for n, p in model.named_parameters()}), flat(jgrad)) <= 5e-2
    moved = np.abs(flat({n: p.detach() for n, p in model.named_parameters()}) - flat(want))
    assert (moved <= args.lr / 2).mean() >= 0.9


def _jax_grad(args, apply_fn, loss_fn, stateful, params, norm, jb):
    """JAX's gradient through ``_cast_fn``, as inside ``make_graph_step``."""
    cast = jcli._cast_fn(args.dtype)

    def loss(p):
        p = cast(p)
        if stateful:
            _, oh, tgt, _ = apply_fn(p, norm, jb["mesh_pos"], jb["edges"], jb["state"],
                                     jb["node_type"], train=True)
        else:
            _, oh, tgt = apply_fn(p, jb["mesh_pos"], jb["edges"], jb["state"], jb["node_type"],
                                  jb["cluster"], jb["cluster_mask"])
        return loss_fn(oh, tgt, jb["mask"])

    return jax.device_get(jax.jit(jax.grad(loss))(params))


@pytest.mark.parametrize("F", [1, 2, 32, 128])
@pytest.mark.parametrize("path", ["interpret", "xla"])
def test_bf16_twins_round_as_the_jax_kernels(monkeypatch, F, path):
    monkeypatch.setenv("FLUID_SEGSUM", "interpret" if path == "interpret" else "auto")
    rng = np.random.default_rng(F)
    B, E, N = 2, 384, 150
    ids = np.clip(np.sort(rng.integers(0, N, (B, E)), axis=1) + rng.integers(-40, 40, (B, E)),
                  0, N - 1).astype(np.int32)
    ids[:, -37:] = N  # ghosts: dropped
    vals = torch.from_numpy(rng.normal(size=(B, E, F)).astype(np.float32)).to(torch.bfloat16)
    nodes = torch.from_numpy(rng.normal(size=(B, N, F)).astype(np.float32)).to(torch.bfloat16)
    def to_jax(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)

    def from_jax(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)

    got = so.segment_sum_nodes(vals, torch.from_numpy(ids), N)
    want = jso.segment_sum_nodes(to_jax(vals), jnp.asarray(ids), N, windowed=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    if path == "interpret":
        assert torch.equal(got, from_jax(want))
    else:  # XLA rounds every add to bf16: each add within 2^-8 of the row's size
        tids = torch.from_numpy(ids)
        exact = so.segment_sum_nodes(vals.double(), tids, N)
        size = so.segment_sum_nodes(vals.double().abs(), tids, N)
        adds = so.segment_sum_nodes(torch.ones(B, E, 1, dtype=torch.float64), tids, N)
        assert bool(((got.double() - exact).abs() <= 2 ** -8 * size).all())
        assert bool(((from_jax(want).double() - exact).abs() <= 2 ** -8 * adds * size).all())
    g = so.gather_nodes(nodes, torch.from_numpy(ids))
    assert g.dtype == torch.bfloat16
    assert torch.equal(g, from_jax(jso.gather_nodes(to_jax(nodes), jnp.asarray(ids),
                                                    windowed=True)))


def test_bf16_backward_keeps_the_forward_dtype():
    ids = torch.tensor([[0, 2, 2, 5]])
    vals = torch.randn(1, 4, 3, dtype=torch.bfloat16, requires_grad=True)
    V = torch.randn(1, 5, 3, dtype=torch.bfloat16, requires_grad=True)
    (so.segment_sum_nodes(vals, ids, 5).float().sum()
     + so.gather_nodes(V, ids).float().square().sum()).backward()
    assert vals.grad.dtype == V.grad.dtype == torch.bfloat16


# -- the CLI -------------------------------------------------------------------------


@pytest.mark.parametrize("model,dtype", [("graphvit", "f32"), ("graphvit", "bf16"),
                                         ("mgn", "bf16"), ("gat", "bf16")])
def test_cli_epoch_then_reload(tmp_path, model, dtype):
    common = ["--model", model, "--dtype", dtype, "--device", "cpu", "--n_processor", "2",
              "--w_size", "32", "--horizon_eval", "5", "--resolution", "40",
              "--save_dir", str(tmp_path), "--n_traj", "2", "--batch_size", "2"]
    first = baselines_cli.main(common + ["--epoch", "1"])
    ckpt = tmp_path / model / "run.pt"
    assert first["checkpoint"] == str(ckpt) and ckpt.exists()
    assert first["train_steps"] == 1 and np.isfinite(first["val_loss"]).all()
    assert np.isfinite(first["train_loss"]).all()
    lines = (tmp_path / model / "run_nrmse.csv").read_text().splitlines()
    assert lines[0] == "step,n_rmse" and len(lines) == 1 + 5
    again = baselines_cli.main(common + ["--epoch", "0", "--prefetch", "0"])
    assert again["train_steps"] == 0
    np.testing.assert_array_equal(again["n_rmse"], first["n_rmse"])
    assert np.isfinite(first["n_rmse"]).all() and first["eval_steps"] == 2 * 4
    saved = torch.load(ckpt, weights_only=True)["params"]
    assert all(v.dtype == torch.float32 for v in saved.values())  # f32 masters


def test_cli_defaults_follow_the_model():
    assert baselines_cli.parse_args(["--model", "graphvit"]).horizon_eval == 51
    assert baselines_cli.parse_args(["--model", "mgn"]).horizon_eval == 101
    args = baselines_cli.parse_args(["--model", "graphvit", "--dtype", "bf16"])
    assert baselines_cli.order_mode(args) == "cluster" and baselines_cli.ghost_type(args) == 2
    args = baselines_cli.parse_args(["--model", "gat"])
    assert baselines_cli.order_mode(args) == "rcm" and baselines_cli.ghost_type(args) == 1
