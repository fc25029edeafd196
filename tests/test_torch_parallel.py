"""The port's data / fsdp / model mesh on the CPU, against the JAX package.

Ranks are CPU processes over gloo (``tests/torch_mesh_worker.py``: one
spawn of four ranks runs every mesh of this file).  The model is the tiny
configuration of ``tests/test_parallel.py`` (GPT-2 layout, 2 layers, d 64,
4 heads, MLP decoder, f32) with DoRA r 4 on q/v whose ``B`` is made
non-zero, weights from the JAX init bridged by ``weights.from_jax_params``,
and the batch of 2 repeated to 8.  The JAX side runs the same step sharded
on the 8-device CPU mesh of ``tests/conftest.py`` at the same (model, fsdp)
sizes (data 8 / (model * fsdp) there, 4 / (model * fsdp) here).

Each mesh step is held to JAX's sharded step and to the port's
one-process step on the same numpy inputs: the loss within 1e-5 relative,
every gradient (gathered whole on rank 0) within 1e-4 of the largest
gradient entry of the model, and every updated trainable tensor within
1e-5 relative L2.  Against the port's own one-process step the mesh step
agrees to ~1e-7 (sums in another order); the bounds are the issue's.
Dropout is off against JAX (the packages draw from different generators)
and on in the port-only check of one-process draws.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from fluid_llm_tpu.config import Config as JConfig
from fluid_llm_tpu.config import ParallelConfig as JParallel
from fluid_llm_tpu.data.pipeline import make_batches as jmake_batches
from fluid_llm_tpu.data.synthetic import SyntheticCylinderDataset as JSynthetic
from fluid_llm_tpu.models.fluid_llm import FluidLLM as JFluidLLM
from fluid_llm_tpu.parallel import mesh as jmesh
from fluid_llm_tpu.train.optim import combine as jcombine
from fluid_llm_tpu.train.optim import partition as jpartition
from fluid_llm_tpu.train.trainer import Trainer as JTrainer
from fluid_llm_tpu_torch.config import Config, ParallelConfig
from fluid_llm_tpu_torch.data import make_batches
from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
from fluid_llm_tpu_torch.ops.quant import QuantLinear, quantize_backbone
from fluid_llm_tpu_torch.parallel import mesh as pmesh
from fluid_llm_tpu_torch.train import checkpoint as ckpt
from fluid_llm_tpu_torch.train.trainer import Trainer
from fluid_llm_tpu_torch.weights import from_jax_params

sys.path.insert(0, os.path.dirname(__file__))
from torch_mesh_worker import spawn  # noqa: E402

torch.set_num_threads(2)

TINY = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, max_pos=128, dropout=0.0)
LLAMA_TINY = dict(n_layers=2, d_model=64, n_heads=8, n_kv_heads=4, d_ff=128, max_pos=128,
                  dropout=0.0)
CFG = dict(
    llm_backbone="gpt2", half_precision=False, use_lora=True, batch_size=2, autoreg_seq_len=4,
    seq_len=4, resolution=64, flash_attention=False,
    lora_config={"r": 4, "lora_alpha": 16, "use_dora": True, "lora_dropout": 0.0},
    pos_embedding_params={"input_emb_layer_dropout": 0.0},
    decoder_params={"type": "MLP", "num_layers": 2, "hidden_dim": 32, "activation": "leakyrelu",
                    "zero_last_layer": False, "dropout": 0.0},
    encoder_params={"type": "MLP", "num_layers": 2, "hidden_dim": 32,
                    "activation": "leakyrelu"},
)
LLAMA = dict(CFG, llm_backbone="huggyllama/llama-7b", llm_layers=2)
# the dropouts of training1.yaml, for the one-process draws
# widths at which adafactor factors the block's matrices (both dims >= 128)
WIDE = dict(TINY, d_model=128, d_ff=256)
# widths whose int8 linears the w8a16 kernel takes whole and cut over model 2
# (K a multiple of 128, N of 16: o's K 128 and fc2's 256 a rank)
INT8 = dict(TINY, d_model=256, d_ff=512)
DROPOUT = dict(lora_config={**CFG["lora_config"], "lora_dropout": 0.1},
               pos_embedding_params={"input_emb_layer_dropout": 0.1})
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]  # (model, fsdp)


def jax_params(cfg_kw: dict, tiny: dict, seed: int = 0):
    """The JAX init with the adapters' ``B`` made non-zero (numpy leaves)."""
    ds = JSynthetic(n_trajectories=2, resolution=64, seq_len=4, mode="valid")
    jm = JFluidLLM.build(JConfig(**cfg_kw), ds.ds_props(), **tiny)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    if "lora" in params:
        rng = np.random.default_rng(5)
        for layer in params["lora"]["layers"]:
            for leaf in layer["attn"].values():
                leaf["B"] = jnp.asarray(rng.normal(size=leaf["B"].shape).astype(np.float32) * 0.05)
    return jax.tree_util.tree_map(np.asarray, params)


def batch8(masked: bool = False):
    """The batch of 2 repeated to 8 (numpy); ``masked``: rows 4-7 with a
    third of their pixels more excluded, so the batch ranks' mask counts
    differ."""
    ds = JSynthetic(n_trajectories=2, resolution=64, seq_len=4, mode="valid")
    b = [np.concatenate([np.asarray(x)] * 4, axis=0)
         for x in next(jmake_batches(ds, 2, shuffle=False))]
    if masked:
        rng = np.random.default_rng(3)
        extra = rng.random(b[3].shape[:3] + (1,) + b[3].shape[4:]) < 0.33
        extra[:4] = False
        b[3] = b[3] | np.broadcast_to(extra, b[3].shape)
    return tuple(b)


def wide_state(cfg: dict = None, tiny: dict = WIDE) -> dict:
    """Weights at ``tiny``'s widths (a full fine-tune's at :data:`WIDE` by
    default), drawn by the port."""
    model = FluidLLM.build(Config(**(cfg or dict(CFG, use_lora=False))), SyntheticCylinderDataset(
        n_trajectories=1, resolution=64, seq_len=4).ds_props(), **tiny)
    model.init_weights(torch.Generator().manual_seed(2))
    return model.state_dict()


def jax_step(cfg_kw, tiny, params, batch, model_ax, fsdp_ax, **par_kw):
    """JAX's sharded autoreg step: (loss, gradients, updated trainable), as
    port state-dict tensors."""
    par = JParallel(model_axis=model_ax, fsdp_axis=fsdp_ax, **par_kw)
    ds = JSynthetic(n_trajectories=2, resolution=64, seq_len=4, mode="valid")
    jm = JFluidLLM.build(JConfig(**cfg_kw, parallel=par), ds.ds_props(), **tiny)
    mesh = jmesh.make_mesh(par)
    trainer = JTrainer(jm)
    sharded = jmesh.shard_params(jax.tree_util.tree_map(jnp.asarray, params), mesh, par)
    trainable, frozen = jpartition(sharded, jm.trainable_mask(sharded))
    b = jmesh.shard_batch(batch, mesh)
    key = jax.random.PRNGKey(1)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda tr: trainer._mode_loss(jcombine(tr, frozen), b, key, "autoreg"),
        has_aux=True))(trainable)
    updates, _ = trainer.opt.update(grads, trainer.opt.init(trainable), trainable)
    new = optax.apply_updates(trainable, updates)  # ``_train_step``'s update, eagerly
    bridge = lambda t: from_jax_params(jax.tree_util.tree_map(np.asarray, t))
    return float(loss), bridge(grads), bridge(new)


def port_step(cfg_kw, tiny, state, batch, steps: int = 1, quant=None):
    """The port's one-process steps: (model, trainer, losses)."""
    model = FluidLLM.build(Config(**cfg_kw), SyntheticCylinderDataset(
        n_trajectories=1, resolution=64, seq_len=4).ds_props(), **tiny)
    model.load_state_dict({k: v for k, v in state.items() if k in model.state_dict()})
    if quant is not None:
        quantize_backbone(model.backbone, quant)
    trainer = Trainer(model)
    losses = [trainer.train_step(tuple(map(torch.as_tensor, batch)))["loss"].item()
              for _ in range(steps)]
    return model, trainer, losses


def check(got: dict, loss: float, grads: dict, params: dict, name: str,
          update_tol: float = 1e-5) -> None:
    """A mesh step against another step: loss, gradients, updated tensors
    (within ``update_tol`` relative L2).  A gradient that is zero but for
    rounding (the key bias's: softmax is invariant to a per-query constant)
    is normalised by Adam into a full-size step, so such tensors' updates
    are left out."""
    assert abs(got["losses"][0] - loss) <= 1e-5 * abs(loss), (name, got["losses"][0], loss)
    scale = max(float(g.abs().max()) for g in grads.values())
    for n, g in grads.items():
        np.testing.assert_allclose(got["grads"][n].numpy(), np.asarray(g), rtol=0,
                                   atol=1e-4 * scale, err_msg=f"{name} grad {n}")
    for n, p in params.items():
        if float(torch.as_tensor(grads[n]).abs().max()) < 1e-6 * scale:
            continue
        p = torch.as_tensor(p)
        err = float((got["params"][n] - p).norm() / p.norm().clamp_min(1e-30))
        assert err <= update_tol, (name, n, err)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One four-rank spawn: the meshes of MESHES, the LLaMA TP step, a
    masked loss whose counts differ between ranks, adafactor full-FT on
    (2, 2), one-process dropout draws on (2, 2) and under sequence
    parallelism, and a checkpoint written on (2, 2) and restored on data 4."""
    tmp = tmp_path_factory.mktemp("parallel")
    params = jax_params(CFG, TINY)
    state = from_jax_params(params)
    lparams = jax_params(LLAMA, LLAMA_TINY)
    batch = batch8()
    masked = batch8(masked=True)
    wide = wide_state()
    int8 = wide_state(CFG, INT8)
    tb = lambda b: tuple(map(torch.as_tensor, b))
    saved = str(tmp / "ckpt")
    variants = [dict(parallel={"model_axis": m, "fsdp_axis": f}) for m, f in MESHES]
    variants += [
        dict(parallel={"model_axis": 2, "fsdp_axis": 2}, cfg=LLAMA, tiny=LLAMA_TINY,
             state=from_jax_params(lparams)),
        dict(parallel={}, batch=tb(masked), val=True),
        dict(parallel={"model_axis": 2, "fsdp_axis": 2}, steps=2, tiny=WIDE, state=wide,
             cfg={"use_lora": False, "optimizer": "adafactor"}),
        dict(parallel={"model_axis": 2, "fsdp_axis": 2}, cfg=DROPOUT, tiny={"dropout": 0.1}),
        dict(parallel={"model_axis": 2, "seq_sharded_acts": True}, cfg=DROPOUT,
             tiny={"dropout": 0.1}),
        dict(parallel={"model_axis": 2, "fsdp_axis": 2}, save=saved),
        dict(parallel={}, restore=saved),
        dict(parallel={"model_axis": 2, "fsdp_axis": 2}, tiny=INT8, state=int8, quant="int8"),
        dict(parallel={"model_axis": 2, "fsdp_axis": 2}, tiny=INT8, state=int8, quant="nf4"),
    ]
    res = spawn("steps", 4, str(tmp / "run"), variants=variants, cfg=CFG, tiny=TINY,
                state=state, batch=tb(batch))
    return dict(params=params, state=state, lparams=lparams, batch=batch, masked=masked,
                res=res, saved=saved, wide=wide, int8=int8)


def test_mesh_axes():
    mesh = pmesh.make_mesh(ParallelConfig(model_axis=2, fsdp_axis=2), world=8, rank=0)
    assert mesh.shape == {"data": 2, "fsdp": 2, "model": 2}
    assert pmesh.make_mesh(ParallelConfig(), world=8, rank=3).shape == \
        {"data": 8, "fsdp": 1, "model": 1}
    assert pmesh.mesh_shape(8, ParallelConfig(model_axis=2, fsdp_axis=2)) == \
        jmesh.mesh_shape(8, JParallel(model_axis=2, fsdp_axis=2))
    for kw in ({"model_axis": 3}, {"pipe_axis": 2, "expert_axis": 2}):
        with pytest.raises(ValueError):
            pmesh.mesh_shape(8, ParallelConfig(**kw))


def test_param_specs_cover_tree():
    """Every tensor of the port's state dict has the JAX ``param_specs``'s
    spec of its leaf, in the ``(out, in)`` orientation."""
    params = jax_params(CFG, TINY)
    jspecs = jmesh.param_specs(params, JParallel(model_axis=2, fsdp_axis=2))
    model = FluidLLM.build(Config(**CFG), SyntheticCylinderDataset(
        n_trajectories=1, resolution=64, seq_len=4).ds_props(), **TINY)
    specs = pmesh.param_specs(model, ParallelConfig(model_axis=2, fsdp_axis=2))
    assert specs.keys() == model.state_dict().keys()
    flat = jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=lambda x: isinstance(x, P))[0]
    seen = 0
    for path, spec in flat:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        *prefix, leaf = keys
        leaf = {"w": "weight", "b": "bias", "scale": "weight"}.get(leaf, leaf)
        name = ".".join(prefix + [leaf])
        t = model.state_dict()[name]
        want = tuple(spec) + (None,) * (t.dim() - len(spec))
        if leaf == "weight" and t.dim() == 2:
            want = want[::-1]
        got = specs[name] + (None,) * (t.dim() - len(specs[name]))
        assert got == want, (name, got, want)
        seen += 1
    assert seen == len(specs)
    assert specs["backbone.layers.0.attn.q.weight"] == ("model", "fsdp")  # JAX P("fsdp", "model")
    assert specs["backbone.layers.0.attn.o.weight"] == ("fsdp", "model")


@pytest.mark.parametrize("model_ax,fsdp_ax", [(2, 1), (1, 2), (2, 2)])
def test_sharded_train_step(world, model_ax, fsdp_ax):
    """One DoRA step on (model, fsdp) ranks: equal to JAX's sharded step and
    to the port's one-process step."""
    got = world["res"][MESHES.index((model_ax, fsdp_ax))]
    assert got["mesh"] == {"data": 4 // (model_ax * fsdp_ax), "fsdp": fsdp_ax, "model": model_ax}
    check(got, *jax_step(CFG, TINY, world["params"], world["batch"], model_ax, fsdp_ax),
          f"jax {model_ax}x{fsdp_ax}")
    model, _, losses = port_step(CFG, TINY, world["state"], world["batch"])
    check(got, losses[0], {n: p.grad for n, p in model.named_parameters() if p.grad is not None},
          {n: p.detach() for n, p in model.named_parameters() if p.requires_grad}, "one process")


def test_sharded_matches_single_device(world):
    """Pure data parallelism over 4 ranks equals the one-process step, its
    optimizer state too (JAX's data-8 step: the masked test below)."""
    got = world["res"][0]
    model, trainer, losses = port_step(CFG, TINY, world["state"], world["batch"])
    assert got["losses"][0] == pytest.approx(losses[0], rel=1e-6)
    for n, p in model.named_parameters():
        if p.requires_grad:
            torch.testing.assert_close(got["params"][n], p.detach(), rtol=0, atol=1e-7)
    one = trainer.opt.state_dict()
    assert got["opt"]["param_groups"][0]["params"] == one["param_groups"][0]["params"]
    for i, st in one["state"].items():  # moments within 1e-5 of each tensor's largest entry
        for k, v in st.items():
            v = torch.as_tensor(v).double()
            torch.testing.assert_close(torch.as_tensor(got["opt"]["state"][i][k]).double(), v,
                                       rtol=0, atol=1e-5 * float(v.abs().max()))


def test_masked_loss_counts_differ_between_ranks(world):
    """Rows 4-7 exclude a third more pixels than rows 0-3, so the batch
    ranks' masked counts differ: the mesh loss (numerator and count reduced
    apart) and its gradients equal the global masked mean's, one process
    and JAX; the validation step's losses and per-row N-RMSE too."""
    got = world["res"][5]
    model, trainer, losses = port_step(CFG, TINY, world["state"], world["masked"])
    check(got, losses[0], {n: p.grad for n, p in model.named_parameters() if p.grad is not None},
          {n: p.detach() for n, p in model.named_parameters() if p.requires_grad}, "masked")
    check(got, *jax_step(CFG, TINY, world["params"], world["masked"], 1, 1), "jax masked")
    assert got["n_rmse"][0].shape == (8, 3)  # every row, 3 steps
    val = trainer.val_step(tuple(map(torch.as_tensor, world["masked"])))
    for k, v in val.items():
        torch.testing.assert_close(got["val"][k], v, rtol=1e-5, atol=1e-7)


def test_train_run_with_mesh(tmp_path, world):
    """``train_run`` for one epoch on two data ranks logs what one process
    logs (rank 0's logs; validation N-RMSE over every trajectory)."""
    from fluid_llm_tpu_torch.train.loop import train_run

    cfg = dict(CFG, num_epochs=1, batch_size=8, save_on=False)
    logs = spawn("train_run", 2, str(tmp_path), cfg=cfg, tiny=TINY, state=world["state"],
                 parallel={})
    model = FluidLLM.build(Config(**cfg), SyntheticCylinderDataset(
        n_trajectories=1, resolution=64, seq_len=4).ds_props(), **TINY)
    model.load_state_dict(world["state"])
    ds = SyntheticCylinderDataset(n_trajectories=8, resolution=64, seq_len=4, mode="valid")
    one = []
    train_run(model.cfg, Trainer(model), ds, ds, log_fn=lambda m, e: one.append(m))
    assert len(logs) == len(one) == 1 and "train/Autoreg/loss" in logs[0]
    assert logs[0].keys() == one[0].keys()
    for k in one[0]:
        assert logs[0][k] == pytest.approx(one[0][k], rel=1e-5), k


def test_llama_family_tp_train_step(world):
    """LLaMA layout (rope, RMSNorm, 8 heads over 4 kv heads, no biases) with
    DoRA on model 2 x fsdp 2: 4 and 2 heads a rank; equal to JAX's sharded
    step and one process."""
    got = world["res"][4]
    check(got, *jax_step(LLAMA, LLAMA_TINY, world["lparams"], world["batch"], 2, 2), "llama")
    model, _, losses = port_step(LLAMA, LLAMA_TINY, from_jax_params(world["lparams"]),
                                 world["batch"])
    check(got, losses[0], {n: p.grad for n, p in model.named_parameters() if p.grad is not None},
          {n: p.detach() for n, p in model.named_parameters() if p.requires_grad}, "llama one")


def test_sharded_adafactor_full_finetune(world):
    """Full fine-tuning with adafactor on model 2 x fsdp 2 at d 128, d_ff
    256 (its block matrices factored): they are chunks over both axes on
    each rank, and adafactor's factored row and column means, block RMS and
    parameter RMS sum their parts, so two steps equal one process's."""
    got = world["res"][6]
    cfg = dict(CFG, use_lora=False, optimizer="adafactor")
    model, trainer, losses = port_step(cfg, WIDE, world["wide"], world["batch"], steps=2)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    scale = max(float(g.abs().max()) for g in grads.values())
    for n, p in model.named_parameters():
        if float(grads[n].abs().max()) < 1e-6 * scale:
            continue  # the key bias: a rounding-noise gradient (see check)
        err = float((got["params"][n] - p.detach()).norm() / p.detach().norm())
        assert err <= 1e-5, (n, err)
    assert any(k.startswith("v_row") for st in got["opt"]["state"].values() for k in st)


def test_dropout_draws_of_one_process(world):
    """With every dropout on (embeddings, backbone, adapters: 0.1), the
    mesh's masks are one process's cut to each rank's rows and tokens: on
    model 2 x fsdp 2 and under sequence parallelism the step equals the
    port's one-process step."""
    cfg = dict(CFG, **DROPOUT)
    model, _, losses = port_step(cfg, dict(TINY, dropout=0.1), world["state"], world["batch"])
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    params = {n: p.detach() for n, p in model.named_parameters() if p.requires_grad}
    for i, name in ((7, "2x2"), (8, "sequence parallel")):
        check(world["res"][i], losses[0], grads, params, f"dropout {name}")


def test_sharded_checkpoint_resume(world):
    """A checkpoint written on model 2 x fsdp 2 restores in one process
    (parameters and optimizer state equal to the mesh's), and on data 4
    (its next step equal to one process's from the same checkpoint)."""
    saved_from = world["res"][9]
    model = FluidLLM.build(Config(**CFG), SyntheticCylinderDataset(
        n_trajectories=1, resolution=64, seq_len=4).ds_props(), **TINY)
    model.init_weights(torch.Generator().manual_seed(9))
    trainer = Trainer(model)
    assert ckpt.restore_checkpoint(world["saved"], 0, model, trainer.opt) == 0
    for n, p in model.named_parameters():
        if p.requires_grad:
            assert torch.equal(saved_from["params"][n], p.detach()), n
    sd = trainer.opt.state_dict()
    for i, st in sd["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(saved_from["opt"]["state"][i][k]),
                               torch.as_tensor(v)), (i, k)
    loss = trainer.train_step(tuple(map(torch.as_tensor, world["batch"])))["loss"].item()
    got = world["res"][10]
    assert got["losses"][0] == pytest.approx(loss, rel=1e-6)
    for n, p in model.named_parameters():
        if p.requires_grad:
            torch.testing.assert_close(got["params"][n], p.detach(), rtol=0, atol=1e-7)


class _FakeDev:
    """Minimal device stand-in for the multi-host ordering math."""

    def __init__(self, pid, did):
        self.process_index = pid
        self.id = did


def test_multihost_device_order_keeps_model_fsdp_on_host():
    devs = [_FakeDev(p, p * 8 + i) for p in range(4) for i in range(8)]
    data, fsdp, model = pmesh.mesh_shape(32, ParallelConfig(model_axis=4, fsdp_axis=2))
    assert (data, fsdp, model) == (4, 2, 4)
    arr = pmesh.multihost_device_order(devs, data, fsdp, model)
    assert arr.shape == (4, 2, 4)
    for di in range(4):
        assert len({d.process_index for d in arr[di].ravel()}) == 1
    assert [arr[di, 0, 0].process_index for di in range(4)] == [0, 1, 2, 3]
    assert [d.id for d in arr[0].ravel()] == list(range(8))
    # torchrun's node-major ranks, 8 a node: the same grid of ranks
    mesh = pmesh.make_mesh(ParallelConfig(model_axis=4, fsdp_axis=2), world=32, rank=5,
                           local_world=8)
    assert mesh.grid.tolist() == np.vectorize(lambda d: d.id)(arr).tolist()
    assert mesh.coords == {"data": 0, "fsdp": 1, "model": 1}


def test_multihost_device_order_rejects_cross_host_model_axis():
    devs = [_FakeDev(p, p * 4 + i) for p in range(2) for i in range(4)]
    with pytest.raises(ValueError, match="must divide"):
        pmesh.multihost_device_order(devs, 1, 1, 8)
    with pytest.raises(ValueError, match="uneven"):
        pmesh.multihost_device_order(devs + [_FakeDev(2, 100)], 3, 1, 3)
    with pytest.raises(NotImplementedError, match="within a host"):
        pmesh.make_mesh(ParallelConfig(pipe_axis=2), world=8, rank=0, local_world=4)


def test_multihost_local_data_rows_contiguous():
    devs = [_FakeDev(p, p * 4 + i) for p in range(2) for i in range(4)]
    arr = pmesh.multihost_device_order(devs, 8, 1, 1)
    assert [arr[i, 0, 0].process_index for i in range(8)] == [0] * 4 + [1] * 4
    mesh = pmesh.make_mesh(ParallelConfig(), world=8, rank=6, local_world=4)
    assert mesh.rows(16) == (12, 14, 16)


def test_int8_frozen_backbone_tensor_parallel(world):
    """DoRA over an int8 frozen backbone (d 256) on model 2 x fsdp 2: each
    rank holds its int8 ``q`` chunk (and the ``scale`` of its output
    columns), gathers the fsdp half on use, and runs the int8 product at
    N/2 or K/2; equal to the one-process step.  At d 128 the row-parallel
    linears' K/2 = 64 is a width the w8a16 kernel does not take: cutting
    raises rather than fall back to the dequantised product."""
    got = world["res"][11]
    model, _, losses = port_step(CFG, INT8, world["int8"], world["batch"], quant="int8")
    # updates within 1e-4: AdamW's first step moves every entry by ~lr, so
    # entries whose gradients are near zero and a rounding apart (the int8
    # product at N/2, K/2 sums in other tiles) move apart; measured 1.24e-5
    check(got, losses[0], {n: p.grad for n, p in model.named_parameters() if p.grad is not None},
          {n: p.detach() for n, p in model.named_parameters() if p.requires_grad}, "int8 2x2",
          update_tol=1e-4)
    narrow = FluidLLM.build(Config(**CFG), SyntheticCylinderDataset(
        n_trajectories=1, resolution=64, seq_len=4).ds_props(), **WIDE)
    quantize_backbone(narrow.backbone, "int8")
    assert isinstance(narrow.backbone.layers[0].attn["o"], QuantLinear)
    with pytest.raises(ValueError, match="w8a16 kernel takes the whole"):
        pmesh.shard_model(narrow, pmesh.make_mesh(ParallelConfig(model_axis=2), world=2, rank=0))


def test_nf4_frozen_backbone_tensor_parallel(world):
    """DoRA over a packed-nf4 frozen backbone (``llm_4bit_loading``'s
    storage) on model 2 x fsdp 2: the nf4 codes stay whole on every rank
    (absmax blocks span rows) and each linear is cut to this rank's
    features when dequantised; equal to the one-process step (updates
    within 1e-4, as the int8 case)."""
    got = world["res"][12]
    model, _, losses = port_step(CFG, INT8, world["int8"], world["batch"], quant="nf4")
    check(got, losses[0], {n: p.grad for n, p in model.named_parameters() if p.grad is not None},
          {n: p.detach() for n, p in model.named_parameters() if p.requires_grad}, "nf4 2x2",
          update_tol=1e-4)
