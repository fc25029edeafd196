"""The port's expert axis on the CPU, against the JAX package's expert-sharded step.

Ranks are CPU processes over gloo (``tests/torch_mesh_worker.py``: one
spawn of four ranks runs every mesh of this file).  The model is the tiny
MoE configuration of ``tests/test_moe.py`` (``moe_setup``: GPT-2 layout, 2
layers, d 64, 4 heads, 4 experts top-2 at capacity factor 8, MLP decoder,
f32, full fine-tuning), weights from the JAX init bridged by
``weights.from_jax_params``, the batch of 2 repeated to 8.  The JAX side
runs the same step sharded on the 8-device CPU mesh of
``tests/conftest.py`` at the same (model, fsdp, expert) sizes (data 8 /
(model * fsdp * expert) there, 4 / (model * fsdp * expert) here).

Each mesh step is held to JAX's sharded step and to the port's
one-process step with ``tests/test_torch_parallel.py``'s bounds: the loss
within 1e-5 relative, every gradient (gathered whole) within 1e-4 of the
largest gradient entry, every updated tensor within 1e-5 relative L2; the
balance loss (``moe_aux``) within 1e-5 relative.  int8 expert banks over
the expert axis: the forward within 1e-5 of JAX's
(``tests/test_quant.py:156-190``).
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
from fluid_llm_tpu.ops.quant import quantize_backbone as jquantize_backbone
from fluid_llm_tpu.parallel import mesh as jmesh
from fluid_llm_tpu.train.optim import combine as jcombine
from fluid_llm_tpu.train.optim import partition as jpartition
from fluid_llm_tpu.train.trainer import Trainer as JTrainer
from fluid_llm_tpu_torch.config import Config, ParallelConfig
from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
from fluid_llm_tpu_torch.ops.quant import quantize_backbone
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
AMPLE = {"experts": 4, "top_k": 2, "capacity_factor": 8.0}  # ``test_moe.moe_setup``
CFG = dict(
    llm_backbone="gpt2", half_precision=False, use_lora=False, batch_size=2, autoreg_seq_len=4,
    seq_len=4, resolution=64, flash_attention=False, moe=AMPLE,
    pos_embedding_params={"input_emb_layer_dropout": 0.0},
    decoder_params={"type": "MLP", "num_layers": 2, "hidden_dim": 32, "activation": "leakyrelu",
                    "zero_last_layer": False, "dropout": 0.0},
    encoder_params={"type": "MLP", "num_layers": 2, "hidden_dim": 32,
                    "activation": "leakyrelu"},
)
LLAMA = dict(CFG, llm_backbone="huggyllama/llama-7b", llm_layers=2)
CHOICE = dict(CFG, moe=dict(AMPLE, router="expert_choice"))
TIGHT = dict(CFG, moe=dict(AMPLE, capacity_factor=1.0))  # tokens dropped at capacity

# (name, parallel keys, config, backbone widths): each held to JAX's step
# on the same axes and to the port's one-process step
STEPS = [
    ("expert 4", {"expert_axis": 4}, CFG, TINY),
    ("data 2 x expert 2", {"expert_axis": 2}, CFG, TINY),
    ("model 2 x expert 2", {"model_axis": 2, "expert_axis": 2}, CFG, TINY),
    ("fsdp 2 x expert 2", {"fsdp_axis": 2, "expert_axis": 2}, CFG, TINY),
    ("expert_choice, expert 2", {"expert_axis": 2}, CHOICE, TINY),
    ("capacity 1.0, expert 4", {"expert_axis": 4}, TIGHT, TINY),
    ("llama, model 2 x expert 2", {"model_axis": 2, "expert_axis": 2}, LLAMA, LLAMA_TINY),
    ("sequence parallel, model 2 x expert 2",
     {"model_axis": 2, "expert_axis": 2, "seq_sharded_acts": True}, CFG, TINY),
    ("ring, model 2 x expert 2",
     {"model_axis": 2, "expert_axis": 2, "seq_sharded_acts": True, "ring_attention": True},
     CFG, TINY),
    ("sequence parallel, data 2 x model 2", {"model_axis": 2, "seq_sharded_acts": True},
     CFG, TINY),
]
NAMES = [s[0] for s in STEPS]
# held to JAX's one-device step instead: JAX's step on this mesh computes
# the learned positions' gradient wrong (7e-3 of the largest gradient entry
# away from its own one-device step, which the port's one-process step
# equals to 1e-9; its loss agrees), so the mesh is held to the one-process
# semantics it should have
JAX_ONE_DEVICE = {"sequence parallel, model 2 x expert 2"}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_params(cfg_kw: dict, tiny: dict) -> dict:
    ds = JSynthetic(n_trajectories=2, resolution=64, seq_len=4, mode="valid")
    jm = JFluidLLM.build(JConfig(**cfg_kw), ds.ds_props(), **tiny)
    return _np(jax.jit(jm.init)(jax.random.PRNGKey(0)))


def batch8():
    ds = JSynthetic(n_trajectories=2, resolution=64, seq_len=4, mode="valid")
    return tuple(np.concatenate([np.asarray(x)] * 4, axis=0)
                 for x in next(jmake_batches(ds, 2, shuffle=False)))


def _jax_model(cfg_kw: dict, tiny: dict, par: JParallel):
    ds = JSynthetic(n_trajectories=2, resolution=64, seq_len=4, mode="valid")
    return JFluidLLM.build(JConfig(**cfg_kw, parallel=par), ds.ds_props(), **tiny)


def jax_step(cfg_kw: dict, tiny: dict, params: dict, batch, par_kw: dict):
    """JAX's sharded autoreg step: (loss, aux, gradients, updated trainable),
    the last two as port state-dict tensors."""
    par = JParallel(**par_kw)
    jm = _jax_model(cfg_kw, tiny, par)
    mesh = jmesh.make_mesh(par)
    trainer = JTrainer(jm)
    sharded = jmesh.shard_params(jax.tree_util.tree_map(jnp.asarray, params), mesh, par)
    trainable, frozen = jpartition(sharded, jm.trainable_mask(sharded))
    b = jmesh.shard_batch(batch, mesh)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda tr: trainer._mode_loss(jcombine(tr, frozen), b, jax.random.PRNGKey(1), "autoreg"),
        has_aux=True))(trainable)
    new = jax.jit(lambda g, t: optax.apply_updates(  # ``_train_step``'s update
        t, trainer.opt.update(g, trainer.opt.init(t), t)[0]))(grads, trainable)
    bridge = lambda t: from_jax_params(_np(t))
    return float(loss), float(metrics["moe_aux"]), bridge(grads), bridge(new)


def _props():
    return SyntheticCylinderDataset(n_trajectories=1, resolution=64, seq_len=4).ds_props()


def port_step(cfg_kw: dict, tiny: dict, state: dict, batch):
    """The port's one-process step: (model, trainer, metrics)."""
    model = FluidLLM.build(Config(**cfg_kw), _props(), **tiny)
    model.load_state_dict(state)
    trainer = Trainer(model)
    metrics = trainer.train_step(tuple(map(torch.as_tensor, batch)))
    return model, trainer, metrics


def check(got: dict, loss: float, aux: float, grads: dict, params: dict, name: str,
          resolved: bool = False) -> None:
    """A mesh step against another step: loss, balance loss, gradients,
    updated tensors (``test_torch_parallel.check``'s bounds).  A gradient
    that is zero but for rounding (the key bias's) is normalised by Adam
    into a full-size step, so such tensors' updates are left out.
    ``resolved`` (against the JAX package): the updates are compared over
    the entries whose gradient the gradient bound resolves (above 1e-4 of
    the largest entry); below it, full fine-tuning leaves entries of
    ~1e-8, near Adam's eps, whose step follows their rounding: the port's
    one-process step and JAX's own steps on two meshes differ there by
    up to 1e-5 relative L2."""
    assert abs(got["losses"][0] - loss) <= 1e-5 * abs(loss), (name, got["losses"][0], loss)
    assert abs(got["aux"][0] - aux) <= 1e-5 * abs(aux), (name, got["aux"][0], aux)
    scale = max(float(torch.as_tensor(g).abs().max()) for g in grads.values())
    for n, g in grads.items():
        np.testing.assert_allclose(got["grads"][n].numpy(), np.asarray(g), rtol=0,
                                   atol=1e-4 * scale, err_msg=f"{name} grad {n}")
    for n, p in params.items():
        g = torch.as_tensor(grads[n])
        if float(g.abs().max()) < 1e-6 * scale:
            continue
        p, q = torch.as_tensor(p), got["params"][n]
        if resolved:
            keep = g.abs() > 1e-4 * scale
            p, q = p[keep], q[keep]
        err = float((q - p).norm() / p.norm().clamp_min(1e-30))
        assert err <= 1e-5, (name, n, err)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One four-rank spawn: a step on every mesh of STEPS (model 2 x expert 2
    also writes a checkpoint, restored on expert 4 for a second step), and
    the int8-bank forward on data 2 x expert 2."""
    tmp = tmp_path_factory.mktemp("expert")
    params = {k: jax_params(c, t) for k, c, t in
              (("gpt2", CFG, TINY), ("llama", LLAMA, LLAMA_TINY))}
    states = {k: from_jax_params(p) for k, p in params.items()}
    batch = batch8()
    tb = tuple(map(torch.as_tensor, batch))
    saved = str(tmp / "ckpt")
    variants = []
    for name, par, cfg, tiny in STEPS:
        v = dict(parallel=par, cfg=cfg, tiny=tiny,
                 state=states["llama" if cfg is LLAMA else "gpt2"])
        if name == "model 2 x expert 2":
            v["save"] = saved
        variants.append(v)
    variants.append(dict(parallel={"expert_axis": 4}, restore=saved))
    forward = [dict(parallel={"expert_axis": 2}, quant="int8"),
               dict(parallel={"model_axis": 2, "expert_axis": 2}, prepare="int8")]
    res = spawn("jobs", 4, str(tmp / "run"), cfg=CFG, tiny=TINY, state=states["gpt2"],
                batch=tb, jobs=[("steps", {"variants": variants}),
                                ("forward", {"variants": forward})])
    return dict(params=params, states=states, batch=batch, steps=res[0], forward=res[1],
                saved=saved)


def test_mesh_axes_expert_last():
    """The axes (data, fsdp, model, expert), expert last (an expert group is
    consecutive ranks); the batch splits over data, fsdp and expert; JAX's
    refusals: pipe with expert, an expert group across hosts; the groups
    made."""
    par = ParallelConfig(model_axis=2, expert_axis=2)
    mesh = pmesh.make_mesh(par, world=8, rank=5)
    assert mesh.shape == {"data": 2, "fsdp": 1, "model": 2, "expert": 2}
    jm = jmesh.make_mesh(JParallel(model_axis=2, expert_axis=2))
    assert tuple(jm.axis_names) == mesh.axis_names and dict(jm.shape) == mesh.shape
    assert mesh.coords == {"data": 1, "fsdp": 0, "model": 0, "expert": 1}
    assert mesh.group("expert").ranks == [4, 5] and mesh.group("model").ranks == [5, 7]
    assert mesh.batch_axes == ("data", "fsdp", "expert")
    # a group for each axis, and for "data" with the batch axes a tensor may
    # be cut over (the groups a gradient is summed over)
    assert set(mesh.groups) == {("data",), ("fsdp",), ("model",), ("expert",),
                                ("data", "fsdp"), ("data", "expert"),
                                ("data", "fsdp", "expert")}
    assert mesh.batch.ranks == [0, 1, 4, 5] and mesh.rows(8) == (6, 8, 8)
    assert pmesh.make_mesh(ParallelConfig(), world=4, rank=1).batch_axes == ("data", "fsdp")
    with pytest.raises(ValueError, match="pipe and expert"):
        pmesh.mesh_shape(8, ParallelConfig(pipe_axis=2, expert_axis=2))
    with pytest.raises(NotImplementedError, match="expert_axis=1 across hosts"):
        pmesh.make_mesh(ParallelConfig(expert_axis=2), world=8, rank=0, local_world=4)
    with pytest.raises(ValueError, match="expert_axis"):
        FluidLLM.build(Config(**dict(CFG, moe={"experts": 3, "top_k": 1}),
                              parallel={"expert_axis": 2}), _props(), **TINY)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_param_specs_of_expert_banks(quant):
    """Every tensor of the MoE model (float or int8 banks) has the JAX
    ``param_specs``'s spec of its leaf on data 2 x model 2 x fsdp 2 x
    expert... (an expert bank ("expert", "model", "fsdp") for fc1, ("expert",
    "fsdp", "model") for fc2, in the ``(out, in)`` orientation; the router
    whole)."""
    params = jax_params(CFG, TINY)
    if quant:
        params = dict(params, backbone=_np(jquantize_backbone(params["backbone"], quant)))
    jpar = JParallel(model_axis=2, fsdp_axis=2, expert_axis=2)
    jspecs = jmesh.param_specs(params, jpar)
    model = FluidLLM.build(Config(**CFG), _props(), **TINY)
    if quant:
        quantize_backbone(model.backbone, quant)
    specs = pmesh.param_specs(model, ParallelConfig(model_axis=2, fsdp_axis=2, expert_axis=2))
    flat = jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=lambda x: isinstance(x, P))[0]
    seen = 0
    for path, spec in flat:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        if keys[-2:-1] == ["w"] and keys[-1] in ("q", "scale"):
            *prefix, leaf = keys[:-2] + [keys[-1]]  # int8 storage: the port's leaf names
        else:
            *prefix, leaf = keys
            leaf = {"w": "weight", "b": "bias", "scale": "weight"}.get(leaf, leaf)
        name = ".".join(prefix + [leaf])
        t = model.state_dict()[name]
        want = tuple(spec) + (None,) * (t.dim() - len(spec))
        if leaf in ("weight", "q") and t.dim() >= 2:  # (.., in, out) -> (.., out, in)
            want = want[:-2] + want[-2:][::-1]
        got = specs[name] + (None,) * (t.dim() - len(specs[name]))
        assert got == want, (name, got, want)
        seen += 1
    assert seen == len(specs)
    w = "q" if quant else "weight"
    assert specs[f"backbone.layers.0.mlp.experts.fc1.{w}"] == ("expert", "model", "fsdp")
    assert specs[f"backbone.layers.0.mlp.experts.fc2.{w}"] == ("expert", "fsdp", "model")
    assert specs["backbone.layers.0.mlp.router.weight"] == ()


@pytest.mark.parametrize("name", NAMES)
def test_expert_train_step(world, name):
    """One full fine-tuning step on the mesh: equal to JAX's sharded step on
    the same axes (JAX_ONE_DEVICE: its one-device step) and to the port's
    one-process step (loss, balance loss, gradients, updated tensors)."""
    i = NAMES.index(name)
    _, par, cfg, tiny = STEPS[i]
    key = "llama" if cfg is LLAMA else "gpt2"
    got = world["steps"][i]
    want = {a: par.get(f"{a}_axis", 1) for a in ("fsdp", "model", "expert")}
    data = 4 // (want["fsdp"] * want["model"] * want["expert"])
    assert got["mesh"] == {"data": data, **{a: n for a, n in want.items()
                                            if a != "expert" or n > 1}}
    jpar = {} if name in JAX_ONE_DEVICE else par
    check(got, *jax_step(cfg, tiny, world["params"][key], world["batch"], jpar), f"jax {name}",
          resolved=True)
    model, _, m = port_step(cfg, tiny, world["states"][key], world["batch"])
    check(got, m["loss"].item(), m["moe_aux"].item(),
          {n: p.grad for n, p in model.named_parameters() if p.grad is not None},
          {n: p.detach() for n, p in model.named_parameters() if p.requires_grad},
          f"one process {name}")


def test_banks_hold_their_experts_only(world):
    """Each rank's banks hold its ``E / expert`` experts (and its model and
    fsdp chunks), not every expert: the expert axis is no data parallelism
    in disguise.  The router stays whole."""
    for i, (name, par, cfg, tiny) in enumerate(STEPS):
        ep, m, f = (par.get(f"{a}_axis", 1) for a in ("expert", "model", "fsdp"))
        ring = par.get("ring_attention", False)
        mc = 1 if ring else m
        d, ff, E = tiny["d_model"], tiny["d_ff"], cfg["moe"]["experts"]
        for coords, banks in world["steps"][i]["held"]:
            for bank, (out, inp, kind) in {"fc1": (ff, d, "col"), "fc2": (d, ff, "row"),
                                           "gate": (ff, d, "col"), "up": (ff, d, "col"),
                                           "down": (d, ff, "row")}.items():
                key = f"backbone.layers.0.mlp.experts.{bank}.weight"
                if key not in banks:
                    continue
                want = (E // ep, out // mc, inp // f) if kind == "col" \
                    else (E // ep, out // f, inp // mc)
                assert banks[key] == want, (name, coords, bank, banks[key], want)


def test_checkpoint_resume_across_expert_meshes(world):
    """A checkpoint written on model 2 x expert 2 restores in one process
    (parameters and optimizer state equal to the mesh's, gathered) and on
    expert 4, whose next step equals one process's from the same checkpoint
    (``tests/test_moe.py:416-462``)."""
    saved_from = world["steps"][NAMES.index("model 2 x expert 2")]
    model = FluidLLM.build(Config(**CFG), _props(), **TINY)
    model.init_weights(torch.Generator().manual_seed(9))
    trainer = Trainer(model)
    assert ckpt.restore_checkpoint(world["saved"], 0, model, trainer.opt) == 0
    for n, p in model.named_parameters():
        assert torch.equal(saved_from["params"][n], p.detach()), n
    for i, st in trainer.opt.state_dict()["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(saved_from["opt"]["state"][i][k]),
                               torch.as_tensor(v)), (i, k)
    m = trainer.train_step(tuple(map(torch.as_tensor, world["batch"])))
    got = world["steps"][len(STEPS)]
    assert got["mesh"]["expert"] == 4
    assert got["losses"][0] == pytest.approx(m["loss"].item(), rel=1e-6)
    for n, p in model.named_parameters():
        torch.testing.assert_close(got["params"][n], p.detach(), rtol=0, atol=1e-6)


def test_int8_banks_forward_over_expert_axis(world):
    """Every linear int8 (the expert banks a scale per expert and output
    column) and cut over data 2 x expert 2: each rank holds its experts'
    int8 storage and the forward is within 1e-5 of JAX's on the expert mesh
    (``tests/test_quant.py:156-190``); served on model 2 x expert 2 (cut,
    then quantized whole and cut again), the storage equal bit for bit to
    the one-process quantization's cut and the forward within 1e-5 too."""
    params = world["params"]["gpt2"]
    states, _, _, _, pos = world["batch"]
    qparams = dict(params, backbone=jquantize_backbone(params["backbone"], "int8"))
    par = JParallel(expert_axis=2)
    jm = _jax_model(CFG, TINY, par)
    mesh = jmesh.make_mesh(par)
    sharded = jmesh.shard_params(qparams, mesh, par)
    want = np.asarray(jax.jit(jm.forward)(sharded, *jmesh.shard_batch((states, pos), mesh)))
    one = FluidLLM.build(Config(**CFG), _props(), **TINY)
    one.load_state_dict(world["states"]["gpt2"])
    quantize_backbone(one.backbone, "int8")
    whole = one.state_dict()
    for got in world["forward"]:
        np.testing.assert_allclose(got["out"].numpy(), want, atol=1e-5, rtol=1e-5)
        assert any(n.endswith("experts.fc1.q") for n in got["held"][0][1])
        for coords, storage in got["held"]:
            for n, t in storage.items():
                w = whole[n]
                if ".experts." in n:
                    e = t.shape[0]
                    w = w[coords["expert"] * e:(coords["expert"] + 1) * e]
                if "model" in coords and t.shape != w.shape:  # a model chunk
                    d = next(i for i, (a, b) in enumerate(zip(t.shape, w.shape)) if a != b)
                    k = t.shape[d]
                    w = w.narrow(d, coords["model"] * k, k)
                assert torch.equal(t, w), (coords, n)
