"""GPipe pipeline stages and Megatron sequence parallelism on the CPU, against
the JAX package.

Ranks are CPU processes over gloo (``tests/torch_mesh_worker.py``, one
spawn of four ranks).  The bare backbone is ``tests/test_pipeline.py``'s
(GPT-2 layout, 4 layers, d 32, 4 heads, f32; a batch of 8 x 12 tokens, the
first 3 of row 0 invalid): the port's pipelined forward at (stages,
microbatches) in {(2, 4), (4, 4), (4, 8)} against JAX's dense ``apply``
within 2e-5 absolute, and its gradients (of ``sum(out * cot)``, a fixed
random cotangent) within 1e-4 of the largest gradient entry, as the JAX
test bounds them.  The pipelined FluidLLM train step (full fine-tuning,
pipe 2 x data 2, 4 microbatches) and the sequence-parallel step (model 2 x
fsdp 2) use ``tests/test_torch_parallel.py``'s model and batch, held to
JAX's and the port's one-process steps with that file's bounds.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid_llm_tpu.models import backbone as jbb
from fluid_llm_tpu_torch.config import Config, ParallelConfig
from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
from fluid_llm_tpu_torch.models import backbone as bb
from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
from fluid_llm_tpu_torch.ops.quant import QuantLinear
from fluid_llm_tpu_torch.parallel import comm, mesh as pmesh
from fluid_llm_tpu_torch.parallel.pipeline import Stages, check_stackable, stage_layers
from fluid_llm_tpu_torch.train import checkpoint as ckpt
from fluid_llm_tpu_torch.weights import from_jax_params

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_parallel import (CFG, TINY, batch8, check, jax_params, jax_step,  # noqa: E402
                                 port_step)
from torch_mesh_worker import spawn  # noqa: E402

torch.set_num_threads(2)

BB = dict(family="gpt2", n_layers=4, d_model=32, n_heads=4, d_ff=64)
PIPES = [(2, 4), (4, 4), (4, 8)]
FULL = dict(CFG, use_lora=False)
PIPE = {"pipe_axis": 2, "pipe_microbatches": 4}


def _unstack(stacked: dict) -> dict:
    """Port tensors of a stacked tree (``backbone.layers.<leaf>`` leading
    with the layer) under the list layout's names."""
    out = {}
    for n, t in stacked.items():
        if n.startswith("backbone.layers.") and not n.split(".")[2].isdigit():
            for i in range(t.shape[0]):
                out[n.replace("backbone.layers.", f"backbone.layers.{i}.", 1)] = t[i]
        else:
            out[n] = t
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    jcfg = jbb.BackboneConfig(**BB, dtype=jnp.float32)
    jparams = jbb.init_params(jax.random.PRNGKey(0), jcfg)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, 12, 32), jnp.float32))
    valid = np.ones((8, 12), bool)
    valid[0, :3] = False
    cot = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (8, 12, 32), jnp.float32))
    out_ref = jbb.apply(jparams, jcfg, jnp.asarray(x), jnp.asarray(valid))
    jgrads = jax.jit(jax.grad(
        lambda p: jnp.sum(jbb.apply(p, jcfg, jnp.asarray(x), jnp.asarray(valid)) * cot)))(jparams)
    state = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams))
    lcfg = dict(family="llama", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4, d_ff=64,
                norm="rmsnorm", pos="rope", act="silu", dtype=torch.bfloat16)
    llama = bb.Backbone(bb.BackboneConfig(**lcfg))
    llama.reset_parameters(torch.Generator().manual_seed(0))
    bf16 = dict(bcfg=lcfg, state=llama.to(torch.bfloat16).state_dict(),
                x=torch.randn(4, 8, 32, generator=torch.Generator().manual_seed(1)).bfloat16())

    params = jax_params(CFG, TINY)
    fstate = from_jax_params(params)
    batch = batch8()
    tb = tuple(map(torch.as_tensor, batch))
    saved = str(tmp / "ckpt")
    variants = [dict(parallel=PIPE, cfg={"use_lora": False}, save=saved),
                dict(parallel={"model_axis": 2, "fsdp_axis": 2, "seq_sharded_acts": True}),
                dict(parallel={"model_axis": 2, "fsdp_axis": 2})]
    jobs = [("backbone", dict(bcfg=dict(BB, dtype=torch.float32), state=state,
                              x=torch.tensor(x), valid=torch.tensor(valid),
                              cot=torch.tensor(cot), pipes=PIPES, bf16=bf16)),
            ("steps", dict(variants=variants, cfg=CFG, tiny=TINY, state=fstate, batch=tb))]
    res = spawn("jobs", 4, str(tmp / "run"), jobs=jobs)
    return dict(res=res, out_ref=np.asarray(out_ref), jgrads=from_jax_params(
        jax.tree_util.tree_map(np.asarray, jgrads)), state=state, x=x, valid=valid, cot=cot,
        params=params, fstate=fstate, batch=batch, saved=saved)


def test_pipe_mesh_axes():
    mesh = pmesh.make_mesh(ParallelConfig(pipe_axis=4), world=8, rank=0)
    assert mesh.shape == {"data": 2, "fsdp": 1, "model": 1, "pipe": 4}
    # pipe stays LAST so stage hops are neighbouring ranks
    assert mesh.axis_names[-1] == "pipe"
    assert mesh.group("pipe").ranks == [0, 1, 2, 3]


@pytest.mark.parametrize("n_pipe,n_mb", PIPES)
def test_pipelined_forward_matches_dense(world, n_pipe, n_mb):
    got = world["res"][0][(n_pipe, n_mb)]["out"]
    np.testing.assert_allclose(got.numpy(), world["out_ref"], atol=2e-5)
    dense = bb.Backbone(bb.BackboneConfig(**BB))
    dense.load_state_dict(world["state"])
    with torch.no_grad():
        want = dense(torch.from_numpy(world["x"]), torch.from_numpy(world["valid"]), kernels=False)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_pipelined_grads_match_dense(world):
    """Every stage's block gradients (4 stages, 4 microbatches) against
    JAX's dense backward, and the input's gradient against the port's."""
    got = world["res"][0][(4, 4)]
    want = {n: t for n, t in world["jgrads"].items() if n.startswith("layers.")}
    assert {n for n in got["grads"] if n.startswith("layers.")} == want.keys()
    scale = max(float(t.abs().max()) for t in want.values())
    for n, t in want.items():
        assert float((got["grads"][n] - t).abs().max()) < 1e-4 * scale, n
    # the learned positions, before the stages, on every pipe rank alike
    np.testing.assert_allclose(got["grads"]["pos_embed"].numpy(), world["jgrads"]["pos_embed"],
                               rtol=0, atol=1e-4 * scale)
    dense = bb.Backbone(bb.BackboneConfig(**BB))
    dense.load_state_dict(world["state"])
    x = torch.from_numpy(world["x"]).requires_grad_(True)
    (dense(x, torch.from_numpy(world["valid"]), kernels=False)
     * torch.from_numpy(world["cot"])).sum().backward()
    torch.testing.assert_close(got["dx"], x.grad, rtol=0, atol=1e-5)


def test_pipelined_bf16_grads_compile(world):
    """A bf16 LLaMA-layout pipeline (2 stages, 2 microbatches) runs forward
    and backward to finite values (the stages hop bf16 activations)."""
    assert world["res"][0]["bf16"] is True


def test_pipe_param_specs_lead_with_pipe():
    model = FluidLLM.build(Config(**FULL), SyntheticCylinderDataset(
        n_trajectories=1, resolution=64, seq_len=4).ds_props(), **TINY)
    model.requires_grad_(False)
    bb.stack_layers(model.backbone)
    specs = pmesh.param_specs(model, ParallelConfig(model_axis=2, pipe_axis=2))
    # JAX P("pipe", None, "model") on (n_layers, in, out)
    assert specs["backbone.layers.attn.q.weight"] == ("pipe", "model", None)
    assert specs["backbone.layers.ln1.weight"] == ("pipe",)
    assert specs["backbone.final_norm.weight"] == ()


def test_pipelined_train_step(world):
    """Full fine-tuning on pipe 2 x data 2, 4 microbatches: equal to JAX's
    pipelined step and to the port's one-process step (loss, every
    gradient, updated parameters)."""
    got = world["res"][1][0]
    assert got["mesh"] == {"data": 2, "fsdp": 1, "model": 1, "pipe": 2}
    jcfg = dict(FULL)
    loss, grads, new = jax_step(jcfg, TINY, jax_params(dict(jcfg, parallel=PIPE), TINY),
                                world["batch"], 1, 1, **PIPE)
    check(got, loss, _unstack(grads), _unstack(new), "jax pipe")
    model, _, losses = port_step(FULL, TINY, world["fstate"], world["batch"])
    check(got, losses[0], {n: p.grad for n, p in model.named_parameters() if p.grad is not None},
          {n: p.detach() for n, p in model.named_parameters() if p.requires_grad}, "pipe one")


def test_seq_sharded_acts_matches_dense(world):
    """Megatron sequence parallelism (tokens over the model axis between the
    linears, 81 tokens padded to 82) on model 2 x fsdp 2: the same step as
    without it, and as JAX's sequence-sharded step."""
    sp, tp = world["res"][1][1], world["res"][1][2]
    assert sp["losses"][0] == pytest.approx(tp["losses"][0], rel=1e-5)
    check(sp, *jax_step(CFG, TINY, world["params"], world["batch"], 2, 2,
                        seq_sharded_acts=True), "jax sp")


def test_pipe_rejects_lora():
    props = SyntheticCylinderDataset(n_trajectories=1, resolution=64, seq_len=4).ds_props()
    with pytest.raises(ValueError, match="full-FT"):
        FluidLLM.build(Config(**CFG, parallel=PIPE), props, **TINY)


def test_pipe_guards():
    """The JAX guards, with their messages: layers not divisible by stages,
    batch not divisible by microbatches (under autograd), in-backbone
    dropout and LoRA trees at the forward, layers that do not stack."""
    with pytest.raises(ValueError, match="not divisible by 2 stages"):
        stage_layers(3, 2, 0)
    stages = Stages(comm.Group([0, 1], 0), range(2), 4)
    with pytest.raises(ValueError, match="not divisible by 4 microbatches"):
        stages.microbatches(6)
    with torch.no_grad():
        assert stages.microbatches(1) == 1  # a rollout's single trajectory
    backbone = bb.Backbone(bb.BackboneConfig(**BB, dropout=0.1))
    backbone.parallel = bb.BackboneParallel(cfg=backbone.cfg, pipe=stages)
    x = torch.zeros(4, 6, 32)
    with pytest.raises(ValueError, match="dropout-free"):
        backbone(x, generator=torch.Generator())
    with pytest.raises(ValueError, match="LoRA"):
        backbone(x, lora=object())
    mixed = bb.Backbone(bb.BackboneConfig(**BB))
    mixed.layers[1].attn["q"] = QuantLinear.from_linear(mixed.layers[1].attn["q"])
    with pytest.raises(ValueError, match="stackable"):
        check_stackable(mixed)
    check_stackable(bb.Backbone(bb.BackboneConfig(**BB)))


def test_unstack_roundtrip_and_pipeline_checkpoint_serves(world):
    """``unstack_layers`` inverts ``stack_layers`` bit for bit, and a
    checkpoint written by the pipeline mesh (each stage's blocks gathered
    to rank 0) restores in one process, its parameters equal to the mesh's
    and its prepared forward equal to the one-process step's model's."""
    props = SyntheticCylinderDataset(n_trajectories=1, resolution=64, seq_len=4).ds_props()
    model = FluidLLM.build(Config(**FULL), props, **TINY)
    model.load_state_dict({k: v for k, v in world["fstate"].items() if k in model.state_dict()})
    before = {k: v.clone() for k, v in model.backbone.state_dict().items()}
    model.requires_grad_(False)
    bb.stack_layers(model.backbone)
    assert isinstance(model.backbone.layers, bb.StackedLayers)
    bb.unstack_layers(model.backbone)
    for k, v in model.backbone.state_dict().items():
        assert torch.equal(v, before[k]), k

    served = FluidLLM.build(Config(**FULL), props, **TINY)
    ckpt.restore_checkpoint(world["saved"], 0, served)
    got = world["res"][1][0]
    for n, p in served.named_parameters():
        assert torch.equal(p.detach(), got["params"][n]), n
    one, _, _ = port_step(FULL, TINY, world["fstate"], world["batch"])
    batch = tuple(map(torch.as_tensor, world["batch"]))
    outs = []
    for m in (served, one):
        m.prepare_inference_params()
        with torch.no_grad():
            outs.append(m.eval()(batch[0], batch[4]))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-5)
