"""Ring attention (context parallelism over the model axis) on the CPU,
against the JAX package.

Ranks are CPU processes over gloo (``tests/torch_mesh_worker.py``, one
spawn of four ranks), K/V chunks travelling the ring by point-to-point
hops.  As ``tests/test_ring.py``: the ring over model 4 against JAX's dense
masked attention (``backbone._attention_xla`` under ``make_masks``), the
forward within 2e-5 absolute / 1e-5 relative on valid rows (with 0 and 7
front-invalid tokens), the gradients of a masked quadratic loss within
5e-5 absolute / 1e-4 relative; the train step with
``parallel.ring_attention`` on model 4 (``tests/test_torch_parallel.py``'s
model with full fine-tuning, BOS and see-init off: 64 tokens; on: 81
padded to 84) against JAX's ring step and the port's one-process step
within that file's bounds.  Port only: a MoE backbone under the ring
(capacity sized by the unpadded tokens) and every dropout on, each equal
to one process.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid_llm_tpu.models import backbone as jbb
from fluid_llm_tpu_torch.config import Config
from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
from fluid_llm_tpu_torch.weights import from_jax_params

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_parallel import (CFG, DROPOUT, TINY, batch8, check, jax_params,  # noqa: E402
                                 jax_step, port_step)
from torch_mesh_worker import spawn  # noqa: E402

torch.set_num_threads(2)

FULL = dict(CFG, use_lora=False)
NO_BOS = dict(FULL, use_bos_token=False, see_init_state=False)  # 4 frames x 16 patches
RING4 = {"model_axis": 4, "seq_sharded_acts": True, "ring_attention": True}
RING2 = {"model_axis": 2, "seq_sharded_acts": True, "ring_attention": True}
MOE = dict(CFG, moe={"experts": 4, "top_k": 2, "capacity_factor": 1.25})


def _rand_qkv(key, bs=2, L=32, H=4, hd=8):
    kq, kk, kv = jax.random.split(key, 3)
    return tuple(np.asarray(jax.random.normal(k, (bs, L, H, hd), jnp.float32))
                 for k in (kq, kk, kv))


def _valid(bs, L, n_invalid):
    return np.repeat((np.arange(L) >= n_invalid)[None], bs, 0)


def _moe_state() -> dict:
    model = FluidLLM.build(Config(**MOE), SyntheticCylinderDataset(
        n_trajectories=1, resolution=64, seq_len=4).ds_props(), **TINY)
    model.init_weights(torch.Generator().manual_seed(4))
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith(".B"):
                p.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(5))
    return model.state_dict()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    ring = {}
    for n_invalid, seed in ((0, 0), (7, 0), (5, 1)):
        q, k, v = _rand_qkv(jax.random.PRNGKey(seed))
        valid = _valid(2, 32, n_invalid)
        w = valid[:, :, None, None].astype(np.float32)
        ring[f"inv{n_invalid}"] = tuple(map(torch.tensor, (q, k, v, valid, w)))
    uneven = tuple(torch.tensor(t) for t in _rand_qkv(jax.random.PRNGKey(2), L=30))

    params, nparams = jax_params(FULL, TINY), jax_params(NO_BOS, TINY)
    batch = tuple(b[:4] for b in batch8())  # the batch of 2, twice
    tb = tuple(map(torch.as_tensor, batch))
    moe = _moe_state()
    variants = [dict(parallel=RING4, cfg=NO_BOS, state=from_jax_params(nparams)),
                dict(parallel=RING4, cfg=FULL, state=from_jax_params(params)),
                dict(parallel=RING2, cfg=MOE, state=moe),
                dict(parallel=RING4, cfg=DROPOUT, tiny={"dropout": 0.1},
                     state=from_jax_params(jax_params(CFG, TINY)))]
    jobs = [("backbone", dict(bcfg=dict(family="gpt2", n_layers=1, d_model=8, n_heads=1,
                                        d_ff=8), state={}, ring=ring, uneven=uneven)),
            ("steps", dict(variants=variants, cfg=CFG, tiny=TINY, state=None, batch=tb))]
    res = spawn("jobs", 4, str(tmp / "run"), jobs=jobs)
    return dict(res=res, ring=ring, params=params, nparams=nparams, batch=batch, moe=moe)


def _dense(q, k, v, valid):
    _, allowed = jbb.make_masks(jnp.asarray(valid))
    return jbb._attention_xla(q, k, v, allowed, jnp.float32)


@pytest.mark.parametrize("n_invalid", [0, 7])
def test_ring_matches_dense_forward(world, n_invalid):
    """The ring over model 4 equals dense attention, also with the
    rollout's front-invalid window slots."""
    q, k, v, valid, _ = (t.numpy() for t in world["ring"][f"inv{n_invalid}"])
    dense = np.asarray(_dense(q, k, v, valid))
    got = world["res"][0]["ring"][f"inv{n_invalid}"]["out"].numpy()
    np.testing.assert_allclose(got[valid], dense[valid], atol=2e-5, rtol=1e-5)


def test_ring_matches_dense_gradients(world):
    """d/dq, d/dk, d/dv of a masked quadratic loss: the reverse ring with dK
    and dV travelling home."""
    q, k, v, valid, w = (t.numpy() for t in world["ring"]["inv5"])
    gd = jax.jit(jax.grad(lambda q, k, v: jnp.sum((_dense(q, k, v, valid) * w) ** 2),
                          argnums=(0, 1, 2)))(q, k, v)
    for a, b, name in zip(world["res"][0]["ring"]["inv5"]["grads"], gd, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5, rtol=1e-4,
                                   err_msg=f"d{name}")


def test_ring_rejects_uneven_tokens(world):
    assert "not divisible" in world["res"][0]["ring"]["uneven"]


def test_ring_train_step_matches_dense(world):
    """A train step with ring attention on model 4 (64 tokens, 16 a rank)
    equals JAX's ring step and the port's one-process step."""
    got = world["res"][1][0]
    assert got["mesh"] == {"data": 1, "fsdp": 1, "model": 4}
    check(got, *jax_step(NO_BOS, TINY, world["nparams"], world["batch"], 4, 1,
                         seq_sharded_acts=True, ring_attention=True), "jax ring")
    model, _, losses = port_step(NO_BOS, TINY, from_jax_params(world["nparams"]), world["batch"])
    check(got, losses[0], {n: p.grad for n, p in model.named_parameters() if p.grad is not None},
          {n: p.detach() for n, p in model.named_parameters() if p.requires_grad}, "ring one")


def test_ring_train_step_pads_odd_tokens(world):
    """BOS and see-init on: 81 tokens padded with invalid ones to 84 over
    model 4 (trimmed after): still the dense step."""
    got = world["res"][1][1]
    check(got, *jax_step(FULL, TINY, world["params"], world["batch"], 4, 1,
                         seq_sharded_acts=True, ring_attention=True), "jax ring padded")
    model, _, losses = port_step(FULL, TINY, from_jax_params(world["params"]), world["batch"])
    check(got, losses[0], {n: p.grad for n, p in model.named_parameters() if p.grad is not None},
          {n: p.detach() for n, p in model.named_parameters() if p.requires_grad}, "padded one")


def test_ring_moe_capacity_by_real_tokens(world):
    """A MoE backbone (4 experts, top-2) under the ring over model 2 x data
    2: each rank routes the whole sequence with capacity sized by the 81
    real tokens (not the 82 padded), so the step, its balance loss
    included, is one process's."""
    got = world["res"][1][2]
    model, _, losses = port_step(MOE, TINY, world["moe"], world["batch"])
    check(got, losses[0], {n: p.grad for n, p in model.named_parameters() if p.grad is not None},
          {n: p.detach() for n, p in model.named_parameters() if p.requires_grad}, "moe ring")


def test_ring_dropout_draws_of_one_process(world):
    got = world["res"][1][3]
    model, _, losses = port_step(dict(CFG, **DROPOUT), dict(TINY, dropout=0.1),
                                 from_jax_params(jax_params(CFG, TINY)), world["batch"])
    check(got, losses[0], {n: p.grad for n, p in model.named_parameters() if p.grad is not None},
          {n: p.detach() for n, p in model.named_parameters() if p.requires_grad}, "ring dropout")


def test_ring_requires_seq_sharding():
    props = SyntheticCylinderDataset(n_trajectories=1, resolution=64, seq_len=4).ds_props()
    model = FluidLLM.build(Config(**NO_BOS, parallel={"ring_attention": True}), props, **TINY)
    model.init_weights(torch.Generator().manual_seed(0))
    states, pos = (torch.as_tensor(batch8()[i][:2]) for i in (0, 4))
    with pytest.raises(ValueError, match="seq_sharded_acts"):
        model(states, pos)
