"""The port's mixture-of-experts backbone against the JAX package, on the CPU.

After the oracles of ``tests/test_moe.py`` that need no mesh: a tiny GPT-2
or LLaMA layout (2 layers, d 64, 4 experts), f32, weights drawn by the JAX
init and bridged by ``weights.from_jax_params``.

- The routing: the same probabilities (the JAX softmax's output, captured)
  give ``dispatch`` and ``combine`` equal bit for bit, both routers, top-1
  and top-2, ties, invalid tokens and tight capacity; the same logits give
  ``dispatch`` equal and ``combine`` within 1e-6 relative (XLA's and
  PyTorch's ``exp`` differ in the last bit);
- the MoE MLP (output 1e-5, aux 1e-6), invalid tokens that neither take
  capacity nor displace real ones, capacity drops, identical experts equal
  to the dense model;
- a train step (autoreg, gen, notf; both routers): loss, ``moe_aux`` and
  every trainable gradient, 1e-4 of each tensor's largest entry;
- the rollout, whose MoE final block runs whole (at tight capacity, where
  a sliced block would route differently), and streaming stepped frame by
  frame against the banded dense forward;
- the guards, the configs that name MoE, and the dtype transform.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid_llm_tpu.config import Config as JConfig
from fluid_llm_tpu.data.pipeline import make_batches as jmake_batches
from fluid_llm_tpu.data.synthetic import SyntheticCylinderDataset as JSynthetic
from fluid_llm_tpu.models import backbone as jbb
from fluid_llm_tpu.models.fluid_llm import FluidLLM as JFluidLLM
from fluid_llm_tpu.rollout.generate import generate as jgenerate
from fluid_llm_tpu.train.trainer import Trainer as JTrainer
from fluid_llm_tpu_torch.config import Config
from fluid_llm_tpu_torch.data import make_batches
from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
from fluid_llm_tpu_torch.models import backbone as bb
from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
from fluid_llm_tpu_torch.rollout.generate import generate
from fluid_llm_tpu_torch.train.trainer import Trainer
from fluid_llm_tpu_torch.weights import from_jax_params

torch.set_num_threads(2)

SEQ_LEN = 4
TINY = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, max_pos=128, dropout=0.0)
CFG = dict(
    llm_backbone="gpt2", half_precision=False, use_lora=False, batch_size=2,
    autoreg_seq_len=SEQ_LEN, seq_len=SEQ_LEN, resolution=64, flash_attention=False,
    pos_embedding_params={"input_emb_layer_dropout": 0.0},
    decoder_params={"type": "MLP", "num_layers": 2, "hidden_dim": 32,
                    "activation": "leakyrelu", "zero_last_layer": False},
    encoder_params={"type": "MLP", "num_layers": 2, "hidden_dim": 32, "activation": "leakyrelu"},
)
AMPLE = {"experts": 4, "top_k": 2, "capacity_factor": 8.0}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got: torch.Tensor, want, rel: float, name: str = "") -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30), err_msg=name)


def _pair(moe=AMPLE, **cfg_kw):
    """The JAX model and its params, the port model with them bridged, and
    both datasets."""
    raw = dict(CFG, moe=dict(moe), **cfg_kw)
    jds = JSynthetic(n_trajectories=2, resolution=64, seq_len=SEQ_LEN, mode="valid")
    tds = SyntheticCylinderDataset(n_trajectories=2, resolution=64, seq_len=SEQ_LEN, mode="valid")
    jmodel = JFluidLLM.build(JConfig(**raw), jds.ds_props(), **TINY)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    model = FluidLLM.build(Config(**raw), tds.ds_props(), **TINY)
    model.load_state_dict(from_jax_params(_np(params)))
    return jmodel, params, jds, model, tds


def _bcfgs(family="opt", **moe):
    kw = dict(dict(family=family, n_layers=1, d_model=8, n_heads=2, d_ff=16, dropout=0.0,
                   moe_experts=2, moe_top_k=1, moe_capacity_factor=100.0), **moe)
    if family == "llama":
        kw.update(act="silu", norm="rmsnorm", pos="rope")
    return jbb.BackboneConfig(**kw), bb.BackboneConfig(**kw)


def _mlp_pair(jcfg, cfg, seed=0):
    """A JAX ``_moe_init`` tree and the port ``MoEMLP`` holding it."""
    p = jbb._moe_init(jax.random.PRNGKey(seed), jcfg)
    mlp = bb.MoEMLP(cfg)
    mlp.load_state_dict(from_jax_params(_np(p)))
    return p, mlp


class _Capture:
    """Records the JAX ``_moe_mlp``'s softmax output and its dispatch and
    combine (the second operands of its first and last einsums), run
    eagerly with ``jax.nn.softmax`` and ``jnp.einsum`` wrapped."""

    def __init__(self, monkeypatch):
        self.probs, self.dispatch, self.combine = [], [], []
        softmax, einsum = jax.nn.softmax, jnp.einsum

        def sm(x, *a, **kw):
            out = softmax(x, *a, **kw)
            self.probs.append(np.asarray(out))
            return out

        def es(spec, *ops, **kw):
            if spec == "bld,blec->ebcd":
                self.dispatch.append(np.asarray(ops[1]))
            elif spec == "ebcd,blec->bld":
                self.combine.append(np.asarray(ops[1]))
            return einsum(spec, *ops, **kw)

        monkeypatch.setattr(jax.nn, "softmax", sm)
        monkeypatch.setattr(jnp, "einsum", es)


ROUTINGS = [dict(moe_router="topk", moe_top_k=1), dict(moe_router="topk", moe_top_k=2),
            dict(moe_router="topk", moe_top_k=3),
            dict(moe_router="expert_choice", moe_top_k=1),
            dict(moe_router="expert_choice", moe_top_k=2)]


@pytest.mark.parametrize("routing", ROUTINGS, ids=lambda r: f"{r['moe_router']}-k{r['moe_top_k']}")
@pytest.mark.parametrize("cf", [0.6, 1.25, 100.0])
@pytest.mark.parametrize("masked", [False, True])
def test_routing_equals_jax(monkeypatch, rng, routing, cf, masked):
    """Logits are the first E columns of h (the router an identity over
    them), with exact ties in some rows; the front five tokens invalid when
    ``masked`` (expert_choice may still pick them once the valid ones run
    out, at gate 0: the output cannot depend on which).  Given the same
    probabilities dispatch and combine are equal bit for bit; given the
    same logits dispatch is equal and combine within 1e-6."""
    E, d, L = 4, 8, 23
    kw = dict(family="opt", n_layers=1, d_model=d, n_heads=2, d_ff=16, moe_experts=E,
              moe_capacity_factor=cf, **routing)
    jcfg, cfg = jbb.BackboneConfig(**kw), bb.BackboneConfig(**kw)
    h = rng.normal(size=(2, L, d)).astype(np.float32) * 2
    h[0, 3, :E] = h[0, 3, 0]  # every expert tied
    h[1, 7, 1:3] = h[1, 7, 0]  # three tied
    valid = np.arange(L)[None].repeat(2, 0) >= (5 if masked else 0)
    p = jbb._moe_init(jax.random.PRNGKey(0), jcfg)
    p["router"]["w"] = jnp.asarray(np.eye(d, E, dtype=np.float32))
    cap = _Capture(monkeypatch)
    _, jaux = jbb._moe_mlp(jnp.asarray(h), p, jcfg, valid=jnp.asarray(valid))
    monkeypatch.undo()
    tvalid = torch.from_numpy(valid)
    r = bb.moe_dispatch(torch.from_numpy(cap.probs[0].copy()), cfg, tvalid)
    np.testing.assert_array_equal(r.dispatch.numpy(), cap.dispatch[0])
    np.testing.assert_array_equal(r.combine.numpy(), cap.combine[0])
    np.testing.assert_allclose(float(r.aux), float(jaux), rtol=1e-6)
    C = bb.moe_capacity(cfg, L)
    assert r.dispatch.shape == (2, L, E, C)
    if masked:  # invalid tokens take no topk slot, and no gate under expert_choice
        assert not r.combine[:, :5].any()
        assert routing["moe_router"] == "expert_choice" or not r.dispatch[:, :5].any()
    r2 = bb.moe_route(torch.from_numpy(h[..., :E].copy()), cfg, tvalid)
    np.testing.assert_array_equal(r2.dispatch.numpy(), cap.dispatch[0])
    np.testing.assert_allclose(r2.combine.numpy(), cap.combine[0], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("family", ["opt", "llama"])
@pytest.mark.parametrize("router", ["topk", "expert_choice"])
def test_moe_mlp_equals_jax(family, router):
    """``moe_mlp`` against ``_moe_mlp`` on the same weights, both
    families' banks, top-2 at a capacity that drops tokens, f32."""
    jcfg, cfg = _bcfgs(family, moe_router=router, moe_top_k=2, moe_capacity_factor=0.75,
                       moe_experts=4)
    p, mlp = _mlp_pair(jcfg, cfg)
    h = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 9, 8), jnp.float32))
    want, jaux = jbb._moe_mlp(jnp.asarray(h), p, jcfg)
    with torch.no_grad():
        got, aux = bb.moe_mlp(torch.from_numpy(h.copy()), mlp, cfg)
    _close(got, want, 1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6, atol=1e-7)


def test_routing_matches_numpy_oracle():
    """``test_moe.py``'s top-1 oracle on the port: gate probability times
    the argmax expert's FFN, per token (ample capacity)."""
    jcfg, cfg = _bcfgs()
    p, mlp = _mlp_pair(jcfg, cfg)
    hn = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 6, 8), jnp.float32))
    with torch.no_grad():
        out, aux = bb.moe_mlp(torch.from_numpy(hn), mlp, cfg)
    wr = np.asarray(p["router"]["w"])
    w1, b1 = np.asarray(p["experts"]["fc1"]["w"]), np.asarray(p["experts"]["fc1"]["b"])
    w2, b2 = np.asarray(p["experts"]["fc2"]["w"]), np.asarray(p["experts"]["fc2"]["b"])
    want = np.zeros_like(hn)
    for b in range(2):
        for t in range(6):
            logits = hn[b, t] @ wr
            probs = np.exp(logits - logits.max())
            probs /= probs.sum()
            e = int(np.argmax(probs))
            want[b, t] = probs[e] * (np.maximum(hn[b, t] @ w1[e] + b1[e], 0.0) @ w2[e] + b2[e])
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)
    assert np.isfinite(float(aux))


@pytest.mark.parametrize("router", ["topk", "expert_choice"])
def test_invalid_tokens_do_not_route(router):
    """``test_moe.py``'s padding oracle at tight capacity (cf 1): five
    garbage tokens marked invalid at the front change no valid token's
    output, with capacity sized by the real count; and the padded call
    equals the JAX one."""
    jcfg, cfg = _bcfgs(moe_router=router, moe_capacity_factor=1.0)
    p, mlp = _mlp_pair(jcfg, cfg)
    h = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 6, 8), jnp.float32))
    pad = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (2, 5, 8), jnp.float32)) * 3
    h_pad = np.concatenate([pad, h], axis=1)
    valid = np.arange(11)[None].repeat(2, 0) >= 5
    with torch.no_grad():
        ref, _ = bb.moe_mlp(torch.from_numpy(h), mlp, cfg, torch.ones(2, 6, dtype=torch.bool))
        out, aux = bb.moe_mlp(torch.from_numpy(h_pad), mlp, cfg, torch.from_numpy(valid),
                              capacity_tokens=6)
    np.testing.assert_allclose(out[:, 5:].numpy(), ref.numpy(), atol=1e-5)
    assert np.isfinite(float(aux))
    want, jaux = jbb._moe_mlp(jnp.asarray(h_pad), p, jcfg, valid=jnp.asarray(valid),
                              capacity_tokens=6)
    _close(out, want, 1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6, atol=1e-7)


def test_capacity_drops_tokens():
    """Zero router logits send every token to expert 0; at capacity 1 only
    the first token of each sequence gets an MLP contribution."""
    jcfg, cfg = _bcfgs(moe_capacity_factor=1e-6)
    p, mlp = _mlp_pair(jcfg, cfg)
    with torch.no_grad():
        mlp.router.weight.zero_()
    h = torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 6, 8))))
    with torch.no_grad():
        out, _ = bb.moe_mlp(h, mlp, cfg)
    assert out[:, 0].abs().max() > 0
    assert torch.equal(out[:, 1:], torch.zeros_like(out[:, 1:]))
    p["router"]["w"] = jnp.zeros_like(p["router"]["w"])
    _close(out, jbb._moe_mlp(jnp.asarray(h.numpy()), p, jcfg)[0], 1e-5)


def test_identical_experts_match_dense():
    """Every expert holding the dense MLP's weights, ample capacity: the
    port's MoE model equals the JAX dense model (top-2 gates sum to 1)."""
    raw = dict(CFG)
    jds = JSynthetic(n_trajectories=2, resolution=64, seq_len=SEQ_LEN, mode="valid")
    dense = JFluidLLM.build(JConfig(**raw), jds.ds_props(), **TINY)
    pd = _np(jax.jit(dense.init)(jax.random.PRNGKey(0)))
    _, pm, _, model, tds = _pair()
    pm = _np(pm)
    for ld, lm in zip(pd["backbone"]["layers"], pm["backbone"]["layers"]):
        for name in ("fc1", "fc2"):
            for leaf in ("w", "b"):
                E = lm["mlp"]["experts"][name][leaf].shape[0]
                lm["mlp"]["experts"][name][leaf] = np.broadcast_to(
                    ld["mlp"][name][leaf][None], (E,) + ld["mlp"][name][leaf].shape).copy()
        for k in ("ln1", "ln2", "attn"):
            lm[k] = ld[k]
    pm = {k: (pm[k] if k == "backbone" else pd[k]) for k in pd}
    pm["backbone"] = {k: (pd["backbone"][k] if k != "layers" else pm["backbone"]["layers"])
                      for k in pd["backbone"]}
    model.load_state_dict(from_jax_params(pm))
    states, _, _, _, pos = next(make_batches(tds, 2, shuffle=False))
    want = dense.forward(pd, jnp.asarray(states.numpy()), jnp.asarray(pos.numpy()))
    with torch.no_grad():
        got = model(states, pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_weight_bridge_covers_the_moe_tree():
    jmodel, params, _, model, _ = _pair()
    sd = from_jax_params(_np(params))
    ours = model.state_dict()
    assert sorted(sd) == sorted(ours)
    assert all(sd[k].shape == ours[k].shape for k in sd)
    assert ours["backbone.layers.0.mlp.router.weight"].shape == (4, 64)
    assert ours["backbone.layers.1.mlp.experts.fc1.weight"].shape == (4, 128, 64)
    np.testing.assert_array_equal(
        ours["backbone.layers.1.mlp.experts.fc2.weight"].numpy(),
        np.swapaxes(np.asarray(params["backbone"]["layers"][1]["mlp"]["experts"]["fc2"]["w"]),
                    1, 2))


@pytest.mark.parametrize("mode,router", [("autoreg", "topk"), ("autoreg", "expert_choice"),
                                         ("gen", "topk"), ("notf", "topk"),
                                         ("notf", "expert_choice")])
def test_train_step_matches_jax(mode, router):
    """Loss, ``moe_aux`` and every gradient against ``jax.value_and_grad``
    of ``Trainer._mode_loss`` (full fine-tuning: router and banks train).
    notf collects the rollout's aux (``test_notf_mode_collects_rollout_aux``);
    topk's aux is positive, expert_choice's 0."""
    jmodel, params, jds, model, tds = _pair(dict(AMPLE, router=router))
    jtrainer = JTrainer(jmodel)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jtrainer._mode_loss(p, b, jax.random.PRNGKey(1), mode), has_aux=True))
    (jloss, jaux), jgrads = fn(params, next(jmake_batches(jds, 2, shuffle=False)))
    trainer = Trainer(model)
    loss, aux = trainer.mode_loss(next(make_batches(tds, 2, shuffle=False)), mode)
    loss.backward()
    _close(loss, jloss, 1e-5, "loss")
    _close(aux["moe_aux"], jaux["moe_aux"], 1e-5, "moe_aux")
    assert (float(aux["moe_aux"].detach()) > 0) == (router == "topk")
    want = from_jax_params(_np(jgrads))
    top = max(float(t.abs().max()) for t in want.values())
    for n, p in model.named_parameters():
        if n.endswith("attn.k.bias"):  # zero in exact arithmetic (softmax ignores it): noise
            assert float(p.grad.abs().max()) < 1e-6 * top, n
            continue
        _close(p.grad, want[n].numpy(), 1e-4 if mode != "gen" else 5e-3, n)
    router_grad = model.backbone.layers[0].mlp.router.weight.grad
    assert router_grad.abs().sum() > 0
    assert model.backbone.layers[0].mlp.experts["fc1"].weight.grad.abs().sum() > 0


def test_rollout_uses_dense_final_block():
    """At a capacity that drops tokens (cf 0.5, where a final block sliced
    to one frame would size C by 16 tokens instead of the window's and route
    differently) the port's rollout equals the JAX one; and the sliced
    backbone refuses a MoE final block."""
    jmodel, params, jds, model, tds = _pair(dict(AMPLE, capacity_factor=0.5))
    states, _, _, bc, pos = next(jmake_batches(jds, 2, shuffle=False))
    js, jd = jgenerate(jmodel, params, states[:, :1], bc, pos, 5)
    tstates, _, _, tbc, tpos = next(make_batches(tds, 2, shuffle=False))
    ts, td = generate(model, tstates[:, :1], tbc, tpos, 5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
    n_patch = tds.ds_props().N_patch
    with pytest.raises(NotImplementedError, match="decode_slice"):
        with torch.no_grad():
            model.backbone(torch.zeros(1, 4 * n_patch, 64), decode_slice=(0, n_patch))


def test_moe_streaming_equals_banded_dense():
    """``test_moe_streaming_equals_banded_dense`` on the port: the LLaMA MoE
    backbone stepped frame by frame through ``apply_streaming`` (a ring of
    3 frames, 5 frames: eviction) equals the JAX dense ``apply`` under the
    banded mask, and so does the port's dense forward under that mask
    (``positions``/``allowed``)."""
    from test_streaming import _token_stream, llama_setup

    cfg, _, jmodel, batch = llama_setup(moe=AMPLE)
    jcfg = jmodel.backbone_cfg
    params = jmodel.init(jax.random.PRNGKey(0))
    states, _, _, _, pos_ids = batch
    bs, T, n_patch = states.shape[:3]
    R = 3
    x, positions, frame_of = _token_stream(jmodel, params, states, pos_ids)
    n_sink = 1 + n_patch
    qf, kf = frame_of[:, None], frame_of[None, :]
    causal = np.asarray(positions)[:, None] >= np.asarray(positions)[None, :]
    allowed = causal & ((kf == -1) | (kf > qf - R))
    pos_b = jnp.broadcast_to(positions[None, :], (bs, x.shape[1]))
    dense = np.asarray(jbb.apply(params["backbone"], jcfg, x, positions_override=pos_b,
                                 allowed_override=jnp.asarray(allowed)[None, None]))

    tcfg = bb.BackboneConfig(**{f: getattr(jcfg, f) for f in (
        "family", "n_layers", "d_model", "n_heads", "d_ff", "n_kv_heads", "max_pos", "act",
        "norm", "pos", "rope_theta", "ln_eps", "moe_experts", "moe_top_k",
        "moe_capacity_factor", "moe_router")}, dropout=0.0)
    model = bb.Backbone(tcfg)
    sd = from_jax_params(_np(params["backbone"]))
    model.load_state_dict(sd)
    tx, tpos = torch.from_numpy(np.asarray(x)), torch.from_numpy(np.asarray(positions))
    cache = bb.init_streaming_cache(tcfg, bs, n_sink, R, n_patch)
    with torch.no_grad():
        bb.apply_streaming(model, tx[:, :n_sink], tpos[:n_sink], cache, 0, prefill=True)
        for f in range(T):
            lo = n_sink + f * n_patch
            y, cache = bb.apply_streaming(model, tx[:, lo:lo + n_patch], tpos[lo:lo + n_patch],
                                          cache, f % R)
            np.testing.assert_allclose(y.numpy(), dense[:, lo:lo + n_patch], atol=2e-5,
                                       rtol=1e-5, err_msg=f"frame {f}")
        got = model(tx, positions=tpos[None].expand(bs, -1),
                    allowed=torch.from_numpy(allowed)[None, None])
    np.testing.assert_allclose(got.numpy(), dense, atol=2e-5, rtol=1e-5)


def test_moe_guards():
    """``FluidLLM.build`` mirrors the JAX guards; ``stack_layers`` keeps MoE
    layers unrolled; LoRA targets on the dense MLP raise on a MoE backbone."""
    props = SyntheticCylinderDataset(n_trajectories=1, resolution=64, seq_len=SEQ_LEN).ds_props()
    build = lambda **kw: FluidLLM.build(Config(**dict(CFG, **kw)), props, **TINY)
    with pytest.raises(ValueError, match="pipe_axis"):
        build(moe=AMPLE, parallel={"pipe_axis": 2})
    with pytest.raises(ValueError, match="top_k"):
        build(moe={"experts": 2, "top_k": 3})
    with pytest.raises(ValueError, match="top_k"):
        build(moe={"experts": 2, "top_k": 0})
    with pytest.raises(ValueError, match="router"):
        build(moe={"experts": 2, "router": "hash"})
    with pytest.raises(ValueError, match="expert_axis"):
        build(moe={"experts": 3, "top_k": 1}, parallel={"expert_axis": 2})
    build(moe={"experts": 4, "top_k": 1}, parallel={"expert_axis": 2})
    model = build(moe=AMPLE)
    bb.stack_layers(model.backbone)
    assert isinstance(model.backbone.layers, torch.nn.ModuleList)
    with pytest.raises(ValueError, match="MoE"):
        build(moe=AMPLE, use_lora=True,
              lora_config={"r": 2, "lora_alpha": 4, "target_modules": ["q_proj", "fc1"]})
    lora = build(moe=AMPLE, use_lora=True,
                 lora_config={"r": 2, "lora_alpha": 4, "target_modules": ["q_proj", "v_proj"]})
    assert set(lora.lora.layers[0]["attn"]) == {"q", "v"}


@pytest.mark.parametrize("name", ["moe_cylinder", "r5_moe"])
def test_published_moe_configs_build(name):
    """The two configs that name MoE build at their published widths (on
    the meta device: no memory): OPT-125m, 6 layers, 4 experts, top-2."""
    cfg = Config.from_yaml(f"configs/{name}.yaml")
    props = SyntheticCylinderDataset(n_trajectories=1, resolution=238, seq_len=10).ds_props()
    with torch.device("meta"):
        model = FluidLLM.build(cfg, props)
    bcfg = model.backbone_cfg
    assert (bcfg.n_layers, bcfg.d_model, bcfg.moe_experts, bcfg.moe_top_k) == (6, 768, 4, 2)
    assert bcfg.moe_capacity_factor == 1.25 and bcfg.moe_router == "topk"
    assert model.backbone.layers[5].mlp.experts["fc1"].weight.shape == (4, 3072, 768)
    assert model.lora is None and all(p.requires_grad for p in model.backbone.parameters())


def test_cast_matmul_params_covers_expert_banks():
    """Serving stores the banks in the activation dtype and keeps the router
    f32 (``backbone.py:282``); ``prepare_inference_params`` is exact."""
    _, _, _, model, tds = _pair()
    states, _, _, _, pos = next(make_batches(tds, 2, shuffle=False))
    with torch.no_grad():
        before = model(states, pos)
    model.prepare_inference_params()
    with torch.no_grad():
        assert torch.equal(model(states, pos), before)
    bb.cast_matmul_params(model.backbone, torch.bfloat16)
    mlp = model.backbone.layers[0].mlp
    assert mlp.router.weight.dtype == torch.float32
    assert {b.weight.dtype for b in mlp.experts.values()} == {torch.bfloat16}
    assert {b.bias.dtype for b in mlp.experts.values()} == {torch.bfloat16}
