"""The port's remaining training surface against the JAX package, on the CPU:
``notf`` training through the differentiated rollout, ``parallel.remat``,
the MLPGNN decoder's attention dropout, the CNN patch encoder and decoder,
adafactor and gradient accumulation (against optax), their checkpoints, and
the figures of ``val_plot_dir`` and ``inference --plot_dir``.

The model is the tiny configuration of ``tests/test_torch_slice.py`` (GPT-2
layout, 2 layers, d 64, DoRA with non-zero ``B``, BOS, see-init, MLPGNN,
f32), weights carried by ``weights.from_jax_params``; the CNN model is cut
to patches of 4x4 so that ``patch_in_dim == llm_dim`` (48).

Tolerances (f32), each stated where it is used: the notf loss within 1e-5
relative and every trainable gradient within 1e-3 of its tensor's largest
entry (measured up to 6.2e-4, on the first GATv2 conv's ``lin_r``); with
the GATv2 activation made smooth (slope 1 on both sides) every gradient
entry within 1e-4 relative (measured 1.3e-7 of its tensor's largest entry
at most);
remat against no remat bit for bit (the same operations recomputed); the
dropout path and the CNN modules within 1e-5 absolute; the CNN
model's forward and 3-step rollout within 1e-4; optimizer parameters within
1e-6 absolute of optax's; checkpoint resumes bit for bit.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from fluid_llm_tpu.config import Config as JConfig
from fluid_llm_tpu.config import DecoderConfig as JDecoderConfig
from fluid_llm_tpu.config import EncoderConfig as JEncoderConfig
from fluid_llm_tpu.data.ds_props import DSProps as JDSProps
from fluid_llm_tpu.data.pipeline import make_batches as jmake_batches
from fluid_llm_tpu.data.synthetic import SyntheticCylinderDataset as JSynthetic
from fluid_llm_tpu.models.decoders import patch_decoder_apply, patch_decoder_init
from fluid_llm_tpu.models.embeddings import patch_encoder_apply, patch_encoder_init
from fluid_llm_tpu.models.fluid_llm import FluidLLM as JFluidLLM
from fluid_llm_tpu.ops import grid_gnn as jgnn
from fluid_llm_tpu.ops import grid_gnn_pallas as jgnn_pallas
from fluid_llm_tpu.rollout.generate import generate as jgenerate
from fluid_llm_tpu.train.optim import build_optimizer as jbuild_optimizer
from fluid_llm_tpu.train.optim import set_learning_rate as jset_learning_rate
from fluid_llm_tpu.train.trainer import Trainer as JTrainer
from fluid_llm_tpu_torch import inference
from fluid_llm_tpu_torch.config import Config, DecoderConfig, EncoderConfig
from fluid_llm_tpu_torch.data import make_batches
from fluid_llm_tpu_torch.data.ds_props import DSProps
from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
from fluid_llm_tpu_torch.models.decoders import PatchDecoder
from fluid_llm_tpu_torch.models.embeddings import PatchEncoder
from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
from fluid_llm_tpu_torch.ops import flash_attention as fa
from fluid_llm_tpu_torch.ops import grid_gnn_fused as gf
from fluid_llm_tpu_torch.ops.grid_gnn import GATv2Conv, slot_attention_dropout
from fluid_llm_tpu_torch.ops.grid_gnn_fused import slot_attention_ref
from fluid_llm_tpu_torch.rollout.generate import generate
from fluid_llm_tpu_torch.tools import plotting
from fluid_llm_tpu_torch.train import checkpoint as ckpt
from fluid_llm_tpu_torch.train.loop import train_run
from fluid_llm_tpu_torch.train.optim import Adafactor, MultiSteps, build_optimizer, \
    factored_dims, set_learning_rate
from fluid_llm_tpu_torch.train.trainer import Trainer
from fluid_llm_tpu_torch.weights import from_jax_params
from test_torch_slice import CFG, SEQ_LEN, TINY

torch.set_num_threads(2)

NO_DROPOUT = dict(CFG, flash_attention=True,
                  lora_config={**CFG["lora_config"], "lora_dropout": 0.0},
                  pos_embedding_params={"input_emb_layer_dropout": 0.0})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got: torch.Tensor, want, rel: float, name: str = "") -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30), err_msg=name)


@pytest.fixture(scope="module")
def pair():
    cfg = Config(**NO_DROPOUT)
    jds = JSynthetic(n_trajectories=2, resolution=64, seq_len=SEQ_LEN, mode="valid")
    tds = SyntheticCylinderDataset(n_trajectories=2, resolution=64, seq_len=SEQ_LEN, mode="valid")
    jmodel = JFluidLLM.build(cfg, jds.ds_props(), **TINY)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    for layer in params["lora"]["layers"]:
        for leaf in layer["attn"].values():
            leaf["B"] = jnp.asarray(rng.normal(size=leaf["B"].shape).astype(np.float32) * 0.05)
    return jmodel, params, jds, tds


def _port_model(params, tds, **cfg_kw) -> FluidLLM:
    model = FluidLLM.build(Config(**dict(NO_DROPOUT, **cfg_kw)), tds.ds_props(), **TINY)
    model.load_state_dict(from_jax_params(_np(params)))
    return model


def _notf(model, batch):
    model.zero_grad(set_to_none=True)
    loss, aux = Trainer(model).mode_loss(batch, "notf")
    loss.backward()
    return loss, aux, {n: p.grad.clone() for n, p in model.named_parameters() if p.requires_grad}


def test_notf_loss_and_gradients_match_jax(pair):
    """``notf``: the loss through the 4-step rollout from the first state,
    differentiated end to end, against ``jax.value_and_grad`` of
    ``Trainer._mode_loss(..., mode="notf")``.  Loss and metrics within 1e-5
    relative; every trainable gradient within 1e-3 of its largest entry: f32
    sums in another order feed each next step's inputs, ~1e-7 apart, which
    moves a few GATv2 pixels across leaky-ReLU's kink (slope 1 vs 0.2), as
    in ``gen`` (``test_torch_train.py``, 5e-3); measured at most 6.2e-4
    (``decoder.gnn.convs.0.lin_r.weight``), 1e-4 or less elsewhere but the
    decoder MLP's last layer (1.9e-4).  The kink is the cause:
    ``test_notf_gradients_match_jax_with_a_smooth_activation`` takes it away
    and the gradients then agree to 1e-4 relative."""
    jloss, jaux, want, loss, aux, grads = _notf_pair(pair)
    _close(loss, jloss, 1e-5, "loss")
    for k in ("MAE", "MSE", "N_RMSE"):
        _close(aux[k], jaux[k], 1e-5, k)
    assert grads and {n.split(".")[0] for n in grads} == {"lora", "input_emb", "decoder", "bos"}
    for n, g in grads.items():
        _close(g, want[n].numpy(), 1e-3, n)


def _notf_pair(pair):
    """The notf loss, metrics and trainable gradients of the JAX trainer and
    of the port on the same weights and batch."""
    jmodel, params, jds, tds = pair
    jtrainer = JTrainer(jmodel)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jtrainer._mode_loss(p, b, jax.random.PRNGKey(1), "notf"), has_aux=True))
    (jloss, jaux), jgrads = fn(params, next(jmake_batches(jds, 2, shuffle=False)))
    model = _port_model(params, tds)
    loss, aux, grads = _notf(model, next(make_batches(tds, 2, shuffle=False)))
    return jloss, jaux, from_jax_params(_np(jgrads)), loss, aux, grads


def test_notf_gradients_match_jax_with_a_smooth_activation(pair, monkeypatch):
    """The notf gradients of the test above, with GATv2's leaky ReLU given
    slope 1 (the identity: no kink) in both packages' slot attention (the
    modules' ``NEG_SLOPE``; nothing else changes).  Every trainable gradient
    entry then agrees within 1e-4 relative (``rtol`` 1e-4, and ``atol`` 1e-6
    of the tensor's largest entry for entries near 0): the 6.2e-4 above
    comes from pixels on the two sides of the kink.  The ``lin_r`` leaves
    are held apart: with slope 1, ``att . lin_r(x_i)`` adds the same logit
    to all five slots of a pixel, which the softmax cancels, so their exact
    gradient is 0; both sides' must be rounding, below 1e-6 of the same
    conv's ``lin_l`` gradient (measured 1.3e-9)."""
    for mod in (jgnn, jgnn_pallas, gf):
        monkeypatch.setattr(mod, "NEG_SLOPE", 1.0)
    jloss, jaux, want, loss, aux, grads = _notf_pair(pair)
    _close(loss, jloss, 1e-5, "loss")
    for n, g in grads.items():
        w = want[n].numpy()
        if ".lin_r." in n:
            scale = np.linalg.norm(want[n.replace(".lin_r.", ".lin_l.")].numpy())
            assert np.linalg.norm(g.numpy()) <= 1e-6 * scale, n
            assert np.linalg.norm(w) <= 1e-6 * scale, n
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-6 * np.abs(w).max(),
                                       err_msg=n)


def _count_calls(monkeypatch):
    """Count the calls of every kernel wrapper the notf path reaches (on
    CPU tensors they run their twins)."""
    counts = {}
    for mod, name in ((fa, "flash_forward"), (fa, "flash_backward"),
                      (gf, "fused_slot_attention"), (gf, "slot_attention_bwd")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return counts


def test_notf_remat_equal_and_call_pattern(pair, monkeypatch):
    """``parallel.remat`` recomputes each rollout step's forward in the
    backward: loss and gradients equal those without it, bit for bit; the
    kernel wrappers run per step: the full layers' flash forward (twice
    with remat), its backward once (dq and dk/dv on the card), the decoder's
    slot forward (twice with remat) and backward once."""
    _, _, _, tds = pair
    batch = next(make_batches(tds, 2, shuffle=False))
    n_steps, full_layers, convs = SEQ_LEN - 1, TINY["n_layers"] - 1, 2
    res = {}
    for remat in (False, True):
        counts = _count_calls(monkeypatch)
        # bf16 and heads of 32: the shapes the flash kernels take
        model = FluidLLM.build(Config(**dict(NO_DROPOUT, half_precision=True,
                                             parallel={"remat": remat})),
                               tds.ds_props(), **dict(TINY, n_heads=2))
        model.init_weights(torch.Generator().manual_seed(0))
        assert model.backbone_cfg.remat is remat
        res[remat] = _notf(model, batch)
        fwd = 2 if remat else 1
        assert counts == {"flash_forward": fwd * full_layers * n_steps,
                          "flash_backward": full_layers * n_steps,
                          "fused_slot_attention": fwd * convs * n_steps,
                          "slot_attention_bwd": convs * n_steps}, (remat, counts)
    assert torch.equal(res[False][0], res[True][0])
    for n, g in res[False][2].items():
        assert torch.equal(g, res[True][2][n]), n


def test_block_remat_replays_dropout(pair):
    """With ``parallel.remat`` each backbone block of a training forward is
    rematerialised; its dropout masks are drawn again from the same
    generator state, so the autoreg loss and gradients with every dropout
    on equal those without remat, bit for bit, and the generator ends where
    it would have."""
    _, params, _, tds = pair
    batch = next(make_batches(tds, 2, shuffle=False))
    res, states = {}, {}
    for remat in (False, True):
        model = FluidLLM.build(Config(**dict(CFG, flash_attention=True,
                                             parallel={"remat": remat})),
                               tds.ds_props(), **dict(TINY, dropout=0.1))
        model.load_state_dict(from_jax_params(_np(params)))
        trainer = Trainer(model)
        trainer.generator.manual_seed(11)
        loss, _ = trainer.mode_loss(batch, "autoreg")
        loss.backward()
        res[remat] = (loss, {n: p.grad for n, p in model.named_parameters() if p.requires_grad})
        states[remat] = trainer.generator.get_state()
    assert torch.equal(res[False][0], res[True][0])
    for n, g in res[False][1].items():
        assert torch.equal(g, res[True][1][n]), n
    assert torch.equal(states[False], states[True])


@pytest.mark.parametrize("rate", [0.3, 0.0])
def test_slot_attention_dropout_matches_jax(rng, monkeypatch, rate):
    """The explicit-alpha path with a given keep mask against the JAX
    ``gatv2_conv_apply`` dropout path, the same mask injected there through
    ``jax.random.bernoulli`` (atol 1e-5).  At rate 0 with every slot kept it
    equals the path without dropout (``slot_attention_ref``)."""
    heads, cdim, in_dim = 2, 3, 5
    jp = jgnn.gatv2_conv_init(jax.random.PRNGKey(2), in_dim, cdim, heads=heads)
    x = rng.normal(size=(2, 6, 5, in_dim)).astype(np.float32)
    keep = rng.random(size=(2, 6, 5, 5, heads)) < 1.0 - rate
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(keep))
    want = jgnn.gatv2_conv_apply(jp, jnp.asarray(x), heads, cdim, dropout=max(rate, 1e-9),
                                 rng=jax.random.PRNGKey(0))
    conv = GATv2Conv(in_dim, cdim, heads=heads)
    conv.load_state_dict(from_jax_params(_np(jp)))
    tx = torch.from_numpy(x)
    xl, xr = conv.lin_l(tx), conv.lin_r(tx)
    got = slot_attention_dropout(xl, xr, conv.att, heads, cdim, torch.from_numpy(keep),
                                 max(rate, 1e-9)) + conv.bias
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    if rate == 0.0:
        plain = slot_attention_ref(xl, xr, conv.att, heads, cdim)
        full = slot_attention_dropout(xl, xr, conv.att, heads, cdim, torch.ones_like(
            torch.from_numpy(keep)), 0.0)
        np.testing.assert_allclose(full.detach().numpy(), plain.detach().numpy(), atol=1e-6)
    # the conv draws its mask from the generator it is given, the kernel path without one
    gen = torch.Generator().manual_seed(3)
    drawn = torch.rand((2, 6, 5, 5, heads), generator=torch.Generator().manual_seed(3)) \
        < 1.0 - 0.3
    np.testing.assert_array_equal(
        conv(tx, dropout=0.3, generator=gen).detach().numpy(),
        (slot_attention_dropout(xl, xr, conv.att, heads, cdim, drawn, 0.3)
         + conv.bias).detach().numpy())


def test_decoder_dropout_trains_and_validates_through_slot_attention(pair, monkeypatch):
    """``decoder_params.dropout`` > 0: the training forward takes the
    dropout path (no slot-attention wrapper call), the validation rollout
    the wrapper (a call per conv and step), and a step trains."""
    _, params, _, tds = pair
    model = FluidLLM.build(Config(**dict(
        NO_DROPOUT, decoder_params={**CFG["decoder_params"], "dropout": 0.1})),
        tds.ds_props(), **TINY)
    model.load_state_dict(from_jax_params(_np(params)))
    batch = next(make_batches(tds, 2, shuffle=False))
    counts = _count_calls(monkeypatch)
    trainer = Trainer(model)
    m = trainer.train_step(batch)
    assert torch.isfinite(m["loss"]) and "fused_slot_attention" not in counts
    assert model.decoder.gnn.out.att.grad.abs().sum() > 0
    trainer.val_step(batch)  # a rollout of SEQ_LEN - 1 steps
    assert counts["fused_slot_attention"] == 2 * (SEQ_LEN - 1)


CNN_PROPS = dict(Nx_patch=3, Ny_patch=2, patch_size=(4, 4), seq_len=3)


def test_cnn_encoder_and_decoder_match_jax(rng):
    """The CNN patch encoder (3x3 convs over each patch, mean-pooled) and the
    CNN decoder (Conv1d over the raw-reshaped token stream), weights carried
    by ``from_jax_params`` (HWIO / WIO -> torch's layout): atol 1e-5.  The
    decoder refuses ``patch_in_dim != llm_dim`` as the JAX one does."""
    props, jprops = DSProps(**CNN_PROPS), JDSProps(**CNN_PROPS)
    llm_dim = props.patch_in_dim  # 48
    enc_kw = dict(type="CNN", num_layers=3, hidden_dim=8, activation="leakyrelu")
    jenc = patch_encoder_init(jax.random.PRNGKey(1), props.patch_in_dim, llm_dim,
                              JEncoderConfig(**enc_kw))
    enc = PatchEncoder(props.patch_in_dim, llm_dim, EncoderConfig(**enc_kw))
    enc.load_state_dict(from_jax_params(_np(jenc)))
    x = rng.normal(size=(2, 3, props.N_patch, 3, 4, 4)).astype(np.float32)
    np.testing.assert_allclose(
        enc(torch.from_numpy(x)).detach().numpy(),
        np.asarray(patch_encoder_apply(jenc, jnp.asarray(x), JEncoderConfig(**enc_kw))),
        atol=1e-5)

    dec_kw = dict(type="CNN", num_layers=3, hidden_dim=32, activation="leakyrelu",
                  zero_last_layer=False)
    jdec = patch_decoder_init(jax.random.PRNGKey(3), llm_dim, jprops, JDecoderConfig(**dec_kw))
    dec = PatchDecoder(llm_dim, props, DecoderConfig(**dec_kw))
    dec.load_state_dict(from_jax_params(_np(jdec)))
    tokens = rng.normal(size=(2, 3, props.N_patch, llm_dim)).astype(np.float32)
    np.testing.assert_allclose(
        dec(torch.from_numpy(tokens)).detach().numpy(),
        np.asarray(patch_decoder_apply(jdec, jnp.asarray(tokens), jprops,
                                       JDecoderConfig(**dec_kw))), atol=1e-5)
    with pytest.raises(ValueError, match="patch_in_dim == llm_dim"):
        PatchDecoder(64, props, DecoderConfig(type="CNN"))


def test_cnn_model_forward_and_rollout_match_jax():
    """A whole model with the CNN encoder and decoder (patches of 4x4,
    llm_dim 48): the training forward and a 3-step rollout, whose CNN decode
    runs over the full window with invalid frames zeroed, within 1e-4."""
    kw = dict(NO_DROPOUT, patch_size=(4, 4), stride=(4, 4), resolution=24, use_lora=False,
              encoder_params={"type": "CNN", "num_layers": 2, "hidden_dim": 8,
                              "activation": "leakyrelu"},
              decoder_params={"type": "CNN", "num_layers": 2, "hidden_dim": 16,
                              "activation": "leakyrelu", "zero_last_layer": False})
    tiny = dict(TINY, d_model=48, n_heads=4, d_ff=96)
    dkw = dict(n_trajectories=2, resolution=24, patch_size=(4, 4), seq_len=SEQ_LEN,
               mode="valid")
    jds, tds = JSynthetic(**dkw), SyntheticCylinderDataset(**dkw)
    jmodel = JFluidLLM.build(JConfig(**kw), jds.ds_props(), **tiny)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(4))
    model = FluidLLM.build(Config(**kw), tds.ds_props(), **tiny)
    model.load_state_dict(from_jax_params(_np(params)))
    jb = next(jmake_batches(jds, 2, shuffle=False))
    tb = next(make_batches(tds, 2, shuffle=False))
    with torch.no_grad():
        got = model.predict_diffs(tb[0], tb[4])
    np.testing.assert_allclose(got.numpy(), np.asarray(jmodel.predict_diffs(params, jb[0], jb[4])),
                               atol=1e-4)
    st, df = generate(model, tb[0][:, :1], tb[3], tb[4], 3)
    jst, jdf = jgenerate(jmodel, params, jb[0][:, :1], jb[3], jb[4], 3)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=1e-4)
    np.testing.assert_allclose(df.numpy(), np.asarray(jdf), atol=1e-4)


def test_factored_dims_match_optax():
    from optax._src.factorized import _factored_dims

    for shape in [(192, 130), (130, 192), (128, 128), (64, 5), (7,), (3, 200, 150),
                  (200, 3, 150), (127, 500)]:
        assert factored_dims(torch.Size(shape)) == _factored_dims(shape, True, 128), shape


def _leaves(rng):
    """A factored leaf (>= 128 x 128), an unfactored matrix and a vector."""
    return {"a": rng.normal(size=(192, 130)).astype(np.float32),
            "b": rng.normal(size=(64, 5)).astype(np.float32) * 0.01,
            "c": rng.normal(size=(7,)).astype(np.float32)}


def _run_both(cfg_kw: dict, n: int, rng, lr_change: int = 10):
    """``n`` steps of the port's optimizer and the JAX package's on the same
    gradients, the learning rate set to 3e-3 before step ``lr_change``;
    yields (step, port params, JAX params) after each step."""
    cfg = Config(**cfg_kw)
    leaves = _leaves(rng)
    jopt = jbuild_optimizer(JConfig(**cfg_kw))
    jparams = {k: jnp.asarray(v) for k, v in leaves.items()}
    jstate = jopt.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in leaves.items()}
    opt = build_optimizer(cfg, tparams.values())
    for i in range(n):
        grads = {k: (rng.normal(size=v.shape) * 10.0 ** rng.integers(-3, 1)).astype(np.float32)
                 for k, v in leaves.items()}
        if i == lr_change:
            jstate = jset_learning_rate(jstate, 3e-3)
            set_learning_rate(opt, 3e-3)
        up, jstate = jopt.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, up)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        yield i, tparams, jparams


@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_adafactor_matches_optax(rng, wd):
    """20 steps of ``optimizer: adafactor`` against the JAX package's
    (``optax.adafactor`` under ``inject_hyperparams``, ``weight_decay_rate =
    weight_decay or None``), the learning rate changed after 10: within
    1e-6 absolute of unit-scale parameters."""
    kw = dict(optimizer="adafactor", learning_rate=1e-2, weight_decay=wd)
    for i, tparams, jparams in _run_both(kw, 20, rng):
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), atol=1e-6,
                                       err_msg=f"{k} step {i}")
    assert isinstance(build_optimizer(Config(**kw), [torch.nn.Parameter(torch.zeros(2))]),
                      Adafactor)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_grad_accumulation_matches_optax_multisteps(rng, name):
    """``grad_accum_steps: 3`` against ``optax.MultiSteps``: the mean of 3
    micro-batches' gradients, one inner update every 3rd call; in between
    the parameters are unchanged, bit for bit; 1e-6 absolute against optax."""
    kw = dict(optimizer=name, learning_rate=1e-2, weight_decay=0.01, grad_accum_steps=3)
    before = None
    for i, tparams, jparams in _run_both(kw, 9, rng, lr_change=4):
        now = {k: p.detach().clone() for k, p in tparams.items()}
        if i % 3 != 2:
            assert before is None or all(torch.equal(now[k], before[k]) for k in now), i
        else:
            assert before is not None and not torch.equal(now["a"], before["a"]), i
        before = now
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), atol=1e-6,
                                       err_msg=f"{k} step {i}")
    opt = build_optimizer(Config(**kw), [torch.nn.Parameter(torch.zeros(2))])
    assert isinstance(opt, MultiSteps) and opt.k == 3


def _tiny_trainer(tds, **cfg_kw):
    model = FluidLLM.build(Config(**dict(NO_DROPOUT, **cfg_kw)), tds.ds_props(), **TINY)
    model.init_weights(torch.Generator().manual_seed(0))
    return Trainer(model)


def test_checkpoint_resume_of_adafactor_and_accumulation_is_exact(pair, tmp_path):
    """adafactor under ``grad_accum_steps: 2``: saved after 3 micro-steps
    (mid-accumulation), restored into a fresh trainer; 3 more steps on the
    same batches leave both with the same parameters and optimizer state,
    bit for bit."""
    _, _, _, tds = pair
    kw = dict(optimizer="adafactor", grad_accum_steps=2, weight_decay=0.01)
    batches = list(make_batches(tds, 1, shuffle=False))
    trainer = _tiny_trainer(tds, **kw)
    for b in (batches * 2)[:3]:
        trainer.train_step(b)
    assert trainer.opt.mini_step == 1
    ckpt.save_checkpoint(str(tmp_path), 3, trainer.model, trainer.opt, 0, trainer.cfg)
    other = _tiny_trainer(tds, **kw)
    ckpt.restore_checkpoint(str(tmp_path), 3, other.model, other.opt)
    assert other.opt.mini_step == 1
    for b in (batches * 2)[:3]:
        trainer.train_step(b)
        other.train_step(b)
    for (n, a), b in zip(trainer.model.state_dict().items(), other.model.state_dict().values()):
        assert torch.equal(a, b), n
    sa, sb = trainer.opt.state_dict(), other.opt.state_dict()
    assert sa["mini_step"] == sb["mini_step"]
    assert all(torch.equal(x, y) for x, y in zip(sa["acc"], sb["acc"]))
    for k, st in sa["inner"]["state"].items():
        for name, val in st.items():
            assert torch.equal(torch.as_tensor(val), torch.as_tensor(sb["inner"]["state"][k][name]))


def test_val_plot_dir_and_inference_plot_dir_write_figures(pair, tmp_path):
    """``val_plot_dir`` writes the first validation batch's figures at each
    validation; ``inference.main --plot_dir`` the rollout frames."""
    _, _, _, tds = pair
    trainer = _tiny_trainer(tds)
    cfg = trainer.cfg.replace(num_epochs=1, val_plot_dir=str(tmp_path / "val"), save_on=False)
    train_run(cfg, trainer, tds, tds)
    figs = sorted(p.name for p in (tmp_path / "val" / "epoch_0000").iterdir())
    assert figs == [f"step_{j}.png" for j in sorted({0, (SEQ_LEN - 1) // 2, SEQ_LEN - 2})]
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(dict(CFG, llm_layers=2, load_dir="synthetic:1")))
    inference.main(["--config_path", str(cfg_path), "--device", "cpu", "--seq_len",
                    str(SEQ_LEN), "--pred_steps", "3", "--plot_dir", str(tmp_path / "roll")])
    assert (tmp_path / "roll" / "rollout_0.png").stat().st_size > 0


def test_plots_without_matplotlib_raise(monkeypatch, tmp_path):
    """Where matplotlib is missing (the card's machine), asking for a figure
    raises ImportError; nothing is skipped silently."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    frames = np.zeros((3, 3, 8, 4), np.float32)
    with pytest.raises(ImportError, match="matplotlib"):
        plotting.save_rollout_plots(frames, frames, str(tmp_path))
    with pytest.raises(ImportError, match="matplotlib"):
        plotting.save_val_plots(frames, frames, str(tmp_path), 0)
