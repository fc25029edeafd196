"""The ported training slice against the JAX package, on the CPU.

- ``lora_linear``, the losses, the normalisers and ``process_metrics``
  against their JAX functions on the same numpy inputs;
- the optimizers against optax on the same numpy gradients, over several
  steps and a learning-rate change;
- one autoreg step of the tiny configuration of ``tests/test_torch_slice.py``
  (GPT-2 layout, 2 layers, d 64, DoRA with non-zero ``B``, BOS, see-init,
  MLPGNN, f32), dropouts at 0: the loss and every trainable gradient
  against ``jax.value_and_grad`` of ``Trainer._mode_loss``, weights bridged
  by ``weights.from_jax_params``.  The port's attention goes through the
  ``FlashAttention`` Function and the decoder through ``SlotAttention``
  (their plain twins on CPU tensors), the JAX package through XLA;
- seeded dropout, the frozen backbone, the autograd guard of the
  exact-window kernel, the checkpoint round trip, and ``main`` ->
  ``continue_train`` -> ``inference.main --checkpoint_dir`` end to end.

Tolerances (f32): 1e-5 relative on elementwise functions and the loss,
1e-4 relative to each tensor's largest entry on gradients (sums over
batch, tokens and pixels in another order; 5e-3 for ``gen``, whose inputs
come from a rollout), 1e-6 absolute on optimizer updates of unit-scale
parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from fluid_llm_tpu.config import Config
from fluid_llm_tpu_torch.config import ParallelConfig
from fluid_llm_tpu.data.pipeline import make_batches as jmake_batches
from fluid_llm_tpu.data.synthetic import SyntheticCylinderDataset as JSynthetic
from fluid_llm_tpu.models.fluid_llm import FluidLLM as JFluidLLM
from fluid_llm_tpu.models.lora import lora_linear as jlora_linear
from fluid_llm_tpu.train import losses as jlosses
from fluid_llm_tpu.train import metrics as jmetrics
from fluid_llm_tpu.train.optim import build_optimizer as jbuild_optimizer
from fluid_llm_tpu.train.optim import partition
from fluid_llm_tpu.train.optim import set_learning_rate as jset_learning_rate
from fluid_llm_tpu.train.trainer import Trainer as JTrainer
from fluid_llm_tpu.utils import process_metrics as jprocess_metrics
from fluid_llm_tpu_torch import continue_train, inference
from fluid_llm_tpu_torch import main as tmain
from fluid_llm_tpu_torch.data import make_batches
from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset
from fluid_llm_tpu_torch.models.fluid_llm import FluidLLM
from fluid_llm_tpu_torch.models.lora import LoraAdapter, lora_linear
from fluid_llm_tpu_torch.ops import exact_attention as xa
from fluid_llm_tpu_torch.parallel.mesh import make_mesh
from fluid_llm_tpu_torch.train import checkpoint as ckpt
from fluid_llm_tpu_torch.train import losses, metrics
from fluid_llm_tpu_torch.train.optim import build_optimizer, set_learning_rate
from fluid_llm_tpu_torch.train.loop import train_run
from fluid_llm_tpu_torch.train.trainer import Trainer
from fluid_llm_tpu_torch.utils import process_metrics
from fluid_llm_tpu_torch.weights import from_jax_params
from test_torch_slice import CFG, SEQ_LEN, TINY

torch.set_num_threads(2)

NO_DROPOUT = dict(CFG, flash_attention=True,
                  lora_config={**CFG["lora_config"], "lora_dropout": 0.0},
                  pos_embedding_params={"input_emb_layer_dropout": 0.0})


def _close(got: torch.Tensor, want, rel: float, name: str = "") -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30), err_msg=name)


@pytest.mark.parametrize("dora", [True, False])
def test_lora_linear_matches_jax(rng, dora):
    """Unmerged LoRA/DoRA forward and its gradients (x, A, B, m): the DoRA
    norm is detached in both (JAX ``stop_gradient``)."""
    d_in, d_out, r = 16, 24, 4
    cfg = Config(lora_config={"r": r, "lora_alpha": 16, "use_dora": dora}).lora_config
    x = rng.normal(size=(3, 7, d_in)).astype(np.float32)
    w = rng.normal(size=(d_in, d_out)).astype(np.float32) * 0.2
    b = rng.normal(size=(d_out,)).astype(np.float32)
    A = rng.normal(size=(d_in, r)).astype(np.float32) * 0.3
    B = rng.normal(size=(r, d_out)).astype(np.float32) * 0.3
    m = np.linalg.norm(w, axis=0) * 1.3
    g = rng.normal(size=(3, 7, d_out)).astype(np.float32)

    def jloss(x, A, B, m):
        ad = {"A": A, "B": B, **({"m": m} if dora else {})}
        y = jlora_linear(x, {"w": jnp.asarray(w), "b": jnp.asarray(b)}, ad, cfg)
        return jnp.sum(y * g), y
    (_, jy), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *map(jnp.asarray, (x, A, B, m)))

    lin = torch.nn.Linear(d_in, d_out)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
        lin.bias.copy_(torch.from_numpy(b))
    ad = LoraAdapter(d_in, d_out, r, dora)
    with torch.no_grad():
        ad.A.copy_(torch.from_numpy(A))
        ad.B.copy_(torch.from_numpy(B))
        if dora:
            ad.m.copy_(torch.from_numpy(m))
    tx = torch.from_numpy(x).requires_grad_()
    y = lora_linear(tx, lin, ad, cfg)
    (y * torch.from_numpy(g)).sum().backward()
    _close(y, jy, 1e-5, "y")
    for t, j, name in zip((tx, ad.A, ad.B, ad.m), jgrads, ("x", "A", "B", "m")):
        if t is not None:
            _close(t.grad, j, 1e-5, name)


def test_losses_and_normalisers_match_jax(rng):
    """The five losses, ``combined_loss`` (pressure mask of its own channel)
    and both normalisers, on images with a mask of ~30 % excluded pixels."""
    preds, target = (rng.normal(size=(2, 3, 3, 16, 12)).astype(np.float32) for _ in range(2))
    mask = np.broadcast_to(rng.random(size=(2, 3, 1, 16, 12)) < 0.3, preds.shape).copy()
    tp, tt, tm = map(torch.from_numpy, (preds, target, mask))
    for name, fn in losses.LOSS_FNS.items():
        _close(fn(tp, tt, tm), getattr(jlosses, f"{name}_loss")(preds, target, mask), 1e-5, name)
    names, weights = ("mae", "mse", "rmse", "mape", "smape"), (0.1, 10.0, 1.0, 0.5, 2.0)
    tot, parts = losses.combined_loss(tp, tt, tm, names, weights, 0.1)
    jtot, jparts = jlosses.combined_loss(preds, target, mask, names, weights, 0.1)
    _close(tot, jtot, 1e-5, "combined")
    for k in jparts:
        _close(parts[k], jparts[k], 1e-5, k)

    diffs = rng.normal(size=(2, 3, 20, 3, 8, 8)).astype(np.float32)
    for ci in (False, True):
        for got, want in zip(metrics.normalise_states(torch.from_numpy(diffs), tt, tp, 0.05, ci),
                             jmetrics.normalise_states(diffs, target, preds, 0.05, ci)):
            _close(got, want, 1e-5, f"states ci={ci}")
        for got, want in zip(metrics.normalise_diffs(tt, tp, 0.05, ci),
                             jmetrics.normalise_diffs(target, preds, 0.05, ci)):
            _close(got, want, 1e-5, f"diffs ci={ci}")


def test_process_metrics_matches_jax(rng):
    batches = [{"loss": rng.random(), "MAE": rng.random(),
                "N_RMSE": rng.random(size=(2, 4)).astype(np.float32)} for _ in range(3)]
    got = process_metrics([{k: torch.tensor(v) for k, v in m.items()} for m in batches],
                          "Autoreg", "train")
    want = jprocess_metrics(batches, "Autoreg", "train")
    assert got[0].keys() == want[0].keys()
    np.testing.assert_allclose([got[0][k] for k in got[0]] + list(got[1:]),
                               [want[0][k] for k in got[0]] + list(want[1:]), rtol=1e-6)


@pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
def test_optimizer_matches_optax(rng, name):
    """Six steps on the same gradients, the learning rate changed after
    three (``set_learning_rate`` on both sides): AdamW's decoupled decay,
    Adam's and SGD's L2, eps 1e-8 outside the square root."""
    cfg = Config(optimizer=name, learning_rate=1e-2, weight_decay=0.1)
    w0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [(rng.normal(size=(5, 3)) * 10.0 ** rng.integers(-3, 1)).astype(np.float32)
             for _ in range(6)]
    jopt = jbuild_optimizer(cfg)
    params = {"w": jnp.asarray(w0)}
    state = jopt.init(params)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = build_optimizer(cfg, [p])
    for i, g in enumerate(grads):
        if i == 3:
            state = jset_learning_rate(state, 3e-3)
            set_learning_rate(opt, 3e-3)
        up, state = jopt.update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, up)
        p.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params["w"]), atol=1e-6)


def test_unported_options_raise():
    """What the port still refuses: an expert group across hosts (JAX's
    refusal; the expert axis is ported: ``tests/test_torch_expert.py``) and
    the multi-process flags without ``--distributed``; pipeline
    parallelism over adapters raises the JAX package's guard (the parallel
    axes are ported: ``tests/test_torch_parallel.py``,
    ``test_torch_pipeline.py``, ``test_torch_ring.py``; adafactor,
    accumulation, notf and ``val_plot_dir``: ``tests/test_torch_surface.py``;
    ``frozen_bf16``, MoE and ``llm_4bit_loading``:
    ``tests/test_torch_quant_train.py``, ``tests/test_torch_moe.py``)."""
    props = SyntheticCylinderDataset(n_trajectories=1, resolution=64, seq_len=SEQ_LEN).ds_props()
    FluidLLM.build(Config(**NO_DROPOUT, frozen_bf16=True), props, **TINY)
    with pytest.raises(ValueError, match="full-FT"):
        FluidLLM.build(Config(**NO_DROPOUT, parallel={"pipe_axis": 2}), props, **TINY)
    FluidLLM.build(Config(**dict(NO_DROPOUT, use_lora=False), parallel={"pipe_axis": 2}), props,
                   **TINY)
    with pytest.raises(NotImplementedError, match="expert_axis"):
        make_mesh(ParallelConfig(expert_axis=2), world=8, rank=0, local_world=4)
    with pytest.raises(SystemExit):
        tmain.main(["--process_id", "0"])


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
    model = FluidLLM.build(cfg, tds.ds_props(), **TINY)
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, params, jds, model, tds


@pytest.mark.parametrize("mode", ["autoreg", "gen"])
def test_train_step_loss_and_gradients_match_jax(pair, mode):
    """``autoreg`` (teacher forced) and ``gen`` (a no-grad rollout makes the
    guide states, then one see-init forward).  ``gen``'s gradients are held
    to 5e-3 of each tensor's largest entry: its inputs are a 3-step f32
    rollout of each package, ~5e-7 apart, which moves a few GATv2 pixels
    across leaky-ReLU's kink (slope 1 vs 0.2) and so changes single terms of
    the decoder's weight gradients by up to ~2e-3 of their largest entry."""
    jmodel, params, jds, model, tds = pair
    jtrainer = JTrainer(jmodel)
    jbatch = next(jmake_batches(jds, 2, shuffle=False))
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jtrainer._mode_loss(p, b, jax.random.PRNGKey(1), mode), has_aux=True))
    (jloss, jaux), jgrads = fn(params, jbatch)

    model.zero_grad(set_to_none=True)
    trainer = Trainer(model)
    loss, aux = trainer.mode_loss(next(make_batches(tds, 2, shuffle=False)), mode)
    loss.backward()
    _close(loss, jloss, 1e-5, "loss")
    for k in ("MAE", "MSE", "N_RMSE"):
        _close(aux[k], jaux[k], 1e-5, k)

    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads))
    trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
    assert trainable and all(n.split(".")[0] in ("lora", "input_emb", "decoder", "bos")
                             for n in trainable)
    for n, p in model.named_parameters():
        if n in trainable:
            _close(p.grad, want[n].numpy(), 1e-4 if mode == "autoreg" else 5e-3, n)
        else:  # the frozen backbone: no gradient, no optimizer state
            assert n.startswith("backbone.") and p.grad is None, n
    opt_params = {id(p) for g in trainer.opt.param_groups for p in g["params"]}
    assert opt_params == {id(p) for p in trainable.values()}


def test_val_step_matches_jax(pair):
    """The validation rollout over the whole sequence (adapters unmerged,
    no gradient): losses and per-step N-RMSE."""
    jmodel, params, jds, model, tds = pair
    jtrainer = JTrainer(jmodel)
    trainable, frozen = partition(params, jmodel.trainable_mask(params))
    want = jtrainer.val_step(trainable, frozen, next(jmake_batches(jds, 2, shuffle=False)))
    got = Trainer(model).val_step(next(make_batches(tds, 2, shuffle=False)))
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], 1e-4, k)


def _tiny_trainer(dropout: bool, seed: int = 0):
    cfg = Config(**CFG) if dropout else Config(**NO_DROPOUT)
    tds = SyntheticCylinderDataset(n_trajectories=2, resolution=64, seq_len=SEQ_LEN, mode="valid")
    model = FluidLLM.build(cfg, tds.ds_props(), **dict(TINY, dropout=0.1 if dropout else 0.0))
    model.init_weights(torch.Generator().manual_seed(seed))
    return Trainer(model), next(make_batches(tds, 2, shuffle=False))


def test_dropout_is_seeded():
    """Same generator state, same loss; another seed, another loss; and the
    forward without ``train`` draws nothing."""
    trainer, batch = _tiny_trainer(dropout=True)
    got = []
    for seed in (3, 3, 4):
        trainer.generator.manual_seed(seed)
        with torch.no_grad():
            got.append(trainer.mode_loss(batch, "autoreg")[0].item())
    assert got[0] == got[1] and got[0] != got[2]
    state = trainer.generator.get_state()
    with torch.no_grad():
        trainer.model(batch[0], batch[4])
    assert torch.equal(state, trainer.generator.get_state())


@pytest.mark.parametrize("flash", [True, False])
def test_training_forward_never_calls_exact_kernel(monkeypatch, flash):
    """With grad enabled the backbone's attention is the flash Function or
    the plain twin, never ``causal_attention`` (forward only); a train step
    then moves every trainable parameter group that gets gradient."""
    trainer, batch = _tiny_trainer(dropout=False)
    trainer.model.backbone.cfg = trainer.model.backbone.cfg.replace(flash_attention=flash)

    def boom(*a, **k):
        raise AssertionError("causal_attention called under autograd")

    monkeypatch.setattr(xa, "causal_attention", boom)
    trainer.train_step(batch)  # B is zero at init: A gets gradient from step 2
    metrics_ = trainer.train_step(batch)
    assert torch.isfinite(metrics_["loss"])
    for name in ("lora.layers.0.attn.q.A", "lora.layers.0.attn.v.B", "lora.layers.1.attn.q.m",
                 "input_emb.patch.mlp.0.weight", "decoder.gnn.out.att", "bos"):
        grad = dict(trainer.model.named_parameters())[name].grad
        assert grad is not None and grad.abs().sum() > 0, name


def test_checkpoint_roundtrip(tmp_path):
    trainer, batch = _tiny_trainer(dropout=False)
    trainer.train_step(batch)
    cfg = trainer.cfg
    path = ckpt.save_checkpoint(str(tmp_path), 7, trainer.model, trainer.opt, 7, cfg)
    assert ckpt.latest_step(str(tmp_path)) == 7 and path.endswith("step_7")
    assert (tmp_path / "step_7.epoch").read_text() == "7"
    other, _ = _tiny_trainer(dropout=False, seed=1)
    assert ckpt.restore_checkpoint(str(tmp_path), 7, other.model, other.opt) == 7
    for (n, a), b in zip(trainer.model.state_dict().items(), other.model.state_dict().values()):
        assert torch.equal(a, b), n
    sa, sb = trainer.opt.state_dict()["state"], other.opt.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for k in sa:
        for name in sa[k]:
            assert torch.equal(torch.as_tensor(sa[k][name]), torch.as_tensor(sb[k][name]))
    saved = ckpt.load_config(str(tmp_path))
    assert (saved.llm_backbone, saved.autoreg_seq_len) == (cfg.llm_backbone, cfg.autoreg_seq_len)


def test_main_continue_train_inference_end_to_end(tmp_path, monkeypatch):
    """The entry points on the CPU: ``main`` for 2 epochs (checkpoints each
    epoch, a profiler trace of the first), ``continue_train`` for 1 more
    from the latest, then ``inference.main`` from that run folder.  An
    empty HF cache: the seeded draw trains."""
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    runs = tmp_path / "runs"
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(dict(
        CFG, llm_layers=2, load_dir="synthetic:2", num_epochs=2, save_model_each=1,
        val_seq_len=SEQ_LEN, checkpoint_save_path=str(runs),
        profile_dir=str(tmp_path / "trace"))))
    jl = tmp_path / "metrics.jsonl"
    assert tmain.main(["--config_path", str(cfg_path), "--device", "cpu",
                       "--metrics_jsonl", str(jl)]) == 2
    run = runs / "000"
    assert ckpt.latest_step(str(run)) == 1
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    saved = yaml.safe_load((run / "config.yaml").read_text())
    (run / "config.yaml").write_text(yaml.safe_dump(dict(saved, num_epochs=1)))
    assert continue_train.main(["--checkpoint_dir", str(runs), "--device", "cpu",
                                "--metrics_jsonl", str(jl)]) == 2
    lines = [yaml.safe_load(line) for line in jl.read_text().splitlines()]
    assert [m["epoch"] for m in lines] == [0, 1, 1]
    assert "val/Gen/N_RMSE" in lines[0] and np.isfinite(lines[-1]["train/Autoreg/loss"])
    mean = inference.main(["--checkpoint_dir", str(runs), "--device", "cpu",
                           "--seq_len", str(SEQ_LEN), "--pred_steps", "3"])
    assert np.isfinite(mean)
