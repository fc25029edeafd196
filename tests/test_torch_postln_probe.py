"""The port's post-LN probe (``tools/postln_probe.py``).

``readout_r2`` runs the port's backbone; its R² is held to the corrected
formula, ``1 - sum(resid^2) / sum((x_te - mean(x_te))^2)``, applied to the
JAX backbone's output on the same weights (the port's draw, bridged back
by ``weights.to_jax_params``) and inputs: within 1e-6 (the two outputs
differ by f32 rounding; the ridge solve is f64).  The JAX tool's
``resid.var()`` re-centres the residual: on a readout that is off by a
constant the two formulas part, and the port's counts the offset.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluid_llm_tpu.models import backbone as jbb
from fluid_llm_tpu_torch.models import backbone as bb
from fluid_llm_tpu_torch.tools import postln_probe
from fluid_llm_tpu_torch.weights import to_jax_params

torch.set_num_threads(2)

_TINY = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, max_pos=64, dropout=0.0)
PRESETS = {
    "opt_pre_ln": dict(_TINY, family="opt", act="relu", pos_offset=2),
    "opt_post_ln": dict(_TINY, family="opt", act="relu", pos_offset=2, d_embed=32,
                        pre_ln=False, final_ln=False),
    "llama": dict(_TINY, family="llama", act="silu", norm="rmsnorm", pos="rope", ln_eps=1e-6),
}


def _corrected_r2(x: np.ndarray, y: np.ndarray) -> float:
    """The ridge readout of the JAX tool (``postln_probe.py:44-60``) with
    the residual's mean counted."""
    yf, xf = np.asarray(y, np.float64), np.asarray(x, np.float64)
    n_train = int(yf.shape[0] * 0.75)
    mu = yf[:n_train].mean(0)
    y_tr, y_te = yf[:n_train] - mu, yf[n_train:] - mu
    x_tr, x_te = xf[:n_train], xf[n_train:]
    lam = 1e-2 * np.trace(y_tr.T @ y_tr) / y_tr.shape[1]
    w = np.linalg.solve(y_tr.T @ y_tr + lam * np.eye(y_tr.shape[1]), y_tr.T @ x_tr)
    resid = x_te - y_te @ w
    return 1.0 - float(np.sum(resid ** 2) / np.sum((x_te - x_te.mean()) ** 2))


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_readout_r2_matches_jax_backbone(preset, monkeypatch):
    kw = PRESETS[preset]
    monkeypatch.setitem(bb.PRESETS, "tiny/probe", bb.BackboneConfig(**kw))
    n_seq, seq_len, seed = 96, 8, 3
    got = postln_probe.readout_r2("tiny/probe", n_seq=n_seq, seq_len=seq_len, seed=seed)

    model = bb.Backbone(bb.BackboneConfig(**kw))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    params = to_jax_params(model.state_dict())
    jcfg = jbb.BackboneConfig(**kw)
    x = postln_probe.probe_inputs(jcfg, n_seq, seq_len, seed)
    y = np.asarray(jax.jit(lambda p, v: jbb.apply(p, jcfg, v))(params, jnp.asarray(x)))
    want = _corrected_r2(x.reshape(-1, x.shape[-1]), y.reshape(-1, y.shape[-1]))
    assert np.isfinite(got) and abs(got - want) <= 1e-6


def test_r2_counts_the_residual_mean():
    """A readout off by 2 on the held-out rows: ``resid.var()`` (the JAX
    tool) scores it near 1; the port's R² counts the offset."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((400, 4))
    y = x.copy()
    y[300:] += 2.0  # the held-out quarter reads 2 high: the readout is off by 2
    got = postln_probe.ridge_r2(x, y)
    assert got == pytest.approx(_corrected_r2(x, y), abs=1e-12)

    y_te = y[300:] - y[:300].mean(0)
    y_tr = y[:300] - y[:300].mean(0)
    lam = 1e-2 * np.trace(y_tr.T @ y_tr) / 4
    w = np.linalg.solve(y_tr.T @ y_tr + lam * np.eye(4), y_tr.T @ x[:300])
    resid = x[300:] - y_te @ w
    flattered = 1.0 - resid.var() / x[300:].var()
    assert flattered > 0.9 and got < -2.0
