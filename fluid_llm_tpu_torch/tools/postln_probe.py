"""Linear-recoverability probe for frozen random backbones.

Counterpart of ``fluid_llm_tpu/tools/postln_probe.py``.  Measures how much
of the input embedding a linear (ridge) readout recovers from a
random-init backbone's output: the quantity that bounds what a patch
decoder can learn when the trunk is frozen (the LoRA/peft anchor protocol,
reference ``src/models/model.py:106-116``).  Pre-LN stacks keep the
residual identity path; OPT-350m's post-LN blocks
(``do_layer_norm_before=False``) re-normalise after every residual add.

R² is ``1 - sum(resid^2) / sum((x_te - mean(x_te))^2)`` on the held-out
quarter.  The JAX tool divides ``resid.var()`` by ``x_te.var()``
(``postln_probe.py:60``): ``var`` re-centres the residual, so a readout
that is off by a constant still scores as if it were not.  The port
counts the residual's mean.

Runs on the CPU (a few seconds for OPT-125m):

    python -m fluid_llm_tpu_torch.tools.postln_probe [backbone ...]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from fluid_llm_tpu_torch.models import backbone as bb


def ridge_r2(x: np.ndarray, y: np.ndarray) -> float:
    """Held-out R² of a ridge readout x <- y: rows (n, d_in) and (n, d_out),
    the first three quarters fit, the last quarter scored."""
    xf, yf = np.asarray(x, np.float64), np.asarray(y, np.float64)
    n_train = int(yf.shape[0] * 0.75)
    y_tr, y_te = yf[:n_train], yf[n_train:]
    x_tr, x_te = xf[:n_train], xf[n_train:]
    mu = y_tr.mean(0)
    y_tr = y_tr - mu
    y_te = y_te - mu
    lam = 1e-2 * np.trace(y_tr.T @ y_tr) / y_tr.shape[1]
    w = np.linalg.solve(y_tr.T @ y_tr + lam * np.eye(y_tr.shape[1]), y_tr.T @ x_tr)
    resid = x_te - y_te @ w
    return float(1.0 - np.sum(resid ** 2) / np.sum((x_te - x_te.mean()) ** 2))


def probe_inputs(cfg: bb.BackboneConfig, n_seq: int, seq_len: int, seed: int) -> np.ndarray:
    """The probe's input embeddings, (n_seq, seq_len, embed_dim) f32."""
    return np.random.default_rng(seed + 1).standard_normal(
        (n_seq, seq_len, cfg.embed_dim)).astype(np.float32)


@torch.no_grad()
def readout_r2(name: str, n_seq: int = 768, seq_len: int = 8, seed: int = 0) -> float:
    """Held-out R² of a ridge readout input <- backbone(input), with the
    backbone's weights drawn from ``seed`` (``Backbone.reset_parameters``),
    on the CPU, f32, no dropout."""
    cfg = bb.preset(name)
    model = bb.Backbone(cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    x = probe_inputs(cfg, n_seq, seq_len, seed)
    y = model(torch.from_numpy(x))
    return ridge_r2(x.reshape(-1, x.shape[-1]), y.reshape(-1, y.shape[-1]).numpy())


def main(argv=None) -> None:
    names = (argv or sys.argv[1:]) or [
        "facebook/opt-125m",
        "facebook/opt-350m",
        "fluid/llama-350m",
    ]
    for name in names:
        r2 = readout_r2(name)
        print(f"{name}: held-out ridge readout R^2 = {r2:+.4f}")


if __name__ == "__main__":
    main()
