"""N-RMSE metric and the loss normalisers.

Counterpart of ``fluid_llm_tpu/train/metrics.py`` (``src/utils_model.py:
48-74,112-145``).  ``std`` is torch's default Bessel-corrected estimator.
"""

from __future__ import annotations

import torch


def aux_calc_n_rmse(preds, target, bc_mask) -> torch.Tensor:
    """``src/utils_model.py:48-56``: masked per-(batch, step) RMSE.

    The reference zeroes masked pixels but averages over *all* pixels --
    reproduced exactly (normalisation constants were computed this way).
    """
    error = (preds - target) * (~bc_mask).to(preds.dtype)
    return (error ** 2).mean(dim=(-1, -2, -3)).sqrt()


def calc_n_rmse(preds, target, bc_mask) -> torch.Tensor:
    """``src/utils_model.py:59-74``.

    preds/target/bc_mask: images (bs, seq_len, 3, tot_px, tot_py).  Returns
    per-(batch, step) N-RMSE = RMSE(velocity) + RMSE(pressure), (bs, seq_len).
    """
    v = aux_calc_n_rmse(preds[:, :, :2], target[:, :, :2], bc_mask[:, :, :2])
    p = aux_calc_n_rmse(preds[:, :, 2:], target[:, :, 2:], bc_mask[:, :, 2:])
    return v + p


def normalise_diffs(targs, preds, norm_const: float, channel_indep: bool):
    """``src/utils_model.py:112-127``: scale preds and targets by the
    target-diff std; images ``(bs, seq_len, 3, tot_px, tot_py)``."""
    dims = (-1, -2, -4) if channel_indep else (-1, -2, -3, -4)
    scale = targs.std(dim=dims, keepdim=True) + norm_const
    return targs / scale, preds / scale


def normalise_states(diffs, targs, preds, norm_const: float, channel_indep: bool):
    """``src/utils_model.py:130-145``: scale state preds and targets by the
    diff std.

    ``diffs``: patches ``(bs, seq_len, N_patch, 3, px, py)``;
    ``targs/preds``: images ``(bs, seq_len, 3, tot_px, tot_py)``.
    """
    if channel_indep:
        # std over (py, px, N_patch, seq) -> (bs, 1, 1, 3, 1, 1); the
        # reference then squeezes the seq axis -> (bs, 1, 3, 1, 1)
        diff_std = diffs.std(dim=(-1, -2, -4, -5), keepdim=True).squeeze(1)
    else:
        # std over everything but batch, last axis squeezed -> (bs, 1, 1, 1, 1)
        diff_std = diffs.std(dim=(-1, -2, -3, -4, -5), keepdim=True).squeeze(-1)
    scale = diff_std + norm_const
    return targs / scale, preds / scale
