"""N-RMSE metric (counterpart of ``fluid_llm_tpu/train/metrics.py``;
``src/utils_model.py:48-74``).  The loss normalisers come with training."""

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
