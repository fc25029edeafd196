"""Masked losses and the combined velocity/pressure objective.

Counterpart of ``fluid_llm_tpu/train/losses.py`` (``src/losses.py``).  Mask
convention as the reference: ``mask == True`` marks boundary/exterior
pixels that are *excluded* from the loss (``src/losses.py:24-27``); the
reference's ``masked_select`` becomes masked sums, same values.

On a rank mesh each rank holds some rows of the batch: every sum and mean
here is over the global batch (``comm.batch_sum``/``batch_mean``, the
numerator and the count of a masked mean reduced apart, so that ranks whose
masks keep different counts still give the one-process mean); outside a
step on a mesh they are the plain sums and means.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from fluid_llm_tpu_torch.parallel.comm import batch_mean, batch_sum


def _sel_mean(values: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Mean of ``values`` over elements where ``sel`` is True."""
    sel = sel.to(values.dtype)
    return batch_sum((values * sel).sum()) / batch_sum(sel.sum()).clamp_min(1.0)


def mape_loss(preds, target, mask, eps: float = 1e-5):
    """``src/losses.py:9-38``: |(p-t)/max(|t|,eps)| clamped to 1, masked mean."""
    loss = ((preds - target) / target.abs().clamp_min(eps)).abs().clamp_max(1.0)
    return _sel_mean(loss, ~mask)


def smape_loss(preds, target, mask, eps: float = 1e-5):
    """``src/losses.py:41-65``; averaged over *all* elements (mask zeros
    included), as the reference does."""
    sel = (~mask).to(preds.dtype)
    scale = target.abs() + preds.abs() + eps
    return 2.0 * batch_mean((target - preds).abs() / scale * sel)


def mse_loss(preds, target, mask):
    """``src/losses.py:68-94``: masked sum of squared error / selected count."""
    return _sel_mean((preds - target) ** 2, ~mask)


def rmse_loss(preds, target, mask):
    """``src/losses.py:100-121``: masked pixels zeroed, divided by the
    *total* element count before the sqrt, as the reference does."""
    sel = (~mask).to(preds.dtype)
    return batch_mean(((target - preds) * sel) ** 2).sqrt()


def mae_loss(preds, target, mask):
    """``src/losses.py:127-153``: masked sum of |error| / selected count."""
    return _sel_mean((preds - target).abs(), ~mask)


LOSS_FNS: dict[str, Callable] = {
    "mape": mape_loss,
    "smape": smape_loss,
    "mse": mse_loss,
    "rmse": rmse_loss,
    "mae": mae_loss,
}


def combined_loss(
    preds: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor,
    loss_fns: Sequence[str],
    loss_weights: Sequence[float],
    pressure_weight: float = 1.0,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """``src/losses.py:159-199``: each loss on velocity (channels :2) and
    pressure (channel 2:), combined as ``vel + pressure_weight * press``,
    then weighted and summed.

    ``preds/target/mask``: images ``(bs, seq, 3, tot_px, tot_py)``.  The
    reference slices the pressure mask as ``mask[:, :, 0:]`` (all three
    channels, ``src/losses.py:178``); the dataset repeats the mask across
    channels, so that triples numerator and denominator of every masked
    mean and leaves the values unchanged.  The pressure channel's own mask
    is used here, as in the JAX package: the same values, the right shape.
    """
    p_preds, p_target, p_mask = preds[:, :, 2:], target[:, :, 2:], mask[:, :, 2:]
    v_preds, v_target, v_mask = preds[:, :, :2], target[:, :, :2], mask[:, :, :2]
    tot = 0.0
    all_losses: dict[str, torch.Tensor] = {}
    for name, weight in zip(loss_fns, loss_weights):
        fn = LOSS_FNS[name]
        val = fn(v_preds, v_target, v_mask) + pressure_weight * fn(p_preds, p_target, p_mask)
        tot = tot + val * weight
        all_losses[name.upper()] = val
    return tot, all_losses
