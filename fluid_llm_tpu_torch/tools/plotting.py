"""Rollout figures: validation comparisons and inference frames.

Counterpart of the figure code of ``fluid_llm_tpu/train/loop.py:51-80``
(``_save_val_plots``) and ``fluid_llm_tpu/inference.py:85-100``
(``save_rollout_plots``), in the style of the reference's ``plots/``
(``src/inference.py:65-77``).  matplotlib is imported when a figure is
asked for, not before: the card's machine has none, and asking for a
figure there raises ``ImportError``.
"""

from __future__ import annotations

import os

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the headless Agg backend."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("figures need matplotlib, which is not installed; run without "
                          "val_plot_dir / --plot_dir") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_val_plots(pred: np.ndarray, true: np.ndarray, plot_dir: str, epoch: int) -> None:
    """Target-vs-prediction frames of one validation trajectory at its
    first, middle and last step: pred, true (steps, 3, X, Y), channel 0 shown,
    into ``plot_dir/epoch_NNNN/step_J.png``."""
    plt = _pyplot()
    pred, true = np.asarray(pred, np.float32), np.asarray(true, np.float32)
    out = os.path.join(plot_dir, f"epoch_{epoch:04d}")
    os.makedirs(out, exist_ok=True)
    vmin, vmax = true[: len(pred), 0].min(), true[: len(pred), 0].max()
    for j in sorted({0, len(pred) // 2, len(pred) - 1}):
        fig, axes = plt.subplots(2, 1, figsize=(12, 6), dpi=80)
        for ax, img, title in zip(axes, (true[j, 0], pred[j, 0]), ("target", "prediction")):
            ax.imshow(np.flipud(img.T), vmin=vmin, vmax=vmax)
            ax.set_title(f"{title} (step {j})")
            ax.axis("off")
        fig.tight_layout()
        fig.savefig(os.path.join(out, f"step_{j}.png"))
        plt.close(fig)


def save_rollout_plots(pred_states: np.ndarray, true_states: np.ndarray, plot_dir: str) -> None:
    """Predicted frames at rollout steps 0, 20, ..., 100, channel 0, on the
    colour range of the first 100 true frames: ``plot_dir/rollout_J.png``."""
    plt = _pyplot()
    os.makedirs(plot_dir, exist_ok=True)
    vmin, vmax = true_states[:100, 0].min(), true_states[:100, 0].max()
    for j in (0, 20, 40, 60, 80, 100):
        if j >= len(pred_states):
            break
        fig = plt.figure(figsize=(15, 4), dpi=100)
        plt.imshow(np.flipud(pred_states[j, 0].T), vmin=vmin, vmax=vmax)
        plt.axis("off")
        plt.tight_layout()
        fig.savefig(os.path.join(plot_dir, f"rollout_{j}.png"), bbox_inches="tight", pad_inches=0)
        plt.close(fig)
