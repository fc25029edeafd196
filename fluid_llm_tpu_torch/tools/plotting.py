"""Figures: validation comparisons, inference frames, mesh and patch plots,
comparison grids.

Counterpart of the figure code of ``fluid_llm_tpu/train/loop.py:51-80``
(``_save_val_plots``), ``fluid_llm_tpu/inference.py:85-100``
(``save_rollout_plots``) and ``fluid_llm_tpu/tools/plotting.py`` (the patch
and mesh plots of ``mesh_utils.py:21-61,109-123``, one frame in the style of
the reference's ``plots/``, ``src/inference.py:65-77``, and the figure grid
of ``max/grid_image.py:5-88``).  Every figure is saved to a file.
matplotlib is imported when a figure is asked for, not before: the card's
machine has none, and asking for a figure there raises ``ImportError``.
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
    _pyplot()
    os.makedirs(plot_dir, exist_ok=True)
    vmin, vmax = true_states[:100, 0].min(), true_states[:100, 0].max()
    for j in (0, 20, 40, 60, 80, 100):
        if j >= len(pred_states):
            break
        plot_field(pred_states[j, 0], os.path.join(plot_dir, f"rollout_{j}.png"), vmin, vmax)


def plot_patches(state: np.ndarray, n_patch: tuple[int, int], out_path: str):
    """Patch grid, single channel (``mesh_utils.py:21-41``).
    state: (N_patch, H, W) with patch index p = x*Ny + y."""
    plt = _pyplot()
    x_count, y_count = n_patch
    state = np.asarray(state, np.float32)
    v_min, v_max = state.min(), state.max()
    state = (state - v_min) / max(v_max - v_min, 1e-12)

    fig, axes = plt.subplots(y_count, x_count, figsize=(x_count, y_count), squeeze=False)
    for i in range(y_count):
        for j in range(x_count):
            axes[i, j].imshow(state[j * y_count + i].T, vmin=0, vmax=1)
            axes[i, j].axis("off")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)


def plot_full_patches(state: np.ndarray, n_patch: tuple[int, int], out_path: str):
    """Patches stitched into one image (``mesh_utils.py:44-61``)."""
    plt = _pyplot()
    x_count, y_count = n_patch
    y_px, x_px = state.shape[1], state.shape[2]
    full = np.zeros((y_count * y_px, x_count * x_px), np.float32)
    for i in range(y_count):
        for j in range(x_count):
            full[i * y_px:(i + 1) * y_px, j * x_px:(j + 1) * x_px] = state[i + j * y_count].T
    fig = plt.figure()
    plt.imshow(full)
    plt.axis("off")
    fig.savefig(out_path)
    plt.close(fig)


def plot_mesh(pos: np.ndarray, faces: np.ndarray, val: np.ndarray, out_path: str):
    """tripcolor + wireframe (``mesh_utils.py:109-123``)."""
    plt = _pyplot()
    from matplotlib import tri as mtri

    triang = mtri.Triangulation(pos[:, 0], pos[:, 1], faces)
    fig = plt.figure(figsize=(8, 8))
    plt.tripcolor(triang, val)
    plt.triplot(triang, "k-", lw=0.1)
    plt.axis("equal")
    plt.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)


def plot_field(img: np.ndarray, out_path: str, vmin=None, vmax=None, flip: bool = True):
    """Single rollout frame in the reference's plots/ style
    (``inference.py:65-77``)."""
    plt = _pyplot()
    fig = plt.figure(figsize=(15, 4), dpi=100)
    data = np.flipud(img.T) if flip else img.T
    plt.imshow(data, vmin=vmin, vmax=vmax)
    plt.axis("off")
    plt.tight_layout()
    fig.savefig(out_path, bbox_inches="tight", pad_inches=0)
    plt.close(fig)


def assemble_grid(
    image_paths: list[list[str]],
    out_path: str,
    row_labels: list[str] | None = None,
    col_labels: list[str] | None = None,
):
    """Stack prerendered frames into a comparison grid
    (``max/grid_image.py:5-88``: models x rollout steps)."""
    plt = _pyplot()
    from PIL import Image

    rows = len(image_paths)
    cols = max(len(r) for r in image_paths)
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 1.2 * rows), squeeze=False)
    for i, row in enumerate(image_paths):
        for j in range(cols):
            ax = axes[i][j]
            ax.axis("off")
            if j < len(row) and os.path.exists(row[j]):
                ax.imshow(np.asarray(Image.open(row[j])))
            if i == 0 and col_labels and j < len(col_labels):
                ax.set_title(col_labels[j], fontsize=9)
        if row_labels and i < len(row_labels):
            axes[i][0].text(
                -0.05, 0.5, row_labels[i], transform=axes[i][0].transAxes,
                ha="right", va="center", fontsize=9,
            )
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
