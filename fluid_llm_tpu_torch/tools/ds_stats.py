"""Streaming per-channel dataset statistics (Welford).

Counterpart of ``fluid_llm_tpu/tools/ds_stats.py`` over the port's datasets
(``data/synthetic.py``, ``data/cylinder.py``): the equivalent of
``max/compute_ds_stats.py:20-97``, the provenance of the hardcoded
normalization constants in the dataloaders (``simple_dataloader.py:205-210``,
``airfoil_ds.py:228-233``).  Host-side numpy; no device.

    python -m fluid_llm_tpu_torch.tools.ds_stats --load_dir <MGN pickle folder> \\
        [--resolution 238] [--n_samples N]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


class Welford:
    """Numerically stable streaming mean/std (``compute_ds_stats.py:20-34``)."""

    def __init__(self):
        self.count = 0
        self.mean = 0.0
        self.m2 = 0.0

    def update(self, values: np.ndarray):
        values = np.asarray(values, np.float64).ravel()
        self.count += len(values)
        delta = values - self.mean
        self.mean += delta.sum() / self.count
        delta2 = values - self.mean
        self.m2 += (delta * delta2).sum()

    @property
    def std(self) -> float:
        return float(np.sqrt(self.m2 / max(self.count, 1)))


def compute_dataset_stats(dataset, n_samples: int | None = None, seq_stride: int = 1):
    """Per-channel state and diff statistics over a PatchDataset-like source.

    Returns {channel: {state_mean, state_std, diff_mean, diff_std}}.
    """
    aggs_state = [Welford() for _ in range(3)]
    aggs_diff = [Welford() for _ in range(3)]
    n = len(dataset) if n_samples is None else min(n_samples, len(dataset))
    for i in range(n):
        src = dataset.get_trajectory(i)
        states = src.node_states[::seq_stride]  # (T, 3, N)
        diffs = states[1:] - states[:-1]
        for c in range(3):
            aggs_state[c].update(states[:, c])
            aggs_diff[c].update(diffs[:, c])
    return {
        c: {
            "state_mean": aggs_state[c].mean,
            "state_std": aggs_state[c].std,
            "diff_mean": aggs_diff[c].mean,
            "diff_std": aggs_diff[c].std,
        }
        for c in range(3)
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--load_dir", default="synthetic")
    parser.add_argument("--resolution", type=int, default=238)
    parser.add_argument("--n_samples", type=int, default=None)
    args = parser.parse_args(argv)

    if args.load_dir == "synthetic":
        from fluid_llm_tpu_torch.data.synthetic import SyntheticCylinderDataset

        ds = SyntheticCylinderDataset(resolution=args.resolution, normalize=False)
    else:
        from fluid_llm_tpu_torch.data.cylinder import MGNDataset

        ds = MGNDataset(args.load_dir, resolution=args.resolution, normalize=False)
    stats = compute_dataset_stats(ds, args.n_samples)
    for c, s in stats.items():
        print(
            f"State {c}: {s['state_mean']:.4g}, {s['state_std']:.4g} | "
            f"Diff {c}: {s['diff_mean']:.3g}, {s['diff_std']:.4g}"
        )
    return stats


if __name__ == "__main__":
    main(sys.argv[1:])
