"""Constrained (size-capped) k-means for GraphViT cluster tokens.

A copy of ``fluid_llm_tpu/tools/clusterize.py`` (NumPy only), so that the
port builds the same cluster tables from the same seed and writes the
``constrained_kmeans_*.npy`` files its EAGLE datasets read.

Offline tool equivalent of ``eagle/clusterize_mgn.py`` /
``clusterize_fluent.py`` (numba-JIT upstream; vectorised NumPy here — it is
an offline preprocessing step, not a device hot path):

1. Lloyd k-means over node positions (``clusterize_mgn.py:55-89``),
2. greedy capacity-capped assignment ordered by (min-max) distance score
   (``:92-119``),
3. swap refinement until no swap improves the assignment (``:122-193``),
4. clusters padded to ``max_cluster_size`` with -1 and saved as
   ``constrained_kmeans_{size}_{name}.npy`` (``:219-229,260-265``).

The swap pass keeps the reference's move/pair-swap rules; exact tie-break
order may differ from the numba version (output format and constraints are
identical).
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def kmeans(x: np.ndarray, K: int, n_iter: int = 300, centers: np.ndarray | None = None):
    if centers is None:
        centers = x[:K].copy()
    assign = np.argmin(((x[:, None] - centers[None]) ** 2).sum(-1), axis=1)
    for _ in range(n_iter):
        d = ((x[:, None] - centers[None]) ** 2).sum(-1)
        new_assign = np.argmin(d, axis=1)
        new_centers = centers.copy()
        for k in range(K):
            members = x[new_assign == k]
            if len(members):
                new_centers[k] = members.mean(axis=0)
        if np.array_equal(new_assign, assign) or (
            ((new_centers - centers) ** 2).sum(-1) < 1e-6
        ).all():
            break
        centers, assign = new_centers, new_assign
    return centers


def capacity_assign(x: np.ndarray, centers: np.ndarray, cap: int) -> np.ndarray:
    """Greedy capped assignment ordered by min-max score (``:92-119``)."""
    n, K = len(x), len(centers)
    d = ((x[:, None] - centers[None]) ** 2).sum(-1)
    scores = d.min(axis=1) - d.max(axis=1)
    order = np.argsort(scores)
    pref = np.argsort(d, axis=1)
    sizes = np.zeros(K, np.int64)
    clusters = np.zeros(n, np.int64)
    for i in order:
        for c in pref[i]:
            if sizes[c] < cap:
                sizes[c] += 1
                clusters[i] = c
                break
    return clusters


def swap_refine(x: np.ndarray, clusters: np.ndarray, cap: int, max_rounds: int = 1000):
    """Move/pair-swap refinement until convergence (``:122-193,200-214``)."""
    n = len(x)
    K = clusters.max() + 1
    for _ in range(max_rounds):
        centers = np.zeros((K, x.shape[-1]), np.float64)
        np.add.at(centers, clusters, x)
        counts = np.bincount(clusters, minlength=K)
        centers /= np.maximum(counts, 1)[:, None]
        sizes = counts.copy()

        d = ((x[:, None] - centers[None]) ** 2).sum(-1)
        cur = d[np.arange(n), clusters]
        delta = cur - d.min(axis=1)
        order = np.argsort(delta)[::-1]

        wanting = [[] for _ in range(K)]
        n_swaps = 0
        for i in order:
            ci = clusters[i]
            if d[i].argmin() == ci:
                break
            moved = False
            for j in np.argsort(d[i]):
                if j == ci:
                    break
                if d[i, ci] > d[i, j] and sizes[j] < cap:
                    sizes[ci] -= 1
                    sizes[j] += 1
                    clusters[i] = j
                    moved = True
                    n_swaps += 1
                    break
                cand = wanting[j]
                if cand:
                    gains = np.array(
                        [
                            -d[i, ci] - d[k, clusters[k]] + d[i, clusters[k]] + d[k, ci]
                            for k in cand
                        ]
                    )
                    gi = int(gains.argmin())
                    if gains[gi] < 0:
                        k = cand.pop(gi)
                        clusters[k] = ci
                        clusters[i] = j
                        moved = True
                        n_swaps += 1
                        break
            if not moved:
                wanting[clusters[i]].append(i)
        if n_swaps == 0:
            break
    return clusters


def constrained_kmeans(points: np.ndarray, max_cluster_size: int, seed: int = 0) -> np.ndarray:
    """points (N, D) -> (C, max_cluster_size) member indices padded with -1
    (the reference's per-frame output layout, ``:219-229``)."""
    points = np.asarray(points, np.float64)
    n = len(points)
    K = int(np.ceil(n / max_cluster_size)) + 1
    rng = np.random.default_rng(seed)
    init = points[rng.permutation(n)[:K]]
    centers = kmeans(points, K, centers=init)
    clusters = capacity_assign(points, centers, max_cluster_size)
    clusters = swap_refine(points, clusters, max_cluster_size)

    out = np.full((K, max_cluster_size), -1, np.int64)
    for k in range(K):
        members = np.nonzero(clusters == k)[0]
        out[k, : len(members)] = members
    return out


def clusterize_pkl_dir(path: str, max_cluster_size: int, seed: int = 0) -> list[str]:
    """Process every trajectory pkl in ``path`` (``clusterize_mgn.py:232-265``).

    Meshes are static per trajectory, so one frame is clustered and
    broadcast over the 600 steps, as upstream effectively does."""
    saved = []
    for fname in sorted(os.listdir(path)):
        if not fname.endswith(".pkl") or "constrained" in fname:
            continue
        with open(os.path.join(path, fname), "rb") as f:
            data = pickle.load(f)
        pos = np.asarray(data["mesh_pos"], np.float64)
        clusters = constrained_kmeans(pos, max_cluster_size, seed=seed)
        stacked = np.repeat(clusters[None], 600, axis=0).astype(np.int32)
        out = os.path.join(path, f"constrained_kmeans_{max_cluster_size}_{fname[:-4]}.npy")
        np.save(out, stacked)
        saved.append(out)
    return saved


def clusterize_eagle_dir(path: str, max_cluster_size: int, seed: int = 0) -> list[str]:
    """EAGLE variant (``eagle/clusterize_fluent.py``): per-trajectory npz
    point clouds change per frame; cluster each frame, warm-starting k-means
    from the previous frame's centres."""
    saved = []
    for root, _, files in os.walk(path):
        if "sim.npz" not in files:
            continue
        data = np.load(os.path.join(root, "sim.npz"), mmap_mode="r")
        pc = np.asarray(data["pointcloud"])
        frames = []
        centers = None
        for t in range(pc.shape[0]):
            points = pc[t].astype(np.float64)
            n = len(points)
            K = int(np.ceil(n / max_cluster_size)) + 1
            if centers is None or len(centers) != K:
                rng = np.random.default_rng(seed)
                centers = points[rng.permutation(n)[:K]]
            centers = kmeans(points, K, centers=centers)
            clusters = capacity_assign(points, centers, max_cluster_size)
            clusters = swap_refine(points, clusters, max_cluster_size)
            out = np.full((K, max_cluster_size), -1, np.int64)
            for k in range(K):
                members = np.nonzero(clusters == k)[0]
                out[k, : len(members)] = members
            frames.append(out)
        arr = np.stack(frames).astype(np.int32)
        out_path = os.path.join(root, f"constrained_kmeans_{max_cluster_size}.npy")
        np.save(out_path, arr)
        saved.append(out_path)
    return saved


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--max_cluster_size", type=int, default=10)
    parser.add_argument("--path", default="./ds/MGN/cylinder_dataset/train")
    parser.add_argument("--eagle", action="store_true", help="EAGLE npz layout")
    args = parser.parse_args(argv)
    fn = clusterize_eagle_dir if args.eagle else clusterize_pkl_dir
    for p in fn(args.path, args.max_cluster_size):
        print("saved", p)


if __name__ == "__main__":
    main()
