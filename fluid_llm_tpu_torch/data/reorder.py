"""Static node relabeling of a trajectory window: RCM or cluster-major.

A copy of ``fluid_llm_tpu/data/reorder.py`` (numpy and scipy).  The JAX
package relabels so that its window-local TPU kernels can take the
unsorted ids; the CUDA kernels take any ids, and the relabeling stays
because ``baselines_cli`` relabels as the JAX CLI does (``rcm`` in f32), so
the two CLIs see the same batches, and because banded ids keep a gather's
rows close together in the card's caches.

- ``rcm``: reverse Cuthill-McKee on the mesh graph bounds ``|u - v|`` for
  every edge by the mesh bandwidth.
- ``cluster`` (where a cluster table exists): nodes grouped by cluster,
  clusters RCM-ordered on their own adjacency graph, members by ascending
  old id.

Positions, states, types, faces, edge endpoints and cluster tables all
relabel consistently, and the models are permutation-equivariant, so the
physics is the same.  The order is cached per topology.
"""

from __future__ import annotations

import hashlib

import numpy as np

from fluid_llm_tpu_torch.data.eagle_mesh import GraphSample

_CACHE: dict[bytes, np.ndarray] = {}
_CACHE_CAP = 256


def _digest(*arrays) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.digest()


def rcm_node_order(edges: np.ndarray, n: int) -> np.ndarray:
    """Reverse Cuthill-McKee order (new -> old) of the mesh nodes."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    e = edges[(edges[:, 0] >= 0) & (edges[:, 0] < n)
              & (edges[:, 1] >= 0) & (edges[:, 1] < n)]
    adj = coo_matrix(
        (np.ones(len(e), np.int8), (e[:, 0], e[:, 1])), shape=(n, n)
    ).tocsr()
    return np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True), dtype=np.int64)


def cluster_major_order(cluster0: np.ndarray, edges: np.ndarray, n: int) -> np.ndarray:
    """Node order (new -> old): nodes grouped by cluster, clusters
    RCM-ordered on their adjacency graph (two clusters are adjacent when a
    mesh edge links them), members within a cluster by ascending old id."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    C = cluster0.shape[0]
    node2cluster = np.full(n, C, np.int64)  # unassigned -> end
    for c in range(C):
        m = cluster0[c]
        m = m[(m >= 0) & (m < n)]
        node2cluster[m] = c

    cu = node2cluster[np.clip(edges[:, 0], 0, n - 1)]
    cv = node2cluster[np.clip(edges[:, 1], 0, n - 1)]
    ok = (cu < C) & (cv < C)
    cadj = coo_matrix(
        (np.ones(ok.sum(), np.int8), (cu[ok], cv[ok])), shape=(C, C)
    ).tocsr()
    corder = np.asarray(reverse_cuthill_mckee(cadj, symmetric_mode=True), dtype=np.int64)
    crank = np.empty(C + 1, np.int64)
    crank[corder] = np.arange(C)
    crank[C] = C

    key = crank[node2cluster]
    return np.lexsort((np.arange(n), key))


def _remap_cluster(cluster: np.ndarray, rank: np.ndarray, n: int) -> np.ndarray:
    """(T, C, K) member table -> new ids, members ascending per row (-1 pads
    trail), rows ordered by first member."""
    T, C, K = cluster.shape
    out = np.full_like(cluster, -1)
    big = np.int64(2**60)
    for t in range(T):
        cl = cluster[t]
        valid = (cl >= 0) & (cl < n)
        mapped = np.where(valid, rank[np.clip(cl, 0, n - 1)], big)
        mapped = np.sort(mapped, axis=1)  # pads (big) trail
        rows = np.argsort(mapped[:, 0], kind="stable")
        mapped = mapped[rows]
        out[t] = np.where(mapped < big, mapped, -1)
    return out


def reorder_sample(sample: GraphSample, mode: str = "cluster") -> GraphSample:
    """Relabel one trajectory window: ``mode="cluster"`` cluster-major where
    a cluster table exists (RCM otherwise), ``mode="rcm"`` RCM always."""
    n = sample.mesh_pos.shape[1]
    cl0 = (sample.cluster[0]
           if sample.cluster is not None and mode == "cluster" else None)
    key = _digest(sample.edges, *([cl0] if cl0 is not None else []))
    order = _CACHE.get(key)
    if order is None:
        if cl0 is not None:
            order = cluster_major_order(np.asarray(cl0, np.int64),
                                        sample.edges.astype(np.int64), n)
        else:
            order = rcm_node_order(sample.edges.astype(np.int64), n)
        if len(_CACHE) >= _CACHE_CAP:
            _CACHE.clear()
        _CACHE[key] = order

    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)

    re = rank[sample.edges.astype(np.int64)]
    re = re[np.lexsort((re[:, 1], re[:, 0]))].astype(sample.edges.dtype)

    cluster = None
    if sample.cluster is not None:
        cluster = _remap_cluster(np.asarray(sample.cluster, np.int64), rank, n)

    faces = rank[sample.faces.astype(np.int64)] if sample.faces is not None else None
    return GraphSample(
        mesh_pos=sample.mesh_pos[:, order],
        edges=re,
        state=sample.state[:, order],
        node_type=sample.node_type[:, order],
        cluster=cluster,
        faces=faces,
    )
