"""Own reduced-HCT (Clough-Tocher) cubic mesh->grid interpolation.

A copy of ``fluid_llm_tpu/core/cubic.py`` (numpy, host side), with
:func:`resample_to_grid_cubic` in torch: one gather and a 9-term FMA on
the tensors' device.  As in the JAX package no module imports it; the
data pipeline resamples linearly (``core/interp.py``).

A replacement for the reference's vendored matplotlib
``CubicTriInterpolator`` (``src/_triinterpolate.py:287-1398`` is a verbatim
copy of matplotlib's HCT implementation).  Same interpolation space — the
*reduced* Hsieh-Clough-Tocher C1 element — but a different formulation:
instead of matplotlib's eccentricity-based shape-function tensors evaluated
per query, this module

  * constructs the 10 cubic Bezier ordinates of each of the 3 subtriangles
    in closed form from the 9 nodal DOFs (values + gradients), and
  * precomputes, per grid pixel, the containing triangle and its 9 DOF
    *weights*, so per-field evaluation is one gather + FMA — the same
    device-friendly shape as the linear path (``core/interp.py``).

Element construction (derived from the C1 Bernstein-Bezier conditions, not
copied): split macro-triangle (V0,V1,V2) at the barycenter Vc.  On the
subtriangle opposite Vk with vertices (Va, Vb, Vc):

  b300=f_a, b030=f_b                          (corner values)
  b210=f_a+df_a.(Vb-Va)/3, b120=f_b+df_b.(Va-Vb)/3     (outer-edge row)
  b201=c_a, b021=c_b with c_i=f_i+df_i.(Vc-Vi)/3       (corner->center)
  b111: the *reduced* condition — the derivative of a cubic along a
    transversal direction is quadratic in the edge parameter; forcing the
    normal derivative on the outer edge to be LINEAR zeroes its middle
    Bezier coefficient.  With a = (bary-direction components of the edge
    normal w.r.t. (Va,Vb,Vc)):
      b111 = [ (a1*(b300+b120) + a2*(b210+b030) + a3*(b201+b021))/2
               - a1*b210 - a2*b120 ] / a3
  C1 across the internal edges (Vi,Vc) has geometry-independent
    coefficients because V_opp = 3*Vc - Va - Vb exactly (barycentric
    (-1,-1,3)), giving the closed forms
      d_i = (b111(left subtri) + b111(right subtri) + c_i) / 3
      f_c = (d_0 + d_1 + d_2) / 3
  which fill b102=d_a, b012=d_b, b003=f_c.

Gradient estimators mirror matplotlib's semantics so results are
oracle-comparable (``tests/test_cubic.py``, ``tests/test_torch_cubic.py``):
  * ``user``  — caller-supplied (dz/dx, dz/dy);
  * ``geom``  — per-triangle linear-fit gradients averaged per node with
    apex-angle weights;
  * ``min_E`` — minimises the bending energy  E = integral of
    (u_xx^2 + u_yy^2 + 2 u_xy^2)  over the mesh with nodal values fixed.
    The element stiffness is assembled by *exact* quadrature (the Hessian
    of a cubic is linear, so the 3 edge-midpoint rule integrates its square
    exactly) and solved with a Jacobi-preconditioned CG started from the
    ``geom`` estimate (tol 1e-10, 1000 iters — matplotlib's settings; the
    minimiser is unique, so implementation details don't change the answer).

Coordinates are ptp-scaled exactly as matplotlib does (x/ptp(x), y/ptp(y)):
anisotropic scaling changes both the element (edge normals) and the energy,
so parity requires the same normalisation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# Bezier ordinate layout per subtriangle (barycentric exponents over
# (Va, Vb, Vc)) and the matching cubic Bernstein basis coefficients.
_ORD_INDEX = {
    (3, 0, 0): 0, (0, 3, 0): 1, (0, 0, 3): 2,
    (2, 1, 0): 3, (1, 2, 0): 4, (2, 0, 1): 5, (0, 2, 1): 6,
    (1, 1, 1): 7, (1, 0, 2): 8, (0, 1, 2): 9,
}
_ORD_EXP = np.array(sorted(_ORD_INDEX, key=_ORD_INDEX.get), dtype=np.int64)  # (10, 3)
# trinomial coefficients 3!/(i!j!k!)
from math import factorial as _fact

_ORD_MULT = np.array(
    [6 // (_fact(int(i)) * _fact(int(j)) * _fact(int(k))) for i, j, k in _ORD_EXP],
    dtype=np.float64,
)


def _cross2(a, b):
    """z of the cross product of 2-vectors (``np.cross`` on 2-vectors is
    deprecated in NumPy 2)."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _perp(v):
    """90-degree rotation: cross(a, p) == dot(_perp(a), p)."""
    return np.stack([-v[..., 1], v[..., 0]], axis=-1)


def _bary_grads(V):
    """Gradients of the 3 barycentric coordinates; V: (n, 3, 2) -> (n, 3, 2)."""
    D = _cross2(V[:, 1] - V[:, 0], V[:, 2] - V[:, 0])  # 2*signed area
    G = np.stack([_perp(V[:, (k + 2) % 3] - V[:, (k + 1) % 3]) for k in range(3)], axis=1)
    return G / D[:, None, None]


def _construct_ordinates(V, f, g):
    """Reduced-HCT Bezier ordinates for every (triangle, subtriangle).

    V: (n, 3, 2) scaled vertices; f: (n, 3) values; g: (n, 3, 2) gradients
    (in scaled coordinates).  Returns (n, 3, 10) — subtriangle k is the one
    opposite vertex k, with local vertex order (V_{k+1}, V_{k+2}, Vc).
    """
    n = V.shape[0]
    Vc = V.mean(axis=1)  # (n, 2)
    c = f + np.einsum("nkd,nkd->nk", Vc[:, None, :] - V, g) / 3.0  # corner->center

    b210 = np.empty((n, 3))
    b120 = np.empty((n, 3))
    b111 = np.empty((n, 3))
    for k in range(3):
        a, b = (k + 1) % 3, (k + 2) % 3
        e = V[:, b] - V[:, a]
        nrm = _perp(e)  # outer-edge normal (scaled coords; scale/sign cancel)
        subV = np.stack([V[:, a], V[:, b], Vc], axis=1)
        avec = np.einsum("nkd,nd->nk", _bary_grads(subV), nrm)  # (n, 3)
        b210[:, k] = f[:, a] + np.einsum("nd,nd->n", g[:, a], e) / 3.0
        b120[:, k] = f[:, b] - np.einsum("nd,nd->n", g[:, b], e) / 3.0
        b111[:, k] = (
            0.5 * (avec[:, 0] * (f[:, a] + b120[:, k])
                   + avec[:, 1] * (b210[:, k] + f[:, b])
                   + avec[:, 2] * (c[:, a] + c[:, b]))
            - avec[:, 0] * b210[:, k]
            - avec[:, 1] * b120[:, k]
        ) / avec[:, 2]

    d = np.empty((n, 3))
    for i in range(3):
        d[:, i] = (b111[:, (i + 1) % 3] + b111[:, (i + 2) % 3] + c[:, i]) / 3.0
    fc = d.mean(axis=1)

    ords = np.empty((n, 3, 10))
    for k in range(3):
        a, b = (k + 1) % 3, (k + 2) % 3
        ords[:, k, 0] = f[:, a]
        ords[:, k, 1] = f[:, b]
        ords[:, k, 2] = fc
        ords[:, k, 3] = b210[:, k]
        ords[:, k, 4] = b120[:, k]
        ords[:, k, 5] = c[:, a]
        ords[:, k, 6] = c[:, b]
        ords[:, k, 7] = b111[:, k]
        ords[:, k, 8] = d[:, a]
        ords[:, k, 9] = d[:, b]
    return ords


def _sub_coords(tau):
    """Macro barycentric (m, 3) -> (subtri k, local (s1, s2, s3))."""
    k = np.argmin(tau, axis=1)
    idx = np.arange(tau.shape[0])
    tk = tau[idx, k]
    s = np.stack([tau[idx, (k + 1) % 3] - tk, tau[idx, (k + 2) % 3] - tk, 3.0 * tk], axis=1)
    return k, s


def _basis(s):
    """Cubic Bernstein basis in ordinate layout; s: (m, 3) -> (m, 10)."""
    powers = s[:, None, :] ** _ORD_EXP[None, :, :]  # (m, 10, 3)
    return _ORD_MULT[None, :] * powers.prod(axis=2)


def _hessian_map(subV, ords_slots):
    """Directional-difference Hessian of the cubic from its ordinates.

    subV: (n, 3, 2) subtriangle vertices (scaled); ords_slots: (n, ..., 10).
    Returns a function s -> (n, ..., 3) giving (u_xx, u_yy, u_xy) at
    sub-barycentric point s (3-vector).  Uses
      D_a D_b u (s) = 6 * sum_{|g|=1} s_g * sum_{k,l} a_k b_l B[g+e_k+e_l].
    """
    G = _bary_grads(subV)  # (n, 3, 2)
    ax, ay = G[..., 0], G[..., 1]  # (n, 3) bary components of d/dx, d/dy

    # T[g, k, l] -> ordinate index of exponent e_g + e_k + e_l
    T = np.empty((3, 3, 3), dtype=np.int64)
    for gi in range(3):
        for k in range(3):
            for li in range(3):
                e = [0, 0, 0]
                for m in (gi, k, li):
                    e[m] += 1
                T[gi, k, li] = _ORD_INDEX[tuple(e)]

    def hess(s):
        # second differences per direction pair, per edge-row g
        out = []
        for (u, v) in ((ax, ax), (ay, ay), (ax, ay)):
            acc = 0.0
            for gi in range(3):
                # sum_{k,l} u_k v_l B[T[gi,k,l]]
                inner = 0.0
                for k in range(3):
                    for li in range(3):
                        inner = inner + (u[:, k] * v[:, li])[
                            (...,) + (None,) * (ords_slots.ndim - 2)
                        ] * ords_slots[..., T[gi, k, li]]
                acc = acc + s[gi] * inner
            out.append(6.0 * acc)
        return np.stack(out, axis=-1)  # (n, ..., 3)

    return hess


def _unit_dof_ordinates(V):
    """Ordinates of the 9 unit DOF vectors for every triangle: (ntri, 9, 3, 10).

    DOF j = (node, component): component 0 is the nodal value, 1/2 the nodal
    x/y gradient (scaled coords).  Shared by the min-E energy assembly and
    the per-pixel weight precompute (``get_cubic_mesh_interpolation``)."""
    ntri = V.shape[0]
    unit_ords = np.empty((ntri, 9, 3, 10))
    for j in range(9):
        node, comp = divmod(j, 3)
        f = np.zeros((ntri, 3))
        g = np.zeros((ntri, 3, 2))
        if comp == 0:
            f[:, node] = 1.0
        else:
            g[:, node, comp - 1] = 1.0
        unit_ords[:, j] = _construct_ordinates(V, f, g)
    return unit_ords


def _jacobi_pcg(rows, cols, vals, b, x0, tol=1e-10, maxiter=1000):
    """Jacobi-preconditioned CG on a COO matrix (duplicates summed)."""
    n = b.shape[0]

    def matvec(x):
        return np.bincount(rows, weights=vals * x[cols], minlength=n)

    diag = np.bincount(rows[rows == cols], weights=vals[rows == cols], minlength=n)
    diag = np.where(diag > 0, diag, 1.0)
    x = x0.copy()
    r = b - matvec(x)
    z = r / diag
    p = z.copy()
    rz = r @ z
    for _ in range(maxiter):
        if np.sqrt(r @ r) < tol:
            break
        Ap = matvec(p)
        alpha = rz / (p @ Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = r / diag
        rz_new = r @ z
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x, float(np.sqrt(r @ r))


class CubicTriInterpolator:
    """Reduced-HCT interpolator over a triangulation (host-side precompute).

    ``pos``: (N, 2) node coordinates; ``faces``: (ntri, 3); ``kind``:
    "min_E" | "geom" | "user" (with ``dz=(dzdx, dzdy)``).
    """

    def __init__(self, pos, faces, z, kind="min_E", dz=None):
        self._setup(pos, faces, z)
        g_nodes = self._estimate_gradients(kind, dz)  # (N, 2) scaled coords
        self.ords = _construct_ordinates(self.V, self.z[self.faces], g_nodes[self.faces])

    @classmethod
    def _bare(cls, pos, faces, z):
        """Geometry + values only — for callers that need the gradient
        estimators without building interpolation ordinates
        (``estimate_gradients``)."""
        self = cls.__new__(cls)
        self._setup(pos, faces, z)
        return self

    def _setup(self, pos, faces, z):
        pos = np.asarray(pos, np.float64)
        self.faces = np.asarray(faces, np.int64)
        self.unit_x = float(np.ptp(pos[:, 0]))
        self.unit_y = float(np.ptp(pos[:, 1]))
        self.pts = np.column_stack([pos[:, 0] / self.unit_x, pos[:, 1] / self.unit_y])
        self.V = self.pts[self.faces]  # (ntri, 3, 2) scaled
        self.z = np.asarray(z, np.float64)

    # -- gradient estimation -------------------------------------------------

    def _tri_linear_grads(self):
        """Per-triangle gradient of the linear fit (scaled coords)."""
        V, z = self.V, self.z[self.faces]
        d1, d2 = V[:, 1] - V[:, 0], V[:, 2] - V[:, 0]
        dz1, dz2 = z[:, 1] - z[:, 0], z[:, 2] - z[:, 0]
        D = _cross2(d1, d2)
        gx = (dz1 * d2[:, 1] - dz2 * d1[:, 1]) / D
        gy = (dz2 * d1[:, 0] - dz1 * d2[:, 0]) / D
        return np.stack([gx, gy], axis=1)  # (ntri, 2)

    def _geom_gradients(self):
        """Apex-angle-weighted average of per-triangle gradients
        (algorithm of matplotlib's ``_DOF_estimator_geom``)."""
        V = self.V
        w = np.empty((V.shape[0], 3))
        for i in range(3):
            e1 = V[:, (i + 1) % 3] - V[:, i]
            e2 = V[:, (i + 2) % 3] - V[:, i]
            alpha1 = np.arctan2(e1[:, 1], e1[:, 0])
            alpha2 = np.arctan2(e2[:, 1], e2[:, 0])
            angle = np.abs(((alpha2 - alpha1) / np.pi) % 1)
            w[:, i] = 0.5 - np.abs(angle - 0.5)
        tg = self._tri_linear_grads()
        n_nodes = self.pts.shape[0]
        wsum = np.bincount(self.faces.ravel(), weights=w.ravel(), minlength=n_nodes)
        g = np.empty((n_nodes, 2))
        for d in range(2):
            g[:, d] = np.bincount(
                self.faces.ravel(), weights=(w * tg[:, d:d + 1]).ravel(), minlength=n_nodes
            ) / wsum
        return g

    def _min_E_gradients(self):
        """Bending-energy-minimising gradients: assemble + Jacobi-PCG."""
        ntri = self.V.shape[0]
        n_nodes = self.pts.shape[0]

        # element DOF -> Hessian-at-quadrature map, via unit-DOF ordinates
        unit_ords = _unit_dof_ordinates(self.V)

        area = 0.5 * np.abs(_cross2(self.V[:, 1] - self.V[:, 0], self.V[:, 2] - self.V[:, 0]))
        wq = area / 9.0  # subtri area / 3 quadrature points
        quad = [np.array([0.5, 0.5, 0.0]), np.array([0.0, 0.5, 0.5]), np.array([0.5, 0.0, 0.5])]
        Ew = np.array([1.0, 1.0, 2.0])

        Vc = self.V.mean(axis=1)
        K = np.zeros((ntri, 9, 9))
        for k in range(3):
            a, b = (k + 1) % 3, (k + 2) % 3
            subV = np.stack([self.V[:, a], self.V[:, b], Vc], axis=1)
            hess = _hessian_map(subV, unit_ords[:, :, k, :])  # -> (ntri, 9, 3)
            for s in quad:
                H = hess(s)  # (ntri, 9dof, 3comp)
                K += wq[:, None, None] * np.einsum("nic,c,njc->nij", H, Ew, H)

        # global DOFs: values fixed (condensed), gradients free (2 per node)
        free = np.array([1, 2, 4, 5, 7, 8])
        fixed = np.array([0, 3, 6])
        gdof = np.empty((ntri, 9), dtype=np.int64)
        for node in range(3):
            gdof[:, node * 3 + 0] = -1
            gdof[:, node * 3 + 1] = self.faces[:, node] * 2
            gdof[:, node * 3 + 2] = self.faces[:, node] * 2 + 1
        Kff = K[:, free][:, :, free]
        rows = np.repeat(gdof[:, free], 6, axis=1).ravel()
        cols = np.tile(gdof[:, free], (1, 6)).ravel()
        vals = Kff.reshape(ntri, -1).ravel()
        Uc = self.z[self.faces]  # (ntri, 3)
        Ff_elem = -np.einsum("nij,nj->ni", K[:, free][:, :, fixed], Uc)
        nf = 2 * n_nodes
        Ff = np.bincount(gdof[:, free].ravel(), weights=Ff_elem.ravel(), minlength=nf)

        x0 = self._geom_gradients().ravel()
        x, err = _jacobi_pcg(rows, cols, vals, Ff, x0, tol=1e-10, maxiter=1000)
        if err > np.linalg.norm(
            np.bincount(rows, weights=vals * x0[cols], minlength=nf) - Ff
        ):
            x = x0  # keep the better guess (matplotlib fallback semantics)
        return x.reshape(n_nodes, 2)

    def _estimate_gradients(self, kind, dz):
        if kind == "user":
            if dz is None:
                raise ValueError("kind='user' requires dz=(dzdx, dzdy)")
            dzdx, dzdy = dz
            return np.column_stack(
                [np.asarray(dzdx, np.float64) * self.unit_x,
                 np.asarray(dzdy, np.float64) * self.unit_y]
            )
        if kind == "geom":
            return self._geom_gradients()
        if kind == "min_E":
            return self._min_E_gradients()
        raise ValueError(f"unknown kind {kind!r}")

    # -- evaluation ----------------------------------------------------------

    def _bary(self, tri_idx, x, y):
        xs = np.asarray(x, np.float64) / self.unit_x
        ys = np.asarray(y, np.float64) / self.unit_y
        V = self.V[tri_idx]
        G = _bary_grads(V)
        p = np.stack([xs, ys], axis=-1)
        tau = 1.0 / 3.0 + np.einsum("mkd,md->mk", G, p - V.mean(axis=1))
        return tau

    def evaluate(self, tri_idx, x, y):
        """Values at points known to lie in triangle ``tri_idx`` (flat arrays)."""
        tri_idx = np.asarray(tri_idx, np.int64)
        tau = self._bary(tri_idx, x, y)
        k, s = _sub_coords(tau)
        return np.einsum("mo,mo->m", _basis(s), self.ords[tri_idx, k])


@dataclass
class CubicMeshInterp:
    """Precomputed per-pixel data for device-side cubic resampling.

    value(pixel) is linear in the 9 DOFs of its containing triangle, so each
    pixel carries its 3 node indices and 9 weights; per-field evaluation is
    one gather + FMA (``resample_to_grid_cubic``), the same device-friendly
    shape as the linear path (``core/interp.py``).  The gradient weights are
    expressed in RAW units (the ptp scaling is folded in), so callers pass
    plain d/dx, d/dy nodal gradients from ``estimate_gradients``.
    """

    vert_idx: np.ndarray  # (H, W, 3) int32
    wf: np.ndarray  # (H, W, 3) f64 — weights of nodal values
    wgx: np.ndarray  # (H, W, 3) f64 — weights of nodal d/dx
    wgy: np.ndarray  # (H, W, 3) f64 — weights of nodal d/dy
    mask: np.ndarray  # (H, W) bool, True outside the mesh


def get_cubic_mesh_interpolation(pos, faces, grid_x, grid_y) -> CubicMeshInterp:
    """Build per-pixel cubic weights once per (mesh, grid) pair."""
    from fluid_llm_tpu_torch.core.triangulation import locate_triangles

    pos = np.asarray(pos, np.float64)
    faces = np.asarray(faces, np.int64)
    unit_x, unit_y = float(np.ptp(pos[:, 0])), float(np.ptp(pos[:, 1]))
    pts = np.column_stack([pos[:, 0] / unit_x, pos[:, 1] / unit_y])
    V = pts[faces]

    tri_index = locate_triangles(pos, faces, grid_x, grid_y)
    mask = tri_index == -1
    inside = ~mask.ravel()
    tri = tri_index.ravel()[inside].astype(np.int64)

    # ordinates of the 9 unit DOF vectors, for every triangle
    unit_ords = _unit_dof_ordinates(V)

    # pixel -> (subtri, basis)
    xs = np.ravel(grid_x)[inside] / unit_x
    ys = np.ravel(grid_y)[inside] / unit_y
    Vt = V[tri]
    G = _bary_grads(Vt)
    p = np.stack([xs, ys], axis=-1)
    tau = 1.0 / 3.0 + np.einsum("mkd,md->mk", G, p - Vt.mean(axis=1))
    k, s = _sub_coords(tau)
    basis = _basis(s)  # (m, 10)

    w9 = np.einsum("mo,mjo->mj", basis, unit_ords[tri, :, k, :])  # (m, 9)

    H, W = mask.shape
    vert_idx = np.zeros((H * W, 3), np.int32)
    # f64 weights: the host evaluators below consume them at full
    # precision; the device path casts at the boundary
    wf = np.zeros((H * W, 3), np.float64)
    wgx = np.zeros((H * W, 3), np.float64)
    wgy = np.zeros((H * W, 3), np.float64)
    vert_idx[inside] = faces[tri].astype(np.int32)
    wf[inside] = w9[:, 0::3]
    # fold the coordinate scaling into the gradient weights: construction
    # consumed gradients in scaled coords (g_scaled = g_raw * unit)
    wgx[inside] = w9[:, 1::3] * unit_x
    wgy[inside] = w9[:, 2::3] * unit_y
    return CubicMeshInterp(
        vert_idx.reshape(H, W, 3), wf.reshape(H, W, 3),
        wgx.reshape(H, W, 3), wgy.reshape(H, W, 3), mask,
    )


def estimate_gradients(pos, faces, z, kind="min_E", dz=None):
    """Nodal (d/dx, d/dy) in raw units, per the chosen estimator."""
    interp = CubicTriInterpolator._bare(pos, faces, z)
    g = interp._estimate_gradients(kind, dz)
    return g[:, 0] / interp.unit_x, g[:, 1] / interp.unit_y


def resample_to_grid_cubic(values, gx, gy, vert_idx, wf, wgx, wgy, mask):
    """Device-side cubic resample: one gather + 9-term FMA.

    values/gx/gy: ``(..., N_nodes)`` tensors; the pixel tables
    (``CubicMeshInterp``'s arrays or tensors) go to their device and dtype.
    Returns ``(..., H, W)`` with masked pixels exactly 0 (``to_grid``
    semantics).
    """
    dev, dt = values.device, values.dtype
    idx = torch.as_tensor(vert_idx, device=dev).long()
    H, W, _ = idx.shape
    flat = idx.reshape(-1)

    def term(nodal, w):
        g = nodal.index_select(-1, flat).reshape(*nodal.shape[:-1], H, W, 3)
        return (g * torch.as_tensor(w, device=dev).to(dt)).sum(-1)

    out = term(values, wf) + term(gx, wgx) + term(gy, wgy)
    return torch.where(torch.as_tensor(mask, device=dev), torch.zeros((), dtype=dt, device=dev),
                       out)


def _host_cubic_eval(interp: CubicMeshInterp, val, gx, gy):
    """f64 host evaluation with the precomputed pixel weights."""
    out = (
        np.einsum("hwk,hwk->hw", val[interp.vert_idx], interp.wf)
        + np.einsum("hwk,hwk->hw", gx[interp.vert_idx], interp.wgx)
        + np.einsum("hwk,hwk->hw", gy[interp.vert_idx], interp.wgy)
    )
    return np.where(interp.mask, 0.0, out).astype(np.float32)


def to_grid_cubic(val, pos, faces, grid_x, grid_y, kind="min_E", dz=None):
    """Cubic-interpolate a nodal field onto the grid; masked pixels -> 0.

    Drop-in for the previous matplotlib-delegating implementation (same
    signature/semantics as the linear ``to_grid``): returns (data, mask).
    Evaluation goes through the same precomputed per-pixel weights as the
    device path (``resample_to_grid_cubic``), so there is exactly ONE
    evaluation pipeline — the interpolant is linear in the 9 DOFs, making
    the weight formulation identical to direct HCT evaluation.
    """
    interp = get_cubic_mesh_interpolation(pos, faces, grid_x, grid_y)
    val = np.asarray(val, np.float64)
    gx, gy = estimate_gradients(pos, faces, val, kind, dz)
    return _host_cubic_eval(interp, val, gx, gy), interp.mask


def resample_sequence_cubic(node_states, pos, faces, grid_x, grid_y, kind="min_E"):
    """(T, C, N_nodes) -> (T, C, H, W) cubic-resampled window.

    The pixel weights are built ONCE; each field estimates its nodal
    gradients (per-field, like the reference) and evaluation is a
    gather + 9-term FMA per pixel.
    """
    interp = get_cubic_mesh_interpolation(pos, faces, grid_x, grid_y)
    T, C = node_states.shape[:2]
    out = np.zeros((T, C) + interp.mask.shape, np.float32)
    for t in range(T):
        for c in range(C):
            val = np.asarray(node_states[t, c], np.float64)
            gx, gy = estimate_gradients(pos, faces, val, kind)
            out[t, c] = _host_cubic_eval(interp, val, gx, gy)
    return out, interp.mask
