"""Batched plane fitting for point-to-plane residuals.

Replaces the per-point Eigen ``colPivHouseholderQr`` 5-point plane fit of the
reference (``liorf/src/mapOptmization.cpp:1089-1122``) with a closed-form
symmetric 3x3 eigen-solver across every scan point at once: cyclic Jacobi
rotations (:func:`jacobi_eigh`), a fixed number of sweeps, no library call.

The trigonometric (Cardano) closed form is not used: it loses the smallest
eigenvector's accuracy when the two smallest eigenvalues are close, the
near-collinear neighbourhoods the ``lam[1]`` gate below has to judge.

Every operation is rounded on its own and every sum over the neighbours is
the halving tree of ``ops/fusion_step.py::tree_sum``: the order the scan
matcher's linearization kernel (``csrc/scan_gn.cu``) keeps, so that on the
card the kernel and this module agree bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .fusion_step import tree_sum

# Sweeps of the float32 3x3 solve: over 3000 seeded matrices (random,
# condition numbers to 1e12, clustered eigenvalues, rank-deficient) the
# largest off-diagonal entry left over the largest input entry was 4e-6
# after 3 sweeps, 5e-24 after 4 and 0 after 5.
JACOBI3_SWEEPS = 5


def _rotate(A: torch.Tensor, V: torch.Tensor, p: int, q: int) -> None:
    """One Jacobi rotation of the symmetric A [..., n, n] in the plane (p, q),
    accumulated into V's columns, in place: tau = (a_qq - a_pp) / (2 a_pq),
    t = sign(tau) / (|tau| + sqrt(tau^2 + 1)) (sign(0) = 1; t = 0 where
    a_pq = 0), c = 1 / sqrt(t^2 + 1), s = t c; a_pp -= t a_pq, a_qq += t a_pq,
    a_pq = 0, a_rp = c a_rp - s a_rq and a_rq = s a_rp + c a_rq for the other
    rows (and columns), the same on V's columns p and q (``csrc/gn_common.cuh::rotate``)."""
    app, aqq, apq = A[..., p, p], A[..., q, q], A[..., p, q]
    one = torch.ones_like(apq)
    nz = apq != 0
    tau = (aqq - app) / (2.0 * torch.where(nz, apq, one))
    t = torch.where(tau >= 0, one, -one) / (torch.abs(tau) + torch.sqrt(tau * tau + 1.0))
    t = torch.where(nz, t, torch.zeros_like(t))
    c = one / torch.sqrt(t * t + 1.0)
    s = t * c
    new_pp, new_qq = app - t * apq, aqq + t * apq
    cc, ss = c[..., None], s[..., None]
    colp, colq = A[..., :, p], A[..., :, q]
    newp = cc * colp - ss * colq
    newq = ss * colp + cc * colq
    newp[..., p] = new_pp
    newp[..., q] = 0.0
    newq[..., q] = new_qq
    newq[..., p] = 0.0
    A[..., :, p] = newp
    A[..., p, :] = newp
    A[..., :, q] = newq
    A[..., q, :] = newq
    vp, vq = V[..., :, p], V[..., :, q]
    nvp = cc * vp - ss * vq
    nvq = ss * vp + cc * vq
    V[..., :, p] = nvp
    V[..., :, q] = nvq


def jacobi_eigh(S: torch.Tensor, sweeps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues [..., n] (unsorted) and eigenvectors (columns of [..., n, n])
    of the symmetric S by ``sweeps`` cyclic Jacobi sweeps over the pairs
    (p, q), p < q, row by row, in S's dtype. An eigenvector's sign is the
    rotations' own (not LAPACK's)."""
    n = S.shape[-1]
    A = S.clone()
    V = torch.eye(n, dtype=S.dtype, device=S.device).expand(S.shape).clone()
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                _rotate(A, V, p, q)
    return torch.diagonal(A, dim1=-2, dim2=-1), V


def smallest_and_middle(lam: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Of three unsorted eigenvalues [..., 3]: the index of the smallest (the
    first on a tie) and the middle value, max(min(l0, l1), min(max(l0, l1), l2)),
    by comparisons alone (``csrc/scan_gn.cu`` takes the same branches)."""
    l0, l1, l2 = lam[..., 0], lam[..., 1], lam[..., 2]
    lt = l1 < l0
    low = torch.where(lt, l1, l0)
    idx = torch.where(lt, 1, 0)
    idx = torch.where(l2 < low, 2, idx)
    hi01 = torch.where(l1 > l0, l1, l0)
    m2 = torch.where(l2 < hi01, l2, hi01)
    mid = torch.where(m2 > low, m2, low)
    return idx, mid


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a0 b0 + a1 b1) + a2 b2 over the last axis."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


class PlaneFit(NamedTuple):
    normal: torch.Tensor  # [N, 3] unit plane normal
    d: torch.Tensor  # [N] plane offset: n.p + d = 0 for points on the plane
    valid: torch.Tensor  # [N] fit validity


def fit_planes(
    neighbors: torch.Tensor,
    neighbor_mask: torch.Tensor,
    max_resid: float = 0.2,
) -> PlaneFit:
    """Fit a plane through each point's k neighbors.

    neighbors: [N, k, 3]; neighbor_mask: [N, k]. A fit is valid when all k
    neighbors lie within `max_resid` of the plane (reference threshold 0.2 m,
    mapOptmization.cpp:1114-1122) and the neighborhood is not collinear.
    """
    w = neighbor_mask.to(neighbors.dtype)  # [N, k]
    cnt = tree_sum(w, -1)
    cnt = torch.where(cnt < 1.0, torch.ones_like(cnt), cnt)  # [N]
    centroid = tree_sum(neighbors * w[..., None], -2) / cnt[..., None]  # [N, 3]
    centered = (neighbors - centroid[..., None, :]) * w[..., None]

    # Scatter-matrix eigendecomposition: the normal is the eigenvector of
    # the smallest eigenvalue. Stays finite for degenerate (collinear)
    # neighborhoods, which are rejected via the middle eigenvalue below.
    S = torch.stack([
        torch.stack([tree_sum(centered[..., i] * centered[..., j], -1) / cnt for j in range(3)], -1)
        for i in range(3)
    ], -2)  # [N, 3, 3]
    lam, V = jacobi_eigh(S, JACOBI3_SWEEPS)
    low, mid = smallest_and_middle(lam)
    normal = torch.gather(V, -1, low[..., None, None].expand(*low.shape, 3, 1))[..., 0]
    d = -dot3(normal, centroid)

    resid = torch.abs(dot3(neighbors, normal[..., None, :]) + d[..., None])
    ok_resid = torch.all(torch.where(neighbor_mask, resid, 0.0) <= max_resid, dim=-1)
    have_all = torch.all(neighbor_mask, dim=-1)
    # collinear neighborhoods have no defined plane: require real in-plane
    # spread in the second principal direction (~> 5 cm RMS)
    planar = mid > 2.5e-3
    return PlaneFit(normal=normal, d=d, valid=ok_resid & have_all & planar)
