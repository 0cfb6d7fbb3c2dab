"""Batched plane fitting for point-to-plane residuals.

Replaces the per-point Eigen ``colPivHouseholderQr`` 5-point plane fit of the
reference (``liorf/src/mapOptmization.cpp:1089-1122``) with one closed-form
batched eigen-decomposition across every scan point at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


# Batched 3x3 eigh on the card: cuSOLVER's batched solver refuses a batch of
# 32768 matrices or more (CUSOLVER_STATUS_INVALID_VALUE from its buffer-size
# query; 24576 runs; NVIDIA H100, torch 2.11 + CUDA 12.8), so a longer batch
# — several sessions' neighbourhoods stacked (pipeline/multistream.py) —
# goes in slices of the bench point's scan size. Each matrix is solved on
# its own either way.
_EIGH_BATCH = 16384


def _eigh(S: torch.Tensor):
    if S.shape[0] <= _EIGH_BATCH:
        return torch.linalg.eigh(S)
    parts = [torch.linalg.eigh(c) for c in torch.split(S, _EIGH_BATCH)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


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
    dtype = neighbors.dtype
    w = neighbor_mask.to(dtype)  # [N, k]
    cnt = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)  # [N, 1]
    centroid = torch.sum(neighbors * w[..., None], dim=-2) / cnt  # [N, 3]
    centered = (neighbors - centroid[..., None, :]) * w[..., None]

    # Scatter-matrix eigendecomposition: the normal is the eigenvector of
    # the smallest eigenvalue. Stays finite for degenerate (collinear)
    # neighborhoods, which are rejected via lambda_mid below. The batched
    # 3x3 eigh is a library call outside any kernel, as in the JAX package.
    S = torch.einsum("nki,nkj->nij", centered, centered) / cnt[..., None]
    lam, V = _eigh(S)  # ascending eigenvalues
    normal = V[..., :, 0]  # [N, 3]
    d = -torch.einsum("ni,ni->n", normal, centroid)

    resid = torch.abs(torch.einsum("nki,ni->nk", neighbors, normal) + d[..., None])
    ok_resid = torch.all(torch.where(neighbor_mask, resid, 0.0) <= max_resid, dim=-1)
    have_all = torch.all(neighbor_mask, dim=-1)
    # collinear neighborhoods have no defined plane: require real in-plane
    # spread in the second principal direction (~> 5 cm RMS)
    planar = lam[..., 1] > 2.5e-3
    return PlaneFit(normal=normal, d=d, valid=ok_resid & have_all & planar)
