"""ScanContext global place recognition as batched tensor ops.

Re-design of the reference's ScanContext
(``liorf/include/Scancontext.{h,cpp}``): the 20x60 polar max-height
descriptor is one scatter-max; ring-key candidate search is a brute-force
batched L2 top-k over the whole database (replacing nanoflann); the
shift-aligned cosine distance is evaluated for *all* 60 column shifts at
once (the reference prunes to ~10% of shifts via the sector key,
``Scancontext.cpp:116-148`` — evaluating all shifts is strictly more
thorough).

Constants follow the reference (``Scancontext.h:80-99``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

NUM_RING = 20
NUM_SECTOR = 60
MAX_RADIUS = 80.0
LIDAR_HEIGHT = 2.0
NUM_EXCLUDE_RECENT = 30
NUM_CANDIDATES = 3
SC_DIST_THRES = 0.3
SECTOR_ANGLE = 360.0 / NUM_SECTOR


def make_descriptor(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[N, 3] + mask -> [20, 60] polar max-height descriptor.

    Matches ``makeScancontext`` (Scancontext.cpp:151-195): z is offset by the
    lidar height, bins take the max z, empty bins are 0.
    """
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2] + LIDAR_HEIGHT
    r = torch.sqrt(x * x + y * y)
    theta = torch.rad2deg(torch.atan2(y, x))
    theta = torch.where(theta < 0, theta + 360.0, theta)

    ring = torch.clamp(torch.ceil(r / MAX_RADIUS * NUM_RING), 1, NUM_RING).to(torch.int64) - 1
    sector = torch.clamp(torch.ceil(theta / 360.0 * NUM_SECTOR), 1, NUM_SECTOR).to(torch.int64) - 1

    ok = mask & (r <= MAX_RADIUS)
    # rejected points go to a dump slot that is sliced off (scancontext.py:49)
    flat = torch.where(ok, ring * NUM_SECTOR + sector, NUM_RING * NUM_SECTOR)
    desc = torch.full(
        (NUM_RING * NUM_SECTOR + 1,), -torch.inf, dtype=torch.float32, device=xyz.device
    )
    desc = desc.scatter_reduce(  # out of place: also runs under torch.func.vmap
        0, flat, torch.where(ok, z, -torch.inf).to(torch.float32),
        reduce="amax", include_self=True,
    )
    desc = desc[:-1].reshape(NUM_RING, NUM_SECTOR)
    return torch.where(torch.isfinite(desc), desc, 0.0)


def ring_key(desc: torch.Tensor) -> torch.Tensor:
    """Rotation-invariant key: row-wise mean ([..., 20, 60] -> [..., 20])."""
    return torch.mean(desc, dim=-1)


def _shifted_cosine_distances(query: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """Column-shift-aligned SC distance.

    query [20, 60], cands [B, 20, 60] -> [B, 60] distance for each shift.
    distance(s) = 1 - mean over sector pairs (both non-empty) of the
    column cosine similarity, with candidate columns rotated by s.
    """
    def norm_cols(d):
        n = torch.linalg.norm(d, dim=-2, keepdim=True)
        nonzero = n[..., 0, :] > 0
        return d / torch.where(n > 0, n, 1.0), nonzero

    qn, q_nonzero = norm_cols(query)  # [20, 60], [60]
    cn, c_nonzero = norm_cols(cands)  # [B, 20, 60], [B, 60]

    # shift index matrix: shifted candidate col j = original col (j - s) % 60
    j = torch.arange(NUM_SECTOR, device=query.device)
    src = (j[None, :] - j[:, None]) % NUM_SECTOR  # [60 shifts, 60 cols]

    cn_sh = cn[:, :, src]  # [B, 20, 60, 60] — (batch, ring, shift, col)
    cz_sh = c_nonzero[:, src]  # [B, 60, 60]

    sims = torch.einsum("rj,brsj->bsj", qn, cn_sh)  # [B, 60, 60]
    both = q_nonzero[None, None, :] & cz_sh
    n_eff = torch.clamp(torch.sum(both, dim=-1), min=1)
    sim = torch.sum(torch.where(both, sims, 0.0), dim=-1) / n_eff
    return 1.0 - sim  # [B, 60]


class SCDetection(NamedTuple):
    index: torch.Tensor  # [] int matched keyframe, -1 if none
    distance: torch.Tensor  # [] best SC distance
    yaw: torch.Tensor  # [] rad yaw offset implied by the best shift


def _smallest_k(d: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries, equal values keeping the lower
    index first (``lax.top_k(-d, k)`` order, scancontext.py:114)."""
    return torch.argsort(d, stable=True)[:k]


def _first_argmin(d: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """argmin with the first-index tie-break of ``jnp.argmin``."""
    return torch.argsort(d, dim=dim, stable=True).select(dim, 0)


def rank_candidates(
    descriptors: torch.Tensor,  # [C, 20, 60] database slice (padded)
    ring_keys: torch.Tensor,  # [C, 20]
    searchable: torch.Tensor,  # [C] bool — which entries may be matched
    query_desc: torch.Tensor,  # [20, 60]
    query_key: torch.Tensor,  # [20]
    num_candidates: int,
):
    """Core of detectLoopClosureID over one database slice: ring-key k-NN
    prefilter, then shift-aligned SC distance over the survivors
    (Scancontext.cpp:253-344). Returns (best_dist, best_local_index,
    best_shift) — dist is +inf when nothing is searchable."""
    d2 = torch.sum((ring_keys - query_key[None, :]) ** 2, dim=-1)
    d2 = torch.where(searchable, d2, torch.inf)
    k = min(num_candidates, ring_keys.shape[0])
    cand_idx = _smallest_k(d2, k)
    cand_ok = torch.isfinite(d2[cand_idx])

    dists = _shifted_cosine_distances(query_desc, descriptors[cand_idx])  # [k, 60]
    best_shift = _first_argmin(dists, dim=-1)
    best_dist = torch.where(cand_ok, torch.min(dists, dim=-1).values, torch.inf)

    # a one-element index tensor: indexing with a 0-dim device tensor would
    # read it back to the host
    b = _first_argmin(best_dist).reshape(1)
    return best_dist[b][0], cand_idx[b][0], best_shift[b][0]


def detect_loop(
    descriptors: torch.Tensor,  # [C, 20, 60] database (padded)
    ring_keys: torch.Tensor,  # [C, 20]
    count,  # [] int number of valid entries (tensor or python int)
    query_desc: torch.Tensor,  # [20, 60]
    query_key: torch.Tensor,  # [20]
    num_candidates: int = NUM_CANDIDATES,
    exclude_recent: int = NUM_EXCLUDE_RECENT,
    dist_thresh: float = SC_DIST_THRES,
) -> SCDetection:
    """Find the best loop candidate for the query descriptor.

    Matches ``detectLoopClosureID`` (Scancontext.cpp:253-344): ring-key
    k-NN prefilter excluding the most recent `exclude_recent` keyframes,
    then shift-aligned SC distance, accepted under `dist_thresh`.
    """
    C = descriptors.shape[0]
    idxs = torch.arange(C, device=descriptors.device)
    searchable = idxs < (count - exclude_recent)

    dist, best_idx, best_shift = rank_candidates(
        descriptors, ring_keys, searchable, query_desc, query_key, num_candidates
    )
    found = dist < dist_thresh
    index = torch.where(found, best_idx, -1)
    yaw = best_shift.to(torch.float32) * math.radians(SECTOR_ANGLE)
    return SCDetection(index=index, distance=dist, yaw=yaw)
