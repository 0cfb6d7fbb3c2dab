"""Multi-rank front-end: point-sharded registration and keyframe-sharded
ScanContext search.

* **Registration data parallelism** — the reference parallelizes the
  per-point correspondence search with OpenMP (mapOptmization.cpp:1078).
  Here the scan's points are split in contiguous blocks over the ranks;
  every rank searches its block against the (replicated) local-map grid —
  one K1 launch per GN iteration on its block — and the 6x6 normal
  equations are all-reduced, so every rank steps the pose identically. One
  collective of 36 + 6 + 1 floats per GN iteration, whatever the scan size.

* **ScanContext database sharding** — the database (descriptors + ring
  keys) is split over keyframes; each rank ranks its own block with the
  single-device core (``ops.scancontext.rank_candidates``) and global
  indices, and the best of the all-gathered per-rank winners (3 scalars a
  rank) is taken. The union of per-rank top-k is a superset of the global
  top-k, so the sharded search is at least as thorough as the single one.
"""

from __future__ import annotations

import math

import torch

from ..ops import scancontext as sc
from ..ops.knn import SpatialHashGrid
from ..ops.scan_match import ScanMatchParams, ScanMatchResult, scan_to_map
from .sharded import GraphMesh


# ---------------------------------------------------------------------------
# point-sharded scan-to-map registration
# ---------------------------------------------------------------------------
def scan_to_map_sharded(
    scan_xyz: torch.Tensor,
    scan_mask: torch.Tensor,
    grid: SpatialHashGrid,
    init_pose: torch.Tensor,
    mesh: GraphMesh,
    params: ScanMatchParams = ScanMatchParams(),
) -> ScanMatchResult:
    """scan_to_map with the scan's points split over the mesh's ranks.

    Every rank passes the whole scan; a length that does not divide the
    world size is padded with masked points. Returns the same result on
    every rank, equal to the single-device matcher's up to the order of the
    normal equations' sums."""
    return scan_to_map(scan_xyz, scan_mask, grid, init_pose, params, mesh=mesh)


# ---------------------------------------------------------------------------
# keyframe-sharded ScanContext loop search
# ---------------------------------------------------------------------------
def _detect_local(descs, keys, count, qdesc, qkey, mesh: GraphMesh, *, num_candidates,
                  exclude_recent, dist_thresh) -> sc.SCDetection:
    """Per-rank detectLoopClosureID over this rank's database block, then
    the cross-rank winner: ties go to the lowest global index, as
    ``argmin`` over the gathered rows (rank order = index order) does."""
    Cl = keys.shape[0]
    gidx = mesh.rank * Cl + torch.arange(Cl, device=keys.device)
    searchable = gidx < (count - exclude_recent)
    best, local_idx, best_shift = sc.rank_candidates(
        descs, keys, searchable, qdesc, qkey, num_candidates
    )
    gbest = gidx[local_idx.reshape(1)][0]
    local = torch.stack([best, gbest.to(torch.float32), best_shift.to(torch.float32)])
    allb = mesh.all_gather(local[None])  # [n, 3]
    w = sc._first_argmin(allb[:, 0]).reshape(1)
    dist, index, shift = allb[w][0]
    found = dist < dist_thresh
    index = torch.where(found, index.to(torch.int64), -1)
    yaw = shift * math.radians(sc.SECTOR_ANGLE)
    return sc.SCDetection(index=index, distance=dist, yaw=yaw)


def detect_loop_sharded(
    descriptors: torch.Tensor,  # [C, 20, 60]
    ring_keys: torch.Tensor,  # [C, 20]
    count,  # [] int number of valid entries (tensor or python int)
    query_desc: torch.Tensor,
    query_key: torch.Tensor,
    mesh: GraphMesh,
    num_candidates: int = sc.NUM_CANDIDATES,
    exclude_recent: int = sc.NUM_EXCLUDE_RECENT,
    dist_thresh: float = sc.SC_DIST_THRES,
) -> sc.SCDetection:
    """detect_loop with the descriptor database split over keyframes.

    Every rank passes the whole database; its length must divide the world
    size (the keyframe rings have power-of-two capacity, so any power-of-two
    world divides them)."""
    span = mesh.block(ring_keys.shape[0])
    return _detect_local(
        descriptors[span], ring_keys[span], count, query_desc, query_key, mesh,
        num_candidates=num_candidates, exclude_recent=exclude_recent,
        dist_thresh=dist_thresh,
    )
