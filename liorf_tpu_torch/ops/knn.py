"""Batched k-nearest-neighbor search without trees.

Replacement for PCL's ``KdTreeFLANN`` 5-NN queries in the scan-matcher hot
loop (``liorf/src/mapOptmization.cpp:1087``) and radius searches over
keyframe positions (``:983-984, 745-746``).

* ``SpatialHashGrid`` — the production path. The map is sorted once per
  frame by an *exact* packed cell key on a recentered, clipped grid
  (no hash collisions); each query gathers its 3x3x3 neighbor cells'
  points (fixed per-cell budget) and reduces a masked top-k. O(N * 27B)
  instead of O(N * M). On the card the whole query, cell runs included, is
  one launch of kernel K1 (``knn_cuda.knn_grid_topk``).

* ``knn_bruteforce`` — exact search over all targets, kernel K2
  (``knn_cuda.knn_bruteforce``), re-exported here under the JAX package's name.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

# the exact cell packing lives beside kernel K1, which recomputes it
from .knn_cuda import _cell_coords, _neighbor_runs, _pack_cells, knn_grid_topk
from .knn_cuda import knn_bruteforce, topk_candidates  # noqa: F401


class SpatialHashGrid(NamedTuple):
    xyz: torch.Tensor  # [M, 3] map points sorted by cell key
    keys: torch.Tensor  # [M] int32 packed cell key per sorted point (sentinel for invalid)
    mask: torch.Tensor  # [M] validity of sorted points
    origin: torch.Tensor  # [3] recenter origin
    cell_size: torch.Tensor  # [] float


def build_grid(
    xyz: torch.Tensor, mask: torch.Tensor, origin: torch.Tensor, cell_size: float
) -> SpatialHashGrid:
    """Sort map points by exact packed cell key. One sort per frame."""
    cell, in_range = _cell_coords(xyz, origin, cell_size)
    keys = _pack_cells(cell, in_range & mask)
    order = torch.argsort(keys, stable=True)  # jnp.argsort is stable (knn.py:68)
    return SpatialHashGrid(
        xyz=xyz[order].contiguous(),
        keys=keys[order].contiguous(),
        mask=(mask & in_range)[order],
        origin=origin,
        # filled on the device: a host value uploaded would make the host wait
        cell_size=torch.full((), cell_size, dtype=xyz.dtype, device=xyz.device),
    )


def exact_bucket(cell_size: float, leaf: float, margin: float = 1.6) -> int:
    """Per-cell candidate budget that cannot truncate a voxel-downsampled
    locally-planar surface.

    After voxel downsampling at ``leaf`` there is at most one point per
    voxel; a plane crossing a grid cell of ``cell_size`` intersects at most
    ``span^2`` voxels where ``span = ceil(cell/leaf) + 1`` (the +1 covers
    voxel-grid misalignment with the cell grid). ``margin`` budgets cells
    holding more than one surface (edges/corners where planes meet).
    Rounded up to a multiple of 8.

    At the bench operating point (cell 1.0 m, leaf 0.3 m) this yields 40.
    """
    span = math.ceil(cell_size / max(leaf, 1e-6)) + 1
    return max(8, math.ceil(span * span * margin / 8) * 8)


def cell_overflow_count(
    grid: SpatialHashGrid,
    queries: torch.Tensor,
    query_mask: torch.Tensor,
    bucket: int,
) -> torch.Tensor:
    """Number of (query, neighbor-cell) runs longer than ``bucket`` — i.e.
    how many candidate gathers :func:`knn_grid` would truncate. 0 means the
    search was provably exact for every query this frame."""
    starts, ends = _neighbor_runs(grid, queries, query_mask)
    return torch.sum(((ends - starts) > bucket) & query_mask[:, None])


def knn_grid(
    grid: SpatialHashGrid,
    queries: torch.Tensor,
    query_mask: torch.Tensor,
    k: int = 5,
    bucket: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k-NN of queries [N, 3] against the grid.

    Returns (dists2 [N, k], idx [N, k] int32) — indices into the grid's
    *sorted* point array; missing neighbors have dist2 = +inf and idx = 0.

    Each query inspects its 27 neighbor cells; per cell up to `bucket`
    sorted points are gathered. Cells holding more than `bucket` points are
    truncated — size the budget with :func:`exact_bucket` and check with
    :func:`cell_overflow_count`.
    """
    # one launch of kernel K1 on the card, its plain version on the CPU
    return knn_grid_topk(grid, queries.contiguous(), query_mask.contiguous(), k=k, bucket=bucket)


def radius_mask(
    points: torch.Tensor, mask: torch.Tensor, center: torch.Tensor, radius: float
) -> torch.Tensor:
    """Boolean mask of points within radius of center (replaces kd-tree
    radiusSearch over keyframe positions, mapOptmization.cpp:983-984)."""
    d2 = torch.sum((points - center) ** 2, dim=-1)
    return mask & (d2 <= radius * radius)
