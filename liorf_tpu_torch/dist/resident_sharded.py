"""Multi-rank resident pipeline: the whole per-frame SLAM step on every rank,
with the registration's scan points split over the ranks.

``ShardedResidentPipeline`` has the API and semantics of
``ResidentPipeline``. Each rank holds the whole state (keyframe rings,
factor rings, local-map grid, filter) and runs the whole frame; only the
scan-to-map registration is split: each rank searches correspondences and
fits planes for its contiguous block of the downsampled scan (one K1 launch
per GN iteration), and the 6x6 normal equations are all-reduced, so every
rank takes the same step — the OpenMP-over-points loop of the reference
(mapOptmization.cpp:1078) spread over processes.

Placement is explicit here, where in the JAX package GSPMD chose it:
deskew, the voxel filter, IMU fusion, the keyframe graph and its solve, the
local-map rebuild and the loop closure (ScanContext + ICP, K2) stay
replicated — they are per-scan or per-keyframe work that a split would
only surround with collectives. The keyframe-sharded solvers
(``dist/sharded.py``, ``dist/shard_map_solver.py``) are the scaling path
for large graphs and run on their own.

Every rank must take the same branches (keyframe, loop gate, full solve):
the host reads them from replicated values, and a rank that decided
otherwise would wait in a collective the others never enter. The
replicated parts repeat bit for bit on every rank: their scatter-adds are
fixed-order segment sums on the card (``ops/segment_sum.py``), not atomics.
"""

from __future__ import annotations

import numpy as np

from ..pipeline.config import SlamConfig
from ..pipeline.resident import ResidentPipeline, resident_step_packed
from .sharded import GraphMesh


class ShardedResidentPipeline(ResidentPipeline):
    """Same API and semantics as ResidentPipeline; the registration's scan
    points split over ``mesh`` (``dist.sharded.make_mesh``), the state on
    the mesh's device."""

    def __init__(self, cfg: SlamConfig, mesh: GraphMesh):
        super().__init__(cfg, device=mesh.device)
        self.mesh = mesh

    def _dispatch_step(self, buf: np.ndarray, S: int, W: int):
        self.state, self._host, gn_iters = resident_step_packed(
            self.state, self._host, buf, self.params, S, W, self.tally, mesh=self.mesh
        )
        self._gn_iters += gn_iters
