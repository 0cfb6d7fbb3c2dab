"""Batched rigid ICP for loop-closure verification.

Replacement for the PCL ``IterativeClosestPoint`` used to verify loop
candidates (``liorf/src/mapOptmization.cpp:571-585,663-677``):
point-to-point correspondences (exact 1-NN, CUDA kernel K2), closed-form
alignment per iteration (Horn's quaternion: Kabsch's minimizer without an
SVD; ``ops/icp_align.py``, one hand-written kernel on the card), fitness =
mean squared correspondence distance (PCL ``getFitnessScore`` semantics).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import icp_align, scan_gn
from .knn import knn_bruteforce


def _nn1(target_xyz, target_mask, moved, source_mask):
    """1-NN through ``knn_bruteforce``: kernel K2 for CUDA tensors, its plain
    version for CPU tensors (the dispatch is the wrapper's, by device)."""
    return knn_bruteforce(target_xyz, target_mask, moved.contiguous(), source_mask, k=1)


class ICPParams(NamedTuple):
    max_iters: int = 30
    max_corr_dist: float = 30.0  # historyKeyframeSearchRadius * 2
    epsilon: float = 1e-6  # transform convergence (same role as PCL's)
    inlier_dist: float = 1.0  # [m] radius for the alignment-quality fraction


class ICPResult(NamedTuple):
    pose: torch.Tensor  # [6] rpyxyz source -> target
    fitness: torch.Tensor  # [] mean squared corr distance
    converged: torch.Tensor  # [] bool
    iters: torch.Tensor
    # fraction of valid source points whose final NN lies within
    # inlier_dist — an alignment-quality signal fitness alone lacks:
    # fitness (an outlier-diluted mean) stays low when 95% of a WRONG
    # match aligns, while the inlier fraction exposes the mismatched tail
    inlier_frac: torch.Tensor  # [] float


def icp_point2point(
    source_xyz: torch.Tensor,
    source_mask: torch.Tensor,
    target_xyz: torch.Tensor,
    target_mask: torch.Tensor,
    init_pose: torch.Tensor,
    params: ICPParams = ICPParams(),
) -> ICPResult:
    """Align source onto target; returns the source->target pose. The
    one-lane case of :func:`icp_point2point_lanes`."""
    res = icp_point2point_lanes(
        source_xyz[None], source_mask[None], target_xyz[None], target_mask[None],
        init_pose[None], params,
    )
    return ICPResult(*(f[0] for f in res))


def icp_point2point_lanes(
    source_xyz: torch.Tensor,
    source_mask: torch.Tensor,
    target_xyz: torch.Tensor,
    target_mask: torch.Tensor,
    init_pose: torch.Tensor,
    params: ICPParams = ICPParams(),
) -> ICPResult:
    """:func:`icp_point2point` for B sessions stacked on a leading axis
    (source [B, N, 3] + mask, target [B, M, 3] + mask, init_pose [B, 6]);
    every field of the result gets the [B] axis.

    One batched loop (in place of the JAX package's ``lax.while_loop``,
    icp.py:106 there): each iteration is one K2 launch for every lane and one
    ``icp_align.icp_align`` call (the alignment of every lane, and the source
    moved for the next K2); a lane whose own loop would have stopped
    (transform change below epsilon) keeps its pose, as a vmapped
    ``lax.while_loop`` does. The host reads one "all done" flag per
    iteration."""
    icp_point2point_lanes.runs += 1
    max_d2 = params.max_corr_dist * params.max_corr_dist
    target_xyz, source_xyz = target_xyz.contiguous(), source_xyz.contiguous()
    source_mask = source_mask.contiguous()
    state = icp_align.init_state(init_pose)
    moved = scan_gn.transform(state.pose, source_xyz)
    for _ in range(params.max_iters):
        d2, idx = _nn1(target_xyz, target_mask, moved, source_mask)
        state, moved, all_done = icp_align.icp_align(
            state, moved, d2, idx, target_xyz, source_mask, source_xyz, max_d2, params.epsilon)
        if bool(all_done):
            break

    d2 = _nn1(target_xyz, target_mask, moved, source_mask)[0][..., 0]
    ok = source_mask & torch.isfinite(d2) & (d2 < max_d2)
    n_ok = torch.clamp(torch.sum(ok.to(torch.float32), dim=-1), min=1.0)
    fitness = torch.sum(torch.where(ok, d2, 0.0), dim=-1) / n_ok
    any_ok = torch.sum(ok.to(torch.int32), dim=-1) > 0
    n_src = torch.clamp(torch.sum(source_mask.to(torch.float32), dim=-1), min=1.0)
    inlier_frac = (
        torch.sum((ok & (d2 < params.inlier_dist**2)).to(torch.float32), dim=-1) / n_src
    )
    # PCL `hasConverged()` semantics (the gate the reference actually uses,
    # mapOptmization.cpp:581): true when the solver terminated by ANY
    # criterion — transformation epsilon OR the iteration cap — with valid
    # correspondences; quality is judged by the separate fitness gate.
    return ICPResult(pose=state.pose, fitness=fitness, converged=any_ok, iters=state.iters,
                     inlier_frac=inlier_frac)


# calls: each moves its source once before its loop and makes one
# correspondence pass after it
icp_point2point_lanes.runs = 0
