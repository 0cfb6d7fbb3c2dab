"""Batched rigid ICP for loop-closure verification.

Replacement for the PCL ``IterativeClosestPoint`` used to verify loop
candidates (``liorf/src/mapOptmization.cpp:571-585,663-677``):
point-to-point correspondences (exact 1-NN, CUDA kernel K2), closed-form SVD
(Kabsch) alignment per iteration, fitness = mean squared correspondence
distance (PCL ``getFitnessScore`` semantics).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3
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
    """Align source onto target; returns the source->target pose."""
    dev = source_xyz.device
    max_d2 = params.max_corr_dist * params.max_corr_dist
    target_xyz = target_xyz.contiguous()

    def correspondences(pose):
        R = se3.euler_to_rot(pose[:3])
        moved = source_xyz @ R.T + pose[3:]
        d2, idx = _nn1(target_xyz, target_mask, moved, source_mask)
        d2, idx = d2[:, 0], idx[:, 0]
        ok = source_mask & torch.isfinite(d2) & (d2 < max_d2)
        return moved, target_xyz[idx], ok, d2

    pose = init_pose.to(torch.float32)
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    it = 0
    # Python loop in place of lax.while_loop (icp.py:106 of the JAX package):
    # one bool is read from the device per iteration.
    while it < params.max_iters:
        moved, matched, ok, _ = correspondences(pose)
        w = ok.to(source_xyz.dtype)
        wsum = torch.clamp(torch.sum(w), min=1.0)
        mu_s = (w @ moved) / wsum
        mu_t = (w @ matched) / wsum
        S = ((matched - mu_t) * w[:, None]).T @ (moved - mu_s)
        U, _, Vt = torch.linalg.svd(S)
        det = torch.linalg.det(U @ Vt)
        D = eye3.clone()
        D[2, 2] = det
        R_d = U @ D @ Vt
        t_d = mu_t - R_d @ mu_s
        # compose: new_pose = delta o pose
        R0 = se3.euler_to_rot(pose[:3])
        R_new, t_new = se3.se3_compose(R_d, t_d, R0, pose[3:])
        new_pose = torch.cat([se3.rot_to_euler(R_new), t_new])
        delta = torch.sum((new_pose - pose) ** 2)
        pose = new_pose
        it += 1
        if bool(delta < params.epsilon):
            break

    _, _, ok, d2 = correspondences(pose)
    n_ok = torch.clamp(torch.sum(ok.to(torch.float32)), min=1.0)
    fitness = torch.sum(torch.where(ok, d2, 0.0)) / n_ok
    any_ok = torch.sum(ok.to(torch.int32)) > 0
    n_src = torch.clamp(torch.sum(source_mask.to(torch.float32)), min=1.0)
    inlier_frac = (
        torch.sum((ok & (d2 < params.inlier_dist**2)).to(torch.float32)) / n_src
    )
    # PCL `hasConverged()` semantics (the gate the reference actually uses,
    # mapOptmization.cpp:581): true when the solver terminated by ANY
    # criterion — transformation epsilon OR the iteration cap — with valid
    # correspondences; quality is judged by the separate fitness gate.
    return ICPResult(
        pose=pose, fitness=fitness, converged=any_ok,
        iters=torch.tensor(it, dtype=torch.int32, device=dev),
        inlier_frac=inlier_frac,
    )
