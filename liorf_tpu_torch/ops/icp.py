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
    icp.py:106 there): each iteration is one K2 launch for every lane and B
    Kabsch solves together; a lane whose own loop would have stopped
    (transform change below epsilon) keeps its pose, as a vmapped
    ``lax.while_loop`` does. The host reads one "all done" flag per
    iteration."""
    B = source_xyz.shape[0]
    dev = source_xyz.device
    max_d2 = params.max_corr_dist * params.max_corr_dist
    target_xyz = target_xyz.contiguous()
    lanes = torch.arange(B, device=dev)[:, None]

    def correspondences(pose):
        R = se3.euler_to_rot(pose[:, :3])
        moved = source_xyz @ R.transpose(-1, -2) + pose[:, None, 3:]
        d2, idx = _nn1(target_xyz, target_mask, moved, source_mask)
        d2, idx = d2[..., 0], idx[..., 0]
        ok = source_mask & torch.isfinite(d2) & (d2 < max_d2)
        return moved, target_xyz[lanes, idx], ok, d2

    pose = init_pose.to(torch.float32)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    it = 0
    while it < params.max_iters:
        moved, matched, ok, _ = correspondences(pose)
        w = ok.to(source_xyz.dtype)
        wsum = torch.clamp(torch.sum(w, dim=-1), min=1.0)[:, None]
        mu_s = (w[:, None, :] @ moved)[:, 0] / wsum
        mu_t = (w[:, None, :] @ matched)[:, 0] / wsum
        S = ((matched - mu_t[:, None]) * w[..., None]).transpose(-1, -2) @ (moved - mu_s[:, None])
        U, _, Vt = torch.linalg.svd(S)
        det = torch.linalg.det(U @ Vt)
        one = torch.ones_like(det)
        D = torch.diag_embed(torch.stack([one, one, det], dim=-1))
        R_d = U @ D @ Vt
        t_d = mu_t - (R_d @ mu_s[..., None])[..., 0]
        R0 = se3.euler_to_rot(pose[:, :3])
        R_new, t_new = se3.se3_compose(R_d, t_d, R0, pose[:, 3:])
        new_pose = torch.cat([se3.rot_to_euler(R_new), t_new], dim=-1)
        delta = torch.sum((new_pose - pose) ** 2, dim=-1)
        live = ~done
        pose = torch.where(live[:, None], new_pose, pose)
        iters = iters + live.to(torch.int32)
        done = done | (delta < params.epsilon)
        it += 1
        if bool(torch.all(done)):
            break

    _, _, ok, d2 = correspondences(pose)
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
    return ICPResult(pose=pose, fitness=fitness, converged=any_ok, iters=iters,
                     inlier_frac=inlier_frac)
