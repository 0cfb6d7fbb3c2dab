"""Scan-to-map point-to-plane Gauss-Newton registration.

Re-design of the reference's scan matcher
(``liorf/src/mapOptmization.cpp:1074-1320``): per GN iteration, every scan
point finds its 5 nearest local-map points (spatial grid instead of a
kd-tree; the top-k is CUDA kernel K1), a plane is fit through them, and the
weighted point-to-plane residuals drive a 6-DoF euler-parameterized
Gauss-Newton step with the LOAM-style eigenvalue degeneracy projection
(``mapOptmization.cpp:1242-1271``). Every iteration is fully batched on the
device; the loop itself runs on the host and reads one ``done`` flag per
iteration.

Semantics kept from the reference:
  * pose = [roll, pitch, yaw, x, y, z], R = Rz Ry Rx;
  * 5th-NN gate at 1 m (``:1097``), plane residual gate 0.2 m (``:1114``);
  * weight s = 1 - 0.9 |d| / |p_sensor|^(1/4), kept if s > 0.1 (``:1125-1139``);
  * degeneracy: eig(J^T J) < 100 -> project the update off those directions;
  * convergence at |drot| < 0.05 deg and |dtrans| < 0.05 cm (``:1280-1292``);
  * requires >= 50 matched points to optimize (``:1182``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3
from .knn import SpatialHashGrid, knn_grid
from .plane_fit import fit_planes


class ScanMatchParams(NamedTuple):
    max_iters: int = 30
    eigen_thresh: float = 100.0
    corr_dist: float = 1.0  # max 5th-NN distance [m]
    plane_max_resid: float = 0.2
    min_weight: float = 0.1
    min_points: int = 50
    conv_rot_deg: float = 0.05
    conv_trans_cm: float = 0.05
    # per-cell k-NN candidate budget. The default is exact for every
    # (cell >= 1 m, leaf >= 0.3 m) configuration — knn.exact_bucket(1.0,
    # 0.3) == 40; pipelines derive the tight value from their config
    # (slam.py) and knn.cell_overflow_count verifies exactness at runtime.
    knn_bucket: int = 40


class ScanMatchResult(NamedTuple):
    pose: torch.Tensor  # [6] rpyxyz
    degenerate: torch.Tensor  # [] bool
    converged: torch.Tensor  # [] bool
    iters: torch.Tensor  # [] int32
    num_matched: torch.Tensor  # [] int32 (matched points at the last iteration)


def _rot_derivatives(rpy: torch.Tensor) -> torch.Tensor:
    """[3] euler -> [3, 3, 3]: dR/d(roll), dR/d(pitch), dR/d(yaw)."""
    r, p, y = rpy[0], rpy[1], rpy[2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    z = torch.zeros_like(r)
    o = torch.ones_like(r)

    def mat(rows):
        return torch.stack([torch.stack(row) for row in rows])

    Rx = mat([[o, z, z], [z, cr, -sr], [z, sr, cr]])
    Ry = mat([[cp, z, sp], [z, o, z], [-sp, z, cp]])
    Rz = mat([[cy, -sy, z], [sy, cy, z], [z, z, o]])
    dRx = mat([[z, z, z], [z, -sr, -cr], [z, cr, -sr]])
    dRy = mat([[-sp, z, cp], [z, z, z], [-cp, z, -sp]])
    dRz = mat([[-sy, -cy, z], [cy, -sy, z], [z, z, z]])
    d_roll = Rz @ Ry @ dRx
    d_pitch = Rz @ dRy @ Rx
    d_yaw = dRz @ Ry @ Rx
    return torch.stack([d_roll, d_pitch, d_yaw])


def scan_to_map(
    scan_xyz: torch.Tensor,
    scan_mask: torch.Tensor,
    grid: SpatialHashGrid,
    init_pose: torch.Tensor,
    params: ScanMatchParams = ScanMatchParams(),
    mesh=None,
) -> ScanMatchResult:
    """Register a scan against the local map grid starting from init_pose.

    scan_xyz: [N, 3] deskewed points in the *sensor* frame; init_pose [6]
    rpyxyz mapping sensor -> map frame. Runs on the device the inputs are on,
    as the one-lane case of :func:`scan_to_map_lanes`. With a ``mesh``
    (``dist.sharded.GraphMesh``) every rank passes the whole scan and
    registers its contiguous block of the points (padded with masked points
    to a multiple of the ranks); the result is the same on every rank.
    """
    if mesh is not None:
        scan_xyz, scan_mask = mesh.local_rows(scan_xyz), mesh.local_rows(scan_mask)
    res = scan_to_map_lanes(
        scan_xyz[None], scan_mask[None], SpatialHashGrid(*(f[None] for f in grid)),
        init_pose[None], params, mesh=mesh,
    )
    return ScanMatchResult(*(f[0] for f in res))


def _build_system_lanes(pose, scan_xyz, scan_mask, scan_norm_quarter, grid, params,
                        mesh=None):
    """One linearization of B sessions at once (correspondences + plane fits
    + (H, g, count)): pose [B, 6], scan [B, N, 3] + mask, a stacked grid
    ([B, ...] fields). One K1 launch for every lane; the plane fits run over
    the flattened [B*N] neighbourhoods. Returns H [B, 6, 6], g [B, 6],
    count [B].

    With a ``mesh`` the scan is this rank's block of points and (H, g,
    count) are summed over the ranks in one all-reduce of 36 + 6 + 1 values
    a lane (the JAX package's ``psum``, scan_match.py:117-120 there); the
    count travels as float32, exact below 2^24 points."""
    B, N = scan_mask.shape
    R = se3.euler_to_rot(pose[:, :3])  # [B, 3, 3]
    t = pose[:, 3:]
    world = scan_xyz @ R.transpose(-1, -2) + t[:, None, :]

    d2, idx = knn_grid(grid, world, scan_mask, k=5, bucket=params.knn_bucket)
    gate = d2[..., 4] < params.corr_dist * params.corr_dist
    nbr_mask = torch.isfinite(d2) & gate[..., None]
    lanes = torch.arange(B, device=idx.device)[:, None, None]
    neighbors = grid.xyz[lanes, idx]  # [B, N, 5, 3]

    fit = fit_planes(
        neighbors.reshape(B * N, 5, 3), nbr_mask.reshape(B * N, 5), params.plane_max_resid
    )
    normal, d, valid = fit.normal.reshape(B, N, 3), fit.d.reshape(B, N), fit.valid.reshape(B, N)
    pd2 = torch.einsum("bni,bni->bn", normal, world) + d
    s = 1.0 - 0.9 * torch.abs(pd2) / scan_norm_quarter
    sel = scan_mask & gate & valid & (s > params.min_weight)
    w = torch.where(sel, s, 0.0)

    dR = torch.func.vmap(_rot_derivatives)(pose[:, :3])  # [B, 3, 3, 3]
    rotated = torch.einsum("bkij,bnj->bnki", dR, scan_xyz)
    J_rot = torch.einsum("bnki,bni->bnk", rotated, normal)
    J = torch.cat([J_rot, normal], dim=-1) * w[..., None]  # [B, N, 6]
    b_ = -(w * pd2)

    Jt = J.transpose(-1, -2)
    H = Jt @ J
    g = (Jt @ b_[..., None])[..., 0]
    count = torch.sum(sel.to(torch.int32), dim=-1)
    if mesh is not None:
        red = mesh.all_reduce(torch.cat([H.reshape(B, 36), g, count[:, None].to(H.dtype)], 1))
        H, g, count = red[:, :36].reshape(B, 6, 6), red[:, 36:42], red[:, 42].to(torch.int32)
    return H, g, count


def scan_to_map_lanes(
    scan_xyz: torch.Tensor,
    scan_mask: torch.Tensor,
    grid: SpatialHashGrid,
    init_pose: torch.Tensor,
    params: ScanMatchParams = ScanMatchParams(),
    mesh=None,
) -> ScanMatchResult:
    """:func:`scan_to_map` for B sessions stacked on a leading axis (scan
    [B, N, 3] + mask [B, N], a stacked grid, init_pose [B, 6]); every field
    of the result gets the [B] axis. The single-session matcher is its
    B = 1 case.

    One batched Gauss-Newton loop: each iteration linearizes every lane
    (one K1 launch for all of them) and solves the B 6x6 systems together;
    a lane whose own loop would have stopped (converged or too few
    matches) is frozen — its pose, match count and iteration count stay as
    its single-session loop left them, as a vmapped ``lax.while_loop``
    does. The host reads one "all done" flag per iteration (in place of
    the JAX package's ``lax.while_loop``, scan_match.py:205 there).

    With a ``mesh`` the scans are this rank's blocks of points and the
    normal equations are all-reduced (:func:`_build_system_lanes`): every
    rank then takes the same steps and reads the same flag."""
    B = scan_xyz.shape[0]
    dev = scan_xyz.device
    scan_norm_quarter = torch.sqrt(
        torch.sqrt(torch.linalg.norm(scan_xyz, dim=-1) + 1e-12)
    )
    pose = init_pose.to(torch.float32)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    P = eye6.expand(B, 6, 6)
    degenerate = torch.zeros((B,), dtype=torch.bool, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    count = torch.zeros((B,), dtype=torch.int32, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    it = 0
    while it < params.max_iters:
        H, g, cnt = _build_system_lanes(
            pose, scan_xyz, scan_mask, scan_norm_quarter, grid, params, mesh
        )
        live = ~done
        enough = cnt >= params.min_points
        # Degeneracy analysis on the first iteration only (reference :1242);
        # every lane is on its first iteration together.
        if it == 0:
            lam, V = torch.linalg.eigh(H)
            good = lam >= params.eigen_thresh
            P = (V * good[:, None, :].to(H.dtype)) @ V.transpose(-1, -2)
            degenerate = ~torch.all(good, dim=-1)

        x = torch.linalg.solve(H + eye6 * 1e-6, g)
        x = torch.where(degenerate[:, None], (P @ x[..., None])[..., 0], x)
        x = torch.where(enough[:, None], x, torch.zeros_like(x))

        pose = torch.where(live[:, None], pose + x, pose)
        count = torch.where(live, cnt, count)
        iters = iters + live.to(torch.int32)
        delta_rot = torch.rad2deg(torch.linalg.norm(x[:, :3], dim=-1))
        delta_trans = torch.linalg.norm(x[:, 3:], dim=-1) * 100.0
        converged = (delta_rot < params.conv_rot_deg) & (
            delta_trans < params.conv_trans_cm
        )
        done = done | (converged | ~enough)
        it += 1
        if bool(torch.all(done)):
            break

    # The match count is the last linearization's (pre-final-update), as in
    # the reference's diagnostics.
    return ScanMatchResult(
        pose=pose,
        degenerate=degenerate,
        converged=done & (count >= params.min_points),
        iters=iters,
        num_matched=count,
    )
