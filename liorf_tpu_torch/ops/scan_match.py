"""Scan-to-map point-to-plane Gauss-Newton registration.

Re-design of the reference's scan matcher
(``liorf/src/mapOptmization.cpp:1074-1320``): per GN iteration, every scan
point finds its 5 nearest local-map points (spatial grid instead of a
kd-tree; the top-k is CUDA kernel K1), a plane is fit through them, and the
weighted point-to-plane residuals drive a 6-DoF euler-parameterized
Gauss-Newton step with the LOAM-style eigenvalue degeneracy projection
(``mapOptmization.cpp:1242-1271``). Every iteration is fully batched on the
device (``ops/scan_gn.py``: two hand-written kernels an iteration beside K1);
the loop itself runs on the host and reads one ``done`` flag per iteration.

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

from . import scan_gn
from .knn import SpatialHashGrid, knn_grid


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
                        mesh=None, world=None):
    """One linearization of B sessions at once (correspondences + plane fits
    + (H, g, count)): pose [B, 6], scan [B, N, 3] + mask, a stacked grid
    ([B, ...] fields). One K1 launch for every lane, then one call of
    ``scan_gn.scan_linearize``. ``world`` is the scan moved by ``pose``
    (``scan_gn.transform``, as ``scan_gn.scan_update`` writes it), moved here
    when not given. Returns H [B, 6, 6], g [B, 6], count [B].

    With a ``mesh`` the scan is this rank's block of points and (H, g,
    count) are summed over the ranks in one all-reduce of 36 + 6 + 1 values
    a lane (the JAX package's ``psum``, scan_match.py:117-120 there); the
    count travels as float32, exact below 2^24 points."""
    B = scan_mask.shape[0]
    if world is None:
        world = scan_gn.transform(pose, scan_xyz)
    d2, idx = knn_grid(grid, world, scan_mask, k=5, bucket=params.knn_bucket)
    H, g, count = scan_gn.scan_linearize(pose, scan_xyz, scan_mask, scan_norm_quarter, d2, idx,
                                         grid.xyz, params)
    if mesh is not None:
        red = mesh.all_reduce(torch.cat([H.reshape(B, 36), g, count[:, None].to(H.dtype)], 1))
        H, g = red[:, :36].reshape(B, 6, 6).contiguous(), red[:, 36:42].contiguous()
        count = red[:, 42].to(torch.int32)
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

    One batched Gauss-Newton loop: the scan moved once
    (``scan_gn.transform``), then each iteration is one K1 launch for every
    lane, one ``scan_gn.scan_linearize`` and one ``scan_gn.scan_update``
    call (the two kernels of ``csrc/scan_gn.cu`` on the card: no library
    solver); a lane whose own loop would have stopped (converged or too few
    matches) is frozen — its pose, match count and iteration count stay as
    its single-session loop left them, as a vmapped ``lax.while_loop``
    does. The host reads one "all done" flag per iteration (in place of
    the JAX package's ``lax.while_loop``, scan_match.py:205 there).

    With a ``mesh`` the scans are this rank's blocks of points and the
    normal equations are all-reduced (:func:`_build_system_lanes`): every
    rank then takes the same steps and reads the same flag."""
    scan_xyz, scan_mask = scan_xyz.contiguous(), scan_mask.contiguous()
    scan_norm_quarter = torch.sqrt(
        torch.sqrt(torch.linalg.norm(scan_xyz, dim=-1) + 1e-12)
    )
    scan_to_map_lanes.calls += 1
    state = scan_gn.init_state(init_pose)
    world = scan_gn.transform(state.pose, scan_xyz)
    for it in range(params.max_iters):
        H, g, cnt = _build_system_lanes(
            state.pose, scan_xyz, scan_mask, scan_norm_quarter, grid, params, mesh, world
        )
        state, world, all_done = scan_gn.scan_update(state, H, g, cnt, scan_xyz, params,
                                                     first=it == 0)
        if bool(all_done):
            break

    # The match count is the last linearization's (pre-final-update), as in
    # the reference's diagnostics.
    return ScanMatchResult(
        pose=state.pose,
        degenerate=state.degenerate,
        converged=state.done & (state.count >= params.min_points),
        iters=state.iters,
        num_matched=state.count,
    )


# calls: each moves its scan once before its loop (scan_gn.transform)
scan_to_map_lanes.calls = 0
