"""The per-frame device step.

One call covers the entire per-scan hot path — deskew, scan voxel
downsample, IMU preintegration, initial-guess prediction, scan-to-map GN
registration, fixed-lag fusion (with device-side divergence reinit),
keyframe gating, and the ScanContext descriptor. Everything stays on the
device; the host reads one small packed summary per frame and one packed
payload per keyframe (plus the scan matcher's per-iteration ``done`` flag).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import se3
from ..core.voxel import voxel_downsample_xyz
from ..imu import fusion as imu_fusion
from ..imu import preintegration as preint
from ..ops import scancontext
from ..ops.deskew import deskew_frame
from ..ops.knn import SpatialHashGrid
from ..ops.scan_match import ScanMatchParams, scan_to_map, scan_to_map_lanes


class FrameParams(NamedTuple):
    leaf: float
    scan_cap: int
    match: ScanMatchParams
    fusion: imu_fusion.FusionParams
    z_tol: float
    rot_tol: float
    kf_dist: float
    kf_angle: float
    imu_rpy_weight: float = 0.0  # 9-axis roll/pitch slerp (imuRPYWeight)
    # gyro-interpolated motion compensation (imageProjection deskewPoint,
    # imageProjection.cpp:536-565). False skips the deskew — exists so the
    # deskew-stressor tests can prove deskew-on beats deskew-off
    deskew: bool = True


class FrameOutputs(NamedTuple):
    pose: torch.Tensor  # [6]
    degenerate: torch.Tensor
    converged: torch.Tensor
    num_matched: torch.Tensor
    is_kf: torch.Tensor
    filter: imu_fusion.FusionFilter
    diverged: torch.Tensor
    ds_xyz: torch.Tensor
    ds_mask: torch.Tensor
    sc_desc: torch.Tensor
    sc_key: torch.Tensor
    deskewed: torch.Tensor
    # Packed buffers so the host needs exactly ONE small read per frame
    # (summary) plus ONE per keyframe (kf_payload).
    summary: torch.Tensor  # [12] f32: pose(6), degenerate, converged, is_kf, num_matched, diverged, gn_iters
    kf_payload: torch.Tensor  # [scan_cap*4 + 20*60 + 20] f32: ds_xyz, ds_mask, sc_desc, sc_key
    gn_iters: torch.Tensor  # [] int32 GN iterations the scan matcher ran


def _pack_summary(pose, degenerate, converged, is_kf, num_matched, diverged, gn_iters):
    # the last slot (padding in the JAX package) carries the GN iteration count
    f32 = torch.float32
    return torch.cat(
        [
            pose.to(f32),
            torch.stack(
                [
                    degenerate.to(f32),
                    converged.to(f32),
                    is_kf.to(f32),
                    num_matched.to(f32),
                    diverged.to(f32),
                    gn_iters.to(f32),
                ]
            ),
        ]
    )


def _pack_kf_payload(ds_xyz, ds_mask, desc, key):
    f32 = torch.float32
    return torch.cat(
        [ds_xyz.to(f32).reshape(-1), ds_mask.to(f32), desc.to(f32).reshape(-1), key.to(f32)]
    )


def _to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def unpack_summary(s):
    """Host-side: one [12] f32 vector -> python scalars."""
    s = _to_numpy(s)
    return dict(
        pose=s[:6].astype(np.float32),
        degenerate=bool(s[6]),
        converged=bool(s[7]),
        is_kf=bool(s[8]),
        num_matched=int(s[9]),
        diverged=bool(s[10]),
        gn_iters=int(s[11]),
    )


def unpack_kf_payload(p, scan_cap: int):
    """Host-side: one flat f32 buffer -> (ds_xyz, ds_mask, desc, key)."""
    p = _to_numpy(p)
    o = 0
    ds_xyz = p[o : o + scan_cap * 3].reshape(scan_cap, 3)
    o += scan_cap * 3
    ds_mask = p[o : o + scan_cap] > 0.5
    o += scan_cap
    desc = p[o : o + 20 * 60].reshape(20, 60)
    o += 20 * 60
    key = p[o : o + 20]
    return ds_xyz, ds_mask, desc, key


class FrameCore(NamedTuple):
    """Shared per-frame computation results (see frame_core)."""

    pose: torch.Tensor  # [6] post-slerp/clamp registered pose
    degenerate: torch.Tensor
    converged: torch.Tensor
    num_matched: torch.Tensor
    is_kf: torch.Tensor
    filter: imu_fusion.FusionFilter  # post-correction (divergence-reinit'd)
    diverged: torch.Tensor
    deskewed: torch.Tensor  # [cap, 3]
    ds_xyz: torch.Tensor
    ds_mask: torch.Tensor
    gn_iters: torch.Tensor


def _select_filter(flag, a: imu_fusion.FusionFilter, b: imu_fusion.FusionFilter):
    """where(flag, a, b) over every leaf of the filter — the tree_map of
    frame_step.py:206-208 of the JAX package, written out."""
    mean = imu_fusion.FusionState(
        *(torch.where(flag, x, y) for x, y in zip(a.mean, b.mean))
    )
    return imu_fusion.FusionFilter(
        mean=mean, sqrt_info=torch.where(flag, a.sqrt_info, b.sqrt_info)
    )


def _frame_front(
    xyz, rel_t, mask, scan_start, dk_times, dk_gyr, dk_mask,
    fu_acc, fu_gyr, fu_dts, fu_mask, filt: imu_fusion.FusionFilter, params: FrameParams,
):
    """frame_core up to the scan matcher: deskew -> voxel downsample ->
    IMU preintegration guess. Reads nothing back (runs under vmap)."""
    # --- front-end: deskew + downsample (imageProjection) ---
    if params.deskew:
        deskewed = deskew_frame(xyz, rel_t, mask, scan_start, dk_times, dk_gyr, dk_mask)
    else:
        deskewed = xyz
    ds_xyz, ds_mask = voxel_downsample_xyz(deskewed, mask, params.leaf, params.scan_cap)

    # --- initial guess: IMU preintegration from the filter state ---
    pre = preint.preintegrate(
        fu_acc, fu_gyr, fu_dts, fu_mask, filt.mean.ba, filt.mean.bg,
        params.fusion.imu,
    )
    nav = preint.predict(
        preint.NavState(R=filt.mean.R, p=filt.mean.p, v=filt.mean.v),
        pre, filt.mean.ba, filt.mean.bg, params.fusion.imu,
    )
    guess = torch.cat([se3.rot_to_euler(nav.R), nav.p])
    return deskewed, ds_xyz, ds_mask, pre, guess


def _frame_back(
    reg_pose, reg_degenerate, pre, filt: imu_fusion.FusionFilter,
    last_kf_pose, params: FrameParams, imu_rpy=None, imu_rpy_ok=None,
):
    """frame_core after the scan matcher: 9-axis slerp + clamps -> fusion
    correction with divergence reinit -> keyframe gate. Reads nothing back
    (runs under vmap). Returns (pose, filter, diverged, is_kf)."""
    pose = reg_pose
    # transformUpdate 9-axis attitude blending (mapOptmization.cpp:1323-1346)
    if imu_rpy is not None and params.imu_rpy_weight > 0:
        w = params.imu_rpy_weight
        z = torch.zeros_like(pose[0])
        roll_s = se3.euler_slerp(
            torch.stack([pose[0], z, z]), torch.stack([imu_rpy[0], z, z]), w
        )[0]
        pitch_s = se3.euler_slerp(
            torch.stack([z, pose[1], z]), torch.stack([z, imu_rpy[1], z]), w
        )[1]
        use = imu_rpy_ok & (torch.abs(imu_rpy[1]) < 1.4)
        pose = torch.stack([
            torch.where(use, roll_s, pose[0]), torch.where(use, pitch_s, pose[1]), *pose[2:]
        ])
    pose = torch.stack([
        torch.clamp(pose[0], -params.rot_tol, params.rot_tol),
        torch.clamp(pose[1], -params.rot_tol, params.rot_tol),
        pose[2], pose[3], pose[4],
        torch.clamp(pose[5], -params.z_tol, params.z_tol),
    ])

    # --- fusion correction with device-side divergence reinit ---
    R_l = se3.euler_to_rot(pose[:3])
    p_l = pose[3:]
    step = imu_fusion.fusion_step(
        filt, pre, R_l, p_l, reg_degenerate, params.fusion
    )
    fresh = imu_fusion.init_filter(R_l, p_l, params.fusion)
    new_filt = _select_filter(step.diverged, fresh, step.filter)

    # --- keyframe gating (saveFrame) ---
    rel = se3.pose_between(last_kf_pose, pose)
    is_kf = (torch.abs(rel[:3]) > params.kf_angle).any() | (
        torch.linalg.norm(rel[3:]) > params.kf_dist
    )
    return pose, new_filt, step.diverged, is_kf


def frame_core(
    xyz, rel_t, mask, scan_start,
    dk_times, dk_gyr, dk_mask,
    fu_acc, fu_gyr, fu_dts, fu_mask,
    grid: SpatialHashGrid,
    filt: imu_fusion.FusionFilter,
    last_kf_pose: torch.Tensor,
    params: FrameParams,
    imu_rpy: torch.Tensor | None = None,
    imu_rpy_ok: torch.Tensor | None = None,
    mesh=None,
) -> FrameCore:
    """The per-frame policy chain: deskew -> voxel downsample -> IMU
    preintegration guess -> scan-to-map GN -> 9-axis attitude slerp + z/rot
    clamps (transformUpdate, mapOptmization.cpp:1323-1353) -> fusion
    correction with divergence reinit -> keyframe gate (saveFrame,
    :1365-1384).

    With a ``mesh`` (``dist.sharded.GraphMesh``) the registration's points
    are split in contiguous blocks over its ranks; everything else runs
    whole on every rank (``dist/resident_sharded.py``)."""
    deskewed, ds_xyz, ds_mask, pre, guess = _frame_front(
        xyz, rel_t, mask, scan_start, dk_times, dk_gyr, dk_mask,
        fu_acc, fu_gyr, fu_dts, fu_mask, filt, params,
    )
    # --- scan-to-map GN (mapOptmization.scan2MapOptimization) ---
    res = scan_to_map(ds_xyz, ds_mask, grid, guess, params.match, mesh=mesh)
    pose, new_filt, diverged, is_kf = _frame_back(
        res.pose, res.degenerate, pre, filt, last_kf_pose, params, imu_rpy, imu_rpy_ok
    )
    return FrameCore(
        pose=pose,
        degenerate=res.degenerate,
        converged=res.converged,
        num_matched=res.num_matched,
        is_kf=is_kf,
        filter=new_filt,
        diverged=diverged,
        deskewed=deskewed,
        ds_xyz=ds_xyz,
        ds_mask=ds_mask,
        gn_iters=res.iters,
    )


def frame_core_lanes(
    xyz, rel_t, mask, scan_start,
    dk_times, dk_gyr, dk_mask,
    fu_acc, fu_gyr, fu_dts, fu_mask,
    grid: SpatialHashGrid,
    filt: imu_fusion.FusionFilter,
    last_kf_pose: torch.Tensor,
    params: FrameParams,
    imu_rpy: torch.Tensor,
    imu_rpy_ok: torch.Tensor,
) -> FrameCore:
    """:func:`frame_core` for B lock-step sessions: every input, the grid
    and the filter carry a leading [B] axis, and so does every output (the
    9-axis attitude is read only when ``params.imu_rpy_weight`` > 0).

    The parts that read nothing back run under ``torch.func.vmap``; the
    scan matcher, which reads its loop flag, is the batched
    ``scan_to_map_lanes`` (one K1 launch per iteration for all lanes)."""
    vmap = torch.func.vmap
    deskewed, ds_xyz, ds_mask, pre, guess = vmap(
        lambda *a: _frame_front(*a, params)
    )(xyz, rel_t, mask, scan_start, dk_times, dk_gyr, dk_mask,
      fu_acc, fu_gyr, fu_dts, fu_mask, filt)
    res = scan_to_map_lanes(ds_xyz, ds_mask, grid, guess, params.match)
    pose, new_filt, diverged, is_kf = vmap(
        lambda p, d, pr, f, kf, r, ok: _frame_back(p, d, pr, f, kf, params, r, ok)
    )(res.pose, res.degenerate, pre, filt, last_kf_pose, imu_rpy, imu_rpy_ok)
    return FrameCore(
        pose=pose,
        degenerate=res.degenerate,
        converged=res.converged,
        num_matched=res.num_matched,
        is_kf=is_kf,
        filter=new_filt,
        diverged=diverged,
        deskewed=deskewed,
        ds_xyz=ds_xyz,
        ds_mask=ds_mask,
        gn_iters=res.iters,
    )


def frame_step(
    # scan
    xyz: torch.Tensor,  # [cap, 3]
    rel_t: torch.Tensor,  # [cap]
    mask: torch.Tensor,  # [cap]
    scan_start: torch.Tensor,  # [] rebased seconds
    # deskew IMU window (covers the sweep)
    dk_times: torch.Tensor,
    dk_gyr: torch.Tensor,
    dk_mask: torch.Tensor,
    # fusion IMU window (previous scan -> this scan)
    fu_acc: torch.Tensor,
    fu_gyr: torch.Tensor,
    fu_dts: torch.Tensor,
    fu_mask: torch.Tensor,
    # state
    grid: SpatialHashGrid,
    filt: imu_fusion.FusionFilter,
    last_kf_pose: torch.Tensor,  # [6]
    params: FrameParams,
    imu_rpy: torch.Tensor | None = None,  # [3] 9-axis attitude at scan start
    imu_rpy_ok: torch.Tensor | None = None,  # [] bool
) -> FrameOutputs:
    """All tensors on one device; runs there."""
    core = frame_core(
        xyz, rel_t, mask, scan_start, dk_times, dk_gyr, dk_mask,
        fu_acc, fu_gyr, fu_dts, fu_mask, grid, filt, last_kf_pose,
        params, imu_rpy, imu_rpy_ok,
    )

    # --- ScanContext descriptor on the deskewed full cloud ---
    desc = scancontext.make_descriptor(core.deskewed, mask)
    key = scancontext.ring_key(desc)

    return FrameOutputs(
        pose=core.pose,
        degenerate=core.degenerate,
        converged=core.converged,
        num_matched=core.num_matched,
        is_kf=core.is_kf,
        filter=core.filter,
        diverged=core.diverged,
        ds_xyz=core.ds_xyz,
        ds_mask=core.ds_mask,
        sc_desc=desc,
        sc_key=key,
        deskewed=core.deskewed,
        summary=_pack_summary(
            core.pose, core.degenerate, core.converged, core.is_kf,
            core.num_matched, core.diverged, core.gn_iters,
        ),
        kf_payload=_pack_kf_payload(core.ds_xyz, core.ds_mask, desc, key),
        gn_iters=core.gn_iters,
    )


def bootstrap_step(
    xyz, rel_t, mask, scan_start, dk_times, dk_gyr, dk_mask,
    init_pose: torch.Tensor, params: FrameParams
):
    """First frame: deskew + downsample + descriptor + filter init."""
    if params.deskew:
        deskewed = deskew_frame(xyz, rel_t, mask, scan_start, dk_times, dk_gyr, dk_mask)
    else:
        deskewed = xyz
    ds_xyz, ds_mask = voxel_downsample_xyz(deskewed, mask, params.leaf, params.scan_cap)
    desc = scancontext.make_descriptor(deskewed, mask)
    key = scancontext.ring_key(desc)
    filt = imu_fusion.init_filter(
        se3.euler_to_rot(init_pose[:3]), init_pose[3:], params.fusion
    )
    return ds_xyz, ds_mask, desc, key, filt, deskewed, _pack_kf_payload(
        ds_xyz, ds_mask, desc, key
    )
