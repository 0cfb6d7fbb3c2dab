"""Device-resident SLAM pipeline: the whole SLAM state lives on the GPU.

The classic pipeline (``slam.LiorfPipeline``) keeps the keyframe store and
the factor lists on the host and uploads them for every solve. This one
keeps the ENTIRE SLAM state in device tensors — fusion filter, keyframe
rings, factor rings, local-map grid, trajectory ring, IMU-rate ring — and
advances it in place with one step per frame. The host packs scan/IMU
windows (numpy) into one buffer, ships it, and pulls results once at the
end.

Every per-frame decision the reference makes on the CPU (keyframe gating
``mapOptmization.cpp:1365-1384``, factor insertion ``:1386-1501``, iSAM
update ``:1521-1531``, pose rewrite ``:1611-1642``, local-map extraction
``:975-1058``) is a small data-parallel or masked computation on the card.
Loop closure runs there too: RS radius search + ScanContext detection,
world-frame submap fusion, ICP verification (kernel K2), and loop factors
feed the same device-resident pose graph at the configured cadence.

Where the JAX package (``liorf_tpu/pipeline/resident.py``) compiles the
step into one program with ``lax.cond`` branches, eager PyTorch runs real
branches, and a branch needs its condition on the host. Computing both
sides with ``torch.where`` would run the pose-graph solve on every frame,
so the host reads as few flags as the branches need:

* ``is_kf`` once per frame, after ``frame_core``;
* ``kf_count`` and the ``pending_loop`` latch are mirrored on the host
  (``HostView``) from those reads, so the loop gate needs no read;
* the loop branch reads its ICP gate once and skips the ICP when it is
  closed (the acceptance contains the gate, so the state is the same);
* the full-vs-window solve flag is read once, only on keyframe frames
  where a GPS candidate shipped or an ICP ran.

Ring writes at indices held on the device (counts, clamps, conditional
writes) go through ``index_copy_``/``index_select`` with index tensors and
never read the index back.
"""

from __future__ import annotations

import functools
import logging
import math
from collections import Counter, deque
from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..core import se3
from ..core.device import resolve_device
from ..core.pointcloud import PAD_COORD
from ..core.voxel import voxel_downsample_xyz
from ..graph import marginal
from ..graph import pose_graph as pg
from ..imu import fusion as imu_fusion
from ..mapping.keyframes import assemble_local_map, subsample_to_cap
from ..ops import knn, scancontext
from ..ops.deskew import deskew_frame
from ..ops.icp import ICPParams, icp_point2point, icp_point2point_lanes
from .config import SlamConfig
from .frame_step import FrameParams, frame_core, frame_core_lanes
from .slam import FrameResult, LiorfPipeline, next_aligned_gps

_F32 = torch.float32
_I64 = torch.int64


class ResidentParams(NamedTuple):
    frame: FrameParams
    # graph solve (static sizes/iterations); the full relaxation (loop/GPS
    # landed) needs the deep PCG budget, the per-keyframe trailing-window
    # step (16 free nodes) converges in far fewer iterations
    graph_window: int
    gn_iters: int = 4
    pcg_iters: int = 64
    window_gn_iters: int = 2
    window_pcg_iters: int = 16
    # local map assembly
    radius: float = 50.0
    recent_seconds: float = 10.0
    kf_density: float = 2.0
    near_cap: int = 64
    map_cap: int = 131072
    map_leaf: float = 0.5
    cell_size: float = 1.0
    kf_cloud_cap: int = 8192
    # gps
    use_gps_elevation: bool = False
    pose_cov_threshold: float = 25.0
    # loop closure (skipped entirely when disabled)
    loop_enabled: bool = False
    loop_search_radius: float = 15.0
    loop_time_diff: float = 30.0
    loop_submap_halfwidth: int = 25
    loop_icp_leaf: float = 0.5
    loop_fitness_thresh: float = 0.3
    loop_icp_cap: int = 16384
    loop_icp_iters: int = 100  # reference: setMaximumIterations(100), :575
    # acceptance gates beyond the reference's fitness check: minimum ICP
    # inlier fraction, and a drift-budget bound on the implied correction
    # (floor + budget * index gap * keyframe spacing) — a self-similar
    # wrong candidate aligns at low fitness but implies a correction no
    # odometry could have drifted (see the JAX package's ResidentParams)
    loop_min_inlier_frac: float = 0.4
    loop_drift_budget: float = 0.05
    loop_correction_floor: float = 2.0
    kf_spacing: float = 1.0  # surroundingkeyframeAddingDistThreshold


class ResidentState(NamedTuple):
    """Counts and index rings are int64 (torch's index type; int32 in the
    JAX package); every field is updated in place by the step, except
    ``filt`` and ``grid``, which it replaces."""

    # fusion filter + keyframe gate
    filt: imu_fusion.FusionFilter
    last_kf_pose: torch.Tensor  # [6]
    # keyframe rings
    kf_poses: torch.Tensor  # [K, 6] rpyxyz (post-solve)
    kf_times: torch.Tensor  # [K] rebased f32
    kf_clouds: torch.Tensor  # [K, C, 3] sensor-frame downsampled clouds
    kf_masks: torch.Tensor  # [K, C]
    kf_count: torch.Tensor  # []
    # ScanContext database
    sc_descs: torch.Tensor  # [K, 20, 60]
    sc_keys: torch.Tensor  # [K, 20]
    # odometry chain factor measurements: edge k connects (k, k+1)
    e_Rm: torch.Tensor  # [K, 3, 3]
    e_tm: torch.Tensor  # [K, 3]
    # gps factor ring
    g_i: torch.Tensor  # [G]
    g_t: torch.Tensor  # [G, 3]
    g_sqrt: torch.Tensor  # [G, 3]
    g_count: torch.Tensor  # []
    g_last: torch.Tensor  # [3] position of last accepted gps
    g_P: torch.Tensor  # [3, 3] (yaw,x,y) chain marginal for the poseCov gate
    # loop-closure factor ring
    l_i: torch.Tensor  # [L] earlier keyframe
    l_j: torch.Tensor  # [L] later keyframe
    l_Rm: torch.Tensor  # [L, 3, 3]
    l_tm: torch.Tensor  # [L, 3]
    l_sqrt: torch.Tensor  # [L, 6]
    l_cauchy: torch.Tensor  # [L]
    l_count: torch.Tensor  # []
    kf_has_loop: torch.Tensor  # [K] bool (loop_index_container equivalent)
    # graph anchor
    prior_R: torch.Tensor  # [3, 3]
    prior_t: torch.Tensor  # [3]
    # local map correspondence grid
    grid: knn.SpatialHashGrid
    # per-frame trajectory ring: pose(6), is_kf, degenerate, converged,
    # num_matched, latest-kf slot(1), latest-kf pose at the time(6) — the
    # last two let export re-anchor every frame onto the CORRECTED keyframe
    # poses (correctPoses parity for the full-rate trajectory)
    traj: torch.Tensor  # [T, 17]
    traj_count: torch.Tensor  # []
    # IMU-rate odometry ring: t, rpy(3), xyz(3), valid — the reference's
    # odometry/imu output stream (imuPreintegration.cpp:23-154,458-506)
    imu_traj: torch.Tensor  # [TI, 8]
    imu_count: torch.Tensor  # []
    # latched loop-closure cadence: a do_loop tick that lands on a frame
    # failing the keyframe gate persists until the NEXT keyframe consumes it
    # (the reference's loop thread inspects the latest keyframe at 1 Hz
    # regardless of when it was added, mapOptmization.cpp:515-542)
    pending_loop: torch.Tensor  # [] bool


class HostView(NamedTuple):
    """What the host knows of the device state without reading it: the
    keyframe count (``min(count + 1, K)`` on every keyframe, and ``is_kf``
    is read each frame) and the loop latch (a function of the two)."""

    kf_count: int
    pending_loop: bool


# ---------------------------------------------------------------------------
# ring access at indices held on the device (no host read of the index)
# ---------------------------------------------------------------------------

def _at(ring: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``ring[i]`` for a 0-dim device index (``ring[i]`` itself would read
    ``i`` back to the host)."""
    return ring.index_select(0, i.reshape(1))[0]


def _put(ring: torch.Tensor, i: torch.Tensor, value: torch.Tensor) -> None:
    """``ring[i] = value`` in place (JAX: ``ring.at[i].set(value)``)."""
    ring.index_copy_(0, i.reshape(1), value.to(ring.dtype).unsqueeze(0))


def _put_where(ring: torch.Tensor, i: torch.Tensor, cond, value) -> None:
    """``ring[i] = cond ? value : ring[i]`` in place (JAX:
    ``jnp.where(cond, ring.at[i].set(value), ring)``)."""
    _put(ring, i, torch.where(cond, value.to(ring.dtype), _at(ring, i)))


def _chain_edge(prev_pose: torch.Tensor, new_pose: torch.Tensor):
    """Between-factor measurement prev -> new from euler poses."""
    Rp = se3.euler_to_rot(prev_pose[:3])
    Rn = se3.euler_to_rot(new_pose[:3])
    Rm = Rp.T @ Rn
    tm = Rp.T @ (new_pose[3:] - prev_pose[3:])
    return Rm, tm


def _solve_graph_resident(state: ResidentState, params: ResidentParams, full: bool):
    """Windowed (or full, when ``full``) GN relaxation over the kf rings.

    The graph spans all K ring slots plus the L loop slots, masked by the
    counts. The odometry-factor sqrt-information mirrors the reference's
    odometryNoise (variances 1e-6 rot / 1e-4 trans,
    mapOptmization.cpp:1390-1393)."""
    K = state.kf_poses.shape[0]
    G = state.g_i.shape[0]
    L = state.l_i.shape[0]
    dev = state.kf_poses.device
    idx = torch.arange(K, dtype=_I64, device=dev)
    count = state.kf_count
    e_sqrt = torch.cat(
        [torch.full((3,), 1.0e3, dtype=_F32, device=dev), torch.full((3,), 1.0e2, dtype=_F32, device=dev)]
    )
    # edges = odometry chain (K slots) ++ loop factors (L slots)
    graph = pg.PoseGraph(
        Rs=se3.euler_to_rot(state.kf_poses[:, :3]),
        ts=state.kf_poses[:, 3:6],
        node_mask=idx < count,
        e_i=torch.cat([idx, state.l_i]),
        e_j=torch.cat([torch.clamp(idx + 1, max=K - 1), state.l_j]),
        e_Rm=torch.cat([state.e_Rm, state.l_Rm]),
        e_tm=torch.cat([state.e_tm, state.l_tm]),
        e_sqrt_info=torch.cat([e_sqrt.expand(K, 6), state.l_sqrt]),
        e_cauchy=torch.cat([torch.zeros((K,), dtype=_F32, device=dev), state.l_cauchy]),
        e_mask=torch.cat(
            [(idx + 1) < count, torch.arange(L, dtype=_I64, device=dev) < state.l_count]
        ),
        g_i=state.g_i,
        g_t=state.g_t,
        g_sqrt_info=state.g_sqrt,
        g_mask=torch.arange(G, dtype=_I64, device=dev) < state.g_count,
        prior_i=torch.zeros((), dtype=_I64, device=dev),
        prior_R=state.prior_R,
        prior_t=state.prior_t,
        prior_sqrt_info=torch.full((6,), 1.0e2, dtype=_F32, device=dev),
    )
    # a real branch in place of lax.cond(full, ...) (resident.py:212 there)
    if full:
        solved = pg.solve(
            graph, free_from=0,
            params=pg.SolveParams(gn_iters=params.gn_iters, pcg_iters=params.pcg_iters),
        )
    else:
        solved = pg.solve(
            graph, free_from=torch.clamp(count - params.graph_window, min=0),
            params=pg.SolveParams(
                gn_iters=params.window_gn_iters, pcg_iters=params.window_pcg_iters
            ),
        )
    rpy = se3.rot_to_euler(solved.Rs)
    new_poses = torch.cat([rpy, solved.ts], dim=-1).to(_F32)
    keep = (idx < count)[:, None]
    return torch.where(keep, new_poses, state.kf_poses)


class LoopPrep(NamedTuple):
    """What the loop branch knows before its ICP (see _loop_prepare)."""

    src_xyz: torch.Tensor  # [cap, 3] current submap (SC pre-rotated), padded
    cur_m: torch.Tensor  # [cap]
    prev_xyz: torch.Tensor  # [cap, 3] candidate's +-halfwidth submap
    prev_m: torch.Tensor  # [cap]
    gate: torch.Tensor  # [] bool: a candidate and enough points
    use_sc: torch.Tensor  # [] bool: ScanContext candidate (init from its yaw)
    init_pose: torch.Tensor  # [6]
    cur_pose: torch.Tensor  # [6]
    cand_pose: torch.Tensor  # [6]
    cur_k: torch.Tensor  # [] keyframe closing the loop
    cand: torch.Tensor  # [] earlier keyframe


def _loop_prepare(state: ResidentState, params: ResidentParams, k, now,
                  do_loop, ext_has, ext_t_cur, ext_t_pre) -> LoopPrep:
    """Loop branch up to the ICP, for the just-inserted keyframe ``k`` (a
    device index). Reads nothing back (runs under vmap on stacked lanes).

    External candidate first (time-stamped pair from a third-party
    detector, ``mapOptmization.cpp:767-819``: stamps mapped to the nearest
    keyframes by searchsorted over the time ring), then RS (radius +
    time-gap search over keyframe positions, ``:732-765``), then
    ScanContext fallback (``Scancontext.cpp:253-344``); the chosen
    candidate's +-halfwidth world-frame submap (``:821-844``, leaf 0.5)
    and the current keyframe's cloud are the ICP's inputs."""
    K = state.kf_poses.shape[0]
    dev = state.kf_poses.device
    idx = torch.arange(K, dtype=_I64, device=dev)
    count = state.kf_count
    last = count - 1

    # --- external candidate (loop times -> keyframe indices; the
    # reference scans the sorted time ring from both ends, :787-806 —
    # equivalent to searchsorted over the ascending keyframe times)
    times_sorted = torch.where(idx < count, state.kf_times, torch.inf)
    ext_cur = torch.minimum(
        torch.searchsorted(times_sorted, ext_t_cur.reshape(1), side="left")[0], last
    )
    ext_pre = torch.minimum(
        torch.clamp(
            torch.searchsorted(times_sorted, ext_t_pre.reshape(1), side="right")[0] - 1, min=0
        ),
        last,
    )
    ext_found = ext_has & (ext_cur != ext_pre) & ~_at(state.kf_has_loop, ext_cur)

    cur_k = torch.where(ext_found, ext_cur, k)
    cur_pose = _at(state.kf_poses, cur_k)

    # --- RS candidate (always about the just-inserted keyframe k)
    pos = state.kf_poses[:, 3:6]
    d = torch.linalg.vector_norm(pos - _at(state.kf_poses, k)[3:6], dim=-1)
    rs_ok = (
        (idx < count)
        & (idx != k)
        & (d <= params.loop_search_radius)
        & ((now - state.kf_times) > params.loop_time_diff)
    )
    # all-inf -> index 0, as jnp.argmin
    rs_cand = torch.argmin(torch.where(rs_ok, d, torch.inf))
    # RS/SC only fire on loop-cadence frames (the reference's 1 Hz loop
    # thread); an off-cadence frame can still carry an external candidate
    rs_found = _at(rs_ok, rs_cand) & do_loop

    # --- SC candidate (only consulted when RS finds nothing)
    det = scancontext.detect_loop(
        state.sc_descs, state.sc_keys, count, _at(state.sc_descs, k), _at(state.sc_keys, k)
    )
    sc_found = (det.index >= 0) & (det.index != k) & do_loop

    use_sc = (~ext_found) & (~rs_found) & sc_found
    found = ext_found | rs_found | sc_found
    cand = torch.where(
        ext_found, ext_pre, torch.where(rs_found, rs_cand, torch.clamp(det.index, min=0))
    )

    # --- submaps in world frame
    def world_points(sel_idx, sel_ok):
        poses = state.kf_poses[sel_idx]
        Rw = se3.euler_to_rot(poses[:, :3])
        tw = poses[:, 3:6]
        pts = torch.einsum("kij,kcj->kci", Rw, state.kf_clouds[sel_idx]) + tw[:, None, :]
        m = state.kf_masks[sel_idx] & sel_ok[:, None]
        pts = torch.where(m[..., None], pts, PAD_COORD)
        return pts.reshape(-1, 3), m.reshape(-1)

    half = params.loop_submap_halfwidth
    nbr = cand + torch.arange(-half, half + 1, dtype=_I64, device=dev)
    nbr_ok = (nbr >= 0) & (nbr < count)
    nbr = torch.clamp(nbr, 0, K - 1)
    prev_xyz, prev_m = world_points(nbr, nbr_ok)
    prev_xyz, prev_m = voxel_downsample_xyz(
        prev_xyz, prev_m, params.loop_icp_leaf, params.loop_icp_cap
    )

    cur_xyz, cur_m = world_points(cur_k.reshape(1), torch.ones((1,), dtype=torch.bool, device=dev))
    cur_xyz, cur_m = voxel_downsample_xyz(
        cur_xyz, cur_m, params.loop_icp_leaf, params.loop_icp_cap
    )
    # SC init: pre-rotate the current submap by the estimated yaw about the
    # candidate pose (the reference initializes ICP from the SC yaw)
    cand_pose = _at(state.kf_poses, cand)
    z = torch.zeros_like(det.yaw)
    yaw_pose = torch.stack([z, z, det.yaw, z, z, z]).to(_F32)
    init_pose = se3.pose_compose(cand_pose, yaw_pose)
    Ri, ti = se3.euler_to_rot(init_pose[:3]), init_pose[3:]
    Rc, tc = se3.euler_to_rot(cur_pose[:3]), cur_pose[3:]
    # T_delta = init_world_pose o cur_pose^-1
    Rd, td = se3.se3_compose(Ri, ti, Rc.T, -(Rc.T @ tc))
    moved = cur_xyz @ Rd.T + td
    src_xyz = torch.where(use_sc, moved, cur_xyz)
    src_xyz = torch.where(cur_m[:, None], src_xyz, PAD_COORD)

    n_cur = torch.sum(cur_m.to(_I64))
    n_prev = torch.sum(prev_m.to(_I64))
    gate = found & (n_cur >= 300) & (n_prev >= 1000) & ~_at(state.kf_has_loop, cur_k)
    return LoopPrep(src_xyz, cur_m, prev_xyz, prev_m, gate, use_sc, init_pose,
                    cur_pose, cand_pose, cur_k, cand)


def _loop_factor(prep: LoopPrep, res_pose, res_converged, res_fitness, res_inlier_frac,
                 params: ResidentParams):
    """Loop branch after the ICP: acceptance and the factor's measurement
    and noise. Reads nothing back (runs under vmap). Returns (accept, Rm,
    tm, sqrt_info, cauchy)."""
    # corrected world pose of the current keyframe: icp o (init or cur)
    base = torch.where(prep.use_sc, prep.init_pose, prep.cur_pose)
    corrected = se3.pose_compose(res_pose, base)
    rel = se3.pose_between(prep.cand_pose, corrected)
    Rm = se3.euler_to_rot(rel[:3])
    tm = rel[3:]

    # acceptance: reference fitness gate (mapOptmization.cpp:581-585) PLUS
    # inlier-fraction and drift-budget consistency (see ResidentParams)
    corr_norm = torch.linalg.vector_norm(corrected[3:] - prep.cur_pose[3:])
    idx_gap = torch.abs(prep.cur_k - prep.cand).to(_F32)
    budget = (
        params.loop_correction_floor
        + params.loop_drift_budget * idx_gap * params.kf_spacing
    )
    accept = (
        prep.gate
        & res_converged
        & (res_fitness <= params.loop_fitness_thresh)
        & (res_inlier_frac >= params.loop_min_inlier_frac)
        & (corr_norm <= budget)
    )

    # noise: SC loops get the constant robust model (var 0.5 + Cauchy 1,
    # :711-726); RS loops fitness-scaled diagonal (:596-620)
    sc_sigma = torch.full((6,), math.sqrt(0.5), dtype=_F32, device=res_pose.device)
    rs_sigma = torch.sqrt(torch.clamp(res_fitness, min=1e-4)).to(_F32).expand(6)
    sigma = torch.where(prep.use_sc, sc_sigma, rs_sigma)
    return accept, Rm, tm, 1.0 / sigma, prep.use_sc.to(_F32)


def _loop_icp_params(params: ResidentParams) -> ICPParams:
    return ICPParams(
        max_iters=params.loop_icp_iters,
        max_corr_dist=params.loop_search_radius * 2.0,
    )


def _try_loop_closure(state: ResidentState, params: ResidentParams, k, now,
                      do_loop: bool, ext_has: bool, ext_t_cur, ext_t_pre,
                      tally: Counter):
    """Loop closure for the just-inserted keyframe ``k`` (a device index):
    candidate and submaps (:func:`_loop_prepare`), ICP verification (kernel
    K2) and acceptance under the fitness threshold (``:571-585``) and the
    two extra gates of ``ResidentParams`` (:func:`_loop_factor`).

    Updates the loop rings in place. Returns ``(state, added)``: ``added``
    is a device bool when an ICP ran, else ``False`` (the gate was closed,
    one host read, and nothing can have been added)."""
    dev = state.kf_poses.device
    prep = _loop_prepare(state, params, k, now, do_loop, ext_has, ext_t_cur, ext_t_pre)
    # The JAX branch runs the ICP whatever the gate and throws the result
    # away; the acceptance contains the gate, so skipping it when the
    # gate is closed leaves the state the same.
    tally["read:loop_gate"] += 1
    if not bool(prep.gate):
        return state, False
    tally["icp_runs"] += 1
    res = icp_point2point(
        prep.src_xyz, prep.cur_m, prep.prev_xyz, prep.prev_m,
        torch.zeros(6, dtype=_F32, device=dev), _loop_icp_params(params),
    )
    accept, Rm, tm, sqrt_info, cauchy = _loop_factor(
        prep, res.pose, res.converged, res.fitness, res.inlier_frac, params
    )

    L = state.l_i.shape[0]
    li = torch.clamp(state.l_count, max=L - 1)
    can_add = accept & (state.l_count < L)
    _put_where(state.l_i, li, can_add, prep.cand)
    _put_where(state.l_j, li, can_add, prep.cur_k)
    _put_where(state.l_Rm, li, can_add, Rm)
    _put_where(state.l_tm, li, can_add, tm)
    _put_where(state.l_sqrt, li, can_add, sqrt_info)
    _put_where(state.l_cauchy, li, can_add, cauchy)
    state.l_count.add_(can_add.to(_I64))
    _put(state.kf_has_loop, prep.cur_k, _at(state.kf_has_loop, prep.cur_k) | can_add)
    return state, can_add


def _insert_keyframe(state: ResidentState, params: ResidentParams, host_kf_count: int,
                     pose, now, ds_xyz, ds_mask, desc, key,
                     gps_has: bool, gps_enu, gps_sigma,
                     do_loop: bool, ext_has: bool, ext_t_cur, ext_t_pre,
                     tally: Counter):
    """Keyframe branch: ring appends + factors + solve + grid rebuild."""
    K = state.kf_poses.shape[0]
    C = params.kf_cloud_cap
    dev = state.kf_poses.device
    k = torch.clamp(state.kf_count, max=K - 1)  # clamp (ring full => overwrite last)
    km1 = torch.clamp(k - 1, min=0)
    # read from the ring as it was before this keyframe's writes
    prev_pose = _at(state.kf_poses, km1)
    first_xyz = state.kf_poses[0, 3:6].clone()

    _put(state.kf_poses, k, pose)
    _put(state.kf_times, k, now)
    kfc_xyz, kfc_m = subsample_to_cap(ds_xyz, ds_mask, C)
    _put(state.kf_clouds, k, kfc_xyz)
    _put(state.kf_masks, k, kfc_m)
    _put(state.sc_descs, k, desc)
    _put(state.sc_keys, k, key)

    # odometry chain factor (k-1 -> k); skipped for the first keyframe
    Rm, tm = _chain_edge(prev_pose, pose)
    has_prev = k > 0
    _put_where(state.e_Rm, km1, has_prev, Rm)
    _put_where(state.e_tm, km1, has_prev, tm)

    # chain-marginal propagation for the poseCovThreshold GPS gate
    # (graph/marginal.py; iSAM2 marginalCovariance at mapOptmization.cpp:1416)
    dyaw = torch.atan2(Rm[1, 0], Rm[0, 0])
    g_P = torch.where(
        has_prev,
        marginal.propagate(state.g_P, prev_pose[2], torch.stack([dyaw, tm[0], tm[1]]), torch),
        state.g_P,
    )

    # GPS factor (addGPSFactor gating that depends on device state:
    # >=5 m trajectory extent (:1408-1414), pose-covariance drift gate
    # (:1416-1418), >=5 m spacing, elevation override;
    # mapOptmization.cpp:1441-1476). Without a candidate nothing changes.
    add_gps = False
    if gps_has:
        if params.use_gps_elevation:
            gz, gsz = gps_enu[2], gps_sigma[2]
        else:
            gz, gsz = pose[5], torch.full((), 0.1, dtype=_F32, device=dev)
        enu = torch.stack([gps_enu[0], gps_enu[1], gz])
        sig = torch.clamp(torch.stack([gps_sigma[0], gps_sigma[1], gsz]), min=1.0)
        far = torch.linalg.vector_norm(enu - state.g_last) >= 5.0
        traveled = torch.linalg.vector_norm(pose[3:6] - first_xyz) >= 5.0
        cov_open = marginal.gate_open(g_P, params.pose_cov_threshold)
        G = state.g_i.shape[0]
        add_gps = far & traveled & cov_open & (state.g_count < G)
        gi = torch.clamp(state.g_count, max=G - 1)
        _put_where(state.g_i, gi, add_gps, k)
        _put_where(state.g_t, gi, add_gps, enu)
        _put_where(state.g_sqrt, gi, add_gps, 1.0 / sig)
        state.g_count.add_(add_gps.to(_I64))
        state.g_last.copy_(torch.where(add_gps, enu, state.g_last))
        g_P = torch.where(
            add_gps, marginal.gps_update(g_P, sig[0] ** 2, sig[1] ** 2, torch), g_P
        )
    state.g_P.copy_(g_P)
    state.kf_count.copy_(torch.clamp(state.kf_count + 1, max=K))

    # loop closure at the loop cadence (a real branch in place of lax.cond
    # at resident.py:486 there; its condition is all host-known)
    loop_added = False
    if params.loop_enabled and (do_loop or ext_has) and min(host_kf_count + 1, K) > 2:
        state, loop_added = _try_loop_closure(
            state, params, k, now, do_loop, ext_has, ext_t_cur, ext_t_pre, tally
        )

    # graph relaxation (full batch when a GPS factor or loop landed,
    # matching the reference's extra isam updates on aLoopIsClosed,
    # :1524-1531). One read, and only when a flag lives on the device.
    full = add_gps | loop_added  # a Python False unless a flag lives on the device
    if isinstance(full, torch.Tensor):
        tally["read:full"] += 1
        full = bool(full)
    state.kf_poses.copy_(_solve_graph_resident(state, params, full))
    new_pose = _at(state.kf_poses, k)

    grid = assemble_local_map(
        state.kf_poses, state.kf_clouds, state.kf_masks, state.kf_times, state.kf_count,
        new_pose[3:6], now,
        radius=params.radius, recent_seconds=params.recent_seconds,
        near_cap=params.near_cap, map_cap=params.map_cap,
        leaf=params.map_leaf, cell_size=params.cell_size,
        density=params.kf_density,
    )
    state.last_kf_pose.copy_(new_pose)
    return state._replace(grid=grid), new_pose


def resident_step(
    state: ResidentState,
    host: HostView,
    # scan
    xyz, rel_t, mask, scan_start,
    # deskew IMU window
    dk_times, dk_gyr, dk_mask,
    # fusion IMU window
    fu_acc, fu_gyr, fu_dts, fu_mask, fu_times,
    # 9-axis attitude (zeros + False when unavailable)
    imu_rpy, imu_rpy_ok,
    # gps candidate (pre-gated host-side for time/cov); gps_has is a bool
    gps_has: bool, gps_enu, gps_sigma,
    # loop-closure cadence flag (host: ~1 Hz)
    do_loop: bool,
    # external loop candidate (rebased stamps; loopInfoHandler parity)
    ext_has: bool, ext_t_cur, ext_t_pre,
    params: ResidentParams,
    tally: Counter,
    mesh=None,
) -> tuple[ResidentState, HostView, torch.Tensor]:
    """One frame. Tensors on the state's device; the three flags are host
    bools. Updates ``state`` in place and returns ``(state, host, gn_iters)``:
    the new host view and the scan matcher's GN iteration count (a device
    tensor). ``tally`` counts host reads by kind (``read:*``) and ICP runs.
    A ``mesh`` splits the registration's points over its ranks
    (``frame_step.frame_core``)."""
    fp = params.frame
    dev = state.kf_poses.device

    # --- IMU-rate odometry recording (TransformFusion parity) ---
    # Propagate the previous fused state through this frame's IMU window
    # and append the per-sample poses to the IMU-rate ring
    # (imuPreintegration.cpp:406-432,458-506).
    ir_R, ir_p = imu_fusion.predict_poses_parallel(
        state.filt.mean, fu_acc, fu_gyr, fu_dts, fu_mask,
        gravity=fp.fusion.imu.gravity,
    )
    ir_block = torch.cat(
        [fu_times[:, None], se3.rot_to_euler(ir_R), ir_p, fu_mask[:, None].to(_F32)], dim=1
    ).to(_F32)
    TI, Wb = state.imu_traj.shape[0], ir_block.shape[0]
    # the clamp dynamic_update_slice applies to its start (resident.py:551)
    ir_off = torch.clamp(state.imu_count, max=TI - Wb)
    state.imu_traj.index_copy_(0, ir_off + torch.arange(Wb, dtype=_I64, device=dev), ir_block)
    state.imu_count.copy_(torch.clamp(state.imu_count + torch.sum(fu_mask.to(_I64)), max=TI))

    # --- shared per-frame core: deskew -> downsample -> guess ->
    # registration -> slerp/clamps -> fusion correction -> kf gate ---
    core = frame_core(
        xyz, rel_t, mask, scan_start, dk_times, dk_gyr, dk_mask,
        fu_acc, fu_gyr, fu_dts, fu_mask,
        state.grid, state.filt, state.last_kf_pose, fp,
        imu_rpy if fp.imu_rpy_weight > 0 else None, imu_rpy_ok, mesh=mesh,
    )
    state = state._replace(filt=core.filter)
    tally["read:is_kf"] += 1
    is_kf = bool(core.is_kf)
    now = scan_start

    # latched loop cadence: a tick that misses a keyframe frame persists
    # until a keyframe actually RUNS the search (mapOptmization.cpp:515-542);
    # the search also needs kf_count > 2 after the insert
    K = state.kf_poses.shape[0]
    want_loop = host.pending_loop or do_loop
    search_runs = is_kf and min(host.kf_count + 1, K) > 2
    pending = want_loop and not search_runs
    state.pending_loop.fill_(pending)

    if is_kf:
        # ScanContext descriptor only exists per keyframe (the reference
        # computes it in saveKeyFramesAndFactor, mapOptmization.cpp:1587-1595)
        desc = scancontext.make_descriptor(core.deskewed, mask)
        key = scancontext.ring_key(desc)
        state, out_pose = _insert_keyframe(
            state, params, host.kf_count, core.pose, now, core.ds_xyz, core.ds_mask,
            desc, key, gps_has, gps_enu, gps_sigma, want_loop, ext_has, ext_t_cur,
            ext_t_pre, tally,
        )
        host = HostView(min(host.kf_count + 1, K), pending)
    else:
        out_pose = core.pose
        host = HostView(host.kf_count, pending)

    # --- trajectory ring append ---
    # cols 0-5: pose at the time; 6-9: is_kf/degenerate/converged/matched;
    # col 10: slot of the latest keyframe; 11-16: that keyframe's pose at
    # the time (re-anchored at export: corrected = kf_now[slot] o
    # (kf_then^-1 o pose), the reference's correctPoses, :1611-1642)
    T = state.traj.shape[0]
    t_i = torch.clamp(state.traj_count, max=T - 1)
    entry = torch.cat(
        [
            out_pose.to(_F32),
            torch.stack(
                [
                    core.is_kf.to(_F32),
                    core.degenerate.to(_F32),
                    core.converged.to(_F32),
                    core.num_matched.to(_F32),
                ]
            ),
            (state.kf_count - 1).to(_F32)[None],
            state.last_kf_pose.to(_F32),
        ]
    )
    _put(state.traj, t_i, entry)
    state.traj_count.copy_(torch.clamp(state.traj_count + 1, max=T))
    return state, host, core.gn_iters


# ---------------------------------------------------------------------------
# Lane axis: B lock-step sessions, state stacked on a leading [B] axis
# (pipeline/multistream.py). JAX vmaps resident_step, and its lax.cond
# branches become selects; here the host reads each branch condition as ONE
# [B] vector, runs a branch when any lane takes it, batched over all lanes,
# and masks every ring write by that lane's flag.
# ---------------------------------------------------------------------------

def stack_states(states):
    """One state with a leading [B] axis on every tensor, from B states of
    one shape (nested NamedTuples included)."""
    first = states[0]
    if isinstance(first, tuple):
        return type(first)(*(stack_states(list(f)) for f in zip(*states)))
    return torch.stack(states)


def lane_state(state, b: int):
    """Lane ``b`` of a stacked state (views of the stacked tensors)."""
    if isinstance(state, tuple):
        return type(state)(*(lane_state(f, b) for f in state))
    return state[b]


def _bcast(cond: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[B] condition reshaped to broadcast against a [B, ...] value."""
    return cond.reshape(cond.shape + (1,) * (like.dim() - cond.dim()))


def _put_where_lanes(ring, lanes, i, cond, value) -> None:
    """``ring[lanes[b], i[b]] = cond[b] ? value[b] : ring[lanes[b], i[b]]``
    in place for every b (index tensors: nothing is read back)."""
    old = ring[lanes, i]
    ring[lanes, i] = torch.where(_bcast(cond, old), value.to(ring.dtype), old)


def _flags(xs, dev) -> torch.Tensor:
    """A list of host bools as a [B] device tensor."""
    return torch.tensor(xs, dtype=torch.bool).to(dev, non_blocking=True)


def _try_loop_closure_lanes(state: ResidentState, params: ResidentParams, search,
                            k, now, do_loop, ext_has, ext_t_cur, ext_t_pre,
                            tally: Counter):
    """:func:`_try_loop_closure` on the lanes where ``search`` (host bools)
    is set: the candidates and submaps of every lane under vmap, ONE read of
    the [B] gate, then one batched ICP (one K2 launch per iteration) over
    the lanes whose gate is open. Returns a device [B] bool of the lanes
    that added a loop factor, or None when no ICP ran."""
    dev = state.kf_poses.device
    B = state.kf_poses.shape[0]
    prep = torch.func.vmap(
        lambda st, kk, nw, dl, eh, tc, tp: _loop_prepare(st, params, kk, nw, dl, eh, tc, tp)
    )(state, k, now, _flags(do_loop, dev), _flags(ext_has, dev), ext_t_cur, ext_t_pre)
    gate = prep.gate & _flags(search, dev)
    tally["read:loop_gate"] += 1
    open_lanes = [b for b, g in enumerate(gate.tolist()) if g]
    if not open_lanes:
        return None
    tally["icp_runs"] += 1
    tally["icp_lanes"] += len(open_lanes)
    sub = torch.tensor(open_lanes, dtype=_I64).to(dev, non_blocking=True)
    sp = LoopPrep(*(x.index_select(0, sub) for x in prep))
    res = icp_point2point_lanes(
        sp.src_xyz, sp.cur_m, sp.prev_xyz, sp.prev_m,
        torch.zeros((len(open_lanes), 6), dtype=_F32, device=dev), _loop_icp_params(params),
    )
    accept, Rm, tm, sqrt_info, cauchy = torch.func.vmap(
        lambda p, rp, rc, rf, ri: _loop_factor(p, rp, rc, rf, ri, params)
    )(sp, res.pose, res.converged, res.fitness, res.inlier_frac)

    L = state.l_i.shape[1]
    l_count = state.l_count.index_select(0, sub)
    li = torch.clamp(l_count, max=L - 1)
    can_add = accept & (l_count < L)
    _put_where_lanes(state.l_i, sub, li, can_add, sp.cand)
    _put_where_lanes(state.l_j, sub, li, can_add, sp.cur_k)
    _put_where_lanes(state.l_Rm, sub, li, can_add, Rm)
    _put_where_lanes(state.l_tm, sub, li, can_add, tm)
    _put_where_lanes(state.l_sqrt, sub, li, can_add, sqrt_info)
    _put_where_lanes(state.l_cauchy, sub, li, can_add, cauchy)
    state.l_count.index_add_(0, sub, can_add.to(_I64))
    _put_where_lanes(state.kf_has_loop, sub, sp.cur_k, can_add, can_add)
    added = torch.zeros((B,), dtype=torch.bool, device=dev)
    return added.index_copy(0, sub, can_add)


def _insert_keyframe_lanes(state: ResidentState, params: ResidentParams, hosts, is_kf,
                           kf_mask, pose, now, ds_xyz, ds_mask, desc, key,
                           gps_has, gps_enu, gps_sigma, do_loop, ext_has,
                           ext_t_cur, ext_t_pre, tally: Counter):
    """:func:`_insert_keyframe` on every lane at once, each ring write
    masked by that lane's ``kf_mask`` (device [B]; ``is_kf`` is the same as
    host bools); the solves and the local-map rebuild run under vmap over
    all lanes and are kept where the lane is a keyframe — lax.cond under
    vmap. Returns (state, new_pose [B, 6])."""
    B, K = state.kf_poses.shape[:2]
    C = params.kf_cloud_cap
    dev = state.kf_poses.device
    vmap = torch.func.vmap
    lanes = torch.arange(B, device=dev)
    m = kf_mask
    k = torch.clamp(state.kf_count, max=K - 1)
    km1 = torch.clamp(k - 1, min=0)
    prev_pose = state.kf_poses[lanes, km1]
    first_xyz = state.kf_poses[:, 0, 3:6].clone()

    _put_where_lanes(state.kf_poses, lanes, k, m, pose)
    _put_where_lanes(state.kf_times, lanes, k, m, now)
    kfc_xyz, kfc_m = vmap(lambda x, mm: subsample_to_cap(x, mm, C))(ds_xyz, ds_mask)
    _put_where_lanes(state.kf_clouds, lanes, k, m, kfc_xyz)
    _put_where_lanes(state.kf_masks, lanes, k, m, kfc_m)
    _put_where_lanes(state.sc_descs, lanes, k, m, desc)
    _put_where_lanes(state.sc_keys, lanes, k, m, key)

    Rm, tm = vmap(_chain_edge)(prev_pose, pose)
    has_prev = (k > 0) & m
    _put_where_lanes(state.e_Rm, lanes, km1, has_prev, Rm)
    _put_where_lanes(state.e_tm, lanes, km1, has_prev, tm)
    dyaw = torch.atan2(Rm[:, 1, 0], Rm[:, 0, 0])
    prop = vmap(lambda P, y, d: marginal.propagate(P, y, d, torch))(
        state.g_P, prev_pose[:, 2], torch.stack([dyaw, tm[:, 0], tm[:, 1]], dim=-1)
    )
    g_P = torch.where(_bcast(has_prev, prop), prop, state.g_P)

    add_gps = None
    if any(g and kf for g, kf in zip(gps_has, is_kf)):
        gm = _flags(gps_has, dev) & m
        if params.use_gps_elevation:
            gz, gsz = gps_enu[:, 2], gps_sigma[:, 2]
        else:
            gz, gsz = pose[:, 5], torch.full((B,), 0.1, dtype=_F32, device=dev)
        enu = torch.stack([gps_enu[:, 0], gps_enu[:, 1], gz], dim=-1)
        sig = torch.clamp(torch.stack([gps_sigma[:, 0], gps_sigma[:, 1], gsz], dim=-1), min=1.0)
        far = torch.linalg.vector_norm(enu - state.g_last, dim=-1) >= 5.0
        traveled = torch.linalg.vector_norm(pose[:, 3:6] - first_xyz, dim=-1) >= 5.0
        cov_open = vmap(lambda P: marginal.gate_open(P, params.pose_cov_threshold))(g_P)
        G = state.g_i.shape[1]
        add_gps = gm & far & traveled & cov_open & (state.g_count < G)
        gi = torch.clamp(state.g_count, max=G - 1)
        _put_where_lanes(state.g_i, lanes, gi, add_gps, k)
        _put_where_lanes(state.g_t, lanes, gi, add_gps, enu)
        _put_where_lanes(state.g_sqrt, lanes, gi, add_gps, 1.0 / sig)
        state.g_count.add_(add_gps.to(_I64))
        state.g_last.copy_(torch.where(add_gps[:, None], enu, state.g_last))
        upd = vmap(lambda P, vx, vy: marginal.gps_update(P, vx, vy, torch))(
            g_P, sig[:, 0] ** 2, sig[:, 1] ** 2
        )
        g_P = torch.where(_bcast(add_gps, upd), upd, g_P)
    state.g_P.copy_(g_P)
    state.kf_count.copy_(torch.where(m, torch.clamp(state.kf_count + 1, max=K), state.kf_count))

    # loop closure at the loop cadence, on the lanes whose (host-known)
    # condition holds
    search = [
        kf and params.loop_enabled and (dl or eh) and min(h.kf_count + 1, K) > 2
        for kf, dl, eh, h in zip(is_kf, do_loop, ext_has, hosts)
    ]
    loop_added = None
    if any(search):
        loop_added = _try_loop_closure_lanes(
            state, params, search, k, now, do_loop, ext_has, ext_t_cur, ext_t_pre, tally
        )

    # graph relaxation: the window solve on every lane; the full one too
    # when a lane landed a GPS or loop factor (ONE read of the [B] flags)
    flags = [x for x in (add_gps, loop_added) if x is not None]
    full = [False] * B
    if flags:
        tally["read:full"] += 1
        full = (functools.reduce(torch.logical_or, flags) & m).tolist()
    solved = vmap(lambda st: _solve_graph_resident(st, params, False))(state)
    if any(full):
        solved_full = vmap(lambda st: _solve_graph_resident(st, params, True))(state)
        solved = torch.where(_bcast(_flags(full, dev), solved), solved_full, solved)
    state.kf_poses.copy_(torch.where(_bcast(m, solved), solved, state.kf_poses))
    new_pose = state.kf_poses[lanes, k]

    grid = vmap(
        lambda P, Cl, Ms, T, n, ctr, nw: assemble_local_map(
            P, Cl, Ms, T, n, ctr, nw,
            radius=params.radius, recent_seconds=params.recent_seconds,
            near_cap=params.near_cap, map_cap=params.map_cap,
            leaf=params.map_leaf, cell_size=params.cell_size,
            density=params.kf_density,
        )
    )(state.kf_poses, state.kf_clouds, state.kf_masks, state.kf_times, state.kf_count,
      new_pose[:, 3:6], now)
    grid = knn.SpatialHashGrid(
        *(torch.where(_bcast(m, new), new, old) for new, old in zip(grid, state.grid))
    )
    state.last_kf_pose.copy_(torch.where(m[:, None], new_pose, state.last_kf_pose))
    return state._replace(grid=grid), new_pose


def resident_step_lanes(
    state: ResidentState,
    hosts: list,
    xyz, rel_t, mask, scan_start,
    dk_times, dk_gyr, dk_mask,
    fu_acc, fu_gyr, fu_dts, fu_mask, fu_times,
    imu_rpy, imu_rpy_ok,
    gps_has: list, gps_enu, gps_sigma,
    do_loop: list,
    ext_has: list, ext_t_cur, ext_t_pre,
    params: ResidentParams,
    tally: Counter,
) -> tuple[ResidentState, list, torch.Tensor]:
    """:func:`resident_step` for B lock-step sessions: the state and every
    tensor input carry a leading [B] axis, ``hosts`` is one HostView per
    lane and the flags are lists of B host bools. Updates ``state`` in
    place; returns (state, hosts, gn_iters [B]).

    The host reads ONE [B] vector where the single-session step reads one
    flag: ``is_kf`` every tick, the loop gate when a lane searches, ``full``
    when a lane's GPS candidate shipped or an ICP ran."""
    fp = params.frame
    dev = state.kf_poses.device
    B = state.kf_poses.shape[0]
    lanes = torch.arange(B, device=dev)

    # --- IMU-rate odometry recording (TransformFusion parity) ---
    ir_R, ir_p = torch.func.vmap(
        lambda st, a, g, d, mk: imu_fusion.predict_poses_parallel(
            st, a, g, d, mk, gravity=fp.fusion.imu.gravity)
    )(state.filt.mean, fu_acc, fu_gyr, fu_dts, fu_mask)
    ir_block = torch.cat(
        [fu_times[..., None], se3.rot_to_euler(ir_R), ir_p, fu_mask[..., None].to(_F32)], dim=-1
    ).to(_F32)
    TI, Wb = state.imu_traj.shape[1], ir_block.shape[1]
    ir_off = torch.clamp(state.imu_count, max=TI - Wb)
    rows = ir_off[:, None] + torch.arange(Wb, dtype=_I64, device=dev)
    state.imu_traj[lanes[:, None], rows] = ir_block
    state.imu_count.copy_(torch.clamp(state.imu_count + torch.sum(fu_mask.to(_I64), dim=-1), max=TI))

    core = frame_core_lanes(
        xyz, rel_t, mask, scan_start, dk_times, dk_gyr, dk_mask,
        fu_acc, fu_gyr, fu_dts, fu_mask,
        state.grid, state.filt, state.last_kf_pose, fp, imu_rpy, imu_rpy_ok,
    )
    state = state._replace(filt=core.filter)
    tally["read:is_kf"] += 1
    is_kf = core.is_kf.tolist()
    now = scan_start

    K = state.kf_poses.shape[1]
    want_loop = [h.pending_loop or dl for h, dl in zip(hosts, do_loop)]
    pending = [
        w and not (kf and min(h.kf_count + 1, K) > 2)
        for w, kf, h in zip(want_loop, is_kf, hosts)
    ]
    state.pending_loop.copy_(_flags(pending, dev))

    out_pose = core.pose
    if any(is_kf):
        desc = torch.func.vmap(scancontext.make_descriptor)(core.deskewed, mask)
        key = scancontext.ring_key(desc)
        state, new_pose = _insert_keyframe_lanes(
            state, params, hosts, is_kf, core.is_kf, core.pose, now, core.ds_xyz,
            core.ds_mask, desc, key, gps_has, gps_enu, gps_sigma, want_loop, ext_has,
            ext_t_cur, ext_t_pre, tally,
        )
        out_pose = torch.where(core.is_kf[:, None], new_pose, core.pose)
    hosts = [
        HostView(min(h.kf_count + 1, K) if kf else h.kf_count, p)
        for h, kf, p in zip(hosts, is_kf, pending)
    ]

    # --- trajectory ring append (layout of resident_step) ---
    T = state.traj.shape[1]
    t_i = torch.clamp(state.traj_count, max=T - 1)
    entry = torch.cat(
        [
            out_pose.to(_F32),
            torch.stack(
                [core.is_kf, core.degenerate, core.converged, core.num_matched], dim=-1
            ).to(_F32),
            (state.kf_count - 1).to(_F32)[:, None],
            state.last_kf_pose.to(_F32),
        ],
        dim=-1,
    )
    state.traj[lanes, t_i] = entry
    state.traj_count.copy_(torch.clamp(state.traj_count + 1, max=T))
    return state, hosts, core.gn_iters


def resident_step_packed_lanes(
    state: ResidentState, hosts: list, bufs: np.ndarray, params: ResidentParams,
    S: int, W: int, tally: Counter,
) -> tuple[ResidentState, list, torch.Tensor]:
    """resident_step_lanes from the B lanes' packed frame buffers ``bufs``
    [B, frame_buf_size]: ONE host->device copy for the tick. ``bufs`` must
    be a fresh array every tick (the copy is asynchronous)."""
    dev = state.kf_poses.device
    buf_d = torch.from_numpy(bufs).to(dev, non_blocking=True)
    args = _unpack_frame(buf_d, bufs, S, W)
    return resident_step_lanes(state, hosts, *args, params=params, tally=tally)


def frame_buf_size(S: int, W: int) -> int:
    """Flat f32 frame-input buffer length for scan capacity S, IMU window W."""
    # xyz 3S + rel S + n_kept 1 (mask is recomputed on device — points are
    # packed compactly, so mask = arange < n_kept; saves S floats of wire)
    # | scan_start 1 | deskew W+3W+W | fusion 3W+3W+W+W+W(times) |
    # rpy 3 + ok 1 | gps 1+3+3 | do_loop 1 | ext loop candidate 1+1+1
    return 4 * S + 14 * W + 17


def _unpack_frame(buf: torch.Tensor, host_buf: np.ndarray, S: int, W: int):
    """Slice the fused frame buffer back into resident_step's inputs: the
    tensors from its device copy ``buf``, the three branch flags from the
    host copy ``host_buf`` (read there, not from the device).

    Stacked lanes (``buf`` [B, L], ``pipeline/multistream.py``) slice the
    same way with a leading [B] axis on every tensor; the flags are then
    one list of B bools each."""
    o = 0
    lead = tuple(buf.shape[:-1])

    def take(n):
        nonlocal o
        v = buf[..., o : o + n]
        o += n
        return v

    def flag():
        nonlocal o
        v = host_buf[..., o] > 0.5
        o += 1
        return v.tolist() if lead else bool(v)

    xyz = take(3 * S).reshape(*lead, S, 3)
    rel_t = take(S)
    n_kept = take(1)[..., 0]
    mask = torch.arange(S, dtype=_F32, device=buf.device) < n_kept[..., None]
    scan_start = take(1)[..., 0]
    dk_times = take(W)
    dk_gyr = take(3 * W).reshape(*lead, W, 3)
    dk_mask = take(W) > 0.5
    fu_acc = take(3 * W).reshape(*lead, W, 3)
    fu_gyr = take(3 * W).reshape(*lead, W, 3)
    fu_dts = take(W)
    fu_mask = take(W) > 0.5
    fu_times = take(W)
    imu_rpy = take(3)
    imu_rpy_ok = take(1)[..., 0] > 0.5
    gps_has = flag()
    gps_enu = take(3)
    gps_sigma = take(3)
    do_loop = flag()
    ext_has = flag()
    ext_t_cur = take(1)[..., 0]
    ext_t_pre = take(1)[..., 0]
    return (
        xyz, rel_t, mask, scan_start, dk_times, dk_gyr, dk_mask,
        fu_acc, fu_gyr, fu_dts, fu_mask, fu_times, imu_rpy, imu_rpy_ok,
        gps_has, gps_enu, gps_sigma, do_loop, ext_has, ext_t_cur, ext_t_pre,
    )


def resident_step_packed(
    state: ResidentState, host: HostView, buf: np.ndarray, params: ResidentParams,
    S: int, W: int, tally: Counter, mesh=None,
) -> tuple[ResidentState, HostView, torch.Tensor]:
    """resident_step with ALL per-frame inputs fused into ONE f32 host
    buffer: one host->device copy per frame instead of 21.

    ``buf`` must be a fresh array for every frame: the copy is asynchronous
    (and on the CPU the tensor aliases the numpy memory), so a buffer reused
    for the next frame could race this one."""
    dev = state.kf_poses.device
    buf_d = torch.from_numpy(buf).to(dev, non_blocking=True)
    args = _unpack_frame(buf_d, buf, S, W)
    return resident_step(state, host, *args, params=params, tally=tally, mesh=mesh)


def make_initial_state(
    cfg: SlamConfig, params: ResidentParams,
    xyz: np.ndarray, rel_t: np.ndarray, mask: np.ndarray, scan_start: float,
    dk_times: np.ndarray, dk_gyr: np.ndarray, dk_mask: np.ndarray,
    init_pose: np.ndarray, device: torch.device,
) -> ResidentState:
    """Host wrapper: uploads the bootstrap frame and builds the state."""

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    return _bootstrap_impl(
        dev(xyz), dev(rel_t), dev(mask), dev(np.float32(scan_start)),
        dev(dk_times), dev(dk_gyr), dev(dk_mask), dev(init_pose, _F32),
        (cfg.kf_capacity, cfg.traj_capacity, cfg.gps_capacity,
         cfg.loop_capacity, cfg.imu_rate_capacity), params,
    )


def _bootstrap_impl(
    xyz, rel_t, mask, scan_start, dk_times, dk_gyr, dk_mask, init_pose,
    caps, params: ResidentParams,
) -> ResidentState:
    K, T, G, L, TI = caps
    fp = params.frame
    C = params.kf_cloud_cap
    dev = xyz.device
    f32 = dict(dtype=_F32, device=dev)
    i64 = dict(dtype=_I64, device=dev)
    b = dict(dtype=torch.bool, device=dev)

    if fp.deskew:
        deskewed = deskew_frame(xyz, rel_t, mask, scan_start, dk_times, dk_gyr, dk_mask)
    else:
        deskewed = xyz
    ds_xyz, ds_mask = voxel_downsample_xyz(deskewed, mask, fp.leaf, fp.scan_cap)
    desc = scancontext.make_descriptor(deskewed, mask)
    key = scancontext.ring_key(desc)
    R0 = se3.euler_to_rot(init_pose[:3])
    filt = imu_fusion.init_filter(R0, init_pose[3:].clone(), fp.fusion)

    kf_poses = torch.zeros((K, 6), **f32)
    kf_poses[0] = init_pose
    kf_times = torch.zeros((K,), **f32)
    kf_times[0] = scan_start
    kfc_xyz, kfc_m = subsample_to_cap(ds_xyz, ds_mask, C)
    kf_clouds = torch.full((K, C, 3), PAD_COORD, **f32)
    kf_clouds[0] = kfc_xyz
    kf_masks = torch.zeros((K, C), **b)
    kf_masks[0] = kfc_m
    sc_descs = torch.zeros((K, 20, 60), **f32)
    sc_descs[0] = desc
    sc_keys = torch.zeros((K, 20), **f32)
    sc_keys[0] = key

    grid = assemble_local_map(
        kf_poses, kf_clouds, kf_masks, kf_times, 1,
        init_pose[3:6], scan_start,
        radius=params.radius, recent_seconds=params.recent_seconds,
        near_cap=params.near_cap, map_cap=params.map_cap,
        leaf=params.map_leaf, cell_size=params.cell_size,
        density=params.kf_density,
    )

    traj = torch.zeros((T, 17), **f32)
    traj[0, :6] = init_pose
    traj[0, 6:11] = torch.tensor([1.0, 0.0, 1.0, 0.0, 0.0], **f32)
    traj[0, 11:] = init_pose
    eye = torch.eye(3, **f32)
    return ResidentState(
        filt=filt,
        last_kf_pose=init_pose.clone(),
        kf_poses=kf_poses,
        kf_times=kf_times,
        kf_clouds=kf_clouds,
        kf_masks=kf_masks,
        kf_count=torch.ones((), **i64),
        sc_descs=sc_descs,
        sc_keys=sc_keys,
        e_Rm=eye.expand(K, 3, 3).clone(),
        e_tm=torch.zeros((K, 3), **f32),
        g_i=torch.zeros((G,), **i64),
        g_t=torch.zeros((G, 3), **f32),
        g_sqrt=torch.ones((G, 3), **f32),
        g_count=torch.zeros((), **i64),
        g_last=torch.full((3,), -1.0e9, **f32),
        g_P=marginal.initial_cov(torch, device=dev),
        l_i=torch.zeros((L,), **i64),
        l_j=torch.zeros((L,), **i64),
        l_Rm=eye.expand(L, 3, 3).clone(),
        l_tm=torch.zeros((L, 3), **f32),
        l_sqrt=torch.ones((L, 6), **f32),
        l_cauchy=torch.zeros((L,), **f32),
        l_count=torch.zeros((), **i64),
        kf_has_loop=torch.zeros((K,), **b),
        prior_R=R0,
        prior_t=init_pose[3:].clone(),
        grid=grid,
        traj=traj,
        traj_count=torch.ones((), **i64),
        imu_traj=torch.zeros((TI, 8), **f32),
        imu_count=torch.zeros((), **i64),
        pending_loop=torch.zeros((), **b),
    )


def _corrected_traj(traj: torch.Tensor, kf_poses: torch.Tensor) -> torch.Tensor:
    """[T, 17] trajectory ring -> [T, 10] with loop-corrected poses.

    Each frame's pose is re-anchored on the CURRENT estimate of the
    keyframe it was tracked against:
        corrected = kf_now[slot] o (kf_then^-1 o pose)
    If no relaxation moved the keyframe since, kf_now == kf_then and this
    is the identity."""
    pose = traj[:, :6]
    slot = torch.clamp(traj[:, 10].to(_I64), 0, kf_poses.shape[0] - 1)
    kf_then = traj[:, 11:17]
    kf_now = kf_poses[slot]
    corrected = se3.pose_compose(kf_now, se3.pose_between(kf_then, pose))
    return torch.cat([corrected.to(_F32), traj[:, 6:10]], dim=1)


def _grown_state(
    st: ResidentState, grow_kf: bool, grow_traj: bool, grow_gps: bool,
    grow_loop: bool, grow_imu: bool = False,
) -> ResidentState:
    """Capacity-doubled copy of ``st`` along the flagged rings."""

    def pad(a, fill=0):
        return torch.cat([a, torch.full_like(a, fill)], dim=0)

    def pad_eye(a):
        eye = torch.eye(3, dtype=a.dtype, device=a.device)
        return torch.cat([a, eye.expand_as(a)], dim=0)

    upd = {}
    if grow_kf:
        upd.update(
            kf_poses=pad(st.kf_poses),
            kf_times=pad(st.kf_times),
            kf_clouds=pad(st.kf_clouds, PAD_COORD),
            kf_masks=pad(st.kf_masks, False),
            sc_descs=pad(st.sc_descs),
            sc_keys=pad(st.sc_keys),
            e_Rm=pad_eye(st.e_Rm),
            e_tm=pad(st.e_tm),
            kf_has_loop=pad(st.kf_has_loop, False),
        )
    if grow_traj:
        upd.update(traj=pad(st.traj))
    if grow_gps:
        upd.update(g_i=pad(st.g_i), g_t=pad(st.g_t), g_sqrt=pad(st.g_sqrt, 1.0))
    if grow_loop:
        upd.update(
            l_i=pad(st.l_i), l_j=pad(st.l_j), l_Rm=pad_eye(st.l_Rm),
            l_tm=pad(st.l_tm), l_sqrt=pad(st.l_sqrt, 1.0),
            l_cauchy=pad(st.l_cauchy),
        )
    if grow_imu:
        upd.update(imu_traj=pad(st.imu_traj))
    return st._replace(**upd)


class ResidentPipeline(LiorfPipeline):
    """Streaming pipeline with the SLAM state on the device (odometry, GPS
    and loop-closure configurations).

    Same input API as LiorfPipeline; per-frame results stay on the device.
    ``process_scan`` returns a stamp-only FrameResult; call
    ``trajectory_arrays()`` / ``save_tum()`` / ``sync_store()`` after the
    run (each triggers the one end-of-run pull). The IMU-rate odometry
    stream is recorded on the device per frame and read back with
    ``imu_rate_trajectory()``; the *live* ``imu_rate_poses`` needs the
    fusion filter on the host, so mid-run it returns empty here (after
    ``sync()`` it works).

    Unlike the JAX package's, which reads nothing from the device per frame,
    this pipeline reads the few branch flags listed in the module docstring;
    ``host_reads()`` counts them by kind. ``device=None`` means ``cuda`` and
    raises when there is none; ``device="cpu"`` runs it on the CPU."""

    def __init__(self, cfg: SlamConfig = SlamConfig(), device=None):
        super().__init__(cfg, resolve_device(device, "ResidentPipeline"))
        self.state: ResidentState | None = None
        self.params = ResidentParams(
            frame=self.frame_params,
            graph_window=cfg.graph_window,
            radius=cfg.surroundingKeyframeSearchRadius,
            kf_density=cfg.surroundingKeyframeDensity,
            near_cap=cfg.near_kf_capacity,
            map_cap=cfg.map_capacity,
            map_leaf=cfg.surroundingKeyframeMapLeafSize,
            cell_size=cfg.grid_cell_size,
            kf_cloud_cap=cfg.kf_cloud_capacity,
            use_gps_elevation=cfg.useGpsElevation,
            pose_cov_threshold=cfg.poseCovThreshold,
            loop_enabled=bool(cfg.loopClosureEnableFlag),
            loop_search_radius=cfg.historyKeyframeSearchRadius,
            loop_time_diff=cfg.historyKeyframeSearchTimeDiff,
            loop_submap_halfwidth=cfg.historyKeyframeSearchNum,
            loop_icp_leaf=cfg.loopClosureICPSurfLeafSize,
            loop_fitness_thresh=cfg.historyKeyframeFitnessScore,
            loop_min_inlier_frac=cfg.loopMinInlierFrac,
            loop_drift_budget=cfg.loopDriftBudget,
            loop_correction_floor=cfg.loopCorrectionFloor,
            kf_spacing=max(cfg.surroundingkeyframeAddingDistThreshold, 0.1),
        )
        self._host = HostView(0, False)
        self._synced = False
        # GC quiesce schedule: after warmup (long-lived object population
        # stable) freeze the object graph so gen-2 collections never pause
        # the stream (utils/gc_control.py); re-armed after ring growth
        self._gc_quiesce_at = 8 if cfg.gc_low_latency else -1
        # exact host-side upper bounds on the device ring counts: the
        # trajectory advances exactly once per processed frame, keyframes at
        # most once per frame, GPS factors at most once per gps-candidate
        # frame, loop factors at most once per do_loop frame. Each
        # (count, at) pair is the last known exact count and the marker it
        # was taken at.
        self._kf_known = (0, 0)  # (count, frame_idx)
        self._g_known = (0, 0)  # (count, gps feeds)
        self._l_known = (0, 0)  # (count, loop flags)
        self._gps_feeds = 0
        self._loop_flags = 0
        self._imu_feeds = 0  # exact IMU-rate ring count (samples shipped)
        # external loop-closure candidates (loopInfoHandler parity: a
        # bounded deque of (t_cur, t_pre) stamp pairs, newest-5 kept;
        # mapOptmization.cpp:530-541)
        self.loop_info_queue: deque = deque(maxlen=5)
        self._ext_pending: list | None = None  # [t_cur, t_pre, frames_left]
        self._loop_tick_pending = False  # manual trigger_loop_search() tick
        self.growth_events = 0  # device-ring doublings this session
        # host reads by kind ("read:is_kf", "read:loop_gate", "read:full",
        # "read:ring_counts") and ICP runs ("icp_runs")
        self.tally: Counter = Counter()
        self._gn_iters = torch.zeros((), dtype=_I64, device=self.device)
        # the native scan packer is built (g++, once per source) here and
        # not at the first frame; without it the numpy packer serves
        native.get_lib()

    def packer(self) -> dict[str, int]:
        """Frames whose scan the native packer packed, and those the numpy
        fallback packed (``native.build_error`` says why it was needed)."""
        return {k[5:]: v for k, v in sorted(self.tally.items()) if k.startswith("pack:")}

    def host_reads(self) -> dict[str, int]:
        """Device->host reads this pipeline made, by kind. The scan matcher
        adds one ``done`` read per GN iteration (``gn_iters_total()``) and
        the ICP one per iteration (K2 launches minus ``tally["icp_runs"]``);
        those are the modules' own and not counted here."""
        return {k[5:]: v for k, v in sorted(self.tally.items()) if k.startswith("read:")}

    def gn_iters_total(self) -> int:
        """GN iterations the scan matcher ran over the session (one read)."""
        return int(self._gn_iters)

    # -- unbounded sessions: device-ring growth -------------------------
    def seed_ring_bounds(self, state: ResidentState, frame_idx: int):
        """Re-seed the host-side ring-count bounds and the host view from a
        restored state (one read).

        Called on checkpoint resume (mapping/export.py:load_checkpoint).
        Lives here, next to ``_maybe_grow_rings``, because the two must
        agree: a stale or missing seed makes the bounds UNDER-estimate the
        device counts and the overflow check silently never fires. Any new
        ring added to ResidentState must be seeded here too."""
        kf, g, l, imu, pending = torch.stack(
            [state.kf_count, state.g_count, state.l_count, state.imu_count,
             state.pending_loop.to(_I64)]
        ).tolist()
        self._kf_known = (kf, frame_idx)
        self._g_known = (g, 0)
        self._l_known = (l, 0)
        self._gps_feeds = 0
        self._loop_flags = 0
        # the IMU-rate ring count is tracked exactly on the host (the
        # device advances it by the number of masked samples shipped)
        self._imu_feeds = imu
        self._host = HostView(kf, bool(pending))

    def _maybe_grow_rings(self):
        """Grow any device ring whose host-side count bound nears capacity
        (the reference's graph and keyframe stores grow unboundedly;
        fixed-shape rings must double).

        The trajectory and IMU-rate rings grow on exact host counts. For
        the other rings a count check is ONE small device->host read, taken
        only when the upper bound (kf <= frames, gps <= gps feeds, loops <=
        loop-cadence frames) says overflow is possible; with
        ``pull_free_growth`` the rings grow on the bounds without it. The
        bounds are the JAX package's (resident.py:954-1006 there), kept so
        the growth events match, though ``is_kf`` is now read every
        frame."""
        st = self.state
        K, T = st.kf_poses.shape[0], st.traj.shape[0]
        G, L = st.g_i.shape[0], st.l_i.shape[0]
        TI = st.imu_traj.shape[0]
        m = 2
        grow_traj = self.frame_idx >= T - m  # exact, no read needed
        # the IMU ring must keep a full window W of writable tail
        grow_imu = self._imu_feeds >= TI - (m + 2) * self.cfg.imu_window
        grow_kf = grow_gps = grow_loop = False
        kf_bound = self._kf_known[0] + (self.frame_idx - self._kf_known[1])
        g_bound = self._g_known[0] + (self._gps_feeds - self._g_known[1])
        l_bound = self._l_known[0] + (self._loop_flags - self._l_known[1])
        if kf_bound >= K - m or g_bound >= G - m or l_bound >= L - m:
            if self.cfg.pull_free_growth:
                # grow on the (pessimistic) host bounds without reading the
                # exact counts: rings sized by the bound (kf ring O(frames)
                # instead of O(keyframes)) — memory for no read
                grow_kf = kf_bound >= K - m
                grow_gps = g_bound >= G - m
                grow_loop = l_bound >= L - m
            else:
                self.tally["read:ring_counts"] += 1
                kf_n, g_n, l_n = torch.stack([st.kf_count, st.g_count, st.l_count]).tolist()
                self._kf_known = (kf_n, self.frame_idx)
                self._g_known = (g_n, self._gps_feeds)
                self._l_known = (l_n, self._loop_flags)
                grow_kf = kf_n >= K - m
                grow_gps = g_n >= G - m
                grow_loop = l_n >= L - m
        if grow_kf or grow_traj or grow_gps or grow_loop or grow_imu:
            self._grow_rings(grow_kf, grow_traj, grow_gps, grow_loop, grow_imu)

    def _grow_rings(self, grow_kf, grow_traj, grow_gps, grow_loop, grow_imu=False):
        self.state = _grown_state(
            self.state, grow_kf, grow_traj, grow_gps, grow_loop, grow_imu
        )
        self.growth_events += 1
        if self.cfg.gc_low_latency:
            self._gc_quiesce_at = self.frame_idx + 4
        logging.getLogger("liorf_tpu_torch").warning(
            "device rings grown (kf=%s traj=%s gps=%s loop=%s imu=%s) -> "
            "kf_capacity=%d. Set capacities in SlamConfig upfront to avoid "
            "the copy.",
            grow_kf, grow_traj, grow_gps, grow_loop, grow_imu,
            self.state.kf_poses.shape[0],
        )

    # -- per-frame ----------------------------------------------------
    def process_scan(self, scan) -> FrameResult:
        cfg = self.cfg
        t0, t1 = scan.stamp, scan.end_time
        if (
            cfg.mappingProcessInterval > 0.0
            and self.last_scan_stamp is not None
            and t0 - self.last_scan_stamp < cfg.mappingProcessInterval
        ):
            # mapping throttle (mapOptmization.cpp:254-255)
            return FrameResult(
                stamp=t0, pose=None, degenerate=False,
                is_keyframe=False, num_matched=0,
            )
        if self.state is not None:
            self._maybe_grow_rings()
        if self.frame_idx == self._gc_quiesce_at:
            from ..utils.gc_control import quiesce

            quiesce()
        base = self._time_base(t0)
        dk_t, _, dk_gyr, _, dk_m, _ = self._imu_window(
            t0 - 0.01, t1 + 0.01, cfg.imu_window
        )
        scan_start = np.float32(t0 - base)
        imu_rpy, imu_rpy_ok = self._attitude_at(t0)
        rpy_np = (
            np.asarray(imu_rpy, np.float32) if imu_rpy_ok else np.zeros(3, np.float32)
        )
        if self.state is None:
            xyz, rts, msk = self._pack_scan(scan)
            init_pose = self.last_pose.copy()
            if imu_rpy_ok:
                init_pose[0] = imu_rpy[0]
                init_pose[1] = imu_rpy[1]
                init_pose[2] = imu_rpy[2] if cfg.useImuHeadingInitialization else 0.0
            self.state = make_initial_state(
                cfg, self.params, xyz, rts, msk, float(scan_start),
                dk_t, dk_gyr, dk_m, init_pose.astype(np.float32), self.device,
            )
            self._host = HostView(1, False)
        else:
            fu_t, fu_acc, fu_gyr, fu_dts, fu_m, fu_n = self._imu_window(
                self.last_scan_stamp, t0, cfg.imu_window
            )
            self._imu_feeds += fu_n  # exact IMU-rate ring advance
            gps_has, gps_enu, gps_sigma = self._gps_candidate(t0)
            do_loop = self.cfg.loopClosureEnableFlag and (
                self.frame_idx % self.loop_every_frames == 0
                or self._loop_tick_pending
            )
            self._loop_tick_pending = False
            ext_has, ext_tc, ext_tp = (
                self._ext_loop_candidate(base)
                if self.cfg.loopClosureEnableFlag
                else (False, 0.0, 0.0)
            )
            # exact host-side ring-count bounds (see _maybe_grow_rings);
            # an external candidate can add a loop factor off-cadence
            self._gps_feeds += int(gps_has)
            self._loop_flags += int(do_loop or ext_has)
            # every per-frame input in ONE fresh host buffer -> ONE copy
            S, W = cfg.raw_cap, cfg.imu_window
            buf = np.empty(frame_buf_size(S, W), np.float32)
            # the scan packed in place by the native one-pass filter (g++,
            # native/), or by the numpy compaction when the library is
            # unavailable: kept points first either way, so the device
            # rebuilds the mask as arange(S) < n_kept
            n_total = native.pack_scan_into(
                scan.xyz, scan.rel_time, scan.ring,
                cfg.lidarMinRange**2, cfg.lidarMaxRange**2,
                cfg.downsampleRate, cfg.point_filter_num,
                buf[: 3 * S].reshape(S, 3), buf[3 * S : 4 * S],
                None,  # mask derived on device from the kept count
            )
            if n_total < 0:
                self.tally["pack:numpy"] += 1
                xyz, rts, msk = self._pack_scan(scan)
                buf[: 3 * S] = xyz.ravel()
                buf[3 * S : 4 * S] = rts
                n_kept = int(msk.sum())
            else:
                self.tally["pack:native"] += 1
                n_kept = min(n_total, S)
                if n_total > S:
                    self._warn_truncated(n_total, S)
            o = 4 * S

            def put(a, n):
                nonlocal o
                buf[o : o + n] = a
                o += n

            put(float(n_kept), 1)
            put(scan_start, 1)
            put(dk_t, W)
            put(dk_gyr.ravel(), 3 * W)
            put(dk_m, W)
            put(fu_acc.ravel(), 3 * W)
            put(fu_gyr.ravel(), 3 * W)
            put(fu_dts, W)
            put(fu_m, W)
            put(fu_t, W)
            put(rpy_np, 3)
            put(float(imu_rpy_ok), 1)
            put(float(gps_has), 1)
            put(gps_enu, 3)
            put(gps_sigma, 3)
            put(float(do_loop), 1)
            put(float(ext_has), 1)
            put(ext_tc, 1)
            put(ext_tp, 1)
            # the layout lives in three places (frame_buf_size, this pack
            # sequence, _unpack_frame); a mismatch must fail loudly
            if o != buf.size:
                raise RuntimeError(f"frame buffer layout drift: {o} != {buf.size}")
            self._dispatch_step(buf, S, W)
        self.last_scan_stamp = t0
        self._prune_imu_queue(t0 - 1.0)
        self._stamps = getattr(self, "_stamps", [])
        self._stamps.append(t0)
        self.frame_idx += 1
        self._synced = False
        return FrameResult(
            stamp=t0, pose=None, degenerate=False, is_keyframe=False, num_matched=0
        )

    def _dispatch_step(self, buf: np.ndarray, S: int, W: int):
        """Ship one packed frame to the device step."""
        self.state, self._host, gn_iters = resident_step_packed(
            self.state, self._host, buf, self.params, S, W, self.tally
        )
        self._gn_iters += gn_iters

    def trigger_loop_search(self):
        """Request an RS+SC loop search on the next frame (manual tick).

        Same effect as one beat of the reference's 1 Hz loop thread
        (mapOptmization.cpp:515-542). The tick ships as ``do_loop`` with
        the next frame; if that frame fails the keyframe gate, the
        ``pending_loop`` latch keeps it armed until the next keyframe
        actually consumes it."""
        self._loop_tick_pending = True

    def push_loop_candidate(self, t_cur: float, t_pre: float):
        """Feed an external loop-closure candidate (stamp pair).

        Equivalent of publishing to the reference's loop-info topic
        (``loopInfoHandler``, mapOptmization.cpp:530-541): a third-party
        place-recognition module names two scan times it believes close a
        loop; the pipeline maps them to keyframes, ICP-verifies, and adds
        the factor. Bounded queue, newest 5 kept."""
        self.loop_info_queue.append((float(t_cur), float(t_pre)))

    def _ext_loop_candidate(self, base: float):
        """Current external candidate to ship with this frame (or none).

        The loop branch only runs on keyframe frames, and the host does not
        know before the step whether THIS frame becomes a keyframe — so a
        candidate is resent for a window of frames (at-least-once); the
        ``kf_has_loop`` dedup on the device makes resends idempotent, like
        the reference's loopIndexContainer check
        (mapOptmization.cpp:811-813). The time-gap gate mirrors
        detectLoopClosureExternal (:780-781: pairs closer than
        historyKeyframeSearchTimeDiff are consumed and dropped)."""
        if self._ext_pending is None:
            while self.loop_info_queue:
                t_cur, t_pre = self.loop_info_queue.popleft()
                if abs(t_cur - t_pre) >= self.cfg.historyKeyframeSearchTimeDiff:
                    self._ext_pending = [t_cur, t_pre, 20]  # ~2 s at 10 Hz
                    break
        if self._ext_pending is None:
            return False, 0.0, 0.0
        t_cur, t_pre, left = self._ext_pending
        if left <= 1:
            self._ext_pending = None
        else:
            self._ext_pending[2] = left - 1
        return True, np.float32(t_cur - base), np.float32(t_pre - base)

    def _gps_candidate(self, stamp: float):
        """Host half of addGPSFactor gating — the shared time/cov drain
        (slam.next_aligned_gps); the state-dependent half (spacing,
        elevation) runs on the device (_insert_keyframe)."""
        nxt = next_aligned_gps(self.gps_queue, stamp, self.cfg.gpsCovThreshold)
        if nxt is None:
            return False, np.zeros(3, np.float32), np.ones(3, np.float32)
        enu, cov = nxt
        sig = np.sqrt(np.maximum([cov[0], cov[1], cov[2]], 1.0)).astype(np.float32)
        return True, np.asarray(enu, np.float32), sig

    def block(self):
        """Wait for all enqueued device work (timing barrier); reads
        nothing."""
        if self.state is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def finish(self):
        """End-of-run barrier. The JAX package also joins its growth
        precompile thread here; eager PyTorch compiles nothing, so this is
        ``block()``."""
        self.block()

    # -- end-of-run sync ----------------------------------------------
    def sync(self):
        """ONE batched pull of trajectory + keyframe state into host arrays.

        The per-frame poses are re-anchored on the CURRENT (post-loop/GPS
        relaxation) keyframe poses before the pull — the reference rewrites
        its global path the same way in correctPoses
        (mapOptmization.cpp:1611-1642)."""
        if self._synced or self.state is None:
            return
        st = self.state
        # only the rows written so far (one a processed frame): the readout's
        # batch then does not depend on the ring's capacity, nor its rounding
        T = min(st.traj.shape[0], self.frame_idx)
        packed = torch.cat(
            [
                _corrected_traj(st.traj[:T], st.kf_poses).reshape(-1),
                st.traj_count.to(_F32)[None],
                st.kf_count.to(_F32)[None],
                st.kf_poses.reshape(-1),
                st.kf_times.reshape(-1),
            ]
        ).cpu().numpy()
        K = st.kf_poses.shape[0]
        traj = packed[: T * 10].reshape(T, 10)
        o = T * 10
        n_traj = int(packed[o])
        if n_traj > T:
            raise RuntimeError(f"sync: {n_traj} trajectory rows on the device, {T} frames processed")
        o += 1
        n_kf = int(packed[o])
        o += 1
        kf_poses = packed[o : o + K * 6].reshape(K, 6)
        o += K * 6
        kf_times = packed[o : o + K]

        base = self._time_base_val or 0.0
        self.trajectory = [
            FrameResult(
                stamp=self._stamps[i] if i < len(self._stamps) else base + float(i),
                pose=traj[i, :6].copy(),
                degenerate=bool(traj[i, 7]),
                is_keyframe=bool(traj[i, 6]),
                num_matched=int(traj[i, 9]),
            )
            for i in range(n_traj)
        ]
        # host keyframe store mirror (poses/times only; clouds pulled by
        # sync_store when export needs them)
        self.store.count = n_kf
        while self.store.kf_cap < max(n_kf, 1):
            self.store._grow()
        self.store.poses[:n_kf] = kf_poses[:n_kf]
        self.store.times[:n_kf] = kf_times[:n_kf].astype(np.float64) + base
        # expose the fusion filter (device tensors) for the live IMU-rate
        # prediction and for export
        self.filter = st.filt
        self._synced = True

    def sync_store(self):
        """Additionally pull keyframe clouds + SC database (for map export)."""
        self.sync()
        st = self.state
        n_kf = self.store.count
        clouds = st.kf_clouds[:n_kf].cpu().numpy()
        masks = st.kf_masks[:n_kf].cpu().numpy()
        self.store.clouds[:n_kf, : clouds.shape[1]] = clouds
        self.store.cloud_masks[:n_kf, : masks.shape[1]] = masks
        self.store.sc_descs[:n_kf] = st.sc_descs[:n_kf].cpu().numpy()
        self.store.sc_keys[:n_kf] = st.sc_keys[:n_kf].cpu().numpy()
        self.store.invalidate_device()

    def imu_rate_trajectory(self):
        """The recorded IMU-rate odometry stream (times [N], poses [N, 6]).

        The device ring holds one pose per IMU sample between consecutive
        scans — the reference's ``odometry/imu`` output (TransformFusion o
        imuHandler, imuPreintegration.cpp:23-154,458-506): the latest
        lidar-corrected fused state re-propagated through the IMU queue.
        ONE device read; call after the run."""
        if self.state is None:
            return np.zeros(0), np.zeros((0, 6), np.float32)
        st = self.state
        packed = torch.cat(
            [st.imu_traj.reshape(-1), st.imu_count.to(_F32)[None]]
        ).cpu().numpy()
        TI = st.imu_traj.shape[0]
        n = int(packed[-1])
        block = packed[: TI * 8].reshape(TI, 8)[:n]
        valid = block[:, 7] > 0.5
        base = self._time_base_val or 0.0
        times = block[valid, 0].astype(np.float64) + base
        poses = block[valid, 1:7].astype(np.float32)
        return times, poses

    def trajectory_arrays(self):
        self.sync()
        return super().trajectory_arrays()

    def keyframe_trajectory(self):
        self.sync()
        return super().keyframe_trajectory()


def make_pipeline(cfg: SlamConfig, device=None) -> ResidentPipeline:
    """The device-resident pipeline covers every config — odometry, GPS,
    and loop closure. The classic host-orchestrated ``LiorfPipeline``
    remains for per-frame host access to results. ``device=None`` means
    ``cuda`` and raises when there is none."""
    return ResidentPipeline(cfg, device=device)
