"""Loop-closure detection + ICP verification.

Re-design of the reference's 1 Hz loop thread
(``liorf/src/mapOptmization.cpp:515-726``):

* RS ("radius search") loops: nearest old keyframe within
  ``historyKeyframeSearchRadius`` whose timestamp differs by more than
  ``historyKeyframeSearchTimeDiff`` (:732-765);
* SC (ScanContext) loops: descriptor database query with yaw estimate
  (:624-726, ``Scancontext.cpp:253-344``).

Every candidate is verified with ICP between the current keyframe cloud and
a +-historyKeyframeSearchNum submap (:821-844, voxel 0.5), accepted when
fitness <= historyKeyframeFitnessScore. Verified loops become between
factors: RS with fitness-scaled diagonal noise (:596-620), SC with a
Cauchy-robust constant noise (:711-726).

Geometry note: unlike the reference's SC path (which anchors both clouds at
keyframe 0's pose — an sc-lio-sam quirk), both paths here build submaps in
the world frame of the *current* pose estimates and initialize ICP from the
graph poses (SC additionally applies its yaw estimate), which keeps the
submap geometrically consistent.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import se3np
from ..core.pointcloud import PAD_COORD
from ..core.voxel import voxel_downsample_np
from ..ops import scancontext
from ..ops.icp import ICPParams, icp_point2point


@dataclass
class LoopFactor:
    idx_from: int  # earlier keyframe (j anchor)
    idx_to: int  # current keyframe
    rel_pose: np.ndarray  # [6] rpyxyz: pose of idx_to in idx_from's frame
    sigma: np.ndarray  # [6] noise sigmas
    cauchy: float  # robust kernel scale, 0 = none
    fitness: float
    kind: str  # "rs" | "sc"


def detect_rs_candidate(
    positions: np.ndarray,  # [K, 3] current keyframe positions
    times: np.ndarray,  # [K]
    cur_idx: int,
    search_radius: float,
    time_diff: float,
) -> int | None:
    """detectLoopClosureDistance (mapOptmization.cpp:732-765)."""
    cur = positions[cur_idx]
    d = np.linalg.norm(positions[: cur_idx + 1] - cur, axis=1)
    order = np.argsort(d)
    for i in order:
        if d[i] > search_radius:
            break
        if abs(times[i] - times[cur_idx]) > time_diff:
            return int(i)
    return None


def _submap_world(store, center_idx: int, half_width: int, leaf: float, cap: int):
    """Fuse +-half_width keyframe clouds around center_idx in world frame
    (loopFindNearKeyframes, mapOptmization.cpp:821-844). Entirely host-side:
    the clouds live in the host keyframe store."""
    lo = max(0, center_idx - half_width)
    hi = min(store.count - 1, center_idx + half_width)
    pts = []
    for k in range(lo, hi + 1):
        mask = store.cloud_masks[k]
        cloud = store.clouds[k][mask]
        pose = store.poses[k]
        R = se3np.euler_to_rot(pose[:3])
        pts.append(cloud @ R.T + pose[3:6])
    if not pts:
        return None
    world = np.concatenate(pts).astype(np.float32)
    ds = voxel_downsample_np(world, leaf)[:cap]
    return ds


def verify_loop(
    store,
    cur_idx: int,
    prev_idx: int,
    cfg,
    init_world_pose: np.ndarray | None = None,
    kind: str = "rs",
    cap: int = 16384,
) -> LoopFactor | None:
    """ICP-verify a loop candidate; return the graph factor or None.

    ``cap`` is the padded size of both ICP clouds (hard-wired to 16384 in
    detector.py:99 of the JAX package; a keyword here so a small test can
    run it smaller)."""
    dev = store.device
    cur_sub = _submap_world(store, cur_idx, 0, cfg.loopClosureICPSurfLeafSize, cap)
    prev_sub = _submap_world(
        store, prev_idx, cfg.historyKeyframeSearchNum, cfg.loopClosureICPSurfLeafSize, cap
    )
    if cur_sub is None or prev_sub is None:
        return None
    n_cur = len(cur_sub)
    n_prev = len(prev_sub)
    if n_cur < 300 or n_prev < 1000:  # reference gates (:565)
        return None

    # ICP aligns the world-frame cur cloud onto the prev submap; with an
    # explicit init pose, pre-move the source there first (host-side).
    src = cur_sub
    if init_world_pose is not None:
        cur_pose = store.poses[cur_idx]
        T_delta = se3np.pose_compose(init_world_pose, se3np.pose_inverse(cur_pose))
        src = se3np.pose_apply(T_delta, cur_sub).astype(np.float32)

    def _pad(a, cap_n):
        out = np.full((cap_n, 3), PAD_COORD, np.float32)
        m = np.zeros(cap_n, bool)
        n = min(len(a), cap_n)
        out[:n] = a[:n]
        m[:n] = True
        return out, m

    src_p, src_m = _pad(src, cap)
    tgt_p, tgt_m = _pad(prev_sub, cap)
    res = icp_point2point(
        torch.as_tensor(src_p, device=dev), torch.as_tensor(src_m, device=dev),
        torch.as_tensor(tgt_p, device=dev), torch.as_tensor(tgt_m, device=dev),
        torch.zeros(6, dtype=torch.float32, device=dev),
        ICPParams(
            max_iters=30, max_corr_dist=float(cfg.historyKeyframeSearchRadius * 2)
        ),
    )
    # ONE packed read of (pose, fitness, converged, inlier_frac)
    packed = torch.cat(
        [
            res.pose,
            torch.stack(
                [res.fitness, res.converged.to(torch.float32), res.inlier_frac]
            ),
        ]
    ).cpu().numpy()
    fitness = float(packed[6])
    if packed[7] < 0.5 or fitness > cfg.historyKeyframeFitnessScore:
        return None
    if float(packed[8]) < cfg.loopMinInlierFrac:
        return None

    # corrected world pose of cur: icp_correction o (init or current) pose
    base = init_world_pose if init_world_pose is not None else store.poses[cur_idx]
    corrected = se3np.pose_compose(packed[:6], base)
    # drift-budget consistency: the implied correction must fit inside the
    # odometric drift plausible over the path between the two keyframes
    corr_norm = float(
        np.linalg.norm(corrected[3:] - store.poses[cur_idx][3:])
    )
    budget = cfg.loopCorrectionFloor + cfg.loopDriftBudget * abs(
        cur_idx - prev_idx
    ) * max(cfg.surroundingkeyframeAddingDistThreshold, 0.1)
    if corr_norm > budget:
        return None
    rel = se3np.pose_between(store.poses[prev_idx], corrected).astype(np.float32)
    if kind == "sc":
        sigma = np.full(6, np.sqrt(0.5), np.float32)  # var 0.5 + Cauchy(1) (:714-719)
        cauchy = 1.0
    else:
        sigma = np.full(6, np.sqrt(max(fitness, 1e-4)), np.float32)  # (:607-610)
        cauchy = 0.0
    return LoopFactor(
        idx_from=prev_idx,
        idx_to=cur_idx,
        rel_pose=rel,
        sigma=sigma,
        cauchy=cauchy,
        fitness=fitness,
        kind=kind,
    )


class LoopDetector:
    """Stateful orchestrator of both loop searches (the loop 'thread')."""

    def __init__(self, cfg, icp_cap: int = 16384):
        self.cfg = cfg
        self.icp_cap = icp_cap
        self.loop_index_container: dict[int, int] = {}  # cur -> prev (:53)

    def run(self, store, now: float) -> list[LoopFactor]:
        if store.count < 2 or not self.cfg.loopClosureEnableFlag:
            return []
        out = []
        cur = store.count - 1
        # --- RS loop (performRSLoopClosure, :542-622)
        if cur not in self.loop_index_container:
            prev = detect_rs_candidate(
                store.positions(),
                store.times[: store.count],
                cur,
                self.cfg.historyKeyframeSearchRadius,
                self.cfg.historyKeyframeSearchTimeDiff,
            )
            if prev is not None and prev != cur:
                f = verify_loop(store, cur, prev, self.cfg, kind="rs", cap=self.icp_cap)
                if f is not None:
                    self.loop_index_container[cur] = prev
                    out.append(f)
        # --- SC loop (performSCLoopClosure, :624-726)
        if cur not in self.loop_index_container:
            dev = store.device_arrays()
            det = scancontext.detect_loop(
                dev["sc_descs"],
                dev["sc_keys"],
                store.count,
                dev["sc_descs"][cur],
                dev["sc_keys"][cur],
            )
            # ONE packed read of (index, yaw)
            iy = torch.stack([det.index.to(torch.float32), det.yaw]).cpu().numpy()
            prev = int(iy[0])
            if prev >= 0 and prev != cur:
                yaw = float(iy[1])
                prev_pose = store.poses[prev]
                init = se3np.pose_compose(
                    prev_pose, np.asarray([0, 0, yaw, 0, 0, 0], np.float64)
                )
                f = verify_loop(
                    store, cur, prev, self.cfg, init_world_pose=init, kind="sc",
                    cap=self.icp_cap,
                )
                if f is not None:
                    self.loop_index_container[cur] = prev
                    out.append(f)
        return out
