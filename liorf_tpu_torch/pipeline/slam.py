"""The online SLAM pipeline: the reference's three ROS nodes fused into one
host-orchestrated sequence of device stages.

Per-frame flow: one device step (`frame_step`) covers deskew -> downsample
-> IMU-preintegrated initial guess -> scan-to-map GN -> fixed-lag fusion ->
keyframe gate -> ScanContext descriptor; the host only slices queues,
records results, and runs the keyframe back-end (pose-graph solve +
local-map grid rebuild + 1 Hz loop detection). All single-pose bookkeeping
math is host-side numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import logging

import numpy as np
import torch

from ..core import se3np
from ..core.device import resolve_device
from ..core.pointcloud import PAD_COORD
from ..graph import marginal
from ..graph import pose_graph as pg
from ..imu import fusion as imu_fusion
from ..imu import preintegration as preint
from ..loops.detector import LoopDetector, LoopFactor
from ..mapping.keyframes import KeyframeStore, assemble_local_map
from ..ops import knn
from ..ops.scan_match import ScanMatchParams
from ..sensors.types import GpsFix, ImuSample, LidarScan
from .config import SlamConfig
from .frame_step import (
    FrameParams,
    bootstrap_step,
    frame_step,
    unpack_kf_payload,
    unpack_summary,
)
from ..core.geodesy import LocalCartesian


def _quat_mul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamilton product of (w,x,y,z) quaternions (host-side)."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.asarray(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


@dataclass
class FrameResult:
    stamp: float
    pose: np.ndarray  # [6] rpyxyz
    degenerate: bool
    is_keyframe: bool
    num_matched: int
    gn_iters: int = 0  # GN iterations the scan matcher ran on this frame


def next_aligned_gps(gps_queue: list, stamp: float, cov_thresh: float):
    """Drain ``gps_queue`` (sorted (ts, enu, cov) triples) for the first
    candidate within +-0.2 s of ``stamp`` that passes the covariance and
    zero-fix gates — the host-side half of addGPSFactor
    (mapOptmization.cpp:1425-1448). Pops consumed entries in place.
    Returns (enu, cov) or None."""
    while gps_queue:
        ts, enu, cov = gps_queue[0]
        if ts < stamp - 0.2:
            gps_queue.pop(0)
            continue
        if ts > stamp + 0.2:
            return None
        gps_queue.pop(0)
        if cov[0] > cov_thresh or cov[1] > cov_thresh:
            continue
        if abs(enu[0]) < 1e-6 and abs(enu[1]) < 1e-6:
            continue
        return enu, cov
    return None


class LiorfPipeline:
    """Streaming API: push IMU/GPS, process scans, read trajectory/map.

    The host-orchestrated pipeline: per-frame ``FrameResult`` poses are
    as-tracked; only keyframe poses are rewritten on graph relaxation.

    ``device=None`` means ``cuda`` and raises when there is no CUDA device;
    pass ``device="cpu"`` to run on the CPU (where the k-NN kernels' plain
    versions are used)."""

    def __init__(self, cfg: SlamConfig = SlamConfig(), device=None):
        self.device = resolve_device(device, "LiorfPipeline")
        self.cfg = cfg
        self.store = KeyframeStore(
            cloud_capacity=cfg.kf_cloud_capacity, initial_kf_capacity=256,
            device=self.device,
        )
        self.loop_detector = LoopDetector(cfg)
        self.gps_conv = LocalCartesian()

        self.imu_queue: list[ImuSample] = []
        self.gps_queue: list[tuple] = []
        self.pending_loops: list[LoopFactor] = []

        self.edges: list[dict] = []
        self.gps_factors: list[dict] = []

        fusion_params = imu_fusion.FusionParams(
            imu=preint.ImuParams(
                acc_noise=cfg.imuAccNoise,
                gyr_noise=cfg.imuGyrNoise,
                acc_bias_rw=cfg.imuAccBiasN,
                gyr_bias_rw=cfg.imuGyrBiasN,
                gravity=cfg.imuGravity,
            )
        )
        self.frame_params = FrameParams(
            leaf=cfg.mappingSurfLeafSize,
            scan_cap=cfg.scan_capacity,
            # candidate budget sized so voxel-leaf-downsampled planar cells
            # can never truncate true nearest neighbors (ops/knn.exact_bucket)
            match=ScanMatchParams(
                knn_bucket=knn.exact_bucket(
                    cfg.grid_cell_size, cfg.surroundingKeyframeMapLeafSize
                )
            ),
            fusion=fusion_params,
            z_tol=cfg.z_tollerance,
            rot_tol=cfg.rotation_tollerance,
            kf_dist=cfg.surroundingkeyframeAddingDistThreshold,
            kf_angle=cfg.surroundingkeyframeAddingAngleThreshold,
            imu_rpy_weight=cfg.imuRPYWeight if cfg.imuType == 1 else 0.0,
            deskew=bool(cfg.deskewEnabled),
        )
        self.filter: imu_fusion.FusionFilter | None = None
        self.grid = None
        self.last_pose = np.zeros(6, np.float32)
        self.last_scan_stamp: float | None = None
        self.trajectory: list[FrameResult] = []
        self.frame_idx = 0
        self.loop_every_frames = max(
            1, int(round(10.0 / max(cfg.loopClosureFrequency, 0.1)))
        )
        self.last_gps_xyz = None
        # (yaw, x, y) marginal covariance of the latest keyframe — the
        # reference's poseCovThreshold GPS gate input (see graph/marginal.py)
        self.pose_cov = marginal.initial_cov(np).astype(np.float64)
        self._ext_rot = cfg.ext_rot
        self._ext_rpy_quat = se3np.rot_to_quat_wxyz(cfg.ext_rpy)
        self._time_base_val: float | None = None

    def _dev(self, a, dtype=None) -> torch.Tensor:
        """Host array / scalar -> tensor on the pipeline's device."""
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    # ------------------------------------------------------------------
    # input streams
    # ------------------------------------------------------------------
    def push_imu(self, s: ImuSample):
        """imuConverter (utility.h:257-290): rotate acc/gyr into the lidar
        frame with extrinsicRot; 9-axis attitude composed with extrinsicRPY."""
        acc_raw = np.asarray(s.acc, np.float64)
        gyr_raw = np.asarray(s.gyr, np.float64)
        if not (np.isfinite(acc_raw).all() and np.isfinite(gyr_raw).all()):
            # drop corrupt samples at the door: one NaN reaching the device
            # poisons preintegration and every downstream state (the
            # reference would integrate it into GTSAM and fail far from the
            # cause); deskew/fusion windows interpolate across the gap
            return
        acc = self._ext_rot @ acc_raw
        gyr = self._ext_rot @ gyr_raw
        quat = s.quat_wxyz
        if self.cfg.imuType == 1 and quat is not None:
            q = np.asarray(quat, np.float64)
            if not np.isfinite(q).all():
                # corrupt attitude: keep the (finite) acc/gyr, drop the quat
                # — a NaN would survive normalization and poison the device
                # roll/pitch slerp
                quat = None
            else:
                quat = _quat_mul_np(q, self._ext_rpy_quat)
                if np.linalg.norm(quat) < 0.1:
                    raise ValueError(
                        "Invalid quaternion, please use a 9-axis IMU!"
                    )
        self.imu_queue.append(ImuSample(s.stamp, acc, gyr, quat))
        if len(self.imu_queue) > 5000:
            self.imu_queue = self.imu_queue[-5000:]

    def _attitude_at(self, t: float):
        """Latest 9-axis attitude rpy at or before t (imuDeskewInfo's
        imuRollInit/..., imageProjection.cpp:371-376)."""
        if self.cfg.imuType != 1:
            return None, False
        best = None
        for s in reversed(self.imu_queue):
            if s.stamp <= t and s.quat_wxyz is not None:
                best = s.quat_wxyz
                break
        if best is None:
            return None, False
        q = np.asarray(best, np.float64)
        q = q / np.linalg.norm(q)
        w, x, y, z = q
        R = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )
        return se3np.rot_to_euler(R), True

    def push_gps(self, fix: GpsFix):
        """gpsHandler (mapOptmization.cpp:277-299): LLA -> local ENU."""
        if fix.status != 0:
            return
        cov = np.asarray(fix.cov_xyz, np.float64)
        if not (
            np.isfinite([fix.lat, fix.lon, fix.alt]).all()
            and np.isfinite(cov).all()
        ):
            # corrupt fix: NaN passes every downstream threshold comparison
            # (NaN > thresh is False) and would land in the pose graph
            return
        enu = self.gps_conv.forward(fix.lat, fix.lon, fix.alt)
        self.gps_queue.append((fix.stamp, np.asarray(enu, np.float64), cov))

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _time_base(self, t: float) -> float:
        if self._time_base_val is None:
            self._time_base_val = float(np.floor(t))
        return self._time_base_val

    def _prune_imu_queue(self, before: float) -> None:
        """Drop consumed IMU samples (stamps < ``before``).

        Every per-frame window starts no earlier than the previous scan
        stamp (fusion window: [last_scan_stamp, t0]; deskew: t0-0.01) and
        ``_attitude_at`` wants the latest sample at/before the scan, so
        with a 1 s reorder/attitude margin nothing older than
        last_scan_stamp - 1 can ever be selected again. Without pruning
        the queue grows to its 5000 cap and ``_imu_window``'s Python
        selection scan costs ~10k comparisons per frame (called twice)."""
        q = self.imu_queue
        cut = 0
        for s in q:
            if s.stamp >= before:
                break
            cut += 1
        if cut:
            del q[:cut]

    def _imu_window(self, t0: float, t1: float, cap: int):
        """Rebased fixed-size arrays of IMU samples in [t0, t1]."""
        base = self._time_base(t0)
        sel = [s for s in self.imu_queue if t0 <= s.stamp <= t1]
        n = min(len(sel), cap)
        times = np.full(cap, np.inf, np.float64)
        acc = np.zeros((cap, 3), np.float32)
        gyr = np.zeros((cap, 3), np.float32)
        mask = np.zeros(cap, bool)
        for i, s in enumerate(sel[:cap]):
            times[i] = s.stamp - base
            acc[i] = s.acc
            gyr[i] = s.gyr
            mask[i] = True
        dts = np.zeros(cap, np.float32)
        if n:
            dts[0] = min(1.0 / self.cfg.imuRate, max(times[0] - (t0 - base), 0.0) + 1e-4)
            if n > 1:
                dts[1:n] = np.diff(times[:n])
        return times.astype(np.float32), acc, gyr, dts, mask, n

    def _warn_truncated(self, n_filtered: int, cap: int) -> None:
        """Dense scans overflowing the raw pack buffer are PREFIX-truncated
        to their lowest rings, which silently wrecks registration — make it
        loud, once per pipeline (set `raw_capacity` to fix)."""
        if getattr(self, "_truncation_warned", False):
            return
        self._truncation_warned = True
        logging.getLogger("liorf_tpu_torch").warning(
            "scan has %d filtered points but raw_capacity=%d: truncating to "
            "the first %d points (lowest rings). Set SlamConfig.raw_capacity "
            ">= the filtered point count to keep the full cloud.",
            n_filtered, cap, cap,
        )

    def _pack_scan(self, scan: LidarScan):
        cfg = self.cfg
        pts_in = scan.xyz
        # squared-range gate (skips the sqrt over the whole cloud); NaN/inf
        # points fail the comparison and are dropped
        d2 = np.einsum("ij,ij->i", pts_in, pts_in)
        with np.errstate(invalid="ignore"):
            keep = (d2 >= cfg.lidarMinRange**2) & (d2 <= cfg.lidarMaxRange**2)
        keep &= np.isfinite(pts_in).all(axis=1)
        if cfg.downsampleRate > 1:
            keep &= (scan.ring % cfg.downsampleRate) == 0
        if cfg.point_filter_num > 1:
            keep &= (np.arange(len(pts_in)) % cfg.point_filter_num) == 0
        idx = np.flatnonzero(keep)
        cap = cfg.raw_cap
        n = min(len(idx), cap)
        if len(idx) > cap:
            self._warn_truncated(len(idx), cap)
        idx = idx[:n]
        xyz = np.full((cap, 3), PAD_COORD, np.float32)
        rts = np.zeros(cap, np.float32)
        msk = np.zeros(cap, bool)
        xyz[:n] = pts_in[idx]
        rts[:n] = scan.rel_time[idx]
        msk[:n] = True
        return xyz, rts, msk

    # ------------------------------------------------------------------
    # the per-frame step
    # ------------------------------------------------------------------
    def process_scan(self, scan: LidarScan) -> FrameResult:
        cfg = self.cfg
        t0 = scan.stamp
        t1 = scan.end_time
        if (
            cfg.mappingProcessInterval > 0.0
            and self.last_scan_stamp is not None
            and t0 - self.last_scan_stamp < cfg.mappingProcessInterval
        ):
            # mapping throttle (mapOptmization.cpp:254-255): clouds arriving
            # faster than the interval are dropped; IMU-rate odometry
            # (imu_rate_poses, the TransformFusion equivalent) covers the gap
            return FrameResult(
                stamp=t0, pose=None, degenerate=False,
                is_keyframe=False, num_matched=0,
            )
        base = self._time_base(t0)
        dev = self._dev

        xyz, rts, msk = (dev(a) for a in self._pack_scan(scan))
        dk_t, _, dk_gyr, _, dk_m, _ = self._imu_window(
            t0 - 0.01, t1 + 0.01, cfg.imu_window
        )
        dk_t, dk_gyr, dk_m = dev(dk_t), dev(dk_gyr), dev(dk_m)
        scan_start = dev(np.float32(t0 - base))

        imu_rpy, imu_rpy_ok = self._attitude_at(t0)

        if self.grid is None or self.filter is None:
            # bootstrap frame (updateInitialGuess first branch,
            # mapOptmization.cpp:906-917): 9-axis attitude seeds roll/pitch,
            # yaw zeroed unless useImuHeadingInitialization
            init_pose = self.last_pose.copy()
            if imu_rpy_ok:
                init_pose[0] = imu_rpy[0]
                init_pose[1] = imu_rpy[1]
                init_pose[2] = imu_rpy[2] if cfg.useImuHeadingInitialization else 0.0
            ds_xyz, ds_mask, desc, key, filt, deskewed, payload = bootstrap_step(
                xyz, rts, msk, scan_start, dk_t, dk_gyr, dk_m,
                dev(init_pose, torch.float32), self.frame_params,
            )
            self.filter = filt
            pose = init_pose
            degenerate, converged, num_matched = False, True, 0
            is_kf = True
            gn_iters = 0
            out_kf = payload
        else:
            _, fu_acc, fu_gyr, fu_dts, fu_m, _ = self._imu_window(
                self.last_scan_stamp, t0, cfg.imu_window
            )
            rpy_arg = (
                dev(imu_rpy if imu_rpy_ok else np.zeros(3), torch.float32)
            ) if self.cfg.imuType == 1 else None
            ok_arg = dev(bool(imu_rpy_ok)) if self.cfg.imuType == 1 else None
            out = frame_step(
                xyz, rts, msk, scan_start, dk_t, dk_gyr, dk_m,
                dev(fu_acc), dev(fu_gyr), dev(fu_dts), dev(fu_m),
                self.grid, self.filter,
                dev(self.store.poses[self.store.count - 1]),
                self.frame_params, rpy_arg, ok_arg,
            )
            # ONE read for the per-frame scalars (packed on the device)
            s = unpack_summary(out.summary)
            gn_iters = s["gn_iters"]
            pose = s["pose"]
            degenerate = s["degenerate"]
            converged = s["converged"]
            is_kf = s["is_kf"]
            num_matched = s["num_matched"]
            self.filter = out.filter
            out_kf = out.kf_payload

        if is_kf:
            self._add_keyframe(pose, t0, out_kf)

        self.last_pose = pose
        self.last_scan_stamp = t0
        self._prune_imu_queue(t0 - 1.0)
        result = FrameResult(
            stamp=t0, pose=pose.copy(), degenerate=degenerate,
            is_keyframe=is_kf, num_matched=num_matched, gn_iters=gn_iters,
        )
        self.trajectory.append(result)
        self.frame_idx += 1

        if (
            cfg.loopClosureEnableFlag
            and self.frame_idx % self.loop_every_frames == 0
            and self.store.count > 2
        ):
            self.pending_loops.extend(self.loop_detector.run(self.store, t0))
        return result

    # ------------------------------------------------------------------
    # keyframe back-end
    # ------------------------------------------------------------------
    def _add_keyframe(self, pose, stamp, payload):
        # ONE read of the packed keyframe payload (only on keyframe events)
        ds_xyz_np, ds_mask_np, desc_np, key_np = unpack_kf_payload(
            payload, self.cfg.scan_capacity
        )
        new_idx = self.store.append(
            pose, stamp, ds_xyz_np, ds_mask_np, desc_np, key_np
        )

        loop_or_gps = False
        if new_idx > 0:
            prev_pose = self.store.poses[new_idx - 1]
            rel = se3np.pose_between(prev_pose, pose).astype(np.float32)
            self.edges.append(
                dict(
                    i=new_idx - 1, j=new_idx, rel=rel,
                    sigma=np.asarray([1e-3] * 3 + [1e-2] * 3, np.float32),
                    cauchy=0.0,
                )
            )
            self.pose_cov = marginal.propagate(
                self.pose_cov, float(prev_pose[2]),
                np.asarray([rel[2], rel[3], rel[4]], np.float64), np,
            )

        loop_or_gps |= self._maybe_add_gps_factor(new_idx, stamp, pose)

        if self.pending_loops:
            for f in self.pending_loops:
                self.edges.append(
                    dict(i=f.idx_from, j=f.idx_to, rel=f.rel_pose,
                         sigma=f.sigma, cauchy=f.cauchy)
                )
            self.pending_loops.clear()
            loop_or_gps = True

        if new_idx > 0:
            self._solve_graph(full=loop_or_gps)
            pose[:] = self.store.poses[new_idx]

        self._rebuild_grid(pose, stamp)

    def _maybe_add_gps_factor(self, new_idx, stamp, pose) -> bool:
        """addGPSFactor gating (mapOptmization.cpp:1402-1480): +-0.2 s time
        alignment, covariance gates, elevation override, >=5 m spacing, and
        the >=5 m trajectory-extent settle gate (:1408-1414). The
        poseCovThreshold gate (:1416-1418) reads the propagated chain
        marginal (graph/marginal.py) in place of iSAM2's. The time/cov
        drain is next_aligned_gps."""
        cfg = self.cfg
        if new_idx > 0 and (
            np.linalg.norm(self.store.poses[0][3:6] - pose[3:6]) < 5.0
        ):
            return False
        if not marginal.gate_open(self.pose_cov, cfg.poseCovThreshold):
            return False
        while True:
            nxt = next_aligned_gps(self.gps_queue, stamp, cfg.gpsCovThreshold)
            if nxt is None:
                break
            enu, cov = nxt
            gx, gy, gz = float(enu[0]), float(enu[1]), float(enu[2])
            nz = float(cov[2])
            if not cfg.useGpsElevation:
                gz = float(pose[5])
                nz = 0.01
            cur = np.array([gx, gy, gz])
            if (
                self.last_gps_xyz is not None
                and np.linalg.norm(cur - self.last_gps_xyz) < 5.0
            ):
                continue
            self.last_gps_xyz = cur
            sig = np.sqrt(np.maximum([cov[0], cov[1], nz], 1.0)).astype(np.float32)
            self.gps_factors.append(dict(i=new_idx, t=cur.astype(np.float32), sigma=sig))
            self.pose_cov = marginal.gps_update(
                self.pose_cov, float(sig[0]) ** 2, float(sig[1]) ** 2, np
            )
            return True
        return False

    def _solve_graph(self, full: bool):
        k = self.store.count
        K = 1 << max(8, int(np.ceil(np.log2(max(k, 2)))))
        E = 1 << max(8, int(np.ceil(np.log2(max(len(self.edges), 2)))))
        G = 1 << max(4, int(np.ceil(np.log2(max(len(self.gps_factors), 2)))))
        g = pg.empty_graph(K, E, G, device=self.device)
        dev = self._dev

        poses = self.store.poses[:k]
        Rs_full = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
        Rs_full[:k] = se3np.euler_to_rot(poses[:, :3]).astype(np.float32)
        ts_full = np.zeros((K, 3), np.float32)
        ts_full[:k] = poses[:, 3:6]

        e_i = np.zeros(E, np.int64)
        e_j = np.zeros(E, np.int64)
        e_Rm = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
        e_tm = np.zeros((E, 3), np.float32)
        e_si = np.ones((E, 6), np.float32)
        e_c = np.zeros(E, np.float32)
        e_m = np.zeros(E, bool)
        for idx, ed in enumerate(self.edges):
            e_i[idx] = ed["i"]
            e_j[idx] = ed["j"]
            e_Rm[idx] = se3np.euler_to_rot(ed["rel"][:3]).astype(np.float32)
            e_tm[idx] = ed["rel"][3:6]
            e_si[idx] = 1.0 / ed["sigma"]
            e_c[idx] = ed["cauchy"]
            e_m[idx] = True

        g_i = np.zeros(G, np.int64)
        g_t = np.zeros((G, 3), np.float32)
        g_si = np.ones((G, 3), np.float32)
        g_m = np.zeros(G, bool)
        for idx, gf in enumerate(self.gps_factors):
            g_i[idx] = gf["i"]
            g_t[idx] = gf["t"]
            g_si[idx] = 1.0 / gf["sigma"]
            g_m[idx] = True

        g = g._replace(
            Rs=dev(Rs_full),
            ts=dev(ts_full),
            node_mask=dev(np.arange(K) < k),
            e_i=dev(e_i),
            e_j=dev(e_j),
            e_Rm=dev(e_Rm),
            e_tm=dev(e_tm),
            e_sqrt_info=dev(e_si),
            e_cauchy=dev(e_c),
            e_mask=dev(e_m),
            g_i=dev(g_i),
            g_t=dev(g_t),
            g_sqrt_info=dev(g_si),
            g_mask=dev(g_m),
            prior_R=dev(Rs_full[0]),
            prior_t=dev(ts_full[0]),
        )
        free_from = 0 if full else max(0, k - self.cfg.graph_window)
        params = (
            pg.SolveParams(gn_iters=6, pcg_iters=96)
            if full
            else pg.SolveParams(gn_iters=3, pcg_iters=32)
        )
        solved = pg.solve(g, free_from=free_from, params=params)
        # ONE read of the solved block (Rs and ts packed together)
        packed = torch.cat(
            [solved.Rs[:k].reshape(-1), solved.ts[:k].reshape(-1)]
        ).cpu().numpy()
        Rs_np = packed[: k * 9].reshape(k, 3, 3)
        ts_np = packed[k * 9 :].reshape(k, 3)
        rpy = se3np.rot_to_euler(Rs_np)
        self.store.update_poses(
            np.concatenate([rpy, ts_np], axis=1).astype(np.float32)
        )

    def _rebuild_grid(self, pose, stamp):
        cfg = self.cfg
        dev = self.store.device_arrays()
        self.grid = assemble_local_map(
            dev["poses"],
            dev["clouds"],
            dev["cloud_masks"],
            self._dev(
                (self.store.times - self._time_base(stamp)).astype(np.float32)
            ),
            self.store.count,
            self._dev(pose[3:6], torch.float32),
            float(np.float32(stamp - self._time_base(stamp))),
            radius=cfg.surroundingKeyframeSearchRadius,
            recent_seconds=10.0,
            near_cap=cfg.near_kf_capacity,
            map_cap=cfg.map_capacity,
            leaf=cfg.surroundingKeyframeMapLeafSize,
            cell_size=cfg.grid_cell_size,
            density=cfg.surroundingKeyframeDensity,
        )

    # ------------------------------------------------------------------
    # outputs
    # ------------------------------------------------------------------
    def trajectory_arrays(self):
        times = np.array([f.stamp for f in self.trajectory])
        poses = np.stack([f.pose for f in self.trajectory])
        return times, poses

    def keyframe_trajectory(self):
        return self.store.times[: self.store.count], self.store.poses[: self.store.count]

    def imu_rate_poses(self, horizon: float = 0.5):
        """IMU-rate odometry since the last scan correction — the
        TransformFusion/odometry-imu output stream of the reference
        (imuPreintegration.cpp:23-154,458-506): the fused filter state
        propagated through the queued IMU samples.

        Returns (times [K], poses [K, 6] rpyxyz)."""
        if self.filter is None or self.last_scan_stamp is None:
            return np.zeros(0), np.zeros((0, 6), np.float32)
        t0 = self.last_scan_stamp
        times, acc, gyr, dts, mask, n = self._imu_window(
            t0, t0 + horizon, self.cfg.imu_window
        )
        if n == 0:
            return np.zeros(0), np.zeros((0, 6), np.float32)
        dev = self._dev
        Rs, ps = imu_fusion.predict_poses(
            self.filter.mean, dev(acc), dev(gyr), dev(dts), dev(mask),
            gravity=self.cfg.imuGravity,
        )
        Rs = Rs.cpu().numpy()[:n]
        ps = ps.cpu().numpy()[:n]
        rpy = se3np.rot_to_euler(Rs)
        base = self._time_base(t0)
        return (
            np.asarray(times[:n], np.float64) + base,
            np.concatenate([rpy, ps], axis=1).astype(np.float32),
        )

    def save_tum(self, path: str):
        from ..eval.metrics import save_tum

        times, poses = self.trajectory_arrays()
        quats = se3np.rot_to_quat_wxyz(se3np.euler_to_rot(poses[:, :3]))
        save_tum(path, times, poses[:, 3:6], quats)
