"""Synthetic LiDAR+IMU+GPS dataset generator.

Drives the end-to-end tests and the benchmark without external datasets: a
structured world (building facades + ground) is ray-sampled from a moving
vehicle; IMU samples are derived analytically from the trajectory; GPS
fixes are synthesized from ground-truth positions. The scan sweep model
matches the common 10 Hz spinning lidar: each point carries a relative
timestamp across the 0.1 s revolution and the vehicle moves during it
(so deskew is actually exercised).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import se3np
from .types import GpsFix, ImuSample, LidarScan


@dataclass
class SyntheticConfig:
    n_frames: int = 60
    scan_hz: float = 10.0
    imu_hz: float = 100.0
    n_rings: int = 16
    points_per_ring: int = 360
    max_range: float = 60.0
    speed: float = 4.0  # m/s along the path
    yaw_rate: float = 0.12  # rad/s — gentle arc
    gyro_bias: tuple = (0.002, -0.001, 0.003)
    accel_noise: float = 0.02
    gyro_noise: float = 0.002
    gps_hz: float = 1.0
    gps_noise: float = 0.5
    seed: int = 0
    # world geometry: "city" (facades + ground, feature-rich) or
    # "corridor" (ground + two parallel side walls only — every surface
    # normal is orthogonal to the travel axis, so scan-to-map registration
    # is rank-deficient along x and MUST trip the eigenvalue degeneracy
    # projection, mapOptmization.cpp:1242-1271 semantics)
    world: str = "city"


def _corridor_surfaces(length: float):
    """Feature-poor corridor: ground + two parallel walls along x.

    No surface constrains translation along the corridor axis — the
    degenerate geometry the reference's LMOptimization eigenvalue test
    exists for (mapOptmization.cpp:1242-1263)."""
    ex = length / 2 + 40.0
    cx = length / 2
    up = np.array([0.0, 0, 1])
    x_dir = np.array([1.0, 0, 0])
    return [
        (np.array([cx, 0.0, 0.0]), up, ex, 12.0, x_dir, np.array([0.0, 1, 0])),
        (np.array([cx, 3.5, 2.5]), np.array([0.0, -1, 0]), ex, 2.5, x_dir, up),
        (np.array([cx, -3.5, 2.5]), np.array([0.0, 1, 0]), ex, 2.5, x_dir, up),
    ]


def _world_surfaces(rng):
    """Random 'city block' world: ground + axis-aligned building walls.

    Returns a list of (point_on_plane, normal, half_extent_u, half_extent_v,
    u_dir, v_dir).
    """
    surfaces = []
    # ground plane z=0
    surfaces.append(
        (np.zeros(3), np.array([0.0, 0, 1]), 200.0, 200.0,
         np.array([1.0, 0, 0]), np.array([0.0, 1, 0]))
    )
    # buildings along the path
    for _ in range(40):
        cx, cy = rng.uniform(-80, 120), rng.uniform(-60, 60)
        w, h = rng.uniform(5, 15), rng.uniform(4, 12)
        if abs(cy) < 6.0:
            cy += np.sign(cy or 1.0) * 8.0  # keep the road clear
        for nrm, off in [
            (np.array([1.0, 0, 0]), np.array([w, 0, 0])),
            (np.array([-1.0, 0, 0]), np.array([-w, 0, 0])),
            (np.array([0.0, 1, 0]), np.array([0, w, 0])),
            (np.array([0.0, -1, 0]), np.array([0, -w, 0])),
        ]:
            center = np.array([cx, cy, h / 2]) + off
            u = np.cross(nrm, [0, 0, 1.0])
            surfaces.append((center, nrm, w, h / 2, u, np.array([0.0, 0, 1])))
    return surfaces


class SyntheticDataset:
    """Generates streams: scans(), imu(), gps(), plus ground truth."""

    def __init__(self, cfg: SyntheticConfig = SyntheticConfig()):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        if cfg.world == "corridor":
            path_len = cfg.speed * cfg.n_frames / cfg.scan_hz
            self.surfaces = _corridor_surfaces(path_len)
        else:
            self.surfaces = _world_surfaces(self.rng)
        self._gt_cache = {}

    # ---- trajectory (smooth arc with mild vertical bounce) ----
    def pose_at(self, t: float):
        c = self.cfg
        if t in self._gt_cache:
            return self._gt_cache[t]
        yaw = c.yaw_rate * t
        if abs(c.yaw_rate) > 1e-9:
            x = c.speed / c.yaw_rate * np.sin(yaw)
            y = c.speed / c.yaw_rate * (1 - np.cos(yaw))
        else:
            x, y = c.speed * t, 0.0
        z = 0.05 * np.sin(0.5 * t)
        roll = 0.01 * np.sin(0.8 * t)
        pitch = 0.01 * np.cos(0.6 * t)
        cr, sr = np.cos(roll), np.sin(roll)
        cp, sp = np.cos(pitch), np.sin(pitch)
        cy, sy = np.cos(yaw), np.sin(yaw)
        Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
        Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
        Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
        R = Rz @ Ry @ Rx
        p = np.array([x, y, 1.8 + z])
        self._gt_cache[t] = (R, p)
        return R, p

    def ground_truth(self):
        """[T, 3] positions at scan times."""
        times = np.arange(self.cfg.n_frames) / self.cfg.scan_hz
        return times, np.stack([self.pose_at(t)[1] for t in times])

    # ---- lidar ----
    def _raycast(self, origins, dirs):
        """Min positive ray-plane hit per ray against all surfaces.

        origins: [N, 3] (per-ray, rays may be fired from different poses),
        dirs: [N, 3]. Vectorized over surfaces x rays."""
        best_t = np.full(len(dirs), np.inf)
        for center, nrm, eu, ev, u, v in self.surfaces:
            denom = dirs @ nrm
            numer = (center - origins) @ nrm
            with np.errstate(divide="ignore", invalid="ignore"):
                t = numer / denom
                hit = dirs * t[:, None] + origins - center
                ok = (
                    (np.abs(denom) > 1e-6)
                    & (t > 0.5)
                    & (t < self.cfg.max_range)
                    & (np.abs(hit @ u) <= eu)
                    & (np.abs(hit @ v) <= ev)
                )
            best_t = np.where(ok & (t < best_t), t, best_t)
        return best_t

    def scan(self, frame: int) -> LidarScan:
        c = self.cfg
        t0 = frame / c.scan_hz
        sweep = 1.0 / c.scan_hz
        n_az = c.points_per_ring
        az = np.linspace(0, 2 * np.pi, n_az, endpoint=False)
        elev = np.deg2rad(np.linspace(-15, 15, c.n_rings))
        az_g, el_g = np.meshgrid(az, elev)  # [rings, n_az]
        ring = np.broadcast_to(np.arange(c.n_rings)[:, None], az_g.shape)
        rel_t = np.broadcast_to((az / (2 * np.pi) * sweep)[None, :], az_g.shape)

        az_f = az_g.ravel()
        el_f = el_g.ravel()
        rel_f = rel_t.ravel()
        ring_f = ring.ravel()

        # each azimuth column is fired at its own time -> its own sensor
        # pose; fully vectorized over all rays of the sweep
        Rs = np.zeros((n_az, 3, 3))
        ps = np.zeros((n_az, 3))
        for a_idx in range(n_az):
            t_fire = t0 + az[a_idx] / (2 * np.pi) * sweep
            Rs[a_idx], ps[a_idx] = self.pose_at(round(t_fire, 6))

        col = np.tile(np.arange(n_az), c.n_rings)  # azimuth column per ray
        d_body = np.stack(
            [
                np.cos(el_f) * np.cos(az_f),
                np.cos(el_f) * np.sin(az_f),
                np.sin(el_f),
            ],
            axis=1,
        )
        R_per = Rs[col]  # [N, 3, 3]
        p_per = ps[col]  # [N, 3]
        d_world = np.einsum("nij,nj->ni", R_per, d_body)
        rng_t = self._raycast(p_per, d_world)
        ok = np.isfinite(rng_t)
        hit_world = p_per + d_world * np.where(ok, rng_t, 1.0)[:, None]
        # express in the firing-time sensor frame (what a lidar measures)
        pts = np.einsum("nij,ni->nj", R_per, hit_world - p_per).astype(np.float32)
        valid = ok

        keep = valid
        return LidarScan(
            stamp=t0,
            xyz=pts[keep],
            intensity=np.ones(keep.sum(), np.float32),
            ring=ring_f[keep].astype(np.int32),
            rel_time=rel_f[keep].astype(np.float64),
        )

    # ---- imu ----
    def imu_stream(self):
        c = self.cfg
        n = int(c.n_frames / c.scan_hz * c.imu_hz) + int(c.imu_hz)
        dt = 1.0 / c.imu_hz
        g_w = np.array([0.0, 0, -9.80511])
        samples = []
        bias = np.asarray(c.gyro_bias)
        for i in range(n):
            t = (i - 2) * dt  # start slightly before the first scan
            R0, p0 = self.pose_at(round(t, 6))
            R1, p1 = self.pose_at(round(t + dt, 6))
            Rm, pm = self.pose_at(round(t + dt / 2, 6))
            # body rates from finite rotation; specific force from acceleration
            # (host-side so3_log: an eager device call per sample would be
            # a launch and a host read each)
            w = se3np.so3_log(R0.T @ R1) / dt
            a_w = (p1 - 2 * pm + p0) / (dt / 2) ** 2
            acc_body = Rm.T @ (a_w - g_w)
            samples.append(
                ImuSample(
                    stamp=t + dt / 2,
                    acc=acc_body + self.rng.normal(scale=c.accel_noise, size=3),
                    gyr=w + bias + self.rng.normal(scale=c.gyro_noise, size=3),
                    quat_wxyz=None,
                )
            )
        return samples

    # ---- gps ----
    def gps_stream(self):
        c = self.cfg
        if c.gps_hz <= 0:
            return []
        fixes = []
        n = int(c.n_frames / c.scan_hz * c.gps_hz)
        # treat ENU == world with a datum at (47N, 8E, 400m)
        lat0, lon0, alt0 = 47.0, 8.0, 400.0
        m_per_deg_lat = 111132.0
        m_per_deg_lon = 111132.0 * np.cos(np.deg2rad(lat0))
        for i in range(n):
            t = i / c.gps_hz
            _, p = self.pose_at(round(t, 6))
            noise = self.rng.normal(scale=c.gps_noise, size=3)
            fixes.append(
                GpsFix(
                    stamp=t,
                    lat=lat0 + (p[1] + noise[1]) / m_per_deg_lat,
                    lon=lon0 + (p[0] + noise[0]) / m_per_deg_lon,
                    alt=alt0 + p[2] + noise[2],
                    cov_xyz=np.full(3, c.gps_noise**2),
                )
            )
        return fixes
