"""KITTI raw-dataset reader.

Replaces the reference's offline kitti2bag conversion
(``liorf/config/doc/kitti2bag/kitti2bag.py``): instead of
producing a rosbag, KITTI raw (synced or extract) directories are read
directly into the framework's scan/IMU/GPS streams.

Layout expected (KITTI raw):
  <root>/velodyne_points/data/??????????.bin  (float32 x,y,z,reflectance)
  <root>/velodyne_points/timestamps{,_start,_end}.txt
  <root>/oxts/data/??????????.txt + oxts/timestamps.txt

Ring and per-point relative time are not stored by KITTI; they are
reconstructed the standard way: ring from the elevation angle (HDL-64E has
64 lasers over [-24.8, 2.0] deg), rel-time from the azimuth sweep position
(10 Hz revolution), matching kitti2bag.py:105-140's approach.
"""

from __future__ import annotations

import os
from datetime import datetime

import numpy as np

from .types import GpsFix, ImuSample, LidarScan

_HDL64_ELEV_MIN = np.deg2rad(-24.8)
_HDL64_ELEV_MAX = np.deg2rad(2.0)
_SWEEP_SECONDS = 0.1


def _parse_timestamps(path: str) -> np.ndarray:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            # 2011-09-30 12:40:59.442522880
            dt = datetime.strptime(line[:26], "%Y-%m-%d %H:%M:%S.%f")
            out.append(dt.timestamp())
    return np.asarray(out, np.float64)


def read_velodyne_bin(path: str) -> np.ndarray:
    """[N, 4] float32 (x, y, z, reflectance)."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def scan_from_points(xyz: np.ndarray, intensity: np.ndarray, stamp: float,
                     n_rings: int = 64) -> LidarScan:
    """Reconstruct ring + relative time for a spinning-lidar cloud."""
    r_xy = np.linalg.norm(xyz[:, :2], axis=1)
    elev = np.arctan2(xyz[:, 2], np.maximum(r_xy, 1e-6))
    frac = (elev - _HDL64_ELEV_MIN) / (_HDL64_ELEV_MAX - _HDL64_ELEV_MIN)
    ring = np.clip(np.round(frac * (n_rings - 1)), 0, n_rings - 1).astype(np.int32)

    # KITTI scans start at the rear (-x); azimuth decreases over the sweep
    az = np.arctan2(xyz[:, 1], xyz[:, 0])  # [-pi, pi], 0 = forward
    rel = (np.pi - az) / (2 * np.pi) * _SWEEP_SECONDS
    return LidarScan(
        stamp=float(stamp),
        xyz=xyz.astype(np.float32),
        intensity=intensity.astype(np.float32),
        ring=ring,
        rel_time=rel.astype(np.float64),
    )


# columns of an oxts data line (kitti devkit): lat lon alt roll pitch yaw ...
_OXTS_FIELDS = dict(
    lat=0, lon=1, alt=2, roll=3, pitch=4, yaw=5,
    ax=11, ay=12, az=13, wx=17, wy=18, wz=19,
    pos_accuracy=23,
)


class KittiRawDataset:
    """Iterates scans / imu / gps from a KITTI raw drive directory."""

    def __init__(self, root: str, n_rings: int = 64):
        self.root = root
        self.n_rings = n_rings
        velo = os.path.join(root, "velodyne_points")
        self.scan_times = _parse_timestamps(os.path.join(velo, "timestamps.txt"))
        start_path = os.path.join(velo, "timestamps_start.txt")
        self.scan_start_times = (
            _parse_timestamps(start_path)
            if os.path.exists(start_path)
            else self.scan_times - _SWEEP_SECONDS / 2
        )
        self.scan_files = sorted(
            os.path.join(velo, "data", f)
            for f in os.listdir(os.path.join(velo, "data"))
            if f.endswith(".bin")
        )
        oxts = os.path.join(root, "oxts")
        self.oxts_times = _parse_timestamps(os.path.join(oxts, "timestamps.txt"))
        self.oxts_files = sorted(
            os.path.join(oxts, "data", f)
            for f in os.listdir(os.path.join(oxts, "data"))
            if f.endswith(".txt")
        )

    def __len__(self):
        return len(self.scan_files)

    def scan(self, i: int) -> LidarScan:
        pts = read_velodyne_bin(self.scan_files[i])
        return scan_from_points(
            pts[:, :3], pts[:, 3], self.scan_start_times[i], self.n_rings
        )

    def _oxts_row(self, i: int) -> np.ndarray:
        return np.loadtxt(self.oxts_files[i])

    def imu_stream(self) -> list[ImuSample]:
        """100 Hz OXTS body rates + accelerations (kitti2bag save_imu_data_raw)."""
        out = []
        for i, t in enumerate(self.oxts_times):
            row = self._oxts_row(i)
            f = _OXTS_FIELDS
            out.append(
                ImuSample(
                    stamp=float(t),
                    acc=np.asarray([row[f["ax"]], row[f["ay"]], row[f["az"]]]),
                    gyr=np.asarray([row[f["wx"]], row[f["wy"]], row[f["wz"]]]),
                    quat_wxyz=_rpy_to_quat(row[f["roll"]], row[f["pitch"]], row[f["yaw"]]),
                )
            )
        return out

    def gps_stream(self) -> list[GpsFix]:
        """NavSatFix stream (kitti2bag save_gps_fix_data, 100 Hz)."""
        out = []
        for i, t in enumerate(self.oxts_times):
            row = self._oxts_row(i)
            f = _OXTS_FIELDS
            acc = float(row[f["pos_accuracy"]]) if len(row) > f["pos_accuracy"] else 1.0
            out.append(
                GpsFix(
                    stamp=float(t),
                    lat=float(row[f["lat"]]),
                    lon=float(row[f["lon"]]),
                    alt=float(row[f["alt"]]),
                    cov_xyz=np.full(3, max(acc, 0.1) ** 2),
                )
            )
        return out


def _rpy_to_quat(roll, pitch, yaw) -> np.ndarray:
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    return np.asarray(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ]
    )
