"""MulRan dataset reader.

The reference supports MulRan through a dedicated point struct and sensor
mode (``liorf/src/imageProjection.cpp:47-57,238-254``,
``config/mulran.yaml``). MulRan's on-disk layout:

  <root>/sensor_data/Ouster/<stamp_ns>.bin   — float32 x,y,z,intensity
                                               (Ouster OS1-64, 64 rings)
  <root>/sensor_data/xsens_imu.csv           — stamp_ns, qx..qz?, gyro, acc...
  <root>/sensor_data/gps.csv                 — stamp_ns, lat, lon, alt, cov...
  <root>/sensor_data/data_stamp.csv          — stamp_ns, sensor name

Ring/relative-time reconstruction follows the same spinning-lidar model as
the KITTI reader (Ouster OS1-64: elevation span [-16.6, 16.6] deg).
"""

from __future__ import annotations

import csv
import os

import numpy as np

from .kitti import scan_from_points
from .types import GpsFix, ImuSample, LidarScan

_OS1_ELEV_MIN = np.deg2rad(-16.6)
_OS1_ELEV_MAX = np.deg2rad(16.6)


def read_ouster_bin(path: str) -> np.ndarray:
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


class MulranDataset:
    def __init__(self, root: str):
        self.root = root
        sd = os.path.join(root, "sensor_data")
        lidar_dir = os.path.join(sd, "Ouster")
        self.scan_files = sorted(
            os.path.join(lidar_dir, f)
            for f in os.listdir(lidar_dir)
            if f.endswith(".bin")
        )
        self.scan_times = np.asarray(
            [int(os.path.basename(f)[:-4]) * 1e-9 for f in self.scan_files]
        )
        self.imu_csv = os.path.join(sd, "xsens_imu.csv")
        self.gps_csv = os.path.join(sd, "gps.csv")

    def __len__(self):
        return len(self.scan_files)

    def scan(self, i: int) -> LidarScan:
        pts = read_ouster_bin(self.scan_files[i])
        r_xy = np.linalg.norm(pts[:, :2], axis=1)
        elev = np.arctan2(pts[:, 2], np.maximum(r_xy, 1e-6))
        frac = (elev - _OS1_ELEV_MIN) / (_OS1_ELEV_MAX - _OS1_ELEV_MIN)
        ring = np.clip(np.round(frac * 63), 0, 63).astype(np.int32)
        az = np.arctan2(pts[:, 1], pts[:, 0])
        rel = (np.pi - az) / (2 * np.pi) * 0.1
        return LidarScan(
            stamp=float(self.scan_times[i]),
            xyz=pts[:, :3].astype(np.float32),
            intensity=pts[:, 3].astype(np.float32),
            ring=ring,
            rel_time=rel.astype(np.float64),
        )

    def imu_stream(self) -> list[ImuSample]:
        """xsens_imu.csv: stamp, qx,qy,qz,qw, ex,ey,ez, gx,gy,gz, ax,ay,az, ..."""
        out = []
        if not os.path.exists(self.imu_csv):
            return out
        with open(self.imu_csv) as f:
            for row in csv.reader(f):
                if len(row) < 14:
                    continue
                t = int(row[0]) * 1e-9
                qx, qy, qz, qw = (float(v) for v in row[1:5])
                gyr = np.asarray([float(v) for v in row[8:11]])
                acc = np.asarray([float(v) for v in row[11:14]])
                out.append(
                    ImuSample(
                        stamp=t, acc=acc, gyr=gyr,
                        quat_wxyz=np.asarray([qw, qx, qy, qz]),
                    )
                )
        return out

    def gps_stream(self) -> list[GpsFix]:
        """gps.csv: stamp, lat, lon, alt, cov(3x3 row-major)..."""
        out = []
        if not os.path.exists(self.gps_csv):
            return out
        with open(self.gps_csv) as f:
            for row in csv.reader(f):
                if len(row) < 4:
                    continue
                t = int(row[0]) * 1e-9
                cov = (
                    np.asarray([float(row[4]), float(row[8]), float(row[12])])
                    if len(row) >= 13
                    else np.ones(3)
                )
                out.append(
                    GpsFix(
                        stamp=t,
                        lat=float(row[1]),
                        lon=float(row[2]),
                        alt=float(row[3]),
                        cov_xyz=cov,
                    )
                )
        return out
