"""Sensor data containers + the 5 point-format adapters.

Replaces the reference's ROS message structs and per-sensor conversion
(``liorf/src/imageProjection.cpp:5-57,216-278``): every supported
sensor (velodyne / ouster / livox / robosense / mulran) is normalized to a
common XYZIRT schema with *relative* per-point time in seconds from scan
start.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class LidarScan:
    """One sweep, normalized: xyz [N,3] f32, intensity [N], ring [N] i32,
    rel_time [N] f64 seconds from scan start, stamp = scan start time."""

    stamp: float
    xyz: np.ndarray
    intensity: np.ndarray
    ring: np.ndarray
    rel_time: np.ndarray

    @property
    def end_time(self) -> float:
        return self.stamp + float(self.rel_time.max()) if len(self.rel_time) else self.stamp


@dataclass
class ImuSample:
    stamp: float
    acc: np.ndarray  # [3] m/s^2 (includes gravity reaction, body frame)
    gyr: np.ndarray  # [3] rad/s
    quat_wxyz: np.ndarray | None = None  # 9-axis attitude, if available


@dataclass
class GpsFix:
    stamp: float
    lat: float
    lon: float
    alt: float
    cov_xyz: np.ndarray = field(default_factory=lambda: np.ones(3))
    status: int = 0  # 0 = fix ok (NavSatFix convention)


# ---------------------------------------------------------------------------
# Point-format adapters (imageProjection.cpp:216-278)
# ---------------------------------------------------------------------------

def from_velodyne(stamp, xyz, intensity, ring, time_rel) -> LidarScan:
    """Velodyne/Livox: time field already relative seconds (:216-218)."""
    return LidarScan(
        stamp=float(stamp),
        xyz=np.asarray(xyz, np.float32),
        intensity=np.asarray(intensity, np.float32),
        ring=np.asarray(ring, np.int32),
        rel_time=np.asarray(time_rel, np.float64),
    )


def from_ouster(stamp, xyz, intensity, ring, t_ns) -> LidarScan:
    """Ouster: per-point t in nanoseconds -> seconds (:220-236)."""
    return LidarScan(
        stamp=float(stamp),
        xyz=np.asarray(xyz, np.float32),
        intensity=np.asarray(intensity, np.float32),
        ring=np.asarray(ring, np.int32),
        rel_time=np.asarray(t_ns, np.float64) * 1e-9,
    )


def from_mulran(stamp, xyz, intensity, ring, t_ns) -> LidarScan:
    """MulRan: ouster-style nanosecond stamps (:238-254)."""
    return from_ouster(stamp, xyz, intensity, ring, t_ns)


def from_robosense(stamp, xyz, intensity, ring, timestamp_abs) -> LidarScan:
    """Robosense: absolute per-point double stamps -> relative (:256-274)."""
    ts = np.asarray(timestamp_abs, np.float64)
    t0 = ts.min() if len(ts) else stamp
    return LidarScan(
        stamp=float(t0),
        xyz=np.asarray(xyz, np.float32),
        intensity=np.asarray(intensity, np.float32),
        ring=np.asarray(ring, np.int32),
        rel_time=ts - t0,
    )


def validate_scan(scan: LidarScan, require_time: bool = True) -> None:
    """Hard validation mirroring cachePointCloud's exits
    (imageProjection.cpp:286-326): NaNs and missing ring/time are errors."""
    if not np.isfinite(scan.xyz).all():
        raise ValueError("Point cloud is not dense (contains NaN/inf points)")
    if scan.ring is None or len(scan.ring) != len(scan.xyz):
        raise ValueError("Point cloud ring channel unavailable")
    if require_time and (scan.rel_time is None or len(scan.rel_time) != len(scan.xyz)):
        raise ValueError("Point cloud timestamp unavailable, deskew impossible")
