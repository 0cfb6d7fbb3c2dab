"""IMU-aided motion deskew of a LiDAR scan.

Equivalent of the reference front-end
(``liorf/src/imageProjection.cpp:331-565``): forward-Euler integration of
gyro rates over the scan window produces a rotation timeline; every point is
rotated into the scan-start frame by the linearly interpolated rotation at
its own timestamp. Positional deskew is intentionally omitted, matching the
reference (``findPosition`` body is disabled, ``imageProjection.cpp:520-534``).

Everything is batched: the integration is a cumulative sum, the per-point
lookup is a vectorized ``searchsorted`` + lerp, and the rotation apply is a
single batched matmul. The reference treats the integrated gyro angles as
roll/pitch/yaw euler angles (R = Rz Ry Rx); we keep those semantics.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3


class ImuRotationTimeline(NamedTuple):
    """Integrated gyro rotation samples over (a window around) one scan."""

    times: torch.Tensor  # [K] absolute seconds, padded with +inf
    angles: torch.Tensor  # [K, 3] integrated (rotX, rotY, rotZ)
    count: torch.Tensor  # [] int number of valid samples


def integrate_gyro(
    imu_times: torch.Tensor, imu_gyro: torch.Tensor, imu_mask: torch.Tensor
) -> ImuRotationTimeline:
    """Forward-Euler integrate angular rates into cumulative angles.

    Mirrors ``imuDeskewInfo`` (imageProjection.cpp:350-409): angle[0] = 0,
    angle[i] = angle[i-1] + gyro[i] * (t[i] - t[i-1]).
    """
    valid = imu_mask
    # dt[i] = t[i] - t[i-1], 0 for the first valid sample and invalid slots.
    dt = torch.diff(imu_times, prepend=imu_times[:1])
    prev_valid = torch.cat([torch.zeros_like(valid[:1]), valid[:-1]])
    dt = torch.where(valid & prev_valid, dt, 0.0)
    increments = imu_gyro * dt[:, None]
    angles = torch.cumsum(torch.where(valid[:, None], increments, 0.0), dim=0)
    count = torch.sum(valid.to(torch.int64))
    times = torch.where(valid, imu_times, torch.inf)
    return ImuRotationTimeline(times=times, angles=angles, count=count)


def interp_rotation(timeline: ImuRotationTimeline, t: torch.Tensor) -> torch.Tensor:
    """Linearly interpolate integrated angles at times t [N] -> [N, 3].

    Matches ``findRotation`` (imageProjection.cpp:493-518): clamp to the
    last sample when t is beyond the timeline, use the front sample when
    before it. Every clamp of the JAX original (deskew.py:68-73) is kept:
    torch does not clamp an out-of-range gather.
    """
    hi = torch.searchsorted(timeline.times, t.contiguous(), right=True)
    hi = torch.minimum(torch.clamp(hi, min=1), torch.clamp(timeline.count, min=1))
    lo = hi - 1
    # when hi exceeds the valid range, both ends clamp to the last sample
    last = torch.clamp(timeline.count - 1, min=0)
    hi = torch.minimum(hi, last)
    t_lo = timeline.times[lo]
    t_hi = timeline.times[hi]
    denom = torch.where(hi == lo, 1.0, t_hi - t_lo)
    ratio = torch.clamp((t - t_lo) / torch.where(denom == 0, 1.0, denom), 0.0, 1.0)
    a_lo = timeline.angles[lo]
    a_hi = timeline.angles[hi]
    return a_lo + (a_hi - a_lo) * ratio[:, None]


def deskew_scan(
    xyz: torch.Tensor,
    rel_times: torch.Tensor,
    mask: torch.Tensor,
    scan_start_time: torch.Tensor,
    timeline: ImuRotationTimeline,
) -> torch.Tensor:
    """Rotate every point into the scan-start frame.

    xyz: [N, 3] raw sensor-frame points; rel_times: [N] seconds since scan
    start; returns deskewed [N, 3].
    """
    t_abs = scan_start_time + rel_times
    angles = interp_rotation(timeline, t_abs)  # [N, 3] euler rpy
    angles0 = interp_rotation(timeline, scan_start_time.reshape(1))  # [1, 3]
    R_pt = se3.euler_to_rot(angles)  # [N, 3, 3]
    R0 = se3.euler_to_rot(angles0[0])  # [3, 3]
    # p_start = R0^T R_pt p
    rotated = torch.einsum("nij,nj->ni", R_pt, xyz)
    out = rotated @ R0  # == R0^T applied to rows
    return torch.where(mask[:, None], out, xyz)
