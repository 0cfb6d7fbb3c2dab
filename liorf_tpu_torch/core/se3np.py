"""Numpy mirrors of the SE(3) helpers for host-side orchestration math.

The pipeline's bookkeeping (keyframe gating, factor construction, export)
works on single poses; dispatching those to the device as eager tensor ops
costs a launch and a host read each. These tiny 3x3 computations belong on
the host. Semantics match
``core.se3`` exactly (R = Rz Ry Rx, pose = [roll, pitch, yaw, x, y, z]).
"""

from __future__ import annotations

import numpy as np


def euler_to_rot(rpy: np.ndarray) -> np.ndarray:
    rpy = np.asarray(rpy, np.float64)
    roll, pitch, yaw = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    R = np.empty(rpy.shape[:-1] + (3, 3), np.float64)
    R[..., 0, 0] = cy * cp
    R[..., 0, 1] = cy * sp * sr - sy * cr
    R[..., 0, 2] = cy * sp * cr + sy * sr
    R[..., 1, 0] = sy * cp
    R[..., 1, 1] = sy * sp * sr + cy * cr
    R[..., 1, 2] = sy * sp * cr - cy * sr
    R[..., 2, 0] = -sp
    R[..., 2, 1] = cp * sr
    R[..., 2, 2] = cp * cr
    return R


def rot_to_euler(R: np.ndarray) -> np.ndarray:
    R = np.asarray(R, np.float64)
    sp = -np.clip(R[..., 2, 0], -1.0, 1.0)
    pitch = np.arcsin(sp)
    cp = np.sqrt(np.maximum(1.0 - sp * sp, 0.0))
    safe = cp > 1e-6
    roll = np.where(safe, np.arctan2(R[..., 2, 1], R[..., 2, 2]), 0.0)
    yaw = np.where(
        safe,
        np.arctan2(R[..., 1, 0], R[..., 0, 0]),
        np.arctan2(-R[..., 0, 1], R[..., 1, 1]),
    )
    return np.stack([roll, pitch, yaw], axis=-1)


def pose_to_Rt(pose: np.ndarray):
    pose = np.asarray(pose, np.float64)
    return euler_to_rot(pose[..., :3]), pose[..., 3:6]


def pose_compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    Ra, ta = pose_to_Rt(a)
    Rb, tb = pose_to_Rt(b)
    R = Ra @ Rb
    t = (Ra @ tb[..., None])[..., 0] + ta
    return np.concatenate([rot_to_euler(R), t], axis=-1)


def pose_inverse(a: np.ndarray) -> np.ndarray:
    Ra, ta = pose_to_Rt(a)
    Rt = np.swapaxes(Ra, -1, -2)
    return np.concatenate([rot_to_euler(Rt), -(Rt @ ta[..., None])[..., 0]], axis=-1)


def pose_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a^-1 b."""
    return pose_compose(pose_inverse(a), b)


def pose_apply(pose: np.ndarray, pts: np.ndarray) -> np.ndarray:
    R, t = pose_to_Rt(pose)
    return np.asarray(pts, np.float64) @ np.swapaxes(R, -1, -2) + t


def rot_to_quat_wxyz(R: np.ndarray) -> np.ndarray:
    """Batch-safe rotation -> (w,x,y,z), via the max-trace construction."""
    R = np.asarray(R, np.float64)
    single = R.ndim == 2
    Rb = R[None] if single else R.reshape(-1, 3, 3)
    out = np.zeros((len(Rb), 4))
    for i, m in enumerate(Rb):
        tr = np.trace(m)
        if tr > 0:
            s = np.sqrt(tr + 1.0) * 2
            out[i] = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
        elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
            s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
            out[i] = [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s]
        elif m[1, 1] > m[2, 2]:
            s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
            out[i] = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s, (m[1, 2] + m[2, 1]) / s]
        else:
            s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
            out[i] = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s, 0.25 * s]
        if out[i, 0] < 0:
            out[i] = -out[i]
    out /= np.linalg.norm(out, axis=1, keepdims=True)
    return out[0] if single else out.reshape(R.shape[:-2] + (4,))


def quat_wxyz_to_rot(q: np.ndarray) -> np.ndarray:
    """(…,4) unit quaternion (w,x,y,z) -> (…,3,3) rotation matrix (batched)."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3))
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def so3_log(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle vector (host-side; matches se3.so3_log).

    Dataset generators and host bookkeeping use this one, not the device
    version: an eager device call plus a result read per pose is wasted.
    """
    R = np.asarray(R, np.float64)
    tr = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(tr)
    if theta < 1e-7:
        return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2.0
    if np.pi - theta < 1e-5:
        # near pi: use the symmetric part to recover the axis
        A = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.maximum(np.diag(A), 0.0))
        # fix signs from off-diagonals
        if axis[0] > 0:
            axis[1] = np.sign(A[0, 1]) * abs(axis[1])
            axis[2] = np.sign(A[0, 2]) * abs(axis[2])
        elif axis[1] > 0:
            axis[2] = np.sign(A[1, 2]) * abs(axis[2])
        n = np.linalg.norm(axis)
        if n > 0:
            axis = axis / n
        return axis * theta
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return w * theta / (2.0 * np.sin(theta))
