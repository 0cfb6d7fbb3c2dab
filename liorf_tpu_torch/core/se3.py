"""SO(3)/SE(3) geometry for the LiDAR-inertial SLAM engine (torch tensors).

Conventions (chosen to be interoperable with the reference liorf system):

* Euler angles are intrinsic roll(x)-pitch(y)-yaw(z), composed as
  ``R = Rz(yaw) @ Ry(pitch) @ Rx(roll)`` — the ``pcl::getTransformation``
  convention used throughout the reference
  (``liorf/src/mapOptmization.cpp:1503-1560``,
  ``src/imageProjection.cpp:536-565``).
* Quaternions are ``(w, x, y, z)``.
* A "pose" in vector form is ``[roll, pitch, yaw, x, y, z]`` (rpyxyz), the
  layout of the reference's ``transformTobeMapped``
  (``src/mapOptmization.cpp:1271-1277``).
* Batched: every function accepts arbitrary leading batch dimensions.

All math is plain torch ops on whatever device the inputs live on; dtype
follows the inputs.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-9



# ---------------------------------------------------------------------------
# Elementary rotations / Euler conversions
# ---------------------------------------------------------------------------

def euler_to_rot(rpy: torch.Tensor) -> torch.Tensor:
    """[..., 3] (roll, pitch, yaw) -> [..., 3, 3] with R = Rz @ Ry @ Rx."""
    roll, pitch, yaw = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    # Closed form of Rz(yaw) Ry(pitch) Rx(roll).
    r00 = cy * cp
    r01 = cy * sp * sr - sy * cr
    r02 = cy * sp * cr + sy * sr
    r10 = sy * cp
    r11 = sy * sp * sr + cy * cr
    r12 = sy * sp * cr - cy * sr
    r20 = -sp
    r21 = cp * sr
    r22 = cp * cr
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def rot_to_euler(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3] (roll, pitch, yaw); inverse of euler_to_rot.

    Uses the numerically safe atan2 extraction; at the pitch = +-pi/2 gimbal
    singularity roll is set to 0 and yaw absorbs the remaining rotation.
    """
    sp = -R[..., 2, 0]
    sp = torch.clamp(sp, -1.0, 1.0)
    pitch = torch.asin(sp)
    cp = torch.sqrt(torch.clamp(1.0 - sp * sp, min=0.0))
    safe = cp > 1e-6
    roll = torch.where(
        safe,
        torch.atan2(R[..., 2, 1], R[..., 2, 2]),
        torch.zeros_like(sp),
    )
    yaw = torch.where(
        safe,
        torch.atan2(R[..., 1, 0], R[..., 0, 0]),
        torch.atan2(-R[..., 0, 1], R[..., 1, 1]),
    )
    return torch.stack([roll, pitch, yaw], dim=-1)


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------

def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w,x,y,z) -> [..., 3, 3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4] (w,x,y,z), w >= 0. Shepperd's method, branchless."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate constructions; pick the numerically best per element.
    qw0 = torch.sqrt(torch.clamp(1.0 + tr, min=_EPS)) / 2
    q0 = torch.stack(
        [qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0)],
        dim=-1,
    )
    qx1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=_EPS)) / 2
    q1 = torch.stack(
        [(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1)],
        dim=-1,
    )
    qy2 = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=_EPS)) / 2
    q2 = torch.stack(
        [(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2)],
        dim=-1,
    )
    qz3 = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=_EPS)) / 2
    q3 = torch.stack(
        [(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3],
        dim=-1,
    )

    cond0 = tr > 0
    cond1 = (m00 > m11) & (m00 > m22)
    cond2 = m11 > m22
    q = torch.where(
        cond0[..., None],
        q0,
        torch.where(cond1[..., None], q1, torch.where(cond2[..., None], q2, q3)),
    )
    # canonical sign: w >= 0
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (w,x,y,z) quaternions."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_slerp(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation from a to b by fraction t in [0, 1]."""
    dot = torch.sum(a * b, dim=-1, keepdim=True)
    b = torch.where(dot < 0, -b, b)
    dot = torch.abs(dot)
    dot = torch.clamp(dot, -1.0, 1.0)
    theta = torch.acos(dot)
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-6
    w_a = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) / torch.where(small, 1.0, sin_theta))
    w_b = torch.where(small, t, torch.sin(t * theta) / torch.where(small, 1.0, sin_theta))
    q = w_a * a + w_b * b
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def euler_slerp(rpy_a: torch.Tensor, rpy_b: torch.Tensor, t) -> torch.Tensor:
    """Slerp between two euler attitudes, returning euler angles.

    Mirrors the reference's IMU attitude blending (tf slerp on RPY
    quaternions, ``src/mapOptmization.cpp:1323-1346``).
    """
    qa = rot_to_quat(euler_to_rot(rpy_a))
    qb = rot_to_quat(euler_to_rot(rpy_b))
    return rot_to_euler(quat_to_rot(quat_slerp(qa, qb, t)))


# ---------------------------------------------------------------------------
# so(3) exp/log
# ---------------------------------------------------------------------------

def hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric."""
    zero = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], zero, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] skew -> [..., 3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] rotation vector -> [..., 3, 3]."""
    A, B, _, W = _rodrigues_terms(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + A[..., None] * W + B[..., None] * (W @ W)


def _rodrigues_terms(w: torch.Tensor):
    """sin(t)/t, (1-cos t)/t^2, (t-sin t)/t^3 (with Taylor fallbacks) and
    hat(w). The scalar terms keep a trailing axis of 1 ([..., 1]): under
    ``torch.func.jacfwd`` a 0-dim tensor combined with a Python number gets a
    float64 tangent, so nothing here is ever 0-dim."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    small = theta < 1e-5
    st = torch.where(small, torch.ones_like(theta), theta)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(st) / st)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(st)) / (st * st))
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (st - torch.sin(st)) / (st ** 3))
    return A, B, C, hat(w)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3] rotation vector. Accurate up to theta <= pi.

    theta is recovered from atan2(||skew||, (tr-1)/2), which stays
    well-conditioned near pi (unlike arccos of the trace). Near pi the axis
    is rebuilt from the symmetric part with argmax-based sign recovery.
    Per-rotation scalars keep a trailing axis of 1 (see _rodrigues_terms).
    """
    tr = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2])[..., None]  # [..., 1]
    cos_theta = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    w_skew = vee(R - R.transpose(-1, -2)) / 2.0  # = sin(theta) * axis
    # The sqrt argument is bounded away from 0 on the branch where it is
    # actually used (double-where), as in the JAX original.
    s2 = torch.sum(w_skew * w_skew, dim=-1, keepdim=True)
    small_s = s2 < 1e-12
    one = torch.ones_like(s2)
    sin_theta = torch.where(
        small_s, torch.zeros_like(s2), torch.sqrt(torch.where(small_s, one, s2))
    )
    theta = torch.atan2(sin_theta, cos_theta)

    small = theta < 1e-5
    near_pi = theta > math.pi - 1e-2
    safe_sin = torch.where(sin_theta < _EPS, one, sin_theta)
    # For tiny angles theta ~= sin(theta), so theta^2 ~= s2 and the Taylor
    # scale 1 + theta^2/6 is expressed in s2 (smooth at the identity).
    scale = torch.where(small, 1.0 + s2 / 6.0, theta / safe_sin)
    w_generic = w_skew * scale

    # Near pi: M = (R + R^T)/2 - cos_theta I  ==  (1 - cos_theta) * a a^T.
    B = (R + R.transpose(-1, -2)) / 2.0
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    M = B - cos_theta[..., None] * eye
    diag = torch.stack([M[..., 0, 0], M[..., 1, 1], M[..., 2, 2]], dim=-1)
    axis2 = diag / torch.clamp(1.0 - cos_theta, min=_EPS)
    pos = axis2 > 1e-12
    axis_abs = torch.where(
        pos, torch.sqrt(torch.where(pos, axis2, torch.ones_like(axis2))),
        torch.zeros_like(axis2),
    )
    # Signs: let r = argmax |a_i| (via diag of M). sign(M[r, i]) = sign(a_r a_i)
    # and sign(a_r) = sign(w_skew[r]) (sin > 0 for theta in (0, pi)), so
    # sign(a_i) = sign(M[r, i]) * sign(w_skew[r]).
    r = torch.argmax(diag, dim=-1, keepdim=True)  # [..., 1]
    row_r = torch.gather(M, -2, r[..., None].expand(r.shape + (3,)))[..., 0, :]
    skew_r = torch.gather(w_skew, -1, r)  # [..., 1]
    sign_r = torch.where(skew_r >= 0, one, -one)
    ones3 = torch.ones_like(row_r)
    signs = torch.where(row_r >= 0, ones3, -ones3) * sign_r
    axis = axis_abs * signs
    a2 = torch.sum(axis * axis, dim=-1, keepdim=True)
    a_pos = a2 > 1e-12
    axis = axis / torch.where(a_pos, torch.sqrt(torch.where(a_pos, a2, one)), one)
    w_pi = axis * theta
    return torch.where(near_pi, w_pi, w_generic)


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l of SO(3): so3_exp(w + dw) ~= so3_exp(J_l dw) so3_exp(w)."""
    _, B, C, W = _rodrigues_terms(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + B[..., None] * W + C[..., None] * (W @ W)


def so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of SO(3)."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    small = theta < 1e-5
    st = torch.where(small, torch.ones_like(theta), theta)
    half = st / 2.0
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 / (st * st)) - (torch.cos(half) / (2.0 * st * torch.sin(half))),
    )
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye - 0.5 * W + cot_term[..., None] * (W @ W)


# ---------------------------------------------------------------------------
# SE(3) as (R, t) pairs and rpyxyz pose vectors
# ---------------------------------------------------------------------------

def se3_compose(Ra, ta, Rb, tb):
    """(Ra,ta) o (Rb,tb): first apply b, then a."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_apply(R, t, pts):
    """Transform [..., N, 3] points by (R [...,3,3], t [...,3])."""
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def pose_to_matrix(pose: torch.Tensor) -> torch.Tensor:
    """rpyxyz [..., 6] -> homogeneous [..., 4, 4]."""
    R = euler_to_rot(pose[..., :3])
    t = pose[..., 3:]
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.tensor(
        [0.0, 0.0, 0.0, 1.0], dtype=pose.dtype, device=pose.device
    ).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def matrix_to_pose(T: torch.Tensor) -> torch.Tensor:
    """homogeneous [..., 4, 4] -> rpyxyz [..., 6]."""
    rpy = rot_to_euler(T[..., :3, :3])
    return torch.cat([rpy, T[..., :3, 3]], dim=-1)


def pose_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """rpyxyz composition: returns pose of (A @ B)."""
    Ra, ta = euler_to_rot(a[..., :3]), a[..., 3:]
    Rb, tb = euler_to_rot(b[..., :3]), b[..., 3:]
    R, t = se3_compose(Ra, ta, Rb, tb)
    return torch.cat([rot_to_euler(R), t], dim=-1)


def pose_inverse(a: torch.Tensor) -> torch.Tensor:
    R, t = se3_inverse(euler_to_rot(a[..., :3]), a[..., 3:])
    return torch.cat([rot_to_euler(R), t], dim=-1)


def pose_between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Relative pose a^-1 b (gtsam ``Pose3::between`` semantics)."""
    return pose_compose(pose_inverse(a), b)


def pose_apply(pose: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Transform points [..., N, 3] by rpyxyz pose [..., 6]."""
    return se3_apply(euler_to_rot(pose[..., :3]), pose[..., 3:], pts)


# --- SE(3) tangent-space (for the pose-graph solver) -----------------------
# Tangent layout: [omega (3), v (3)] — rotation first, translation second,
# right-multiplicative update: (R, t) <- (R exp(w), t + R v).


def se3_retract(R, t, xi):
    """Right-multiplicative retraction of tangent xi=[w,v] onto (R, t)."""
    w, v = xi[..., :3], xi[..., 3:]
    dR = so3_exp(w)
    return R @ dR, t + (R @ v[..., None])[..., 0]


def se3_local(Ra, ta, Rb, tb):
    """Inverse of retract: xi such that retract((Ra,ta), xi) == (Rb,tb)."""
    Rt = Ra.transpose(-1, -2)
    w = so3_log(Rt @ Rb)
    v = (Rt @ (tb - ta)[..., None])[..., 0]
    return torch.cat([w, v], dim=-1)
