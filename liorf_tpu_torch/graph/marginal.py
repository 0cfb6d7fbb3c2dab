"""Pose marginal-covariance proxy for the GPS-factor gate.

The reference gates GPS factors on iSAM2's marginal covariance of the
latest pose: factors are only added while ``poseCovariance(3,3)`` or
``(4,4)`` (the x/y translation variances) exceed ``poseCovThreshold``
(``liorf/src/mapOptmization.cpp:1416-1418``), i.e. while the
trajectory is drifting unanchored. That marginal is shaped by three
ingredients of the reference's graph:

- the first-pose prior with variances ``(1e-2, 1e-2, pi^2, 1e8, 1e8,
  1e8)`` — position essentially unanchored (``mapOptmization.cpp:1390``),
- odometry between factors with variances ``(1e-6, 1e-6, 1e-6, 1e-4,
  1e-4, 1e-4)`` per keyframe (``mapOptmization.cpp:1394``), whose *yaw*
  component dominates position uncertainty over distance (rotation
  leverage: a heading error of sigma radians puts sigma*d meters of
  position error d meters down the road),
- GPS factors with clamped variances ``max(noise, 1)`` that collapse the
  x/y marginal back down (``mapOptmization.cpp:1470-1474``).

Instead of maintaining a full graph marginal (which our batched solver
never materializes — it solves, it does not invert), we propagate the
exact (yaw, x, y) sub-marginal of the keyframe chain as a tiny 3x3
recursion: an EKF-style covariance push through each between factor plus
an information update per accepted GPS factor. On a pure chain with
unary position fixes this IS the marginal of the latest pose restricted
to (yaw, x, y); loop closures (which the reference's marginal would also
shrink) are ignored, which only makes the gate *more* willing to accept
GPS — the conservative direction.

Functions are generic over the array namespace (`xp`: numpy for the host
pipeline, torch for the device-resident one) and build matrices with
stack/concatenate only. With torch every constant is built on the device
of the covariance (or of ``device`` for ``initial_cov``), so the resident
step runs them on the card.
"""

from __future__ import annotations

import numpy as np

# Reference noise values (mapOptmization.cpp:1390,1394). The prior
# position variance is clamped from the reference's 1e8 to 1e4: the
# float32 cancellation error of the Kalman update is ~ulp(prior), so the
# clamp keeps the post-fix variance accurate to ~1e-3 on device, while
# 1e4 is still 400x poseCovThreshold — the gate cannot tell them apart.
PRIOR_VAR = (np.pi * np.pi, 1.0e4, 1.0e4)  # (yaw, x, y)
STEP_VAR = (1e-6, 1e-4, 1e-4)
_VAR_CLAMP = 1.0e4


def _f32(xp, values, device=None):
    """float32 constant of namespace ``xp`` (torch: on ``device``, each value
    filled there: a host list uploaded would make the host wait for the card)."""
    if xp is np:
        return np.asarray(values, dtype=np.float32)
    return xp.stack([xp.full((), v, dtype=xp.float32, device=device) for v in values])


def initial_cov(xp=np, device=None):
    """3x3 (yaw, x, y) covariance of the first keyframe prior (torch:
    ``device`` is where it is built)."""
    return xp.diag(_f32(xp, PRIOR_VAR, device))


def propagate(P, yaw, delta_local, xp=np):
    """Push the covariance through one odometry between factor.

    ``yaw`` is the heading of the previous keyframe; ``delta_local`` is
    the (dyaw, dx, dy) step measured in the previous keyframe's frame.
    """
    c, s = xp.cos(yaw), xp.sin(yaw)
    # on the device (and of the dtype) of the heading: numpy takes a float
    one = xp.ones_like(c)
    zero = xp.zeros_like(c)
    # world-frame step (for the rotation-leverage Jacobian d pos / d yaw)
    dxw = c * delta_local[1] - s * delta_local[2]
    dyw = s * delta_local[1] + c * delta_local[2]
    F = xp.stack(
        [
            xp.stack([one, zero, zero]),
            xp.stack([-dyw * one, one, zero]),
            xp.stack([dxw * one, zero, one]),
        ]
    )
    Q = xp.diag(_f32(xp, STEP_VAR, getattr(P, "device", None)))
    P = F @ P @ F.T + Q
    return xp.clip(P, -_VAR_CLAMP, _VAR_CLAMP)


def gps_update(P, var_x, var_y, xp=np):
    """Condition on a GPS position fix with variances (var_x, var_y).

    Kalman form with a closed-form 2x2 innovation inverse (no linear
    solve — exact and cheap).
    """
    # S = H P H^T + V, H = [[0,1,0],[0,0,1]]
    s00 = P[1, 1] + var_x
    s01 = P[1, 2]
    s11 = P[2, 2] + var_y
    det = s00 * s11 - s01 * s01
    i00, i01, i11 = s11 / det, -s01 / det, s00 / det
    PH = xp.stack([P[:, 1], P[:, 2]], axis=1)  # [3,2]
    Sinv = xp.stack([xp.stack([i00, i01]), xp.stack([i01, i11])])
    K = PH @ Sinv  # [3,2]
    HP = xp.stack([P[1, :], P[2, :]])  # [2,3]
    P = P - K @ HP
    return 0.5 * (P + P.T)


def gate_open(P, threshold):
    """True when a GPS factor should be accepted (either x or y marginal
    variance has drifted past ``poseCovThreshold``;
    mapOptmization.cpp:1416-1418 skips only when BOTH are below it)."""
    return (P[1, 1] >= threshold) | (P[2, 2] >= threshold)
