"""On-manifold IMU preintegration (Forster et al., TRO 2017).

Replacement for GTSAM's ``PreintegratedImuMeasurements`` used by the
reference (``liorf/src/imuPreintegration.cpp:176-177,214-228,359-375``):
Delta-R/v/p accumulation, first-order bias Jacobians, and 9x9 covariance
propagation over a fixed-capacity masked window of IMU samples, in one kernel
call (``ops/preintegrate.py``; no per-sample Python loop on the frame path).

Conventions: gravity acts in -z with magnitude ``imuGravity``
(``MakeSharedU``, imuPreintegration.cpp:213); acc/gyro samples are already
rotated into the lidar-aligned frame (``imuConverter``, utility.h:257-290).
Tangent ordering for the covariance: [dtheta, dv, dp].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3
from ..ops import preintegrate as pre_op


class ImuParams(NamedTuple):
    acc_noise: float = 3.9939570888238808e-03  # continuous sigma [m/s^2/sqrt(Hz)]
    gyr_noise: float = 1.5636343949698187e-03  # [rad/s/sqrt(Hz)]
    acc_bias_rw: float = 6.4356659353532566e-05  # bias random walk sigma
    gyr_bias_rw: float = 3.5640318696367613e-05
    int_noise: float = 1e-4  # integration position noise (imuPreintegration.cpp:216)
    gravity: float = 9.80511


class Preintegrated(NamedTuple):
    dR: torch.Tensor  # [3, 3]
    dv: torch.Tensor  # [3]
    dp: torch.Tensor  # [3]
    dt: torch.Tensor  # [] total time
    # first-order bias Jacobians (linearized at bias_lin)
    dR_dbg: torch.Tensor  # [3, 3]
    dv_dba: torch.Tensor  # [3, 3]
    dv_dbg: torch.Tensor  # [3, 3]
    dp_dba: torch.Tensor  # [3, 3]
    dp_dbg: torch.Tensor  # [3, 3]
    cov: torch.Tensor  # [9, 9] on [dtheta, dv, dp]
    bias_acc_lin: torch.Tensor  # [3] linearization point
    bias_gyr_lin: torch.Tensor  # [3]


def _so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian Jr(w) = Jl(-w)."""
    return se3.so3_left_jacobian(-w)


def prefix_products(mats: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products P[i] = M[0] @ ... @ M[i] of [K, n, n].

    Log-step doubling (Hillis-Steele) in place of
    ``lax.associative_scan(matmul)`` (preintegration.py:94 of the JAX
    package): ceil(log2 K) rounds of one batched matmul each.
    """
    out = mats
    d = 1
    K = mats.shape[0]
    while d < K:
        out = torch.cat([out[:d], out[:-d] @ out[d:]], dim=0)
        d *= 2
    return out


def preintegrate(
    acc: torch.Tensor,  # [K, 3]
    gyr: torch.Tensor,  # [K, 3]
    dts: torch.Tensor,  # [K] per-sample integration interval
    mask: torch.Tensor,  # [K]
    bias_acc: torch.Tensor,  # [3]
    bias_gyr: torch.Tensor,  # [3]
    params: ImuParams,
) -> Preintegrated:
    """Integrate a masked window of IMU samples (log-depth parallel form).

    Preintegration is a monoid: two preintegrated segments A (earlier) and
    B (later) compose as

        dR = dR_A dR_B,  dv = dv_A + dR_A dv_B,
        dp = dp_A + dv_A T_B + dR_A dp_B,  T = T_A + T_B,

    with the first-order bias Jacobians and the covariance recursion
    (e' = A e + n) composing associatively alongside; masked samples are the
    monoid identity. One call of ``ops/preintegrate.py::preintegrate`` (the
    kernel ``csrc/preintegrate.cu`` on the card, its plain version on the
    CPU): each sample's segment, the rotations' prefix and the segments
    composed in order, in tiles of 64 samples. Under ``torch.func.vmap`` the
    lanes are one launch. ``preintegrate.calls`` counts the calls (a vmapped
    call once); ``preintegrate_sequential`` is the oracle."""
    preintegrate.calls += 1
    out = pre_op.preintegrate(
        acc[None], gyr[None], dts[None], mask[None], bias_acc[None], bias_gyr[None],
        params.acc_noise, params.gyr_noise, params.int_noise,
    )
    return Preintegrated(*(o[0] for o in out), bias_acc_lin=bias_acc, bias_gyr_lin=bias_gyr)


preintegrate.calls = 0


def preintegrate_sequential(
    acc: torch.Tensor,  # [K, 3]
    gyr: torch.Tensor,  # [K, 3]
    dts: torch.Tensor,  # [K] per-sample integration interval
    mask: torch.Tensor,  # [K]
    bias_acc: torch.Tensor,  # [3]
    bias_gyr: torch.Tensor,  # [3]
    params: ImuParams,
) -> Preintegrated:
    """Sequential preintegration — the direct transcription of the Forster
    recursions; the oracle for the parallel form (tests only: it loops over
    the samples in Python)."""
    dtype, dev = acc.dtype, acc.device
    eye = torch.eye(3, dtype=dtype, device=dev)

    sg2 = params.gyr_noise**2
    sa2 = params.acc_noise**2
    si2 = params.int_noise**2

    dR = eye
    dv = torch.zeros(3, dtype=dtype, device=dev)
    dp = torch.zeros(3, dtype=dtype, device=dev)
    T = torch.zeros((), dtype=dtype, device=dev)
    dR_dbg = dv_dba = dv_dbg = dp_dba = dp_dbg = torch.zeros((3, 3), dtype=dtype, device=dev)
    cov = torch.zeros((9, 9), dtype=dtype, device=dev)

    for i in range(acc.shape[0]):
        if not bool(mask[i]):
            continue
        a = acc[i] - bias_acc
        w = gyr[i] - bias_gyr
        dt = dts[i]

        dR_inc = se3.so3_exp(w * dt)
        Jr = _so3_right_jacobian(w * dt)
        a_hat = se3.hat(a)
        Ra = dR @ a  # acceleration rotated into the start frame

        # covariance propagation BEFORE state update (uses pre-update dR)
        A = torch.zeros((9, 9), dtype=dtype, device=dev)
        A[0:3, 0:3] = dR_inc.T
        A[3:6, 0:3] = -(dR @ a_hat) * dt
        A[3:6, 3:6] = eye
        A[6:9, 0:3] = -0.5 * (dR @ a_hat) * dt * dt
        A[6:9, 3:6] = eye * dt
        A[6:9, 6:9] = eye
        B = torch.zeros((9, 6), dtype=dtype, device=dev)
        B[0:3, 0:3] = Jr * dt
        B[3:6, 3:6] = dR * dt
        B[6:9, 3:6] = 0.5 * dR * dt * dt
        safe_dt = torch.where(dt > 0, dt, 1.0)
        noise = torch.cat(
            [(sg2 / safe_dt).expand(3), (sa2 / safe_dt).expand(3)]
        ).to(dtype)
        cov_new = A @ cov @ A.T + (B * noise[None, :]) @ B.T
        # si2 * dt (NOT safe_dt): a valid sample with dt == 0 integrates
        # nothing and must inject no noise — parity with the parallel form
        cov_new[6:9, 6:9] += eye * si2 * dt

        # bias Jacobians (Forster eqs. around (70))
        dp_dba_new = dp_dba + dv_dba * dt - 0.5 * dR * dt * dt
        dp_dbg_new = dp_dbg + dv_dbg * dt - 0.5 * (dR @ a_hat) @ dR_dbg * dt * dt
        dv_dba_new = dv_dba - dR * dt
        dv_dbg_new = dv_dbg - (dR @ a_hat) @ dR_dbg * dt
        dR_dbg_new = dR_inc.T @ dR_dbg - Jr * dt

        # state update
        dp = dp + dv * dt + 0.5 * Ra * dt * dt
        dv = dv + Ra * dt
        dR = dR @ dR_inc
        T = T + dt
        dR_dbg, dv_dba, dv_dbg, dp_dba, dp_dbg, cov = (
            dR_dbg_new, dv_dba_new, dv_dbg_new, dp_dba_new, dp_dbg_new, cov_new,
        )

    return Preintegrated(
        dR=dR, dv=dv, dp=dp, dt=T,
        dR_dbg=dR_dbg, dv_dba=dv_dba, dv_dbg=dv_dbg, dp_dba=dp_dba, dp_dbg=dp_dbg,
        cov=cov, bias_acc_lin=bias_acc, bias_gyr_lin=bias_gyr,
    )


class NavState(NamedTuple):
    R: torch.Tensor  # [3, 3] body -> world
    p: torch.Tensor  # [3]
    v: torch.Tensor  # [3]


def bias_corrected_deltas(preint: Preintegrated, bias_acc, bias_gyr):
    """First-order bias-corrected (dR, dv, dp)."""
    dba = bias_acc - preint.bias_acc_lin
    dbg = bias_gyr - preint.bias_gyr_lin
    dR = preint.dR @ se3.so3_exp(preint.dR_dbg @ dbg)
    dv = preint.dv + preint.dv_dba @ dba + preint.dv_dbg @ dbg
    dp = preint.dp + preint.dp_dba @ dba + preint.dp_dbg @ dbg
    return dR, dv, dp


def _gravity(params: ImuParams, like: torch.Tensor) -> torch.Tensor:
    # a slice fill on the device: a list through torch.tensor is a blocking
    # upload, and an integer index (g[2] = x) waits for the card too
    g = torch.zeros(3, dtype=like.dtype, device=like.device)
    g[2:] = -params.gravity
    return g


def predict(
    state: NavState, preint: Preintegrated, bias_acc, bias_gyr, params: ImuParams
) -> NavState:
    """Propagate a NavState through the preintegrated window
    (GTSAM ``PreintegratedImuMeasurements::predict`` semantics)."""
    g = _gravity(params, state.p)
    dR, dv, dp = bias_corrected_deltas(preint, bias_acc, bias_gyr)
    T = preint.dt
    p = state.p + state.v * T + 0.5 * g * T * T + state.R @ dp
    v = state.v + g * T + state.R @ dv
    R = state.R @ dR
    return NavState(R=R, p=p, v=v)


def residual(
    state_i: NavState,
    state_j: NavState,
    bias_acc,
    bias_gyr,
    preint: Preintegrated,
    params: ImuParams,
) -> torch.Tensor:
    """15->9 IMU factor residual [r_theta, r_v, r_p] (Forster eq. 45)."""
    g = _gravity(params, state_i.p)
    dR, dv, dp = bias_corrected_deltas(preint, bias_acc, bias_gyr)
    T = preint.dt
    Ri_T = state_i.R.T
    r_R = se3.so3_log(dR.T @ (Ri_T @ state_j.R))
    r_v = Ri_T @ (state_j.v - state_i.v - g * T) - dv
    r_p = Ri_T @ (state_j.p - state_i.p - state_i.v * T - 0.5 * g * T * T) - dp
    return torch.cat([r_R, r_v, r_p])
