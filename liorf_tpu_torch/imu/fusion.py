"""Tightly-coupled IMU/LiDAR fusion: a fixed-lag Gauss-Newton smoother.

Replaces the reference's second factor graph
(``liorf/src/imuPreintegration.cpp:156-507``): GTSAM ISAM2 over a chain of
(pose, velocity, bias) states with an ImuFactor + bias random-walk
BetweenFactor + lidar-pose PriorFactor per lidar correction, reset every 100
keys. Because every state carries a strong lidar prior, the chain's
information is local; we solve the same factors exactly over a lag-1 window
(previous state marginalized into a 15x15 Gaussian prior via Schur
complement) — one small dense GN per correction. The reference's divergence
guard (velocity > 30 m/s or bias norm > 1.0 resets the filter,
``imuPreintegration.cpp:438-456``) is preserved as a device-side flag.

State: (R, p, v, b_acc, b_gyr); tangent [dtheta, dp, dv, dba, dbg] with
R <- R exp(dtheta), p <- p + dp (world frame), linear elsewhere.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se3
from ..ops import fusion_step as fstep
from .preintegration import (
    ImuParams, NavState, Preintegrated, predict, prefix_products, residual,
)


class FusionParams(NamedTuple):
    imu: ImuParams = ImuParams()
    # sigmas of the lidar pose prior (rot rad x3, trans m x3), reference
    # correctionNoise / correctionNoise2 (imuPreintegration.cpp:222-224)
    correction_rot_sigma: float = 0.05
    correction_trans_sigma: float = 0.1
    degenerate_sigma: float = 1.0
    # initial prior sigmas (imuPreintegration.cpp:219-221)
    init_pose_sigma: float = 1e-2
    init_vel_sigma: float = 1e4
    init_bias_sigma: float = 1e-3
    gn_iters: int = 4
    max_velocity: float = 30.0
    max_bias: float = 1.0


class FusionState(NamedTuple):
    R: torch.Tensor  # [3, 3]
    p: torch.Tensor  # [3]
    v: torch.Tensor  # [3]
    ba: torch.Tensor  # [3]
    bg: torch.Tensor  # [3]


class FusionFilter(NamedTuple):
    mean: FusionState
    sqrt_info: torch.Tensor  # [15, 15] upper-triangular-ish whitening of the prior


def _retract(s: FusionState, xi: torch.Tensor) -> FusionState:
    return FusionState(
        R=s.R @ se3.so3_exp(xi[0:3]),
        p=s.p + xi[3:6],
        v=s.v + xi[6:9],
        ba=s.ba + xi[9:12],
        bg=s.bg + xi[12:15],
    )


def _local(a: FusionState, b: FusionState) -> torch.Tensor:
    """xi such that retract(a, xi) ~= b."""
    return torch.cat(
        [se3.so3_log(a.R.T @ b.R), b.p - a.p, b.v - a.v, b.ba - a.ba, b.bg - a.bg]
    )


def init_filter(R0: torch.Tensor, p0: torch.Tensor, params: FusionParams) -> FusionFilter:
    """Initialize from the first lidar pose (imuPreintegration.cpp:274-316)."""
    dev = R0.device
    z = torch.zeros(3, dtype=torch.float32, device=dev)
    mean = FusionState(R=R0, p=p0, v=z, ba=z.clone(), bg=z.clone())
    # filled on the device (a list through torch.tensor is a blocking upload)
    sig = torch.full((15,), params.init_pose_sigma, dtype=torch.float32, device=dev)
    sig[6:9] = params.init_vel_sigma
    sig[9:15] = params.init_bias_sigma
    return FusionFilter(mean=mean, sqrt_info=torch.diag(1.0 / sig))


class FusionStep(NamedTuple):
    filter: FusionFilter
    diverged: torch.Tensor  # [] bool — caller should re-init when set


def _cholesky(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN (not an exception, no host sync) when M is
    not positive definite, which is what the JAX original returns and what
    the divergence flag below looks for."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where(info == 0, L, torch.nan)


def fusion_step(
    filt: FusionFilter,
    preint: Preintegrated,
    lidar_R: torch.Tensor,
    lidar_p: torch.Tensor,
    degenerate: torch.Tensor,
    params: FusionParams = FusionParams(),
) -> FusionStep:
    """One lidar correction: GN over (state_i, state_j), then marginalize i.

    One call of ``ops/fusion_step.py::fusion_step`` (the kernel
    ``csrc/fusion.cu`` on the card, its plain version on the CPU): the same
    factors, GN iterations and marginalization as :func:`fusion_step_jacfwd`
    with closed-form Jacobians. Under ``torch.func.vmap`` the lanes are one
    launch. ``fusion_step.calls`` counts the calls (a vmapped call once)."""
    fusion_step.calls += 1
    m, pre = filt.mean, preint
    tensors = (m.R, m.p, m.v, m.ba, m.bg, filt.sqrt_info, pre.dR, pre.dv, pre.dp, pre.dt,
               pre.dR_dbg, pre.dv_dba, pre.dv_dbg, pre.dp_dba, pre.dp_dbg, pre.cov,
               pre.bias_acc_lin, pre.bias_gyr_lin, lidar_R, lidar_p, degenerate)
    R, p, v, ba, bg, W, diverged = (o[0] for o in fstep.fusion_step(
        *(t[None] for t in tensors),
        params.imu.acc_bias_rw, params.imu.gyr_bias_rw, params.imu.gravity,
        params.correction_rot_sigma, params.correction_trans_sigma, params.degenerate_sigma,
        params.max_velocity, params.max_bias, params.gn_iters))
    return FusionStep(filter=FusionFilter(mean=FusionState(R, p, v, ba, bg), sqrt_info=W),
                      diverged=diverged)


fusion_step.calls = 0


def jacfwd_system(prior_mean, prior_W, imu_W, bias_W, corr_W, preint, lidar_R, lidar_p,
                  s_i, s_j, params):
    """(J [36, 30], r [36]) of :func:`fusion_step_jacfwd`'s residual (prior,
    IMU, bias, lidar rows) at (s_i, s_j): ``torch.func.jacfwd`` at xi = 0,
    as ``jax.jacfwd`` in the JAX package."""

    def residuals(xi):
        si = _retract(s_i, xi[0:15])
        sj = _retract(s_j, xi[15:30])
        r_prior = prior_W @ _local(prior_mean, si)
        r_imu = imu_W @ residual(
            NavState(R=si.R, p=si.p, v=si.v),
            NavState(R=sj.R, p=sj.p, v=sj.v),
            si.ba,
            si.bg,
            preint,
            params.imu,
        )
        r_bias = bias_W * torch.cat([sj.ba - si.ba, sj.bg - si.bg])
        r_lidar = corr_W * torch.cat(
            [se3.so3_log(lidar_R.T @ sj.R), sj.p - lidar_p]
        )
        r = torch.cat([r_prior, r_imu, r_bias, r_lidar])
        return r, r

    zero = torch.zeros(30, dtype=s_i.p.dtype, device=s_i.p.device)
    return torch.func.jacfwd(residuals, has_aux=True)(zero)


def fusion_step_jacfwd(
    filt: FusionFilter,
    preint: Preintegrated,
    lidar_R: torch.Tensor,
    lidar_p: torch.Tensor,
    degenerate: torch.Tensor,
    params: FusionParams = FusionParams(),
) -> FusionStep:
    """:func:`fusion_step` op by op, as the JAX package writes it: the
    Jacobian by ``torch.func.jacfwd``, the library's QR, triangular solves,
    ``solve_ex`` and ``cholesky_ex``. The oracle of the closed-form version
    (tests and ``chip_smoke.py``); nothing on the main path calls it."""
    dtype, dev = filt.mean.p.dtype, filt.mean.p.device
    prior_mean = filt.mean
    prior_W = filt.sqrt_info

    def eye(n):
        return torch.eye(n, dtype=dtype, device=dev)

    # whitening for the IMU factor from the preintegrated covariance
    cov = preint.cov + eye(9) * 1e-10
    L = _cholesky(cov)
    imu_W = torch.linalg.solve_triangular(L, eye(9), upper=False)

    # bias random-walk whitening: sigma * sqrt(dt) (imuPreintegration.cpp:372-373)
    sqdt = torch.sqrt(torch.clamp(preint.dt, min=1e-6))
    rw = torch.tensor(
        [params.imu.acc_bias_rw] * 3 + [params.imu.gyr_bias_rw] * 3,
        dtype=dtype, device=dev,
    )
    bias_W = 1.0 / (rw * sqdt)

    corr_sig = torch.where(
        degenerate,
        torch.full((6,), params.degenerate_sigma, dtype=dtype, device=dev),
        torch.tensor(
            [params.correction_rot_sigma] * 3 + [params.correction_trans_sigma] * 3,
            dtype=dtype, device=dev,
        ),
    )
    corr_W = 1.0 / corr_sig

    # initial guess for state_j: IMU propagation from state_i
    guess_nav = predict(
        NavState(R=prior_mean.R, p=prior_mean.p, v=prior_mean.v),
        preint,
        prior_mean.ba,
        prior_mean.bg,
        params.imu,
    )
    state_j0 = FusionState(
        R=guess_nav.R, p=guess_nav.p, v=guess_nav.v, ba=prior_mean.ba, bg=prior_mean.bg
    )

    def jac_and_res(s_i, s_j):
        return jacfwd_system(prior_mean, prior_W, imu_W, bias_W, corr_W, preint, lidar_R,
                             lidar_p, s_i, s_j, params)

    s_i, s_j = prior_mean, state_j0
    # fixed-length Python loop in place of lax.scan (fusion.py:187); no host
    # sync inside
    for _ in range(params.gn_iters):
        J, r = jac_and_res(s_i, s_j)
        # Column-scaled QR least squares: the normal equations span ~1e16 in
        # conditioning (free-velocity prior vs whitened IMU dp rows) which
        # f32 cannot solve; QR on the scaled Jacobian keeps kappa ~ sqrt of
        # that and converges in one Newton step.
        d = torch.sqrt(torch.clamp(torch.sum(J * J, dim=0), min=1e-16))
        Js = J / d[None, :]
        Q, Rm = torch.linalg.qr(Js)
        y = torch.linalg.solve_triangular(
            Rm + eye(30) * 1e-7, -(Q.T @ r)[:, None], upper=True
        )[:, 0]
        dx = y / d
        s_i, s_j = _retract(s_i, dx[0:15]), _retract(s_j, dx[15:30])

    # Marginalize state_i: Schur complement of the final Hessian, in the
    # same Jacobi-scaled coordinates for f32 robustness.
    J, _ = jac_and_res(s_i, s_j)
    H = J.T @ J
    d = torch.sqrt(torch.clamp(torch.diag(H), min=1e-12))
    Hs = H / (d[:, None] * d[None, :]) + eye(30) * 1e-7
    A = Hs[0:15, 0:15]
    B = Hs[0:15, 15:30]
    C = Hs[15:30, 15:30]
    AinvB, _ = torch.linalg.solve_ex(A, B)
    S = C - B.T @ AinvB
    S = 0.5 * (S + S.T) + eye(15) * 1e-7
    # unscale: H_marg = D_j^1/2 S D_j^1/2; sqrt info W = chol(S)^T D_j^1/2
    d_j = d[15:30]
    W_new = _cholesky(S).T * d_j[None, :]

    diverged = (
        (torch.linalg.norm(s_j.v) > params.max_velocity)
        | (torch.linalg.norm(s_j.ba) > params.max_bias)
        | (torch.linalg.norm(s_j.bg) > params.max_bias)
        | ~torch.all(torch.isfinite(W_new))
    )
    return FusionStep(filter=FusionFilter(mean=s_j, sqrt_info=W_new), diverged=diverged)


def predict_poses(
    state: FusionState,
    acc: torch.Tensor,  # [K, 3]
    gyr: torch.Tensor,  # [K, 3]
    dts: torch.Tensor,  # [K]
    mask: torch.Tensor,  # [K]
    gravity: float = 9.80511,
) -> tuple[torch.Tensor, torch.Tensor]:
    """IMU-rate forward integration from `state` (bias-corrected).

    Returns (R [K, 3, 3], p [K, 3]) after each sample — the equivalent of
    the reference's ``odometry/imu_incremental`` stream
    (imuPreintegration.cpp:458-506).

    The K-step recursion (a ``lax.scan`` in fusion.py:243 of the JAX
    package) is evaluated in its log-depth form: a prefix product of the
    per-sample rotation increments and two cumulative sums, equal to the
    sequential recursion up to f32 reassociation.
    """
    dt = torch.where(mask, dts, 0.0)
    g = torch.zeros(3, dtype=state.p.dtype, device=state.p.device)
    g[2:] = -gravity  # a slice fill on the device (g[2] = x waits for the card)

    dR_inc = se3.so3_exp((gyr - state.bg) * dt[:, None])  # [K,3,3]
    Rs = state.R @ prefix_products(dR_inc)  # rotation AFTER each sample
    pre_R = torch.cat([state.R[None], Rs[:-1]], dim=0)  # before each

    a_w = torch.einsum("kij,kj->ki", pre_R, acc - state.ba) + g  # [K, 3]
    dv = a_w * dt[:, None]
    vs = state.v + torch.cumsum(dv, dim=0)  # velocity AFTER each sample
    pre_v = torch.cat([state.v[None], vs[:-1]], dim=0)
    dp = pre_v * dt[:, None] + 0.5 * a_w * dt[:, None] ** 2
    ps = state.p + torch.cumsum(dp, dim=0)
    return Rs, ps


# ``predict_poses`` already is the log-depth form, which the JAX package
# keeps apart under this name (its fusion.py:247-278); the resident step
# calls it by that name.
predict_poses_parallel = predict_poses
