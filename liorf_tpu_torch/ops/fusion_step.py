"""The IMU fusion correction (``imu/fusion.py::fusion_step``) in one kernel.

Not a TPU kernel. The JAX package jits ``fusion_step``
(``liorf_tpu/imu/fusion.py:98-213``) into one XLA program: ``jax.jacfwd`` of
a 36-row residual in 30 tangents, ``gn_iters`` column-scaled QR least-squares
steps under ``lax.scan``, then a Schur-complement marginalization and a
Cholesky factor. Op by op on the card that was five ``torch.func.jacfwd``
passes, four library QRs and their solves a call: thousands of launches,
~235 ms a frame of host time. The kernel (``csrc/fusion.cu``) runs the whole
correction in one launch, one thread block a lane.

* :func:`fusion_step` — one correction for every lane: the new mean (R, p,
  v, ba, bg), its square-root information ``W`` [B, 15, 15] and the
  divergence flag. Every tensor argument has a leading lane axis [B]; one
  call on the card serves every lane (a vmapped call's lanes included).
* :func:`fusion_step_plain` — the same function in torch ops, in the
  kernel's order of operations.
* :func:`system_plain` — the 36 residual rows and their Jacobian in 30
  tangents at two states, in closed form (tests hold it to ``jacfwd``).

The Jacobians at xi = 0 under the fusion's retraction (R <- R exp(xi_R),
linear elsewhere) are ``jacfwd``'s own derivative, not the textbook one:
the rotation rows are ``so3_log``'s forward-mode derivative in the branch
the value takes (``core/so3_jvp.py::log_jvp``) along the directions in
which ``jacfwd`` perturbs its argument, and the IMU rotation row's column
in the gyro bias goes through ``so3_exp``'s forward-mode derivative at
``dR_dbg @ dbg`` (``core/so3_jvp.py::so3_exp_jvp``: the Taylor branch below
1e-5 rad, else sin / cos).

The order contract (the kernel keeps it, this module spells it): every
operation is rounded on its own (no fused multiply-add); a 3-term product
sum is ``(a0 b0 + a1 b1) + a2 b2``; every longer sum is the halving tree of
:func:`tree_sum` (zeros padded to a power of two, element i added to element
i + h) over all its terms, masked ones as +0.0; the factorizations are
Householder QR (LAPACK's reflector), LU with partial pivoting (the first
largest pivot) and Cholesky, column by column, exactly as written below.
``sin``, ``cos`` and ``atan2`` are taken in float64 and rounded to float32,
so torch and the kernel (CUDA's float64 functions on the card) agree; on
the card torch's ``sqrt`` and division are IEEE's, as the kernel's, and the
two agree bit for bit there. On the CPU the float32 ``sqrt`` (MKL's) may
differ in the last place.

Dispatch by the tensor's device and nothing else: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises. The kernel is a
``torch.library`` custom op with a vmap rule, so the lane axis of
``pipeline/multistream.py`` (``torch.func.vmap``) folds into the launch.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..core.build import build_cuda_library
from ..core.se3 import hat
from ..core.so3_jvp import hat_p, log_jvp, mm, mtm, mtv, mv, q_hat, so3_exp, so3_exp_jvp, sum3
from .segment_sum import _fold_lanes

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fusion.cu"

# the tensor arguments, in the kernel's order, and their shapes after the
# lane axis
ARGS = ("R", "p", "v", "ba", "bg", "W", "dR", "dv", "dp", "dt", "dR_dbg", "dv_dba", "dv_dbg",
        "dp_dba", "dp_dbg", "cov", "bias_acc_lin", "bias_gyr_lin", "lidar_R", "lidar_p",
        "degenerate")
SHAPES = dict(R=(3, 3), p=(3,), v=(3,), ba=(3,), bg=(3,), W=(15, 15), dR=(3, 3), dv=(3,),
              dp=(3,), dt=(), dR_dbg=(3, 3), dv_dba=(3, 3), dv_dbg=(3, 3), dp_dba=(3, 3),
              dp_dbg=(3, 3), cov=(9, 9), bias_acc_lin=(3,), bias_gyr_lin=(3,), lidar_R=(3, 3),
              lidar_p=(3,), degenerate=())
# the scalars, passed by value
CONSTS = ("acc_bias_rw", "gyr_bias_rw", "gravity", "correction_rot_sigma",
          "correction_trans_sigma", "degenerate_sigma", "max_velocity", "max_bias")

_lib = None
build_seconds: float | None = None  # wall time of the nvcc run, if one was needed


def load_library(extra_flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    so, build_seconds = build_cuda_library(_SOURCE, extra_flags)
    lib = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    lib.liorf_fusion_step.argtypes = ([vp] * 28 + [ctypes.c_float] * len(CONSTS)
                                      + [ctypes.c_int] * 2 + [vp])
    lib.liorf_fusion_step.restype = ctypes.c_int
    _lib = lib
    return lib


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum of ``x`` along ``dim`` as a halving tree: zeros padded to a
    power of two P, then element i added to element i + P/2, and so on down
    to one (a warp's shuffle-down order)."""
    dim = dim % x.dim()
    n = x.shape[dim]
    P = 1 << (n - 1).bit_length()
    if P > n:
        pad = list(x.shape)
        pad[dim] = P - n
        x = torch.cat([x, x.new_zeros(pad)], dim)
    while P > 1:
        P //= 2
        x = x.narrow(dim, 0, P) + x.narrow(dim, P, P)
    return x.squeeze(dim)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def cholesky(M):
    """Lower Cholesky factor of [B, n, n] (its lower triangle read), column
    by column: L[i][j] = (M[i][j] - sum_{k<j} L[i][k] L[j][k]) / L[j][j],
    the diagonal the square root of the same difference. NaN everywhere
    when a pivot is not > 0 (LAPACK's test), as ``imu/fusion.py::_cholesky``
    returns."""
    n = M.shape[-1]
    idx = torch.arange(n, device=M.device)
    L = torch.zeros_like(M)
    ok = torch.ones(M.shape[0], dtype=torch.bool, device=M.device)
    for j in range(n):
        s = M[:, :, j] - tree_sum(torch.where(idx < j, L * L[:, j:j + 1, :], 0.0), 2)
        piv = s[:, j]
        ok = ok & (piv > 0)
        Ljj = torch.sqrt(piv)[:, None]
        col = torch.where(idx == j, Ljj, torch.where(idx > j, s / Ljj, 0.0))
        L = torch.where(idx == j, col[:, :, None], L)
    return torch.where(ok[:, None, None], L, torch.nan)


def lower_inverse(L):
    """L^-1 of a lower-triangular [B, n, n] by forward substitution, every
    column of the identity at once: X[i] = (I[i] - sum_{m<i} L[i][m] X[m]) / L[i][i]."""
    n = L.shape[-1]
    idx = torch.arange(n, device=L.device)
    eye = _eye(n, L)
    X = torch.zeros_like(L)
    for i in range(n):
        s = tree_sum(torch.where((idx < i)[:, None], L[:, i, :, None] * X, 0.0), 1)
        X = torch.where((idx == i)[:, None], ((eye[i] - s) / L[:, i, i, None])[:, None, :], X)
    return X


def _gravity(T, gravity):
    """[0, 0, -gravity] with T's lane axis, built on T's device."""
    z = torch.zeros_like(T)
    return torch.stack([z, z, torch.full_like(T, -gravity)], -1)


def predict_plain(R, p, v, ba, bg, pre, gravity):
    """The IMU prediction of the state after the window
    (``imu/preintegration.py::predict``) with the bias-corrected deltas."""
    dR0, dv0, dp0, T, dR_dbg, dv_dba, dv_dbg, dp_dba, dp_dbg, bal, bgl = pre
    dba, dbg = ba - bal, bg - bgl
    dRc = mm(dR0, so3_exp(mv(dR_dbg, dbg)))
    dvc = (dv0 + mv(dv_dba, dba)) + mv(dv_dbg, dbg)
    dpc = (dp0 + mv(dp_dba, dba)) + mv(dp_dbg, dbg)
    g, t = _gravity(T, gravity), T[:, None]
    p_new = ((p + v * t) + ((0.5 * g) * t) * t) + mv(R, dpc)
    v_new = (v + g * t) + mv(R, dvc)
    return mm(R, dRc), p_new, v_new


def system_plain(s_i, s_j, prior, Wp, imu_W, bias_W, corr_W, pre, lidar_R, lidar_p, gravity):
    """The 36 whitened residual rows (prior 15, IMU 9, bias 6, lidar 6) and
    their Jacobian [B, 36, 30] in the 30 tangents [theta_i, p_i, v_i, ba_i,
    bg_i, theta_j, p_j, v_j, ba_j, bg_j] at xi = 0, in closed form.
    ``s_i``, ``s_j``, ``prior``: (R, p, v, ba, bg) with a lane axis."""
    Ri, pi, vi, bai, bgi = s_i
    Rj, pj, vj, baj, bgj = s_j
    PR, Pp, Pv, Pba, Pbg = prior
    dR0, dv0, dp0, T, dR_dbg, dv_dba, dv_dbg, dp_dba, dp_dbg, bal, bgl = pre
    B = Ri.shape[0]
    Z3 = torch.zeros_like(Ri)

    # prior: Wp local(prior, s_i); its rotation columns log's derivative at
    # PR^T Ri along (PR^T Ri) hat(e_k)
    Qp = mtm(PR, Ri)
    lp, dlp = log_jvp(Qp, q_hat(Qp))  # [B, 3], [B, 3 (k), 3 (m)]
    local = torch.cat([lp, pi - Pp, vi - Pv, bai - Pba, bgi - Pbg], -1)
    r_prior = tree_sum(Wp * local[:, None, :], -1)
    Jp_rot = sum3(*(Wp[:, :, m, None] * dlp[:, None, :, m] for m in range(3)))
    J_prior = torch.cat([Jp_rot, Wp[:, :, 3:], torch.zeros_like(Wp)], -1)

    # IMU (imu/preintegration.py::residual at the bias-corrected deltas)
    dba, dbg = bai - bal, bgi - bgl
    w = mv(dR_dbg, dbg)
    dRc = mm(dR0, so3_exp(w))
    dvc = (dv0 + mv(dv_dba, dba)) + mv(dv_dbg, dbg)
    dpc = (dp0 + mv(dp_dba, dba)) + mv(dp_dbg, dbg)
    M = mtm(Ri, Rj)
    E = mtm(dRc, M)
    # directions of E: theta_i (-hat(e_k) M behind dRc^T), theta_j (E hat(e_k)),
    # bg_i (dR0 d exp(w) along the columns of dR_dbg, then ^T M)
    dE_bg = mtm(mm(dR0[:, None], so3_exp_jvp(w, dR_dbg.transpose(-1, -2))), M[:, None])
    dE = torch.cat([mtm(dRc[:, None], hat_p(M)), q_hat(E), dE_bg], 1)
    rR, drR = log_jvp(E, dE)  # [B, 3], [B, 9, 3]
    g, t = _gravity(T, gravity), T[:, None]
    a_v = mtv(Ri, (vj - vi) - g * t)
    a_p = mtv(Ri, ((pj - pi) - vi * t) - ((0.5 * g) * t) * t)
    raw_r = torch.cat([rR, a_v - dvc, a_p - dpc], -1)
    RiT = Ri.transpose(-1, -2)
    dr = drR.transpose(-1, -2)  # [B, 3 (m), 9 (direction)]
    row_R = torch.cat([dr[..., 0:3], Z3, Z3, Z3, dr[..., 6:9], dr[..., 3:6], Z3, Z3, Z3, Z3], -1)
    row_v = torch.cat([hat(a_v), Z3, -RiT, -dv_dba, -dv_dbg, Z3, Z3, RiT, Z3, Z3], -1)
    row_p = torch.cat([hat(a_p), -RiT, -(RiT * T[:, None, None]), -dp_dba, -dp_dbg, Z3, RiT, Z3,
                       Z3, Z3], -1)
    J_raw = torch.cat([row_R, row_v, row_p], 1)  # [B, 9, 30]
    r_imu = tree_sum(imu_W * raw_r[:, None, :], -1)
    J_imu = tree_sum(imu_W[:, :, :, None] * J_raw[:, None, :, :], 2)

    # bias random walk
    r_bias = bias_W * torch.cat([baj - bai, bgj - bgi], -1)
    z69 = torch.zeros((B, 6, 9), dtype=Ri.dtype, device=Ri.device)
    J_bias = torch.cat([z69, torch.diag_embed(-bias_W), z69, torch.diag_embed(bias_W)], -1)

    # lidar pose prior
    Ql = mtm(lidar_R, Rj)
    ll, dll = log_jvp(Ql, q_hat(Ql))
    r_lidar = corr_W * torch.cat([ll, pj - lidar_p], -1)
    z3_15 = torch.zeros((B, 3, 15), dtype=Ri.dtype, device=Ri.device)
    J_lidar = torch.cat([
        torch.cat([z3_15, corr_W[:, :3, None] * dll.transpose(-1, -2), torch.zeros_like(z3_15[..., :12])], -1),
        torch.cat([z3_15, Z3, torch.diag_embed(corr_W[:, 3:]), torch.zeros_like(z3_15[..., :9])], -1),
    ], 1)

    J = torch.cat([J_prior, J_imu, J_bias, J_lidar], 1)
    r = torch.cat([r_prior, r_imu, r_bias, r_lidar], -1)
    return J, r


def householder_solve(J, r):
    """The column-scaled least-squares step of a GN iteration: d =
    sqrt(max(sum J^2, 1e-16)) a column, Householder QR of [J / d | r]
    (LAPACK's reflector: beta = -sign(alpha) ||x||, tau = (beta - alpha) /
    beta, v = x / (alpha - beta); no reflection where the column below the
    diagonal is zero), back substitution of (R + 1e-7 I) y = -Q^T r, dx = y / d."""
    B, m, n = J.shape
    d = torch.sqrt(torch.clamp(tree_sum(J * J, 1), min=1e-16))
    A = torch.cat([J / d[:, None, :], r[:, :, None]], -1)  # [B, 36, 31]
    rows = torch.arange(m, device=J.device)[:, None]
    cols = torch.arange(n + 1, device=J.device)
    for k in range(n):
        col = A[:, :, k]
        alpha = col[:, k]
        x = torch.where(rows[:, 0] > k, col, 0.0)
        xn2 = tree_sum(x * x, 1)
        nz = xn2 != 0
        norm = torch.sqrt(alpha * alpha + xn2)
        beta = torch.where(nz, torch.where(alpha >= 0, -norm, norm), alpha)
        tau = torch.where(nz, (beta - alpha) / beta, 0.0)
        den = (alpha - beta)[:, None]
        v = torch.where(rows[:, 0] > k, torch.where(nz[:, None], col / den, 0.0),
                        torch.where(rows[:, 0] == k, 1.0, 0.0))
        w = tree_sum(v[:, :, None] * A, 1)  # [B, 31]
        upd = A - (tau[:, None] * w)[:, None, :] * v[:, :, None]
        A = torch.where((rows >= k) & (cols > k), upd, A)
        A = torch.where((rows == k) & (cols == k), beta[:, None, None], A)
    jj = torch.arange(n, device=J.device)
    y = torch.zeros_like(d)
    for k in reversed(range(n)):
        s = tree_sum(torch.where(jj > k, A[:, k, :n] * y, 0.0), 1)
        yk = (-A[:, k, n] - s) / (A[:, k, k] + 1e-7)
        y = torch.where(jj == k, yk[:, None], y)
    return y / d


def _retract(s, dx):
    R, p, v, ba, bg = s
    return (mm(R, so3_exp(dx[:, 0:3])), p + dx[:, 3:6], v + dx[:, 6:9], ba + dx[:, 9:12],
            bg + dx[:, 12:15])


def marginal_sqrt_info(J):
    """The square-root information of state j once state i is marginalized
    out of H = J^T J, in Jacobi-scaled coordinates: Hs = H / (d d^T) + 1e-7 I
    (d = sqrt(max(diag H, 1e-12))), the Schur complement S = C - B^T A^-1 B
    (A^-1 B by LU with partial pivoting, the first largest pivot, on [A | B],
    then back substitution), 0.5 (S + S^T) + 1e-7 I, W = chol(S)^T d_j.

    In float64 from J to W, rounded to J's type once at the end: H's float32
    conditioning is ~1e8, and in float32 the product and the Schur
    complement each lose the velocity block of the information to ~1 %,
    which the next correction turns into cm/s of velocity; in float64 it is
    within 1e-7 of a float64 run of the whole step."""
    dtype = J.dtype
    J = J.double()
    H = tree_sum(J[:, :, :, None] * J[:, :, None, :], 1)  # [B, 30, 30]
    d = torch.sqrt(torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), min=1e-12))
    Hs = H / (d[:, :, None] * d[:, None, :]) + _eye(30, H) * 1e-7
    Bm, C = Hs[:, :15, 15:], Hs[:, 15:, 15:]
    Mx = Hs[:, :15, :]  # [A | B]
    rows = torch.arange(15, device=J.device)[:, None]
    cols = torch.arange(30, device=J.device)
    for k in range(15):
        a = torch.where(rows[:, 0] >= k, Mx[:, :, k].abs(), -1.0)
        piv = torch.argmax(a, 1)  # the first largest
        rk = Mx[:, k, :]
        rp = torch.gather(Mx, 1, piv[:, None, None].expand(-1, 1, 30))[:, 0]
        Mx = torch.where(rows == k, rp[:, None, :],
                         torch.where(rows == piv[:, None, None], rk[:, None, :], Mx))
        l = Mx[:, :, k] / Mx[:, k, k, None]
        upd = Mx - l[:, :, None] * Mx[:, k, None, :]
        Mx = torch.where((rows > k) & (cols > k), upd, Mx)
    X = torch.zeros_like(C)
    for k in reversed(range(15)):
        s = tree_sum(torch.where(rows > k, Mx[:, k, :15, None] * X, 0.0), 1)
        X = torch.where(rows == k, ((Mx[:, k, 15:] - s) / Mx[:, k, k, None])[:, None, :], X)
    S = C - tree_sum(Bm[:, :, :, None] * X[:, :, None, :], 1)
    S = 0.5 * (S + S.transpose(1, 2)) + _eye(15, S) * 1e-7
    return (cholesky(S).transpose(1, 2) * d[:, None, 15:]).to(dtype)


def _norm3(x):
    return torch.sqrt(sum3(x[:, 0] * x[:, 0], x[:, 1] * x[:, 1], x[:, 2] * x[:, 2]))


def fusion_step_plain(R, p, v, ba, bg, W, dR, dv, dp, dt, dR_dbg, dv_dba, dv_dbg, dp_dba,
                      dp_dbg, cov, bias_acc_lin, bias_gyr_lin, lidar_R, lidar_p, degenerate,
                      acc_bias_rw, gyr_bias_rw, gravity, correction_rot_sigma,
                      correction_trans_sigma, degenerate_sigma, max_velocity, max_bias,
                      gn_iters):
    """Plain PyTorch version of :func:`fusion_step` (same arguments), in the
    kernel's order of operations: (R, p, v, ba, bg, W, diverged)."""
    f = R.dtype
    pre = (dR, dv, dp, dt, dR_dbg, dv_dba, dv_dbg, dp_dba, dp_dbg, bias_acc_lin, bias_gyr_lin)
    prior = (R, p, v, ba, bg)
    imu_W = lower_inverse(cholesky(cov + _eye(9, cov) * 1e-10))
    sqdt = torch.sqrt(torch.clamp(dt, min=1e-6))[:, None]
    B = R.shape[0]
    rw = torch.cat([torch.full((B, 3), acc_bias_rw, dtype=f, device=R.device),
                    torch.full((B, 3), gyr_bias_rw, dtype=f, device=R.device)], -1)
    bias_W = 1.0 / (rw * sqdt)
    sig = torch.cat([torch.full((B, 3), correction_rot_sigma, dtype=f, device=R.device),
                     torch.full((B, 3), correction_trans_sigma, dtype=f, device=R.device)], -1)
    corr_W = 1.0 / torch.where(degenerate[:, None], degenerate_sigma, sig)
    consts = (W, imu_W, bias_W, corr_W, pre, lidar_R, lidar_p, gravity)

    s_i = prior
    s_j = (*predict_plain(R, p, v, ba, bg, pre, gravity), ba, bg)
    for _ in range(gn_iters):
        dx = householder_solve(*system_plain(s_i, s_j, prior, *consts))
        s_i, s_j = _retract(s_i, dx[:, :15]), _retract(s_j, dx[:, 15:])
    J, _ = system_plain(s_i, s_j, prior, *consts)
    W_new = marginal_sqrt_info(J)
    _, _, vj, baj, bgj = s_j
    diverged = ((_norm3(vj) > max_velocity) | (_norm3(baj) > max_bias) | (_norm3(bgj) > max_bias)
                | ~torch.isfinite(W_new).flatten(1).all(1))
    return (*s_j, W_new, diverged)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _launch(*args):
    """The kernel on every lane: ``args`` as :func:`fusion_step` takes them."""
    tensors, consts = args[:len(ARGS)], args[len(ARGS):]
    gn_iters = int(consts[-1])
    dev = tensors[0].device
    B = tensors[0].shape[0]
    checked = []
    for name, t in zip(ARGS, tensors):
        dtype = torch.bool if name == "degenerate" else torch.float32
        want = (B, *SHAPES[name])
        if t.dtype != dtype or tuple(t.shape) != want or t.device != dev:
            raise ValueError(f"fusion_step: {name} {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected {dtype} {want} on {dev}")
        checked.append(t.contiguous())
    f32 = dict(dtype=torch.float32, device=dev)
    out = [torch.empty(s, **f32) for s in ((B, 3, 3), (B, 3), (B, 3), (B, 3), (B, 3), (B, 15, 15))]
    out.append(torch.empty(B, dtype=torch.bool, device=dev))
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.liorf_fusion_step(
            *(t.data_ptr() for t in checked), *(t.data_ptr() for t in out),
            *(float(c) for c in consts[:-1]), gn_iters, B,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fusion_step: CUDA launch failed with error {err}")
    fusion_step.launches += 1
    return tuple(out)


@torch.library.custom_op("liorf_tpu_torch::fusion_step", mutates_args=())
def _fusion_op(R: torch.Tensor, p: torch.Tensor, v: torch.Tensor, ba: torch.Tensor,
               bg: torch.Tensor, W: torch.Tensor, dR: torch.Tensor, dv: torch.Tensor,
               dp: torch.Tensor, dt: torch.Tensor, dR_dbg: torch.Tensor, dv_dba: torch.Tensor,
               dv_dbg: torch.Tensor, dp_dba: torch.Tensor, dp_dbg: torch.Tensor,
               cov: torch.Tensor, bias_acc_lin: torch.Tensor, bias_gyr_lin: torch.Tensor,
               lidar_R: torch.Tensor, lidar_p: torch.Tensor, degenerate: torch.Tensor,
               acc_bias_rw: float, gyr_bias_rw: float, gravity: float,
               correction_rot_sigma: float, correction_trans_sigma: float,
               degenerate_sigma: float, max_velocity: float, max_bias: float, gn_iters: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor, torch.Tensor]:
    # The op on any device but CUDA is the plain version (the CPU path and
    # the tests reach the vmap rule through it).
    return fusion_step_plain(R, p, v, ba, bg, W, dR, dv, dp, dt, dR_dbg, dv_dba, dv_dbg, dp_dba,
                             dp_dbg, cov, bias_acc_lin, bias_gyr_lin, lidar_R, lidar_p,
                             degenerate, acc_bias_rw, gyr_bias_rw, gravity, correction_rot_sigma,
                             correction_trans_sigma, degenerate_sigma, max_velocity, max_bias,
                             gn_iters)


@_fusion_op.register_kernel("cuda")
def _fusion_cuda(*args):
    return _launch(*args)


@_fusion_op.register_vmap
def _fusion_vmap(info, in_dims, *args):
    """Lanes of a vmap fold into the op's own [B] axis: one launch."""
    n = info.batch_size
    k = len(ARGS)
    out = _fusion_op(*(_fold_lanes(t, d, n) for t, d in zip(args[:k], in_dims[:k])), *args[k:])
    return tuple(o.reshape(n, -1, *o.shape[1:]) for o in out), (0,) * len(out)


def fusion_step(*args):
    """(R [B,3,3], p, v, ba, bg [B,3], W [B,15,15], diverged [B]) of one
    fusion correction a lane: the tensors of ``ARGS`` with a lane axis (the
    prior filter's mean and square-root information, the preintegrated
    window's fields, the lidar pose and the degenerate flag), then the
    scalars of ``CONSTS`` and ``gn_iters``. One call on the card for every
    lane (a vmapped call's lanes included)."""
    dev = args[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fusion_step: unsupported device {dev}")
    return _fusion_op(*args)


fusion_step.launches = 0


def launch_counts() -> dict[str, int]:
    return {"fusion_step": fusion_step.launches}


def reset_launch_counts() -> None:
    fusion_step.launches = 0
