"""The SO(3) algebra of the hand-written kernels' plain versions, in torch
ops with every operation rounded on its own and in the kernels' order: the
3 x 3 products (:func:`mm`, :func:`mv`, :func:`mtm`, :func:`mtv`), ``so3_exp``
and its forward-mode derivative (:func:`so3_exp`, :func:`so3_exp_jvp`), the
Jacobians' W^2 term (:func:`jr_term`), and ``so3_log`` and its forward-mode
derivative (:func:`log_jvp`). The plain versions of the pose graph's
linearization (``ops/linearize.py``), of the IMU fusion correction
(``ops/fusion_step.py``) and of IMU preintegration (``ops/preintegrate.py``)
take their rotation algebra from here; ``csrc/so3_log.cuh`` is the log's CUDA
twin, ``csrc/so3_exp.cuh`` the exp's and the products', and
``csrc/fusion.cu`` spells the rest (the same operations in the same order, so
each kernel equals its plain version bit for bit on the card).

The derivative is the one ``torch.func.jacfwd`` takes of
``core/se3.py::so3_log``'s formula, in the branch the value takes (theta <
1e-5, the generic branch, or theta > pi - 1e-2, where the axis is rebuilt
from the symmetric part), not the textbook one. A 3-term product sum is
``(a0 b0 + a1 b1) + a2 b2``. ``atan2`` is taken in float64 and rounded to
float32: the CPU's float32 ``atan2`` rounds a vectorized chunk and a scalar
tail differently, which made a lane's bits depend on the batch around it; in
float64 both (and CUDA's ``atan2``, which torch and the kernels share) round
to the same float32.
"""

from __future__ import annotations

import math

import torch

from .se3 import hat

_NEAR_PI = math.pi - 1e-2
_SIXTH = 1.0 / 6.0


def mtm(A, B):
    """A^T B of [..., 3, 3] blocks, each entry (a0 b0 + a1 b1) + a2 b2."""
    p = [A[..., l, :, None] * B[..., l, None, :] for l in range(3)]
    return (p[0] + p[1]) + p[2]


def mtv(A, v):
    """A^T v: [..., 3, 3] x [..., 3] -> [..., 3]."""
    p = [A[..., l, :] * v[..., l, None] for l in range(3)]
    return (p[0] + p[1]) + p[2]


def mm(A, B):
    """A B of [..., 3, 3] blocks, each entry (a0 b0 + a1 b1) + a2 b2."""
    p = [A[..., :, l, None] * B[..., None, l, :] for l in range(3)]
    return (p[0] + p[1]) + p[2]


def mv(A, x):
    """A x: [..., 3, 3] x [..., 3] -> [..., 3]."""
    p = [A[..., :, l] * x[..., l, None] for l in range(3)]
    return (p[0] + p[1]) + p[2]


def exp_terms(w):
    """``so3_exp``'s scalars at w [..., 3] (``core/se3.py::_rodrigues_terms``):
    theta^2, the Taylor flag, the safe theta, sin and cos of it, A, B."""
    th2 = sum3(w[..., 0] * w[..., 0], w[..., 1] * w[..., 1], w[..., 2] * w[..., 2])
    th = torch.sqrt(th2)
    small = th < 1e-5
    st = torch.where(small, torch.ones_like(th), th)
    sn = torch.sin(st.double()).to(th2.dtype)  # in float64, as the kernel
    cs = torch.cos(st.double()).to(th2.dtype)
    A = torch.where(small, 1.0 - th2 / 6.0, sn / st)
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - cs) / (st * st))
    return th2, small, st, sn, cs, A, B


def jr_term(th2, small, st, sn):
    """(theta - sin theta) / theta^3 from :func:`exp_terms`' scalars, the W^2
    coefficient of the left and right Jacobians (1/6 - theta^2 / 120 below
    1e-5; ``csrc/so3_exp.cuh::jr_term``)."""
    return torch.where(small, _SIXTH - th2 * (1.0 / 120.0), (st - sn) / ((st * st) * st))


def so3_exp(w):
    """Rodrigues' formula [..., 3] -> [..., 3, 3]: I + A W + B W^2."""
    _, _, _, _, _, A, B = exp_terms(w)
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return (eye + A[..., None, None] * W) + B[..., None, None] * mm(W, W)


def so3_exp_jvp(w, dw):
    """The forward-mode derivative of :func:`so3_exp` at w [..., 3] along
    each direction dw [..., D, 3] -> [..., D, 3, 3], branch by branch (the
    one ``jacfwd`` takes of ``_rodrigues_terms``' formula)."""
    th2, small, st, sn, cs, A, B = (x[..., None] for x in exp_terms(w))
    w_ = w[..., None, :]
    dth2 = sum3(w_[..., 0] * dw[..., 0], w_[..., 1] * dw[..., 1], w_[..., 2] * dw[..., 2]) * 2.0
    zero = torch.zeros_like(dth2)
    dst = torch.where(small, zero, dth2 / (st * 2.0))
    dA = torch.where(small, -(dth2 / 6.0), (cs * dst - A * dst) / st)
    dB = torch.where(small, -(dth2 / 24.0), (sn * dst / st - (B * 2.0) * dst) / st)
    W, dW = hat(w_), hat(dw)
    W2, dWW, WdW = mm(W, W), mm(dW, W), mm(W, dW)

    def s(x):
        return x[..., None, None]

    return ((s(dA) * W + s(A) * dW) + s(dB) * W2) + s(B) * (dWW + WdW)


def _cols(c0, c1, c2):
    """A [..., 3, 3] from its three columns [..., 3]."""
    return torch.stack([c0, c1, c2], -1)


def q_hat(Q):
    """Q hat(e_k) for k = 0, 1, 2 -> [..., 3, 3, 3] (exact column moves):
    the tangent of Q exp(w) along w = e_k."""
    z = torch.zeros_like(Q[..., 0])
    c = [Q[..., :, 0], Q[..., :, 1], Q[..., :, 2]]
    return torch.stack([_cols(z, c[2], -c[1]), _cols(-c[2], z, c[0]), _cols(c[1], -c[0], z)], -3)


def hat_p(P):
    """-hat(e_k) P for k = 0, 1, 2 -> [..., 3, 3, 3] (exact row moves): with
    Rm^T in front, the tangent of Rm^T exp(w)^T P along w = e_k."""
    z = torch.zeros_like(P[..., 0, :])
    r = [P[..., 0, :], P[..., 1, :], P[..., 2, :]]
    return torch.stack([torch.stack(x, -2) for x in
                        ((z, r[2], -r[1]), (-r[2], z, r[0]), (r[1], -r[0], z))], -3)


def sum3(x0, x1, x2):
    return (x0 + x1) + x2


def log_jvp(Q, dQ):
    """``so3_log(Q)`` [..., 3] and its derivative along each direction dQ
    [..., D, 3, 3] -> [..., D, 3]: the formula of ``core/se3.py::so3_log``
    and its forward-mode derivative, branch by branch (the derivative
    ``jacfwd`` takes of the branch the value takes)."""

    def q(a, c):
        return Q[..., a, c]

    # value (every per-rotation scalar [...]); the tangents [..., D]
    tr = sum3(q(0, 0), q(1, 1), q(2, 2))
    cr = (tr - 1.0) * 0.5
    cin = (cr >= -1.0) & (cr <= 1.0)
    cos = torch.clamp(cr, -1.0, 1.0)
    ws = [(q(2, 1) - q(1, 2)) * 0.5, (q(0, 2) - q(2, 0)) * 0.5, (q(1, 0) - q(0, 1)) * 0.5]
    s2 = sum3(ws[0] * ws[0], ws[1] * ws[1], ws[2] * ws[2])
    small_s = s2 < 1e-12
    sin = torch.where(small_s, torch.zeros_like(s2), torch.sqrt(s2))
    theta = torch.atan2(sin.double(), cos.double()).to(sin.dtype)  # see the module's note
    small = theta < 1e-5
    near = theta > _NEAR_PI
    tiny = sin < 1e-9
    safe = torch.where(tiny, torch.ones_like(sin), sin)
    scale = torch.where(small, 1.0 + s2 * _SIXTH, theta / safe)
    w_gen = [x * scale for x in ws]

    # near pi: the axis from the diagonal of M = (Q + Q^T) / 2 - cos I
    d = [q(a, a) - cos for a in range(3)]
    omc = 1.0 - cos
    den_in = omc >= 1e-9
    den = torch.clamp(omc, min=1e-9)
    ax2 = [x / den for x in d]
    pos = [x > 1e-12 for x in ax2]
    aabs = [torch.where(p, torch.sqrt(x), torch.zeros_like(x)) for p, x in zip(pos, ax2)]
    r = torch.argmax(torch.stack(d, -1), -1)  # the first largest

    def m(a, c):
        return d[a] if a == c else (q(a, c) + q(c, a)) * 0.5

    def pick(vals):  # vals[r]
        return torch.where(r == 0, vals[0], torch.where(r == 1, vals[1], vals[2]))

    one = torch.ones_like(cos)
    sgr = torch.where(pick(ws) >= 0, one, -one)
    sg = [torch.where(pick([m(a, c) for a in range(3)]) >= 0, one, -one) * sgr for c in range(3)]
    ax = [a * s for a, s in zip(aabs, sg)]
    a2 = sum3(ax[0] * ax[0], ax[1] * ax[1], ax[2] * ax[2])
    a_pos = a2 > 1e-12
    nrm = torch.where(a_pos, torch.sqrt(a2), one)
    axn = [x / nrm for x in ax]
    w = torch.stack([torch.where(near, a * theta, g) for a, g in zip(axn, w_gen)], -1)

    # tangents: the value's scalars broadcast over the direction axis
    def v(x):
        return x[..., None]

    def dq(a, c):
        return dQ[..., a, c]

    zero = torch.zeros_like(dQ[..., 0, 0])
    dcos = torch.where(v(cin), sum3(dq(0, 0), dq(1, 1), dq(2, 2)) * 0.5, zero)
    dws = [(dq(2, 1) - dq(1, 2)) * 0.5, (dq(0, 2) - dq(2, 0)) * 0.5, (dq(1, 0) - dq(0, 1)) * 0.5]
    ds2 = sum3(v(ws[0]) * dws[0], v(ws[1]) * dws[1], v(ws[2]) * dws[2]) * 2.0
    dsin = torch.where(v(small_s), zero, ds2 / v(sin * 2.0))
    dtheta = (v(cos) * dsin - v(sin) * dcos) / v(sin * sin + cos * cos)
    dsafe = torch.where(v(tiny), zero, dsin)
    dscale = torch.where(v(small), ds2 * _SIXTH, (dtheta - v(scale) * dsafe) / v(safe))
    dw_gen = [dx * v(scale) + v(x) * dscale for dx, x in zip(dws, ws)]
    dden = torch.where(v(den_in), -dcos, zero)
    dax = []
    for a in range(3):
        dax2 = ((dq(a, a) - dcos) - v(ax2[a]) * dden) / v(den)
        daabs = torch.where(v(pos[a]), dax2 / v(aabs[a] * 2.0), zero)
        dax.append(daabs * v(sg[a]))
    da2 = sum3(v(ax[0]) * dax[0], v(ax[1]) * dax[1], v(ax[2]) * dax[2]) * 2.0
    dnrm = torch.where(v(a_pos), da2 / v(nrm * 2.0), zero)
    dw = [torch.where(v(near), ((dx - v(x) * dnrm) / v(nrm)) * v(theta) + v(x) * dtheta, g)
          for dx, x, g in zip(dax, axn, dw_gen)]
    return w, torch.stack(dw, -1)
