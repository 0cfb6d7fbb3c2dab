"""The pose graph's linearization and normal-equation sums of one
Gauss-Newton step in one kernel.

Not a TPU kernel. The JAX package jits ``_build_normal_terms``
(``liorf_tpu/graph/pose_graph.py:99-117,141-202``: ``jacfwd`` of each
factor's residual under ``vmap``, whitening, the Cauchy weight, the masks,
then ``.at[].add`` of J^T r and J^T J per node) into a few fused XLA
programs; op by op on the card it was thousands of launches a GN step. The
kernel (``csrc/linearize.cu``) forms each factor's residual and Jacobians in
closed form, weights and masks them, writes the J blocks the PCG kernel
(``ops/pcg.py``) reads and each factor's J^T r and J^T J terms, then sums
every node's terms in the order of the solve's ``SegmentPlan``.

* :func:`linearize_normal` — (rhs [B,K,6], diag [B,K,6,6], Ji, Jj [B,E,6,6],
  Jg [B,G,3,6], Jp [B,6,6]) of a graph: ``rhs = -J^T r`` and the block
  diagonal of ``J^T J`` per node, and the whitened, Cauchy-weighted,
  masked Jacobian blocks with frozen nodes' columns zeroed. Every argument
  has a leading lane axis [B]; one call on the card serves every lane.
* :func:`linearize_normal_plain` — the same function in torch ops, in the
  kernel's order of operations (its phase A, :func:`factor_rows_plain`,
  then ``segment_sum_plain`` over the plan's sorted rows).

The Jacobians at the zero tangent under the right-perturbation retraction
(``core/se3.py::se3_retract``): for a between factor d r_R / d w is the
derivative of ``so3_log``'s formula (the branch it takes: theta < 1e-5, the
generic branch, or theta > pi - 1e-2, where the axis is rebuilt from the
symmetric part) along the directions in which ``jacfwd`` perturbs its
argument, d r_t / d w_i = [Ri^T (tj - ti)]x, d r_t / d v_i = -I and
d r_t / d v_j = Ri^T Rj; a GPS factor's is [0 | Ri]; the prior's
[[d log, 0], [0, Ri]]. ``graph/pose_graph.py::_linearize`` (``jacfwd``)
stays as their oracle.

The order contract (the kernel keeps it, this module spells it): every
operation is rounded on its own (no fused multiply-add); a 3-term product
sum is ``(a0 b0 + a1 b1) + a2 b2``; a factor's J^T r and J^T J sum their
rows in index order from the first product; a node's sums add its rows in
the plan's stable sorted order from 0.0 (``segment_sum``'s contract). A row
that is exactly zero (an unused or masked slot, a frozen endpoint) adds
nothing to a sum that starts from +0.0, so the kernel skips it: the dump
node's hundreds of unused slots cost no time, and a ring's capacity
changes no bit. The one function rounded by a library is ``atan2``, taken
in float64 and rounded to float32: the CPU's float32 ``atan2`` rounds a
vectorized chunk and a scalar tail differently, which made a lane's bits
depend on the batch around it; in float64 both paths (and CUDA's ``atan2``,
which torch and the kernel share) round to the same float32. On the card
torch's ``sqrt`` is IEEE's, as the kernel's, so the two agree bit for bit
there; the CPU's float32 ``sqrt`` (MKL) is off by an ulp now and then.

Dispatch by the tensor's device and nothing else: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises. The kernel is a
``torch.library`` custom op with a vmap rule, so the lane axis of
``pipeline/multistream.py`` (``torch.func.vmap``) folds into the launch.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from ..core.build import build_cuda_library
from ..core.se3 import hat
from .segment_sum import _fold_lanes, segment_sum_plain

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "linearize.cu"

ROW = 42  # a plan row: the factor's -J^T r (6) and J^T J (36) at one endpoint
_NEAR_PI = math.pi - 1e-2
_SIXTH = 1.0 / 6.0

_lib = None
build_seconds: float | None = None  # wall time of the nvcc run, if one was needed


def load_library(extra_flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    so, build_seconds = build_cuda_library(_SOURCE, extra_flags)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.liorf_linearize.argtypes = [vp] * 28 + [ci] * 4 + [vp]
    lib.liorf_linearize.restype = ci
    _lib = lib
    return lib


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _mtm(A, B):
    """A^T B of [..., 3, 3] blocks, each entry (a0 b0 + a1 b1) + a2 b2."""
    p = [A[..., l, :, None] * B[..., l, None, :] for l in range(3)]
    return (p[0] + p[1]) + p[2]


def _mtv(A, v):
    """A^T v: [..., 3, 3] x [..., 3] -> [..., 3]."""
    p = [A[..., l, :] * v[..., l, None] for l in range(3)]
    return (p[0] + p[1]) + p[2]


def _cols(c0, c1, c2):
    """A [..., 3, 3] from its three columns [..., 3]."""
    return torch.stack([c0, c1, c2], -1)


def _q_hat(Q):
    """Q hat(e_k) for k = 0, 1, 2 -> [..., 3, 3, 3] (exact column moves):
    the tangent of Q exp(w) along w = e_k."""
    z = torch.zeros_like(Q[..., 0])
    c = [Q[..., :, 0], Q[..., :, 1], Q[..., :, 2]]
    return torch.stack([_cols(z, c[2], -c[1]), _cols(-c[2], z, c[0]), _cols(c[1], -c[0], z)], -3)


def _hat_p(P):
    """-hat(e_k) P for k = 0, 1, 2 -> [..., 3, 3, 3] (exact row moves): with
    Rm^T in front, the tangent of Rm^T exp(w)^T P along w = e_k."""
    z = torch.zeros_like(P[..., 0, :])
    r = [P[..., 0, :], P[..., 1, :], P[..., 2, :]]
    return torch.stack([torch.stack(x, -2) for x in
                        ((z, r[2], -r[1]), (-r[2], z, r[0]), (r[1], -r[0], z))], -3)


def _sum3(x0, x1, x2):
    return (x0 + x1) + x2


def _log_jvp(Q, dQ):
    """``so3_log(Q)`` [..., 3] and its derivative along each direction dQ
    [..., D, 3, 3] -> [..., D, 3]: the formula of ``core/se3.py::so3_log``
    and its forward-mode derivative, branch by branch (the derivative
    ``jacfwd`` takes of the branch the value takes)."""

    def q(a, c):
        return Q[..., a, c]

    # value (every per-rotation scalar [...]); the tangents [..., D]
    tr = _sum3(q(0, 0), q(1, 1), q(2, 2))
    cr = (tr - 1.0) * 0.5
    cin = (cr >= -1.0) & (cr <= 1.0)
    cos = torch.clamp(cr, -1.0, 1.0)
    ws = [(q(2, 1) - q(1, 2)) * 0.5, (q(0, 2) - q(2, 0)) * 0.5, (q(1, 0) - q(0, 1)) * 0.5]
    s2 = _sum3(ws[0] * ws[0], ws[1] * ws[1], ws[2] * ws[2])
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
    a2 = _sum3(ax[0] * ax[0], ax[1] * ax[1], ax[2] * ax[2])
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
    dcos = torch.where(v(cin), _sum3(dq(0, 0), dq(1, 1), dq(2, 2)) * 0.5, zero)
    dws = [(dq(2, 1) - dq(1, 2)) * 0.5, (dq(0, 2) - dq(2, 0)) * 0.5, (dq(1, 0) - dq(0, 1)) * 0.5]
    ds2 = _sum3(v(ws[0]) * dws[0], v(ws[1]) * dws[1], v(ws[2]) * dws[2]) * 2.0
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
    da2 = _sum3(v(ax[0]) * dax[0], v(ax[1]) * dax[1], v(ax[2]) * dax[2]) * 2.0
    dnrm = torch.where(v(a_pos), da2 / v(nrm * 2.0), zero)
    dw = [torch.where(v(near), ((dx - v(x) * dnrm) / v(nrm)) * v(theta) + v(x) * dtheta, g)
          for dx, x, g in zip(dax, axn, dw_gen)]
    return w, torch.stack(dw, -1)


def _blocks(tl, tr, bl, br):
    """A [..., 6, 6] from its four [..., 3, 3] blocks."""
    return torch.cat([torch.cat([tl, tr], -1), torch.cat([bl, br], -1)], -2)


def _row(J, rw):
    """A factor's terms at one endpoint, [..., 42]: -J^T r (6), J^T J (36),
    each summed over the residual rows in index order."""
    t = J * rw[..., None]
    jr = t[..., 0, :]
    for s in range(1, J.shape[-2]):
        jr = jr + t[..., s, :]
    jj = J[..., :, :, None] * J[..., :, None, :]
    acc = jj[..., 0, :, :]
    for s in range(1, J.shape[-2]):
        acc = acc + jj[..., s, :, :]
    return torch.cat([-jr, acc.flatten(-2)], -1)


def _take(x, idx):
    """x [B, K, ...] at idx [B, n] -> [B, n, ...]."""
    tail = x.shape[2:]
    return torch.gather(x, 1, idx.reshape(*idx.shape, *(1,) * len(tail)).expand(*idx.shape, *tail))


def factor_rows_plain(Rs, ts, e_i, e_j, e_Rm, e_tm, e_sqrt_info, e_cauchy, e_mask, g_i, g_t,
                      g_sqrt_info, g_mask, p_i, prior_R, prior_t, prior_sqrt_info, free_mask):
    """Phase A of the kernel in torch ops: (Ji, Jj, Jg, Jp, rows [B, M, 42]),
    the rows in the plan's unsorted order (Ji's at e_i, Jj's at e_j, GPS at
    g_i, the prior at p_i)."""
    f32 = Rs.dtype
    fm = free_mask.to(f32)
    eye = torch.eye(3, dtype=f32, device=Rs.device)
    zero3 = torch.zeros_like(eye)

    # between factors
    Ri, Rj, ti, tj = _take(Rs, e_i), _take(Rs, e_j), _take(ts, e_i), _take(ts, e_j)
    P = _mtm(Ri, Rj)
    Q = _mtm(e_Rm, P)
    u = _mtv(Ri, tj - ti)
    dQ = torch.cat([_mtm(e_Rm[..., None, :, :], _hat_p(P)), _q_hat(Q)], -3)
    w_log, dw = _log_jvp(Q, dQ)
    A = dw.transpose(-1, -2)  # [..., 3, 6]: columns w_i then w_j
    Ji0 = _blocks(A[..., :3], zero3.expand_as(P), hat(u), (-eye).expand_as(P))
    Jj0 = _blocks(A[..., 3:], zero3.expand_as(P), zero3.expand_as(P), P)
    rw = torch.cat([w_log, u - e_tm], -1) * e_sqrt_info
    rn2 = rw[..., 0] * rw[..., 0]
    for s in range(1, 6):
        rn2 = rn2 + rw[..., s] * rw[..., s]
    c = e_cauchy
    w_rob = torch.where(c > 0, torch.reciprocal(1.0 + rn2 / torch.clamp(c * c, min=1e-12)),
                        torch.ones_like(c))
    w = torch.sqrt(w_rob) * e_mask.to(f32)
    rw = rw * w[..., None]
    Ji = ((Ji0 * e_sqrt_info[..., None]) * w[..., None, None]) * _take(fm, e_i)[..., None, None]
    Jj = ((Jj0 * e_sqrt_info[..., None]) * w[..., None, None]) * _take(fm, e_j)[..., None, None]

    # GPS factors
    Rg = _take(Rs, g_i)
    gm = g_mask.to(f32)
    rg = ((_take(ts, g_i) - g_t) * g_sqrt_info) * gm[..., None]
    Jg0 = torch.cat([torch.zeros_like(Rg), Rg], -1)
    Jg = ((Jg0 * g_sqrt_info[..., None]) * gm[..., None, None]) * _take(fm, g_i)[..., None, None]

    # the prior (a factor axis of one)
    Rp, tp = _take(Rs, p_i), _take(ts, p_i)
    Qp = _mtm(prior_R[:, None], Rp)
    wp, dwp = _log_jvp(Qp, _q_hat(Qp))
    Jp0 = _blocks(dwp.transpose(-1, -2), zero3.expand_as(Rp), zero3.expand_as(Rp), Rp)
    psi = prior_sqrt_info[:, None]
    rp = torch.cat([wp, tp - prior_t[:, None]], -1) * psi
    Jp = (Jp0 * psi[..., None]) * _take(fm, p_i)[..., None, None]

    rows = torch.cat([_row(Ji, rw), _row(Jj, rw), _row(Jg, rg), _row(Jp, rp)], 1)
    return Ji, Jj, Jg, Jp[:, 0], rows


def linearize_normal_plain(Rs, ts, e_i, e_j, e_Rm, e_tm, e_sqrt_info, e_cauchy, e_mask, g_i, g_t,
                           g_sqrt_info, g_mask, p_i, prior_R, prior_t, prior_sqrt_info, free_mask,
                           keys, perm):
    """Plain PyTorch version of :func:`linearize_normal` (same arguments),
    in the kernel's order of operations. On CPU tensors the node sums add
    in the plan's order (``index_add``); on the card ``index_add``'s
    atomics do not keep it."""
    Ji, Jj, Jg, Jp, rows = factor_rows_plain(
        Rs, ts, e_i, e_j, e_Rm, e_tm, e_sqrt_info, e_cauchy, e_mask, g_i, g_t, g_sqrt_info,
        g_mask, p_i, prior_R, prior_t, prior_sqrt_info, free_mask)
    sums = segment_sum_plain(rows, perm, keys, Rs.shape[1])
    B, K = sums.shape[:2]
    rhs = sums[..., :6].contiguous()
    diag = sums[..., 6:].reshape(B, K, 6, 6).contiguous()
    return rhs, diag, Ji, Jj, Jg, Jp


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_FLOAT = ("Rs", "ts", "e_Rm", "e_tm", "e_sqrt_info", "e_cauchy", "g_t", "g_sqrt_info",
          "prior_R", "prior_t", "prior_sqrt_info")
_BOOL = ("e_mask", "g_mask", "free_mask")
ARGS = ("Rs", "ts", "e_i", "e_j", "e_Rm", "e_tm", "e_sqrt_info", "e_cauchy", "e_mask", "g_i",
        "g_t", "g_sqrt_info", "g_mask", "p_i", "prior_R", "prior_t", "prior_sqrt_info",
        "free_mask", "keys", "perm")


def _shapes(B, K, E, G):
    M = 2 * E + G + 1
    return dict(Rs=(B, K, 3, 3), ts=(B, K, 3), e_i=(B, E), e_j=(B, E), e_Rm=(B, E, 3, 3),
                e_tm=(B, E, 3), e_sqrt_info=(B, E, 6), e_cauchy=(B, E), e_mask=(B, E),
                g_i=(B, G), g_t=(B, G, 3), g_sqrt_info=(B, G, 3), g_mask=(B, G), p_i=(B, 1),
                prior_R=(B, 3, 3), prior_t=(B, 3), prior_sqrt_info=(B, 6), free_mask=(B, K),
                keys=(B, M), perm=(B, M))


def _launch(*tensors, keep_rows: bool = False):
    """The kernel on every lane: (rhs, diag, Ji, Jj, Jg, Jp), and with
    ``keep_rows`` also phase A's rows [B, M, 42] (for checks)."""
    args = dict(zip(ARGS, tensors))
    dev = args["Rs"].device
    B, K = args["Rs"].shape[:2]
    E, G = args["e_i"].shape[1], args["g_i"].shape[1]
    want = _shapes(B, K, E, G)
    for name, t in args.items():
        dtype = (torch.float32 if name in _FLOAT else torch.bool if name in _BOOL
                 else torch.int64)
        if t.dtype != dtype or tuple(t.shape) != want[name] or t.device != dev:
            raise ValueError(f"linearize_normal: {name} {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected {dtype} {want[name]} on {dev}")
    args = {k: t.contiguous() for k, t in args.items()}
    M = 2 * E + G + 1
    f32 = dict(dtype=torch.float32, device=dev)
    out = [torch.empty(s, **f32) for s in ((B, K, 6), (B, K, 6, 6), (B, E, 6, 6), (B, E, 6, 6),
                                             (B, G, 3, 6), (B, 6, 6))]
    rows = torch.empty((B, M, ROW), **f32)
    flags = torch.empty((B, M), dtype=torch.int32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.liorf_linearize(
            *(t.data_ptr() for t in args.values()), *(t.data_ptr() for t in out),
            rows.data_ptr(), flags.data_ptr(), B, K, E, G,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"linearize_normal: CUDA launch failed with error {err}")
    linearize_normal.launches += 1
    return (*out, rows) if keep_rows else tuple(out)


@torch.library.custom_op("liorf_tpu_torch::linearize_normal", mutates_args=())
def _linearize_op(Rs: torch.Tensor, ts: torch.Tensor, e_i: torch.Tensor, e_j: torch.Tensor,
                  e_Rm: torch.Tensor, e_tm: torch.Tensor, e_sqrt_info: torch.Tensor,
                  e_cauchy: torch.Tensor, e_mask: torch.Tensor, g_i: torch.Tensor,
                  g_t: torch.Tensor, g_sqrt_info: torch.Tensor, g_mask: torch.Tensor,
                  p_i: torch.Tensor, prior_R: torch.Tensor, prior_t: torch.Tensor,
                  prior_sqrt_info: torch.Tensor, free_mask: torch.Tensor, keys: torch.Tensor,
                  perm: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor]:
    # The op on any device but CUDA is the plain version (the CPU path and
    # the tests reach the vmap rule through it).
    return linearize_normal_plain(Rs, ts, e_i, e_j, e_Rm, e_tm, e_sqrt_info, e_cauchy, e_mask,
                                  g_i, g_t, g_sqrt_info, g_mask, p_i, prior_R, prior_t,
                                  prior_sqrt_info, free_mask, keys, perm)


@_linearize_op.register_kernel("cuda")
def _linearize_cuda(*args):
    return _launch(*args)


@_linearize_op.register_vmap
def _linearize_vmap(info, in_dims, *args):
    """Lanes of a vmap fold into the op's own [B] axis: one launch."""
    n = info.batch_size
    out = _linearize_op(*(_fold_lanes(t, d, n) for t, d in zip(args, in_dims)))
    return tuple(o.reshape(n, -1, *o.shape[1:]) for o in out), (0,) * len(out)


def linearize_normal(Rs, ts, e_i, e_j, e_Rm, e_tm, e_sqrt_info, e_cauchy, e_mask, g_i, g_t,
                     g_sqrt_info, g_mask, p_i, prior_R, prior_t, prior_sqrt_info, free_mask,
                     keys, perm):
    """(rhs [B,K,6], diag [B,K,6,6], Ji [B,E,6,6], Jj [B,E,6,6], Jg [B,G,3,6],
    Jp [B,6,6]) of a pose graph's GN step: the ``PoseGraph`` fields with a
    lane axis (``p_i`` [B,1] the prior's node), ``free_mask`` [B,K] (False:
    the node is frozen, its Jacobian columns zero), and ``keys`` / ``perm``
    [B, 2E+G+1], the stable sort of ``cat([e_i, e_j, g_i, p_i])``
    (``SegmentPlan.sorted_rows``), the order of every node's sums. One call
    on the card for every lane (a vmapped call's lanes included)."""
    if Rs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"linearize_normal: unsupported device {Rs.device}")
    return _linearize_op(Rs, ts, e_i, e_j, e_Rm, e_tm, e_sqrt_info, e_cauchy, e_mask, g_i, g_t,
                         g_sqrt_info, g_mask, p_i, prior_R, prior_t, prior_sqrt_info, free_mask,
                         keys, perm)


linearize_normal.launches = 0


def launch_counts() -> dict[str, int]:
    return {"linearize_normal": linearize_normal.launches}


def reset_launch_counts() -> None:
    linearize_normal.launches = 0
