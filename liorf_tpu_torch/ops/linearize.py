"""The pose graph's linearization and normal-equation sums of one
Gauss-Newton step in one kernel.

Not a TPU kernel. The JAX package jits ``_build_normal_terms``
(``liorf_tpu/graph/pose_graph.py:99-117,141-202``: ``jacfwd`` of each
factor's residual under ``vmap``, whitening, the Cauchy weight, the masks,
then ``.at[].add`` of J^T r and J^T J per node) into a few fused XLA
programs; op by op on the card it was thousands of launches a GN step. The
kernel (``csrc/linearize.cu``, one launch: a cluster of blocks a lane, a
factor on a group of eight threads, the node sums after the cluster's
barrier) forms each factor's residual and Jacobians in closed form, weights
and masks them, writes the J blocks the PCG kernel (``ops/pcg.py``) reads
and each factor's J^T r and J^T J terms, then sums every node's terms in
the order of the solve's ``SegmentPlan`` (a node's rows where its sorted
keys change value).

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
``pipeline/multistream.py`` (``torch.func.vmap``) folds into the launch; a
call with no vmap around it launches without the op's dispatch, its outputs
and scratch views of one allocation, its 28 addresses one packed array.
"""

from __future__ import annotations

import ctypes
import math
from array import array
from pathlib import Path

import torch
from torch._C import _functorch

from ..core.build import build_cuda_library, raw_stream
from ..core.se3 import hat
from ..core.so3_jvp import hat_p, log_jvp, mtm, mtv, q_hat
from .segment_sum import _fold_lanes, segment_sum_plain

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "linearize.cu"

ROW = 42  # a plan row: the factor's -J^T r (6) and J^T J (36) at one endpoint

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
    lib.liorf_linearize.argtypes = [vp, ci, ci, ci, ci, ci, vp]
    lib.liorf_linearize.restype = ci
    lib.liorf_linearize_kernel_launches.argtypes = []
    lib.liorf_linearize_kernel_launches.restype = ctypes.c_longlong
    _lib = lib
    return lib


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

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
    P = mtm(Ri, Rj)
    Q = mtm(e_Rm, P)
    u = mtv(Ri, tj - ti)
    dQ = torch.cat([mtm(e_Rm[..., None, :, :], hat_p(P)), q_hat(Q)], -3)
    w_log, dw = log_jvp(Q, dQ)
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
    Qp = mtm(prior_R[:, None], Rp)
    wp, dwp = log_jvp(Qp, q_hat(Qp))
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
_DTYPES = tuple(torch.float32 if n in _FLOAT else torch.bool if n in _BOOL else torch.int64
                for n in ARGS)


def _shapes(B, K, E, G):
    M = 2 * E + G + 1
    return dict(Rs=(B, K, 3, 3), ts=(B, K, 3), e_i=(B, E), e_j=(B, E), e_Rm=(B, E, 3, 3),
                e_tm=(B, E, 3), e_sqrt_info=(B, E, 6), e_cauchy=(B, E), e_mask=(B, E),
                g_i=(B, G), g_t=(B, G, 3), g_sqrt_info=(B, G, 3), g_mask=(B, G), p_i=(B, 1),
                prior_R=(B, 3, 3), prior_t=(B, 3), prior_sqrt_info=(B, 6), free_mask=(B, K),
                keys=(B, M), perm=(B, M))


def _out_shapes(B, K, E, G):
    """(rhs, diag, Ji, Jj, Jg, Jp) and the scratch rows [B, M, 42], then the
    flags [B, M] (int32, in the same float32 buffer)."""
    M = 2 * E + G + 1
    return ((B, K, 6), (B, K, 6, 6), (B, E, 6, 6), (B, E, 6, 6), (B, G, 3, 6), (B, 6, 6),
            (B, M, ROW), (B, M))


def _checked(tensors) -> list:
    """The arguments as the kernel takes them (contiguous), or ValueError: a
    dtype, shape or device it does not take."""
    if len(tensors) != len(ARGS):
        raise ValueError(f"linearize_normal: {len(tensors)} arguments, expected {len(ARGS)}")
    Rs, e_i, g_i = tensors[0], tensors[2], tensors[9]
    dev = Rs.device
    if Rs.dim() != 4 or e_i.dim() != 2 or g_i.dim() != 2:
        raise ValueError(f"linearize_normal: Rs {tuple(Rs.shape)}, e_i {tuple(e_i.shape)}, "
                         f"g_i {tuple(g_i.shape)}: expected [B, K, 3, 3], [B, E], [B, G]")
    want = _shapes(Rs.shape[0], Rs.shape[1], e_i.shape[1], g_i.shape[1])
    out = []
    for name, t, dtype in zip(ARGS, tensors, _DTYPES):
        if t.dtype is not dtype or t.shape != want[name] or t.device != dev:
            raise ValueError(f"linearize_normal: {name} {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected {dtype} {want[name]} on {dev}")
        out.append(t if t.is_contiguous() else t.contiguous())
    return out


_LAYOUTS: dict = {}  # (B, K, E, G) -> the outputs' and the scratch's places in one buffer


def _layout(B, K, E, G):
    """(size, stride, offset) of the six outputs, the rows and the flags in
    one float32 buffer, one after the other, and the buffer's length."""
    key = (B, K, E, G)
    if key not in _LAYOUTS:
        views, off = [], 0
        for shape in _out_shapes(B, K, E, G):
            views.append((shape, tuple(math.prod(shape[k + 1:]) for k in range(len(shape))), off))
            off += math.prod(shape)
        _LAYOUTS[key] = (tuple(views), off)
    return _LAYOUTS[key]


def _buffer(B, K, E, G, dev, outputs_apart: bool, keep_rows: bool = False):
    """The outputs and the scratch in one allocation (the outputs views of
    it), or (``outputs_apart``, a custom op's outputs may not alias) one
    tensor an output and one for the scratch. Returns (outputs, the rows
    [B, M, 42] when ``keep_rows``, the addresses of the eight)."""
    views, total = _layout(B, K, E, G)
    if outputs_apart:
        out = [torch.empty(v[0], dtype=torch.float32, device=dev) for v in views[:6]]
        scratch = torch.empty(total - views[6][2], dtype=torch.float32, device=dev)
        at = scratch.data_ptr() - 4 * views[6][2]
        rows = scratch.as_strided(views[6][0], views[6][1], 0) if keep_rows else None
        return out, rows, [t.data_ptr() for t in out] + [at + 4 * v[2] for v in views[6:]]
    buf = torch.empty(total, dtype=torch.float32, device=dev)
    at = buf.data_ptr()
    rows = buf.as_strided(*views[6]) if keep_rows else None
    return [buf.as_strided(*v) for v in views[:6]], rows, [at + 4 * v[2] for v in views]


def _run(lib, ptrs, B, K, E, G, dev) -> None:
    """The ctypes call: the 28 addresses packed in one array."""
    packed = array("q", ptrs)
    err = lib.liorf_linearize(packed.buffer_info()[0], B, K, E, G, dev.index,
                              raw_stream(dev.index))
    if err != 0:
        raise RuntimeError(f"linearize_normal: CUDA launch failed with error {err}")


def _launch(*tensors, keep_rows: bool = False, outputs_apart: bool = False):
    """The kernel on every lane: (rhs, diag, Ji, Jj, Jg, Jp), and with
    ``keep_rows`` also phase A's rows [B, M, 42] (for checks)."""
    ins = _checked(tensors)
    dev = ins[0].device
    B, K = ins[0].shape[:2]
    E, G = ins[2].shape[1], ins[9].shape[1]
    out, rows, ptrs = _buffer(B, K, E, G, dev, outputs_apart, keep_rows)
    _run(load_library(), [t.data_ptr() for t in ins] + ptrs, B, K, E, G, dev)
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
    return _launch(*args, outputs_apart=True)


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
    if Rs.device.type == "cuda" and _functorch.maybe_current_level() is None:
        # no vmap around the call: the launch without the custom op's dispatch
        return _launch(Rs, ts, e_i, e_j, e_Rm, e_tm, e_sqrt_info, e_cauchy, e_mask, g_i, g_t,
                       g_sqrt_info, g_mask, p_i, prior_R, prior_t, prior_sqrt_info, free_mask,
                       keys, perm)
    if Rs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"linearize_normal: unsupported device {Rs.device}")
    return _linearize_op(Rs, ts, e_i, e_j, e_Rm, e_tm, e_sqrt_info, e_cauchy, e_mask, g_i, g_t,
                         g_sqrt_info, g_mask, p_i, prior_R, prior_t, prior_sqrt_info, free_mask,
                         keys, perm)


linearize_normal.launches = 0


def launch_counts() -> dict[str, int]:
    return {"linearize_normal": linearize_normal.launches}


def kernel_launches() -> int:
    """Kernels the library has launched in this process (its own count)."""
    return int(load_library().liorf_linearize_kernel_launches())


def reset_launch_counts() -> None:
    linearize_normal.launches = 0
