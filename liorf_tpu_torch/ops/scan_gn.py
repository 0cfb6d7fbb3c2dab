"""The scan matcher's Gauss-Newton iteration in two hand-written kernels.

Not a TPU kernel. The JAX package does this work in XLA
(``liorf_tpu/ops/scan_match.py:83-121`` and ``:164-195``,
``liorf_tpu/ops/plane_fit.py:22-55``); op by op on the card a GN iteration
was ~40 eager launches and two library solvers (a batched ``eigh`` of the
[N, 3, 3] scatter matrices, ``solve`` of the [B, 6, 6] systems, and on the
first iteration ``eigh`` of them), each making the host wait for the card.
The kernels (``csrc/scan_gn.cu``) do one GN iteration of every lane in two
calls of one kernel launch each, around kernel K1 (the 5-NN search, which
stays its own launch):

* :func:`scan_linearize` — (H [B, 6, 6], g [B, 6], count [B]) of the
  point-to-plane system at the lanes' poses: each point's world position,
  the 5th-NN gate, its 5 neighbours read from the grid by K1's indices, the
  plane through them (scatter matrix, cyclic Jacobi in float32,
  ``ops/plane_fit.py``), the residual gate and weight, its row of J and its
  share of b, summed over the points in a fixed order.
* :func:`scan_update` — the GN step of every lane: on the first iteration the
  6x6 eigen-decomposition of H (Jacobi, float64: its sweeps' operations in
  their order, run as a program of waves, ``csrc/jacobi6_waves.cuh``) and
  its degeneracy projection, then ``solve(H + 1e-6 I, g)`` (LU with partial
  pivoting, float64), the projection, the frozen lanes, the convergence
  test, the moved scan for the next K1 and one "all lanes done" flag, the
  only value the host reads an iteration.
* :func:`transform` — points moved by their lanes' poses: a match's first K1
  queries (and ICP's first K2 queries).

Each kernel finishes its lanes' work in one launch through arrival counters
(:func:`arrival_counters`): the last tile of a lane takes the sum over the
tiles, the last lane writes the all-done flag, and each sets its counter
back to 0, so no launch clears them.

The order contract (the kernels keep it, this module spells it): every
operation is rounded on its own; a 3-term product sum is
``(a0 b0 + a1 b1) + a2 b2``; a sum over a point's neighbours, or over the 6
entries of a row, is ``ops/fusion_step.py::tree_sum``'s halving tree; a sum
over the points is :func:`tiled_sum` (the halving tree within tiles of
``TILE`` points, then over the tiles), masked points as +0.0; sin and cos of
a pose are taken in float64 and rounded to float32. It depends on the point
count alone, so a lane of a stacked call has the bits of a call on that lane.
On the card the kernels and these plain versions agree bit for bit.

Dispatch by the tensor's device and nothing else: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from ..core.build import build_cuda_library
from .fusion_step import tree_sum
from .plane_fit import dot3, fit_planes, jacobi_eigh

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "scan_gn.cu"

TILE = 128  # points a tile: the first level of every sum over points (gn_common.cuh::kTile)
# Sweeps of the float64 6x6 solve: over 3000 seeded matrices the largest
# off-diagonal entry left over the largest input entry was 1.5e-10 after 6
# sweeps, 6.6e-27 after 7 and 1.4e-54 after 8.
JACOBI6_SWEEPS = 8
RAD2DEG = 57.29577951308232
TERMS = 28  # a point's share: H's upper triangle (21, row by row), g (6), the count
_UPPER = [(i, j) for i in range(6) for j in range(i, 6)]

_lib = None
build_seconds: float | None = None  # wall time of the nvcc run, if one was needed


def load_library(extra_flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    so, build_seconds = build_cuda_library(_SOURCE, extra_flags)
    lib = ctypes.CDLL(str(so))
    vp, ci, cf, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
    lib.liorf_scan_linearize.argtypes = [vp] * 12 + [cf] * 3 + [ci] * 3 + [vp]
    lib.liorf_scan_linearize.restype = ci
    lib.liorf_scan_update.argtypes = [vp] * 19 + [cd, cf, cf, ci, ci, ci, ci, vp]
    lib.liorf_scan_update.restype = ci
    lib.liorf_scan_transform.argtypes = [vp] * 3 + [ci] * 2 + [vp]
    lib.liorf_scan_transform.restype = ci
    lib.liorf_scan_gn_kernel_launches.argtypes = []
    lib.liorf_scan_gn_kernel_launches.restype = ctypes.c_longlong
    _lib = lib
    return lib


_arrivals: dict = {}


def arrival_counters(dev: torch.device, kind: str, n: int) -> torch.Tensor:
    """At least ``n`` arrival counters of the ``kind`` kernel ("linearize":
    one a lane, "update": one) on ``dev``. They are 0 between launches: the
    last tile or lane to arrive sets its counter back, so the tensor is
    zeroed once, when it is made. Launches of one kind on ``dev`` run one at
    a time (one stream), as every caller in the package makes them."""
    t = _arrivals.get((dev, kind))
    if t is None or t.numel() < n:
        t = torch.zeros((max(n, 8),), dtype=torch.int32, device=dev)
        _arrivals[(dev, kind)] = t
    return t


class GNState(NamedTuple):
    """The batched GN loop's state a lane."""
    pose: torch.Tensor  # [B, 6] float32 rpyxyz
    P: torch.Tensor  # [B, 6, 6] float64 degeneracy projection (first iteration's)
    degenerate: torch.Tensor  # [B] bool
    done: torch.Tensor  # [B] bool: the lane's own loop would have stopped
    count: torch.Tensor  # [B] int32 matches of the lane's last live linearization
    iters: torch.Tensor  # [B] int32 live iterations


def init_state(pose: torch.Tensor) -> GNState:
    B, dev = pose.shape[0], pose.device
    zb = torch.zeros((B,), dtype=torch.bool, device=dev)
    zi = torch.zeros((B,), dtype=torch.int32, device=dev)
    P = torch.eye(6, dtype=torch.float64, device=dev).expand(B, 6, 6).contiguous()
    return GNState(pose.to(torch.float32).contiguous(), P, zb, zb.clone(), zi, zi.clone())


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def tiled_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum of ``x`` along ``dim`` in the kernels' order: zeros padded to a
    whole number of tiles of ``TILE``, the halving tree within each tile,
    then the halving tree over the tiles (zeros padded to a power of two)."""
    dim = dim % x.dim()
    n = x.shape[dim]
    tiles = max(1, -(-n // TILE))
    if tiles * TILE > n:
        pad = list(x.shape)
        pad[dim] = tiles * TILE - n
        x = torch.cat([x, x.new_zeros(pad)], dim)
    x = x.reshape(*x.shape[:dim], tiles, TILE, *x.shape[dim + 1:])
    return tree_sum(tree_sum(x, dim + 1), dim)


def _trig(rpy: torch.Tensor):
    """cos and sin of [..., 3] euler angles, in float64 rounded to float32."""
    r = rpy.double()
    return torch.cos(r).float(), torch.sin(r).float()


def _mat(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def rot_f32(rpy: torch.Tensor) -> torch.Tensor:
    """[..., 3] euler -> [..., 3, 3] R = Rz Ry Rx (``core/se3.py::euler_to_rot``'s
    products), cos and sin in float64 rounded to float32
    (``csrc/gn_common.cuh::rot_f32``)."""
    c, s = _trig(rpy)
    return _rot(c, s)


def _rot(c, s):
    cr, cp, cy = c[..., 0], c[..., 1], c[..., 2]
    sr, sp, sy = s[..., 0], s[..., 1], s[..., 2]
    return _mat([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ])


def rot_derivatives(rpy: torch.Tensor) -> torch.Tensor:
    """[..., 3] euler -> [..., 3, 3, 3]: dR/d(roll), dR/d(pitch), dR/d(yaw) of
    :func:`rot_f32` in closed form (the products of the JAX package's
    ``_rot_derivatives``, ``liorf_tpu/ops/scan_match.py:63-81``, multiplied out)."""
    c, s = _trig(rpy)
    R = _rot(c, s)
    cr, cp, cy = c[..., 0], c[..., 1], c[..., 2]
    sr, sp, sy = s[..., 0], s[..., 1], s[..., 2]
    z = torch.zeros_like(cr)
    r = [[R[..., i, j] for j in range(3)] for i in range(3)]
    d_roll = _mat([[z, r[0][2], -r[0][1]], [z, r[1][2], -r[1][1]], [z, r[2][2], -r[2][1]]])
    d_pitch = _mat([
        [-(cy * sp), cy * cp * sr, cy * cp * cr],
        [-(sy * sp), sy * cp * sr, sy * cp * cr],
        [-cp, -(sp * sr), -(sp * cr)],
    ])
    d_yaw = _mat([[-r[1][0], -r[1][1], -r[1][2]], [r[0][0], r[0][1], r[0][2]], [z, z, z]])
    return torch.stack([d_roll, d_pitch, d_yaw], -3)


def _apply(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """M [B, 3, 3] on points x [B, N, 3]: ((M_r0 x0 + M_r1 x1) + M_r2 x2) a row."""
    return torch.stack([dot3(M[:, None, r, :], x) for r in range(3)], -1)


def transform_plain(pose: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """R p + t of points [B, N, 3] by poses [B, 6] (:func:`rot_f32`), in the
    kernels' order: the scan as K1 and K2 query it."""
    return _apply(rot_f32(pose[:, :3]), xyz) + pose[:, None, 3:]


def point_terms(normal, d, valid, world, scan_xyz, dR, scan_norm_quarter, scan_mask, gate,
                min_weight) -> torch.Tensor:
    """Each point's share [B, N, 28] of (H's upper triangle, g, count): the
    plane residual pd2 = n.world + d, its weight s = 1 - 0.9 |pd2| / |p|^(1/4),
    J = [n . (dR_k p), n] s, b = -s pd2; +0.0 where the point is not selected.

    An eigenvector's sign does not change the share: with (-n, -d) pd2, J and
    b change sign together, |pd2| does not, and J_i J_j and J_i b keep their
    bits (negation is exact)."""
    pd2 = dot3(normal, world) + d
    s = 1.0 - 0.9 * torch.abs(pd2) / scan_norm_quarter
    sel = scan_mask & gate & valid & (s > min_weight)
    w = torch.where(sel, s, 0.0)
    jr = torch.stack([dot3(normal, _apply(dR[:, k], scan_xyz)) for k in range(3)], -1)
    J = torch.cat([jr, normal], -1) * w[..., None]  # [B, N, 6]
    b = -(w * pd2)
    terms = [J[..., i] * J[..., j] for i, j in _UPPER] + [J[..., i] * b for i in range(6)]
    terms.append(torch.ones_like(b))
    return torch.where(sel[..., None], torch.stack(terms, -1), 0.0)


def _system(sums: torch.Tensor):
    """(H [B, 6, 6], g [B, 6], count [B] int32) of the summed shares."""
    at = {ij: k for k, ij in enumerate(_UPPER)}
    H = torch.stack([torch.stack([sums[:, at[min(i, j), max(i, j)]] for j in range(6)], -1)
                     for i in range(6)], -2)
    return H.contiguous(), sums[:, 21:27].contiguous(), sums[:, 27].to(torch.int32)


def scan_linearize_plain(pose, scan_xyz, scan_mask, scan_norm_quarter, d2, idx, grid_xyz,
                         corr_dist, plane_max_resid, min_weight):
    """Plain PyTorch version of :func:`scan_linearize` (same arguments, the
    thresholds as floats), in the kernel's order of operations."""
    B, N = scan_mask.shape
    R = rot_f32(pose[:, :3])
    world = _apply(R, scan_xyz) + pose[:, None, 3:]
    gate = d2[..., 4] < corr_dist * corr_dist
    nbr_mask = torch.isfinite(d2) & gate[..., None]
    nb = torch.gather(grid_xyz, 1, idx.long().reshape(B, N * 5, 1).expand(-1, -1, 3))
    fit = fit_planes(nb.reshape(B * N, 5, 3), nbr_mask.reshape(B * N, 5), plane_max_resid)
    terms = point_terms(fit.normal.reshape(B, N, 3), fit.d.reshape(B, N), fit.valid.reshape(B, N),
                        world, scan_xyz, rot_derivatives(pose[:, :3]), scan_norm_quarter,
                        scan_mask, gate, min_weight)
    return _system(tiled_sum(terms, 1))


def lu_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x of A x = b ([B, n, n], [B, n]) by LU with partial pivoting (the first
    largest pivot, as LAPACK's getrf) on [A | b], then back substitution,
    each row's sum a halving tree."""
    B, n = b.shape
    M = torch.cat([A, b[..., None]], -1)
    rows = torch.arange(n, device=A.device)[:, None]
    cols = torch.arange(n + 1, device=A.device)
    for k in range(n):
        piv = torch.full((B,), k, dtype=torch.long, device=A.device)
        best = torch.abs(M[:, k, k])
        for r in range(k + 1, n):
            v = torch.abs(M[:, r, k])
            gt = v > best
            piv = torch.where(gt, r, piv)
            best = torch.where(gt, v, best)
        rk = M[:, k, :]
        rp = torch.gather(M, 1, piv[:, None, None].expand(-1, 1, n + 1))[:, 0]
        M = torch.where(rows == k, rp[:, None, :],
                        torch.where(rows == piv[:, None, None], rk[:, None, :], M))
        l = M[:, :, k] / M[:, k, k, None]
        upd = M - l[:, :, None] * M[:, k, None, :]
        M = torch.where((rows > k) & (cols > k), upd, M)
    jj = torch.arange(n, device=A.device)
    x = torch.zeros_like(b)
    for k in reversed(range(n)):
        s = tree_sum(torch.where(jj > k, M[:, k, :n] * x, 0.0), 1)
        x = torch.where(jj == k, ((M[:, k, n] - s) / M[:, k, k])[:, None], x)
    return x


def _norm3(x):
    return torch.sqrt((x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]) + x[:, 2] * x[:, 2])


def scan_update_plain(state: GNState, H, g, cnt, scan_xyz, params, first: bool):
    """Plain PyTorch version of :func:`scan_update`, in the kernel's order of
    operations: (the new GNState, the scan moved by the new poses [B, N, 3],
    all lanes done [1] bool)."""
    Hd = H.double()
    if first:
        # Degeneracy analysis on the first iteration only (reference :1242);
        # every lane is on its first iteration together. P = V_good V_good^T
        # depends neither on the eigenvectors' signs nor on the basis inside
        # the good subspace.
        lam, V = jacobi_eigh(Hd, JACOBI6_SWEEPS)
        good = lam >= params.eigen_thresh
        outer = V[:, :, None, :] * V[:, None, :, :]  # [B, i, j, k] = V_ik V_jk
        P = tree_sum(torch.where(good[:, None, None, :], outer, 0.0), -1)
        degenerate = ~torch.all(good, dim=-1)
    else:
        P, degenerate = state.P, state.degenerate
    A = Hd.clone()
    A.diagonal(dim1=-2, dim2=-1).add_(1e-6)
    x = lu_solve(A, g.double())
    x = torch.where(degenerate[:, None], tree_sum(P * x[:, None, :], -1), x)
    enough = cnt >= params.min_points
    xf = torch.where(enough[:, None], x.float(), 0.0)
    live = ~state.done
    pose = torch.where(live[:, None], state.pose + xf, state.pose)
    count = torch.where(live, cnt, state.count)
    iters = state.iters + live.to(torch.int32)
    delta_rot = _norm3(xf[:, :3]) * RAD2DEG
    delta_trans = _norm3(xf[:, 3:]) * 100.0
    converged = (delta_rot < params.conv_rot_deg) & (delta_trans < params.conv_trans_cm)
    done = state.done | (converged | ~enough)
    new = GNState(pose, P, degenerate, done, count, iters)
    return new, transform_plain(pose, scan_xyz), torch.all(done).reshape(1)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _check(t: torch.Tensor, name: str, dtype, shape, device) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return t


def _device(t: torch.Tensor, what: str) -> torch.device:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device


def transform(pose: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Points [B, N, 3] moved by their lanes' poses [B, 6]: the first K1 or K2
    queries of a match (the updates move the later ones). One call on the
    card for every lane."""
    if _device(xyz, "transform").type == "cpu":
        return transform_plain(pose, xyz)
    return _launch_transform(pose, xyz)


def _launch_transform(pose, xyz):
    dev = xyz.device
    B, N = xyz.shape[:2]
    _check(pose, "pose", torch.float32, (B, 6), dev)
    _check(xyz, "xyz", torch.float32, (B, N, 3), dev)
    out = torch.empty((B, N, 3), dtype=torch.float32, device=dev)
    if B == 0 or N == 0:
        return out
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.liorf_scan_transform(pose.data_ptr(), xyz.data_ptr(), out.data_ptr(), B, N,
                                       torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"transform: CUDA launch failed with error {err}")
    transform.launches += 1
    return out


transform.launches = 0


def scan_linearize(pose, scan_xyz, scan_mask, scan_norm_quarter, d2, idx, grid_xyz, params):
    """(H [B, 6, 6], g [B, 6], count [B] int32) of every lane at its pose:
    pose [B, 6], scan [B, N, 3] + mask [B, N] (sensor frame), |p|^(1/4)
    [B, N], K1's (d2, idx) [B, N, 5] of the moved scan, the grid's sorted
    points [B, M, 3]. One call on the card for every lane."""
    args = (pose, scan_xyz, scan_mask, scan_norm_quarter, d2, idx, grid_xyz,
            params.corr_dist, params.plane_max_resid, params.min_weight)
    if _device(pose, "scan_linearize").type == "cpu":
        return scan_linearize_plain(*args)
    return _launch_linearize(*args)


def _launch_linearize(pose, scan_xyz, scan_mask, scan_norm_quarter, d2, idx, grid_xyz,
                      corr_dist, plane_max_resid, min_weight):
    dev = pose.device
    B, N = scan_mask.shape
    M = grid_xyz.shape[1]
    if N >= 1 << 24:
        raise ValueError(f"scan_linearize: {N} points a lane; the count is summed in float32")
    f32 = torch.float32
    ins = [_check(pose, "pose", f32, (B, 6), dev), _check(scan_xyz, "scan_xyz", f32, (B, N, 3), dev),
           _check(scan_mask, "scan_mask", torch.bool, (B, N), dev),
           _check(scan_norm_quarter, "scan_norm_quarter", f32, (B, N), dev),
           _check(d2, "d2", f32, (B, N, 5), dev), _check(idx, "idx", torch.int32, (B, N, 5), dev),
           _check(grid_xyz, "grid_xyz", f32, (B, M, 3), dev)]
    tiles = 1 << (max(1, -(-N // TILE)) - 1).bit_length()
    partial = torch.empty((B, tiles, TERMS), dtype=f32, device=dev)
    H = torch.empty((B, 6, 6), dtype=f32, device=dev)
    g = torch.empty((B, 6), dtype=f32, device=dev)
    count = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return H, g, count
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.liorf_scan_linearize(
            *(t.data_ptr() for t in ins), partial.data_ptr(), H.data_ptr(), g.data_ptr(),
            count.data_ptr(), arrival_counters(dev, "linearize", B).data_ptr(),
            corr_dist * corr_dist, plane_max_resid, min_weight, B, N, M,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"scan_linearize: CUDA launch failed with error {err}")
    scan_linearize.launches += 1
    return H, g, count


scan_linearize.launches = 0


def scan_update(state: GNState, H, g, cnt, scan_xyz, params, first: bool):
    """The GN step of every lane from its summed system (H [B, 6, 6], g [B, 6],
    count [B] int32): (the new GNState, the scan [B, N, 3] moved by the new
    poses for the next K1, all lanes done [1] bool). A lane already done
    keeps its pose, count and iterations (a vmapped ``lax.while_loop``'s
    frozen lane). One call on the card for every lane."""
    if _device(H, "scan_update").type == "cpu":
        return scan_update_plain(state, H, g, cnt, scan_xyz, params, first)
    return _launch_update(state, H, g, cnt, scan_xyz, params, first)


def _launch_update(state: GNState, H, g, cnt, scan_xyz, params, first: bool):
    dev = H.device
    B, N = scan_xyz.shape[:2]
    f32, b8, i32 = torch.float32, torch.bool, torch.int32
    ins = [_check(H, "H", f32, (B, 6, 6), dev), _check(g, "g", f32, (B, 6), dev),
           _check(cnt, "count", i32, (B,), dev), _check(state.pose, "pose", f32, (B, 6), dev),
           _check(state.P, "P", torch.float64, (B, 6, 6), dev),
           _check(state.degenerate, "degenerate", b8, (B,), dev),
           _check(state.done, "done", b8, (B,), dev),
           _check(state.count, "state.count", i32, (B,), dev),
           _check(state.iters, "iters", i32, (B,), dev),
           _check(scan_xyz, "scan_xyz", f32, (B, N, 3), dev)]
    new = GNState(*(torch.empty_like(t) for t in state))
    world = torch.empty((B, N, 3), dtype=f32, device=dev)
    all_done = torch.empty((1,), dtype=b8, device=dev)
    if B == 0:
        return new, world, all_done.fill_(True)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.liorf_scan_update(
            *(t.data_ptr() for t in ins), *(t.data_ptr() for t in new), world.data_ptr(),
            all_done.data_ptr(), arrival_counters(dev, "update", 1).data_ptr(),
            float(params.eigen_thresh), params.conv_rot_deg,
            params.conv_trans_cm, int(params.min_points), int(bool(first)), B, N,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"scan_update: CUDA launch failed with error {err}")
    scan_update.launches += 1
    return new, world, all_done


scan_update.launches = 0


def kernel_launches() -> int:
    """Kernels the library has launched in this process (one a call of each
    wrapper; the wrappers' ``launches`` count the calls)."""
    return int(load_library().liorf_scan_gn_kernel_launches())


def launch_counts() -> dict[str, int]:
    return {"scan_linearize": scan_linearize.launches, "scan_update": scan_update.launches,
            "transform": transform.launches}


def reset_launch_counts() -> None:
    scan_linearize.launches = 0
    scan_update.launches = 0
    transform.launches = 0
