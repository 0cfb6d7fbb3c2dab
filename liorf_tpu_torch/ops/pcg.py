"""The pose graph's block-Jacobi preconditioned conjugate gradients in one
launch: every iteration of a Gauss-Newton step's linear solve.

Not a TPU kernel. The JAX package runs this loop as one ``lax.scan``
(``liorf_tpu/graph/pose_graph.py:220-253``); op by op on the card each
iteration was ~59 launches (two fixed-order dots, a segment sum and the
products around them), each costing host time far above its work. The
kernel (``csrc/pcg.cu``) runs the whole loop on the card, one thread-block
cluster a lane, and keeps every reduction in a fixed order, so a solve
repeats bit for bit and a ring's unused (zero) slots change no bit of it.

* :func:`pcg_solve` — ``(H + damping I) x = rhs`` with ``H`` the sum of the
  factors' ``J^T J``, by ``iters`` iterations from ``x = 0``, with the
  block-Jacobi preconditioner ``Minv``. Every argument has a leading lane
  axis [B]; one launch on the card serves every lane.
* :func:`pcg_solve_plain` — the same function in torch ops, in the
  kernel's order of operations (on CPU tensors bit-equal to it).

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
from .segment_sum import _fold_lanes, fixed_dot_plain, segment_sum_plain

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "pcg.cu"

# Blocks a lane: 8, the portable cluster size. chip_smoke.py's pcg_profile
# times 1, 2, 4 and 8 at the main window, the resident full solve, the
# 8-lane tick and the main path's own window (PERF.md §6): 8 was the
# fastest or tied at every one, so no rule by size picks another.
CLUSTER = 8
# where a lane's arrays live (csrc/pcg.cu::lane_layout): on chip where they
# fit a block's shared memory, else device memory
DEVICE_MEMORY, ON_CHIP = 0, 1

_lib = None
build_seconds: float | None = None  # wall time of the nvcc run, if one was needed


def load_library(extra_flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    so, build_seconds = build_cuda_library(_SOURCE, extra_flags)
    lib = ctypes.CDLL(str(so))
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.liorf_pcg_solve.argtypes = [vp] * 15 + [ci] * 5 + [ctypes.c_float, ci, vp]
    lib.liorf_pcg_solve.restype = ci
    lib.liorf_pcg_scratch_floats.argtypes = [cll, cll, cll]
    lib.liorf_pcg_scratch_floats.restype = cll
    lib.liorf_pcg_iscratch_ints.argtypes = [cll, cll, cll]
    lib.liorf_pcg_iscratch_ints.restype = cll
    lib.liorf_pcg_layout.argtypes = [cll, cll, cll, ci]
    lib.liorf_pcg_layout.restype = ci
    lib.liorf_pcg_shared_bytes.argtypes = [cll, cll, cll, ci]
    lib.liorf_pcg_shared_bytes.restype = cll
    _lib = lib
    return lib


def _ordered_sum(prod: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis from 0.0 in index order, each add rounded."""
    acc = torch.zeros_like(prod[..., 0])
    for j in range(prod.shape[-1]):
        acc = acc + prod[..., j]
    return acc


def _gather_nodes(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v [B, K, 6] at idx [B, n] -> [B, n, 6]."""
    return torch.gather(v, 1, idx[..., None].expand(*idx.shape, v.shape[-1]))


def pcg_solve_plain(Ji, Jj, Jg, Jp, e_i, e_j, g_i, p_i, keys, perm, Minv, rhs,
                    iters: int, damping: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`pcg_solve` (same arguments), in the
    kernel's order: products over the 6 (GPS: 3) terms from 0.0 in index
    order, the node sums of the matvec in the plan's sorted order
    (``segment_sum_plain``), the dots by ``fixed_dot_plain``, every
    operation rounded on its own."""
    B, K, _ = rhs.shape
    E = Ji.shape[1]
    # every factor row as [6, 6] (GPS rows 3-5 zero: they add exact zeros)
    Jg6 = torch.cat([Jg, Jg.new_zeros((B, Jg.shape[1], 3, 6))], 2)
    J = torch.cat([Ji, Jj, Jg6, Jp[:, None]], 1)  # [B, M, 6, 6]
    Jt = J.transpose(-1, -2)
    ends = torch.cat([e_i, e_j, g_i, p_i], 1)  # [B, M]

    def A(p):
        y = _ordered_sum(J * _gather_nodes(p, ends)[:, :, None, :])  # [B, M, 6]
        y_e = y[:, :E] + y[:, E:2 * E]
        y = torch.cat([y_e, y_e, y[:, 2 * E:]], 1)
        rows = _ordered_sum(Jt * y[:, :, None, :])
        return segment_sum_plain(rows, perm, keys, K) + damping * p

    def dot(a, c):
        return fixed_dot_plain(a.reshape(B, -1), c.reshape(B, -1))[:, None, None]

    def where_nonzero(den, num):
        return torch.where(torch.abs(den) > 1e-20, num / den, 0.0)

    x = torch.zeros_like(rhs)
    r = rhs
    z = _ordered_sum(Minv * r[:, :, None, :])
    p = z
    rz = dot(r, z)
    for _ in range(iters):
        Ap = A(p)
        alpha = where_nonzero(dot(p, Ap), rz)
        x = x + alpha * p
        r = r - alpha * Ap
        z = _ordered_sum(Minv * r[:, :, None, :])
        rz_new = dot(r, z)
        p = z + where_nonzero(rz, rz_new) * p
        rz = rz_new
    return x


_INDEX = ("e_i", "e_j", "g_i", "p_i", "keys", "perm")


def _launch(Ji, Jj, Jg, Jp, e_i, e_j, g_i, p_i, keys, perm, Minv, rhs, iters: int,
            damping: float, cluster: int = CLUSTER) -> torch.Tensor:
    """The kernel on every lane. ``cluster`` (blocks a lane, 1 to 8)
    changes no bit."""
    dev = rhs.device
    B, K, _ = rhs.shape
    E, G = Ji.shape[1], Jg.shape[1]
    M = 2 * E + G + 1
    want = dict(Ji=(B, E, 6, 6), Jj=(B, E, 6, 6), Jg=(B, G, 3, 6), Jp=(B, 6, 6), e_i=(B, E),
                e_j=(B, E), g_i=(B, G), p_i=(B, 1), keys=(B, M), perm=(B, M),
                Minv=(B, K, 6, 6), rhs=(B, K, 6))
    args = dict(Ji=Ji, Jj=Jj, Jg=Jg, Jp=Jp, e_i=e_i, e_j=e_j, g_i=g_i, p_i=p_i, keys=keys,
                perm=perm, Minv=Minv, rhs=rhs)
    for name, t in args.items():
        dtype = torch.int64 if name in _INDEX else torch.float32
        if t.dtype != dtype or tuple(t.shape) != want[name] or t.device != dev:
            raise ValueError(f"pcg_solve: {name} {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected {dtype} {want[name]} on {dev}")
    if not 1 <= cluster <= 8:
        raise ValueError(f"pcg_solve: cluster of {cluster} blocks, expected 1 to 8")
    args = {k: t.contiguous() for k, t in args.items()}
    lib = load_library()
    x = torch.empty((B, K, 6), dtype=torch.float32, device=dev)
    scratch = torch.empty((B, lib.liorf_pcg_scratch_floats(K, E, G)), dtype=torch.float32, device=dev)
    iscratch = torch.empty((B, lib.liorf_pcg_iscratch_ints(K, E, G)), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.liorf_pcg_solve(
            *(t.data_ptr() for t in args.values()), x.data_ptr(), scratch.data_ptr(),
            iscratch.data_ptr(), B, K, E, G, iters, damping, cluster,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"pcg_solve: CUDA launch failed with error {err}")
    pcg_solve.launches += 1
    return x


@torch.library.custom_op("liorf_tpu_torch::pcg_solve", mutates_args=())
def _pcg_solve_op(Ji: torch.Tensor, Jj: torch.Tensor, Jg: torch.Tensor, Jp: torch.Tensor,
                  e_i: torch.Tensor, e_j: torch.Tensor, g_i: torch.Tensor, p_i: torch.Tensor,
                  keys: torch.Tensor, perm: torch.Tensor, Minv: torch.Tensor, rhs: torch.Tensor,
                  iters: int, damping: float) -> torch.Tensor:
    # The op on any device but CUDA is the plain version (the CPU path and
    # the tests reach the vmap rule through it).
    return pcg_solve_plain(Ji, Jj, Jg, Jp, e_i, e_j, g_i, p_i, keys, perm, Minv, rhs, iters, damping)


@_pcg_solve_op.register_kernel("cuda")
def _pcg_solve_cuda(*args):
    return _launch(*args)


@_pcg_solve_op.register_vmap
def _pcg_solve_vmap(info, in_dims, *args):
    """Lanes of a vmap fold into the op's own [B] axis: one launch."""
    n = info.batch_size
    tensors = [_fold_lanes(t, d, n) for t, d in zip(args[:12], in_dims[:12])]
    out = _pcg_solve_op(*tensors, *args[12:])
    return out.reshape(n, -1, *out.shape[1:]), 0


def pcg_solve(Ji, Jj, Jg, Jp, e_i, e_j, g_i, p_i, keys, perm, Minv, rhs, iters: int,
              damping: float) -> torch.Tensor:
    """x [B, K, 6] solving ``(H + damping I) x = rhs`` by ``iters`` PCG
    iterations from 0, preconditioned by ``Minv``; ``H x`` is the sum, per
    node, of the factors' ``J^T J x``. Ji, Jj [B,E,6,6] (between factors
    e_i -> e_j), Jg [B,G,3,6] (GPS at g_i), Jp [B,6,6] (the prior at p_i
    [B,1]), all masked and whitened; keys / perm [B, 2E+G+1] the stable
    sort of ``cat([e_i, e_j, g_i, p_i])`` (``SegmentPlan.sorted_rows``);
    Minv [B,K,6,6]; rhs [B,K,6]. One launch on the card for every lane."""
    if rhs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pcg_solve: unsupported device {rhs.device}")
    return _pcg_solve_op(Ji, Jj, Jg, Jp, e_i, e_j, g_i, p_i, keys, perm, Minv, rhs, iters,
                         float(damping))


pcg_solve.launches = 0


def launch_counts() -> dict[str, int]:
    return {"pcg_solve": pcg_solve.launches}


def reset_launch_counts() -> None:
    pcg_solve.launches = 0
