"""The whole voxel filter on the card in one kernel call: the cells, a sort
of compact keys over only the digits that vary, and the reduction.

Not a TPU kernel. On the card ``core/voxel.py::voxel_downsample`` was
``_cells`` (four eager launches), ``lexsort``'s four stable library radix
sorts over every bit of their keys with their gathers, then
``ops/voxel_reduce.py``'s two kernels behind a memset (the JAX package's
filter is XLA's ``lexsort`` and scatter-add, ``liorf_tpu/core/voxel.py:38-69``,
outside any Pallas kernel). The kernel (``csrc/voxel_filter.cu``, one
cooperative launch for every lane) does all of it.

* :func:`voxel_filter` — for each lane, the points in input order (``xyz``
  [B,M,3] f32, ``intensity`` [B,M] f32 or None for zeros, ``mask`` [B,M]
  bool) and the leaf size -> (centroids [B,S,3], intensity [B,S], valid
  [B,S], rep_idx [B,S] int64) for ``out_capacity`` S slots.
* :func:`voxel_filter_plain` — the same function in torch ops:
  :func:`cells_plain`, :func:`filter_order_plain` (the compact-key order),
  then ``ops/voxel_reduce.py::voxel_reduce_plain``.

The contract. A point's cell is ``floor(where(mask, xyz, PAD_COORD) *
(1.0 / leaf))`` cast to int32, the product rounded once in float32 (torch's
product by a Python scalar, on the CPU and the card alike). The order is
``numpy.lexsort((x, y, z, ~mask))`` of the cells, ties in input order, spelt
as a stable sort of compact keys: a valid point packs (z - z_min, y - y_min,
x - x_min) at the bit widths its lane's valid cells need, with the invalid
bit above them; an invalid point's key is that bit alone (every invalid
point has PAD_COORD's cell). Equal keys are equal cells. The key has at most
97 bits; the sort is least significant digit first, 8 bits a digit, and a
digit that is the same for every key of the lane leaves the lane's order as
it is: the kernel sorts only the digits under its lane's key width (each
field's top bit varies; the invalid bit where the lane holds both kinds of
point), the plain version sorts by every digit. Then
``voxel_reduce_plain``'s contract: each run of equal valid cells is summed
from 0.0 in sorted order, one rounded add at a time, into the slot of its
rank; centroid = sum / count and intensity = isum / count by IEEE division;
the representative is the smallest input index; invalid points and slots >=
S are dropped; empty slots get PAD_COORD, 0, false and M. The kernel and the
plain version on a CPU copy agree bit for bit.

One difference with the CPU the contract does not cover: a coordinate whose
cell is past int32's range (|x| / leaf >= 2^31) or NaN casts to the saturated
value or 0 on the card (``cvt.rzi.s32.f32``, torch's cast there too) and to
INT32_MIN on the CPU.

Dispatch by the tensor's device and nothing else: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises. The kernel is a
``torch.library`` custom op with a vmap rule, so the lane axis of
``pipeline/multistream.py`` (``torch.func.vmap``) folds into one launch; a
call with no vmap around it launches without the op's dispatch, its outputs
and scratch views of one allocation, its addresses one packed array. The
launch is cooperative: every lane needs one block resident at once, so a
call of more lanes than the card holds such blocks (two a multiprocessor) raises.
"""

from __future__ import annotations

import ctypes
from array import array
from pathlib import Path
from typing import Optional

import torch
from torch._C import _functorch

from ..core.build import build_cuda_library, raw_stream
from ..core.pointcloud import PAD_COORD
from .segment_sum import _fold_lanes
from .voxel_reduce import voxel_reduce_plain

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "voxel_filter.cu"

DIGITS = 13  # 8-bit digits of the widest key: the invalid bit over three 32-bit fields

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
    lib.liorf_voxel_filter_scratch_bytes.argtypes = [ci, ci, ci]
    lib.liorf_voxel_filter_scratch_bytes.restype = ctypes.c_longlong
    lib.liorf_voxel_filter.argtypes = [vp, ctypes.c_float, ci, ci, ci, ci, vp]
    lib.liorf_voxel_filter.restype = ci
    lib.liorf_voxel_filter_kernel_launches.argtypes = []
    lib.liorf_voxel_filter_kernel_launches.restype = ctypes.c_longlong
    _lib = lib
    return lib


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def cells_plain(xyz, mask, leaf: float) -> torch.Tensor:
    """[..., M, 3] int32 cells (``core/voxel.py::_cells`` over any leading
    axes): padded points land in PAD_COORD's cell."""
    return torch.floor(torch.where(mask[..., None], xyz, PAD_COORD) * (1.0 / leaf)).to(torch.int32)


def key_digits(cell, mask) -> torch.Tensor:
    """[DIGITS, B, M] int64: the 8-bit digits of each point's compact key,
    least significant first (module docstring)."""
    c = cell.to(torch.int64)
    valid = mask[..., None]
    lo = torch.where(valid, c, 2**31).amin(1)  # [B, 3]; an empty lane: 2^31
    hi = torch.where(valid, c, -2**31 - 1).amax(1)
    any_valid = mask.any(1)[:, None]
    lo = torch.where(any_valid, lo, 0)
    span = torch.where(any_valid, hi - lo, 0)  # [B, 3] in [0, 2^32)
    width = ((span[..., None] >> torch.arange(32, device=cell.device)) != 0).sum(-1)
    off = torch.cat([torch.zeros_like(width[:, :1]), width.cumsum(1)], 1)  # [B, 4]
    fields = torch.cat([torch.where(valid, c - lo[:, None], 0),
                        (~mask).to(torch.int64)[..., None]], -1)  # [B, M, 4]
    out = []
    for p in range(DIGITS):
        s = (8 * p - off)[:, None, :]  # where the digit starts in each field
        part = torch.where(s >= 0, fields >> s.clamp(0, 40), fields << (-s).clamp(0, 8)) & 255
        out.append(part[..., 0] | part[..., 1] | part[..., 2] | part[..., 3])
    return torch.stack(out)


def filter_order_plain(cell, mask) -> torch.Tensor:
    """[B, M] int64: ``numpy.lexsort((x, y, z, ~mask))`` of each lane's cells
    [B, M, 3], as stable sorts of the compact keys' digits, least
    significant first."""
    order = torch.arange(mask.shape[1], device=cell.device).expand(mask.shape).contiguous()
    for d in key_digits(cell, mask):
        order = torch.gather(order, 1, torch.argsort(torch.gather(d, 1, order), dim=1,
                                                     stable=True))
    return order


def voxel_filter_plain(xyz, intensity, mask, leaf: float, out_capacity: int):
    """Plain PyTorch version of :func:`voxel_filter` (same contract). On the
    CPU its sums add in sorted order; on the card ``voxel_reduce_plain``'s
    atomics do not keep it."""
    if intensity is None:
        intensity = torch.zeros(mask.shape, dtype=torch.float32, device=mask.device)
    cell = cells_plain(xyz, mask, leaf)
    return voxel_reduce_plain(xyz, intensity, mask, cell, filter_order_plain(cell, mask),
                              out_capacity)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_counters: dict = {}
_SCRATCH: dict = {}  # (lanes, M, device index) -> scratch bytes


def lane_counters(dev: torch.device, lanes: int) -> torch.Tensor:
    """At least two counters a lane on ``dev`` (a lane's arrivals at its
    barriers, its blocks' departures). They are 0 between launches: the
    lane's last block to leave sets them back, so the tensor is zeroed once,
    when it is made. Launches on ``dev`` run one at a time (one stream), as
    every caller in the package makes them."""
    t = _counters.get(dev)
    if t is None or t.numel() < 2 * lanes:
        t = torch.zeros((max(2 * lanes, 16),), dtype=torch.int32, device=dev)
        _counters[dev] = t
    return t


def _checked(xyz, intensity, mask):
    """The arguments as the kernel takes them (contiguous), or ValueError."""
    dev = xyz.device
    if xyz.dim() != 3:
        raise ValueError(f"voxel_filter: xyz {tuple(xyz.shape)}, expected [B, M, 3]")
    B, M = xyz.shape[:2]
    want = {"xyz": (xyz, torch.float32, (B, M, 3)),
            "intensity": (intensity, torch.float32, (B, M)), "mask": (mask, torch.bool, (B, M))}
    for name, (t, dtype, shape) in want.items():
        if t is not None and (t.dtype is not dtype or t.shape != shape or t.device != dev):
            raise ValueError(f"voxel_filter: {name} {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected {dtype} {shape} on {dev}")
    if M >= 2**31 - 1:
        raise ValueError(f"voxel_filter: {M} points a lane (< 2^31 - 1)")
    return [t if t is None or t.is_contiguous() else t.contiguous() for t in (xyz, intensity, mask)]


def _scratch_bytes(lib, B: int, M: int, dev: torch.device) -> int:
    key = (B, M, dev.index)
    if key not in _SCRATCH:
        n = int(lib.liorf_voxel_filter_scratch_bytes(B, M, dev.index))
        if n < 0:
            raise RuntimeError(f"voxel_filter: no launch plan for {B} lanes of {M} points "
                               f"(CUDA error {-n})")
        _SCRATCH[key] = n
    return _SCRATCH[key]


def _buffer(B: int, M: int, S: int, scratch: int, dev, outputs_apart: bool, keep_order: bool):
    """(centroids, intensity, valid, rep[, order]) and the scratch's address:
    views of one int64 allocation, the scratch last, or (``outputs_apart``, a
    custom op's outputs may not alias) one tensor an output and one for the
    scratch."""
    if outputs_apart:
        out = [torch.empty((B, S, 3), dtype=torch.float32, device=dev),
               torch.empty((B, S), dtype=torch.float32, device=dev),
               torch.empty((B, S), dtype=torch.bool, device=dev),
               torch.empty((B, S), dtype=torch.int64, device=dev)]
        if keep_order:
            out.append(torch.empty((B, M), dtype=torch.int64, device=dev))
        return out, torch.empty(((scratch + 15) // 8,), dtype=torch.int64, device=dev)
    n_order = B * M if keep_order else 0
    # int64 words: rep, order, then centroids and intensity as float32 pairs,
    # valid as bytes, then the scratch 16-byte aligned
    w_f = B * S + n_order
    w_v = w_f + (4 * B * S + 1) // 2
    w_s = (w_v + (B * S + 7) // 8 + 1) // 2 * 2
    buf = torch.empty((w_s + (scratch + 7) // 8 + 1,), dtype=torch.int64, device=dev)
    f, u = buf.view(torch.float32), buf.view(torch.bool)
    out = [f.as_strided((B, S, 3), (3 * S, 3, 1), 2 * w_f),
           f.as_strided((B, S), (S, 1), 2 * w_f + 3 * B * S),
           u.as_strided((B, S), (S, 1), 8 * w_v),
           buf.as_strided((B, S), (S, 1), 0)]
    if keep_order:
        out.append(buf.as_strided((B, M), (M, 1), B * S))
    return out, buf.data_ptr() + 8 * w_s


def _launch(xyz, intensity, mask, leaf: float, out_capacity: int, keep_order: bool = False,
            outputs_apart: bool = False):
    """The kernel on every lane: (centroids, intensity, valid, rep), and with
    ``keep_order`` also the sorted permutation [B, M] (for checks)."""
    xyz, intensity, mask = _checked(xyz, intensity, mask)
    dev = xyz.device
    B, M = mask.shape
    S = int(out_capacity)
    if S < 0 or S >= 2**31 - 1:
        raise ValueError(f"voxel_filter: {S} slots (0 <= S < 2^31 - 1)")
    lib = load_library()
    out, scratch = _buffer(B, M, S, _scratch_bytes(lib, B, M, dev), dev, outputs_apart, keep_order)
    if outputs_apart:
        scratch = (scratch.data_ptr() + 15) // 16 * 16
    ptrs = array("q", [xyz.data_ptr(), 0 if intensity is None else intensity.data_ptr(),
                       mask.data_ptr(), scratch,
                       *(t.data_ptr() for t in out[:4]), out[4].data_ptr() if keep_order else 0,
                       lane_counters(dev, B).data_ptr()])
    err = lib.liorf_voxel_filter(ptrs.buffer_info()[0], 1.0 / leaf, B, M, S, dev.index,
                                 raw_stream(dev.index))
    if err != 0:
        raise RuntimeError(f"voxel_filter: CUDA launch failed with error {err}")
    voxel_filter.launches += 1
    return tuple(out)


@torch.library.custom_op("liorf_tpu_torch::voxel_filter", mutates_args=())
def _voxel_filter_op(xyz: torch.Tensor, intensity: Optional[torch.Tensor], mask: torch.Tensor,
                     leaf: float, out_capacity: int
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    # The op on any device but CUDA is the plain version (the tests reach the
    # vmap rule through it on the CPU).
    return voxel_filter_plain(xyz, intensity, mask, leaf, out_capacity)


@_voxel_filter_op.register_kernel("cuda")
def _voxel_filter_cuda(xyz, intensity, mask, leaf, out_capacity):
    return _launch(xyz, intensity, mask, leaf, out_capacity, outputs_apart=True)


@_voxel_filter_op.register_vmap
def _voxel_filter_vmap(info, in_dims, xyz, intensity, mask, leaf, out_capacity):
    """Lanes of a vmap fold into the op's own [B] axis: one launch."""
    n = info.batch_size
    args = (_fold_lanes(t, d, n) for t, d in zip((xyz, intensity, mask), in_dims[:3]))
    out = _voxel_filter_op(*args, leaf, out_capacity)
    return tuple(t.reshape(n, -1, *t.shape[1:]) for t in out), (0, 0, 0, 0)


def voxel_filter(xyz, intensity, mask, leaf: float, out_capacity: int):
    """The voxel filter (module docstring): (centroids [B,S,3], intensity
    [B,S], valid [B,S], rep_idx [B,S] int64); ``intensity`` None reads as
    zeros. One call on the card for every lane (a vmapped call's lanes
    included)."""
    if xyz.device.type == "cuda" and _functorch.maybe_current_level() is None:
        # no vmap around the call: the launch without the custom op's dispatch
        return _launch(xyz, intensity, mask, leaf, out_capacity)
    if xyz.device.type not in ("cpu", "cuda"):
        raise ValueError(f"voxel_filter: unsupported device {xyz.device}")
    return _voxel_filter_op(xyz, intensity, mask, float(leaf), int(out_capacity))


voxel_filter.launches = 0


def launch_counts() -> dict[str, int]:
    return {"voxel_filter": voxel_filter.launches}


def kernel_launches() -> int:
    """Kernels the library has launched in this process (its own count)."""
    return int(load_library().liorf_voxel_filter_kernel_launches())


def reset_launch_counts() -> None:
    voxel_filter.launches = 0
