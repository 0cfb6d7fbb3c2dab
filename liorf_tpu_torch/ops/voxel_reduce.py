"""The voxel filter's reduction after its sort, in one kernel call.

Not a TPU kernel. The JAX package's filter (``liorf_tpu/core/voxel.py``)
sorts the points by cell and scatter-adds them (``.at[].add``) into one slot
a voxel, which XLA fuses; in eager ops on the card (the plain version
below) that is about 35 launches a call, and its ``index_add`` is atomic,
so its sums would not repeat. The kernel (``csrc/voxel_reduce.cu``) does all that follows the sort: it
finds the segments of equal cells, ranks them into slots, sums each slot's
rows in sorted order and writes the centroids, intensities, masks and
representatives.

* :func:`voxel_reduce` — for each lane, the points in input order (``xyz``
  [B,M,3] f32, ``intensity`` [B,M] f32, ``mask`` [B,M] bool, ``cell``
  [B,M,3] int32) and their sort permutation ``order`` [B,M] int64 (cells in
  lexicographic order, invalid points last) -> (centroids [B,S,3], intensity
  [B,S], valid [B,S], rep_idx [B,S] int64) for ``out_capacity`` S slots.
* :func:`voxel_reduce_plain` — the same function in torch ops (the filter's
  composition since the port began: ``index_add`` and
  ``scatter_reduce(amin)``).

The contract, which the kernel keeps bit for bit: sorted position p starts a
segment when p is 0, its cell differs from the previous one, or either
point is invalid; a segment's slot is its rank among the starts, and
invalid points and slots >= S are dropped. x, y, z, intensity and the count
are each summed from 0.0 in sorted order, one rounded add at a time (the
CPU's sequential ``index_add``); centroid = sum / count and intensity =
isum / count by IEEE division; the representative is the smallest input
index in the voxel. Empty slots get ``PAD_COORD``, intensity 0, valid false
and rep M.

Dispatch by the tensor's device and nothing else: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises. The kernel is a
``torch.library`` custom op with a vmap rule, so the lane axis of
``pipeline/multistream.py`` (``torch.func.vmap``) runs through it in one
call for every lane.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ..core.build import build_cuda_library
from ..core.pointcloud import PAD_COORD
from .segment_sum import _fold_lanes

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "voxel_reduce.cu"

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
    lib.liorf_voxel_reduce_scratch_bytes.argtypes = [ci, ci, ci]
    lib.liorf_voxel_reduce_scratch_bytes.restype = ctypes.c_longlong
    lib.liorf_voxel_reduce.argtypes = [vp] * 10 + [ci] * 3 + [vp]
    lib.liorf_voxel_reduce.restype = ci
    _lib = lib
    return lib


def voxel_reduce_plain(xyz, intensity, mask, cell, order, out_capacity: int):
    """Plain PyTorch version of :func:`voxel_reduce` (same contract): the
    lanes' rows gathered into sorted order, one ``index_add`` a quantity over
    every lane's slots and a dump slot, ``scatter_reduce(amin)`` of the input
    indices. On the CPU it adds in sorted order; on the card its atomics do
    not keep it."""
    B, M = mask.shape
    S = out_capacity
    dev = xyz.device

    def gather(t):
        idx = order.reshape(B, M, *([1] * (t.dim() - 2))).expand(t.shape)
        return torch.gather(t, 1, idx)

    cell_s, xyz_s, inten_s, mask_s = gather(cell), gather(xyz), gather(intensity), gather(mask)
    same_as_prev = torch.all(cell_s[:, 1:] == cell_s[:, :-1], dim=-1) & mask_s[:, 1:] & mask_s[:, :-1]
    new_seg = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev), ~same_as_prev], dim=1)
    seg_id = torch.cumsum(new_seg.to(torch.int64), dim=1) - 1
    # every lane's S slots and a dump slot (dropped points), lane after lane
    tgt = torch.where(mask_s & (seg_id < S), seg_id, S)
    tgt = (tgt + torch.arange(B, device=dev)[:, None] * (S + 1)).reshape(-1)
    sums = torch.zeros((B * (S + 1), 3), dtype=torch.float32, device=dev)
    sums = sums.index_add(0, tgt, xyz_s.reshape(-1, 3)).reshape(B, S + 1, 3)[:, :S]
    isum = torch.zeros((B * (S + 1),), dtype=torch.float32, device=dev)
    isum = isum.index_add(0, tgt, inten_s.reshape(-1)).reshape(B, S + 1)[:, :S]
    cnt = torch.zeros((B * (S + 1),), dtype=torch.float32, device=dev)
    cnt = cnt.index_add(0, tgt, torch.ones_like(inten_s).reshape(-1)).reshape(B, S + 1)[:, :S]
    rep = torch.full((B * (S + 1),), M, dtype=torch.int64, device=dev)
    rep = rep.scatter_reduce(0, tgt, order.reshape(-1), reduce="amin", include_self=True)
    rep = rep.reshape(B, S + 1)[:, :S]

    valid = cnt > 0
    denom = torch.where(valid, cnt, 1.0)
    centroids = torch.where(valid[..., None], sums / denom[..., None], PAD_COORD)
    return centroids, isum / denom, valid, torch.where(valid, rep, M)


def _launch(xyz, intensity, mask, cell, order, out_capacity: int):
    dev = xyz.device
    B, M = mask.shape
    S = out_capacity
    want = {"xyz": (xyz, torch.float32, (B, M, 3)), "intensity": (intensity, torch.float32, (B, M)),
            "mask": (mask, torch.bool, (B, M)), "cell": (cell, torch.int32, (B, M, 3)),
            "order": (order, torch.int64, (B, M))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"voxel_reduce: {name} {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected {dtype} {shape} on {dev}")
    if M >= 2**31 - 1 or S >= 2**31 - 1:
        raise ValueError(f"voxel_reduce: {M} points into {S} slots (each < 2^31 - 1)")
    xyz, intensity, mask, cell, order = (
        t.contiguous() for t in (xyz, intensity, mask, cell, order))
    lib = load_library()
    scratch = torch.empty((lib.liorf_voxel_reduce_scratch_bytes(B, M, S),), dtype=torch.uint8,
                          device=dev)
    out_xyz = torch.empty((B, S, 3), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, S), dtype=torch.float32, device=dev)
    out_valid = torch.empty((B, S), dtype=torch.bool, device=dev)
    out_rep = torch.empty((B, S), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = lib.liorf_voxel_reduce(
            xyz.data_ptr(), intensity.data_ptr(), mask.data_ptr(), cell.data_ptr(),
            order.data_ptr(), scratch.data_ptr(), out_xyz.data_ptr(), out_i.data_ptr(),
            out_valid.data_ptr(), out_rep.data_ptr(), B, M, S,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"voxel_reduce: CUDA launch failed with error {err}")
    voxel_reduce.launches += 1
    return out_xyz, out_i, out_valid, out_rep


@torch.library.custom_op("liorf_tpu_torch::voxel_reduce", mutates_args=())
def _voxel_reduce_op(xyz: torch.Tensor, intensity: torch.Tensor, mask: torch.Tensor,
                     cell: torch.Tensor, order: torch.Tensor, out_capacity: int
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    # The op on any device but CUDA is the plain version (the tests reach
    # the vmap rule through it on the CPU).
    return voxel_reduce_plain(xyz, intensity, mask, cell, order, out_capacity)


@_voxel_reduce_op.register_kernel("cuda")
def _voxel_reduce_cuda(xyz, intensity, mask, cell, order, out_capacity):
    return _launch(xyz, intensity, mask, cell, order, out_capacity)


@_voxel_reduce_op.register_vmap
def _voxel_reduce_vmap(info, in_dims, xyz, intensity, mask, cell, order, out_capacity):
    """Lanes of a vmap fold into the op's own [B] axis: one launch."""
    n = info.batch_size
    args = (_fold_lanes(t, d, n) for t, d in zip((xyz, intensity, mask, cell, order), in_dims))
    out = _voxel_reduce_op(*args, out_capacity)
    return tuple(t.reshape(n, -1, *t.shape[1:]) for t in out), (0, 0, 0, 0)


def voxel_reduce(xyz, intensity, mask, cell, order, out_capacity: int):
    """The voxel filter after its sort (module docstring): (centroids
    [B,S,3], intensity [B,S], valid [B,S], rep_idx [B,S] int64). One call on
    the card for every lane."""
    if xyz.device.type == "cpu":
        return voxel_reduce_plain(xyz, intensity, mask, cell, order, out_capacity)
    if xyz.device.type != "cuda":
        raise ValueError(f"voxel_reduce: unsupported device {xyz.device}")
    return _voxel_reduce_op(xyz, intensity, mask, cell, order, out_capacity)


voxel_reduce.launches = 0


def launch_counts() -> dict[str, int]:
    return {"voxel_reduce": voxel_reduce.launches}


def reset_launch_counts() -> None:
    voxel_reduce.launches = 0
