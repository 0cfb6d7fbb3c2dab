"""The voxel filter's reduction after its sort, on the CPU: the route of a
CPU cloud through ``core/voxel.py::voxel_downsample`` (``_cells``,
``lexsort``, then this), the JAX package's filter op for op.

Not a TPU kernel. The JAX package's filter (``liorf_tpu/core/voxel.py``)
sorts the points by cell and scatter-adds them (``.at[].add``) into one slot
a voxel. On the card the whole filter, sort included, is one kernel call
(``ops/voxel_filter.py``), whose plain version ends in
:func:`voxel_reduce_plain`.

* :func:`voxel_reduce` — for each lane, the points in input order (``xyz``
  [B,M,3] f32, ``intensity`` [B,M] f32, ``mask`` [B,M] bool, ``cell``
  [B,M,3] int32) and their sort permutation ``order`` [B,M] int64 (cells in
  lexicographic order, invalid points last) -> (centroids [B,S,3], intensity
  [B,S], valid [B,S], rep_idx [B,S] int64) for ``out_capacity`` S slots.
* :func:`voxel_reduce_plain` — the same function in torch ops
  (``index_add`` and ``scatter_reduce(amin)``).

The contract (``ops/voxel_filter.py``'s kernel keeps it bit for bit): sorted
position p starts a segment when p is 0, its cell differs from the previous
one, or either point is invalid; a segment's slot is its rank among the
starts, and invalid points and slots >= S are dropped. x, y, z, intensity
and the count are each summed from 0.0 in sorted order, one rounded add at a
time (the CPU's sequential ``index_add``); centroid = sum / count and
intensity = isum / count by IEEE division; the representative is the
smallest input index in the voxel. Empty slots get ``PAD_COORD``, intensity
0, valid false and rep M.

CPU tensors only: on the card ``index_add``'s atomics would not keep the
order, so a CUDA tensor raises (the card's filter is ``voxel_filter``). The
op is a ``torch.library`` custom op with a vmap rule, so the lane axis of a
vmapped CPU filter folds into one call.
"""

from __future__ import annotations

import torch

from ..core.pointcloud import PAD_COORD
from .segment_sum import _fold_lanes


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


@torch.library.custom_op("liorf_tpu_torch::voxel_reduce", mutates_args=())
def _voxel_reduce_op(xyz: torch.Tensor, intensity: torch.Tensor, mask: torch.Tensor,
                     cell: torch.Tensor, order: torch.Tensor, out_capacity: int
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    return voxel_reduce_plain(xyz, intensity, mask, cell, order, out_capacity)


@_voxel_reduce_op.register_kernel("cuda")
def _voxel_reduce_cuda(xyz, intensity, mask, cell, order, out_capacity):
    raise ValueError("voxel_reduce: CPU tensors only; the card's filter is ops/voxel_filter.py")


@_voxel_reduce_op.register_vmap
def _voxel_reduce_vmap(info, in_dims, xyz, intensity, mask, cell, order, out_capacity):
    """Lanes of a vmap fold into the op's own [B] axis: one call."""
    n = info.batch_size
    args = (_fold_lanes(t, d, n) for t, d in zip((xyz, intensity, mask, cell, order), in_dims))
    out = _voxel_reduce_op(*args, out_capacity)
    return tuple(t.reshape(n, -1, *t.shape[1:]) for t in out), (0, 0, 0, 0)


def voxel_reduce(xyz, intensity, mask, cell, order, out_capacity: int):
    """The voxel filter after its sort (module docstring): (centroids
    [B,S,3], intensity [B,S], valid [B,S], rep_idx [B,S] int64), on CPU
    tensors."""
    if xyz.device.type != "cpu":
        raise ValueError(f"voxel_reduce: CPU tensors only, got {xyz.device} (the card's filter "
                         f"is ops/voxel_filter.py)")
    return voxel_reduce_plain(xyz, intensity, mask, cell, order, out_capacity)
