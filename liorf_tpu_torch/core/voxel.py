"""Deterministic fixed-capacity voxel-grid downsampling.

Replacement for PCL ``VoxelGrid`` (used throughout the reference: scan
downsample ``mapOptmization.cpp:1061-1067``, local map ``:1036-1038``, ICP
clouds ``:839-843``). Instead of a hash map, points are lex-sorted by
quantized cell coordinate; segment boundaries give one output slot per
occupied voxel. Static shapes, no host round-trip.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.segment_sum import segment_sum
from .pointcloud import PAD_COORD, PointCloud


class VoxelResult(NamedTuple):
    cloud: PointCloud
    rep_idx: torch.Tensor  # [out_capacity] index into the input of one representative point per voxel (min input index)


def lexsort(keys) -> torch.Tensor:
    """``numpy.lexsort`` for 1-D tensors: the LAST key is the primary one.

    The three cell coordinates do not pack into one 64-bit key (up to
    +-3.3e7 each at leaf 0.3), so the order is built by successive stable
    sorts, least significant key first (replaces ``jnp.lexsort``,
    voxel.py:44 and keyframes.py:188 of the JAX package).
    """
    order = None
    for key in keys:
        if order is None:
            order = torch.argsort(key, stable=True)
        else:
            order = order[torch.argsort(key[order], stable=True)]
    return order


def voxel_downsample(
    cloud: PointCloud,
    leaf_size: float,
    out_capacity: int | None = None,
) -> VoxelResult:
    """Centroid voxel filter. Output has `out_capacity` slots (default: input
    capacity); voxels beyond capacity are dropped deterministically in cell
    sort order."""
    n = cloud.capacity
    dev = cloud.xyz.device
    if out_capacity is None:
        out_capacity = n
    inv_leaf = 1.0 / leaf_size

    # Quantized cell coords; padded points land in a far-away cell.
    xyz = torch.where(cloud.mask[:, None], cloud.xyz, PAD_COORD)
    cell = torch.floor(xyz * inv_leaf).to(torch.int32)

    # Lex-sort points by (z, y, x, valid) so identical cells are contiguous
    # and invalid points sort to the back.
    order = lexsort(
        (cell[:, 0], cell[:, 1], cell[:, 2], (~cloud.mask).to(torch.uint8))
    )
    cell_s = cell[order]
    xyz_s = cloud.xyz[order]
    inten_s = cloud.intensity[order]
    mask_s = cloud.mask[order]

    same_as_prev = torch.all(cell_s[1:] == cell_s[:-1], dim=-1) & mask_s[1:] & mask_s[:-1]
    new_seg = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), ~same_as_prev])
    seg_id = torch.cumsum(new_seg.to(torch.int64), dim=0) - 1  # [n]

    # Scatter-accumulate into fixed-size output. Invalid points are routed to
    # a dump slot (out_capacity) which is sliced off — torch raises on an
    # out-of-range index where JAX drops it, so the dump slot is load-bearing.
    # Out-of-place scatters, so the filter also runs under torch.func.vmap.
    tgt = torch.where(mask_s & (seg_id < out_capacity), seg_id, out_capacity)
    if xyz_s.is_cuda:
        # On the card, one fixed-order segment sum (the atomic index_add
        # would not repeat): tgt is sorted — valid points first, seg_id
        # non-decreasing, everything past the capacity in the dump slot,
        # which the kernel skips.
        rows = torch.cat([xyz_s, inten_s[:, None], torch.ones_like(inten_s)[:, None]], dim=1)
        acc = segment_sum(rows[None], None, tgt[None], out_capacity)[0]
        sums, isum, cnt_v = acc[:, :3], acc[:, 3], acc[:, 4]
    else:
        sums = torch.zeros((out_capacity + 1, 3), dtype=torch.float32, device=dev)
        sums = sums.index_add(0, tgt, xyz_s)
        isum = torch.zeros((out_capacity + 1,), dtype=torch.float32, device=dev)
        isum = isum.index_add(0, tgt, inten_s)
        cnt = torch.zeros((out_capacity + 1,), dtype=torch.float32, device=dev)
        cnt = cnt.index_add(0, tgt, torch.ones_like(inten_s))
        sums, isum, cnt_v = sums[:-1], isum[:-1], cnt[:-1]
    # representative = smallest original index in the voxel
    rep = torch.full((out_capacity + 1,), n, dtype=torch.int64, device=dev)
    rep = rep.scatter_reduce(0, tgt, order, reduce="amin", include_self=True)

    valid = cnt_v > 0
    denom = torch.where(valid, cnt_v, 1.0)
    centroids = sums / denom[:, None]
    centroids = torch.where(valid[:, None], centroids, PAD_COORD)
    intensity = isum / denom
    out = PointCloud(xyz=centroids, intensity=intensity, mask=valid)
    return VoxelResult(cloud=out, rep_idx=torch.where(valid, rep[:-1], n))


def voxel_downsample_xyz(
    xyz: torch.Tensor, mask: torch.Tensor, leaf_size: float, out_capacity: int | None = None
):
    """Convenience wrapper over raw arrays; returns (xyz, mask)."""
    pc = PointCloud(
        xyz=xyz,
        intensity=torch.zeros(xyz.shape[0], dtype=torch.float32, device=xyz.device),
        mask=mask,
    )
    res = voxel_downsample(pc, leaf_size, out_capacity)
    return res.cloud.xyz, res.cloud.mask


def voxel_downsample_np(xyz, leaf_size: float):
    """Host-side (numpy) centroid voxel filter for host-resident clouds.

    Used where the data already lives on the host (e.g. loop-closure submap
    prep from the keyframe store).
    """
    xyz = np.asarray(xyz, np.float32)
    if len(xyz) == 0:
        return xyz
    cell = np.floor(xyz / leaf_size).astype(np.int64)
    # pack 21 bits per axis around a 2^20 offset
    key = (
        ((cell[:, 0] + (1 << 20)) << 42)
        | ((cell[:, 1] + (1 << 20)) << 21)
        | (cell[:, 2] + (1 << 20))
    )
    uniq, inv, cnt = np.unique(key, return_inverse=True, return_counts=True)
    sums = np.zeros((len(uniq), 3), np.float64)
    np.add.at(sums, inv, xyz)
    return (sums / cnt[:, None]).astype(np.float32)
