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

from ..ops.voxel_filter import voxel_filter
from ..ops.voxel_reduce import voxel_reduce
from .pointcloud import PAD_COORD, PointCloud


class VoxelResult(NamedTuple):
    cloud: PointCloud
    rep_idx: torch.Tensor  # [out_capacity] index into the input of one representative point per voxel (min input index)


def lexsort(keys) -> torch.Tensor:
    """``numpy.lexsort`` for 1-D tensors: the LAST key is the primary one.

    The three cell coordinates do not pack into one 64-bit key (up to
    +-3.3e7 each at leaf 0.3), so the order is built by successive stable
    sorts, least significant key first (replaces ``jnp.lexsort``,
    voxel.py:44 and keyframes.py:188 of the JAX package). The CPU route of
    the voxel filter; on the card the filter sorts compact keys in its
    kernel (``ops/voxel_filter.py``).
    """
    order = None
    for key in keys:
        if order is None:
            order = torch.argsort(key, stable=True)
        else:
            order = order[torch.argsort(key[order], stable=True)]
    return order


def _cells(cloud: PointCloud, leaf_size: float) -> torch.Tensor:
    """Quantized cell coords; padded points land in a far-away cell."""
    xyz = torch.where(cloud.mask[:, None], cloud.xyz, PAD_COORD)
    return torch.floor(xyz * (1.0 / leaf_size)).to(torch.int32)


def voxel_downsample(
    cloud: PointCloud,
    leaf_size: float,
    out_capacity: int | None = None,
) -> VoxelResult:
    """Centroid voxel filter. Output has `out_capacity` slots (default: input
    capacity); voxels beyond capacity are dropped deterministically in cell
    sort order. Points are lex-sorted by (z, y, x) cell with invalid points
    last, so identical cells are contiguous, then each run of equal cells is
    summed into a slot. On the CPU: ``_cells``, ``lexsort`` and
    ``ops/voxel_reduce.py``; on the card one kernel call for all of it
    (``ops/voxel_filter.py``, the same order and bits)."""
    if out_capacity is None:
        out_capacity = cloud.capacity
    voxel_downsample.calls += 1
    if cloud.xyz.device.type == "cuda":
        xyz, intensity, valid, rep = voxel_filter(
            cloud.xyz[None], cloud.intensity[None], cloud.mask[None], leaf_size, out_capacity)
    else:
        cell = _cells(cloud, leaf_size)
        order = lexsort((cell[:, 0], cell[:, 1], cell[:, 2], (~cloud.mask).to(torch.uint8)))
        xyz, intensity, valid, rep = voxel_reduce(
            cloud.xyz[None], cloud.intensity[None], cloud.mask[None], cell[None], order[None],
            out_capacity)
    return VoxelResult(cloud=PointCloud(xyz=xyz[0], intensity=intensity[0], mask=valid[0]),
                       rep_idx=rep[0])


voxel_downsample.calls = 0


def voxel_downsample_xyz(
    xyz: torch.Tensor, mask: torch.Tensor, leaf_size: float, out_capacity: int | None = None
):
    """Convenience wrapper over raw arrays; returns (xyz, mask). On the card
    the kernel reads no intensity (zeros) and this is its one launch."""
    if xyz.device.type == "cuda":
        voxel_downsample.calls += 1
        out = voxel_filter(xyz[None], None, mask[None], leaf_size,
                           xyz.shape[0] if out_capacity is None else out_capacity)
        return out[0][0], out[2][0]
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
