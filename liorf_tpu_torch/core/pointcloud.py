"""Fixed-capacity masked point cloud containers.

Point clouds are stored padded to a fixed capacity with a validity mask, as
in the JAX package: shapes stay constant from frame to frame, so buffers are
reused and nothing on the frame path depends on a data-dependent size.
Invalid slots hold a large sentinel coordinate so that distance-based ops
naturally ignore them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .device import resolve_device

# Sentinel coordinate for padded points: far away from any real geometry so
# that nearest-neighbor queries never select padding.
PAD_COORD = 1.0e7


class PointCloud(NamedTuple):
    """A padded point cloud: xyz [N, 3], intensity [N], mask [N] (bool)."""

    xyz: torch.Tensor
    intensity: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> torch.Tensor:
        return torch.sum(self.mask.to(torch.int32), dim=-1)


def make_cloud(xyz, intensity=None, mask=None, capacity: int | None = None,
               device=None) -> PointCloud:
    """Build a PointCloud, padding/truncating to `capacity` if given.

    A tensor keeps its device when ``device`` is None; for host data
    ``device=None`` means ``cuda`` and raises when there is none."""
    if not (device is None and isinstance(xyz, torch.Tensor)):
        device = resolve_device(device, "make_cloud")
    xyz = torch.as_tensor(xyz, dtype=torch.float32, device=device)
    device = xyz.device
    n = xyz.shape[0]
    if intensity is None:
        intensity = torch.zeros((n,), dtype=torch.float32, device=device)
    else:
        intensity = torch.as_tensor(intensity, dtype=torch.float32, device=device)
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=device)
    else:
        mask = torch.as_tensor(mask, dtype=torch.bool, device=device)
    if capacity is not None and capacity != n:
        if n > capacity:
            xyz, intensity, mask = xyz[:capacity], intensity[:capacity], mask[:capacity]
        else:
            pad = capacity - n
            xyz = torch.cat(
                [xyz, torch.full((pad, 3), PAD_COORD, dtype=xyz.dtype, device=device)]
            )
            intensity = torch.cat(
                [intensity, torch.zeros((pad,), dtype=intensity.dtype, device=device)]
            )
            mask = torch.cat([mask, torch.zeros((pad,), dtype=torch.bool, device=device)])
    xyz = torch.where(mask[:, None], xyz, PAD_COORD)
    return PointCloud(xyz=xyz, intensity=intensity, mask=mask)


def apply_mask(cloud: PointCloud, extra_mask: torch.Tensor) -> PointCloud:
    """AND an extra mask in; masked-out slots get the PAD sentinel coord."""
    mask = cloud.mask & extra_mask
    xyz = torch.where(mask[:, None], cloud.xyz, PAD_COORD)
    return PointCloud(xyz=xyz, intensity=cloud.intensity, mask=mask)


def compact(cloud: PointCloud) -> PointCloud:
    """Stable-partition valid points to the front (same capacity)."""
    order = torch.argsort((~cloud.mask).to(torch.uint8), stable=True)  # valid first
    xyz = cloud.xyz[order]
    intensity = cloud.intensity[order]
    mask = cloud.mask[order]
    xyz = torch.where(mask[:, None], xyz, PAD_COORD)
    return PointCloud(xyz=xyz, intensity=intensity, mask=mask)


def to_numpy(cloud: PointCloud) -> np.ndarray:
    """Extract the valid points as a dense [n, 4] numpy array (xyzi)."""
    mask = cloud.mask.cpu().numpy()
    xyz = cloud.xyz.cpu().numpy()[mask]
    inten = cloud.intensity.cpu().numpy()[mask]
    return np.concatenate([xyz, inten[:, None]], axis=1)


def round_up_pow2(n: int, minimum: int = 256) -> int:
    """Smallest power of two >= max(n, minimum) — capacity bucketing."""
    c = minimum
    while c < n:
        c *= 2
    return c
