"""Keyframe store and local-map assembly.

Host-shell + device-core replacement for the reference back-end's keyframe
state (``cloudKeyPoses3D/6D``, ``surfCloudKeyFrames``, transformed-cloud
cache; ``liorf/src/mapOptmization.cpp:975-1058``). Keyframe clouds live in
fixed-capacity device tensors; the fused local map is recomputed on device
(transform + concat + voxel filter), replacing the reference's host-side
cache with 1000-entry eviction (``:1042-1043``).

Capacity doubling happens host-side (numpy pad + re-upload).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import se3
from ..core.device import resolve_device
from ..core.pointcloud import PAD_COORD
from ..core.voxel import lexsort, voxel_downsample_xyz
from ..ops import knn


def subsample_to_cap(xyz: torch.Tensor, mask: torch.Tensor, cap: int):
    """Reduce a (valid-prefix) masked cloud to `cap` slots WITHOUT spatial
    bias: the voxel filter emits points in cell-sort order, so a plain
    prefix `[:cap]` would systematically drop one side of the scan when it
    overflows. Instead take an even stride over the n valid points (a fair
    spatial subsample given the sort interleaves cells)."""
    n = torch.sum(mask.to(torch.int64))
    ar = torch.arange(cap, dtype=torch.int64, device=xyz.device)
    idx = torch.where(n > cap, (ar * n) // cap, ar)
    # torch raises on an out-of-range gather where JAX clamps
    idx = torch.clamp(idx, max=mask.shape[0] - 1)
    return xyz[idx], mask[idx]


def subsample_to_cap_np(xyz, mask, cap: int):
    """NumPy twin of :func:`subsample_to_cap` for the host keyframe store."""
    n = int(np.sum(mask))
    ar = np.arange(cap)
    idx = np.where(n > cap, (ar * n) // cap, ar)
    idx = np.minimum(idx, len(mask) - 1)
    return xyz[idx], mask[idx]


class KeyframeStore:
    """Append-only store of keyframe poses, clouds, times, SC descriptors.

    ``device`` is where the device mirror lives and where loop verification
    runs its ICP: ``None`` means ``cuda`` and raises when there is none."""

    def __init__(self, cloud_capacity: int = 8192, initial_kf_capacity: int = 256,
                 device=None):
        self.cloud_cap = cloud_capacity
        self.kf_cap = initial_kf_capacity
        self.device = resolve_device(device, "KeyframeStore")
        self.count = 0
        k, c = self.kf_cap, self.cloud_cap
        self.poses = np.zeros((k, 6), np.float32)  # rpyxyz (optimized)
        self.times = np.zeros((k,), np.float64)
        self.clouds = np.full((k, c, 3), PAD_COORD, np.float32)  # sensor frame
        self.cloud_masks = np.zeros((k, c), bool)
        self.sc_descs = np.zeros((k, 20, 60), np.float32)
        self.sc_keys = np.zeros((k, 20), np.float32)
        self._dev = None

    def _grow(self):
        self.kf_cap *= 2
        for name in ("poses", "times", "clouds", "cloud_masks", "sc_descs", "sc_keys"):
            arr = getattr(self, name)
            pad_shape = (self.kf_cap - arr.shape[0],) + arr.shape[1:]
            fill = PAD_COORD if name == "clouds" else 0
            setattr(self, name, np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)]))

    def _to_dev(self, arr: np.ndarray) -> torch.Tensor:
        # a copy: the device mirror must not alias the host arrays on CPU
        return torch.tensor(arr, device=self.device)

    def append(self, pose_rpyxyz, time, cloud_xyz, cloud_mask, sc_desc, sc_key) -> int:
        if self.count == self.kf_cap:
            self._grow()
            self._dev = None  # capacity changed: device mirror rebuilt lazily
        i = self.count
        self.poses[i] = np.asarray(pose_rpyxyz, np.float32)
        self.times[i] = time
        cloud_xyz = np.asarray(cloud_xyz, np.float32)
        cloud_mask = np.asarray(cloud_mask, bool)
        if len(cloud_xyz) >= self.cloud_cap:
            cloud_xyz, cloud_mask = subsample_to_cap_np(
                cloud_xyz, cloud_mask, self.cloud_cap
            )
        n = min(len(cloud_xyz), self.cloud_cap)
        self.clouds[i, :n] = cloud_xyz[:n]
        self.clouds[i, n:] = PAD_COORD
        self.cloud_masks[i, :n] = cloud_mask[:n]
        self.cloud_masks[i, n:] = False
        self.sc_descs[i] = np.asarray(sc_desc, np.float32)
        self.sc_keys[i] = np.asarray(sc_key, np.float32)
        self.count += 1
        # incremental device update: only the new row is uploaded, written
        # IN PLACE into the device mirror (the JAX package's _set_row,
        # keyframes.py:53-55, returns a fresh array instead)
        if self._dev is not None:
            d = self._dev
            d["clouds"][i] = self._to_dev(self.clouds[i])
            d["cloud_masks"][i] = self._to_dev(self.cloud_masks[i])
            d["sc_descs"][i] = self._to_dev(self.sc_descs[i])
            d["sc_keys"][i] = self._to_dev(self.sc_keys[i])
            d["poses"] = self._to_dev(self.poses)  # small [K, 6]
        return i

    def update_poses(self, poses_rpyxyz: np.ndarray):
        """Rewrite all keyframe poses after graph relaxation (correctPoses,
        mapOptmization.cpp:1611-1642)."""
        self.poses[: self.count] = poses_rpyxyz[: self.count]
        if self._dev is not None:
            self._dev["poses"] = self._to_dev(self.poses)

    def device_arrays(self):
        """Device mirror of the store (incrementally maintained)."""
        if self._dev is None:
            self._dev = {
                name: self._to_dev(getattr(self, name))
                for name in ("poses", "clouds", "cloud_masks", "sc_descs", "sc_keys")
            }
        return self._dev

    def invalidate_device(self):
        self._dev = None

    def positions(self) -> np.ndarray:
        return self.poses[: self.count, 3:6]


def assemble_local_map(
    kf_poses: torch.Tensor,  # [K, 6] rpyxyz
    kf_clouds: torch.Tensor,  # [K, C, 3]
    kf_cloud_masks: torch.Tensor,  # [K, C]
    kf_times: torch.Tensor,  # [K]
    kf_count,  # [] int (tensor or python int)
    center: torch.Tensor,  # [3] current position
    now,  # [] current time (same clock as kf_times)
    radius: float,
    recent_seconds: float,
    near_cap: int,
    map_cap: int,
    leaf: float,
    cell_size: float,
    density: float = 2.0,
) -> knn.SpatialHashGrid:
    """Select nearby keyframes, fuse their world-frame clouds, voxel-filter,
    and build the correspondence grid.

    Mirrors ``extractNearby``/``extractCloud`` (mapOptmization.cpp:975-1058):
    radius search over keyframe positions, *density-filtered* to one
    keyframe per ``density``-sized position voxel (the reference's
    ``surroundingKeyframeDensity`` downsample of the selected poses,
    :991-997), plus all keyframes from the last `recent_seconds` (appended
    after the density filter, :999-1007), fused and downsampled at `leaf`.
    """
    K = kf_poses.shape[0]
    dev = kf_poses.device
    idx = torch.arange(K, device=dev)
    valid = idx < kf_count
    pos = kf_poses[:, 3:6]
    d2 = torch.sum((pos - center) ** 2, dim=-1)
    near_r = valid & (d2 <= radius * radius)
    recent = valid & ((now - kf_times) < recent_seconds)

    # density filter: keep the keyframe closest to the current position per
    # density cell (exact two-key cell identity: x | packed yz, 15 bits/axis)
    sentinel = 2**31 - 1
    cell = torch.floor(pos / density).to(torch.int32) + (1 << 14)
    cell = torch.clamp(cell, 0, (1 << 15) - 1)
    kx = torch.where(near_r, cell[:, 0], sentinel)
    kyz = torch.where(near_r, (cell[:, 1] << 15) | cell[:, 2], sentinel)
    order = lexsort((d2, kyz, kx))  # group by cell, ties by distance
    kx_s, kyz_s = kx[order], kyz[order]
    first = torch.cat(
        [
            torch.ones((1,), dtype=torch.bool, device=dev),
            (kx_s[1:] != kx_s[:-1]) | (kyz_s[1:] != kyz_s[:-1]),
        ]
    )
    # out of place (a scatter, not a slice write): also runs under vmap
    rep = torch.zeros((K,), dtype=torch.bool, device=dev).scatter(
        0, order, first & near_r[order]
    )
    near = rep | recent

    # take up to near_cap selected keyframes, preferring the closest
    order_key = torch.where(near, d2, torch.inf)
    sel = torch.argsort(order_key, stable=True)[:near_cap]  # [near_cap]
    sel_ok = torch.isfinite(order_key[sel])

    poses_sel = kf_poses[sel]
    clouds_sel = kf_clouds[sel]  # [near_cap, C, 3]
    masks_sel = kf_cloud_masks[sel] & sel_ok[:, None]

    Rw = se3.euler_to_rot(poses_sel[:, :3])  # [near_cap, 3, 3]
    tw = poses_sel[:, 3:6]
    world = torch.einsum("kij,kcj->kci", Rw, clouds_sel) + tw[:, None, :]
    world = torch.where(masks_sel[..., None], world, PAD_COORD)

    flat_xyz = world.reshape(-1, 3)
    flat_mask = masks_sel.reshape(-1)
    ds_xyz, ds_mask = voxel_downsample_xyz(flat_xyz, flat_mask, leaf, map_cap)
    return knn.build_grid(ds_xyz, ds_mask, center, cell_size)
