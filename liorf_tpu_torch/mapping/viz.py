"""Visualization export — the off-ROS equivalent of the reference's rviz
topics (trajectory/path, global & local maps, registered clouds, loop
markers; ``mapOptmization.cpp:846-897,1732-1783``). Port of
``liorf_tpu/mapping/viz.py``: the same functions, names and output bytes,
numpy and matplotlib only; the loop pairs of a resident pipeline are read
from its (device) state in one host read.

Artifacts instead of topics:

* ``export_ply`` — colored PLY point clouds (trajectory polyline, global map
  height-colored, loop-constraint line segments) for MeshLab/CloudCompare;
* ``render_overview`` — a PNG top-down overview (trajectory + map + loop
  markers + optional ground truth) via matplotlib (Agg).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .export import global_map_points


def _write_ply(path: str, xyz: np.ndarray, rgb: np.ndarray,
               edges: np.ndarray | None = None):
    """ASCII PLY with optional line elements (edge list into the vertices)."""
    n = len(xyz)
    ne = 0 if edges is None else len(edges)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        if ne:
            f.write(f"element edge {ne}\n")
            f.write("property int vertex1\nproperty int vertex2\n")
        f.write("end_header\n")
        for p, c in zip(xyz, rgb):
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c[0]} {c[1]} {c[2]}\n")
        if ne:
            for a, b in edges:
                f.write(f"{a} {b}\n")


def _height_colors(z: np.ndarray) -> np.ndarray:
    """Blue->green->red ramp over the z range (rviz axis-color style)."""
    lo, hi = np.percentile(z, 2), np.percentile(z, 98)
    t = np.clip((z - lo) / max(hi - lo, 1e-6), 0, 1)
    r = np.clip(2 * t - 1, 0, 1)
    g = 1 - np.abs(2 * t - 1)
    b = np.clip(1 - 2 * t, 0, 1)
    return (np.stack([r, g, b], 1) * 255).astype(np.uint8)


def _loop_pairs(pipeline) -> np.ndarray:
    """[(i, j)] accepted loop-closure keyframe pairs, if any. A resident
    pipeline's ``l_count`` / ``l_i`` / ``l_j`` come back in one read."""
    st = getattr(pipeline, "state", None)
    if st is not None:
        L = st.l_i.shape[0]
        flat = torch.cat([st.l_count.reshape(1), st.l_i, st.l_j]).cpu().numpy()
        n = int(flat[0])
        if n:
            return np.stack([flat[1:1 + n], flat[1 + L:1 + L + n]], 1)
        return np.zeros((0, 2), np.int64)
    pairs = getattr(getattr(pipeline, "loop_detector", None),
                    "loop_index_container", {}) or {}
    return np.asarray([(j, i) for i, j in pairs.items()], np.int64).reshape(-1, 2)


def export_ply(pipeline, directory: str, max_map_points: int = 500_000) -> dict:
    """Write trajectory.ply, map.ply, loops.ply; returns artifact paths."""
    os.makedirs(directory, exist_ok=True)
    if hasattr(pipeline, "sync_store"):
        pipeline.sync_store()
    store = pipeline.store
    k = store.count
    poses = store.poses[:k]

    out = {}
    traj_xyz = poses[:, 3:6].astype(np.float32)
    traj_rgb = np.tile(np.array([[255, 200, 0]], np.uint8), (k, 1))
    traj_edges = np.stack([np.arange(k - 1), np.arange(1, k)], 1) if k > 1 else None
    out["trajectory"] = os.path.join(directory, "trajectory.ply")
    _write_ply(out["trajectory"], traj_xyz, traj_rgb, traj_edges)

    gm = global_map_points(store)
    if len(gm) > max_map_points:
        sel = np.linspace(0, len(gm) - 1, max_map_points).astype(int)
        gm = gm[sel]
    out["map"] = os.path.join(directory, "map.ply")
    _write_ply(out["map"], gm[:, :3], _height_colors(gm[:, 2]))

    pairs = _loop_pairs(pipeline)
    pairs = pairs[(pairs[:, 0] < k) & (pairs[:, 1] < k)] if len(pairs) else pairs
    if len(pairs):
        pts = poses[np.asarray(pairs).ravel(), 3:6].astype(np.float32)
        rgb = np.tile(np.array([[255, 0, 255]], np.uint8), (len(pts), 1))
        edges = np.arange(len(pts)).reshape(-1, 2)
        out["loops"] = os.path.join(directory, "loops.ply")
        _write_ply(out["loops"], pts, rgb, edges)
    return out


def render_overview(pipeline, path: str, gt: np.ndarray | None = None,
                    max_map_points: int = 200_000) -> str:
    """Top-down PNG: map (height-colored), trajectory, loop markers.
    Raises ImportError where matplotlib is not installed."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if hasattr(pipeline, "sync_store"):
        pipeline.sync_store()
    store = pipeline.store
    k = store.count
    poses = store.poses[:k]

    gm = global_map_points(store)
    if len(gm) > max_map_points:
        sel = np.linspace(0, len(gm) - 1, max_map_points).astype(int)
        gm = gm[sel]

    fig, ax = plt.subplots(figsize=(10, 10), dpi=110)
    if len(gm):
        ax.scatter(gm[:, 0], gm[:, 1], c=gm[:, 2], s=0.2, cmap="viridis",
                   alpha=0.5, linewidths=0, rasterized=True)
    if gt is not None and len(gt):
        ax.plot(gt[:, 0], gt[:, 1], "-", color="0.4", lw=1.2, label="ground truth")
    if k:
        ax.plot(poses[:, 3], poses[:, 4], "-", color="crimson", lw=1.6,
                label="trajectory")
        ax.plot(poses[0, 3], poses[0, 4], "o", color="crimson", ms=6)
    pairs = _loop_pairs(pipeline)
    pairs = pairs[(pairs[:, 0] < k) & (pairs[:, 1] < k)] if len(pairs) else pairs
    for a, b in pairs:
        ax.plot(poses[[a, b], 3], poses[[a, b], 4], "-", color="magenta",
                lw=1.0, alpha=0.9)
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.legend(loc="upper right", fontsize=9)
    ax.set_title(f"liorf_tpu_torch — {k} keyframes, {len(pairs)} loop constraints")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path
