"""Map export + SLAM-state checkpointing for the device-resident pipeline.

``save_map`` mirrors the reference's save_map service
(``mapOptmization.cpp:379-432``, ``srv/save_map.srv``): writes
trajectory.pcd, transformations.pcd, SurfMap.pcd and GlobalMap.pcd
(optionally voxel-downsampled to a requested resolution).

``save_checkpoint``/``load_checkpoint`` add what the reference lacks: a full
mid-run snapshot of a ``ResidentPipeline`` — every field of its
``ResidentState`` as numpy, the nested filter and grid as dicts of arrays,
plus the host-side stream state — so a session can resume. Unpickling one
needs no class of either package, and ``load_checkpoint`` refuses any
pickle that names one (the JAX package's checkpoints pickle its own
NamedTuples, so they cannot be read here).
"""

from __future__ import annotations

import io
import os
import pickle

import numpy as np
import torch

from ..core import se3np
from ..core.pointcloud import make_cloud
from ..core.voxel import voxel_downsample
from ..sensors.types import ImuSample
from ..utils.pcdio import save_pcd

FORMAT = "liorf_tpu_torch-resident-v1"


def global_map_points(store, max_points_per_kf: int | None = None) -> np.ndarray:
    """All keyframe clouds fused in the world frame -> [N, 4] xyzi."""
    pts = []
    for k in range(store.count):
        mask = store.cloud_masks[k]
        cloud = store.clouds[k][mask]
        if max_points_per_kf:
            cloud = cloud[:max_points_per_kf]
        pose = store.poses[k]
        R = se3np.euler_to_rot(pose[:3]).astype(np.float32)
        world = cloud @ R.T + pose[3:6]
        inten = np.full(len(world), float(k), np.float32)
        pts.append(np.concatenate([world, inten[:, None]], axis=1))
    if not pts:
        return np.zeros((0, 4), np.float32)
    return np.concatenate(pts).astype(np.float32)


def save_map(pipeline, directory: str, resolution: float = 0.0) -> bool:
    """Write trajectory/transformations/SurfMap/GlobalMap PCDs from the
    pipeline's host keyframe store (call ``sync_store()`` first on a
    ``ResidentPipeline``). The voxel filter runs on the pipeline's device."""
    os.makedirs(directory, exist_ok=True)
    store = pipeline.store
    k = store.count
    poses = store.poses[:k]
    times = store.times[:k]

    save_pcd(
        os.path.join(directory, "trajectory.pcd"),
        dict(
            x=poses[:, 3], y=poses[:, 4], z=poses[:, 5],
            intensity=np.arange(k, dtype=np.float32),
        ),
    )
    save_pcd(
        os.path.join(directory, "transformations.pcd"),
        dict(
            x=poses[:, 3], y=poses[:, 4], z=poses[:, 5],
            intensity=np.arange(k, dtype=np.float32),
            roll=poses[:, 0], pitch=poses[:, 1], yaw=poses[:, 2],
            time=(times - (times[0] if k else 0.0)).astype(np.float32),
        ),
    )

    cloud = global_map_points(store)
    if resolution > 0 and len(cloud):
        cap = 1 << int(np.ceil(np.log2(max(len(cloud), 2))))
        pc = make_cloud(
            cloud[:, :3], intensity=cloud[:, 3], capacity=cap, device=pipeline.device
        )
        ds = voxel_downsample(pc, resolution)
        m = ds.cloud.mask.cpu().numpy()
        cloud = np.concatenate(
            [ds.cloud.xyz.cpu().numpy()[m], ds.cloud.intensity.cpu().numpy()[m][:, None]],
            axis=1,
        )
    for name in ("SurfMap.pcd", "GlobalMap.pcd"):
        save_pcd(
            os.path.join(directory, name),
            dict(x=cloud[:, 0], y=cloud[:, 1], z=cloud[:, 2], intensity=cloud[:, 3]),
        )
    return True


def _to_arrays(x):
    """State tree -> numpy: NamedTuples become dicts of their fields."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if hasattr(x, "_asdict"):
        return {k: _to_arrays(v) for k, v in x._asdict().items()}
    return x


def save_checkpoint(pipeline, path: str):
    """Snapshot a ``ResidentPipeline`` for resume (one pull of the whole
    state). The classic pipeline's host-structured format is not ported."""
    if getattr(pipeline, "state", None) is None:
        raise NotImplementedError(
            "save_checkpoint: only a ResidentPipeline (make_pipeline(cfg)) that "
            "has processed a scan can be checkpointed by this package"
        )
    payload = dict(
        format=FORMAT,
        state=_to_arrays(pipeline.state),
        stamps=list(getattr(pipeline, "_stamps", [])),
        time_base=pipeline._time_base_val,
        frame_idx=pipeline.frame_idx,
        last_scan_stamp=pipeline.last_scan_stamp,
        # IMU samples as plain tuples: the file names no class
        imu_queue=[
            (s.stamp, np.asarray(s.acc), np.asarray(s.gyr),
             None if s.quat_wxyz is None else np.asarray(s.quat_wxyz))
            for s in pipeline.imu_queue[-1024:]
        ],
        gps_queue=list(pipeline.gps_queue),
        gps_datum=pipeline.gps_conv._datum,
    )
    with open(path, "wb") as f:
        pickle.dump(payload, f)


class _ArraysOnly(pickle.Unpickler):
    """Unpickles builtins and numpy arrays only: a checkpoint of this
    package names no other class, and unpickling anything else could import
    (and run) code."""

    def find_class(self, module, name):
        if module == "builtins" or module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"{module}.{name} is not allowed in a checkpoint")


def load_checkpoint(pipeline, path: str):
    """Restore a ``save_checkpoint`` snapshot into a freshly constructed
    ``ResidentPipeline``; the state goes to the pipeline's device."""
    from ..convert import resident_state_from_arrays

    if not hasattr(pipeline, "seed_ring_bounds"):
        raise ValueError("load_checkpoint needs a ResidentPipeline (make_pipeline(cfg))")
    with open(path, "rb") as f:
        raw = f.read()
    try:
        payload = _ArraysOnly(io.BytesIO(raw)).load()
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path!r} is not a liorf_tpu_torch checkpoint ({e}); checkpoints of "
            "the JAX package cannot be resumed by the port"
        ) from e
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"{path!r} is not a {FORMAT} checkpoint")
    state = resident_state_from_arrays(payload["state"], device=pipeline.device)
    pipeline.state = state
    # seed the host-side ring-count bounds and host view from the snapshot
    # (invariant owned by ResidentPipeline)
    pipeline.seed_ring_bounds(state, int(payload["frame_idx"]))
    pipeline._stamps = list(payload["stamps"])
    pipeline._time_base_val = payload["time_base"]
    pipeline.frame_idx = payload["frame_idx"]
    pipeline.last_scan_stamp = payload["last_scan_stamp"]
    pipeline.imu_queue = [ImuSample(*s) for s in payload["imu_queue"]]
    pipeline.gps_queue = list(payload["gps_queue"])
    if payload["gps_datum"] is not None:
        pipeline.gps_conv._datum = payload["gps_datum"]
    pipeline._synced = False
    return pipeline
