"""Map export + SLAM-state checkpointing for the device-resident pipeline.

``save_map`` mirrors the reference's save_map service
(``mapOptmization.cpp:379-432``, ``srv/save_map.srv``): writes
trajectory.pcd, transformations.pcd, SurfMap.pcd and GlobalMap.pcd
(optionally voxel-downsampled to a requested resolution).

``save_checkpoint``/``load_checkpoint`` add what the reference lacks: a full
mid-run snapshot so a session can resume. A ``ResidentPipeline`` is written
in this package's format — every field of its ``ResidentState`` as numpy,
the nested filter and grid as dicts of arrays, plus the host-side stream
state — which names no class. A ``LiorfPipeline`` is written in the JAX
package's classic layout. ``load_checkpoint`` also resumes the JAX
package's resident checkpoints (resident-v1 / resident-v2), which pickle a
few of its classes by name: those are read as the port's classes of the
same fields (``JAX_CLASS_MAP``), and a pickle naming any other class is
refused before anything is imported.
"""

from __future__ import annotations

import importlib
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
    """Snapshot a pipeline for resume. A ``ResidentPipeline`` is written in
    this package's format (one pull of the whole state); a ``LiorfPipeline``
    in the JAX package's classic layout (host arrays and builtins, no
    class), which either package can read back."""
    if getattr(pipeline, "state", None) is not None:
        _save_resident(pipeline, path)
        return
    if hasattr(pipeline, "seed_ring_bounds"):
        raise ValueError("save_checkpoint: a ResidentPipeline must process a scan first")
    store = pipeline.store
    n = store.count
    filt = pipeline.filter
    payload = dict(
        count=n,
        poses=store.poses[:n],
        times=store.times[:n],
        clouds=store.clouds[:n],
        cloud_masks=store.cloud_masks[:n],
        sc_descs=store.sc_descs[:n],
        sc_keys=store.sc_keys[:n],
        edges=pipeline.edges,
        gps_factors=pipeline.gps_factors,
        pose_cov=np.asarray(pipeline.pose_cov),
        last_gps_xyz=pipeline.last_gps_xyz,
        loop_index=pipeline.loop_detector.loop_index_container,
        last_pose=pipeline.last_pose,
        last_scan_stamp=pipeline.last_scan_stamp,
        frame_idx=pipeline.frame_idx,
        trajectory=[(f.stamp, f.pose) for f in pipeline.trajectory],
        filter=None if filt is None else dict(
            mean=[x.cpu().numpy() for x in filt.mean],
            sqrt_info=filt.sqrt_info.cpu().numpy(),
        ),
        time_base=pipeline._time_base_val,
    )
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def _save_resident(pipeline, path: str):
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


# The classes a checkpoint of the JAX package pickles by name, each mapped to
# the port's class of the same fields (strings only: the JAX package is never
# imported). resident-v2 names the first four; resident-v1 also pickled the
# ResidentState tuple itself.
JAX_CLASS_MAP = {
    "liorf_tpu.imu.fusion.FusionFilter": "liorf_tpu_torch.imu.fusion.FusionFilter",
    "liorf_tpu.imu.fusion.FusionState": "liorf_tpu_torch.imu.fusion.FusionState",
    "liorf_tpu.ops.knn.SpatialHashGrid": "liorf_tpu_torch.ops.knn.SpatialHashGrid",
    "liorf_tpu.sensors.types.ImuSample": "liorf_tpu_torch.sensors.types.ImuSample",
    "liorf_tpu.pipeline.resident.ResidentState": "liorf_tpu_torch.pipeline.resident.ResidentState",
}

# Defaults for ResidentState fields that a JAX resident-v2 file may lack
# (liorf_tpu/mapping/export.py:30-34): each takes the pipeline's config.
_RESIDENT_FIELD_DEFAULTS = {
    "imu_traj": lambda cfg: np.zeros((cfg.imu_rate_capacity, 8), np.float32),
    "imu_count": lambda cfg: np.asarray(0, np.int32),
    "pending_loop": lambda cfg: np.asarray(False),
}


class _ArraysOnly(pickle.Unpickler):
    """Unpickles builtins, numpy arrays and the JAX package's classes of
    ``JAX_CLASS_MAP`` (as the port's classes) only: unpickling anything else
    could import (and run) code."""

    def find_class(self, module, name):
        if module == "builtins" or module == "numpy" or module.startswith("numpy."):
            return super().find_class(module, name)
        target = JAX_CLASS_MAP.get(f"{module}.{name}")
        if target is not None:
            mod, _, cls = target.rpartition(".")
            return getattr(importlib.import_module(mod), cls)
        raise pickle.UnpicklingError(f"{module}.{name} is not allowed in a checkpoint")


def _jax_resident_state(saved, cfg, path: str) -> dict:
    """The fields of a JAX resident-v1 / v2 state as numpy, completed as the
    JAX loader completes them (liorf_tpu/mapping/export.py:190-225): missing
    fields from ``_RESIDENT_FIELD_DEFAULTS``, a pre-r3 10-column ``traj``
    padded with its re-anchoring columns."""
    from ..pipeline.resident import ResidentState

    fields = dict(saved._asdict()) if hasattr(saved, "_asdict") else dict(saved)
    missing = set(ResidentState._fields) - set(fields)
    unfillable = missing - set(_RESIDENT_FIELD_DEFAULTS)
    if unfillable:
        raise ValueError(
            f"checkpoint {path!r} lacks ResidentState fields {sorted(unfillable)} "
            "with no known default: it was written by an incompatible version"
        )
    fields = {k: fields[k] for k in ResidentState._fields if k in fields}
    for name in missing:
        fields[name] = _RESIDENT_FIELD_DEFAULTS[name](cfg)
    traj = np.asarray(fields["traj"])
    if traj.shape[1] == 10:
        # pre-r3 ring without the (slot, kf-pose-then) columns: anchor every
        # frame on keyframe 0, whose prior keeps it fixed
        anchor = np.asarray(fields["kf_poses"])[0].astype(np.float32)
        pad = np.concatenate(
            [np.zeros((traj.shape[0], 1), np.float32), np.tile(anchor, (traj.shape[0], 1))],
            axis=1,
        )
        fields["traj"] = np.concatenate([traj.astype(np.float32), pad], axis=1)
    return fields


def load_checkpoint(pipeline, path: str):
    """Restore a snapshot into a freshly constructed pipeline, its state on
    the pipeline's device. A ``ResidentPipeline`` takes this package's
    format and the JAX package's resident-v1 / resident-v2; a
    ``LiorfPipeline`` takes the classic layout (written by either package)."""
    with open(path, "rb") as f:
        raw = f.read()
    try:
        payload = _ArraysOnly(io.BytesIO(raw)).load()
    except pickle.UnpicklingError as e:
        raise ValueError(f"{path!r} is not a liorf_tpu_torch checkpoint ({e})") from e
    except TypeError as e:
        # resident-v1 pickled the ResidentState tuple itself: a layout that
        # changed since fails in its constructor
        raise ValueError(
            f"checkpoint {path!r} pickles a ResidentState of another layout "
            "(resident-v1): re-create it with the version that resumes it"
        ) from e
    if not isinstance(payload, dict):
        raise ValueError(f"{path!r} is not a liorf_tpu_torch checkpoint")
    fmt = payload.get("format")
    resident = hasattr(pipeline, "seed_ring_bounds")
    if fmt is None and "count" in payload:
        if resident:
            raise ValueError(f"{path!r} is a classic checkpoint: it needs a LiorfPipeline")
        return _load_classic(pipeline, payload)
    if fmt not in (FORMAT, "resident-v1", "resident-v2"):
        raise ValueError(f"{path!r} is not a {FORMAT} checkpoint")
    if not resident:
        raise ValueError(f"a {fmt} checkpoint needs a ResidentPipeline (make_pipeline(cfg))")
    return _load_resident(pipeline, payload, path)


def _load_resident(pipeline, payload: dict, path: str):
    from ..convert import resident_state_from_arrays

    saved = payload["state"]
    if payload["format"] != FORMAT:
        saved = _jax_resident_state(saved, pipeline.cfg, path)
    state = resident_state_from_arrays(saved, device=pipeline.device)
    pipeline.state = state
    # seed the host-side ring-count bounds and host view from the snapshot
    # (invariant owned by ResidentPipeline)
    pipeline.seed_ring_bounds(state, int(payload["frame_idx"]))
    pipeline._stamps = list(payload["stamps"])
    pipeline._time_base_val = payload["time_base"]
    pipeline.frame_idx = payload["frame_idx"]
    pipeline.last_scan_stamp = payload["last_scan_stamp"]
    # this package's tuples, or the JAX package's ImuSample read as the port's
    pipeline.imu_queue = [
        s if isinstance(s, ImuSample) else ImuSample(*s) for s in payload["imu_queue"]
    ]
    pipeline.gps_queue = list(payload["gps_queue"])
    if payload["gps_datum"] is not None:
        pipeline.gps_conv._datum = payload["gps_datum"]
    pipeline._synced = False
    return pipeline


def _load_classic(pipeline, state: dict):
    """The classic layout into a ``LiorfPipeline``
    (liorf_tpu/mapping/export.py:239-272): the keyframe store grown to fit,
    the host lists, the filter rebuilt on the pipeline's device, the local
    map rebuilt around the last pose."""
    from ..imu.fusion import FusionFilter, FusionState
    from ..pipeline.slam import FrameResult

    store = pipeline.store
    n = state["count"]
    while store.kf_cap < n:
        store._grow()
    store.count = n
    store.poses[:n] = state["poses"]
    store.times[:n] = state["times"]
    store.clouds[:n] = state["clouds"]
    store.cloud_masks[:n] = state["cloud_masks"]
    store.sc_descs[:n] = state["sc_descs"]
    store.sc_keys[:n] = state["sc_keys"]
    store.invalidate_device()
    pipeline.edges = state["edges"]
    pipeline.gps_factors = state["gps_factors"]
    if "pose_cov" in state:
        pipeline.pose_cov = np.asarray(state["pose_cov"], np.float64)
        pipeline.last_gps_xyz = state["last_gps_xyz"]
    pipeline.loop_detector.loop_index_container = state["loop_index"]
    pipeline.last_pose = state["last_pose"]
    pipeline.last_scan_stamp = state["last_scan_stamp"]
    pipeline.frame_idx = state["frame_idx"]
    pipeline.trajectory = [
        FrameResult(stamp=t, pose=p, degenerate=False, is_keyframe=False, num_matched=0)
        for t, p in state["trajectory"]
    ]
    if state["filter"] is not None:
        dev = pipeline.device
        mean = FusionState(*[torch.as_tensor(x, dtype=torch.float32, device=dev)
                             for x in state["filter"]["mean"]])
        pipeline.filter = FusionFilter(
            mean=mean,
            sqrt_info=torch.as_tensor(state["filter"]["sqrt_info"], dtype=torch.float32, device=dev),
        )
    pipeline._time_base_val = state["time_base"]
    if n and pipeline.last_scan_stamp is not None:
        pipeline._rebuild_grid(pipeline.last_pose, pipeline.last_scan_stamp)
    return pipeline
