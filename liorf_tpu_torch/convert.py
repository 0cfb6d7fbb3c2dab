"""Carry SLAM state across from the JAX package as plain numpy arrays.

There are no weights in this system; the state is the SLAM state. Each
function takes the fields of one of the JAX package's state tuples as numpy
arrays / Python values (the caller does the ``np.asarray``; nothing here
imports JAX) and builds the port's counterpart on ``device``, so one frame
can be run from identical state on both sides. ``device=None`` means
``cuda`` and raises when there is none, as on every entry point of the port.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.device import resolve_device
from .graph.pose_graph import PoseGraph
from .imu.fusion import FusionFilter, FusionParams, FusionState
from .imu.preintegration import ImuParams, Preintegrated
from .mapping.keyframes import KeyframeStore
from .ops.knn import SpatialHashGrid
from .ops.scan_match import ScanMatchParams
from .pipeline.frame_step import FrameParams
from .pipeline.resident import ResidentParams, ResidentState


def _tensor(a, device, dtype=None) -> torch.Tensor:
    device = resolve_device(device, "liorf_tpu_torch.convert")
    a = np.asarray(a)
    if dtype is None and a.dtype == np.float64:
        dtype = torch.float32
    return torch.tensor(a, dtype=dtype, device=device)


def grid_from_arrays(fields: Mapping, device=None) -> SpatialHashGrid:
    """``SpatialHashGrid`` from {xyz, keys, mask, origin, cell_size}."""
    return SpatialHashGrid(
        xyz=_tensor(fields["xyz"], device, torch.float32),
        keys=_tensor(fields["keys"], device, torch.int32),
        mask=_tensor(fields["mask"], device, torch.bool),
        origin=_tensor(fields["origin"], device, torch.float32),
        cell_size=_tensor(fields["cell_size"], device, torch.float32),
    )


def fusion_filter_from_arrays(mean: Mapping, sqrt_info, device=None) -> FusionFilter:
    """``FusionFilter`` from the mean's {R, p, v, ba, bg} and sqrt_info."""
    return FusionFilter(
        mean=FusionState(
            **{k: _tensor(mean[k], device, torch.float32) for k in FusionState._fields}
        ),
        sqrt_info=_tensor(sqrt_info, device, torch.float32),
    )


def preintegrated_from_arrays(fields: Mapping, device=None) -> Preintegrated:
    return Preintegrated(
        **{k: _tensor(fields[k], device, torch.float32) for k in Preintegrated._fields}
    )


def pose_graph_from_arrays(fields: Mapping, device=None) -> PoseGraph:
    """``PoseGraph`` from its fields; index fields become int64 (torch's
    index type), masks bool, the rest float32."""
    out = {}
    for k in PoseGraph._fields:
        if k in ("e_i", "e_j", "g_i", "prior_i"):
            dtype = torch.int64
        elif k.endswith("mask"):
            dtype = torch.bool
        else:
            dtype = torch.float32
        out[k] = _tensor(fields[k], device, dtype)
    return PoseGraph(**out)


def keyframe_store_from_arrays(fields: Mapping, count: int, device=None):
    """``KeyframeStore`` from the host arrays {poses, times, clouds,
    cloud_masks, sc_descs, sc_keys} of the JAX package's store."""
    clouds = np.asarray(fields["clouds"], np.float32)
    store = KeyframeStore(
        cloud_capacity=clouds.shape[1], initial_kf_capacity=clouds.shape[0],
        device=device,
    )
    store.poses = np.array(fields["poses"], np.float32)
    store.times = np.array(fields["times"], np.float64)
    store.clouds = clouds.copy()
    store.cloud_masks = np.array(fields["cloud_masks"], bool)
    store.sc_descs = np.array(fields["sc_descs"], np.float32)
    store.sc_keys = np.array(fields["sc_keys"], np.float32)
    store.count = int(count)
    return store


def _as_dict(v) -> dict:
    """A mapping, or a NamedTuple of either package, as a dict."""
    return dict(v._asdict()) if hasattr(v, "_asdict") else dict(v)


def resident_state_from_arrays(fields: Mapping, device=None) -> ResidentState:
    """``ResidentState`` from its fields as numpy (the JAX package's state
    pulled with ``np.asarray`` per leaf, or a checkpoint of the port), with
    ``filt`` as {mean: {R, p, v, ba, bg}, sqrt_info} and ``grid`` as the
    fields of ``grid_from_arrays``; the nested tuples may also be given as
    NamedTuples. Integer fields become int64 (torch's index type), bools
    bool, the rest float32."""
    fields = _as_dict(fields)
    filt = _as_dict(fields["filt"])
    out = {
        "filt": fusion_filter_from_arrays(
            _as_dict(filt["mean"]), filt["sqrt_info"], device
        ),
        "grid": grid_from_arrays(_as_dict(fields["grid"]), device),
    }
    for name in ResidentState._fields:
        if name in out:
            continue
        a = np.asarray(fields[name])
        if a.dtype == bool:
            dtype = torch.bool
        elif np.issubdtype(a.dtype, np.integer):
            dtype = torch.int64
        else:
            dtype = torch.float32
        out[name] = _tensor(a, device, dtype)
    return ResidentState(**out)


def scan_match_params(values: Mapping) -> ScanMatchParams:
    return ScanMatchParams(**dict(values))


def frame_params(values: Mapping) -> FrameParams:
    """``FrameParams`` from ``jax_params._asdict()`` with ``match``,
    ``fusion`` and ``fusion.imu`` given as nested mappings or tuples."""

    values = dict(values)
    fusion = _as_dict(values["fusion"])
    fusion["imu"] = ImuParams(**_as_dict(fusion["imu"]))
    values["fusion"] = FusionParams(**fusion)
    values["match"] = ScanMatchParams(**_as_dict(values["match"]))
    return FrameParams(**values)


def resident_params(values: Mapping) -> ResidentParams:
    """``ResidentParams`` from ``jax_params._asdict()``, ``frame`` nested as
    in ``frame_params``."""
    values = dict(values)
    values["frame"] = frame_params(_as_dict(values["frame"]))
    return ResidentParams(**values)
