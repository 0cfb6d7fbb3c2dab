"""Typed configuration mirroring the reference's ParamServer.

Every field keeps the reference's parameter name and default where it maps
(``liorf/include/utility.h:156-255``, ``config/*.yaml``); YAML
files written for the reference (the ``liorf:`` namespace) load directly.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np

try:
    import yaml  # type: ignore

    _HAVE_YAML = True
except Exception:  # pragma: no cover
    _HAVE_YAML = False


@dataclass
class SlamConfig:
    # Topics / frames (kept for config-file compatibility; unused off-ROS)
    pointCloudTopic: str = "points_raw"
    imuTopic: str = "imu_raw"
    odomTopic: str = "odometry/imu"
    gpsTopic: str = "gps/fix"
    lidarFrame: str = "base_link"
    baselinkFrame: str = "base_link"
    odometryFrame: str = "odom"
    mapFrame: str = "map"

    # GPS
    useImuHeadingInitialization: bool = False
    useGpsElevation: bool = False
    gpsCovThreshold: float = 2.0
    poseCovThreshold: float = 25.0

    # Export
    savePCD: bool = False
    savePCDDirectory: str = "liorf_maps/"

    # Sensor
    sensor: str = "velodyne"  # velodyne|ouster|livox|robosense|mulran
    N_SCAN: int = 64
    Horizon_SCAN: int = 1800
    downsampleRate: int = 1
    point_filter_num: int = 3
    lidarMinRange: float = 1.0
    lidarMaxRange: float = 1000.0
    # gyro motion compensation (imageProjection deskewPoint); off = feed the
    # raw sweep to registration — only for deskew-efficacy stress tests
    deskewEnabled: bool = True

    # IMU
    imuType: int = 0  # 0: 6-axis, 1: 9-axis
    imuRate: float = 100.0
    imuAccNoise: float = 3.9939570888238808e-03
    imuGyrNoise: float = 1.5636343949698187e-03
    imuAccBiasN: float = 6.4356659353532566e-05
    imuGyrBiasN: float = 3.5640318696367613e-05
    imuGravity: float = 9.80511
    imuRPYWeight: float = 0.01
    extrinsicTrans: list = field(default_factory=lambda: [0.0, 0.0, 0.0])
    extrinsicRot: list = field(default_factory=lambda: np.eye(3).ravel().tolist())
    extrinsicRPY: list = field(default_factory=lambda: np.eye(3).ravel().tolist())

    # Voxel sizes
    mappingSurfLeafSize: float = 0.4

    # Motion constraint
    z_tollerance: float = 1000.0
    rotation_tollerance: float = 1000.0

    # CPU params (kept for compat; parallelism is XLA-native here)
    numberOfCores: int = 4
    mappingProcessInterval: float = 0.0

    # Surrounding map
    surroundingkeyframeAddingDistThreshold: float = 1.0
    surroundingkeyframeAddingAngleThreshold: float = 0.2
    surroundingKeyframeDensity: float = 2.0
    surroundingKeyframeSearchRadius: float = 50.0
    surroundingKeyframeMapLeafSize: float = 0.5

    # Loop closure
    loopClosureEnableFlag: bool = True
    loopClosureFrequency: float = 1.0
    surroundingKeyframeSize: int = 50
    historyKeyframeSearchRadius: float = 15.0
    historyKeyframeSearchTimeDiff: float = 30.0
    historyKeyframeSearchNum: int = 25
    loopClosureICPSurfLeafSize: float = 0.5
    historyKeyframeFitnessScore: float = 0.3
    # loop acceptance gates beyond the reference's fitness check (see
    # pipeline/resident.py ResidentParams): minimum ICP inlier fraction,
    # and a drift-budget consistency bound on the implied correction
    # (floor + budget * keyframe-index-gap * keyframe spacing). Set
    # loopMinInlierFrac=0 and loopCorrectionFloor=inf for strict
    # reference-parity acceptance.
    loopMinInlierFrac: float = 0.4
    loopDriftBudget: float = 0.05
    loopCorrectionFloor: float = 2.0

    # Visualization (kept for config compat)
    globalMapVisualizationSearchRadius: float = 1000.0
    globalMapVisualizationPoseDensity: float = 10.0
    globalMapVisualizationLeafSize: float = 1.0

    # --- fixed-capacity engine sizes (not in the reference) ---
    scan_capacity: int = 16384
    # raw (pre-voxel-downsample) padded scan size; None = scan_capacity.
    # Dense lidars (e.g. HDL-64's ~120k pts) need raw_capacity >= the
    # filtered point count — a too-small pack cap PREFIX-truncates the
    # scan to its lowest rings and silently wrecks registration accuracy —
    # while scan_capacity keeps the post-downsample working set small.
    raw_capacity: int | None = None
    map_capacity: int = 131072
    kf_cloud_capacity: int = 8192
    near_kf_capacity: int = 64
    imu_window: int = 256
    grid_cell_size: float = 1.0
    graph_window: int = 16  # trailing-window incremental solve size
    kf_capacity: int = 1024  # device-resident keyframe ring capacity
    traj_capacity: int = 8192  # device-resident trajectory ring capacity
    gps_capacity: int = 256  # device-resident GPS factor ring capacity
    loop_capacity: int = 128  # device-resident loop-factor ring capacity
    # device-resident IMU-rate odometry ring (one entry per IMU sample;
    # the reference's odometry/imu stream) — 2 MB at the default
    imu_rate_capacity: int = 65536
    # grow device rings from the host-side count UPPER BOUNDS instead of
    # pulling the exact device counts (used by the device-resident
    # pipeline only). Cost: the keyframe ring is sized by the
    # frame-count bound (O(frames), ~2-4x more memory than O(keyframes)).
    pull_free_growth: bool = False
    # Quiet CPython gen-2 GC after warmup (utils/gc_control.py): a full
    # collection is a ~400 ms stop-the-world pause mid-stream otherwise.
    gc_low_latency: bool = True

    @property
    def raw_cap(self) -> int:
        return self.raw_capacity if self.raw_capacity is not None else self.scan_capacity

    @property
    def ext_rot(self) -> np.ndarray:
        return np.asarray(self.extrinsicRot, np.float64).reshape(3, 3)

    @property
    def ext_rpy(self) -> np.ndarray:
        return np.asarray(self.extrinsicRPY, np.float64).reshape(3, 3)

    @property
    def ext_trans(self) -> np.ndarray:
        return np.asarray(self.extrinsicTrans, np.float64).reshape(3)


def load_config(path: str) -> SlamConfig:
    """Load a reference-format YAML (the `liorf:` namespace) into SlamConfig."""
    if not _HAVE_YAML:  # pragma: no cover
        raise RuntimeError("pyyaml not available")
    with open(path) as f:
        raw = yaml.safe_load(f)
    params = raw.get("liorf", raw)
    cfg = SlamConfig()
    names = {f.name for f in dataclasses.fields(SlamConfig)}
    for k, v in params.items():
        if k in names:
            setattr(cfg, k, v)
    if cfg.raw_capacity is None and "N_SCAN" in params:
        # size the raw (pre-downsample) pack buffer for the sensor: a pack
        # cap below the filtered point count PREFIX-truncates the scan to
        # its lowest rings (silent accuracy loss on dense lidars)
        pts = cfg.N_SCAN * cfg.Horizon_SCAN
        pts = pts // max(1, cfg.point_filter_num)
        if cfg.downsampleRate > 1:
            pts = pts // cfg.downsampleRate
        cfg.raw_capacity = max(cfg.scan_capacity, -(-pts // 4096) * 4096)
    return cfg
