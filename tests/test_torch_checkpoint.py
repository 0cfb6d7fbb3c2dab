"""Both checkpoint formats in the port, and resuming the JAX package's files.

* The JAX ``ResidentPipeline`` writes a resident-v2 checkpoint mid-run; the
  port resumes it and runs on, held to the uninterrupted JAX run.
* A resident-v2 file without the fields added after it was introduced loads
  with the JAX loader's defaults, and a pre-r3 trajectory ring is padded.
* The classic ``LiorfPipeline`` layout round-trips in the port, and the same
  state written by the JAX package's ``save_checkpoint`` resumes alike.
* A pickle naming any other class of the JAX package is refused.

The resident size and settings are tests/test_torch_gps.py's (its GPS gate
open, no fix fed here), so one JAX program, compiled once into the
persistent cache, serves both files; the port's own resume across loop
closures is tests/test_torch_resident.py's.
"""

import pickle

import numpy as np
import pytest

from liorf_tpu.imu.fusion import FusionFilter as JFusionFilter
from liorf_tpu.imu.fusion import FusionState as JFusionState
from liorf_tpu.mapping.export import save_checkpoint as jsave_checkpoint
from liorf_tpu.pipeline import LiorfPipeline as JLiorf
from liorf_tpu.pipeline import ResidentPipeline as JResident
from liorf_tpu.pipeline import SlamConfig as JConfig
from liorf_tpu.sensors.synthetic import SyntheticConfig, SyntheticDataset
from liorf_tpu_torch.mapping.export import load_checkpoint, save_checkpoint
from liorf_tpu_torch.pipeline import LiorfPipeline, ResidentPipeline, SlamConfig

N_FRAMES = 5
CKPT_AT = 3  # frames processed before the checkpoint
_KW = dict(
    scan_capacity=4096, map_capacity=16384, kf_cloud_capacity=4096,
    near_kf_capacity=8, imu_window=32, mappingSurfLeafSize=0.2,
    surroundingKeyframeMapLeafSize=0.2, point_filter_num=1, downsampleRate=1,
    N_SCAN=16, loopClosureEnableFlag=False, surroundingkeyframeAddingDistThreshold=0.3,
    kf_capacity=32, traj_capacity=64, gps_capacity=8, loop_capacity=8,
    imu_rate_capacity=1024, poseCovThreshold=0.0,
)


@pytest.fixture(scope="module")
def streams():
    syn = SyntheticDataset(SyntheticConfig(n_frames=N_FRAMES, n_rings=16, points_per_ring=250))
    return [syn.scan(f) for f in range(N_FRAMES)], syn.imu_stream()


def _drive(pipe, streams, lo=0, hi=N_FRAMES, at=None, hook=None):
    """Feed frames [lo, hi) with their IMU samples; ``hook(pipe)`` runs
    once ``at`` frames are done."""
    scans, imu = streams
    ii = 0
    for f in range(hi):
        scan = scans[f]
        while ii < len(imu) and imu[ii].stamp <= scan.end_time + 0.02:
            if f >= lo:
                pipe.push_imu(imu[ii])
            ii += 1
        if f >= lo:
            pipe.process_scan(scan)
        if hook is not None and f + 1 == at:
            hook(pipe)
    return pipe


@pytest.fixture(scope="module")
def jax_run(streams, tmp_path_factory):
    """The JAX ResidentPipeline over the whole run, writing its resident-v2
    checkpoint after CKPT_AT frames."""
    ckpt = str(tmp_path_factory.mktemp("jax_resident") / "ckpt.pkl")
    pipe = JResident(JConfig(**_KW))
    _drive(pipe, streams, at=CKPT_AT, hook=lambda p: jsave_checkpoint(p, ckpt))
    return pipe, ckpt


def _counts(state):
    return {k: int(np.asarray(getattr(state, k)))
            for k in ("kf_count", "l_count", "g_count", "traj_count", "imu_count")}


def test_resume_jax_resident_checkpoint(jax_run, streams):
    """The port resumes the JAX package's resident-v2 file and runs to the
    end: the trajectory and keyframe poses within the resident file's 1e-3
    (m, rad) of the JAX run without the break, the same stamps and counts."""
    jp, ckpt = jax_run
    with open(ckpt, "rb") as f:
        assert pickle.load(f)["format"] == "resident-v2"
    resumed = ResidentPipeline(SlamConfig(**_KW), device="cpu")
    load_checkpoint(resumed, ckpt)
    assert resumed.frame_idx == CKPT_AT and resumed._host.kf_count == CKPT_AT
    assert resumed.imu_queue and type(resumed.imu_queue[0]).__module__ == "liorf_tpu_torch.sensors.types"
    _drive(resumed, streams, lo=CKPT_AT)
    jt, jposes = jp.trajectory_arrays()
    tt, tposes = resumed.trajectory_arrays()
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tposes, jposes, atol=1e-3)
    assert _counts(resumed.state) == _counts(jp.state)
    n = int(jp.state.kf_count)
    np.testing.assert_allclose(resumed.state.kf_poses[:n].numpy(), np.asarray(jp.state.kf_poses)[:n],
                               atol=1e-3)


def test_jax_checkpoint_missing_fields_take_defaults(jax_run, tmp_path):
    """A resident-v2 file written before imu_traj / imu_count / pending_loop
    existed loads with the JAX loader's defaults; a pre-r3 ten-column
    trajectory ring gets its re-anchoring columns (keyframe 0's pose)."""
    _, ckpt = jax_run
    with open(ckpt, "rb") as f:
        payload = pickle.load(f)
    for name in ("imu_traj", "imu_count", "pending_loop"):
        del payload["state"][name]
    full_traj = np.asarray(payload["state"]["traj"])
    payload["state"]["traj"] = full_traj[:, :10]
    old = str(tmp_path / "old.pkl")
    with open(old, "wb") as f:
        pickle.dump(payload, f)
    cfg = SlamConfig(**_KW)
    pipe = load_checkpoint(ResidentPipeline(cfg, device="cpu"), old)
    st = pipe.state
    assert int(st.imu_count) == 0 and not bool(st.pending_loop)
    assert tuple(st.imu_traj.shape) == (cfg.imu_rate_capacity, 8) and not st.imu_traj.any()
    assert tuple(st.traj.shape) == full_traj.shape
    np.testing.assert_array_equal(st.traj[:, :10].numpy(), full_traj[:, :10])
    np.testing.assert_array_equal(st.traj[:, 10].numpy(), 0.0)
    anchor = np.asarray(payload["state"]["kf_poses"])[0]
    np.testing.assert_array_equal(st.traj[:, 11:].numpy(), np.tile(anchor, (full_traj.shape[0], 1)))


def _jax_classic_twin(pipe):
    """A JAX LiorfPipeline holding the port pipeline's host state, for the
    JAX package's classic save_checkpoint."""
    j = JLiorf(JConfig(**_KW))
    n = pipe.store.count
    while j.store.kf_cap < n:
        j.store._grow()
    j.store.count = n
    for name in ("poses", "times", "clouds", "cloud_masks", "sc_descs", "sc_keys"):
        getattr(j.store, name)[:n] = getattr(pipe.store, name)[:n]
    for name in ("edges", "gps_factors", "pose_cov", "last_gps_xyz", "last_pose",
                 "last_scan_stamp", "frame_idx", "trajectory", "_time_base_val"):
        setattr(j, name, getattr(pipe, name))
    j.loop_detector.loop_index_container = pipe.loop_detector.loop_index_container
    j.filter = JFusionFilter(
        mean=JFusionState(*[x.numpy() for x in pipe.filter.mean]),
        sqrt_info=pipe.filter.sqrt_info.numpy(),
    )
    return j


def test_classic_checkpoint_round_trip(streams, tmp_path):
    """LiorfPipeline save -> load -> next frame, in the port: the store,
    last pose and trajectory come back and the next frame is finite
    (tests/test_export_cli.py:39-55). The same state written by the JAX
    package's classic save_checkpoint loads alike, and the next frame from
    it equals the next frame from the port's own file."""
    cfg = SlamConfig(**_KW)
    pipe = _drive(LiorfPipeline(cfg, device="cpu"), streams, hi=CKPT_AT)
    own, theirs = str(tmp_path / "own.pkl"), str(tmp_path / "jax.pkl")
    save_checkpoint(pipe, own)
    jsave_checkpoint(_jax_classic_twin(pipe), theirs)
    results = []
    for path in (own, theirs):
        back = load_checkpoint(LiorfPipeline(cfg, device="cpu"), path)
        assert back.store.count == pipe.store.count
        np.testing.assert_array_equal(back.last_pose, pipe.last_pose)
        np.testing.assert_array_equal(back.store.clouds[: back.store.count],
                                      pipe.store.clouds[: pipe.store.count])
        assert len(back.trajectory) == CKPT_AT and back.grid is not None
        _drive(back, streams, lo=CKPT_AT, hi=CKPT_AT + 1)
        res = back.trajectory[-1]
        assert np.isfinite(res.pose).all()
        results.append(res.pose)
    np.testing.assert_array_equal(results[0], results[1])


def test_refuses_other_jax_classes(tmp_path):
    """Only the mapped classes of the JAX package are read: a pickle naming
    any other (here its SlamConfig) is refused before anything is built."""
    path = str(tmp_path / "foreign.pkl")
    with open(path, "wb") as f:
        pickle.dump(dict(format="resident-v2", state=JConfig()), f)
    with pytest.raises(ValueError, match="liorf_tpu.pipeline.config.SlamConfig is not allowed"):
        load_checkpoint(ResidentPipeline(SlamConfig(**_KW), device="cpu"), path)
