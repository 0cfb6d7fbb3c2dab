"""The slice as a whole: the streaming pipeline of the port against the JAX
package's, a single frame from carried-across state, and the loop detector.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liorf_tpu.core import se3 as jse3
from liorf_tpu.imu import preintegration as jpre
from liorf_tpu.ops.scan_match import scan_to_map as j_scan_to_map
from liorf_tpu.pipeline import frame_step as jfs
from liorf_tpu.pipeline.config import SlamConfig as JConfig
from liorf_tpu.pipeline.slam import LiorfPipeline as JPipeline
from liorf_tpu.sensors.synthetic import SyntheticConfig, SyntheticDataset
from liorf_tpu_torch import convert
from liorf_tpu_torch.core import se3np
from liorf_tpu_torch.eval.metrics import ate_rmse
from liorf_tpu_torch.loops.detector import LoopDetector
from liorf_tpu_torch.mapping.keyframes import KeyframeStore
from liorf_tpu_torch.pipeline import LiorfPipeline, SlamConfig
from liorf_tpu_torch.pipeline import frame_step as tfs
from liorf_tpu_torch.sensors import synthetic as tsyn

N_FRAMES = 6
CARRY_AT = 4  # the frame run from carried-across state

# Small size: 16 rings x 250 points at leaf 0.2 — enough matched points
# (~2000) that the scan match is well conditioned; on sparser scans the
# eigenvalue projection flags every frame degenerate, the weak directions are
# then held at the IMU prediction, and a one-ulp difference drifts freely
# (measured 1.4e-3..4.2e-3 over six frames at 8 rings x 250, leaf 0.3).
# kf_cloud_capacity holds a whole downsampled scan: the keyframe subsample's
# stride depends on the exact voxel count, so one point crossing a voxel face
# by an f32 ulp would otherwise re-pick every point of the keyframe cloud.
_KW = dict(
    scan_capacity=4096, map_capacity=16384, kf_cloud_capacity=4096,
    near_kf_capacity=8, imu_window=32, mappingSurfLeafSize=0.2,
    surroundingKeyframeMapLeafSize=0.2, loopClosureEnableFlag=False,
    point_filter_num=1, downsampleRate=1, N_SCAN=16,
)
_SYN = dict(n_frames=N_FRAMES, n_rings=16, points_per_ring=250)


def _frame_inputs(pipe, scan):
    """The arrays process_scan hands to frame_step, built with the
    pipeline's own helpers (numpy; the same for both packages)."""
    cfg = pipe.cfg
    t0, t1 = scan.stamp, scan.end_time
    base = pipe._time_base(t0)
    xyz, rts, msk = pipe._pack_scan(scan)
    dk_t, _, dk_gyr, _, dk_m, _ = pipe._imu_window(t0 - 0.01, t1 + 0.01, cfg.imu_window)
    _, fu_acc, fu_gyr, fu_dts, fu_m, _ = pipe._imu_window(pipe.last_scan_stamp, t0, cfg.imu_window)
    return (xyz, rts, msk, np.float32(t0 - base), dk_t, dk_gyr, dk_m, fu_acc, fu_gyr, fu_dts, fu_m)


# The sparse size: 8 rings x 180 points, leaf 0.4, scan_capacity 2048. Every
# frame after the first is flagged degenerate on both sides (~400 matched
# points), so the weak directions ride the IMU prediction and the two
# free-running pipelines separate further: held to its measured bound.
_KW_SPARSE = dict(
    scan_capacity=2048, map_capacity=8192, kf_cloud_capacity=1024,
    near_kf_capacity=8, imu_window=32, mappingSurfLeafSize=0.4,
    surroundingKeyframeMapLeafSize=0.4, loopClosureEnableFlag=False,
    point_filter_num=1, downsampleRate=1, N_SCAN=8,
)
_SYN_SPARSE = dict(n_frames=N_FRAMES, n_rings=8, points_per_ring=180)


def _run_both(kw, syn_kw, carry_at=None):
    syn = SyntheticDataset(SyntheticConfig(**syn_kw))
    jp = JPipeline(JConfig(**kw))
    tp = LiorfPipeline(SlamConfig(**kw), device="cpu")
    imu = syn.imu_stream()
    ii = 0
    jres, tres, carried = [], [], None
    for f in range(N_FRAMES):
        scan = syn.scan(f)
        while ii < len(imu) and imu[ii].stamp <= scan.end_time + 0.02:
            jp.push_imu(imu[ii])
            tp.push_imu(imu[ii])
            ii += 1
        if f == carry_at:
            carried = dict(
                inputs=_frame_inputs(jp, scan),
                grid={k: np.asarray(v) for k, v in jp.grid._asdict().items()},
                mean={k: np.asarray(v) for k, v in jp.filter.mean._asdict().items()},
                sqrt_info=np.asarray(jp.filter.sqrt_info),
                last_kf_pose=jp.store.poses[jp.store.count - 1].copy(),
                jgrid=jp.grid, jfilter=jp.filter, jparams=jp.frame_params,
            )
        jres.append(jp.process_scan(scan))
        tres.append(tp.process_scan(scan))
    return syn, jp, tp, jres, tres, carried


@pytest.fixture(scope="module")
def runs():
    return _run_both(_KW, _SYN, carry_at=CARRY_AT)


@pytest.fixture(scope="module")
def runs_sparse():
    return _run_both(_KW_SPARSE, _SYN_SPARSE, carry_at=1)


def test_six_frames_match_jax(runs):
    """Free-running, each pipeline on its own state: per-frame pose within
    1e-3 (m, rad) of JAX (measured 3.7e-4 max; the differences are f32
    reassociation amplified by six frames of map building), the same
    keyframe flags and edge count."""
    syn, jp, tp, jres, tres, _ = runs
    for f, (a, b) in enumerate(zip(tres, jres)):
        np.testing.assert_allclose(a.pose, b.pose, atol=1e-3, err_msg=f"frame {f}")
        assert a.is_keyframe == b.is_keyframe, f
        assert a.degenerate == b.degenerate, f
        assert abs(a.num_matched - b.num_matched) <= 0.01 * max(b.num_matched, 1), f
    assert [r.is_keyframe for r in tres].count(True) >= 2
    assert len(tp.edges) == len(jp.edges) == tp.store.count - 1
    assert tp.store.count == jp.store.count
    np.testing.assert_allclose(
        tp.store.poses[: tp.store.count], jp.store.poses[: jp.store.count], atol=1e-3
    )
    tt, tposes = tp.trajectory_arrays()
    jt, _ = jp.trajectory_arrays()
    np.testing.assert_array_equal(tt, jt)
    _, gt = syn.ground_truth()
    # both track the generator's ground truth
    assert ate_rmse(tposes[:, 3:6].astype(np.float64), gt[:N_FRAMES]) < 0.05
    # IMU-rate odometry between scans
    t_imu, p_imu = tp.imu_rate_poses()
    j_imu_t, j_imu_p = jp.imu_rate_poses()
    assert len(t_imu) == len(j_imu_t)
    if len(t_imu):
        np.testing.assert_allclose(p_imu, j_imu_p, atol=5e-3)


def test_six_frames_match_jax_sparse(runs_sparse):
    """The same six frames at the sparse size (8 x 180, leaf 0.4), where
    every matched frame is degenerate. Everything discrete is equal
    (keyframe flags, degenerate flags, keyframe and edge counts); attitude
    and x, y stay within 2e-3 (measured 1.7e-3, pitch of frame 1); z, the
    direction the degenerate projection leaves to the IMU prediction, drifts
    1.0e-3 per frame to 5.3e-3 at frame 5 and is held to 6e-3.
    test_sparse_divergence_is_one_voxel shows where the difference starts."""
    syn, jp, tp, jres, tres, _ = runs_sparse
    for f, (a, b) in enumerate(zip(tres, jres)):
        np.testing.assert_allclose(a.pose[:5], b.pose[:5], atol=2e-3, err_msg=f"frame {f}")
        np.testing.assert_allclose(a.pose[5], b.pose[5], atol=6e-3, err_msg=f"frame {f} z")
        assert a.is_keyframe == b.is_keyframe, f
        assert a.degenerate == b.degenerate, f
        assert abs(a.num_matched - b.num_matched) <= 0.01 * max(b.num_matched, 1), f
    assert all(r.degenerate for r in jres[1:])
    assert tp.store.count == jp.store.count >= 2
    assert len(tp.edges) == len(jp.edges) == tp.store.count - 1
    np.testing.assert_allclose(
        tp.store.poses[: tp.store.count], jp.store.poses[: jp.store.count], atol=6e-3
    )
    _, tposes = tp.trajectory_arrays()
    _, gt = syn.ground_truth()
    assert ate_rmse(tposes[:, 3:6].astype(np.float64), gt[:N_FRAMES]) < 0.05


def _jax_gn_iters(carried, oj):
    """GN iterations of the JAX frame (frame_step does not report them): its
    scan matcher run again on the frame's own downsampled cloud and guess."""
    inp = [jnp.asarray(a) for a in carried["inputs"]]
    filt, params = carried["jfilter"], carried["jparams"]
    pre = jpre.preintegrate(*inp[7:11], filt.mean.ba, filt.mean.bg, params.fusion.imu)
    nav = jpre.predict(
        jpre.NavState(R=filt.mean.R, p=filt.mean.p, v=filt.mean.v),
        pre, filt.mean.ba, filt.mean.bg, params.fusion.imu,
    )
    guess = jnp.concatenate([jse3.rot_to_euler(nav.R), nav.p])
    return int(j_scan_to_map(oj.ds_xyz, oj.ds_mask, carried["jgrid"], guess, params.match).iters)


def _step_both(carried):
    oj = jfs.frame_step(
        *(jnp.asarray(a) for a in carried["inputs"]), carried["jgrid"], carried["jfilter"],
        jnp.asarray(carried["last_kf_pose"]), carried["jparams"],
    )
    params = convert.frame_params(carried["jparams"]._asdict())
    ot = tfs.frame_step(
        *(torch.tensor(np.asarray(a)) for a in carried["inputs"]),
        convert.grid_from_arrays(carried["grid"], device="cpu"),
        convert.fusion_filter_from_arrays(carried["mean"], carried["sqrt_info"], device="cpu"),
        torch.tensor(carried["last_kf_pose"]), params,
    )
    return oj, ot, params


def test_sparse_divergence_is_one_voxel(runs_sparse):
    """Why the sparse run is held to a wider bound than 1e-3. The two
    bootstrap frames deskew to within 4e-6, but one point of the azimuth-0
    ray lies on the y = 0 voxel face and lands on either side of it, so the
    first keyframe clouds differ by one voxel (978 against 977 centroids)
    and the two maps are not the same map from then on. Given the same map
    the port follows JAX exactly: frame 1 from the JAX pipeline's state
    agrees to 1e-4 although its scan match is degenerate and uses all its
    iterations without converging."""
    _, jp, tp, _, _, carried = runs_sparse
    nj, nt = int(jp.store.cloud_masks[0].sum()), int(tp.store.cloud_masks[0].sum())
    assert abs(nj - nt) <= 1 and min(nj, nt) > 900
    oj, ot, params = _step_both(carried)
    sj, st = jfs.unpack_summary(oj.summary), tfs.unpack_summary(ot.summary)
    np.testing.assert_allclose(st["pose"], sj["pose"], atol=1e-4)
    assert st["degenerate"] and sj["degenerate"]
    assert st["converged"] == sj["converged"]
    assert st["num_matched"] == sj["num_matched"]
    assert st["gn_iters"] == _jax_gn_iters(carried, oj)


def test_single_frame_from_carried_state(runs):
    """One frame_step from the JAX pipeline's state (grid, filter, last
    keyframe pose carried across as numpy): pose within 1e-4 (m, rad), same
    flags, the same GN iteration count."""
    *_, carried = runs
    oj, ot, params = _step_both(carried)
    sj, st = jfs.unpack_summary(oj.summary), tfs.unpack_summary(ot.summary)
    np.testing.assert_allclose(st["pose"], sj["pose"], atol=1e-4)
    for key in ("degenerate", "converged", "is_kf", "diverged"):
        assert st[key] == sj[key], key
    assert abs(st["num_matched"] - sj["num_matched"]) <= 0.01 * sj["num_matched"]
    assert st["gn_iters"] == _jax_gn_iters(carried, oj)
    assert 1 <= st["gn_iters"] <= params.match.max_iters
    for a, b in zip(ot.filter.mean, oj.filter.mean):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4)
    np.testing.assert_array_equal(ot.ds_mask.numpy(), np.asarray(oj.ds_mask))
    # a point within an ulp of a voxel face may fall on the other side and
    # move two centroids: all but a handful of rows agree
    rows_equal = (np.abs(ot.ds_xyz.numpy() - np.asarray(oj.ds_xyz)) <= 1e-4).all(axis=1)
    assert rows_equal.mean() > 0.995
    # the keyframe payload unpacks to the same pieces on both sides
    cap = params.scan_cap
    for a, b in zip(tfs.unpack_kf_payload(ot.kf_payload, cap), jfs.unpack_kf_payload(oj.kf_payload, cap)):
        assert a.shape == b.shape


def test_synthetic_generator_is_the_same():
    """The port keeps its own copy of the numpy-only dataset generator."""
    cfg = dict(n_frames=2, n_rings=4, points_per_ring=60)
    a = SyntheticDataset(SyntheticConfig(**cfg)).scan(1)
    b = tsyn.SyntheticDataset(tsyn.SyntheticConfig(**cfg)).scan(1)
    np.testing.assert_array_equal(a.xyz, b.xyz)
    np.testing.assert_array_equal(a.rel_time, b.rel_time)


def _world_points(rng):
    """Ground + two facades + wall stubs, ~0.35 m spacing."""
    g = np.stack(np.meshgrid(np.arange(-10, 40, 0.35), np.arange(-8, 8, 0.35)), -1).reshape(-1, 2)
    ground = np.c_[g, np.zeros(len(g))]
    w = np.stack(np.meshgrid(np.arange(-10, 40, 0.35), np.arange(0, 5, 0.35)), -1).reshape(-1, 2)
    left = np.c_[w[:, 0], np.full(len(w), 8.0), w[:, 1]]
    right = np.c_[w[:, 0], np.full(len(w), -8.0), w[:, 1]]
    # wall stubs across the street: they pin the position along x
    c = np.stack(np.meshgrid(np.arange(0, 5, 0.35), np.arange(0, 5, 0.35)), -1).reshape(-1, 2)
    stubs = [
        np.c_[np.full(len(c), x), y0 + c[:, 0], c[:, 1]]
        for x, y0 in ((-6.0, -8.0), (2.0, 3.0), (7.0, -8.0), (13.0, 3.0), (19.0, -8.0), (25.0, 3.0))
    ]
    pts = np.concatenate([ground, left, right, *stubs])
    return pts + rng.normal(0, 0.01, pts.shape)


def test_loop_detector_two_pass_store():
    """A hand-built store: six keyframes out along x, six coming back over
    the same ground 60 s later; the last one's stored pose is off by a known
    drift. LoopDetector.run (RS search + ICP through knn_bruteforce at
    cap=2048) must return one RS factor whose rel_pose is within 5 cm /
    0.01 rad of the true relative pose."""
    rng = np.random.default_rng(11)
    world = _world_points(rng)
    cfg = SlamConfig(
        kf_cloud_capacity=2048, historyKeyframeSearchNum=1, loopClosureICPSurfLeafSize=0.6,
    )
    store = KeyframeStore(cloud_capacity=2048, initial_kf_capacity=16, device="cpu")
    xs = [0, 3, 6, 9, 12, 15, 15.5, 12.5, 9.5, 6.5, 3.5, 0.6]
    true_poses = []
    for i, x in enumerate(xs):
        yaw = 0.0 if i < 6 else np.pi - 0.05
        y = 0.0 if i < 6 else 0.4
        true_poses.append(np.array([0.0, 0.0, yaw, x, y, 0.0]))
    drift = np.array([0.0, 0.0, 0.03, 0.35, -0.25, 0.05])
    for i, pose in enumerate(true_poses):
        near = world[np.linalg.norm(world[:, :2] - pose[3:5], axis=1) < 11.0]
        near = near[rng.permutation(len(near))[:2000]]
        cloud = se3np.pose_apply(se3np.pose_inverse(pose), near).astype(np.float32)
        stored = pose if i < len(xs) - 1 else se3np.pose_compose(drift, pose)
        desc = np.zeros((20, 60), np.float32)
        store.append(stored.astype(np.float32), 100.0 + (i if i < 6 else 60 + i), cloud,
                     np.ones(len(cloud), bool), desc, desc.mean(-1))
    det = LoopDetector(cfg, icp_cap=2048)
    factors = det.run(store, now=172.0)
    assert len(factors) == 1
    f = factors[0]
    assert f.kind == "rs" and f.idx_to == 11 and f.idx_from == 0
    want = se3np.pose_between(true_poses[0], true_poses[11])
    d = f.rel_pose - want
    d[:3] = (d[:3] + np.pi) % (2 * np.pi) - np.pi
    assert np.abs(d[3:]).max() < 0.05, d
    assert np.abs(d[:3]).max() < 0.01, d
    assert f.fitness < cfg.historyKeyframeFitnessScore and f.cauchy == 0.0
    assert det.loop_index_container == {11: 0}
    # the same keyframe is not searched twice
    assert det.run(store, now=172.0) == []
