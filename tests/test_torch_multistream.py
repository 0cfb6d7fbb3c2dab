"""Multi-session serving in the port (``MultiStreamPipeline``, the lane axis of
both k-NN kernels and of the scan matcher) against the port's own
single-session pipeline and the JAX package's, on the CPU.

Two distinct streams (their own seeds, speeds and yaw rates), small sizes.
The JAX runs are module-scoped, so each JAX program compiles once. Streams
are frozen once and fed to every run, since ``imu_stream()`` and ``scan()``
draw fresh noise on each call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from liorf_tpu.ops import knn as jknn
from liorf_tpu.ops.knn_pallas import knn_bruteforce_pallas
from liorf_tpu.ops.scan_match import ScanMatchParams as JParams
from liorf_tpu.ops.scan_match import scan_to_map as jscan_to_map
from liorf_tpu.pipeline import SlamConfig as JConfig
from liorf_tpu.pipeline.multistream import MultiStreamPipeline as JMulti
from liorf_tpu.sensors.synthetic import SyntheticConfig, SyntheticDataset
from liorf_tpu_torch import convert
from liorf_tpu_torch.ops import knn as tknn
from liorf_tpu_torch.ops import knn_cuda
from liorf_tpu_torch.ops.scan_match import ScanMatchParams, scan_to_map, scan_to_map_lanes
from liorf_tpu_torch.pipeline import ResidentPipeline, SlamConfig
from liorf_tpu_torch.pipeline.multistream import MultiStreamPipeline

B = 2
N_FRAMES = 6

# tests/test_torch_resident.py's size (16 rings x 250 points, leaf 0.2) with
# its loop settings (a search every frame, a 0.25 s time gap, a keyframe
# every ~0.3 m): the keyframe branch, the loop branch with its gated ICP and
# the full solve all run, and loop factors land. Not tests/test_multistream.py's
# 16 x 360 at leaf 0.4: there every scan match is degenerate and the two
# packages' single-session pipelines already drift apart by up to 1.05e-2
# over six frames (ROADMAP Queue C, the sparse case), which would hide what
# the lane axis does. The ICP submap cap is cut from 16384 on every side
# (the CPU k-NN of the ICP is quadratic in it).
_KW = dict(
    scan_capacity=4096, map_capacity=16384, kf_cloud_capacity=4096,
    near_kf_capacity=8, imu_window=32, mappingSurfLeafSize=0.2,
    surroundingKeyframeMapLeafSize=0.2, point_filter_num=1, downsampleRate=1,
    N_SCAN=16, loopClosureEnableFlag=True, loopClosureFrequency=10.0,
    historyKeyframeSearchTimeDiff=0.25, surroundingkeyframeAddingDistThreshold=0.3,
    kf_capacity=32, traj_capacity=64, gps_capacity=8, loop_capacity=8,
    imu_rate_capacity=1024,
)
_ICP_CAP = 4096


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _icp_cap(params):
    return params._replace(loop_icp_cap=_ICP_CAP)


@pytest.fixture(scope="module")
def streams():
    """Two distinct streams: scans and IMU samples, frozen."""
    syns = [
        SyntheticDataset(SyntheticConfig(n_frames=N_FRAMES, n_rings=16, points_per_ring=250, seed=0)),
        SyntheticDataset(SyntheticConfig(n_frames=N_FRAMES, n_rings=16, points_per_ring=250,
                                         seed=7, yaw_rate=0.4, speed=3.0)),
    ]
    return [([s.scan(f) for f in range(N_FRAMES)], s.imu_stream()) for s in syns]


def _feed_single(pipe, stream):
    scans, imu = stream
    ii = 0
    for scan in scans:
        while ii < len(imu) and imu[ii].stamp <= scan.end_time + 0.02:
            pipe.push_imu(imu[ii])
            ii += 1
        pipe.process_scan(scan)
    return pipe


def _feed_multi(mp, streams):
    iis = [0] * len(streams)
    for f in range(N_FRAMES):
        scans = [s[0][f] for s in streams]
        for lane, (_, imu) in enumerate(streams):
            while iis[lane] < len(imu) and imu[iis[lane]].stamp <= scans[lane].end_time + 0.02:
                mp.push_imu(lane, imu[iis[lane]])
                iis[lane] += 1
        mp.step(scans)
    mp.finish()
    return mp


def _port_multi(streams, **kw):
    mp = MultiStreamPipeline(SlamConfig(**{**_KW, **kw}), n_streams=B, device="cpu")
    mp.params = _icp_cap(mp.params)
    return _feed_multi(mp, streams)


def _port_single(stream, **kw):
    pipe = ResidentPipeline(SlamConfig(**{**_KW, **kw}), device="cpu")
    pipe.params = _icp_cap(pipe.params)
    return _feed_single(pipe, stream)


@pytest.fixture(scope="module")
def port_runs(streams):
    return _port_multi(streams), [_port_single(s) for s in streams]


@pytest.fixture(scope="module")
def jax_multi(streams):
    mp = JMulti(JConfig(**_KW), n_streams=B)
    for s in mp.streams:
        s.params = _icp_cap(s.params)
    return _feed_multi(mp, streams)


# ---------------------------------------------------------------------------
# (a) both kernels' plain versions with a lane axis vs jax.vmap
# ---------------------------------------------------------------------------

def _lane_grids(seed, m=1500, n=96):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-6, 6, (B, m, 3)).astype(np.float32)
    xyz[:, : m // 2, 2] = 0.0  # a floor: planar cells with many points
    mask = rng.uniform(size=(B, m)) > 0.1
    q = (xyz[:, rng.integers(0, m, n)] + rng.normal(0, 0.05, (B, n, 3))).astype(np.float32)
    qmask = rng.uniform(size=(B, n)) > 0.1
    q[1, :3] = [[700.0, 0, 0], [0, -800.0, 0], [1e9, 0, 0]]  # out of range
    origin = np.array([[0.25, -0.5, 0.125], [-0.5, 0.25, 0.0]], np.float32)
    return xyz, mask, q, qmask, origin


def test_k1_lanes_plain_vs_jax_vmap():
    """The stacked knn_grid (K1's plain version) against jax.vmap of the
    JAX knn_grid over two different grids and query sets: grids equal
    exactly, distances within 1e-6 (relative; both packages compute the
    same direct differences), indices equal."""
    xyz, mask, q, qmask, origin = _lane_grids(0)
    jg = jax.vmap(lambda x, m, o: jknn.build_grid(x, m, o, 1.0))(
        jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(origin))
    d_j, i_j = jax.vmap(lambda g, qq, qm: jknn.knn_grid(g, qq, qm, k=5, bucket=16))(
        jg, jnp.asarray(q), jnp.asarray(qmask))
    grids = [tknn.build_grid(_t(xyz[b]), _t(mask[b]), _t(origin[b]), 1.0) for b in range(B)]
    tg = type(grids[0])(*(torch.stack(f) for f in zip(*grids)))
    np.testing.assert_array_equal(tg.keys.numpy(), np.asarray(jg.keys))
    d_t, i_t = tknn.knn_grid(tg, _t(q), _t(qmask), k=5, bucket=16)
    assert d_t.shape == (B, q.shape[1], 5)
    d_t, i_t, d_j, i_j = d_t.numpy(), i_t.numpy(), np.asarray(d_j), np.asarray(i_j)
    np.testing.assert_array_equal(np.isfinite(d_t), np.isfinite(d_j))
    fin = np.isfinite(d_t)
    np.testing.assert_allclose(d_t[fin], d_j[fin], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(i_t, i_j)
    # lane b of the stacked call is the one-lane call on lane b's data
    for b in range(B):
        d1, i1 = tknn.knn_grid(grids[b], _t(q[b]), _t(qmask[b]), k=5, bucket=16)
        assert torch.equal(d1, torch.from_numpy(d_t[b])) and torch.equal(i1, torch.from_numpy(i_t[b]))


def test_k2_lanes_plain_vs_jax_vmap():
    """The stacked knn_bruteforce (K2's plain version) against jax.vmap of
    the Pallas kernel in interpret mode. The Pallas kernel computes
    |q|^2 + |t|^2 - 2 q.t, the port direct differences; coordinates on a
    1/8 grid make both exact in f32, so distances agree within 1e-6 and the
    selection (ties to the lower index) is compared index for index. One
    lane has its targets all masked; duplicated targets make exact ties."""
    rng = np.random.default_rng(1)
    m, n = 700, 130
    tgt = (rng.integers(-64, 64, (B, m, 3)) / 8.0).astype(np.float32)
    tgt[:, 400:450] = tgt[:, 100:150]  # duplicates: ties
    q = (rng.integers(-64, 64, (B, n, 3)) / 8.0).astype(np.float32)
    tmask = rng.uniform(size=(B, m)) > 0.1
    tmask[1] = False  # an empty lane
    qmask = rng.uniform(size=(B, n)) > 0.1
    d_p, i_p = jax.vmap(
        lambda t, tm, qq, qm: knn_bruteforce_pallas(t, tm, qq, qm, k=3, tile_q=64, tile_m=256,
                                                    interpret=True)
    )(jnp.asarray(tgt), jnp.asarray(tmask), jnp.asarray(q), jnp.asarray(qmask))
    d_t, i_t = knn_cuda.knn_bruteforce(_t(tgt), _t(tmask), _t(q), _t(qmask), k=3)
    assert d_t.shape == (B, n, 3) and i_t.dtype == torch.int32
    d_t, i_t, d_p, i_p = d_t.numpy(), i_t.numpy(), np.asarray(d_p), np.asarray(i_p)
    assert np.isinf(d_t[1]).all() and (i_t[1] == 0).all()
    np.testing.assert_array_equal(np.isfinite(d_t), np.isfinite(d_p))
    fin = np.isfinite(d_t)
    np.testing.assert_allclose(d_t[fin], d_p[fin], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(i_t[fin], i_p[fin])
    for b in range(B):
        d1, i1 = knn_cuda.knn_bruteforce(_t(tgt[b]), _t(tmask[b]), _t(q[b]), _t(qmask[b]), k=3)
        assert np.array_equal(d1.numpy(), d_t[b]) and np.array_equal(i1.numpy(), i_t[b])


# ---------------------------------------------------------------------------
# (b) the batched scan matcher
# ---------------------------------------------------------------------------

def test_scan_to_map_lanes_vs_single_and_jax_vmap(monkeypatch):
    """Two lanes (the __graft_entry__ scan; the same scan reversed from a
    perturbed start) through scan_to_map_lanes, against two one-lane port
    calls and jax.vmap of the JAX scan_to_map: poses within 1e-4, per-lane
    iteration counts (which differ between the lanes) and flags equal, and
    one K1 call per batched iteration (counted on the plain path here)."""
    _, (scan, mask, grid, init) = graft.entry()
    scan, mask, init = np.asarray(scan), np.asarray(mask), np.asarray(init)
    scans = np.stack([scan, scan[::-1]])
    masks = np.stack([mask, mask[::-1]])
    inits = np.stack([init, init + np.array([0.01, -0.01, 0.02, 0.1, -0.05, 0.02], np.float32)])
    jgrid = jax.tree_util.tree_map(lambda a: jnp.stack([a, a]), grid)
    jres = jax.vmap(lambda s, m, g, i: jscan_to_map(s, m, g, i, JParams(knn_bucket=40)))(
        jnp.asarray(scans), jnp.asarray(masks), jgrid, jnp.asarray(inits))
    tgrid = convert.grid_from_arrays({k: np.asarray(v) for k, v in grid._asdict().items()}, device="cpu")
    stacked = type(tgrid)(*(torch.stack([f, f]) for f in tgrid))
    params = ScanMatchParams(knn_bucket=40)
    calls = []
    real = knn_cuda.knn_grid_topk_plain

    def counted(*a, **k):
        if a[1].dim() == 3:  # a stacked call (it recurses lane by lane)
            calls.append(a[1].shape[0])
        return real(*a, **k)

    monkeypatch.setattr(knn_cuda, "knn_grid_topk_plain", counted)
    res = scan_to_map_lanes(_t(scans), _t(masks), stacked, _t(inits), params)
    monkeypatch.undo()
    assert calls == [B] * int(res.iters.max())
    assert res.iters.tolist()[0] != res.iters.tolist()[1]
    for b in range(B):
        one = scan_to_map(_t(scans[b]), _t(masks[b]), tgrid, _t(inits[b]), params)
        np.testing.assert_allclose(res.pose[b].numpy(), one.pose.numpy(), atol=1e-6)
        assert int(res.iters[b]) == int(one.iters) == int(jres.iters[b])
        assert bool(res.degenerate[b]) == bool(one.degenerate) == bool(jres.degenerate[b])
        assert bool(res.converged[b]) == bool(one.converged) == bool(jres.converged[b])
        assert int(res.num_matched[b]) == int(one.num_matched)
        np.testing.assert_allclose(res.pose[b].numpy(), np.asarray(jres.pose[b]), atol=1e-4)


# ---------------------------------------------------------------------------
# (c) MultiStreamPipeline against single sessions and the JAX package
# ---------------------------------------------------------------------------

def _kf_flags(pipe):
    return [r.is_keyframe for r in pipe.trajectory]


def test_multistream_matches_single_sessions(port_runs):
    """Each lane of the batched run against a single-session
    ResidentPipeline on the same stream: the same keyframe flags, keyframe,
    loop-factor and GPS counts, loop pairs and GN iterations; every frame's
    pose and the IMU-rate stream within 1e-4 (m, rad; measured 1.0e-5: the
    batched products and solves round differently from the one-session
    ones, and the loop branch's full solve carries it). Loop factors landed
    and the ICP ran batched."""
    mp, singles = port_runs
    assert mp.tally["icp_runs"] >= 1 and mp.tally["read:loop_gate"] >= 1
    assert mp.host_reads()["is_kf"] == N_FRAMES - 1  # one [B] read a tick
    assert mp.gn_iters_per_lane() == [s.gn_iters_total() for s in singles]
    for lane, one in enumerate(singles):
        shell = mp.stream(lane)
        t_m, p_m = shell.trajectory_arrays()
        t_s, p_s = one.trajectory_arrays()
        np.testing.assert_array_equal(t_m, t_s)
        np.testing.assert_allclose(p_m, p_s, atol=1e-4)
        assert _kf_flags(shell) == _kf_flags(one)
        for f in ("kf_count", "l_count", "g_count", "traj_count", "imu_count"):
            assert int(getattr(shell.state, f)) == int(getattr(one.state, f)), f
        n_loops = int(one.state.l_count)
        np.testing.assert_array_equal(shell.state.l_i[:n_loops], one.state.l_i[:n_loops])
        np.testing.assert_array_equal(shell.state.l_j[:n_loops], one.state.l_j[:n_loops])
        it_m, ip_m = shell.imu_rate_trajectory()
        it_s, ip_s = one.imu_rate_trajectory()
        np.testing.assert_array_equal(it_m, it_s)
        np.testing.assert_allclose(ip_m, ip_s, atol=1e-4)
    assert sum(int(s.state.l_count) for s in singles) >= 1


def test_multistream_matches_jax_multistream(port_runs, jax_multi):
    """The port's batched run against the JAX MultiStreamPipeline on the
    same two streams: keyframe flags and loop-factor counts equal, every
    frame's pose within 1e-3 (m, rad; measured 2.4e-4) — the bound
    tests/test_torch_resident.py holds the single-session pipelines to."""
    mp, _ = port_runs
    for lane in range(B):
        t_t, p_t = mp.stream(lane).trajectory_arrays()
        t_j, p_j = jax_multi.stream(lane).trajectory_arrays()
        np.testing.assert_array_equal(t_t, t_j)
        np.testing.assert_allclose(p_t, p_j, atol=1e-3)
        assert _kf_flags(mp.stream(lane)) == _kf_flags(jax_multi.stream(lane))
        assert int(mp.stream(lane).state.l_count) == int(jax_multi.stream(lane).state.l_count)


def test_step_lanes_equals_single_steps_nine_axis():
    """One resident_step_packed_lanes tick from two lanes' carried states
    against resident_step_packed on each lane, with the 9-axis attitude
    slerp on (imuType 1, quaternions from the ground truth): every traj
    entry, filter and keyframe pose within 1e-5, flags and counts equal."""
    from collections import Counter

    from liorf_tpu_torch.core import se3np
    from liorf_tpu_torch.pipeline import resident as tres
    from liorf_tpu_torch.sensors.types import ImuSample

    kw = dict(_KW, imuType=1, imuRPYWeight=0.01, useImuHeadingInitialization=False,
              loopClosureEnableFlag=False)
    pre, bufs, hosts = [], [], []
    for seed, extra in ((0, {}), (7, dict(yaw_rate=0.4, speed=3.0))):
        syn = SyntheticDataset(SyntheticConfig(n_frames=4, n_rings=16, points_per_ring=250,
                                               seed=seed, **extra))
        imu = [ImuSample(s.stamp, s.acc, s.gyr, se3np.rot_to_quat_wxyz(
            syn.pose_at(round(max(s.stamp, 0.0), 6))[0])) for s in syn.imu_stream()]
        pipe = ResidentPipeline(SlamConfig(**kw), device="cpu")
        step = pipe._dispatch_step

        def capture(buf, S, W, pipe=pipe, step=step):
            if pipe.frame_idx == 3:
                pre.append(tres.stack_states([pipe.state]))  # a copy, with a lane axis
                bufs.append(buf.copy())
                hosts.append(pipe._host)
            step(buf, S, W)

        pipe._dispatch_step = capture
        _feed_single(pipe, ([syn.scan(f) for f in range(4)], imu))
        pre[-1] = (pre[-1], pipe)
    params = pre[0][1].params
    assert params.frame.imu_rpy_weight > 0
    S, W = pre[0][1].cfg.raw_cap, pre[0][1].cfg.imu_window
    stacked = tres.stack_states([tres.lane_state(p[0], 0) for p in pre])
    out, out_hosts, gn = tres.resident_step_packed_lanes(
        stacked, hosts, np.stack(bufs), params, S, W, Counter())
    for b, (_, pipe) in enumerate(pre):
        one = tres.lane_state(out, b)
        ref = pipe.state  # the single-session step's result on the same carried state
        assert out_hosts[b] == pipe._host
        np.testing.assert_allclose(one.traj[:4].numpy(), ref.traj[:4].numpy(), atol=1e-5)
        np.testing.assert_allclose(one.filt.mean.R.numpy(), ref.filt.mean.R.numpy(), atol=1e-5)
        np.testing.assert_allclose(one.kf_poses.numpy(), ref.kf_poses.numpy(), atol=1e-5)
        for f in ("kf_count", "traj_count", "imu_count", "pending_loop"):
            assert int(getattr(one, f)) == int(getattr(ref, f)), f


# ---------------------------------------------------------------------------
# (d) growth mid-serving, (e) constructor errors, (f) the device rule
# ---------------------------------------------------------------------------

def test_multistream_growth_mid_serving(streams, port_runs):
    """Small trajectory, keyframe, loop and IMU-rate rings (the capacities
    tests/test_torch_resident.py grows a single session with) force
    coordinated doublings of the stacked state mid-run; the trajectories
    match the large-ring run within 1e-5."""
    grown = _port_multi(streams, traj_capacity=4, kf_capacity=4, loop_capacity=3,
                        imu_rate_capacity=150)
    assert grown.growth_events >= 1 and grown._ring_shapes["traj"] >= N_FRAMES
    assert grown._ring_shapes["kf"] > 4 and grown._ring_shapes["imu"] > 150
    assert grown.state.traj.shape[:2] == (B, grown._ring_shapes["traj"])
    assert grown.state.kf_clouds.shape[:2] == (B, grown._ring_shapes["kf"])
    mp, _ = port_runs
    for lane in range(B):
        np.testing.assert_allclose(
            grown.stream(lane).trajectory_arrays()[1], mp.stream(lane).trajectory_arrays()[1],
            atol=1e-5,
        )


def test_multistream_constructor_and_tick_errors(streams):
    cfg = SlamConfig(**_KW)
    with pytest.raises(ValueError, match="n_streams"):
        MultiStreamPipeline(cfg, n_streams=0, device="cpu")
    throttled = SlamConfig(**{**_KW, "mappingProcessInterval": 0.15})
    with pytest.raises(ValueError, match="mappingProcessInterval"):
        MultiStreamPipeline(throttled, n_streams=B, device="cpu")
    mp = MultiStreamPipeline(cfg, n_streams=B, device="cpu")
    with pytest.raises(ValueError, match="expected 2 scans"):
        mp.step([streams[0][0][0]])
    # a lane that produced no frame this tick: lock-step is broken
    scans = [s[0][0] for s in streams]
    mp.step(scans)
    mp.stream(1)._dispatch_step = lambda buf, S, W: None
    with pytest.raises(RuntimeError, match="produced no frame"):
        mp.step([s[0][1] for s in streams])


def test_multistream_defaults_to_cuda():
    cfg = SlamConfig(scan_capacity=256, map_capacity=1024, kf_cloud_capacity=256)
    if torch.cuda.is_available():
        assert MultiStreamPipeline(cfg, n_streams=2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            MultiStreamPipeline(cfg, n_streams=2)
    assert MultiStreamPipeline(cfg, n_streams=2, device="cpu").device.type == "cpu"
