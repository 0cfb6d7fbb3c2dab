"""The device-resident pipeline of the port (``ResidentPipeline``,
``make_pipeline``) against the JAX package's, one step from carried-across
state, ring growth, checkpoint resume and the ``cli``, on the CPU.

One JAX run (module-scoped; its two programs compile once) serves every
comparison. The streams are frozen once and fed to every run, since
``imu_stream()`` and ``scan()`` draw fresh noise on each call.
"""

import json
import os
import shutil
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liorf_tpu.graph import marginal as jmarginal
from liorf_tpu.pipeline import ResidentPipeline as JResident
from liorf_tpu.pipeline import SlamConfig as JConfig
from liorf_tpu.sensors.synthetic import SyntheticConfig, SyntheticDataset
from liorf_tpu_torch import cli, convert
from liorf_tpu_torch.graph import marginal as tmarginal
from liorf_tpu_torch.mapping.export import load_checkpoint, save_checkpoint
from liorf_tpu_torch.mapping.keyframes import assemble_local_map
from liorf_tpu_torch.pipeline import ResidentPipeline, SlamConfig, make_pipeline
from liorf_tpu_torch.pipeline import resident as tres

N_FRAMES = 5
CARRY_AT = 4  # the frame run again from carried-across state
CKPT_AT = 3  # frames processed before the checkpoint

# The size of tests/test_torch_slice.py (16 rings x 250 points, leaf 0.2,
# kf_cloud_capacity 4096), with loop closure on: a search every frame
# (loopClosureFrequency 10), a short time gap (0.25 s) and a keyframe every
# frame (0.3 m spacing; the car moves 0.4 m a frame), so the loop branch,
# the gated ICP and the full solve all run from frame 2 on. Small rings:
# the graph spans every kf slot.
_KW = dict(
    scan_capacity=4096, map_capacity=16384, kf_cloud_capacity=4096,
    near_kf_capacity=8, imu_window=32, mappingSurfLeafSize=0.2,
    surroundingKeyframeMapLeafSize=0.2, point_filter_num=1, downsampleRate=1,
    N_SCAN=16, loopClosureEnableFlag=True, loopClosureFrequency=10.0,
    historyKeyframeSearchTimeDiff=0.25, surroundingkeyframeAddingDistThreshold=0.3,
    kf_capacity=32, traj_capacity=64, gps_capacity=8, loop_capacity=8,
    imu_rate_capacity=1024,
)
# Capacities that every ring but the GPS one outgrows within the run.
_SMALL_CAPS = dict(kf_capacity=4, traj_capacity=4, loop_capacity=3, imu_rate_capacity=150)
# The ICP submap cap, cut from 16384 on both sides: the plain (CPU) k-NN
# of the ICP is quadratic in it, and these scans fill a fraction of it.
_ICP_CAP = 4096


def _with_icp_cap(pipe):
    pipe.params = pipe.params._replace(loop_icp_cap=_ICP_CAP)
    return pipe


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


def _np_tree(x):
    """A JAX state tree as numpy copies, NamedTuples as dicts."""
    if hasattr(x, "_asdict"):
        return {k: _np_tree(v) for k, v in x._asdict().items()}
    return np.array(x)


@pytest.fixture(scope="module")
def jax_run(streams):
    """The JAX ResidentPipeline over the whole run; frame CARRY_AT's packed
    buffer and its state before and after the step are copied to numpy
    (the step donates its state)."""
    pipe = _with_icp_cap(JResident(JConfig(**_KW)))
    carried = {}
    dispatch = pipe._dispatch_step

    def capture(buf, S, W):
        if pipe.frame_idx == CARRY_AT:
            carried.update(buf=buf.copy(), before=_np_tree(pipe.state))
        dispatch(buf, S, W)
        if pipe.frame_idx == CARRY_AT:
            carried["after"] = _np_tree(pipe.state)

    pipe._dispatch_step = capture
    _drive(pipe, streams)
    return pipe, carried


@pytest.fixture(scope="module")
def port_run(streams, tmp_path_factory):
    """The port's ResidentPipeline over the same run, checkpointed after
    CKPT_AT frames."""
    ckpt = str(tmp_path_factory.mktemp("resident") / "ckpt.pkl")
    pipe = _with_icp_cap(make_pipeline(SlamConfig(**_KW), device="cpu"))
    _drive(pipe, streams, at=CKPT_AT, hook=lambda p: save_checkpoint(p, ckpt))
    return pipe, ckpt


def _point_set(xyz, mask):
    """Valid points as a set of mm-rounded integer triples."""
    return set(map(tuple, np.round(xyz[mask] * 1e3).astype(np.int64)))


def _counts(state):
    return {k: int(np.asarray(getattr(state, k))) for k in ("kf_count", "l_count", "g_count", "traj_count", "imu_count")}


def test_whole_run_matches_jax(jax_run, port_run):
    """Free-running, each pipeline on its own state: every frame's
    (loop-corrected) pose within 1e-3 (m, rad) of JAX, the same keyframe
    flags and counts, and the loop branch really ran on both sides."""
    jp, _ = jax_run
    tp, _ = port_run
    jt, jposes = jp.trajectory_arrays()
    tt, tposes = tp.trajectory_arrays()
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tposes, jposes, atol=1e-3)
    assert [f.is_keyframe for f in tp.trajectory] == [f.is_keyframe for f in jp.trajectory]
    assert _counts(tp.state) == _counts(jp.state)
    assert int(jp.state.l_count) >= 1  # the loop branch and an ICP ran
    for name in ("l_i", "l_j"):
        np.testing.assert_array_equal(getattr(tp.state, name).numpy(), np.asarray(getattr(jp.state, name)))
    # the host view stays exact without reading the device
    assert tp._host.kf_count == int(tp.state.kf_count)
    assert tp._host.pending_loop == bool(tp.state.pending_loop)
    reads = tp.host_reads()
    assert reads["is_kf"] == N_FRAMES - 1
    assert 1 <= reads["full"] <= reads["loop_gate"] <= N_FRAMES - 1
    assert tp.tally["icp_runs"] >= int(tp.state.l_count)
    np.testing.assert_allclose(tp.store.poses[: tp.store.count], jp.store.poses[: jp.store.count], atol=1e-3)


def test_imu_rate_trajectory_matches_jax(jax_run, port_run):
    jp, _ = jax_run
    tp, _ = port_run
    jt, jposes = jp.imu_rate_trajectory()
    tt, tposes = tp.imu_rate_trajectory()
    assert len(tt) == len(jt) > 5 * (N_FRAMES - 2)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tposes, jposes, atol=1e-3)


def test_step_from_carried_state(jax_run):
    """One resident_step (packed) of frame CARRY_AT — a keyframe frame whose
    loop branch runs an ICP and a full solve — from the JAX pipeline's state
    carried across as numpy: every float field within 1e-4 (the fusion
    filter's information as in the fusion-step test), every int and bool
    field equal — except where one voxel-face flip of the frame's
    downsampled cloud reaches (as in test_torch_slice.py's carried frame):
    a handful of points of the new keyframe cloud, and the local map grid,
    compared as a point set. The grid step alone, run from JAX's post-step
    rings, matches JAX's grid slot for slot."""
    jp, carried = jax_run
    state = convert.resident_state_from_arrays(carried["before"], device="cpu")
    params = convert.resident_params(jp.params._asdict())
    before = carried["before"]
    host = tres.HostView(int(before["kf_count"]), bool(before["pending_loop"]))
    tally = Counter()
    S, W = jp.cfg.raw_cap, jp.cfg.imu_window
    out, host, gn = tres.resident_step_packed(state, host, carried["buf"], params, S, W, tally)
    after = carried["after"]
    assert tally["read:is_kf"] == 1 and tally["icp_runs"] == 1 and tally["read:full"] == 1
    assert host.kf_count == int(after["kf_count"]) and host.pending_loop == bool(after["pending_loop"])
    assert 1 <= int(gn) <= params.frame.match.max_iters

    def compare(name, t, j):
        t = t.numpy()
        if j.dtype == bool or np.issubdtype(j.dtype, np.integer):
            np.testing.assert_array_equal(t, j, err_msg=name)
        elif name == "filt.sqrt_info":
            # QR factors differ in sign between LAPACK front ends: the
            # information W^T W is compared, to 2e-3 of its largest entry
            # (as tests/test_torch_ops.py::test_fusion_step_and_predict_poses)
            It, Ij = t.T @ t, j.T @ j
            assert np.abs(It - Ij).max() <= 2e-3 * np.abs(Ij).max(), name
        elif name == "kf_clouds":
            # a point within an ulp of a voxel face may fall on the other
            # side and move two centroids (as in test_torch_slice.py's
            # carried frame): all but a handful of points agree to 1e-4
            rows_equal = (np.abs(t - j) <= 1e-4).reshape(-1, 3).all(axis=1)
            assert (~rows_equal).sum() <= 0.005 * rows_equal.size, (name, (~rows_equal).sum())
        elif name == "l_sqrt":
            # 1 / sqrt(ICP fitness), ~9 here: held relatively
            np.testing.assert_allclose(t, j, rtol=1e-4, err_msg=name)
        else:
            # rtol covers the f32 ulps of the 1e4-sized marginal entries
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-4, err_msg=name)

    for name in tres.ResidentState._fields:
        t, j = getattr(out, name), after[name]
        if name == "filt":
            for k, v in t.mean._asdict().items():
                compare(f"filt.mean.{k}", v, j["mean"][k])
            compare("filt.sqrt_info", t.sqrt_info, j["sqrt_info"])
        elif name == "grid":
            # the local map as a point set: the voxel-face flip above adds
            # or moves a few map points, and every later point of the
            # key-sorted arrays (xyz, keys, mask) shifts by one slot
            compare("grid.origin", t.origin, j["origin"])
            compare("grid.cell_size", t.cell_size, j["cell_size"])
            pt, pj = _point_set(t.xyz.numpy(), t.mask.numpy()), _point_set(j["xyz"], j["mask"])
            assert len(pt ^ pj) <= 0.005 * len(pj), len(pt ^ pj)
        else:
            compare(name, t, j)
    assert int(after["l_count"]) > int(before["l_count"])  # a loop factor landed

    # the grid step alone, from JAX's own post-step rings: equal to JAX's
    # grid slot for slot, ints and bools exactly
    rings = convert.resident_state_from_arrays(after, device="cpu")
    kf_pose = rings.last_kf_pose
    grid = assemble_local_map(
        rings.kf_poses, rings.kf_clouds, rings.kf_masks, rings.kf_times, rings.kf_count,
        kf_pose[3:6], rings.kf_times[int(rings.kf_count) - 1],
        radius=params.radius, recent_seconds=params.recent_seconds,
        near_cap=params.near_cap, map_cap=params.map_cap, leaf=params.map_leaf,
        cell_size=params.cell_size, density=params.kf_density,
    )
    np.testing.assert_array_equal(grid.keys.numpy(), after["grid"]["keys"])
    np.testing.assert_array_equal(grid.mask.numpy(), after["grid"]["mask"])
    np.testing.assert_allclose(grid.xyz.numpy(), after["grid"]["xyz"], atol=1e-4)


def test_gps_factor_branch(jax_run):
    """The GPS half of the keyframe branch, which no run of this length
    reaches (the trajectory must first span 5 m): a fix for a keyframe 6 m
    on is added with addGPSFactor's gates and noise (elevation from the
    pose, variances clamped to >= 1), the marginal is conditioned on it and
    the solve is the full one; a fix within 5 m of it is refused."""
    jp, carried = jax_run
    params = convert.resident_params(jp.params._asdict())._replace(loop_enabled=False)
    st = convert.resident_state_from_arrays(carried["after"], device="cpu")
    k = int(st.kf_count)
    z = torch.zeros(())
    tally = Counter()

    def insert(st, k, pose, enu):
        sigma = torch.tensor([2.0, 0.5, 3.0])
        return tres._insert_keyframe(
            st, params, k, pose, st.kf_times[k - 1] + 0.1, st.kf_clouds[0].clone(),
            st.kf_masks[0].clone(), st.sc_descs[0].clone(), st.sc_keys[0].clone(),
            True, enu, sigma, False, False, z, z, tally,
        )

    prev = st.kf_poses[k - 1].clone()
    pose = prev.clone()
    pose[3] += 6.0
    Rm, tm = tres._chain_edge(prev, pose)
    dyaw = torch.atan2(Rm[1, 0], Rm[0, 0])
    P_want = tmarginal.gps_update(
        tmarginal.propagate(st.g_P.clone(), prev[2], torch.stack([dyaw, tm[0], tm[1]]), torch),
        4.0, 1.0, torch,
    )
    enu = torch.tensor([float(pose[3]) + 0.3, float(pose[4]) - 0.2, 50.0])
    st, new_pose = insert(st, k, pose, enu)
    assert int(st.g_count) == 1 and int(st.g_i[0]) == k and tally["read:full"] == 1
    np.testing.assert_allclose(st.g_t[0].numpy(), [enu[0], enu[1], pose[5]], atol=1e-6)
    np.testing.assert_allclose(st.g_sqrt[0].numpy(), [0.5, 1.0, 1.0])
    np.testing.assert_array_equal(st.g_last.numpy(), st.g_t[0].numpy())
    np.testing.assert_allclose(st.g_P.numpy(), P_want.numpy(), rtol=1e-6, atol=1e-6)

    pose2 = new_pose.clone()
    pose2[3] += 1.0
    st, _ = insert(st, k + 1, pose2, enu + torch.tensor([1.0, 0.0, 0.0]))
    assert int(st.g_count) == 1 and tally["read:full"] == 2 and int(st.kf_count) == k + 2


def test_external_loop_candidate(jax_run):
    """loopInfoHandler parity: a stamp pair maps to keyframes by
    searchsorted over the time ring (the current stamp to the first keyframe
    at or after it, the earlier one to the last at or before it, as
    :787-806) and is ICP-verified without the RS/SC
    cadence; a resend is deduplicated by kf_has_loop on the device. On the
    host a candidate is resent for 20 frames, and a pair closer than
    historyKeyframeSearchTimeDiff is consumed and dropped."""
    jp, carried = jax_run
    params = convert.resident_params(jp.params._asdict())
    st = convert.resident_state_from_arrays(carried["after"], device="cpu")
    t, k = st.kf_times, st.kf_count - 1
    assert not bool(st.kf_has_loop[2])
    n = int(st.l_count)
    tally = Counter()
    for _ in range(2):
        st, added = tres._try_loop_closure(
            st, params, k, t[k], False, True, t[2] - 0.01, t[0] + 0.01, tally
        )
    assert tally["icp_runs"] == 1 and added is False  # the resend found the gate closed
    assert int(st.l_count) == n + 1 and bool(st.kf_has_loop[2])
    assert (int(st.l_i[n]), int(st.l_j[n])) == (0, 2)

    pipe = ResidentPipeline(SlamConfig(**_KW), device="cpu")
    pipe.push_loop_candidate(10.0, 2.0)
    assert [pipe._ext_loop_candidate(0.0)[0] for _ in range(21)] == [True] * 20 + [False]
    pipe.push_loop_candidate(5.0, 5.1)
    assert pipe._ext_loop_candidate(0.0)[0] is False and not pipe.loop_info_queue


def test_ring_growth_matches_large_rings(streams, port_run):
    """Rings that start too small grow as the JAX package's do (same bounds,
    m = 2) and the run equals the one with large rings."""
    tp, _ = port_run
    cfg = SlamConfig(**{**_KW, **_SMALL_CAPS})
    small = _drive(_with_icp_cap(ResidentPipeline(cfg, device="cpu")), streams)
    assert small.growth_events >= 2
    st = small.state
    assert st.kf_poses.shape[0] > 4 and st.traj.shape[0] > 4
    assert st.l_i.shape[0] > 3 and st.imu_traj.shape[0] > 150
    assert small.host_reads()["ring_counts"] >= 1
    assert _counts(st) == _counts(tp.state)
    np.testing.assert_allclose(small.trajectory_arrays()[1], tp.trajectory_arrays()[1], atol=1e-5)
    np.testing.assert_allclose(small.imu_rate_trajectory()[1], tp.imu_rate_trajectory()[1], atol=1e-5)


def test_checkpoint_resume_equals_uninterrupted_run(streams, port_run):
    """Checkpoint after CKPT_AT frames, resume in a fresh pipeline, run the
    rest: the same trajectory as the uninterrupted run, bit for bit."""
    tp, ckpt = port_run
    resumed = _with_icp_cap(ResidentPipeline(SlamConfig(**_KW), device="cpu"))
    load_checkpoint(resumed, ckpt)
    assert resumed.frame_idx == CKPT_AT and resumed._host.kf_count == CKPT_AT
    _drive(resumed, streams, lo=CKPT_AT)
    t_res, p_res = resumed.trajectory_arrays()
    t_full, p_full = tp.trajectory_arrays()
    np.testing.assert_array_equal(t_res, t_full)
    np.testing.assert_array_equal(p_res, p_full)
    assert _counts(resumed.state) == _counts(tp.state)


def test_checkpoint_refuses_foreign_pickles(tmp_path):
    """A pickle that names a class (the JAX package's checkpoints pickle its
    NamedTuples) is refused before anything is imported."""
    import pickle

    path = str(tmp_path / "foreign.pkl")
    with open(path, "wb") as f:
        pickle.dump(dict(format="resident-v2", state=Counter()), f)
    with pytest.raises(ValueError, match="not a liorf_tpu_torch checkpoint"):
        load_checkpoint(ResidentPipeline(SlamConfig(**_KW), device="cpu"), path)


def test_marginal_device_functions_match_jax():
    """The marginal proxy with torch tensors (constants built on P's device)
    against the JAX package's with jnp."""
    rng = np.random.default_rng(3)
    P_t = tmarginal.initial_cov(torch, device="cpu")
    P_j = jmarginal.initial_cov(jnp)
    np.testing.assert_array_equal(P_t.numpy(), np.asarray(P_j))
    for _ in range(4):
        yaw = np.float32(rng.uniform(-3, 3))
        delta = rng.normal(size=3).astype(np.float32)
        P_t = tmarginal.propagate(P_t, torch.tensor(yaw), torch.tensor(delta), torch)
        P_j = jmarginal.propagate(P_j, jnp.asarray(yaw), jnp.asarray(delta), jnp)
        np.testing.assert_allclose(P_t.numpy(), np.asarray(P_j), rtol=1e-6, atol=1e-6)
    vx, vy = np.float32(2.0), np.float32(3.5)
    G_t = tmarginal.gps_update(P_t, torch.tensor(vx), torch.tensor(vy), torch)
    G_j = jmarginal.gps_update(P_j, jnp.asarray(vx), jnp.asarray(vy), jnp)
    np.testing.assert_allclose(G_t.numpy(), np.asarray(G_j), rtol=1e-5, atol=1e-5)
    for thresh in (1.0, 25.0, 1e5):
        assert bool(tmarginal.gate_open(G_t, thresh)) == bool(jmarginal.gate_open(G_j, thresh))
    assert P_t.dtype == G_t.dtype == torch.float32


def test_small_op_semantics_match_jax():
    """The ops the loop branch leans on: argmin of an all-inf vector is 0,
    and searchsorted over inf-padded times agrees on both sides."""
    assert int(torch.argmin(torch.full((5,), torch.inf))) == int(jnp.argmin(jnp.full((5,), jnp.inf))) == 0
    times = np.array([0.1, 0.5, 0.5, 0.9, np.inf, np.inf], np.float32)
    for q in (0.0, 0.5, 0.7, 0.9, 2.0):
        for side in ("left", "right"):
            t = torch.searchsorted(torch.tensor(times), torch.tensor([q], dtype=torch.float32), side=side)
            j = jnp.searchsorted(jnp.asarray(times), jnp.float32(q), side=side)
            assert int(t[0]) == int(j), (q, side)


def test_cli_run_and_eval(tmp_path, capsys):
    """``cli run --device cpu`` writes the JAX CLI's files and closing JSON
    line; ``cli eval`` of the trajectory against itself is zero."""
    cfg = tmp_path / "small.yaml"
    cfg.write_text(
        "liorf:\n  scan_capacity: 4096\n  map_capacity: 16384\n  kf_cloud_capacity: 2048\n"
        "  near_kf_capacity: 8\n  imu_window: 32\n  kf_capacity: 16\n  traj_capacity: 32\n"
        "  gps_capacity: 8\n  loop_capacity: 8\n  imu_rate_capacity: 1024\n"
    )
    out = str(tmp_path / "out")
    cli.main(["run", "--dataset", "synthetic", "--frames", "4", "--out", out, "--device", "cpu",
              "--config", str(cfg), "--save-map", "--imu-tum", "--checkpoint"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"frames", "keyframes", "scans_per_sec", "out"}
    assert line["frames"] == 4 and line["keyframes"] >= 1 and line["out"] == out
    for name in ("trajectory_tum.txt", "imu_rate_tum.txt", "checkpoint.pkl", "trajectory.pcd",
                 "transformations.pcd", "SurfMap.pcd", "GlobalMap.pcd"):
        assert os.path.exists(os.path.join(out, name)), name
    tum = np.loadtxt(os.path.join(out, "trajectory_tum.txt"))
    assert tum.shape == (4, 8) and np.isfinite(tum).all()
    est = os.path.join(out, "trajectory_tum.txt")
    cli.main(["eval", "--est", est, "--gt", est])
    ev = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ev["ate_rmse"] == 0.0 and ev["frames"] == 4


def test_make_pipeline_defaults_to_cuda():
    cfg = SlamConfig(scan_capacity=256, map_capacity=1024, kf_cloud_capacity=256)
    if torch.cuda.is_available():
        assert make_pipeline(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_pipeline(cfg)
    assert isinstance(make_pipeline(cfg, device="cpu"), ResidentPipeline)


def test_native_packer_is_built_with_the_pipeline(monkeypatch):
    """The scan packer's g++ build happens when the pipeline is built, not
    inside its first frame; without g++ the numpy packer serves."""
    from liorf_tpu_torch import native

    if shutil.which("g++") is None:
        pytest.skip("needs g++ (the numpy packer serves without it)")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    pipe = ResidentPipeline(SlamConfig(scan_capacity=256, map_capacity=1024,
                                       kf_cloud_capacity=256), device="cpu")
    assert pipe.frame_idx == 0 and pipe.state is None
    assert native._lib is not None, native.build_error
