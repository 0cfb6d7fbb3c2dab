"""The port's distributed modes (``liorf_tpu_torch.dist``) against the JAX
package's and against the port's single-device functions, on the CPU.

The JAX side runs in this process on the virtual 8-device CPU mesh of
``tests/conftest.py`` (``make_mesh(n)``). The port side runs in gloo worker
processes launched by the package's own launcher (``dist.launch``), twice
for the whole module: one launch of 4 ranks runs every case, one of 2 ranks
the solver cases at n = 2 and ``cli optimize``. The workers import only the
port; they read their inputs from an ``.npz`` and each rank writes its
results to one (``dist/cases.py``). Both launches start with the first test
and run while this process computes the JAX and single-device references.

Bounds (from the JAX package's own dist tests unless said otherwise):
solver 2e-3 m (tests/test_shard_map_solver.py), inner-outer 5e-3 m,
frozen nodes exact, ``solve_sharded`` 5e-3 m (tests/test_dist.py:48),
registration pose 5e-4 with equal match counts
(tests/test_sharded_frontend.py:46-50), loop search index and shift equal
and distance 1e-5, the sharded resident pipeline translation 2e-2 m and
rotation 6e-2 rad with >= 80 % keyframe flags equal (tests/test_dist.py),
``solve_multihost`` parity 1e-3 m and half the initial error
(tests/test_multihost.py), and every rank's results equal rank 0's exactly.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liorf_tpu.dist import shard_map_solver as jsms
from liorf_tpu.dist import sharded as jsharded
from liorf_tpu.dist import sharded_frontend as jfront
from liorf_tpu.graph import pose_graph as jpg
from liorf_tpu.ops import knn as jknn
from liorf_tpu.ops import scancontext as jsc
from liorf_tpu.ops.scan_match import ScanMatchParams as JScanMatchParams
from liorf_tpu_torch import cli, convert
from liorf_tpu_torch.dist.launch import launch
from liorf_tpu_torch.graph import pose_graph as tpg
from liorf_tpu_torch.mapping.export import load_checkpoint
from liorf_tpu_torch.ops import knn as tknn
from liorf_tpu_torch.ops.scan_match import ScanMatchParams, scan_to_map
from liorf_tpu_torch.pipeline import ResidentPipeline, SlamConfig
from liorf_tpu_torch.sensors.synthetic import SyntheticConfig, SyntheticDataset

CASES = "liorf_tpu_torch.dist.cases"
# fewer iterations than the JAX package's tests (4 x 48): a gloo collective
# costs ~2-6 ms between processes on this host, and each PCG step makes
# four; both packages and the single-device solve run the same iterations
SOLVE = dict(gn_iters=3, pcg_iters=32)
INNER = dict(gn_iters=3, pcg_iters=8, inner_iters=8)
WINDOW = dict(gn_iters=2, pcg_iters=32)
OPTIMIZE = ["--gn-iters", "3", "--pcg-iters", "32"]
SCAN = dict(max_iters=10)
DEMO = dict(nodes_per_device=32, pcg_iters=32, gn_iters=3, repeats=0)

# tests/test_dist.py's sharded-pipeline configuration (16 x 360, 10 frames)
PIPE_FRAMES = 10
PIPE_SYN = dict(n_frames=PIPE_FRAMES, n_rings=16, points_per_ring=360)
PIPE_CFG = dict(
    scan_capacity=4096, raw_capacity=8192, map_capacity=32768, kf_cloud_capacity=2048,
    near_kf_capacity=16, imu_window=64, point_filter_num=1, downsampleRate=1,
    mappingSurfLeafSize=0.4, surroundingKeyframeMapLeafSize=0.4, loopClosureEnableFlag=True,
    kf_capacity=64, traj_capacity=64, gps_capacity=16, loop_capacity=16,
)
# and its growth configuration: 12 frames through rings of 8
GROW_FRAMES = 12
GROW_SYN = dict(n_frames=GROW_FRAMES, n_rings=8, points_per_ring=180)
GROW_CFG = dict(
    scan_capacity=1024, raw_capacity=2048, map_capacity=8192, kf_cloud_capacity=512,
    near_kf_capacity=8, imu_window=32, point_filter_num=1, downsampleRate=1,
    mappingSurfLeafSize=0.4, surroundingKeyframeMapLeafSize=0.4, loopClosureEnableFlag=False,
    kf_capacity=8, traj_capacity=8, gps_capacity=8, loop_capacity=8, pull_free_growth=True,
)


# ---------------------------------------------------------------------------
# inputs, as numpy (every one made from a seed)

def circle_graph(K=48, E=64, G=16, noise=0.15, seed=0):
    """tests/test_shard_map_solver.py's graph: noisy circle, odometry chain,
    one loop edge, GPS ties. Returns (fields, gt, n)."""
    rng = np.random.default_rng(seed)
    n = K - 4
    yaw = 2 * np.pi * np.arange(n) / n
    gt = np.stack([10 * np.cos(yaw), 10 * np.sin(yaw), 0.1 * np.sin(3 * yaw)], 1)
    gt = gt.astype(np.float32)
    ts = gt + rng.normal(scale=noise, size=gt.shape).astype(np.float32)
    f = {k: np.asarray(v) for k, v in jpg.empty_graph(K, E, G)._asdict().items()}
    e_i = np.arange(E, dtype=np.int32) % (n - 1)
    e_j = e_i + 1
    e_tm = gt[e_j] - gt[e_i]
    e_mask = np.zeros(E, bool)
    e_mask[: n - 1] = True
    e_i[n - 1], e_j[n - 1], e_mask[n - 1] = n - 1, 0, True
    e_tm[n - 1] = gt[0] - gt[n - 1]
    g_idx = np.linspace(0, n - 1, G, dtype=np.int32)
    ts_full = np.zeros((K, 3), np.float32)
    ts_full[:n] = ts
    f.update(
        ts=ts_full, node_mask=np.arange(K) < n, e_i=e_i, e_j=e_j, e_tm=e_tm, e_mask=e_mask,
        g_i=g_idx, g_t=gt[g_idx], g_mask=np.ones(G, bool), prior_t=gt[0],
    )
    return f, gt, n


def chain_graph(K=64, n=48, noise=0.05, seed=0):
    """tests/test_dist.py's graph: a noisy circle with an odometry chain."""
    rng = np.random.default_rng(seed)
    yaw = 2 * np.pi * np.arange(n) / n
    ts = np.stack([10 * np.cos(yaw), 10 * np.sin(yaw), np.zeros(n)], 1).astype(np.float32)
    noisy = ts + rng.normal(scale=noise, size=ts.shape).astype(np.float32)
    noisy[0] = ts[0]
    f = {k: np.asarray(v) for k, v in jpg.empty_graph(K, K, 8)._asdict().items()}
    e_i = np.arange(K, dtype=np.int32) % (n - 1)
    f.update(
        ts=np.concatenate([noisy, np.zeros((K - n, 3), np.float32)]),
        node_mask=np.arange(K) < n, e_i=e_i, e_j=e_i + 1, e_tm=ts[e_i + 1] - ts[e_i],
        e_sqrt_info=np.full((K, 6), 10.0, np.float32), e_mask=np.arange(K) < n - 1,
        prior_t=ts[0],
    )
    return f, n


def plane_world(rng, n_per=2048):
    pts = []
    for axis, offset in [(2, 0.0), (0, -8.0), (0, 8.0), (1, -8.0), (1, 8.0)]:
        p = rng.uniform(-8, 8, size=(n_per, 3))
        p[:, axis] = offset
        pts.append(p)
    return np.concatenate(pts).astype(np.float32)


def sc_database(rng, count, C, planted=True):
    """tests/test_sharded_frontend.py's databases: random descriptors with
    the query a shifted copy of entry 7, or ring-disjoint ones (no match)."""
    descs = np.zeros((C, 20, 60), np.float32)
    if planted:
        descs[:count] = rng.uniform(0, 5, size=(count, 20, 60))
        q = np.roll(descs[7], 13, axis=1)
    else:
        for i in range(count):
            descs[i, 5 + i % 10] = rng.uniform(1, 5, size=60)
        q = np.zeros((20, 60), np.float32)
        q[0] = rng.uniform(1, 5, size=60)
    return descs, descs.mean(-1), q, q.mean(-1)


def run_stream(pipe, syn_kw, frames):
    syn = SyntheticDataset(SyntheticConfig(**syn_kw))
    imu = syn.imu_stream()
    ii = 0
    for f in range(frames):
        scan = syn.scan(f)
        while ii < len(imu) and imu[ii].stamp <= scan.end_time + 0.02:
            pipe.push_imu(imu[ii])
            ii += 1
        pipe.process_scan(scan)
    pipe.finish()
    return pipe


# ---------------------------------------------------------------------------
# the two launches

class Runs:
    """Both launches, started at once; ``result(world)`` waits for one and
    returns every rank's results as ({name/field: array}, meta)."""

    def __init__(self, tmp):
        self.tmp = tmp
        rng = np.random.default_rng(7)
        self.circle, self.gt, self.n = circle_graph()
        self.chain, self.chain_n = chain_graph()
        map_xyz = plane_world(rng)
        self.map_xyz = map_xyz
        self.scan = plane_world(rng, 512)
        self.init = np.asarray([0.02, -0.01, 0.03, 0.15, -0.1, 0.05], np.float32)
        grid = tknn.build_grid(torch.as_tensor(map_xyz), torch.ones(len(map_xyz), dtype=torch.bool),
                               torch.zeros(3), 1.0)
        self.grid = {f: getattr(grid, f).numpy() for f in grid._fields}
        self.db = sc_database(np.random.default_rng(1), 60, 64)
        self.db_none = sc_database(np.random.default_rng(2), 60, 64, planted=False)
        self.checkpoint = os.path.join(tmp, "checkpoint.pkl")

        cases4, arrays4 = [], {}
        cases2, arrays2 = [], {}

        def add(cases, arrays, case, inputs):
            cases.append(case)
            arrays.update({f"{case['name']}/{k}": v for k, v in inputs.items()})

        for cases, arrays, world in ((cases4, arrays4, 4), (cases2, arrays2, 2)):
            add(cases, arrays, dict(kind="solve", name="solve", params=SOLVE), self.circle)
            add(cases, arrays, dict(kind="multihost", name="multihost", args=DEMO), {})
        add(cases4, arrays4, dict(kind="solve", name="inner", params=INNER), self.circle)
        add(cases4, arrays4, dict(kind="solve", name="window", params=WINDOW,
                                  free_from=self.n - 8), self.circle)
        add(cases4, arrays4, dict(kind="solve", name="sharded", solver="sharded",
                                  params=SOLVE), self.chain)
        scan_in = {**{f"grid_{k}": v for k, v in self.grid.items()}, "init_pose": self.init}
        add(cases4, arrays4, dict(kind="scan", name="scan", params=SCAN),
            dict(scan_in, scan_xyz=self.scan, scan_mask=np.ones(len(self.scan), bool)))
        add(cases4, arrays4, dict(kind="scan", name="ragged", params=SCAN),
            dict(scan_in, scan_xyz=self.scan[:-3], scan_mask=np.ones(len(self.scan) - 3, bool)))
        for name, (descs, keys, q, qk) in (("detect", self.db), ("nomatch", self.db_none)):
            add(cases4, arrays4, dict(kind="detect", name=name, count=60),
                dict(descs=descs, keys=keys, qdesc=q, qkey=qk))
        add(cases4, arrays4, dict(kind="pipeline", name="pipeline", config=PIPE_CFG,
                                  synthetic=PIPE_SYN, frames=PIPE_FRAMES), {})
        # ring growth, then cli optimize of the grown run's checkpoint
        add(cases2, arrays2, dict(kind="pipeline", name="growth", config=GROW_CFG,
                                  synthetic=GROW_SYN, frames=GROW_FRAMES,
                                  checkpoint=self.checkpoint), {})
        add(cases2, arrays2, dict(kind="cli_optimize", name="optimize",
                                  checkpoint=self.checkpoint, flags=OPTIMIZE,
                                  out=os.path.join(tmp, "optimized2.pkl")), {})
        self._pool = ThreadPoolExecutor(2)
        self.futures = {w: self._start(w, c, a) for w, c, a in ((4, cases4, arrays4),
                                                                (2, cases2, arrays2))}

    def _start(self, world, cases, arrays):
        path = os.path.join(self.tmp, f"cases{world}.npz")
        np.savez(path, spec=json.dumps({"cases": cases}), **arrays)
        out = os.path.join(self.tmp, f"results{world}")
        return self._pool.submit(
            launch, world, ["--cases", path, "--results", out], module=CASES,
            backend="gloo", device="cpu", timeout=240,
        ), out

    def result(self, world: int):
        fut, out = self.futures[world]
        fut.result()
        ranks = [np.load(os.path.join(out, f"rank{r}.npz")) for r in range(world)]
        for r in ranks[1:]:  # every rank's results equal rank 0's bit for bit
            assert r.files == ranks[0].files
            for k in r.files:
                if k != "meta":
                    np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
        return ({k: ranks[0][k] for k in ranks[0].files if k != "meta"},
                [json.loads(str(r["meta"])) for r in ranks])

    def close(self):
        self._pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = Runs(str(tmp_path_factory.mktemp("dist")))
    yield r
    r.close()


def _jax_graph(fields):
    return jpg.PoseGraph(**{k: jnp.asarray(v) for k, v in fields.items()})


def _port_graph(fields):
    return convert.pose_graph_from_arrays(fields, device="cpu")


# ---------------------------------------------------------------------------
# the sharded resident pipeline first: its single-device reference is the
# longest computation here, and it runs while the workers do

def test_sharded_resident_pipeline_matches_single_device(runs):
    single = run_stream(ResidentPipeline(SlamConfig(**PIPE_CFG), device="cpu"), PIPE_SYN,
                        PIPE_FRAMES)
    ref = single.state.traj[: int(single.state.traj_count)].numpy()
    out, metas = runs.result(4)
    traj = out["pipeline/traj"]
    assert traj.shape == ref.shape == (PIPE_FRAMES, ref.shape[1])
    np.testing.assert_allclose(traj[:, 3:6], ref[:, 3:6], atol=2e-2)
    np.testing.assert_allclose(traj[:, :3], ref[:, :3], atol=6e-2)
    assert (traj[:, 6] == ref[:, 6]).mean() >= 0.8
    # each rank's GN iterations are the pipeline's; K1 counts launches of
    # the CUDA kernel only (the CPU runs its plain version)
    assert len({m["pipeline"]["gn_iters"] for m in metas}) == 1
    assert metas[0]["pipeline"]["gn_iters"] == single.gn_iters_total()


# ---------------------------------------------------------------------------
# solvers

@pytest.mark.parametrize("world", [4, 2])
def test_solve_shard_map_matches_jax_and_single_device(runs, world):
    jout = jsms.solve_shard_map(_jax_graph(runs.circle), jsharded.make_mesh(world),
                                params=jpg.SolveParams(**SOLVE))
    single = tpg.solve(_port_graph(runs.circle), params=tpg.SolveParams(**SOLVE))
    out, metas = runs.result(world)
    n = runs.n
    np.testing.assert_allclose(out["solve/ts"][:n], np.asarray(jout.ts)[:n], atol=2e-3)
    np.testing.assert_allclose(out["solve/ts"][:n], single.ts[:n].numpy(), atol=2e-3)
    err = np.linalg.norm(out["solve/ts"][:n] - runs.gt[:n], axis=1).mean()
    init_err = np.linalg.norm(runs.circle["ts"][:n] - runs.gt[:n], axis=1).mean()
    assert err < 0.5 * init_err
    # the JAX body's collective counts: per GN step 2 gathers + 2 reduce-
    # scatters, per PCG iteration one gather + one reduce-scatter (the
    # matvec) and two scalar all-reduces, one all-reduce to start each PCG,
    # two gathers at the end
    g, p = SOLVE["gn_iters"], SOLVE["pcg_iters"]
    assert metas[0]["solve"]["collectives_per_solve"] == {
        "all_gather": g * (2 + p) + 2, "reduce_scatter": g * (2 + p),
        "all_reduce": g * (1 + 2 * p),
    }


def test_inner_outer_matches_jax_and_single_device(runs):
    jout = jsms.solve_shard_map(_jax_graph(runs.circle), jsharded.make_mesh(4),
                                params=jpg.SolveParams(**INNER))
    single = tpg.solve(_port_graph(runs.circle), params=tpg.SolveParams(**SOLVE))
    out, metas = runs.result(4)
    n = runs.n
    np.testing.assert_allclose(out["inner/ts"][:n], np.asarray(jout.ts)[:n], atol=5e-3)
    np.testing.assert_allclose(out["inner/ts"][:n], single.ts[:n].numpy(), atol=5e-3)
    err = np.linalg.norm(out["inner/ts"][:n] - runs.gt[:n], axis=1).mean()
    init_err = np.linalg.norm(runs.circle["ts"][:n] - runs.gt[:n], axis=1).mean()
    assert err < 0.5 * init_err
    # the flexible CG sums its two scalars in one all-reduce: 2 a PCG step
    g, p = INNER["gn_iters"], INNER["pcg_iters"]
    assert metas[0]["inner"]["collectives_per_solve"]["all_reduce"] == g * (1 + 2 * p)


def test_trailing_window_keeps_frozen_nodes(runs):
    free_from = runs.n - 8
    single = tpg.solve(_port_graph(runs.circle), free_from=free_from,
                       params=tpg.SolveParams(**WINDOW))
    out, _ = runs.result(4)
    np.testing.assert_array_equal(out["window/ts"][:free_from], runs.circle["ts"][:free_from])
    np.testing.assert_allclose(out["window/ts"][: runs.n], single.ts[: runs.n].numpy(),
                               atol=2e-3)


def test_solve_sharded_matches_jax_and_single_device(runs):
    jout = jsharded.solve_sharded(_jax_graph(runs.chain), jsharded.make_mesh(4),
                                  params=jpg.SolveParams(**SOLVE))
    single = tpg.solve(_port_graph(runs.chain), params=tpg.SolveParams(**SOLVE))
    out, _ = runs.result(4)
    n = runs.chain_n
    np.testing.assert_allclose(out["sharded/ts"][:n], np.asarray(jout.ts)[:n], atol=5e-3)
    np.testing.assert_allclose(out["sharded/ts"][:n], single.ts[:n].numpy(), atol=5e-3)


@pytest.mark.parametrize("world", [4, 2])
def test_solve_multihost(runs, world):
    _, metas = runs.result(world)
    res = metas[0]["multihost"]
    assert res["num_processes"] == world and res["global_devices"] == world
    assert res["parity_max_abs_m"] < 1e-3
    assert res["err_vs_gt_m"] < 0.5 * res["init_err_m"]


# ---------------------------------------------------------------------------
# front-end

@pytest.mark.parametrize("name", ["scan", "ragged"])
def test_scan_to_map_sharded_matches_jax_and_single_device(runs, name):
    scan = runs.scan if name == "scan" else runs.scan[:-3]
    jgrid = jknn.build_grid(jnp.asarray(runs.map_xyz), jnp.ones(len(runs.map_xyz), bool),
                            jnp.zeros(3, jnp.float32), 1.0)
    jout = jfront.scan_to_map_sharded(jnp.asarray(scan), jnp.ones(len(scan), bool), jgrid,
                                      jnp.asarray(runs.init), jsharded.make_mesh(4),
                                      JScanMatchParams(**SCAN))
    grid = convert.grid_from_arrays(runs.grid, device="cpu")
    single = scan_to_map(torch.as_tensor(scan), torch.ones(len(scan), dtype=torch.bool), grid,
                         torch.as_tensor(runs.init), ScanMatchParams(**SCAN))
    out, metas = runs.result(4)
    np.testing.assert_allclose(out[f"{name}/pose"], np.asarray(jout.pose), atol=5e-4)
    np.testing.assert_allclose(out[f"{name}/pose"], single.pose.numpy(), atol=5e-4)
    assert int(out[f"{name}/num_matched"]) == int(jout.num_matched) == int(single.num_matched)
    np.testing.assert_allclose(out[f"{name}/pose"], np.zeros(6), atol=5e-3)
    # one all-reduce of the normal equations per GN iteration
    assert metas[0][name]["collectives"] == {"all_reduce": int(out[f"{name}/iters"])}


@pytest.mark.parametrize("name", ["detect", "nomatch"])
def test_detect_loop_sharded_matches_jax(runs, name):
    descs, keys, q, qk = runs.db if name == "detect" else runs.db_none
    jout = jfront.detect_loop_sharded(jnp.asarray(descs), jnp.asarray(keys), jnp.asarray(60),
                                      jnp.asarray(q), jnp.asarray(qk), jsharded.make_mesh(4))
    ref = jsc.detect_loop(jnp.asarray(descs), jnp.asarray(keys), jnp.asarray(60),
                          jnp.asarray(q), jnp.asarray(qk))
    out, _ = runs.result(4)
    assert int(out[f"{name}/index"]) == int(jout.index) == (7 if name == "detect" else -1)
    if name == "detect":
        assert int(ref.index) == 7
        np.testing.assert_allclose(out[f"{name}/distance"], np.asarray(jout.distance), atol=1e-5)
        np.testing.assert_allclose(out[f"{name}/yaw"], np.asarray(jout.yaw), atol=1e-6)


# ---------------------------------------------------------------------------
# ring growth and cli optimize (the 2-rank launch)

def test_sharded_resident_pipeline_ring_growth(runs):
    out, metas = runs.result(2)
    assert metas[0]["growth"]["growth_events"] >= 1
    traj = out["growth/traj"]
    assert traj.shape[0] == GROW_FRAMES
    assert np.isfinite(traj[:, :6]).all()


def test_cli_optimize_over_two_ranks_matches_one(runs, capsys):
    runs.result(2)
    one = os.path.join(runs.tmp, "optimized1.pkl")
    cli.main(["optimize", "--checkpoint", runs.checkpoint, "--out", one, "--device", "cpu",
              *OPTIMIZE])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["devices"] == 1 and line["out"] == one

    def poses(path):
        pipe = ResidentPipeline(SlamConfig(**GROW_CFG), device="cpu")
        load_checkpoint(pipe, path)
        return pipe.state.kf_poses.numpy(), int(pipe.state.kf_count)

    before, k = poses(runs.checkpoint)
    p1, _ = poses(one)
    p2, _ = poses(os.path.join(runs.tmp, "optimized2.pkl"))
    assert k == line["keyframes"] >= 2
    np.testing.assert_allclose(p2[:k], p1[:k], atol=2e-3)
    np.testing.assert_array_equal(p1[k:], before[k:])
    # one rank: the single-device solve of the same graph
    pipe = ResidentPipeline(SlamConfig(**GROW_CFG), device="cpu")
    load_checkpoint(pipe, runs.checkpoint)
    solved = tpg.solve(cli.optimize_graph(pipe.state, "cpu"),
                       params=tpg.SolveParams(gn_iters=3, pcg_iters=32))
    np.testing.assert_allclose(p1[:k, 3:], solved.ts[:k].numpy(), atol=1e-5)
