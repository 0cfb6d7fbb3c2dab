"""Run distributed cases read from an ``.npz`` on every rank of a launch.

A worker of ``dist/launch.py`` (``launch(n, ["--cases", IN, "--results",
DIR], module="liorf_tpu_torch.dist.cases", ...)``) used by the tests and by
``chip_smoke.py`` to hold the distributed modes against the single-device
port on the same inputs: every rank runs every case of ``IN`` in order and
writes ``DIR/rank{r}.npz`` — the arrays each case returns under
``"{name}/{field}"`` and a JSON ``meta`` (times, kernel launches,
collectives, iteration counts) — so that the caller can also check that
every rank's results equal rank 0's bit for bit.

``IN`` holds a JSON ``spec`` ({"cases": [{"kind": ..., "name": ..., ...}]})
and each case's input arrays under ``"{name}/{field}"``. Kinds:

* ``solve`` — ``solve_shard_map`` (or ``solve_sharded``) of a pose graph;
* ``scan`` — ``scan_to_map_sharded`` of a scan against a grid;
* ``detect`` — ``detect_loop_sharded`` over a ScanContext database;
* ``pipeline`` — ``ShardedResidentPipeline`` over a synthetic sequence
  (rank 0 saves a checkpoint of it where the case names one);
* ``multihost`` — ``multihost.demo_run`` (``solve_multihost``);
* ``cli_optimize`` — ``cli optimize`` of a checkpoint over the group.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as tdist

from .. import convert
from ..graph import pose_graph as pg
from ..ops import knn_cuda, segment_sum, voxel_filter
from ..ops.scan_match import ScanMatchParams
from . import multihost
from .resident_sharded import ShardedResidentPipeline
from .shard_map_solver import solve_shard_map
from .sharded import GraphMesh, solve_sharded
from .sharded_frontend import detect_loop_sharded, scan_to_map_sharded


def _timed(mesh: GraphMesh, fn, repeats: int):
    """``fn()`` once (the result kept), then ``repeats`` more times on the
    host clock with the device drained; seconds per call (None if
    ``repeats`` is 0)."""

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    out = fn()
    if not repeats:
        return out, None
    sync()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    sync()
    return out, (time.perf_counter() - t0) / repeats


def _inputs(data, name: str) -> dict:
    pre = f"{name}/"
    return {k[len(pre):]: data[k] for k in data.files if k.startswith(pre)}


def case_solve(mesh: GraphMesh, case: dict, arrays: dict):
    graph = convert.pose_graph_from_arrays(arrays, device=mesh.device)
    params = pg.SolveParams(**case.get("params", {}))
    solver = solve_sharded if case.get("solver") == "sharded" else solve_shard_map
    repeats = case.get("repeats", 0)
    mesh.counts.clear()
    segment_sum.reset_launch_counts()
    out, dt = _timed(mesh, lambda: solver(graph, mesh, case.get("free_from", 0), params),
                     repeats)
    meta = {"collectives_per_solve": {k: v // (1 + repeats) for k, v in mesh.counts.items()},
            "segment_sum_launches_per_solve":
                segment_sum.launch_counts()["segment_sum"] // (1 + repeats)}
    if dt is not None:
        meta["ms_per_gn_step"] = dt * 1e3 / params.gn_iters
    return {"Rs": out.Rs, "ts": out.ts}, meta


def case_scan(mesh: GraphMesh, case: dict, arrays: dict):
    grid = convert.grid_from_arrays({k[5:]: v for k, v in arrays.items()
                                     if k.startswith("grid_")}, device=mesh.device)
    args = [torch.as_tensor(arrays[k], device=mesh.device)
            for k in ("scan_xyz", "scan_mask", "init_pose")]
    params = ScanMatchParams(**case.get("params", {}))

    def run():
        return scan_to_map_sharded(args[0], args[1], grid, args[2], mesh, params)

    knn_cuda.reset_launch_counts()
    mesh.counts.clear()
    res = run()
    meta = {"k1_launches": knn_cuda.launch_counts()["knn_grid_topk"],
            "collectives": dict(mesh.counts)}
    _, dt = _timed(mesh, run, case.get("repeats", 0))
    if dt is not None:
        meta["ms_per_iter"] = dt * 1e3 / int(res.iters)
    return {f: getattr(res, f) for f in res._fields}, meta


def case_detect(mesh: GraphMesh, case: dict, arrays: dict):
    args = [torch.as_tensor(arrays[k], device=mesh.device)
            for k in ("descs", "keys", "qdesc", "qkey")]

    def run():
        return detect_loop_sharded(args[0], args[1], case["count"], args[2], args[3], mesh)

    res, dt = _timed(mesh, run, case.get("repeats", 0))
    meta = {} if dt is None else {"ms": dt * 1e3}
    return {f: getattr(res, f) for f in res._fields}, meta


def case_pipeline(mesh: GraphMesh, case: dict, arrays: dict):
    from ..pipeline.config import SlamConfig
    from ..sensors.synthetic import SyntheticConfig, SyntheticDataset

    syn = SyntheticDataset(SyntheticConfig(**case["synthetic"]))
    pipe = ShardedResidentPipeline(SlamConfig(**case["config"]), mesh)
    imu = syn.imu_stream()
    ii = 0
    frame_ms = []
    for counted in (knn_cuda, segment_sum, voxel_filter):
        counted.reset_launch_counts()
    for f in range(case["frames"]):
        scan = syn.scan(f)
        while ii < len(imu) and imu[ii].stamp <= scan.end_time + 0.02:
            pipe.push_imu(imu[ii])
            ii += 1
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        pipe.process_scan(scan)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    pipe.finish()
    if case.get("checkpoint"):
        from ..mapping.export import save_checkpoint

        if mesh.rank == 0:
            save_checkpoint(pipe, case["checkpoint"])
        tdist.barrier(group=mesh.group)  # the file exists for every rank's next case
    launches = knn_cuda.launch_counts()
    n = int(pipe.state.traj_count)
    meta = {
        "frame_ms": frame_ms, "gn_iters": pipe.gn_iters_total(),
        "k1_launches": launches["knn_grid_topk"], "k2_launches": launches["knn_bruteforce"],
        "voxel_filter_launches": voxel_filter.launch_counts()["voxel_filter"],
        "segment_sum_launches": segment_sum.launch_counts()["segment_sum"],
        "growth_events": pipe.growth_events, "host_reads": pipe.host_reads(),
        "icp_runs": pipe.tally["icp_runs"],
        "keyframes": int(pipe.state.kf_count), "loop_factors": int(pipe.state.l_count),
    }
    return {"traj": pipe.state.traj[:n]}, meta


def case_multihost(mesh: GraphMesh, case: dict, arrays: dict):
    return {}, multihost.demo_run(mesh, **case.get("args", {}))


def case_cli_optimize(mesh: GraphMesh, case: dict, arrays: dict):
    from .. import cli

    cli.main(["optimize", "--checkpoint", case["checkpoint"], "--out", case["out"],
              "--device", str(mesh.device), "--devices", str(mesh.size),
              *map(str, case.get("flags", []))])
    return {}, {}


CASES = {
    "solve": case_solve, "scan": case_scan, "detect": case_detect,
    "pipeline": case_pipeline, "multihost": case_multihost,
    "cli_optimize": case_cli_optimize,
}


def run_cases(mesh: GraphMesh, cases_path: str, results_dir: str) -> None:
    data = np.load(cases_path)
    spec = json.loads(str(data["spec"]))
    out, meta = {}, {}
    for case in spec["cases"]:
        name = case["name"]
        t0 = time.perf_counter()
        arrays, m = CASES[case["kind"]](mesh, case, _inputs(data, name))
        m["seconds"] = time.perf_counter() - t0
        meta[name] = m
        for k, v in arrays.items():
            out[f"{name}/{k}"] = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
    os.makedirs(results_dir, exist_ok=True)
    np.savez(os.path.join(results_dir, f"rank{mesh.rank}.npz"), meta=json.dumps(meta), **out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    multihost.add_rendezvous_flags(p)
    p.add_argument("--cases", required=True, help=".npz of the cases and their inputs")
    p.add_argument("--results", required=True, help="directory for rank{r}.npz")
    args = p.parse_args(argv)
    mesh = multihost.join(args)
    try:
        run_cases(mesh, args.cases, args.results)
    finally:
        tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
