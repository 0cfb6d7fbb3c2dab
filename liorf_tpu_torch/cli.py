"""Command-line interface: run SLAM over a dataset, export trajectory + maps.

The off-ROS equivalent of ``roslaunch liorf run_*.launch`` + ``rosbag play``
+ the save_map service, on the GPU by default. Examples:

    python -m liorf_tpu_torch.cli run --dataset synthetic --frames 100 --out /tmp/out
    python -m liorf_tpu_torch.cli run --dataset synthetic --frames 8 --out /tmp/o --device cpu
    python -m liorf_tpu_torch.cli run --dataset kitti --root /data/2011_09_30_drive_0018_sync \
        --config configs/kitti.yaml --gps --out /tmp/kitti_out
    python -m liorf_tpu_torch.cli run --dataset rosbag --root drive.bag --imu-topic /imu \
        --out /tmp/bag_out
    python -m liorf_tpu_torch.cli eval --est /tmp/out/trajectory_tum.txt --gt gt_tum.txt

    python -m liorf_tpu_torch.cli optimize --checkpoint /tmp/out/checkpoint.pkl --out /tmp/o.pkl

``run`` drives the device-resident pipeline (``make_pipeline``) over the
synthetic, KITTI raw, MulRan or rosbag dataset and prints one JSON line; its
files and that line are those of ``liorf_tpu.cli run``. On stderr it also
prints which scan packer ran (``{"packer": {"native": n, "numpy": m}}``).
``--viz`` writes the PLY files and, where matplotlib imports, overview.png;
without matplotlib it says so on stderr and goes on (the JAX cli raises).
``--resume`` and ``optimize --checkpoint`` read this package's checkpoints
and the JAX package's resident ones.
``optimize`` relaxes a checkpoint's whole keyframe graph with the
distributed solver over the current process group (a group of one when
there is none; under ``torchrun`` or ``dist.launch``, one rank a process).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from contextlib import nullcontext

import numpy as np


def _make_dataset(args):
    if args.dataset == "synthetic":
        from .sensors.synthetic import SyntheticConfig, SyntheticDataset

        syn = SyntheticDataset(SyntheticConfig(n_frames=args.frames))
        return syn, syn.imu_stream(), syn.gps_stream() if args.gps else []
    if not args.root:
        raise SystemExit(f"--dataset {args.dataset} needs --root")
    if args.dataset == "kitti":
        from .sensors.kitti import KittiRawDataset

        ds = KittiRawDataset(args.root)
        return ds, ds.imu_stream(), ds.gps_stream() if args.gps else []
    if args.dataset == "mulran":
        from .sensors.mulran import MulranDataset

        ds = MulranDataset(args.root)
        return ds, ds.imu_stream(), ds.gps_stream() if args.gps else []
    if args.dataset == "rosbag":
        from .pipeline import SlamConfig, load_config
        from .sensors.rosbag import RosbagDataset

        cfg = load_config(args.config) if args.config else SlamConfig()
        ds = RosbagDataset(
            args.root,
            cloud_topic=args.cloud_topic or cfg.pointCloudTopic,
            imu_topic=args.imu_topic or cfg.imuTopic,
            gps_topic=(args.gps_topic or cfg.gpsTopic) if args.gps else None,
            sensor=cfg.sensor,
        )
        return ds, ds.imu_stream(), ds.gps_stream() if args.gps else []
    raise SystemExit(f"unknown dataset {args.dataset}")


def cmd_run(args):
    from .mapping.export import load_checkpoint, save_checkpoint, save_map
    from .pipeline import SlamConfig, load_config, make_pipeline

    cfg = load_config(args.config) if args.config else SlamConfig()
    pipe = make_pipeline(cfg, device=args.device)
    if args.resume:
        load_checkpoint(pipe, args.resume)

    ds, imu, gps = _make_dataset(args)
    n = len(ds) if hasattr(ds, "__len__") else args.frames
    n = min(n, args.frames) if args.frames else n

    timers = None
    if args.profile:
        from .utils.profiling import StageTimers

        timers = StageTimers()
    stage = timers.stage if timers else (lambda *_a, **_k: nullcontext())

    ii = gi = 0
    t0 = time.perf_counter()
    for f in range(n):
        with stage("ingest"):
            scan = ds.scan(f)
            while ii < len(imu) and imu[ii].stamp <= scan.end_time + 0.02:
                pipe.push_imu(imu[ii])
                ii += 1
            while gi < len(gps) and gps[gi].stamp <= scan.stamp:
                pipe.push_gps(gps[gi])
                gi += 1
        with stage("pack+dispatch"):
            res = pipe.process_scan(scan)
        if args.verbose and f % 10 == 0:
            # the resident pipeline keeps results on the device (pose=None)
            pose_txt = (
                np.round(res.pose[3:], 2) if res.pose is not None else "(on device)"
            )
            print(f"[{f}/{n}] pose={pose_txt} kf={res.is_keyframe}", file=sys.stderr)
    with stage("device drain"):
        pipe.block()  # drain queued device work before stopping the clock
    elapsed = time.perf_counter() - t0
    if timers:
        print(json.dumps(dict(profile=timers.report())), file=sys.stderr)
    print(json.dumps(dict(packer=pipe.packer())), file=sys.stderr)

    os.makedirs(args.out, exist_ok=True)
    pipe.sync_store()  # pull keyframe clouds for export (one-time)
    pipe.save_tum(os.path.join(args.out, "trajectory_tum.txt"))
    if args.imu_tum:
        # IMU-rate odometry stream (the reference's odometry/imu topic,
        # imuPreintegration.cpp:482-505) as a TUM trajectory
        from .core import se3np
        from .eval.metrics import save_tum

        it, ip = pipe.imu_rate_trajectory()
        if len(it):
            quats = se3np.rot_to_quat_wxyz(se3np.euler_to_rot(ip[:, :3]))
            save_tum(os.path.join(args.out, "imu_rate_tum.txt"), it, ip[:, 3:6], quats)
    if args.save_map:
        save_map(pipe, args.out, resolution=args.resolution)
    elif cfg.savePCD:
        # reference parity: auto-export on shutdown when savePCD is set
        # (mapOptmization.cpp:442-450 invokes the save_map service with
        # default resolution into savePCDDirectory). The reference
        # unconditionally prepends $HOME to the configured value (:385);
        # a leading "~" is honored as the user spelling the same thing.
        raw = cfg.savePCDDirectory
        if raw.startswith("~"):
            dest = os.path.expanduser(raw)
        else:
            dest = os.path.join(os.path.expanduser("~"), raw.lstrip("/"))
        save_map(pipe, dest)
    if args.checkpoint:
        save_checkpoint(pipe, os.path.join(args.out, "checkpoint.pkl"))
    if args.viz:
        from .mapping.viz import export_ply, render_overview

        export_ply(pipe, args.out)
        # the PNG needs matplotlib, which a GPU host may lack: the PLY files
        # and the JSON line are written all the same
        try:
            render_overview(pipe, os.path.join(args.out, "overview.png"))
        except ImportError as e:
            print(f"cli run --viz: overview.png not drawn ({e})", file=sys.stderr)
    print(
        json.dumps(
            dict(
                frames=n,
                keyframes=pipe.store.count,
                scans_per_sec=round(n / elapsed, 2),
                out=args.out,
            )
        )
    )


def optimize_graph(st, device):
    """The full-batch pose graph of a resident state: every keyframe, the
    odometry chain (k, k+1), the loop and GPS factor rings, the prior on
    keyframe 0 (the JAX package's ``cli optimize``, cli.py:222-240 there)."""
    import torch

    from .core import se3
    from .graph import pose_graph as pg

    K, L, G = st.kf_poses.shape[0], st.l_i.shape[0], st.g_i.shape[0]
    i64 = dict(dtype=torch.int64, device=device)
    idx = torch.arange(K, **i64)
    e_sqrt = torch.tensor([1.0e3] * 3 + [1.0e2] * 3, dtype=torch.float32, device=device)
    return pg.PoseGraph(
        Rs=se3.euler_to_rot(st.kf_poses[:, :3]),
        ts=st.kf_poses[:, 3:6],
        node_mask=idx < st.kf_count,
        e_i=torch.cat([idx, st.l_i]),
        e_j=torch.cat([torch.clamp(idx + 1, max=K - 1), st.l_j]),
        e_Rm=torch.cat([st.e_Rm, st.l_Rm]),
        e_tm=torch.cat([st.e_tm, st.l_tm]),
        e_sqrt_info=torch.cat([e_sqrt.expand(K, 6), st.l_sqrt]),
        e_cauchy=torch.cat([torch.zeros(K, dtype=torch.float32, device=device), st.l_cauchy]),
        e_mask=torch.cat([(idx + 1) < st.kf_count, torch.arange(L, **i64) < st.l_count]),
        g_i=st.g_i,
        g_t=st.g_t,
        g_sqrt_info=st.g_sqrt,
        g_mask=torch.arange(G, **i64) < st.g_count,
        prior_i=torch.zeros((), **i64),
        prior_R=st.prior_R,
        prior_t=st.prior_t,
        prior_sqrt_info=torch.full((6,), 1.0e2, dtype=torch.float32, device=device),
    )


def cmd_optimize(args):
    """Distributed full-batch pose-graph relaxation of a checkpointed run.

    The live pipeline solves incrementally on one device; this offline pass
    splits keyframe blocks and factors over the ranks of the current
    process group (explicit all-gather / reduce-scatter collectives,
    ``dist/shard_map_solver.py``) and rewrites every keyframe pose — the
    reference's loop-closure isam bursts (mapOptmization.cpp:1521-1531,
    correctPoses :1611-1642) over the whole graph. Without a process group
    it joins torchrun's (``WORLD_SIZE`` / ``RANK`` in the environment) or
    forms a group of one on ``--device``. Rank 0 writes the checkpoint and
    prints the JSON line."""
    import datetime

    import torch
    import torch.distributed as tdist

    from .core import se3
    from .core.device import resolve_device
    from .dist.multihost import init_multihost
    from .dist.shard_map_solver import solve_shard_map
    from .dist.sharded import make_mesh
    from .graph import pose_graph as pg
    from .mapping.export import load_checkpoint, save_checkpoint
    from .pipeline import SlamConfig, load_config, make_pipeline

    own_group = not tdist.is_initialized()
    if own_group and "WORLD_SIZE" in os.environ:
        args.device = init_multihost(None, int(os.environ["WORLD_SIZE"]),
                                     int(os.environ["RANK"]), device=args.device)
    elif own_group:
        device = resolve_device(args.device, "cli optimize")
        tdist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo", store=tdist.HashStore(),
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=300),
        )
    try:
        mesh = make_mesh(args.devices, device=args.device)
        cfg = load_config(args.config) if args.config else SlamConfig()
        pipe = make_pipeline(cfg, device=mesh.device)
        load_checkpoint(pipe, args.checkpoint)
        st = pipe.state
        graph = optimize_graph(st, mesh.device)
        sync = torch.cuda.synchronize if mesh.device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        solved = solve_shard_map(
            graph, mesh, free_from=0,
            params=pg.SolveParams(gn_iters=args.gn_iters, pcg_iters=args.pcg_iters),
        )
        sync()
        elapsed = time.perf_counter() - t0

        new_poses = torch.cat([se3.rot_to_euler(solved.Rs), solved.ts], dim=-1)
        keep = graph.node_mask[:, None]
        pipe.state = st._replace(kf_poses=torch.where(keep, new_poses, st.kf_poses))
        pipe._synced = False
        out = args.out or args.checkpoint
        if mesh.rank == 0:
            save_checkpoint(pipe, out)
            print(json.dumps(dict(
                keyframes=int(st.kf_count), devices=mesh.size,
                solve_s=round(elapsed, 3), out=out,
            )))
    finally:
        if own_group:
            tdist.destroy_process_group()


def cmd_eval(args):
    """evo-equivalent trajectory evaluation: timestamp-associated pairs,
    SE(3) APE (trans + rot) and SE(3) RPE (trans + rot) — the metrics
    behind the reference's demo/kitti05_{ape,rpe}.png plots."""
    from .eval.metrics import (
        associate,
        ate_rmse,
        ate_rot_rmse_deg,
        load_tum,
        rpe_se3,
    )

    t_est, est, q_est = load_tum(args.est)
    t_gt, gt, q_gt = load_tum(args.gt)
    ia, ib = associate(t_est, t_gt, max_diff=args.t_max_diff)
    est, q_est = est[ia], q_est[ia]
    gt, q_gt = gt[ib], q_gt[ib]
    n = len(ia)
    if n < 2:
        raise SystemExit(
            f"only {n} associated pose pairs (t_max_diff={args.t_max_diff}); "
            "check the trajectories share a clock"
        )
    rpe_t, rpe_r = rpe_se3(est, q_est, gt, q_gt, delta=args.delta)
    print(
        json.dumps(
            dict(
                ate_rmse=round(ate_rmse(est, gt), 4),
                ate_rot_rmse_deg=round(ate_rot_rmse_deg(est, q_est, gt, q_gt), 4),
                rpe_rmse=round(rpe_t, 4),
                rpe_rot_rmse_deg=round(rpe_r, 4),
                frames=n,
            )
        )
    )


def main(argv=None):
    p = argparse.ArgumentParser(prog="liorf_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run SLAM over a dataset")
    r.add_argument(
        "--dataset", choices=["synthetic", "kitti", "mulran", "rosbag"], required=True
    )
    r.add_argument("--root", help="dataset root directory (or .bag path for rosbag)")
    r.add_argument("--config", help="reference-format YAML config")
    r.add_argument("--cloud-topic", help="rosbag: PointCloud2 topic (default: config)")
    r.add_argument("--imu-topic", help="rosbag: Imu topic (default: config)")
    r.add_argument("--gps-topic", help="rosbag: NavSatFix topic (default: config)")
    r.add_argument(
        "--resume",
        help="resume from a checkpoint.pkl: this package's, or a resident one "
        "(resident-v1 / resident-v2) of the JAX package",
    )
    r.add_argument(
        "--viz", action="store_true",
        help="export trajectory/map/loops PLYs + overview.png (the PNG only "
        "where matplotlib is installed)",
    )
    r.add_argument(
        "--profile", action="store_true",
        help="report per-stage host timing (ingest/dispatch/drain) to stderr",
    )
    r.add_argument("--frames", type=int, default=0, help="limit frame count")
    r.add_argument("--gps", action="store_true", help="enable the GPS factor stream")
    r.add_argument("--out", required=True)
    r.add_argument("--save-map", action="store_true")
    r.add_argument(
        "--imu-tum", action="store_true",
        help="also export the IMU-rate odometry stream as imu_rate_tum.txt",
    )
    r.add_argument("--resolution", type=float, default=0.0)
    r.add_argument("--checkpoint", action="store_true")
    r.add_argument("--verbose", action="store_true")
    r.add_argument(
        "--device", default=None,
        help="torch device of the SLAM state (default: cuda, an error where "
        "there is none; cpu runs the kernels' plain versions)",
    )
    r.set_defaults(fn=cmd_run)

    o = sub.add_parser(
        "optimize", help="distributed full-batch relaxation of a checkpoint"
    )
    o.add_argument(
        "--checkpoint", required=True,
        help="checkpoint.pkl of a resident pipeline: this package's or the JAX package's",
    )
    o.add_argument("--config", help="reference-format YAML config")
    o.add_argument("--out", help="output checkpoint (default: in-place)")
    o.add_argument(
        "--devices", type=int, default=None,
        help="ranks of the process group (default: all; without a group, 1)",
    )
    o.add_argument("--gn-iters", type=int, default=6)
    o.add_argument("--pcg-iters", type=int, default=96)
    o.add_argument(
        "--device", default=None,
        help="torch device of this rank (default: cuda, one card per rank; cpu "
        "solves on the host)",
    )
    o.set_defaults(fn=cmd_optimize)

    e = sub.add_parser("eval", help="ATE/RPE between TUM trajectories")
    e.add_argument("--est", required=True)
    e.add_argument("--gt", required=True)
    e.add_argument("--delta", type=int, default=10)
    e.add_argument(
        "--t-max-diff", type=float, default=0.02,
        help="max timestamp difference for pose association (s)",
    )
    e.set_defaults(fn=cmd_eval)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
