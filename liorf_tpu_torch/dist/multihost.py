"""Multi-process distributed runtime for the pose-graph backend.

The reference's backend (GTSAM iSAM2, mapOptmization.cpp:1521-1531) cannot
outgrow one host. This module runs the keyframe-block-sharded GN/PCG solver
(``dist/shard_map_solver.py``) over a ``torch.distributed`` process group:
one process per device, NCCL between CUDA cards, gloo between CPU
processes.

* ``init_multihost`` joins the group (``init_process_group`` with a
  ``tcp://HOST:PORT`` or ``file://PATH`` rendezvous, or the ``env://`` one
  that ``torchrun`` sets up) with a finite timeout, so that a rank that
  falls out of step fails the run instead of hanging it;
* ``global_graph_mesh`` is the mesh over the whole group;
* ``solve_multihost`` solves one graph collectively: every process passes
  the same host graph and gets the solved graph back.

Run one worker per process (``dist/launch.py`` starts N of them locally):

    python -m liorf_tpu_torch.dist.multihost --coordinator file:///tmp/rdv \\
        --num-processes N --process-id I --backend gloo --device cpu
    torchrun --nproc-per-node N -m liorf_tpu_torch.dist.multihost --backend gloo --device cpu
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import time

import numpy as np
import torch
import torch.distributed as tdist

from ..core.device import resolve_device
from ..graph import pose_graph as pg
from ..graph.pose_graph import SolveParams
from .shard_map_solver import solve_shard_map
from .sharded import GraphMesh, make_mesh

DEFAULT_TIMEOUT_S = 300.0


def _init_method(coordinator: str | None) -> str:
    if not coordinator:
        return "env://"
    if coordinator.startswith(("tcp://", "file://", "env://")):
        return coordinator
    return f"tcp://{coordinator}"  # HOST:PORT, as the JAX package's flag


def init_multihost(
    coordinator: str | None,
    num_processes: int,
    process_id: int,
    backend: str | None = None,
    device=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> torch.device:
    """Join the process group; returns this process's device.

    ``device=None`` means ``cuda:{process_id % device_count}`` and raises
    without CUDA. ``backend=None`` means ``nccl`` on CUDA and ``gloo`` on
    the CPU; gloo on CUDA only when named. ``coordinator`` is
    ``tcp://HOST:PORT``, ``HOST:PORT``, ``file://PATH`` or None (``env://``,
    torchrun's ``MASTER_ADDR`` / ``MASTER_PORT``)."""
    if device is None:
        resolve_device(None, "init_multihost")
        device = f"cuda:{process_id % torch.cuda.device_count()}"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", process_id % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("init_multihost: nccl needs a CUDA device")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        # the ranks share the host's cores, and their work between two
        # collectives is small: a thread pool each would only contend
        torch.set_num_threads(1)
    tdist.init_process_group(
        backend, init_method=_init_method(coordinator), world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s),
    )
    return device


def global_graph_mesh(device=None) -> GraphMesh:
    """The mesh over every process of the group (keyframe-block axis)."""
    return make_mesh(device=device)


def solve_multihost(
    graph: pg.PoseGraph,
    mesh: GraphMesh | None = None,
    free_from: int = 0,
    params: SolveParams = SolveParams(),
) -> pg.PoseGraph:
    """Distributed GN/PCG across the process group.

    Every process must call this collectively with the SAME graph; each gets
    the solved graph back. Semantics match ``pose_graph.solve``."""
    return solve_shard_map(graph, mesh or global_graph_mesh(), free_from, params)


# ---------------------------------------------------------------------------
# demo / emulation worker


def demo_graph(K: int, E: int, G: int, noise: float = 0.15, seed: int = 0, device=None):
    """Deterministic noisy-circle pose graph (odometry chain + closing loop
    edge + sparse GPS ties) — every process builds the identical graph.
    Returns (graph, ground-truth positions [n, 3], n)."""
    rng = np.random.default_rng(seed)
    n = K - 4
    yaw = 2 * np.pi * np.arange(n) / n
    r = 10.0 + 0.02 * n
    gt = np.stack([r * np.cos(yaw), r * np.sin(yaw), 0.1 * np.sin(3 * yaw)], 1)
    gt = gt.astype(np.float32)
    ts = gt + rng.normal(scale=noise, size=gt.shape).astype(np.float32)

    graph = pg.empty_graph(K, E, G, device=device)
    e_i = np.arange(E, dtype=np.int64) % (n - 1)
    e_j = e_i + 1
    e_tm = gt[e_j] - gt[e_i]
    e_mask = np.zeros(E, bool)
    e_mask[: n - 1] = True
    e_i[n - 1], e_j[n - 1], e_mask[n - 1] = n - 1, 0, True
    e_tm[n - 1] = gt[0] - gt[n - 1]

    g_idx = np.unique(np.linspace(0, n - 1, G, dtype=np.int64))
    g_mask = np.zeros(G, bool)
    g_mask[: len(g_idx)] = True
    g_idx = np.pad(g_idx, (0, G - len(g_idx)))
    ts_full = np.zeros((K, 3), np.float32)
    ts_full[:n] = ts
    dev = graph.Rs.device

    def t(a):
        return torch.as_tensor(a, device=dev)

    return graph._replace(
        ts=t(ts_full), node_mask=t(np.arange(K) < n),
        e_i=t(e_i), e_j=t(e_j), e_tm=t(e_tm), e_mask=t(e_mask),
        g_i=t(g_idx), g_t=t(gt[g_idx]), g_mask=t(g_mask), prior_t=t(gt[0]),
    ), gt, n


def demo_run(mesh: GraphMesh, nodes_per_device: int = 64, edges_per_node: int = 2,
             gn_iters: int = 4, pcg_iters: int = 48, inner_iters: int = 0,
             repeats: int = 3) -> dict:
    """Weak scaling: ``nodes_per_device`` keyframes a rank. Solves once to
    warm up, then ``repeats`` times on the clock, and holds the result
    against the single-device ``pose_graph.solve`` of the same graph."""
    K = nodes_per_device * mesh.size
    graph, gt, n = demo_graph(K, K * edges_per_node, max(8, K // 8), device=mesh.device)
    params = SolveParams(gn_iters=gn_iters, pcg_iters=pcg_iters, inner_iters=inner_iters)

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    out = solve_multihost(graph, mesh, free_from=0, params=params)  # warm-up
    mesh.counts.clear()
    sync()
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = solve_multihost(graph, mesh, free_from=0, params=params)
    sync()
    dt = (time.perf_counter() - t0) / max(repeats, 1)
    collectives = {k: v // max(repeats, 1) for k, v in mesh.counts.items()}

    ts = out.ts[:n].cpu().numpy()
    err = float(np.linalg.norm(ts - gt[:n], axis=1).mean())
    init_err = float(np.linalg.norm(graph.ts[:n].cpu().numpy() - gt[:n], axis=1).mean())
    # parity vs the single-device solver (local compute, same graph)
    ref = pg.solve(graph, free_from=0, params=params)
    parity = float(np.abs(ts - ref.ts[:n].cpu().numpy()).max())
    return {
        "num_processes": mesh.size,
        "global_devices": mesh.size,
        "device": str(mesh.device),
        "nodes": int(K),
        "solve_s": dt,
        "ms_per_gn_step": dt * 1e3 / max(gn_iters, 1),
        "collectives_per_solve": collectives,
        "err_vs_gt_m": err,
        "init_err_m": init_err,
        "parity_max_abs_m": parity,
    }


def add_rendezvous_flags(p: argparse.ArgumentParser) -> None:
    """The flags every worker of ``dist/launch.py`` takes; without
    ``--coordinator``, torchrun's ``RANK`` / ``WORLD_SIZE`` environment."""
    p.add_argument("--coordinator", default=None,
                   help="tcp://HOST:PORT, HOST:PORT or file://PATH (default: env://)")
    p.add_argument("--num-processes", type=int,
                   default=int(os.environ.get("WORLD_SIZE", 1)))
    p.add_argument("--process-id", type=int, default=int(os.environ.get("RANK", 0)))
    p.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                   help="default: nccl on cuda, gloo on cpu")
    p.add_argument("--device", default=None,
                   help="cpu, cuda or cuda:N (default: cuda, one card per process)")
    p.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT_S,
                   help="seconds a collective may wait for the other ranks")


def join(args) -> GraphMesh:
    """``init_multihost`` from the flags of ``add_rendezvous_flags``; the
    mesh over the whole group."""
    device = init_multihost(args.coordinator, args.num_processes, args.process_id,
                            backend=args.backend, device=args.device, timeout_s=args.timeout)
    return global_graph_mesh(device)


def _demo_main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_rendezvous_flags(p)
    p.add_argument("--nodes-per-device", type=int, default=64)
    p.add_argument("--edges-per-node", type=int, default=2)
    p.add_argument("--gn-iters", type=int, default=4)
    p.add_argument("--pcg-iters", type=int, default=48)
    p.add_argument("--inner-iters", type=int, default=0)
    p.add_argument("--repeats", type=int, default=3)
    args = p.parse_args(argv)

    mesh = join(args)
    try:
        res = demo_run(mesh, args.nodes_per_device, args.edges_per_node, args.gn_iters,
                       args.pcg_iters, args.inner_iters, args.repeats)
        if mesh.rank == 0:
            print(json.dumps(res), flush=True)
    finally:
        tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(_demo_main())
