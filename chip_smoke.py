#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``liorf_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card, < 20 minutes

Builds the CUDA kernels from ``liorf_tpu_torch/csrc`` (one nvcc a source,
started together), holds each against its plain PyTorch version on the card
at the shapes the pipeline gives it (the k-NN kernels bit for bit; the
voxel filter, one kernel call for cells, sort and reduction, bit for bit
against its plain version and the CPU's route on a CPU copy; the
fixed-order segment sum, at the
distributed solver's matvec, against a float64 reduction and the CPU's
index_add; the pose graph's PCG kernel bit for bit against its plain version
on the CPU; its linearization kernel bit for bit against its plain version
and within a stated bound of the jacfwd linearization; the IMU fusion
kernel bit for bit against its plain version on the card and within stated
bounds of a float64 run and of the jacfwd fusion step; the IMU
preintegration kernel bit for bit against its plain version on the card and
within the CPU tests' bounds of the sequential recursion; the scan matcher's
linearization and update kernels and ICP's alignment kernel bit for bit
against their plain versions on the card; the deskew and the ScanContext
descriptor bit for bit against their plain versions on the card),
then drives the streaming SLAM pipeline (``LiorfPipeline``: push_imu /
process_scan / trajectory_arrays) at the repo's bench size and on the
loop-closure course, the device-resident pipeline (``make_pipeline``,
``ResidentPipeline``) on the same two courses, two default-mode runs of each
course that must be bit-equal (``repeat``), GPS factors through a whole
stream (``gps_path``, also through ``cli run --gps``), ring growth on the
loop course (``growth_path``), the fault-injection cases of
tests/test_fault_injection.py (``faults``), multi-session serving
(``MultiStreamPipeline``, N = 1, 4, 8 lock-step sessions at the multistream
operating point, then N = 4 on the loop course), the ``cli run`` entry point
(run with ``--viz``, then ``--resume``), and the distributed modes
(``liorf_tpu_torch.dist``: the keyframe-sharded solver, point-sharded
registration, the sharded loop search and ``ShardedResidentPipeline``, over
NCCL on every visible card and over 4 gloo ranks sharing card 0, against the
single-device port), and checks the outputs. K1 (``knn_grid_topk``) is timed
at the main path's shapes on the main path's own final grid, and the voxel
filter, the PCG kernel and the linearization on the arguments
the main path gave them, right after that path (the PCG and the
linearization also on the resident full solve's), and on the 8-lane
launches of multistream_path; the fusion and the preintegration kernels on
the last launch of the main path, the resident path and the 8-lane
multistream path (the preintegration also on a seeded K = 256 window); the deskew
and the descriptor on the last launch of the main path, the resident path and
the 8-lane multistream path (the deskew also on a seeded K = 256 case); the segment
sum on a seeded plan of the dist phase's graph; both k-NN kernels with a
lane axis at N = 8 in the kernels phase; the scan matcher's two kernels (one
kernel launch a call) on the last launches of the main path, the resident path
and the 8-lane multistream path, ICP's alignment kernel on the last launch of the resident
loop path and the multistream loop course. A single-device path launches no
segment sum, one voxel_filter a voxel filter call, one fusion_step a fusion
call, one preintegrate a preintegration call, one deskew a deskew call and one
make_descriptor a descriptor call (at most one of each a multistream tick but
the bootstrap's, where each lane bootstraps alone), one scan_linearize and one scan_update a K1 launch (a GN iteration)
and one icp_align an ICP iteration (a K2 launch but each run's last);
resident_loop_path's host syncs come from no library solver, no upload, no
kernel wrapper and not the IMU preintegration, at most MAX_SYNCS_PER_FRAME a frame; main_path and
resident_path name their five slowest frames. Everything runs
in the default mode (``torch.use_deterministic_algorithms`` off).

Each phase prints one JSON line. Any failed check raises, so the exit code is
non-zero and the closing ``{"ok": true, ...}`` line is never printed. There is
no CPU fallback: without a CUDA device the script exits with code 5.

Options (for shorter runs while developing):
    --phases device,kernels,main_path,resident_path,split,loop_path,resident_loop_path,
             repeat,gps_path,growth_path,faults,multistream_path,cli,dist
             [,profile][,profile_resident][,pcg_profile][,fusion_profile][,scan_gn_profile]
             [,scan_gn_parent][,linearize_profile][,preintegrate_profile][,kernels_parent]
             [,voxel_parent][,voxel_profile][,front_profile]
             [,edge_floor][,repair_cost][,first_frames]
                      not run by default: "profile" traces 8 warm frames with
                      torch.profiler (device-busy share, kernel time by name,
                      host operators by their own time), "profile_resident"
                      the same through the resident pipeline (one a process);
                      "pcg_profile" times the PCG kernel's phases by clock
                      cycles (a profiling build of csrc/pcg.cu),
                      "fusion_profile" the fusion kernel's on the main
                      path's last launch (with main_path; a profiling
                      build of csrc/fusion.cu), "scan_gn_profile" the scan
                      matcher's on its last linearization and first and
                      later updates (with main_path; a profiling build of
                      csrc/scan_gn.cu, with ptxas' and the SASS's sizes),
                      "linearize_profile" and "preintegrate_profile" the
                      pose graph's linearization and the IMU
                      preintegration on their last launches (with
                      main_path; profiling builds of csrc/linearize.cu and
                      csrc/preintegrate.cu, with ptxas' and the SASS's
                      sizes), "voxel_profile" the voxel filter's time by
                      part on the main path's scan and map clouds (with
                      main_path; a profiling build of csrc/voxel_filter.cu);
                      "edge_floor" holds a factor's linearization bits over
                      256 to 4096 edge slots; "repair_cost" times
                      resident_path here and in the --parent checkout, in turns;
                      "front_profile" the deskew's and the descriptor's
                      phases (with main_path; profiling builds of
                      csrc/deskew.cu and csrc/scancontext.cu); "first_frames"
                      a fresh process's first frames on the main, resident
                      and multistream pipelines (here, and in turns with the
                      --parent checkout where one is given)
    --parent DIR      the checkout repair_cost, scan_gn_parent (with main_path:
                      the scan matcher's calls of DIR on this tree's arguments,
                      bit for bit and timed in turns) and kernels_parent (with
                      main_path: DIR's linearize_normal, preintegrate,
                      deskew and descriptor calls the same way) and voxel_parent (with main_path: DIR's
                      voxel filter on the main path's scan and map clouds and
                      on seeded 8-lane scans, bit for bit and timed in turns)
                      and first_frames compare with
    --ptxas           print ptxas' register / shared-memory report
"""

from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from collections import Counter
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor, wait

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU\n")
    sys.exit(5)

from liorf_tpu_torch import native  # noqa: E402
from liorf_tpu_torch.eval.metrics import ate_rmse  # noqa: E402
from liorf_tpu_torch.core import build, se3  # noqa: E402
from liorf_tpu_torch.graph import pose_graph as pg  # noqa: E402
from liorf_tpu_torch.imu import fusion as tfusion  # noqa: E402
from liorf_tpu_torch.imu import preintegration as tpre  # noqa: E402
from liorf_tpu_torch.ops import deskew as tdsk  # noqa: E402
from liorf_tpu_torch.ops import fusion_step as fstep  # noqa: E402
from liorf_tpu_torch.ops import icp as ticp  # noqa: E402
from liorf_tpu_torch.ops import icp_align as ialign  # noqa: E402
from liorf_tpu_torch.ops import knn, knn_cuda  # noqa: E402
from liorf_tpu_torch.ops import linearize as lin  # noqa: E402
from liorf_tpu_torch.ops import pcg  # noqa: E402
from liorf_tpu_torch.ops import preintegrate as tpop  # noqa: E402
from liorf_tpu_torch.ops import scan_gn as sgn  # noqa: E402
from liorf_tpu_torch.ops import scan_match as tmatch  # noqa: E402
from liorf_tpu_torch.ops import scancontext as tsc  # noqa: E402
from liorf_tpu_torch.ops import segment_sum as segsum  # noqa: E402
from liorf_tpu_torch.ops import voxel_filter as vfil  # noqa: E402
from liorf_tpu_torch.core import voxel as tvoxel  # noqa: E402
from liorf_tpu_torch.pipeline import LiorfPipeline, SlamConfig, make_pipeline  # noqa: E402
from liorf_tpu_torch.pipeline import resident as tres  # noqa: E402
from liorf_tpu_torch.sensors.synthetic import SyntheticConfig, SyntheticDataset  # noqa: E402

DEV = torch.device("cuda", 0)
SEED = 0
MAIN_FRAMES = 60  # main path, at the bench size
LOOP_FRAMES = 64  # loop course
LOOP_PATH_FRAMES = 32  # loop_path's depth: through its first loop closures (frame ~26)
# main_path's ATE on the card before the deskew kernel (NVIDIA H100 80GB HBM3
# at 700 W) and how far a change of rounding may move it
MAIN_ATE_M, MAIN_ATE_DRIFT_M = 0.018448, 0.002

# Published peaks of one H100 SXM (NVIDIA data sheet): the bounds below are
# stated against these, with the card's power limit printed beside them.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FP64_FLOP_PER_S = 67e12  # with the tensor cores: the card's float64 peak

KERNEL_SOURCE = "liorf_tpu_torch/csrc/knn_kernels.cu"
SEGSUM_SOURCE = "liorf_tpu_torch/csrc/segment_sum.cu"
PCG_SOURCE = "liorf_tpu_torch/csrc/pcg.cu"
LINEARIZE_SOURCE = "liorf_tpu_torch/csrc/linearize.cu"
VOXEL_SOURCE = "liorf_tpu_torch/csrc/voxel_filter.cu"
FUSION_SOURCE = "liorf_tpu_torch/csrc/fusion.cu"
SCAN_GN_SOURCE = "liorf_tpu_torch/csrc/scan_gn.cu"
ICP_ALIGN_SOURCE = "liorf_tpu_torch/csrc/icp_align.cu"
PREINT_SOURCE = "liorf_tpu_torch/csrc/preintegrate.cu"
DESKEW_SOURCE = "liorf_tpu_torch/csrc/deskew.cu"
SC_SOURCE = "liorf_tpu_torch/csrc/scancontext.cu"
# tolerance of kernel vs plain version (both use the same rounded arithmetic,
# so the observed error is expected to be 0)
D2_RTOL, D2_ATOL = 1e-4, 1e-3
# (on top of it the script requires torch.equal of distances and indices)

# The repo's bench size (bench.py): 32 rings x 900 points = 28.8k points/scan.
BENCH_CAPS = dict(
    scan_capacity=16384,
    raw_capacity=32768,
    map_capacity=131072,
    kf_cloud_capacity=8192,
    near_kf_capacity=32,
    imu_window=64,
    point_filter_num=1,
    downsampleRate=1,
)


# The multistream operating point (bench.py:303-315,
# scripts/bench_multistream.py:39-55): 16 rings x 720 points a stream.
MULTI_CAPS = dict(
    scan_capacity=8192,
    raw_capacity=16384,
    map_capacity=131072,
    kf_cloud_capacity=4096,
    near_kf_capacity=32,
    imu_window=64,
    point_filter_num=1,
    downsampleRate=1,
)
MULTI_ICP_CAP = 16384  # ResidentParams.loop_icp_cap: K2's shape in the ICP


KERNEL_MODULES = (knn_cuda, segsum, pcg, lin, vfil, fstep, sgn, ialign, tpop, tdsk, tsc)


def reset_counts() -> None:
    """Every kernel's launch count, the pose graph's count of GN steps, the
    voxel filter's, the fusion step's, the preintegration's, the deskew's,
    the descriptor's and the scan matcher's counts of calls and the ICP's
    count of runs to 0 (just before a path runs)."""
    for m in KERNEL_MODULES:
        m.reset_launch_counts()
    pg.solve.gn_steps = 0
    tvoxel.voxel_downsample.calls = 0
    tfusion.fusion_step.calls = 0
    tpre.preintegrate.calls = 0
    tdsk.deskew_frame.calls = 0
    tsc.make_descriptor.calls = 0
    ticp.icp_point2point_lanes.runs = 0
    tmatch.scan_to_map_lanes.calls = 0


def launch_counts() -> dict[str, int]:
    out = {}
    for m in KERNEL_MODULES:
        out.update(m.launch_counts())
    return {**out, "pose_graph_gn_steps": pg.solve.gn_steps,
            "voxel_filter_calls": tvoxel.voxel_downsample.calls,
            "fusion_calls": tfusion.fusion_step.calls,
            "preintegrate_calls": tpre.preintegrate.calls,
            "deskew_calls": tdsk.deskew_frame.calls,
            "descriptor_calls": tsc.make_descriptor.calls,
            "icp_runs": ticp.icp_point2point_lanes.runs,
            "scan_to_map_calls": tmatch.scan_to_map_lanes.calls}


_EMIT = threading.Lock()
_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    # one write a line: the closing phases run side by side in threads
    line = json.dumps({"phase": phase, **fields, "at_s": time.perf_counter() - _T0}) + "\n"
    with _EMIT:
        sys.stdout.write(line)
        sys.stdout.flush()


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps: int = 20, warm: int = 3, batch: int = 1) -> float:
    """Median time of fn() in ms, by CUDA events, after warm-up. With
    batch > 1 each sample is `batch` calls back to back, divided by `batch`:
    the device time of a kernel once the host keeps ahead of it. With
    batch = 1 a sample is one call from an idle device, the host's time to
    reach the launch included (how the port's first kernels were timed)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


_L2_FLUSH = None  # 256 MB: writing it evicts the 50 MB L2 (~0.08 ms)


def cold_l2_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median device time of one fn() after the L2 cache was overwritten: a
    256 MB write runs just before each timed call, and the first event is
    recorded behind it, so the host's time to reach the launch hides under
    the write and the kernel finds its inputs in HBM."""
    global _L2_FLUSH
    if _L2_FLUSH is None:
        _L2_FLUSH = torch.empty(256 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        _L2_FLUSH.fill_(1)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_ms(fn) -> dict:
    """A kernel's time three ways: back to back (`ms`, the kernel's own, its
    inputs warm in L2), one call after the L2 was overwritten
    (`ms_cold_l2`), and one call from an idle device (`ms_single_call`, the
    first slice's method, the wrapper's host time included)."""
    return dict(ms=cuda_ms(fn, reps=10, batch=20), ms_cold_l2=cold_l2_ms(fn),
                ms_single_call=cuda_ms(fn))


# ---------------------------------------------------------------------------
# phase: device
# ---------------------------------------------------------------------------

def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def phase_device(ptxas: bool) -> str:
    """The card, the toolchain, and the eleven kernel libraries built at once
    (one nvcc a source, started together)."""
    smi = nvidia_smi_line()
    nvcc = subprocess.run(
        [build.find_nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-2:]
    flags = ("-Xptxas", "-v") if ptxas else ()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_MODULES)) as ex:
        for f in [ex.submit(m.load_library, flags) for m in KERNEL_MODULES]:
            f.result()
    emit(
        "device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=" | ".join(nvcc), python=sys.version.split()[0],
        kernel_build_seconds=dict(knn_kernels=knn_cuda.build_seconds,
                                  segment_sum=segsum.build_seconds,
                                  pcg=pcg.build_seconds, linearize=lin.build_seconds,
                                  voxel_filter=vfil.build_seconds,
                                  fusion=fstep.build_seconds,
                                  scan_gn=sgn.build_seconds, icp_align=ialign.build_seconds,
                                  preintegrate=tpop.build_seconds,
                                  deskew=tdsk.build_seconds, scancontext=tsc.build_seconds,
                                  all_wall=time.perf_counter() - t0),
        tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
        tf32_cudnn=torch.backends.cudnn.allow_tf32,
        deterministic_algorithms=torch.are_deterministic_algorithms_enabled(),
    )
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul must be off")
    check(not torch.are_deterministic_algorithms_enabled(),
          "the script runs in the default mode: deterministic algorithms must be off")
    return smi


# ---------------------------------------------------------------------------
# phase: kernels
# ---------------------------------------------------------------------------

def compare_knn(d_k, i_k, d_p, i_p) -> dict:
    """Kernel vs plain: distances within tolerance, indices equal off ties,
    missing neighbours (+inf, 0) in the same places."""
    fin_k, fin_p = torch.isfinite(d_k), torch.isfinite(d_p)
    check(bool((fin_k == fin_p).all()), "missing-neighbour pattern differs")
    check(bool((i_k[~fin_k] == 0).all()), "missing neighbour must carry index 0")
    check(bool(torch.isinf(d_k[~fin_k]).all()), "missing neighbour must carry +inf")
    dk, dp = d_k[fin_k], d_p[fin_p]
    err = (dk - dp).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    check(bool((err <= D2_ATOL + D2_RTOL * dp.abs()).all()), f"d2 disagrees: {max_abs}")
    differ = (i_k != i_p) & fin_k
    # a differing index is allowed only on an exact tie of the distances
    bad = differ & (d_k != d_p)
    check(int(bad.sum()) == 0, f"{int(bad.sum())} indices differ off ties")
    # both kernels repeat their plain version's arithmetic: nothing may differ
    check(torch.equal(d_k, d_p) and torch.equal(i_k, i_p), "kernel and plain version differ")
    return dict(
        max_abs_err=max_abs,
        index_agreement=float(1.0 - differ.sum().item() / max(int(fin_k.sum()), 1)),
        tie_index_differences=int(differ.sum()),
        missing=int((~fin_k).sum()),
    )


def synthetic_grid(m: int, gen: torch.Generator):
    """A planar map of m points with one over-full cell, duplicate points,
    masked and out-of-range points (the sentinel run)."""
    xyz = (torch.rand((m, 3), generator=gen, device=DEV) - 0.5) * 40.0
    xyz[: m // 2, 2] = 0.0
    xyz[m // 2 :, 0] = 4.0
    xyz[:100] = torch.rand((100, 3), generator=gen, device=DEV) + 2.0  # one dense cell
    xyz[200:300] = xyz[300:400]  # duplicates: exact ties
    xyz[400:420, 1] = 900.0  # out of the 1024-cell range
    mask = torch.rand((m,), generator=gen, device=DEV) > 0.05
    return knn.build_grid(xyz, mask, torch.tensor([0.25, -0.5, 0.125], device=DEV), 1.0)


def grid_queries(grid, n: int, gen: torch.Generator, ragged: bool):
    """Scan-shaped queries: valid map points, jittered, as a scan near the
    map gives them; the ragged set adds out-of-range and masked queries."""
    pick = torch.nonzero(grid.mask)[:, 0]
    pick = pick[torch.randint(0, len(pick), (n,), generator=gen, device=DEV)]
    q = grid.xyz[pick] + 0.05 * torch.randn((n, 3), generator=gen, device=DEV)
    mask = torch.ones(n, dtype=torch.bool, device=DEV)
    if ragged:
        q[:3] = torch.tensor([[700.0, 0.0, 0.0], [0.0, -800.0, 0.0], [0.0, 0.0, 1e9]], device=DEV)
        mask[3::10] = False
    return q.contiguous(), mask


def bench_k1(grid, q, mask, k: int, bucket: int, timed: bool = True) -> dict:
    n, m = q.shape[0], grid.xyz.shape[0]
    d_k, i_k = knn_cuda.knn_grid_topk(grid, q, mask, k, bucket)
    torch.cuda.synchronize()
    d_p, i_p = knn_cuda.knn_grid_topk_plain(grid, q, mask, k, bucket)
    res = compare_knn(d_k, i_k, d_p, i_p)
    check(bool(torch.isinf(d_k[~mask]).all()), "masked queries must be missing")
    starts, ends = knn_cuda._neighbor_runs(grid, q, mask)
    lens = torch.clamp(ends - starts, max=bucket) * mask[:, None]
    sum_runs = int(lens.sum())
    res.update(shape=[n, m], k=k, bucket=bucket, sum_runs=sum_runs,
               truncated_runs=int(((ends - starts) > bucket)[mask].sum()))
    if not timed:
        return res

    offs = torch.arange(bucket, dtype=torch.int32, device=DEV)

    def library():
        s, e = knn_cuda._neighbor_runs(grid, q, mask)
        valid = offs < torch.clamp(e - s, max=bucket)[..., None]
        valid = (valid & mask[:, None, None]).reshape(n, -1)
        cand = torch.where(valid, (s[..., None] + offs).reshape(n, -1), 0)
        d = (grid.xyz[cand] - q[:, None, :]).square().sum(-1)
        return torch.topk(torch.where(valid, d, torch.inf), k, dim=1, largest=False)

    # What the function must move: queries and their mask, the sorted grid's
    # coordinates and keys once, origin and cell size, the outputs; what it
    # computes: 8 flop for each point of the (truncated) runs this input has.
    bytes_moved = n * 12 + n + m * 16 + 16 + n * k * 8
    flops = 8 * sum_runs
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    res.update(
        **kernel_ms(lambda: knn_cuda.knn_grid_topk(grid, q, mask, k, bucket)),
        plain_ms=cuda_ms(lambda: knn_cuda.knn_grid_topk_plain(grid, q, mask, k, bucket), reps=5, batch=4),
        library_ms=cuda_ms(library, reps=5, batch=4),
        library_call="searchsorted runs, gather, (cand - q).square().sum(-1), torch.topk(largest=False)",
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=bytes_moved, flops=flops, l2_candidate_bytes=12 * sum_runs,
    )
    return res


def bench_k2(n: int, m: int, k: int, gen) -> dict:
    tgt = (torch.rand((m, 3), generator=gen, device=DEV) - 0.5) * 60.0
    qry = (torch.rand((n, 3), generator=gen, device=DEV) - 0.5) * 60.0
    tgt[m // 2 :: 64] = tgt[: (m - m // 2 + 63) // 64]  # duplicated targets: exact ties
    tmask = torch.rand((m,), generator=gen, device=DEV) > 0.10
    qmask = torch.rand((n,), generator=gen, device=DEV) > 0.10
    d_k, i_k = knn_cuda.knn_bruteforce(tgt, tmask, qry, qmask, k)
    torch.cuda.synchronize()
    d_p, i_p = knn_cuda.knn_bruteforce_plain(tgt, tmask, qry, qmask, k)
    res = compare_knn(d_k, i_k, d_p, i_p)
    check(bool(torch.isinf(d_k[~qmask]).all()), "masked queries must be missing")
    # an all-masked map: everything missing
    d0, i0 = knn_cuda.knn_bruteforce(tgt, torch.zeros_like(tmask), qry, qmask, k)
    check(bool(torch.isinf(d0).all()) and bool((i0 == 0).all()), "all-masked map")

    far = torch.where(tmask[:, None], tgt, torch.full_like(tgt, 1e6))

    def library():
        return torch.topk(torch.cdist(qry, far), k, dim=1, largest=False)

    bytes_moved = m * 13 + n * 13 + n * k * 8
    flops = n * m * 8
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    res.update(
        shape=[n, m], k=k,
        **kernel_ms(lambda: knn_cuda.knn_bruteforce(tgt, tmask, qry, qmask, k)),
        plain_ms=cuda_ms(lambda: knn_cuda.knn_bruteforce_plain(tgt, tmask, qry, qmask, k), reps=5, batch=4),
        library_ms=cuda_ms(library, reps=5, batch=4),
        library_call="torch.cdist then torch.topk(largest=False)",
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=bytes_moved, flops=flops,
    )
    return res


def stack_grids(grids):
    """One stacked grid ([B, ...] on every field) from B grids of one size."""
    return type(grids[0])(*(torch.stack(f).contiguous() for f in zip(*grids)))


def lane_equal(out, refs, what: str) -> None:
    """Stacked (d2, idx) against per-lane references, bit for bit."""
    for b, (d_r, i_r) in enumerate(refs):
        check(torch.equal(out[0][b], d_r) and torch.equal(out[1][b], i_r),
              f"{what}: lane {b} differs from its reference")


def bench_k1_lanes(lanes: int, n: int, m: int, k: int, bucket: int, gen) -> dict:
    """K1 with a lane axis: `lanes` distinct grids and query sets in one
    launch, held bit for bit against the stacked plain version and against
    one-lane calls lane by lane; then a ragged stack (a lane of masked
    queries only, a lane with an empty map, ragged query masks)."""
    grids = [synthetic_grid(m, gen) for _ in range(lanes)]
    qs = [grid_queries(g, n, gen, b % 2 == 1) for b, g in enumerate(grids)]
    grid = stack_grids(grids)
    q = torch.stack([x[0] for x in qs]).contiguous()
    qm = torch.stack([x[1] for x in qs]).contiguous()
    out = knn_cuda.knn_grid_topk(grid, q, qm, k, bucket)
    torch.cuda.synchronize()
    plain = knn_cuda.knn_grid_topk_plain(grid, q, qm, k, bucket)
    res = compare_knn(out[0], out[1], plain[0], plain[1])
    lane_equal(out, [knn_cuda.knn_grid_topk(g, q[b], qm[b], k, bucket)
                     for b, g in enumerate(grids)], "K1 stacked vs one-lane calls")
    # ragged: lane 0 all queries masked, lane 1 an empty (all-invalid) map
    rq = qm.clone()
    rq[0] = False
    empty = knn.build_grid(grids[1].xyz, torch.zeros_like(grids[1].mask), grids[1].origin, 1.0)
    rgrids = list(grids)
    rgrids[1] = empty
    rgrid = stack_grids(rgrids)
    rout = knn_cuda.knn_grid_topk(rgrid, q, rq, k, bucket)
    rplain = knn_cuda.knn_grid_topk_plain(rgrid, q, rq, k, bucket)
    compare_knn(rout[0], rout[1], rplain[0], rplain[1])
    lane_equal(rout, [knn_cuda.knn_grid_topk(g, q[b], rq[b], k, bucket)
                      for b, g in enumerate(rgrids)], "K1 ragged stack vs one-lane calls")
    check(bool(torch.isinf(rout[0][0]).all()), "K1: a lane of masked queries must be all missing")
    sum_runs = 0
    for b, g in enumerate(grids):
        s_, e_ = knn_cuda._neighbor_runs(g, q[b], qm[b])
        sum_runs += int((torch.clamp(e_ - s_, max=bucket) * qm[b][:, None]).sum())
    bytes_moved = lanes * (n * 12 + n + m * 16 + 16 + n * k * 8)
    flops = 8 * sum_runs
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    one = kernel_ms(lambda: knn_cuda.knn_grid_topk(grids[0], q[0], qm[0], k, bucket))
    res.update(
        lanes=lanes, shape=[lanes, n, m], k=k, bucket=bucket, sum_runs=sum_runs,
        equal_to_one_lane_calls=True, ragged_equal=True,
        **kernel_ms(lambda: knn_cuda.knn_grid_topk(grid, q, qm, k, bucket)),
        one_lane_ms=one["ms"], one_lane_ms_single_call=one["ms_single_call"],
        plain_ms=cuda_ms(lambda: knn_cuda.knn_grid_topk_plain(grid, q, qm, k, bucket), reps=3, batch=2),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=bytes_moved, flops=flops,
    )
    return res


def bench_k2_lanes(lanes: int, n: int, m: int, k: int, gen) -> dict:
    """K2 with a lane axis: `lanes` distinct target and query sets in one
    launch, held bit for bit against the stacked plain version and one-lane
    calls; then a ragged stack (an all-masked map lane, an all-masked query
    lane) and a lane length that is no multiple of 16 (the wrapper pads)."""
    tgt = (torch.rand((lanes, m, 3), generator=gen, device=DEV) - 0.5) * 60.0
    qry = (torch.rand((lanes, n, 3), generator=gen, device=DEV) - 0.5) * 60.0
    tgt[:, m // 2 :: 64] = tgt[:, : (m - m // 2 + 63) // 64]  # exact ties
    tmask = torch.rand((lanes, m), generator=gen, device=DEV) > 0.10
    qmask = torch.rand((lanes, n), generator=gen, device=DEV) > 0.10
    out = knn_cuda.knn_bruteforce(tgt, tmask, qry, qmask, k)
    torch.cuda.synchronize()
    plain = knn_cuda.knn_bruteforce_plain(tgt, tmask, qry, qmask, k)
    res = compare_knn(out[0], out[1], plain[0], plain[1])
    lane_equal(out, [knn_cuda.knn_bruteforce(tgt[b], tmask[b], qry[b], qmask[b], k)
                     for b in range(lanes)], "K2 stacked vs one-lane calls")
    rt, rq = tmask.clone(), qmask.clone()
    rt[0] = False
    rq[1] = False
    m2 = m - 5  # no multiple of 16
    rt2 = rt[:, :m2].contiguous()
    t2 = tgt[:, :m2].contiguous()
    rout = knn_cuda.knn_bruteforce(t2, rt2, qry, rq, k)
    rplain = knn_cuda.knn_bruteforce_plain(t2, rt2, qry, rq, k)
    compare_knn(rout[0], rout[1], rplain[0], rplain[1])
    lane_equal(rout, [knn_cuda.knn_bruteforce(t2[b], rt2[b], qry[b], rq[b], k)
                      for b in range(lanes)], "K2 ragged stack vs one-lane calls")
    check(bool(torch.isinf(rout[0][0]).all() and torch.isinf(rout[0][1]).all()),
          "K2: an all-masked map lane and an all-masked query lane must be all missing")
    bytes_moved = lanes * (m * 13 + n * 13 + n * k * 8)
    flops = lanes * n * m * 8
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    one = kernel_ms(lambda: knn_cuda.knn_bruteforce(tgt[0], tmask[0], qry[0], qmask[0], k))
    res.update(
        lanes=lanes, shape=[lanes, n, m], k=k, equal_to_one_lane_calls=True, ragged_equal=True,
        **kernel_ms(lambda: knn_cuda.knn_bruteforce(tgt, tmask, qry, qmask, k)),
        one_lane_ms=one["ms"], one_lane_ms_single_call=one["ms_single_call"],
        plain_ms=cuda_ms(lambda: knn_cuda.knn_bruteforce_plain(tgt, tmask, qry, qmask, k), reps=3, batch=2),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=bytes_moved, flops=flops,
    )
    return res


def phase_kernels(main_size_k1: bool) -> dict:
    """Both kernels against their plain versions. K1 at the main path's size
    is measured on the main path's own grid after that path
    (phase_k1_main_grid); here it runs on ragged synthetic grids, and at full
    width on a synthetic stand-in only when the main path is not run."""
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    bucket = knn.exact_bucket(1.0, 0.3)
    ragged = synthetic_grid(3001, gen)
    out = {
        "knn_bruteforce": bench_k2(16384, 16384, 1, gen),
        "knn_bruteforce_k5": bench_k2(16384, 16384, 5, gen),
        # ragged sizes: no multiple of any tile
        "knn_bruteforce_ragged": bench_k2(1001, 3333, 8, gen),
        "knn_grid_topk_ragged_k3": bench_k1(ragged, *grid_queries(ragged, 1001, gen, True), 3, 8, False),
        "knn_grid_topk_ragged_k8": bench_k1(ragged, *grid_queries(ragged, 1001, gen, True), 8, 8, False),
    }
    check(out["knn_grid_topk_ragged_k3"]["truncated_runs"] > 0, "ragged grid must overflow a cell")
    # the lane axis, at the multistream path's shapes with N = 8 sessions
    out["knn_grid_topk_lanes8"] = bench_k1_lanes(
        8, MULTI_CAPS["scan_capacity"], MULTI_CAPS["map_capacity"], 5, bucket, gen)
    out["knn_bruteforce_lanes8"] = bench_k2_lanes(8, MULTI_ICP_CAP, MULTI_ICP_CAP, 1, gen)
    if main_size_k1:
        big = synthetic_grid(BENCH_CAPS["map_capacity"], gen)
        out["knn_grid_topk"] = bench_k1(big, *grid_queries(big, BENCH_CAPS["scan_capacity"], gen, False), 5, bucket)
    emit("kernels", tolerance=dict(rtol=D2_RTOL, atol=D2_ATOL), **out)
    return out


def phase_k1_main_grid(pipe: LiorfPipeline) -> dict:
    """K1 at the main path's shapes on the main path's final grid, queried
    by a jittered scan-shaped set (as phase_split does)."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    q, mask = grid_queries(pipe.grid, pipe.cfg.scan_capacity, gen, False)
    res = bench_k1(pipe.grid, q, mask, 5, pipe.frame_params.match.knn_bucket)
    emit("kernels_main_grid", knn_grid_topk=res)
    return res


# ---------------------------------------------------------------------------
# phases: main_path, loop_path
# ---------------------------------------------------------------------------

def run_pipeline(pipe: LiorfPipeline, syn: SyntheticDataset, n_frames: int, log=None):
    """Every frame through ``pipe``, each timed by the host's clock around
    ``process_scan`` and a synchronize; with ``log`` (a FrameLog) each
    frame's kinds are noted outside the timed window."""
    imu = syn.imu_stream()
    ii = 0
    frame_ms, results = [], []
    for f in range(n_frames):
        scan = syn.scan(f)
        while ii < len(imu) and imu[ii].stamp <= scan.end_time + 0.02:
            pipe.push_imu(imu[ii])
            ii += 1
        if log is not None:
            log.before()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(pipe.process_scan(scan))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if log is not None:
            log.after(results[-1])
    return results, frame_ms


_SEEN_IN_PROCESS: set[str] = set()  # every event kind a frame of this process has shown


class FrameLog:
    """What each frame of a path did, for its slowest frames: keyframe,
    window or full solve, loop search, ICP, ring growth, the host's garbage
    collected and frozen, the native scan packer's first use (and build), and
    which of those
    and of the kernels ran for the first time in this process (the first
    call of the library routines and kernels behind them). Hooks the
    pipeline's solve and loop search while it is open; reads the launch
    counters and the growth count between frames, outside the timed window."""

    def __init__(self, pipe):
        self.pipe, self.kinds, self._cur, self._restore = pipe, [], [], []
        if isinstance(pipe, tres.ResidentPipeline):
            self._hook(tres, "_solve_graph_resident", lambda st, params, full: "full solve"
                       if full else "window solve")
            self._hook(tres, "_try_loop_closure", lambda *a, **k: "loop search")
        else:
            self._hook(pipe, "_solve_graph", lambda *a, full=False, **k: "full solve" if full
                       else "window solve")
            self._hook(pipe.loop_detector, "run", lambda *a, **k: "loop search")

    def _hook(self, obj, name, kind):
        real = getattr(obj, name)

        def call(*a, **k):
            self._cur.append(kind(*a, **k))
            return real(*a, **k)

        setattr(obj, name, call)
        self._restore.append((obj, name, real))

    def close(self):
        for obj, name, real in reversed(self._restore):
            setattr(obj, name, real)
        self._restore = []

    def before(self):
        self._cur, self._counts = [], launch_counts()
        self._growth = getattr(self.pipe, "growth_events", 0)
        self._kf = self._keyframes()
        # the resident pipeline collects and freezes the host's garbage once
        # at a set frame (utils/gc_control.py::quiesce), and again after a growth
        if self.pipe.frame_idx == getattr(self.pipe, "_gc_quiesce_at", None):
            self._cur.append("gc quiesce (gc.collect + gc.freeze)")
        self._native = native._lib is not None

    def _keyframes(self) -> int:
        # the resident pipeline's FrameResult leaves is_keyframe False: its
        # host view counts them
        host = getattr(self.pipe, "_host", None)
        return host.kf_count if host is not None else self.pipe.store.count

    def after(self, result):
        counts = launch_counts()
        ran = [k for k, v in counts.items() if v > self._counts[k] and k in
               {n for m in KERNEL_MODULES for n in m.launch_counts()}]
        kinds = (["keyframe"] if self._keyframes() > self._kf else []) + self._cur
        if counts["icp_runs"] > self._counts["icp_runs"]:
            kinds.append("ICP")
        if getattr(self.pipe, "growth_events", 0) > self._growth:
            kinds.append("ring growth")
        if not self._native and native._lib is not None:
            kinds.append("native packer first used (its g++ build where none is cached)")
        firsts = [k for k in dict.fromkeys(kinds + [f"kernel {n}" for n in ran])
                  if k not in _SEEN_IN_PROCESS]
        _SEEN_IN_PROCESS.update(firsts)
        self.kinds.append(list(dict.fromkeys(kinds)) + [f"first in process: {k}" for k in firsts])


def slowest_frames(frame_ms, kinds, n: int = 5) -> list[dict]:
    """The n slowest frames but the bootstrap: index, ms, kinds."""
    order = sorted(range(1, len(frame_ms)), key=lambda f: -frame_ms[f])[:n]
    return [dict(frame=f, ms=frame_ms[f], kind=kinds[f] or ["plain frame"]) for f in order]


def percentile(xs, p):
    return float(np.percentile(np.asarray(xs), p))


MAIN_KW = dict(**BENCH_CAPS, mappingSurfLeafSize=0.3, surroundingKeyframeMapLeafSize=0.3,
               loopClosureEnableFlag=True)


def main_config() -> SlamConfig:
    return SlamConfig(**MAIN_KW)


def main_synthetic(n_frames: int) -> dict:
    return dict(n_frames=n_frames, n_rings=32, points_per_ring=900, seed=SEED)


class Course:
    """A synthetic course drawn once, at the longest length a phase runs it,
    and replayed by every phase that runs it. Its scans are ray casts of the
    noise-free trajectory (no random draw) and its IMU noise is drawn one
    sample after another, first of all; so the first n frames of the long
    draw are what a fresh draw of n frames gives, read in run_pipeline's
    order (the city world's geometry does not depend on the length). With a
    pool, the scans are cast in its worker processes ahead of use."""

    def __init__(self, synthetic: dict, pool=None):
        self.syn = SyntheticDataset(SyntheticConfig(**synthetic))
        self.frames = synthetic["n_frames"]
        self.imu = self.syn.imu_stream()
        self.gt = self.syn.ground_truth()
        self.scans = {}
        self.gps = None
        if pool is not None:
            for lo in range(0, self.frames, SCAN_CHUNK):
                hi = min(lo + SCAN_CHUNK, self.frames)
                job = pool.submit(draw_scans, synthetic, lo, hi)
                self.scans.update({f: (job, f - lo) for f in range(lo, hi)})

    def scan(self, f: int):
        s = self.scans.get(f)
        if s is None:
            s = self.scans[f] = self.syn.scan(f)
        elif isinstance(s, tuple):
            s = self.scans[f] = s[0].result()[s[1]]
        return s

    def gps_stream(self):
        # drawn after the whole IMU stream, as a fresh dataset of this
        # length draws it
        if self.gps is None:
            self.gps = self.syn.gps_stream()
        return self.gps


SCAN_CHUNK = 8  # scans a worker casts in one job
SCAN_WORKERS = 6


def draw_scans(synthetic: dict, lo: int, hi: int) -> list:
    """Scans lo..hi-1 of a course (in a worker process)."""
    syn = SyntheticDataset(SyntheticConfig(**synthetic))
    return [syn.scan(f) for f in range(lo, hi)]


class CoursePrefix:
    """The first ``n`` frames of a Course, with SyntheticDataset's readers."""

    def __init__(self, course: Course, n: int):
        check(n <= course.frames, f"{n} frames of a course drawn to {course.frames}")
        self.course, self.n = course, n

    def imu_stream(self):
        return self.course.imu  # run_pipeline reads it up to each scan's end

    def scan(self, f: int):
        check(f < self.n, f"frame {f} of a {self.n}-frame course")
        return self.course.scan(f)

    def ground_truth(self):
        t, p = self.course.gt
        return t[: self.n], p[: self.n]

    def gps_stream(self):
        check(self.n == self.course.frames, "GPS fixes are drawn for the whole course only")
        return self.course.gps_stream()


def course_synthetic(name: str, lane: int = 0) -> dict:
    """The generator's settings of a course at its longest: the main course
    (as long as gps_path runs it), the loop course (lane 0 as long as the
    resident loop paths run it, lanes 1.. as multistream_loop_course does)
    and multistream_path's streams (lane ``lane``'s own seed, and on odd
    lanes tests/test_multistream.py's second course: yaw rate 0.4, 3 m/s)."""
    if name == "main":
        return main_synthetic(GPS_FRAMES)
    if name == "loop":
        return dict(loop_synthetic(LOOP_FRAMES if lane == 0 else MULTI_LOOP_TICKS),
                    seed=SEED + 101 * lane)
    kw = dict(yaw_rate=0.4, speed=3.0) if lane % 2 else {}
    return dict(n_frames=MULTI_TICKS, n_rings=16, points_per_ring=720, seed=SEED + 101 * lane,
                **kw)


_COURSES: dict = {}


def course(name: str, lane: int = 0, pool=None) -> Course:
    if (name, lane) not in _COURSES:
        _COURSES[name, lane] = Course(course_synthetic(name, lane), pool)
    return _COURSES[name, lane]


def draw_courses(pool) -> None:
    """Every course the script runs, its scans cast by ``pool``."""
    for name, lanes in (("main", 1), ("loop", MULTI_PARITY_LANES), ("multi", max(MULTI_LANES))):
        for lane in range(lanes):
            course(name, lane, pool)


def main_dataset(n_frames: int) -> CoursePrefix:
    # every path of one course sees one input: the first n_frames frames of
    # the course drawn once
    return CoursePrefix(course("main"), n_frames)


LOOP_KW = dict(**BENCH_CAPS, mappingSurfLeafSize=0.4, surroundingKeyframeMapLeafSize=0.4,
               loopClosureEnableFlag=True, loopClosureFrequency=2.0,
               historyKeyframeSearchTimeDiff=2.0, historyKeyframeSearchNum=5)


def loop_config() -> SlamConfig:
    return SlamConfig(**LOOP_KW)


def loop_synthetic(n_frames: int) -> dict:
    return dict(n_frames=n_frames, n_rings=16, points_per_ring=360, speed=3.0, yaw_rate=1.2,
                gyro_bias=(0.01, -0.008, 0.015), accel_noise=0.08, gyro_noise=0.01, seed=SEED)


def loop_dataset(n_frames: int) -> CoursePrefix:
    return CoursePrefix(course("loop"), n_frames)


def phase_main_path(n_frames: int = MAIN_FRAMES):
    cfg = main_config()
    syn = main_dataset(n_frames)
    pipe = LiorfPipeline(cfg)  # device=None: the card
    check(pipe.device.type == "cuda", "pipeline must default to the GPU")
    reset_counts()
    log = FrameLog(pipe)
    try:
        results, frame_ms = run_pipeline(pipe, syn, n_frames, log)
    finally:
        log.close()
    counts = launch_counts()

    _, poses = pipe.trajectory_arrays()
    _, gt = syn.ground_truth()
    check(poses.shape == (n_frames, 6), f"trajectory shape {poses.shape}")
    check(bool(np.isfinite(poses).all()), "trajectory not finite")
    ate = ate_rmse(poses[:, 3:6].astype(np.float64), gt[:n_frames])
    gn_iters = [r.gn_iters for r in results]
    steady = frame_ms[1:]  # frame 0 is the bootstrap
    emit(
        "main_path", frames=n_frames, points_per_scan=32 * 900, ate_rmse_m=ate,
        keyframes=pipe.store.count, graph_edges=len(pipe.edges),
        gn_iters_total=int(sum(gn_iters)), gn_iters_per_frame_mean=float(np.mean(gn_iters[1:])),
        k1_launches=counts["knn_grid_topk"], k2_launches=counts["knn_bruteforce"],
        ms_per_frame_p50=percentile(steady, 50), ms_per_frame_p99=percentile(steady, 99),
        ms_per_frame_mean=float(np.mean(steady)),
        degenerate_frames=int(sum(r.degenerate for r in results)),
        num_matched_mean=float(np.mean([r.num_matched for r in results[1:]])),
        slowest_frames=slowest_frames(frame_ms, log.kinds),
    )
    check(ate < 0.3, f"ATE {ate} m >= 0.3 m")
    check(abs(ate - MAIN_ATE_M) < MAIN_ATE_DRIFT_M,
          f"ATE {ate} m moved more than {MAIN_ATE_DRIFT_M} m from {MAIN_ATE_M} m")
    check(pipe.store.count >= 2, "fewer than 2 keyframes")
    # every frame deskews its scan and takes its descriptor, the bootstrap too
    check(counts["deskew"] == n_frames and counts["make_descriptor"] == n_frames,
          f"{counts['deskew']} deskew and {counts['make_descriptor']} descriptor launches in "
          f"{n_frames} frames")
    check(counts["knn_grid_topk"] > 0, "K1 never launched on the main path")
    check(
        counts["knn_grid_topk"] == sum(gn_iters),
        f"K1 launches {counts['knn_grid_topk']} != GN iterations {sum(gn_iters)}",
    )
    return pipe, counts


def phase_split(pipe: LiorfPipeline, lin_args, resident=None) -> None:
    """Where a frame's time goes: the stages of one frame, each timed alone by
    CUDA events at the main path's shapes, on the pipeline's final state;
    with ``resident`` (phase_resident_path's pipeline and pre-step
    snapshots) also the resident step's stages. ``lin_args``: the main
    path's last linearization, one call of it in the trace of one call
    each."""
    from liorf_tpu_torch.core.voxel import voxel_downsample_xyz
    from liorf_tpu_torch.imu import fusion, preintegration
    from liorf_tpu_torch.ops import scan_match, scancontext
    from liorf_tpu_torch.ops.deskew import deskew_frame

    cfg, fp = pipe.cfg, pipe.frame_params
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    grid = pipe.grid
    # a scan-shaped query set: valid map points, jittered
    n = cfg.scan_capacity
    pick = torch.nonzero(grid.mask)[:, 0]
    pick = pick[torch.randint(0, len(pick), (n,), generator=gen, device=DEV)]
    world = grid.xyz[pick] + 0.05 * torch.randn((n, 3), generator=gen, device=DEV)
    mask = torch.ones(n, dtype=torch.bool, device=DEV)
    pose = torch.zeros(6, device=DEV)
    norm_q = torch.sqrt(torch.sqrt(torch.linalg.norm(world, dim=-1) + 1e-12))
    raw = torch.cat([world, world + 0.1], dim=0)[: cfg.raw_cap].contiguous()
    raw_mask = torch.ones(raw.shape[0], dtype=torch.bool, device=DEV)
    K = cfg.imu_window
    acc = torch.randn((K, 3), generator=gen, device=DEV) + torch.tensor([0, 0, 9.8], device=DEV)
    gyr = 0.1 * torch.randn((K, 3), generator=gen, device=DEV)
    dts = torch.full((K,), 0.01, device=DEV)
    imask = torch.arange(K, device=DEV) < 10
    z3 = torch.zeros(3, device=DEV)
    # deskew's inputs: a gyro window of 24 samples at 200 Hz over a 0.1 s scan
    dk_times = 0.3 + 0.005 * torch.arange(K, device=DEV, dtype=torch.float32)
    dk_mask = torch.arange(K, device=DEV) < 24
    rel_t = 0.1 * torch.rand(raw.shape[0], generator=gen, device=DEV)
    scan_start = torch.full((), 0.31, device=DEV)
    pre = preintegration.preintegrate(acc, gyr, dts, imask, z3, z3, fp.fusion.imu)
    filt = fusion.init_filter(torch.eye(3, device=DEV), z3, fp.fusion)
    no = torch.zeros((), dtype=torch.bool, device=DEV)
    stamp = pipe.last_scan_stamp
    kf_pose = pipe.store.poses[pipe.store.count - 1].copy()
    grid1 = knn.SpatialHashGrid(*(f[None] for f in grid))
    st0 = sgn.init_state(pose[None])
    H, g, cnt = scan_match._build_system_lanes(
        pose[None], world[None], mask[None], norm_q[None], grid1, fp.match)

    stages = {
        "gn_iteration (_build_system_lanes, one lane: the moved scan + knn_grid + scan_linearize)":
            lambda: scan_match._build_system_lanes(
                pose[None], world[None], mask[None], norm_q[None], grid1, fp.match),
        "gn_iteration, the scan already moved (knn_grid + scan_linearize, as in the loop)":
            lambda: scan_match._build_system_lanes(
                pose[None], world[None], mask[None], norm_q[None], grid1, fp.match, world=world[None]),
        "knn_grid (one K1 launch)": lambda: knn.knn_grid(grid, world, mask, 5, fp.match.knn_bucket),
        "scan_update (one lane, first iteration)": lambda: sgn.scan_update(
            st0, H, g, cnt, world[None], fp.match, first=True),
        "scan_update (one lane, later iteration)": lambda: sgn.scan_update(
            st0, H, g, cnt, world[None], fp.match, first=False),
        "voxel_downsample scan (raw -> scan_capacity)": lambda: voxel_downsample_xyz(raw, raw_mask, fp.leaf, fp.scan_cap),
        "scancontext descriptor (one csrc/scancontext.cu launch)": lambda: scancontext.make_descriptor(
            raw, raw_mask),
        "preintegrate (one csrc/preintegrate.cu launch)": lambda: preintegration.preintegrate(
            acc, gyr, dts, imask, z3, z3, fp.fusion.imu),
        "deskew (one csrc/deskew.cu launch, raw_capacity points)": lambda: deskew_frame(
            raw, rel_t, raw_mask, scan_start, dk_times, gyr, dk_mask),
        "fusion_step": lambda: fusion.fusion_step(filt, pre, torch.eye(3, device=DEV), z3, no, fp.fusion),
        "fusion_step_jacfwd (op by op, the oracle)": lambda: fusion.fusion_step_jacfwd(
            filt, pre, torch.eye(3, device=DEV), z3, no, fp.fusion),
        "pose graph solve (window)": lambda: pipe._solve_graph(full=False),
        "pose graph solve (full)": lambda: pipe._solve_graph(full=True),
        "local-map rebuild (assemble_local_map + grid)": lambda: pipe._rebuild_grid(kf_pose, stamp),
    }
    resident_notes = {}
    if resident is not None:
        rstages, resident_notes = resident_stages(*resident)
        stages.update(rstages)
    out = {name: cuda_ms(fn, reps=5, warm=1) for name, fn in stages.items()}
    solves = {name: fn for name, fn in stages.items() if "solve" in name}
    parts = {name: solve_parts(fn) for name, fn in solves.items()}
    # the host waits of one window solve (empty_graph built its prior's
    # information from a host list until PR 7: one blocking upload a solve)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pipe._solve_graph(full=False)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    solve_syncs = Counter(f"{os.path.relpath(w.filename)}:{w.lineno}"
                          for w in caught if "synchroniz" in str(w.message).lower())
    # What one call of each one-kernel stage puts on the device, by kernel
    # name: one trace of the three calls (a second trace in one process has
    # come back empty on the card), each kernel's name its own op's.
    one_kernel = {
        "knn_grid_kernel": lambda: knn.knn_grid(grid, world, mask, 5, fp.match.knn_bucket),
        "deskew_kernel": lambda: deskew_frame(raw, rel_t, raw_mask, scan_start, dk_times, gyr,
                                              dk_mask),
        "descriptor_kernel": lambda: scancontext.make_descriptor(raw, raw_mask),
        "linearize_kernel": lambda: sgn.scan_linearize(pose[None], world[None], mask[None],
                                                       norm_q[None], d2[None], idx[None],
                                                       grid.xyz[None], fp.match),
        "update_kernel": lambda: sgn.scan_update(st0, H, g, cnt, world[None], fp.match,
                                                 first=True),
        "normal_terms_kernel": lambda: lin.linearize_normal(*lin_args),
        "preintegrate_kernel": lambda: preintegration.preintegrate(acc, gyr, dts, imask, z3, z3,
                                                                   fp.fusion.imu),
        "voxel_filter_kernel": lambda: voxel_downsample_xyz(raw, raw_mask, fp.leaf, fp.scan_cap),
    }
    d2, idx = knn.knn_grid(grid, world, mask, 5, fp.match.knn_bucket)
    launched, attempts = device_kernels(lambda: [fn() for fn in one_kernel.values()])
    emit("split", keyframes=pipe.store.count, ms=out, one_call_each_device_kernels=launched,
         one_call_each_of=list(one_kernel), profiler_attempts=attempts, solve_parts_ms=parts,
         main_window_solve_host_sync_sites=[[k, n] for k, n in solve_syncs.most_common()],
         **resident_notes)
    check(not any("graph/pose_graph.py" in k for k in solve_syncs),
          f"the pose graph solve waits for the card: {dict(solve_syncs)}")
    check(len(launched) == len(one_kernel) and all(
        any(k in e["name"] and e["calls"] == 1 for e in launched) for k in one_kernel),
        f"one knn_grid, one deskew, one make_descriptor, one scan_linearize, one scan_update, "
        f"one linearize_normal, one preintegrate and one voxel filter call must be one launch "
        f"each of "
        f"{list(one_kernel)}, got {launched}")


def device_kernels(fn) -> tuple[list, int]:
    """What fn() puts on the device, by kernel name (torch.profiler), and the
    traces it took. The tracer now and then hands back an empty trace (no
    device event at all, seen once on the card): that is the instrument
    failing, not the call, so an empty trace is taken again, up to three
    times; any trace with events is judged as it is."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        launched = [
            dict(name=e.key[:80], calls=e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
        ]
        if launched:
            break
    return launched, attempt + 1


def solve_parts(fn, reps: int = 3) -> dict:
    """One pose-graph solve (``fn``) split, by CUDA events around each call,
    into its linearizations (``pose_graph._build_normal_terms``) and its
    PCG (``pose_graph._pcg_fused``: the preconditioner's inverse and the
    kernel), each summed over the solve's GN steps; the median of ``reps``
    solves, the total by events around the whole call."""
    real_build, real_pcg = pg._build_normal_terms, pg._pcg_fused
    spans = {"linearize": [], "pcg": []}

    def timed(key, f):
        def call(*a, **kw):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = f(*a, **kw)
            e.record()
            spans[key].append((s, e))
            return out
        return call

    runs = []
    fn()  # warm
    pg._build_normal_terms, pg._pcg_fused = timed("linearize", real_build), timed("pcg", real_pcg)
    try:
        for _ in range(reps):
            for v in spans.values():
                v.clear()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            runs.append(dict(total=s.elapsed_time(e), gn_steps=len(spans["pcg"]),
                             **{k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}))
    finally:
        pg._build_normal_terms, pg._pcg_fused = real_build, real_pcg
    return {k: statistics.median(r[k] for r in runs) for k in runs[0]}


def phase_profile(warm: int = 12, traced: int = 8, resident: bool = False) -> None:
    """Device-busy share of a warm frame and the kernels that fill it, from a
    torch.profiler trace of `traced` frames at the main path's size, through
    LiorfPipeline or, with ``resident``, the resident pipeline
    (``profile_resident``: run it in a process of its own, since a second trace
    in one process has come back empty). The profiler stretches the host's
    time but not the device's, so the share is the traced window's device time
    over the wall time of the `traced` untraced frames just before it, in the
    same run. ``top_host`` ranks the host's operators by their own time in
    the trace (stretched by the profiler alike: read it as shares)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = SlamConfig(
        **BENCH_CAPS, mappingSurfLeafSize=0.3, surroundingKeyframeMapLeafSize=0.3,
        loopClosureEnableFlag=True,
    )
    n = warm + 2 * traced
    syn = SyntheticDataset(SyntheticConfig(n_frames=n, n_rings=32, points_per_ring=900, seed=SEED))
    pipe = make_pipeline(cfg) if resident else LiorfPipeline(cfg)
    imu = syn.imu_stream()
    scans = [syn.scan(f) for f in range(n)]
    ii = 0

    def keyframes():
        return pipe._host.kf_count if resident else pipe.store.count

    def feed(f):
        nonlocal ii
        while ii < len(imu) and imu[ii].stamp <= scans[f].end_time + 0.02:
            pipe.push_imu(imu[ii])
            ii += 1
        return pipe.process_scan(scans[f])

    for f in range(warm):
        feed(f)
    torch.cuda.synchronize()
    kf0 = keyframes()
    t0 = time.perf_counter()
    for f in range(warm, warm + traced):
        feed(f)
    torch.cuda.synchronize()
    untraced_wall_ms = (time.perf_counter() - t0) * 1e3
    kf1 = keyframes()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for f in range(warm + traced, n):
            feed(f)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    # device-side events only (kernels, copies): the CPU-side op rows carry
    # the same device time again
    rows = [
        (e.key, e.count, e.self_device_time_total / 1e3)
        for e in averages
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    rows = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])
    host = sorted(((e.key, e.count, e.self_cpu_time_total / 1e3) for e in averages
                   if e.device_type == torch.autograd.DeviceType.CPU), key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows)
    emit(
        "profile_resident" if resident else "profile",
        path="resident_path" if resident else "main_path", frames=traced,
        keyframes_in_window=keyframes() - kf1,
        traced_wall_ms=wall_ms, device_busy_ms=device_ms,
        untraced_frames=traced, untraced_wall_ms=untraced_wall_ms,
        keyframes_in_untraced_window=kf1 - kf0,
        device_busy_share=device_ms / untraced_wall_ms,
        device_launches=int(sum(r[1] for r in rows)),
        top=[dict(name=k[:80], calls=c, device_ms=ms) for k, c, ms in rows[:12]],
        top_host=[dict(name=k[:80], calls=c, self_ms=ms) for k, c, ms in host[:16]],
        host_self_ms=sum(r[2] for r in host),
        note="share = traced window's device time / wall time of the untraced window before it",
    )


REPAIR_FRAMES = 40
# one resident_path run in a subprocess, from the checkout it starts in
REPAIR_RUN = (
    "import hashlib, json, statistics, numpy as np, chip_smoke as cs; "
    "rp = cs.make_pipeline(cs.main_config()); "
    "_, ms = cs.run_pipeline(rp, cs.main_dataset({n}), {n}); "
    "t = np.ascontiguousarray(rp.trajectory_arrays()[1]); "
    "print(json.dumps(dict(ms_per_frame_p50=statistics.median(ms[1:]), "
    "ms_per_frame_mean=float(np.mean(ms[1:])), "
    "trajectory_sha=hashlib.sha256(t.tobytes()).hexdigest()[:16])))"
)


def phase_repair_cost(parent: str, turns=("parent", "this", "this", "parent")) -> None:
    """What the fixed-order reductions cost end to end: resident_path's
    frame time on the main course (REPAIR_FRAMES frames) in a checkout from
    before them (``--parent DIR``: ``git archive <commit> | tar -x -C DIR``)
    and in this one, in turns, each run a process of its own in its own
    checkout (and build directory). Not in the default run:
    ``--phases device,repair_cost --parent DIR``."""
    check(parent is not None and os.path.isfile(os.path.join(parent, "chip_smoke.py")),
          "repair_cost needs --parent DIR, a checkout from before the repair")
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k not in ("LIORF_TORCH_BUILD_DIR", "PYTHONPATH")}
    runs = []
    for turn in turns:
        root = os.path.abspath(parent) if turn == "parent" else here
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", REPAIR_RUN.format(n=REPAIR_FRAMES)], cwd=root,
                           env=env, capture_output=True, text=True, timeout=300)
        check(r.returncode == 0, f"repair_cost: the {turn} run exited {r.returncode}: {r.stderr[-2000:]}")
        runs.append(dict(checkout=turn, process_s=time.perf_counter() - t0,
                         **json.loads(r.stdout.strip().splitlines()[-1])))
    summary = {t: dict(median_p50=statistics.median(r["ms_per_frame_p50"] for r in runs
                                                    if r["checkout"] == t),
                       runs_equal=len({r["trajectory_sha"] for r in runs if r["checkout"] == t}) == 1)
               for t in dict.fromkeys(turns)}
    emit("repair_cost", nvidia_smi=nvidia_smi_line(), frames=REPAIR_FRAMES, turns=runs, **summary)


FIRST_FRAMES = 3  # frames (ticks) a fresh process runs in first_frames

# One fresh process's first frames on one path (argv: main, resident or
# multistream, and the frames), driven by its checkout's own chip_smoke.py:
# the imports', the construction's and each frame's time (host clock, the
# card synchronized around each), and where torch._dynamo, which a
# process's first torch.library custom-op call imports, came in.
FIRST_RUN = r"""
import json, sys, time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
import chip_smoke as cs
t2 = time.perf_counter()
path, n = sys.argv[1], int(sys.argv[2])
def dynamo(where):
    return where if "torch._dynamo" in sys.modules else None
at = dynamo("import")
if path == "multistream":
    from liorf_tpu_torch.pipeline.multistream import MultiStreamPipeline
    courses = [cs.course("multi", b) for b in range(max(cs.MULTI_LANES))]
    t3 = time.perf_counter()
    mp = MultiStreamPipeline(cs.multi_config(), n_streams=len(courses))
    ii = [0] * len(courses)
    def frame(f):
        scans = [c.scan(f) for c in courses]
        for b, c in enumerate(courses):
            ii[b] = cs.feed_imu(lambda s, b=b: mp.push_imu(b, s), scans[b], c.imu, ii[b])
        return lambda: mp.step(scans)
else:
    syn = cs.main_dataset(n)
    imu, ii = syn.imu_stream(), [0]
    t3 = time.perf_counter()
    pipe = (cs.LiorfPipeline if path == "main" else cs.make_pipeline)(cs.main_config())
    def frame(f):
        scan = syn.scan(f)
        ii[0] = cs.feed_imu(pipe.push_imu, scan, imu, ii[0])
        return lambda: pipe.process_scan(scan)
t4 = time.perf_counter()
at = at or dynamo("construction")
ms = []
for f in range(n):
    step = frame(f)
    torch.cuda.synchronize()
    a = time.perf_counter()
    step()
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - a) * 1e3)
    at = at or dynamo(f"frame {f}")
print(json.dumps(dict(torch_import_s=t1 - t0, package_import_s=t2 - t1, construction_s=t4 - t3,
                      frame_ms=ms, dynamo_imported_at=at)))
"""

# every kernel library of a checkout built at once, in a process of its own
FIRST_BUILD = ("import chip_smoke as cs; from concurrent.futures import ThreadPoolExecutor; "
               "ex = ThreadPoolExecutor(len(cs.KERNEL_MODULES)); "
               "[f.result() for f in [ex.submit(m.load_library) for m in cs.KERNEL_MODULES]]")


def phase_first_frames(parent: str | None,
                       turns=("parent", "this", "this", "parent")) -> None:
    """A fresh process's first FIRST_FRAMES frames on main_path's,
    resident_path's and multistream_path's (8 lanes) pipelines and courses,
    each run a process of its own in its own checkout (and build directory),
    in turns with the ``--parent DIR`` checkout's where one is given; every
    checkout's kernels built first, in a process of their own, so that no
    frame builds one. Fails if a frame of this checkout imports
    torch._dynamo. Not in the default run:
    ``--phases device,first_frames [--parent DIR]``."""
    roots = {"this": os.path.dirname(os.path.abspath(__file__))}
    if parent is None:
        turns = ("this", "this")
    else:
        check(os.path.isfile(os.path.join(parent, "chip_smoke.py")),
              f"first_frames: {parent} holds no chip_smoke.py")
        roots["parent"] = os.path.abspath(parent)
    env = {k: v for k, v in os.environ.items() if k not in ("LIORF_TORCH_BUILD_DIR", "PYTHONPATH")}

    def run(turn, *argv):
        r = subprocess.run([sys.executable, "-c", *argv], cwd=roots[turn], env=env,
                           capture_output=True, text=True, timeout=900)
        check(r.returncode == 0, f"first_frames: the {turn} run exited {r.returncode}: "
                                 f"{r.stderr[-2000:]}")
        return r.stdout

    build_s = {}
    for turn in roots:
        t0 = time.perf_counter()
        run(turn, FIRST_BUILD)
        build_s[turn] = time.perf_counter() - t0
    runs = []
    for path in ("main", "resident", "multistream"):
        for turn in turns:
            t0 = time.perf_counter()
            out = json.loads(run(turn, FIRST_RUN, path, str(FIRST_FRAMES)).strip().splitlines()[-1])
            runs.append(dict(path=path, checkout=turn, process_s=time.perf_counter() - t0, **out))
    emit("first_frames", nvidia_smi=nvidia_smi_line(), frames=FIRST_FRAMES, build_s=build_s,
         runs=runs, note="frame_ms: host clock around each frame (tick), the card synchronized; "
                         "frame 0 the bootstrap")
    for r in runs:
        if r["checkout"] == "this":
            check(r["dynamo_imported_at"] in ("import", "construction"),
                  f"first_frames: {r['path']}'s {r['dynamo_imported_at']} imported torch._dynamo")


EDGE_SLOTS = (256, 320, 384, 448, 512, 768, 1024, 1152, 1536, 2048, 4096)


def phase_edge_floor(keep: int = 200) -> None:
    """A factor's linearization bits against the batch around it (the
    batched products under jacfwd, which the kernel replaced, took other
    bits at 1536 and 2048 edge slots): one seeded graph of 4096 nodes
    linearized in EDGE_SLOTS edge slots, its first ``keep`` nodes' factors
    live and the rest masked; the classes of slot counts whose live
    Jacobians and node sums have the same bits (one class: capacity-free),
    and the call's time at each. Not in the default run:
    ``--phases device,edge_floor``."""
    graph = random_graph(4096, 3500, max(EDGE_SLOTS), 256, seed=11)
    free = graph.node_mask
    groups, ms = [], {}
    for E in EDGE_SLOTS:
        g = graph._replace(**{k: getattr(graph, k)[:E] for k in (
            "e_i", "e_j", "e_Rm", "e_tm", "e_sqrt_info", "e_cauchy", "e_mask")})
        g = g._replace(e_mask=g.e_mask & (torch.arange(E, device=DEV) < keep - 1))
        plan = pg._plan(g)
        rhs, diag, t = pg._build_normal_terms(g, free, plan)
        live = [rhs[:keep], diag[:keep], t.Ji[:keep - 1], t.Jj[:keep - 1]]
        for ref, sizes in groups:
            if all(torch.equal(a, b) for a, b in zip(live, ref)):
                sizes.append(E)
                break
        else:
            groups.append((live, [E]))
        ms[E] = cuda_ms(lambda: pg._build_normal_terms(g, free, plan), reps=10, batch=5)
    classes = [sizes for _, sizes in groups]
    emit("edge_floor", nvidia_smi=nvidia_smi_line(), nodes=4096, live_nodes=keep,
         edge_slots=list(EDGE_SLOTS), classes_equal_live_rows=classes,
         linearize_ms_by_edge_slots=ms)
    check(len(classes) == 1, f"a factor's bits moved with the edge slots: {classes}")


def phase_loop_path(n_frames: int = LOOP_PATH_FRAMES):
    """The repo's loop course (tests/test_loop_efficacy.py): a self-revisiting
    circle with a biased, noisy IMU; loop closure on."""
    cfg = loop_config()
    syn = loop_dataset(n_frames)
    pipe = LiorfPipeline(cfg)
    reset_counts()
    results, frame_ms = run_pipeline(pipe, syn, n_frames)
    counts = launch_counts()
    _, poses = pipe.trajectory_arrays()
    _, gt = syn.ground_truth()
    loop_edges = [e for e in pipe.edges if e["j"] - e["i"] != 1]
    pending = len(pipe.pending_loops)
    ate = ate_rmse(poses[:, 3:6].astype(np.float64), gt[:n_frames])
    emit(
        "loop_path", frames=n_frames, keyframes=pipe.store.count,
        loop_factors_in_graph=len(loop_edges), loop_factors_pending=pending,
        loop_pairs=sorted(pipe.loop_detector.loop_index_container.items()),
        k1_launches=counts["knn_grid_topk"], k2_launches=counts["knn_bruteforce"],
        ate_rmse_m=ate, ms_per_frame_p50=percentile(frame_ms[1:], 50),
        ms_per_frame_p99=percentile(frame_ms[1:], 99),
    )
    check(bool(np.isfinite(poses).all()), "loop trajectory not finite")
    check(len(loop_edges) + pending >= 1, "no loop factor landed")
    check(counts["knn_bruteforce"] > 0, "K2 never launched on the loop path")
    check(counts["knn_grid_topk"] == sum(r.gn_iters for r in results), "K1 count != GN iterations")
    return counts


# ---------------------------------------------------------------------------
# phases: resident_path, resident_loop_path, cli
# ---------------------------------------------------------------------------

def clone_state(st):
    """A copy of a (nested) NamedTuple of tensors: the resident step updates
    its state in place."""
    return type(st)(*(clone_state(x) if isinstance(x, tuple) else x.clone() for x in st))


def resident_report(rp, counts, frame_ms, n_frames) -> dict:
    """What a resident run read from the device, per frame by kind. The
    pipeline counts its own branch reads; the scan matcher reads one `done`
    per GN iteration, the ICP one per iteration (every K2 launch but each
    run's last, final correspondence pass)."""
    steps = n_frames - 1  # frame 0 is the bootstrap
    gn = rp.gn_iters_total()
    reads = rp.host_reads()
    per_frame = {k: v / steps for k, v in reads.items()}
    per_frame["scan_to_map done (per GN iteration)"] = gn / steps
    per_frame["icp_point2point delta (per ICP iteration)"] = (
        counts["knn_bruteforce"] - rp.tally["icp_runs"]
    ) / steps
    st = rp.state
    return dict(
        frames=n_frames, keyframes=int(st.kf_count), loop_factors=int(st.l_count),
        gps_factors=int(st.g_count), gn_iters_total=gn,
        k1_launches=counts["knn_grid_topk"], k2_launches=counts["knn_bruteforce"],
        icp_runs=rp.tally["icp_runs"], host_reads_total=reads,
        host_reads_per_frame=per_frame,
        host_reads_per_frame_sum=float(sum(per_frame.values())),
        growth_events=rp.growth_events,
        ms_per_frame_p50=percentile(frame_ms[1:], 50),
        ms_per_frame_p99=percentile(frame_ms[1:], 99),
        ms_per_frame_mean=float(np.mean(frame_ms[1:])),
    )


def phase_resident_path(main_poses: np.ndarray, n_frames: int = MAIN_FRAMES):
    """The device-resident pipeline (make_pipeline, the JAX package's main
    path) on the main path's course and streams. Keeps pre-step snapshots
    of its last frames for the split phase."""
    rp = make_pipeline(main_config())  # device=None: the card
    check(rp.device.type == "cuda", "make_pipeline must default to the GPU")
    snaps = []
    dispatch = rp._dispatch_step

    def capture(buf, S, W):
        snap = None
        if rp.frame_idx >= n_frames - 8:
            snap = dict(state=clone_state(rp.state), host=rp._host, buf=buf)
        dispatch(buf, S, W)
        if snap is not None:
            snap["is_kf"] = rp._host.kf_count > snap["host"].kf_count
            snaps.append(snap)

    rp._dispatch_step = capture
    syn = main_dataset(n_frames)
    reset_counts()
    log = FrameLog(rp)
    try:
        _, frame_ms = run_pipeline(rp, syn, n_frames, log)
    finally:
        log.close()
    counts = launch_counts()
    rp._dispatch_step = dispatch

    _, poses = rp.trajectory_arrays()
    _, gt = syn.ground_truth()
    check(poses.shape == (n_frames, 6), f"resident trajectory shape {poses.shape}")
    check(bool(np.isfinite(poses).all()), "resident trajectory not finite")
    ate = ate_rmse(poses[:, 3:6].astype(np.float64), gt[:n_frames])
    dist = np.linalg.norm(poses[:, 3:6] - main_poses[:, 3:6], axis=1)
    rep = resident_report(rp, counts, frame_ms, n_frames)
    emit(
        "resident_path", points_per_scan=32 * 900, ate_rmse_m=ate,
        max_dist_to_main_path_m=float(dist.max()), **rep,
        slowest_frames=slowest_frames(frame_ms, log.kinds),
        note="snapshots of the last 8 frames' states are taken inside their timed window",
    )
    check(ate < 0.3, f"resident ATE {ate} m >= 0.3 m")
    check(rep["keyframes"] >= 2, "fewer than 2 keyframes")
    check(counts["knn_grid_topk"] > 0, "K1 never launched on the resident path")
    check(
        counts["knn_grid_topk"] == rep["gn_iters_total"],
        f"K1 launches {counts['knn_grid_topk']} != GN iterations {rep['gn_iters_total']}",
    )
    check(float(dist.max()) < 0.15, f"resident path {dist.max()} m from main_path's trajectory")
    # the descriptor only at keyframes (the bootstrap's included), the deskew every frame
    check(counts["make_descriptor"] == rep["keyframes"] and counts["deskew"] == n_frames,
          f"{counts['make_descriptor']} descriptor launches for {rep['keyframes']} keyframes, "
          f"{counts['deskew']} deskew launches in {n_frames} frames")
    return (rp, snaps), counts


def resident_stages(rp, snaps):
    """The resident step's stages at the main path's shapes, each on a copy
    of a pre-step state (the copy, ~0.13 GB on the card, is inside the
    timed call)."""
    S, W = rp.cfg.raw_cap, rp.cfg.imu_window
    kf = [s for s in snaps if s["is_kf"]]
    non_kf = [s for s in snaps if not s["is_kf"]]
    check(kf and non_kf, "the resident path's last frames need a keyframe and a non-keyframe")

    def step(snap):
        return lambda: tres.resident_step_packed(
            clone_state(snap["state"]), snap["host"], snap["buf"], rp.params, S, W, Counter()
        )

    st = rp.state
    k = st.kf_count - 1
    now = tres._at(st.kf_times, k)
    z = torch.zeros((), device=DEV)
    tally = Counter()
    tres._try_loop_closure(clone_state(st), rp.params, k, now, True, False, z, z, tally)
    K, L = st.kf_poses.shape[0], st.l_i.shape[0]
    stages = {
        "resident_step, non-keyframe frame (state copy included)": step(non_kf[-1]),
        "resident_step, keyframe frame (state copy included)": step(kf[-1]),
        "_try_loop_closure on the final kf ring (search + submaps + gate)": lambda: tres._try_loop_closure(
            clone_state(st), rp.params, k, now, True, False, z, z, Counter()),
        f"resident pose graph solve (window, {K}+{L} slots)": lambda: tres._solve_graph_resident(st, rp.params, False),
        f"resident pose graph solve (full, {K}+{L} slots)": lambda: tres._solve_graph_resident(st, rp.params, True),
    }
    notes = dict(resident_loop_closure_ran_icp=tally["icp_runs"] > 0,
                 resident_kf_slots=K, resident_loop_slots=L)
    return stages, notes


# The host syncs of resident_loop_path: none may come from the scan
# matcher's or ICP's arithmetic (their kernels run without a library solver),
# from the IMU preintegration, the deskew or the descriptor (one kernel
# each, no read) or from a host value
# uploaded at a grid build or a keyframe; each loop may
# read its one "all done" flag an iteration. What is left (~10 a frame:
# those flags, is_kf, the loop gate and full-solve flags) stays under
# MAX_SYNCS_PER_FRAME.
NO_SYNC_FILES = ("ops/plane_fit.py", "ops/scan_gn.py", "ops/icp_align.py", "ops/knn.py",
                 "graph/marginal.py", "ops/preintegrate.py", "imu/preintegration.py",
                 "ops/deskew.py", "ops/scancontext.py")
FLAG_READ = "if bool(all_done):"
MAX_SYNCS_PER_FRAME = 12


def allowed_sync(site: str) -> bool:
    path, line = site.rsplit(":", 1)
    if path.endswith(NO_SYNC_FILES):
        return False
    if path.endswith(("ops/scan_match.py", "ops/icp.py")):
        with open(path) as f:
            return FLAG_READ in f.read().splitlines()[int(line) - 1]
    return True


def phase_resident_loop_path(n_frames: int = LOOP_FRAMES):
    """The loop course of loop_path through make_pipeline. Run with CUDA's
    sync debug mode on, which warns at every point where the host waits for
    the device (reads and blocking copies alike): their count per frame is
    reported, so this path's frame times are not comparable."""
    rp = make_pipeline(loop_config())
    syn = loop_dataset(n_frames)
    reset_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, frame_ms = run_pipeline(rp, syn, n_frames)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    counts = launch_counts()
    sync_sites = Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}"
        for w in caught if "synchroniz" in str(w.message).lower()
    )
    syncs = sum(sync_sites.values())
    _, poses = rp.trajectory_arrays()
    _, gt = syn.ground_truth()
    ate = ate_rmse(poses[:, 3:6].astype(np.float64), gt[:n_frames])
    rep = resident_report(rp, counts, frame_ms, n_frames)
    emit(
        "resident_loop_path", ate_rmse_m=ate, host_syncs_per_frame=syncs / (n_frames - 1),
        host_sync_sites_top=[[site, n] for site, n in sync_sites.most_common(12)],
        loop_pairs=[[int(i), int(j)] for i, j in zip(
            rp.state.l_i[: rep["loop_factors"]].tolist(), rp.state.l_j[: rep["loop_factors"]].tolist())],
        **rep, note="frame times taken with the sync debug mode on",
    )
    check(bool(np.isfinite(poses).all()), "resident loop trajectory not finite")
    waits = [site for site in sync_sites if not allowed_sync(site)]
    check(not waits, f"the host waits for the card where it may not: {waits}")
    check(syncs / (n_frames - 1) <= MAX_SYNCS_PER_FRAME,
          f"{syncs / (n_frames - 1)} host syncs a frame (at most {MAX_SYNCS_PER_FRAME})")
    check(rep["loop_factors"] >= 1, "no loop factor landed on the resident loop path")
    check(counts["knn_bruteforce"] > 0, "K2 never launched on the resident loop path")
    check(counts["knn_grid_topk"] == rep["gn_iters_total"], "K1 count != GN iterations")
    return counts, resident_run(rp)


def resident_run(rp) -> dict:
    """What two runs of one stream are compared on: the trajectory, the
    keyframe poses and the loop factors (one read each)."""
    st = rp.state
    kf, nl = int(st.kf_count), int(st.l_count)
    return dict(traj=rp.trajectory_arrays()[1], kf_poses=st.kf_poses[:kf].cpu().numpy(),
                loops=torch.stack([st.l_i[:nl], st.l_j[:nl]], 1).cpu().numpy(),
                is_kf=[r.is_keyframe for r in rp.trajectory])


# ---------------------------------------------------------------------------
# phase: multistream_path
# ---------------------------------------------------------------------------

# cut from 60 (and then 32) ticks, and the loop course from 64, to keep the
# whole run well inside its time limit on a slow host
MULTI_TICKS = 20
MULTI_WARM = 12  # ticks before the rate chunks (bench.py's method)
MULTI_CHUNK = 8
MULTI_LOOP_TICKS = 32  # through the first loop closures (frame ~26)
MULTI_LANES = (1, 4, 8)
MULTI_PARITY_LANES = 4
# Every lane at N = 4 against a single-session run of its stream, both in
# the default mode (the voxel filter's and the pose graph's scatter-adds are
# fixed-order segment sums, so one session repeats bit for bit; before them
# this parity needed torch.use_deterministic_algorithms). What is left is
# the batched products' and solves' own rounding. One tick from the single
# sessions' carried states shows it before it compounds: each lane's new
# trajectory row and keyframe poses within MULTI_STEP_M (m, rad) of the
# single step's, flags equal. Over
# the frames of scan matching it compounds on the ill-conditioned courses, so
# whole trajectories are held to the bound tests/test_resident.py:87 puts
# between two pipelines on the same streams (as resident_path is to
# main_path), keyframe indices and loop factors equal, ATE within
# MULTI_PARITY_ATE_M.
MULTI_STEP_M = 1e-5
MULTI_STEP_EVERY = 3  # frames between the carried states stepped batched
MULTI_PARITY_M = 0.15
MULTI_PARITY_ATE_M = 0.01


def multi_config() -> SlamConfig:
    return SlamConfig(
        **MULTI_CAPS, mappingSurfLeafSize=0.3, surroundingKeyframeMapLeafSize=0.3,
        loopClosureEnableFlag=True, kf_capacity=128, traj_capacity=128,
        gps_capacity=16, loop_capacity=16,
    )


def multi_stream(lane: int):
    """Lane ``lane``'s own stream (16 rings x 720 points, course_synthetic):
    scans and IMU, with the generator's ground truth."""
    c = course("multi", lane)
    return [c.scan(f) for f in range(MULTI_TICKS)], c.imu, c.gt[1]


def feed_imu(push, scan, imu, at: int) -> int:
    while at < len(imu) and imu[at].stamp <= scan.end_time + 0.02:
        push(imu[at])
        at += 1
    return at


def multistream_step_parity(rp, carried) -> list[dict]:
    """One batched tick (resident_step_packed_lanes) from the lanes' carried
    pre-step states at each captured frame, against each single session's
    own step on the same state and frame: per lane the largest difference of
    the new trajectory row and of the keyframe poses (m, rad; read once), and
    whether the host views (keyframe count, loop latch) agree."""
    S, W = rp.cfg.raw_cap, rp.cfg.imu_window
    frames = sorted(set(carried[0]).intersection(*carried[1:]))
    check(len(frames) >= 5, f"carried states at frames {frames} only")
    diff = torch.zeros(len(carried), device=DEV)
    flags = [True] * len(carried)
    for f in frames:
        pre = [c[f] for c in carried]
        out, hosts, _ = tres.resident_step_packed_lanes(
            tres.stack_states([c["state"] for c in pre]), [c["host"] for c in pre],
            np.stack([c["buf"] for c in pre]), rp.params, S, W, Counter())
        for b, c in enumerate(pre):
            one = tres.lane_state(out, b)
            d = torch.maximum((one.traj[:, :6] - c["traj_after"]).abs().max(),
                              (one.kf_poses - c["kf_after"]).abs().max())
            diff[b] = torch.maximum(diff[b], d)
            flags[b] = flags[b] and hosts[b] == c["host_after"]
        del out
    return [dict(one_tick_frames=frames, one_tick_max_abs_diff=float(x), one_tick_flags_equal=fl)
            for x, fl in zip(diff.tolist(), flags)]


def phase_multistream_path() -> dict:
    """MultiStreamPipeline at the repo's multistream operating point
    (bench.py:303-315, scripts/bench_multistream.py:39-55) for N = 1, 4, 8
    distinct streams, MULTI_TICKS ticks each: aggregate scans/s (median over 8-tick
    chunks after 12 warm ticks), scaling efficiency against N = 1 of this
    run, tick p50/p99, host reads and K1/K2 launches per tick (each tick's
    K1 launches = its slowest lane's GN iterations). Every lane at N = 4
    is held to a single-session ResidentPipeline run on its stream, both
    in the default mode: one tick from carried states within
    MULTI_STEP_M (m, rad); over the stream keyframe flags and loop factors
    equal, poses within MULTI_PARITY_M, ATE within MULTI_PARITY_ATE_M of
    the single run. Then N = 4 on the loop course
    (multistream_loop_course)."""
    from liorf_tpu_torch.pipeline.multistream import MultiStreamPipeline

    cfg = multi_config()
    t0 = time.perf_counter()
    streams = [multi_stream(b) for b in range(max(MULTI_LANES))]
    gen_s = time.perf_counter() - t0

    def single(b, carried=None):
        """Lane b's stream through ResidentPipeline: (pipeline, ms a frame).
        With ``carried`` (a dict), every MULTI_STEP_EVERY-th step's pre-step
        state, host view and frame buffer, and its results, go into it by
        frame index."""
        rp = make_pipeline(cfg)
        dispatch = rp._dispatch_step

        def capture(buf, S, W):
            if rp.frame_idx % MULTI_STEP_EVERY:
                return dispatch(buf, S, W)
            c = dict(state=clone_state(rp.state), host=rp._host, buf=buf)
            dispatch(buf, S, W)
            c.update(host_after=rp._host, traj_after=rp.state.traj[:, :6].clone(),
                     kf_after=rp.state.kf_poses.clone())
            carried[rp.frame_idx] = c

        if carried is not None:
            rp._dispatch_step = capture
        scans, imu, _ = streams[b]
        ii, ms = 0, []
        for scan in scans:
            ii = feed_imu(rp.push_imu, scan, imu, ii)
            torch.cuda.synchronize()
            a = time.perf_counter()
            rp.process_scan(scan)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - a) * 1e3)
        rp.finish()
        return rp, ms

    def multi(n, captured=None):
        """n lanes through MultiStreamPipeline: tick ms, K1 launches per tick
        and each tick's per-lane GN iterations (kept on the device, read
        once at the end). With ``captured`` (a dict), the arguments of the
        run's last n-lane launches of each kind go into it
        (capture_kernel_args)."""
        mp = MultiStreamPipeline(cfg, n_streams=n)
        check(mp.device.type == "cuda", "MultiStreamPipeline must default to the GPU")
        iis = [0] * n
        tick_ms, k1_tick, gn_tick, fus_tick, pre_tick = [], [], [], [], []
        dsk_tick, sc_tick = [], []
        reset_counts()
        for f in range(MULTI_TICKS):
            scans = [streams[b][0][f] for b in range(n)]
            for b in range(n):
                iis[b] = feed_imu(lambda s, b=b: mp.push_imu(b, s), scans[b], streams[b][1], iis[b])
            k1, fus = launch_counts()["knn_grid_topk"], fstep.fusion_step.launches
            pre = tpop.preintegrate.launches
            dsk, sc = tdsk.deskew.launches, tsc.make_descriptor.launches
            torch.cuda.synchronize()
            a = time.perf_counter()
            if captured is None:
                mp.step(scans)
            else:
                with capture_kernel_args(captured, n):
                    mp.step(scans)
            torch.cuda.synchronize()
            tick_ms.append((time.perf_counter() - a) * 1e3)
            k1_tick.append(launch_counts()["knn_grid_topk"] - k1)
            fus_tick.append(fstep.fusion_step.launches - fus)
            pre_tick.append(tpop.preintegrate.launches - pre)
            dsk_tick.append(tdsk.deskew.launches - dsk)
            sc_tick.append(tsc.make_descriptor.launches - sc)
            gn_tick.append(mp.last_gn_iters)
        counts = launch_counts()
        mp.finish()
        return mp, counts, tick_ms, k1_tick, gn_tick, fus_tick, pre_tick, dsk_tick, sc_tick

    def lane_report(mp, n):
        ates, kf_counts, loops = [], [], []
        for b in range(n):
            shell = mp.stream(b)
            _, poses = shell.trajectory_arrays()
            check(poses.shape == (MULTI_TICKS, 6) and bool(np.isfinite(poses).all()),
                  f"N={n} lane {b}: trajectory {poses.shape} not finite")
            ates.append(ate_rmse(poses[:, 3:6].astype(np.float64), streams[b][2][:MULTI_TICKS]))
            kf_counts.append(int(shell.state.kf_count))
            loops.append(int(shell.state.l_count))
        return ates, kf_counts, loops

    # Parity: each lane's stream through ResidentPipeline and single ticks of
    # the four lanes from their carried states; the four lanes batched over
    # the whole stream are the timed N = 4 run below (both in the default
    # mode, so a run repeats).
    carried = [{} for _ in range(MULTI_PARITY_LANES)]
    singles, single_ms = [], None
    for b in range(MULTI_PARITY_LANES):
        rp, ms = single(b, carried[b])
        singles.append(rp)
        if single_ms is None:
            # lane 0's single-session frame times, but the bootstrap and the
            # frames whose state was copied inside the timed call
            single_ms = [m for f, m in enumerate(ms) if f > 0 and f not in carried[b]]
    step_parity = multistream_step_parity(singles[0], carried)
    del carried

    # Timing: N = 1, 4, 8 lanes.
    out, per_n, lane_cases, mp_det = {}, {}, {}, None
    for n in MULTI_LANES:
        mp, counts, tick_ms, k1_tick, gn_tick, fus_tick, pre_tick, dsk_tick, sc_tick = multi(
            n, lane_cases if n == max(MULTI_LANES) else None)
        ticks = mp.ticks
        # per tick: the batched GN loop runs until its slowest lane stops,
        # one K1 launch per iteration (the bootstrap tick runs no GN)
        gn = torch.stack(gn_tick[1:]).cpu().numpy()  # [ticks, n], one read
        k1_vs_max = [int(k) - int(g) for k, g in zip(k1_tick[1:], gn.max(axis=1))]
        chunks = [
            n * MULTI_CHUNK / (sum(tick_ms[i:i + MULTI_CHUNK]) / 1e3)
            for i in range(MULTI_WARM, MULTI_TICKS - MULTI_CHUNK + 1, MULTI_CHUNK)
        ]
        gn_batched = mp.gn_iters_batched()
        reads = {k: v / ticks for k, v in mp.host_reads().items()}
        reads["scan_to_map all-done (per batched GN iteration)"] = gn_batched / ticks
        reads["icp all-done (per batched ICP iteration)"] = (
            counts["knn_bruteforce"] - mp.tally["icp_runs"]) / ticks
        ates, kf_counts, loops = lane_report(mp, n)
        per_n[n] = dict(
            lanes=n, ticks=ticks, scans_per_sec=statistics.median(chunks),
            tick_ms_p50=percentile(tick_ms[1:], 50), tick_ms_p99=percentile(tick_ms[1:], 99),
            tick_ms_mean=float(np.mean(tick_ms[1:])),
            k1_launches=counts["knn_grid_topk"], k2_launches=counts["knn_bruteforce"],
            k1_per_tick=counts["knn_grid_topk"] / ticks, k2_per_tick=counts["knn_bruteforce"] / ticks,
            k1_bootstrap_tick=k1_tick[0], k1_ticks_off_slowest_lane=sum(x != 0 for x in k1_vs_max),
            fusion_launches_per_tick_max=max(fus_tick),
            preintegrate_launches_per_tick_max=max(pre_tick),
            # the bootstrap tick: each lane bootstraps alone (one deskew and
            # one descriptor a lane); every later tick's lanes are one launch
            deskew_launches_bootstrap_tick=dsk_tick[0],
            descriptor_launches_bootstrap_tick=sc_tick[0],
            deskew_launches_per_tick_max=max(dsk_tick[1:]),
            descriptor_launches_per_tick_max=max(sc_tick[1:]),
            descriptor_ticks=sum(x > 0 for x in sc_tick[1:]),
            gn_iters_batched=gn_batched, gn_iters_per_lane=mp.gn_iters_per_lane(),
            gn_iters_slowest_lane_per_tick=float(gn.max(axis=1).mean()),
            gn_iters_lane_mean_per_tick=float(gn.mean()),
            icp_runs=mp.tally["icp_runs"], icp_lanes=mp.tally["icp_lanes"],
            host_reads_per_tick=reads, ate_rmse_m=ates, keyframes=kf_counts, loop_factors=loops,
            growth_events=mp.growth_events,
        )
        out[f"n{n}"] = counts
        if n == MULTI_PARITY_LANES:
            mp_det = mp
        del mp
    parity = []
    for b, rp in enumerate(singles):
        shell = mp_det.stream(b)
        d = np.abs(shell.trajectory_arrays()[1] - rp.trajectory_arrays()[1]).max(axis=1)
        kf_m = [i for i, r in enumerate(shell.trajectory) if r.is_keyframe]
        kf_s = [i for i, r in enumerate(rp.trajectory) if r.is_keyframe]
        over = np.flatnonzero(d > 1e-4)
        parity.append(dict(
            lane=b, max_abs_pose_diff=float(d.max()),
            diff_every_5th_frame=[float(x) for x in d[::5]],
            first_frame_over_1e4=int(over[0]) if len(over) else None,
            keyframes_equal=kf_m == kf_s,
            loop_factors=[int(shell.state.l_count), int(rp.state.l_count)],
            ate_single_m=ate_rmse(rp.trajectory_arrays()[1][:, 3:6].astype(np.float64),
                                  streams[b][2][:MULTI_TICKS]),
            ate_lane_m=per_n[MULTI_PARITY_LANES]["ate_rmse_m"][b], **step_parity[b]))
    del singles, mp_det
    base = per_n[MULTI_LANES[0]]["scans_per_sec"]
    for n, row in per_n.items():
        row["scaling_efficiency"] = row["scans_per_sec"] / (n * base)
    k1_1, k1_8 = per_n[1]["k1_per_tick"], per_n[max(MULTI_LANES)]["k1_per_tick"]
    emit("multistream_path", nvidia_smi=nvidia_smi_line(), points_per_scan=16 * 720,
         stream_generation_s=gen_s, parity_bound=MULTI_PARITY_M, one_tick_bound=MULTI_STEP_M,
         parity_ate_bound=MULTI_PARITY_ATE_M, vs_single_session_n4=parity,
         single_session_frames_timed=len(single_ms),
         single_session_ms_per_frame_p50=percentile(single_ms, 50),
         single_session_scans_per_sec=1e3 / percentile(single_ms, 50),
         runs=[per_n[n] for n in MULTI_LANES], k1_per_tick_ratio_8_to_1=k1_8 / k1_1)
    icp_cases = {}
    out["loop_n4"] = multistream_loop_course(MULTI_PARITY_LANES, icp_cases)
    # the lane-folded launches of the widest run, held as the main path's are
    pcg_lanes = phase_pcg(pcg_cases(lane_cases), f"multistream_path_{max(MULTI_LANES)}")
    lin_lanes = phase_linearize(linearize_case(lane_cases), f"multistream_path_{max(MULTI_LANES)}")
    fus_lanes = phase_fusion(fusion_case(lane_cases), f"multistream_path_{max(MULTI_LANES)}")
    pre_lanes = phase_preintegrate(preintegrate_case(lane_cases),
                                   f"multistream_path_{max(MULTI_LANES)}")
    front_tick = dict(deskew=lane_cases["deskew"])
    dsk_lanes = phase_deskew(front_case(lane_cases, "deskew"), f"multistream_path_{max(MULTI_LANES)}")
    # the descriptor runs at a tick with a keyframe in any lane; without one
    # in the run, seeded clouds of as many lanes
    sc_args = lane_cases.pop("make_descriptor", None)
    front_tick["make_descriptor"] = sc_args
    sc_lanes = phase_descriptor(
        sc_args or seeded_clouds(max(MULTI_LANES)),
        f"multistream_path_{max(MULTI_LANES)}" if sc_args
        else f"seeded {max(MULTI_LANES)} lanes (no {max(MULTI_LANES)}-lane keyframe tick)")
    vr_lanes = phase_voxel_filter(lane_cases, max(MULTI_LANES))
    sg_lanes = phase_scan_gn(lane_cases, f"multistream_path_{max(MULTI_LANES)}")
    ia_lanes = phase_icp_align(icp_cases, f"multistream_loop_course_{MULTI_PARITY_LANES}")
    del lane_cases, icp_cases
    # the checks after the lines, so a failing run still shows its numbers
    for p in parity:
        check(p["one_tick_flags_equal"], f"lane {p['lane']}: a tick's flags differ from the single step's")
        check(p["one_tick_max_abs_diff"] < MULTI_STEP_M,
              f"lane {p['lane']}: one tick {p['one_tick_max_abs_diff']} from the single step's "
              f"(bound {MULTI_STEP_M})")
        check(p["keyframes_equal"], f"lane {p['lane']}: keyframe indices differ from its single run")
        check(p["loop_factors"][0] == p["loop_factors"][1],
              f"lane {p['lane']}: loop factors differ from its single run")
        check(p["max_abs_pose_diff"] < MULTI_PARITY_M,
              f"lane {p['lane']}: {p['max_abs_pose_diff']} from its single-session run "
              f"(bound {MULTI_PARITY_M})")
        check(abs(p["ate_lane_m"] - p["ate_single_m"]) < MULTI_PARITY_ATE_M,
              f"lane {p['lane']}: ATE {p['ate_lane_m']} against {p['ate_single_m']} alone")
    for n, row in per_n.items():
        check(row["k1_launches"] == row["gn_iters_batched"],
              f"N={n}: K1 launches {row['k1_launches']} != batched GN iterations")
        check(row["k1_bootstrap_tick"] == 0 and row["k1_ticks_off_slowest_lane"] == 0,
              f"N={n}: K1 launches of {row['k1_ticks_off_slowest_lane']} ticks differ from the "
              "slowest lane's GN iterations of that tick")
        check(max(row["ate_rmse_m"]) < 0.3, f"N={n}: ATE {max(row['ate_rmse_m'])} m >= 0.3 m")
        # the fusion step: at most one launch a tick, every lane in it
        check(row["fusion_launches_per_tick_max"] <= 1,
              f"N={n}: {row['fusion_launches_per_tick_max']} fusion launches in one tick")
        # the preintegration: at most one launch a tick, every lane in it
        check(row["preintegrate_launches_per_tick_max"] <= 1,
              f"N={n}: {row['preintegrate_launches_per_tick_max']} preintegrate launches in one "
              "tick")
        # the deskew and the descriptor: at most one launch a tick after the
        # bootstrap, every lane in it; the bootstrap one a lane
        for k in ("deskew", "descriptor"):
            check(row[f"{k}_launches_per_tick_max"] <= 1 and row[f"{k}_launches_bootstrap_tick"] == n,
                  f"N={n}: {row[f'{k}_launches_per_tick_max']} {k} launches in one tick, "
                  f"{row[f'{k}_launches_bootstrap_tick']} in the bootstrap tick")
    return (out, vr_lanes, pcg_lanes, lin_lanes, fus_lanes, sg_lanes, ia_lanes, pre_lanes,
            dsk_lanes, sc_lanes, front_tick)


def multistream_loop_course(n: int, captured: dict) -> dict:
    """N sessions on the loop course (loop_path's configuration and
    course, each lane its own seed): the batched loop branch, its gate read
    and the batched ICP (one K2 launch per iteration for the lanes whose
    gate is open) on the card. At the multistream operating point no loop
    search finds a candidate within 60 ticks (30 s time gap). The widest
    ICP alignment launch of the run goes into ``captured``."""
    from liorf_tpu_torch.pipeline.multistream import MultiStreamPipeline

    cfg = loop_config()
    syns = []
    for b in range(n):
        syn = CoursePrefix(course("loop", b), MULTI_LOOP_TICKS)
        syns.append(([syn.scan(f) for f in range(MULTI_LOOP_TICKS)], syn.imu_stream(),
                     syn.ground_truth()[1]))
    mp = MultiStreamPipeline(cfg, n_streams=n)
    iis = [0] * n
    reset_counts()
    t0 = time.perf_counter()
    for f in range(MULTI_LOOP_TICKS):
        scans = [syns[b][0][f] for b in range(n)]
        for b in range(n):
            iis[b] = feed_imu(lambda s, b=b: mp.push_imu(b, s), scans[b], syns[b][1], iis[b])
        with capture_kernel_args(captured, None):
            mp.step(scans)
    mp.finish()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    loops, ates = [], []
    for b in range(n):
        shell = mp.stream(b)
        _, poses = shell.trajectory_arrays()
        check(bool(np.isfinite(poses).all()), f"loop course lane {b}: trajectory not finite")
        ates.append(ate_rmse(poses[:, 3:6].astype(np.float64), syns[b][2]))
        loops.append(int(shell.state.l_count))
    emit("multistream_loop_course", lanes=n, ticks=mp.ticks, wall_s=wall,
         k1_launches=counts["knn_grid_topk"], k2_launches=counts["knn_bruteforce"],
         gn_iters_batched=mp.gn_iters_batched(), icp_runs=mp.tally["icp_runs"],
         icp_lanes=mp.tally["icp_lanes"], loop_factors=loops, ate_rmse_m=ates,
         host_reads_per_tick={k: v / mp.ticks for k, v in mp.host_reads().items()})
    check(counts["knn_grid_topk"] == mp.gn_iters_batched(), "loop course: K1 != batched GN iterations")
    check(counts["knn_bruteforce"] > 0, "K2 never launched on the multistream loop course")
    check(sum(loops) >= 1, "no loop factor landed on the multistream loop course")
    return counts


def phase_cli(frames: int = 20, resume_frames: int = 10) -> None:
    """``python -m liorf_tpu_torch.cli run`` on the card (its default
    device), then a second run that resumes from the first one's
    checkpoint; the files and the closing JSON line are checked."""
    from liorf_tpu_torch.utils.pcdio import load_pcd

    root = os.path.dirname(os.path.abspath(__file__))

    def cli(*args):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "liorf_tpu_torch.cli", "run", "--dataset", "synthetic", *args],
            cwd=root, capture_output=True, text=True, timeout=600,
        )
        check(r.returncode == 0, f"cli run {args} exited {r.returncode}: {r.stderr[-2000:]}")
        line = json.loads(r.stdout.strip().splitlines()[-1])
        check(set(line) == {"frames", "keyframes", "scans_per_sec", "out"}, f"cli line {line}")
        # which scan packer the resident pipeline used (its stderr report)
        packer = [json.loads(x)["packer"] for x in r.stderr.splitlines() if x.startswith('{"packer"')]
        check(len(packer) == 1, f"cli run printed no packer report: {r.stderr[-2000:]}")
        line["packer"] = packer[0]
        return line, time.perf_counter() - t0, r.stderr

    with tempfile.TemporaryDirectory(prefix="liorf_cli_") as tmp:
        a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        first, t_first, err = cli("--frames", str(frames), "--out", a, "--save-map", "--checkpoint",
                                  "--imu-tum", "--viz")
        check(first["frames"] == frames and first["keyframes"] >= 2 and first["out"] == a, f"cli line {first}")
        # every step frame (all but the bootstrap) packed by the native g++ packer
        check(first["packer"] == {"native": frames - 1}, f"cli run packer {first['packer']}")
        names = ("trajectory_tum.txt", "imu_rate_tum.txt", "checkpoint.pkl", "trajectory.pcd",
                 "transformations.pcd", "SurfMap.pcd", "GlobalMap.pcd", "trajectory.ply", "map.ply")
        missing = [n for n in names if not os.path.exists(os.path.join(a, n))]
        check(not missing, f"cli run wrote no {missing}")
        tum = np.loadtxt(os.path.join(a, "trajectory_tum.txt"))
        imu_tum = np.loadtxt(os.path.join(a, "imu_rate_tum.txt"))
        gmap = load_pcd(os.path.join(a, "GlobalMap.pcd"))
        kf_pcd = load_pcd(os.path.join(a, "trajectory.pcd"))
        check(tum.shape == (frames, 8) and bool(np.isfinite(tum).all()), f"trajectory_tum {tum.shape}")
        check(len(imu_tum) > frames and len(gmap["x"]) > 100, "imu_rate_tum / GlobalMap too small")
        check(len(kf_pcd["x"]) == first["keyframes"], "trajectory.pcd != keyframes")
        # --viz: one PLY vertex a keyframe, and the map.ply of every keyframe
        # cloud (GlobalMap.pcd at resolution 0 holds the same points)
        ply = {n: ply_vertices(os.path.join(a, f"{n}.ply")) for n in ("trajectory", "map")}
        check(ply["trajectory"] == first["keyframes"], f"trajectory.ply {ply['trajectory']} vertices")
        check(ply["map"] == len(gmap["x"]), f"map.ply {ply['map']} vertices, GlobalMap {len(gmap['x'])}")
        try:
            import matplotlib  # noqa: F401
            png = os.path.getsize(os.path.join(a, "overview.png"))
            check(png > 10_000, f"overview.png {png} bytes")
        except ImportError:
            png = None
            check("overview.png not drawn" in err, "cli run --viz: no word on the missing PNG")

        second, t_second, _ = cli("--frames", str(resume_frames), "--out", b,
                               "--resume", os.path.join(a, "checkpoint.pkl"))
        tum2 = np.loadtxt(os.path.join(b, "trajectory_tum.txt"))
        check(tum2.shape == (frames + resume_frames, 8) and bool(np.isfinite(tum2).all()),
              f"resumed trajectory_tum {tum2.shape}")
        check(np.array_equal(tum2[:frames, 0], tum[:, 0]), "resumed run lost the checkpointed stamps")
        check(second["keyframes"] >= first["keyframes"], "resumed run lost keyframes")
        check(second["packer"] == {"native": resume_frames}, f"resumed run packer {second['packer']}")
        from liorf_tpu_torch import native

        emit("cli", run=first, run_seconds=t_first, resume=second, resume_seconds=t_second,
             packer="native" if native.get_lib() is not None else f"numpy ({native.build_error})",
             trajectory_rows=[len(tum), len(tum2)], imu_rate_rows=len(imu_tum),
             global_map_points=len(gmap["x"]), ply_vertices=ply, overview_png_bytes=png)


def ply_vertices(path: str) -> int:
    with open(path) as f:
        for line in f:
            if line.startswith("element vertex "):
                return int(line.split()[2])
            if line.startswith("end_header"):
                break
    raise AssertionError(f"{path}: no vertex element")


# ---------------------------------------------------------------------------
# the arguments a path gives the kernels that are not TPU kernels
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def capture_kernel_args(cases: dict, lanes: int = 1):
    """Keep, by reference (no device work), the arguments of the block's
    last launch over ``lanes`` lanes (vmapped calls fold their lanes into
    the launch's leading axis) of: the voxel filter, by output size
    (``voxel_filter_out<S>``); the PCG for each iteration count
    (``pcg_iters<n>``: the window and the full solves); the linearization
    (``linearize``); of the fusion step (``fusion_step``); of the IMU
    preintegration (``preintegrate``); of the deskew (``deskew``) and the
    ScanContext descriptor (``make_descriptor``); and of any segment
    sum (``segment_sum``: a single-device path launches none); of the scan
    matcher's linearization (``scan_linearize``), update (``scan_update``,
    and ``scan_update_first`` of a first GN iteration) and first move of the
    scan (``transform``); and of ICP's
    alignment (``icp_align``; with ``lanes`` None the widest launch, the last
    of equals)."""
    real, real_pcg, real_lin, real_vfil = segsum._launch, pcg._launch, lin._launch, vfil._launch
    real_fus, real_sl, real_su, real_ia = (fstep._launch, sgn._launch_linearize, sgn._launch_update,
                                           ialign._launch_align)
    real_tf, real_pre = sgn._launch_transform, tpop._launch
    real_dsk, real_sc = tdsk._launch, tsc._launch

    def spy(*args, **kw):
        cases["segment_sum"] = args
        return real(*args, **kw)

    def spy_pcg(*args, **kw):
        if args[0].shape[0] == lanes:
            cases[f"pcg_iters{args[12]}"] = (args[:12], args[12], args[13])
        return real_pcg(*args, **kw)

    def spy_lin(*args, **kw):
        if args[0].shape[0] == lanes:
            cases["linearize"] = args
        return real_lin(*args, **kw)

    def spy_vfil(*args, **kw):
        if args[0].shape[0] == lanes:
            cases[f"voxel_filter_out{args[4]}"] = args
        return real_vfil(*args, **kw)

    def spy_fus(*args):
        if args[0].shape[0] == lanes:
            cases["fusion_step"] = args
        return real_fus(*args)

    def spy_pre(*args, **kw):
        if args[0].shape[0] == lanes:
            cases["preintegrate"] = args
        return real_pre(*args, **kw)

    def spy_dsk(*args):
        if args[0].shape[0] == lanes:
            cases["deskew"] = args
        return real_dsk(*args)

    def spy_sc(*args):
        if args[0].shape[0] == lanes:
            cases["make_descriptor"] = args
        return real_sc(*args)

    def spy_sl(*args):
        if args[0].shape[0] == lanes:
            cases["scan_linearize"] = args
        return real_sl(*args)

    def spy_su(*args):
        if args[1].shape[0] == lanes:
            cases["scan_update_first" if args[-1] else "scan_update"] = args
        return real_su(*args)

    def spy_tf(*args):
        if args[0].shape[0] == lanes:
            cases["transform"] = args
        return real_tf(*args)

    def spy_ia(*args):
        b = args[1].shape[0]
        if b == lanes or (lanes is None and b >= cases.get("icp_align", args)[1].shape[0]):
            cases["icp_align"] = args
        return real_ia(*args)

    segsum._launch, pcg._launch, lin._launch, vfil._launch = spy, spy_pcg, spy_lin, spy_vfil
    fstep._launch, sgn._launch_linearize, sgn._launch_update = spy_fus, spy_sl, spy_su
    ialign._launch_align, sgn._launch_transform, tpop._launch = spy_ia, spy_tf, spy_pre
    tdsk._launch, tsc._launch = spy_dsk, spy_sc
    try:
        yield cases
    finally:
        tdsk._launch, tsc._launch = real_dsk, real_sc
        segsum._launch, pcg._launch, lin._launch, vfil._launch = real, real_pcg, real_lin, real_vfil
        fstep._launch, sgn._launch_linearize, sgn._launch_update = real_fus, real_sl, real_su
        ialign._launch_align, sgn._launch_transform, tpop._launch = real_ia, real_tf, real_pre


def pcg_cases(cases: dict) -> dict:
    """The captured PCG launches, taken out of ``cases``."""
    return {k: cases.pop(k) for k in [k for k in cases if k.startswith("pcg_iters")]}


def linearize_case(cases: dict):
    """The captured linearization, taken out of ``cases``."""
    check("linearize" in cases, f"no linearize_normal launch captured: {sorted(cases)}")
    return cases.pop("linearize")


def fusion_case(cases: dict):
    """The captured fusion step, taken out of ``cases``."""
    check("fusion_step" in cases, f"no fusion_step launch captured: {sorted(cases)}")
    return cases.pop("fusion_step")


def preintegrate_case(cases: dict):
    """The captured preintegration, taken out of ``cases``."""
    check("preintegrate" in cases, f"no preintegrate launch captured: {sorted(cases)}")
    return cases.pop("preintegrate")


def front_case(cases: dict, name: str):
    """The captured deskew (``deskew``) or descriptor (``make_descriptor``),
    taken out of ``cases``."""
    check(name in cases, f"no {name} launch captured: {sorted(cases)}")
    return cases.pop(name)


def bench_segsum(src, perm, keys, S: int, offsets) -> dict:
    """The kernel, walking the given offsets, against a float64 reduction of
    the same rows (within Higham's bound for a sequential float32 sum,
    (n - 1) 2^-24 sum|x| per output, n the segment's rows), against the
    CPU's sequential index_add (bit for bit) and against itself; timed
    beside the plain version (index_add, atomic on the card) and the other
    candidate, torch's sort-based index_put(accumulate=True) over the rows'
    own indices. The lanes ([B] axis) are one launch; index_put takes them
    as one flat scatter, lane b's rows at b (S + 1) + key."""
    B, M, C = src.shape

    def kernel():
        return segsum._segment_sum_op(src, perm, keys, S, offsets)  # SegmentPlan.sum's launch

    out, again = kernel(), kernel()
    src64 = src.double()
    ref = segsum.segment_sum_plain(src64, perm, keys, S)
    abs_sum = segsum.segment_sum_plain(src64.abs(), perm, keys, S)
    rows = segsum.segment_sum_plain(torch.ones_like(src64[..., :1]), perm, keys, S)
    tol = (rows - 1).clamp(min=0) * 2.0**-24 * abs_sum
    err = (out.double() - ref).abs()
    cpu = segsum.segment_sum_plain(src.cpu(), None if perm is None else perm.cpu(), keys.cpu(), S)
    # candidate (a): the rows in their own order at their own indices, rows
    # keyed past the last segment into a dump row
    idx = keys if perm is None else torch.empty_like(keys).scatter_(1, perm, keys)
    idx = (idx.clamp(max=S) + torch.arange(B, device=DEV)[:, None] * (S + 1)).reshape(-1)
    flat = src.reshape(B * M, C)

    def index_put():
        out = torch.zeros((B * (S + 1), C), device=DEV).index_put_((idx,), flat, accumulate=True)
        return out.reshape(B, S + 1, C)[:, :S]

    a1, a2 = index_put(), index_put()
    # what the function must move: the rows, the perm and the offsets once,
    # the sums once; M * C additions
    bytes_moved = B * (M * C * 4 + M * 8 * (perm is not None) + (S + 1) * 8 + S * C * 4)
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, B * M * C / FP32_FLOP_PER_S
    res = dict(
        shape=[M, C, S], lanes=B, perm=perm is not None,
        # the plain version on the CPU adds in the kernel's order
        max_abs_err=float((out.cpu() - cpu).abs().max()),
        max_abs_err_vs_float64=float(err.max()),
        max_err_over_bound=float((err / tol.clamp(min=1e-30)).max()),
        equal_to_cpu_index_add=bool(torch.equal(out.cpu(), cpu)),
        repeats=bool(torch.equal(out, again)),
        index_put_repeats=bool(torch.equal(a1, a2)),
        index_put_max_abs_err_vs_float64=float((a1.double() - ref).abs().max()),
        **kernel_ms(kernel),
        plain_ms=cuda_ms(lambda: segsum.segment_sum_plain(src, perm, keys, S), reps=10, batch=20),
        library_ms=cuda_ms(index_put, reps=10, batch=20),
        library_ms_single_call=cuda_ms(index_put),
        library_call="torch.zeros(B (S + 1), C).index_put_((idx,), rows, accumulate=True)",
        bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=bytes_moved,
    )
    what = f"segment_sum {res['shape']} x {B} lanes"
    check(bool((err <= tol).all()), f"{what}: off the float64 sum by {res['max_abs_err_vs_float64']}")
    check(res["equal_to_cpu_index_add"], f"{what}: differs from the CPU's index_add")
    check(res["repeats"], f"{what}: two launches differ")
    return res


def pcg_flops(args, iters: int) -> int:
    """f32 operations of one pcg_solve on these arguments, as its data needs
    them (factors with an all-zero Jacobian add nothing and are skipped):
    per iteration 294 a between factor (J p at both ends, J^T y at both),
    72 a GPS factor, 144 the prior, 6 a nonzero row's node sums, and 144 a
    node (damping, two dots, x / r / p updates, Minv r); 84 a node to
    start."""
    Ji, Jj, Jg, Jp = args[:4]
    K = args[11].shape[1]

    def nonzero(J):
        return J.reshape(*J.shape[:2], -1).ne(0).any(-1)

    ni, nj, ng = nonzero(Ji), nonzero(Jj), nonzero(Jg)
    npr = Jp.reshape(Jp.shape[0], -1).ne(0).any(-1)
    rows = ni.sum() + nj.sum() + ng.sum() + npr.sum()
    per_iter = (294 * (ni | nj).sum() + 72 * ng.sum() + 144 * npr.sum() + 6 * rows
                + 144 * K * Jp.shape[0])
    return int(iters * per_iter + 84 * K * Jp.shape[0])


def op_by_op_pcg(args, iters: int, damping: float):
    """The op-by-op ``pose_graph._pcg`` (its dot ``torch.sum``, each lane
    under vmap) on pcg_solve's arguments: what the solve ran before the
    kernel, one launch an operation. It takes the block diagonal, so the
    preconditioner's blocks are recovered from Minv (outside the timing)."""
    eye = torch.eye(6, device=DEV)
    diag = torch.linalg.inv(args[10]) - eye * (damping + 1e-6)

    def one(Ji, Jj, Jg, Jp, e_i, e_j, g_i, p_i, d, rhs):
        plan = segsum.SegmentPlan([e_i, e_j, g_i, p_i], rhs.shape[0])
        t = pg.NormalTerms(Ji, Jj, Jg, Jp, e_i, e_j, g_i, p_i, plan)
        return pg._pcg(pg._matvec(t), rhs, d, iters, damping)

    lanes = torch.func.vmap(one)
    xs = (*args[:8], diag, args[11])
    return lambda: lanes(*xs)


def bench_pcg(args, iters: int, damping: float) -> dict:
    """The PCG kernel on the arguments a path gave it: against its plain
    version on CPU copies (bit for bit), against itself, at cluster sizes 1
    and 8 (bit for bit), and one launch of B lanes against each lane alone
    (bit for bit); timed beside the plain version on the card and the
    op-by-op ``_pcg`` (no single PyTorch call runs a PCG: library_ms null)."""
    B, K, _ = args[11].shape
    E, G = args[0].shape[1], args[2].shape[1]

    def kernel():
        return pcg.pcg_solve(*args, iters, damping)

    out, again = kernel(), kernel()
    cpu = pcg.pcg_solve_plain(*(a.cpu() for a in args), iters, damping)
    c1 = pcg._launch(*args, iters, damping, cluster=1)
    alone = torch.cat([pcg.pcg_solve(*(a[b:b + 1] for a in args), iters, damping)
                       for b in range(B)])
    old = op_by_op_pcg(args, iters, damping)
    x_old = old()
    bytes_moved = sum(a.numel() * a.element_size() for a in args) + out.numel() * 4
    flops = pcg_flops(args, iters)
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    res = dict(
        shape=dict(lanes=B, nodes=K, edges=E, gps=G, iters=iters), lanes=B,
        max_abs_err=float((out.cpu() - cpu).abs().max()),
        equal_to_cpu_plain=bool(torch.equal(out.cpu(), cpu)),
        repeats=bool(torch.equal(out, again)),
        cluster=pcg.CLUSTER,
        layout=int(pcg.load_library().liorf_pcg_layout(K, E, G, pcg.CLUSTER)),
        cluster_1_equal_8=bool(torch.equal(out, c1)),
        lanes_equal_one_lane_launches=bool(torch.equal(out, alone)),
        op_by_op_max_abs_diff=float((out - x_old).abs().max()),
        max_abs_x=float(out.abs().max()),
        **kernel_ms(kernel),
        # the kernel's own time on the card, apart from the wrapper's host time
        device_ms=device_only_ms(kernel),
        plain_ms=cuda_ms(lambda: pcg.pcg_solve_plain(*args, iters, damping), reps=3, warm=1),
        op_by_op_ms=cuda_ms(old, reps=3, warm=1),
        op_by_op_call="pose_graph._pcg op by op (torch.sum dots), vmapped over the lanes",
        library_ms=None,
        bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=bytes_moved, flops=flops,
    )
    what = f"pcg_solve {res['shape']}"
    check(res["equal_to_cpu_plain"], f"{what}: differs from its plain version on the CPU "
          f"by {res['max_abs_err']}")
    check(res["repeats"] and res["cluster_1_equal_8"], f"{what}: not repeatable across launches "
          "or cluster sizes")
    check(res["lanes_equal_one_lane_launches"], f"{what}: a lane differs from its launch alone")
    check(bool(torch.isfinite(out).all()), f"{what}: not finite")
    return res


def phase_pcg(cases: dict, label: str) -> dict:
    """The PCG kernel held on every launch shape a path gave it
    (capture_kernel_args): one line a path."""
    check(cases, f"no pcg_solve launch captured on {label}")
    out = {k: bench_pcg(*v) for k, v in sorted(cases.items())}
    emit("kernels_pcg", path=label, **out,
         tolerance="bit for bit: the plain version on the CPU, cluster sizes, lanes")
    return out


# ---------------------------------------------------------------------------
# the pose graph's linearization kernel (not a TPU kernel), at the paths' shapes
# ---------------------------------------------------------------------------

# Kernel against the jacfwd linearization: the closed form and jacfwd's
# batched products differ in the order of their sums; within 1e-2 of pi both
# carry rounding amplified by 1 / sin(theta) (tests/test_torch_linearize.py's
# bounds): the block diagonal and the J blocks within 1e-4 of their largest
# entry. The right-hand side -J^T r nearly cancels once a solve converges, so
# its own largest entry is no scale (the main path's last window step was
# off by 0.23 of it): a difference d in the whitened residual moves it by
# about J^T J d, so each entry is held within 1e-5 of its column's stiffness,
# the diagonal of J^T J at that node and tangent (1e-8 to 1e-7 on the CPU
# through a converging solve).
LINEARIZE_JACFWD_TOL = 1e-4
LINEARIZE_RHS_TOL = 1e-5
LINEARIZE_OUT = ("rhs", "diag", "Ji", "Jj", "Jg", "Jp")


def linearize_graph(args):
    """The lanes' PoseGraph [B, ...] and free mask of linearize_normal's
    arguments (node_mask is not read by a linearization)."""
    a = dict(zip(lin.ARGS, args))
    graph = pg.PoseGraph(
        Rs=a["Rs"], ts=a["ts"], node_mask=a["free_mask"], e_i=a["e_i"], e_j=a["e_j"],
        e_Rm=a["e_Rm"], e_tm=a["e_tm"], e_sqrt_info=a["e_sqrt_info"], e_cauchy=a["e_cauchy"],
        e_mask=a["e_mask"], g_i=a["g_i"], g_t=a["g_t"], g_sqrt_info=a["g_sqrt_info"],
        g_mask=a["g_mask"], prior_i=a["p_i"][:, 0], prior_R=a["prior_R"], prior_t=a["prior_t"],
        prior_sqrt_info=a["prior_sqrt_info"])
    return graph, a["free_mask"]


def device_only_ms(fn, reps: int = 20) -> float:
    """Median device time of one fn() in ms, apart from the host's time to
    reach its launches: the card spins ~1 ms (torch.cuda._sleep) just before
    each timed call, so the call is enqueued before the first event is
    reached. (A second torch.profiler trace in one process came back empty
    on the card, so this takes CUDA events, not the tracer.)"""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bench_linearize(args) -> dict:
    """The linearization kernel on the arguments a path gave it: against its
    plain version (phase A on the card, bit for bit including the rows; the
    node sums in the plan's order on the CPU, since index_add on the card
    adds in no fixed order), its node sums against the CPU's index_add of
    its own rows (bit for bit), against itself, each lane against its own
    launch, and against the jacfwd linearization (``pose_graph._normal_terms_
    jacfwd``, vmapped over the lanes) within LINEARIZE_JACFWD_TOL; timed
    beside the plain version on the card and the jacfwd linearization it
    replaced (no single PyTorch call linearizes a pose graph: library_ms
    null)."""
    B, K = args[0].shape[:2]
    E, G = args[2].shape[1], args[9].shape[1]

    def kernel():
        return lin.linearize_normal(*args)

    k0 = lin.kernel_launches()
    again = kernel()
    per_call = lin.kernel_launches() - k0
    *out, rows = lin._launch(*args, keep_rows=True)
    k0 = lin.kernel_launches()
    vmapped = torch.func.vmap(lambda *a: tuple(
        x[0] for x in lin.linearize_normal(*(t[None] for t in a))))(*args)
    per_vmapped_call = lin.kernel_launches() - k0
    Ji, Jj, Jg, Jp, rows_p = lin.factor_rows_plain(*args[:18])
    sums = segsum.segment_sum_plain(rows_p.cpu(), args[19].cpu(), args[18].cpu(), K)
    plain = (sums[..., :6], sums[..., 6:].reshape(B, K, 6, 6), Ji.cpu(), Jj.cpu(), Jg.cpu(),
             Jp.cpu())
    own = segsum.segment_sum_plain(rows.cpu(), args[19].cpu(), args[18].cpu(), K)
    alone = [lin.linearize_normal(*(a[b:b + 1] for a in args)) for b in range(B)]
    graph, free = linearize_graph(args)

    def jacfwd():
        return torch.func.vmap(pg._normal_terms_jacfwd)(graph, free)

    oracle = jacfwd()
    # f32 operations as the data needs them (a factor whose rows are all zero,
    # unused or masked, needs none; atan2 counted as one): ~1650 a between
    # factor (P, Q, six directions of so3_log's derivative, the weights, both
    # J blocks, two rows of 42 sums of 6 products), ~270 a GPS factor, ~720
    # the prior, and 42 adds a nonzero row in its node's sums
    nz = rows.ne(0).any(-1)  # [B, M]
    n_between = int((nz[:, :E] | nz[:, E:2 * E]).sum())
    n_gps, n_prior = int(nz[:, 2 * E:2 * E + G].sum()), int(nz[:, -1].sum())
    flops = 1650 * n_between + 270 * n_gps + 720 * n_prior + 42 * int(nz.sum())
    bytes_moved = (sum(a.numel() * a.element_size() for a in args)
                   + sum(o.numel() * 4 for o in out))
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    rel = {n: float((o - j).abs().max() / j.abs().max().clamp(min=1e-30))
           for n, o, j in zip(LINEARIZE_OUT, out, oracle)}
    stiffness = torch.diagonal(oracle[1], dim1=-2, dim2=-1)  # [B, K, 6]
    rhs_over_stiffness = float(((out[0] - oracle[0]).abs() / stiffness.clamp(min=1e-30)).max())
    res = dict(
        shape=dict(lanes=B, nodes=K, edges=E, gps=G), lanes=B,
        active=dict(between=n_between, gps=n_gps, prior=n_prior, rows=int(nz.sum())),
        kernel_launches_per_call=per_call, kernel_launches_per_vmapped_call=per_vmapped_call,
        vmapped_call_equal=all(torch.equal(o, v) for o, v in zip(out, vmapped)),
        max_abs_err=max(float((o.cpu() - p).abs().max()) for o, p in zip(out, plain)),
        equal_to_plain=all(torch.equal(o.cpu(), p) for o, p in zip(out, plain)),
        rows_equal_to_plain=bool(torch.equal(rows, rows_p)),
        sums_equal_to_cpu_index_add=bool(torch.equal(out[0].cpu(), own[..., :6])
                                         and torch.equal(out[1].cpu(), own[..., 6:].reshape(B, K, 6, 6))),
        repeats=all(torch.equal(o, a) for o, a in zip(out, again)),
        lanes_equal_one_lane_launches=all(
            torch.equal(o, torch.cat([x[k] for x in alone])) for k, o in enumerate(out)),
        jacfwd_max_rel_diff=rel, jacfwd_rhs_diff_over_stiffness=rhs_over_stiffness,
        **kernel_ms(kernel),
        # the kernel's own time on the card, apart from the wrapper's host time
        device_ms=device_only_ms(kernel),
        host_parts_us=call_host_parts_us(linearize_host_steps(args), lin.linearize_normal, args),
        plain_ms=cuda_ms(lambda: lin.linearize_normal_plain(*args), reps=5, warm=1),
        op_by_op_ms=cuda_ms(jacfwd, reps=5, warm=1),
        op_by_op_call="pose_graph._normal_terms_jacfwd (jacfwd under vmap, masks, SegmentPlan "
                      "sums), vmapped over the lanes",
        library_ms=None,
        bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=bytes_moved, flops=flops,
    )
    res["finite"] = all(bool(torch.isfinite(o).all()) for o in out)
    return res


def phase_linearize(args, label: str) -> dict:
    """The linearization kernel held on the last launch a path gave it
    (capture_kernel_args): one line a path, then its checks."""
    res = bench_linearize(args)
    emit("kernels_linearize", path=label, **res,
         tolerance=f"bit for bit against the plain version (phase A on the card, node sums on "
                   f"the CPU); jacfwd: diag and J blocks within {LINEARIZE_JACFWD_TOL} of their "
                   f"largest entry, rhs within {LINEARIZE_RHS_TOL} of its column's stiffness")
    what = f"linearize_normal on {label} {res['shape']}"
    check(res["kernel_launches_per_call"] == 1,
          f"{what}: {res['kernel_launches_per_call']} kernel launches a call, not one")
    check(res["kernel_launches_per_vmapped_call"] == 1,
          f"{what}: {res['kernel_launches_per_vmapped_call']} kernel launches a vmapped call, "
          f"not one")
    check(res["vmapped_call_equal"], f"{what}: the vmapped call differs from the direct one")
    check(res["rows_equal_to_plain"], f"{what}: phase A's rows differ from the plain version's")
    check(res["equal_to_plain"], f"{what}: differs from its plain version by {res['max_abs_err']}")
    check(res["sums_equal_to_cpu_index_add"], f"{what}: node sums differ from the CPU's index_add")
    check(res["repeats"], f"{what}: two launches differ")
    check(res["lanes_equal_one_lane_launches"], f"{what}: a lane differs from its launch alone")
    check(res["finite"], f"{what}: not finite")
    rel = {k: v for k, v in res["jacfwd_max_rel_diff"].items() if k != "rhs"}
    check(max(rel.values()) <= LINEARIZE_JACFWD_TOL, f"{what}: off the jacfwd linearization: {rel}")
    check(res["jacfwd_rhs_diff_over_stiffness"] <= LINEARIZE_RHS_TOL,
          f"{what}: rhs off the jacfwd linearization's by "
          f"{res['jacfwd_rhs_diff_over_stiffness']} of its column's stiffness")
    return res


# ---------------------------------------------------------------------------
# the fusion step
# ---------------------------------------------------------------------------

# The kernel against its plain version on the card: bit for bit (NaN where
# the other is NaN). Against a float64 run of the plain version: the mean
# within FUSION_MEAN_TOL a component (rad, m, m/s) and the information W^T W
# within FUSION_INFO_TOL of its largest entry, the bounds tests/test_torch_ops.py
# puts on the port against its own float64 run (the ill-conditioned
# correction) and on the information. Against the jacfwd oracle
# (imu/fusion.py::fusion_step_jacfwd, float32 op by op, the route the kernel
# replaced): the mean within FUSION_JACFWD_MEAN_TOL, that test's bound between
# two implementations of one correction from one state, and the information
# within FUSION_INFO_TOL, fixed bounds; the oracle's own distance to the
# float64 run is recorded beside them (its float32 marginalization is
# ~1e-3 of the information's largest entry off).
FUSION_MEAN_TOL = 1e-4
FUSION_JACFWD_MEAN_TOL = 1e-5
FUSION_INFO_TOL = 2e-3
FUSION_OUT = ("R", "p", "v", "ba", "bg", "W", "diverged")


# The fusion step's operations as the function needs them (not as
# csrc/fusion.cu runs them): an add, sub, mul, div, sqrt, sin, cos or atan2 is
# one; a sign change, a copy or a structural zero is none; an n-term sum is
# n - 1 adds. The 3 x 3 geometry, each in its cheapest branch:
EXP_OPS = 37      # theta^2 5, sqrt 1, A and B (Taylor) 2 + 2, W^2 = w w^T - theta^2 I 9, A W 3, B W^2 6, I + ... 9
EXP_JVP_OPS = 68  # dtheta^2 6, dA and dB (Taylor) 1 + 1, d(W^2) 21, dA W, A dW, dB W^2, B dW^2 18, their sums 21
LOG_OPS = 21      # trace 2, cos 2, skew part 6, sin^2 5, sqrt 1, atan2 1, scale 1, w 3
LOG_W_OPS = 3     # of LOG_OPS, w = skew * scale, which only the residual needs
LOG_JVP_OPS = 32  # dcos 3, dskew 6, d(sin^2) 6, dtheta 7, dscale (Taylor) 1, dw 9
MM_OPS, MV_OPS = 45, 15  # a 3 x 3 product, a 3 x 3 matrix-vector product


def _dot_ops(t: int) -> int:
    """A t-term product sum."""
    return 2 * t - 1 if t > 0 else 0


def _chol_ops(n: int) -> int:
    """Cholesky of n x n: column j's entries each a j-term dot, a sub (j > 0)
    and a sqrt or div."""
    return sum((n - j) * (_dot_ops(j) + (j > 0) + 1) for j in range(n))


def fusion_jacobian_pattern(w_nz: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The nonzero pattern of the 36 x 30 Jacobian (ops/fusion_step.py::
    system_plain) given the prior's square-root information's pattern
    [15, 15], and the term counts [9, 30] of the IMU rows' whitening (the
    lower-triangular imu_W times the raw rows)."""
    J = np.zeros((36, 30), bool)
    J[:15, :3] = w_nz[:, :3].any(1)[:, None]
    J[:15, 3:15] = w_nz[:, 3:]
    raw = np.zeros((9, 30), bool)
    raw[0:3, 0:3] = raw[0:3, 12:15] = raw[0:3, 15:18] = True  # theta_i, bg_i, theta_j
    for r0, blocks in ((3, (6, 9, 12, 21)), (6, (3, 6, 9, 12, 18))):  # the v and p rows
        raw[r0:r0 + 3, 0:3] = ~np.eye(3, dtype=bool)  # hat(a): no diagonal
        for c in blocks:
            raw[r0:r0 + 3, c:c + 3] = True
    terms = np.cumsum(raw, 0)  # row r of imu_W @ raw: the terms m <= r
    J[15:24] = terms > 0
    for m in range(6):
        J[24 + m, 9 + m] = J[24 + m, 24 + m] = True
    J[30:33, 15:18] = True
    for m in range(3):
        J[33 + m, 18 + m] = True
    return J, terms


def _householder_ops(J: np.ndarray) -> tuple[int, np.ndarray]:
    """Householder QR of [J | r] on its pattern, with fill-in: a reflector
    over the rows nonzero in its column, a later column updated only where
    one of them is nonzero. Returns the count and R's pattern."""
    A = np.concatenate([J, np.ones((J.shape[0], 1), bool)], 1)
    ops = 0
    for k in range(J.shape[1]):
        below = [i for i in range(k + 1, A.shape[0]) if A[i, k]]
        if not below:
            A[k, k] = True
            continue
        rows = [k] + below
        t = len(below)
        ops += _dot_ops(t) + 3 + 2 + 1 + t  # ||x||^2, the norm, tau, alpha - beta, v
        for j in range(k + 1, A.shape[1]):
            hit = [i for i in rows if A[i, j]]
            if hit:  # v^T a_j (v_k = 1), tau w, a_j - tau w v
                ops += len(hit) - (k in hit) + len(hit) - 1 + 1 + t + len(rows)
                A[rows, j] = True
        A[below, k] = False
        A[k, k] = True
    return ops, A


def fusion_ops(W: torch.Tensor, gn_iters: int) -> tuple[int, int]:
    """(float32, float64) operations that fusion_step needs for the lanes of
    W (the prior's square-root information [B, 15, 15]: its nonzeros set the
    Jacobian's). Counted on each lane's pattern: the geometry once where the
    kernel repeats it, the last system without the residual W_new does not
    need, the QR with its fill-in, H = J^T J its symmetric half; the LU of
    the Schur complement, A^-1 B and C - B^T A^-1 B dense (H's first 15 rows
    are ~80 % nonzero)."""
    f32 = f64 = 0
    for w_nz in (W != 0).cpu().numpy():
        J, terms = fusion_jacobian_pattern(w_nz)
        corr_J = 3 + MV_OPS + EXP_OPS + MM_OPS  # dbg, w = dR_dbg dbg, exp(w), dR0 exp(w)
        corr_r = 3 + 2 * (2 * MV_OPS + 6)  # dba; dv and dp corrected
        log_jac = 3 * (LOG_OPS - LOG_W_OPS)
        system_J = (
            MM_OPS + 3 * LOG_JVP_OPS + 3 * int(sum(_dot_ops(int(n)) for n in w_nz[:, :3].sum(1)))
            + corr_J + 2 * MM_OPS + 9 * LOG_JVP_OPS + 3 * MM_OPS + 3 * (EXP_JVP_OPS + 2 * MM_OPS)
            + (5 + MV_OPS) + (13 + MV_OPS) + 9 + int(sum(_dot_ops(int(t)) for t in terms.ravel()))
            + MM_OPS + 3 * LOG_JVP_OPS + 9 + log_jac)
        system_r = (12 + int(sum(_dot_ops(int(n)) for n in w_nz.sum(1))) + corr_r + 6
                    + sum(_dot_ops(r + 1) for r in range(9)) + 12 + 9 + 3 * LOG_W_OPS)
        qr, Rp = _householder_ops(J)
        back = sum(2 + _dot_ops(int(Rp[k, k + 1:30].sum())) + bool(Rp[k, k + 1:30].any())
                   for k in range(30)) + 30
        gn = (int(sum(_dot_ops(int(n)) + 1 for n in J.sum(0))) + int(J.sum()) + qr + back
              + 2 * (EXP_OPS + MM_OPS + 12))
        setup = 9 + _chol_ops(9) + 9 + sum(2 * (i - c) for c in range(9) for i in range(c + 1, 9))
        setup += 5 + 2 + 28 + 20 + MM_OPS  # bias and lidar weights, the prediction
        f32 += setup + (gn_iters + 1) * system_J + gn_iters * (system_r + gn) + 3 * 6
        both = (J[:, :, None] & J[:, None, :]).sum(0)[np.triu_indices(30)]
        f64 += (int(sum(_dot_ops(int(t)) for t in both)) + 30 + 2 * int((both > 0).sum()) + 30
                + sum((14 - k) + 2 * (14 - k) * (29 - k) for k in range(15))
                + 15 * sum(_dot_ops(14 - k) + (k < 14) + 1 for k in range(15))
                + 225 * (_dot_ops(15) + 1) + 105 * 2 + 15 + _chol_ops(15) + 120)
    return f32, f64


def fusion_params(consts) -> tfusion.FusionParams:
    acc_rw, gyr_rw, gravity, rot, trans, deg, max_v, max_b, iters = consts
    return tfusion.FusionParams(
        imu=tfusion.ImuParams(acc_bias_rw=acc_rw, gyr_bias_rw=gyr_rw, gravity=gravity),
        correction_rot_sigma=rot, correction_trans_sigma=trans, degenerate_sigma=deg,
        max_velocity=max_v, max_bias=max_b, gn_iters=iters)


def fusion_jacfwd(tensors, params):
    """The jacfwd oracle on every lane (vmapped, as the multistream lanes ran
    it before the kernel): the op's seven outputs with a lane axis."""
    def one(*t):
        filt = tfusion.FusionFilter(tfusion.FusionState(*t[:5]), t[5])
        st = tfusion.fusion_step_jacfwd(filt, tfusion.Preintegrated(*t[6:18]), t[18], t[19],
                                        t[20], params)
        return (*st.filter.mean, st.filter.sqrt_info, st.diverged)

    if tensors[0].shape[0] == 1:
        return tuple(x[None] for x in one(*(t[0] for t in tensors)))
    return torch.func.vmap(one)(*tensors)


def same_bits(x, y) -> bool:
    """Equal, NaN where the other is NaN."""
    return bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all()) if x.is_floating_point() \
        else bool(torch.equal(x, y))


def fusion_diffs(out, ref) -> dict:
    """The largest difference of the mean (a component) and of the
    information W^T W (over its largest entry), lanes that diverged in
    neither left out."""
    keep = ~(out[6] | ref[6])
    mean = max((float((a[keep].double() - b[keep].double()).abs().max()) if keep.any() else 0.0)
               for a, b in zip(out[:5], ref[:5]))
    if not keep.any():
        return dict(mean=mean, info=0.0)
    W, Wr = out[5][keep].double(), ref[5][keep].double()
    I, Ir = W.transpose(1, 2) @ W, Wr.transpose(1, 2) @ Wr
    return dict(mean=mean, info=float((I - Ir).abs().max() / Ir.abs().max()))


def bench_fusion(args) -> dict:
    """The fusion kernel on the arguments a path gave it: against its plain
    version on the card (bit for bit), against itself, each lane against its
    own launch, against a float64 run of the plain version (FUSION_MEAN_TOL,
    FUSION_INFO_TOL) and against the jacfwd oracle (FUSION_JACFWD_MEAN_TOL,
    FUSION_INFO_TOL); timed beside the plain
    version on the card and the op-by-op oracle it replaced (no single
    PyTorch call runs a fusion step: library_ms null)."""
    k = len(fstep.ARGS)
    tensors, consts = args[:k], args[k:]
    B = tensors[0].shape[0]

    def kernel():
        return fstep.fusion_step(*args)

    out = fstep._launch(*args)
    again = kernel()
    plain = fstep.fusion_step_plain(*args)
    alone = [fstep.fusion_step(*(t[b:b + 1] for t in tensors), *consts) for b in range(B)]
    f64 = fstep.fusion_step_plain(*(t.double() if t.is_floating_point() else t for t in tensors),
                                  *consts)
    params = fusion_params(consts)
    oracle = fusion_jacfwd(tensors, params)
    f32_ops, f64_ops = fusion_ops(tensors[fstep.ARGS.index("W")], int(consts[-1]))
    bytes_moved = (sum(t.numel() * t.element_size() for t in tensors)
                   + sum(o.numel() * o.element_size() for o in out))
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = f32_ops / FP32_FLOP_PER_S + f64_ops / FP64_FLOP_PER_S
    vs64, vsj, oracle64 = fusion_diffs(out, f64), fusion_diffs(out, oracle), fusion_diffs(oracle, f64)
    res = dict(
        shape=dict(lanes=B, gn_iters=int(consts[-1])), lanes=B,
        diverged_lanes=int(out[6].sum()), degenerate_lanes=int(tensors[-1].sum()),
        max_abs_err=max(float((o.double() - p.double()).abs().nan_to_num(0.0).max())
                        for o, p in zip(out, plain)),
        equal_to_plain=all(same_bits(o, p) for o, p in zip(out, plain)),
        repeats=all(same_bits(o, a) for o, a in zip(out, again)),
        lanes_equal_one_lane_launches=all(
            same_bits(o, torch.cat([x[i] for x in alone])) for i, o in enumerate(out)),
        float64_mean_max_abs_diff=vs64["mean"], float64_info_max_rel_diff=vs64["info"],
        jacfwd_mean_max_abs_diff=vsj["mean"], jacfwd_info_max_rel_diff=vsj["info"],
        jacfwd_vs_float64_mean_max_abs_diff=oracle64["mean"],
        jacfwd_vs_float64_info_max_rel_diff=oracle64["info"],
        diverged_equal_float64=bool(torch.equal(out[6], f64[6])),
        diverged_equal_jacfwd=bool(torch.equal(out[6], oracle[6])),
        finite=all(bool(torch.isfinite(o[~out[6]]).all()) for o in out[:6]),
        **kernel_ms(kernel),
        # the kernel's own time on the card, apart from the wrapper's host time
        device_ms=device_only_ms(kernel),
        plain_ms=cuda_ms(lambda: fstep.fusion_step_plain(*args), reps=5, warm=1),
        op_by_op_ms=cuda_ms(lambda: fusion_jacfwd(tensors, params), reps=3, warm=1),
        op_by_op_call="imu/fusion.py::fusion_step_jacfwd (jacfwd, library QR, solve_ex, "
                      "cholesky_ex)" + (", vmapped over the lanes" if B > 1 else ""),
        library_ms=None,
        bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=bytes_moved, flops=dict(float32=f32_ops, float64=f64_ops),
    )
    return res


def phase_fusion(args, label: str) -> dict:
    """The fusion kernel held on the last launch a path gave it
    (capture_kernel_args): one line a path, then its checks."""
    res = bench_fusion(args)
    emit("kernels_fusion", path=label, **res,
         tolerance=f"bit for bit against the plain version on the card (NaN where it is NaN); "
                   f"float64 run: mean within {FUSION_MEAN_TOL} a component, W^T W within "
                   f"{FUSION_INFO_TOL} of its largest entry; jacfwd oracle: mean within "
                   f"{FUSION_JACFWD_MEAN_TOL}, W^T W within {FUSION_INFO_TOL}; the oracle's "
                   f"own distance to the float64 run for information")
    what = f"fusion_step on {label} {res['shape']}"
    check(res["equal_to_plain"], f"{what}: differs from its plain version by {res['max_abs_err']}")
    check(res["repeats"], f"{what}: two launches differ")
    check(res["lanes_equal_one_lane_launches"], f"{what}: a lane differs from its launch alone")
    check(res["finite"], f"{what}: not finite where it did not diverge")
    check(res["diverged_equal_float64"] and res["diverged_equal_jacfwd"],
          f"{what}: the divergence flag differs from the float64 run's or the oracle's")
    for ref, mean_tol in (("float64", FUSION_MEAN_TOL), ("jacfwd", FUSION_JACFWD_MEAN_TOL)):
        check(res[f"{ref}_mean_max_abs_diff"] <= mean_tol
              and res[f"{ref}_info_max_rel_diff"] <= FUSION_INFO_TOL,
              f"{what}: off the {ref} run: mean {res[f'{ref}_mean_max_abs_diff']} (bound "
              f"{mean_tol}), information {res[f'{ref}_info_max_rel_diff']} (bound "
              f"{FUSION_INFO_TOL})")
    return res


# ---------------------------------------------------------------------------
# the IMU preintegration
# ---------------------------------------------------------------------------

# The kernel against its plain version on the card: bit for bit. Against
# imu/preintegration.py::preintegrate_sequential (the Forster recursion on
# core/se3.py's own Rodrigues forms, in float64 on a CPU copy of each lane, so
# that it shares no helper and no rounding with the code under test), as
# tests/test_torch_preintegrate.py holds them, a form's rounding counted at
# its worst (PREINT_ROUNDINGS a field's entry a sample: the covariance's
# A Q A^T + Q, two 9-term product sums and an add): the plain version in
# float64 within 2 PREINT_ROUNDINGS n eps64 max|field| a field (a 3 x 3 block
# of the covariance), n the valid samples (sequential_max_ratio_to_bound);
# and the kernel's float32 result within (PREINT_ROUNDINGS n eps32 + 3 e)
# max|field|, e = max over the samples of min(eps32 / (2 theta), theta / 2),
# theta = |w dt|, what float32's cancellation in Rodrigues'
# (1 - cos theta) / theta^2 can put into a leaf's Jr
# (exact_max_ratio_to_bound). Each line records the largest distance over
# its bound (<= 1 holds).
EPS32 = 2.0**-24
EPS64 = 2.0**-53
PREINT_ROUNDINGS = 19
PREINT_K256 = (256, 230)  # the seeded window: K and its valid samples (a dt = 0, a masked one)

# The operations the function needs a valid sample (the sequential Forster
# recursion on A's structure, not the kernel's tree): a and w dt 9; so3_exp
# (EXP_OPS); Jr 28; the state (P hat(a) 27, P a 15, dp 12, dv 6, dR 45, T 1);
# the five Jacobians 207; the covariance A S A^T on A's block structure (513
# for A S, 285 for the symmetric half of (A S) A^T) and B N B^T on B's (180).
PREINT_SAMPLE_OPS = 9 + EXP_OPS + 28 + (27 + 15 + 12 + 6 + 45 + 1) + 207 + (513 + 285 + 180)


def _cov_blocks(name, x):
    if name != "cov":
        return [x]
    return [x[3 * i:3 * i + 3, 3 * j:3 * j + 3] for i in range(3) for j in range(3)]


def _scaled_ratio(got, want, rel: float) -> float:
    """The largest distance of got from want over rel max|field| (each 3 x 3
    block of the covariance its own field)."""
    worst = 0.0
    for name, x, y in zip(tpop.FIELDS, got, want):
        for xb, yb in zip(_cov_blocks(name, x.double()), _cov_blocks(name, y.double())):
            d, scale = float((xb - yb).abs().max()), rel * float(yb.abs().max())
            worst = max(worst, d / scale if scale > 0 else (0.0 if d == 0 else float("inf")))
    return worst


def preint_oracle_ratios(args, out) -> dict:
    """The plain version in float64 and the kernel's float32 result against
    preintegrate_sequential in float64, each lane on a CPU copy, over their
    bounds (see PREINT_ROUNDINGS)."""
    host = [t.cpu() for t in args[:6]]
    wide = [t.double() if t.is_floating_point() else t for t in host]
    params = tpre.ImuParams(acc_noise=args[6], gyr_noise=args[7], int_noise=args[8])
    plain64 = tpop.preintegrate_plain(*wide, *args[6:])
    seq_ratio = exact_ratio = 0.0
    for b in range(host[0].shape[0]):
        seq = tpre.preintegrate_sequential(*(t[b] for t in wide), params)
        seq = [getattr(seq, f) for f in tpop.FIELDS]
        acc, gyr, dts, mask, ba, bg = (t[b] for t in host)
        n = int(mask.sum())
        theta = ((gyr - bg) * torch.where(mask, dts, 0.0)[:, None]).double().norm(dim=1)
        leaf = float(torch.minimum(EPS32 / (2 * theta), theta / 2).max())
        seq_ratio = max(seq_ratio, _scaled_ratio([o[b] for o in plain64], seq,
                                                 2 * PREINT_ROUNDINGS * n * EPS64))
        exact_ratio = max(exact_ratio, _scaled_ratio([o[b].cpu() for o in out], seq,
                                                     PREINT_ROUNDINGS * n * EPS32 + 3 * leaf))
    return dict(sequential_max_ratio_to_bound=seq_ratio, exact_max_ratio_to_bound=exact_ratio)


def preint_seeded_case(lanes: int = 4):
    """tests/test_torch_ops.py::_imu_case's window at K = 256 (230 valid
    samples, a duplicate timestamp, a masked one), one lane a seed 5, 6, ..."""
    K, n_valid = PREINT_K256
    cols = []
    for seed in range(5, 5 + lanes):
        rng = np.random.default_rng(seed)
        acc = (rng.normal(0, 0.5, (K, 3)) + [0.3, -0.2, 9.8]).astype(np.float32)
        gyr = rng.normal(0, 0.3, (K, 3)).astype(np.float32)
        dts = np.full(K, 0.005, np.float32)
        dts[3] = 0.0
        mask = np.arange(K) < n_valid
        mask[7] = False
        cols.append((acc, gyr, dts, mask, np.array([0.02, -0.01, 0.03], np.float32),
                     np.array([0.001, 0.002, -0.001], np.float32)))
    p = tpre.ImuParams()
    return (*(torch.from_numpy(np.stack(c)).to(DEV) for c in zip(*cols)), p.acc_noise,
            p.gyr_noise, p.int_noise)


def bench_preintegrate(args) -> dict:
    """The preintegration kernel on the arguments a path gave it: against
    its plain version on the card (bit for bit), against itself, each lane
    against its own launch, against the sequential oracle in float64 (see
    PREINT_ROUNDINGS); timed beside the plain version (no single PyTorch call
    preintegrates a window: library_ms null). bound_ms counts what the
    function needs: the mask, the valid samples' acc, gyr and dt, the biases
    and the outputs, each once, and PREINT_SAMPLE_OPS a valid sample."""
    tensors, consts = args[:6], args[6:]
    B, K = tensors[2].shape

    def kernel():
        return tpop.preintegrate(*args)

    k0 = tpop.kernel_launches()
    out = kernel()
    per_call = tpop.kernel_launches() - k0
    again = kernel()
    k0 = tpop.kernel_launches()
    vmapped = torch.func.vmap(lambda *a: tuple(
        x[0] for x in tpop.preintegrate(*(t[None] for t in a), *consts)))(*tensors)
    per_vmapped_call = tpop.kernel_launches() - k0
    plain = tpop.preintegrate_plain(*args)
    alone = [tpop.preintegrate(*(t[b:b + 1] for t in tensors), *consts) for b in range(B)]
    n_valid = int(tensors[3].sum())
    return dict(
        shape=dict(lanes=B, K=K, valid_samples=n_valid), lanes=B,
        kernel_launches_per_call=per_call, kernel_launches_per_vmapped_call=per_vmapped_call,
        vmapped_call_equal=all(same_bits(o, v) for o, v in zip(out, vmapped)),
        max_abs_err=max_abs_err(out, plain),
        equal_to_plain=all(same_bits(o, p) for o, p in zip(out, plain)),
        repeats=all(same_bits(o, a) for o, a in zip(out, again)),
        lanes_equal_one_lane_launches=all(
            same_bits(o, torch.cat([x[i] for x in alone])) for i, o in enumerate(out)),
        **preint_oracle_ratios(args, out),
        finite=all(bool(torch.isfinite(o).all()) for o in out),
        **kernel_ms(kernel),
        # the kernel's own time on the card, apart from the wrapper's host time
        device_ms=device_only_ms(kernel),
        host_parts_us=call_host_parts_us(preintegrate_host_steps(args), tpop.preintegrate,
                                          args),
        plain_ms=cuda_ms(lambda: tpop.preintegrate_plain(*args), reps=5, warm=1),
        library_ms=None,
        **bound(nbytes(tensors[3:]) + n_valid * (12 + 12 + 4) + nbytes(out),
                n_valid * PREINT_SAMPLE_OPS),
    )


def phase_preintegrate(args, label: str) -> dict:
    """The preintegration kernel held on the launch a path gave it
    (capture_kernel_args) or on the seeded window: one line, then its checks."""
    res = bench_preintegrate(args)
    emit("kernels_preintegrate", path=label, **res,
         tolerance="bit for bit against the plain version on the card; against the sequential "
                   "oracle in float64: the plain version in float64 within 38 n eps64 "
                   "max|field| (sequential_max_ratio_to_bound <= 1), the kernel within "
                   "(19 n eps32 + 3 e) max|field| (exact_max_ratio_to_bound <= 1)")
    what = f"preintegrate on {label} {res['shape']}"
    check(res["kernel_launches_per_call"] == 1,
          f"{what}: {res['kernel_launches_per_call']} kernel launches a call, not one")
    check(res["kernel_launches_per_vmapped_call"] == 1,
          f"{what}: {res['kernel_launches_per_vmapped_call']} kernel launches a vmapped call, "
          f"not one")
    check(res["vmapped_call_equal"], f"{what}: the vmapped call differs from the direct one")
    check(res["equal_to_plain"], f"{what}: differs from its plain version by {res['max_abs_err']}")
    check(res["repeats"], f"{what}: two launches differ")
    check(res["lanes_equal_one_lane_launches"], f"{what}: a lane differs from its launch alone")
    check(res["finite"], f"{what}: not finite")
    check(res["sequential_max_ratio_to_bound"] <= 1.0,
          f"{what}: the plain version in float64 {res['sequential_max_ratio_to_bound']} of its "
          f"bound from the sequential oracle")
    check(res["exact_max_ratio_to_bound"] <= 1.0,
          f"{what}: {res['exact_max_ratio_to_bound']} of its bound from the float64 oracle")
    return res


# ---------------------------------------------------------------------------
# the frame's front end: the deskew and the ScanContext descriptor
# ---------------------------------------------------------------------------

# Operations as the data needs them (an add, sub, mul, div, sin or cos is
# one; compares, clamps and the search not counted): a masked-in point's
# deskew 64 float32 (its time 1, the lerp 12, R = Rz Ry Rx from its sines and
# cosines 21, R p and R0^T (R p) 30) and 6 float64 (sin and cos of three
# angles); the timeline 4 float32 (dt, gyr dt) and 3 float64 (the running
# sum) a valid sample.
DESKEW_POINT_OPS = (64, 6)
DESKEW_SAMPLE_OPS = (4, 3)
# The descriptor: a masked-in point's radius 4 (two products, a sum, a root);
# one within 80 m 9 more (z + 2, atan2, degrees, +360, the ring's and the
# sector's quotient and product, and its max).
SC_POINT_OPS, SC_BIN_OPS = 4, 9
# Against the plain version on a CPU copy (the CPU's libm: sin, cos, atan2):
# tests/test_torch_ops.py::test_deskew's 5e-5 m and
# ::test_scancontext_descriptor_and_detect's share of bins that differ.
DESKEW_CPU_M = 5e-5
SC_CPU_BINS = 0.01
DESKEW_SEEDED = ((256, 230), (300, 271))  # (K, valid samples): 256, and a K of no power of two


def deskew_seeded_case(K: int, n_valid: int, lanes: int = 4, n: int = BENCH_CAPS["raw_capacity"]):
    """Seeded scans of n points and gyro windows of K samples (n_valid valid,
    5 ms apart from 0.3 s, one masked inside), one lane a seed; lane 0's
    window is empty; points timed from before the timeline to after it, 10 %
    masked out."""
    cols = []
    for b in range(lanes):
        rng = np.random.default_rng(100 + b)
        times = (0.3 + 0.005 * np.arange(K)).astype(np.float32)
        gyr = rng.normal(0, 0.5, (K, 3)).astype(np.float32)
        imask = (np.arange(K) < n_valid) & (b > 0)
        imask[n_valid // 2] = False
        xyz = rng.uniform(-60, 60, (n, 3)).astype(np.float32)
        rel = rng.uniform(-0.05, 0.005 * n_valid + 0.05, n).astype(np.float32)
        mask = rng.uniform(size=n) > 0.1
        cols.append((xyz, rel, mask, np.float32(0.31), times, gyr, imask))
    return tuple(torch.from_numpy(np.stack(c)).to(DEV) for c in zip(*cols))


def bench_deskew(args) -> dict:
    """The deskew kernel on the arguments a path gave it: against its plain
    version on the card (bit for bit), against itself, each lane against its
    own launch, and against the plain version on a CPU copy (within
    DESKEW_CPU_M); timed beside the plain version (no single PyTorch call
    deskews: library_ms null). bound_ms counts what the function needs: the
    mask, xyz and the output of every point (a masked-out point is copied),
    the time of a masked-in one, the window, and DESKEW_POINT_OPS a masked-in
    point and DESKEW_SAMPLE_OPS a valid sample."""
    xyz, rel_t, mask, start, times, gyr, imask = args
    B, N = mask.shape

    def kernel():
        return tdsk.deskew(*args)

    k0 = tdsk.kernel_launches()
    out = kernel()
    per_call = tdsk.kernel_launches() - k0
    again = kernel()
    k0 = tdsk.kernel_launches()
    vmapped = torch.func.vmap(tdsk.deskew_frame)(*args)
    per_vmapped_call = tdsk.kernel_launches() - k0
    plain = tdsk.deskew_plain(*args)
    alone = torch.cat([tdsk.deskew(*(t[b:b + 1] for t in args)) for b in range(B)])
    cpu = tdsk.deskew_plain(*(t.cpu() for t in args))
    n_in, n_valid = int(mask.sum()), int(imask.sum())
    (p32, p64), (s32, s64) = DESKEW_POINT_OPS, DESKEW_SAMPLE_OPS
    return dict(
        shape=dict(lanes=B, points=N, points_masked_in=n_in, K=times.shape[1],
                   valid_samples=n_valid), lanes=B,
        kernel_launches_per_call=per_call, kernel_launches_per_vmapped_call=per_vmapped_call,
        vmapped_call_equal=same_bits(out, vmapped),
        max_abs_err=max_abs_err([out], [plain]),
        equal_to_plain=same_bits(out, plain), repeats=same_bits(out, again),
        lanes_equal_one_lane_launches=same_bits(out, alone),
        cpu_max_abs_diff=max_abs_err([out.cpu()], [cpu]),
        finite=bool(torch.isfinite(out[mask]).all()),
        **kernel_ms(kernel),
        # the kernel's own time on the card, apart from the wrapper's host time
        device_ms=device_only_ms(kernel),
        host_parts_us=call_host_parts_us(deskew_host_steps(args), tdsk.deskew, args),
        plain_ms=cuda_ms(lambda: tdsk.deskew_plain(*args), reps=5, warm=1),
        library_ms=None,
        **bound(nbytes([mask, xyz, out, start, times, gyr, imask]) + 4 * n_in,
                p32 * n_in + s32 * n_valid, p64 * n_in + s64 * n_valid),
    )


def phase_deskew(args, label: str) -> dict:
    """The deskew kernel held on the launch a path gave it (capture_kernel_args)
    or on a seeded case: one line, then its checks."""
    res = dict(path=label, **bench_deskew(args))
    emit("kernels_deskew", **res,
         tolerance=f"bit for bit against the plain version on the card, a second launch and "
                   f"one-lane launches; within {DESKEW_CPU_M} m of the plain version on a CPU copy "
                   "(the CPU's sin and cos)")
    what = f"deskew on {label} {res['shape']}"
    check_one_launch(res, what)
    check(res["equal_to_plain"], f"{what}: differs from its plain version by {res['max_abs_err']}")
    check(res["repeats"], f"{what}: two launches differ")
    check(res["lanes_equal_one_lane_launches"], f"{what}: a lane differs from its launch alone")
    check(res["finite"], f"{what}: a masked-in point is not finite")
    check(res["cpu_max_abs_diff"] <= DESKEW_CPU_M,
          f"{what}: {res['cpu_max_abs_diff']} m from the plain version on the CPU")
    return res


def check_one_launch(res: dict, what: str) -> None:
    """One kernel launch a call and a vmapped call, by the library's own
    count, the vmapped call's result the direct one's."""
    check(res["kernel_launches_per_call"] == 1,
          f"{what}: {res['kernel_launches_per_call']} kernel launches a call, not one")
    check(res["kernel_launches_per_vmapped_call"] == 1,
          f"{what}: {res['kernel_launches_per_vmapped_call']} kernel launches a vmapped call, "
          f"not one")
    check(res["vmapped_call_equal"], f"{what}: the vmapped call differs from the direct one")


def seeded_clouds(lanes: int = 8, n: int = BENCH_CAPS["raw_capacity"]):
    """tests/test_torch_ops.py's descriptor recipe a lane (points out to 90 m,
    heights -2..6 m, 10 % masked out), one seed a lane."""
    xs, ms = [], []
    for b in range(lanes):
        rng = np.random.default_rng(200 + b)
        xyz = rng.uniform(-90, 90, (n, 3)).astype(np.float32)
        xyz[:, 2] = rng.uniform(-2, 6, n)
        xs.append(xyz)
        ms.append(rng.uniform(size=n) > 0.1)
    return torch.from_numpy(np.stack(xs)).to(DEV), torch.from_numpy(np.stack(ms)).to(DEV)


def bench_descriptor(args) -> dict:
    """The descriptor kernel on the arguments a path gave it: against its
    plain version on the card (bit for bit), against itself, each lane
    against its own launch, and against the plain version on a CPU copy (the
    share of bins that differ, under SC_CPU_BINS); timed beside the plain
    version and the library's reduction alone (one scatter_reduce(amax) of
    the points' precomputed bins and heights, ops/scancontext.py::
    descriptor_bins). bound_ms counts the mask of every point, the xyz of a
    masked-in one, the output, and SC_POINT_OPS a masked-in point and
    SC_BIN_OPS one within 80 m."""
    xyz, mask = args
    B, N = mask.shape

    def kernel():
        return tsc.descriptors(xyz, mask)

    k0 = tsc.kernel_launches()
    out = kernel()
    per_call = tsc.kernel_launches() - k0
    again = kernel()
    k0 = tsc.kernel_launches()
    vmapped = torch.func.vmap(tsc.make_descriptor)(xyz, mask)
    per_vmapped_call = tsc.kernel_launches() - k0
    plain = tsc.make_descriptor_plain(xyz, mask)
    alone = torch.cat([tsc.descriptors(xyz[b:b + 1], mask[b:b + 1]) for b in range(B)])
    cpu = tsc.make_descriptor_plain(xyz.cpu(), mask.cpu())
    flat, height = tsc.descriptor_bins(xyz, mask)
    base = torch.full((B * tsc.BINS,), -torch.inf, device=DEV)
    n_in = int(mask.sum())
    n_binned = int((flat % tsc.BINS != tsc.BINS - 1).sum())
    return dict(
        shape=dict(lanes=B, points=N, points_masked_in=n_in, points_binned=n_binned), lanes=B,
        kernel_launches_per_call=per_call, kernel_launches_per_vmapped_call=per_vmapped_call,
        vmapped_call_equal=same_bits(out, vmapped),
        max_abs_err=max_abs_err([out], [plain]),
        equal_to_plain=same_bits(out, plain), repeats=same_bits(out, again),
        lanes_equal_one_lane_launches=same_bits(out, alone),
        cpu_bins_differing=float((out.cpu() != cpu).double().mean()),
        finite=bool(torch.isfinite(out).all()),
        **kernel_ms(kernel),
        device_ms=device_only_ms(kernel),
        host_parts_us=call_host_parts_us(descriptor_host_steps(args), tsc.descriptors, args),
        plain_ms=cuda_ms(lambda: tsc.make_descriptor_plain(xyz, mask), reps=5, warm=1),
        library_ms=cuda_ms(lambda: base.scatter_reduce(0, flat, height, "amax", include_self=True),
                           reps=10, batch=20),
        library_call="scatter_reduce(amax) of the precomputed bins (the reduction alone)",
        **bound(nbytes([mask, out]) + 12 * n_in, SC_POINT_OPS * n_in + SC_BIN_OPS * n_binned),
    )


def phase_descriptor(args, label: str) -> dict:
    """The descriptor kernel held on the launch a path gave it or on seeded
    clouds: one line, then its checks."""
    res = dict(path=label, **bench_descriptor(args))
    emit("kernels_scancontext", **res,
         tolerance=f"bit for bit against the plain version on the card, a second launch and "
                   f"one-lane launches; under {SC_CPU_BINS} of the bins differ from the plain "
                   "version on a CPU copy (the CPU's atan2)")
    what = f"make_descriptor on {label} {res['shape']}"
    check_one_launch(res, what)
    check(res["equal_to_plain"], f"{what}: differs from its plain version by {res['max_abs_err']}")
    check(res["repeats"], f"{what}: two launches differ")
    check(res["lanes_equal_one_lane_launches"], f"{what}: a lane differs from its launch alone")
    check(res["finite"], f"{what}: not finite")
    check(res["cpu_bins_differing"] < SC_CPU_BINS,
          f"{what}: {res['cpu_bins_differing']} of the bins differ from the plain version on the CPU")
    return res


# ---------------------------------------------------------------------------
# the scan matcher's GN iteration and ICP's alignment step
# ---------------------------------------------------------------------------

# Operations as the data needs them (an add, sub, mul, div, sqrt, sin, cos,
# asin or atan2 is one): a plane fit ~850 float32 (the centroid 36, the
# scatter matrix 78, 15 Jacobi rotations of ~43, the plane and its residuals
# ~50) for every point that passes its mask and the 5th-NN gate; ~95 more
# for a selected point (its row of J, b, the 27 products); 15 (its world
# position) and 28 (the sums) for every point. A GN step: ~12400 float64
# on a first iteration (120 Jacobi rotations of ~100, the projection), ~220
# on a later one (the LU, the step); 15 a point moved. ICP: 28 a
# correspondence (both passes' products and sums), ~2400 float64 a lane
# (Horn's matrix, 36 Jacobi rotations, the composition, the euler angles).
FIT_OPS, ROW_OPS, POINT_OPS, MOVE_OPS = 850, 95, 43, 15
UPDATE_FIRST_OPS, UPDATE_OPS = 12400, 220
ICP_PAIR_OPS, HORN_OPS = 28, 2400
EIGH_SLICE = 16384  # cuSOLVER's batched eigh refuses 32768 or more [3, 3] matrices (H100, CUDA 12.8)


def nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


def rows_read(idx, valid, m: int) -> int:
    """Distinct rows (lane, index) of a [B, m, 3] table that the valid
    entries of idx [B, N, k] read."""
    lane = torch.arange(idx.shape[0], device=idx.device).view(-1, *([1] * (idx.dim() - 1)))
    return int(torch.unique((lane * m + idx.long())[valid]).numel())


def flat(out) -> tuple:
    """An update's or alignment's (state, moved, flag) as one tuple."""
    return (*out[0], out[1], out[2])


def max_abs_err(out, ref) -> float:
    return max(float((o.double() - r.double()).abs().nan_to_num(0.0).max()) if o.numel() else 0.0
               for o, r in zip(out, ref))


def bound(bytes_moved: int, f32_ops: int, f64_ops: int = 0) -> dict:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = f32_ops / FP32_FLOP_PER_S + f64_ops / FP64_FLOP_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=bytes_moved, flops=dict(float32=f32_ops, float64=f64_ops))


def scatter_matrices(args):
    """The [B * N, 3, 3] scatter matrices of a linearization's neighbourhoods
    (the old route's input to the library eigh)."""
    pose, scan, mask, nq, d2, idx, gxyz = args[:7]
    B, N = mask.shape
    gate = d2[..., 4] < args[7] * args[7]
    w = (torch.isfinite(d2) & gate[..., None]).to(torch.float32).reshape(B * N, 5, 1)
    nb = torch.gather(gxyz, 1, idx.long().reshape(B, N * 5, 1).expand(-1, -1, 3)).reshape(B * N, 5, 3)
    cnt = w.sum(1).clamp(min=1.0)
    c = (nb - (nb * w).sum(1, keepdim=True) / cnt[:, None]) * w
    return c.transpose(1, 2) @ c / cnt[:, :, None]


def bench_scan_linearize(args) -> dict:
    """The linearization kernel on the arguments a path gave it: against its
    plain version on the card (bit for bit), itself, each lane's own launch;
    timed beside the plain version and the old route's library call, one
    batched eigh of the scatter matrices (in slices of EIGH_SLICE)."""
    B, N = args[2].shape
    M = args[6].shape[1]

    def kernel():
        return sgn._launch_linearize(*args)

    k0 = sgn.kernel_launches()
    out = kernel()
    per_call = sgn.kernel_launches() - k0
    again = kernel()
    plain = sgn.scan_linearize_plain(*args)
    alone = [sgn._launch_linearize(*(t[b:b + 1] for t in args[:7]), *args[7:]) for b in range(B)]
    d2, idx = args[4], args[5]
    gate = d2[..., 4] < args[7] * args[7]
    fits, sel = int((args[2] & gate).sum()), int(out[2].sum())
    used = torch.isfinite(d2) & gate[..., None]
    S = scatter_matrices(args)
    return dict(
        shape=dict(lanes=B, points=N, grid=M), lanes=B, fits=fits, selected=sel,
        kernel_launches_per_call=per_call, max_abs_err=max_abs_err(out, plain),
        equal_to_plain=all(same_bits(o, p) for o, p in zip(out, plain)),
        repeats=all(same_bits(o, a) for o, a in zip(out, again)),
        lanes_equal_one_lane_launches=all(
            same_bits(o, torch.cat([x[k] for x in alone])) for k, o in enumerate(out)),
        finite=all(bool(torch.isfinite(o).all()) for o in out[:2]),
        **kernel_ms(kernel), device_ms=device_only_ms(kernel),
        plain_ms=cuda_ms(lambda: sgn.scan_linearize_plain(*args), reps=5, warm=1),
        library_ms=cuda_ms(lambda: [torch.linalg.eigh(c) for c in torch.split(S, EIGH_SLICE)],
                           reps=5, warm=1),
        library_call=f"torch.linalg.eigh of the [{B * N}, 3, 3] scatter matrices"
                     + (f", in slices of {EIGH_SLICE}" if B * N > EIGH_SLICE else ""),
        **bound(nbytes(args[:6]) + 12 * rows_read(idx, used, M) + nbytes(out),
                FIT_OPS * fits + ROW_OPS * sel + POINT_OPS * B * N),
    )


def bench_scan_update(args) -> dict:
    """The update kernel on the arguments a path gave it (its state, H, g,
    count, scan, params, first): against its plain version on the card (bit
    for bit), itself, each lane's own launch; timed beside the plain version
    and torch.linalg.solve of the damped systems (the library call it
    replaced; the first iteration's eigh went with it)."""
    state, H, g, cnt, scan, params, first = args
    B, N = scan.shape[:2]

    def kernel():
        return sgn._launch_update(*args)

    k0 = sgn.kernel_launches()
    out = flat(kernel())
    per_call = sgn.kernel_launches() - k0
    again = flat(kernel())
    plain = flat(sgn.scan_update_plain(*args))
    alone = [flat(sgn._launch_update(sgn.GNState(*(t[b:b + 1] for t in state)), H[b:b + 1],
                                     g[b:b + 1], cnt[b:b + 1], scan[b:b + 1], params, first))
             for b in range(B)]
    lane_outs = range(len(out) - 1)  # the all-done flag is the lanes' together
    A = H + torch.eye(6, device=H.device) * 1e-6
    Hd = H.double()
    solve_ms = cuda_ms(lambda: torch.linalg.solve(A, g), reps=5, warm=1)
    return dict(
        shape=dict(lanes=B, points=N, first=bool(first)), lanes=B,
        kernel_launches_per_call=per_call, max_abs_err=max_abs_err(out, plain),
        equal_to_plain=all(same_bits(o, p) for o, p in zip(out, plain)),
        repeats=all(same_bits(o, a) for o, a in zip(out, again)),
        lanes_equal_one_lane_launches=all(
            same_bits(out[k], torch.cat([x[k] for x in alone])) for k in lane_outs),
        finite=bool(torch.isfinite(out[0]).all()),
        **kernel_ms(kernel), device_ms=device_only_ms(kernel),
        plain_ms=cuda_ms(lambda: sgn.scan_update_plain(*args), reps=5, warm=1),
        library_ms=(cuda_ms(lambda: torch.linalg.eigh(Hd), reps=5, warm=1) if first else solve_ms),
        library_call=(f"torch.linalg.eigh of the [{B}, 6, 6] float64 systems" if first
                      else f"torch.linalg.solve of [{B}, 6, 6] float32"),
        solve_ms=solve_ms, solve_call=f"torch.linalg.solve of [{B}, 6, 6] float32",
        **bound(nbytes((*state, H, g, cnt, scan)) + nbytes(out),
                MOVE_OPS * B * N, B * (UPDATE_FIRST_OPS if first else UPDATE_OPS)),
    )


def bench_transform(args) -> dict:
    """The scan moved by its pose, the kernel on the arguments a path gave it:
    against its plain version on the card (bit for bit), itself, each lane's
    own launch; timed beside the plain version and the route it replaced
    (se3.euler_to_rot, a batched product and an add; no one PyTorch call
    forms R from the euler angles: library_ms null)."""
    pose, xyz = args
    B, N = xyz.shape[:2]

    def kernel():
        return sgn._launch_transform(*args)

    def old_route():
        return xyz @ se3.euler_to_rot(pose[:, :3]).transpose(-1, -2) + pose[:, None, 3:]

    k0 = sgn.kernel_launches()
    out = kernel()
    per_call = sgn.kernel_launches() - k0
    again, plain = kernel(), sgn.transform_plain(*args)
    alone = torch.cat([sgn._launch_transform(pose[b:b + 1], xyz[b:b + 1]) for b in range(B)])
    return dict(
        shape=dict(lanes=B, points=N), lanes=B, kernel_launches_per_call=per_call,
        max_abs_err=max_abs_err([out], [plain]),
        equal_to_plain=same_bits(out, plain), repeats=same_bits(out, again),
        lanes_equal_one_lane_launches=same_bits(out, alone),
        old_route_max_abs_diff=float((out - old_route()).abs().max()),
        finite=bool(torch.isfinite(out).all()),
        **kernel_ms(kernel), device_ms=device_only_ms(kernel),
        plain_ms=cuda_ms(lambda: sgn.transform_plain(*args), reps=5, warm=1),
        op_by_op_ms=cuda_ms(old_route, reps=5, warm=1),
        op_by_op_call="xyz @ se3.euler_to_rot(pose).T + t (the route the kernel replaced)",
        library_ms=None, library_call=None,
        **bound(nbytes(args) + nbytes([out]), MOVE_OPS * B * N),
    )


def phase_scan_gn(cases: dict, label: str) -> dict:
    """The scan matcher's two kernels held on the last launches a path gave
    them (capture_kernel_args): one line a path, then its checks."""
    check(all(k in cases for k in ("scan_linearize", "scan_update_first", "transform")),
          f"{label}: no scan_linearize / first scan_update / transform launch captured: "
          f"{sorted(cases)}")
    res = {"scan_linearize": bench_scan_linearize(cases.pop("scan_linearize")),
           "scan_update_first": bench_scan_update(cases.pop("scan_update_first")),
           "transform": bench_transform(cases.pop("transform"))}
    if "scan_update" in cases:
        res["scan_update"] = bench_scan_update(cases.pop("scan_update"))
    emit("kernels_scan_gn", path=label, **res,
         tolerance="bit for bit against the plain versions on the card (NaN where it is NaN), "
                   "against a second launch and, lane by lane, against one-lane launches; one "
                   "kernel launch a call")
    for name, r in res.items():
        what = f"{name} on {label} {r['shape']}"
        check(r["equal_to_plain"], f"{what}: differs from its plain version by {r['max_abs_err']}")
        check(r["repeats"], f"{what}: two launches differ")
        check(r["lanes_equal_one_lane_launches"], f"{what}: a lane differs from its launch alone")
        check(r["finite"], f"{what}: not finite")
        check(r["kernel_launches_per_call"] == 1,
              f"{what}: {r['kernel_launches_per_call']} kernel launches a call, not one")
    return res


def bench_icp_align(args) -> dict:
    """ICP's alignment kernel on the arguments a path gave it: against its
    plain version on the card (bit for bit), itself, each lane's own launch;
    timed beside the plain version and torch.linalg.svd of the lanes'
    cross-covariances (the library call it replaced, with a det)."""
    state, moved, d2, idx, target, mask, source, max_d2, eps = args
    B, N = mask.shape
    M = target.shape[1]

    def kernel():
        return ialign._launch_align(*args)

    out, again = flat(kernel()), flat(kernel())
    plain = flat(ialign.icp_align_plain(*args))
    alone = [flat(ialign._launch_align(ialign.ICPState(*(t[b:b + 1] for t in state)),
                                       *(t[b:b + 1] for t in args[1:7]), max_d2, eps))
             for b in range(B)]
    ok = mask & torch.isfinite(d2[..., 0]) & (d2[..., 0] < max_d2)
    w = ok.to(torch.float32)[..., None]
    mt = torch.gather(target, 1, idx.long().expand(-1, -1, 3))
    wsum = w.sum(1).clamp(min=1.0)
    S = ((mt - (mt * w).sum(1, keepdim=True) / wsum[:, None]) * w).transpose(1, 2) @ (
        moved - (moved * w).sum(1, keepdim=True) / wsum[:, None])
    pairs = int(ok.sum())
    return dict(
        shape=dict(lanes=B, source=N, target=M), lanes=B, correspondences=pairs,
        max_abs_err=max_abs_err(out, plain),
        equal_to_plain=all(same_bits(o, p) for o, p in zip(out, plain)),
        repeats=all(same_bits(o, a) for o, a in zip(out, again)),
        lanes_equal_one_lane_launches=all(
            same_bits(out[k], torch.cat([x[k] for x in alone])) for k in range(len(out) - 1)),
        finite=bool(torch.isfinite(out[0]).all()),
        **kernel_ms(kernel), device_ms=device_only_ms(kernel),
        plain_ms=cuda_ms(lambda: ialign.icp_align_plain(*args), reps=5, warm=1),
        library_ms=cuda_ms(lambda: torch.linalg.svd(S), reps=5, warm=1),
        library_call=f"torch.linalg.svd of [{B}, 3, 3] float32",
        **bound(nbytes((*state, moved, d2, idx, mask, source)) + 12 * rows_read(idx, ok[..., None], M)
                + nbytes(out), MOVE_OPS * B * N + ICP_PAIR_OPS * pairs, HORN_OPS * B),
    )


def phase_icp_align(cases: dict, label: str) -> dict:
    """ICP's alignment kernel held on the last launch a path gave it
    (capture_kernel_args): one line a path, then its checks."""
    check("icp_align" in cases, f"{label}: no icp_align launch captured: {sorted(cases)}")
    res = bench_icp_align(cases.pop("icp_align"))
    emit("kernels_icp_align", path=label, **res,
         tolerance="bit for bit against the plain version on the card (NaN where it is NaN), "
                   "against a second launch and, lane by lane, against one-lane launches")
    what = f"icp_align on {label} {res['shape']}"
    check(res["equal_to_plain"], f"{what}: differs from its plain version by {res['max_abs_err']}")
    check(res["repeats"], f"{what}: two launches differ")
    check(res["lanes_equal_one_lane_launches"], f"{what}: a lane differs from its launch alone")
    check(res["finite"], f"{what}: not finite")
    return res


FUSION_PHASES = ("setup_whitening", "build_system", "qr", "back_substitution_retracts", "h",
                 "lu", "inverse_b_schur", "cholesky_outputs")


def phase_fusion_profile(args, label: str) -> None:
    """Not in the default run. The fusion kernel rebuilt with
    -DLIORF_FUSION_PROFILE on the last launch a path gave it: clock cycles
    block 0's first thread spends in each phase (summed over the GN
    iterations), their shares, and the profiling build's device time; its
    outputs held bit for bit against the plain version."""
    import ctypes

    fstep._lib = None
    try:
        lib = fstep.load_library(("-DLIORF_FUSION_PROFILE",))
        lib.liorf_fusion_profile.argtypes = [ctypes.c_void_p]
        lib.liorf_fusion_profile.restype = ctypes.c_int
        out = fstep._launch(*args)
        plain = fstep.fusion_step_plain(*args)
        check(all(same_bits(o, p) for o, p in zip(out, plain)),
              "fusion_profile: the profiling build differs from the plain version")
        ms = device_only_ms(lambda: fstep._launch(*args))
        fstep._launch(*args)
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * len(FUSION_PHASES))()
        check(lib.liorf_fusion_profile(ctypes.addressof(buf)) == 0, "reading the profile failed")
    finally:
        fstep._lib = None  # the next user builds the library without the profile
    cycles = {name: buf[j] for j, name in enumerate(FUSION_PHASES)}
    total = sum(cycles.values())
    emit("fusion_profile", path=label, lanes=int(args[0].shape[0]), gn_iters=int(args[-1]),
         cycles=cycles, total_cycles=total,
         share={k: v / total for k, v in cycles.items()}, device_ms=ms,
         note="cycles of block 0's thread 0 in the last launch, each phase closed by a block "
              "barrier (the profiling build; its times are the plain build's only roughly)")


def phase_scan_gn_parent(cases: dict, label: str, parent: str) -> None:
    """Not in the default run. The scan matcher's two calls of an older
    checkout (``--parent DIR``: its ops/scan_gn.py as a module of its own,
    parent_module, its kernels built from DIR's csrc/scan_gn.cu) run on the
    last launches a path gave this one's (capture_kernel_args): each output
    bit for bit against this tree's, and the device time of both, in turns
    (parent, this, this, parent)."""
    old = parent_module(parent, "scan_gn")
    calls = {"scan_linearize": (old._launch_linearize, sgn._launch_linearize, lambda o: o),
             "scan_update_first": (old._launch_update, sgn._launch_update, flat),
             "scan_update": (old._launch_update, sgn._launch_update, flat)}
    res = {}
    for name, (old, new, f) in calls.items():
        if name not in cases:
            continue
        args = cases[name]
        same = all(same_bits(o, p) for o, p in zip(f(new(*args)), f(old(*args))))
        turns = [("parent", old), ("this", new), ("this", new), ("parent", old)]
        times = [(who, device_only_ms(lambda fn=fn: fn(*args))) for who, fn in turns]
        res[name] = dict(equal_to_parent=same, turns=times,
                         parent_ms=statistics.median(t for w, t in times if w == "parent"),
                         this_ms=statistics.median(t for w, t in times if w == "this"))
    emit("scan_gn_parent", path=label, parent=parent, **res,
         note="device time of one call from an idle device (device_only_ms), in turns")
    for name, r in res.items():
        check(r["equal_to_parent"], f"scan_gn_parent: {name} differs from the parent's")


SCAN_GN_PROFILE = {  # csrc/scan_gn.cu's profile slots a call, by phase
    "scan_linearize": dict(prologue=0, loads_and_gathers=1, plane_jacobi=2, row_and_terms=3,
                           tile_tree=4, tiles_tree=5, tiles_tree_loads=14),
    "scan_update": dict(jacobi=6, lu=7, substitution=8, p=9, projection_and_step=10, writes=11,
                        moved_scan=12, all_done=13),
}
SCAN_GN_PROFILE_SLOTS = 15


def nvcc_report(source: str, flags: tuple[str, ...] = ()) -> dict:
    """ptxas' registers, stack and spills of every function of ``source``
    (kernels and the device functions they call) and the SASS instruction
    count of every kernel, from one nvcc run with -Xptxas -v and cuobjdump
    -sass on its library."""
    import re

    nvcc = build.find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "report.so")
        proc = subprocess.run([nvcc, *build.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-o", so, source],
                              capture_output=True, text=True)
        check(proc.returncode == 0, f"nvcc failed on {source}: {proc.stderr[-2000:]}")
        sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True).stdout
    out, name, props = {}, None, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and props:
            out.setdefault(props, {}).update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})["sass_instructions"] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            out[name]["sass_instructions"] += 1
    return {k: v for k, v in out.items() if v}


def phase_scan_gn_profile(cases: dict, label: str) -> None:
    """Not in the default run. The scan matcher's kernels rebuilt with
    -DLIORF_SCAN_GN_PROFILE on the last launches a path gave them
    (capture_kernel_args): clock cycles a phase (SCAN_GN_PROFILE) of the
    profiling thread of the lane's first block, of the linearization, the
    first and a later update, each held bit for bit against its plain
    version, and the profiling build's device time; then ptxas' registers
    and spills and the SASS size of every kernel of the plain build."""
    import ctypes

    calls = {"scan_linearize": (sgn._launch_linearize, sgn.scan_linearize_plain, "scan_linearize"),
             "scan_update_first": (sgn._launch_update, sgn.scan_update_plain, "scan_update"),
             "scan_update": (sgn._launch_update, sgn.scan_update_plain, "scan_update")}
    res = {}
    sgn._lib = None
    try:
        lib = sgn.load_library(("-DLIORF_SCAN_GN_PROFILE",))
        lib.liorf_scan_gn_profile.argtypes = [ctypes.c_void_p]
        lib.liorf_scan_gn_profile.restype = ctypes.c_int
        for name, (launch, plain, kind) in calls.items():
            if name not in cases:
                continue
            args = cases[name]
            got, want = launch(*args), plain(*args)
            flat_got = flat(got) if kind == "scan_update" else got
            flat_want = flat(want) if kind == "scan_update" else want
            check(all(same_bits(o, p) for o, p in zip(flat_got, flat_want)),
                  f"scan_gn_profile: the profiling build's {name} differs from its plain version")
            ms = device_only_ms(lambda: launch(*args))
            launch(*args)
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * SCAN_GN_PROFILE_SLOTS)()
            check(lib.liorf_scan_gn_profile(ctypes.addressof(buf)) == 0, "reading the profile failed")
            cycles = {ph: buf[j] for ph, j in SCAN_GN_PROFILE[kind].items()}
            res[name] = dict(cycles=cycles, device_ms=ms)
    finally:
        sgn._lib = None  # the next user builds the library without the profile
    emit("scan_gn_profile", path=label, **res, build=nvcc_report(SCAN_GN_SOURCE),
         note="cycles of each call's profiling thread in its last launch (the lane's first "
              "block; the tiles' tree by the last block), each stamp after the phase's results "
              "are used (the profiling build; its times are the plain build's only roughly)")


def host_us(fn, reps: int = 100, rounds: int = 5) -> float:
    """Host time of one fn() in microseconds: the median over ``rounds`` of
    ``reps`` calls back to back, the device drained between rounds."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def linearize_host_steps(args) -> dict:
    """The linearization's host steps on ``args``, each a call of its own,
    from ops/linearize.py's helpers: the checks, the one allocation with its
    views, the addresses, the ctypes call with its launch, the direct call."""
    ins = lin._checked(args)
    dev = ins[0].device
    B, K = ins[0].shape[:2]
    E, G = ins[2].shape[1], ins[9].shape[1]
    lib = lin.load_library()
    out = lin._buffer(B, K, E, G, dev, False)  # held: the timed launches write into it
    ptrs = [t.data_ptr() for t in ins] + out[2]
    return dict(checks=lambda: lin._checked(args),
                allocation=lambda: lin._buffer(B, K, E, G, dev, False),
                addresses=lambda: [t.data_ptr() for t in ins],
                ctypes_call_and_launch=lambda: (out, lin._run(lib, ptrs, B, K, E, G, dev)),
                direct=lambda: lin._launch(*args))


def preintegrate_host_steps(args) -> dict:
    """The preintegration's host steps on ``args``, as linearize_host_steps,
    from ops/preintegrate.py's helpers."""
    tensors, noise = args[:6], args[6:]
    ins = tpop._checked(*tensors)
    B, K = tensors[2].shape
    dev = tensors[0].device
    lib = tpop.load_library()
    out = tpop._outputs(B, dev, False)  # held: the timed launches write into it
    ptrs = [t.data_ptr() for t in ins] + out[1]
    return dict(checks=lambda: tpop._checked(*tensors),
                allocation=lambda: tpop._outputs(B, dev, False),
                addresses=lambda: [t.data_ptr() for t in ins],
                ctypes_call_and_launch=lambda: (out, tpop._run(lib, ptrs, *noise, K, B, dev)),
                direct=lambda: tpop._launch(*args))


def deskew_host_steps(args) -> dict:
    """The deskew's host steps on ``args``, as linearize_host_steps, from
    ops/deskew.py's helpers."""
    ins = tdsk._checked(*args)
    B, N = args[0].shape[:2]
    K = args[4].shape[1]
    dev = args[0].device
    lib = tdsk.load_library()
    out = torch.empty((B, N, 3), dtype=torch.float32, device=dev)  # held: the launches write it
    ptrs = tdsk._addresses(ins, out)
    return dict(checks=lambda: tdsk._checked(*args),
                allocation=lambda: torch.empty((B, N, 3), dtype=torch.float32, device=dev),
                addresses=lambda: tdsk._addresses(ins, out),
                ctypes_call_and_launch=lambda: tdsk._run(lib, ptrs, N, K, B, dev),
                direct=lambda: tdsk._launch(*args))


def descriptor_host_steps(args) -> dict:
    """The descriptor's host steps on ``args``, as linearize_host_steps,
    from ops/scancontext.py's helpers (the addresses with the lanes'
    scratch)."""
    ins = tsc._checked(*args)
    B, N = args[1].shape
    dev = args[0].device
    lib = tsc.load_library()
    out = torch.empty((B, tsc.NUM_RING, tsc.NUM_SECTOR), dtype=torch.float32, device=dev)
    stream = build.raw_stream(dev.index)
    ptrs = [t.data_ptr() for t in ins] + [out.data_ptr(), *tsc.lane_scratch(dev, B, stream)]
    return dict(checks=lambda: tsc._checked(*args),
                allocation=lambda: torch.empty((B, tsc.NUM_RING, tsc.NUM_SECTOR),
                                               dtype=torch.float32, device=dev),
                addresses=lambda: [t.data_ptr() for t in ins]
                + [*tsc.lane_scratch(dev, B, build.raw_stream(dev.index))],
                ctypes_call_and_launch=lambda: tsc._run(lib, ptrs, N, B, dev, stream),
                direct=lambda: tsc._launch(*args))


def call_host_parts_us(steps: dict, public, args) -> dict:
    """A wrapper's host time on these arguments split into its ``steps``
    (linearize_host_steps, preintegrate_host_steps), beside the public
    call's; ``dispatch`` is the public call less the direct launch (what the
    custom op's dispatch adds)."""
    parts = {k: host_us(f) for k, f in steps.items()}
    parts["public_call"] = host_us(lambda: public(*args))
    parts["dispatch"] = parts["public_call"] - parts["direct"]
    return parts


def phase_kernel_profile(phase, mod, source, define, reader, slots, spans, launch, reference,
                         label) -> None:
    """Not in the default run. A kernel rebuilt with ``define`` (a profiling
    build) on the launch a path gave it: clock cycles a phase (``slots``:
    name -> slot of the library's ``reader``), spans by the global timer in
    ns (``spans``: name -> (first slot, last slot)), held bit for bit against
    ``reference()``, the profiling build's device time, then ptxas' and the
    SASS's sizes of the plain build."""
    import ctypes

    mod._lib = None
    try:
        lib = mod.load_library((define,))
        read = getattr(lib, reader)
        read.argtypes = [ctypes.c_void_p]
        read.restype = ctypes.c_int
        got, want = launch(), reference()
        check(all(same_bits(o.cpu(), p.cpu()) for o, p in zip(got, want)),
              f"{phase}: the profiling build differs from its plain version")
        ms = device_only_ms(launch)
        n = 1 + max([*slots.values(), *(j for pair in spans.values() for j in pair)])
        buf = (ctypes.c_longlong * n)()
        torch.cuda.synchronize()
        check(read(ctypes.addressof(buf)) == 0, "reading the profile failed")  # resets it
        launch()
        torch.cuda.synchronize()
        check(read(ctypes.addressof(buf)) == 0, "reading the profile failed")
    finally:
        mod._lib = None  # the next user builds the library without the profile
    emit(phase, path=label, cycles={k: buf[j] for k, j in slots.items()},
         spans_ns={k: buf[b] - buf[a] for k, (a, b) in spans.items()}, device_ms=ms,
         build=nvcc_report(source),
         note="cycles of the profiling thread in the last launch, each lap taken after the "
              "phase's results are used; spans by %globaltimer (the profiling build; its times "
              "are the plain build's only roughly)")


# csrc/linearize.cu's and csrc/preintegrate.cu's profile slots, by phase
LINEARIZE_PROFILE = dict(factor_loads_p_q_u=0, log_value=1, direction_and_shuffles=2, weights=3,
                         both_j_stored=4, both_rows_sums=5, later_factor_slots=6,
                         key_warp_pass_and_copy=7, cluster_barrier=8, flag_bits=9,
                         node0_walk_and_sums=10)
LINEARIZE_SPANS = dict(launch=(11, 12))
PREINT_PROFILE = dict(window_end_and_first_rotations=0, later_rotations=1, prefix_and_inputs=2,
                      leaf_segments=3,
                      level_1=4, level_2=5, level_3=6, level_4=7, level_5=8, level_6=9,
                      window_compose=10, outputs=11)
PREINT_SPANS = dict(launch=(12, 13))


def linearize_reference(args) -> tuple:
    """The plain linearization of ``args`` on a CPU copy's order: phase A on
    the card, the node sums in the plan's order on the CPU."""
    B, K = args[0].shape[:2]
    Ji, Jj, Jg, Jp, rows_p = lin.factor_rows_plain(*args[:18])
    sums = segsum.segment_sum_plain(rows_p.cpu(), args[19].cpu(), args[18].cpu(), K)
    return (sums[..., :6], sums[..., 6:].reshape(B, K, 6, 6), Ji.cpu(), Jj.cpu(), Jg.cpu(),
            Jp.cpu())


def phase_linearize_profile(args, label: str) -> None:
    """Not in the default run: the linearization's cycles a phase on the
    main path's last launch (a profiling build of csrc/linearize.cu)."""
    phase_kernel_profile("linearize_profile", lin, LINEARIZE_SOURCE, "-DLIORF_LINEARIZE_PROFILE",
                         "liorf_linearize_profile", LINEARIZE_PROFILE, LINEARIZE_SPANS,
                         lambda: lin._launch(*args), lambda: linearize_reference(args), label)


def phase_preintegrate_profile(args, label: str) -> None:
    """Not in the default run: the preintegration's cycles a phase on the
    main path's last launch (a profiling build of csrc/preintegrate.cu)."""
    phase_kernel_profile("preintegrate_profile", tpop, PREINT_SOURCE,
                         "-DLIORF_PREINTEGRATE_PROFILE", "liorf_preintegrate_profile",
                         PREINT_PROFILE, PREINT_SPANS, lambda: tpop._launch(*args),
                         lambda: tpop.preintegrate_plain(*args), label)


# csrc/deskew.cu's and csrc/scancontext.cu's profile slots, by phase
DESKEW_PROFILE = dict(point_loads_issued=0, timeline_loads=1, prefix=2, r0_on_warp0=3, barrier=4,
                      point=6, point_thread_wait=5, point_thread_math=7)
DESKEW_SPANS = dict(launch=(8, 9), blocks_starting=(8, 10), blocks_ending=(11, 9))
SC_PROFILE = dict(load_issued_bins_set=0, point_loads=1, point_bin=2, shared_atomic=3,
                  block_barrier=4, merge=5, arrival=6, last_block=7)
SC_SPANS = dict(launch=(8, 9))


def phase_front_profile(deskew_cases: dict, descriptor_cases: dict) -> None:
    """Not in the default run: the deskew's and the descriptor's cycles a
    phase (profiling builds of csrc/deskew.cu and csrc/scancontext.cu) on
    each of their cases (label -> args: the main path's last launches and
    seeded ones), each held bit for bit against its plain version."""
    for case, args in deskew_cases.items():
        phase_kernel_profile("deskew_profile", tdsk, DESKEW_SOURCE, "-DLIORF_DESKEW_PROFILE",
                             "liorf_deskew_profile", DESKEW_PROFILE, DESKEW_SPANS,
                             lambda: (tdsk._launch(*args),), lambda: (tdsk.deskew_plain(*args),),
                             case)
    for case, args in descriptor_cases.items():
        phase_kernel_profile("descriptor_profile", tsc, SC_SOURCE, "-DLIORF_SCANCONTEXT_PROFILE",
                             "liorf_scancontext_profile", SC_PROFILE, SC_SPANS,
                             lambda: (tsc._launch(*args),),
                             lambda: (tsc.make_descriptor_plain(*args),), case)


_PARENT_MODULES = {}


def parent_module(parent: str, name: str):
    """``ops/<name>.py`` of an older checkout (``--parent DIR``) as a module
    of its own (once a process): its custom op renamed (one name registers
    once a process), its relative imports resolved in this tree's package,
    its kernel built from DIR's csrc/."""
    import types
    from pathlib import Path

    if (parent, name) in _PARENT_MODULES:
        return _PARENT_MODULES[parent, name]
    path = Path(parent) / "liorf_tpu_torch" / "ops" / f"{name}.py"
    check(path.is_file(), f"the parent phases need --parent DIR with {path}")
    mod = types.ModuleType(f"liorf_parent_{name}")
    mod.__file__, mod.__package__ = str(path), "liorf_tpu_torch.ops"
    src = path.read_text().replace("liorf_tpu_torch::", "liorf_parent::")
    exec(compile(src, str(path), "exec"), mod.__dict__)
    _PARENT_MODULES[parent, name] = mod
    return mod


# the public call of each ops module that kernels_parent compares
PARENT_CALLS = {"linearize": "linearize_normal", "preintegrate": "preintegrate",
                "deskew": "deskew", "scancontext": "descriptors"}


def _outputs_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def phase_kernels_parent(cases: dict, parent: str) -> None:
    """Not in the default run. The linearization's, the preintegration's,
    the deskew's and the descriptor's public calls of an older checkout
    (``--parent DIR``) beside this tree's, on the arguments of ``cases``
    (name -> (ops module name, label, args)): every output against this
    tree's (bit for bit; the signs of zeros apart), then device time and the
    call back to back and from an idle device, in turns (parent, this, this,
    parent)."""
    this = {"linearize": lin, "preintegrate": tpop, "deskew": tdsk, "scancontext": tsc}
    res = {}
    for name, (mod_name, label, args) in cases.items():
        old = getattr(parent_module(parent, mod_name), PARENT_CALLS[mod_name])
        new = getattr(this[mod_name], PARENT_CALLS[mod_name])
        got, want = _outputs_tuple(new(*args)), _outputs_tuple(old(*args))
        turns = []
        for who, fn in (("parent", old), ("this", new), ("this", new), ("parent", old)):
            f = (lambda fn=fn: fn(*args))
            turns.append(dict(who=who, device_ms=device_only_ms(f), **kernel_ms(f)))
        res[name] = dict(
            path=label, equal_to_parent=all(same_bits(x, y) for x, y in zip(got, want)),
            zero_signs_equal=all(bool((torch.signbit(x) == torch.signbit(y)).all())
                                 for x, y in zip(got, want) if x.is_floating_point()),
            turns=turns,
            **{f"{who}_{k}": statistics.median(t[k] for t in turns if t["who"] == who)
               for who in ("parent", "this") for k in ("device_ms", "ms", "ms_single_call")})
    emit("kernels_parent", parent=parent, **res,
         note="device_ms: device_only_ms; ms: 20 calls back to back; ms_single_call: one call "
              "from an idle device; the medians of each side's two turns")
    for name, r in res.items():
        check(r["equal_to_parent"], f"kernels_parent: {name} differs from the parent's")


PCG_PHASES = ("tree_rz", "p_own", "edges", "gps_prior", "sync1", "node_sums", "sync2",
              "tree_pap", "x_r", "precond", "sync3")


def random_graph(K: int, n: int, E: int, G: int, seed: int):
    """A noisy chain of n keyframes in K node slots, three loop edges and
    G - 1 GPS fixes in E / G factor slots, the rest unused (as
    tests/test_torch_pcg.py draws them), on the card."""
    g = torch.Generator().manual_seed(seed)
    truth = torch.cumsum(torch.randn((K, 3), generator=g), 0)
    e_i, e_j = torch.zeros(E, dtype=torch.int64), torch.zeros(E, dtype=torch.int64)
    e_i[: n - 1], e_j[: n - 1] = torch.arange(n - 1), torch.arange(1, n)
    e_i[n - 1: n + 2], e_j[n - 1: n + 2] = torch.tensor([0, 1, 2]), torch.tensor([n - 1, n - 2, n - 3])
    gi = torch.randint(0, n, (G,), generator=g)
    graph = pg.empty_graph(K, E, G, device="cpu")._replace(
        ts=truth + 0.3 * torch.randn((K, 3), generator=g),
        Rs=se3.so3_exp(0.1 * torch.randn((K, 3), generator=g)),
        node_mask=torch.arange(K) < n, e_i=e_i, e_j=e_j,
        e_tm=truth[e_j] - truth[e_i] + 0.01 * torch.randn((E, 3), generator=g),
        e_mask=torch.arange(E) < n + 2, e_cauchy=(torch.arange(E) == n - 1).float(),
        g_i=gi, g_t=truth[gi], g_mask=torch.arange(G) < G - 1)
    return graph._replace(**{k: v.to(DEV) for k, v in graph._asdict().items()})


# the PCG's shapes: the main path's window solve, the resident full solve,
# the 8-lane multistream tick (label, lanes, node slots, used nodes, edge
# and GPS slots, iterations)
PCG_SHAPES = (("main window", 1, 256, 224, 256, 16, 32),
              ("resident full solve", 1, 1024, 900, 1152, 256, 64),
              ("multistream tick", 8, 128, 100, 144, 16, 16))


def pcg_shape_args(lanes: int, K: int, n: int, E: int, G: int) -> list:
    """pcg_solve's arguments for the first GN step of ``lanes`` random graphs
    (random_graph, seeds 3, 4, ...), stacked on a lane axis."""
    lane_args = []
    for b in range(lanes):
        graph = random_graph(K, n, E, G, seed=3 + b)
        rhs, diag, t = pg._build_normal_terms(graph, graph.node_mask)
        keys, perm = t.plan.sorted_rows()
        lane_args.append((t.Ji, t.Jj, t.Jg, t.Jp, t.e_i, t.e_j, t.g_i, t.p_i, keys, perm,
                          pg._block_jacobi(diag, 1e-4), rhs))
    return [torch.stack(v) for v in zip(*lane_args)]


PCG_CLUSTERS = (1, 2, 4, 8)  # the cluster sizes a launch may take
# how z and p reach a factor's endpoints: replicated in every block (the
# kernel), or read from their owner's block (a development build)
PCG_EXCHANGES = (("replicated", ()), ("remote_reads", ("-DLIORF_PCG_REMOTE_P",)))


def phase_pcg_profile(captured=None) -> None:
    """Not in the default run. The PCG kernel at its three shapes
    (PCG_SHAPES): first every cluster size (on chip where the lane fits,
    else device memory), timed back to back and held bit for bit against
    the default launch (the table behind pcg.CLUSTER); then, at the default
    cluster, z and p replicated in every block (the kernel) against read at
    a factor's endpoints from their owner's block (-DLIORF_PCG_REMOTE_P):
    each timed in its plain build and held bit for bit against the default
    launch, then rebuilt with -DLIORF_PCG_PROFILE: clock cycles block 0's
    first thread spends in each phase of an iteration (summed, divided by
    the iterations). ``captured``: the main path's own launches
    (capture_kernel_args), held and profiled beside the random graphs."""
    import ctypes

    lib = pcg.load_library()
    cases = [(label, pcg_shape_args(lanes, K, n, E, G), iters, 1e-4)
             for label, lanes, K, n, E, G, iters in PCG_SHAPES]
    cases += [(f"main path {key} (its own arguments)", *case)
              for key, case in sorted((captured or {}).items())]
    refs = [pcg._launch(*args, iters, damping) for _, args, iters, damping in cases]
    table = []
    for (label, args, iters, damping), ref in zip(cases, refs):
        B, K, _ = args[11].shape
        E, G = args[0].shape[1], args[2].shape[1]
        for cluster in PCG_CLUSTERS:
            def call():
                return pcg._launch(*args, iters, damping, cluster=cluster)

            row = dict(shape=label, lanes=B, nodes=K, edges=E, gps=G, iters=iters,
                       cluster=cluster, layout=int(lib.liorf_pcg_layout(K, E, G, cluster)),
                       shared_bytes=int(lib.liorf_pcg_shared_bytes(K, E, G, cluster)),
                       default=cluster == pcg.CLUSTER,
                       equal_to_default=bool(torch.equal(call(), ref)),
                       ms=cuda_ms(call, reps=10, batch=5))
            check(row["equal_to_default"], f"pcg_profile: {row} differs from the default launch")
            table.append(row)
    out = []
    try:
        for exchange, flags in PCG_EXCHANGES:
            pcg._lib = None
            pcg.load_library(flags)
            ms = {}
            for (label, args, iters, damping), ref in zip(cases, refs):
                def call():
                    return pcg._launch(*args, iters, damping)

                check(torch.equal(call(), ref), f"pcg_profile: {exchange} differs from the kernel "
                      f"on {label}")
                ms[label] = cuda_ms(call, reps=10, batch=5)
            pcg._lib = None
            lib = pcg.load_library(flags + ("-DLIORF_PCG_PROFILE",))
            lib.liorf_pcg_profile.argtypes = [ctypes.c_void_p]
            for (label, args, iters, damping), ref in zip(cases, refs):
                B, K, _ = args[11].shape
                E, G = args[0].shape[1], args[2].shape[1]
                check(torch.equal(pcg._launch(*args, iters, damping), ref),
                      f"pcg_profile: the profiling build ({exchange}) differs on {label}")
                torch.cuda.synchronize()
                buf = (ctypes.c_longlong * 16)()
                check(lib.liorf_pcg_profile(ctypes.addressof(buf)) == 0, "reading the profile failed")
                cycles = {name: buf[j] / iters for j, name in enumerate(PCG_PHASES)}
                out.append(dict(shape=label, lanes=B, nodes=K, edges=E, gps=G, iters=iters,
                                cluster=pcg.CLUSTER,
                                layout=int(lib.liorf_pcg_layout(K, E, G, pcg.CLUSTER)),
                                exchange=exchange, ms=ms[label], cycles_per_iteration=cycles,
                                cycles_per_iteration_total=sum(cycles.values()),
                                prologue_cycles=buf[11]))
    finally:
        pcg._lib = None  # the next user builds the kernel's own library
    emit("pcg_profile", clusters=table, rows=out,
         note="clusters: the kernel's build, back to back (layout 1 on chip, 0 device memory); "
              "rows: ms of each exchange's plain build, back to back, and cycles of block 0's "
              "thread 0 in its profiling build's last launch")


def phase_segment_sum() -> dict:
    """The segment sum at its one remaining site, the distributed solver's
    matvec (dist/shard_map_solver.py): the SegmentPlan a rank builds over
    the seeded graph of the dist phase (2048 nodes, 4096 edge and 64 GPS
    slots: dist_graph), its offsets found once, summing seeded rows of 6
    (J^T r) and 36 (J^T J) columns."""
    graph = dist_graph(1)[0]
    K = graph.Rs.shape[0]
    keys, perm = segsum.SegmentPlan([graph.e_i, graph.e_j, graph.g_i], K).sorted_rows()
    offsets = segsum.segment_offsets(keys[None], K)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    out = {}
    for kind, cols in (("dist_matvec", 6), ("dist_diag_own", 36)):
        rows = torch.randn((1, keys.shape[0], cols), generator=gen, device=DEV)
        out[kind] = bench_segsum(rows, perm[None], keys[None], K, offsets)
    emit("kernels_segment_sum", tolerance="against float64: (n - 1) 2^-24 sum|x|", **out)
    return out


def voxel_sort_key(cell, mask):
    """The library yardstick's key: one int64 a point, the cell's (z, y, x)
    packed 21 bits an axis (wrapping where a cell is wider) under the
    invalid bit."""
    c = cell.to(torch.int64) & ((1 << 21) - 1)
    return ((~mask).to(torch.int64) << 63) | (c[..., 2] << 42) | (c[..., 1] << 21) | c[..., 0]


def bench_voxel_filter(args) -> dict:
    """The voxel filter on the arguments a path gave it (one kernel call for
    every lane): its sorted permutation and outputs against its plain
    version on a CPU copy (np.array_equal), each lane against the same
    voxel_downsample call on a CPU copy (its route: _cells, lexsort,
    voxel_reduce_plain), against itself; the library's own count of kernel
    launches around one call and around the lanes under torch.func.vmap (1
    each), the lanes' counters back at 0; timed three ways and by device
    time alone, beside its bound, the plain version on the card (its
    index_add is atomic there), the parts of the eager filter it replaced
    (the cells, lexsort's four stable argsorts) and one torch.sort of an
    int64 key of the same length (the library yardstick)."""
    xyz, intensity, mask, leaf, S = args  # intensity None: the kernel reads zeros
    B, M = mask.shape

    def kernel():
        return vfil.voxel_filter(xyz, intensity, mask, leaf, S)

    out, again = kernel(), kernel()
    order = vfil._launch(xyz, intensity, mask, leaf, S, keep_order=True)[4]
    zeros = torch.zeros((B, M), device=DEV)
    cpu_args = [t.cpu() for t in (xyz, zeros if intensity is None else intensity, mask)]
    cell_cpu = vfil.cells_plain(cpu_args[0], cpu_args[2], leaf)
    want_order = vfil.filter_order_plain(cell_cpu, cpu_args[2])
    cpu = vfil.voxel_filter_plain(*cpu_args, leaf, S)
    lanes_cpu = [tvoxel.voxel_downsample(tvoxel.PointCloud(*(t[b] for t in cpu_args)), leaf, S)
                 for b in range(B)]
    k0 = vfil.kernel_launches()
    kernel()
    k1 = vfil.kernel_launches()
    torch.func.vmap(lambda x, i, m: tvoxel.voxel_downsample(tvoxel.PointCloud(x, i, m), leaf, S))(
        xyz, zeros if intensity is None else intensity, mask)
    k2 = vfil.kernel_launches()
    torch.cuda.synchronize()
    counters_zero = int(vfil.lane_counters(DEV, B).abs().sum()) == 0
    cell = vfil.cells_plain(xyz, mask, leaf)
    key = voxel_sort_key(cell, mask)
    valid_points = int(mask.sum())
    voxels = int(out[2].sum())
    # what the function must move: 17 B a point read (xyz, intensity, mask),
    # 25 B a slot written (centroid, intensity, valid, rep); 3 multiplies a
    # point, 5 adds a valid point and 4 divisions a voxel
    bytes_moved = B * (17 * M + 25 * S)
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = (3 * B * M + 5 * valid_points + 4 * voxels) / FP32_FLOP_PER_S
    res = dict(
        shape=[M, S], lanes=B, leaf=leaf, valid_points=valid_points, voxels=voxels,
        max_abs_err=max(float((g.cpu().double() - w.double()).abs().max()) for g, w in
                        zip(out[:2], cpu[:2])),
        equal_to_cpu_plain=all(np.array_equal(g.cpu().numpy(), w.numpy()) for g, w in zip(out, cpu)),
        order_equal_to_plain=bool(torch.equal(order.cpu(), want_order)),
        call_equal_to_cpu=all(np.array_equal(g[b].cpu().numpy(), w.numpy())
                              for b, r in enumerate(lanes_cpu)
                              for g, w in zip(out, (*r.cloud, r.rep_idx))),
        repeats=all(torch.equal(g, a) for g, a in zip(out, again)),
        kernel_launches_per_call=k1 - k0, kernel_launches_per_vmapped_call=k2 - k1,
        counters_zero=counters_zero,
        **kernel_ms(kernel), device_ms=device_only_ms(kernel),
        plain_ms=cuda_ms(lambda: vfil.voxel_filter_plain(xyz, intensity, mask, leaf, S),
                         reps=10, batch=5),
        # the eager filter's parts on the card: the cells and lexsort's four
        # stable argsorts, one lane at a time (single calls)
        cells_ms=cuda_ms(lambda: vfil.cells_plain(xyz, mask, leaf)),
        lexsort_ms=sum(cuda_ms(lambda b=b: tvoxel.lexsort(
            (cell[b, :, 0], cell[b, :, 1], cell[b, :, 2], (~mask[b]).to(torch.uint8))))
            for b in range(B)),
        library_ms=cuda_ms(lambda: torch.sort(key, dim=-1), reps=10, batch=20),
        library_ms_single_call=cuda_ms(lambda: torch.sort(key, dim=-1)),
        library_call="torch.sort of an int64 key [B, M] (the packed cell under the invalid bit)",
        bound_ms=max(t_bytes, t_ops) * 1e3, bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=bytes_moved,
    )
    return res


def phase_voxel_filter(cases: dict, lanes: int = 1) -> dict:
    """The voxel filter held on the arguments a path gave it
    (capture_kernel_args), over ``lanes`` lanes, one line a path; and no
    segment sum launched on the path."""
    kinds = sorted(k for k in cases if k.startswith("voxel_filter_out"))
    check(kinds, f"no {lanes}-lane voxel_filter launch captured: {sorted(cases)}")
    check("segment_sum" not in cases, f"a segment sum was launched on a single-device path "
          f"({lanes} lanes)")
    out = {kind: bench_voxel_filter(cases[kind]) for kind in kinds}
    emit("kernels_voxel_reduce" if lanes == 1 else f"kernels_voxel_reduce_lanes{lanes}",
         lanes=lanes, kernel="voxel_filter", tolerance="bit for bit (np.array_equal)", **out)
    for kind, r in out.items():
        what = f"voxel_filter {kind} x {lanes} lanes"
        check(r["lanes"] == lanes, f"{what}: captured with {r['lanes']} lanes")
        check(r["equal_to_cpu_plain"], f"{what}: differs from its plain version on the CPU")
        check(r["order_equal_to_plain"], f"{what}: its order differs from the plain version's")
        check(r["repeats"], f"{what}: two launches differ")
        check(r["call_equal_to_cpu"], f"{what}: differs from voxel_downsample on the CPU")
        check(r["kernel_launches_per_call"] == 1 and r["kernel_launches_per_vmapped_call"] == 1,
              f"{what}: {r['kernel_launches_per_call']} / {r['kernel_launches_per_vmapped_call']} "
              f"kernel launches a call / a vmapped call")
        check(r["counters_zero"], f"{what}: the lanes' counters are not back at 0")
    return out


VOXEL_SEEDED = (8, 16384, 8192)  # lanes, points, slots: the multistream operating point's scans


def voxel_seeded_lanes(lanes: int, n: int, S: int):
    """voxel_filter's arguments for ``lanes`` seeded city-like scans of ``n``
    points (+-60 m around the sensor, -2 to 8 m of height, 15 % padded), each
    lane shifted by its own offset, at leaf 0.3 into S slots."""
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    xyz = (torch.rand((lanes, n, 3), generator=gen, device=DEV) - 0.5) * 120.0
    xyz[..., 2] = xyz[..., 2] / 12.0 + 3.0
    xyz += torch.arange(lanes, device=DEV, dtype=torch.float32)[:, None, None] * 37.0
    mask = torch.rand((lanes, n), generator=gen, device=DEV) > 0.15
    xyz = torch.where(mask[..., None], xyz, tvoxel.PAD_COORD)
    return xyz, torch.rand((lanes, n), generator=gen, device=DEV), mask, 0.3, S


def parent_voxel_downsample(parent: str):
    """The parent checkout's voxel filter on the card (``--parent DIR``):
    ``_cells``, ``lexsort`` (their code is this tree's) and DIR's
    ``ops/voxel_reduce.py`` kernels, vmapped over the lanes as the parent's
    multistream path ran it."""
    old = parent_module(parent, "voxel_reduce")

    def one(xyz, intensity, mask, leaf, S):
        if intensity is None:  # voxel_downsample_xyz's zeros
            intensity = torch.zeros(mask.shape, device=mask.device)
        cell = tvoxel._cells(tvoxel.PointCloud(xyz, intensity, mask), leaf)
        order = tvoxel.lexsort((cell[:, 0], cell[:, 1], cell[:, 2], (~mask).to(torch.uint8)))
        return tuple(t[0] for t in old.voxel_reduce(
            xyz[None], intensity[None], mask[None], cell[None], order[None], S))

    def call(xyz, intensity, mask, leaf, S):
        if xyz.shape[0] == 1:
            return tuple(t[None] for t in one(
                xyz[0], None if intensity is None else intensity[0], mask[0], leaf, S))
        if intensity is None:
            return torch.func.vmap(lambda x, m: one(x, None, m, leaf, S))(xyz, mask)
        return torch.func.vmap(lambda x, i, m: one(x, i, m, leaf, S))(xyz, intensity, mask)
    return call


VOXEL_PROFILE = ("cells", "keys", "offsets", "scatter", "segments", "slots", "barriers", "passes")


def phase_voxel_profile(cases: dict, label: str) -> None:
    """Not in the default run: the voxel filter's time by part on the
    arguments a path gave it (a profiling build of csrc/voxel_filter.cu,
    -DLIORF_VOXEL_PROFILE: block 0's thread 0 adds the global timer's ns a
    part, its waits at the lane's barriers apart, and counts the passes),
    the medians of 5 launches, each bit for bit against the plain build's;
    then ptxas' and the SASS's sizes of the plain build."""
    import ctypes

    kinds = sorted(k for k in cases if k.startswith("voxel_filter_out"))
    want = {k: vfil.voxel_filter(*cases[k]) for k in kinds}
    out = {}
    vfil._lib = None
    vfil._SCRATCH.clear()
    try:
        read = vfil.load_library(("-DLIORF_VOXEL_PROFILE",)).liorf_voxel_filter_profile
        read.argtypes = [ctypes.c_void_p]
        read.restype = ctypes.c_int
        buf = (ctypes.c_longlong * len(VOXEL_PROFILE))()
        for k in kinds:
            def call(a=cases[k]):
                return vfil.voxel_filter(*a)
            check(all(torch.equal(g, w) for g, w in zip(call(), want[k])),
                  f"voxel_profile {k}: the profiling build differs from the plain build")
            runs = []
            for _ in range(5):
                torch.cuda.synchronize()
                check(read(ctypes.addressof(buf)) == 0, "reading the profile failed")  # resets it
                call()
                torch.cuda.synchronize()
                check(read(ctypes.addressof(buf)) == 0, "reading the profile failed")
                runs.append(list(buf))
            out[k] = dict(device_ms=device_only_ms(call), **{
                name: statistics.median(r[j] for r in runs) for j, name in enumerate(VOXEL_PROFILE)})
    finally:
        vfil._lib = None  # the next user builds the library without the profile
        vfil._SCRATCH.clear()
    emit("voxel_profile", path=label, ns_by_part=out, build=nvcc_report(VOXEL_SOURCE),
         note="ns by part of block 0's thread 0 (barriers: its waits for the lane's other blocks); "
              "device_ms of the profiling build")


def phase_voxel_parent(cases: dict, parent: str, pipe: LiorfPipeline) -> None:
    """Not in the default run. The parent checkout's voxel filter (``--parent
    DIR``) beside this tree's on the same clouds (``cases``: name -> (label,
    args)): every output bit for bit, then device time, the call back to back
    and one call from an idle device (``split``'s method), in turns (parent,
    this, this, parent); the kernels one parent scan call launches (one
    profiler trace, the process's only one); and ``pipe``'s local-map rebuild
    (split's stage) with each filter, its grid bit for bit, in turns."""
    from liorf_tpu_torch.mapping import keyframes

    old = parent_voxel_downsample(parent)
    res = {}
    for name, (label, args) in cases.items():
        def new(a=args):
            return vfil.voxel_filter(*a)

        def prev(a=args):
            return old(*a)
        equal = all(torch.equal(x, y) for x, y in zip(new(), prev()))
        turns = [dict(who=who, device_ms=device_only_ms(fn), **kernel_ms(fn))
                 for who, fn in (("parent", prev), ("this", new), ("this", new), ("parent", prev))]
        res[name] = dict(
            path=label, shape=[args[2].shape[1], args[4]], lanes=args[2].shape[0],
            equal_to_parent=equal, turns=turns,
            **{f"{who}_{k}": statistics.median(t[k] for t in turns if t["who"] == who)
               for who in ("parent", "this") for k in ("device_ms", "ms", "ms_single_call")})
    scan = min((k for k in cases if cases[k][1][2].shape[0] == 1), key=lambda k: cases[k][1][4])
    launched, _ = device_kernels(lambda: old(*cases[scan][1]))

    def old_xyz(xyz, mask, leaf, cap=None):
        out = old(xyz[None], None, mask[None], leaf, xyz.shape[0] if cap is None else cap)
        return out[0][0], out[2][0]

    stamp, kf_pose = pipe.last_scan_stamp, pipe.store.poses[pipe.store.count - 1].copy()
    real = keyframes.voxel_downsample_xyz
    grids, rebuild = {}, []
    try:
        for who in ("parent", "this", "this", "parent"):
            keyframes.voxel_downsample_xyz = old_xyz if who == "parent" else real
            pipe._rebuild_grid(kf_pose, stamp)
            grids[who] = tuple(t.clone() for t in pipe.grid)
            rebuild.append(dict(who=who, ms=cuda_ms(lambda: pipe._rebuild_grid(kf_pose, stamp),
                                                    reps=10, warm=1)))
    finally:
        keyframes.voxel_downsample_xyz = real
    emit("kernels_voxel_parent", parent=parent, **res,
         parent_scan_call_device_launches=sum(e["calls"] for e in launched),
         parent_scan_call_kernels=launched,
         local_map_rebuild=dict(
             turns=rebuild, grid_equal_to_parent=all(
                 torch.equal(a, b) for a, b in zip(grids["this"], grids["parent"])),
             **{f"{who}_ms": statistics.median(t["ms"] for t in rebuild if t["who"] == who)
                for who in ("parent", "this")}),
         note="device_ms: device_only_ms; ms: 20 calls back to back; ms_single_call: one call "
              "from an idle device; the medians of each side's two turns; the rebuild: one "
              "_rebuild_grid from an idle device, median of 10, each side's two turns")
    for name, r in res.items():
        check(r["equal_to_parent"], f"kernels_voxel_parent: {name} differs from the parent's")
    check(all(torch.equal(a, b) for a, b in zip(grids["this"], grids["parent"])),
          "kernels_voxel_parent: the local map's grid differs from the parent's")


# ---------------------------------------------------------------------------
# phase: repeat (the default mode gives one answer per input)
# ---------------------------------------------------------------------------

REPEAT_MAIN_FRAMES = 30
REPEAT_LOOP_FRAMES = 32  # through the first loop closure (frame ~26)


def phase_repeat() -> dict:
    """The main course and the loop course twice each through
    make_pipeline in the default mode: the trajectories, keyframe poses and
    loop factors of the two runs must be equal (np.array_equal)."""
    check(not torch.are_deterministic_algorithms_enabled(), "repeat runs in the default mode")
    report, counts = {}, Counter()
    for name, cfg, dataset, n in (("main", main_config, main_dataset, REPEAT_MAIN_FRAMES),
                                  ("loop", loop_config, loop_dataset, REPEAT_LOOP_FRAMES)):
        runs = []
        for _ in range(2):
            rp = make_pipeline(cfg())
            reset_counts()
            run_pipeline(rp, dataset(n), n)
            counts.update(launch_counts())
            runs.append(resident_run(rp))
        a, b = runs
        d = np.abs(a["traj"] - b["traj"]).max(axis=1)
        report[name] = dict(
            frames=n, keyframes=len(a["kf_poses"]), loop_factors=len(a["loops"]),
            trajectory_equal=bool(np.array_equal(a["traj"], b["traj"])),
            kf_poses_equal=bool(np.array_equal(a["kf_poses"], b["kf_poses"])),
            loops_equal=bool(np.array_equal(a["loops"], b["loops"])),
            max_abs_diff=float(d.max()),
            first_frame_differs=next((int(f) for f in np.flatnonzero(d > 0)), None))
    emit("repeat", **report)
    for name, r in report.items():
        check(r["trajectory_equal"] and r["kf_poses_equal"] and r["loops_equal"],
              f"repeat: two default-mode runs of the {name} course differ "
              f"(max {r['max_abs_diff']}, first frame {r['first_frame_differs']})")
    check(report["loop"]["loop_factors"] >= 1, "repeat: the loop course closed no loop")
    return dict(counts)


# ---------------------------------------------------------------------------
# phase: gps_path (GPS factors through a whole stream)
# ---------------------------------------------------------------------------

# The main course at the bench size with GPS from the generator at its
# defaults (1 Hz, 0.5 m noise). poseCovThreshold 0 opens the marginal gate
# (at 25, the default, it stays shut on a course this short), leaving the
# time (+-0.2 s), covariance and 5 m spacing gates. The host offers each
# frame the fix of its own stamp, which lands only on a keyframe frame: at
# 4 m/s a keyframe comes every third frame (1.2 m), so the fixes of t = 3,
# 6, 9 s land (12 m apart); 100 frames (fixes up to t = 9 s) land three
# factors, each followed by a full solve.
GPS_FRAMES = 100
GPS_KW = dict(poseCovThreshold=0.0)
GPS_MIN_FACTORS = 3
# the CPU test's course (tests/test_torch_gps.py): on the card and on the CPU
GPS_SMALL_KW = dict(
    scan_capacity=4096, map_capacity=16384, kf_cloud_capacity=4096,
    near_kf_capacity=8, imu_window=32, mappingSurfLeafSize=0.2,
    surroundingKeyframeMapLeafSize=0.2, point_filter_num=1, downsampleRate=1,
    N_SCAN=16, loopClosureEnableFlag=False, surroundingkeyframeAddingDistThreshold=0.3,
    kf_capacity=32, traj_capacity=64, gps_capacity=8, loop_capacity=8,
    imu_rate_capacity=1024, poseCovThreshold=0.0,
)
GPS_SMALL_FRAMES = 21
GPS_CARD_VS_CPU_M = 0.15  # resident_path's bound between two pipelines


def run_frozen(rp, scans, imu, gps=()):
    """Frozen streams through a pipeline: IMU up to each scan's end, GPS
    fixes up to its stamp. Returns the frame times (ms)."""
    ii = gi = 0
    ms = []
    for scan in scans:
        ii = feed_imu(rp.push_imu, scan, imu, ii)
        while gi < len(gps) and gps[gi].stamp <= scan.stamp:
            rp.push_gps(gps[gi])
            gi += 1
        sync = torch.cuda.synchronize if rp.device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        rp.process_scan(scan)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def phase_gps_path() -> dict:
    """GPS factors through ResidentPipeline at the bench size, against the
    same frozen streams without GPS; the CPU test's small course on the card
    against the port on the CPU; then ``cli run --gps``."""
    syn = main_dataset(GPS_FRAMES)
    imu = syn.imu_stream()
    scans = [syn.scan(f) for f in range(GPS_FRAMES)]
    gps = syn.gps_stream()
    gt = syn.ground_truth()[1]

    rp = make_pipeline(SlamConfig(**MAIN_KW, **GPS_KW))
    solves = []  # each keyframe's graph solve: full (True) or window
    solve = tres._solve_graph_resident

    def recorded_solve(state, params, full):
        solves.append(bool(full))
        return solve(state, params, full)

    reset_counts()
    tres._solve_graph_resident = recorded_solve
    try:
        ms = run_frozen(rp, scans, imu, gps)
    finally:
        tres._solve_graph_resident = solve
    counts = launch_counts()
    st = rp.state
    n_g = int(st.g_count)
    g_i = st.g_i[:n_g].tolist()
    poses = rp.trajectory_arrays()[1]
    ate = ate_rmse(poses[:, 3:6].astype(np.float64), gt)
    gn = rp.gn_iters_total()

    plain = make_pipeline(SlamConfig(**MAIN_KW, **GPS_KW))
    run_frozen(plain, scans, imu)
    plain_poses = plain.trajectory_arrays()[1]
    del plain

    small = gps_small_course()
    on_card = make_pipeline(SlamConfig(**GPS_SMALL_KW))
    run_frozen(on_card, *small)
    GPS_SMALL_CARD.update(traj=on_card.trajectory_arrays()[1], g_count=int(on_card.state.g_count))

    report = dict(
        frames=GPS_FRAMES, points_per_scan=32 * 900, pose_cov_threshold=GPS_KW["poseCovThreshold"],
        gps_fixes=len(gps), gps_factors=n_g, gps_keyframes=g_i,
        gps_targets=st.g_t[:n_g].cpu().numpy().round(4).tolist(),
        full_solves=sum(solves), window_solves=len(solves) - sum(solves), keyframes=int(st.kf_count),
        ate_rmse_m=ate, ate_rmse_without_gps_m=ate_rmse(plain_poses[:, 3:6].astype(np.float64), gt),
        max_dist_to_without_gps_m=float(np.linalg.norm(poses[:, 3:6] - plain_poses[:, 3:6], axis=1).max()),
        gn_iters_total=gn, k1_launches=counts["knn_grid_topk"],
        voxel_filter_launches=counts["voxel_filter"],
        ms_per_frame_p50=percentile(ms[1:], 50), ms_per_frame_p99=percentile(ms[1:], 99),
        host_reads=rp.host_reads(),
    )
    emit("gps_path", **report)
    check(n_g >= GPS_MIN_FACTORS, f"gps_path: {n_g} GPS factors landed, expected >= {GPS_MIN_FACTORS}")
    check(sum(solves) >= n_g, f"gps_path: {sum(solves)} full solves for {n_g} GPS factors")
    check(ate < 0.3, f"gps_path: ATE {ate} m >= 0.3 m")
    check(counts["knn_grid_topk"] == gn, "gps_path: K1 launches != GN iterations")
    return counts


GPS_SMALL_CARD: dict = {}  # gps_path's run of the small course on the card


def gps_small_course():
    """The CPU test's small course: scans, IMU and GPS fixes."""
    small = SyntheticDataset(SyntheticConfig(n_frames=25, n_rings=16, points_per_ring=250,
                                             speed=6.0, gps_hz=2.0))
    scans = [small.scan(f) for f in range(GPS_SMALL_FRAMES)]
    return scans, small.imu_stream(), small.gps_stream()


def phase_gps_small_cpu() -> None:
    """gps_path's small course through the port on the CPU, against
    gps_path's run of it on the card (run while the dist ranks run: the CPU
    pipeline needs no card)."""
    on_cpu = make_pipeline(SlamConfig(**GPS_SMALL_KW), device="cpu")
    t0 = time.perf_counter()
    run_frozen(on_cpu, *gps_small_course())
    cpu_s = time.perf_counter() - t0
    small_d = float(np.abs(GPS_SMALL_CARD["traj"] - on_cpu.trajectory_arrays()[1]).max())
    small_g = [GPS_SMALL_CARD["g_count"], int(on_cpu.state.g_count)]
    emit("gps_small_course", frames=GPS_SMALL_FRAMES, gps_factors_card_cpu=small_g,
         max_abs_card_vs_cpu=small_d, bound=GPS_CARD_VS_CPU_M, cpu_seconds=cpu_s)
    check(small_g[0] == small_g[1] >= 2, f"gps_path: small course factors card/cpu {small_g}")
    check(small_d < GPS_CARD_VS_CPU_M, f"gps_path: the card {small_d} from the CPU on the small course")


def gps_cli_run(tmp: str) -> dict:
    """gps_path through ``cli run --gps``: its synthetic course for
    GPS_FRAMES frames with a config whose poseCovThreshold opens the gate,
    writing its checkpoint under ``tmp`` (a subprocess; run in a closing
    thread)."""
    root = os.path.dirname(os.path.abspath(__file__))
    cfg = os.path.join(tmp, "gps.yaml")
    with open(cfg, "w") as f:
        f.write(f"liorf:\n  poseCovThreshold: {GPS_KW['poseCovThreshold']}\n")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "liorf_tpu_torch.cli", "run", "--dataset", "synthetic",
         "--frames", str(GPS_FRAMES), "--gps", "--config", cfg, "--out", os.path.join(tmp, "out"),
         "--checkpoint"],
        cwd=root, capture_output=True, text=True, timeout=600,
    )
    check(r.returncode == 0, f"cli run --gps exited {r.returncode}: {r.stderr[-2000:]}")
    return dict(json.loads(r.stdout.strip().splitlines()[-1]), seconds=time.perf_counter() - t0)


def phase_gps_cli(line: dict, tmp: str) -> None:
    """gps_cli_run's factors, read back from its checkpoint."""
    from liorf_tpu_torch.mapping.export import load_checkpoint

    rp = load_checkpoint(tres.ResidentPipeline(SlamConfig(), device="cpu"),
                         os.path.join(tmp, "out", "checkpoint.pkl"))
    n_g = int(rp.state.g_count)
    emit("gps_cli", **line, gps_factors=n_g)
    check(n_g >= GPS_MIN_FACTORS, f"cli run --gps landed {n_g} factors")


# ---------------------------------------------------------------------------
# phase: growth_path (ring growth on the card)
# ---------------------------------------------------------------------------

# tests/test_resident.py:236's rings: every one but the GPS ring outgrows
# them on the loop course; held to resident_loop_path's large-ring run
# (keyframes and loop factors equal, trajectory within
# tests/test_torch_resident.py:333's 1e-5).
GROWTH_RINGS = dict(kf_capacity=8, traj_capacity=16, gps_capacity=8, loop_capacity=8)
GROWTH_M = 1e-5


def phase_growth_path(large: dict) -> dict:
    out, counts = {}, Counter()
    for pull_free in (False, True):
        rp = make_pipeline(SlamConfig(**LOOP_KW, **GROWTH_RINGS, pull_free_growth=pull_free))
        reset_counts()
        ms = run_frozen(rp, *frozen_loop_course())
        c = launch_counts()
        counts.update(c)
        run = resident_run(rp)
        st = rp.state
        per_frame = np.abs(run["traj"] - large["traj"]).max(axis=1)
        d = per_frame.max()
        out[f"pull_free_growth_{pull_free}"] = r = dict(
            growth_events=rp.growth_events,
            rings=dict(kf=st.kf_poses.shape[0], traj=st.traj.shape[0], gps=st.g_i.shape[0],
                       loop=st.l_i.shape[0]),
            keyframes=len(run["kf_poses"]), loop_factors=len(run["loops"]),
            keyframes_equal=run["is_kf"] == large["is_kf"]
            and len(run["kf_poses"]) == len(large["kf_poses"]),
            loops_equal=bool(np.array_equal(run["loops"], large["loops"])),
            max_abs_vs_large_rings=float(d),
            first_frame_differs=next((int(f) for f in np.flatnonzero(per_frame > 0)), None),
            trajectory_equal=bool(np.array_equal(run["traj"], large["traj"])),
            kf_poses_equal=bool(np.array_equal(run["kf_poses"], large["kf_poses"])),
            gn_iters_total=rp.gn_iters_total(), k1_launches=c["knn_grid_topk"],
            k2_launches=c["knn_bruteforce"], host_reads=rp.host_reads(),
            ms_per_frame_p50=percentile(ms[1:], 50))
    emit("growth_path", frames=LOOP_FRAMES, rings=GROWTH_RINGS, bound=GROWTH_M, **out)
    for name, r in out.items():
        check(r["growth_events"] >= 2, f"growth_path {name}: {r['growth_events']} growth events")
        check(r["keyframes_equal"] and r["loops_equal"],
              f"growth_path {name}: keyframes or loop factors differ from the large rings")
        check(r["max_abs_vs_large_rings"] < GROWTH_M,
              f"growth_path {name}: {r['max_abs_vs_large_rings']} from the large-ring run "
              f"(first at frame {r['first_frame_differs']})")
        check(r["k1_launches"] == r["gn_iters_total"], "growth_path: K1 launches != GN iterations")
        check(r["k2_launches"] > 0, "growth_path: K2 never launched")
    return dict(counts)


def frozen_loop_course():
    """The loop course's streams, as loop_dataset feeds them to run_pipeline."""
    syn = loop_dataset(LOOP_FRAMES)
    imu = syn.imu_stream()
    return [syn.scan(f) for f in range(LOOP_FRAMES)], imu


# ---------------------------------------------------------------------------
# phase: faults (tests/test_fault_injection.py's behaviours on the card)
# ---------------------------------------------------------------------------

FAULT_KW = dict(
    scan_capacity=4096, map_capacity=32768, kf_cloud_capacity=2048, near_kf_capacity=16,
    imu_window=64, point_filter_num=1, downsampleRate=1, mappingSurfLeafSize=0.4,
    surroundingKeyframeMapLeafSize=0.4, loopClosureEnableFlag=False, kf_capacity=64,
    traj_capacity=128, gps_capacity=16,
)
FAULT_FRAMES = 10
FAULT_DRIFT_M = 2.0
FAULT_STEP_M = 5.0


def fault_drift(rp, syn) -> float:
    _, poses = rp.trajectory_arrays()
    check(bool(np.isfinite(poses).all()), "a non-finite pose escaped the pipeline")
    _, gt = syn.ground_truth()
    rel = poses[:, 3:6] - poses[0, 3:6]
    return float(np.linalg.norm(rel - (gt[: len(poses)] - gt[0]), axis=1).max())


def phase_faults() -> dict:
    """The 8 cases of tests/test_fault_injection.py at its size (16 x 360
    points, 10 frames, leaves 0.4) through the port's ResidentPipeline on
    the card, each held to that test's assertions: finite poses, drift from
    the ground truth's shape < 2.0 m, and after the IMU spike each of the
    last frames' steps < 5 m. One dataset serves all cases, each drawing
    fresh noise, as the test's module fixture does."""
    from dataclasses import replace

    from liorf_tpu_torch.sensors.types import GpsFix, ImuSample, LidarScan

    syn = SyntheticDataset(SyntheticConfig(n_frames=FAULT_FRAMES, n_rings=16, points_per_ring=360))
    cfg = SlamConfig(**FAULT_KW)

    def run(mutate_scan=None, mutate_imu=None, config=cfg, each=None):
        rp = make_pipeline(config)
        imu = syn.imu_stream()
        ii = 0
        for f in range(FAULT_FRAMES):
            scan = syn.scan(f)
            if mutate_scan is not None:
                scan = mutate_scan(f, scan)
            while ii < len(imu) and imu[ii].stamp <= scan.end_time + 0.02:
                s = imu[ii] if mutate_imu is None else mutate_imu(ii, imu[ii])
                if s is not None:
                    rp.push_imu(s)
                ii += 1
            if each is not None:
                each(rp, scan)
            rp.process_scan(scan)
        return rp

    def bad_imu(i, s):
        if i % 7 == 3:
            return ImuSample(s.stamp, np.full(3, np.nan), s.gyr, s.quat_wxyz)
        if i % 11 == 5:
            return ImuSample(s.stamp, s.acc, np.full(3, np.inf), s.quat_wxyz)
        return s

    def bad_scan(f, scan):
        if f % 2 == 1:
            xyz = scan.xyz.copy()
            xyz[::5] = np.nan
            xyz[1::97] = np.inf
            return LidarScan(stamp=scan.stamp, xyz=xyz, intensity=scan.intensity,
                             ring=scan.ring, rel_time=scan.rel_time)
        return scan

    def empty(f, scan):
        if f == 4:
            return LidarScan(stamp=scan.stamp, xyz=np.zeros((0, 3), np.float32),
                             intensity=np.zeros(0, np.float32), ring=np.zeros(0, np.int32),
                             rel_time=np.zeros(0, np.float32))
        return scan

    def duplicate_and_stale():
        rp = make_pipeline(cfg)
        imu = syn.imu_stream()
        ii = 0
        scans = [syn.scan(f) for f in range(8)]
        for f, scan in enumerate(scans):
            ii = feed_imu(rp.push_imu, scan, imu, ii)
            rp.process_scan(scan)
            if f == 3:
                rp.process_scan(scan)  # exact duplicate
            if f == 5:
                rp.process_scan(scans[2])  # stale out-of-order replay
        return rp

    def spike(i, s):
        if i == 150:
            return ImuSample(s.stamp, np.array([2.0e4, 0.0, 9.81]), np.array([0.0, 0.0, 500.0]),
                             s.quat_wxyz)
        return s

    ident = np.array([1.0, 0.0, 0.0, 0.0])

    def bad_quat(i, s):
        return ImuSample(s.stamp, s.acc, s.gyr, np.full(4, np.nan) if i % 5 == 2 else ident)

    def nan_gps(rp, scan):
        rp.push_gps(GpsFix(scan.stamp, np.nan, np.nan, np.nan))
        rp.push_gps(GpsFix(scan.stamp, 47.0, 8.0, 400.0, cov_xyz=np.full(3, np.nan)))

    cases = {
        "nan_imu_samples": lambda: run(mutate_imu=bad_imu),
        "nan_points_in_scan": lambda: run(mutate_scan=bad_scan),
        "empty_scan": lambda: run(mutate_scan=empty),
        "imu_dropout": lambda: run(mutate_imu=lambda i, s: None if 100 <= i < 300 else s),
        "duplicate_and_stale_scan": duplicate_and_stale,
        "imu_spike": lambda: run(mutate_imu=spike),
        "nan_quaternion_9axis": lambda: run(mutate_imu=bad_quat, config=replace(cfg, imuType=1)),
        "nan_gps_fix": lambda: run(each=nan_gps),
    }
    report, counts, failed = {}, Counter(), []
    for name, case in cases.items():
        reset_counts()
        rp = case()
        c = launch_counts()
        counts.update(c)
        _, poses = rp.trajectory_arrays()
        r = report[name] = dict(frames=len(poses), finite=bool(np.isfinite(poses).all()),
                                gn_iters=rp.gn_iters_total(), k1_launches=c["knn_grid_topk"])
        if name == "imu_spike":
            steps = np.linalg.norm(np.diff(poses[-3:, 3:6], axis=0), axis=1)
            r["last_steps_m"] = steps.tolist()
            ok = r["finite"] and bool((steps < FAULT_STEP_M).all())
        else:
            r["drift_m"] = fault_drift(rp, syn) if r["finite"] else None
            ok = r["finite"] and r["drift_m"] < FAULT_DRIFT_M
        r["held"] = ok
        if not ok:
            failed.append(name)
    emit("faults", cases=report, drift_bound_m=FAULT_DRIFT_M, step_bound_m=FAULT_STEP_M)
    check(not failed, f"faults: {failed} broke the fault-injection assertions on the card")
    for name, r in report.items():
        check(r["k1_launches"] == r["gn_iters"], f"faults {name}: K1 launches != GN iterations")
    return dict(counts)


# ---------------------------------------------------------------------------
# phase: dist (the distributed modes, liorf_tpu_torch.dist)
# ---------------------------------------------------------------------------

# Sizes: the solver at scripts/bench_scaling.py:22-23,33-35 of the JAX
# package (2048 keyframes and 64 GPS factors a rank, 2 factors a keyframe,
# SolveParams() = 6 GN x 64 PCG; once more with inner_iters = 4), the
# registration at the main path's bench size on its own map, a ScanContext
# database of 1024 keyframes, and ShardedResidentPipeline over 20 frames of
# the main path's streams — then over the first 32 frames of the loop
# course, where the first loop closes (frame ~26) and K2 runs in the
# replicated ICP. Bounds: tests/test_torch_dist.py's.
DIST_FRAMES = 20
DIST_LOOP_FRAMES = 32
DIST_KF_PER_RANK = 2048
DIST_GPS_PER_RANK = 64
DIST_SC = 1024
DIST_GLOO_RANKS = 4
DIST_SOLVE_M = 2e-3
DIST_INNER_M = 5e-3
DIST_SCAN = 5e-4
DIST_TRANS_M = 2e-2
DIST_ROT = 6e-2
DIST_KF_AGREE = 0.8


def dist_graph(world: int):
    from liorf_tpu_torch.dist.multihost import demo_graph

    K = DIST_KF_PER_RANK * world
    return demo_graph(K, 2 * K, DIST_GPS_PER_RANK * world, device=DEV)


def timed_s(fn, repeats: int = 1):
    """(result of a warm call, seconds per call of ``repeats`` more)."""
    out = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / repeats


def dist_references():
    """The single-device port on the dist phase's inputs, on the card: the
    pipeline (in the default mode, as the sharded one runs),
    then the registration on its final map, the loop search, the solves."""
    from liorf_tpu_torch.core.voxel import voxel_downsample_xyz
    from liorf_tpu_torch.graph import pose_graph as pg
    from liorf_tpu_torch.ops import scancontext
    from liorf_tpu_torch.ops.scan_match import scan_to_map

    ref = {}
    rp = tres.ResidentPipeline(main_config(), device=DEV)
    syn = main_dataset(DIST_FRAMES)
    _, frame_ms = run_pipeline(rp, syn, DIST_FRAMES)
    n = int(rp.state.traj_count)
    ref["pipeline"] = dict(traj=rp.state.traj[:n].cpu().numpy(), ms=frame_ms[1:],
                           gn_iters=rp.gn_iters_total())

    # registration: the next raw scan, downsampled, against the final map,
    # from the last pose with an offset
    scan = syn.scan(DIST_FRAMES - 1)
    ds, ds_mask = voxel_downsample_xyz(
        torch.as_tensor(scan.xyz, device=DEV), torch.ones(len(scan.xyz), dtype=torch.bool, device=DEV),
        0.3, BENCH_CAPS["scan_capacity"])
    init = rp.state.traj[n - 1, :6] + torch.tensor([0.01, -0.01, 0.02, 0.1, -0.05, 0.05], device=DEV)
    grid = rp.state.grid
    params = rp.frame_params.match
    res, dt = timed_s(lambda: scan_to_map(ds, ds_mask, grid, init, params))
    ref["scan"] = dict(inputs=dict(scan_xyz=ds.cpu().numpy(), scan_mask=ds_mask.cpu().numpy(),
                                   init_pose=init.cpu().numpy(),
                                   **{f"grid_{f}": getattr(grid, f).cpu().numpy()
                                      for f in grid._fields}),
                       params=params._asdict(), pose=res.pose.cpu().numpy(),
                       num_matched=int(res.num_matched), iters=int(res.iters),
                       ms_per_iter=dt * 1e3 / int(res.iters))

    rng = np.random.default_rng(SEED)
    descs = rng.uniform(0, 5, size=(DIST_SC, 20, 60)).astype(np.float32)
    q = np.roll(descs[7], 13, axis=1)
    dargs = [torch.as_tensor(a, device=DEV) for a in (descs, descs.mean(-1), q, q.mean(-1))]
    det, dt = timed_s(lambda: scancontext.detect_loop(dargs[0], dargs[1], DIST_SC - 24, dargs[2],
                                                      dargs[3]), repeats=5)
    ref["detect"] = dict(inputs=dict(descs=descs, keys=descs.mean(-1), qdesc=q, qkey=q.mean(-1)),
                         index=int(det.index), distance=float(det.distance),
                         yaw=float(det.yaw), ms=dt * 1e3)

    for world in sorted({torch.cuda.device_count(), DIST_GLOO_RANKS}):
        graph, gt, n_nodes = dist_graph(world)
        out, dt = timed_s(lambda: pg.solve(graph, params=pg.SolveParams()))
        ref[f"solve{world}"] = dict(
            inputs={k: v.cpu().numpy() for k, v in graph._asdict().items()},
            ts=out.ts.cpu().numpy(), gt=gt, n=n_nodes,
            ms_per_gn_step=dt * 1e3 / pg.SolveParams().gn_iters)
    return ref


def dist_run(label: str, world: int, backend: str, device: str | None, ref: dict, tmp: str):
    """One launch of the cases worker over ``world`` ranks; every rank's
    results bit-identical to rank 0's; rank 0's held to the references."""
    from liorf_tpu_torch.dist.launch import launch

    cases, arrays = [], {}

    def add(case, inputs):
        cases.append(case)
        arrays.update({f"{case['name']}/{k}": v for k, v in inputs.items()})

    solve_in = ref[f"solve{world}"]["inputs"]
    add(dict(kind="solve", name="solve", params={}, repeats=1), solve_in)
    add(dict(kind="solve", name="inner", params=dict(inner_iters=4), repeats=1), solve_in)
    add(dict(kind="scan", name="scan", params=ref["scan"]["params"], repeats=1),
        ref["scan"]["inputs"])
    add(dict(kind="detect", name="detect", count=DIST_SC - 24, repeats=5),
        ref["detect"]["inputs"])
    add(dict(kind="pipeline", name="pipeline", config=MAIN_KW,
             synthetic=main_synthetic(DIST_FRAMES), frames=DIST_FRAMES), {})
    add(dict(kind="pipeline", name="loop", config=LOOP_KW,
             synthetic=loop_synthetic(DIST_LOOP_FRAMES), frames=DIST_LOOP_FRAMES), {})
    path = os.path.join(tmp, f"{label}.npz")
    np.savez(path, spec=json.dumps({"cases": cases}), **arrays)
    out_dir = os.path.join(tmp, label)
    t0 = time.perf_counter()
    launch(world, ["--cases", path, "--results", out_dir], module="liorf_tpu_torch.dist.cases",
           backend=backend, device=device, timeout=480)
    seconds = time.perf_counter() - t0

    ranks = [np.load(os.path.join(out_dir, f"rank{r}.npz")) for r in range(world)]
    metas = [json.loads(str(r["meta"])) for r in ranks]
    for r, rk in enumerate(ranks[1:], 1):
        check(rk.files == ranks[0].files, f"{label}: rank {r} returned other results")
        for k in rk.files:
            if k != "meta":
                check(np.array_equal(rk[k], ranks[0][k], equal_nan=True),
                      f"{label}: rank {r}'s {k} differs from rank 0's")
    out, m0 = ranks[0], metas[0]

    sref = ref[f"solve{world}"]
    n = sref["n"]
    solve_err = float(np.abs(out["solve/ts"][:n] - sref["ts"][:n]).max())
    inner_err = float(np.abs(out["inner/ts"][:n] - sref["ts"][:n]).max())
    init_err = float(np.linalg.norm(sref["inputs"]["ts"][:n] - sref["gt"][:n], axis=1).mean())
    gt_err = {k: float(np.linalg.norm(out[f"{k}/ts"][:n] - sref["gt"][:n], axis=1).mean())
              for k in ("solve", "inner")}
    params = dict(gn=6, pcg=64)
    coll = m0["solve"]["collectives_per_solve"]
    per_pcg = (sum(coll.values()) - params["gn"] * 5 - 2) / (params["gn"] * params["pcg"])

    scan_err = float(np.abs(out["scan/pose"] - ref["scan"]["pose"]).max())
    traj, rtraj = out["pipeline/traj"], ref["pipeline"]["traj"]
    pipe = [m["pipeline"] for m in metas]
    loop = [m["loop"] for m in metas]
    report = dict(
        world=world, backend=backend, device=device or "cuda (one card a rank)",
        launch_seconds=seconds,
        solve=dict(nodes=DIST_KF_PER_RANK * world, ms_per_gn_step=m0["solve"]["ms_per_gn_step"],
                   single_ms_per_gn_step=sref["ms_per_gn_step"],
                   max_abs_vs_single_m=solve_err, err_vs_gt_m=gt_err["solve"],
                   init_err_m=init_err, collectives_per_solve=coll,
                   collectives_per_pcg_iteration=per_pcg),
        inner_outer=dict(inner_iters=4, ms_per_gn_step=m0["inner"]["ms_per_gn_step"],
                         segment_sum_launches_per_solve=m0["inner"][
                             "segment_sum_launches_per_solve"],
                         max_abs_vs_single_m=inner_err, err_vs_gt_m=gt_err["inner"],
                         collectives_per_solve=m0["inner"]["collectives_per_solve"]),
        scan=dict(points=int(ref["scan"]["inputs"]["scan_mask"].shape[0]),
                  points_per_rank=-(-ref["scan"]["inputs"]["scan_mask"].shape[0] // world),
                  ms_per_iter=m0["scan"]["ms_per_iter"],
                  single_ms_per_iter=ref["scan"]["ms_per_iter"], max_abs_vs_single=scan_err,
                  num_matched=int(out["scan/num_matched"]),
                  single_num_matched=ref["scan"]["num_matched"],
                  iters=int(out["scan/iters"]), k1_launches=m0["scan"]["k1_launches"]),
        detect=dict(database=DIST_SC, index=int(out["detect/index"]),
                    distance=float(out["detect/distance"]), ms=m0["detect"]["ms"],
                    single_ms=ref["detect"]["ms"]),
        pipeline=dict(
            frames=DIST_FRAMES, ms_per_frame_p50=percentile(pipe[0]["frame_ms"][1:], 50),
            single_ms_per_frame_p50=percentile(ref["pipeline"]["ms"], 50),
            max_abs_trans_vs_single_m=float(np.abs(traj[:, 3:6] - rtraj[:, 3:6]).max()),
            # both in the default mode: bit-equal, else the first frame whose
            # trajectory row parts
            bit_equal_to_single=bool(np.array_equal(traj, rtraj)),
            first_frame_differs=next((int(f) for f in np.flatnonzero(
                (traj != rtraj).any(axis=1))), None) if traj.shape == rtraj.shape else 0,
            max_abs_rot_vs_single=float(np.abs(traj[:, :3] - rtraj[:, :3]).max()),
            keyframe_flags_equal=float((traj[:, 6] == rtraj[:, 6]).mean()),
            gn_iters_per_rank=[p["gn_iters"] for p in pipe],
            k1_launches_per_rank=[p["k1_launches"] for p in pipe],
            k2_launches_per_rank=[p["k2_launches"] for p in pipe],
            voxel_filter_launches_per_rank=[p["voxel_filter_launches"] for p in pipe],
            segment_sum_launches_per_rank=[p["segment_sum_launches"] for p in pipe],
            single_gn_iters=ref["pipeline"]["gn_iters"], keyframes=pipe[0]["keyframes"],
            loop_factors=pipe[0]["loop_factors"], host_reads=pipe[0]["host_reads"]),
        loop_course=dict(
            frames=DIST_LOOP_FRAMES, ms_per_frame_p50=percentile(loop[0]["frame_ms"][1:], 50),
            loop_factors=loop[0]["loop_factors"], icp_runs=loop[0]["icp_runs"],
            gn_iters_per_rank=[p["gn_iters"] for p in loop],
            k1_launches_per_rank=[p["k1_launches"] for p in loop],
            k2_launches_per_rank=[p["k2_launches"] for p in loop]),
    )
    emit(f"dist_{label}", **report)
    check(solve_err < DIST_SOLVE_M, f"{label}: solve {solve_err} m from the single-device solve")
    check(gt_err["solve"] < 0.5 * init_err, f"{label}: the solve did not halve the error")
    check(inner_err < DIST_INNER_M, f"{label}: inner-outer {inner_err} m from the single solve")
    check(gt_err["inner"] < 0.5 * init_err, f"{label}: inner-outer did not halve the error")
    check(per_pcg == 4, f"{label}: {per_pcg} collectives per PCG iteration, expected 4")
    check(scan_err < DIST_SCAN, f"{label}: registration {scan_err} from the single-device one")
    check(int(out["scan/num_matched"]) == ref["scan"]["num_matched"],
          f"{label}: registration matched {int(out['scan/num_matched'])} points, "
          f"single-device {ref['scan']['num_matched']}")
    check(m0["scan"]["k1_launches"] == int(out["scan/iters"]),
          f"{label}: registration K1 launches != GN iterations")
    check(int(out["detect/index"]) == ref["detect"]["index"] == 7
          and abs(float(out["detect/distance"]) - ref["detect"]["distance"]) < 1e-5
          and float(out["detect/yaw"]) == ref["detect"]["yaw"],
          f"{label}: loop search disagrees with the single-device one")
    check(traj.shape == rtraj.shape, f"{label}: trajectory shape {traj.shape} != {rtraj.shape}")
    # one rank runs the single pipeline's reductions in their fixed order
    check(world > 1 or report["pipeline"]["bit_equal_to_single"],
          f"{label}: world 1 parts from the single pipeline at frame "
          f"{report['pipeline']['first_frame_differs']}")
    check(report["pipeline"]["max_abs_trans_vs_single_m"] < DIST_TRANS_M
          and report["pipeline"]["max_abs_rot_vs_single"] < DIST_ROT
          and report["pipeline"]["keyframe_flags_equal"] >= DIST_KF_AGREE,
          f"{label}: sharded pipeline too far from the single-device one")
    for r, p in enumerate(pipe + loop):
        check(p["k1_launches"] == p["gn_iters"] > 0,
              f"{label}: rank {r % world} K1 launches {p['k1_launches']} != GN iterations "
              f"{p['gn_iters']}")
        check(p["loop_factors"] == 0 or p["k2_launches"] > 0,
              f"{label}: rank {r % world} closed a loop without K2")
    for runs in (pipe, loop):
        check(len({(p["k1_launches"], p["k2_launches"]) for p in runs}) == 1,
              f"{label}: ranks launched the kernels unequally")
    check(loop[0]["loop_factors"] >= 1, f"{label}: no loop closed on the loop course")
    return {**{k: pipe[0][f"{n}_launches"] + loop[0][f"{n}_launches"]
               for k, n in (("knn_grid_topk", "k1"), ("knn_bruteforce", "k2"),
                            ("voxel_filter", "voxel_filter"))},
            # the segment sum (the local matvec): one sharded solve and one
            # inner-outer solve on rank 0
            "segment_sum": m0["solve"]["segment_sum_launches_per_solve"]
            + m0["inner"]["segment_sum_launches_per_solve"]}


def phase_dist(pool: ThreadPoolExecutor, meanwhile=None) -> dict:
    """The distributed modes on the card, against the single-device port on
    the same inputs: one launch over every visible card on NCCL (one rank a
    card), one of DIST_GLOO_RANKS gloo ranks sharing card 0 (NCCL refuses
    two ranks on one card): the sharded arithmetic — padding, blocks,
    all-gather, reduce-scatter, the first rank's prior — runs on the card.
    Four ranks on one card show correctness, not scaling. The kernels were
    built here (phase_device), so the ranks load the same library. The two
    launches run side by side (threads of ``pool``), so their times are
    taken on a shared card; ``meanwhile`` runs here while they run."""
    knn_cuda.load_library()
    t0 = time.perf_counter()
    ref = dist_references()
    emit("dist_reference", seconds=time.perf_counter() - t0,
         single_solve_ms_per_gn_step={k: v["ms_per_gn_step"] for k, v in ref.items()
                                      if k.startswith("solve")},
         single_scan_ms_per_iter=ref["scan"]["ms_per_iter"],
         single_pipeline_ms_per_frame_p50=percentile(ref["pipeline"]["ms"], 50))
    with tempfile.TemporaryDirectory() as tmp:
        runs = {
            "dist_nccl": pool.submit(dist_run, "nccl", torch.cuda.device_count(), "nccl", None,
                                     ref, tmp),
            f"dist_gloo{DIST_GLOO_RANKS}": pool.submit(
                dist_run, f"gloo{DIST_GLOO_RANKS}", DIST_GLOO_RANKS, "gloo", "cuda:0", ref, tmp),
        }
        if meanwhile is not None:
            meanwhile()
        wait(runs.values())
        return {k: f.result() for k, f in runs.items()}


# ---------------------------------------------------------------------------

def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--phases",
        default="device,kernels,main_path,resident_path,split,loop_path,resident_loop_path,"
                "repeat,gps_path,growth_path,faults,multistream_path,cli,dist",
    )
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--parent", help="repair_cost, scan_gn_parent, kernels_parent: an older "
                                     "checkout to compare with")
    args = ap.parse_args()
    phases = args.phases.split(",")
    full = {
        "device", "kernels", "main_path", "resident_path", "loop_path",
        "resident_loop_path", "repeat", "gps_path", "growth_path", "faults", "multistream_path",
        "cli", "dist",
    } <= set(phases)

    t_start = time.perf_counter()
    # The worker processes fork here, before this process makes a CUDA
    # context, and cast every course's scans while the kernels build.
    start = "forkserver" if torch.cuda.is_initialized() else "fork"
    scan_pool = ProcessPoolExecutor(SCAN_WORKERS, mp_context=multiprocessing.get_context(start))
    try:
        run_phases(args, phases, full, t_start, scan_pool)
    finally:
        scan_pool.shutdown(cancel_futures=True)


def run_phases(args, phases, full, t_start, scan_pool) -> None:
    draw_courses(scan_pool)
    smi = phase_device(args.ptxas)
    kern = phase_kernels("main_path" not in phases) if "kernels" in phases else None
    main_counts = loop_counts = res_counts = res_loop_counts = multi_counts = dist_counts = None
    front_tick = {}
    vr_lanes = pcg_lanes = lin_lanes = fus_lanes = sg_lanes = ia_lanes = pre_lanes = None
    dsk_lanes = sc_lanes = pcg_main_args = None
    res_loop_run, new_counts = None, {}
    if "main_path" in phases:
        cases = {}
        with capture_kernel_args(cases):
            pipe, main_counts = phase_main_path()
        pcg_main = pcg_main_args = pcg_cases(cases)
        lin_main = split_lin = linearize_case(cases)
        pre_main = cases["preintegrate"]
        fus_case = fusion_case(cases)
        sg_case = {k: cases.pop(k) for k in ("scan_linearize", "scan_update_first", "scan_update",
                                             "transform") if k in cases}
        dsk_main, sc_main = cases.get("deskew"), cases.get("make_descriptor")
        if kern is not None:
            kern["knn_grid_topk"] = phase_k1_main_grid(pipe)
            kern["voxel_filter"] = phase_voxel_filter(cases)
            kern["segment_sum"] = phase_segment_sum()
            kern["pcg_solve"] = phase_pcg(pcg_main, "main_path")
            kern["linearize_normal"] = phase_linearize(lin_main, "main_path")
            kern["fusion_step"] = phase_fusion(fus_case, "main_path")
            kern["preintegrate"] = phase_preintegrate(preintegrate_case(cases), "main_path")
            kern["preintegrate_k256"] = phase_preintegrate(
                preint_seeded_case(), f"seeded K={PREINT_K256[0]} window")
            kern["scan_gn"] = phase_scan_gn(dict(sg_case), "main_path")
            kern["deskew"] = phase_deskew(front_case(cases, "deskew"), "main_path")
            for K, n_valid in DESKEW_SEEDED:
                kern[f"deskew_k{K}"] = phase_deskew(
                    deskew_seeded_case(K, n_valid),
                    f"seeded K={K} ({n_valid} valid), 4 lanes, lane 0's window empty")
            kern["scancontext"] = phase_descriptor(front_case(cases, "make_descriptor"),
                                                   "main_path")
        if "fusion_profile" in phases:
            phase_fusion_profile(fus_case, "main_path")
        if "scan_gn_profile" in phases:
            phase_scan_gn_profile(sg_case, "main_path")
        if "scan_gn_parent" in phases:
            phase_scan_gn_parent(sg_case, "main_path", args.parent)
        if "linearize_profile" in phases:
            phase_linearize_profile(lin_main, "main_path")
        if "preintegrate_profile" in phases:
            phase_preintegrate_profile(pre_main, "main_path")
        if "voxel_parent" in phases:
            phase_voxel_parent({
                **{k: ("main_path", cases[k]) for k in cases if k.startswith("voxel_filter_out")},
                "lanes8": (f"seeded {VOXEL_SEEDED[0]} lanes", voxel_seeded_lanes(*VOXEL_SEEDED))},
                args.parent, pipe)
        if "voxel_profile" in phases:
            phase_voxel_profile(cases, "main_path")
        if "front_profile" in phases:
            lanes, raw = max(MULTI_LANES), MULTI_CAPS["raw_capacity"]
            phase_front_profile(
                {"main_path": dsk_main,
                 **{f"seeded K={K}": deskew_seeded_case(K, n_valid)
                    for K, n_valid in DESKEW_SEEDED},
                 f"seeded {lanes} lanes x {raw}": deskew_seeded_case(64, 12, lanes, raw)},
                {"main_path": sc_main, f"seeded {lanes} lanes x {raw}": seeded_clouds(lanes, raw)})
        if "kernels_parent" in phases:
            phase_kernels_parent({
                "linearize_normal": ("linearize", "main_path", lin_main),
                "preintegrate": ("preintegrate", "main_path", pre_main),
                "preintegrate_k256": ("preintegrate", "seeded K=256 window",
                                      preint_seeded_case()),
                "deskew": ("deskew", "main_path", dsk_main),
                **{f"deskew_k{K}": ("deskew", f"seeded K={K} ({n_valid} valid), 4 lanes",
                                    deskew_seeded_case(K, n_valid))
                   for K, n_valid in DESKEW_SEEDED},
                "make_descriptor": ("scancontext", "main_path", sc_main)}, args.parent)
        del lin_main, pre_main, fus_case, sg_case, cases, dsk_main, sc_main
        resident = None
        if "resident_path" in phases:
            res_cases = {}
            with capture_kernel_args(res_cases):
                resident, res_counts = phase_resident_path(pipe.trajectory_arrays()[1])
            if kern is not None:
                kern["fusion_step_resident"] = phase_fusion(fusion_case(res_cases),
                                                            "resident_path")
                kern["scan_gn_resident"] = phase_scan_gn(res_cases, "resident_path")
                kern["preintegrate_resident"] = phase_preintegrate(
                    preintegrate_case(res_cases), "resident_path")
                kern["deskew_resident"] = phase_deskew(front_case(res_cases, "deskew"),
                                                       "resident_path")
                kern["scancontext_resident"] = phase_descriptor(
                    front_case(res_cases, "make_descriptor"), "resident_path (its last keyframe)")
                # the resident full solve's arguments (the main course lands
                # no loop or GPS factor, so the path itself runs none)
                rp = resident[0]
                res_cases = {}
                with capture_kernel_args(res_cases):
                    tres._solve_graph_resident(rp.state, rp.params, True)
                kern["pcg_solve_resident_full"] = phase_pcg(pcg_cases(res_cases),
                                                            "resident_path full solve")
                lin_full = linearize_case(res_cases)
                kern["linearize_normal_resident_full"] = phase_linearize(
                    lin_full, "resident_path full solve")
                if "linearize_profile" in phases:
                    phase_linearize_profile(lin_full, "resident_path full solve")
                del rp, res_cases
        if "split" in phases:
            phase_split(pipe, split_lin, resident)
        del pipe, resident, split_lin
    if "profile" in phases:
        phase_profile()
    if "profile_resident" in phases:
        phase_profile(resident=True)
    if "pcg_profile" in phases:
        phase_pcg_profile(pcg_main_args)
    if "edge_floor" in phases:
        phase_edge_floor()
    if "repair_cost" in phases:
        phase_repair_cost(args.parent)
    if "first_frames" in phases:
        phase_first_frames(args.parent)
    if "loop_path" in phases:
        loop_counts = phase_loop_path()
    if "resident_loop_path" in phases:
        rl_cases = {}
        with capture_kernel_args(rl_cases):
            res_loop_counts, res_loop_run = phase_resident_loop_path()
        if kern is not None:
            kern["icp_align"] = phase_icp_align(rl_cases, "resident_loop_path")
        del rl_cases
    if "repeat" in phases:
        new_counts["repeat"] = phase_repeat()
    if "gps_path" in phases:
        new_counts["gps_path"] = phase_gps_path()
    if "growth_path" in phases:
        if res_loop_run is None:
            res_loop_run = phase_resident_loop_path()[1]
        new_counts["growth_path"] = phase_growth_path(res_loop_run)
    if "faults" in phases:
        new_counts["faults"] = phase_faults()
    if "multistream_path" in phases:
        (multi_counts, vr_lanes, pcg_lanes, lin_lanes, fus_lanes, sg_lanes, ia_lanes,
         pre_lanes, dsk_lanes, sc_lanes, front_tick) = phase_multistream_path()
    if "kernels_parent" in phases:
        # the 8-lane tick's deskew and descriptor launches (multistream_path's
        # last), or seeded ones of the tick's shape when multistream_path did
        # not run (or had no keyframe tick)
        lanes, raw = max(MULTI_LANES), MULTI_CAPS["raw_capacity"]
        tick, seeded = f"multistream_path_{lanes}", f"seeded {lanes} lanes x {raw} points"
        dsk_tick = front_tick.get("deskew")
        sc_tick = front_tick.get("make_descriptor")
        phase_kernels_parent({
            "deskew_lanes8": ("deskew", tick if dsk_tick else seeded,
                              dsk_tick or deskew_seeded_case(64, 12, lanes, raw)),
            "make_descriptor_lanes8": ("scancontext", tick if sc_tick else seeded,
                                       sc_tick or seeded_clouds(lanes, raw))},
            args.parent)
    # The closing phases wait on processes of their own (cli runs, dist
    # ranks), so those run side by side in threads; this process's own
    # torch work stays on this thread (torch.func's forward-AD levels are
    # process-wide), the dist references and every path before alone.
    small_cpu = phase_gps_small_cpu if "gps_path" in phases else None
    with ThreadPoolExecutor(4) as pool, tempfile.TemporaryDirectory(prefix="liorf_gps_") as tmp:
        gps_cli = pool.submit(gps_cli_run, tmp) if "gps_path" in phases else None
        side = [pool.submit(phase_cli)] if "cli" in phases else []
        if "dist" in phases:
            dist_counts = phase_dist(pool, small_cpu)
        elif small_cpu is not None:
            small_cpu()
        wait(side + [gps_cli] if gps_cli else side)
        for f in side:
            f.result()
        if gps_cli is not None:
            phase_gps_cli(gps_cli.result(), tmp)
    torch.cuda.synchronize()
    emit("done", seconds=time.perf_counter() - t_start, phases=phases)
    if not full:
        # a partial run is for development: it proves nothing as a whole
        print("partial run: no result line", file=sys.stderr)
        sys.exit(4)

    def row(name, replaces, launches, r=None, source=KERNEL_SOURCE, **extra):
        r = kern[name] if r is None else r
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "ms_cold_l2": r["ms_cold_l2"],
            "ms_single_call": r["ms_single_call"],
            **extra,
        }

    # launches: K1, the voxel filter's reduction, the PCG and the
    # linearization from the main path's run, K2 from the loop path's run
    # (the only classic path that reaches it), the segment sum from the dist
    # ranks' (its one remaining site); each counted from 0 just before its
    # path. launches_by_path adds the other paths' counts (the dist ranks
    # count K1, K2, the segment sum and the voxel filter's reduction).
    single_device = {
        "main_path": main_counts, "loop_path": loop_counts, "resident_path": res_counts,
        "resident_loop_path": res_loop_counts, **new_counts,
        **{f"multistream_path_{n}": c for n, c in multi_counts.items()},
    }

    def by_path(name):
        return {**{path: c[name] for path, c in single_device.items()},
                **{path: c[name] for path, c in dist_counts.items() if name in c}}

    def lanes8(name):
        r = kern[name]
        return {k: r[k] for k in ("shape", "ms", "ms_single_call", "one_lane_ms", "plain_ms",
                                  "bound_ms", "bound_by", "max_abs_err")}

    k1 = kern["knn_grid_topk"]
    kernels = [
        row("knn_grid_topk",
            "liorf_tpu/ops/knn_pallas.py:132 + the gather at liorf_tpu/ops/knn.py:151-173",
            main_counts["knn_grid_topk"], sum_runs=k1["sum_runs"],
            l2_candidate_bytes=k1["l2_candidate_bytes"],
            launches_by_path=by_path("knn_grid_topk"), lanes8=lanes8("knn_grid_topk_lanes8")),
        row("knn_bruteforce", "liorf_tpu/ops/knn_pallas.py:187", loop_counts["knn_bruteforce"],
            launches_by_path=by_path("knn_bruteforce"), lanes8=lanes8("knn_bruteforce_lanes8")),
    ]
    seg = kern["segment_sum"]
    matvec = seg["dist_matvec"]
    kernels.append(row(
        "segment_sum",
        "none (not a TPU kernel): the card's atomic index_add in "
        "liorf_tpu_torch/dist/shard_map_solver.py (SegmentPlan.sum)",
        dist_counts["dist_nccl"]["segment_sum"], r=matvec, source=SEGSUM_SOURCE,
        shape=matvec["shape"], launches_by_path=by_path("segment_sum"),
        by_site={k: {f: v[f] for f in ("shape", "ms", "ms_cold_l2", "ms_single_call", "plain_ms",
                                        "library_ms", "bound_ms", "max_abs_err",
                                        "index_put_repeats")}
                 for k, v in seg.items()}))
    vox = kern["voxel_filter"]
    scan_voxel = vox[f"voxel_filter_out{BENCH_CAPS['scan_capacity']}"]
    vox_fields = ("shape", "lanes", "ms", "ms_cold_l2", "ms_single_call", "device_ms", "plain_ms",
                  "library_ms", "bound_ms", "bound_by", "max_abs_err", "lexsort_ms", "cells_ms",
                  "kernel_launches_per_call")
    kernels.append(row(
        "voxel_filter",
        "none (not a TPU kernel): the eager filter of liorf_tpu_torch/core/voxel.py on the card "
        "(_cells, lexsort's four stable argsorts, and the voxel_reduce kernels after them; the "
        "JAX package's lexsort and .at[].add / .at[].min at liorf_tpu/core/voxel.py:38-69)",
        main_counts["voxel_filter"], r=scan_voxel, source=VOXEL_SOURCE,
        shape=scan_voxel["shape"], device_ms=scan_voxel["device_ms"],
        launches_by_path=by_path("voxel_filter"),
        voxel_filter_calls_by_path=by_path("voxel_filter_calls"),
        by_site={k: {f: v[f] for f in vox_fields} for k, v in vox.items()},
        lanes8={k: {f: v[f] for f in vox_fields} for k, v in vr_lanes.items()}))
    # the PCG row: the main path's last launch shape (its window solves)
    pcg_main = max(kern["pcg_solve"].values(), key=lambda r: r["shape"]["iters"])
    pcg_fields = ("shape", "ms", "ms_cold_l2", "ms_single_call", "device_ms", "cluster",
                  "layout", "plain_ms", "op_by_op_ms", "bound_ms", "bound_by",
                  "flops", "max_abs_err")
    kernels.append(row(
        "pcg_solve",
        "none (not a TPU kernel): the op-by-op PCG of liorf_tpu_torch/graph/pose_graph.py "
        "(pose_graph._pcg; the JAX package's lax.scan at liorf_tpu/graph/pose_graph.py:220-253), "
        "with the fixed-order dot (fixed_dot) and the matvec's segment sum folded in",
        main_counts["pcg_solve"], r=pcg_main, source=PCG_SOURCE, shape=pcg_main["shape"],
        op_by_op_ms=pcg_main["op_by_op_ms"], device_ms=pcg_main["device_ms"],
        cluster=pcg_main["cluster"],
        launches_by_path=by_path("pcg_solve"), gn_steps_by_path=by_path("pose_graph_gn_steps"),
        resident_full={k: {f: v[f] for f in pcg_fields}
                       for k, v in kern["pcg_solve_resident_full"].items()},
        lanes8={k: {f: v[f] for f in pcg_fields} for k, v in pcg_lanes.items()}))
    # the linearization row: the main path's last launch (a window solve's)
    lin_fields = ("shape", "active", "ms", "ms_cold_l2", "ms_single_call", "device_ms",
                  "plain_ms", "op_by_op_ms", "bound_ms", "bound_by", "flops", "max_abs_err",
                  "jacfwd_max_rel_diff", "jacfwd_rhs_diff_over_stiffness",
                  "kernel_launches_per_call", "host_parts_us")
    lin_main = kern["linearize_normal"]
    kernels.append(row(
        "linearize_normal",
        "none (not a TPU kernel): the jacfwd linearization and its SegmentPlan sums of "
        "liorf_tpu_torch/graph/pose_graph.py (the JAX package's jitted _build_normal_terms at "
        "liorf_tpu/graph/pose_graph.py:99-117,141-202)",
        main_counts["linearize_normal"], r=lin_main, source=LINEARIZE_SOURCE,
        shape=lin_main["shape"], op_by_op_ms=lin_main["op_by_op_ms"],
        device_ms=lin_main["device_ms"],
        kernel_launches_per_call=lin_main["kernel_launches_per_call"],
        host_parts_us=lin_main["host_parts_us"],
        jacfwd_max_rel_diff=lin_main["jacfwd_max_rel_diff"],
        jacfwd_rhs_diff_over_stiffness=lin_main["jacfwd_rhs_diff_over_stiffness"],
        launches_by_path=by_path("linearize_normal"),
        resident_full={f: kern["linearize_normal_resident_full"][f] for f in lin_fields},
        lanes8={f: lin_lanes[f] for f in lin_fields}))
    # the fusion row: the main path's last launch (one lane)
    fus_fields = ("shape", "ms", "ms_cold_l2", "ms_single_call", "device_ms", "plain_ms",
                  "op_by_op_ms", "bound_ms", "bound_by", "flops", "max_abs_err",
                  "float64_mean_max_abs_diff", "float64_info_max_rel_diff",
                  "jacfwd_mean_max_abs_diff", "jacfwd_info_max_rel_diff")
    fus_main = kern["fusion_step"]
    kernels.append(row(
        "fusion_step",
        "none (not a TPU kernel): the op-by-op jacfwd fusion step of "
        "liorf_tpu_torch/imu/fusion.py (fusion_step_jacfwd; the JAX package's jitted fusion_step "
        "at liorf_tpu/imu/fusion.py:98-213)",
        main_counts["fusion_step"], r=fus_main, source=FUSION_SOURCE, shape=fus_main["shape"],
        op_by_op_ms=fus_main["op_by_op_ms"], device_ms=fus_main["device_ms"],
        float64_mean_max_abs_diff=fus_main["float64_mean_max_abs_diff"],
        jacfwd_mean_max_abs_diff=fus_main["jacfwd_mean_max_abs_diff"],
        jacfwd_info_max_rel_diff=fus_main["jacfwd_info_max_rel_diff"],
        launches_by_path=by_path("fusion_step"), fusion_calls_by_path=by_path("fusion_calls"),
        resident={f: kern["fusion_step_resident"][f] for f in fus_fields},
        lanes8={f: fus_lanes[f] for f in fus_fields}))
    # the preintegration row: the main path's last launch (one lane)
    pre_fields = ("shape", "ms", "ms_cold_l2", "ms_single_call", "device_ms", "plain_ms",
                  "library_ms", "bound_ms", "bound_by", "bytes", "flops", "max_abs_err",
                  "sequential_max_ratio_to_bound", "exact_max_ratio_to_bound",
                  "kernel_launches_per_call", "host_parts_us")
    pre_main = kern["preintegrate"]
    kernels.append(row(
        "preintegrate",
        "none (not a TPU kernel): the eager log-depth tree (a Hillis-Steele prefix and pairwise "
        "_compose levels) of liorf_tpu_torch/imu/preintegration.py::preintegrate (the JAX "
        "package's jitted preintegrate, two lax.associative_scans, at "
        "liorf_tpu/imu/preintegration.py:56-162)",
        main_counts["preintegrate"], r=pre_main, source=PREINT_SOURCE, shape=pre_main["shape"],
        device_ms=pre_main["device_ms"],
        kernel_launches_per_call=pre_main["kernel_launches_per_call"],
        host_parts_us=pre_main["host_parts_us"],
        sequential_max_ratio_to_bound=pre_main["sequential_max_ratio_to_bound"],
        exact_max_ratio_to_bound=pre_main["exact_max_ratio_to_bound"],
        launches_by_path=by_path("preintegrate"),
        preintegrate_calls_by_path=by_path("preintegrate_calls"),
        resident={f: kern["preintegrate_resident"][f] for f in pre_fields},
        lanes8={f: pre_lanes[f] for f in pre_fields},
        seeded_k256={f: kern["preintegrate_k256"][f] for f in pre_fields}))
    # the scan matcher's rows: the main path's last launches (one lane)
    gn_fields = ("shape", "ms", "ms_cold_l2", "ms_single_call", "device_ms", "plain_ms",
                 "library_ms", "library_call", "bound_ms", "bound_by", "bytes", "flops",
                 "max_abs_err")
    sg_fields = (*gn_fields, "kernel_launches_per_call")
    gn_replaces = ("none (not a TPU kernel): the eager ops and library solvers of "
                   "liorf_tpu_torch/ops/scan_match.py::_build_system_lanes / scan_to_map_lanes "
                   "and ops/plane_fit.py (the JAX package's XLA at "
                   "liorf_tpu/ops/scan_match.py:83-121,164-195 and liorf_tpu/ops/plane_fit.py:22-55)")
    sg = kern["scan_gn"]
    for name in ("scan_linearize", "scan_update"):
        r = sg.get(name, sg["scan_update_first"])
        kernels.append(row(
            name, gn_replaces, main_counts[name], r=r, source=SCAN_GN_SOURCE, shape=r["shape"],
            device_ms=r["device_ms"], library_call=r["library_call"],
            kernel_launches_per_call=r["kernel_launches_per_call"],
            launches_by_path=by_path(name), k1_launches_by_path=by_path("knn_grid_topk"),
            first_iteration=({f: sg["scan_update_first"][f] for f in sg_fields}
                             if name == "scan_update" else None),
            resident={k: {f: v[f] for f in sg_fields} for k, v in kern["scan_gn_resident"].items()},
            lanes8={k: {f: v[f] for f in sg_fields} for k, v in sg_lanes.items()}))
    tf = sg["transform"]
    kernels.append(row(
        "transform",
        "none (not a TPU kernel): the eager moved scan (se3.euler_to_rot, a batched product, an "
        "add) of liorf_tpu_torch/ops/scan_match.py and ops/icp.py",
        main_counts["transform"], r=tf, source=SCAN_GN_SOURCE, shape=tf["shape"],
        device_ms=tf["device_ms"], op_by_op_ms=tf["op_by_op_ms"],
        kernel_launches_per_call=tf["kernel_launches_per_call"],
        launches_by_path=by_path("transform"), scan_to_map_calls_by_path=by_path("scan_to_map_calls"),
        resident={f: kern["scan_gn_resident"]["transform"][f] for f in sg_fields},
        lanes8={f: sg_lanes["transform"][f] for f in sg_fields}))
    # ICP's row: the resident loop path's last launch (one lane); launches
    # from the loop path's run, as K2's
    ia = kern["icp_align"]
    kernels.append(row(
        "icp_align",
        "none (not a TPU kernel): the eager Kabsch step (torch.linalg.svd, det) of "
        "liorf_tpu_torch/ops/icp.py::icp_point2point_lanes (the JAX package's XLA at "
        "liorf_tpu/ops/icp.py:73-91)",
        loop_counts["icp_align"], r=ia, source=ICP_ALIGN_SOURCE, shape=ia["shape"],
        device_ms=ia["device_ms"], library_call=ia["library_call"],
        launches_by_path=by_path("icp_align"), k2_launches_by_path=by_path("knn_bruteforce"),
        icp_runs_by_path=by_path("icp_runs"),
        lanes=({f: ia_lanes[f] for f in gn_fields} | {"correspondences": ia_lanes["correspondences"]})))
    # the front end's rows: the main path's last launches (one lane)
    front_fields = ("shape", "ms", "ms_cold_l2", "ms_single_call", "device_ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_by", "bytes", "flops", "max_abs_err",
                    "kernel_launches_per_call", "host_parts_us")
    dsk = kern["deskew"]
    kernels.append(row(
        "deskew",
        "none (not a TPU kernel): the ~70 eager launches of liorf_tpu_torch/ops/deskew.py "
        "(integrate_gyro + deskew_scan; the JAX package's jitted lines at "
        "liorf_tpu/ops/deskew.py:35-108)",
        main_counts["deskew"], r=dsk, source=DESKEW_SOURCE, shape=dsk["shape"],
        device_ms=dsk["device_ms"], cpu_max_abs_diff=dsk["cpu_max_abs_diff"],
        kernel_launches_per_call=dsk["kernel_launches_per_call"],
        host_parts_us=dsk["host_parts_us"],
        launches_by_path=by_path("deskew"), deskew_calls_by_path=by_path("deskew_calls"),
        resident={f: kern["deskew_resident"][f] for f in front_fields},
        lanes8={f: dsk_lanes[f] for f in front_fields},
        seeded={f"K{K}": {f: kern[f"deskew_k{K}"][f] for f in front_fields}
                for K, _ in DESKEW_SEEDED}))
    sc = kern["scancontext"]
    kernels.append(row(
        "make_descriptor",
        "none (not a TPU kernel): the ~15 eager launches of "
        "liorf_tpu_torch/ops/scancontext.py::make_descriptor (the JAX package's jitted "
        "make_descriptor at liorf_tpu/ops/scancontext.py:34-53)",
        main_counts["make_descriptor"], r=sc, source=SC_SOURCE, shape=sc["shape"],
        device_ms=sc["device_ms"], library_call=sc["library_call"],
        kernel_launches_per_call=sc["kernel_launches_per_call"],
        host_parts_us=sc["host_parts_us"],
        cpu_bins_differing=sc["cpu_bins_differing"],
        launches_by_path=by_path("make_descriptor"),
        descriptor_calls_by_path=by_path("descriptor_calls"),
        resident={f: kern["scancontext_resident"][f] for f in front_fields},
        lanes8={f: sc_lanes[f] for f in front_fields} | {"path": sc_lanes["path"]}))
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was never launched by its path")
    check(res_counts["knn_grid_topk"] > 0, "K1 never launched on the resident path")
    check(res_loop_counts["knn_bruteforce"] > 0, "K2 never launched on the resident loop path")
    check(all(c["knn_grid_topk"] > 0 for c in multi_counts.values()),
          "K1 never launched on the multistream path")
    check(all(c["knn_grid_topk"] > 0 and c["knn_bruteforce"] > 0 for c in dist_counts.values()),
          "K1 or K2 never launched on the dist path")
    check(all(c["segment_sum"] > 0 and c["voxel_filter"] > 0 for c in dist_counts.values()),
          "the segment sum or the voxel filter never launched on the dist path")
    check(all(c["knn_grid_topk"] > 0 and c["voxel_filter"] > 0 and c["pcg_solve"] > 0
              for c in new_counts.values()),
          "K1, the voxel filter or the PCG kernel never launched on repeat, gps_path, "
          "growth_path or faults")
    check(new_counts["growth_path"]["knn_bruteforce"] > 0, "K2 never launched on growth_path")
    for path, c in single_device.items():
        check(c["pcg_solve"] > 0 and c["pcg_solve"] == c["pose_graph_gn_steps"],
              f"{path}: {c['pcg_solve']} PCG launches for {c['pose_graph_gn_steps']} GN steps")
        check(c["linearize_normal"] == c["pose_graph_gn_steps"],
              f"{path}: {c['linearize_normal']} linearize launches for "
              f"{c['pose_graph_gn_steps']} GN steps")
        check(c["voxel_filter"] > 0 and c["voxel_filter"] == c["voxel_filter_calls"],
              f"{path}: {c['voxel_filter']} voxel_filter launches for "
              f"{c['voxel_filter_calls']} voxel filter calls")
        check(c["segment_sum"] == 0,
              f"{path}: {c['segment_sum']} segment sum launches on a single-device path")
        check(c["fusion_step"] > 0 and c["fusion_step"] == c["fusion_calls"],
              f"{path}: {c['fusion_step']} fusion_step launches for {c['fusion_calls']} "
              f"fusion calls")
        check(c["preintegrate"] > 0 and c["preintegrate"] == c["preintegrate_calls"],
              f"{path}: {c['preintegrate']} preintegrate launches for "
              f"{c['preintegrate_calls']} preintegrate calls")
        check(c["deskew"] > 0 and c["deskew"] == c["deskew_calls"],
              f"{path}: {c['deskew']} deskew launches for {c['deskew_calls']} deskew calls")
        check(c["make_descriptor"] > 0 and c["make_descriptor"] == c["descriptor_calls"],
              f"{path}: {c['make_descriptor']} descriptor launches for "
              f"{c['descriptor_calls']} make_descriptor calls")
        # one linearization and one update a (batched) GN iteration, as K1;
        # one alignment an ICP iteration: K2 less each run's last pass
        check(c["scan_linearize"] == c["knn_grid_topk"] == c["scan_update"],
              f"{path}: {c['scan_linearize']} scan_linearize and {c['scan_update']} scan_update "
              f"launches for {c['knn_grid_topk']} K1 launches")
        check(c["icp_align"] == c["knn_bruteforce"] - c["icp_runs"],
              f"{path}: {c['icp_align']} icp_align launches for {c['knn_bruteforce']} K2 "
              f"launches in {c['icp_runs']} ICP runs")
        # one first move a scan match and an ICP run
        check(c["transform"] == c["scan_to_map_calls"] + c["icp_runs"],
              f"{path}: {c['transform']} transform launches for {c['scan_to_map_calls']} scan "
              f"matches and {c['icp_runs']} ICP runs")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
