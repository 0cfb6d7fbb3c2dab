"""The two hand-written Hopper k-NN kernels, their plain versions and wrappers.

* ``topk_candidates`` (K1) replaces ``liorf_tpu/ops/knn_pallas.py:
  topk_candidates_pallas`` — the tail of ``knn.knn_grid``: for each query,
  squared distances to its C gathered candidates and the k smallest.
  Memory-bound (N*C*12 bytes of coordinates streamed once; of cand_idx only
  the k winners per row are read); one warp per query, private register
  top-k per lane, warp arg-min rounds (see csrc/knn_kernels.cu).
* ``knn_bruteforce`` (K2) replaces ``knn_bruteforce_pallas`` — exact k-NN of
  N queries against M masked targets. Compute-bound on the CUDA cores
  (N*M pairs x 8 flop); 32 queries x 8 target slices per block, targets
  staged through shared memory, register top-k, shared-memory merge.

Both use direct-difference distances ``(dx*dx + dy*dy) + dz*dz`` with every
operation rounded separately, and so do the plain versions below: kernel and
plain version agree bit for bit, ties resolve to the lower index in both.
(The TPU K2 used the |q|^2+|t|^2-2q.t expansion, knn_pallas.py:47-51.)

Dispatch is by the tensor's device and nothing else: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises. There is no
fallback on a failed build or launch.

The CUDA source is compiled at first use with ``nvcc`` into
``build/liorf_tpu_torch/`` beside the package (or ``$LIORF_TORCH_BUILD_DIR``)
and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

MAX_K = 8
_BIG = 1e30  # "no neighbour" coordinate / distance threshold of the callers

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "knn_kernels.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lib = None
build_seconds: float | None = None  # wall time of the nvcc run, if one was needed


def _build_dir() -> Path:
    env = os.environ.get("LIORF_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "liorf_tpu_torch"


def _find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "k-NN kernels cannot be built"
    )


def load_library(extra_flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    src = _SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS + extra_flags).encode()).hexdigest()[:12]
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"libknn_kernels_{tag}.so"
    if not so.exists():
        tmp = out_dir / f".{so.name}.{os.getpid()}.tmp"
        cmd = [_find_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(_SOURCE)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        if extra_flags and (proc.stdout or proc.stderr):
            print(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.liorf_knn_max_k.argtypes = []
    lib.liorf_knn_max_k.restype = ci
    lib.liorf_topk_candidates.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.liorf_topk_candidates.restype = ci
    lib.liorf_knn_bruteforce.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.liorf_knn_bruteforce.restype = ci
    if lib.liorf_knn_max_k() != MAX_K:
        raise RuntimeError("kernel library and wrapper disagree on MAX_K")
    _lib = lib
    return lib


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k}: the kernels take 1 <= k <= {MAX_K}")


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(dx*dx + dy*dy) + dz*dz over the last axis, in the kernels' order."""
    d = a - b
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    return (dx * dx + dy * dy) + dz * dz


def _launch_error(name: str, err: int) -> RuntimeError:
    return RuntimeError(f"{name}: CUDA launch failed with error {err}")


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

def topk_candidates_plain(
    queries: torch.Tensor, cand_xyz: torch.Tensor, cand_idx: torch.Tensor, k: int = 5
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`topk_candidates` (same contract)."""
    n, c = cand_idx.shape
    d2 = _sq_dist(cand_xyz, queries[:, None, :])  # [N, C]
    d2 = torch.where(d2 < _BIG * 0.5, d2, torch.inf)
    if c < k:
        pad = torch.full((n, k - c), torch.inf, dtype=d2.dtype, device=d2.device)
        d2 = torch.cat([d2, pad], dim=1)
        cand_idx = torch.cat([cand_idx, torch.zeros_like(pad, dtype=cand_idx.dtype)], dim=1)
    # stable sort: equal distances keep candidate order (lower position first)
    vals, pos = torch.sort(d2, dim=1, stable=True)
    vals, pos = vals[:, :k], pos[:, :k]
    idx = torch.gather(cand_idx, 1, pos)
    idx = torch.where(torch.isfinite(vals), idx, 0)
    return vals.contiguous(), idx.to(torch.int32).contiguous()


def topk_candidates(
    queries: torch.Tensor, cand_xyz: torch.Tensor, cand_idx: torch.Tensor, k: int = 5
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest of each query's candidate list.

    queries [N,3] f32, cand_xyz [N,C,3] f32 (invalid candidates pre-set to
    coordinates >= 1e30), cand_idx [N,C] i32. Returns (d2 [N,k] f32,
    idx [N,k] i32) with missing neighbours as (+inf, 0).
    """
    _check_k(k)
    if queries.device.type == "cpu":
        return topk_candidates_plain(queries, cand_xyz, cand_idx, k)
    if queries.device.type != "cuda":
        raise ValueError(f"topk_candidates: unsupported device {queries.device}")
    dev = queries.device
    n, c = cand_idx.shape
    _check(queries, "queries", torch.float32, (n, 3), dev)
    _check(cand_xyz, "cand_xyz", torch.float32, (n, c, 3), dev)
    _check(cand_idx, "cand_idx", torch.int32, (n, c), dev)
    lib = load_library()
    out_d = torch.empty((n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n, k), dtype=torch.int32, device=dev)
    if n == 0:
        return out_d, out_i
    with torch.cuda.device(dev):
        err = lib.liorf_topk_candidates(
            queries.data_ptr(), cand_xyz.data_ptr(), cand_idx.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), n, c, k,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise _launch_error("topk_candidates", err)
    topk_candidates.launches += 1
    return out_d, out_i


topk_candidates.launches = 0


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

def knn_bruteforce_plain(
    map_xyz: torch.Tensor,
    map_mask: torch.Tensor,
    queries: torch.Tensor,
    query_mask: torch.Tensor,
    k: int = 5,
    tile: int = 2048,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`knn_bruteforce` (same contract).

    Streams the targets in tiles with a running top-k merged by a stable
    sort; the running best is concatenated first, so among equal distances
    the lower target index stays ahead.
    """
    n, m = queries.shape[0], map_xyz.shape[0]
    dev = queries.device
    best_d = torch.full((n, k), torch.inf, dtype=queries.dtype, device=dev)
    best_i = torch.zeros((n, k), dtype=torch.int64, device=dev)
    for base in range(0, m, tile):
        t = map_xyz[base:base + tile]
        d2 = _sq_dist(t[None, :, :], queries[:, None, :])  # [N, T]
        d2 = torch.where(map_mask[None, base:base + tile], d2, torch.inf)
        cols = torch.arange(base, base + t.shape[0], device=dev).expand(n, -1)
        all_d = torch.cat([best_d, d2], dim=1)
        all_i = torch.cat([best_i, cols], dim=1)
        vals, pos = torch.sort(all_d, dim=1, stable=True)
        best_d = vals[:, :k]
        best_i = torch.gather(all_i, 1, pos[:, :k])
    missing = ~(best_d < _BIG * 0.5) | ~query_mask[:, None]
    best_d = torch.where(missing, torch.inf, best_d)
    best_i = torch.where(missing, 0, best_i)
    return best_d.contiguous(), best_i.to(torch.int32).contiguous()


def knn_bruteforce(
    map_xyz: torch.Tensor,
    map_mask: torch.Tensor,
    queries: torch.Tensor,
    query_mask: torch.Tensor,
    k: int = 5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN of queries [N,3] against masked targets [M,3].

    Returns (d2 [N,k] f32, idx [N,k] i32); masked queries and missing
    neighbours come back as (+inf, 0).
    """
    _check_k(k)
    if queries.device.type == "cpu":
        return knn_bruteforce_plain(map_xyz, map_mask, queries, query_mask, k)
    if queries.device.type != "cuda":
        raise ValueError(f"knn_bruteforce: unsupported device {queries.device}")
    dev = queries.device
    n, m = queries.shape[0], map_xyz.shape[0]
    _check(map_xyz, "map_xyz", torch.float32, (m, 3), dev)
    _check(map_mask, "map_mask", torch.bool, (m,), dev)
    _check(queries, "queries", torch.float32, (n, 3), dev)
    _check(query_mask, "query_mask", torch.bool, (n,), dev)
    lib = load_library()
    out_d = torch.empty((n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n, k), dtype=torch.int32, device=dev)
    if n == 0:
        return out_d, out_i
    with torch.cuda.device(dev):
        err = lib.liorf_knn_bruteforce(
            map_xyz.data_ptr(), map_mask.data_ptr(), queries.data_ptr(),
            query_mask.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), n, m, k,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise _launch_error("knn_bruteforce", err)
    knn_bruteforce.launches += 1
    return out_d, out_i


knn_bruteforce.launches = 0


def launch_counts() -> dict[str, int]:
    return {
        "topk_candidates": topk_candidates.launches,
        "knn_bruteforce": knn_bruteforce.launches,
    }


def reset_launch_counts() -> None:
    topk_candidates.launches = 0
    knn_bruteforce.launches = 0
