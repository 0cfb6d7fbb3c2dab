"""The two hand-written Hopper k-NN kernels, their plain versions and wrappers.

* ``knn_grid_topk`` (K1) is ``knn.knn_grid`` in one launch: the query's cell,
  the runs of its 27 neighbour cells in the sorted grid (binary searches over
  ``grid.keys``), and the k nearest of their points, read straight from
  ``grid.xyz``. It replaces ``liorf_tpu/ops/knn_pallas.py:
  topk_candidates_pallas`` together with the gather in front of it
  (``liorf_tpu/ops/knn.py:147-173``): no ``[N, 27*bucket(, 3)]`` candidate
  tensor is written. Bound by L2 latency (the grid, ~2 MB at the bench point,
  sits in L2); one warp per query, register top-k per lane, warp arg-min
  rounds (see csrc/knn_kernels.cu).
* ``topk_candidates`` keeps the Pallas kernel's own contract (pre-gathered
  candidates) for the CPU and the parity tests; on a CUDA tensor it raises,
  since the card computes that function only fused, in ``knn_grid_topk``.
* ``knn_bruteforce`` (K2) replaces ``knn_bruteforce_pallas`` — exact k-NN of
  N queries against M masked targets. Bound by instruction slots on the CUDA cores
  (N*M pairs); register tiling (several queries per thread fed by one
  shared-memory load), targets staged by double-buffered ``cp.async``, the
  target range split across blocks with a merge pass when that fills the card.

All use direct-difference distances ``(dx*dx + dy*dy) + dz*dz`` with every
operation rounded separately, and so do the plain versions below: kernel and
plain version agree bit for bit, ties resolve to the lower index in both.
(The TPU K2 used the |q|^2+|t|^2-2q.t expansion, knn_pallas.py:47-51.)

Both kernels take a lane axis: inputs stacked on a leading ``[B]`` axis (one
lock-step session each, ``pipeline/multistream.py``) are served by ONE launch,
the lane being a grid axis of the launch. The per-lane arithmetic is the
one-session kernel's, so lane ``b`` of a stacked call equals a call on lane
``b``'s data bit for bit. The launch counters count launches, not lanes.

Dispatch is by the tensor's device and nothing else: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises. There is no
fallback on a failed build or launch.

The CUDA source is compiled at first use with ``nvcc`` into
``build/liorf_tpu_torch/`` beside the package (or ``$LIORF_TORCH_BUILD_DIR``)
and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..core.build import build_cuda_library

MAX_K = 8
_BIG = 1e30  # "no neighbour" coordinate / distance threshold of the callers

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "knn_kernels.cu"

_lib = None
build_seconds: float | None = None  # wall time of the nvcc run, if one was needed


def load_library(extra_flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    so, build_seconds = build_cuda_library(_SOURCE, extra_flags)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.liorf_knn_max_k.argtypes = []
    lib.liorf_knn_max_k.restype = ci
    lib.liorf_knn_grid_topk.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
    lib.liorf_knn_grid_topk.restype = ci
    lib.liorf_knn_bruteforce_ranges.argtypes = [ci, ci, ci, ci, ci]
    lib.liorf_knn_bruteforce_ranges.restype = ci
    lib.liorf_knn_bruteforce.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp,
    ]
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


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t itself when its data starts on a 16-byte boundary, else a copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ---------------------------------------------------------------------------
# Grid keys: the exact cell packing of knn.build_grid, which K1 recomputes
# for the queries on the card.
# ---------------------------------------------------------------------------

# 10 bits per axis -> 1024^3 cells around the recenter origin. With
# cell_size >= 0.5 m that covers a >=256 m half-extent, larger than the 50 m
# local-map radius + lidar range used by the reference.
_BITS = 10
_HALF = 1 << (_BITS - 1)  # 512
_SENTINEL = 2**31 - 1

# 3x3x3 neighbor offsets, precomputed as key deltas (static python ints);
# they increase strictly in this order.
_NEIGHBOR_OFFSETS = [
    (dx << (2 * _BITS)) + (dy << _BITS) + dz
    for dx in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dz in (-1, 0, 1)
]


def _pack_cells(cell: torch.Tensor, in_range: torch.Tensor) -> torch.Tensor:
    """[..., 3] int cell coords (already offset to [0, 1024)) -> int32 key."""
    key = (cell[..., 0] << (2 * _BITS)) | (cell[..., 1] << _BITS) | cell[..., 2]
    return torch.where(in_range, key, _SENTINEL)


def _cell_coords(xyz: torch.Tensor, origin: torch.Tensor, cell_size):
    rel = (xyz - origin) / cell_size
    cell = torch.floor(rel).to(torch.int32) + _HALF
    in_range = torch.all((cell >= 0) & (cell < (1 << _BITS)), dim=-1)
    return torch.clamp(cell, 0, (1 << _BITS) - 1), in_range


def _neighbor_runs(grid, queries, query_mask):
    """Start / end of the sorted run of each query's 27 neighbor cells."""
    cell, in_range = _cell_coords(queries, grid.origin, grid.cell_size)
    base_key = _pack_cells(cell, in_range & query_mask)  # [N]
    # int32 arithmetic wraps for masked queries (sentinel + offset), as in
    # the JAX original; their candidates are masked out by knn_grid.
    offsets = torch.tensor(_NEIGHBOR_OFFSETS, dtype=torch.int32, device=queries.device)
    nbr_keys = base_key[:, None] + offsets  # [N, 27]
    starts = torch.searchsorted(grid.keys, nbr_keys, right=False, out_int32=True)
    ends = torch.searchsorted(grid.keys, nbr_keys, right=True, out_int32=True)
    return starts, ends


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

def topk_candidates_plain(
    queries: torch.Tensor, cand_xyz: torch.Tensor, cand_idx: torch.Tensor, k: int = 5
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest of each query's pre-gathered candidates, in plain PyTorch.

    The contract of the TPU kernel ``topk_candidates_pallas``: queries [N,3]
    f32, cand_xyz [N,C,3] f32 (invalid candidates pre-set to coordinates
    >= 1e30), cand_idx [N,C] i32 -> (d2 [N,k] f32, idx [N,k] i32), missing
    neighbours (+inf, 0), ties to the lower candidate position.
    """
    n, c = cand_idx.shape
    d2 = _sq_dist(cand_xyz, queries[:, None, :])  # [N, C]
    d2 = torch.where(d2 < _BIG * 0.5, d2, torch.inf)
    if c < k:
        pad = torch.full((n, k - c), torch.inf, dtype=d2.dtype, device=d2.device)
        d2 = torch.cat([d2, pad], dim=1)
        cand_idx = torch.cat([cand_idx, torch.zeros_like(pad, dtype=cand_idx.dtype)], dim=1)
    # k rounds of argmin, each taking the first (lowest) position among equal
    # distances and retiring it: the first k of a stable sort, without
    # sorting all C candidates (missing neighbours come out as (+inf, 0)
    # either way)
    vals, pos = [], []
    for _ in range(k):
        p = torch.argmin(d2, dim=1, keepdim=True)
        vals.append(torch.gather(d2, 1, p))
        pos.append(p)
        d2 = d2.scatter(1, p, torch.inf)
    vals, pos = torch.cat(vals, dim=1), torch.cat(pos, dim=1)
    idx = torch.gather(cand_idx, 1, pos)
    idx = torch.where(torch.isfinite(vals), idx, 0)
    return vals.contiguous(), idx.to(torch.int32).contiguous()


def topk_candidates(
    queries: torch.Tensor, cand_xyz: torch.Tensor, cand_idx: torch.Tensor, k: int = 5
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`topk_candidates_plain` for CPU tensors. The card has no kernel
    for pre-gathered candidates: it computes this function fused with the
    gather, in :func:`knn_grid_topk`, so a CUDA tensor raises here."""
    _check_k(k)
    if queries.device.type == "cpu":
        return topk_candidates_plain(queries, cand_xyz, cand_idx, k)
    raise ValueError(
        f"topk_candidates: no kernel for {queries.device} tensors; on the card the "
        "candidates are gathered inside the kernel: call knn_grid_topk(grid, queries, ...)"
    )


def _lane(grid, b: int):
    """Lane ``b`` of a stacked grid (every field has a leading [B] axis)."""
    return type(grid)(*(f[b] for f in grid))


def knn_grid_topk_plain(
    grid, queries: torch.Tensor, query_mask: torch.Tensor, k: int = 5, bucket: int = 16
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`knn_grid_topk`: the 27 runs by
    ``searchsorted``, the ``[N, 27*bucket]`` gather, then the top-k tail.
    Stacked inputs (queries [B,N,3]) go lane by lane."""
    if queries.dim() == 3:
        outs = [
            knn_grid_topk_plain(_lane(grid, b), queries[b], query_mask[b], k, bucket)
            for b in range(queries.shape[0])
        ]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    n = queries.shape[0]
    starts, ends = _neighbor_runs(grid, queries, query_mask)
    counts = torch.clamp(ends - starts, max=bucket)

    # Candidate indices: [N, 27, bucket]
    offs = torch.arange(bucket, dtype=torch.int32, device=queries.device)
    cand = starts[..., None] + offs
    cand_valid = offs < counts[..., None]
    cand = torch.where(cand_valid, cand, 0).reshape(n, 27 * bucket)
    cand_valid = cand_valid.reshape(n, 27 * bucket)

    cand_xyz = grid.xyz[cand]  # [N, C, 3]
    # invalid candidates pushed to "infinity" via their coordinates, exactly
    # what the TPU path hands its kernel (liorf_tpu/ops/knn.py:171-173). Only
    # query_mask masks: the sentinel run of an out-of-range query's centre
    # cell (invalid map points) stays a candidate, as in the reference.
    sel = (cand_valid & query_mask[:, None])[..., None]
    cand_xyz = torch.where(sel, cand_xyz, _BIG)
    return topk_candidates_plain(queries, cand_xyz, cand, k=k)


def knn_grid_topk(
    grid, queries: torch.Tensor, query_mask: torch.Tensor, k: int = 5, bucket: int = 16
) -> tuple[torch.Tensor, torch.Tensor]:
    """k-NN of queries [N,3] among the points of their 27 neighbour cells.

    ``grid`` is a ``knn.SpatialHashGrid`` (xyz [M,3] f32 and keys [M] i32
    sorted by key, origin [3] f32, cell_size [] f32); each neighbour cell
    contributes at most ``bucket`` points. Returns (d2 [N,k] f32,
    idx [N,k] i32) with indices into the sorted grid and missing neighbours
    as (+inf, 0). One kernel launch on the card; origin and cell_size are
    read there, never on the host.

    Stacked sessions: grid fields [B,M,3], [B,M], [B,3], [B], queries
    [B,N,3], query_mask [B,N] -> [B,N,k]; still one launch.
    """
    _check_k(k)
    if bucket < 1:
        raise ValueError(f"bucket={bucket}: must be >= 1")
    if queries.device.type == "cpu":
        return knn_grid_topk_plain(grid, queries, query_mask, k, bucket)
    if queries.device.type != "cuda":
        raise ValueError(f"knn_grid_topk: unsupported device {queries.device}")
    dev = queries.device
    lead = tuple(queries.shape[:-2])  # () or (B,)
    if len(lead) > 1:
        raise ValueError(f"queries: shape {tuple(queries.shape)}, expected [N,3] or [B,N,3]")
    lanes = lead[0] if lead else 1
    n, m = queries.shape[-2], grid.xyz.shape[-2]
    _check(queries, "queries", torch.float32, lead + (n, 3), dev)
    _check(query_mask, "query_mask", torch.bool, lead + (n,), dev)
    _check(grid.xyz, "grid.xyz", torch.float32, lead + (m, 3), dev)
    _check(grid.keys, "grid.keys", torch.int32, lead + (m,), dev)
    _check(grid.origin, "grid.origin", torch.float32, lead + (3,), dev)
    _check(grid.cell_size, "grid.cell_size", torch.float32, lead, dev)
    lib = load_library()
    out_d = torch.empty(lead + (n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty(lead + (n, k), dtype=torch.int32, device=dev)
    if n == 0 or lanes == 0:
        return out_d, out_i
    with torch.cuda.device(dev):
        err = lib.liorf_knn_grid_topk(
            grid.xyz.data_ptr(), grid.keys.data_ptr(), grid.origin.data_ptr(),
            grid.cell_size.data_ptr(), queries.data_ptr(), query_mask.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), lanes, n, m, k, bucket,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise _launch_error("knn_grid_topk", err)
    knn_grid_topk.launches += 1
    return out_d, out_i


knn_grid_topk.launches = 0


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
    the lower target index stays ahead. Stacked inputs (queries [B,N,3]) go
    lane by lane.
    """
    if queries.dim() == 3:
        outs = [
            knn_bruteforce_plain(map_xyz[b], map_mask[b], queries[b], query_mask[b], k, tile)
            for b in range(queries.shape[0])
        ]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
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
    neighbours come back as (+inf, 0). Stacked sessions: map [B,M,3] + mask
    [B,M], queries [B,N,3] + mask [B,N] -> [B,N,k]; still one launch (and
    the merge pass when the targets are split).
    """
    _check_k(k)
    if queries.device.type == "cpu":
        return knn_bruteforce_plain(map_xyz, map_mask, queries, query_mask, k)
    if queries.device.type != "cuda":
        raise ValueError(f"knn_bruteforce: unsupported device {queries.device}")
    dev = queries.device
    lead = tuple(queries.shape[:-2])  # () or (B,)
    if len(lead) > 1:
        raise ValueError(f"queries: shape {tuple(queries.shape)}, expected [N,3] or [B,N,3]")
    lanes = lead[0] if lead else 1
    n, m = queries.shape[-2], map_xyz.shape[-2]
    _check(map_xyz, "map_xyz", torch.float32, lead + (m, 3), dev)
    _check(map_mask, "map_mask", torch.bool, lead + (m,), dev)
    _check(queries, "queries", torch.float32, lead + (n, 3), dev)
    _check(query_mask, "query_mask", torch.bool, lead + (n,), dev)
    lib = load_library()
    out_d = torch.empty(lead + (n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty(lead + (n, k), dtype=torch.int32, device=dev)
    if n == 0 or lanes == 0:
        return out_d, out_i
    # the kernel stages the targets with 16-byte cp.async copies: every
    # lane's block must start on a 16-byte boundary, so a stacked map whose
    # lane length is not a multiple of 16 is copied into one that is (the
    # padding targets are masked and past the m searched ones)
    mstride = m
    if lanes > 1 and m % 16:
        mstride = m + 16 - m % 16
        map_xyz = torch.nn.functional.pad(map_xyz, (0, 0, 0, mstride - m))
        map_mask = torch.nn.functional.pad(map_mask, (0, mstride - m))
    map_xyz, map_mask = _aligned16(map_xyz), _aligned16(map_mask)
    sms = _sm_count(dev.index if dev.index is not None else torch.cuda.current_device())
    ranges = lib.liorf_knn_bruteforce_ranges(lanes, n, m, k, sms)
    # partial lists of the target ranges, merged by a second kernel
    part = lanes * ranges * n * k if ranges > 1 else 0
    part_d = torch.empty(part, dtype=torch.float32, device=dev)
    part_i = torch.empty(part, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.liorf_knn_bruteforce(
            map_xyz.data_ptr(), map_mask.data_ptr(), queries.data_ptr(),
            query_mask.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            part_d.data_ptr(), part_i.data_ptr(), lanes, n, m, mstride, k, sms,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise _launch_error("knn_bruteforce", err)
    knn_bruteforce.launches += 1
    return out_d, out_i


knn_bruteforce.launches = 0


def launch_counts() -> dict[str, int]:
    """Calls that launched each kernel (K2's merge pass is part of its call)."""
    return {
        "knn_grid_topk": knn_grid_topk.launches,
        "knn_bruteforce": knn_bruteforce.launches,
    }


def reset_launch_counts() -> None:
    knn_grid_topk.launches = 0
    knn_bruteforce.launches = 0
