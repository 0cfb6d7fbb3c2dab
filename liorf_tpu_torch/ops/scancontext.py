"""ScanContext global place recognition as batched tensor ops.

Re-design of the reference's ScanContext
(``liorf/include/Scancontext.{h,cpp}``): the 20x60 polar max-height
descriptor is one scatter-max; ring-key candidate search is a brute-force
batched L2 top-k over the whole database (replacing nanoflann); the
shift-aligned cosine distance is evaluated for *all* 60 column shifts at
once (the reference prunes to ~10% of shifts via the sector key,
``Scancontext.cpp:116-148`` — evaluating all shifts is strictly more
thorough).

The descriptor is one hand-written kernel (``csrc/scancontext.cu``), not a
TPU kernel: the JAX package jits ``make_descriptor``
(``liorf_tpu/ops/scancontext.py:34-53``) into its frame program; op by op on
the card it was ~15 eager launches, ~0.8 ms of host time a call, for a dozen
operations a point. What bounds the kernel is the points' bytes (13 a point)
and ``atan2f``, both far below a launch's latency at the main path's 32768
points; so the kernel spreads a lane over the card (a point a thread, 128
blocks there), reduces into each block's shared bins by an integer atomic
max (exact, so in any order the same bits), and merges the blocks' bins
into a per-lane scratch (:func:`lane_scratch`, one a stream) by global
atomics, the lane's last block writing the descriptor; one launch for every
lane.

* :func:`make_descriptor` — one scan's descriptor (no lane axis), what the
  pipelines call; under ``torch.func.vmap`` the lanes are one launch.
* :func:`descriptors` — every lane's, [B, N, 3] + mask [B, N] -> [B, 20, 60].
* :func:`make_descriptor_plain` — :func:`descriptors` in torch ops, in the
  kernel's order: every operation rounded on its own, a quotient IEEE's (by a
  tensor: torch multiplies by a Python divisor's reciprocal on the card),
  ``atan2`` the card's ``atan2f`` (torch's atan2 there), degrees torch's
  ``rad2deg``. A bin that a NaN height reaches reads 0 (torch's ``amax``
  keeps the NaN, and a non-finite bin is 0), as one that +inf reaches.

Dispatch by the tensor's device and nothing else: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises. A call with no
vmap around it launches without the custom op's dispatch, its addresses one
packed array.

Constants follow the reference (``Scancontext.h:80-99``).
"""

from __future__ import annotations

import ctypes
import math
from array import array
from pathlib import Path
from typing import NamedTuple

import torch
from torch._C import _functorch

from ..core.build import build_cuda_library, raw_stream
from .segment_sum import _fold_lanes

NUM_RING = 20
NUM_SECTOR = 60
MAX_RADIUS = 80.0
LIDAR_HEIGHT = 2.0
NUM_EXCLUDE_RECENT = 30
NUM_CANDIDATES = 3
SC_DIST_THRES = 0.3
SECTOR_ANGLE = 360.0 / NUM_SECTOR

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "scancontext.cu"

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
    lib.liorf_scancontext.argtypes = [vp, ci, ci, ci, vp]
    lib.liorf_scancontext.restype = ci
    lib.liorf_scancontext_kernel_launches.argtypes = []
    lib.liorf_scancontext_kernel_launches.restype = ctypes.c_longlong
    _lib = lib
    return lib


BINS = NUM_RING * NUM_SECTOR + 1  # a lane's bins and its dump slot


def descriptor_bins(xyz: torch.Tensor, mask: torch.Tensor):
    """Each point's slot and height for :func:`make_descriptor_plain`'s
    scatter-max, flat over the lanes of xyz [B, N, 3] and mask [B, N]: lane
    b's bin (ring, sector) at b * BINS + ring * 60 + sector, and a rejected
    point (masked out, or beyond 80 m) in its lane's dump slot b * BINS + 1200
    with height -inf (``liorf_tpu/ops/scancontext.py:49``)."""
    B = xyz.shape[0]
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2] + LIDAR_HEIGHT
    r = torch.sqrt(x * x + y * y)
    theta = torch.rad2deg(torch.atan2(y, x))
    theta = torch.where(theta < 0, theta + 360.0, theta)

    radius, circle = r.new_full((), MAX_RADIUS), r.new_full((), 360.0)
    ring = torch.clamp(torch.ceil(r / radius * NUM_RING), 1, NUM_RING).to(torch.int64) - 1
    sector = torch.clamp(torch.ceil(theta / circle * NUM_SECTOR), 1, NUM_SECTOR).to(torch.int64) - 1

    ok = mask & (r <= MAX_RADIUS)
    lane = torch.arange(B, device=xyz.device)[:, None] * BINS
    flat = lane + torch.where(ok, ring * NUM_SECTOR + sector, BINS - 1)
    return flat.reshape(-1), torch.where(ok, z, -torch.inf).to(torch.float32).reshape(-1)


def make_descriptor_plain(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, N, 3] + mask [B, N] -> [B, 20, 60] polar max-height descriptors.

    Matches ``makeScancontext`` (Scancontext.cpp:151-195): z is offset by the
    lidar height, bins take the max z, empty bins are 0.
    """
    B = xyz.shape[0]
    flat, height = descriptor_bins(xyz, mask)
    desc = torch.full((B * BINS,), -torch.inf, dtype=torch.float32, device=xyz.device)
    desc = desc.scatter_reduce(0, flat, height, reduce="amax", include_self=True)
    desc = desc.reshape(B, BINS)[:, :-1].reshape(B, NUM_RING, NUM_SECTOR)
    return torch.where(torch.isfinite(desc), desc, 0.0)


# the empty bin's key in the kernel's merge scratch: the order-preserving
# image of -inf (csrc/scancontext.cu::key)
EMPTY_KEY = 0x007FFFFF
_scratch: dict = {}


def lane_scratch(dev: torch.device, lanes: int, stream: int) -> tuple[int, int]:
    """The addresses of at least ``lanes`` lanes' merge scratch for launches
    on ``stream`` (a raw stream address, ``core/build.py::raw_stream``) of
    ``dev``: 1200 keys a lane (:data:`EMPTY_KEY` between launches), then an
    arrival counter a lane (0 between launches). The lane's last block sets
    both back, so the buffer is filled once, when it is made. Each stream
    has its own: launches on one stream run one at a time, so two never
    share a scratch, on whatever streams they are made."""
    have = _scratch.get((dev.index, stream))
    if have is None or have[1] < lanes:
        cap = max(lanes, 8)
        t = torch.full((cap * (BINS - 1) + cap,), EMPTY_KEY, dtype=torch.int32, device=dev)
        t[cap * (BINS - 1):] = 0
        have = _scratch[(dev.index, stream)] = (t, cap)
    t, cap = have
    return t.data_ptr(), t.data_ptr() + 4 * cap * (BINS - 1)


def _checked(xyz, mask) -> list:
    """The tensors as the kernel takes them (contiguous), or ValueError."""
    dev = xyz.device
    if xyz.dim() != 3 or xyz.shape[2] != 3 or xyz.dtype is not torch.float32:
        raise ValueError(f"descriptors: xyz {xyz.dtype} {tuple(xyz.shape)}, expected float32 "
                         "[B, N, 3]")
    if mask.dtype is not torch.bool or mask.shape != xyz.shape[:2] or mask.device != dev:
        raise ValueError(f"descriptors: mask {mask.dtype} {tuple(mask.shape)} on {mask.device}, "
                         f"expected bool {tuple(xyz.shape[:2])} on {dev}")
    return [t if t.is_contiguous() else t.contiguous() for t in (xyz, mask)]


def _run(lib, ptrs, N, B, dev, stream) -> None:
    """The ctypes call on ``stream``: the 5 addresses packed in one array."""
    packed = array("q", ptrs)
    err = lib.liorf_scancontext(packed.buffer_info()[0], N, B, dev.index, stream)
    if err != 0:
        raise RuntimeError(f"descriptors: CUDA launch failed with error {err}")


def _launch(xyz, mask):
    """The kernel on every lane: the arguments as :func:`descriptors` takes them."""
    ins = _checked(xyz, mask)
    B, N = mask.shape
    dev = xyz.device
    out = torch.empty((B, NUM_RING, NUM_SECTOR), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    stream = raw_stream(dev.index)
    _run(load_library(),
         [t.data_ptr() for t in ins] + [out.data_ptr(), *lane_scratch(dev, B, stream)],
         N, B, dev, stream)
    make_descriptor.launches += 1
    return out


@torch.library.custom_op("liorf_tpu_torch::scancontext", mutates_args=())
def _descriptor_op(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    # The op on any device but CUDA is the plain version (the CPU path and
    # the tests reach the vmap rule through it).
    return make_descriptor_plain(xyz, mask)


@_descriptor_op.register_kernel("cuda")
def _descriptor_cuda(xyz, mask):
    return _launch(xyz, mask)


@_descriptor_op.register_vmap
def _descriptor_vmap(info, in_dims, xyz, mask):
    """Lanes of a vmap fold into the op's own [B] axis: one launch."""
    n = info.batch_size
    out = _descriptor_op(*(_fold_lanes(t, d, n) for t, d in zip((xyz, mask), in_dims)))
    return out.reshape(n, -1, *out.shape[1:]), 0


def descriptors(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The descriptor of every lane: xyz [B, N, 3] + mask [B, N] (bool) ->
    [B, 20, 60]. One call on the card for every lane."""
    dev = xyz.device
    if dev.type == "cuda" and _functorch.maybe_current_level() is None:
        # no vmap around the call: the launch without the custom op's dispatch
        return _launch(xyz, mask)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"descriptors: unsupported device {dev}")
    return _descriptor_op(xyz, mask)


def make_descriptor(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[N, 3] + mask -> [20, 60] polar max-height descriptor: :func:`descriptors`
    on one lane. ``make_descriptor.calls`` counts the calls (a vmapped call
    once), ``make_descriptor.launches`` the kernel's launches."""
    make_descriptor.calls += 1
    return descriptors(xyz[None], mask[None])[0]


make_descriptor.calls = 0
make_descriptor.launches = 0


def launch_counts() -> dict[str, int]:
    return {"make_descriptor": make_descriptor.launches}


def kernel_launches() -> int:
    """Kernels the library has launched in this process (its own count)."""
    return int(load_library().liorf_scancontext_kernel_launches())


def reset_launch_counts() -> None:
    make_descriptor.launches = 0


def ring_key(desc: torch.Tensor) -> torch.Tensor:
    """Rotation-invariant key: row-wise mean ([..., 20, 60] -> [..., 20])."""
    return torch.mean(desc, dim=-1)


def _shifted_cosine_distances(query: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """Column-shift-aligned SC distance.

    query [20, 60], cands [B, 20, 60] -> [B, 60] distance for each shift.
    distance(s) = 1 - mean over sector pairs (both non-empty) of the
    column cosine similarity, with candidate columns rotated by s.
    """
    def norm_cols(d):
        n = torch.linalg.norm(d, dim=-2, keepdim=True)
        nonzero = n[..., 0, :] > 0
        return d / torch.where(n > 0, n, 1.0), nonzero

    qn, q_nonzero = norm_cols(query)  # [20, 60], [60]
    cn, c_nonzero = norm_cols(cands)  # [B, 20, 60], [B, 60]

    # shift index matrix: shifted candidate col j = original col (j - s) % 60
    j = torch.arange(NUM_SECTOR, device=query.device)
    src = (j[None, :] - j[:, None]) % NUM_SECTOR  # [60 shifts, 60 cols]

    cn_sh = cn[:, :, src]  # [B, 20, 60, 60] — (batch, ring, shift, col)
    cz_sh = c_nonzero[:, src]  # [B, 60, 60]

    sims = torch.einsum("rj,brsj->bsj", qn, cn_sh)  # [B, 60, 60]
    both = q_nonzero[None, None, :] & cz_sh
    n_eff = torch.clamp(torch.sum(both, dim=-1), min=1)
    sim = torch.sum(torch.where(both, sims, 0.0), dim=-1) / n_eff
    return 1.0 - sim  # [B, 60]


class SCDetection(NamedTuple):
    index: torch.Tensor  # [] int matched keyframe, -1 if none
    distance: torch.Tensor  # [] best SC distance
    yaw: torch.Tensor  # [] rad yaw offset implied by the best shift


def _smallest_k(d: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries, equal values keeping the lower
    index first (``lax.top_k(-d, k)`` order, scancontext.py:114)."""
    return torch.argsort(d, stable=True)[:k]


def _first_argmin(d: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """argmin with the first-index tie-break of ``jnp.argmin``."""
    return torch.argsort(d, dim=dim, stable=True).select(dim, 0)


def rank_candidates(
    descriptors: torch.Tensor,  # [C, 20, 60] database slice (padded)
    ring_keys: torch.Tensor,  # [C, 20]
    searchable: torch.Tensor,  # [C] bool — which entries may be matched
    query_desc: torch.Tensor,  # [20, 60]
    query_key: torch.Tensor,  # [20]
    num_candidates: int,
):
    """Core of detectLoopClosureID over one database slice: ring-key k-NN
    prefilter, then shift-aligned SC distance over the survivors
    (Scancontext.cpp:253-344). Returns (best_dist, best_local_index,
    best_shift) — dist is +inf when nothing is searchable."""
    d2 = torch.sum((ring_keys - query_key[None, :]) ** 2, dim=-1)
    d2 = torch.where(searchable, d2, torch.inf)
    k = min(num_candidates, ring_keys.shape[0])
    cand_idx = _smallest_k(d2, k)
    cand_ok = torch.isfinite(d2[cand_idx])

    dists = _shifted_cosine_distances(query_desc, descriptors[cand_idx])  # [k, 60]
    best_shift = _first_argmin(dists, dim=-1)
    best_dist = torch.where(cand_ok, torch.min(dists, dim=-1).values, torch.inf)

    # a one-element index tensor: indexing with a 0-dim device tensor would
    # read it back to the host
    b = _first_argmin(best_dist).reshape(1)
    return best_dist[b][0], cand_idx[b][0], best_shift[b][0]


def detect_loop(
    descriptors: torch.Tensor,  # [C, 20, 60] database (padded)
    ring_keys: torch.Tensor,  # [C, 20]
    count,  # [] int number of valid entries (tensor or python int)
    query_desc: torch.Tensor,  # [20, 60]
    query_key: torch.Tensor,  # [20]
    num_candidates: int = NUM_CANDIDATES,
    exclude_recent: int = NUM_EXCLUDE_RECENT,
    dist_thresh: float = SC_DIST_THRES,
) -> SCDetection:
    """Find the best loop candidate for the query descriptor.

    Matches ``detectLoopClosureID`` (Scancontext.cpp:253-344): ring-key
    k-NN prefilter excluding the most recent `exclude_recent` keyframes,
    then shift-aligned SC distance, accepted under `dist_thresh`.
    """
    C = descriptors.shape[0]
    idxs = torch.arange(C, device=descriptors.device)
    searchable = idxs < (count - exclude_recent)

    dist, best_idx, best_shift = rank_candidates(
        descriptors, ring_keys, searchable, query_desc, query_key, num_candidates
    )
    found = dist < dist_thresh
    index = torch.where(found, best_idx, -1)
    yaw = best_shift.to(torch.float32) * math.radians(SECTOR_ANGLE)
    return SCDetection(index=index, distance=dist, yaw=yaw)
