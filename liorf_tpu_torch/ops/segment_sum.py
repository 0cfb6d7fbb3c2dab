"""Fixed-order reductions on the card: the scatter-adds of the distributed
pose-graph solver, the order of the single-device solve's node sums (kept by
``ops/linearize.py`` and ``ops/pcg.py``) and of the voxel filter's sums
(kept by ``ops/voxel_reduce.py``), and of the solve's dot products.

On a CUDA tensor ``index_add`` adds with atomics in whatever order the
threads arrive, so two runs of one stream gave two trajectories. Not a TPU
kernel: the JAX package's scatter-adds repeat on their own, and this
kernel (``csrc/segment_sum.cu``) restores that on the card. Each output
element is summed by one thread over its rows in a fixed order, from 0.0,
which is also the order of the CPU's sequential ``index_add`` over the same
rows; the CPU keeps ``index_add`` itself.

* :func:`segment_sum` — ``out[b, s] = sum of src[b, perm[b, p]]`` over the
  positions ``p`` whose sorted ``keys[b, p] == s``; ``perm`` may be None
  (the rows are already in key order). The kernel walks each segment's
  positions between its two offsets (:func:`segment_offsets`, one
  ``searchsorted`` of the keys before the launch).
* :class:`SegmentPlan` — several scatter-adds into one output whose row
  indices stay fixed over a solve (the pose graph's edge, GPS and prior
  endpoints): one stable sort and its offsets, found once, then each
  :meth:`sum` is one launch; the sorted rows also feed the linearization and PCG kernels
  (``ops/linearize.py``, ``ops/pcg.py``), which sum in that order.
* :func:`fixed_dot_plain` — the order of the PCG's dot products, which the
  PCG kernel keeps: chunks of 32 products summed in order, the chunk sums
  by a tree of adjacent pairs. It does not depend on the length beyond the
  last nonzero product, so a ring's unused (zero) slots change no bit of
  it and a session whose rings grew gives the bits of one that started
  with large rings; ``torch.sum`` shapes its reduction by the length, and
  the solve's result moved with the ring capacity.

Dispatch by the tensor's device and nothing else: a CPU tensor takes the
plain version (``index_add``), a CUDA tensor launches the kernel or raises.
The kernel is a ``torch.library`` custom op with a vmap rule, so the lane
axis of ``pipeline/multistream.py`` (``torch.func.vmap``) runs through it
in one launch for every lane.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from ..core.build import build_cuda_library

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "segment_sum.cu"

FIXED_DOT_CHUNK = 32

_lib = None
build_seconds: float | None = None  # wall time of the nvcc run, if one was needed


def load_library(extra_flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    so, build_seconds = build_cuda_library(_SOURCE, extra_flags)
    lib = ctypes.CDLL(str(so))
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.liorf_segment_sum.argtypes = [vp, vp, vp, vp, ci, cll, ci, cll, vp]
    lib.liorf_segment_sum.restype = ci
    _lib = lib
    return lib


def segment_sum_plain(
    src: torch.Tensor, perm: Optional[torch.Tensor], keys: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Plain PyTorch version of :func:`segment_sum` (same contract): one
    ``index_add`` over the lanes' rows, in sorted order, rows keyed past the
    last segment into a dump row that is dropped. On the CPU it adds in
    that order; on the card its atomics do not keep it."""
    B, M, C = src.shape
    S = num_segments
    rows = src if perm is None else torch.gather(src, 1, perm[..., None].expand(B, M, C))
    lane = torch.arange(B, dtype=keys.dtype, device=keys.device)[:, None] * S
    flat = torch.where(keys < S, keys + lane, B * S)
    out = torch.zeros((B * S + 1, C), dtype=src.dtype, device=src.device)
    out = out.index_add(0, flat.reshape(-1), rows.reshape(B * M, C))
    return out[:-1].reshape(B, S, C)


def segment_offsets(keys: torch.Tensor, num_segments: int) -> torch.Tensor:
    """[B, S + 1] int64: ``offsets[b, s]`` is the first position of the
    sorted ``keys[b]`` whose key is >= s, so segment s lies between
    ``offsets[b, s]`` and ``offsets[b, s + 1]`` (one ``searchsorted``)."""
    bounds = torch.arange(num_segments + 1, dtype=keys.dtype, device=keys.device)
    return torch.searchsorted(keys, bounds.repeat(keys.shape[0], 1))


def _launch(src, perm, keys, num_segments: int, offsets) -> torch.Tensor:
    dev = src.device
    if src.dtype != torch.float32 or keys.dtype != torch.int64:
        raise TypeError(f"segment_sum: src {src.dtype} (float32), keys {keys.dtype} (int64)")
    if src.dim() != 3 or keys.shape != src.shape[:2]:
        raise ValueError(f"segment_sum: src {tuple(src.shape)} [B,M,C], keys {tuple(keys.shape)} [B,M]")
    if perm is not None and (perm.dtype != torch.int64 or perm.shape != keys.shape):
        raise ValueError(f"segment_sum: perm {perm.dtype} {tuple(perm.shape)}, expected int64 [B,M]")
    B, M, C = src.shape
    if offsets.dtype != torch.int64 or offsets.shape != (B, num_segments + 1):
        raise ValueError(f"segment_sum: offsets {offsets.dtype} {tuple(offsets.shape)}, "
                         f"expected int64 [{B},{num_segments + 1}]")
    for t in (keys, perm, offsets):
        if t is not None and t.device != dev:
            raise ValueError(f"segment_sum: index on {t.device}, src on {dev}")
    src, offsets = src.contiguous(), offsets.contiguous()
    perm = None if perm is None else perm.contiguous()
    out = torch.empty((B, num_segments, C), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.liorf_segment_sum(
            src.data_ptr(), None if perm is None else perm.data_ptr(), offsets.data_ptr(),
            out.data_ptr(), B, M, C, num_segments, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"segment_sum: CUDA launch failed with error {err}")
    segment_sum.launches += 1
    return out


@torch.library.custom_op("liorf_tpu_torch::segment_sum", mutates_args=())
def _segment_sum_op(
    src: torch.Tensor, perm: Optional[torch.Tensor], keys: torch.Tensor, num_segments: int,
    offsets: torch.Tensor,
) -> torch.Tensor:
    # The op on any device but CUDA is the plain version (the tests reach
    # the vmap rule through it on the CPU), which reads the keys; the
    # kernel reads their offsets.
    return segment_sum_plain(src, perm, keys, num_segments)


@_segment_sum_op.register_kernel("cuda")
def _segment_sum_cuda(src, perm, keys, num_segments, offsets):
    return _launch(src, perm, keys, num_segments, offsets)


def _fold_lanes(t, d, n: int):
    """A vmapped argument (vmap dim ``d``, None if unbatched, over ``n``
    lanes) folded into its leading [B] axis: [n * B, ...]."""
    if t is None:
        return None
    t = t.expand(n, *t.shape) if d is None else t.movedim(d, 0)
    return t.reshape(n * t.shape[1], *t.shape[2:])


@_segment_sum_op.register_vmap
def _segment_sum_vmap(info, in_dims, src, perm, keys, num_segments, offsets):
    """Lanes of a vmap fold into the op's own [B] axis: one launch."""
    n = info.batch_size
    d_src, d_perm, d_keys, _, d_off = in_dims
    src, perm, keys, offsets = (_fold_lanes(t, d, n) for t, d in (
        (src, d_src), (perm, d_perm), (keys, d_keys), (offsets, d_off)))
    out = _segment_sum_op(src, perm, keys, num_segments, offsets)
    return out.reshape(n, -1, *out.shape[1:]), 0


def segment_sum(
    src: torch.Tensor, perm: Optional[torch.Tensor], keys: torch.Tensor, num_segments: int,
) -> torch.Tensor:
    """Fixed-order segment sum. src [B,M,C] f32, keys [B,M] int64 >= 0 and
    sorted per lane, perm [B,M] int64 or None (row ``perm[b, p]`` of src is
    the p-th in key order) -> [B, num_segments, C]; empty segments are 0 and
    rows keyed ``>= num_segments`` are dropped (never read on the card).
    On the card the keys' offsets are found first, then one launch for every
    lane (a :class:`SegmentPlan` finds its offsets once for every sum)."""
    if src.device.type == "cpu":
        return segment_sum_plain(src, perm, keys, num_segments)
    if src.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {src.device}")
    return _segment_sum_op(src, perm, keys, num_segments, segment_offsets(keys, num_segments))


segment_sum.launches = 0


class SegmentPlan:
    """Scatter-adds of several value blocks into one ``[num_segments, ...]``
    output, at row indices fixed at construction: ``sum([v0, v1, ...])`` is
    ``zeros.index_add(0, index[0], v0).index_add(0, index[1], v1)...``.

    On CPU tensors it is exactly those index_adds. On CUDA tensors the
    indices are sorted once here (stably, so each row keeps the order of the
    blocks and of its values within them, the CPU's order), the segments'
    offsets found once, and every sum is one launch of the kernel."""

    def __init__(self, index: list[torch.Tensor], num_segments: int):
        self.index = index
        self.num_segments = num_segments
        self.on_card = index[0].device.type == "cuda"
        self._sorted = None
        if self.on_card:
            self.keys, self.perm = self.sorted_rows()
            self.offsets = segment_offsets(self.keys[None], num_segments)

    def sorted_rows(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(keys, perm): the stable sort of the concatenated indices, the
        order in which a row's values are added (on any device)."""
        if self._sorted is None:
            self._sorted = tuple(torch.sort(torch.cat(self.index), stable=True))
        return self._sorted

    def sum(self, values: list[torch.Tensor]) -> torch.Tensor:
        tail = values[0].shape[1:]
        if not self.on_card:
            out = torch.zeros((self.num_segments, *tail), dtype=values[0].dtype,
                              device=values[0].device)
            for idx, v in zip(self.index, values):
                out = out.index_add(0, idx, v)
            return out
        rows = torch.cat([v.reshape(v.shape[0], -1) for v in values])
        out = _segment_sum_op(rows[None], self.perm[None], self.keys[None], self.num_segments,
                              self.offsets)
        return out[0].reshape(self.num_segments, *tail)


def _dot_chunks(n: int) -> int:
    """The power of two of chunk sums the dot's tree runs over."""
    return 1 << max(0, (-(-n // FIXED_DOT_CHUNK) - 1).bit_length())


def fixed_dot_plain(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The fixed-order dot product of each lane, [B, n] x [B, n] -> [B]:
    the products in chunks of 32 summed in order from 0.0, the chunk sums
    by a tree of adjacent pairs over a power of two of them (zeros past the
    last). The PCG kernel (``csrc/pcg.cu``) adds in this order."""
    B, n = a.shape
    P = _dot_chunks(n)
    prod = torch.zeros((B, P * FIXED_DOT_CHUNK), dtype=a.dtype, device=a.device)
    prod[:, :n] = a * c
    prod = prod.reshape(B, P, FIXED_DOT_CHUNK)
    part = torch.zeros((B, P), dtype=a.dtype, device=a.device)
    for j in range(FIXED_DOT_CHUNK):
        part = part + prod[:, :, j]
    while part.shape[1] > 1:
        part = part[:, 0::2] + part[:, 1::2]
    return part[:, 0]


def launch_counts() -> dict[str, int]:
    return {"segment_sum": segment_sum.launches}


def reset_launch_counts() -> None:
    segment_sum.launches = 0
