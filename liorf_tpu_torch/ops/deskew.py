"""IMU-aided motion deskew of a LiDAR scan, in one kernel.

Equivalent of the reference front-end
(``liorf/src/imageProjection.cpp:331-565``): forward-Euler integration of
gyro rates over the scan window produces a rotation timeline; every point is
rotated into the scan-start frame by the linearly interpolated rotation at
its own timestamp. Positional deskew is intentionally omitted, matching the
reference (``findPosition`` body is disabled, ``imageProjection.cpp:520-534``).
The reference treats the integrated gyro angles as roll/pitch/yaw euler
angles (R = Rz Ry Rx); we keep those semantics.

Not a TPU kernel. The JAX package jits these few lines
(``liorf_tpu/ops/deskew.py:35-108``) into its frame program. Op by op on the
card they were ~70 eager launches (a cumulative sum, two ``searchsorted`` +
gather + lerp chains, the euler rotations, a batched product), ~2.4 ms of host
time a frame for ~70 floating-point operations a point. The kernel
(``csrc/deskew.cu``) does all of it in one launch for every lane. What bounds
it on the card is the points' bytes (~29 a point: xyz in and out, the time,
the mask) and, behind them, the float64 sine and cosine of three angles a
point (the compiler runs each such call after the one before); the timeline
is a few hundred samples. At the main path's 32768 points all of it is
below a launch's latency, so the kernel shortens each block's chain: every
thread issues its point's loads first; one warp builds a window of up to 64
samples in its registers (a Hillis-Steele prefix by shuffles in the plain
version's order, cut where the last valid sample is covered), a longer one
the whole block; one barrier publishes it; then a binary search in the
shared times, a lerp, and the rotations, their trigonometry three lanes a
point up to 65536 points a launch (a lane a point past that, where the
card's float64 pipe is the limit).

* :func:`deskew` — the deskewed points of every lane: xyz [B, N, 3], rel_t
  [B, N], mask [B, N], scan_start [B], dk_times [B, K], dk_gyr [B, K, 3],
  dk_mask [B, K] -> [B, N, 3]. One call on the card serves every lane (a
  vmapped call's lanes included).
* :func:`deskew_frame` — one scan (no lane axis), what the pipelines call.
* :func:`deskew_plain` — :func:`deskew` in torch ops, in the kernel's order:
  :func:`integrate_gyro`, then :func:`deskew_scan` (through
  :func:`interp_rotation`), each taking any leading batch axes.

The order contract (the kernel keeps it, this module spells it): every
operation is rounded on its own (no fused multiply-add); the angles'
running sum is an inclusive Hillis-Steele prefix in float64 (at step d, x[i]
+ x[i - d] for i >= d), rounded to float32 once; the search is
``torch.searchsorted``'s upper bound; sin and cos are taken in float64 and
rounded to float32; a 3-term product sum is ``(a0 b0 + a1 b1) + a2 b2``. On
the card the kernel and the plain version agree bit for bit.

Dispatch by the tensor's device and nothing else: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises. The kernel is a
``torch.library`` custom op with a vmap rule, so the lane axis of
``pipeline/multistream.py`` (``torch.func.vmap``) folds into the launch; a
call with no vmap around it launches without the op's dispatch, its
addresses one packed array. The kernel reads each input's lanes wherever
they lie (a tick's inputs are slices of its packed frame buffer), so the
call copies none of them.
"""

from __future__ import annotations

import ctypes
from array import array
from pathlib import Path
from typing import NamedTuple

import torch
from torch._C import _functorch

from ..core.build import build_cuda_library, raw_stream
from .plane_fit import dot3
from .scan_gn import rot_f32
from .segment_sum import _fold_lanes

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "deskew.cu"

# The longest gyro window the kernel takes (csrc/deskew.cu::kMaxK): past 64
# samples the prefix's two buffers, the times and the angles in shared
# memory, 64 bytes a sample.
MAX_K = 2048

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
    lib.liorf_deskew.argtypes = [vp, ci, ci, ci, ci, vp]
    lib.liorf_deskew.restype = ci
    lib.liorf_deskew_kernel_launches.argtypes = []
    lib.liorf_deskew_kernel_launches.restype = ctypes.c_longlong
    _lib = lib
    return lib


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

class ImuRotationTimeline(NamedTuple):
    """Integrated gyro rotation samples over (a window around) one scan."""

    times: torch.Tensor  # [..., K] absolute seconds, padded with +inf
    angles: torch.Tensor  # [..., K, 3] integrated (rotX, rotY, rotZ)
    count: torch.Tensor  # [...] int number of valid samples


def integrate_gyro(
    imu_times: torch.Tensor, imu_gyro: torch.Tensor, imu_mask: torch.Tensor
) -> ImuRotationTimeline:
    """Forward-Euler integrate angular rates into cumulative angles.

    Mirrors ``imuDeskewInfo`` (imageProjection.cpp:350-409): angle[0] = 0,
    angle[i] = angle[i-1] + gyro[i] * (t[i] - t[i-1]). The running sum is
    the kernel's: a Hillis-Steele prefix in float64, rounded to float32.
    """
    valid = imu_mask
    # dt[i] = t[i] - t[i-1], 0 for the first valid sample and invalid slots.
    dt = torch.diff(imu_times, dim=-1, prepend=imu_times[..., :1])
    prev_valid = torch.cat([torch.zeros_like(valid[..., :1]), valid[..., :-1]], -1)
    dt = torch.where(valid & prev_valid, dt, 0.0)
    increments = imu_gyro * dt[..., None]
    x = torch.where(valid[..., None], increments, 0.0).double()
    K, d = x.shape[-2], 1
    while d < K:
        x = torch.cat([x[..., :d, :], x[..., d:, :] + x[..., :-d, :]], -2)
        d *= 2
    count = torch.sum(valid.to(torch.int64), -1)
    times = torch.where(valid, imu_times, torch.inf)
    return ImuRotationTimeline(times=times, angles=x.float(), count=count)


def interp_rotation(timeline: ImuRotationTimeline, t: torch.Tensor) -> torch.Tensor:
    """Linearly interpolate integrated angles at times t [..., N] -> [..., N, 3].

    Matches ``findRotation`` (imageProjection.cpp:493-518): clamp to the
    last sample when t is beyond the timeline, use the front sample when
    before it. Every clamp of the JAX original (deskew.py:68-73) is kept:
    torch does not clamp an out-of-range gather.
    """
    hi = torch.searchsorted(timeline.times, t.contiguous(), right=True)
    count = timeline.count[..., None]
    hi = torch.minimum(torch.clamp(hi, min=1), torch.clamp(count, min=1))
    lo = hi - 1
    # when hi exceeds the valid range, both ends clamp to the last sample
    last = torch.clamp(count - 1, min=0)
    hi = torch.minimum(hi, last)
    t_lo = timeline.times.gather(-1, lo)
    t_hi = timeline.times.gather(-1, hi)
    denom = torch.where(hi == lo, 1.0, t_hi - t_lo)
    ratio = torch.clamp((t - t_lo) / torch.where(denom == 0, 1.0, denom), 0.0, 1.0)
    a_lo = timeline.angles.gather(-2, lo[..., None].expand(*lo.shape, 3))
    a_hi = timeline.angles.gather(-2, hi[..., None].expand(*hi.shape, 3))
    return a_lo + (a_hi - a_lo) * ratio[..., None]


def deskew_scan(
    xyz: torch.Tensor,
    rel_times: torch.Tensor,
    mask: torch.Tensor,
    scan_start_time: torch.Tensor,
    timeline: ImuRotationTimeline,
) -> torch.Tensor:
    """Rotate every point into the scan-start frame.

    xyz: [..., N, 3] raw sensor-frame points; rel_times: [..., N] seconds
    since scan start; scan_start_time [...]; returns deskewed [..., N, 3].
    """
    start = scan_start_time[..., None]
    angles = interp_rotation(timeline, start + rel_times)  # [..., N, 3] euler rpy
    R_pt = rot_f32(angles)  # [..., N, 3, 3]
    R0 = rot_f32(interp_rotation(timeline, start))  # [..., 1, 3, 3]
    # p_start = R0^T R_pt p, row by row
    rotated = torch.stack([dot3(R_pt[..., r, :], xyz) for r in range(3)], -1)
    out = torch.stack([dot3(R0[..., :, c], rotated) for c in range(3)], -1)
    return torch.where(mask[..., None], out, xyz)


def deskew_plain(xyz, rel_t, mask, scan_start, dk_times, dk_gyr, dk_mask):
    """Plain PyTorch version of :func:`deskew` (same arguments), in the
    kernel's order of operations."""
    return deskew_scan(xyz, rel_t, mask, scan_start, integrate_gyro(dk_times, dk_gyr, dk_mask))


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

ARGS = ("xyz", "rel_t", "mask", "scan_start", "dk_times", "dk_gyr", "dk_mask")


def _lanes_apart(t) -> bool:
    """Whether each lane's block of t [B, ...] is contiguous, the lanes any
    stride apart (a slice of a packed frame buffer, or a lane a vmap
    broadcast): the kernel reads such a tensor as it is."""
    stride, expect = t.stride(), 1
    for d in range(t.dim() - 1, 0, -1):
        if t.shape[d] != 1 and stride[d] != expect:
            return False
        expect *= t.shape[d]
    return True


def _checked(xyz, rel_t, mask, scan_start, dk_times, dk_gyr, dk_mask) -> list:
    """The tensors as the kernel takes them (each lane's block contiguous),
    or ValueError: a dtype, shape or device it does not take, or a window it
    cannot hold."""
    dev = xyz.device
    if xyz.dim() != 3 or dk_times.dim() != 2:
        raise ValueError(f"deskew: xyz {tuple(xyz.shape)}, dk_times {tuple(dk_times.shape)}: "
                         "[B, N, 3] points and a [B, K] window")
    B, N = xyz.shape[:2]
    K = dk_times.shape[1]
    if not 1 <= K <= MAX_K:
        raise ValueError(f"deskew: a window of {K} samples (1 to {MAX_K})")
    want = ((B, N, 3), (B, N), (B, N), (B,), (B, K), (B, K, 3), (B, K))
    out = []
    for name, t, shape in zip(ARGS, (xyz, rel_t, mask, scan_start, dk_times, dk_gyr, dk_mask),
                              want):
        dtype = torch.bool if name in ("mask", "dk_mask") else torch.float32
        if t.dtype is not dtype or t.shape != shape or t.device != dev:
            raise ValueError(f"deskew: {name} {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected {dtype} {shape} on {dev}")
        out.append(t if t.is_contiguous() or _lanes_apart(t) else t.contiguous())
    return out


def _addresses(ins, out) -> list:
    """The inputs' and the output's addresses, then the inputs' lane strides."""
    return [t.data_ptr() for t in ins] + [out.data_ptr()] + [t.stride(0) for t in ins]


def _run(lib, ptrs, N, K, B, dev) -> None:
    """The ctypes call: the 8 addresses and 7 lane strides packed in one array."""
    packed = array("q", ptrs)
    err = lib.liorf_deskew(packed.buffer_info()[0], N, K, B, dev.index, raw_stream(dev.index))
    if err != 0:
        raise RuntimeError(f"deskew: CUDA launch failed with error {err}")


def _launch(xyz, rel_t, mask, scan_start, dk_times, dk_gyr, dk_mask):
    """The kernel on every lane: the arguments as :func:`deskew` takes them."""
    ins = _checked(xyz, rel_t, mask, scan_start, dk_times, dk_gyr, dk_mask)
    B, N = xyz.shape[:2]
    dev = xyz.device
    out = torch.empty((B, N, 3), dtype=torch.float32, device=dev)
    if B == 0 or N == 0:
        return out
    _run(load_library(), _addresses(ins, out), N, dk_times.shape[1], B, dev)
    deskew.launches += 1
    return out


@torch.library.custom_op("liorf_tpu_torch::deskew", mutates_args=())
def _deskew_op(xyz: torch.Tensor, rel_t: torch.Tensor, mask: torch.Tensor,
               scan_start: torch.Tensor, dk_times: torch.Tensor, dk_gyr: torch.Tensor,
               dk_mask: torch.Tensor) -> torch.Tensor:
    # The op on any device but CUDA is the plain version (the CPU path and
    # the tests reach the vmap rule through it).
    return deskew_plain(xyz, rel_t, mask, scan_start, dk_times, dk_gyr, dk_mask)


@_deskew_op.register_kernel("cuda")
def _deskew_cuda(*args):
    return _launch(*args)


@_deskew_op.register_vmap
def _deskew_vmap(info, in_dims, *args):
    """Lanes of a vmap fold into the op's own [B] axis: one launch."""
    n = info.batch_size
    out = _deskew_op(*(_fold_lanes(t, d, n) for t, d in zip(args, in_dims)))
    return out.reshape(n, -1, *out.shape[1:]), 0


def deskew(xyz, rel_t, mask, scan_start, dk_times, dk_gyr, dk_mask):
    """The deskewed points of every lane, [B, N, 3]: xyz [B, N, 3], rel_t
    [B, N] (seconds since the scan's start), mask [B, N] (bool), scan_start
    [B], the gyro window dk_times [B, K], dk_gyr [B, K, 3], dk_mask [B, K]
    (bool). Masked-out points come back as they are. One call on the card
    for every lane (a vmapped call's lanes included)."""
    dev = xyz.device
    if dev.type == "cuda" and _functorch.maybe_current_level() is None:
        # no vmap around the call: the launch without the custom op's dispatch
        return _launch(xyz, rel_t, mask, scan_start, dk_times, dk_gyr, dk_mask)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"deskew: unsupported device {dev}")
    return _deskew_op(xyz, rel_t, mask, scan_start, dk_times, dk_gyr, dk_mask)


deskew.launches = 0


def deskew_frame(xyz, rel_t, mask, scan_start, dk_times, dk_gyr, dk_mask):
    """One scan deskewed: xyz [N, 3], rel_t [N], mask [N], scan_start [],
    dk_times [K], dk_gyr [K, 3], dk_mask [K] -> [N, 3]; :func:`deskew` on
    one lane. ``deskew_frame.calls`` counts the calls (a vmapped call once)."""
    deskew_frame.calls += 1
    out = deskew(xyz[None], rel_t[None], mask[None], scan_start.reshape(1), dk_times[None],
                 dk_gyr[None], dk_mask[None])
    return out[0]


deskew_frame.calls = 0


def launch_counts() -> dict[str, int]:
    return {"deskew": deskew.launches}


def kernel_launches() -> int:
    """Kernels the library has launched in this process (its own count)."""
    return int(load_library().liorf_deskew_kernel_launches())


def reset_launch_counts() -> None:
    deskew.launches = 0
