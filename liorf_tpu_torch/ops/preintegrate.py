"""IMU preintegration (``imu/preintegration.py::preintegrate``) in one kernel.

Not a TPU kernel. The JAX package jits ``preintegrate``
(``liorf_tpu/imu/preintegration.py:56-162``) into one XLA program of two
``lax.associative_scan``s: the rotations' prefix, then the monoid product of
the per-sample segments (Delta R / v / p, the five bias Jacobians, the 9 x 9
covariance recursion). Op by op on the card that was a log-depth tree of
batched eager products, a few hundred launches and 8-12 ms of host time a
frame. The kernel (``csrc/preintegrate.cu``) runs the whole window in one
launch, one thread block a lane. What bounds it is latency, not bytes (~12 a
sample) or operations (~5 kFLOP a sample): the depth of the prefix and of
the tree. Its design keeps that depth inside one block and as short as the
window: the window goes in tiles of :data:`TILE` samples, one thread a
leaf, and only as far as the lane's last valid sample (:func:`window_cut`:
its tile is the last, and there the tree covers the power of two of slots
that reaches it); each tile's rotation prefix by Hillis-Steele doubling (on
one warp's registers when it covers 32 slots or fewer), its segments
composed pairwise in order, every entry of a level's 9 x 9 products one item
over the block's threads; the tiles composed in order, the rotation prefix
carried from tile to tile.

* :func:`preintegrate` — the preintegrated window of every lane: the ten
  tensors of :data:`FIELDS`, each with a leading lane axis [B]. One call on
  the card serves every lane (a vmapped call's lanes included).
* :func:`preintegrate_plain` — the same function in torch ops, in the
  kernel's order of operations.

The order contract (the kernel keeps it, this module spells it): every
operation is rounded on its own (no fused multiply-add); a 3-term product
sum is ``(a0 b0 + a1 b1) + a2 b2`` (``core/so3_jvp.py``); a 9 x 9 product's
entry is its 9 terms summed in order (:func:`mm9`); ``sin`` and ``cos`` are
taken in float64 and rounded to float32; every quotient is IEEE's, tensor by
tensor (a Python number over a tensor is a reciprocal and a product in
torch, so the noise densities are tensors first); the slots past a lane's
cut are left out of its tree and its tiles, not composed in as identity
segments (composing one keeps every value but not every sign of a zero, and
x 0 of an infinite x is NaN).

Dispatch by the tensor's device and nothing else: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises. The kernel is a
``torch.library`` custom op with a vmap rule, so the lane axis of
``pipeline/multistream.py`` (``torch.func.vmap``) folds into the launch; a
call with no vmap around it launches without the op's dispatch, its ten
outputs views of one allocation, its addresses one packed array.
"""

from __future__ import annotations

import ctypes
import math
from array import array
from pathlib import Path

import torch
from torch._C import _functorch

from ..core.build import build_cuda_library, raw_stream
from ..core.se3 import hat
from ..core.so3_jvp import exp_terms, jr_term, mm, mtm, mv
from .segment_sum import _fold_lanes

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "preintegrate.cu"

TILE = 64  # samples a tile (csrc/preintegrate.cu::kTile): the tree's leaves

# the outputs, in the kernel's order, and their shapes after the lane axis
FIELDS = ("dR", "dv", "dp", "dt", "dR_dbg", "dv_dba", "dv_dbg", "dp_dba", "dp_dbg", "cov")
SHAPES = dict(dR=(3, 3), dv=(3,), dp=(3,), dt=(), dR_dbg=(3, 3), dv_dba=(3, 3), dv_dbg=(3, 3),
              dp_dba=(3, 3), dp_dbg=(3, 3), cov=(9, 9))

_lib = None
build_seconds: float | None = None  # wall time of the nvcc run, if one was needed


def load_library(extra_flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    so, build_seconds = build_cuda_library(_SOURCE, extra_flags)
    lib = ctypes.CDLL(str(so))
    vp, cf, ci = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    lib.liorf_preintegrate.argtypes = [vp, cf, cf, cf, ci, ci, ci, vp]
    lib.liorf_preintegrate.restype = ci
    lib.liorf_preintegrate_kernel_launches.argtypes = []
    lib.liorf_preintegrate_kernel_launches.restype = ctypes.c_longlong
    _lib = lib
    return lib


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def mm9(X, Y):
    """X Y of [..., 9, 9] blocks, each entry its 9 terms summed in order."""
    p = X[..., :, :, None] * Y[..., None, :, :]  # [..., r, l, c]
    s = p[..., :, 0, :]
    for l in range(1, 9):
        s = s + p[..., :, l, :]
    return s


def _blocks(rows):
    return torch.cat([torch.cat(r, -1) for r in rows], -2)


def _leaves(a, dt, Rinc, Jr, P, sg2, sa2, si2):
    """The per-sample segments (dR, dv, dp, T, dR_dbg, dv_dba, dv_dbg,
    dp_dba, dp_dbg, A, Q) from a = acc - ba, dt (0 where masked), so3_exp(w
    dt), Jr(w dt) and the exclusive prefix rotation P, each [..., 3(, 3)]."""
    eye = torch.eye(3, dtype=a.dtype, device=a.device).expand(Rinc.shape)
    z = torch.zeros_like(Rinc)
    t1, t2 = dt[..., None], dt[..., None, None]
    h2 = (dt * dt)[..., None, None]
    dv = a * t1
    dp = (dv * t1) * 0.5
    Ra = mm(P, hat(a))
    A = _blocks([
        [Rinc.transpose(-1, -2), z, z],
        [-(Ra * t2), eye, z],
        [-((Ra * h2) * 0.5), eye * t2, eye],
    ])
    # B = [[Jr dt, 0], [0, P dt], [0, (P h) 0.5]], N = (sg2 / dt, sa2 / dt)
    B1, B2, B3 = Jr * t2, P * t2, (P * h2) * 0.5
    safe = torch.where(dt > 0, dt, 1.0)
    ng = (torch.full_like(safe, sg2) / safe)[..., None, None]
    na = (torch.full_like(safe, sa2) / safe)[..., None, None]
    Q = _blocks([
        [mm(B1 * ng, B1.transpose(-1, -2)), z, z],
        [z, mm(B2 * na, B2.transpose(-1, -2)), mm(B2 * na, B3.transpose(-1, -2))],
        [z, mm(B3 * na, B2.transpose(-1, -2)),
         mm(B3 * na, B3.transpose(-1, -2)) + eye * (dt * si2)[..., None, None]],
    ])
    return (Rinc, dv, dp, dt, -(Jr * t2), -(eye * t2), z, -(eye * (h2 * 0.5)), z, A, Q)


def compose(L, R):
    """The monoid product of two segments, L earlier than R (batched over
    the leading axes; imu/preintegration.py's formulas, the kernel's order)."""
    (dR_a, dv_a, dp_a, T_a, g_a, vba_a, vbg_a, pba_a, pbg_a, A_a, Q_a) = L
    (dR_b, dv_b, dp_b, T_b, g_b, vba_b, vbg_b, pba_b, pbg_b, A_b, Q_b) = R
    t1, t2 = T_b[..., None], T_b[..., None, None]
    return (
        mm(dR_a, dR_b),
        dv_a + mv(dR_a, dv_b),
        (dp_a + dv_a * t1) + mv(dR_a, dp_b),
        T_a + T_b,
        mtm(dR_b, g_a) + g_b,
        vba_a + mm(dR_a, vba_b),
        (vbg_a + mm(dR_a, vbg_b)) - mm(mm(dR_a, hat(dv_b)), g_a),
        (pba_a + vba_a * t2) + mm(dR_a, pba_b),
        ((pbg_a + vbg_a * t2) + mm(dR_a, pbg_b)) - mm(mm(dR_a, hat(dp_b)), g_a),
        mm9(A_b, A_a),
        mm9(mm9(A_b, Q_a), A_b.transpose(-1, -2)) + Q_b,
    )


def window_cut(mask):
    """Where each lane's window ends for the kernel and its plain version:
    (the last tile, the power of two of slots its tree covers), [B] each,
    from the last valid sample (slot 0 when none is valid). Samples past it
    are left out, not composed in as identity segments."""
    K = mask.shape[1]
    slot = torch.arange(K, device=mask.device)
    last = torch.where(mask, slot, 0).amax(1)
    tile = torch.div(last, TILE, rounding_mode="floor")
    n = last - tile * TILE + 1
    cover = torch.ones_like(n)
    for _ in range(TILE.bit_length() - 1):
        cover = torch.where(cover < n, cover * 2, cover)
    return tile, cover


def preintegrate_plain(acc, gyr, dts, mask, bias_acc, bias_gyr, acc_noise, gyr_noise,
                       int_noise):
    """Plain PyTorch version of :func:`preintegrate` (same arguments), in
    the kernel's order of operations: the ten tensors of :data:`FIELDS`."""
    B, K = dts.shape
    if K < 1:
        raise ValueError(f"preintegrate: a window of {K} samples (at least 1)")
    tiles = -(-K // TILE)
    pad = tiles * TILE - K
    last_tile, cover = window_cut(mask)
    # samples past K are masked ones: the identity segment
    acc = torch.nn.functional.pad(acc, (0, 0, 0, pad)).view(B, tiles, TILE, 3)
    gyr = torch.nn.functional.pad(gyr, (0, 0, 0, pad)).view(B, tiles, TILE, 3)
    dt = torch.nn.functional.pad(torch.where(mask, dts, 0.0), (0, pad)).view(B, tiles, TILE)
    a = acc - bias_acc[:, None, None]
    w = (gyr - bias_gyr[:, None, None]) * dt[..., None]
    th2, small, st, sn, _, A, Bt = exp_terms(w)
    W = hat(w)
    W2 = mm(W, W)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)

    def s(x):
        return x[..., None, None]

    Rinc = (eye + s(A) * W) + s(Bt) * W2
    Jr = (eye - s(Bt) * W) + s(jr_term(th2, small, st, sn)) * W2

    # each tile's inclusive rotation prefix (Hillis-Steele doubling), then
    # the exclusive prefix C incl[i - 1] with C carried from tile to tile
    incl, d = Rinc, 1
    while d < TILE:
        incl = torch.cat([incl[:, :, :d], mm(incl[:, :, :-d], incl[:, :, d:])], 2)
        d *= 2
    C = eye.expand(B, 3, 3)
    pre = []
    for t in range(tiles):
        pre.append(torch.cat([C[:, None], mm(C[:, None], incl[:, t, :-1])], 1))
        C = mm(C, incl[:, t, -1])
    P = torch.stack(pre, 1)

    segs = _leaves(a, dt, Rinc, Jr, P, gyr_noise**2, acc_noise**2, int_noise**2)
    # each tile's pairwise tree, in order; in a lane's last tile a right
    # neighbour at or past its cover is left out (the left one goes up)
    in_last = (torch.arange(tiles, device=dt.device)[None] == last_tile[:, None])[..., None]
    size = 1
    while segs[0].shape[2] > 1:
        left = tuple(x[:, :, 0::2] for x in segs)
        both = compose(left, tuple(x[:, :, 1::2] for x in segs))
        start = size * (2 * torch.arange(left[0].shape[2], device=dt.device) + 1)
        alone = in_last & (start[None, None] >= cover[:, None, None])  # [B, tiles, n]
        segs = tuple(torch.where(alone.view(*alone.shape, *(1,) * (x.dim() - 3)), l, x)
                     for l, x in zip(left, both))
        size *= 2
    out = tuple(x[:, 0, 0] for x in segs)
    for t in range(1, tiles):  # the tiles in order, up to each lane's last
        seg = tuple(x[:, t, 0] for x in segs)
        on = t <= last_tile
        out = tuple(torch.where(on.view(B, *(1,) * (x.dim() - 1)), y, x)
                    for x, y in zip(out, compose(out, seg)))
    dR, dv, dp, T, dR_dbg, dv_dba, dv_dbg, dp_dba, dp_dbg, _, cov = out
    return dR, dv, dp, T, dR_dbg, dv_dba, dv_dbg, dp_dba, dp_dbg, cov


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

ARGS = ("acc", "gyr", "dts", "mask", "bias_acc", "bias_gyr")
_SIZES = tuple(math.prod(SHAPES[f]) for f in FIELDS)  # floats a lane of each output


def _checked(acc, gyr, dts, mask, bias_acc, bias_gyr) -> list:
    """The tensors as the kernel takes them (contiguous), or ValueError: a
    dtype, shape or device it does not take, or an empty window."""
    dev = acc.device
    if dts.dim() != 2 or dts.shape[1] < 1:
        raise ValueError(f"preintegrate: dts {tuple(dts.shape)}: a [B, K] window, K >= 1")
    B, K = dts.shape
    want = ((B, K, 3), (B, K, 3), (B, K), (B, K), (B, 3), (B, 3))
    out = []
    for name, t, shape in zip(ARGS, (acc, gyr, dts, mask, bias_acc, bias_gyr), want):
        dtype = torch.bool if name == "mask" else torch.float32
        if t.dtype is not dtype or t.shape != shape or t.device != dev:
            raise ValueError(f"preintegrate: {name} {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected {dtype} {shape} on {dev}")
        out.append(t if t.is_contiguous() else t.contiguous())
    return out


_LAYOUTS: dict = {}  # lanes -> the outputs' places in one buffer


def _layout(B):
    """(size, stride, offset) of each output in one float32 buffer, field
    after field, and the buffer's length."""
    if B not in _LAYOUTS:
        views, off = [], 0
        for f, n in zip(FIELDS, _SIZES):
            shape = (B, *SHAPES[f])
            views.append((shape, tuple(math.prod(shape[k + 1:]) for k in range(len(shape))), off))
            off += B * n
        _LAYOUTS[B] = (tuple(views), off)
    return _LAYOUTS[B]


def _outputs(B, dev, apart: bool):
    """The ten outputs [B, ...] and their addresses: views of one float32
    buffer (one allocation), or (``apart``, a custom op's outputs may not
    alias) one tensor each."""
    if apart:
        out = [torch.empty((B, *SHAPES[f]), dtype=torch.float32, device=dev) for f in FIELDS]
        return out, [t.data_ptr() for t in out]
    views, total = _layout(B)
    buf = torch.empty(total, dtype=torch.float32, device=dev)
    at = buf.data_ptr()
    return ([buf.as_strided(*v) for v in views], [at + 4 * v[2] for v in views])


def _run(lib, ptrs, acc_noise, gyr_noise, int_noise, K, B, dev) -> None:
    """The ctypes call: the 16 addresses packed in one array."""
    packed = array("q", ptrs)
    err = lib.liorf_preintegrate(packed.buffer_info()[0], float(gyr_noise) ** 2,
                                 float(acc_noise) ** 2, float(int_noise) ** 2, K, B, dev.index,
                                 raw_stream(dev.index))
    if err != 0:
        raise RuntimeError(f"preintegrate: CUDA launch failed with error {err}")


def _launch(acc, gyr, dts, mask, bias_acc, bias_gyr, acc_noise, gyr_noise, int_noise,
            outputs_apart: bool = False):
    """The kernel on every lane: the arguments as :func:`preintegrate` takes them."""
    ins = _checked(acc, gyr, dts, mask, bias_acc, bias_gyr)
    B, K = dts.shape
    dev = acc.device
    out, ptrs = _outputs(B, dev, outputs_apart)
    _run(load_library(), [t.data_ptr() for t in ins] + ptrs, acc_noise, gyr_noise, int_noise,
         K, B, dev)
    preintegrate.launches += 1
    return tuple(out)


@torch.library.custom_op("liorf_tpu_torch::preintegrate", mutates_args=())
def _preintegrate_op(acc: torch.Tensor, gyr: torch.Tensor, dts: torch.Tensor,
                     mask: torch.Tensor, bias_acc: torch.Tensor, bias_gyr: torch.Tensor,
                     acc_noise: float, gyr_noise: float, int_noise: float
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor, torch.Tensor]:
    # The op on any device but CUDA is the plain version (the CPU path and
    # the tests reach the vmap rule through it).
    return preintegrate_plain(acc, gyr, dts, mask, bias_acc, bias_gyr, acc_noise, gyr_noise,
                              int_noise)


@_preintegrate_op.register_kernel("cuda")
def _preintegrate_cuda(*args):
    return _launch(*args, outputs_apart=True)


@_preintegrate_op.register_vmap
def _preintegrate_vmap(info, in_dims, *args):
    """Lanes of a vmap fold into the op's own [B] axis: one launch."""
    n = info.batch_size
    k = len(ARGS)
    out = _preintegrate_op(*(_fold_lanes(t, d, n) for t, d in zip(args[:k], in_dims[:k])),
                           *args[k:])
    return tuple(o.reshape(n, -1, *o.shape[1:]) for o in out), (0,) * len(out)


def preintegrate(acc, gyr, dts, mask, bias_acc, bias_gyr, acc_noise, gyr_noise, int_noise):
    """The preintegrated window of every lane (the ten tensors of
    :data:`FIELDS`, each [B, ...]): acc, gyr [B, K, 3], dts [B, K], mask [B,
    K] (bool), bias_acc, bias_gyr [B, 3] (the linearization point), then
    ``ImuParams``' noise densities. One call on the card for every lane (a
    vmapped call's lanes included)."""
    dev = acc.device
    if dev.type == "cuda" and _functorch.maybe_current_level() is None:
        # no vmap around the call: the launch without the custom op's dispatch
        return _launch(acc, gyr, dts, mask, bias_acc, bias_gyr, acc_noise, gyr_noise, int_noise)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"preintegrate: unsupported device {dev}")
    return _preintegrate_op(acc, gyr, dts, mask, bias_acc, bias_gyr, acc_noise, gyr_noise,
                            int_noise)


preintegrate.launches = 0


def launch_counts() -> dict[str, int]:
    return {"preintegrate": preintegrate.launches}


def kernel_launches() -> int:
    """Kernels the library has launched in this process (its own count)."""
    return int(load_library().liorf_preintegrate_kernel_launches())


def reset_launch_counts() -> None:
    preintegrate.launches = 0
