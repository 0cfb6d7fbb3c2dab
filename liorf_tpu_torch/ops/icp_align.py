"""ICP's alignment step (``ops/icp.py``) in one hand-written kernel.

Not a TPU kernel. The JAX package does this step in XLA
(``liorf_tpu/ops/icp.py:73-91``): the weighted means, the cross-covariance,
``jnp.linalg.svd`` and ``det`` (Kabsch), the composition with the pose. Op
by op on the card that was ~30 eager launches and a library SVD an ICP
iteration, each making the host wait for the card. The kernel
(``csrc/icp_align.cu``) runs an iteration of every lane in one call, after
kernel K2 (the 1-NN search, its own launch), one block a lane:

* the sums of the correspondences within ``max_d2`` (their count, the moved
  source's and the matched targets' coordinates), then the 3x3
  cross-covariance S of their deviations from the means, both over the
  points in :func:`~liorf_tpu_torch.ops.scan_gn.tiled_sum`'s order;
* the optimal proper rotation by Horn's quaternion method: the eigenvector of
  the largest eigenvalue of the 4x4 symmetric matrix built from S (cyclic
  Jacobi, float64). The same minimizer as Kabsch's ``U diag(1, 1, det) V^T``,
  the reflection case included, without an SVD or a determinant;
* the translation, the composition with the lane's pose (the rotation that
  moved the source), ``rot_to_euler`` with its gimbal branch, all in float64
  and rounded to float32 once; the change, the lane's done flag, the
  source moved by the new pose (the next K2's queries) and one "all lanes
  done" flag, the only value the host reads an iteration.

The order contract is ``ops/scan_gn.py``'s; asin and atan2 are taken in
float64 (CUDA's, on the card, for torch and the kernel alike). On the card
the kernel and :func:`icp_align_plain` agree bit for bit. Dispatch by the
tensor's device and nothing else: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from ..core.build import build_cuda_library
from .fusion_step import tree_sum
from .plane_fit import dot3, jacobi_eigh
from .scan_gn import TILE, _check, _device, rot_f32, tiled_sum, transform_plain

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "icp_align.cu"

# Sweeps of the float64 4x4 solve: over 3000 seeded matrices the largest
# off-diagonal entry left over the largest input entry was 6.6e-20 after 5
# sweeps and 1.6e-79 after 6.
JACOBI4_SWEEPS = 6

_lib = None
build_seconds: float | None = None  # wall time of the nvcc run, if one was needed


def load_library(extra_flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    so, build_seconds = build_cuda_library(_SOURCE, extra_flags)
    lib = ctypes.CDLL(str(so))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.liorf_icp_align.argtypes = [vp] * 14 + [cf, cf, ci, ci, ci, vp]
    lib.liorf_icp_align.restype = ci
    _lib = lib
    return lib


class ICPState(NamedTuple):
    """The batched ICP loop's state a lane."""
    pose: torch.Tensor  # [B, 6] float32 rpyxyz source -> target
    done: torch.Tensor  # [B] bool: the change fell below epsilon
    iters: torch.Tensor  # [B] int32 live iterations


def init_state(pose: torch.Tensor) -> ICPState:
    B, dev = pose.shape[0], pose.device
    return ICPState(pose.to(torch.float32).contiguous(),
                    torch.zeros((B,), dtype=torch.bool, device=dev),
                    torch.zeros((B,), dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def horn_matrix(S: torch.Tensor) -> torch.Tensor:
    """Horn's 4x4 symmetric matrix [B, 4, 4] of a cross-covariance S [B, 3, 3]
    (S[i][j] = sum of target_i source_j deviations): with h(a, b) = S[b][a]
    (source a, target b), the eigenvector of its largest eigenvalue is the
    unit quaternion (w, x, y, z) of the rotation taking the source onto the
    target."""
    def h(a, b):
        return S[:, b, a]

    xx, yy, zz = h(0, 0), h(1, 1), h(2, 2)
    yz, zy, zx, xz, xy, yx = h(1, 2), h(2, 1), h(2, 0), h(0, 2), h(0, 1), h(1, 0)
    rows = [
        [(xx + yy) + zz, yz - zy, zx - xz, xy - yx],
        [yz - zy, (xx - yy) - zz, xy + yx, zx + xz],
        [zx - xz, xy + yx, (yy - xx) - zz, yz + zy],
        [xy - yx, zx + xz, yz + zy, ((-xx) - yy) + zz],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def quat_rotation(q: torch.Tensor) -> torch.Tensor:
    """[B, 4] unit quaternion (w, x, y, z) -> [B, 3, 3]."""
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    rows = [
        [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z), 2.0 * (x * z + w * y)],
        [2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - w * x)],
        [2.0 * (x * z - w * y), 2.0 * (y * z + w * x), 1.0 - 2.0 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def horn_rotation(S: torch.Tensor) -> torch.Tensor:
    """The proper rotation [B, 3, 3] maximizing trace(R^T S) of a float64
    cross-covariance [B, 3, 3]: Horn's quaternion, the eigenvector of the
    largest eigenvalue (the first on a tie) of :func:`horn_matrix` by
    ``JACOBI4_SWEEPS`` Jacobi sweeps."""
    lam, V = jacobi_eigh(horn_matrix(S), JACOBI4_SWEEPS)
    best, k = lam[:, 0], torch.zeros_like(lam[:, 0], dtype=torch.long)
    for j in range(1, 4):
        gt = lam[:, j] > best
        k = torch.where(gt, j, k)
        best = torch.where(gt, lam[:, j], best)
    q = torch.gather(V, 2, k[:, None, None].expand(-1, 4, 1))[:, :, 0]
    return quat_rotation(q)


def _mm(A, B):
    return torch.stack([torch.stack([dot3(A[:, i, :], B[:, :, j]) for j in range(3)], -1)
                        for i in range(3)], -2)


def _mv(A, x):
    return torch.stack([dot3(A[:, i, :], x) for i in range(3)], -1)


def rot_to_euler64(R: torch.Tensor) -> torch.Tensor:
    """``core/se3.py::rot_to_euler`` in float64: the gimbal branch (cos(pitch)
    <= 1e-6: roll 0, yaw from the other pair) kept."""
    sp = torch.clamp(-R[:, 2, 0], -1.0, 1.0)
    pitch = torch.asin(sp)
    cp = torch.sqrt(torch.clamp(1.0 - sp * sp, min=0.0))
    safe = cp > 1e-6
    roll = torch.where(safe, torch.atan2(R[:, 2, 1], R[:, 2, 2]), torch.zeros_like(sp))
    yaw = torch.where(safe, torch.atan2(R[:, 1, 0], R[:, 0, 0]), torch.atan2(-R[:, 0, 1], R[:, 1, 1]))
    return torch.stack([roll, pitch, yaw], -1)


def icp_align_plain(state: ICPState, moved, d2, idx, target_xyz, source_mask, source_xyz,
                    max_d2: float, epsilon: float):
    """Plain PyTorch version of :func:`icp_align` (same arguments), in the
    kernel's order of operations."""
    B, N = source_mask.shape
    d2, idx = d2.reshape(B, N), idx.reshape(B, N)
    ok = source_mask & torch.isfinite(d2) & (d2 < max_d2)
    matched = torch.gather(target_xyz, 1, idx.long()[..., None].expand(-1, -1, 3))
    first = torch.cat([torch.ones_like(d2)[..., None], moved, matched], -1)
    s1 = tiled_sum(torch.where(ok[..., None], first, 0.0), 1)  # [B, 7]
    wsum = torch.where(s1[:, 0] < 1.0, torch.ones_like(s1[:, 0]), s1[:, 0])[:, None]
    mu_s, mu_t = s1[:, 1:4] / wsum, s1[:, 4:7] / wsum
    dt, ds = matched - mu_t[:, None], moved - mu_s[:, None]
    second = torch.stack([dt[..., i] * ds[..., j] for i in range(3) for j in range(3)], -1)
    S = tiled_sum(torch.where(ok[..., None], second, 0.0), 1).reshape(B, 3, 3)
    R_d = horn_rotation(S.double())
    t_d = mu_t.double() - _mv(R_d, mu_s.double())
    # compose: new = delta o pose, with the rotation that moved the source
    R_new = _mm(R_d, rot_f32(state.pose[:, :3]).double())
    t_new = _mv(R_d, state.pose[:, 3:].double()) + t_d
    new_pose = torch.cat([rot_to_euler64(R_new), t_new], -1).float()
    diff = new_pose - state.pose
    delta = tree_sum(diff * diff, -1)
    live = ~state.done
    pose = torch.where(live[:, None], new_pose, state.pose)
    new = ICPState(pose, state.done | (delta < epsilon), state.iters + live.to(torch.int32))
    return new, transform_plain(pose, source_xyz), torch.all(new.done).reshape(1)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def icp_align(state: ICPState, moved, d2, idx, target_xyz, source_mask, source_xyz,
              max_d2: float, epsilon: float):
    """One ICP iteration of every lane: moved source [B, N, 3] (the source by
    the lane's pose) and K2's (d2, idx) [B, N, 1] of it against the target
    [B, M, 3]; source mask [B, N] and the source itself [B, N, 3]. Returns
    (the new ICPState, the source moved by the new poses [B, N, 3], all lanes
    done [1] bool). A lane already done keeps its pose and iterations. One
    call on the card for every lane."""
    if _device(moved, "icp_align").type == "cpu":
        return icp_align_plain(state, moved, d2, idx, target_xyz, source_mask, source_xyz,
                               max_d2, epsilon)
    return _launch_align(state, moved, d2, idx, target_xyz, source_mask, source_xyz, max_d2,
                         epsilon)


def _launch_align(state: ICPState, moved, d2, idx, target_xyz, source_mask, source_xyz,
                  max_d2: float, epsilon: float):
    dev = moved.device
    B, N = source_mask.shape
    M = target_xyz.shape[1]
    f32, b8, i32 = torch.float32, torch.bool, torch.int32
    ins = [_check(state.pose, "pose", f32, (B, 6), dev), _check(state.done, "done", b8, (B,), dev),
           _check(state.iters, "iters", i32, (B,), dev),
           _check(moved, "moved", f32, (B, N, 3), dev), _check(d2, "d2", f32, (B, N, 1), dev),
           _check(idx, "idx", i32, (B, N, 1), dev),
           _check(target_xyz, "target_xyz", f32, (B, M, 3), dev),
           _check(source_mask, "source_mask", b8, (B, N), dev),
           _check(source_xyz, "source_xyz", f32, (B, N, 3), dev)]
    tiles = 1 << (max(1, -(-N // TILE)) - 1).bit_length()
    if tiles * 9 * 4 > 48 * 1024:
        raise ValueError(f"icp_align: {N} points a lane; the tile sums need at most 48 KB of "
                         f"shared memory ({tiles} tiles of {TILE})")
    new = ICPState(*(torch.empty_like(t) for t in state))
    moved_next = torch.empty((B, N, 3), dtype=f32, device=dev)
    all_done = torch.empty((1,), dtype=b8, device=dev)
    if B == 0:
        return new, moved_next, all_done.fill_(True)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.liorf_icp_align(
            *(t.data_ptr() for t in ins), *(t.data_ptr() for t in new), moved_next.data_ptr(),
            all_done.data_ptr(), max_d2, epsilon, B, N, M,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"icp_align: CUDA launch failed with error {err}")
    icp_align.launches += 1
    return new, moved_next, all_done


icp_align.launches = 0


def launch_counts() -> dict[str, int]:
    return {"icp_align": icp_align.launches}


def reset_launch_counts() -> None:
    icp_align.launches = 0
