"""The scan matcher's GN iteration in two calls (``ops/scan_gn.py``): the
linearization's plain version against the JAX package's ``_build_system``,
the update's against JAX's degeneracy analysis and solve, the plane fit's
sign, the order contract's lane independence; and on the card (marker
``gpu``) both kernels against their plain versions, lanes against single
launches, one kernel launch a call at every lane count and point count, the
arrival counters back at 0 after every call. Without JAX on the card:

    python -m pytest tests/test_torch_scan_gn.py -m gpu -q --noconftest
"""

import numpy as np
import pytest
import torch

from liorf_tpu_torch.ops import knn as tknn
from liorf_tpu_torch.ops import plane_fit, scan_gn
from liorf_tpu_torch.ops.scan_match import ScanMatchParams

PARAMS = ScanMatchParams(knn_bucket=40)


def _world(seed=0, n_map=4096, n_scan=2048):
    """Five planes (a floor, four walls) of n_map points each, and a scan of
    n_scan of their points with 1 cm of noise, in the sensor frame of a pose
    near the origin (the shape of ``__graft_entry__.entry()``)."""
    rng = np.random.default_rng(seed)
    pts = []
    for axis, offset in [(2, 0.0), (0, -10.0), (0, 10.0), (1, -10.0), (1, 10.0)]:
        p = rng.uniform(-10, 10, size=(n_map, 3))
        p[:, axis] = offset
        pts.append(p)
    map_xyz = np.concatenate(pts).astype(np.float32)
    scan = map_xyz[rng.permutation(len(map_xyz))[:n_scan]] + rng.normal(0, 0.01, (n_scan, 3))
    scan = (scan - np.array([0.3, -0.2, 1.5])).astype(np.float32)
    mask = rng.uniform(size=n_scan) > 0.03
    pose = np.array([0.01, -0.02, 0.03, 0.25, -0.15, 1.45], np.float32)
    return map_xyz, scan, mask, pose


def _port_inputs(map_xyz, scan, mask, pose, device="cpu"):
    """The linearization's arguments, one lane, K1's (d2, idx) by knn_grid."""
    dev = torch.device(device)
    grid = tknn.build_grid(torch.as_tensor(map_xyz, device=dev),
                           torch.ones(len(map_xyz), dtype=torch.bool, device=dev),
                           torch.zeros(3, device=dev), 1.0)
    s = torch.as_tensor(scan, device=dev)[None].contiguous()
    m = torch.as_tensor(mask, device=dev)[None].contiguous()
    p = torch.as_tensor(pose, device=dev)[None].contiguous()
    nq = torch.sqrt(torch.sqrt(torch.linalg.norm(s, dim=-1) + 1e-12))
    world = scan_gn.transform_plain(p, s)
    d2, idx = tknn.knn_grid(grid, world[0], m[0], 5, PARAMS.knn_bucket)
    return p, s, m, nq, d2[None], idx[None], grid.xyz[None].contiguous()


# ---------------------------------------------------------------------------
# the plain versions against the JAX package (CPU)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_system():
    import jax.numpy as jnp

    from liorf_tpu.ops import knn as jknn
    from liorf_tpu.ops.scan_match import ScanMatchParams as JParams
    from liorf_tpu.ops.scan_match import _build_system

    map_xyz, scan, mask, pose = _world()
    jgrid = jknn.build_grid(jnp.asarray(map_xyz), jnp.ones(len(map_xyz), bool), jnp.zeros(3), 1.0)
    s = jnp.asarray(scan)
    nq = jnp.sqrt(jnp.sqrt(jnp.linalg.norm(s, axis=-1) + 1e-12))
    H, g, count = _build_system(jnp.asarray(pose), s, jnp.asarray(mask), nq, jgrid,
                                JParams(knn_bucket=40))
    return (map_xyz, scan, mask, pose), (np.asarray(H), np.asarray(g), int(count))


def test_linearize_plain_matches_jax_build_system(jax_system):
    """The same pose, scan and map. The sums run over ~1900 points in another
    order (tiles of 128 and a tree, against XLA's dot), and the plane's normal
    comes from Jacobi sweeps, not LAPACK's eigh: H and g agree to 1e-4 of
    their largest entry. A point sitting on a gate's threshold (5th-NN
    distance, plane residual, weight, collinearity) may flip and move the
    count by one and H by one point's share: count within 0.5 %, and at
    most 1e-3 of H's largest entry apart per flipped point."""
    (map_xyz, scan, mask, pose), (Hj, gj, cj) = jax_system
    H, g, count = scan_gn.scan_linearize_plain(*_port_inputs(map_xyz, scan, mask, pose),
                                               PARAMS.corr_dist, PARAMS.plane_max_resid,
                                               PARAMS.min_weight)
    assert cj > 1500
    flips = abs(int(count[0]) - cj)
    assert flips <= 0.005 * cj
    scale = np.abs(Hj).max()
    tol = 1e-4 + 1e-3 * flips
    np.testing.assert_allclose(H[0].numpy(), Hj, atol=tol * scale)
    np.testing.assert_allclose(g[0].numpy(), gj, atol=tol * np.abs(gj).max())
    assert torch.equal(H[0], H[0].T)


def test_a_flipped_normal_keeps_every_share():
    """An eigenvector's sign does not change a point's share: with (-n, -d)
    the residual, J and b flip together, and every term keeps its bits."""
    map_xyz, scan, mask, pose = _world(seed=1, n_scan=512)
    p, s, m, nq, d2, idx, gxyz = _port_inputs(map_xyz, scan, mask, pose)
    B, N = m.shape
    gate = d2[..., 4] < PARAMS.corr_dist ** 2
    nb = torch.gather(gxyz, 1, idx.long().reshape(B, N * 5, 1).expand(-1, -1, 3))
    fit = plane_fit.fit_planes(nb.reshape(N, 5, 3), (torch.isfinite(d2) & gate[..., None])[0],
                               PARAMS.plane_max_resid)
    world = scan_gn.transform_plain(p, s)
    dR = scan_gn.rot_derivatives(p[:, :3])
    args = (fit.valid[None], world, s, dR, nq, m, gate, PARAMS.min_weight)
    a = scan_gn.point_terms(fit.normal[None], fit.d[None], *args)
    b = scan_gn.point_terms(-fit.normal[None], -fit.d[None], *args)
    assert int(a[..., 27].sum()) > 300
    assert torch.equal(a, b)


def test_rotation_and_derivatives_match_jax():
    """rot_f32 (cos and sin in float64, rounded) and its closed-form
    derivatives against the JAX package's euler_to_rot and _rot_derivatives
    (float32 cos and sin, matrix products): a few float32 roundings."""
    import jax.numpy as jnp

    from liorf_tpu.core import se3 as jse3
    from liorf_tpu.ops.scan_match import _rot_derivatives

    rng = np.random.default_rng(4)
    for rpy in rng.uniform(-3, 3, (8, 3)).astype(np.float32):
        R = scan_gn.rot_f32(torch.as_tensor(rpy))
        dR = scan_gn.rot_derivatives(torch.as_tensor(rpy))
        np.testing.assert_allclose(R.numpy(), np.asarray(jse3.euler_to_rot(jnp.asarray(rpy))),
                                   atol=1e-6)
        np.testing.assert_allclose(dR.numpy(), np.asarray(_rot_derivatives(jnp.asarray(rpy))),
                                   atol=1e-6)


def test_transform_matches_the_matrix_product():
    """The moved scan (rot_f32's R, then the 3-term sums) against the route it
    replaced, se3.euler_to_rot and a batched product: a few float32 roundings
    of points ~30 m out."""
    from liorf_tpu_torch.core import se3

    rng = np.random.default_rng(8)
    pose = torch.as_tensor(rng.uniform(-1, 1, (3, 6)).astype(np.float32))
    xyz = torch.as_tensor(rng.uniform(-30, 30, (3, 500, 3)).astype(np.float32))
    want = xyz @ se3.euler_to_rot(pose[:, :3]).transpose(-1, -2) + pose[:, None, 3:]
    np.testing.assert_allclose(scan_gn.transform(pose, xyz).numpy(), want.numpy(), atol=3e-5)


def _system(seed, eig, count):
    """A seeded symmetric system with the given eigenvalues, its g and count."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    H = (Q * np.asarray(eig, np.float64)) @ Q.T
    H = ((H + H.T) / 2).astype(np.float32)
    g = rng.normal(0, 20, 6).astype(np.float32)
    return H, g, count


SYSTEMS = {
    "well_conditioned": _system(0, [300, 800, 2e3, 5e3, 1e4, 3e4], 900),
    "degenerate": _system(1, [0.5, 40, 2e3, 5e3, 1e4, 3e4], 900),
    "too_few_points": _system(2, [300, 800, 2e3, 5e3, 1e4, 3e4], 30),
}


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_update_plain_matches_jax_analyze_and_solve(name):
    """The first iteration's update against the JAX package's
    (scan_match.py:173-186 there, recomputed with jnp.linalg on the same
    H, g): eigh, the good directions' projection, solve(H + 1e-6 I, g), the
    projection where degenerate, zero below min_points. The port solves in
    float64 (Jacobi, LU), JAX in float32: against a float64 numpy solve the
    port's step is within 1e-6 of its largest component; against JAX's within
    1e-5 of it plus JAX's own distance to the float64 solve (its float32 solve
    of the whole H before the projection: 5e-6 where degenerate, condition
    6e4); the flags exactly."""
    import jax.numpy as jnp

    H, g, count = SYSTEMS[name]
    Hj = jnp.asarray(H)
    lam, V = jnp.linalg.eigh(Hj)
    good = lam >= PARAMS.eigen_thresh
    P = (V * good[None, :].astype(Hj.dtype)) @ V.T
    degenerate = bool(~jnp.all(good))
    x = jnp.linalg.solve(Hj + jnp.eye(6) * 1e-6, jnp.asarray(g))
    x = np.asarray(P @ x if degenerate else x)
    enough = count >= PARAMS.min_points
    x = x if enough else np.zeros(6, np.float32)

    H64 = H.astype(np.float64) + np.eye(6) * 1e-6
    x64 = np.linalg.solve(H64, g.astype(np.float64))
    if degenerate:
        w, U = np.linalg.eigh(H.astype(np.float64))
        x64 = (U[:, w >= PARAMS.eigen_thresh] @ U[:, w >= PARAMS.eigen_thresh].T) @ x64
    x64 = x64 if enough else np.zeros(6)

    st = scan_gn.init_state(torch.zeros((1, 6)))
    scan = torch.zeros((1, 4, 3))
    new, world, all_done = scan_gn.scan_update_plain(
        st, torch.as_tensor(H)[None], torch.as_tensor(g)[None],
        torch.tensor([count], dtype=torch.int32), scan, PARAMS, first=True)
    assert bool(new.degenerate[0]) == degenerate == (name == "degenerate")
    scale = max(np.abs(x64).max(), 1e-3)
    np.testing.assert_allclose(new.pose[0].numpy(), x64, atol=1e-6 * scale)
    own = np.abs(x - x64).max()  # JAX's float32 error: 5e-6 where degenerate (condition 6e4)
    np.testing.assert_allclose(new.pose[0].numpy(), x, atol=1e-5 * scale + own)
    assert bool(new.done[0]) == (not enough) and bool(all_done[0]) == (not enough)
    assert int(new.iters[0]) == 1 and int(new.count[0]) == count
    # the moved scan is the new pose's
    assert torch.equal(world, scan_gn.transform_plain(new.pose, scan))


def test_update_keeps_a_done_lane_frozen():
    """A lane already done keeps its pose, count and iterations; the other
    lane steps; the flag is set only once both are done."""
    H, g, _ = SYSTEMS["well_conditioned"]
    st = scan_gn.init_state(torch.tensor([[0.1, 0, 0, 1, 2, 3], [0, 0, 0, 0, 0, 0.0]]))
    st = st._replace(done=torch.tensor([True, False]), count=torch.tensor([77, 0], dtype=torch.int32),
                     iters=torch.tensor([4, 4], dtype=torch.int32))
    Hs, gs = torch.as_tensor(H)[None].repeat(2, 1, 1), torch.as_tensor(g)[None].repeat(2, 1)
    new, _, all_done = scan_gn.scan_update_plain(st, Hs, gs, torch.tensor([900, 900], dtype=torch.int32),
                                                 torch.zeros((2, 3, 3)), PARAMS, first=True)
    assert torch.equal(new.pose[0], st.pose[0]) and not torch.equal(new.pose[1], st.pose[1])
    assert new.count.tolist() == [77, 900] and new.iters.tolist() == [4, 5]
    assert not bool(all_done[0])


def test_linearize_lanes_equal_single_lanes():
    """The sums' order depends on the point count alone: a lane of a stacked
    call has the bits of a call on that lane."""
    lanes = [_port_inputs(*_world(seed=s, n_scan=700)) for s in (5, 6)]
    consts = (PARAMS.corr_dist, PARAMS.plane_max_resid, PARAMS.min_weight)
    stacked = scan_gn.scan_linearize_plain(*(torch.cat(x) for x in zip(*lanes)), *consts)
    for b, args in enumerate(lanes):
        one = scan_gn.scan_linearize_plain(*args, *consts)
        for x, y in zip(stacked, one):
            assert torch.equal(x[b:b + 1], y)


def test_tiled_sum_order():
    """tiled_sum is the halving tree within tiles of TILE, then over the
    tiles; within float32 rounding of a float64 sum."""
    x = torch.randn(3, 1000, 2, generator=torch.Generator().manual_seed(0))
    got = scan_gn.tiled_sum(x, 1)
    pad = torch.cat([x, x.new_zeros(3, 1024 - 1000, 2)], 1).reshape(3, 8, 128, 2)
    from liorf_tpu_torch.ops.fusion_step import tree_sum
    assert torch.equal(got, tree_sum(tree_sum(pad, 2), 1))
    np.testing.assert_allclose(got.numpy(), x.double().sum(1).numpy(), atol=1e-4)


_WAVES_HARNESS = r"""
// Runs csrc/jacobi6_waves.cuh's program on the CPU as the update kernel runs
// it (a wave's rotations from the state before the wave), on the float64
// matrices of argv[1]; writes each one's eigenvalues and eigenvectors to
// argv[2] and the program's ops, waves and slots to stdout.
#include <cmath>
#include <cstdio>
#include <vector>
#include "jacobi6_waves.cuh"
using namespace jacobi6;
constexpr int kSweeps = SWEEPS;
constexpr int kRot = kPairs * kSweeps;
constexpr Program kP = build<kSweeps>();
constexpr int kS = slots(kP, kRot);
static_assert(kP.n > 0, "program");
int main(int argc, char** argv) {
  FILE* in = std::fopen(argv[1], "rb");
  FILE* out = std::fopen(argv[2], "wb");
  double H[36];
  while (std::fread(H, sizeof(double), 36, in) == 36) {
    double d[6], o[kPairs], C[kS], S[kS], V[6][6];
    for (int i = 0; i < 6; ++i) {
      d[i] = H[i * 6 + i];
      for (int j = i + 1; j < 6; ++j) o[off(i, j)] = i == 0 && j == 1 ? H[1] : H[j * 6 + i];
      for (int j = 0; j < 6; ++j) V[i][j] = i == j ? 1.0 : 0.0;
    }
    for (int i = 0; i < kP.n; ++i) {
      if (kP.kind[i] == kWave) {
        double T[3], Cw[3];
        for (int j = 0; j < kP.count[i]; ++j) {
          const int k = kP.rot[i][j], p = pair_p(k), q = pair_q(k);
          const double app = d[p], aqq = d[q], apq = o[off(p, q)];
          double t = 0.0;
          if (apq != 0.0) {
            const double tau = (aqq - app) / (2.0 * apq);
            const double y = 1.0 / (std::fabs(tau) + std::sqrt(tau * tau + 1.0));
            t = tau >= 0.0 ? y : -y;
          }
          T[j] = t;
          Cw[j] = 1.0 / std::sqrt(t * t + 1.0);
        }
        for (int j = 0; j < kP.count[i]; ++j) {
          const int k = kP.rot[i][j], p = pair_p(k), q = pair_q(k);
          const double apq = o[off(p, q)];
          C[k % kS] = Cw[j];
          S[k % kS] = T[j] * Cw[j];
          d[p] = d[p] - T[j] * apq;
          d[q] = d[q] + T[j] * apq;
          o[off(p, q)] = 0.0;
        }
      } else {
        const int k = kP.rot[i][0], p = pair_p(k), q = pair_q(k);
        const double c = C[k % kS], s = S[k % kS];
        if (kP.kind[i] == kRow) {
          const int r = kP.row[i];
          const double x = o[off(r, p)], y = o[off(r, q)];
          o[off(r, p)] = c * x - s * y;
          o[off(r, q)] = s * x + c * y;
        } else {
          for (int r = 0; r < 6; ++r) {
            const double vp = V[r][p], vq = V[r][q];
            V[r][p] = c * vp - s * vq;
            V[r][q] = s * vp + c * vq;
          }
        }
      }
    }
    std::fwrite(d, sizeof(double), 6, out);
    std::fwrite(V, sizeof(double), 36, out);
  }
  int waves = 0;
  for (int i = 0; i < kP.n; ++i) waves += kP.kind[i] == kWave;
  std::printf("%d %d %d\n", kP.n, waves, kS);
  std::fclose(out);
  return 0;
}
"""


def _sweeps_ieee(A, sweeps):
    """gn_common.cuh::jacobi's sweeps, one IEEE float64 operation at a time
    (numpy scalars): the order ``plane_fit.jacobi_eigh`` spells in tensors."""
    a, v = A.copy(), np.eye(6)
    with np.errstate(over="ignore"):  # a tiny a_pq overflows tau to inf, then t = 0
        return _sweeps(a, v, sweeps)


def _sweeps(a, v, sweeps):
    for _ in range(sweeps):
        for p in range(5):
            for q in range(p + 1, 6):
                apq, t = a[p, q], 0.0
                if apq != 0.0:
                    tau = (a[q, q] - a[p, p]) / (2.0 * apq)
                    t = (1.0 if tau >= 0.0 else -1.0) / (abs(tau) + np.sqrt(tau * tau + 1.0))
                c = 1.0 / np.sqrt(t * t + 1.0)
                s = t * c
                app, aqq = a[p, p] - t * apq, a[q, q] + t * apq
                for r in range(6):
                    if r != p and r != q:
                        arp, arq = a[r, p], a[r, q]
                        a[r, p] = a[p, r] = c * arp - s * arq
                        a[r, q] = a[q, r] = s * arp + c * arq
                a[p, p], a[q, q], a[p, q], a[q, p] = app, aqq, 0.0, 0.0
                vp, vq = v[:, p].copy(), v[:, q].copy()
                v[:, p], v[:, q] = c * vp - s * vq, s * vp + c * vq
    return np.diag(a).copy(), v


def test_jacobi_wave_program_is_the_sweeps(tmp_path):
    """The update kernel runs the first iteration's 6x6 Jacobi as a program
    of waves (``csrc/jacobi6_waves.cuh``: each task as soon as the last
    earlier task on its entries has run). Built for the CPU by g++ (no
    contraction) and run as the kernel runs it, the program gives the
    sequential sweeps' bits in IEEE float64 (``_sweeps_ieee``) at
    ``JACOBI6_SWEEPS`` sweeps: the scan matcher's systems, degenerate and
    diagonal ones, a zero row, scales from 1e-27 to 1e6, and matrices that
    are not symmetric; the 120 rotations in 51 waves. Against the plain
    version on the CPU (``plane_fit.jacobi_eigh``, where torch's float64
    square root is not always the correctly rounded one) within 1e-12 of
    the largest entry; on the card the kernel and the plain version agree
    bit for bit (the gpu cases)."""
    import shutil
    import subprocess
    from pathlib import Path

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the wave program for the CPU")
    csrc = Path(scan_gn.__file__).resolve().parent.parent / "csrc"
    src, exe = tmp_path / "waves.cpp", tmp_path / "waves"
    src.write_text(_WAVES_HARNESS.replace("SWEEPS;", f"{scan_gn.JACOBI6_SWEEPS};", 1))
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-I", str(csrc), str(src),
                    "-o", str(exe)], check=True, capture_output=True)
    rng = np.random.default_rng(11)
    mats = [SYSTEMS[k][0] for k in SYSTEMS]
    for _ in range(40):
        Q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
        eig = 10.0 ** rng.uniform(-3, 5, 6) * (rng.uniform(size=6) < 0.85)
        mats.append(((Q * eig) @ Q.T) * 10.0 ** rng.uniform(-27, 1))
    mats.append(np.diag([5.0, 3.0, 3.0, 1.0, 0.0, 2.0]))
    zero_row = mats[5].copy()
    zero_row[2], zero_row[:, 2] = 0.0, 0.0
    mats.append(zero_row)
    H = np.stack(mats)
    H = ((H + np.swapaxes(H, 1, 2)) / 2).astype(np.float32).astype(np.float64)
    H = np.concatenate([H, rng.normal(size=(3, 6, 6)).astype(np.float32).astype(np.float64)])
    (tmp_path / "in.bin").write_bytes(H.tobytes())
    run = subprocess.run([str(exe), str(tmp_path / "in.bin"), str(tmp_path / "out.bin")],
                         check=True, capture_output=True, text=True)
    ops, waves, slots = map(int, run.stdout.split())
    assert waves == 51 and slots < 15 * scan_gn.JACOBI6_SWEEPS
    got = np.frombuffer((tmp_path / "out.bin").read_bytes(), np.float64).reshape(len(H), 42)
    for h, row in zip(H, got):
        lam, V = _sweeps_ieee(h, scan_gn.JACOBI6_SWEEPS)
        assert np.array_equal(row[:6], lam) and np.array_equal(row[6:].reshape(6, 6), V)
    lam, V = plane_fit.jacobi_eigh(torch.as_tensor(H), scan_gn.JACOBI6_SWEEPS)
    scale = np.abs(H).max(axis=(1, 2))
    assert (np.abs(got[:, :6] - lam.numpy()).max(1) <= 1e-12 * scale).all()
    assert (np.abs(got[:, 6:] - V.numpy().reshape(-1, 36)).max(1) <= 1e-9).all()


def test_wrappers_take_the_plain_version_on_the_cpu():
    args = _port_inputs(*_world(seed=2, n_scan=300))
    scan_gn.reset_launch_counts()
    H, g, c = scan_gn.scan_linearize(*args, PARAMS)
    st = scan_gn.init_state(args[0])
    scan_gn.scan_update(st, H, g, c, args[1], PARAMS, first=True)
    assert scan_gn.launch_counts() == {"scan_linearize": 0, "scan_update": 0, "transform": 0}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    # decided here, not at import: every xdist worker must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _same(x, y):
    return bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all()) if x.is_floating_point() \
        else bool(torch.equal(x, y))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 3])
def test_kernels_are_their_plain_versions(dev, seed):
    """Bit for bit against the plain versions on the card, both calls, the
    first iteration (Jacobi on H) and a later one; a second launch repeats."""
    args = _port_inputs(*_world(seed=seed), device=dev)
    consts = (PARAMS.corr_dist, PARAMS.plane_max_resid, PARAMS.min_weight)
    before = scan_gn.launch_counts()
    H, g, c = scan_gn.scan_linearize(*args, PARAMS)
    again = scan_gn.scan_linearize(*args, PARAMS)
    want = scan_gn.scan_linearize_plain(*args, *consts)
    assert int(c[0]) > 1000
    for x, y, z in zip((H, g, c), want, again):
        assert _same(x, y) and _same(x, z)
    st = scan_gn.init_state(args[0])
    for first in (True, False):
        got = scan_gn.scan_update(st, H, g, c, args[1], PARAMS, first=first)
        ref = scan_gn.scan_update_plain(st, H, g, c, args[1], PARAMS, first=first)
        for x, y in zip((*got[0], got[1], got[2]), (*ref[0], ref[1], ref[2])):
            assert _same(x, y)
        st = got[0]
    after = scan_gn.launch_counts()
    assert after["scan_linearize"] == before["scan_linearize"] + 2
    assert after["scan_update"] == before["scan_update"] + 2


@pytest.mark.gpu
def test_lanes_equal_single_launches(dev):
    lanes = [_port_inputs(*_world(seed=s, n_scan=1500), device=dev) for s in range(3)]
    stacked = scan_gn.scan_linearize(*(torch.cat(x).contiguous() for x in zip(*lanes)), PARAMS)
    for b, args in enumerate(lanes):
        one = scan_gn.scan_linearize(*args, PARAMS)
        for x, y in zip(stacked, one):
            assert _same(x[b:b + 1], y)
    st = scan_gn.init_state(torch.cat([x[0] for x in lanes]))
    scans = torch.cat([x[1] for x in lanes]).contiguous()
    got = scan_gn.scan_update(st, *stacked, scans, PARAMS, first=True)
    for b in range(3):
        one = scan_gn.scan_update(scan_gn.init_state(lanes[b][0]), *(t[b:b + 1] for t in stacked),
                                  scans[b:b + 1], PARAMS, first=True)
        for x, y in zip(got[0], one[0]):
            assert _same(x[b:b + 1], y)
        assert _same(got[1][b:b + 1], one[1])


@pytest.mark.gpu
def test_transform_kernel_is_its_plain_version(dev):
    """Bit for bit on the card, every lane in one launch (the cos and sin in
    float64 are CUDA's on both sides)."""
    rng = np.random.default_rng(9)
    pose = torch.as_tensor(rng.uniform(-3, 3, (4, 6)).astype(np.float32), device=dev)
    xyz = torch.as_tensor(rng.uniform(-80, 80, (4, 3000, 3)).astype(np.float32), device=dev)
    before = scan_gn.transform.launches
    got = scan_gn.transform(pose, xyz)
    assert scan_gn.transform.launches == before + 1
    assert torch.equal(got, scan_gn.transform_plain(pose, xyz))
    assert torch.equal(got[2:3], scan_gn.transform(pose[2:3], xyz[2:3].contiguous()))


@pytest.mark.gpu
def test_wrappers_check_their_arguments(dev):
    args = list(_port_inputs(*_world(seed=1, n_scan=256), device=dev))
    bad = list(args)
    bad[5] = bad[5].long()
    with pytest.raises(TypeError):
        scan_gn.scan_linearize(*bad, PARAMS)
    bad = list(args)
    bad[6] = bad[6].cpu()
    with pytest.raises(ValueError):
        scan_gn.scan_linearize(*bad, PARAMS)
    H, g, c = scan_gn.scan_linearize(*args, PARAMS)
    st = scan_gn.init_state(args[0])
    with pytest.raises(ValueError):
        scan_gn.scan_update(st, H.transpose(1, 2), g, c, args[1], PARAMS, first=True)


def _stack(n_lanes, n_scan, dev, seed=20):
    """The linearization's arguments of n_lanes seeded lanes of n_scan points."""
    lanes = [_port_inputs(*_world(seed=seed + s, n_scan=n_scan), device=dev) for s in range(n_lanes)]
    return tuple(torch.cat(x).contiguous() for x in zip(*lanes))


def _check_one_call(dev, args, st, first):
    """Both calls once against their plain versions, bit for bit; one kernel
    launch each; the arrival counters 0 after each. The new state."""
    consts = (PARAMS.corr_dist, PARAMS.plane_max_resid, PARAMS.min_weight)
    B = args[0].shape[0]
    k0 = scan_gn.kernel_launches()
    got = scan_gn.scan_linearize(*args, PARAMS)
    assert scan_gn.kernel_launches() == k0 + 1
    for x, y in zip(got, scan_gn.scan_linearize_plain(*args, *consts)):
        assert _same(x, y)
    assert not bool(scan_gn.arrival_counters(dev, "linearize", B).any())
    k0 = scan_gn.kernel_launches()
    new, world, all_done = scan_gn.scan_update(st, *got, args[1], PARAMS, first=first)
    assert scan_gn.kernel_launches() == k0 + 1
    ref = scan_gn.scan_update_plain(st, *got, args[1], PARAMS, first=first)
    for x, y in zip((*new, world, all_done), (*ref[0], ref[1], ref[2])):
        assert _same(x, y)
    assert not bool(scan_gn.arrival_counters(dev, "update", 1).any())
    return new


@pytest.mark.gpu
@pytest.mark.parametrize("lanes, n", [(1, 1), (3, 127), (3, 128), (3, 129), (1, 16384),
                                      (2, 16385), (8, 1500), (33, 300)])
def test_one_launch_a_call_is_the_plain_version(dev, lanes, n):
    """Every lane count and point count (one tile, a tile's edge, the main
    path's 128 tiles, and past them, where the tiles' tree starts in device
    memory) through a first and two later iterations: each call one kernel
    launch, bit for bit its plain version (the moved scan and the all-done
    flag with it)."""
    args = _stack(lanes, n, dev)
    st = scan_gn.init_state(args[0])
    for first in (True, False, False):
        st = _check_one_call(dev, args, st, first)
        args = (st.pose.contiguous(), *args[1:])


def _systems(dev, names):
    """The SYSTEMS' (H, g, count) stacked over the lanes, on the card."""
    H, g, c = zip(*(SYSTEMS[k] for k in names))
    return (torch.as_tensor(np.stack(H), device=dev), torch.as_tensor(np.stack(g), device=dev),
            torch.tensor(c, dtype=torch.int32, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("first", [True, False])
def test_update_edge_lanes_are_the_plain_version(dev, first):
    """A degenerate lane, a lane with too few points, a frozen lane and a
    well-conditioned one in one launch, on the first and a later iteration:
    bit for bit the plain version, and the all-done flag only once every lane
    is done."""
    names = ["degenerate", "too_few_points", "well_conditioned", "well_conditioned"]
    H, g, c = _systems(dev, names)
    scan = torch.as_tensor(np.random.default_rng(3).uniform(-20, 20, (4, 700, 3)).astype(np.float32),
                           device=dev)
    st = scan_gn.init_state(torch.zeros((4, 6), device=dev))
    if not first:  # a later iteration carries the first one's projection
        st = scan_gn.scan_update_plain(st, H, g, c, scan, PARAMS, first=True)[0]
    st = st._replace(done=torch.tensor([False, False, True, False], device=dev))
    got = scan_gn.scan_update(st, H, g, c, scan, PARAMS, first=first)
    ref = scan_gn.scan_update_plain(st, H, g, c, scan, PARAMS, first=first)
    for x, y in zip((*got[0], got[1], got[2]), (*ref[0], ref[1], ref[2])):
        assert _same(x, y)
    assert bool(got[0].degenerate[0]) and not bool(got[0].degenerate[3])
    assert torch.equal(got[0].pose[2], st.pose[2])
    assert not bool(got[2][0])
    done = st._replace(done=torch.ones(4, dtype=torch.bool, device=dev))
    assert bool(scan_gn.scan_update(done, H, g, c, scan, PARAMS, first=first)[2][0])


@pytest.mark.gpu
def test_back_to_back_calls_reset_the_arrival_counters(dev):
    """Calls of 3, 1, 33 and 3 lanes back to back, the all-done flag
    alternating: every call's last tile and last lane find the counters at 0
    (a counter left over would skip H or the flag), bit for bit the plain
    versions."""
    st = None
    for k, lanes in enumerate((3, 1, 33, 3)):
        args = _stack(lanes, 300, dev, seed=40 + k)
        st = scan_gn.init_state(args[0])
        st = st._replace(done=torch.full((lanes,), k % 2 == 1, device=dev))
        new = _check_one_call(dev, args, st, first=True)
        flag = scan_gn.scan_update(st, *scan_gn.scan_linearize(*args, PARAMS), args[1], PARAMS,
                                   first=True)[2]
        want = scan_gn.scan_update_plain(st, *scan_gn.scan_linearize(*args, PARAMS), args[1],
                                         PARAMS, first=True)[2]
        assert torch.equal(flag, want)
        assert new.done.shape == (lanes,)
