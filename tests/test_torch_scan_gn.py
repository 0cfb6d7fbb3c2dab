"""The scan matcher's GN iteration in two calls (``ops/scan_gn.py``): the
linearization's plain version against the JAX package's ``_build_system``,
the update's against JAX's degeneracy analysis and solve, the plane fit's
sign, the order contract's lane independence; and on the card (marker
``gpu``) both kernels against their plain versions, lanes against single
launches. Without JAX on the card:

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
