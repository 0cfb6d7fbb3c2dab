"""Module-by-module parity of the PyTorch port with the JAX package.

Every case builds its inputs with numpy from a seed, hands the same arrays to
both sides on the CPU, and compares the outputs. Tolerances are stated per
case with their reason; "f32 reassociation" means both sides do the same f32
arithmetic in a different order (XLA fuses and reorders, torch runs op by op).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liorf_tpu.core import se3 as jse3
from liorf_tpu.core import voxel as jvoxel
from liorf_tpu.core.pointcloud import PAD_COORD, PointCloud as JPointCloud
from liorf_tpu.graph import pose_graph as jpg
from liorf_tpu.imu import fusion as jfusion
from liorf_tpu.imu import preintegration as jpre
from liorf_tpu.mapping import keyframes as jkf
from liorf_tpu.ops import deskew as jdeskew
from liorf_tpu.ops import icp as jicp
from liorf_tpu.ops import plane_fit as jplane
from liorf_tpu.ops import scancontext as jsc
from liorf_tpu_torch import convert
from liorf_tpu_torch.core import se3 as tse3
from liorf_tpu_torch.core import se3np
from liorf_tpu_torch.core import voxel as tvoxel
from liorf_tpu_torch.core.pointcloud import PointCloud as TPointCloud
from liorf_tpu_torch.graph import pose_graph as tpg
from liorf_tpu_torch.imu import fusion as tfusion
from liorf_tpu_torch.imu import preintegration as tpre
from liorf_tpu_torch.mapping import keyframes as tkf
from liorf_tpu_torch.ops import deskew as tdeskew
from liorf_tpu_torch.ops import icp as ticp
from liorf_tpu_torch.ops import plane_fit as tplane
from liorf_tpu_torch.ops import scancontext as tsc


def _t(a):
    return torch.tensor(np.asarray(a))


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, rtol=0.0, atol=0.0):
    np.testing.assert_allclose(_n(a), _n(b), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# core/se3
# ---------------------------------------------------------------------------

_SE3_UNARY = [
    "euler_to_rot", "so3_exp", "so3_left_jacobian", "so3_left_jacobian_inv",
    "hat", "pose_to_matrix", "pose_inverse",
]


@pytest.mark.parametrize("name", _SE3_UNARY)
def test_se3_unary(name):
    """Elementwise closed forms: 2e-6 absolute (f32 sin/cos differ in the last
    ulp between the two libraries)."""
    rng = np.random.default_rng(0)
    width = 6 if name.startswith("pose") else 3
    x = rng.uniform(-1.2, 1.2, (64, width)).astype(np.float32)
    x[0] = 0.0  # the Taylor branches
    x[1] = 1e-7
    _close(getattr(tse3, name)(_t(x)), getattr(jse3, name)(jnp.asarray(x)), atol=2e-6)


def test_se3_round_trips_and_logs():
    rng = np.random.default_rng(1)
    rpy = rng.uniform(-1.4, 1.4, (128, 3)).astype(np.float32)
    R = tse3.euler_to_rot(_t(rpy))
    _close(tse3.rot_to_euler(R), rpy, atol=5e-6)
    _close(tse3.rot_to_euler(R), jse3.rot_to_euler(jnp.asarray(R.numpy())), atol=2e-6)
    q = tse3.rot_to_quat(R)
    _close(q, jse3.rot_to_quat(jnp.asarray(R.numpy())), atol=2e-6)
    _close(tse3.quat_to_rot(q), R, atol=5e-6)
    # so3_log incl. the identity, tiny angles and the near-pi branch
    w = rng.normal(size=(128, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    ang = rng.uniform(0.0, np.pi, (128, 1)).astype(np.float32)
    ang[:4, 0] = [0.0, 1e-6, np.pi - 1e-3, np.pi - 5e-3]
    Rw = jse3.so3_exp(jnp.asarray(w * ang))
    _close(tse3.so3_log(_t(np.asarray(Rw))), jse3.so3_log(Rw), atol=2e-5)
    a = rng.uniform(-1, 1, (32, 6)).astype(np.float32)
    b = rng.uniform(-1, 1, (32, 6)).astype(np.float32)
    for fn in ("pose_compose", "pose_between"):
        _close(getattr(tse3, fn)(_t(a), _t(b)), getattr(jse3, fn)(jnp.asarray(a), jnp.asarray(b)), atol=5e-6)
    _close(
        tse3.euler_slerp(_t(a[:, :3]), _t(b[:, :3]), 0.3),
        jse3.euler_slerp(jnp.asarray(a[:, :3]), jnp.asarray(b[:, :3]), 0.3), atol=5e-6,
    )
    pts = rng.normal(size=(32, 10, 3)).astype(np.float32)
    _close(tse3.pose_apply(_t(a), _t(pts)), jse3.pose_apply(jnp.asarray(a), jnp.asarray(pts)), atol=5e-6)
    Ra, ta = jse3.euler_to_rot(jnp.asarray(a[:, :3])), jnp.asarray(a[:, 3:])
    Rb, tb = jse3.euler_to_rot(jnp.asarray(b[:, :3])), jnp.asarray(b[:, 3:])
    xi_j = jse3.se3_local(Ra, ta, Rb, tb)
    xi_t = tse3.se3_local(*(_t(np.asarray(v)) for v in (Ra, ta, Rb, tb)))
    _close(xi_t, xi_j, atol=1e-5)
    R2, t2 = tse3.se3_retract(_t(np.asarray(Ra)), _t(np.asarray(ta)), xi_t)
    _close(R2, Rb, atol=1e-5)
    _close(t2, tb, atol=1e-5)


# ---------------------------------------------------------------------------
# core/voxel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out_cap", [None, 300])
def test_voxel_downsample(out_cap):
    """Output order, masks and rep_idx exact; centroids to 1e-5 relative
    (index_add_ accumulates in another order than XLA's scatter-add)."""
    rng = np.random.default_rng(2)
    n = 2048
    xyz = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    xyz[:, 2] *= 0.1
    inten = rng.uniform(0, 1, n).astype(np.float32)
    mask = rng.uniform(size=n) > 0.2
    xyz[~mask] = PAD_COORD
    rj = jvoxel.voxel_downsample(
        JPointCloud(jnp.asarray(xyz), jnp.asarray(inten), jnp.asarray(mask)), 0.5, out_cap
    )
    rt = tvoxel.voxel_downsample(TPointCloud(_t(xyz), _t(inten), _t(mask)), 0.5, out_cap)
    np.testing.assert_array_equal(_n(rt.cloud.mask), _n(rj.cloud.mask))
    np.testing.assert_array_equal(_n(rt.rep_idx), _n(rj.rep_idx))
    _close(rt.cloud.xyz, rj.cloud.xyz, rtol=1e-5, atol=1e-6)
    _close(rt.cloud.intensity, rj.cloud.intensity, rtol=1e-5, atol=1e-6)
    assert 0 < int(rt.cloud.mask.sum()) < n
    _close(tvoxel.voxel_downsample_np(xyz[mask], 0.5), jvoxel.voxel_downsample_np(xyz[mask], 0.5))


def test_pointcloud_containers():
    from liorf_tpu.core import pointcloud as jpc
    from liorf_tpu_torch.core import pointcloud as tpc

    rng = np.random.default_rng(12)
    xyz = rng.normal(size=(10, 3)).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0, 0, 1, 1, 1, 0], bool)
    for cap in (16, 6, None):
        cj = jpc.make_cloud(xyz, np.arange(10.0), mask, capacity=cap)
        ct = tpc.make_cloud(xyz, np.arange(10.0), mask, capacity=cap, device="cpu")
        for a, b in zip(ct, cj):
            np.testing.assert_array_equal(_n(a), _n(b))
        assert int(ct.count()) == int(cj.count()) and ct.capacity == cj.capacity
        for a, b in zip(tpc.compact(ct), jpc.compact(cj)):
            np.testing.assert_array_equal(_n(a), _n(b))
        np.testing.assert_array_equal(tpc.to_numpy(ct), jpc.to_numpy(cj))
    extra = np.arange(10) % 3 != 0
    ct = tpc.apply_mask(tpc.make_cloud(xyz, mask=mask, device="cpu"), _t(extra))
    cj = jpc.apply_mask(jpc.make_cloud(xyz, mask=mask), jnp.asarray(extra))
    np.testing.assert_array_equal(_n(ct.xyz), _n(cj.xyz))
    assert tpc.round_up_pow2(300) == jpc.round_up_pow2(300) == 512
    assert tpc.PAD_COORD == jpc.PAD_COORD == PAD_COORD


# ---------------------------------------------------------------------------
# ops/plane_fit
# ---------------------------------------------------------------------------

def _plane_case(seed, n=1024):
    rng = np.random.default_rng(seed)
    normals = rng.normal(size=(n, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    centers = rng.uniform(-10, 10, (n, 3))
    nb = centers[:, None, :] + rng.uniform(-0.5, 0.5, (n, 5, 3))
    # project onto each plane, then add noise; some neighbourhoods are noisy
    # enough to fail the residual gate, some are collinear
    off = np.einsum("nki,ni->nk", nb - centers[:, None, :], normals)
    nb = nb - off[..., None] * normals[:, None, :]
    noise = np.where(rng.uniform(size=(n, 1, 1)) < 0.2, 0.3, 0.01)
    nb = nb + rng.normal(size=nb.shape) * noise
    nb[:16] = centers[:16, None, :] + np.linspace(-0.5, 0.5, 5)[None, :, None] * normals[:16, None, :]
    nmask = rng.uniform(size=(n, 5)) > 0.03
    return nb.astype(np.float32), nmask


def test_plane_fit():
    """eigh returns eigenvectors up to sign: compare |n.n_ref|, d up to the
    same sign, and validity. 1e-4 on the normal alignment (eigenvectors of
    near-degenerate 3x3 blocks are ill-conditioned in f32), so only
    well-separated (valid) fits are compared for normals."""
    nb, nmask = _plane_case(3)
    fj = jplane.fit_planes(jnp.asarray(nb), jnp.asarray(nmask), 0.2)
    ft = tplane.fit_planes(_t(nb), _t(nmask), 0.2)
    vj, vt = _n(fj.valid), _n(ft.valid)
    assert (vj == vt).mean() > 0.995  # gates sit on thresholds: a point on the edge may flip
    both = vj & vt
    assert both.sum() > 400 and (~vj).sum() > 100
    dots = np.sum(_n(ft.normal) * _n(fj.normal), axis=1)
    np.testing.assert_allclose(np.abs(dots[both]), 1.0, atol=1e-4)
    np.testing.assert_allclose(
        (_n(ft.d) * np.sign(dots))[both], _n(fj.d)[both], rtol=1e-3, atol=2e-3
    )


# ---------------------------------------------------------------------------
# ops/deskew
# ---------------------------------------------------------------------------

def test_deskew():
    """Cumsum + lerp + one rotation per point: 5e-5 m absolute on points up
    to 60 m out (angle error 1e-6 rad x range)."""
    rng = np.random.default_rng(4)
    K, n = 32, 4096
    times = np.full(K, np.inf, np.float32)
    times[:20] = 0.3 + np.arange(20) * 0.01
    gyro = rng.normal(0, 0.5, (K, 3)).astype(np.float32)
    imask = np.arange(K) < 20
    xyz = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    rel = rng.uniform(0, 0.1, n).astype(np.float32)
    rel[:3] = [0.0, 0.25, 0.1]  # before / beyond the timeline
    mask = rng.uniform(size=n) > 0.1
    start = np.float32(0.31)
    tlj = jdeskew.integrate_gyro(jnp.asarray(times), jnp.asarray(gyro), jnp.asarray(imask))
    tlt = tdeskew.integrate_gyro(_t(times), _t(gyro), _t(imask))
    _close(tlt.angles, tlj.angles, atol=1e-6)
    assert int(tlt.count) == int(tlj.count) == 20
    oj = jdeskew.deskew_scan(jnp.asarray(xyz), jnp.asarray(rel), jnp.asarray(mask), jnp.asarray(start), tlj)
    ot = tdeskew.deskew_scan(_t(xyz), _t(rel), _t(mask), torch.tensor(start), tlt)
    _close(ot, oj, atol=5e-5)
    # empty timeline: every clamp must hold (torch raises on a bad gather)
    empty = tdeskew.integrate_gyro(_t(times), _t(gyro), torch.zeros(K, dtype=torch.bool))
    ot = tdeskew.deskew_scan(_t(xyz), _t(rel), _t(mask), torch.tensor(start), empty)
    _close(ot, xyz, atol=1e-6)


# ---------------------------------------------------------------------------
# imu/preintegration + imu/fusion
# ---------------------------------------------------------------------------

def _imu_case(seed, K=32, n_valid=21):
    rng = np.random.default_rng(seed)
    acc = (rng.normal(0, 0.5, (K, 3)) + [0.3, -0.2, 9.8]).astype(np.float32)
    gyr = rng.normal(0, 0.3, (K, 3)).astype(np.float32)
    dts = np.full(K, 0.005, np.float32)
    dts[3] = 0.0  # duplicate timestamp
    mask = np.arange(K) < n_valid
    mask[7] = False
    ba = np.array([0.02, -0.01, 0.03], np.float32)
    bg = np.array([0.001, 0.002, -0.001], np.float32)
    return acc, gyr, dts, mask, ba, bg


@pytest.mark.parametrize("K,n_valid", [(32, 21), (13, 13)])
def test_preintegrate_parallel_sequential_jax(K, n_valid):
    """parallel (tree) = sequential (oracle) = JAX, to f32 reassociation:
    1e-5 relative on the deltas/Jacobians, 1e-4 on the covariance (a sum of
    ~20 rank-6 terms spanning 1e-10..1e-5)."""
    acc, gyr, dts, mask, ba, bg = _imu_case(5, K, n_valid)
    pj = jpre.preintegrate(*(jnp.asarray(a) for a in (acc, gyr, dts, mask, ba, bg)), jpre.ImuParams())
    args = tuple(_t(a) for a in (acc, gyr, dts, mask, ba, bg))
    pt = tpre.preintegrate(*args, tpre.ImuParams())
    ps = tpre.preintegrate_sequential(*args, tpre.ImuParams())
    for name in pj._fields:
        tol = dict(rtol=1e-4, atol=1e-12) if name == "cov" else dict(rtol=1e-5, atol=2e-7)
        _close(getattr(pt, name), getattr(pj, name), **tol)
        _close(getattr(pt, name), getattr(ps, name), **tol)
    # carried across by convert: identical state in, identical prediction out
    pc = convert.preintegrated_from_arrays({k: np.asarray(v) for k, v in pj._asdict().items()}, device="cpu")
    R0 = np.asarray(jse3.euler_to_rot(jnp.asarray([0.1, -0.2, 0.3], jnp.float32)))
    sj = jpre.predict(
        jpre.NavState(jnp.asarray(R0), jnp.ones(3), jnp.full(3, 0.5)), pj,
        jnp.asarray(ba), jnp.asarray(bg), jpre.ImuParams(),
    )
    st = tpre.predict(
        tpre.NavState(_t(R0), torch.ones(3), torch.full((3,), 0.5)), pc,
        _t(ba), _t(bg), tpre.ImuParams(),
    )
    for a, b in zip(st, sj):
        _close(a, b, atol=1e-6)


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    return type(x)(*(_f64(v) for v in x))


def test_fusion_step_and_predict_poses():
    """One lidar correction from identical filter state (carried across by
    convert). QR factors differ in sign between LAPACK front ends, so the
    solved state is compared, not Q/R: mean to 1e-5, the marginal information
    W^T W to 2e-3 of its largest entry (the Schur complement of a Hessian
    whose f32 conditioning is ~1e8; both sides sit ~1e-3 from a float64 run
    of the same code).

    A second correction from that dense prior, fed the same (now
    inconsistent) preintegration, is much worse conditioned: there the port
    is held to its own float64 run (1e-4) and JAX is only required to be as
    close to it as its f32 solve gets (1e-2; measured 6e-3 in v)."""
    acc, gyr, dts, mask, ba, bg = _imu_case(6)
    params_j, params_t = jfusion.FusionParams(), tfusion.FusionParams()
    R0 = np.asarray(jse3.euler_to_rot(jnp.asarray([0.02, -0.01, 0.4], jnp.float32)))
    p0 = np.array([1.0, 2.0, 0.1], np.float32)
    fj = jfusion.init_filter(jnp.asarray(R0), jnp.asarray(p0), params_j)
    fj = fj._replace(mean=fj.mean._replace(v=jnp.asarray([2.0, 0.1, 0.0], jnp.float32)))
    ft = convert.fusion_filter_from_arrays(
        {k: np.asarray(v) for k, v in fj.mean._asdict().items()}, np.asarray(fj.sqrt_info),
        device="cpu",
    )
    z = np.zeros(3, np.float32)
    pj = jpre.preintegrate(*(jnp.asarray(a) for a in (acc, gyr, dts, mask, z, z)), params_j.imu)
    pt = convert.preintegrated_from_arrays({k: np.asarray(v) for k, v in pj._asdict().items()}, device="cpu")
    lid_R = np.asarray(jse3.euler_to_rot(jnp.asarray([0.021, -0.012, 0.405], jnp.float32)))
    lid_p = np.array([1.21, 2.02, 0.1], np.float32)
    no = torch.tensor(False)

    sj = jfusion.fusion_step(fj, pj, jnp.asarray(lid_R), jnp.asarray(lid_p), jnp.asarray(False), params_j)
    st = tfusion.fusion_step(ft, pt, _t(lid_R), _t(lid_p), no, params_t)
    assert bool(st.diverged) == bool(sj.diverged) is False
    for a, b in zip(st.filter.mean, sj.filter.mean):
        _close(a, b, atol=1e-5)
    Wt, Wj = _n(st.filter.sqrt_info), _n(sj.filter.sqrt_info)
    It, Ij = Wt.T @ Wt, Wj.T @ Wj
    assert np.abs(It - Ij).max() <= 2e-3 * np.abs(Ij).max()

    s2j = jfusion.fusion_step(sj.filter, pj, jnp.asarray(lid_R), jnp.asarray(lid_p), jnp.asarray(False), params_j)
    s2t = tfusion.fusion_step(st.filter, pt, _t(lid_R), _t(lid_p), no, params_t)
    s64 = tfusion.fusion_step(_f64(st.filter), _f64(pt), _t(lid_R).double(), _t(lid_p).double(), no, params_t)
    for a, b, c in zip(s2t.filter.mean, s2j.filter.mean, s64.filter.mean):
        _close(a, c, atol=1e-4)
        _close(b, c, atol=1e-2)

    # a degenerate scan match widens the lidar prior; a diverged state is flagged
    sdj = jfusion.fusion_step(fj, pj, jnp.asarray(lid_R), jnp.asarray(lid_p), jnp.asarray(True), params_j)
    sdt = tfusion.fusion_step(ft, pt, _t(lid_R), _t(lid_p), torch.tensor(True), params_t)
    for a, b in zip(sdt.filter.mean, sdj.filter.mean):
        _close(a, b, atol=1e-5)
    far = lid_p + np.array([10.0, 0, 0], np.float32)  # 10 m in 0.1 s: > 30 m/s
    assert bool(tfusion.fusion_step(ft, pt, _t(lid_R), _t(far), no, params_t).diverged)
    assert bool(jfusion.fusion_step(fj, pj, jnp.asarray(lid_R), jnp.asarray(far), jnp.asarray(False), params_j).diverged)

    Rj, pjs = jfusion.predict_poses(sj.filter.mean, *(jnp.asarray(a) for a in (acc, gyr, dts, mask)))
    Rt, pts = tfusion.predict_poses(st.filter.mean, *(_t(a) for a in (acc, gyr, dts, mask)))
    _close(Rt, Rj, atol=1e-5)
    _close(pts, pjs, atol=1e-4)


# ---------------------------------------------------------------------------
# ops/scancontext
# ---------------------------------------------------------------------------

def test_scancontext_descriptor_and_detect():
    rng = np.random.default_rng(7)
    n = 4096
    xyz = rng.uniform(-90, 90, (n, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(-2, 6, n)
    mask = rng.uniform(size=n) > 0.1
    dj = jsc.make_descriptor(jnp.asarray(xyz), jnp.asarray(mask))
    dt = tsc.make_descriptor(_t(xyz), _t(mask))
    # a max over bins: exact unless a point sits on a bin edge
    assert (np.abs(_n(dt) - _n(dj)) > 0).mean() < 0.01
    _close(tsc.ring_key(dt), jsc.ring_key(jnp.asarray(_n(dt))), rtol=1e-6)  # a mean of 60

    # database of 48 descriptors; entry 5 is the query rotated by 7 sectors
    C = 64
    descs = np.maximum(rng.normal(1.0, 1.0, (C, 20, 60)), 0).astype(np.float32)
    descs[:, :, ::7] = 0.0
    query = np.roll(descs[5], 7, axis=1) + rng.normal(0, 0.01, (20, 60)).astype(np.float32) * (descs[5] > 0)
    query = query.astype(np.float32)
    descs[40] = descs[5]  # an exact duplicate inside the excluded tail
    keys = descs.mean(-1)
    qkey = query.mean(-1)
    for count, expect in ((48, 5), (20, -1)):
        detj = jsc.detect_loop(
            jnp.asarray(descs), jnp.asarray(keys), jnp.asarray(count, jnp.int32),
            jnp.asarray(query), jnp.asarray(qkey),
        )
        dett = tsc.detect_loop(_t(descs), _t(keys), count, _t(query), _t(qkey))
        assert int(dett.index) == int(detj.index) == expect
        _close(dett.yaw, detj.yaw, atol=1e-6)
        if expect >= 0:
            _close(dett.distance, detj.distance, atol=1e-5)
    # ties in the ring-key ranking: the lower index comes first
    assert tsc._smallest_k(torch.tensor([2.0, 1.0, 1.0, 3.0, 1.0]), 2).tolist() == [1, 2]


# ---------------------------------------------------------------------------
# graph/pose_graph
# ---------------------------------------------------------------------------

def _graph_arrays(seed, K=16, E=32, G=4):
    """A noisy chain of 12 nodes on an arc + one loop edge + two GPS fixes."""
    rng = np.random.default_rng(seed)
    k = 12
    gt = np.zeros((k, 6))
    gt[:, 2] = np.linspace(0, 1.5, k)
    gt[:, 3] = 10 * np.sin(gt[:, 2])
    gt[:, 4] = 10 * (1 - np.cos(gt[:, 2]))
    est = gt + rng.normal(0, 0.05, gt.shape) * [0.2, 0.2, 1, 1, 1, 0.2]
    est[0] = gt[0]
    a = dict(
        Rs=np.tile(np.eye(3, dtype=np.float32), (K, 1, 1)), ts=np.zeros((K, 3), np.float32),
        node_mask=np.arange(K) < k,
        e_i=np.zeros(E, np.int32), e_j=np.zeros(E, np.int32),
        e_Rm=np.tile(np.eye(3, dtype=np.float32), (E, 1, 1)), e_tm=np.zeros((E, 3), np.float32),
        e_sqrt_info=np.ones((E, 6), np.float32), e_cauchy=np.zeros(E, np.float32),
        e_mask=np.zeros(E, bool),
        g_i=np.zeros(G, np.int32), g_t=np.zeros((G, 3), np.float32),
        g_sqrt_info=np.ones((G, 3), np.float32), g_mask=np.zeros(G, bool),
    )
    a["Rs"][:k] = se3np.euler_to_rot(est[:, :3])
    a["ts"][:k] = est[:, 3:]
    edges = [(i, i + 1, 0.0) for i in range(k - 1)] + [(1, k - 1, 1.0)]
    for n, (i, j, c) in enumerate(edges):
        rel = se3np.pose_between(gt[i], gt[j]) + rng.normal(0, 0.01, 6)
        a["e_i"][n], a["e_j"][n] = i, j
        a["e_Rm"][n] = se3np.euler_to_rot(rel[:3])
        a["e_tm"][n] = rel[3:]
        a["e_sqrt_info"][n] = 1.0 / np.array([1e-2] * 3 + [5e-2] * 3)
        a["e_cauchy"][n] = c
        a["e_mask"][n] = True
    for n, i in enumerate((6, 11)):
        a["g_i"][n] = i
        a["g_t"][n] = gt[i, 3:] + rng.normal(0, 0.05, 3)
        a["g_mask"][n] = True
    a["prior_R"] = a["Rs"][0].copy()
    a["prior_t"] = a["ts"][0].copy()
    return a, gt


@pytest.mark.parametrize("free_from", [0, 8])
def test_pose_graph_solve(free_from):
    """Chain + Cauchy loop + GPS, full and trailing-window solves. PCG in f32
    is an iteration whose rounding differs between the libraries: solved
    poses to 2e-4 (m, rad-ish), error to 1e-3 relative."""
    arrays, gt = _graph_arrays(8)
    gj = jpg.empty_graph(16, 32, 4)._replace(**{k: jnp.asarray(v) for k, v in arrays.items()})
    gt_ = convert.pose_graph_from_arrays({k: np.asarray(v) for k, v in gj._asdict().items()}, device="cpu")
    _close(tpg.graph_error(gt_), jpg.graph_error(gj), rtol=1e-4)
    params = dict(gn_iters=4, pcg_iters=48)
    sj = jpg.solve(gj, free_from=jnp.asarray(free_from, jnp.int32), params=jpg.SolveParams(**params))
    st = tpg.solve(gt_, free_from=free_from, params=tpg.SolveParams(**params))
    _close(st.Rs, sj.Rs, atol=2e-4)
    _close(st.ts, sj.ts, atol=2e-4)
    ej, et = float(jpg.graph_error(sj)), float(tpg.graph_error(st))
    assert abs(et - ej) <= 1e-3 * ej + 1e-6
    assert et < (0.5 if free_from == 0 else 0.9) * float(tpg.graph_error(gt_))
    np.testing.assert_array_equal(_n(st.Rs[:free_from]), arrays["Rs"][:free_from])


# ---------------------------------------------------------------------------
# mapping/keyframes
# ---------------------------------------------------------------------------

def test_assemble_local_map_and_store():
    """Selection (radius, density cells, recency, near_cap) and the fused
    voxel map: keys and masks exact, points to 1e-4 m (rotation + centroid
    reassociation)."""
    rng = np.random.default_rng(9)
    K, C = 32, 256
    count = 20
    store_j = jkf.KeyframeStore(cloud_capacity=C, initial_kf_capacity=8)
    store_t = tkf.KeyframeStore(cloud_capacity=C, initial_kf_capacity=8, device="cpu")
    for i in range(count):
        pose = np.array([0.01 * i, -0.01, 0.1 * i, 0.7 * i, 0.2 * np.sin(i), 0.0], np.float32)
        n_pts = 300 if i == 3 else 200  # one cloud overflows the capacity
        cloud = rng.uniform(-8, 8, (n_pts, 3)).astype(np.float32)
        cloud[:, 2] = rng.normal(0, 0.05, n_pts)
        cmask = rng.uniform(size=n_pts) > 0.1
        desc = rng.uniform(size=(20, 60)).astype(np.float32)
        for s in (store_j, store_t):
            if i == 10:
                s.device_arrays()  # later appends take the in-place row path
            s.append(pose, 100.0 + 0.5 * i, cloud, cmask, desc, desc.mean(-1))
    assert store_t.kf_cap == store_j.kf_cap == 32
    dj, dt = store_j.device_arrays(), store_t.device_arrays()
    for name in dj:
        np.testing.assert_array_equal(_n(dt[name]), _n(dj[name]))
    times = (store_t.times - 100.0).astype(np.float32)
    center = np.array([9.0, 0.0, 0.0], np.float32)
    kw = dict(radius=6.0, recent_seconds=1.2, near_cap=8, map_cap=2048, leaf=0.4, cell_size=1.0, density=2.0)
    gj = jkf.assemble_local_map(
        dj["poses"], dj["clouds"], dj["cloud_masks"], jnp.asarray(times),
        jnp.asarray(count, jnp.int32), jnp.asarray(center), jnp.asarray(np.float32(9.6)), **kw
    )
    gt = tkf.assemble_local_map(
        dt["poses"], dt["clouds"], dt["cloud_masks"], _t(times), count, _t(center), 9.6, **kw
    )
    np.testing.assert_array_equal(_n(gt.mask), _n(gj.mask))
    assert 500 < int(gt.mask.sum()) < 2048
    # a centroid within rounding of a voxel face may land in the next cell
    assert (_n(gt.keys) == _n(gj.keys)).mean() > 0.999
    same = _n(gt.keys) == _n(gj.keys)
    _close(_n(gt.xyz)[same], _n(gj.xyz)[same], atol=1e-4)
    # convert carries the JAX store and grid across unchanged
    store_c = convert.keyframe_store_from_arrays(
        {n: getattr(store_j, n) for n in ("poses", "times", "clouds", "cloud_masks", "sc_descs", "sc_keys")},
        store_j.count, device="cpu",
    )
    assert store_c.count == count and store_c.kf_cap == store_j.kf_cap
    for name, arr in store_c.device_arrays().items():
        np.testing.assert_array_equal(_n(arr), _n(dj[name]))
    gc = convert.grid_from_arrays({k: np.asarray(v) for k, v in gj._asdict().items()}, device="cpu")
    np.testing.assert_array_equal(_n(gc.keys), _n(gj.keys))
    xs, ms = tkf.subsample_to_cap(_t(np.asarray(dj["clouds"][3])), _t(np.asarray(dj["cloud_masks"][3])), 100)
    xj, mj = jkf.subsample_to_cap(dj["clouds"][3], dj["cloud_masks"][3], 100)
    np.testing.assert_array_equal(_n(xs), _n(xj))
    np.testing.assert_array_equal(_n(ms), _n(mj))


# ---------------------------------------------------------------------------
# ops/icp
# ---------------------------------------------------------------------------

def test_icp_point2point():
    """1024 source points onto a 2048-point target after a known offset.
    The two sides find 1-NN with different d2 forms (expansion vs direct
    differences), so a near-tie may pick another neighbour for a few points:
    pose to 2e-3, both within 2 cm / 5 mrad of the true offset."""
    rng = np.random.default_rng(10)
    tgt = rng.uniform(-15, 15, (2048, 3)).astype(np.float32)
    tgt[:700, 2] = 0.0
    tgt[700:1400, 0] = 15.0
    tgt[1400:, 1] = -15.0
    true = np.array([0.01, -0.02, 0.05, 0.4, -0.3, 0.1])
    src_world = tgt[rng.permutation(2048)[:1024]] + rng.normal(0, 0.01, (1024, 3))
    src = se3np.pose_apply(se3np.pose_inverse(true), src_world).astype(np.float32)
    smask = rng.uniform(size=1024) > 0.05
    tmask = rng.uniform(size=2048) > 0.02
    init = np.zeros(6, np.float32)
    rj = jicp.icp_point2point(
        jnp.asarray(src), jnp.asarray(smask), jnp.asarray(tgt), jnp.asarray(tmask),
        jnp.asarray(init), jicp.ICPParams(max_iters=30, max_corr_dist=30.0),
    )
    rt = ticp.icp_point2point(
        _t(src), _t(smask), _t(tgt), _t(tmask), _t(init),
        ticp.ICPParams(max_iters=30, max_corr_dist=30.0),
    )
    _close(rt.pose, rj.pose, atol=2e-3)
    assert np.abs(_n(rt.pose)[3:] - true[3:]).max() < 0.02
    assert np.abs(_n(rt.pose)[:3] - true[:3]).max() < 5e-3
    assert bool(rt.converged) and bool(rj.converged)
    _close(rt.fitness, rj.fitness, rtol=0.05, atol=1e-5)
    _close(rt.inlier_frac, rj.inlier_frac, atol=5e-3)
    assert 1 <= int(rt.iters) <= 30
