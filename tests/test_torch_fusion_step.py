"""The IMU fusion correction in one call (``ops/fusion_step.py``): its
closed-form Jacobian against ``jacfwd``'s (``imu/fusion.py::jacfwd_system``)
in each branch of ``so3_log`` and ``so3_exp``, its plain version against the
JAX package's ``fusion_step``, the ``jacfwd`` oracle and a float64 run, its
vmap rule; and on the card (marker ``gpu``) the kernel against the plain
version bit for bit: at 0, 1 and 4 GN iterations, with a covariance that is
not positive definite, with 1, 8 and 33 lanes in one launch, and on a lane
of mixed magnitudes whose sums round otherwise in another order. Without JAX
on the card:

    python -m pytest tests/test_torch_fusion_step.py -m gpu -q --noconftest
"""

import math

import numpy as np
import pytest
import torch

from liorf_tpu_torch import convert
from liorf_tpu_torch.core import so3_jvp as so3
from liorf_tpu_torch.imu import fusion
from liorf_tpu_torch.imu import preintegration as pre
from liorf_tpu_torch.ops import fusion_step as fs

PARAMS = fusion.FusionParams()
ARG_COV = fs.ARGS.index("cov")
# Closed form against jacfwd: the two differ in the order of their sums (the
# prior rows' 3 products against jacfwd's 15, the IMU rows' whitening), a
# few float32 roundings: 2e-6 of each column's largest entry. Within 1e-2 of
# pi so3_log's axis comes from the symmetric part over (1 - cos) and theta
# from sin ~ 1e-3, so both derivatives carry rounding amplified by 1 / sin:
# 1e-4 (as tests/test_torch_linearize.py).
TOL, TOL_NEAR_PI = 2e-6, 1e-4


def _rot(v):
    """Rodrigues' formula in float64, rounded to float32."""
    v = np.asarray(v, np.float64)
    t = np.linalg.norm(v)
    W = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    if t < 1e-12:
        return (np.eye(3) + W).astype(np.float32)
    R = np.eye(3) + np.sin(t) / t * W + (1 - np.cos(t)) / t**2 * (W @ W)
    return R.astype(np.float32)


def _axis(rng):
    a = rng.normal(size=3)
    return a / np.linalg.norm(a)


def _imu(seed, K=32, n_valid=21):
    """A masked IMU window (a duplicate timestamp, a masked sample), numpy."""
    rng = np.random.default_rng(seed)
    acc = (rng.normal(0, 0.5, (K, 3)) + [0.3, -0.2, 9.8]).astype(np.float32)
    gyr = rng.normal(0, 0.3, (K, 3)).astype(np.float32)
    dts = np.full(K, 0.005, np.float32)
    dts[3] = 0.0
    mask = np.arange(K) < n_valid
    mask[7] = False
    return acc, gyr, dts, mask


def _preint(seed):
    z = torch.zeros(3)
    return pre.preintegrate(*(torch.from_numpy(a) for a in _imu(seed)), z, z, PARAMS.imu)


def _weights(preint, degenerate=False):
    """imu_W, bias_W, corr_W with a lane axis, as the plain version forms them."""
    imu_W = fs.lower_inverse(fs.cholesky(preint.cov[None] + torch.eye(9) * 1e-10))
    sqdt = torch.sqrt(torch.clamp(preint.dt, min=1e-6))
    ip = PARAMS.imu
    bias_W = (1.0 / (torch.tensor([ip.acc_bias_rw] * 3 + [ip.gyr_bias_rw] * 3) * sqdt))[None]
    sig = ([PARAMS.degenerate_sigma] * 6 if degenerate else
           [PARAMS.correction_rot_sigma] * 3 + [PARAMS.correction_trans_sigma] * 3)
    return imu_W, bias_W, (1.0 / torch.tensor(sig))[None]


def _state(R, p, v, ba, bg):
    return fusion.FusionState(*(torch.as_tensor(np.asarray(x, np.float32)) for x in (R, p, v, ba, bg)))


def _lanes(s):
    return tuple(x[None] for x in s)


def _pre_tuple(p):
    return tuple(x[None] for x in (p.dR, p.dv, p.dp, p.dt, p.dR_dbg, p.dv_dba, p.dv_dbg,
                                   p.dp_dba, p.dp_dbg, p.bias_acc_lin, p.bias_gyr_lin))


# each case: the angles of the prior's, the IMU's and the lidar's rotation
# residual, and the size of the gyro-bias rotation dR_dbg @ dbg (0: exactly
# the linearization point)
BRANCHES = {
    "generic": (0.3, 0.2, 0.25, 0.04),
    "identity": (0.0, 0.0, 0.0, 0.0),
    "tiny": (3e-6, 4e-6, 2e-6, 3e-6),
    "near_pi": (math.pi - 4e-3, math.pi - 6e-3, math.pi - 3e-3, 0.04),
    "bias_taylor": (0.3, 0.2, 0.25, 4e-6),
}


def _branch_case(name, seed=3):
    """Two states, a dense prior and a lidar pose whose three rotation
    residuals have the angles of BRANCHES[name]; the gyro bias of state i
    set so that dR_dbg @ (bg_i - bg_lin) has the branch's size."""
    a_prior, a_imu, a_lidar, a_bias = BRANCHES[name]
    rng = np.random.default_rng(seed)
    preint = _preint(seed)
    Ri = _rot(0.7 * rng.normal(size=3))
    # bg_i - bg_lin whose rotation dR_dbg @ dbg has length a_bias
    dRdbg = preint.dR_dbg.double().numpy()
    dbg = np.linalg.solve(dRdbg, a_bias * _axis(rng)) if a_bias else np.zeros(3)
    bg_i = (preint.bias_gyr_lin.double().numpy() + dbg).astype(np.float32)
    dRc = so3.mm(preint.dR[None], so3.so3_exp(so3.mv(preint.dR_dbg[None], torch.from_numpy(
        bg_i - preint.bias_gyr_lin.numpy())[None])))[0].double().numpy()
    Rj = (Ri.astype(np.float64) @ dRc @ _rot(a_imu * _axis(rng))).astype(np.float32)
    si = _state(Ri, rng.normal(size=3), rng.normal(size=3), 0.01 * rng.normal(size=3), bg_i)
    sj = _state(Rj, rng.normal(size=3), rng.normal(size=3), 0.01 * rng.normal(size=3),
                0.01 * rng.normal(size=3))
    prior = _state(Ri.astype(np.float64) @ _rot(a_prior * _axis(rng)).T, rng.normal(size=3),
                   rng.normal(size=3), 0.01 * rng.normal(size=3), 0.01 * rng.normal(size=3))
    lidar_R = torch.from_numpy((Rj.astype(np.float64) @ _rot(a_lidar * _axis(rng)).T)
                               .astype(np.float32))
    L = rng.normal(size=(15, 15)).astype(np.float32)
    W = torch.from_numpy(np.triu(L) + 5 * np.eye(15, dtype=np.float32))
    return si, sj, prior, W, preint, lidar_R, torch.from_numpy(rng.normal(size=3).astype(np.float32))


@pytest.mark.parametrize("name", list(BRANCHES))
def test_jacobian_matches_jacfwd_in_each_branch(name):
    si, sj, prior, W, preint, lidar_R, lidar_p = _branch_case(name)
    imu_W, bias_W, corr_W = _weights(preint)
    want_J, want_r = fusion.jacfwd_system(prior, W, imu_W[0], bias_W[0], corr_W[0], preint,
                                          lidar_R, lidar_p, si, sj, PARAMS)
    J, r = fs.system_plain(_lanes(si), _lanes(sj), _lanes(prior), W[None], imu_W, bias_W, corr_W,
                           _pre_tuple(preint), lidar_R[None], lidar_p[None], PARAMS.imu.gravity)
    tol = TOL_NEAR_PI if name == "near_pi" else TOL
    scale = want_J.abs().amax(0).clamp(min=1e-30)
    assert ((J[0] - want_J).abs() / scale).max() <= tol, name
    assert (r[0] - want_r).abs().max() <= tol * want_r.abs().max(), name
    # every block the branch reaches is there: the IMU rotation rows' bias
    # columns are nonzero wherever the window rotates
    assert want_J[15:24, 12:15].abs().max() > 0


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def _op_args(filt, preint, lidar_R, lidar_p, degenerate):
    m = filt.mean
    return [x[None] for x in (m.R, m.p, m.v, m.ba, m.bg, filt.sqrt_info, preint.dR, preint.dv,
                              preint.dp, preint.dt, preint.dR_dbg, preint.dv_dba, preint.dv_dbg,
                              preint.dp_dba, preint.dp_dbg, preint.cov, preint.bias_acc_lin,
                              preint.bias_gyr_lin, lidar_R, lidar_p, degenerate)]


def _consts(p=PARAMS):
    return (p.imu.acc_bias_rw, p.imu.gyr_bias_rw, p.imu.gravity, p.correction_rot_sigma,
            p.correction_trans_sigma, p.degenerate_sigma, p.max_velocity, p.max_bias, p.gn_iters)


def _plain(filt, preint, lidar_R, lidar_p, degenerate):
    """fusion_step_plain on one lane -> (FusionFilter, diverged)."""
    out = fs.fusion_step_plain(*_op_args(filt, preint, lidar_R, lidar_p, degenerate), *_consts())
    R, p, v, ba, bg, W, div = (o[0] for o in out)
    return fusion.FusionFilter(fusion.FusionState(R, p, v, ba, bg), W), bool(div)


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    return type(x)(*(_f64(v) for v in x))


@pytest.fixture(scope="module")
def jax_case():
    """A first correction and, from its prior, a second (the same, now
    inconsistent, window) through the JAX package; the port's inputs carried
    across by convert."""
    import jax.numpy as jnp
    from liorf_tpu.core import se3 as jse3
    from liorf_tpu.imu import fusion as jfusion
    from liorf_tpu.imu import preintegration as jpre

    pj_params = jfusion.FusionParams()
    acc, gyr, dts, mask = _imu(11)
    R0 = np.asarray(jse3.euler_to_rot(jnp.asarray([0.05, 0.02, -0.7], jnp.float32)))
    fj = jfusion.init_filter(jnp.asarray(R0), jnp.asarray([4.0, -1.0, 0.3], jnp.float32), pj_params)
    fj = fj._replace(mean=fj.mean._replace(v=jnp.asarray([3.0, -0.5, 0.2], jnp.float32)))
    z = np.zeros(3, np.float32)
    pj = jpre.preintegrate(*(jnp.asarray(a) for a in (acc, gyr, dts, mask, z, z)), pj_params.imu)
    lid_R = np.asarray(jse3.euler_to_rot(jnp.asarray([0.052, 0.018, -0.69], jnp.float32)))
    lid_p = np.array([4.33, -1.06, 0.31], np.float32)
    far = lid_p + np.array([0.0, 12.0, 0.0], np.float32)  # 12 m in 0.1 s: > 30 m/s
    runs = {}
    for name, lp, deg in (("first", lid_p, False), ("degenerate", lid_p, True), ("far", far, False)):
        runs[name] = jfusion.fusion_step(fj, pj, jnp.asarray(lid_R), jnp.asarray(lp),
                                         jnp.asarray(deg), pj_params)
    runs["second"] = jfusion.fusion_step(runs["first"].filter, pj, jnp.asarray(lid_R),
                                         jnp.asarray(lid_p), jnp.asarray(False), pj_params)
    out = {k: (tuple(np.asarray(x) for x in v.filter.mean), np.asarray(v.filter.sqrt_info),
               bool(v.diverged)) for k, v in runs.items()}
    ft = convert.fusion_filter_from_arrays(
        {k: np.asarray(v) for k, v in fj.mean._asdict().items()}, np.asarray(fj.sqrt_info),
        device="cpu")
    pt = convert.preintegrated_from_arrays({k: np.asarray(v) for k, v in pj._asdict().items()},
                                           device="cpu")
    return ft, pt, *(torch.from_numpy(a.copy()) for a in (lid_R, lid_p, far)), out


def _info(W):
    W = np.asarray(W, np.float64)
    return W.T @ W


def test_plain_matches_jax_fusion_step(jax_case):
    """The first correction: the mean within 1e-5 of the JAX package's, the
    information within 2e-3 of its largest entry (tests/test_torch_ops.py's
    bounds), and within the same bounds of the port's jacfwd oracle; the
    degenerate scan match's wider lidar prior likewise; a 12 m jump is
    flagged diverged by both."""
    ft, pt, lid_R, lid_p, far, out = jax_case
    no, yes = torch.tensor(False), torch.tensor(True)
    oracle = fusion.fusion_step_jacfwd(ft, pt, lid_R, lid_p, no, PARAMS)
    for name, deg in (("first", no), ("degenerate", yes)):
        got, div = _plain(ft, pt, lid_R, lid_p, deg)
        mean, W, jdiv = out[name]
        assert div is jdiv is False
        for a, b in zip(got.mean, mean):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=0)
        I, Ij = _info(got.sqrt_info), _info(W)
        assert np.abs(I - Ij).max() <= 2e-3 * np.abs(Ij).max(), name
        if name == "first":
            for a, b in zip(got.mean, oracle.filter.mean):
                np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)
            Io = _info(oracle.filter.sqrt_info)
            assert np.abs(I - Io).max() <= 2e-3 * np.abs(Io).max()
    _, div = _plain(ft, pt, lid_R, far, no)
    assert div and out["far"][2]


def test_ill_conditioned_second_correction(jax_case):
    """From a first correction's dense prior, fed the same (now
    inconsistent) window: the float32 step within 1e-4 of its float64 run
    (tests/test_torch_ops.py's bound), from the port's own prior and from
    the JAX package's; from the JAX prior, the JAX package's step within 1e-4
    of the same float64 run. (The two first corrections' priors differ by
    the JAX package's float32 marginalization, ~1 % of the information's
    velocity block, which this step turns into cm of position: the steps are
    compared from one prior.)"""
    ft, pt, lid_R, lid_p, _, out = jax_case
    no = torch.tensor(False)
    own, _ = _plain(ft, pt, lid_R, lid_p, no)
    mean, W, _ = out["first"]
    from_jax = convert.fusion_filter_from_arrays(
        dict(zip(fusion.FusionState._fields, mean)), W, device="cpu")
    for prior in (own, from_jax):
        got, div = _plain(prior, pt, lid_R, lid_p, no)
        ref, _ = _plain(_f64(prior), _f64(pt), lid_R.double(), lid_p.double(), no)
        assert not div
        for a, b in zip(got.mean, ref.mean):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=0)
        I, Iref = _info(got.sqrt_info), _info(ref.sqrt_info)
        assert np.abs(I - Iref).max() <= 2e-3 * np.abs(Iref).max()
    for c, b in zip(out["second"][0], ref.mean):
        np.testing.assert_allclose(c, b.numpy(), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# lanes, failures
# ---------------------------------------------------------------------------

def _lane_inputs(seed, degenerate=False):
    """One seeded lane: a filter, a window, a lidar pose near the prediction."""
    rng = np.random.default_rng(seed)
    preint = _preint(seed)
    R0 = torch.from_numpy(_rot(0.5 * rng.normal(size=3)))
    filt = fusion.init_filter(R0, torch.from_numpy(rng.normal(size=3).astype(np.float32)), PARAMS)
    filt = filt._replace(mean=filt.mean._replace(
        v=torch.from_numpy(rng.normal(size=3).astype(np.float32))))
    nav = pre.predict(pre.NavState(filt.mean.R, filt.mean.p, filt.mean.v), preint,
                      filt.mean.ba, filt.mean.bg, PARAMS.imu)
    lid_R = nav.R @ torch.from_numpy(_rot(0.01 * rng.normal(size=3)))
    lid_p = nav.p + torch.from_numpy(0.05 * rng.normal(size=3).astype(np.float32))
    return _op_args(filt, preint, lid_R, lid_p, torch.tensor(degenerate))


def _stack(lanes):
    return [torch.cat(v) for v in zip(*lanes)]


def _same(x, y):
    """Equal bit for bit, NaN where the other is NaN."""
    return bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all())


def test_vmap_over_lanes_is_lane_by_lane():
    """Under torch.func.vmap (the multistream lane axis) imu/fusion.py's
    fusion_step is one call of the op over the lanes: equal to each lane's
    own call, and counted once."""
    lanes = [_lane_inputs(s, degenerate=s == 2) for s in (1, 2, 3)]
    singles = [fs.fusion_step(*args, *_consts()) for args in lanes]
    stacked = _stack(lanes)  # [3, ...]: vmap's lanes

    def one(R, p, v, ba, bg, W, *rest):
        preint = pre.Preintegrated(*rest[:12])
        step = fusion.fusion_step(
            fusion.FusionFilter(fusion.FusionState(R, p, v, ba, bg), W), preint,
            rest[12], rest[13], rest[14], PARAMS)
        return (*step.filter.mean, step.filter.sqrt_info, step.diverged)

    calls = fusion.fusion_step.calls
    got = torch.func.vmap(one)(*stacked)
    assert fusion.fusion_step.calls == calls + 1
    for k in range(7):
        assert _same(got[k], torch.cat([s[k] for s in singles])), k


def test_not_positive_definite_is_nan_not_an_error():
    """A window covariance that is not positive definite gives NaN whitening
    (no exception, no host sync), and the step is flagged diverged."""
    args = _lane_inputs(4)
    args[ARG_COV] = -args[ARG_COV]
    out = fs.fusion_step(*args, *_consts())
    assert bool(out[-1][0])
    assert torch.isnan(out[5]).all()



# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    # decided here, not at import: every xdist worker must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("seed, degenerate", [(1, False), (2, True), (5, False)])
def test_kernel_is_its_plain_version(dev, seed, degenerate):
    """Bit for bit against the plain version on the card (torch's float64
    sin / cos / atan2 there and the kernel's are CUDA's); one launch, and a
    second launch repeats."""
    args = [t.to(dev) for t in _lane_inputs(seed, degenerate)]
    want = fs.fusion_step_plain(*args, *_consts())
    before = fs.fusion_step.launches
    got = fs.fusion_step(*args, *_consts())
    again = fs.fusion_step(*args, *_consts())
    assert fs.fusion_step.launches == before + 2
    for x, y, z in zip(got, want, again):
        assert _same(x, y) and _same(x, z)


@pytest.mark.gpu
def test_eight_lanes_in_one_launch(dev):
    lanes = [[t.to(dev) for t in _lane_inputs(s, degenerate=s % 3 == 0)] for s in range(8)]
    singles = [fs.fusion_step(*args, *_consts()) for args in lanes]
    before = fs.fusion_step.launches
    got = fs.fusion_step(*_stack(lanes), *_consts())
    assert fs.fusion_step.launches == before + 1
    for k in range(7):
        assert _same(got[k], torch.cat([s[k] for s in singles])), k
    bad = _stack(lanes)
    bad[ARG_COV] = -bad[ARG_COV]
    out = fs.fusion_step(*bad, *_consts())
    assert bool(out[-1].all()) and torch.isnan(out[5]).all()


def _held(got, want):
    return all(_same(x, y) for x, y in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("gn_iters", [0, 1, 4])
def test_kernel_is_its_plain_version_at_each_iteration_count(dev, gn_iters):
    """No GN iteration (the marginalization alone), one, and the default
    four: bit for bit against the plain version on the card."""
    args = [t.to(dev) for t in _lane_inputs(6, degenerate=gn_iters == 1)]
    consts = (*_consts()[:-1], gn_iters)
    assert _held(fs.fusion_step(*args, *consts), fs.fusion_step_plain(*args, *consts))


@pytest.mark.gpu
def test_not_positive_definite_on_the_card(dev):
    """A covariance that is not positive definite: NaN whitening through
    every later step on the card, the divergence flag set, as the plain
    version has them."""
    args = [t.to(dev) for t in _lane_inputs(4)]
    args[ARG_COV] = -args[ARG_COV]
    got = fs.fusion_step(*args, *_consts())
    assert bool(got[-1][0]) and torch.isnan(got[5]).all()
    assert _held(got, fs.fusion_step_plain(*args, *_consts()))


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 8, 33])
def test_lanes_in_one_launch_are_the_plain_version(dev, lanes):
    """1, 8 and 33 lanes (more than a warp's worth of blocks) in one launch,
    every third degenerate: bit for bit against the plain version's own lane
    axis on the card."""
    stacked = _stack([[t.to(dev) for t in _lane_inputs(s, degenerate=s % 3 == 0)]
                      for s in range(lanes)])
    before = fs.fusion_step.launches
    got = fs.fusion_step(*stacked, *_consts())
    assert fs.fusion_step.launches == before + 1
    assert _held(got, fs.fusion_step_plain(*stacked, *_consts()))


def _sequential_sum(x, dim):
    """Left to right from the first term: an order other than tree_sum's."""
    dim = dim % x.dim()
    acc = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


@pytest.mark.gpu
def test_mixed_magnitudes_hold_the_summation_order(dev, monkeypatch):
    """A lane whose prior information rows and window covariance span six
    and four orders of magnitude, so that its sums round differently in
    another order (the plain version with left-to-right sums gives other
    bits): the kernel is still the plain version bit for bit."""
    rng = np.random.default_rng(11)
    args = _lane_inputs(11)
    W = fs.ARGS.index("W")
    args[W] = args[W] * torch.from_numpy(10.0 ** rng.uniform(-3, 3, (1, 15, 1))).float()
    D = torch.from_numpy(10.0 ** rng.uniform(-2, 2, (1, 9, 1))).float()
    args[ARG_COV] = D * args[ARG_COV] * D.transpose(1, 2)
    args = [t.to(dev) for t in args]
    want = fs.fusion_step_plain(*args, *_consts())
    assert _held(fs.fusion_step(*args, *_consts()), want)
    monkeypatch.setattr(fs, "tree_sum", _sequential_sum)
    assert not _held(fs.fusion_step_plain(*args, *_consts()), want)
