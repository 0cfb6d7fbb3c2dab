"""IMU preintegration in one call (``ops/preintegrate.py``): its plain
version against the JAX package's ``preintegrate`` and the port's
sequential oracle (``imu/preintegration.py::preintegrate_sequential``, the
Forster recursion on ``core/se3.py``'s own Rodrigues forms) at K = 13, 32, 64
and 256, an empty window, the vmap rule, and the CPU path taking no kernel.
The kernel against its plain version on the card is in
``tests/test_torch_gpu.py``.

Bounds. Against the JAX package (the same float32 arithmetic): up to K = 64
(13 valid samples of 13, 21 of 32 and of 64 as
``tests/test_torch_ops.py::_imu_case``, and a full window of 64)
``tests/test_torch_ops.py``'s bounds, 1e-5 relative and 2e-7 absolute on the
deltas and Jacobians, 1e-4 and 1e-12 on the covariance. K = 256 (230 valid)
integrates eleven times the samples those bounds were set for, and its
fields grow with the window (dv_dbg ~ T^2): an absolute bound does not scale
with them. Over n samples two forms of the recursion in one precision (the
sequential one against a tree, or two trees) round each sample's
contribution in another order, at most one rounding of the field's scale a
sample, so there each field (each 3 x 3 block of the covariance) is held to
n eps max|field|, eps the unit roundoff, n the valid samples.

Against the oracle, which runs in float64 so that it shares no rounding with
the code under test, a form's own rounding is counted at its worst: a sample
rounds a field's entry at most ROUNDINGS = 19 times (the covariance's
A Q A^T + Q: two 9-term product sums of 9 roundings each, then an add; the
deltas and Jacobians fewer). So the plain version in float64 is held to
2 ROUNDINGS n eps64 max|field| a field (the algorithm, apart from float32;
both sides round), and the plain version in float32 to
(ROUNDINGS n eps32 + 3 e) max|field|, the float32 form's own distance from the
exact recursion. There e is the largest error a sample's leaf puts into Jr:
so3_exp's and Jr's B = (1 - cos theta) / theta^2 in float32 loses up to
eps32 / 2 of cos to the cancellation, eps32 / (2 theta) of Jr's B W term, and
no more than the term itself, theta / 2, when cos rounds to 1; so e = max over
the samples of min(eps32 / (2 theta), theta / 2), theta = |w dt|, and a 3 x 3
product with a rotation sums three such entries.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from liorf_tpu.imu import preintegration as jpre
from liorf_tpu_torch.imu import preintegration as tpre
from liorf_tpu_torch.ops import preintegrate as pop

EPS = 2.0**-24
EPS64 = 2.0**-53
ROUNDINGS = 19  # a form's roundings of a field's entry a sample, at most
CASES = [(13, 13), (32, 21), (64, 21), (64, 64), (256, 230)]  # (K, valid samples)
_jax_preintegrate = jax.jit(jpre.preintegrate, static_argnums=6)  # one program a K


def _imu_case(seed, K, n_valid):
    """``tests/test_torch_ops.py::_imu_case``: a duplicate timestamp (dt = 0)
    and a masked sample inside the valid run, the tail masked."""
    rng = np.random.default_rng(seed)
    acc = (rng.normal(0, 0.5, (K, 3)) + [0.3, -0.2, 9.8]).astype(np.float32)
    gyr = rng.normal(0, 0.3, (K, 3)).astype(np.float32)
    dts = np.full(K, 0.005, np.float32)
    dts[3] = 0.0
    mask = np.arange(K) < n_valid
    mask[7] = False
    ba = np.array([0.02, -0.01, 0.03], np.float32)
    bg = np.array([0.001, 0.002, -0.001], np.float32)
    return acc, gyr, dts, mask, ba, bg


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"K{c[0]}_valid{c[1]}")
def case(request):
    """One window through the JAX package, the plain version (in float32
    and in float64) and the sequential oracle in float64 (each once a
    module)."""
    K, n_valid = request.param
    arrays = _imu_case(5, K, n_valid)
    jax_out = _jax_preintegrate(*(jnp.asarray(a) for a in arrays), jpre.ImuParams())
    args = tuple(torch.from_numpy(a) for a in arrays)
    args64 = tuple(a.double() if a.is_floating_point() else a for a in args)
    acc, gyr, dts, mask, ba, bg = args
    theta = ((gyr - bg) * torch.where(mask, dts, 0.0)[:, None]).double().norm(dim=1)
    return dict(
        K=K, n_valid=n_valid,
        leaf=float(torch.minimum(EPS / (2 * theta), theta / 2).max()),
        jax={f: np.asarray(getattr(jax_out, f)) for f in pop.FIELDS},
        plain=tpre.preintegrate(*args, tpre.ImuParams()),
        plain64=tpre.preintegrate(*args64, tpre.ImuParams()),
        seq=tpre.preintegrate_sequential(*args64, tpre.ImuParams()),
    )


def _blocks(name, x):
    """A field's parts that share a scale: the covariance's 3 x 3 blocks."""
    if name != "cov":
        return [x]
    return [x[3 * i:3 * i + 3, 3 * j:3 * j + 3] for i in range(3) for j in range(3)]


def _fields(got, want):
    for name in pop.FIELDS:
        x = np.asarray(getattr(got, name), np.float64)
        y = np.asarray(want[name] if isinstance(want, dict) else getattr(want, name), np.float64)
        yield name, x, y


def _hold_scaled(got, want, rel):
    """Each field (each 3 x 3 block of the covariance) within rel max|field|."""
    for name, x, y in _fields(got, want):
        for xb, yb in zip(_blocks(name, x), _blocks(name, y)):
            bound = rel * np.abs(yb).max()
            assert np.abs(xb - yb).max() <= bound, (name, np.abs(xb - yb).max(), bound)


def _hold(got, want, c):
    if c["K"] > 64:
        _hold_scaled(got, want, c["n_valid"] * EPS)
        return
    for name, x, y in _fields(got, want):
        tol = dict(rtol=1e-4, atol=1e-12) if name == "cov" else dict(rtol=1e-5, atol=2e-7)
        np.testing.assert_allclose(x, y, err_msg=name, **tol)


def test_plain_matches_jax(case):
    _hold(case["plain"], case["jax"], case)


def test_plain_matches_sequential_oracle(case):
    """The plain version's algorithm, in float64, against the oracle's."""
    assert case["plain64"].cov.dtype == torch.float64
    _hold_scaled(case["plain64"], case["seq"], 2 * ROUNDINGS * case["n_valid"] * EPS64)


def test_plain_float32_is_near_the_exact_recursion(case):
    _hold_scaled(case["plain"], case["seq"], ROUNDINGS * case["n_valid"] * EPS + 3 * case["leaf"])


def test_empty_window_is_the_identity_segment():
    acc, gyr, dts, mask, ba, bg = (torch.from_numpy(a) for a in _imu_case(3, 40, 0))
    out = tpre.preintegrate(acc, gyr, dts, mask, ba, bg, tpre.ImuParams())
    assert torch.equal(out.dR, torch.eye(3))
    for name in pop.FIELDS[1:]:
        assert torch.equal(getattr(out, name), torch.zeros_like(getattr(out, name))), name


def test_vmap_over_lanes_is_one_call_and_lane_by_lane(monkeypatch):
    """Under torch.func.vmap (the multistream lane axis) the lanes are one
    call of the op, each lane bit-equal to its own call."""
    lanes = [tuple(torch.from_numpy(a) for a in _imu_case(s, 64, 18 + s)) for s in (1, 2, 3)]
    singles = [tpre.preintegrate(*args, tpre.ImuParams()) for args in lanes]
    stacked = [torch.stack(x) for x in zip(*lanes)]
    real, plain_calls = pop.preintegrate_plain, []

    def counted(*args):
        plain_calls.append(args[0].shape[0])
        return real(*args)

    monkeypatch.setattr(pop, "preintegrate_plain", counted)
    calls = tpre.preintegrate.calls
    got = torch.func.vmap(lambda *a: tuple(tpre.preintegrate(*a, tpre.ImuParams())))(*stacked)
    assert tpre.preintegrate.calls == calls + 1
    assert plain_calls == [3]
    for k, name in enumerate(tpre.Preintegrated._fields):
        assert torch.equal(got[k], torch.stack([getattr(s, name) for s in singles])), name


def test_cpu_takes_the_plain_version_and_launches_nothing():
    arrays = [torch.from_numpy(a)[None] for a in _imu_case(4, 13, 13)]
    before = pop.preintegrate.launches
    got = pop.preintegrate(*arrays, 3.99e-3, 1.56e-3, 1e-4)
    want = pop.preintegrate_plain(*arrays, 3.99e-3, 1.56e-3, 1e-4)
    assert pop.preintegrate.launches == before
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    with pytest.raises(ValueError):
        pop.preintegrate_plain(*(a[:, :0] for a in arrays[:4]), *arrays[4:], 1.0, 1.0, 1.0)
