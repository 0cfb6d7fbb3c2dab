"""IMU preintegration in one call (``ops/preintegrate.py``): its plain
version against the JAX package's ``preintegrate`` and the port's
sequential oracle (``imu/preintegration.py::preintegrate_sequential``, the
Forster recursion on ``core/se3.py``'s own Rodrigues forms) at K = 13, 32, 64
and 256, an empty window, the vmap rule, and the CPU path taking no kernel;
the window's end (the slots past the last valid sample left out, bit for
bit, signed zeros and non-finite samples included; windows masked in the
middle, empty, valid only in the first or the last slot; lanes of other
ends in one call).
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
NOISE = (1.56e-3, 3.99e-3, 1e-4)  # acc, gyr, integration noise densities
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


# ---------------------------------------------------------------------------
# the window's end: the slots past the last valid sample are left out
# ---------------------------------------------------------------------------

def _bits(x, y):
    """Equal to the bit: values, signs of zeros, NaN where the other is NaN."""
    same = (x == y) & (torch.signbit(x) == torch.signbit(y))
    return bool((same | (torch.isnan(x) & torch.isnan(y))).all())


def _window(seed, K, last, variant):
    """A window of K slots whose last valid sample is ``last`` (a masked
    sample in the middle), with garbage in the masked slots after it;
    ``signed_zeros``: some valid samples have a = 0, w = 0 and dt = -0.0;
    ``non_finite``: a valid sample's acc is infinite and another's gyr NaN."""
    acc, gyr, dts, mask, ba, bg = _imu_case(seed, K, last + 1)
    rng = np.random.default_rng(seed + 1)
    tail = np.arange(K) > last
    acc[tail] = rng.normal(0, 50, (int(tail.sum()), 3))
    gyr[tail] = rng.normal(0, 50, (int(tail.sum()), 3))
    if last > 7:
        mask[7] = False
    if variant == "signed_zeros":
        for s in range(0, last + 1, 3):
            acc[s], gyr[s] = ba, bg
        dts[1: last + 1: 4] = -0.0
        ba[0], bg[1] = -0.0, 0.0
    elif variant == "non_finite":
        acc[last // 2, 1] = np.inf
        gyr[last, 0] = np.nan
    return acc, gyr, dts, mask, ba, bg


@pytest.mark.parametrize("variant", ["finite", "signed_zeros", "non_finite"])
@pytest.mark.parametrize("K, last", [(64, 9), (64, 0), (64, 63), (130, 70), (300, 200)])
def test_trailing_masked_slots_are_cut_bit_for_bit(K, last, variant):
    """A window padded with masked slots after its last valid sample gives
    the bits of the same window cut to the power of two of its last tile
    that covers that sample: the padding is left out, not composed in (a
    composed identity segment keeps the values but not every sign of a zero,
    and x 0 of an infinite x is NaN)."""
    arrays = [torch.from_numpy(a) for a in _window(K + last, K, last, variant)]
    tile, cover = (int(x) for x in pop.window_cut(arrays[3][None]))
    start, n = pop.TILE * tile, last - pop.TILE * tile + 1  # the last tile, its slots to cover
    assert 0 < n <= cover < 2 * n or cover == n == 1
    cut = start + cover
    got = pop.preintegrate_plain(*(a[None] for a in arrays), *NOISE)
    short = [a[:cut] if a.dim() and a.shape[0] == K else a for a in arrays]
    want = pop.preintegrate_plain(*(a[None] for a in short), *NOISE)
    for name, x, y in zip(pop.FIELDS, got, want):
        assert _bits(x, y), name


@pytest.mark.parametrize("K", [64, 256])
@pytest.mark.parametrize("kind", ["masked_in_the_middle", "all_masked", "only_slot_0",
                                  "only_the_last_slot"])
def test_edge_windows_match_jax_and_the_oracle(K, kind):
    """Windows whose end the kernel finds by its ballot: masked samples in
    the middle, none valid, only slot 0, only slot K - 1; against the JAX
    package at its bounds (as ``test_plain_matches_jax``) and against the
    sequential oracle in float64 at the float32 bound."""
    acc, gyr, dts, mask, ba, bg = _imu_case(40 + K, K, K)
    if kind == "masked_in_the_middle":
        mask[K // 4: K // 2] = False
        mask[K - 5:] = False
    else:
        mask[:] = False
        if kind == "only_slot_0":
            mask[0] = True
        elif kind == "only_the_last_slot":
            mask[K - 1] = True
    arrays = (acc, gyr, dts, mask, ba, bg)
    args = tuple(torch.from_numpy(a) for a in arrays)
    n_valid = int(mask.sum())
    c = dict(K=K, n_valid=max(n_valid, 1))
    got = tpre.preintegrate(*args, tpre.ImuParams())
    jax_out = _jax_preintegrate(*(jnp.asarray(a) for a in arrays), jpre.ImuParams())
    _hold(got, {f: np.asarray(getattr(jax_out, f)) for f in pop.FIELDS}, c)
    seq = tpre.preintegrate_sequential(*(a.double() if a.is_floating_point() else a
                                         for a in args), tpre.ImuParams())
    theta = ((args[1] - args[5]) * torch.where(args[3], args[2], 0.0)[:, None]).double().norm(dim=1)
    leaf = float(torch.minimum(EPS / (2 * theta), theta / 2).max())
    _hold_scaled(got, seq, ROUNDINGS * c["n_valid"] * EPS + 3 * leaf)
    if n_valid == 0:
        assert torch.equal(got.dR, torch.eye(3))


def test_lanes_of_other_window_ends_in_one_call():
    """Lanes whose windows end in other slots and other tiles, in one call:
    each lane has the bits of its own call."""
    ends = (0, 9, 40, 63, 64, 130, 199)
    lanes = [[torch.from_numpy(a) for a in _window(3 + e, 200, e, "signed_zeros")]
             for e in ends]
    stacked = [torch.stack(x) for x in zip(*lanes)]
    got = pop.preintegrate_plain(*stacked, *NOISE)
    for b, one in enumerate(lanes):
        want = pop.preintegrate_plain(*(a[None] for a in one), *NOISE)
        for name, x, y in zip(pop.FIELDS, got, want):
            assert _bits(x[b:b + 1], y), (ends[b], name)


def _old_order(arrays):
    """The same windows with every slot of the last tile composed in (the
    order before the cut): padded with zero slots to whole tiles, the last
    slot made valid with dt = 0, which is the identity segment a masked slot
    is."""
    acc, gyr, dts, mask, ba, bg = arrays
    K = dts.shape[1]
    pad = -(-K // pop.TILE) * pop.TILE - K + 1
    f = torch.nn.functional.pad
    mask = f(mask, (0, pad))
    mask[:, -1] = True
    return f(acc, (0, 0, 0, pad)), f(gyr, (0, 0, 0, pad)), f(dts, (0, pad)), mask, ba, bg


def test_leaving_out_the_trailing_slots_moves_only_signs_of_zeros():
    """Against the order that composed every slot of the last tile in, the
    cut changes no value, only now and then the sign of a zero: 200 seeded
    windows (lanes) of 1 to 130 slots, some with zero rates and
    accelerations, dt = -0.0, rotations about one axis, or garbage in the
    masked slots."""
    rng = np.random.default_rng(16)
    for K in (1, 5, 13, 31, 32, 33, 64, 65, 100, 130):
        B = 20
        acc = (rng.normal(0, 0.5, (B, K, 3)) + [0.3, -0.2, 9.8]).astype(np.float32)
        gyr = rng.normal(0, 0.3, (B, K, 3)).astype(np.float32)
        dts = rng.uniform(0.002, 0.006, (B, K)).astype(np.float32)
        mask = np.zeros((B, K), bool)
        ba = rng.normal(0, 0.02, (B, 3)).astype(np.float32)
        bg = rng.normal(0, 0.002, (B, 3)).astype(np.float32)
        for b in range(B):
            mask[b, :rng.integers(0, K + 1)] = True
            mask[b] &= rng.uniform(size=K) > rng.choice([0.0, 0.1, 0.5])
            kind = b % 4
            if kind == 1:  # signed zeros
                sel = rng.uniform(size=K) < 0.3
                acc[b, sel] = ba[b]
                gyr[b, rng.uniform(size=K) < 0.3] = bg[b]
                dts[b, rng.uniform(size=K) < 0.2] = -0.0
                acc[b, rng.uniform(size=K) < 0.1] = -0.0
            elif kind == 2:  # rotations about z, no acceleration along y
                gyr[b, :, :2] = bg[b, :2]
                acc[b, :, 1] = ba[b, 1]
            elif kind == 3:  # garbage in the masked slots
                acc[b, ~mask[b]] = rng.normal(0, 100, (int((~mask[b]).sum()), 3))
                gyr[b, ~mask[b]] = rng.normal(0, 100, (int((~mask[b]).sum()), 3))
                dts[b, ~mask[b]] = -1.0
        arrays = [torch.from_numpy(x) for x in (acc, gyr, dts, mask, ba, bg)]
        got = pop.preintegrate_plain(*arrays, *NOISE)
        before = pop.preintegrate_plain(*_old_order(arrays), *NOISE)
        for name, x, y in zip(pop.FIELDS, got, before):
            assert bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all()), (K, name)
