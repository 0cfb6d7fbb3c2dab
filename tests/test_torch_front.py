"""The frame's front end in one call each: the deskew (``ops/deskew.py``) and
the ScanContext descriptor (``ops/scancontext.py``). Their plain versions
against the JAX package's functions on seeded inputs, the edge cases of the
timeline, the vmap rules, and the CPU path taking no kernel. The kernels
against their plain versions on the card are in ``tests/test_torch_gpu.py``.

Bounds, as ``tests/test_torch_ops.py::test_deskew`` and
``::test_scancontext_descriptor_and_detect`` state them: the integrated
angles within 1e-6 rad of JAX's (the port's prefix is a float64 one rounded
once, JAX's a float32 cumsum), the points within 5e-5 m out to 60 m (angle
error 1e-6 rad x range; the port takes sin and cos in float64, JAX in
float32); under 1 % of the descriptor's bins differ (a max over bins is
exact unless a point sits on a bin edge, where two atan2 or sqrt of an ulp
apart fall on either side), the ring key at rtol 1e-6 (a mean of 60). A
vmapped call is one call on the lanes stacked, so its lanes equal single
calls exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liorf_tpu.ops import deskew as jdeskew
from liorf_tpu.ops import scancontext as jsc
from liorf_tpu_torch.ops import deskew as tdeskew
from liorf_tpu_torch.ops import scancontext as tsc

START = np.float32(0.31)
# (K, valid samples, points): test_deskew's recipe (32, 20, 4096), then the
# windows K = 1, 13, 64 and 256 over point counts that are not multiples of 256
CASES = [(32, 20, 4096), (1, 1, 1000), (13, 13, 3001), (64, 24, 4097), (256, 230, 2500)]


@jax.jit
def _jax_deskew(xyz, rel, mask, start, times, gyro, imask):
    tl = jdeskew.integrate_gyro(times, gyro, imask)
    return tl.angles, tl.count, jdeskew.deskew_scan(xyz, rel, mask, start, tl)


def _deskew_case(K, n_valid, n, seed=4):
    """test_deskew's recipe at K samples (n_valid valid, 10 ms apart) and n
    points: three points timed before, beyond and inside the timeline."""
    rng = np.random.default_rng(seed + K)
    times = np.full(K, np.inf, np.float32)
    times[:n_valid] = 0.3 + np.arange(n_valid) * 0.01
    gyro = rng.normal(0, 0.5, (K, 3)).astype(np.float32)
    imask = np.arange(K) < n_valid
    xyz = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    rel = rng.uniform(0, 0.1, n).astype(np.float32)
    rel[:3] = [-0.05, 0.25 + 0.01 * K, 0.1]
    mask = rng.uniform(size=n) > 0.1
    return xyz, rel, mask, START, times, gyro, imask


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _port(case):
    """The case through the port: the pieces, deskew_frame and the plain
    version on one lane."""
    xyz, rel, mask, start, times, gyro, imask = (_t(a) for a in case)
    tl = tdeskew.integrate_gyro(times, gyro, imask)
    out = tdeskew.deskew_frame(xyz, rel, mask, start, times, gyro, imask)
    plain = tdeskew.deskew_plain(xyz[None], rel[None], mask[None], start.reshape(1), times[None],
                                 gyro[None], imask[None])[0]
    return tl, out, plain


@pytest.fixture(scope="module", params=CASES, ids=[f"K{k}-valid{v}-N{n}" for k, v, n in CASES])
def deskew_case(request):
    case = _deskew_case(*request.param)
    want = _jax_deskew(*(jnp.asarray(a) for a in case))
    return case, [np.asarray(w) for w in want]


def test_deskew_against_jax(deskew_case):
    case, (angles, count, pts) = deskew_case
    tl, out, plain = _port(case)
    np.testing.assert_allclose(tl.angles.numpy(), angles, rtol=0, atol=1e-6)
    assert int(tl.count) == int(count) == int(case[6].sum())
    np.testing.assert_allclose(out.numpy(), pts, rtol=0, atol=5e-5)
    assert torch.equal(out, plain)
    # masked-out points come back as they were
    assert torch.equal(out[~_t(case[2])], _t(case[0])[~_t(case[2])])


def test_deskew_prefix_is_float64_rounded_once(deskew_case):
    """The angles' running sum: a float64 prefix rounded to float32, which on
    the CPU is the sequential float64 sum's (the same bits here)."""
    case, _ = deskew_case
    times, gyro, imask = case[4:]
    with np.errstate(invalid="ignore"):  # inf - inf in the padding, masked below
        dt = np.diff(times, prepend=times[:1])
    dt = np.where(imask & np.r_[False, imask[:-1]], dt, np.float32(0))
    inc = np.where(imask[:, None], gyro * dt[:, None], np.float32(0)).astype(np.float32)
    want = np.cumsum(inc.astype(np.float64), 0).astype(np.float32)
    got = tdeskew.integrate_gyro(_t(times), _t(gyro), _t(imask)).angles.numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("start", [0.1, 0.31, 0.75], ids=["before", "inside", "after"])
def test_deskew_scan_start_outside_the_timeline(start):
    """The scan's start before the first sample or after the last one: every
    clamp of interp_rotation holds, as JAX's."""
    case = list(_deskew_case(32, 20, 1000))
    case[3] = np.float32(start)
    want = np.asarray(_jax_deskew(*(jnp.asarray(a) for a in case))[2])
    _, out, plain = _port(case)
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=5e-5)
    assert torch.equal(out, plain)


def test_deskew_empty_timeline_and_all_masked():
    """No valid sample: every point rotated by the identity, so unchanged; no
    point masked in: every point unchanged."""
    xyz, rel, mask, start, times, gyro, imask = _deskew_case(64, 24, 777)
    out = tdeskew.deskew_frame(_t(xyz), _t(rel), _t(mask), _t(start), _t(times), _t(gyro),
                               torch.zeros(64, dtype=torch.bool))
    assert torch.equal(out, _t(xyz))
    out = tdeskew.deskew_frame(_t(xyz), _t(rel), torch.zeros(777, dtype=torch.bool), _t(start),
                               _t(times), _t(gyro), _t(imask))
    assert torch.equal(out, _t(xyz))


def test_deskew_vmap_is_the_lanes_of_one_call():
    """Four lanes under torch.func.vmap (one call of the op on the stacked
    lanes, as a multistream tick makes it) against four single calls, and
    the batched op itself: exactly equal."""
    cases = [_deskew_case(64, 20 + b, 1000, seed=b) for b in range(4)]
    stacked = [torch.stack([_t(c[i]) for c in cases]) for i in range(7)]
    launches = tdeskew.deskew.launches
    calls = tdeskew.deskew_frame.calls
    got = torch.func.vmap(tdeskew.deskew_frame)(*stacked)
    assert tdeskew.deskew_frame.calls == calls + 1
    batched = tdeskew.deskew(*stacked)
    for b, c in enumerate(cases):
        one = tdeskew.deskew_frame(*(_t(a) for a in c))
        assert torch.equal(got[b], one) and torch.equal(batched[b], one), b
    assert tdeskew.deskew.launches == launches  # the CPU path launches no kernel


def test_deskew_kernel_guard_refuses_a_window_it_cannot_take():
    """The kernel's window lives in shared memory: a longer one raises in the
    wrapper, before anything is built or launched."""
    K = tdeskew.MAX_K + 1
    args = (torch.zeros(1, 8, 3), torch.zeros(1, 8), torch.ones(1, 8, dtype=torch.bool),
            torch.zeros(1), torch.zeros(1, K), torch.zeros(1, K, 3),
            torch.ones(1, K, dtype=torch.bool))
    with pytest.raises(ValueError, match="window"):
        tdeskew._launch(*args)


# ---------------------------------------------------------------------------
# the ScanContext descriptor
# ---------------------------------------------------------------------------

def _cloud(seed, n):
    """test_scancontext_descriptor_and_detect's recipe: points out to 90 m (a
    share beyond the 80 m rim), heights -2..6 m, 10 % masked out."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-90, 90, (n, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(-2, 6, n)
    mask = rng.uniform(size=n) > 0.1
    return xyz, mask


@pytest.mark.parametrize("n", [4096, 1000])
def test_descriptor_against_jax(n):
    xyz, mask = _cloud(7, n)
    dj = np.asarray(jsc.make_descriptor(jnp.asarray(xyz), jnp.asarray(mask)))
    dt = tsc.make_descriptor(_t(xyz), _t(mask))
    assert (np.abs(dt.numpy() - dj) > 0).mean() < 0.01
    np.testing.assert_allclose(tsc.ring_key(dt).numpy(),
                               np.asarray(jsc.ring_key(jnp.asarray(dt.numpy()))), rtol=1e-6)
    assert torch.equal(dt, tsc.make_descriptor_plain(_t(xyz)[None], _t(mask)[None])[0])


def test_descriptor_non_finite_heights_and_empty_bins():
    """A bin that a NaN or +inf height reaches reads 0, as an empty one; a
    -inf height leaves its bin as it was; nothing masked in gives zeros."""
    xyz = np.array([[10.0, 0.5, 1.0], [10.0, 0.6, np.nan], [30.0, 1.0, np.inf],
                    [30.0, 1.1, 0.5], [50.0, 2.0, -np.inf], [50.0, 2.1, -1.0]], np.float32)
    mask = np.ones(6, bool)
    d = tsc.make_descriptor(_t(xyz), _t(mask))
    ring = lambda r: int(np.ceil(r / 80 * 20)) - 1  # noqa: E731
    assert float(d[ring(10.0), 0]) == 0.0  # NaN wins its bin
    assert float(d[ring(30.0), 0]) == 0.0  # +inf wins its bin
    assert float(d[ring(50.0), 0]) == 1.0  # -1 + 2 over -inf
    assert int((d != 0).sum()) == 1
    assert torch.equal(tsc.make_descriptor(_t(xyz), torch.zeros(6, dtype=torch.bool)),
                       torch.zeros(20, 60))


def test_descriptor_vmap_is_the_lanes_of_one_call():
    clouds = [_cloud(s, 2000) for s in range(4)]
    X = torch.stack([_t(c[0]) for c in clouds])
    M = torch.stack([_t(c[1]) for c in clouds])
    launches, calls = tsc.make_descriptor.launches, tsc.make_descriptor.calls
    got = torch.func.vmap(tsc.make_descriptor)(X, M)
    assert tsc.make_descriptor.calls == calls + 1
    batched = tsc.descriptors(X, M)
    for b in range(4):
        one = tsc.make_descriptor(X[b], M[b])
        assert torch.equal(got[b], one) and torch.equal(batched[b], one), b
    assert tsc.make_descriptor.launches == launches  # the CPU path launches no kernel
