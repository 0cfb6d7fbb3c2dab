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


# ---------------------------------------------------------------------------
# the kernels' schedules, spelled in numpy: the deskew's prefix on one warp
# (a window of up to 64 samples, csrc/deskew.cu::timeline_warp) or on the
# block (a longer one, ::timeline_block), and the descriptor's merge of
# blocks' bins (csrc/scancontext.cu)
# ---------------------------------------------------------------------------

def _warp_prefix(x, Kc=None):
    """The inclusive prefix of x [K, 3] (float64, K <= 64) as the kernel's
    warp takes it: lane t holds samples t and t + 32 (slots 0 and 1); step
    d < 32 adds lane (t - d) mod 32's slot j where t >= d, else its slot
    j - 1 (no add to slot 0); step d = 32 adds the lane's own slot 0 to its
    slot 1; every term the step's old value; the steps while d < Kc (the
    window's last valid sample + 1, K when not given)."""
    K = x.shape[0]
    assert K <= 64
    Kc = K if Kc is None else Kc
    slots = np.zeros((64, 3))
    slots[:K] = x
    slots = slots.reshape(2, 32, 3).transpose(1, 0, 2)  # [lane, j, 3]
    lane = np.arange(32)[:, None, None]
    col = np.arange(2)[None, :, None]
    d = 1
    while d < 32 and d < Kc:
        term = slots[(np.arange(32) - d) % 32]  # the shuffle from lane (t - d) mod 32
        before = np.concatenate([np.zeros((32, 1, 3)), term[:, :-1]], 1)  # its slot j - 1
        slots = np.where(lane >= d, slots + term, np.where(col > 0, slots + before, slots))
        d *= 2
    if 32 < Kc:
        slots[:, 1] = slots[:, 1] + slots[:, 0]
    return slots.transpose(1, 0, 2).reshape(64, 3)[:K]


def _block_prefix(x, Kc):
    """The inclusive prefix of the first Kc samples of x [K, 3] (float64) as
    the kernel's block takes a longer window: the 3 Kc doubles of the
    window through its last valid sample in one buffer, step d (while
    d < Kc) writing element j of the other buffer as j >= 3 d ? x[j] +
    x[j - 3 d] : x[j], every term the step's old value."""
    src = x[:Kc].reshape(-1).copy()
    d = 1
    while d < Kc:
        dst = src.copy()
        dst[3 * d:] = src[3 * d:] + src[:-3 * d]
        src = dst
        d *= 2
    return src.reshape(Kc, 3)


def _doubling_prefix(x):
    """ops/deskew.py::integrate_gyro's Hillis-Steele doubling in numpy."""
    K, d = x.shape[0], 1
    while d < K:
        x = np.concatenate([x[:d], x[d:] + x[:-d]])
        d *= 2
    return x


def _window_ids(p):
    return f"K{p[0]}-tail{p[1]}"


# windows of K samples and a masked tail: the warp's (K <= 64, the file's
# CASES) and the block's (past 64)
WARP_WINDOWS = [(k, t) for k in (1, 13, 32, 64) for t in (0, k // 3)]
BLOCK_WINDOWS = [(k, t) for k in (256, 300, 2048) for t in (0, k // 3)]


@pytest.fixture(scope="module")
def gyro_window(request):
    """A seeded window of K samples (every tenth masked out and a masked tail
    of the given length, magnitudes over twelve decades so that another
    order of the sums rounds otherwise), its increments in float64, as
    integrate_gyro forms them, the plain version's doubling of them, its
    angles, and Kc (the last valid sample + 1, at least 1)."""
    K, tail = request.param
    rng = np.random.default_rng(K)
    times = (0.3 + 0.005 * np.arange(K)).astype(np.float32)
    gyro = (rng.normal(0, 1, (K, 3)) * 10.0 ** rng.uniform(-6, 6, (K, 3))).astype(np.float32)
    imask = (np.arange(K) % 10 != 9) & (np.arange(K) < K - tail)
    dt = np.diff(times, prepend=times[:1])
    dt = np.where(imask & np.r_[False, imask[:-1]], dt, np.float32(0))
    inc = np.where(imask[:, None], gyro * dt[:, None], np.float32(0)).astype(np.float64)
    angles = tdeskew.integrate_gyro(_t(times), _t(gyro), _t(imask)).angles.numpy()
    Kc = max(int(np.flatnonzero(imask).max(initial=-1)) + 1, 1)
    return inc, _doubling_prefix(inc), angles, Kc


def _same_prefix(got, want, angles):
    """Bit for bit in float64 (signed zeros too), and rounded to float32
    integrate_gyro's angles, over got's samples."""
    n = len(got)
    np.testing.assert_array_equal(got.view(np.int64), want[:n].view(np.int64))
    np.testing.assert_array_equal(got.astype(np.float32).view(np.int32), angles[:n].view(np.int32))


@pytest.mark.parametrize("gyro_window", WARP_WINDOWS, indirect=True, ids=_window_ids)
def test_deskew_warp_prefix_is_the_plain_versions(gyro_window):
    """The kernel's prefix schedule on one warp (a window of up to 64
    samples) gives the plain version's doubling bit for bit, so its float32
    rounding is integrate_gyro's angles; cut where the last valid sample is
    covered (the kernel's steps while d < Kc), the same through that sample,
    the only angles interp_rotation reads."""
    inc, want, angles, Kc = gyro_window
    if Kc > 12:  # the data tells the doubling from a left-to-right sum
        assert not np.array_equal(np.cumsum(inc[:Kc], 0), want[:Kc])
    _same_prefix(_warp_prefix(inc), want, angles)
    _same_prefix(_warp_prefix(inc, Kc)[:Kc], want, angles)


@pytest.mark.parametrize("gyro_window", BLOCK_WINDOWS, indirect=True, ids=_window_ids)
def test_deskew_block_prefix_is_the_plain_versions(gyro_window):
    """A window past 64 samples on the whole block, its doubling over the
    samples through the last valid one (steps while d < Kc, a barrier a
    step): the plain version's prefix there bit for bit, and its angles;
    uncut (Kc = K), the whole prefix."""
    inc, want, angles, Kc = gyro_window
    if Kc > 12:  # the data tells the doubling from a left-to-right sum
        assert not np.array_equal(np.cumsum(inc[:Kc], 0), want[:Kc])
    _same_prefix(_block_prefix(inc, Kc), want, angles)
    _same_prefix(_block_prefix(inc, len(inc)), want, angles)


def _keys(h):
    """csrc/scancontext.cu::key of float32 heights (a NaN as +inf)."""
    u = np.where(np.isnan(h), np.float32(np.inf), h).astype(np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _unkeys(k):
    return np.where(k & 0x80000000, k & 0x7FFFFFFF, ~k).astype(np.uint32).view(np.float32)


def _merged_descriptor(xyz, mask, blocks):
    """The kernel's merge spelled in numpy on one lane: each block of point
    indices (any split) takes its points' keys into its shared bins by a max
    (csrc/scancontext.cu's bins and keys, an atomic max a point), the
    blocks' bins merge into the lane's by a max (global atomics), and an
    empty or non-finite bin reads 0."""
    flat, height = tsc.descriptor_bins(_t(xyz)[None], _t(mask)[None])
    flat, height = flat.numpy(), height.numpy()
    empty = _keys(np.array([-np.inf], np.float32))[0]
    lane = np.full(tsc.BINS - 1, empty, np.uint32)
    for idx in blocks:
        shared = np.full(tsc.BINS - 1, empty, np.uint32)
        pts = idx[flat[idx] != tsc.BINS - 1]  # masked out or beyond 80 m
        np.maximum.at(shared, flat[pts], _keys(height[pts]))
        lane = np.maximum(lane, shared)
    out = _unkeys(lane)
    return np.where(np.isfinite(out), out, np.float32(0)).reshape(tsc.NUM_RING, tsc.NUM_SECTOR)


def _with_non_finite(xyz, mask):
    xyz, mask = xyz.copy(), mask.copy()
    xyz[:5] = [[3, 1, np.nan], [20, 5, np.inf], [40, -3, -np.inf], [0, 0, 1], [8, 0, 2]]
    mask[:5] = True
    return xyz, mask


@pytest.fixture(scope="module")
def split_cloud():
    xyz, mask = _with_non_finite(*_cloud(11, 3000))
    return xyz, mask, tsc.make_descriptor_plain(_t(xyz)[None], _t(mask)[None])[0].numpy()


@pytest.mark.parametrize("split", ["one_block", "blocks_of_256", "random_blocks", "strided"])
def test_descriptor_merged_over_any_split_of_blocks(split_cloud, split):
    """A max is exact: the blocks' bins merged by a max, however the points
    are split into blocks, give make_descriptor_plain's bits."""
    xyz, mask, want = split_cloud
    n = len(mask)
    rng = np.random.default_rng(5)
    blocks = {
        "one_block": [np.arange(n)],
        "blocks_of_256": np.array_split(np.arange(n), range(256, n, 256)),
        "random_blocks": np.array_split(rng.permutation(n), np.sort(rng.choice(n, 40, False))),
        "strided": [np.arange(b, n, 7) for b in range(7)],
    }[split]
    got = _merged_descriptor(xyz, mask, blocks)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_descriptor_every_point_in_one_bin():
    """Every point in one bin (every point's atomic on one shared word, every
    block's on one word of the lane's scratch): the bin holds the largest
    height + 2, every other bin 0; as the JAX package's, and as the merged
    blocks'."""
    rng = np.random.default_rng(3)
    n = 4000
    r = rng.uniform(10.5, 11.5, n)
    th = np.deg2rad(rng.uniform(1.0, 5.0, n))
    xyz = np.stack([r * np.cos(th), r * np.sin(th), rng.uniform(-2, 6, n)], 1).astype(np.float32)
    mask = np.ones(n, bool)
    mask[::9] = False
    d = tsc.make_descriptor(_t(xyz), _t(mask))
    ring = int(np.ceil(11 / 80 * 20)) - 1
    assert int((d != 0).sum()) == 1
    assert float(d[ring, 0]) == float(np.float32(xyz[mask, 2].max()) + np.float32(2))
    dj = np.asarray(jsc.make_descriptor(jnp.asarray(xyz), jnp.asarray(mask)))
    np.testing.assert_array_equal(d.numpy(), dj)
    blocks = np.array_split(np.arange(n), range(256, n, 256))
    np.testing.assert_array_equal(_merged_descriptor(xyz, mask, blocks), d.numpy())


def test_deskew_kernel_takes_packed_lanes_uncopied():
    """A multistream tick's deskew inputs are slices of its packed frame
    buffer [B, F]: each lane's block contiguous, the lanes F apart. The
    kernel's wrapper hands them on as they are (their lane strides go with
    the addresses), copies a tensor only where a lane's block is not
    contiguous, and a vmap broadcast (lane stride 0) stays uncopied too."""
    B, N, K = 3, 50, 8
    F = 4 * N + 1 + 4 * K + 7
    buf = torch.arange(B * F, dtype=torch.float32).reshape(B, F)
    xyz = buf[:, :3 * N].view(B, N, 3)
    rel = buf[:, 3 * N:4 * N]
    start = buf[:, 4 * N]
    times = buf[:, 4 * N + 1:4 * N + 1 + K]
    gyr = buf[:, 4 * N + 1 + K:4 * N + 1 + 4 * K].view(B, K, 3)
    mask = torch.ones(B, N, dtype=torch.bool)
    imask = torch.ones(1, K, dtype=torch.bool).expand(B, K)
    args = (xyz, rel, mask, start, times, gyr, imask)
    assert not xyz.is_contiguous() and imask.stride(0) == 0
    ins = tdeskew._checked(*args)
    assert all(a is b for a, b in zip(ins, args))
    out = torch.empty(B, N, 3)
    ptrs = tdeskew._addresses(ins, out)
    assert ptrs[8:] == [F, F, N, F, F, F, 0]
    # a lane whose block is not contiguous is copied
    xyz_t = buf[:, :3 * N].view(B, 3, N).transpose(1, 2)
    assert tdeskew._checked(xyz_t, *args[1:])[0].is_contiguous()
