"""The voxel filter in one call (``ops/voxel_filter.py``): its compact-key
order against ``numpy.lexsort`` of the cells ``core/voxel.py::_cells``
gives (a city-like cloud with cells on both sides of 0, a valid point at
+-1e6 m, a cloud of no valid point, long runs of one cell, a synthetic
sensor-frame scan, cells near int32's ends, two lanes of other ranges
through ``torch.func.vmap``), its plain version against the CPU route of
``voxel_downsample`` and the JAX package's filter, its vmap rule; on the
card (marker ``gpu``) the kernel against its plain version on a CPU copy,
order and outputs bit for bit, at the scan and map sites, eight lanes, the
widest keys and the edges. Without JAX on the card:

    python -m pytest tests/test_torch_voxel_filter.py -m gpu -q --noconftest
"""

import numpy as np
import pytest
import torch

from liorf_tpu_torch.core import voxel as tvoxel
from liorf_tpu_torch.core.pointcloud import PAD_COORD, PointCloud
from liorf_tpu_torch.ops import voxel_filter as vf

KINDS = ("city", "spike", "all_invalid", "long_runs", "sensor")


def _cloud(kind: str, n: int, seed: int, leaf: float = 0.3):
    """xyz [n, 3] f32, intensity [n] f32, mask [n] bool of one kind, numpy
    from ``seed``: a city-like scan (+-60 m around the sensor, a few metres
    of height, about a fifth of the slots padded), with a valid spike at
    +-1e6 m, with no valid point, or in long runs of one cell; "wide" puts
    valid points near int32's ends at leaf 1.0 (every bit of the key
    varies); "sensor" is a scan of the repo's synthetic city in the sensor's
    frame (32 rings, hundreds of points in the voxels next to the sensor)."""
    rng = np.random.default_rng(seed)
    if kind == "sensor":
        from liorf_tpu_torch.sensors.synthetic import SyntheticConfig, SyntheticDataset

        scan = SyntheticDataset(SyntheticConfig(n_frames=seed + 1, n_rings=32, points_per_ring=900,
                                                seed=seed)).scan(seed)
        k = min(n, len(scan.xyz))
        xyz = np.full((n, 3), PAD_COORD, np.float32)
        xyz[:k] = scan.xyz[:k]
        mask = np.arange(n) < k
        return xyz, rng.uniform(0.0, 1.0, n).astype(np.float32), mask
    xyz = rng.uniform(-60.0, 60.0, (n, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(-2.0, 8.0, n)
    mask = rng.uniform(size=n) > 0.2
    if kind == "spike":
        xyz[n // 3] = [1e6, -1e6, 1e6]
        xyz[n // 2] = [-1e6, 1e6, -1e6]
        mask[[n // 3, n // 2]] = True
    elif kind == "all_invalid":
        mask[:] = False
    elif kind == "long_runs":
        xyz = np.repeat(xyz[: n // 60 + 1] * (leaf / 4), 60, axis=0)[:n]
    elif kind == "wide":
        ends = rng.choice([-2.1e9, -1.5e9, -3.0, 0.5, 1.5e9, 2.1e9], size=(n // 8, 3))
        xyz[: n // 8] = ends
        mask[: n // 8] = True
    xyz[~mask] = PAD_COORD
    inten = rng.uniform(0.0, 1.0, n).astype(np.float32)
    return xyz, inten, mask


def _lexsort_of_cells(xyz, mask, leaf):
    cell = tvoxel._cells(PointCloud(torch.tensor(xyz), torch.zeros(len(mask)),
                                    torch.tensor(mask)), leaf).numpy()
    return cell, np.lexsort((cell[:, 0], cell[:, 1], cell[:, 2], ~mask))


@pytest.mark.parametrize("kind", KINDS)
def test_compact_key_order_is_numpy_lexsort(kind):
    """The plain compact-key order (per-lane min, packing at the widths the
    lane needs, stable sorts by 8-bit digit) is numpy.lexsort((x, y, z,
    ~mask)) of _cells' cells, ties in input order."""
    xyz, _, mask = _cloud(kind, 4000, KINDS.index(kind))
    cell, want = _lexsort_of_cells(xyz, mask, 0.3)
    got = vf.filter_order_plain(torch.tensor(cell)[None], torch.tensor(mask)[None])[0]
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "city":
        assert (cell[mask] < 0).any() and (cell[mask] > 0).any()
    if kind == "spike":
        # 32-bit fields: each axis spans ~6.7e6 cells
        digits = vf.key_digits(torch.tensor(cell)[None], torch.tensor(mask)[None])
        assert int((digits[:, 0] != digits[:, 0, :1]).any(-1).sum()) >= 9


def test_widest_keys_are_numpy_lexsort():
    """Cells near int32's ends (leaf 1.0, +-2.1e9 m): 97 bits vary, all 13
    digits."""
    xyz, _, mask = _cloud("wide", 4000, 5)
    cell, want = _lexsort_of_cells(xyz, mask, 1.0)
    assert cell[mask].min() < -2**30 and cell[mask].max() > 2**30
    digits = vf.key_digits(torch.tensor(cell)[None], torch.tensor(mask)[None])
    assert bool((digits[:, 0] != digits[:, 0, :1]).any(-1).all())
    got = vf.filter_order_plain(torch.tensor(cell)[None], torch.tensor(mask)[None])[0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_lanes_of_other_ranges_through_vmap():
    """Two lanes whose cells span other ranges (other widths, other
    minima): the order of the stacked call, and of the op under
    torch.func.vmap, is each lane's numpy.lexsort; the filter's outputs each
    lane's CPU route."""
    a, b = _cloud("city", 3000, 11), _cloud("spike", 3000, 12)
    b[0][b[2]] *= 3.0
    cells, wants = zip(*(_lexsort_of_cells(c[0], c[2], 0.3) for c in (a, b)))
    got = vf.filter_order_plain(torch.tensor(np.stack(cells)), torch.tensor(np.stack([a[2], b[2]])))
    for lane, want in enumerate(wants):
        np.testing.assert_array_equal(got[lane].numpy(), want)
    xyz, inten, mask = (torch.tensor(np.stack(t)) for t in zip(a, b))
    batched = torch.func.vmap(lambda x, i, m: tuple(
        t[0] for t in vf._voxel_filter_op(x[None], i[None], m[None], 0.3, 1500)))(xyz, inten, mask)
    for lane in range(2):
        alone = tvoxel.voxel_downsample(PointCloud(xyz[lane], inten[lane], mask[lane]), 0.3, 1500)
        for g, w in zip(batched, (*alone.cloud, alone.rep_idx)):
            assert torch.equal(g[lane], w)
        assert 0 < int(alone.cloud.mask.sum()) <= 1500


@pytest.mark.parametrize("kind, out_cap", [("city", None), ("long_runs", 30), ("all_invalid", 64)])
def test_plain_filter_is_the_cpu_route(kind, out_cap):
    """voxel_filter_plain (cells, the compact-key order, voxel_reduce_plain)
    equals voxel_downsample's CPU route (_cells, lexsort, voxel_reduce) bit
    for bit, and the sorted permutation is the same."""
    xyz, inten, mask = (torch.tensor(t) for t in _cloud(kind, 2500, 3))
    S = 2500 if out_cap is None else out_cap
    got = vf.voxel_filter(xyz[None], inten[None], mask[None], 0.3, S)
    want = tvoxel.voxel_downsample(PointCloud(xyz, inten, mask), 0.3, S)
    for g, w in zip(got, (*want.cloud, want.rep_idx)):
        assert torch.equal(g[0], w)
    assert int(got[2].sum()) == {"all_invalid": 0, "long_runs": 30}.get(kind, int(got[2].sum()))


def test_no_intensity_reads_as_zeros():
    """intensity None (voxel_downsample_xyz's call) is a cloud of zero
    intensity, through the op's vmap rule too."""
    xyz, _, mask = (torch.tensor(t) for t in _cloud("city", 1500, 4))
    zeros = torch.zeros(mask.shape)
    want = vf.voxel_filter(xyz[None], zeros[None], mask[None], 0.3, 700)
    got = vf.voxel_filter(xyz[None], None, mask[None], 0.3, 700)
    lanes = torch.func.vmap(lambda x, m: tuple(
        t[0] for t in vf._voxel_filter_op(x[None], None, m[None], 0.3, 700)))(xyz[None], mask[None])
    for g, l, w in zip(got, lanes, want):
        assert torch.equal(g, w) and torch.equal(l, w)
    ds, ds_mask = tvoxel.voxel_downsample_xyz(xyz, mask, 0.3, 700)
    assert torch.equal(ds, want[0][0]) and torch.equal(ds_mask, want[2][0])


def test_plain_filter_against_jax():
    """The plain version against the JAX package's voxel_downsample: masks and
    representatives exact, centroids and intensity to 1e-5 relative (XLA's
    scatter-add sums in another order)."""
    import jax.numpy as jnp

    from liorf_tpu.core import voxel as jvoxel
    from liorf_tpu.core.pointcloud import PointCloud as JPointCloud

    xyz, inten, mask = _cloud("city", 2048, 21)
    xyz[mask] *= 0.05
    rj = jvoxel.voxel_downsample(JPointCloud(jnp.asarray(xyz), jnp.asarray(inten),
                                             jnp.asarray(mask)), 0.3, 900)
    rt = [t[0] for t in vf.voxel_filter_plain(*(torch.tensor(t)[None] for t in (xyz, inten, mask)),
                                              0.3, 900)]
    np.testing.assert_array_equal(rt[2].numpy(), np.asarray(rj.cloud.mask))
    np.testing.assert_array_equal(rt[3].numpy(), np.asarray(rj.rep_idx))
    np.testing.assert_allclose(rt[0].numpy(), np.asarray(rj.cloud.xyz), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rt[1].numpy(), np.asarray(rj.cloud.intensity), rtol=1e-5, atol=1e-6)
    assert 100 < int(rt[2].sum()) <= 900


def test_guards():
    """What the kernel does not take raises before any launch; voxel_reduce
    takes CPU tensors only."""
    from liorf_tpu_torch.ops import voxel_reduce as vr

    x = torch.zeros((1, 8, 3))
    with pytest.raises(ValueError):
        vf._checked(x, torch.zeros((1, 8)), torch.ones((1, 8)))  # float mask
    with pytest.raises(ValueError):
        vf._checked(x[0], torch.zeros(8), torch.ones(8, dtype=torch.bool))
    with pytest.raises(ValueError):
        vf.voxel_filter(x.to("meta"), torch.zeros((1, 8), device="meta"),
                        torch.ones((1, 8), dtype=torch.bool, device="meta"), 0.3, 4)
    with pytest.raises(ValueError):
        vr.voxel_reduce(*(t.to("meta") for t in (
            x, torch.zeros((1, 8)), torch.ones((1, 8), dtype=torch.bool),
            torch.zeros((1, 8, 3), dtype=torch.int32), torch.zeros((1, 8), dtype=torch.int64))), 4)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    # decided here, not at import: every xdist worker must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


def check_kernel(dev, clouds, S: int, leaf: float):
    """The kernel on the card against its plain version on a CPU copy: the
    sorted permutation and every output bit for bit; a second launch equal;
    each launch one kernel; the lanes' counters back at 0."""
    xyz, inten, mask = (torch.tensor(np.stack(t)) for t in zip(*clouds))
    order = vf.filter_order_plain(vf.cells_plain(xyz, mask, leaf), mask)
    want = vf.voxel_filter_plain(xyz, inten, mask, leaf, S)
    card = [t.to(dev) for t in (xyz, inten, mask)]
    before, kernels = vf.voxel_filter.launches, vf.kernel_launches()
    got = vf._launch(*card, leaf, S, keep_order=True)
    again = vf.voxel_filter(*card, leaf, S)
    torch.cuda.synchronize()
    assert vf.voxel_filter.launches == before + 2 and vf.kernel_launches() == kernels + 2
    assert torch.equal(got[4].cpu(), order)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert torch.equal(g.cpu(), w)
    assert int(vf.lane_counters(dev, len(clouds)).abs().sum()) == 0
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("n, S, lanes", [(32768, 16384, 1), (262144, 131072, 1), (16384, 8192, 8)],
                         ids=["scan", "map", "lanes8"])
def test_kernel_is_the_plain_version_at_the_sites(dev, n, S, lanes):
    got = check_kernel(dev, [_cloud("city", n, seed) for seed in range(lanes)], S, 0.3)
    assert 0 < int(got[2].sum(-1).min()) <= S


@pytest.mark.gpu
@pytest.mark.parametrize("kind, n, S, leaf", [("sensor", 32768, 16384, 0.3),
                                              ("wide", 32768, 16384, 1.0),
                                              ("spike", 32768, 16384, 0.3),
                                              ("all_invalid", 5000, 4000, 0.3),
                                              ("long_runs", 40000, 4096, 0.3),
                                              ("city", 32768, 2000, 0.3),
                                              ("city", 1, 1, 0.3), ("city", 2049, 3000, 0.3)],
                         ids=["sensor", "wide", "spike", "all_invalid", "long_runs",
                              "capacity_below_voxels", "one_point", "two_tiles_and_one"])
def test_kernel_edge_cases_are_the_plain_version(dev, kind, n, S, leaf):
    got = check_kernel(dev, [_cloud(kind, n, 7)], S, leaf)
    valid = int(got[2].sum())
    assert valid == {"all_invalid": 0, "capacity_below_voxels": S}.get(kind, valid)


@pytest.mark.gpu
def test_vmapped_filter_is_one_launch(dev):
    """voxel_downsample under torch.func.vmap over three lanes of other ranges:
    one launch, each lane the one-lane call's bits."""
    clouds = [_cloud(k, 20000, s) for s, k in enumerate(("city", "spike", "long_runs"))]
    xyz, inten, mask = (torch.tensor(np.stack(t)).to(dev) for t in zip(*clouds))
    before = vf.kernel_launches()
    batched = torch.func.vmap(lambda x, i, m: tvoxel.voxel_downsample(
        PointCloud(x, i, m), 0.3, 9000))(xyz, inten, mask)
    assert vf.kernel_launches() == before + 1
    for lane in range(3):
        alone = tvoxel.voxel_downsample(PointCloud(xyz[lane], inten[lane], mask[lane]), 0.3, 9000)
        for g, w in zip((*batched.cloud, batched.rep_idx), (*alone.cloud, alone.rep_idx)):
            assert torch.equal(g[lane], w)


@pytest.mark.gpu
def test_xyz_filter_is_one_launch_without_intensity(dev):
    """voxel_downsample_xyz on the card: one kernel launch and no other (no
    zeros for the intensity), the CPU route's bits."""
    xyz, _, mask = (torch.tensor(t) for t in _cloud("city", 32768, 8))
    before = vf.kernel_launches()
    got = tvoxel.voxel_downsample_xyz(xyz.to(dev), mask.to(dev), 0.3, 16384)
    assert vf.kernel_launches() == before + 1
    want = tvoxel.voxel_downsample_xyz(xyz, mask, 0.3, 16384)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.gpu
def test_cells_past_int32_cast_as_torch_does_on_the_card(dev):
    """Valid points whose cells pass int32's range, or are NaN: the kernel
    casts them as torch does on the card (saturating, NaN to 0), so its order
    is the plain compact-key order of torch's cells on the card, and so are
    its masks and representatives."""
    xyz, inten, mask = _cloud("city", 4096, 9)
    xyz[:40] = np.array([3e12, -3e12, 1.0], np.float32)
    xyz[40:60] = np.nan
    mask[:60] = True
    card = [torch.tensor(t).to(dev)[None] for t in (xyz, inten, mask)]
    got = vf._launch(*card, 0.3, 4096, keep_order=True)
    cell = vf.cells_plain(card[0], card[2], 0.3)
    assert int(cell[0, :40, 0].max()) == 2**31 - 1 and int(cell[0, 40:60].abs().max()) == 0
    assert torch.equal(got[4], vf.filter_order_plain(cell, card[2]))
    want = vf.voxel_filter_plain(*card, 0.3, 4096)
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
