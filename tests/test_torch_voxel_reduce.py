"""The voxel filter's reduction (``ops/voxel_reduce.py``) and its sort
(``core/voxel.py::lexsort``), the CPU route of the filter: the sort against
``numpy.lexsort``, the filter against the JAX package's, the plain version
against a sequential float32 sum of each voxel in numpy, the vmap rule, the
segment sum's offsets; on the card (marker ``gpu``) the filter's one kernel
call (``ops/voxel_filter.py``) against this route on a CPU copy, bit for
bit, and the segment sum at the dist shapes. Without JAX on the card:

    python -m pytest tests/test_torch_voxel_reduce.py -m gpu -q --noconftest
"""

import numpy as np
import pytest
import torch

from liorf_tpu_torch.core import voxel as tvoxel
from liorf_tpu_torch.core.pointcloud import PAD_COORD, PointCloud
from liorf_tpu_torch.ops import segment_sum as ss
from liorf_tpu_torch.ops import voxel_filter as vf
from liorf_tpu_torch.ops import voxel_reduce as vr

I32 = np.iinfo(np.int32)


def _cells_case(rng, n: int, kind: str):
    """[n, 3] int32 cells and a mask, of one kind of hard case."""
    if kind == "negative":
        cell = rng.integers(-3, 3, size=(n, 3))
    elif kind == "extremes":
        cell = rng.choice([I32.min, I32.min + 1, -1, 0, 1, I32.max - 1, I32.max], size=(n, 3))
    elif kind == "pad":
        cell = rng.integers(-2, 2, size=(n, 3))
        cell[rng.uniform(size=n) < 0.3] = int(np.floor(PAD_COORD / 0.3))
    else:  # ties: long runs of one cell
        cell = np.repeat(rng.integers(-1, 1, size=(n // 50 + 1, 3)), 50, axis=0)[:n]
    mask = rng.uniform(size=n) > 0.25
    return cell.astype(np.int32), mask


@pytest.mark.parametrize("kind", ["negative", "extremes", "pad", "ties"])
def test_filter_sort_is_numpy_lexsort(kind):
    """The filter's order, (z, y, x) cell with invalid points last, ties in
    input order: the permutation voxel_reduce's representative relies on."""
    rng = np.random.default_rng(["negative", "extremes", "pad", "ties"].index(kind))
    cell, mask = _cells_case(rng, 1500, kind)
    want = np.lexsort((cell[:, 0], cell[:, 1], cell[:, 2], ~mask))
    c, m = torch.tensor(cell), torch.tensor(mask)
    got = tvoxel.lexsort((c[:, 0], c[:, 1], c[:, 2], (~m).to(torch.uint8))).numpy()
    np.testing.assert_array_equal(got, want)


def _cloud(rng, n: int, spread: float = 6.0, valid: float = 0.8):
    xyz = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    xyz[:, 2] *= 0.1
    inten = rng.uniform(0, 1, n).astype(np.float32)
    mask = rng.uniform(size=n) < valid
    xyz[~mask] = PAD_COORD
    return xyz, inten, mask


@pytest.mark.parametrize("out_cap", [None, 300, 120])
def test_voxel_downsample_against_jax(out_cap):
    """Masks and rep_idx exact; centroids and intensity to 1e-5 relative
    (XLA's scatter-add sums in another order than the CPU's index_add). The
    cloud has 640 occupied voxels, so 300 and 120 drop some."""
    import jax.numpy as jnp

    from liorf_tpu.core import voxel as jvoxel
    from liorf_tpu.core.pointcloud import PointCloud as JPointCloud

    xyz, inten, mask = _cloud(np.random.default_rng(7), 1024)
    rj = jvoxel.voxel_downsample(
        JPointCloud(jnp.asarray(xyz), jnp.asarray(inten), jnp.asarray(mask)), 0.5, out_cap)
    rt = tvoxel.voxel_downsample(
        PointCloud(torch.tensor(xyz), torch.tensor(inten), torch.tensor(mask)), 0.5, out_cap)
    np.testing.assert_array_equal(rt.cloud.mask.numpy(), np.asarray(rj.cloud.mask))
    np.testing.assert_array_equal(rt.rep_idx.numpy(), np.asarray(rj.rep_idx))
    np.testing.assert_allclose(rt.cloud.xyz.numpy(), np.asarray(rj.cloud.xyz), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rt.cloud.intensity.numpy(), np.asarray(rj.cloud.intensity),
                               rtol=1e-5, atol=1e-6)
    occupied = int(np.asarray(jvoxel.voxel_downsample(
        JPointCloud(jnp.asarray(xyz), jnp.asarray(inten), jnp.asarray(mask)), 0.5).cloud.mask).sum())
    assert occupied > 300
    assert int(rt.cloud.mask.sum()) == (occupied if out_cap is None else out_cap)


def _reduce_args(cloud: PointCloud, leaf: float):
    """voxel_reduce's arguments for one lane, as voxel_downsample makes them."""
    cell = tvoxel._cells(cloud, leaf)
    order = tvoxel.lexsort((cell[:, 0], cell[:, 1], cell[:, 2], (~cloud.mask).to(torch.uint8)))
    return (cloud.xyz[None], cloud.intensity[None], cloud.mask[None], cell[None], order[None])


def _sequential_reference(xyz, inten, mask, cell, order, S: int):
    """The contract in numpy, one point at a time: segments of equal valid
    cells in sorted order, each quantity summed from 0.0 in float32, one
    rounded add at a time, then divided; the representative is the smallest
    input index."""
    n = len(mask)
    acc = np.zeros((S, 5), np.float32)
    rep = np.full(S, n, np.int64)
    slot, prev = -1, None
    for p in order:
        key = tuple(cell[p]) if mask[p] else None
        if key is None or key != prev:
            slot += 1
        prev = key
        if key is None or slot >= S:
            continue
        for q, v in enumerate((*xyz[p], inten[p], 1.0)):
            acc[slot, q] = np.float32(acc[slot, q] + np.float32(v))
        rep[slot] = min(rep[slot], p)
    valid = acc[:, 4] > 0
    cnt = np.where(valid, acc[:, 4], np.float32(1.0))
    cen = np.where(valid[:, None], acc[:, :3] / cnt[:, None], np.float32(PAD_COORD))
    return cen, acc[:, 3] / cnt, valid, np.where(valid, rep, n)


@pytest.mark.parametrize("out_cap", [None, 200])
def test_plain_is_the_sequential_sum(out_cap):
    """voxel_reduce_plain (one index_add over the lanes' slots, then
    scatter_reduce(amin)) is bit-equal on the CPU to the contract summed
    point by point in numpy, and the smallest input index of a voxel is the
    order at its first sorted position, since the sort is stable (what the
    kernel reads)."""
    xyz, inten, mask = _cloud(np.random.default_rng(3), 3000, spread=4.0)
    cloud = PointCloud(torch.tensor(xyz), torch.tensor(inten), torch.tensor(mask))
    S = 3000 if out_cap is None else out_cap
    args = _reduce_args(cloud, 0.5)
    got = [t[0] for t in vr.voxel_reduce_plain(*args, S)]
    want = _sequential_reference(xyz, inten, mask, args[3][0].numpy(), args[4][0].numpy(), S)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert 0 < int(got[2].sum()) <= S
    order, mask_s = args[4][0], args[2][0][args[4][0]]
    cell_s = args[3][0][order]
    first = torch.ones_like(mask_s)
    first[1:] = ~((cell_s[1:] == cell_s[:-1]).all(-1) & mask_s[1:] & mask_s[:-1])
    firsts = order[first & mask_s][:S]
    assert torch.equal(got[3][got[2]], firsts)


def test_vmap_rule_folds_lanes_into_one_call():
    """Under torch.func.vmap (the multistream lane axis) the op sees one
    stacked call; the result is the loop over the lanes."""
    rng = np.random.default_rng(11)
    lanes = [_reduce_args(PointCloud(*map(torch.tensor, _cloud(rng, 700))), 0.5)
             for _ in range(3)]
    stacked = [torch.cat(parts) for parts in zip(*lanes)]

    def one(*a):
        return tuple(t[0] for t in vr._voxel_reduce_op(*(x[None] for x in a), 256))

    got = torch.func.vmap(one)(*stacked)
    for b, args in enumerate(lanes):
        for g, w in zip(got, vr.voxel_reduce_plain(*args, 256)):
            assert torch.equal(g[b], w[0])
    # and voxel_downsample itself under vmap is each lane's filter
    clouds = [PointCloud(*map(torch.tensor, _cloud(rng, 500))) for _ in range(2)]
    batched = torch.func.vmap(lambda x, i, m: tvoxel.voxel_downsample(PointCloud(x, i, m), 0.5, 200))(
        *(torch.stack(t) for t in zip(*clouds)))
    for b, cl in enumerate(clouds):
        alone = tvoxel.voxel_downsample(cl, 0.5, 200)
        assert torch.equal(batched.cloud.xyz[b], alone.cloud.xyz)
        assert torch.equal(batched.rep_idx[b], alone.rep_idx)


def test_segment_offsets_bound_each_segment():
    """offsets[s] .. offsets[s + 1] are the positions keyed s; rows keyed
    past the last segment lie beyond offsets[S]; the plain sum ignores the
    offsets the card's kernel walks."""
    rng = np.random.default_rng(4)
    keys = torch.tensor(np.sort(rng.integers(0, 40, size=(2, 500)), axis=1))
    S = 33
    off = ss.segment_offsets(keys, S)
    assert off.shape == (2, S + 1)
    for b in range(2):
        for s in range(S):
            assert bool((keys[b, off[b, s]:off[b, s + 1]] == s).all())
        assert int(off[b, S]) == int((keys[b] < S).sum())
    src = torch.tensor(rng.normal(size=(2, 500, 6)).astype(np.float32))
    assert torch.equal(ss._segment_sum_op(src, None, keys, S, off),
                       ss.segment_sum_plain(src, None, keys, S))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    # decided here, not at import: every xdist worker must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _gpu_case(kind: str, n: int, seed: int):
    """One lane's cloud [n] of a kind, on the CPU."""
    rng = np.random.default_rng(seed)
    if kind == "all_invalid":
        xyz, inten, mask = _cloud(rng, n, valid=0.0)
    elif kind == "one_voxel":
        xyz, inten, mask = _cloud(rng, n, spread=0.2, valid=1.0)
        xyz[:, :] = np.abs(xyz) + 0.01  # every point in the cell (0, 0, 0)
    elif kind == "long_runs":
        # ~90 points a voxel: a block's 256 slots span more rows than it stages
        xyz, inten, mask = _cloud(rng, n, spread=2.0, valid=0.9)
    else:  # a scan or a map: about two points a voxel at leaf 0.3
        side = (n / 2) ** (1 / 3) * 0.3 / 2
        xyz, inten, mask = _cloud(rng, n, spread=side * 1.0, valid=0.9)
        xyz[mask, 2] *= 10.0
    return PointCloud(torch.tensor(xyz), torch.tensor(inten), torch.tensor(mask))


def _check_kernel(dev, lanes, S, leaf):
    """The filter's kernel on the card against the CPU route (_cells, lexsort,
    voxel_reduce_plain) on a CPU copy, bit for bit, and against itself."""
    args = [torch.cat(parts) for parts in zip(*(_reduce_args(c, leaf) for c in lanes))]
    want = vr.voxel_reduce_plain(*args, S)
    card = [a.to(dev) for a in args[:3]]
    before = vf.voxel_filter.launches
    got = vf.voxel_filter(*card, leaf, S)
    again = vf.voxel_filter(*card, leaf, S)
    assert vf.voxel_filter.launches == before + 2
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert torch.equal(g.cpu(), w)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("n, S, lanes", [(32768, 16384, 1), (262144, 131072, 1), (16384, 8192, 8)],
                         ids=["scan", "map", "lanes8"])
def test_kernel_is_the_plain_version(dev, n, S, lanes):
    clouds = [_gpu_case("site", n, seed) for seed in range(lanes)]
    got = _check_kernel(dev, clouds, S, 0.3)
    assert 0 < int(got[2].sum(-1).min()) < S


@pytest.mark.gpu
@pytest.mark.parametrize("kind, n, S", [("site", 32768, 2000), ("all_invalid", 5000, 4000),
                                        ("one_voxel", 6000, 100), ("long_runs", 40000, 4096)],
                         ids=["capacity_below_voxels", "all_invalid", "one_voxel", "long_runs"])
def test_kernel_edge_cases(dev, kind, n, S):
    got = _check_kernel(dev, [_gpu_case(kind, n, 5)], S, 0.3)
    valid = int(got[2].sum())
    assert valid == {"site": S, "all_invalid": 0, "one_voxel": 1}.get(kind, valid)


@pytest.mark.gpu
def test_voxel_downsample_on_the_card_is_one_call(dev):
    cloud = PointCloud(*(t.to(dev) for t in _gpu_case("site", 32768, 9)))
    before_k, before_s = vf.kernel_launches(), ss.segment_sum.launches
    new = tvoxel.voxel_downsample(cloud, 0.3, 16384)
    assert vf.kernel_launches() == before_k + 1 and ss.segment_sum.launches == before_s
    cpu = tvoxel.voxel_downsample(PointCloud(*(t.cpu() for t in cloud)), 0.3, 16384)
    for g, w in zip((*new.cloud, new.rep_idx), (*cpu.cloud, cpu.rep_idx)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("cols", [6, 36])
def test_segment_sum_offsets_at_the_dist_site(dev, cols):
    """A SegmentPlan at the distributed solver's matvec shapes (2048 nodes a
    rank, 4096 edges, 64 GPS factors): the kernel walking the plan's offsets
    equals the CPU's index_adds bit for bit, and itself."""
    rng = np.random.default_rng(cols)
    K, E, G = 2048, 4096, 64
    e_i = rng.integers(0, K, size=E)
    idx = [e_i, np.clip(e_i + rng.integers(1, 3, size=E), 0, K - 1), rng.integers(0, K, size=G)]
    vals = [rng.normal(size=(len(i), cols)).astype(np.float32) for i in idx]
    cpu = ss.SegmentPlan([torch.tensor(i) for i in idx], K).sum([torch.tensor(v) for v in vals])
    plan = ss.SegmentPlan([torch.tensor(i, device=dev) for i in idx], K)
    before = ss.segment_sum.launches
    a = plan.sum([torch.tensor(v, device=dev) for v in vals])
    b = plan.sum([torch.tensor(v, device=dev) for v in vals])
    assert ss.segment_sum.launches == before + 2
    assert torch.equal(a, b) and torch.equal(a.cpu(), cpu)
