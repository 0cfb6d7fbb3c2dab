"""Tests that need an NVIDIA GPU (marker ``gpu``): the CUDA kernels against
their plain versions for every k on ragged shapes, and the scan matcher on
the card against the CPU. They skip where there is no card; run them on a GPU machine with

    python -m pytest tests/test_torch_gpu.py -m gpu -q
"""

import numpy as np
import pytest
import torch

from liorf_tpu_torch.ops import knn as tknn
from liorf_tpu_torch.ops import knn_cuda
from liorf_tpu_torch.ops.scan_match import ScanMatchParams, scan_to_map

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    # decided here, not at import: every xdist worker must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _ragged_grid(dev, gen, m, bucket):
    """A planar map with one over-full cell, duplicate points, masked and
    out-of-range points (the sentinel run), built by the port's build_grid."""
    xyz = (torch.rand((m, 3), generator=gen, device=dev) - 0.5) * 20
    xyz[: m // 2, 2] = 0.0
    xyz[m // 2 :, 0] = 4.0
    xyz[:100] = torch.rand((100, 3), generator=gen, device=dev) + 2.0  # one dense cell
    xyz[200:300] = xyz[300:400]  # duplicates: exact ties
    xyz[400:420, 1] = 900.0  # out of range
    mask = torch.rand((m,), generator=gen, device=dev) > 0.05
    return tknn.build_grid(xyz, mask, torch.tensor([0.25, -0.5, 0.125], device=dev), 1.0)


def _grid_queries(dev, gen, grid, n):
    pick = torch.randint(0, grid.xyz.shape[0], (n,), generator=gen, device=dev)
    q = grid.xyz[pick] + 0.05 * torch.randn((n, 3), generator=gen, device=dev)
    q[:7] = torch.tensor([[700.0, 0, 0], [0, -800.0, 0], [0, 0, 1e9], [2.5, 2.5, 2.5],
                          [-600.0, 0, 0], [1.0, 1.0, 1.0], [0, 0, 0]], device=dev)
    mask = torch.rand((n,), generator=gen, device=dev) > 0.1
    mask[:5] = True
    return q.contiguous(), mask


@pytest.mark.parametrize("k", range(1, 9))
def test_knn_grid_topk_kernel_vs_plain(dev, k):
    """The fused K1 against knn_grid_topk_plain on ragged grids: bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(k)
    for m, n, bucket in ((3001 + k, 777, 8), (20000, 1001, 40), (1, 33, 4)):
        grid = _ragged_grid(dev, gen, m, bucket) if m > 500 else tknn.build_grid(
            torch.zeros((m, 3), device=dev), torch.ones(m, dtype=torch.bool, device=dev),
            torch.zeros(3, device=dev), 1.0)
        q, mask = _grid_queries(dev, gen, grid, n)
        before = knn_cuda.knn_grid_topk.launches
        d_k, i_k = knn_cuda.knn_grid_topk(grid, q, mask, k, bucket)
        assert knn_cuda.knn_grid_topk.launches == before + 1
        d_p, i_p = knn_cuda.knn_grid_topk_plain(grid, q, mask, k, bucket)
        assert torch.equal(d_k, d_p) and torch.equal(i_k, i_p), (m, n, bucket)
        # the same through knn.knn_grid, which takes the kernel on the card
        d_g, i_g = tknn.knn_grid(grid, q, mask, k, bucket)
        assert knn_cuda.knn_grid_topk.launches == before + 2
        assert torch.equal(d_g, d_p) and torch.equal(i_g, i_p)


@pytest.mark.parametrize("k", range(1, 9))
def test_knn_bruteforce_kernel_vs_plain(dev, k):
    gen = torch.Generator(device=dev).manual_seed(100 + k)
    n, m = 1001, 2500 + k
    tgt = torch.randn((m, 3), generator=gen, device=dev) * 10
    tgt[1000:1100] = tgt[:100]  # ties
    qry = torch.randn((n, 3), generator=gen, device=dev) * 10
    tm = torch.rand((m,), generator=gen, device=dev) > 0.1
    qm = torch.rand((n,), generator=gen, device=dev) > 0.1
    before = knn_cuda.knn_bruteforce.launches
    d_k, i_k = knn_cuda.knn_bruteforce(tgt, tm, qry, qm, k)
    assert knn_cuda.knn_bruteforce.launches == before + 1
    d_p, i_p = knn_cuda.knn_bruteforce_plain(tgt, tm, qry, qm, k)
    assert torch.equal(d_k, d_p) and torch.equal(i_k, i_p)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_knn_bruteforce_ragged_and_unaligned(dev, k):
    """N off every multiple of the queries a thread or block owns, tiny and
    ragged M, and targets whose data does not start on 16 bytes."""
    gen = torch.Generator(device=dev).manual_seed(200 + k)
    for n, m in ((1, 1), (31, 5), (33, 257), (257, 4099), (4097, 700)):
        base = torch.randn((m + 1, 3), generator=gen, device=dev) * 5
        tgt = base[1:]  # a view 12 bytes into its storage
        qry = torch.randn((n, 3), generator=gen, device=dev) * 5
        tm = torch.rand((m + 1,), generator=gen, device=dev)[1:] > 0.2
        qm = torch.rand((n,), generator=gen, device=dev) > 0.2
        d_k, i_k = knn_cuda.knn_bruteforce(tgt, tm, qry, qm, k)
        d_p, i_p = knn_cuda.knn_bruteforce_plain(tgt, tm, qry, qm, k)
        assert torch.equal(d_k, d_p) and torch.equal(i_k, i_p), (n, m)


def test_wrappers_raise_on_what_the_kernel_does_not_take(dev):
    q = torch.zeros((4, 3), device=dev)
    ok_idx = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    # pre-gathered candidates have no kernel on the card: raise, naming the fused one
    with pytest.raises(ValueError, match="knn_grid_topk"):
        knn_cuda.topk_candidates(q, torch.zeros((4, 8, 3), device=dev), ok_idx, 2)
    mask = torch.ones(4, dtype=torch.bool, device=dev)
    grid = tknn.build_grid(q, mask, torch.zeros(3, device=dev), 1.0)
    with pytest.raises(TypeError):  # f64 queries
        knn_cuda.knn_grid_topk(grid, q.double(), mask, 2)
    with pytest.raises(ValueError):  # grid on the CPU
        knn_cuda.knn_grid_topk(grid._replace(keys=grid.keys.cpu()), q, mask, 2)
    with pytest.raises(ValueError):  # k out of range
        knn_cuda.knn_grid_topk(grid, q, mask, 9)
    with pytest.raises(ValueError):  # not contiguous
        knn_cuda.knn_bruteforce(
            torch.zeros((3, 8), device=dev).T, torch.ones(8, dtype=torch.bool, device=dev),
            q, torch.ones(4, dtype=torch.bool, device=dev), 1,
        )


def test_scan_to_map_gpu_matches_cpu(dev):
    rng = np.random.default_rng(0)
    pts = []
    for axis, offset in [(2, 0.0), (0, -10.0), (0, 10.0), (1, -10.0), (1, 10.0)]:
        p = rng.uniform(-10, 10, size=(4096, 3))
        p[:, axis] = offset
        pts.append(p)
    map_xyz = torch.tensor(np.concatenate(pts).astype(np.float32))
    scan = map_xyz[::4][:4096].contiguous()
    init = torch.tensor([0.01, -0.005, 0.02, 0.1, -0.05, 0.02])
    out = {}
    for d in ("cpu", dev):
        grid = tknn.build_grid(
            map_xyz.to(d), torch.ones(len(map_xyz), dtype=torch.bool, device=d),
            torch.zeros(3, device=d), 1.0,
        )
        out[str(d)] = scan_to_map(
            scan.to(d), torch.ones(len(scan), dtype=torch.bool, device=d), grid,
            init.to(d), ScanMatchParams(knn_bucket=40),
        )
    a, b = out["cpu"], out[str(dev)]
    np.testing.assert_allclose(b.pose.cpu().numpy(), a.pose.numpy(), atol=1e-4)
    assert int(a.iters) == int(b.iters) and bool(b.converged)


def test_make_pipeline_on_the_card_matches_cpu(dev):
    """make_pipeline with no device runs the resident pipeline on the card;
    six frames with a loop search every frame agree with the CPU run."""
    from liorf_tpu_torch.ops import knn_cuda as kc
    from liorf_tpu_torch.pipeline import SlamConfig, make_pipeline
    from liorf_tpu_torch.sensors.synthetic import SyntheticConfig, SyntheticDataset

    kw = dict(
        scan_capacity=4096, map_capacity=16384, kf_cloud_capacity=4096,
        near_kf_capacity=8, imu_window=32, mappingSurfLeafSize=0.2,
        surroundingKeyframeMapLeafSize=0.2, point_filter_num=1, downsampleRate=1,
        loopClosureEnableFlag=True, loopClosureFrequency=10.0,
        historyKeyframeSearchTimeDiff=0.25, surroundingkeyframeAddingDistThreshold=0.3,
        kf_capacity=32, traj_capacity=64, gps_capacity=8, loop_capacity=8,
        imu_rate_capacity=1024,
    )
    syn = SyntheticDataset(SyntheticConfig(n_frames=6, n_rings=16, points_per_ring=250))
    scans, imu = [syn.scan(f) for f in range(6)], syn.imu_stream()
    out = {}
    kc.reset_launch_counts()
    for d in (None, "cpu"):
        pipe = make_pipeline(SlamConfig(**kw), device=d)
        # the CPU run's plain k-NN is quadratic in the ICP cap (as in
        # tests/test_torch_resident.py)
        pipe.params = pipe.params._replace(loop_icp_cap=4096)
        ii = 0
        for scan in scans:
            while ii < len(imu) and imu[ii].stamp <= scan.end_time + 0.02:
                pipe.push_imu(imu[ii])
                ii += 1
            pipe.process_scan(scan)
        out[str(pipe.device.type)] = pipe
    gpu, cpu = out["cuda"], out["cpu"]
    assert gpu.state.kf_poses.device.type == "cuda"
    counts = kc.launch_counts()
    assert counts["knn_grid_topk"] == gpu.gn_iters_total() > 0
    assert int(gpu.state.l_count) == int(cpu.state.l_count) >= 1
    assert counts["knn_bruteforce"] > 0
    np.testing.assert_allclose(gpu.trajectory_arrays()[1], cpu.trajectory_arrays()[1], atol=1e-3)


@pytest.mark.parametrize("k", [1, 5, 8])
def test_knn_grid_topk_lanes_vs_plain_and_one_lane(dev, k):
    """K1 with a lane axis on ragged stacks (a lane of masked queries, a lane
    with an empty map): one launch, equal bit for bit to the stacked plain
    version and to one-lane calls."""
    gen = torch.Generator(device=dev).manual_seed(300 + k)
    lanes, m, n, bucket = 3, 3001, 777, 8
    grids = [_ragged_grid(dev, gen, m, bucket) for _ in range(lanes)]
    grids[2] = tknn.build_grid(grids[2].xyz, torch.zeros_like(grids[2].mask), grids[2].origin, 1.0)
    qs = [_grid_queries(dev, gen, g, n) for g in grids]
    grid = type(grids[0])(*(torch.stack(f).contiguous() for f in zip(*grids)))
    q = torch.stack([x[0] for x in qs]).contiguous()
    qm = torch.stack([x[1] for x in qs]).contiguous()
    qm[1] = False
    before = knn_cuda.knn_grid_topk.launches
    d_k, i_k = knn_cuda.knn_grid_topk(grid, q, qm, k, bucket)
    assert knn_cuda.knn_grid_topk.launches == before + 1
    d_p, i_p = knn_cuda.knn_grid_topk_plain(grid, q, qm, k, bucket)
    assert torch.equal(d_k, d_p) and torch.equal(i_k, i_p)
    assert torch.isinf(d_k[1]).all()
    for b, g in enumerate(grids):
        d1, i1 = knn_cuda.knn_grid_topk(g, q[b], qm[b], k, bucket)
        assert torch.equal(d1, d_k[b]) and torch.equal(i1, i_k[b])


@pytest.mark.parametrize("k", [1, 3, 8])
def test_knn_bruteforce_lanes_vs_plain_and_one_lane(dev, k):
    """K2 with a lane axis: lane lengths that are no multiple of 16 (the
    wrapper pads), an all-masked map lane, an all-masked query lane; one
    launch, bit for bit against the plain version and one-lane calls."""
    gen = torch.Generator(device=dev).manual_seed(400 + k)
    for lanes, n, m in ((3, 1001, 2505), (5, 33, 17), (2, 4097, 700)):
        tgt = torch.randn((lanes, m, 3), generator=gen, device=dev) * 5
        qry = torch.randn((lanes, n, 3), generator=gen, device=dev) * 5
        tm = torch.rand((lanes, m), generator=gen, device=dev) > 0.2
        qm = torch.rand((lanes, n), generator=gen, device=dev) > 0.2
        tm[0] = False
        qm[-1] = False
        before = knn_cuda.knn_bruteforce.launches
        d_k, i_k = knn_cuda.knn_bruteforce(tgt, tm, qry, qm, k)
        assert knn_cuda.knn_bruteforce.launches == before + 1
        d_p, i_p = knn_cuda.knn_bruteforce_plain(tgt, tm, qry, qm, k)
        assert torch.equal(d_k, d_p) and torch.equal(i_k, i_p), (lanes, n, m)
        for b in range(lanes):
            d1, i1 = knn_cuda.knn_bruteforce(tgt[b], tm[b], qry[b], qm[b], k)
            assert torch.equal(d1, d_k[b]) and torch.equal(i1, i_k[b]), (lanes, n, m, b)


def test_multistream_on_the_card_matches_single_sessions(dev):
    """MultiStreamPipeline with no device runs on the card: two distinct
    streams, six ticks with a loop search every frame; each lane agrees
    with a single-session run on the card (keyframe flags and loop factors
    equal, poses within 1e-3), and K1 launched once per batched GN
    iteration."""
    from liorf_tpu_torch.ops import knn_cuda as kc
    from liorf_tpu_torch.pipeline import SlamConfig, make_pipeline
    from liorf_tpu_torch.pipeline.multistream import MultiStreamPipeline
    from liorf_tpu_torch.sensors.synthetic import SyntheticConfig, SyntheticDataset

    kw = dict(
        scan_capacity=4096, map_capacity=16384, kf_cloud_capacity=4096,
        near_kf_capacity=8, imu_window=32, mappingSurfLeafSize=0.2,
        surroundingKeyframeMapLeafSize=0.2, point_filter_num=1, downsampleRate=1,
        loopClosureEnableFlag=True, loopClosureFrequency=10.0,
        historyKeyframeSearchTimeDiff=0.25, surroundingkeyframeAddingDistThreshold=0.3,
        kf_capacity=32, traj_capacity=64, gps_capacity=8, loop_capacity=8,
        imu_rate_capacity=1024,
    )
    syns = [SyntheticDataset(SyntheticConfig(n_frames=6, n_rings=16, points_per_ring=250, seed=0)),
            SyntheticDataset(SyntheticConfig(n_frames=6, n_rings=16, points_per_ring=250, seed=7,
                                             yaw_rate=0.4, speed=3.0))]
    streams = [([s.scan(f) for f in range(6)], s.imu_stream()) for s in syns]
    mp = MultiStreamPipeline(SlamConfig(**kw), n_streams=2)
    assert mp.device.type == "cuda"
    iis = [0, 0]
    kc.reset_launch_counts()
    for f in range(6):
        scans = [s[0][f] for s in streams]
        for b, (_, imu) in enumerate(streams):
            while iis[b] < len(imu) and imu[iis[b]].stamp <= scans[b].end_time + 0.02:
                mp.push_imu(b, imu[iis[b]])
                iis[b] += 1
        mp.step(scans)
    mp.finish()
    assert kc.launch_counts()["knn_grid_topk"] == mp.gn_iters_batched() > 0
    for b, (scans, imu) in enumerate(streams):
        one = make_pipeline(SlamConfig(**kw))
        ii = 0
        for scan in scans:
            while ii < len(imu) and imu[ii].stamp <= scan.end_time + 0.02:
                one.push_imu(imu[ii])
                ii += 1
            one.process_scan(scan)
        shell = mp.stream(b)
        assert [r.is_keyframe for r in shell.trajectory] == [r.is_keyframe for r in one.trajectory]
        assert int(shell.state.l_count) == int(one.state.l_count)
        np.testing.assert_allclose(shell.trajectory_arrays()[1], one.trajectory_arrays()[1],
                                   atol=1e-3)


# ---------------------------------------------------------------------------
# IMU preintegration (csrc/preintegrate.cu)
# ---------------------------------------------------------------------------

PREINT_NOISE = (3.9939570888238808e-03, 1.5636343949698187e-03, 1e-4)  # ImuParams' defaults


def _imu_windows(seed, lanes, K, dev):
    """Masked IMU windows, numpy-seeded: a duplicate timestamp (dt = 0), a
    masked tail, and a sample whose rotation takes so3_exp's Taylor branch
    (|w dt| < 1e-5)."""
    rng = np.random.default_rng(seed)
    acc = (rng.normal(0, 0.5, (lanes, K, 3)) + [0.3, -0.2, 9.8]).astype(np.float32)
    gyr = rng.normal(0, 0.3, (lanes, K, 3)).astype(np.float32)
    dts = rng.uniform(0.002, 0.006, (lanes, K)).astype(np.float32)
    mask = rng.uniform(size=(lanes, K)) > 0.1
    mask[:, K - K // 8:] = False
    ba = rng.normal(0, 0.02, (lanes, 3)).astype(np.float32)
    bg = rng.normal(0, 0.002, (lanes, 3)).astype(np.float32)
    dts[:, min(3, K - 1)] = 0.0
    gyr[:, min(1, K - 1)] = bg + 3e-4
    return [torch.from_numpy(a).to(dev) for a in (acc, gyr, dts, mask, ba, bg)]


@pytest.mark.parametrize("lanes", [1, 8])
@pytest.mark.parametrize("K", [1, 13, 64, 256, 300])
def test_preintegrate_kernel_vs_plain(dev, K, lanes):
    """Bit for bit against the plain version on the card, one launch for all
    lanes; a second launch repeats; each lane equals its own launch."""
    from liorf_tpu_torch.ops import preintegrate as pop

    args = _imu_windows(K + lanes, lanes, K, dev)
    want = pop.preintegrate_plain(*args, *PREINT_NOISE)
    before = pop.preintegrate.launches
    got = pop.preintegrate(*args, *PREINT_NOISE)
    again = pop.preintegrate(*args, *PREINT_NOISE)
    assert pop.preintegrate.launches == before + 2
    for name, x, y, z in zip(pop.FIELDS, got, want, again):
        assert torch.equal(x, y) and torch.equal(x, z), (name, float((x - y).abs().max()))
    for b in range(lanes):
        one = pop.preintegrate(*(a[b:b + 1] for a in args), *PREINT_NOISE)
        assert all(torch.equal(x[b:b + 1], y) for x, y in zip(got, one)), b


def _windows_of_other_ends(seed, lanes, K, dev):
    """Lanes of K slots, each with its own count of valid samples at its own
    slots (of two or more lanes the first none, the last all), masked
    samples in the middle."""
    acc, gyr, dts, mask, ba, bg = _imu_windows(seed, lanes, K, "cpu")
    rng = np.random.default_rng(seed)
    for b in range(lanes):
        n = (0 if b == 0 else K) if lanes > 1 and b in (0, lanes - 1) else int(rng.integers(1, K + 1))
        keep = torch.zeros(K, dtype=torch.bool)
        keep[torch.from_numpy(rng.permutation(K)[:n])] = True
        mask[b] = keep
    return [a.to(dev) for a in (acc, gyr, dts, mask, ba, bg)]


def _bits_equal(x, y):
    """The same 32-bit patterns (the signs of zeros included)."""
    return torch.equal(x.contiguous().view(torch.int32), y.contiguous().view(torch.int32))


@pytest.mark.parametrize("lanes", [1, 8, 33])
@pytest.mark.parametrize("K", [1, 31, 32, 33, 64, 65, 256, 300, 2048])
def test_preintegrate_one_launch_any_window(dev, K, lanes):
    """Bit for bit against the plain version on the card (every bit, signs of
    zeros too) at windows of 1 to 2048 slots, lanes with other counts and
    slots of valid samples (one all masked), one kernel launch a call (the
    library's own count), the same lanes under torch.func.vmap alike; a
    second call queued behind the first repeats."""
    from liorf_tpu_torch.ops import preintegrate as pop

    args = _windows_of_other_ends(3 * K + lanes, lanes, K, dev)
    want = pop.preintegrate_plain(*args, *PREINT_NOISE)
    k0 = pop.kernel_launches()
    got = pop.preintegrate(*args, *PREINT_NOISE)
    again = pop.preintegrate(*args, *PREINT_NOISE)
    assert pop.kernel_launches() == k0 + 2
    vmapped = torch.func.vmap(lambda *a: tuple(
        x[0] for x in pop.preintegrate(*(t[None] for t in a), *PREINT_NOISE)))(*args)
    assert pop.kernel_launches() == k0 + 3
    for name, x, y, z, v in zip(pop.FIELDS, got, want, again, vmapped):
        assert _bits_equal(x, y) and _bits_equal(x, z) and _bits_equal(x, v), (
            name, float((x - y).abs().max()))


def test_preintegrate_on_every_card(dev):
    """The kernel's ~100 KB of dynamic shared memory is an opt-in of each
    device's context: a process that launches on one card and then on
    another gets the same bits from both (as the plain version on each)."""
    from liorf_tpu_torch.ops import preintegrate as pop

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    host = _imu_windows(11, 3, 64, "cpu")
    first = None
    for d in range(torch.cuda.device_count()):
        card = torch.device("cuda", d)
        args = [a.to(card) for a in host]
        got = pop.preintegrate(*args, *PREINT_NOISE)
        want = pop.preintegrate_plain(*args, *PREINT_NOISE)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), d
        got = [x.cpu() for x in got]
        first = first or got
        assert all(torch.equal(x, y) for x, y in zip(got, first)), d


def test_preintegrate_raises_on_what_the_kernel_does_not_take(dev):
    from liorf_tpu_torch.ops import preintegrate as pop

    args = _imu_windows(0, 2, 16, dev)
    bad = {0: args[0].double(), 3: args[3].float(), 1: args[1][:, :8], 4: args[4][:1],
           2: args[2].cpu()}
    for i, t in bad.items():
        with pytest.raises(ValueError):
            pop.preintegrate(*args[:i], t, *args[i + 1:], *PREINT_NOISE)
    with pytest.raises(ValueError):  # an empty window
        pop.preintegrate(*(a[:, :0] if a.dim() > 1 and i < 4 else a for i, a in enumerate(args)),
                         *PREINT_NOISE)


# ---------------------------------------------------------------------------
# the frame's front end: deskew (csrc/deskew.cu) and the ScanContext
# descriptor (csrc/scancontext.cu)
# ---------------------------------------------------------------------------

def _deskew_lanes(seed, lanes, K, N, dev):
    """Seeded scans and gyro windows: samples 5 ms apart from 0.3 s, a masked
    tail and a masked sample inside, points timed before, inside and after
    the timeline, 10 % of them masked out; lane 0's window is empty when
    there are several lanes."""
    rng = np.random.default_rng(seed)
    times = (0.3 + 0.005 * np.arange(K, dtype=np.float32))[None].repeat(lanes, 0)
    gyr = rng.normal(0, 0.5, (lanes, K, 3)).astype(np.float32)
    imask = np.arange(K)[None] < max(1, K - K // 8)
    imask = imask.repeat(lanes, 0)
    imask[:, K // 2] = K < 3
    if lanes > 1:
        imask[0] = False
    xyz = rng.uniform(-60, 60, (lanes, N, 3)).astype(np.float32)
    rel = rng.uniform(-0.02, 0.005 * K + 0.02, (lanes, N)).astype(np.float32)
    mask = rng.uniform(size=(lanes, N)) > 0.1
    start = np.full(lanes, 0.3 + 0.0025 * K, np.float32)
    return [torch.from_numpy(a).to(dev) for a in (xyz, rel, mask, start, times, gyr, imask)]


@pytest.mark.parametrize("lanes", [1, 8])
@pytest.mark.parametrize("K, N", [(1, 1000), (13, 4097), (64, 32768), (256, 2500), (2048, 300)])
def test_deskew_kernel_vs_plain(dev, K, N, lanes):
    """Bit for bit against the plain version on the card, one launch for all
    lanes; a second launch repeats; each lane equals its own launch."""
    from liorf_tpu_torch.ops import deskew as dk

    args = _deskew_lanes(K + N + lanes, lanes, K, N, dev)
    want = dk.deskew_plain(*args)
    before = dk.deskew.launches
    got = dk.deskew(*args)
    again = dk.deskew(*args)
    assert dk.deskew.launches == before + 2
    assert torch.equal(got, want), float((got - want).abs().max())
    assert torch.equal(got, again)
    for b in range(lanes):
        assert torch.equal(got[b:b + 1], dk.deskew(*(a[b:b + 1] for a in args))), b


def test_deskew_on_every_card(dev):
    """The kernel's dynamic shared memory is an opt-in of each device's
    context: the same bits from every card, as the plain version's."""
    from liorf_tpu_torch.ops import deskew as dk

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    host = _deskew_lanes(3, 3, 256, 5000, "cpu")
    first = None
    for d in range(torch.cuda.device_count()):
        args = [a.to(torch.device("cuda", d)) for a in host]
        got = dk.deskew(*args)
        assert torch.equal(got, dk.deskew_plain(*args)), d
        first = got.cpu() if first is None else first
        assert torch.equal(got.cpu(), first), d


def test_deskew_raises_on_what_the_kernel_does_not_take(dev):
    from liorf_tpu_torch.ops import deskew as dk

    args = _deskew_lanes(0, 2, 16, 100, dev)
    bad = {0: args[0].double(), 2: args[2].float(), 1: args[1][:, :50], 3: args[3][:1],
           4: args[4].cpu(), 6: args[6][:, :8]}
    for i, t in bad.items():
        with pytest.raises(ValueError):
            dk.deskew(*args[:i], t, *args[i + 1:])
    long = _deskew_lanes(0, 1, dk.MAX_K + 1, 100, dev)
    with pytest.raises(ValueError):
        dk.deskew(*long)


def _clouds(seed, lanes, N, dev):
    """Points out to 90 m with heights -2..6 m, 10 % masked out, a NaN, a +inf
    and a -inf height masked in, a point at the origin and one on a ring's
    edge."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-90, 90, (lanes, N, 3)).astype(np.float32)
    xyz[..., 2] = rng.uniform(-2, 6, (lanes, N))
    mask = rng.uniform(size=(lanes, N)) > 0.1
    if N >= 5:
        xyz[:, :5] = [[3, 1, np.nan], [20, 5, np.inf], [40, -3, -np.inf], [0, 0, 1], [8, 0, 2]]
        mask[:, :5] = True
    return torch.from_numpy(xyz).to(dev), torch.from_numpy(mask).to(dev)


@pytest.mark.parametrize("lanes", [1, 8])
@pytest.mark.parametrize("N", [1, 1000, 32768, 40001])
def test_descriptor_kernel_vs_plain(dev, N, lanes):
    """Bit for bit against the plain version on the card (a max is exact, so
    the atomics' order does not show), one launch for all lanes; repeats;
    each lane equals its own launch."""
    from liorf_tpu_torch.ops import scancontext as sc

    xyz, mask = _clouds(N + lanes, lanes, N, dev)
    want = sc.make_descriptor_plain(xyz, mask)
    before = sc.make_descriptor.launches
    got = sc.descriptors(xyz, mask)
    again = sc.descriptors(xyz, mask)
    assert sc.make_descriptor.launches == before + 2
    assert torch.equal(got, want), float((got - want).abs().max())
    assert torch.equal(got, again)
    for b in range(lanes):
        assert torch.equal(got[b:b + 1], sc.descriptors(xyz[b:b + 1], mask[b:b + 1])), b
    one = torch.func.vmap(sc.make_descriptor)(xyz, mask)
    assert torch.equal(one, got)


def test_descriptor_on_every_card(dev):
    from liorf_tpu_torch.ops import scancontext as sc

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    host = _clouds(5, 3, 20000, "cpu")
    first = None
    for d in range(torch.cuda.device_count()):
        xyz, mask = (a.to(torch.device("cuda", d)) for a in host)
        got = sc.descriptors(xyz, mask)
        assert torch.equal(got, sc.make_descriptor_plain(xyz, mask)), d
        first = got.cpu() if first is None else first
        assert torch.equal(got.cpu(), first), d


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("K, N", [(300, 255), (300, 33001), (2048, 257), (2048, 16385)])
def test_deskew_long_windows_one_launch(dev, K, N, lanes):
    """Windows of 300 and 2048 samples (the timeline on the whole block, a
    barrier a step) over point counts that are not multiples of the block:
    bit for bit against the plain version, one kernel launch a call by the
    library's own count, each lane as its own launch."""
    from liorf_tpu_torch.ops import deskew as dk

    args = _deskew_lanes(K + N, lanes, K, N, dev)
    want = dk.deskew_plain(*args)
    k0 = dk.kernel_launches()
    got = dk.deskew(*args)
    assert dk.kernel_launches() == k0 + 1
    assert torch.equal(got, want), float((got - want).abs().max())
    for b in range(lanes):
        assert torch.equal(got[b:b + 1], dk.deskew(*(a[b:b + 1] for a in args))), b


def test_descriptor_every_point_in_one_bin(dev):
    """Every point of every lane in one bin: every point's atomic on one
    shared word, every block's on one word of its lane's scratch; bit for
    bit against the plain version."""
    from liorf_tpu_torch.ops import scancontext as sc

    gen = torch.Generator().manual_seed(9)
    n, lanes = 40001, 3
    r = 10.5 + torch.rand((lanes, n), generator=gen)
    th = torch.deg2rad(1.0 + 4.0 * torch.rand((lanes, n), generator=gen))
    z = -2.0 + 8.0 * torch.rand((lanes, n), generator=gen)
    xyz = torch.stack([r * torch.cos(th), r * torch.sin(th), z], -1).to(dev)
    mask = (torch.rand((lanes, n), generator=gen) > 0.1).to(dev)
    got = sc.descriptors(xyz, mask)
    assert torch.equal(got, sc.make_descriptor_plain(xyz, mask))
    assert int((got != 0).sum()) == lanes


def test_descriptor_calls_in_a_row_leave_the_scratch_clean(dev):
    """Three calls in a row at 8, 1 and 8 lanes, each bit for bit against the
    plain version, one kernel launch a call: a merge scratch or an arrival
    counter left dirty by a call would show in the next."""
    from liorf_tpu_torch.ops import scancontext as sc

    for i, lanes in enumerate((8, 1, 8)):
        xyz, mask = _clouds(40 + i, lanes, 32768 if i != 1 else 1000, dev)
        k0 = sc.kernel_launches()
        got = sc.descriptors(xyz, mask)
        assert sc.kernel_launches() == k0 + 1, i
        assert torch.equal(got, sc.make_descriptor_plain(xyz, mask)), i


def test_descriptor_scratch_a_stream(dev):
    """Descriptor calls on two streams at once, interleaved with nothing
    between them: each stream merges into a scratch of its own, so every
    call is bit for bit the plain version's."""
    from liorf_tpu_torch.ops import scancontext as sc

    clouds = [_clouds(60 + i, 8, 32768, dev) for i in range(2)]
    want = [sc.make_descriptor_plain(*c) for c in clouds]
    cur = torch.cuda.current_stream(dev)
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    for s in streams:
        s.wait_stream(cur)
    got = [[], []]
    for _ in range(4):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i].append(sc.descriptors(*clouds[i]))
    for s in streams:
        cur.wait_stream(s)
    scratch = [sc.lane_scratch(dev, 8, s.cuda_stream) for s in streams]
    assert scratch[0] != scratch[1]
    for i in range(2):
        for g in got[i]:
            assert torch.equal(g, want[i]), i


@pytest.mark.parametrize("lanes", [1, 8])
def test_deskew_reads_packed_lanes_where_they_lie(dev, lanes):
    """Inputs as a multistream tick hands them over, slices of one packed
    frame buffer a lane (each lane's block contiguous, the lanes apart) and a
    window mask broadcast over the lanes: bit for bit against the plain
    version on contiguous copies, one launch, nothing copied."""
    from liorf_tpu_torch.ops import deskew as dk

    N, K = 16384, 64
    xyz, rel, mask, start, times, gyr, imask = _deskew_lanes(lanes + 11, lanes, K, N, dev)
    F = 4 * N + 1 + 4 * K + 5
    buf = torch.zeros((lanes, F), device=dev)
    buf[:, :3 * N] = xyz.reshape(lanes, -1)
    buf[:, 3 * N:4 * N] = rel
    buf[:, 4 * N] = start
    buf[:, 4 * N + 1:4 * N + 1 + K] = times
    buf[:, 4 * N + 1 + K:4 * N + 1 + 4 * K] = gyr.reshape(lanes, -1)
    g0 = 4 * N + 1 + K
    packed = (buf[:, :3 * N].view(lanes, N, 3), buf[:, 3 * N:4 * N], mask, buf[:, 4 * N],
              buf[:, 4 * N + 1:g0], buf[:, g0:g0 + 3 * K].view(lanes, K, 3),
              imask[-1:].expand(lanes, K))
    assert all(a is b for a, b in zip(dk._checked(*packed), packed))
    want = dk.deskew_plain(*(t.contiguous() for t in packed))
    k0 = dk.kernel_launches()
    got = dk.deskew(*packed)
    assert dk.kernel_launches() == k0 + 1
    assert torch.equal(got, want), float((got - want).abs().max())
