"""Tests that need an NVIDIA GPU (marker ``gpu``): the CUDA kernels against
their plain versions for every k, and the scan matcher on the card against
the CPU. They skip where there is no card; run them on a GPU machine with

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


@pytest.mark.parametrize("k", range(1, 9))
def test_topk_candidates_kernel_vs_plain(dev, k):
    gen = torch.Generator(device=dev).manual_seed(k)
    n, c = 777, 27 * 8 + k
    q = torch.randn((n, 3), generator=gen, device=dev) * 10
    cand = q[:, None, :] + torch.randn((n, c, 3), generator=gen, device=dev)
    cand[:, 1] = cand[:, 0]  # ties
    bad = torch.rand((n, c), generator=gen, device=dev) < 0.2
    bad[3] = True
    cand = torch.where(bad[..., None], torch.full_like(cand, 1e30), cand).contiguous()
    idx = torch.randint(0, 9999, (n, c), generator=gen, device=dev, dtype=torch.int32)
    before = knn_cuda.topk_candidates.launches
    d_k, i_k = knn_cuda.topk_candidates(q, cand, idx, k)
    assert knn_cuda.topk_candidates.launches == before + 1
    d_p, i_p = knn_cuda.topk_candidates_plain(q, cand, idx, k)
    assert torch.equal(d_k, d_p) and torch.equal(i_k, i_p)


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


def test_wrappers_raise_on_what_the_kernel_does_not_take(dev):
    q = torch.zeros((4, 3), device=dev)
    ok_idx = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        knn_cuda.topk_candidates(q, torch.zeros((4, 8, 3), device=dev), ok_idx.long(), 2)
    with pytest.raises(ValueError):  # candidate tensor on the CPU
        knn_cuda.topk_candidates(q, torch.zeros((4, 8, 3)), ok_idx, 2)
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
