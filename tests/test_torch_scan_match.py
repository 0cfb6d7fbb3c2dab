"""scan_to_map parity on the exact inputs of ``__graft_entry__.entry()``."""

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from liorf_tpu.ops.scan_match import ScanMatchParams as JParams
from liorf_tpu.ops.scan_match import scan_to_map as jscan_to_map
from liorf_tpu_torch import convert
from liorf_tpu_torch.ops import knn as tknn
from liorf_tpu_torch.ops import knn_cuda
from liorf_tpu_torch.ops.scan_match import ScanMatchParams, scan_to_map


@pytest.fixture(scope="module")
def entry_case():
    _, (scan, mask, grid, init) = graft.entry()
    params = JParams(knn_bucket=40)
    ref = jscan_to_map(scan, mask, grid, init, params)
    return scan, mask, grid, init, ref


def test_scan_to_map_matches_jax(entry_case):
    """Same inputs, grid carried across by convert. The GN solve is a 6x6
    f32 system fed by ~4k residuals: pose within 1e-4 (m, rad), the same
    iteration count and flags; num_matched within 1 % (a point sitting on a
    gate threshold may flip)."""
    scan, mask, grid, init, ref = entry_case
    tgrid = convert.grid_from_arrays({k: np.asarray(v) for k, v in grid._asdict().items()}, device="cpu")
    params = convert.scan_match_params(JParams(knn_bucket=40)._asdict())
    assert params == ScanMatchParams(knn_bucket=tknn.exact_bucket(1.0, 0.3))
    knn_cuda.reset_launch_counts()
    res = scan_to_map(
        torch.tensor(np.asarray(scan)), torch.tensor(np.asarray(mask)), tgrid,
        torch.tensor(np.asarray(init)), params,
    )
    np.testing.assert_allclose(res.pose.numpy(), np.asarray(ref.pose), atol=1e-4)
    assert int(res.iters) == int(ref.iters)
    assert bool(res.degenerate) == bool(ref.degenerate)
    assert bool(res.converged) == bool(ref.converged) is True
    assert abs(int(res.num_matched) - int(ref.num_matched)) <= 0.01 * int(ref.num_matched)
    assert knn_cuda.launch_counts()["knn_grid_topk"] == 0  # CPU: plain version


def test_scan_to_map_grid_built_by_port(entry_case):
    """The same, with the grid built by the port's own build_grid."""
    scan, mask, grid, init, ref = entry_case
    rng = np.random.default_rng(0)
    map_pts = []
    for axis, offset in [(2, 0.0), (0, -10.0), (0, 10.0), (1, -10.0), (1, 10.0)]:
        p = rng.uniform(-10, 10, size=(4096, 3))
        p[:, axis] = offset
        map_pts.append(p)
    map_xyz = torch.tensor(np.concatenate(map_pts).astype(np.float32))
    tgrid = tknn.build_grid(map_xyz, torch.ones(len(map_xyz), dtype=torch.bool), torch.zeros(3), 1.0)
    np.testing.assert_array_equal(tgrid.keys.numpy(), np.asarray(grid.keys))
    res = scan_to_map(
        torch.tensor(np.asarray(scan)), torch.tensor(np.asarray(mask)), tgrid,
        torch.tensor(np.asarray(init)), ScanMatchParams(knn_bucket=40),
    )
    np.testing.assert_allclose(res.pose.numpy(), np.asarray(ref.pose), atol=1e-4)
    assert int(res.iters) == int(ref.iters)


def test_scan_to_map_too_few_points():
    """Fewer than min_points matches: no update, not converged, one pass."""
    grid = tknn.build_grid(
        torch.zeros((64, 3)), torch.zeros(64, dtype=torch.bool), torch.zeros(3), 1.0
    )
    init = torch.tensor([0.0, 0.0, 0.1, 1.0, 2.0, 3.0])
    res = scan_to_map(torch.randn(128, 3, generator=torch.Generator().manual_seed(0)),
                      torch.ones(128, dtype=torch.bool), grid, init)
    assert int(res.iters) == 1 and not bool(res.converged) and int(res.num_matched) == 0
    np.testing.assert_array_equal(res.pose.numpy(), init.numpy())
