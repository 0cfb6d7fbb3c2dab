"""Plain PyTorch versions of the two CUDA k-NN kernels vs the Pallas kernels
(interpret mode), their XLA references and the JAX ``knn_grid``, on the same
numpy inputs.

On the CPU the port's wrappers dispatch to the plain versions (the tensors
lie on the CPU); the CUDA kernels themselves are held against these same
plain versions on the card by ``chip_smoke.py`` and ``test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from liorf_tpu.ops import knn as jknn
from liorf_tpu.ops.knn_pallas import knn_bruteforce_pallas, topk_candidates_pallas
from liorf_tpu_torch.ops import knn as tknn
from liorf_tpu_torch.ops import knn_cuda


def _t(a):
    return torch.tensor(np.asarray(a))


def _grid_case(seed, n=512, m=6000, bucket=8):
    rng = np.random.default_rng(seed)
    # two planes, ~1 point per 0.33 m voxel -> cells of a few points
    map_xyz = rng.uniform(-10, 10, (m, 3)).astype(np.float32)
    map_xyz[: m // 2, 2] = 0.0
    map_xyz[m // 2 :, 0] = 5.0
    map_mask = rng.uniform(size=m) > 0.05
    q = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    q[: n // 2, 2] = rng.normal(0, 0.1, n // 2)
    q[n // 2 :, 0] = 5.0 + rng.normal(0, 0.1, n - n // 2)
    qmask = rng.uniform(size=n) > 0.1
    return map_xyz, map_mask, q, qmask, bucket


def _xla_tail(queries, cand_xyz, cand_idx, k):
    """The XLA tail of knn_grid (knn.py:175-185) on pre-masked candidates."""
    diff = cand_xyz - queries[:, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    d2 = jnp.where(d2 < 0.5e30, d2, jnp.inf)
    vals, pos = jax.lax.top_k(-d2, k)
    idx = jnp.take_along_axis(cand_idx, pos, axis=1)
    d = -vals
    return d, jnp.where(jnp.isfinite(d), idx, 0)


def _assert_knn_equal(d_t, i_t, d_ref, i_ref, rtol, atol, min_idx_agree=1.0):
    d_t, i_t = d_t.numpy(), i_t.numpy()
    d_ref, i_ref = np.asarray(d_ref), np.asarray(i_ref)
    assert d_t.shape == d_ref.shape and i_t.shape == i_ref.shape
    fin = np.isfinite(d_ref)
    # missing neighbours agree exactly: (+inf, 0) on both sides
    assert (np.isfinite(d_t) == fin).all()
    assert (i_t[~fin] == 0).all() and (i_ref[~fin] == 0).all()
    np.testing.assert_allclose(d_t[fin], d_ref[fin], rtol=rtol, atol=atol)
    agree = (i_t == i_ref)[fin].mean() if fin.any() else 1.0
    assert agree >= min_idx_agree, agree


@pytest.mark.parametrize("seed", [0, 1])
def test_k1_plain_vs_pallas_and_xla(seed):
    """K1: N=512, C=27*8. d2 rtol 1e-5 (same direct-difference form, only
    the order of the three squares' sum may differ); indices exact — the
    inputs are continuous random, so no exact ties."""
    n, c, k = 512, 27 * 8, 5
    rng = np.random.default_rng(seed)
    q = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    cand_xyz = (q[:, None, :] + rng.normal(0, 1.0, (n, c, 3))).astype(np.float32)
    cand_idx = rng.integers(0, 50000, (n, c)).astype(np.int32)
    valid = rng.uniform(size=(n, c)) > 0.3
    valid[7] = False  # a row with nothing valid
    valid[8, :3], valid[8, 3:] = True, False  # a row with fewer than k valid
    masked = np.where(valid[..., None], cand_xyz, np.float32(1e30))

    d_t, i_t = knn_cuda.topk_candidates(_t(q), _t(masked), _t(cand_idx), k=k)
    assert i_t.dtype == torch.int32 and d_t.dtype == torch.float32
    d_p, i_p = topk_candidates_pallas(
        jnp.asarray(q), jnp.asarray(masked), jnp.asarray(cand_idx), k=k,
        tile_q=128, interpret=True,
    )
    _assert_knn_equal(d_t, i_t, d_p, i_p, rtol=1e-5, atol=0)
    d_x, i_x = _xla_tail(jnp.asarray(q), jnp.asarray(masked), jnp.asarray(cand_idx), k)
    _assert_knn_equal(d_t, i_t, d_x, i_x, rtol=1e-5, atol=0)
    assert np.isinf(d_t.numpy()[7]).all() and (i_t.numpy()[7] == 0).all()
    assert np.isfinite(d_t.numpy()[8]).sum() == 3


def test_k1_ties_take_lower_position():
    """Duplicate candidates: the first occurrence wins, as the kernels'
    first-index arg-min does."""
    q = np.zeros((2, 3), np.float32)
    cand = np.zeros((2, 6, 3), np.float32)
    cand[:, :, 0] = [3.0, 1.0, 1.0, 2.0, 1.0, 2.0]
    idx = np.arange(12, dtype=np.int32).reshape(2, 6) + 100
    d, i = knn_cuda.topk_candidates_plain(_t(q), _t(cand), _t(idx), k=4)
    np.testing.assert_array_equal(i.numpy()[0], [101, 102, 104, 103])
    np.testing.assert_array_equal(d.numpy()[0], [1.0, 1.0, 1.0, 4.0])
    d_p, i_p = topk_candidates_pallas(
        jnp.asarray(q), jnp.asarray(cand), jnp.asarray(idx), k=4, tile_q=8,
        interpret=True,
    )
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_p))


@pytest.mark.parametrize("seed", [0, 1])
def test_knn_grid_vs_jax(seed):
    """knn_grid end to end (grid build, 27-run gather, K1 plain tail) vs the
    JAX knn_grid on the CPU backend: indices exact, d2 rtol 1e-5."""
    map_xyz, map_mask, q, qmask, bucket = _grid_case(seed)
    origin = np.array([0.5, -0.25, 0.1], np.float32)
    jg = jknn.build_grid(jnp.asarray(map_xyz), jnp.asarray(map_mask), jnp.asarray(origin), 1.0)
    tg = tknn.build_grid(_t(map_xyz), _t(map_mask), _t(origin), 1.0)
    np.testing.assert_array_equal(tg.keys.numpy(), np.asarray(jg.keys))
    np.testing.assert_array_equal(tg.xyz.numpy(), np.asarray(jg.xyz))
    np.testing.assert_array_equal(tg.mask.numpy(), np.asarray(jg.mask))
    d_j, i_j = jknn.knn_grid(jg, jnp.asarray(q), jnp.asarray(qmask), k=5, bucket=bucket)
    d_t, i_t = tknn.knn_grid(tg, _t(q), _t(qmask), k=5, bucket=bucket)
    _assert_knn_equal(d_t, i_t, d_j, i_j, rtol=1e-5, atol=0)
    ov_j = jknn.cell_overflow_count(jg, jnp.asarray(q), jnp.asarray(qmask), bucket)
    ov_t = tknn.cell_overflow_count(tg, _t(q), _t(qmask), bucket)
    assert int(ov_t) == int(ov_j)
    assert tknn.exact_bucket(1.0, 0.3) == jknn.exact_bucket(1.0, 0.3) == 40


def _sentinel_case():
    """Queries beyond the 1024-cell range with query_mask true: their key is
    the sentinel, whose centre run holds the grid's invalid points."""
    map_xyz, map_mask, q, qmask, bucket = _grid_case(5, n=64, m=2000)
    map_xyz[:10, 0] = 900.0  # out of range: sentinel keys although mask is true
    q[:4] = [[700.0, 0.0, 0.0], [-800.0, 1.0, 2.0], [0.0, 0.0, 1e4], [1e9, 5.0, 5.0]]
    qmask[:4] = True
    return map_xyz, map_mask, q, qmask, bucket


def _dense_cell_case():
    """One cell holding far more points than the bucket: truncated runs."""
    map_xyz, map_mask, q, qmask, bucket = _grid_case(6, n=128, m=3000)
    rng = np.random.default_rng(6)
    map_xyz[:200] = (rng.uniform(0, 1, (200, 3)) + [2.0, 3.0, 0.0]).astype(np.float32)
    map_mask[:200] = True
    q[:40] = (rng.uniform(0, 1, (40, 3)) + [2.0, 3.0, 0.0]).astype(np.float32)
    return map_xyz, map_mask, q, qmask, bucket


def _duplicates_case():
    """Every map point twice (and a third copy of some): exact ties."""
    map_xyz, map_mask, q, qmask, bucket = _grid_case(7, n=128, m=1500)
    map_xyz = np.concatenate([map_xyz, map_xyz, map_xyz[:300]])
    map_mask = np.concatenate([map_mask, map_mask, map_mask[:300]])
    return map_xyz, map_mask, q, qmask, 16


def _masked_case():
    map_xyz, map_mask, q, qmask, bucket = _grid_case(8, n=128, m=2000)
    qmask[::3] = False
    return map_xyz, map_mask, q, qmask, bucket


_GRID_CASES = {
    "k1": (lambda: _grid_case(2, n=128, m=2000), 1),
    "k5": (lambda: _grid_case(3, n=128, m=2000), 5),
    "k8": (lambda: _grid_case(4, n=128, m=2000), 8),
    "truncated_cell": (_dense_cell_case, 5),
    "masked_query": (_masked_case, 5),
    "out_of_range_query": (_sentinel_case, 5),
    "duplicate_points": (_duplicates_case, 8),
}


@pytest.mark.parametrize("case", list(_GRID_CASES))
def test_knn_grid_topk_plain_vs_jax(case):
    """knn_grid_topk_plain through tknn.knn_grid vs the JAX knn_grid on the
    CPU backend, case by case: indices exact, d2 rtol 1e-5."""
    make, k = _GRID_CASES[case]
    map_xyz, map_mask, q, qmask, bucket = make()
    origin = np.array([0.25, -0.5, 0.125], np.float32)
    jg = jknn.build_grid(jnp.asarray(map_xyz), jnp.asarray(map_mask), jnp.asarray(origin), 1.0)
    tg = tknn.build_grid(_t(map_xyz), _t(map_mask), _t(origin), 1.0)
    np.testing.assert_array_equal(tg.keys.numpy(), np.asarray(jg.keys))
    d_j, i_j = jknn.knn_grid(jg, jnp.asarray(q), jnp.asarray(qmask), k=k, bucket=bucket)
    d_t, i_t = tknn.knn_grid(tg, _t(q), _t(qmask), k=k, bucket=bucket)
    assert d_t.shape == (len(q), k) and i_t.dtype == torch.int32
    _assert_knn_equal(d_t, i_t, d_j, i_j, rtol=1e-5, atol=0)
    d_t, i_t = d_t.numpy(), i_t.numpy()
    assert (np.isinf(d_t[~qmask]).all()) and (i_t[~qmask] == 0).all()
    keys = tg.keys.numpy()
    if case == "out_of_range_query":
        # the reference's behaviour, reproduced: an out-of-range query with
        # query_mask true finds the grid's invalid points (sentinel run)
        assert np.isfinite(d_t[:4]).all()
        assert (keys[i_t[:4]] == 2**31 - 1).all()
        assert (keys[i_t[4:][np.isfinite(d_t[4:])]] != 2**31 - 1).all()
    if case == "truncated_cell":
        ov_j = jknn.cell_overflow_count(jg, jnp.asarray(q), jnp.asarray(qmask), bucket)
        ov_t = tknn.cell_overflow_count(tg, _t(q), _t(qmask), bucket)
        assert int(ov_t) == int(ov_j) > 0
    if case == "duplicate_points":
        fin = np.isfinite(d_t)
        tie = np.zeros_like(fin[:, 1:])
        tie[fin[:, 1:]] = np.diff(d_t, axis=1)[fin[:, 1:]] == 0
        assert tie.any()  # ties were met
        # equal distances come out in increasing grid index
        assert (np.diff(i_t, axis=1)[tie] > 0).all()


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("m", [1000, 5000])
def test_k2_plain_vs_pallas_and_xla(k, m):
    """K2: N=300. The JAX side uses the |q|^2+|t|^2-2q.t expansion, the port
    direct differences, so d2 agrees to atol 1e-3 (the tolerance of
    tests/test_knn_pallas.py) and near-ties may swap: >= 99 % equal indices."""
    n = 300
    rng = np.random.default_rng(m + k)
    map_xyz = rng.uniform(-20, 20, (m, 3)).astype(np.float32)
    q = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    map_mask = rng.uniform(size=m) > 0.1
    qmask = rng.uniform(size=n) > 0.1
    d_t, i_t = knn_cuda.knn_bruteforce(_t(map_xyz), _t(map_mask), _t(q), _t(qmask), k=k)
    assert i_t.dtype == torch.int32
    args = (jnp.asarray(map_xyz), jnp.asarray(map_mask), jnp.asarray(q), jnp.asarray(qmask))
    d_p, i_p = knn_bruteforce_pallas(*args, k=k, tile_q=128, tile_m=512, interpret=True)
    _assert_knn_equal(d_t, i_t, d_p, i_p, rtol=0, atol=1e-3, min_idx_agree=0.99)
    d_x, i_x = jknn.knn_bruteforce(*args, k=k, tile=512)
    _assert_knn_equal(d_t, i_t, d_x, i_x, rtol=0, atol=1e-3, min_idx_agree=0.99)
    # against float64 brute force: the port's direct differences are exact
    # to f32 rounding
    d64 = ((q[:, None, :].astype(np.float64) - map_xyz[None].astype(np.float64)) ** 2).sum(-1)
    d64[:, ~map_mask] = np.inf
    ref = np.sort(d64, axis=1)[:, :k]
    np.testing.assert_allclose(d_t.numpy()[qmask], ref[qmask], rtol=1e-5)


def test_k2_all_masked_and_ragged():
    rng = np.random.default_rng(3)
    m, n = 257, 65  # not multiples of any tile
    map_xyz = rng.uniform(-5, 5, (m, 3)).astype(np.float32)
    q = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    d, i = knn_cuda.knn_bruteforce(
        _t(map_xyz), torch.zeros(m, dtype=torch.bool), _t(q), torch.ones(n, dtype=torch.bool), k=3
    )
    assert torch.isinf(d).all() and (i == 0).all()
    # two valid targets, k=3: the third neighbour is missing
    mask = np.zeros(m, bool)
    mask[[5, 200]] = True
    d, i = knn_cuda.knn_bruteforce(_t(map_xyz), _t(mask), _t(q), torch.ones(n, dtype=torch.bool), k=3)
    assert torch.isfinite(d[:, :2]).all() and torch.isinf(d[:, 2]).all()
    assert set(np.unique(i[:, :2].numpy())) == {5, 200} and (i[:, 2] == 0).all()
    d_p, i_p = knn_bruteforce_pallas(
        jnp.asarray(map_xyz), jnp.asarray(mask), jnp.asarray(q), jnp.ones(n, bool),
        k=3, tile_q=64, tile_m=128, interpret=True,
    )
    _assert_knn_equal(d, i, d_p, i_p, rtol=0, atol=1e-3)


def test_wrappers_reject_bad_input_and_count_no_cpu_launch():
    q = torch.zeros((4, 3))
    with pytest.raises(ValueError):
        knn_cuda.topk_candidates(q, torch.zeros((4, 8, 3)), torch.zeros((4, 8), dtype=torch.int32), k=9)
    with pytest.raises(ValueError):
        knn_cuda.knn_bruteforce(q, torch.ones(4, dtype=torch.bool), q, torch.ones(4, dtype=torch.bool), k=0)
    knn_cuda.reset_launch_counts()
    knn_cuda.knn_bruteforce(q, torch.ones(4, dtype=torch.bool), q, torch.ones(4, dtype=torch.bool), k=1)
    knn_cuda.topk_candidates(q, torch.zeros((4, 8, 3)), torch.zeros((4, 8), dtype=torch.int32), k=2)
    grid = tknn.build_grid(q, torch.ones(4, dtype=torch.bool), torch.zeros(3), 1.0)
    knn_cuda.knn_grid_topk(grid, q, torch.ones(4, dtype=torch.bool), k=2, bucket=4)
    with pytest.raises(ValueError):
        knn_cuda.knn_grid_topk(grid, q, torch.ones(4, dtype=torch.bool), k=2, bucket=0)
    # the plain versions are not kernel launches
    assert knn_cuda.launch_counts() == {"knn_grid_topk": 0, "knn_bruteforce": 0}
