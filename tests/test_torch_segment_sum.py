"""The fixed-order reductions (``ops/segment_sum.py``) that replace the
card's atomic scatter-adds and its length-shaped dot products: the segment
sum's plain version against JAX's ``.at[].add`` and an explicit loop, its
vmap rule, ``SegmentPlan`` on CPU tensors (the index_adds it stands for),
the fixed-order dot's bound and padding invariance (the order the PCG kernel
of ``ops/pcg.py`` keeps), and on the card (marker ``gpu``) the kernel
against float64, its plain version and itself, and the pose-graph solve's
per-row operations and its result unmoved by the ring capacity around
them. Without JAX on the card:

    python -m pytest tests/test_torch_segment_sum.py -m gpu -q --noconftest
"""

import numpy as np
import pytest
import torch

from liorf_tpu_torch.ops import segment_sum as ss


def _case(rng, lanes, m, c, s, with_perm):
    """Rows [lanes, m, c] and keys sorted per lane in [0, s); with a perm,
    the rows are unsorted and perm is a stable argsort of their keys."""
    src = rng.normal(size=(lanes, m, c)).astype(np.float32)
    raw = rng.integers(0, s, size=(lanes, m))
    raw[:, : m // 4] = s - 1  # one long segment
    if with_perm:
        perm = np.argsort(raw, axis=1, kind="stable")
        keys = np.take_along_axis(raw, perm, 1)
        return torch.tensor(src), torch.tensor(perm), torch.tensor(keys), raw
    keys = np.sort(raw, axis=1)
    return torch.tensor(src), None, torch.tensor(keys), keys


@pytest.mark.parametrize("with_perm", [False, True], ids=["sorted_rows", "perm"])
def test_plain_matches_jax_and_a_loop(with_perm):
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    s = 37
    src, perm, keys, raw = _case(rng, 3, 200, 5, s, with_perm)
    out = ss.segment_sum_plain(src, perm, keys, s).numpy()
    for b in range(3):
        ref = np.zeros((s, 5), np.float32)
        rows = src[b].numpy() if perm is None else src[b].numpy()[perm[b].numpy()]
        for p, k in enumerate(keys[b].numpy()):
            ref[k] += rows[p]
        np.testing.assert_array_equal(out[b], ref)
        j = jnp.zeros((s, 5), jnp.float32).at[jnp.asarray(raw[b])].add(jnp.asarray(src[b].numpy()))
        np.testing.assert_allclose(out[b], np.asarray(j), rtol=1e-6, atol=1e-5)
    assert out.shape == (3, s, 5)


def test_vmap_rule_folds_lanes_into_one_call():
    """Under torch.func.vmap (the multistream lane axis) the op sees one
    stacked call; batched and unbatched arguments mix."""
    rng = np.random.default_rng(1)
    s = 11
    src, perm, keys, _ = _case(rng, 4, 60, 3, s, True)
    want = ss.segment_sum_plain(src, perm, keys, s)

    def one(x, p, k):
        return ss._segment_sum_op(x[None], p[None], k[None], s, ss.segment_offsets(k[None], s))[0]

    np.testing.assert_array_equal(torch.func.vmap(one)(src, perm, keys).numpy(), want.numpy())
    shared = torch.func.vmap(one, in_dims=(0, None, None))(src, perm[0], keys[0])
    np.testing.assert_array_equal(
        shared[2].numpy(), ss.segment_sum_plain(src[2:3], perm[:1], keys[:1], s)[0].numpy())


def test_segment_plan_on_cpu_is_the_index_adds():
    """On CPU tensors a plan is the chained index_adds (bit for bit, under
    vmap too), so the CPU parity bounds of the voxel filter and the pose
    graph do not move."""
    rng = np.random.default_rng(2)
    K = 9
    idx = [torch.tensor(rng.integers(0, K, size=n)) for n in (14, 14, 3, 1)]
    vals = [torch.tensor(rng.normal(size=(len(i), 6, 6)).astype(np.float32)) for i in idx]
    want = torch.zeros((K, 6, 6))
    for i, v in zip(idx, vals):
        want = want.index_add(0, i, v)
    plan = ss.SegmentPlan(idx, K)
    assert not plan.on_card
    assert torch.equal(plan.sum(vals), want)
    stacked = [torch.stack([v, 2 * v]) for v in vals]
    got = torch.func.vmap(lambda *vs: ss.SegmentPlan(idx, K).sum(list(vs)))(*stacked)
    assert torch.equal(got[0], want) and torch.equal(got[1], 2 * want)


def test_fixed_dot_plain_order_and_padding():
    """The fixed-order dot: within n 2^-24 sum|a c| of a float64 dot at
    every length, and zero padding (a ring's unused slots) changes no bit of
    it, where torch.sum moves (the pose graph's PCG kernel sums in this
    order, so a grown ring solves as a large one; its vmap rule is held in
    tests/test_torch_pcg.py)."""
    rng = np.random.default_rng(5)
    for n in (0, 1, 31, 32, 33, 1200, 6144):
        a, c = (torch.tensor(rng.normal(size=(2, n)).astype(np.float32)) for _ in range(2))
        got = ss.fixed_dot_plain(a, c).double()
        prod = a.double() * c.double()
        bound = n * 2.0**-24 * prod.abs().sum(-1)  # n roundings: the products and the sums
        assert bool(((got - prod.sum(-1)).abs() <= bound).all()), n
    a, c = (torch.tensor(rng.normal(size=(1, 1200)).astype(np.float32)) for _ in range(2))
    vals = set()
    for n in (1200, 1536, 6144, 49152):
        pa, pc = torch.zeros((1, n)), torch.zeros((1, n))
        pa[:, :1200], pc[:, :1200] = a, c
        vals.add(float(ss.fixed_dot_plain(pa, pc)))
    assert len(vals) == 1


@pytest.fixture
def dev():
    # decided here, not at import: every xdist worker must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("with_perm", [False, True], ids=["sorted_rows", "perm"])
def test_kernel_against_float64_and_itself(dev, with_perm):
    rng = np.random.default_rng(3)
    s = 1001
    src, perm, keys, _ = _case(rng, 3, 20011, 7, s, with_perm)
    src, keys = src.to(dev), keys.to(dev)
    perm = None if perm is None else perm.to(dev)
    before = ss.segment_sum.launches
    a = ss.segment_sum(src, perm, keys, s)
    b = ss.segment_sum(src, perm, keys, s)
    assert ss.segment_sum.launches == before + 2
    assert torch.equal(a, b)  # repeatable
    ref = ss.segment_sum_plain(src.double(), perm, keys, s)
    torch.testing.assert_close(a.double(), ref, rtol=1e-5, atol=1e-3)
    # the CPU's sequential order: equal to the plain version there
    cpu = ss.segment_sum_plain(src.cpu(), None if perm is None else perm.cpu(), keys.cpu(), s)
    assert torch.equal(a.cpu(), cpu)


@pytest.mark.gpu
def test_vmap_on_the_card_is_one_launch(dev):
    rng = np.random.default_rng(4)
    s = 64
    src, perm, keys, _ = _case(rng, 5, 3000, 6, s, True)
    src, perm, keys = src.to(dev), perm.to(dev), keys.to(dev)
    before = ss.segment_sum.launches
    got = torch.func.vmap(lambda x, p, k: ss.segment_sum(x[None], p[None], k[None], s)[0])(src, perm, keys)
    assert ss.segment_sum.launches == before + 1
    assert torch.equal(got, ss.segment_sum(src, perm, keys, s))


# The solve's per-row operations on the card: a row's bits must not depend
# on the batch around it (the ring capacity), or a session whose rings grew
# parts from one that started with large rings. Each takes the first rows of
# one seeded batch of 4096.
def _row_ops(dev):
    from liorf_tpu_torch.core import se3
    from liorf_tpu_torch.graph import pose_graph as pg

    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn((4096, *shape), generator=g, device=dev)

    R = se3.so3_exp(0.5 * rand(3))
    t, w, J, r, v, M = rand(3), 0.1 * rand(6), rand(6, 6), rand(6), rand(6), rand(6, 6)
    spd = M @ M.transpose(1, 2) + torch.eye(6, device=dev)
    return {
        "jt": lambda n: pg._jt(J[:n], r[:n]),
        "bmv": lambda n: pg._bmv(J[:n], v[:n]),
        "jtj": lambda n: pg._jtj(J[:n]),
        "inv_ex": lambda n: torch.linalg.inv_ex(spd[:n])[0],
        "so3_exp": lambda n: se3.so3_exp(w[:n, :3]),
        "so3_log": lambda n: se3.so3_log(R[:n]),
        "euler_to_rot": lambda n: se3.euler_to_rot(w[:n, :3]),
        "rot_to_euler": lambda n: se3.rot_to_euler(R[:n]),
        "se3_retract": lambda n: se3.se3_retract(R[:n], t[:n], w[:n])[0],
    }


@pytest.mark.gpu
# The factors' linearization (between, GPS, prior) is one kernel since it
# stopped going through jacfwd's batched products: its case is
# tests/test_torch_linearize.py::test_factor_bits_ignore_the_batch_around_them.
@pytest.mark.parametrize("op", ["jt", "bmv", "jtj", "inv_ex", "so3_exp", "so3_log", "euler_to_rot",
                                "rot_to_euler", "se3_retract"])
def test_solve_rows_ignore_the_batch_around_them(dev, op):
    f = _row_ops(dev)[op]
    for rows, sizes in ((8, (16, 24, 32, 40, 64, 80, 128, 144, 300, 1032, 1152, 2048)),
                        (300, (1000, 1032, 2048))):
        alone = f(rows)
        for n in sizes:
            assert torch.equal(f(n)[:rows], alone), (op, rows, n)


@pytest.mark.gpu
@pytest.mark.parametrize("n, capacities", [(200, (256, 1024)), (12, (16, 1024))],
                         ids=["200_at_256_and_1024", "12_at_16_and_1024"])
def test_solve_is_the_same_at_any_capacity(dev, n, capacities):
    """One graph (a noisy chain of n keyframes, a loop factor every 40, GPS
    on every 25th) solved at two node capacities: bit-equal."""
    from liorf_tpu_torch.core import se3
    from liorf_tpu_torch.graph import pose_graph as pg

    gen = torch.Generator(device=dev).manual_seed(1)
    truth_all = torch.cumsum(torch.randn((1024, 3), generator=gen, device=dev), 0)
    rot_all = se3.so3_exp(0.05 * torch.randn((1024, 3), generator=gen, device=dev))
    noise_all = torch.randn((1024 + 8, 3), generator=gen, device=dev)
    start_all = truth_all + 0.1 * torch.randn((1024, 3), generator=gen, device=dev)
    solved = []
    for K in capacities:
        idx = torch.arange(K, device=dev)
        truth = truth_all[:K]
        loops = torch.arange(0, max(n - 40, 0), 40, device=dev)
        pad = torch.zeros(8 - len(loops), dtype=torch.int64, device=dev)
        e_i = torch.cat([idx, loops, pad])
        e_j = torch.cat([torch.clamp(idx + 1, max=K - 1), loops + 40, pad])
        noise = torch.cat([noise_all[:K], noise_all[1024:]])
        gi = torch.arange(0, 16 * 25, 25, device=dev).clamp(max=K - 1)
        graph = pg.empty_graph(K, K + 8, 16, device=dev)._replace(
            ts=start_all[:K], Rs=rot_all[:K], node_mask=idx < n, e_i=e_i, e_j=e_j,
            e_tm=truth[e_j] - truth[e_i] + 0.01 * noise,
            e_mask=torch.cat([idx + 1 < n, torch.arange(8, device=dev) < len(loops)]),
            g_i=gi, g_t=truth[gi], g_mask=torch.arange(16, device=dev) * 25 < n)
        solved.append(pg.solve(graph).ts[:n])
    assert torch.equal(*solved)
