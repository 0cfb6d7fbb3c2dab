"""The pose graph's PCG in one call (``ops/pcg.py``): the plain version
against the JAX package's ``_pcg`` and the port's op-by-op ``_pcg`` on the
same normal equations, unmoved by zero padding of nodes and edges, its
vmap rule, its guards; and on the card (marker ``gpu``) the kernel against
the plain version bit for bit, at every cluster size (on chip where the lane
fits, else in device memory) with frozen nodes or none, on chip at the
default cluster, in the device-memory layout of a grown ring, with 8 lanes
in one launch and with zero slots around the graph. Without JAX on the card:

    python -m pytest tests/test_torch_pcg.py -m gpu -q --noconftest
"""

import numpy as np
import pytest
import torch

from liorf_tpu_torch import convert
from liorf_tpu_torch.core import se3
from liorf_tpu_torch.graph import pose_graph as pg
from liorf_tpu_torch.ops import pcg

DAMPING = 1e-4


def _random_graph(K, n, E, G, seed, device="cpu"):
    """A noisy chain of n keyframes in K node slots, three loop edges and
    G - 1 GPS fixes in E / G factor slots (the rest unused)."""
    g = torch.Generator().manual_seed(seed)
    truth = torch.cumsum(torch.randn((K, 3), generator=g), 0)
    e_i, e_j = torch.zeros(E, dtype=torch.int64), torch.zeros(E, dtype=torch.int64)
    e_i[: n - 1], e_j[: n - 1] = torch.arange(n - 1), torch.arange(1, n)
    e_i[n - 1: n + 2], e_j[n - 1: n + 2] = torch.tensor([0, 1, 2]), torch.tensor([n - 1, n - 2, n - 3])
    gi = torch.randint(0, n, (G,), generator=g)
    graph = pg.empty_graph(K, E, G, device="cpu")._replace(
        ts=truth + 0.3 * torch.randn((K, 3), generator=g),
        Rs=se3.so3_exp(0.1 * torch.randn((K, 3), generator=g)),
        node_mask=torch.arange(K) < n, e_i=e_i, e_j=e_j,
        e_tm=truth[e_j] - truth[e_i] + 0.01 * torch.randn((E, 3), generator=g),
        e_mask=torch.arange(E) < n + 2, e_cauchy=(torch.arange(E) == n - 1).float(),
        g_i=gi, g_t=truth[gi], g_mask=torch.arange(G) < G - 1)
    return graph._replace(**{k: v.to(device) for k, v in graph._asdict().items()})


def _args(graph, free_from=0):
    """pcg_solve's arguments (one lane, no lane axis) for the graph's first
    GN step."""
    K = graph.Rs.shape[0]
    free = graph.node_mask & (torch.arange(K, device=graph.Rs.device) >= free_from)
    rhs, diag, t = pg._build_normal_terms(graph, free)
    keys, perm = t.plan.sorted_rows()
    return [t.Ji, t.Jj, t.Jg, t.Jp, t.e_i, t.e_j, t.g_i, t.p_i, keys, perm,
            pg._block_jacobi(diag, DAMPING), rhs]


def _one(args, iters, fn=pcg.pcg_solve_plain):
    return fn(*(a[None] for a in args), iters, DAMPING)[0]


def _pad(args, K2, E2):
    """The same normal equations in K2 node and E2 edge slots: zero factors
    at node 0, zero right-hand side, the preconditioner of an empty node."""
    Ji, Jj, Jg, Jp, e_i, e_j, g_i, p_i, _, _, Minv, rhs = args
    K, E = rhs.shape[0], e_i.shape[0]

    def z(t, n):
        return torch.cat([t, t.new_zeros((n, *t.shape[1:]))])

    Ji, Jj, e_i, e_j = z(Ji, E2 - E), z(Jj, E2 - E), z(e_i, E2 - E), z(e_j, E2 - E)
    empty = pg._block_jacobi(torch.zeros((K2 - K, 6, 6)), DAMPING)
    keys, perm = torch.sort(torch.cat([e_i, e_j, g_i, p_i]), stable=True)
    return [Ji, Jj, Jg, Jp, e_i, e_j, g_i, p_i, keys, perm, torch.cat([Minv, empty]), z(rhs, K2 - K)]


@pytest.fixture(scope="module")
def small():
    """The pose-graph test's graph (tests/test_torch_ops.py): K 16, E 32, G 4."""
    from test_torch_ops import _graph_arrays

    arrays, _ = _graph_arrays(8)
    fields = {k: v.numpy() for k, v in pg.empty_graph(16, 32, 4, device="cpu")._asdict().items()}
    return arrays, convert.pose_graph_from_arrays({**fields, **arrays}, device="cpu")


@pytest.mark.parametrize("free_from", [0, 8])
def test_plain_matches_jax_pcg(small, free_from):
    """The JAX package's normal terms (its linearization, masked as its
    _build_normal_terms masks them) through its _pcg and through the plain
    version: x to 1e-4 of its largest element."""
    import jax
    import jax.numpy as jnp
    from liorf_tpu.graph import pose_graph as jpg

    gj = jpg.empty_graph(16, 32, 4)._replace(**{k: jnp.asarray(v) for k, v in small[0].items()})
    free = jnp.asarray(np.asarray(gj.node_mask) & (np.arange(16) >= free_from))

    @jax.jit
    def jax_pcg(g, free):
        rhs, matvec, diag = jpg._build_normal_terms(g, free)
        (_, Ji, Jj), (_, Jg), (_, Jp) = jpg._linearize(g)
        fm = free.astype(jnp.float32)
        return (jpg._pcg(matvec, rhs, diag, 48, DAMPING), rhs, diag, Ji * fm[g.e_i][:, None, None],
                Jj * fm[g.e_j][:, None, None], Jg * fm[g.g_i][:, None, None], Jp * fm[g.prior_i])

    want, rhs, diag, *jac = (torch.from_numpy(np.asarray(v)) for v in jax_pcg(gj, free))
    gt = small[1]
    idx = [gt.e_i, gt.e_j, gt.g_i, gt.prior_i.reshape(1)]
    keys, perm = torch.sort(torch.cat(idx), stable=True)
    got = _one([*jac, *idx, keys, perm, pg._block_jacobi(diag, DAMPING), rhs], 48)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))


# The full solve of this graph holds its translation gauge by a prior of
# sqrt information 1e-4: after damping its condition number is ~1e8, and
# two float32 orders of the same sums part by ~3e-5 of max|x| once CG
# reaches that subspace (6.7e-7 after 16 iterations, 3.0e-5 after 48).
# The window solve (8 nodes frozen) is well conditioned: 1.8e-7.
@pytest.mark.parametrize("free_from, tol", [(0, 1e-4), (8, 1e-5)], ids=["full", "window"])
def test_plain_matches_op_by_op_pcg(small, free_from, tol):
    """Against the port's op-by-op _pcg on the same terms (its products and
    dots sum in other orders)."""
    gt = small[1]
    K = gt.Rs.shape[0]
    free = gt.node_mask & (torch.arange(K) >= free_from)
    rhs, diag, t = pg._build_normal_terms(gt, free)
    want = pg._pcg(pg._matvec(t), rhs, diag, 48, DAMPING)
    got = _one(_args(gt, free_from), 48)
    torch.testing.assert_close(got, want, rtol=0, atol=tol * float(want.abs().max()))


def test_zero_padding_changes_no_bit(small):
    """A ring's unused slots: the graph's equations in 1024 node and 1152
    edge slots give the bits of the graph alone."""
    args = _args(small[1])
    alone = _one(args, 32)
    padded = _one(_pad(args, 1024, 1152), 32)
    assert torch.equal(padded[:16], alone)
    assert not padded[16:].any()


def test_vmap_rule_folds_lanes_into_one_call():
    """Under torch.func.vmap (the multistream lane axis) the op sees one
    stacked call; the graph's structure unbatched, its values batched."""
    lanes = [_args(_random_graph(24, 20, 32, 4, seed=0), free_from=f) for f in (0, 3, 9, 15)]
    singles = torch.stack([_one(a, 12) for a in lanes])
    batched = [torch.stack(vals) for vals in zip(*lanes)]
    shared = list(range(4, 10))  # endpoints and the sorted rows: one graph
    in_dims = tuple(None if i in shared else 0 for i in range(12))
    args = [batched[i][0] if i in shared else batched[i] for i in range(12)]

    def one(*a):
        return pcg._pcg_solve_op(*(x[None] for x in a), 12, DAMPING)[0]

    got = torch.func.vmap(one, in_dims=in_dims)(*args)
    assert torch.equal(got, singles)
    # the plain version's own lane axis gives the same bits
    assert torch.equal(pcg.pcg_solve_plain(*batched, 12, DAMPING), singles)


def test_iters_zero_and_the_guards():
    """iters = 0 returns zeros; a zero <p, Ap> (no factors, no damping) and
    a zero <r, z> (a frozen graph) stop the iteration at 0, not NaN."""
    args = _args(_random_graph(16, 12, 32, 4, seed=1))
    x0 = _one(args, 0)
    assert x0.shape == (16, 6) and not x0.any()
    Ji, Jj, Jg, Jp, *idx, Minv, rhs = args
    eye = torch.eye(6).expand(16, 6, 6)
    no_h = [torch.zeros_like(Ji), torch.zeros_like(Jj), torch.zeros_like(Jg),
            torch.zeros_like(Jp), *idx, eye, rhs]
    x = pcg.pcg_solve_plain(*(a[None] for a in no_h), 5, 0.0)[0]
    assert not x.any() and bool(torch.isfinite(x).all())
    frozen = _one(_args(_random_graph(16, 12, 32, 4, seed=1), free_from=16), 5)
    assert not frozen.any() and bool(torch.isfinite(frozen).all())


def test_solve_takes_the_fused_pcg(small):
    """pose_graph.solve's GN steps each make one pcg_solve call (counted in
    solve.gn_steps) and reach the op-by-op result within 1e-5."""
    gt = small[1]
    before = pg.solve.gn_steps
    out = pg.solve(gt, params=pg.SolveParams(gn_iters=2, pcg_iters=24))
    assert pg.solve.gn_steps == before + 2
    g = gt
    free = gt.node_mask
    for _ in range(2):
        rhs, diag, t = pg._build_normal_terms(g, free)
        dx = pg._pcg(pg._matvec(t), rhs, diag, 24, DAMPING) * free[:, None].float()
        Rs, ts = se3.se3_retract(g.Rs, g.ts, dx)
        g = g._replace(Rs=Rs, ts=ts)
    torch.testing.assert_close(out.ts, g.ts, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    # decided here, not at import: every xdist worker must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _on(args, dev):
    return [a.to(dev) for a in args]


@pytest.mark.gpu
@pytest.mark.parametrize("K", [8, 256, 1024, 4096])
def test_kernel_is_its_plain_version(dev, K):
    """The kernel against the plain version on the CPU copies of its
    arguments, bit for bit, at the graph sizes of a short session to a long
    ring; one launch, and a second launch repeats."""
    args = _args(_random_graph(K, K - K // 8, K + K // 8 + 3, max(4, K // 4), seed=K))
    want = _one(args, 64)
    before = pcg.pcg_solve.launches
    got = _one(_on(args, dev), 64, pcg.pcg_solve)
    again = _one(_on(args, dev), 64, pcg.pcg_solve)
    assert pcg.pcg_solve.launches == before + 2
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, again)


# the main path's window solve and the resident full solve (nodes, used
# nodes, edge and GPS slots), and the first node left free when some are
# frozen (the solve's window)
SHAPES = {"window": (256, 224, 256, 16), "resident_full": (1024, 900, 1152, 256)}
FREE_FROM = {"window": 200, "resident_full": 880}
CLUSTERS = (1, 2, 4, 8)  # the cluster sizes a launch may take


@pytest.mark.gpu
@pytest.mark.parametrize("frozen", [False, True], ids=["all_free", "frozen"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cluster_size_changes_no_bit(dev, shape, frozen):
    """Clusters of 1, 2, 4 and 8 blocks (the window on chip at every size,
    the resident full solve in device memory below 8) and the default
    launch, with every used node free or those below FREE_FROM frozen
    (zero rows and right-hand sides, the chunks the kernel skips): the
    plain version's bits."""
    args = _args(_random_graph(*SHAPES[shape], seed=3), FREE_FROM[shape] if frozen else 0)
    want = _one(args, 64)
    lane = [a[None] for a in _on(args, dev)]
    outs = [pcg._launch(*lane, 64, DAMPING, cluster=c)[0] for c in CLUSTERS]
    outs.append(pcg._launch(*lane, 64, DAMPING)[0])
    assert all(torch.equal(o.cpu(), want) for o in outs)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_default_cluster_keeps_the_lane_on_chip(dev, shape):
    """The default cluster holds the main window and the resident full solve
    on chip."""
    K, _, E, G = SHAPES[shape]
    assert pcg.load_library().liorf_pcg_layout(K, E, G, pcg.CLUSTER) == pcg.ON_CHIP


@pytest.mark.gpu
def test_device_memory_layout_of_a_grown_ring(dev):
    """A ring past what any cluster holds on chip (4096 node slots) takes the
    device-memory layout and keeps the plain version's bits, at the default
    cluster and at one block."""
    args = _args(_random_graph(4096, 3584, 4611, 1024, seed=9))
    K, E, G = 4096, 4611, 1024
    lib = pcg.load_library()
    assert all(lib.liorf_pcg_layout(K, E, G, c) == pcg.DEVICE_MEMORY for c in CLUSTERS)
    got = _one(_on(args, dev), 32, pcg.pcg_solve)
    one_block = pcg._launch(*(a[None] for a in _on(args, dev)), 32, DAMPING, cluster=1)[0]
    want = _one(args, 32)
    assert torch.equal(got.cpu(), want) and torch.equal(one_block.cpu(), want)


@pytest.mark.gpu
def test_eight_lanes_in_one_launch(dev):
    lanes = [_on(_args(_random_graph(128, 100 + 3 * b, 160, 16, seed=b)), dev) for b in range(8)]
    singles = torch.stack([_one(a, 32, pcg.pcg_solve) for a in lanes])
    before = pcg.pcg_solve.launches
    got = torch.func.vmap(lambda *a: _one(a, 32, pcg.pcg_solve))(
        *(torch.stack(v) for v in zip(*lanes)))
    assert pcg.pcg_solve.launches == before + 1
    assert torch.equal(got, singles)


@pytest.mark.gpu
def test_zero_slots_change_no_bit_on_the_card(dev):
    args = _args(_random_graph(200, 180, 220, 16, seed=4))
    alone = _one(_on(args, dev), 64, pcg.pcg_solve)
    padded = _one(_on(_pad(args, 1024, 1152), dev), 64, pcg.pcg_solve)
    assert torch.equal(padded[:200], alone)
