"""The pose graph's linearization and normal-equation sums in one call
(``ops/linearize.py``): the plain version against the ``jacfwd``
linearization (``graph/pose_graph.py::_linearize``) for each factor kind and
each branch of ``so3_log``, against the JAX package's ``_build_normal_terms``
and ``_linearize`` and its solve, unmoved by zero slots, its vmap rule; and
on the card (marker ``gpu``) the kernel against the plain version, eight
lanes in one launch, and a factor's bits unmoved by the batch around it.
Without JAX on the card:

    python -m pytest tests/test_torch_linearize.py -m gpu -q --noconftest
"""

import math

import numpy as np
import pytest
import torch

from liorf_tpu_torch import convert
from liorf_tpu_torch.graph import pose_graph as pg
from liorf_tpu_torch.ops import linearize as lin

NAMES = ("rhs", "diag", "Ji", "Jj", "Jg", "Jp")
# Against jacfwd: the closed form and jacfwd's products differ in the order
# of their sums (and -I against -Ri^T Ri), a few float32 roundings: 2e-6 of
# each output's largest entry. Within 1e-2 of pi so3_log's axis comes from
# the symmetric part over (1 - cos) and theta from sin ~ 1e-3, so both
# derivatives carry rounding amplified by 1 / sin: 1e-4.
TOL, TOL_NEAR_PI = 2e-6, 1e-4


def _rot(v):
    """Rodrigues' formula in float64, rounded to float32."""
    v = np.asarray(v, np.float64)
    t = np.linalg.norm(v)
    W = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    if t < 1e-12:
        return (np.eye(3) + W).astype(np.float32)
    R = np.eye(3) + np.sin(t) / t * W + (1 - np.cos(t)) / t**2 * (W @ W)
    return R.astype(np.float32)


def _graph(seed, K=24, n=16, E=24, G=4, rel_angles=()):
    """A noisy chain of n keyframes in K node slots, two Cauchy loop edges,
    three GPS fixes (the fourth slot masked) and the rest of the E edge
    slots unused (naming node 0, masked); numpy-drawn from ``seed``. Edge k
    of ``rel_angles`` gets a measured rotation that leaves a residual
    rotation of that angle (about a random axis)."""
    rng = np.random.default_rng(seed)
    a = {k: v.numpy() for k, v in pg.empty_graph(K, E, G, device="cpu")._asdict().items()}
    truth = np.cumsum(rng.normal(size=(K, 3)), 0).astype(np.float32)
    a["Rs"] = np.stack([_rot(0.3 * rng.normal(size=3)) for _ in range(K)])
    a["ts"] = (truth + 0.2 * rng.normal(size=(K, 3))).astype(np.float32)
    a["node_mask"] = np.arange(K) < n
    ends = [(i, i + 1) for i in range(n - 1)] + [(0, n - 1), (2, n - 3)]
    for e, (i, j) in enumerate(ends):
        a["e_i"][e], a["e_j"][e] = i, j
        noise = _rot(0.02 * rng.normal(size=3))
        a["e_Rm"][e] = a["Rs"][i].T @ a["Rs"][j] @ noise
        a["e_tm"][e] = a["Rs"][i].T @ (truth[j] - truth[i]) + 0.05 * rng.normal(size=3)
        a["e_sqrt_info"][e] = rng.uniform(1.0, 30.0, size=6)
        a["e_mask"][e] = True
    for e, angle in enumerate(rel_angles):
        i, j = ends[e]
        axis = rng.normal(size=3)
        rel = _rot(angle * axis / np.linalg.norm(axis))
        a["e_Rm"][e] = a["Rs"][i].T @ a["Rs"][j] @ rel.T
    a["e_cauchy"][n - 1: n + 1] = (0.5, 2.0)
    a["g_i"][:3] = (3, 9, 14)
    a["g_t"][:3] = truth[[3, 9, 14]] + 0.3 * rng.normal(size=(3, 3))
    a["g_sqrt_info"][:] = rng.uniform(0.5, 3.0, size=(G, 3))
    a["g_mask"][:3] = True
    a["prior_R"], a["prior_t"] = a["Rs"][0].copy(), a["ts"][0].copy()
    return a


def _torch_graph(a):
    return convert.pose_graph_from_arrays(a, device="cpu")


def _free(g, free_from):
    return g.node_mask & (torch.arange(g.Rs.shape[0]) >= free_from)


def _plain(g, free):
    rhs, diag, t = pg._build_normal_terms(g, free)
    return rhs, diag, t.Ji, t.Jj, t.Jg, t.Jp


def _close(got, want, tol, what):
    for name, a, b in zip(NAMES, got, want):
        b = torch.as_tensor(np.asarray(b))
        torch.testing.assert_close(a, b, rtol=0, atol=tol * float(b.abs().max()) + 1e-30,
                                   msg=lambda m: f"{what} {name}: {m}")


def _op_args(g, free):
    keys, perm = pg._plan(g).sorted_rows()
    return [g.Rs, g.ts, g.e_i, g.e_j, g.e_Rm, g.e_tm, g.e_sqrt_info, g.e_cauchy, g.e_mask,
            g.g_i, g.g_t, g.g_sqrt_info, g.g_mask, g.prior_i.reshape(1), g.prior_R, g.prior_t,
            g.prior_sqrt_info, free, keys, perm]


# ---------------------------------------------------------------------------
# against the jacfwd oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("branch, angle", [
    ("zero", 0.0), ("below_1e-5", 3e-6), ("generic_small", 1e-3), ("generic", 2.0),
    ("near_pi", math.pi - 1e-3)])
def test_plain_matches_jacfwd_in_each_branch(branch, angle):
    """Every between factor's residual rotation in one branch of so3_log
    (the first edges set to it; the prior's rotation too), each factor kind
    present; frozen nodes and masked slots as the solve has them."""
    a = _graph(1, rel_angles=[angle] * 15)
    a["prior_R"] = a["Rs"][0] @ _rot([0.0, 0.0, angle]).T
    g = _torch_graph(a)
    tol = TOL_NEAR_PI if branch == "near_pi" else TOL
    for free_from in (0, 6):
        free = _free(g, free_from)
        _close(_plain(g, free), pg._normal_terms_jacfwd(g, free), tol, f"{branch} free_from={free_from}")


def test_each_factor_kind_alone():
    """A graph of between factors only, of GPS factors only, and of the
    prior only (the others masked): each against jacfwd."""
    a = _graph(2)
    kinds = {
        "between": dict(g_mask=np.zeros_like(a["g_mask"]), prior_sqrt_info=np.zeros(6, np.float32)),
        "gps": dict(e_mask=np.zeros_like(a["e_mask"]), prior_sqrt_info=np.zeros(6, np.float32)),
        "prior": dict(e_mask=np.zeros_like(a["e_mask"]), g_mask=np.zeros_like(a["g_mask"]),
                      prior_R=a["Rs"][0] @ _rot([0.1, -0.2, 0.3]),
                      prior_sqrt_info=np.array([10, 10, 1 / math.pi, 1, 1, 1], np.float32)),
    }
    for kind, over in kinds.items():
        g = _torch_graph({**a, **over})
        free = _free(g, 0)
        got = _plain(g, free)
        _close(got, pg._normal_terms_jacfwd(g, free), TOL, kind)
        assert got[1].abs().sum() > 0, kind  # the kind left something to sum


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_reference():
    """The JAX package's normal terms (its _build_normal_terms; its
    _linearize masked as that function masks it) for the seeded graph at
    free_from 0 and 6, and its solve."""
    import jax
    import jax.numpy as jnp
    from liorf_tpu.graph import pose_graph as jpg

    a = _graph(3)
    K, E, G = a["Rs"].shape[0], a["e_i"].shape[0], a["g_i"].shape[0]
    gj = jpg.empty_graph(K, E, G)._replace(**{k: jnp.asarray(v) for k, v in a.items()})

    @jax.jit
    def terms(g, free):
        rhs, _, diag = jpg._build_normal_terms(g, free)
        (_, Ji, Jj), (_, Jg), (_, Jp) = jpg._linearize(g)
        fm = free.astype(jnp.float32)
        return (rhs, diag, Ji * fm[g.e_i][:, None, None], Jj * fm[g.e_j][:, None, None],
                Jg * fm[g.g_i][:, None, None], Jp * fm[g.prior_i])

    out = {f: [np.asarray(x) for x in terms(gj, jnp.asarray(a["node_mask"] & (np.arange(K) >= f)))]
           for f in (0, 6)}
    params = dict(gn_iters=3, pcg_iters=32)
    solved = jpg.solve(gj, free_from=jnp.asarray(0, jnp.int32), params=jpg.SolveParams(**params))
    return a, out, np.asarray(solved.ts), params


@pytest.mark.parametrize("free_from", [0, 6])
def test_plain_matches_jax_normal_terms(jax_reference, free_from):
    a, out, _, _ = jax_reference
    g = _torch_graph(a)
    _close(_plain(g, _free(g, free_from)), out[free_from], 1e-5, f"jax free_from={free_from}")


def test_solve_matches_jax_solve(jax_reference):
    """The port's solve (the plain version's terms, the PCG's plain version)
    against the JAX package's solve: translations within 1e-4 of the
    largest (test_torch_pcg.py's bound on the PCG against the JAX _pcg)."""
    a, _, ts, params = jax_reference
    got = pg.solve(_torch_graph(a), params=pg.SolveParams(**params)).ts
    torch.testing.assert_close(got, torch.from_numpy(ts), rtol=0,
                               atol=1e-4 * float(np.abs(ts).max()))


# ---------------------------------------------------------------------------
# zero slots, lanes
# ---------------------------------------------------------------------------

def _pad(a, E2, G2, K2):
    """The same graph in more edge, GPS and node slots: unused slots name
    node 0 and are masked, unused nodes are identities."""
    b = {k: v.copy() for k, v in a.items()}
    big = {k: v.numpy() for k, v in pg.empty_graph(K2, E2, G2, device="cpu")._asdict().items()}
    for k, v in b.items():
        if k in big and np.ndim(v) >= 1 and not k.startswith("prior"):
            big[k][: v.shape[0]] = v
    big.update({k: v for k, v in b.items() if k.startswith("prior")})
    return big


def test_zero_slots_change_no_bit():
    """A ring's unused slots (edges and GPS fixes masked on node 0, empty
    nodes): the graph's terms at its own capacities and at larger ones are
    equal bit for bit on the graph's nodes and factors."""
    a = _graph(4)
    g, big = _torch_graph(a), _torch_graph(_pad(a, 200, 16, 64))
    K, E, G = a["Rs"].shape[0], a["e_i"].shape[0], a["g_i"].shape[0]
    for free_from in (0, 6):
        small = _plain(g, _free(g, free_from))
        large = _plain(big, _free(big, free_from))
        for name, x, y in zip(NAMES, small, large):
            n = {"rhs": K, "diag": K, "Ji": E, "Jj": E, "Jg": G}.get(name)
            assert torch.equal(x, y if n is None else y[:n]), (name, free_from)
        assert not large[0][K:].any() and not large[1][K:].any()


def test_vmap_over_lanes_is_lane_by_lane():
    """Under torch.func.vmap (the multistream lane axis) the op folds the
    lanes into one call: equal to each lane's own call; the plain version
    vmapped itself gives the same bits."""
    lanes = []
    for seed, free_from in ((5, 0), (6, 4), (7, 9)):
        g = _torch_graph(_graph(seed))
        lanes.append(_op_args(g, _free(g, free_from)))
    singles = [lin.linearize_normal(*(x[None] for x in args)) for args in lanes]
    stacked = [torch.stack(v) for v in zip(*lanes)]

    def one(*a):
        return tuple(x[0] for x in lin.linearize_normal(*(t[None] for t in a)))

    def one_plain(*a):
        return tuple(x[0] for x in lin.linearize_normal_plain(*(t[None] for t in a)))

    for fn in (one, one_plain):
        got = torch.func.vmap(fn)(*stacked)
        for k in range(6):
            assert torch.equal(got[k], torch.cat([s[k] for s in singles])), (fn.__name__, NAMES[k])


def test_solve_builds_one_plan():
    """The plan (the sorted node sums' order) is built once a solve, not
    once a GN step."""
    g = _torch_graph(_graph(8))
    made = []
    real = pg._plan
    pg._plan = lambda graph: made.append(1) or real(graph)
    try:
        pg.solve(g, params=pg.SolveParams(gn_iters=3, pcg_iters=4))
    finally:
        pg._plan = real
    assert len(made) == 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    # decided here, not at import: every xdist worker must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _random_args(K, n, E, G, seed, dev, lanes=1, free_from=0):
    """One seeded graph's op arguments with a lane axis, on ``dev``."""
    from test_torch_pcg import _random_graph

    out = []
    for b in range(lanes):
        g = _random_graph(K, n, E, G, seed=seed + b)
        out.append(_op_args(g, _free(g, free_from)))
    return [torch.stack(v).to(dev) for v in zip(*out)]


def _plain_on_card(args):
    """The plain version's phase A on the card, its node sums in the plan's
    order on the CPU (index_add on the card adds in no fixed order)."""
    from liorf_tpu_torch.ops.segment_sum import segment_sum_plain

    Ji, Jj, Jg, Jp, rows = lin.factor_rows_plain(*args[:18])
    sums = segment_sum_plain(rows.cpu(), args[19].cpu(), args[18].cpu(), args[0].shape[1])
    B, K = sums.shape[:2]
    return (sums[..., :6], sums[..., 6:].reshape(B, K, 6, 6), Ji.cpu(), Jj.cpu(), Jg.cpu(),
            Jp.cpu()), rows


@pytest.mark.gpu
@pytest.mark.parametrize("K, free_from", [(16, 0), (256, 0), (256, 200), (1024, 0)])
def test_kernel_is_its_plain_version(dev, K, free_from):
    """Bit for bit (torch's atan2 on the card and the kernel's are CUDA's
    atan2f); one launch, and a second launch repeats."""
    args = _random_args(K, K - K // 8, K + K // 8 + 3, max(4, K // 4), K, dev, free_from=free_from)
    want, rows = _plain_on_card(args)
    before = lin.linearize_normal.launches
    got = lin._launch(*args, keep_rows=True)
    again = lin.linearize_normal(*args)
    assert lin.linearize_normal.launches == before + 2
    assert torch.equal(got[-1], rows)
    for name, x, y, z in zip(NAMES, got, want, again):
        assert torch.equal(x.cpu(), y), name
        assert torch.equal(x, z), name


@pytest.mark.gpu
def test_eight_lanes_in_one_launch(dev):
    args = _random_args(128, 100, 160, 16, 0, dev, lanes=8, free_from=40)
    singles = [lin.linearize_normal(*(a[b:b + 1] for a in args)) for b in range(8)]
    before = lin.linearize_normal.launches
    got = torch.func.vmap(lambda *a: tuple(x[0] for x in lin.linearize_normal(*(t[None] for t in a))))(*args)
    assert lin.linearize_normal.launches == before + 1
    for k in range(6):
        assert torch.equal(got[k], torch.cat([s[k] for s in singles])), NAMES[k]


@pytest.mark.gpu
def test_factor_bits_ignore_the_batch_around_them(dev):
    """A factor's Jacobians and its node sums have the same bits in graphs
    of 256 to 4096 edge slots (the ring capacity), where cuBLAS's batched
    products under jacfwd took other bits at 1536 and 2048."""
    full = _random_args(4096, 3500, 4096, 256, 11, dev)
    keep = 200  # the first nodes and edges, whose factors all lie among them
    ref = None
    for E in (256, 512, 1024, 1152, 1536, 2048, 4096):
        args = list(full)
        for k in (2, 3, 4, 5, 6, 7, 8):  # the edge fields cut to E slots
            args[k] = full[k][:, :E]
        args[8] = args[8] & (torch.arange(E, device=dev) < keep - 1)
        M = 2 * E + full[9].shape[1] + 1
        idx = torch.cat([args[2], args[3], args[9], args[13]], 1)
        args[18], args[19] = torch.sort(idx, stable=True)
        assert args[18].shape[1] == M
        out = lin.linearize_normal(*args)
        cut = (out[0][:, :keep], out[1][:, :keep], out[2][:, :keep - 1], out[3][:, :keep - 1])
        if ref is None:
            ref = cut
        for name, x, y in zip(NAMES, cut, ref):
            assert torch.equal(x, y), (name, E)


def test_sorted_keys_give_each_node_its_plan_rows():
    """The kernel finds a node's rows where the plan's sorted keys change
    value (csrc/linearize.cu's key pass): the same rows, in the same order,
    as the plan's offsets (``segment_offsets``), node 0 with hundreds of
    unused slots included, and within a node the rows in their stable
    order (index_add's order: Ji rows, Jj rows, GPS, the prior)."""
    from liorf_tpu_torch.ops.segment_sum import segment_offsets
    from test_torch_pcg import _random_graph

    K, n, E, G = 256, 60, 512, 32
    g = _random_graph(K, n, E, G, seed=3)
    keys, perm = pg._plan(g).sorted_rows()
    M = keys.shape[0]
    assert M == 2 * E + G + 1
    offsets = segment_offsets(keys[None], K)[0]
    prev = torch.cat([torch.tensor([-1]), keys[:-1]])
    nxt = torch.cat([keys[1:], torch.tensor([K])])
    lo, hi = torch.zeros(K, dtype=torch.int64), torch.zeros(K, dtype=torch.int64)
    first = torch.nonzero(keys != prev)[:, 0]
    last = torch.nonzero(keys != nxt)[:, 0]
    lo[keys[first]], hi[keys[last]] = first, last + 1
    for k in range(K):
        a, b = int(offsets[k]), int(offsets[k + 1])
        if a == b:
            assert lo[k] == hi[k] == 0, k
            continue
        assert (int(lo[k]), int(hi[k])) == (a, b), k
        assert bool((perm[a:b][1:] > perm[a:b][:-1]).all()), k
    assert int(offsets[1] - offsets[0]) > 2 * (E - n - 2)  # node 0: every unused slot's rows


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 3, 33])
@pytest.mark.parametrize("K", [16, 64, 256, 1024])
def test_one_kernel_launch_a_call(dev, K, lanes):
    """Bit for bit at every size and lane count, one kernel launch a call
    (the library's own count), the public call and the same lanes under
    torch.func.vmap alike, each lane with its own graph and frozen nodes."""
    args = _random_args(K, K - K // 8, K + K // 8 + 3, max(4, K // 4), 7 * K + lanes, dev,
                        lanes=lanes, free_from=K // 5)
    want, rows = _plain_on_card(args)
    k0 = lin.kernel_launches()
    got = lin.linearize_normal(*args)
    assert lin.kernel_launches() == k0 + 1
    vmapped = torch.func.vmap(_one_lane)(*args)
    assert lin.kernel_launches() == k0 + 2
    assert torch.equal(lin._launch(*args, keep_rows=True)[-1], rows)
    for name, x, y, z in zip(NAMES, got, want, vmapped):
        assert torch.equal(x.cpu(), y) and torch.equal(x, z), name


def _one_lane(*a):
    """linearize_normal of one lane (its lane axis taken by vmap)."""
    return tuple(x[0] for x in lin.linearize_normal(*(t[None] for t in a)))


def _hub_args(dev, free_from=0):
    """A graph whose node 1 ends 40 loop edges (80 rows with its chain's)."""
    from test_torch_pcg import _random_graph

    K, n, E, G = 256, 200, 300, 16
    g = _random_graph(K, n, E, G, seed=21)
    e_i, e_j, mask = g.e_i.clone(), g.e_j.clone(), g.e_mask.clone()
    extra = torch.arange(n + 2, n + 42)
    e_i[extra], e_j[extra] = 1, torch.arange(40, 200, 4)
    mask[extra] = True
    g = g._replace(e_i=e_i, e_j=e_j, e_mask=mask)
    return [torch.stack([a]).to(dev) for a in _op_args(g, _free(g, free_from))]


@pytest.mark.gpu
@pytest.mark.parametrize("free_from", [0, 256], ids=["free", "every_node_frozen"])
def test_a_node_of_many_rows_and_frozen_graphs(dev, free_from):
    """A node with more than 32 rows (its walk takes several rounds of
    eight flags), and a graph whose every node is frozen (every row zero,
    every sum +0.0): bit for bit, one launch."""
    args = _hub_args(dev, free_from)
    keys = args[18][0]
    assert int((keys == 1).sum()) > 32
    want, rows = _plain_on_card(args)
    k0 = lin.kernel_launches()
    got = lin.linearize_normal(*args)
    assert lin.kernel_launches() == k0 + 1
    assert torch.equal(lin._launch(*args, keep_rows=True)[-1], rows)
    for name, x, y in zip(NAMES, got, want):
        assert torch.equal(x.cpu(), y), name
    if free_from:
        assert all(bool((x == 0).all()) and not bool(torch.signbit(x).any()) for x in got[:2])


@pytest.mark.gpu
def test_back_to_back_calls(dev):
    """Calls of two graphs queued back to back (no synchronisation between
    them) and again: each bit for bit its plain version, one launch each."""
    a = _random_args(256, 224, 290, 64, 5, dev, free_from=30)
    b = _hub_args(dev)
    k0 = lin.kernel_launches()
    outs = [lin.linearize_normal(*x) for x in (a, b, a, b)]
    assert lin.kernel_launches() == k0 + 4
    for x, got in zip((a, b, a, b), outs):
        want, _ = _plain_on_card(x)
        for name, u, v in zip(NAMES, got, want):
            assert torch.equal(u.cpu(), v), name
