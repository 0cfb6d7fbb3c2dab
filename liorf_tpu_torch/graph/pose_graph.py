"""Keyframe pose-graph optimization: batched Gauss-Newton with PCG.

Replacement for GTSAM's ISAM2 in the reference back-end
(``liorf/src/mapOptmization.cpp:68-73,1386-1533``). The graph holds SE(3)
keyframe poses with three factor families, mirroring the reference:

* prior on the first pose (``addOdomFactor``, :1390-1394);
* between factors — the odometry chain and loop closures (:1396-1400,
  :1482-1501), loops optionally with a Cauchy robust kernel (:711-719);
* GPS unary position factors (``addGPSFactor``, :1470-1474).

Instead of incremental Bayes-tree updates, the solver runs batched
Gauss-Newton: every factor's residual and closed-form Jacobians and the
normal equations' per-node sums in one call (``ops/linearize.py``; the
forward-mode autodiff of ``torch.func`` stays as their oracle), solved by
preconditioned conjugate gradients with a block-Jacobi preconditioner
(``ops/pcg.py``); all gather/scatter is over fixed-capacity masked arrays.
A trailing-window mode (freeze all but the last W nodes) provides the
cheap per-keyframe incremental step; full solves run when loops/GPS land,
like the reference's 5x ``isam->update()`` burst (:1521-1531).

Tangent convention: [omega, v] with right-multiplicative retraction
(R <- R exp(w), t <- t + R v) from ``core.se3``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..core import se3
from ..core.device import resolve_device
from ..ops.linearize import linearize_normal
from ..ops.pcg import pcg_solve
from ..ops.segment_sum import SegmentPlan


class PoseGraph(NamedTuple):
    # nodes
    Rs: torch.Tensor  # [K, 3, 3]
    ts: torch.Tensor  # [K, 3]
    node_mask: torch.Tensor  # [K]
    # between factors (odometry + loops)
    e_i: torch.Tensor  # [E] int64
    e_j: torch.Tensor  # [E] int64
    e_Rm: torch.Tensor  # [E, 3, 3] measured relative rotation (i -> j)
    e_tm: torch.Tensor  # [E, 3] measured relative translation (in i's frame)
    e_sqrt_info: torch.Tensor  # [E, 6] diagonal sqrt information [rot, trans]
    e_cauchy: torch.Tensor  # [E] Cauchy scale c (<=0 disables the robust kernel)
    e_mask: torch.Tensor  # [E]
    # GPS unary factors
    g_i: torch.Tensor  # [G] int64
    g_t: torch.Tensor  # [G, 3] measured position
    g_sqrt_info: torch.Tensor  # [G, 3]
    g_mask: torch.Tensor  # [G]
    # prior on one node
    prior_i: torch.Tensor  # [] int64
    prior_R: torch.Tensor  # [3, 3]
    prior_t: torch.Tensor  # [3]
    prior_sqrt_info: torch.Tensor  # [6]


def _prior_sqrt_info(f32: dict) -> torch.Tensor:
    v = torch.full((6,), 1e-4, **f32)
    v[:2].fill_(10.0)
    v[2:3].fill_(1.0 / math.pi)
    return v


def empty_graph(num_nodes: int, num_edges: int, num_gps: int, device=None) -> PoseGraph:
    """All-masked graph of the given capacities; ``device=None`` means
    ``cuda`` and raises when there is none."""
    device = resolve_device(device, "empty_graph")
    f32 = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    b = dict(dtype=torch.bool, device=device)
    eye = torch.eye(3, **f32)
    return PoseGraph(
        Rs=eye.expand(num_nodes, 3, 3).clone(),
        ts=torch.zeros((num_nodes, 3), **f32),
        node_mask=torch.zeros((num_nodes,), **b),
        e_i=torch.zeros((num_edges,), **i64),
        e_j=torch.zeros((num_edges,), **i64),
        e_Rm=eye.expand(num_edges, 3, 3).clone(),
        e_tm=torch.zeros((num_edges, 3), **f32),
        e_sqrt_info=torch.ones((num_edges, 6), **f32),
        e_cauchy=torch.zeros((num_edges,), **f32),
        e_mask=torch.zeros((num_edges,), **b),
        g_i=torch.zeros((num_gps,), **i64),
        g_t=torch.zeros((num_gps, 3), **f32),
        g_sqrt_info=torch.ones((num_gps, 3), **f32),
        g_mask=torch.zeros((num_gps,), **b),
        prior_i=torch.zeros((), **i64),
        prior_R=eye.clone(),
        prior_t=torch.zeros((3,), **f32),
        # reference prior variances (1e-2, 1e-2, pi^2) rot, 1e8 trans
        # (mapOptmization.cpp:1390) -> sqrt information = 1/sigma; filled in
        # place (a tensor built from a list would be a host upload)
        prior_sqrt_info=_prior_sqrt_info(f32),
    )


# ---------------------------------------------------------------------------
# factor residuals (per-factor, batched; Jacobians via forward-mode autodiff)
# ---------------------------------------------------------------------------

def _between_residual(xi_i, xi_j, Ri, ti, Rj, tj, Rm, tm):
    """Whitening-free between residual on the tangent perturbation."""
    Ri2, ti2 = se3.se3_retract(Ri, ti, xi_i)
    Rj2, tj2 = se3.se3_retract(Rj, tj, xi_j)
    r_R = se3.so3_log(Rm.T @ (Ri2.T @ Rj2))
    r_t = Ri2.T @ (tj2 - ti2) - tm
    return torch.cat([r_R, r_t])


def _gps_residual(xi_i, Ri, ti, target):
    _, ti2 = se3.se3_retract(Ri, ti, xi_i)
    return ti2 - target


def _prior_residual(xi_i, Ri, ti, R0, t0):
    Ri2, ti2 = se3.se3_retract(Ri, ti, xi_i)
    return torch.cat([se3.so3_log(R0.T @ Ri2), ti2 - t0])


def _between_rJ(Ri, ti, Rj, tj, Rm, tm):
    def one(Ri, ti, Rj, tj, Rm, tm):
        z = torch.zeros(6, dtype=Ri.dtype, device=Ri.device)

        def f(a, b):
            r = _between_residual(a, b, Ri, ti, Rj, tj, Rm, tm)
            return r, r

        (Ji, Jj), r = jacfwd(f, argnums=(0, 1), has_aux=True)(z, z)
        return r, Ji, Jj

    return vmap(one)(Ri, ti, Rj, tj, Rm, tm)


def _gps_rJ(Ri, ti, tgt):
    def one(Ri, ti, tgt):
        z = torch.zeros(6, dtype=Ri.dtype, device=Ri.device)

        def f(a):
            r = _gps_residual(a, Ri, ti, tgt)
            return r, r

        J, r = jacfwd(f, has_aux=True)(z)
        return r, J

    return vmap(one)(Ri, ti, tgt)


def _linearize(graph: PoseGraph):
    """Whitened residuals + Jacobian blocks for every factor by ``jacfwd``:
    ``graph_error``'s residuals, and the oracle of the closed-form Jacobians
    of ``ops/linearize.py`` (tests, chip_smoke.py)."""
    # between
    Ri = graph.Rs[graph.e_i]
    ti = graph.ts[graph.e_i]
    Rj = graph.Rs[graph.e_j]
    tj = graph.ts[graph.e_j]
    r_e, Ji, Jj = _between_rJ(Ri, ti, Rj, tj, graph.e_Rm, graph.e_tm)
    r_e = r_e * graph.e_sqrt_info
    Ji = Ji * graph.e_sqrt_info[:, :, None]
    Jj = Jj * graph.e_sqrt_info[:, :, None]
    # robust Cauchy via IRLS: weight = 1 / (1 + ||r||^2 / c^2)
    rn2 = torch.sum(r_e * r_e, dim=-1)
    c2 = graph.e_cauchy * graph.e_cauchy
    w_rob = torch.where(
        graph.e_cauchy > 0, 1.0 / (1.0 + rn2 / torch.clamp(c2, min=1e-12)), 1.0
    )
    w = torch.sqrt(w_rob) * graph.e_mask.to(r_e.dtype)
    r_e = r_e * w[:, None]
    Ji = Ji * w[:, None, None]
    Jj = Jj * w[:, None, None]

    # gps
    r_g, Jg = _gps_rJ(graph.Rs[graph.g_i], graph.ts[graph.g_i], graph.g_t)
    wg = graph.g_mask.to(r_g.dtype)
    r_g = r_g * graph.g_sqrt_info * wg[:, None]
    Jg = Jg * graph.g_sqrt_info[:, :, None] * wg[:, None, None]

    # prior (a one-element index: indexing with the 0-dim device tensor
    # itself would read it back to the host)
    p_i = graph.prior_i.reshape(1)
    Rp = graph.Rs[p_i][0]
    tp = graph.ts[p_i][0]
    z = torch.zeros(6, dtype=Rp.dtype, device=Rp.device)

    def f(a):
        r = _prior_residual(a, Rp, tp, graph.prior_R, graph.prior_t)
        return r, r

    Jp, r_p = jacfwd(f, has_aux=True)(z)
    r_p = r_p * graph.prior_sqrt_info
    Jp = Jp * graph.prior_sqrt_info[:, None]

    return (r_e, Ji, Jj), (r_g, Jg), (r_p, Jp)


# The per-factor and per-node products of the solve, as an elementwise
# product and a sum over the last axis. cuBLAS picks the kernel of a batched
# product, and with it a row's rounding, by the batch size, so with einsums
# the card's solve moved with the ring capacity; this form gives a row the
# same bits at any batch size (tests/test_torch_segment_sum.py).

def _bmv(M, v):
    """M [B, m, n] times v [B, n] -> [B, m]."""
    return (M * v[..., None, :]).sum(-1)


def _jt(J, r):
    """J^T r per factor: J [E, R, 6], r [E, R] -> [E, 6]."""
    return (J.transpose(-1, -2).contiguous() * r[..., None, :]).sum(-1)


def _jtj(J):
    """J^T J per factor: J [E, R, 6] -> [E, 6, 6]."""
    Jt = J.transpose(-1, -2).contiguous()
    return (Jt[..., :, None, :] * Jt[..., None, :, :]).sum(-1)


class NormalTerms(NamedTuple):
    """The linearized factors of one GN step, masked and whitened: what the
    matvec ``H x`` is made of."""
    Ji: torch.Tensor  # [E, 6, 6]
    Jj: torch.Tensor  # [E, 6, 6]
    Jg: torch.Tensor  # [G, 3, 6]
    Jp: torch.Tensor  # [6, 6]
    e_i: torch.Tensor  # [E]
    e_j: torch.Tensor  # [E]
    g_i: torch.Tensor  # [G]
    p_i: torch.Tensor  # [1]
    plan: SegmentPlan  # over [e_i, e_j, g_i, p_i]


def _plan(graph: PoseGraph) -> SegmentPlan:
    """The node sums' plan over [e_i, e_j, g_i, p_i]: the endpoints are
    fixed over a solve, so one plan serves its every GN step."""
    idx = [graph.e_i, graph.e_j, graph.g_i, graph.prior_i.reshape(1)]
    return SegmentPlan(idx, graph.Rs.shape[0])


def _build_normal_terms(graph: PoseGraph, free_mask, plan: SegmentPlan | None = None):
    """Linearize and return (rhs [K,6], block-diag [K,6,6], NormalTerms):
    ``ops.linearize.linearize_normal``, one launch on the card (every lane
    under vmap), its plain version on the CPU. The node sums add in the
    plan's sorted order (the chained index_adds of pose_graph.py:192-214 of
    the JAX package, in its order of blocks); out of place, so the solve
    also runs under torch.func.vmap (one graph per lane of
    pipeline/multistream.py)."""
    plan = _plan(graph) if plan is None else plan
    keys, perm = plan.sorted_rows()
    e_i, e_j, g_i, p_i = plan.index
    args = (graph.Rs, graph.ts, e_i, e_j, graph.e_Rm, graph.e_tm, graph.e_sqrt_info,
            graph.e_cauchy, graph.e_mask, g_i, graph.g_t, graph.g_sqrt_info, graph.g_mask, p_i,
            graph.prior_R, graph.prior_t, graph.prior_sqrt_info, free_mask, keys, perm)
    rhs, diag, Ji, Jj, Jg, Jp = (x[0] for x in linearize_normal(*(a[None] for a in args)))
    return rhs, diag, NormalTerms(Ji, Jj, Jg, Jp, e_i, e_j, g_i, p_i, plan)


def _normal_terms_jacfwd(graph: PoseGraph, free_mask):
    """(rhs, diag, Ji, Jj, Jg, Jp) op by op from the ``jacfwd``
    linearization, masked and summed as the JAX package's
    ``_build_normal_terms``: the oracle of ``linearize_normal`` (tests,
    chip_smoke.py)."""
    (r_e, Ji, Jj), (r_g, Jg), (r_p, Jp) = _linearize(graph)
    fm = free_mask.to(r_e.dtype)
    plan = _plan(graph)
    e_i, e_j, g_i, p_i = plan.index
    Ji = Ji * fm[e_i][:, None, None]
    Jj = Jj * fm[e_j][:, None, None]
    Jg = Jg * fm[g_i][:, None, None]
    Jp = Jp * fm[p_i][0]
    rhs = plan.sum([-_jt(Ji, r_e), -_jt(Jj, r_e), -_jt(Jg, r_g), -(Jp.T @ r_p)[None]])
    diag = plan.sum([_jtj(Ji), _jtj(Jj), _jtj(Jg), (Jp.T @ Jp)[None]])
    return rhs, diag, Ji, Jj, Jg, Jp


def _matvec(t: NormalTerms):
    """``H x`` op by op (x [K, 6]): the distributed solver's operator."""

    def matvec(x):
        yi = _bmv(t.Ji, x[t.e_i])
        yj = _bmv(t.Jj, x[t.e_j])
        y_e = yi + yj
        y_g = _bmv(t.Jg, x[t.g_i])
        y_p = t.Jp @ x[t.p_i][0]
        return t.plan.sum([_jt(t.Ji, y_e), _jt(t.Jj, y_e), _jt(t.Jg, y_g), (t.Jp.T @ y_p)[None]])

    return matvec


def _block_jacobi(precond_blocks, damping: float):
    """The preconditioner's inverted blocks, (diag + (damping + 1e-6) I)^-1."""
    eye = torch.eye(6, dtype=precond_blocks.dtype, device=precond_blocks.device)
    blocks = precond_blocks + eye[None] * (damping + 1e-6)
    return torch.linalg.inv_ex(blocks)[0]  # [K, 6, 6]; no host sync


def _sum_dot(a, b):
    return torch.sum(a * b)


def _pcg(matvec, rhs, precond_blocks, iters: int, damping: float, dot=_sum_dot):
    """Block-Jacobi preconditioned CG for (H + damping I) x = rhs, op by op.

    A fixed number of iterations in a Python loop (a ``lax.scan`` in
    pose_graph.py:252 of the JAX package); nothing inside reads the device.
    ``dot`` is the inner product: the distributed solver passes one that
    sums over the ranks' blocks (``dist/shard_map_solver.py``). The
    single-device solve runs the same iteration as one kernel
    (:func:`_pcg_fused`).
    """
    Minv = _block_jacobi(precond_blocks, damping)

    def apply_M(r):
        return _bmv(Minv, r)

    def A(x):
        return matvec(x) + damping * x

    x = torch.zeros_like(rhs)
    r = rhs
    z = apply_M(r)
    p = z
    rz = dot(r, z)

    for _ in range(iters):
        Ap = A(p)
        denom = dot(p, Ap)
        alpha = torch.where(torch.abs(denom) > 1e-20, rz / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_M(r)
        rz_new = dot(r, z)
        beta = torch.where(torch.abs(rz) > 1e-20, rz_new / rz, 0.0)
        p = z + beta * p
        rz = rz_new
    return x


def _pcg_fused(rhs, diag, t: NormalTerms, iters: int, damping: float):
    """:func:`_pcg` on ``H`` of ``t`` as one ``ops.pcg.pcg_solve`` call: one
    launch on the card (every lane under vmap), the plain version on the
    CPU, each in a fixed order of operations."""
    keys, perm = t.plan.sorted_rows()
    one = (t.Ji, t.Jj, t.Jg, t.Jp, t.e_i, t.e_j, t.g_i, t.p_i, keys, perm,
           _block_jacobi(diag, damping), rhs)
    return pcg_solve(*(a[None] for a in one), iters, damping)[0]


class SolveParams(NamedTuple):
    gn_iters: int = 6
    pcg_iters: int = 64
    damping: float = 1e-4
    # inner CG iterations of the communication-avoiding preconditioner; only
    # the distributed solver reads it (dist/shard_map_solver.py)
    inner_iters: int = 0


def solve(
    graph: PoseGraph,
    free_from=0,
    params: SolveParams = SolveParams(),
) -> PoseGraph:
    """Optimize node poses; nodes with index < free_from stay frozen.

    ``free_from=0`` is a full batch relaxation (the loop/GPS path);
    ``free_from=count-W`` gives the cheap trailing-window incremental step.
    """
    K = graph.Rs.shape[0]
    idx = torch.arange(K, device=graph.Rs.device)
    free_mask = graph.node_mask & (idx >= free_from)

    plan = _plan(graph)
    # fixed-length Python loop in place of lax.scan (pose_graph.py:289)
    for _ in range(params.gn_iters):
        rhs, diag, terms = _build_normal_terms(graph, free_mask, plan)
        dx = _pcg_fused(rhs, diag, terms, params.pcg_iters, params.damping)
        solve.gn_steps += 1
        dx = dx * free_mask[:, None].to(dx.dtype)
        Rs, ts = se3.se3_retract(graph.Rs, graph.ts, dx)
        graph = graph._replace(Rs=Rs, ts=ts)
    return graph


solve.gn_steps = 0  # GN steps run (a vmapped solve's lanes count once)


def graph_error(graph: PoseGraph) -> torch.Tensor:
    """Total whitened squared error (for tests/diagnostics)."""
    (r_e, _, _), (r_g, _), (r_p, _) = _linearize(graph)
    return torch.sum(r_e * r_e) + torch.sum(r_g * r_g) + torch.sum(r_p * r_p)
