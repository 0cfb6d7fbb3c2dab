"""Explicit-collective distributed pose-graph solver over ``torch.distributed``.

The JAX package writes this solver as a ``shard_map`` body with ``psum``s
(``liorf_tpu/dist/shard_map_solver.py``); here each rank is one process and
every collective is a call on a ``GraphMesh`` (``dist/sharded.py``):

* **nodes** (keyframe poses, PCG vectors, block preconditioner) are split in
  contiguous blocks over the ranks — per-rank node work is O(K/n);
* **factors** (between/GPS) are split in blocks the same way — per-rank
  linearization work is O(E/n);
* per GN step: an all-gather each of the rotations and translations, one
  reduce-scatter each of the right-hand side and the block diagonal;
* per PCG matvec: one all-gather of the [K, 6] search direction plus one
  reduce-scatter of the factor contributions; per dot product one scalar
  all-reduce (the flexible CG sums its two scalars in one).

Every rank passes the same host graph and gets the whole solved graph back.
"""

from __future__ import annotations

import torch

from ..core import se3
from ..graph import pose_graph as pg
from ..graph.pose_graph import SolveParams
from ..ops.segment_sum import SegmentPlan
from .sharded import GraphMesh, shard_graph


def _pad_graph(graph: pg.PoseGraph, n: int) -> tuple[pg.PoseGraph, int]:
    """Pad node and factor arrays so every leading dim divides the rank
    count. Pad slots carry mask=False (factors) / node_mask=False (nodes)
    and identity rotations; padded nodes sit at the end so factor indices
    stay valid."""

    def pad(x, target):
        extra = target - x.shape[0]
        if extra == 0:
            return x
        return torch.cat([x, x.new_zeros((extra, *x.shape[1:]))])

    def pad_rot(x, target):
        extra = target - x.shape[0]
        if extra == 0:
            return x
        eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(extra, 3, 3)
        return torch.cat([x, eye])

    K, E, G = graph.Rs.shape[0], graph.e_i.shape[0], graph.g_i.shape[0]
    Kp, Ep, Gp = (-(-d // n) * n for d in (K, E, G))
    return graph._replace(
        Rs=pad_rot(graph.Rs, Kp), ts=pad(graph.ts, Kp),
        node_mask=pad(graph.node_mask, Kp),
        e_i=pad(graph.e_i, Ep), e_j=pad(graph.e_j, Ep),
        e_Rm=pad_rot(graph.e_Rm, Ep), e_tm=pad(graph.e_tm, Ep),
        e_sqrt_info=pad(graph.e_sqrt_info, Ep),
        e_cauchy=pad(graph.e_cauchy, Ep), e_mask=pad(graph.e_mask, Ep),
        g_i=pad(graph.g_i, Gp), g_t=pad(graph.g_t, Gp),
        g_sqrt_info=pad(graph.g_sqrt_info, Gp), g_mask=pad(graph.g_mask, Gp),
    ), Kp


def _prior_terms(graph: pg.PoseGraph, first: bool) -> pg.PoseGraph:
    """The prior counts once: on the first rank at its weight, on every
    other rank with zero information (so its terms vanish)."""
    return graph if first else graph._replace(
        prior_sqrt_info=torch.zeros_like(graph.prior_sqrt_info)
    )


def _local_factor_terms(graph: pg.PoseGraph, Rs_g, ts_g, free_w):
    """Linearize this rank's factor block (and the prior, see
    ``_prior_terms``) against the gathered poses.

    Returns rhs [K, 6] and diag [K, 6, 6] over the FULL node range (to be
    reduce-scattered), the local matvec over gathered [K, 6] vectors, and
    the masked Jacobians (Ji, Jj, Jg)."""
    g = graph._replace(Rs=Rs_g, ts=ts_g)
    rhs, diag, t = pg._build_normal_terms(g, free_w > 0)
    return rhs, diag, pg._matvec(t), (t.Ji, t.Jj, t.Jg)


def _local_matvec(graph: pg.PoseGraph, Ji, Jj, Jg, Kl: int, offset: int):
    """Shard-LOCAL normal-equation operator (additive-Schwarz block).

    Restricts this rank's factor block to its own node range
    [offset, offset + Kl): couplings to other ranks' nodes are clipped
    (standard Schwarz truncation — each clipped J^T J term stays PSD, and
    the outer damping keeps the local operator SPD). Applying it needs no
    collective: it is the inner solve of the communication-avoiding
    inner-outer PCG.

    Also returns the operator's own [Kl, 6, 6] block diagonal, so the caller
    can complete it to the true global one: the clipped operator alone
    leaves each block's gauge directions nearly unconstrained, and an inner
    CG would amplify them."""
    li, lj, lg = graph.e_i - offset, graph.e_j - offset, graph.g_i - offset
    wi = ((li >= 0) & (li < Kl)).to(Ji.dtype)
    wj = ((lj >= 0) & (lj < Kl)).to(Jj.dtype)
    wg = ((lg >= 0) & (lg < Kl)).to(Jg.dtype)
    li, lj, lg = (torch.clamp(x, 0, Kl - 1) for x in (li, lj, lg))
    # the scatter-adds of every inner matvec, in a fixed order on the card
    plan = SegmentPlan([li, lj, lg], Kl)

    def jt(J, r, w):  # J^T r per factor, clipped
        return pg._jt(J, r) * w[:, None]

    def matvec(x_l):  # x_l: [Kl, 6] local
        yi = torch.einsum("eri,ei->er", Ji, x_l[li]) * wi[:, None]
        yj = torch.einsum("eri,ei->er", Jj, x_l[lj]) * wj[:, None]
        y_e = yi + yj
        y_g = torch.einsum("gri,gi->gr", Jg, x_l[lg]) * wg[:, None]
        return plan.sum([jt(Ji, y_e, wi), jt(Jj, y_e, wj), jt(Jg, y_g, wg)])

    def jtj(J, w):
        return torch.einsum("eri,erj->eij", J, J) * w[:, None, None]

    diag_own = plan.sum([jtj(Ji, wi), jtj(Jj, wj), jtj(Jg, wg)])
    return matvec, diag_own


def _where_nonzero(den, num):
    return torch.where(torch.abs(den) > 1e-20, num / den, 0.0)


def _flexible_pcg(A, A_loc, rhs_l, Minv_l, params: SolveParams, mesh: GraphMesh):
    """Communication-avoiding inner-outer PCG: the preconditioner is an
    inner CG of ``params.inner_iters`` steps on the shard-local operator
    (no collective); the outer CG is flexible (Polak-Ribiere: the inner
    solve is only approximately linear, so beta uses z'(r_new - r_old)).
    ``pcg_iters`` counts outer iterations, each four collectives."""

    def apply_bj(r):
        return torch.einsum("kij,kj->ki", Minv_l, r)

    def apply_M(r):
        x = torch.zeros_like(r)
        rr = r
        p = apply_bj(r)
        rz = torch.sum(r * p)
        for _ in range(params.inner_iters):
            Ap = A_loc(p)
            alpha = _where_nonzero(torch.sum(p * Ap), rz)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = apply_bj(rr)
            rz_new = torch.sum(rr * z)
            p = z + _where_nonzero(rz, rz_new) * p
            rz = rz_new
        return x

    x = torch.zeros_like(rhs_l)
    r = rhs_l
    z = apply_M(r)
    p = z
    rz = mesh.all_reduce(torch.sum(r * z))
    for _ in range(params.pcg_iters):
        Ap = A(p)
        alpha = _where_nonzero(mesh.all_reduce(torch.sum(p * Ap)), rz)
        x = x + alpha * p
        r_new = r - alpha * Ap
        z_new = apply_M(r_new)
        # one fused reduction for both scalars
        pair = mesh.all_reduce(torch.stack([torch.sum(r_new * z_new), torch.sum(r * z_new)]))
        beta = _where_nonzero(rz, pair[0] - pair[1])
        r, rz, p = r_new, pair[0], z_new + beta * p
    return x


def _shard_body(graph: pg.PoseGraph, free_w_g, params: SolveParams, mesh: GraphMesh):
    """One rank's solve: ``graph`` is its node block [Kl, ...] and factor
    block (global indices), ``free_w_g`` [K] the free weight of every node.
    Returns the gathered (whole) rotations and translations."""
    n, Kl = mesh.size, graph.Rs.shape[0]
    K = Kl * n
    offset = mesh.rank * Kl
    free_local = free_w_g[offset:offset + Kl]
    graph = _prior_terms(graph, mesh.rank == 0)
    eye = torch.eye(6, dtype=graph.ts.dtype, device=graph.ts.device)

    Rs_l, ts_l = graph.Rs, graph.ts
    for _ in range(params.gn_iters):
        Rs_g, ts_g = mesh.all_gather(Rs_l), mesh.all_gather(ts_l)
        rhs_f, diag_f, mv_f, jacs = _local_factor_terms(graph, Rs_g, ts_g, free_w_g)
        # one reduce-scatter each: full-range contributions -> local block
        rhs_l = mesh.reduce_scatter(rhs_f)  # [Kl, 6]
        diag_l = mesh.reduce_scatter(diag_f)  # [Kl, 6, 6]

        def A(x_l, mv_f=mv_f):
            # all-gather the direction, local factor matvec, reduce-scatter
            return mesh.reduce_scatter(mv_f(mesh.all_gather(x_l)))

        if params.inner_iters > 0:
            mv_loc, diag_own = _local_matvec(graph, *jacs, Kl, offset)
            # complete the clipped operator's block diagonal to the true
            # global one (diag_l holds every rank's factors and the prior)
            diag_corr = diag_l - diag_own

            def A_loc(x_l, mv_loc=mv_loc, diag_corr=diag_corr):
                return (mv_loc(x_l) + torch.einsum("kij,kj->ki", diag_corr, x_l)
                        + params.damping * x_l)

            Minv_l, _ = torch.linalg.inv_ex(diag_l + eye * (params.damping + 1e-6))
            dx_l = _flexible_pcg(
                lambda x_l: A(x_l) + params.damping * x_l, A_loc, rhs_l, Minv_l, params, mesh
            )
        else:
            def dot(a, b):
                return mesh.all_reduce(torch.sum(a * b))

            dx_l = pg._pcg(A, rhs_l, diag_l, params.pcg_iters, params.damping, dot=dot)

        dx_l = dx_l * free_local[:, None]
        Rs_l, ts_l = se3.se3_retract(Rs_l, ts_l, dx_l)
    # gathered (replicated) poses, so every rank sees the whole graph
    return mesh.all_gather(Rs_l), mesh.all_gather(ts_l)


def solve_shard_map(
    graph: pg.PoseGraph,
    mesh: GraphMesh,
    free_from=0,
    params: SolveParams = SolveParams(),
) -> pg.PoseGraph:
    """Distributed GN/PCG with explicit collectives; same semantics as
    ``pose_graph.solve``. Called collectively by every rank with the same
    graph; returns the whole solved graph on every rank, on the graph's
    device."""
    K = graph.Rs.shape[0]
    padded, Kp = _pad_graph(graph, mesh.size)
    idx = torch.arange(Kp, device=padded.Rs.device)
    free_w = (padded.node_mask & (idx >= free_from)).to(torch.float32).to(mesh.device)
    Rs, ts = _shard_body(shard_graph(padded, mesh), free_w, params, mesh)
    return graph._replace(Rs=Rs[:K].to(graph.Rs.device), ts=ts[:K].to(graph.ts.device))
