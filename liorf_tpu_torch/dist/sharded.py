"""Distributed pose-graph optimization over a process group.

The scaling axis of a SLAM engine is trajectory/map growth: keyframe nodes
and factor edges are split in contiguous blocks over the ranks of a
``torch.distributed`` process group, one rank per device. The JAX package
compiles ``pose_graph.solve`` under GSPMD and lets XLA place the
collectives; PyTorch has no GSPMD, so here every collective is explicit and
``solve_sharded`` runs the explicit-collective solver of
``dist/shard_map_solver.py`` (identical semantics to ``pose_graph.solve``).

* ``GraphMesh`` — the group, this rank, the world size, the device, and the
  three collectives the solvers use (tiled all-gather and reduce-scatter on
  dim 0, sum all-reduce), each counted by kind in ``mesh.counts``;
* ``make_mesh(n)`` — a mesh over an already initialised group (it never
  starts processes: ``dist/multihost.py`` and ``dist/launch.py`` do);
* ``solve_sharded(graph, mesh, ...)`` — split the graph over the mesh and
  solve; every rank gets the whole solved graph back.
"""

from __future__ import annotations

import warnings
from collections import Counter

import torch
import torch.distributed as tdist

from ..graph import pose_graph as pg


class GraphMesh:
    """A 1-D mesh of ``size`` ranks on the ``graph`` axis.

    Collectives act on tensors on ``device``: NCCL between cards, gloo
    between CPU processes, and gloo also for several ranks sharing one card
    (it takes CUDA tensors for all three collectives and stages them through
    the host itself)."""

    def __init__(self, group, rank: int, size: int, device: torch.device):
        self.group = group
        self.rank = rank
        self.size = size
        self.device = torch.device(device)
        self.counts: Counter = Counter()  # collectives issued, by kind

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[n, ...] on each rank -> [size * n, ...], rank r's block at r * n."""
        self.counts["all_gather"] += 1
        x = x.contiguous()
        out = x.new_empty((self.size * x.shape[0], *x.shape[1:]))
        tdist.all_gather_into_tensor(out, x, group=self.group)
        return out

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """[size * n, ...] on each rank -> this rank's block [n, ...] of the
        sum over ranks."""
        self.counts["reduce_scatter"] += 1
        if x.shape[0] % self.size:
            raise ValueError(f"reduce_scatter: dim 0 ({x.shape[0]}) does not divide {self.size}")
        x = x.contiguous()
        out = x.new_empty((x.shape[0] // self.size, *x.shape[1:]))
        tdist.reduce_scatter_tensor(out, x, op=tdist.ReduceOp.SUM, group=self.group)
        return out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over ranks (a new tensor; ``x`` is left as it was)."""
        self.counts["all_reduce"] += 1
        buf = x.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(buf, op=tdist.ReduceOp.SUM, group=self.group)
        return buf

    def block(self, n: int) -> slice:
        """This rank's contiguous block of a leading axis of length ``n``
        (``n`` a multiple of ``size``)."""
        if n % self.size:
            raise ValueError(f"length {n} does not divide the {self.size}-rank mesh")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Pad ``x`` on dim 0 to a multiple of ``size`` with zeros (False for
        masks) and return this rank's block of it."""
        extra = -x.shape[0] % self.size
        if extra:
            x = torch.cat([x, x.new_zeros((extra, *x.shape[1:]))])
        return x[self.block(x.shape[0])]


def make_mesh(n_devices: int | None = None, group=None, device=None) -> GraphMesh:
    """A mesh over the already initialised default group (or ``group``).

    ``n_devices``, when given, must equal the world size. ``device=None``
    means ``cuda:{rank % device_count}`` (one card per rank) and raises
    without CUDA; ``device="cpu"`` runs the collectives on host tensors."""
    if not tdist.is_initialized():
        raise RuntimeError(
            "make_mesh: no process group; call dist.multihost.init_multihost "
            "(or torch.distributed.init_process_group) first"
        )
    size = tdist.get_world_size(group)
    rank = tdist.get_rank(group)
    # torch >= 2.12 renames the tensor collectives (*_single); the names used
    # here exist on every supported version, so the rename warning is noise
    warnings.filterwarnings(
        "ignore", message=r".*is deprecated\. Please use `torch\.distributed\..*_single",
        category=FutureWarning,
    )
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, the group has {size}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' to run on the CPU")
        device = f"cuda:{rank % torch.cuda.device_count()}"
    return GraphMesh(group, rank, size, torch.device(device))


_NODE_FIELDS = ("Rs", "ts", "node_mask")
_EDGE_FIELDS = ("e_i", "e_j", "e_Rm", "e_tm", "e_sqrt_info", "e_cauchy", "e_mask")
_GPS_FIELDS = ("g_i", "g_t", "g_sqrt_info", "g_mask")


def graph_shardings(mesh: GraphMesh, graph: pg.PoseGraph) -> pg.PoseGraph:
    """This rank's slice of every ``PoseGraph`` field of a graph padded to
    the mesh (``shard_map_solver._pad_graph``): nodes, between factors and
    GPS factors in contiguous blocks; None for the prior, which every rank
    keeps whole."""
    K, E, G = graph.Rs.shape[0], graph.e_i.shape[0], graph.g_i.shape[0]
    spans = {**dict.fromkeys(_NODE_FIELDS, mesh.block(K)),
             **dict.fromkeys(_EDGE_FIELDS, mesh.block(E)),
             **dict.fromkeys(_GPS_FIELDS, mesh.block(G))}
    return pg.PoseGraph(**{f: spans.get(f) for f in pg.PoseGraph._fields})


def shard_graph(graph: pg.PoseGraph, mesh: GraphMesh) -> pg.PoseGraph:
    """This rank's block of a padded graph, on the mesh's device (factor
    indices stay global)."""
    spans = graph_shardings(mesh, graph)
    return pg.PoseGraph(*(
        (x if s is None else x[s]).to(mesh.device) for x, s in zip(graph, spans)
    ))


def solve_sharded(
    graph: pg.PoseGraph,
    mesh: GraphMesh,
    free_from=0,
    params: pg.SolveParams = pg.SolveParams(),
) -> pg.PoseGraph:
    """Split the graph over the mesh and solve; identical semantics to
    ``pose_graph.solve``. Every rank passes the same graph and gets the
    whole solved graph back."""
    from .shard_map_solver import solve_shard_map

    return solve_shard_map(graph, mesh, free_from=free_from, params=params)
