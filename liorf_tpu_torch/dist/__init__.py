"""Distributed modes over ``torch.distributed``: the keyframe-sharded
pose-graph solvers, point-sharded registration, the sharded ScanContext
search and the sharded resident pipeline. The multi-process runtime is
``dist.multihost`` (run as a module by ``dist.launch``)."""

from .resident_sharded import ShardedResidentPipeline
from .shard_map_solver import solve_shard_map
from .sharded import GraphMesh, make_mesh, shard_graph, solve_sharded
from .sharded_frontend import detect_loop_sharded, scan_to_map_sharded

__all__ = [
    "GraphMesh", "ShardedResidentPipeline", "detect_loop_sharded", "make_mesh",
    "scan_to_map_sharded", "shard_graph", "solve_shard_map", "solve_sharded",
]
