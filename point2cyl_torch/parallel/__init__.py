"""Data parallelism and point sharding over ranks (the port of
``point2cyl_tpu/parallel``): ``mesh`` (the data axis, batch rows,
replication, global BN), ``distributed`` (joining a multi-process run,
each rank's rows and draws), ``collectives`` (the ``jax.lax``
collectives over ``torch.distributed``), ``point_sharding`` (ring
neighbour ops) and ``sharded_backbone`` (the point-sharded eval forward,
eager or captured).

JAX's exported names resolve on first use, so that a model module can
import ``parallel.collectives`` without importing the models back.
"""

__all__ = [
    "make_mesh", "replicate", "shard_batch",
    "ball_query_sharded", "farthest_point_sample_sharded", "index_points_sharded",
    "sample_and_group_sharded", "three_nn_interpolate_sharded",
    "backbone_apply_point_sharded", "ShardedForward",
]

_HOMES = {
    "make_mesh": "mesh", "replicate": "mesh", "shard_batch": "mesh",
    "ball_query_sharded": "point_sharding",
    "farthest_point_sample_sharded": "point_sharding",
    "index_points_sharded": "point_sharding",
    "sample_and_group_sharded": "point_sharding",
    "three_nn_interpolate_sharded": "point_sharding",
    "backbone_apply_point_sharded": "sharded_backbone",
    "ShardedForward": "sharded_backbone",
}


def __getattr__(name: str):
    if name in _HOMES:
        import importlib

        return getattr(importlib.import_module(f"{__name__}.{_HOMES[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
