"""The multi-device layer and the query runtime.

Counterpart of ``deltapq_tpu/parallel``: the mesh (``mesh``), the
sharded plain, decoded and compressed queries and the data-parallel
Lloyd step (``sharded``, ``pipeline``, ``sharded_tree``), the sharded
slot-tile engine (``fused_sharded``), ``init_distributed``,
``ContinuousBatcher`` and ``batch_iterator`` (``runtime``).
"""

from .mesh import make_mesh, shard_rows, replicated, pad_to_shards
from .sharded import (make_sharded_query_fn, sharded_query_plain,
                      make_dp_lloyd_step, make_sharded_decoded_query_fn,
                      sharded_query_decoded)
from .pipeline import make_pipelined_query_fn, pipelined_query
from .fused_sharded import ShardedCompressedEngine
from .runtime import ContinuousBatcher, batch_iterator, init_distributed

__all__ = [
    "make_mesh", "shard_rows", "replicated", "pad_to_shards",
    "make_sharded_query_fn", "sharded_query_plain", "make_dp_lloyd_step",
    "make_sharded_decoded_query_fn", "sharded_query_decoded",
    "make_pipelined_query_fn", "pipelined_query",
    "ShardedCompressedEngine",
    "ContinuousBatcher", "batch_iterator", "init_distributed",
]
