"""Query runtime: continuous batching (``runtime``).

Counterpart of ``deltapq_tpu/parallel``; so far ``ContinuousBatcher``
and ``batch_iterator``.  The mesh, the sharded engines and
``init_distributed`` are not ported yet (ROADMAP A5).
"""

from .runtime import ContinuousBatcher, batch_iterator

__all__ = ["ContinuousBatcher", "batch_iterator"]
