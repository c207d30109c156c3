"""Continuous query batching.

Counterpart of ``ContinuousBatcher`` and ``batch_iterator`` in
``deltapq_tpu/parallel/runtime.py`` (``init_distributed`` waits for the
multi-GPU port, ROADMAP A5).  No reference counterpart: the reference is
a single-process OpenMP program.

``ContinuousBatcher`` keeps a bounded window of batches in flight
(default 2 = double buffering).  A query function that returns tensors
on a card returns once the batch's work is queued; the batcher then
queues the copy of its results into pinned host memory behind that work
and records an event, so batch i's results are fetched (one event wait)
while batch i+1 already runs on the card.  Queueing the copy right after
its batch keeps it ahead of the next batch on the stream: a plain
``.cpu()`` at fetch time would wait for the next batch too.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterable, Iterator, Tuple

import numpy as np
import torch


def _to_host_async(out):
    """Queue the copy of a query function's (dists, ids) to the host.
    Tensors on a card go to pinned buffers behind the work that makes
    them, with an event recorded after the copies; host values pass
    through."""
    if not any(isinstance(t, torch.Tensor) and t.is_cuda for t in out):
        return out, None
    host = []
    for t in out:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def _fetch(item) -> Tuple[np.ndarray, np.ndarray]:
    out, ev = item
    if ev is not None:
        ev.synchronize()
    return tuple(t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
                 for t in out)


class ContinuousBatcher:
    """Stream query batches through a query function with a bounded
    in-flight window (default 2 = double buffering).

    query_fn: (queries [B, D] NumPy) -> (dists, ids), tensors on the
    device or host arrays.  The returned iterator yields NumPy (dists,
    ids) per input batch in order, fetching batch i once batch
    i+depth-1 is queued.
    """

    def __init__(self, query_fn: Callable, depth: int = 2):
        self.query_fn = query_fn
        self.depth = max(1, depth)

    def run(self, batches: Iterable[np.ndarray]
            ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        inflight = collections.deque()
        for q in batches:
            inflight.append(_to_host_async(self.query_fn(q)))
            if len(inflight) >= self.depth:
                yield _fetch(inflight.popleft())
        while inflight:
            yield _fetch(inflight.popleft())


def batch_iterator(queries: np.ndarray, batch_size: int,
                   pad_to_batch: bool = True) -> Iterator[np.ndarray]:
    """Slice a query set into fixed-size batches (padding the tail with
    repeated rows so every dispatch has the same shape)."""
    n = len(queries)
    for off in range(0, n, batch_size):
        q = queries[off:off + batch_size]
        if pad_to_batch and len(q) < batch_size:
            reps = -(-batch_size // len(q))
            q = np.tile(q, (reps, 1))[:batch_size]
        yield q
