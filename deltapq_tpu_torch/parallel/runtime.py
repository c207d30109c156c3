"""Multi-process runtime and continuous query batching.

Counterpart of ``deltapq_tpu/parallel/runtime.py``.  No reference
counterpart: the reference is a single-process OpenMP program.

``init_distributed`` joins processes with ``torch.distributed`` (NCCL
for the cards, gloo for the CPU); after it, ``mesh.make_mesh`` spans
every process.

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
from typing import Callable, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None) -> int:
    """Join this process to a ``torch.distributed`` default group;
    returns the world size.

    With no arguments nothing is joined: the size of an already
    initialized default group, else 1.  With them, ``init_process_group``
    over ``tcp://{coordinator_address}`` (``host:port``) with
    ``num_processes`` ranks, this one ``process_id``; the backend is NCCL
    for a CUDA ``device`` (None: the card) and gloo for the CPU.  A
    missing NCCL raises: no other backend takes its place."""
    if coordinator_address is None and num_processes is None:
        return (dist.get_world_size()
                if dist.is_available() and dist.is_initialized() else 1)
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("init_distributed takes coordinator_address, "
                         "num_processes and process_id together")
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if not dist.is_available() or (
            backend == "nccl" and not dist.is_nccl_available()):
        raise RuntimeError(f"torch.distributed has no {backend} backend "
                           f"here")
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    return dist.get_world_size()


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
