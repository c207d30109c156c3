"""Pipelined sharded query: the cross-shard merge of one batch beside the
next batch's table build and local scan.

Counterpart of ``deltapq_tpu/parallel/pipeline.py``.  No reference
counterpart (the reference has no distributed layer).

A one-batch software pipeline over the batch stream: step i builds batch
i's ADC tables and runs every shard's local scan (``sharded.
_local_scan_topk``), then merges batch i-1's per-shard candidates
(``mesh.gather_topk``, S * B * k pairs); a flush merges the last batch.
The two stages of a step share no data.  On a card the merges run on a
second CUDA stream that waits, through an event, for the scans of its
batch, so a merge queues behind its own batch's scans and not behind the
next batch's; on the CPU the steps simply run in order.  The results
equal ``sharded_query_plain``'s, batch for batch.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..ops.adc import adc_table
from ..ops.fused import _np_f32
from .mesh import Mesh, gather_topk, make_mesh, shard_rows
from .sharded import (_codewords_on, _local_valid, _local_scan_topk,
                      _on_devices, _pad_codes_for_mesh)


def make_pipelined_query_fn(mesh: Mesh, top_k: int, tile_n: int = 8192
                            ) -> Callable:
    """Returns ``fn(codewords [M, K, Ds], qbatches [NB, B, D],
    codes_shards, n_valid) -> (dists [NB, B, top_k], ids [NB, B,
    top_k])`` on ``mesh.devices[0]``, the codes split over the mesh as
    in ``make_sharded_query_fn`` and the whole batch stream run through
    the one-batch pipeline."""
    dev0 = mesh.devices[0]
    on_card = dev0.type == "cuda"

    def run(codewords, qbatches, codes_shards, n_valid):
        cws = _on_devices(torch.as_tensor(codewords, dtype=torch.float32),
                          mesh)
        qb = torch.as_tensor(qbatches, dtype=torch.float32)
        devs = list(cws)
        merge_stream = torch.cuda.Stream(dev0) if on_card else None
        # every batch's candidates stay referenced until the end: the
        # merge stream reads them after their producer moved on
        held, outs = [], []

        def local_stage(q):
            tables = {d: adc_table(cws[d], q.to(d)) for d in devs}
            ds, ids = [], []
            for g, c in zip(mesh.shard_ids(), codes_shards):
                rows = c.shape[0]
                base = g * rows
                d, i = _local_scan_topk(
                    tables[c.device], c,
                    _local_valid(int(n_valid), base, rows), base, top_k,
                    min(tile_n, rows))
                ds.append(d)
                ids.append(i)
            events = []
            if on_card:
                for d in devs:
                    ev = torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(d))
                    events.append(ev)
            return ds, ids, events

        def merge_stage(ds, ids, events):
            ctx = (torch.cuda.stream(merge_stream) if on_card
                   else nullcontext())
            with ctx:
                for ev in events:
                    merge_stream.wait_event(ev)
                outs.append(gather_topk(mesh, ds, ids, top_k))

        prev = None
        for q in qb:
            cur = local_stage(q)
            held.append(cur)
            if prev is not None:
                merge_stage(*prev)
            prev = cur
        if prev is not None:
            merge_stage(*prev)
        if on_card:
            main = torch.cuda.current_stream(dev0)
            main.wait_stream(merge_stream)
            for o in outs:          # made on the merge stream, read here
                for t in o:
                    t.record_stream(main)
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))

    return run


def pipelined_query(codewords, queries: np.ndarray, codes: np.ndarray,
                    mesh: Optional[Mesh] = None, top_k: int = 10,
                    batch_size: int = 128, device=None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """End-to-end pipelined sharded query over a query stream (``mesh``
    None: every local device of ``device``).  Pads the query count to a
    batch multiple and the database to a shard multiple; returns NumPy
    (dists [NQ, top_k], ids [NQ, top_k])."""
    if mesh is None:
        mesh = make_mesh(device=device)
    cw = _np_f32(codewords)
    M, K, Ds = cw.shape
    D = M * Ds
    q = np.asarray(queries, np.float32)
    nq = len(q)
    if q.shape[1] < D:
        q = np.pad(q, ((0, 0), (0, D - q.shape[1])))
    nb = -(-nq // batch_size)
    q_pad = np.zeros((nb * batch_size, D), np.float32)
    q_pad[:nq] = q
    codes_pad, n_valid = _pad_codes_for_mesh(np.asarray(codes), mesh)
    fn = make_pipelined_query_fn(mesh, top_k)
    d, i = fn(_codewords_on(cw, mesh.devices[0]),
              torch.from_numpy(q_pad.reshape(nb, batch_size, D)),
              shard_rows(mesh, codes_pad), n_valid)
    d = d.cpu().numpy().reshape(nb * batch_size, top_k)[:nq]
    i = i.cpu().numpy().reshape(nb * batch_size, top_k)[:nq]
    return d, i
