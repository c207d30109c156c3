"""The flagship forward step, for a caller that wants one callable.

Counterpart of ``entry`` in the repository's ``__graft_entry__.py``:
``entry()`` returns ``(fwd, args)``, where ``fwd(*args)`` is the batched
compressed-tier ADC query step -- the exact f32 ADC tables, the
slot-tile scan (kernel B5, ``csrc/delta_mins.cu``) at bf16, then
``select_rerank`` with the rerank kernel B2 (``csrc/rerank.cu``) -- over
the same inputs as the JAX step: M=8, K=256, Ds=16, B=128 queries and
N=16,384 chain codes, all drawn from seed 0.  On a card the kernels run
(there is no fallback to their plain versions); with ``device="cpu"``
the wrappers run the plain versions.  ``step`` is the same step with the
per-query exactness certificate as a third output.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .ops import fused_kernels as fk
from .ops.adc import adc_table
from .ops.delta_tiles import build_delta_tiles
from .ops.fused import _default_n_sub, _pool_for

M, K, Ds = 8, 256, 16
B, N, TOP_K = 128, 16384, 10


def step(cw_t, q_t, qc_t, cwbd_t, rd, ovf):
    """The flagship step over ``entry``'s args: (dists [B, top_k] exact
    f32 ascending, scan rows [B, top_k], ok [B], the rerank's
    exactness certificate).  The slot count, the pool and the rung come
    from the tile arrays, as ``entry`` builds them."""
    n_pad = rd.shape[0] * fk.TILE
    S = rd.shape[1] - (M + 7) // 8
    ns_total = n_pad // fk.SUB
    pool = _pool_for(ns_total)
    ns = _default_n_sub(TOP_K, -(-ns_total // pool), fk.SUB * pool)
    table = adc_table(cw_t, q_t)
    q2 = torch.sum(qc_t * qc_t, dim=1)
    compact = (fk.compact_codebook(cwbd_t, M, Ds, "bf16")
               if cwbd_t.device.type == "cuda" else None)
    mins, echo = fk.fused_delta_mins(
        qc_t.to(torch.bfloat16).t().contiguous(), cwbd_t, rd, ovf, N, S,
        compact=compact, mode="bf16")
    return fk.select_rerank(mins.t().contiguous(), q2, table, echo, N,
                            TOP_K, ns, pool)


def entry(device=None):
    """(fwd, args) of the flagship step on ``device`` (None: the card).
    ``fwd(*args)`` returns (dists [B, top_k] exact f32 ascending, scan
    rows [B, top_k])."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    cw = rng.normal(size=(M, K, Ds)).astype(np.float32)
    queries = rng.normal(size=(B, M * Ds)).astype(np.float32)
    # chain codes: a compressible database for the slot tiles
    codes = np.empty((N, M), np.uint8)
    codes[0] = rng.integers(0, K, size=M)
    for i in range(1, N):
        codes[i] = codes[i - 1]
        codes[i, rng.integers(0, M)] = rng.integers(0, K)
    tiles = build_delta_tiles(codes)
    mu = fk.codebook_center(cw)
    cwbd = fk.build_blockdiag_codebook(cw, center=mu)
    qc = queries - mu[None, :]

    def fwd(*args):
        return step(*args)[:2]

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return fwd, (up(cw), up(queries), up(qc), cwbd.to(dev),
                 up(tiles.row_data), up(tiles.ovf))
