"""Exact brute-force top-k groundtruth.

Counterpart of ``deltapq_tpu/eval/groundtruth.py`` (``exact_topk``;
``groundtruth_from_file`` waits for ``io/``).  The distance matrix of a
(query batch x database tile) is one f32 matrix product with TF32 off
(``d2 = |q|^2 - 2 q x^T + |x|^2``), with a running top-k merged per
tile.  Plain PyTorch: the JAX package computes it in XLA.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.adc import no_tf32


def _exact_tile_topk(q, x_tile, base: int, n_valid: int, best_d, best_i,
                     top_k: int):
    """Merge one database tile into the running (best_d, best_i)."""
    B = q.shape[0]
    tile = x_tile.shape[0]
    q2 = torch.sum(q * q, dim=1, keepdim=True)
    x2 = torch.sum(x_tile * x_tile, dim=1)
    with no_tf32():
        d2 = q2 - 2.0 * torch.mm(q, x_tile.t()) + x2[None, :]
    ids = base + torch.arange(tile, dtype=torch.int32, device=q.device)
    d2 = torch.where((ids < n_valid)[None, :], d2,
                     torch.full_like(d2, float("inf")))
    cat_d = torch.cat([best_d, d2], dim=1)
    cat_i = torch.cat([best_i, ids[None, :].expand(B, tile)], dim=1)
    top, pos = torch.topk(cat_d, top_k, dim=1, largest=False, sorted=True)
    return top, torch.gather(cat_i, 1, pos)


def exact_topk(queries: np.ndarray, base_iter, top_k: int = 100,
               tile_n: int = 65536, device=None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact top-k over a database streamed as an iterable of [tile, D]
    arrays (or a single [N, D] array), on ``device``.

    Returns (dists [B, top_k] squared-L2 ascending, ids [B, top_k] i32).
    """
    device = resolve_device(device)
    q = torch.from_numpy(np.asarray(queries, np.float32)).to(device)
    B = q.shape[0]
    if isinstance(base_iter, np.ndarray):
        arr = base_iter
        base_iter = (arr[i:i + tile_n] for i in range(0, len(arr), tile_n))
    best_d = torch.full((B, top_k), float("inf"), dtype=torch.float32,
                        device=device)
    best_i = torch.full((B, top_k), -1, dtype=torch.int32, device=device)
    offset = 0
    for x_tile in base_iter:
        # integer (bvecs-style) tiles cross to the device in their narrow
        # dtype and are widened there
        x_tile = np.asarray(x_tile)
        if x_tile.dtype not in (np.uint8, np.int8):
            x_tile = x_tile.astype(np.float32, copy=False)
        n = len(x_tile)
        xd = torch.from_numpy(np.ascontiguousarray(x_tile)).to(device)
        best_d, best_i = _exact_tile_topk(
            q, xd.to(torch.float32), offset, offset + n, best_d, best_i,
            top_k)
        offset += n
    order = torch.argsort(best_d, dim=1, stable=True)
    return (torch.gather(best_d, 1, order).cpu().numpy(),
            torch.gather(best_i, 1, order).cpu().numpy())
