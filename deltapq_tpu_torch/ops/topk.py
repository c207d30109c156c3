"""Top-k selection helper.

Counterpart of ``deltapq_tpu/ops/topk.py``.  The JAX function picks
between an exact ``lax.top_k`` and ``lax.approx_min_k``, an accelerator
op of the TPU that has no counterpart on this card; here every
``select`` value selects exactly with ``torch.topk`` (an intended
divergence: the results are the exact ones the JAX function's "exact"
gives).
"""

from __future__ import annotations

from typing import Tuple

import torch

SELECTS = ("auto", "exact", "approx")


def smallest_k(dists: torch.Tensor, top_k: int, select: str = "auto"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values [B, k] ascending, indices [B, k] int64) of the smallest
    entries per row.  select: "exact" | "approx" | "auto", all exact
    here.  With ``top_k`` beyond the row length everything is selected
    and padded with (+inf, -1)."""
    if select not in SELECTS:
        raise ValueError(f"unknown select {select!r}")
    B, n = dists.shape
    vals, idx = torch.topk(dists, min(top_k, n), dim=1, largest=False,
                           sorted=True)
    if top_k > n:
        vals = torch.cat([vals, vals.new_full((B, top_k - n),
                                              float("inf"))], dim=1)
        idx = torch.cat([idx, idx.new_full((B, top_k - n), -1)], dim=1)
    return vals, idx
