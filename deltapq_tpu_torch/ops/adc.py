"""Asymmetric distance computation (ADC): table build + exact linear scan.

Counterpart of ``deltapq_tpu/ops/adc.py``.  These are plain PyTorch: the
JAX package computes them in XLA, outside any Pallas kernel.

``adc_query_topk`` is both the compressed engine's terminal exact scan
and the oracle the tests and ``chip_smoke.py`` hold the engine to: it
adds the M table values of a row in ascending m starting from 0.0, the
order the rerank kernel uses, so their distances are bit-equal.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Tuple

import numpy as np
import torch


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """Run f32 matmuls at full f32 precision (TF32 keeps ~3 decimal
    digits): ``torch.backends.cuda.matmul.allow_tf32`` is False inside
    and restored on exit, so the rest of the process keeps its own
    setting.  Every matmul of the port runs inside this."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def adc_table(codewords: torch.Tensor, queries: torch.Tensor
              ) -> torch.Tensor:
    """Squared-L2 table T[b, m, k] between query slices and codewords.

    codewords f32 [M, K, Ds]; queries f32 [B, D] (D = M*Ds).  The cross
    term is one [B, D] x [D, M*K] matmul against a block-diagonal
    codeword matrix, as in the JAX package, with TF32 off.
    """
    M, K, Ds = codewords.shape
    B = queries.shape[0]
    qs = queries.reshape(B, M, Ds)
    q2 = torch.sum(qs * qs, dim=2)                         # [B, M]
    c2 = torch.sum(codewords * codewords, dim=2)           # [M, K]
    eye = torch.eye(M, dtype=codewords.dtype, device=codewords.device)
    bd = (codewords.permute(0, 2, 1)[:, :, None, :]
          * eye[:, None, :, None]).reshape(M * Ds, M * K)
    with no_tf32():
        cross = torch.matmul(queries, bd).reshape(B, M, K)
    return q2[:, :, None] - 2.0 * cross + c2[None]


def adc_tile_dists(table: torch.Tensor, codes_tile: torch.Tensor
                   ) -> torch.Tensor:
    """Distances [B, tile] for one tile of codes [tile, M]:
    sum_m T[b, m, codes[n, m]] in ascending m from 0.0."""
    B, M, K = table.shape
    idx = codes_tile.to(torch.int64)
    acc = torch.zeros((B, codes_tile.shape[0]), dtype=torch.float32,
                      device=table.device)
    for m in range(M):
        acc = acc + table[:, m, :].index_select(1, idx[:, m])
    return acc


def adc_query_topk(table: torch.Tensor, codes: torch.Tensor, n_valid: int,
                   top_k: int, tile_n: int = 16384
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming ADC scan with running top-k.

    table f32 [B, M, K]; codes [N_pad, M] with N_pad % tile_n == 0;
    padding rows (>= n_valid) get +inf.  Returns (dists [B, top_k]
    ascending, ids [B, top_k] int64, -1 where fewer than top_k rows).
    """
    B = table.shape[0]
    n_pad = codes.shape[0]
    if n_pad % tile_n:
        raise ValueError("pad codes to a multiple of tile_n")
    dev = table.device
    best_d = torch.full((B, top_k), float("inf"), dtype=torch.float32,
                        device=dev)
    best_i = torch.full((B, top_k), -1, dtype=torch.int64, device=dev)
    for base in range(0, n_pad, tile_n):
        d = adc_tile_dists(table, codes[base:base + tile_n])
        ids = base + torch.arange(tile_n, device=dev)
        d = torch.where((ids < n_valid)[None, :], d,
                        torch.full_like(d, float("inf")))
        cat_d = torch.cat([best_d, d], dim=1)
        cat_i = torch.cat([best_i, ids[None, :].expand(B, tile_n)], dim=1)
        best_d, pos = torch.topk(cat_d, top_k, dim=1, largest=False,
                                 sorted=True)
        best_i = torch.gather(cat_i, 1, pos)
    order = torch.argsort(best_d, dim=1, stable=True)
    return (torch.gather(best_d, 1, order), torch.gather(best_i, 1, order))


def pad_codes(codes: np.ndarray, tile_n: int) -> np.ndarray:
    """Pad the database to a multiple of tile_n (padding rows are code 0;
    they are masked by n_valid during scans)."""
    n = codes.shape[0]
    pad = (-n) % tile_n
    if pad:
        codes = np.concatenate(
            [codes, np.zeros((pad, codes.shape[1]), codes.dtype)], axis=0)
    return codes
