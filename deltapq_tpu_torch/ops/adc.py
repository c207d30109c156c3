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

from .. import resolve_device


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


def pad_codes(codes, tile_n: int):
    """Pad the database (a NumPy array or a tensor) to a multiple of
    tile_n (padding rows are code 0; they are masked by n_valid during
    scans)."""
    n = codes.shape[0]
    pad = (-n) % tile_n
    if not pad:
        return codes
    if isinstance(codes, torch.Tensor):
        return torch.cat([codes, codes.new_zeros((pad, codes.shape[1]))])
    return np.concatenate(
        [codes, np.zeros((pad, codes.shape[1]), codes.dtype)], axis=0)


def query_plain(codewords, queries: np.ndarray, codes, top_k: int = 10,
                tile_n: int = 16384, engine: str = "auto", device=None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """End-to-end plain ADC query (reference ``PQTree::QueryPlain``):
    build tables, scan, top-k, on ``device``.

    engine: "xla" (the gather scan ``adc_query_topk``, exact, runs
    everywhere; the name is the JAX package's), "pallas" (the ADC top-k
    kernel ``adc_kernels.adc_topk_pallas`` at f32: exact), or "auto"
    ("pallas" on a CUDA device, "xla" on the CPU).  ``codes`` is a NumPy
    array or a tensor (kept on the device by a caller that queries it
    often).  Returns NumPy (dists [B, top_k], ids [B, top_k])."""
    device = resolve_device(device)
    cw = codewords if isinstance(codewords, torch.Tensor) else \
        torch.from_numpy(np.asarray(codewords, np.float32))
    cw = cw.to(device=device, dtype=torch.float32)
    M, K, Ds = cw.shape
    D = M * Ds
    q = np.asarray(queries, np.float32)
    if q.shape[1] < D:
        q = np.pad(q, ((0, 0), (0, D - q.shape[1])))
    n_valid = codes.shape[0]
    if engine == "auto":
        engine = "pallas" if device.type == "cuda" else "xla"
    c = codes if isinstance(codes, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(codes))
    c = c.to(device)
    table = adc_table(cw, torch.from_numpy(q).to(device))
    if engine == "pallas":
        from .adc_kernels import TILE_N, adc_topk_pallas

        if c.dtype not in (torch.uint8, torch.int32):
            c = c.to(torch.int32)
        d, i = adc_topk_pallas(table, pad_codes(c, TILE_N).contiguous(),
                               n_valid, top_k, TILE_N, "f32")
    elif engine == "xla":
        tile_n = min(tile_n, max(256, 1 << (n_valid - 1).bit_length()))
        d, i = adc_query_topk(table, pad_codes(c, tile_n), n_valid, top_k,
                              tile_n)
    else:
        raise ValueError(f"unknown engine {engine!r}")
    return d.cpu().numpy(), i.cpu().numpy()
