"""The ADC scan kernel with a fused tile-local top-k, in PyTorch + CUDA.

Counterpart of ``deltapq_tpu/ops/adc_pallas.py`` (its name differs: the
kernel is CUDA C++, not Pallas).  Ported: ``adc_topk_pallas`` in its
``"f32"`` precision, the mode ``query_plain(engine="pallas")`` runs:

* ``adc_topk_pallas`` -> ``csrc/adc_topk.cu`` (replaces
  ``_adc_topk_kernel`` with ``_accumulate_onehot``): exact f32 ADC
  distances per tile, the tile's ``top_k`` smallest per query by
  mask-argmin, merged across tiles here in PyTorch (as the JAX package
  merges them in XLA).

The wrapper takes the plain version for tensors on the CPU and, for CUDA
tensors, launches the kernel or raises.  The ``"bf16"`` / ``"bf16x2"``
precisions and the other kernels of ``adc_pallas.py`` are not ported yet
(ROADMAP B6, B8-B10).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import build

#: shared memory the kernel's block may take (the card allows 227 KB);
#: the queries per block follow from it
SMEM_BUDGET = 160 * 1024
QC_MAX = 16
KERNEL_THREADS = 256
#: rows per tile of ``adc_topk_pallas`` (the tile ``query_plain`` uses)
TILE_N = 4096


def _queries_per_block(M: int, K: int, tile_n: int) -> int:
    qc = (SMEM_BUDGET - 4 * tile_n) // (4 * M * K)
    if qc < 1:
        raise NotImplementedError(
            f"adc_topk: a [{M}*{K}] f32 table and a {tile_n}-row tile do "
            f"not fit the kernel's shared memory")
    return min(qc, QC_MAX)


def adc_topk_tiles_ref(table: torch.Tensor, codes: torch.Tensor,
                       n_valid: int, top_k: int, tile_n: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: per tile, distances summed in
    ascending m from 0.0, rows >= n_valid at +inf, then ``top_k`` rounds
    of argmin (the first of equal minima) that set the winner to +inf.
    Returns (d [nT, top_k, B] f32, tile-local rows [nT, top_k, B] i32)."""
    B, M, K = table.shape
    n_pad = codes.shape[0]
    nt = n_pad // tile_n
    dev = table.device
    out_d = torch.empty((nt, top_k, B), dtype=torch.float32, device=dev)
    out_i = torch.empty((nt, top_k, B), dtype=torch.int32, device=dev)
    step = max(1, (1 << 18) // tile_n)          # tiles per chunk
    for t0 in range(0, nt, step):
        t1 = min(nt, t0 + step)
        c = codes[t0 * tile_n:t1 * tile_n].to(torch.int64)
        acc = torch.zeros((B, c.shape[0]), dtype=torch.float32, device=dev)
        for m in range(M):
            acc = acc + table[:, m, :].index_select(1, c[:, m])
        rows = t0 * tile_n + torch.arange(c.shape[0], device=dev)
        acc = torch.where((rows < n_valid)[None, :], acc,
                          torch.full_like(acc, float("inf")))
        acc = acc.reshape(B, t1 - t0, tile_n).transpose(0, 1).contiguous()
        for j in range(top_k):
            dmin, amin = torch.min(acc, dim=2)          # [T, B]
            out_d[t0:t1, j] = dmin
            out_i[t0:t1, j] = amin.to(torch.int32)
            acc.scatter_(2, amin[:, :, None], float("inf"))
    return out_d, out_i


def adc_topk_tiles(table: torch.Tensor, codes: torch.Tensor, n_valid: int,
                   top_k: int, tile_n: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile-local top-k of the exact f32 ADC distances: table [B, M, K]
    f32; codes [N_pad, M] u8 (int32 for K > 256), N_pad % tile_n == 0.
    Returns (d [nT, top_k, B] f32, rows [nT, top_k, B] i32 tile-local).
    On CUDA tensors this launches ``csrc/adc_topk.cu``; on CPU tensors it
    runs the plain version."""
    B, M, K = table.shape
    n_pad = codes.shape[0]
    if (table.dtype != torch.float32 or codes.dim() != 2
            or codes.shape[1] != M or n_pad % tile_n
            or codes.dtype not in (torch.uint8, torch.int32)):
        raise ValueError("adc_topk: table [B, M, K] f32 and codes "
                         "[N_pad, M] u8/i32 with N_pad % tile_n == 0")
    if table.device.type == "cpu":
        return adc_topk_tiles_ref(table, codes, n_valid, top_k, tile_n)
    if (codes.device != table.device or not table.is_contiguous()
            or not codes.is_contiguous() or tile_n % KERNEL_THREADS):
        raise ValueError("adc_topk: contiguous operands on one device and "
                         f"tile_n % {KERNEL_THREADS} == 0 required")
    qc = _queries_per_block(M, K, tile_n)
    nt = n_pad // tile_n
    out_d = torch.empty((nt, top_k, B), dtype=torch.float32,
                        device=table.device)
    out_i = torch.empty((nt, top_k, B), dtype=torch.int32,
                        device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = build.library().adc_topk_launch(
        table.data_ptr(), codes.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), B, M, K, n_pad, tile_n, int(n_valid), top_k, qc,
        codes.element_size(), stream)
    build.check(err, "adc_topk")
    build.count("adc_topk")
    return out_d, out_i


def adc_topk_pallas(table: torch.Tensor, codes: torch.Tensor, n_valid: int,
                    top_k: int, tile_n: int = TILE_N
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming ADC scan + top-k: per tile only ``top_k`` candidates
    per query leave the kernel; one merge picks the global ``top_k``.
    Returns (dists [B, top_k] ascending, ids [B, top_k] global rows;
    padding rows masked out).  This is the JAX function's
    ``precision="f32"`` (exact tables); its bf16 modes are not ported."""
    B = table.shape[0]
    d_tiles, i_tiles = adc_topk_tiles(table, codes, n_valid, top_k, tile_n)
    nt = d_tiles.shape[0]
    base = (torch.arange(nt, dtype=torch.int32, device=table.device)
            * tile_n)[:, None, None]
    gids = i_tiles + base                                  # [T, k, B]
    d = torch.where(gids < n_valid, d_tiles,
                    torch.full_like(d_tiles, float("inf")))
    cand_d = d.permute(2, 0, 1).reshape(B, nt * top_k)
    cand_i = gids.permute(2, 0, 1).reshape(B, nt * top_k)
    # a stable sort keeps the lower candidate among equals, as top_k does
    srt, pos = torch.sort(cand_d, dim=1, stable=True)
    return srt[:, :top_k], torch.gather(cand_i, 1, pos[:, :top_k])
