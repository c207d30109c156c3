"""The ADC lookup kernels and the tile-dictionary engine, in PyTorch +
CUDA.

Counterpart of ``deltapq_tpu/ops/adc_pallas.py`` (its name differs: the
kernels are CUDA C++, not Pallas).  The TPU kernels select table values
with one-hot matmuls; on the card each is a lookup in shared memory
(``csrc/adc_lookup.cuh`` holds what they share):

* ``adc_dists_pallas``  -> ``csrc/adc_dists.cu`` (replaces
  ``_adc_dists_kernel``): the full f32 distance matrix [B, N].
* ``adc_topk_pallas``   -> ``csrc/adc_topk.cu`` (replaces
  ``_adc_topk_kernel``): distances per tile, the tile's ``top_k``
  smallest per query as mask-argmin selects them (a warp's sorted
  candidates in registers on the card), merged across tiles here.
* ``adc_topk_packed``   -> ``csrc/adc_topk.cu`` too (replaces
  ``_adc_topk_packed_kernel``): the same distances, selected on an int32
  key (order-preserving distance bits, the low 12 bits the tile-local
  row) as ``top_k`` threshold-min sweeps select it (on the card B6's
  warp selection, on the keys); exact f32 distances are recomputed for
  the winners.
* ``adc_topk_tiledict`` -> ``csrc/adc_topk.cu`` too (replaces
  ``_adc_topk_tiledict_kernel``): per tile the table is compacted through
  the tile's dictionary of distinct centroid ids and narrow per-row
  indexes are scanned, then the packed selection (on the card B9's warp
  kernel over the compact tables).  ``build_tile_dict`` builds the
  dictionaries on the host; ``TileDictEngine`` is the engine.

``precision`` of the top-k functions, as ``_accumulate_onehot`` adds the
values: ``"f32"`` (exact tables), ``"bf16"`` (the table rounded to bf16)
or ``"bf16x2"`` (bf16 hi and lo parts, hi then lo for each m; the JAX
default).  The sums are f32 in ascending m, and a one-hot product of a
bf16 value is exact, so kernel, plain version and the JAX kernel agree
bit for bit.  On this card the bf16 modes buy no speed; they select on
rounded tables, which is a different result.

Each wrapper takes the plain version for tensors on the CPU and, for
CUDA tensors, launches the kernel or raises.  What the JAX package
computes in XLA around the kernels stays plain PyTorch here: the bf16
split, the merge across tiles, ``_exact_dists_for_ids``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..kernels import build

#: the distance-matrix and packed kernels: one query's table must fit
#: this much shared memory (the card allows 227 KB a block)
SMEM_BUDGET = 160 * 1024
KERNEL_THREADS = 256
#: rows per tile of ``adc_topk_pallas`` (the tile ``query_plain`` uses)
TILE_N = 4096
#: ``adc_topk_tiles`` and ``adc_topk_tiledict_tiles`` on the card: the
#: 4*M*K (4*M*D) bytes of one warp's tables must fit beside a 32 KB code
#: chunk
TOPK_WARP_TABLES = 192 * 1024
_ROW_BITS = 12  # tile-local row id packed into the low mantissa bits
_KEY_BIG = 0x7FFFFFFF
PRECISIONS = ("f32", "bf16", "bf16x2")
_ENTRY_BYTES = {"f32": 4, "bf16": 2, "bf16x2": 4}


def _check_precision(precision: str) -> int:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return PRECISIONS.index(precision)


def _mode_name(kernel: str, precision: str) -> str:
    """Launch-counter key: the f32 mode carries the kernel's bare name."""
    return kernel if precision == "f32" else f"{kernel}_{precision}"


def _check_tables_fit(what: str, n_bytes: int, limit: int) -> None:
    """The shapes a lookup kernel takes on the card: the tables it keeps
    in shared memory (one query's, or one warp's), ``n_bytes``, must fit
    ``limit`` bytes; else NotImplementedError."""
    if n_bytes > limit:
        raise NotImplementedError(
            f"{what}: the tables kept in shared memory ({n_bytes} bytes) "
            f"must fit {limit} bytes")


def split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split f32 -> (bf16 hi, bf16 lo) with hi + lo ~= x to ~2^-18 rel."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def _tables_f32(table: torch.Tensor, precision: str) -> List[torch.Tensor]:
    """The values a precision adds for each m, in order, as f32 tables
    [B, M, K] (what the plain versions look up)."""
    _check_precision(precision)
    if precision == "f32":
        return [table]
    if precision == "bf16":
        return [table.to(torch.bfloat16).to(torch.float32)]
    return [t.to(torch.float32) for t in split_bf16(table)]


def _kernel_table(table: torch.Tensor, precision: str) -> torch.Tensor:
    """The table in the kernels' layout: f32 [B, M*K], bf16 [B, M*K] or
    bf16 [B, M*K, 2] (hi, lo)."""
    B = table.shape[0]
    flat = table.reshape(B, -1)
    if precision == "f32":
        return flat.contiguous()
    if precision == "bf16":
        return flat.to(torch.bfloat16).contiguous()
    return torch.stack(split_bf16(flat), dim=-1).contiguous()


def _lookup_sums(tables: List[torch.Tensor], c64: torch.Tensor
                 ) -> torch.Tensor:
    """[B, n] sums over ascending m of the tables' values at rows' codes
    ``c64`` [n, M] int64, from 0.0 (for each m every table in turn)."""
    B, M, _ = tables[0].shape
    acc = torch.zeros((B, c64.shape[0]), dtype=torch.float32,
                      device=tables[0].device)
    for m in range(M):
        for t in tables:
            acc = acc + t[:, m, :].index_select(1, c64[:, m])
    return acc


def _check_scan_operands(what: str, table: torch.Tensor, codes: torch.Tensor,
                         tile_n: int, max_tile: Optional[int] = None) -> None:
    B, M, K = table.shape
    if (table.dtype != torch.float32 or codes.dim() != 2
            or codes.shape[1] != M or codes.shape[0] % tile_n
            or codes.dtype not in (torch.uint8, torch.int32)
            or (K > 256 and codes.dtype != torch.int32)):
        raise ValueError(f"{what}: table [B, M, K] f32 and codes [N_pad, M] "
                         f"u8 (int32 for K > 256) with N_pad % tile_n == 0")
    if max_tile is not None and tile_n > max_tile:
        raise ValueError(f"{what}: tile_n <= {max_tile} (the tile-local row "
                         f"takes {_ROW_BITS} bits of the key)")


def _check_cuda_operands(what: str, table: torch.Tensor, *others) -> None:
    if any(o.device != table.device or not o.is_contiguous()
           for o in others):
        raise ValueError(f"{what}: contiguous operands on one device "
                         f"required")


def _tile_chunks(nt: int, tile_n: int):
    """Ranges of tiles of about 2^18 rows for the plain versions."""
    step = max(1, (1 << 18) // tile_n)
    for t0 in range(0, nt, step):
        yield t0, min(nt, t0 + step)


# ---------------------------------------------------------------- B8 ----

def adc_dists_ref(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Plain version of the distance-matrix kernel: [B, N] f32 sums over
    ascending m from 0.0 (``ops.adc.adc_tile_dists`` in row chunks)."""
    B = table.shape[0]
    n = codes.shape[0]
    out = torch.empty((B, n), dtype=torch.float32, device=table.device)
    for r0 in range(0, n, 1 << 18):
        c = codes[r0:r0 + (1 << 18)].to(torch.int64)
        out[:, r0:r0 + c.shape[0]] = _lookup_sums([table], c)
    return out


def adc_dists_pallas(table: torch.Tensor, codes: torch.Tensor,
                     tile_n: int = 512) -> torch.Tensor:
    """Full distance matrix [B, N] f32: table [B, M, K] f32; codes [N, M]
    u8 (int32 for K > 256), N % tile_n == 0 as the JAX function asks.
    No n_valid mask.  On CUDA tensors this launches
    ``csrc/adc_dists.cu``; on CPU tensors it runs the plain version."""
    _check_scan_operands("adc_dists", table, codes, tile_n)
    if table.device.type == "cpu":
        return adc_dists_ref(table, codes)
    B, M, K = table.shape
    _check_tables_fit("adc_dists", 4 * M * K, SMEM_BUDGET)
    tab = table.reshape(B, M * K)
    _check_cuda_operands("adc_dists", table, tab, codes)
    n = codes.shape[0]
    out = torch.empty((B, n), dtype=torch.float32, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = build.library().adc_dists_launch(
        tab.data_ptr(), codes.data_ptr(), out.data_ptr(), B, M, K, n,
        codes.element_size(), stream)
    build.check(err, "adc_dists")
    build.count("adc_dists")
    return out


# ---------------------------------------------------------------- B6 ----

def adc_topk_tiles_ref(table: torch.Tensor, codes: torch.Tensor,
                       n_valid: int, top_k: int, tile_n: int,
                       precision: str = "f32"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: per tile, distances summed in
    ascending m from 0.0, rows >= n_valid at +inf, then ``top_k`` rounds
    of argmin (the first of equal minima) that set the winner to +inf.
    Returns (d [nT, top_k, B] f32, tile-local rows [nT, top_k, B] i32)."""
    B, M, K = table.shape
    n_pad = codes.shape[0]
    nt = n_pad // tile_n
    dev = table.device
    tables = _tables_f32(table, precision)
    out_d = torch.empty((nt, top_k, B), dtype=torch.float32, device=dev)
    out_i = torch.empty((nt, top_k, B), dtype=torch.int32, device=dev)
    for t0, t1 in _tile_chunks(nt, tile_n):
        c = codes[t0 * tile_n:t1 * tile_n].to(torch.int64)
        acc = _lookup_sums(tables, c)
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
                   top_k: int, tile_n: int, precision: str = "f32"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile-local top-k of the ADC distances at ``precision``: table
    [B, M, K] f32; codes [N_pad, M] u8 (int32 for K > 256), N_pad %
    tile_n == 0.  Returns (d [nT, top_k, B] f32, rows [nT, top_k, B] i32
    tile-local).  On CUDA tensors this launches ``csrc/adc_topk.cu``; on
    CPU tensors it runs the plain version."""
    prec = _check_precision(precision)
    _check_scan_operands("adc_topk", table, codes, tile_n)
    if table.device.type == "cpu":
        return adc_topk_tiles_ref(table, codes, n_valid, top_k, tile_n,
                                  precision)
    B, M, K = table.shape
    if tile_n % KERNEL_THREADS:
        raise ValueError(f"adc_topk: tile_n % {KERNEL_THREADS} == 0 "
                         f"required")
    _check_tables_fit("adc_topk", 4 * M * K, TOPK_WARP_TABLES)
    tab = _kernel_table(table, precision)
    _check_cuda_operands("adc_topk", table, tab, codes)
    nt = codes.shape[0] // tile_n
    out_d = torch.empty((nt, top_k, B), dtype=torch.float32,
                        device=table.device)
    out_i = torch.empty((nt, top_k, B), dtype=torch.int32,
                        device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = build.library().adc_topk_launch(
        tab.data_ptr(), codes.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), B, M, K, codes.shape[0], tile_n, int(n_valid),
        top_k, codes.element_size(), prec, stream)
    name = _mode_name("adc_topk", precision)
    build.check(err, name)
    build.count(name)
    return out_d, out_i


def adc_topk_pallas(table: torch.Tensor, codes: torch.Tensor, n_valid: int,
                    top_k: int, tile_n: int = TILE_N,
                    precision: str = "bf16x2"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming ADC scan + top-k: per tile only ``top_k`` candidates
    per query leave the kernel; one merge picks the global ``top_k``.
    Returns (dists [B, top_k] ascending, ids [B, top_k] global rows;
    padding rows masked out).  The distances are the kernel's own: exact
    at ``"f32"``, sums of the rounded table's values otherwise."""
    B = table.shape[0]
    d_tiles, i_tiles = adc_topk_tiles(table, codes, n_valid, top_k, tile_n,
                                      precision)
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


# ------------------------------------------------------------ B9, B10 ----

def _exact_dists_for_ids(table: torch.Tensor, codes: torch.Tensor,
                         ids: torch.Tensor) -> torch.Tensor:
    """Recompute exact f32 distances for the final [B, k] winner ids, in
    ascending m from 0.0 (ids are clipped so sentinel entries read a
    valid row harmlessly)."""
    B, M, K = table.shape
    safe = ids.to(torch.int64).clamp(0, codes.shape[0] - 1)
    cw = codes[safe].to(torch.int64)                        # [B, k, M]
    tf = table.reshape(B, M * K)
    out = torch.zeros(ids.shape, dtype=torch.float32, device=table.device)
    for m in range(M):
        out = out + torch.gather(tf, 1, m * K + cw[:, :, m])
    return out


def packed_keys(dists: torch.Tensor, rows: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """The int32 selection key of f32 ``dists``: its bits made to order
    as the floats do (the low 31 bits of a negative value flipped), the
    low 12 bits replaced by the tile-local ``rows``; 0x7FFFFFFF where not
    ``valid``."""
    bits = dists.contiguous().view(torch.int32)
    bits = bits ^ ((bits >> 31) & _KEY_BIG)       # >> on int32: arithmetic
    packed = (bits & ~((1 << _ROW_BITS) - 1)) | rows.to(torch.int32)
    return torch.where(valid, packed, torch.full_like(packed, _KEY_BIG))


def _packed_sweeps(packed: torch.Tensor, top_k: int) -> torch.Tensor:
    """``top_k`` sweeps last = min(key where key > last) from INT_MIN
    over the last axis of ``packed`` [T, B, tile_n] -> [T, top_k, B]."""
    T, B, _ = packed.shape
    big = torch.full_like(packed, _KEY_BIG)
    last = torch.full((T, B), -0x80000000, dtype=torch.int32,
                      device=packed.device)
    out = torch.empty((T, top_k, B), dtype=torch.int32,
                      device=packed.device)
    for j in range(top_k):
        last = torch.where(packed > last[:, :, None], packed,
                           big).amin(dim=2)
        out[:, j] = last
    return out


def _packed_from_dists(acc: torch.Tensor, t0: int, t1: int, tile_n: int,
                       n_valid: int, top_k: int) -> torch.Tensor:
    """Keys and sweeps for the tiles [t0, t1) whose distances are ``acc``
    [B, (t1 - t0) * tile_n]."""
    B = acc.shape[0]
    dev = acc.device
    local = torch.arange(tile_n, dtype=torch.int32, device=dev)
    grow = (torch.arange(t0, t1, device=dev)[:, None] * tile_n
            + local[None, :])                               # [T, tile_n]
    acc = acc.reshape(B, t1 - t0, tile_n).transpose(0, 1)   # [T, B, tile_n]
    packed = packed_keys(acc, local[None, None, :],
                         (grow < n_valid)[:, None, :])
    return _packed_sweeps(packed, top_k)


def adc_topk_packed_tiles_ref(table: torch.Tensor, codes: torch.Tensor,
                              n_valid: int, top_k: int, tile_n: int,
                              precision: str = "bf16x2") -> torch.Tensor:
    """Plain version of the packed kernel: per tile the distances at
    ``precision``, their packed keys, then the ``top_k`` sweeps.  Returns
    the keys [nT, top_k, B] i32."""
    B = table.shape[0]
    nt = codes.shape[0] // tile_n
    tables = _tables_f32(table, precision)
    out = torch.empty((nt, top_k, B), dtype=torch.int32,
                      device=table.device)
    for t0, t1 in _tile_chunks(nt, tile_n):
        c = codes[t0 * tile_n:t1 * tile_n].to(torch.int64)
        out[t0:t1] = _packed_from_dists(_lookup_sums(tables, c), t0, t1,
                                        tile_n, n_valid, top_k)
    return out


def adc_topk_packed_tiles(table: torch.Tensor, codes: torch.Tensor,
                          n_valid: int, top_k: int, tile_n: int,
                          precision: str = "bf16x2") -> torch.Tensor:
    """Tile-local packed top-k keys [nT, top_k, B] i32: operands as
    ``adc_topk_tiles``, tile_n <= 4096, one query's table of at most
    ``SMEM_BUDGET`` bytes at ``precision``.  On CUDA tensors this launches
    ``csrc/adc_topk.cu`` (``adc_topk_packed_launch``); on CPU tensors it
    runs the plain version."""
    prec = _check_precision(precision)
    _check_scan_operands("adc_topk_packed", table, codes, tile_n,
                         1 << _ROW_BITS)
    if table.device.type == "cpu":
        return adc_topk_packed_tiles_ref(table, codes, n_valid, top_k,
                                         tile_n, precision)
    B, M, K = table.shape
    _check_tables_fit("adc_topk_packed", _ENTRY_BYTES[precision] * M * K,
                     SMEM_BUDGET)
    tab = _kernel_table(table, precision)
    _check_cuda_operands("adc_topk_packed", table, tab, codes)
    out = torch.empty((codes.shape[0] // tile_n, top_k, B),
                      dtype=torch.int32, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = build.library().adc_topk_packed_launch(
        tab.data_ptr(), codes.data_ptr(), out.data_ptr(), B, M, K,
        codes.shape[0], tile_n, int(n_valid), top_k,
        codes.element_size(), prec, stream)
    name = _mode_name("adc_topk_packed", precision)
    build.check(err, name)
    build.count(name)
    return out


def _merge_packed(packed: torch.Tensor, table: torch.Tensor,
                  codes: torch.Tensor, n_valid: int, top_k: int,
                  tile_n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge the tiles' packed keys [nT, top_k, B]: global rows from the
    keys' low bits, keys of rows >= n_valid (a tile's exhausted sweeps
    read as row 4095) back at 0x7FFFFFFF, the ``top_k`` smallest keys
    (the lower candidate among equals), exact distances for their rows."""
    nt, _, B = packed.shape
    rows = packed & ((1 << _ROW_BITS) - 1)
    base = (torch.arange(nt, dtype=torch.int32, device=packed.device)
            * tile_n)[:, None, None]
    gids = rows + base
    key = torch.where(gids < n_valid, packed,
                      torch.full_like(packed, _KEY_BIG))
    cand_key = key.permute(2, 0, 1).reshape(B, nt * top_k)
    cand_i = gids.permute(2, 0, 1).reshape(B, nt * top_k)
    _, pos = torch.sort(cand_key, dim=1, stable=True)
    ids = torch.gather(cand_i, 1, pos[:, :top_k])
    return _exact_dists_for_ids(table, codes, ids), ids


def adc_topk_packed(table: torch.Tensor, codes: torch.Tensor, n_valid: int,
                    top_k: int, tile_n: int = 4096,
                    precision: str = "bf16x2"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ADC scan + top-k via packed int32 selection.

    Selection key is (distance truncated to ~2^-12 relative, row id);
    reported distances are exact f32 recomputed for the winners.
    Returns (dists [B, top_k] in the order of the packed key, ids i32)."""
    packed = adc_topk_packed_tiles(table, codes, n_valid, top_k, tile_n,
                                   precision)
    return _merge_packed(packed, table, codes, n_valid, top_k, tile_n)


def build_tile_dict(codes: np.ndarray, tile_n: int = 2048,
                    max_dict: int = 64):
    """Host-side build (a copy of the JAX package's).  Returns (dict_vals
    i32 [T, M, D], idx u8 [N, M], dict_width) or None if some tile
    exceeds ``max_dict`` distinct values in a subspace."""
    codes = np.asarray(codes)
    n, M = codes.shape
    assert n % tile_n == 0
    n_tiles = n // tile_n
    widths = 1
    dicts = np.zeros((n_tiles, M, max_dict), np.int32)
    idx = np.zeros((n, M), np.uint8)
    for t in range(n_tiles):
        rows = codes[t * tile_n:(t + 1) * tile_n]
        for m in range(M):
            u, inv = np.unique(rows[:, m], return_inverse=True)
            if len(u) > max_dict:
                return None
            widths = max(widths, len(u))
            dicts[t, m, :len(u)] = u
            dicts[t, m, len(u):] = u[0]
            idx[t * tile_n:(t + 1) * tile_n, m] = inv
    # round dict width up to a power of two >= 8 for clean tiling
    d = 8
    while d < widths:
        d *= 2
    return dicts[:, :, :d].copy(), idx, d


def adc_topk_tiledict_tiles_ref(table: torch.Tensor, idx: torch.Tensor,
                                dict_vals: torch.Tensor, n_valid: int,
                                top_k: int, tile_n: int) -> torch.Tensor:
    """Plain version of the tile-dictionary kernel: per tile the table
    compacted through the dictionary (stage A), the rows' sums over
    ascending m of the compact table at their indexes (stage B), the
    packed keys and the sweeps.  Returns the keys [nT, top_k, B] i32."""
    B, M, _ = table.shape
    nt = idx.shape[0] // tile_n
    dev = table.device
    out = torch.empty((nt, top_k, B), dtype=torch.int32, device=dev)
    ar_m = torch.arange(M, device=dev)[None, :, None]
    for t0, t1 in _tile_chunks(nt, tile_n):
        T = t1 - t0
        compact = table[:, ar_m, dict_vals[t0:t1].to(torch.int64)]
        ix = idx[t0 * tile_n:t1 * tile_n].to(torch.int64).reshape(
            T, tile_n, M)                                   # [T, tile_n, M]
        acc = torch.zeros((B, T, tile_n), dtype=torch.float32, device=dev)
        for m in range(M):
            acc = acc + torch.gather(
                compact[:, :, m, :], 2,
                ix[None, :, :, m].expand(B, T, tile_n))
        out[t0:t1] = _packed_from_dists(acc.reshape(B, T * tile_n), t0, t1,
                                        tile_n, n_valid, top_k)
    return out


def adc_topk_tiledict_tiles(table: torch.Tensor, idx: torch.Tensor,
                            dict_vals: torch.Tensor, n_valid: int,
                            top_k: int, tile_n: int) -> torch.Tensor:
    """Tile-local packed top-k keys [nT, top_k, B] i32 of the
    tile-dictionary scan: table [B, M, K] f32; idx u8 [N_pad, M]
    positions in the tile's dictionary; dict_vals i32 [nT, M, D], D <=
    256; tile_n <= 4096.  On CUDA tensors this launches
    ``csrc/adc_topk.cu`` (``adc_topk_tiledict_launch``: B9's warp kernel
    over the compact tables, 4*M*D bytes a warp); on CPU tensors it runs
    the plain version."""
    B, M, K = table.shape
    n_pad = idx.shape[0]
    if (table.dtype != torch.float32 or idx.dim() != 2 or idx.shape[1] != M
            or idx.dtype != torch.uint8 or n_pad % tile_n
            or dict_vals.dtype != torch.int32 or dict_vals.dim() != 3
            or dict_vals.shape[:2] != (n_pad // tile_n, M)):
        raise ValueError("adc_topk_tiledict: table [B, M, K] f32, idx "
                         "[N_pad, M] u8 with N_pad % tile_n == 0 and "
                         "dict_vals [N_pad / tile_n, M, D] i32")
    D = dict_vals.shape[2]
    if tile_n > (1 << _ROW_BITS) or D > 256:
        raise ValueError(f"adc_topk_tiledict: tile_n <= {1 << _ROW_BITS} "
                         f"and a dictionary of at most 256 values (u8 "
                         f"indexes), got tile_n {tile_n}, width {D}")
    if table.device.type == "cpu":
        return adc_topk_tiledict_tiles_ref(table, idx, dict_vals, n_valid,
                                           top_k, tile_n)
    _check_tables_fit("adc_topk_tiledict", 4 * M * D, TOPK_WARP_TABLES)
    tab = table.reshape(B, M * K)
    _check_cuda_operands("adc_topk_tiledict", table, tab, idx, dict_vals)
    out = torch.empty((n_pad // tile_n, top_k, B), dtype=torch.int32,
                      device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = build.library().adc_topk_tiledict_launch(
        tab.data_ptr(), idx.data_ptr(), dict_vals.data_ptr(),
        out.data_ptr(), B, M, K, D, n_pad, tile_n, int(n_valid), top_k,
        stream)
    build.check(err, "adc_topk_tiledict")
    build.count("adc_topk_tiledict")
    return out


def adc_topk_tiledict(table: torch.Tensor, idx: torch.Tensor,
                      dict_vals: torch.Tensor, codes: torch.Tensor,
                      n_valid: int, top_k: int, tile_n: int = 2048
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """TileDict scan + top-k.  idx [N, M] u8 dict positions; dict_vals
    [T, M, D] int32; codes [N, M] (for exact distance readout).  Returns
    (dists [B, top_k] exact f32, global ids i32)."""
    packed = adc_topk_tiledict_tiles(table, idx, dict_vals, n_valid, top_k,
                                     tile_n)
    return _merge_packed(packed, table, codes, n_valid, top_k, tile_n)


class TileDictEngine:
    """Compressed-scan engine: rows ordered by DeltaTree DFS (clustered
    codes land in the same tiles), per-tile dictionaries, f32-exact
    kernel.  ``ok`` is False when some tile has more than ``max_dict``
    distinct values in a subspace; such an engine holds no state and its
    ``query`` raises: choosing another engine is the caller's decision."""

    def __init__(self, codewords, codes, order=None, tile_n: int = 2048,
                 max_dict: int = 64, device=None):
        from .adc import pad_codes

        self.device = resolve_device(device)
        codes = np.asarray(codes)
        self.n_valid = len(codes)
        if order is None:
            order = np.arange(len(codes))
        self.order = np.asarray(order, np.int64)
        reordered = pad_codes(codes[self.order], tile_n)
        built = build_tile_dict(reordered, tile_n=tile_n, max_dict=max_dict)
        self.ok = built is not None
        if not self.ok:
            return
        dicts, idx, D = built
        # padded rows map to order[0]; they're masked via n_valid anyway
        row_to_db = np.concatenate(
            [self.order, np.zeros(len(reordered) - len(self.order),
                                  np.int64)]).astype(np.int32)
        self._set_state(codewords, dicts, idx, reordered, row_to_db, tile_n)

    def _set_state(self, codewords, dicts, idx, codes_reordered, row_to_db,
                   tile_n):
        dev = self.device
        codewords = np.asarray(codewords, np.float32)
        M, K, Ds = codewords.shape
        self.tile_n = tile_n
        self.dict_width = dicts.shape[2]
        self.D_vec = M * Ds
        self.codewords = torch.from_numpy(codewords).to(dev)
        # np.array copies: the arrays may be read-only views
        self.dicts = torch.from_numpy(np.array(dicts, np.int32)).to(dev)
        self.idx = torch.from_numpy(np.array(idx, np.uint8)).to(dev)
        self.codes_reordered = torch.from_numpy(
            np.array(codes_reordered)).to(dev)
        self.row_to_db = torch.from_numpy(
            np.array(row_to_db, np.int32)).to(dev)

    def query(self, queries, top_k: int = 10
              ) -> Tuple[np.ndarray, np.ndarray]:
        from .adc import adc_table

        if not self.ok:
            raise RuntimeError("TileDictEngine: a tile's dictionary does "
                               "not fit max_dict; the engine holds no "
                               "state (check .ok and choose another)")
        q = np.asarray(queries, np.float32)
        if q.shape[1] < self.D_vec:
            q = np.pad(q, ((0, 0), (0, self.D_vec - q.shape[1])))
        table = adc_table(self.codewords, torch.from_numpy(q).to(self.device))
        d, rows = adc_topk_tiledict(table, self.idx, self.dicts,
                                    self.codes_reordered, self.n_valid,
                                    top_k, self.tile_n)
        # a sentinel key's row lies past the padded rows: clip, as take does
        ids = self.row_to_db[rows.to(torch.int64).clamp(
            max=self.row_to_db.shape[0] - 1)]
        return d.cpu().numpy(), ids.cpu().numpy()
