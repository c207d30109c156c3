"""Sharded query execution and data-parallel codebook training, over the
port's mesh.

Counterpart of ``deltapq_tpu/parallel/sharded.py``, which is XLA (no
Pallas kernel), so this is plain PyTorch.  No reference counterpart: the
reference is single-process OpenMP.

- the [N, M] code array is split along N over the mesh's shards;
- a query batch's ADC tables are built once and copied to each shard's
  device (B*M*K*4 bytes, small);
- every shard scans its rows and keeps a local top-k;
- the local top-k candidates are merged by ``mesh.gather_topk`` (k*S
  candidates a query), so every process holds the final result;
- k-means runs data-parallel: each shard's one-hot matmul partial sums
  are summed over the shards (``mesh.psum``).

A mesh that repeats one device runs its shards on that device one after
the other.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..ops.adc import adc_query_topk, adc_table, no_tf32
from ..ops.adc_kernels import _exact_dists_for_ids
from ..ops.decoded import _cross_f32, build_decoded_cache
from ..ops.fused import _np_f32
from ..ops.topk import smallest_k
from .mesh import Mesh, gather_topk, make_mesh, psum, shard_rows


def _on_devices(x: torch.Tensor, mesh: Mesh) -> dict:
    """``x`` on each distinct device of the mesh, by device."""
    return {d: x.to(d) for d in dict.fromkeys(mesh.devices)}


def _local_valid(n_valid: int, base: int, rows: int) -> int:
    return min(max(n_valid - base, 0), rows)


def _stable_smallest(x: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest along the last axis, ascending, the lower index
    first among equals (``lax.top_k`` of the negation)."""
    srt, pos = torch.sort(x, dim=-1, stable=True)
    return srt[..., :k], pos[..., :k]


# --------------------------------------------------------------------------
# Sharded ADC query
# --------------------------------------------------------------------------

def _local_scan_topk(table: torch.Tensor, codes_local: torch.Tensor,
                     n_valid: int, base: int, top_k: int, tile_n: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over this shard's rows (``ops.adc.adc_query_topk``, in one
    tile where ``tile_n`` does not divide them) with the global id offset
    ``base``: rows >= ``n_valid`` (local) are +inf.  Returns (dists
    [B, top_k] f32, global ids [B, top_k] int64, -1 where fewer rows)."""
    rows = codes_local.shape[0]
    d, i = adc_query_topk(table, codes_local, n_valid, top_k,
                          tile_n if rows % tile_n == 0 else rows)
    return d, torch.where(torch.isfinite(d), i + base, torch.full_like(i, -1))


def make_sharded_query_fn(mesh: Mesh, top_k: int, tile_n: int = 8192
                          ) -> Callable:
    """Returns ``fn(table [B, M, K], codes_shards, n_valid) -> (dists
    [B, top_k], ids [B, top_k])`` on ``mesh.devices[0]``: codes_shards
    are this process's row shards (``shard_rows`` of [N_pad, M]), equal
    in rows; the merged result is the same on every process."""

    def run(table, codes_shards, n_valid):
        tables = _on_devices(table, mesh)
        ds, ids = [], []
        for g, c in zip(mesh.shard_ids(), codes_shards):
            rows = c.shape[0]
            base = g * rows
            d, i = _local_scan_topk(tables[c.device], c,
                                    _local_valid(int(n_valid), base, rows),
                                    base, top_k, min(tile_n, rows))
            ds.append(d)
            ids.append(i)
        return gather_topk(mesh, ds, ids, top_k)

    return run


def _pad_codes_for_mesh(codes: np.ndarray, mesh: Mesh,
                        tile_n: int = 8192) -> Tuple[np.ndarray, int]:
    """Pad rows so each shard gets the same count (a multiple of the
    scan tile).  Returns (codes_padded, n_valid)."""
    n_shards = mesh.size
    n_valid = codes.shape[0]
    per = max(256, -(-n_valid // n_shards))
    per = -(-per // tile_n) * tile_n if per > tile_n else per
    total = n_shards * per
    if codes.shape[0] < total:
        codes = np.concatenate(
            [codes, np.zeros((total - codes.shape[0], codes.shape[1]),
                             codes.dtype)])
    return codes, n_valid


def _padded_queries(queries: np.ndarray, D: int) -> torch.Tensor:
    q = np.asarray(queries, np.float32)
    if q.shape[1] < D:
        q = np.pad(q, ((0, 0), (0, D - q.shape[1])))
    return torch.from_numpy(np.ascontiguousarray(q))


def _codewords_on(codewords, device) -> torch.Tensor:
    cw = codewords if isinstance(codewords, torch.Tensor) else \
        torch.from_numpy(np.asarray(codewords, np.float32))
    return cw.to(device=device, dtype=torch.float32)


def sharded_query_plain(codewords, queries: np.ndarray, codes: np.ndarray,
                        top_k: int = 10, mesh: Optional[Mesh] = None,
                        tile_n: int = 8192, device=None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """End-to-end sharded plain-ADC query (``mesh`` None: every local
    device of ``device``, None being the cards).  Returns NumPy (dists
    [B, top_k], ids [B, top_k])."""
    if mesh is None:
        mesh = make_mesh(device=device)
    tile_n = min(tile_n, 8192)
    codes_p, n_valid = _pad_codes_for_mesh(np.asarray(codes), mesh, tile_n)
    per = codes_p.shape[0] // mesh.size
    cw = _codewords_on(codewords, mesh.devices[0])
    M, K, Ds = cw.shape
    table = adc_table(cw, _padded_queries(queries, M * Ds).to(cw.device))
    fn = make_sharded_query_fn(mesh, top_k, tile_n=min(tile_n, per))
    d, i = fn(table, shard_rows(mesh, codes_p), n_valid)
    return d.cpu().numpy(), i.cpu().numpy()


# --------------------------------------------------------------------------
# Data-parallel k-means (the framework's "training step")
# --------------------------------------------------------------------------

def make_dp_lloyd_step(mesh: Mesh) -> Callable:
    """One data-parallel Lloyd iteration over a sharded learn set.

    Returns ``step(x_shards, centers) -> (new_centers [M, K, Ds],
    distortion)`` on ``mesh.devices[0]``: x_shards are this process's
    shards of the subspace-sliced training data [M, n, Ds] split along n
    (``shard_rows(mesh, x, dim=1)``); centers [M, K, Ds] replicated.
    Each shard's one-hot matmuls give partial centroid sums and counts,
    summed over every shard; an empty cluster keeps its old centre."""

    def step(x_shards, centers):
        cs = _on_devices(torch.as_tensor(centers, dtype=torch.float32),
                         mesh)
        K = cs[mesh.devices[0]].shape[1]
        sums, counts, dist = [], [], []
        for x in x_shards:
            c = cs[x.device]
            x2 = torch.sum(x * x, dim=2, keepdim=True)        # [M, n, 1]
            c2 = torch.sum(c * c, dim=2)                       # [M, K]
            with no_tf32():
                cross = torch.bmm(x, c.transpose(1, 2))        # [M, n, K]
            d2 = x2 - 2.0 * cross + c2[:, None, :]
            labels = torch.argmin(d2, dim=2)                   # first min
            onehot = torch.nn.functional.one_hot(labels, K).to(
                torch.float32)                                 # [M, n, K]
            with no_tf32():
                sums.append(torch.bmm(onehot.transpose(1, 2), x))
            counts.append(onehot.sum(dim=1))                   # [M, K]
            dist.append(torch.sum(torch.amin(d2, dim=2)))
        total, cnt = psum(mesh, sums), psum(mesh, counts)
        old = cs[mesh.devices[0]]
        new = total / torch.clamp_min(cnt, 1.0)[..., None]
        new = torch.where((cnt == 0)[..., None], old, new)
        return new, psum(mesh, dist)

    return step


# --------------------------------------------------------------------------
# Sharded decoded-cache engine
# --------------------------------------------------------------------------

def make_sharded_decoded_query_fn(mesh: Mesh, top_k: int,
                                  precision: str = "bf16x2") -> Callable:
    """Sharded decoded-cache query: returns ``fn(table [B, M, K],
    queries [B, D] f32, hi_shards, lo_shards, pre_shards, codes_shards)
    -> (dists [B, top_k], ids [B, top_k])``, the shards being this
    process's rows of xhat_hi / xhat_lo bf16 [N_pad, D], precomp f32
    [N_pad] (+inf on padding rows) and codes [N_pad, M].  Per shard: the
    bf16 (or three-product bf16x2) cross term summed in f32, an exact
    shortlist of min(max(16 top_k, 64), 1024, rows) rows, their exact f32
    table sums, the local top-k; then the merge."""
    if precision not in ("bf16", "bf16x2"):
        raise ValueError(f"unknown precision {precision!r}")

    def run(table, queries, hi_shards, lo_shards, pre_shards, codes_shards):
        tables, qs = _on_devices(table, mesh), _on_devices(queries, mesh)
        B = queries.shape[0]
        ds, ids = [], []
        for g, hi, lo, pre, c in zip(mesh.shard_ids(), hi_shards, lo_shards,
                                     pre_shards, codes_shards):
            q = qs[hi.device]
            rows = hi.shape[0]
            q_hi = q.to(torch.bfloat16)
            q_lo = (q - q_hi.to(torch.float32)).to(torch.bfloat16)
            q2 = torch.sum(q * q, dim=1)
            cross = _cross_f32(q_hi, hi)                       # [B, rows]
            if precision == "bf16x2":
                cross = cross + _cross_f32(q_lo, hi) + _cross_f32(q_hi, lo)
            d = pre[None, :] - 2.0 * cross + q2[:, None]
            shortlist = min(max(16 * top_k, 64), 1024, rows)
            cd, ci = smallest_k(d, shortlist, "exact")
            exact = _exact_dists_for_ids(tables[hi.device], c, ci)
            exact = torch.where(torch.isfinite(cd), exact,
                                torch.full_like(exact, float("inf")))
            k_local = min(top_k, shortlist)
            dloc, pos = _stable_smallest(exact, k_local)
            li = torch.gather(ci, 1, pos)
            if k_local < top_k:
                pad = top_k - k_local
                dloc = torch.cat([dloc, dloc.new_full((B, pad),
                                                      float("inf"))], 1)
                li = torch.cat([li, li.new_zeros((B, pad))], 1)
            ds.append(dloc)
            ids.append(li + g * rows)
        return gather_topk(mesh, ds, ids, top_k)

    return run


def sharded_query_decoded(codewords, queries: np.ndarray, codes: np.ndarray,
                          top_k: int = 10, mesh: Optional[Mesh] = None,
                          precision: str = "bf16x2", device=None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """End-to-end sharded decoded-cache query (``mesh`` None: every local
    device of ``device``).  Each process decodes only its own shards'
    rows.  Returns NumPy (dists [B, top_k], ids [B, top_k])."""
    if mesh is None:
        mesh = make_mesh(device=device)
    S = mesh.size
    codes = np.asarray(codes)
    n_valid = codes.shape[0]
    per = max(8, -(-n_valid // S))
    codes_p = np.asarray(codes)
    if len(codes_p) < S * per:
        codes_p = np.concatenate(
            [codes_p, np.zeros((S * per - len(codes_p), codes.shape[1]),
                               codes.dtype)])
    cwn = _np_f32(codewords)
    hi_s, lo_s, pre_s = [], [], []
    for g, dev in zip(mesh.shard_ids(), mesh.devices):
        hi, lo, pre = build_decoded_cache(cwn, codes_p[g * per:(g + 1) * per])
        pre[max(n_valid - g * per, 0):] = np.inf
        hi_s.append(hi.to(dev))
        lo_s.append(lo.to(dev))
        pre_s.append(torch.from_numpy(pre).to(dev))
    M, K, Ds = cwn.shape
    cw = _codewords_on(cwn, mesh.devices[0])
    q = _padded_queries(queries, M * Ds).to(cw.device)
    table = adc_table(cw, q)
    fn = make_sharded_decoded_query_fn(mesh, top_k, precision)
    d, i = fn(table, q, hi_s, lo_s, pre_s, shard_rows(mesh, codes_p))
    return d.cpu().numpy(), i.cpu().numpy()
