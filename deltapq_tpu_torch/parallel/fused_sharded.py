"""Sharded compressed engine: the slot-tile scan kernel over the port's
mesh, and the one-rung sharded query step
(``make_sharded_delta_query_fn``) it grew from.

Counterpart of ``deltapq_tpu/parallel/fused_sharded.py``.  Each shard
holds a contiguous range of the slot tiles (``ops/delta_tiles.py``)
resident on its device -- tiles are self-contained, so shards split on
tile boundaries and no decode state crosses them.  A query builds the
ADC tables and the grouped query operands once (copied to each distinct
device), then on each shard:

1. ``fused_delta_mins`` scans the shard's tiles (kernel B5,
   ``csrc/delta_mins.cu``, on a card);
2. the shard engine's ``ladder`` selects and reranks over the shard's
   codes echo, with the port's ladder and terminal exact scan, and the
   shard's own first-rung hint (on a card the per-query ladder
   kernel, ``csrc/ladder.cu``; the batch ladder with B2,
   ``csrc/rerank.cu``, otherwise), its results on the host;
3. the shard's row base is added to its rows;

and ``mesh.gather_topk`` merges the shards, after which ``row_to_db``
maps scan rows to database ids (-1 stays -1).  ``tracing``'s ``rungs``
and ``rung_rows`` add up each shard's ladder over the real rows.

Where this differs from the JAX engine, whose per-shard selection runs
one fixed rung and returns uncertified rows where a shard's certificate
fails: every shard here ends exact (ladder + terminal scan), so the
merged results are exact at every shard count, and the engine runs at
``precision`` ("bf16" by default, the JAX engine's only mode; "int8"
and "int16" too).  ``last_exact_frac`` is the fraction of queries whose
first shot certified on every shard; ``tracing``'s counters
``real_rows`` and ``first_shot_rows`` count the same queries.  A shard
holding no valid row (the padding tiles at the end) launches nothing and
contributes +inf rows.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import tracing
from ..ops import fused_kernels as fk
from ..ops.delta_tiles import DeltaTiles, TILE, _full_planes, build_delta_tiles
from ..ops.fused import FusedCompressedEngine, _np_f32
from .mesh import Mesh, all_gather, gather_topk, make_mesh, shard_rows


def _to(x, device):
    return x.to(device) if isinstance(x, torch.Tensor) else x


def _current(device):
    """``device`` made current: the kernels launch on the current
    device's streams."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else nullcontext())


def make_sharded_delta_query_fn(mesh: Mesh, top_k: int, n_sub: int,
                                pool: int, S: int, *, Ds: int):
    """The sharded slot-tile query step over the JAX operands: returns
    ``fn(q, q2, table, cwbd, row_data, ovf, n_valid) -> (dists [B,
    top_k], rows [B, top_k] global scan rows, ok [B])``, with q [G*Dg, B]
    bf16 (the grouped layout), q2 [B] f32, table [B, M, K] f32, cwbd the
    bf16 block-diagonal codebook, row_data [nT, P+S, TILE] u8 and ovf
    [nT, M, Cap] u8 whole (nT a multiple of the shard count; each shard
    keeps its contiguous tile range, as ``shard_rows`` splits).

    Each shard runs the slot-tile scan (kernel B5 on a card) and
    ``select_rerank`` (kernel B2) at the fixed ``n_sub`` -- no ladder, so
    ``ok`` (the AND of every shard's certificate) says which queries are
    exact -- and ``gather_topk`` merges the shards.  A shard holding no
    valid row launches nothing and adds +inf rows (ok); the JAX step
    scans it all the same.  ``Ds`` is the codewords' subspace width,
    which the CUDA kernels need and the JAX operands do not carry: the
    block-diagonal codebook cannot give it, since a codebook learned on
    D not divisible by M has zero columns at the end of its last
    subspace (``ops.kmeans.pq_learn`` pads D up to M*Ds)."""

    def fn(q, q2, table, cwbd, row_data, ovf, n_valid):
        n_valid = int(n_valid)
        M = ovf.shape[1]
        rds, ovfs = shard_rows(mesh, row_data), shard_rows(mesh, ovf)
        rows_local = rds[0].shape[0] * TILE
        per_dev = {}
        ds, rows, oks = [], [], []
        for g, dev, rd, ov in zip(mesh.shard_ids(), mesh.devices, rds, ovfs):
            if dev not in per_dev:
                cw = cwbd.to(dev)
                compact = None
                if dev.type == "cuda":
                    compact = fk.compact_codebook(cw, M, Ds, "bf16")
                per_dev[dev] = (q.to(dev), q2.to(dev), table.to(dev), cw,
                                compact)
            qd, q2d, td, cw, compact = per_dev[dev]
            base = g * rows_local
            local_valid = min(max(n_valid - base, 0), rows_local)
            B = qd.shape[1]
            if local_valid == 0:
                ds.append(torch.full((B, top_k), float("inf"), device=dev))
                rows.append(torch.full((B, top_k), -1, dtype=torch.int64,
                                       device=dev))
                oks.append(torch.ones(B, dtype=torch.bool, device=dev))
                continue
            with _current(dev):
                mins, echo = fk.fused_delta_mins(
                    qd, cw, rd, ov, local_valid, S, compact=compact,
                    mode="bf16")
                d, r, ok = fk.select_rerank(
                    fk.pool_mins_nb(mins, pool), q2d, td, echo, local_valid,
                    top_k, n_sub, pool, prepooled=True)
            ds.append(d)
            rows.append(torch.where(r >= 0, r.to(torch.int64) + base, -1))
            oks.append(ok)
        d, r = gather_topk(mesh, ds, rows, top_k)
        return d, r, all_gather(mesh, oks).all(dim=0)

    return fn


class ShardedCompressedEngine:
    """Slot-tile compressed engine sharded over a mesh.

    The tile count is padded to a multiple of the shard count: a padding
    tile's first row is a full-code overflow row (all mask planes set)
    over a zero overflow bank, and every padding row is masked by
    ``n_valid``.  Each local shard is a ``FusedCompressedEngine`` over its
    tile range (``self.shards``: (engine, global row base))."""

    #: each shard's engine keeps its own first rung; this one stays None,
    #: so a chunked engine over a mesh seeds no chunk with it
    ns_hint = None

    def __init__(self, codewords, codes_scan: np.ndarray,
                 mesh: Optional[Mesh] = None,
                 row_to_db: Optional[np.ndarray] = None,
                 precision: str = "bf16", device=None):
        if mesh is None:
            mesh = make_mesh(device=device)
        codewords = _np_f32(codewords)
        M, K, Ds = codewords.shape
        self.M, self.K, self.Ds, self.D = M, K, Ds, M * Ds
        self.mesh, self.precision = mesh, precision
        self.tiles = build_delta_tiles(np.asarray(codes_scan))
        self.n_valid = self.tiles.n_valid
        rd, ovf = self.tiles.row_data, self.tiles.ovf
        nt = rd.shape[0]
        nt_pad = -(-nt // mesh.size) * mesh.size
        if nt_pad != nt:
            rd_p = np.zeros((nt_pad,) + rd.shape[1:], rd.dtype)
            rd_p[:nt] = rd
            rd_p[nt:, :self.tiles.n_planes, 0] = _full_planes(M)
            ovf_p = np.zeros((nt_pad,) + ovf.shape[1:], ovf.dtype)
            ovf_p[:nt] = ovf
            rd, ovf = rd_p, ovf_p
        per = nt_pad // mesh.size
        rows_local = per * TILE
        self.shards: List[Tuple[FusedCompressedEngine, int]] = []
        for g, dev in zip(mesh.shard_ids(), mesh.devices):
            base = g * rows_local
            local = DeltaTiles(
                row_data=rd[g * per:(g + 1) * per],
                ovf=ovf[g * per:(g + 1) * per],
                n_valid=min(max(self.n_valid - base, 0), rows_local),
                M=M, S=self.tiles.S, Cap=self.tiles.Cap)
            self.shards.append((FusedCompressedEngine.from_tiles(
                codewords, local, precision=precision, device=dev), base))
        self.row_to_db = (np.asarray(row_to_db, np.int64)
                          if row_to_db is not None else None)
        self.last_exact_frac = 1.0

    def bytes_per_vec(self) -> float:
        """Resident slot-tile bytes a vector (over every shard, padding
        tiles aside)."""
        return self.tiles.nbytes() / max(self.n_valid, 1)

    def query(self, queries: np.ndarray, top_k: int = 10
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k over every shard: (dists [B, top_k] f32, ids
        [B, top_k] int64, -1 where fewer rows)."""
        e0 = self.shards[0][0]
        table, qop, uq, cert, b = e0.prepare(queries)
        operands = {e0.device: (table, qop, uq, cert)}
        ds, rows, oks = [], [], []
        for eng, base in self.shards:
            dev = eng.device
            if dev not in operands:
                operands[dev] = (table.to(dev), qop.to(dev), _to(uq, dev),
                                 tuple(_to(c, dev) for c in cert))
            t, qo, u, (q2, err_r, scale2) = operands[dev]
            if eng.n_valid == 0:
                ds.append(torch.full((t.shape[0], top_k), float("inf")))
                rows.append(torch.full((t.shape[0], top_k), -1,
                                       dtype=torch.int64))
                oks.append(torch.ones(t.shape[0], dtype=torch.bool))
                continue
            with _current(dev):
                mins, echo = eng.scan(qo, u)
                d, r, ok1, _ = eng.ladder(t, (q2, err_r, scale2), mins,
                                          echo, b, top_k, count_rows=False)
            ds.append(d)
            rows.append(torch.where(r >= 0, r.to(torch.int64) + base, -1))
            oks.append(ok1)
        d, r = gather_topk(self.mesh, ds, rows, top_k)
        ok = all_gather(self.mesh, oks).all(dim=0)[:b].cpu()
        self.last_exact_frac = float(ok.to(torch.float32).mean())
        tracing.count("real_rows", b)
        tracing.count("first_shot_rows", int(ok.sum()))
        d = d[:b].cpu().numpy()
        r = np.where(np.isfinite(d), r[:b].cpu().numpy(), -1)
        if self.row_to_db is not None:
            mapped = self.row_to_db[np.clip(r, 0, self.n_valid - 1)]
            r = np.where(r >= 0, mapped, -1)
        return d, r

    def calibrate(self, top_k: int = 10) -> float:
        """Each shard sizes its own first rung (``calibrate`` of its
        engine); returns the lowest first-shot rate reached."""
        fracs = []
        for e, _ in self.shards:
            if e.n_valid:
                with _current(e.device):
                    fracs.append(e.calibrate(top_k=top_k))
        return min(fracs, default=1.0)

    def warmup(self, batch_sizes=(512,), top_k: int = 10,
               calibrate: bool = True) -> None:
        """Calibrate every shard's first rung, then one batch of each
        size."""
        if calibrate:
            self.calibrate(top_k=top_k)
        e0 = self.shards[0][0]
        for b in batch_sizes:
            self.query(e0._warmup_queries(b), top_k=top_k)
