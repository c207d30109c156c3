"""Big-N pipeline: chunked encode, partitioned tree build and the
compressed tier split into row chunks, in PyTorch + CUDA.

Counterpart of ``deltapq_tpu/bigscale.py``.  Host memory is bounded by
encoding chunk by chunk (only codes, M B/vec, accumulate on the host);
device memory by the compressed tiles (~5 B/vec resident) plus bounded
per-batch scratch:

* ``encode_stream``      -- encode a vector stream chunk by chunk with
  ``pq_encode`` on the codewords' device; returns host NumPy codes.
* ``build_partitioned``  -- lexicographic global sort, split into P
  contiguous partitions, an independent DeltaTree per partition (a
  process pool, ``spawn`` context: the children import this package and
  torch but never touch CUDA), the per-partition DFS orders
  concatenated.  Tiles are TILE-self-contained, so partition boundaries
  cost nothing.
* ``BigCompressedIndex`` -- the compressed engine over that order, at
  int8 by default; above two chunks' worth of rows a
  ``ChunkedCompressedEngine``.
* ``ChunkedCompressedEngine`` -- one ``FusedCompressedEngine`` per row
  chunk, resident on the device or uploaded chunk by chunk per query
  batch from host (or memory-mapped) stream tiles; per-chunk exact
  top-k merged on the host.  With ``mesh=`` each chunk is a
  ``parallel.fused_sharded.ShardedCompressedEngine`` whose slot tiles
  split over the mesh's shards (chunks still run one after the other).
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from . import resolve_device
from .ops.delta_tiles import decode_delta_tiles
from .ops.encode import pq_encode
from .ops.fused import FusedCompressedEngine, _np_f32
from .ops.stream_tiles import (StreamTiles, build_stream_tiles,
                               decode_stream_tiles)


def encode_stream(codewords, chunks: Iterable[np.ndarray]) -> np.ndarray:
    """Encode a stream of vector chunks; returns codes [N, M] (u8, int32
    for K > 256) on the host.  ``codewords`` is an f32 tensor (the
    encode runs on its device) or a NumPy array (on the CPU).  Host
    memory holds only the accumulated codes, never the vector set."""
    cw = torch.as_tensor(codewords, dtype=torch.float32)
    out: List[np.ndarray] = []
    for x in chunks:
        out.append(pq_encode(cw, x, batch_size=262144).cpu().numpy())
    return np.concatenate(out, axis=0)


def _build_one_partition(args):
    """Worker: edges + DFS layout of one contiguous code partition.
    Returns the DFS permutation local to the partition plus stats."""
    codes_part, K, method = args
    from .tree.build import find_edges_by_diff
    from .tree.layout import build_layout

    t0 = time.time()
    res = find_edges_by_diff(codes_part, K=K, method=method)
    t1 = time.time()
    tree = build_layout(codes_part, res.edges, res.root_id, K=K,
                        tables="skip")
    t2 = time.time()
    return (tree.vec_id.astype(np.int64), res.n_diffs,
            t1 - t0, t2 - t1)


@dataclass
class BigBuildStats:
    n: int
    n_parts: int
    n_diffs: int
    t_sort: float
    t_build: float
    per_part: List[Tuple[float, float]] = field(default_factory=list)


def build_partitioned(codes: np.ndarray, n_parts: int = 16,
                      K: int = 256, method: int = 1,
                      workers: Optional[int] = None
                      ) -> Tuple[np.ndarray, BigBuildStats]:
    """Global lex sort + per-partition DeltaTree DFS orders.

    Returns (row_to_db [N] i64: scan row -> database id, stats with the
    (edge-find, layout) seconds of each partition).  ``workers``
    processes build the partitions (None: ``os.cpu_count()``).  The scan
    order is the concatenation of each partition's DFS order; use
    ``codes[row_to_db]`` as the tile packer's input.
    """
    n, M = codes.shape
    if workers is None:
        workers = os.cpu_count() or 1
    t0 = time.time()
    order = np.lexsort(codes.T[::-1]).astype(np.int64)
    t_sort = time.time() - t0
    bounds = np.linspace(0, n, n_parts + 1).astype(np.int64)

    t0 = time.time()
    jobs = []
    for p in range(n_parts):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        jobs.append((np.ascontiguousarray(codes[order[lo:hi]]), K,
                     method))
    if workers > 1 and n_parts > 1:
        # spawn, not fork: the parent's torch (and CUDA) runtime is
        # multithreaded, and fork risks deadlock in the children
        import multiprocessing as mp

        with ProcessPoolExecutor(
                max_workers=min(workers, n_parts),
                mp_context=mp.get_context("spawn")) as ex:
            results = list(ex.map(_build_one_partition, jobs))
    else:
        results = [_build_one_partition(j) for j in jobs]
    t_build = time.time() - t0

    row_to_db = np.empty(n, np.int64)
    n_diffs = 0
    per_part = []
    for p, (vec_id_local, nd, te, tl) in enumerate(results):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        row_to_db[lo:hi] = order[lo:hi][vec_id_local]
        n_diffs += nd
        per_part.append((te, tl))
    stats = BigBuildStats(n=n, n_parts=n_parts, n_diffs=n_diffs,
                          t_sort=t_sort, t_build=t_build,
                          per_part=per_part)
    return row_to_db, stats


class BigCompressedIndex:
    """Compressed-tier index over a partition-concatenated scan order:
    ``build_partitioned`` + a compressed engine (tiles resident on
    ``device``, decode fused into the scan).  Beyond ``2 * chunk_rows``
    rows the engine is a ``ChunkedCompressedEngine`` of resident chunks.
    """

    def __init__(self, codewords, codes: np.ndarray, n_parts: int = 16,
                 method: int = 1, workers: Optional[int] = None,
                 batch_b: int = 128, precision: str = "int8",
                 chunk_rows: Optional[int] = None, device=None):
        codewords = _np_f32(codewords)
        K = codewords.shape[1]
        codes = np.asarray(codes)
        self.row_to_db, self.build_stats = build_partitioned(
            codes, n_parts=n_parts, K=K, method=method, workers=workers)
        codes_scan = codes[self.row_to_db]
        n = len(codes_scan)
        if chunk_rows is None:
            chunk_rows = ChunkedCompressedEngine.CHUNK_ROWS
        if n > 2 * chunk_rows:
            self.engine = ChunkedCompressedEngine(
                codewords, codes_scan, row_to_db=self.row_to_db,
                precision=precision, chunk_rows=chunk_rows, resident=True,
                device=device)
        else:
            self.engine = FusedCompressedEngine(
                codewords, codes_scan, row_to_db=self.row_to_db,
                precision=precision, device=device)
        self.batch_b = batch_b

    def bytes_per_vec(self) -> float:
        return self.engine.bytes_per_vec()

    def warmup(self, batch_sizes=(128,), top_k: int = 10) -> None:
        """Certificate calibration plus one batch of each size."""
        self.engine.warmup(batch_sizes, top_k=top_k)

    def query(self, queries: np.ndarray, top_k: int = 10):
        return self.engine.query(queries, top_k=top_k)


def _sharded_chunk(codewords, codes_scan, ids, mesh, axis, precision):
    from .parallel.fused_sharded import ShardedCompressedEngine
    from .parallel.mesh import check_axis

    check_axis(mesh, axis)
    return ShardedCompressedEngine(codewords, codes_scan, mesh,
                                   row_to_db=ids, precision=precision)


class ChunkedCompressedEngine:
    """Compressed tier split into row chunks: the out-of-core path.

    Each chunk is a ``FusedCompressedEngine`` over stream tiles;
    ``resident=True`` keeps every chunk's tiles on ``device`` (uploaded
    once), ``resident=False`` keeps them on the host (or memory-mapped,
    ``from_saved``) and uploads one chunk at a time per query batch.
    Each chunk's top-k is exact (its own certificate, ladder and
    terminal scan), so the merged top-k of the concatenated per-chunk
    results equals the plain scan's up to equal-distance ties.

    With ``mesh`` (a ``parallel.mesh.Mesh``) each chunk's rows split
    over the mesh's shards (``ShardedCompressedEngine`` at ``precision``,
    exact as every chunk is); the chunks are then resident on the mesh.
    ``shard_axis`` must name the mesh's axis (ValueError otherwise).

    After each ``query``: ``last_exact_fracs`` holds each chunk's
    certified first-shot fraction, ``last_upload_s`` the host seconds
    the uploads took (0.0 when resident).
    """

    #: default rows per chunk (multiple of the kernel TILE)
    CHUNK_ROWS = 16 * 1024 * 1024
    #: the first rung the non-resident chunks share: chunk 0's calibrated
    #: one, carried from each batch's engine to the next
    ns_hint: Optional[int] = None

    def __init__(self, codewords, codes_scan: np.ndarray,
                 row_to_db: Optional[np.ndarray] = None,
                 precision: str = "int8", chunk_rows: int = CHUNK_ROWS,
                 resident: bool = True, mesh=None, shard_axis: str = "shard",
                 device=None):
        n = len(codes_scan)
        chunk_rows = max(1024, (chunk_rows // 1024) * 1024)
        self.codewords = _np_f32(codewords)
        self.precision = precision
        self.resident = resident or mesh is not None
        self.device = (mesh.devices[0] if mesh is not None
                       else resolve_device(device))
        self.chunks: List = []
        self._host: List = []
        for lo in range(0, n, chunk_rows):
            hi = min(lo + chunk_rows, n)
            ids = (np.asarray(row_to_db)[lo:hi]
                   if row_to_db is not None
                   else np.arange(lo, hi, dtype=np.int64))
            if mesh is not None:
                self.chunks.append(_sharded_chunk(
                    self.codewords, codes_scan[lo:hi], ids, mesh,
                    shard_axis, precision))
            elif resident:
                self.chunks.append(FusedCompressedEngine(
                    self.codewords, codes_scan[lo:hi], row_to_db=ids,
                    precision=precision, device=self.device))
            else:
                # the tile upload waits for query time
                self._host.append((build_stream_tiles(codes_scan[lo:hi]),
                                   ids))
        self.last_exact_fracs: List[float] = []
        self.last_upload_s = 0.0

    def bytes_per_vec(self) -> float:
        if self.resident:
            tot = sum(e.bytes_per_vec() * e.n_valid for e in self.chunks)
            nv = sum(e.n_valid for e in self.chunks)
        else:
            tot = sum(st.row_data.nbytes + st.vals.nbytes
                      for st, _ in self._host)
            nv = sum(st.n_valid for st, _ in self._host)
        return tot / max(nv, 1)

    def save(self, path: str) -> None:
        """Persist every chunk's stream tiles (``StreamTiles.save``) and
        id map as raw files, plus the codewords and a header: the JAX
        package's layout, so either package reopens it with
        ``from_saved``, memory-mapped or not."""
        os.makedirs(path, exist_ok=True)
        items = self.chunks if self.resident else self._host
        base = 0
        for i, item in enumerate(items):
            st, ids = ((item.tiles, item.row_to_db) if self.resident
                       else item)
            if not isinstance(st, StreamTiles):
                # a sharded chunk scans slot tiles: its file holds the
                # same rows as stream tiles
                st = build_stream_tiles(decode_delta_tiles(st))
            if isinstance(ids, torch.Tensor):
                ids = ids.cpu().numpy()
            ids = (np.asarray(ids) if ids is not None
                   else np.arange(base, base + st.n_valid, dtype=np.int64))
            base += st.n_valid
            cdir = os.path.join(path, f"chunk_{i:04d}")
            st.save(cdir)
            ids.astype(np.int64).tofile(os.path.join(cdir, "ids.i64"))
        np.save(os.path.join(path, "codewords.npy"), self.codewords)
        with open(os.path.join(path, "header.json"), "w") as f:
            json.dump({"n_chunks": len(items),
                       "precision": self.precision}, f)

    @classmethod
    def from_saved(cls, path: str, mmap: bool = True,
                   resident: bool = False, mesh=None,
                   shard_axis: str = "shard", device=None
                   ) -> "ChunkedCompressedEngine":
        """Reopen a saved chunked engine at its saved precision.
        ``mmap=True`` with ``resident=False`` is the beyond-host-RAM
        mode: tiles stay on disk and each query batch streams them chunk
        by chunk through the device.  ``mesh``: each chunk's rows split
        over the mesh's shards, resident there."""
        with open(os.path.join(path, "header.json")) as f:
            h = json.load(f)
        self = cls.__new__(cls)
        self.codewords = np.load(os.path.join(path, "codewords.npy"))
        self.precision = h["precision"]
        self.resident = resident or mesh is not None
        self.device = (mesh.devices[0] if mesh is not None
                       else resolve_device(device))
        self.chunks, self._host = [], []
        for i in range(int(h["n_chunks"])):
            cdir = os.path.join(path, f"chunk_{i:04d}")
            st = StreamTiles.load(cdir, mmap=mmap)
            ids = np.fromfile(os.path.join(cdir, "ids.i64"), np.int64)
            if mesh is not None:
                self.chunks.append(_sharded_chunk(
                    self.codewords, decode_stream_tiles(st), ids, mesh,
                    shard_axis, self.precision))
            elif resident:
                self.chunks.append(FusedCompressedEngine.from_tiles(
                    self.codewords, st, row_to_db=ids,
                    precision=self.precision, device=self.device))
            else:
                self._host.append((st, ids))
        self.last_exact_fracs = []
        self.last_upload_s = 0.0
        return self

    def _upload(self, st, ids):
        return FusedCompressedEngine.from_tiles(
            self.codewords, st, row_to_db=ids, precision=self.precision,
            device=self.device)

    def warmup(self, batch_sizes=(128,), top_k: int = 10,
               calibrate: bool = True) -> None:
        """Certificate calibration plus one batch of each size.  The
        first chunk calibrates its first-rung size on its own tie
        density and the hint seeds every other chunk (each still adapts
        afterwards).  Non-resident chunks are uploaded anew per batch,
        so the hint lives on this engine; as in the JAX package only
        chunk 0 is calibrated and warmed there."""
        if self.resident:
            if not self.chunks:
                return
            e0 = self.chunks[0]
            if calibrate:
                e0.calibrate(top_k=top_k)
                hint = e0.ns_hint
                if hint:
                    for e in self.chunks[1:]:
                        e.ns_hint = hint
            for e in self.chunks:
                e.warmup(batch_sizes, top_k=top_k, calibrate=False)
        elif self._host:
            eng = self._upload(*self._host[0])
            if calibrate:
                eng.calibrate(top_k=top_k)
                self.ns_hint = eng.ns_hint
            eng.warmup(batch_sizes, top_k=top_k, calibrate=False)

    def query(self, queries: np.ndarray, top_k: int = 10
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k over every chunk: (dists [B, top_k] f32, ids
        [B, top_k] int64)."""
        parts_d, parts_i = [], []
        self.last_exact_fracs = []
        self.last_upload_s = 0.0
        hint = self.ns_hint
        for c in range(len(self.chunks) if self.resident
                       else len(self._host)):
            if self.resident:
                eng = self.chunks[c]
            else:
                # one chunk on the device at a time; its tensors are
                # dropped after its scan
                t0 = time.perf_counter()
                eng = self._upload(*self._host[c])
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.last_upload_s += time.perf_counter() - t0
                if hint:
                    eng.ns_hint = hint
            d, i = eng.query(queries, top_k=top_k)
            self.last_exact_fracs.append(eng.last_exact_frac)
            if not self.resident:
                # carry the adaptation across the per-batch engines
                hint = self.ns_hint = eng.ns_hint
            parts_d.append(d)
            parts_i.append(i)
        d_all = np.concatenate(parts_d, axis=1)
        i_all = np.concatenate(parts_i, axis=1)
        order = np.argsort(d_all, axis=1, kind="stable")[:, :top_k]
        return (np.take_along_axis(d_all, order, axis=1),
                np.take_along_axis(i_all, order, axis=1))
