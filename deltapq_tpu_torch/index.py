"""High-level index facade: the product API, in PyTorch + CUDA.

Counterpart of ``deltapq_tpu/index.py``: codebook learning -> encoding
-> DeltaTree compression -> engine selection -> query, with live
inserts (an uncompressed tail buffer, folded in once it outgrows
``rebuild_fraction``), masked deletes and persistence.  Every tensor of
the index lives on ``device`` (``None``: the card).  ``save`` and
``load`` use the JAX package's on-disk layout (``index.npz``, ``config.json``,
``compressed.dtc``, ``tree_soa.npz``), so each package loads the
other's directory.

Example::

    idx = DeltaPQIndex.build(train_vecs, base_vecs, M=8, K=256)
    dists, ids = idx.search(queries, top_k=10)
    idx.add(new_vecs)
    idx.remove([3, 17])
    idx.save("index_dir")
    idx2 = DeltaPQIndex.load("index_dir")
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np
import torch

from . import resolve_device, tracing

FUSED_ENGINES = ("fused", "fused_codes", "fused_compressed", "fused_dedup")


class DeltaPQIndex:
    def __init__(self, codewords, codes: np.ndarray, engine: str = "auto",
                 tree_method: int = 1, height: int = 1,
                 rebuild_fraction: float = 0.2, build_tree: bool = True,
                 device=None):
        self.codewords = (codewords.detach().cpu().numpy()
                          if isinstance(codewords, torch.Tensor)
                          else np.asarray(codewords, np.float32))
        self.codewords = self.codewords.astype(np.float32)
        self.M, self.K, self.Ds = self.codewords.shape
        self.codes = np.asarray(codes)
        self.engine = engine
        self.tree_method = tree_method
        self.height = height
        self.rebuild_fraction = rebuild_fraction
        self.device = resolve_device(device)
        self.tail = np.empty((0, self.M), self.codes.dtype)
        self.deleted = np.zeros(0, bool)  # lazily sized
        self.tree = None
        self._stream = None
        self._cached_codes = None  # device copy of all codes, built lazily
        self._fused_engine = None
        self._engine_resolved = None  # "auto" resolution, per process
        if build_tree and self.K <= 256 and self.M <= 16 and len(codes):
            self._build_tree()

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, train_vecs: np.ndarray, base_vecs: np.ndarray,
              M: int = 8, K: int = 256, seed: int = 0,
              max_iters: int = 100, device=None, **kw) -> "DeltaPQIndex":
        """Learn the codebook on ``train_vecs`` (k-means seeded from a
        ``torch.Generator`` seeded with ``seed``), encode ``base_vecs``
        and index them."""
        from .ops.encode import pq_encode
        from .ops.kmeans import pq_learn

        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        cw = pq_learn(gen, np.asarray(train_vecs), M=M, K=K,
                      max_iters=max_iters, device=device)
        codes = pq_encode(cw, np.asarray(base_vecs)).cpu().numpy()
        return cls(cw, codes, device=device, **kw)

    def _build_tree(self):
        from .tree.build import find_edges_by_diff
        from .tree.build_device import find_edges_by_diff_device
        from .tree.layout import build_layout
        from .tree.serialize import serialize_dtc

        kw = dict(K=self.K, max_height_folds=self.height,
                  method=self.tree_method)
        # the same result on both routes; method 3 runs on the host only
        if self.device.type == "cuda" and self.tree_method != 3:
            with tracing.span("index.build.edges", device=str(self.device)):
                res = find_edges_by_diff_device(self.codes,
                                                device=self.device, **kw)
        else:
            with tracing.span("index.build.edges", device="host"):
                res = find_edges_by_diff(self.codes, **kw)
        with tracing.span("index.build.layout"):
            self.tree = build_layout(self.codes, res.edges, res.root_id,
                                     K=self.K, codewords=self.codewords)
        # the DTC byte format caps at M=8 (a one-byte bitmap); for
        # 8 < M <= 16 the tree still gives the compressed tier its scan
        # order and the stream tiles are the compressed form
        with tracing.span("index.build.serialize"):
            self._stream = (serialize_dtc(self.tree) if self.M <= 8
                            else None)

    # -- queries -----------------------------------------------------------

    @property
    def n(self) -> int:
        return len(self.codes) + len(self.tail)

    def _all_codes(self) -> np.ndarray:
        if len(self.tail):
            return np.concatenate([self.codes, self.tail])
        return self.codes

    def search(self, queries: np.ndarray, top_k: int = 10
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over main + tail, with deleted rows masked: (dists
        [B, top_k] f32, ids [B, top_k] int64; +inf / -1 where fewer than
        top_k live rows).  ``fetch`` is rounded up to a power of two so
        growing delete counts do not change the scan's shape every
        call."""
        from .ops.adc import query_plain

        with tracing.span("index.search"):
            engine = self.engine
            if engine == "auto":
                # resolved into a separate field: self.engine stays "auto"
                # (and save() persists it), so a loaded index resolves anew
                # on the device it is loaded on
                if self._engine_resolved is None:
                    self._engine_resolved = self._resolve_auto()
                engine = self._engine_resolved
            if engine in FUSED_ENGINES:
                return self._search_fused(queries, top_k, engine)
            q = np.asarray(queries, np.float32)
            fetch = top_k + int(self.deleted.sum())
            fetch = min(1 << (max(fetch, 1) - 1).bit_length(), self.n)
            fetch = min(max(fetch, top_k), self.n)  # never exceed rows
            if self._cached_codes is None:
                self._cached_codes = torch.from_numpy(
                    np.ascontiguousarray(self._all_codes())).to(self.device)
            d, i = query_plain(self.codewords, q, self._cached_codes,
                               top_k=fetch, engine=engine, device=self.device)
            i = i.astype(np.int64)
            return self._finish(d, i, top_k)

    def _finish(self, d: np.ndarray, i: np.ndarray, top_k: int
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Mask deleted rows, pad to top_k, mark rows that ran out of live
        candidates (mass deletes) -1."""
        with tracing.span("index.finish"):
            if self.deleted.any():
                dele = np.flatnonzero(self.deleted)
                bad = np.isin(i, dele)
                d = np.where(bad, np.inf, d)
                order = np.argsort(d, axis=1, kind="stable")
                d = np.take_along_axis(d, order, axis=1)
                i = np.take_along_axis(i, order, axis=1)
            if d.shape[1] < top_k:
                pad = top_k - d.shape[1]
                d = np.concatenate(
                    [d, np.full((len(d), pad), np.inf, d.dtype)], axis=1)
                i = np.concatenate(
                    [i, np.full((len(i), pad), -1, i.dtype)], axis=1)
            d, i = d[:, :top_k], i[:, :top_k]
            return d, np.where(np.isinf(d), -1, i)

    def _resolve_auto(self, device=None) -> str:
        """Resolve engine="auto" once, at first search.  On a CUDA
        device: "pallas" (the ADC top-k kernel) for K > 256 or M > 16,
        "fused_dedup" when the distinct codes fit the exact-all regime,
        else "fused_compressed" -- the JAX package's accelerator rule.
        On the CPU the kernels run as their plain versions, so the plain
        scan "xla" stays.  On a CUDA device "auto" never resolves to
        "xla"."""
        from .ops.fused import DedupCompressedEngine

        device = torch.device(device) if device is not None else self.device
        if device.type != "cuda":
            return "xla"
        if self.K > 256 or self.M > 16 or not len(self.codes):
            return "pallas"
        n_unique = len(np.unique(self._all_codes(), axis=0))
        if n_unique <= DedupCompressedEngine.EXACT_ALL_MAX_ROWS:
            return "fused_dedup"
        return "fused_compressed"

    def _search_fused(self, queries, top_k, engine):
        """Fused-engine search: the engine object is cached and rebuilt
        lazily after add/remove/compact."""
        if self._fused_engine is None:
            self._fused_engine = self._make_engine(engine)
        # over-fetch so masked (deleted) rows cannot truncate results
        k_eff = min(top_k + int(self.deleted.sum()), self.n)
        d, i = self._fused_engine.query(np.asarray(queries, np.float32),
                                        top_k=k_eff)
        return self._finish(d, i.astype(np.int64), top_k)

    def _make_engine(self, engine: str):
        from .ops.fused import (DedupCompressedEngine, FusedCodesEngine,
                                FusedCompressedEngine, FusedDecodedEngine)

        with tracing.span("engine.build"):
            codes = self._all_codes()
            dev = self.device
            if engine == "fused" or self.K > 256:
                # wider codes run on the decoded tier only
                return FusedDecodedEngine(self.codewords, codes, device=dev)
            if engine == "fused_codes":
                return FusedCodesEngine(self.codewords, codes, device=dev)
            if engine == "fused_dedup":
                return DedupCompressedEngine(self.codewords, codes, device=dev)
            # the compressed tier at bf16, as the JAX index builds it
            if self.tree is not None and len(self.tail) == 0:
                return FusedCompressedEngine.from_tree(
                    self.codewords, self.tree, precision="bf16", device=dev)
            order = np.lexsort(codes.T[::-1])
            return FusedCompressedEngine(self.codewords, codes[order],
                                         row_to_db=order, precision="bf16",
                                         device=dev)

    # -- updates -----------------------------------------------------------

    def _invalidate(self):
        self._cached_codes = None
        self._fused_engine = None
        self._engine_resolved = None  # the dup factor may have changed

    def add(self, vecs: np.ndarray) -> np.ndarray:
        """Insert vectors; returns their ids.  New codes go to the
        uncompressed tail; the tree is rebuilt when the tail exceeds
        ``rebuild_fraction`` of the index."""
        from .ops.encode import pq_encode

        cw = torch.from_numpy(self.codewords).to(self.device)
        new_codes = pq_encode(cw, np.asarray(vecs, np.float32)
                              ).cpu().numpy().astype(self.codes.dtype)
        ids = np.arange(self.n, self.n + len(new_codes))
        self.tail = np.concatenate([self.tail, new_codes])
        self._invalidate()
        if len(self.tail) > self.rebuild_fraction * max(len(self.codes), 1):
            self.compact()
        return ids

    def remove(self, ids) -> None:
        """Mask rows as deleted (compacted out at the next rebuild)."""
        ids = np.asarray(ids, np.int64)
        if len(self.deleted) < self.n:
            self.deleted = np.concatenate(
                [self.deleted, np.zeros(self.n - len(self.deleted), bool)])
        self.deleted[ids] = True

    def compact(self) -> None:
        """Fold the tail into the main code array, drop deleted rows and
        rebuild the DeltaTree.  Row ids change (compaction)."""
        all_codes = self._all_codes()
        if len(self.deleted):
            mask = np.ones(len(all_codes), bool)
            mask[:len(self.deleted)] &= ~self.deleted
            all_codes = all_codes[mask]
        self.codes = all_codes
        self.tail = np.empty((0, self.M), self.codes.dtype)
        self.deleted = np.zeros(0, bool)
        self._invalidate()
        if self.K <= 256 and self.M <= 16 and len(self.codes):
            self._build_tree()

    # -- stats / persistence ----------------------------------------------

    def stats(self) -> dict:
        out = {"n": self.n, "n_main": len(self.codes),
               "n_tail": len(self.tail),
               "n_deleted": int(self.deleted.sum()),
               "plain_bytes": int(self.n * self.codes.itemsize * self.M)}
        if self._stream is not None:
            out["compressed_bytes"] = len(self._stream)
            out["bytes_per_vec"] = round(
                len(self._stream) / max(len(self.codes), 1), 3)
        eng = self._fused_engine
        if eng is not None and hasattr(eng, "bytes_per_vec"):
            out["delta_tile_bytes_per_vec"] = round(eng.bytes_per_vec(), 3)
        return out

    def save(self, path: str) -> None:
        """Write the JAX package's index directory (tail and deletes are
        folded in first, so the stream and tree describe the saved
        rows)."""
        from .tree.serialize import write_dtc

        if len(self.tail) or (len(self.deleted) and self.deleted.any()):
            self.compact()
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, "index.npz"),
                 codewords=self.codewords, codes=self._all_codes(),
                 deleted=self.deleted)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump({"engine": self.engine, "method": self.tree_method,
                       "height": self.height, "M": self.M, "K": self.K},
                      f)
        if self._stream is not None:
            write_dtc(os.path.join(path, "compressed.dtc"), self.tree)
            t = self.tree
            np.savez(os.path.join(path, "tree_soa.npz"),
                     vec_id=t.vec_id, parent_pos=t.parent_pos,
                     depth=t.depth, diff_num=t.diff_num,
                     diff_off=t.diff_off, diff_m=t.diff_m,
                     diff_to=t.diff_to,
                     child_pos_start=t.child_pos_start,
                     child_num=t.child_num, max_dist=t.max_dist,
                     max_dist2p=t.max_dist2p, root_id=t.root_id,
                     M=t.M, K=t.K)

    @classmethod
    def load(cls, path: str, device=None) -> "DeltaPQIndex":
        """Open an index directory written by either package."""
        from .tree.layout import DeltaTree
        from .tree.serialize import serialize_dtc

        with np.load(os.path.join(path, "index.npz")) as z:
            codewords, codes, deleted = (z["codewords"], z["codes"],
                                         z["deleted"])
        with open(os.path.join(path, "config.json")) as f:
            cfg = json.load(f)
        idx = cls(codewords, codes, engine=cfg["engine"],
                  tree_method=cfg["method"], height=cfg["height"],
                  build_tree=False, device=device)
        soa = os.path.join(path, "tree_soa.npz")
        if os.path.exists(soa):
            with np.load(soa) as t:
                idx.tree = DeltaTree(
                    vec_id=t["vec_id"], parent_pos=t["parent_pos"],
                    depth=t["depth"], diff_num=t["diff_num"],
                    diff_off=t["diff_off"], diff_m=t["diff_m"],
                    diff_to=t["diff_to"],
                    child_pos_start=t["child_pos_start"],
                    child_num=t["child_num"], max_dist=t["max_dist"],
                    max_dist2p=t["max_dist2p"], root_id=int(t["root_id"]),
                    M=int(t["M"]), K=int(t["K"]))
            idx._stream = serialize_dtc(idx.tree)
        if len(deleted):
            idx.deleted = deleted
        return idx
