"""GIST1M-shape benchmark: M=16, K=256, D=960, top-100 over the fused tiers.

Usage:  python3 -m deltapq_tpu_torch.bench_gist [N] [B] [tier ...]

Counterpart of ``tools/bench_gist.py``: the same synthetic workload
(``synth.make_gist_workload``: clustered 960-d vectors -> PQ learn ->
encode; the GIST1M files themselves are not part of the repository), the
M=16 DeltaTree (method 1 with combination subsampling) and its DFS order
as the scan order, B/vec of the stream tiles in DFS order against
lexsort, and the tiers ``decoded codes stream delta delta8`` (default: all
but ``delta``, as in the JAX tool; ``delta`` is the slot-tile engine at
bf16 and ``delta8`` the stream engine at int8; ``stream16`` adds the
stream engine at int16).  Defaults N 1,000,000 and B 500.

Every tier is verified on the benchmark's batch against the exact scan
``adc_query_topk``: distances ``allclose(rtol=1e-5, atol=1e-3)``, and ids
up to ties -- every id in a query's symmetric difference with the exact
scan must lie, in f64, within 1e-9 (relative) of the k-th distance, else
it is a real divergence.  A tier whose distances differ or that has a
real divergence fails the run.  Timing: the mean host wall of
synchronised ``query`` calls after a warmup, and the scan kernel alone
between CUDA events (the JAX tool's salted loop works around a dispatch
cache this card does not have).
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import resolve_device
from .bench_engines import cuda_ms
from .ops.adc import adc_query_topk, adc_table, pad_codes
from .ops.fused import (FusedCodesEngine, FusedCompressedEngine,
                        FusedDecodedEngine)
from .ops.stream_tiles import build_stream_tiles
from .synth import make_gist_workload
from .tree.build import find_edges_by_diff
from .tree.layout import build_layout

M, K, DS, TOP_K = 16, 256, 60, 100
D = M * DS
TIERS = ("decoded", "codes", "stream", "delta8")

#: tier name -> engine over the scan-ordered codes
TIER_ENGINES: Dict[str, Callable] = {
    "decoded": lambda cw, codes, dev: FusedDecodedEngine(
        cw, codes, device=dev),
    "codes": lambda cw, codes, dev: FusedCodesEngine(
        cw, codes, device=dev),
    "stream": lambda cw, codes, dev: FusedCompressedEngine(
        cw, codes, precision="bf16", device=dev),
    "stream16": lambda cw, codes, dev: FusedCompressedEngine(
        cw, codes, precision="int16", device=dev),
    "delta": lambda cw, codes, dev: FusedCompressedEngine(
        cw, codes, precision="bf16", fmt="slots", device=dev),
    "delta8": lambda cw, codes, dev: FusedCompressedEngine(
        cw, codes, precision="int8", device=dev),
}


def gist_queries(x: np.ndarray, b: int, seed: int = 0) -> np.ndarray:
    """The benchmark's queries: ``b`` database rows plus N(0, 0.1^2)
    noise, from a generator of their own."""
    rng = np.random.default_rng(seed)
    rows = x[rng.integers(0, len(x), size=b)]
    return rows + rng.normal(size=rows.shape).astype(np.float32) * 0.1


def tree_order(codes: np.ndarray) -> Tuple[np.ndarray, int, float]:
    """(DFS order of the M=16 DeltaTree, its diff count, build seconds)."""
    t0 = time.perf_counter()
    res = find_edges_by_diff(codes, K=K, method=1)
    tree = build_layout(codes, res.edges, res.root_id, K=K, tables="skip")
    return (tree.vec_id.astype(np.int64), int(res.n_diffs),
            time.perf_counter() - t0)


def exact_reference(cw: np.ndarray, codes_scan: np.ndarray,
                    queries: np.ndarray, device, top_k: int = TOP_K,
                    table: Optional[torch.Tensor] = None):
    """(table, exact distances, exact scan rows) of ``adc_query_topk``
    over the scan-ordered codes, all on ``device``: over ``table`` where
    given, else ``adc_table``'s."""
    dev = resolve_device(device)
    if table is None:
        table = adc_table(torch.from_numpy(cw).to(dev),
                          torch.from_numpy(queries).to(dev))
    cp = torch.from_numpy(pad_codes(codes_scan, 16384)).to(dev)
    d_ref, i_ref = adc_query_topk(table, cp, len(codes_scan), top_k, 16384)
    return table, d_ref, i_ref


def tie_audit(table: torch.Tensor, codes_scan: np.ndarray, ids: np.ndarray,
              ids_ref: np.ndarray) -> Tuple[float, int, int]:
    """(id agreement, flips, real divergences): an id in a query's
    symmetric difference with the exact scan is a tie flip when its f64
    distance lies within 1e-9 (relative) of the exact scan's k-th, else a
    real divergence."""
    agree = float(np.mean(ids == ids_ref))
    tab64 = table.detach().cpu().numpy().astype(np.float64)
    ci = codes_scan.astype(np.int64)
    m_ar = np.arange(table.shape[1])[None, :]
    flips = real = 0
    for q in range(len(ids)):
        ours, ref = set(ids[q].tolist()), set(ids_ref[q].tolist())
        sym = sorted((ours - ref) | (ref - ours))
        if not sym:
            continue
        d64 = tab64[q, m_ar, ci[sym]].sum(axis=1)
        dk = tab64[q, m_ar, ci[ids_ref[q]]].sum(axis=1).max()
        flips += len(sym)
        real += int(np.sum(np.abs(d64 - dk) > 1e-9 * max(dk, 1e-12)))
    return agree, flips, real


def verify(eng, name: str, queries: np.ndarray, table: torch.Tensor,
           d_ref: np.ndarray, ids_ref: np.ndarray, codes_scan: np.ndarray,
           top_k: int = TOP_K) -> Dict[str, float]:
    """One batch of ``eng.query`` against the exact scan; raises on
    distances out of tolerance or a real id divergence.  The engine has
    no row map, so its ids and ``ids_ref`` are both scan rows.  A bf16
    engine on a card makes its own table (``csrc/prepare.cu``), equal to
    ``table`` up to the order of its f32 sums: its ids are audited against
    the exact scan over that table."""
    d, ids = eng.query(queries, top_k=top_k)
    dists_ok = bool(np.allclose(d, d_ref, rtol=1e-5, atol=1e-3))
    own = eng.prepare(queries)[0][:len(queries)]
    if not torch.equal(own, table):
        table, _, i_own = exact_reference(None, codes_scan, queries,
                                          own.device, top_k, table=own)
        ids_ref = i_own.cpu().numpy()
    agree, flips, real = tie_audit(table, codes_scan, ids, ids_ref)
    out = dict(dists_match=dists_ok, id_agree=agree, flips=flips,
               real_divergences=real, first_shot=eng.last_exact_frac)
    print(f"  {name}: dists_match={dists_ok} id_agree={agree:.4f} "
          f"first_shot_cert={eng.last_exact_frac:.3f} tie_audit: {flips} "
          f"flips, {real} real divergences", flush=True)
    if not dists_ok or real:
        raise AssertionError(f"{name}: not exact against adc_query_topk "
                             f"({out})")
    return out


def time_engine(eng, queries: np.ndarray, top_k: int = TOP_K,
                n_batches: int = 5) -> Tuple[float, float]:
    """(mean host-wall ms of a synchronised ``query``, device ms of the
    scan kernel alone)."""
    eng.query(queries, top_k=top_k)
    walls = []
    for _ in range(n_batches):
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.query(queries, top_k=top_k)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    _, qop, uq, _, _ = eng.prepare(queries)
    return float(np.mean(walls)) * 1e3, cuda_ms(lambda: eng.scan(qop, uq), 3)


def main(argv: Optional[List[str]] = None, device=None) -> Dict[str, dict]:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if len(argv) > 0 else 1_000_000
    b = int(argv[1]) if len(argv) > 1 else 500
    tiers = list(argv[2:]) or list(TIERS)
    unknown = [t for t in tiers if t not in TIER_ENGINES]
    if unknown:
        raise SystemExit(f"unknown tier(s) {unknown}; known: "
                         f"{sorted(TIER_ENGINES)}")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    cw, codes, x = make_gist_workload(n, M, K, DS, device=dev)
    print(f"workload built in {time.perf_counter() - t0:.1f}s", flush=True)
    queries = gist_queries(x, b)
    del x

    order, n_diffs, t_tree = tree_order(codes)
    codes_scan = codes[order]
    bpv_dfs = build_stream_tiles(codes_scan).bytes_per_vec()
    bpv_lex = build_stream_tiles(
        codes[np.lexsort(codes.T[::-1])]).bytes_per_vec()
    print(f"M={M} tree build {t_tree:.1f}s ({n_diffs} diffs); "
          f"{len(np.unique(codes, axis=0))} distinct codes; stream B/vec: "
          f"tree-DFS {bpv_dfs:.3f} vs lexsort {bpv_lex:.3f} (plain {M})",
          flush=True)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain versions: no device time)")
    print(f"{name}: N={n} B={b} M={M} K={K} D={D} top_k={TOP_K}", flush=True)

    # engines scan in tree-DFS order and report scan rows (no row map),
    # as the JAX tool's do
    table, d_ref, i_ref = exact_reference(cw, codes_scan, queries, dev)
    d_ref, ids_ref = d_ref.cpu().numpy(), i_ref.cpu().numpy()
    results: Dict[str, dict] = {}
    for tier in tiers:
        eng = TIER_ENGINES[tier](cw, codes_scan, dev)
        if hasattr(eng, "tiles"):
            extra = (f"S={eng.tiles.S} Cap={eng.tiles.Cap} "
                     if eng.fmt == "slots" else f"e_max={eng.tiles.e_max} ")
            print(f"  {tier} tiles: planes={eng.tiles.n_planes} {extra}"
                  f"bytes/vec={eng.bytes_per_vec():.3f}", flush=True)
        res = verify(eng, tier, queries, table, d_ref, ids_ref, codes_scan)
        if dev.type == "cuda":
            res["ms_batch"], res["ms_scan"] = time_engine(eng, queries)
        results[tier] = res
        del eng
    b_pad = -(-b // 128) * 128
    for tier, res in results.items():
        if "ms_batch" in res:
            print(f"{tier}: {res['ms_batch']:.3f} ms/batch  "
                  f"{b / res['ms_batch'] * 1e3:,.0f} QPS (scan kernel "
                  f"{res['ms_scan']:.3f} ms at B={b_pad})", flush=True)
    return results


if __name__ == "__main__":
    main()
