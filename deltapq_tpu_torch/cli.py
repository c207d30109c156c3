"""Unified CLI covering both reference binaries, on the port.

Counterpart of ``deltapq_tpu/cli.py``: the same flags (single-dash, as
the reference's ``pqtree`` ``main.cpp:183-233`` and ``deltapq``
``deltapq_approx_tree_main.cpp:26-70``), the same tasks, the same
eight ``-engine`` choices, the same file names, the same printed lines
and the same final metrics JSON line.  Every task runs on one card;
``main(argv, device="cpu")`` runs it on the CPU (the tests do).

Where it differs from the JAX CLI:

- ``learn`` seeds a ``torch.Generator``, not a ``jax.random`` key, so
  the codewords differ from the JAX package's for the same seed;
- ``-shards N`` shards the plain scan over ``make_mesh(N)``: N shards
  placed round-robin over the cards (on one card, N shards of it), where
  the JAX CLI takes the first N devices;
- ``query_compressed`` takes the fused compressed engine (bf16, as the
  JAX ``from_tree`` default) for ``auto`` and ``fused_compressed`` on a
  CUDA device, where the JAX CLI takes it on a TPU;
- ``diff_scan`` decodes with the Python decoder (``native/`` is not
  ported).

Usage (a dataset directory holding ``base``/``learn``/``query`` files):

  python -m deltapq_tpu_torch.cli -dataset /data/sift -ext fvecs \\
      -task learn -m 8 -k 256 -train_size 100000
  python -m deltapq_tpu_torch.cli -dataset /data/sift -task encode
  python -m deltapq_tpu_torch.cli -dataset /data/sift -task approx_tree
  python -m deltapq_tpu_torch.cli -dataset /data/sift -task query -topk 10
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time

import numpy as np
import torch

from . import resolve_device
from .config import (PQConfig, TreeConfig, codewords_filename, codes_filename,
                     groundtruth_filename, diff_index_filename,
                     compressed_codes_filename, edges_filename)
from .io import (read_vecs, iter_vec_batches, num_vectors, read_codewords,
                 write_codewords, read_codes, write_codes, read_groundtruth,
                 write_groundtruth)
from .profiling import Metrics, host_mem_usage

ENGINES = ["auto", "xla", "pallas", "decoded", "fused", "fused_codes",
           "fused_compressed", "fused_dedup"]
FUSED = ("fused", "fused_codes", "fused_compressed", "fused_dedup")
#: the SoA fields of a DeltaTree as ``approx_tree`` caches them
SOA_FIELDS = ("vec_id", "parent_pos", "depth", "diff_num", "diff_off",
              "diff_m", "diff_to", "child_pos_start", "child_num",
              "max_dist", "max_dist2p")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="deltapq-tpu-torch", add_help=False)
    p.add_argument("--help", action="help")
    p.add_argument("-dataset", required=True, help="dataset directory")
    p.add_argument("-task", required=True)
    p.add_argument("-ext", default="fvecs", choices=["fvecs", "bvecs"])
    p.add_argument("-m", type=int, default=8, help="PQ subspaces M")
    p.add_argument("-k", type=int, default=256, help="centroids per subspace")
    p.add_argument("-N", type=int, default=-1, help="number of vectors")
    p.add_argument("-topk", type=int, default=10)
    p.add_argument("-query_size", type=int, default=-1)
    p.add_argument("-train_size", type=int, default=-1)
    p.add_argument("-diff", type=int, default=-1,
                   help="max edge weight (default M)")
    p.add_argument("-h", dest="height", type=int, default=1,
                   help="tree height multiplier (MAX_HEIGHT = M*h)")
    p.add_argument("-method", type=int, default=1, choices=[1, 2, 3],
                   help="edge finding: 1=height star, 2=WOH, 3=TA "
                        "minimum-weight attachment (find_edge.cpp:48)")
    p.add_argument("-debug", type=int, default=0)
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-batch", type=int, default=128,
                   help="query batch size per device dispatch")
    p.add_argument("-shards", type=int, default=0,
                   help="shard over this many devices (0 = single device)")
    p.add_argument("-metrics_out", default=None,
                   help="write stage metrics JSON to this path")
    p.add_argument("-rand_sample", type=int, default=0,
                   help="query task: self-query random base vectors, "
                        "report the code Hamming histogram "
                        "(reference -rand_sample, main.cpp:522-562)")
    p.add_argument("-synth", type=int, default=0,
                   help="encode task: generate a synthetic chain-code "
                        "dataset instead of encoding base vectors "
                        "(reference -synth, main.cpp:443-462)")
    p.add_argument("-src_a", default=None, help="combine: first code file")
    p.add_argument("-src_b", default=None, help="combine: second code file")
    p.add_argument("-engine", default="auto", choices=ENGINES,
                   help="scan engine: fused* = subtile-min kernel tiers "
                        "(fused=decoded bf16 tier, fused_codes=u8 "
                        "tier, fused_compressed=delta-tile tier, "
                        "fused_dedup=distinct-code product tier)")
    p.add_argument("-force", type=int, default=0,
                   help="rebuild artifacts even if cached files exist "
                        "(reference semantics: every stage is cached and "
                        "skipped when its file exists, exists_test3)")
    return p


def _pq_config(args, dim) -> PQConfig:
    return PQConfig(M=args.m, K=args.k, dim=dim)


def _sync(args):
    """What ``Metrics.stage`` waits on before it stops the clock."""
    return torch.cuda.synchronize if args.device.type == "cuda" else None


def _codewords(args) -> np.ndarray:
    cfg = PQConfig(M=args.m, K=args.k)
    return read_codewords(os.path.join(args.dataset, codewords_filename(cfg)))


def _load_codes(args):
    cfg = PQConfig(M=args.m, K=args.k)
    n = args.N
    path = os.path.join(args.dataset,
                        codes_filename(cfg, n if n > 0 else None))
    if not os.path.exists(path) and n <= 0:
        # search for any N
        cands = glob.glob(os.path.join(
            args.dataset, f"codes.bin.plain.M{args.m}K{args.k}N*"))
        if not cands:
            raise FileNotFoundError(
                f"no code file for M={args.m} K={args.k} in {args.dataset}; "
                f"run -task encode first")
        # pick the largest N numerically (lexicographic sort would pick
        # e.g. N10000 over N2000 arbitrarily)
        def _n_suffix(p):
            m = re.search(r"N(\d+)$", p)
            return int(m.group(1)) if m else -1
        path = max(cands, key=_n_suffix)
    codes, _ = read_codes(path, M=args.m, K=args.k)
    if n > 0:
        codes = codes[:n]
    return codes


def _load_queries(args):
    q = read_vecs(os.path.join(args.dataset, f"query.{args.ext}"),
                  ext=args.ext)
    if args.query_size > 0:
        q = q[:args.query_size]
    elif len(q) > 10000:
        # reference default query pool cap; announce the truncation
        print(f"using first 10000 of {len(q)} queries "
              f"(-query_size to override)")
        q = q[:10000]
    return q


def _query_batches(eng, q, args):
    """An engine's answers for all queries, ``-batch`` at a time, into
    one pair of host arrays."""
    d = np.empty((len(q), args.topk), np.float32)
    i = np.empty((len(q), args.topk), np.int64)
    for off in range(0, len(q), args.batch):
        db, ib = eng.query(q[off:off + args.batch], top_k=args.topk)
        d[off:off + len(db)] = db
        i[off:off + len(ib)] = ib
    return d, i


def task_learn(args, metrics: Metrics):
    from .ops.kmeans import pq_learn

    out_path = os.path.join(args.dataset,
                            codewords_filename(PQConfig(M=args.m, K=args.k)))
    if os.path.exists(out_path) and not args.force:
        print(f"REMINDER: codewords exist, skipping (use -force 1): "
              f"{out_path}")
        return
    learn_path = os.path.join(args.dataset, f"learn.{args.ext}")
    with metrics.stage("read"):
        # load pool of 100K, shuffle, cut to train_size (main.cpp:250-264)
        learns = read_vecs(learn_path, ext=args.ext, top_n=100_000)
    rng = np.random.default_rng(args.seed)
    rng.shuffle(learns)
    if args.train_size > 0:
        learns = learns[:args.train_size]
    print(f"learn pool {len(learns)} vectors dim {learns.shape[1]}")
    with metrics.stage("kmeans", sync=_sync(args)):
        # reference termination: <=1000 iters, eps 1.0, 3 attempts
        # (cv::kmeans TermCriteria, pq.cpp:149-151)
        gen = torch.Generator(device=args.device).manual_seed(args.seed)
        cw = pq_learn(gen, learns, M=args.m, K=args.k, max_iters=1000,
                      tol=1.0, n_init=3, device=args.device)
    out = os.path.join(args.dataset,
                       codewords_filename(_pq_config(args, learns.shape[1])))
    write_codewords(out, cw.cpu().numpy())
    print(f"codewords written to {out}")


def task_encode(args, metrics: Metrics):
    from .ops.encode import pq_encode

    cfg = PQConfig(M=args.m, K=args.k)
    if args.synth:
        from .synth import chain_codes

        n = args.N if args.N > 0 else 100_000
        codes = chain_codes(n, M=args.m, K=args.k, seed=args.seed)
        out = os.path.join(args.dataset, codes_filename(cfg, n))
        write_codes(out, codes)
        print(f"{n} synthetic chain codes written to {out}")
        return
    cw = torch.from_numpy(_codewords(args)).to(args.device)
    base = os.path.join(args.dataset, f"base.{args.ext}")
    total = num_vectors(base, args.ext)
    if args.N > 0:
        total = min(total, args.N)
    out_path = os.path.join(args.dataset, codes_filename(cfg, total))
    if os.path.exists(out_path) and not args.force:
        print(f"REMINDER: code file exists, skipping (use -force 1): "
              f"{out_path}")
        return
    chunks = []
    with metrics.stage("encode"):
        for batch in iter_vec_batches(base, ext=args.ext,
                                      batch_size=262144, top_n=total):
            chunks.append(pq_encode(cw, batch).cpu().numpy())
    codes = np.concatenate(chunks).astype(cfg.code_dtype)
    out = os.path.join(args.dataset, codes_filename(cfg, len(codes)))
    write_codes(out, codes)
    print(f"{len(codes)} codes written to {out}")


def task_combine(args, metrics: Metrics):
    """Merge two code files (reference ``combine``, ``main.cpp:283-313``)."""
    cfg = PQConfig(M=args.m, K=args.k)
    a, _ = read_codes(args.src_a, M=args.m, K=args.k)
    b, _ = read_codes(args.src_b, M=args.m, K=args.k)
    combined = np.concatenate([a, b])
    out = os.path.join(args.dataset, codes_filename(cfg, len(combined)))
    write_codes(out, combined)
    print(f"{len(a)} + {len(b)} codes combined into {out}")


def task_rand_sample(args, metrics: Metrics):
    """Self-query sampled base vectors excluding the query row; report
    the code Hamming histogram (``SampledQuery``, ``pq_tree.cpp:278-392``,
    ``main.cpp:522-562``)."""
    from .ops.adc import query_plain
    from .eval.metrics import code_hamming_hist

    cw = _codewords(args)
    codes = _load_codes(args)
    n_sample = args.rand_sample if args.rand_sample > 1 else \
        (args.query_size if args.query_size > 0 else 1000)
    rng = np.random.default_rng(args.seed)
    ids = rng.integers(0, len(codes), min(n_sample, len(codes)))
    base = read_vecs(os.path.join(args.dataset, f"base.{args.ext}"),
                     ext=args.ext)
    q = base[ids]
    with metrics.stage("query"):
        d, i = query_plain(cw, q, codes, top_k=3, device=args.device)
    # top-1 excluding the query row itself (top-3 fetch: with ties the
    # self row may rank 2nd or 3rd)
    nn = np.where(i[:, 0] != ids, i[:, 0],
                  np.where(i[:, 1] != ids, i[:, 1], i[:, 2]))
    hist = code_hamming_hist(codes[ids], codes[nn])
    for h, c in enumerate(hist):
        print(f"dist_hist[{h}] = {c}")
    metrics.set("dist_hist", hist.tolist())


def task_groundtruth(args, metrics: Metrics):
    from .eval.groundtruth import groundtruth_from_file

    q = _load_queries(args)
    base = os.path.join(args.dataset, f"base.{args.ext}")
    with metrics.stage("scan"):
        d, i = groundtruth_from_file(base, q, args.ext, top_k=args.topk,
                                     top_n=args.N, device=args.device)
    n = num_vectors(base, args.ext) if args.N <= 0 else args.N
    gt_dir = os.path.join(args.dataset, "groundtruth")
    os.makedirs(gt_dir, exist_ok=True)
    out = os.path.join(gt_dir, groundtruth_filename(n, args.topk))
    write_groundtruth(out, i, d)
    print(f"groundtruth written to {out}")


def _fused_engine(args, cw, codes):
    from .ops.fused import (DedupCompressedEngine, FusedCodesEngine,
                            FusedCompressedEngine, FusedDecodedEngine)

    if args.engine == "fused":
        return FusedDecodedEngine(cw, codes, device=args.device)
    if args.engine == "fused_codes":
        return FusedCodesEngine(cw, codes, device=args.device)
    if args.engine == "fused_dedup":
        return DedupCompressedEngine(cw, codes, device=args.device)
    # the JAX engine's default precision, bf16 (the port's class: int16)
    order = np.lexsort(codes.T[::-1])
    return FusedCompressedEngine(cw, codes[order], row_to_db=order,
                                 precision="bf16", device=args.device)


def task_query(args, metrics: Metrics):
    """Plain ADC query (pqtree -task query / deltapq -task pqscan)."""
    from .ops.adc import query_plain
    from .parallel import make_mesh, sharded_query_plain

    cw = _codewords(args)
    codes = _load_codes(args)
    q = _load_queries(args)
    t0 = time.perf_counter()
    with metrics.stage("query"):
        if args.shards:
            d, i = sharded_query_plain(
                cw, q, codes, top_k=args.topk,
                mesh=make_mesh(args.shards, device=args.device))
        elif args.engine == "decoded":
            from .ops.decoded import DecodedEngine
            eng = DecodedEngine(cw, codes, device=args.device)
            d, i = eng.query(q, top_k=args.topk)
        elif args.engine in FUSED:
            d, i = _query_batches(_fused_engine(args, cw, codes), q, args)
        elif len(q) > args.batch:
            # continuous batching: fixed-size dispatches, double-buffered
            from .ops.adc import query_plain_tensors
            from .parallel.runtime import ContinuousBatcher, batch_iterator
            cw_dev = torch.from_numpy(cw).to(args.device)
            codes_dev = torch.from_numpy(codes).to(args.device)
            outs = list(ContinuousBatcher(
                lambda b: query_plain_tensors(cw_dev, b, codes_dev,
                                              top_k=args.topk,
                                              engine=args.engine,
                                              device=args.device)).run(
                batch_iterator(q, args.batch)))
            d = np.concatenate([o[0] for o in outs])[:len(q)]
            i = np.concatenate([o[1] for o in outs])[:len(q)]
        else:
            d, i = query_plain(cw, q, codes, top_k=args.topk,
                               engine=args.engine, device=args.device)
    dt = time.perf_counter() - t0
    print(f"{dt / len(q) * 1000:.4f} [msec/query]")
    if args.debug:
        for b in range(min(5, len(q))):
            print(i[b, 0], d[b, 0])
    return d, i


def _save_soa(path, tree):
    np.savez(path, **{f: getattr(tree, f) for f in SOA_FIELDS},
             root_id=tree.root_id, M=tree.M, K=tree.K)


def task_approx_tree(args, metrics: Metrics):
    from .tree.build import EdgeFindResult, find_edges_by_diff
    from .tree.layout import build_layout
    from .tree.serialize import write_dtc

    cfg = PQConfig(M=args.m, K=args.k)
    tcfg = TreeConfig(diff=args.diff if args.diff > 0 else None,
                      h=args.height, method=args.method)
    cw = _codewords(args)
    codes = _load_codes(args)
    n = len(codes)
    done = os.path.join(args.dataset,
                        compressed_codes_filename(cfg, tcfg, n))
    if os.path.exists(done) and os.path.exists(done + ".soa.npz") \
            and not args.force:
        print(f"REMINDER: DPNode file exists. No need to rebuild! "
              f"(use -force 1)\n    {done}")
        return
    # stage cache for the edges (reference find_edges_by_diff_approx
    # checks/writes its edges file, deltapq_create_approx_tree.h:
    # 1215-1242, 1320-1329): an interrupted build resumes after the
    # most expensive stage
    diff_tag = (f"_D{tcfg.resolved_diff(args.m)}"
                if tcfg.resolved_diff(args.m) != args.m else "")
    edges_path = os.path.join(
        args.dataset, edges_filename(cfg, tcfg, n)) + diff_tag + ".npz"
    if os.path.exists(edges_path) and not args.force:
        print(f"REMINDER: edges file exists, loading: {edges_path}")
        z = np.load(edges_path)
        res = EdgeFindResult(edges=z["edges"],
                             root_id=int(z["root_id"]),
                             heights=np.zeros(0, np.int32),
                             n_diffs=int(z["n_diffs"]),
                             finalists=np.zeros(0, np.int64))
    else:
        ta_tables = None
        if args.method == 3:
            from .tree.layout import mkk_tables

            ta_tables = mkk_tables(cw)
        with metrics.stage("find_edges"):
            res = find_edges_by_diff(
                codes, K=args.k,
                diff_argument=tcfg.resolved_diff(args.m),
                max_height_folds=args.height, method=args.method,
                tables=ta_tables)
        np.savez(edges_path, edges=res.edges, root_id=res.root_id,
                 n_diffs=res.n_diffs)
    print(f"found {len(res.edges)} edges, {res.n_diffs} diffs")
    with metrics.stage("layout"):
        tree = build_layout(codes, res.edges, res.root_id, K=args.k,
                            codewords=cw)
    out = os.path.join(args.dataset,
                       compressed_codes_filename(cfg, tcfg, n))
    with metrics.stage("serialize"):
        write_dtc(out, tree)
    # cache the SoA for fast query loading
    _save_soa(out + ".soa.npz", tree)
    comp_bytes = os.path.getsize(out) - 16
    print(f"compressed codes written to {out}: {comp_bytes} bytes "
          f"({comp_bytes / n:.2f} B/vec vs {args.m} plain)")


def _load_tree(args, n):
    from .tree.layout import DeltaTree

    cfg = PQConfig(M=args.m, K=args.k)
    tcfg = TreeConfig(h=args.height, method=args.method)
    path = os.path.join(args.dataset,
                        compressed_codes_filename(cfg, tcfg, n)) + ".soa.npz"
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} missing; run -task approx_tree")
    z = np.load(path)
    return DeltaTree(**{f: z[f] for f in SOA_FIELDS},
                     root_id=int(z["root_id"]), M=int(z["M"]),
                     K=int(z["K"]))


def task_query_compressed(args, metrics: Metrics):
    """deltapq -task query / query_im / batch_query over the DeltaTree."""
    from .ops.delta import build_delta_pack, query_compressed

    cw = _codewords(args)
    codes = _load_codes(args)
    tree = _load_tree(args, len(codes))
    q = _load_queries(args)
    if args.engine in ("pallas", "decoded"):
        # lossless decompression => identical distances
        from .ops.adc import query_plain
        with metrics.stage("decode"):
            decoded = tree.decode_codes()
        t0 = time.perf_counter()
        with metrics.stage("query"):
            if args.engine == "decoded":
                from .ops.decoded import DecodedEngine
                d, i = DecodedEngine(cw, decoded, device=args.device).query(
                    q, top_k=args.topk)
            else:
                d, i = query_plain(cw, q, decoded, top_k=args.topk,
                                   engine=args.engine, device=args.device)
        print(f"{(time.perf_counter()-t0) / len(q) * 1000:.4f} [msec/query]")
        if args.debug:
            print(i[0, 0], d[0, 0])
        return d, i
    if args.engine in ("auto", "fused_compressed") \
            and args.device.type == "cuda":
        # the card's path: fused delta-tile engine (in-kernel decode; the
        # level-wise traversal remains the CPU/debug path), at the JAX
        # from_tree's default precision
        from .ops.fused import FusedCompressedEngine

        with metrics.stage("pack", sync=_sync(args)):
            eng = FusedCompressedEngine.from_tree(cw, tree, precision="bf16",
                                                  device=args.device)
        t0 = time.perf_counter()
        with metrics.stage("query"):
            d, i = _query_batches(eng, q, args)
        dt = time.perf_counter() - t0
        print(f"{dt / len(q) * 1000:.4f} [msec/query] "
              f"({eng.bytes_per_vec():.2f} B/vec resident)")
        if args.debug:
            print(i[0, 0], d[0, 0])
        return d, i
    with metrics.stage("pack"):
        pack = build_delta_pack(tree)
    t0 = time.perf_counter()
    with metrics.stage("query"):
        d, i = query_compressed(pack, cw, q, top_k=args.topk,
                                device=args.device)
    dt = time.perf_counter() - t0
    print(f"{dt / len(q) * 1000:.4f} [msec/query]")
    if args.debug:
        print(i[0, 0], d[0, 0])
    return d, i


def task_approx_with_id(args, metrics: Metrics):
    """Embedded-id DeltaTree build (reference ``approx_with_id``,
    ``deltapq_approx_tree_main.cpp:186-264``); stores the SoA cache
    (the reference's 1-byte bitmap cannot address the id subspaces, so
    there is no byte-stream format for this variant)."""
    from .tree.with_id import build_tree_with_id

    cfg = PQConfig(M=args.m, K=args.k)
    cw = _codewords(args)
    codes = _load_codes(args)
    with metrics.stage("build"):
        tree = build_tree_with_id(codes, K=args.k, codewords=cw,
                                  max_height_folds=args.height,
                                  method=args.method)
    tcfg = TreeConfig(h=args.height, method=args.method)
    out = os.path.join(args.dataset,
                       compressed_codes_filename(cfg, tcfg, len(codes),
                                                 with_id=True)) + ".soa.npz"
    _save_soa(out, tree)
    print(f"embedded-id tree SoA written to {out}")


def task_diff_index(args, metrics: Metrics):
    from .tree.serialize import write_diff_index

    cfg = PQConfig(M=args.m, K=args.k)
    codes = _load_codes(args)
    out = os.path.join(args.dataset, diff_index_filename(cfg, len(codes)))
    with metrics.stage("serialize"):
        write_diff_index(out, codes)
    print(f"diff index written to {out}: {os.path.getsize(out)} bytes")


def task_recall(args, metrics: Metrics):
    from .eval.metrics import recall_at_k

    d, i = task_query(args, metrics)
    n = args.N if args.N > 0 else _load_codes(args).shape[0]
    gt_path = os.path.join(args.dataset, "groundtruth",
                           groundtruth_filename(n, 10000))
    if not os.path.exists(gt_path):
        gt_path = os.path.join(args.dataset, "groundtruth",
                               groundtruth_filename(n, args.topk))
    gt_ids, gt_d = read_groundtruth(gt_path)
    r = recall_at_k(i, gt_ids[:len(i)], k=args.topk)
    print(f"{r}")
    metrics.set("recall", r)


def task_map(args, metrics: Metrics):
    from .eval.metrics import epsilon_recall, mean_average_precision
    from .io.vecs import read_vecs_at

    d, i = task_query(args, metrics)
    n = args.N if args.N > 0 else _load_codes(args).shape[0]
    gt_ids, gt_d = read_groundtruth(
        os.path.join(args.dataset, "groundtruth",
                     groundtruth_filename(n, args.topk)))
    out = mean_average_precision(i, gt_ids[:len(i)], d, gt_d[:len(i)])
    print(f"MAP = {out['mAP']}")
    print(f"Avg ratio: {out.get('avg_ratio')}")
    print(f"Max ratio: {out.get('max_ratio')}")
    # read only the retrieved rows by seek offset (reference pattern,
    # main.cpp:901-931) instead of materializing the whole base file
    q = _load_queries(args)
    safe_i = np.maximum(i, 0)  # -1 sentinels read row 0, masked below
    rows = read_vecs_at(os.path.join(args.dataset, f"base.{args.ext}"),
                        safe_i, ext=args.ext)
    diff = rows - q[:len(i), None, :]
    td = np.sum(diff * diff, axis=2).astype(np.float32)
    td = np.where(i >= 0, td, np.inf)
    er = epsilon_recall(td, gt_d[:len(i)])
    print(f"eps recall = {er['eps_recall']}")
    print(f"recall = {er['recall_true']}")
    print(f"ratio = {er['k_app_ratio']}")
    for k, v in {**out, **er}.items():
        metrics.set(k, v)


def task_diff_scan(args, metrics: Metrics):
    """Query over the sequential diff index (reference ``diff_scan``,
    ``deltapq_approx_tree_main.cpp:428-495`` /
    ``query_processing_diff_scan_o_direct``): decode the tree-less diff
    stream losslessly (the C++ decoder of ``native/`` at K <= 256 and
    M <= 8 when the library is available, else the Python loop), then
    run the plain ADC scan -- distances are identical to pqscan by
    construction."""
    from .native import diff_index_decode_native
    from .ops.adc import query_plain
    from .tree.serialize import decode_diff_index

    cfg = PQConfig(M=args.m, K=args.k)
    cw = _codewords(args)
    codes = _load_codes(args)
    idx_path = os.path.join(args.dataset,
                            diff_index_filename(cfg, len(codes)))
    if not os.path.exists(idx_path):
        raise FileNotFoundError(f"{idx_path}; run -task diff_index first")
    with open(idx_path, "rb") as f:
        n_codes = int(np.fromfile(f, np.int64, 1)[0])
        n_bytes = int(np.fromfile(f, np.int64, 1)[0])
        stream = np.fromfile(f, np.uint8, n_bytes)
    with metrics.stage("decode"):
        # the C++ decoder takes one byte a diff and an 8-bit bitmap
        decoded = (diff_index_decode_native(stream, n_codes, args.m)
                   if args.k <= 256 and args.m <= 8 else None)
        if decoded is None:
            decoded = decode_diff_index(stream, n_codes, args.m, args.k)
    if not np.array_equal(decoded, codes[:n_codes]):
        raise RuntimeError("diff index decode mismatch")
    q = _load_queries(args)
    # the JAX query_plain scans with its gather path for any engine name
    # but pallas and auto
    engine = args.engine if args.engine in ("auto", "pallas") else "xla"
    t0 = time.perf_counter()
    with metrics.stage("query"):
        d, i = query_plain(cw, q, decoded, top_k=args.topk, engine=engine,
                           device=args.device)
    print(f"{(time.perf_counter()-t0) / len(q) * 1000:.4f} [msec/query]")
    return d, i


def task_accuracy(args, metrics: Metrics):
    """Top-1 accuracy vs groundtruth (the reference ``accuracy`` task is
    buggy -- scores a never-filled array, ``main.cpp:703-718``; this is
    the intended semantics)."""
    from .eval.metrics import top1_accuracy

    d, i = task_query(args, metrics)
    n = args.N if args.N > 0 else _load_codes(args).shape[0]
    gt_ids, _ = read_groundtruth(
        os.path.join(args.dataset, "groundtruth",
                     groundtruth_filename(n, args.topk)))
    acc = top1_accuracy(i, gt_ids[:len(i)])
    print(f"top-1 accuracy = {acc}")
    metrics.set("top1_accuracy", acc)


def task_update(args, metrics: Metrics):
    """Update-cost simulation (``update_query_processing_simulation``,
    ``deltapq_create_approx_tree.h:3646-3723``): random code updates;
    each update costs 1 bitmap byte + changed bytes + 0.25 B of marks."""
    codes = _load_codes(args)
    rng = np.random.default_rng(args.seed)
    n_updates = args.query_size if args.query_size > 0 else 10000
    idx = rng.integers(0, len(codes), n_updates)
    new_vals = rng.integers(0, args.k, (n_updates, args.m)).astype(codes.dtype)
    changed = (codes[idx] != new_vals).sum(axis=1)
    total_bytes = float(np.sum(1 + changed) + 0.25 * n_updates)
    print(f"{n_updates} updates: {total_bytes} bytes "
          f"({total_bytes / n_updates:.2f} B/update)")
    metrics.set("update_bytes", total_bytes)


TASKS = {
    "learn": task_learn,
    "encode": task_encode,
    "combine": task_combine,
    "rand_sample": task_rand_sample,
    "groundtruth": task_groundtruth,
    "query": task_query,
    "pqscan": task_query,
    "recall": task_recall,
    "mAP": task_map,
    "approx_tree": task_approx_tree,
    "approx_with_id": task_approx_with_id,
    "query_compressed": task_query_compressed,
    "query_im": task_query_compressed,
    "batch_query": task_query_compressed,
    "diff_index": task_diff_index,
    "diff_scan": task_diff_scan,
    "accuracy": task_accuracy,
    "update": task_update,
}


def main(argv=None, device=None):
    """Run one task on ``device`` (None: the card).  Without a card the
    default raises before any task runs: nothing falls back to the
    CPU."""
    args = build_parser().parse_args(argv)
    if args.task not in TASKS:
        print(f"unknown task {args.task!r}; available: {sorted(TASKS)}",
              file=sys.stderr)
        return 2
    args.device = resolve_device(device)
    torch.empty(0, device=args.device)       # raises without the device
    metrics = Metrics()
    t0 = time.perf_counter()
    TASKS[args.task](args, metrics)
    metrics.set("time_total_s", round(time.perf_counter() - t0, 3))
    for k, v in host_mem_usage().items():
        metrics.set(k, round(v, 1))
    if args.metrics_out:
        metrics.dump(args.metrics_out)
    print(json.dumps(metrics.data, sort_keys=True, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
