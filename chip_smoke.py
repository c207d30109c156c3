#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port's main path on one card.

Usage: ``python3 chip_smoke.py`` from the repository root, on a host with
one CUDA card (Hopper, sm_90a) and nvcc.  Without a card it exits
non-zero and prints no result.  It imports nothing of JAX.

Phases, each timed:

1. device: the card's name and power limit, CUDA and nvcc versions;
2. kernel build: nvcc builds ``deltapq_tpu_torch/csrc/*.cu`` afresh;
3. data and index: the sift_like workload at N = 1,048,576, D=128, M=8,
   K=256 -- PQ learn + encode on the card, DeltaTree (method 1), DFS
   order, stream tiles; prints the distinct-code count and B/vec;
4. each kernel against its plain PyTorch version on the full tiles at
   B=512: the codes echo exact, the subtile mins within
   4e-6 * (max pre + 2 max|u*cross|), the rerank bit-equal on a
   cap-rung-sized candidate set (S = 65,536); times from CUDA events;
5. engine: ``FusedCompressedEngine(precision="int16")``, warmup, then
   timed batches of 512 top-10 queries, each held to the plain exact
   scan ``adc_query_topk`` over the same table: distances bit-equal, ids
   equal up to f64-audited ties.  The launch counts of both kernels in
   this phase must be > 0.  Then one batch whose rungs are forced to 1,
   2 and 4 units, so the later rungs and the terminal exact scan run
   (the timed batches certify on the first rung); it is timed and held
   to the same checks.

Any failed check raises, so the script exits non-zero without the last
line.  Its last two lines are a JSON object of per-kernel measurements
and ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from deltapq_tpu_torch.kernels import build
from deltapq_tpu_torch.ops import fused_kernels as fk
from deltapq_tpu_torch.ops.adc import adc_query_topk, pad_codes
from deltapq_tpu_torch.ops.encode import pq_encode
from deltapq_tpu_torch.ops.fused import (FusedCompressedEngine,
                                         _pool_for, _quantized_query_stats,
                                         fused_select_esc)
from deltapq_tpu_torch.ops.kmeans import pq_learn
from deltapq_tpu_torch.ops.stream_tiles import (build_stream_tiles,
                                                decode_stream_tiles)
from deltapq_tpu_torch.synth import WORKLOADS, workload_vectors
from deltapq_tpu_torch.tree.build import find_edges_by_diff
from deltapq_tpu_torch.tree.layout import build_layout

N = 1 << 20
D, M, K = 128, 8, 256
B, TOP_K = 512, 10
N_BATCHES = 5
S_RERANK = 65536
TRAIN = 20000
REPLACES = {
    "stream_mins": "deltapq_tpu/ops/fused_pallas.py:522",
    "rerank": "deltapq_tpu/ops/fused_pallas.py:1096",
}
SOURCES = {
    "stream_mins": "deltapq_tpu_torch/csrc/stream_mins.cu",
    "rerank": "deltapq_tpu_torch/csrc/rerank.cu",
}


def log(*a):
    print(*a, flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


class Phase:
    """Prints a phase's name on entry and its wall time on exit."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        log(f"== {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"== {self.name}: {time.perf_counter() - self.t0:.2f} s")


def cuda_ms(fn, reps):
    """Mean device ms per call of ``fn`` over ``reps`` calls (warm)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs only "
              "on a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    with Phase("1 device"):
        card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0]
        log(f"card: {card}")
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"devices {torch.cuda.device_count()}")
        log(run([build.nvcc_path(), "--version"]).splitlines()[-1])
    tag = f"[{card}]"

    with Phase("2 kernel build"):
        info = build.build(force=True)
        build.library()
        log(f"nvcc {' '.join(build.NVCC_FLAGS)}: {info.seconds:.1f} s")
        for line in info.log.splitlines():
            if any(w in line for w in ("entry function", "Used", "spill")):
                log("  " + line.strip())

    with Phase("3 data and index"):
        t = time.perf_counter()
        x = workload_vectors(N, seed=0, **WORKLOADS["sift_like"])
        log(f"vectors [{N}, {D}]: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(0)
        cw = pq_learn(gen, x[:TRAIN], M=M, K=K, max_iters=40, n_init=1,
                      device=dev)
        torch.cuda.synchronize()
        log(f"pq_learn ({TRAIN} rows, 40 iters): "
            f"{time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        codes = pq_encode(cw, x).cpu().numpy()
        log(f"pq_encode: {time.perf_counter() - t:.1f} s")
        del x
        n_distinct = len(np.unique(codes, axis=0))
        t = time.perf_counter()
        res = find_edges_by_diff(codes, K=K, method=1)
        tree = build_layout(codes, res.edges, res.root_id, K=K,
                            tables="skip")
        log(f"DeltaTree + DFS: {time.perf_counter() - t:.1f} s")
        check(np.array_equal(tree.decode_codes(), codes),
              "DeltaTree decode is not lossless")
        order = tree.vec_id.astype(np.int64)
        t = time.perf_counter()
        eng = FusedCompressedEngine(cw, codes[order], row_to_db=order,
                                    precision="int16", device=dev)
        log(f"stream tiles + upload: {time.perf_counter() - t:.1f} s")
        check(np.array_equal(decode_stream_tiles(eng.tiles),
                             codes[order]), "stream tiles not lossless")
        bpv_lex = build_stream_tiles(
            codes[np.lexsort(codes.T[::-1])]).bytes_per_vec()
        log(f"distinct codes {n_distinct} of {N} (dup "
            f"{N / n_distinct:.3f}x); B/vec DFS {eng.bytes_per_vec():.4f}, "
            f"lexsort {bpv_lex:.4f}, plain {M}; tree diffs {res.n_diffs}")

    rng = np.random.default_rng(1)
    kernels = {}
    with Phase("4 kernels vs plain PyTorch"):
        q = rng.normal(size=(B, D)).astype(np.float32)
        table, qop, uq, eq, b = eng.prepare(q)
        mins, echo = eng.scan(qop, uq)
        ref_m, ref_c, pre_max, cross_max = fk.fused_stream_mins_ref(
            qop, eng.cwbd, eng.row_data, eng.vals, eng.meta, eng.n_valid,
            M, u=uq)
        check(torch.equal(echo, ref_c), "B1 echo != plain decode")
        check(np.array_equal(echo[:N].cpu().numpy(), codes[order]),
              "B1 echo != decode_stream_tiles")
        fin = torch.isfinite(ref_m)
        check(torch.equal(fin, torch.isfinite(mins)), "B1 inf pattern")
        err = float((mins[fin] - ref_m[fin]).abs().max())
        tol = 4e-6 * (pre_max + 2 * cross_max)
        log(f"B1 stream_mins: echo exact; mins max|err| {err:.6g} <= tol "
            f"{tol:.6g} (max pre {pre_max:.6g}, max|u*cross| "
            f"{cross_max:.6g})")
        check(err <= tol, "B1 mins out of tolerance")
        ms = cuda_ms(lambda: eng.scan(qop, uq), 20)
        plain_ms = cuda_ms(lambda: fk.fused_stream_mins_ref(
            qop, eng.cwbd, eng.row_data, eng.vals, eng.meta, eng.n_valid,
            M, u=uq), 2)
        log(f"{tag} B1 {ms:.4f} ms/call, plain {plain_ms:.4f} ms/call "
            f"(N={N}, B={B})")
        kernels["stream_mins"] = dict(max_abs_err=err, ms=ms,
                                      plain_ms=plain_ms)
        del ref_m, ref_c

        # cap-rung-sized candidates, gathered from the echo as the
        # epilogue gathers them
        n_sub = S_RERANK // fk.SUB
        mins_bn = fk.pool_mins_nb(mins, 1)
        sub_ids, _ = fk._select_units(mins_bn, n_sub)
        cw_units = echo.reshape(-1, fk.SUB * M)[sub_ids]
        cand = cw_units.reshape(B, S_RERANK, M).transpose(1, 2).contiguous()
        tab = table.reshape(B, M * K).contiguous()
        out = fk.rerank_table_sums(tab, cand)
        ref = fk.rerank_table_sums_ref(tab, cand)
        check(torch.equal(out, ref), "B2 rerank not bit-equal")
        log(f"B2 rerank: bit-equal on [{B}, {M}, {S_RERANK}] candidates")
        ms = cuda_ms(lambda: fk.rerank_table_sums(tab, cand), 20)
        plain_ms = cuda_ms(lambda: fk.rerank_table_sums_ref(tab, cand), 5)
        log(f"{tag} B2 {ms:.4f} ms/call, plain {plain_ms:.4f} ms/call "
            f"(B={B}, S={S_RERANK})")
        kernels["rerank"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms)
        del cand, out, ref, mins, echo

    with Phase("5 engine"):
        codes_db = torch.from_numpy(pad_codes(codes, 16384)).to(dev)
        codes_db64 = codes_db[:N].to(torch.int64)
        fk.reset_launch_counts()
        t = time.perf_counter()
        eng.warmup(batch_sizes=(B,), top_k=TOP_K)
        torch.cuda.synchronize()
        log(f"warmup (calibrate + one batch): "
            f"{time.perf_counter() - t:.2f} s, ns_hint "
            f"{getattr(eng, 'ns_hint', None)}")
        split = np.zeros(3)
        walls, fracs = [], []
        for i in range(N_BATCHES):
            q = rng.normal(size=(B, D)).astype(np.float32)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            torch.cuda.synchronize()
            t = time.perf_counter()
            ev[0].record()
            table, qop, uq, eq, b = eng.prepare(q)
            ev[1].record()
            mins, echo = eng.scan(qop, uq)
            ev[2].record()
            d, ids = eng.select(table, qop, uq, eq, mins, echo, b, TOP_K)
            ev[3].record()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            split += [ev[j].elapsed_time(ev[j + 1]) for j in range(3)]
            fracs.append(eng.last_exact_frac)
            check_batch(table[:b], codes_db, codes_db64, d, ids)
        # the user entry point once: same distances as the staged run
        dq, _ = eng.query(q, top_k=TOP_K)
        check(np.array_equal(dq, d.cpu().numpy()), "query() != stages")
        counts = fk.launch_counts()
        split /= N_BATCHES
        wall = float(np.mean(walls))
        log(f"{tag} ms/batch (B={B}, top-{TOP_K}, N={N}): "
            f"table+quantize {split[0]:.4f}, B1 scan {split[1]:.4f}, "
            f"epilogue+ladder+terminal {split[2]:.4f}; host wall "
            f"{wall * 1e3:.4f} ms -> {B / wall:.1f} QPS")
        log(f"{tag} certified first-shot fraction "
            f"{float(np.mean(fracs)):.4f} over {N_BATCHES} batches")
        log(f"{tag} kernel launches in this phase: {counts}")
        check(counts["stream_mins"] > 0 and counts["rerank"] > 0,
              "a kernel of the main path was never launched")
        log(f"all {N_BATCHES} batches: distances bit-equal to "
            f"adc_query_topk, ids equal up to audited ties")

        # the later rungs and the terminal exact scan, forced
        table, qop, uq, eq, b = eng.prepare(q)
        mins, echo = eng.scan(qop, uq)
        q2, err_r, scale2 = _quantized_query_stats(eng, qop, uq, eq)
        torch.cuda.synchronize()
        t = time.perf_counter()
        d, rows, ok, _ = fused_select_esc(
            mins, q2, table, echo, N, TOP_K, (1, 2, 4),
            _pool_for(mins.shape[0]), err_r=err_r, scale2=scale2,
            final_exact=True)
        torch.cuda.synchronize()
        forced_ms = (time.perf_counter() - t) * 1e3
        n_term = int((~ok).sum())
        check(n_term > 0, "the forced ladder never reached the terminal scan")
        ids = torch.where(rows >= 0, eng.row_to_db[rows.clamp(0, N - 1)]
                          .to(rows.dtype), rows)
        check_batch(table[:b], codes_db, codes_db64, d[:b], ids[:b])
        log(f"{tag} forced ladder (rungs 1, 2, 4 units) with the terminal "
            f"exact scan for {n_term} of {B} queries: epilogue "
            f"{forced_ms:.4f} ms (host wall); distances bit-equal to "
            f"adc_query_topk, ids equal up to audited ties")

    log(card)
    log(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=SOURCES[k], replaces=REPLACES[k],
             launches=counts[k], **v) for k, v in kernels.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def check_batch(table, codes_db, codes_db64, d, ids):
    """Engine results against the plain exact scan over the same table:
    distances bit-equal; each id carries its reported distance; id sets
    differ only at f64-audited ties of the top-k boundary."""
    dr, ir = adc_query_topk(table, codes_db, N, TOP_K, 16384)
    check(torch.equal(d, dr), "distances differ from adc_query_topk")
    Bq, Mq, _ = table.shape
    c = codes_db64[ids.clamp_min(0)]                       # [B, k, M]
    own = torch.zeros(ids.shape, dtype=torch.float32, device=ids.device)
    bi = torch.arange(Bq, device=ids.device)[:, None]
    for m in range(Mq):
        own = own + table[bi, m, c[:, :, m]]
    check(torch.equal(own, d), "an id does not carry its distance")
    same = torch.sort(ids, 1).values == torch.sort(ir, 1).values
    t64 = table.to(torch.float64)
    for b in torch.nonzero(~same.all(1)).flatten().tolist():
        d64 = t64[b][torch.arange(Mq, device=t64.device)[None, :],
                     codes_db64].sum(1)
        srt = torch.sort(d64).values
        gap = float((srt[TOP_K] - srt[TOP_K - 1]) / srt[TOP_K - 1].abs())
        check(gap < 1e-5, f"query {b}: id sets differ without a tie "
                          f"(f64 gap {gap:.3g})")


if __name__ == "__main__":
    sys.exit(main())
