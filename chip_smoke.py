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
   cap-rung-sized candidate set (S = 65,536); times from CUDA events; B1
   also at B=64 on the same tiles (one query block: a block's fixed work
   is all there is to hide), its mins equal to the first 64 columns;
5. engine: ``FusedCompressedEngine(precision="int16")``, warmup, then
   timed batches of 512 top-10 queries, each held to the plain exact
   scan ``adc_query_topk`` over the same table: distances bit-equal, ids
   equal up to f64-audited ties.  The launch counts of both kernels in
   this phase must be > 0.  Then one batch whose rungs are forced to 1,
   2 and 4 units, so the later rungs and the terminal exact scan run
   (the timed batches certify on the first rung); it is timed and held
   to the same checks;
6. kernels of the index tiers, on the same data at B=512: the bf16 mode
   of the stream kernel on the stream tiles, the codes kernel (bf16 and
   int16) on the scan-ordered codes, the decoded kernel on the bf16
   decoded tiles (8192 rows a tile) and the ADC top-k kernel B6 in its
   three modes (top-10, 4096-row tiles; the merged f32 distances
   bit-equal to ``adc_query_topk``; each mode beside its bound and the
   shared-memory floor of its N B M lookups), each against its plain
   version (bf16 scans within
   2e-5 * (max pre + 2 sqrt(max pre) max ||q||), int16 within 4e-6 *
   (max pre + 2 max|u*cross|), echoes exact, ADC top-k bit-equal) and
   timed with CUDA events beside the plain version, the bound and B1's
   time in the same mode on the same rows (phases 4 and 6); B1's int16
   mins equal B3's bit for bit (both on ``mma.sync``, B3 without the
   decode); B4 beside one ``torch.mm`` of the same operands
   (``library_ms``: the cross product alone);
7. index: ``DeltaPQIndex`` over phase 3's codewords and codes (no second
   learn), five timed B=512 top-10 batches each for ``auto`` (->
   ``fused_compressed`` at bf16), ``fused``, ``fused_codes`` and
   ``pallas``, plus the codes tier at int16 through
   ``FusedCodesEngine``; ``stats()``; a save/load round trip; a
   dup_heavy index whose ``auto`` resolves to ``fused_dedup``.  Every
   batch is held to ``adc_query_topk`` as in phase 5.  The launch counts
   are set to 0 before each path and read after it: each path must have
   launched its own scan kernel, and every fused tier the rerank kernel;
8. int8 and slot-tile kernels on phase 3's codes at B=512: B1 and B3 in
   int8 mode against their plain versions (mins bit-equal, echo exact)
   and against each other (bit for bit),
   B5 on the slot tiles of the same DFS order at int8 (bit-equal), int16
   and bf16 (within the bounds of phases 4 and 6), its echo equal to the
   codes, its mins equal to B1's on the same rows bit for bit at int8 and
   int16; each timed beside its plain version, its bound and B1's time in
   the same mode; the slot tiles' S, Cap and B/vec; then the int8 codes
   tier through ``FusedCodesEngine``;
9. slot-tile engine: ``FusedCompressedEngine(fmt="slots")`` at int16 and
   int8, warmup then five timed B=512 top-10 batches each, and two at
   bf16, every batch held to ``adc_query_topk``; a ``save`` ->
   ``convert.load_jax_engine`` round trip of a slot file with ``fmt`` and
   with the key removed, both answering as the engine does;
10. big N at int8: 8,388,608 sift_like vectors made and encoded chunk by
   chunk (chunk c from seed c, so chunk 0 is phase 3's data; phase 3's
   codewords, no second learn) by ``encode_stream``;
   ``BigCompressedIndex(n_parts=8, precision="int8", chunk_rows=
   2,097,152)`` -> four resident chunks; warmup, five timed B=128 top-10
   batches held to ``adc_query_topk`` over all 8,388,608 codes; ``save``
   -> ``from_saved(mmap=True, resident=False)``, two checked batches with
   the per-batch upload time; ``DedupCompressedEngine`` at its default
   (int8) over phase 3's codes, two checked batches.

11. the plain-scan kernel family against its plain versions, timed with
   CUDA events, on the engine benchmark's workload
   (``bench_engines.workload``) at N = 1,048,576, B=512, top-10: the
   distance matrix B8 (bit-equal, compared in row chunks; its library
   yardstick ``embedding_bag``), B6 at f32, bf16 and bf16x2 (each
   beside its bound and the shared-memory floor of its N B M lookups, as
   in phase 6), B9 at f32, bf16
   and bf16x2 (tile 4096), and B10 (tile 2048) on phase 7's dup_heavy
   codes in DeltaTree-DFS order, where the dictionary fits (its width is
   printed).  Every one bit-equal to its plain version;
12. the plain-scan engines at B=128 and B=512: the gather scan, the
   distance matrix with ``smallest_k``, argmin at f32 / bf16 / bf16x2,
   packed at f32 / bf16 / bf16x2 and the decoded engine at bf16x2 with
   and without rerank and at bf16 on the benchmark's workload, and
   ``TileDictEngine`` on the dup_heavy codes: ms/batch, QPS, launches of
   the engine's own kernel, and against the exact scan: the exact
   engines bit-equal (the packed keys' truncated 12 bits audited in
   f64), the rounded ones by recall@10; ``DecodedEngine`` save and load
   on the card and its peak device memory.

13. the pipelined stream kernel B7 on phase 3's tiles at B=512, int8 and
   bf16: codes equal to B1's, mins equal bit for bit at int8 and within
   the bound of phase 6 at bf16 (B7 sums on the CUDA cores, B1 on the
   tensor cores), and held to the plain
   version (int8 bit-equal, bf16 within the bound of phase 6), timed in
   turns with B1 (B1, B7, B7, B1); then ``FusedCompressedEngine(
   pipelined=True)`` at int8 and bf16, warmup and five timed batches each,
   every batch held to ``adc_query_topk``; on that path the pipelined
   kernel's launch count must be > 0 and the serial stream kernel's 0;
14. the GIST shape at full width (M=16, K=256, Ds=60, D=960, top-100,
   B=500, which the engines pad to 512): ``synth.make_gist_workload`` at
   N = 1,000,000, the M=16 DeltaTree, its DFS order, B/vec (DFS, lexsort,
   plain 16); B1, B3 and B5 in their three modes and B4 against their
   plain versions (codes exact, int8 bit-equal, int16 and bf16 within the
   bounds of phases 4 and 6), timed, B4 beside its ``torch.mm`` yardstick;
   B1, B3 and B5 all run the gathered ``wgmma`` tail there (B1 and B5
   with their own decodes), and B3 and B5 are held to B1 on the same rows
   bit for bit at int8 and int16; then B3 and B1 again on the
   near-distinct code set below (lexsort order), timed, B3 against its
   plain version and bit for bit against B1;
   every one of those engines then
   answers the benchmark's batch through ``query`` and is verified as
   ``bench_gist.verify`` does (distances allclose to ``adc_query_topk``,
   ids up to f64-audited ties, 0 real divergences), and the decoded,
   codes, stream (bf16, int16, int8) and slot (bf16) engines are timed;
   ``DeltaPQIndex(engine="auto")`` over these codes (whatever it resolves
   to) and over a second, near-distinct GIST-shape code set of 250,000
   rows, where it must resolve to ``fused_compressed`` and run.  The
   kernels of this phase are listed as ``<name>@gist``.

Every kernel's entry in the ``kernels`` line carries ``bound_ms``: the
least time the card could take for the same work, the larger of the
bytes it must move (each input read once, each output written once) over
3.35 TB/s and its operations over the published peak of their type (67
TFLOP/s f32 outside the tensor cores, 989 bf16, 1,979 TOP/s int8).

Any failed check raises, so the script exits non-zero without the last
line.  Its last two lines are a JSON object of per-kernel measurements
and ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from deltapq_tpu_torch import bench_engines, bench_gist, bench_stream
from deltapq_tpu_torch.bigscale import (BigCompressedIndex,
                                        ChunkedCompressedEngine,
                                        encode_stream)
from deltapq_tpu_torch.convert import (load_jax_decoded_engine,
                                       load_jax_engine)
from deltapq_tpu_torch.eval.metrics import recall_at_k
from deltapq_tpu_torch.index import DeltaPQIndex
from deltapq_tpu_torch.kernels import build
from deltapq_tpu_torch.ops import adc_kernels as ak
from deltapq_tpu_torch.ops import fused_kernels as fk
from deltapq_tpu_torch.ops.adc import adc_query_topk, adc_table, pad_codes
from deltapq_tpu_torch.ops import decoded as pdecoded
from deltapq_tpu_torch.ops.decoded import DecodedEngine
from deltapq_tpu_torch.ops.encode import pq_encode
from deltapq_tpu_torch.ops.delta_tiles import (build_delta_tiles,
                                               decode_delta_tiles)
from deltapq_tpu_torch.ops.fused import (DedupCompressedEngine,
                                         FusedCodesEngine,
                                         FusedCompressedEngine,
                                         FusedDecodedEngine, _pool_for,
                                         fused_select_esc)
from deltapq_tpu_torch.ops.kmeans import pq_learn
from deltapq_tpu_torch.ops.stream_tiles import (build_stream_tiles,
                                                decode_stream_tiles)
from deltapq_tpu_torch.synth import (WORKLOADS, gist_vectors,
                                     make_gist_workload, workload_vectors)
from deltapq_tpu_torch.tree.build import find_edges_by_diff
from deltapq_tpu_torch.tree.layout import build_layout

N = 1 << 20
D, M, K = 128, 8, 256
B, TOP_K = 512, 10
B_SMALL = 64           # phase 4: one query block of B1
N_BATCHES = 5
S_RERANK = 65536
TRAIN = 20000
ADC_TILE = ak.TILE_N   # query_plain's tile for the ADC top-k kernel
DECODED_TILE = 8192    # FusedDecodedEngine's tile
BIG_CHUNKS = 8         # phase 10: N = 8 * 1,048,576
BIG_CHUNK_ROWS = 2 * N
BIG_B = 128            # BigCompressedIndex.batch_b
REPLACES = {
    "stream_mins": "deltapq_tpu/ops/fused_pallas.py:522",
    "rerank": "deltapq_tpu/ops/fused_pallas.py:1096",
    "stream_mins_bf16": "deltapq_tpu/ops/fused_pallas.py:522",
    "codes_mins": "deltapq_tpu/ops/fused_pallas.py:428",
    "codes_mins_int16": "deltapq_tpu/ops/fused_pallas.py:428",
    "decoded_mins": "deltapq_tpu/ops/fused_pallas.py:131",
    "adc_topk": "deltapq_tpu/ops/adc_pallas.py:104",
    "stream_mins_int8": "deltapq_tpu/ops/fused_pallas.py:522",
    "codes_mins_int8": "deltapq_tpu/ops/fused_pallas.py:428",
    "delta_mins": "deltapq_tpu/ops/fused_pallas.py:446",
    "delta_mins_int8": "deltapq_tpu/ops/fused_pallas.py:446",
    "delta_mins_bf16": "deltapq_tpu/ops/fused_pallas.py:446",
    "adc_dists": "deltapq_tpu/ops/adc_pallas.py:35",
    "adc_topk_bf16": "deltapq_tpu/ops/adc_pallas.py:104",
    "adc_topk_bf16x2": "deltapq_tpu/ops/adc_pallas.py:104",
    "adc_topk_packed": "deltapq_tpu/ops/adc_pallas.py:144",
    "adc_topk_packed_bf16": "deltapq_tpu/ops/adc_pallas.py:144",
    "adc_topk_packed_bf16x2": "deltapq_tpu/ops/adc_pallas.py:144",
    "adc_topk_tiledict": "deltapq_tpu/ops/adc_pallas.py:382",
    "stream_mins_pipelined_int8": "deltapq_tpu/ops/fused_pallas.py:663",
    "stream_mins_pipelined_bf16": "deltapq_tpu/ops/fused_pallas.py:663",
}
SOURCES = {
    "stream_mins": "deltapq_tpu_torch/csrc/stream_mins.cu",
    "rerank": "deltapq_tpu_torch/csrc/rerank.cu",
    "stream_mins_bf16": "deltapq_tpu_torch/csrc/stream_mins.cu",
    "codes_mins": "deltapq_tpu_torch/csrc/codes_mins.cu",
    "codes_mins_int16": "deltapq_tpu_torch/csrc/codes_mins.cu",
    "decoded_mins": "deltapq_tpu_torch/csrc/decoded_mins.cu",
    "adc_topk": "deltapq_tpu_torch/csrc/adc_topk.cu",
    "stream_mins_int8": "deltapq_tpu_torch/csrc/stream_mins.cu",
    "codes_mins_int8": "deltapq_tpu_torch/csrc/codes_mins.cu",
    "delta_mins": "deltapq_tpu_torch/csrc/delta_mins.cu",
    "delta_mins_int8": "deltapq_tpu_torch/csrc/delta_mins.cu",
    "delta_mins_bf16": "deltapq_tpu_torch/csrc/delta_mins.cu",
    "adc_dists": "deltapq_tpu_torch/csrc/adc_dists.cu",
    "adc_topk_bf16": "deltapq_tpu_torch/csrc/adc_topk.cu",
    "adc_topk_bf16x2": "deltapq_tpu_torch/csrc/adc_topk.cu",
    "adc_topk_packed": "deltapq_tpu_torch/csrc/adc_topk_packed.cu",
    "adc_topk_packed_bf16": "deltapq_tpu_torch/csrc/adc_topk_packed.cu",
    "adc_topk_packed_bf16x2": "deltapq_tpu_torch/csrc/adc_topk_packed.cu",
    "adc_topk_tiledict": "deltapq_tpu_torch/csrc/adc_topk_tiledict.cu",
    "stream_mins_pipelined_int8":
        "deltapq_tpu_torch/csrc/stream_mins_pipelined.cu",
    "stream_mins_pipelined_bf16":
        "deltapq_tpu_torch/csrc/stream_mins_pipelined.cu",
}
#: published peaks of one H100 SXM at its full power limit (NVIDIA's data
#: sheet): device memory bytes/s; operations/s by type
HBM_BPS = 3.35e12
PEAK_OPS = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
#: shared memory serves 32 four-byte words a clock on each SM; the H100
#: SXM's boost clock (data sheet)
SMEM_WORDS_PER_CLOCK = 32
SM_CLOCK_HZ = 1.98e9
PACKED_TILE = 4096     # adc_topk_packed's tile
DICT_TILE = 2048       # adc_topk_tiledict's and TileDictEngine's tile
ENGINE_BS = (128, 512)
GIST_N = 1_000_000     # phase 14: rows of the GIST-shape workload
GIST_B = 500           # its batch (the engines pad it to 512)
GIST_IDX_N = 250_000   # rows of the near-distinct code set for the index


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


cuda_ms = bench_engines.cuda_ms   # mean device ms per warm call


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def bound(n_bytes, ops, kind):
    """The least ms the card could take: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = n_bytes / HBM_BPS * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


def scan_bound(mode, mins, b, d, inputs, outputs):
    """Bound of a scan kernel: its products are matrix products, 2 N B D
    operations (int16: four int8 digit products), at the tensor cores'
    rate for their type."""
    ops = 2 * mins.shape[0] * fk.SUB * b * d * (4 if mode == "int16" else 1)
    return bound(nbytes(*inputs, *outputs), ops,
                 "bf16" if mode == "bf16" else "int8")


def engine_operands(e, qop, uq):
    """The tensors a scan kernel of engine ``e`` reads."""
    return [qop, uq] + [getattr(e, name, None) for name in (
        "cwbd", "row_data", "vals", "meta", "ovf", "codes", "xt")]


def lookup_bound(table, inputs, outputs, n_rows, adds_per_m=1):
    """Bound of an ADC lookup kernel: N B M f32 additions (twice that at
    bf16x2) outside the tensor cores."""
    b, m, _ = table.shape
    return bound(nbytes(table, *inputs, *outputs),
                 n_rows * b * m * adds_per_m, "f32")


def lookup_floor_ms(table, n_rows):
    """The shared-memory floor of an ADC lookup kernel: N B M table
    lookups at 32 words a clock on each SM, at the H100's boost clock."""
    b, m, _ = table.shape
    sms = torch.cuda.get_device_properties(table.device).multi_processor_count
    return n_rows * b * m / (SMEM_WORDS_PER_CLOCK * sms * SM_CLOCK_HZ) * 1e3


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
        cw = pq_learn(gen, x[:TRAIN], M=M, K=K, max_iters=40, n_init=1)
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
                                    precision="int16")
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
        table, qop, uq, cert, b = eng.prepare(q)
        mins, echo = eng.scan(qop, uq)
        ref_m, ref_c, pre_max, cross_max = fk.fused_stream_mins_ref(
            qop, eng.cwbd, eng.row_data, eng.vals, eng.meta, eng.n_valid,
            M, u=uq, mode="int16")
        check(torch.equal(echo, ref_c), "B1 echo != plain decode")
        check(np.array_equal(echo[:N].cpu().numpy(), codes[order]),
              "B1 echo != decode_stream_tiles")
        log(f"B1 stream_mins: echo exact (max pre {pre_max:.6g}, "
            f"max|u*cross| {cross_max:.6g})")
        err = mins_err(mins, ref_m, int16_tol(pre_max, cross_max),
                       "B1 stream_mins")
        ms = cuda_ms(lambda: eng.scan(qop, uq), 20)
        plain_ms = cuda_ms(lambda: fk.fused_stream_mins_ref(
            qop, eng.cwbd, eng.row_data, eng.vals, eng.meta, eng.n_valid,
            M, u=uq, mode="int16"), 2)
        log(f"{tag} B1 {ms:.4f} ms/call, plain {plain_ms:.4f} ms/call "
            f"(N={N}, B={B})")
        # one query block a tile: a block's fixed work (codebook load,
        # decode) is all that 64 queries leave to hide
        q64 = qop[:, :B_SMALL].contiguous()
        u64 = uq[..., :B_SMALL].contiguous()

        def scan64():
            return fk.fused_stream_mins(
                q64, eng.cwbd, eng.row_data, eng.vals, eng.meta, eng.n_valid,
                M, u=u64, compact=eng.compact, mode="int16")

        check(torch.equal(scan64()[0], mins[:, :B_SMALL]),
              "B1 at B=64 != the first 64 columns at B=512")
        ms64 = cuda_ms(scan64, 20)
        log(f"{tag} B1 at B={B_SMALL} on the same tiles {ms64:.4f} ms/call "
            f"(x{B // B_SMALL} = {ms64 * (B // B_SMALL):.4f} against "
            f"{ms:.4f} at B={B}); mins equal to the first {B_SMALL} columns "
            f"at B={B}")
        kernels["stream_mins"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            **scan_bound("int16", mins, B, D, engine_operands(eng, qop, uq),
                         (mins, echo)))
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
        kernels["rerank"] = dict(
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
            **bound(nbytes(tab, cand, out), B * S_RERANK * M, "f32"))
        del cand, out, ref, mins, echo

    with Phase("5 engine"):
        codes_db = torch.from_numpy(pad_codes(codes, 16384)).to(dev)
        codes_db64 = codes_db[:N].to(torch.int64)
        build.reset_launch_counts()
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
            table, qop, uq, cert, b = eng.prepare(q)
            ev[1].record()
            mins, echo = eng.scan(qop, uq)
            ev[2].record()
            d, ids = eng.select(table, cert, mins, echo, b, TOP_K)
            ev[3].record()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            split += [ev[j].elapsed_time(ev[j + 1]) for j in range(3)]
            fracs.append(eng.last_exact_frac)
            check_batch(table[:b], codes_db, codes_db64, d, ids)
        # the user entry point once: same distances as the staged run
        dq, _ = eng.query(q, top_k=TOP_K)
        check(np.array_equal(dq, d.cpu().numpy()), "query() != stages")
        counts = build.launch_counts()
        launches = {k: counts[k] for k in ("stream_mins", "rerank")}
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
        table, qop, uq, (q2, err_r, scale2), b = eng.prepare(q)
        mins, echo = eng.scan(qop, uq)
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

    phase6_tier_kernels(dev, tag, cw, codes, order, eng, rng, kernels)
    # stream_mins and rerank keep their counts from phase 5's path
    counts7, dup = phase7_index(dev, tag, cw, codes, codes_db, codes_db64,
                                rng)
    launches.update(counts7)
    dt = phase8_int8_and_slot_kernels(dev, tag, cw, codes, order, eng, rng,
                                      kernels, codes_db, codes_db64,
                                      launches)
    phase13_pipelined(dev, tag, cw, order, eng, rng, kernels, codes_db,
                      codes_db64, launches)
    del eng
    phase9_slot_engine(dev, tag, cw, order, dt, rng, codes_db, codes_db64,
                       launches)
    phase10_big_n(dev, tag, cw, codes, rng, launches)
    del codes_db, codes_db64
    tde = phase11_adc_family_kernels(dev, tag, rng, kernels, dup)
    phase12_plain_scan_engines(dev, tag, rng, dup, tde, launches)
    del tde, dup
    phase14_gist(dev, tag, kernels, launches)
    for k in kernels:
        check(launches.get(k, 0) > 0, f"kernel {k} was never launched on "
                                      f"its path")

    log(card)
    log(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=SOURCES[k.split("@")[0]],
             replaces=REPLACES[k.split("@")[0]], launches=launches[k], **v)
        for k, v in kernels.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def mins_against_b1(mins, b1, prec, what):
    """B3's or B5's mins against B1's on the same rows: bit for bit at
    int8 and int16 (integer products are exact in any order), else the
    largest difference, printed."""
    if prec != "bf16":
        check(torch.equal(mins, b1), f"{what}: mins != B1's on the same rows")
        return "mins = B1's bit for bit"
    fin = torch.isfinite(b1)
    return f"max |mins - B1's| {float((mins[fin] - b1[fin]).abs().max()):.6g}"


def mins_err(mins, ref, tol, what):
    """Largest |kernel - plain| over the finite subtile minima; fails
    unless the +inf pattern is equal and the error within ``tol``."""
    fin = torch.isfinite(ref)
    check(torch.equal(fin, torch.isfinite(mins)), f"{what}: inf pattern")
    err = float((mins[fin] - ref[fin]).abs().max())
    log(f"{what}: mins max|err| {err:.6g} <= tol {tol:.6g}")
    check(err <= tol, f"{what}: mins out of tolerance")
    return err


def int16_tol(pre_max, cross_max):
    """The int16 digit products are int32-exact; the kernel sums pre
    exactly and rounds once, the plain version sums it in f32."""
    return 4e-6 * (pre_max + 2 * cross_max)


def bf16_tol(pre_max, cross_max):
    """Two f32 sums of the same exact bf16 products in two orders: each
    is off by at most (D-1) 2^-24 sum |terms| (< 7.6e-6 of it at D=128),
    and sum |x^ q| <= cross_max = sqrt(max pre) max ||q||."""
    return 2e-5 * (pre_max + 2 * cross_max)


def phase6_tier_kernels(dev, tag, cw, codes, order, eng, rng, kernels):
    """Each kernel of the index tiers against its plain version at the
    shapes the index gives it, timed beside it."""
    with Phase("6 kernels of the index tiers"):
        q = rng.normal(size=(B, D)).astype(np.float32)

        e = FusedCompressedEngine.from_tiles(cw, eng.tiles, row_to_db=order,
                                             precision="bf16")
        table, qop, uq, cert, b = e.prepare(q)
        mins, echo = e.scan(qop, uq)
        args = (qop, e.cwbd, e.row_data, e.vals, e.meta, e.n_valid, M)
        ref_m, ref_c, pre_max, cross_max = fk.fused_stream_mins_ref(
            *args, mode="bf16")
        check(torch.equal(echo, ref_c), "B1 bf16 echo != plain decode")
        err = mins_err(mins, ref_m, bf16_tol(pre_max, cross_max),
                       "B1 stream_mins bf16")
        ms = cuda_ms(lambda: e.scan(qop, uq), 20)
        plain_ms = cuda_ms(lambda: fk.fused_stream_mins_ref(
            *args, mode="bf16"), 2)
        log(f"{tag} B1 bf16 {ms:.4f} ms/call, plain {plain_ms:.4f} ms/call "
            f"(N={N}, B={B})")
        kernels["stream_mins_bf16"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            **scan_bound("bf16", mins, B, D, engine_operands(e, qop, uq),
                         (mins, echo)))
        del e, mins, echo, ref_m, ref_c

        for prec, name in (("bf16", "codes_mins"),
                           ("int16", "codes_mins_int16")):
            e = FusedCodesEngine(cw, codes, order=order, precision=prec)
            table, qop, uq, cert, b = e.prepare(q)
            mins, echo = e.scan(qop, uq)
            args = (qop, e.cwbd, e.codes, e.n_valid)
            ref_m, _, pre_max, cross_max = fk.fused_codes_mins_ref(
                *args, u=uq, mode=prec)
            tol = (bf16_tol if prec == "bf16" else int16_tol)(pre_max,
                                                              cross_max)
            err = mins_err(mins, ref_m, tol, f"B3 codes_mins {prec}")
            if prec == "int16":
                # the integer products are exact in any order
                check(torch.equal(eng.scan(qop, uq)[0], mins),
                      "B1 int16 mins != B3's on the same rows")
                log("B1 int16 = B3 int16 bit for bit on the same rows")
            ms = cuda_ms(lambda: e.scan(qop, uq), 20)
            plain_ms = cuda_ms(lambda: fk.fused_codes_mins_ref(
                *args, u=uq, mode=prec), 2)
            kernels[name] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                **scan_bound(prec, mins, B, D, engine_operands(e, qop, uq),
                             (mins,)))
            b1 = kernels[fk._launch_name("stream_mins", prec)]["ms"]
            log(f"{tag} B3 {prec} {ms:.4f} ms/call, plain {plain_ms:.4f} "
                f"ms/call, bound {kernels[name]['bound_ms']:.4f} ms, B1 on "
                f"the same rows {b1:.4f} ms (N={N}, B={B})")
            del e, mins, echo, ref_m

        t = time.perf_counter()
        e = FusedDecodedEngine(cw, codes[order], tile=DECODED_TILE)
        log(f"decoded cache [{N}, {D}] bf16 + upload: "
            f"{time.perf_counter() - t:.1f} s")
        table, qop, uq, cert, b = e.prepare(q)
        mins, _ = e.scan(qop, uq)
        ref_m, pre_max, cross_max = fk.fused_decoded_mins_ref(qop, e.xt, N)
        err = mins_err(mins, ref_m, bf16_tol(pre_max, cross_max),
                       "B4 decoded_mins")
        ms = cuda_ms(lambda: e.scan(qop, uq), 20)
        plain_ms = cuda_ms(lambda: fk.fused_decoded_mins_ref(qop, e.xt, N),
                           2)
        library_ms = cuda_ms(lambda: bench_stream.mm_yardstick(e.xt, qop),
                             20)
        log(f"{tag} B4 {ms:.4f} ms/call, plain {plain_ms:.4f} ms/call, "
            f"library {library_ms:.4f} ms/call (one torch.mm: the cross "
            f"product alone, no norms, no minima) (N={N}, B={B}, tile "
            f"{DECODED_TILE})")
        kernels["decoded_mins"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            **{**scan_bound("bf16", mins, B, D, (qop, e.xt), (mins,)),
               "library_ms": library_ms})
        del e, mins, ref_m

        codes_p = torch.from_numpy(pad_codes(codes, ADC_TILE)).to(dev)
        tab = adc_table(cw, torch.from_numpy(q).to(dev))
        dm, _ = ak.adc_topk_pallas(tab, codes_p, N, TOP_K, ADC_TILE,
                                   "f32")
        dr, _ = adc_query_topk(tab, codes_p, N, TOP_K, ADC_TILE)
        check(torch.equal(dm, dr), "B6 merged top-k != adc_query_topk")
        log("B6 adc_topk: merged distances bit-equal to adc_query_topk")
        # the index's pallas tier runs f32; the bf16 modes' entries come
        # from phase 11
        b6_modes(tag, "index tier codes", tab, codes_p, kernels, ("f32",))


def search_batches(index, label, tag, cw, codes_db, codes_db64, rng, n,
                   kernels=()):
    """One untimed search (it builds the engine), then N_BATCHES timed
    B=512 top-10 searches, each held to the plain exact scan over the
    table the engine built (the checks launch no kernel).  The launch
    counts are set to 0 just before the first search and read after the
    last; each kernel in ``kernels`` must have been launched.  Returns
    this path's launch counts."""
    q = rng.normal(size=(B, D)).astype(np.float32)
    build.reset_launch_counts()
    t = time.perf_counter()
    index.search(q, TOP_K)
    first = time.perf_counter() - t
    walls, fracs = [], []
    for _ in range(N_BATCHES):
        q = rng.normal(size=(B, D)).astype(np.float32)
        torch.cuda.synchronize()
        t = time.perf_counter()
        d, ids = index.search(q, TOP_K)
        walls.append(time.perf_counter() - t)
        eng = index._fused_engine
        if hasattr(eng, "prepare"):
            table = eng.prepare(q)[0][:B]
            fracs.append(eng.last_exact_frac)
        else:
            table = adc_table(cw, torch.from_numpy(q).to(cw.device))
        check_batch(table, codes_db, codes_db64, torch.from_numpy(d).to(
            cw.device), torch.from_numpy(ids).to(cw.device), n)
    counts = build.launch_counts()
    wall = float(np.mean(walls))
    resolved = index._engine_resolved or index.engine
    frac = (f", certified first-shot {float(np.mean(fracs)):.4f}"
            if fracs else "")
    log(f"{tag} index {label} (-> {resolved}): first search {first:.2f} s; "
        f"{N_BATCHES} batches of B={B}, top-{TOP_K}: host wall "
        f"{wall * 1e3:.4f} ms/batch -> {B / wall:.1f} QPS{frac}; distances "
        f"bit-equal to adc_query_topk, ids equal up to audited ties")
    log(f"  launches on the {label} path: "
        f"{({k: v for k, v in counts.items() if v})}")
    for k in kernels:
        check(counts[k] > 0, f"kernel {k} never launched on the index's "
                             f"{label} path")
    return counts


def phase7_index(dev, tag, cw, codes, codes_db, codes_db64, rng):
    """The index API on the card; returns, for each kernel of the index
    tiers, its launch count on its own path."""
    launches = {}
    with Phase("7 index"):
        t = time.perf_counter()
        idx = DeltaPQIndex(cw, codes)
        log(f"DeltaPQIndex(cw, codes): tree, table-driven layout, DTC "
            f"stream: {time.perf_counter() - t:.1f} s")
        counts = search_batches(idx, "auto", tag, cw, codes_db, codes_db64,
                                rng, N, ("stream_mins_bf16", "rerank"))
        check(idx._engine_resolved == "fused_compressed"
              and idx._fused_engine.precision == "bf16",
              "auto did not resolve to fused_compressed at bf16")
        launches["stream_mins_bf16"] = counts["stream_mins_bf16"]
        for name, own in (("fused", ("decoded_mins", "rerank")),
                          ("fused_codes", ("codes_mins", "rerank")),
                          ("pallas", ("adc_topk",))):
            other = DeltaPQIndex(cw, codes, engine=name, build_tree=False)
            counts = search_batches(other, name, tag, cw, codes_db,
                                    codes_db64, rng, N, own)
            launches[own[0]] = counts[own[0]]
            del other

        # the codes tier at int16, through the engine's own entry point
        ce = FusedCodesEngine(cw, codes, precision="int16")
        build.reset_launch_counts()
        for _ in range(2):
            q = rng.normal(size=(B, D)).astype(np.float32)
            d, ids = ce.query(q, top_k=TOP_K)
            check_batch(ce.prepare(q)[0][:B], codes_db, codes_db64,
                        torch.from_numpy(d).to(dev),
                        torch.from_numpy(ids).to(dev))
        counts = build.launch_counts()
        for k in ("codes_mins_int16", "rerank"):
            check(counts[k] > 0, f"kernel {k} never launched by "
                                 f"FusedCodesEngine(precision='int16')")
        launches["codes_mins_int16"] = counts["codes_mins_int16"]
        log(f"FusedCodesEngine(precision='int16'): 2 batches exact; "
            f"launches {({k: v for k, v in counts.items() if v})}")
        del ce

        st = idx.stats()
        log(f"stats(): {st}")
        check("bytes_per_vec" in st, "stats() has no bytes_per_vec")
        with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as path:
            t = time.perf_counter()
            idx.save(path)
            back = DeltaPQIndex.load(path)
            log(f"save + load: {time.perf_counter() - t:.1f} s")
        check(np.array_equal(back.tree.vec_id, idx.tree.vec_id)
              and back._stream == idx._stream, "loaded tree differs")
        q = rng.normal(size=(B, D)).astype(np.float32)
        d0, i0 = idx.search(q, TOP_K)
        d1, i1 = back.search(q, TOP_K)
        check(np.array_equal(d0, d1) and np.array_equal(i0, i1),
              "the loaded index answers differently")
        log("save/load round trip: same tree, same stream, same results")
        del idx, back

        t = time.perf_counter()
        x = workload_vectors(N, seed=0, **WORKLOADS["dup_heavy"])
        gen = torch.Generator(device=dev).manual_seed(0)
        cw_d = pq_learn(gen, x[:TRAIN], M=M, K=K, max_iters=40, n_init=1)
        codes_d = pq_encode(cw_d, x).cpu().numpy()
        del x
        idx_d = DeltaPQIndex(cw_d, codes_d)
        n_distinct = len(np.unique(codes_d, axis=0))
        log(f"dup_heavy index at N={N}: {n_distinct} distinct codes (dup "
            f"{N / n_distinct:.2f}x), learn + encode + index "
            f"{time.perf_counter() - t:.1f} s")
        cdb = torch.from_numpy(pad_codes(codes_d, 16384)).to(dev)
        search_batches(idx_d, "dup_heavy auto", tag, cw_d, cdb,
                       cdb[:N].to(torch.int64), rng, N)
        check(idx_d._engine_resolved == "fused_dedup",
              "dup_heavy auto did not resolve to fused_dedup")
        dup = dict(cw=cw_d.cpu().numpy(), codes=codes_d,
                   order=idx_d.tree.vec_id.astype(np.int64))
    return launches, dup


def scan_vs_plain(tag, label, e, q, plain, kernels, key, tol=None, reps=20,
                  library=None):
    """One engine's scan kernel against its plain version on the same
    operands: echo exact, mins bit-equal (``tol`` None) or within
    ``tol(pre_max, cross_max)``; both timed with CUDA events.  ``plain``
    maps (qop, uq) to the plain version's (mins, echo, pre_max,
    cross_max).  The bound counts the kernel's own batch (``q`` padded as
    the engine pads it).  ``library`` maps (qop, uq) to one PyTorch call
    timed as the kernel's yardstick.  Returns the kernel's (mins,
    echo)."""
    table, qop, uq, cert, b = e.prepare(q)
    mins, echo = e.scan(qop, uq)
    ref_m, ref_c, pre_max, cross_max = plain(qop, uq)
    check(torch.equal(echo, ref_c), f"{label} echo != plain")
    if tol is None:
        check(torch.equal(mins, ref_m), f"{label} mins not bit-equal")
        err = 0.0
        log(f"{label}: mins bit-equal to the plain version, echo exact")
    else:
        err = mins_err(mins, ref_m, tol(pre_max, cross_max), label)
    ms = cuda_ms(lambda: e.scan(qop, uq), reps)
    plain_ms = cuda_ms(lambda: plain(qop, uq), 2)
    bnd = scan_bound(getattr(e, "precision", "bf16"), mins, qop.shape[1],
                     e.D, engine_operands(e, qop, uq), (mins, echo))
    lib = ""
    if library is not None:
        bnd["library_ms"] = cuda_ms(lambda: library(qop, uq), reps)
        lib = (f", library {bnd['library_ms']:.4f} ms/call (one torch.mm: "
               f"the cross product alone, no norms, no minima)")
    log(f"{tag} {label} {ms:.4f} ms/call, plain {plain_ms:.4f} "
        f"ms/call{lib} (N={e.n_valid}, B={qop.shape[1]})")
    kernels[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bnd)
    return mins, echo


def phase8_int8_and_slot_kernels(dev, tag, cw, codes, order, eng, rng,
                                 kernels, codes_db, codes_db64, launches):
    """B1 and B3 in int8 mode and B5 in its three modes against their
    plain versions on phase 3's codes, timed; then the int8 codes tier's
    own path.  Returns the slot tiles of the DFS order."""
    with Phase("8 int8 and slot-tile kernels"):
        q = rng.normal(size=(B, D)).astype(np.float32)
        e = FusedCompressedEngine.from_tiles(cw, eng.tiles, row_to_db=order,
                                             precision="int8")
        scan_vs_plain(tag, "B1 stream_mins int8", e, q,
                      lambda qop, uq: fk.fused_stream_mins_ref(
                          qop, e.cwbd, e.row_data, e.vals, e.meta,
                          e.n_valid, M, u=uq, mode="int8"),
                      kernels, "stream_mins_int8")
        b1_mins = {"int8": e.scan(*e.prepare(q)[1:3])[0],
                   "int16": eng.scan(*eng.prepare(q)[1:3])[0]}
        e1 = e
        e = FusedCodesEngine(cw, codes, order=order, precision="int8")
        scan_vs_plain(tag, "B3 codes_mins int8", e, q,
                      lambda qop, uq: fk.fused_codes_mins_ref(
                          qop, e.cwbd, e.codes, e.n_valid, u=uq,
                          mode="int8"),
                      kernels, "codes_mins_int8")
        _, qop, uq, _, _ = e.prepare(q)
        check(torch.equal(e1.scan(qop, uq)[0], e.scan(qop, uq)[0]),
              "B1 int8 mins != B3's on the same rows")
        log(f"B1 int8 = B3 int8 bit for bit on the same rows; B1 "
            f"{kernels['stream_mins_int8']['ms']:.4f} ms, B3 "
            f"{kernels['codes_mins_int8']['ms']:.4f} ms")
        del e, e1

        t = time.perf_counter()
        dt = build_delta_tiles(codes[order])
        log(f"slot tiles of the DFS order: {time.perf_counter() - t:.1f} s; "
            f"S {dt.S}, Cap {dt.Cap}, B/vec {dt.bytes_per_vec():.4f} "
            f"(stream tiles {eng.bytes_per_vec():.4f}, plain {M})")
        check(np.array_equal(decode_delta_tiles(dt), codes[order]),
              "slot tiles not lossless")
        for prec, key, tol in (("int8", "delta_mins_int8", None),
                               ("int16", "delta_mins", int16_tol),
                               ("bf16", "delta_mins_bf16", bf16_tol)):
            e = FusedCompressedEngine.from_tiles(cw, dt, row_to_db=order,
                                                 precision=prec)
            mins, echo = scan_vs_plain(
                tag, f"B5 delta_mins {prec}", e, q,
                lambda qop, uq: fk.fused_delta_mins_ref(
                    qop, e.cwbd, e.row_data, e.ovf, e.n_valid, dt.S, u=uq,
                    mode=prec),
                kernels, key, tol)
            check(np.array_equal(echo[:N].cpu().numpy(), codes[order]),
                  f"B5 {prec} echo != the codes")
            if prec in b1_mins:
                check(torch.equal(mins, b1_mins[prec]),
                      f"B5 {prec} mins != B1's on the same rows")
            b1 = kernels[fk._launch_name("stream_mins", prec)]["ms"]
            log(f"{tag} B5 {prec}: bound {kernels[key]['bound_ms']:.4f} ms, "
                f"B1 on the same rows {b1:.4f} ms"
                + ("; mins = B1's bit for bit" if prec in b1_mins else ""))
            del e, echo, mins
        del b1_mins

        # the int8 codes tier through its own entry point
        ce = FusedCodesEngine(cw, codes, precision="int8")
        build.reset_launch_counts()
        for _ in range(2):
            q = rng.normal(size=(B, D)).astype(np.float32)
            d, ids = ce.query(q, top_k=TOP_K)
            check_batch(ce.prepare(q)[0][:B], codes_db, codes_db64,
                        torch.from_numpy(d).to(dev),
                        torch.from_numpy(ids).to(dev))
        counts = build.launch_counts()
        check(counts["codes_mins_int8"] > 0 and counts["rerank"] > 0,
              "FusedCodesEngine(precision='int8') launched no scan")
        launches["codes_mins_int8"] = counts["codes_mins_int8"]
        log(f"FusedCodesEngine(precision='int8'): 2 batches exact, "
            f"first-shot {ce.last_exact_frac:.4f}; launches "
            f"{({k: v for k, v in counts.items() if v})}")
    return dt


def timed_batches(tag, label, e, b, n_batches, rng, codes_db, codes_db64,
                  n):
    """``n_batches`` top-10 queries of ``b`` through the staged engine
    (prepare, scan, select timed with CUDA events), each held to the
    plain exact scan.  Returns the mean certified first-shot fraction."""
    split = np.zeros(3)
    walls, fracs = [], []
    for _ in range(n_batches):
        q = rng.normal(size=(b, D)).astype(np.float32)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        ev[0].record()
        table, qop, uq, cert, bq = e.prepare(q)
        ev[1].record()
        mins, echo = e.scan(qop, uq)
        ev[2].record()
        d, ids = e.select(table, cert, mins, echo, bq, TOP_K)
        ev[3].record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        split += [ev[j].elapsed_time(ev[j + 1]) for j in range(3)]
        fracs.append(e.last_exact_frac)
        check_batch(table[:bq], codes_db, codes_db64, d, ids, n)
    split /= n_batches
    wall = float(np.mean(walls))
    log(f"{tag} {label} ms/batch (B={b}, top-{TOP_K}, N={n}): "
        f"table+quantize {split[0]:.4f}, scan {split[1]:.4f}, "
        f"epilogue+ladder+terminal {split[2]:.4f}; host wall "
        f"{wall * 1e3:.4f} ms -> {b / wall:.1f} QPS; certified first-shot "
        f"{float(np.mean(fracs)):.4f}; {n_batches} batches bit-equal to "
        f"adc_query_topk, ids equal up to audited ties")
    return float(np.mean(fracs))


def phase9_slot_engine(dev, tag, cw, order, dt, rng, codes_db, codes_db64,
                       launches):
    """The slot-tile engine at int16, int8 and bf16, and its files."""
    with Phase("9 slot-tile engine"):
        for prec, key, n_batches in (("int16", "delta_mins", N_BATCHES),
                                     ("int8", "delta_mins_int8", N_BATCHES),
                                     ("bf16", "delta_mins_bf16", 2)):
            e = FusedCompressedEngine.from_tiles(cw, dt, row_to_db=order,
                                                 precision=prec)
            build.reset_launch_counts()
            t = time.perf_counter()
            e.warmup(batch_sizes=(B,), top_k=TOP_K)
            torch.cuda.synchronize()
            log(f"slots {prec}: warmup {time.perf_counter() - t:.2f} s, "
                f"ns_hint {getattr(e, 'ns_hint', None)}")
            timed_batches(tag, f"slot engine {prec}", e, B, n_batches, rng,
                          codes_db, codes_db64, N)
            counts = build.launch_counts()
            check(counts[key] > 0 and counts["rerank"] > 0,
                  f"slot engine {prec} never launched {key}")
            launches[key] = counts[key]
            log(f"  launches on the slots {prec} path: "
                f"{({k: v for k, v in counts.items() if v})}")
            if prec == "int8":
                e8 = e
            del e
        q = rng.normal(size=(B, D)).astype(np.float32)
        d0, i0 = e8.query(q, top_k=TOP_K)
        with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as path:
            e8.save(f"{path}/slots")
            with np.load(f"{path}/slots.npz") as z:
                check(str(z["fmt"]) == "slots", "slot file has no fmt")
                state = {k: z[k] for k in z.files if k != "fmt"}
            np.savez(f"{path}/nofmt", **state)
            for name in ("slots", "nofmt"):
                back = load_jax_engine(f"{path}/{name}")
                check(back.fmt == "slots" and back.precision == "int8",
                      f"{name}: not reloaded as int8 slot tiles")
                d1, i1 = back.query(q, top_k=TOP_K)
                check(np.array_equal(d0, d1) and np.array_equal(i0, i1),
                      f"the reloaded slot file ({name}) answers differently")
                del back
        del e8
        log("slot file round trip (with fmt, and without it): int8 slot "
            "tiles back, same results")


def phase13_pipelined(dev, tag, cw, order, eng, rng, kernels, codes_db,
                      codes_db64, launches):
    """B7 on phase 3's tiles: against B1 bit for bit and against the plain
    version, timed in turns with B1; then the pipelined engines."""
    with Phase("13 pipelined stream kernel"):
        q = rng.normal(size=(B, D)).astype(np.float32)
        for prec, tol in (("int8", None), ("bf16", bf16_tol)):
            key = f"stream_mins_pipelined_{prec}"
            e1 = FusedCompressedEngine.from_tiles(
                cw, eng.tiles, row_to_db=order, precision=prec)
            e7 = FusedCompressedEngine.from_tiles(
                cw, eng.tiles, row_to_db=order, precision=prec,
                pipelined=True)
            table, qop, uq, cert, b = e1.prepare(q)
            m1, c1 = e1.scan(qop, uq)
            m7, c7 = e7.scan(qop, uq)
            check(torch.equal(c7, c1), f"B7 {prec}: codes differ from B1's")
            ref_m, ref_c, pre_max, cross_max = fk.fused_stream_mins_ref(
                qop, e7.cwbd, e7.row_data, e7.vals, e7.meta, e7.n_valid, M,
                u=uq, mode=prec, pipelined=True)
            if tol is None:
                # integer products: B7's CUDA-core tail and B1's tensor-core
                # tail give the same bits
                check(torch.equal(m7, m1), f"B7 {prec}: mins differ from B1's")
            else:
                mins_err(m7, m1, tol(pre_max, cross_max),
                         f"B7 {prec} against B1 (f32 sums in two orders)")
            check(torch.equal(c7, ref_c), f"B7 {prec} echo != plain decode")
            if tol is None:
                check(torch.equal(m7, ref_m), f"B7 {prec} mins not bit-equal")
                err = 0.0
            else:
                err = mins_err(m7, ref_m, tol(pre_max, cross_max),
                               f"B7 stream_mins_pipelined {prec}")
            del ref_m, ref_c
            b1a = cuda_ms(lambda: e1.scan(qop, uq), 20)
            b7a = cuda_ms(lambda: e7.scan(qop, uq), 20)
            b7b = cuda_ms(lambda: e7.scan(qop, uq), 20)
            b1b = cuda_ms(lambda: e1.scan(qop, uq), 20)
            plain_ms = cuda_ms(lambda: fk.fused_stream_mins_ref(
                qop, e7.cwbd, e7.row_data, e7.vals, e7.meta, e7.n_valid, M,
                u=uq, mode=prec, pipelined=True), 2)
            ms = (b7a + b7b) / 2
            log(f"{tag} B7 {prec}: codes equal to B1's, mins "
                f"{'equal bit for bit' if tol is None else 'within tol'}; "
                f"{'bit-equal to' if tol is None else 'within tol of'} the "
                f"plain version; B7 {b7a:.4f} / {b7b:.4f} ms/call against "
                f"B1 {b1a:.4f} / {b1b:.4f} (B7 / B1 = "
                f"{ms / ((b1a + b1b) / 2):.4f}), plain {plain_ms:.4f} "
                f"(N={N}, B={B})")
            kernels[key] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                **scan_bound(prec, m7, B, D, engine_operands(e7, qop, uq),
                             (m7, c7)))
            del e1, m1, c1, m7, c7

            build.reset_launch_counts()
            t = time.perf_counter()
            e7.warmup(batch_sizes=(B,), top_k=TOP_K)
            torch.cuda.synchronize()
            log(f"pipelined {prec}: warmup {time.perf_counter() - t:.2f} s, "
                f"ns_hint {getattr(e7, 'ns_hint', None)}")
            timed_batches(tag, f"pipelined stream engine {prec}", e7, B,
                          N_BATCHES, rng, codes_db, codes_db64, N)
            counts = build.launch_counts()
            serial = fk._launch_name("stream_mins", prec)
            check(counts[key] > 0 and counts["rerank"] > 0
                  and counts[serial] == 0,
                  f"the pipelined {prec} path launched {counts}")
            launches[key] = counts[key]
            log(f"  launches on the pipelined {prec} path: "
                f"{({k: v for k, v in counts.items() if v})}")
            del e7


def gist_check(name, d, ids, table, d_ref, ids_ref, codes):
    """Results at the GIST shape against the exact scan, as
    ``bench_gist.verify``: distances allclose, ids up to f64-audited
    ties."""
    dists_ok = bool(np.allclose(d, d_ref, rtol=1e-5, atol=1e-3))
    agree, flips, real = bench_gist.tie_audit(table, codes, ids, ids_ref)
    check(dists_ok and real == 0,
          f"{name}: dists_match={dists_ok}, {real} real divergences")
    return agree, flips


def phase14_gist(dev, tag, kernels, launches):
    """The GIST shape at full width: workload, tree, kernels against
    their plain versions, engines through ``bench_gist``'s entry points,
    and the index."""
    Mg, Kg, Dsg, top_k = bench_gist.M, bench_gist.K, bench_gist.DS, \
        bench_gist.TOP_K
    with Phase("14 GIST shape (M=16, D=960, top-100)"):
        t = time.perf_counter()
        cw, codes, x = make_gist_workload(GIST_N, Mg, Kg, Dsg)
        log(f"make_gist_workload [{GIST_N}, {Mg * Dsg}] (vectors, pq_learn "
            f"on 20000 rows, encode): {time.perf_counter() - t:.1f} s")
        queries = bench_gist.gist_queries(x, GIST_B)
        del x
        order, n_diffs, t_tree = bench_gist.tree_order(codes)
        codes_scan = codes[order]
        st = build_stream_tiles(codes_scan)
        check(np.array_equal(decode_stream_tiles(st), codes_scan),
              "GIST stream tiles not lossless")
        bpv_lex = build_stream_tiles(
            codes[np.lexsort(codes.T[::-1])]).bytes_per_vec()
        n_distinct = len(np.unique(codes, axis=0))
        log(f"M={Mg} DeltaTree + DFS {t_tree:.1f} s ({n_diffs} diffs); "
            f"{n_distinct} distinct codes of {GIST_N} (dup "
            f"{GIST_N / n_distinct:.2f}x); stream B/vec DFS "
            f"{st.bytes_per_vec():.4f}, lexsort {bpv_lex:.4f}, plain {Mg}; "
            f"planes {st.n_planes}, e_max {st.e_max}")
        dt = build_delta_tiles(codes_scan)
        check(np.array_equal(decode_delta_tiles(dt), codes_scan),
              "GIST slot tiles not lossless")
        log(f"slot tiles: S {dt.S}, Cap {dt.Cap}, planes {dt.n_planes}, "
            f"B/vec {dt.bytes_per_vec():.4f}")
        table, d_ref, i_ref = bench_gist.exact_reference(cw, codes_scan,
                                                         queries, dev)
        d_ref, ids_ref = d_ref.cpu().numpy(), i_ref.cpu().numpy()
        del i_ref

        def stream(prec):
            return FusedCompressedEngine.from_tiles(cw, st, precision=prec)

        def slots(prec):
            return FusedCompressedEngine.from_tiles(cw, dt, precision=prec)

        def codes_eng(prec):
            return FusedCodesEngine(cw, codes_scan, precision=prec)

        def plain_of(e):
            if isinstance(e, FusedDecodedEngine):
                return lambda qop, uq: (lambda m, p, c: (m, e.codes, p, c))(
                    *fk.fused_decoded_mins_ref(qop, e.xt, e.n_valid))
            if isinstance(e, FusedCodesEngine):
                return lambda qop, uq: fk.fused_codes_mins_ref(
                    qop, e.cwbd, e.codes, e.n_valid, u=uq, mode=e.precision)
            if e.fmt == "slots":
                return lambda qop, uq: fk.fused_delta_mins_ref(
                    qop, e.cwbd, e.row_data, e.ovf, e.n_valid, dt.S, u=uq,
                    mode=e.precision)
            return lambda qop, uq: fk.fused_stream_mins_ref(
                qop, e.cwbd, e.row_data, e.vals, e.meta, e.n_valid, Mg,
                u=uq, mode=e.precision)

        tols = {"int8": None, "int16": int16_tol, "bf16": bf16_tol}
        # (label, kernel key, engine, timed through query())
        specs = [("B1 stream_mins (wgmma)", "stream_mins", stream, "int16",
                  True),
                 ("B1 stream_mins (wgmma)", "stream_mins", stream, "int8",
                  True),
                 ("B1 stream_mins (wgmma)", "stream_mins", stream, "bf16",
                  True),
                 ("B3 codes_mins", "codes_mins", codes_eng, "bf16", True),
                 ("B3 codes_mins", "codes_mins", codes_eng, "int16", False),
                 ("B3 codes_mins", "codes_mins", codes_eng, "int8", False),
                 ("B5 delta_mins", "delta_mins", slots, "int16", False),
                 ("B5 delta_mins", "delta_mins", slots, "int8", False),
                 ("B5 delta_mins", "delta_mins", slots, "bf16", True),
                 ("B4 decoded_mins", "decoded_mins",
                  lambda prec: FusedDecodedEngine(cw, codes_scan), "bf16",
                  True)]
        b1_mins = {}      # B1's mins a mode, on the same wgmma tail
        for label, kernel, make, prec, timed in specs:
            e = make(prec)
            key = (kernel if kernel == "decoded_mins"
                   else fk._launch_name(kernel, prec))
            name = f"{key}@gist"
            mins, echo = scan_vs_plain(
                tag, f"GIST {label} {prec}", e, queries, plain_of(e),
                kernels, name, tols[prec], reps=5,
                library=(lambda qop, uq: bench_stream.mm_yardstick(e.xt, qop))
                if kernel == "decoded_mins" else None)
            check(np.array_equal(echo[:GIST_N].cpu().numpy(), codes_scan),
                  f"GIST {label} {prec}: echo != the codes")
            if kernel == "stream_mins":
                b1_mins[prec] = mins
            elif kernel != "decoded_mins":
                b1 = kernels[fk._launch_name("stream_mins", prec) + "@gist"]
                same = mins_against_b1(mins, b1_mins[prec], prec,
                                       f"GIST {label} {prec}")
                log(f"{tag} GIST {label} {prec} (wgmma): bound "
                    f"{kernels[name]['bound_ms']:.4f} ms, B1 (wgmma, its own "
                    f"decode) on the same rows {b1['ms']:.4f} ms; {same}")
            del echo, mins
            # the engine's own path, as bench_gist drives it
            build.reset_launch_counts()
            res = bench_gist.verify(e, f"{label} {prec}", queries, table,
                                    d_ref, ids_ref, codes_scan)
            line = ""
            if timed:
                ms_batch, _ = bench_gist.time_engine(e, queries)
                line = (f"; {ms_batch:.4f} ms/batch -> "
                        f"{GIST_B / ms_batch * 1e3:.1f} QPS (host wall, "
                        f"B={GIST_B}, top-{top_k})")
            counts = build.launch_counts()
            check(counts[key] > 0 and counts["rerank"] > 0,
                  f"GIST {label} {prec}: the engine launched {counts}")
            launches[name] = counts[key]
            log(f"{tag} GIST engine {type(e).__name__} "
                f"{getattr(e, 'fmt', '')} {prec}: id agreement "
                f"{res['id_agree']:.4f}, {res['flips']} tie flips, 0 real "
                f"divergences, first-shot {res['first_shot']:.4f}{line}; "
                f"launches {({k: v for k, v in counts.items() if v})}")
            del e

        # the index on these codes, whatever auto resolves to
        idx = DeltaPQIndex(cw, codes, build_tree=False)
        d, ids = idx.search(queries, top_k)
        tab_db, dr_db, ir_db = bench_gist.exact_reference(cw, codes, queries,
                                                          dev)
        agree, flips = gist_check("index auto", d, ids, tab_db,
                                  dr_db.cpu().numpy(), ir_db.cpu().numpy(),
                                  codes)
        log(f"DeltaPQIndex(auto) over the GIST codes -> "
            f"{idx._engine_resolved} ({n_distinct} distinct codes): "
            f"distances match, id agreement {agree:.4f}, {flips} tie flips, "
            f"0 real divergences")
        del idx, tab_db, dr_db, ir_db, table, b1_mins

        # auto -> fused_compressed needs more than 65,536 distinct codes:
        # the same codebook over vectors of 125,000 clusters
        t = time.perf_counter()
        x2 = gist_vectors(GIST_IDX_N, Mg * Dsg, n_clusters=GIST_IDX_N // 2,
                          seed=1)
        codes2 = pq_encode(torch.from_numpy(cw).to(dev), x2,
                           batch_size=65536).cpu().numpy()
        q2 = bench_gist.gist_queries(x2, GIST_B, seed=1)
        del x2
        n2 = len(np.unique(codes2, axis=0))
        log(f"near-distinct GIST-shape codes [{GIST_IDX_N}, {Mg}]: {n2} "
            f"distinct, {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        idx = DeltaPQIndex(cw, codes2)
        log(f"DeltaPQIndex(cw, codes) at M={Mg}: "
            f"{time.perf_counter() - t:.1f} s")
        tab2, dr2, ir2 = bench_gist.exact_reference(cw, codes2, q2, dev)
        dr2, ir2 = dr2.cpu().numpy(), ir2.cpu().numpy()
        build.reset_launch_counts()
        t = time.perf_counter()
        d, ids = idx.search(q2, top_k)
        first = time.perf_counter() - t
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            d, ids = idx.search(q2, top_k)
            walls.append(time.perf_counter() - t)
            agree, flips = gist_check("index auto (near-distinct)", d, ids,
                                      tab2, dr2, ir2, codes2)
        counts = build.launch_counts()
        e = idx._fused_engine
        check(idx._engine_resolved == "fused_compressed"
              and e.precision == "bf16" and e.row_data.shape[1] == 2
              and counts["stream_mins_bf16"] > 0 and counts["rerank"] > 0,
              f"auto at M=16 resolved to {idx._engine_resolved}, launches "
              f"{counts}")
        wall = float(np.mean(walls))
        log(f"{tag} DeltaPQIndex(auto) at M={Mg}, N={GIST_IDX_N} -> "
            f"{idx._engine_resolved} (bf16, 2 mask planes): first search "
            f"{first:.2f} s; {wall * 1e3:.4f} ms/batch -> "
            f"{GIST_B / wall:.1f} QPS (B={GIST_B}, top-{top_k}); distances "
            f"match, id agreement {agree:.4f}, {flips} tie flips, 0 real "
            f"divergences; first-shot {e.last_exact_frac:.4f}; "
            f"stats {idx.stats()}; launches "
            f"{({k: v for k, v in counts.items() if v})}")
        del idx

        # B3's wide tail on the near-distinct codes (lexsort order), beside
        # B1 on the same rows
        codes2 = codes2[np.lexsort(codes2.T[::-1])]
        st2 = build_stream_tiles(codes2)
        for prec in ("int16", "int8", "bf16"):
            e1 = FusedCompressedEngine.from_tiles(cw, st2, precision=prec)
            e3 = FusedCodesEngine(cw, codes2, precision=prec)
            _, qop, uq, _, _ = e1.prepare(q2)
            m1 = e1.scan(qop, uq)[0]
            ms1 = cuda_ms(lambda: e1.scan(qop, uq), 5)
            own = {}
            mins, _ = scan_vs_plain(
                tag, f"GIST near-distinct B3 codes_mins {prec}", e3, q2,
                plain_of(e3), own, "b3", tols[prec], reps=5)
            same = mins_against_b1(mins, m1, prec,
                                   f"GIST near-distinct B3 {prec}")
            log(f"{tag} GIST near-distinct (N={GIST_IDX_N}) B3 {prec} "
                f"{own['b3']['ms']:.4f} ms, bound "
                f"{own['b3']['bound_ms']:.4f} ms, B1 (wgmma, its own "
                f"decode) on the same rows {ms1:.4f} ms; {same}")
            del e1, e3, mins, m1


def sift_chunks(n_chunks):
    """Phase 10's vectors, chunk c from seed c (chunk 0 = phase 3's)."""
    for c in range(n_chunks):
        yield workload_vectors(N, seed=c, **WORKLOADS["sift_like"])


def phase10_big_n(dev, tag, cw, codes, rng, launches):
    """BigCompressedIndex at int8 over 8,388,608 rows in four resident
    chunks, its mmap reload, and the dedup tier's int8 inner engine."""
    with Phase("10 big N at int8"):
        n_big = BIG_CHUNKS * N
        t = time.perf_counter()
        codes8 = encode_stream(cw, sift_chunks(BIG_CHUNKS))
        log(f"vectors + encode_stream [{n_big}, {D}] in {BIG_CHUNKS} "
            f"chunks: {time.perf_counter() - t:.1f} s; host codes "
            f"{codes8.nbytes / 2**20:.0f} MiB; chunk 0 rows differing from "
            f"phase 3's codes: {int((codes8[:N] != codes).any(1).sum())}")
        t = time.perf_counter()
        idx = BigCompressedIndex(cw, codes8, n_parts=8, precision="int8",
                                 chunk_rows=BIG_CHUNK_ROWS)
        st = idx.build_stats
        log(f"BigCompressedIndex: {time.perf_counter() - t:.1f} s (sort "
            f"{st.t_sort:.2f} s, partition builds {st.t_build:.2f} s wall "
            f"on {os.cpu_count()} workers, tree diffs {st.n_diffs})")
        for p, (te, tl) in enumerate(st.per_part):
            log(f"  partition {p}: tree {te:.2f} s, layout {tl:.2f} s")
        eng = idx.engine
        check(isinstance(eng, ChunkedCompressedEngine) and eng.resident
              and len(eng.chunks) == n_big // BIG_CHUNK_ROWS,
              "BigCompressedIndex did not chunk")
        log(f"{len(eng.chunks)} resident int8 chunks of {BIG_CHUNK_ROWS} "
            f"rows; B/vec {idx.bytes_per_vec():.4f}")
        cdb = torch.from_numpy(pad_codes(codes8, 16384)).to(dev)
        cdb64 = cdb[:n_big].to(torch.int64)
        build.reset_launch_counts()
        t = time.perf_counter()
        idx.warmup(batch_sizes=(BIG_B,), top_k=TOP_K)
        torch.cuda.synchronize()
        log(f"warmup (calibrate chunk 0 + one batch a chunk): "
            f"{time.perf_counter() - t:.2f} s, ns_hint "
            f"{getattr(eng.chunks[0], 'ns_hint', None)}")
        walls, fracs = [], []
        for _ in range(N_BATCHES):
            q = rng.normal(size=(BIG_B, D)).astype(np.float32)
            torch.cuda.synchronize()
            t = time.perf_counter()
            d, ids = idx.query(q, top_k=TOP_K)
            walls.append(time.perf_counter() - t)
            fracs.append(eng.last_exact_fracs)
            big_check(cw, q, cdb, cdb64, d, ids, n_big)
        counts = build.launch_counts()
        check(counts["stream_mins_int8"] > 0 and counts["rerank"] > 0,
              "the big-N int8 path never launched stream_mins_int8")
        launches["stream_mins_int8"] = counts["stream_mins_int8"]
        wall = float(np.mean(walls))
        log(f"{tag} big-N int8 (N={n_big}, B={BIG_B}, top-{TOP_K}): "
            f"host wall {wall * 1e3:.4f} ms/batch -> {BIG_B / wall:.1f} "
            f"QPS; first-shot per chunk "
            f"{np.round(np.mean(fracs, axis=0), 4).tolist()}; "
            f"{N_BATCHES} batches bit-equal to adc_query_topk over all "
            f"{n_big} codes, ids equal up to audited ties")
        log(f"  launches on the big-N path: "
            f"{({k: v for k, v in counts.items() if v})}")

        with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as path:
            t = time.perf_counter()
            eng.save(path)
            back = ChunkedCompressedEngine.from_saved(path, mmap=True,
                                                      resident=False)
            log(f"save + from_saved(mmap=True, resident=False): "
                f"{time.perf_counter() - t:.1f} s")
            for _ in range(2):
                q = rng.normal(size=(BIG_B, D)).astype(np.float32)
                torch.cuda.synchronize()
                t = time.perf_counter()
                d, ids = back.query(q, top_k=TOP_K)
                wall = time.perf_counter() - t
                big_check(cw, q, cdb, cdb64, d, ids, n_big)
                up = back.last_upload_s
                log(f"{tag} mmap batch: host wall {wall * 1e3:.4f} ms: "
                    f"uploads (pageable host -> card, {len(back._host)} "
                    f"chunks) {up * 1e3:.4f} ms, scans and selection "
                    f"{(wall - up) * 1e3:.4f} ms; first-shot "
                    f"{np.round(back.last_exact_fracs, 4).tolist()}; "
                    f"bit-equal to adc_query_topk")
            del back
        del idx, eng, cdb, cdb64

        t = time.perf_counter()
        de = DedupCompressedEngine(cw, codes)
        check(isinstance(de.engine, FusedCompressedEngine)
              and de.engine.precision == "int8",
              "the dedup tier did not build its int8 inner engine")
        log(f"DedupCompressedEngine (default precision) over phase 3's "
            f"codes: {de.n_unique} distinct, inner engine int8 stream "
            f"tiles, {time.perf_counter() - t:.1f} s")
        cdb = torch.from_numpy(pad_codes(codes, 16384)).to(dev)
        cdb64 = cdb[:N].to(torch.int64)
        for _ in range(2):
            q = rng.normal(size=(B, D)).astype(np.float32)
            torch.cuda.synchronize()
            t = time.perf_counter()
            d, ids = de.query(q, top_k=TOP_K)
            wall = time.perf_counter() - t
            big_check(cw, q, cdb, cdb64, d, ids, N)
            log(f"{tag} dedup int8 batch (B={B}): host wall "
                f"{wall * 1e3:.4f} ms, first-shot "
                f"{de.engine.last_exact_frac:.4f}; bit-equal to "
                f"adc_query_topk")


def tiles_vs_plain(tag, label, key, kernels, kernel, plain, reps, bnd):
    """One ADC lookup kernel against its plain version on the same
    operands: every output bit-equal; both timed with CUDA events.
    Returns the kernel's outputs."""
    out = kernel()
    ref = plain()
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    check(all(torch.equal(a, b) for a, b in zip(outs, refs)),
          f"{label} not bit-equal to the plain version")
    del ref, refs
    ms = cuda_ms(kernel, reps)
    plain_ms = cuda_ms(plain, 1)
    log(f"{tag} {label}: bit-equal to the plain version; {ms:.4f} ms/call, "
        f"plain {plain_ms:.4f} ms/call")
    kernels[key] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                        **bnd(outs))
    return out


def b6_modes(tag, what, tab, codes_p, kernels, keep):
    """B6 in its three modes on one table and code set: each bit-equal to
    its plain version, timed beside it, its bound and the shared-memory
    floor of its lookups logged; the modes in ``keep`` go into
    ``kernels``."""
    n_pad = codes_p.shape[0]
    floor = lookup_floor_ms(tab, n_pad)
    for prec in ak.PRECISIONS:
        own = {}
        tiles_vs_plain(
            tag, f"B6 adc_topk {prec} on the {what} (N={N}, B={B}, "
                 f"top-{TOP_K}, tile {ADC_TILE})",
            ak._mode_name("adc_topk", prec), own,
            lambda: ak.adc_topk_tiles(tab, codes_p, N, TOP_K, ADC_TILE,
                                      prec),
            lambda: ak.adc_topk_tiles_ref(tab, codes_p, N, TOP_K, ADC_TILE,
                                          prec),
            10, lambda outs: lookup_bound(tab, (codes_p,), outs, n_pad,
                                          2 if prec == "bf16x2" else 1))
        (key, entry), = own.items()
        log(f"{tag} B6 {prec}: bound {entry['bound_ms']:.4f} ms "
            f"({entry['bound_by']}), shared-memory lookup floor "
            f"{floor:.4f} ms")
        if prec in keep:
            kernels[key] = entry


def phase11_adc_family_kernels(dev, tag, rng, kernels, dup):
    """B8, the bf16 modes of B6, B9 in its three precisions and B10
    against their plain versions at N=1,048,576, B=512, top-10, timed.
    Returns the ``TileDictEngine`` over the dup_heavy codes."""
    with Phase("11 plain-scan kernel family vs plain"):
        cw_b, codes_b, q_b = bench_engines.workload(N, B)
        tab = adc_table(torch.from_numpy(cw_b).to(dev),
                        torch.from_numpy(q_b).to(dev))
        codes_p = torch.from_numpy(pad_codes(codes_b, PACKED_TILE)).to(dev)
        n_pad = codes_p.shape[0]
        log(f"engine benchmark workload: N={N}, B={B}, M={M}, K={K}; "
            f"{len(np.unique(codes_b, axis=0))} distinct codes")

        # B8: compared in row chunks, so the plain side never holds a
        # second [B, N] matrix
        out = ak.adc_dists_pallas(tab, codes_p)
        step = 1 << 18
        for r0 in range(0, n_pad, step):
            ref = ak.adc_dists_ref(tab, codes_p[r0:r0 + step])
            check(torch.equal(out[:, r0:r0 + step], ref),
                  f"B8 rows {r0}.. not bit-equal to the plain version")
        del ref
        ms = cuda_ms(lambda: ak.adc_dists_pallas(tab, codes_p), 5)
        # the one library call that computes the same sums: a bag per row
        w = tab.reshape(B, M * K).t().contiguous()          # [M*K, B]
        ix = (codes_p.to(torch.int64)
              + torch.arange(M, device=dev)[None, :] * K)
        lib = torch.nn.functional.embedding_bag(ix, w, mode="sum")
        lib_err = float((lib.t() - out).abs().max())
        bnd = lookup_bound(tab, (codes_p,), (out,), n_pad)
        del lib, out
        library_ms = cuda_ms(lambda: torch.nn.functional.embedding_bag(
            ix, w, mode="sum"), 3)
        del ix, w
        plain_ms = cuda_ms(lambda: ak.adc_dists_ref(tab, codes_p), 1)
        log(f"{tag} B8 adc_dists [{B}, {n_pad}]: bit-equal to the plain "
            f"version; {ms:.4f} ms/call, plain {plain_ms:.4f}, "
            f"embedding_bag {library_ms:.4f} (max |diff| {lib_err:.3g}: "
            f"its own summation order)")
        kernels["adc_dists"] = dict(max_abs_err=0.0, ms=ms,
                                    plain_ms=plain_ms,
                                    **{**bnd, "library_ms": library_ms})

        b6_modes(tag, "engine benchmark codes", tab, codes_p, kernels,
                 ("bf16", "bf16x2"))
        keys_f32 = None
        for prec in ("f32", "bf16", "bf16x2"):
            keys = tiles_vs_plain(
                tag, f"B9 adc_topk_packed {prec} (tile {PACKED_TILE})",
                ak._mode_name("adc_topk_packed", prec), kernels,
                lambda: ak.adc_topk_packed_tiles(tab, codes_p, N, TOP_K,
                                                 PACKED_TILE, prec),
                lambda: ak.adc_topk_packed_tiles_ref(tab, codes_p, N, TOP_K,
                                                     PACKED_TILE, prec),
                10, lambda outs: lookup_bound(
                    tab, (codes_p,), outs, n_pad,
                    2 if prec == "bf16x2" else 1))
            if prec == "f32":
                keys_f32 = keys
        # exact keys select the exact scan's rows up to 12 truncated bits
        d, ids = ak._merge_packed(keys_f32, tab, codes_p, N, TOP_K,
                                  PACKED_TILE)
        check_packed(tab, codes_p, d, ids.to(torch.int64), N)
        del keys_f32, codes_p, tab

        # B10 on the dup_heavy codes in DeltaTree-DFS order
        t = time.perf_counter()
        for max_dict in (64, 128, 256):     # the JAX default first
            eng = ak.TileDictEngine(dup["cw"], dup["codes"],
                                    order=dup["order"], tile_n=DICT_TILE,
                                    max_dict=max_dict)
            if eng.ok:
                break
            log(f"a tile of the dup_heavy codes in DFS order has more than "
                f"{max_dict} distinct values in a subspace: wider")
        check(eng.ok, "no tile dictionary of u8 indexes fits")
        log(f"TileDictEngine over dup_heavy in DFS order: dictionary width "
            f"{eng.dict_width} (K={K}), {eng.dicts.shape[0]} tiles of "
            f"{DICT_TILE}, {time.perf_counter() - t:.1f} s")
        tab = adc_table(eng.codewords, torch.from_numpy(
            rng.normal(size=(B, D)).astype(np.float32)).to(dev))
        n_rows = eng.idx.shape[0]
        keys = tiles_vs_plain(
            tag, f"B10 adc_topk_tiledict (tile {DICT_TILE}, width "
                 f"{eng.dict_width})", "adc_topk_tiledict", kernels,
            lambda: ak.adc_topk_tiledict_tiles(tab, eng.idx, eng.dicts, N,
                                               TOP_K, DICT_TILE),
            lambda: ak.adc_topk_tiledict_tiles_ref(tab, eng.idx, eng.dicts,
                                                   N, TOP_K, DICT_TILE),
            10, lambda outs: lookup_bound(tab, (eng.idx, eng.dicts), outs,
                                          n_rows))
        check(torch.equal(keys, ak.adc_topk_packed_tiles(
            tab, eng.codes_reordered, N, TOP_K, DICT_TILE, "f32")),
            "B10 keys != B9 f32 keys on the same rows")
        log("B10 keys equal B9's f32 keys on the same rows")
    return eng


def check_packed(table, codes_pad, d, ids, n):
    """Results selected on exact packed keys against the plain exact
    scan: each id carries its exact distance, bit-equal; the id sets may
    differ only inside the 12 bits the key drops -- every returned
    distance is, in f64, within 2^-11 relative of the exact scan's
    k-th."""
    dr, ir = adc_query_topk(table, pad_codes(codes_pad, 16384), n, TOP_K,
                            16384)
    own = ak._exact_dists_for_ids(table, codes_pad, ids)
    check(torch.equal(own, d), "an id does not carry its exact distance")
    srt = torch.sort(d, 1).values
    same = torch.sort(ids, 1).values == torch.sort(ir, 1).values
    exact_rows = same.all(1)
    check(torch.equal(srt[exact_rows], dr[exact_rows]),
          "equal id sets with different distances")
    t64 = table.to(torch.float64)
    Mq = table.shape[1]
    c64 = codes_pad[:n].to(torch.int64)
    n_audit = 0
    for b in torch.nonzero(~exact_rows).flatten().tolist():
        d64 = t64[b][torch.arange(Mq, device=t64.device)[None, :],
                     c64].sum(1)
        kth = torch.sort(d64).values[TOP_K - 1]
        worst = d64[ids[b]].max()
        check(float(worst) <= float(kth) + abs(float(kth)) * 2.0 ** -11,
              f"query {b}: a returned row lies beyond the key's truncation "
              f"({float(worst)} against the k-th {float(kth)})")
        n_audit += 1
    return n_audit


def time_engine(fn, q, reps):
    """(ms/batch, results) of ``fn(q)``: one warm call, then ``reps``
    synchronised calls between CUDA events."""
    res = fn(q)
    return cuda_ms(lambda: fn(q), reps), res


def phase12_plain_scan_engines(dev, tag, rng, dup, eng, launches):
    """The plain-scan engine family through its entry points; ``eng`` is
    phase 11's ``TileDictEngine``."""
    own_kernel = {
        "dists-smallest_k": "adc_dists",
        "pallas-argmin-f32": "adc_topk",
        "pallas-argmin-bf16": "adc_topk_bf16",
        "pallas-argmin-bf16x2": "adc_topk_bf16x2",
        "pallas-packed-f32": "adc_topk_packed",
        "pallas-packed-bf16": "adc_topk_packed_bf16",
        "pallas-packed-bf16x2": "adc_topk_packed_bf16x2"}
    exact = ("dists-smallest_k", "pallas-argmin-f32")
    with Phase("12 plain-scan engines"):
        cw_b, codes_b, _ = bench_engines.workload(N, B)
        t = time.perf_counter()
        engs = bench_engines.engines(cw_b, codes_b, all_modes=True)
        check(engs.pop("pallas-tiledict-f32") is None,
              "the unordered benchmark codes fit a 64-wide dictionary?")
        log(f"engines over the benchmark workload (decoded cache "
            f"included): {time.perf_counter() - t:.1f} s; its unordered "
            f"codes do not fit a 64-wide tile dictionary, so "
            f"TileDictEngine runs on the dup_heavy codes below")
        codes_p = torch.from_numpy(pad_codes(codes_b, 16384)).to(dev)
        codes_p64 = codes_p[:N].to(torch.int64)
        cwd = torch.from_numpy(cw_b).to(dev)
        for b in ENGINE_BS:
            q = torch.from_numpy(
                rng.normal(size=(b, D)).astype(np.float32)).to(dev)
            table = adc_table(cwd, q)
            dr, ir = adc_query_topk(table, codes_p, N, TOP_K, 16384)
            for name, fn in engs.items():
                build.reset_launch_counts()
                torch.cuda.reset_peak_memory_stats()
                ms, (d, ids) = time_engine(
                    fn, q, 2 if name in ("xla-gather",
                                         "dists-smallest_k") else 5)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                counts = build.launch_counts()
                ids = ids.to(torch.int64)
                note = ""
                if name in exact or name == "xla-gather":
                    check(torch.equal(d, dr), f"{name}: distances differ "
                                              f"from adc_query_topk")
                    check_batch(table, codes_p, codes_p64, d, ids)
                    note = "bit-equal to adc_query_topk"
                elif name == "pallas-packed-f32":
                    n_audit = check_packed(table, codes_p, d, ids, N)
                    note = (f"exact distances; ids equal to adc_query_topk"
                            f" but for {n_audit} queries inside the key's "
                            f"12 truncated bits (f64 audit)")
                else:
                    rec = recall_at_k(ids.cpu().numpy(), ir.cpu().numpy())
                    note = f"recall@{TOP_K} against the exact scan {rec:.4f}"
                    one_bf16 = "bf16" in name and "bf16x2" not in name
                    check(rec > (0.5 if one_bf16 else 0.99),
                          f"{name}: recall {rec}")
                key = own_kernel.get(name)
                if key:
                    check(counts[key] > 0, f"{name} never launched {key}")
                    launches[key] = launches.get(key, 0) + counts[key]
                log(f"{tag} {name} (B={b}): {ms:.4f} ms/batch -> "
                    f"{b / ms * 1e3:.1f} QPS; {note}; launches "
                    f"{({k: v for k, v in counts.items() if v})}; peak "
                    f"device memory {peak:.2f} GiB")
        del engs, codes_p, codes_p64
        log("decoded_topk's matrix products ran as "
            + ("torch.mm(bf16, bf16, out_dtype=f32)" if pdecoded._mm_out_dtype
               else "f32 torch.mm of the widened operands, TF32 off"))

        # TileDictEngine, through its query(), on the dup_heavy codes
        codes_d = torch.from_numpy(pad_codes(dup["codes"], 16384)).to(dev)
        for b in ENGINE_BS:
            q = rng.normal(size=(b, D)).astype(np.float32)
            build.reset_launch_counts()
            eng.query(q, top_k=TOP_K)
            walls = []
            for _ in range(N_BATCHES):
                torch.cuda.synchronize()
                t = time.perf_counter()
                d, ids = eng.query(q, top_k=TOP_K)
                walls.append(time.perf_counter() - t)
            counts = build.launch_counts()
            check(counts["adc_topk_tiledict"] > 0,
                  "TileDictEngine never launched adc_topk_tiledict")
            launches["adc_topk_tiledict"] = (
                launches.get("adc_topk_tiledict", 0)
                + counts["adc_topk_tiledict"])
            table = adc_table(eng.codewords, torch.from_numpy(q).to(dev))
            n_audit = check_packed(table, codes_d,
                                   torch.from_numpy(d).to(dev),
                                   torch.from_numpy(ids).to(dev).to(
                                       torch.int64), N)
            wall = float(np.mean(walls))
            log(f"{tag} TileDictEngine (dup_heavy, DFS order, width "
                f"{eng.dict_width}, B={b}): host wall {wall * 1e3:.4f} "
                f"ms/batch -> {b / wall:.1f} QPS; exact distances; ids "
                f"equal to adc_query_topk but for {n_audit} queries inside "
                f"the key's 12 truncated bits; launches "
                f"{({k: v for k, v in counts.items() if v})}")
        del eng, codes_d

        # DecodedEngine through query(), and its file, on the card
        n_small = N // 8
        dec = DecodedEngine(cw_b, codes_b[:n_small])
        q = rng.normal(size=(BIG_B, D)).astype(np.float32)
        d0, i0 = dec.query(q, top_k=TOP_K)
        big_check(cwd, q, torch.from_numpy(pad_codes(
            codes_b[:n_small], 16384)).to(dev), None, d0,
            i0.astype(np.int64), n_small)
        with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as path:
            t = time.perf_counter()
            dec.save(f"{path}/decoded.npz")
            back = load_jax_decoded_engine(f"{path}/decoded.npz")
            secs = time.perf_counter() - t
        check(back.device.type == "cuda" and back.precision == "bf16x2",
              "the decoded cache did not load onto the card")
        d1, i1 = back.query(q, top_k=TOP_K)
        check(np.array_equal(d0, d1) and np.array_equal(i0, i1),
              "the reloaded decoded cache answers differently")
        log(f"DecodedEngine.query over {n_small} rows bit-equal to "
            f"adc_query_topk; save + load on the card {secs:.1f} s, same "
            f"results")


def big_check(cw, q, codes_db, codes_db64, d, ids, n):
    """Results of an engine without ``prepare`` against the plain exact
    scan over the table of the same queries."""
    dev = codes_db.device
    if codes_db64 is None:
        codes_db64 = codes_db[:n].to(torch.int64)
    table = adc_table(cw, torch.from_numpy(q).to(dev))
    check_batch(table, codes_db, codes_db64, torch.from_numpy(d).to(dev),
                torch.from_numpy(ids).to(dev), n)


def check_batch(table, codes_db, codes_db64, d, ids, n=N):
    """Engine results against the plain exact scan over the same table:
    distances bit-equal; each id carries its reported distance; id sets
    differ only at f64-audited ties of the top-k boundary."""
    dr, ir = adc_query_topk(table, codes_db, n, TOP_K, 16384)
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
