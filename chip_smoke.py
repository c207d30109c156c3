#!/usr/bin/env python3
"""Checks of the PyTorch + CUDA port on one card, and its kernels' times.

Usage: ``python3 chip_smoke.py`` from the repository root, on a host with
one CUDA card (Hopper, sm_90a) and nvcc.  Without a card it exits
non-zero and prints no result.  It imports nothing of JAX.

What it checks.  Every query path answers as the plain exact scan
``adc_query_topk`` over the same table: distances bit-equal (or within a
stated tolerance), ids equal up to f64-audited ties.  Every kernel equals
its plain PyTorch version: bit for bit, or within the bound of its mode
(int16 scans 4e-6 * (max pre + 2 max|u*cross|), bf16 scans 2e-5 *
(max pre + 2 sqrt(max pre) max ||q||)).  Launch counts show that each
path ran its own kernels.  The phases, on synthetic data made from seeds:

1. device: the card's name and power limit, CUDA and nvcc versions;
2. kernel build: nvcc builds ``deltapq_tpu_torch/csrc/*.cu`` afresh (ptxas
   registers and spills printed), and g++ the host library
   ``native/dtc_native.cpp``;
3. data and index: the sift_like workload at N = 1,048,576, D=128, M=8,
   K=256; PQ learn + encode on the card, DeltaTree (method 1), DFS order,
   stream tiles (lossless); distinct codes and B/vec;
4. B1 (int16, B=512 and B=64) and B2 (cap-rung-sized candidates, beside
   one ``embedding_bag``) against their plain versions;
5. the int16 stream engine: warmup, N_BATCHES checked batches of 512
   top-10 queries, ``query`` equal to its stages, B1 and the per-query
   ladder launched and B2 not; the batch ladder forced to rungs 1, 2, 4
   into the terminal scan; the ladder's two kernels against their plain
   versions at the rungs ``rung_plan`` gives the engine;
6. the index tiers' kernels against their plain versions: B1 bf16, B3
   bf16 / int16 (int16 equal to B1 bit for bit), B4 (beside one
   ``torch.mm``), B6 f32, and the bf16 prepare kernel (its operand
   bit-equal to the host path's);
7. ``DeltaPQIndex`` over phase 3's codes: checked batches for ``auto``
   (-> ``fused_compressed`` bf16), ``fused``, ``fused_codes`` and
   ``pallas``, ``FusedCodesEngine`` int16, ``stats()``, save / load, and
   a dup_heavy index whose ``auto`` resolves to ``fused_dedup``;
8. B1 and B3 at int8 and B5 in three modes against their plain versions
   and against each other (bit for bit at int8 and int16), the slot
   tiles lossless; the int8 codes tier's checked batches;
9. the slot-tile engine at int16, int8 and bf16, checked batches, and a
   slot file saved with and without ``fmt`` reloading as the engine;
10. big N at int8: 8,388,608 rows through ``encode_stream`` and
    ``BigCompressedIndex`` (four resident chunks), checked batches over
    every code; ``from_saved(mmap=True, resident=False)``;
    ``DedupCompressedEngine``'s int8 inner engine;
11. the plain-scan kernels against their plain versions at N =
    1,048,576, B=512: B8 (beside ``embedding_bag``), B6 bf16 / bf16x2, B9
    in three precisions, B10 on the dup_heavy codes (its keys equal to
    B9's f32 keys);
12. the plain-scan engines at B=128 and 512, exact ones bit-equal and
    rounded ones by recall@10, their peak device memory;
    ``TileDictEngine``; ``DecodedEngine`` save and load;
13. B7 at int8 and bf16 equal to B1 bit for bit and to its plain
    version; the ``pipelined=True`` engines' checked batches, B7 launched
    and B1 not;
14. the GIST shape (M=16, Ds=60, D=960, top-100, B=500) at N =
    1,000,000: B1, B3, B5 in three modes and B4 against their plain
    versions and B3 / B5 against B1; every engine verified as
    ``bench_gist.verify`` does; ``DeltaPQIndex(auto)`` over these codes
    and over 250,000 near-distinct codes (-> ``fused_compressed``); B3
    against B1 on the near-distinct codes;
15. the CLI end to end on a SIFT1M-shaped fvecs dataset: every task
    through ``cli.main`` (its wall and printed lines logged), the code
    file byte-equal to ``pq_encode``, each of the eight engines held to
    the exact scan (decoded by recall@10), recall equal to
    ``recall_at_k``, the DTC lossless, ``query -shards 4``, the
    ContinuousBatcher at depth 1 and 2 equal, and ``query_compressed`` in
    a fresh interpreter; then each kernel the CLI launched against its
    plain version (``<name>@cli``);
16. sharded on one card: ``ShardedCompressedEngine`` over 1, 2 and 4
    shards (B5 and the ladder once a shard a batch), its kernels on shard
    0 of 4 against their plain versions (``@sharded``);
    ``sharded_query_plain``, ``pipelined_query``,
    ``sharded_query_decoded``, ``sharded_query_compressed``,
    ``make_dp_lloyd_step``, ``init_distributed`` (NCCL, world 1), the
    chunked and dedup tiers on a mesh, ``dryrun_multichip(4)``;
17. serving: ``CoalescingServer`` over phase 5's engine at three wave
    widths, every served wave checked; ``query_coalesced``;
18. the rest of the package: the native library against the Python
    loops (layout, DTC, diff index), ``scan_query_native``, the exact-MST
    tree (cut to 262,144 rows), ``rotate_tree`` and the bit format (cut
    to 65,536), the row store, the legacy prefix tree (cut to 16,384),
    ``make_sharded_delta_query_fn`` at ``rung_plan``'s first rung (at
    least ``SHARDED_MIN_OK`` certified), ``entry()``.

What it times.  Each kernel and its plain version with CUDA events (one
line a kernel, and the ``kernels`` JSON line: ms, plain_ms, bound_ms,
bound_by, library_ms, launches on its path).  ``bound_ms`` is the least
time the card could take for the same work, the benchmark's
``benchmark/roofline.py`` arithmetic: the bytes it must move (each input
read once, each output written once) over the HBM rate, or its
operations over the peak of their type, whichever is larger.  Set-up
steps (build, data, trees, warmups, files, CLI tasks) and phase 18's
codecs, native beside Python, print their host wall.  No query path's
rate is measured here: ``python3 -m benchmark.run`` measures them.

Any failed check raises, so the script exits non-zero without the last
line.  Its last two lines are a JSON object of per-kernel measurements
and ``{"ok": true, "device": {...}}``.
"""

import collections
import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from benchmark.roofline import bound_s, scan_ops, scan_peak_kind
from deltapq_tpu_torch import bench_engines, bench_gist, bench_stream, cli
from deltapq_tpu_torch import entry as flagship
from deltapq_tpu_torch.bigscale import (BigCompressedIndex,
                                        ChunkedCompressedEngine,
                                        encode_stream)
from deltapq_tpu_torch.convert import (load_jax_decoded_engine,
                                       load_jax_engine)
from deltapq_tpu_torch.eval.metrics import recall_at_k
from deltapq_tpu_torch.index import DeltaPQIndex
from deltapq_tpu_torch.io import (read_codes, read_codewords,
                                  read_groundtruth, write_vecs)
from deltapq_tpu_torch.kernels import build
from deltapq_tpu_torch.legacy import (BitVecsStore, dichotomize_codewords,
                                      prefix_tree_query)
from deltapq_tpu_torch.native import build as native_build
from deltapq_tpu_torch.native import (diff_index_decode_native, have_native,
                                      scan_query_native)
from deltapq_tpu_torch.ops import adc_kernels as ak
from deltapq_tpu_torch.ops import fused_kernels as fk
from deltapq_tpu_torch.ops.adc import (adc_query_topk, adc_table, pad_codes,
                                       query_plain, query_plain_tensors)
from deltapq_tpu_torch.ops import decoded as pdecoded
from deltapq_tpu_torch.ops.decoded import DecodedEngine
from deltapq_tpu_torch.ops.encode import pq_encode
from deltapq_tpu_torch.ops.delta_tiles import (DeltaTiles, build_delta_tiles,
                                               decode_delta_tiles)
from deltapq_tpu_torch.ops.fused import (DedupCompressedEngine,
                                         FusedCodesEngine,
                                         FusedCompressedEngine,
                                         FusedDecodedEngine,
                                         fused_select_esc, rung_plan)
from deltapq_tpu_torch.ops.kmeans import pq_learn
from deltapq_tpu_torch.ops.stream_tiles import (build_stream_tiles,
                                                decode_stream_tiles)
from deltapq_tpu_torch.parallel import (ShardedCompressedEngine,
                                        init_distributed, make_dp_lloyd_step,
                                        make_mesh, pipelined_query,
                                        shard_rows, sharded_query_decoded,
                                        sharded_query_plain)
from deltapq_tpu_torch.parallel.dryrun import dryrun_multichip
from deltapq_tpu_torch.parallel.fused_sharded import \
    make_sharded_delta_query_fn
from deltapq_tpu_torch.parallel.runtime import (ContinuousBatcher,
                                                batch_iterator)
from deltapq_tpu_torch.parallel.sharded_tree import sharded_query_compressed
from deltapq_tpu_torch.serving import CoalescingServer, query_coalesced
from deltapq_tpu_torch.synth import (WORKLOADS, gist_vectors,
                                     make_gist_workload, workload_vectors)
from deltapq_tpu_torch.tree import layout as tree_layout
from deltapq_tpu_torch.tree.build import find_edges_by_diff
from deltapq_tpu_torch.tree.exact_mst import find_edges_exact_mst
from deltapq_tpu_torch.tree.layout import build_layout
from deltapq_tpu_torch.tree.reroot import rotate_tree, tree_height
from deltapq_tpu_torch.tree.serialize import (
    block_aware_size, decode_diff_index, decode_dtc_to_codes, deserialize_bits,
    deserialize_dtc, deserialize_dtc_row_store, query_bits, query_row_store,
    read_dtc_raw, serialize_bits, serialize_diff_index, serialize_dtc,
    serialize_dtc_row_store)

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
    "ladder": "deltapq_tpu/ops/fused.py:115",
    "ladder_mins": "deltapq_tpu/ops/fused_pallas.py:1198",
    # none: the JAX engines' prepare is XLA and NumPy
    "prepare": "deltapq_tpu/ops/fused.py:464",
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
    "adc_topk_packed": "deltapq_tpu_torch/csrc/adc_topk.cu",
    "adc_topk_packed_bf16": "deltapq_tpu_torch/csrc/adc_topk.cu",
    "adc_topk_packed_bf16x2": "deltapq_tpu_torch/csrc/adc_topk.cu",
    "adc_topk_tiledict": "deltapq_tpu_torch/csrc/adc_topk.cu",
    "stream_mins_pipelined_int8":
        "deltapq_tpu_torch/csrc/stream_mins_pipelined.cu",
    "stream_mins_pipelined_bf16":
        "deltapq_tpu_torch/csrc/stream_mins_pipelined.cu",
    "ladder": "deltapq_tpu_torch/csrc/ladder.cu",
    "ladder_mins": "deltapq_tpu_torch/csrc/ladder.cu",
    "prepare": "deltapq_tpu_torch/csrc/prepare.cu",
}
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
CLI_N, CLI_LEARN, CLI_QUERIES = 1_000_000, 100_000, 10_000   # phase 15
CLI_Q = 1000           # its -query_size
#: recall@10 against the exact scan below which a rounded (bf16x2) scan
#: fails (phases 12 and 15)
DECODED_RECALL = 0.99
CLI_ENGINES = ("xla", "auto", "pallas", "decoded", "fused", "fused_codes",
               "fused_compressed", "fused_dedup")
#: the kernels a CLI path must launch, by launch counter
CLI_MUST = {("query", "pallas"): ("adc_topk",),
            ("query", "fused"): ("decoded_mins",),
            ("query", "fused_codes"): ("codes_mins",),
            ("query", "fused_compressed"): ("stream_mins_bf16", "ladder"),
            ("query_compressed", "auto"): ("stream_mins_bf16", "ladder")}
MST_N = 262_144        # phase 18: rows of the exact-MST tree (cut)
ROTATE_N = 65_536      # phase 18: rows of the rotation and the bit format (cut)
LEGACY_N = 16_384      # phase 18: rows of the prefix-tree store (cut)
RAW_D = 128            # phase 18: raw u8 bytes a row of the row store
ODD_D = 108            # phase 18: a width not divisible by M (Ds 14)
QUERY_SIGMA = 0.8      # phase 18: query = a database row + N(0, 0.8^2),
                       # the sift_like recipe's own per-row noise
#: phase 18: least certified share of the one-rung step at S shards, by
#: case.  The step certifies a query only where every shard does, at one
#: fixed rung, so the share falls with S: 0.9551 / 0.4375 / 0.1465 at N on
#: the H100; at D=108 on 16,384 rows (the first rows of N, so a query's
#: cluster is mostly missing) 0.5820 at S=1 on the H100 and 0.6387 /
#: 0.4375 / 0.3789 on a CPU.  Each floor sits well below its reading
SHARDED_MIN_OK = {D: {1: 0.85, 2: 0.35, 4: 0.10},
                  ODD_D: {1: 0.45, 2: 0.25, 4: 0.20}}


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
    """A kernel's ``bound_ms`` and ``bound_by`` fields: the benchmark's
    ``roofline.bound_s`` in ms."""
    s, by = bound_s(n_bytes, ops, kind)
    return dict(bound_ms=s * 1e3, bound_by=by, library_ms=None)


def scan_bound(mode, n_rows, b, d, inputs, outputs):
    """Bound of a scan kernel over ``n_rows`` valid rows (not the tiles'
    padding): ``roofline.scan_ops`` at the peak of ``scan_peak_kind``."""
    return bound(nbytes(*inputs, *outputs), scan_ops(n_rows, b, d, mode),
                 scan_peak_kind(mode))


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
        t = time.perf_counter()
        native_build.build(force=True)
        log(f"g++ {' '.join(native_build.GXX_FLAGS)} (native/"
            f"dtc_native.cpp): {time.perf_counter() - t:.1f} s")
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
        learn = x[:TRAIN].copy()          # phase 16's Lloyd step
        legacy_x = x[:LEGACY_N].copy()    # phase 18's prefix-tree store
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
            **scan_bound("int16", eng.n_valid, B, D,
                         engine_operands(eng, qop, uq),
                         (mins, echo)))
        del ref_m, ref_c

        rerank_vs_plain(tag, "B2 rerank", "rerank", kernels, table, mins,
                        echo)
        del mins, echo

    with Phase("5 engine"):
        codes_db = torch.from_numpy(pad_codes(codes, 16384)).to(dev)
        codes_db64 = codes_db[:N].to(torch.int64)
        build.reset_launch_counts()
        t = time.perf_counter()
        eng.warmup(batch_sizes=(B,), top_k=TOP_K)
        torch.cuda.synchronize()
        log(f"warmup (calibrate + one batch): "
            f"{time.perf_counter() - t:.2f} s, ns_hint {eng.ns_hint}")
        checked_batches("int16 stream engine", eng, B, N_BATCHES, rng,
                        codes_db, codes_db64, N)
        # the user entry point once: same distances as the stages
        q = rng.normal(size=(B, D)).astype(np.float32)
        table, qop, uq, (q2, err_r, scale2), b = eng.prepare(q)
        mins, echo = eng.scan(qop, uq)
        d, _ = eng.select(table, (q2, err_r, scale2), mins, echo, b, TOP_K)
        dq, _ = eng.query(q, top_k=TOP_K)
        check(np.array_equal(dq, d.cpu().numpy()), "query() != stages")
        counts = build.launch_counts()
        log(f"{tag} kernel launches in this phase: {counts}")
        check(counts["stream_mins"] > 0 and counts["ladder_mins"] > 0
              and counts["ladder"] > 0 and counts["rerank"] == 0,
              f"the main path launched {counts}")

        # the later rungs and the terminal exact scan, forced, on the
        # same minima
        d, rows, ok, _ = fused_select_esc(
            mins, q2, table, echo, N, TOP_K, (1, 2, 4),
            rung_plan(mins.shape[0], TOP_K, B).pool, err_r=err_r,
            scale2=scale2, final_exact=True)
        n_term = int((~ok).sum())
        check(n_term > 0, "the forced ladder never reached the terminal scan")
        ids = torch.where(rows >= 0, eng.row_to_db[rows.clamp(0, N - 1)]
                          .to(rows.dtype), rows)
        check_batch(table[:b], codes_db, codes_db64, d[:b], ids[:b])
        log(f"forced ladder (rungs 1, 2, 4 units) with the terminal exact "
            f"scan for {n_term} of {B} queries: distances bit-equal to "
            f"adc_query_topk, ids equal up to audited ties")
        # B1 and both ladders' kernels, as this phase's paths launched them
        counts = build.launch_counts()
        launches = {k: counts[k] for k in ("stream_mins", "rerank",
                                           "ladder", "ladder_mins")}
        ladder_vs_plain(tag, "B2' ladder", "", kernels, eng, table, mins,
                        echo, (q2, err_r, scale2))
        del mins, echo

    phase6_tier_kernels(dev, tag, cw, codes, order, eng, rng, kernels)
    # stream_mins, rerank and the ladder's kernels keep their counts from
    # phase 5's paths
    counts7, dup = phase7_index(dev, cw, codes, codes_db, codes_db64, rng)
    launches.update(counts7)
    dt = phase8_int8_and_slot_kernels(dev, tag, cw, codes, order, eng, rng,
                                      kernels, codes_db, codes_db64,
                                      launches)
    phase13_pipelined(dev, tag, cw, order, eng, rng, kernels, codes_db,
                      codes_db64, launches)
    phase16_sharded(dev, tag, cw, codes, order, learn, rng, kernels,
                    launches, codes_db, codes_db64, dup)
    phase17_serving(dev, cw, eng, rng, codes_db, codes_db64)
    phase18_rest(dev, tag, cw, codes, order, res, tree, eng.bytes_per_vec(),
                 dt, legacy_x, codes_db, codes_db64)
    del eng, learn, legacy_x, res, tree
    phase9_slot_engine(dev, cw, order, dt, rng, codes_db, codes_db64,
                       launches)
    phase10_big_n(dev, cw, codes, rng, launches)
    del codes_db, codes_db64
    tde = phase11_adc_family_kernels(dev, tag, rng, kernels, dup)
    phase12_plain_scan_engines(dev, rng, dup, tde, launches)
    del tde, dup
    phase14_gist(dev, tag, kernels, launches)
    phase15_cli(dev, tag, kernels, launches)
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


def rerank_vs_plain(tag, label, key, kernels, table, mins, echo):
    """B2 on cap-rung-sized candidates (S = 65,536 rows a query),
    gathered from a scan's codes echo as the epilogue gathers them:
    bit-equal to its plain version, timed beside it and beside its
    library yardstick, one ``embedding_bag`` (a bag of M table entries a
    candidate, at q*M*K + m*K + code)."""
    b, m_, k_ = table.shape
    dev = table.device
    n_sub = S_RERANK // fk.SUB
    sub_ids, _ = fk._select_units(fk.pool_mins_nb(mins, 1), n_sub)
    cw_units = echo.reshape(-1, fk.SUB * m_)[sub_ids[:b]]
    cand = cw_units.reshape(b, S_RERANK, m_).transpose(1, 2).contiguous()
    tab = table.reshape(b, m_ * k_).contiguous()
    out = fk.rerank_table_sums(tab, cand)
    ref = fk.rerank_table_sums_ref(tab, cand)
    check(torch.equal(out, ref), f"{label} not bit-equal")
    log(f"{label}: bit-equal on [{b}, {m_}, {S_RERANK}] candidates")
    del ref
    ms = cuda_ms(lambda: fk.rerank_table_sums(tab, cand), 20)
    plain_ms = cuda_ms(lambda: fk.rerank_table_sums_ref(tab, cand), 5)
    ix = (cand.transpose(1, 2).to(torch.int64)
          + torch.arange(b, device=dev)[:, None, None] * (m_ * k_)
          + torch.arange(m_, device=dev)[None, None, :] * k_
          ).reshape(b * S_RERANK, m_)
    w = tab.reshape(-1, 1)
    lib = torch.nn.functional.embedding_bag(ix, w, mode="sum")
    lib_err = float((lib.reshape(b, S_RERANK) - out).abs().max())
    del lib
    library_ms = cuda_ms(lambda: torch.nn.functional.embedding_bag(
        ix, w, mode="sum"), 3)
    log(f"{tag} {label} {ms:.4f} ms/call, plain {plain_ms:.4f} ms/call, "
        f"embedding_bag {library_ms:.4f} (max |diff| {lib_err:.3g}: its own "
        f"summation order) (B={b}, S={S_RERANK})")
    kernels[key] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
        **{**bound(nbytes(tab, cand, out), b * S_RERANK * m_, "f32"),
           "library_ms": library_ms})


def ladder_vs_plain(tag, label, suffix, kernels, e, table, mins, echo,
                    cert):
    """The per-query ladder's two kernels on a scan's own minima, at the
    rungs ``rung_plan`` gives engine ``e`` (its ``ns_hint``):
    ``ladder_mins`` bit-equal to ``pool_mins_nb`` (times scale2); the
    ladder's distances and status bytes equal to ``fused_ladder_ref``'s,
    its scan rows equal up to ties at equal distance, each carrying its
    distance.  Each timed
    beside its plain version and bound by the bytes it must move (the
    ladder: minima, tables, q2, err_r, the codes of the units of each
    row's deepest rung, its outputs; ``ladder_mins``: minima in and out).
    Entries ``ladder<suffix>`` and ``ladder_mins<suffix>``."""
    q2, err_r, scale2 = cert
    b_, m_, _ = table.shape
    pool, _, rungs = rung_plan(mins.shape[0], TOP_K, b_, e.ns_hint)
    unit = fk.SUB * pool

    def plain_mins():
        out = fk.pool_mins_nb(mins, pool)
        return out * scale2 if scale2 is not None else out

    mins_bn = fk.ladder_mins(mins, pool, scale2)
    check(torch.equal(mins_bn, plain_mins()),
          f"{label}: ladder_mins not bit-equal")

    def ladder():
        return fk.fused_ladder(mins_bn, q2, table, echo, e.n_valid, TOP_K,
                               rungs, pool, err_r=err_r)

    def plain():
        return fk.fused_ladder_ref(mins_bn, q2, table, echo, e.n_valid,
                                   TOP_K, rungs, pool, err_r=err_r)

    buf = ladder()
    d, rows, st = fk.ladder_views(buf, b_, TOP_K)
    rd, rrows, rst = plain()
    check(torch.equal(d, rd) and torch.equal(st, rst),
          f"{label}: distances or status differ from fused_ladder_ref")
    strict = d < d[:, -1:]
    fin = torch.isfinite(d)
    c = echo[rows.clamp_min(0)].to(torch.int64)              # [B, k, M]
    bi = torch.arange(b_, device=d.device)[:, None]
    own = torch.zeros_like(d)
    for m in range(m_):
        own = own + table[bi, m, c[:, :, m]]
    check(torch.equal(torch.sort(torch.where(strict, rows, -2), 1).values,
                      torch.sort(torch.where(strict, rrows, -2), 1).values)
          and torch.equal(rows < 0, ~fin)
          and torch.equal(torch.where(fin, own, d), d),
          f"{label}: rows differ from fused_ladder_ref beyond ties")
    reached = torch.where(st == fk.LADDER_FAILED, len(rungs) - 1,
                          st.to(torch.int64))
    reranked = int(torch.tensor(rungs, device=d.device)[reached].sum()) \
        * unit
    status = dict(zip(*(x.tolist() for x in torch.unique(
        st, return_counts=True))))
    ms = cuda_ms(ladder, 20)
    plain_ms = cuda_ms(plain, 2)
    kernels["ladder" + suffix] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
        **bound(nbytes(mins_bn, table, q2, err_r, buf) + reranked * m_,
                reranked * m_, "f32"))
    mins_ms = cuda_ms(lambda: fk.ladder_mins(mins, pool, scale2), 20)
    plain_mins_ms = cuda_ms(plain_mins, 20)
    kernels["ladder_mins" + suffix] = dict(
        max_abs_err=0.0, ms=mins_ms, plain_ms=plain_mins_ms,
        **bound(nbytes(mins, mins_bn), 0, "f32"))
    log(f"{label}: rungs {rungs} units of {unit} rows, status a row "
        f"{status}; minima bit-equal, distances and status equal to the "
        f"plain ladder, rows up to ties (B={b_}, top-{TOP_K})")
    log(f"{tag} {label} {ms:.4f} ms/call, plain {plain_ms:.4f} ms/call "
        f"(bound {kernels['ladder' + suffix]['bound_ms']:.4f}); "
        f"ladder_mins {mins_ms:.4f} ms/call, plain {plain_mins_ms:.4f} "
        f"(bound {kernels['ladder_mins' + suffix]['bound_ms']:.4f})")


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
            **scan_bound("bf16", e.n_valid, B, D,
                         engine_operands(e, qop, uq), (mins, echo)))
        del mins, echo, ref_m, ref_c
        prepare_vs_plain(tag, "", kernels, e, q)
        del e

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
                **scan_bound(prec, e.n_valid, B, D,
                             engine_operands(e, qop, uq), (mins,)))
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
            **{**scan_bound("bf16", e.n_valid, B, D, (qop, e.xt), (mins,)),
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


def device_ms(fn, reps):
    """Mean device ms per call of a launcher whose host side outlasts
    its kernels: the stream is held busy (``torch.cuda._sleep``, about
    0.1 s) while the host queues ``reps`` calls, so the events time the
    kernels back to back and not the host between them."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def prepare_vs_plain(tag, suffix, kernels, e, q):
    """The bf16 prepare kernel (``csrc/prepare.cu``) of engine ``e`` at
    the batch ``q``: qop bit-equal to the plain version and to the host
    path; the table and q2 within 2e-6 of their terms' magnitude (the
    order of f32 sums, as tests/test_torch_cuda.py holds them); the
    kernel timed beside its plain version."""
    b = len(q)
    b_pad = -(-b // 128) * 128
    M_, K_, Ds_ = e.codewords.shape
    qd = torch.from_numpy(q).to(e.device)
    args = (qd, e.codewords, e.mu_dev, b_pad, e._operand_layout())
    t, qop, q2 = fk.fused_prepare(*args)
    tr, qopr, q2r = fk.fused_prepare_ref(*args)
    host = e._prepare_on_host(q)
    check(torch.equal(qop.view(torch.int16), qopr.view(torch.int16))
          and torch.equal(qop.view(torch.int16), host[1].view(torch.int16)),
          f"prepare{suffix}: qop != the plain version / the host path")
    qs = torch.zeros((b_pad, M_ * Ds_), dtype=torch.float64, device=e.device)
    qs[:b] = qd[:, :M_ * Ds_].to(torch.float64)
    scale = ((qs.view(b_pad, M_, Ds_) ** 2).sum(-1)[:, :, None]
             + (e.codewords.to(torch.float64) ** 2).sum(-1)[None])
    rel = float(((t.double() - tr.double()).abs() / scale).max())
    rel_q2 = float(((q2 - q2r).abs() / q2r.abs()).max())
    check(rel <= 2e-6 and rel_q2 <= 2e-6,
          f"prepare{suffix}: table {rel:.3g}, q2 {rel_q2:.3g} of scale")
    n_diff = int((t != tr).sum())
    ms = device_ms(lambda: fk.fused_prepare(*args), 50)
    plain_ms = device_ms(lambda: fk.fused_prepare_ref(*args), 20)
    kernels["prepare" + suffix] = dict(
        max_abs_err=float((t - tr).abs().max()), ms=ms, plain_ms=plain_ms,
        **bound(nbytes(qd, e.codewords, e.mu_dev, t, qop, q2),
                2 * b_pad * M_ * K_ * Ds_, "f32"))
    log(f"{tag} prepare{suffix} (B={b}, M={M_}, K={K_}, Ds={Ds_}): kernel "
        f"{ms:.4f} ms/call, plain {plain_ms:.4f} ms/call, bound "
        f"{kernels['prepare' + suffix]['bound_ms']:.4f} ms "
        f"({kernels['prepare' + suffix]['bound_by']}); qop bit-equal to "
        f"the plain version and the host path; table entries != "
        f"adc_table's {n_diff} of {t.numel()} (max {rel:.3g} of q2 + c2), "
        f"q2 max rel {rel_q2:.3g}")


def search_batches(index, label, cw, codes_db, codes_db64, rng, n,
                   kernels=()):
    """One search (it builds the engine), then N_BATCHES B=512 top-10
    searches, each held to the plain exact scan over the table the engine
    builds.  The launch counts are set to 0 just before the first search
    and read after the last, before the checks (whose tables launch
    ``prepare`` again); each kernel in ``kernels`` must have been
    launched, and ``prepare``, where it was, once a search: as often as
    the path's scan, ``kernels[0]``.  Returns this path's launch
    counts."""
    q = rng.normal(size=(B, D)).astype(np.float32)
    build.reset_launch_counts()
    index.search(q, TOP_K)
    fracs, batches = [], []
    eng = index._fused_engine
    for _ in range(N_BATCHES):
        q = rng.normal(size=(B, D)).astype(np.float32)
        d, ids = index.search(q, TOP_K)
        batches.append((q, d, ids))
        if hasattr(eng, "prepare"):
            fracs.append(eng.last_exact_frac)
    counts = build.launch_counts()
    for q, d, ids in batches:
        table = (eng.prepare(q)[0][:B] if hasattr(eng, "prepare") else
                 adc_table(cw, torch.from_numpy(q).to(cw.device)))
        check_batch(table, codes_db, codes_db64, torch.from_numpy(d).to(
            cw.device), torch.from_numpy(ids).to(cw.device), n)
    resolved = index._engine_resolved or index.engine
    frac = (f", certified first-shot {float(np.mean(fracs)):.4f}"
            if fracs else "")
    log(f"index {label} (-> {resolved}): {N_BATCHES} batches of B={B}, "
        f"top-{TOP_K}{frac}; distances bit-equal to adc_query_topk, ids "
        f"equal up to audited ties")
    log(f"  launches on the {label} path: "
        f"{({k: v for k, v in counts.items() if v})}")
    for k in kernels:
        check(counts[k] > 0, f"kernel {k} never launched on the index's "
                             f"{label} path")
    check(not counts["prepare"] or counts["prepare"] == counts[kernels[0]],
          f"prepare launched {counts['prepare']} times on the {label} path, "
          f"its scan {counts[kernels[0]] if kernels else 0}")
    return counts


def phase7_index(dev, cw, codes, codes_db, codes_db64, rng):
    """The index API on the card; returns, for each kernel of the index
    tiers, its launch count on its own path."""
    launches = {}
    with Phase("7 index"):
        t = time.perf_counter()
        idx = DeltaPQIndex(cw, codes)
        log(f"DeltaPQIndex(cw, codes): tree, table-driven layout, DTC "
            f"stream: {time.perf_counter() - t:.1f} s")
        counts = search_batches(idx, "auto", cw, codes_db, codes_db64,
                                rng, N, ("stream_mins_bf16", "ladder",
                                         "prepare"))
        check(idx._engine_resolved == "fused_compressed"
              and idx._fused_engine.precision == "bf16",
              "auto did not resolve to fused_compressed at bf16")
        launches["stream_mins_bf16"] = counts["stream_mins_bf16"]
        launches["prepare"] = counts["prepare"]
        for name, own in (("fused", ("decoded_mins", "ladder")),
                          ("fused_codes", ("codes_mins", "ladder")),
                          ("pallas", ("adc_topk",))):
            other = DeltaPQIndex(cw, codes, engine=name, build_tree=False)
            counts = search_batches(other, name, cw, codes_db,
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
        for k in ("codes_mins_int16", "ladder"):
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
        search_batches(idx_d, "dup_heavy auto", cw_d, cdb,
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
    bnd = scan_bound(getattr(e, "precision", "bf16"), e.n_valid,
                     qop.shape[1], e.D, engine_operands(e, qop, uq),
                     (mins, echo))
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
        check(counts["codes_mins_int8"] > 0 and counts["ladder"] > 0,
              "FusedCodesEngine(precision='int8') launched no scan")
        launches["codes_mins_int8"] = counts["codes_mins_int8"]
        log(f"FusedCodesEngine(precision='int8'): 2 batches exact, "
            f"first-shot {ce.last_exact_frac:.4f}; launches "
            f"{({k: v for k, v in counts.items() if v})}")
    return dt


def checked_batches(label, e, b, n_batches, rng, codes_db, codes_db64, n):
    """``n_batches`` top-10 queries of ``b`` through the staged engine
    (prepare, scan, select), each held to the plain exact scan."""
    fracs = []
    for _ in range(n_batches):
        q = rng.normal(size=(b, D)).astype(np.float32)
        table, qop, uq, cert, bq = e.prepare(q)
        mins, echo = e.scan(qop, uq)
        d, ids = e.select(table, cert, mins, echo, bq, TOP_K)
        fracs.append(e.last_exact_frac)
        check_batch(table[:bq], codes_db, codes_db64, d, ids, n)
    log(f"{label} (B={b}, top-{TOP_K}, N={n}): certified first-shot "
        f"{float(np.mean(fracs)):.4f}; {n_batches} batches bit-equal to "
        f"adc_query_topk, ids equal up to audited ties")


def phase9_slot_engine(dev, cw, order, dt, rng, codes_db, codes_db64,
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
                f"ns_hint {e.ns_hint}")
            checked_batches(f"slot engine {prec}", e, B, n_batches, rng,
                            codes_db, codes_db64, N)
            counts = build.launch_counts()
            check(counts[key] > 0 and counts["ladder"] > 0,
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
            # one tail: the same bits in both modes
            check(torch.equal(m7, m1), f"B7 {prec}: mins differ from B1's")
            ref_m, ref_c, pre_max, cross_max = fk.fused_stream_mins_ref(
                qop, e7.cwbd, e7.row_data, e7.vals, e7.meta, e7.n_valid, M,
                u=uq, mode=prec, pipelined=True)
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
            log(f"{tag} B7 {prec}: codes and mins equal to B1's bit for bit; "
                f"{'bit-equal to' if tol is None else 'within tol of'} the "
                f"plain version; B7 {b7a:.4f} / {b7b:.4f} ms/call against "
                f"B1 {b1a:.4f} / {b1b:.4f} (B7 / B1 = "
                f"{ms / ((b1a + b1b) / 2):.4f}), plain {plain_ms:.4f} "
                f"(N={N}, B={B})")
            kernels[key] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                **scan_bound(prec, e7.n_valid, B, D,
                             engine_operands(e7, qop, uq), (m7, c7)))
            del e1, m1, c1, m7, c7

            build.reset_launch_counts()
            t = time.perf_counter()
            e7.warmup(batch_sizes=(B,), top_k=TOP_K)
            torch.cuda.synchronize()
            log(f"pipelined {prec}: warmup {time.perf_counter() - t:.2f} s, "
                f"ns_hint {e7.ns_hint}")
            checked_batches(f"pipelined stream engine {prec}", e7, B,
                            N_BATCHES, rng, codes_db, codes_db64, N)
            counts = build.launch_counts()
            serial = fk._launch_name("stream_mins", prec)
            check(counts[key] > 0 and counts["ladder"] > 0
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


def plain_scan_of(e):
    """(qop, uq) -> the plain version's (mins, echo, pre_max, cross_max)
    of engine ``e``'s scan kernel."""
    if isinstance(e, FusedDecodedEngine):
        return lambda qop, uq: (lambda m, p, c: (m, e.codes, p, c))(
            *fk.fused_decoded_mins_ref(qop, e.xt, e.n_valid))
    if isinstance(e, FusedCodesEngine):
        return lambda qop, uq: fk.fused_codes_mins_ref(
            qop, e.cwbd, e.codes, e.n_valid, u=uq, mode=e.precision)
    if e.fmt == "slots":
        return lambda qop, uq: fk.fused_delta_mins_ref(
            qop, e.cwbd, e.row_data, e.ovf, e.n_valid, e.tiles.S, u=uq,
            mode=e.precision)
    return lambda qop, uq: fk.fused_stream_mins_ref(
        qop, e.cwbd, e.row_data, e.vals, e.meta, e.n_valid, e.M, u=uq,
        mode=e.precision)


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

        tols = {"int8": None, "int16": int16_tol, "bf16": bf16_tol}
        # (label, kernel key, engine)
        specs = [("B1 stream_mins (wgmma)", "stream_mins", stream, "int16"),
                 ("B1 stream_mins (wgmma)", "stream_mins", stream, "int8"),
                 ("B1 stream_mins (wgmma)", "stream_mins", stream, "bf16"),
                 ("B3 codes_mins", "codes_mins", codes_eng, "bf16"),
                 ("B3 codes_mins", "codes_mins", codes_eng, "int16"),
                 ("B3 codes_mins", "codes_mins", codes_eng, "int8"),
                 ("B5 delta_mins", "delta_mins", slots, "int16"),
                 ("B5 delta_mins", "delta_mins", slots, "int8"),
                 ("B5 delta_mins", "delta_mins", slots, "bf16"),
                 ("B4 decoded_mins", "decoded_mins",
                  lambda prec: FusedDecodedEngine(cw, codes_scan), "bf16")]
        b1_mins = {}      # B1's mins a mode, on the same wgmma tail
        for label, kernel, make, prec in specs:
            e = make(prec)
            key = (kernel if kernel == "decoded_mins"
                   else fk._launch_name(kernel, prec))
            name = f"{key}@gist"
            mins, echo = scan_vs_plain(
                tag, f"GIST {label} {prec}", e, queries, plain_scan_of(e),
                kernels, name, tols[prec], reps=5,
                library=(lambda qop, uq: bench_stream.mm_yardstick(e.xt, qop))
                if kernel == "decoded_mins" else None)
            check(np.array_equal(echo[:GIST_N].cpu().numpy(), codes_scan),
                  f"GIST {label} {prec}: echo != the codes")
            if kernel == "stream_mins":
                b1_mins[prec] = mins
                if prec == "bf16":
                    prepare_vs_plain(tag, "@gist", kernels, e, queries)
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
            counts = build.launch_counts()
            check(counts[key] > 0 and counts["ladder"] > 0,
                  f"GIST {label} {prec}: the engine launched {counts}")
            launches[name] = counts[key]
            # prepare on one batch of the engine's own path, without the
            # check's own prepares: once at bf16
            build.reset_launch_counts()
            e.query(queries, top_k=top_k)
            one = build.launch_counts()["prepare"]
            check(one == (prec == "bf16"),
                  f"GIST {label} {prec}: {one} prepare launches a batch")
            if "prepare@gist" in kernels and "prepare@gist" not in launches:
                launches["prepare@gist"] = one
            log(f"GIST engine {type(e).__name__} "
                f"{getattr(e, 'fmt', '')} {prec}: id agreement "
                f"{res['id_agree']:.4f}, {res['flips']} tie flips, 0 real "
                f"divergences, first-shot {res['first_shot']:.4f}; "
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
        build.reset_launch_counts()
        idx.search(q2, top_k)
        # the bf16 engine's own table (csrc/prepare.cu)
        own = idx._fused_engine.prepare(q2)[0][:GIST_B]
        tab2, dr2, ir2 = bench_gist.exact_reference(cw, codes2, q2, dev,
                                                    table=own)
        dr2, ir2 = dr2.cpu().numpy(), ir2.cpu().numpy()
        for _ in range(3):
            d, ids = idx.search(q2, top_k)
            agree, flips = gist_check("index auto (near-distinct)", d, ids,
                                      tab2, dr2, ir2, codes2)
        counts = build.launch_counts()
        e = idx._fused_engine
        check(idx._engine_resolved == "fused_compressed"
              and e.precision == "bf16" and e.row_data.shape[1] == 2
              and counts["stream_mins_bf16"] > 0 and counts["ladder"] > 0,
              f"auto at M=16 resolved to {idx._engine_resolved}, launches "
              f"{counts}")
        log(f"DeltaPQIndex(auto) at M={Mg}, N={GIST_IDX_N} -> "
            f"{idx._engine_resolved} (bf16, 2 mask planes), B={GIST_B}, "
            f"top-{top_k}: distances match, id agreement {agree:.4f}, "
            f"{flips} tie flips, 0 real divergences; first-shot "
            f"{e.last_exact_frac:.4f}; stats {idx.stats()}; launches "
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
                plain_scan_of(e3), own, "b3", tols[prec], reps=5)
            same = mins_against_b1(mins, m1, prec,
                                   f"GIST near-distinct B3 {prec}")
            log(f"{tag} GIST near-distinct (N={GIST_IDX_N}) B3 {prec} "
                f"{own['b3']['ms']:.4f} ms, bound "
                f"{own['b3']['bound_ms']:.4f} ms, B1 (wgmma, its own "
                f"decode) on the same rows {ms1:.4f} ms; {same}")
            del e1, e3, mins, m1


def run_cli(dev, tag, argv, lc):
    """One CLI task in this process through ``cli.main(argv)`` on the
    card, the launch counts set to 0 just before it and read just after
    (added into ``lc``); its printed lines and wall time logged.  Returns
    (what the task returned, the metrics JSON it printed, its launches).
    """
    task = argv[argv.index("-task") + 1]
    fn = cli.TASKS[task]
    got = {}

    def keep(args, metrics):
        got["out"] = fn(args, metrics)
        return got["out"]

    buf = io.StringIO()
    cli.TASKS[task] = keep
    build.reset_launch_counts()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv, device=dev)
        torch.cuda.synchronize()
    finally:
        cli.TASKS[task] = fn
    wall = time.perf_counter() - t
    counts = {k: v for k, v in build.launch_counts().items() if v}
    check(rc == 0, f"cli {task} returned {rc}")
    for k, v in counts.items():
        lc[k] = lc.get(k, 0) + v
    lines = buf.getvalue().splitlines()
    flags = " ".join(argv[argv.index("-task") + 2:])
    log(f"{tag} cli {task} {flags}: {wall:.2f} s wall; launches {counts}")
    for line in lines:
        log(f"    | {line}")
    return got.get("out"), json.loads(lines[-1]), counts


def phase15_cli(dev, tag, kernels, launches):
    """The CLI's pipeline on the card at SIFT1M's size, every task checked;
    then each kernel it launched against its plain version."""
    with Phase("15 CLI end to end"), \
            tempfile.TemporaryDirectory() as root:
        t = time.perf_counter()
        x = workload_vectors(CLI_N + CLI_LEARN + CLI_QUERIES, seed=15,
                             **WORKLOADS["sift_like"])
        parts = {"base": x[:CLI_N], "learn": x[CLI_N:CLI_N + CLI_LEARN],
                 "query": x[CLI_N + CLI_LEARN:]}
        for name, a in parts.items():
            write_vecs(os.path.join(root, f"{name}.fvecs"), a)
        base, q = parts["base"], parts["query"][:CLI_Q]
        del x
        log(f"dataset (base {CLI_N}, learn {CLI_LEARN}, query "
            f"{CLI_QUERIES} x {D} fvecs, sift_like): "
            f"{time.perf_counter() - t:.1f} s")
        common = ["-dataset", root, "-ext", "fvecs", "-m", str(M), "-k",
                  str(K), "-topk", str(TOP_K), "-query_size", str(CLI_Q),
                  "-batch", str(B)]
        lc = {}

        def run(*task):
            return run_cli(dev, tag, [*common, "-task", *task], lc)

        def must(key, counts):
            for k in CLI_MUST.get(key, ()):
                check(counts.get(k, 0) > 0, f"cli {key} launched {counts}")

        run("learn", "-train_size", "20000")
        run("encode")
        cw = read_codewords(os.path.join(root, f"M{M}K{K}codewords.txt"))
        cw_t = torch.from_numpy(cw).to(dev)
        path = os.path.join(root, f"codes.bin.plain.M{M}K{K}N{CLI_N}")
        codes, _ = read_codes(path, M=M, K=K)
        want = pq_encode(cw_t, base).cpu().numpy()
        with open(path, "rb") as f:
            check(f.read() == np.int64(CLI_N).tobytes() + want.tobytes(),
                  "the code file != pq_encode of the codewords")
        log("code file = pq_encode of the same codewords, byte for byte")
        del want
        run("groundtruth")
        codes_db = torch.from_numpy(pad_codes(codes, 16384)).to(dev)
        codes_db64 = codes_db[:CLI_N].to(torch.int64)
        res = {}
        for e in CLI_ENGINES:
            res[e], _, counts = run("query", "-engine", e)
            must(("query", e), counts)
            if e == "fused_compressed":     # B1 on the lexsort order
                lex_b1 = counts["stream_mins_bf16"]
            d, i = res[e]
            if e == "decoded":
                r = recall_at_k(i, res["xla"][1], k=TOP_K)
                log(f"decoded: recall@{TOP_K} against the exact scan {r}")
                check(r > DECODED_RECALL, "decoded recall against the "
                                          "exact scan")
            else:
                big_check(cw_t, q, codes_db, codes_db64, d, i, CLI_N,
                          card=counts.get("prepare", 0) > 0)
                log(f"query -engine {e}: distances bit-equal to "
                    f"adc_query_topk, ids equal up to audited ties")
        (d, i), _, _ = run("query", "-shards", "4")
        check(np.array_equal(d, res["xla"][0]),
              "query -shards 4 distances != query -engine xla")
        big_check(cw_t, q, codes_db, codes_db64, d, i, CLI_N)
        log("query -shards 4 (the plain scan on 4 shards of the card): "
            "distances bit-equal to -engine xla and adc_query_topk, ids "
            "equal up to audited ties")
        batcher_depths(dev, cw_t, codes, parts["query"])
        _, m, _ = run("recall")
        gt_ids, _ = read_groundtruth(os.path.join(
            root, "groundtruth", f"N{CLI_N}Top{TOP_K}.txt"))
        r = recall_at_k(res["auto"][1], gt_ids[:CLI_Q], k=TOP_K)
        check(m["recall"] == r, f"recall {m['recall']} != {r}")
        log(f"recall {r}: equal to recall_at_k of the groundtruth file")

        run("approx_tree", "-method", "1")
        dtc = os.path.join(root,
                           f"M{M}K{K}_Approx_compressed_codes_opt_N{CLI_N}")
        t = time.perf_counter()
        n_codes, stream = read_dtc_raw(dtc)
        vec_id = np.load(dtc + ".soa.npz")["vec_id"].astype(np.int64)
        check(np.array_equal(decode_dtc_to_codes(stream, n_codes, M),
                             codes[vec_id]), "the DTC is not lossless")
        log(f"DTC decodes losslessly to the code file "
            f"({time.perf_counter() - t:.1f} s): {len(stream)} bytes, "
            f"{len(stream) / CLI_N:.4f} B/vec")
        del stream
        (d, i), _, counts = run("query_compressed", "-engine", "auto")
        must(("query_compressed", "auto"), counts)
        check(np.array_equal(d, res["fused_compressed"][0]),
              "query_compressed auto distances != query fused_compressed")
        check(np.allclose(d, res["xla"][0], rtol=1e-5, atol=1e-4),
              "query_compressed auto distances out of tolerance of xla")
        big_check(cw_t, q, codes_db, codes_db64, d, i, CLI_N, card=True)
        log("query_compressed auto: distances bit-equal to query "
            "fused_compressed and to adc_query_topk over the card's table "
            f"(csrc/prepare.cu); max |d - xla| "
            f"{float(np.abs(d - res['xla'][0]).max()):.3g}")
        (d, i), _, _ = run("query_compressed", "-engine", "xla")
        check(np.allclose(d, res["xla"][0], rtol=1e-5, atol=1e-4),
              "level-wise distances out of tolerance")
        log(f"query_compressed xla (level-wise): max |d - xla| "
            f"{float(np.abs(d - res['xla'][0]).max()):.3g}, id agreement "
            f"{float(np.mean(i == res['xla'][1])):.4f}")
        run("diff_index")
        (d, i), _, _ = run("diff_scan", "-engine", "pallas")
        check(np.array_equal(d, res["xla"][0]), "diff_scan distances")
        log("diff_scan: decode equal to the code file (the task's own "
            "check), distances bit-equal to query xla")
        run("mAP")
        run("update")
        del codes_db, codes_db64

        t = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "deltapq_tpu_torch.cli", *common,
             "-task", "query_compressed"], capture_output=True, text=True,
            timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
        check(p.returncode == 0, f"python -m deltapq_tpu_torch.cli: "
                                 f"{p.returncode}\n{p.stderr[-2000:]}")
        last = json.loads(p.stdout.strip().splitlines()[-1])
        log(f"{tag} python3 -m deltapq_tpu_torch.cli -task "
            f"query_compressed (fresh interpreter): exit 0, "
            f"{time.perf_counter() - t:.2f} s wall")
        for line in p.stdout.strip().splitlines():
            log(f"    | {line}")
        check("time_query_s" in last, "no metrics JSON")

        # B1 bf16 runs on two row orders: each is its own entry
        counts = {k + "@cli": v for k, v in lc.items()}
        counts["stream_mins_bf16@cli"] -= lex_b1
        counts["stream_mins_bf16@cli_lexsort"] = lex_b1
        cli_kernels(dev, tag, cw, codes, vec_id, q, kernels, counts)
        for name in [k for k in kernels if "@cli" in k]:
            launches[name] = counts[name]


def batcher_depths(dev, cw_t, codes, queries):
    """The ContinuousBatcher's double buffering on the card: the plain
    query as ``query -engine pallas`` runs it past ``-batch`` (B6 f32),
    over every query file row in batches of B, two batches in flight
    (depth 2) and one at a time (depth 1), the results equal."""
    codes_dev = torch.from_numpy(codes).to(dev)

    def fn(b):
        return query_plain_tensors(cw_t, b, codes_dev, top_k=TOP_K,
                                   engine="pallas", device=dev)

    def once(depth):
        outs = list(ContinuousBatcher(fn, depth).run(
            batch_iterator(queries, B)))
        return [np.concatenate([o[j] for o in outs]) for j in (0, 1)]

    ref = once(2)
    check(all(np.array_equal(a, r) for a, r in zip(once(1), ref)),
          "ContinuousBatcher depth 1 results differ from depth 2")
    log(f"ContinuousBatcher, {len(queries)} queries in "
        f"{-(-len(queries) // B)} batches of {B} (B6 f32, N={len(codes)}): "
        f"depth 1 and depth 2 results equal")
    del codes_dev


def cli_kernels(dev, tag, cw, codes, order, q, kernels, counts):
    """Each kernel the CLI launched (``counts``: launches by entry name),
    against its plain version on engines built as the CLI builds them
    (the DeltaTree's DFS order for query_compressed, lexsort for
    fused_compressed, the dedup tier's inner engine), at B=512 of its
    queries; timed, listed as ``<name>@cli`` (B1 bf16 on the lexsort
    order as ``stream_mins_bf16@cli_lexsort``)."""
    qb = q[:B]
    tols = {"int8": None, "int16": int16_tol, "bf16": bf16_tol}
    lex = np.lexsort(codes.T[::-1])
    engines = {
        "stream_mins_bf16@cli": lambda: FusedCompressedEngine(
            cw, codes[order], row_to_db=order, precision="bf16",
            device=dev),
        "stream_mins_bf16@cli_lexsort": lambda: FusedCompressedEngine(
            cw, codes[lex], row_to_db=lex, precision="bf16", device=dev),
        "codes_mins@cli": lambda: FusedCodesEngine(cw, codes, device=dev),
        "decoded_mins@cli": lambda: FusedDecodedEngine(cw, codes,
                                                       device=dev),
        "stream_mins_int8@cli": lambda: DedupCompressedEngine(
            cw, codes, device=dev).engine}
    for key, make in engines.items():
        if not counts.get(key):
            continue
        e = make()
        if e is None:          # the dedup tier held its codes exactly
            continue
        mins, echo = scan_vs_plain(
            tag, f"CLI {key}", e, qb, plain_scan_of(e), kernels, key,
            tols[getattr(e, "precision", "bf16")], reps=10,
            library=(lambda qop, uq: bench_stream.mm_yardstick(e.xt, qop))
            if key == "decoded_mins@cli" else None)
        if key == "stream_mins_bf16@cli":
            table, _, _, cert, _ = e.prepare(qb)
            ladder_vs_plain(tag, "CLI B2' ladder", "@cli", kernels, e,
                            table, mins, echo, cert)
        if counts.get("prepare@cli") and e.precision == "bf16" \
                and "prepare@cli" not in kernels:
            prepare_vs_plain(tag, "@cli", kernels, e, qb)
        del e, mins, echo
    if counts.get("adc_topk@cli"):
        codes_p = torch.from_numpy(pad_codes(codes, ADC_TILE)).to(dev)
        tab = adc_table(torch.from_numpy(cw).to(dev),
                        torch.from_numpy(qb).to(dev))
        tiles_vs_plain(
            tag, f"CLI B6 adc_topk f32 (N={CLI_N}, B={B}, top-{TOP_K})",
            "adc_topk@cli", kernels,
            lambda: ak.adc_topk_tiles(tab, codes_p, CLI_N, TOP_K, ADC_TILE,
                                      "f32"),
            lambda: ak.adc_topk_tiles_ref(tab, codes_p, CLI_N, TOP_K,
                                          ADC_TILE, "f32"),
            10, lambda outs: lookup_bound(tab, (codes_p,), outs, CLI_N))
    for k, n in counts.items():
        if n and k.split("@")[0] in SOURCES:
            check(k in kernels, f"the CLI launched {k}, which has no "
                                f"measured entry")

def sift_chunks(n_chunks):
    """Phase 10's vectors, chunk c from seed c (chunk 0 = phase 3's)."""
    for c in range(n_chunks):
        yield workload_vectors(N, seed=c, **WORKLOADS["sift_like"])


def phase10_big_n(dev, cw, codes, rng, launches):
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
            f"{eng.chunks[0].ns_hint}")
        fracs = []
        for _ in range(N_BATCHES):
            q = rng.normal(size=(BIG_B, D)).astype(np.float32)
            d, ids = idx.query(q, top_k=TOP_K)
            fracs.append(eng.last_exact_fracs)
            big_check(cw, q, cdb, cdb64, d, ids, n_big)
        counts = build.launch_counts()
        check(counts["stream_mins_int8"] > 0 and counts["ladder"] > 0,
              "the big-N int8 path never launched stream_mins_int8")
        launches["stream_mins_int8"] = counts["stream_mins_int8"]
        log(f"big-N int8 (N={n_big}, B={BIG_B}, top-{TOP_K}): first-shot "
            f"per chunk {np.round(np.mean(fracs, axis=0), 4).tolist()}; "
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
                d, ids = back.query(q, top_k=TOP_K)
                big_check(cw, q, cdb, cdb64, d, ids, n_big)
                log(f"mmap batch ({len(back._host)} chunks uploaded from "
                    f"pageable host memory): first-shot "
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
            d, ids = de.query(q, top_k=TOP_K)
            big_check(cw, q, cdb, cdb64, d, ids, N)
            log(f"dedup int8 batch (B={B}): first-shot "
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
    ``kernels``.  Returns B6's ms per mode."""
    n_pad = codes_p.shape[0]
    floor = lookup_floor_ms(tab, n_pad)
    times = {}
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
        times[prec] = entry["ms"]
    return times


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

        b6_ms = b6_modes(tag, "engine benchmark codes", tab, codes_p,
                         kernels, ("bf16", "bf16x2"))
        floor = lookup_floor_ms(tab, n_pad)
        keys_f32 = None
        for prec in ("f32", "bf16", "bf16x2"):
            key = ak._mode_name("adc_topk_packed", prec)
            keys = tiles_vs_plain(
                tag, f"B9 adc_topk_packed {prec} (tile {PACKED_TILE})",
                key, kernels,
                lambda: ak.adc_topk_packed_tiles(tab, codes_p, N, TOP_K,
                                                 PACKED_TILE, prec),
                lambda: ak.adc_topk_packed_tiles_ref(tab, codes_p, N, TOP_K,
                                                     PACKED_TILE, prec),
                10, lambda outs: lookup_bound(
                    tab, (codes_p,), outs, n_pad,
                    2 if prec == "bf16x2" else 1))
            entry = kernels[key]
            log(f"{tag} B9 {prec}: bound {entry['bound_ms']:.4f} ms "
                f"({entry['bound_by']}), shared-memory lookup floor "
                f"{floor:.4f} ms; B9 / B6 = {entry['ms'] / b6_ms[prec]:.4f} "
                f"(the same lookups and selection, on packed keys)")
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
        b9_ms = cuda_ms(lambda: ak.adc_topk_packed_tiles(
            tab, eng.codes_reordered, N, TOP_K, DICT_TILE, "f32"), 10)
        entry = kernels["adc_topk_tiledict"]
        log(f"{tag} B10 keys equal B9's f32 keys on the same rows; B10 "
            f"{entry['ms']:.4f} ms, B9 f32 on the codes of the same rows "
            f"{b9_ms:.4f} ms (B10 / B9 = {entry['ms'] / b9_ms:.4f}); bound "
            f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}), "
            f"shared-memory lookup floor "
            f"{lookup_floor_ms(tab, n_rows):.4f} ms")
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


def phase12_plain_scan_engines(dev, rng, dup, eng, launches):
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
                d, ids = fn(q)
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
                    check(rec > (0.5 if one_bf16 else DECODED_RECALL),
                          f"{name}: recall {rec}")
                key = own_kernel.get(name)
                if key:
                    check(counts[key] > 0, f"{name} never launched {key}")
                    launches[key] = launches.get(key, 0) + counts[key]
                log(f"{name} (B={b}): {note}; launches "
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
            d, ids = eng.query(q, top_k=TOP_K)
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
            log(f"TileDictEngine (dup_heavy, DFS order, width "
                f"{eng.dict_width}, B={b}): exact distances; ids equal to "
                f"adc_query_topk but for {n_audit} queries inside the key's "
                f"12 truncated bits; launches "
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



SHARDS = (1, 2, 4)     # phase 16: shards of the one card
SERVE_ROWS, SERVE_POOL = 128, 10_000    # phase 17: rows a wave, the pool
SERVE_CLIENTS, SERVE_DEPTH = 8, 4       # client threads, waves in flight
SERVE_WAVE_ROWS = (512, 1024, 2048)
SERVE_DISPATCHES = 256                  # the served window, in dispatches
SERVE_COALESCED = 64                    # waves through query_coalesced


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sharded_batches(label, e, rng, codes_db, codes_db64, n, key):
    """Warmup, then N_BATCHES top-10 queries of B through a sharded
    engine, the launch counts set to 0 just before the first and read
    after the last; each batch then held to ``adc_query_topk`` (the
    checks launch no kernel).  The scan kernel ``key`` must have run
    once a non-empty shard a batch, and so must the ladder's two kernels.
    Returns the counts."""
    e.warmup(batch_sizes=(B,), top_k=TOP_K)
    build.reset_launch_counts()
    fracs, got = [], []
    for _ in range(N_BATCHES):
        q = rng.normal(size=(B, D)).astype(np.float32)
        d, ids = e.query(q, top_k=TOP_K)
        fracs.append(e.last_exact_frac)
        got.append((q, d, ids))
    counts = build.launch_counts()
    for q, d, ids in got:
        big_check(e.shards[0][0].codewords, q, codes_db, codes_db64, d,
                  ids, n, card=counts["prepare"] > 0)
    live = sum(1 for s, _ in e.shards if s.n_valid)
    check(counts[key] == live * N_BATCHES,
          f"{label}: {key} launched {counts[key]} times, not "
          f"{live * N_BATCHES}")
    check(counts["ladder"] == counts["ladder_mins"] == live * N_BATCHES,
          f"{label}: the ladder launched {counts['ladder']} times")
    log(f"{label}: {N_BATCHES} batches of B={B}, top-{TOP_K}: certified "
        f"first-shot (every shard) {float(np.mean(fracs)):.4f}; launches "
        f"{key} {counts[key]}, ladder {counts['ladder']}; distances "
        f"bit-equal to adc_query_topk, ids equal up to audited ties")
    return counts


def phase16_sharded(dev, tag, cw, codes, order, learn, rng, kernels,
                    launches, codes_db, codes_db64, dup):
    """The multi-device layer on meshes of 1, 2 and 4 shards of the one
    card: no scaling is claimed (the shards of one card run one after
    the other)."""
    with Phase("16 sharded on one card"):
        cw_np = cw.cpu().numpy()
        codes_scan = codes[order]
        for S, prec in ((1, "bf16"), (2, "bf16"), (4, "bf16"),
                        (4, "int16")):
            mesh = make_mesh(S, device=dev)
            t = time.perf_counter()
            e = ShardedCompressedEngine(cw, codes_scan, mesh,
                                        row_to_db=order, precision=prec)
            log(f"ShardedCompressedEngine S={S} {prec}: slot tiles (S "
                f"{e.tiles.S}, Cap {e.tiles.Cap}) + upload "
                f"{time.perf_counter() - t:.1f} s, "
                f"{e.bytes_per_vec():.4f} B/vec")
            key = fk._launch_name("delta_mins", prec)
            counts = sharded_batches(f"sharded engine S={S} {prec}", e, rng,
                                     codes_db, codes_db64, N, key)
            if (S, prec) == (4, "bf16"):
                launches["delta_mins_bf16@sharded"] = counts[key]
                launches["ladder@sharded"] = counts["ladder"]
                launches["ladder_mins@sharded"] = counts["ladder_mins"]
                es = e.shards[0][0]
                q = rng.normal(size=(B, D)).astype(np.float32)
                mins, echo = scan_vs_plain(
                    tag, "sharded B5 delta_mins bf16 (shard 0 of 4)", es, q,
                    lambda qop, uq: fk.fused_delta_mins_ref(
                        qop, es.cwbd, es.row_data, es.ovf, es.n_valid,
                        es.tiles.S, u=uq, mode="bf16"),
                    kernels, "delta_mins_bf16@sharded", bf16_tol)
                table, _, _, cert, _ = es.prepare(q)
                ladder_vs_plain(tag, "sharded B2' ladder (shard 0 of 4)",
                                "@sharded", kernels, es, table, mins, echo,
                                cert)
                del mins, echo
            del e

        mesh4 = make_mesh(4, device=dev)
        q = rng.normal(size=(B, D)).astype(np.float32)
        d, ids = sharded_query_plain(cw, q, codes, top_k=TOP_K, mesh=mesh4)
        dx, _ = query_plain_tensors(cw, q, codes_db[:N], top_k=TOP_K,
                                    engine="xla", device=dev)
        check(np.array_equal(d, dx.cpu().numpy()),
              "sharded_query_plain distances != query_plain xla")
        big_check(cw, q, codes_db, codes_db64, d, ids, N)
        log(f"sharded_query_plain S=4 (B={B}): distances bit-equal to "
            f"query_plain(engine='xla') and adc_query_topk, ids up to "
            f"audited ties")
        qs = rng.normal(size=(4 * B, D)).astype(np.float32)
        pd, pi = pipelined_query(cw, qs, codes, mesh4, top_k=TOP_K,
                                 batch_size=B)
        for b0 in range(0, 4 * B, B):
            sd, si = sharded_query_plain(cw, qs[b0:b0 + B], codes,
                                         top_k=TOP_K, mesh=mesh4)
            check(np.array_equal(pd[b0:b0 + B], sd)
                  and np.array_equal(pi[b0:b0 + B], si),
                  "pipelined_query != sharded_query_plain on a batch")
            big_check(cw, qs[b0:b0 + B], codes_db, codes_db64, sd, si, N)
        log(f"pipelined_query S=4, 4 batches of {B}: each batch equal to "
            f"sharded_query_plain, distances bit-equal to adc_query_topk")
        dd, di = sharded_query_decoded(cw_np, q, codes, top_k=TOP_K,
                                       mesh=mesh4)
        big_check(cw, q, codes_db, codes_db64, dd, di, N)
        de, _ = DecodedEngine(cw_np, codes, device=dev).query(q, top_k=TOP_K)
        check(np.array_equal(np.asarray(de), dd),
              "sharded_query_decoded != DecodedEngine")
        log(f"sharded_query_decoded S=4 bf16x2 (B={B}): distances equal "
            f"to DecodedEngine's and bit-equal to adc_query_topk")
        dc, ic = sharded_query_compressed(cw_np, codes, q, top_k=TOP_K,
                                          mesh=mesh4, workers=4)
        dr, ir = adc_query_topk(adc_table(cw, torch.from_numpy(q).to(dev)),
                                codes_db, N, TOP_K, 16384)
        dr = dr.cpu().numpy()
        check(np.allclose(dc, dr, rtol=1e-5, atol=1e-4),
              "sharded_query_compressed out of tolerance")
        log(f"sharded_query_compressed S=4 (four DeltaTrees on a spawn pool "
            f"of 4, level-wise query, B={B}): max |d - adc_query_topk| "
            f"{float(np.abs(dc - dr).max()):.3g}, id agreement "
            f"{float(np.mean(ic == ir.cpu().numpy())):.4f}")

        M_, K_, Ds_ = cw_np.shape
        x = torch.from_numpy(np.ascontiguousarray(
            learn.reshape(len(learn), M_, Ds_).transpose(1, 0, 2)))
        c4, dist4 = make_dp_lloyd_step(mesh4)(shard_rows(mesh4, x, dim=1),
                                              cw)
        c1, dist1 = make_dp_lloyd_step(make_mesh(1, device=dev))(
            [x.to(dev)], cw)
        # a row whose two nearest centres lie closer than the f32
        # rounding of its distances (|x|^2 + |c|^2 scale) may take either
        # label: the centres it touches are not compared
        xd, cd = x.to(dev, torch.float64), cw.to(torch.float64)
        d2 = ((xd[:, :, None, :] - cd[:, None]) ** 2).sum(-1)
        two = torch.topk(d2, 2, dim=2, largest=False)
        scale = (xd * xd).sum(-1) + (cd * cd).sum(-1).amax(1)[:, None]
        near = (two.values[..., 1] - two.values[..., 0]) < 1e-5 * scale
        keep = torch.ones((M_, K_), dtype=torch.bool, device=dev)
        mm, rr = torch.nonzero(near, as_tuple=True)
        keep[mm, two.indices[mm, rr, 0]] = False
        keep[mm, two.indices[mm, rr, 1]] = False
        del d2, xd, cd
        check(torch.allclose(c4[keep], c1[keep], rtol=1e-5, atol=1e-4),
              "DP Lloyd step S=4 != S=1 where the labels agree")
        check(abs(float(dist4) - float(dist1)) <= 1e-5 * abs(float(dist1)),
              "DP Lloyd distortion S=4 != S=1")
        log(f"DP Lloyd step S=4 on the {len(learn)}-row learn pool: centres "
            f"allclose to one single-shard step on {int(keep.sum())} of "
            f"{M_ * K_} (the rest touched by rows whose labels f32 "
            f"rounding may flip), distortion "
            f"{float(dist4):.6g} / {float(dist1):.6g}")

        port = free_port()
        check(init_distributed(f"127.0.0.1:{port}", 1, 0, device=dev) == 1,
              "init_distributed: world size")
        try:
            mesh_g = make_mesh(2, device=dev)
            check(mesh_g.group is not None, "the mesh has no group")
            res = []
            for m in (mesh_g, alone(mesh_g)):
                e = ShardedCompressedEngine(cw, codes_scan, m,
                                            row_to_db=order)
                res.append(e.query(q, top_k=TOP_K))
                del e
            check(all(np.array_equal(a, b) for a, b in zip(*res)),
                  "the group's gather changed the S=2 results")
        finally:
            torch.distributed.destroy_process_group()
        big_check(cw, q, codes_db, codes_db64, *res[0], N, card=True)
        log(f"init_distributed(tcp://127.0.0.1:{port}, world 1, NCCL): the "
            f"S=2 sharded engine through the group's all_gather gives the "
            f"same arrays as without the group; group destroyed")

        mesh2 = make_mesh(2, device=dev)
        t = time.perf_counter()
        ch = ChunkedCompressedEngine(cw_np, codes_scan, row_to_db=order,
                                     chunk_rows=2 ** 19, mesh=mesh2)
        log(f"ChunkedCompressedEngine(mesh=S2, chunk_rows=2**19): "
            f"{len(ch.chunks)} chunks x 2 shards, "
            f"{time.perf_counter() - t:.1f} s")
        build.reset_launch_counts()
        d, ids = ch.query(q, top_k=TOP_K)
        big_check(cw, q, codes_db, codes_db64, d, ids, N)
        with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as path:
            t = time.perf_counter()
            ch.save(path)
            back = ChunkedCompressedEngine.from_saved(path, mmap=True,
                                                      mesh=mesh2)
            t_io = time.perf_counter() - t
            d2, i2 = back.query(q, top_k=TOP_K)
        check(back.precision == ch.precision
              and all(c.precision == ch.precision for c in back.chunks),
              "from_saved(mesh=) did not keep the saved precision")
        big_check(cw, q, codes_db, codes_db64, d2, i2, N)
        counts = build.launch_counts()
        check(counts["delta_mins_int8"] == 2 * len(back.chunks) * 2,
              f"chunked mesh engine launches {counts}")
        log(f"{tag} chunked engine on S=2 ({ch.precision}): exact; save + "
            f"from_saved(mmap=True, mesh=S2) {t_io:.1f} s, exact; "
            f"first-shot {np.round(back.last_exact_fracs, 4).tolist()}")
        del ch, back

        cw_d = torch.from_numpy(dup["cw"]).to(dev)
        cdb = torch.from_numpy(pad_codes(dup["codes"], 16384)).to(dev)
        de = DedupCompressedEngine(dup["cw"], dup["codes"], mesh=mesh2)
        for _ in range(2):
            q = rng.normal(size=(B, D)).astype(np.float32)
            d, ids = de.query(q, top_k=TOP_K)
            big_check(cw_d, q, cdb, None, d, ids, N)
        log(f"DedupCompressedEngine(mesh=S2) on the dup_heavy codes "
            f"({de.n_unique} distinct, {de.engine.precision}): 2 batches "
            f"exact")
        del de, cdb
        dryrun_multichip(4, device=dev)


def alone(mesh):
    """The same shards as ``mesh``, in this process alone (no group)."""
    return type(mesh)(devices=mesh.devices, axis_names=mesh.axis_names)


def serve_window(srv, pool, idx):
    """``SERVE_CLIENTS`` client threads push the waves ``pool[idx[w]]``
    (round-robin over the clients) through the started server ``srv``,
    each client keeping ``SERVE_DEPTH`` waves in flight: it submits the
    next as soon as its oldest resolves.  Returns the results in wave
    order."""
    n = len(idx)
    out, errs = [None] * n, []

    def client(c):
        try:
            live = collections.deque()
            for w in range(c, n, SERVE_CLIENTS):
                if len(live) == SERVE_DEPTH:
                    v, f = live.popleft()
                    out[v] = f.result(timeout=120)
                live.append((w, srv.submit(pool[idx[w]])))
            for v, f in live:
                out[v] = f.result(timeout=120)
        except Exception as e:  # reported below
            errs.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVE_CLIENTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    check(not errs and all(o is not None for o in out),
          f"serving: {errs[:1]}")
    return out


def phase17_serving(dev, cw, eng, rng, codes_db, codes_db64):
    """``CoalescingServer`` over phase 5's int16 stream engine at three
    dispatch widths: a started, warm server over ``SERVE_DISPATCHES``
    dispatches' worth of waves from closed-loop clients, every served
    wave held to ``adc_query_topk``; then ``query_coalesced``."""
    with Phase("17 serving"):
        pool = rng.normal(size=(SERVE_POOL, D)).astype(np.float32)
        # each pool row's table and exact top-k, in waves of SERVE_ROWS
        tables, refs = [], []
        for r0 in range(0, SERVE_POOL, SERVE_ROWS):
            tables.append(adc_table(cw, torch.from_numpy(
                pool[r0:r0 + SERVE_ROWS]).to(dev)))
            refs.append(adc_query_topk(tables[-1], codes_db, N, TOP_K,
                                       16384))
        table_pool = torch.cat(tables)
        ref_d = torch.cat([r[0] for r in refs])
        ref_i = torch.cat([r[1] for r in refs])
        del tables, refs

        def check_waves(idx, out):
            for w0 in range(0, len(idx), 64):
                rows = torch.from_numpy(idx[w0:w0 + 64].reshape(-1)).to(dev)
                d = np.concatenate([o[0] for o in out[w0:w0 + 64]])
                ids = np.concatenate([o[1] for o in out[w0:w0 + 64]])
                check_batch(table_pool[rows], codes_db, codes_db64,
                            torch.from_numpy(d).to(dev),
                            torch.from_numpy(ids).to(dev),
                            ref=(ref_d[rows], ref_i[rows]))

        for rows in SERVE_WAVE_ROWS:
            per = rows // SERVE_ROWS                  # waves a dispatch
            idx = rng.integers(0, SERVE_POOL,
                               (SERVE_DISPATCHES * per, SERVE_ROWS))
            with CoalescingServer(eng, wave_rows=rows, max_wait_ms=2.0,
                                  top_k=TOP_K) as srv:
                warm = serve_window(srv, pool, idx[:4 * per])
                k0, r0 = srv.dispatches, srv.rows_served
                out = serve_window(srv, pool, idx)
                k, r = srv.dispatches - k0, srv.rows_served - r0
            check(r == idx.size, f"served {r} rows, not {idx.size}")
            check_waves(idx[:4 * per], warm)
            check_waves(idx, out)
            log(f"CoalescingServer wave_rows={rows}, max_wait_ms=2, "
                f"{SERVE_CLIENTS} clients x {SERVE_DEPTH} waves of "
                f"{SERVE_ROWS} in flight, {len(idx)} waves after {4 * per} "
                f"warm: {k} dispatches, {r / max(k, 1):.1f} rows a "
                f"dispatch; every wave bit-equal to adc_query_topk, ids up "
                f"to audited ties")
        waves = [pool[i] for i in idx[:SERVE_COALESCED]]
        got = query_coalesced(eng, waves, top_k=TOP_K, wave_rows=1024)
        for w, (d, _) in zip(waves, got):
            dw, _ = eng.query(w, top_k=TOP_K)
            check(np.array_equal(d, dw), "query_coalesced != per-wave query")
        check_waves(idx[:SERVE_COALESCED], got)
        log(f"query_coalesced over {SERVE_COALESCED} waves (wave_rows "
            f"1024): distances equal to the per-wave queries, bit-equal to "
            f"adc_query_topk, ids up to audited ties")


def big_check(cw, q, codes_db, codes_db64, d, ids, n, card=False):
    """Results of an engine without ``prepare`` against the plain exact
    scan over the table of the same queries: ``adc_table``'s, or with
    ``card`` the one the bf16 engines make on the card."""
    dev = codes_db.device
    if codes_db64 is None:
        codes_db64 = codes_db[:n].to(torch.int64)
    table = (card_table(cw, q) if card
             else adc_table(cw, torch.from_numpy(q).to(dev)))
    check_batch(table, codes_db, codes_db64, torch.from_numpy(d).to(dev),
                torch.from_numpy(ids).to(dev), n)


def card_table(cw, q):
    """The table a bf16 fused engine makes on the card for queries ``q``
    (``csrc/prepare.cu``; a query's table does not depend on its batch):
    adc_table's up to the order of its f32 sums."""
    M_, K_, Ds_ = cw.shape
    d_pad = -(-M_ * Ds_ // 128) * 128
    mu = np.zeros(d_pad, np.float32)
    mu[:M_ * Ds_] = fk.codebook_center(cw.cpu().numpy())
    b = len(q)
    return fk.fused_prepare(
        torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(cw.device),
        cw.to(torch.float32).contiguous(), torch.from_numpy(mu).to(cw.device),
        -(-b // fk.PREPARE_QB) * fk.PREPARE_QB,
        fk.grouped_layout(M_, Ds_))[0][:b]


def check_batch(table, codes_db, codes_db64, d, ids, n=N, ref=None):
    """Engine results against the plain exact scan over the same table
    (or ``ref``, its (dists, ids) computed before): distances bit-equal;
    each id carries its reported distance; id sets differ only at
    f64-audited ties of the top-k boundary.  ``d`` and ``ids`` may be on
    the host (``select`` returns them there)."""
    d, ids = d.to(table.device), ids.to(table.device)
    dr, ir = (ref if ref is not None
              else adc_query_topk(table, codes_db, n, TOP_K, 16384))
    check(torch.equal(d, dr), "distances differ from adc_query_topk")
    check(torch.equal(own_dists(table, codes_db64, ids), d),
          "an id does not carry its distance")
    audit_ties(table, codes_db64, ids, ir)


def own_dists(table, codes_db64, ids):
    """The f32 table sum of each id's code, in ascending m [B, k]."""
    Bq, Mq, _ = table.shape
    c = codes_db64[ids.clamp_min(0)]                       # [B, k, M]
    own = torch.zeros(ids.shape, dtype=torch.float32, device=ids.device)
    bi = torch.arange(Bq, device=ids.device)[:, None]
    for m in range(Mq):
        own = own + table[bi, m, c[:, :, m]]
    return own


def audit_ties(table, codes_db64, ids, ir, rtol=1e-5):
    """Id sets may differ only where the f64 distances of the top-k
    boundary tie within ``rtol``."""
    Mq = table.shape[1]
    same = torch.sort(ids, 1).values == torch.sort(ir, 1).values
    t64 = table.to(torch.float64)
    for b in torch.nonzero(~same.all(1)).flatten().tolist():
        d64 = t64[b][torch.arange(Mq, device=t64.device)[None, :],
                     codes_db64].sum(1)
        srt = torch.sort(d64).values
        gap = float((srt[TOP_K] - srt[TOP_K - 1]) / srt[TOP_K - 1].abs())
        check(gap < rtol, f"query {b}: id sets differ without a tie "
                          f"(f64 gap {gap:.3g})")


TREE_FIELDS = ("vec_id", "parent_pos", "depth", "diff_num", "diff_off",
               "diff_m", "diff_to", "child_pos_start", "child_num",
               "max_dist", "max_dist2p")


def timed(fn, *a, **k):
    """(fn's result, host wall s)."""
    t = time.perf_counter()
    out = fn(*a, **k)
    return out, time.perf_counter() - t


def sharded_step_case(dev, label, cw, codes_scan, order, q, codes_db,
                      codes_db64, n, tiles=None):
    """``make_sharded_delta_query_fn`` at the engine's first rung on 1, 2
    and 4 shards of ``dev`` over the slot tiles of ``codes_scan`` (row i
    is database row ``order[i]``), queries q [B, D] (D <= M*Ds; the rest
    zero), both over the bf16 engine's table (``card_table``).  B5
    launches once a shard.  Certified rows equal the exact
    ``ShardedCompressedEngine`` (itself held to ``adc_query_topk``);
    every row carries its own exact f32 distance, and the j-th distance
    is never below the exact j-th; at least ``SHARDED_MIN_OK[D][S]`` of
    the queries certify at S shards."""
    cw_np = cw.cpu().numpy()
    Mc, _, Dsc = cw_np.shape
    Dc = Mc * Dsc
    qp = np.zeros((len(q), Dc), np.float32)
    qp[:, :q.shape[1]] = q
    ref = ShardedCompressedEngine(cw, codes_scan, make_mesh(1, device=dev),
                                  row_to_db=order, precision="bf16")
    d_ref, i_ref = ref.query(qp, top_k=TOP_K)
    if tiles is None:
        tiles = ref.tiles
    del ref
    table = card_table(cw, qp)
    d_ref = torch.from_numpy(d_ref).to(dev)
    i_ref = torch.from_numpy(i_ref).to(dev)
    check_batch(table, codes_db, codes_db64, d_ref, i_ref, n=n)
    mu = fk.codebook_center(cw_np)
    cwbd = fk.build_blockdiag_codebook(cw_np, center=mu).to(dev)
    qc = qp - mu[None, :]
    qk = torch.from_numpy(fk.pack_query_grouped(qc, Mc, Dsc)).to(dev)
    qk = qk.to(torch.bfloat16).t().contiguous()
    q2 = torch.from_numpy((qc * qc).sum(axis=1)).to(dev)
    rd_t = torch.from_numpy(tiles.row_data).to(dev)
    ovf_t = torch.from_numpy(tiles.ovf).to(dev)
    order_t = torch.from_numpy(order).to(dev)
    check(tiles.n_tiles % max(SHARDS) == 0,
          f"{label}: {tiles.n_tiles} tiles do not split over the shards")
    for S in SHARDS:
        plan = rung_plan(tiles.n_tiles // S * (fk.TILE // fk.SUB), TOP_K,
                         len(q))
        ns = plan.rungs[0]
        fn = make_sharded_delta_query_fn(make_mesh(S, device=dev), TOP_K,
                                         ns, plan.pool, tiles.S, Ds=Dsc)
        build.reset_launch_counts()
        d, rows, ok = fn(qk, q2, table, cwbd, rd_t, ovf_t, n)
        counts = build.launch_counts()
        live = sum(1 for g in range(S)
                   if g * (tiles.n_tiles // S) * fk.TILE < n)
        check(counts["delta_mins_bf16"] == live and counts["rerank"] >= live,
              f"{label} S={S}: B5 once a non-empty shard, B2 at least as "
              f"often: {counts}")
        ids = torch.where(rows >= 0, order_t[rows.clamp_min(0)], -1)
        check(torch.equal(d[ok], d_ref[ok]),
              f"{label} S={S}: certified distances != "
              f"ShardedCompressedEngine")
        audit_ties(table[ok], codes_db64, ids[ok], i_ref[ok])
        fin = torch.isfinite(d)
        check(bool((ids[fin] >= 0).all()) and torch.equal(
            own_dists(table, codes_db64, ids)[fin], d[fin]),
            f"{label} S={S}: a returned row does not carry its exact f32 "
            f"distance")
        check(bool((d >= d_ref).all()),
              f"{label} S={S}: a j-th distance below the exact j-th")
        okf = float(ok.float().mean())
        check(okf >= SHARDED_MIN_OK[q.shape[1]][S],
              f"{label} S={S}: only {okf:.4f} of the queries certified")
        log(f"make_sharded_delta_query_fn {label} N={n} S={S} (n_sub {ns}, "
            f"pool {plan.pool}): ok {okf:.4f}; B5 "
            f"{counts['delta_mins_bf16']}, B2 {counts['rerank']}; certified "
            f"rows equal to ShardedCompressedEngine (ids up to audited "
            f"ties), every row its own exact distance, none below the "
            f"exact j-th")


def phase18_rest(dev, tag, cw, codes, order, res, tree, bpv3, dt, legacy_x,
                 codes_db, codes_db64):
    """The last of the package on phase 3's data: the native library
    against the Python loops, the exact-MST tree, the rotation, the
    block-aware size, the bit and row-store formats and their queries,
    the legacy prefix tree, the one-rung sharded step and ``entry``.
    Its draws come from a generator of its own, so the later phases
    draw what they drew before it ran."""
    with Phase("18 the rest of the package"):
        rng = np.random.default_rng(18)
        cw_np = cw.cpu().numpy()
        check(have_native(), "the native library did not build on this "
                             "host (g++ -O3 -march=native)")
        log(f"native library: {native_build.lib_path()}")

        # -- native against the Python loops, on phase 3's tree --------
        tn, t_nat = timed(build_layout, codes, res.edges, res.root_id, K=K,
                          tables="skip")
        saved = tree_layout.dfs_layout_native
        tree_layout.dfs_layout_native = lambda *a: None
        try:
            tp, t_py = timed(build_layout, codes, res.edges, res.root_id,
                             K=K, tables="skip")
        finally:
            tree_layout.dfs_layout_native = saved
        for f in TREE_FIELDS:
            check(np.array_equal(getattr(tn, f), getattr(tp, f)),
                  f"build_layout: native and Python {f} differ")
        log(f"{tag} build_layout (N={N}): native DFS {t_nat:.3f} s, Python "
            f"DFS {t_py:.3f} s; every DeltaTree array equal")
        stream = np.frombuffer(serialize_dtc(tn), np.uint8)
        pn, t_pn = timed(deserialize_dtc, stream, N, M)
        pp, t_pp = timed(deserialize_dtc, stream, N, M, use_native=False)
        check(all(a.dtype == b.dtype and np.array_equal(a, b)
                  for a, b in zip(pn, pp)), "DTC parse: native != Python")
        dn, t_dn = timed(decode_dtc_to_codes, stream, N, M)
        dp, t_dp = timed(decode_dtc_to_codes, stream, N, M, use_native=False)
        check(np.array_equal(dn, dp) and np.array_equal(dn, codes[order]),
              "DTC decode: native != Python or not lossless")
        ds = np.frombuffer(serialize_diff_index(codes), np.uint8)
        xn, t_xn = timed(diff_index_decode_native, ds, N, M)
        xp, t_xp = timed(decode_diff_index, ds, N, M, K)
        check(np.array_equal(xn, xp) and np.array_equal(xn, codes),
              "diff index decode: native != Python or not lossless")
        log(f"{tag} DTC stream {len(stream)} bytes: parse native "
            f"{t_pn:.4f} s / Python {t_pp:.3f} s, decode native {t_dn:.4f} s "
            f"/ Python {t_dp:.3f} s; diff index {len(ds)} bytes: decode "
            f"native {t_xn:.4f} s / Python {t_xp:.3f} s; byte-equal")
        q8 = rng.normal(size=(8, D)).astype(np.float32)
        table = adc_table(cw, torch.from_numpy(q8).to(dev))
        dr, ir = adc_query_topk(table, codes_db, N, TOP_K, 16384)
        tab_np = table.cpu().numpy()
        scans = [scan_query_native(stream, N, M, K, tab_np[b], TOP_K)
                 for b in range(8)]
        d_n = np.stack([s[0] for s in scans])
        ids_n = np.stack([tn.vec_id[s[1]] for s in scans]).astype(np.int64)
        check(np.allclose(d_n, dr.cpu().numpy(), rtol=1e-5, atol=0),
              "scan_query_native distances vs adc_query_topk")
        audit_ties(table, codes_db64, torch.from_numpy(ids_n).to(dev), ir,
                   rtol=1e-5)
        log(f"scan_query_native, 8 queries over the DTC stream: distances "
            f"within rtol 1e-5 of adc_query_topk "
            f"(max |d| diff {float(np.abs(d_n - dr.cpu().numpy()).max()):.3g}"
            f"), ids up to audited ties")
        del tp, pn, pp, dn, dp, ds, xn, xp

        # -- the exact-MST tree ----------------------------------------
        cm = codes[:MST_N]
        mst, t_mst = timed(find_edges_exact_mst, cm, K)
        ra, t_ra = timed(find_edges_by_diff, cm, K=K, method=1)
        kids = mst.edges[:, 1].astype(np.int64)
        check(len(mst.edges) == MST_N - 1
              and len(np.unique(kids)) == MST_N - 1
              and mst.root_id not in set(kids.tolist()),
              "the exact-MST tree does not span")
        check(mst.n_diffs <= ra.n_diffs,
              "the exact MST has more diffs than the approximate tree")
        tm = build_layout(cm, mst.edges, mst.root_id, K=K, tables="skip")
        h_before = tree_height(mst.edges, mst.root_id, MST_N)
        s_m, t_ser = timed(serialize_dtc, tm)          # repairs tm in place
        check(int(tm.depth.max()) <= 15, "repair left depth > 15")
        om = tm.vec_id.astype(np.int64)
        check(np.array_equal(decode_dtc_to_codes(
            np.frombuffer(s_m, np.uint8), MST_N, M), cm[om]),
            "the exact-MST DTC is not lossless")
        ta = build_layout(cm, ra.edges, ra.root_id, K=K, tables="skip")
        s_a = serialize_dtc(ta)
        em = FusedCompressedEngine(cw, cm[om], row_to_db=om,
                                   precision="int16", device=dev)
        bpv_a = build_stream_tiles(
            cm[ta.vec_id.astype(np.int64)]).bytes_per_vec()
        log(f"{tag} exact MST (N={MST_N}, cut): edges {t_mst:.2f} s "
            f"(approximate {t_ra:.2f} s), diffs {mst.n_diffs} (approximate "
            f"{ra.n_diffs}), height {h_before} -> {int(tm.depth.max())} by "
            f"serialize_dtc's repair ({t_ser:.2f} s); DTC B/vec "
            f"{len(s_m) / MST_N:.4f} (approximate {len(s_a) / MST_N:.4f}); "
            f"stream tiles B/vec {em.bytes_per_vec():.4f} (approximate "
            f"{bpv_a:.4f}; phase 3's approximate tree at N={N}: "
            f"{bpv3:.4f}); lossless")
        build.reset_launch_counts()
        for _ in range(2):
            q = rng.normal(size=(B, D)).astype(np.float32)
            table, qop, uq, cert, b = em.prepare(q)
            mins, echo = em.scan(qop, uq)
            d, ids = em.select(table, cert, mins, echo, b, TOP_K)
            check_batch(table[:b], codes_db, codes_db64[:MST_N], d, ids,
                        n=MST_N)
        counts = build.launch_counts()
        check(counts["stream_mins"] > 0 and counts["ladder"] > 0,
              f"the exact-MST engine's kernels: {counts}")
        log(f"int16 engine over its DFS order: 2 batches of {B} bit-equal "
            f"to adc_query_topk; launches B1 {counts['stream_mins']}, B2' "
            f"{counts['ladder']}")
        del em, mins, echo, tm, ta, mst, ra

        # -- rotation, block-aware size, bit format (cut) --------------
        cr = codes[:ROTATE_N]
        mr = find_edges_exact_mst(cr, K)
        h, t_h = timed(tree_height, mr.edges, mr.root_id, ROTATE_N)
        (oe, root2, h2), t_rot = timed(rotate_tree, mr.edges, mr.root_id,
                                       ROTATE_N)
        check(h2 <= h and tree_height(oe, root2, ROTATE_N) == h2,
              "rotate_tree did not lower the height")
        log(f"{tag} tree_height / rotate_tree (exact MST, N={ROTATE_N}, "
            f"cut): height {h} -> {h2}, {t_h:.3f} s / {t_rot:.3f} s")
        bas, t_bas = timed(block_aware_size, tree)
        log(f"{tag} block_aware_size (phase 3's tree): {bas['blocks']} "
            f"blocks of 4096 B = {bas['bytes']} B "
            f"({bas['bytes'] / N:.4f} B/vec; plain {bas['plain_bytes']}), "
            f"{t_bas:.3f} s")
        rb = find_edges_by_diff(cr, K=K, method=1)
        tb = build_layout(cr, rb.edges, rb.root_id, K=K, tables="skip")
        check(int(tb.depth.max()) <= 7, "the bit format's depth field "
                                        "holds 3 bits")
        (bs, n_bits), t_bs = timed(serialize_bits, tb)
        cb, t_bd = timed(deserialize_bits, bs, n_bits, ROTATE_N, M)
        check(np.array_equal(cb, cr[tb.vec_id.astype(np.int64)]),
              "the bit format is not lossless")
        q = rng.normal(size=(B, D)).astype(np.float32)
        d, ids = query_bits(bs, n_bits, ROTATE_N, M, cw_np, q, tb.vec_id,
                            top_k=TOP_K, device=dev)
        big_check(cw, q, codes_db, codes_db64[:ROTATE_N], d, ids, ROTATE_N)
        log(f"{tag} bit format (N={ROTATE_N}, cut): {n_bits} bits, write "
            f"{t_bs:.2f} s, read {t_bd:.2f} s, lossless; query_bits B={B} "
            f"bit-equal to adc_query_topk")

        # -- row store --------------------------------------------------
        raw = rng.integers(0, 256, (N, RAW_D), dtype=np.uint8)
        rs, t_rw = timed(serialize_dtc_row_store, tree, raw)
        check(len(rs) == len(stream) + N * RAW_D, "row-store size")
        (cr_, raw_r), t_rr = timed(deserialize_dtc_row_store, rs, N, M,
                                   RAW_D)
        check(np.array_equal(cr_, codes[order])
              and np.array_equal(raw_r, raw[order]),
              "the row store is not lossless")
        d, ids, rows = query_row_store(rs, N, M, RAW_D, cw_np, q,
                                       tree.vec_id, top_k=TOP_K, device=dev)
        big_check(cw, q, codes_db, codes_db64, d, ids, N)
        check(np.array_equal(rows, raw[ids]), "row store: raw rows")
        log(f"{tag} row store (N={N}, {RAW_D} raw B a row): {len(rs)} "
            f"bytes, write {t_rw:.2f} s, read {t_rr:.2f} s, lossless; "
            f"query_row_store B={B} distances bit-equal to "
            f"adc_query_topk, raw rows = raw[ids]")
        del rs, raw, raw_r, cr_, stream

        # -- legacy prefix tree (cut) ----------------------------------
        cw2, t_dich = timed(dichotomize_codewords, cw_np, device=dev)
        for m in range(M):
            check(np.array_equal(np.unique(cw2[m], axis=0),
                                 np.unique(cw_np[m], axis=0)),
                  "dichotomize_codewords is not a permutation")
        codes2 = pq_encode(torch.from_numpy(cw2).to(dev),
                           legacy_x).cpu().numpy()
        store = BitVecsStore(codes2)
        ql = legacy_x[rng.integers(0, LEGACY_N, 16)] + 0.02
        d1, _ = query_plain(cw2, ql, codes2, top_k=1, engine="xla",
                            device=dev)
        nodes = []
        for b in range(len(ql)):
            _, dist, st = prefix_tree_query(store, cw2, ql[b],
                                            codes_db=codes2)
            check(abs(dist - float(d1[b, 0])) < 1e-3,
                  f"prefix_tree_query top-1 {dist} != {float(d1[b, 0])}")
            nodes.append(st["nodes_expanded"])
        log(f"{tag} legacy (N={LEGACY_N}, cut): dichotomize_codewords on "
            f"the card {t_dich:.2f} s; 16 prefix_tree_query, nodes expanded "
            f"{min(nodes)}-{max(nodes)}; top-1 within 1e-3 of query_plain")

        # -- the one-rung sharded step over phase 8's slot tiles --------
        ql = (legacy_x[rng.integers(0, LEGACY_N, B)]
              + rng.normal(size=(B, D)).astype(np.float32) * QUERY_SIGMA)
        sharded_step_case(dev, f"D={D}", cw, codes[order], order, ql,
                          codes_db, codes_db64, N, tiles=dt)
        # D not divisible by M: pq_learn pads D up to M*Ds with zeros, so
        # the block-diagonal codebook's last columns are zero
        xs = np.ascontiguousarray(legacy_x[:, :ODD_D])
        gen = torch.Generator(device=dev).manual_seed(18)
        cw_o = pq_learn(gen, xs, M=M, K=K, max_iters=20, n_init=1,
                        device=dev)
        Ds_o = cw_o.shape[2]
        check(Ds_o * M > ODD_D and not bool(cw_o[M - 1, :, ODD_D - (M - 1)
                                                   * Ds_o:].any()),
              "pq_learn did not zero-pad the last subspace")
        codes_o = pq_encode(cw_o, xs).cpu().numpy()
        order_o = np.lexsort(codes_o.T[::-1])
        db_o = torch.from_numpy(pad_codes(codes_o, 16384)).to(dev)
        qo = (xs[rng.integers(0, LEGACY_N, B)]
              + rng.normal(size=(B, ODD_D)).astype(np.float32) * QUERY_SIGMA)
        sharded_step_case(dev, f"D={ODD_D} (Ds {Ds_o}, zero-padded)",
                          cw_o, codes_o[order_o], order_o, qo, db_o,
                          db_o[:LEGACY_N].to(torch.int64), LEGACY_N)

        # -- entry ------------------------------------------------------
        fwd, args = flagship.entry(device=dev)
        build.reset_launch_counts()
        d, rows = fwd(*args)
        counts = build.launch_counts()
        check(counts["delta_mins_bf16"] > 0 and counts["rerank"] > 0,
              f"entry's fwd: {counts}")
        d2, rows2, ok = flagship.step(*args)
        check(torch.equal(d, d2) and torch.equal(rows, rows2),
              "entry: fwd != step")
        ce = decode_delta_tiles(DeltaTiles(
            row_data=args[4].cpu().numpy(), ovf=args[5].cpu().numpy(),
            n_valid=flagship.N, M=M, S=args[4].shape[1] - 1,
            Cap=args[5].shape[2]))
        te = adc_table(args[0], args[1])
        ce_t = torch.from_numpy(ce).to(dev)
        dr, ir = adc_query_topk(te, ce_t, flagship.N, TOP_K, 1024)
        check(ok.any() and torch.equal(d[ok], dr[ok]),
              "entry: certified distances != adc_query_topk")
        audit_ties(te[ok], ce_t.to(torch.int64), rows[ok], ir[ok])
        log(f"entry(): ok {float(ok.float().mean()):.4f}; B5 "
            f"{counts['delta_mins_bf16']},"
            f" B2 {counts['rerank']}; certified distances bit-equal to "
            f"adc_query_topk, rows up to audited ties")


if __name__ == "__main__":
    sys.exit(main())
