"""Scan-kernel benchmark: B1 beside B3, B5 and B4 on one card, in one run.

Usage:  python3 -m deltapq_tpu_torch.bench_stream [N] [B ...]
        python3 -m deltapq_tpu_torch.bench_stream gist [N] [B]

The first form: the sift_like workload (``synth.make_clustered_codes``:
clustered 128-d vectors, PQ M=8, K=256 learned on 20,000 rows, seed 0)
in lexsort order (no tree build, so the run is short; DFS order
compresses a little better and decodes the same way).  For every batch
size (default 64 and 512) and every scan mode it times, with CUDA
events,

* B1 ``fused_stream_mins`` on the stream tiles,
* B3 ``fused_codes_mins`` on B1's echoed codes -- the scan without the
  decode,
* B5 ``fused_delta_mins`` on the slot tiles of the same rows,

and holds B3's and B5's mins against B1's: bit for bit at int8 and
int16, max |difference| printed at bf16.  At B=64 one query block is
all a tile has, so a block's fixed work (codebook load, decode) is what
the time shows; a one-tile engine gives the floor under it, the
wrapper's host time and the launch.  Then B4 ``fused_decoded_mins`` on
the decoded bf16 rows beside its ``torch.mm`` yardstick (the cross
product alone, no minima), and B4 again at the GIST width (D=1024) on
random rows.

The ``gist`` form: the GIST-shape workload (``synth.make_gist_workload``,
M=16, K=256, Ds=60, default N 1,000,000, B 512) in the DFS order of its
M=16 DeltaTree (``bench_gist.tree_order``), B1, B3 and B5 as above in
the three modes (all three on the gathered ``wgmma`` tail there), then B1 and
B3 on a near-distinct code set of N/4 rows (the same codebook over
``gist_vectors`` of N/8 clusters, seed 1, lexsort order).

A kernel that does not launch, or integer mins that differ, fail the
run.  The script runs against any tree of the port whose engines take
these arguments, so one card can time two versions of the kernels with
it.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import resolve_device
from .bench_engines import cuda_ms
from .ops import fused_kernels as fk
from .ops.delta_tiles import build_delta_tiles
from .ops.fused import (FusedCodesEngine, FusedCompressedEngine,
                        FusedDecodedEngine)
from .ops.stream_tiles import build_stream_tiles
from .synth import WORKLOADS, make_clustered_codes

M, K, D = 8, 256, 128
GIST_D = 1024


def mm_yardstick(xt: torch.Tensor, q: torch.Tensor):
    """One ``torch.mm`` of the bf16 rows [N, D] with the bf16 queries
    [D, B] into f32 (into bf16 on the CPU, or where ``torch.mm`` takes no
    ``out_dtype``): the cross product of the decoded scan, without its
    norms and minima.  A yardstick only; no scan path calls it."""
    x = xt.reshape(-1, xt.shape[-1])
    if x.is_cuda:
        try:
            return torch.mm(x, q, out_dtype=torch.float32)
        except TypeError:        # this PyTorch's mm has no out_dtype
            pass
    return torch.mm(x, q)        # the same product, rounded to bf16


def _cut_batch(e, q, b):
    """The engine's scan operands for exactly ``b`` queries (``prepare``
    pads the batch to a multiple of 128)."""
    _, qop, uq, _, _ = e.prepare(q)
    qop = qop[:, :b].contiguous()
    return qop, None if uq is None else uq[..., :b].contiguous()


def scan_trio(card, label, prec, e1, e3, e5, q, b, timer, reps):
    """B1 on its stream tiles, B3 on B1's echo and (when ``e5`` is not
    None) B5 on the slot tiles of the same rows, timed in turns; B3's and
    B5's mins held to B1's (bit for bit at int8 and int16)."""
    qop, uq = _cut_batch(e1, q, b)
    m1, echo = e1.scan(qop, uq)
    e3.codes = echo
    others = [("B3", e3)] + ([("B5", e5)] if e5 is not None else [])
    same = []
    for name, e in others:
        m, _ = e.scan(qop, uq)
        if prec == "bf16":
            fin = torch.isfinite(m1)
            same.append(f"max |B1 - {name}| "
                        f"{float((m1 - m)[fin].abs().max()):.6g}")
        elif not torch.equal(m1, m):
            raise AssertionError(f"{label} {prec} B={b}: B1 != {name}")
        else:
            same.append(f"B1 = {name} bit for bit")
    times = {"B1": timer(lambda: e1.scan(qop, uq), reps)}
    for name, e in others:
        times[name] = timer(lambda: e.scan(qop, uq), reps)
    shown = ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
    print(f"[{card}] {label} {prec} B={b}: {shown}; {'; '.join(same)}",
          flush=True)


def main(argv=None, device=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(device)
    card = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain versions; no device time)")
    timer = cuda_ms if dev.type == "cuda" else (lambda fn, reps: float("nan"))
    if argv and argv[0] == "gist":
        return gist(argv[1:], dev, card, timer)
    n = int(argv[0]) if argv else 1 << 20
    batches = [int(a) for a in argv[1:]] or [64, 512]
    cw, codes = make_clustered_codes(n, M, K, device=dev,
                                     **WORKLOADS["sift_like"])
    cw, codes = cw.cpu().numpy(), codes.cpu().numpy()
    codes = codes[np.lexsort(codes.T[::-1])]
    st, dt = build_stream_tiles(codes), build_delta_tiles(codes)
    rng = np.random.default_rng(1)
    print(f"[{card}] sift_like N={n}, M={M}, K={K}, D={D}, lexsort order; "
          f"slot tiles S {dt.S}, Cap {dt.Cap}", flush=True)
    for prec in ("int16", "int8", "bf16"):
        e1 = FusedCompressedEngine.from_tiles(cw, st, precision=prec,
                                              device=dev)
        e3 = FusedCodesEngine(cw, codes, precision=prec, device=dev)
        e5 = FusedCompressedEngine.from_tiles(cw, dt, precision=prec,
                                              device=dev)
        for b in batches:
            q = rng.normal(size=(b, D)).astype(np.float32)
            scan_trio(card, "sift_like", prec, e1, e3, e5, q, b, timer, 20)
        # one tile and a few queries: what is left is the launch and the
        # wrapper's host time
        e0 = FusedCompressedEngine(cw, codes[:1024], precision=prec,
                                   device=dev)
        qop, uq = _cut_batch(e0, q[:8], 8)
        ms0 = timer(lambda: e0.scan(qop, uq), 50)
        print(f"[{card}] {prec} B=8, one tile: B1 {ms0:.4f} ms (the launch "
              f"and the wrapper's host time)", flush=True)
        del e0, e1, e3, e5
    e4 = FusedDecodedEngine(cw, codes, device=dev)
    for b in batches:
        q = rng.normal(size=(b, D)).astype(np.float32)
        qop, uq = _cut_batch(e4, q, b)
        e4.scan(qop, uq)
        ms4 = timer(lambda: e4.scan(qop, uq), 20)
        lib = timer(lambda: mm_yardstick(e4.xt, qop), 20)
        print(f"[{card}] decoded B={qop.shape[1]}: B4 {ms4:.4f} ms, torch.mm "
              f"(cross product alone) {lib:.4f} ms", flush=True)
    del e4
    # B4 at the GIST width: 960 dims padded to 1024, random bf16 rows (the
    # product's time does not depend on the values)
    gen = torch.Generator(device=dev).manual_seed(0)
    nt = -(-n // 8192)
    xt = torch.randn((nt, 8192, GIST_D), generator=gen, device=dev
                     ).to(torch.bfloat16)
    for b in batches:
        qop = torch.randn((GIST_D, b), generator=gen, device=dev
                          ).to(torch.bfloat16)
        fk.fused_decoded_mins(qop, xt, n)
        ms4 = timer(lambda: fk.fused_decoded_mins(qop, xt, n), 5)
        lib = timer(lambda: mm_yardstick(xt, qop), 5)
        print(f"[{card}] decoded D={GIST_D} B={b}: B4 {ms4:.4f} ms, torch.mm "
              f"(cross product alone) {lib:.4f} ms", flush=True)
    return 0


def gist(argv, dev, card, timer) -> int:
    """The ``gist`` form (module docstring)."""
    from . import bench_gist
    from .ops.encode import pq_encode
    from .synth import gist_vectors, make_gist_workload

    n = int(argv[0]) if argv else 1_000_000
    b = int(argv[1]) if len(argv) > 1 else 512
    cw, codes, x = make_gist_workload(n, bench_gist.M, bench_gist.K,
                                      bench_gist.DS, device=dev)
    del x
    order, _, _ = bench_gist.tree_order(codes)
    codes = codes[order]
    st, dt = build_stream_tiles(codes), build_delta_tiles(codes)
    n2 = n // 4
    x2 = gist_vectors(n2, bench_gist.D, n_clusters=max(1, n2 // 2), seed=1)
    codes2 = pq_encode(torch.from_numpy(cw).to(dev), x2,
                       batch_size=65536).cpu().numpy()
    del x2
    codes2 = codes2[np.lexsort(codes2.T[::-1])]
    st2 = build_stream_tiles(codes2)
    print(f"[{card}] GIST shape N={n}, M={bench_gist.M}, Ds={bench_gist.DS}, "
          f"DFS order, {len(np.unique(codes, axis=0))} distinct codes; "
          f"slot tiles S {dt.S}, Cap {dt.Cap}; near-distinct set N={n2}, "
          f"{len(np.unique(codes2, axis=0))} distinct, lexsort order",
          flush=True)
    rng = np.random.default_rng(1)
    q = rng.normal(size=(b, bench_gist.D)).astype(np.float32) * 4
    for prec in ("int16", "int8", "bf16"):
        e1 = FusedCompressedEngine.from_tiles(cw, st, precision=prec,
                                              device=dev)
        e3 = FusedCodesEngine(cw, codes, precision=prec, device=dev)
        e5 = FusedCompressedEngine.from_tiles(cw, dt, precision=prec,
                                              device=dev)
        scan_trio(card, "gist", prec, e1, e3, e5, q, b, timer, 5)
        del e1, e3, e5
        e1 = FusedCompressedEngine.from_tiles(cw, st2, precision=prec,
                                              device=dev)
        e3 = FusedCodesEngine(cw, codes2, precision=prec, device=dev)
        scan_trio(card, "gist near-distinct", prec, e1, e3, None, q, b,
                  timer, 5)
        del e1, e3
    return 0


if __name__ == "__main__":
    sys.exit(main())
