"""Scan-kernel benchmark: B1 beside B3 and B4 on one card, in one run.

Usage:  python3 -m deltapq_tpu_torch.bench_stream [N] [B ...]

The sift_like workload (``synth.make_clustered_codes``: clustered 128-d
vectors, PQ M=8, K=256 learned on 20,000 rows, seed 0) in lexsort order
(no tree build, so the run is short; DFS order compresses a little
better and decodes the same way).  For every batch size (default 64 and
512) and every scan mode it times, with CUDA events,

* B1 ``fused_stream_mins`` on the stream tiles,
* B3 ``fused_codes_mins`` on B1's echoed codes -- the scan tail without
  the decode,

and holds B1's mins against B3's: bit for bit at int8 and int16, max
|difference| printed at bf16.  At B=64 one query block is all a tile
has, so a block's fixed work (codebook load, decode) is what the time
shows; a one-tile engine gives the floor under it, the wrapper's host
time and the launch.  Then B4 ``fused_decoded_mins`` on the decoded bf16 rows beside
its ``torch.mm`` yardstick (the cross product alone, no minima), and B4
again at the GIST width (D=1024) on random rows.  A kernel that does not
launch fails the run.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import resolve_device
from .bench_engines import cuda_ms
from .ops import fused_kernels as fk
from .ops.fused import (FusedCodesEngine, FusedCompressedEngine,
                        FusedDecodedEngine)
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


def main(argv=None, device=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    n = int(argv[0]) if argv else 1 << 20
    batches = [int(a) for a in argv[1:]] or [64, 512]
    dev = resolve_device(device)
    card = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain versions; no device time)")
    cw, codes = make_clustered_codes(n, M, K, device=dev,
                                     **WORKLOADS["sift_like"])
    cw, codes = cw.cpu().numpy(), codes.cpu().numpy()
    codes = codes[np.lexsort(codes.T[::-1])]
    rng = np.random.default_rng(1)
    timer = cuda_ms if dev.type == "cuda" else (lambda fn, reps: float("nan"))
    print(f"[{card}] sift_like N={n}, M={M}, K={K}, D={D}, lexsort order",
          flush=True)
    for prec in ("int16", "int8", "bf16"):
        e1 = FusedCompressedEngine(cw, codes, precision=prec, device=dev)
        e3 = FusedCodesEngine(cw, codes, precision=prec, device=dev)
        for b in batches:
            q = rng.normal(size=(b, D)).astype(np.float32)
            _, qop, uq, _, _ = e1.prepare(q)
            # prepare pads the batch to a multiple of 128: cut it back
            qop = qop[:, :b].contiguous()
            uq = None if uq is None else uq[..., :b].contiguous()
            m1, echo = e1.scan(qop, uq)
            e3.codes = echo
            m3, _ = e3.scan(qop, uq)
            if prec == "bf16":
                fin = torch.isfinite(m3)
                same = f"max |B1 - B3| {float((m1 - m3)[fin].abs().max()):.6g}"
            else:
                if not torch.equal(m1, m3):
                    raise AssertionError(f"{prec} B={b}: B1 != B3")
                same = "B1 = B3 bit for bit"
            ms1 = timer(lambda: e1.scan(qop, uq), 20)
            ms3 = timer(lambda: e3.scan(qop, uq), 20)
            print(f"[{card}] {prec} B={qop.shape[1]}: B1 {ms1:.4f} ms, B3 "
                  f"{ms3:.4f} ms; {same}", flush=True)
        # one tile and a few queries: what is left is the launch and the
        # wrapper's host time
        e0 = FusedCompressedEngine(cw, codes[:1024], precision=prec,
                                   device=dev)
        _, qop, uq, _, _ = e0.prepare(q[:8])
        qop = qop[:, :8].contiguous()
        uq = None if uq is None else uq[..., :8].contiguous()
        ms0 = timer(lambda: e0.scan(qop, uq), 50)
        print(f"[{card}] {prec} B=8, one tile: B1 {ms0:.4f} ms (the launch "
              f"and the wrapper's host time)", flush=True)
        del e0, e1, e3
    e4 = FusedDecodedEngine(cw, codes, device=dev)
    for b in batches:
        q = rng.normal(size=(b, D)).astype(np.float32)
        _, qop, uq, _, _ = e4.prepare(q)
        qop = qop[:, :b].contiguous()
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


if __name__ == "__main__":
    sys.exit(main())
