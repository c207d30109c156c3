"""ADC lookup-kernel benchmark: B6 in its three modes beside B9 and B8.

Usage:  python3 -m deltapq_tpu_torch.bench_adc [N] [B]

The engine benchmark's workload (``bench_engines.workload``: random
codewords, clustered codes, M=8, K=256; default N 1,048,576, B 512),
top-10 in 4096-row tiles, as ``query_plain`` runs it, once in the
workload's own order and once sorted (``np.lexsort``, neighbouring rows
sharing codes as a DFS order makes them).  For each order and precision
it times, with CUDA events,

* B6 ``adc_topk_tiles`` -- distances and the tile-local top-k,
* B9 ``adc_topk_packed_tiles`` -- the same lookups, selected on packed
  keys,

and B8 ``adc_dists_pallas`` (the f32 lookups alone, into a [B, N]
matrix) once an order.  B6's output is held to its plain version
bit for bit in every mode (the plain version runs once a mode); a kernel
that does not launch, or that differs, fails the run.  The script only
calls entry points that every tree of the port has had since B6 was
ported, so one card can time two versions of the kernels with it.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from . import resolve_device
from .bench_engines import cuda_ms, workload
from .ops import adc_kernels as ak
from .ops.adc import adc_table, pad_codes

TOP_K, TILE = 10, 4096


def card_line(dev) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if dev.type != "cuda":
        return "cpu (plain versions; no device time)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None, device=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    dev = resolve_device(device)
    n = int(argv[0]) if argv else 1 << 20
    b = int(argv[1]) if len(argv) > 1 else 512
    card = card_line(dev)
    timer = cuda_ms if dev.type == "cuda" else (lambda fn, reps: float("nan"))
    cw, codes_np, q = workload(n, b)
    tab = adc_table(torch.from_numpy(cw).to(dev), torch.from_numpy(q).to(dev))
    print(f"[{card}] engine benchmark workload N={n}, B={b}, top-{TOP_K}, "
          f"tile {TILE}", flush=True)
    for order in ("unordered", "lexsort"):
        rows = (codes_np if order == "unordered"
                else codes_np[np.lexsort(codes_np.T[::-1])])
        codes = torch.from_numpy(pad_codes(rows, TILE)).to(dev)
        for prec in ak.PRECISIONS:
            d, i = ak.adc_topk_tiles(tab, codes, n, TOP_K, TILE, prec)
            rd, ri = ak.adc_topk_tiles_ref(tab, codes, n, TOP_K, TILE, prec)
            if not (torch.equal(d, rd) and torch.equal(i, ri)):
                raise AssertionError(f"B6 {prec} ({order}) differs from its "
                                     f"plain version")
            del d, i, rd, ri
            b6 = timer(lambda: ak.adc_topk_tiles(tab, codes, n, TOP_K, TILE,
                                                 prec), 10)
            b9 = timer(lambda: ak.adc_topk_packed_tiles(
                tab, codes, n, TOP_K, TILE, prec), 10)
            print(f"[{card}] {order} {prec}: B6 {b6:.4f} ms (bit-equal to "
                  f"its plain version), B9 {b9:.4f} ms", flush=True)
        b8 = timer(lambda: ak.adc_dists_pallas(tab, codes), 5)
        print(f"[{card}] {order}: B8 {b8:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
