"""ADC lookup-kernel benchmark: B6 and B9 in their three modes, B8 and B10.

Usage:  python3 -m deltapq_tpu_torch.bench_adc [N] [B]

The engine benchmark's workload (``bench_engines.workload``: random
codewords, clustered codes, M=8, K=256; default N 1,048,576, B 512),
top-10 in 4096-row tiles, as ``query_plain`` runs it, once in the
workload's own order and once sorted (``np.lexsort``, neighbouring rows
sharing codes as a DFS order makes them).  For each order and precision
it times, with CUDA events,

* B6 ``adc_topk_tiles`` -- distances and the tile-local top-k,
* B9 ``adc_topk_packed_tiles`` -- the same lookups, selected on packed
  keys (its time over B6's is printed),

and once an order B8 ``adc_dists_pallas`` (the f32 lookups alone, into a
[B, N] matrix) and B10 ``adc_topk_tiledict_tiles`` (tile 2048, the
tile dictionaries of those rows at most 256 wide: the workload is not
the duplicate-heavy one B10 is made for, so this times the kernel, not
the format).  B6's, B9's and B10's outputs are held to their plain
versions bit for bit (the plain version runs once a mode); a kernel that
does not launch, or that differs, fails the run.

Last, B10 where its format is meant to pay: the dup_heavy codes
(``bench.py``'s recipe, ``synth.make_clustered_codes`` with
``WORKLOADS["dup_heavy"]``, PQ learned on the first 20,000 rows), sorted
(``np.lexsort``: no tree build), whose 2048-row tiles have narrow
dictionaries (the width is printed); B9 f32 on the codes of the same rows
is timed beside it, and the two give the same keys bit for bit.

The script only calls entry points that every tree of the port has had
since B6 was ported, so one card can time two versions of the kernels
with it.
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
from .synth import WORKLOADS, make_clustered_codes

TOP_K, TILE, DICT_TILE = 10, 4096, 2048


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
            keys = ak.adc_topk_packed_tiles(tab, codes, n, TOP_K, TILE, prec)
            if not torch.equal(keys, ak.adc_topk_packed_tiles_ref(
                    tab, codes, n, TOP_K, TILE, prec)):
                raise AssertionError(f"B9 {prec} ({order}) differs from its "
                                     f"plain version")
            del keys
            b6 = timer(lambda: ak.adc_topk_tiles(tab, codes, n, TOP_K, TILE,
                                                 prec), 10)
            b9 = timer(lambda: ak.adc_topk_packed_tiles(
                tab, codes, n, TOP_K, TILE, prec), 10)
            print(f"[{card}] {order} {prec}: B6 {b6:.4f} ms (bit-equal to "
                  f"its plain version), B9 {b9:.4f} ms (so is B9; B9 / B6 = "
                  f"{b9 / b6:.4f})", flush=True)
        b8 = timer(lambda: ak.adc_dists_pallas(tab, codes), 5)
        dicts, idx, width = ak.build_tile_dict(
            pad_codes(rows, DICT_TILE), tile_n=DICT_TILE, max_dict=256)
        idx, dicts = torch.from_numpy(idx).to(dev), torch.from_numpy(
            dicts).to(dev)
        keys = ak.adc_topk_tiledict_tiles(tab, idx, dicts, n, TOP_K,
                                          DICT_TILE)
        if not torch.equal(keys, ak.adc_topk_tiledict_tiles_ref(
                tab, idx, dicts, n, TOP_K, DICT_TILE)):
            raise AssertionError(f"B10 ({order}) differs from its plain "
                                 f"version")
        b10 = timer(lambda: ak.adc_topk_tiledict_tiles(
            tab, idx, dicts, n, TOP_K, DICT_TILE), 10)
        print(f"[{card}] {order}: B8 {b8:.4f} ms; B10 {b10:.4f} ms (tile "
              f"{DICT_TILE}, dictionary width {width}; equal to its plain "
              f"version bit for bit)", flush=True)
        del idx, dicts, keys
    cw_d, codes_d = make_clustered_codes(n, 8, 256, seed=0, device=dev,
                                         **WORKLOADS["dup_heavy"])
    tab, idx, dicts, width, codes = tiledict_operands(cw_d, codes_d, q, dev)
    keys = ak.adc_topk_tiledict_tiles(tab, idx, dicts, n, TOP_K, DICT_TILE)
    if not (torch.equal(keys, ak.adc_topk_tiledict_tiles_ref(
            tab, idx, dicts, n, TOP_K, DICT_TILE))
            and torch.equal(keys, ak.adc_topk_packed_tiles(
                tab, codes, n, TOP_K, DICT_TILE, "f32"))):
        raise AssertionError("B10 on the dup_heavy rows differs from its "
                             "plain version or from B9's f32 keys")
    b10 = timer(lambda: ak.adc_topk_tiledict_tiles(
        tab, idx, dicts, n, TOP_K, DICT_TILE), 10)
    b9 = timer(lambda: ak.adc_topk_packed_tiles(tab, codes, n, TOP_K,
                                                DICT_TILE, "f32"), 10)
    print(f"[{card}] dup_heavy lexsort: B10 {b10:.4f} ms (tile {DICT_TILE}, "
          f"dictionary width {width}), B9 f32 {b9:.4f} ms on the codes of "
          f"the same rows (B10 / B9 = {b10 / b9:.4f}); the same keys bit for "
          f"bit, equal to B10's plain version", flush=True)
    return 0


def tiledict_operands(cw, codes, q, dev):
    """B10's operands over ``codes`` [n, M] in lexsort order, in 2048-row
    tiles: (table, idx, dicts, dictionary width, the sorted codes padded),
    the table of queries ``q`` on ``dev``."""
    codes = np.asarray(codes.cpu() if isinstance(codes, torch.Tensor)
                       else codes)
    rows = pad_codes(codes[np.lexsort(codes.T[::-1])], DICT_TILE)
    dicts, idx, width = ak.build_tile_dict(rows, tile_n=DICT_TILE,
                                           max_dict=256)
    tab = adc_table(torch.as_tensor(cw).to(dev), torch.from_numpy(q).to(dev))
    return (tab, torch.from_numpy(idx).to(dev),
            torch.from_numpy(dicts).to(dev), width,
            torch.from_numpy(rows).to(dev))


if __name__ == "__main__":
    sys.exit(main())
