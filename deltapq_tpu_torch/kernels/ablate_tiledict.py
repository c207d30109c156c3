"""Ablation of the tile-dictionary top-k (B10, ``csrc/adc_topk.cu``) on a
card.

Usage:  python3 -m deltapq_tpu_torch.kernels.ablate_tiledict [N] [B]

B10 is B9's warp kernel over compact tables, gathered for every (query
group, tile) item through the tile's dictionary.  As ``ablate_adc`` does
for B6, each variant is ``adc_topk.cu`` with a line replaced, built by its
own ``nvcc`` into a library of its own (``build.build_variants``), and
timed with CUDA events (default N 1,048,576, B 512; top-10, 2048-row
tiles) on two sets of rows in lexsort order: the dup_heavy codes
(``bench_adc``'s, narrow dictionaries) and the engine benchmark's codes
(``bench_engines.workload``, 256 wide):

* ``whole``: the kernel as it is -- table groups of 16, 8 or 4 bytes
  (four, two or one query a warp; the widest with which a block holds
  as many warps as at 4 bytes), items tile-major (a block keeps a tile's
  indexes, one code chunk, across the query groups it walks);
* ``group4`` / ``group8`` / ``group16``: one group width at every
  dictionary width;
* ``query-major``: items query-major, as B6 and B9 walk them (the tile's
  chunk restaged for every item);
* ``no-select``: the lookups without the selection (no row is inserted;
  wrong output, only the time means something).

B9 f32 on the codes of the same rows (the package's library) is timed
beside them.  All but ``no-select`` compute the same function and must
equal the package's B10 bit for bit.
"""

from __future__ import annotations

import sys

import torch

from . import build

GB_LINE = "  const int gb = f16 >= want ? 16 : f8 >= want ? 8 : 4;"
#: variant -> [(text of adc_topk.cu, its replacement)]
VARIANTS = {
    "whole": [],
    "group4": [(GB_LINE, "  const int gb = 4;")],
    "group8": [(GB_LINE, "  const int gb = 8;")],
    "group16": [(GB_LINE, "  const int gb = 16;")],
    "query-major": [("  static constexpr bool TILE_MAJOR = true;",
                     "  static constexpr bool TILE_MAJOR = false;")],
    "no-select": [("unsigned hit = __ballot_sync(FULL, d < tau[qi]);",
                   "unsigned hit = __ballot_sync(FULL, d < tau[qi]) & "
                   "(n_valid < 0 ? ~0u : 0u);")],
}


def main(argv=None) -> int:
    from ..bench_adc import DICT_TILE, TOP_K, card_line, tiledict_operands
    from ..bench_engines import cuda_ms, workload
    from ..ops import adc_kernels as ak
    from ..synth import WORKLOADS, make_clustered_codes

    argv = list(sys.argv[1:] if argv is None else argv)
    n = int(argv[0]) if argv else 1 << 20
    b = int(argv[1]) if len(argv) > 1 else 512
    dev = torch.device("cuda")
    libs = build.build_variants("ablate_tiledict", "adc_topk.cu", VARIANTS)
    card = card_line(dev)
    cw_b, codes_b, q = workload(n, b)
    cw_d, codes_d = make_clustered_codes(n, 8, 256, seed=0, device=dev,
                                         **WORKLOADS["dup_heavy"])
    print(f"{card}; N={n}, B={b}, top-{TOP_K}, tile {DICT_TILE}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    for rows, cw, codes in (("dup_heavy", cw_d, codes_d),
                            ("engine benchmark", cw_b, codes_b)):
        tab, idx, dicts, width, codes_p = tiledict_operands(cw, codes, q, dev)
        _, M, K = tab.shape
        n_pad = idx.shape[0]
        ref = ak.adc_topk_tiledict_tiles(tab, idx, dicts, n, TOP_K,
                                         DICT_TILE)
        out = torch.empty_like(ref)
        print(f"{rows} codes, lexsort order: dictionary width {width}",
              flush=True)
        for name, lib in libs.items():
            def call(lib=lib, name=name):
                build.check(lib.adc_topk_tiledict_launch(
                    tab.data_ptr(), idx.data_ptr(), dicts.data_ptr(),
                    out.data_ptr(), b, M, K, width, n_pad, DICT_TILE, n,
                    TOP_K, stream), f"variant {name}")
            call()
            if name != "no-select" and not torch.equal(out, ref):
                raise AssertionError(f"{rows}: variant {name} differs from "
                                     f"the package's B10")
            print(f"  B10 {name:11s} {cuda_ms(call, 10):8.4f} ms", flush=True)
        b9 = cuda_ms(lambda: ak.adc_topk_packed_tiles(
            tab, codes_p, n, TOP_K, DICT_TILE, "f32"), 10)
        print(f"  B9 f32 on the same rows {b9:8.4f} ms", flush=True)
        del tab, idx, dicts, codes_p, ref, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
