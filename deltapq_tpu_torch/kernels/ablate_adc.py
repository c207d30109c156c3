"""Ablation of the ADC top-k kernel (``csrc/adc_topk.cu``) on a card.

Usage:  python3 -m deltapq_tpu_torch.kernels.ablate_adc [N] [B]

As ``ablate_wide`` does for the wide scan tail, each variant is
``adc_topk.cu`` with a line replaced, built by its own ``nvcc`` into a
library of its own, and timed with CUDA events in the three precisions on
the engine benchmark's workload (``bench_engines.workload``, default N
1,048,576, B 512; top-10, 4096-row tiles):

* ``whole``: the kernel as it is -- 4-byte table groups, the [M][K] table
  of one query a warp (two at bf16), up to 24 warps a block;
* ``group8`` / ``group16``: query-interleaved tables, 8- and 16-byte
  groups -- one load of a code serves two or four queries (four or eight
  at bf16), and fewer warps fit a block;
* ``warps16``: at most 16 warps a block;
* ``no-select``: the lookups without the selection (no row is inserted;
  wrong output, only the time means something).

``whole``, the two layouts and ``warps16`` compute the same function and
must equal the package's kernel bit for bit.  A replaced line that is no
longer in the source stops the run (``build.build_variants``), so the
script cannot silently ablate nothing.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from . import build

#: variant -> [(text of the source, its replacement)]
VARIANTS = {
    "whole": [],
    "group8": [("constexpr int GROUP_BYTES = 4;",
                "constexpr int GROUP_BYTES = 8;")],
    "group16": [("constexpr int GROUP_BYTES = 4;",
                 "constexpr int GROUP_BYTES = 16;")],
    "warps16": [("static constexpr int MAX = KR == 1 ? 24 : 16;",
                 "static constexpr int MAX = 16;")],
    "no-select": [("unsigned hit = __ballot_sync(FULL, d < tau[qi]);",
                   "unsigned hit = __ballot_sync(FULL, d < tau[qi]) & "
                   "(n_valid < 0 ? ~0u : 0u);")],
}


def main(argv=None) -> int:
    from ..bench_engines import cuda_ms, workload
    from ..ops import adc_kernels as ak
    from ..ops.adc import adc_table, pad_codes

    argv = list(sys.argv[1:] if argv is None else argv)
    n = int(argv[0]) if argv else 1 << 20
    b = int(argv[1]) if len(argv) > 1 else 512
    top_k, tile = 10, ak.TILE_N
    libs = build.build_variants("ablate_adc", "adc_topk.cu", VARIANTS)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0]
    cw, codes_np, q = workload(n, b)
    dev = torch.device("cuda")
    table = adc_table(torch.from_numpy(cw).to(dev),
                      torch.from_numpy(q).to(dev))
    codes = torch.from_numpy(pad_codes(codes_np, tile)).to(dev)
    _, M, K = table.shape
    nt = codes.shape[0] // tile
    print(f"{card}; engine benchmark workload N={n}, B={b}, top-{top_k}, "
          f"tile {tile}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    for prec in ak.PRECISIONS:
        tab = ak._kernel_table(table, prec)
        rd, ri = ak.adc_topk_tiles(table, codes, n, top_k, tile, prec)
        d = torch.empty((nt, top_k, b), dtype=torch.float32, device=dev)
        i = torch.empty((nt, top_k, b), dtype=torch.int32, device=dev)
        for name, lib in libs.items():
            def call():
                build.check(lib.adc_topk_launch(
                    tab.data_ptr(), codes.data_ptr(), d.data_ptr(),
                    i.data_ptr(), b, M, K, codes.shape[0], tile, n, top_k,
                    codes.element_size(), ak.PRECISIONS.index(prec),
                    stream), f"ablation {name}")
            call()
            if name != "no-select" and not (torch.equal(d, rd)
                                            and torch.equal(i, ri)):
                raise AssertionError(f"{prec}: variant {name} differs from "
                                     f"the package's kernel")
            print(f"{prec:6s} {name:9s} {cuda_ms(call, 10):8.4f} ms",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
