"""Ablation of the distance-matrix kernel (B8, ``csrc/adc_dists.cu``) on a
card.

Usage:  python3 -m deltapq_tpu_torch.kernels.ablate_dists [N] [B]

Three levers of B8's design (its source's header says how):

* (a) warps: 32 warps a block over one staged table, against 8;
* (b) lanes on queries: a warp's lanes on 16 queries of a [M*K][16]
  table, four queries a lane in one 16-byte load, eight rows at a time
  (lookups nearly free of bank conflicts), against lanes on rows, each
  looking up its own row in one query's [M*K] table, the block's 16
  queries in turn (the layout B8 had before);
* (c) streaming stores (``st.global.cs``) against plain ones.

The package's kernel turns (a) and (b) on and (c) off.  Each variant is
``adc_dists.cu`` with its constants replaced for the levers it sets
otherwise, built by its own ``nvcc`` into a library of its own
(``build.build_variants``), and timed with CUDA events on the engine
benchmark's workload (``bench_engines.workload``, default N 1,048,576,
B 512): every combination, from ``none`` to ``abc``, named by the levers
it turns on (``ab`` is the package's kernel), and beside ``ab`` ``qv1``
(one query a lane, 16 lanes a row: four loads where ``ab`` has one, and a
warp writes 32 bytes of a query's row where ``ab`` writes a 128-byte
line), ``run8`` (eight rows a lane) and ``w24`` / ``w16`` (24 or 16
warps a block: more registers a thread).  All compute the same function
and must equal the package's B8 bit for bit.  Then two diagnostics of
``ab``, whose output is wrong and whose time alone means something:
``no-store`` (the sums without the stores) and ``no-lookup`` (the stores
and the code reads without the table lookups), and the card's write rate
on the same [B, N] output (``Tensor.fill_``).
"""

from __future__ import annotations

import itertools
import sys

import torch

from . import build

#: lever -> [(text of adc_dists.cu as the package has it, the text that
#: sets the lever the other way)]
FLIP = {
    "a": [("constexpr int WARPS = 32;", "constexpr int WARPS = 8;")],
    "b": [("constexpr int QL_MAX = 16;", "constexpr int QL_MAX = 1;"),
          ("constexpr int QR = 1;", "constexpr int QR = 16;")],
    "c": [("constexpr bool STREAM = false;",
           "constexpr bool STREAM = true;")],
}
PACKAGE = "ab"
#: variant (the levers it turns on) -> replacements
VARIANTS = {
    ("".join(on) or "none"): [e for lever in "abc"
                              if (lever in on) != (lever in PACKAGE)
                              for e in FLIP[lever]]
    for k in range(4) for on in itertools.combinations("abc", k)}
VARIANTS["qv1"] = [("constexpr int QV_MAX = 4;", "constexpr int QV_MAX = 1;")]
VARIANTS["w24"] = [("constexpr int WARPS = 32;", "constexpr int WARPS = 24;")]
VARIANTS["w16"] = [("constexpr int WARPS = 32;", "constexpr int WARPS = 16;")]
VARIANTS["run8"] = [("constexpr int RUN = 4;", "constexpr int RUN = 8;")]
#: diagnostics: wrong output, only the time means something
DIAGNOSTICS = {
    "no-store": [("          if (vec && r0 + RUN <= r_end) {",
                  "          if (__float_as_uint(acc[0][0]) != 0x7fc00001u) {"
                  "\n          } else if (vec && r0 + RUN <= r_end) {")],
    "no-lookup": [("  const V e = *reinterpret_cast<const V*>("
                   "Tm + (c << lq));",
                   "  V e = V{};\n  reinterpret_cast<float*>(&e)[0] = "
                   "__int_as_float(c << lq);")],
}


def main(argv=None) -> int:
    from ..bench_adc import card_line
    from ..bench_engines import cuda_ms, workload
    from ..ops import adc_kernels as ak
    from ..ops.adc import adc_table

    argv = list(sys.argv[1:] if argv is None else argv)
    n = int(argv[0]) if argv else 1 << 20
    b = int(argv[1]) if len(argv) > 1 else 512
    dev = torch.device("cuda")
    libs = build.build_variants("ablate_dists", "adc_dists.cu",
                                {**VARIANTS, **DIAGNOSTICS})
    card = card_line(dev)
    cw, codes_np, q = workload(n, b)
    table = adc_table(torch.from_numpy(cw).to(dev),
                      torch.from_numpy(q).to(dev))
    codes = torch.from_numpy(codes_np).to(dev)
    _, M, K = table.shape
    print(f"{card}; engine benchmark workload N={n}, B={b}, M={M}, K={K}",
          flush=True)
    ref = ak.adc_dists_pallas(table, codes)
    out = torch.empty_like(ref)
    stream = torch.cuda.current_stream().cuda_stream
    for name, lib in libs.items():
        def call(lib=lib, name=name):
            build.check(lib.adc_dists_launch(
                table.data_ptr(), codes.data_ptr(), out.data_ptr(), b, M, K,
                n, 1, stream), f"variant {name}")
        call()
        if name in VARIANTS and not torch.equal(out, ref):
            raise AssertionError(f"variant {name} differs from the "
                                 f"package's B8")
        print(f"B8 {name:9s} {cuda_ms(call, 5):8.4f} ms", flush=True)
    fill = cuda_ms(lambda: out.fill_(1.0), 5)
    print(f"fill_ of the [{b}, {n}] f32 output: {fill:.4f} ms "
          f"({out.numel() * 4 / fill / 1e9:.3f} TB/s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
