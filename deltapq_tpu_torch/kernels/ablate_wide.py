"""Ablation of the gathered wgmma wide tail (``csrc/wide_mma.cuh``) on a card.

Usage:  python3 -m deltapq_tpu_torch.kernels.ablate_wide [N] [B]

As ``ablate_decoded`` does for the decoded scan, this takes the tail's
parts out one at a time: each variant is ``wide_mma.cuh`` with a few
lines replaced (the ``wgmma`` by a no-op; the gathered codeword copies,
the query copies, the rows' code loads, ``pre`` or the epilogue switched
off behind a condition that is never true at run time), built with
``codes_mins.cu`` by its own
``nvcc`` into a library of its own, and B3 is timed through each with
CUDA events on the GIST-shape workload (``synth.make_gist_workload``,
default N 1,000,000, in the DFS order of its M=16 DeltaTree) at B (default
512) in the three modes.  The whole variant must give the package's
kernel's minima bit for bit; the others compute wrong minima, and only
their times mean something.  A replaced line that is no longer in the
source stops the run, so the script cannot silently ablate nothing.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from . import build

NOP = ("namespace wide_mma {\n"
       "template <class T, int N>\n"
       "__device__ __forceinline__ void wide_nop(T (&d)[N], uint64_t a, "
       "uint64_t b, int s) {\n"
       "  d[0] += (T)((a ^ b) & 1) * (T)s;\n}\n")
#: part -> [(text of the source, its replacement, times it occurs)]
PARTS = {
    "mma": [("mma::wgmma_bf16_n128(", "wide_nop(", 1),
            ("mma::wgmma_s8_n128(", "wide_nop(", 1),
            ("mma::wgmma_s8_n32(", "wide_nop(", 4),
            ("namespace wide_mma {\n", NOP, 1)],
    "gather": [("            mma::cp_async16_ca(",
                "            if (n_valid < 0) mma::cp_async16_ca(", 1)],
    "queries": [("            mma::cp_async16(\n",
                 "            if (n_valid < 0) mma::cp_async16(\n", 1)],
    "pre": [("        if (ks == 0 && tid < BM)\n",
             "        if (ks == 0 && tid < BM && n_valid < 0)\n", 1)],
    "codes": [("        crow[j] = load_code_row(",
               "        crow[j] = n_valid < 0 ? make_uint4(0, 0, 0, 0) : "
               "load_code_row(", 1)],
    "epilogue": [("      for (int j0 = 0; j0 < NB; j0 += 8) {",
                  "      for (int j0 = 0; j0 < (n_valid < 0 ? NB : 0); "
                  "j0 += 8) {", 1)],
}
#: variant -> the parts it takes out
VARIANTS = {
    "whole": (), "no-mma": ("mma",), "no-gather": ("gather",),
    "no-queries": ("queries",), "no-pre": ("pre",), "no-epi": ("epilogue",),
    "no-codes": ("codes",),
    "only-mma": ("gather", "queries", "pre", "epilogue"),
    "skeleton": ("mma", "gather", "queries", "pre", "epilogue"),
}


def variant_source(src: str, parts) -> str:
    """``wide_mma.cuh`` with ``parts`` taken out."""
    for part in parts:
        for old, new, times in PARTS[part]:
            if src.count(old) != times:
                raise RuntimeError(f"ablation {part!r}: the source no longer "
                                   f"has {times} x {old!r}")
            src = src.replace(old, new)
    return src


def _build_variants():
    out = build.BUILD_DIR / "ablate_wide"
    src = (build.CSRC_DIR / "wide_mma.cuh").read_text()
    codes_cu = (build.CSRC_DIR / "codes_mins.cu").read_text()
    nvcc = build.nvcc_path()
    cmds = []
    for name, parts in VARIANTS.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "wide_mma.cuh").write_text(variant_source(src, parts))
        (d / "codes_mins.cu").write_text(codes_cu)
        cmds.append([nvcc, *build.NVCC_FLAGS[:-2], "-shared",
                     f"-I{build.CSRC_DIR}", "-o", str(d / "lib.so"),
                     str(d / "codes_mins.cu")])
    for cmd, rc, log in build._run_all(cmds):
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{log}")
    libs = {}
    for name in VARIANTS:
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        lib.codes_mins_launch.argtypes = build.SIGNATURES["codes_mins_launch"]
        lib.codes_mins_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    from .. import bench_gist
    from ..bench_engines import cuda_ms
    from ..ops import fused_kernels as fk
    from ..ops.fused import FusedCodesEngine
    from ..synth import make_gist_workload

    argv = list(sys.argv[1:] if argv is None else argv)
    n = int(argv[0]) if argv else 1_000_000
    b = int(argv[1]) if len(argv) > 1 else 512
    libs = _build_variants()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0]
    M, K, Ds = bench_gist.M, bench_gist.K, bench_gist.DS
    cw, codes, x = make_gist_workload(n, M, K, Ds)
    del x
    order, _, _ = bench_gist.tree_order(codes)
    codes = codes[order]
    q = np.random.default_rng(1).normal(size=(b, M * Ds)).astype(
        np.float32) * 4
    print(f"{card}; GIST shape N={n}, B={b}, DFS order", flush=True)
    for prec in ("int16", "int8", "bf16"):
        e = FusedCodesEngine(cw, codes, precision=prec)
        _, qop, uq, _, _ = e.prepare(q)
        qop = qop[:, :b].contiguous()
        uq = (torch.ones((1, b), device=qop.device) if uq is None
              else uq[..., :b].contiguous())
        cwc, nrm, pad = e.compact
        planes = 2 if prec == "int16" else 1
        qt = fk.pad_transpose_queries(qop, M, Ds, prec)
        nt = e.codes.shape[0] // fk.TILE
        mins = torch.empty((nt * fk.TILE // fk.SUB, b), device=qop.device)
        ref, _ = fk.fused_codes_mins(qop, e.cwbd, e.codes, e.n_valid, u=uq,
                                     compact=e.compact, mode=prec)
        stream = torch.cuda.current_stream().cuda_stream
        for name, lib in libs.items():
            def call():
                build.check(lib.codes_mins_launch(
                    qt.data_ptr(), cwc.data_ptr(), pad.data_ptr(),
                    nrm.data_ptr(), e.codes.data_ptr(), uq.data_ptr(),
                    mins.data_ptr(), b, qop.shape[0] // planes, nt,
                    e.n_valid, M, K, Ds, fk.MODES[prec], stream),
                    f"ablation {name}")
            call()
            if name == "whole" and not torch.equal(mins, ref):
                raise AssertionError(f"{prec}: the whole variant differs "
                                     f"from the package's kernel")
            print(f"{prec:5s} {name:10s} {cuda_ms(call, 5):8.4f} ms",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
