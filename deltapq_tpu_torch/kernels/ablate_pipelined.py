"""Two designs of the pipelined stream kernel (``csrc/stream_mins_pipelined.cu``)
timed beside the serial stream kernel on a card.

Usage:  python3 -m deltapq_tpu_torch.kernels.ablate_pipelined [N] [B]

As ``ablate_adc`` does for the ADC top-k kernel, each variant is
``stream_mins_pipelined.cu`` with lines replaced, built by its own
``nvcc`` into a library of its own:

* ``whole``: the kernel as it is -- one code tile in shared memory beside
  the staging buffer, the decode of tile t+1 after the last query block
  of tile t;
* ``two-tiles``: a second code tile, so that the decode of tile t+1 runs
  in the middle of tile t's query blocks (what the kernel did before it
  moved onto ``MmaTail``, with the decode between subtiles).

Both are timed with CUDA events at int8 and bf16 on the sift_like workload
(``synth.make_clustered_codes``, M=8, K=256, D=128, lexsort order as
``bench_stream`` uses it; default N 1,048,576, B 512), in turns with the
serial kernel B1 on the same stream tiles (B1, whole, two-tiles,
two-tiles, whole, B1).  Each must give B1's codes and minima bit for bit,
or the run stops.  A replaced text that is no longer in the source stops
the run too, so the script cannot silently time the same kernel twice.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from . import build

_BODY = """\
  prefetch_tile(stage, row_data, vals, meta, nT, t0, n_groups);
  Tail::load_codebook(smem, cw, nrm, M, K, Ds);
  for (int t = t0; t < t1; ++t) {
    __pipeline_wait_prior(0);
    __syncthreads();   // tile t is staged; the last scan has read the codes
    // tile t's window starts at group meta[t], so its first value sits
    // meta[nT + t] bytes into the staged window
    stream_decode<MMAX>(stage, stage + TILE, (long long)meta[nT + t], sc, M,
                        codes_out + (size_t)t * TILE * M);
    // the decode ended with a barrier: the staging buffer is free again
    if (t + 1 < t1)
      prefetch_tile(stage, row_data, vals, meta, nT, t + 1, n_groups);
    for (int qb0 = 0; qb0 < B; qb0 += Tail::QBLK) {
      if (qb0) __syncthreads();   // the last scan has read the queries
      Tail::load_queries(smem, qt, u, B, Dg, qb0, M, K, Ds);
      __syncthreads();
      Tail::scan(smem, sc.codes, mins, t, B, qb0, n_valid, M, K, Ds);
    }
  }
"""
_TWO_TILES = """\
  uint8_t* buf1 = stage;                   // the second code tile
  stage += TILE * MMAX;
  prefetch_tile(stage, row_data, vals, meta, nT, t0, n_groups);
  Tail::load_codebook(smem, cw, nrm, M, K, Ds);
  auto decode = [&](int t, uint8_t* buf) {
    Scratch d = sc;
    d.codes = buf;
    __pipeline_wait_prior(0);
    __syncthreads();   // tile t is staged
    stream_decode<MMAX>(stage, stage + TILE, (long long)meta[nT + t], d, M,
                        codes_out + (size_t)t * TILE * M);
    if (t + 1 < t1)
      prefetch_tile(stage, row_data, vals, meta, nT, t + 1, n_groups);
  };
  decode(t0, sc.codes);
  const int nqb = (B + Tail::QBLK - 1) / Tail::QBLK;
  for (int t = t0; t < t1; ++t) {
    uint8_t* cur = (t - t0) & 1 ? buf1 : sc.codes;
    uint8_t* nxt = (t - t0) & 1 ? sc.codes : buf1;
    for (int i = 0; i < nqb; ++i) {
      if (i == nqb / 2 && t + 1 < t1) decode(t + 1, nxt);
      __syncthreads();   // the last scan has read the queries
      Tail::load_queries(smem, qt, u, B, Dg, i * Tail::QBLK, M, K, Ds);
      __syncthreads();
      Tail::scan(smem, cur, mins, t, B, i * Tail::QBLK, n_valid, M, K, Ds);
    }
  }
"""
#: variant -> [(text of the source, its replacement)]
VARIANTS = {
    "whole": [],
    "two-tiles": [
        (_BODY, _TWO_TILES),
        ("+ align16(scratch_bytes<MMAX>()) + STAGE_BYTES;",
         "+ align16(scratch_bytes<MMAX>()) + TILE * MMAX + STAGE_BYTES;")],
}


def variant_source(src: str, name: str) -> str:
    """``stream_mins_pipelined.cu`` as variant ``name`` builds it."""
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: the source no longer has "
                               f"{old[:60]!r}... once")
        src = src.replace(old, new)
    return src


def _build_variants():
    out = build.BUILD_DIR / "ablate_pipelined"
    src = (build.CSRC_DIR / "stream_mins_pipelined.cu").read_text()
    nvcc = build.nvcc_path()
    cmds = []
    for name in VARIANTS:
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "kernel.cu").write_text(variant_source(src, name))
        cmds.append([nvcc, *build.NVCC_FLAGS, "-shared",
                     f"-I{build.CSRC_DIR}", "-o", str(d / "lib.so"),
                     str(d / "kernel.cu")])
    for cmd, rc, log in build._run_all(cmds):
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{log}")
        print("\n".join(l for l in log.splitlines() if "registers" in l),
              flush=True)
    libs = {}
    for name in VARIANTS:
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        fn = lib.stream_mins_pipelined_launch
        fn.argtypes = build.SIGNATURES["stream_mins_pipelined_launch"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main(argv=None) -> int:
    from ..bench_engines import cuda_ms
    from ..ops import fused_kernels as fk
    from ..ops.fused import FusedCompressedEngine
    from ..ops.stream_tiles import build_stream_tiles
    from ..synth import WORKLOADS, make_clustered_codes

    argv = list(sys.argv[1:] if argv is None else argv)
    n = int(argv[0]) if argv else 1 << 20
    b = int(argv[1]) if len(argv) > 1 else 512
    M, K, D = 8, 256, 128
    libs = _build_variants()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0]
    dev = torch.device("cuda")
    cw, codes = make_clustered_codes(n, M, K, device=dev,
                                     **WORKLOADS["sift_like"])
    cw, codes = cw.cpu().numpy(), codes.cpu().numpy()
    codes = codes[np.lexsort(codes.T[::-1])]
    st = build_stream_tiles(codes)
    q = np.random.default_rng(1).normal(size=(b, D)).astype(np.float32)
    print(f"{card}; sift_like N={n}, B={b}, M={M}, K={K}, lexsort order",
          flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    for prec in ("int8", "bf16"):
        e1 = FusedCompressedEngine.from_tiles(cw, st, precision=prec,
                                              device=dev)
        _, qop, uq, _, _ = e1.prepare(q)
        qop = qop[:, :b].contiguous()
        uq = None if uq is None else uq[..., :b].contiguous()
        m1, c1 = e1.scan(qop, uq)
        cwc, nrm, _, u, ds = fk._compact_operands(qop, e1.cwbd, M,
                                                  e1.compact, uq, prec)
        qt = fk.transpose_queries(qop)
        nt = e1.row_data.shape[0]
        mins = torch.empty_like(m1)
        out_codes = torch.empty_like(c1)
        calls = {}
        for name, fn in libs.items():
            def call(fn=fn, name=name):
                build.check(fn(
                    qt.data_ptr(), cwc.data_ptr(), nrm.data_ptr(),
                    e1.row_data.data_ptr(), e1.vals.data_ptr(),
                    e1.meta.data_ptr(), u.data_ptr(), mins.data_ptr(),
                    out_codes.data_ptr(), b, qop.shape[0], nt,
                    e1.vals.shape[0], int(e1.n_valid), M, K, ds,
                    fk.MODES[prec], stream), f"variant {name}")
            call()
            if not (torch.equal(mins, m1) and torch.equal(out_codes, c1)):
                raise AssertionError(f"{prec}: variant {name} differs from "
                                     f"B1")
            calls[name] = call
        order = ["B1", *libs, *reversed(libs), "B1"]
        times = {k: [] for k in ("B1", *libs)}
        for k in order:
            fn = calls.get(k, lambda: e1.scan(qop, uq))
            times[k].append(cuda_ms(fn, 20))
        shown = "; ".join(f"{k} " + " / ".join(f"{t:.4f}" for t in v)
                          for k, v in times.items())
        print(f"{prec}: {shown} ms (each bit-equal to B1)", flush=True)
        del e1
    return 0


if __name__ == "__main__":
    sys.exit(main())
