"""The packed ADC top-k (B9) in another layout, timed beside the package's
kernel on a card.

Usage:  python3 -m deltapq_tpu_torch.kernels.ablate_packed [N] [B]

``kernels/adc_topk_rows.cu`` is B9 with the lanes of a warp on one row and
many queries (conflict-free table lookups, a selection per lane; its
header says how).  This script builds it by its own ``nvcc`` into a
library of its own and times it with CUDA events against the package's B9
(``csrc/adc_topk.cu``: a lane a row, one query a warp, a selection per
warp) in the three precisions on the engine benchmark's workload
(``bench_engines.workload``, default N 1,048,576, B 512; top-10, 4096-row
tiles), in turns (package, rows, rows, package).  The two must give the
same keys bit for bit, or the run stops.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from . import build

SOURCE = build.PKG_DIR / "kernels" / "adc_topk_rows.cu"


def _build():
    out = build.BUILD_DIR / "ablate_packed"
    out.mkdir(parents=True, exist_ok=True)
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
           f"-I{build.CSRC_DIR}", "-o", str(out / "lib.so"), str(SOURCE)]
    (cmd, rc, log), = build._run_all([cmd])
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{log}")
    print("\n".join(l for l in log.splitlines() if "registers" in l),
          flush=True)
    fn = ctypes.CDLL(str(out / "lib.so")).adc_topk_packed_launch
    fn.argtypes = build.SIGNATURES["adc_topk_packed_launch"]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    from ..bench_engines import cuda_ms, workload
    from ..ops import adc_kernels as ak
    from ..ops.adc import adc_table, pad_codes

    argv = list(sys.argv[1:] if argv is None else argv)
    n = int(argv[0]) if argv else 1 << 20
    b = int(argv[1]) if len(argv) > 1 else 512
    top_k, tile = 10, 4096
    rows_fn = _build()
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
        keys = torch.empty((nt, top_k, b), dtype=torch.int32, device=dev)
        out = torch.empty_like(keys)

        def launch(fn, dst, what):
            build.check(fn(
                tab.data_ptr(), codes.data_ptr(), dst.data_ptr(), b, M, K,
                codes.shape[0], tile, n, top_k, 1, ak.PRECISIONS.index(prec),
                stream), what)

        def rows():
            launch(rows_fn, out, "rows layout")

        def package():     # the kernel alone, on the same converted table
            launch(build.library().adc_topk_packed_launch, keys, "B9")

        package()
        rows()
        if not torch.equal(keys, ak.adc_topk_packed_tiles_ref(
                table, codes, n, top_k, tile, prec)):
            raise AssertionError(f"{prec}: B9 differs from its plain version")
        if not torch.equal(out, keys):
            raise AssertionError(f"{prec}: the rows layout's keys differ "
                                 f"from B9's")
        t = [cuda_ms(fn, 10) for fn in (package, rows, rows, package)]
        print(f"{prec:6s} B9 {t[0]:.4f} / {t[3]:.4f} ms, rows layout "
              f"{t[1]:.4f} / {t[2]:.4f} ms (keys bit-equal)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
