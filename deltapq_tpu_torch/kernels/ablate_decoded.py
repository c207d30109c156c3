"""Ablation of the decoded scan kernel (``csrc/decoded_mins.cu``) on a card.

Usage:  python3 -m deltapq_tpu_torch.kernels.ablate_decoded

Where the kernel's time goes cannot be read off a profiler on every
host, so this takes its parts out one at a time: each variant is the
kernel's source with a few lines replaced (the ``wgmma`` by a no-op, the
``cp.async`` copies, the ``pre`` sums or the epilogue switched off behind
a condition that is never true at run time), built by its own ``nvcc``
beside a small C++ harness that calls ``decoded_mins_launch`` on
N = 1,007,616 rows at D = 128 and D = 1024, B = 64 and B = 512, and times
five launches with CUDA events.  The variants compute wrong minima; only
their times mean something.  A replaced line that is no longer in the
source stops the run, so the script cannot silently ablate nothing.
"""

from __future__ import annotations

import subprocess
import sys

from . import build

HARNESS = r"""
#include <cstdio>
#include <cuda_runtime.h>
extern "C" int decoded_mins_launch(const void* qt, const void* xt, void* mins,
                                   int B, int D, int n_rows, int n_valid,
                                   void* stream);
int main(int argc, char** argv) {
  const int n = 123 * 8192;
  void *xt, *q, *mins;
  cudaMalloc(&xt, (size_t)n * 1024 * 2);
  cudaMemset(xt, 0x11, (size_t)n * 1024 * 2);
  cudaMalloc(&q, (size_t)1024 * 512 * 2);
  cudaMemset(q, 0x11, (size_t)1024 * 512 * 2);
  cudaMalloc(&mins, (size_t)n / 32 * 512 * 4);
  for (int B : {64, 512})
    for (int D : {128, 1024}) {
      int e = decoded_mins_launch(q, xt, mins, B, D, n, n, 0);
      cudaDeviceSynchronize();
      cudaEvent_t a, b;
      cudaEventCreate(&a);
      cudaEventCreate(&b);
      cudaEventRecord(a);
      for (int i = 0; i < 5; ++i)
        decoded_mins_launch(q, xt, mins, B, D, n, n, 0);
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      float ms;
      cudaEventElapsedTime(&ms, a, b);
      printf("%-9s D=%-4d B=%-3d %8.4f ms  (launch %d, run %d)\n", argv[1], D,
             B, ms / 5, e, (int)cudaGetLastError());
    }
  return 0;
}
"""

NOP = ("namespace {\nstatic __device__ __forceinline__ void wgmma_nop("
       "float (&d)[64], uint64_t a, uint64_t b, int s) {\n"
       "  d[0] += (float)(a ^ b) * s;\n}\n")
#: part -> [(line of the source, its replacement)]
PARTS = {
    "mma": [("        mma::wgmma_bf16_n128(\n", "        wgmma_nop(\n"),
            ("namespace {\n", NOP)],
    "copies": [("        mma::cp_async16(\n            st + a_dst",
                "        if (n_valid < 0) mma::cp_async16(\n"
                "            st + a_dst"),
               ("        mma::cp_async16(st + b_dst",
                "        if (n_valid < 0) mma::cp_async16(st + b_dst")],
    "pre": [("        if (8 * c < kmax) {\n", "        if (n_valid < 0) {\n")],
    "epilogue": [("      if (row0 + rb < n_rows) {\n",
                  "      if (row0 + rb < n_rows && (n_valid < 0 || "
                  "acc[0][0] == 123.f)) {\n")],
}
#: variant -> the parts it takes out
VARIANTS = {
    "whole": (), "no-mma": ("mma",), "no-copies": ("copies",),
    "no-pre": ("pre",), "no-epi": ("epilogue",),
    "only-mma": ("copies", "pre", "epilogue"),
    "skeleton": ("mma", "copies", "pre", "epilogue"),
}


def variant_source(src: str, parts) -> str:
    """The kernel's source with ``parts`` taken out."""
    for part in parts:
        for old, new in PARTS[part]:
            if src.count(old) != 1:
                raise RuntimeError(f"ablation {part!r}: the source no longer "
                                   f"has exactly one {old!r}")
            src = src.replace(old, new)
    return src


def main() -> int:
    out = build.BUILD_DIR / "ablate_decoded"
    out.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC_DIR / "decoded_mins.cu").read_text()
    (out / "harness.cu").write_text(HARNESS)
    nvcc = build.nvcc_path()
    cmds = []
    for name, parts in VARIANTS.items():
        cu = out / f"{name}.cu"
        cu.write_text(variant_source(src, parts))
        cmds.append([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                     "-std=c++17", "-O3", f"-I{build.CSRC_DIR}", "-o",
                     str(out / name), str(out / "harness.cu"), str(cu)])
    for cmd, rc, log in build._run_all(cmds):
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{log}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0]
    print(card, flush=True)
    for name in VARIANTS:
        subprocess.run([str(out / name), name], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
