// The full ADC distance matrix.
//
// Replaces the TPU kernel deltapq_tpu/ops/adc_pallas.py:_adc_dists_kernel,
// reached from adc_dists_pallas.  Python wrapper and plain PyTorch
// version: deltapq_tpu_torch/ops/adc_kernels.py.
//
// What it computes: out[b, n] = sum_m tab[b, m*K + codes[n, m]], added in
// ascending m from 0.0f with __fadd_rn, so it is bit-equal to the plain
// scan's tile distances (ops/adc.py adc_tile_dists).  No n_valid mask (the
// TPU kernel has none).  The TPU kernel writes [N, B] and its wrapper
// transposes; this one writes the [B, N] result directly.
//
// What bounds it on an H100: the f32 output (N*B*4 bytes, 2 GiB at N=1M,
// B=512) against N*B*M shared-memory lookups.
//
// Design: a block holds QC queries' [M*K] table rows in shared memory and
// walks `rows` database rows; a thread reads a row's codes once into
// registers (M <= 16) and sums them for each of the block's queries, so
// consecutive threads write consecutive floats of one output row.  All
// output offsets are 64-bit.

#include "adc_lookup.cuh"

namespace {

using adc::THREADS;
constexpr int M_REG = 16;   // codes of a row held in registers up to this M

template <typename CodeT>
__global__ void __launch_bounds__(THREADS)
adc_dists_kernel(const float* __restrict__ tab,     // [B, M*K]
                 const CodeT* __restrict__ codes,   // [N, M]
                 float* __restrict__ out,           // [B, N]
                 int B, int M, int K, long long N, int rows, int QC) {
  extern __shared__ __align__(16) float tab_s[];    // [QC, MK]
  const int MK = M * K;
  const int q0 = blockIdx.y * QC;
  const int nq = min(QC, B - q0);
  adc::stage(tab_s, tab + (size_t)q0 * MK, nq * MK);
  __syncthreads();

  const long long r0 = (long long)blockIdx.x * rows;
  const long long r1 = min(N, r0 + rows);
  for (long long r = r0 + threadIdx.x; r < r1; r += THREADS) {
    const CodeT* c = codes + r * M;
    if (M <= M_REG) {
      int off[M_REG];
#pragma unroll
      for (int m = 0; m < M_REG; ++m)
        off[m] = m < M ? m * K + (int)c[m] : 0;
      for (int j = 0; j < nq; ++j) {
        const float* T = tab_s + (size_t)j * MK;
        float acc = 0.0f;
#pragma unroll
        for (int m = 0; m < M_REG; ++m)
          if (m < M) acc = __fadd_rn(acc, T[off[m]]);
        out[(size_t)(q0 + j) * N + r] = acc;
      }
    } else {
      for (int j = 0; j < nq; ++j)
        out[(size_t)(q0 + j) * N + r] = adc::row_sum<adc::F32, CodeT>(
            tab_s + (size_t)j * MK, c, M, K);
    }
  }
}

template <typename CodeT>
cudaError_t launch(const float* tab, const void* codes, float* out, int B,
                   int M, int K, long long N, int rows, int QC,
                   cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)QC * M * K;
  cudaError_t e = cudaFuncSetAttribute(
      adc_dists_kernel<CodeT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)((N + rows - 1) / rows), (B + QC - 1) / QC);
  adc_dists_kernel<CodeT><<<grid, THREADS, smem, st>>>(
      tab, static_cast<const CodeT*>(codes), out, B, M, K, N, rows, QC);
  return cudaGetLastError();
}

}  // namespace

// code_bytes 1 (u8 codes) or 4 (int32 codes, K > 256); `rows` database
// rows per block; QC queries per block, sized by the Python wrapper so
// that 4*QC*M*K bytes fit in shared memory.  Returns cudaGetLastError()
// after the launch.
extern "C" int adc_dists_launch(const void* tab, const void* codes,
                                void* out, int B, int M, int K, int n,
                                int rows, int QC, int code_bytes,
                                void* stream) {
  if (n == 0 || B == 0) return (int)cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  auto* tp = static_cast<const float*>(tab);
  auto* op = static_cast<float*>(out);
  if (code_bytes == 1)
    return (int)launch<uint8_t>(tp, codes, op, B, M, K, n, rows, QC, st);
  if (code_bytes == 4)
    return (int)launch<int32_t>(tp, codes, op, B, M, K, n, rows, QC, st);
  return (int)cudaErrorInvalidValue;
}
