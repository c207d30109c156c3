// Exact per-candidate ADC table sums for the rerank.
//
// Replaces the TPU kernel deltapq_tpu/ops/fused_pallas.py:_rerank_kernel,
// reached from rerank_table_sums.  Python wrapper and plain PyTorch
// version: deltapq_tpu_torch/ops/fused_kernels.py.
//
// out[b, s] = sum_m tab[b, m*K + cand[b, m, s]], added in ascending m
// starting from 0.0f with __fadd_rn, so the result is bit-equal to the
// plain scan (ops/adc.py adc_tile_dists / adc_query_topk).
//
// What bounds it on an H100: memory.  The candidates are read once
// (M bytes per candidate) and the sums written once (4 bytes): at the
// cap rung (B=512, S=65536, M=8) that is 384 MB, ~0.12 ms at 3.35 TB/s.
//
// Design: the TPU had no per-lane gather and did a one-hot compare +
// select + reduce over [K, strip] per subspace.  Here one query's table
// row (M*K f32, 8 KB at M=8, K=256) sits in shared memory, and each
// thread takes candidates and does M shared-memory lookups.  Each block
// walks CHUNK candidates so the table load is amortised; threads of a
// warp read consecutive candidate codes (coalesced).  Codes are u8, or
// int32 for K > 256.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 4096;     // candidates per block

template <typename CodeT>
__global__ void __launch_bounds__(THREADS)
rerank_kernel(const float* __restrict__ tab,      // [B, M*K]
              const CodeT* __restrict__ cand,     // [B, M, S]
              float* __restrict__ out,            // [B, S]
              int M, int K, int S) {
  extern __shared__ float tab_s[];
  const int b = blockIdx.y;
  const int MK = M * K;
  for (int i = threadIdx.x; i < MK; i += THREADS)
    tab_s[i] = tab[(size_t)b * MK + i];
  __syncthreads();
  const CodeT* cb = cand + (size_t)b * M * S;
  const int s_end = min(S, (blockIdx.x + 1) * CHUNK);
  for (int s = blockIdx.x * CHUNK + threadIdx.x; s < s_end; s += THREADS) {
    float acc = 0.0f;
    for (int m = 0; m < M; ++m)
      acc = __fadd_rn(acc, tab_s[m * K + (int)cb[(size_t)m * S + s]]);
    out[(size_t)b * S + s] = acc;
  }
}

}  // namespace

// code_bytes 1 (u8 candidates) or 4 (int32).  Returns cudaGetLastError()
// after the launch.
extern "C" int rerank_launch(const void* tab, const void* cand, void* out,
                             int B, int M, int K, int S, int code_bytes,
                             void* stream) {
  if (B == 0 || S == 0) return (int)cudaSuccess;
  const size_t smem = sizeof(float) * M * K;
  dim3 grid((S + CHUNK - 1) / CHUNK, B);
  auto st = static_cast<cudaStream_t>(stream);
  auto* tp = static_cast<const float*>(tab);
  auto* op = static_cast<float*>(out);
  if (code_bytes == 1)
    rerank_kernel<uint8_t><<<grid, THREADS, smem, st>>>(
        tp, static_cast<const uint8_t*>(cand), op, M, K, S);
  else if (code_bytes == 4)
    rerank_kernel<int32_t><<<grid, THREADS, smem, st>>>(
        tp, static_cast<const int32_t*>(cand), op, M, K, S);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Human-readable name of a CUDA error code returned by a launch.
extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
