// ADC distances per tile + tile-local top-k by mask-argmin.
//
// Replaces the TPU kernel deltapq_tpu/ops/adc_pallas.py:_adc_topk_kernel
// (with _accumulate_onehot) in its three precisions, reached from
// adc_topk_pallas.  Python wrapper, plain PyTorch version and the
// cross-tile merge: deltapq_tpu_torch/ops/adc_kernels.py.
//
// What it computes, per tile t of tile_n rows and query b:
//   dist[r] = sum_m tab[b, m*K + codes[t*tile_n + r, m]], added in
//             ascending m from 0.0f with __fadd_rn: of f32 table values
//             ("f32", bit-equal to the plain scan, ops/adc.py
//             adc_query_topk), of the table rounded to bf16 ("bf16"), or of
//             its bf16 hi and lo parts, hi then lo for each m ("bf16x2");
//             +inf at rows >= n_valid;
//   then top_k rounds of mask-argmin, as the TPU kernel: each round takes
//   the smallest (value, row) -- the lower row wins a tie, as argmin --
//   writes it to out_d/out_i[t, j, b] (tile-local row) and sets that
//   row's value to +inf (the row stays a candidate, so a tile with fewer
//   than top_k finite rows repeats the lowest row at +inf, as argmin
//   over an all-inf column does).
//
// What bounds it on an H100: shared-memory table lookups (N*B*M = 4.3e9
// at N=1M, B=512, M=8) and, for small top_k, the latency of the
// selection rounds (two block barriers each).  The bf16 modes buy no
// speed here (the TPU takes them for fewer matrix-unit passes); they
// exist because they select on rounded tables.
//
// Design: the TPU has no per-lane gather and does a one-hot [tile, K] x
// [K, B] matmul per subspace.  Here a block holds QC queries' [M*K] table
// rows in shared memory (QC*M*K entries of 4 or 2 bytes, dynamic shared
// memory above 48 KB) and the current query's tile distances; every
// thread keeps the (value, row) minimum of its strided rows, so a
// selection round is a warp shuffle-reduce, a block reduce over the
// warps, and one rescan by the winning thread.

#include <math_constants.h>

#include "adc_lookup.cuh"

namespace {

using adc::FULL;
using adc::THREADS;
using adc::WARPS;

__device__ __forceinline__ bool less_vr(float v, int r, float ov, int orr) {
  return ov < v || (ov == v && orr < r);
}

// (value, row) minimum of this thread's rows tid, tid + THREADS, ...
__device__ __forceinline__ void local_min(const float* dist_s, int tile_n,
                                          float& v, int& r) {
  const int tid = threadIdx.x;
  v = dist_s[tid];
  r = tid;
  for (int i = tid + THREADS; i < tile_n; i += THREADS) {
    const float x = dist_s[i];
    if (x < v) {
      v = x;
      r = i;
    }
  }
}

template <int P, typename CodeT>
__global__ void __launch_bounds__(THREADS)
adc_topk_kernel(const typename adc::Entry<P>::type* __restrict__ tab,
                                                    // [B, M*K] entries
                const CodeT* __restrict__ codes,    // [N_pad, M]
                float* __restrict__ out_d,          // [nT, top_k, B]
                int* __restrict__ out_i,            // [nT, top_k, B]
                int B, int M, int K, int tile_n, int n_valid, int top_k,
                int QC) {
  using E = typename adc::Entry<P>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int MK = M * K;
  float* dist_s = reinterpret_cast<float*>(smem);             // [tile_n]
  E* tab_s = reinterpret_cast<E*>(smem + sizeof(float) * tile_n);  // [QC, MK]
  __shared__ float red_v[WARPS];
  __shared__ int red_r[WARPS];
  __shared__ int win_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x;
  const int q0 = blockIdx.y * QC;
  const int nq = min(QC, B - q0);
  adc::stage(tab_s, tab + (size_t)q0 * MK, nq * MK);
  __syncthreads();

  const long long row0 = (long long)t * tile_n;
  for (int j = 0; j < nq; ++j) {
    const E* T = tab_s + (size_t)j * MK;
    for (int r = tid; r < tile_n; r += THREADS) {
      const float acc = adc::row_sum<P, CodeT>(T, codes + (row0 + r) * M, M,
                                               K);
      dist_s[r] = row0 + r < n_valid ? acc : CUDART_INF_F;
    }
    __syncthreads();
    float lv;
    int lr;
    local_min(dist_s, tile_n, lv, lr);
    for (int s = 0; s < top_k; ++s) {
      float v = lv;
      int r = lr;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(FULL, v, o);
        const int orr = __shfl_xor_sync(FULL, r, o);
        if (less_vr(v, r, ov, orr)) {
          v = ov;
          r = orr;
        }
      }
      if (lane == 0) {
        red_v[warp] = v;
        red_r[warp] = r;
      }
      __syncthreads();
      if (warp == 0) {
        v = lane < WARPS ? red_v[lane] : CUDART_INF_F;
        r = lane < WARPS ? red_r[lane] : 0x7fffffff;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(FULL, v, o);
          const int orr = __shfl_xor_sync(FULL, r, o);
          if (less_vr(v, r, ov, orr)) {
            v = ov;
            r = orr;
          }
        }
        if (lane == 0) {
          const size_t o = ((size_t)t * top_k + s) * B + q0 + j;
          out_d[o] = v;
          out_i[o] = r;
          win_s = r;
        }
      }
      __syncthreads();
      const int win = win_s;
      if (win % THREADS == tid) {
        dist_s[win] = CUDART_INF_F;
        local_min(dist_s, tile_n, lv, lr);
      }
    }
    __syncthreads();   // dist_s is rewritten for the next query
  }
}

template <int P, typename CodeT>
cudaError_t launch(const void* tab, const void* codes, float* out_d,
                   int* out_i, int B, int M, int K, int n_pad, int tile_n,
                   int n_valid, int top_k, int QC, cudaStream_t st) {
  const size_t smem = sizeof(float) * tile_n
                      + adc::entry_bytes(P) * (size_t)QC * M * K;
  // every template instance needs its own opt-in above 48 KB
  cudaError_t e = cudaFuncSetAttribute(
      adc_topk_kernel<P, CodeT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(n_pad / tile_n, (B + QC - 1) / QC);
  adc_topk_kernel<P, CodeT><<<grid, THREADS, smem, st>>>(
      static_cast<const typename adc::Entry<P>::type*>(tab),
      static_cast<const CodeT*>(codes), out_d, out_i, B, M, K, tile_n,
      n_valid, top_k, QC);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_codes(int code_bytes, const void* tab, const void* codes,
                         float* out_d, int* out_i, int B, int M, int K,
                         int n_pad, int tile_n, int n_valid, int top_k,
                         int QC, cudaStream_t st) {
  if (code_bytes == 1)
    return launch<P, uint8_t>(tab, codes, out_d, out_i, B, M, K, n_pad,
                              tile_n, n_valid, top_k, QC, st);
  if (code_bytes == 4)
    return launch<P, int32_t>(tab, codes, out_d, out_i, B, M, K, n_pad,
                              tile_n, n_valid, top_k, QC, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// prec 0 (tab f32 [B, M*K]), 1 (bf16 [B, M*K]) or 2 (bf16 [B, M*K, 2]: hi,
// lo); code_bytes 1 (u8 codes) or 4 (int32 codes, K > 256); tile_n a
// multiple of 256 dividing n_pad; QC queries per block, sized by the
// Python wrapper so that 4*tile_n + QC*M*K entries fit in shared memory.
// Returns cudaGetLastError() after the launch.
extern "C" int adc_topk_launch(const void* tab, const void* codes,
                               void* out_d, void* out_i, int B, int M, int K,
                               int n_pad, int tile_n, int n_valid, int top_k,
                               int QC, int code_bytes, int prec,
                               void* stream) {
  if (n_pad == 0 || B == 0 || top_k == 0) return (int)cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  auto* dp = static_cast<float*>(out_d);
  auto* ip = static_cast<int*>(out_i);
  switch (prec) {
    case adc::F32:
      return (int)launch_codes<adc::F32>(code_bytes, tab, codes, dp, ip, B,
                                         M, K, n_pad, tile_n, n_valid, top_k,
                                         QC, st);
    case adc::BF16:
      return (int)launch_codes<adc::BF16>(code_bytes, tab, codes, dp, ip, B,
                                          M, K, n_pad, tile_n, n_valid,
                                          top_k, QC, st);
    case adc::BF16X2:
      return (int)launch_codes<adc::BF16X2>(code_bytes, tab, codes, dp, ip,
                                            B, M, K, n_pad, tile_n, n_valid,
                                            top_k, QC, st);
  }
  return (int)cudaErrorInvalidValue;
}
