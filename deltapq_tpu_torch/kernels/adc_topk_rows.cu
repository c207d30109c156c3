// An alternative layout for the packed ADC top-k (B9, csrc/adc_topk.cu),
// built and timed only by kernels/ablate_packed.py; the package's library
// does not contain it.
//
// B9 gives each lane of a warp its own row and one query: the 32 lookups of
// a warp fall on 32 random banks of shared memory, and the worst bank takes
// about 3.5 of them.  Here the lanes of a warp meet one row (two at f32 and
// bf16x2) with many queries: the block's table is [M*K][QL] entries (QL = 16
// queries of 4-byte entries, 32 of 2-byte ones, 128 KB at M=8, K=256), so
// the lookups of one code fall on consecutive words -- one wavefront at
// bf16, 1.5 on average where two half-warps meet two rows.  The selection
// is then per lane: each lane keeps its query's best keys in a sorted list
// of LK registers and inserts alone (the warp diverges on an insert), and
// at a tile's end the two half-warps' lists of a query merge.
//
// Shapes: u8 codes with M = 8 (one 8-byte row), K <= 256, top_k <= LK = 16;
// anything else returns cudaErrorInvalidValue.  The keys are B9's bit for
// bit (the same sums in the same order, the same packed key).

#include <limits.h>

#include "adc_lookup.cuh"

namespace {

using adc::FULL;

constexpr int LK = 16;          // keys a lane keeps
constexpr int WARPS_PB = 16;    // warps a block

template <int P>
struct Rows {
  using E = typename adc::Entry<P>::type;
  static constexpr int QL = sizeof(E) == 2 ? 32 : 16;   // queries a block
  static constexpr int RPS = 32 / QL;                   // rows a step
};

// Insert k into the sorted list: every larger key moves one down.
__device__ __forceinline__ void lane_insert(int (&key)[LK], int k) {
#pragma unroll
  for (int j = LK - 1; j > 0; --j)
    key[j] = k < key[j - 1] ? key[j - 1] : (k < key[j] ? k : key[j]);
  key[0] = min(key[0], k);
}

__device__ __forceinline__ int kth(const int (&key)[LK], int k) {
  int x = key[0];
#pragma unroll
  for (int j = 1; j < LK; ++j)
    if (j == k) x = key[j];
  return x;
}

template <int P>
__global__ void __launch_bounds__(WARPS_PB * 32, 1)
adc_topk_rows_kernel(const typename adc::Entry<P>::type* __restrict__ tab,
                     const uint2* __restrict__ codes,   // [N_pad] rows of 8
                     int* __restrict__ out,             // [nT, top_k, B]
                     int B, int K, int nT, int tile_n, int n_valid,
                     int top_k) {
  using R = Rows<P>;
  using E = typename R::E;
  constexpr int QL = R::QL, RPS = R::RPS, M = 8;
  extern __shared__ __align__(16) unsigned char smem[];
  E* tab_s = reinterpret_cast<E*>(smem);                // [M*K][QL]
  const int MK = M * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.y * QL;
  for (int i = threadIdx.x; i < QL * MK; i += blockDim.x) {
    const int ql = i / MK, mk = i - ql * MK;
    tab_s[mk * QL + ql] = q0 + ql < B ? tab[(size_t)(q0 + ql) * MK + mk]
                                      : E(0);
  }
  __syncthreads();
  const int ql = lane % QL, half = lane / QL;
  const E* tq = tab_s + ql;
  for (int t = blockIdx.x * WARPS_PB + warp; t < nT;
       t += gridDim.x * WARPS_PB) {
    int key[LK];
#pragma unroll
    for (int j = 0; j < LK; ++j) key[j] = adc::KEY_BIG;
    int tau = adc::KEY_BIG;
    const long long row0 = (long long)t * tile_n;
    for (int r0 = 0; r0 < tile_n; r0 += 32) {
      const int mine = r0 + lane;
      const uint2 cw = mine < tile_n ? codes[row0 + mine] : make_uint2(0, 0);
#pragma unroll 4
      for (int s = 0; s < 32; s += RPS) {
        const int src = s + half;
        const unsigned lo = __shfl_sync(FULL, cw.x, src);
        const unsigned hi = __shfl_sync(FULL, cw.y, src);
        float acc = 0.0f;
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const unsigned c = ((m < 4 ? lo : hi) >> (8 * (m & 3))) & 0xffu;
          acc = adc::add_entry<P>(acc, tq[(m * K + (int)c) * QL]);
        }
        const int row = r0 + src;
        const int k = adc::packed_key(acc, row,
                                      row < tile_n && row0 + row < n_valid);
        if (k < tau) {
          lane_insert(key, k);
          tau = kth(key, top_k - 1);
        }
      }
    }
    if (RPS == 2) {   // the other half-warp's keys of the same query
#pragma unroll
      for (int j = 0; j < LK; ++j) {
        const int k = __shfl_xor_sync(FULL, key[j], 16);
        if (half == 0 && k < tau) {
          lane_insert(key, k);
          tau = kth(key, top_k - 1);
        }
      }
    }
    if (half == 0 && q0 + ql < B) {
#pragma unroll
      for (int j = 0; j < LK; ++j)
        if (j < top_k) out[((size_t)t * top_k + j) * B + q0 + ql] = key[j];
    }
  }
}

template <int P>
cudaError_t launch(const void* tab, const void* codes, int* out, int B,
                   int K, int n_pad, int tile_n, int n_valid, int top_k,
                   cudaStream_t st) {
  using R = Rows<P>;
  auto kernel = adc_topk_rows_kernel<P>;
  const size_t smem = sizeof(typename R::E) * R::QL * 8 * K;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int nT = n_pad / tile_n;
  const int nqg = (B + R::QL - 1) / R::QL;
  int bpg = sms / nqg;                        // blocks of a query group
  bpg = bpg < 1 ? 1 : bpg;
  const int need = (nT + WARPS_PB - 1) / WARPS_PB;
  bpg = bpg > need ? need : bpg;
  kernel<<<dim3(bpg, nqg), WARPS_PB * 32, smem, st>>>(
      static_cast<const typename R::E*>(tab),
      static_cast<const uint2*>(codes), out, B, K, nT, tile_n, n_valid,
      top_k);
  return cudaGetLastError();
}

}  // namespace

// adc_topk_packed_launch's signature (csrc/adc_topk.cu), for the shapes in
// the header.
extern "C" int adc_topk_packed_launch(const void* tab, const void* codes,
                                      void* out, int B, int M, int K,
                                      int n_pad, int tile_n, int n_valid,
                                      int top_k, int code_bytes, int prec,
                                      void* stream) {
  if (n_pad == 0 || B == 0 || top_k == 0) return (int)cudaSuccess;
  if (M != 8 || K > 256 || code_bytes != 1 || top_k > LK
      || tile_n > adc::MAX_TILE || n_pad % tile_n)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<int*>(out);
  switch (prec) {
    case adc::F32:
      return (int)launch<adc::F32>(tab, codes, o, B, K, n_pad, tile_n,
                                   n_valid, top_k, st);
    case adc::BF16:
      return (int)launch<adc::BF16>(tab, codes, o, B, K, n_pad, tile_n,
                                    n_valid, top_k, st);
    case adc::BF16X2:
      return (int)launch<adc::BF16X2>(tab, codes, o, B, K, n_pad, tile_n,
                                      n_valid, top_k, st);
  }
  return (int)cudaErrorInvalidValue;
}
