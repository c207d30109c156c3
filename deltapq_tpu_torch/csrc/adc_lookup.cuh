// What the ADC lookup kernels share (adc_dists.cu, adc_topk.cu,
// adc_topk_tiledict.cu): the table types of the three precisions, staging a
// block's table rows in shared memory, a row's ascending-m lookup sum, the
// order-preserving packed key and the block-wide packed top-k sweeps (the
// tile-dictionary kernel's selection).
//
// The TPU kernels (deltapq_tpu/ops/adc_pallas.py) have no per-lane gather
// and select table values with one-hot [tile, K] x [K, B] matmuls; on the
// card the same selection is a lookup in shared memory.  A one-hot product
// selects its table value exactly, so the lookup returns the same bits.
//
// Precisions, as adc_pallas.py:_accumulate_onehot adds them (f32
// accumulator from 0.0f, ascending m, __fadd_rn so nothing is contracted):
//   F32     one f32 value per entry;
//   BF16    one bf16 value per entry (the table rounded by the wrapper);
//   BF16X2  a bf16 (hi, lo) pair per entry, hi in the low half of a 32-bit
//           word: for each m the hi value is added, then the lo value.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace adc {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int ROW_BITS = 12;          // tile-local row in the key's low bits
constexpr int MAX_TILE = 1 << ROW_BITS;
constexpr int KEYS = MAX_TILE / THREADS;   // keys a thread holds
constexpr int KEY_BIG = 0x7fffffff;

enum Prec { F32 = 0, BF16 = 1, BF16X2 = 2 };

template <int P> struct Entry { using type = float; };
template <> struct Entry<BF16> { using type = uint16_t; };
template <> struct Entry<BF16X2> { using type = uint32_t; };

__host__ __device__ inline size_t entry_bytes(int prec) {
  return prec == BF16 ? 2 : 4;
}

template <int P>
__device__ __forceinline__ float add_entry(float acc,
                                           typename Entry<P>::type e);
template <>
__device__ __forceinline__ float add_entry<F32>(float acc, float e) {
  return __fadd_rn(acc, e);
}
template <>
__device__ __forceinline__ float add_entry<BF16>(float acc, uint16_t e) {
  return __fadd_rn(acc, __uint_as_float((uint32_t)e << 16));
}
template <>
__device__ __forceinline__ float add_entry<BF16X2>(float acc, uint32_t e) {
  acc = __fadd_rn(acc, __uint_as_float(e << 16));
  return __fadd_rn(acc, __uint_as_float(e & 0xffff0000u));
}

// dst[0 .. count) = src[0 .. count), by the whole block
template <typename E>
__device__ __forceinline__ void stage(E* dst, const E* __restrict__ src,
                                      int count) {
  for (int i = threadIdx.x; i < count; i += THREADS) dst[i] = src[i];
}

// sum_m T[m*K + c[m]] of one row, ascending m from 0.0f
template <int P, typename CodeT>
__device__ __forceinline__ float row_sum(const typename Entry<P>::type* T,
                                         const CodeT* __restrict__ c, int M,
                                         int K) {
  float acc = 0.0f;
  for (int m = 0; m < M; ++m) acc = add_entry<P>(acc, T[m * K + (int)c[m]]);
  return acc;
}

// adc_pallas.py:166-177: the f32 bits as an int32 that orders as the
// float does (the low 31 bits of a negative value flipped), the low 12
// bits replaced by the tile-local row; KEY_BIG for a row past n_valid.
__device__ __forceinline__ int packed_key(float d, int row, bool valid) {
  int bits = __float_as_int(d);
  bits ^= (bits >> 31) & 0x7fffffff;
  return valid ? ((bits & ~(MAX_TILE - 1)) | row) : KEY_BIG;
}

// adc_pallas.py:178-182: top_k sweeps last = min(key where key > last)
// from INT_MIN over the block's keys (KEYS per thread, in registers; keys
// are unique, so there is no mask state).  A sweep is a per-thread min, a
// warp reduce and one barrier: red is [2][WARPS], used in turns, with one
// more barrier after the last sweep.  Thread 0 writes sweep s to
// out[s * stride].
__device__ __forceinline__ void packed_sweeps(const int (&key)[KEYS],
                                              int top_k, int* out,
                                              size_t stride,
                                              int (*red)[WARPS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int last = INT_MIN;
  for (int s = 0; s < top_k; ++s) {
    int v = KEY_BIG;
#pragma unroll
    for (int i = 0; i < KEYS; ++i)
      if (key[i] > last) v = min(v, key[i]);
    v = __reduce_min_sync(FULL, v);
    int* r = red[s & 1];
    if (lane == 0) r[warp] = v;
    __syncthreads();
    v = r[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v = min(v, r[w]);
    last = v;
    if (threadIdx.x == 0) out[(size_t)s * stride] = last;
  }
  __syncthreads();   // red is free for the next query's sweeps
}

// One tile's packed top-k for one query whose table row T is staged in
// shared memory: keys of rows tid, tid + THREADS, ... then the sweeps.
template <int P, typename CodeT>
__device__ __forceinline__ void packed_tile_topk(
    const typename Entry<P>::type* T, const CodeT* __restrict__ codes,
    long long row0, int tile_n, int n_valid, int M, int K, int top_k,
    int* out, size_t stride, int (*red)[WARPS]) {
  int key[KEYS];
#pragma unroll
  for (int i = 0; i < KEYS; ++i) {
    const int r = threadIdx.x + i * THREADS;
    key[i] = KEY_BIG;
    if (r < tile_n)
      key[i] = packed_key(row_sum<P, CodeT>(T, codes + (row0 + r) * M, M, K),
                          r, row0 + r < n_valid);
  }
  packed_sweeps(key, top_k, out, stride, red);
}

}  // namespace adc
