// What the ADC lookup kernels share (adc_dists.cu, adc_topk.cu): the table
// types of the three precisions and the order-preserving packed key.
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

constexpr unsigned FULL = 0xffffffffu;
constexpr int ROW_BITS = 12;          // tile-local row in the key's low bits
constexpr int MAX_TILE = 1 << ROW_BITS;
constexpr int KEY_BIG = 0x7fffffff;

enum Prec { F32 = 0, BF16 = 1, BF16X2 = 2 };

template <int P> struct Entry { using type = float; };
template <> struct Entry<BF16> { using type = uint16_t; };
template <> struct Entry<BF16X2> { using type = uint32_t; };

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

// adc_pallas.py:166-177: the f32 bits as an int32 that orders as the
// float does (the low 31 bits of a negative value flipped), the low 12
// bits replaced by the tile-local row; KEY_BIG for a row past n_valid.
__device__ __forceinline__ int packed_key(float d, int row, bool valid) {
  int bits = __float_as_int(d);
  bits ^= (bits >> 31) & 0x7fffffff;
  return valid ? ((bits & ~(MAX_TILE - 1)) | row) : KEY_BIG;
}

}  // namespace adc
