// Block-wide pieces of a tile decode, shared by the stream kernel
// (stream_mins.cu) and the slot-tile kernel (delta_mins.cu).  Thread i of
// the 256-thread block owns the RPT = 4 consecutive rows 4i..4i+3 of a
// 1024-row tile, so thread order is row order and a scan over the block is
// a scan down the tile.
//
// They replace the TPU kernels' lane-parallel workarounds
// (deltapq_tpu/ops/fused_pallas.py): the Hillis-Steele roll chains along
// the lanes for prefix counts and for the forward fill, and the
// triangular-matmul prefix sums.  Here each is a warp shuffle scan plus a
// block prefix over the 8 warp totals in shared memory.

#pragma once

#include "scan_tail.cuh"

namespace tile_decode {

using namespace scan_tail;

constexpr int RPT = TILE / THREADS;      // rows per thread

// Shared memory a decode needs after the tail's operands:
// codes [TILE, MMAX] u8 | wsum [WARPS] int | wlast [WARPS, MMAX] int.
struct Scratch {
  uint8_t* codes;
  int* wsum;
  int* wlast;
};

__host__ __device__ inline size_t scratch_bytes() {
  return TILE * MMAX + sizeof(int) * WARPS + sizeof(int) * WARPS * MMAX;
}

__device__ inline Scratch scratch(unsigned char* base) {
  Scratch s;
  s.codes = base;
  s.wsum = reinterpret_cast<int*>(base + TILE * MMAX);
  s.wlast = s.wsum + WARPS;
  return s;
}

// Exclusive prefix sum of the per-thread totals tsum in thread (= row)
// order.  Contains a __syncthreads(); call it once per kernel.
__device__ __forceinline__ int block_exclusive_sum(int tsum, int* wsum_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = tsum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) wsum_s[warp] = incl;
  __syncthreads();
  int off = incl - tsum;
  for (int w = 0; w < warp; ++w) off += wsum_s[w];
  return off;
}

// Forward fill down the tile.  Row 4*tid+i has written its own values to
// codes_s for the subspaces set in set[i]; every other subspace m of the
// row takes the value of the last row above it that sets m, found by a
// max-scan of "last row setting m" (row 0 sets every subspace).  The
// filled codes go back to codes_s and, when codes_out is not null, to
// codes_out [TILE, M].  Ends with a __syncthreads(), so the tile is ready
// for the scan tail.
__device__ __forceinline__ void forward_fill(const unsigned (&set)[RPT],
                                             uint8_t* codes_s,
                                             int* wlast_s, int M,
                                             uint8_t* codes_out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = tid * RPT;
  int last[RPT][MMAX];
  int agg[MMAX];
#pragma unroll
  for (int m = 0; m < MMAX; ++m) {
    int ls = -1;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (m < M && (set[i] >> m & 1u)) ls = r0 + i;
      last[i][m] = ls;
    }
    agg[m] = ls;
  }
  int excl[MMAX];
#pragma unroll
  for (int m = 0; m < MMAX; ++m) {
    int v = agg[m];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int w = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v = max(v, w);
    }
    const int ex = __shfl_up_sync(FULL, v, 1);
    excl[m] = lane == 0 ? -1 : ex;
    if (lane == 31) wlast_s[warp * MMAX + m] = v;
  }
  __syncthreads();   // raw values and warp aggregates visible
  uint8_t code[RPT][MMAX];
#pragma unroll
  for (int m = 0; m < MMAX; ++m) {
    int pre = excl[m];
    for (int w = 0; w < warp; ++w) pre = max(pre, wlast_s[w * MMAX + m]);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      // row 0 sets every subspace, so src >= 0 on well-formed tiles; the
      // clamp keeps a malformed tile inside the buffer
      const int src = max(max(pre, last[i][m]), 0);
      code[i][m] = (m < M) ? codes_s[src * MMAX + m] : 0;
    }
  }
  __syncthreads();   // every fill read done before overwriting
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int m = 0; m < MMAX; ++m) codes_s[(r0 + i) * MMAX + m] = code[i][m];
  if (codes_out != nullptr) {
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      for (int m = 0; m < M; ++m) codes_out[(r0 + i) * M + m] = code[i][m];
  }
  __syncthreads();
}

}  // namespace tile_decode
