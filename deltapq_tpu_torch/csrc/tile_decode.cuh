// Block-wide pieces of a tile decode, shared by the stream kernels
// (stream_mins.cu, stream_mins_pipelined.cu) and the slot-tile kernel
// (delta_mins.cu).  Thread i of the 256-thread block owns the RPT = 4
// consecutive rows 4i..4i+3 of a 1024-row tile, so thread order is row
// order and a scan over the block is a scan down the tile.
//
// They replace the TPU kernels' lane-parallel workarounds
// (deltapq_tpu/ops/fused_pallas.py: _stream_decode and the decode of
// _delta_mins_kernel): the Hillis-Steele roll chains along the lanes for
// prefix counts and for the forward fill, and the triangular-matmul
// prefix sums.  Here each is a warp shuffle scan plus a block prefix over
// the 8 warp totals in shared memory.
//
// Everything is a template on MS, the code bytes a row has in the shared
// code tile: 8 for the narrow scan tails (M <= 8, one mask plane), 16 for
// the wide ones (M <= 16, two mask planes; a row's set mask is then 16
// bits, bit j of plane p being subspace 8p + j).

#pragma once

#include "scan_tail.cuh"

namespace tile_decode {

using namespace scan_tail;

constexpr int RPT = TILE / THREADS;      // rows per thread

// Shared memory a decode needs after the tail's operands:
// codes [TILE, MS] u8 | wsum [WARPS] int | wlast [WARPS, MS] int.
struct Scratch {
  uint8_t* codes;
  int* wsum;
  int* wlast;
};

template <int MS>
__host__ __device__ inline size_t scratch_bytes() {
  return TILE * MS + sizeof(int) * WARPS + sizeof(int) * WARPS * MS;
}

template <int MS>
__device__ inline Scratch scratch(unsigned char* base) {
  Scratch s;
  s.codes = base;
  s.wsum = reinterpret_cast<int*>(base + TILE * MS);
  s.wlast = s.wsum + WARPS;
  return s;
}

// A row's set mask from the P = ceil(M/8) mask planes [P, TILE].
template <int MS>
__device__ __forceinline__ unsigned row_mask(const uint8_t* planes, int r,
                                             int M) {
  unsigned mask = planes[r];
  if (MS > 8 && M > 8) mask |= (unsigned)planes[TILE + r] << 8;
  return mask & ((1u << M) - 1u);
}

// Exclusive prefix sum of the per-thread totals tsum in thread (= row)
// order.  Contains one __syncthreads(); a second call may follow only
// after another block-wide barrier (forward_fill has three).
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
// max-scan of "last row setting m" (row 0 sets every subspace).  Only the
// scan's per-subspace exclusive prefix stays in registers: the last
// setting row inside a thread's own four rows is read off the masks
// again, so 16 subspaces cost 16 registers, not 16 x 5.  The filled codes
// go back to codes_s and, when codes_out is not null, to codes_out
// [TILE, M].  Ends with a __syncthreads(), so the tile is ready for the
// scan tail.
template <int MS>
__device__ __forceinline__ void forward_fill(const unsigned (&set)[RPT],
                                             uint8_t* codes_s,
                                             int* wlast_s, int M,
                                             uint8_t* codes_out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = tid * RPT;
  int excl[MS];
#pragma unroll
  for (int m = 0; m < MS; ++m) {
    int v = -1;
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      if (set[i] >> m & 1u) v = r0 + i;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int w = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v = max(v, w);
    }
    const int ex = __shfl_up_sync(FULL, v, 1);
    excl[m] = lane == 0 ? -1 : ex;
    if (lane == 31) wlast_s[warp * MS + m] = v;
  }
  __syncthreads();   // raw values and warp aggregates visible
  unsigned code[RPT][MS / 4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int w = 0; w < MS / 4; ++w) code[i][w] = 0u;
#pragma unroll
  for (int m = 0; m < MS; ++m) {
    int last = excl[m];
    for (int w = 0; w < warp; ++w) last = max(last, wlast_s[w * MS + m]);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (set[i] >> m & 1u) last = r0 + i;
      // row 0 sets every subspace, so last >= 0 on well-formed tiles; the
      // clamp keeps a malformed tile inside the buffer
      const unsigned c = m < M ? codes_s[max(last, 0) * MS + m] : 0u;
      code[i][m / 4] |= c << (8 * (m % 4));
    }
  }
  __syncthreads();   // every fill read done before overwriting
  unsigned* rows_s = reinterpret_cast<unsigned*>(codes_s + r0 * MS);
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int w = 0; w < MS / 4; ++w) rows_s[i * (MS / 4) + w] = code[i][w];
  if (codes_out != nullptr) {
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int m = 0; m < MS; ++m)
        if (m < M)
          codes_out[(r0 + i) * M + m] =
              (uint8_t)(code[i][m / 4] >> (8 * (m % 4)));
  }
  __syncthreads();
}

// Decode of one stream tile into sc.codes (and codes_out when not null):
// planes [P, TILE] are the tile's mask planes; the row's j-th set subspace
// reads its value at stream position p = base + (diffs of the rows above
// in the tile) + j, which lives at vals[(p/1024)*1024 + (p%8)*128 +
// (p/8)%128] (ops/stream_tiles.py).  planes and vals may point to global
// or to shared memory; base is relative to vals.
template <int MS>
__device__ __forceinline__ void stream_decode(const uint8_t* planes,
                                              const uint8_t* vals,
                                              long long base,
                                              const Scratch& sc, int M,
                                              uint8_t* codes_out) {
  const int r0 = threadIdx.x * RPT;
  unsigned mask[RPT];
  int tsum = 0;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    mask[i] = row_mask<MS>(planes, r0 + i, M);
    tsum += __popc(mask[i]);
  }
  long long p = base + block_exclusive_sum(tsum, sc.wsum);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    for (int m = 0; m < M; ++m) {
      if (mask[i] >> m & 1u) {
        const long long idx = (p >> 10 << 10) + (p & 7) * 128
                              + ((p >> 3) & 127);
        sc.codes[(r0 + i) * MS + m] = vals[idx];
        ++p;
      }
    }
  }
  forward_fill<MS>(mask, sc.codes, sc.wlast, M, codes_out);
}

}  // namespace tile_decode
