// The scan tails shared by the stream kernel (stream_mins.cu), the codes
// kernel (codes_mins.cu), the slot-tile kernel (delta_mins.cu) and the
// pipelined stream kernel (stream_mins_pipelined.cu): a 1024-row tile of
// codes in shared memory -> x^ gathered from the codebook -> pre - 2 cross
// per (row, query) -> 32-row subtile minima.
//
// Replaces the tail of the TPU kernels deltapq_tpu/ops/fused_pallas.py:
// _scan_tail (its int16, int8 and bf16 branches), which decodes codes ->
// x^ with a one-hot matmul because the TPU has no per-lane gather.  Here
// each lane gathers its row's codeword words from the codebook.
//
// What bounds a tail on an H100: its dot products (2 rows x queries x D
// operations, x4 at int16).  On the CUDA cores (__dp4a, f32 fma) they cost
// 20-50 times the tensor cores' time, and every subtile minimum costs five
// shuffles a query.  So the narrow shapes of the stream, codes and
// slot-tile kernels run the MmaTail structs below (mma.sync, three
// shuffles for two queries), and their wide shapes (up to M=16, D=1024)
// the gathered wgmma tail of wide_mma.cuh.  The CUDA-core tails stay for
// the pipelined stream kernel (Int8Tail, Bf16Tail).
//
// The CUDA-core structs share one interface (load the operands; scan the
// subtiles S_LO <= s < S_HI of a code tile, all 32 by default -- the
// pipelined stream kernel scans a tile in two halves; the bounds are
// template arguments so that the subtile loop unrolls either way):
//
//   Int8Tail   codewords and queries as one int8 value each (step scale);
//              cross is one exact int32 __dp4a chain, pre the exact int32
//              sum of per-codeword norms (both below 127^2 * 128 < 2^24,
//              so exact in f32); then cross * u[b] and pre - 2 cross
//              round once each, in the JAX order, with _rn intrinsics
//              (no fma contraction): bit-equal to the plain version.
//   Bf16Tail   x^ and q are bf16 values; each product of two bf16 values
//              is exact in f32, so cross = sum x^ q is an f32 fma chain
//              (only the order of summation differs from the matrix
//              unit's); pre = sum over m of per-codeword f32 norms of
//              the bf16 x^, added in ascending m.  No u factor.
//   (int16)    codewords and queries as two base-128 int8 digits
//              (A = 128a + b); aa, p2, bb are exact int32 sums, cross =
//              ((16384 aa + 128 p2) + bb) * u[b] in the JAX order with _rn
//              intrinsics; pre = sum A^2 exact in int64 from per-codeword
//              norms, rounded once (MmaTail and wide_mma.cuh).
//
// Layout of the work, narrow CUDA-core tails (M <= 8 and M*Ds <= 128;
// Int8Tail, Bf16Tail): 256 threads; the compact codebook, the norms and
// the queries sit in shared memory; each warp takes 32-row subtiles, a
// lane holds its row's whole x^ in registers, reads each query's operand
// as broadcast 16-byte shared loads, and the subtile min is a warp
// shuffle-reduce.
//
// The TPU kernel splits the subspaces of a wide shape into G = 2 groups
// of 8, because a [TILE, 4096] one-hot and a [4096, 1024] codebook do not
// fit its VMEM; no tail here carries that banding over (wide_mma.cuh sums
// a whole row at once).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma.cuh"

namespace scan_tail {

constexpr int TILE = 1024;
constexpr int SUB = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int QB = 64;                   // queries per block
constexpr int MMAX = 8;                  // code bytes per row, narrow tails
constexpr int MSW = 16;                  // code bytes per row, wide tails
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// bf16 pair in one 32-bit word (element 2i low, 2i+1 high) -> f32, exact
__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ float warp_min(float d) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) d = fminf(d, __shfl_xor_sync(FULL, d, o));
  return d;
}

// The 32 rows of a warp (lane = row; x^ as bf16 pairs in xw, D <= 2*DW)
// against QB queries held as f32 rows of 2*DW in q_s: writes the subtile
// minimum of pre - 2 cross for query b to out[b], b < nb.  Used by the
// bf16 tail.
template <int DW>
__device__ __forceinline__ void bf16_subtile_mins(const unsigned (&xw)[DW],
                                                  float pre, bool valid,
                                                  const float* q_s,
                                                  float* out, int nb,
                                                  int lane) {
  for (int b0 = 0; b0 < QB; b0 += 32) {
    float mine = CUDART_INF_F;
    for (int bi = 0; bi < 32; ++bi) {
      const float4* q4 = reinterpret_cast<const float4*>(
          q_s + (b0 + bi) * 2 * DW);
      float acc = 0.0f;
#pragma unroll
      for (int w = 0; w < DW / 2; ++w) {
        const float4 Q = q4[w];
        acc = fmaf(bf16_lo(xw[2 * w]), Q.x, acc);
        acc = fmaf(bf16_hi(xw[2 * w]), Q.y, acc);
        acc = fmaf(bf16_lo(xw[2 * w + 1]), Q.z, acc);
        acc = fmaf(bf16_hi(xw[2 * w + 1]), Q.w, acc);
      }
      float d = valid ? __fsub_rn(pre, __fmul_rn(2.0f, acc)) : CUDART_INF_F;
      d = warp_min(d);
      if (lane == bi) mine = d;
    }
    if (b0 + lane < nb) out[b0 + lane] = mine;
  }
}

// ---- int8 mode ---------------------------------------------------------
// DW: 32-bit words of a row (D <= 4*DW); WS = Ds/4.
// Operands: q int8 [Dg, B]; cw int32 [M, K, WS] (four int8 values a
// word); nrm int32 [M, K] (per-codeword sum of squares, exact); u f32 [B].
template <int DW>
struct Int8Tail {
  static constexpr int MS = MMAX, QBLK = QB;
  // shared memory: nrm int32 [M*K] | cw int32 [M*K*WS] | q | u
  struct Layout {
    size_t nrm, cw, q, u, total;
  };
  __host__ __device__ static Layout layout(int M, int K, int Ds) {
    Layout s;
    s.nrm = 0;
    s.cw = s.nrm + sizeof(int) * M * K;
    s.q = align16(s.cw + sizeof(int) * M * K * (Ds / 4));
    s.u = s.q + sizeof(int) * QB * DW;
    s.total = align16(s.u + sizeof(float) * QB);
    return s;
  }

  __device__ static void load(unsigned char* smem, const void* q_,
                              const void* cw_, const void* nrm_,
                              const float* u, int B, int, int qb0, int M,
                              int K, int Ds) {
    const Layout L = layout(M, K, Ds);
    const int tid = threadIdx.x;
    const int MKW = M * K * (Ds / 4);
    auto* cw = static_cast<const int*>(cw_);
    auto* nrm = static_cast<const int*>(nrm_);
    auto* q = static_cast<const int8_t*>(q_);
    int* cw_s = reinterpret_cast<int*>(smem + L.cw);
    int* nrm_s = reinterpret_cast<int*>(smem + L.nrm);
    int8_t* qb_s = reinterpret_cast<int8_t*>(smem + L.q);
    float* u_s = reinterpret_cast<float*>(smem + L.u);
    for (int i = tid; i < MKW; i += THREADS) cw_s[i] = cw[i];
    for (int i = tid; i < M * K; i += THREADS) nrm_s[i] = nrm[i];
    const int D = M * Ds;
    const int DP = 4 * DW;                 // bytes of one query row
    for (int i = tid; i < QB * DP; i += THREADS) {
      const int b = i % QB, d = i / QB;    // consecutive b: coalesced
      qb_s[b * DP + d] =
          (d < D && qb0 + b < B) ? q[(size_t)d * B + qb0 + b] : int8_t(0);
    }
    for (int b = tid; b < QB; b += THREADS)
      u_s[b] = (qb0 + b < B) ? u[qb0 + b] : 1.0f;
  }

  // codes_s [TILE, MMAX] u8; writes mins[(t*32 + s)*B + qb0 + b]
  template <int S_LO = 0, int S_HI = TILE / SUB>
  __device__ static void scan(const unsigned char* smem,
                              const uint8_t* codes_s, float* mins, int t,
                              int B, int qb0, int n_valid, int M, int K,
                              int Ds, const void*, const void*) {
    const Layout L = layout(M, K, Ds);
    const int WS = Ds / 4;
    const int* cw_s = reinterpret_cast<const int*>(smem + L.cw);
    const int* nrm_s = reinterpret_cast<const int*>(smem + L.nrm);
    const int* q_s = reinterpret_cast<const int*>(smem + L.q);
    const float* u_s = reinterpret_cast<const float*>(smem + L.u);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int MW = M * WS;                 // words of real dims
    const int nb = min(QB, B - qb0);
    for (int s = S_LO + warp; s < S_HI; s += WARPS) {
      const int r = s * SUB + lane;
      int xw[DW];
#pragma unroll
      for (int w = 0; w < DW; ++w) {
        if (w < MW) {
          const int m = w / WS;
          const int k = codes_s[r * MMAX + m];
          xw[w] = cw_s[(m * K + k) * WS + (w - m * WS)];
        } else {
          xw[w] = 0;
        }
      }
      int pre_i = 0;
      for (int m = 0; m < M; ++m) pre_i += nrm_s[m * K + codes_s[r * MMAX + m]];
      const float pre = __int2float_rn(pre_i);   // exact: < 2^24
      const bool valid = (long long)t * TILE + r < n_valid;
      float* out = mins + ((size_t)t * (TILE / SUB) + s) * B + qb0;

      for (int b0 = 0; b0 < QB; b0 += 32) {
        float mine = CUDART_INF_F;
        for (int bi = 0; bi < 32; ++bi) {
          const int b = b0 + bi;
          const int4* q4 = reinterpret_cast<const int4*>(q_s + b * DW);
          int acc = 0;
#pragma unroll
          for (int w4 = 0; w4 < DW / 4; ++w4) {
            const int4 Q = q4[w4];
            acc = __dp4a(xw[4 * w4 + 0], Q.x, acc);
            acc = __dp4a(xw[4 * w4 + 1], Q.y, acc);
            acc = __dp4a(xw[4 * w4 + 2], Q.z, acc);
            acc = __dp4a(xw[4 * w4 + 3], Q.w, acc);
          }
          const float cross = __fmul_rn(__int2float_rn(acc), u_s[b]);
          float d = valid ? __fsub_rn(pre, __fmul_rn(2.0f, cross))
                          : CUDART_INF_F;
          d = warp_min(d);
          if (lane == bi) mine = d;
        }
        if (b0 + lane < nb) out[b0 + lane] = mine;
      }
    }
  }
};

// ---- bf16 mode ---------------------------------------------------------
// DW: 32-bit words (bf16 pairs) of a row (D <= 2*DW); WH = Ds/2.
// Operands: q bf16 [Dg, B]; cw [M, K, WH] bf16 pairs; nrm f32 [M, K]
// (per-codeword sum of x^2 of the bf16 values).
template <int DW>
struct Bf16Tail {
  static constexpr int MS = MMAX, QBLK = QB;
  // shared memory: nrm f32 [M*K] | cw [M*K*WH] words | q f32 [QB, 2*DW]
  struct Layout {
    size_t nrm, cw, q, total;
  };
  __host__ __device__ static Layout layout(int M, int K, int Ds) {
    Layout s;
    s.nrm = 0;
    s.cw = s.nrm + sizeof(float) * M * K;
    s.q = align16(s.cw + sizeof(unsigned) * M * K * (Ds / 2));
    s.total = align16(s.q + sizeof(float) * QB * 2 * DW);
    return s;
  }

  __device__ static void load(unsigned char* smem, const void* q_,
                              const void* cw_, const void* nrm_,
                              const float*, int B, int, int qb0, int M,
                              int K, int Ds) {
    const Layout L = layout(M, K, Ds);
    const int tid = threadIdx.x;
    const int MKW = M * K * (Ds / 2);
    auto* cw = static_cast<const unsigned*>(cw_);
    auto* nrm = static_cast<const float*>(nrm_);
    auto* q = static_cast<const uint16_t*>(q_);
    unsigned* cw_s = reinterpret_cast<unsigned*>(smem + L.cw);
    float* nrm_s = reinterpret_cast<float*>(smem + L.nrm);
    float* q_s = reinterpret_cast<float*>(smem + L.q);
    for (int i = tid; i < MKW; i += THREADS) cw_s[i] = cw[i];
    for (int i = tid; i < M * K; i += THREADS) nrm_s[i] = nrm[i];
    const int D = M * Ds;
    for (int i = tid; i < QB * 2 * DW; i += THREADS) {
      const int b = i % QB, d = i / QB;    // consecutive b: coalesced
      float v = 0.0f;
      if (d < D && qb0 + b < B)
        v = __uint_as_float((unsigned)q[(size_t)d * B + qb0 + b] << 16);
      q_s[b * 2 * DW + d] = v;
    }
  }

  template <int S_LO = 0, int S_HI = TILE / SUB>
  __device__ static void scan(const unsigned char* smem,
                              const uint8_t* codes_s, float* mins, int t,
                              int B, int qb0, int n_valid, int M, int K,
                              int Ds, const void*, const void*) {
    const Layout L = layout(M, K, Ds);
    const int WH = Ds / 2;
    const unsigned* cw_s = reinterpret_cast<const unsigned*>(smem + L.cw);
    const float* nrm_s = reinterpret_cast<const float*>(smem + L.nrm);
    const float* q_s = reinterpret_cast<const float*>(smem + L.q);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int MW = M * WH;
    const int nb = min(QB, B - qb0);
    for (int s = S_LO + warp; s < S_HI; s += WARPS) {
      const int r = s * SUB + lane;
      unsigned xw[DW];
#pragma unroll
      for (int w = 0; w < DW; ++w) {
        if (w < MW) {
          const int m = w / WH;
          const int k = codes_s[r * MMAX + m];
          xw[w] = cw_s[(m * K + k) * WH + (w - m * WH)];
        } else {
          xw[w] = 0u;
        }
      }
      float pre = 0.0f;
      for (int m = 0; m < M; ++m)
        pre = __fadd_rn(pre, nrm_s[m * K + codes_s[r * MMAX + m]]);
      const bool valid = (long long)t * TILE + r < n_valid;
      bf16_subtile_mins<DW>(
          xw, pre, valid, q_s,
          mins + ((size_t)t * (TILE / SUB) + s) * B + qb0, nb, lane);
    }
  }
};

// ---- narrow tails on the tensor cores -------------------------------------
// MmaTail<MODE, DWP>: the narrow shapes (M <= 8, M*Ds <= 128) with the
// products on the tensor cores, as the stream, codes and slot-tile
// kernels run them (one persistent block meets every query block of the
// batch with a tile, restaging the queries).  MODE 0 is
// int16, 1 bf16, 2 int8 (the kernels' mode argument); DWP is the 32-bit
// words of a row and digit plane, padded to whole k-steps of eight words
// (int8 and int16: four digits a word, D <= 4*DWP; bf16: a pair a word,
// D <= 2*DWP).  Operands as Int8Tail's and Bf16Tail's (int16: cw int32
// [2, M, K, Ds/4], the a- then the b-digit plane, nrm int64 [M, K], the
// exact sum of A^2), but for the queries: qt is the transposed operand
// [B, planes*Dg] (a query's D values contiguous, zero past D), so that a
// query block is staged with plain 16-byte copies.
//
// A warp owns a 32-row subtile as two m-fragments and meets the block's
// queries eight at a time (one n-fragment): int8 and int16 run
// mma.sync.m16n8k32 (s8 x s8 -> s32), bf16 m16n8k16 (f32 accumulate).  In
// both shapes a thread needs, of each eight words of a row, word t and
// word t+4 for rows g and g+8 (mma.cuh), so
//   * A is a gather, not a tile load: the thread reads exactly its
//     fragment words from the compact codebook in shared memory by its
//     four rows' codes (rows g, g+8, g+16, g+24 of the subtile) and keeps
//     them in registers for all the queries of the block; no x^ tile is
//     staged;
//   * B is the staged queries [b][word] with a row stride of DWP + 4 words,
//     which puts the eight queries of a fragment on disjoint banks;
//   * the subtile minimum is taken in registers: four values in the thread
//     (two m-fragments x rows g, g+8), then __shfl_xor_sync over lanes 4, 8
//     and 16, for two queries at once; the lane whose g equals the
//     n-fragment's number keeps the result, so 64 minima leave the warp as
//     one 256-byte run.
// The integer sums are exact in any order, so int8 and int16 give the bits
// of Int8Tail and of the int16 arithmetic above (the epilogue is theirs,
// with _rn intrinsics); bf16 differs from Bf16Tail by the order of the f32
// sums inside the tensor core.  pre is computed as above, one row a lane, and
// handed to the rows' owners by shuffle.
template <int MODE, int DWP>
struct MmaTail {
  static_assert(DWP % 8 == 0, "whole k-steps of eight words");
  static constexpr int MS = MMAX;
  static constexpr int QBLK = MODE == 2 ? 128 : 64;   // queries per pass
  static constexpr int PLANES = MODE == 0 ? 2 : 1;
  static constexpr int VPW = MODE == 1 ? 2 : 4;        // values per word
  static constexpr int QSTR = DWP + 4;                 // words per query row
  static constexpr int KSTEPS = DWP / 8;
  static constexpr int NRM_BYTES = MODE == 0 ? 8 : 4;
  // shared memory: nrm [M*K] | cw [PLANES*M*K*WS] words |
  // q [PLANES][QBLK][QSTR] words | u [QBLK]
  struct Layout {
    size_t nrm, cw, q, u, total;
  };
  __host__ __device__ static Layout layout(int M, int K, int Ds) {
    Layout s;
    s.nrm = 0;
    s.cw = s.nrm + (size_t)NRM_BYTES * M * K;
    s.q = align16(s.cw + sizeof(int) * PLANES * M * K * (Ds / VPW));
    s.u = s.q + sizeof(int) * PLANES * QBLK * QSTR;
    s.total = align16(s.u + sizeof(float) * QBLK);
    return s;
  }

  // Once a block: the compact codebook and the norms.
  __device__ static void load_codebook(unsigned char* smem, const void* cw_,
                                       const void* nrm_, int M, int K,
                                       int Ds) {
    const Layout L = layout(M, K, Ds);
    const int n_cw = PLANES * M * K * (Ds / VPW);
    const int n_nrm = M * K * (NRM_BYTES / 4);
    const int* cw = static_cast<const int*>(cw_);
    const int* nrm = static_cast<const int*>(nrm_);
    int* cw_s = reinterpret_cast<int*>(smem + L.cw);
    int* nrm_s = reinterpret_cast<int*>(smem + L.nrm);
    for (int i = threadIdx.x; i < n_cw; i += THREADS) cw_s[i] = cw[i];
    for (int i = threadIdx.x; i < n_nrm; i += THREADS) nrm_s[i] = nrm[i];
  }

  // Once a query block: queries qb0 .. qb0 + QBLK of qt [B, PLANES*Dg]
  // (Dg values a plane, 16-byte aligned rows) and their u.
  __device__ static void load_queries(unsigned char* smem, const void* qt_,
                                      const float* u, int B, int Dg, int qb0,
                                      int M, int K, int Ds) {
    const Layout L = layout(M, K, Ds);
    constexpr int C = DWP / 4;             // 16-byte pieces per query row
    const int plane_bytes = Dg * (4 / VPW);
    const unsigned char* qt = static_cast<const unsigned char*>(qt_);
    int* q_s = reinterpret_cast<int*>(smem + L.q);
    float* u_s = reinterpret_cast<float*>(smem + L.u);
    for (int i = threadIdx.x; i < PLANES * QBLK * C; i += THREADS) {
      const int c = i % C, b = (i / C) % QBLK, p = i / (C * QBLK);
      int4 v = make_int4(0, 0, 0, 0);
      if (qb0 + b < B)
        v = *reinterpret_cast<const int4*>(
            qt + ((size_t)(qb0 + b) * PLANES + p) * plane_bytes + 16 * c);
      *reinterpret_cast<int4*>(q_s + (p * QBLK + b) * QSTR + 4 * c) = v;
    }
    if (MODE != 1)
      for (int b = threadIdx.x; b < QBLK; b += THREADS)
        u_s[b] = (qb0 + b < B) ? u[qb0 + b] : 1.0f;
  }

  // codes_s [TILE, MMAX] u8; writes mins[(t*32 + s)*B + qb0 + b]
  __device__ static void scan(const unsigned char* smem,
                              const uint8_t* codes_s, float* mins, int t,
                              int B, int qb0, int n_valid, int M, int K,
                              int Ds) {
    const Layout L = layout(M, K, Ds);
    const int WS = Ds / VPW;
    const int MW = M * WS;                 // words of real dims
    const int MKW = M * K * WS;            // words of one digit plane
    const float inv_ws = 1.0f / (float)WS;
    const unsigned* cw_s = reinterpret_cast<const unsigned*>(smem + L.cw);
    const unsigned* q_s = reinterpret_cast<const unsigned*>(smem + L.q);
    const float* u_s = reinterpret_cast<const float*>(smem + L.u);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int nb = min(QBLK, B - qb0);
    for (int s = warp; s < TILE / SUB; s += WARPS) {
      // pre and validity of row s*32 + lane, then of this thread's rows
      float pre_l;
      {
        const uint8_t* crow = codes_s + (s * SUB + lane) * MMAX;
        if (MODE == 0) {
          const long long* nrm_s =
              reinterpret_cast<const long long*>(smem + L.nrm);
          long long pre_i = 0;
          for (int m = 0; m < M; ++m) pre_i += nrm_s[m * K + crow[m]];
          pre_l = __ll2float_rn(pre_i);    // exact integer, rounded once
        } else if (MODE == 2) {
          const int* nrm_s = reinterpret_cast<const int*>(smem + L.nrm);
          int pre_i = 0;
          for (int m = 0; m < M; ++m) pre_i += nrm_s[m * K + crow[m]];
          pre_l = __int2float_rn(pre_i);   // exact: < 2^24
        } else {
          const float* nrm_s = reinterpret_cast<const float*>(smem + L.nrm);
          pre_l = 0.0f;
          for (int m = 0; m < M; ++m)
            pre_l = __fadd_rn(pre_l, nrm_s[m * K + crow[m]]);
        }
      }
      float pre[4];
      bool ok[4];
      unsigned clo[4], chi[4];             // the rows' eight code bytes
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = s * SUB + 8 * r + g;
        pre[r] = __shfl_sync(FULL, pre_l, 8 * r + g);
        ok[r] = (long long)t * TILE + row < n_valid;
        const uint2 c = *reinterpret_cast<const uint2*>(codes_s + row * MMAX);
        clo[r] = c.x;
        chi[r] = c.y;
      }
      // A fragments: a[p][i][ks][.] for digit plane p, m-fragment i (rows
      // 16i + g and 16i + 8 + g), k-step ks; word index 4j + t4 of the row
      // is register (j & 1) * 2 + (row half) of k-step j / 2
      unsigned a[PLANES][2][KSTEPS][4];
#pragma unroll
      for (int j = 0; j < 2 * KSTEPS; ++j) {
        const int w = 4 * j + t4;
        // floor(w / WS): w + 0.5 keeps the quotient clear of an integer
        const int m = __float2int_rz(((float)w + 0.5f) * inv_ws);
        const int off = m * K * WS + (w - m * WS);
        const bool in = w < MW;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const unsigned k = __byte_perm(clo[r], chi[r], m) & 0xffu;
          const int at = off + (int)k * WS;
#pragma unroll
          for (int p = 0; p < PLANES; ++p)
            a[p][r >> 1][j >> 1][(j & 1) * 2 + (r & 1)] =
                in ? cw_s[p * MKW + at] : 0u;
        }
      }
      float* out = mins + ((size_t)t * (TILE / SUB) + s) * B + qb0;

      for (int f0 = 0; f0 * 8 < nb; f0 += 8) {      // 64 queries a round
        float o0 = CUDART_INF_F, o1 = CUDART_INF_F;
#pragma unroll
        for (int fi = 0; fi < 8; ++fi) {
          const int f = f0 + fi;                     // n-fragment
          if (f * 8 < nb) {
            const unsigned* qrow = q_s + (f * 8 + g) * QSTR + t4;
            float d[2][4];                           // [m-fragment][c0..c3]
            if (MODE == 1) {
              float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
              for (int ks = 0; ks < KSTEPS; ++ks) {
                const unsigned b0 = qrow[8 * ks], b1 = qrow[8 * ks + 4];
                mma::bf16_16816(acc[0], a[0][0][ks], b0, b1);
                mma::bf16_16816(acc[1], a[0][1][ks], b0, b1);
              }
#pragma unroll
              for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e) d[i][e] = acc[i][e];
            } else if (MODE == 2) {
              int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
              for (int ks = 0; ks < KSTEPS; ++ks) {
                const unsigned b0 = qrow[8 * ks], b1 = qrow[8 * ks + 4];
                mma::s8_16832(acc[0], a[0][0][ks], b0, b1);
                mma::s8_16832(acc[1], a[0][1][ks], b0, b1);
              }
#pragma unroll
              for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  d[i][e] = __fmul_rn(__int2float_rn(acc[i][e]),
                                      u_s[f * 8 + 2 * t4 + (e & 1)]);
            } else {
              int aa[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
              int p2[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
              int bb[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
              const unsigned* qrow_b = qrow + QBLK * QSTR;
#pragma unroll
              for (int ks = 0; ks < KSTEPS; ++ks) {
                const unsigned qa0 = qrow[8 * ks], qa1 = qrow[8 * ks + 4];
                const unsigned qb0_ = qrow_b[8 * ks];
                const unsigned qb1_ = qrow_b[8 * ks + 4];
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                  mma::s8_16832(aa[i], a[0][i][ks], qa0, qa1);
                  mma::s8_16832(p2[i], a[0][i][ks], qb0_, qb1_);
                  mma::s8_16832(p2[i], a[PLANES - 1][i][ks], qa0, qa1);
                  mma::s8_16832(bb[i], a[PLANES - 1][i][ks], qb0_, qb1_);
                }
              }
#pragma unroll
              for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const float cross = __fadd_rn(
                      __fadd_rn(__fmul_rn(16384.0f, __int2float_rn(aa[i][e])),
                                __fmul_rn(128.0f, __int2float_rn(p2[i][e]))),
                      __int2float_rn(bb[i][e]));
                  d[i][e] = __fmul_rn(cross, u_s[f * 8 + 2 * t4 + (e & 1)]);
                }
            }
            // d holds cross; c0, c1 are row g (+16i), c2, c3 row g + 8
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float v = CUDART_INF_F;
#pragma unroll
              for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const float x = __fsub_rn(
                      pre[2 * i + h], __fmul_rn(2.0f, d[i][2 * h + e]));
                  v = fminf(v, ok[2 * i + h] ? x : CUDART_INF_F);
                }
              v = fminf(v, __shfl_xor_sync(FULL, v, 4));
              v = fminf(v, __shfl_xor_sync(FULL, v, 8));
              v = fminf(v, __shfl_xor_sync(FULL, v, 16));
              if (g == fi) {
                if (e == 0) o0 = v; else o1 = v;
              }
            }
          }
        }
        const int col = f0 * 8 + g * 8 + 2 * t4;
        if (col < nb) out[col] = o0;
        if (col + 1 < nb) out[col + 1] = o1;
      }
    }
  }
};

template <int DWP> using Int16Mma = MmaTail<0, DWP>;
template <int DWP> using Bf16Mma = MmaTail<1, DWP>;
template <int DWP> using Int8Mma = MmaTail<2, DWP>;

}  // namespace scan_tail
