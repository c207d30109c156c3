// The wide scan tail on the tensor cores (wgmma), shared by the stream
// kernel (stream_mins.cu), the codes kernel (codes_mins.cu) and the
// slot-tile kernel (delta_mins.cu) at every shape the narrow tails do not
// take (M <= 16, D up to 1024; the GIST shape M=16, Ds=60): code rows ->
// x^ gathered from the codebook -> pre - 2 cross -> 32-row subtile minima.
//
// Replaces, for those shapes, the tail of the TPU kernels
// deltapq_tpu/ops/fused_pallas.py: _stream_mins_kernel, _codes_mins_kernel
// and _delta_mins_kernel (_scan_tail, its int16, int8 and bf16 branches),
// which decode codes -> x^ with a one-hot matmul in two groups of 8
// subspaces.
//
// What bounds it on an H100: the products, 2 N B D operations (x4 at
// int16), 0.50 ms (int8), 0.99 (bf16), 1.99 (int16) at N=1M, B=512, D=960.
// The codebook (245-490 KB) stays in the 50 MB L2; the gathers that build
// x^ move 1-2 KB a row for every block of queries, mostly from L1.
//
// Design: the decoded scan's wgmma pipeline (decoded_mins.cu) with a
// gathered A operand.
//   * Operands: cw_pad [planes, M, K, SP] bytes, each subspace's codeword
//     zero-padded to SP, a whole number of 16-byte pieces (Ds=60: 64 bytes
//     at int8 and int16, 128 at bf16), and qt_pad [B, planes, M*SP] bytes,
//     the queries in the same padded layout (fused_kernels.py builds both).
//     Row r of x^ in a plane is the concatenation over m of
//     cw_pad[m][code[r][m]], so 16-byte piece pc of it is a cp.async from
//     cw_pad + ((m*K + code[r][m])*SP + 16 (pc - m SP/16)), m = pc / (SP/16):
//     one 16-byte copy per piece, as the decoded scan copies a dense row.
//   * A work item is 128 rows x BN queries; the block walks slices of 128
//     bytes of the padded row (two planes at int16) through a ring of four
//     48 KB stages, two slices in flight while one multiplies and the one
//     before drains from the tensor cores.  Shared rows are the 128-byte
//     swizzle rows wgmma reads (piece c of row r at c ^ (r & 7)); both
//     operands are K-major, which 8-bit wgmma requires.
//   * Both warpgroups own all 128 rows, as two 64-row blocks placed so that
//     a 32-row subtile lies in one warp (rows 0-15 of subtile w at rows
//     16w.. of the first block, 16-31 at rows 16w.. of the second), and
//     each takes half the queries: wgmma m64n128k16 bf16 -> f32 and
//     m64n128k32 s8 -> s32 (128 queries a warpgroup, 64 accumulators a
//     block); int16 takes its four digit products (aa = a.a, p2 = a.b +
//     b.a, bb = b.b) into three accumulators with m64n32k32 (32 queries a
//     warpgroup, 96 registers), so no integer is folded before the f32
//     epilogue.  Every k-step is unconditional: the zero fill past the row
//     and past the batch adds nothing, and a branch around wgmma would
//     serialise it.
//   * A thread copies the same piece column of four rows every slice; the
//     rows' 16 code bytes are loaded once per item into registers, so a
//     piece's source is one byte select and one multiply-add away.
//   * pre comes from the per-codeword norm tables, summed over m ascending
//     (int64 at int16, int32 at int8, f32 __fadd_rn at bf16) by the first
//     warpgroup while the first slice's products are in flight.  The
//     epilogue is the narrow tails' arithmetic (scan_tail.cuh) with _rn
//     intrinsics, so int8 and int16 give the plain version's bits (integer
//     sums are exact in any order) and bf16 differs only by the order of
//     the f32 sums.
//   * Subtile minima in registers: four values in the thread and three
//     shuffles for two queries; 64 minima leave a warp as one 256-byte run.
//   * The ring runs on across items, so an item's epilogue overlaps the
//     next item's copies.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace wide_mma {

constexpr int THREADS = 256;           // two warpgroups
constexpr int SUB = 32;                // rows per subtile minimum
constexpr int BM = 128;                // rows per work item
constexpr int SLICE = 128;             // bytes of a row plane per slice
constexpr int STAGES = 4;
constexpr int ALIGN = 1024;            // of a swizzled tile
constexpr unsigned FULL = 0xffffffffu;

// Shared row of item row r: subtile w = r / 32 puts its rows 0-15 into the
// first 64-row block and its rows 16-31 into the second, both at 16w..
__device__ __forceinline__ int shared_row(int r) {
  return ((r >> 4) & 1) * 64 + ((r >> 5) & 3) * 16 + (r & 15);
}

// Byte offset of 16-byte piece c of shared row sr (128-byte swizzle).
__device__ __forceinline__ int piece(int sr, int c) {
  return sr * SLICE + ((c ^ (sr & 7)) << 4);
}

// A row's M <= 16 code bytes, four to a word (bytes past M zero).  Rows of
// a [rows, 16] array (the slot-tile kernel's decoded tile, whose bytes past
// M are zero, or codes at M = 16) come as one 16-byte load.
__device__ __forceinline__ uint4 load_code_row(const uint8_t* p, int M,
                                               int cstride) {
  if (cstride == 16 && ((uintptr_t)p & 15) == 0)
    return *reinterpret_cast<const uint4*>(p);
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int m = 0; m < 16; ++m)
    if (m < M) w[m >> 2] |= (unsigned)p[m] << (8 * (m & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ unsigned code_byte(const uint4& c, int m) {
  const unsigned w = (m & 8) ? ((m & 4) ? c.w : c.z) : ((m & 4) ? c.y : c.x);
  return (w >> (8 * (m & 3))) & 0xffu;
}

// MODE: 0 int16, 1 bf16, 2 int8 (the kernels' mode argument).
template <int MODE>
struct WideMma {
  static constexpr int PLANES = MODE == 0 ? 2 : 1;
  static constexpr int NW = MODE == 0 ? 32 : 128;   // queries a warpgroup
  static constexpr int BN = 2 * NW;                 // queries a work item
  static constexpr int NB = NW / 8;                 // n8 blocks
  static constexpr int NACC = NW / 2;               // registers of m64 x NW
  static constexpr int A_PLANE = BM * SLICE;
  static constexpr int B_PLANE = BN * SLICE;
  static constexpr int A_BYTES = PLANES * A_PLANE;
  static constexpr int STAGE_BYTES = A_BYTES + PLANES * B_PLANE;
  // dynamic shared memory of the ring: alignment slack, stages, pre
  static constexpr int SMEM_BYTES =
      ALIGN + STAGES * STAGE_BYTES + BM * (int)sizeof(float);
  static_assert(STAGE_BYTES == 48 * 1024, "four stages fit beside a tile");

  // The ring's shared memory: smem_raw rounded up to ALIGN.
  struct Ring {
    unsigned char* base;
    unsigned base_addr;
    float* pre_s;
  };
  __device__ static Ring ring(unsigned char* smem_raw) {
    const unsigned raw0 = mma::smem_addr(smem_raw);
    const unsigned pad = (ALIGN - (raw0 & (ALIGN - 1))) & (ALIGN - 1);
    Ring r;
    r.base = smem_raw + pad;
    r.base_addr = raw0 + pad;
    r.pre_s = reinterpret_cast<float*>(r.base + STAGES * STAGE_BYTES);
    return r;
  }

  // pre of one row from the norm tables, ascending m.
  __device__ static float row_pre(const uint8_t* crow, const void* nrm_,
                                  int M, int K) {
    if (MODE == 0) {
      const long long* nrm = static_cast<const long long*>(nrm_);
      long long s = 0;
      for (int m = 0; m < M; ++m) s += __ldg(nrm + m * K + crow[m]);
      return __ll2float_rn(s);             // exact integer, rounded once
    } else if (MODE == 2) {
      const int* nrm = static_cast<const int*>(nrm_);
      int s = 0;
      for (int m = 0; m < M; ++m) s += __ldg(nrm + m * K + crow[m]);
      return __int2float_rn(s);            // exact: < 2^24
    } else {
      const float* nrm = static_cast<const float*>(nrm_);
      float s = 0.0f;
      for (int m = 0; m < M; ++m)
        s = __fadd_rn(s, __ldg(nrm + m * K + crow[m]));
      return s;
    }
  }

  // Scans work items item0, item0 + step, ... < n_items.  Item i is rows
  // row_base + (i / nqb) * 128 .. + 128 against queries (i % nqb) * BN ..;
  // the codes of the item's row r are codes + ((i / nqb)*128 + r) * cstride
  // (global or shared memory).  Writes mins[(row/32)*B + b].  Leaves no
  // copy in flight.
  __device__ __forceinline__ static void scan(
      const Ring& rg, const uint8_t* codes, int cstride, long long row_base,
      int item0, int step, int n_items, int nqb,
      const uint8_t* __restrict__ qt, const uint8_t* __restrict__ cw,
      const void* __restrict__ nrm, const float* __restrict__ u,
      float* __restrict__ mins, int B, int n_valid, int M, int K, int SP) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wg = warp >> 2, w = warp & 3;   // warpgroup, warp in it
    const int g = lane >> 2, t = lane & 3;
    const int SPP = SP / 16;                  // pieces a subspace
    const int RP = M * SPP;                   // pieces a row plane
    const int RB = M * SP;                    // bytes a row plane
    const int KS = (RP + 7) / 8;              // slices an item
    const size_t cw_plane = (size_t)M * K * SP;

    // Copy side, STAGES - 2 slices ahead of the products.  Thread tid
    // copies piece c8 = tid % 8 of rows r8 + 32j (j < 4) and of queries
    // r8 + 32j (j < BN/32), r8 = tid / 8, in every plane.
    const int c8 = tid & 7, r8 = tid >> 3;
    const unsigned a_dst = piece(shared_row(r8), c8);   // + j * 16 rows
    const unsigned b_dst = A_BYTES + piece(r8, c8);     // + j * 32 rows
    int ld_item = item0, ld_ks = 0, ld_stage = 0;
    uint4 crow[4];                 // code bytes of the four rows
    const uint8_t* ld_q = qt;      // qt row of query r8 of the item
    int ld_cols = 0;               // queries left from r8 on
    auto start_item = [&]() {
      if (ld_item >= n_items) return;
      const int rb = ld_item / nqb, col0 = (ld_item - rb * nqb) * BN + r8;
      const uint8_t* c0 = codes + (size_t)(rb * BM + r8) * cstride;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        crow[j] = load_code_row(c0 + (size_t)32 * j * cstride, M, cstride);
      ld_cols = B - col0;
      ld_q = qt + (size_t)col0 * PLANES * RB;
    };
    start_item();

    // Start the copy of the next slice; always commits a group, an empty
    // one past the last item, so that the group count stays in step.
    auto copy_next = [&]() {
      if (ld_item < n_items) {
        const int pc = 8 * ld_ks + c8;        // piece of the row plane
        const bool in = pc < RP;
        const int m = in ? pc / SPP : 0;
        const uint8_t* src0 = cw + (size_t)m * K * SP + 16 * (pc - m * SPP);
        const unsigned st = rg.base_addr + (unsigned)ld_stage * STAGE_BYTES;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint8_t* src = src0 + (size_t)code_byte(crow[j], m) * SP;
#pragma unroll
          for (int p = 0; p < PLANES; ++p)
            mma::cp_async16_ca(st + p * A_PLANE + a_dst + j * 16 * SLICE,
                               in ? src + p * cw_plane : cw, in ? 16 : 0);
        }
#pragma unroll
        for (int j = 0; j < BN / 32; ++j) {
          const bool qin = in && 32 * j < ld_cols;
#pragma unroll
          for (int p = 0; p < PLANES; ++p)
            mma::cp_async16(
                st + p * B_PLANE + b_dst + 32 * j * SLICE,
                qin ? ld_q + (size_t)(32 * j * PLANES + p) * RB + 16 * pc
                    : qt,
                qin ? 16 : 0);
        }
      }
      mma::cp_async_commit();
      if (++ld_stage == STAGES) ld_stage = 0;
      if (++ld_ks == KS) {
        ld_ks = 0;
        ld_item += step;
        start_item();
      }
    };

    for (int s = 0; s < STAGES - 2; ++s) copy_next();

    // [64-row block][n8 block * 4 + c]; int16 adds p2 and bb
    using Acc = typename std::conditional<MODE == 1, float, int>::type;
    Acc acc[2][NACC];
    int p2[MODE == 0 ? 2 : 1][MODE == 0 ? NACC : 1];
    int bb[MODE == 0 ? 2 : 1][MODE == 0 ? NACC : 1];
    float pre_mine = 0.0f;
    int stage = 0;
    for (int item = item0; item < n_items; item += step) {
      const int rb = item / nqb;
      for (int ks = 0; ks < KS; ++ks) {
        mma::cp_async_wait<STAGES - 3>();
        mma::fence_async_proxy();
        // this slice has landed; every warp has waited for the wgmma group
        // of the slice before the last, whose stage the next copy refills
        __syncthreads();
        copy_next();
        const unsigned st = rg.base_addr + (unsigned)stage * STAGE_BYTES;
        const unsigned sb = st + A_BYTES + wg * NW * SLICE;
        mma::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < SLICE / 32; ++kk) {
          const int first = ks | kk;          // 0: overwrite
#pragma unroll
          for (int mb = 0; mb < 2; ++mb) {
            const uint64_t da =
                mma::tile_desc(st + mb * 64 * SLICE + 32 * kk);
            const uint64_t db = mma::tile_desc(sb + 32 * kk);
            if constexpr (MODE == 1) {
              mma::wgmma_bf16_n128(acc[mb], da, db, first);
            } else if constexpr (MODE == 2) {
              mma::wgmma_s8_n128(acc[mb], da, db, first);
            } else {
              const uint64_t da_b = mma::tile_desc(
                  st + A_PLANE + mb * 64 * SLICE + 32 * kk);
              const uint64_t db_b = mma::tile_desc(sb + B_PLANE + 32 * kk);
              mma::wgmma_s8_n32(acc[mb], da, db, first);
              mma::wgmma_s8_n32(p2[mb], da, db_b, first);
              mma::wgmma_s8_n32(p2[mb], da_b, db, 1);
              mma::wgmma_s8_n32(bb[mb], da_b, db_b, first);
            }
          }
        }
        mma::wgmma_commit();
        // pre of row tid while the first slice's products are in flight
        if (ks == 0 && tid < BM)
          pre_mine = row_pre(codes + (size_t)(rb * BM + tid) * cstride,
                             nrm, M, K);
        if (++stage == STAGES) stage = 0;
        // this slice's group stays in flight over the next slice's wait
        // and copy
        mma::wgmma_wait_one();
      }

      mma::wgmma_wait_all();
      if (tid < BM) rg.pre_s[tid] = pre_mine;
      __syncthreads();
      const long long row0 = row_base + (long long)rb * BM;
      const int col0 = (item - rb * nqb) * BN + wg * NW;
      const int rs = w * SUB;                 // the warp's subtile
      float pr[2][2];
      bool ok[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rs + i * 16 + h * 8 + g;
          pr[i][h] = rg.pre_s[r];
          ok[i][h] = row0 + r < n_valid;
        }
      float* out = mins + (size_t)((row0 + rs) / SUB) * B;
#pragma unroll
      for (int j0 = 0; j0 < NB; j0 += 8) {     // 64 queries a round
        float o0 = CUDART_INF_F, o1 = CUDART_INF_F;
#pragma unroll
        for (int jj = 0; jj < (NB < 8 ? NB : 8); ++jj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = col0 + (j0 + jj) * 8 + 2 * t + e;
            float uc = 1.0f;
            if (MODE != 1) uc = col < B ? __ldg(u + col) : 1.0f;
            float v = CUDART_INF_F;
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int at = 4 * (j0 + jj) + 2 * h + e;
                float cross;
                if constexpr (MODE == 1) {
                  cross = acc[i][at];
                } else if constexpr (MODE == 2) {
                  cross = __fmul_rn(__int2float_rn(acc[i][at]), uc);
                } else {
                  const float aa = __int2float_rn(acc[i][at]);
                  cross = __fadd_rn(
                      __fadd_rn(__fmul_rn(16384.0f, aa),
                                __fmul_rn(128.0f, __int2float_rn(p2[i][at]))),
                      __int2float_rn(bb[i][at]));
                  cross = __fmul_rn(cross, uc);
                }
                const float d = __fsub_rn(pr[i][h], __fmul_rn(2.0f, cross));
                v = fminf(v, ok[i][h] ? d : CUDART_INF_F);
              }
            v = fminf(v, __shfl_xor_sync(FULL, v, 4));
            v = fminf(v, __shfl_xor_sync(FULL, v, 8));
            v = fminf(v, __shfl_xor_sync(FULL, v, 16));
            if (g == jj) {
              if (e == 0) o0 = v; else o1 = v;
            }
          }
        }
        const int col = col0 + (j0 + g) * 8 + 2 * t;
        if (j0 + g < NB) {
          if (col < B) out[col] = o0;
          if (col + 1 < B) out[col + 1] = o1;
        }
      }
    }
    mma::cp_async_wait<0>();
  }
};

}  // namespace wide_mma
