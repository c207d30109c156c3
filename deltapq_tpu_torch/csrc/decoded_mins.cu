// Decoded-tier scan: bf16 x^ rows . bf16 queries -> 32-row subtile minima.
//
// Replaces the TPU kernel deltapq_tpu/ops/fused_pallas.py:
// _decoded_mins_kernel, reached from fused_decoded_mins.  Python wrapper
// and plain PyTorch version: deltapq_tpu_torch/ops/fused_kernels.py.
//
// What it computes: xt [nT, tile, D] bf16 (rows contiguous, read as
// [N_pad, D]); qt [B, D] bf16, the queries transposed (a query's D values
// contiguous).  Per row n and query b:
//   pre   = sum_d x^[n,d]^2 in f32 (from the bf16 x^, as the TPU kernel);
//   cross = sum_d x^[n,d] q[d,b] in f32 (products of two bf16 values are
//           exact in f32; only the order of summation differs);
//   d     = pre - 2 cross, +inf at rows >= n_valid;
// and writes the minimum over every 32 consecutive rows to
// mins[n/32, b].
//
// What bounds it on an H100: it is GEMM-shaped, 2 N D B operations
// (1.07e12 at N=1M, D=1024, B=512: 1.0 ms at the 989 TFLOP/s of the bf16
// tensor cores) over rows that are read once (2 GB there: 0.6 ms).  So the
// product has to run on the tensor cores at their full rate -- mma.sync
// reaches about a quarter of it here (PERF.md) -- and the rows must not be
// read once per handful of queries.
//
// Design: one kernel for every D % 8 == 0.
//   * A block owns 256 rows x 128 queries and walks D in slices of 64
//     values.  Rows and queries reach shared memory as 16-byte cp.async
//     pieces through a ring of four stages (zero-filled past D, past the
//     last row and past the last query): two slices are in flight while
//     one multiplies and the one before it drains from the tensor cores.  A shared row is the slice's 128 bytes, its
//     eight 16-byte pieces XOR-swizzled by the row number (the 128-byte
//     swizzle wgmma reads), which also keeps the other readers free of
//     bank conflicts.
//   * The product is wgmma m64n128k16 (bf16 in, f32 accumulate), both
//     operands K-major in shared memory, named by descriptors: two
//     warpgroups, each owning 128 rows as two 64-row blocks (128
//     accumulators a thread).  Rows are placed in shared memory so that a
//     32-row subtile lies in ONE warp's accumulators: rows 0-15 of subtile
//     w of a warpgroup go to rows 16w.. of its first block, rows 16-31 to
//     rows 16w.. of its second.
//   * pre is a side product: thread i sums the squares of row i's slice
//     from shared memory on the CUDA cores (1/128 of the product's work)
//     while the wgmma group is in flight, as four interleaved fma chains,
//     each ascending in d, added at the end.
//   * Epilogue in registers: a subtile minimum is four values in the
//     thread (two blocks x rows g, g+8) and three __shfl_xor_sync over the
//     lanes that differ in g, for two queries at a time.  The lane whose g
//     equals the n8 block's number (mod 8) keeps the result, so 64 minima
//     leave the warp as one 256-byte run.
//   * The grid is persistent: as many blocks as the card holds at once
//     (one an SM), block b taking tiles b, b + grid, ...; the cp.async
//     ring runs on across tiles, so a tile's epilogue overlaps the next
//     tile's loads.  Tiles are numbered with the query block fastest, so
//     the blocks that share a row tile run side by side and the rows come
//     from device memory once and from L2 for the other query blocks.
//     Nothing depends on a 65,535 grid limit any more.

#include <math_constants.h>

#include "mma.cuh"

namespace {

constexpr int THREADS = 256;             // two warpgroups
constexpr int SUB = 32;                  // rows per subtile minimum
constexpr int BM = 256;                  // rows per block tile
constexpr int BN = 128;                  // queries per block tile
constexpr int BK = 64;                   // values of D per slice
constexpr int STAGES = 4;
constexpr int ROW_BYTES = BK * 2;        // 128: one swizzle row
constexpr int A_BYTES = BM * ROW_BYTES;
constexpr int STAGE_BYTES = A_BYTES + BN * ROW_BYTES;
constexpr int ALIGN = 1024;              // of a swizzled tile
constexpr int SMEM_BYTES = ALIGN + STAGES * STAGE_BYTES + BM * sizeof(float);
constexpr int NB = BN / 8;               // n8 blocks of an accumulator
constexpr unsigned FULL = 0xffffffffu;
static_assert(THREADS == BM, "thread i sums the squares of row i");
static_assert(ROW_BYTES == 128 && BN == 128, "128-byte swizzle, m64n128k16");

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Shared row of tile row r: subtile w = (r % 128) / 32 of warpgroup r / 128
// puts its rows 0-15 into the group's first 64-row block and its rows 16-31
// into the second, both at rows 16w.. of the block.
__device__ __forceinline__ int shared_row(int r) {
  return (r & 128) + ((r >> 4) & 1) * 64 + ((r >> 5) & 3) * 16 + (r & 15);
}

// Byte offset of 16-byte piece c of shared row sr (128-byte swizzle).
__device__ __forceinline__ int piece(int sr, int c) {
  return sr * ROW_BYTES + ((c ^ (sr & 7)) << 4);
}

__global__ void __launch_bounds__(THREADS, 1)
decoded_mins_kernel(const uint16_t* __restrict__ qt,   // [B, D] bf16
                    const uint16_t* __restrict__ xt,   // [n_rows, D] bf16
                    float* __restrict__ mins,          // [n_rows/32, B]
                    int B, int D, int n_rows, int n_valid, int nqb,
                    int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw0 = mma::smem_addr(smem_raw);
  const unsigned pad = (ALIGN - (raw0 & (ALIGN - 1))) & (ALIGN - 1);
  unsigned char* smem = smem_raw + pad;
  const unsigned smem0 = raw0 + pad;
  float* pre_s = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, w = warp & 3;     // warpgroup, warp in it
  const int g = lane >> 2, t = lane & 3;
  const int KS = (D + BK - 1) / BK;

  // The copy side runs two slices ahead of the product, with its own
  // (tile, slice, stage) counters: no division in the loop.  Thread tid
  // copies piece c = tid % 8 of rows tid / 8 + 32 j (j < 8) of x^ and of
  // queries tid / 8 + 32 j (j < 4); what does not depend on the slice is
  // worked out once a tile.
  const int c8 = tid & 7, r8 = tid >> 3;
  const unsigned a_dst = piece(shared_row(r8), c8);   // + (j & 3) * 16 rows
  const unsigned b_dst = A_BYTES + piece(r8, c8);     //   + (j >> 2) * 128
  int ld_tile = blockIdx.x, ld_ks = 0, ld_stage = 0;
  const uint16_t* ld_a = xt;      // x^[row0 + r8][8 c8 + slice]
  const uint16_t* ld_b = qt;      // qt[col0 + r8][8 c8 + slice]
  int ld_rows = 0, ld_cols = 0;   // rows and queries left from r8 on
  auto start_tile = [&]() {
    if (ld_tile >= n_tiles) return;
    const long long row0 = (long long)(ld_tile / nqb) * BM + r8;
    const int col0 = (ld_tile % nqb) * BN + r8;
    ld_rows = (int)min((long long)BM, (long long)n_rows - row0);
    ld_cols = B - col0;
    ld_a = xt + (size_t)max(row0, 0LL) * D + 8 * c8;
    ld_b = qt + (size_t)col0 * D + 8 * c8;
  };
  start_tile();

  // Start the copy of the next slice; always commits a group, an empty one
  // past the last tile, so that the group count stays in step.
  auto copy_next = [&]() {
    if (ld_tile < n_tiles) {
      const bool in_d = ld_ks * BK + 8 * c8 < D;
      const unsigned st = smem0 + (unsigned)ld_stage * STAGE_BYTES;
#pragma unroll
      for (int j = 0; j < BM / 32; ++j) {
        const bool in = in_d && 32 * j < ld_rows;
        mma::cp_async16(
            st + a_dst + ((j >> 2) * 128 + (j & 3) * 16) * ROW_BYTES,
            in ? ld_a + (size_t)32 * j * D : xt, in ? 16 : 0);
      }
#pragma unroll
      for (int j = 0; j < BN / 32; ++j) {
        const bool in = in_d && 32 * j < ld_cols;
        mma::cp_async16(st + b_dst + 32 * j * ROW_BYTES,
                        in ? ld_b + (size_t)32 * j * D : qt, in ? 16 : 0);
      }
      ld_a += BK;
      ld_b += BK;
    }
    mma::cp_async_commit();
    if (++ld_stage == STAGES) ld_stage = 0;
    if (++ld_ks == KS) {
      ld_ks = 0;
      ld_tile += gridDim.x;
      start_tile();
    }
  };

  for (int s = 0; s < STAGES - 2; ++s) copy_next();

  float acc[2][4 * NB];      // [64-row block][n8 block * 4 + c]
  float pre[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int stage = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
   for (int ks = 0; ks < KS; ++ks) {
    mma::cp_async_wait<STAGES - 3>();
    mma::fence_async_proxy();
    // this slice has landed; every warp has waited for the wgmma group of
    // the slice before the last, whose stage the next copy overwrites
    __syncthreads();
    copy_next();
    const unsigned char* stp = smem + (size_t)stage * STAGE_BYTES;
    const unsigned st = smem0 + (unsigned)stage * STAGE_BYTES;
    const int kmax = min(BK, D - ks * BK);     // real values of this slice

    // every k16 step of the slice, also past D (the zero fill adds
    // nothing): a branch around a wgmma would serialize the group
    mma::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = mma::tile_desc(st + A_BYTES + 32 * kk);
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
        mma::wgmma_bf16_n128(
            acc[mb],
            mma::tile_desc(st + (wg * 128 + mb * 64) * ROW_BYTES + 32 * kk),
            db, ks | kk);
    }
    mma::wgmma_commit();

    // pre of row tid while the tensor cores work: four fma chains, one
    // per pair of 16-byte pieces, each ascending in d (one chain of 64
    // dependent fma a slice would outlast the wgmma group); the zero fill
    // adds nothing
    {
      const int sr = shared_row(tid);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (8 * c < kmax) {
          const uint4 X = *reinterpret_cast<const uint4*>(stp + piece(sr, c));
          float p = pre[c & 3];
          p = fmaf(bf16_lo(X.x), bf16_lo(X.x), p);
          p = fmaf(bf16_hi(X.x), bf16_hi(X.x), p);
          p = fmaf(bf16_lo(X.y), bf16_lo(X.y), p);
          p = fmaf(bf16_hi(X.y), bf16_hi(X.y), p);
          p = fmaf(bf16_lo(X.z), bf16_lo(X.z), p);
          p = fmaf(bf16_hi(X.z), bf16_hi(X.z), p);
          p = fmaf(bf16_lo(X.w), bf16_lo(X.w), p);
          p = fmaf(bf16_hi(X.w), bf16_hi(X.w), p);
          pre[c & 3] = p;
        }
      }
    }
    if (++stage == STAGES) stage = 0;
    // this slice's wgmma group stays in flight over the next slice's wait
    // and copy
    mma::wgmma_wait_one();
   }
    {
      mma::wgmma_wait_all();
      pre_s[tid] = __fadd_rn(__fadd_rn(pre[0], pre[1]),
                             __fadd_rn(pre[2], pre[3]));
      pre[0] = pre[1] = pre[2] = pre[3] = 0.0f;
      __syncthreads();
      const long long row0 = (long long)(tile / nqb) * BM;
      const int col0 = (tile % nqb) * BN;
      const int rb = wg * 128 + w * SUB;       // the warp's subtile, in the tile
      if (row0 + rb < n_rows) {
        float p[2][2];
        bool ok[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = rb + i * 16 + h * 8 + g;
            p[i][h] = pre_s[r];
            ok[i][h] = row0 + r < n_valid;
          }
#pragma unroll
        for (int j0 = 0; j0 < NB; j0 += 8) {   // 64 queries a round
          float o0 = CUDART_INF_F, o1 = CUDART_INF_F;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float v = CUDART_INF_F;
#pragma unroll
              for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const float d = __fsub_rn(
                      p[i][h],
                      __fmul_rn(2.0f, acc[i][4 * (j0 + jj) + 2 * h + e]));
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
          float* out = mins + (size_t)((row0 + rb) / SUB) * B + col;
          if (col < B) out[0] = o0;
          if (col + 1 < B) out[1] = o1;
        }
      }
    }
  }
}

}  // namespace

// D % 8 == 0, n_rows % 32 == 0, qt [B, D] and xt 16-byte aligned (checked by
// the Python wrapper).  Returns cudaGetLastError() after the launch.
extern "C" int decoded_mins_launch(const void* qt, const void* xt, void* mins,
                                   int B, int D, int n_rows, int n_valid,
                                   void* stream) {
  if (n_rows == 0 || B == 0) return (int)cudaSuccess;
  if (D < 8 || D % 8) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      decoded_mins_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, occ = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
      != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &occ, decoded_mins_kernel, THREADS, SMEM_BYTES)) != cudaSuccess)
    return (int)e;
  if (occ < 1) return (int)cudaErrorLaunchOutOfResources;
  const int nqb = (B + BN - 1) / BN;
  const long long tiles = (long long)((n_rows + BM - 1) / BM) * nqb;
  // the kernel's tile counters are ints and run up to STAGES grids ahead
  if (tiles > 0x7fffffffLL - (long long)(STAGES + 1) * sms * occ)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)tiles;
  const int grid = n_tiles < sms * occ ? n_tiles : sms * occ;
  decoded_mins_kernel<<<grid, THREADS, SMEM_BYTES,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(qt), static_cast<const uint16_t*>(xt),
      static_cast<float*>(mins), B, D, n_rows, n_valid, nqb, n_tiles);
  return (int)cudaGetLastError();
}
