// Slot-tile decode + scan (int16, int8 or bf16) + 32-row subtile minima.
//
// Replaces the TPU kernel deltapq_tpu/ops/fused_pallas.py:
// _delta_mins_kernel, reached from fused_delta_mins via _mins_call.
// Python wrapper and plain PyTorch version:
// deltapq_tpu_torch/ops/fused_kernels.py (fused_delta_mins,
// fused_delta_mins_ref); tile format: deltapq_tpu_torch/ops/delta_tiles.py.
//
// What it computes, per 1024-row slot tile t (M <= 16; P = ceil(M/8) mask
// planes, then S value slots) and query b:
//   decode   row r's mask (bit j of plane p is subspace 8p + j; an
//            overflow row carries all-ones planes) sets nd subspaces; a row with
//            nd > S is an overflow row: its full code is column k of the
//            tile's overflow bank ovf[t, :, k], k = the number of overflow
//            rows above it (0 past Cap, as the TPU's one-hot scatter
//            gives).  Any other row's j-th set subspace takes value slot
//            j, row_data[t, P + j, r].  Every subspace a row does not set
//            is forward-filled down the tile (row 0 is always an overflow
//            row, so every subspace has a source).
//   scan     x^ gathered from the codebook by the decoded codes, d = pre -
//            2 cross in the int16, int8 or bf16 mode, +inf at rows >=
//            n_valid.
//   output   min over each 32-row subtile -> mins[t*32 + s, b]; the
//            decoded codes -> codes_out[t*1024 + r, m].
//
// What bounds it on an H100: the dot products, 2 N B D operations (x4 at
// int16) on the tensor cores; the decode reads P+S bytes a row plus the
// bank (M*Cap bytes a tile), about 4 MB at N=1M, M=8.
//
// Design: the TPU decoded rows-on-lanes, with a Hillis-Steele roll chain
// for the overflow rank and a one-hot matmul to scatter the overflow
// codes.  Here the overflow rank is a block exclusive count of the
// nd > S rows (warp shuffles plus a prefix over the 8 warp totals), each
// value is a plain load into the shared-memory code tile, and the forward
// fill is the stream kernel's block max-scan (tile_decode.cuh).  The grid
// is persistent (as many blocks as the card holds at once, block b walking
// tiles b, b + grid, ...): a block decodes a tile once, echoes its codes,
// and meets every query block of the batch with it on the tensor cores:
//   * narrow shapes (M <= 8, M*Ds <= 128): the stream kernel's MmaTail
//     (scan_tail.cuh), the compact codebook loaded once a block, the
//     queries restaged from the transposed operand for each query block;
//   * wide shapes (up to M=16, D=1024): the gathered wgmma tail of
//     wide_mma.cuh over the tile's (128-row block, query block) pairs, its
//     gathers reading the decoded codes from shared memory.

#include "tile_decode.cuh"
#include "wide_mma.cuh"

namespace {

using namespace scan_tail;
using namespace tile_decode;

// Decode slot tile rd [P+S, TILE] with overflow bank [M, Cap] into
// sc.codes [TILE, MS] and codes_out [TILE, M].  Ends with a
// __syncthreads(); the caller has one before it.
template <int MS>
__device__ __forceinline__ void slot_decode(const uint8_t* rd,
                                            const uint8_t* bank,
                                            const Scratch& sc, int M, int S,
                                            int Cap, uint8_t* codes_out) {
  const int P = (M + 7) / 8;
  const unsigned full = (1u << M) - 1u;

  // ---- overflow rows and their rank: a block exclusive count ------------
  const int r0 = threadIdx.x * RPT;
  unsigned set[RPT];
  bool over[RPT];
  int tcount = 0;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    set[i] = row_mask<MS>(rd, r0 + i, M);
    over[i] = __popc(set[i]) > S;
    tcount += over[i];
  }
  int rank = block_exclusive_sum(tcount, sc.wsum);

  // ---- values: the overflow bank or the row's slots ---------------------
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + i;
    if (over[i]) {
      for (int m = 0; m < M; ++m)
        sc.codes[r * MS + m] = rank < Cap ? bank[m * Cap + rank] : 0;
      ++rank;
      set[i] = full;
    } else {
      int j = 0;
      for (int m = 0; m < M; ++m) {
        if (set[i] >> m & 1u) {
          sc.codes[r * MS + m] = rd[(P + j) * TILE + r];
          ++j;
        }
      }
    }
  }

  forward_fill<MS>(set, sc.codes, sc.wlast, M, codes_out);
}

template <class Tail>
__global__ void __launch_bounds__(THREADS, 2)
delta_mins_mma_kernel(const void* __restrict__ qt,
                      const void* __restrict__ cw,
                      const void* __restrict__ nrm,
                      const uint8_t* __restrict__ row_data,  // [nT, P+S, TILE]
                      const uint8_t* __restrict__ ovf,       // [nT, M, Cap]
                      const float* __restrict__ u,           // [B]
                      float* __restrict__ mins,              // [nT*32, B]
                      uint8_t* __restrict__ codes_out,       // [nT*TILE, M]
                      int B, int Dg, int nT, int n_valid, int M, int K,
                      int Ds, int S, int Cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Scratch sc = scratch<MMAX>(smem + Tail::layout(M, K, Ds).total);
  const int P = (M + 7) / 8;
  Tail::load_codebook(smem, cw, nrm, M, K, Ds);
  for (int t = blockIdx.x; t < nT; t += gridDim.x) {
    __syncthreads();   // the last scan has read the code tile and queries
    slot_decode<MMAX>(row_data + (size_t)t * (P + S) * TILE,
                      ovf + (size_t)t * M * Cap, sc, M, S, Cap,
                      codes_out + (size_t)t * TILE * M);
    for (int qb0 = 0; qb0 < B; qb0 += Tail::QBLK) {
      if (qb0) __syncthreads();   // the last scan has read the queries
      Tail::load_queries(smem, qt, u, B, Dg, qb0, M, K, Ds);
      __syncthreads();
      Tail::scan(smem, sc.codes, mins, t, B, qb0, n_valid, M, K, Ds);
    }
  }
}

template <class Tail>
int launch_mma(const void* qt, const void* cw, const void* nrm,
               const void* rd, const void* ovf, const void* u, void* mins,
               void* codes_out, int B, int Dg, int nT, int n_valid, int M,
               int K, int Ds, int S, int Cap, void* stream) {
  const size_t smem = Tail::layout(M, K, Ds).total + scratch_bytes<MMAX>();
  auto kernel = delta_mins_mma_kernel<Tail>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int grid = 0;
  if (e == cudaSuccess)
    e = mma::resident_grid(kernel, THREADS, smem, nT, &grid);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      qt, cw, nrm, static_cast<const uint8_t*>(rd),
      static_cast<const uint8_t*>(ovf), static_cast<const float*>(u),
      static_cast<float*>(mins), static_cast<uint8_t*>(codes_out), B, Dg,
      nT, n_valid, M, K, Ds, S, Cap);
  return (int)cudaGetLastError();
}

// The wide shapes: the decoded tile [TILE, MSW] sits after the ring.
template <int MODE>
__global__ void __launch_bounds__(wide_mma::THREADS, 1)
delta_mins_wide_kernel(const uint8_t* __restrict__ qt,  // [B, planes*M*SP]
                       const uint8_t* __restrict__ cw,  // [planes, M, K, SP]
                       const void* __restrict__ nrm,
                       const uint8_t* __restrict__ row_data,
                       const uint8_t* __restrict__ ovf,
                       const float* __restrict__ u, float* __restrict__ mins,
                       uint8_t* __restrict__ codes_out, int B, int nT,
                       int n_valid, int M, int K, int SP, int S, int Cap,
                       int nqb) {
  using W = wide_mma::WideMma<MODE>;
  extern __shared__ unsigned char smem_raw[];
  const typename W::Ring rg = W::ring(smem_raw);
  const Scratch sc = scratch<MSW>(rg.base + W::SMEM_BYTES - wide_mma::ALIGN);
  const int P = (M + 7) / 8;
  const int n_items = (TILE / wide_mma::BM) * nqb;
  for (int t = blockIdx.x; t < nT; t += gridDim.x) {
    __syncthreads();   // the last scan has read the code tile
    slot_decode<MSW>(row_data + (size_t)t * (P + S) * TILE,
                     ovf + (size_t)t * M * Cap, sc, M, S, Cap,
                     codes_out + (size_t)t * TILE * M);
    W::scan(rg, sc.codes, MSW, (long long)t * TILE, 0, 1, n_items, nqb, qt,
            cw, nrm, u, mins, B, n_valid, M, K, SP);
  }
}

template <int MODE>
int launch_wide(const void* qt, const void* cw_pad, const void* nrm,
                const void* rd, const void* ovf, const void* u, void* mins,
                void* codes_out, int B, int nT, int n_valid, int M, int K,
                int SP, int S, int Cap, void* stream) {
  using W = wide_mma::WideMma<MODE>;
  const size_t smem = W::SMEM_BYTES + scratch_bytes<MSW>();
  auto kernel = delta_mins_wide_kernel<MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int grid = 0;
  if (e == cudaSuccess)
    e = mma::resident_grid(kernel, wide_mma::THREADS, smem, nT, &grid);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, wide_mma::THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(qt), static_cast<const uint8_t*>(cw_pad),
      nrm, static_cast<const uint8_t*>(rd), static_cast<const uint8_t*>(ovf),
      static_cast<const float*>(u), static_cast<float*>(mins),
      static_cast<uint8_t*>(codes_out), B, nT, n_valid, M, K, SP, S, Cap,
      (B + W::BN - 1) / W::BN);
  return (int)cudaGetLastError();
}

}  // namespace

// mode 0: int16 (Ds % 4 == 0); mode 1: bf16 (Ds % 2 == 0); mode 2: int8
// (Ds % 4 == 0); 2 <= M <= 16, 1 <= S < M; u [B] f32 (ones at bf16).  The
// query and codebook operands by shape as in codes_mins_launch: narrow
// shapes read qt [B, planes*Dg] and cw, wide ones qt [B, planes*M*SP] and
// cw_pad (checked by the Python wrapper).  Returns cudaGetLastError()
// after the launch.
extern "C" int delta_mins_launch(const void* qt, const void* cw,
                                 const void* cw_pad, const void* nrm,
                                 const void* row_data, const void* ovf,
                                 const void* u, void* mins, void* codes_out,
                                 int B, int Dg, int nT, int n_valid, int M,
                                 int K, int Ds, int S, int Cap, int mode,
                                 void* stream) {
  if (nT == 0 || B == 0) return (int)cudaSuccess;
  if (M < 2 || M > MSW || S < 1 || S >= M || Cap < 1 || qt == nullptr)
    return (int)cudaErrorInvalidValue;
  const int D = M * Ds;
#define DELTA_LAUNCH(T)                                                    \
  return launch_mma<T>(qt, cw, nrm, row_data, ovf, u, mins, codes_out, B,  \
                       Dg, nT, n_valid, M, K, Ds, S, Cap, stream)
#define DELTA_WIDE(MODE)                                                  \
  return launch_wide<MODE>(qt, cw_pad, nrm, row_data, ovf, u, mins,       \
                           codes_out, B, nT, n_valid, M, K, SP, S, Cap,   \
                           stream)
  if (M > MMAX || D > 128) {
    if (cw_pad == nullptr) return (int)cudaErrorInvalidValue;
    const int SP = (int)align16((size_t)Ds * (mode == 1 ? 2 : 1));
    if (mode == 0) DELTA_WIDE(0);
    if (mode == 1) DELTA_WIDE(1);
    if (mode == 2) DELTA_WIDE(2);
  } else if (mode == 0) {
    if (D <= 32) DELTA_LAUNCH(Int16Mma<8>);
    if (D <= 64) DELTA_LAUNCH(Int16Mma<16>);
    if (D <= 128) DELTA_LAUNCH(Int16Mma<32>);
  } else if (mode == 1) {
    if (D <= 16) DELTA_LAUNCH(Bf16Mma<8>);
    if (D <= 32) DELTA_LAUNCH(Bf16Mma<16>);
    if (D <= 64) DELTA_LAUNCH(Bf16Mma<32>);
    if (D <= 128) DELTA_LAUNCH(Bf16Mma<64>);
  } else if (mode == 2) {
    if (D <= 32) DELTA_LAUNCH(Int8Mma<8>);
    if (D <= 64) DELTA_LAUNCH(Int8Mma<16>);
    if (D <= 128) DELTA_LAUNCH(Int8Mma<32>);
  }
#undef DELTA_LAUNCH
#undef DELTA_WIDE
  return (int)cudaErrorInvalidValue;
}
