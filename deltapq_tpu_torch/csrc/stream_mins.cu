// Stream-tile decode + scan (int16, int8 or bf16) + 32-row subtile minima.
//
// Replaces the TPU kernel deltapq_tpu/ops/fused_pallas.py:
// _stream_mins_kernel (with _stream_decode and the int16, int8 and bf16
// branches of _scan_tail), reached from fused_stream_mins.  Python
// wrapper and plain PyTorch version: deltapq_tpu_torch/ops/fused_kernels.py.
//
// What it computes, per 1024-row stream tile t and query b:
//   decode   mask planes (P = ceil(M/8); bit j of plane p is subspace
//            8p + j) -> per-row diff count nd, block exclusive scan
//            -> row offset; each set subspace m reads its value from the
//            packed stream at p = meta[0,t]*1024 + meta[1,t] + off + rank
//            (flat layout (p/1024)*1024 + (p%8)*128 + (p/8)%128, see
//            ops/stream_tiles.py); forward fill of every subspace down
//            the tile (tile_decode.cuh).
//   scan     a shared tail (scan_tail.cuh, wide_mma.cuh): int16 digits,
//            int8 values or bf16 x^ against the queries, d = pre - 2
//            cross, +inf at rows >= n_valid.
//   output   min over each 32-row subtile -> mins[t*32 + s, b]; the
//            decoded codes -> codes_out[t*1024 + r, m].
//
// What bounds it on an H100: the dot products, 2 N B D operations (x4 at
// int16: four int8 digit products) at the tensor cores' rate: 0.07-0.28
// ms at N=1M, B=512, D=128; 0.50-1.99 ms at the GIST shape (D=960).  Next
// to them stands a block's fixed work: the codebook into shared memory
// (narrow shapes) and the tile's decode (prefix scans and barriers).  The
// stream itself is 2-5 MB and the mins output 64 MB: memory is not the
// bound.
//
// Design: the TPU used one-hot matmuls in place of gathers (stream
// value window, codes -> x^ decode); here each is a plain gather from
// global or shared memory.  The grid is persistent at every shape -- as
// many blocks as the card holds at once (the occupancy API says how many),
// block b walking tiles b, b + grid, ... -- so a tile is decoded once, by
// the block that then meets every query block of the batch with it and
// that alone echoes its codes.  The products run on the tensor cores:
//   * Narrow shapes (M <= 8, M*Ds <= 128: the main path): the MmaTail
//     structs of scan_tail.cuh (mma.sync m16n8k32 s8 for int8 and int16,
//     m16n8k16 bf16; the A operand gathered from the compact codebook in
//     shared memory by the row's codes, subtile minima in registers), the
//     codebook loaded once a block, the queries (9-18 KB) restaged from the
//     transposed operand with 16-byte copies for each query block.
//   * Wide shapes (up to M=16, D=1024; the GIST shape M=16, Ds=60): the
//     gathered wgmma tail of wide_mma.cuh over the tile's (128-row block,
//     query block) pairs, its gathers reading the decoded codes from
//     shared memory, placed after the tail's 4-stage ring -- the slot-tile
//     kernel's layout (delta_mins.cu), with the stream decode in place of
//     the slot decode.
// The codes and slot-tile kernels run the same two tails, so at int8 and
// int16 the three kernels give the same bits on the same rows; the
// pipelined stream kernel keeps the CUDA-core narrow tails (Int8Tail,
// Bf16Tail).

#include "tile_decode.cuh"
#include "wide_mma.cuh"

namespace {

using namespace scan_tail;
using namespace tile_decode;

// The narrow shapes: one block walks tiles blockIdx.x, blockIdx.x + grid,
// ... with the codebook in shared memory for its whole life; it decodes a
// tile once (and is the only block to echo its codes), then meets every
// query block of the batch, restaging the queries (qt, the transposed
// operand) each time.
template <class Tail>
__global__ void __launch_bounds__(THREADS, 2)
stream_mins_mma_kernel(const void* __restrict__ qt,
                       const void* __restrict__ cw,
                       const void* __restrict__ nrm,
                       const uint8_t* __restrict__ row_data,  // [nT, 1, TILE]
                       const uint8_t* __restrict__ vals,
                       const int* __restrict__ meta,          // [2, nT]
                       const float* __restrict__ u,
                       float* __restrict__ mins,              // [nT*32, B]
                       uint8_t* __restrict__ codes_out,       // [nT*TILE, M]
                       int B, int Dg, int nT, int n_valid, int M, int K,
                       int Ds) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Scratch sc = scratch<MMAX>(smem + Tail::layout(M, K, Ds).total);
  Tail::load_codebook(smem, cw, nrm, M, K, Ds);
  for (int t = blockIdx.x; t < nT; t += gridDim.x) {
    __syncthreads();   // the last scan has read the code tile and queries
    stream_decode<MMAX>(row_data + (size_t)t * TILE, vals,
                        (long long)meta[t] * 1024 + meta[nT + t], sc, M,
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
               const void* rd, const void* vals, const void* meta,
               const void* u, void* mins, void* codes_out, int B, int Dg,
               int nT, int n_valid, int M, int K, int Ds, void* stream) {
  const size_t smem = Tail::layout(M, K, Ds).total + scratch_bytes<MMAX>();
  auto kernel = stream_mins_mma_kernel<Tail>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int grid = 0;
  if (e == cudaSuccess)
    e = mma::resident_grid(kernel, THREADS, smem, nT, &grid);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      qt, cw, nrm, static_cast<const uint8_t*>(rd),
      static_cast<const uint8_t*>(vals), static_cast<const int*>(meta),
      static_cast<const float*>(u), static_cast<float*>(mins),
      static_cast<uint8_t*>(codes_out), B, Dg, nT, n_valid, M, K, Ds);
  return (int)cudaGetLastError();
}

// The wide shapes: the decoded tile [TILE, MSW] sits after the ring.
template <int MODE>
__global__ void __launch_bounds__(wide_mma::THREADS, 1)
stream_mins_wide_kernel(const uint8_t* __restrict__ qt,  // [B, planes*M*SP]
                        const uint8_t* __restrict__ cw,  // [planes, M, K, SP]
                        const void* __restrict__ nrm,
                        const uint8_t* __restrict__ row_data,  // [nT, P, TILE]
                        const uint8_t* __restrict__ vals,
                        const int* __restrict__ meta,          // [2, nT]
                        const float* __restrict__ u, float* __restrict__ mins,
                        uint8_t* __restrict__ codes_out, int B, int nT,
                        int n_valid, int M, int K, int SP, int nqb) {
  using W = wide_mma::WideMma<MODE>;
  extern __shared__ unsigned char smem_raw[];
  const typename W::Ring rg = W::ring(smem_raw);
  const Scratch sc = scratch<MSW>(rg.base + W::SMEM_BYTES - wide_mma::ALIGN);
  const int P = (M + 7) / 8;
  const int n_items = (TILE / wide_mma::BM) * nqb;
  for (int t = blockIdx.x; t < nT; t += gridDim.x) {
    __syncthreads();   // the last scan has read the code tile
    stream_decode<MSW>(row_data + (size_t)t * P * TILE, vals,
                       (long long)meta[t] * 1024 + meta[nT + t], sc, M,
                       codes_out + (size_t)t * TILE * M);
    W::scan(rg, sc.codes, MSW, (long long)t * TILE, 0, 1, n_items, nqb, qt,
            cw, nrm, u, mins, B, n_valid, M, K, SP);
  }
}

template <int MODE>
int launch_wide(const void* qt, const void* cw_pad, const void* nrm,
                const void* rd, const void* vals, const void* meta,
                const void* u, void* mins, void* codes_out, int B, int nT,
                int n_valid, int M, int K, int SP, void* stream) {
  using W = wide_mma::WideMma<MODE>;
  const size_t smem = W::SMEM_BYTES + scratch_bytes<MSW>();
  auto kernel = stream_mins_wide_kernel<MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int grid = 0;
  if (e == cudaSuccess)
    e = mma::resident_grid(kernel, wide_mma::THREADS, smem, nT, &grid);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, wide_mma::THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(qt), static_cast<const uint8_t*>(cw_pad),
      nrm, static_cast<const uint8_t*>(rd), static_cast<const uint8_t*>(vals),
      static_cast<const int*>(meta), static_cast<const float*>(u),
      static_cast<float*>(mins), static_cast<uint8_t*>(codes_out), B, nT,
      n_valid, M, K, SP, (B + W::BN - 1) / W::BN);
  return (int)cudaGetLastError();
}

}  // namespace

// mode 0: int16 (Ds % 4 == 0); mode 1: bf16 (Ds % 2 == 0); mode 2: int8
// (Ds % 4 == 0); M <= 16; u [B] f32 (ones at bf16).  The query and
// codebook operands by shape as in codes_mins_launch: narrow shapes (M <= 8
// with M*Ds <= 128) read qt [B, planes*Dg], the transposed q (Dg values a
// plane), and cw, the compact codebook; wide ones qt [B, planes*M*SP] and
// cw_pad [planes, M, K, SP], the padded operands (checked by the Python
// wrapper).  Returns cudaGetLastError() after the launch (or the error of a
// request the card refuses).
extern "C" int stream_mins_launch(const void* qt, const void* cw,
                                  const void* cw_pad, const void* nrm,
                                  const void* row_data, const void* vals,
                                  const void* meta, const void* u, void* mins,
                                  void* codes_out, int B, int Dg, int nT,
                                  int n_valid, int M, int K, int Ds, int mode,
                                  void* stream) {
  if (nT == 0 || B == 0) return (int)cudaSuccess;
  if (M < 1 || M > MSW || qt == nullptr) return (int)cudaErrorInvalidValue;
  const int D = M * Ds;
#define STREAM_LAUNCH_MMA(T)                                                \
  return launch_mma<T>(qt, cw, nrm, row_data, vals, meta, u, mins,          \
                       codes_out, B, Dg, nT, n_valid, M, K, Ds, stream)
#define STREAM_WIDE(MODE)                                                  \
  return launch_wide<MODE>(qt, cw_pad, nrm, row_data, vals, meta, u, mins, \
                           codes_out, B, nT, n_valid, M, K, SP, stream)
  if (M > MMAX || D > 128) {
    if (cw_pad == nullptr) return (int)cudaErrorInvalidValue;
    const int SP = (int)align16((size_t)Ds * (mode == 1 ? 2 : 1));
    if (mode == 0) STREAM_WIDE(0);
    if (mode == 1) STREAM_WIDE(1);
    if (mode == 2) STREAM_WIDE(2);
  } else if (mode == 0) {
    if (D <= 32) STREAM_LAUNCH_MMA(Int16Mma<8>);
    if (D <= 64) STREAM_LAUNCH_MMA(Int16Mma<16>);
    if (D <= 128) STREAM_LAUNCH_MMA(Int16Mma<32>);
  } else if (mode == 1) {
    if (D <= 16) STREAM_LAUNCH_MMA(Bf16Mma<8>);
    if (D <= 32) STREAM_LAUNCH_MMA(Bf16Mma<16>);
    if (D <= 64) STREAM_LAUNCH_MMA(Bf16Mma<32>);
    if (D <= 128) STREAM_LAUNCH_MMA(Bf16Mma<64>);
  } else if (mode == 2) {
    if (D <= 32) STREAM_LAUNCH_MMA(Int8Mma<8>);
    if (D <= 64) STREAM_LAUNCH_MMA(Int8Mma<16>);
    if (D <= 128) STREAM_LAUNCH_MMA(Int8Mma<32>);
  }
#undef STREAM_LAUNCH_MMA
#undef STREAM_WIDE
  return (int)cudaErrorInvalidValue;
}
