// Codes-tier scan: resident u8 codes -> x^ -> subtile minima.
//
// Replaces the TPU kernel deltapq_tpu/ops/fused_pallas.py:
// _codes_mins_kernel (the int16, int8 and bf16 branches of _scan_tail on
// resident codes), reached from fused_codes_mins via _mins_call.  Python
// wrapper and plain PyTorch version: deltapq_tpu_torch/ops/fused_kernels.py.
//
// What it computes, per 1024-row tile t and query b: the row's M code
// bytes from codes [N_pad, M], then d = pre - 2 cross (+inf at rows >=
// n_valid) and the 32-row subtile minima mins[t*32 + s, b].  The TPU
// kernel also echoes its input codes; the wrapper returns the resident
// codes tensor itself as that echo, so nothing is copied.
//
// What bounds it on an H100: the dot products, 2 N B D operations (x4 at
// int16) on the tensor cores; the codes are M bytes a row, 8 MB at N=1M,
// M=8 and 16 MB at M=16.
//
// Design: the TPU decodes codes -> x^ with a one-hot matmul against the
// block-diagonal codebook; here x^ is gathered from the codebook by the
// codes, and the products run on the tensor cores in both forms:
//   * narrow shapes (M <= 8, M*Ds <= 128): the stream kernel's MmaTail
//     (scan_tail.cuh, mma.sync, A gathered from the compact codebook in
//     shared memory) in a persistent grid -- as many blocks as the card
//     holds at once, block b walking tiles b, b + grid, ... -- so the
//     codebook is loaded once a block; a tile's codes are copied into
//     shared memory once and met with every query block of the batch
//     (staged from the transposed queries with 16-byte copies);
//   * wide shapes (up to M=16, D=1024): the gathered wgmma tail of
//     wide_mma.cuh over work items of 128 rows x a query block, numbered
//     with the query block fastest so that the blocks sharing rows run
//     side by side; the grid is persistent and the copy ring runs on
//     across items.

#include "scan_tail.cuh"
#include "wide_mma.cuh"

namespace {

using namespace scan_tail;

template <class Tail>
__global__ void __launch_bounds__(THREADS, 2)
codes_mins_mma_kernel(const void* __restrict__ qt,
                      const void* __restrict__ cw,
                      const void* __restrict__ nrm,
                      const uint8_t* __restrict__ codes,   // [nT*TILE, M]
                      const float* __restrict__ u,         // [B]
                      float* __restrict__ mins,            // [nT*32, B]
                      int B, int Dg, int nT, int n_valid, int M, int K,
                      int Ds) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* codes_s = smem + Tail::layout(M, K, Ds).total;
  Tail::load_codebook(smem, cw, nrm, M, K, Ds);
  for (int t = blockIdx.x; t < nT; t += gridDim.x) {
    __syncthreads();   // the last scan has read the code tile
    const uint8_t* ct = codes + (size_t)t * TILE * M;
    for (int i = threadIdx.x; i < TILE * M; i += THREADS)   // coalesced
      codes_s[(i / M) * MMAX + i % M] = ct[i];
    for (int qb0 = 0; qb0 < B; qb0 += Tail::QBLK) {
      if (qb0) __syncthreads();   // the last scan has read the queries
      Tail::load_queries(smem, qt, u, B, Dg, qb0, M, K, Ds);
      __syncthreads();
      Tail::scan(smem, codes_s, mins, t, B, qb0, n_valid, M, K, Ds);
    }
  }
}

template <class Tail>
int launch_mma(const void* qt, const void* cw, const void* nrm,
               const void* codes, const void* u, void* mins, int B, int Dg,
               int nT, int n_valid, int M, int K, int Ds, void* stream) {
  const size_t smem = Tail::layout(M, K, Ds).total + TILE * MMAX;
  auto kernel = codes_mins_mma_kernel<Tail>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int grid = 0;
  if (e == cudaSuccess)
    e = mma::resident_grid(kernel, THREADS, smem, nT, &grid);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      qt, cw, nrm, static_cast<const uint8_t*>(codes),
      static_cast<const float*>(u), static_cast<float*>(mins), B, Dg, nT,
      n_valid, M, K, Ds);
  return (int)cudaGetLastError();
}

template <int MODE>
__global__ void __launch_bounds__(wide_mma::THREADS, 1)
codes_mins_wide_kernel(const uint8_t* __restrict__ qt,   // [B, planes*M*SP]
                       const uint8_t* __restrict__ cw,   // [planes, M, K, SP]
                       const void* __restrict__ nrm,
                       const uint8_t* __restrict__ codes,  // [n_rows, M]
                       const float* __restrict__ u, float* __restrict__ mins,
                       int B, int n_valid, int M, int K, int SP, int nqb,
                       int n_items) {
  using W = wide_mma::WideMma<MODE>;
  extern __shared__ unsigned char smem_raw[];
  W::scan(W::ring(smem_raw), codes, M, 0, blockIdx.x, gridDim.x, n_items,
          nqb, qt, cw, nrm, u, mins, B, n_valid, M, K, SP);
}

template <int MODE>
int launch_wide(const void* qt, const void* cw_pad, const void* nrm,
                const void* codes, const void* u, void* mins, int B, int nT,
                int n_valid, int M, int K, int SP, void* stream) {
  using W = wide_mma::WideMma<MODE>;
  auto kernel = codes_mins_wide_kernel<MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W::SMEM_BYTES);
  const int nqb = (B + W::BN - 1) / W::BN;
  const long long items = (long long)nT * (TILE / wide_mma::BM) * nqb;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int grid = 0;
  if (e == cudaSuccess)
    e = mma::resident_grid(kernel, wide_mma::THREADS, W::SMEM_BYTES, items,
                           &grid);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, wide_mma::THREADS, W::SMEM_BYTES,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(qt), static_cast<const uint8_t*>(cw_pad),
      nrm, static_cast<const uint8_t*>(codes), static_cast<const float*>(u),
      static_cast<float*>(mins), B, n_valid, M, K, SP, nqb, (int)items);
  return (int)cudaGetLastError();
}

}  // namespace

// mode 0: int16 (Ds % 4 == 0); mode 1: bf16 (Ds % 2 == 0); mode 2: int8
// (Ds % 4 == 0); M <= 16; u [B] f32 (ones at bf16).  M <= 8 with M*Ds <=
// 128 (narrow) reads qt [B, planes*Dg], the transposed q (Dg values a
// plane), and cw / nrm, the compact codebook; any other shape (wide) reads
// qt [B, planes*M*SP] and cw_pad [planes, M, K, SP], the padded operands,
// SP = the bytes of one subspace's codeword rounded up to 16 (checked by
// the Python wrapper), and nrm.  Returns cudaGetLastError() after the
// launch (or the error of a request the card refuses).
extern "C" int codes_mins_launch(const void* qt, const void* cw,
                                 const void* cw_pad, const void* nrm,
                                 const void* codes, const void* u,
                                 void* mins, int B, int Dg, int nT,
                                 int n_valid, int M, int K, int Ds, int mode,
                                 void* stream) {
  if (nT == 0 || B == 0) return (int)cudaSuccess;
  if (M < 1 || M > MSW || qt == nullptr) return (int)cudaErrorInvalidValue;
  const int D = M * Ds;
#define CODES_LAUNCH(T)                                                    \
  return launch_mma<T>(qt, cw, nrm, codes, u, mins, B, Dg, nT, n_valid, M, \
                       K, Ds, stream)
  if (M > MMAX || D > 128) {
    if (cw_pad == nullptr) return (int)cudaErrorInvalidValue;
    const int SP = (int)align16((size_t)Ds * (mode == 1 ? 2 : 1));
    if (mode == 0)
      return launch_wide<0>(qt, cw_pad, nrm, codes, u, mins, B, nT, n_valid,
                            M, K, SP, stream);
    if (mode == 1)
      return launch_wide<1>(qt, cw_pad, nrm, codes, u, mins, B, nT, n_valid,
                            M, K, SP, stream);
    if (mode == 2)
      return launch_wide<2>(qt, cw_pad, nrm, codes, u, mins, B, nT, n_valid,
                            M, K, SP, stream);
  } else if (mode == 0) {
    if (D <= 32) CODES_LAUNCH(Int16Mma<8>);
    if (D <= 64) CODES_LAUNCH(Int16Mma<16>);
    if (D <= 128) CODES_LAUNCH(Int16Mma<32>);
  } else if (mode == 1) {
    if (D <= 16) CODES_LAUNCH(Bf16Mma<8>);
    if (D <= 32) CODES_LAUNCH(Bf16Mma<16>);
    if (D <= 64) CODES_LAUNCH(Bf16Mma<32>);
    if (D <= 128) CODES_LAUNCH(Bf16Mma<64>);
  } else if (mode == 2) {
    if (D <= 32) CODES_LAUNCH(Int8Mma<8>);
    if (D <= 64) CODES_LAUNCH(Int8Mma<16>);
    if (D <= 128) CODES_LAUNCH(Int8Mma<32>);
  }
#undef CODES_LAUNCH
  return (int)cudaErrorInvalidValue;
}
