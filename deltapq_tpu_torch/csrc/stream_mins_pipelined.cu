// Pipelined stream-tile decode + scan (int8 or bf16) + subtile minima.
//
// Replaces the TPU kernel deltapq_tpu/ops/fused_pallas.py:
// _stream_mins_pipelined_kernel, selected inside fused_stream_mins.  It is
// the same function as _stream_mins_kernel (stream_mins.cu here): the
// decoded codes [nT*TILE, M] and the 32-row subtile minima [nT*32, B] of
// pre - 2 cross, for one subspace group (M <= 8, D <= 128) at int8 and
// bf16.  Python wrapper: fused_stream_mins(..., pipelined=True) in
// deltapq_tpu_torch/ops/fused_kernels.py; the plain version is the stream
// kernel's.
//
// What the TPU kernel does: its grid is sequential, so step i decodes
// tile i while it scans tile i-1 out of a double-buffered scratch, with
// the value window of tile i+1 already in flight; a dummy tile and a
// garbage first block pad the two ends.  None of that plumbing is carried
// over.
//
// What bounds it on an H100: the dot products of the scan tail, 2 N B D
// operations at the tensor cores' rate, as in stream_mins.cu; beside them a
// tile's decode (prefix scans and barriers) and the latency of its mask
// and value reads.
//
// Design: stream_mins.cu's narrow kernel -- MmaTail (mma.sync) of
// scan_tail.cuh, a persistent grid (as many blocks as the card holds at
// once), the compact codebook and norms loaded once a block, each tile
// decoded once by the one block that echoes its codes and then meets every
// query block of the batch with it, the queries restaged from the
// transposed operand for each -- with what is this kernel's own on top: a
// block walks a contiguous run of tiles, so that it knows tile t+1 while
// it works on tile t, and the mask plane and value window of tile t+1 (the
// whole 1024-value groups its stream segment touches, known from meta of
// tiles t+1 and t+2) travel by cp.async into a staging buffer while tile t
// is scanned.  The decode then reads shared memory only.  It runs after
// the last query block of a tile, with one code tile in shared memory:
// the staging buffer (11 KB) leaves two blocks an SM at D = 128 (bf16 about
// 109 KB a block), and the other block's scan hides a decode.  A second
// code tile that lets the decode run in the middle of the scan costs a
// resident block at bf16 and measured slower, at int8 too
// (kernels/ablate_pipelined.py, PERF.md).  Per row the arithmetic is
// stream_mins.cu's, so mins and codes equal its bit for bit.

#include <cuda_pipeline.h>

#include "tile_decode.cuh"

namespace {

using namespace scan_tail;
using namespace tile_decode;

// Groups of 1024 values a tile's segment can touch at M <= 8: it starts
// up to 1016 values into a group and holds at most 8 * 1024 values.
constexpr int STAGE_GROUPS = 10;
constexpr int STAGE_BYTES = TILE + STAGE_GROUPS * 1024;   // mask | window

// First group and group count of tile t's value window.
__device__ __forceinline__ void window_of(const int* meta, int nT, int t,
                                          int n_groups, int& w0, int& ng) {
  w0 = meta[t];
  const int end = t + 1 < nT
      ? meta[t + 1] + (meta[nT + t + 1] + 1023) / 1024 : n_groups;
  ng = min(min(end, n_groups) - w0, STAGE_GROUPS);
}

// All threads: start the copy of tile t's mask plane and value window.
__device__ __forceinline__ void prefetch_tile(uint8_t* stage,
                                              const uint8_t* row_data,
                                              const uint8_t* vals,
                                              const int* meta, int nT, int t,
                                              int n_groups) {
  int w0, ng;
  window_of(meta, nT, t, n_groups, w0, ng);
  const uint8_t* mask_g = row_data + (size_t)t * TILE;
  const uint8_t* win_g = vals + (size_t)w0 * 1024;
  const int n16 = (TILE + ng * 1024) / 16;
  for (int i = threadIdx.x; i < n16; i += THREADS) {
    const uint8_t* src = i < TILE / 16 ? mask_g + 16 * i
                                       : win_g + 16 * (i - TILE / 16);
    __pipeline_memcpy_async(stage + 16 * i, src, 16);
  }
  __pipeline_commit();
}

// Block b walks tiles [b * run, min(nT, (b + 1) * run)).
template <class Tail>
__global__ void __launch_bounds__(THREADS, 2)
stream_mins_pipelined_kernel(
    const void* __restrict__ qt, const void* __restrict__ cw,
    const void* __restrict__ nrm,
    const uint8_t* __restrict__ row_data,  // [nT, 1, TILE]
    const uint8_t* __restrict__ vals,      // [n_groups, 8, 128]
    const int* __restrict__ meta,          // [2, nT]
    const float* __restrict__ u,           // [B]
    float* __restrict__ mins,              // [nT*32, B]
    uint8_t* __restrict__ codes_out,       // [nT*TILE, M]
    int B, int Dg, int nT, int n_groups, int run, int n_valid, int M, int K,
    int Ds) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* p = smem + Tail::layout(M, K, Ds).total;
  const Scratch sc = scratch<MMAX>(p);
  uint8_t* stage = p + align16(scratch_bytes<MMAX>());
  const int t0 = blockIdx.x * run;
  const int t1 = min(nT, t0 + run);

  prefetch_tile(stage, row_data, vals, meta, nT, t0, n_groups);
  Tail::load_codebook(smem, cw, nrm, M, K, Ds);
  for (int t = t0; t < t1; ++t) {
    __pipeline_wait_prior(0);
    __syncthreads();   // tile t is staged; the last scan has read the codes
    // tile t's window starts at group meta[t], so its first value sits
    // meta[nT + t] bytes into the staged window
    stream_decode<MMAX>(stage, stage + TILE, (long long)meta[nT + t], sc, M,
                        codes_out + (size_t)t * TILE * M);
    // the decode ended with a barrier: the staging buffer is free again
    if (t + 1 < t1)
      prefetch_tile(stage, row_data, vals, meta, nT, t + 1, n_groups);
    for (int qb0 = 0; qb0 < B; qb0 += Tail::QBLK) {
      if (qb0) __syncthreads();   // the last scan has read the queries
      Tail::load_queries(smem, qt, u, B, Dg, qb0, M, K, Ds);
      __syncthreads();
      Tail::scan(smem, sc.codes, mins, t, B, qb0, n_valid, M, K, Ds);
    }
  }
}

template <class Tail>
int launch(const void* qt, const void* cw, const void* nrm, const void* rd,
           const void* vals, const void* meta, const void* u, void* mins,
           void* codes_out, int B, int Dg, int nT, int n_groups, int n_valid,
           int M, int K, int Ds, void* stream) {
  const size_t smem = Tail::layout(M, K, Ds).total
                      + align16(scratch_bytes<MMAX>()) + STAGE_BYTES;
  auto kernel = stream_mins_pipelined_kernel<Tail>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int grid = 0;
  if (e == cudaSuccess)
    e = mma::resident_grid(kernel, THREADS, smem, nT, &grid);
  if (e != cudaSuccess) return (int)e;
  const int run = (nT + grid - 1) / grid;   // tiles a block walks
  grid = (nT + run - 1) / run;               // every block has a tile
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      qt, cw, nrm, static_cast<const uint8_t*>(rd),
      static_cast<const uint8_t*>(vals), static_cast<const int*>(meta),
      static_cast<const float*>(u), static_cast<float*>(mins),
      static_cast<uint8_t*>(codes_out), B, Dg, nT, n_groups, run, n_valid,
      M, K, Ds);
  return (int)cudaGetLastError();
}

}  // namespace

// mode 1: bf16 (Ds % 2 == 0); mode 2: int8 (Ds % 4 == 0); M <= 8 and
// M*Ds <= 128 (STAGE_GROUPS holds the window of a tile only there); qt
// [B, Dg] the transposed queries and cw, nrm the compact codebook, as
// stream_mins_launch reads them at the narrow shapes; n_groups =
// vals.shape[0]; row_data and vals 16-byte aligned (checked by the Python
// wrapper).  Returns cudaGetLastError() after the launch (or the error of
// a request the card refuses).
extern "C" int stream_mins_pipelined_launch(
    const void* qt, const void* cw, const void* nrm, const void* row_data,
    const void* vals, const void* meta, const void* u, void* mins,
    void* codes_out, int B, int Dg, int nT, int n_groups, int n_valid, int M,
    int K, int Ds, int mode, void* stream) {
  if (nT == 0 || B == 0) return (int)cudaSuccess;
  const int D = M * Ds;
  if (M < 1 || M > MMAX || D > 128 || qt == nullptr)
    return (int)cudaErrorInvalidValue;
#define PIPE_LAUNCH(T)                                                      \
  return launch<T>(qt, cw, nrm, row_data, vals, meta, u, mins, codes_out, B, \
                   Dg, nT, n_groups, n_valid, M, K, Ds, stream)
  if (mode == 1) {
    if (D <= 16) PIPE_LAUNCH(Bf16Mma<8>);
    if (D <= 32) PIPE_LAUNCH(Bf16Mma<16>);
    if (D <= 64) PIPE_LAUNCH(Bf16Mma<32>);
    if (D <= 128) PIPE_LAUNCH(Bf16Mma<64>);
  } else if (mode == 2) {
    if (D <= 32) PIPE_LAUNCH(Int8Mma<8>);
    if (D <= 64) PIPE_LAUNCH(Int8Mma<16>);
    if (D <= 128) PIPE_LAUNCH(Int8Mma<32>);
  }
#undef PIPE_LAUNCH
  return (int)cudaErrorInvalidValue;
}
