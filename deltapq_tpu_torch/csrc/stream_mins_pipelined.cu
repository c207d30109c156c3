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
// What bounds it on an H100: the dot products of the scan tail, as in
// stream_mins.cu.  Beside them stream_mins.cu pays, for every tile, a
// fresh load of the compact codebook, the norms and the queries into
// shared memory (up to 80 KB a block) and the latency of the tile's mask
// and value reads before any product can start.
//
// Design: a loop inside the block takes the place of the sequential grid.
// One block walks a run of consecutive tiles for its 64 queries:
//   * the codebook, norms and queries are loaded into shared memory once
//     for the whole run;
//   * two code tiles live in shared memory.  While the warps scan tile i
//     out of buffer i % 2, the mask plane and the value window of tile
//     i+1 (the whole 1024-value groups its stream segment touches, known
//     from meta of tiles i+1 and i+2) are in flight: cp.async into a
//     staging buffer, committed as soon as the previous decode has read
//     the buffer and waited just before the next decode;
//   * the decode of tile i+1 (tile_decode.cuh, reading the staged bytes)
//     fills buffer (i+1) % 2 in the middle of the scan of tile i: every
//     warp scans some of its four subtiles, takes part in the decode,
//     starts the copy of tile i+2, and scans the rest.  All eight
//     warps decode, rather than a producer warp group beside consumer
//     warps: the decode is a few block-wide prefix scans over 1024 rows
//     -- short, latency-bound and full of barriers -- and a dedicated
//     group would idle through the scan, which is where the time goes.
//     Placed mid-scan, a warp that waits at one of the decode's barriers
//     leaves the SM's schedulers to the warps (of this block and of its
//     neighbour on the SM) that are still in their dot products, and the
//     copy has had part of a scan to land.  That is why there are two
//     code tiles: tile i is still being read while tile i+1 is written.
// The run length is ceil(nT / runs).  runs is WAVES = 4 times the blocks
// the card holds at once for one query block (SM count x the occupancy the
// kernel reaches, divided by the query blocks and rounded down, so that a
// wave never spills a few blocks into a wave of its own): four short
// waves measured 2-4% faster than one long one, whose blocks run in lock
// step.  Tiles past nT are skipped, not padded.  Per row the arithmetic is
// stream_mins.cu's (the same tails of scan_tail.cuh), so mins and codes
// equal its bit for bit.
//
// What it costs: the second code tile and the staging buffer (19 KB) take
// a resident block away -- at D = 128 bf16 one block an SM against
// stream_mins.cu's two, int8 two against three -- and the tails are
// chains of dependent fma / __dp4a that need those warps to hide their
// latency.  On this card that outweighs the saved loads (PERF.md).

#include <cuda_pipeline.h>

#include "tile_decode.cuh"

namespace {

using namespace scan_tail;
using namespace tile_decode;

// Groups of 1024 values a tile's segment can touch at M <= 8: it starts
// up to 1016 values into a group and holds at most 8 * 1024 values.
constexpr int STAGE_GROUPS = 10;
constexpr int STAGE_BYTES = TILE + STAGE_GROUPS * 1024;   // mask | window
constexpr int WAVES = 4;                 // waves of blocks over the card
constexpr int SPLIT = TILE / SUB / 2;    // subtiles scanned before a decode

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

template <class Tail>
__global__ void __launch_bounds__(THREADS, 2)
stream_mins_pipelined_kernel(
    const void* __restrict__ q, const void* __restrict__ cw,
    const void* __restrict__ nrm,
    const uint8_t* __restrict__ row_data,  // [nT, 1, TILE]
    const uint8_t* __restrict__ vals,      // [n_groups, 8, 128]
    const int* __restrict__ meta,          // [2, nT]
    const float* __restrict__ u,           // [B] or null
    float* __restrict__ mins,              // [nT*32, B]
    uint8_t* __restrict__ codes_out,       // [nT*TILE, M]
    int B, int Dg, int nT, int n_groups, int run, int n_valid, int M, int K,
    int Ds) {
  constexpr int MS = Tail::MS;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* p = smem + Tail::layout(M, K, Ds).total;
  const Scratch sc = scratch<MS>(p);       // buffer 0 + the scan scratch
  p += align16(scratch_bytes<MS>());
  uint8_t* buf1 = p;                       // buffer 1
  uint8_t* stage = p + TILE * MS;
  const int qb0 = blockIdx.y * Tail::QBLK;
  const int t0 = blockIdx.x * run;
  const int t1 = min(nT, t0 + run);
  if (t0 >= t1) return;
  uint8_t* out0 = blockIdx.y == 0 ? codes_out : nullptr;

  prefetch_tile(stage, row_data, vals, meta, nT, t0, n_groups);
  Tail::load(smem, q, cw, nrm, u, B, Dg, qb0, M, K, Ds);

  // Tile t's window starts at group meta[t], so its first value sits
  // meta[nT + t] bytes into the staged window.
  auto decode = [&](int t, uint8_t* buf) {
    Scratch d = sc;
    d.codes = buf;
    __pipeline_wait_prior(0);
    __syncthreads();                       // the staged bytes are visible
    stream_decode<MS>(stage, stage + TILE, (long long)meta[nT + t], d, M,
                      out0 ? out0 + (size_t)t * TILE * M : nullptr);
    // the decode ended with a barrier: the staging buffer is free again
    if (t + 1 < t1)
      prefetch_tile(stage, row_data, vals, meta, nT, t + 1, n_groups);
  };

  decode(t0, sc.codes);
  for (int t = t0; t < t1; ++t) {
    uint8_t* cur = (t - t0) & 1 ? buf1 : sc.codes;
    uint8_t* nxt = (t - t0) & 1 ? sc.codes : buf1;
    Tail::template scan<0, SPLIT>(smem, cur, mins, t, B, qb0, n_valid, M, K,
                                  Ds, cw, nrm);
    if (t + 1 < t1) decode(t + 1, nxt);
    Tail::template scan<SPLIT, TILE / SUB>(smem, cur, mins, t, B, qb0,
                                           n_valid, M, K, Ds, cw, nrm);
  }
}

template <class Tail>
int launch(const void* q, const void* cw, const void* nrm, const void* rd,
           const void* vals, const void* meta, const void* u, void* mins,
           void* codes_out, int B, int Dg, int nT, int n_groups, int n_valid,
           int M, int K, int Ds, void* stream) {
  constexpr int MS = Tail::MS;
  const size_t smem = Tail::layout(M, K, Ds).total
                      + align16(scratch_bytes<MS>()) + TILE * MS
                      + STAGE_BYTES;
  auto kernel = stream_mins_pipelined_kernel<Tail>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, occ = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
      != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &occ, kernel, THREADS, smem)) != cudaSuccess)
    return (int)e;
  if (occ < 1) return (int)cudaErrorLaunchOutOfResources;
  // runs per query block: WAVES waves of resident blocks over the card
  const int nqb = (B + Tail::QBLK - 1) / Tail::QBLK;
  int runs = WAVES * (sms * occ / nqb);
  runs = runs < 1 ? 1 : (runs > nT ? nT : runs);
  const int run = (nT + runs - 1) / runs;
  dim3 grid((nT + run - 1) / run, nqb);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      q, cw, nrm, static_cast<const uint8_t*>(rd),
      static_cast<const uint8_t*>(vals), static_cast<const int*>(meta),
      static_cast<const float*>(u), static_cast<float*>(mins),
      static_cast<uint8_t*>(codes_out), B, Dg, nT, n_groups, run, n_valid,
      M, K, Ds);
  return (int)cudaGetLastError();
}

}  // namespace

// mode 1: bf16 (Ds % 2 == 0); mode 2: int8 (Ds % 4 == 0); M <= 8 and
// M*Ds <= 128; n_groups = vals.shape[0]; row_data and vals 16-byte aligned
// (checked by the Python wrapper).  Returns cudaGetLastError() after the
// launch.
extern "C" int stream_mins_pipelined_launch(
    const void* q, const void* cw, const void* nrm, const void* row_data,
    const void* vals, const void* meta, const void* u, void* mins,
    void* codes_out, int B, int Dg, int nT, int n_groups, int n_valid, int M,
    int K, int Ds, int mode, void* stream) {
  if (nT == 0 || B == 0) return (int)cudaSuccess;
  const int D = M * Ds;
  if (M < 1 || M > MMAX || D > 128) return (int)cudaErrorInvalidValue;
#define PIPE_LAUNCH(T)                                                      \
  return launch<T>(q, cw, nrm, row_data, vals, meta, u, mins, codes_out, B,  \
                   Dg, nT, n_groups, n_valid, M, K, Ds, stream)
  if (mode == 1) {
    if (D <= 8) PIPE_LAUNCH(Bf16Tail<4>);
    if (D <= 16) PIPE_LAUNCH(Bf16Tail<8>);
    if (D <= 32) PIPE_LAUNCH(Bf16Tail<16>);
    if (D <= 64) PIPE_LAUNCH(Bf16Tail<32>);
    if (D <= 128) PIPE_LAUNCH(Bf16Tail<64>);
  } else if (mode == 2) {
    if (D <= 16) PIPE_LAUNCH(Int8Tail<4>);
    if (D <= 32) PIPE_LAUNCH(Int8Tail<8>);
    if (D <= 64) PIPE_LAUNCH(Int8Tail<16>);
    if (D <= 128) PIPE_LAUNCH(Int8Tail<32>);
  }
#undef PIPE_LAUNCH
  return (int)cudaErrorInvalidValue;
}
