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
//   scan     the shared tail (scan_tail.cuh): int16 digits, int8 values or
//            bf16 x^ against the queries, d = pre - 2 cross, +inf at rows
//            >= n_valid.
//   output   min over each 32-row subtile -> mins[t*32 + s, b]; the
//            decoded codes -> codes_out[t*1024 + r, m] (query block 0).
//
// What bounds it on an H100: the dot products.  int16: 4 int8 MACs per
// (row, query, dim) = 2.7e11 MACs at N=1M, B=512, D=128 -- about 6.7e10
// __dp4a; int8: a third of that (one __dp4a chain per row and query
// against int16's three); bf16: 6.7e10 f32 fma plus two bf16 unpacks per
// pair.  The stream itself is ~5 MB and the mins output 64 MB: memory is
// not the bound.
//
// Design: the TPU used one-hot matmuls in place of gathers (stream
// value window, codes -> x^ decode); here each is a plain gather from
// global or shared memory.  One block per (tile, query block): the block
// decodes its tile into shared memory (tile_decode.cuh: 1024 x 8 code
// bytes, or 1024 x 16 with two mask planes at M > 8) and hands it to the
// shared tail.  At M <= 8 and D <= 128 the tail keeps the compact
// codebook, the per-codeword norms and 64 queries in shared memory; at
// the GIST shape (M=16, D=960) it takes the wide form described in
// scan_tail.cuh (codebook in global memory, 32 queries staged, the row
// walked chunk by chunk).  wgmma / tensor cores are later work.

#include "tile_decode.cuh"

namespace {

using namespace scan_tail;
using namespace tile_decode;

template <class Tail>
__global__ void __launch_bounds__(THREADS, 2)
stream_mins_kernel(const void* __restrict__ q, const void* __restrict__ cw,
                   const void* __restrict__ nrm,
                   const uint8_t* __restrict__ row_data,  // [nT, P, TILE]
                   const uint8_t* __restrict__ vals,      // packed stream
                   const int* __restrict__ meta,          // [2, nT]
                   const float* __restrict__ u,           // [B] or null
                   float* __restrict__ mins,              // [nT*32, B]
                   uint8_t* __restrict__ codes_out,       // [nT*TILE, M]
                   int B, int Dg, int nT, int n_valid, int M, int K,
                   int Ds) {
  constexpr int MS = Tail::MS;
  extern __shared__ __align__(16) unsigned char smem[];
  const Scratch sc = scratch<MS>(smem + Tail::layout(M, K, Ds).total);
  const int t = blockIdx.x;
  const int qb0 = blockIdx.y * Tail::QBLK;
  const int P = (M + 7) / 8;

  Tail::load(smem, q, cw, nrm, u, B, Dg, qb0, M, K, Ds);

  stream_decode<MS>(
      row_data + (size_t)t * P * TILE, vals,
      (long long)meta[t] * 1024 + meta[nT + t], sc, M,
      blockIdx.y == 0 ? codes_out + (size_t)t * TILE * M : nullptr);

  Tail::scan(smem, sc.codes, mins, t, B, qb0, n_valid, M, K, Ds, cw, nrm);
}

template <class Tail>
int launch(const void* q, const void* cw, const void* nrm, const void* rd,
           const void* vals, const void* meta, const void* u, void* mins,
           void* codes_out, int B, int Dg, int nT, int n_valid, int M, int K,
           int Ds, void* stream) {
  const size_t smem = Tail::layout(M, K, Ds).total
                      + scratch_bytes<Tail::MS>();
  cudaError_t e = cudaFuncSetAttribute(
      stream_mins_kernel<Tail>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(nT, (B + Tail::QBLK - 1) / Tail::QBLK);
  stream_mins_kernel<Tail><<<grid, THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      q, cw, nrm, static_cast<const uint8_t*>(rd),
      static_cast<const uint8_t*>(vals), static_cast<const int*>(meta),
      static_cast<const float*>(u), static_cast<float*>(mins),
      static_cast<uint8_t*>(codes_out), B, Dg, nT, n_valid, M, K, Ds);
  return (int)cudaGetLastError();
}

}  // namespace

// mode 0: int16 (Ds % 4 == 0); mode 1: bf16 (Ds % 2 == 0); mode 2: int8
// (Ds % 4 == 0); M <= 16; Dg is the rows of one plane of q (checked by the
// Python wrapper).  M <= 8 with M*Ds <= 128 takes the narrow tails, any
// other shape the wide ones.  Returns cudaGetLastError() after the launch
// (or the error of a shared-memory request the card refuses).
extern "C" int stream_mins_launch(const void* q, const void* cw,
                                  const void* nrm, const void* row_data,
                                  const void* vals, const void* meta,
                                  const void* u, void* mins, void* codes_out,
                                  int B, int Dg, int nT, int n_valid, int M,
                                  int K, int Ds, int mode, void* stream) {
  if (nT == 0 || B == 0) return (int)cudaSuccess;
  if (M < 1 || M > MSW) return (int)cudaErrorInvalidValue;
  const int D = M * Ds;
#define STREAM_LAUNCH(T)                                                   \
  return launch<T>(q, cw, nrm, row_data, vals, meta, u, mins, codes_out, B, \
                   Dg, nT, n_valid, M, K, Ds, stream)
  if (M > MMAX || D > 128) {
    if (mode == 0) STREAM_LAUNCH(Int16Wide);
    if (mode == 1) STREAM_LAUNCH(Bf16Wide);
    if (mode == 2) STREAM_LAUNCH(Int8Wide);
  } else if (mode == 0) {
    if (D <= 16) STREAM_LAUNCH(Int16Tail<4>);
    if (D <= 32) STREAM_LAUNCH(Int16Tail<8>);
    if (D <= 64) STREAM_LAUNCH(Int16Tail<16>);
    if (D <= 128) STREAM_LAUNCH(Int16Tail<32>);
  } else if (mode == 1) {
    if (D <= 8) STREAM_LAUNCH(Bf16Tail<4>);
    if (D <= 16) STREAM_LAUNCH(Bf16Tail<8>);
    if (D <= 32) STREAM_LAUNCH(Bf16Tail<16>);
    if (D <= 64) STREAM_LAUNCH(Bf16Tail<32>);
    if (D <= 128) STREAM_LAUNCH(Bf16Tail<64>);
  } else if (mode == 2) {
    if (D <= 16) STREAM_LAUNCH(Int8Tail<4>);
    if (D <= 32) STREAM_LAUNCH(Int8Tail<8>);
    if (D <= 64) STREAM_LAUNCH(Int8Tail<16>);
    if (D <= 128) STREAM_LAUNCH(Int8Tail<32>);
  }
#undef STREAM_LAUNCH
  return (int)cudaErrorInvalidValue;
}
