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
//   scan     the shared tail (scan_tail.cuh) in the int16, int8 or bf16
//            mode, d = pre - 2 cross, +inf at rows >= n_valid.
//   output   min over each 32-row subtile -> mins[t*32 + s, b]; the
//            decoded codes -> codes_out[t*1024 + r, m] (query block 0).
//
// What bounds it on an H100: the dot products of the tail, as in the
// stream kernel (stream_mins.cu); the decode reads P+S bytes a row plus
// the bank (M*Cap bytes a tile), about 4 MB at N=1M, M=8.
//
// Design: the TPU decoded rows-on-lanes, with a Hillis-Steele roll chain
// for the overflow rank and a one-hot matmul to scatter the overflow
// codes.  Here the overflow rank is a block exclusive count of the
// nd > S rows (warp shuffles plus a prefix over the 8 warp totals), each
// value is a plain load into the shared-memory code tile, and the forward
// fill is the stream kernel's block max-scan (tile_decode.cuh).  One block
// per (tile, query block); the tail reads the decoded tile from shared
// memory (the narrow or the wide form of scan_tail.cuh, by shape).

#include "tile_decode.cuh"

namespace {

using namespace scan_tail;
using namespace tile_decode;

template <class Tail>
__global__ void __launch_bounds__(THREADS, 2)
delta_mins_kernel(const void* __restrict__ q, const void* __restrict__ cw,
                  const void* __restrict__ nrm,
                  const uint8_t* __restrict__ row_data,  // [nT, P+S, TILE]
                  const uint8_t* __restrict__ ovf,       // [nT, M, Cap]
                  const float* __restrict__ u,           // [B] or null
                  float* __restrict__ mins,              // [nT*32, B]
                  uint8_t* __restrict__ codes_out,       // [nT*TILE, M]
                  int B, int Dg, int n_valid, int M, int K, int Ds, int S,
                  int Cap) {
  constexpr int MS = Tail::MS;
  extern __shared__ __align__(16) unsigned char smem[];
  const Scratch sc = scratch<MS>(smem + Tail::layout(M, K, Ds).total);
  const int tid = threadIdx.x;
  const int t = blockIdx.x;
  const int qb0 = blockIdx.y * Tail::QBLK;
  const int P = (M + 7) / 8;
  const uint8_t* rd = row_data + (size_t)t * (P + S) * TILE;
  const uint8_t* bank = ovf + (size_t)t * M * Cap;
  const unsigned full = (1u << M) - 1u;

  Tail::load(smem, q, cw, nrm, u, B, Dg, qb0, M, K, Ds);

  // ---- overflow rows and their rank: a block exclusive count ------------
  const int r0 = tid * RPT;
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

  forward_fill<MS>(
      set, sc.codes, sc.wlast, M,
      blockIdx.y == 0 ? codes_out + (size_t)t * TILE * M : nullptr);

  Tail::scan(smem, sc.codes, mins, t, B, qb0, n_valid, M, K, Ds, cw, nrm);
}

template <class Tail>
int launch(const void* q, const void* cw, const void* nrm, const void* rd,
           const void* ovf, const void* u, void* mins, void* codes_out,
           int B, int Dg, int nT, int n_valid, int M, int K, int Ds, int S,
           int Cap, void* stream) {
  const size_t smem = Tail::layout(M, K, Ds).total
                      + scratch_bytes<Tail::MS>();
  cudaError_t e = cudaFuncSetAttribute(
      delta_mins_kernel<Tail>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(nT, (B + Tail::QBLK - 1) / Tail::QBLK);
  delta_mins_kernel<Tail><<<grid, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      q, cw, nrm, static_cast<const uint8_t*>(rd),
      static_cast<const uint8_t*>(ovf), static_cast<const float*>(u),
      static_cast<float*>(mins), static_cast<uint8_t*>(codes_out), B, Dg,
      n_valid, M, K, Ds, S, Cap);
  return (int)cudaGetLastError();
}

}  // namespace

// mode 0: int16 (Ds % 4 == 0); mode 1: bf16 (Ds % 2 == 0); mode 2: int8
// (Ds % 4 == 0); 2 <= M <= 16, 1 <= S < M; Dg is the rows of one plane of
// q (checked by the Python wrapper).  M <= 8 with M*Ds <= 128 takes the
// narrow tails, any other shape the wide ones.  Returns cudaGetLastError()
// after the launch.
extern "C" int delta_mins_launch(const void* q, const void* cw,
                                 const void* nrm, const void* row_data,
                                 const void* ovf, const void* u, void* mins,
                                 void* codes_out, int B, int Dg, int nT,
                                 int n_valid, int M, int K, int Ds, int S,
                                 int Cap, int mode, void* stream) {
  if (nT == 0 || B == 0) return (int)cudaSuccess;
  if (M < 2 || M > MSW || S < 1 || S >= M || Cap < 1)
    return (int)cudaErrorInvalidValue;
  const int D = M * Ds;
#define DELTA_LAUNCH(T)                                                   \
  return launch<T>(q, cw, nrm, row_data, ovf, u, mins, codes_out, B, Dg,  \
                   nT, n_valid, M, K, Ds, S, Cap, stream)
  if (M > MMAX || D > 128) {
    if (mode == 0) DELTA_LAUNCH(Int16Wide);
    if (mode == 1) DELTA_LAUNCH(Bf16Wide);
    if (mode == 2) DELTA_LAUNCH(Int8Wide);
  } else if (mode == 0) {
    if (D <= 16) DELTA_LAUNCH(Int16Tail<4>);
    if (D <= 32) DELTA_LAUNCH(Int16Tail<8>);
    if (D <= 64) DELTA_LAUNCH(Int16Tail<16>);
    if (D <= 128) DELTA_LAUNCH(Int16Tail<32>);
  } else if (mode == 1) {
    if (D <= 8) DELTA_LAUNCH(Bf16Tail<4>);
    if (D <= 16) DELTA_LAUNCH(Bf16Tail<8>);
    if (D <= 32) DELTA_LAUNCH(Bf16Tail<16>);
    if (D <= 64) DELTA_LAUNCH(Bf16Tail<32>);
    if (D <= 128) DELTA_LAUNCH(Bf16Tail<64>);
  } else if (mode == 2) {
    if (D <= 16) DELTA_LAUNCH(Int8Tail<4>);
    if (D <= 32) DELTA_LAUNCH(Int8Tail<8>);
    if (D <= 64) DELTA_LAUNCH(Int8Tail<16>);
    if (D <= 128) DELTA_LAUNCH(Int8Tail<32>);
  }
#undef DELTA_LAUNCH
  return (int)cudaErrorInvalidValue;
}
