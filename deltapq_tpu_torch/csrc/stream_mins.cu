// Stream-tile decode + scan (int16 or bf16) + 32-row subtile minima.
//
// Replaces the TPU kernel deltapq_tpu/ops/fused_pallas.py:
// _stream_mins_kernel (with _stream_decode and the int16 and bf16
// branches of _scan_tail), reached from fused_stream_mins.  Python
// wrapper and plain PyTorch version: deltapq_tpu_torch/ops/fused_kernels.py.
//
// What it computes, per 1024-row stream tile t and query b:
//   decode   mask plane -> per-row diff count nd, block exclusive scan
//            -> row offset; each set subspace m reads its value from the
//            packed stream at p = meta[0,t]*1024 + meta[1,t] + off + rank
//            (flat layout (p/1024)*1024 + (p%8)*128 + (p/8)%128, see
//            ops/stream_tiles.py); forward fill of every subspace down
//            the tile (max-scan of the last row that set it).
//   scan     the shared tail (scan_tail.cuh): int16 digits or bf16 x^
//            against the queries, d = pre - 2 cross, +inf at rows >=
//            n_valid.
//   output   min over each 32-row subtile -> mins[t*32 + s, b]; the
//            decoded codes -> codes_out[t*1024 + r, m] (query block 0).
//
// What bounds it on an H100: the dot products.  int16: 4 int8 MACs per
// (row, query, dim) = 2.7e11 MACs at N=1M, B=512, D=128 -- about 6.7e10
// __dp4a.  bf16: 6.7e10 f32 fma plus two bf16 unpacks per pair.  The
// stream itself is ~5 MB and the mins output 64 MB: memory is not the
// bound.
//
// Design: the TPU used one-hot matmuls in place of gathers (stream
// value window, codes -> x^ decode); here each is a plain gather from
// global or shared memory.  One block per (tile, 64-query block): the
// block decodes its tile into shared memory (1024 x 8 code bytes) and
// hands it to the shared tail, which keeps the compact codebook, the
// per-codeword norms and its 64 queries in shared memory.  wgmma /
// tensor cores are later work.

#include "scan_tail.cuh"

namespace {

using namespace scan_tail;

constexpr int RPT = TILE / THREADS;      // rows per thread in the decode

// shared memory after the tail's operands: codes | wsum | wlast
template <class Tail>
__host__ __device__ inline size_t decode_base(int M, int K, int Ds) {
  return Tail::layout(M, K, Ds).total;
}
template <class Tail>
__host__ __device__ inline size_t smem_total(int M, int K, int Ds) {
  return decode_base<Tail>(M, K, Ds) + TILE * MMAX + sizeof(int) * WARPS
         + sizeof(int) * WARPS * MMAX;
}

template <class Tail>
__global__ void __launch_bounds__(THREADS, 2)
stream_mins_kernel(const void* __restrict__ q, const void* __restrict__ cw,
                   const void* __restrict__ nrm,
                   const uint8_t* __restrict__ row_data,  // [nT, 1, TILE]
                   const uint8_t* __restrict__ vals,      // packed stream
                   const int* __restrict__ meta,          // [2, nT]
                   const float* __restrict__ u,           // [B] or null
                   float* __restrict__ mins,              // [nT*32, B]
                   uint8_t* __restrict__ codes_out,       // [nT*TILE, M]
                   int B, int Dg, int nT, int n_valid, int M, int K,
                   int Ds) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t base0 = decode_base<Tail>(M, K, Ds);
  uint8_t* codes_s = smem + base0;
  int* wsum_s = reinterpret_cast<int*>(smem + base0 + TILE * MMAX);
  int* wlast_s = wsum_s + WARPS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x;
  const int qb0 = blockIdx.y * QB;

  Tail::load(smem, q, cw, nrm, u, B, Dg, qb0, M, K, Ds);

  // ---- decode: per-row diff counts and their block exclusive scan -------
  const int r0 = tid * RPT;
  unsigned mask[RPT];
  int nd[RPT], tsum = 0;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    mask[i] = row_data[(size_t)t * TILE + r0 + i];
    nd[i] = __popc(mask[i]);
    tsum += nd[i];
  }
  int incl = tsum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) wsum_s[warp] = incl;
  __syncthreads();
  int off = incl - tsum;
  for (int w = 0; w < warp; ++w) off += wsum_s[w];

  // ---- decode: gather each set subspace's value from the stream ---------
  const long long base = (long long)meta[t] * 1024 + meta[nT + t];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    int j = 0;
    for (int m = 0; m < M; ++m) {
      if (mask[i] >> m & 1u) {
        const long long p = base + off + j;
        const long long idx = (p >> 10 << 10) + (p & 7) * 128
                              + ((p >> 3) & 127);
        codes_s[(r0 + i) * MMAX + m] = vals[idx];
        ++j;
      }
    }
    off += nd[i];
  }

  // ---- decode: forward fill = max-scan of the last row setting m --------
  int last[RPT][MMAX];
  int agg[MMAX];
#pragma unroll
  for (int m = 0; m < MMAX; ++m) {
    int ls = -1;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (m < M && (mask[i] >> m & 1u)) ls = r0 + i;
      last[i][m] = ls;
    }
    agg[m] = ls;
  }
  int excl[MMAX];
#pragma unroll
  for (int m = 0; m < MMAX; ++m) {
    int v = agg[m];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int w = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v = max(v, w);
    }
    int ex = __shfl_up_sync(FULL, v, 1);
    excl[m] = lane == 0 ? -1 : ex;
    if (lane == 31) wlast_s[warp * MMAX + m] = v;
  }
  __syncthreads();   // raw values and warp aggregates visible
  uint8_t code[RPT][MMAX];
#pragma unroll
  for (int m = 0; m < MMAX; ++m) {
    int pre = excl[m];
    for (int w = 0; w < warp; ++w) pre = max(pre, wlast_s[w * MMAX + m]);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int src = max(pre, last[i][m]);   // row 0 is full: src >= 0
      code[i][m] = (m < M) ? codes_s[src * MMAX + m] : 0;
    }
  }
  __syncthreads();   // every fill read done before overwriting
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int m = 0; m < MMAX; ++m) codes_s[(r0 + i) * MMAX + m] = code[i][m];
  if (blockIdx.y == 0) {
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      for (int m = 0; m < M; ++m)
        codes_out[((size_t)t * TILE + r0 + i) * M + m] = code[i][m];
  }
  __syncthreads();

  Tail::scan(smem, codes_s, mins, t, B, qb0, n_valid, M, K, Ds);
}

template <class Tail>
int launch(const void* q, const void* cw, const void* nrm, const void* rd,
           const void* vals, const void* meta, const void* u, void* mins,
           void* codes_out, int B, int Dg, int nT, int n_valid, int M, int K,
           int Ds, void* stream) {
  const size_t smem = smem_total<Tail>(M, K, Ds);
  cudaError_t e = cudaFuncSetAttribute(
      stream_mins_kernel<Tail>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(nT, (B + QB - 1) / QB);
  stream_mins_kernel<Tail><<<grid, THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      q, cw, nrm, static_cast<const uint8_t*>(rd),
      static_cast<const uint8_t*>(vals), static_cast<const int*>(meta),
      static_cast<const float*>(u), static_cast<float*>(mins),
      static_cast<uint8_t*>(codes_out), B, Dg, nT, n_valid, M, K, Ds);
  return (int)cudaGetLastError();
}

}  // namespace

// mode 0: int16 (Ds % 4 == 0, M*Ds <= 128); mode 1: bf16 (Ds % 2 == 0,
// M*Ds <= 128).  M <= 8 (checked by the Python wrapper).  Returns
// cudaGetLastError() after the launch.
extern "C" int stream_mins_launch(const void* q, const void* cw,
                                  const void* nrm, const void* row_data,
                                  const void* vals, const void* meta,
                                  const void* u, void* mins, void* codes_out,
                                  int B, int Dg, int nT, int n_valid, int M,
                                  int K, int Ds, int mode, void* stream) {
  if (nT == 0 || B == 0) return (int)cudaSuccess;
  const int D = M * Ds;
#define STREAM_LAUNCH(T)                                                   \
  return launch<T>(q, cw, nrm, row_data, vals, meta, u, mins, codes_out, B, \
                   Dg, nT, n_valid, M, K, Ds, stream)
  if (mode == 0) {
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
  }
#undef STREAM_LAUNCH
  return (int)cudaErrorInvalidValue;
}
