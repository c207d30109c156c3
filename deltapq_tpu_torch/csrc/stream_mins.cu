// Stream-tile decode + int16 two-digit scan + 32-row subtile minima.
//
// Replaces the TPU kernel deltapq_tpu/ops/fused_pallas.py:
// _stream_mins_kernel (with _stream_decode and the int16 branch of
// _scan_tail), reached from fused_stream_mins.  Python wrapper and
// plain PyTorch version: deltapq_tpu_torch/ops/fused_kernels.py.
//
// What it computes, per 1024-row stream tile t and query b:
//   decode   mask plane -> per-row diff count nd, block exclusive scan
//            -> row offset; each set subspace m reads its value from the
//            packed stream at p = meta[0,t]*1024 + meta[1,t] + off + rank
//            (flat layout (p/1024)*1024 + (p%8)*128 + (p/8)%128, see
//            ops/stream_tiles.py); forward fill of every subspace down
//            the tile (max-scan of the last row that set it).
//   scan     x^ digits a, b (A = 128a + b) from the compact codebook;
//            pre = sum A^2 (exact integer, from per-codeword norms);
//            aa = xa.qa, p2 = xa.qb + xb.qa, bb = xb.qb  (exact int32);
//            cross = ((16384*aa + 128*p2) + bb) * u[b]; d = pre - 2 cross
//            in the JAX order, with _rn intrinsics so no FMA contraction
//            changes the rounding; +inf at rows >= n_valid.
//   output   min over each 32-row subtile -> mins[t*32 + s, b]; the
//            decoded codes -> codes_out[t*1024 + r, m] (query block 0).
//
// What bounds it on an H100: the integer dot products, 4 int8 MACs per
// (row, query, dim) = 2.7e11 MACs at N=1M, B=512, D=128 -- about 6.7e10
// __dp4a, i.e. a few ms at the card's integer issue rate.  The stream
// itself is ~5 MB and the mins output 64 MB: memory is not the bound.
//
// Design: the TPU used one-hot matmuls in place of gathers (stream
// value window, codes -> x^ decode); here each is a plain gather from
// global or shared memory.  One block per (tile, 64-query block): the
// block decodes its tile into shared memory (1024 x 8 code bytes), keeps
// the compact [M, K, Ds] a/b-digit codebook (64 KB at M=8, K=256,
// Ds=16), the per-codeword norms and its 64 queries' digits in shared
// memory, and gives each warp 32-row subtiles: a lane holds its row's
// x^ digits in registers, reads each query's digits as broadcast
// 16-byte shared loads, and the subtile min is a warp shuffle-reduce.
// wgmma / int8 tensor cores are later work.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int TILE = 1024;
constexpr int SUB = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RPT = TILE / THREADS;      // rows per thread in the decode
constexpr int QB = 64;                   // queries per block
constexpr int MMAX = 8;                  // one mask plane, one group
constexpr unsigned FULL = 0xffffffffu;

struct Smem {
  size_t nrm, cw, q, u, codes, wsum, wlast, total;
};

// Shared-memory carve-up; nrm first so the int64 array is 8-aligned.
__host__ __device__ inline Smem smem_layout(int M, int K, int WS, int DW) {
  Smem s;
  s.nrm = 0;
  s.cw = s.nrm + sizeof(long long) * M * K;
  s.q = s.cw + sizeof(int) * 2 * M * K * WS;
  s.q = (s.q + 15) & ~size_t(15);
  s.u = s.q + sizeof(int) * QB * 2 * DW;
  s.codes = s.u + sizeof(float) * QB;
  s.wsum = s.codes + TILE * MMAX;
  s.wlast = s.wsum + sizeof(int) * WARPS;
  s.total = s.wlast + sizeof(int) * WARPS * MMAX;
  return s;
}

// DW: 32-bit words of one digit plane of a decoded row (D <= 4*DW).
template <int DW>
__global__ void __launch_bounds__(THREADS, 2)
stream_mins_kernel(const int8_t* __restrict__ q,       // [2*Dg, B]
                   const int* __restrict__ cw,         // [2, M, K, WS]
                   const long long* __restrict__ nrm,  // [M, K]
                   const uint8_t* __restrict__ row_data,  // [nT, 1, TILE]
                   const uint8_t* __restrict__ vals,   // packed stream
                   const int* __restrict__ meta,       // [2, nT]
                   const float* __restrict__ u,        // [B]
                   float* __restrict__ mins,           // [nT*32, B]
                   uint8_t* __restrict__ codes_out,    // [nT*TILE, M]
                   int B, int Dg, int nT, int n_valid, int M, int K,
                   int WS) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout(M, K, WS, DW);
  long long* nrm_s = reinterpret_cast<long long*>(smem + L.nrm);
  int* cw_s = reinterpret_cast<int*>(smem + L.cw);
  int* q_s = reinterpret_cast<int*>(smem + L.q);
  float* u_s = reinterpret_cast<float*>(smem + L.u);
  uint8_t* codes_s = smem + L.codes;
  int* wsum_s = reinterpret_cast<int*>(smem + L.wsum);
  int* wlast_s = reinterpret_cast<int*>(smem + L.wlast);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x;
  const int qb0 = blockIdx.y * QB;
  const int D = M * WS * 4;
  const int MKW = M * K * WS;

  // ---- operands into shared memory --------------------------------------
  for (int i = tid; i < 2 * MKW; i += THREADS) cw_s[i] = cw[i];
  for (int i = tid; i < M * K; i += THREADS) nrm_s[i] = nrm[i];
  {
    int8_t* qb_s = reinterpret_cast<int8_t*>(q_s);
    const int DP = 4 * DW;                 // bytes per digit plane
    for (int i = tid; i < QB * DP; i += THREADS) {
      const int b = i % QB, d = i / QB;    // consecutive b: coalesced
      int8_t a = 0, c = 0;
      if (d < D && qb0 + b < B) {
        a = q[(size_t)d * B + qb0 + b];
        c = q[(size_t)(Dg + d) * B + qb0 + b];
      }
      qb_s[b * 2 * DP + d] = a;
      qb_s[b * 2 * DP + DP + d] = c;
    }
    for (int b = tid; b < QB; b += THREADS)
      u_s[b] = (qb0 + b < B) ? u[qb0 + b] : 1.0f;
  }

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

  // ---- scan: one warp per 32-row subtile, lane = row --------------------
  const int MW = M * WS;                   // words of real dims
  for (int s = warp; s < TILE / SUB; s += WARPS) {
    const int r = s * SUB + lane;
    int xa[DW], xb[DW];
#pragma unroll
    for (int w = 0; w < DW; ++w) {
      if (w < MW) {
        const int m = w / WS;
        const int k = codes_s[r * MMAX + m];
        const int at = (m * K + k) * WS + (w - m * WS);
        xa[w] = cw_s[at];
        xb[w] = cw_s[MKW + at];
      } else {
        xa[w] = 0;
        xb[w] = 0;
      }
    }
    long long pre_i = 0;
    for (int m = 0; m < M; ++m) pre_i += nrm_s[m * K + codes_s[r * MMAX + m]];
    const float pre = __ll2float_rn(pre_i);   // exact integer, rounded once
    const bool valid = (long long)t * TILE + r < n_valid;

    for (int b0 = 0; b0 < QB; b0 += 32) {
      float mine = CUDART_INF_F;
      for (int bi = 0; bi < 32; ++bi) {
        const int b = b0 + bi;
        const int4* qa4 = reinterpret_cast<const int4*>(q_s + b * 2 * DW);
        const int4* qb4 = qa4 + DW / 4;
        int aa = 0, p2 = 0, bb = 0;
#pragma unroll
        for (int w4 = 0; w4 < DW / 4; ++w4) {
          const int4 A = qa4[w4];
          const int4 C = qb4[w4];
          aa = __dp4a(xa[4 * w4 + 0], A.x, aa);
          aa = __dp4a(xa[4 * w4 + 1], A.y, aa);
          aa = __dp4a(xa[4 * w4 + 2], A.z, aa);
          aa = __dp4a(xa[4 * w4 + 3], A.w, aa);
          p2 = __dp4a(xa[4 * w4 + 0], C.x, p2);
          p2 = __dp4a(xa[4 * w4 + 1], C.y, p2);
          p2 = __dp4a(xa[4 * w4 + 2], C.z, p2);
          p2 = __dp4a(xa[4 * w4 + 3], C.w, p2);
          p2 = __dp4a(xb[4 * w4 + 0], A.x, p2);
          p2 = __dp4a(xb[4 * w4 + 1], A.y, p2);
          p2 = __dp4a(xb[4 * w4 + 2], A.z, p2);
          p2 = __dp4a(xb[4 * w4 + 3], A.w, p2);
          bb = __dp4a(xb[4 * w4 + 0], C.x, bb);
          bb = __dp4a(xb[4 * w4 + 1], C.y, bb);
          bb = __dp4a(xb[4 * w4 + 2], C.z, bb);
          bb = __dp4a(xb[4 * w4 + 3], C.w, bb);
        }
        float cross = __fadd_rn(
            __fadd_rn(__fmul_rn(16384.0f, __int2float_rn(aa)),
                      __fmul_rn(128.0f, __int2float_rn(p2))),
            __int2float_rn(bb));
        cross = __fmul_rn(cross, u_s[b]);
        float d = valid ? __fsub_rn(pre, __fmul_rn(2.0f, cross))
                        : CUDART_INF_F;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          d = fminf(d, __shfl_xor_sync(FULL, d, o));
        if (lane == bi) mine = d;
      }
      const int b = qb0 + b0 + lane;
      if (b < B) mins[((size_t)t * (TILE / SUB) + s) * B + b] = mine;
    }
  }
}

template <int DW>
cudaError_t launch(const int8_t* q, const int* cw, const long long* nrm,
                   const uint8_t* row_data, const uint8_t* vals,
                   const int* meta, const float* u, float* mins,
                   uint8_t* codes_out, int B, int Dg, int nT, int n_valid,
                   int M, int K, int WS, cudaStream_t stream) {
  const Smem L = smem_layout(M, K, WS, DW);
  cudaError_t e = cudaFuncSetAttribute(
      stream_mins_kernel<DW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (e != cudaSuccess) return e;
  dim3 grid(nT, (B + QB - 1) / QB);
  stream_mins_kernel<DW><<<grid, THREADS, L.total, stream>>>(
      q, cw, nrm, row_data, vals, meta, u, mins, codes_out, B, Dg, nT,
      n_valid, M, K, WS);
  return cudaGetLastError();
}

}  // namespace

// Ds must be a multiple of 4, M <= 8, M*Ds <= 128 (checked by the
// Python wrapper).  Returns cudaGetLastError() after the launch.
extern "C" int stream_mins_launch(const void* q, const void* cw,
                                  const void* nrm, const void* row_data,
                                  const void* vals, const void* meta,
                                  const void* u, void* mins, void* codes_out,
                                  int B, int Dg, int nT, int n_valid, int M,
                                  int K, int Ds, void* stream) {
  const int WS = Ds / 4;
  const int words = M * WS;
  auto* qp = static_cast<const int8_t*>(q);
  auto* cwp = static_cast<const int*>(cw);
  auto* np_ = static_cast<const long long*>(nrm);
  auto* rd = static_cast<const uint8_t*>(row_data);
  auto* vp = static_cast<const uint8_t*>(vals);
  auto* mp = static_cast<const int*>(meta);
  auto* up = static_cast<const float*>(u);
  auto* op = static_cast<float*>(mins);
  auto* cp = static_cast<uint8_t*>(codes_out);
  auto st = static_cast<cudaStream_t>(stream);
  if (words <= 4)
    return launch<4>(qp, cwp, np_, rd, vp, mp, up, op, cp, B, Dg, nT,
                     n_valid, M, K, WS, st);
  if (words <= 8)
    return launch<8>(qp, cwp, np_, rd, vp, mp, up, op, cp, B, Dg, nT,
                     n_valid, M, K, WS, st);
  if (words <= 16)
    return launch<16>(qp, cwp, np_, rd, vp, mp, up, op, cp, B, Dg, nT,
                      n_valid, M, K, WS, st);
  if (words <= 32)
    return launch<32>(qp, cwp, np_, rd, vp, mp, up, op, cp, B, Dg, nT,
                      n_valid, M, K, WS, st);
  return (int)cudaErrorInvalidValue;
}
