// Decoded-tier scan: bf16 x^ rows . bf16 queries -> 32-row subtile minima.
//
// Replaces the TPU kernel deltapq_tpu/ops/fused_pallas.py:
// _decoded_mins_kernel, reached from fused_decoded_mins.  Python wrapper
// and plain PyTorch version: deltapq_tpu_torch/ops/fused_kernels.py.
//
// What it computes: xt [nT, tile, D] bf16 (rows contiguous, read as
// [N_pad, D]); q [D, B] bf16.  Per row n and query b:
//   pre   = sum_d x^[n,d]^2 in f32 (from the bf16 x^, as the TPU kernel);
//   cross = sum_d x^[n,d] q[d,b] in f32 (products of two bf16 values are
//           exact in f32; only the order of summation differs);
//   d     = pre - 2 cross, +inf at rows >= n_valid;
// and writes the minimum over every 32 consecutive rows to
// mins[n/32, b].
//
// What bounds it on an H100: it is GEMM-shaped, N x D x B multiply-adds
// (6.7e10 at N=1M, D=128, B=512).  Here they run as f32 fma on the CUDA
// cores (67 TFLOP/s peak, so ~2 ms at best), not on the tensor cores
// (989 TFLOP/s bf16); the rows (256 MB at N=1M) stream once per 64-query
// block.  Tensor-core mma is later work.
//
// Design: one block per (1024 rows, 64 queries); the queries sit in
// shared memory as f32; each warp takes 32-row subtiles, a lane loads its
// row's D bf16 values into registers with 16-byte loads and runs the
// shared bf16 query loop of scan_tail.cuh (warp shuffle-reduce for the
// subtile minimum).
//
// D > 128 (the GIST shape pads 960 -> 1024, a 2 KB row): a row no longer
// fits a lane's registers, so decoded_mins_wide_kernel walks it in chunks
// of 8 values with the partial sums of 16 queries in registers, as the
// wide scan tails do, and reads the row again for the next 16 queries;
// 32 queries a block stay in shared memory as bf16 pairs (66 KB at
// D=1024).  pre and cross are f32 fma chains in ascending d, the order of
// the narrow kernel.  The grid runs the query blocks of one row tile side
// by side (blockIdx.x), so a tile's 2 MB of rows are read from device
// memory once and from L2 by the other query blocks.

#include "scan_tail.cuh"

namespace {

using namespace scan_tail;

constexpr int ROWS = 1024;               // rows per block

template <int DW>
__global__ void __launch_bounds__(THREADS, 2)
decoded_mins_kernel(const uint16_t* __restrict__ q,    // [D, B] bf16
                    const uint16_t* __restrict__ xt,   // [n_rows, D] bf16
                    float* __restrict__ mins,          // [n_rows/32, B]
                    int B, int D, int n_rows, int n_valid) {
  __shared__ __align__(16) float q_s[QB * 2 * DW];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qb0 = blockIdx.y * QB;
  for (int i = tid; i < QB * 2 * DW; i += THREADS) {
    const int b = i % QB, d = i / QB;      // consecutive b: coalesced
    float v = 0.0f;
    if (d < D && qb0 + b < B)
      v = __uint_as_float((unsigned)q[(size_t)d * B + qb0 + b] << 16);
    q_s[b * 2 * DW + d] = v;
  }
  __syncthreads();
  const int nb = min(QB, B - qb0);
  const int n_sub = n_rows / SUB;
  for (int s = blockIdx.x * (ROWS / SUB) + warp;
       s < min(n_sub, (blockIdx.x + 1) * (ROWS / SUB)); s += WARPS) {
    const long long row = (long long)s * SUB + lane;
    const uint4* xr = reinterpret_cast<const uint4*>(xt + row * D);
    unsigned xw[DW];
#pragma unroll
    for (int i = 0; i < DW / 4; ++i) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (i < D / 8) v = xr[i];
      xw[4 * i + 0] = v.x;
      xw[4 * i + 1] = v.y;
      xw[4 * i + 2] = v.z;
      xw[4 * i + 3] = v.w;
    }
    float pre = 0.0f;
#pragma unroll
    for (int w = 0; w < DW; ++w) {
      const float lo = bf16_lo(xw[w]), hi = bf16_hi(xw[w]);
      pre = fmaf(lo, lo, pre);
      pre = fmaf(hi, hi, pre);
    }
    bf16_subtile_mins<DW>(xw, pre, row < n_valid, q_s,
                          mins + (size_t)s * B + qb0, nb, lane);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
decoded_mins_wide_kernel(const uint16_t* __restrict__ q,   // [D, B] bf16
                         const uint16_t* __restrict__ xt,  // [n_rows, D]
                         float* __restrict__ mins,         // [n_rows/32, B]
                         int B, int D, int n_rows, int n_valid) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* q_s = reinterpret_cast<unsigned*>(smem);   // [QBW, qstr] pairs
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qb0 = blockIdx.x * QBW;
  const int DW = D / 2, qstr = DW + 4;
  for (int i = tid; i < QBW * DW; i += THREADS) {
    const int b = i % QBW, w = i / QBW;      // consecutive b: coalesced
    unsigned word = 0u;
    if (qb0 + b < B)
      word = (unsigned)q[(size_t)(2 * w) * B + qb0 + b]
             | (unsigned)q[(size_t)(2 * w + 1) * B + qb0 + b] << 16;
    q_s[b * qstr + w] = word;
  }
  __syncthreads();
  const int nb = min(QBW, B - qb0);
  const int n_sub = n_rows / SUB;
  for (int s = blockIdx.y * (ROWS / SUB) + warp;
       s < min(n_sub, (blockIdx.y + 1) * (ROWS / SUB)); s += WARPS) {
    const long long row = (long long)s * SUB + lane;
    const uint4* xr = reinterpret_cast<const uint4*>(xt + row * D);
    const bool valid = row < n_valid;
    float* out = mins + (size_t)s * B + qb0;
    float pre = 0.0f;
    for (int q0 = 0; q0 < nb; q0 += QS) {
      float acc[QS];
#pragma unroll
      for (int bi = 0; bi < QS; ++bi) acc[bi] = 0.0f;
      for (int c = 0; c < D / 8; ++c) {
        const uint4 X = __ldg(xr + c);
        const float x[8] = {bf16_lo(X.x), bf16_hi(X.x), bf16_lo(X.y),
                            bf16_hi(X.y), bf16_lo(X.z), bf16_hi(X.z),
                            bf16_lo(X.w), bf16_hi(X.w)};
        if (q0 == 0) {
#pragma unroll
          for (int j = 0; j < 8; ++j) pre = fmaf(x[j], x[j], pre);
        }
#pragma unroll
        for (int bi = 0; bi < QS; ++bi) {
          const uint4 Q = *reinterpret_cast<const uint4*>(
              q_s + (q0 + bi) * qstr + 4 * c);
          float a = acc[bi];
          a = fmaf(x[0], bf16_lo(Q.x), a);
          a = fmaf(x[1], bf16_hi(Q.x), a);
          a = fmaf(x[2], bf16_lo(Q.y), a);
          a = fmaf(x[3], bf16_hi(Q.y), a);
          a = fmaf(x[4], bf16_lo(Q.z), a);
          a = fmaf(x[5], bf16_hi(Q.z), a);
          a = fmaf(x[6], bf16_lo(Q.w), a);
          a = fmaf(x[7], bf16_hi(Q.w), a);
          acc[bi] = a;
        }
      }
      float mine = CUDART_INF_F;
#pragma unroll
      for (int bi = 0; bi < QS; ++bi) {
        float d = valid ? __fsub_rn(pre, __fmul_rn(2.0f, acc[bi]))
                        : CUDART_INF_F;
        d = warp_min(d);
        if (lane == bi) mine = d;
      }
      if (lane < QS && q0 + lane < nb) out[q0 + lane] = mine;
    }
  }
}

int launch_wide(const void* q, const void* xt, void* mins, int B, int D,
                int n_rows, int n_valid, void* stream) {
  const size_t smem = sizeof(unsigned) * QBW * (D / 2 + 4);
  cudaError_t e = cudaFuncSetAttribute(
      decoded_mins_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((B + QBW - 1) / QBW, (n_rows + ROWS - 1) / ROWS);
  decoded_mins_wide_kernel<<<grid, THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(xt),
      static_cast<float*>(mins), B, D, n_rows, n_valid);
  return (int)cudaGetLastError();
}

template <int DW>
int launch(const void* q, const void* xt, void* mins, int B, int D,
           int n_rows, int n_valid, void* stream) {
  dim3 grid((n_rows + ROWS - 1) / ROWS, (B + QB - 1) / QB);
  decoded_mins_kernel<DW><<<grid, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(xt),
      static_cast<float*>(mins), B, D, n_rows, n_valid);
  return (int)cudaGetLastError();
}

}  // namespace

// D % 8 == 0, n_rows % 32 == 0, and above D = 128 at most 65,535 row
// tiles of 1024 (checked by the Python wrapper).  Returns
// cudaGetLastError() after the launch.
extern "C" int decoded_mins_launch(const void* q, const void* xt, void* mins,
                                   int B, int D, int n_rows, int n_valid,
                                   void* stream) {
  if (n_rows == 0 || B == 0) return (int)cudaSuccess;
  if (D <= 32) return launch<16>(q, xt, mins, B, D, n_rows, n_valid, stream);
  if (D <= 64) return launch<32>(q, xt, mins, B, D, n_rows, n_valid, stream);
  if (D <= 128) return launch<64>(q, xt, mins, B, D, n_rows, n_valid, stream);
  return launch_wide(q, xt, mins, B, D, n_rows, n_valid, stream);
}
