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

// D % 8 == 0, D <= 128, n_rows % 32 == 0 (checked by the Python
// wrapper).  Returns cudaGetLastError() after the launch.
extern "C" int decoded_mins_launch(const void* q, const void* xt, void* mins,
                                   int B, int D, int n_rows, int n_valid,
                                   void* stream) {
  if (n_rows == 0 || B == 0) return (int)cudaSuccess;
  if (D <= 32) return launch<16>(q, xt, mins, B, D, n_rows, n_valid, stream);
  if (D <= 64) return launch<32>(q, xt, mins, B, D, n_rows, n_valid, stream);
  if (D <= 128) return launch<64>(q, xt, mins, B, D, n_rows, n_valid, stream);
  return (int)cudaErrorInvalidValue;
}
