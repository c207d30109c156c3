// The bf16 prepare on the card: one launch a batch makes, from the raw
// query batch, the exact ADC table, the centred bf16 query operand of the
// scan kernels and the certificate's q2.
//
// Replaces no TPU kernel: the JAX package's prepare is XLA (adc_table) and
// NumPy (padding, centring, the grouped layout, the bf16 cast).  On this
// card that stage was host work while the card idled: NumPy padding and
// centring, a one-thread bf16 cast and transpose, three pageable copies and
// about ten small launches a batch (0.87 ms of a 2.28-ms call at SIFT1M's
// B=512).  Now the host copies the raw batch once, pinned, and this kernel
// does the rest.  Python wrapper and plain PyTorch version (fused_prepare,
// fused_prepare_ref): deltapq_tpu_torch/ops/fused_kernels.py.
//
// Inputs: q [B, Dq] f32, the raw batch (rows >= B and columns >= Dq read
// as 0, the host's zero padding); cw [M, K, Ds] f32; mu [d_pad] f32, the
// centre (0 beyond M*Ds).  Outputs for B_pad rows (a multiple of 32):
//   table [B_pad, M, K] f32: (q2_bm - 2 cross_bmk) + c2_mk, adc_table's
//     expression on the raw query.  cross is an FMA chain over j ascending
//     from 0, as the f32 matmul accumulates; q2_bm and c2_mk add squares
//     rounded one by one, as torch's sum of q * q.  So the table differs
//     from adc_table's only by the order of its sums.
//   qop [G*Dg, B_pad] bf16: qop[g*Dg + j, b] = bf16_rn(q[b, g*W + j] -
//     mu[g*W + j]) for j < min(W, n_src - g*W), else 0: the grouped layout
//     of fused_kernels.group_geometry (W = Mg*Ds, n_src = M*Ds) or the
//     decoded tier's plain one (G = 1, W = Dg = n_src = d_pad).  The f32
//     subtraction and the round-to-nearest-even cast are the host's, so
//     the operand is bit-equal to the host path's.
//   q2 [B_pad] f32: sum over d < d_pad of (q[b, d] - mu[d])^2.
//
// Grid (B_pad / 32, M + 1).  Block (x, m < M) writes the table of 32
// queries in subspace m: the tile's query slices transposed into shared
// memory [Ds][32], the subspace's codewords staged 256 at a time [256][Ds
// + 1] (an odd row stride: no bank conflicts), a thread a codeword with 32
// accumulators, one a query, each query's row written along k (coalesced).
// A subspace wider than 128 columns is staged 128 columns at a time, the
// sums carried from one chunk to the next in the same order.
// Block (x, M) writes the operand and q2 of the same 32 queries: 32 x 256
// pieces transposed through shared memory, so reads along d and writes
// along b are whole lines; q2 adds the squares of the values it writes
// (each source column appears once in either layout) and reduces the
// warps' shares in a fixed order.  Staging loops issue 16 loads a thread
// before storing any.
//
// What bounds it on an H100: the table write (4.19 MB at SIFT1M's B=512,
// 1.3 us at 3.35 TB/s), or at GIST's Ds=60 the cross products (252 MFLOP,
// 3.8 us at 67 TFLOP/s); an empty launch of this grid takes 1.7 us.  It
// takes 8.9 us at SIFT1M's shape and 44.5 us at GIST's (table blocks
// alone 24.2, operand blocks alone 39.3): taking out the table's stores
// or its shared-memory query reads moves it by under 1%, taking out the
// operand block's global loads saves 19 us at GIST (PERF.md section 7).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int QB = 32;          // queries a block
constexpr int KC = THREADS;     // codewords staged at a time
constexpr int DC = 128;         // subspace columns staged at a time
constexpr int RP = 256;         // operand rows an operand block's pass
constexpr int UNROLL = 16;      // loads in flight a thread while staging

// A table block's shared memory, at least the operand block's tile and
// its warps' q2 shares.
constexpr size_t OPERAND_FLOATS = (size_t)QB * (RP + 1) + WARPS * QB;
constexpr size_t smem_bytes(int Ds) {
  const size_t dc = Ds < DC ? Ds : DC;
  const size_t table = dc * QB + QB + (size_t)KC * (dc + 1);
  return sizeof(float) * (table > OPERAND_FLOATS ? table : OPERAND_FLOATS);
}

// The host's padded batch: zero outside [B, Dq].
__device__ __forceinline__ float raw(const float* __restrict__ q, int b,
                                     int d, int B, int Dq) {
  return (b < B && d < Dq) ? q[(size_t)b * Dq + d] : 0.0f;
}

__device__ void table_block(const float* __restrict__ q,
                            const float* __restrict__ cw,
                            float* __restrict__ table, float* smem, int b0,
                            int m, int B, int Dq, int M, int K, int Ds) {
  const int dc_max = min(Ds, DC);       // smem_bytes(Ds)'s chunk
  float* qs = smem;                     // [dc_max][QB]
  float* q2s = qs + dc_max * QB;        // [QB]
  float* cws = q2s + QB;                // [KC][dc_max + 1]
  const int tid = threadIdx.x;
  const bool one_chunk = Ds <= DC;      // qs staged once for every k0
  const float* cwm = cw + (size_t)m * K * Ds;
  float q2 = 0.0f;                      // thread tid < QB: query tid's
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    float acc[QB];
#pragma unroll
    for (int b = 0; b < QB; ++b) acc[b] = 0.0f;
    float c2 = 0.0f;
    for (int j0 = 0; j0 < Ds; j0 += DC) {
      const int dc = min(DC, Ds - j0);
      __syncthreads();                  // the last chunk read
      if (k0 == 0 || !one_chunk) {
        for (int i0 = 0; i0 < QB * dc; i0 += THREADS * UNROLL) {
          float v[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int i = i0 + u * THREADS + tid, b = i / dc;
            v[u] = i < QB * dc
                       ? raw(q, b0 + b, m * Ds + j0 + i - b * dc, B, Dq)
                       : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int i = i0 + u * THREADS + tid, b = i / dc;
            if (i < QB * dc) qs[(i - b * dc) * QB + b] = v[u];
          }
        }
      }
      for (int i0 = 0; i0 < kc * dc; i0 += THREADS * UNROLL) {
        float v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int i = i0 + u * THREADS + tid, kk = i / dc;
          v[u] = i < kc * dc
                     ? cwm[(size_t)(k0 + kk) * Ds + j0 + i - kk * dc]
                     : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int i = i0 + u * THREADS + tid, kk = i / dc;
          if (i < kc * dc) cws[kk * (dc + 1) + i - kk * dc] = v[u];
        }
      }
      __syncthreads();
      if (k0 == 0 && tid < QB) {
        for (int j = 0; j < dc; ++j) {
          const float x = qs[j * QB + tid];
          q2 = __fadd_rn(q2, __fmul_rn(x, x));
        }
      }
      if (tid < kc) {
        const float* c_row = cws + tid * (dc + 1);
        for (int j = 0; j < dc; ++j) {
          const float c = c_row[j];
          c2 = __fadd_rn(c2, __fmul_rn(c, c));
          const float4* qj = reinterpret_cast<const float4*>(qs + j * QB);
#pragma unroll
          for (int v = 0; v < QB / 4; ++v) {
            const float4 x = qj[v];
            acc[4 * v + 0] = __fmaf_rn(x.x, c, acc[4 * v + 0]);
            acc[4 * v + 1] = __fmaf_rn(x.y, c, acc[4 * v + 1]);
            acc[4 * v + 2] = __fmaf_rn(x.z, c, acc[4 * v + 2]);
            acc[4 * v + 3] = __fmaf_rn(x.w, c, acc[4 * v + 3]);
          }
        }
      }
    }
    if (k0 == 0) {                      // the same for the whole block
      if (tid < QB) q2s[tid] = q2;
      __syncthreads();
    }
    if (tid < kc) {
      const int k = k0 + tid;
#pragma unroll
      for (int b = 0; b < QB; ++b)
        table[((size_t)(b0 + b) * M + m) * K + k] =
            __fadd_rn(__fsub_rn(q2s[b], __fmul_rn(2.0f, acc[b])), c2);
    }
  }
}

__device__ void operand_block(const float* __restrict__ q,
                              const float* __restrict__ mu,
                              __nv_bfloat16* __restrict__ qop,
                              float* __restrict__ q2, float* smem, int b0,
                              int B, int Dq, int B_pad, int d_pad, int G,
                              int W, int Dg, int n_src) {
  float (*tile)[RP + 1] = reinterpret_cast<float (*)[RP + 1]>(smem);
  float* share = smem + QB * (RP + 1);  // [WARPS][QB]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows = G * Dg;
  float s = 0.0f;                       // this thread's share of q2[lane]
  for (int r0 = 0; r0 < rows; r0 += RP) {
#pragma unroll
    for (int cc = 0; cc < RP / 32; ++cc) {
      const int rr = cc * 32 + lane, r = r0 + rr;
      const int g = r / Dg, j = r - g * Dg, c = g * W + j;
      const bool take = r < rows && j < W && c < n_src;
      const float m = take ? mu[c] : 0.0f;
#pragma unroll
      for (int i = 0; i < QB / WARPS; ++i) {
        const int bb = warp + i * WARPS;
        tile[bb][rr] =
            take ? __fsub_rn(raw(q, b0 + bb, c, B, Dq), m) : 0.0f;
      }
    }
    __syncthreads();
    for (int rr = warp; rr < RP; rr += WARPS) {
      const int r = r0 + rr;
      if (r < rows) {
        const float x = tile[lane][rr];
        s = __fadd_rn(s, __fmul_rn(x, x));
        qop[(size_t)r * B_pad + b0 + lane] = __float2bfloat16_rn(x);
      }
    }
    __syncthreads();
  }
  share[warp * QB + lane] = s;
  __syncthreads();
  if (warp == 0) {
    float t = 0.0f;
    for (int w = 0; w < WARPS; ++w) t = __fadd_rn(t, share[w * QB + lane]);
    // columns past the layout's sources: mu is 0 there, and so is q past
    // Dq, so only a batch wider than M*Ds adds anything
    for (int d = n_src; d < min(Dq, d_pad); ++d) {
      const float x = __fsub_rn(raw(q, b0 + lane, d, B, Dq), mu[d]);
      t = __fadd_rn(t, __fmul_rn(x, x));
    }
    q2[b0 + lane] = t;
  }
}

__global__ void __launch_bounds__(THREADS)
prepare_kernel(const float* __restrict__ q, const float* __restrict__ cw,
               const float* __restrict__ mu, float* __restrict__ table,
               __nv_bfloat16* __restrict__ qop, float* __restrict__ q2, int B,
               int Dq, int B_pad, int M, int K, int Ds, int d_pad, int G,
               int W, int Dg, int n_src) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int b0 = blockIdx.x * QB, m = blockIdx.y;
  if (m < M)
    table_block(q, cw, table, smem, b0, m, B, Dq, M, K, Ds);
  else
    operand_block(q, mu, qop, q2, smem, b0, B, Dq, B_pad, d_pad, G, W, Dg,
                  n_src);
}

}  // namespace

// q [B, Dq] f32 (Dq <= d_pad), cw [M, K, Ds] f32, mu [d_pad]
// f32; B_pad >= B a multiple of 32; the operand layout (G, W, Dg, n_src)
// with n_src <= d_pad.  Returns cudaGetLastError() after the launch.
extern "C" int prepare_launch(const void* q, const void* cw, const void* mu,
                              void* table, void* qop, void* q2, int B, int Dq,
                              int B_pad, int M, int K, int Ds, int d_pad,
                              int G, int W, int Dg, int n_src, void* stream) {
  if (B_pad == 0) return (int)cudaSuccess;
  if (B < 0 || B > B_pad || B_pad % QB != 0 || Dq < 0 || Dq > d_pad
      || M < 1 || K < 1 || Ds < 1 || M * Ds > d_pad || G < 1
      || W < 1 || Dg < 1 || n_src > d_pad)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Ds);
  const cudaError_t e = cudaFuncSetAttribute(
      prepare_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(DC));
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B_pad / QB, M + 1);
  prepare_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(cw),
      static_cast<const float*>(mu), static_cast<float*>(table),
      static_cast<__nv_bfloat16*>(qop), static_cast<float*>(q2), B, Dq, B_pad,
      M, K, Ds, d_pad, G, W, Dg, n_src);
  return (int)cudaGetLastError();
}
