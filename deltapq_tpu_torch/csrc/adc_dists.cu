// The full ADC distance matrix.
//
// Replaces the TPU kernel deltapq_tpu/ops/adc_pallas.py:_adc_dists_kernel,
// reached from adc_dists_pallas.  Python wrapper and plain PyTorch
// version: deltapq_tpu_torch/ops/adc_kernels.py.
//
// What it computes: out[b, n] = sum_m tab[b, m*K + codes[n, m]], added in
// ascending m from 0.0f with __fadd_rn, so it is bit-equal to the plain
// scan's tile distances (ops/adc.py adc_tile_dists).  No n_valid mask (the
// TPU kernel has none).  The TPU kernel writes [N, B] and its wrapper
// transposes; this one writes the [B, N] result directly.
//
// What bounds it on an H100: the f32 output, N*B*4 bytes (2 GiB at N=1M,
// B=512, 40x the L2: 0.64 ms at 3.35 TB/s), and beside it N*B*M table
// lookups in shared memory, at most 32 four-byte words a clock on each SM
// (0.51 ms there).  The two can overlap.
//
// Design:
//   * Lanes on queries.  A block holds the tables of QL queries (16 where
//     they fit: 128 KB at M=8, K=256; 8 at M=16) as [M*K][QL], entry (m,
//     k) of its QL queries in QL consecutive words.  A lane owns QV = 4
//     consecutive queries (QV = 1 where fewer than 4 share a block) and
//     reads their entries at code c of a row in one 16-byte load, word
//     (m*K + c)*QL + 4*v; QL/QV lanes meet one row.  A quarter-warp's two
//     rows meet in the same banks when their codes have the same parity,
//     so a load takes 1.5 wavefronts a quarter-warp on average: 21 lookups
//     a wavefront, against about 8.4 when each lane looks up its own row in
//     one query's [M*K] table (B6's bank conflicts, as
//     kernels/ablate_adc.py measures them).  One load, one address and one
//     code extraction serve four lookups.  Each sum stays one lane's
//     ascending-m __fadd_rn chain.
//   * Runs of rows.  A lane sums RUN = 4 consecutive rows for each of its
//     queries and writes each query's run as one 16-byte piece, so the
//     eight lanes of a query (eight row groups) write a whole 128-byte line
//     of its output row in one instruction.  Streaming stores
//     (st.global.cs, STREAM) measured no faster (kernels/ablate_dists.py).
//   * WARPS warps a block over one staged table (32: 1,024 threads, which
//     is all an SM holds beside 128 KB of tables), and a persistent grid
//     that walks (query group, row chunk) items in contiguous ranges,
//     query-major, so a block stages its tables once or twice in all.
//   * A lane reads its rows' codes (u8 with M = 4, 8 or 16) in one 4-, 8-
//     or 16-byte load a row, shared by the lanes of its row, all of a run
//     before the first lookup; other shapes (int32 codes for K > 256, any
//     other M) read one code a lookup.
// Measured on the H100 (kernels/ablate_dists.py, N=1M, B=512, M=8): about
// 1.15-1.2 ms, against 2.3-2.4 with lanes on rows; the sums without the
// stores take 0.87 ms and the stores without the lookups 0.90, where the
// card fills the same [B, N] output in 0.66: the two limits overlap in
// part.  All output offsets are 64-bit.

#include "adc_lookup.cuh"
#include "mma.cuh"

namespace {

constexpr int WARPS = 32;         // warps a block
constexpr int QL_MAX = 16;        // queries across a warp's lanes
constexpr int QV_MAX = 4;         // queries a lane reads in one load
constexpr int QR = 1;             // queries a lane sums in turn
constexpr bool STREAM = false;    // streaming stores
constexpr int RUN = 4;            // consecutive rows a lane sums
static_assert(RUN % 4 == 0, "a run is stored in 16-byte pieces");

template <int MT> struct CodeWords;   // MT u8 codes in one load
template <> struct CodeWords<4> { using type = unsigned; };
template <> struct CodeWords<8> { using type = uint2; };
template <> struct CodeWords<16> { using type = uint4; };

template <int QV> struct Entries;     // QV queries' entries in one load
template <> struct Entries<1> { using type = float; };
template <> struct Entries<4> { using type = float4; };

__device__ __forceinline__ void put(float* p, float x) {
  if (STREAM)
    __stcs(p, x);
  else
    *p = x;
}
__device__ __forceinline__ void put4(float* p, float4 x) {
  if (STREAM)
    __stcs(reinterpret_cast<float4*>(p), x);
  else
    *reinterpret_cast<float4*>(p) = x;
}

// acc[i] += the entry of the lane's query i at code c, read from Tm = T +
// m*K*QL (T: the lane's first query)
template <int QV>
__device__ __forceinline__ void add_entries(float (&acc)[QV], const float* Tm,
                                            int c, int lq) {
  using V = typename Entries<QV>::type;
  const V e = *reinterpret_cast<const V*>(Tm + (c << lq));
  const float* f = reinterpret_cast<const float*>(&e);
#pragma unroll
  for (int i = 0; i < QV; ++i) acc[i] = adc::add_entry<adc::F32>(acc[i], f[i]);
}

// acc[s][i] = sum_m T[((m*K + c) << lq) + i] over the codes c of row r0 +
// s, ascending m from 0.0f with __fadd_rn (adc_lookup.cuh add_entry);
// rows at or past r_end read code 0.  MT = 4, 8, 16: a row's u8 codes in
// one load, every row's before the first lookup; MT = 0: M codes of a row
// one at a time.
template <typename CodeT, int MT, int QV>
__device__ __forceinline__ void run_sums(float (&acc)[RUN][QV],
                                         const float* T,
                                         const CodeT* __restrict__ codes,
                                         long long r0, long long r_end,
                                         int M, int KQ, int lq) {
#pragma unroll
  for (int s = 0; s < RUN; ++s)
#pragma unroll
    for (int i = 0; i < QV; ++i) acc[s][i] = 0.0f;
  if constexpr (MT == 0) {
#pragma unroll
    for (int s = 0; s < RUN; ++s) {
      if (r0 + s < r_end) {
        const CodeT* c = codes + (r0 + s) * M;
        for (int m = 0; m < M; ++m)
          add_entries<QV>(acc[s], T + m * KQ, (int)__ldg(c + m), lq);
      }
    }
  } else {
    using W = typename CodeWords<MT>::type;
    W v[RUN];
#pragma unroll
    for (int s = 0; s < RUN; ++s)
      v[s] = r0 + s < r_end
                 ? __ldg(reinterpret_cast<const W*>(codes + (r0 + s) * MT))
                 : W{};
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int s = 0; s < RUN; ++s) {
        const unsigned w = reinterpret_cast<const unsigned*>(&v[s])[m >> 2];
        add_entries<QV>(acc[s], T + m * KQ, (w >> (8 * (m & 3))) & 0xff, lq);
      }
    }
  }
}

// A block's tables: [QR][M*K][QL], query q0 + j*QL + q at (j, mk, q); a
// lane owns queries q0 + j*QL + v*QV + i, i < QV.  vec: out rows may be
// written in 16-byte pieces (N % 4 == 0, aligned).
template <typename CodeT, int MT, int QV>
__global__ void __launch_bounds__(WARPS * 32, 1)
adc_dists_kernel(const float* __restrict__ tab,     // [B, M*K]
                 const CodeT* __restrict__ codes,   // [N, M]
                 float* __restrict__ out,           // [B, N]
                 int B, int M, int K, long long N, int lq, int item_rows,
                 int n_chunks, int nqg, bool vec) {
  extern __shared__ __align__(16) float tab_s[];
  const int QL = 1 << lq, MK = M * K, KQ = K << lq;
  const int LR = QL / QV;                     // lanes a row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int v = lane % LR, g = lane / LR;
  const int step = 32 / LR * RUN;             // rows a warp sums at a time
  const int stride = (blockDim.x >> 5) * step;
  const int QB = QL * QR;                     // queries a block
  const long long n_items = (long long)nqg * n_chunks;
  const long long it0 = n_items * blockIdx.x / gridDim.x;
  const long long it1 = n_items * (blockIdx.x + 1) / gridDim.x;
  int staged = -1;
  for (long long item = it0; item < it1; ++item) {
    const int qg = (int)(item / n_chunks);
    const long long r_begin = (item - (long long)qg * n_chunks) * item_rows;
    const long long r_end = min(N, r_begin + item_rows);
    const int q0 = qg * QB;
    if (qg != staged) {
      __syncthreads();   // every warp is done with the last group's tables
      for (int i = threadIdx.x; i < QB * MK; i += blockDim.x) {
        const int ql = i / MK, mk = i - ql * MK;
        const int j = ql >> lq;
        tab_s[(size_t)j * MK * QL + (mk << lq) + (ql & (QL - 1))] =
            q0 + ql < B ? tab[(size_t)(q0 + ql) * MK + mk] : 0.0f;
      }
      __syncthreads();
      staged = qg;
    }
#pragma unroll 1
    for (int j = 0; j < QR; ++j) {
      const int b0 = q0 + j * QL + v * QV;    // the lane's first query
      if (b0 >= B) break;
      const float* T = tab_s + j * MK * QL + v * QV;
      for (long long r0 = r_begin + warp * step + g * RUN; r0 < r_end;
           r0 += stride) {
        float acc[RUN][QV];
        run_sums<CodeT, MT, QV>(acc, T, codes, r0, r_end, M, KQ, lq);
#pragma unroll
        for (int i = 0; i < QV; ++i) {
          if (b0 + i >= B) break;
          float* o = out + (size_t)(b0 + i) * N + r0;
          if (vec && r0 + RUN <= r_end) {
#pragma unroll
            for (int s = 0; s < RUN; s += 4)
              put4(o + s, make_float4(acc[s][i], acc[s + 1][i],
                                      acc[s + 2][i], acc[s + 3][i]));
          } else {
#pragma unroll
            for (int s = 0; s < RUN; ++s)
              if (r0 + s < r_end) put(o + s, acc[s][i]);
          }
        }
      }
    }
  }
}

template <typename CodeT, int MT, int QV>
cudaError_t launch(const float* tab, const CodeT* codes, float* out, int B,
                   int M, int K, long long N, int lq, cudaStream_t st) {
  auto kernel = adc_dists_kernel<CodeT, MT, QV>;
  const size_t smem = ((size_t)4 * M * K * QR) << lq;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int item_rows = WARPS * 32 * RUN;
  const int n_chunks = (int)((N + item_rows - 1) / item_rows);
  const int QB = QR << lq;
  const int nqg = (B + QB - 1) / QB;
  int grid = 0;
  e = mma::resident_grid(kernel, 32 * WARPS, smem, (long long)nqg * n_chunks,
                         &grid);
  if (e != cudaSuccess) return e;
  const bool vec = N % 4 == 0 && ((uintptr_t)out & 15) == 0;
  kernel<<<grid, 32 * WARPS, smem, st>>>(tab, codes, out, B, M, K, N, lq,
                                         item_rows, n_chunks, nqg, vec);
  return cudaGetLastError();
}

// QV_MAX queries a lane where a row's lanes cover that many, else one
template <typename CodeT, int MT>
cudaError_t launch_qv(const float* tab, const CodeT* codes, float* out,
                      int B, int M, int K, long long N, int lq,
                      cudaStream_t st) {
  if ((1 << lq) >= QV_MAX)
    return launch<CodeT, MT, QV_MAX>(tab, codes, out, B, M, K, N, lq, st);
  return launch<CodeT, MT, 1>(tab, codes, out, B, M, K, N, lq, st);
}

}  // namespace

// code_bytes 1 (u8 codes) or 4 (int32 codes, K > 256); one query's table,
// 4*M*K bytes, must fit a block's shared memory (checked by the Python
// wrapper).  Returns cudaGetLastError() after the launch (or the error of
// a request the card refuses).
extern "C" int adc_dists_launch(const void* tab, const void* codes,
                                void* out, int B, int M, int K, int n,
                                int code_bytes, void* stream) {
  if (n == 0 || B == 0) return (int)cudaSuccess;
  if (code_bytes != 1 && code_bytes != 4) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* tp = static_cast<const float*>(tab);
  auto* op = static_cast<float*>(out);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  // lq = log2 QL: the fewest lanes that cover the batch, up to QL_MAX,
  // whose tables fit
  const size_t table = (size_t)4 * M * K * QR;
  if (table > (size_t)optin) return (int)cudaErrorInvalidValue;
  int lq = 0;
  while ((2 << lq) <= QL_MAX && (1 << lq) * QR < B &&
         (table << (lq + 1)) <= (size_t)optin)
    ++lq;
  if (code_bytes == 4)
    return (int)launch_qv<int32_t, 0>(
        tp, static_cast<const int32_t*>(codes), op, B, M, K, n, lq, st);
  auto* cp = static_cast<const uint8_t*>(codes);
  // the M codes of a row in one load where the rows are aligned to it
  const uintptr_t at = (uintptr_t)cp;
  if (M == 4 && at % 4 == 0)
    return (int)launch_qv<uint8_t, 4>(tp, cp, op, B, M, K, n, lq, st);
  if (M == 8 && at % 8 == 0)
    return (int)launch_qv<uint8_t, 8>(tp, cp, op, B, M, K, n, lq, st);
  if (M == 16 && at % 16 == 0)
    return (int)launch_qv<uint8_t, 16>(tp, cp, op, B, M, K, n, lq, st);
  return (int)launch_qv<uint8_t, 0>(tp, cp, op, B, M, K, n, lq, st);
}
