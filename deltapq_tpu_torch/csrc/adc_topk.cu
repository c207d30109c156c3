// ADC distances per tile + tile-local top-k, selected inside a warp.
//
// Replaces the TPU kernel deltapq_tpu/ops/adc_pallas.py:_adc_topk_kernel
// (with _accumulate_onehot) in its three precisions, reached from
// adc_topk_pallas.  Python wrapper, plain PyTorch version and the
// cross-tile merge: deltapq_tpu_torch/ops/adc_kernels.py.
//
// What it computes, per tile t of tile_n rows and query b:
//   dist[r] = sum_m tab[b, m*K + codes[t*tile_n + r, m]], added in
//             ascending m from 0.0f with __fadd_rn: of f32 table values
//             ("f32", bit-equal to the plain scan, ops/adc.py
//             adc_query_topk), of the table rounded to bf16 ("bf16"), or of
//             its bf16 hi and lo parts, hi then lo for each m ("bf16x2");
//             +inf at rows >= n_valid;
//   then what top_k rounds of mask-argmin give on the TPU: the top_k
//   smallest (value, row) pairs -- the lower row wins a tie, as argmin --
//   in ascending order, written to out_d/out_i[t, j, b] (tile-local row);
//   a tile with fewer than top_k finite rows fills the rest with (+inf,
//   row 0), as argmin over an all-inf column does.
//
// What bounds it on an H100: the operations, N*B*M f32 additions at the
// CUDA cores' 67 TFLOP/s (0.064 ms at N=1M, B=512, M=8), and next to them
// the same number of table lookups in shared memory, at most 32 four-byte
// words a clock on each SM (about 0.5 ms there).  The old design ran 2*top_k
// block barriers for every (tile, query) and reread each row's codes for
// every query; its selection took about half of its 11.4 ms.
//
// Design:
//   * A warp owns QI queries (one at f32 and bf16x2, two at bf16) and meets
//     every row of the tile with them, one row a lane.  Its tables sit in
//     shared memory as [M*K] groups of GROUP_BYTES = 4 (entry (m, k) of its
//     QI queries side by side), so one 4-byte load of a code serves QI
//     lookups.  A block holds as many warps as their tables fit beside
//     the code chunk, up to 24 (all 24 at M=8, K=256).  Measured on the
//     H100 (kernels/ablate_adc.py): 8- and 16-byte groups, which serve more
//     queries a load, leave fewer warps to hide the loads' latency and ran
//     slower.
//   * The tile's codes are staged once a block for all its warps, word by
//     word, transposed to [word][row] so that a warp's 32 rows read 32
//     consecutive words; a chunk of at most 32 KB at a time.
//   * Selection without block barriers: each warp keeps, for each of its
//     queries, the best top_k (value, row) pairs so far in registers,
//     sorted, element j in lane j % 32 of register j / 32 (KR = ceil(top_k
//     / 32) registers).  Rows arrive in ascending order, so a new distance
//     enters only if it is strictly below the current top_k-th value tau;
//     a ballot finds the lanes that beat tau, and each of them is inserted
//     in lane order by one shuffle-shift of the list (equal values keep
//     the earlier, lower row first).  After the first rows tau is small and
//     an insertion rare (about top_k * ln(tile_n / top_k) a tile).  A
//     launch selects at most 256 ranks; a larger top_k takes further
//     launches, each keeping only the rows that come after the last
//     (value, row) of the launch before.
//   * A persistent grid (as many blocks as the card holds at once) walks
//     the (query group, tile) items in contiguous ranges, so a block stages
//     its tables once or twice in all.

#include <math_constants.h>

#include <algorithm>

#include "adc_lookup.cuh"
#include "mma.cuh"

namespace {

using adc::FULL;

constexpr int CODE_BYTES = 32 * 1024;   // shared memory of a code chunk
constexpr int GROUP_BYTES = 4;          // a table group: one load of a code

// Warps a block may hold: a one-register list leaves room for 24 (at most
// 85 registers a thread), a longer one for 16 (128 registers).
template <int KR> struct Warps {
  static constexpr int MAX = KR == 1 ? 24 : 16;
};

template <int BYTES> struct Vec { using type = uint2; };
template <> struct Vec<4> { using type = unsigned; };
template <> struct Vec<16> { using type = uint4; };

// A table group: entry (m, k) of the QI queries a warp owns, side by side.
template <int P> struct Group {
  using E = typename adc::Entry<P>::type;
  using V = typename Vec<GROUP_BYTES>::type;
  static constexpr int QI = GROUP_BYTES / (int)sizeof(E);
};

// acc[i] += the entry of query i in group g, as adc_lookup.cuh:add_entry
// adds it.
template <int P>
__device__ __forceinline__ void add_group(float (&acc)[Group<P>::QI],
                                          typename Group<P>::V g) {
  const auto* e = reinterpret_cast<const typename Group<P>::E*>(&g);
#pragma unroll
  for (int i = 0; i < Group<P>::QI; ++i)
    acc[i] = adc::add_entry<P>(acc[i], e[i]);
}

// Insert (v, row) into a warp's sorted list (element j: lane j % 32,
// register j / 32): every element after the place of v moves one down.
// v is finite and row higher than every row already in the list, so v goes
// after the elements equal to it.
template <int KR>
__device__ __forceinline__ void insert(float (&val)[KR], int (&rw)[KR],
                                       float v, int row, int lane) {
  float pv[KR];
  int pr[KR];
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    pv[r] = __shfl_sync(FULL, val[r], (lane + 31) & 31);
    pr[r] = __shfl_sync(FULL, rw[r], (lane + 31) & 31);
  }
#pragma unroll
  for (int r = KR - 1; r >= 0; --r) {
    // element 32r + lane - 1; lane 0 of register r follows lane 31 of r - 1
    const float prev = lane ? pv[r] : (r ? pv[r > 0 ? r - 1 : 0]
                                         : -CUDART_INF_F);
    const int prow = lane ? pr[r] : pr[r > 0 ? r - 1 : 0];
    if (v < prev) {
      val[r] = prev;
      rw[r] = prow;
    } else if (v < val[r]) {
      val[r] = v;
      rw[r] = row;
    }
  }
}

// The value of element k of the list, in every lane.
template <int KR>
__device__ __forceinline__ float element(const float (&val)[KR], int k) {
  float x = val[0];
#pragma unroll
  for (int r = 1; r < KR; ++r)
    if (r == k >> 5) x = val[r];
  return __shfl_sync(FULL, x, k & 31);
}

// DEEP: a later launch of a top_k above one launch's ranks, which keeps
// only the rows after the last (value, row) of the launch before.
template <int P, typename CodeT, int KR, bool DEEP>
__global__ void __launch_bounds__(Warps<KR>::MAX * 32, 1)
adc_topk_kernel(const typename adc::Entry<P>::type* __restrict__ tab,
                                                    // [B, M*K] entries
                const CodeT* __restrict__ codes,    // [N_pad, M]
                float* __restrict__ out_d,          // [nT, top_k, B]
                int* __restrict__ out_i,            // [nT, top_k, B]
                int B, int M, int K, int nT, int tile_n, int n_valid,
                int top_k, int j0, int kp, int CH, int nqg) {
  using E = typename adc::Entry<P>::type;
  using V = typename Group<P>::V;
  constexpr int QI = Group<P>::QI;
  constexpr int CPW = 4 / sizeof(CodeT);             // codes a word
  extern __shared__ __align__(16) unsigned char smem[];
  const int MK = M * K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = blockDim.x >> 5, QC = W * QI;
  const int RB = M * (int)sizeof(CodeT);             // bytes of a code row
  const int WR = (RB + 3) / 4;                       // words of a code row
  const int WF = M / CPW;                            // words of CPW codes
  V* tab_s = reinterpret_cast<V*>(smem);             // [W][MK] groups
  unsigned* codes_s = reinterpret_cast<unsigned*>(smem + (size_t)W * MK *
                                                  GROUP_BYTES);
  const V* tab_w = tab_s + (size_t)warp * MK;

  const long long n_items = (long long)nqg * nT;
  const long long it0 = n_items * blockIdx.x / gridDim.x;
  const long long it1 = n_items * (blockIdx.x + 1) / gridDim.x;
  int staged = -1;
  for (long long item = it0; item < it1; ++item) {
    const int qg = (int)(item / nT), t = (int)(item - (long long)qg * nT);
    const int q0 = qg * QC;
    if (qg != staged) {
      __syncthreads();   // every warp is done with the last group's tables
      E* te = reinterpret_cast<E*>(tab_s);
      for (int i = tid; i < QC * MK; i += blockDim.x) {
        const int ql = i / MK, mk = i - ql * MK;
        const int w = ql / QI, qi = ql - w * QI;
        te[((size_t)w * MK + mk) * QI + qi] =
            q0 + ql < B ? tab[(size_t)(q0 + ql) * MK + mk] : E(0);
      }
      staged = qg;
    }

    float val[QI][KR];
    int rw[QI][KR];
#pragma unroll
    for (int qi = 0; qi < QI; ++qi)
#pragma unroll
      for (int r = 0; r < KR; ++r) {
        val[qi][r] = CUDART_INF_F;
        rw[qi][r] = 0;
      }
    float tau[QI], lo_v[QI];
    int lo_r[QI];
#pragma unroll
    for (int qi = 0; qi < QI; ++qi) {
      const int q = q0 + warp * QI + qi;
      tau[qi] = CUDART_INF_F;
      lo_v[qi] = -CUDART_INF_F;
      lo_r[qi] = -1;
      if (DEEP && q < B) {
        const size_t o = ((size_t)t * top_k + j0 - 1) * B + q;
        lo_v[qi] = out_d[o];
        lo_r[qi] = out_i[o];
      }
    }

    const long long row0 = (long long)t * tile_n;
    for (int c0 = 0; c0 < tile_n && row0 + c0 < n_valid; c0 += CH) {
      const int ch = min(CH, tile_n - c0);
      __syncthreads();   // the last chunk's codes (and the tables) are read
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          codes + (row0 + c0) * M);
      if (RB % 4 == 0 && ((uintptr_t)src & 15) == 0) {
        // [row][word] in global -> [word][row]: four words a 16-byte load
        const uint4* s4 = reinterpret_cast<const uint4*>(src);
        for (int i = tid; i < ch * WR / 4; i += blockDim.x) {
          const uint4 x = s4[i];
          const unsigned wd[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int idx = 4 * i + j, r = idx / WR;
            codes_s[(idx - r * WR) * CH + r] = wd[j];
          }
        }
      } else {
        unsigned char* cb = reinterpret_cast<unsigned char*>(codes_s);
        for (int i = tid; i < ch * RB; i += blockDim.x) {
          const int r = i / RB, b = i - r * RB;
          cb[((b >> 2) * CH + r) * 4 + (b & 3)] = src[i];
        }
      }
      __syncthreads();

      // rows of the chunk below n_valid
      const long long left = n_valid - row0 - c0;
      const int nv = left < ch ? (int)left : ch;
      if (q0 + warp * QI < B) {
        for (int s = 0; s < ch; s += 32) {
          const int r = s + lane;                // row of the chunk
          float acc[QI];
#pragma unroll
          for (int qi = 0; qi < QI; ++qi) acc[qi] = 0.0f;
#pragma unroll 2
          for (int w = 0; w < WF; ++w) {
            const unsigned word = codes_s[w * CH + r];
            V e[CPW];
#pragma unroll
            for (int j = 0; j < CPW; ++j) {
              const unsigned c = CPW == 4 ? (word >> (8 * j)) & 0xffu : word;
              e[j] = tab_w[(CPW * w + j) * K + (int)c];
            }
#pragma unroll
            for (int j = 0; j < CPW; ++j) add_group<P>(acc, e[j]);
          }
          if (CPW == 4 && WF < WR) {               // M % 4 codes are left
            const unsigned word = codes_s[WF * CH + r];
            for (int m = 4 * WF; m < M; ++m)
              add_group<P>(acc, tab_w[m * K + ((word >> (8 * (m & 3))) &
                                               0xffu)]);
          }
#pragma unroll
          for (int qi = 0; qi < QI; ++qi) {
            float d = r < nv ? acc[qi] : CUDART_INF_F;
            if (DEEP && !(d > lo_v[qi]
                          || (d == lo_v[qi] && c0 + r > lo_r[qi])))
              d = CUDART_INF_F;
            unsigned hit = __ballot_sync(FULL, d < tau[qi]);
            while (hit) {
              const int src_lane = __ffs(hit) - 1;
              insert<KR>(val[qi], rw[qi], __shfl_sync(FULL, d, src_lane),
                         c0 + s + src_lane, lane);
              tau[qi] = element<KR>(val[qi], kp - 1);
              hit &= hit - 1;
              hit &= __ballot_sync(FULL, d < tau[qi]);
            }
          }
        }
      }
    }

#pragma unroll
    for (int qi = 0; qi < QI; ++qi) {
      const int q = q0 + warp * QI + qi;
      if (q >= B) continue;
#pragma unroll
      for (int r = 0; r < KR; ++r) {
        const int j = 32 * r + lane;
        if (j < kp) {
          const size_t o = ((size_t)t * top_k + j0 + j) * B + q;
          out_d[o] = val[qi][r];
          out_i[o] = rw[qi][r];
        }
      }
    }
  }
}

template <int P, typename CodeT, int KR, bool DEEP>
cudaError_t launch(const void* tab, const void* codes, float* out_d,
                   int* out_i, int B, int M, int K, int n_pad, int tile_n,
                   int n_valid, int top_k, int j0, int kp,
                   cudaStream_t st) {
  constexpr int QI = Group<P>::QI;
  auto kernel = adc_topk_kernel<P, CodeT, KR, DEEP>;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const int WR = (M * (int)sizeof(CodeT) + 3) / 4;
  const int CH = std::min(tile_n,
                          std::max(32, CODE_BYTES / (4 * WR) / 32 * 32));
  const size_t code_smem = (size_t)4 * WR * CH;
  const size_t per_warp = (size_t)GROUP_BYTES * M * K;
  const long long fit = ((long long)optin - (long long)code_smem)
                        / (long long)per_warp;
  if (fit < 1) return cudaErrorInvalidValue;
  const int nqw = (B + QI - 1) / QI;                  // warps the batch fills
  const int W = (int)std::min((long long)std::min(Warps<KR>::MAX, nqw), fit);
  const size_t smem = per_warp * W + code_smem;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  const int nT = n_pad / tile_n;
  const int nqg = (B + W * QI - 1) / (W * QI);
  int grid = 0;
  if (e == cudaSuccess)
    e = mma::resident_grid(kernel, 32 * W, smem, (long long)nqg * nT, &grid);
  if (e != cudaSuccess) return e;
  kernel<<<grid, 32 * W, smem, st>>>(
      static_cast<const typename adc::Entry<P>::type*>(tab),
      static_cast<const CodeT*>(codes), out_d, out_i, B, M, K, nT, tile_n,
      n_valid, top_k, j0, kp, CH, nqg);
  return cudaGetLastError();
}

template <int P, typename CodeT>
cudaError_t launch_k(const void* tab, const void* codes, float* out_d,
                     int* out_i, int B, int M, int K, int n_pad, int tile_n,
                     int n_valid, int top_k, cudaStream_t st) {
  // launches of at most 256 ranks; after the first, each keeps the rows
  // after the last (value, row) of the one before (DEEP)
#define ADC_TOPK_LAUNCH(KR, DEEP, J0, KP)                                   \
  launch<P, CodeT, KR, DEEP>(tab, codes, out_d, out_i, B, M, K, n_pad,      \
                             tile_n, n_valid, top_k, J0, KP, st)
  const int k0 = std::min(256, top_k);
  cudaError_t e = k0 <= 32    ? ADC_TOPK_LAUNCH(1, false, 0, k0)
                  : k0 <= 64  ? ADC_TOPK_LAUNCH(2, false, 0, k0)
                  : k0 <= 128 ? ADC_TOPK_LAUNCH(4, false, 0, k0)
                              : ADC_TOPK_LAUNCH(8, false, 0, k0);
  for (int j0 = k0; j0 < top_k && e == cudaSuccess; j0 += 256)
    e = ADC_TOPK_LAUNCH(8, true, j0, std::min(256, top_k - j0));
#undef ADC_TOPK_LAUNCH
  return e;
}

template <int P>
cudaError_t launch_codes(int code_bytes, const void* tab, const void* codes,
                         float* out_d, int* out_i, int B, int M, int K,
                         int n_pad, int tile_n, int n_valid, int top_k,
                         cudaStream_t st) {
  if (code_bytes == 1)
    return launch_k<P, uint8_t>(tab, codes, out_d, out_i, B, M, K, n_pad,
                                tile_n, n_valid, top_k, st);
  if (code_bytes == 4)
    return launch_k<P, int32_t>(tab, codes, out_d, out_i, B, M, K, n_pad,
                                tile_n, n_valid, top_k, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// prec 0 (tab f32 [B, M*K]), 1 (bf16 [B, M*K]) or 2 (bf16 [B, M*K, 2]: hi,
// lo); code_bytes 1 (u8 codes) or 4 (int32 codes, K > 256); tile_n a
// multiple of 32 dividing n_pad; one warp's tables, 4*M*K
// bytes, must fit the block's shared memory beside a code chunk (checked
// by the Python wrapper).  Returns cudaGetLastError() after the launch (or
// the error of a request the card refuses).
extern "C" int adc_topk_launch(const void* tab, const void* codes,
                               void* out_d, void* out_i, int B, int M, int K,
                               int n_pad, int tile_n, int n_valid, int top_k,
                               int code_bytes, int prec, void* stream) {
  if (n_pad == 0 || B == 0 || top_k == 0) return (int)cudaSuccess;
  if (tile_n % 32 || n_pad % tile_n) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* dp = static_cast<float*>(out_d);
  auto* ip = static_cast<int*>(out_i);
  switch (prec) {
    case adc::F32:
      return (int)launch_codes<adc::F32>(code_bytes, tab, codes, dp, ip, B,
                                         M, K, n_pad, tile_n, n_valid, top_k,
                                         st);
    case adc::BF16:
      return (int)launch_codes<adc::BF16>(code_bytes, tab, codes, dp, ip, B,
                                          M, K, n_pad, tile_n, n_valid,
                                          top_k, st);
    case adc::BF16X2:
      return (int)launch_codes<adc::BF16X2>(code_bytes, tab, codes, dp, ip,
                                            B, M, K, n_pad, tile_n, n_valid,
                                            top_k, st);
  }
  return (int)cudaErrorInvalidValue;
}
