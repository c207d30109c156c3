// ADC distances per tile + tile-local top-k, selected inside a warp: B6
// (value, row) pairs, B9 packed int32 keys and B10 packed keys over
// tile-dictionary tables, one kernel.
//
// Replaces the TPU kernels deltapq_tpu/ops/adc_pallas.py:_adc_topk_kernel
// (B6, reached from adc_topk_pallas), _adc_topk_packed_kernel (B9, reached
// from adc_topk_packed), with _accumulate_onehot, in their three
// precisions, and _adc_topk_tiledict_kernel (B10, reached from
// adc_topk_tiledict and TileDictEngine).  Python wrappers, plain PyTorch
// versions, the host-side dictionary build and the cross-tile merges:
// deltapq_tpu_torch/ops/adc_kernels.py.
//
// What it computes, per tile t of tile_n rows and query b:
//   dist[r] = sum_m tab[b, m*K + codes[t*tile_n + r, m]], added in
//             ascending m from 0.0f with __fadd_rn: of f32 table values
//             ("f32", bit-equal to the plain scan, ops/adc.py
//             adc_query_topk), of the table rounded to bf16 ("bf16"), or of
//             its bf16 hi and lo parts, hi then lo for each m ("bf16x2");
//   B6 (PairTopK): dist, or +inf at rows >= n_valid; then what top_k rounds
//             of mask-argmin give on the TPU: the top_k smallest (value,
//             row) pairs -- the lower row wins a tie, as argmin -- in
//             ascending order, written to out_d/out_i[t, j, b] (tile-local
//             row); a tile with fewer than top_k finite rows fills the rest
//             with (+inf, row 0), as argmin over an all-inf column does;
//   B9 (PackedTopK, tile_n <= 4096): the key of adc_lookup.cuh:packed_key
//             (order-preserving distance bits, the low 12 bits the
//             tile-local row, 0x7fffffff past n_valid); then what top_k
//             sweeps last = min(key where key > last) from INT_MIN give:
//             keys are unique within a tile, so the top_k smallest in
//             ascending order, 0x7fffffff once the tile runs out, written to
//             out[t, j, b];
//   B10 (f32, u8 indexes, tile_n <= 4096): B9's keys over the table
//             compacted through tile t's dictionary, t_m[d] = tab[b, m*K +
//             dict[t, m, d]] (the TPU kernel's [D, K] one-hot matmul), and
//             dist[r] = sum_m t_m[idx[t*tile_n + r, m]]: the same f32 values
//             in the same order as B9 reads through the codes, so the keys
//             equal B9's f32 keys on the same rows.
//
// What bounds it on an H100: the operations, N*B*M f32 additions at the
// CUDA cores' 67 TFLOP/s (0.064 ms at N=1M, B=512, M=8), and next to them
// the same number of table lookups in shared memory, at most 32 four-byte
// words a clock on each SM (about 0.5 ms there).  A selection in block-wide
// rounds (the TPU kernels' mask-argmin and threshold sweeps, carried over
// as they are) costs a block barrier a rank for every (tile, query), about
// half of such a kernel's time on this card (PERF.md).
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
//     slower.  So did, for B9, the lanes of a warp on one row and many
//     queries (lookups without bank conflicts, a selection per lane): no
//     faster at f32 and bf16x2, slower at bf16.  Where two bf16 tables of a
//     warp do not fit (B9 takes 2*M*K up to 160 KB), B9 runs 2-byte groups,
//     one query a warp.
//   * The tile's codes are staged once a block for all its warps, word by
//     word, transposed to [word][row] so that a warp's 32 rows read 32
//     consecutive words; a chunk of at most 32 KB at a time.
//   * Selection without block barriers: each warp keeps, for each of its
//     queries, the best top_k keys so far in registers, sorted, element j
//     in lane j % 32 of register j / 32 (KR = ceil(top_k / 32) registers).
//     Rows arrive in ascending order, so a new key enters only if it is
//     strictly below the current top_k-th key tau; a ballot finds the lanes
//     that beat tau, and each of them is inserted in lane order by one
//     shuffle-shift of the list (B6: equal values keep the earlier, lower
//     row first; B9's keys are unique and need no tie rule).  After the
//     first rows tau is small and an insertion rare (about top_k * ln(tile_n
//     / top_k) a tile).  A launch selects at most 256 ranks; a larger top_k
//     takes further launches (DEEP), each keeping only the rows whose key
//     comes after the last key of the launch before.
//   * A persistent grid (as many blocks as the card holds at once) walks
//     the (query group, tile) items in contiguous ranges, so a block stages
//     its tables once or twice in all.
//   * B10 (DictTables) differs in where a warp's tables come from: each
//     (query group, tile) item gathers them from the f32 table in device
//     memory (4 MB at B=512, resident in the L2 cache) through the tile's
//     dictionary, D entries a subspace in place of K, a thread a column
//     with its loads for the group's queries in flight together.  Items
//     run tile-major, so a block walks the query groups of one tile in
//     turn and keeps the tile's indexes (one chunk: 2048 rows x 8 bytes)
//     while it restages only the compact tables.  The compact tables are
//     K/D times smaller, so wider groups fit: B10 takes the widest of 16,
//     8 and 4 bytes with which a block still holds as many warps as at 4
//     (16 at D <= 64 and M=8: four queries a warp, one load and one code
//     extraction for four lookups).  Measured on the H100
//     (kernels/ablate_tiledict.py): at D = 64 16-byte groups take 1.52 ms
//     where 4-byte ones, free of bank conflicts but one lookup a load,
//     take 2.46; at D = 256 4-byte groups are the fastest.

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
template <> struct Vec<2> { using type = uint16_t; };
template <> struct Vec<4> { using type = unsigned; };
template <> struct Vec<16> { using type = uint4; };

// A table group of GB bytes: entry (m, k) of the QI queries a warp owns,
// side by side.
template <int P, int GB> struct Group {
  using E = typename adc::Entry<P>::type;
  using V = typename Vec<GB>::type;
  static constexpr int QI = GB / (int)sizeof(E);
  static_assert(QI >= 1, "a group holds an entry");
};

// acc[i] += the entry of query i in group g, as adc_lookup.cuh:add_entry
// adds it.
template <int P, int GB>
__device__ __forceinline__ void add_group(float (&acc)[Group<P, GB>::QI],
                                          typename Group<P, GB>::V g) {
  const auto* e = reinterpret_cast<const typename Group<P, GB>::E*>(&g);
#pragma unroll
  for (int i = 0; i < Group<P, GB>::QI; ++i)
    acc[i] = adc::add_entry<P>(acc[i], e[i]);
}

// The element k of a warp's list (element j: lane j % 32, register j / 32),
// in every lane.
template <int KR, typename T>
__device__ __forceinline__ T element(const T (&val)[KR], int k) {
  T x = val[0];
#pragma unroll
  for (int r = 1; r < KR; ++r)
    if (r == k >> 5) x = val[r];
  return __shfl_sync(FULL, x, k & 31);
}

// The outputs of the two selections, each [nT, top_k, B].
struct PairOut {
  float* d;
  int* i;
};
struct PackedOut {
  int* k;
};

// B6's list: (value, row) pairs, the lower row first among equal values;
// the unfilled tail reads (+inf, row 0).
template <int KR_>
struct PairTopK {
  static constexpr int KR = KR_;
  using Key = float;                       // what a row is selected on
  using Out = PairOut;
  float val[KR];
  int rw[KR];
  float lo_v;                              // DEEP: the last pair of the
  int lo_r;                                // launch before

  __device__ static Key none() { return CUDART_INF_F; }
  __device__ void init() {
#pragma unroll
    for (int r = 0; r < KR; ++r) {
      val[r] = CUDART_INF_F;
      rw[r] = 0;
    }
    lo_v = -CUDART_INF_F;
    lo_r = -1;
  }
  __device__ void restart(const Out& o, size_t at) {
    lo_v = o.d[at];
    lo_r = o.i[at];
  }
  // the key of tile-local row `row` whose sum is acc
  template <bool DEEP>
  __device__ Key key(float acc, int row, bool valid) const {
    float d = valid ? acc : CUDART_INF_F;
    if (DEEP && !(d > lo_v || (d == lo_v && row > lo_r))) d = CUDART_INF_F;
    return d;
  }
  // Insert (v, row): every element after the place of v moves one down.
  // v is finite and row higher than every row already in the list, so v
  // goes after the elements equal to it.
  __device__ void insert(float v, int row, int lane) {
    float pv[KR];
    int pr[KR];
#pragma unroll
    for (int r = 0; r < KR; ++r) {
      pv[r] = __shfl_sync(FULL, val[r], (lane + 31) & 31);
      pr[r] = __shfl_sync(FULL, rw[r], (lane + 31) & 31);
    }
#pragma unroll
    for (int r = KR - 1; r >= 0; --r) {
      // element 32r + lane - 1; lane 0 of register r follows lane 31 of r-1
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
  __device__ Key kth(int k) const { return element<KR>(val, k); }
  __device__ void store(const Out& o, size_t at, int r) const {
    o.d[at] = val[r];
    o.i[at] = rw[r];
  }
};

// B9's list: packed int32 keys, unique within a tile; the unfilled tail
// reads 0x7fffffff.
template <int KR_>
struct PackedTopK {
  static constexpr int KR = KR_;
  using Key = int;
  using Out = PackedOut;
  int keys[KR];
  int lo;                                  // DEEP: the last key before

  __device__ static Key none() { return adc::KEY_BIG; }
  __device__ void init() {
#pragma unroll
    for (int r = 0; r < KR; ++r) keys[r] = adc::KEY_BIG;
    lo = INT_MIN;
  }
  __device__ void restart(const Out& o, size_t at) { lo = o.k[at]; }
  template <bool DEEP>
  __device__ Key key(float acc, int row, bool valid) const {
    const int k = adc::packed_key(acc, row, valid);
    return DEEP && !(k > lo) ? adc::KEY_BIG : k;
  }
  // Insert v below every larger key (the row is in the key).
  __device__ void insert(int v, int, int lane) {
    int pv[KR];
#pragma unroll
    for (int r = 0; r < KR; ++r)
      pv[r] = __shfl_sync(FULL, keys[r], (lane + 31) & 31);
#pragma unroll
    for (int r = KR - 1; r >= 0; --r) {
      const int prev = lane ? pv[r] : (r ? pv[r > 0 ? r - 1 : 0] : INT_MIN);
      if (v < prev)
        keys[r] = prev;
      else if (v < keys[r])
        keys[r] = v;
    }
  }
  __device__ Key kth(int k) const { return element<KR>(keys, k); }
  __device__ void store(const Out& o, size_t at, int r) const {
    o.k[at] = keys[r];
  }
};

// Where a warp's tables come from.  B6, B9: a query's [M*K] table row,
// staged once a query group; items query-major.
struct FullTables {
  static constexpr bool PER_TILE = false;   // tables depend on the tile
  static constexpr bool TILE_MAJOR = false;
  int row;                                  // entries of a query's row: M*K
  __device__ int col(int, int mk, int) const { return mk; }
};

// B10: the table compacted through tile t's dictionary (K = D entries a
// subspace), gathered for every (query group, tile) item; items
// tile-major.
struct DictTables {
  static constexpr bool PER_TILE = true;
  static constexpr bool TILE_MAJOR = true;
  int row;                                  // entries of a query's row: M*Kf
  const int* dict;                          // [nT, M, D] centroid ids
  int Kf, D;                                // centroids, dictionary width
  // column of compact entry md = m*D + d of tile t in a query's row
  __device__ int col(int t, int md, int MD) const {
    return md / D * Kf + __ldg(dict + (size_t)t * MD + md);
  }
};

// S: the selection (PairTopK or PackedTopK); DEEP: a later launch of a
// top_k above one launch's ranks, which keeps only the rows whose key comes
// after the last key of the launch before; Src: FullTables or DictTables.
template <int P, int GB, typename CodeT, class S, bool DEEP, class Src>
__global__ void __launch_bounds__(Warps<S::KR>::MAX * 32, 1)
adc_topk_kernel(const typename adc::Entry<P>::type* __restrict__ tab,
                                                    // [B, src.row] entries
                const CodeT* __restrict__ codes,    // [N_pad, M]
                typename S::Out out,                // each [nT, top_k, B]
                Src src, int B, int M, int K, int nT, int tile_n,
                int n_valid, int top_k, int j0, int kp, int CH, int nqg) {
  using E = typename adc::Entry<P>::type;
  using V = typename Group<P, GB>::V;
  using Key = typename S::Key;
  constexpr int QI = Group<P, GB>::QI;
  constexpr int CPW = 4 / sizeof(CodeT);             // codes a word
  extern __shared__ __align__(16) unsigned char smem[];
  const int MK = M * K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = blockDim.x >> 5, QC = W * QI;
  const int RB = M * (int)sizeof(CodeT);             // bytes of a code row
  const int WR = (RB + 3) / 4;                       // words of a code row
  const int WF = M / CPW;                            // words of CPW codes
  V* tab_s = reinterpret_cast<V*>(smem);             // [W][MK] groups
  unsigned* codes_s = reinterpret_cast<unsigned*>(
      smem + (((size_t)W * MK * GB + 15) & ~size_t(15)));
  const V* tab_w = tab_s + (size_t)warp * MK;

  const long long n_items = (long long)nqg * nT;
  const long long it0 = n_items * blockIdx.x / gridDim.x;
  const long long it1 = n_items * (blockIdx.x + 1) / gridDim.x;
  int tab_q = -1, tab_t = -1;   // the item whose tables are staged
  int chunk_t = -1;             // the tile whose codes fill the chunk whole
  for (long long item = it0; item < it1; ++item) {
    int qg, t;
    if (Src::TILE_MAJOR) {
      t = (int)(item / nqg);
      qg = (int)(item - (long long)t * nqg);
    } else {
      qg = (int)(item / nT);
      t = (int)(item - (long long)qg * nT);
    }
    const int q0 = qg * QC;
    if (qg != tab_q || (Src::PER_TILE && t != tab_t)) {
      __syncthreads();   // every warp is done with the last item's tables
      // a thread a column: consecutive threads read consecutive columns
      // of a query's row, and each thread's loads of its column for the
      // QC queries are independent (in flight together)
      E* te = reinterpret_cast<E*>(tab_s);
      const int nq = min(QC, B - q0);
      for (int mk = tid; mk < MK; mk += blockDim.x) {
        const E* col = tab + (size_t)q0 * src.row + src.col(t, mk, MK);
#pragma unroll 8
        for (int ql = 0; ql < QC; ++ql) {
          const int w = ql / QI, qi = ql - w * QI;
          te[((size_t)w * MK + mk) * QI + qi] =
              ql < nq ? col[(size_t)ql * src.row] : E(0);
        }
      }
      tab_q = qg;
      tab_t = t;
    }

    S sel[QI];
    Key tau[QI];
#pragma unroll
    for (int qi = 0; qi < QI; ++qi) {
      const int q = q0 + warp * QI + qi;
      sel[qi].init();
      tau[qi] = S::none();
      if (DEEP && q < B)
        sel[qi].restart(out, ((size_t)t * top_k + j0 - 1) * B + q);
    }

    const long long row0 = (long long)t * tile_n;
    for (int c0 = 0; c0 < tile_n && row0 + c0 < n_valid; c0 += CH) {
      const int ch = min(CH, tile_n - c0);
      __syncthreads();   // the last chunk's codes (and the tables) are read
      if (ch < tile_n || t != chunk_t) {   // else the chunk holds tile t
        const unsigned char* cs = reinterpret_cast<const unsigned char*>(
            codes + (row0 + c0) * M);
        if (RB % 4 == 0 && ch * WR % 4 == 0 && ((uintptr_t)cs & 15) == 0) {
          // [row][word] in global -> [word][row]: four words a 16-byte load
          const uint4* s4 = reinterpret_cast<const uint4*>(cs);
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
            cb[((b >> 2) * CH + r) * 4 + (b & 3)] = cs[i];
          }
        }
        // a tile_n that is no multiple of 32 leaves a warp lanes past the
        // chunk's last row: they read code 0 (their keys are masked)
        const int pad = ((ch + 31) & ~31) - ch;
        for (int i = tid; i < pad * WR; i += blockDim.x)
          codes_s[(i / pad) * CH + ch + i % pad] = 0u;
        chunk_t = ch == tile_n ? t : -1;
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
            for (int j = 0; j < CPW; ++j) add_group<P, GB>(acc, e[j]);
          }
          if (CPW == 4 && WF < WR) {               // M % 4 codes are left
            const unsigned word = codes_s[WF * CH + r];
            for (int m = 4 * WF; m < M; ++m)
              add_group<P, GB>(acc, tab_w[m * K + ((word >> (8 * (m & 3))) &
                                                   0xffu)]);
          }
#pragma unroll
          for (int qi = 0; qi < QI; ++qi) {
            const Key d = sel[qi].template key<DEEP>(acc[qi], c0 + r, r < nv);
            unsigned hit = __ballot_sync(FULL, d < tau[qi]);
            while (hit) {
              const int src_lane = __ffs(hit) - 1;
              sel[qi].insert(__shfl_sync(FULL, d, src_lane),
                             c0 + s + src_lane, lane);
              tau[qi] = sel[qi].kth(kp - 1);
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
      for (int r = 0; r < S::KR; ++r) {
        const int j = 32 * r + lane;
        if (j < kp)
          sel[qi].store(out, ((size_t)t * top_k + j0 + j) * B + q, r);
      }
    }
  }
}

// Rows of a code chunk (a multiple of 32, so that a warp's last rows stay
// inside the chunk) and the shared memory of a block of W warps.
inline int chunk_rows(int WR, int tile_n) {
  return std::min((tile_n + 31) / 32 * 32,
                  std::max(32, CODE_BYTES / (4 * WR) / 32 * 32));
}
inline size_t block_smem(int GB, int M, int K, int W, int WR, int CH) {
  return (((size_t)GB * M * K * W + 15) & ~size_t(15)) + (size_t)4 * WR * CH;
}

// Warps of GB-byte table groups a block can hold beside a code chunk (0:
// not one).
inline cudaError_t warps_that_fit(int GB, int M, int K, int code_bytes,
                                  int tile_n, long long* fit) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const int WR = (M * code_bytes + 3) / 4;
  const size_t code_smem = block_smem(GB, M, K, 0, WR,
                                      chunk_rows(WR, tile_n));
  *fit = ((long long)optin - (long long)code_smem - 16)
         / ((long long)GB * M * K);
  return cudaSuccess;
}

template <int P, int GB, typename CodeT, class S, bool DEEP, class Src>
cudaError_t launch(const void* tab, const void* codes, typename S::Out out,
                   Src src, int B, int M, int K, int n_pad, int tile_n,
                   int n_valid, int top_k, int j0, int kp, cudaStream_t st) {
  constexpr int QI = Group<P, GB>::QI;
  auto kernel = adc_topk_kernel<P, GB, CodeT, S, DEEP, Src>;
  long long fit = 0;
  cudaError_t e = warps_that_fit(GB, M, K, (int)sizeof(CodeT), tile_n, &fit);
  if (e != cudaSuccess) return e;
  if (fit < 1) return cudaErrorInvalidValue;
  const int WR = (M * (int)sizeof(CodeT) + 3) / 4;
  const int CH = chunk_rows(WR, tile_n);
  const int nqw = (B + QI - 1) / QI;                  // warps the batch fills
  int W = (int)std::min((long long)std::min(Warps<S::KR>::MAX, nqw), fit);
  const int nqg = (nqw + W - 1) / W;
  W = (nqw + nqg - 1) / nqg;          // the same groups, as even as they go
  const size_t smem = block_smem(GB, M, K, W, WR, CH);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  const int nT = n_pad / tile_n;
  int grid = 0;
  if (e == cudaSuccess)
    e = mma::resident_grid(kernel, 32 * W, smem, (long long)nqg * nT, &grid);
  if (e != cudaSuccess) return e;
  kernel<<<grid, 32 * W, smem, st>>>(
      static_cast<const typename adc::Entry<P>::type*>(tab),
      static_cast<const CodeT*>(codes), out, src, B, M, K, nT, tile_n,
      n_valid, top_k, j0, kp, CH, nqg);
  return cudaGetLastError();
}

// Launches of at most 256 ranks; after the first, each keeps the rows whose
// key comes after the last key of the one before (DEEP).  K: the entries of
// a subspace in a warp's tables.
template <int P, int GB, typename CodeT, template <int> class S, class Src>
cudaError_t launch_k(const void* tab, const void* codes,
                     typename S<1>::Out out, Src src, int B, int M, int K,
                     int n_pad, int tile_n, int n_valid, int top_k,
                     cudaStream_t st) {
#define ADC_TOPK_LAUNCH(KR, DEEP, J0, KP)                                   \
  launch<P, GB, CodeT, S<KR>, DEEP>(tab, codes, out, src, B, M, K, n_pad,   \
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

template <int P, int GB, template <int> class S>
cudaError_t launch_codes(int code_bytes, const void* tab, const void* codes,
                         typename S<1>::Out out, int B, int M, int K,
                         int n_pad, int tile_n, int n_valid, int top_k,
                         cudaStream_t st) {
  const FullTables src{M * K};
  if (code_bytes == 1)
    return launch_k<P, GB, uint8_t, S>(tab, codes, out, src, B, M, K, n_pad,
                                       tile_n, n_valid, top_k, st);
  if (code_bytes == 4)
    return launch_k<P, GB, int32_t, S>(tab, codes, out, src, B, M, K, n_pad,
                                       tile_n, n_valid, top_k, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// B6.  prec 0 (tab f32 [B, M*K]), 1 (bf16 [B, M*K]) or 2 (bf16 [B, M*K,
// 2]: hi, lo); code_bytes 1 (u8 codes) or 4 (int32 codes, K > 256); tile_n
// a multiple of 32 dividing n_pad; one warp's tables, 4*M*K bytes, must fit
// the block's shared memory beside a code chunk (checked by the Python
// wrapper).  Returns cudaGetLastError() after the launch (or the error of a
// request the card refuses).
extern "C" int adc_topk_launch(const void* tab, const void* codes,
                               void* out_d, void* out_i, int B, int M, int K,
                               int n_pad, int tile_n, int n_valid, int top_k,
                               int code_bytes, int prec, void* stream) {
  if (n_pad == 0 || B == 0 || top_k == 0) return (int)cudaSuccess;
  if (tile_n % 32 || n_pad % tile_n) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const PairOut out{static_cast<float*>(out_d), static_cast<int*>(out_i)};
#define B6_LAUNCH(P)                                                        \
  (int)launch_codes<P, GROUP_BYTES, PairTopK>(code_bytes, tab, codes, out,  \
                                              B, M, K, n_pad, tile_n,       \
                                              n_valid, top_k, st)
  switch (prec) {
    case adc::F32: return B6_LAUNCH(adc::F32);
    case adc::BF16: return B6_LAUNCH(adc::BF16);
    case adc::BF16X2: return B6_LAUNCH(adc::BF16X2);
  }
#undef B6_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// B9.  tab, codes and prec as adc_topk_launch; tile_n <= 4096 dividing
// n_pad (any tile_n: the chunks round up to whole warps of rows); one
// warp's tables must fit beside a code chunk: 4*M*K bytes, or at bf16
// 2*M*K (a warp then owns one query).  Returns cudaGetLastError() after the
// launch (or the error of a request the card refuses).
extern "C" int adc_topk_packed_launch(const void* tab, const void* codes,
                                      void* out, int B, int M, int K,
                                      int n_pad, int tile_n, int n_valid,
                                      int top_k, int code_bytes, int prec,
                                      void* stream) {
  if (n_pad == 0 || B == 0 || top_k == 0) return (int)cudaSuccess;
  if (tile_n > adc::MAX_TILE || n_pad % tile_n)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const PackedOut o{static_cast<int*>(out)};
#define B9_LAUNCH(P, GB)                                                    \
  (int)launch_codes<P, GB, PackedTopK>(code_bytes, tab, codes, o, B, M, K,  \
                                       n_pad, tile_n, n_valid, top_k, st)
  switch (prec) {
    case adc::F32: return B9_LAUNCH(adc::F32, GROUP_BYTES);
    case adc::BF16: {
      long long fit = 0;
      cudaError_t e = warps_that_fit(GROUP_BYTES, M, K, code_bytes, tile_n,
                                     &fit);
      if (e != cudaSuccess) return (int)e;
      return fit >= 1 ? B9_LAUNCH(adc::BF16, GROUP_BYTES)
                      : B9_LAUNCH(adc::BF16, 2);
    }
    case adc::BF16X2: return B9_LAUNCH(adc::BF16X2, GROUP_BYTES);
  }
#undef B9_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// B10.  tab f32 [B, M*K]; idx u8 [n_pad, M] positions in the tile's
// dictionary; dict i32 [n_pad / tile_n, M, D] centroid ids, D <= 256;
// tile_n <= 4096 dividing n_pad; one warp's compact tables, 4*M*D bytes,
// must fit beside a code chunk.  The table groups are the widest (16, 8
// or 4 bytes: four, two or one query a warp) with which a block still
// holds as many warps as at 4 bytes.  Returns cudaGetLastError() after
// the launch (or the error of a request the card refuses).
extern "C" int adc_topk_tiledict_launch(const void* tab, const void* idx,
                                        const void* dict, void* out, int B,
                                        int M, int K, int D, int n_pad,
                                        int tile_n, int n_valid, int top_k,
                                        void* stream) {
  if (n_pad == 0 || B == 0 || top_k == 0) return (int)cudaSuccess;
  if (tile_n > adc::MAX_TILE || n_pad % tile_n || D > 256)
    return (int)cudaErrorInvalidValue;
  long long f4 = 0, f8 = 0, f16 = 0;
  cudaError_t e = warps_that_fit(4, M, D, 1, tile_n, &f4);
  if (e == cudaSuccess) e = warps_that_fit(8, M, D, 1, tile_n, &f8);
  if (e == cudaSuccess) e = warps_that_fit(16, M, D, 1, tile_n, &f16);
  if (e != cudaSuccess) return (int)e;
  const long long want = std::min<long long>(Warps<1>::MAX, f4);
  const int gb = f16 >= want ? 16 : f8 >= want ? 8 : 4;
  const DictTables src{M * K, static_cast<const int*>(dict), K, D};
  const PackedOut o{static_cast<int*>(out)};
  auto st = static_cast<cudaStream_t>(stream);
#define B10_LAUNCH(GB)                                                      \
  (int)launch_k<adc::F32, GB, uint8_t, PackedTopK>(                         \
      tab, idx, o, src, B, M, D, n_pad, tile_n, n_valid, top_k, st)
  return gb == 16 ? B10_LAUNCH(16) : gb == 8 ? B10_LAUNCH(8) : B10_LAUNCH(4);
#undef B10_LAUNCH
}
