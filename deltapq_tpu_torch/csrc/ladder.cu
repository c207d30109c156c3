// The selection ladder on the card: per query, exact unit selection,
// exact rerank, the certificate and the escalation, in one launch a batch.
//
// Replaces no TPU kernel one for one.  The JAX package runs the ladder as
// select_rerank (deltapq_tpu/ops/fused_pallas.py; its rerank is the kernel
// _rerank_kernel) inside fused_select_esc's batch-wide lax.cond rungs
// (deltapq_tpu/ops/fused.py); on this card that chain was about 25 small
// aten ops a rung and one host read of ok.all() between rungs, so the
// failing 1-5% of a batch made every query rerun.  This kernel is B2's
// main-path form: csrc/rerank.cu stays the kernel of the batch ladder.
// Python wrapper and plain PyTorch version (fused_ladder,
// fused_ladder_ref): deltapq_tpu_torch/ops/fused_kernels.py.
//
// ladder_mins_kernel first lays the scan's minima out a query a row,
// pooled, scale2 folded in.  Then ladder_kernel, one block a query, takes
// its pooled unit minima x[0, nu) and
//  1. selects: the `need` smallest units by (minimum, unit), ascending,
//     exactly -- the key range, a 1024-bin histogram pass narrowed until
//     the need-th key's bin fits the buffer, one gather pass and a bitonic
//     sort in shared memory.  One selection of (largest rung <= 8 * first
//     rung) + 1 units serves those rungs as prefixes; a later rung (the
//     cap) selects again.  The fence of a rung of ns units is the
//     (ns+1)-th smallest minimum, so every unselected unit's minimum is
//     at least the fence;
//  2. reranks exactly: T[b, m, code] added in ascending m from 0.0f with
//     __fadd_rn (bit-equal to the plain scan), the query's table in shared
//     memory, the rows of the rung's new units only, into a running
//     top-k (a sorted list plus a candidate buffer, merged by a bitonic
//     sort when it fills; a candidate enters only below the k-th key);
//  3. certifies with select_rerank's formulas, each operation rounded as
//     torch rounds it (no contraction into FMAs):
//       bf16:        (d_k - q2) <= fence - 0.02 (|fence| + q2 + 1)
//       int8/int16:  d_k <= max(sqrt(max(fence + q2, 0)) - err_r, 0)^2
//  4. escalates only this query while its certificate fails;
//  5. writes d, ids (through row_to_db where given; -1 at +inf) and a
//     status byte: the rung (0-based) that certified, or 255.
//
// What bounds them on an H100: ladder_mins_kernel, memory (the minima read
// and written once: 128 MB at SIFT1M's B=512, 0.038 ms at 3.35 TB/s; a
// plain transposing copy took 0.136 ms).  ladder_kernel: the minima, read
// three times a selection (range, histogram, gather; 125 KB a query at
// SIFT1M, mostly from L2 on the 2nd and 3rd pass), and the shared-memory
// syncs of the sorts.  The rerank reads M bytes a candidate row, unit-row
// slices of the echo, so a warp reads one contiguous unit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SELBUF = 4096;    // (key, unit) pairs one selection holds
constexpr int TKBUF = 1024;     // running top-k + its candidate buffer
constexpr int NBINS = 1024;     // histogram bins of a selection pass
constexpr int LOG_NBINS = 10;
constexpr int PER = NBINS / THREADS;
constexpr int MAX_TOP_K = 128;
constexpr int MAX_MK = 16 * 256;
constexpr int MAX_RUNGS = 4;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned long long EMPTY = ~0ull;
constexpr unsigned char FAILED = 255;

constexpr size_t SMEM_MAX = sizeof(unsigned long long) * (SELBUF + TKBUF)
                            + sizeof(uint32_t) * NBINS
                            + sizeof(float) * MAX_MK;

// Order-preserving map of a float to u32 (-0.0 as +0.0, as a float compare
// sees them); key_value inverts it.
__device__ __forceinline__ uint32_t order_key(float v) {
  if (v == 0.0f) v = 0.0f;
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__device__ __forceinline__ unsigned long long pack(uint32_t key,
                                                   uint32_t idx) {
  return ((unsigned long long)key << 32) | idx;
}

__device__ __forceinline__ int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Ascending bitonic sort of s[0, p), p a power of two, by the block.  The
// caller has synchronised after writing s; returns synchronised.
__device__ void block_sort(unsigned long long* s, int p) {
  for (int k = 2; k <= p; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < (p >> 1); i += THREADS) {
        const int a = 2 * i - (i & (j - 1));
        const int c = a + j;
        const unsigned long long x = s[a], y = s[c];
        if ((x > y) == ((a & k) == 0)) {
          s[a] = y;
          s[c] = x;
        }
      }
      __syncthreads();
    }
}

// The `need` smallest entries of x[0, nu) by (order_key, index), ascending,
// into sel[0, need) as pack(key, index).  need <= min(nu, SELBUF).
__device__ void select_units(const float* __restrict__ x, int nu, int need,
                             unsigned long long* sel, uint32_t* hist) {
  __shared__ uint32_t w_lo[WARPS], w_hi[WARPS];
  __shared__ int w_a[WARPS], w_b[WARPS];
  __shared__ int s_bin, s_below, s_count, s_n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the key range
  uint32_t lo = 0xFFFFFFFFu, hi = 0u;
  for (int i = tid; i < nu; i += THREADS) {
    const uint32_t k = order_key(x[i]);
    lo = min(lo, k);
    hi = max(hi, k);
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(FULL, lo, o));
    hi = max(hi, __shfl_xor_sync(FULL, hi, o));
  }
  if (lane == 0) {
    w_lo[warp] = lo;
    w_hi[warp] = hi;
  }
  __syncthreads();
  for (int w = 0; w < WARPS; ++w) {
    lo = min(lo, w_lo[w]);
    hi = max(hi, w_hi[w]);
  }

  // narrow [lo, hi] to a bin that holds the need-th key; below counts the
  // keys under lo, in_bin those in [lo, hi]
  int below = 0, in_bin = nu;
  while (below + in_bin > SELBUF && lo < hi) {
    const uint32_t span = hi - lo;
    const int shift = span < (uint32_t)NBINS ? 0
                      : (32 - __clz(span)) - LOG_NBINS;
    for (int i = tid; i < NBINS; i += THREADS) hist[i] = 0u;
    __syncthreads();
    for (int i = tid; i < nu; i += THREADS) {
      const uint32_t k = order_key(x[i]);
      if (k >= lo && k <= hi) atomicAdd(&hist[(k - lo) >> shift], 1u);
    }
    __syncthreads();
    int local = 0;
    for (int q = 0; q < PER; ++q) local += (int)hist[tid * PER + q];
    int incl = local;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) w_a[warp] = incl;
    __syncthreads();
    int excl = incl - local;
    for (int w = 0; w < warp; ++w) excl += w_a[w];
    const int want = need - below;            // 1-based rank in [lo, hi]
    if (excl < want && want <= excl + local) {
      int c = excl;
      for (int q = 0; q < PER; ++q) {
        const int h = (int)hist[tid * PER + q];
        if (c + h >= want) {
          s_bin = tid * PER + q;
          s_below = c;
          s_count = h;
          break;
        }
        c += h;
      }
    }
    __syncthreads();
    const uint32_t nlo = lo + ((uint32_t)s_bin << shift);
    const unsigned long long top =
        (unsigned long long)nlo + ((1ull << shift) - 1ull);
    hi = (uint32_t)min((unsigned long long)hi, top);
    lo = nlo;
    below += s_below;
    in_bin = s_count;
    __syncthreads();                          // s_* read by every thread
  }

  int n;
  if (below + in_bin <= SELBUF) {
    // every key <= hi, in any order: the sort orders them
    if (tid == 0) s_n = 0;
    __syncthreads();
    for (int i = tid; i < nu; i += THREADS) {
      const uint32_t k = order_key(x[i]);
      if (k <= hi) sel[atomicAdd(&s_n, 1)] = pack(k, (uint32_t)i);
    }
    n = below + in_bin;
  } else {
    // the bin is one key value tied more than the buffer holds: every key
    // under it, and of the ties the lowest indices, in index order
    const int take = need - below;
    int run_a = 0, run_b = 0;
    for (int base = 0; base < nu; base += THREADS) {
      const int i = base + tid;
      const uint32_t k = i < nu ? order_key(x[i]) : 0xFFFFFFFFu;
      const bool fa = i < nu && k < lo, fb = i < nu && k == lo;
      const unsigned ba = __ballot_sync(FULL, fa);
      const unsigned bb = __ballot_sync(FULL, fb);
      if (lane == 0) {
        w_a[warp] = __popc(ba);
        w_b[warp] = __popc(bb);
      }
      __syncthreads();
      int oa = 0, ob = 0, ta = 0, tb = 0;
      for (int w = 0; w < WARPS; ++w) {
        if (w < warp) {
          oa += w_a[w];
          ob += w_b[w];
        }
        ta += w_a[w];
        tb += w_b[w];
      }
      const unsigned lt = (1u << lane) - 1u;
      if (fa) sel[run_a + oa + __popc(ba & lt)] = pack(k, (uint32_t)i);
      if (fb) {
        const int q = run_b + ob + __popc(bb & lt);
        if (q < take) sel[below + q] = pack(k, (uint32_t)i);
      }
      run_a += ta;
      run_b += tb;
      __syncthreads();
    }
    n = need;
  }
  const int p = next_pow2(n);
  for (int i = n + tid; i < p; i += THREADS) sel[i] = EMPTY;
  __syncthreads();
  block_sort(sel, p);
}

// Merge the candidate buffer tk[kp, kp + cnt) into the sorted top-kp
// list tk[0, kp) and zero the buffer's count *s_cnt; returns the key of the
// new k-th entry.  Called by every thread after a sync; returns
// synchronised.
__device__ uint32_t merge_topk(unsigned long long* tk, int kp, int top_k,
                               int cnt, int* s_cnt) {
  const int n = kp + cnt;
  const int p = next_pow2(n);
  for (int i = n + threadIdx.x; i < p; i += THREADS) tk[i] = EMPTY;
  __syncthreads();
  block_sort(tk, p);
  const uint32_t thr = (uint32_t)(tk[top_k - 1] >> 32);
  __syncthreads();
  if (threadIdx.x == 0) *s_cnt = 0;
  __syncthreads();
  return thr;
}

// select_rerank's certificate, each operation rounded as torch rounds it.
__device__ __forceinline__ bool certified(float dk, float fence, float q2,
                                          const float* err_r, int b) {
  if (err_r != nullptr) {
    float ft = __fadd_rn(fence, q2);
    ft = ft < 0.0f ? 0.0f : ft;               // clamp_min keeps a NaN
    float root = __fsub_rn(__fsqrt_rn(ft), err_r[b]);
    root = root < 0.0f ? 0.0f : root;
    return dk <= __fmul_rn(root, root);
  }
  const float margin =
      __fmul_rn(0.02f, __fadd_rn(__fadd_rn(fabsf(fence), q2), 1.0f));
  return __fsub_rn(dk, q2) <= __fsub_rn(fence, margin);
}

__global__ void __launch_bounds__(THREADS)
ladder_kernel(const float* __restrict__ mins,       // [B, nu]
              const float* __restrict__ q2,         // [B]
              const float* __restrict__ err_r,      // [B] or null
              const float* __restrict__ tab,        // [B, M*K]
              const uint8_t* __restrict__ codes,    // [rows, M]
              const int32_t* __restrict__ row_to_db,  // [n_valid] or null
              float* __restrict__ out_d,            // [B, top_k]
              long long* __restrict__ out_id,       // [B, top_k]
              uint8_t* __restrict__ status,         // [B]
              int nu, int M, int K, int unit, int n_valid, int top_k,
              int kp, int n_rungs, int4 rung4) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* sel = smem;                       // SELBUF
  unsigned long long* tk = sel + SELBUF;                // TKBUF
  uint32_t* hist = reinterpret_cast<uint32_t*>(tk + TKBUF);  // NBINS
  float* tab_s = reinterpret_cast<float*>(hist + NBINS);     // M*K
  __shared__ int s_cnt, s_ok;

  const int b = blockIdx.x, tid = threadIdx.x;
  const int MK = M * K;
  for (int i = tid; i < MK; i += THREADS) tab_s[i] = tab[(size_t)b * MK + i];
  for (int i = tid; i < kp; i += THREADS) tk[i] = EMPTY;
  if (tid == 0) s_cnt = 0;
  __syncthreads();

  const int rung[MAX_RUNGS] = {rung4.x, rung4.y, rung4.z, rung4.w};
  int first = rung[0];
  for (int j = 1; j < n_rungs; ++j)
    if (rung[j] <= 8 * rung[0]) first = rung[j];
  const int ushift = __ffs(unit) - 1;                  // unit = 2^ushift
  const int cap = TKBUF - kp;
  const float* x = mins + (size_t)b * nu;
  const bool words = (M & 3) == 0;

  int have = 0, done = 0;
  uint32_t thr = 0xFFFFFFFFu;
  for (int j = 0; j < n_rungs; ++j) {
    const int ns = rung[j];
    if (ns + 1 > have) {
      have = (have == 0 ? first : rung[n_rungs - 1]) + 1;
      select_units(x, nu, have, sel, hist);
    }
    const int n_cand = (ns - done) << ushift;
    for (int c0 = 0; c0 < n_cand; c0 += THREADS) {
      const int c = c0 + tid;
      if (c < n_cand) {
        const uint32_t u = (uint32_t)sel[done + (c >> ushift)];
        const int row = (int)(u << ushift) + (c & (unit - 1));
        if (row < n_valid) {
          const uint8_t* cr = codes + (size_t)row * M;
          float acc = 0.0f;
          if (words) {
            const uint32_t* cw = reinterpret_cast<const uint32_t*>(cr);
            for (int q = 0; q < (M >> 2); ++q) {
              const uint32_t w = cw[q];
              for (int t = 0; t < 4; ++t)
                acc = __fadd_rn(acc, tab_s[(4 * q + t) * K
                                           + ((w >> (8 * t)) & 0xFFu)]);
            }
          } else {
            for (int m = 0; m < M; ++m)
              acc = __fadd_rn(acc, tab_s[m * K + cr[m]]);
          }
          const uint32_t k = order_key(acc);
          if (k < thr) tk[kp + atomicAdd(&s_cnt, 1)] = pack(k, (uint32_t)row);
        }
      }
      __syncthreads();
      const int cnt = s_cnt;
      __syncthreads();                        // read by all before new adds
      if (cnt > cap - THREADS) thr = merge_topk(tk, kp, top_k, cnt, &s_cnt);
    }
    const int cnt = s_cnt;
    if (cnt > 0) thr = merge_topk(tk, kp, top_k, cnt, &s_cnt);
    done = ns;

    if (tid == 0) {
      const int k_eff = min(top_k, ns << ushift);
      const unsigned long long e = tk[k_eff - 1];
      const float dk = e == EMPTY ? INFINITY : key_value((uint32_t)(e >> 32));
      const float fence = key_value((uint32_t)(sel[ns] >> 32));
      s_ok = certified(dk, fence, q2[b], err_r, b);
    }
    __syncthreads();
    const bool ok = s_ok;
    if (ok || j == n_rungs - 1) {
      for (int s = tid; s < top_k; s += THREADS) {
        const unsigned long long e = tk[s];
        float d = INFINITY;
        long long id = -1;
        if (e != EMPTY) {
          d = key_value((uint32_t)(e >> 32));
          const int row = (int)(uint32_t)e;
          id = row_to_db != nullptr ? (long long)row_to_db[row] : row;
        }
        out_d[(size_t)b * top_k + s] = d;
        out_id[(size_t)b * top_k + s] = id;
      }
      if (tid == 0) status[b] = ok ? (uint8_t)j : FAILED;
      return;
    }
  }
}

// The ladder's minima: pooled [B, NS] minima [B, nu] from the scan's [NS, B]
// (the min of `pool` consecutive subtiles, +inf past NS), times scale2 where
// given (one rounding, as torch multiplies): a 32 x 32 tile transposed
// through shared memory, so reads and writes are both whole lines.
__global__ void __launch_bounds__(256)
ladder_mins_kernel(const float* __restrict__ mins,    // [ns, B]
                   const float* __restrict__ scale2,  // [] or null
                   float* __restrict__ out,           // [B, nu]
                   int ns, int B, int nu, int pool) {
  __shared__ float tile[32][33];
  const int u0 = blockIdx.x * 32, b0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int j = ty; j < 32; j += 8) {
    const int u = u0 + j, b = b0 + tx;
    float v = INFINITY;
    if (u < nu && b < B) {
      for (int t = 0; t < pool; ++t) {
        const long long r = (long long)u * pool + t;
        if (r < ns) v = fminf(v, mins[r * B + b]);
      }
      if (scale2 != nullptr) v = __fmul_rn(v, *scale2);
    }
    tile[j][tx] = v;
  }
  __syncthreads();
  for (int j = ty; j < 32; j += 8) {
    const int b = b0 + j, u = u0 + tx;
    if (b < B && u < nu) out[(size_t)b * nu + u] = tile[tx][j];
  }
}

}  // namespace

// nu = ceil(ns / pool).  Returns cudaGetLastError() after the launch.
extern "C" int ladder_mins_launch(const void* mins, const void* scale2,
                                  void* out, int ns, int B, int pool,
                                  void* stream) {
  if (ns == 0 || B == 0) return (int)cudaSuccess;
  if (pool < 1) return (int)cudaErrorInvalidValue;
  const int nu = (ns + pool - 1) / pool;
  dim3 grid((nu + 31) / 32, (B + 31) / 32);
  ladder_mins_kernel<<<grid, dim3(32, 8), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mins), static_cast<const float*>(scale2),
      static_cast<float*>(out), ns, B, nu, pool);
  return (int)cudaGetLastError();
}

// rungs r0..r{n_rungs-1} ascending (unit counts), the rest ignored;
// unit a power of two; top_k <= 128, M*K <= 4096, last rung + 1 <=
// min(nu, 4096).  Returns cudaGetLastError() after the launch.
extern "C" int ladder_launch(const void* mins, const void* q2,
                             const void* err_r, const void* tab,
                             const void* codes, const void* row_to_db,
                             void* out_d, void* out_id, void* status, int B,
                             int nu, int M, int K, int unit, int n_valid,
                             int top_k, int r0, int r1, int r2, int r3,
                             int n_rungs, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  const int r[MAX_RUNGS] = {r0, r1, r2, r3};
  if (n_rungs < 1 || n_rungs > MAX_RUNGS || top_k < 1
      || top_k > MAX_TOP_K || M < 1 || K < 1 || M * K > MAX_MK || unit < 1
      || (unit & (unit - 1)) != 0 || r[0] < 1
      || r[n_rungs - 1] + 1 > nu || r[n_rungs - 1] + 1 > SELBUF)
    return (int)cudaErrorInvalidValue;
  for (int j = 1; j < n_rungs; ++j)
    if (r[j] <= r[j - 1]) return (int)cudaErrorInvalidValue;
  int kp = 1;
  while (kp < top_k) kp <<= 1;
  const size_t smem = sizeof(unsigned long long) * (SELBUF + TKBUF)
                      + sizeof(uint32_t) * NBINS + sizeof(float) * M * K;
  const cudaError_t e = cudaFuncSetAttribute(
      ladder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_MAX);
  if (e != cudaSuccess) return (int)e;
  ladder_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mins), static_cast<const float*>(q2),
      static_cast<const float*>(err_r), static_cast<const float*>(tab),
      static_cast<const uint8_t*>(codes),
      static_cast<const int32_t*>(row_to_db), static_cast<float*>(out_d),
      static_cast<long long*>(out_id), static_cast<uint8_t*>(status), nu, M,
      K, unit, n_valid, top_k, kp, n_rungs, make_int4(r0, r1, r2, r3));
  return (int)cudaGetLastError();
}
