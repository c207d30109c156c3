// ADC distances per tile + tile-local top-k on packed int32 keys.
//
// Replaces the TPU kernel
// deltapq_tpu/ops/adc_pallas.py:_adc_topk_packed_kernel (with
// _accumulate_onehot) in its three precisions, reached from
// adc_topk_packed.  Python wrapper, plain PyTorch version and the
// cross-tile merge: deltapq_tpu_torch/ops/adc_kernels.py.
//
// What it computes, per tile t of tile_n <= 4096 rows and query b: the
// distances of adc_topk.cu for the given precision, each turned into the
// key of adc_lookup.cuh:packed_key (order-preserving distance bits, the
// low 12 bits the tile-local row, 0x7fffffff past n_valid), then top_k
// sweeps last = min(key where key > last) from INT_MIN, written to
// out[t, j, b].  Bit-equal to the plain version.
//
// What bounds it on an H100: N*B*M shared-memory lookups; the selection
// is top_k sweeps over 16 registers a thread with one barrier each.
//
// Design: keys within a tile are unique, so the TPU kernel's sweeps carry
// no mask state; here each thread keeps the keys of its 16 strided rows
// in registers, and nothing but the QC queries' table rows lies in shared
// memory.

#include "adc_lookup.cuh"

namespace {

using adc::THREADS;
using adc::WARPS;

template <int P, typename CodeT>
__global__ void __launch_bounds__(THREADS)
adc_topk_packed_kernel(const typename adc::Entry<P>::type* __restrict__ tab,
                                                    // [B, M*K] entries
                       const CodeT* __restrict__ codes,   // [N_pad, M]
                       int* __restrict__ out,             // [nT, top_k, B]
                       int B, int M, int K, int tile_n, int n_valid,
                       int top_k, int QC) {
  using E = typename adc::Entry<P>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  E* tab_s = reinterpret_cast<E*>(smem);            // [QC, MK]
  __shared__ int red[2][WARPS];
  const int MK = M * K;
  const int t = blockIdx.x;
  const int q0 = blockIdx.y * QC;
  const int nq = min(QC, B - q0);
  adc::stage(tab_s, tab + (size_t)q0 * MK, nq * MK);
  __syncthreads();
  const long long row0 = (long long)t * tile_n;
  for (int j = 0; j < nq; ++j)
    adc::packed_tile_topk<P, CodeT>(
        tab_s + (size_t)j * MK, codes, row0, tile_n, n_valid, M, K, top_k,
        out + (size_t)t * top_k * B + q0 + j, (size_t)B, red);
}

template <int P, typename CodeT>
cudaError_t launch(const void* tab, const void* codes, int* out, int B,
                   int M, int K, int n_pad, int tile_n, int n_valid,
                   int top_k, int QC, cudaStream_t st) {
  const size_t smem = adc::entry_bytes(P) * (size_t)QC * M * K;
  cudaError_t e = cudaFuncSetAttribute(
      adc_topk_packed_kernel<P, CodeT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(n_pad / tile_n, (B + QC - 1) / QC);
  adc_topk_packed_kernel<P, CodeT><<<grid, THREADS, smem, st>>>(
      static_cast<const typename adc::Entry<P>::type*>(tab),
      static_cast<const CodeT*>(codes), out, B, M, K, tile_n, n_valid,
      top_k, QC);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_codes(int code_bytes, const void* tab, const void* codes,
                         int* out, int B, int M, int K, int n_pad,
                         int tile_n, int n_valid, int top_k, int QC,
                         cudaStream_t st) {
  if (code_bytes == 1)
    return launch<P, uint8_t>(tab, codes, out, B, M, K, n_pad, tile_n,
                              n_valid, top_k, QC, st);
  if (code_bytes == 4)
    return launch<P, int32_t>(tab, codes, out, B, M, K, n_pad, tile_n,
                              n_valid, top_k, QC, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// prec 0 (tab f32 [B, M*K]), 1 (bf16 [B, M*K]) or 2 (bf16 [B, M*K, 2]: hi,
// lo); code_bytes 1 (u8 codes) or 4 (int32 codes, K > 256); tile_n <= 4096
// dividing n_pad; QC queries per block, sized by the Python wrapper so
// that QC*M*K entries fit in shared memory.  Returns cudaGetLastError()
// after the launch.
extern "C" int adc_topk_packed_launch(const void* tab, const void* codes,
                                      void* out, int B, int M, int K,
                                      int n_pad, int tile_n, int n_valid,
                                      int top_k, int QC, int code_bytes,
                                      int prec, void* stream) {
  if (n_pad == 0 || B == 0 || top_k == 0) return (int)cudaSuccess;
  if (tile_n > adc::MAX_TILE) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* op = static_cast<int*>(out);
  switch (prec) {
    case adc::F32:
      return (int)launch_codes<adc::F32>(code_bytes, tab, codes, op, B, M, K,
                                         n_pad, tile_n, n_valid, top_k, QC,
                                         st);
    case adc::BF16:
      return (int)launch_codes<adc::BF16>(code_bytes, tab, codes, op, B, M,
                                          K, n_pad, tile_n, n_valid, top_k,
                                          QC, st);
    case adc::BF16X2:
      return (int)launch_codes<adc::BF16X2>(code_bytes, tab, codes, op, B, M,
                                            K, n_pad, tile_n, n_valid, top_k,
                                            QC, st);
  }
  return (int)cudaErrorInvalidValue;
}
