// Tile-dictionary ADC scan + tile-local top-k on packed int32 keys.
//
// Replaces the TPU kernel
// deltapq_tpu/ops/adc_pallas.py:_adc_topk_tiledict_kernel, reached from
// adc_topk_tiledict and TileDictEngine.  Python wrapper, plain PyTorch
// version, the host-side dictionary build and the cross-tile merge:
// deltapq_tpu_torch/ops/adc_kernels.py.
//
// What it computes, per tile t of tile_n <= 4096 rows and query b:
//   stage A  t_m[d] = tab[b, m*K + dict[t, m, d]]: the table compacted
//            through the tile's dictionary (the TPU kernel's [D, K] one-hot
//            matmul is this gather);
//   stage B  dist[r] = sum_m t_m[idx[t*tile_n + r, m]], ascending m from
//            0.0f with __fadd_rn: the same f32 values in the same order as
//            the plain kernel reads through the codes, so the keys equal
//            adc_topk_packed.cu's "f32" keys on the same rows;
//   then the packed key and the top_k sweeps of adc_lookup.cuh.
//
// What bounds it on an H100: N*B*M shared-memory lookups, as the packed
// kernel; the compact table of a query is M*D*4 bytes against M*K*4, so a
// block holds K/D times the queries in the same shared memory (or the
// same queries in a fraction of it, and more blocks share an SM): that is
// what the format buys on this card.
//
// Design: a block gathers the compact tables of its QC queries from the
// f32 table in device memory (4 MB at B=512: it stays in the L2 cache),
// once per (tile, query block); the scan then is adc_topk_packed.cu's with
// K = D and the u8 indexes in place of the codes.

#include "adc_lookup.cuh"

namespace {

using adc::THREADS;
using adc::WARPS;

__global__ void __launch_bounds__(THREADS)
adc_topk_tiledict_kernel(const float* __restrict__ tab,     // [B, M*K]
                         const uint8_t* __restrict__ idx,   // [N_pad, M]
                         const int* __restrict__ dict,      // [nT, M, D]
                         int* __restrict__ out,             // [nT, top_k, B]
                         int B, int M, int K, int D, int tile_n, int n_valid,
                         int top_k, int QC) {
  extern __shared__ __align__(16) float tab_s[];    // [QC, M*D]
  __shared__ int red[2][WARPS];
  const int MK = M * K, MD = M * D;
  const int t = blockIdx.x;
  const int q0 = blockIdx.y * QC;
  const int nq = min(QC, B - q0);
  const int* dt = dict + (size_t)t * MD;
  for (int i = threadIdx.x; i < nq * MD; i += THREADS) {
    const int j = i / MD, md = i - j * MD;
    tab_s[i] = tab[(size_t)(q0 + j) * MK + (md / D) * K + dt[md]];
  }
  __syncthreads();
  const long long row0 = (long long)t * tile_n;
  for (int j = 0; j < nq; ++j)
    adc::packed_tile_topk<adc::F32, uint8_t>(
        tab_s + (size_t)j * MD, idx, row0, tile_n, n_valid, M, D, top_k,
        out + (size_t)t * top_k * B + q0 + j, (size_t)B, red);
}

}  // namespace

// idx u8 [n_pad, M] positions in the tile's dictionary; dict i32
// [n_pad / tile_n, M, D] centroid ids, D <= 256; tile_n <= 4096 dividing
// n_pad; QC queries per block, sized by the Python wrapper so that
// 4*QC*M*D bytes fit in shared memory.  Returns cudaGetLastError() after
// the launch.
extern "C" int adc_topk_tiledict_launch(const void* tab, const void* idx,
                                        const void* dict, void* out, int B,
                                        int M, int K, int D, int n_pad,
                                        int tile_n, int n_valid, int top_k,
                                        int QC, void* stream) {
  if (n_pad == 0 || B == 0 || top_k == 0) return (int)cudaSuccess;
  if (tile_n > adc::MAX_TILE || D > 256) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)QC * M * D;
  cudaError_t e = cudaFuncSetAttribute(
      adc_topk_tiledict_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_pad / tile_n, (B + QC - 1) / QC);
  adc_topk_tiledict_kernel<<<grid, THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tab), static_cast<const uint8_t*>(idx),
      static_cast<const int*>(dict), static_cast<int*>(out), B, M, K, D,
      tile_n, n_valid, top_k, QC);
  return (int)cudaGetLastError();
}
