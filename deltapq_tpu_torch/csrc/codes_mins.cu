// Codes-tier scan: resident u8 codes -> x^ -> subtile minima.
//
// Replaces the TPU kernel deltapq_tpu/ops/fused_pallas.py:
// _codes_mins_kernel (the int16, int8 and bf16 branches of _scan_tail on
// resident codes), reached from fused_codes_mins via _mins_call.  Python
// wrapper and plain PyTorch version: deltapq_tpu_torch/ops/fused_kernels.py.
//
// What it computes, per 1024-row tile t and query b: the row's M code
// bytes are read from codes [N_pad, M] into shared memory, then the
// shared tail (scan_tail.cuh) gives d = pre - 2 cross (+inf at rows >=
// n_valid) and the 32-row subtile minima mins[t*32 + s, b].  The TPU
// kernel also echoes its input codes; the wrapper returns the resident
// codes tensor itself as that echo, so nothing is copied.
//
// What bounds it on an H100: the dot products, as in the stream kernel
// (stream_mins.cu); the codes are M bytes a row, 8 MB at N=1M, M=8 and
// 16 MB at M=16.
//
// Design: the TPU decodes codes -> x^ with a one-hot matmul against the
// block-diagonal codebook; here each lane gathers its row's codeword
// words from the codebook: from shared memory at M <= 8 and D <= 128,
// from global memory (L2-resident) chunk by chunk in the wide tails of
// scan_tail.cuh (M <= 16, the GIST shape D=960).

#include "scan_tail.cuh"

namespace {

using namespace scan_tail;

template <class Tail>
__global__ void __launch_bounds__(THREADS, 2)
codes_mins_kernel(const void* __restrict__ q, const void* __restrict__ cw,
                  const void* __restrict__ nrm,
                  const uint8_t* __restrict__ codes,   // [nT*TILE, M]
                  const float* __restrict__ u,         // [B] or null
                  float* __restrict__ mins,            // [nT*32, B]
                  int B, int Dg, int n_valid, int M, int K, int Ds) {
  constexpr int MS = Tail::MS;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t base0 = Tail::layout(M, K, Ds).total;
  uint8_t* codes_s = smem + base0;
  const int t = blockIdx.x;
  const int qb0 = blockIdx.y * Tail::QBLK;

  Tail::load(smem, q, cw, nrm, u, B, Dg, qb0, M, K, Ds);
  const uint8_t* ct = codes + (size_t)t * TILE * M;
  for (int i = threadIdx.x; i < TILE * M; i += THREADS)   // coalesced
    codes_s[(i / M) * MS + i % M] = ct[i];
  __syncthreads();

  Tail::scan(smem, codes_s, mins, t, B, qb0, n_valid, M, K, Ds, cw, nrm);
}

template <class Tail>
int launch(const void* q, const void* cw, const void* nrm, const void* codes,
           const void* u, void* mins, int B, int Dg, int nT, int n_valid,
           int M, int K, int Ds, void* stream) {
  const size_t smem = Tail::layout(M, K, Ds).total + TILE * Tail::MS;
  cudaError_t e = cudaFuncSetAttribute(
      codes_mins_kernel<Tail>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(nT, (B + Tail::QBLK - 1) / Tail::QBLK);
  codes_mins_kernel<Tail><<<grid, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      q, cw, nrm, static_cast<const uint8_t*>(codes),
      static_cast<const float*>(u), static_cast<float*>(mins), B, Dg,
      n_valid, M, K, Ds);
  return (int)cudaGetLastError();
}

}  // namespace

// mode 0: int16 (Ds % 4 == 0); mode 1: bf16 (Ds % 2 == 0); mode 2: int8
// (Ds % 4 == 0); M <= 16; Dg is the rows of one plane of q (checked by the
// Python wrapper).  M <= 8 with M*Ds <= 128 takes the narrow tails, any
// other shape the wide ones.  Returns cudaGetLastError() after the launch.
extern "C" int codes_mins_launch(const void* q, const void* cw,
                                 const void* nrm, const void* codes,
                                 const void* u, void* mins, int B, int Dg,
                                 int nT, int n_valid, int M, int K, int Ds,
                                 int mode, void* stream) {
  if (nT == 0 || B == 0) return (int)cudaSuccess;
  if (M < 1 || M > MSW) return (int)cudaErrorInvalidValue;
  const int D = M * Ds;
#define CODES_LAUNCH(T)                                                 \
  return launch<T>(q, cw, nrm, codes, u, mins, B, Dg, nT, n_valid, M, K, \
                   Ds, stream)
  if (M > MMAX || D > 128) {
    if (mode == 0) CODES_LAUNCH(Int16Wide);
    if (mode == 1) CODES_LAUNCH(Bf16Wide);
    if (mode == 2) CODES_LAUNCH(Int8Wide);
  } else if (mode == 0) {
    if (D <= 16) CODES_LAUNCH(Int16Tail<4>);
    if (D <= 32) CODES_LAUNCH(Int16Tail<8>);
    if (D <= 64) CODES_LAUNCH(Int16Tail<16>);
    if (D <= 128) CODES_LAUNCH(Int16Tail<32>);
  } else if (mode == 1) {
    if (D <= 8) CODES_LAUNCH(Bf16Tail<4>);
    if (D <= 16) CODES_LAUNCH(Bf16Tail<8>);
    if (D <= 32) CODES_LAUNCH(Bf16Tail<16>);
    if (D <= 64) CODES_LAUNCH(Bf16Tail<32>);
    if (D <= 128) CODES_LAUNCH(Bf16Tail<64>);
  } else if (mode == 2) {
    if (D <= 16) CODES_LAUNCH(Int8Tail<4>);
    if (D <= 32) CODES_LAUNCH(Int8Tail<8>);
    if (D <= 64) CODES_LAUNCH(Int8Tail<16>);
    if (D <= 128) CODES_LAUNCH(Int8Tail<32>);
  }
#undef CODES_LAUNCH
  return (int)cudaErrorInvalidValue;
}
