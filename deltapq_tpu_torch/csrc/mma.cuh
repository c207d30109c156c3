// Tensor-core and asynchronous-copy pieces shared by the kernels: the
// warp-level mma.sync shapes of the narrow scan tails (scan_tail.cuh), and
// the cp.async copies and warpgroup wgmma shapes of the decoded scan
// (decoded_mins.cu) and the gathered wide tail (wide_mma.cuh), whose
// accumulators have the c layout below.  Fragment layouts, with
// g = lane / 4 and t = lane % 4:
//
//   m16n8k16 bf16 (A 16x16 row-major, B 16x8 column-major, C 16x8 f32):
//     a0 = A[g][2t, 2t+1]      a1 = A[g+8][2t, 2t+1]
//     a2 = A[g][2t+8, 2t+9]    a3 = A[g+8][2t+8, 2t+9]
//     b0 = B[2t, 2t+1][g]      b1 = B[2t+8, 2t+9][g]
//   m16n8k32 s8 (A 16x32, B 32x8, C 16x8 s32), four bytes a register:
//     a0 = A[g][4t..4t+3]      a1 = A[g+8][4t..4t+3]
//     a2 = A[g][16+4t..]       a3 = A[g+8][16+4t..]
//     b0 = B[4t..4t+3][g]      b1 = B[16+4t..][g]
//   both:  c0 = C[g][2t]  c1 = C[g][2t+1]  c2 = C[g+8][2t]  c3 = C[g+8][2t+1]
//
// So in either shape a thread holds, of each group of eight 32-bit words
// of a row, word t and word t+4, for rows g and g+8 (A) or column g (B).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ void bf16_16816(float (&c)[4],
                                           const unsigned (&a)[4],
                                           unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void s8_16832(int (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, around L1; src_bytes = 0 writes zeros (the
// source is then not read, but must be a valid address).
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// The same through L1, for gathers whose sources repeat (codewords).
__device__ __forceinline__ void cp_async16_ca(unsigned dst, const void* src,
                                              int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- warpgroup products (wgmma, sm_90a) -----------------------------------
// Both operands K-major in shared memory, 128-byte rows with the 128-byte
// swizzle (16-byte piece c of row r at c ^ (r & 7)), named by descriptors.
// An accumulator of m64nN is N/2 registers a thread: register 4j + e is, in
// the n8 block j, the c_e above, for rows 16 * (warp of the group) + g and
// + 8.  scale_d = 0 overwrites the accumulator.

// Descriptor of a K-major tile at shared address saddr (1024-byte aligned,
// plus 32 bytes per k-step): 128-byte rows, 128-byte swizzle, 1024 bytes
// from one group of eight rows to the next.
__device__ __forceinline__ uint64_t tile_desc(unsigned saddr) {
  return (uint64_t)((saddr & 0x3ffffu) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

#define MMA_R8(f, i) f(d[i]), f(d[i + 1]), f(d[i + 2]), f(d[i + 3]), \
    f(d[i + 4]), f(d[i + 5]), f(d[i + 6]), f(d[i + 7])
#define MMA_F(x) "+f"(x)
#define MMA_I(x) "+r"(x)

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], bf16 in, f32 accumulate.
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : MMA_R8(MMA_F, 0), MMA_R8(MMA_F, 8), MMA_R8(MMA_F, 16),
        MMA_R8(MMA_F, 24), MMA_R8(MMA_F, 32), MMA_R8(MMA_F, 40),
        MMA_R8(MMA_F, 48), MMA_R8(MMA_F, 56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 32] . B[32 x 128], s8 in, s32 accumulate (exact).
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "%64, %65, p;\n}\n"
      : MMA_R8(MMA_I, 0), MMA_R8(MMA_I, 8), MMA_R8(MMA_I, 16),
        MMA_R8(MMA_I, 24), MMA_R8(MMA_I, 32), MMA_R8(MMA_I, 40),
        MMA_R8(MMA_I, 48), MMA_R8(MMA_I, 56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 32] (+)= A[64 x 32] . B[32 x 32], s8 in, s32 accumulate (exact).
__device__ __forceinline__ void wgmma_s8_n32(int (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "%16, %17, p;\n}\n"
      : MMA_R8(MMA_I, 0), MMA_R8(MMA_I, 8)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef MMA_R8
#undef MMA_F
#undef MMA_I

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_one() {   // all but the last
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Orders this thread's shared-memory writes (cp.async among them) before
// later reads of the tensor cores' asynchronous proxy.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Grid of a persistent kernel: as many blocks as the card holds at once,
// at most n_work.
template <class Kernel>
inline cudaError_t resident_grid(Kernel kernel, int threads, size_t smem,
                                 long long n_work, int* grid) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &occ, kernel, threads, smem)) != cudaSuccess)
    return e;
  if (occ < 1) return cudaErrorLaunchOutOfResources;
  const long long resident = (long long)sms * occ;
  *grid = (int)(n_work < resident ? n_work : resident);
  return cudaSuccess;
}

}  // namespace mma
