// Tensor-core and asynchronous-copy pieces shared by the kernels: the
// warp-level mma.sync shapes of the narrow scan tails (scan_tail.cuh) and
// the cp.async copies of the decoded scan (decoded_mins.cu, whose wgmma
// accumulators have the c layout below).  Fragment layouts, with
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace mma
