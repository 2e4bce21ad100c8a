// Helpers shared by the tensor-core kernels (spectral_conv.cu, ffn.cu), for
// Hopper (sm_90a): the TF32 split that keeps fp32 accuracy on the tensor
// cores (3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi, fp32 accumulation), one
// mma.sync.m16n8k8 TF32 product, and 16-byte cp.async copies.
//
// Fragments of mma.sync.m16n8k8 (lane = 4 g + t, g the group, t its thread):
//   A (16 x 8, row-major): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
//                          a3 = A[g+8][t+4]
//   B (8 x 8, k x n):      b0 = B[t][g], b1 = B[t+4][g]
//   C, D (16 x 8):         c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t],
//                          c3 = C[g+8][2t+1]

#pragma once

#include <cstdint>

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  // not volatile: the compiler may interleave independent products and
  // move fragment loads across them
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
