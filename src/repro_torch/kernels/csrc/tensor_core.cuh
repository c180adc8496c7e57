// Warp-level tensor-core products and asynchronous copies for Hopper
// (sm_90a), shared by the GEMM (fused.cu) and the flash dk/dv kernel
// (flash.cu).
//
// Products are `mma.sync.aligned` on one warp:
//   * m16n8k8 with .tf32 operands for fp32 inputs, as the 3xTF32 split:
//     x = big + small, both TF32 values (split_tf32), and
//     a.b ~ a_small.b_big + a_big.b_small + a_big.b_big, issued in that
//     order into one fp32 accumulator (the dropped a_small.b_small term
//     is below 2^-22 of the product).  The tensor core's own additions
//     round toward zero (on the H100: tools/mma_rounding.py), so callers
//     add the accumulator into an ordinary fp32 register sum at a fixed
//     interval and zero it ("promotion").
//   * m16n8k16 with .bf16 operands for bf16 inputs: one product, exact,
//     with the same promotion.
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k8 /
// m16n8k16"), with g = lane / 4 and t = lane % 4:
//   tf32 A (16x8):  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   tf32 B (8x8):   b0 (k t, n g)  b1 (k t+4, n g)
//   bf16 A (16x16): a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                   a3 (g+8, 2t+8..), the lower k in the low half
//   bf16 B (16x8):  b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C / D (16x8):   c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
#pragma once
#include <cstdint>

#include "common.cuh"

namespace {

// ---- cp.async: global -> shared without a register round trip ----
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes; the source's first `src_bytes` are copied and the rest of
// the 16 zero-filled (0 reads nothing).  Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes (one fp32 element), zero-filled when src_bytes is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- operands ----
// x = big + small.  big is x rounded to TF32 to nearest, ties away from
// zero: what cvt.rna.tf32.f32 returns for a finite x, in two integer
// operations where cvt also tests for NaN (an inf stays inf; a NaN may
// come out as inf, still not finite).  small = x - big is exact, and is
// passed unrounded: the tensor core reads a .tf32 operand's upper 19
// bits, which truncates small to TF32 (below 2^-21 of x, against 2^-22
// when rounded; measured on the card: the fp32 checks hold with err/tol
// at most ~0.1, and the kernels ran 10-25 % faster than with cvt).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// Two bf16 values in one register, `lo` (the lower k) in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// ---- products: c += a.b on one warp ----
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[n] += a.b[n] for N column tiles sharing one A fragment, as 3xTF32
// products of split operands: small.big, big.small, big.big.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float c[N][4], const uint32_t ab[4],
                                           const uint32_t as[4],
                                           const uint32_t bb[N][2],
                                           const uint32_t bs[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    mma_tf32(c[n], as, bb[n]);
    mma_tf32(c[n], ab, bs[n]);
    mma_tf32(c[n], ab, bb[n]);
  }
}

}  // namespace
