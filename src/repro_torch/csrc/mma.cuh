// Inline-PTX wrappers of the warp-level tensor-core pieces the decode core's
// bf16 walk uses (sm_80 and later, so Hopper): `ldmatrix` of 8 x 8 bf16
// tiles from shared memory, plain and transposed, and `mma.sync` m16n8k16
// with bf16 inputs and an fp32 accumulator.
//
// Fragment layouts (lane l, g = l / 4, c = 2 * (l % 4)):
// * A (16 x 16, row-major), four .b32 of two bf16: a0 (row g, cols c, c+1),
//   a1 (row g+8, cols c, c+1), a2 (row g, cols c+8, c+9), a3 (row g+8, c+8..).
// * B (16 x 8, k x n), two .b32: b0 (k = c, c+1; n = g), b1 (k = c+8, c+9).
// * C / D (16 x 8 fp32): d0, d1 (row g, cols c, c+1), d2, d3 (row g+8).
// `ldmatrix` matrix j takes its eight row addresses from lanes 8j..8j+7 and
// gives lane l row g, columns c, c+1 of that matrix (`.trans`: rows c, c+1
// of column g), which is a B fragment half when the rows are B's n (plain)
// or k (transposed) index.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace repro {
namespace sm80 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// d += A B for one m16n8k16 tile.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two floats as bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

}  // namespace sm80
}  // namespace repro
