// fp32 products on Hopper's tensor cores at fp32's accuracy: each fp32
// operand split into a TF32 high part and the TF32 of its remainder, each
// product taken as three `mma.sync` m16n8k8 TF32 products (lo hi + hi lo +
// hi hi, fp32 accumulation; the lo lo term, about 2^-22 of the product, is
// dropped): CUTLASS's OpMultiplyAddFastF32 scheme. A product is off by about
// 2^-21 of its size, where one TF32 product would be off by 2^-11.
//
// Shared by the fp32 flash forward (`flash_attention.cu`, variant tf32x3:
// `prod_rows` is S = Q K^T, `prod_acc` is O += P V) and the fp32 flash
// backward (`flash_attention_bwd.cu`, variant tf32x3: S^T, dP^T, dP and S by
// `prod_rows`; dV, dK and dQ by `prod_acc`). Operand tiles live in shared
// memory as rows of HD + 4 floats, which keeps every fragment load free of
// bank conflicts.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace repro {
namespace tf32x3 {

// x rounded to TF32 (10 mantissa bits): half an ulp added to the magnitude,
// then the low 13 bits cleared (round to nearest, ties away), so the
// tensor core reads the value exactly. `tests/test_torch_flash_bwd.py::
// _tf32_round` is the same on the host.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo to about 2^-22 of |x|: hi = TF32(x), lo = TF32(x - hi)
// (x - hi is exact in fp32).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// d += a b, one m16n8k8 TF32 tile with fp32 accumulation. Fragments (lane l,
// g = l / 4, c = l % 4): a0 (row g, k c), a1 (g + 8, c), a2 (g, c + 4), a3
// (g + 8, c + 4); b0 (k c, n g), b1 (k c + 4, n g); d0, d1 (row g, n 2c, 2c
// + 1), d2, d3 (row g + 8).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a b in three TF32 products, the small terms first: a_lo b_hi + a_hi
// b_lo + a_hi b_hi (a_lo b_lo, about 2^-22 of |a b|, is dropped).
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}
__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

// acc[j] += A B^T over HD for one warp: A is 16 fp32 rows at `a` (split into
// TF32 parts here), B is NJ x 8 rows at bh / bl, already split. Rows of
// HD + 4 floats: the lanes' loads hit 32 distinct banks. The hi hi products
// and the two small ones accumulate apart, added at the end: 2 NJ chains of
// dependent products instead of NJ.
template <int HD, int NJ>
__device__ __forceinline__ void prod_rows(float (&acc)[NJ][4], const float* a, const float* bh,
                                          const float* bl, int lane) {
  constexpr int LD = HD + 4;
  const int g = lane >> 2, c = lane & 3;
  float small[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) small[j][0] = small[j][1] = small[j][2] = small[j][3] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < HD; kk += 8) {
    uint32_t ah[4], al[4];
    split(a[g * LD + kk + c], ah[0], al[0]);
    split(a[(g + 8) * LD + kk + c], ah[1], al[1]);
    split(a[g * LD + kk + c + 4], ah[2], al[2]);
    split(a[(g + 8) * LD + kk + c + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int r = (8 * j + g) * LD + kk + c;
      const uint32_t bh0 = bits(bh[r]), bh1 = bits(bh[r + 4]);
      mma_tf32(small[j], al, bh0, bh1);
      mma_tf32(small[j], ah, bits(bl[r]), bits(bl[r + 4]));
      mma_tf32(acc[j], ah, bh0, bh1);
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += small[j][e];
}

// acc (16 rows x HD) += P B for one warp: P is the 16 x (NJ x 8) product
// `prod_rows` left in registers (its accumulator layout), B is NJ x 8 rows
// of HD at bh / bl. The k order inside each step of 8 is permuted, slot c
// being column 2c and slot c + 4 column 2c + 1, so that P's accumulator
// registers are its A fragment as they stand and B's rows follow the same
// permutation: no shuffle.
template <int HD, int NJ>
__device__ __forceinline__ void prod_acc(float (&acc)[HD / 8][4], const float (&p)[NJ][4],
                                         const float* bh, const float* bl, int lane) {
  constexpr int LD = HD + 4;
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    uint32_t ah[4], al[4];
    split(p[j][0], ah[0], al[0]);
    split(p[j][2], ah[1], al[1]);
    split(p[j][1], ah[2], al[2]);
    split(p[j][3], ah[3], al[3]);
    const int r = (8 * j + 2 * c) * LD + g;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      mma3(acc[n], ah, al, bits(bh[r + 8 * n]), bits(bh[r + LD + 8 * n]), bits(bl[r + 8 * n]),
           bits(bl[r + LD + 8 * n]));
  }
}

// Rows [0, n) of a (.., HD) fp32 tensor at `src` (rows `stride` floats
// apart) into ROWS rows of HD + 4 floats, zeros past n; 16-byte loads by
// the block's NT threads.
template <int HD, int ROWS, int NT>
__device__ __forceinline__ void stage(float* dst, const float* src, size_t stride, int n) {
  constexpr int V4 = HD / 4, LD = HD + 4;
  for (int e = threadIdx.x; e < ROWS * V4; e += NT) {
    const int r = e / V4, d = (e - r * V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n) x = __ldg(reinterpret_cast<const float4*>(src + r * stride + d));
    *reinterpret_cast<float4*>(dst + r * LD + d) = x;
  }
}
// The same rows split into their TF32 parts, hi and lo.
template <int HD, int ROWS, int NT>
__device__ __forceinline__ void stage_split(float* hi, float* lo, const float* src, size_t stride,
                                            int n) {
  constexpr int V4 = HD / 4, LD = HD + 4;
  for (int e = threadIdx.x; e < ROWS * V4; e += NT) {
    const int r = e / V4, d = (e - r * V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n) x = __ldg(reinterpret_cast<const float4*>(src + r * stride + d));
    uint32_t h[4], l[4];
    split(x.x, h[0], l[0]);
    split(x.y, h[1], l[1]);
    split(x.z, h[2], l[2]);
    split(x.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(hi + r * LD + d) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + r * LD + d) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

}  // namespace tf32x3
}  // namespace repro
