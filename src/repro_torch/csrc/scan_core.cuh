// Pieces the scan's two tensor-core kernels share (`linear_scan.cu`'s
// `scan_mma_kernel`, `linear_scan_bwd.cu`'s `scan_bwd_mma_kernel`): the fp32
// to bf16 hi + lo split that keeps an operand exact to ~2^-17 on the tensor
// cores, and the asynchronous copies that stage a chunk's rows.
#pragma once

#include <cstdint>

#include "mma.cuh"

namespace repro {
namespace scan {

// x0, x1 as bf16x2 hi = bf16(x) and lo = bf16(x - hi): hi + lo is x to ~2^-17.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = sm80::pack_bf16x2(x0, x1);
  lo = sm80::pack_bf16x2(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace scan
}  // namespace repro
