// Hopper (sm_90a) building blocks shared by the tensor-core kernels: shared
// memory addresses, mbarriers, TMA tile loads and bulk copies, named
// barriers between warpgroups, wgmma matrix descriptors and
// synchronisation, register rebalancing, and the host-side encoding of a
// TMA tensor map.
//
// The tensor map is encoded with `cuTensorMapEncodeTiled`, looked up
// through the CUDA runtime's entry-point query, so the library links
// against no libcuda stub and loads wherever the CUDA runtime does.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro {
namespace sm90 {

// ---------------------------------------------------------------------------
// device side
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA) and
// the other threads; follow with __syncthreads().
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic on the barrier.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA tile loads, global -> shared, completing `bytes` on `bar`. Coordinates
// are in elements, innermost first; elements outside the tensor read 0.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// Bulk copy without a tensor map, global -> shared: `bytes` a multiple of
// 16, both addresses 16-byte aligned, completing `bytes` on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One thread's 16-byte copy global -> shared (both 16-byte aligned), of
// which the first `src_bytes` (0 or 16) are read and the rest zero-filled;
// completes with the thread's next `cp_async_commit` group.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Named barriers between warpgroups (ids 1..15; 0 is __syncthreads):
// `count` threads in all, a multiple of 32. `named_arrive` does not wait;
// writes to shared memory before it are visible to the threads that pass
// the matching `named_sync`.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// wgmma shared-memory matrix descriptor for a tile written by TMA with the
// 128-byte swizzle: rows of 128 bytes, 8-row atoms of 1024 bytes, the tile
// 1024-byte aligned. `lbo` / `sbo` in bytes: for a K-major operand sbo is
// the stride between 8-row groups (1024) and lbo is unused; for an MN-major
// operand lbo is the stride between 64-element column blocks and sbo the
// stride between groups of 8 K rows (1024).
__device__ __forceinline__ uint64_t smem_desc(const void* tile, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = smem_u32(tile);
  return uint64_t((a & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Columns of a bf16 tile of head_dim `hd` built from 64-column TMA boxes of
// 128 bytes (the 128-byte swizzle's row): 80 and 112 -> 128, 160 -> 192.
__host__ __device__ constexpr int tile_columns(int hd) { return (hd + 63) / 64 * 64; }

// Makes this thread's ordinary stores to shared memory visible to the async
// proxy (TMA, and the operand reads of `wgmma`); follow with a barrier
// before the async accesses.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Zeroes rows [rows, 64) of `n` consecutive 64-row, 128-byte-row boxes
// (`box_bytes` apart, 16-byte aligned): the rows of a tile that its TMA box
// does not cover, which the tile's products still read. The whole block
// calls it, then `fence_proxy_async` and a barrier.
__device__ __forceinline__ void zero_box_tails(uint8_t* base, int n, uint32_t box_bytes,
                                               int rows) {
  const int per_box = (64 - rows) * 8;  // 16-byte stores a box
  for (int e = threadIdx.x; e < n * per_box; e += blockDim.x)
    *reinterpret_cast<uint4*>(base + (e / per_box) * box_bytes + rows * 128 +
                              (e % per_box) * 16) = make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Orders register accesses around the asynchronous wgmma: the compiler may
// neither hoist a read of `r` above a wait nor sink a write below a fence.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// TMA and 16-byte vector loads need 16-byte-aligned global addresses.
inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// Tensor map of a bf16 tensor of `rank` dims (sizes and byte strides
// innermost first; strides[0] is the element size and is not passed on),
// read in boxes of `box` elements with the 128-byte swizzle; elements out of
// range read zero. Returns false if the driver refuses it.
inline bool encode_bf16_map(CUtensorMap* map, const void* base, int rank, const uint64_t* sizes,
                            const uint64_t* strides, const uint32_t* box) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  cuuint64_t dims[5], bytes[4];
  cuuint32_t boxes[5], elem[5];
  for (int i = 0; i < rank; ++i) {
    dims[i] = sizes[i];
    boxes[i] = box[i];
    elem[i] = 1;
    if (i > 0) bytes[i - 1] = strides[i];
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, cuuint32_t(rank), const_cast<void*>(base), dims,
            bytes, boxes, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
}  // namespace repro
