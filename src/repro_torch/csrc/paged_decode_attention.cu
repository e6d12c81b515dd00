// Paged decode attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the reference's Pallas TPU kernel
// `repro/kernels/paged_decode_attention.py::paged_decode_attention`
// (`_kernel`): one query token per slot attends over a block pool of KV
// pages addressed through a per-slot page table. A logical position t is
// valid when t <= pos and, for window > 0, t > pos - window. Online softmax
// in fp32, output in the input dtype.
//
// What bounds it on the H100: bytes (each valid K/V row is read once for
// 4 * groups * head_dim FLOP). The design is the shared decode core
// (`decode_core.cuh`): one thread-block cluster per (slot, KV head), each
// block taking its share of the slot's valid positions as read on the
// device, 16-byte loads several rows deep, warp-private online softmax, and
// the cluster's blocks merged through distributed shared memory in one
// launch. The Pallas scalar prefetch of the page table becomes each block
// reading the table entries of the rows it loads, for valid positions only,
// so null-page padding is never read.
#include "decode_core.cuh"

// C entry point. q, out: (B, H, hd); k_pool, v_pool: (P, page, KV, hd),
// 16-byte aligned, any hd up to 256 (rows that are not whole 16-byte loads
// take the SIMT walk's element loads); table: (B, n_pages)
// int32; pos: (B,) int32, >= 0. All contiguous, one float dtype (0 fp32,
// 1 bf16); H a multiple of KV; `cluster` blocks (1, 2, 4, 8 or 16) per (slot, KV
// head, group of at most 8 of its query heads); `variant` 0 runs the exact fp32 FMA walk, 1 the bf16 tensor-core
// walk (bf16, hd a multiple of 16). Returns the cudaError_t of the launch.
extern "C" int paged_decode_attention_fwd(const void* q, const void* k_pool,
                                          const void* v_pool, const void* table,
                                          const void* pos, void* out, int B, int H, int KV,
                                          int hd, int page, int n_pages, int dtype,
                                          float scale, int window, int cluster, int variant,
                                          void* stream) {
  if (page < 1 || n_pages < 1) return int(cudaErrorInvalidValue);
  repro::decode::Params p = {};
  p.q = q;
  p.k = k_pool;
  p.v = v_pool;
  p.pos = static_cast<const int*>(pos);
  p.table = static_cast<const int*>(table);
  p.out = out;
  p.H = H;
  p.KV = KV;
  p.hd = hd;
  p.cap = page * n_pages;
  p.page = page;
  p.n_pages = n_pages;
  p.window = window;
  return int(repro::decode::run<repro::decode::PagedRows>(p, B, dtype, scale, cluster, variant,
                                                          static_cast<cudaStream_t>(stream)));
}
