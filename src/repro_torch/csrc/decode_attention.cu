// Dense-cache decode attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the reference's Pallas TPU kernel
// `repro/kernels/decode_attention.py::decode_attention` (`_kernel`): one
// query token per slot attends over that slot's dense KV cache
// (B, S, KV, hd); cache slot t is valid when t <= pos[b]. There is no window
// argument, as in the Pallas kernel: ring buffers are fully valid once warm
// through the caller's eff_pos clamp. Online softmax in fp32, output in the
// input dtype.
//
// What bounds it on the H100: bytes (each valid K/V row is read once for
// 4 * groups * head_dim FLOP). The Pallas kernel walks the cache in order on
// one core, carrying (m, l, acc) in VMEM scratch across its sequential grid
// axis; here the shared decode core (`decode_core.cuh`) spreads each slot's
// valid positions over a thread-block cluster and merges the blocks through
// distributed shared memory, in one launch: the same algorithm as the paged
// kernel, a dense cache being a page pool of one page per slot. Any S runs
// (the Pallas wrapper needs S to be a multiple of its block).
#include "decode_core.cuh"

// C entry point. q, out: (B, H, hd); k_cache, v_cache: (B, S, KV, hd),
// 16-byte aligned, hd * element size a multiple of 16; pos: (B,) int32,
// >= 0 (positions past S - 1 see the whole cache). All contiguous, one float
// dtype (0 fp32, 1 bf16); H a multiple of KV; `cluster` blocks (1, 2, 4, 8 or
// 16) per (slot, KV head, group of at most 8 of its query heads). Returns the
// cudaError_t of the launch.
extern "C" int decode_attention_fwd(const void* q, const void* k_cache, const void* v_cache,
                                    const void* pos, void* out, int B, int S, int H, int KV,
                                    int hd, int dtype, float scale, int cluster, int variant,
                                    void* stream) {
  if (S < 1) return int(cudaErrorInvalidValue);
  repro::decode::Params p = {};
  p.q = q;
  p.k = k_cache;
  p.v = v_cache;
  p.pos = static_cast<const int*>(pos);
  p.out = out;
  p.H = H;
  p.KV = KV;
  p.hd = hd;
  p.cap = S;
  p.S = S;
  return int(repro::decode::run<repro::decode::DenseRows>(p, B, dtype, scale, cluster, variant,
                                                          static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory (bytes) a block of either decode kernel asks for at
// these operands: dtype 0 fp32, 1 bf16; G query heads per KV head (a block
// holds `block_group(G)` of them); head_dim; the variant as above.
extern "C" int decode_smem_bytes(int dtype, int G, int hd, int variant) {
  return int(repro::decode::smem_bytes(dtype, repro::decode::block_group(G), hd, variant));
}
