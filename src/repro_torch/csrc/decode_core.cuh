// One query token per slot against that slot's KV rows: the decode-attention
// core shared by `decode_attention.cu` (dense per-slot caches) and
// `paged_decode_attention.cu` (a page pool through a per-slot page table).
// The two differ only in how (slot, position) maps to a K/V row, which is
// the `Rows` template argument (`DenseRows`, `PagedRows`).
//
// What bounds it on the H100: in aggregate, bytes. Each valid position costs
// 4 * hd bytes of bf16 K and V for 4 * G * hd FLOP (G query heads per KV
// head), about G FLOP a byte against the card's ridge of ~295, so the levers
// are many SMs pulling bytes at once, wide loads with many in flight, no
// device-memory round trip and one launch.
//
// Design:
// * One thread-block cluster of C blocks per (slot, KV head), one launch per
//   call. Each block reads pos[b] on the device and takes its even share of
//   the slot's valid range [first, last] (first = pos - window + 1 with a
//   window, last = min(pos, capacity - 1)), rounded to the block's load
//   granule: the work follows the actual positions without a host sync, and
//   positions past pos (null-page padding included) are never read. The
//   wrapper picks C from the card's SM count (`decode_core.cluster_size`:
//   as many blocks as still fit one wave of one block an SM).
//   A block holds at most MAX_GROUP query heads; a KV head with more splits
//   them into head groups (`block_group`), a grid axis, each group's
//   cluster re-reading the KV head's rows. With 8 or fewer there is one.
// * A lane copies 16 bytes of a row, so one warp instruction moves a
//   512-byte hd = 256 bf16 row; narrower rows are moved several at once.
//   Each warp walks a strided subset of the block's positions, its K and V
//   rows copied by cp.async into a 3-stage ring in shared memory, two steps
//   ahead of the one being scored. Rows that are not a whole number of
//   16-byte loads (hd * element size not a multiple of 16, so most rows
//   start unaligned) take the SIMT walk with element loads instead, each
//   lane still filling its own 16-byte ring slots (zeros past hd); the
//   merge buffers then hold rows of hd rounded up to those slots (`hs`).
// * Warp-private online softmax in base 2 (scores scaled by scale * log2 e):
//   each warp keeps (m, l, acc) per query head in registers and q beside
//   them, so the walk has no block barrier; all G query heads share each
//   loaded K/V row (GQA). Two walks, picked by the wrapper's rule
//   (`decode_core.variant`): bf16 rows of 16, 32, 64, 80, 112, 128, 160 or
//   256 dims (but one query head a KV head at 80, 112 or 160, where one of
//   a tile's 16 rows is real) go to the tensor cores (`decode_mma_kernel`:
//   S = Q K^T and O += P V as mma.sync m16n8k16 tiles, eight positions a
//   warp step, at the row's own width: k16 steps and n8 tiles need no
//   padding at these dims); fp32 and other head dims take exact fp32 FMA
//   (`decode_kernel`: a lane holds 16 bytes of a row, a batch's U x G dot
//   products summed over the lanes by one reduce-scatter / all-gather, rows
//   rounded up to a power of two). On this
//   card the walk, not the bytes, sets the time: the cluster cap puts a
//   slot's rows on at most 8 SMs, and there the SIMT walk issues ~260
//   instructions a row.
// * Merges in a fixed order, so results are deterministic: the warps of a
//   block in shared memory, then the blocks of the cluster through
//   distributed shared memory (pushed before one cluster barrier), each
//   block writing a slice of the output. A block or warp that
//   saw no position holds (m, l) = (-inf, 0) and weighs exactly 0: no
//   -inf - -inf is ever formed. No partials reach device memory and there is
//   no second kernel.
#pragma once

#include <cooperative_groups.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace repro {
namespace decode {

namespace cg = cooperative_groups;

constexpr int NT = 256;  // threads a block
constexpr int NW = NT / 32;
constexpr int MAX_GROUP = 8;    // query heads per KV head held in registers
constexpr int MAX_HD = 256;
constexpr int MAX_CLUSTER = 16;  // above 8 needs the non-portable attribute
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
// the walk: exact fp32 FMA (`decode_kernel`), or bf16 tensor-core tiles
// (`decode_mma_kernel`, hd 16, 32, 64, 80, 112, 128, 160 or 256)
enum Variant : int { kSimt = 0, kMma = 1 };

struct Params {
  const void* q;     // (B, H, hd)
  const void* k;     // rows of hd elements: (B, S, KV, hd) or (P, page, KV, hd)
  const void* v;
  const int* pos;    // (B,)
  const int* table;  // paged: (B, n_pages); dense: unused
  void* out;         // (B, H, hd)
  int H, KV, hd;
  int hs;            // floats a row of the merge buffers: hd rounded up to whole loads
  int vec_rows;      // 1: rows are whole 16-byte loads (cp.async); 0: element loads
  int GT;            // query heads per KV head
  int ngrp;          // blocks' head groups per KV head: ceil(GT / MAX_GROUP)
  int G;             // query heads a group holds (the last group may hold fewer)
  int cap;           // positions a slot holds: S, or n_pages * page
  int S;             // dense: cache depth
  int page, n_pages;  // paged
  int window;        // > 0: only positions t > pos - window
  float qscale;      // softmax scale * log2 e
};

// Row (of the (rows, hd) view of K and V) of slot b, KV head kvh, walked
// from position t with a fixed stride of positions.
struct DenseRows {
  struct Cursor {
    long long r, step;
    __device__ long long row() const { return r; }
    __device__ void advance() { r += step; }
  };
  __device__ static Cursor at(const Params& p, int b, int kvh, int t, int stride) {
    return {(static_cast<long long>(b) * p.S + t) * p.KV + kvh,
            static_cast<long long>(stride) * p.KV};
  }
};

// ((table[b][t / page]) * page + t % page) * KV + kvh. The block reads its
// own table entries (the Pallas kernel's scalar prefetch), one per row it
// loads, and only for valid positions; the page and offset advance by the
// stride without a division.
struct PagedRows {
  struct Cursor {
    const int* trow;
    int pi, po, page, sp, sr, KV, kvh;
    __device__ long long row() const {
      return (static_cast<long long>(__ldg(trow + pi)) * page + po) * KV + kvh;
    }
    __device__ void advance() {
      pi += sp;
      po += sr;
      if (po >= page) {
        po -= page;
        ++pi;
      }
    }
  };
  __device__ static Cursor at(const Params& p, int b, int kvh, int t, int stride) {
    return {p.table + static_cast<size_t>(b) * p.n_pages, t / p.page, t % p.page, p.page,
            stride / p.page, stride % p.page, p.KV, kvh};
  }
};

// How a block reads rows of HDP elements (hd rounded up to a power of two).
template <typename T, int HDP>
struct Geo {
  static constexpr int VEC = 16 / int(sizeof(T));  // elements per 16-byte load
  static constexpr int NCH = HDP / VEC;            // 16-byte chunks of a row
  static constexpr int LPR = NCH < 32 ? NCH : 32;  // lanes of a unit (one row)
  static constexpr int CPL = NCH / LPR;            // chunks per lane
  static constexpr int EPL = CPL * VEC;            // elements per lane
  static constexpr int RPW = 32 / LPR;             // units (rows at once) per warp
  static constexpr int GR = NW * RPW;              // rows a block reads at once
};

// 16 bytes of a row as floats (bf16 -> fp32 is exact: the top 16 bits).
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& u, float* f) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The first n (<= 16 / sizeof(T)) elements at src, zeros after them, as the
// 16 bytes a cp.async of a whole chunk would have delivered: the load of a
// row that is not a whole number of 16-byte loads (src may be unaligned).
template <typename T>
__device__ __forceinline__ uint4 load_elems(const T* src, int n) {
  using Bits = typename std::conditional<sizeof(T) == 4, unsigned, unsigned short>::type;
  constexpr int VEC = 16 / int(sizeof(T));
  const Bits* s = reinterpret_cast<const Bits*>(src);
  Bits w[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) w[e] = e < n ? __ldg(s + e) : Bits(0);
  uint4 u;
  memcpy(&u, w, sizeof(u));
  return u;
}

// Weight of a state with max m in a merge whose max is M >= m: 0 for a
// state that saw nothing (m = -inf), so -inf - -inf never arises.
__device__ __forceinline__ float weight(float m, float M) {
  return m == REPRO_ABSENT ? 0.f : exp2f(m - M);
}

// Sums v[0..N) over the P lanes of an aligned group (P a power of two), every
// lane ending with all N sums: a reduce-scatter by recursive halving, then
// the all-gather back, about 2N shuffles instead of N log2 P.
template <int N, int C, int O>
struct LaneSum {
  static __device__ __forceinline__ void run(float (&v)[N], int lane) {
    if constexpr (O > 0) {
      if constexpr (C > 1) {
        constexpr int H = C / 2;
        const bool up = lane & O;  // this lane keeps the upper half
#pragma unroll
        for (int j = 0; j < H; ++j) {
          const float send = up ? v[j] : v[j + H];
          const float keep = up ? v[j + H] : v[j];
          v[j] = keep + __shfl_xor_sync(FULL, send, O);
        }
        LaneSum<N, H, O / 2>::run(v, lane);
#pragma unroll
        for (int j = 0; j < H; ++j) {
          const float own = v[j];
          const float other = __shfl_xor_sync(FULL, own, O);
          v[j] = up ? other : own;
          v[j + H] = up ? own : other;
        }
      } else {
        v[0] += __shfl_xor_sync(FULL, v[0], O);
        LaneSum<N, 1, O / 2>::run(v, lane);
      }
    }
  }
};

// Asynchronous 16-byte copies global -> shared (zero-filled when !pred:
// nothing is read), and the cluster barrier split into its arrive and wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Rows a unit holds per batch: fewer where a row is two loads a lane (fp32
// at hd 256) or q and acc hold 8 heads, so the ring and the registers fit.
template <typename T, int HDP, int GMAX>
struct Batch {
  static constexpr int U = (GMAX >= 8 || Geo<T, HDP>::CPL > 1) ? 2 : 4;
  static constexpr int STAGES = 3;  // batches in flight per warp
  // one warp's ring: [STAGES][U][K, V][CPL][32 lanes] of 16 bytes
  static constexpr int RING = STAGES * U * 2 * Geo<T, HDP>::CPL * 32;
};

// Shared memory of a block, in floats: the warps' rings, then the merge
// buffers (each block's acc, its receive slices, the (m, l) tables).
// `hs` is a row of the merge buffers: hd rounded up to whole 16-byte loads.
__host__ __device__ constexpr size_t merge_floats(int G, int hs) {
  return size_t(G) * hs + 4 * MAX_CLUSTER            // recv
         + (3 * MAX_CLUSTER + NW) * MAX_GROUP;        // wm, wl, recv_ml
}
template <typename T, int HDP, int GMAX>
__host__ __device__ constexpr size_t smem_floats(int G, int hs) {
  return size_t(4) * NW * Batch<T, HDP, GMAX>::RING + size_t(NW) * G * hs  // rings, wacc
         + merge_floats(G, hs);
}

// The tensor-core walk (bf16, hd = HDP, a multiple of 16): a warp takes TR
// = 8 positions a step, their K and V rows copied by cp.async into a
// 3-stage ring of 8-row tiles, each row's 16-byte chunks placed at chunk ^
// (row % 8) so that ldmatrix reads eight rows without bank conflicts. A
// ring row spans RS chunks: the row's NCH rounded up to whole 8-chunk
// (128-byte) groups once it has 8 or more (hd 80 and 112: 16 chunks, hd
// 160: 24), so the swizzle of a chunk stays inside its own group of 8, and
// so inside the row, and the eight rows ldmatrix reads at one chunk fall on
// eight distinct 16-byte bank groups; the padding is never written or read.
// A copy instruction moves RPI whole rows, one chunk a lane; the lanes past
// RPI * NCH (hd 80: 2, 112: 4, 160: 12) copy nothing. Everything is
// unrolled at compile time, with no runtime guard, so a tile's ldmatrix
// loads issue ahead of their products. `kernels/decode_core.py::
// mma_ring_slot` is this layout on the host, for the tests.
template <int HDP>
struct MmaGeo {
  static_assert(HDP % 16 == 0 && HDP <= 256, "whole k16 steps of at most 256 dims");
  static constexpr int TR = 8;                    // positions a warp scores per step
  static constexpr int NCH = HDP / 8;             // 16-byte chunks of a bf16 row (<= 32)
  static constexpr int RS = NCH <= 8 ? NCH : (NCH + 7) / 8 * 8;  // chunks a ring row spans
  static constexpr int RPI = 32 / NCH;            // rows a warp copies per instruction
  static constexpr int COPIERS = RPI * NCH;       // lanes that copy
  static constexpr int CPT = (TR + RPI - 1) / RPI;  // copy instructions per tile
  static constexpr int SW = (NCH < 8 ? NCH : 8) - 1;  // chunk swizzle mask
  static constexpr int KS = HDP / 16;             // k16 steps of S = Q K^T
  static constexpr int N8 = HDP / 8;              // n8 tiles of O = P V
  static constexpr int STAGES = 3;
  static constexpr int TILE = TR * RS * 16;       // bytes of a K or a V tile
  static constexpr int RING = STAGES * 2 * TILE;  // bytes of a warp's ring
};
// The rings, which the warps' acc (at most NW * 8 * HDP floats) reuses
// after the walk, then the merge buffers.
template <int HDP>
__host__ __device__ constexpr size_t mma_smem_floats(int G, int hs) {
  return size_t(NW) * MmaGeo<HDP>::RING / 4 + merge_floats(G, hs);
}

// The end of both kernels. On entry each warp's (m, l) is in wm / wl
// [warp][g] and its acc in wacc[warp][g][hs] (hs = hd but for the rows that
// are not whole loads, whose padding holds zeros). Merges the block's warps and
// sends the result to the cluster: block r of the cluster writes slice r of
// the output, so each block stores slice r of its acc into block r's `recv`
// and its (m, l) into every block's `recv_ml`; the stores complete before
// the cluster barrier releases, and after it only local memory is read.
template <typename T>
__device__ __forceinline__ void merge_and_store(const Params& p, cg::cluster_group& cluster,
                                                int rank, int b, int hb, int G, const float* wacc,
                                                float* recv, float* wm, const float* wl,
                                                float* recv_ml) {
  const int C = static_cast<int>(cluster.dim_blocks().x);
  const int tid = threadIdx.x, hd = p.hd, hs = p.hs;
  cluster_wait();
  const int n4 = G * hs / 4;           // float4s of a (slot, KV head)'s output
  const int slice = (n4 + C - 1) / C;  // float4s each block writes
  for (int i4 = tid; i4 < n4; i4 += NT) {
    const int g = 4 * i4 / hs;
    float M = REPRO_ABSENT;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, wm[w * MAX_GROUP + g]);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float wt = weight(wm[w * MAX_GROUP + g], M);
      const float4 x = reinterpret_cast<const float4*>(wacc + size_t(w) * G * hs)[i4];
      a.x = fmaf(wt, x.x, a.x);
      a.y = fmaf(wt, x.y, a.y);
      a.z = fmaf(wt, x.z, a.z);
      a.w = fmaf(wt, x.w, a.w);
    }
    const int r = i4 / slice;
    reinterpret_cast<float4*>(cluster.map_shared_rank(recv, r))[rank * slice + i4 - r * slice] = a;
  }
  if (tid < G) {
    float M = REPRO_ABSENT, L = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, wm[w * MAX_GROUP + tid]);
#pragma unroll
    for (int w = 0; w < NW; ++w) L += weight(wm[w * MAX_GROUP + tid], M) * wl[w * MAX_GROUP + tid];
    for (int r = 0; r < C; ++r) {
      float* dst = cluster.map_shared_rank(recv_ml, r) + (rank * MAX_GROUP + tid) * 2;
      dst[0] = M;
      dst[1] = L;
    }
  }
  cluster.sync();

  // this block's slice of the output: the C blocks' parts, weighted
  // e^(m_r - M) / L in rank order (deterministic); only local memory from here
  if (tid < G) {
    float M = REPRO_ABSENT, L = 0.f;
    for (int r = 0; r < C; ++r) M = fmaxf(M, recv_ml[(r * MAX_GROUP + tid) * 2]);
    for (int r = 0; r < C; ++r)
      L += weight(recv_ml[(r * MAX_GROUP + tid) * 2], M) * recv_ml[(r * MAX_GROUP + tid) * 2 + 1];
    const float inv = L > 0.f ? 1.f / L : 0.f;  // no valid position at all: zeros
    for (int r = 0; r < C; ++r)
      wm[r * MAX_GROUP + tid] = weight(recv_ml[(r * MAX_GROUP + tid) * 2], M) * inv;
  }
  __syncthreads();
  T* op = static_cast<T*>(p.out) + (size_t(b) * p.H + hb) * hd;
  for (int j = tid; j < slice && rank * slice + j < n4; j += NT) {
    const int i4 = rank * slice + j, g = 4 * i4 / hs, col = 4 * i4 - g * hs;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < C; ++r) {
      const float wt = wm[r * MAX_GROUP + g];
      const float4 x = reinterpret_cast<const float4*>(recv)[r * slice + j];
      o.x = fmaf(wt, x.x, o.x);
      o.y = fmaf(wt, x.y, o.y);
      o.z = fmaf(wt, x.z, o.z);
      o.w = fmaf(wt, x.w, o.w);
    }
    T* og = op + g * hd + col;  // the padding past hd is not written
    if (col < hd) og[0] = from_float<T>(o.x);
    if (col + 1 < hd) og[1] = from_float<T>(o.y);
    if (col + 2 < hd) og[2] = from_float<T>(o.z);
    if (col + 3 < hd) og[3] = from_float<T>(o.w);
  }
}

template <typename T, int HDP, int GMAX, class Rows>
__global__ void __launch_bounds__(NT, 1) decode_kernel(const Params p) {
  using Gm = Geo<T, HDP>;
  using Bt = Batch<T, HDP, GMAX>;
  constexpr int VEC = Gm::VEC, LPR = Gm::LPR, CPL = Gm::CPL, EPL = Gm::EPL;
  constexpr int RPW = Gm::RPW, GR = Gm::GR;
  constexpr int U = Bt::U, STAGES = Bt::STAGES;
  constexpr int STEP = U * GR;  // positions a block advances per batch

  // arrive now, wait before the first remote write: every block of the
  // cluster has started by then
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.dim_blocks().x);
  const int rank = static_cast<int>(cluster.block_rank());
  // blockIdx.y: KV head kvh, head group grp of it (one group when GT <= 8)
  const int kvh = blockIdx.y / p.ngrp, grp = blockIdx.y - kvh * p.ngrp, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int unit = lane / LPR, ul = lane % LPR;
  const int G = min(p.G, p.GT - grp * p.G), hd = p.hd, hs = p.hs;
  const int hb = kvh * p.GT + grp * p.G;  // this block's first query head
  const int nch = (hd + VEC - 1) / VEC;  // 16-byte chunks of a row that exist (the last
                                         // one partial where rows are not whole loads)

  extern __shared__ __align__(16) float smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem) + warp * Bt::RING;
  float* wacc = smem + 4 * NW * Bt::RING;  // [NW][G][hs] each warp's acc
  float* recv = wacc + NW * G * hs;        // [C][slice] acc slices the blocks send here
  float* wm = recv + G * hs + 4 * MAX_CLUSTER;  // [NW][MAX_GROUP] each warp's m, then
                                                // [C][MAX_GROUP] each block's weight
  float* wl = wm + MAX_CLUSTER * MAX_GROUP;     // [NW][MAX_GROUP] each warp's l
  float* recv_ml = wl + NW * MAX_GROUP;         // [C][MAX_GROUP][m, l] from each block

  // this block's share [lo, hi) of the slot's valid positions
  const int pos = p.pos[b];
  const int last = min(pos, p.cap - 1);
  const int first = p.window > 0 ? max(0, pos - p.window + 1) : 0;
  int lo = 0, hi = 0;
  if (last >= first) {
    const int per = ((last - first + C) / C + GR - 1) / GR * GR;
    lo = min(last + 1, first + rank * per);
    hi = min(last + 1, lo + per);
  }

  // q: (B, H, hd); this block's heads are hb .. hb + G - 1
  const T* qp = static_cast<const T*>(p.q) + (size_t(b) * p.H + hb) * hd;
  const bool qvec = reinterpret_cast<uintptr_t>(p.q) % 16 == 0 && hd % VEC == 0;
  float qr[GMAX][EPL], m[GMAX], l[GMAX], acc[GMAX][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = REPRO_ABSENT;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int ch = c * LPR + ul;
      float f[VEC];
      if (g < G && ch < nch) {
        if (qvec) {
          unpack<T>(__ldg(reinterpret_cast<const uint4*>(qp + g * hd) + ch), f);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            f[e] = ch * VEC + e < hd ? to_float(qp[g * hd + ch * VEC + e]) : 0.f;
        }
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        qr[g][c * VEC + e] = f[e] * p.qscale;
        acc[g][c * VEC + e] = 0.f;
      }
    }
  }

  if (lo < hi) {  // block-uniform
    const T* kp = static_cast<const T*>(p.k);
    const T* vp = static_cast<const T*>(p.v);
    const int tw = lo + warp * RPW;  // unit 0's first row: warp-uniform
    auto cur = Rows::at(p, b, kvh, tw + unit, GR);
    auto slot = [&](int st, int i, int kv, int c) {
      return ring + (((st * U + i) * 2 + kv) * CPL + c) * 32 + lane;
    };

    // copy batch j (rows t, t + GR, ..., t + (U - 1) GR, t = tw + j STEP +
    // unit) into stage j % STAGES; each lane copies, and later reads, only
    // its own 16-byte chunks, so no barrier is needed. Rows that are not
    // whole 16-byte loads are read element by element (block-uniform branch)
    auto issue = [&](int j) {
      const int t = tw + j * STEP + unit, st = j % STAGES;
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const bool ok = t + i * GR < hi;
        const long long row = ok ? cur.row() : 0;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int ch = c * LPR + ul;
          const bool in = ok && ch < nch;
          if (p.vec_rows) {
            cp_async16(slot(st, i, 0, c), in ? kp + row * hd + ch * VEC : kp, in);
            cp_async16(slot(st, i, 1, c), in ? vp + row * hd + ch * VEC : vp, in);
          } else {
            const int n = in ? min(VEC, hd - ch * VEC) : 0;
            *slot(st, i, 0, c) = load_elems<T>(kp + row * hd + ch * VEC, n);
            *slot(st, i, 1, c) = load_elems<T>(vp + row * hd + ch * VEC, n);
          }
        }
        cur.advance();
      }
    };

    // online softmax over batch j
    auto consume = [&](int j) {
      const int t = tw + j * STEP + unit, st = j % STAGES;
      float s[U * GMAX];
#pragma unroll
      for (int i = 0; i < U; ++i) {
        float kf[EPL];
#pragma unroll
        for (int c = 0; c < CPL; ++c) unpack<T>(*slot(st, i, 0, c), kf + c * VEC);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) a = fmaf(qr[g][e], kf[e], a);
          s[i * GMAX + g] = a;
        }
      }
      LaneSum<U * GMAX, U * GMAX, LPR / 2>::run(s, lane);
      float vf[U][EPL];
#pragma unroll
      for (int i = 0; i < U; ++i)
#pragma unroll
        for (int c = 0; c < CPL; ++c) unpack<T>(*slot(st, i, 1, c), vf[i] + c * VEC);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          float mx = REPRO_ABSENT;
#pragma unroll
          for (int i = 0; i < U; ++i)
            if (t + i * GR < hi) mx = fmaxf(mx, s[i * GMAX + g]);
          const float mn = fmaxf(m[g], mx);
          const float alpha = mn == REPRO_ABSENT ? 1.f : exp2f(m[g] - mn);
          float pr[U], ps = 0.f;
#pragma unroll
          for (int i = 0; i < U; ++i) {
            pr[i] = t + i * GR < hi ? exp2f(s[i * GMAX + g] - mn) : 0.f;
            ps += pr[i];
          }
          l[g] = l[g] * alpha + ps;
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            float a = acc[g][e] * alpha;
#pragma unroll
            for (int i = 0; i < U; ++i) a = fmaf(pr[i], vf[i][e], a);
            acc[g][e] = a;
          }
          m[g] = mn;
        }
      }
    };

    // STAGES - 1 batches in flight ahead of the one being scored; a group
    // is committed every step (empty past the end) so the wait counts hold
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) {
      if (tw + j * STEP < hi) issue(j);
      cp_async_commit();
    }
    for (int j = 0; tw + j * STEP < hi; ++j) {  // warp-uniform
      if (tw + (j + STAGES - 1) * STEP < hi) issue(j + STAGES - 1);
      cp_async_commit();
      cp_async_wait<STAGES - 1>();  // batch j has landed
      consume(j);
    }
    cp_async_wait<0>();
  }

  // merge the units of a warp (same dims, other positions)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      const float mo = __shfl_xor_sync(FULL, m[g], off);
      const float lo_ = __shfl_xor_sync(FULL, l[g], off);
      const float M = fmaxf(m[g], mo);
      const float a = weight(m[g], M), ao = weight(mo, M);
      l[g] = l[g] * a + lo_ * ao;
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[g][e] = acc[g][e] * a + __shfl_xor_sync(FULL, acc[g][e], off) * ao;
      m[g] = M;
    }
  }
  if (lane < LPR) {  // unit 0 holds the warp's state
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        if (lane == 0) {
          wm[warp * MAX_GROUP + g] = m[g];
          wl[warp * MAX_GROUP + g] = l[g];
        }
        float* dst = wacc + (size_t(warp) * G + g) * hs;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int ch = c * LPR + lane;
          if (ch < nch) {
#pragma unroll
            for (int e = 0; e < VEC; e += 4)
              *reinterpret_cast<float4*>(dst + ch * VEC + e) =
                  make_float4(acc[g][c * VEC + e], acc[g][c * VEC + e + 1],
                              acc[g][c * VEC + e + 2], acc[g][c * VEC + e + 3]);
          }
        }
      }
    }
  }
  __syncthreads();

  merge_and_store<T>(p, cluster, rank, b, hb, G, wacc, recv, wm, wl, recv_ml);
}

template <int HDP, int GMAX, class Rows>
__global__ void __launch_bounds__(NT, 1) decode_mma_kernel(const Params p) {
  using bf16 = __nv_bfloat16;
  using Mg = MmaGeo<HDP>;
  constexpr int TR = Mg::TR, NCH = Mg::NCH, RS = Mg::RS, RPI = Mg::RPI, CPT = Mg::CPT;
  constexpr int SW = Mg::SW, KS = Mg::KS, N8 = Mg::N8, STAGES = Mg::STAGES, TILE = Mg::TILE;
  constexpr int WSTEP = NW * TR;  // positions between a warp's steps

  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.dim_blocks().x);
  const int rank = static_cast<int>(cluster.block_rank());
  const int kvh = blockIdx.y / p.ngrp, grp = blockIdx.y - kvh * p.ngrp, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = min(p.G, p.GT - grp * p.G), hd = p.hd;
  const int hb = kvh * p.GT + grp * p.G;

  extern __shared__ __align__(16) float smem[];
  char* ring = reinterpret_cast<char*>(smem) + warp * Mg::RING;
  float* wacc = smem;  // [NW][G][hd] each warp's acc, over the rings once they are done
                       // (hs = hd: the tensor-core walk takes whole-load rows only)
  float* recv = smem + NW * Mg::RING / 4;
  float* wm = recv + G * hd + 4 * MAX_CLUSTER;
  float* wl = wm + MAX_CLUSTER * MAX_GROUP;
  float* recv_ml = wl + NW * MAX_GROUP;

  const int pos = p.pos[b];
  const int last = min(pos, p.cap - 1);
  const int first = p.window > 0 ? max(0, pos - p.window + 1) : 0;
  int lo = 0, hi = 0;
  if (last >= first) {
    const int per = ((last - first + C) / C + TR - 1) / TR * TR;
    lo = min(last + 1, first + rank * per);
    hi = min(last + 1, lo + per);
  }

  // lane l holds row g = l / 4 of the m16 tiles (query head g of this KV
  // head; rows G..15 stay zero) and columns c2, c2 + 1 of each 8-wide tile
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  uint32_t qa[KS][2];  // Q as A fragments: a0 (dims 16 ks + c2, +1), a2 (+8); a1 = a3 = 0
  {
    const unsigned short* qs = reinterpret_cast<const unsigned short*>(
        static_cast<const bf16*>(p.q) + (size_t(b) * p.H + hb + g) * hd);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = 16 * ks + 8 * h + c2;
        qa[ks][h] = g < G ? uint32_t(qs[d]) | uint32_t(qs[d + 1]) << 16 : 0u;
      }
  }
  float m = REPRO_ABSENT, l = 0.f;  // row g's running max, this lane's part of its sum
  float o[N8][4];                   // O = P V: rows g (o[.][0..1]) and g + 8 (unused)
#pragma unroll
  for (int n = 0; n < N8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  if (lo < hi) {  // block-uniform
    const bf16* kp = static_cast<const bf16*>(p.k);
    const bf16* vp = static_cast<const bf16*>(p.v);
    const int tw = lo + warp * TR;               // this warp's first tile
    const int rl = lane / NCH, ch = lane % NCH;  // copies: row of an instruction, chunk
    const int mr = lane & 7, mj = lane >> 3;     // ldmatrix: row this lane addresses, matrix
    // the byte offset of (row, chunk) in a tile, and this lane's ldmatrix row
    auto at = [](int row, int chunk) { return (row * RS + (chunk ^ (row & SW))) * 16; };
    const bool copier = lane < Mg::COPIERS;

    // tile j of this warp (positions tw + j WSTEP ...) into stage st
    auto issue = [&](int j, int st) {
      const int t0 = tw + j * WSTEP;
      char* kt = ring + st * 2 * TILE;
      auto cur = Rows::at(p, b, kvh, t0 + rl, RPI);
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int r = i * RPI + rl;
        if (copier && r < TR) {
          const bool valid = t0 + r < hi;
          const long long row = valid ? cur.row() : 0;
          cp_async16(kt + at(r, ch), valid ? kp + row * HDP + ch * 8 : kp, valid);
          cp_async16(kt + TILE + at(r, ch), valid ? vp + row * HDP + ch * 8 : vp, valid);
        }
        cur.advance();
      }
    };

    auto consume = [&](int j, int st) {
      const int t0 = tw + j * WSTEP;
      const char* kt = ring + st * 2 * TILE;
      const char* vt = kt + TILE;
      // S = Q K^T: rows = heads, columns = the tile's 8 positions; even and
      // odd k16 steps in two accumulators to halve the dependent chain
      // (pairs of k16 steps by ldmatrix.x4, an odd last step by .x2)
      float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
      {
        constexpr int K2 = KS / 2;
        uint32_t r[K2 > 0 ? K2 : 1][4], rt[2];
#pragma unroll
        for (int k2 = 0; k2 < K2; ++k2) sm80::ldsm_x4(r[k2], kt + at(mr, 4 * k2 + mj));
        if constexpr (KS % 2) sm80::ldsm_x2(rt, kt + at(mr, 4 * K2 + (mj & 1)));
#pragma unroll
        for (int k2 = 0; k2 < K2; ++k2) {
          sm80::mma_bf16(s0, qa[2 * k2][0], 0u, qa[2 * k2][1], 0u, r[k2][0], r[k2][1]);
          sm80::mma_bf16(s1, qa[2 * k2 + 1][0], 0u, qa[2 * k2 + 1][1], 0u, r[k2][2], r[k2][3]);
        }
        if constexpr (KS % 2)
          sm80::mma_bf16(s0, qa[KS - 1][0], 0u, qa[KS - 1][1], 0u, rt[0], rt[1]);
      }
      const float sc[2] = {s0[0] + s1[0], s0[1] + s1[1]};
      // online softmax of row g over positions t0 + c2, t0 + c2 + 1 (the
      // quad of lanes 4g..4g+3 holds the row's 8 columns)
      const int tp = t0 + c2;
      const float x0 = tp < hi ? sc[0] * p.qscale : REPRO_ABSENT;
      const float x1 = tp + 1 < hi ? sc[1] * p.qscale : REPRO_ABSENT;
      float mx = fmaxf(x0, x1);
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float mn = fmaxf(m, mx);  // finite: position t0 is valid
      const float alpha = exp2f(m - mn);
      const float p0 = exp2f(x0 - mn), p1 = exp2f(x1 - mn);
      l = l * alpha + (p0 + p1);
      m = mn;
      if (__any_sync(FULL, alpha != 1.f)) {
#pragma unroll
        for (int n = 0; n < N8; ++n) {
          o[n][0] *= alpha;
          o[n][1] *= alpha;
        }
      }
      // O += P V: P (bf16) as the A fragment a0 (row g, positions c2, c2+1);
      // V rows transposed by ldmatrix into B fragments, 8 dims a tile
      // (four n8 tiles a ldmatrix.x4, a last pair by .x2)
      const uint32_t pa = sm80::pack_bf16x2(p0, p1);
      constexpr int N4 = N8 / 4 * 4;
#pragma unroll
      for (int n4 = 0; n4 < N4; n4 += 4) {
        uint32_t r[4];
        sm80::ldsm_x4_t(r, vt + at(mr, n4 + mj));
#pragma unroll
        for (int q = 0; q < 4; ++q) sm80::mma_bf16(o[n4 + q], pa, 0u, 0u, 0u, r[q], 0u);
      }
      if constexpr (N8 % 4) {
        static_assert(N8 % 4 == 2, "n8 tiles come in pairs");
        uint32_t r[2];
        sm80::ldsm_x2_t(r, vt + at(mr, N4 + (mj & 1)));
#pragma unroll
        for (int q = 0; q < 2; ++q) sm80::mma_bf16(o[N4 + q], pa, 0u, 0u, 0u, r[q], 0u);
      }
    };

    // as in the SIMT walk, STAGES - 1 tiles in flight ahead of the one being
    // scored; the warp barriers make the other lanes' copies visible before
    // ldmatrix reads them and keep a stage from being refilled while read
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) {
      if (tw + j * WSTEP < hi) issue(j, j);
      cp_async_commit();
    }
    for (int j = 0, st = 0; tw + j * WSTEP < hi; ++j, st = st + 1 == STAGES ? 0 : st + 1) {
      if (tw + (j + STAGES - 1) * WSTEP < hi) issue(j + STAGES - 1, st == 0 ? STAGES - 1 : st - 1);
      cp_async_commit();
      cp_async_wait<STAGES - 1>();
      __syncwarp();
      consume(j, st);
      __syncwarp();
    }
    cp_async_wait<0>();
  }
  l += __shfl_xor_sync(FULL, l, 1);
  l += __shfl_xor_sync(FULL, l, 2);

  __syncthreads();  // every warp is done with its ring: wacc lies over them
  if (g < G) {
    if ((lane & 3) == 0) {
      wm[warp * MAX_GROUP + g] = m;
      wl[warp * MAX_GROUP + g] = l;
    }
    float* dst = wacc + (size_t(warp) * G + g) * hd;
#pragma unroll
    for (int n = 0; n < N8; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n + c2) = make_float2(o[n][0], o[n][1]);
  }
  __syncthreads();
  merge_and_store<bf16>(p, cluster, rank, b, hb, G, wacc, recv, wm, wl, recv_ml);
}

// Query heads a block holds for GT heads per KV head: GT itself up to
// MAX_GROUP; above it, the KV head's heads split into ceil(GT / MAX_GROUP)
// groups of at most MAX_GROUP, one block (cluster) each, every group
// re-reading the KV head's rows.
inline int block_group(int GT) {
  const int ngrp = (GT + MAX_GROUP - 1) / MAX_GROUP;
  return (GT + ngrp - 1) / ngrp;
}

// The SIMT walk's row width for hd: hd rounded up to a power of two.
inline int head_dim_bucket(int hd) {
  return hd <= 16 ? 16 : hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
}

// The tensor-core walk's head dims (`decode_core.MMA_HEAD_DIMS`), each its own
// instantiation at the row's width.
inline bool is_mma_head_dim(int hd) {
  switch (hd) {
    case 16: case 32: case 64: case 80: case 112: case 128: case 160: case 256: return true;
    default: return false;
  }
}

template <typename T, int HDP, int GMAX, bool MMA>
constexpr size_t smem_floats_of(int G, int hs) {
  if constexpr (MMA) return mma_smem_floats<HDP>(G, hs);
  else return smem_floats<T, HDP, GMAX>(G, hs);
}

// hd rounded up to whole 16-byte loads of `elem`-byte elements.
inline int row_floats(int hd, int elem) {
  const int vec = 16 / elem;
  return (hd + vec - 1) / vec * vec;
}

namespace {  // internal linkage: each library keeps its own launch state

template <typename T, int HDP, int GMAX, class Rows, bool MMA>
cudaError_t launch_kernel(const Params& p, int B, int cluster, cudaStream_t stream) {
  auto kernel = [] {  // only the walk asked for is instantiated
    if constexpr (MMA) return decode_mma_kernel<HDP, GMAX, Rows>;
    else return decode_kernel<T, HDP, GMAX, Rows>;
  }();
  // once per instantiation: room for its largest shared-memory need and the
  // non-portable cluster size (the wrappers pick at most 8)
  static const cudaError_t setup = [&] {
    const int most = int(sizeof(float) * smem_floats_of<T, HDP, GMAX, MMA>(GMAX, HDP));
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return err;
  }();
  if (setup != cudaSuccess) return setup;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, p.KV * p.ngrp, B);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = sizeof(float) * smem_floats_of<T, HDP, GMAX, MMA>(p.G, p.hs);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  const cudaError_t last = cudaGetLastError();  // also clears a failed launch's error
  return err != cudaSuccess ? err : last;
}

// Calls f(T{}, HDP, GMAX) with the instantiation that serves dtype, hd, G.
template <typename T, int HDP, class F>
auto with_group(int G, F&& f) {
  using std::integral_constant;
  if (G <= 1) return f(T{}, integral_constant<int, HDP>{}, integral_constant<int, 1>{});
  if (G <= 2) return f(T{}, integral_constant<int, HDP>{}, integral_constant<int, 2>{});
  if (G <= 4) return f(T{}, integral_constant<int, HDP>{}, integral_constant<int, 4>{});
  return f(T{}, integral_constant<int, HDP>{}, integral_constant<int, 8>{});
}

template <typename T, class F>
auto with_head_dim(int hd, int G, F&& f) {
  switch (head_dim_bucket(hd)) {
    case 16: return with_group<T, 16>(G, f);
    case 32: return with_group<T, 32>(G, f);
    case 64: return with_group<T, 64>(G, f);
    case 128: return with_group<T, 128>(G, f);
    default: return with_group<T, 256>(G, f);
  }
}

// The SIMT walk's instantiation for dtype, hd (by its bucket), G.
template <class F>
auto dispatch(int dtype, int hd, int G, F&& f) {
  if (dtype == kFloat32) return with_head_dim<float>(hd, G, f);
  return with_head_dim<__nv_bfloat16>(hd, G, f);
}

// The tensor-core walk's instantiation for hd (one of `is_mma_head_dim`), G.
template <class F>
auto dispatch_mma(int hd, int G, F&& f) {
  using T = __nv_bfloat16;
  switch (hd) {
    case 16: return with_group<T, 16>(G, f);
    case 32: return with_group<T, 32>(G, f);
    case 64: return with_group<T, 64>(G, f);
    case 80: return with_group<T, 80>(G, f);
    case 112: return with_group<T, 112>(G, f);
    case 128: return with_group<T, 128>(G, f);
    case 160: return with_group<T, 160>(G, f);
    default: return with_group<T, 256>(G, f);
  }
}

// Dynamic shared memory a launch for these operands asks for (0 for the
// tensor-core walk at operands it does not take).
inline size_t smem_bytes(int dtype, int G, int hd, int variant) {
  if (variant == kMma) {
    if (dtype != kBFloat16 || !is_mma_head_dim(hd)) return 0;
    return dispatch_mma(hd, G, [&](auto, auto hdp, auto gmax) {
      constexpr int H = decltype(hdp)::value, M = decltype(gmax)::value;
      return sizeof(float) * smem_floats_of<__nv_bfloat16, H, M, true>(G, hd);
    });
  }
  return dispatch(dtype, hd, G, [&](auto t, auto hdp, auto gmax) {
    using T = decltype(t);
    constexpr int H = decltype(hdp)::value, M = decltype(gmax)::value;
    return sizeof(float) * smem_floats_of<T, H, M, false>(G, row_floats(hd, int(sizeof(T))));
  });
}

// Checks what the kernel assumes (the wrappers' `decode_core.layout_error`
// checks the same first) and launches. `scale` is the softmax scale.
template <class Rows>
cudaError_t run(Params p, int B, int dtype, float scale, int cluster, int variant,
                cudaStream_t s) {
  const int elem = dtype == kFloat32 ? 4 : dtype == kBFloat16 ? 2 : 0;
  if (elem == 0 || B < 1 || p.KV < 1 || p.H % p.KV != 0 || p.cap < 1) return cudaErrorInvalidValue;
  p.GT = p.H / p.KV;
  p.ngrp = (p.GT + MAX_GROUP - 1) / MAX_GROUP;
  p.G = block_group(p.GT);
  if (p.KV * p.ngrp > 65535 || p.hd < 1 || p.hd > MAX_HD) return cudaErrorInvalidValue;
  p.hs = row_floats(p.hd, elem);
  p.vec_rows = (p.hd * elem) % 16 == 0;
  if (reinterpret_cast<uintptr_t>(p.k) % 16 != 0 || reinterpret_cast<uintptr_t>(p.v) % 16 != 0)
    return cudaErrorMisalignedAddress;
  if (cluster < 1 || cluster > MAX_CLUSTER || (cluster & (cluster - 1)) != 0)
    return cudaErrorInvalidValue;
  if (variant == kMma && (dtype != kBFloat16 || !is_mma_head_dim(p.hd) || !p.vec_rows))
    return cudaErrorInvalidValue;
  if (variant != kMma && variant != kSimt) return cudaErrorInvalidValue;
  p.qscale = scale * LOG2E;
  if (variant == kMma)
    return dispatch_mma(p.hd, p.G, [&](auto, auto hdp, auto gmax) {
      constexpr int H = decltype(hdp)::value, M = decltype(gmax)::value;
      return launch_kernel<__nv_bfloat16, H, M, Rows, true>(p, B, cluster, s);
    });
  return dispatch(dtype, p.hd, p.G, [&](auto t, auto hdp, auto gmax) {
    constexpr int H = decltype(hdp)::value, M = decltype(gmax)::value;
    return launch_kernel<decltype(t), H, M, Rows, false>(p, B, cluster, s);
  });
}

}  // namespace

}  // namespace decode
}  // namespace repro
