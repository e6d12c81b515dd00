// Gradient of the chunkwise gated linear recurrence, hand-written CUDA C++
// for Hopper (sm_90a).
//
//   S_t = a_t * S_{t-1} + k_t^T v_t ;  y_t = q_t @ S_t ;  a_t = exp(log_a_t)
//
// Replaces no Pallas kernel: the reference's `gated_linear_scan` Pallas kernel
// (`repro/kernels/linear_scan.py`) has no VJP, and the reference trains
// through `jax.vjp` of its jnp oracle (`repro/kernels/ref.py::gated_linear_scan`,
// `use_pallas=False`). This is that gradient on the card, so that xlstm's
// mLSTM and zamba2's Mamba2 layers train through a kernel
// (`kernels/linear_scan.py::GatedLinearScanFn`).
//
// Inputs: the forward's q, k: (B, H, S, dk), v: (B, H, S, dv) (fp32 or bf16,
// by their strides; q may be a stride-0 broadcast over H), log_a (B, H, S)
// fp32, the optional fp32 initial state (B, H, dk, dv); the gradients of y
// (dy, strided, q's dtype) and of the final state (dS, contiguous fp32), each
// null for zeros. With the mLSTM's normaliser the scan runs over the
// extended value matrix [v | 1], as the forward does: its dy column is dnrm
// (B, H, S), its final-state column dn (B, H, dk), its initial column init_n.
// Outputs: dq, dk (q's dtype), dv (contiguous, q's dtype; the normaliser
// column's dv is dropped), dlog_a (B, H, S) fp32, d(initial state) and
// d(initial normaliser) (fp32), when asked for.
//
// dlog_a comes from the identity dA_t = q_t . dq_t - k_t . dk_t (plus
// <dS, S_final> at the last position), dlog_a_t = sum_{i >= t} dA_i: the
// derivative of every term of y and of the final state with respect to the
// cumulative log decay A_t, so no block needs the reverse carry and the
// forward state at once.
//
// Two variants, picked by an explicit rule in the wrapper
// (`kernels/linear_scan.py::backward_variant`):
//
// * `scan_bwd_mma_kernel` (bf16, dk <= 384, 16-byte rows, at most 8 column
//   tiles): the chunkwise form on the tensor cores. Per chunk of L = 16
//   positions, A the chunk's inclusive cumulative log decay (fp64, as the
//   forward), a_tot its last, Gamma_ij = exp(A_i - A_j) formed only for
//   j <= i, P = dY V^T o Gamma and R = Q K^T o Gamma:
//     forward walk  dq = P K + diag(e^A) dY S_prev^T,
//                   S  = e^a_tot S_prev + K^T diag(e^(a_tot - A)) V;
//     reverse walk  dk = P^T Q + diag(e^(a_tot - A)) V dS^T,
//                   dv = R^T dY + diag(e^(a_tot - A)) K dS,
//                   dS = e^a_tot dS + (diag(e^A) Q)^T dY, from the
//                   final-state gradient; d(initial state) is what it ends
//                   with.
//   The walks are independent, each a cluster of its own (the reverse walks
//   launched first): a block per tile of T extended columns (16, 32 or 64,
//   the wrapper's `backward_tile_columns`), the tiles of one (walk, b, h) a
//   thread-block cluster of at most 8. A block holds the dk x T slab of S
//   (or dS) in registers as mma.sync m16n8k16 accumulator fragments, warp w
//   rows 16 MT w .. 16 MT (w + 1); every product runs on the tensor cores,
//   q, k, v and dy exact in bf16 and every other operand (the slab, P, R, v
//   and dy scaled by the decays) as bf16 hi + lo halves; dv's operand dS^T
//   is the slab's halves transposed in registers (movmatrix), its sum over
//   the warps' rows in shared memory. The tiles' dq (dk) partials never
//   reach device memory: each chunk's go to a double-buffered buffer in
//   shared memory, and after a cluster barrier each rank adds a 1/R share of
//   the chunk's items over the R tiles in tile order (distributed shared
//   memory; no atomics, the same bits every run) and writes it in bf16. The
//   barrier of a chunk is waited out in the next, whose copies (cp.async,
//   two stages) and partial loads fly behind its products. Each tile's
//   share of q . dq and k . dk comes from the partials in registers.
//   Bounded at the paths' shapes by the chunk's latency (two warps a
//   sub-partition, three or four block barriers and a cluster barrier a
//   chunk) and by the halves' conversions, far more than by the tensor
//   cores (PERF.md).
//   Then `scan_bwd_mma_cumsum_kernel`: dlog_a as the reverse sum in fp64 of
//   the tiles' halves. Two launches a call.
// * `scan_bwd_walk_kernel` (`simt`: fp32, whose parity rests on exact FMA,
//   and the rest): a block per (32 extended columns, head, batch), a thread
//   per state row d holding row d of its 32 columns of S (the forward walk,
//   from the initial state) and then of G (the reverse walk, from dS) in
//   registers, walked position by position in fp32:
//     forward  S_t = a_t S_{t-1} + k_t^T v_t,      dq_t = dy_t S_t^T
//     reverse  G_t = [t = S-1 ? dS : a_{t+1} G_{t+1}] + q_t^T dy_t
//              dk_t = G_t v_t^T,  dv_t = k_t G_t,  d(init) = a_0 G_0
//   q_t[d], k_t[d] (a column a thread), v_t and dy_t of the block's columns
//   and a_t are staged in shared memory 16 positions at a time. dq_t[d] and
//   dk_t[d] are sums over the block's columns, written as fp32 partials, one
//   per column tile; dv_t (a sum over rows) is reduced in each warp by a
//   butterfly (31 shuffles), then over the warps in shared memory. Then
//   `scan_bwd_reduce_kernel` (a warp per position adds the tiles' partials
//   in tile order, writes dq and dk, forms dA_t) and
//   `scan_bwd_cumsum_kernel` (the reverse sum in fp64). Three launches a
//   call.
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"
#include "scan_core.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int kMaxDk = 1024;
constexpr int TW = 32;  // extended state columns a walk block owns: one per lane
constexpr int NP = 16;  // positions staged in shared memory at a time

struct Strides {
  long long b, h, s, d;
};

struct BwdArgs {
  const void* q;  // (B, H, S, dk)
  const void* k;
  const void* v;         // (B, H, S, dv)
  const float* la;       // (B, H, S)
  const float* init;     // (B, H, dk, dv) or null: zeros
  const float* init_n;   // (B, H, dk) or null: zeros (normaliser)
  const void* dy;        // (B, H, S, dv) or null: zeros
  const float* dS;       // (B, H, dk, dv) contiguous, or null: zeros
  const void* dnrm;      // (B, H, S) or null: zeros (normaliser)
  const float* dn;       // (B, H, dk) contiguous, or null: zeros (normaliser)
  bool norm;             // the extended column dv is the normaliser's
  void* dq;              // (B, H, S, dk) contiguous, q's dtype
  void* dk_out;          // (B, H, S, dk)
  void* dv_out;          // (B, H, S, dv)
  float* dla;            // (B, H, S)
  float* d_init;         // (B, H, dk, dv) or null: not asked for
  float* d_init_n;       // (B, H, dk) or null
  float* dq_part;        // (tiles, B, H, S, dk) fp32 scratch
  float* dk_part;        // (tiles, B, H, S, dk)
  float* fin_part;       // (tiles, B, H): <dS, S_final> over a tile's columns
  float* dA;             // (B, H, S) scratch (mma: (tiles, B, H, S), the q . dq halves)
  float* dAk;            // mma: (tiles, B, H, S) scratch, the k . dk halves
  int B, H, S, dk, dv, tiles;
  Strides qs, ks, vs, las, dys, dns;
};

// Extended column c of v at position s (c == dv: the normaliser's ones).
template <typename T>
__device__ __forceinline__ float v_at(const BwdArgs& a, const T* vb, int s, int c) {
  if (c < a.dv) return repro::to_float(vb[s * a.vs.s + c * a.vs.d]);
  return (c == a.dv && a.norm) ? 1.f : 0.f;
}

// Extended column c of dy at position s (c == dv: dnrm).
template <typename T>
__device__ __forceinline__ float dy_at(const BwdArgs& a, const T* dyb, const T* dnb, int s,
                                       int c) {
  if (c < a.dv) return dyb != nullptr ? repro::to_float(dyb[s * a.dys.s + c * a.dys.d]) : 0.f;
  if (c == a.dv && a.norm && dnb != nullptr) return repro::to_float(dnb[s * a.dns.s]);
  return 0.f;
}

// Row d, extended column c of a (B, H, dk, dv) fp32 state and its
// normaliser column (B, H, dk), or 0.
__device__ __forceinline__ float state_at(const BwdArgs& a, const float* st, const float* st_n,
                                          size_t bh, int d, int c) {
  if (d >= a.dk) return 0.f;
  if (c < a.dv) return st != nullptr ? st[(bh * a.dk + d) * a.dv + c] : 0.f;
  if (c == a.dv && a.norm && st_n != nullptr) return st_n[bh * a.dk + d];
  return 0.f;
}

// Sums kd * g[c] over the warp's 32 lanes for every column c, leaving column
// `lane`'s sum in the result: at each step a lane keeps the half of its
// columns whose index bit matches its own lane bit and adds its partner's
// copy of that half (the first step forms the products as it goes).
__device__ __forceinline__ float reduce_scatter32(const float (&g)[TW], float kd, int lane) {
  float x[TW / 2];
  const bool top = (lane & (TW / 2)) != 0;
#pragma unroll
  for (int j = 0; j < TW / 2; ++j) {
    const float lo = kd * g[j], hi = kd * g[j + TW / 2];
    x[j] = (top ? hi : lo) + __shfl_xor_sync(FULL, top ? lo : hi, TW / 2);
  }
#pragma unroll
  for (int off = TW / 4; off >= 1; off >>= 1) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int j = 0; j < off; ++j) {
      const float send = upper ? x[j] : x[j + off];
      const float keep = upper ? x[j + off] : x[j];
      x[j] = keep + __shfl_xor_sync(FULL, send, off);
    }
  }
  return x[0];
}

// Shared memory of a walk block of `threads` threads: v and dy of NP
// positions x TW columns, a_t of NP positions, the warps' dv partials, and
// q and k of NP positions, a column per thread.
__host__ __device__ inline size_t walk_smem_bytes(int threads) {
  return sizeof(float) * (2 * size_t(NP) * TW + NP + size_t(NP) * (threads / 32) * TW +
                          2 * size_t(NP) * threads);
}

template <typename T, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB) scan_bwd_walk_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int j0 = tile * TW;
  const size_t bh = size_t(b) * a.H + h;
  const int d = threadIdx.x, lane = d & 31, warp = d >> 5, warps = blockDim.x >> 5;
  const bool row = d < a.dk;
  float* vsm = smem;                // [NP][TW]
  float* dysm = vsm + NP * TW;      // [NP][TW]
  float* asm_ = dysm + NP * TW;     // [NP]
  float* red = asm_ + NP;           // [NP][warps][TW]
  float* qsm = red + NP * warps * TW;  // [NP][blockDim.x]: q_t[d] of the stage
  float* ksm = qsm + NP * blockDim.x;  // [NP][blockDim.x]: k_t[d]

  const T* qb = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h;
  const float* lb = a.la + b * a.las.b + h * a.las.h;
  const T* dyb = a.dy != nullptr ? static_cast<const T*>(a.dy) + b * a.dys.b + h * a.dys.h
                                 : nullptr;
  const T* dnb = a.dnrm != nullptr ? static_cast<const T*>(a.dnrm) + b * a.dns.b + h * a.dns.h
                                   : nullptr;
  const size_t part = (size_t(tile) * a.B * a.H + bh) * a.S;  // this tile's partial rows

  // v, dy, a_t and (with_q) q_t[d], k_t[d] of positions t0 .. t0 + np - 1
  // into shared memory
  auto stage = [&](int t0, int np, bool with_q) {
    for (int idx = threadIdx.x; idx < NP * TW; idx += blockDim.x) {
      const int i = idx / TW, c = idx % TW;
      vsm[idx] = i < np ? v_at<T>(a, vb, t0 + i, j0 + c) : 0.f;
      dysm[idx] = i < np ? dy_at<T>(a, dyb, dnb, t0 + i, j0 + c) : 0.f;
    }
    if (threadIdx.x < NP)
      asm_[threadIdx.x] = threadIdx.x < np ? expf(lb[(t0 + threadIdx.x) * a.las.s]) : 1.f;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const bool on = row && i < np;
      ksm[i * blockDim.x + d] = on ? repro::to_float(kb[(t0 + i) * a.ks.s + d * a.ks.d]) : 0.f;
      if (with_q)
        qsm[i * blockDim.x + d] = on ? repro::to_float(qb[(t0 + i) * a.qs.s + d * a.qs.d]) : 0.f;
    }
  };

  // ---- forward walk: S_t row d, dq_t[d] over this tile's columns -------------
  float s[TW];
#pragma unroll
  for (int c = 0; c < TW; ++c) s[c] = state_at(a, a.init, a.init_n, bh, d, j0 + c);
  for (int t0 = 0; t0 < a.S; t0 += NP) {
    const int np = min(NP, a.S - t0);
    __syncthreads();  // the previous positions' readers are done
    stage(t0, np, false);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (i < np) {
        const float at = asm_[i], kd = ksm[i * blockDim.x + d];
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < TW; ++c) {
          s[c] = fmaf(at, s[c], kd * vsm[i * TW + c]);
          acc = fmaf(s[c], dysm[i * TW + c], acc);
        }
        if (row) a.dq_part[(part + t0 + i) * a.dk + d] = acc;
      }
    }
  }
  // <dS, S_final> over this tile's columns: row d's share, then the block's
  {
    float fin = 0.f;
#pragma unroll
    for (int c = 0; c < TW; ++c) fin = fmaf(state_at(a, a.dS, a.dn, bh, d, j0 + c), s[c], fin);
    fin = repro::warp_sum(fin);
    __syncthreads();
    if (lane == 0) red[warp] = fin;
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.f;
      for (int w = 0; w < warps; ++w) total += red[w];
      a.fin_part[size_t(tile) * a.B * a.H + bh] = total;
    }
  }

  // ---- reverse walk: G_t row d; dk_t[d] partial; dv_t of this tile ----------
  float g[TW];
#pragma unroll
  for (int c = 0; c < TW; ++c) g[c] = state_at(a, a.dS, a.dn, bh, d, j0 + c);
  for (int t1 = a.S; t1 > 0; t1 -= NP) {
    const int t0 = max(0, t1 - NP), np = t1 - t0;
    __syncthreads();  // the previous positions' readers (red, the stage) are done
    stage(t0, np, true);
    __syncthreads();
#pragma unroll
    for (int i = NP - 1; i >= 0; --i) {
      if (i < np) {  // block-uniform: every lane takes part in the butterfly
        const float qd = qsm[i * blockDim.x + d];
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < TW; ++c) {
          g[c] = fmaf(qd, dysm[i * TW + c], g[c]);  // G_t
          acc = fmaf(g[c], vsm[i * TW + c], acc);
        }
        if (row) a.dk_part[(part + t0 + i) * a.dk + d] = acc;
        red[(i * warps + warp) * TW + lane] = reduce_scatter32(g, ksm[i * blockDim.x + d], lane);
        const float at = asm_[i];
#pragma unroll
        for (int c = 0; c < TW; ++c) g[c] *= at;  // a_t G_t, the next position's carry
      }
    }
    __syncthreads();
    // dv of these positions: the warps' partials added in warp order
    for (int idx = threadIdx.x; idx < np * TW; idx += blockDim.x) {
      const int i = idx / TW, c = idx % TW;
      float x = 0.f;
      for (int w = 0; w < warps; ++w) x += red[(i * warps + w) * TW + c];
      if (j0 + c < a.dv)
        static_cast<T*>(a.dv_out)[(bh * a.S + t0 + i) * a.dv + j0 + c] = repro::from_float<T>(x);
    }
  }
  // d(initial state) = a_0 G_0, what the walk ends with
  if (row) {
#pragma unroll
    for (int c = 0; c < TW; ++c) {
      const int col = j0 + c;
      if (col < a.dv && a.d_init != nullptr)
        a.d_init[(bh * a.dk + d) * a.dv + col] = g[c];
      else if (col == a.dv && a.norm && a.d_init_n != nullptr)
        a.d_init_n[bh * a.dk + d] = g[c];
    }
  }
}

constexpr int RW = 8;  // reduce kernel: warps a block, one position each

template <typename T>
__global__ void __launch_bounds__(RW * 32) scan_bwd_reduce_kernel(const BwdArgs a) {
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = size_t(b) * a.H + h;
  const int lane = threadIdx.x & 31, t = blockIdx.x * RW + (threadIdx.x >> 5);
  if (t >= a.S) return;  // warp-uniform
  const T* qb = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
  const size_t tile_stride = size_t(a.B) * a.H * a.S * a.dk;
  const size_t row = (bh * a.S + t) * a.dk;
  float dA = 0.f;
  for (int d = lane; d < a.dk; d += 32) {
    float gq = 0.f, gk = 0.f;
    for (int tile = 0; tile < a.tiles; ++tile) {
      gq += a.dq_part[tile * tile_stride + row + d];
      gk += a.dk_part[tile * tile_stride + row + d];
    }
    static_cast<T*>(a.dq)[row + d] = repro::from_float<T>(gq);
    static_cast<T*>(a.dk_out)[row + d] = repro::from_float<T>(gk);
    dA = fmaf(repro::to_float(qb[t * a.qs.s + d * a.qs.d]), gq, dA);
    dA = fmaf(-repro::to_float(kb[t * a.ks.s + d * a.ks.d]), gk, dA);
  }
  dA = repro::warp_sum(dA);
  if (lane == 0) {
    if (t == a.S - 1)
      for (int tile = 0; tile < a.tiles; ++tile) dA += a.fin_part[size_t(tile) * a.B * a.H + bh];
    a.dA[bh * a.S + t] = dA;
  }
}

// dlog_a_t = sum_{i >= t} dA_i, in fp64: one warp per (b, h).
__global__ void __launch_bounds__(32) scan_bwd_cumsum_kernel(const BwdArgs a) {
  const size_t bh = size_t(blockIdx.y) * a.H + blockIdx.x;
  const int lane = threadIdx.x;
  double carry = 0.0;  // the sum over the positions after this chunk
  for (int c0 = (a.S - 1) / 32 * 32; c0 >= 0; c0 -= 32) {
    const int t = c0 + lane;
    double x = t < a.S ? double(a.dA[bh * a.S + t]) : 0.0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double y = __shfl_down_sync(FULL, x, off);
      if (lane + off < 32) x += y;
    }
    if (t < a.S) a.dla[bh * a.S + t] = float(x + carry);
    carry += __shfl_sync(FULL, x, 0);  // lane 0 holds the chunk's total
  }
}

template <typename T, int MAXT, int MINB>
cudaError_t launch_walk(const BwdArgs& a, int threads, cudaStream_t stream) {
  auto kernel = scan_bwd_walk_kernel<T, MAXT, MINB>;
  const size_t bytes = walk_smem_bytes(threads);
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(a.tiles, a.H, a.B), threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  const int threads = (a.dk + 31) / 32 * 32;
  // up to xlstm's 384 rows, two blocks an SM (<= 85 registers a thread):
  // xlstm's 13 x 16 blocks then run in one wave of an H100's 132 SMs
  cudaError_t err = threads <= 384 ? launch_walk<T, 384, 2>(a, threads, stream)
                                   : launch_walk<T, 1024, 1>(a, threads, stream);
  if (err != cudaSuccess) return err;
  scan_bwd_reduce_kernel<T><<<dim3((a.S + RW - 1) / RW, a.H, a.B), RW * 32, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_bwd_cumsum_kernel<<<dim3(a.H, a.B), 32, 0, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// scan_bwd_mma_kernel: the chunkwise gradient on the tensor cores
// ---------------------------------------------------------------------------

namespace mmab {

using bf16 = __nv_bfloat16;
using repro::scan::cp_async16;
using repro::scan::cp_async4;
using repro::scan::cp_async_commit;
using repro::scan::cp_async_wait;
using repro::scan::split2;
using repro::sm80::ldsm_x2;
using repro::sm80::ldsm_x2_t;
using repro::sm80::ldsm_x4;
using repro::sm80::ldsm_x4_t;
using repro::sm80::mma_bf16;
using repro::sm80::movmatrix_t;

constexpr int L = 16;          // positions per chunk
constexpr int PST = L + 8;     // bf16 row stride of the score tiles (48 bytes)
constexpr int MAX_DK = 384;
constexpr int MAX_TILES = 8;   // column tiles of one (b, h): one cluster, portable size

// NW warps, each owning MT m16 tiles of dk rows of the state; N8 n8 tiles of
// extended state columns a block.
template <int NW, int MT, int N8>
struct Geo {
  static constexpr int NT = 32 * NW;
  static constexpr int DKP = 16 * MT * NW;  // dk padded: rows past dk are zero
  static constexpr int KS = DKP / 16;       // k16 steps of dk
  static constexpr int T = 8 * N8;          // extended state columns a block owns
  static constexpr int KC = T / 16;         // k16 steps (m16 tiles) of the block's columns
  static constexpr int QST = DKP + 8;       // bf16 row stride of q, k (odd count of 16 bytes)
  static constexpr int VST = T + 8;         // bf16 row stride of v, dy and their scaled copies
  static constexpr int PRT = DKP + 4;       // fp32 row stride of a dq / dk partial
  static constexpr int DVS = T + 4;         // fp32 row stride of a warp's dv partial
  static constexpr int RK = NW >= 8 ? 3 : 1;  // dk ranges of the Q K^T score tiles
};

constexpr size_t al16(size_t x) { return (x + 15) / 16 * 16; }

// Byte offsets of the shared-memory regions: two stages of a chunk's q, k
// (all of dk), v, dy (the block's columns) and log_a; the gated scores P
// and R (bf16 hi and lo halves); R's partials over dk ranges; the scaled v
// or dy (hi and lo); the two dq / dk partial buffers the cluster reads; the
// warps' dv partials; the warps' shares of the dA halves; their sums of
// <dS, S_final>.
template <int NW, int MT, int N8>
struct Lay {
  using G = Geo<NW, MT, N8>;
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + al16(2 * L * G::QST);
  static constexpr size_t V = K + al16(2 * L * G::QST);
  static constexpr size_t DY = V + al16(2 * L * G::VST);
  static constexpr size_t LA = DY + al16(2 * L * G::VST);
  static constexpr size_t STAGE = LA + al16(4 * L);
  static constexpr size_t PH = 2 * STAGE;
  static constexpr size_t PL = PH + al16(2 * L * PST);
  static constexpr size_t RH = PL + al16(2 * L * PST);
  static constexpr size_t RL = RH + al16(2 * L * PST);
  static constexpr size_t RP = RL + al16(2 * L * PST);
  static constexpr size_t WH = RP + al16(4 * G::RK * L * L);
  static constexpr size_t WL = WH + al16(2 * L * G::VST);
  static constexpr size_t PART = WL + al16(2 * L * G::VST);
  static constexpr size_t PART_BYTES = al16(4 * L * G::PRT);
  static constexpr size_t DVR = PART + 2 * PART_BYTES;
  static constexpr size_t DOTW = DVR + al16(4 * size_t(NW) * L * G::DVS);
  static constexpr size_t FIN = DOTW + al16(4 * size_t(NW) * L);
  static constexpr size_t TOTAL = FIN + al16(4 * NW);
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  mma_bf16(d, a[0], a[1], a[2], a[3], b0, b1);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ float gate(float x, double ai, double aj, bool on) {
  return on ? x * expf(float(ai - aj)) : 0.f;
}

// Scales the columns (positions i = 8 ni + c2 (+1)) of [m][2][4] accumulator
// fragments by the per-position factor f (lane i holds f_i).
template <int M>
__device__ __forceinline__ void scale_cols(float (&acc)[M][2][4], float f, int c2) {
  const float f0 = __shfl_sync(FULL, f, c2), f1 = __shfl_sync(FULL, f, c2 + 1);
  const float f8 = __shfl_sync(FULL, f, c2 + 8), f9 = __shfl_sync(FULL, f, c2 + 9);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    acc[m][0][0] *= f0;
    acc[m][0][1] *= f1;
    acc[m][0][2] *= f0;
    acc[m][0][3] *= f1;
    acc[m][1][0] *= f8;
    acc[m][1][1] *= f9;
    acc[m][1][2] *= f8;
    acc[m][1][3] *= f9;
  }
}

__device__ __forceinline__ void add4(float4& x, const float4& y) {
  x.x += y.x;
  x.y += y.y;
  x.z += y.z;
  x.w += y.w;
}

// x as four bf16 at dst (8-byte aligned).
__device__ __forceinline__ void store_bf16x4(const float4& x, bf16* dst) {
  __nv_bfloat162 o01 = __floats2bfloat162_rn(x.x, x.y), o23 = __floats2bfloat162_rn(x.z, x.w);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&o01);
  packed.y = *reinterpret_cast<uint32_t*>(&o23);
  *reinterpret_cast<uint2*>(dst) = packed;
}

// The sum of y[0 .. R) in order, as four bf16 at dst.
__device__ __forceinline__ void store_sum(const float4 (&y)[MAX_TILES], int R, bf16* dst) {
  float4 x = y[0];
#pragma unroll
  for (int r = 1; r < MAX_TILES; ++r)
    if (r < R) add4(x, y[r]);
  store_bf16x4(x, dst);
}

// One block per (tile of T extended state columns, head, batch); the tiles
// of one (b, h) are one cluster (rank = tile). Warp w owns state rows
// d0w .. d0w + 16 MT of the block's columns: the slab s (S in the forward
// walk, the reverse carry dS after it) as m16n8 accumulator fragments,
// rows d = d0w + 16 m + g (+ 8), columns c = j0 + 8 n + c2 (+ 1).
template <int NW, int MT, int N8>
__global__ void __launch_bounds__(32 * NW, NW >= 8 ? 1 : 4)
    scan_bwd_mma_kernel(const BwdArgs a) {
  using G = Geo<NW, MT, N8>;
  using Y = Lay<NW, MT, N8>;
  constexpr int NT = G::NT, DKP = G::DKP, KS = G::KS, T = G::T, KC = G::KC;
  constexpr int QST = G::QST, VST = G::VST, PRT = G::PRT, DVS = G::DVS, RK = G::RK;
  // the warps of the P score tiles: the last two (with 2 warps, both, after
  // the other jobs)
  constexpr int PW = NW >= 4 ? NW - 2 : 0;
  extern __shared__ __align__(16) unsigned char sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int R = static_cast<int>(cluster.dim_blocks().x);
  const int rank = static_cast<int>(cluster.block_rank());
  // blockIdx.z < B: the reverse walk of batch b = z, else the forward walk
  // of b = z - B: the longer walks first, as the card takes clusters in order
  const int walk = blockIdx.z < a.B ? 1 : 0;
  const int j0 = rank * T, h = blockIdx.y, b = blockIdx.z - (walk ? 0 : a.B);
  const size_t bh = size_t(b) * a.H + h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = 2 * (lane & 3);  // fragment row, column pair
  const int mr = lane & 7, mj = lane >> 3;       // ldmatrix: row this lane addresses, matrix
  const int d0w = warp * 16 * MT;
  const int dve = a.dv + (a.norm ? 1 : 0);
  const int nch = (a.S + L - 1) / L;

  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.vs.b + h * a.vs.h;
  const float* lg = a.la + b * a.las.b + h * a.las.h;
  const bf16* yg = a.dy != nullptr ? static_cast<const bf16*>(a.dy) + b * a.dys.b + h * a.dys.h
                                   : nullptr;
  const bf16* ng = a.dnrm != nullptr
                       ? static_cast<const bf16*>(a.dnrm) + b * a.dns.b + h * a.dns.h
                       : nullptr;
  bf16* Ph = reinterpret_cast<bf16*>(sm + Y::PH);
  bf16* Pl = reinterpret_cast<bf16*>(sm + Y::PL);
  bf16* Rh = reinterpret_cast<bf16*>(sm + Y::RH);
  bf16* Rl = reinterpret_cast<bf16*>(sm + Y::RL);
  float* Rp = reinterpret_cast<float*>(sm + Y::RP);
  bf16* Wh = reinterpret_cast<bf16*>(sm + Y::WH);
  bf16* Wl = reinterpret_cast<bf16*>(sm + Y::WL);
  float* Part = reinterpret_cast<float*>(sm + Y::PART);
  float* Dvr = reinterpret_cast<float*>(sm + Y::DVR);
  float* DotW = reinterpret_cast<float*>(sm + Y::DOTW);
  float* Fin = reinterpret_cast<float*>(sm + Y::FIN);

  // whether the n8 tile n of the block's columns holds an extended column
  // (block-uniform: the products of empty tiles are skipped)
  auto col8 = [&](int n) { return j0 + 8 * n < dve; };

  // chunk t's q, k, v, dy, log_a into stage st: cp.async for what exists,
  // plain stores of zeros (and of the normaliser's ones and dnrm) for the
  // rest; rows past S are zero and decay by exp(0) = 1
  auto issue = [&](int t, int st) {
    const int c0 = t * L, nv = min(L, a.S - c0);
    unsigned char* base = sm + st * Y::STAGE;
    bf16* qs = reinterpret_cast<bf16*>(base + Y::Q);
    bf16* ks = reinterpret_cast<bf16*>(base + Y::K);
    bf16* vs = reinterpret_cast<bf16*>(base + Y::V);
    bf16* ys = reinterpret_cast<bf16*>(base + Y::DY);
    float* ls = reinterpret_cast<float*>(base + Y::LA);
    constexpr int NCH = DKP / 8;
    for (int idx = tid; idx < L * NCH; idx += NT) {
      const int i = idx / NCH, ch = idx - i * NCH;
      const bool on = i < nv && 8 * ch < a.dk;
      bf16* dk_ = ks + i * QST + 8 * ch;
      bf16* dq_ = qs + i * QST + 8 * ch;
      if (on) {
        cp_async16(dk_, kg + (c0 + i) * a.ks.s + 8 * ch);
        cp_async16(dq_, qg + (c0 + i) * a.qs.s + 8 * ch);
      } else {
        *reinterpret_cast<uint4*>(dk_) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dq_) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    constexpr int VCH = T / 8;
    for (int idx = tid; idx < L * VCH; idx += NT) {
      const int i = idx / VCH, cc = idx - i * VCH, c = j0 + 8 * cc;
      bf16* dv_ = vs + i * VST + 8 * cc;
      bf16* dy_ = ys + i * VST + 8 * cc;
      if (i < nv && c < a.dv) {
        cp_async16(dv_, vg + (c0 + i) * a.vs.s + c);
        if (yg != nullptr)
          cp_async16(dy_, yg + (c0 + i) * a.dys.s + c);
        else
          *reinterpret_cast<uint4*>(dy_) = make_uint4(0u, 0u, 0u, 0u);
      } else {
        // the normaliser's column (the first of its 8): v = 1 (bf16 0x3f80), dy = dnrm
        const bool ncol = i < nv && c == a.dv && a.norm;
        const unsigned one = ncol ? 0x3f80u : 0u;
        const unsigned dn = ncol && ng != nullptr ? __bfloat16_as_ushort(ng[(c0 + i) * a.dns.s])
                                                  : 0u;
        *reinterpret_cast<uint4*>(dv_) = make_uint4(one, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dy_) = make_uint4(dn, 0u, 0u, 0u);
      }
    }
    if (tid < L) {
      if (tid < nv)
        cp_async4(ls + tid, lg + (c0 + tid) * a.las.s);
      else
        ls[tid] = 0.f;
    }
  };

  // lane i < L: A_i, the chunk's inclusive cumulative log decay, in fp64
  auto decay = [&](const float* La) {
    double A = lane < L ? double(La[lane]) : 0.0;
#pragma unroll
    for (int off = 1; off < L; off <<= 1) {
      const double n = __shfl_up_sync(FULL, A, off);
      if (lane >= off) A += n;
    }
    return A;
  };

  // P = (dY V^T o Gamma) over the block's columns, n8 tile pn of its 16 x 16:
  // row i (the later position), column j; exp(A_i - A_j) formed only for
  // j <= i; bf16 hi and lo halves into Ph, Pl [i][j]
  auto score_p = [&](const bf16* DY, const bf16* V, int pn, double A) {
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      if (col8(2 * kc)) {
        uint32_t aa[4], bb[2];
        ldsm_x4(aa, DY + (8 * (mj & 1) + mr) * VST + 16 * kc + 8 * (mj >> 1));
        ldsm_x2(bb, V + (8 * pn + mr) * VST + 16 * kc + 8 * (mj & 1));
        mma(acc[kc & 1], aa, bb[0], bb[1]);
      }
    }
    const int i = g, j = 8 * pn + c2;
    const double Ai = __shfl_sync(FULL, A, i), Ai8 = __shfl_sync(FULL, A, i + 8);
    const double Aj = __shfl_sync(FULL, A, j), Aj1 = __shfl_sync(FULL, A, j + 1);
    uint32_t hi, lo;
    split2(gate(acc[0][0] + acc[1][0], Ai, Aj, j <= i),
           gate(acc[0][1] + acc[1][1], Ai, Aj1, j + 1 <= i), hi, lo);
    *reinterpret_cast<uint32_t*>(Ph + i * PST + j) = hi;
    *reinterpret_cast<uint32_t*>(Pl + i * PST + j) = lo;
    split2(gate(acc[0][2] + acc[1][2], Ai8, Aj, j <= i + 8),
           gate(acc[0][3] + acc[1][3], Ai8, Aj1, j + 1 <= i + 8), hi, lo);
    *reinterpret_cast<uint32_t*>(Ph + (i + 8) * PST + j) = hi;
    *reinterpret_cast<uint32_t*>(Pl + (i + 8) * PST + j) = lo;
  };

  // Wh, Wl [j][c] = X[j][c] * f_j as bf16 hi and lo (X: v or dy of the
  // block's columns; f: lane j holds f_j), by the warps w0 .. w0 + nw - 1
  auto scale_rows = [&](const bf16* X, float f, int w0, int nw) {
    constexpr int WCH = L * T / 8;
    const int nt = 32 * nw;
    for (int r = 0; r < (WCH + nt - 1) / nt; ++r) {
      const int idx = tid - 32 * w0 + r * nt;
      const int i = (idx / (T / 8)) % L, cc = idx % (T / 8);
      const float fi = __shfl_sync(FULL, f, i);
      if (idx < WCH) {
        const uint4 raw = *reinterpret_cast<const uint4*>(X + i * VST + 8 * cc);
        const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
          split2(__uint_as_float(w[p] << 16) * fi, __uint_as_float(w[p] & 0xffff0000u) * fi, hi[p],
                 lo[p]);
        *reinterpret_cast<uint4*>(Wh + i * VST + 8 * cc) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(Wl + i * VST + 8 * cc) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
  };

  // acc[m][ni] += (the slab as A: rows d, k = the block's columns) x X^T
  // (X [i][c] in shared memory: dy in the forward walk, v in the reverse),
  // the fp32 slab in bf16 hi and lo halves; all hi products, then all lo
  float s[MT][N8][4];
  auto slab_times = [&](float(&acc)[MT][2][4], const bf16* X) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      if (col8(2 * kc)) {
        uint32_t bx[4];
        ldsm_x4(bx, X + (8 * (mj >> 1) + mr) * VST + 16 * kc + 8 * (mj & 1));
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          split2(s[m][2 * kc][0], s[m][2 * kc][1], ah[m][0], al[m][0]);
          split2(s[m][2 * kc][2], s[m][2 * kc][3], ah[m][1], al[m][1]);
          split2(s[m][2 * kc + 1][0], s[m][2 * kc + 1][1], ah[m][2], al[m][2]);
          split2(s[m][2 * kc + 1][2], s[m][2 * kc + 1][3], ah[m][3], al[m][3]);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma(acc[m][0], ah[m], bx[0], bx[1]);
          mma(acc[m][1], ah[m], bx[2], bx[3]);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma(acc[m][0], al[m], bx[0], bx[1]);
          mma(acc[m][1], al[m], bx[2], bx[3]);
        }
      }
    }
  };

  // slab = e_tot slab + (A operands at[m]: rows d, k = the chunk's
  // positions) x W (Wh + Wl [j][c])
  auto slab_update = [&](const uint32_t(&at)[MT][4], float e_tot) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < N8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[m][n][e] *= e_tot;
#pragma unroll
    for (int np = 0; np < N8 / 2; ++np) {
      if (col8(2 * np)) {
        uint32_t bh_[4], bl_[4];
        const int off = (8 * (mj & 1) + mr) * VST + 16 * np + 8 * (mj >> 1);
        ldsm_x4_t(bh_, Wh + off);
        ldsm_x4_t(bl_, Wl + off);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma(s[m][2 * np], at[m], bh_[0], bh_[1]);
          mma(s[m][2 * np + 1], at[m], bh_[2], bh_[3]);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma(s[m][2 * np], at[m], bl_[0], bl_[1]);
          mma(s[m][2 * np + 1], at[m], bl_[2], bl_[3]);
        }
      }
    }
  };

  // The cluster's sum of the partials of chunk tp in buffer `buf`, this
  // rank's share: the float4 items [rank N / R, (rank + 1) N / R) of the
  // chunk's L x DKP / 4 (row i, 4-wide column group d), each the R tiles'
  // partials added in tile order (the same bits every run), written in bf16
  // to `out` (B, H, S, dk). `gather_begin` loads a thread's first item from
  // every rank (a thread has one at the paths' shapes) early, so that the
  // loads fly behind the chunk's products; `gather_end` sums any further
  // item, runs `then` (the caller's own partials and barrier arrival: its
  // release then waits on no store of this chunk's) and then sums and
  // stores the first. tp < 0: nothing to sum.
  constexpr int GN = L * DKP / 4, GD4 = DKP / 4;
  float4 gy[MAX_TILES];
  auto gather_items = [&](int tp) {
    const int lo = rank * GN / R, hi = (rank + 1) * GN / R;
    return tp >= 0 ? max(0, (hi - lo - tid + NT - 1) / NT) : 0;
  };
  auto gather_src = [&](int buf, int idx, int r) {
    const int i = idx / GD4, d = 4 * (idx - i * GD4);
    return *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(Part + size_t(buf) * (Y::PART_BYTES / 4) + i * PRT + d, r));
  };
  auto gather_on = [&](int tp, int idx) {
    const int i = idx / GD4, d = 4 * (idx - i * GD4);
    return i < min(L, a.S - tp * L) && d < a.dk;
  };
  auto gather_dst = [&](int tp, void* out, int idx) {
    const int i = idx / GD4, d = 4 * (idx - i * GD4);
    return static_cast<bf16*>(out) + (bh * a.S + tp * L + i) * a.dk + d;
  };
  auto gather_begin = [&](int tp, int buf) {
    const int idx = rank * GN / R + tid;
    if (gather_items(tp) > 0 && gather_on(tp, idx)) {
#pragma unroll
      for (int r = 0; r < MAX_TILES; ++r)
        if (r < R) gy[r] = gather_src(buf, idx, r);
    }
  };
  auto gather_end = [&](int tp, int buf, void* out, auto&& then) {
    const int n_items = gather_items(tp), idx0 = rank * GN / R + tid;
    for (int it = 1; it < n_items; ++it) {
      const int idx = idx0 + it * NT;
      if (gather_on(tp, idx)) {
        float4 x = gather_src(buf, idx, 0);
        for (int r = 1; r < R; ++r) add4(x, gather_src(buf, idx, r));
        store_bf16x4(x, gather_dst(tp, out, idx));
      }
    }
    then();
    if (n_items > 0 && gather_on(tp, idx0)) store_sum(gy, R, gather_dst(tp, out, idx0));
  };

  // hands this chunk's partial acc (rows d, columns i) to the cluster in
  // buffer buf, after this rank's share of the previous chunk's (tq >= 0,
  // buffer buf ^ 1), whose barrier was waited out and loads issued early in
  // this chunk (`gather_begin`)
  auto handoff = [&](const float(&acc)[MT][2][4], int buf, int tq, void* out) {
    gather_end(tq, buf ^ 1, out, [&] {
      float* P = Part + size_t(buf) * (Y::PART_BYTES / 4);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            P[(8 * ni + c2 + (e & 1)) * PRT + d0w + 16 * m + g + 8 * (e >> 1)] = acc[m][ni][e];
      cluster_arrive();
    });
  };

  // This tile's share of one half of dA: x_i . (the tile's partial of row
  // i), from the partial in registers and xa, the A fragments of X^T (rows
  // d, k = the chunk's positions), whose elements sit where acc's do; summed
  // over the warp's rows, then (`dots_out`, after a block barrier) over the
  // warps in order, one value a (tile, position) in dst (tiles, B, H, S).
  auto dots = [&](const float(&acc)[MT][2][4], const uint32_t(&xa)[MT][4]) {
    float p[4] = {0.f, 0.f, 0.f, 0.f};  // positions c2, c2 + 1, c2 + 8, c2 + 9
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      p[0] = fmaf(__uint_as_float(xa[m][0] << 16), acc[m][0][0], p[0]);
      p[1] = fmaf(__uint_as_float(xa[m][0] & 0xffff0000u), acc[m][0][1], p[1]);
      p[0] = fmaf(__uint_as_float(xa[m][1] << 16), acc[m][0][2], p[0]);
      p[1] = fmaf(__uint_as_float(xa[m][1] & 0xffff0000u), acc[m][0][3], p[1]);
      p[2] = fmaf(__uint_as_float(xa[m][2] << 16), acc[m][1][0], p[2]);
      p[3] = fmaf(__uint_as_float(xa[m][2] & 0xffff0000u), acc[m][1][1], p[3]);
      p[2] = fmaf(__uint_as_float(xa[m][3] << 16), acc[m][1][2], p[2]);
      p[3] = fmaf(__uint_as_float(xa[m][3] & 0xffff0000u), acc[m][1][3], p[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) p[e] += __shfl_xor_sync(FULL, p[e], off);
    if (lane < 4) {
      DotW[warp * L + c2] = p[0];
      DotW[warp * L + c2 + 1] = p[1];
      DotW[warp * L + c2 + 8] = p[2];
      DotW[warp * L + c2 + 9] = p[3];
    }
  };
  auto dots_out = [&](int c0, int nv, float* dst) {
    if (tid < nv) {
      float x = DotW[tid];
      for (int w = 1; w < NW; ++w) x += DotW[w * L + tid];
      dst[(size_t(rank) * a.B * a.H + bh) * a.S + c0 + tid] = x;
    }
  };

  // The two walks are independent (dq needs only forward-direction
  // quantities, dk and dv only reverse-direction ones): each is a cluster
  // of its own, so that twice as many clusters of about half the length
  // share the card.
  if (walk == 0) {
    // ---- forward walk: S from the initial state; dq partials -----------------
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < N8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[m][n][e] = state_at(a, a.init, a.init_n, bh, d0w + 16 * m + g + 8 * (e >> 1),
                                j0 + 8 * n + c2 + (e & 1));
    issue(0, 0);
    cp_async_commit();
    for (int t = 0; t < nch; ++t) {
      const int st = t & 1, c0 = t * L, nv = min(L, a.S - c0);
      cp_async_wait<0>();
      __syncthreads();
      if (t > 0) {  // the previous chunk's partials, from every rank
        cluster_wait();
        gather_begin(t - 1, st ^ 1);
      }
      const unsigned char* base = sm + st * Y::STAGE;
      const bf16* Q = reinterpret_cast<const bf16*>(base + Y::Q);
      const bf16* K = reinterpret_cast<const bf16*>(base + Y::K);
      const bf16* V = reinterpret_cast<const bf16*>(base + Y::V);
      const bf16* DY = reinterpret_cast<const bf16*>(base + Y::DY);
      const double A = decay(reinterpret_cast<const float*>(base + Y::LA));
      const double a_tot = __shfl_sync(FULL, A, L - 1);
      const float eA = expf(float(A)), gl = expf(float(a_tot - A)), e_tot = expf(float(a_tot));
      // P on the last two warps, Vsc = v exp(a_tot - A_j) on the others
      if (warp >= PW) score_p(DY, V, warp - PW, A);
      if (warp < PW || PW == 0) scale_rows(V, gl, 0, PW > 0 ? PW : NW);
      __syncthreads();
      // the next chunk's copies, behind this chunk's products (the stage was
      // last read in the previous chunk)
      if (t + 1 < nch) issue(t + 1, st ^ 1);
      cp_async_commit();

      // dq^T = exp(A_i) (S_prev dY^T) + K^T P^T, rows d of this warp
      float acc[MT][2][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][ni][e] = 0.f;
      slab_times(acc, DY);
      scale_cols<MT>(acc, eA, c2);
      uint32_t ak[MT][4];  // K^T: rows d, k = the chunk's positions
#pragma unroll
      for (int m = 0; m < MT; ++m)
        ldsm_x4_t(ak[m], K + (8 * (mj >> 1) + mr) * QST + d0w + 16 * m + 8 * (mj & 1));
      {
        uint32_t bh_[4], bl_[4];  // P^T: k = j, n = i, from P [i][j]
        const int off = (8 * (mj >> 1) + mr) * PST + 8 * (mj & 1);
        ldsm_x4(bh_, Ph + off);
        ldsm_x4(bl_, Pl + off);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma(acc[m][0], ak[m], bh_[0], bh_[1]);
          mma(acc[m][1], ak[m], bh_[2], bh_[3]);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma(acc[m][0], ak[m], bl_[0], bl_[1]);
          mma(acc[m][1], ak[m], bl_[2], bl_[3]);
        }
      }
      {
        uint32_t aq[MT][4];  // Q^T, for q . dq
#pragma unroll
        for (int m = 0; m < MT; ++m)
          ldsm_x4_t(aq[m], Q + (8 * (mj >> 1) + mr) * QST + d0w + 16 * m + 8 * (mj & 1));
        dots(acc, aq);
      }
      handoff(acc, t & 1, t - 1, a.dq);
      // S = exp(a_tot) S + K^T Vsc
      slab_update(ak, e_tot);
      __syncthreads();  // every read of this stage and of P, Wh, Wl is done
      dots_out(c0, nv, a.dA);
    }
    cp_async_wait<0>();
    cluster_wait();
    gather_begin(nch - 1, (nch - 1) & 1);
    gather_end(nch - 1, (nch - 1) & 1, a.dq, [] {});
    // <dS, S_final> over this tile's columns
    {
      float f = 0.f;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < N8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            f = fmaf(state_at(a, a.dS, a.dn, bh, d0w + 16 * m + g + 8 * (e >> 1),
                              j0 + 8 * n + c2 + (e & 1)),
                     s[m][n][e], f);
      f = repro::warp_sum(f);
      if (lane == 0) Fin[warp] = f;
      __syncthreads();
      if (tid == 0) {
        float total = 0.f;
        for (int w = 0; w < NW; ++w) total += Fin[w];
        a.fin_part[size_t(rank) * a.B * a.H + bh] = total;
      }
    }
  } else {
    // ---- reverse walk: the carry dS from the final-state gradient; dk
    // partials, dv, d(initial state) ------------------------------------------
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < N8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[m][n][e] = state_at(a, a.dS, a.dn, bh, d0w + 16 * m + g + 8 * (e >> 1),
                                j0 + 8 * n + c2 + (e & 1));
    issue(nch - 1, 0);
    cp_async_commit();
    for (int n_ = 0; n_ < nch; ++n_) {
      const int t = nch - 1 - n_, st = n_ & 1, c0 = t * L, nv = min(L, a.S - c0);
      cp_async_wait<0>();
      __syncthreads();
      if (n_ > 0) {  // the previous chunk's partials, from every rank
        cluster_wait();
        gather_begin(t + 1, st ^ 1);
      }
      const unsigned char* base = sm + st * Y::STAGE;
      const bf16* Q = reinterpret_cast<const bf16*>(base + Y::Q);
      const bf16* K = reinterpret_cast<const bf16*>(base + Y::K);
      const bf16* V = reinterpret_cast<const bf16*>(base + Y::V);
      const bf16* DY = reinterpret_cast<const bf16*>(base + Y::DY);
      const double A = decay(reinterpret_cast<const float*>(base + Y::LA));
      const double a_tot = __shfl_sync(FULL, A, L - 1);
      const float eA = expf(float(A)), gl = expf(float(a_tot - A)), e_tot = expf(float(a_tot));
      // the score tiles: R = Q K^T over dk ranges (partials), P over the
      // block's columns; dYsc = dy exp(A_j)
      for (int job = warp; job < 2 * RK + 2; job += NW) {
        if (job < 2 * RK) {
          const int rn = job & 1, kr = job >> 1;
          float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          const int k0 = KS * kr / RK, k1 = KS * (kr + 1) / RK;
#pragma unroll 4
          for (int ks = k0; ks < k1; ++ks) {
            uint32_t aa[4], bb[2];
            ldsm_x4(aa, Q + (8 * (mj & 1) + mr) * QST + 16 * ks + 8 * (mj >> 1));
            ldsm_x2(bb, K + (8 * rn + mr) * QST + 16 * ks + 8 * (mj & 1));
            mma(acc[(ks - k0) & 1], aa, bb[0], bb[1]);
          }
          float* o = Rp + kr * L * L;
          *reinterpret_cast<float2*>(o + g * L + 8 * rn + c2) =
              make_float2(acc[0][0] + acc[1][0], acc[0][1] + acc[1][1]);
          *reinterpret_cast<float2*>(o + (g + 8) * L + 8 * rn + c2) =
              make_float2(acc[0][2] + acc[1][2], acc[0][3] + acc[1][3]);
        } else {
          score_p(DY, V, job - 2 * RK, A);
        }
      }
      // dYsc = dy exp(A_j) on the warps of the P tiles (the lighter jobs)
      if (warp >= PW) scale_rows(DY, eA, PW, NW - PW);
      __syncthreads();
      if (t > 0) issue(t - 1, st ^ 1);  // the next chunk's copies, as in the forward walk
      cp_async_commit();
      // R: the dk ranges' partials added in order, gated, in bf16 hi and lo
#pragma unroll
      for (int r = 0; r < (L * L + NT - 1) / NT; ++r) {
        const int e = tid + r * NT, i = (e / L) % L, j = e % L;
        const double Ai = __shfl_sync(FULL, A, i), Aj = __shfl_sync(FULL, A, j);
        if (e < L * L) {
          float x = Rp[e];
#pragma unroll
          for (int kr = 1; kr < RK; ++kr) x += Rp[kr * L * L + e];
          const float v = gate(x, Ai, Aj, j <= i);
          const bf16 hi = __float2bfloat16(v);
          Rh[i * PST + j] = hi;
          Rl[i * PST + j] = __float2bfloat16(v - __bfloat162float(hi));
        }
      }
      __syncthreads();

      // dk^T = exp(a_tot - A_i) (dS V^T) + Q^T P, rows d of this warp
      float acc[MT][2][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][ni][e] = 0.f;
      slab_times(acc, V);
      scale_cols<MT>(acc, gl, c2);
      uint32_t aq[MT][4];  // Q^T: rows d, k = the chunk's positions
#pragma unroll
      for (int m = 0; m < MT; ++m)
        ldsm_x4_t(aq[m], Q + (8 * (mj >> 1) + mr) * QST + d0w + 16 * m + 8 * (mj & 1));
      {
        uint32_t bh_[4], bl_[4];  // P: k = j, n = i, from P [j][i]
        const int off = (8 * (mj & 1) + mr) * PST + 8 * (mj >> 1);
        ldsm_x4_t(bh_, Ph + off);
        ldsm_x4_t(bl_, Pl + off);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma(acc[m][0], aq[m], bh_[0], bh_[1]);
          mma(acc[m][1], aq[m], bh_[2], bh_[3]);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma(acc[m][0], aq[m], bl_[0], bl_[1]);
          mma(acc[m][1], aq[m], bl_[2], bl_[3]);
        }
      }
      {
        uint32_t ak[MT][4];  // K^T, for k . dk
#pragma unroll
        for (int m = 0; m < MT; ++m)
          ldsm_x4_t(ak[m], K + (8 * (mj >> 1) + mr) * QST + d0w + 16 * m + 8 * (mj & 1));
        dots(acc, ak);
      }
      handoff(acc, n_ & 1, n_ > 0 ? t + 1 : -1, a.dk_out);

      // dv^T = exp(a_tot - A_i) (dS^T K^T) + dY^T R over the block's columns:
      // this warp's rows d, as the A operand dS^T (columns c x rows d) by
      // transposing the slab's bf16 halves in registers; the chunk's intra
      // term added by one warp per output tile; the warps' partials summed in
      // shared memory
      float dva[KC][2][4];
#pragma unroll
      for (int mc = 0; mc < KC; ++mc)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) dva[mc][ni][e] = 0.f;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t bk[4];  // K^T: k = d, n = i, from K [i][d]
        ldsm_x4(bk, K + (8 * (mj >> 1) + mr) * QST + d0w + 16 * m + 8 * (mj & 1));
#pragma unroll
        for (int mc = 0; mc < KC; ++mc) {
          if (col8(2 * mc)) {
            uint32_t h[4], l[4];
            split2(s[m][2 * mc][0], s[m][2 * mc][1], h[0], l[0]);          // d 0-7, c 0-7
            split2(s[m][2 * mc + 1][0], s[m][2 * mc + 1][1], h[1], l[1]);  // d 0-7, c 8-15
            split2(s[m][2 * mc][2], s[m][2 * mc][3], h[2], l[2]);          // d 8-15, c 0-7
            split2(s[m][2 * mc + 1][2], s[m][2 * mc + 1][3], h[3], l[3]);  // d 8-15, c 8-15
            const uint32_t ah[4] = {movmatrix_t(h[0]), movmatrix_t(h[1]), movmatrix_t(h[2]),
                                    movmatrix_t(h[3])};
            const uint32_t al[4] = {movmatrix_t(l[0]), movmatrix_t(l[1]), movmatrix_t(l[2]),
                                    movmatrix_t(l[3])};
            mma(dva[mc][0], ah, bk[0], bk[1]);
            mma(dva[mc][1], ah, bk[2], bk[3]);
            mma(dva[mc][0], al, bk[0], bk[1]);
            mma(dva[mc][1], al, bk[2], bk[3]);
          }
        }
      }
      scale_cols<KC>(dva, gl, c2);
#pragma unroll
      for (int mc = 0; mc < KC; ++mc) {
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          if ((2 * mc + ni) % NW == warp && col8(2 * mc)) {
            uint32_t ay[4], rh[2], rl[2];  // dY^T: rows c, k = j; R: k = j, n = i
            ldsm_x4_t(ay, DY + (8 * (mj >> 1) + mr) * VST + 16 * mc + 8 * (mj & 1));
            ldsm_x2_t(rh, Rh + (8 * (mj & 1) + mr) * PST + 8 * ni);
            ldsm_x2_t(rl, Rl + (8 * (mj & 1) + mr) * PST + 8 * ni);
            mma(dva[mc][ni], ay, rh[0], rh[1]);
            mma(dva[mc][ni], ay, rl[0], rl[1]);
          }
        }
      }
      {
        float* D = Dvr + warp * L * DVS;
#pragma unroll
        for (int mc = 0; mc < KC; ++mc)
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              D[(8 * ni + c2 + (e & 1)) * DVS + 16 * mc + g + 8 * (e >> 1)] = dva[mc][ni][e];
      }
      // dS = exp(a_tot) dS + Q^T dYsc
      slab_update(aq, e_tot);
      __syncthreads();  // the dv partials are written; every read of this stage is done
      dots_out(c0, nv, a.dAk);
      for (int idx = tid; idx < L * T / 4; idx += NT) {
        const int i = idx / (T / 4), c = 4 * (idx % (T / 4)), col = j0 + c;
        if (i < nv && col < a.dv) {
          float4 x = *reinterpret_cast<const float4*>(Dvr + i * DVS + c);
          for (int w = 1; w < NW; ++w)
            add4(x, *reinterpret_cast<const float4*>(Dvr + (w * L + i) * DVS + c));
          store_bf16x4(x, static_cast<bf16*>(a.dv_out) + (bh * a.S + c0 + i) * a.dv + col);
        }
      }
    }
    cp_async_wait<0>();
    cluster_wait();
    gather_begin(0, (nch - 1) & 1);
    gather_end(0, (nch - 1) & 1, a.dk_out, [] {});
    // d(initial state): the carry after chunk 0
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < N8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = d0w + 16 * m + g + 8 * (e >> 1), c = j0 + 8 * n + c2 + (e & 1);
          if (d < a.dk) {
            if (c < a.dv && a.d_init != nullptr)
              a.d_init[(bh * a.dk + d) * a.dv + c] = s[m][n][e];
            else if (c == a.dv && a.norm && a.d_init_n != nullptr)
              a.d_init_n[bh * a.dk + d] = s[m][n][e];
          }
        }
  }
  // no block leaves while another still reads its partials
  cluster_arrive();
  cluster_wait();
}

// dlog_a_t = sum_{i >= t} dA_i in fp64, dA_i the tiles' q . dq halves less
// their k . dk halves (each in tile order), plus the tiles' <dS, S_final>
// at the last position: one warp per (b, h).
__global__ void __launch_bounds__(32) scan_bwd_mma_cumsum_kernel(const BwdArgs a) {
  const size_t bh = size_t(blockIdx.y) * a.H + blockIdx.x;
  const size_t bhs = size_t(a.B) * a.H * a.S;
  const int lane = threadIdx.x;
  float fin = 0.f;
  for (int r = 0; r < a.tiles; ++r) fin += a.fin_part[size_t(r) * a.B * a.H + bh];
  double carry = 0.0;
  for (int c0 = (a.S - 1) / 32 * 32; c0 >= 0; c0 -= 32) {
    const int t = c0 + lane;
    double x = 0.0;
    if (t < a.S) {
      for (int r = 0; r < a.tiles; ++r) x += double(a.dA[r * bhs + bh * a.S + t]);
      for (int r = 0; r < a.tiles; ++r) x -= double(a.dAk[r * bhs + bh * a.S + t]);
      if (t == a.S - 1) x += double(fin);
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double y = __shfl_down_sync(FULL, x, off);
      if (lane + off < 32) x += y;
    }
    if (t < a.S) a.dla[bh * a.S + t] = float(x + carry);
    carry += __shfl_sync(FULL, x, 0);
  }
}

template <int NW, int MT, int N8>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  auto kernel = scan_bwd_mma_kernel<NW, MT, N8>;
  constexpr size_t bytes = Lay<NW, MT, N8>::TOTAL;
  static const cudaError_t setup =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (setup != cudaSuccess) return setup;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.tiles, a.H, 2 * a.B);
  cfg.blockDim = dim3(32 * NW, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.tiles;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  const cudaError_t last = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (last != cudaSuccess) return last;
  scan_bwd_mma_cumsum_kernel<<<dim3(a.H, a.B), 32, 0, stream>>>(a);
  return cudaGetLastError();
}

// The instantiation for dk (rows: NW warps of MT m16 tiles) and `tile`
// state columns a block (N8 = tile / 8); the paths' dk, 384 and 64, are
// exact (no padded row).
template <int N8>
cudaError_t launch_dk(const BwdArgs& a, cudaStream_t stream) {
  if (a.dk <= 32) return launch<2, 1, N8>(a, stream);
  if (a.dk <= 64) return launch<4, 1, N8>(a, stream);
  if (a.dk <= 128) return launch<8, 1, N8>(a, stream);
  if (a.dk <= 256) return launch<8, 2, N8>(a, stream);
  return launch<8, 3, N8>(a, stream);
}

inline cudaError_t launch_tile(const BwdArgs& a, int tile, cudaStream_t stream) {
  if (tile == 16) return launch_dk<2>(a, stream);
  if (tile == 32) return launch_dk<4>(a, stream);
  if (tile == 64) return launch_dk<8>(a, stream);
  return cudaErrorInvalidValue;
}

// Clusters of `tiles` blocks the card can hold at once.
template <int NW, int MT, int N8>
int max_clusters(int tiles) {
  auto kernel = scan_bwd_mma_kernel<NW, MT, N8>;
  constexpr size_t bytes = Lay<NW, MT, N8>::TOTAL;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes)) !=
      cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, 1, 1);
  cfg.blockDim = dim3(32 * NW, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = tiles;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return n;
}

template <int N8>
int clusters_dk(int dk, int tiles) {
  if (dk <= 32) return max_clusters<2, 1, N8>(tiles);
  if (dk <= 64) return max_clusters<4, 1, N8>(tiles);
  if (dk <= 128) return max_clusters<8, 1, N8>(tiles);
  if (dk <= 256) return max_clusters<8, 2, N8>(tiles);
  return max_clusters<8, 3, N8>(tiles);
}

template <int N8>
size_t smem_dk(int dk) {
  if (dk <= 32) return Lay<2, 1, N8>::TOTAL;
  if (dk <= 64) return Lay<4, 1, N8>::TOTAL;
  if (dk <= 128) return Lay<8, 1, N8>::TOTAL;
  if (dk <= 256) return Lay<8, 2, N8>::TOTAL;
  return Lay<8, 3, N8>::TOTAL;
}

}  // namespace mmab

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// What the tensor-core kernel's 16-byte row copies and its cluster assume
// (the wrapper's `linear_scan.backward_variant` checks the same first).
bool mma_layout_ok(const BwdArgs& a) {
  const Strides* all[3] = {&a.qs, &a.ks, &a.vs};
  for (const Strides* s : all)
    if (s->d != 1 || s->b % 8 || s->h % 8 || s->s % 8) return false;
  if (a.dy != nullptr &&
      (a.dys.d != 1 || a.dys.b % 8 || a.dys.h % 8 || a.dys.s % 8 || !aligned16(a.dy)))
    return false;
  return a.dk <= mmab::MAX_DK && a.dk % 8 == 0 && a.dv % 8 == 0 && aligned16(a.q) &&
         aligned16(a.k) && aligned16(a.v) && a.tiles <= mmab::MAX_TILES;
}

}  // namespace

enum Variant : int { kSimt = 0, kMma = 1 };

// C entry point. q, k: (B, H, S, dk), v: (B, H, S, dv) of one dtype (0 fp32,
// 1 bf16), log_a (B, H, S) fp32, dy (B, H, S, dv) and dnrm (B, H, S) in q's
// dtype, each by its element strides (dy, dnrm may be null: zeros); init,
// dS: contiguous fp32 (B, H, dk, dv), init_n, dn: contiguous fp32 (B, H, dk),
// each may be null (zeros). norm != 0: the normaliser column. Outputs, all
// contiguous: dq, dk_out (B, H, S, dk) and dv (B, H, S, dv) in q's dtype,
// dlog_a (B, H, S) fp32, d_init (B, H, dk, dv) and d_init_n (B, H, dk) fp32
// (null: not written). variant 0 (`simt`, the per-position walks; three
// launches): scratch of 2 tiles B H S dk + tiles B H + B H S fp32 elements,
// tiles = ceil((dv + norm) / 32). Variant 1 (`mma`, bf16, the chunkwise
// walks on the tensor cores, `tile` of 16, 32 or 64 extended columns a
// block and at most 8 tiles; two launches): scratch of 2 tiles B H S +
// tiles B H fp32 elements, tiles = ceil((dv + norm) / tile)
// (`linear_scan.py::backward_scratch_elements`). Launches on `stream`;
// returns the first failing launch's cudaError_t, or 0.
extern "C" int gated_linear_scan_bwd(
    const void* q, const void* k, const void* v, const void* log_a, const void* init,
    const void* init_n, const void* dy, const void* dS, const void* dnrm, const void* dn,
    void* dq, void* dk_out, void* dv_out, void* dlog_a, void* d_init, void* d_init_n, void* scratch,
    int B, int H, int S, int dk, int dv, int norm, long long qsb, long long qsh, long long qss,
    long long qsd, long long ksb, long long ksh, long long kss, long long ksd, long long vsb,
    long long vsh, long long vss, long long vsd, long long lab, long long lah, long long las,
    long long dysb, long long dysh, long long dyss, long long dysd, long long dnb, long long dnh,
    long long dns, int dtype, int variant, int tile, void* stream) {
  if (B < 1 || H < 1 || S < 1 || dk < 1 || dk > kMaxDk || dv < 1 || H > 65535 || B > 65535)
    return int(cudaErrorInvalidValue);
  if (dtype != repro::kFloat32 && dtype != repro::kBFloat16) return int(cudaErrorInvalidValue);
  if (variant != kSimt && variant != kMma) return int(cudaErrorInvalidValue);
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.la = static_cast<const float*>(log_a);
  a.init = static_cast<const float*>(init);
  a.init_n = static_cast<const float*>(init_n);
  a.dy = dy;
  a.dS = static_cast<const float*>(dS);
  a.dnrm = dnrm;
  a.dn = static_cast<const float*>(dn);
  a.norm = norm != 0;
  a.dq = dq;
  a.dk_out = dk_out;
  a.dv_out = dv_out;
  a.dla = static_cast<float*>(dlog_a);
  a.d_init = static_cast<float*>(d_init);
  a.d_init_n = static_cast<float*>(d_init_n);
  a.B = B;
  a.H = H;
  a.S = S;
  a.dk = dk;
  a.dv = dv;
  const int dve = dv + (a.norm ? 1 : 0);
  const size_t bhs = size_t(B) * H * S;
  if (variant == kMma) {
    if (tile != 16 && tile != 32 && tile != 64) return int(cudaErrorInvalidValue);
    a.tiles = (dve + tile - 1) / tile;
    a.dq_part = a.dk_part = nullptr;
    a.dA = static_cast<float*>(scratch);
    a.dAk = a.dA + size_t(a.tiles) * bhs;
    a.fin_part = a.dAk + size_t(a.tiles) * bhs;
  } else {
    a.tiles = (dve + TW - 1) / TW;
    a.dq_part = static_cast<float*>(scratch);
    a.dk_part = a.dq_part + size_t(a.tiles) * bhs * dk;
    a.fin_part = a.dk_part + size_t(a.tiles) * bhs * dk;
    a.dA = a.fin_part + size_t(a.tiles) * B * H;
    a.dAk = nullptr;
  }
  a.qs = {qsb, qsh, qss, qsd};
  a.ks = {ksb, ksh, kss, ksd};
  a.vs = {vsb, vsh, vss, vsd};
  a.las = {lab, lah, las, 0};
  a.dys = {dysb, dysh, dyss, dysd};
  a.dns = {dnb, dnh, dns, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (variant == kMma) {
    if (dtype != repro::kBFloat16 || !mma_layout_ok(a) || 2 * B > 65535)
      return int(cudaErrorInvalidValue);
    err = mmab::launch_tile(a, tile, s);
  } else {
    err = dtype == repro::kBFloat16 ? launch<__nv_bfloat16>(a, s) : launch<float>(a, s);
  }
  if (err != cudaSuccess) cudaGetLastError();  // clear a failed launch's error
  return int(err);
}

// Dynamic shared memory (bytes) a block of the tensor-core backward asks
// for: `tile` (16, 32 or 64) extended columns a block, dk; 0 for another tile.
// Clusters of ceil(columns / tile) blocks of the tensor-core backward (one
// walk of one (b, h) each) the card holds at once, or -1.
extern "C" int gated_linear_scan_bwd_mma_max_clusters(int tile, int dk, int columns) {
  const int tiles = (columns + tile - 1) / tile;
  if (tile == 16) return mmab::clusters_dk<2>(dk, tiles);
  if (tile == 32) return mmab::clusters_dk<4>(dk, tiles);
  if (tile == 64) return mmab::clusters_dk<8>(dk, tiles);
  return -1;
}

extern "C" int gated_linear_scan_bwd_mma_smem_bytes(int tile, int dk) {
  if (tile == 16) return int(mmab::smem_dk<2>(dk));
  if (tile == 32) return int(mmab::smem_dk<4>(dk));
  if (tile == 64) return int(mmab::smem_dk<8>(dk));
  return 0;
}
