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
// The recurrence, walked position by position in fp32 (t = 0 .. S-1):
//   forward  S_t = a_t S_{t-1} + k_t^T v_t,      dq_t = dy_t S_t^T
//   reverse  G_t = [t = S-1 ? dS : a_{t+1} G_{t+1}] + q_t^T dy_t
//            dk_t = G_t v_t^T,  dv_t = k_t G_t,  d(init) = a_0 G_0
// and dlog_a from the identity dA_t = q_t . dq_t - k_t . dk_t (plus
// <dS, S_final> at the last position), dlog_a_t = sum_{i >= t} dA_i: the
// derivative of every term of y and of the final state with respect to the
// cumulative log decay A_t, so no block needs G_t and S_{t-1} at once.
//
// Three launches a call (the wrapper counts them as one):
// * `scan_bwd_walk_kernel`: a block per (32 extended columns, head, batch),
//   a thread per state row d (dk threads, rounded up to a warp), holding row
//   d of its 32 columns of S (the forward walk, from the initial state) and
//   then of G (the reverse walk, from dS) in registers. q_t[d], k_t[d] (a
//   column a thread), v_t and dy_t of the block's columns and a_t are staged
//   in shared memory 16 positions at a time (the last three read as
//   broadcasts). Up to 384 rows a block keeps to 85 registers a thread, so
//   two blocks share an SM and xlstm's 208 blocks run in one wave.
//   dq_t[d] and dk_t[d] are sums over the block's columns, inside the thread,
//   written as fp32 partials, one per column tile; dv_t (a sum over rows) is
//   reduced in each warp by a butterfly that leaves column `lane` in lane
//   `lane` (31 shuffles), then over the warps in shared memory once per 16
//   positions. Bounded by these per-position steps on CUDA cores: the work
//   is 8 S dk dv FLOP a (b, h) (four rank-1 products a position) and a
//   position's steps depend on the one before.
// * `scan_bwd_reduce_kernel`: a warp per position adds the column tiles'
//   partials in tile order (no atomics: the same bits every run), writes dq
//   and dk, and forms dA_t from the fp32 sums.
// * `scan_bwd_cumsum_kernel`: a warp per (b, h) takes the reverse inclusive
//   sum of dA in fp64, 32 positions at a time from the end.
#include <cstdint>

#include "common.cuh"

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
  float* dA;             // (B, H, S) scratch
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

}  // namespace

// C entry point. q, k: (B, H, S, dk), v: (B, H, S, dv) of one dtype (0 fp32,
// 1 bf16), log_a (B, H, S) fp32, dy (B, H, S, dv) and dnrm (B, H, S) in q's
// dtype, each by its element strides (dy, dnrm may be null: zeros); init,
// dS: contiguous fp32 (B, H, dk, dv), init_n, dn: contiguous fp32 (B, H, dk),
// each may be null (zeros). norm != 0: the normaliser column. Outputs, all
// contiguous: dq, dk_out (B, H, S, dk) and dv (B, H, S, dv) in q's dtype,
// dlog_a (B, H, S) fp32, d_init (B, H, dk, dv) and d_init_n (B, H, dk) fp32
// (null: not written). scratch: 2 tiles B H S dk + tiles B H + B H S fp32
// elements, tiles = ceil((dv + norm) / 32) (`linear_scan.py::
// backward_scratch_elements`). Three launches on `stream`; returns the first
// failing launch's cudaError_t, or 0.
extern "C" int gated_linear_scan_bwd(
    const void* q, const void* k, const void* v, const void* log_a, const void* init,
    const void* init_n, const void* dy, const void* dS, const void* dnrm, const void* dn,
    void* dq, void* dk_out, void* dv_out, void* dlog_a, void* d_init, void* d_init_n, void* scratch,
    int B, int H, int S, int dk, int dv, int norm, long long qsb, long long qsh, long long qss,
    long long qsd, long long ksb, long long ksh, long long kss, long long ksd, long long vsb,
    long long vsh, long long vss, long long vsd, long long lab, long long lah, long long las,
    long long dysb, long long dysh, long long dyss, long long dysd, long long dnb, long long dnh,
    long long dns, int dtype, void* stream) {
  if (B < 1 || H < 1 || S < 1 || dk < 1 || dk > kMaxDk || dv < 1 || H > 65535 || B > 65535)
    return int(cudaErrorInvalidValue);
  if (dtype != repro::kFloat32 && dtype != repro::kBFloat16) return int(cudaErrorInvalidValue);
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
  a.tiles = (dv + (a.norm ? 1 : 0) + TW - 1) / TW;
  const size_t bhs = size_t(B) * H * S;
  a.dq_part = static_cast<float*>(scratch);
  a.dk_part = a.dq_part + size_t(a.tiles) * bhs * dk;
  a.fin_part = a.dk_part + size_t(a.tiles) * bhs * dk;
  a.dA = a.fin_part + size_t(a.tiles) * B * H;
  a.qs = {qsb, qsh, qss, qsd};
  a.ks = {ksb, ksh, kss, ksd};
  a.vs = {vsb, vsh, vss, vsd};
  a.las = {lab, lah, las, 0};
  a.dys = {dysb, dysh, dyss, dysd};
  a.dns = {dnb, dnh, dns, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == repro::kBFloat16 ? launch<__nv_bfloat16>(a, s)
                                                    : launch<float>(a, s);
  if (err != cudaSuccess) cudaGetLastError();  // clear a failed launch's error
  return int(err);
}
