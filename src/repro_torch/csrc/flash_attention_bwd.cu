// Flash attention backward for Hopper (sm_90a), hand-written CUDA C++.
//
// What it stands for: the gradient of the reference's
// `repro/kernels/flash_attention.py::flash_attention`. That Pallas kernel
// has no VJP; the reference trains through its jnp oracle
// `repro/kernels/ref.py::attention`, whose gradient this reproduces
// (`kernels/ref.py::attention_backward` is the same formulas in plain
// PyTorch). Given q, k, v, the forward's output o, its per-row log-sum-exp
// lse (fp32, (B, H, Sq), natural units, as both forward variants of
// `flash_attention.cu` write it) and dO, it writes dQ, dK and dV. With P =
// exp(scale * q k^T - lse) on the keys a row may attend (causal, static
// window, prefix-LM, q_offset >= 0: the forward's masks exactly) and D =
// rowsum(dO * o):
//
//     dV = P^T dO        dP = dO V^T        dS = P * (dP - D)
//     dQ = scale * dS K  dK = scale * dS^T Q
//
// A row with no key it may attend (a window past the last key) is the
// reference's uniform average: P = 1 / Skv on every key, no gradient to q or
// k. With q_offset >= 0 that is the only such row. Every variant below takes
// these rows, so the variant rule looks at the operands only. K and V are
// never repeated for the G query heads of a KV head, and ragged Sq / Skv are
// masked here.
//
// What bounds it on the H100: at gemma3-1b's training shape (B=4, S=1024,
// 4 query heads over 1 at head_dim 256, causal, bf16) the five products
// over half the score matrix are 21.5 GFLOP, 21.7 us at the tensor cores'
// 989 TFLOP/s, against ~42 MB of bytes (12.5 us): operations. Three variants,
// chosen by an explicit rule in the wrapper
// (`kernels/flash_attention.py::backward_variant`):
//
// * wgmma (bf16, head_dim 64 / 80 / 112 / 128 / 160 / 256, at most 64 query
//   heads per KV head, 16-byte-aligned operands): every product on the
//   tensor cores. Rows are the forward's packing, (position, query head)
//   pairs of one KV group, P = 64 / G whole positions to a tile of 64 rows
//   (gemma3: 16 positions x 4 heads; granite-20b's G = 48: one position, 48
//   rows; grok-1's G = 6: 10 positions, 60 rows), so each K / V tile serves
//   all G heads. A tile's rows past P * G are zeroed in shared memory once
//   (TMA never writes them): dV and dK sum over rows, and a stale NaN there
//   would reach every key. Tiles span HDP = ceil(head_dim / 64) * 64 columns
//   of 64-column, 128-byte-swizzled TMA boxes (zeros past head_dim); S and
//   dP loop over the head_dim / 16 k-steps of real columns, dV, dK and dQ
//   run at n = HDP (an MN-major operand with that swizzle comes in whole
//   64-column atoms), and only head_dim columns are stored. Three or four
//   launches a call:
//   - rowstat: lse (in log2 units) and D = rowsum(dO * o) of each packed
//     row, into fp32 scratch laid out by query tile (64 lse, then 64 D), one
//     warp a row; padding rows and rows past Sq get lse = +inf, so their P
//     is 0;
//   - dK/dV: a block owns 64 keys of one KV head (K and V loaded once by
//     TMA) and walks a run of the query tiles that can see them through a
//     2-stage TMA ring of packed Q and dO tiles with their row stats. Two
//     consumer warpgroups at `setmaxnreg` 240 split the work, since dK and
//     dV together (2 x 64 x 256 fp32) do not fit one warpgroup's registers:
//     warpgroup 0 computes S^T = K Q^T (`wgmma` m64n64k16, both K-major),
//     P^T = exp2(S^T scale log2e - lse2), hands P^T over in shared memory
//     (64 x 64 fp32, behind named barriers) and adds dV += P^T dO (A = P^T
//     as bf16 in registers, dO through the transpose bit); warpgroup 1
//     computes dP^T = V dO^T, dS^T = P^T (dP^T - D) and adds dK += dS^T Q.
//     Each starts its next tile's first product behind its second. 210 KB
//     of shared memory at hd 256, 162 KB at hd 160. The walks of the first
//     key tiles under a causal mask are long (key tile 0 sees every query
//     tile), so a walk of
//     more than `chunk` query tiles is split over several blocks, each
//     writing its fp32 partial dK / dV to scratch; the host picks `chunk`
//     from the mask geometry when the unsplit grid fills less than one wave
//     of the card (`flash_attention.backward_plan`);
//   - reduce (only when a walk was split): adds each key tile's partials in
//     split order and writes bf16;
//   - dQ: a block of one consumer warpgroup owns 64 packed query rows and
//     walks the key tiles they attend (the forward's key range) through a
//     2-stage TMA ring of K and V tiles: S = Q K^T and dP = dO V^T
//     (`wgmma`, from shared memory), dS in registers, dQ += dS K (A = dS as
//     bf16 in registers, K through the transpose bit); the 64 x head_dim
//     fp32 dQ stays in registers. A 1-D grid, query tiles outermost from
//     the last, starts the longest causal walks of every batch first.
//   Seven products (S and dP are recomputed in both walks), no atomics:
//   every run gives the same bits. On the card (PERF.md section 6) it runs
//   at about 5x its bound at gemma3's shape: the S and dP products read both
//   operands from shared memory, and a warpgroup's exponentials and masks
//   wait on its own products (neither the ring's loads nor the split bound
//   it). An accumulator is zeroed, behind a register fence, before its
//   stage starts, and never written by another instruction inside one:
//   ptxas otherwise reuses its registers as scratch and serialises every
//   wgmma of the kernel (its warning C7515).
// * tf32x3 (fp32: every supported head dim and group size, 16-byte-aligned
//   operands): every product on the tensor cores by `mma.sync` m16n8k8 TF32
//   tiles, each fp32 operand split into a TF32 high part and the TF32 of its
//   remainder and each product taken as three (lo hi + hi lo + hi hi, fp32
//   accumulation; the lo lo term, ~2^-22 of the product, is dropped):
//   CUTLASS's OpMultiplyAddFastF32 scheme: a product is off by about 2^-21 of
//   its size, where one TF32 product would be off by 2^-11. At
//   `examples/train_100m_torch.py`'s shape (B=4, S=256, 8 query heads over 2,
//   hd 80, causal) its bound is 12.6 us of operations at the fp32 FMA peak,
//   5.1 us as three products at the TF32 peak. Three or four launches: D =
//   rowsum(dO * o) as simt's; dK/dV, a block per (key tile of 64, split of
//   its walk, b * KV + kvh) whose eight warps pair up on 16 keys each (one
//   computes S^T = K Q^T, P^T and dV += P^T dO, hands P^T over in shared
//   memory; the other dP^T = V dO^T, dS^T and dK += dS^T Q), walking (query
//   head, query tile of 32) pairs whose Q and dO tiles are split once as they
//   are staged; walks longer than `chunk` pairs are split over blocks when
//   the unsplit grid leaves the card's SMs idle
//   (`flash_attention.tf32x3_plan`), fp32 partials added in split order by a
//   reduce launch; dQ, a block per (64 query rows, query head, batch) whose
//   warps take half of each 64-key tile (32 at hd 160, 16 at 256), the
//   halves' dQ added in a fixed order. P and dS never leave registers but for
//   the one hand-over: a product's accumulator is the next product's A
//   fragment as it stands (the k order inside each step of 8 is permuted to
//   match). Rows of hd + 4 floats keep every fragment load free of bank
//   conflicts. No atomics. The split, the products and the staging are
//   `tf32x3.cuh`'s, shared with the forward's tf32x3 variant.
// * simt (bf16 at head dims 16 and 32, more than 64 query heads per KV head
//   or unaligned operands; fp32 only when unaligned): scalar fp32 FMA on the
//   CUDA cores.
//   Three launches: D = rowsum(dO * o), one warp a (b, position, head) row;
//   dK/dV, one block per (key tile of 32, KV head, batch), walking every
//   query tile that can see its keys for all G query heads of its KV group,
//   dK and dV in fp32 registers; dQ, one block per (query tile of 32, query
//   head, batch), walking the forward's key range. Each recomputes S and dP
//   from K/V and Q/dO tiles staged in fp32 shared memory (rows padded to an
//   odd stride: conflict-free column reads). No atomics: deterministic.
#include "common.cuh"
#include "hopper.cuh"
#include "tf32x3.cuh"
#include "wgmma.cuh"

namespace {

using repro::NEG_INF;

constexpr int BR = 32;               // rows of a block's own tile (keys in dK/dV, queries in dQ)
constexpr int BC = 32;               // the tile it walks (queries in dK/dV, keys in dQ)
constexpr int NT = 256;              // threads per block
constexpr int NW = NT / 32;          // warps
constexpr int RPW = BR / NW;         // own rows per warp

template <int HD>
constexpr size_t smem_bytes() {      // four staged tiles, P / dS, three per-row values
  return sizeof(float) * (4 * size_t(BR) * (HD + 1) + 2 * size_t(BR) * (BC + 1) + 3 * BR);
}

// May query position qp attend key `key`? The forward's masks.
__device__ __forceinline__ bool allowed(int qp, int key, int causal, int window,
                                        int prefix_len) {
  bool ok = true;
  if (causal) {
    ok = key <= qp;
    if (prefix_len > 0) ok = ok || (qp < prefix_len && key < prefix_len);
  }
  if (window > 0) ok = ok && (qp - key < window);
  return ok;
}

// A query position (>= 0) with no key it may attend.
__device__ __forceinline__ bool row_empty(int qp, int Skv, int causal, int window,
                                          int prefix_len) {
  int kmax = Skv - 1;
  if (causal) {
    kmax = min(qp, Skv - 1);
    if (prefix_len > 0 && qp < prefix_len) kmax = max(kmax, min(prefix_len, Skv) - 1);
  }
  return kmax < 0 || (window > 0 && kmax <= qp - window);
}

// Row states staged beside lse and D.
constexpr float ROW_LIVE = 0.f, ROW_EMPTY = 1.f, ROW_ABSENT = 2.f;

// ---------------------------------------------------------------------------
// D = rowsum(dO * o)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT) flash_bwd_delta_kernel(
    const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta, int rows,
    int Sq, int H, int hd) {
  const int r = blockIdx.x * NW + threadIdx.x / 32;  // (b, position, head) in memory order
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;  // a whole warp
  const T* orow = o + size_t(r) * hd;
  const T* drow = dout + size_t(r) * hd;
  float s = 0.f;
  for (int d = lane; d < hd; d += 32) s += repro::to_float(orow[d]) * repro::to_float(drow[d]);
  s = repro::warp_sum(s);
  if (lane == 0) {
    const int h = r % H, i = (r / H) % Sq, b = r / (H * Sq);
    delta[(size_t(b) * H + h) * Sq + i] = s;
  }
}

// Stage rows [r0, r0 + n) of a (B, S, heads, HD) tensor's head `head` as fp32
// into `dst` [BR][HD + 1]; rows past n read zeros.
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, size_t row_stride, int n) {
  for (int e = threadIdx.x; e < BR * HD; e += NT) {
    const int j = e / HD, d = e % HD;
    dst[j * (HD + 1) + d] = j < n ? repro::to_float(src[size_t(j) * row_stride + d]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// dK, dV: a block per (key tile, KV head, batch)
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int H, int KV, float scale,
    int causal, int window, int prefix_len, int q_offset) {
  constexpr int LD = HD + 1;
  constexpr int NCOL = (HD + 31) / 32;  // head dims a lane owns: lane, lane + 32, ...
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BR * LD;
  float* Qs = Vs + BR * LD;
  float* dOs = Qs + BC * LD;
  float* Ps = dOs + BC * LD;
  float* dSs = Ps + BR * (BC + 1);
  float* lse_s = dSs + BR * (BC + 1);
  float* D_s = lse_s + BC;
  float* state_s = D_s + BC;

  const int k0 = blockIdx.x * BR, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nk = min(BR, Skv - k0);
  const size_t q_row = size_t(H) * HD, kv_row = size_t(KV) * HD;

  stage_rows<T, HD>(Ks, k + (size_t(b) * Skv + k0) * kv_row + size_t(kvh) * HD, kv_row, nk);
  stage_rows<T, HD>(Vs, v + (size_t(b) * Skv + k0) * kv_row + size_t(kvh) * HD, kv_row, nk);

  // query rows that can see a key of this tile: causal rows from the tile's
  // first key on (every row when it reaches into the bidirectional prefix),
  // windowed rows up to the last key + window - 1, and every row when some
  // row has no key at all (it spreads over every key)
  int i_lo = 0, i_hi = Sq;
  if (causal && !(prefix_len > 0 && k0 < prefix_len)) i_lo = max(0, k0 - q_offset);
  if (window > 0 && q_offset + Sq - 1 < Skv + window - 1)
    i_hi = min(Sq, k0 + nk - 1 + window - q_offset);
  i_lo = (i_lo / BC) * BC;

  float dk_acc[RPW][NCOL], dv_acc[RPW][NCOL];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < NCOL; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;
  const float inv_skv = 1.f / float(Skv);

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* lse_h = lse + (size_t(b) * H + h) * Sq;
    const float* D_h = delta + (size_t(b) * H + h) * Sq;
    for (int i0 = i_lo; i0 < i_hi; i0 += BC) {
      const int nq = min(BC, Sq - i0);
      __syncthreads();  // K / V staged, or the previous tile fully consumed
      const size_t off = (size_t(b) * Sq + i0) * q_row + size_t(h) * HD;
      stage_rows<T, HD>(Qs, q + off, q_row, nq);
      stage_rows<T, HD>(dOs, dout + off, q_row, nq);
      if (threadIdx.x < BC) {
        const int i = i0 + threadIdx.x;
        const bool in = threadIdx.x < nq;
        lse_s[threadIdx.x] = in ? lse_h[i] : 0.f;
        D_s[threadIdx.x] = in ? D_h[i] : 0.f;
        state_s[threadIdx.x] =
            !in ? ROW_ABSENT
                : (row_empty(q_offset + i, Skv, causal, window, prefix_len) ? ROW_EMPTY
                                                                             : ROW_LIVE);
      }
      __syncthreads();

      // S and dP: this warp's keys (rows), query i0 + lane (column)
      float s[RPW], dp[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) s[r] = dp[r] = 0.f;
      const float* qrow = Qs + lane * LD;
      const float* orow = dOs + lane * LD;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        const float qd = qrow[d], od = orow[d];
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const int j = warp * RPW + r;
          s[r] += Ks[j * LD + d] * qd;
          dp[r] += Vs[j * LD + d] * od;
        }
      }
      const float st = state_s[lane];
      const int qp = q_offset + i0 + lane;
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int j = warp * RPW + r;
        const int key = k0 + j;
        float p = 0.f, ds = 0.f;
        if (j < nk && st != ROW_ABSENT) {
          if (st == ROW_EMPTY) {
            p = inv_skv;
          } else if (allowed(qp, key, causal, window, prefix_len)) {
            p = expf(s[r] * scale - lse_s[lane]);
            ds = p * (dp[r] - D_s[lane]);
          }
        }
        Ps[j * (BC + 1) + lane] = p;
        dSs[j * (BC + 1) + lane] = ds;
      }
      __syncthreads();

      // dV += P dO, dK += dS Q over the tile's queries
#pragma unroll 2
      for (int i = 0; i < nq; ++i) {
        float pr[RPW], dsr[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          pr[r] = Ps[(warp * RPW + r) * (BC + 1) + i];
          dsr[r] = dSs[(warp * RPW + r) * (BC + 1) + i];
        }
#pragma unroll
        for (int c = 0; c < NCOL; ++c) {
          const int d = lane + 32 * c;
          if (d < HD) {
            const float od = dOs[i * LD + d], qd = Qs[i * LD + d];
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
              dv_acc[r][c] += pr[r] * od;
              dk_acc[r][c] += dsr[r] * qd;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int j = warp * RPW + r;
    if (j >= nk) continue;
    const size_t row = (size_t(b) * Skv + k0 + j) * kv_row + size_t(kvh) * HD;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) {
        dk[row + d] = repro::from_float<T>(dk_acc[r][c] * scale);
        dv[row + d] = repro::from_float<T>(dv_acc[r][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: a block per (query tile, query head, batch)
// ---------------------------------------------------------------------------

// Key range [k_begin, k_end) the query positions [qp_lo, qp_hi] visit (the
// forward's `key_range`): exact when every row has a key; a block with an
// empty row visits every key (its own rows get no gradient either way).
__device__ __forceinline__ void key_range(int qp_lo, int qp_hi, int Skv, int causal, int window,
                                          int prefix_len, int* k_begin, int* k_end) {
  const bool rows_nonempty = (!causal || qp_lo >= 0 || prefix_len > 0) &&
                             (window <= 0 || qp_hi <= Skv + window - 2);
  *k_begin = 0;
  *k_end = Skv;
  if (rows_nonempty) {
    if (window > 0) *k_begin = max(0, qp_lo - window + 1);
    if (causal) {
      int hi = qp_hi + 1;
      if (prefix_len > 0 && qp_lo < prefix_len) hi = max(hi, prefix_len);
      *k_end = min(Skv, hi);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int Sq, int Skv, int H, int KV, float scale, int causal, int window,
    int prefix_len, int q_offset) {
  constexpr int LD = HD + 1;
  constexpr int NCOL = (HD + 31) / 32;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BR * LD;
  float* Ks = dOs + BR * LD;
  float* Vs = Ks + BC * LD;
  float* dSs = Vs + BC * LD;
  float* lse_s = dSs + 2 * BR * (BC + 1);  // (P's room of the dK/dV layout unused)
  float* D_s = lse_s + BR;
  float* state_s = D_s + BR;

  const int i0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nq = min(BR, Sq - i0);
  const size_t q_row = size_t(H) * HD, kv_row = size_t(KV) * HD;

  const size_t off = (size_t(b) * Sq + i0) * q_row + size_t(h) * HD;
  stage_rows<T, HD>(Qs, q + off, q_row, nq);
  stage_rows<T, HD>(dOs, dout + off, q_row, nq);
  if (threadIdx.x < BR) {
    const int i = i0 + threadIdx.x;
    const bool in = threadIdx.x < nq;
    lse_s[threadIdx.x] = in ? lse[(size_t(b) * H + h) * Sq + i] : 0.f;
    D_s[threadIdx.x] = in ? delta[(size_t(b) * H + h) * Sq + i] : 0.f;
    state_s[threadIdx.x] =
        !in ? ROW_ABSENT
            : (row_empty(q_offset + i, Skv, causal, window, prefix_len) ? ROW_EMPTY : ROW_LIVE);
  }

  int k_begin, k_end;
  key_range(q_offset + i0, q_offset + i0 + nq - 1, Skv, causal, window, prefix_len, &k_begin,
            &k_end);

  float dq_acc[RPW][NCOL];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < NCOL; ++c) dq_acc[r][c] = 0.f;

  for (int kt = k_begin; kt < k_end; kt += BC) {
    const int nk = min(BC, k_end - kt);
    __syncthreads();  // Q / dO staged, or the previous tile fully consumed
    const size_t koff = (size_t(b) * Skv + kt) * kv_row + size_t(kvh) * HD;
    stage_rows<T, HD>(Ks, k + koff, kv_row, nk);
    stage_rows<T, HD>(Vs, v + koff, kv_row, nk);
    __syncthreads();

    // S and dP: this warp's query rows, key kt + lane (column)
    float s[RPW], dp[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = dp[r] = 0.f;
    const float* krow = Ks + lane * LD;
    const float* vrow = Vs + lane * LD;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float kd = krow[d], vd = vrow[d];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int i = warp * RPW + r;
        s[r] += Qs[i * LD + d] * kd;
        dp[r] += dOs[i * LD + d] * vd;
      }
    }
    const int key = kt + lane;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int i = warp * RPW + r;
      float ds = 0.f;
      if (lane < nk && state_s[i] == ROW_LIVE &&
          allowed(q_offset + i0 + i, key, causal, window, prefix_len))
        ds = expf(s[r] * scale - lse_s[i]) * (dp[r] - D_s[i]);
      dSs[i * (BC + 1) + lane] = ds;
    }
    __syncthreads();

    // dQ += dS K over the tile's keys
#pragma unroll 2
    for (int j = 0; j < nk; ++j) {
      float dsr[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) dsr[r] = dSs[(warp * RPW + r) * (BC + 1) + j];
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        const int d = lane + 32 * c;
        if (d < HD) {
          const float kd = Ks[j * LD + d];
#pragma unroll
          for (int r = 0; r < RPW; ++r) dq_acc[r][c] += dsr[r] * kd;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int i = warp * RPW + r;
    if (i >= nq) continue;
    const size_t row = (size_t(b) * Sq + i0 + i) * q_row + size_t(h) * HD;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) dq[row + d] = repro::from_float<T>(dq_acc[r][c] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq, void* dk,
                   void* dv, int B, int Sq, int Skv, int H, int KV, float scale, int causal,
                   int window, int prefix_len, int q_offset, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD>();
  auto dkdv = flash_bwd_dkdv_kernel<T, HD>;
  auto dqk = flash_bwd_dq_kernel<T, HD>;
  static const cudaError_t attr = [&] {  // once a process: the port drives one card
    cudaError_t e = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(bytes));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  }();
  if (attr != cudaSuccess) return attr;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int rows = B * Sq * H;
  flash_bwd_delta_kernel<T><<<(rows + NW - 1) / NW, NT, 0, stream>>>(
      static_cast<const T*>(o), dot, delta, rows, Sq, H, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((Skv + BR - 1) / BR, KV, B), NT, bytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, H, KV,
      scale, causal, window, prefix_len, q_offset);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dqk<<<dim3((Sq + BR - 1) / BR, H, B), NT, bytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), Sq, Skv, H, KV, scale, causal, window,
      prefix_len, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, float* delta, void* dq, void* dk,
                        void* dv, int B, int Sq, int Skv, int H, int KV, float scale, int causal,
                        int window, int prefix_len, int q_offset, cudaStream_t stream) {
#define REPRO_BWD_HD(N)                                                                       \
  case N:                                                                                     \
    return launch<T, N>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, KV, scale,  \
                        causal, window, prefix_len, q_offset, stream);
  switch (hd) {
    REPRO_BWD_HD(16)
    REPRO_BWD_HD(32)
    REPRO_BWD_HD(64)
    REPRO_BWD_HD(80)  // train_100m's ~100M-parameter gemma3-family model
    REPRO_BWD_HD(112)
    REPRO_BWD_HD(128)
    REPRO_BWD_HD(160)
    REPRO_BWD_HD(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_BWD_HD
}

// ---------------------------------------------------------------------------
// wgmma: bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace fb {
constexpr int ROWS = 64;                   // packed (position, head) query rows of a tile
constexpr int BKV = 64;                    // keys a tile
constexpr int STAGES = 2;
constexpr int CHUNK = 64 * 128;            // one 64-column box of a 64-row tile: 8 KB
constexpr int STAT = 2 * ROWS;             // floats of a query tile's row stats: lse2, then D
constexpr uint32_t STAT_BYTES = STAT * sizeof(float);
constexpr int BAR_P_FULL = 1, BAR_P_EMPTY = 2;  // named barriers of the P^T hand-over
constexpr float LOG2E = 1.4426950408889634f;
template <int HD>
constexpr int tile_bytes() { return repro::sm90::tile_columns(HD) / 64 * CHUNK; }
template <int HD>
constexpr size_t dkdv_smem() {  // K, V, STAGES x (Q, dO), P^T, row stats, barriers, slack
  return size_t(2 + 2 * STAGES) * tile_bytes<HD>() + ROWS * BKV * sizeof(float) +
         STAGES * STAT_BYTES + (1 + 2 * STAGES) * sizeof(uint64_t) + 1024;
}
template <int HD>
constexpr size_t dq_smem() {  // Q, dO, STAGES x (K, V), row stats, barriers, slack
  return size_t(2 + 2 * STAGES) * tile_bytes<HD>() + STAT_BYTES +
         (1 + 2 * STAGES) * sizeof(uint64_t) + 1024;
}
}  // namespace fb

// 2^x on the special-function unit, subnormal results flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A float of shared memory, through a shared-space load
__device__ __forceinline__ float lds(const float* p) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(repro::sm90::smem_u32(p)) : "memory");
  return v;
}

__device__ __forceinline__ float2 lds2(const float* p) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y)
               : "r"(repro::sm90::smem_u32(p)) : "memory");
  return v;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// Query tiles [lo, hi) (of P positions each) that can see a key of key tile
// j: causal rows from the tile's first key on (every row when it reaches
// into the bidirectional prefix), windowed rows up to its last key + window
// - 1, and every row when some row has no key at all (it spreads over every
// key). `flash_attention.py::_query_tiles_seen` is the host's copy, which
// only sizes the split.
__device__ __forceinline__ void query_tiles(int j, int Sq, int Skv, int P, int causal,
                                            int window, int prefix_len, int q_offset, int* lo,
                                            int* hi) {
  const int k0 = j * fb::BKV, khi = min(k0 + fb::BKV - 1, Skv - 1);
  int pos_lo = 0, pos_hi = Sq;
  if (causal && !(prefix_len > 0 && k0 < prefix_len)) pos_lo = max(0, k0 - q_offset);
  if (window > 0 && q_offset + Sq - 1 < Skv + window - 1)
    pos_hi = min(Sq, khi + window - q_offset);
  *lo = pos_lo / P;
  *hi = pos_hi > pos_lo ? (pos_hi + P - 1) / P : *lo;
}

// Blocks a walk of n query tiles is split over, at most `chunk` tiles each.
__device__ __forceinline__ int walk_splits(int n, int chunk) {
  return n > chunk ? (n + chunk - 1) / chunk : 1;
}

// lse (log2 units) and D of every packed row of every query tile: row x < P
// * G of tile `tile` is (position tile * P + x / G, head kvh * G + x % G), at
// stat[((b * KV + kvh) * n_qt + tile) * 128 + {0, 64} + x]. Padding rows (x
// >= P * G, when G does not divide 64) and rows past Sq: lse2 = +inf (P =
// 0), D = 0.
__global__ void __launch_bounds__(NT) flash_bwd_rowstat_kernel(
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ stat, int rows, int Sq, int H, int KV,
    int G, int hd, int n_qt) {
  const int r = blockIdx.x * NW + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;  // a whole warp
  const int per_z = n_qt * fb::ROWS;
  const int z = r / per_z, rr = r % per_z;
  const int b = z / KV, kvh = z % KV;
  const int x = rr % fb::ROWS, P = fb::ROWS / G;
  const bool real = x < P * G;
  const int pos = (rr / fb::ROWS) * P + x / G, h = kvh * G + x % G;
  float d = 0.f;
  if (real && pos < Sq) {
    const size_t row = ((size_t(b) * Sq + pos) * H + h) * hd;
    for (int e = lane * 8; e < hd; e += 256) {  // 16-byte loads: 8 bf16
      const uint4 a = *reinterpret_cast<const uint4*>(o + row + e);
      const uint4 c = *reinterpret_cast<const uint4*>(dout + row + e);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float2 fa = __bfloat1622float2(a2[x]), fc = __bfloat1622float2(c2[x]);
        d += fa.x * fc.x + fa.y * fc.y;
      }
    }
    d = repro::warp_sum(d);
  }
  if (lane == 0) {
    float* s = stat + (size_t(z) * n_qt + rr / fb::ROWS) * fb::STAT;
    s[x] = real && pos < Sq ? lse[(size_t(b) * H + h) * Sq + pos] * fb::LOG2E : CUDART_INF_F;
    s[fb::ROWS + x] = d;
  }
}

// dK, dV: a block per (key tile of 64, split of its query walk, b * KV +
// kvh); two consumer warpgroups and one producer warpgroup.
template <int HD>
__global__ void __launch_bounds__(384, 1) flash_bwd_dkdv_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
    const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
    const float* __restrict__ stat, float* __restrict__ partial, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int KV, int G, int n_qt,
    float scale, float scale_log2, int causal, int window, int prefix_len, int q_offset,
    int chunk) {
  using namespace repro::sm90;
  constexpr int HDP = tile_columns(HD);  // columns of a tile; TMA reads zeros past HD
  constexpr int CH = HDP / 64;
  constexpr int TILE = CH * fb::CHUNK;  // one 64-row tile: Q, dO, K or V
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* k_tile = smem;
  uint8_t* v_tile = smem + TILE;
  uint8_t* ring = smem + 2 * TILE;  // stage s: Q at ring + 2 s TILE, dO one TILE on
  float* pt = reinterpret_cast<float*>(ring + 2 * fb::STAGES * TILE);  // P^T [32][128]
  float* stats = pt + fb::ROWS * fb::BKV;                              // [STAGES][STAT]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + fb::STAGES * fb::STAT);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + fb::STAGES;

  const int j = blockIdx.x, split = blockIdx.y, z = blockIdx.z;
  const int b = z / KV, kvh = z % KV;
  const int P = fb::ROWS / G, PG = P * G;  // packed rows a Q / dO box fills
  int lo, hi;
  query_tiles(j, Sq, Skv, P, causal, window, prefix_len, q_offset, &lo, &hi);
  const int splits = walk_splits(hi - lo, chunk);
  if (split >= splits) return;  // the whole block, before any barrier
  const int i_begin = lo + split * chunk;
  const int n_tiles = max(0, min(hi, i_begin + chunk) - i_begin);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < fb::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  if (PG < fb::ROWS) {
    // rows PG..63 of every ring tile are zeroed once: TMA never writes them,
    // and dV += P^T dO, dK += dS^T Q sum over rows, where a stale NaN would
    // reach every key (0 * NaN is NaN)
    zero_box_tails(ring, 2 * fb::STAGES * CH, fb::CHUNK, PG);
    fence_proxy_async();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: K and V once, then the ring of Q, dO tiles and row stats
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256 && n_tiles > 0) {
      mbar_arrive_expect_tx(kv_full, 2 * TILE);
      for (int ch = 0; ch < CH; ++ch) {
        tma_load_4d(k_tile + ch * fb::CHUNK, &k_map, kv_full, ch * 64, kvh, j * fb::BKV, b);
        tma_load_4d(v_tile + ch * fb::CHUNK, &v_map, kv_full, ch * 64, kvh, j * fb::BKV, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % fb::STAGES;
        mbar_wait(&empty[s], ((i / fb::STAGES) & 1) ^ 1);
        uint8_t* st = ring + 2 * s * TILE;
        const int qt = i_begin + i;
        mbar_arrive_expect_tx(&full[s], 2 * CH * PG * 128 + fb::STAT_BYTES);
        for (int ch = 0; ch < CH; ++ch) {
          tma_load_5d(st + ch * fb::CHUNK, &q_map, &full[s], ch * 64, 0, kvh, qt * P, b);
          tma_load_5d(st + TILE + ch * fb::CHUNK, &do_map, &full[s], ch * 64, 0, kvh, qt * P,
                      b);
        }
        bulk_load(stats + s * fb::STAT, stat + (size_t(z) * n_qt + qt) * fb::STAT,
                  fb::STAT_BYTES, &full[s]);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, t = lane % 4;
    const int tid = threadIdx.x % 128;
    const int k0 = j * fb::BKV, khi = min(k0 + fb::BKV - 1, Skv - 1);
    // this thread's two accumulator rows: keys k0 + warp * 16 + lane / 4 (+ 8)
    int key[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) key[h] = k0 + warp * 16 + lane / 4 + 8 * h;
    const float inv_skv = 1.f / float(Skv);
    float acc[HDP / 2];  // dV (warpgroup 0) or dK (warpgroup 1), 64 keys x HDP
#pragma unroll
    for (int x = 0; x < HDP / 2; ++x) acc[x] = 0.f;
    float sacc[32];  // S^T (warpgroup 0) or dP^T (warpgroup 1): 64 keys x 64 rows
#pragma unroll
    for (int x = 0; x < 32; ++x) sacc[x] = 0.f;
    uint32_t pa[4][4];  // P^T or dS^T as the bf16 A fragment of m64k16, rows 16 kk ..
    // A of the first product: K (S^T = K Q^T) or V (dP^T = V dO^T); B: the
    // stage's Q or dO tile, both K-major
    const uint8_t* a_tile = wg == 0 ? k_tile : v_tile;
    auto launch_first = [&](int i) {
      const int s = i % fb::STAGES;
      mbar_wait(&full[s], (i / fb::STAGES) & 1);
      const uint8_t* b_tile = ring + 2 * s * TILE + (wg == 0 ? 0 : TILE);
      fence_regs(sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int off = (kk / 4) * fb::CHUNK + (kk % 4) * 32;
        wgmma_ss<64, 0, 0>(sacc, smem_desc(a_tile + off, 16, 1024),
                           smem_desc(b_tile + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };

    if (n_tiles > 0) {
      mbar_wait(kv_full, 0);
      launch_first(0);
      wgmma_wait<0>();
      fence_regs(sacc);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % fb::STAGES;
      const float* st = stats + s * fb::STAT;
      const int pos0 = (i_begin + i) * P;
      const int qp_lo = q_offset + pos0, qp_hi = q_offset + min(Sq, pos0 + P) - 1;
      // every (row, key) pair of the tile attends: no mask, no empty row
      const bool whole =
          (!causal || khi <= qp_lo || (prefix_len > 0 && qp_hi < prefix_len && khi < prefix_len)) &&
          (window <= 0 || qp_hi - k0 < window);
      // sacc[4 jj + e] is key row e / 2, packed query column 8 jj + 2 t + (e & 1)
      if (wg == 0) {
        if (i > 0) named_sync(fb::BAR_P_EMPTY, 256);  // warpgroup 1 has read P^T of tile i - 1
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float2 l2 = lds2(st + 8 * jj + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sacc[4 * jj + e] = ex2(fmaf(sacc[4 * jj + e], scale_log2, (e & 1) ? -l2.y : -l2.x));
        }
        if (whole) {
#pragma unroll
          for (int x = 0; x < 32; ++x) pt[x * 128 + tid] = sacc[x];
        } else {
#pragma unroll
          for (int x = 0; x < 32; ++x) {
            const int row = 8 * (x / 4) + 2 * t + (x & 1);  // packed query row
            const int pos = pos0 + row / G;
            const int qp = q_offset + pos;
            float p = sacc[x], p_dv = p;
            if (row >= PG || pos >= Sq) {
              p = p_dv = 0.f;
            } else if (row_empty(qp, Skv, causal, window, prefix_len)) {
              p = 0.f;  // no gradient to q or k
              p_dv = inv_skv;
            } else if (!allowed(qp, key[(x % 4) / 2], causal, window, prefix_len)) {
              p = p_dv = 0.f;
            }
            pt[x * 128 + tid] = p;
            sacc[x] = p_dv;
          }
        }
        named_arrive(fb::BAR_P_FULL, 256);
      } else {
        named_sync(fb::BAR_P_FULL, 256);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float2 d2 = lds2(st + fb::ROWS + 8 * jj + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sacc[4 * jj + e] =
                pt[(4 * jj + e) * 128 + tid] * (sacc[4 * jj + e] - ((e & 1) ? d2.y : d2.x));
        }
        if (i + 1 < n_tiles) named_arrive(fb::BAR_P_EMPTY, 256);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16x2(sacc[8 * kk + 0], sacc[8 * kk + 1]);
        pa[kk][1] = pack_bf16x2(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pa[kk][2] = pack_bf16x2(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pa[kk][3] = pack_bf16x2(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
      // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1): B is the
      // stage's dO or Q tile, MN-major (head dims contiguous), 16 rows =
      // 2048 bytes a step, over the padded HDP columns (whole 64-column
      // atoms of the 128-byte swizzle); the next tile's first product starts
      // behind it
      const uint8_t* b_tile = ring + 2 * s * TILE + (wg == 0 ? TILE : 0);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<HDP, 1>(acc, pa[kk], smem_desc(b_tile + kk * 2048, fb::CHUNK, 1024), 1);
      wgmma_commit();
      if (i + 1 < n_tiles) launch_first(i + 1);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(sacc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // the product read these until the wait
#pragma unroll
        for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(pa[kk][r])::"memory");
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // epilogue: acc[4 jj + 2 h + c] is key[h], head dim 8 jj + 2 t + c; the
    // HD real columns only
    const float mul = wg == 0 ? 1.f : scale;
    if (splits == 1) {
      __nv_bfloat16* out = wg == 0 ? dv : dk;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (key[h] >= Skv) continue;
        __nv_bfloat16* row = out + ((size_t(b) * Skv + key[h]) * KV + kvh) * HD;
#pragma unroll
        for (int jj = 0; jj < HD / 8; ++jj)
          *reinterpret_cast<uint32_t*>(row + 8 * jj + 2 * t) =
              pack_bf16x2(acc[4 * jj + 2 * h] * mul, acc[4 * jj + 2 * h + 1] * mul);
      }
    } else {
      // partial[split][z][key tile][64 keys][dK, dV][HD], fp32
      float* base = partial + ((size_t(split) * gridDim.z + z) * gridDim.x + j) * fb::BKV * 2 * HD;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* row = base + (size_t(warp * 16 + lane / 4 + 8 * h) * 2 + (wg == 0 ? 1 : 0)) * HD;
#pragma unroll
        for (int jj = 0; jj < HD / 8; ++jj)
          *reinterpret_cast<float2*>(row + 8 * jj + 2 * t) =
              make_float2(acc[4 * jj + 2 * h] * mul, acc[4 * jj + 2 * h + 1] * mul);
      }
    }
  }
}

// The split walks' partial dK, dV added in split order (the same bits every
// run): a block per (slice of NT * 4 floats of a key tile's 64 x 2 x HD,
// key tile, b * KV + kvh), one float4 a thread; tiles walked whole are done.
template <int HD>
__global__ void __launch_bounds__(NT) flash_bwd_reduce_kernel(
    const float* __restrict__ partial, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int KV, int P, int causal, int window,
    int prefix_len, int q_offset, int chunk) {
  const int j = blockIdx.y, z = blockIdx.z, n_kt = gridDim.y;
  int lo, hi;
  query_tiles(j, Sq, Skv, P, causal, window, prefix_len, q_offset, &lo, &hi);
  const int splits = walk_splits(hi - lo, chunk);
  const int e = (blockIdx.x * NT + threadIdx.x) * 4;  // float offset in the key tile's block
  const int r = e / (2 * HD), which = (e / HD) % 2, d = e % HD;
  const int key = j * fb::BKV + r;
  if (splits == 1 || key >= Skv) return;
  const int b = z / KV, kvh = z % KV;
  const size_t split_stride = size_t(gridDim.z) * n_kt * fb::BKV * 2 * HD;
  const float* src = partial + (size_t(z) * n_kt + j) * fb::BKV * 2 * HD + e;
  float4 sum = *reinterpret_cast<const float4*>(src);
  for (int s = 1; s < splits; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(src + s * split_stride);
    sum.x += x.x;
    sum.y += x.y;
    sum.z += x.z;
    sum.w += x.w;
  }
  __nv_bfloat16* out = (which == 0 ? dk : dv) + ((size_t(b) * Skv + key) * KV + kvh) * HD + d;
  uint2 packed;
  packed.x = repro::sm90::pack_bf16x2(sum.x, sum.y);
  packed.y = repro::sm90::pack_bf16x2(sum.z, sum.w);
  *reinterpret_cast<uint2*>(out) = packed;
}

// dQ: a block per (64 packed query rows, KV head, batch); one consumer
// warpgroup and one producer warpgroup.
template <int HD>
__global__ void __launch_bounds__(256, 1) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
    const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
    const float* __restrict__ stat, __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H,
    int KV, int G, int n_qt, float scale, float scale_log2, int causal, int window,
    int prefix_len, int q_offset) {
  using namespace repro::sm90;
  constexpr int HDP = tile_columns(HD);  // columns of a tile; TMA reads zeros past HD
  constexpr int CH = HDP / 64;
  constexpr int TILE = CH * fb::CHUNK;  // one 64-row tile: Q, dO, K or V
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* q_tile = smem;
  uint8_t* do_tile = smem + TILE;
  uint8_t* ring = smem + 2 * TILE;  // stage s: K at ring + 2 s TILE, V one TILE on
  float* stats = reinterpret_cast<float*>(ring + 2 * fb::STAGES * TILE);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(stats + fb::STAT);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + fb::STAGES;

  // a 1-D grid, the query tile outermost and from the last: the longest
  // causal walks of every (batch, KV head) start first
  const int n_z = gridDim.x / n_qt;
  const int qt = n_qt - 1 - int(blockIdx.x) / n_z, z = int(blockIdx.x) % n_z;
  const int kvh = z % KV, b = z / KV;
  const int P = fb::ROWS / G, PG = P * G;  // packed rows the Q / dO boxes fill
  const int pos0 = qt * P;
  const int nq = min(P, Sq - pos0);
  const int qp_lo = q_offset + pos0, qp_hi = q_offset + pos0 + nq - 1;
  int k_begin, k_end;
  key_range(qp_lo, qp_hi, Skv, causal, window, prefix_len, &k_begin, &k_end);
  const int n_tiles = (k_end - k_begin + fb::BKV - 1) / fb::BKV;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < fb::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  if (PG < fb::ROWS) {  // rows PG..63 of the Q and dO tiles: zero, never loaded
    zero_box_tails(q_tile, 2 * CH, fb::CHUNK, PG);
    fence_proxy_async();
  }
  __syncthreads();

  if (wg == 1) {
    // producer: Q, dO and the row stats once, then the ring of K / V tiles
    if (threadIdx.x == 128) {
      mbar_arrive_expect_tx(q_full, 2 * CH * PG * 128 + fb::STAT_BYTES);
      for (int ch = 0; ch < CH; ++ch) {
        tma_load_5d(q_tile + ch * fb::CHUNK, &q_map, q_full, ch * 64, 0, kvh, pos0, b);
        tma_load_5d(do_tile + ch * fb::CHUNK, &do_map, q_full, ch * 64, 0, kvh, pos0, b);
      }
      bulk_load(stats, stat + (size_t(z) * n_qt + qt) * fb::STAT, fb::STAT_BYTES, q_full);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % fb::STAGES;
        mbar_wait(&empty[s], ((i / fb::STAGES) & 1) ^ 1);
        uint8_t* st = ring + 2 * s * TILE;
        mbar_arrive_expect_tx(&full[s], 2 * TILE);
        const int kt = k_begin + i * fb::BKV;
        for (int ch = 0; ch < CH; ++ch) {
          tma_load_4d(st + ch * fb::CHUNK, &k_map, &full[s], ch * 64, kvh, kt, b);
          tma_load_4d(st + TILE + ch * fb::CHUNK, &v_map, &full[s], ch * 64, kvh, kt, b);
        }
      }
    }
  } else {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
    // this thread's two rows of the 64: warp * 16 + lane / 4 (+ 8)
    int pos[2], qp[2], head[2];
    float lse2[2], dd[2];
    bool real[2], live[2];  // a row the Q box fills; one that also exists and attends
    mbar_wait(q_full, 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + lane / 4 + 8 * h;
      pos[h] = pos0 + r / G;
      qp[h] = q_offset + pos[h];
      head[h] = kvh * G + r % G;
      lse2[h] = lds(stats + r);
      dd[h] = lds(stats + fb::ROWS + r);
      real[h] = r < PG && pos[h] < Sq;
      live[h] = real[h] && !row_empty(qp[h], Skv, causal, window, prefix_len);
    }
    float dqacc[HDP / 2];  // columns past HD stay 0 (K's are) and are not stored
#pragma unroll
    for (int x = 0; x < HDP / 2; ++x) dqacc[x] = 0.f;
    float sacc[32], dpacc[32];  // S, then dS; dP: 64 rows x 64 keys
#pragma unroll
    for (int x = 0; x < 32; ++x) sacc[x] = dpacc[x] = 0.f;
    uint32_t pa[4][4];

    // S and dP accumulate onto zeros that the register fence hides from the
    // compiler, set before each stage starts: the products then read their
    // accumulators, which stay live, and no instruction but a wgmma writes an
    // accumulator inside a stage (otherwise ptxas serialises every wgmma)
    auto zero_scores = [&] {
#pragma unroll
      for (int x = 0; x < 32; ++x) sacc[x] = dpacc[x] = 0.f;
      fence_regs(sacc);
      fence_regs(dpacc);
    };
    // S = Q K^T and dP = dO V^T of key tile i, both K-major; its K / V
    // tiles have landed
    auto launch_scores = [&](int i) {
      const uint8_t* k_s = ring + 2 * (i % fb::STAGES) * TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int off = (kk / 4) * fb::CHUNK + (kk % 4) * 32;
        wgmma_ss<64, 0, 0>(sacc, smem_desc(q_tile + off, 16, 1024),
                           smem_desc(k_s + off, 16, 1024), 1);
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int off = (kk / 4) * fb::CHUNK + (kk % 4) * 32;
        wgmma_ss<64, 0, 0>(dpacc, smem_desc(do_tile + off, 16, 1024),
                           smem_desc(k_s + TILE + off, 16, 1024), 1);
      }
      wgmma_commit();
    };

    if (n_tiles > 0) {
      zero_scores();
      mbar_wait(&full[0], 0);
      launch_scores(0);
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(dpacc);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % fb::STAGES;
      const int kt = k_begin + i * fb::BKV;
      const bool whole = kt + fb::BKV <= k_end && (!causal || kt + fb::BKV - 1 <= qp_lo) &&
                         (window <= 0 || qp_hi - kt < window);
      // sacc[x] is row (x % 4) / 2, key kt + 8 (x / 4) + 2 t + (x & 1)
#pragma unroll
      for (int x = 0; x < 32; ++x)
        sacc[x] = ex2(fmaf(sacc[x], scale_log2, -lse2[(x % 4) / 2])) *
                  (dpacc[x] - dd[(x % 4) / 2]);
      if (!whole) {
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int h = (x % 4) / 2;
          const int key = kt + 8 * (x / 4) + 2 * t + (x & 1);
          if (key >= k_end || !live[h] || !allowed(qp[h], key, causal, window, prefix_len))
            sacc[x] = 0.f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16x2(sacc[8 * kk + 0], sacc[8 * kk + 1]);
        pa[kk][1] = pack_bf16x2(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pa[kk][2] = pack_bf16x2(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pa[kk][3] = pack_bf16x2(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
      zero_scores();
      if (i + 1 < n_tiles) mbar_wait(&full[(i + 1) % fb::STAGES], ((i + 1) / fb::STAGES) & 1);
      // dQ += dS K: K is N-major (head dims contiguous), 16 keys = 2048 bytes
      // a step, over the padded HDP columns; the next tile's S and dP start
      // behind it
      const uint8_t* k_s = ring + 2 * s * TILE;
      fence_regs(dqacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<HDP, 1>(dqacc, pa[kk], smem_desc(k_s + kk * 2048, fb::CHUNK, 1024), 1);
      wgmma_commit();
      if (i + 1 < n_tiles) launch_scores(i + 1);
      wgmma_wait<0>();
      fence_regs(dqacc);
      fence_regs(sacc);
      fence_regs(dpacc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(pa[kk][r])::"memory");
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // epilogue: dqacc[4 jj + 2 h + c] is row h, head dim 8 jj + 2 t + c
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!real[h]) continue;
      __nv_bfloat16* row = dq + ((size_t(b) * Sq + pos[h]) * H + head[h]) * HD;
#pragma unroll
      for (int jj = 0; jj < HD / 8; ++jj)
        *reinterpret_cast<uint32_t*>(row + 8 * jj + 2 * t) =
            pack_bf16x2(dqacc[4 * jj + 2 * h] * scale, dqacc[4 * jj + 2 * h + 1] * scale);
    }
  }
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, float* stat, float* partial,
                         void* dq, void* dk, void* dv, int B, int Sq, int Skv, int H, int KV,
                         float scale, int causal, int window, int prefix_len, int q_offset,
                         int chunk, int splits, cudaStream_t stream) {
  constexpr size_t dkdv_bytes = fb::dkdv_smem<HD>();
  constexpr size_t dq_bytes = fb::dq_smem<HD>();
  auto dkdv = flash_bwd_dkdv_wgmma_kernel<HD>;
  auto dqk = flash_bwd_dq_wgmma_kernel<HD>;
  static const cudaError_t attr = [&] {  // once a process: the port drives one card
    cudaError_t e = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(dkdv_bytes));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                int(dq_bytes));
  }();
  if (attr != cudaSuccess) return attr;
  const int G = H / KV;
  const int P = fb::ROWS / G;
  const int n_qt = (Sq + P - 1) / P, n_kt = (Skv + fb::BKV - 1) / fb::BKV;
  CUtensorMap q_map, do_map, k_map, v_map;
  const uint64_t e = 2;  // bytes of a bf16
  // q, dO: (B, Sq, KV, G, HD) read in boxes of (1, P, 1, G, 64): P * G packed
  // rows of 128 bytes; a box's columns past HD read zeros
  const uint64_t q_sizes[5] = {uint64_t(HD), uint64_t(G), uint64_t(KV), uint64_t(Sq), uint64_t(B)};
  const uint64_t q_strides[5] = {e, e * HD, e * HD * G, e * HD * H, e * HD * H * Sq};
  const uint32_t q_box[5] = {64, uint32_t(G), 1, uint32_t(P), 1};
  // k, v: (B, Skv, KV, HD) in boxes of (1, 64 keys, 1, 64)
  const uint64_t kv_sizes[4] = {uint64_t(HD), uint64_t(KV), uint64_t(Skv), uint64_t(B)};
  const uint64_t kv_strides[4] = {e, e * HD, e * HD * KV, e * HD * KV * Skv};
  const uint32_t kv_box[4] = {64, 1, fb::BKV, 1};
  if (!repro::sm90::encode_bf16_map(&q_map, q, 5, q_sizes, q_strides, q_box) ||
      !repro::sm90::encode_bf16_map(&do_map, dout, 5, q_sizes, q_strides, q_box) ||
      !repro::sm90::encode_bf16_map(&k_map, k, 4, kv_sizes, kv_strides, kv_box) ||
      !repro::sm90::encode_bf16_map(&v_map, v, 4, kv_sizes, kv_strides, kv_box))
    return cudaErrorInvalidValue;
  const float scale_log2 = scale * fb::LOG2E;
  auto* dq_t = static_cast<__nv_bfloat16*>(dq);
  auto* dk_t = static_cast<__nv_bfloat16*>(dk);
  auto* dv_t = static_cast<__nv_bfloat16*>(dv);

  const int rows = B * KV * n_qt * fb::ROWS;
  flash_bwd_rowstat_kernel<<<(rows + NW - 1) / NW, NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), lse, stat,
      rows, Sq, H, KV, G, HD, n_qt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv<<<dim3(n_kt, splits, B * KV), 384, dkdv_bytes, stream>>>(
      q_map, do_map, k_map, v_map, stat, partial, dk_t, dv_t, Sq, Skv, KV, G, n_qt, scale,
      scale_log2, causal, window, prefix_len, q_offset, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    flash_bwd_reduce_kernel<HD><<<dim3(fb::BKV * 2 * HD / (NT * 4), n_kt, B * KV), NT, 0,
                                  stream>>>(
        partial, dk_t, dv_t, Sq, Skv, KV, P, causal, window, prefix_len, q_offset, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  dqk<<<n_qt * KV * B, 256, dq_bytes, stream>>>(q_map, do_map, k_map, v_map, stat, dq_t, Sq,
                                                    Skv, H, KV, G, n_qt, scale, scale_log2,
                                                    causal, window, prefix_len, q_offset);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tf32x3: fp32 on the tensor cores, three TF32 products a product
// ---------------------------------------------------------------------------

namespace tx {
// tf32_bits, split, mma_tf32, mma3, prod_rows, prod_acc, stage, stage_split:
// the three-TF32-product machinery this variant shares with the forward's
using namespace repro::tf32x3;
constexpr int KT = 64;  // keys of a dK/dV block: 16 a warp, in each half of its 8 warps
constexpr int QR = 64;  // query rows of a dQ block: 16 a row group of two warps
// Query rows a dK/dV visit stages, and keys a dQ visit stages: the tiles
// that keep a block in the shared memory (two blocks an SM up to hd 80).
template <int HD>
__host__ __device__ constexpr int walk_rows() { return HD <= 160 ? 32 : 16; }
template <int HD>
__host__ __device__ constexpr int blocks_per_sm() { return HD <= 80 ? 2 : 1; }
// Keys a dQ visit stages: 64 up to hd 128, then fewer, so that the block's
// tiles fit the shared memory.
template <int HD>
__host__ __device__ constexpr int dq_keys() { return HD <= 128 ? 64 : walk_rows<HD>(); }
template <int HD>
constexpr size_t dkdv_smem() {  // K, V; Q and dO as (hi, lo); P^T; lse, D, row state
  constexpr int BQ = walk_rows<HD>();
  return sizeof(float) * (size_t(2 * KT + 4 * BQ) * (HD + 4) + size_t(KT) * (BQ + 8) + 3 * BQ);
}
template <int HD>
constexpr size_t dq_smem() {  // Q, dO; K and V as (hi, lo); lse, D, row state
  return sizeof(float) * (size_t(2 * QR + 4 * dq_keys<HD>()) * (HD + 4) + 3 * QR);
}

// lse, D and the row state (live, empty, absent) of query rows [i0, i0 + n)
// of head h into ROWS entries each.
template <int ROWS>
__device__ __forceinline__ void stage_stats(float* lse_s, float* D_s, float* st_s,
                                            const float* lse_h, const float* D_h, int i0, int n,
                                            int Skv, int causal, int window, int prefix_len,
                                            int q_offset) {
  for (int x = threadIdx.x; x < ROWS; x += NT) {
    const int i = i0 + x;
    const bool in = x < n;
    lse_s[x] = in ? lse_h[i] : 0.f;
    D_s[x] = in ? D_h[i] : 0.f;
    st_s[x] = !in ? ROW_ABSENT
                  : (row_empty(q_offset + i, Skv, causal, window, prefix_len) ? ROW_EMPTY
                                                                               : ROW_LIVE);
  }
}

}  // namespace tx

// dK, dV: a block per (key tile of 64, split of its walk, b * KV + kvh),
// eight warps: warp w < 4 owns keys 16w .. 16w + 15 and computes S^T = K Q^T,
// P^T and dV += P^T dO; warp w + 4 owns the same keys and computes dP^T = V
// dO^T, dS^T = P^T (dP^T - D) (P^T from warp w through shared memory) and dK
// += dS^T Q. The walk visits (query head, query tile of BQ) pairs, heads
// outermost; a split block takes `chunk` of them and writes its fp32
// partial (dK scaled), a tile walked whole is written by its one block.
template <int HD>
__global__ void __launch_bounds__(NT, tx::blocks_per_sm<HD>()) flash_bwd_dkdv_tf32x3_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ partial, int Sq, int Skv, int H, int KV, float scale, int causal,
    int window, int prefix_len, int q_offset, int chunk) {
  constexpr int BQ = tx::walk_rows<HD>(), LD = HD + 4, LP = BQ + 8, NJ = BQ / 8, N8 = HD / 8;
  constexpr int KT = tx::KT;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;           // [KT][LD]
  float* Vs = Ks + KT * LD;   // [KT][LD]
  float* Qh = Vs + KT * LD;   // [BQ][LD] each
  float* Ql = Qh + BQ * LD;
  float* Oh = Ql + BQ * LD;
  float* Ol = Oh + BQ * LD;
  float* Ps = Ol + BQ * LD;   // [KT][LP] P^T
  float* lse_s = Ps + KT * LP;
  float* D_s = lse_s + BQ;
  float* st_s = D_s + BQ;

  const int j = blockIdx.x, k0 = j * KT, split = blockIdx.y, z = blockIdx.z;
  const int b = z / KV, kvh = z % KV, G = H / KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const bool vwarp = warp < 4;
  const int kw = 16 * (warp & 3);  // this warp's first key in the tile
  const int nk = min(KT, Skv - k0);
  int lo, hi;
  query_tiles(j, Sq, Skv, BQ, causal, window, prefix_len, q_offset, &lo, &hi);
  const int nq = hi - lo, pairs = G * nq;
  const int splits = walk_splits(pairs, chunk);
  if (split >= splits) return;  // the whole block: past this tile's walk
  const int p_begin = splits > 1 ? split * chunk : 0;
  const int p_end = splits > 1 ? min(pairs, p_begin + chunk) : pairs;

  const size_t kv_row = size_t(KV) * HD, q_row = size_t(H) * HD;
  tx::stage<HD, KT, NT>(Ks, k + (size_t(b) * Skv + k0) * kv_row + size_t(kvh) * HD, kv_row, nk);
  tx::stage<HD, KT, NT>(Vs, v + (size_t(b) * Skv + k0) * kv_row + size_t(kvh) * HD, kv_row, nk);

  float acc[N8][4];  // dV (warps 0-3) or dK (4-7) of this warp's 16 keys
#pragma unroll
  for (int n = 0; n < N8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float inv_skv = 1.f / float(Skv);

  for (int p = p_begin; p < p_end; ++p) {
    const int h = kvh * G + p / nq, i0 = (lo + p % nq) * BQ, nrow = min(BQ, Sq - i0);
    __syncthreads();  // K / V staged, or the previous pair consumed
    const size_t off = (size_t(b) * Sq + i0) * q_row + size_t(h) * HD;
    tx::stage_split<HD, BQ, NT>(Qh, Ql, q + off, q_row, nrow);
    tx::stage_split<HD, BQ, NT>(Oh, Ol, dout + off, q_row, nrow);
    tx::stage_stats<BQ>(lse_s, D_s, st_s, lse + (size_t(b) * H + h) * Sq,
                        delta + (size_t(b) * H + h) * Sq, i0, nrow, Skv, causal, window,
                        prefix_len, q_offset);
    __syncthreads();

    // S^T = K Q^T (warps 0-3) or dP^T = V dO^T (4-7): keys kw + g (+ 8),
    // queries 8 jj + 2c (+ 1)
    float s[NJ][4];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) s[jj][0] = s[jj][1] = s[jj][2] = s[jj][3] = 0.f;
    if (vwarp)
      tx::prod_rows<HD, NJ>(s, Ks + kw * LD, Qh, Ql, lane);
    else
      tx::prod_rows<HD, NJ>(s, Vs + kw * LD, Oh, Ol, lane);
    if (vwarp) {
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + kw + g + (e >> 1) * 8, x = 8 * jj + 2 * c + (e & 1);
          const float st = st_s[x];
          float pv = 0.f;
          if (key < Skv && st != ROW_ABSENT) {
            if (st == ROW_EMPTY)
              pv = inv_skv;
            else if (allowed(q_offset + i0 + x, key, causal, window, prefix_len))
              pv = expf(s[jj][e] * scale - lse_s[x]);
          }
          s[jj][e] = pv;
        }
        float* row = Ps + (kw + g) * LP + 8 * jj + 2 * c;
        *reinterpret_cast<float2*>(row) = make_float2(s[jj][0], s[jj][1]);
        *reinterpret_cast<float2*>(row + 8 * LP) = make_float2(s[jj][2], s[jj][3]);
      }
    }
    __syncthreads();  // P^T handed over
    if (vwarp) {
      tx::prod_acc<HD, NJ>(acc, s, Oh, Ol, lane);  // dV += P^T dO
    } else {
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float* row = Ps + (kw + g) * LP + 8 * jj + 2 * c;
        const float2 p0 = *reinterpret_cast<const float2*>(row);
        const float2 p1 = *reinterpret_cast<const float2*>(row + 8 * LP);
        const float pt[4] = {p0.x, p0.y, p1.x, p1.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // dS^T: 0 for masked pairs and rows without a key
          const int x = 8 * jj + 2 * c + (e & 1);
          s[jj][e] = st_s[x] == ROW_LIVE ? pt[e] * (s[jj][e] - D_s[x]) : 0.f;
        }
      }
      tx::prod_acc<HD, NJ>(acc, s, Qh, Ql, lane);  // dK += dS^T Q
    }
  }

  // this warp's 16 keys: rows kw + g (+ 8), columns 8n + 2c (+ 1)
  const float mul = vwarp ? 1.f : scale;
  if (splits == 1) {
    float* out = vwarp ? dv : dk;
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const int key = kw + g + 8 * h8;
      if (key >= nk) continue;
      float* row = out + ((size_t(b) * Skv + k0 + key) * KV + kvh) * HD + 2 * c;
#pragma unroll
      for (int n = 0; n < N8; ++n)
        *reinterpret_cast<float2*>(row + 8 * n) =
            make_float2(acc[n][2 * h8] * mul, acc[n][2 * h8 + 1] * mul);
    }
  } else {
    const size_t n_keys = size_t(gridDim.x) * KT;
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const int key = kw + g + 8 * h8;
      float* row = partial + (((size_t(split) * gridDim.z + z) * n_keys + k0 + key) * 2 +
                              (vwarp ? 1 : 0)) * HD + 2 * c;
#pragma unroll
      for (int n = 0; n < N8; ++n)
        *reinterpret_cast<float2*>(row + 8 * n) =
            make_float2(acc[n][2 * h8] * mul, acc[n][2 * h8 + 1] * mul);
    }
  }
}

// The split walks' partial dK, dV added in split order (the same bits every
// run): a block per (slice of NT * 4 floats of a key tile's 64 x 2 x HD,
// key tile, b * KV + kvh), one float4 a thread; tiles walked whole are done.
template <int HD>
__global__ void __launch_bounds__(NT) flash_bwd_reduce_tf32x3_kernel(
    const float* __restrict__ partial, float* __restrict__ dk, float* __restrict__ dv, int Sq,
    int Skv, int KV, int G, int causal, int window, int prefix_len, int q_offset, int chunk) {
  constexpr int BQ = tx::walk_rows<HD>(), KT = tx::KT;
  const int j = blockIdx.y, z = blockIdx.z, n_kt = gridDim.y;
  int lo, hi;
  query_tiles(j, Sq, Skv, BQ, causal, window, prefix_len, q_offset, &lo, &hi);
  const int splits = walk_splits(G * (hi - lo), chunk);
  const int e = (blockIdx.x * NT + threadIdx.x) * 4;  // float offset in the key tile's block
  if (e >= KT * 2 * HD) return;
  const int r = e / (2 * HD), which = (e / HD) % 2, d = e % HD;
  const int key = j * KT + r;
  if (splits == 1 || key >= Skv) return;
  const int b = z / KV, kvh = z % KV;
  const size_t split_stride = size_t(gridDim.z) * n_kt * KT * 2 * HD;
  const float* src = partial + (size_t(z) * n_kt + j) * KT * 2 * HD + e;
  float4 sum = *reinterpret_cast<const float4*>(src);
  for (int s = 1; s < splits; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(src + s * split_stride);
    sum.x += x.x;
    sum.y += x.y;
    sum.z += x.z;
    sum.w += x.w;
  }
  float* out = (which == 0 ? dk : dv) + ((size_t(b) * Skv + key) * KV + kvh) * HD + d;
  *reinterpret_cast<float4*>(out) = sum;
}

// dQ: a block per (64 query rows of one head, batch), eight warps: warp w
// holds rows 16 (w % 4) .. + 15 and takes half w / 4 of every key tile of BK
// (`tx::dq_keys`) it walks (the forward's key range): S = Q K^T, dP = dO V^T, dS = P (dP -
// D), dQ += dS K, all in registers; the two halves' dQ are added in a fixed
// order at the end. Query tiles outermost from the last, so that the
// longest causal walks of every (batch, head) start first.
template <int HD>
__global__ void __launch_bounds__(NT, tx::blocks_per_sm<HD>()) flash_bwd_dq_tf32x3_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int Sq, int Skv, int H, int KV,
    float scale, int causal, int window, int prefix_len, int q_offset, int n_qt, int B) {
  constexpr int BK = tx::dq_keys<HD>(), LD = HD + 4, NJ = BK / 16, N8 = HD / 8;
  constexpr int QR = tx::QR;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;          // [QR][LD]
  float* Os = Qs + QR * LD;  // [QR][LD]
  float* Kh = Os + QR * LD;  // [BK][LD] each
  float* Kl = Kh + BK * LD;
  float* Vh = Kl + BK * LD;
  float* Vl = Vh + BK * LD;
  float* lse_s = Vl + BK * LD;
  float* D_s = lse_s + QR;
  float* st_s = D_s + QR;

  const int qt = n_qt - 1 - int(blockIdx.x / (H * B)), rest = blockIdx.x % (H * B);
  const int h = rest % H, b = rest / H, kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int rg = 16 * (warp & 3), kb = (warp >> 2) * (BK / 2);  // rows, first key of the half
  const int i0 = qt * QR, nrow = min(QR, Sq - i0);
  const size_t q_row = size_t(H) * HD, kv_row = size_t(KV) * HD;
  const size_t off = (size_t(b) * Sq + i0) * q_row + size_t(h) * HD;
  tx::stage<HD, QR, NT>(Qs, q + off, q_row, nrow);
  tx::stage<HD, QR, NT>(Os, dout + off, q_row, nrow);
  tx::stage_stats<QR>(lse_s, D_s, st_s, lse + (size_t(b) * H + h) * Sq,
                      delta + (size_t(b) * H + h) * Sq, i0, nrow, Skv, causal, window,
                      prefix_len, q_offset);
  int k_begin, k_end;
  key_range(q_offset + i0, q_offset + i0 + nrow - 1, Skv, causal, window, prefix_len, &k_begin,
            &k_end);

  float acc[N8][4];
#pragma unroll
  for (int n = 0; n < N8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int kt = k_begin; kt < k_end; kt += BK) {
    const int nk = min(BK, k_end - kt);
    __syncthreads();  // Q / dO staged, or the previous tile consumed
    const size_t koff = (size_t(b) * Skv + kt) * kv_row + size_t(kvh) * HD;
    tx::stage_split<HD, BK, NT>(Kh, Kl, k + koff, kv_row, nk);
    tx::stage_split<HD, BK, NT>(Vh, Vl, v + koff, kv_row, nk);
    __syncthreads();
    float s[NJ][4], dp[NJ][4];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jj][e] = dp[jj][e] = 0.f;
    tx::prod_rows<HD, NJ>(s, Qs + rg * LD, Kh + kb * LD, Kl + kb * LD, lane);
    tx::prod_rows<HD, NJ>(dp, Os + rg * LD, Vh + kb * LD, Vl + kb * LD, lane);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // rows rg + g (+ 8), keys kt + kb + 8 jj + 2c (+ 1)
        const int x = rg + g + (e >> 1) * 8, kl = kb + 8 * jj + 2 * c + (e & 1);
        float ds = 0.f;
        if (kl < nk && st_s[x] == ROW_LIVE &&
            allowed(q_offset + i0 + x, kt + kl, causal, window, prefix_len))
          ds = expf(s[jj][e] * scale - lse_s[x]) * (dp[jj][e] - D_s[x]);
        s[jj][e] = ds;
      }
    }
    tx::prod_acc<HD, NJ>(acc, s, Kh + kb * LD, Kl + kb * LD, lane);  // dQ += dS K
  }

  // dQ = scale (first half + second half), over the K / V tiles' room
  __syncthreads();
  float* red = Kh;  // [QR][LD]: QR <= 4 * BK rows of the K / V room
  if (warp >= 4) {
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      *reinterpret_cast<float2*>(red + (rg + g) * LD + 8 * n + 2 * c) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(red + (rg + g + 8) * LD + 8 * n + 2 * c) =
          make_float2(acc[n][2], acc[n][3]);
    }
  }
  __syncthreads();
  if (warp < 4) {
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const int x = rg + g + 8 * h8;
      if (x >= nrow) continue;
      float* row = dq + (size_t(b) * Sq + i0 + x) * q_row + size_t(h) * HD + 2 * c;
      const float* other = red + x * LD + 2 * c;
#pragma unroll
      for (int n = 0; n < N8; ++n) {
        const float2 o = *reinterpret_cast<const float2*>(other + 8 * n);
        *reinterpret_cast<float2*>(row + 8 * n) = make_float2(
            (acc[n][2 * h8] + o.x) * scale, (acc[n][2 * h8 + 1] + o.y) * scale);
      }
    }
  }
}

template <int HD>
cudaError_t launch_tf32x3(const float* q, const float* k, const float* v, const float* o,
                          const float* dout, const float* lse, float* delta, float* partial,
                          float* dq, float* dk, float* dv, int B, int Sq, int Skv, int H, int KV,
                          float scale, int causal, int window, int prefix_len, int q_offset,
                          int chunk, int splits, cudaStream_t stream) {
  static_assert(tx::QR <= 4 * tx::dq_keys<HD>(), "dQ's reduction fits the K / V room");
  constexpr int BQ = tx::walk_rows<HD>();
  const size_t pairs = size_t(H / KV) * ((Sq + BQ - 1) / BQ);
  if (chunk < 1 || splits < 1 || size_t(splits) * chunk < pairs ||
      (splits > 1 && partial == nullptr))
    return cudaErrorInvalidValue;
  static_assert(tx::KT == fb::BKV, "query_tiles walks key tiles of the wgmma variant's size");
  constexpr size_t dkdv_bytes = tx::dkdv_smem<HD>(), dq_bytes = tx::dq_smem<HD>();
  auto dkdv = flash_bwd_dkdv_tf32x3_kernel<HD>;
  auto dqk = flash_bwd_dq_tf32x3_kernel<HD>;
  static const cudaError_t attr = [&] {  // once a process: the port drives one card
    cudaError_t e = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(dkdv_bytes));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                int(dq_bytes));
  }();
  if (attr != cudaSuccess) return attr;
  const int rows = B * Sq * H;
  flash_bwd_delta_kernel<float><<<(rows + NW - 1) / NW, NT, 0, stream>>>(o, dout, delta, rows,
                                                                          Sq, H, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_kt = (Skv + tx::KT - 1) / tx::KT;
  dkdv<<<dim3(n_kt, splits, B * KV), NT, dkdv_bytes, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, partial, Sq, Skv, H, KV, scale, causal, window,
      prefix_len, q_offset, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    constexpr int slices = (tx::KT * 2 * HD / 4 + NT - 1) / NT;
    flash_bwd_reduce_tf32x3_kernel<HD><<<dim3(slices, n_kt, B * KV), NT, 0, stream>>>(
        partial, dk, dv, Sq, Skv, KV, H / KV, causal, window, prefix_len, q_offset, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int n_qt = (Sq + tx::QR - 1) / tx::QR;
  dqk<<<n_qt * H * B, NT, dq_bytes, stream>>>(q, k, v, dout, lse, delta, dq, Sq, Skv, H, KV,
                                              scale, causal, window, prefix_len, q_offset, n_qt,
                                              B);
  return cudaGetLastError();
}

// The tf32x3 tiling at HD as the kernels are built: query rows a dK/dV visit
// stages, the blocks an SM its launch bounds ask for, and the dK/dV blocks
// the card keeps resident on an SM with their shared memory.
template <int HD>
cudaError_t tiling_tf32x3(int* walk_rows, int* blocks_per_sm, int* resident) {
  auto dkdv = flash_bwd_dkdv_tf32x3_kernel<HD>;
  constexpr size_t dkdv_bytes = tx::dkdv_smem<HD>();
  cudaError_t e = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(dkdv_bytes));
  if (e != cudaSuccess) return e;
  *walk_rows = tx::walk_rows<HD>();
  *blocks_per_sm = tx::blocks_per_sm<HD>();
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, dkdv, NT, dkdv_bytes);
}

}  // namespace

// The tf32x3 kernels' tiling at head dim `hd` (what the host's plan copies):
// see `tiling_tf32x3`. Returns the first cudaError_t that is not success.
extern "C" int flash_attention_bwd_tf32x3_tiling(int hd, int* walk_rows, int* blocks_per_sm,
                                                 int* resident) {
  switch (hd) {
    case 16: return int(tiling_tf32x3<16>(walk_rows, blocks_per_sm, resident));
    case 32: return int(tiling_tf32x3<32>(walk_rows, blocks_per_sm, resident));
    case 64: return int(tiling_tf32x3<64>(walk_rows, blocks_per_sm, resident));
    case 80: return int(tiling_tf32x3<80>(walk_rows, blocks_per_sm, resident));
    case 112: return int(tiling_tf32x3<112>(walk_rows, blocks_per_sm, resident));
    case 128: return int(tiling_tf32x3<128>(walk_rows, blocks_per_sm, resident));
    case 160: return int(tiling_tf32x3<160>(walk_rows, blocks_per_sm, resident));
    case 256: return int(tiling_tf32x3<256>(walk_rows, blocks_per_sm, resident));
    default: return int(cudaErrorInvalidValue);
  }
}

// C entry point. q, o, dout, dq: (B, Sq, H, hd); k, v, dk, dv: (B, Skv, KV,
// hd); lse: fp32 (B, H, Sq); contiguous, one dtype (0 fp32, 1 bf16) for the
// rest; q_offset >= 0. `variant` 0 simt: `delta` is fp32 scratch of (B, H,
// Sq); `partial`, `chunk` and `splits` are unused. 1 wgmma (bf16; hd 64 /
// 80 / 112 / 128 / 160 / 256; G = H / KV at most 64; every pointer 16-byte
// aligned): `delta` is fp32 scratch of B * KV * n_qt * 128 floats (n_qt =
// ceil(Sq / P) query tiles of P = 64 / G positions, 64 packed rows with
// padding), a dK/dV walk covers at most `chunk` query
// tiles, `splits` >= ceil(n_qt / chunk) is the grid's split dimension and,
// when above 1, `partial` is fp32 scratch of splits * B * KV * ceil(Skv /
// 64) * 64 * 2 * hd floats. 2 tf32x3 (fp32; every supported hd and G; every
// pointer 16-byte aligned): `delta` is fp32 scratch of (B, H, Sq), a dK/dV
// walk covers at most `chunk` (query head, query tile of BQ =
// tx::walk_rows<hd>) pairs, `splits` >= ceil(G * ceil(Sq / BQ) / chunk)
// and, when above 1, `partial` is as for wgmma. Three (simt), three to
// four (wgmma, tf32x3) launches on `stream`; returns the first cudaError_t
// that is not success.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, float* partial, int B, int Sq, int Skv,
                                   int H, int KV, int hd, int dtype, float scale, int causal,
                                   int window, int prefix_len, int q_offset, int variant,
                                   int chunk, int splits, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0 || q_offset < 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    using repro::sm90::aligned16;
    const int G = H / KV;
    if (dtype != repro::kBFloat16 || G > fb::ROWS) return int(cudaErrorInvalidValue);
    const int n_qt = (Sq + fb::ROWS / G - 1) / (fb::ROWS / G);
    if (chunk < 1 || splits < 1 || size_t(splits) * chunk < size_t(n_qt) ||
        (splits > 1 && partial == nullptr))
      return int(cudaErrorInvalidValue);
    const void* ptrs[] = {q, k, v, o, dout, delta, dq, dk, dv};
    for (const void* p : ptrs)
      if (!aligned16(p)) return int(cudaErrorInvalidValue);
    if (splits > 1 && !aligned16(partial)) return int(cudaErrorInvalidValue);
#define REPRO_BWD_WGMMA(N)                                                                  \
  case N:                                                                                   \
    return int(launch_wgmma<N>(q, k, v, o, dout, lse, delta, partial, dq, dk, dv, B, Sq, Skv, \
                               H, KV, scale, causal, window, prefix_len, q_offset, chunk,   \
                               splits, s));
    switch (hd) {
      REPRO_BWD_WGMMA(64)
      REPRO_BWD_WGMMA(80)
      REPRO_BWD_WGMMA(112)
      REPRO_BWD_WGMMA(128)
      REPRO_BWD_WGMMA(160)
      REPRO_BWD_WGMMA(256)
      default:
        return int(cudaErrorInvalidValue);
    }
#undef REPRO_BWD_WGMMA
  }
  if (variant == 2) {
    using repro::sm90::aligned16;
    if (dtype != repro::kFloat32) return int(cudaErrorInvalidValue);
    const void* ptrs[] = {q, k, v, o, dout, dq, dk, dv};
    for (const void* p : ptrs)
      if (!aligned16(p)) return int(cudaErrorInvalidValue);
    if (splits > 1 && !aligned16(partial)) return int(cudaErrorInvalidValue);
    const float* f[] = {static_cast<const float*>(q), static_cast<const float*>(k),
                        static_cast<const float*>(v), static_cast<const float*>(o),
                        static_cast<const float*>(dout)};
#define REPRO_BWD_TF32X3(N)                                                                 \
  case N:                                                                                   \
    return int(launch_tf32x3<N>(f[0], f[1], f[2], f[3], f[4], lse, delta, partial,          \
                                static_cast<float*>(dq), static_cast<float*>(dk),           \
                                static_cast<float*>(dv), B, Sq, Skv, H, KV, scale, causal,  \
                                window, prefix_len, q_offset, chunk, splits, s));
    switch (hd) {
      REPRO_BWD_TF32X3(16)
      REPRO_BWD_TF32X3(32)
      REPRO_BWD_TF32X3(64)
      REPRO_BWD_TF32X3(80)
      REPRO_BWD_TF32X3(112)
      REPRO_BWD_TF32X3(128)
      REPRO_BWD_TF32X3(160)
      REPRO_BWD_TF32X3(256)
      default:
        return int(cudaErrorInvalidValue);
    }
#undef REPRO_BWD_TF32X3
  }
  if (variant != 0) return int(cudaErrorInvalidValue);
  if (dtype == repro::kFloat32)
    return int(dispatch_hd<float>(hd, q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H,
                                  KV, scale, causal, window, prefix_len, q_offset, s));
  if (dtype == repro::kBFloat16)
    return int(dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq,
                                          Skv, H, KV, scale, causal, window, prefix_len,
                                          q_offset, s));
  return int(cudaErrorInvalidValue);
}
