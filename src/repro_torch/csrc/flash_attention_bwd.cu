// Flash attention backward for Hopper (sm_90a), hand-written CUDA C++.
//
// The gradient of `flash_attention.cu`'s forward: given q, k, v, the
// forward's output o and its per-row log-sum-exp lse (fp32, (B, H, Sq)), and
// the output's gradient dO, it writes dQ, dK and dV. The reference has no
// counterpart: its Pallas kernel `repro/kernels/flash_attention.py::
// flash_attention` has no VJP, and the reference trains through its jnp
// oracle `repro/kernels/ref.py::attention`, whose gradient this reproduces
// (`kernels/ref.py::attention_backward` is the same formulas in plain
// PyTorch). With P = exp(scale * q k^T - lse) on the keys a row may attend
// (causal, static window, prefix-LM, q_offset: the forward's masks exactly)
// and D = rowsum(dO * o):
//
//     dV = P^T dO        dP = dO V^T        dS = P * (dP - D)
//     dQ = scale * dS K  dK = scale * dS^T Q
//
// A row with no key it may attend (a window past the last key) is the
// reference's uniform average: P = 1 / Skv on every key, no gradient to q or
// k. The wrapper requires q_offset >= 0, where that is the only such row.
//
// Three launches a call:
// * delta: D = rowsum(dO * o), one warp a (b, position, head) row;
// * dK/dV: one block per (key tile of 32, KV head, batch) walks every
//   query tile that can see its keys, for all G query heads of its KV group
//   (gemma3: 4 over 1), and keeps dK and dV in fp32 registers: no atomics,
//   so every run gives the same bits;
// * dQ: one block per (query tile of 32, query head, batch) walks the key
//   tiles its rows can attend (the forward's key range) and keeps dQ in fp32
//   registers.
// Each recomputes S and dP from K/V and Q/dO tiles staged in fp32 shared
// memory (rows padded to an odd stride: conflict-free column reads).
//
// What bounds it on the H100: at gemma3-1b's training shape (B=4, S=1024,
// 4 query heads over 1 at head_dim 256, causal, bf16) the work is 5 products
// over half the score matrix, 21.5 GFLOP: 21.7 us at the tensor cores' 989
// TFLOP/s, against ~42 MB of bytes (12.5 us). This first version is simple
// and exact: scalar fp32 FMA on the CUDA cores (67 TFLOP/s peak), 7
// products (S and dP are recomputed in both walks), and tiles of 32 whose
// score stage reads shared memory about as often as it multiplies, so it
// runs far from that bound; a tensor-core (`wgmma`) version is later work.
#include "common.cuh"

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
    REPRO_BWD_HD(112)
    REPRO_BWD_HD(128)
    REPRO_BWD_HD(160)
    REPRO_BWD_HD(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_BWD_HD
}

}  // namespace

// C entry point. q, o, dout, dq: (B, Sq, H, hd); k, v, dk, dv: (B, Skv, KV,
// hd); lse, delta: fp32 (B, H, Sq) (delta is scratch); contiguous, one dtype
// (0 fp32, 1 bf16) for the rest; q_offset >= 0. Three launches on `stream`;
// returns the first cudaError_t that is not success.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, int B, int Sq, int Skv, int H, int KV,
                                   int hd, int dtype, float scale, int causal, int window,
                                   int prefix_len, int q_offset, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0 || q_offset < 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return int(dispatch_hd<float>(hd, q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H,
                                  KV, scale, causal, window, prefix_len, q_offset, s));
  if (dtype == repro::kBFloat16)
    return int(dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq,
                                          Skv, H, KV, scale, causal, window, prefix_len,
                                          q_offset, s));
  return int(cudaErrorInvalidValue);
}
