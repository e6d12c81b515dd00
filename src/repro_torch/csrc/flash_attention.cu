// Flash attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the reference's Pallas TPU kernel
// `repro/kernels/flash_attention.py::flash_attention` (`_kernel`): online-
// softmax attention with causal, static sliding-window, prefix-LM and static
// q_offset masking, and native GQA (query head h reads KV head h / groups,
// repeated K/V is never materialised). Inputs fp32 or bf16, all arithmetic
// in fp32, output in the input dtype.
//
// What bounds it on the H100: at the serving path's prefill shapes (one
// prompt of 64-1024 tokens, 4 query heads over 1 KV head, head_dim 256) the
// work is a few GFLOP per call, so launch overhead and the bytes of Q, K, V
// and O dominate, not the tensor cores. Design against that: one block per
// (32 query rows, head, batch) so a 1024-token prompt already fills 128
// blocks; K/V tiles of 32 keys are staged once in shared memory and shared
// by all 32 query rows; the key loop visits only the tiles a block's rows
// can attend to (causal upper bound, window lower bound), which is exact
// whenever every row has at least one valid key (checked per block; blocks
// with a row that has none visit every tile, as the Pallas kernel does).
// Ragged Sq / Skv are masked here: the Pallas wrapper's block-multiple
// assertion does not apply. The 32 x head_dim fp32 output accumulator lives
// in registers (head_dim / 8 floats per thread). Scalar FMA on CUDA cores;
// tensor cores (wgmma) and TMA are later work.
#include "common.cuh"

namespace {

using repro::NEG_INF;

constexpr int BQ = 32;               // query rows per block
constexpr int BK = 32;               // keys per tile: one per lane in the score stage
constexpr int NT = 256;              // threads per block
constexpr int NW = NT / 32;          // warps
constexpr int ROWS_PER_WARP = BQ / NW;
constexpr int DG = NT / BQ;          // threads sharing one query row in the PV stage

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(BQ) * HD          // Qs  [BQ][HD], pre-scaled
                          + size_t(BK) * (HD + 1)  // Ks  [BK][HD+1], padded: conflict-free rows
                          + size_t(BK) * HD        // Vs  [BK][HD]
                          + size_t(BQ) * (BK + 1)  // Ps  [BQ][BK+1]
                          + BQ);                   // per-row rescale factor, then final denom
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Skv, int H, int KV, float scale, int causal,
    int window, int prefix_len, int q_offset) {
  static_assert(HD % DG == 0, "head_dim must be a multiple of 8");
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * HD;
  float* Vs = Ks + BK * (HD + 1);
  float* Ps = Vs + BK * HD;
  float* row_s = Ps + BQ * (BK + 1);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nq = min(BQ, Sq - q0);

  // layouts: q, o (B, Sq, H, HD); k, v (B, Skv, KV, HD), all contiguous
  const size_t q_row = size_t(H) * HD;
  const size_t kv_row = size_t(KV) * HD;
  const T* qb = q + (size_t(b) * Sq + q0) * q_row + size_t(h) * HD;
  const T* kb = k + size_t(b) * Skv * kv_row + size_t(kvh) * HD;
  const T* vb = v + size_t(b) * Skv * kv_row + size_t(kvh) * HD;

  for (int e = tid; e < BQ * HD; e += NT) {
    const int i = e / HD, d = e % HD;
    Qs[e] = i < nq ? repro::to_float(qb[size_t(i) * q_row + d]) * scale : 0.f;
  }

  // Key range this block visits. Keys outside [k_begin, k_end) are left out
  // entirely, which equals masking them when every row has a valid key.
  const int qp_lo = q_offset + q0;
  const int qp_hi = q_offset + q0 + nq - 1;
  const bool rows_nonempty = (!causal || qp_lo >= 0 || prefix_len > 0) &&
                             (window <= 0 || qp_hi <= Skv + window - 2);
  int k_begin = 0, k_end = Skv;
  if (rows_nonempty) {
    if (window > 0) k_begin = max(0, qp_lo - window + 1);
    if (causal) {
      int hi = qp_hi + 1;
      if (prefix_len > 0 && qp_lo < prefix_len) hi = max(hi, prefix_len);
      k_end = min(Skv, hi);
    }
  }

  float m_r[ROWS_PER_WARP], l_r[ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    m_r[r] = NEG_INF;
    l_r[r] = 0.f;
  }
  constexpr int NC = HD / DG;
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;
  const int pr = tid / DG;  // PV stage: query row
  const int pg = tid % DG;  // PV stage: dims pg, pg + 8, pg + 16, ...

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();  // Qs written / previous tile fully consumed
    for (int e = tid; e < BK * HD; e += NT) {
      const int j = e / HD, d = e % HD;
      const int key = kt + j;
      const bool ok = key < k_end;
      Ks[j * (HD + 1) + d] = ok ? repro::to_float(kb[size_t(key) * kv_row + d]) : 0.f;
      Vs[j * HD + d] = ok ? repro::to_float(vb[size_t(key) * kv_row + d]) : 0.f;
    }
    __syncthreads();

    // scores: lane = key, each warp owns rows warp, warp + NW, ...
    const int key = kt + lane;
    const bool in_range = key < k_end;
    float s[ROWS_PER_WARP];
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) s[r] = 0.f;
    const float* krow = Ks + lane * (HD + 1);
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int r = 0; r < ROWS_PER_WARP; ++r) s[r] += Qs[(warp + NW * r) * HD + d] * kd;
    }

    // mask + online softmax, one row per warp-wide reduction
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int i = warp + NW * r;
      const int qp = q_offset + q0 + i;
      bool allowed = true;
      if (causal) {
        allowed = key <= qp;
        if (prefix_len > 0) allowed = allowed || (qp < prefix_len && key < prefix_len);
      }
      if (window > 0) allowed = allowed && (qp - key < window);
      const float sv = in_range ? (allowed ? s[r] : NEG_INF) : REPRO_ABSENT;
      const float m_new = fmaxf(m_r[r], repro::warp_max(sv));
      const float p = in_range ? expf(sv - m_new) : 0.f;
      const float alpha = expf(m_r[r] - m_new);
      l_r[r] = alpha * l_r[r] + repro::warp_sum(p);
      m_r[r] = m_new;
      Ps[i * (BK + 1) + lane] = p;
      if (lane == 0) row_s[i] = alpha;
    }
    __syncthreads();

    // acc = alpha * acc + P @ V
    const float a = row_s[pr];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] *= a;
    const float* prow = Ps + pr * (BK + 1);
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float p = prow[j];
      const float* vrow = Vs + j * HD + pg;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] += p * vrow[c * DG];
    }
  }

  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) row_s[warp + NW * r] = l_r[r];
  }
  __syncthreads();
  if (pr < nq) {
    const float denom = fmaxf(row_s[pr], 1e-30f);
    T* orow = o + (size_t(b) * Sq + q0 + pr) * q_row + size_t(h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[pg + c * DG] = repro::from_float<T>(acc[c] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                   int Skv, int H, int KV, float scale, int causal, int window,
                   int prefix_len, int q_offset, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD>();
  auto kernel = flash_attention_kernel<T, HD>;
  if (bytes > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return err;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H,
                                      KV, scale, causal, window, prefix_len, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B,
                        int Sq, int Skv, int H, int KV, float scale, int causal, int window,
                        int prefix_len, int q_offset, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window, prefix_len, q_offset, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window, prefix_len, q_offset, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window, prefix_len, q_offset, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window, prefix_len, q_offset, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window, prefix_len, q_offset, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point. q, o: (B, Sq, H, hd); k, v: (B, Skv, KV, hd); contiguous,
// one dtype (0 fp32, 1 bf16). Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int Sq, int Skv, int H, int KV, int hd, int dtype,
                                   float scale, int causal, int window, int prefix_len,
                                   int q_offset, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return int(dispatch_hd<float>(hd, q, k, v, o, B, Sq, Skv, H, KV, scale, causal, window,
                                  prefix_len, q_offset, s));
  if (dtype == repro::kBFloat16)
    return int(dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Skv, H, KV, scale, causal,
                                          window, prefix_len, q_offset, s));
  return int(cudaErrorInvalidValue);
}

// Message of a cudaError_t returned by an entry point of this library.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
