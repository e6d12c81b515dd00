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
// What bounds it on the H100: bytes. Each call reads the K and V rows of
// every valid position once and does 4 * groups * head_dim FLOP per position
// (bf16 on the serving path), far below the card's ridge point. The Pallas
// kernel walks the cache in order on one core, carrying (m, l, acc) in VMEM
// scratch across its sequential grid axis; here that axis becomes split-K:
// each block takes one (slot, KV head, split of `split_len` positions) and
// walks only the valid positions of its split in chunks of 32, with all
// `groups` query heads sharing each loaded K/V row (GQA). Blocks whose split
// starts past pos exit at once, so positions past pos are never read. A
// block issues all of its chunk's K and V loads before it waits on any, so
// their latencies overlap. It writes its unnormalised partial (m, l, acc) to
// scratch, and a second kernel on the same stream merges a slot's partials,
// one block per (slot, KV head, group) -- which spreads a slot's cache over
// many SMs instead of one block per (slot, KV head). Any S runs: the ragged
// last chunk is masked here (the Pallas wrapper needs S to be a multiple of
// its block).
#include "common.cuh"

namespace {

using repro::NEG_INF;

constexpr int NT = 256;        // threads per block; one head_dim lane each in the PV stage
constexpr int NW = NT / 32;
constexpr int CH = 32;         // positions per chunk: one per lane in the softmax stage
constexpr int MAX_HD = NT;  // stage 3 gives every head_dim lane its own thread
constexpr int KREG = MAX_HD / 32;
constexpr int PER_WARP = CH / NW;  // positions each warp scores per chunk

size_t smem_bytes(int G, int hd) {
  return sizeof(float) * (size_t(G) * hd       // q_s [G][hd], pre-scaled
                          + size_t(G) * hd     // acc [G][hd]
                          + size_t(G) * CH     // p_s [G][CH]
                          + 3 * size_t(G));    // m, l, alpha per group
}

// Partial attention of one split. part_acc: (B, KV, n_splits, G, hd) fp32;
// part_ml: (B, KV, n_splits, G, 2) fp32 holding (m, l).
template <typename T>
__global__ void __launch_bounds__(NT) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_cache, const T* __restrict__ v_cache,
    const int* __restrict__ pos_arr, float* __restrict__ part_acc, float* __restrict__ part_ml,
    int S, int H, int KV, int hd, int split_len, int n_splits, float scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int sp = blockIdx.z;
  const int last = min(pos_arr[b], S - 1);
  const int first = sp * split_len;
  if (first > last) return;  // block-uniform: no valid position in this split
  const int end = min(last, first + split_len - 1);

  extern __shared__ float smem[];
  const int G = H / KV;
  float* q_s = smem;
  float* acc = q_s + G * hd;
  float* p_s = acc + G * hd;
  float* m_s = p_s + G * CH;
  float* l_s = m_s + G;
  float* alpha_s = l_s + G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // row t of this (slot, KV head): k_cache[((b * S + t) * KV + kvh) * hd]
  const size_t row_stride = size_t(KV) * hd;
  const T* kb = k_cache + (size_t(b) * S * KV + kvh) * hd;
  const T* vb = v_cache + (size_t(b) * S * KV + kvh) * hd;
  const int d_own = tid;  // the head_dim lane this thread owns in stage 3 (hd <= NT)

  for (int c0 = first; c0 <= end; c0 += CH) {
    const int nj = min(CH, end - c0 + 1);
    // The chunk's K rows (stage 1: warp w scores positions w, w + NW, ...)
    // and V values (stage 3: thread d reads dimension d of every position)
    // are all loaded up front, before anything waits on them -- for the
    // first chunk even before q -- so their global-memory latencies overlap
    // instead of adding up.
    float kreg[PER_WARP][KREG];
#pragma unroll
    for (int r = 0; r < PER_WARP; ++r) {
      const int j = warp + NW * r;
      const T* krow = kb + size_t(c0 + (j < nj ? j : 0)) * row_stride;
#pragma unroll
      for (int c = 0; c < KREG; ++c) {
        const int d = lane + 32 * c;
        kreg[r][c] = (j < nj && d < hd) ? repro::to_float(krow[d]) : 0.f;
      }
    }
    float vv[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j)
      vv[j] = (j < nj && d_own < hd) ? repro::to_float(vb[size_t(c0 + j) * row_stride + d_own])
                                     : 0.f;

    if (c0 == first) {  // block-uniform
      // q: (B, H, hd); this block's heads are kvh * G .. kvh * G + G - 1
      const T* qb = q + (size_t(b) * H + size_t(kvh) * G) * hd;
      for (int e = tid; e < G * hd; e += NT) {
        q_s[e] = repro::to_float(qb[e]) * scale;
        acc[e] = 0.f;
      }
      for (int g = tid; g < G; g += NT) {
        m_s[g] = NEG_INF;
        l_s[g] = 0.f;
      }
      __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < PER_WARP; ++r) {
      const int j = warp + NW * r;
      if (j >= nj) continue;  // warp-uniform
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < KREG; ++c) {
          const int d = lane + 32 * c;
          if (d < hd) part += q_s[g * hd + d] * kreg[r][c];
        }
        part = repro::warp_sum(part);
        if (lane == 0) p_s[g * CH + j] = part;
      }
    }
    __syncthreads();

    // stage 2: online softmax, warp g owns group g
    for (int g = warp; g < G; g += NW) {
      const bool ok = lane < nj;
      const float s = ok ? p_s[g * CH + lane] : REPRO_ABSENT;
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, repro::warp_max(s));
      const float p = ok ? expf(s - m_new) : 0.f;
      const float alpha = expf(m_old - m_new);
      const float psum = repro::warp_sum(p);
      p_s[g * CH + lane] = p;
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = alpha * l_s[g] + psum;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // stage 3: acc = alpha * acc + P @ V, thread d owns dimension d of every
    // group; positions past nj carry p == 0 and v == 0
    if (d_own < hd) {
      for (int g = 0; g < G; ++g) {
        float a = acc[g * hd + d_own] * alpha_s[g];
#pragma unroll
        for (int j = 0; j < CH; ++j) a += p_s[g * CH + j] * vv[j];
        acc[g * hd + d_own] = a;
      }
    }
    __syncthreads();
  }

  const size_t part = (size_t(b) * KV + kvh) * n_splits + sp;
  float* pa = part_acc + part * G * hd;
  for (int e = tid; e < G * hd; e += NT) pa[e] = acc[e];
  float* pml = part_ml + part * 2 * G;
  for (int g = tid; g < G; g += NT) {
    pml[2 * g] = m_s[g];
    pml[2 * g + 1] = l_s[g];
  }
}

// Merge the partials of the splits that ran (those starting at or before
// pos): out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s. One block per
// (slot, KV head, group): the split weights are computed once into shared
// memory, then thread d sums dimension d over the splits, whose loads are
// independent of each other (unrolled, so several are in flight at once).
template <typename T>
__global__ void __launch_bounds__(NT) decode_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ pos_arr, T* __restrict__ out, int S, int H, int KV, int hd,
    int split_len, int n_splits) {
  extern __shared__ float w_s[];  // [n_splits]: e^(m_s - M)
  __shared__ float red[NW];
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int g = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int last = min(pos_arr[b], S - 1);
  const int used = last < 0 ? 0 : last / split_len + 1;
  const size_t base = (size_t(b) * KV + kvh) * n_splits;
  const float* pml = part_ml + base * 2 * G + 2 * g;  // (m, l) of split s at pml[2 G s]
  const float* pa = part_acc + base * G * hd + size_t(g) * hd;  // split s at pa[G hd s]

  float m = NEG_INF;
  for (int s = tid; s < used; s += NT) m = fmaxf(m, pml[2 * G * s]);
  m = repro::warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  float M = NEG_INF;
  for (int w = 0; w < NW; ++w) M = fmaxf(M, red[w]);
  __syncthreads();  // red is reused below

  float l = 0.f;
  for (int s = tid; s < used; s += NT) {
    const float w = expf(pml[2 * G * s] - M);
    w_s[s] = w;
    l += w * pml[2 * G * s + 1];
  }
  l = repro::warp_sum(l);
  if (lane == 0) red[warp] = l;
  __syncthreads();
  float L = 0.f;
  for (int w = 0; w < NW; ++w) L += red[w];

  T* ob = out + (size_t(b) * H + size_t(kvh) * G + g) * hd;
  for (int d = tid; d < hd; d += NT) {
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < used; ++s) a += w_s[s] * pa[size_t(G) * hd * s + d];
    ob[d] = repro::from_float<T>(a / fmaxf(L, 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_cache, const void* v_cache, const int* pos,
                   float* part_acc, float* part_ml, void* out, int B, int S, int H, int KV,
                   int hd, int split_len, int n_splits, float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes(H / KV, hd);
  auto kernel = decode_split_kernel<T>;
  if (bytes > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(B, KV, n_splits);
  kernel<<<grid, NT, bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k_cache),
                                      static_cast<const T*>(v_cache), pos, part_acc, part_ml, S,
                                      H, KV, hd, split_len, n_splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t w_bytes = sizeof(float) * size_t(n_splits);
  if (w_bytes > 48 * 1024) return cudaErrorInvalidValue;  // the wrapper keeps n_splits small
  decode_combine_kernel<T><<<dim3(B, KV, H / KV), NT, w_bytes, stream>>>(
      part_acc, part_ml, pos, static_cast<T*>(out), S, H, KV, hd, split_len, n_splits);
  return cudaGetLastError();
}

}  // namespace

// C entry point. q, out: (B, H, hd); k_cache, v_cache: (B, S, KV, hd); pos:
// (B,) int32, >= 0; part_acc: (B, KV, n_splits, H / KV, hd) fp32 and
// part_ml: (B, KV, n_splits, H / KV, 2) fp32 scratch, n_splits =
// ceil(S / split_len), split_len a multiple of 32. All contiguous, one float
// dtype for q/k/v/out (0 fp32, 1 bf16). Returns the cudaError_t of the launches.
extern "C" int decode_attention_fwd(const void* q, const void* k_cache, const void* v_cache,
                                    const void* pos, void* part_acc, void* part_ml, void* out,
                                    int B, int S, int H, int KV, int hd, int split_len,
                                    int n_splits, int dtype, float scale, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || hd < 1 || hd > MAX_HD || split_len < CH ||
      split_len % CH != 0 || n_splits != (S + split_len - 1) / split_len)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* pa = static_cast<float*>(part_acc);
  float* pml = static_cast<float*>(part_ml);
  if (dtype == repro::kFloat32)
    return int(launch<float>(q, k_cache, v_cache, p, pa, pml, out, B, S, H, KV, hd, split_len,
                             n_splits, scale, s));
  if (dtype == repro::kBFloat16)
    return int(launch<__nv_bfloat16>(q, k_cache, v_cache, p, pa, pml, out, B, S, H, KV, hd,
                                     split_len, n_splits, scale, s));
  return int(cudaErrorInvalidValue);
}
