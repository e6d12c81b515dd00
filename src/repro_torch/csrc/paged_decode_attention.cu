// Paged decode attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the reference's Pallas TPU kernel
// `repro/kernels/paged_decode_attention.py::paged_decode_attention`
// (`_kernel`): one query token per slot attends over a block pool of KV
// pages addressed through a per-slot page table. A logical position idx is
// valid when idx <= pos and, for window > 0, idx > pos - window. Online
// softmax in fp32, output in the input dtype.
//
// What bounds it on the H100: bytes. Each call reads the K and V rows of
// every valid position once (bf16 on the serving path) and does only
// 4 * groups * head_dim FLOP per position, far below the card's ridge point.
// Design against that: the Pallas scalar prefetch of the page table becomes
// the block reading its own table entries; one block per (slot, KV head)
// walks only the valid positions [max(0, pos - window + 1), pos] in chunks of
// 32 -- positions past pos (null-page padding included) are never read, so
// their bytes are never moved -- and all `groups` query heads share each
// loaded K/V row (GQA). With gemma3's single KV head and 8 slots that is
// only 8 blocks on 132 SMs: splitting each slot's positions over several
// blocks plus a combine pass (split-K) is the next step.
#include "common.cuh"

namespace {

using repro::NEG_INF;

constexpr int NT = 256;        // threads per block; one head_dim lane each in the PV stage
constexpr int NW = NT / 32;
constexpr int CH = 32;         // positions per chunk: one per lane in the softmax stage
constexpr int MAX_HD = 256;
constexpr int KREG = MAX_HD / 32;
constexpr int PER_WARP = CH / NW;  // positions each warp scores per chunk

size_t smem_bytes(int G, int hd) {
  return sizeof(long long) * CH                  // K/V row offsets of the chunk
         + sizeof(float) * (size_t(G) * hd       // q_s [G][hd], pre-scaled
                            + size_t(G) * hd     // acc [G][hd]
                            + size_t(G) * CH     // p_s [G][CH]
                            + 3 * size_t(G));    // m, l, alpha per group
}

template <typename T>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool, const T* __restrict__ v_pool,
    const int* __restrict__ table, const int* __restrict__ pos_arr, T* __restrict__ out,
    int H, int KV, int hd, int page, int n_pages, float scale, int window) {
  extern __shared__ long long smem_ll[];
  long long* row_off = smem_ll;  // [CH]
  float* q_s = reinterpret_cast<float*>(row_off + CH);
  const int G = H / KV;
  float* acc = q_s + G * hd;
  float* p_s = acc + G * hd;
  float* m_s = p_s + G * CH;
  float* l_s = m_s + G;
  float* alpha_s = l_s + G;

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

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

  // exactly the valid positions: the rest contribute exp(NEG_INF - m) == 0
  const int pos = pos_arr[b];
  const int last = min(pos, n_pages * page - 1);
  const int first = window > 0 ? max(0, pos - window + 1) : 0;
  const int* trow = table + size_t(b) * n_pages;

  for (int c0 = first; c0 <= last; c0 += CH) {
    const int nj = min(CH, last - c0 + 1);
    // stage 1: scores; warp w scores positions w, w + NW, ... of the chunk.
    // All of a warp's K rows are loaded before any is used, so their
    // global-memory latencies overlap instead of adding up.
    float kreg[PER_WARP][KREG];
#pragma unroll
    for (int r = 0; r < PER_WARP; ++r) {
      const int j = warp + NW * r;
      const T* krow = k_pool;
      if (j < nj) {
        const int t = c0 + j;
        const long long off =
            ((long long)trow[t / page] * page + t % page) * KV + kvh;  // row index into the pool
        if (lane == 0) row_off[j] = off * hd;
        krow = k_pool + off * hd;
      }
#pragma unroll
      for (int c = 0; c < KREG; ++c) {
        const int d = lane + 32 * c;
        kreg[r][c] = (j < nj && d < hd) ? repro::to_float(krow[d]) : 0.f;
      }
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
    // group; the chunk's V values are loaded first (overlapping latencies),
    // and positions past nj carry p == 0 and v == 0
    for (int d = tid; d < hd; d += NT) {
      float vv[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j) vv[j] = j < nj ? repro::to_float(v_pool[row_off[j] + d]) : 0.f;
      for (int g = 0; g < G; ++g) {
        float a = acc[g * hd + d] * alpha_s[g];
#pragma unroll
        for (int j = 0; j < CH; ++j) a += p_s[g * CH + j] * vv[j];
        acc[g * hd + d] = a;
      }
    }
    __syncthreads();
  }

  T* ob = out + (size_t(b) * H + size_t(kvh) * G) * hd;
  for (int e = tid; e < G * hd; e += NT) {
    ob[e] = repro::from_float<T>(acc[e] / fmaxf(l_s[e / hd], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const int* table,
                   const int* pos, void* out, int B, int H, int KV, int hd, int page,
                   int n_pages, float scale, int window, cudaStream_t stream) {
  const size_t bytes = smem_bytes(H / KV, hd);
  auto kernel = paged_decode_kernel<T>;
  if (bytes > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(B, KV);
  kernel<<<grid, NT, bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k_pool),
                                      static_cast<const T*>(v_pool), table, pos,
                                      static_cast<T*>(out), H, KV, hd, page, n_pages, scale,
                                      window);
  return cudaGetLastError();
}

}  // namespace

// C entry point. q, out: (B, H, hd); k_pool, v_pool: (P, page, KV, hd);
// table: (B, n_pages) int32; pos: (B,) int32, >= 0. All contiguous, one
// float dtype (0 fp32, 1 bf16). Returns the cudaError_t of the launch.
extern "C" int paged_decode_attention_fwd(const void* q, const void* k_pool,
                                          const void* v_pool, const void* table,
                                          const void* pos, void* out, int B, int H, int KV,
                                          int hd, int page, int n_pages, int dtype,
                                          float scale, int window, void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || hd < 1 || hd > MAX_HD || page < 1 || n_pages < 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(table);
  const int* p = static_cast<const int*>(pos);
  if (dtype == repro::kFloat32)
    return int(launch<float>(q, k_pool, v_pool, tbl, p, out, B, H, KV, hd, page, n_pages,
                             scale, window, s));
  if (dtype == repro::kBFloat16)
    return int(launch<__nv_bfloat16>(q, k_pool, v_pool, tbl, p, out, B, H, KV, hd, page,
                                     n_pages, scale, window, s));
  return int(cudaErrorInvalidValue);
}
