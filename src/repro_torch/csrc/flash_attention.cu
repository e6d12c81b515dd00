// Flash attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the reference's Pallas TPU kernel
// `repro/kernels/flash_attention.py::flash_attention` (`_kernel`): online-
// softmax attention with causal, static sliding-window, prefix-LM and static
// q_offset masking, and native GQA (query head h reads KV head h / groups,
// repeated K/V is never materialised). Inputs fp32 or bf16, softmax in fp32,
// output in the input dtype.
//
// What bounds it on the H100: at the serving path's prefill shapes (one
// prompt of 64-1024 tokens, 4 query heads over 1 KV head, head_dim 256,
// bf16) a call is at most ~2 GFLOP, 2.2 us at the tensor cores' 989 TFLOP/s;
// with one prompt only 16-64 blocks exist, so the chain of key tiles of the
// last query rows -- per tile two products, the softmax between them and a
// wait on the tile's load -- sets the time, not the card's peak. Three
// variants, chosen by an explicit rule in the wrapper
// (`kernels/flash_attention.py::variant`):
//
// * wgmma (bf16, head_dim 64 / 80 / 112 / 128 / 160 / 256, at most 64 query
//   heads per KV head): the tensor cores. A block owns one KV head and one or
//   two consumer warpgroups of 64 query rows; a row is a (position, query
//   head) pair, so the heads that share a KV head (gemma3's 4) sit in one
//   warpgroup's rows and every K/V tile is read once for all of them. A
//   warpgroup holds P = 64 / G whole positions, P * G rows: 64 when G
//   divides 64, 48 for granite-20b's 48 heads a group, 60 for grok-1's 6; its
//   rows past P * G are zeroed in shared memory once (TMA never writes them)
//   and never stored. One producer thread loads Q once and then keeps a
//   2-stage ring of K and V tiles of 64 keys in flight with TMA (128-byte
//   swizzle, 64-column boxes; keys past Skv read zeros and are masked by
//   index), guarded by "full" / "empty" mbarriers. Tiles span HDP =
//   ceil(head_dim / 64) * 64 columns (128 at hd 80 and 112, 192 at 160), TMA
//   reading zeros past head_dim (global rows of 160 / 224 / 320 bytes are
//   16-byte multiples, as TMA needs). Each consumer warpgroup computes S = Q
//   K^T with `wgmma` m64n64k16 over the head_dim / 16 k-steps of real
//   columns only (both operands K-major, from shared memory), masks (only
//   tiles that cross a mask edge) and runs the online softmax on the
//   accumulator fragment (row max and sum over the four lanes that share a
//   row), converts P to bf16 in registers and adds P V with `wgmma`
//   m64n{HDP}k16 (A from registers, V through the transpose bit: an N-major
//   operand with the 128-byte swizzle comes in whole 64-column atoms, so the
//   padded width, not head_dim), starting the next tile's S behind it so
//   that one wait covers both. The 64 x HDP fp32 output accumulator stays in
//   registers (96 a thread at hd 160); only head_dim columns are stored. One
//   consumer warpgroup a block when the grid then fits in one wave -- a
//   single prompt: the chain of key tiles of the last rows sets the time,
//   and a warpgroup with the tensor cores to itself walks it faster -- two
//   otherwise (`setmaxnreg` then gives them 240 registers each); the wrapper
//   picks (`kernels/flash_attention.py::consumer_warpgroups`). 145 KB of
//   shared memory at hd 160 with two consumer warpgroups. A causal grid
//   (no prefix, no window) of more blocks than the card has SMs starts its
//   longest key walks first, over every (batch, KV head): on an H100 that
//   took 7-25 % off the 1024-token prefills of 8 to 64 query heads, where
//   the grid spans two or more waves. Other grids keep (query block, KV
//   head, batch) order, whose neighbouring blocks share a KV head: the
//   global order cost 10-13 % there (one wave, or walks of equal length),
//   for a reason not measured.
// * tf32x3 (fp32, every supported head_dim and group size, 16-byte-aligned
//   operands): both products on the tensor cores by `mma.sync` m16n8k8 TF32,
//   each as three TF32 products of the operands' high and low parts (fp32
//   accumulation; `tf32x3.cuh`, shared with the backward): fp32's 2e-5
//   parity, which one TF32 product would break. At
//   `examples/train_100m_torch.py`'s shape (B=4, S=256, 8 query heads over
//   2, hd 80, causal) its bound is 2.04 us, three products at the TF32 peak
//   (its bytes: 1.96 us), where the fp32 FMA peak gives 5.03 us. A block owns
//   64 (position, query head) rows of one KV head (the G heads share each
//   K/V tile, any G) and eight warps: four row groups of 16 x two halves of
//   every key tile, merged at the end in a fixed order. K/V tiles arrive by
//   cp.async in a two-stage ring and are split into TF32 parts once, as
//   they land; see the kernel.
// * simt (bf16 at head_dim 16 / 32 or with more than 64 query heads per KV
//   head; any dtype with unaligned operands): one block per (32 query rows,
//   head, batch), K/V tiles of 32 keys staged in fp32 shared memory, scalar
//   FMA on the CUDA cores. Any head_dim that is a multiple of 8
//   instantiates; those of the repo's configs and examples do (16, 32, 64,
//   80, 112, 128, 160, 256), hd 160 asking for 65,920 bytes of shared
//   memory.
//
// Every variant also writes each query row's log-sum-exp (fp32, (B, H,
// Sq), natural log of the scaled scores) when the caller passes a buffer for
// it: the training path's forward, whose gradient comes from
// `flash_attention_bwd.cu`. Serving passes none, and nothing else changes.
//
// All three walk only the key tiles a block's rows can attend to (causal upper
// bound, window lower bound), which is exact whenever every row has at least
// one valid key (checked per block; blocks with a row that has none visit
// every tile, so such a row averages V over all keys, as the Pallas kernel
// and the reference oracle give with their finite -1e30 mask). Ragged Sq /
// Skv are masked here: the Pallas wrapper's block-multiple assertion does
// not apply.
#include "common.cuh"
#include "hopper.cuh"
#include "tf32x3.cuh"
#include "wgmma.cuh"

namespace {

using repro::NEG_INF;
using repro::sm90::aligned16;

// ---------------------------------------------------------------------------
// simt: fp32 (and the bf16 shapes the wgmma variant does not take)
// ---------------------------------------------------------------------------

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

// Key range [k_begin, k_end) the block's query positions [qp_lo, qp_hi]
// visit: keys outside it are left out entirely, which equals masking them
// when every row has a valid key (see the note at the top).
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
__global__ void __launch_bounds__(NT) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int Sq, int Skv, int H, int KV, float scale,
    int causal, int window, int prefix_len, int q_offset) {
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

  int k_begin, k_end;
  key_range(q_offset + q0, q_offset + q0 + nq - 1, Skv, causal, window, prefix_len, &k_begin,
            &k_end);

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
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int i = warp + NW * r;
      row_s[i] = l_r[r];
      // log-sum-exp of the row's scaled scores, (B, H, Sq), for the backward
      if (lse != nullptr && i < nq)
        lse[(size_t(b) * H + h) * Sq + q0 + i] = m_r[r] + logf(fmaxf(l_r[r], 1e-30f));
    }
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
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int Sq, int Skv, int H, int KV, float scale, int causal, int window,
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
                                      static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Skv,
                                      H, KV, scale, causal, window, prefix_len, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int Sq, int Skv, int H, int KV, float scale,
                        int causal, int window, int prefix_len, int q_offset,
                        cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, B, Sq, Skv, H, KV, scale, causal, window, prefix_len, q_offset, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, Sq, Skv, H, KV, scale, causal, window, prefix_len, q_offset, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, Sq, Skv, H, KV, scale, causal, window, prefix_len, q_offset, stream);
    case 80:  // train_100m's ~100M-parameter gemma3-family model
      return launch<T, 80>(q, k, v, o, lse, B, Sq, Skv, H, KV, scale, causal, window, prefix_len, q_offset, stream);
    case 112:  // zamba2-7b, kimi-k2
      return launch<T, 112>(q, k, v, o, lse, B, Sq, Skv, H, KV, scale, causal, window, prefix_len, q_offset, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, Sq, Skv, H, KV, scale, causal, window, prefix_len, q_offset, stream);
    case 160:  // stablelm-12b
      return launch<T, 160>(q, k, v, o, lse, B, Sq, Skv, H, KV, scale, causal, window, prefix_len, q_offset, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, lse, B, Sq, Skv, H, KV, scale, causal, window, prefix_len, q_offset, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// wgmma: bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace fa {
constexpr int ROWS = 64;                   // (position, head) rows of one consumer warpgroup
constexpr int BKV = 64;                    // keys per K / V tile
constexpr int STAGES = 2;
constexpr int CHUNK = 64 * 128;            // one 64-column box of a 64-row tile: 8 KB
template <int HD, int NC>
constexpr size_t smem_bytes() {  // Q tiles, K / V ring, barriers, alignment slack
  return size_t(NC + 2 * STAGES) * (repro::sm90::tile_columns(HD) / 64) * CHUNK +
         (1 + 2 * STAGES) * sizeof(uint64_t) + 1024;
}
}  // namespace fa

// NC consumer warpgroups (1 or 2) and one producer warpgroup a block.
// LONGEST_FIRST: the grid's order (see the launch).
template <int HD, int NC, bool LONGEST_FIRST>
__global__ void __launch_bounds__(128 * (NC + 1), 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int Sq, int Skv, int H, int G, float scale_log2, int causal,
    int window, int prefix_len, int q_offset) {
  using namespace repro::sm90;
  constexpr int HDP = tile_columns(HD);  // columns of a tile; TMA reads zeros past HD
  constexpr int CH = HDP / 64;
  constexpr int TILE = CH * fa::CHUNK;  // one 64-row tile: Q of a warpgroup, or K, or V
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint8_t* q_tiles = smem;                 // [NC][TILE]
  uint8_t* kv_tiles = smem + NC * TILE;    // [STAGES][K tile, V tile]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv_tiles + 2 * fa::STAGES * TILE);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + fa::STAGES;

  const int P = fa::ROWS / G;  // positions per warpgroup
  const int PG = P * G;        // rows of its Q tile that TMA fills; the rest are zero
  // LONGEST_FIRST (a causal grid of more than one wave): a 1-D grid, query
  // blocks outermost and from the last, so the longest key walks of every
  // (batch, KV head) start first and the short ones fill the last wave's
  // tail; otherwise (x: query block, y: KV head, z: batch), which keeps the
  // blocks of one KV head neighbours in launch order
  int qb, kvh, b;
  if constexpr (LONGEST_FIRST) {
    const int n_qb = (Sq + NC * P - 1) / (NC * P), n_z = int(gridDim.x) / n_qb;
    const int z = int(blockIdx.x) % n_z;
    qb = n_qb - 1 - int(blockIdx.x) / n_z;
    kvh = z % (H / G);
    b = z / (H / G);
  } else {
    qb = blockIdx.x;
    kvh = blockIdx.y;
    b = blockIdx.z;
  }
  const int q0 = qb * NC * P;
  const int nq = min(NC * P, Sq - q0);
  int k_begin, k_end;
  key_range(q_offset + q0, q_offset + q0 + nq - 1, Skv, causal, window, prefix_len, &k_begin,
            &k_end);
  const int n_tiles = (k_end - k_begin + fa::BKV - 1) / fa::BKV;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < fa::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  if (PG < fa::ROWS) {  // a group that does not divide 64: zero rows PG..63 once
    zero_box_tails(q_tiles, NC * CH, fa::CHUNK, PG);
    fence_proxy_async();
  }
  __syncthreads();

  if (wg == NC) {
    // producer: Q once, then the ring of K / V tiles. With two consumer
    // warpgroups the 384 threads start at 168 registers, and `setmaxnreg`
    // moves the producer's to the consumers; with one, all start at 255.
    if constexpr (NC > 1) setmaxnreg_dec<24>();
    if (threadIdx.x == NC * 128) {
      mbar_arrive_expect_tx(q_full, NC * CH * PG * 128);
      for (int c = 0; c < NC; ++c)
        for (int ch = 0; ch < CH; ++ch)
          tma_load_5d(q_tiles + c * TILE + ch * fa::CHUNK, &q_map, q_full, ch * 64, 0, kvh,
                      q0 + c * P, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % fa::STAGES;
        mbar_wait(&empty[s], ((i / fa::STAGES) & 1) ^ 1);
        uint8_t* kt_s = kv_tiles + 2 * s * TILE;
        mbar_arrive_expect_tx(&full[s], 2 * TILE);
        const int kt = k_begin + i * fa::BKV;
        for (int ch = 0; ch < CH; ++ch) {
          tma_load_4d(kt_s + ch * fa::CHUNK, &k_map, &full[s], ch * 64, kvh, kt, b);
          tma_load_4d(kt_s + TILE + ch * fa::CHUNK, &v_map, &full[s], ch * 64, kvh, kt, b);
        }
      }
    }
  } else {
    if constexpr (NC > 1) setmaxnreg_inc<240>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int t = lane % 4;
    // this thread's two rows of the warpgroup's 64: warp * 16 + lane / 4 (+ 8)
    int qp[2], pos[2], head[2];
    bool pad[2];  // a row past the P * G the Q box fills
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + lane / 4 + 8 * h;
      pos[h] = q0 + wg * P + r / G;
      qp[h] = q_offset + pos[h];
      head[h] = kvh * G + r % G;
      pad[h] = r >= PG;
    }
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float oacc[HDP / 2];  // columns past HD stay 0 (V's are) and are not stored
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) oacc[i] = 0.f;
    float sacc[32];  // S of one tile, then P in fp32
#pragma unroll
    for (int j = 0; j < 32; ++j) sacc[j] = 0.f;
    uint32_t pa[4][4];  // P as the bf16 A fragment of m64k16, keys 16 kk .. 16 kk + 15
    const uint8_t* q_tile = q_tiles + wg * TILE;
    // the block's real query positions: a tile every row may see whole needs no mask
    const int qp_lo = q_offset + q0, qp_hi = q_offset + q0 + nq - 1;

    // S = Q K^T of tile i: 64 rows x 64 keys, 16 head dims a step over the HD
    // real ones, K-major both
    auto launch_scores = [&](int i) {
      const uint8_t* k_tile = kv_tiles + 2 * (i % fa::STAGES) * TILE;
      mbar_wait(&full[i % fa::STAGES], (i / fa::STAGES) & 1);
      fence_regs(sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int off = (kk / 4) * fa::CHUNK + (kk % 4) * 32;
        wgmma_ss<64, 0, 0>(sacc, smem_desc(q_tile + off, 16, 1024),
                           smem_desc(k_tile + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };

    mbar_wait(q_full, 0);
    if (n_tiles > 0) {
      launch_scores(0);
      wgmma_wait<0>();
      fence_regs(sacc);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % fa::STAGES;
      const int kt = k_begin + i * fa::BKV;
      const bool whole = kt + fa::BKV <= k_end && (!causal || kt + fa::BKV - 1 <= qp_lo) &&
                         (window <= 0 || qp_hi - kt < window);

      // online softmax on the fragment: sacc[4j + e] is row h = e / 2, key
      // kt + 8j + 2t + (e & 1); scores go to log2 units (scale_log2)
      float mx[2] = {m[0], m[1]};
      if (whole) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          sacc[j] *= scale_log2;
          mx[(j % 4) / 2] = fmaxf(mx[(j % 4) / 2], sacc[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e / 2;
            const int key = kt + 8 * j + 2 * t + (e & 1);
            bool allowed = true;
            if (causal) {
              allowed = key <= qp[h];
              if (prefix_len > 0) allowed = allowed || (qp[h] < prefix_len && key < prefix_len);
            }
            if (window > 0) allowed = allowed && (qp[h] - key < window);
            const float sv =
                key < k_end ? (allowed ? sacc[4 * j + e] * scale_log2 : NEG_INF) : REPRO_ABSENT;
            sacc[4 * j + e] = sv;
            mx[h] = fmaxf(mx[h], sv);
          }
        }
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = exp2f(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float p = exp2f(sacc[j] - m[(j % 4) / 2]);
        sacc[j] = p;
        l[(j % 4) / 2] += p;
      }
      // P V of the previous tile is complete: rescale O unless no row of the
      // warp moved its max
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int j = 0; j < HDP / 8; ++j) {
          oacc[4 * j + 0] *= alpha[0];
          oacc[4 * j + 1] *= alpha[0];
          oacc[4 * j + 2] *= alpha[1];
          oacc[4 * j + 3] *= alpha[1];
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16x2(sacc[8 * kk + 0], sacc[8 * kk + 1]);
        pa[kk][1] = pack_bf16x2(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pa[kk][2] = pack_bf16x2(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pa[kk][3] = pack_bf16x2(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }

      // O += P V: V is N-major (head dims contiguous), 16 keys = 2048 bytes a
      // step, over the padded HDP columns: an N-major operand with the
      // 128-byte swizzle comes in whole 64-column atoms. The next tile's
      // scores start behind it, so the tensor cores run both while this
      // warpgroup waits once.
      const uint8_t* v_tile = kv_tiles + (2 * s + 1) * TILE;
      fence_regs(oacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<HDP, 1>(oacc, pa[kk], smem_desc(v_tile + kk * 2048, fa::CHUNK, 1024), 1);
      wgmma_commit();
      if (i + 1 < n_tiles) launch_scores(i + 1);
      wgmma_wait<0>();
      fence_regs(oacc);
      fence_regs(sacc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // the P V product read these until the wait
#pragma unroll
        for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(pa[kk][r])::"memory");
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // epilogue: row sums over the four lanes of a row, one bf16 store a pair
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      if (pad[h] || pos[h] >= Sq) continue;
      // log-sum-exp in natural units (m is in log2 units of the scaled
      // scores), at (b, head, pos) of the (B, H, Sq) output
      if (lse != nullptr && t == 0)
        lse[(size_t(b) * H + head[h]) * Sq + pos[h]] =
            (m[h] + log2f(fmaxf(l[h], 1e-30f))) * 0.6931471805599453f;
      const float denom = fmaxf(l[h], 1e-30f);
      __nv_bfloat16* orow = o + (size_t(b) * Sq + pos[h]) * size_t(H) * HD +
                            size_t(head[h]) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
            pack_bf16x2(oacc[4 * j + 2 * h] / denom, oacc[4 * j + 2 * h + 1] / denom);
    }
  }
}

template <int HD, int NC>
cudaError_t launch_wgmma_nc(const CUtensorMap& q_map, const CUtensorMap& k_map,
                            const CUtensorMap& v_map, void* o, float* lse, int B, int Sq,
                            int Skv, int H,
                            int KV, float scale, int causal, int window, int prefix_len,
                            int q_offset, cudaStream_t stream) {
  constexpr size_t bytes = fa::smem_bytes<HD, NC>();
  static const cudaError_t attr = [] {  // once a process: the port drives one card
    cudaError_t e = cudaFuncSetAttribute(flash_attention_wgmma_kernel<HD, NC, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(flash_attention_wgmma_kernel<HD, NC, false>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  }();
  if (attr != cudaSuccess) return attr;
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const int P = fa::ROWS / (H / KV);
  const int n_qb = (Sq + NC * P - 1) / (NC * P);
  // walks that differ by query block (causal, no prefix, no window) over more
  // blocks than the card runs at once: the longest first (see the kernel)
  const bool longest_first =
      causal && prefix_len == 0 && window <= 0 && n_qb > 1 && n_qb * KV * B > sms;
  const float scale_log2 = scale * 1.4426950408889634f;  // softmax in exp2
  if (longest_first)
    flash_attention_wgmma_kernel<HD, NC, true><<<n_qb * KV * B, 128 * (NC + 1), bytes, stream>>>(
        q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), lse, Sq, Skv, H, H / KV,
        scale_log2, causal, window, prefix_len, q_offset);
  else
    flash_attention_wgmma_kernel<HD, NC, false><<<dim3(n_qb, KV, B), 128 * (NC + 1), bytes,
                                                  stream>>>(
        q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), lse, Sq, Skv, H, H / KV,
        scale_log2, causal, window, prefix_len, q_offset);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                         int B, int Sq, int Skv, int H, int KV, float scale, int causal,
                         int window,
                         int prefix_len, int q_offset, int consumers, cudaStream_t stream) {
  const int G = H / KV;
  const int P = fa::ROWS / G;
  CUtensorMap q_map, k_map, v_map;
  const uint64_t e = 2;  // bytes of a bf16
  // q: (B, Sq, KV, G, HD) read in boxes of (1, P, 1, G, 64): P * G rows of 128
  // bytes; a box's columns past HD read zeros
  const uint64_t q_sizes[5] = {uint64_t(HD), uint64_t(G), uint64_t(KV), uint64_t(Sq), uint64_t(B)};
  const uint64_t q_strides[5] = {e, e * HD, e * HD * G, e * HD * H, e * HD * H * Sq};
  const uint32_t q_box[5] = {64, uint32_t(G), 1, uint32_t(P), 1};
  // k, v: (B, Skv, KV, HD) in boxes of (1, 64 keys, 1, 64)
  const uint64_t kv_sizes[4] = {uint64_t(HD), uint64_t(KV), uint64_t(Skv), uint64_t(B)};
  const uint64_t kv_strides[4] = {e, e * HD, e * HD * KV, e * HD * KV * Skv};
  const uint32_t kv_box[4] = {64, 1, fa::BKV, 1};
  if (!repro::sm90::encode_bf16_map(&q_map, q, 5, q_sizes, q_strides, q_box) ||
      !repro::sm90::encode_bf16_map(&k_map, k, 4, kv_sizes, kv_strides, kv_box) ||
      !repro::sm90::encode_bf16_map(&v_map, v, 4, kv_sizes, kv_strides, kv_box))
    return cudaErrorInvalidValue;
  return consumers == 1
             ? launch_wgmma_nc<HD, 1>(q_map, k_map, v_map, o, lse, B, Sq, Skv, H, KV, scale,
                                      causal, window, prefix_len, q_offset, stream)
             : launch_wgmma_nc<HD, 2>(q_map, k_map, v_map, o, lse, B, Sq, Skv, H, KV, scale,
                                      causal, window, prefix_len, q_offset, stream);
}

// ---------------------------------------------------------------------------
// tf32x3: fp32 on the tensor cores, three TF32 products a product
// ---------------------------------------------------------------------------

namespace ft {
constexpr int ROWS = 64;  // (position, query head) rows of a block: 16 a row group of two warps
constexpr int NT = 256;   // eight warps: four row groups x two halves of every key tile
// Keys a K / V tile holds: 64 up to hd 112, then fewer, so that the block's
// tiles (Q; a two-stage ring of K and V; their low parts) fit the shared
// memory: 203 KB at hd 112, 164 KB at 160, 163 KB at 256.
template <int HD>
__host__ __device__ constexpr int keys() { return HD <= 112 ? 64 : HD <= 160 ? 32 : 16; }
template <int HD>
constexpr size_t smem_bytes() {  // Q; K, V x 2 stages (raw, then hi in place); K lo, V lo
  return sizeof(float) * size_t(ROWS + 6 * keys<HD>()) * (HD + 4);
}
}  // namespace ft

// A block per (64 rows, b * KV + kvh); a row is a (position, query head)
// pair of the KV head's G heads, flattened position-major, so the heads
// that share a KV head share each K / V tile whatever G is (48, 72: a row
// block may hold part of a position's heads). Eight warps: warp w holds rows
// 16 (w % 4) .. + 15 and takes half w / 4 of every key tile, with its own
// running max, sum and output; the halves merge in a fixed order at the end
// (no atomics). K / V tiles arrive by 16-byte cp.async in a two-stage ring
// (the next tile's loads fly while this one is multiplied), are split into
// TF32 hi (in place) and lo once, and both products read them from there:
// S = Q K^T by `prod_rows` (Q's fragments split as they are read), the
// online softmax on the accumulator fragment in fp32 (log2 units), O += P V
// by `prod_acc` with P's accumulator as its A fragment. `longest_first` (a
// causal grid of more than one wave): row blocks from the last, so the
// longest walks of every (batch, KV head) start first; otherwise row blocks
// innermost, so neighbouring blocks share a KV head.
template <int HD>
__global__ void __launch_bounds__(ft::NT, 1) flash_attention_tf32x3_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, int Sq, int Skv, int H, int KV,
    float scale_log2, int causal, int window, int prefix_len, int q_offset, int longest_first) {
  namespace tx = repro::tf32x3;
  using repro::sm90::cp_async16;
  constexpr int R = ft::ROWS, BK = ft::keys<HD>(), LD = HD + 4, NJ = BK / 16, N8 = HD / 8;
  constexpr int V4 = HD / 4;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // [R][LD]
  float* ring = Qs + R * LD;      // [2][K, V][BK][LD]
  float* Kl = ring + 4 * BK * LD;  // [BK][LD]
  float* Vl = Kl + BK * LD;        // [BK][LD]

  const int G = H / KV, rows = Sq * G;
  const int n_rb = (rows + R - 1) / R, nz = int(gridDim.x) / n_rb;
  const int rb = longest_first ? n_rb - 1 - int(blockIdx.x) / nz : int(blockIdx.x) % n_rb;
  const int z = longest_first ? int(blockIdx.x) % nz : int(blockIdx.x) / n_rb;
  const int b = z / KV, kvh = z % KV;
  const int x0 = rb * R, nrow = min(R, rows - x0);
  const int qp_lo = q_offset + x0 / G, qp_hi = q_offset + (x0 + nrow - 1) / G;
  int k_begin, k_end;
  key_range(qp_lo, qp_hi, Skv, causal, window, prefix_len, &k_begin, &k_end);
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;
  const size_t q_row = size_t(H) * HD, kv_row = size_t(KV) * HD;
  const float* qb = q + size_t(b) * Sq * q_row + size_t(kvh) * G * HD;
  const float* kbase = k + size_t(b) * Skv * kv_row + size_t(kvh) * HD;
  const float* vbase = v + size_t(b) * Skv * kv_row + size_t(kvh) * HD;

  // Q rows x -> (position (x0 + x) / G, head (x0 + x) % G), zeros past nrow
  for (int e = threadIdx.x; e < R * V4; e += ft::NT) {
    const int x = e / V4, d = (e - x * V4) * 4, xr = min(x0 + x, rows - 1);
    cp_async16(Qs + x * LD + d, qb + size_t(xr / G) * q_row + size_t(xr % G) * HD + d,
               x < nrow ? 16 : 0);
  }
  // keys kt .. kt + BK - 1 into ring stage s, zeros past k_end
  auto load_tile = [&](int kt, int s) {
    float* Ks = ring + 2 * s * BK * LD;
    for (int e = threadIdx.x; e < BK * V4; e += ft::NT) {
      const int j = e / V4, d = (e - j * V4) * 4, key = min(kt + j, k_end - 1);
      const int n = kt + j < k_end ? 16 : 0;
      cp_async16(Ks + j * LD + d, kbase + size_t(key) * kv_row + d, n);
      cp_async16(Ks + (BK + j) * LD + d, vbase + size_t(key) * kv_row + d, n);
    }
    repro::sm90::cp_async_commit();
  };
  if (n_tiles > 0) load_tile(k_begin, 0);
  else repro::sm90::cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int rg = 16 * (warp & 3), kh = (warp >> 2) * (BK / 2);  // rows, first key of the half
  int qp[2];  // the query positions of this thread's rows rg + g (+ 8)
#pragma unroll
  for (int h = 0; h < 2; ++h) qp[h] = q_offset + (x0 + rg + g + 8 * h) / G;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[N8][4];
#pragma unroll
  for (int n = 0; n < N8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i & 1, kt = k_begin + i * BK;
    repro::sm90::cp_async_wait<0>();
    __syncthreads();  // tile i landed for every thread; tile i - 1's products are done
    if (i + 1 < n_tiles) load_tile(kt + BK, s ^ 1);
    float* Kh = ring + 2 * s * BK * LD;
    float* Vh = Kh + BK * LD;
    for (int e = threadIdx.x; e < 2 * BK * V4; e += ft::NT) {  // K then V: hi in place, lo apart
      const int r = e / V4, d = (e - r * V4) * 4;
      float4* src = reinterpret_cast<float4*>(Kh + r * LD + d);
      const float4 xv = *src;
      uint32_t hi[4], lo[4];
      tx::split(xv.x, hi[0], lo[0]);
      tx::split(xv.y, hi[1], lo[1]);
      tx::split(xv.z, hi[2], lo[2]);
      tx::split(xv.w, hi[3], lo[3]);
      *reinterpret_cast<uint4*>(src) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(Kl + r * LD + d) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    __syncthreads();

    // S = Q K^T: rows rg + g (+ 8), keys kt + kh + 8 jj + 2c (+ 1)
    float sc[NJ][4];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) sc[jj][0] = sc[jj][1] = sc[jj][2] = sc[jj][3] = 0.f;
    tx::prod_rows<HD, NJ>(sc, Qs + rg * LD, Kh + kh * LD, Kl + kh * LD, lane);

    // online softmax on the fragment, in log2 units of the scaled scores
    const bool whole = kt + BK <= k_end && (!causal || kt + BK - 1 <= qp_lo) &&
                       (window <= 0 || qp_hi - kt < window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, key = kt + kh + 8 * jj + 2 * c + (e & 1);
        float sv = sc[jj][e] * scale_log2;
        if (!whole) {
          bool allowed = true;
          if (causal) {
            allowed = key <= qp[h];
            if (prefix_len > 0) allowed = allowed || (qp[h] < prefix_len && key < prefix_len);
          }
          if (window > 0) allowed = allowed && (qp[h] - key < window);
          sv = key < k_end ? (allowed ? sv : NEG_INF) : REPRO_ABSENT;
        }
        sc[jj][e] = sv;
        mx[h] = fmaxf(mx[h], sv);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[jj][e] - m[e >> 1]);
        sc[jj][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    tx::prod_acc<HD, NJ>(acc, sc, Vh + kh * LD, Vl + kh * LD, lane);  // O += P V
  }

  // merge the two halves of every key tile: half 1 hands its output, max and
  // sum over in shared memory (the ring's room), half 0 adds them and stores
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  repro::sm90::cp_async_wait<0>();
  __syncthreads();
  float* red = ring;              // [R][LD]: R <= 4 * BK rows of the ring
  float* red_m = ring + R * LD;   // [R], then [R] sums
  if (warp >= 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = red + (rg + g + 8 * h) * LD + 2 * c;
#pragma unroll
      for (int n = 0; n < N8; ++n)
        *reinterpret_cast<float2*>(row + 8 * n) = make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
      if (c == 0) {
        red_m[rg + g + 8 * h] = m[h];
        red_m[R + rg + g + 8 * h] = l[h];
      }
    }
  }
  __syncthreads();
  if (warp < 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = rg + g + 8 * h;
      if (x >= nrow) continue;
      const float m2 = red_m[x], mm = fmaxf(m[h], m2);
      const float a1 = exp2f(m[h] - mm), a2 = exp2f(m2 - mm);
      const float sum = l[h] * a1 + red_m[R + x] * a2;
      const int pos = (x0 + x) / G, head = kvh * G + (x0 + x) % G;
      // log-sum-exp in natural units, at (b, head, pos) of the (B, H, Sq) output
      if (lse != nullptr && c == 0)
        lse[(size_t(b) * H + head) * Sq + pos] =
            (mm + log2f(fmaxf(sum, 1e-30f))) * 0.6931471805599453f;
      const float inv = 1.f / fmaxf(sum, 1e-30f);
      const float* other = red + x * LD + 2 * c;
      float* orow = o + (size_t(b) * Sq + pos) * q_row + size_t(head) * HD + 2 * c;
#pragma unroll
      for (int n = 0; n < N8; ++n) {
        const float2 p2 = *reinterpret_cast<const float2*>(other + 8 * n);
        *reinterpret_cast<float2*>(orow + 8 * n) =
            make_float2((acc[n][2 * h] * a1 + p2.x * a2) * inv,
                        (acc[n][2 * h + 1] * a1 + p2.y * a2) * inv);
      }
    }
  }
}

template <int HD>
cudaError_t launch_tf32x3(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                          int Sq, int Skv, int H, int KV, float scale, int causal, int window,
                          int prefix_len, int q_offset, cudaStream_t stream) {
  static_assert(ft::ROWS <= 4 * ft::keys<HD>(), "the halves' merge fits the ring's room");
  constexpr size_t bytes = ft::smem_bytes<HD>();
  static const cudaError_t attr = cudaFuncSetAttribute(  // once a process: one card
      flash_attention_tf32x3_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (attr != cudaSuccess) return attr;
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const long long n_rb = (static_cast<long long>(Sq) * (H / KV) + ft::ROWS - 1) / ft::ROWS;
  const long long blocks = n_rb * KV * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // walks that differ by row block (causal, no prefix, no window) over more
  // blocks than the card runs at once: the longest first (see the kernel)
  const int longest_first =
      causal && prefix_len == 0 && window <= 0 && n_rb > 1 && blocks > sms;
  flash_attention_tf32x3_kernel<HD><<<unsigned(blocks), ft::NT, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, Sq, Skv, H, KV, scale * 1.4426950408889634f, causal, window,
      prefix_len, q_offset, longest_first);
  return cudaGetLastError();
}

}  // namespace

// C entry point. q, o: (B, Sq, H, hd); k, v: (B, Skv, KV, hd); contiguous,
// one dtype (0 fp32, 1 bf16); variant 0 simt, 1 wgmma (bf16; hd 64 / 80 /
// 112 / 128 / 160 / 256; H / KV at most 64; q, k, v, o 16-byte aligned) with
// `consumers` (1 or 2) consumer warpgroups a block, which the wrapper picks
// by the grid's size; 2 tf32x3 (fp32; every supported hd and H / KV; q, k,
// v, o 16-byte aligned).
// `lse`: null, or fp32 (B, H, Sq) that receives each query row's
// log-sum-exp of its scaled, masked scores (the backward's input).
// Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int B, int Sq, int Skv, int H, int KV, int hd,
                                   int dtype,
                                   float scale, int causal, int window, int prefix_len,
                                   int q_offset, int variant, int consumers, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KV < 1 || H % KV != 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    const int G = H / KV;
    if (dtype != repro::kBFloat16 || G > fa::ROWS || !aligned16(q) || !aligned16(k) ||
        !aligned16(v) || !aligned16(o) || (consumers != 1 && consumers != 2))
      return int(cudaErrorInvalidValue);
    decltype(&launch_wgmma<64>) fn = nullptr;
    switch (hd) {
      case 64: fn = launch_wgmma<64>; break;
      case 80: fn = launch_wgmma<80>; break;
      case 112: fn = launch_wgmma<112>; break;
      case 128: fn = launch_wgmma<128>; break;
      case 160: fn = launch_wgmma<160>; break;
      case 256: fn = launch_wgmma<256>; break;
      default: return int(cudaErrorInvalidValue);
    }
    return int(fn(q, k, v, o, lse, B, Sq, Skv, H, KV, scale, causal, window, prefix_len,
                  q_offset, consumers, s));
  }
  if (variant == 2) {
    if (dtype != repro::kFloat32 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
        !aligned16(o))
      return int(cudaErrorInvalidValue);
#define REPRO_FWD_TF32X3(N)                                                                    \
  case N:                                                                                      \
    return int(launch_tf32x3<N>(q, k, v, o, lse, B, Sq, Skv, H, KV, scale, causal, window,     \
                                prefix_len, q_offset, s));
    switch (hd) {
      REPRO_FWD_TF32X3(16)
      REPRO_FWD_TF32X3(32)
      REPRO_FWD_TF32X3(64)
      REPRO_FWD_TF32X3(80)
      REPRO_FWD_TF32X3(112)
      REPRO_FWD_TF32X3(128)
      REPRO_FWD_TF32X3(160)
      REPRO_FWD_TF32X3(256)
      default:
        return int(cudaErrorInvalidValue);
    }
#undef REPRO_FWD_TF32X3
  }
  if (variant != 0) return int(cudaErrorInvalidValue);
  if (dtype == repro::kFloat32)
    return int(dispatch_hd<float>(hd, q, k, v, o, lse, B, Sq, Skv, H, KV, scale, causal,
                                  window, prefix_len, q_offset, s));
  if (dtype == repro::kBFloat16)
    return int(dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, lse, B, Sq, Skv, H, KV, scale,
                                          causal, window, prefix_len, q_offset, s));
  return int(cudaErrorInvalidValue);
}

// Message of a cudaError_t returned by an entry point of this library.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
