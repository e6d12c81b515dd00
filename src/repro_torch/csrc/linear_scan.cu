// Chunkwise gated linear recurrence for Hopper (sm_90a), hand-written CUDA C++.
//
//   S_t = a_t * S_{t-1} + k_t^T v_t ;  y_t = q_t @ S_t ;  a_t = exp(log_a_t)
//
// Replaces the reference's Pallas TPU kernel
// `repro/kernels/linear_scan.py::gated_linear_scan` (`_kernel`): the mLSTM
// matrix memory of xlstm and the Mamba2 SSD core. q, k: (B, H, S, dk); v:
// (B, H, S, dv), fp32 or bf16, given by their strides (the models pass
// head-split views of their projections); log_a: (B, H, S) fp32. Returns y
// (B, H, S, dv) in q's dtype and the final state (B, H, dk, dv) in fp32, from
// an optional fp32 initial state (zeros when absent).
//
// The mLSTM's normaliser in the same launch. The reference calls the scan a
// second time with v = ones for it (`repro/models/ssm.py:97`). Here it is one
// more column of the value matrix, [v | 1]: extended column dv holds ones, its
// state column is the normaliser state n (B, H, dk) and its output column is
// nrm (B, H, S). Every kernel below works on these dv + 1 extended columns
// when `nrm` is given; the normaliser's column is the first of the tile past
// the last of v's.
//
// Per chunk, as the Pallas kernel: A = cumsum(log_a) (in fp64: A reaches -60
// and below within a chunk at xlstm's decays, where fp32 would leave ~1e-5 of
// rounding in every gate); intra-chunk scores (q_i . k_j) exp(A_i - A_j) for
// j <= i (the exponent is formed only there, where it is <= 0: for j > i it
// could overflow); the inter-chunk read exp(A_i) q_i S_prev; the state update
// exp(a_tot) S_prev + k^T (v * exp(a_tot - A)). Any S runs: a ragged last
// chunk is masked.
//
// Three kernels, picked by an explicit rule in the wrapper
// (`kernels/linear_scan.py::variant`):
//
// * `scan_mma_kernel` (bf16, dk <= 384, 16-byte rows, S > 16): the products
//   on the tensor cores. What bounds the scan on the H100 is operations,
//   4 S dk dv per (b, h) for the two state products: a block owns a tile of
//   16 CT extended state columns (the grid is (tiles, H, B); the wrapper
//   picks CT from the card's SM count) and keeps its dk x 16 CT slab of the
//   state in registers, transposed (S^T), as mma.sync m16n8k16 accumulator
//   fragments: warp (ct, dp) holds rows 16 ct .. of S^T and a 1 / DP share of
//   dk. Chunks of L = 32 positions; per chunk: the 32 x 32 scores Q K^T
//   (six warps a tile each, gated, P kept in bf16 hi + lo halves; the
//   other two warps scale v), y^T = S_prev^T Q^T (the fp32 state split into
//   bf16 hi + lo A fragments in registers) + V^T P^T, and S^T = e S^T +
//   Vsc^T K with Vsc = v * exp(a_tot - A) in bf16 hi + lo. q and k are exact
//   in bf16, so every product is exact to ~2^-17 of its fp32 form: no
//   operand is rounded to 8 bits that the plain version keeps in fp32. The
//   next chunk's q, k, v and log_a are copied by cp.async into a second
//   stage while the current one computes. Products into one accumulator are
//   issued several apart, and the paths' dk (384, 64) have their own
//   instantiations, whose loops over dk carry no run-time bound. The scores
//   are recomputed by each dv tile (under a tenth of a block's products at
//   dk = 384).
// * `scan_step_kernel` (S <= 16, a decode tick; any dtype): bound by bytes,
//   the state read once and written once. A block owns 32 extended columns;
//   a thread a 4-column group of every 32nd state row, read with 16-byte
//   loads, and walks the S positions over it in fp32; y is summed over the
//   rows through shuffles and shared memory.
// * `scan_simt_kernel` (fp32, and what the others do not take): exact fp32
//   FMA on CUDA cores, as ported first. Each block owns 32 extended columns
//   and a dk x 32 slab of the state in shared memory and walks chunks of 64
//   positions, recomputing the chunk's scores per tile.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"
#include "scan_core.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int kMaxDk = 1024;

// Element strides of a (B, H, S, d) view; d is 0 for log_a's (B, H, S).
struct Strides {
  long long b, h, s, d;
};

struct Args {
  const void* q;  // (B, H, S, dk)
  const void* k;
  const void* v;         // (B, H, S, dv)
  const float* la;       // (B, H, S)
  const float* init;     // (B, H, dk, dv) or null: zeros
  const float* init_n;   // (B, H, dk) or null: zeros (normaliser)
  void* y;               // (B, H, S, dv), contiguous, q's dtype
  float* st_out;         // (B, H, dk, dv), contiguous
  void* nrm;             // (B, H, S) in q's dtype, or null: no normaliser
  float* n_out;          // (B, H, dk)
  int H, S, dk, dv;
  Strides qs, ks, vs, las;
};

__device__ __forceinline__ bool has_norm(const Args& a) { return a.nrm != nullptr; }

// Initial value of extended state column c at row d (c == dv: the normaliser).
__device__ __forceinline__ float init_at(const Args& a, size_t bh, int d, int c) {
  if (d >= a.dk) return 0.f;
  if (c < a.dv) return a.init != nullptr ? a.init[(bh * a.dk + d) * a.dv + c] : 0.f;
  if (c == a.dv && has_norm(a)) return a.init_n != nullptr ? a.init_n[bh * a.dk + d] : 0.f;
  return 0.f;
}

__device__ __forceinline__ void store_state(const Args& a, size_t bh, int d, int c, float x) {
  if (d >= a.dk) return;
  if (c < a.dv)
    a.st_out[(bh * a.dk + d) * a.dv + c] = x;
  else if (c == a.dv && has_norm(a))
    a.n_out[bh * a.dk + d] = x;
}

template <typename T>
__device__ __forceinline__ void store_y(const Args& a, size_t bh, int s, int c, float x) {
  if (c < a.dv)
    static_cast<T*>(a.y)[(bh * a.S + s) * a.dv + c] = repro::from_float<T>(x);
  else if (c == a.dv && has_norm(a))
    static_cast<T*>(a.nrm)[bh * a.S + s] = repro::from_float<T>(x);
}

// Extended column c of v at position s of this (b, h)'s rows vb.
template <typename T>
__device__ __forceinline__ float v_at(const Args& a, const T* vb, int s, int c) {
  if (c < a.dv) return repro::to_float(vb[s * a.vs.s + c * a.vs.d]);
  return (c == a.dv && has_norm(a)) ? 1.f : 0.f;
}

using repro::scan::cp_async16;
using repro::scan::cp_async4;
using repro::scan::cp_async_commit;
using repro::scan::cp_async_wait;

// ---------------------------------------------------------------------------
// scan_mma_kernel: bf16 products on the tensor cores
// ---------------------------------------------------------------------------

namespace mmas {

using bf16 = __nv_bfloat16;
using repro::sm80::ldsm_x4;
using repro::sm80::ldsm_x4_t;
using repro::sm80::mma_bf16;
using repro::sm80::pack_bf16x2;

constexpr int L = 32;  // positions per chunk
constexpr int NT = 256, NW = NT / 32;
constexpr int MAX_DK = 384;
constexpr int KSM = MAX_DK / 16;  // k16 steps of dk at most
constexpr int NTILE = 6;  // m16 x n8 score tiles on or below the diagonal: a warp each
constexpr int PST = L + 8;        // bf16 row stride of P (80 bytes: ldmatrix conflict-free)

template <int CT>
struct Geo {
  static constexpr int DVT = 16 * CT;    // extended state columns a block owns
  static constexpr int DP = NW / CT;     // warps sharing a 16-column tile, each a share of dk
  static constexpr int KW = KSM / DP;    // k16 steps of dk a warp holds at most
  static constexpr int VST = DVT + 8;    // bf16 row stride of v-like tiles (odd 16-byte count)
};

__host__ __device__ inline size_t take(size_t& o, size_t bytes) {
  const size_t r = o;
  o += (bytes + 15) / 16 * 16;
  return r;
}

// Byte offsets of the shared-memory regions for dk padded to dkp (a multiple
// of 16). q and k rows are padded by 16 bytes so that the eight rows an
// ldmatrix reads fall in eight different 16-byte bank groups.
template <int CT>
struct Smem {
  int qst;             // bf16 row stride of the q and k tiles
  size_t q, k, v, la;  // stage 0: [L][qst], [L][qst], [L][VST] bf16, [L] fp32
  size_t stage;        // bytes from stage 0 to stage 1
  size_t vh, vl;       // v * exp(a_tot - A), bf16 hi and lo halves [L][VST]
  size_t ph, pl;       // gated scores, bf16 hi and lo halves [L][PST]
  size_t yp;           // y^T partials of the warps dp > 0 [DP - 1][CT][4][32][4] fp32
  size_t ys;           // y staged for the store [L][VST] bf16
  size_t total;
  __host__ __device__ explicit Smem(int dkp) {
    using G = Geo<CT>;
    qst = dkp + 8;
    size_t o = 0;
    q = take(o, 2 * size_t(L) * qst);
    k = take(o, 2 * size_t(L) * qst);
    v = take(o, 2 * size_t(L) * G::VST);
    la = take(o, 4 * size_t(L));
    stage = o;
    o *= 2;
    vh = take(o, 2 * size_t(L) * G::VST);
    vl = take(o, 2 * size_t(L) * G::VST);
    ph = take(o, 2 * size_t(L) * PST);
    pl = take(o, 2 * size_t(L) * PST);
    yp = take(o, 4 * size_t(G::DP - 1) * CT * 4 * 32 * 4);
    ys = take(o, 2 * size_t(L) * G::VST);
    total = o;
  }
};

using repro::scan::split2;

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  mma_bf16(d, a[0], a[1], a[2], a[3], b0, b1);
}

// Per chunk, four block barriers: the chunk's copies have landed (the next
// chunk's are issued into the other stage first); P and Vsc are written; the
// y^T partials are written; y is staged for the store.
// KSD > 0: dk has exactly KSD k16 steps (384 and 64, the paths' dk), known
// at compile time, so the per-step bounds below fold away and every product
// loop is straight-line code the compiler can schedule across; KSD = 0: any
// dk <= MAX_DK, each step guarded at run time.
template <int CT, int KSD>
__global__ void __launch_bounds__(NT, 1) scan_mma_kernel(const Args a) {
  using G = Geo<CT>;
  constexpr int DVT = G::DVT, DP = G::DP, VST = G::VST;
  constexpr int KW = KSD > 0 ? (KSD + DP - 1) / DP : G::KW;  // k16 steps a warp holds at most
  constexpr bool EXACT = KSD > 0 && KSD % DP == 0;           // every warp holds KW steps
  extern __shared__ __align__(16) unsigned char sm[];
  const int j0 = blockIdx.x * DVT, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = size_t(b) * a.H + h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = 2 * (lane & 3);  // fragment row, column pair
  const int mr = lane & 7, mj = lane >> 3;       // ldmatrix: row this lane addresses, matrix
  // dk padded to whole k16 steps: a constant when KSD > 0, and with it every
  // shared-memory offset and row stride below
  const int dkp = KSD > 0 ? 16 * KSD : (a.dk + 15) / 16 * 16, KSd = dkp / 16;
  const Smem<CT> lay(dkp);
  const int qst = lay.qst;
  const bool norm = has_norm(a);
  const int dve = a.dv + (norm ? 1 : 0);

  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.vs.b + h * a.vs.h;
  const float* lg = a.la + b * a.las.b + h * a.las.h;
  float* Yp = reinterpret_cast<float*>(sm + lay.yp);
  bf16* Ys = reinterpret_cast<bf16*>(sm + lay.ys);

  // this warp's part: state columns cw .. cw + 15 (rows of S^T) and the k16
  // steps kbase .. kbase + kw - 1 of dk
  const int ct = warp % CT, dp = warp / CT;
  const int kw = KSD > 0 ? KW : (KSd + DP - 1) / DP, kbase = dp * kw;
  // whether this warp holds k16 step kbase + ks (a constant when EXACT)
  auto holds = [&](int ks) { return EXACT || (ks < kw && kbase + ks < KSd); };
  const int cw = j0 + 16 * ct;
  const bool active = cw < dve;  // warp-uniform: the tile has a column here

  // S^T as accumulator fragments: s[n] rows c = cw + g (+ 8), columns
  // d = 16 kbase + 8 n + c2 (+ 1)
  float s[2 * KW][4];
#pragma unroll
  for (int n = 0; n < 2 * KW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[n][e] = active && holds(n / 2)
                    ? init_at(a, bh, 16 * kbase + 8 * n + c2 + (e & 1), cw + g + 8 * (e >> 1))
                    : 0.f;

  // chunk c0's q, k, v, log_a into stage st: cp.async for what exists, plain
  // stores of zeros (and of the normaliser's ones) for the rest
  auto issue = [&](int c0, int st) {
    const int nv = min(L, a.S - c0);
    unsigned char* base = sm + st * lay.stage;
    bf16* qs = reinterpret_cast<bf16*>(base + lay.q);
    bf16* ks = reinterpret_cast<bf16*>(base + lay.k);
    bf16* vs = reinterpret_cast<bf16*>(base + lay.v);
    float* ls = reinterpret_cast<float*>(base + lay.la);
    const int nch = dkp / 8;
    for (int idx = tid; idx < L * nch; idx += NT) {
      const int i = idx / nch, ch = idx - i * nch;
      bf16* dq = qs + i * qst + 8 * ch;
      bf16* dk = ks + i * qst + 8 * ch;
      if (i < nv && 8 * ch < a.dk) {
        cp_async16(dq, qg + (c0 + i) * a.qs.s + 8 * ch);
        cp_async16(dk, kg + (c0 + i) * a.ks.s + 8 * ch);
      } else {
        *reinterpret_cast<uint4*>(dq) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dk) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    for (int idx = tid; idx < L * DVT / 8; idx += NT) {
      const int i = idx / (DVT / 8), cc = idx % (DVT / 8);
      const int c = j0 + 8 * cc;
      bf16* dv = vs + i * VST + 8 * cc;
      if (i < nv && c < a.dv) {
        cp_async16(dv, vg + (c0 + i) * a.vs.s + c);
      } else {
        // bf16 1.0 in the normaliser's column (the first of its 8)
        const unsigned one = i < nv && c == a.dv && norm ? 0x3f80u : 0u;
        *reinterpret_cast<uint4*>(dv) = make_uint4(one, 0u, 0u, 0u);
      }
    }
    if (tid < L) {
      if (tid < nv)
        cp_async4(ls + tid, lg + (c0 + tid) * a.las.s);
      else
        ls[tid] = 0.f;  // masked rows decay by exp(0) = 1 and add nothing
    }
  };

  bf16* Vh = reinterpret_cast<bf16*>(sm + lay.vh);
  bf16* Vl = reinterpret_cast<bf16*>(sm + lay.vl);
  bf16* Ph = reinterpret_cast<bf16*>(sm + lay.ph);
  bf16* Pl = reinterpret_cast<bf16*>(sm + lay.pl);
  const int nchunks = (a.S + L - 1) / L;
  issue(0, 0);
  cp_async_commit();
  for (int t = 0; t < nchunks; ++t) {
    const int st = t & 1, c0 = t * L, nv = min(L, a.S - c0);
    if (t + 1 < nchunks) issue(c0 + L, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this chunk's copies (the next chunk's stay in flight)
    __syncthreads();
    const unsigned char* base = sm + st * lay.stage;
    const bf16* Q = reinterpret_cast<const bf16*>(base + lay.q);
    const bf16* K = reinterpret_cast<const bf16*>(base + lay.k);
    const bf16* V = reinterpret_cast<const bf16*>(base + lay.v);
    const float* La = reinterpret_cast<const float*>(base + lay.la);

    // decay, in every warp: lane i holds A_i (fp64 inclusive scan), exp(A_i)
    // and exp(a_tot - A_i)
    double A = La[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double n = __shfl_up_sync(FULL, A, off);
      if (lane >= off) A += n;
    }
    const double a_tot = __shfl_sync(FULL, A, L - 1);
    const float eA = expf(float(A)), gl = expf(float(a_tot - A)), e_tot = expf(float(a_tot));

    if (warp < NTILE) {
      // scores Q K^T of one m16 x n8 tile on or below the diagonal, (m16
      // tile, n8 tile) = (0,0) (0,1) (1,0) (1,1) (1,2) (1,3) for warps 0..5,
      // even and odd k16 steps in two accumulators; then the gate
      // exp(A_i - A_j) for j <= i, else 0, and P into shared memory as bf16
      // hi and lo halves
      const int mi = warp < 2 ? 0 : 1, nj = warp < 2 ? warp : warp - 2;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      auto score_step = [&](int ks, float(&d)[4]) {
        uint32_t qa[4], kb[2];
        ldsm_x4(qa, Q + (16 * mi + mr + 8 * (mj & 1)) * qst + 16 * ks + 8 * (mj >> 1));
        repro::sm80::ldsm_x2(kb, K + (8 * nj + mr) * qst + 16 * ks + 8 * (mj & 1));
        mma(d, qa, kb[0], kb[1]);
      };
#pragma unroll 4
      for (int ks = 0; ks + 1 < KSd; ks += 2) {
        score_step(ks, acc[0]);
        score_step(ks + 1, acc[1]);
      }
      if (KSd & 1) score_step(KSd - 1, acc[0]);
      const int i = 16 * mi + g, j = 8 * nj + c2;
      const double Ai = __shfl_sync(FULL, A, i), Ai8 = __shfl_sync(FULL, A, i + 8);
      const double Aj = __shfl_sync(FULL, A, j), Aj1 = __shfl_sync(FULL, A, j + 1);
      auto gate = [](float sc, double ai, double aj, bool on) {
        return on ? sc * expf(float(ai - aj)) : 0.f;
      };
      uint32_t hi, lo;
      split2(gate(acc[0][0] + acc[1][0], Ai, Aj, j <= i),
             gate(acc[0][1] + acc[1][1], Ai, Aj1, j + 1 <= i), hi, lo);
      *reinterpret_cast<uint32_t*>(Ph + i * PST + j) = hi;
      *reinterpret_cast<uint32_t*>(Pl + i * PST + j) = lo;
      split2(gate(acc[0][2] + acc[1][2], Ai8, Aj, j <= i + 8),
             gate(acc[0][3] + acc[1][3], Ai8, Aj1, j + 1 <= i + 8), hi, lo);
      *reinterpret_cast<uint32_t*>(Ph + (i + 8) * PST + j) = hi;
      *reinterpret_cast<uint32_t*>(Pl + (i + 8) * PST + j) = lo;
    } else {
      // warps 6 and 7: Vsc = v * exp(a_tot - A_j), as bf16 hi and lo halves
      constexpr int VCH = L * DVT / 8, NTV = (NW - NTILE) * 32;
#pragma unroll
      for (int r = 0; r < (VCH + NTV - 1) / NTV; ++r) {
        const int idx = (warp - NTILE) * 32 + lane + r * NTV;
        const int i = idx / (DVT / 8), cc = idx % (DVT / 8);
        const float gi = __shfl_sync(FULL, gl, i & 31);
        if (idx < VCH) {
          const uint4 raw = *reinterpret_cast<const uint4*>(V + i * VST + 8 * cc);
          const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int p = 0; p < 4; ++p)
            split2(__uint_as_float(w[p] << 16) * gi, __uint_as_float(w[p] & 0xffff0000u) * gi,
                   hi[p], lo[p]);
          *reinterpret_cast<uint4*>(Vh + i * VST + 8 * cc) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<uint4*>(Vl + i * VST + 8 * cc) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
      }
    }
    __syncthreads();
    // y^T (columns c of this warp x the chunk's 32 positions): the inter-chunk
    // part S_prev^T Q^T over this warp's share of dk (yi), and in the dp = 0
    // warps the intra-chunk part V^T P^T (yo). Products into one accumulator
    // are issued four apart (hi halves of the four position tiles, then the
    // lo halves), so the tensor cores' latency is not waited out per product.
    float yi[4][4], yo[4][4];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) yi[ni][e] = yo[ni][e] = 0.f;
    if (active) {
#pragma unroll
      for (int ks = 0; ks < KW; ++ks) {
        if (holds(ks)) {
          const int kk = kbase + ks;
          uint32_t bq[2][4];
#pragma unroll
          for (int p = 0; p < 2; ++p)
            ldsm_x4(bq[p], Q + (16 * p + mr + 8 * (mj >> 1)) * qst + 16 * kk + 8 * (mj & 1));
          uint32_t ah[4], al[4];
          split2(s[2 * ks][0], s[2 * ks][1], ah[0], al[0]);
          split2(s[2 * ks][2], s[2 * ks][3], ah[1], al[1]);
          split2(s[2 * ks + 1][0], s[2 * ks + 1][1], ah[2], al[2]);
          split2(s[2 * ks + 1][2], s[2 * ks + 1][3], ah[3], al[3]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma(yi[ni], ah, bq[ni >> 1][2 * (ni & 1)], bq[ni >> 1][2 * (ni & 1) + 1]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma(yi[ni], al, bq[ni >> 1][2 * (ni & 1)], bq[ni >> 1][2 * (ni & 1) + 1]);
        }
      }
      if (dp == 0) {
#pragma unroll
        for (int kj = 0; kj < 2; ++kj) {
          if (16 * kj < nv) {
            uint32_t av[4];
            ldsm_x4_t(av, V + (16 * kj + mr + 8 * (mj >> 1)) * VST + 16 * ct + 8 * (mj & 1));
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              if (kj == 0 || p == 1) {  // positions j <= i only
                uint32_t bh_[4], bl_[4];
                const int off = (16 * p + mr + 8 * (mj >> 1)) * PST + 16 * kj + 8 * (mj & 1);
                ldsm_x4(bh_, Ph + off);
                ldsm_x4(bl_, Pl + off);
#pragma unroll
                for (int q = 0; q < 2; ++q) mma(yo[2 * p + q], av, bh_[2 * q], bh_[2 * q + 1]);
#pragma unroll
                for (int q = 0; q < 2; ++q) mma(yo[2 * p + q], av, bl_[2 * q], bl_[2 * q + 1]);
              }
            }
          }
        }
      } else {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          reinterpret_cast<float4*>(Yp)[(((dp - 1) * CT + ct) * 4 + ni) * 32 + lane] =
              make_float4(yi[ni][0], yi[ni][1], yi[ni][2], yi[ni][3]);
      }

      // state update S^T = exp(a_tot) S^T + Vsc^T K over this warp's dk
      // share, four d-tile pairs (eight accumulators) a group: their hi
      // products, then their lo products
#pragma unroll
      for (int n = 0; n < 2 * KW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= e_tot;
#pragma unroll
      for (int kj = 0; kj < 2; ++kj) {
        if (16 * kj < nv) {
          uint32_t ah[4], al[4];
          const int off = (16 * kj + mr + 8 * (mj >> 1)) * VST + 16 * ct + 8 * (mj & 1);
          ldsm_x4_t(ah, Vh + off);
          ldsm_x4_t(al, Vl + off);
#pragma unroll
          for (int np0 = 0; np0 < KW; np0 += 4) {
            uint32_t bk[4][4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int np = np0 + e;
              if (np < KW && holds(np))
                ldsm_x4_t(bk[e], K + (16 * kj + mr + 8 * (mj & 1)) * qst + 16 * (kbase + np) +
                                     8 * (mj >> 1));
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int np = np0 + e;
              if (np < KW && holds(np)) {
                mma(s[2 * np], ah, bk[e][0], bk[e][1]);
                mma(s[2 * np + 1], ah, bk[e][2], bk[e][3]);
              }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int np = np0 + e;
              if (np < KW && holds(np)) {
                mma(s[2 * np], al, bk[e][0], bk[e][1]);
                mma(s[2 * np + 1], al, bk[e][2], bk[e][3]);
              }
            }
          }
        }
      }
    }

    __syncthreads();

    // y = exp(A_i) (sum of the dk shares) + intra, staged as bf16 [i][c]
    if (active && dp == 0) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        float4 add = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int r = 1; r < DP; ++r) {
          const float4 x =
              reinterpret_cast<const float4*>(Yp)[(((r - 1) * CT + ct) * 4 + ni) * 32 + lane];
          add.x += x.x;
          add.y += x.y;
          add.z += x.z;
          add.w += x.w;
        }
        const int i0 = 8 * ni + c2;
        const float e0 = __shfl_sync(FULL, eA, i0), e1 = __shfl_sync(FULL, eA, i0 + 1);
        bf16* o = Ys + i0 * VST + 16 * ct + g;
        o[0] = __float2bfloat16(fmaf(yi[ni][0] + add.x, e0, yo[ni][0]));
        o[VST] = __float2bfloat16(fmaf(yi[ni][1] + add.y, e1, yo[ni][1]));
        o[8] = __float2bfloat16(fmaf(yi[ni][2] + add.z, e0, yo[ni][2]));
        o[VST + 8] = __float2bfloat16(fmaf(yi[ni][3] + add.w, e1, yo[ni][3]));
      }
    }
    __syncthreads();

    // store the chunk's rows: 16 bytes of y a thread, the normaliser apart
    for (int idx = tid; idx < L * DVT / 8; idx += NT) {
      const int i = idx / (DVT / 8), cc = idx % (DVT / 8);
      const int c = j0 + 8 * cc;
      if (i < nv) {
        if (c < a.dv)
          *reinterpret_cast<uint4*>(static_cast<bf16*>(a.y) + (bh * a.S + c0 + i) * a.dv + c) =
              *reinterpret_cast<const uint4*>(Ys + i * VST + 8 * cc);
        else if (c == a.dv && norm)
          static_cast<bf16*>(a.nrm)[bh * a.S + c0 + i] = Ys[i * VST + 8 * cc];
      }
    }
  }
  cp_async_wait<0>();

  if (active) {
#pragma unroll
    for (int n = 0; n < 2 * KW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (holds(n / 2))
          store_state(a, bh, 16 * kbase + 8 * n + c2 + (e & 1), cw + g + 8 * (e >> 1), s[n][e]);
  }
}

template <int CT, int KSD>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  auto kernel = scan_mma_kernel<CT, KSD>;
  // once per instantiation: room for the largest dk it takes
  static const cudaError_t setup = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(Smem<CT>(MAX_DK).total));
  if (setup != cudaSuccess) return setup;
  const size_t bytes = Smem<CT>((a.dk + 15) / 16 * 16).total;
  const int dve = a.dv + (a.nrm != nullptr ? 1 : 0);
  const dim3 grid((dve + Geo<CT>::DVT - 1) / Geo<CT>::DVT, a.H, B);
  kernel<<<grid, NT, bytes, stream>>>(a);
  return cudaGetLastError();
}

// The instantiation for `tile` state columns a block and dk.
template <int CT>
cudaError_t launch_dk(const Args& a, int B, cudaStream_t stream) {
  const int ksd = (a.dk + 15) / 16;
  if (ksd == 24) return launch<CT, 24>(a, B, stream);
  if (ksd == 4) return launch<CT, 4>(a, B, stream);
  return launch<CT, 0>(a, B, stream);
}

inline cudaError_t launch_tile(const Args& a, int B, int tile, cudaStream_t stream) {
  if (tile == 16) return launch_dk<1>(a, B, stream);
  if (tile == 32) return launch_dk<2>(a, B, stream);
  if (tile == 64) return launch_dk<4>(a, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace mmas

// ---------------------------------------------------------------------------
// scan_step_kernel: S <= 16 positions (a decode tick), bound by the state's bytes
// ---------------------------------------------------------------------------

namespace step {

constexpr int NT = 256, NW = NT / 32;
constexpr int TW = 32;     // extended columns a block owns: 8 groups of 4
constexpr int MAX_S = 16;  // positions a launch takes

template <typename T>
__global__ void __launch_bounds__(NT) scan_step_kernel(const Args a) {
  __shared__ float vsm[MAX_S][TW];     // this tile's v (the normaliser's ones included)
  __shared__ float at[MAX_S];          // a_t = exp(log_a_t)
  __shared__ float red[NW][MAX_S][TW];  // y summed over each warp's rows
  const int j0 = blockIdx.x * TW, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = size_t(b) * a.H + h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = tid & 7, rg = tid >> 3;  // column group of 4, row group: rows rg, rg + 32, ...
  const T* qb = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h;
  const float* lb = a.la + b * a.las.b + h * a.las.h;
  for (int idx = tid; idx < MAX_S * TW; idx += NT) {
    const int t = idx / TW, c = idx % TW;
    vsm[t][c] = t < a.S ? v_at<T>(a, vb, t, j0 + c) : 0.f;
  }
  if (tid < MAX_S) at[tid] = tid < a.S ? expf(lb[tid * a.las.s]) : 1.f;
  __syncthreads();

  const int c0 = j0 + 4 * cg;  // this thread's first column
  // whole 16-byte rows of the state: 4 columns of v's, rows 16-byte aligned
  const bool vec = a.dv % 4 == 0 && c0 + 3 < a.dv &&
                   (a.init == nullptr || reinterpret_cast<uintptr_t>(a.init) % 16 == 0) &&
                   reinterpret_cast<uintptr_t>(a.st_out) % 16 == 0;
  float py[MAX_S][4];
#pragma unroll
  for (int t = 0; t < MAX_S; ++t) py[t][0] = py[t][1] = py[t][2] = py[t][3] = 0.f;
  for (int d = rg; d < a.dk; d += NT / 8) {
    float s4[4];
    if (vec) {
      const float4 x = a.init != nullptr
                           ? *reinterpret_cast<const float4*>(a.init + (bh * a.dk + d) * a.dv + c0)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      s4[0] = x.x;
      s4[1] = x.y;
      s4[2] = x.z;
      s4[3] = x.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) s4[e] = init_at(a, bh, d, c0 + e);
    }
#pragma unroll
    for (int t = 0; t < MAX_S; ++t) {
      if (t < a.S) {
        const float qd = repro::to_float(qb[t * a.qs.s + d * a.qs.d]);
        const float kd = repro::to_float(kb[t * a.ks.s + d * a.ks.d]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s4[e] = fmaf(at[t], s4[e], kd * vsm[t][4 * cg + e]);
          py[t][e] = fmaf(qd, s4[e], py[t][e]);
        }
      }
    }
    if (vec) {
      *reinterpret_cast<float4*>(a.st_out + (bh * a.dk + d) * a.dv + c0) =
          make_float4(s4[0], s4[1], s4[2], s4[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) store_state(a, bh, d, c0 + e, s4[e]);
    }
  }
  // sum y over the rows: the warp's four row groups (lanes 8 and 16 apart),
  // then the warps
#pragma unroll
  for (int t = 0; t < MAX_S; ++t) {
    if (t < a.S) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = py[t][e];
        x += __shfl_xor_sync(FULL, x, 8);
        x += __shfl_xor_sync(FULL, x, 16);
        if (lane < 8) red[warp][t][4 * cg + e] = x;
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < a.S * TW; idx += NT) {
    const int t = idx / TW, c = idx % TW;
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) x += red[w][t][c];
    store_y<T>(a, bh, t, j0 + c, x);
  }
}

template <typename T>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const int dve = a.dv + (a.nrm != nullptr ? 1 : 0);
  const dim3 grid((dve + TW - 1) / TW, a.H, B);
  scan_step_kernel<T><<<grid, NT, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace step

// ---------------------------------------------------------------------------
// scan_simt_kernel: exact fp32 FMA on CUDA cores
// ---------------------------------------------------------------------------

namespace simt {

constexpr int kL = 64;               // positions per chunk
constexpr int kDVT = 32;             // extended state columns a block owns: one per lane
constexpr int kDKT = 32;             // state rows per sub-tile of the dk loop
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQKStride = kDKT + 1;  // padded rows: conflict-free column reads

size_t smem_bytes(int dkp) {
  return sizeof(float) * (size_t(dkp) * kDVT             // st   [dkp][kDVT] state slab
                          + 2 * size_t(kL) * kQKStride  // qsm, ksm [kL][kQKStride]
                          + 2 * size_t(kL) * kDVT       // vsm, vsc [kL][kDVT]
                          + size_t(kL) * kL)            // scm  [kL][kL] gated scores
         + sizeof(double) * kL                          // Am   [kL] (8-byte aligned: the
                                                        //       float counts above are even)
         + sizeof(float) * kL;                          // eAm  [kL]
}

template <typename T>
struct Ctx {
  size_t bh;
  const T* q;  // this (b, h)'s rows
  const T* k;
  const T* v;
  const float* la;
  int dkp, j0;
  float* st;
  float* qsm;
  float* ksm;
  float* vsm;
  float* vsc;
  float* scm;
  double* Am;
  float* eAm;
};

// One chunk of nv <= kL valid positions starting at c0. NG = ceil(nv / 16)
// row groups hold valid rows: a full chunk has 4; rows past nv are zero in
// shared memory and never stored.
template <typename T, int NG>
__device__ __forceinline__ void chunk_step(const Args& a, const Ctx<T>& c, int c0, int nv) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ti = tid >> 4, tj = tid & 15;  // scores: rows ti + 16 r, cols tj + 16 u
  const int col = c.j0 + lane;

  // v chunk, and the chunk's cumulative log decay A in fp64 (one warp: two
  // positions a lane, an inclusive scan of the pair sums); every exponent
  // below is formed in fp64 and only then rounded to fp32 and exponentiated
  for (int idx = tid; idx < kL * kDVT; idx += kThreads) {
    const int i = idx / kDVT, cc = idx % kDVT;
    c.vsm[idx] = i < nv ? v_at<T>(a, c.v, c0 + i, c.j0 + cc) : 0.f;
  }
  if (warp == 0) {
    const int i0 = 2 * lane;
    const double x0 = i0 < nv ? c.la[(c0 + i0) * a.las.s] : 0.0;
    const double x1 = i0 + 1 < nv ? c.la[(c0 + i0 + 1) * a.las.s] : 0.0;
    double incl = x0 + x1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double n = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += n;
    }
    double excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = 0.0;
    c.Am[i0] = excl + x0;
    c.Am[i0 + 1] = (excl + x0) + x1;
  }
  __syncthreads();
  const double a_tot = c.Am[kL - 1];  // masked rows add log a = 0
  const float e_tot = expf(float(a_tot));
  if (tid < kL) c.eAm[tid] = expf(float(c.Am[tid]));
  for (int idx = tid; idx < kL * kDVT; idx += kThreads)
    c.vsc[idx] = c.vsm[idx] * expf(float(a_tot - c.Am[idx / kDVT]));

  float sacc[NG][NG];
#pragma unroll
  for (int r = 0; r < NG; ++r)
#pragma unroll
    for (int u = 0; u < NG; ++u) sacc[r][u] = 0.f;
  float yacc[2 * NG];  // rows warp + 8 r, column `col`
#pragma unroll
  for (int r = 0; r < 2 * NG; ++r) yacc[r] = 0.f;

  for (int d0 = 0; d0 < c.dkp; d0 += kDKT) {
    for (int idx = tid; idx < 16 * NG * kDKT; idx += kThreads) {
      const int i = idx / kDKT, d = idx % kDKT;
      float xq = 0.f, xk = 0.f;
      if (i < nv && d0 + d < a.dk) {
        xq = repro::to_float(c.q[(c0 + i) * a.qs.s + (d0 + d) * a.qs.d]);
        xk = repro::to_float(c.k[(c0 + i) * a.ks.s + (d0 + d) * a.ks.d]);
      }
      c.qsm[i * kQKStride + d] = xq;
      c.ksm[i * kQKStride + d] = xk;
    }
    __syncthreads();  // also publishes eAm and vsc on the first sub-tile
    // intra-chunk scores q_i . k_j over this sub-tile
#pragma unroll 4
    for (int d = 0; d < kDKT; ++d) {
      float qa[NG], kb[NG];
#pragma unroll
      for (int r = 0; r < NG; ++r) qa[r] = c.qsm[(ti + 16 * r) * kQKStride + d];
#pragma unroll
      for (int u = 0; u < NG; ++u) kb[u] = c.ksm[(tj + 16 * u) * kQKStride + d];
#pragma unroll
      for (int r = 0; r < NG; ++r)
#pragma unroll
        for (int u = 0; u < NG; ++u) sacc[r][u] = fmaf(qa[r], kb[u], sacc[r][u]);
    }
    // inter-chunk read q_i . S_prev[:, col] (scaled by exp(A_i) below)
#pragma unroll 4
    for (int d = 0; d < kDKT; ++d) {
      const float s = c.st[(d0 + d) * kDVT + lane];
#pragma unroll
      for (int r = 0; r < 2 * NG; ++r)
        yacc[r] = fmaf(c.qsm[(warp + kWarps * r) * kQKStride + d], s, yacc[r]);
    }
    __syncthreads();  // every read of these state rows is done
    // state update of rows d0 .. d0 + kDKT: S = exp(a_tot) S + k^T (v exp(a_tot - A))
#pragma unroll
    for (int m = 0; m < kDKT / kWarps; ++m) {
      const int d = warp + kWarps * m;
      float acc = 0.f;
      for (int j = 0; j < nv; ++j)
        acc = fmaf(c.ksm[j * kQKStride + d], c.vsc[j * kDVT + lane], acc);
      float* p = &c.st[(d0 + d) * kDVT + lane];
      *p = fmaf(e_tot, *p, acc);
    }
    __syncthreads();  // before the next sub-tile overwrites q and k
  }

  // gated scores: exp(A_i - A_j) formed only where j <= i
#pragma unroll
  for (int r = 0; r < NG; ++r)
#pragma unroll
    for (int u = 0; u < NG; ++u) {
      const int i = ti + 16 * r, j = tj + 16 * u;
      c.scm[i * kL + j] = j <= i ? sacc[r][u] * expf(float(c.Am[i] - c.Am[j])) : 0.f;
    }
  __syncthreads();
  // y_i = exp(A_i) q_i S_prev + sum_{j <= i} scores_ij v_j
#pragma unroll
  for (int r = 0; r < 2 * NG; ++r) {
    const int i = warp + kWarps * r;  // warp-uniform: the j loop does not diverge
    float acc = yacc[r] * c.eAm[i];
    for (int j = 0; j <= i; ++j) acc = fmaf(c.scm[i * kL + j], c.vsm[j * kDVT + lane], acc);
    if (i < nv) store_y<T>(a, c.bh, c0 + i, col, acc);
  }
  __syncthreads();  // before the next chunk overwrites v, A and the scores
}

template <typename T>
__global__ void __launch_bounds__(kThreads) scan_simt_kernel(const Args a, int dkp) {
  extern __shared__ float smem[];
  const int j0 = blockIdx.x * kDVT, h = blockIdx.y, b = blockIdx.z;
  Ctx<T> c;
  c.bh = size_t(b) * a.H + h;
  c.q = static_cast<const T*>(a.q) + b * a.qs.b + h * a.qs.h;
  c.k = static_cast<const T*>(a.k) + b * a.ks.b + h * a.ks.h;
  c.v = static_cast<const T*>(a.v) + b * a.vs.b + h * a.vs.h;
  c.la = a.la + b * a.las.b + h * a.las.h;
  c.dkp = dkp;
  c.j0 = j0;
  c.st = smem;
  c.qsm = c.st + size_t(dkp) * kDVT;
  c.ksm = c.qsm + kL * kQKStride;
  c.vsm = c.ksm + kL * kQKStride;
  c.vsc = c.vsm + kL * kDVT;
  c.scm = c.vsc + kL * kDVT;
  c.Am = reinterpret_cast<double*>(c.scm + kL * kL);
  c.eAm = reinterpret_cast<float*>(c.Am + kL);

  // the state slab: the initial state's columns j0 .. j0 + kDVT, or zeros
  for (int idx = threadIdx.x; idx < dkp * kDVT; idx += kThreads)
    c.st[idx] = init_at(a, c.bh, idx / kDVT, j0 + idx % kDVT);
  __syncthreads();

  for (int c0 = 0; c0 < a.S; c0 += kL) {
    const int nv = min(kL, a.S - c0);
    switch ((nv + 15) / 16) {
      case 1: chunk_step<T, 1>(a, c, c0, nv); break;
      case 2: chunk_step<T, 2>(a, c, c0, nv); break;
      case 3: chunk_step<T, 3>(a, c, c0, nv); break;
      default: chunk_step<T, 4>(a, c, c0, nv); break;
    }
  }

  for (int idx = threadIdx.x; idx < dkp * kDVT; idx += kThreads)
    store_state(a, c.bh, idx / kDVT, j0 + idx % kDVT, c.st[idx]);
}

template <typename T>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const int dkp = (a.dk + kDKT - 1) / kDKT * kDKT;
  const size_t bytes = smem_bytes(dkp);
  auto kernel = scan_simt_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return err;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return err;
  }
  const int dve = a.dv + (a.nrm != nullptr ? 1 : 0);
  const dim3 grid((dve + kDVT - 1) / kDVT, a.H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(a, dkp);
  return cudaGetLastError();
}

}  // namespace simt

enum Variant : int { kSimt = 0, kMma = 1, kStep = 2 };

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// What the tensor-core kernel's 16-byte row copies assume (the wrapper's
// `linear_scan.variant` checks the same first).
bool mma_layout_ok(const Args& a) {
  const Strides* all[3] = {&a.qs, &a.ks, &a.vs};
  for (const Strides* s : all)
    if (s->d != 1 || s->b % 8 || s->h % 8 || s->s % 8) return false;
  return a.dk <= mmas::MAX_DK && a.dk % 8 == 0 && a.dv % 8 == 0 && aligned16(a.q) &&
         aligned16(a.k) && aligned16(a.v) && aligned16(a.y);
}

}  // namespace

// C entry point. q, k: (B, H, S, dk) and v: (B, H, S, dv) of one dtype (0 fp32,
// 1 bf16) and log_a: (B, H, S) fp32, each given by its element strides;
// init (may be null) and state_out: contiguous fp32 (B, H, dk, dv); y:
// contiguous (B, H, S, dv) in q's dtype. nrm (null: no normaliser):
// contiguous (B, H, S) in q's dtype, the scan of v = ones in the same launch,
// from init_n (may be null) into n_out, contiguous fp32 (B, H, dk). variant:
// 0 the exact-FMA chunk kernel, 1 the tensor-core chunk kernel (bf16; `tile`
// of 16, 32 or 64 state columns a block), 2 the step kernel (S <= 16).
// Returns the cudaError_t of the launch.
extern "C" int gated_linear_scan_fwd(const void* q, const void* k, const void* v,
                                     const void* log_a, const void* init, const void* init_n,
                                     void* y, void* state_out, void* nrm, void* n_out, int B,
                                     int H, int S, int dk, int dv, long long qsb, long long qsh,
                                     long long qss, long long qsd, long long ksb, long long ksh,
                                     long long kss, long long ksd, long long vsb, long long vsh,
                                     long long vss, long long vsd, long long lab, long long lah,
                                     long long las, int dtype, int variant, int tile,
                                     void* stream) {
  if (B < 1 || H < 1 || S < 1 || dk < 1 || dk > kMaxDk || dv < 1 || H > 65535 || B > 65535)
    return int(cudaErrorInvalidValue);
  if (dtype != repro::kFloat32 && dtype != repro::kBFloat16) return int(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.la = static_cast<const float*>(log_a);
  a.init = static_cast<const float*>(init);
  a.init_n = static_cast<const float*>(init_n);
  a.y = y;
  a.st_out = static_cast<float*>(state_out);
  a.nrm = nrm;
  a.n_out = static_cast<float*>(n_out);
  a.H = H;
  a.S = S;
  a.dk = dk;
  a.dv = dv;
  a.qs = {qsb, qsh, qss, qsd};
  a.ks = {ksb, ksh, kss, ksd};
  a.vs = {vsb, vsh, vss, vsd};
  a.las = {lab, lah, las, 0};
  if (nrm != nullptr && n_out == nullptr) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf = dtype == repro::kBFloat16;
  cudaError_t err = cudaErrorInvalidValue;
  if (variant == kStep) {
    if (S <= step::MAX_S)
      err = bf ? step::launch<__nv_bfloat16>(a, B, s) : step::launch<float>(a, B, s);
  } else if (variant == kMma) {
    if (!bf || S <= step::MAX_S || !mma_layout_ok(a)) return int(cudaErrorInvalidValue);
    err = mmas::launch_tile(a, B, tile, s);
  } else if (variant == kSimt) {
    err = bf ? simt::launch<__nv_bfloat16>(a, B, s) : simt::launch<float>(a, B, s);
  }
  if (err != cudaSuccess) cudaGetLastError();  // clear a failed launch's error
  return int(err);
}

// Dynamic shared memory (bytes) a block of the tensor-core kernel asks for:
// `tile` (16, 32 or 64) state columns a block, dk; 0 for another tile.
extern "C" int gated_linear_scan_mma_smem_bytes(int tile, int dk) {
  const int dkp = (dk + 15) / 16 * 16;
  if (tile == 16) return int(mmas::Smem<1>(dkp).total);
  if (tile == 32) return int(mmas::Smem<2>(dkp).total);
  if (tile == 64) return int(mmas::Smem<4>(dkp).total);
  return 0;
}
