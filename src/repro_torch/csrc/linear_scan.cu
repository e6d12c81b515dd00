// Chunkwise gated linear recurrence for Hopper (sm_90a), hand-written CUDA C++.
//
//   S_t = a_t * S_{t-1} + k_t^T v_t ;  y_t = q_t @ S_t ;  a_t = exp(log_a_t)
//
// Replaces the reference's Pallas TPU kernel
// `repro/kernels/linear_scan.py::gated_linear_scan` (`_kernel`): the mLSTM
// matrix memory of xlstm (and its normaliser with v = ones) and the Mamba2
// SSD core. q, k: (B, H, S, dk); v: (B, H, S, dv), fp32 or bf16, any strides
// (the models pass head-split views of their projections); log_a: (B, H, S)
// fp32. Returns y (B, H, S, dv) in q's dtype and the final state
// (B, H, dk, dv) in fp32, from an optional fp32 initial state (zeros when
// absent): serving prefills from zero states and decodes one position at a
// time from the slot's state through this same kernel.
//
// Per chunk of kL positions, as the Pallas kernel: A = cumsum(log_a) (here in
// fp64, see chunk_step); intra-chunk scores (q_i . k_j) exp(A_i - A_j) for
// j <= i (the exponent is formed only for j <= i, where it is <= 0: for
// j > i it could overflow); the inter-chunk read exp(A_i) q_i S_prev; and the
// state update exp(a_tot) S_prev + k^T (v * exp(a_tot - A)). Every product
// is computed here in fp32 on CUDA cores; the state accumulates in fp32.
//
// What bounds it on the H100: the TPU kernel keeps one (dk, dv) fp32 state in
// VMEM; xlstm-125m's mLSTM has dk = dv = 384, a 576 KB state, more than a
// block's 227 KB of shared memory. The columns of S evolve independently
// (S[:, c] depends on q, k, a and v[:, c] only), so the grid is (dv tiles of
// kDVT columns, H, B) and each block keeps a dk x kDVT slab of the state in
// shared memory and walks the chunks in order. The price is that each dv
// tile recomputes the chunk's intra-chunk scores (L x L x dk), which are half
// of a block's arithmetic at dk = 384; the scan is then bound by operations
// (scalar FMA from shared memory), not by the ~110 MB it moves at the
// forward/loss shape. q and k are staged in dk sub-tiles of kDKT, so shared
// memory is ~97 KB at dk = 384 and two blocks share an SM. Any S runs: the
// ragged last chunk is masked here (the Pallas wrapper asserts S % chunk ==
// 0), and a chunk with few valid rows (a decode step, S = 1) does only the
// row groups that hold them. tensor cores (wgmma), one scores pass shared by
// all dv tiles, and fusing the normaliser as an extra v column are later work.
#include "common.cuh"

namespace {

constexpr int kL = 64;                    // positions per chunk
constexpr int kDVT = 32;                  // state columns a block owns: one per lane
constexpr int kDKT = 32;                  // state rows per sub-tile of the dk loop
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQKStride = kDKT + 1;       // padded rows: conflict-free column reads
constexpr int kMaxDk = 1024;

// Element strides of a (B, H, S, d) view; d is 0 for log_a's (B, H, S).
struct Strides {
  long long b, h, s, d;
};

size_t smem_bytes(int dkp) {
  return sizeof(float) * (size_t(dkp) * kDVT        // st   [dkp][kDVT] state slab
                          + 2 * size_t(kL) * kQKStride  // qsm, ksm [kL][kQKStride]
                          + 2 * size_t(kL) * kDVT   // vsm, vsc [kL][kDVT]
                          + size_t(kL) * kL)        // scm  [kL][kL] gated scores
         + sizeof(double) * kL                      // Am   [kL] (8-byte aligned: the
                                                    //       float counts above are even)
         + sizeof(float) * kL;                      // eAm  [kL]
}

template <typename T>
struct Ctx {
  const T* q;  // this (b, h)'s rows
  const T* k;
  const T* v;
  const float* la;
  T* y;  // this (b, h)'s contiguous (S, dv) output
  Strides qs, ks, vs;
  long long las;
  int S, dk, dkp, dv, j0;
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
// row groups hold valid rows: a full chunk has 4, a decode step 1; rows past
// nv are zero in shared memory and never stored.
template <typename T, int NG>
__device__ __forceinline__ void chunk_step(const Ctx<T>& c, int c0, int nv) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ti = tid >> 4, tj = tid & 15;  // scores: rows ti + 16 r, cols tj + 16 u
  const int col = c.j0 + lane;

  // v chunk, and the chunk's cumulative log decay A in fp64 (one warp: two
  // positions a lane, an inclusive scan of the pair sums). A reaches -60 and
  // below within a chunk at xlstm's decays, where fp32 would leave ~1e-5 of
  // rounding in A_i - A_j and so in every gate; every exponent below is
  // formed in fp64 and only then rounded to fp32 and exponentiated.
  for (int idx = tid; idx < kL * kDVT; idx += kThreads) {
    const int i = idx / kDVT, cc = idx % kDVT;
    float x = 0.f;
    if (i < nv && c.j0 + cc < c.dv)
      x = repro::to_float(c.v[(c0 + i) * c.vs.s + (c.j0 + cc) * c.vs.d]);
    c.vsm[idx] = x;
  }
  if (warp == 0) {
    const int i0 = 2 * lane;
    const double x0 = i0 < nv ? c.la[(c0 + i0) * c.las] : 0.0;
    const double x1 = i0 + 1 < nv ? c.la[(c0 + i0 + 1) * c.las] : 0.0;
    double incl = x0 + x1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double n = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += n;
    }
    double excl = __shfl_up_sync(0xffffffffu, incl, 1);
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
      if (i < nv && d0 + d < c.dk) {
        xq = repro::to_float(c.q[(c0 + i) * c.qs.s + (d0 + d) * c.qs.d]);
        xk = repro::to_float(c.k[(c0 + i) * c.ks.s + (d0 + d) * c.ks.d]);
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
    if (i < nv && col < c.dv) c.y[size_t(c0 + i) * c.dv + col] = repro::from_float<T>(acc);
  }
  __syncthreads();  // before the next chunk overwrites v, A and the scores
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gated_scan_kernel(const T* q, const T* k, const T* v, const float* log_a,
                      const float* init, T* y, float* state_out, int H, int S, int dk,
                      int dkp, int dv, Strides qs, Strides ks, Strides vs, Strides las) {
  extern __shared__ float smem[];
  const int j0 = blockIdx.x * kDVT, h = blockIdx.y, b = blockIdx.z;
  const size_t bh = size_t(b) * H + h;
  Ctx<T> c;
  c.q = q + b * qs.b + h * qs.h;
  c.k = k + b * ks.b + h * ks.h;
  c.v = v + b * vs.b + h * vs.h;
  c.la = log_a + b * las.b + h * las.h;
  c.y = y + bh * S * dv;
  c.qs = qs;
  c.ks = ks;
  c.vs = vs;
  c.las = las.s;
  c.S = S;
  c.dk = dk;
  c.dkp = dkp;
  c.dv = dv;
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
  for (int idx = threadIdx.x; idx < dkp * kDVT; idx += kThreads) {
    const int d = idx / kDVT, cc = idx % kDVT;
    float x = 0.f;
    if (init != nullptr && d < dk && j0 + cc < dv) x = init[(bh * dk + d) * dv + j0 + cc];
    c.st[idx] = x;
  }
  __syncthreads();

  for (int c0 = 0; c0 < S; c0 += kL) {
    const int nv = min(kL, S - c0);
    switch ((nv + 15) / 16) {
      case 1: chunk_step<T, 1>(c, c0, nv); break;
      case 2: chunk_step<T, 2>(c, c0, nv); break;
      case 3: chunk_step<T, 3>(c, c0, nv); break;
      default: chunk_step<T, 4>(c, c0, nv); break;
    }
  }

  for (int idx = threadIdx.x; idx < dkp * kDVT; idx += kThreads) {
    const int d = idx / kDVT, cc = idx % kDVT;
    if (d < dk && j0 + cc < dv) state_out[(bh * dk + d) * dv + j0 + cc] = c.st[idx];
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* log_a,
                   const float* init, void* y, float* state_out, int B, int H, int S, int dk,
                   int dv, Strides qs, Strides ks, Strides vs, Strides las,
                   cudaStream_t stream) {
  const int dkp = (dk + kDKT - 1) / kDKT * kDKT;
  const size_t bytes = smem_bytes(dkp);
  auto kernel = gated_scan_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return err;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return err;
  }
  dim3 grid((dv + kDVT - 1) / kDVT, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), log_a, init,
      static_cast<T*>(y), state_out, H, S, dk, dkp, dv, qs, ks, vs, las);
  return cudaGetLastError();
}

}  // namespace

// C entry point. q, k: (B, H, S, dk) and v: (B, H, S, dv) of one dtype (0 fp32,
// 1 bf16) and log_a: (B, H, S) fp32, each given by its element strides;
// init (may be null) and state_out: contiguous fp32 (B, H, dk, dv); y:
// contiguous (B, H, S, dv) in q's dtype. Returns the cudaError_t of the launch.
extern "C" int gated_linear_scan_fwd(const void* q, const void* k, const void* v,
                                     const void* log_a, const void* init, void* y,
                                     void* state_out, int B, int H, int S, int dk, int dv,
                                     long long qsb, long long qsh, long long qss, long long qsd,
                                     long long ksb, long long ksh, long long kss, long long ksd,
                                     long long vsb, long long vsh, long long vss, long long vsd,
                                     long long lab, long long lah, long long las, int dtype,
                                     void* stream) {
  if (B < 1 || H < 1 || S < 1 || dk < 1 || dk > kMaxDk || dv < 1 || H > 65535 || B > 65535)
    return int(cudaErrorInvalidValue);
  const Strides qs{qsb, qsh, qss, qsd}, ks{ksb, ksh, kss, ksd}, vs{vsb, vsh, vss, vsd};
  const Strides la{lab, lah, las, 0};
  const float* la_p = static_cast<const float*>(log_a);
  const float* init_p = static_cast<const float*>(init);
  float* st_p = static_cast<float*>(state_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return int(launch<float>(q, k, v, la_p, init_p, y, st_p, B, H, S, dk, dv, qs, ks, vs, la, s));
  if (dtype == repro::kBFloat16)
    return int(launch<__nv_bfloat16>(q, k, v, la_p, init_p, y, st_p, B, H, S, dk, dv, qs, ks, vs,
                                     la, s));
  return int(cudaErrorInvalidValue);
}
