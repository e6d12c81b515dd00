// Fused linear layer y = act(x @ W + b) for Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces the reference's Pallas TPU kernel
// `repro/kernels/fused_linear.py::fused_linear` (`_kernel`): a tiled matrix
// product with an fp32 accumulator, and the bias and the activation (none,
// relu, or gelu in its tanh form, jax.nn.gelu's default) applied in the
// epilogue before the one store of the output, in x's dtype. The Pallas
// kernel carries its accumulator across a sequential K grid axis in VMEM
// scratch; here each block owns one 64 x 64 output tile and loops over K
// itself, in slices of 16 staged in shared memory, with a 4 x 4 register
// micro-tile per thread.
//
// What bounds it on the H100: at the paper's Test Case 2 shapes (256 x 64 @
// 64 x 32, then 256 x 32 @ 32 x 10) the work is ~1 MFLOP per call, so launch
// overhead, not bytes or operations. At large square shapes it is bound by
// operations; this first kernel does fp32 FMAs on the CUDA cores (67 TFLOP/s
// peak) for fp32 and bf16 inputs alike -- never TF32, which would change the
// fp32 results beyond the reference's 2e-5 tolerance. Tensor cores (wgmma
// fed by TMA) for bf16 are later work. Ragged M, N and K are masked here:
// out-of-range loads read 0 and out-of-range outputs are not stored (the
// Pallas wrapper needs block multiples, which Test Case 2 met by padding the
// batch to 8 rows).
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16;  // output tile and K slice
constexpr int TM = 4, TN = 4;             // register micro-tile of one thread
constexpr int NT = (BM / TM) * (BN / TN);  // 256 threads
constexpr int PAD = 4;                     // As row padding: fewer bank conflicts on the transposed store

enum Act : int { kNone = 0, kRelu = 1, kGelu = 2 };

__device__ __forceinline__ float apply_act(float y, int act) {
  if (act == kRelu) return fmaxf(y, 0.f);
  if (act == kGelu) {
    // 0.5 y (1 + tanh(sqrt(2 / pi) (y + 0.044715 y^3))), as torch's and jax's tanh gelu
    const float k0 = 0.7978845608028654f, k1 = 0.044715f;
    return 0.5f * y * (1.f + tanhf(k0 * (y + k1 * y * y * y)));
  }
  return y;
}

template <typename T>
__global__ void __launch_bounds__(NT) fused_linear_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
    T* __restrict__ y, int M, int N, int K, int act) {
  __shared__ float As[BK][BM + PAD];  // x tile, transposed: As[k][m]
  __shared__ float Bs[BK][BN];        // W tile: Bs[k][n]
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // neighbouring threads load neighbouring addresses of x and of W
#pragma unroll
    for (int i = 0; i < BM * BK / NT; ++i) {
      const int e = tid + i * NT;
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? repro::to_float(x[size_t(gm) * K + gk]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BK * BN / NT; ++i) {
      const int e = tid + i * NT;
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? repro::to_float(w[size_t(gk) * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: bias, activation, one masked store in the output dtype
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int gn = n0 + tx * TN + j;
    if (gn >= N) continue;
    const float bj = repro::to_float(bias[gn]);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = m0 + ty * TM + i;
      if (gm < M) y[size_t(gm) * N + gn] = repro::from_float<T>(apply_act(acc[i][j] + bj, act));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* y, int M, int N, int K,
                   int act, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fused_linear_kernel<T><<<grid, NT, 0, stream>>>(static_cast<const T*>(x),
                                                 static_cast<const T*>(w),
                                                 static_cast<const T*>(b), static_cast<T*>(y),
                                                 M, N, K, act);
  return cudaGetLastError();
}

}  // namespace

// C entry point. x: (M, K); w: (K, N); b: (N,); y: (M, N). All contiguous,
// one float dtype (0 fp32, 1 bf16); act 0 none, 1 relu, 2 gelu (tanh).
// Returns the cudaError_t of the launch.
extern "C" int fused_linear_fwd(const void* x, const void* w, const void* b, void* y, int M,
                                int N, int K, int dtype, int act, void* stream) {
  if (M < 1 || N < 1 || K < 1 || act < kNone || act > kGelu) return int(cudaErrorInvalidValue);
  if ((long long)((M + BM - 1) / BM) > 65535) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) return int(launch<float>(x, w, b, y, M, N, K, act, s));
  if (dtype == repro::kBFloat16) return int(launch<__nv_bfloat16>(x, w, b, y, M, N, K, act, s));
  return int(cudaErrorInvalidValue);
}
