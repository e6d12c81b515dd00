// Fused linear layer y = act(x @ W + b) for Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces the reference's Pallas TPU kernel
// `repro/kernels/fused_linear.py::fused_linear` (`_kernel`): a tiled matrix
// product with an fp32 accumulator, and the bias and the activation (none,
// relu, or gelu in its tanh form, jax.nn.gelu's default) applied in the
// epilogue before the one store of the output, in x's dtype. The Pallas
// kernel carries its accumulator across a sequential K grid axis in VMEM
// scratch; here each block owns one output tile and loops over K itself.
//
// What bounds it on the H100: a large product is bound by operations --
// 989 TFLOP/s for bf16 on the tensor cores, 67 TFLOP/s for fp32 on the CUDA
// cores -- and Test Case 2's small products (256 x 64 @ 64 x 32, then
// 256 x 32 @ 32 x 10, ~1 MFLOP) by launch latency. Three variants, chosen
// by an explicit rule in the wrapper (`kernels/fused_linear.py::variant`):
//
// * wgmma (bf16, K and N multiples of 8, x and W 16-byte aligned): the
//   tensor cores. A 128 x 256 output tile a block; one producer warp keeps a
//   4-stage ring of TMA loads in flight (x tile 128 x 64, K-major; W tile
//   64 x 256 as four 64-column boxes, N-major), each stage guarded by a
//   "full" and an "empty" mbarrier; two consumer warpgroups each run
//   `wgmma.mma_async` m64n256k16 on their 64 rows (B through the transpose
//   bit), the accumulator in registers (`setmaxnreg` moves registers from
//   the producer to them). TMA's 128-byte swizzle makes the shared-memory
//   reads conflict-free, and it zero-fills a ragged M / N / K; the epilogue
//   clips the store. Every product stays in fp32 accumulation.
// * simt_tiled (fp32, K and N multiples of 4, 16-byte aligned, at least a
//   wave of 128 x 128 tiles): exact fp32 FMA on the CUDA cores -- never TF32,
//   which would move the results outside the reference's 2e-5 tolerance. A
//   128 x 128 tile a block, 8 x 8 outputs a thread, K slices of 16 loaded by
//   16-byte `cp.async` into two shared-memory buffers (the next slice loads
//   while this one is multiplied) and read back as float4.
// * simt (everything else, fp32 or bf16, any shape): a 64 x 64 tile, K slices
//   of 16, a 4 x 4 micro-tile, ragged M, N, K masked in the loads. Small
//   problems stay here: Test Case 2's 256-row batches give 4 blocks, where a
//   128 x 128 tile would give 2.
#include "common.cuh"
#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

using repro::sm90::aligned16;

enum Act : int { kNone = 0, kRelu = 1, kGelu = 2 };
enum Variant : int { kSimt = 0, kSimtTiled = 1, kWgmma = 2 };

__device__ __forceinline__ float apply_act(float y, int act) {
  if (act == kRelu) return fmaxf(y, 0.f);
  if (act == kGelu) {
    // 0.5 y (1 + tanh(sqrt(2 / pi) (y + 0.044715 y^3))), as torch's and jax's tanh gelu
    const float k0 = 0.7978845608028654f, k1 = 0.044715f;
    return 0.5f * y * (1.f + tanhf(k0 * (y + k1 * y * y * y)));
  }
  return y;
}

// ---------------------------------------------------------------------------
// wgmma: bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {
constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int CONSUMERS = 2;                  // warpgroups of 64 output rows each
constexpr int NT = 128 * (CONSUMERS + 1);     // + one producer warpgroup
constexpr int A_BYTES = BM * BK * 2;          // x tile: 128 rows of 128 bytes
constexpr int B_BOX = BK * 64 * 2;            // one 64-column box of W: 64 rows of 128 bytes
constexpr int B_BYTES = (BN / 64) * B_BOX;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr size_t SMEM = size_t(STAGES) * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t) + 1024;
}  // namespace tc

__global__ void __launch_bounds__(tc::NT, 1) fused_linear_wgmma_kernel(
    const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
    const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y, int M, int N, int K,
    int act) {
  using namespace repro::sm90;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + tc::STAGES * tc::STAGE_BYTES);
  uint64_t* empty = full + tc::STAGES;
  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.y * tc::BM, n0 = blockIdx.x * tc::BN;
  const int k_tiles = (K + tc::BK - 1) / tc::BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < tc::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], tc::CONSUMERS * 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == tc::CONSUMERS) {
    // producer: one thread keeps the ring full
    setmaxnreg_dec<40>();
    if (threadIdx.x == tc::CONSUMERS * 128) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % tc::STAGES;
        mbar_wait(&empty[s], ((kt / tc::STAGES) & 1) ^ 1);
        uint8_t* a = smem + s * tc::STAGE_BYTES;
        uint8_t* b = a + tc::A_BYTES;
        mbar_arrive_expect_tx(&full[s], tc::STAGE_BYTES);
        tma_load_2d(a, &x_map, &full[s], kt * tc::BK, m0);
#pragma unroll
        for (int j = 0; j < tc::BN / 64; ++j)
          tma_load_2d(b + j * tc::B_BOX, &w_map, &full[s], n0 + 64 * j, kt * tc::BK);
      }
    }
  } else {
    // consumers: 64 rows x 256 columns each, fp32 in registers
    setmaxnreg_inc<232>();
    float acc[tc::BN / 2];
#pragma unroll
    for (int i = 0; i < tc::BN / 2; ++i) acc[i] = 0.f;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    fence_regs(acc);
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % tc::STAGES;
      mbar_wait(&full[s], (kt / tc::STAGES) & 1);
      const uint8_t* a = smem + s * tc::STAGE_BYTES + wg * (64 * 128);
      const uint8_t* b = smem + s * tc::STAGE_BYTES + tc::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < tc::BK / 16; ++kk) {
        // x: K-major, 16 columns = 32 bytes along the swizzled row; W:
        // N-major (transpose bit), 16 K rows = 2048 bytes down the box
        wgmma_ss<256, 0, 1>(acc, smem_desc(a + kk * 32, 16, 1024),
                            smem_desc(b + kk * 2048, tc::B_BOX, 1024), 1);
      }
      wgmma_commit();
      // keep this slice's products in flight; the previous slice's are done
      wgmma_wait<1>();
      if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % tc::STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // epilogue: bias, activation, bf16 pairs; rows and columns clipped
    const int g = lane / 4, t = lane % 4;
    const int row0 = m0 + wg * 64 + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < tc::BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= N) continue;  // N % 8 == 0: col + 1 < N as well
      const float b0 = __bfloat162float(bias[col]), b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row < M) {
          *reinterpret_cast<uint32_t*>(y + size_t(row) * N + col) =
              pack_bf16x2(apply_act(acc[4 * j + 2 * h] + b0, act),
                          apply_act(acc[4 * j + 2 * h + 1] + b1, act));
        }
      }
    }
  }
}

cudaError_t launch_wgmma(const void* x, const void* w, const void* b, void* y, int M, int N,
                         int K, int act, cudaStream_t stream) {
  CUtensorMap x_map, w_map;
  const uint64_t x_sizes[2] = {uint64_t(K), uint64_t(M)}, x_strides[2] = {2, uint64_t(K) * 2};
  const uint32_t x_box[2] = {tc::BK, tc::BM};
  const uint64_t w_sizes[2] = {uint64_t(N), uint64_t(K)}, w_strides[2] = {2, uint64_t(N) * 2};
  const uint32_t w_box[2] = {64, tc::BK};
  if (!repro::sm90::encode_bf16_map(&x_map, x, 2, x_sizes, x_strides, x_box) ||
      !repro::sm90::encode_bf16_map(&w_map, w, 2, w_sizes, w_strides, w_box))
    return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(  // once a process: one card
      fused_linear_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(tc::SMEM));
  if (attr != cudaSuccess) return attr;
  dim3 grid((N + tc::BN - 1) / tc::BN, (M + tc::BM - 1) / tc::BM);
  fused_linear_wgmma_kernel<<<grid, tc::NT, tc::SMEM, stream>>>(
      x_map, w_map, static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(y), M, N,
      K, act);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// simt_tiled: fp32, 128 x 128 tiles, cp.async double buffering
// ---------------------------------------------------------------------------

namespace st {
constexpr int BM = 128, BN = 128, BK = 16, NT = 256;  // 16 x 16 threads, 8 x 8 outputs each
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   repro::sm90::smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__global__ void __launch_bounds__(st::NT, 2) fused_linear_simt_tiled_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ y, int M, int N, int K, int act) {
  __shared__ __align__(16) float As[2][st::BM][st::BK];  // x tile, K-contiguous rows
  __shared__ __align__(16) float Bs[2][st::BK][st::BN];  // W tile, N-contiguous rows
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * st::BM, n0 = blockIdx.x * st::BN;

  // one K slice: 512 float4 of x and 512 of W, two of each a thread; a
  // float4 past M, N or K (all multiples of 4 where it matters) reads zeros
  auto load = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + i * st::NT;
      const int r = e / 4, c = (e % 4) * 4;
      const bool ok = m0 + r < M && k0 + c < K;
      cp_async16(&As[buf][r][c], ok ? x + size_t(m0 + r) * K + k0 + c : x, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + i * st::NT;
      const int r = e / 32, c = (e % 32) * 4;
      const bool ok = k0 + r < K && n0 + c < N;
      cp_async16(&Bs[buf][r][c], ok ? w + size_t(k0 + r) * N + n0 + c : w, ok ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  // rows ty*4 + i and 64 + ty*4 + i, columns tx*4 + j and 64 + tx*4 + j:
  // neighbouring threads read neighbouring float4 of Bs
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int k_tiles = (K + st::BK - 1) / st::BK;
  load(0, 0);
  for (int kt = 0; kt < k_tiles; ++kt) {
    if (kt + 1 < k_tiles) {
      load((kt + 1) & 1, (kt + 1) * st::BK);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    const int buf = kt & 1;
#pragma unroll
    for (int k4 = 0; k4 < st::BK; k4 += 4) {
      float4 a4[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a4[i] = *reinterpret_cast<const float4*>(&As[buf][(i / 4) * 64 + ty * 4 + i % 4][k4]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k4 + kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][k4 + kk][64 + tx * 4]);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = kk == 0 ? a4[i].x : kk == 1 ? a4[i].y : kk == 2 ? a4[i].z : a4[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration's load
  }

#pragma unroll
  for (int jh = 0; jh < 2; ++jh) {
    const int col = n0 + jh * 64 + tx * 4;
    if (col >= N) continue;  // N % 4 == 0: the float4 is in or out as a whole
    const float4 bb = *reinterpret_cast<const float4*>(bias + col);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = m0 + (i / 4) * 64 + ty * 4 + i % 4;
      if (row >= M) continue;
      float4 o;
      o.x = apply_act(acc[i][jh * 4 + 0] + bb.x, act);
      o.y = apply_act(acc[i][jh * 4 + 1] + bb.y, act);
      o.z = apply_act(acc[i][jh * 4 + 2] + bb.z, act);
      o.w = apply_act(acc[i][jh * 4 + 3] + bb.w, act);
      *reinterpret_cast<float4*>(y + size_t(row) * N + col) = o;
    }
  }
}

// ---------------------------------------------------------------------------
// simt: any dtype and shape, 64 x 64 tiles
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 64, BK = 16;  // output tile and K slice
constexpr int TM = 4, TN = 4;             // register micro-tile of one thread
constexpr int NT = (BM / TM) * (BN / TN);  // 256 threads
constexpr int PAD = 4;                     // As row padding: fewer bank conflicts on the transposed store

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

cudaError_t launch_simt_tiled(const void* x, const void* w, const void* b, void* y, int M,
                              int N, int K, int act, cudaStream_t stream) {
  dim3 grid((N + st::BN - 1) / st::BN, (M + st::BM - 1) / st::BM);
  fused_linear_simt_tiled_kernel<<<grid, st::NT, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(y), M, N, K, act);
  return cudaGetLastError();
}

}  // namespace

// C entry point. x: (M, K); w: (K, N); b: (N,); y: (M, N). All contiguous,
// one float dtype (0 fp32, 1 bf16); act 0 none, 1 relu, 2 gelu (tanh);
// variant 0 simt, 1 simt_tiled (fp32; K, N multiples of 4; x, w, b, y
// 16-byte aligned), 2 wgmma (bf16; K, N multiples of 8; x, w 16-byte
// aligned). Returns the cudaError_t of the launch.
extern "C" int fused_linear_fwd(const void* x, const void* w, const void* b, void* y, int M,
                                int N, int K, int dtype, int act, int variant, void* stream) {
  if (M < 1 || N < 1 || K < 1 || act < kNone || act > kGelu) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kWgmma) {
    if (dtype != repro::kBFloat16 || K % 8 || N % 8 || !aligned16(x) || !aligned16(w) ||
        (M + tc::BM - 1) / tc::BM > 65535)
      return int(cudaErrorInvalidValue);
    return int(launch_wgmma(x, w, b, y, M, N, K, act, s));
  }
  if (variant == kSimtTiled) {
    if (dtype != repro::kFloat32 || K % 4 || N % 4 || !aligned16(x) || !aligned16(w) ||
        !aligned16(b) || !aligned16(y) || (M + st::BM - 1) / st::BM > 65535)
      return int(cudaErrorInvalidValue);
    return int(launch_simt_tiled(x, w, b, y, M, N, K, act, s));
  }
  if (variant != kSimt || (long long)((M + BM - 1) / BM) > 65535) return int(cudaErrorInvalidValue);
  if (dtype == repro::kFloat32) return int(launch<float>(x, w, b, y, M, N, K, act, s));
  if (dtype == repro::kBFloat16) return int(launch<__nv_bfloat16>(x, w, b, y, M, N, K, act, s));
  return int(cudaErrorInvalidValue);
}
