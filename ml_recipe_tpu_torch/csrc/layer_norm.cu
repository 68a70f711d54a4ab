// LayerNorm forward and backward for Hopper (sm_90a), bound to PyTorch
// through plain C launch functions loaded with ctypes
// (ml_recipe_tpu_torch/ops/layer_norm.py).
//
// Replaces the TPU package's two LayerNorm kernels
// (ml_recipe_tpu/ops/layer_norm.py):
// - :84 `_ln_fwd_kernel`, per row of h [N, C]:
//     y = (h - mean) * rsqrt(var + eps) * gamma + beta
//   with the mean and then the CENTRED variance in f32 (two passes over the
//   row, never E[x^2] - E[x]^2), the affine in f32 and one rounding to the
//   output type;
// - :96 `_ln_bwd_kernel`, the one-pass backward with the statistics
//   recomputed from h:
//     dh = (g*gamma - mean(g*gamma) - xhat * mean(g*gamma*xhat)) * rstd
//     dgamma = sum over rows of g*xhat,  dbeta = sum over rows of g   (f32)
//
// Bound on the H100: device memory. A row of C elements moves 2C (forward:
// h in, y out) or 3C (backward: h and g in, dh out) elements for about 10
// and 20 f32 operations per element: at bf16 that is 2.5-3.3 operations per
// byte against the ~20 the card's 67 TFLOP/s f32 rate needs per byte of
// 3.35 TB/s. What the design does about it: every element is read from
// device memory once and written once. A block owns whole rows and each of
// its threads holds kPerThread columns of the row in registers, at a stride
// of the block size so a warp's loads are coalesced; the statistics are
// block reductions (warp shuffles, then one shared-memory slot per warp,
// summed by every thread in the same fixed order). The block size is C /
// kPerThread rounded up to a warp, so C <= kMaxC = 4096 (1024 threads);
// every C of the repo's configs (32 to 1024) fits, and the launch refuses a
// larger one.
//
// The dgamma/dbeta sum crosses rows. The TPU kernel adds each grid step's
// partial into one [1, C] block that stays resident across its SEQUENTIAL
// grid (:113-128); blocks of a GPU run concurrently, so neither that nor
// atomics (whose order changes from run to run) carries over. Here each
// backward block owns a tile of kRowsPerTile rows, keeps its columns'
// partial sums in registers while it walks the tile's rows in order, and
// writes them to an f32 [n_tiles, 2, C] scratch; a second kernel sums the
// scratch over tiles in a fixed order. The result is deterministic: two
// launches on the same inputs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPerThread = 4;                 // columns a thread holds
constexpr int kMaxThreads = 1024;
constexpr int kMaxC = kPerThread * kMaxThreads;
constexpr int kRowsPerTile = 16;              // backward rows per block
constexpr int kReduceSlices = 8;              // tile slices per column sum

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Sum each v[i] over the block; every thread gets the sums. `red` holds 32
// floats per value. Partials are added in warp order by every thread, so
// the result is the same in all of them and from run to run. blockDim.x is
// a multiple of 32.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
    }
    if (lane == 0) red[i * 32 + warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float s = 0.f;
    for (int w = 0; w < n_warps; ++w) s += red[i * 32 + w];
    v[i] = s;
  }
  __syncthreads();  // `red` is reused by the next reduction
}

// Load one row's columns into x (0 past C), centre them on the row mean
// and return rstd = rsqrt(centred variance + eps); x then holds h - mean.
template <typename T>
__device__ __forceinline__ float centre_row(const T* __restrict__ row,
                                            float (&x)[kPerThread], int C,
                                            float eps, float* red) {
  float s[1] = {0.f};
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    x[i] = c < C ? to_float(row[c]) : 0.f;
    s[0] += x[i];
  }
  block_sum(s, red);
  const float mean = s[0] / (float)C;
  float q[1] = {0.f};
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    x[i] = c < C ? x[i] - mean : 0.f;
    q[0] += x[i] * x[i];
  }
  block_sum(q, red);
  return rsqrtf(q[0] / (float)C + eps);
}

// One block per row.
template <typename T, typename TO>
__global__ void __launch_bounds__(kMaxThreads)
    layer_norm_fwd_kernel(const T* __restrict__ h,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta,
                          TO* __restrict__ y, int C, float eps) {
  __shared__ float red[32];
  const int64_t off = (int64_t)blockIdx.x * C;
  float x[kPerThread];
  const float rstd = centre_row(h + off, x, C, eps, red);
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < C) {
      // xhat * gamma + beta, rounded as the TPU kernel's separate ops
      // (no fused multiply-add)
      const float xhat = __fmul_rn(x[i], rstd);
      store(y + off + c, __fadd_rn(__fmul_rn(xhat, gamma[c]), beta[c]));
    }
  }
}

// One block per tile of kRowsPerTile rows; writes dh and the tile's
// dgamma/dbeta partials to partial[tile, 0, :] and partial[tile, 1, :].
template <typename T, typename G>
__global__ void __launch_bounds__(kMaxThreads)
    layer_norm_bwd_kernel(const T* __restrict__ h,
                          const float* __restrict__ gamma,
                          const G* __restrict__ g, T* __restrict__ dh,
                          float* __restrict__ partial, int N, int C,
                          float eps) {
  __shared__ float red[64];
  float gam[kPerThread], pg[kPerThread], pb[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    gam[i] = c < C ? gamma[c] : 0.f;
    pg[i] = 0.f;
    pb[i] = 0.f;
  }
  const int row0 = blockIdx.x * kRowsPerTile;
  const int rows = min(kRowsPerTile, N - row0);
  for (int r = 0; r < rows; ++r) {
    const int64_t off = (int64_t)(row0 + r) * C;
    float x[kPerThread], gg[kPerThread];
    const float rstd = centre_row(h + off, x, C, eps, red);
    float m[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
      const float gv = c < C ? to_float(g[off + c]) : 0.f;
      x[i] = __fmul_rn(x[i], rstd);                  // xhat
      gg[i] = __fmul_rn(gv, gam[i]);
      m[0] += gg[i];
      m[1] += __fmul_rn(gg[i], x[i]);
      pg[i] += __fmul_rn(gv, x[i]);
      pb[i] += gv;
    }
    block_sum(m, red);
    const float m1 = m[0] / (float)C, m2 = m[1] / (float)C;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
      if (c < C) {
        const float d = __fsub_rn(__fsub_rn(gg[i], m1), __fmul_rn(x[i], m2));
        store(dh + off + c, __fmul_rn(d, rstd));
      }
    }
  }
  float* p = partial + (int64_t)blockIdx.x * 2 * C;
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < C) {
      p[c] = pg[i];
      p[C + c] = pb[i];
    }
  }
}

// dgamma[c] = sum over tiles of partial[t, 0, c], dbeta from partial[t, 1,
// c]. Block (32 columns, kReduceSlices slices): slice s sums tiles s, s+8,
// ... in order, then slice 0 adds the slices in order. A fixed order, so the
// sums are the same from run to run.
__global__ void __launch_bounds__(32 * kReduceSlices)
    layer_norm_bwd_reduce_kernel(const float* __restrict__ partial,
                                 float* __restrict__ dgamma,
                                 float* __restrict__ dbeta, int n_tiles,
                                 int C) {
  __shared__ float acc[kReduceSlices][2][32];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int slice = threadIdx.y;
  float sg = 0.f, sb = 0.f;
  if (c < C) {
    for (int t = slice; t < n_tiles; t += kReduceSlices) {
      const float* p = partial + (int64_t)t * 2 * C;
      sg += p[c];
      sb += p[C + c];
    }
  }
  acc[slice][0][threadIdx.x] = sg;
  acc[slice][1][threadIdx.x] = sb;
  __syncthreads();
  if (slice == 0 && c < C) {
    float a = 0.f, b = 0.f;
    for (int s = 0; s < kReduceSlices; ++s) {
      a += acc[s][0][threadIdx.x];
      b += acc[s][1][threadIdx.x];
    }
    dgamma[c] = a;
    dbeta[c] = b;
  }
}

int block_threads(int C) {
  const int t = (C + kPerThread - 1) / kPerThread;
  return (t + 31) / 32 * 32;
}

template <typename T, typename TO>
cudaError_t launch_fwd(const void* h, const void* gamma, const void* beta,
                       void* y, int N, int C, float eps, cudaStream_t s) {
  layer_norm_fwd_kernel<T, TO><<<N, block_threads(C), 0, s>>>(
      static_cast<const T*>(h), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<TO*>(y), C, eps);
  return cudaGetLastError();
}

template <typename T, typename G>
cudaError_t launch_bwd(const void* h, const void* gamma, const void* g,
                       void* dh, void* partial, void* dgamma, void* dbeta,
                       int N, int C, float eps, cudaStream_t s) {
  const int n_tiles = (N + kRowsPerTile - 1) / kRowsPerTile;
  layer_norm_bwd_kernel<T, G><<<n_tiles, block_threads(C), 0, s>>>(
      static_cast<const T*>(h), static_cast<const float*>(gamma),
      static_cast<const G*>(g), static_cast<T*>(dh),
      static_cast<float*>(partial), N, C, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  layer_norm_bwd_reduce_kernel<<<(C + 31) / 32, dim3(32, kReduceSlices), 0,
                                 s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), n_tiles, C);
  return cudaGetLastError();
}

}  // namespace

// The rows of one backward tile: the wrapper sizes the [n_tiles, 2, C] f32
// partial scratch with it.
extern "C" int layer_norm_rows_per_tile() { return kRowsPerTile; }

// h: [N, C] contiguous, bf16 (h_bf16 = 1) or f32, C <= 4096 (kMaxC, the
// wrapper's MAX_C); gamma, beta: f32 [C]; y: [N, C] contiguous, bf16
// (y_bf16 = 1) or f32. Returns the launch's cudaError_t.
extern "C" int layer_norm_fwd(const void* h, const void* gamma,
                              const void* beta, void* y, int N, int C,
                              int h_bf16, int y_bf16, float eps,
                              void* stream) {
  if (N <= 0 || C <= 0 || C > kMaxC) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  cudaError_t err;
  if (h_bf16) {
    err = y_bf16 ? launch_fwd<bf, bf>(h, gamma, beta, y, N, C, eps, s)
                 : launch_fwd<bf, float>(h, gamma, beta, y, N, C, eps, s);
  } else {
    err = y_bf16 ? launch_fwd<float, bf>(h, gamma, beta, y, N, C, eps, s)
                 : launch_fwd<float, float>(h, gamma, beta, y, N, C, eps, s);
  }
  return (int)err;
}

// h, dh: [N, C] contiguous in h's type (h_bf16); g: [N, C] contiguous,
// bf16 (g_bf16 = 1) or f32; gamma: f32 [C]; partial: f32 scratch of
// ceil(N / layer_norm_rows_per_tile()) * 2 * C; dgamma, dbeta: f32 [C].
extern "C" int layer_norm_bwd(const void* h, const void* gamma, const void* g,
                              void* dh, void* partial, void* dgamma,
                              void* dbeta, int N, int C, int h_bf16,
                              int g_bf16, float eps, void* stream) {
  if (N <= 0 || C <= 0 || C > kMaxC) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  cudaError_t err;
  if (h_bf16) {
    err = g_bf16 ? launch_bwd<bf, bf>(h, gamma, g, dh, partial, dgamma,
                                      dbeta, N, C, eps, s)
                 : launch_bwd<bf, float>(h, gamma, g, dh, partial, dgamma,
                                         dbeta, N, C, eps, s);
  } else {
    err = g_bf16 ? launch_bwd<float, bf>(h, gamma, g, dh, partial, dgamma,
                                         dbeta, N, C, eps, s)
                 : launch_bwd<float, float>(h, gamma, g, dh, partial, dgamma,
                                            dbeta, N, C, eps, s);
  }
  return (int)err;
}
