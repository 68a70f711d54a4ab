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
// 3.35 TB/s. At 32x384 (12288 x 768 bf16) the forward's bound is 0.0113
// ms, and 0.0141 ms with the quantize epilogue (one more byte an element).
//
// The forward for C <= 1024 (every hidden size of the repo's models) with
// rows of whole 16-byte vectors: one warp per row, 8 rows a block. Each
// lane holds its columns in registers, loaded as 16-byte vectors (24
// values from three loads at C = 768 in bf16); the mean and the centred
// variance are warp shuffles alone, with no shared memory and no
// __syncthreads, summed in the same order on every run; rsqrtf; the
// affine with __fmul_rn/__fadd_rn (no FMA contraction); one rounding. On
// request (q != null) the same launch also writes the
// int8 codes and f32 scale of ITS OWN ROUNDED OUTPUT y on the grid of
// ops/quant_matmul.py `quantize_rowwise` (rowwise.cuh): amax by shuffles,
// then the codes, so the int8 model's projections that read a LayerNorm
// output take its codes from here, bit for bit what quantize_rowwise(y)
// gives. For 1024 < C <= kMaxC = 4096, or rows of no whole vectors, a
// block owns a row (kPerThread columns a thread, at a stride of the block
// size; block reductions of warp shuffles and one shared slot per warp),
// and a second kernel of the same launch writes the codes of its y.
//
// The backward (bound by memory: 3C elements a row for ~16 f32 operations
// an element; at 32x512 = 16384 x 768 bf16 it must move 75.5 MB, 0.0225 ms
// at 3.35 TB/s) for C <= 1024 with rows of whole 16-byte vectors: one warp
// per row, kBwdWarps warps a block, and at most kBwdBlocks blocks (two an
// SM), which walk the rows in a fixed interleave: warp w of block b takes
// rows b * kBwdWarps + w, then every G * kBwdWarps rows on (G blocks). A
// lane owns the columns (lane + 32j) * 8 .. + 8 of every row it visits.
// Each warp double-buffers its rows in shared memory: it starts the 16-byte
// cp.async copies of its next row's h and g, then reads back its current
// row (each lane only the words it copied itself, so no barrier), converts
// it to f32 once and keeps it in registers through four passes. The mean,
// the centred variance and the two means of dh are warp shuffles alone (no
// __syncthreads per row); xhat and g*gamma are formed once, with
// __fsub_rn/__fmul_rn, so the rounding is the TPU kernel's separate ops and
// never a contraction; dh leaves as 16-byte vectors. (On the H100 a third
// or fourth buffered row, a third block an SM, streaming stores and fixed
// 64-row tiles measured no faster; scripts/ln_bwd_ab.py times such builds
// side by side.)
//
// The dgamma/dbeta sum crosses rows. The TPU kernel adds each grid step's
// partial into one [1, C] block that stays resident across its SEQUENTIAL
// grid (:113-128); blocks of a GPU run concurrently, so neither that nor
// atomics (whose order changes from run to run) carries over. A lane keeps
// the partial sums of its columns in registers while its warp walks its
// rows in order; at the end each warp parks them in its own buffers, and
// the block's threads add them over the warps in warp order into ONE
// partial row per block of an f32 [G, 2, C] scratch (264 rows, 1.6 MB, at C
// = 768). A second kernel, layer_norm_bwd_sum_kernel, sums the scratch
// over its rows in a fixed order with 32 x 32 threads a block, one block
// per 32 of its 2C columns (48 blocks at C = 768), each thread a slice of
// the rows. It is a second kernel and not a last-arriving block of the
// first because one block would read the whole scratch through one SM (~10
// us at that SM's share of L2 bandwidth), where 48 blocks read it in about
// two microseconds, with no arrival counter to fence and reset. The result
// is deterministic: two launches on the same inputs give the same bits (on
// one kind of card: the interleave is fixed by kBwdBlocks, not by the SM
// count).
//
// For 1024 < C <= kMaxC, or rows of no whole vectors, block b of G =
// min(N, kBwdBlocks) walks rows b, b + G, ... one after another (block
// reductions, kPerThread columns a thread), writing the same scratch row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rowwise.cuh"

namespace {

constexpr int kPerThread = 4;                 // columns a thread holds
constexpr int kMaxThreads = 1024;
constexpr int kMaxC = kPerThread * kMaxThreads;
constexpr int kBwdBlocks = 264;               // backward blocks at most: two
                                              // for each of an H100's 132 SMs
constexpr int kSumSlices = 32;                // row slices per column sum
constexpr int kWarpMaxC = 1024;               // warp kernel: 32 values a lane
constexpr int kWarpRows = 8;                  // warp kernel: rows a block
constexpr int kBwdVec = 8;                    // backward warp kernel: elements
                                              // a lane moves at once
constexpr int kBwdWarps = 8;                  // ... and warps a block

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

// One warp per row (C <= kWarpMaxC), kWarpRows rows a block. V: elements a
// lane loads at once (16 bytes of h, or 1 where the row is not aligned for
// that). kCodes: also write q (int8 [N, C]) and qscale (f32 [N]), the
// quantize_rowwise grid of the rounded y.
template <typename T, typename TO, int V, bool kCodes>
__global__ void __launch_bounds__(kWarpRows * 32)
    layer_norm_fwd_warp_kernel(const T* __restrict__ h,
                               const float* __restrict__ gamma,
                               const float* __restrict__ beta,
                               TO* __restrict__ y, int8_t* __restrict__ q,
                               float* __restrict__ qscale, int N, int C,
                               float eps) {
  constexpr int NV = kWarpMaxC / 32 / V;      // vectors a lane holds at most
  const int row = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;
  const int64_t off = (int64_t)row * C;
  float x[NV][V];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (lane + 32 * j) * V;
    if (c < C) {
      rowwise::load(h + off + c, x[j]);
#pragma unroll
      for (int e = 0; e < V; ++e) s += x[j][e];
    }
  }
  const float mean = rowwise::warp_sum(s) / (float)C;
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if ((lane + 32 * j) * V < C) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        x[j][e] -= mean;
        ss += x[j][e] * x[j][e];
      }
    }
  }
  const float rstd = rsqrtf(rowwise::warp_sum(ss) / (float)C + eps);
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (lane + 32 * j) * V;
    if (c < C) {
      float g[V], b[V];
      rowwise::load(gamma + c, g);
      rowwise::load(beta + c, b);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        // xhat * gamma + beta, rounded as the TPU kernel's separate ops
        x[j][e] = __fadd_rn(__fmul_rn(__fmul_rn(x[j][e], rstd), g[e]), b[e]);
      }
      rowwise::store(y + off + c, x[j]);
      if constexpr (kCodes) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          x[j][e] = rowwise::round_to<TO>(x[j][e]);   // what y holds
          amax = fmaxf(amax, fabsf(x[j][e]));
        }
      }
    }
  }
  if constexpr (kCodes) {
    const float sc = rowwise::quant_scale(rowwise::warp_max(amax));
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (lane + 32 * j) * V;
      if (c < C) rowwise::store_codes(q + off + c, x[j], sc);
    }
    if (lane == 0) qscale[row] = sc;
  }
}

// The codes of a written y (the block kernel's rows, or rows not aligned
// for the warp kernel's vectors): one warp per row, rowwise::quantize_row.
template <typename TO>
__global__ void __launch_bounds__(kWarpRows * 32)
    layer_norm_fwd_codes_kernel(const TO* __restrict__ y,
                                int8_t* __restrict__ q,
                                float* __restrict__ qscale, int N, int C) {
  const int row = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= N) return;
  rowwise::quantize_row<TO, 1>(y + (int64_t)row * C, q + (int64_t)row * C,
                               qscale + row, C, threadIdx.x & 31);
}

// One block per row (C > kWarpMaxC, or rows not aligned for 16-byte
// vectors).
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

// Block b of G walks rows b, b + G, ...; writes dh and the block's
// dgamma/dbeta partials to partial[b, 0, :] and partial[b, 1, :].
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
  for (int r = blockIdx.x; r < N; r += gridDim.x) {
    const int64_t off = (int64_t)r * C;
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

// The raw bits of kBwdVec elements of T: one uint4 of bf16, two of f32.
template <typename T>
struct Raw {
  static constexpr int kWords = sizeof(T) / 2;
  uint4 w[kWords];
};

__device__ __forceinline__ void to_f32(const Raw<rowwise::bf16>& r,
                                       float (&v)[kBwdVec]) {
  rowwise::unpack(r.w[0], v);
}
__device__ __forceinline__ void to_f32(const Raw<float>& r,
                                       float (&v)[kBwdVec]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    v[4 * i] = __uint_as_float(r.w[i].x);
    v[4 * i + 1] = __uint_as_float(r.w[i].y);
    v[4 * i + 2] = __uint_as_float(r.w[i].z);
    v[4 * i + 3] = __uint_as_float(r.w[i].w);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The warp kernel's shared memory, in 16-byte words: two row buffers of h
// and g per warp (the next row in flight while the current one computes),
// each lane's vectors at [j][word][lane], so a lane reads back its own
// words, conflict-free. After the rows, each warp's buffers hold its
// dgamma/dbeta partials. 48 KB a block at C = 768 in bf16.
template <typename T, typename G, int NV>
struct BwdRing {
  static constexpr int kH = NV * Raw<T>::kWords * 32;   // words of h a row
  static constexpr int kRow = kH + NV * Raw<G>::kWords * 32;
  static constexpr int kWarp = 2 * kRow;
  static constexpr int kBytes = kBwdWarps * kWarp * 16;
  static_assert(kWarp >= 2 * NV * 2 * 32, "the partials fit a warp's ring");
  // two blocks an SM where a lane's row (h and g as f32) and partials take
  // at most 96 registers, else one
  static constexpr int kMinBlocks = NV * 4 * kBwdVec <= 96 ? 2 : 1;
};

// One warp per row: warp w of block b of G walks rows b * kBwdWarps + w +
// i * G * kBwdWarps in order of i; NV: vectors of kBwdVec a lane holds (C
// <= 32 * kBwdVec * NV). Writes dh and the block's dgamma/dbeta partials to
// partial[b, 0, :] and partial[b, 1, :].
template <typename T, typename G, int NV>
__global__ void __launch_bounds__(kBwdWarps * 32,
                                  (BwdRing<T, G, NV>::kMinBlocks))
    layer_norm_bwd_warp_kernel(const T* __restrict__ h,
                               const float* __restrict__ gamma,
                               const G* __restrict__ g, T* __restrict__ dh,
                               float* __restrict__ partial, int N, int C,
                               float eps) {
  using Ring = BwdRing<T, G, NV>;
  constexpr int V = kBwdVec;
  constexpr int KT = Raw<T>::kWords, KG = Raw<G>::kWords;
  extern __shared__ uint4 ring_all[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint4* ring = ring_all + warp * Ring::kWarp;
  const int first = blockIdx.x * kBwdWarps + warp;
  const int stride = gridDim.x * kBwdWarps;
  const int mine = first < N ? (N - first + stride - 1) / stride
                             : 0;           // rows this warp walks
  // the copies of the warp's k-th row into buffer k % 2
  auto fetch = [&](int k) {
    if (k < mine) {
      const int64_t off = (int64_t)(first + k * stride) * C;
      uint4* st = ring + (k & 1) * Ring::kRow;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = (lane + 32 * j) * V;
        if (c < C) {
#pragma unroll
          for (int w = 0; w < KT; ++w) {
            cp_async16(st + (j * KT + w) * 32 + lane,
                       reinterpret_cast<const uint4*>(h + off + c) + w);
          }
#pragma unroll
          for (int w = 0; w < KG; ++w) {
            cp_async16(st + Ring::kH + (j * KG + w) * 32 + lane,
                       reinterpret_cast<const uint4*>(g + off + c) + w);
          }
        }
      }
    }
    cp_async_commit();   // an empty group past the warp's rows
  };
  float pg[NV][V], pb[NV][V];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int e = 0; e < V; ++e) pg[j][e] = pb[j][e] = 0.f;
  }
  fetch(0);
  for (int k = 0; k < mine; ++k) {
    // row k + 1 into the buffer that row k - 1 left, then wait for row k:
    // every lane reads back only the words it copied itself
    fetch(k + 1);
    cp_async_wait<1>();
    const int64_t off = (int64_t)(first + k * stride) * C;
    const uint4* st = ring + (k & 1) * Ring::kRow;
    // the row as f32, once: x = h, then h - mean, then xhat; gv = g, then
    // g * gamma
    float x[NV][V], gv[NV][V];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if ((lane + 32 * j) * V < C) {
        Raw<T> hr;
        Raw<G> gr;
#pragma unroll
        for (int w = 0; w < KT; ++w) hr.w[w] = st[(j * KT + w) * 32 + lane];
#pragma unroll
        for (int w = 0; w < KG; ++w) {
          gr.w[w] = st[Ring::kH + (j * KG + w) * 32 + lane];
        }
        to_f32(hr, x[j]);
        to_f32(gr, gv[j]);
      }
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if ((lane + 32 * j) * V < C) {
#pragma unroll
        for (int e = 0; e < V; ++e) s += x[j][e];
      }
    }
    const float mean = rowwise::warp_sum(s) / (float)C;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if ((lane + 32 * j) * V < C) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          x[j][e] = __fsub_rn(x[j][e], mean);
          q += x[j][e] * x[j][e];
        }
      }
    }
    const float rstd = rsqrtf(rowwise::warp_sum(q) / (float)C + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (lane + 32 * j) * V;
      if (c < C) {
        float gam[V];
        rowwise::load(gamma + c, gam);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xhat = __fmul_rn(x[j][e], rstd);
          const float gg = __fmul_rn(gv[j][e], gam[e]);
          m1 += gg;
          m2 += __fmul_rn(gg, xhat);
          pg[j][e] += __fmul_rn(gv[j][e], xhat);
          pb[j][e] += gv[j][e];
          x[j][e] = xhat;
          gv[j][e] = gg;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      m1 += __shfl_xor_sync(0xffffffffu, m1, o);
      m2 += __shfl_xor_sync(0xffffffffu, m2, o);
    }
    m1 /= (float)C;
    m2 /= (float)C;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (lane + 32 * j) * V;
      if (c < C) {
        float d[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          d[e] = __fmul_rn(
              __fsub_rn(__fsub_rn(gv[j][e], m1), __fmul_rn(x[j][e], m2)),
              rstd);
        }
        rowwise::store(dh + off + c, d);
      }
    }
  }
  cp_async_wait<0>();
  // each warp's partials into its own ring as [p][j][half][lane] float4s;
  // then every thread sums some of those words over the warps, in warp
  // order, into the block's row of the scratch
  float4* part = reinterpret_cast<float4*>(ring);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int e = 4 * half;
      part[(j * 2 + half) * 32 + lane] =
          make_float4(pg[j][e], pg[j][e + 1], pg[j][e + 2], pg[j][e + 3]);
      part[((NV + j) * 2 + half) * 32 + lane] =
          make_float4(pb[j][e], pb[j][e + 1], pb[j][e + 2], pb[j][e + 3]);
    }
  }
  __syncthreads();
  float* out = partial + (int64_t)blockIdx.x * 2 * C;
  const float4* all = reinterpret_cast<const float4*>(ring_all);
  for (int i = threadIdx.x; i < 2 * NV * 2 * 32; i += kBwdWarps * 32) {
    const int l = i & 31, half = (i >> 5) & 1, pj = i >> 6;
    const int which = pj / NV, c = (l + 32 * (pj % NV)) * V + 4 * half;
    if (c < C) {
      float4 t = all[i];
      for (int w = 1; w < kBwdWarps; ++w) {
        const float4 u = all[w * Ring::kWarp + i];
        t = make_float4(t.x + u.x, t.y + u.y, t.z + u.z, t.w + u.w);
      }
      *reinterpret_cast<float4*>(out + which * C + c) = t;
    }
  }
}

// dgamma[c] = sum over scratch rows of partial[t, 0, c], dbeta from
// partial[t, 1, c]: a block sums 32 of the 2C columns of a scratch row with
// kSumSlices slices of threads; slice s sums rows s, s + kSumSlices, ... in
// order, then one thread per column adds the slices in order. A fixed
// order, so the sums are the same from run to run.
__global__ void __launch_bounds__(32 * kSumSlices)
    layer_norm_bwd_sum_kernel(const float* __restrict__ partial,
                              float* __restrict__ dgamma,
                              float* __restrict__ dbeta, int rows, int C) {
  __shared__ float acc[kSumSlices][32];
  const int col = blockIdx.x * 32 + threadIdx.x;   // of a row's 2C
  float s = 0.f;
  if (col < 2 * C) {
#pragma unroll 4
    for (int t = threadIdx.y; t < rows; t += kSumSlices) {
      s += partial[(int64_t)t * 2 * C + col];
    }
  }
  acc[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < 2 * C) {
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < kSumSlices; ++k) a += acc[k][threadIdx.x];
    if (col < C) {
      dgamma[col] = a;
    } else {
      dbeta[col - C] = a;
    }
  }
}

int block_threads(int C) {
  const int t = (C + kPerThread - 1) / kPerThread;
  return (t + 31) / 32 * 32;
}

template <typename T, typename TO, int V, bool kCodes>
cudaError_t launch_fwd_warp(const void* h, const void* gamma,
                            const void* beta, void* y, void* q, void* qscale,
                            int N, int C, float eps, cudaStream_t s) {
  const int blocks = (N + kWarpRows - 1) / kWarpRows;
  layer_norm_fwd_warp_kernel<T, TO, V, kCodes><<<blocks, kWarpRows * 32, 0,
                                                  s>>>(
      static_cast<const T*>(h), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<TO*>(y),
      static_cast<int8_t*>(q), static_cast<float*>(qscale), N, C, eps);
  return cudaGetLastError();
}

template <typename T, typename TO>
cudaError_t launch_fwd(const void* h, const void* gamma, const void* beta,
                       void* y, void* q, void* qscale, int N, int C,
                       float eps, cudaStream_t s) {
  // the warp kernel where a lane holds its columns and every row and
  // operand allows 16-byte vectors of h
  constexpr int V = 16 / sizeof(T);
  using rowwise::aligned;
  const bool warp = C <= kWarpMaxC && C % V == 0 && aligned(h, 16) &&
                    aligned(gamma, 16) && aligned(beta, 16) &&
                    aligned(y, 16) && (q == nullptr || aligned(q, 16));
  if (warp) {
    return q != nullptr
               ? launch_fwd_warp<T, TO, V, true>(h, gamma, beta, y, q, qscale,
                                                 N, C, eps, s)
               : launch_fwd_warp<T, TO, V, false>(h, gamma, beta, y, q,
                                                  qscale, N, C, eps, s);
  }
  layer_norm_fwd_kernel<T, TO><<<N, block_threads(C), 0, s>>>(
      static_cast<const T*>(h), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<TO*>(y), C, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || q == nullptr) return err;
  layer_norm_fwd_codes_kernel<TO>
      <<<(N + kWarpRows - 1) / kWarpRows, kWarpRows * 32, 0, s>>>(
          static_cast<const TO*>(y), static_cast<int8_t*>(q),
          static_cast<float*>(qscale), N, C);
  return cudaGetLastError();
}

template <typename T, typename G, int NV>
cudaError_t launch_bwd_warp(const void* h, const void* gamma, const void* g,
                            void* dh, void* partial, int blocks, int N,
                            int C, float eps, cudaStream_t s) {
  constexpr int smem = BwdRing<T, G, NV>::kBytes;
  if constexpr (smem > 48 * 1024) {      // past the default limit
    const cudaError_t err = cudaFuncSetAttribute(
        layer_norm_bwd_warp_kernel<T, G, NV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  layer_norm_bwd_warp_kernel<T, G, NV><<<blocks, kBwdWarps * 32, smem, s>>>(
      static_cast<const T*>(h), static_cast<const float*>(gamma),
      static_cast<const G*>(g), static_cast<T*>(dh),
      static_cast<float*>(partial), N, C, eps);
  return cudaGetLastError();
}

template <typename T, typename G>
cudaError_t launch_bwd(const void* h, const void* gamma, const void* g,
                       void* dh, void* partial, void* dgamma, void* dbeta,
                       int N, int C, float eps, cudaStream_t s) {
  // the warp kernel where a lane holds its columns and every row and
  // operand allows 16-byte vectors
  using rowwise::aligned;
  const bool warp = C <= kWarpMaxC && C % kBwdVec == 0 && aligned(h, 16) &&
                    aligned(gamma, 16) && aligned(g, 16) &&
                    aligned(dh, 16) && aligned(partial, 16);
  // the blocks, each one row of the partial scratch
  const int blocks = warp ? min((N + kBwdWarps - 1) / kBwdWarps, kBwdBlocks)
                          : min(N, kBwdBlocks);
  cudaError_t err;
  switch (warp ? (C + 32 * kBwdVec - 1) / (32 * kBwdVec) : 0) {
    case 1:
      err = launch_bwd_warp<T, G, 1>(h, gamma, g, dh, partial, blocks, N, C,
                                     eps, s);
      break;
    case 2:
      err = launch_bwd_warp<T, G, 2>(h, gamma, g, dh, partial, blocks, N, C,
                                     eps, s);
      break;
    case 3:
      err = launch_bwd_warp<T, G, 3>(h, gamma, g, dh, partial, blocks, N, C,
                                     eps, s);
      break;
    case 4:
      err = launch_bwd_warp<T, G, 4>(h, gamma, g, dh, partial, blocks, N, C,
                                     eps, s);
      break;
    default:
      layer_norm_bwd_kernel<T, G><<<blocks, block_threads(C), 0, s>>>(
          static_cast<const T*>(h), static_cast<const float*>(gamma),
          static_cast<const G*>(g), static_cast<T*>(dh),
          static_cast<float*>(partial), N, C, eps);
      err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  layer_norm_bwd_sum_kernel<<<(2 * C + 31) / 32, dim3(32, kSumSlices), 0,
                              s>>>(static_cast<const float*>(partial),
                                   static_cast<float*>(dgamma),
                                   static_cast<float*>(dbeta), blocks, C);
  return cudaGetLastError();
}

}  // namespace

// The backward's blocks at most, each one row of its f32 partial scratch:
// the wrapper reads it once, when the library loads, and gives a launch a
// [min(N, layer_norm_bwd_scratch_rows()), 2, C] scratch.
extern "C" int layer_norm_bwd_scratch_rows() { return kBwdBlocks; }

// h: [N, C] contiguous, bf16 (h_bf16 = 1) or f32, C <= 4096 (kMaxC, the
// wrapper's MAX_C); gamma, beta: f32 [C]; y: [N, C] contiguous, bf16
// (y_bf16 = 1) or f32. q: null, or int8 [N, C] for the codes of y and
// qscale f32 [N] for their row scales, at any C <= kMaxC: the warp kernel
// writes them itself (C <= 1024, rows and operands 16-byte aligned);
// otherwise layer_norm_fwd_codes_kernel writes them after the block
// kernel, in the same launch. Returns the launch's cudaError_t.
extern "C" int layer_norm_fwd(const void* h, const void* gamma,
                              const void* beta, void* y, void* q,
                              void* qscale, int N, int C, int h_bf16,
                              int y_bf16, float eps, void* stream) {
  if (N <= 0 || C <= 0 || C > kMaxC || (q != nullptr && qscale == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  cudaError_t err;
  if (h_bf16) {
    err = y_bf16 ? launch_fwd<bf, bf>(h, gamma, beta, y, q, qscale, N, C,
                                      eps, s)
                 : launch_fwd<bf, float>(h, gamma, beta, y, q, qscale, N, C,
                                         eps, s);
  } else {
    err = y_bf16 ? launch_fwd<float, bf>(h, gamma, beta, y, q, qscale, N, C,
                                         eps, s)
                 : launch_fwd<float, float>(h, gamma, beta, y, q, qscale, N,
                                            C, eps, s);
  }
  return (int)err;
}

// h, dh: [N, C] contiguous in h's type (h_bf16); g: [N, C] contiguous,
// bf16 (g_bf16 = 1) or f32; gamma: f32 [C]; partial: f32 scratch of
// min(N, layer_norm_bwd_scratch_rows()) * 2 * C; dgamma, dbeta: f32 [C]. The
// warp kernel takes C <= 1024 with C % 8 == 0 and every pointer 16-byte
// aligned, the block kernel the rest; then the column sum. Returns the
// first failed launch's cudaError_t, or cudaSuccess.
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
