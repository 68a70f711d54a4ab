// Int8 matrix product with the fused dequant, for Hopper (sm_90a), bound to
// PyTorch through a plain C launch function loaded with ctypes
// (ml_recipe_tpu_torch/ops/quant_matmul.py).
//
// Replaces ml_recipe_tpu/ops/quant_matmul.py:85 `_q8_matmul_kernel`:
//
//   out[m, n] = float(sum_k x[m, k] * w[n, k]) * xs[m] * ws[n]
//
// with x [M, K] int8 (per-row activation codes, scales xs f32 [M]) and w
// [N, K] int8 (per-output-channel weight codes, scales ws f32 [N]), out f32
// [M, N]. The sum is exact int32 accumulation over all of K (|x|, |w| <=
// 127, so K * 127^2 stays far below 2^31 at every K the repo uses); the
// epilogue is the TPU kernel's `_rescale` (:78-82): one round-to-nearest
// int32 -> f32 conversion, then two f32 multiplies in that order, so the
// result is bit-identical to the plain version's.
//
// The weight is stored [N, K], K-contiguous (the port's QuantLinear layout;
// the weight bridge transposes the JAX package's [K, N]), so both operands
// stream along K: the `row.col` operand layout of the tensor-core int8
// product.
//
// Bound on the H100: at the serving shapes (M = 12288 rows of a 32x384
// batch, (K, N) = (768, 768), (768, 3072), (3072, 768)) the f32 output
// dominates the bytes, and 2*M*N*K operations at 1979 TOPS (int8 dense)
// take less time than those bytes at 3.35 TB/s, so device memory bounds it.
// What the design does about it: each x and w element is read from device
// memory once per 128-wide tile of the other operand, and each output once.
// A block of 8 warps owns a 128x128 output tile; per 32-deep slice of K it
// stages both operands' 128x32 byte tiles in shared memory (rows padded to
// 48 bytes so the fragment loads hit 32 distinct banks) and each warp runs
// `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32` on its 64x32 sub-tile,
// with the int32 accumulators in registers until the epilogue. Ragged M and
// N are handled by bounds checks (zero-filled loads, guarded stores), so
// every shape launches the kernel: the QA heads (N = 1, 2, 5) and the
// pooler's B rows included. K must be a multiple of 4 (the loads move
// 4-byte words); the launch refuses any other. No `cp.async`, TMA or
// `wgmma` pipelining yet: that is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 32;   // block tile, K slice
constexpr int kWarpsN = 4;                      // 2 x 4 warps
constexpr int kWarpM = 64, kWarpN = 32;         // warp tile
constexpr int kThreads = 256;
constexpr int kRowBytes = kBK + 16;             // padded shared row
constexpr int kWordsPerRow = kBK / 4;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t word(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads)
    q8_matmul_kernel(const int8_t* __restrict__ x,
                     const float* __restrict__ xs,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ ws, float* __restrict__ out,
                     int M, int N, int K) {
  __shared__ __align__(16) int8_t as[kBM * kRowBytes];
  __shared__ __align__(16) int8_t bs[kBN * kRowBytes];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp / kWarpsN) * kWarpM, wn = (warp % kWarpsN) * kWarpN;
  const int grp = lane >> 2, tig = lane & 3;   // fragment row group, column

  int acc[kWarpM / 16][kWarpN / 8][4];
#pragma unroll
  for (int i = 0; i < kWarpM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kWarpN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // stage x[m0:m0+128, k0:k0+32] and w[n0:n0+128, k0:k0+32] as 4-byte
    // words, zeros past M, N or K
#pragma unroll
    for (int i = 0; i < kBM * kWordsPerRow / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / kWordsPerRow, c = (idx % kWordsPerRow) * 4;
      const int k = k0 + c;
      uint32_t va = 0, vb = 0;
      if (k < K) {
        if (m0 + r < M) va = word(x + (int64_t)(m0 + r) * K + k);
        if (n0 + r < N) vb = word(w + (int64_t)(n0 + r) * K + k);
      }
      *reinterpret_cast<uint32_t*>(as + r * kRowBytes + c) = va;
      *reinterpret_cast<uint32_t*>(bs + r * kRowBytes + c) = vb;
    }
    __syncthreads();

    // fragments (PTX ISA, mma.m16n8k32 .s8): A row grp (+8) holds columns
    // tig*4..+3 (+16); B column grp holds rows tig*4..+3 (+16)
    uint32_t a[kWarpM / 16][4], b[kWarpN / 8][2];
#pragma unroll
    for (int i = 0; i < kWarpM / 16; ++i) {
      const int8_t* p = as + (wm + i * 16 + grp) * kRowBytes + tig * 4;
      a[i][0] = word(p);
      a[i][1] = word(p + 8 * kRowBytes);
      a[i][2] = word(p + 16);
      a[i][3] = word(p + 8 * kRowBytes + 16);
    }
#pragma unroll
    for (int j = 0; j < kWarpN / 8; ++j) {
      const int8_t* p = bs + (wn + j * 8 + grp) * kRowBytes + tig * 4;
      b[j][0] = word(p);
      b[j][1] = word(p + 16);
    }
#pragma unroll
    for (int i = 0; i < kWarpM / 16; ++i)
#pragma unroll
      for (int j = 0; j < kWarpN / 8; ++j) mma_s8(acc[i][j], a[i], b[j]);
    __syncthreads();
  }

  // the TPU kernel's _rescale: float(acc) * x_scale * w_scale, in order
#pragma unroll
  for (int i = 0; i < kWarpM / 16; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + i * 16 + grp + half * 8;
      if (m >= M) continue;
      const float xsm = xs[m];
#pragma unroll
      for (int j = 0; j < kWarpN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + tig * 2 + e;
          if (n < N) {
            const float v = __int2float_rn(acc[i][j][half * 2 + e]);
            out[(int64_t)m * N + n] = __fmul_rn(__fmul_rn(v, xsm), ws[n]);
          }
        }
      }
    }
  }
}

}  // namespace

// x: [M, K] int8, w: [N, K] int8, both contiguous and 4-byte aligned;
// xs: f32 [M]; ws: f32 [N]; out: f32 [M, N]. K % 4 == 0. Returns the
// launch's cudaError_t.
extern "C" int q8_matmul(const void* x, const void* xs, const void* w,
                         const void* ws, void* out, int M, int N, int K,
                         void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 != 0 ||
      (M + kBM - 1) / kBM > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  q8_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(xs),
      static_cast<const int8_t*>(w), static_cast<const float*>(ws),
      static_cast<float*>(out), M, N, K);
  return (int)cudaGetLastError();
}
