// Int8 matrix product with its fused epilogues, and the per-row activation
// quantize, for Hopper (sm_90a), bound to PyTorch through plain C launch
// functions loaded with ctypes (ml_recipe_tpu_torch/ops/quant_matmul.py).
//
// Replaces ml_recipe_tpu/ops/quant_matmul.py:85 `_q8_matmul_kernel`:
//
//   out[m, n] = float(sum_k x[m, k] * w[n, k]) * xs[m] * ws[n]
//
// with x [M, K] int8 (per-row activation codes, scales xs f32 [M]) and w
// [N, K] int8 (per-output-channel weight codes, scales ws f32 [N]). The sum
// is exact int32 accumulation over all of K (|x|, |w| <= 127, so K * 127^2
// stays far below 2^31 at every K the repo uses). One source, two
// epilogues, picked by template:
// - f32 output, the TPU kernel's `_rescale` (:78-82): __int2float_rn, then
//   two __fmul_rn in that order (`q8_matmul`, out_kind 0);
// - the QuantLinear epilogue (quant/layers.py; the JAX package's QuantDense,
//   ml_recipe_tpu/quant/layers.py:40-52): the same two products, then
//   __fadd_rn of bias[n], rounded once to the output type (f32, or bf16 by
//   __float2bfloat16_rn): out_kind 1 and 2. The plain version is
//   (int8_matmul_plain(...) + bias).to(dtype), bit for bit. Every step is
//   an explicit _rn intrinsic, so nvcc's default FMA contraction cannot
//   fuse a product into the add.
//
// And the activation quantize (`q8_quantize_rows`), the XLA half of the JAX
// package's QuantDense that has no Pallas kernel: one warp per row reads
// bf16 or f32, takes amax(|x|) by shuffles, and writes the int8 codes and
// the f32 row scale of rowwise.cuh's grid (quantize_rowwise, bit for bit;
// rowwise::quantize_row_held). A row of at most 32 x 12 16-byte vectors
// (bf16 K <= 3072, f32 K <= 1536) is read once and held in registers
// between the amax and the codes (4 vectors a lane where they suffice); a
// longer one is read twice.
//
// Bound on the H100 (3.35 TB/s, 1979 TOP/s int8 dense): at the serving
// shapes, M = 12288 rows of a 32x384 batch and (K, N) = (768, 768),
// (768, 3072), (3072, 768), the QuantLinear epilogue with a bf16 output
// moves M*K + N*K + 2*M*N bytes (plus the scales and bias) and does
// 2*M*N*K operations: 0.0086 ms (bytes), 0.0293 ms (operations) and
// 0.0293 ms (operations), 1.12 ms over the 72 such products of a forward.
// The f32 mode's bounds are 0.0143 / 0.0486 (bytes) / 0.0293 ms. The
// quantize moves 2 bytes in and 1 out per element: 0.0085 ms at 12288 x
// 768, 0.0338 at 12288 x 3072.
//
// The design. Both operands are K-major (x [M, K], w [N, K]), the only
// operand layout `wgmma` takes for s8. Where K % 16 == 0 and both operands
// are 16-byte aligned (every projection of the repo's models) the product
// runs on `wgmma`, fed by TMA (`q8_matmul_wgmma_kernel`):
// - persistent: one block an SM walks the 128x128 output tiles (n
//   fastest) a grid apart; two consumer warpgroups own 64 rows each and a
//   producer warp feeds them, 288 threads;
// - K streams in 128-byte slices through a 4-stage ring (128 KB of dynamic
//   shared memory) that runs on across tiles. One producer thread issues
//   two TMA box loads per slice ([128 rows, 128 bytes] of x and of w,
//   128B-swizzled, zero-filled past M, N and K) that complete on the
//   slice's `full` mbarrier, after waiting on its `empty` one, so the next
//   tile's first slices load while the consumers store this one;
// - per slice each consumer warpgroup issues four
//   `wgmma.mma_async.m64n128k32.s32.s8.s8` on shared-memory descriptors
//   (the K step moves the descriptor's address inside the swizzle row),
//   commits, waits for the previous slice's group and releases that
//   slice's slot: one group in flight behind the TMA loads;
// - the epilogue rescales the 64 int32 accumulators a thread holds. A bf16
//   output of whole 16-byte rows (N % 8 == 0) is transposed across each
//   quad of lanes by shuffles, so every lane stores whole 16-byte chunks
//   and a warp's store covers 64 contiguous bytes of 8 rows, not 16 (at
//   N = 3072 the 4-byte stores cost more than the products); any other
//   output takes guarded stores of two neighbouring columns (one where N
//   is odd), so the ragged QA heads (N = 1, 2, 5) and the pooler's B rows
//   launch this kernel too.
// The tensor maps are encoded on the host at each launch with
// cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint (nothing
// links against the driver library). Any other K (a multiple of 4; the
// launch refuses the rest) takes `q8_matmul_kernel`: a block of 8 warps
// per 128x128 tile walks K in 64-byte slices through a 4-stage `cp.async`
// ring of 4-byte words (64 KB), XOR-swizzled so `ldmatrix` reads without
// bank conflicts, and each warp runs
// `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32` on its 64x32 sub-tile
// with the same epilogue.

#include <cuda.h>   // CUtensorMap and its enums; no driver library linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "rowwise.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBN = 128;   // block tile: rows of x, rows of w
constexpr int kBK = 64;               // bytes of K per stage
constexpr int kStages = 4;
constexpr int kThreads = 256;         // 8 warps: 2 (M) x 4 (N)
constexpr int kWarpsN = 4;
constexpr int kWarpM = 64, kWarpN = 32;
constexpr int kTileBytes = kBM * kBK;           // one operand, one stage
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kSmemBytes = kStages * kStageBytes;
constexpr int kQuantRows = 8;         // quantize: rows (warps) per block
// quantize: 16-byte vectors a lane holds, for rows up to 1024 bf16 (the
// context) and 3072 (the GELU output)
constexpr int kHeldShort = 4, kHeldLong = 12;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (0..3) of tile row r.
__device__ __forceinline__ int swz(int r, int c) {
  return r * kBK + ((c ^ ((r >> 1) & 3)) << 4);
}

// 4 bytes global -> shared, asynchronously; with !full nothing is read and
// the bytes are zero-filled (past the ragged edge).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage x[m0:m0+128, k0:k0+64] and w[n0:n0+128, k0:k0+64] at `stage`
// (x's tile, then w's) as 4-byte words, zeros past M, N and K.
__device__ __forceinline__ void load_stage(uint32_t stage,
                                           const int8_t* __restrict__ x,
                                           const int8_t* __restrict__ w,
                                           int m0, int n0, int k0, int M,
                                           int N, int K, int tid) {
#pragma unroll
  for (int i = 0; i < kBM * (kBK / 4) / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx >> 4, word = idx & 15;
    const int k = k0 + word * 4;
    const int off = swz(r, word >> 2) + ((word & 3) << 2);
    const bool a_ok = k < K && m0 + r < M;
    const bool b_ok = k < K && n0 + r < N;
    cp_async4(stage + off, a_ok ? x + (int64_t)(m0 + r) * K + k : x, a_ok);
    cp_async4(stage + kTileBytes + off,
              b_ok ? w + (int64_t)(n0 + r) * K + k : w, b_ok);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(bf16* p, float a) {
  *p = __float2bfloat16_rn(a);
}

// float(acc) * xs * ws (+ bias), each step rounded on its own.
template <bool kBias>
__device__ __forceinline__ float rescale(int acc, float xsm, float wsn,
                                         float bn) {
  const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), xsm), wsn);
  return kBias ? __fadd_rn(v, bn) : v;
}

template <typename OutT, bool kBias>
__global__ void __launch_bounds__(kThreads, 2)
    q8_matmul_kernel(const int8_t* __restrict__ x,
                     const float* __restrict__ xs,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ ws,
                     const float* __restrict__ bias, OutT* __restrict__ out,
                     int M, int N, int K) {
  extern __shared__ __align__(128) int8_t smem[];
  const uint32_t base = smem_u32(smem);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp / kWarpsN) * kWarpM, wn = (warp % kWarpsN) * kWarpN;

  int acc[kWarpM / 16][kWarpN / 8][4];
#pragma unroll
  for (int i = 0; i < kWarpM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kWarpN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int n_k = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) {
      load_stage(base + s * kStageBytes, x, w, m0, n0, s * kBK, M, N, K,
                 tid);
    }
    cp_async_commit();
  }

  // ldmatrix.x4: lane l gives the address of row l % 8 of matrix l / 8.
  // A (16x32 bytes): matrices (rows 0-7 | 8-15) x (bytes 0-15 | 16-31) in
  // the order a0..a3 of the m16n8k32 fragment; B (two 8-row n-tiles x 32
  // bytes): b0, b1 of n-tile 2jj, then of n-tile 2jj + 1.
  const int mat = lane >> 3, mrow = lane & 7;
  const int a_row = wm + ((mat & 1) << 3) + mrow, a_chunk = mat >> 1;
  const int b_row = wn + ((mat >> 1) << 3) + mrow, b_chunk = mat & 1;

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();  // slice kt has landed (this thread's)
    __syncthreads();               // ... everyone's; slot kt-1 is free
    const int next = kt + kStages - 1;
    if (next < n_k) {
      load_stage(base + (next % kStages) * kStageBytes, x, w, m0, n0,
                 next * kBK, M, N, K, tid);
    }
    cp_async_commit();

    const uint32_t sa = base + (kt % kStages) * kStageBytes;
    const uint32_t sb = sa + kTileBytes;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t a[kWarpM / 16][4], b[kWarpN / 8][2];
#pragma unroll
      for (int i = 0; i < kWarpM / 16; ++i) {
        ldmatrix_x4(a[i], sa + swz(a_row + i * 16, ks * 2 + a_chunk));
      }
#pragma unroll
      for (int jj = 0; jj < kWarpN / 16; ++jj) {
        uint32_t t[4];
        ldmatrix_x4(t, sb + swz(b_row + jj * 16, ks * 2 + b_chunk));
        b[2 * jj][0] = t[0];
        b[2 * jj][1] = t[1];
        b[2 * jj + 1][0] = t[2];
        b[2 * jj + 1][1] = t[3];
      }
#pragma unroll
      for (int i = 0; i < kWarpM / 16; ++i)
#pragma unroll
        for (int j = 0; j < kWarpN / 8; ++j)
          mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: accumulator c[half * 2 + e] is row grp + 8 * half, column
  // 2 * tig + e of its 16x8 tile
  const int grp = lane >> 2, tig = lane & 3;
  float wsv[kWarpN / 8][2], bv[kWarpN / 8][2];
#pragma unroll
  for (int j = 0; j < kWarpN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn + j * 8 + tig * 2 + e;
      wsv[j][e] = n < N ? ws[n] : 0.f;
      bv[j][e] = kBias && n < N ? bias[n] : 0.f;
    }
  const bool pairs = (N & 1) == 0;   // two columns, one aligned store
#pragma unroll
  for (int i = 0; i < kWarpM / 16; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + i * 16 + grp + half * 8;
      if (m >= M) continue;
      const float xsm = xs[m];
      OutT* row = out + (int64_t)m * N;
#pragma unroll
      for (int j = 0; j < kWarpN / 8; ++j) {
        const int n = n0 + wn + j * 8 + tig * 2;
        const float v0 = rescale<kBias>(acc[i][j][half * 2], xsm, wsv[j][0],
                                        bv[j][0]);
        const float v1 = rescale<kBias>(acc[i][j][half * 2 + 1], xsm,
                                        wsv[j][1], bv[j][1]);
        if (pairs) {
          if (n < N) store2(row + n, v0, v1);
        } else {
          if (n < N) store1(row + n, v0);
          if (n + 1 < N) store1(row + n + 1, v1);
        }
      }
    }
  }
}

// kHeld > 0: rows of at most 32 * kHeld 16-byte vectors, held in
// registers; else V elements a lane loads at once, the row read twice.
template <typename T, int V, int kHeld>
__global__ void __launch_bounds__(kQuantRows * 32)
    q8_quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                            float* __restrict__ scale, int M, int K) {
  const int row = blockIdx.x * kQuantRows + (threadIdx.x >> 5);
  if (row >= M) return;
  const int64_t off = (int64_t)row * K;
  if constexpr (kHeld > 0) {
    rowwise::quantize_row_held<T, kHeld>(x + off, q + off, scale + row, K,
                                         threadIdx.x & 31);
  } else {
    rowwise::quantize_row<T, V>(x + off, q + off, scale + row, K,
                                threadIdx.x & 31);
  }
}

// cudaFuncSetAttribute once per instantiation and device (the flags are
// per instantiation: its template arguments, not its pointer type, key
// them); it costs host time on every launch otherwise.
template <typename OutT, bool kBias>
cudaError_t allow_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(q8_matmul_kernel<OutT, kBias>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename OutT, bool kBias>
cudaError_t launch(const void* x, const void* xs, const void* w,
                   const void* ws, const void* bias, void* out, int M, int N,
                   int K, cudaStream_t stream) {
  auto kernel = q8_matmul_kernel<OutT, kBias>;
  cudaError_t err = allow_smem<OutT, kBias>();
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(xs),
      static_cast<const int8_t*>(w), static_cast<const float*>(ws),
      static_cast<const float*>(bias), static_cast<OutT*>(out), M, N, K);
  return cudaGetLastError();
}

cudaError_t launch_kind(int out_kind, const void* x, const void* xs,
                        const void* w, const void* ws, const void* bias,
                        void* out, int M, int N, int K, cudaStream_t s) {
  switch (out_kind) {
    case 0:
      return launch<float, false>(x, xs, w, ws, bias, out, M, N, K, s);
    case 1:
      return launch<float, true>(x, xs, w, ws, bias, out, M, N, K, s);
    case 2:
      return launch<bf16, true>(x, xs, w, ws, bias, out, M, N, K, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int V, int kHeld>
cudaError_t launch_quantize(const void* x, void* q, void* scale, int M, int K,
                            cudaStream_t s) {
  const int blocks = (M + kQuantRows - 1) / kQuantRows;
  q8_quantize_rows_kernel<T, V, kHeld><<<blocks, kQuantRows * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scale), M, K);
  return cudaGetLastError();
}


// ---- the wgmma + TMA kernel (K % 16 == 0, 16-byte aligned operands) ------

namespace wg {

constexpr int kBM = 128, kBN = 128;   // block tile
constexpr int kBK = 128;              // bytes of K per stage: one swizzle row
constexpr int kStages = 4;            // 128 KB: one block on an SM
constexpr int kConsumers = 2;         // warpgroups of 64 output rows each
constexpr int kThreads = kConsumers * 128 + 32;    // + a producer warp
constexpr int kTileBytes = kBM * kBK;              // 16 KB, one operand
constexpr int kStageBytes = 2 * kTileBytes;
// the ring, its 1024-byte alignment (128B swizzle), full and empty barriers
constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * 8;

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\n"
      "bra.uni WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One [128 rows, 128 bytes] box of a 2-D int8 tensor map into shared
// memory, 128B-swizzled, completing on `bar`; zeros past the tensor.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int k0, int row0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k0), "r"(row0)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major operand in the 128B swizzle
// (rows of 128 bytes, 8-row groups 1024 bytes apart, 1024-byte aligned
// tiles); a K step inside the row adds its byte offset to the address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[64x128] += a[64x32] . b[128x32]^T, s8 in, s32 out; a and b K-major in
// shared memory. d[j*4 + r] is row (warp % 4) * 16 + lane / 4 + 8 * (r / 2),
// column 8 * j + 2 * (lane % 4) + r % 2 of the warpgroup's 64 rows.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// One warp's 16 rows of a warpgroup's 64x128 tile: d[j*4 + r] is row m +
// 8 * (r / 2), column n + 8 * j + r % 2 (m, n: this thread's first),
// rescaled and stored with guarded stores.
template <typename OutT, bool kBias>
__device__ __forceinline__ void store_tile(const int (&d)[64],
                                           OutT* __restrict__ out,
                                           const float* __restrict__ xs,
                                           const float* __restrict__ ws,
                                           const float* __restrict__ bias,
                                           int m, int n, int M, int N,
                                           bool pairs) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row_m = m + half * 8;
    if (row_m >= M) continue;
    const float xsm = xs[row_m];
    OutT* row = out + (int64_t)row_m * N;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int c = n + j * 8;
      if (c >= N) continue;
      const bool two = c + 1 < N;
      const float v0 = rescale<kBias>(d[j * 4 + half * 2], xsm, ws[c],
                                      kBias ? bias[c] : 0.f);
      const float v1 =
          two ? rescale<kBias>(d[j * 4 + half * 2 + 1], xsm, ws[c + 1],
                               kBias ? bias[c + 1] : 0.f)
              : 0.f;
      if (pairs) {
        store2(row + c, v0, v1);
      } else {
        store1(row + c, v0);
        if (two) store1(row + c + 1, v1);
      }
    }
  }
}

// store_tile for a bf16 output whose rows are whole 16-byte chunks (N % 8
// == 0, a 16-byte aligned output): the four lanes of a quad hold 4-byte
// pieces of the same 16-byte chunks (tiles j of 8 columns), so per group of
// four tiles they transpose their pieces by shuffles and each lane stores
// one whole chunk: a warp's store covers 64 contiguous bytes of each of 8
// rows instead of 16. Same values as store_tile.
template <bool kBias>
__device__ __forceinline__ void store_tile_chunks(
    const int (&d)[64], bf16* __restrict__ out, const float* __restrict__ xs,
    const float* __restrict__ ws, const float* __restrict__ bias, int m,
    int n0, int M, int N, int lane) {
  const int tig = lane & 3, quad = lane & ~3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row_m = m + half * 8;
    const float xsm = row_m < M ? xs[row_m] : 0.f;
#pragma unroll
    for (int g = 0; g < kBN / 32; ++g) {
      uint32_t piece[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * g + k;
        const int c = n0 + j * 8 + tig * 2;
        const int cc = c < N ? c : 0;   // past N: read in bounds, not stored
        const float v0 = rescale<kBias>(d[j * 4 + half * 2], xsm, ws[cc],
                                        kBias ? bias[cc] : 0.f);
        const float v1 = rescale<kBias>(d[j * 4 + half * 2 + 1], xsm,
                                        ws[cc + 1],
                                        kBias ? bias[cc + 1] : 0.f);
        piece[k] = rowwise::pack_bf16x2(v0, v1);
      }
      // lane tig gathers tile 4g + tig's chunk: piece[tig] of every lane
      uint32_t chunk[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int src = 0; src < 4; ++src) {
          const uint32_t v = __shfl_sync(0xffffffffu, piece[k], quad | src);
          if (k == tig) chunk[src] = v;
        }
      }
      const int col = n0 + (4 * g + tig) * 8;
      if (row_m < M && col < N) {
        *reinterpret_cast<uint4*>(out + (int64_t)row_m * N + col) =
            make_uint4(chunk[0], chunk[1], chunk[2], chunk[3]);
      }
    }
  }
}

template <typename OutT, bool kBias>
__global__ void __launch_bounds__(kThreads, 1)
    q8_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                           const __grid_constant__ CUtensorMap tw,
                           const float* __restrict__ xs,
                           const float* __restrict__ ws,
                           const float* __restrict__ bias,
                           OutT* __restrict__ out, int M, int N, int K,
                           bool chunks) {
  extern __shared__ __align__(1024) int8_t smem[];
  const uint32_t tiles = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t full = tiles + kStages * kStageBytes;   // kStages x 8 B
  const uint32_t empty = full + kStages * 8;
  const int tid = threadIdx.x, group = tid >> 7;
  const int tiles_n = (N + kBN - 1) / kBN;
  const int n_tiles = tiles_n * ((M + kBM - 1) / kBM);
  const int n_k = (K + kBK - 1) / kBK;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // tiles (n fastest) go round the blocks; `it` counts the slices a block
  // has passed through its ring, across its tiles
  if (group == kConsumers) {
    // the producer warp: one thread keeps up to kStages slices in flight,
    // running into the next tile while the consumers store this one
    if (tid == kConsumers * 128) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * kBN;
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int s = it % kStages;
          mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, kStageBytes);
          const uint32_t dst = tiles + s * kStageBytes;
          tma_load(dst, &tx, kt * kBK, m0, full + 8 * s);
          tma_load(dst + kTileBytes, &tw, kt * kBK, n0, full + 8 * s);
        }
      }
    }
    return;
  }

  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int grp = lane >> 2, tig = lane & 3;
  const bool pairs = (N & 1) == 0;
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * kBN;
    int d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0;
    for (int kt = 0; kt < n_k; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      const uint32_t a = tiles + s * kStageBytes + group * 64 * kBK;
      const uint32_t b = tiles + s * kStageBytes + kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / 32; ++k) {
        wgmma_s8(d, sw128_desc(a + 32 * k), sw128_desc(b + 32 * k));
      }
      wgmma_commit();
      // the previous slice's products are done: give its slot back
      wgmma_wait<1>();
      if (kt > 0) mbar_arrive(empty + 8 * ((it - 1) % kStages));
    }
    wgmma_wait<0>();
    mbar_arrive(empty + 8 * ((it - 1) % kStages));
    const int m = m0 + group * 64 + warp * 16 + grp;
    if constexpr (std::is_same<OutT, bf16>::value) {
      if (chunks) {
        store_tile_chunks<kBias>(d, out, xs, ws, bias, m, n0, M, N, lane);
        continue;
      }
    }
    store_tile<OutT, kBias>(d, out, xs, ws, bias, m, n0 + tig * 2, M, N,
                            pairs);
  }
}

// cuTensorMapEncodeTiled from the driver the runtime loaded (no link
// against the driver library); null when there is none, and the launch
// then fails: there is no fallback to another kernel.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return (EncodeTiled) nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The [rows, K] int8 operand as [128, 128]-byte boxes, 128B-swizzled.
bool tensor_map(CUtensorMap* map, const void* base, int rows, int K) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)kBM};
  const cuuint32_t step[2] = {1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                   const_cast<void*>(base), dims, strides, box, step,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename OutT, bool kBias>
cudaError_t launch(const void* x, const void* xs, const void* w,
                   const void* ws, const void* bias, void* out, int M, int N,
                   int K, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !done[dev]) {
    err = cudaFuncSetAttribute(q8_matmul_wgmma_kernel<OutT, kBias>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) done[dev] = true;
  }
  static int sms[kMaxDevices] = {};
  if (dev >= kMaxDevices || sms[dev] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices) return cudaErrorInvalidValue;
    sms[dev] = n;
  }
  if (encoder() == nullptr) return cudaErrorNotSupported;
  CUtensorMap tx, tw;
  if (!tensor_map(&tx, x, M, K) || !tensor_map(&tw, w, N, K)) {
    return cudaErrorInvalidValue;
  }
  // persistent: one block an SM, each walking the tiles a grid apart
  const int64_t n_tiles =
      (int64_t)((N + kBN - 1) / kBN) * ((M + kBM - 1) / kBM);
  const int blocks = (int)std::min<int64_t>(n_tiles, sms[dev]);
  q8_matmul_wgmma_kernel<OutT, kBias>
      <<<blocks, kThreads, kSmemBytes, stream>>>(
      tx, tw, static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<const float*>(bias), static_cast<OutT*>(out), M, N, K,
      N % 8 == 0 && rowwise::aligned(out, 16));
  return cudaGetLastError();
}

cudaError_t launch_kind(int out_kind, const void* x, const void* xs,
                        const void* w, const void* ws, const void* bias,
                        void* out, int M, int N, int K, cudaStream_t s) {
  switch (out_kind) {
    case 0:
      return launch<float, false>(x, xs, w, ws, bias, out, M, N, K, s);
    case 1:
      return launch<float, true>(x, xs, w, ws, bias, out, M, N, K, s);
    case 2:
      return launch<bf16, true>(x, xs, w, ws, bias, out, M, N, K, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace wg

}  // namespace

// x: [M, K] int8, w: [N, K] int8, both contiguous and 4-byte aligned;
// xs: f32 [M]; ws: f32 [N]; K % 4 == 0. out_kind 0: out f32 [M, N] =
// float(acc) * xs * ws (bias unused, may be null); 1: out f32 [M, N] = that
// + bias (f32 [N]); 2: the same rounded to bf16. Returns the launch's
// cudaError_t.
extern "C" int q8_matmul(const void* x, const void* xs, const void* w,
                         const void* ws, const void* bias, void* out, int M,
                         int N, int K, int out_kind, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 != 0 ||
      (M + kBM - 1) / kBM > 65535 || out_kind < 0 || out_kind > 2 ||
      (out_kind > 0 && bias == nullptr) || !rowwise::aligned(x, 4) ||
      !rowwise::aligned(w, 4)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tma = K % 16 == 0 && rowwise::aligned(x, 16) &&
                   rowwise::aligned(w, 16);
  if (tma) {
    return (int)wg::launch_kind(out_kind, x, xs, w, ws, bias, out, M, N, K,
                                s);
  }
  return (int)launch_kind(out_kind, x, xs, w, ws, bias, out, M, N, K, s);
}

// x: [M, K] contiguous, bf16 (x_bf16 = 1) or f32; q: int8 [M, K]; scale:
// f32 [M]. Returns the launch's cudaError_t.
extern "C" int q8_quantize_rows(const void* x, void* q, void* scale, int M,
                                int K, int x_bf16, void* stream) {
  if (M <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int v = x_bf16 ? 8 : 4;   // elements in 16 bytes
  const bool vec = K % v == 0 && rowwise::aligned(x, 16) &&
                   rowwise::aligned(q, v);
  const int held = !vec                          ? 0
                   : K <= 32 * kHeldShort * v ? kHeldShort
                   : K <= 32 * kHeldLong * v  ? kHeldLong
                                              : 0;
  cudaError_t err;
  using bf = __nv_bfloat16;
  if (x_bf16) {
    err = held == kHeldShort
              ? launch_quantize<bf, 8, kHeldShort>(x, q, scale, M, K, s)
          : held == kHeldLong
              ? launch_quantize<bf, 8, kHeldLong>(x, q, scale, M, K, s)
          : vec ? launch_quantize<bf, 8, 0>(x, q, scale, M, K, s)
                : launch_quantize<bf, 1, 0>(x, q, scale, M, K, s);
  } else {
    err = held == kHeldShort
              ? launch_quantize<float, 4, kHeldShort>(x, q, scale, M, K, s)
          : held == kHeldLong
              ? launch_quantize<float, 4, kHeldLong>(x, q, scale, M, K, s)
          : vec ? launch_quantize<float, 4, 0>(x, q, scale, M, K, s)
                : launch_quantize<float, 1, 0>(x, q, scale, M, K, s);
  }
  return (int)err;
}
