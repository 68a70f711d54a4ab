// Device helpers shared by the fused attention kernels
// (fused_attention_fwd.cu, fused_attention_bwd.cu): type conversions, the
// rounding points the TPU kernels apply, and the dropout keep-bit. One copy,
// so the backward always regenerates exactly the forward's dropout mask.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr float kMaskedScore = -1e30f;  // never -inf: masked rows stay finite

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The f32 kernels' rounding point and store: in f32 the TPU kernels'
// `x.astype(v.dtype)` before a product is the identity. The bf16 kernels
// round in `pack_bf16` below, where they build a tensor-core operand.
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// ml_recipe_tpu/ops/flash_attention.py `hash_uniform`, in uint32
// (wraparound is defined here, unlike signed overflow): the uniform is
// hash_u24(x) / 2^24, exactly (a 24-bit integer).
__device__ __forceinline__ uint32_t hash_u24(uint32_t x) {
  x *= 0xCC9E2D51u;
  x ^= x >> 16;
  x *= 0x1B873593u;
  return (x >> 7) & 0x00FFFFFFu;
}
__device__ __forceinline__ float hash_uniform(uint32_t x) {
  return (float)hash_u24(x) * (1.0f / 16777216.0f);
}

// The per-(batch row, head) key of the dropout hash: seed[b] + h*0x9E3779B9.
__device__ __forceinline__ uint32_t dropout_key(const int32_t* seeds, int b,
                                                int h) {
  return (uint32_t)seeds[b] + (uint32_t)h * 0x9E3779B9u;
}

// Whether the forward kept the probability at ABSOLUTE (row, col) of this
// head: `_uniform_grid(seed, h, L_hash, row_offset, col_offset) >= rate`
// (ml_recipe_tpu/ops/flash_streaming.py `_keep_tile`). The flat index
// row * L_hash + col is computed in uint32, so it wraps as JAX's int32
// arithmetic does at any length and offset. Single-chip calls pass the
// tile's own row and column with L_hash = L; a call on one block of a
// longer sequence passes its offsets folded in and the full length.
__device__ __forceinline__ bool keep_bit(uint32_t row, uint32_t col,
                                         uint32_t L_hash, uint32_t key,
                                         float rate) {
  return hash_uniform((row * L_hash + col) ^ key) >= rate;
}

// keep_bit in integers, for the bf16 kernels' inner loops: n / 2^24 >=
// rate exactly when n >= ceil(rate * 2^24) (rate * 2^24 is exact in f32),
// so `keep_u24(..., keep_threshold(rate))` is the same bit without the
// integer-to-float conversion.
__host__ __device__ __forceinline__ uint32_t keep_threshold(float rate) {
  return (uint32_t)ceilf(rate * 16777216.0f);
}
__device__ __forceinline__ bool keep_u24(uint32_t row, uint32_t col,
                                         uint32_t L_hash, uint32_t key,
                                         uint32_t threshold) {
  return hash_u24((row * L_hash + col) ^ key) >= threshold;
}

// The ids and the dropout coordinates of one call, passed by value to both
// kernels. `qids`/`kids` point at row 0 of the q-side and k-side ids, each
// row `ids_stride` ints apart: the [B, L] key mask (or segment ids) gives
// qids == kids and ids_stride = L; `seg_split` ids, one [B, 2L] plane with
// the q ids first, give kids = qids + L and ids_stride = 2L. Row `row` and
// column `col` of the call draw the keep-bit at absolute
// (row_base + row, col_base + col) of an L_hash-long sequence.
struct Coords {
  const int32_t* qids;
  const int32_t* kids;
  int64_t ids_stride;
  uint32_t row_base;
  uint32_t col_base;
  uint32_t L_hash;
};

// The allowed grid: the key mask (`kseg > 0`) or, segmented, the block
// diagonal `qseg == kseg && kseg > 0`. The q-side and k-side ids come from
// two rows of ids (the same row unless the caller splits them, as
// `_stream_mask_tile`'s `seg_split` does).
__device__ __forceinline__ bool allowed(int qseg, int kseg, int segmented) {
  return segmented ? (kseg == qseg && kseg > 0) : kseg > 0;
}

// ---- tensor-core building blocks of the bf16 kernels -------------------
//
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) on fragments held by one
// warp. With g = lane / 4 and t = lane % 4, a thread holds:
// - of the 16x16 A operand, a[0] = A[g][2t..2t+1], a[1] = A[g+8][2t..],
//   a[2] = A[g][2t+8..], a[3] = A[g+8][2t+8..] (two bf16 each, the lower
//   column in the low half);
// - of the 16x8 B operand (k by n), b[0] = B[2t..2t+1][g], b[1] =
//   B[2t+8..2t+9][g];
// - of the 16x8 f32 accumulator, c[0..1] = C[g][2t..2t+1] and c[2..3] =
//   C[g+8][2t..2t+1].
// So the accumulator of two neighbouring 8-column tiles, rounded to bf16,
// is the A operand of the next product, with no trip through shared memory
// (`to_a`), and the (row, col) a thread draws the dropout keep-bit at is
// the accumulator element's (`frag_row`, `frag_col`).
//
// Tiles sit in shared memory as rows of D bf16 padded to D + 8, so the 8
// rows one ldmatrix phase reads start 16 bytes apart in the banks: no
// conflicts at D = 32, 64 or 128.

namespace tc {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the special-function unit, a denormal result flushed to 0 (a
// probability below 2^-126 adds nothing any f32 or bf16 sum here keeps);
// -inf gives 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ int frag_row(int lane, int e) {
  return (lane >> 2) + ((e >> 1) << 3);
}
__device__ __forceinline__ int frag_col(int lane, int j, int e) {
  return j * 8 + 2 * (lane & 3) + (e & 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; with !full nothing is read
// and the 16 bytes are zero-filled (a row past the ragged edge).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [row0, row0 + R) of a [.., row_stride] bf16 operand (D columns from
// `src`) into `dst` with row pitch D + 8, zero past row L. Issued by all
// NT threads, 16 bytes each; the caller commits the group.
template <int R, int D, int NT>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int64_t row_stride, int row0,
                                          int L, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int c = tid; c < R * kChunks; c += NT) {
    const int r = c / kChunks;
    const int ch = c - r * kChunks;
    const bool ok = row0 + r < L;
    const bf16* s = src + (ok ? (int64_t)(row0 + r) * row_stride : 0) + ch * 8;
    cp_async16(dst + r * (D + 8) + ch * 8, s, ok);
  }
}

// R 32-bit values src[row0 + i] into dst[i], zero past L.
template <int R, int NT>
__device__ __forceinline__ void load_vec(void* dst, const void* src,
                                         int row0, int L, int tid) {
  for (int i = tid; i < R; i += NT) {
    const bool ok = row0 + i < L;
    cp_async4(static_cast<uint32_t*>(dst) + i,
              static_cast<const uint32_t*>(src) + (ok ? row0 + i : 0), ok);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 (round to nearest even, the TPU kernels'
// `astype`), the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc[16 x N] += A[16 x K] B[N x K]^T, both operands rows of K bf16 in
// shared memory (pitch K + 8): A's 16 rows at `a`, B's N rows at `b`.
// This is every "rows times rows" product: q k^T, k q^T, g v^T, v g^T.
template <int K, int N>
__device__ __forceinline__ void mma_rows(float (&acc)[N / 8][4], const bf16* a,
                                         const bf16* b, int lane) {
  constexpr int P = K + 8;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, a + (lane & 15) * P + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int nn = 0; nn < N / 16; ++nn) {
      uint32_t bfr[4];
      ldmatrix_x4(bfr, b + (nn * 16 + (lane & 7) + ((lane >> 4) << 3)) * P +
                           kk * 16 + ((lane >> 3) & 1) * 8);
      mma(acc[2 * nn], af, bfr[0], bfr[1]);
      mma(acc[2 * nn + 1], af, bfr[2], bfr[3]);
    }
  }
}

// acc[16 x N] += A[16 x K] B[K x N], A in registers (`to_a`), B's K rows of
// N bf16 in shared memory (pitch N + 8) read transposed by ldmatrix.
// This is every "probabilities times rows" product: p v, p^T g, ds^T q,
// ds k.
template <int K, int N>
__device__ __forceinline__ void mma_frag(float (&acc)[N / 8][4],
                                         const uint32_t (&a)[K / 16][4],
                                         const bf16* b, int lane) {
  constexpr int P = N + 8;
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc) {
#pragma unroll
    for (int dn = 0; dn < N / 16; ++dn) {
      uint32_t bfr[4];
      ldmatrix_x4_trans(bfr, b + (kc * 16 + (lane & 7) +
                                  ((lane >> 3) & 1) * 8) * P +
                                 dn * 16 + (lane >> 4) * 8);
      mma(acc[2 * dn], a[kc], bfr[0], bfr[1]);
      mma(acc[2 * dn + 1], a[kc], bfr[2], bfr[3]);
    }
  }
}

// The accumulator of a [16 x N] product, rounded to bf16, as the A
// operand of a product over those N columns.
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4],
                                     const float (&c)[N / 8][4]) {
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc) {
    a[kc][0] = pack_bf16(c[2 * kc][0], c[2 * kc][1]);
    a[kc][1] = pack_bf16(c[2 * kc][2], c[2 * kc][3]);
    a[kc][2] = pack_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
    a[kc][3] = pack_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
  }
}

// Rows r_lo and r_lo + 8 of a [16 x N] accumulator, each times its mul,
// as bf16 into rows of `base` (row_stride apart); rows past L are skipped.
template <int N>
__device__ __forceinline__ void store_frag(bf16* base, int64_t row_stride,
                                           int r_lo, int L,
                                           const float (&c)[N / 8][4],
                                           const float (&mul)[2], int lane) {
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int r = r_lo + 8 * ri;
    if (r >= L) continue;
    bf16* p = base + (int64_t)r * row_stride + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(p + j * 8) = __floats2bfloat162_rn(
          c[j][2 * ri] * mul[ri], c[j][2 * ri + 1] * mul[ri]);
    }
  }
}

}  // namespace tc

// Registers, static shared memory, dynamic shared memory (as launched) and
// local memory (stack and spills) of one kernel, into attrs[0..3].
inline int kernel_attrs(const void* kernel, int dynamic_smem, int* attrs) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  attrs[0] = a.numRegs;
  attrs[1] = (int)a.sharedSizeBytes;
  attrs[2] = dynamic_smem;
  attrs[3] = (int)a.localSizeBytes;
  return 0;
}

}  // namespace attn
