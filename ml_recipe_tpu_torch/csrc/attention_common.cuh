// Device helpers shared by the fused attention kernels
// (fused_attention_fwd.cu, fused_attention_bwd.cu): type conversions, the
// rounding points the TPU kernels apply, and the dropout keep-bit. One copy,
// so the backward always regenerates exactly the forward's dropout mask.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace attn {

constexpr float kMaskedScore = -1e30f;  // never -inf: masked rows stay finite

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Round a value to the input type and back, as the TPU kernels'
// `x.astype(v.dtype)` does before a product.
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// ml_recipe_tpu/ops/flash_attention.py `hash_uniform`, in uint32
// (wraparound is defined here, unlike signed overflow).
__device__ __forceinline__ float hash_uniform(uint32_t x) {
  x *= 0xCC9E2D51u;
  x ^= x >> 16;
  x *= 0x1B873593u;
  return (float)((x >> 7) & 0x00FFFFFFu) * (1.0f / 16777216.0f);
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

}  // namespace attn
