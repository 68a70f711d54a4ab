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

// `_uniform_grid(seed, h, L)[row, col] >= rate`: whether the forward kept
// the probability at (row, col) of this head.
__device__ __forceinline__ bool keep_bit(int row, int col, int L,
                                         uint32_t key, float rate) {
  return hash_uniform((uint32_t)(row * L + col) ^ key) >= rate;
}

// The allowed grid: the key mask (`kseg > 0`) or, segmented, the block
// diagonal `qseg == kseg && kseg > 0`.
__device__ __forceinline__ bool allowed(int qseg, int kseg, int segmented) {
  return segmented ? (kseg == qseg && kseg > 0) : kseg > 0;
}

}  // namespace attn
