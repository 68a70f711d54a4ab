// Row helpers shared by layer_norm.cu (the LayerNorm forward's quantize
// epilogue) and q8_matmul.cu (the standalone row quantize): warp
// reductions, vector loads and stores of a row's elements as f32, and the
// int8 activation grid of ops/quant_matmul.py `quantize_rowwise`.
//
// The grid, bit for bit with quantize_rowwise (and the JAX package's):
//   scale = max(amax(|x|), 1e-8) / 127      (an IEEE division)
//   code  = clamp(rint(x / scale), -127, 127)
// with rint rounding half to even, as torch.round and jnp.round do (not
// roundf, which rounds half away from zero), and x / scale an IEEE
// division, never a multiply by the reciprocal.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace rowwise {

using bf16 = __nv_bfloat16;

constexpr float kInt8Max = 127.0f;
constexpr float kEps = 1e-8f;   // the amax floor: an all-zero row gets codes 0

// Butterfly reductions over a warp: every lane ends with the same value,
// combined in the same order on every run.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t u) {
  __nv_bfloat162 b;
  *reinterpret_cast<uint32_t*>(&b) = u;
  return __bfloat1622float2(b);
}

// v[0..V) = p[0..V) as f32. V is 1, or V elements span 8, 16 or 32 bytes
// from an address aligned to that size (16 at most).
template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = *p;
  } else {
    static_assert(V % 4 == 0, "f32 vectors are float4s");
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
  }
}
template <int V>
__device__ __forceinline__ void load(const bf16* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = __bfloat162float(*p);
  } else if constexpr (V == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = bf16x2_to_float2(u.x), b = bf16x2_to_float2(u.y);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    static_assert(V % 8 == 0, "bf16 vectors are 4 or 8k elements");
#pragma unroll
    for (int i = 0; i < V / 8; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = bf16x2_to_float2(w[k]);
        v[8 * i + 2 * k] = f.x;
        v[8 * i + 2 * k + 1] = f.y;
      }
    }
  }
}

// p[0..V) = v rounded once to the element type (aligned as for load).
template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = v[0];
  } else {
    static_assert(V % 4 == 0, "f32 vectors are float4s");
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    }
  }
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&b);
}
template <int V>
__device__ __forceinline__ void store(bf16* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    p[0] = __float2bfloat16_rn(v[0]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
  } else {
    static_assert(V % 8 == 0, "bf16 vectors are 4 or 8k elements");
#pragma unroll
    for (int i = 0; i < V / 8; ++i) {
      reinterpret_cast<uint4*>(p)[i] = make_uint4(
          pack_bf16x2(v[8 * i], v[8 * i + 1]),
          pack_bf16x2(v[8 * i + 2], v[8 * i + 3]),
          pack_bf16x2(v[8 * i + 4], v[8 * i + 5]),
          pack_bf16x2(v[8 * i + 6], v[8 * i + 7]));
    }
  }
}

// The value a store of x to TO keeps, as f32.
template <typename TO>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<TO, bf16>::value) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ float quant_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, kEps), kInt8Max);
}
__device__ __forceinline__ uint32_t quant_code(float x, float scale) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -kInt8Max),
                        kInt8Max);
  return static_cast<uint32_t>(__float2int_rn(r)) & 0xffu;
}

// The int8 codes of v on the row's grid `scale` into p[0..V) (p aligned
// to V bytes).
template <int V>
__device__ __forceinline__ void store_codes(int8_t* p, const float (&v)[V],
                                            float scale) {
  if constexpr (V == 1) {
    p[0] = static_cast<int8_t>(quant_code(v[0], scale));
  } else {
    static_assert(V % 4 == 0, "codes move as 4-byte words");
    uint32_t w[V / 4];
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      w[i] = quant_code(v[4 * i], scale) |
             (quant_code(v[4 * i + 1], scale) << 8) |
             (quant_code(v[4 * i + 2], scale) << 16) |
             (quant_code(v[4 * i + 3], scale) << 24);
    }
    if constexpr (V == 4) {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    } else {
#pragma unroll
      for (int i = 0; i < V / 8; ++i) {
        reinterpret_cast<uint2*>(p)[i] = make_uint2(w[2 * i], w[2 * i + 1]);
      }
    }
  }
}

// One warp quantizes a row x[0..K) into q[0..K) and *scale: amax(|x|) by
// shuffles, then the codes. The row is read twice (from L1 or L2 the
// second time). V: elements a lane loads at once (K % V == 0, x aligned to
// V elements' bytes, q to V bytes).
template <typename T, int V>
__device__ __forceinline__ void quantize_row(const T* __restrict__ x,
                                             int8_t* __restrict__ q,
                                             float* __restrict__ scale, int K,
                                             int lane) {
  float amax = 0.f;
  for (int c = lane * V; c < K; c += 32 * V) {
    float v[V];
    load(x + c, v);
#pragma unroll
    for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(v[e]));
  }
  const float s = quant_scale(warp_max(amax));
  for (int c = lane * V; c < K; c += 32 * V) {
    float v[V];
    load(x + c, v);
    store_codes(q + c, v, s);
  }
  if (lane == 0) *scale = s;
}

// v = the 16 bytes of u as f32 values: 8 bf16 or 4 f32.
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = bf16x2_to_float2(w[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}

// quantize_row for rows of at most 32 * NV 16-byte vectors (K % V == 0, x
// 16-byte aligned, q V-byte aligned): the row is read once and held in
// registers, raw, between the amax and the codes.
template <typename T, int NV>
__device__ __forceinline__ void quantize_row_held(const T* __restrict__ x,
                                                  int8_t* __restrict__ q,
                                                  float* __restrict__ scale,
                                                  int K, int lane) {
  constexpr int V = 16 / sizeof(T);
  uint4 raw[NV];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (lane + 32 * j) * V;
    if (c < K) {
      raw[j] = *reinterpret_cast<const uint4*>(x + c);
      float v[V];
      unpack(raw[j], v);
#pragma unroll
      for (int e = 0; e < V; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
  }
  const float s = quant_scale(warp_max(amax));
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (lane + 32 * j) * V;
    if (c < K) {
      float v[V];
      unpack(raw[j], v);
      store_codes(q + c, v, s);
    }
  }
  if (lane == 0) *scale = s;
}

__host__ __forceinline__ bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace rowwise
