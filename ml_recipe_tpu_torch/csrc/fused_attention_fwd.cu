// Fused attention forward for Hopper (sm_90a), bound to PyTorch through a
// plain C launch function loaded with ctypes
// (ml_recipe_tpu_torch/ops/flash_attention.py).
//
// Replaces the TPU kernel ml_recipe_tpu/ops/flash_attention.py
// `_fused_fwd_kernel` (the L <= 512 regime that every serving bucket runs):
//
//   out = softmax(q k^T / sqrt(D)) v      per (batch, head), [B, L, H, D]
//
// with the TPU kernel's exact semantics where they change results:
// - disallowed scores are -1e30, never -inf, so an all-masked row averages
//   v instead of producing NaN (and pad-row garbage stays finite);
// - the allowed grid is the key mask (`mask[b, col] > 0`) or, segmented,
//   the block diagonal `seg[row] == seg[col] && seg[col] > 0`;
// - the softmax denominator l is summed BEFORE dropout; a kept probability
//   is scaled by 1/(1-rate), cast to v's dtype before the PV product, and
//   the divide by l is folded into the output;
// - the dropout keep-bit is `hash_uniform(x) >= rate` with
//   x = (row*L + col) ^ (seed[b] + h*0x9E3779B9) and the 3-stage
//   finalizer of `hash_uniform`, all in uint32 (wraparound is defined
//   here, unlike signed overflow);
// - optional per-row logsumexp m + log(l), [B, H, L] f32.
//
// Bound on the H100: at the serving shapes (L <= 512, D = 64) the work is
// 4*B*H*L^2*D operations against 4*B*L*H*D*2 bytes of q, k, v and out, so
// the card's memory rate bounds it (PERF.md has the numbers). What this
// design does about it: the [L, L] score matrix never leaves the chip —
// one block per (64-row q tile, head, batch) streams 32- or 64-column K/V
// tiles through shared memory with an online softmax in f32 registers, so device
// memory sees each q row and o row once and each K/V tile once per q tile.
// The products are plain f32 FMAs reading broadcast K/V values from shared
// memory; tensor cores (mma.sync / wgmma), TMA and pipelining are later
// work, and until then the kernel is far from its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;  // query rows per block, one thread per row
constexpr float kMaskedScore = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Round a probability to the input type and back, as the TPU kernel's
// `e.astype(v.dtype)` does before the PV product.
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// ml_recipe_tpu/ops/flash_attention.py `hash_uniform`, in uint32.
__device__ __forceinline__ float hash_uniform(uint32_t x) {
  x *= 0xCC9E2D51u;
  x ^= x >> 16;
  x *= 0x1B873593u;
  return (float)((x >> 7) & 0x00FFFFFFu) * (1.0f / 16777216.0f);
}

template <typename T, int D, int BLOCK_N>
__global__ void __launch_bounds__(kBlockM)
    fused_attention_fwd_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const int32_t* __restrict__ mask,
                               const int32_t* __restrict__ seeds,
                               T* __restrict__ out, float* __restrict__ lse,
                               int L, int H, float scale, float rate,
                               float keep_scale, int segmented) {
  __shared__ __align__(16) float ks[BLOCK_N][D];
  __shared__ __align__(16) float vs[BLOCK_N][D];
  __shared__ float ss[kBlockM][BLOCK_N + 1];  // +1: no bank conflicts
  __shared__ int kmask[BLOCK_N];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * kBlockM + tid;
  const bool row_ok = row < L;
  const int64_t row_stride = (int64_t)H * D;  // [B, L, H, D] contiguous
  const int64_t head_base = (int64_t)b * L * row_stride + (int64_t)h * D;
  const int32_t* mask_b = mask + (int64_t)b * L;

  float qf[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qf[d] = row_ok ? to_float(q[head_base + row * row_stride + d]) : 0.0f;
    acc[d] = 0.0f;
  }
  const int qseg = (segmented && row_ok) ? mask_b[row] : 0;
  const uint32_t seed_h =
      rate > 0.0f ? (uint32_t)seeds[b] + (uint32_t)h * 0x9E3779B9u : 0u;

  float m = -INFINITY;  // running row max (finite after the first tile)
  float l = 0.0f;       // running pre-dropout denominator

  for (int n0 = 0; n0 < L; n0 += BLOCK_N) {
    // cooperative K/V tile load: consecutive threads read consecutive d
    for (int idx = tid; idx < BLOCK_N * D; idx += kBlockM) {
      const int j = idx / D;
      const int d = idx - j * D;
      const int col = n0 + j;
      float kv = 0.0f, vv = 0.0f;
      if (col < L) {
        const int64_t off = head_base + col * row_stride + d;
        kv = to_float(k[off]);
        vv = to_float(v[off]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    for (int j = tid; j < BLOCK_N; j += kBlockM) {
      kmask[j] = (n0 + j < L) ? mask_b[n0 + j] : 0;
    }
    __syncthreads();

    // scores of this row against the tile
    float tile_max = -INFINITY;
    for (int j = 0; j < BLOCK_N; ++j) {
      const int col = n0 + j;
      float s = -INFINITY;  // past the ragged edge: no column at all
      if (col < L) {
        const float4* kr = reinterpret_cast<const float4*>(&ks[j][0]);
        float dot = 0.0f;
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 kk = kr[d4];
          dot = fmaf(qf[4 * d4 + 0], kk.x, dot);
          dot = fmaf(qf[4 * d4 + 1], kk.y, dot);
          dot = fmaf(qf[4 * d4 + 2], kk.z, dot);
          dot = fmaf(qf[4 * d4 + 3], kk.w, dot);
        }
        const int kseg = kmask[j];
        const bool allowed = segmented ? (kseg == qseg && kseg > 0) : kseg > 0;
        s = allowed ? dot * scale : kMaskedScore;
      }
      ss[tid][j] = s;
      tile_max = fmaxf(tile_max, s);
    }

    // online softmax: rescale what the earlier tiles accumulated
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);  // m = -inf on the first tile -> 0
    l *= corr;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
    m = m_new;

    for (int j = 0; j < BLOCK_N; ++j) {
      const int col = n0 + j;
      if (col >= L) break;
      float p = expf(ss[tid][j] - m);
      l += p;
      if (rate > 0.0f) {
        const uint32_t x = (uint32_t)(row * L + col) ^ seed_h;
        p = hash_uniform(x) >= rate ? p * keep_scale : 0.0f;
      }
      p = round_to(p, T(0.0f));
      const float4* vr = reinterpret_cast<const float4*>(&vs[j][0]);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
      }
    }
    __syncthreads();  // the next tile overwrites ks/vs/kmask
  }

  if (!row_ok) return;
  const float inv_l = 1.0f / l;
  T* o = out + head_base + row * row_stride;
#pragma unroll
  for (int d = 0; d < D; ++d) store(o + d, acc[d] * inv_l);
  if (lse != nullptr) {
    lse[((int64_t)b * H + h) * L + row] = m + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, const void* seeds, void* out, void* lse,
                   int B, int L, int H, float scale, float rate,
                   float keep_scale, int segmented, cudaStream_t stream) {
  // K/V tiles of 64 columns at D = 32 and 32 columns above, so that K, V
  // and the score tile stay inside the 48 KB of static shared memory
  // (D = 64: 2*32*64*4 + 64*33*4 = 24.8 KB)
  constexpr int kBlockN = D <= 32 ? 64 : 32;
  const dim3 grid((L + kBlockM - 1) / kBlockM, H, B);
  fused_attention_fwd_kernel<T, D, kBlockN><<<grid, kBlockM, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(mask),
      static_cast<const int32_t*>(seeds), static_cast<T*>(out),
      static_cast<float*>(lse), L, H, scale, rate, keep_scale, segmented);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const void* mask, const void* seeds, void* out,
                     void* lse, int B, int L, int H, float scale, float rate,
                     float keep_scale, int segmented, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, mask, seeds, out, lse, B, L, H, scale,
                           rate, keep_scale, segmented, stream);
    case 64:
      return launch<T, 64>(q, k, v, mask, seeds, out, lse, B, L, H, scale,
                           rate, keep_scale, segmented, stream);
    case 128:
      return launch<T, 128>(q, k, v, mask, seeds, out, lse, B, L, H, scale,
                            rate, keep_scale, segmented, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: [B, L, H, D] contiguous, bf16 (is_bf16 = 1) or f32.
// mask: [B, L] int32 key mask, or segment ids when segmented = 1.
// seeds: [B] int32 per-row dropout seeds (read only when rate > 0).
// lse: [B, H, L] f32, or null. Returns the launch's cudaError_t.
extern "C" int fused_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* mask,
                                   const void* seeds, void* out, void* lse,
                                   int B, int L, int H, int D, int is_bf16,
                                   float scale, float rate, float keep_scale,
                                   int segmented, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch_d<__nv_bfloat16>(D, q, k, v, mask, seeds, out, lse, B,
                                        L, H, scale, rate, keep_scale,
                                        segmented, s)
              : launch_d<float>(D, q, k, v, mask, seeds, out, lse, B, L, H,
                                scale, rate, keep_scale, segmented, s);
  return (int)err;
}
