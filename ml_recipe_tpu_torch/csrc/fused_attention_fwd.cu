// Fused attention forward for Hopper (sm_90a), bound to PyTorch through a
// plain C launch function loaded with ctypes
// (ml_recipe_tpu_torch/ops/flash_attention.py).
//
// Replaces the three forward kernels of the TPU package's attention
// regimes, which compute one function and differ only in how they tile it
// for VMEM:
// - ml_recipe_tpu/ops/flash_attention.py:129 `_fused_fwd_kernel` (L <= 512:
//   every serving bucket, every layer of config/test_bert.cfg);
// - ml_recipe_tpu/ops/flash_attention.py:364 `_blocked_fwd_kernel`
//   (q-blocked, K/V resident: config/long_context.cfg's 768 and 1024 rows);
// - ml_recipe_tpu/ops/flash_streaming.py:241 `_stream_fwd_kernel` (K/V
//   streamed with an online softmax: the 3072 and 4096 rows of the cfg's
//   single-chip variant), with its `base_ref` offsets, `L_hash` and
//   `seg_split` ids.
//
//   out = softmax(q k^T / sqrt(D)) v      per (batch, head), [B, L, H, D]
//
// with the TPU kernels' exact semantics where they change results:
// - disallowed scores are -1e30, never -inf, so an all-masked row averages
//   v instead of producing NaN (and pad-row garbage stays finite);
// - the allowed grid is the key mask (`kids[col] > 0`) or, segmented, the
//   block diagonal `qids[row] == kids[col] && kids[col] > 0`;
// - the softmax denominator l is summed BEFORE dropout; a kept probability
//   is scaled by 1/(1-rate), cast to v's dtype before the PV product, and
//   the divide by l is folded into the output;
// - the dropout keep-bit is `hash_uniform(x) >= rate` with
//   x = ((row_base+row)*L_hash + (col_base+col)) ^ (seed[b] + h*0x9E3779B9)
//   and the 3-stage finalizer of `hash_uniform`, all in uint32
//   (attention_common.cuh, shared with the backward so both regenerate one
//   mask); single-chip calls pass bases (0, 0) and L_hash = L;
// - optional per-row logsumexp m + log(l), [B, H, L] f32.
//
// Bound on the H100: the work is 4*B*H*L^2*D operations against
// 4*B*L*H*D bytes per element of q, k, v and out. At the serving shapes
// (32x384) the memory rate bounds it; at the training shapes (32x512,
// 32x1024, 2x4096 with D = 64) the tensor-core rate does: 1.03e11
// operations at 32x1024 and at 2x4096, ~0.10 ms at 989 TFLOP/s, against
// 201 MB (0.06 ms) and 50 MB (0.015 ms) of bf16 traffic. PERF.md has the
// measured times. What this design does about it: the [L, L] score matrix
// never leaves the chip, at any L. One block per (64-row q tile, head,
// batch) streams 32- or 64-column K/V tiles through shared memory with an
// online softmax in f32 registers (the streaming kernel's scheme, which
// the fused and blocked regimes reduce to), so device memory sees each q
// row and o row once and each K/V tile once per q tile, and no shared
// memory size depends on L. The products are plain f32 FMAs reading
// broadcast K/V values from shared memory; tensor cores (mma.sync /
// wgmma), TMA and pipelining are later work, and until then the kernel is
// far from its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using attn::Coords;
using attn::kMaskedScore;
using attn::round_to;
using attn::store;
using attn::to_float;

constexpr int kBlockM = 64;  // query rows per block, one thread per row

template <typename T, int D, int BLOCK_N>
__global__ void __launch_bounds__(kBlockM)
    fused_attention_fwd_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               Coords ids,
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
  const int32_t* qids_b = ids.qids + (int64_t)b * ids.ids_stride;
  const int32_t* kids_b = ids.kids + (int64_t)b * ids.ids_stride;

  float qf[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qf[d] = row_ok ? to_float(q[head_base + row * row_stride + d]) : 0.0f;
    acc[d] = 0.0f;
  }
  const int qseg = (segmented && row_ok) ? qids_b[row] : 0;
  const uint32_t seed_h = rate > 0.0f ? attn::dropout_key(seeds, b, h) : 0u;

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
      kmask[j] = (n0 + j < L) ? kids_b[n0 + j] : 0;
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
        s = attn::allowed(qseg, kseg, segmented) ? dot * scale : kMaskedScore;
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
        p = attn::keep_bit(ids.row_base + (uint32_t)row,
                           ids.col_base + (uint32_t)col, ids.L_hash, seed_h,
                           rate)
                ? p * keep_scale
                : 0.0f;
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
                   const Coords& ids, const void* seeds, void* out, void* lse,
                   int B, int L, int H, float scale, float rate,
                   float keep_scale, int segmented, cudaStream_t stream) {
  // K/V tiles of 64 columns at D = 32 and 32 columns above, so that K, V
  // and the score tile stay inside the 48 KB of static shared memory
  // (D = 64: 2*32*64*4 + 64*33*4 = 24.8 KB)
  constexpr int kBlockN = D <= 32 ? 64 : 32;
  const dim3 grid((L + kBlockM - 1) / kBlockM, H, B);
  fused_attention_fwd_kernel<T, D, kBlockN><<<grid, kBlockM, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ids,
      static_cast<const int32_t*>(seeds), static_cast<T*>(out),
      static_cast<float*>(lse), L, H, scale, rate, keep_scale, segmented);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const Coords& ids, const void* seeds, void* out,
                     void* lse, int B, int L, int H, float scale, float rate,
                     float keep_scale, int segmented, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, ids, seeds, out, lse, B, L, H, scale,
                           rate, keep_scale, segmented, stream);
    case 64:
      return launch<T, 64>(q, k, v, ids, seeds, out, lse, B, L, H, scale,
                           rate, keep_scale, segmented, stream);
    case 128:
      return launch<T, 128>(q, k, v, ids, seeds, out, lse, B, L, H, scale,
                            rate, keep_scale, segmented, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: [B, L, H, D] contiguous, bf16 (is_bf16 = 1) or f32.
// qids, kids: int32 ids, row b at b * ids_stride: the key mask (kids > 0)
// or, when segmented = 1, the q-side and k-side segment ids (qids == kids
// unless the caller splits them). seeds: [B] int32 per-row dropout seeds
// (read only when rate > 0); the keep-bit of (row, col) is drawn at
// (row_base + row, col_base + col) of an L_hash-long sequence.
// lse: [B, H, L] f32, or null. Returns the launch's cudaError_t.
extern "C" int fused_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* qids,
                                   const void* kids, long long ids_stride,
                                   const void* seeds, void* out, void* lse,
                                   int B, int L, int H, int D, int is_bf16,
                                   int row_base, int col_base, int L_hash,
                                   float scale, float rate, float keep_scale,
                                   int segmented, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || L_hash <= 0 || ids_stride < L) {
    return (int)cudaErrorInvalidValue;
  }
  const Coords ids{static_cast<const int32_t*>(qids),
                   static_cast<const int32_t*>(kids), (int64_t)ids_stride,
                   (uint32_t)row_base, (uint32_t)col_base, (uint32_t)L_hash};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch_d<__nv_bfloat16>(D, q, k, v, ids, seeds, out, lse, B,
                                        L, H, scale, rate, keep_scale,
                                        segmented, s)
              : launch_d<float>(D, q, k, v, ids, seeds, out, lse, B, L, H,
                                scale, rate, keep_scale, segmented, s);
  return (int)err;
}
