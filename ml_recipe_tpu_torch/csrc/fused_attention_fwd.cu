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
// measured times.
//
// What this design does about it, in bf16 (`fused_attention_fwd_tc`): the
// [L, L] score matrix never leaves the chip, at any L, and both products
// run on the tensor cores. One block of 4 warps per (64-row q tile, head,
// batch); each warp owns 16 query rows. The q tile is copied once; 64-key
// K/V tiles stream through a 2-stage ring of dynamic shared memory as bf16
// with cp.async, the next tile in flight while the current one computes.
// S = q k^T and O += bf16(P) v are mma.sync.m16n8k16 products (bf16 in,
// f32 accumulate), their shared-memory operands read with ldmatrix. The
// online softmax (mask, the -inf ragged edge, row max, exp, l, dropout)
// runs in registers on the accumulator fragments, and the rounded P is
// the A operand of the PV product straight from those registers. No
// shared memory size depends on L.
//
// Why mma.sync (with ldmatrix) for both products and not wgmma: wgmma
// reads shared-memory operands only in its canonical core-matrix layout
// (8 rows of 16 bytes a block, swizzled for the full rate) and works on
// 64-row tiles a warpgroup, so the staging, the zero fill past the ragged
// edge and the per-element mask and keep-bit would all follow that layout.
// mma.sync reads plain padded rows through ldmatrix, and each thread's
// fragment elements sit at a fixed (row, col) (attention_common.cuh), which
// keeps the masks and the dropout coordinates plain code. The price is
// rate: mma.sync reaches a fraction of the wgmma peak (PERF.md has the
// kernel against sdpa). wgmma with TMA and a producer warp is later work.
//
// The f32 instantiations (`fused_attention_fwd_kernel<float, ...>`) keep
// the first design: one thread per query row, scalar f32 FMAs against
// K/V tiles in static shared memory. Tensor cores would need TF32 there,
// which would change the function; no main path runs f32 attention.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_common.cuh"

namespace {

using attn::Coords;
using attn::kMaskedScore;
using attn::round_to;
using attn::store;
using attn::to_float;

constexpr int kBlockM = 64;  // query rows per block (f32: a thread per row)

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

namespace tc = attn::tc;
using tc::bf16;

constexpr int kWarps = 4;           // bf16: 16 query rows per warp
constexpr int kTileN = 64;          // bf16: keys per K/V stage

template <int D>
struct FwdTc {
  static constexpr int kPitch = D + 8;
  // q tile, then the 2-stage K and V rings, then the 2-stage key ids
  static constexpr int kSmemBytes =
      (kBlockM + 4 * kTileN) * kPitch * (int)sizeof(bf16) +
      2 * kTileN * (int)sizeof(int32_t);
};

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
    fused_attention_fwd_tc(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, Coords ids,
                           const int32_t* __restrict__ seeds,
                           T* __restrict__ out, float* __restrict__ lse,
                           int L, int H, float scale, float rate,
                           float keep_scale, int segmented) {
  static_assert(std::is_same<T, bf16>::value, "the tensor-core path is bf16");
  constexpr int P = FwdTc<D>::kPitch;
  constexpr int NT = kWarps * 32;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);       // [kBlockM][P]
  bf16* ks = qs + kBlockM * P;                       // [2][kTileN][P]
  bf16* vs = ks + 2 * kTileN * P;                    // [2][kTileN][P]
  int32_t* kid_s = reinterpret_cast<int32_t*>(vs + 2 * kTileN * P);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * kBlockM;
  const int64_t row_stride = (int64_t)H * D;  // [B, L, H, D] contiguous
  const int64_t head_base = (int64_t)b * L * row_stride + (int64_t)h * D;
  const int32_t* qids_b = ids.qids + (int64_t)b * ids.ids_stride;
  const int32_t* kids_b = ids.kids + (int64_t)b * ids.ids_stride;
  const bf16* kg = k + head_base;
  const bf16* vg = v + head_base;

  auto load_kv = [&](int stage, int n0) {
    tc::load_rows<kTileN, D, NT>(ks + stage * kTileN * P, kg, row_stride, n0,
                                 L, tid);
    tc::load_rows<kTileN, D, NT>(vs + stage * kTileN * P, vg, row_stride, n0,
                                 L, tid);
    tc::load_vec<kTileN, NT>(kid_s + stage * kTileN, kids_b, n0, L, tid);
    tc::cp_async_commit();
  };
  tc::load_rows<kBlockM, D, NT>(qs, q + head_base, row_stride, row0, L, tid);
  load_kv(0, 0);  // one group with the q tile

  // this thread's two query rows (accumulator rows g and g + 8)
  int rows[2], qseg[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    rows[ri] = row0 + warp * 16 + tc::frag_row(lane, 2 * ri);
    qseg[ri] = (segmented && rows[ri] < L) ? qids_b[rows[ri]] : 0;
  }
  const uint32_t seed_h = rate > 0.0f ? attn::dropout_key(seeds, b, h) : 0u;
  const uint32_t keep_thr = attn::keep_threshold(rate);

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  }
  float m[2] = {-INFINITY, -INFINITY};  // running row max
  float l[2] = {0.0f, 0.0f};  // this thread's share of the pre-dropout sum

  const int n_tiles = (L + kTileN - 1) / kTileN;
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    const int n0 = it * kTileN;
    tc::cp_async_wait_all();  // this tile (the one group in flight) is in
    __syncthreads();          // ... for all; the other stage is free
    if (it + 1 < n_tiles) load_kv(stage ^ 1, n0 + kTileN);
    const bf16* kt = ks + stage * kTileN * P;
    const bf16* vt = vs + stage * kTileN * P;
    const int32_t* kid_t = kid_s + stage * kTileN;

    float s[kTileN / 8][4];
#pragma unroll
    for (int j = 0; j < kTileN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    }
    tc::mma_rows<D, kTileN>(s, qs + warp * 16 * P, kt, lane);

    // scores: masked -1e30, past the ragged edge -inf (no column at all)
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kTileN / 8; ++j) {
      const int2 kid2 = *reinterpret_cast<const int2*>(
          kid_t + tc::frag_col(lane, j, 0));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = tc::frag_col(lane, j, e);
        float x = -INFINITY;
        if (n0 + c < L) {
          x = attn::allowed(qseg[e >> 1], (e & 1) ? kid2.y : kid2.x,
                            segmented)
                  ? s[j][e] * scale
                  : kMaskedScore;
        }
        s[j][e] = x;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
      }
    }
    // online softmax: the 4 threads of a quad share a row
    float corr[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float x = tile_max[ri];
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float m_new = fmaxf(m[ri], x);
      corr[ri] = tc::exp2_ftz((m[ri] - m_new) * tc::kLog2e);  // first tile: 0
      m[ri] = m_new;
      l[ri] *= corr[ri];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= corr[e >> 1];
    }
#pragma unroll
    for (int j = 0; j < kTileN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e >> 1;
        float p = tc::exp2_ftz((s[j][e] - m[ri]) * tc::kLog2e);  // -inf -> 0
        l[ri] += p;
        if (rate > 0.0f) {
          p = attn::keep_u24(ids.row_base + (uint32_t)rows[ri],
                             ids.col_base + (uint32_t)(n0 + tc::frag_col(
                                                                lane, j, e)),
                             ids.L_hash, seed_h, keep_thr)
                  ? p * keep_scale
                  : 0.0f;
        }
        s[j][e] = p;
      }
    }
    uint32_t pa[kTileN / 16][4];
    tc::to_a<kTileN>(pa, s);  // bf16(p): the PV product's A operand
    tc::mma_frag<kTileN, D>(o, pa, vt, lane);
  }

  float inv_l[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    l[ri] += __shfl_xor_sync(0xffffffffu, l[ri], 1);
    l[ri] += __shfl_xor_sync(0xffffffffu, l[ri], 2);
    inv_l[ri] = 1.0f / l[ri];
  }
  tc::store_frag<D>(out + head_base, row_stride, rows[0], L, o, inv_l, lane);
  if (lse != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      if (rows[ri] < L) {
        lse[((int64_t)b * H + h) * L + rows[ri]] = m[ri] + logf(l[ri]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const Coords& ids, const void* seeds, void* out, void* lse,
                   int B, int L, int H, float scale, float rate,
                   float keep_scale, int segmented, cudaStream_t stream) {
  const dim3 grid((L + kBlockM - 1) / kBlockM, H, B);
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int smem = FwdTc<D>::kSmemBytes;
    cudaError_t err = cudaFuncSetAttribute(
        fused_attention_fwd_tc<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    fused_attention_fwd_tc<T, D><<<grid, kWarps * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), ids, static_cast<const int32_t*>(seeds),
        static_cast<T*>(out), static_cast<float*>(lse), L, H, scale, rate,
        keep_scale, segmented);
  } else {
    // f32: K/V tiles of 64 columns at D = 32 and 32 columns above, so that
    // K, V and the score tile stay inside the 48 KB of static shared
    // memory (D = 64: 2*32*64*4 + 64*33*4 = 24.8 KB)
    constexpr int kBlockN = D <= 32 ? 64 : 32;
    fused_attention_fwd_kernel<T, D, kBlockN><<<grid, kBlockM, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), ids,
        static_cast<const int32_t*>(seeds), static_cast<T*>(out),
        static_cast<float*>(lse), L, H, scale, rate, keep_scale, segmented);
  }
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

// attrs[0..3]: registers, static shared memory, dynamic shared memory and
// local memory bytes of the bf16 kernel at head dim D. Returns a
// cudaError_t.
extern "C" int fused_attention_fwd_attrs(int D, int* attrs) {
  switch (D) {
    case 32:
      return attn::kernel_attrs((const void*)fused_attention_fwd_tc<bf16, 32>,
                                FwdTc<32>::kSmemBytes, attrs);
    case 64:
      return attn::kernel_attrs((const void*)fused_attention_fwd_tc<bf16, 64>,
                                FwdTc<64>::kSmemBytes, attrs);
    case 128:
      return attn::kernel_attrs(
          (const void*)fused_attention_fwd_tc<bf16, 128>,
          FwdTc<128>::kSmemBytes, attrs);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
