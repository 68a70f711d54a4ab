// Fused attention backward for Hopper (sm_90a), bound to PyTorch through a
// plain C launch function loaded with ctypes
// (ml_recipe_tpu_torch/ops/flash_attention.py).
//
// Replaces the four backward kernels of the TPU package's attention
// regimes, which compute one function:
// - ml_recipe_tpu/ops/flash_attention.py:266 `_fused_bwd_kernel` (L <= 512,
//   math `_attention_bwd_math`: every layer of config/test_bert.cfg);
// - ml_recipe_tpu/ops/flash_attention.py:305 `_blocked_bwd_kernel` (dq per
//   q-block, dk/dv accumulated over the q sweep: config/long_context.cfg's
//   768 and 1024 rows);
// - ml_recipe_tpu/ops/flash_streaming.py:374 `_stream_dkv_kernel` (dk/dv, q
//   innermost) by kernel A below, and flash_streaming.py:339
//   `_stream_dq_kernel` (dq, k innermost) by kernel B: the 3072 and 4096
//   rows of the cfg's single-chip variant, with `base_ref` offsets,
//   `L_hash` and `seg_split` ids.
//
// Per (batch, head), with the forward's saved output `out` and per-row
// logsumexp `lse`:
//
//   p    = exp(s - lse),  s = q k^T / sqrt(D) (masked scores -1e30)
//          segmented only: p = 0 where the grid forbids (all-masked pad rows
//          have lse = -1e30 and exp(s - lse) would degenerate to 1); the
//          key-mask mode keeps the TPU kernel's unzeroed values
//   pd   = keep ? p / (1 - rate) : 0        (the forward's dropout mask, at
//          the same absolute coordinates: attention_common.cuh `keep_bit`)
//   dv   = bf16(pd)^T g
//   dp   = keep ? (g v^T) / (1 - rate) : 0
//   row  = sum_d g * out                    (the delta identity, f32)
//   ds   = p * (dp - row)
//   dq   = (bf16(ds) k) * scale,  dk = (bf16(ds)^T q) * scale
//
// (bf16(...) rounds to the input type, as the TPU kernel's `astype` does;
// the scale multiplies the f32 product, after it.)
//
// Bound on the H100: the work is 5 products of 2*B*H*L^2*D operations each
// (s, dv, dp, dq, dk): 6.4e10 at 32x512x12x64 (~0.065 ms at 989 TFLOP/s)
// and 2.6e11 at 32x1024 and at 2x4096 (~0.26 ms). The traffic is q, k, v,
// g, out read once and dq, dk, dv written once: ~201 MB in bf16 at 32x512
// (~0.060 ms at 3.35 TB/s), ~403 MB at 32x1024, ~101 MB at 2x4096. So the
// tensor-core rate bounds it at every training shape, the memory rate
// nearly as much at 32x512.
//
// What this design does about it: the FlashAttention-2 split that the
// streaming TPU kernels use, deterministic, and no shared memory size
// depends on L. Every output element has exactly one writer, so there are
// no atomics and two launches on the same inputs give the same bits:
// - a pre-pass computes the row term `row` once per (b, h, query row);
// - kernel A (dk/dv), one block per (64-key tile, head, batch), walks every
//   query row;
// - kernel B (dq), one block per (64-row query tile, head, batch), walks
//   every key.
// That recomputes s and dp in both kernels: 7 products instead of 5
// (~9.0e10 operations at 32x512, ~0.09 ms at 989 TFLOP/s), the price of
// no atomics.
//
// bf16 (`fused_attention_bwd_dkdv_tc`, `fused_attention_bwd_dq_tc`): 4
// warps a block, each owning 16 keys (A) or 16 query rows (B). A block
// keeps its own 64 rows of k and v (A) or q and g (B) in shared memory and
// streams the other side through a 2-stage ring of dynamic shared memory
// with cp.async, the next stage in flight while the current one computes:
// A streams q, g, lse, the row term and the q-side ids; B streams k, v and
// the k-side ids. All seven products are mma.sync.m16n8k16 (bf16 in, f32
// accumulate; fused_attention_fwd.cu says why not wgmma): kernel A computes
// s^T = k q^T and dp^T = v g^T, so that bf16(p_drop)^T and bf16(ds)^T come
// out of the accumulators already as the A operands of dv += p_drop^T g
// and dk += ds^T q, and kernel B computes s, dp and dq += bf16(ds) k the
// same way; no probability goes through shared memory. dk, dv and dq stay
// in f32 registers; the scale multiplies them at the store. Kernel A
// streams 32 query rows a stage (16 at D = 128) and kernel B 64 keys (32
// at D = 128), so that each thread's accumulators stay in registers (a
// spilling backward ran 17x slower) and, at D <= 64, 3 blocks of A fit an
// SM.
//
// The f32 instantiations keep the first design: a key or row owned by D/32
// lanes, 32 columns each, partial dot products summed with warp shuffles,
// scalar f32 FMAs against tiles staged in shared memory (tensor cores would
// need TF32, which would change the function).

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

constexpr int kKeysPerBlock = 64;   // kernel A: keys per block
constexpr int kRowsPerStage = 32;   // kernel A: query rows staged per pass
constexpr int kRowsPerBlock = 64;   // kernel B: query rows per block
constexpr int kKeysPerStage = 32;   // kernel B: keys staged per pass

// Each key (kernel A) or query row (kernel B) is owned by D/32 consecutive
// lanes, each holding 32 of the D columns of its f32 accumulators, so a
// thread keeps 2*32 accumulators at any D (one lane owning all 2*D of them
// put them in local memory at D = 64). The lanes sum their partial dot
// products with warp shuffles.
constexpr int kChunk = 32;          // columns per lane
constexpr int kChunkStride = 36;    // staged chunk: 32 floats + 4 pad, so
                                    // the 8 lanes of a float4 phase that
                                    // read 8 different chunks hit 8
                                    // different bank quads

template <int D>
struct Lanes {
  static constexpr int kPerRow = D / kChunk;            // lanes per row
  static constexpr int kRowStride = kPerRow * kChunkStride;
};

// Column d of a staged row starts at chunk (d / 32), offset (d % 32).
__device__ __forceinline__ int staged(int d) {
  return (d / kChunk) * kChunkStride + (d % kChunk);
}

// Sum a lane's partial over the kPerRow lanes that share its row.
template <int kPerRow>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < kPerRow; off <<= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// row[b, h, i] = sum_d g[b, i, h, d] * out[b, i, h, d] in f32; one warp per
// (b, i, h) row of the [B, L, H, D] layout, written to [B, H, L].
template <typename T, int D>
__global__ void fused_attention_bwd_row_term(const T* __restrict__ g,
                                             const T* __restrict__ out,
                                             float* __restrict__ delta,
                                             int L, int H, int64_t n_rows) {
  const int64_t r = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (r >= n_rows) return;
  const int64_t base = r * D;
  float acc = 0.0f;
#pragma unroll
  for (int d = lane; d < D; d += 32) {
    acc = fmaf(to_float(g[base + d]), to_float(out[base + d]), acc);
  }
  acc = row_sum<32>(acc);
  if (lane == 0) {
    const int h = (int)(r % H);
    const int64_t bi = r / H;  // b * L + i
    const int i = (int)(bi % L);
    const int64_t b = bi / L;
    delta[(b * H + h) * L + i] = acc;
  }
}

// Kernel A: dk and dv of one 64-key tile of one (batch, head).
template <typename T, int D>
__global__ void __launch_bounds__(kKeysPerBlock * Lanes<D>::kPerRow)
    fused_attention_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ g,
                             Coords ids, const int32_t* __restrict__ seeds,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             T* __restrict__ dk, T* __restrict__ dv, int L,
                             int H, float scale, float rate, float keep_scale,
                             int segmented) {
  constexpr int P = Lanes<D>::kPerRow;
  constexpr int RS = Lanes<D>::kRowStride;
  constexpr int NT = kKeysPerBlock * P;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                          // [kKeysPerBlock][RS]
  float* vs = ks + kKeysPerBlock * RS;       // [kKeysPerBlock][RS]
  float* qs = vs + kKeysPerBlock * RS;       // [kRowsPerStage][RS]
  float* gs = qs + kRowsPerStage * RS;       // [kRowsPerStage][RS]
  float* lse_s = gs + kRowsPerStage * RS;    // [kRowsPerStage]
  float* row_s = lse_s + kRowsPerStage;      // [kRowsPerStage]
  int* qseg_s = reinterpret_cast<int*>(row_s + kRowsPerStage);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int j = tid / P;                     // this lane's key in the tile
  const int part = tid % P;                  // ... and its column chunk
  const int col0 = blockIdx.x * kKeysPerBlock;
  const int col = col0 + j;
  const bool col_ok = col < L;
  const int64_t row_stride = (int64_t)H * D;  // [B, L, H, D] contiguous
  const int64_t head_base = (int64_t)b * L * row_stride + (int64_t)h * D;
  const int32_t* qids_b = ids.qids + (int64_t)b * ids.ids_stride;
  const int32_t* kids_b = ids.kids + (int64_t)b * ids.ids_stride;
  const float* lse_bh = lse + ((int64_t)b * H + h) * L;
  const float* delta_bh = delta + ((int64_t)b * H + h) * L;

  for (int idx = tid; idx < kKeysPerBlock * D; idx += NT) {
    const int jj = idx / D;
    const int d = idx - jj * D;
    const int c = col0 + jj;
    float kv = 0.0f, vv = 0.0f;
    if (c < L) {
      const int64_t off = head_base + c * row_stride + d;
      kv = to_float(k[off]);
      vv = to_float(v[off]);
    }
    ks[jj * RS + staged(d)] = kv;
    vs[jj * RS + staged(d)] = vv;
  }
  // keys past the ragged edge compute on zeros (the shuffles need every
  // lane) and store nothing; kseg 0 keeps their scores masked
  const int kseg = col_ok ? kids_b[col] : 0;
  const uint32_t key = rate > 0.0f ? attn::dropout_key(seeds, b, h) : 0u;

  float dk_acc[kChunk];
  float dv_acc[kChunk];
#pragma unroll
  for (int d = 0; d < kChunk; ++d) {
    dk_acc[d] = 0.0f;
    dv_acc[d] = 0.0f;
  }
  const float4* kr = reinterpret_cast<const float4*>(
      &ks[j * RS + part * kChunkStride]);
  const float4* vr = reinterpret_cast<const float4*>(
      &vs[j * RS + part * kChunkStride]);

  for (int m0 = 0; m0 < L; m0 += kRowsPerStage) {
    __syncthreads();  // the K/V tile is in; the last stage's rows are read
    for (int idx = tid; idx < kRowsPerStage * D; idx += NT) {
      const int i = idx / D;
      const int d = idx - i * D;
      const int r = m0 + i;
      float qv = 0.0f, gv = 0.0f;
      if (r < L) {
        const int64_t off = head_base + r * row_stride + d;
        qv = to_float(q[off]);
        gv = to_float(g[off]);
      }
      qs[i * RS + staged(d)] = qv;
      gs[i * RS + staged(d)] = gv;
    }
    for (int i = tid; i < kRowsPerStage; i += NT) {
      const int r = m0 + i;
      lse_s[i] = r < L ? lse_bh[r] : 0.0f;
      row_s[i] = r < L ? delta_bh[r] : 0.0f;
      qseg_s[i] = (segmented && r < L) ? qids_b[r] : 0;
    }
    __syncthreads();

    const int rows = min(kRowsPerStage, L - m0);
    for (int i = 0; i < rows; ++i) {
      const float4* qi = reinterpret_cast<const float4*>(
          &qs[i * RS + part * kChunkStride]);
      const float4* gi = reinterpret_cast<const float4*>(
          &gs[i * RS + part * kChunkStride]);
      float s_dot = 0.0f, dp_dot = 0.0f;
#pragma unroll
      for (int d4 = 0; d4 < kChunk / 4; ++d4) {
        const float4 qq = qi[d4], kk = kr[d4], gg = gi[d4], vv = vr[d4];
        s_dot = fmaf(qq.x, kk.x, s_dot);
        s_dot = fmaf(qq.y, kk.y, s_dot);
        s_dot = fmaf(qq.z, kk.z, s_dot);
        s_dot = fmaf(qq.w, kk.w, s_dot);
        dp_dot = fmaf(gg.x, vv.x, dp_dot);
        dp_dot = fmaf(gg.y, vv.y, dp_dot);
        dp_dot = fmaf(gg.z, vv.z, dp_dot);
        dp_dot = fmaf(gg.w, vv.w, dp_dot);
      }
      s_dot = row_sum<P>(s_dot);
      dp_dot = row_sum<P>(dp_dot);
      const bool ok = attn::allowed(qseg_s[i], kseg, segmented);
      const float s = ok ? s_dot * scale : kMaskedScore;
      float p = expf(s - lse_s[i]);
      if (segmented && !ok) p = 0.0f;
      bool keep = true;
      if (rate > 0.0f) {
        keep = attn::keep_bit(ids.row_base + (uint32_t)(m0 + i),
                              ids.col_base + (uint32_t)col, ids.L_hash, key,
                              rate);
      }
      const float pd = keep ? p * keep_scale : 0.0f;
      const float dp = keep ? dp_dot * keep_scale : 0.0f;
      const float ds = p * (dp - row_s[i]);
      const float pr = round_to(pd, T(0.0f));
      const float dsr = round_to(ds, T(0.0f));
#pragma unroll
      for (int d4 = 0; d4 < kChunk / 4; ++d4) {
        const float4 qq = qi[d4], gg = gi[d4];
        dv_acc[4 * d4 + 0] = fmaf(pr, gg.x, dv_acc[4 * d4 + 0]);
        dv_acc[4 * d4 + 1] = fmaf(pr, gg.y, dv_acc[4 * d4 + 1]);
        dv_acc[4 * d4 + 2] = fmaf(pr, gg.z, dv_acc[4 * d4 + 2]);
        dv_acc[4 * d4 + 3] = fmaf(pr, gg.w, dv_acc[4 * d4 + 3]);
        dk_acc[4 * d4 + 0] = fmaf(dsr, qq.x, dk_acc[4 * d4 + 0]);
        dk_acc[4 * d4 + 1] = fmaf(dsr, qq.y, dk_acc[4 * d4 + 1]);
        dk_acc[4 * d4 + 2] = fmaf(dsr, qq.z, dk_acc[4 * d4 + 2]);
        dk_acc[4 * d4 + 3] = fmaf(dsr, qq.w, dk_acc[4 * d4 + 3]);
      }
    }
  }

  if (!col_ok) return;
  const int64_t off = head_base + col * row_stride + part * kChunk;
#pragma unroll
  for (int d = 0; d < kChunk; ++d) {
    store(dk + off + d, dk_acc[d] * scale);
    store(dv + off + d, dv_acc[d]);
  }
}

// Kernel B: dq of one 64-row query tile of one (batch, head).
template <typename T, int D>
__global__ void __launch_bounds__(kRowsPerBlock * Lanes<D>::kPerRow)
    fused_attention_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ g,
                           Coords ids, const int32_t* __restrict__ seeds,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dq, int L, int H, float scale,
                           float rate, float keep_scale, int segmented) {
  constexpr int P = Lanes<D>::kPerRow;
  constexpr int RS = Lanes<D>::kRowStride;
  constexpr int NT = kRowsPerBlock * P;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                          // [kKeysPerStage][RS]
  float* vs = ks + kKeysPerStage * RS;       // [kKeysPerStage][RS]
  float* gs = vs + kKeysPerStage * RS;       // [kRowsPerBlock][RS]
  int* kmask = reinterpret_cast<int*>(gs + kRowsPerBlock * RS);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int i = tid / P;                     // this lane's row in the tile
  const int part = tid % P;                  // ... and its column chunk
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int row = row0 + i;
  const bool row_ok = row < L;
  const int64_t row_stride = (int64_t)H * D;
  const int64_t head_base = (int64_t)b * L * row_stride + (int64_t)h * D;
  const int32_t* qids_b = ids.qids + (int64_t)b * ids.ids_stride;
  const int32_t* kids_b = ids.kids + (int64_t)b * ids.ids_stride;

  for (int idx = tid; idx < kRowsPerBlock * D; idx += NT) {
    const int ii = idx / D;
    const int d = idx - ii * D;
    const int r = row0 + ii;
    gs[ii * RS + staged(d)] =
        r < L ? to_float(g[head_base + r * row_stride + d]) : 0.0f;
  }
  // rows past the ragged edge compute on zeros (the shuffles need every
  // lane) and store nothing
  float qf[kChunk];
  float acc[kChunk];
  const int64_t qoff = head_base + row * row_stride + part * kChunk;
#pragma unroll
  for (int d = 0; d < kChunk; ++d) {
    qf[d] = row_ok ? to_float(q[qoff + d]) : 0.0f;
    acc[d] = 0.0f;
  }
  const int64_t bhr = ((int64_t)b * H + h) * L + row;
  const float lse_r = row_ok ? lse[bhr] : 0.0f;
  const float row_term = row_ok ? delta[bhr] : 0.0f;
  const int qseg = (segmented && row_ok) ? qids_b[row] : 0;
  const uint32_t key = rate > 0.0f ? attn::dropout_key(seeds, b, h) : 0u;
  const float4* gr = reinterpret_cast<const float4*>(
      &gs[i * RS + part * kChunkStride]);

  for (int n0 = 0; n0 < L; n0 += kKeysPerStage) {
    __syncthreads();  // g is staged; the last stage's keys are read
    for (int idx = tid; idx < kKeysPerStage * D; idx += NT) {
      const int jj = idx / D;
      const int d = idx - jj * D;
      const int c = n0 + jj;
      float kv = 0.0f, vv = 0.0f;
      if (c < L) {
        const int64_t off = head_base + c * row_stride + d;
        kv = to_float(k[off]);
        vv = to_float(v[off]);
      }
      ks[jj * RS + staged(d)] = kv;
      vs[jj * RS + staged(d)] = vv;
    }
    for (int jj = tid; jj < kKeysPerStage; jj += NT) {
      kmask[jj] = (n0 + jj < L) ? kids_b[n0 + jj] : 0;
    }
    __syncthreads();

    const int cols = min(kKeysPerStage, L - n0);
    for (int jj = 0; jj < cols; ++jj) {
      const float4* kj = reinterpret_cast<const float4*>(
          &ks[jj * RS + part * kChunkStride]);
      const float4* vj = reinterpret_cast<const float4*>(
          &vs[jj * RS + part * kChunkStride]);
      float s_dot = 0.0f, dp_dot = 0.0f;
#pragma unroll
      for (int d4 = 0; d4 < kChunk / 4; ++d4) {
        const float4 kk = kj[d4], vv = vj[d4], gg = gr[d4];
        s_dot = fmaf(qf[4 * d4 + 0], kk.x, s_dot);
        s_dot = fmaf(qf[4 * d4 + 1], kk.y, s_dot);
        s_dot = fmaf(qf[4 * d4 + 2], kk.z, s_dot);
        s_dot = fmaf(qf[4 * d4 + 3], kk.w, s_dot);
        dp_dot = fmaf(gg.x, vv.x, dp_dot);
        dp_dot = fmaf(gg.y, vv.y, dp_dot);
        dp_dot = fmaf(gg.z, vv.z, dp_dot);
        dp_dot = fmaf(gg.w, vv.w, dp_dot);
      }
      s_dot = row_sum<P>(s_dot);
      dp_dot = row_sum<P>(dp_dot);
      const int col = n0 + jj;
      const bool ok = attn::allowed(qseg, kmask[jj], segmented);
      const float s = ok ? s_dot * scale : kMaskedScore;
      float p = expf(s - lse_r);
      if (segmented && !ok) p = 0.0f;
      bool keep = true;
      if (rate > 0.0f) {
        keep = attn::keep_bit(ids.row_base + (uint32_t)row,
                              ids.col_base + (uint32_t)col, ids.L_hash, key,
                              rate);
      }
      const float dp = keep ? dp_dot * keep_scale : 0.0f;
      const float dsr = round_to(p * (dp - row_term), T(0.0f));
#pragma unroll
      for (int d4 = 0; d4 < kChunk / 4; ++d4) {
        const float4 kk = kj[d4];
        acc[4 * d4 + 0] = fmaf(dsr, kk.x, acc[4 * d4 + 0]);
        acc[4 * d4 + 1] = fmaf(dsr, kk.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(dsr, kk.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(dsr, kk.w, acc[4 * d4 + 3]);
      }
    }
  }

  if (!row_ok) return;
  T* o = dq + qoff;
#pragma unroll
  for (int d = 0; d < kChunk; ++d) store(o + d, acc[d] * scale);
}

namespace tc = attn::tc;
using tc::bf16;

constexpr int kWarps = 4;   // bf16: 16 keys (A) or query rows (B) a warp
constexpr int kTile = 64;   // bf16: keys (A) or query rows (B) a block

template <int D>
struct BwdTc {
  static constexpr int kPitch = D + 8;
  // query rows per streamed stage of kernel A, keys per stage of kernel B,
  // sized with kernel A's register budget (kMinBlocksA): at D <= 64, 32
  // rows fit 3 blocks an SM in 168 registers without spilling (64 rows
  // need 2 blocks' worth, and the fewer warps hide less latency); at
  // D = 128, dk and dv alone take 128 f32 registers a thread and 32 rows
  // spilled
  static constexpr int kRowsA = D > 64 ? 16 : 32;
  static constexpr int kMinBlocksA = D > 64 ? 1 : 3;
  static constexpr int kKeysB = D > 64 ? 32 : 64;
  // A: k, v [kTile][P]; q, g [2][kRowsA][P]; lse, row term, q ids
  // [2][kRowsA]. B: q, g [kTile][P]; k, v [2][kKeysB][P]; k ids
  // [2][kKeysB].
  static constexpr int kSmemA =
      (2 * kTile + 4 * kRowsA) * kPitch * (int)sizeof(bf16) + 6 * kRowsA * 4;
  static constexpr int kSmemB =
      (2 * kTile + 4 * kKeysB) * kPitch * (int)sizeof(bf16) + 2 * kKeysB * 4;
};

// Kernel A, bf16: dk and dv of one 64-key tile of one (batch, head).
template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32, BwdTc<D>::kMinBlocksA)
    fused_attention_bwd_dkdv_tc(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const T* __restrict__ g, Coords ids,
                                const int32_t* __restrict__ seeds,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                T* __restrict__ dk, T* __restrict__ dv, int L,
                                int H, float scale, float rate,
                                float keep_scale, int segmented) {
  static_assert(std::is_same<T, bf16>::value, "the tensor-core path is bf16");
  constexpr int P = BwdTc<D>::kPitch;
  constexpr int BM = BwdTc<D>::kRowsA;
  constexpr int NT = kWarps * 32;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* ks = reinterpret_cast<bf16*>(smem_tc);      // [kTile][P]
  bf16* vs = ks + kTile * P;                        // [kTile][P]
  bf16* qs = vs + kTile * P;                        // [2][BM][P]
  bf16* gs = qs + 2 * BM * P;                       // [2][BM][P]
  float* lse_s = reinterpret_cast<float*>(gs + 2 * BM * P);  // [2][BM]
  float* row_s = lse_s + 2 * BM;                    // [2][BM]
  int32_t* qid_s = reinterpret_cast<int32_t*>(row_s + 2 * BM);  // [2][BM]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int col0 = blockIdx.x * kTile;
  const int64_t row_stride = (int64_t)H * D;  // [B, L, H, D] contiguous
  const int64_t head_base = (int64_t)b * L * row_stride + (int64_t)h * D;
  const int32_t* qids_b = ids.qids + (int64_t)b * ids.ids_stride;
  const int32_t* kids_b = ids.kids + (int64_t)b * ids.ids_stride;
  const float* lse_bh = lse + ((int64_t)b * H + h) * L;
  const float* delta_bh = delta + ((int64_t)b * H + h) * L;
  const bf16* qg = q + head_base;
  const bf16* gg = g + head_base;

  tc::load_rows<kTile, D, NT>(ks, k + head_base, row_stride, col0, L, tid);
  tc::load_rows<kTile, D, NT>(vs, v + head_base, row_stride, col0, L, tid);
  auto load_stage = [&](int stage, int m0) {
    tc::load_rows<BM, D, NT>(qs + stage * BM * P, qg, row_stride, m0, L, tid);
    tc::load_rows<BM, D, NT>(gs + stage * BM * P, gg, row_stride, m0, L, tid);
    tc::load_vec<BM, NT>(lse_s + stage * BM, lse_bh, m0, L, tid);
    tc::load_vec<BM, NT>(row_s + stage * BM, delta_bh, m0, L, tid);
    tc::load_vec<BM, NT>(qid_s + stage * BM, qids_b, m0, L, tid);
    tc::cp_async_commit();
  };
  load_stage(0, 0);  // one group with the k and v tiles

  // this thread's two keys (accumulator rows g and g + 8 of s^T); keys past
  // the ragged edge compute on zeros and store nothing
  int keys[2], kseg[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    keys[ri] = col0 + warp * 16 + tc::frag_row(lane, 2 * ri);
    kseg[ri] = keys[ri] < L ? kids_b[keys[ri]] : 0;
  }
  const uint32_t seed_h = rate > 0.0f ? attn::dropout_key(seeds, b, h) : 0u;
  const uint32_t keep_thr = attn::keep_threshold(rate);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.0f;
  }

  const int n_stages = (L + BM - 1) / BM;
  for (int it = 0; it < n_stages; ++it) {
    const int stage = it & 1;
    const int m0 = it * BM;
    tc::cp_async_wait_all();  // this stage (the one group in flight) is in
    __syncthreads();          // ... for all; the other stage is free
    if (it + 1 < n_stages) load_stage(stage ^ 1, m0 + BM);
    const bf16* qt = qs + stage * BM * P;
    const bf16* gt = gs + stage * BM * P;
    const float* lse_t = lse_s + stage * BM;
    const float* row_t = row_s + stage * BM;
    const int32_t* qid_t = qid_s + stage * BM;

    // s^T = k q^T and dp^T = v g^T: [16 keys x BM rows] each
    float p[BM / 8][4], ds[BM / 8][4];
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = ds[j][e] = 0.0f;
    }
    tc::mma_rows<D, BM>(p, ks + warp * 16 * P, qt, lane);
    tc::mma_rows<D, BM>(ds, vs + warp * 16 * P, gt, lane);
    // p, ds = p (dp - row), then p_drop in p's place
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      const int c0 = tc::frag_col(lane, j, 0);   // even: a pair of rows
      const float2 lse2 = *reinterpret_cast<const float2*>(lse_t + c0);
      const float2 row2 = *reinterpret_cast<const float2*>(row_t + c0);
      const int2 qid2 = *reinterpret_cast<const int2*>(qid_t + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + (e & 1);               // query row in the stage
        const int ri = e >> 1;
        const bool ok = attn::allowed((e & 1) ? qid2.y : qid2.x, kseg[ri],
                                      segmented);
        const float sv = ok ? p[j][e] * scale : kMaskedScore;
        float pv = tc::exp2_ftz((sv - ((e & 1) ? lse2.y : lse2.x)) *
                                tc::kLog2e);
        // segmented: p = 0 where the grid forbids; no row past the edge
        if ((segmented && !ok) || m0 + c >= L) pv = 0.0f;
        bool keep = true;
        if (rate > 0.0f) {
          keep = attn::keep_u24(ids.row_base + (uint32_t)(m0 + c),
                                ids.col_base + (uint32_t)keys[ri],
                                ids.L_hash, seed_h, keep_thr);
        }
        const float dpv = keep ? ds[j][e] * keep_scale : 0.0f;
        ds[j][e] = pv * (dpv - ((e & 1) ? row2.y : row2.x));
        p[j][e] = keep ? pv * keep_scale : 0.0f;
      }
    }
    uint32_t pa[BM / 16][4], da[BM / 16][4];
    tc::to_a<BM>(pa, p);    // bf16(p_drop)^T
    tc::to_a<BM>(da, ds);   // bf16(ds)^T
    tc::mma_frag<BM, D>(dv_acc, pa, gt, lane);   // dv += p_drop^T g
    tc::mma_frag<BM, D>(dk_acc, da, qt, lane);   // dk += ds^T q
  }

  const float mul_dk[2] = {scale, scale};
  const float mul_dv[2] = {1.0f, 1.0f};
  tc::store_frag<D>(dk + head_base, row_stride, keys[0], L, dk_acc, mul_dk,
                    lane);
  tc::store_frag<D>(dv + head_base, row_stride, keys[0], L, dv_acc, mul_dv,
                    lane);
}

// Kernel B, bf16: dq of one 64-row query tile of one (batch, head).
template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
    fused_attention_bwd_dq_tc(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ g, Coords ids,
                              const int32_t* __restrict__ seeds,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              T* __restrict__ dq, int L, int H, float scale,
                              float rate, float keep_scale, int segmented) {
  static_assert(std::is_same<T, bf16>::value, "the tensor-core path is bf16");
  constexpr int P = BwdTc<D>::kPitch;
  constexpr int BN = BwdTc<D>::kKeysB;
  constexpr int NT = kWarps * 32;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);      // [kTile][P]
  bf16* gs = qs + kTile * P;                        // [kTile][P]
  bf16* ks = gs + kTile * P;                        // [2][BN][P]
  bf16* vs = ks + 2 * BN * P;                       // [2][BN][P]
  int32_t* kid_s = reinterpret_cast<int32_t*>(vs + 2 * BN * P);  // [2][BN]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * kTile;
  const int64_t row_stride = (int64_t)H * D;
  const int64_t head_base = (int64_t)b * L * row_stride + (int64_t)h * D;
  const int32_t* qids_b = ids.qids + (int64_t)b * ids.ids_stride;
  const int32_t* kids_b = ids.kids + (int64_t)b * ids.ids_stride;
  const bf16* kg = k + head_base;
  const bf16* vg = v + head_base;

  tc::load_rows<kTile, D, NT>(qs, q + head_base, row_stride, row0, L, tid);
  tc::load_rows<kTile, D, NT>(gs, g + head_base, row_stride, row0, L, tid);
  auto load_stage = [&](int stage, int n0) {
    tc::load_rows<BN, D, NT>(ks + stage * BN * P, kg, row_stride, n0, L, tid);
    tc::load_rows<BN, D, NT>(vs + stage * BN * P, vg, row_stride, n0, L, tid);
    tc::load_vec<BN, NT>(kid_s + stage * BN, kids_b, n0, L, tid);
    tc::cp_async_commit();
  };
  load_stage(0, 0);  // one group with the q and g tiles

  // this thread's two query rows; rows past the ragged edge compute on
  // zeros and store nothing
  int rows[2], qseg[2];
  float lse_r[2], row_term[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    rows[ri] = row0 + warp * 16 + tc::frag_row(lane, 2 * ri);
    const bool ok = rows[ri] < L;
    const int64_t bhr = ((int64_t)b * H + h) * L + rows[ri];
    qseg[ri] = (segmented && ok) ? qids_b[rows[ri]] : 0;
    lse_r[ri] = ok ? lse[bhr] : 0.0f;
    row_term[ri] = ok ? delta[bhr] : 0.0f;
  }
  const uint32_t seed_h = rate > 0.0f ? attn::dropout_key(seeds, b, h) : 0u;
  const uint32_t keep_thr = attn::keep_threshold(rate);

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }

  const int n_stages = (L + BN - 1) / BN;
  for (int it = 0; it < n_stages; ++it) {
    const int stage = it & 1;
    const int n0 = it * BN;
    tc::cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_stages) load_stage(stage ^ 1, n0 + BN);
    const bf16* kt = ks + stage * BN * P;
    const bf16* vt = vs + stage * BN * P;
    const int32_t* kid_t = kid_s + stage * BN;

    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
    }
    tc::mma_rows<D, BN>(s, qs + warp * 16 * P, kt, lane);   // s = q k^T
    tc::mma_rows<D, BN>(dp, gs + warp * 16 * P, vt, lane);  // dp = g v^T
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int2 kid2 = *reinterpret_cast<const int2*>(
          kid_t + tc::frag_col(lane, j, 0));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = tc::frag_col(lane, j, e);   // key in the stage
        const int ri = e >> 1;
        const bool ok = attn::allowed(qseg[ri], (e & 1) ? kid2.y : kid2.x,
                                      segmented);
        const float sv = ok ? s[j][e] * scale : kMaskedScore;
        float pv = tc::exp2_ftz((sv - lse_r[ri]) * tc::kLog2e);
        // segmented: p = 0 where the grid forbids; no key past the edge
        if ((segmented && !ok) || n0 + c >= L) pv = 0.0f;
        float dpv = dp[j][e];
        if (rate > 0.0f) {
          dpv = attn::keep_u24(ids.row_base + (uint32_t)rows[ri],
                               ids.col_base + (uint32_t)(n0 + c), ids.L_hash,
                               seed_h, keep_thr)
                    ? dpv * keep_scale
                    : 0.0f;
        }
        s[j][e] = pv * (dpv - row_term[ri]);   // ds
      }
    }
    uint32_t da[BN / 16][4];
    tc::to_a<BN>(da, s);
    tc::mma_frag<BN, D>(acc, da, kt, lane);    // dq += bf16(ds) k
  }

  const float mul[2] = {scale, scale};
  tc::store_frag<D>(dq + head_base, row_stride, rows[0], L, acc, mul, lane);
}

template <int D>
cudaError_t launch_tc(const bf16* q, const bf16* k, const bf16* v,
                      const bf16* g, const float* lse, const float* delta,
                      const Coords& ids, const int32_t* seeds, bf16* dq,
                      bf16* dk, bf16* dv, int B, int L, int H, float scale,
                      float rate, float keep_scale, int segmented,
                      cudaStream_t stream) {
  const dim3 grid((L + kTile - 1) / kTile, H, B);
  cudaError_t err = cudaFuncSetAttribute(
      fused_attention_bwd_dkdv_tc<bf16, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, BwdTc<D>::kSmemA);
  if (err != cudaSuccess) return err;
  fused_attention_bwd_dkdv_tc<bf16, D>
      <<<grid, kWarps * 32, BwdTc<D>::kSmemA, stream>>>(
          q, k, v, g, ids, seeds, lse, delta, dk, dv, L, H, scale, rate,
          keep_scale, segmented);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused_attention_bwd_dq_tc<bf16, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             BwdTc<D>::kSmemB);
  if (err != cudaSuccess) return err;
  fused_attention_bwd_dq_tc<bf16, D>
      <<<grid, kWarps * 32, BwdTc<D>::kSmemB, stream>>>(
          q, k, v, g, ids, seeds, lse, delta, dq, L, H, scale, rate,
          keep_scale, segmented);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const float* q_, const float* k_, const float* v_,
                       const float* g_, const float* lse_,
                       const float* delta_,
                       const Coords& ids, const int32_t* seeds_, float* dq,
                       float* dk, float* dv, int B, int L, int H, float scale,
                       float rate, float keep_scale, int segmented,
                       cudaStream_t stream) {
  using T = float;
  // shared memory above the 48 KB static limit needs the opt-in attribute
  cudaError_t err;
  constexpr int RS = Lanes<D>::kRowStride;
  constexpr int P = Lanes<D>::kPerRow;
  const int smem_a = (2 * kKeysPerBlock * RS + 2 * kRowsPerStage * RS +
                      3 * kRowsPerStage) * (int)sizeof(float);
  err = cudaFuncSetAttribute(fused_attention_bwd_dkdv<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_a);
  if (err != cudaSuccess) return err;
  const dim3 grid_a((L + kKeysPerBlock - 1) / kKeysPerBlock, H, B);
  fused_attention_bwd_dkdv<T, D><<<grid_a, kKeysPerBlock * P, smem_a,
                                   stream>>>(
      q_, k_, v_, g_, ids, seeds_, lse_, delta_, dk, dv, L, H, scale, rate,
      keep_scale, segmented);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem_b = (2 * kKeysPerStage * RS + kRowsPerBlock * RS +
                      kKeysPerStage) * (int)sizeof(float);
  err = cudaFuncSetAttribute(fused_attention_bwd_dq<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_b);
  if (err != cudaSuccess) return err;
  const dim3 grid_b((L + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  fused_attention_bwd_dq<T, D><<<grid_b, kRowsPerBlock * P, smem_b,
                                 stream>>>(
      q_, k_, v_, g_, ids, seeds_, lse_, delta_, dq, L, H, scale, rate,
      keep_scale, segmented);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g,
                   const void* out, const void* lse, const Coords& ids,
                   const void* seeds, void* dq, void* dk, void* dv,
                   void* delta, int B, int L, int H, float scale, float rate,
                   float keep_scale, int segmented, cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* g_ = static_cast<const T*>(g);
  const int32_t* seeds_ = static_cast<const int32_t*>(seeds);
  const float* lse_ = static_cast<const float*>(lse);
  float* delta_ = static_cast<float*>(delta);

  const int64_t n_rows = (int64_t)B * L * H;
  const int threads = 256;  // 8 rows (warps) per block
  const int64_t blocks = (n_rows * 32 + threads - 1) / threads;
  fused_attention_bwd_row_term<T, D><<<(unsigned)blocks, threads, 0, stream>>>(
      g_, static_cast<const T*>(out), delta_, L, H, n_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if constexpr (std::is_same<T, bf16>::value) {
    return launch_tc<D>(q_, k_, v_, g_, lse_, delta_, ids, seeds_,
                        static_cast<T*>(dq), static_cast<T*>(dk),
                        static_cast<T*>(dv), B, L, H, scale, rate, keep_scale,
                        segmented, stream);
  } else {
    return launch_f32<D>(q_, k_, v_, g_, lse_, delta_, ids, seeds_,
                         static_cast<T*>(dq), static_cast<T*>(dk),
                         static_cast<T*>(dv), B, L, H, scale, rate,
                         keep_scale, segmented, stream);
  }
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const void* g, const void* out, const void* lse,
                     const Coords& ids, const void* seeds, void* dq, void* dk,
                     void* dv, void* delta, int B, int L, int H, float scale,
                     float rate, float keep_scale, int segmented,
                     cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, g, out, lse, ids, seeds, dq, dk, dv,
                           delta, B, L, H, scale, rate, keep_scale, segmented,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, g, out, lse, ids, seeds, dq, dk, dv,
                           delta, B, L, H, scale, rate, keep_scale, segmented,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, g, out, lse, ids, seeds, dq, dk, dv,
                            delta, B, L, H, scale, rate, keep_scale,
                            segmented, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, g, out, dq, dk, dv: [B, L, H, D] contiguous, bf16 (is_bf16 = 1)
// or f32. lse: [B, H, L] f32 (the forward's). qids, kids, ids_stride,
// row_base, col_base, L_hash: as fused_attention_fwd takes them (the
// forward's own, so the backward regenerates its dropout mask). seeds: [B]
// int32 per-row dropout seeds (read only when rate > 0). delta: [B, H, L]
// f32 scratch for the row term. Returns the first failing launch's
// cudaError_t, or 0.
extern "C" int fused_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* g,
                                   const void* out, const void* lse,
                                   const void* qids, const void* kids,
                                   long long ids_stride, const void* seeds,
                                   void* dq, void* dk, void* dv, void* delta,
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
      is_bf16 ? launch_d<__nv_bfloat16>(D, q, k, v, g, out, lse, ids, seeds,
                                        dq, dk, dv, delta, B, L, H, scale,
                                        rate, keep_scale, segmented, s)
              : launch_d<float>(D, q, k, v, g, out, lse, ids, seeds, dq, dk,
                                dv, delta, B, L, H, scale, rate, keep_scale,
                                segmented, s);
  return (int)err;
}

// attrs[0..3]: registers, static shared memory, dynamic shared memory and
// local memory bytes of bf16 kernel A (which = 0) or B (which = 1) at head
// dim D. Returns a cudaError_t.
extern "C" int fused_attention_bwd_attrs(int D, int which, int* attrs) {
  const void* kernel = nullptr;
  int smem = 0;
  switch (D) {
    case 32:
      kernel = which ? (const void*)fused_attention_bwd_dq_tc<bf16, 32>
                     : (const void*)fused_attention_bwd_dkdv_tc<bf16, 32>;
      smem = which ? BwdTc<32>::kSmemB : BwdTc<32>::kSmemA;
      break;
    case 64:
      kernel = which ? (const void*)fused_attention_bwd_dq_tc<bf16, 64>
                     : (const void*)fused_attention_bwd_dkdv_tc<bf16, 64>;
      smem = which ? BwdTc<64>::kSmemB : BwdTc<64>::kSmemA;
      break;
    case 128:
      kernel = which ? (const void*)fused_attention_bwd_dq_tc<bf16, 128>
                     : (const void*)fused_attention_bwd_dkdv_tc<bf16, 128>;
      smem = which ? BwdTc<128>::kSmemB : BwdTc<128>::kSmemA;
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return attn::kernel_attrs(kernel, smem, attrs);
}
