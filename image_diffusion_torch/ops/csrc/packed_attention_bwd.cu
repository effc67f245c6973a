// Packed multi-head self-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_packed_bwd_kernel` of
// image_diffusion_tpu/ops/pallas/attention.py (called by `_packed_bwd`, the
// VJP of `_packed_forward`), with its default clamped-exp2 softmax.  For each
// batch row b and head h, on the packed (B, N, C) layout whose head h owns
// channels [h*d, (h+1)*d), with scale = 1/sqrt(d), given the forward's
// output O and row sums l = sum_row(w):
//
//     qs    = bf16(float(q_h) * scale * log2(e))    as the forward kernel
//     w     = exp2(clamp(qs . k_h^T, -100, 100))    fp32 accumulation
//     P     = w / l                                 fp32
//     dP    = dO_h . v_h^T                          fp32 accumulation
//     delta = sum_row(dO_h * O_h)                   fp32, = sum_row(dP * P)
//     dS    = bf16(P * (dP - delta) * scale)        natural-domain scale
//     dq_h  = dS . k_h                              -> q's dtype
//     dk_h  = dS^T . q_h                            fp32 sum, cast once
//     dv_h  = bf16(P)^T . dO_h                      fp32 sum, cast once
//
// The scores are recomputed exactly as `packed_attention.cu` computes them
// (q pre-scaled and rounded to bf16 before the product, the same exp2), and
// l is the forward's own sum, so P here is the P of the forward.  delta
// from O differs from sum_row(dP * P) only by O's rounding to bf16.  The
// clamp's zero derivative is ignored, as in the TPU kernel.
//
// Bounds on the H100 (989 TFLOP/s bf16, 3.35 TB/s) at the training batch of
// 48: five products suffice, 10*B*N^2*C FLOPs, against 7*B*N*C*2 bytes (q,
// k, v, dO read; dq, dk, dv written).  The N=1024 sites are bound by
// operations (130 us at C=256, 65 us at C=128); the N <= 256 sites by
// memory.  The exponentials are a limit of their own: these kernels take
// two per score (one in each kernel), 2*B*h*N^2 = 805 M at each N=1024
// site, at 16 a clock on each of the 132 SMs 193 us a site at the card's
// 1980 MHz maximum, more than the tensor-core time at both.
//
// Design.  The TPU kernel carries the dK/dV sums across sequential Q-block
// grid steps in VMEM; Hopper runs blocks in parallel and in no order, so the
// work is split into two kernels with no atomics, deterministic:
//   (a) dq: a 64-row Q tile of one head of one batch row per warpgroup.
//       Its prologue takes delta from its own O and dO rows (written to
//       scratch for (b)) and 1/l from the forward's row sums, so one pass
//       over the key tiles is enough: S, dP, dS . K, three products.
//   (b) dkdv: one block per (64-key tile; head; batch row).  It loops over
//       all Q tiles, recomputes S^T = k . qs^T and dP^T = v . dO^T with the
//       keys as rows, normalizes with 1/l and delta, and keeps the fp32 dK
//       and dV of its keys in registers until the end: four products.
// Seven products and two exponentials per score, where five and one would
// need fp32 atomics on dq.  All read q, k, v, dO in place by head-band
// offset (no transpose, no padding, no N x N matrix in device memory).
//   * N a multiple of 128: `wg_dq_kernel`, `wg_dkdv_kernel`.  The
//     warpgroup's own 64 x d tiles (Q and dO in (a), K and V in (b)) are
//     register A fragments; the streamed tiles (K, V in (a); Q, dO, l,
//     delta in (b)) arrive by 16-byte `cp.async` into a ring (three stages
//     in (a), two in (b)) in the layout `wgmma` reads without a swizzle
//     (`packed_common.cuh`).  Every product is a `wgmma` with B read from
//     shared memory: rows^T products (S, dP, S^T, dP^T) from the tile as it
//     lies, products over the tile's rows (dS.K, P^T.dO, dS^T.Q) from the
//     same tile through the transpose bit.  P^T and dS^T, rounded, are
//     register A operands.  (b) writes the scaled, rounded Q tile beside
//     the raw one in shared memory, and 1/l over l: each thread converts
//     the chunks it copied itself, so no extra barrier is needed.  At d=32
//     a block of (a) is two warpgroups sharing the K/V stream, which
//     bounds a one-warpgroup block there; at d=16 and in (b) that gained
//     nothing.
//   * otherwise (N a multiple of 16): `dq_kernel`, `dkdv_kernel`, one warp
//     per 16 rows, tiles staged by plain loads, `mma.sync` m16n8k16.
// On an NVIDIA H100 80GB HBM3 at 700 W, batch 48, device time of both
// kernels: 0.764 ms at (N, C) = (1024, 256) and 0.497 ms at (1024, 128),
// against 0.670 and 0.611 ms for the backward of PyTorch's
// scaled_dot_product_attention; 3.00 ms over the UNet's 14 sites (SDPA's
// backward 3.01 ms).  (b) is the larger half (0.50 of the 0.76 ms): per
// score it needs as many instruction slots (8) and tensor-core
// clocks as special-function clocks.  Not yet used: TMA, a producer warp, a five-product single kernel
// with fp32 atomics on dq.

#include "packed_common.cuh"

namespace {

using namespace packed;

constexpr int kDqStages = 3;    // K/V ring of wg_dq_kernel
constexpr int kDkdvStages = 2;  // Q/dO ring of wg_dkdv_kernel

// delta of rows g and g + 8 from the dO fragments `da` and the matching O
// rows, and 1/l of the same rows
template <int KSTEPS>
__device__ __forceinline__ void row_stats(float& delta0, float& delta1,
                                          const uint32_t (&da)[KSTEPS][4],
                                          const __nv_bfloat16* o_r0, size_t ld, int g, int tq) {
  uint32_t oa[KSTEPS][4];
  load_a(oa, o_r0, ld, g, tq, 1.0f);
  float t0 = 0.0f, t1 = 0.0f;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = unpack_bf16(da[kk][i]);
      const float2 b = unpack_bf16(oa[kk][i]);
      if (i & 1) t1 += a.x * b.x + a.y * b.y;  // fragments 1, 3: row g + 8
      else t0 += a.x * b.x + a.y * b.y;
    }
  }
  delta0 = quad_sum(t0);
  delta1 = quad_sum(t1);
}

template <int D, int WG>
__global__ void __launch_bounds__(WG * 128)
wg_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ out,
             const __nv_bfloat16* __restrict__ dout, const float* __restrict__ row_sum,
             __nv_bfloat16* __restrict__ dq, float* __restrict__ delta, int N, int C,
             float qscale, float scale) {
  constexpr int KSTEPS = D / 16;
  constexpr int TILE_BYTES = kTile * D * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = shared_address(smem);  // stage s: K tile, then V tile

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int row0 = blockIdx.x * (WG * kTile) + warp * 16;
  const size_t base = (size_t)blockIdx.z * N * C + (size_t)blockIdx.y * D;
  const size_t stats = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * N;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;
  const int tiles = N / kTile;

#pragma unroll
  for (int t = 0; t < kDqStages - 1; ++t)
    fetch_pair<D, kDqStages, WG * 128>(ring, t, tiles, kb, vb, C);

  uint32_t qa[KSTEPS][4], da[KSTEPS][4];
  load_a(qa, q + base + (size_t)row0 * C, C, g, tq, qscale);
  load_a(da, dout + base + (size_t)row0 * C, C, g, tq, 1.0f);
  float delta0, delta1;
  row_stats(delta0, delta1, da, out + base + (size_t)row0 * C, C, g, tq);
  const float inv0 = 1.0f / row_sum[stats + row0 + g];
  const float inv1 = 1.0f / row_sum[stats + row0 + g + 8];
  if (tq == 0) {
    delta[stats + row0 + g] = delta0;
    delta[stats + row0 + g + 8] = delta1;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kDqStages - 2>();  // this thread's part of tile t has landed
    fence_proxy_async();
    __syncthreads();  // all of tile t has landed; all warps are done with tile t - 1
    fetch_pair<D, kDqStages, WG * 128>(ring, t + kDqStages - 1, tiles, kb, vb, C);
    const uint32_t ks = ring + (t % kDqStages) * 2 * TILE_BYTES;
    const uint32_t vs = ks + TILE_BYTES;

    float s[kTile / 2], dp[kTile / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      WgmmaRS<kTile>::template run<0>(s, qa[kk], desc_rows<D>(ks, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      WgmmaRS<kTile>::template run<0>(dp, da[kk], desc_rows<D>(vs, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);

    uint32_t dsa[kTile / 16][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = weight(s[4 * j + e]) * (e < 2 ? inv0 : inv1);
        s[4 * j + e] = p * (dp[4 * j + e] - (e < 2 ? delta0 : delta1)) * scale;
      }
    }
#pragma unroll
    for (int kb16 = 0; kb16 < kTile / 16; ++kb16) pack_a(dsa[kb16], s, kb16);
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kb16 = 0; kb16 < kTile / 16; ++kb16)
      WgmmaRS<D>::template run<1>(acc, dsa[kb16], desc_cols<D>(ks, kb16), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
  }

  store_rows<D>(dq + base + (size_t)(row0 + g) * C + 2 * tq, C, acc);
}

template <int D>
__global__ void __launch_bounds__(128)
wg_dkdv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ row_sum, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int N, int C,
               float qscale, float scale) {
  constexpr int KSTEPS = D / 16;
  constexpr int CHUNKS = D / 8;
  constexpr int TILE_BYTES = kTile * D * 2;
  // a stage: Q tile, scaled Q tile, dO tile, 64 x 1/l, 64 x delta
  constexpr int STAGE_BYTES = 3 * TILE_BYTES + 2 * kTile * 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = shared_address(smem);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int key0 = blockIdx.x * kTile + warp * 16;
  const size_t base = (size_t)blockIdx.z * N * C + (size_t)blockIdx.y * D;
  const size_t stats = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * N;
  const __nv_bfloat16* qb = q + base;
  const __nv_bfloat16* dob = dout + base;
  const int tiles = N / kTile;

  auto fetch = [&](int t) {
    if (t < tiles) {
      const uint32_t stage = ring + (t % kDkdvStages) * STAGE_BYTES;
      stage_tile<D, kTile, 128>(stage, qb + (size_t)t * kTile * C, C);
      stage_tile<D, kTile, 128>(stage + 2 * TILE_BYTES, dob + (size_t)t * kTile * C, C);
      // threads 0..15 bring the 64 row sums, 16..31 the 64 deltas, 16 bytes each
      if (threadIdx.x < 32) {
        const float* src = (threadIdx.x < 16 ? row_sum : delta) + stats + t * kTile;
        cp_async16(stage + 3 * TILE_BYTES + threadIdx.x * 16, src + (threadIdx.x & 15) * 4);
      }
    }
    cp_async_commit();  // one group per tile, empty past the end
  };
#pragma unroll
  for (int t = 0; t < kDkdvStages - 1; ++t) fetch(t);

  uint32_t ka[KSTEPS][4], va[KSTEPS][4];
  load_a(ka, k + base + (size_t)key0 * C, C, g, tq, 1.0f);
  load_a(va, v + base + (size_t)key0 * C, C, g, tq, 1.0f);
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kDkdvStages - 2>();  // this thread's part of tile t has landed
    unsigned char* stage = smem + (t % kDkdvStages) * STAGE_BYTES;
    // what this thread copied, it finishes: the scaled, rounded Q chunks
    // beside the raw ones, and 1/l in place of l
#pragma unroll
    for (int i = 0; i < kTile * CHUNKS / 128; ++i) {
      const int idx = threadIdx.x + i * 128;
      const uint4 raw = *reinterpret_cast<const uint4*>(stage + idx * 16);
      uint4 sc;
      sc.x = scaled_pair(raw.x, qscale);
      sc.y = scaled_pair(raw.y, qscale);
      sc.z = scaled_pair(raw.z, qscale);
      sc.w = scaled_pair(raw.w, qscale);
      *reinterpret_cast<uint4*>(stage + TILE_BYTES + idx * 16) = sc;
    }
    if (threadIdx.x < 16) {
      float4* l = reinterpret_cast<float4*>(stage + 3 * TILE_BYTES) + threadIdx.x;
      float4 x = *l;
      x.x = 1.0f / x.x;
      x.y = 1.0f / x.y;
      x.z = 1.0f / x.z;
      x.w = 1.0f / x.w;
      *l = x;
    }
    fence_proxy_async();
    __syncthreads();  // all of tile t is ready; all warps are done with tile t - 1
    fetch(t + kDkdvStages - 1);
    const uint32_t q_s = ring + (t % kDkdvStages) * STAGE_BYTES;
    const uint32_t qs_s = q_s + TILE_BYTES;
    const uint32_t do_s = q_s + 2 * TILE_BYTES;
    const float* inv_s = reinterpret_cast<const float*>(stage + 3 * TILE_BYTES);
    const float* d_s = inv_s + kTile;

    float st[kTile / 2], dpt[kTile / 2];  // keys as rows, the tile's queries as columns
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      WgmmaRS<kTile>::template run<0>(st, ka[kk], desc_rows<D>(qs_s, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      WgmmaRS<kTile>::template run<0>(dpt, va[kk], desc_rows<D>(do_s, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(st);
    reg_fence(dpt);

#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      const float2 inv = *reinterpret_cast<const float2*>(inv_s + 8 * j + 2 * tq);
      const float2 del = *reinterpret_cast<const float2*>(d_s + 8 * j + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = weight(st[4 * j + e]) * ((e & 1) ? inv.y : inv.x);
        st[4 * j + e] = p;
        dpt[4 * j + e] = p * (dpt[4 * j + e] - ((e & 1) ? del.y : del.x)) * scale;
      }
    }
    uint32_t pa[kTile / 16][4], dsa[kTile / 16][4];
#pragma unroll
    for (int kb16 = 0; kb16 < kTile / 16; ++kb16) {
      pack_a(pa[kb16], st, kb16);
      pack_a(dsa[kb16], dpt, kb16);
    }
    reg_fence(dv_acc);
    reg_fence(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kb16 = 0; kb16 < kTile / 16; ++kb16)
      WgmmaRS<D>::template run<1>(dv_acc, pa[kb16], desc_cols<D>(do_s, kb16), 1);
#pragma unroll
    for (int kb16 = 0; kb16 < kTile / 16; ++kb16)
      WgmmaRS<D>::template run<1>(dk_acc, dsa[kb16], desc_cols<D>(q_s, kb16), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dv_acc);
    reg_fence(dk_acc);
  }

  const size_t r0 = base + (size_t)(key0 + g) * C + 2 * tq;
  store_rows<D>(dk + r0, C, dk_acc);
  store_rows<D>(dv + r0, C, dv_acc);
}

template <int D, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ out,
          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ row_sum,
          __nv_bfloat16* __restrict__ dq, float* __restrict__ delta, int N, int C,
          float qscale, float scale) {
  constexpr int KSTEPS = D / 16;
  constexpr int NTILES = D / 8;
  constexpr int LDS = D + 8;
  __shared__ __align__(16) __nv_bfloat16 ks[kTile * LDS];
  __shared__ __align__(16) __nv_bfloat16 vs[kTile * LDS];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int row0 = blockIdx.x * (16 * WARPS) + warp * 16;
  const bool active = row0 < N;  // N % 16 == 0: all 16 rows or none
  const size_t base = (size_t)blockIdx.z * N * C + (size_t)blockIdx.y * D;
  const size_t stats = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * N;

  uint32_t qa[KSTEPS][4], da[KSTEPS][4];
  float delta0 = 0.0f, delta1 = 0.0f, inv0 = 0.0f, inv1 = 0.0f;
  if (active) {
    load_a(qa, q + base + (size_t)row0 * C, C, g, tq, qscale);
    load_a(da, dout + base + (size_t)row0 * C, C, g, tq, 1.0f);
    row_stats(delta0, delta1, da, out + base + (size_t)row0 * C, C, g, tq);
    inv0 = 1.0f / row_sum[stats + row0 + g];
    inv1 = 1.0f / row_sum[stats + row0 + g + 8];
    if (tq == 0) {
      delta[stats + row0 + g] = delta0;
      delta[stats + row0 + g + 8] = delta1;
    }
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  for (int kv0 = 0; kv0 < N; kv0 += kTile) {
    const int rows = min(kTile, N - kv0);
    __syncthreads();
    stage2<D, LDS, WARPS * 32>(ks, vs, k + base, v + base, kv0, rows, C);
    __syncthreads();
    if (!active) continue;
    for (int kc = 0; kc < rows; kc += 16) {
      float s[8], dp[8];
      row_products<KSTEPS, LDS>(s, qa, ks, kc, g, tq);
      row_products<KSTEPS, LDS>(dp, da, vs, kc, g, tq);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool hi = e & 2;  // accumulators 2, 3, 6, 7: row g + 8
        const float p = weight(s[e]) * (hi ? inv1 : inv0);
        s[e] = p * (dp[e] - (hi ? delta1 : delta0)) * scale;
      }
      uint32_t dsa[4];
      pack_a(dsa, s, 0);
      col_products<NTILES, LDS>(acc, dsa, ks, kc, g, tq);
    }
  }

  if (!active) return;
  store_rows<D>(dq + base + (size_t)(row0 + g) * C + 2 * tq, C, acc);
}

template <int D, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
dkdv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ row_sum, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
            int N, int C, float qscale, float scale) {
  constexpr int KSTEPS = D / 16;
  constexpr int NTILES = D / 8;
  constexpr int LDS = D + 8;
  constexpr int CHUNKS = D / 8;
  constexpr int THREADS = WARPS * 32;
  __shared__ __align__(16) __nv_bfloat16 qs_s[kTile * LDS];  // q * scale * log2(e)
  __shared__ __align__(16) __nv_bfloat16 q_s[kTile * LDS];
  __shared__ __align__(16) __nv_bfloat16 do_s[kTile * LDS];
  __shared__ float inv_s[kTile];
  __shared__ float d_s[kTile];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int key0 = blockIdx.x * (16 * WARPS) + warp * 16;
  const bool active = key0 < N;
  const size_t base = (size_t)blockIdx.z * N * C + (size_t)blockIdx.y * D;
  const size_t stats = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * N;

  uint32_t ka[KSTEPS][4], va[KSTEPS][4];
  if (active) {
    load_a(ka, k + base + (size_t)key0 * C, C, g, tq, 1.0f);
    load_a(va, v + base + (size_t)key0 * C, C, g, tq, 1.0f);
  }
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

  for (int q0 = 0; q0 < N; q0 += kTile) {
    const int rows = min(kTile, N - q0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < rows * CHUNKS; idx += THREADS) {
      const int r = idx / CHUNKS;
      const int c = (idx % CHUNKS) * 8;
      const size_t goff = base + (size_t)(q0 + r) * C + c;
      const uint4 raw = *reinterpret_cast<const uint4*>(q + goff);
      *reinterpret_cast<uint4*>(&q_s[r * LDS + c]) = raw;
      uint4 sc;
      sc.x = scaled_pair(raw.x, qscale);
      sc.y = scaled_pair(raw.y, qscale);
      sc.z = scaled_pair(raw.z, qscale);
      sc.w = scaled_pair(raw.w, qscale);
      *reinterpret_cast<uint4*>(&qs_s[r * LDS + c]) = sc;
      *reinterpret_cast<uint4*>(&do_s[r * LDS + c]) = *reinterpret_cast<const uint4*>(dout + goff);
    }
    for (int idx = threadIdx.x; idx < rows; idx += THREADS) {
      inv_s[idx] = 1.0f / row_sum[stats + q0 + idx];
      d_s[idx] = delta[stats + q0 + idx];
    }
    __syncthreads();
    if (!active) continue;

    for (int qc = 0; qc < rows; qc += 16) {
      float st[8], ds[8];  // keys as rows, queries qc + j*8 + column
      row_products<KSTEPS, LDS>(st, ka, qs_s, qc, g, tq);
      row_products<KSTEPS, LDS>(ds, va, do_s, qc, g, tq);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int qi = qc + (e >> 2) * 8 + 2 * tq + (e & 1);
        const float p = weight(st[e]) * inv_s[qi];
        st[e] = p;
        ds[e] = p * (ds[e] - d_s[qi]) * scale;
      }
      uint32_t pa[4], dsa[4];
      pack_a(pa, st, 0);
      pack_a(dsa, ds, 0);
      col_products<NTILES, LDS>(dv_acc, pa, do_s, qc, g, tq);
      col_products<NTILES, LDS>(dk_acc, dsa, q_s, qc, g, tq);
    }
  }

  if (!active) return;
  const size_t r0 = base + (size_t)(key0 + g) * C + 2 * tq;
  store_rows<D>(dk + r0, C, dk_acc);
  store_rows<D>(dv + r0, C, dv_acc);
}

// The dq kernel with WG warpgroups (64 WG Q rows) a block, then the dk/dv
// kernel with one.
template <int D, int WG>
cudaError_t launch_wg(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                      const __nv_bfloat16* out, const __nv_bfloat16* dout, const float* row_sum,
                      __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, float* delta,
                      int B, int N, int C, int heads, float qscale, float scale,
                      cudaStream_t stream) {
  constexpr int DQ_SMEM = kDqStages * 2 * kTile * D * 2;
  constexpr int DKDV_SMEM = kDkdvStages * (3 * kTile * D * 2 + 2 * kTile * 4);
  cudaError_t err;
  if (DQ_SMEM > 48 * 1024) {
    err = cudaFuncSetAttribute(wg_dq_kernel<D, WG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DQ_SMEM);
    if (err != cudaSuccess) return err;
  }
  wg_dq_kernel<D, WG><<<dim3(N / (WG * kTile), heads, B), WG * 128, DQ_SMEM, stream>>>(
      q, k, v, out, dout, row_sum, dq, delta, N, C, qscale, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (DKDV_SMEM > 48 * 1024) {
    err = cudaFuncSetAttribute(wg_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DKDV_SMEM);
    if (err != cudaSuccess) return err;
  }
  wg_dkdv_kernel<D><<<dim3(N / kTile, heads, B), 128, DKDV_SMEM, stream>>>(
      q, k, v, dout, row_sum, delta, dk, dv, N, C, qscale, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, const void* row_sum, void* dq, void* dk, void* dv,
                   void* delta, int B, int N, int C, int heads, float qscale, float scale,
                   cudaStream_t stream) {
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* op = static_cast<const __nv_bfloat16*>(out);
  const auto* dop = static_cast<const __nv_bfloat16*>(dout);
  const auto* lp = static_cast<const float*>(row_sum);
  auto* dqp = static_cast<__nv_bfloat16*>(dq);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  auto* dp = static_cast<float*>(delta);
  cudaError_t err;
  if (N % (2 * kTile) == 0) {
    // two warpgroups share the dq kernel's K/V ring where that pays: at d=32
    // the stream of tiles bounds a one-warpgroup block; at d=16 it does not,
    // and at d >= 48 only one 256-thread block would fit an SM's registers
    return launch_wg<D, D == 32 ? 2 : 1>(qp, kp, vp, op, dop, lp, dqp, dkp, dvp, dp, B, N, C, heads,
                                         qscale, scale, stream);
  }
  const bool wide = N >= 64;
  const dim3 grid(wide ? (N + 63) / 64 : N / 16, heads, B);
  if (wide)
    dq_kernel<D, 4><<<grid, 128, 0, stream>>>(qp, kp, vp, op, dop, lp, dqp, dp, N, C, qscale, scale);
  else
    dq_kernel<D, 1><<<grid, 32, 0, stream>>>(qp, kp, vp, op, dop, lp, dqp, dp, N, C, qscale, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (wide)
    dkdv_kernel<D, 4><<<grid, 128, 0, stream>>>(qp, kp, vp, dop, lp, dp, dkp, dvp, N, C, qscale, scale);
  else
    dkdv_kernel<D, 1><<<grid, 32, 0, stream>>>(qp, kp, vp, dop, lp, dp, dkp, dvp, N, C, qscale, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out, dout, dq, dk, dv: contiguous bf16 (B, N, C) device buffers,
// 16-byte aligned; row_sum: fp32 (B, heads, N), the forward kernel's row
// sums for the same q and k, and out its output; delta: fp32 (B, heads, N)
// scratch that the first kernel writes and the second reads.  C = heads * d
// with d in {16, 32, 48, 64}; N a positive multiple of 16.  qscale =
// log2(e) / sqrt(d), scale = 1 / sqrt(d).  Launches both kernels on
// `stream` and returns the cudaError_t of the launches (0 on success).
extern "C" int packed_attention_backward(const void* q, const void* k, const void* v,
                                         const void* out, const void* dout, const void* row_sum,
                                         void* dq, void* dk, void* dv, void* delta, int B, int N,
                                         int C, int heads, float qscale, float scale,
                                         void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || N % 16 != 0 || heads <= 0 || heads > 65535 ||
      C % heads != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C / heads) {
    case 16: return (int)launch<16>(q, k, v, out, dout, row_sum, dq, dk, dv, delta, B, N, C, heads, qscale, scale, s);
    case 32: return (int)launch<32>(q, k, v, out, dout, row_sum, dq, dk, dv, delta, B, N, C, heads, qscale, scale, s);
    case 48: return (int)launch<48>(q, k, v, out, dout, row_sum, dq, dk, dv, delta, B, N, C, heads, qscale, scale, s);
    case 64: return (int)launch<64>(q, k, v, out, dout, row_sum, dq, dk, dv, delta, B, N, C, heads, qscale, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
