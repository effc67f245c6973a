// Packed multi-head self-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_packed_kernel` of
// image_diffusion_tpu/ops/pallas/attention.py (called by `_packed_forward`),
// with its default clamped-exp2 softmax.  For each batch row b and head h,
// on the packed (B, N, C) layout whose head h owns channels [h*d, (h+1)*d):
//
//     qs  = bf16(float(q_h) * scale * log2(e))          scale = 1/sqrt(d)
//     s   = qs . bf16(k_h)^T                            fp32 accumulation
//     w   = exp2(clamp(s, -100, 100))
//     out = (bf16(w) . bf16(v_h)) / sum_row(w)          fp32 accumulation
//     row_sum = sum_row(w)                              fp32, when asked for
//
// The TPU kernel rounds P = w / sum(w) to bf16 before the AV product; here
// the unnormalized w is rounded and the fp32 row sum divides once at the
// end.  Both roundings are one bf16 ulp of the same weights, inside the
// bf16 tolerance the plain version is held to.  The clamp bounds every
// weight to [2^-100, 2^100], so no running max is needed: K/V stream in
// tiles and the accumulators are never rescaled.  `row_sum` is what the
// backward kernels need to rebuild P without a pass of their own.
//
// Bounds on the H100 (989 TFLOP/s bf16, 3.35 TB/s), at the sampling grid's
// batch of 54: 4*B*N^2*C FLOPs against 4*B*N*C*2 bytes (q, k, v read, out
// written).  The N=1024 sites (C=256, 128) are bound by operations (58.6
// and 29.3 us); the N <= 256 sites by memory (1.1 to 12.7 us).  A third
// limit stands beside those: one exp2 per score, B*h*N^2 = 453 M at each
// N=1024 site, on special-function units that do 16 a clock on each of
// the 132 SMs: 108 us a site at the card's 1980 MHz maximum, twice the
// tensor-core time at d=32 and four times at d=16, so those sites are
// bound by the exponentials, not the products.
//
// Design.  Every kernel reads Q, K and V in place from the packed layout by
// head-band offset: no head transpose, no padding in device memory and no
// N x N scores there.  A head dim that is an odd multiple of 8 (72, DiT-
// XL/2's 1152 / 16) is padded to the next multiple of 16 in shared memory
// and registers (`padded`).
//   * N a multiple of 128: `wg_packed_attention_kernel`.  A warpgroup (128
//     threads) owns a 64-row Q tile of one head of one batch row; a block
//     is two warpgroups that share the K/V stream, which halves the
//     traffic from L2: with one warpgroup a block the d=32 site was bound
//     by those loads.  The
//     scaled, rounded Q tile lives in registers as A fragments.  K/V tiles
//     of 64 keys arrive by 16-byte `cp.async` into a ring of three stages,
//     laid out as `wgmma` reads them without a swizzle
//     (`packed_common.cuh`), so the next two tiles' loads are in flight
//     while the current tile is multiplied.  Scores are one `wgmma`
//     m64n64k16 per 16 channels with B read straight from the K tile; the
//     weights are formed on the accumulator registers and, rounded, are the
//     register A operand of the second `wgmma` (m64n{d}k16), whose B is the
//     V tile as it lies (keys x d) through the transpose bit.  Four or more
//     warpgroups share an SM, so one's exponentials overlap another's
//     products.
//   * otherwise (N a multiple of 16): `packed_attention_kernel`, one warp
//     per 16 Q rows, K/V tiles staged by plain loads, `mma.sync` m16n8k16.
//     The N <= 64 sites take 3 to 9 us on the device.
// On an NVIDIA H100 80GB HBM3 at 700 W, batch 54, device time: 0.239 ms at
// (N, C) = (1024, 256) and 0.175 ms at (1024, 128), against 0.258 and 0.259
// ms for PyTorch's scaled_dot_product_attention; 0.99 ms over the UNet's 14
// sites (SDPA 1.20 ms).  Tried and not kept, both slower: starting the next tile's
// scores before the current tile's exponentials within one warpgroup (the
// second score buffer costs the occupancy it gains), and four warpgroups a
// block.  Not yet used: TMA (the
// 96-byte head band of d=48 fits none of its swizzles), a producer warp,
// and a polynomial exp2 on the FMA units beside the special-function one.

#include "packed_common.cuh"

namespace {

using namespace packed;

constexpr int kWarpgroups = 2;  // a block of the wgmma kernel: 128 Q rows
constexpr int kStages = 3;      // its K/V ring

// The width of the shared K and V tiles and of the score product's K: the
// head dim rounded up to the 16-deep k-step.  d = 72 (DiT-XL/2) pads to
// 80: K's columns 72-79 are zero in shared memory and Q's in registers,
// so the fifth k-step adds nothing; the AV product's n = 72 needs no pad.
__host__ __device__ constexpr int padded(int d) { return (d + 15) / 16 * 16; }

// Divide a warp's 16 x D accumulator tile by its rows' sums of weights
// (`l0`, `l1`: this thread's partial sums of rows g and g + 8) and store it;
// `o0` points at row g, column 2t of the output, `l` at row g of the row
// sums or is null.
template <int D>
__device__ __forceinline__ void finish(__nv_bfloat16* o0, int C, const float (&acc)[D / 2],
                                       float l0, float l1, float* l, int tq) {
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  store_rows<D>(o0, C, acc, 1.0f / l0, 1.0f / l1);
  if (l != nullptr && tq == 0) {
    l[0] = l0;
    l[8] = l1;
  }
}

template <int D>
__global__ void __launch_bounds__(kWarpgroups * 128)
wg_packed_attention_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, float* __restrict__ row_sum,
                           int N, int C, float qscale) {
  constexpr int DP = padded(D);              // the tiles' width
  constexpr int KSTEPS = DP / 16;            // k-steps of the score product
  constexpr int TILE_BYTES = kTile * DP * 2;  // one K or V tile
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = shared_address(smem);  // stage s: K tile, then V tile
  if constexpr (DP != D) {
    // the K tiles' last chunk (channels D to DP = D + 8) of each 8-row
    // group: zero once, never written by a copy; one 16-byte row of it a
    // tile row
    for (int i = threadIdx.x; i < kStages * kTile; i += kWarpgroups * 128) {
      const int stage = i / kTile, r = i % kTile;
      const int off = ((r / 8) * (DP / 8) + D / 8) * 128 + (r % 8) * 16;
      *reinterpret_cast<uint4*>(smem + stage * 2 * TILE_BYTES + off) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int tq = lane & 3;  // thread in group
  const int row0 = blockIdx.x * (kWarpgroups * kTile) + warp * 16;
  const size_t base = (size_t)blockIdx.z * N * C + (size_t)blockIdx.y * D;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;
  const int tiles = N / kTile;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t)
    fetch_pair<D, kStages, kWarpgroups * 128, DP>(ring, t, tiles, kb, vb, C);

  uint32_t qa[KSTEPS][4];
  load_a<KSTEPS, D>(qa, q + base + (size_t)row0 * C, C, g, tq, qscale);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float l0 = 0.0f, l1 = 0.0f;  // partial row sums of rows g and g + 8

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's part of tile t has landed
    fence_proxy_async();
    __syncthreads();  // all of tile t has landed; all warps are done with tile t - 1
    fetch_pair<D, kStages, kWarpgroups * 128, DP>(ring, t + kStages - 1, tiles, kb, vb, C);
    const uint32_t ks = ring + (t % kStages) * 2 * TILE_BYTES;
    const uint32_t vs = ks + TILE_BYTES;

    float s[kTile / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      WgmmaRS<kTile>::template run<0>(s, qa[kk], desc_rows<DP>(ks, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);

    uint32_t pa[kTile / 16][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      const float w0 = weight(s[4 * j]), w1 = weight(s[4 * j + 1]);
      const float w2 = weight(s[4 * j + 2]), w3 = weight(s[4 * j + 3]);
      l0 += w0 + w1;
      l1 += w2 + w3;
      pa[j / 2][(j & 1) * 2] = pack_bf16(w0, w1);
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(w2, w3);
    }
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kb16 = 0; kb16 < kTile / 16; ++kb16)
      WgmmaRS<D>::template run<1>(acc, pa[kb16], desc_cols<DP>(vs, kb16), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
  }

  finish<D>(o + base + (size_t)(row0 + g) * C + 2 * tq, C, acc, l0, l1,
            row_sum == nullptr ? nullptr
                               : row_sum + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * N + row0 + g,
            tq);
}

template <int D, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
packed_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ o, float* __restrict__ row_sum,
                        int N, int C, float qscale) {
  constexpr int DP = padded(D);
  constexpr int KSTEPS = DP / 16;  // k-steps of the score product
  constexpr int NTILES = D / 8;    // n-tiles of the AV product
  constexpr int LDS = DP + 8;      // shared row stride: 8 elements of padding, distinct banks
  __shared__ __align__(16) __nv_bfloat16 ks[kTile * LDS];
  __shared__ __align__(16) __nv_bfloat16 vs[kTile * LDS];
  if constexpr (DP != D) {
    // K's columns [D, DP): zero once, never written by the staging
    for (int r = threadIdx.x; r < kTile; r += WARPS * 32)
      *reinterpret_cast<uint4*>(&ks[r * LDS + D]) = make_uint4(0u, 0u, 0u, 0u);
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int row0 = blockIdx.x * (16 * WARPS) + warp * 16;
  // N % 16 == 0, so a warp's 16 rows are all valid or all past the end
  const bool active = row0 < N;
  const size_t base = (size_t)blockIdx.z * N * C + (size_t)blockIdx.y * D;

  uint32_t qa[KSTEPS][4];
  if (active) load_a<KSTEPS, D>(qa, q + base + (size_t)row0 * C, C, g, tq, qscale);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float l0 = 0.0f, l1 = 0.0f;

  for (int kv0 = 0; kv0 < N; kv0 += kTile) {
    const int rows = min(kTile, N - kv0);  // a multiple of 16
    __syncthreads();  // every warp is done with the previous tile
    stage2<D, LDS, WARPS * 32>(ks, vs, k + base, v + base, kv0, rows, C);
    __syncthreads();
    if (!active) continue;

    for (int kc = 0; kc < rows; kc += 16) {
      float s[8];
      row_products<KSTEPS, LDS>(s, qa, ks, kc, g, tq);
#pragma unroll
      for (int e = 0; e < 8; ++e) s[e] = weight(s[e]);
      l0 += (s[0] + s[1]) + (s[4] + s[5]);
      l1 += (s[2] + s[3]) + (s[6] + s[7]);
      uint32_t pa[4];
      pack_a(pa, s, 0);
      col_products<NTILES, LDS>(acc, pa, vs, kc, g, tq);
    }
  }

  if (!active) return;
  finish<D>(o + base + (size_t)(row0 + g) * C + 2 * tq, C, acc, l0, l1,
            row_sum == nullptr ? nullptr
                               : row_sum + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * N + row0 + g,
            tq);
}

template <int D>
cudaError_t launch_wg(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                      __nv_bfloat16* o, float* row_sum, int B, int N, int C, int heads,
                      float qscale, cudaStream_t stream) {
  constexpr int SMEM = kStages * 2 * kTile * padded(D) * 2;
  if (SMEM > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(wg_packed_attention_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(N / (kWarpgroups * kTile), heads, B);
  wg_packed_attention_kernel<D><<<grid, kWarpgroups * 128, SMEM, stream>>>(q, k, v, o, row_sum, N,
                                                                           C, qscale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* row_sum, int B,
                   int N, int C, int heads, float qscale, cudaStream_t stream) {
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp = static_cast<float*>(row_sum);
  if (N % (kWarpgroups * kTile) == 0) {
    return launch_wg<D>(qp, kp, vp, op, lp, B, N, C, heads, qscale, stream);
  } else if (N >= 64) {
    dim3 grid((N + 63) / 64, heads, B);
    packed_attention_kernel<D, 4><<<grid, 128, 0, stream>>>(qp, kp, vp, op, lp, N, C, qscale);
  } else {
    dim3 grid(N / 16, heads, B);
    packed_attention_kernel<D, 1><<<grid, 32, 0, stream>>>(qp, kp, vp, op, lp, N, C, qscale);
  }
  return cudaGetLastError();
}

}  // namespace


// q, k, v, o: contiguous bf16 (B, N, C) device buffers, 16-byte aligned;
// row_sum: fp32 (B, heads, N) that receives each row's sum of weights, or
// null for none; C = heads * d with d in {16, 32, 48, 64, 72}; N a positive
// multiple of 16.  qscale = log2(e) / sqrt(d).  Launches on `stream` and
// returns the cudaError_t of the launch (0 on success).
extern "C" int packed_attention_forward(const void* q, const void* k, const void* v, void* o,
                                        void* row_sum, int B, int N, int C, int heads,
                                        float qscale, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || N % 16 != 0 || heads <= 0 || heads > 65535 ||
      C % heads != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C / heads) {
    case 16: return (int)launch<16>(q, k, v, o, row_sum, B, N, C, heads, qscale, s);
    case 32: return (int)launch<32>(q, k, v, o, row_sum, B, N, C, heads, qscale, s);
    case 48: return (int)launch<48>(q, k, v, o, row_sum, B, N, C, heads, qscale, s);
    case 64: return (int)launch<64>(q, k, v, o, row_sum, B, N, C, heads, qscale, s);
    case 72: return (int)launch<72>(q, k, v, o, row_sum, B, N, C, heads, qscale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
