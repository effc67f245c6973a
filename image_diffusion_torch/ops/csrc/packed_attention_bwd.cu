// Packed multi-head self-attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_packed_bwd_kernel` of
// image_diffusion_tpu/ops/pallas/attention.py (called by `_packed_bwd`, the
// VJP of `_packed_forward`), with its default clamped-exp2 softmax.  For each
// batch row b and head h, on the packed (B, N, C) layout whose head h owns
// channels [h*d, (h+1)*d), with scale = 1/sqrt(d):
//
//     qs    = bf16(float(q_h) * scale * log2(e))    as the forward kernel
//     w     = exp2(clamp(qs . k_h^T, -100, 100))    fp32 accumulation
//     P     = w / sum_row(w)                        fp32
//     dP    = dO_h . v_h^T                          fp32 accumulation
//     delta = sum_row(dP * P)
//     dS    = bf16(P * (dP - delta) * scale)        natural-domain scale
//     dq_h  = dS . k_h                              -> q's dtype
//     dk_h  = dS^T . q_h                            fp32 sum, cast once
//     dv_h  = bf16(P)^T . dO_h                      fp32 sum, cast once
//
// The scores are recomputed exactly as `packed_attention.cu` computes them
// (q pre-scaled and rounded to bf16 before the product), so P here is the P
// of the forward.  The clamp's zero derivative is ignored, as in the TPU
// kernel.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s) at the training batch of
// 48: five products, 10*B*N^2*C FLOPs, against 7*B*N*C*2 bytes (q, k, v, dO
// read; dq, dk, dv written).  The N=1024 sites are compute-bound (130 us at
// C=256, 65 us at C=128); the N <= 256 sites are bound by memory.
//
// Design.  The TPU kernel carries the dK/dV sums across sequential Q-block
// grid steps in VMEM; Hopper runs blocks in parallel and in no order, so the
// work is split into two kernels with no atomics, deterministic:
//   (a) dq_kernel: one block per (64-row Q tile, or 16 rows when N < 64;
//       head; batch row), one warp per 16 Q rows.  A first pass over all
//       key tiles recomputes S and dP and gives each row its sum(w) and
//       delta = sum(w*dP)/sum(w) (fp32, written to scratch for (b)); a
//       second pass forms dS and accumulates dq in registers.
//   (b) dkdv_kernel: one block per (64-key tile, or 16 keys; head; batch
//       row), one warp per 16 keys.  It loops over all Q tiles, recomputes
//       S^T = k . qs^T and dP^T = v . dO^T with the keys as rows, normalizes
//       with the row statistics of (a), and keeps the fp32 dK and dV of its
//       keys in registers until the end.
// Both read q, k, v and dO in place by head-band offset (no transpose, no
// padding, no N x N matrix in device memory), stage the streamed tiles in
// shared memory (rows padded by 8 elements), and run every product on the
// tensor cores as bf16 m16n8k16 mma.sync with fp32 accumulation; score
// accumulators are reused in registers as A fragments of the next product.
// This does nine products where five suffice (the first pass of (a)
// recomputes S and dP, (b) recomputes both again).  Not yet used: wgmma,
// TMA, load/compute overlap, row statistics saved by the forward.
// Takes d in {16, 32, 48, 64} and N a multiple of 16; a warp whose 16 rows
// lie past N skips its work, and the last tile stops at N.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;  // rows of a streamed tile
constexpr float kClamp = 100.0f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t scaled_pair(const __nv_bfloat16* p, float scale) {
  float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return pack_bf16(f.x * scale, f.y * scale);
}

// d += a . b for a 16x16 (row) A, 16x8 (col) B, fp32 16x8 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments of the 16 x D block whose first row is `r0` of a row-major
// matrix with row stride `ld`, each pair scaled in fp32 and rounded back
template <int KSTEPS>
__device__ __forceinline__ void load_a(uint32_t (&a)[KSTEPS][4], const __nv_bfloat16* r0,
                                       size_t ld, int g, int tq, float scale) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const __nv_bfloat16* p0 = r0 + (size_t)g * ld + kk * 16 + 2 * tq;
    const __nv_bfloat16* p1 = p0 + (size_t)8 * ld;
    a[kk][0] = scaled_pair(p0, scale);
    a[kk][1] = scaled_pair(p1, scale);
    a[kk][2] = scaled_pair(p0 + 8, scale);
    a[kk][3] = scaled_pair(p1 + 8, scale);
  }
}

// s[j] = a . rows^T for the 16 staged rows [r, r+16) of `tile`: the score
// block of 16 A rows against those rows, keys (or queries) j*8 + column
template <int KSTEPS, int LDS>
__device__ __forceinline__ void row_products(float (&s)[2][4], const uint32_t (&a)[KSTEPS][4],
                                             const __nv_bfloat16* tile, int r, int g, int tq) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    const __nv_bfloat16* row = tile + (r + j * 8 + g) * LDS + 2 * tq;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(row + kk * 16);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(row + kk * 16 + 8);
      mma_bf16(s[j], a[kk], b0, b1);
    }
  }
}

// acc[n] += a . tile[r : r+16, n*8 : n*8+8] for every 8-column band n
template <int NTILES, int LDS>
__device__ __forceinline__ void col_products(float (&acc)[NTILES][4], const uint32_t (&a)[4],
                                             const __nv_bfloat16* tile, int r, int g, int tq) {
#pragma unroll
  for (int n = 0; n < NTILES; ++n) {
    const __nv_bfloat16* col = tile + (r + 2 * tq) * LDS + n * 8 + g;
    const uint32_t b0 = pack_bf16(col[0], col[LDS]);
    const uint32_t b1 = pack_bf16(col[8 * LDS], col[9 * LDS]);
    mma_bf16(acc[n], a, b0, b1);
  }
}

// the 16x16 A fragment whose columns are the accumulators of s[0], s[1]
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&s)[2][4]) {
  a[0] = pack_bf16(s[0][0], s[0][1]);
  a[1] = pack_bf16(s[0][2], s[0][3]);
  a[2] = pack_bf16(s[1][0], s[1][1]);
  a[3] = pack_bf16(s[1][2], s[1][3]);
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ float weight(float s) { return exp2f(fminf(fmaxf(s, -kClamp), kClamp)); }

// stage rows [r0, r0 + rows) of the head band of `a` and `b` into shared
template <int D, int LDS, int THREADS>
__device__ __forceinline__ void stage2(__nv_bfloat16* as, __nv_bfloat16* bs,
                                       const __nv_bfloat16* a, const __nv_bfloat16* b,
                                       int r0, int rows, int C) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < rows * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * 8;
    const size_t goff = (size_t)(r0 + r) * C + c;
    *reinterpret_cast<uint4*>(&as[r * LDS + c]) = *reinterpret_cast<const uint4*>(a + goff);
    *reinterpret_cast<uint4*>(&bs[r * LDS + c]) = *reinterpret_cast<const uint4*>(b + goff);
  }
}

template <int D, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
          __nv_bfloat16* __restrict__ dq, float* __restrict__ inv_l, float* __restrict__ delta,
          int N, int C, float qscale, float scale) {
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
  if (active) {
    load_a(qa, q + base + (size_t)row0 * C, C, g, tq, qscale);
    load_a(da, dout + base + (size_t)row0 * C, C, g, tq, 1.0f);
  }

  // pass 1: row sums of w and of w * dP
  float l0 = 0.0f, l1 = 0.0f, t0 = 0.0f, t1 = 0.0f;
  for (int kv0 = 0; kv0 < N; kv0 += kTile) {
    const int rows = min(kTile, N - kv0);
    __syncthreads();
    stage2<D, LDS, WARPS * 32>(ks, vs, k + base, v + base, kv0, rows, C);
    __syncthreads();
    if (!active) continue;
    for (int kc = 0; kc < rows; kc += 16) {
      float s[2][4], dp[2][4];
      row_products<KSTEPS, LDS>(s, qa, ks, kc, g, tq);
      row_products<KSTEPS, LDS>(dp, da, vs, kc, g, tq);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float w0 = weight(s[j][0]), w1 = weight(s[j][1]);
        const float w2 = weight(s[j][2]), w3 = weight(s[j][3]);
        l0 += w0 + w1;
        l1 += w2 + w3;
        t0 += w0 * dp[j][0] + w1 * dp[j][1];
        t1 += w2 * dp[j][2] + w3 * dp[j][3];
      }
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  const float delta0 = quad_sum(t0) * inv0, delta1 = quad_sum(t1) * inv1;

  // pass 2: dS and dq
  float acc[NTILES][4];
#pragma unroll
  for (int n = 0; n < NTILES; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  for (int kv0 = 0; kv0 < N; kv0 += kTile) {
    const int rows = min(kTile, N - kv0);
    __syncthreads();
    stage2<D, LDS, WARPS * 32>(ks, vs, k + base, v + base, kv0, rows, C);
    __syncthreads();
    if (!active) continue;
    for (int kc = 0; kc < rows; kc += 16) {
      float s[2][4], dp[2][4];
      row_products<KSTEPS, LDS>(s, qa, ks, kc, g, tq);
      row_products<KSTEPS, LDS>(dp, da, vs, kc, g, tq);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = weight(s[j][e]) * (e < 2 ? inv0 : inv1);
          s[j][e] = p * (dp[j][e] - (e < 2 ? delta0 : delta1)) * scale;
        }
      }
      uint32_t dsa[4];
      pack_a(dsa, s);
      col_products<NTILES, LDS>(acc, dsa, ks, kc, g, tq);
    }
  }

  if (!active) return;
  __nv_bfloat16* o0 = dq + base + (size_t)(row0 + g) * C + 2 * tq;
  __nv_bfloat16* o1 = o0 + (size_t)8 * C;
#pragma unroll
  for (int n = 0; n < NTILES; ++n) {
    *reinterpret_cast<uint32_t*>(o0 + n * 8) = pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(o1 + n * 8) = pack_bf16(acc[n][2], acc[n][3]);
  }
  if (tq == 0) {
    inv_l[stats + row0 + g] = inv0;
    inv_l[stats + row0 + g + 8] = inv1;
    delta[stats + row0 + g] = delta0;
    delta[stats + row0 + g + 8] = delta1;
  }
}

template <int D, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
dkdv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ inv_l, const float* __restrict__ delta,
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
  __shared__ float l_s[kTile];
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
  float dk_acc[NTILES][4], dv_acc[NTILES][4];
#pragma unroll
  for (int n = 0; n < NTILES; ++n) {
    dk_acc[n][0] = dk_acc[n][1] = dk_acc[n][2] = dk_acc[n][3] = 0.0f;
    dv_acc[n][0] = dv_acc[n][1] = dv_acc[n][2] = dv_acc[n][3] = 0.0f;
  }

  for (int q0 = 0; q0 < N; q0 += kTile) {
    const int rows = min(kTile, N - q0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < rows * CHUNKS; idx += THREADS) {
      const int r = idx / CHUNKS;
      const int c = (idx % CHUNKS) * 8;
      const size_t goff = base + (size_t)(q0 + r) * C + c;
      const uint4 raw = *reinterpret_cast<const uint4*>(q + goff);
      *reinterpret_cast<uint4*>(&q_s[r * LDS + c]) = raw;
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
      uint4 sc;
      sc.x = scaled_pair(e, qscale);
      sc.y = scaled_pair(e + 2, qscale);
      sc.z = scaled_pair(e + 4, qscale);
      sc.w = scaled_pair(e + 6, qscale);
      *reinterpret_cast<uint4*>(&qs_s[r * LDS + c]) = sc;
      *reinterpret_cast<uint4*>(&do_s[r * LDS + c]) = *reinterpret_cast<const uint4*>(dout + goff);
    }
    for (int idx = threadIdx.x; idx < rows; idx += THREADS) {
      l_s[idx] = inv_l[stats + q0 + idx];
      d_s[idx] = delta[stats + q0 + idx];
    }
    __syncthreads();
    if (!active) continue;

    for (int qc = 0; qc < rows; qc += 16) {
      float st[2][4], dpt[2][4];  // keys as rows, queries qc + j*8 + column
      row_products<KSTEPS, LDS>(st, ka, qs_s, qc, g, tq);
      row_products<KSTEPS, LDS>(dpt, va, do_s, qc, g, tq);
      float ds[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qc + j * 8 + 2 * tq + (e & 1);
          const float p = weight(st[j][e]) * l_s[qi];
          st[j][e] = p;
          ds[j][e] = p * (dpt[j][e] - d_s[qi]) * scale;
        }
      }
      uint32_t pa[4], dsa[4];
      pack_a(pa, st);
      pack_a(dsa, ds);
      col_products<NTILES, LDS>(dv_acc, pa, do_s, qc, g, tq);
      col_products<NTILES, LDS>(dk_acc, dsa, q_s, qc, g, tq);
    }
  }

  if (!active) return;
  const size_t r0 = base + (size_t)(key0 + g) * C + 2 * tq;
  const size_t r1 = r0 + (size_t)8 * C;
#pragma unroll
  for (int n = 0; n < NTILES; ++n) {
    *reinterpret_cast<uint32_t*>(dk + r0 + n * 8) = pack_bf16(dk_acc[n][0], dk_acc[n][1]);
    *reinterpret_cast<uint32_t*>(dk + r1 + n * 8) = pack_bf16(dk_acc[n][2], dk_acc[n][3]);
    *reinterpret_cast<uint32_t*>(dv + r0 + n * 8) = pack_bf16(dv_acc[n][0], dv_acc[n][1]);
    *reinterpret_cast<uint32_t*>(dv + r1 + n * 8) = pack_bf16(dv_acc[n][2], dv_acc[n][3]);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, void* dq,
                   void* dk, void* dv, void* inv_l, void* delta, int B, int N, int C, int heads,
                   float qscale, float scale, cudaStream_t stream) {
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* dop = static_cast<const __nv_bfloat16*>(dout);
  auto* dqp = static_cast<__nv_bfloat16*>(dq);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  auto* lp = static_cast<float*>(inv_l);
  auto* dp = static_cast<float*>(delta);
  const bool wide = N >= 64;
  const dim3 grid(wide ? (N + 63) / 64 : N / 16, heads, B);
  if (wide)
    dq_kernel<D, 4><<<grid, 128, 0, stream>>>(qp, kp, vp, dop, dqp, lp, dp, N, C, qscale, scale);
  else
    dq_kernel<D, 1><<<grid, 32, 0, stream>>>(qp, kp, vp, dop, dqp, lp, dp, N, C, qscale, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (wide)
    dkdv_kernel<D, 4><<<grid, 128, 0, stream>>>(qp, kp, vp, dop, lp, dp, dkp, dvp, N, C, qscale, scale);
  else
    dkdv_kernel<D, 1><<<grid, 32, 0, stream>>>(qp, kp, vp, dop, lp, dp, dkp, dvp, N, C, qscale, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dq, dk, dv: contiguous bf16 (B, N, C) device buffers,
// 16-byte aligned; inv_l, delta: fp32 (B, heads, N) scratch that the first
// kernel writes and the second reads.  C = heads * d with d in {16, 32, 48,
// 64}; N a positive multiple of 16.  qscale = log2(e) / sqrt(d), scale =
// 1 / sqrt(d).  Launches both kernels on `stream` and returns the
// cudaError_t of the launches (0 on success).
extern "C" int packed_attention_backward(const void* q, const void* k, const void* v,
                                         const void* dout, void* dq, void* dk, void* dv,
                                         void* inv_l, void* delta, int B, int N, int C,
                                         int heads, float qscale, float scale, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || N % 16 != 0 || heads <= 0 || heads > 65535 ||
      C % heads != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C / heads) {
    case 16: err = launch<16>(q, k, v, dout, dq, dk, dv, inv_l, delta, B, N, C, heads, qscale, scale, s); break;
    case 32: err = launch<32>(q, k, v, dout, dq, dk, dv, inv_l, delta, B, N, C, heads, qscale, scale, s); break;
    case 48: err = launch<48>(q, k, v, dout, dq, dk, dv, inv_l, delta, B, N, C, heads, qscale, scale, s); break;
    case 64: err = launch<64>(q, k, v, dout, dq, dk, dv, inv_l, delta, B, N, C, heads, qscale, scale, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
