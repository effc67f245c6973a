// Blockwise (flash) self-attention forward for Hopper (sm_90a), head-major.
//
// Replaces the TPU kernel `_flash_kernel` of
// image_diffusion_tpu/ops/pallas/attention.py (defined at line 40, called
// at line 80 by `_flash_forward`, which serves `flash_attention` and
// `attention`).  For each (batch, head) slice of the (B, H, N, D) layout:
//
//     s   = scale * (q . k^T)                  bf16 operands, fp32 sums
//     m   = running row max of s over the K/V tiles seen so far
//     w   = exp(s - m)                         natural exp, no clamp
//     out = (sum_tiles bf16(w) . bf16(v)) / sum_tiles(w)
//
// with the accumulator and the row sum rescaled by exp(m_old - m_new) at
// every tile: the TPU kernel's online softmax.  The exp is taken as exp2
// of scores scaled by scale * log2(e) in fp32, the same function; the
// scale is applied to the fp32 scores, never folded into a bf16 q.  The
// TPU kernel feeds fp32 weights to its P.V product; here the weights are
// rounded to bf16 for the tensor cores, as the JAX package's default path
// for these sites rounds its softmax weights (models/layers.py), one bf16
// ulp of each weight.  Output in bf16.
//
// Bounds on the H100 (989 TFLOP/s bf16, 3.35 TB/s) at the VAE's sites
// (H = 1, N = 1024, D = 384):
//   * operations: 4*B*N^2*D = 77.3 GFLOP at B = 48 (78 us), 43.5 GFLOP at
//     B = 27 (44 us): the bound;
//   * bytes: 4*B*N*D*2 (q, k, v read once, out written once) = 151 MB at
//     B = 48 (45 us);
//   * the K/V stream from L2: every block of 64 Q rows reads its slice's
//     whole K and V, N/64 times the bytes of K and V: 1.21 GB at B = 48;
//   * exponentials: B*N^2 = 50.3 M at B = 48, 12 us on the special-
//     function units.
// What the design does about each: every score is computed once (the
// tensor work is the minimal 4*B*N^2*D); Q, K and V are read by TMA, Q once
// a block and K/V once a block, out written once; the L2 stream is left as
// it is, since it does not bind (end of this note); one exp2 per score,
// plus two a row a tile for the running max.
//
// Design.  One block per (64-row Q tile, batch*head slice): two
// warpgroups, 256 threads, one block an SM (about 210 KB of shared memory at
// D = 384).
//   * Each score is computed once.  The 64 x D fp32 output does not fit one
//     warpgroup's registers next to a score tile (192 + 32 a thread at
//     D = 384), so each warpgroup keeps the output's columns of one half of
//     D (96 registers).  Tile j's scores belong to warpgroup j % 2 alone:
//     S = Q . K_j^T as one chain of `wgmma` m64n64k16, both operands in
//     shared memory (K-major, 128-byte swizzle).  That warpgroup takes the
//     tile's own row max and exponentials first, then, once the other has
//     handed over the running max and sum of tile j - 1, only moves them to
//     the new max (two exp2 and a multiply a row), writes bf16 P_j
//     (swizzled as an A operand), the rescale factors, max and sum to
//     shared memory, fences those generic-proxy writes for the asynchronous
//     proxy and arrives on a named barrier that the other warpgroup waits
//     on.  Both then rescale their columns and add P_j . V_j[:, their
//     columns] by `wgmma` m64n{D/2}k16: the scorer with P in registers (its
//     score accumulators are the A fragments), the other from shared memory;
//     B is the V tile as it lies (keys x D: MN-major through the transpose
//     bit).  The serial part of the online softmax is that short step.
//   * TMA.  Q, K and V are read through tensor maps (encoded per call on the
//     host, since they hold the base pointers, through the driver entry
//     point: no -lcuda) in boxes of 64 rows x 128 bytes with the 128-byte
//     swizzle.  K and V tiles go through a ring of 3 slots at D = 384 (4
//     below) in the order K_0, K_1, V_0, K_2, V_1, ...: at 3 slots K_j
//     lands in V_{j-3}'s slot, released long before, and V_j in K_j's,
//     released once tile j's scores are done.  Completion is an mbarrier a
//     slot; the warp whose release completes a slot's count (shared-memory
//     atomics) starts the next load into it, so loads start as soon as
//     their slot is free and in no fixed order.
//   * Overlap.  While one warpgroup takes its tile's exponentials, the
//     other's score product and P.V products run on the tensor cores.  A
//     warpgroup finishes its previous P.V product before it waits for its
//     next K tile, and issues the other's P.V product before its own.
// N must be a multiple of 64; D is 128, 256 or 384 (each warpgroup owns 64,
// 128 or 192 output columns).
//
// Tried and dropped (NVIDIA H100 80GB HBM3, 700 W; see PERF.md):
//   * a producer warp in a 288-thread block, without `setmaxnreg`: ptxas
//     then gives each thread only 168 registers, and the kernel spilled
//     once P stayed in registers.  A producer warpgroup that hands its
//     registers to the consumers by `setmaxnreg` (384 threads) is untried;
//   * a producer that loads the ring strictly in order K_j, V_j: at 3 slots
//     each K tile waited for the P.V products two tiles back, and its load
//     sat on every tile's critical path;
//   * the score product as two independent chains over the halves of D:
//     32 more registers and no faster;
//   * issuing the next own tile's scores right after the P.V products, to
//     run during the other warpgroup's exponentials: slower;
//   * the P hand-over on an mbarrier with 128 arrivals, or one a warp: no
//     faster than the named barrier.
//   * Not tried: clusters with TMA multicast of K/V.  The L2 stream does not
//     bind: a build of this kernel with the products, the softmax and the
//     hand-over taken out, the ring alone, takes a third of its time.

#include <cmath>
#include <cstdint>
#include <cuda.h>

#include "packed_common.cuh"

namespace {

using packed::fence_proxy_async;
using packed::kTile;  // Q rows of a block, keys of a K/V tile
using packed::pack_bf16;
using packed::quad_sum;
using packed::reg_fence;
using packed::shared_address;
using packed::wgmma_commit;
using packed::wgmma_fence;
using packed::wgmma_wait;
using packed::WgmmaRS;
using packed::WgmmaSS;

constexpr int kBox = 64;                        // columns of a TMA box: 128 bytes, one swizzle span
constexpr int kBoxBytes = kTile * kBox * 2;     // 8 KiB
constexpr int kThreads = 2 * 128;               // two warpgroups

// Dynamic shared memory of the D-wide kernel, in bytes from a 1024-byte
// aligned base (the swizzle's repeat): the Q tile, the K/V ring, two P
// tiles, the row statistics (alpha[2][64], m[64], l[64] fp32), the
// mbarriers (full[S], q, pempty[2]) and the ring slots' release counts.
template <int D>
struct Layout {
  static constexpr int kStages = D == 384 ? 3 : 4;
  static constexpr int kTileBytes = kTile * D * 2;   // D / 64 boxes
  static constexpr int kQ = 0;
  static constexpr int kRing = kTileBytes;
  static constexpr int kP = kRing + kStages * kTileBytes;
  static constexpr int kStats = kP + 2 * kBoxBytes;
  static constexpr int kBars = kStats + 4 * kTile * 4;
  static constexpr int kCounts = kBars + 8 * (kStages + 3);
  static constexpr int kBytes = kCounts + 4 * kStages + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "more shared memory than a block may have");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// max and sum over one row of a thread's 64-column accumulator tile (the
// 16 values s[4j + R], s[4j + R + 1]), as trees; the max across the row's
// four threads too
template <int R>
__device__ __forceinline__ float row_max(const float (&s)[kTile / 2]) {
  float x[kTile / 8];
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) x[j] = fmaxf(s[4 * j + R], s[4 * j + R + 1]);
#pragma unroll
  for (int w = 1; w < kTile / 8; w *= 2)
#pragma unroll
    for (int j = 0; j < kTile / 8; j += 2 * w) x[j] = fmaxf(x[j], x[j + w]);
  x[0] = fmaxf(x[0], __shfl_xor_sync(0xffffffffu, x[0], 1));
  return fmaxf(x[0], __shfl_xor_sync(0xffffffffu, x[0], 2));
}

template <int R>
__device__ __forceinline__ float row_sum(const float (&s)[kTile / 2]) {
  float x[kTile / 8];
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) x[j] = s[4 * j + R] + s[4 * j + R + 1];
#pragma unroll
  for (int w = 1; w < kTile / 8; w *= 2)
#pragma unroll
    for (int j = 0; j < kTile / 8; j += 2 * w) x[j] += x[j + w];
  return x[0];
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one box of the 2-D map at (column x, row y) into shared memory, completion on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int y,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------- named barriers

// Barriers 1 and 2: P of an even or an odd tile is in shared memory.  The
// scoring warpgroup's 128 threads arrive, the other warpgroup's 128 wait.
__device__ __forceinline__ int p_ready(int t) { return 1 + (t & 1); }

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

// ---------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor with the 128-byte swizzle: address, the
// byte step between 64-element chunks along M or N of an MN-major operand
// ("leading"), and between 8-row groups ("stride"); atoms 1024-byte aligned.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lead, uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(stride >> 4) << 32) | (1ull << 62);
}

// K-major operand (rows are M or N, columns are K) of a tile stored as
// 64-column boxes of 64 rows: k-step `kk` covers columns [16 kk, 16 kk + 16),
// 32 bytes into box kk / 4.  The Q, K and P tiles.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  return desc_sw128(tile + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16, 1024);
}

// MN-major operand (rows are K, columns are N): the V tile from box `box`
// on, k-step `kb` covering rows (keys) [16 kb, 16 kb + 16).
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int box, int kb) {
  return desc_sw128(tile + box * kBoxBytes + kb * 2048, kBoxBytes, 1024);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                       int N, float scale_log2) {
  using L = Layout<D>;
  constexpr int S = L::kStages;
  constexpr int BOXES = D / kBox;
  constexpr int DH = D / 2;          // output columns of a consumer warpgroup
  constexpr int KSTEPS = D / 16;     // k-steps of the score product
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = shared_address(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  float* alpha_s = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kStats);  // [2][64]
  float* m_s = alpha_s + 2 * kTile;
  float* l_s = m_s + kTile;
  const int T = N / kTile;
  const int kv0 = blockIdx.y * N;             // the slice's first row in the (B*H*N, D) matrix
  const int row0 = kv0 + blockIdx.x * kTile;  // this block's first Q row
  const uint32_t bars = base + L::kBars;
  const uint32_t qfull = bars + 8 * S;
  auto full = [&](int i) { return bars + 8 * (i % S); };  // slot of ring item i has landed
  // releases of each slot's current item: 8 a use (one a warp; the scoring
  // warpgroup's warps count 2 for a K tile, which only they read)
  unsigned* released = reinterpret_cast<unsigned*>(smem_raw + (base - raw) + L::kCounts);
  // ring items: K_0, K_1, V_0, K_2, V_1, ..., K_{T-1}, V_{T-2}, V_{T-1}, so
  // that at 3 stages K_j's slot is V_{j-3}'s, long released, and V_j's is
  // K_j's, released once tile j's scores are done
  auto kitem = [&](int j) { return j == 0 ? 0 : 2 * j - 1; };
  auto vitem = [&](int j) { return j == T - 1 ? 2 * T - 1 : 2 * j + 2; };
  auto load = [&](int i) {  // start ring item i: one thread
    const bool is_v = i > 0 && ((i & 1) == 0 || i == 2 * T - 1);
    const int j = is_v ? (i == 2 * T - 1 ? T - 1 : (i - 2) >> 1) : (i + 1) >> 1;
    const CUtensorMap* map = is_v ? &vmap : &kmap;
    mbar_expect_tx(full(i), L::kTileBytes);
#pragma unroll
    for (int b = 0; b < BOXES; ++b)
      tma_load(base + L::kRing + (i % S) * L::kTileBytes + b * kBoxBytes, map, b * kBox, kv0 + j * kTile, full(i));
  };
  auto pempty = [&](int t) { return qfull + 8 + 8 * (t & 1); };  // P buffer of tile t
  auto slot = [&](int i) { return base + L::kRing + (i % S) * L::kTileBytes; };


  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full(i), 1);
      released[i] = 0;
    }
    mbar_init(qfull, 1);
    for (int b = 0; b < 2; ++b) mbar_init(pempty(b), 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(qfull, L::kTileBytes);
#pragma unroll
    for (int b = 0; b < BOXES; ++b)
      tma_load(base + L::kQ + b * kBoxBytes, &qmap, b * kBox, row0, qfull);
    for (int i = 0; i < S && i < 2 * T; ++i) load(i);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // consumer warpgroup c: output columns [c * DH, (c + 1) * DH), and the
  // scores of tiles t with t % 2 == c.  This thread holds rows r0 and r1 of
  // every accumulator, columns 8n + 2tq and + 1.
  const int c = warp >> 2;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int r0 = (warp & 3) * 16 + g;
  const int r1 = r0 + 8;
  const uint32_t qs = base + L::kQ;
  unsigned char* const p_s = smem_raw + (base - raw) + L::kP;

  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
  float s[kTile / 2];          // a score tile
  uint32_t pa[kTile / 16][4];  // this warpgroup's bf16 P as the A operand of its P.V product
  int pv = -1;                 // the tile whose P.V product this warpgroup has in flight

  auto release = [&](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // this warp is done with ring item i; the warp that completes the slot's
  // releases starts item i + S in it
  auto release_item = [&](int i, unsigned count) {
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();  // this warp's products that read the slot are done
      if ((atomicAdd(&released[i % S], count) + count) % 8 == 0 && i + S < 2 * T) {
        __threadfence_block();  // and so are the other warps'
        load(i + S);
      }
    }
  };
  auto finish_pv = [&]() {  // after a wgmma wait that covers the product
    if (pv >= 0) {
      release_item(vitem(pv), 1);
      release(pempty(pv));
      pv = -1;
    }
  };
  auto rescale = [&](float a0, float a1) {
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      acc[4 * n] *= a0;
      acc[4 * n + 1] *= a0;
      acc[4 * n + 2] *= a1;
      acc[4 * n + 3] *= a1;
    }
  };
  // acc += P_u . V_u[:, own columns]: P from shared memory (the other
  // warpgroup's tile) or from registers (this one's)
  auto issue_pv = [&](int u, bool from_registers) {
    const int i = vitem(u);
    const uint32_t p = base + L::kP + (u & 1) * kBoxBytes;
    mbar_wait(full(i), (i / S) & 1);
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < kTile / 16; ++kb) {
      const uint64_t v = desc_mnmajor(slot(i), c * (DH / kBox), kb);
      if (from_registers)
        WgmmaRS<DH>::template run<1>(acc, pa[kb], v, 1);
      else
        WgmmaSS<DH>::template run<1>(acc, desc_kmajor(p, kb), v, 1);
    }
    wgmma_commit();
    pv = u;
  };

  mbar_wait(qfull, 0);
  for (int t = c; t <= T; t += 2) {
    const bool own = t < T;
    if (pv >= 0) {  // its own tile t - 2: done before the wait for K_t
      wgmma_wait<0>();
      reg_fence(acc);
      finish_pv();
    }

    // tile t's scores and its own statistics, before the running ones are
    // known: row max ml (log2 units), weights exp2(s - ml), their row sums
    float ml0 = -INFINITY, ml1 = -INFINITY, sum0 = 0.0f, sum1 = 0.0f;
    if (own) {
      const int i = kitem(t);
      mbar_wait(full(i), (i / S) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        WgmmaSS<kTile>::template run<0>(s, desc_kmajor(qs, kk), desc_kmajor(slot(i), kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);
      release_item(i, 2);
      // the scale is positive, so the max of the scaled scores is the
      // scaled max; weights exp2(scale * s - ml) by one FMA each
      ml0 = row_max<0>(s) * scale_log2;
      ml1 = row_max<2>(s) * scale_log2;
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        s[4 * j] = ex2(fmaf(s[4 * j], scale_log2, -ml0));
        s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], scale_log2, -ml0));
        s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], scale_log2, -ml1));
        s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], scale_log2, -ml1));
      }
      sum0 = quad_sum(row_sum<0>(s));
      sum1 = quad_sum(row_sum<2>(s));
    }

    // the running statistics after tile t - 1, and its P, from the other
    // warpgroup (the four threads of a row hold the same values)
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f, ap0 = 1.0f, ap1 = 1.0f;
    if (t >= 1) {
      named_sync(p_ready(t - 1));
      ap0 = alpha_s[((t - 1) & 1) * kTile + r0];
      ap1 = alpha_s[((t - 1) & 1) * kTile + r1];
      m0 = m_s[r0];
      m1 = m_s[r1];
      l0 = l_s[r0];
      l1 = l_s[r1];
    }

    float a0 = 1.0f, a1 = 1.0f;
    if (own) {  // the online softmax step: weights exp2(s - m_new), rescale by exp2(m_old - m_new)
      const float mx0 = fmaxf(m0, ml0), mx1 = fmaxf(m1, ml1);
      const float f0 = ex2(ml0 - mx0), f1 = ex2(ml1 - mx1);
      a0 = ex2(m0 - mx0);  // 0 on the first tile (m = -inf)
      a1 = ex2(m1 - mx1);
      l0 = l0 * a0 + sum0 * f0;
      l1 = l1 * a1 + sum1 * f1;
      // bf16 P_t, in registers and, swizzled, in shared memory: row r's
      // 16-byte chunk j lands at chunk j ^ (r % 8)
      if (t >= 2) mbar_wait(pempty(t), ((t - 2) >> 1) & 1);
      unsigned char* p = p_s + (t & 1) * kBoxBytes;
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        const uint32_t lo = pack_bf16(s[4 * j] * f0, s[4 * j + 1] * f0);
        const uint32_t hi = pack_bf16(s[4 * j + 2] * f1, s[4 * j + 3] * f1);
        pa[j / 2][(j & 1) * 2] = lo;
        pa[j / 2][(j & 1) * 2 + 1] = hi;
        *reinterpret_cast<uint32_t*>(p + r0 * 128 + ((j ^ g) << 4) + 4 * tq) = lo;
        *reinterpret_cast<uint32_t*>(p + r1 * 128 + ((j ^ g) << 4) + 4 * tq) = hi;
      }
      m_s[r0] = mx0;
      m_s[r1] = mx1;
      l_s[r0] = l0;
      l_s[r1] = l1;
      alpha_s[(t & 1) * kTile + r0] = a0;
      alpha_s[(t & 1) * kTile + r1] = a1;
      fence_proxy_async();  // P is read by wgmma, through the asynchronous proxy
      named_arrive(p_ready(t));
    }

    if (t >= 1) {  // the other warpgroup's tile t - 1
      rescale(ap0, ap1);
      issue_pv(t - 1, false);
    }
    if (!own) break;
    if (t >= 1) {
      wgmma_wait<0>();
      reg_fence(acc);
      finish_pv();
    }
    rescale(a0, a1);
    issue_pv(t, true);
  }
  wgmma_wait<0>();
  reg_fence(acc);
  finish_pv();

  // divide by the row sums of the last tile's owner (this warpgroup, or the
  // other, written before its P's arrival)
  const float inv0 = 1.0f / l_s[r0];
  const float inv1 = 1.0f / l_s[r1];
  __nv_bfloat16* o0 = o + (size_t)(row0 + r0) * D + c * DH + 2 * tq;
  __nv_bfloat16* o1 = o0 + (size_t)8 * D;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    *reinterpret_cast<uint32_t*>(o0 + 8 * n) = pack_bf16(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
    *reinterpret_cast<uint32_t*>(o1 + 8 * n) = pack_bf16(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found at run time (no -lcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// the (rows, D) bf16 matrix at `ptr` in boxes of 64 rows x 64 columns, 128-byte swizzle
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int rows, int D) {
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {kBox, kTile};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int N, float scale_log2,
           cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (!make_map(encode, &maps[i], ptrs[i], BH * N, D)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<D>::kBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / kTile, BH);
  flash_attention_kernel<D><<<grid, kThreads, Layout<D>::kBytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), N, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous bf16 (B*H, N, D) device buffers, 16-byte aligned;
// D in {128, 256, 384}; N a positive multiple of 64.  scale_log2 =
// scale * log2(e).  Launches on `stream` and returns the cudaError_t of
// the launch (0 on success).
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, void* o,
                                       int BH, int N, int D, float scale_log2, void* stream) {
  if (BH <= 0 || BH > 65535 || N <= 0 || N % kTile != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128: return launch<128>(q, k, v, o, BH, N, scale_log2, s);
    case 256: return launch<256>(q, k, v, o, BH, N, scale_log2, s);
    case 384: return launch<384>(q, k, v, o, BH, N, scale_log2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
