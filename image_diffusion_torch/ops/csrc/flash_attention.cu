// Blockwise (flash) self-attention forward for Hopper (sm_90a), head-major.
//
// Replaces the TPU kernel `_flash_kernel` of
// image_diffusion_tpu/ops/pallas/attention.py (called by `_flash_forward`,
// `flash_attention` and `attention`).  For each (batch, head) slice of the
// (B, H, N, D) layout:
//
//     s   = scale * (q . k^T)                  bf16 operands, fp32 sums
//     m   = running row max of s over the K/V tiles seen so far
//     w   = exp(s - m)                         natural exp, no clamp
//     out = (sum_tiles bf16(w) . bf16(v)) / sum_tiles(w)
//
// with the accumulator and the row sum rescaled by exp(m_old - m_new)
// whenever a tile raises a row's max: the TPU kernel's online softmax.  The
// exp is taken as exp2 of scores scaled by scale * log2(e) in fp32, the
// same function; the scale is applied to the fp32 scores, never folded into
// a bf16 q.  The TPU kernel feeds fp32 weights to its P.V product; here
// the weights are rounded to bf16 for the tensor cores, as the JAX
// package's default path for these sites rounds its softmax weights
// (models/layers.py), one bf16 ulp of each weight.  Output in bf16.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s) at the VAE's sites
// (H = 1, N = 1024, D = 384): 4*B*N^2*D FLOPs against 4*B*N*D*2 bytes, so
// compute-bound: 78 us at B = 48, 44 us at B = 27.
//
// Design: one block per (64-row Q tile, batch*head slice): 768 blocks at
// B = 48.  D = 384 is too wide for one warp's registers (a 16 x 384 fp32
// accumulator alone is 192 registers a thread), so the block has 8 warps:
// 4 row groups of 16 Q rows times 2 column halves of the output.  Both
// warps of a row group compute the same 16 x 64 score tile (the QK^T
// product is done twice: 1.5x the minimal tensor-core work) and each keeps
// the fp32 accumulator of its D/2 output columns in registers (96 a thread
// at D = 384); the max, the rescale and the row sums are computed
// identically in both, so no exchange is needed.  Q (64 rows), K and V
// (64 keys) tiles are staged in dynamic shared memory, rows padded by 8
// elements so fragment loads hit distinct banks (147 KB at D = 384).
// Products are bf16 m16n8k16 mma.sync with fp32 accumulation; the score
// accumulators are reused in registers as the A operand of the P.V product,
// and V's B fragments come from ldmatrix.trans.  N must be a multiple of 64.
// Not yet used: wgmma, TMA, overlap of the next tile's loads with compute,
// and sharing the score tile between the two column halves.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;      // Q rows per block
constexpr int kKeys = 64;      // keys per K/V tile
constexpr int kRowGroups = 4;  // warps along the Q rows, 16 rows each
constexpr int kColGroups = 2;  // warps along the output's D
constexpr int kThreads = kRowGroups * kColGroups * 32;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// four transposed 8x8 bf16 matrices from shared memory; lane i*8 + r gives
// the address of row r of matrix i
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
constexpr int smem_bytes() {
  return (kRows + 2 * kKeys) * (D + 8) * 2;
}

template <int D>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, const __nv_bfloat16* src, int rows) {
  constexpr int LDS = D + 8;
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < rows * CHUNKS; idx += kThreads) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * 8;
    *reinterpret_cast<uint4*>(&dst[r * LDS + c]) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int N,
                       float scale_log2) {
  constexpr int LDS = D + 8;             // shared row stride in elements
  constexpr int KSTEPS = D / 16;         // k-steps of the score product
  constexpr int STILES = kKeys / 8;      // n-tiles of the 16 x 64 score tile
  constexpr int DW = D / kColGroups;     // output columns of one warp
  constexpr int NTILES = DW / 8;         // n-tiles of its P.V product
  static_assert(NTILES % 2 == 0, "D / 2 must be a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + kRows * LDS;
  __nv_bfloat16* vs = ks + kKeys * LDS;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (and key / column) group
  const int tq = lane & 3;  // thread in group
  const int rg = warp % kRowGroups;
  const int col0 = (warp / kRowGroups) * DW;
  const int row0 = blockIdx.x * kRows;
  const size_t base = (size_t)blockIdx.y * N * D;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;

  stage<D>(qs, q + base + (size_t)row0 * D, kRows);
  // this thread's A-fragment rows g and g + 8 of its warp's 16 Q rows
  const __nv_bfloat16* qrow = &qs[(rg * 16 + g) * LDS + 2 * tq];

  float acc[NTILES][4];
#pragma unroll
  for (int n = 0; n < NTILES; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g, g + 8 (log2 units)
  float l0 = 0.0f, l1 = 0.0f;            // partial running sums of this thread's columns

  for (int kv0 = 0; kv0 < N; kv0 += kKeys) {
    __syncthreads();  // every warp is done with the previous tile
    stage<D>(ks, kb + (size_t)kv0 * D, kKeys);
    stage<D>(vs, vb + (size_t)kv0 * D, kKeys);
    __syncthreads();

    float s[STILES][4];
#pragma unroll
    for (int j = 0; j < STILES; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint32_t a[4] = {load_pair(qrow + kk * 16), load_pair(qrow + 8 * LDS + kk * 16),
                             load_pair(qrow + kk * 16 + 8), load_pair(qrow + 8 * LDS + kk * 16 + 8)};
#pragma unroll
      for (int j = 0; j < STILES; ++j) {
        const __nv_bfloat16* krow = &ks[(j * 8 + g) * LDS + kk * 16 + 2 * tq];
        mma_bf16(s[j], a, load_pair(krow), load_pair(krow + 8));
      }
    }

    // online softmax over this tile, in log2 units
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < STILES; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = exp2f(m0 - mx0);  // 0 on the first tile (m = -inf)
    const float alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int n = 0; n < NTILES; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }
#pragma unroll
    for (int j = 0; j < STILES; ++j) {
      s[j][0] = exp2f(s[j][0] - m0);
      s[j][1] = exp2f(s[j][1] - m0);
      s[j][2] = exp2f(s[j][2] - m1);
      s[j][3] = exp2f(s[j][3] - m1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }

    // acc += bf16(w) . V[:, col0:col0 + DW], 16 keys per k-step
#pragma unroll
    for (int kc = 0; kc < kKeys / 16; ++kc) {
      // score accumulators of keys [16kc, 16kc+8) and [16kc+8, 16kc+16) are
      // exactly the A fragment of the 16x16 weight block
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      // matrices 0/1: keys +0/+8 at columns +0; 2/3: the same at columns +8
      const __nv_bfloat16* vrow =
          &vs[(kc * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDS + col0 + 8 * (lane >> 4)];
#pragma unroll
      for (int np = 0; np < NTILES / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vrow + np * 16);
        mma_bf16(acc[2 * np], pa, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], pa, b[2], b[3]);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / l0;
  const float inv1 = 1.0f / l1;
  __nv_bfloat16* o0 = o + base + (size_t)(row0 + rg * 16 + g) * D + col0 + 2 * tq;
  __nv_bfloat16* o1 = o0 + (size_t)8 * D;
#pragma unroll
  for (int n = 0; n < NTILES; ++n) {
    *reinterpret_cast<uint32_t*>(o0 + n * 8) = pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(o1 + n * 8) = pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int N, float scale_log2,
           cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / kRows, BH);
  flash_attention_kernel<D><<<grid, kThreads, smem_bytes<D>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), N, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: contiguous bf16 (B*H, N, D) device buffers, 16-byte aligned;
// D in {128, 256, 384}; N a positive multiple of 64.  scale_log2 =
// scale * log2(e).  Launches on `stream` and returns the cudaError_t of
// the launch (0 on success).
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, void* o,
                                       int BH, int N, int D, float scale_log2, void* stream) {
  if (BH <= 0 || BH > 65535 || N <= 0 || N % kRows != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 128: return launch<128>(q, k, v, o, BH, N, scale_log2, s);
    case 256: return launch<256>(q, k, v, o, BH, N, scale_log2, s);
    case 384: return launch<384>(q, k, v, o, BH, N, scale_log2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
