// Building blocks shared by the attention kernels for Hopper (sm_90a):
// `packed_attention.cu` (forward), `packed_attention_bwd.cu` (backward) and
// `flash_attention.cu` (the bf16, fences, `wgmma` and shared-address helpers).
//
//   * bf16 packing, the clamped exp2 weight, and the m16n8k16 `mma.sync`
//     used at short sequences;
//   * 16-byte `cp.async` copies of a (rows x D) head-band tile from the
//     packed (B, N, C) layout into shared memory, in the layout `wgmma`
//     reads without a swizzle: 8-row x 16-byte core matrices, each 128
//     contiguous bytes, ordered [row / 8][16-byte chunk of the row].  One
//     tile in that layout serves both as the B operand of rows^T products
//     (its rows are the product's N, its channels the K: "K-major") and,
//     through the transpose bit, as the B operand of products over its
//     rows (rows are K, channels N: "MN-major"), so V, K, Q and dO need no
//     transposed copy.  Any D that is a multiple of 16 fits, 48 included,
//     which none of the 32/64/128-byte swizzles would take;
//   * `wgmma.mma_async` m64nNk16 (bf16 x bf16 -> fp32) with A in registers
//     and B in shared memory, for N in {16, 32, 48, 64, 72, 128, 192}, with both
//     in shared memory for N in {64, 128, 192}, and its fences.  A thread's
//     accumulators of a 64 x N tile are, per 8 columns
//     j: d[4j], d[4j+1] = row g, columns 8j + 2t, + 1 and d[4j+2], d[4j+3] =
//     row g + 8 (g = lane / 4, t = lane % 4, rows within the warp's 16), as
//     `mma.sync` lays them out; the register A operand of a 16-deep k-step
//     is {d[8k], d[8k+1]}, {d[8k+2], d[8k+3]}, {d[8k+4], d[8k+5]}, {d[8k+6],
//     d[8k+7]} rounded to bf16 pairs, so a score tile becomes the next
//     product's A operand without leaving registers.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace packed {

constexpr float kClamp = 100.0f;
constexpr int kTile = 64;  // rows of a streamed tile, and of a block's own tile

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// two adjacent bf16, scaled in fp32 and rounded back
__device__ __forceinline__ uint32_t scaled_pair(uint32_t u, float scale) {
  const float2 f = unpack_bf16(u);
  return pack_bf16(f.x * scale, f.y * scale);
}

// exp2(clamp(s, -100, 100)): the clamp keeps the argument far inside the
// range where ex2.approx needs no denormal handling
__device__ __forceinline__ float weight(float s) {
  float w;
  s = fminf(fmaxf(s, -kClamp), kClamp);
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(w) : "f"(s));
  return w;
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// A fragments (mma.sync m16n8k16 and wgmma m64nNk16 alike) of the 16 x D
// block whose first row is `r0` of a row-major matrix with row stride `ld`,
// each pair scaled in fp32 and rounded back.  Columns at or past DV (a head
// dim that is an odd multiple of 8, padded to KSTEPS * 16) are zero and
// not read.
template <int KSTEPS, int DV = KSTEPS * 16>
__device__ __forceinline__ void load_a(uint32_t (&a)[KSTEPS][4], const __nv_bfloat16* r0,
                                       size_t ld, int g, int tq, float scale) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const __nv_bfloat16* p0 = r0 + (size_t)g * ld + kk * 16 + 2 * tq;
    const __nv_bfloat16* p1 = p0 + (size_t)8 * ld;
    a[kk][0] = scaled_pair(*reinterpret_cast<const uint32_t*>(p0), scale);
    a[kk][1] = scaled_pair(*reinterpret_cast<const uint32_t*>(p1), scale);
    if (kk * 16 + 8 < DV) {
      a[kk][2] = scaled_pair(*reinterpret_cast<const uint32_t*>(p0 + 8), scale);
      a[kk][3] = scaled_pair(*reinterpret_cast<const uint32_t*>(p1 + 8), scale);
    } else {
      a[kk][2] = a[kk][3] = 0u;
    }
  }
}

// the A fragment of k-step `kb` whose columns are the accumulators s[8kb ..]
template <int R>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&s)[R], int kb) {
  a[0] = pack_bf16(s[8 * kb + 0], s[8 * kb + 1]);
  a[1] = pack_bf16(s[8 * kb + 2], s[8 * kb + 3]);
  a[2] = pack_bf16(s[8 * kb + 4], s[8 * kb + 5]);
  a[3] = pack_bf16(s[8 * kb + 6], s[8 * kb + 7]);
}

// Store a warp's 16 x D fp32 accumulator tile (`acc[4n ..]`: row g and row
// g + 8, columns 8n + 2t, + 1) as bf16 rows of a matrix with row stride
// `ld`; `r0` points at row g, column 2t.  Rows g and g + 8 are scaled by
// `s0` and `s1`.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* r0, size_t ld, const float (&acc)[D / 2],
                                           float s0 = 1.0f, float s1 = 1.0f) {
  __nv_bfloat16* r1 = r0 + 8 * ld;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(r0 + n * 8) = pack_bf16(acc[4 * n] * s0, acc[4 * n + 1] * s0);
    *reinterpret_cast<uint32_t*>(r1 + n * 8) = pack_bf16(acc[4 * n + 2] * s1, acc[4 * n + 3] * s1);
  }
}

// ---------------------------------------------------------------- mma.sync

// d += a . b for a 16x16 (row) A, 16x8 (col) B, fp32 16x8 accumulator
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// s[0..8) = a . rows^T for the 16 rows [r, r+16) of a row-major shared tile
// with row stride LDS: 16 A rows against those rows, column j*8 + ... of
// accumulators s[4j ..]
template <int KSTEPS, int LDS>
__device__ __forceinline__ void row_products(float (&s)[8], const uint32_t (&a)[KSTEPS][4],
                                             const __nv_bfloat16* tile, int r, int g, int tq) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    s[4 * j] = s[4 * j + 1] = s[4 * j + 2] = s[4 * j + 3] = 0.0f;
    const __nv_bfloat16* row = tile + (r + j * 8 + g) * LDS + 2 * tq;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(row + kk * 16);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(row + kk * 16 + 8);
      mma_bf16(&s[4 * j], a[kk], b0, b1);
    }
  }
}

// acc[4n ..] += a . tile[r : r+16, n*8 : n*8+8] for every 8-column band n
template <int NTILES, int LDS>
__device__ __forceinline__ void col_products(float (&acc)[4 * NTILES], const uint32_t (&a)[4],
                                             const __nv_bfloat16* tile, int r, int g, int tq) {
#pragma unroll
  for (int n = 0; n < NTILES; ++n) {
    const __nv_bfloat16* col = tile + (r + 2 * tq) * LDS + n * 8 + g;
    const uint32_t b0 = pack_bf16(col[0], col[LDS]);
    const uint32_t b1 = pack_bf16(col[8 * LDS], col[9 * LDS]);
    mma_bf16(&acc[4 * n], a, b0, b1);
  }
}

// stage rows [r0, r0 + rows) of the head band of `a` and `b` into row-major
// shared tiles with row stride LDS (plain 16-byte loads)
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

// ---------------------------------------------------------------- cp.async

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most PENDING of this thread's committed groups are in flight
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// make this thread's shared-memory writes (cp.async's included) visible to
// wgmma, which reads shared memory through the asynchronous proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Start the copy of rows [0, ROWS) of the head band at `g` (row stride C
// elements) into the tile at shared address `tile`, in core-matrix order:
// the 16-byte chunk c of row r lands at ((r / 8) * (DP / 8) + c) * 128 +
// (r % 8) * 16, DP >= D being the tile's width (DP > D leaves the chunks
// past D of each 8-row group unwritten: the zero padding of a head dim
// that is an odd multiple of 8).  Thread `idx` takes row (idx % 8) of core
// matrix (idx / 8), so a warp writes 512 contiguous bytes (no bank
// conflicts) and reads whole 32-byte sectors.
template <int D, int ROWS, int THREADS, int DP = D>
__device__ __forceinline__ void stage_tile(uint32_t tile, const __nv_bfloat16* g, int C) {
  constexpr int CHUNKS = D / 8;
  constexpr int TOTAL = ROWS * CHUNKS;
#pragma unroll
  for (int i = 0; i < (TOTAL + THREADS - 1) / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    if (TOTAL % THREADS == 0 || idx < TOTAL) {
      const int r = (idx / (8 * CHUNKS)) * 8 + (idx & 7);
      const int c = (idx >> 3) % CHUNKS;
      const uint32_t dst = DP == D ? tile + idx * 16
                                   : tile + ((r >> 3) * (DP / 8) + c) * 128 + (idx & 7) * 16;
      cp_async16(dst, g + (size_t)r * C + c * 8);
    }
  }
}

// Start the copies of tile t (rows [t * kTile, (t + 1) * kTile)) of the
// head bands `a` and `b` into stage t % STAGES of the ring at shared address
// `ring` (a's tile, then b's), or nothing past the last tile; one cp.async
// group either way, so a wait counts tiles.
template <int D, int STAGES, int THREADS, int DP = D>
__device__ __forceinline__ void fetch_pair(uint32_t ring, int t, int tiles,
                                           const __nv_bfloat16* a, const __nv_bfloat16* b,
                                           int C) {
  constexpr int TILE_BYTES = kTile * DP * 2;
  if (t < tiles) {
    const uint32_t stage = ring + (t % STAGES) * 2 * TILE_BYTES;
    stage_tile<D, kTile, THREADS, DP>(stage, a + (size_t)t * kTile * C, C);
    stage_tile<D, kTile, THREADS, DP>(stage + TILE_BYTES, b + (size_t)t * kTile * C, C);
  }
  cp_async_commit();
}

// ---------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor without swizzle: address, the byte step
// between core matrices along K ("leading") and along M or N ("stride"),
// all in units of 16 bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t k_step, uint32_t mn_step) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(k_step >> 4) << 16) |
         ((uint64_t)(mn_step >> 4) << 32);
}

// B operand of a rows^T product: the staged tile's rows are N, its channels
// K; k-step `kk` covers channels [16 kk, 16 kk + 16).  Transpose bit 0.
template <int D>
__device__ __forceinline__ uint64_t desc_rows(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 256, 128, (D / 8) * 128);
}

// B operand of a product over the tile's rows: rows are K, channels N;
// k-step `kb` covers rows [16 kb, 16 kb + 16).  Transpose bit 1.
template <int D>
__device__ __forceinline__ uint64_t desc_cols(uint32_t tile, int kb) {
  return smem_desc(tile + kb * 2 * (D / 8) * 128, (D / 8) * 128, 128);
}

// before the first wgmma, and between ordinary code that touched registers
// a wgmma reads or accumulates into and that wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// keeps the compiler from moving reads or writes of accumulators across the
// asynchronous product's start and its wait
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N fp32, N / 2 registers a thread) = or += a (64 x 16 bf16, register
// fragments) . B (16 x N bf16 in shared memory by `desc`); TRANS_B = 1 when
// B's N is contiguous in memory (`desc_cols`), 0 when its K is (`desc_rows`)
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<16> {
  template <int TRANS_B>
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(TRANS_B));
  }
};

template <>
struct WgmmaRS<32> {
  template <int TRANS_B>
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(TRANS_B));
  }
};

template <>
struct WgmmaRS<48> {
  template <int TRANS_B>
  static __device__ __forceinline__ void run(float (&d)[24], const uint32_t (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, %30;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(TRANS_B));
  }
};

template <>
struct WgmmaRS<64> {
  template <int TRANS_B>
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(TRANS_B));
  }
};


template <>
struct WgmmaRS<72> {
  template <int TRANS_B>
  static __device__ __forceinline__ void run(float (&d)[36], const uint32_t (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1, %42;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(TRANS_B));
  }
};


template <>
struct WgmmaRS<128> {
  template <int TRANS_B>
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(TRANS_B));
  }
};

template <>
struct WgmmaRS<192> {
  template <int TRANS_B>
  static __device__ __forceinline__ void run(float (&d)[96], const uint32_t (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(TRANS_B));
  }
};

// d (64 x N fp32) = or += A (64 x 16 bf16) . B (16 x N bf16), both in shared
// memory by descriptor; TRANS_B as for WgmmaRS (A is always K-major)
template <int N>
struct WgmmaSS;

template <>
struct WgmmaSS<64> {
  template <int TRANS_B>
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
  }
};

template <>
struct WgmmaSS<128> {
  template <int TRANS_B>
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
  }
};

template <>
struct WgmmaSS<192> {
  template <int TRANS_B>
  static __device__ __forceinline__ void run(float (&d)[96], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, %99;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
  }
};

}  // namespace packed
