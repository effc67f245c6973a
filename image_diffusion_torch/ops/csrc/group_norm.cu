// GroupNorm, optionally followed by SiLU, forward and backward, for Hopper
// (sm_90a), on bf16 activations in channels_last memory.
//
// Replaces no TPU kernel: the JAX package's GroupNorm is plain jnp code
// (image_diffusion_tpu/models/layers.py:GroupNorm), which XLA fuses on the
// TPU.  On the card the same formula ran as about twenty ATen launches a
// norm, six full-size passes in bf16 mode, two of them in fp32, and SiLU a
// seventh; this pair takes their place wherever a GroupNorm sees a bf16
// tensor on a card (models/layers.py).
//
// Function, for a row b (one image) and a group g of C / G channels:
//
//     mean = E[x],  var = max(E[x^2] - E[x]^2, 0),  rstd = rsqrt(var + eps)
//     a[c] = w[c] * rstd,  b[c] = bias[c] - mean * a[c]
//     y    = act(x * a[c] + b[c]),  act = SiLU or the identity
//
// with the sums of x and x^2 in fp32 (per channel over the pixels, then
// per group: the JAX formula's order), the affine and SiLU in fp32
// registers, y rounded to bf16 once at the store.  The gradient recomputes
// z = x * a + b from x and the saved (mean, rstd), never stored:
//
//     dz   = dy * act'(z),  xhat = (x - mean) * rstd
//     dw   = sum_{rows, pixels} dz * xhat,   dbias = sum dz
//     c1   = E_group[w * dz],  c2 = E_group[w * dz * xhat]
//     dx   = rstd * (w * dz - c1 - xhat * c2)
//
// Bound: bytes.  The forward reads x twice and writes y, 6 bytes an element
// (3.35 TB/s: 1.8 ns per 1,000 elements); the backward reads x and dy twice
// and writes dx, 10 bytes an element.  The fp32 partial sums it adds are
// under a sixteenth of that at every shape of the shipped models.  The
// second pass of each pair starts on the rows the first pass read last,
// which L2 may still hold.  Device times against these floors, shape by
// shape: PERF.md.
//
// Design: one algorithm for every (rows, C, H*W, C/G), its tiles read from
// the shape by the host (ops/group_norm.py:tiling).  A group's C/G channels
// are an 8-64 byte run at a stride of C, so a block that walks one group
// would throw most of each sector away; instead each block takes a tile of
// P whole pixels of one row, all C channels, in 16-byte vectors: thread j of
// a pixel lane holds channels [8j, 8j + 8) for the whole tile, lanes stride
// over the tile's pixels, neighbouring threads read neighbouring addresses.
//   forward   1. stats: per (row, tile) fp32 sums of x and x^2 per group
//                (per-thread per-channel sums, then over the lanes, then
//                over the group's channels, in shared memory);
//             2. apply: combines its row's tile partials in tile order into
//                mean and rstd (written once a row for the backward when
//                asked), a and b per channel in shared memory, then y.
//   backward  1. reduce: per (row, tile) fp32 sums per channel of dz and
//                dz * xhat (for dw, dbias) and per group of w * dz and
//                w * dz * xhat (for dx);
//             2. dx: combines its row's group partials in tile order, then
//                dx;
//             3. params: dw and dbias per channel over every (row, tile)
//                partial, 32 fixed slices a channel, combined in order.
// Every reduction is a fixed-order sum of per-block partials: no atomics,
// so the outputs and gradients are the same bits on every run.
// Each entry point returns the launch's cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;       // bf16 values in one 16-byte access
constexpr int kUnroll = 4;     // forward: vectors a thread has in flight
constexpr int kUnrollBwd = 2;  // backward: vectors a thread has in flight a tensor
constexpr int kSlices = 32;    // params kernel: row slices a channel
constexpr int kMaxThreads = 256;  // a block's threads (C <= 2048)
// The backward's SiLU recomputation makes it the one pass of the pair
// that is not purely bound by bytes: three blocks an SM (85 registers a
// thread, two vectors in flight a tensor) beat two blocks with four
// (100-114 registers): 10-20% less time at the cells' SiLU shapes.
constexpr int kMinBlocksBwd = 3;

__device__ __forceinline__ void unpack(const uint4& v, float f[kVec]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint4 pack(const float f[kVec]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
}

// within a few fp32 ulps, far below the bf16 rounding of what it feeds; an
// IEEE division here made the SiLU backward bind on instructions
__device__ __forceinline__ float sigmoid(float z) { return __fdividef(1.0f, 1.0f + __expf(-z)); }

// The tile of block (t, b): pixels [p0, p1) of row b; thread (lane lp,
// vector j) reads pixels p0 + lp, p0 + lp + lanes, ... at channels 8j..8j+7.
// The second pass of each kernel pair walks the blocks in reverse (the
// last rows first), so it starts on what the first pass left in L2.
struct Tile {
  int V, lanes, j, lp, t, b, p0, p1;
  size_t row;  // index of the row's first 16-byte vector
  __device__ Tile(int HW, int C, int P, bool reverse) {
    V = C / kVec;
    lanes = blockDim.x / V;
    j = threadIdx.x % V;
    lp = threadIdx.x / V;
    t = reverse ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    b = reverse ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
    p0 = t * P;
    p1 = min(p0 + P, HW);
    row = (size_t)b * HW * V;
  }
  __device__ size_t at(int p) const { return row + (size_t)p * V + j; }
};

// Per-channel sums a thread holds -> per-channel sums of the block in
// red[0..C), summed over the lanes in lane order.  red holds lanes * C floats.
__device__ void sum_lanes(float* red, const float v[kVec], const Tile& tile, int C) {
  float4* dst = reinterpret_cast<float4*>(red + tile.lp * C + tile.j * kVec);
  dst[0] = make_float4(v[0], v[1], v[2], v[3]);
  dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = red[c];
    for (int l = 1; l < tile.lanes; ++l) s += red[l * C + c];
    red[c] = s;  // column c is read and written by this thread alone
  }
  __syncthreads();
}

// ------------------------------------------------------------ forward

__global__ void __launch_bounds__(kMaxThreads) group_norm_stats_kernel(
    const uint4* __restrict__ x, float2* __restrict__ part, int HW, int C, int G, int P, int T) {
  extern __shared__ float smem[];  // [2][lanes][C]
  const Tile tile(HW, C, P, false);
  float s[kVec] = {}, q[kVec] = {};
  for (int p = tile.p0 + tile.lp; p < tile.p1; p += tile.lanes * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pu = p + u * tile.lanes;
      v[u] = pu < tile.p1 ? __ldg(x + tile.at(pu)) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float f[kVec];
      unpack(v[u], f);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        s[i] += f[i];
        q[i] = fmaf(f[i], f[i], q[i]);  // a bf16 value's square is exact in fp32
      }
    }
  }
  float* rs = smem;
  float* rq = smem + tile.lanes * C;
  sum_lanes(rs, s, tile, C);
  sum_lanes(rq, q, tile, C);
  const int cg = C / G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float S = 0.0f, Q = 0.0f;
    for (int c = g * cg; c < (g + 1) * cg; ++c) {
      S += rs[c];
      Q += rq[c];
    }
    part[((size_t)tile.b * T + tile.t) * G + g] = make_float2(S, Q);
  }
}

// mean and rstd of group g of row b from its T tile partials, in tile order
__device__ __forceinline__ float2 row_stats(const float2* __restrict__ part, int b, int g, int G,
                                            int T, float n, float eps) {
  const float2* pp = part + (size_t)b * T * G + g;
  float S = 0.0f, Q = 0.0f;
  for (int t = 0; t < T; ++t) {
    const float2 v = pp[(size_t)t * G];
    S += v.x;
    Q += v.y;
  }
  const float mean = S / n;
  const float var = fmaxf(Q / n - mean * mean, 0.0f);  // cancellation can go below 0
  return make_float2(mean, rsqrtf(var + eps));
}

// a = w * rstd and b = bias - mean * a of channel c: the same expression in
// the forward and in both backward passes, so the recomputed pre-activation
// is the forward's to the bit
__device__ __forceinline__ float2 affine(float w, float bias, float mean, float rstd) {
  const float a = w * rstd;
  return make_float2(a, fmaf(-mean, a, bias));
}

template <bool kSilu>
__global__ void __launch_bounds__(kMaxThreads) group_norm_apply_kernel(
    const uint4* __restrict__ x, uint4* __restrict__ y, const float2* __restrict__ part,
    const float* __restrict__ weight, const float* __restrict__ bias, float* __restrict__ mean_out,
    float* __restrict__ rstd_out, int HW, int C, int G, int P, int T, float eps) {
  extern __shared__ float smem[];  // a[C], b[C], mean[G], rstd[G]
  float* sa = smem;
  float* sb = smem + C;
  float* sm = smem + 2 * C;
  float* sr = sm + G;
  const Tile tile(HW, C, P, true);
  const int cg = C / G;
  const float n = (float)cg * (float)HW;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const float2 st = row_stats(part, tile.b, g, G, T, n, eps);
    sm[g] = st.x;
    sr[g] = st.y;
    if (mean_out != nullptr && tile.t == 0) {
      mean_out[(size_t)tile.b * G + g] = st.x;
      rstd_out[(size_t)tile.b * G + g] = st.y;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float2 ab = affine(weight[c], bias[c], sm[c / cg], sr[c / cg]);
    sa[c] = ab.x;
    sb[c] = ab.y;
  }
  __syncthreads();
  float a[kVec], bb[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    a[i] = sa[tile.j * kVec + i];
    bb[i] = sb[tile.j * kVec + i];
  }
  for (int p = tile.p0 + tile.lp; p < tile.p1; p += tile.lanes * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pu = p + u * tile.lanes;
      if (pu < tile.p1) v[u] = __ldg(x + tile.at(pu));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pu = p + u * tile.lanes;
      if (pu >= tile.p1) continue;
      float f[kVec];
      unpack(v[u], f);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float z = fmaf(f[i], a[i], bb[i]);
        f[i] = kSilu ? z * sigmoid(z) : z;
      }
      y[tile.at(pu)] = pack(f);
    }
  }
}

// ------------------------------------------------------------ backward

// Per channel of a thread's vector: the forward's a and b, and the row's
// mean and rstd of the channel's group.
struct ChannelCoef {
  float a[kVec], bb[kVec], mean[kVec], rstd[kVec];
  __device__ void load(const float* __restrict__ weight, const float* __restrict__ bias,
                       const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                       int b, int c0, int cg, int G) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int c = c0 + i;
      const size_t bg = (size_t)b * G + c / cg;
      mean[i] = mean_in[bg];
      rstd[i] = rstd_in[bg];
      const float2 ab = affine(weight[c], bias[c], mean[i], rstd[i]);
      a[i] = ab.x;
      bb[i] = ab.y;
    }
  }
};

// dz = dy * act'(z) at z = x * a + b
template <bool kSilu>
__device__ __forceinline__ float grad_pre(float x, float dy, float a, float bb) {
  if (!kSilu) return dy;
  const float z = fmaf(x, a, bb);
  const float s = sigmoid(z);
  return dy * s * fmaf(z, 1.0f - s, 1.0f);
}

template <bool kSilu>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocksBwd) group_norm_bwd_reduce_kernel(
    const uint4* __restrict__ x, const uint4* __restrict__ dy, const float* __restrict__ mean_in,
    const float* __restrict__ rstd_in, const float* __restrict__ weight,
    const float* __restrict__ bias, float2* __restrict__ part_c, float2* __restrict__ part_g,
    int HW, int C, int G, int P, int T) {
  extern __shared__ float smem[];  // [2][lanes][C]
  const Tile tile(HW, C, P, false);
  const int cg = C / G;
  ChannelCoef k;
  k.load(weight, bias, mean_in, rstd_in, tile.b, tile.j * kVec, cg, G);
  float sdz[kVec] = {}, sdzx[kVec] = {};
  for (int p = tile.p0 + tile.lp; p < tile.p1; p += tile.lanes * kUnrollBwd) {
    uint4 vx[kUnrollBwd], vd[kUnrollBwd];
#pragma unroll
    for (int u = 0; u < kUnrollBwd; ++u) {
      const int pu = p + u * tile.lanes;
      const bool in = pu < tile.p1;
      vx[u] = in ? __ldg(x + tile.at(pu)) : make_uint4(0, 0, 0, 0);
      vd[u] = in ? __ldg(dy + tile.at(pu)) : make_uint4(0, 0, 0, 0);  // dy 0: adds 0
    }
#pragma unroll
    for (int u = 0; u < kUnrollBwd; ++u) {
      float fx[kVec], fd[kVec];
      unpack(vx[u], fx);
      unpack(vd[u], fd);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float dz = grad_pre<kSilu>(fx[i], fd[i], k.a[i], k.bb[i]);
        sdz[i] += dz;
        sdzx[i] = fmaf(dz, (fx[i] - k.mean[i]) * k.rstd[i], sdzx[i]);
      }
    }
  }
  float* r1 = smem;
  float* r2 = smem + tile.lanes * C;
  sum_lanes(r1, sdz, tile, C);
  sum_lanes(r2, sdzx, tile, C);
  const size_t e = (size_t)tile.b * T + tile.t;
  for (int c = threadIdx.x; c < C; c += blockDim.x) part_c[e * C + c] = make_float2(r1[c], r2[c]);
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float S1 = 0.0f, S2 = 0.0f;
    for (int c = g * cg; c < (g + 1) * cg; ++c) {
      S1 = fmaf(weight[c], r1[c], S1);
      S2 = fmaf(weight[c], r2[c], S2);
    }
    part_g[e * G + g] = make_float2(S1, S2);
  }
}

template <bool kSilu>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocksBwd) group_norm_bwd_dx_kernel(
    const uint4* __restrict__ x, const uint4* __restrict__ dy, const float* __restrict__ mean_in,
    const float* __restrict__ rstd_in, const float* __restrict__ weight,
    const float* __restrict__ bias, const float2* __restrict__ part_g, uint4* __restrict__ dx,
    int HW, int C, int G, int P, int T) {
  extern __shared__ float smem[];  // c1[G], c2[G]
  const Tile tile(HW, C, P, true);
  const int cg = C / G;
  const float n = (float)cg * (float)HW;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const float2* pp = part_g + (size_t)tile.b * T * G + g;
    float S1 = 0.0f, S2 = 0.0f;
    for (int t = 0; t < T; ++t) {
      const float2 v = pp[(size_t)t * G];
      S1 += v.x;
      S2 += v.y;
    }
    smem[g] = S1 / n;
    smem[G + g] = S2 / n;
  }
  __syncthreads();
  ChannelCoef k;
  k.load(weight, bias, mean_in, rstd_in, tile.b, tile.j * kVec, cg, G);
  // dx = a * dz - rstd * c1 - (x - mean) * rstd^2 * c2, with a = w * rstd
  float k1[kVec], k3[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int g = (tile.j * kVec + i) / cg;
    k1[i] = k.rstd[i] * smem[g];
    k3[i] = k.rstd[i] * k.rstd[i] * smem[G + g];
  }
  for (int p = tile.p0 + tile.lp; p < tile.p1; p += tile.lanes * kUnrollBwd) {
    uint4 vx[kUnrollBwd], vd[kUnrollBwd];
#pragma unroll
    for (int u = 0; u < kUnrollBwd; ++u) {
      const int pu = p + u * tile.lanes;
      if (pu < tile.p1) {
        vx[u] = __ldg(x + tile.at(pu));
        vd[u] = __ldg(dy + tile.at(pu));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnrollBwd; ++u) {
      const int pu = p + u * tile.lanes;
      if (pu >= tile.p1) continue;
      float fx[kVec], fd[kVec];
      unpack(vx[u], fx);
      unpack(vd[u], fd);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float dz = grad_pre<kSilu>(fx[i], fd[i], k.a[i], k.bb[i]);
        fd[i] = fmaf(k.a[i], dz, -fmaf(fx[i] - k.mean[i], k3[i], k1[i]));
      }
      dx[tile.at(pu)] = pack(fd);
    }
  }
}

// dw[c] and dbias[c] over the E = rows * T partials of channel c: slice s of
// 32 sums partials s, s + 32, ... in order, then the slices in order.
__global__ void __launch_bounds__(32 * kSlices) group_norm_bwd_params_kernel(
    const float2* __restrict__ part_c, float* __restrict__ dweight, float* __restrict__ dbias,
    int E, int C) {
  __shared__ float2 red[kSlices][33];
  const int lane = threadIdx.x, s = threadIdx.y;
  const int c = blockIdx.x * 32 + lane;
  float sdz = 0.0f, sdzx = 0.0f;
  if (c < C) {
#pragma unroll 4
    for (int e = s; e < E; e += kSlices) {
      const float2 v = part_c[(size_t)e * C + c];
      sdz += v.x;
      sdzx += v.y;
    }
  }
  red[s][lane] = make_float2(sdz, sdzx);
  __syncthreads();
  if (s == 0 && c < C) {
    for (int i = 1; i < kSlices; ++i) {
      sdz += red[i][lane].x;
      sdzx += red[i][lane].y;
    }
    dweight[c] = sdzx;
    dbias[c] = sdz;
  }
}

bool bad_shape(int B, int HW, int C, int G, int P, int T, int threads) {
  return B <= 0 || B > 65535 || HW <= 0 || C <= 0 || C % kVec || G <= 0 || C % G ||
         P <= 0 || T <= 0 || T > 65535 || (long long)P * T < HW || (long long)P * (T - 1) >= HW ||
         threads <= 0 || threads % (C / kVec) || threads > kMaxThreads || (long long)(C / G) * HW > (1 << 24);
}

}  // namespace

// y = act(GroupNorm(x)) on (B, H*W, C) bf16; part: fp32 scratch of
// B * T * G float2; mean, rstd: B * G fp32 each, or both null.
extern "C" int group_norm_forward(const void* x, void* y, void* mean, void* rstd,
                                  const void* weight, const void* bias, void* part, int B, int HW,
                                  int C, int G, int P, int T, int threads, float eps, int silu,
                                  void* stream) {
  if (bad_shape(B, HW, C, G, P, T, threads) || (mean == nullptr) != (rstd == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(T, B);
  const int lanes = threads / (C / kVec);
  group_norm_stats_kernel<<<grid, threads, 2 * lanes * C * sizeof(float), s>>>(
      static_cast<const uint4*>(x), static_cast<float2*>(part), HW, C, G, P, T);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (2 * C + 2 * G) * sizeof(float);
  const auto* ux = static_cast<const uint4*>(x);
  auto* uy = static_cast<uint4*>(y);
  const auto* pp = static_cast<const float2*>(part);
  const auto* fw = static_cast<const float*>(weight);
  const auto* fb = static_cast<const float*>(bias);
  auto* fm = static_cast<float*>(mean);
  auto* fr = static_cast<float*>(rstd);
  if (silu)
    group_norm_apply_kernel<true><<<grid, threads, smem, s>>>(ux, uy, pp, fw, fb, fm, fr, HW, C, G,
                                                              P, T, eps);
  else
    group_norm_apply_kernel<false><<<grid, threads, smem, s>>>(ux, uy, pp, fw, fb, fm, fr, HW, C,
                                                               G, P, T, eps);
  return (int)cudaGetLastError();
}

// dx, dweight, dbias of act(GroupNorm(x)) from dy, x and the forward's mean
// and rstd; part_c: B * T * C float2, part_g: B * T * G float2 of scratch.
extern "C" int group_norm_backward(const void* x, const void* dy, const void* mean,
                                   const void* rstd, const void* weight, const void* bias,
                                   void* dx, void* dweight, void* dbias, void* part_c,
                                   void* part_g, int B, int HW, int C, int G, int P, int T,
                                   int threads, int silu, void* stream) {
  if (bad_shape(B, HW, C, G, P, T, threads)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(T, B);
  const int lanes = threads / (C / kVec);
  const auto* ux = static_cast<const uint4*>(x);
  const auto* udy = static_cast<const uint4*>(dy);
  const auto* fm = static_cast<const float*>(mean);
  const auto* fr = static_cast<const float*>(rstd);
  const auto* fw = static_cast<const float*>(weight);
  const auto* fb = static_cast<const float*>(bias);
  auto* pc = static_cast<float2*>(part_c);
  auto* pg = static_cast<float2*>(part_g);
  const size_t smem_reduce = 2 * lanes * C * sizeof(float);
  if (silu)
    group_norm_bwd_reduce_kernel<true><<<grid, threads, smem_reduce, s>>>(ux, udy, fm, fr, fw, fb,
                                                                         pc, pg, HW, C, G, P, T);
  else
    group_norm_bwd_reduce_kernel<false><<<grid, threads, smem_reduce, s>>>(ux, udy, fm, fr, fw, fb,
                                                                          pc, pg, HW, C, G, P, T);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem_dx = 2 * G * sizeof(float);
  auto* udx = static_cast<uint4*>(dx);
  if (silu)
    group_norm_bwd_dx_kernel<true><<<grid, threads, smem_dx, s>>>(ux, udy, fm, fr, fw, fb, pg, udx,
                                                                  HW, C, G, P, T);
  else
    group_norm_bwd_dx_kernel<false><<<grid, threads, smem_dx, s>>>(ux, udy, fm, fr, fw, fb, pg, udx,
                                                                   HW, C, G, P, T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  group_norm_bwd_params_kernel<<<(C + 31) / 32, dim3(32, kSlices), 0, s>>>(
      pc, static_cast<float*>(dweight), static_cast<float*>(dbias), B * T, C);
  return (int)cudaGetLastError();
}
