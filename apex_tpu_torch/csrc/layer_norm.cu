// LayerNorm and RMSNorm, forward and backward, for Hopper (sm_90a).
//
// Replace two TPU kernels of apex_tpu/ops/layer_norm.py:
//   _fwd_2d (:118, body _ln_fwd_kernel :63)
//   _bwd_2d (:135, body _ln_bwd_kernel :77)
// over a (rows, h) view of the input, h a multiple of 128 up to 32768
// (the reference's gate, _use_pallas); x and dy in f32 or bf16, the
// weight and bias in f32 or bf16 (one dtype for both), statistics and
// every sum in f32.  BERT-Large runs them at (4096, 1024) bf16, 49 times
// each a step.
//
// What bounds them: bytes.  A row of h elements costs a few f32
// operations per element against 2-4 bytes moved, far below the card's
// ~20 operations per byte, so the least time is reading x (and dy) once
// and writing y (dx) once at 3.35 TB/s.
//
// Design.  The TPU kernel normalises a block of rows in VMEM and, in the
// backward, adds each block's dw/db into one (1, h) accumulator across
// its in-order grid.  Here:
// - forward, two bodies, routed by the Python wrapper (`fwd_route`) on
//   shape and layout, both hand-written:
//   * register (h a multiple of 8 up to FUSED_MAX_H = 8192, x 16-byte
//     aligned): the fused backward's layout.  A persistent grid (as many
//     256-thread CTAs as the SMs hold at once) walks equal chunks of
//     rows, GROUP threads to a row (one warp while the row fits 4
//     vectors a thread: h <= 1024 in bf16, 512 in f32; then 64 .. 256),
//     the row in registers from 16-byte loads, the next row's loads
//     issued before this row's sums, w and b read once a CTA into the
//     lanes that own their columns; mean and centred variance through
//     the shuffle tree (and, past a warp, the group's warps in a fixed
//     order), y written once with 16-byte stores.  (4096, 1024) bf16
//     reads 8.4 MB and writes 8.4 MB: 5.0 us at 3.35 TB/s.
//   * wide (any other h or row start): one 256-thread block per row;
//     three passes over the row (mean, centred sum of squares, output),
//     the later ones from L1/L2, scalar loads;
// - backward, two bodies, routed by the Python wrapper (`bwd_route`) on
//   shape and layout, both hand-written (a dispatch, not a fallback):
//   * fused (h a multiple of 8 up to FUSED_MAX_H = 8192, x, dy and dx
//     16-byte aligned): two launches that read x and dy once.  A CTA of
//     256 threads walks a fixed chunk of rows (`rows_per_chunk`, a
//     function of the row count alone: 32 at 4096 rows), GROUP threads
//     to a row (32 while the row fits 4 vectors a thread, then 64 ..
//     256), 256 / GROUP rows at a time.  Each thread holds its vectors of
//     the row in registers (16-byte loads: 8 bf16 or 4 f32, NV of them),
//     and the next row's loads are issued before this row's sums; the
//     mean, rstd, mean(dy*w) and mean(dy*w*xhat) come from registers
//     through warp-shuffle trees and, past one warp, a fixed-order sum of
//     the group's warps in shared memory; dx is written once.  dy*xhat
//     and dy are summed per column in registers across the CTA's rows
//     (the thread owns the same columns in every row); the CTA's row
//     groups meet in a fixed tree through shared memory (lanes on
//     neighbouring words) and each CTA writes one f32 partial row of dw
//     and of db.  The registers bound the row: at most 8 vectors a
//     thread of 256 threads (8192 columns of f32, 16384 of bf16; the
//     limit is stated as 8192 for both).  (4096, 1024) bf16 reads 16.8
//     MB, writes 8.4 MB of dx and 1 MB of partials: 7.8 us at 3.35 TB/s.
//   * three launches (wider rows or an unaligned x or dy): (1) one block
//     per row recomputes mean and rstd (the reference recomputes the
//     statistics rather than saving them), writes dx and leaves the two
//     per-row statistics in a small scratch; (2) a column kernel gives
//     each thread one column and a fixed chunk of rows and writes that
//     chunk's partial dw/db.  Its loads are scalar and coalesced across
//     the block, so any row start is accepted; it reads x four times
//     and dy twice in (1), both again in (2).
//   Both end in the combine: 32 columns a CTA, each column's partials
//   summed by 8 threads in a fixed stride and the 8 sums added in
//   order.  No atomics: the bits are the same every run.
//
// Arithmetic is in the reference body's order with explicit roundings:
// mean = sum / h, var = sum((x - mean)^2) / h, rstd = 1 / sqrt(var + eps)
// (both IEEE-rounded, where the reference's lax.rsqrt may round
// otherwise), y = xhat * w + b; dx = (dy*w - mean(dy*w) - xhat *
// mean(dy*w*xhat)) * rstd, RMS without the centring and the first mean.
// Row sums go through a fixed shuffle tree, so they are reproducible but
// not in the twin's order: the twins agree within a tolerance.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int ROW_THREADS = 256;
constexpr int COL_THREADS = 256;

enum Dtype { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float load1(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store1(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// Sum of `a` (and `b`) over the block in a fixed order; every thread gets
// the totals.  `sh` holds 2 x 33 floats.
__device__ __forceinline__ float2 block_allsum2(float a, float b, float* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sh[warp] = a;
    sh[33 + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    a = lane < n_warps ? sh[lane] : 0.f;
    b = lane < n_warps ? sh[33 + lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    if (lane == 0) {
      sh[32] = a;
      sh[65] = b;
    }
  }
  __syncthreads();
  const float2 r = make_float2(sh[32], sh[65]);
  __syncthreads();                 // sh is free again for the next sum
  return r;
}

// mean (0 for RMS) and rstd of one row.
template <typename X, bool RMS>
__device__ __forceinline__ float2 row_stats(const X* __restrict__ xr, int h,
                                            float eps, float* sh) {
  const float hf = static_cast<float>(h);
  float mu = 0.f;
  if (!RMS) {
    float s = 0.f;
    for (int j = threadIdx.x; j < h; j += blockDim.x) s = __fadd_rn(s, load1(xr, j));
    mu = __fdiv_rn(block_allsum2(s, 0.f, sh).x, hf);
  }
  float s = 0.f;
  for (int j = threadIdx.x; j < h; j += blockDim.x) {
    const float d = RMS ? load1(xr, j) : __fsub_rn(load1(xr, j), mu);
    s = __fadd_rn(s, __fmul_rn(d, d));
  }
  const float var = __fdiv_rn(block_allsum2(s, 0.f, sh).x, hf);
  return make_float2(mu, __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps))));
}

template <typename X, typename W, bool RMS>
__global__ void __launch_bounds__(ROW_THREADS)
ln_fwd_kernel(const X* __restrict__ x, const W* __restrict__ w,
              const W* __restrict__ b, X* __restrict__ y, int h, float eps) {
  __shared__ float sh[66];
  const int64_t off = static_cast<int64_t>(blockIdx.x) * h;
  const float2 stats = row_stats<X, RMS>(x + off, h, eps, sh);
  for (int j = threadIdx.x; j < h; j += blockDim.x) {
    const float xv = load1(x, off + j);
    const float d = RMS ? xv : __fsub_rn(xv, stats.x);
    const float r = __fmul_rn(__fmul_rn(d, stats.y), load1(w, j));
    store1(y, off + j, __fadd_rn(r, load1(b, j)));
  }
}

template <typename X, typename W, bool RMS>
__global__ void __launch_bounds__(ROW_THREADS)
ln_bwd_dx_kernel(const X* __restrict__ x, const W* __restrict__ w,
                 const X* __restrict__ dy, X* __restrict__ dx,
                 float* __restrict__ mean_out, float* __restrict__ rstd_out,
                 int h, float eps) {
  __shared__ float sh[66];
  const int64_t off = static_cast<int64_t>(blockIdx.x) * h;
  const float2 stats = row_stats<X, RMS>(x + off, h, eps, sh);
  const float mu = stats.x, rstd = stats.y, hf = static_cast<float>(h);
  float s1 = 0.f, s2 = 0.f;
  for (int j = threadIdx.x; j < h; j += blockDim.x) {
    const float xv = load1(x, off + j);
    const float xhat = __fmul_rn(RMS ? xv : __fsub_rn(xv, mu), rstd);
    const float dyw = __fmul_rn(load1(dy, off + j), load1(w, j));
    if (!RMS) s1 = __fadd_rn(s1, dyw);
    s2 = __fadd_rn(s2, __fmul_rn(dyw, xhat));
  }
  const float2 sums = block_allsum2(s1, s2, sh);
  const float m1 = __fdiv_rn(sums.x, hf), m2 = __fdiv_rn(sums.y, hf);
  for (int j = threadIdx.x; j < h; j += blockDim.x) {
    const float xv = load1(x, off + j);
    const float xhat = __fmul_rn(RMS ? xv : __fsub_rn(xv, mu), rstd);
    const float dyw = __fmul_rn(load1(dy, off + j), load1(w, j));
    const float c = RMS ? dyw : __fsub_rn(dyw, m1);
    store1(dx, off + j, __fmul_rn(__fsub_rn(c, __fmul_rn(xhat, m2)), rstd));
  }
  if (threadIdx.x == 0) {
    mean_out[blockIdx.x] = mu;
    rstd_out[blockIdx.x] = rstd;
  }
}

// One thread per column, one grid row per chunk of `rows_per_chunk` rows:
// the chunk's sums of dy * xhat and dy, from the saved statistics.
template <typename X, bool RMS>
__global__ void __launch_bounds__(COL_THREADS)
ln_bwd_partial_kernel(const X* __restrict__ x, const X* __restrict__ dy,
                      const float* __restrict__ mean,
                      const float* __restrict__ rstd,
                      float* __restrict__ part_w, float* __restrict__ part_b,
                      int64_t rows, int h, int rows_per_chunk) {
  const int col = blockIdx.x * COL_THREADS + threadIdx.x;
  if (col >= h) return;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * rows_per_chunk;
  const int64_t r1 = r0 + rows_per_chunk < rows ? r0 + rows_per_chunk : rows;
  float aw = 0.f, ab = 0.f;
  for (int64_t r = r0; r < r1; ++r) {
    const int64_t i = r * h + col;
    const float xv = load1(x, i);
    const float xhat = __fmul_rn(RMS ? xv : __fsub_rn(xv, mean[r]), rstd[r]);
    const float d = load1(dy, i);
    aw = __fadd_rn(aw, __fmul_rn(d, xhat));
    ab = __fadd_rn(ab, d);
  }
  const int64_t o = static_cast<int64_t>(blockIdx.y) * h + col;
  part_w[o] = aw;
  part_b[o] = ab;
}

// 16 bytes of x-type values: loaded raw (Raw<X>, four registers), then
// unpacked to f32 (8 bf16 or 4 f32); and f32 stored back as 16 bytes.
template <typename X> struct Raw;
template <> struct Raw<float> { using type = float4; };
template <> struct Raw<__nv_bfloat16> { using type = uint4; };

template <typename X>
__device__ __forceinline__ typename Raw<X>::type load_raw(const X* p,
                                                          int64_t v) {
  using R = typename Raw<X>::type;
  return __ldg(reinterpret_cast<const R*>(p) + v);
}
__device__ __forceinline__ void unpack(const float4& u, float* o) {
  o[0] = u.x; o[1] = u.y; o[2] = u.z; o[3] = u.w;
}
__device__ __forceinline__ void unpack(const uint4& u, float* o) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    o[2 * j] = f.x;
    o[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void store_vec(float* p, int64_t v, const float* o) {
  reinterpret_cast<float4*>(p)[v] = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, int64_t v,
                                          const float* o) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(o[2 * j], o[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&b);
  }
  reinterpret_cast<uint4*>(p)[v] = make_uint4(w[0], w[1], w[2], w[3]);
}

constexpr int FUSED_THREADS = 256;
constexpr int FUSED_MAX_H = 8192;

// Sum of `a` and `b` over the `group` threads of a row group (a power of
// two, 32 .. FUSED_THREADS, whole warps) in a fixed order; every thread
// of the group gets the totals.  `sh` is this reduction's slot, 2 x 8
// floats: three slots used in turn keep one __syncthreads a sum safe
// (a slot is written again only after the next sum's barrier, which
// every thread reaches after it read the slot).
__device__ __forceinline__ float2 group_sum2(float a, float b, int group,
                                             float* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if (group == 32) return make_float2(a, b);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sh[warp] = a;
    sh[8 + warp] = b;
  }
  __syncthreads();
  const int w0 = warp & ~(group / 32 - 1);       // the group's first warp
  a = b = 0.f;
  for (int j = 0; j < group / 32; ++j) {
    a = __fadd_rn(a, sh[w0 + j]);
    b = __fadd_rn(b, sh[8 + w0 + j]);
  }
  return make_float2(a, b);
}

// The register forward: y of every row of the CTA's chunk of rows, x read
// once with 16-byte loads and y written once with 16-byte stores.  NV
// vectors of E values a thread a row (thread t of its group owns vectors
// t, t + group, ...: a warp's loads of a row are 512 contiguous bytes);
// w and b are read once a CTA into the registers of the lanes that own
// those columns; the next row's loads are in flight while this row's
// sums run.  The group's sums alternate between two shared-memory slots
// (`red`), so one barrier a sum keeps them safe.
template <typename X, typename W, bool RMS, int NV>
__global__ void __launch_bounds__(FUSED_THREADS)
ln_fwd_reg_kernel(const X* __restrict__ x, const W* __restrict__ w,
                  const W* __restrict__ b, X* __restrict__ y, int64_t rows,
                  int h, int group, int64_t rows_per_cta, float eps) {
  constexpr int E = 16 / sizeof(X);
  __shared__ float red[2][16];
  const int groups = FUSED_THREADS / group;
  const int g = threadIdx.x / group, t = threadIdx.x % group;
  const int nvec = h / E;
  const float hf = static_cast<float>(h);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_cta;
  const int64_t r1 = r0 + rows_per_cta < rows ? r0 + rows_per_cta : rows;

  using R = typename Raw<X>::type;
  R px[NV];
  const auto fetch = [&](int64_t r) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = t + i * group;
      px[i] = (r < r1 && v < nvec) ? load_raw(x + r * h, v) : R{};
    }
  };
  fetch(r0 + g);
  float wv[NV][E], bv[NV][E];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = t + i * group;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int64_t c = static_cast<int64_t>(v) * E + e;
      wv[i][e] = v < nvec ? load1(w, c) : 0.f;
      bv[i][e] = v < nvec ? load1(b, c) : 0.f;
    }
  }

  int slot = 0;
  for (int64_t base = r0; base < r1; base += groups) {
    const int64_t r = base + g;
    float xv[NV][E];
#pragma unroll
    for (int i = 0; i < NV; ++i) unpack(px[i], xv[i]);
    fetch(r + groups);
    float mu = 0.f;
    if (!RMS) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e) s = __fadd_rn(s, xv[i][e]);
      mu = __fdiv_rn(group_sum2(s, 0.f, group, red[slot]).x, hf);
      slot ^= 1;
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (t + i * group >= nvec) continue;       // padding: no (0 - mu)^2
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = RMS ? xv[i][e] : __fsub_rn(xv[i][e], mu);
        s = __fadd_rn(s, __fmul_rn(d, d));
      }
    }
    const float var = __fdiv_rn(group_sum2(s, 0.f, group, red[slot]).x, hf);
    slot ^= 1;
    const float rstd = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
    if (r >= r1) continue;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = t + i * group;
      if (v >= nvec) continue;
      float o[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = RMS ? xv[i][e] : __fsub_rn(xv[i][e], mu);
        o[e] = __fadd_rn(__fmul_rn(__fmul_rn(d, rstd), wv[i][e]), bv[i][e]);
      }
      store_vec(y + r * h, v, o);
    }
  }
}

// The fused backward: dx of every row of the CTA's chunk, and the chunk's
// partial dw (sum of dy * xhat) and db (sum of dy), reading x and dy
// once.  NV vectors of E values a thread a row; thread t of its group
// owns vectors t, t + group, ...
template <typename X, typename W, bool RMS, int NV>
__global__ void __launch_bounds__(FUSED_THREADS)
ln_bwd_fused_kernel(const X* __restrict__ x, const W* __restrict__ w,
                    const X* __restrict__ dy, X* __restrict__ dx,
                    float* __restrict__ part_w, float* __restrict__ part_b,
                    int64_t rows, int h, int group, int rows_per_chunk,
                    float eps) {
  constexpr int E = 16 / sizeof(X);
  __shared__ float red[3][16];
  extern __shared__ float comb[];   // the tree's slots when groups > 1
  const int groups = FUSED_THREADS / group;
  const int g = threadIdx.x / group, t = threadIdx.x % group;
  const int nvec = h / E;
  const float hf = static_cast<float>(h);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_chunk;
  const int64_t r1 = r0 + rows_per_chunk < rows ? r0 + rows_per_chunk : rows;

  // this thread's vectors of a row, raw (zeros past the chunk or the
  // row): the next row's loads are in flight while this row's sums run
  using R = typename Raw<X>::type;
  R px[NV], pdy[NV];
  const auto fetch = [&](int64_t r) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = t + i * group;
      if (r < r1 && v < nvec) {
        px[i] = load_raw(x + r * h, v);
        pdy[i] = load_raw(dy + r * h, v);
      } else {
        px[i] = pdy[i] = R{};
      }
    }
  };
  fetch(r0 + g);
  float wv[NV][E], aw[NV][E], ab[NV][E];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = t + i * group;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      wv[i][e] = v < nvec ? load1(w, static_cast<int64_t>(v) * E + e) : 0.f;
      aw[i][e] = ab[i][e] = 0.f;
    }
  }

  for (int64_t base = r0; base < r1; base += groups) {
    const int64_t r = base + g;
    const bool live = r < r1;
    float xv[NV][E], dv[NV][E];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      unpack(px[i], xv[i]);
      unpack(pdy[i], dv[i]);
    }
    fetch(r + groups);
    float mu = 0.f;
    if (!RMS) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e) s = __fadd_rn(s, xv[i][e]);
      mu = __fdiv_rn(group_sum2(s, 0.f, group, red[0]).x, hf);
    }
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (t + i * group >= nvec) continue;       // padding: no (0 - mu)^2
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = RMS ? xv[i][e] : __fsub_rn(xv[i][e], mu);
        s = __fadd_rn(s, __fmul_rn(d, d));
      }
    }
    const float var = __fdiv_rn(group_sum2(s, 0.f, group, red[1]).x, hf);
    const float rstd = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        xv[i][e] = __fmul_rn(RMS ? xv[i][e] : __fsub_rn(xv[i][e], mu), rstd);
        const float dyw = __fmul_rn(dv[i][e], wv[i][e]);
        if (!RMS) s1 = __fadd_rn(s1, dyw);
        s2 = __fadd_rn(s2, __fmul_rn(dyw, xv[i][e]));
      }
    const float2 sums = group_sum2(s1, s2, group, red[2]);
    const float m1 = __fdiv_rn(sums.x, hf), m2 = __fdiv_rn(sums.y, hf);
    if (!live) continue;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = t + i * group;
      if (v >= nvec) continue;
      float o[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float dyw = __fmul_rn(dv[i][e], wv[i][e]);
        const float c = RMS ? dyw : __fsub_rn(dyw, m1);
        o[e] = __fmul_rn(__fsub_rn(c, __fmul_rn(xv[i][e], m2)), rstd);
        aw[i][e] = __fadd_rn(aw[i][e], __fmul_rn(dv[i][e], xv[i][e]));
        ab[i][e] = __fadd_rn(ab[i][e], dv[i][e]);
      }
      store_vec(dx + r * h, v, o);
    }
  }

  // the row groups' column sums meet in a fixed tree: in each round the
  // upper half of the groups still in play hands its sums through shared
  // memory (element (i * E + e) * group + t of its slot: lanes on
  // neighbouring words) to the lower half; group 0 writes the chunk's
  // partial rows from its registers
  for (int half = groups / 2; half > 0; half /= 2) {
    float* slot = comb + static_cast<size_t>(g % half) * 2 * NV * E * group;
    if (g >= half && g < 2 * half) {
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          slot[(i * E + e) * group + t] = aw[i][e];
          slot[((NV + i) * E + e) * group + t] = ab[i][e];
        }
    }
    __syncthreads();
    if (g < half) {
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          aw[i][e] = __fadd_rn(aw[i][e], slot[(i * E + e) * group + t]);
          ab[i][e] = __fadd_rn(ab[i][e], slot[((NV + i) * E + e) * group + t]);
        }
    }
    __syncthreads();
  }
  if (g != 0) return;
  float* pw = part_w + static_cast<int64_t>(blockIdx.x) * h;
  float* pb = part_b + static_cast<int64_t>(blockIdx.x) * h;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = t + i * group;
    if (v >= nvec) continue;
#pragma unroll
    for (int j = 0; j < E / 4; ++j) {            // E / 4 float4 a vector
      store_vec(pw, v * (E / 4) + j, aw[i] + 4 * j);
      store_vec(pb, v * (E / 4) + j, ab[i] + 4 * j);
    }
  }
}

// dw, db: the partial rows of `n_chunks` chunks summed per column in a
// fixed order (8 threads a column, each over chunks s, s + 8, ...; then
// the 8 sums in order).  32 columns a CTA.
constexpr int COMB_COLS = 32;
constexpr int COMB_SLICES = 8;

__global__ void __launch_bounds__(COMB_COLS * COMB_SLICES)
ln_bwd_combine_kernel(const float* __restrict__ part_w,
                      const float* __restrict__ part_b, int n_chunks, int h,
                      float* __restrict__ dw, float* __restrict__ db) {
  __shared__ float sw[COMB_SLICES][COMB_COLS], sb[COMB_SLICES][COMB_COLS];
  const int lane = threadIdx.x % COMB_COLS, slice = threadIdx.x / COMB_COLS;
  const int col = blockIdx.x * COMB_COLS + lane;
  float aw = 0.f, ab = 0.f;
  if (col < h) {
    for (int c = slice; c < n_chunks; c += COMB_SLICES) {
      aw = __fadd_rn(aw, part_w[static_cast<int64_t>(c) * h + col]);
      ab = __fadd_rn(ab, part_b[static_cast<int64_t>(c) * h + col]);
    }
  }
  sw[slice][lane] = aw;
  sb[slice][lane] = ab;
  __syncthreads();
  if (slice == 0 && col < h) {
    for (int j = 1; j < COMB_SLICES; ++j) {
      aw = __fadd_rn(aw, sw[j][lane]);
      ab = __fadd_rn(ab, sb[j][lane]);
    }
    dw[col] = aw;
    db[col] = ab;
  }
}

// The register forward's launch: a persistent grid of as many CTAs as
// the SMs hold at once (at most one a row group's worth of rows), each
// walking an equal chunk of rows.
template <typename X, typename W, bool RMS, int NV>
int launch_fwd_reg(const X* x, const W* w, const W* b, X* y, long long rows,
                   int h, int group, float eps, cudaStream_t st) {
  static int resident = 0;                     // CTAs the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ln_fwd_reg_kernel<X, W, RMS, NV>, FUSED_THREADS, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long groups = FUSED_THREADS / group;
  const long long need = (rows + groups - 1) / groups;
  const long long ctas = need < resident ? need : resident;
  const long long per_cta = (rows + ctas - 1) / ctas;
  ln_fwd_reg_kernel<X, W, RMS, NV><<<static_cast<unsigned>((rows + per_cta - 1) / per_cta),
                                     FUSED_THREADS, 0, st>>>(
      x, w, b, y, rows, h, group, per_cta, eps);
  return static_cast<int>(cudaGetLastError());
}

// The register forward's geometry, the fused backward's: `group` threads
// to a row, the fewest (from one warp) that keep a thread at 4 vectors
// or fewer, then NV the vectors a thread, a power of two (8 only for f32
// rows past 4096).
template <typename X, typename W, bool RMS>
int launch_fwd_reg_nv(const X* x, const W* w, const W* b, X* y,
                      long long rows, int h, float eps, cudaStream_t st) {
  constexpr int E = 16 / sizeof(X);
  const int nvec = h / E;
  int group = 32;
  while (group < FUSED_THREADS && 4 * group < nvec) group *= 2;
  const int need = (nvec + group - 1) / group;
  if (need <= 1) return launch_fwd_reg<X, W, RMS, 1>(x, w, b, y, rows, h, group, eps, st);
  if (need <= 2) return launch_fwd_reg<X, W, RMS, 2>(x, w, b, y, rows, h, group, eps, st);
  if (need <= 4) return launch_fwd_reg<X, W, RMS, 4>(x, w, b, y, rows, h, group, eps, st);
  if constexpr (E == 4) return launch_fwd_reg<X, W, RMS, 8>(x, w, b, y, rows, h, group, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename X, typename W>
int launch_fwd(const void* x, const void* w, const void* b, void* y,
               long long rows, int h, float eps, bool rms, bool reg,
               cudaStream_t st) {
  const X* xx = static_cast<const X*>(x);
  const W* ww = static_cast<const W*>(w);
  const W* bb = static_cast<const W*>(b);
  X* yy = static_cast<X*>(y);
  if (reg) {                    // the register body: 16-byte rows in registers
    constexpr int E = 16 / sizeof(X);
    const bool ok = h % E == 0 && h <= FUSED_MAX_H &&
                    (reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(y)) % 16 == 0;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    return rms ? launch_fwd_reg_nv<X, W, true>(xx, ww, bb, yy, rows, h, eps, st)
               : launch_fwd_reg_nv<X, W, false>(xx, ww, bb, yy, rows, h, eps, st);
  }
  if (rms) {
    ln_fwd_kernel<X, W, true><<<static_cast<unsigned>(rows), ROW_THREADS, 0, st>>>(xx, ww, bb, yy, h, eps);
  } else {
    ln_fwd_kernel<X, W, false><<<static_cast<unsigned>(rows), ROW_THREADS, 0, st>>>(xx, ww, bb, yy, h, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename X, typename W, bool RMS, int NV>
void launch_fused(const X* x, const W* w, const X* dy, X* dx, float* part_w,
                  float* part_b, long long rows, int h, int group,
                  int rows_per_chunk, int n_chunks, float eps,
                  cudaStream_t st) {
  // groups / 2 slots of 2 x NV x E x group floats
  constexpr int E = 16 / sizeof(X);
  const size_t smem = group < FUSED_THREADS
                          ? sizeof(float) * NV * E * FUSED_THREADS : 0;
  ln_bwd_fused_kernel<X, W, RMS, NV><<<n_chunks, FUSED_THREADS, smem, st>>>(
      x, w, dy, dx, part_w, part_b, rows, h, group, rows_per_chunk, eps);
}

// The fused body's geometry: `group` threads to a row, the fewest (from
// one warp) that keep a thread at 4 vectors or fewer, then NV the
// vectors a thread, a power of two (8 only for f32 rows past 4096).
template <typename X, typename W, bool RMS>
int launch_fused_nv(const X* x, const W* w, const X* dy, X* dx,
                    float* part_w, float* part_b, long long rows, int h,
                    int rows_per_chunk, int n_chunks, float eps,
                    cudaStream_t st) {
  constexpr int E = 16 / sizeof(X);
  const int nvec = h / E;
  int group = 32;
  while (group < FUSED_THREADS && 4 * group < nvec) group *= 2;
  const int need = (nvec + group - 1) / group;
  const auto run = [&](auto nv) {
    launch_fused<X, W, RMS, decltype(nv)::value>(
        x, w, dy, dx, part_w, part_b, rows, h, group, rows_per_chunk,
        n_chunks, eps, st);
  };
  if (need <= 1) run(std::integral_constant<int, 1>());
  else if (need <= 2) run(std::integral_constant<int, 2>());
  else if (need <= 4) run(std::integral_constant<int, 4>());
  else if constexpr (E == 4) run(std::integral_constant<int, 8>());
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename X, typename W>
int launch_bwd(const void* x, const void* w, const void* dy, void* dx,
               float* mean, float* rstd, float* part_w, float* part_b,
               float* dw, float* db, long long rows, int h, float eps,
               bool rms, int rows_per_chunk, int n_chunks, cudaStream_t st) {
  const X* xx = static_cast<const X*>(x);
  const W* ww = static_cast<const W*>(w);
  const X* dyy = static_cast<const X*>(dy);
  X* dxx = static_cast<X*>(dx);
  cudaError_t err;
  if (mean == nullptr) {                 // the fused body: no row statistics
    constexpr int E = 16 / sizeof(X);
    const bool ok = h % E == 0 && h <= FUSED_MAX_H && rstd == nullptr &&
                    (reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(dy) |
                     reinterpret_cast<uintptr_t>(dx) |
                     reinterpret_cast<uintptr_t>(part_w) |
                     reinterpret_cast<uintptr_t>(part_b)) % 16 == 0;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    const int rc =
        rms ? launch_fused_nv<X, W, true>(xx, ww, dyy, dxx, part_w, part_b,
                                          rows, h, rows_per_chunk, n_chunks,
                                          eps, st)
            : launch_fused_nv<X, W, false>(xx, ww, dyy, dxx, part_w, part_b,
                                           rows, h, rows_per_chunk, n_chunks,
                                           eps, st);
    if (rc != 0) return rc;
  } else {
    if (rms) {
      ln_bwd_dx_kernel<X, W, true><<<static_cast<unsigned>(rows), ROW_THREADS, 0, st>>>(
          xx, ww, dyy, dxx, mean, rstd, h, eps);
    } else {
      ln_bwd_dx_kernel<X, W, false><<<static_cast<unsigned>(rows), ROW_THREADS, 0, st>>>(
          xx, ww, dyy, dxx, mean, rstd, h, eps);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((h + COL_THREADS - 1) / COL_THREADS, n_chunks);
    if (rms) {
      ln_bwd_partial_kernel<X, true><<<grid, COL_THREADS, 0, st>>>(
          xx, dyy, mean, rstd, part_w, part_b, rows, h, rows_per_chunk);
    } else {
      ln_bwd_partial_kernel<X, false><<<grid, COL_THREADS, 0, st>>>(
          xx, dyy, mean, rstd, part_w, part_b, rows, h, rows_per_chunk);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ln_bwd_combine_kernel<<<(h + COMB_COLS - 1) / COMB_COLS,
                          COMB_COLS * COMB_SLICES, 0, st>>>(
      part_w, part_b, n_chunks, h, dw, db);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`,
// allocates nothing (the wrapper passes outputs and scratch), and returns
// cudaGetLastError() after its launches (0 when they were accepted).
// Dtype codes: 0 float32, 1 bfloat16.  `rows` blocks of the row kernels
// must fit the grid (< 2^31); the wrapper checks.

// y = norm(x) * w + b (RMS: the reference's zero bias).  `reg` 1 asks
// for the register body (h a multiple of 8 up to 8192, x and y 16-byte
// aligned; anything else is refused with cudaErrorInvalidValue), 0 for
// the block-a-row body (any h, any row start).
extern "C" int apex_layer_norm_fwd(const void* x, int x_dtype, const void* w,
                                   const void* b, int w_dtype, void* y,
                                   long long rows, int h, float eps, int rms,
                                   int reg, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool r = rms != 0, v = reg != 0;
  if (x_dtype == F32 && w_dtype == F32)
    return launch_fwd<float, float>(x, w, b, y, rows, h, eps, r, v, st);
  if (x_dtype == F32 && w_dtype == BF16)
    return launch_fwd<float, __nv_bfloat16>(x, w, b, y, rows, h, eps, r, v, st);
  if (x_dtype == BF16 && w_dtype == F32)
    return launch_fwd<__nv_bfloat16, float>(x, w, b, y, rows, h, eps, r, v, st);
  if (x_dtype == BF16 && w_dtype == BF16)
    return launch_fwd<__nv_bfloat16, __nv_bfloat16>(x, w, b, y, rows, h, eps, r,
                                                    v, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward into dx (x's dtype) and dw, db (f32).  With `mean` and
// `rstd` null, the fused body: two launches (dx and each chunk's dw/db
// partial row from one read of x and dy, then the combine); it takes h
// a multiple of 8 up to 8192 with x, dy, dx and the partials 16-byte
// aligned, and refuses anything else (cudaErrorInvalidValue).  With
// them set, the three-launch body: dx (+ the per-row statistics into
// mean and rstd), the per-chunk dw/db partials, and their combine.
// Either way rows_per_chunk rows make one of the n_chunks partial rows
// of part_w and part_b.
extern "C" int apex_layer_norm_bwd(const void* x, int x_dtype, const void* w,
                                   int w_dtype, const void* dy, void* dx,
                                   void* mean, void* rstd, void* part_w,
                                   void* part_b, void* dw, void* db,
                                   long long rows, int h, float eps, int rms,
                                   int rows_per_chunk, int n_chunks,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mu = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  float* pw = static_cast<float*>(part_w);
  float* pb = static_cast<float*>(part_b);
  float* gw = static_cast<float*>(dw);
  float* gb = static_cast<float*>(db);
  const bool r = rms != 0;
  if (x_dtype == F32 && w_dtype == F32) {
    return launch_bwd<float, float>(x, w, dy, dx, mu, rs, pw, pb, gw, gb, rows,
                                    h, eps, r, rows_per_chunk, n_chunks, st);
  } else if (x_dtype == F32 && w_dtype == BF16) {
    return launch_bwd<float, __nv_bfloat16>(x, w, dy, dx, mu, rs, pw, pb, gw,
                                            gb, rows, h, eps, r,
                                            rows_per_chunk, n_chunks, st);
  } else if (x_dtype == BF16 && w_dtype == F32) {
    return launch_bwd<__nv_bfloat16, float>(x, w, dy, dx, mu, rs, pw, pb, gw,
                                            gb, rows, h, eps, r,
                                            rows_per_chunk, n_chunks, st);
  } else if (x_dtype == BF16 && w_dtype == BF16) {
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(
        x, w, dy, dx, mu, rs, pw, pb, gw, gb, rows, h, eps, r, rows_per_chunk,
        n_chunks, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
