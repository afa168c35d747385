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
// - forward: one 256-thread block per row; three passes over the row
//   (mean, centred sum of squares, output), the later ones from L1/L2;
// - backward: (1) one block per row recomputes mean and rstd (the
//   reference recomputes the statistics rather than saving them), writes
//   dx and leaves the two per-row statistics in a small scratch; (2) a
//   column kernel gives each thread one column and a fixed chunk of rows
//   and writes that chunk's partial dw/db; (3) a combine sums the chunks
//   of each column in order.  No atomics: the bits are the same every
//   run.  dx and dw/db read x and dy twice (about 1.6x the bound's
//   bytes); a fused single-read backward is later work.
// Loads are scalar and coalesced across the block (neighbouring threads,
// neighbouring columns), so any row start is accepted.
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

__global__ void __launch_bounds__(COL_THREADS)
ln_bwd_combine_kernel(const float* __restrict__ part_w,
                      const float* __restrict__ part_b, int n_chunks, int h,
                      float* __restrict__ dw, float* __restrict__ db) {
  const int col = blockIdx.x * COL_THREADS + threadIdx.x;
  if (col >= h) return;
  float aw = 0.f, ab = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    aw = __fadd_rn(aw, part_w[static_cast<int64_t>(c) * h + col]);
    ab = __fadd_rn(ab, part_b[static_cast<int64_t>(c) * h + col]);
  }
  dw[col] = aw;
  db[col] = ab;
}

template <typename X, typename W>
void launch_fwd(const void* x, const void* w, const void* b, void* y,
                long long rows, int h, float eps, bool rms, cudaStream_t st) {
  const X* xx = static_cast<const X*>(x);
  const W* ww = static_cast<const W*>(w);
  const W* bb = static_cast<const W*>(b);
  X* yy = static_cast<X*>(y);
  if (rms) {
    ln_fwd_kernel<X, W, true><<<static_cast<unsigned>(rows), ROW_THREADS, 0, st>>>(xx, ww, bb, yy, h, eps);
  } else {
    ln_fwd_kernel<X, W, false><<<static_cast<unsigned>(rows), ROW_THREADS, 0, st>>>(xx, ww, bb, yy, h, eps);
  }
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
  if (rms) {
    ln_bwd_dx_kernel<X, W, true><<<static_cast<unsigned>(rows), ROW_THREADS, 0, st>>>(
        xx, ww, dyy, dxx, mean, rstd, h, eps);
  } else {
    ln_bwd_dx_kernel<X, W, false><<<static_cast<unsigned>(rows), ROW_THREADS, 0, st>>>(
        xx, ww, dyy, dxx, mean, rstd, h, eps);
  }
  cudaError_t err = cudaGetLastError();
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
  ln_bwd_combine_kernel<<<(h + COL_THREADS - 1) / COL_THREADS, COL_THREADS, 0,
                          st>>>(part_w, part_b, n_chunks, h, dw, db);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`,
// allocates nothing (the wrapper passes outputs and scratch), and returns
// cudaGetLastError() after its launches (0 when they were accepted).
// Dtype codes: 0 float32, 1 bfloat16.  `rows` blocks of the row kernels
// must fit the grid (< 2^31); the wrapper checks.

// y = norm(x) * w + b (RMS: the reference's zero bias).
extern "C" int apex_layer_norm_fwd(const void* x, int x_dtype, const void* w,
                                   const void* b, int w_dtype, void* y,
                                   long long rows, int h, float eps, int rms,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool r = rms != 0;
  if (x_dtype == F32 && w_dtype == F32) {
    launch_fwd<float, float>(x, w, b, y, rows, h, eps, r, st);
  } else if (x_dtype == F32 && w_dtype == BF16) {
    launch_fwd<float, __nv_bfloat16>(x, w, b, y, rows, h, eps, r, st);
  } else if (x_dtype == BF16 && w_dtype == F32) {
    launch_fwd<__nv_bfloat16, float>(x, w, b, y, rows, h, eps, r, st);
  } else if (x_dtype == BF16 && w_dtype == BF16) {
    launch_fwd<__nv_bfloat16, __nv_bfloat16>(x, w, b, y, rows, h, eps, r, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Three launches: dx (+ per-row statistics), the per-chunk dw/db
// partials, and their combine into dw, db (f32).
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
