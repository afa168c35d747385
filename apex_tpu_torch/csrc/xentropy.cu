// Softmax cross entropy with label smoothing, forward and backward, for
// Hopper (sm_90a).
//
// Replace two TPU kernels of apex_tpu/ops/xentropy.py:
//   _xent_fwd (:103, pallas_call :115, body _fwd_kernel :47):
//     per row lse = logsumexp(x) and
//     loss = lse - (1 - s) * x[t] - s * mean(x)     -> apex_xent_fwd
//   _xent_bwd (:129, pallas_call :141, body _bwd_kernel :64):
//     dx = dy * (exp(x - lse) - (1 - s) * onehot - s / C) -> apex_xent_bwd
// over logits (N, C), C a multiple of 128 up to 65536 (the reference's
// gate, _use_pallas); x in f32, bf16 or fp16, the losses and dx in f32
// or x's dtype, lse and every sum in f32.  The one-hot is col == t, as
// the reference's iota == target: a label outside [0, C) (BERT's -1 on
// padding) has no target term, forward or backward.  BERT-Large's MLM
// head at Megatron's padded vocabulary runs them at (4096, 30592) f32.
//
// What bounds them: bytes.  A logit costs a handful of f32 operations
// (max, exp, add) against 2-4 bytes read, far below the card's ~20
// operations per byte; the least time is reading x once (and, backward,
// writing dx once) at 3.35 TB/s.
//
// Design.  The TPU kernel holds a block of up to 256 whole rows in VMEM;
// a row of 65536 f32 (256 KB) does not fit a Hopper block's shared memory.
// - Forward: one 256-thread block a row, which streams the row once in
//   16-byte vectors (neighbouring threads, neighbouring vectors).  Each
//   thread keeps an online max and sum of exponentials (rescaled once a
//   vector) and the sum of x; the block merges them through a fixed
//   shuffle tree and then the warps in order.  x[t] is one load by the
//   first thread.  No atomics: the same bits every run.
// - Backward: every element is independent given its row's lse, dy and
//   label, so a block takes a slab of 4096 columns of one row (grid x the
//   rows, y the slabs): one read of x, one write of dx, 16-byte vectors.
//
// Arithmetic follows the plain version's order with explicit roundings
// (no contraction into FMAs): lse = m + log(sum(exp(x - m))) (the sum
// rescaled online, so not the plain version's bits), loss = lse - (1 - s)
// * x_t, then loss - s * (sum(x) / C); dx = ((exp(x - lse) [- (1 - s) at
// the label]) - s / C) * dy.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_C = 65536;
constexpr int SLAB = 4096;       // columns of one backward block

enum Dtype { F32 = 0, BF16 = 1, F16 = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// The elements of one 16-byte vector of T (4 f32 or 8 bf16/fp16).
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const T* h = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) v[i] = to_f(h[i]);
}

// N floats to N elements of T at p (16-byte aligned), in 16-byte stores.
template <typename T, int N>
__device__ __forceinline__ void store_n(T* p, const float* v) {
  constexpr int PER = Vec<T>::N;
#pragma unroll
  for (int j = 0; j < N / PER; ++j) {
    uint4 r;
    T* h = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int i = 0; i < PER; ++i) h[i] = from_f<T>(v[j * PER + i]);
    *reinterpret_cast<uint4*>(p + j * PER) = r;
  }
}

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// max that propagates NaN, as torch.amax does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// (m, s) <- the merge of two (max, sum of exp(x - max)) pairs.  A pair
// with max -inf holds no mass (its sum is 0), which keeps exp(-inf -
// -inf) out of the sum.
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  const float mn = nan_max(m, m2);
  const float a = m == neg_inf() ? 0.f : __fmul_rn(s, expf(__fsub_rn(m, mn)));
  const float b = m2 == neg_inf() ? 0.f : __fmul_rn(s2, expf(__fsub_rn(m2, mn)));
  m = mn;
  s = __fadd_rn(a, b);
}

template <typename T, typename O>
__global__ void __launch_bounds__(THREADS)
xent_fwd_kernel(const T* __restrict__ x, const long long* __restrict__ labels,
                O* __restrict__ loss, float* __restrict__ lse_out, int c,
                float one_minus_s, float s) {
  constexpr int N = Vec<T>::N;
  __shared__ float sh_m[THREADS / 32], sh_s[THREADS / 32], sh_x[THREADS / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * c;
  float m = neg_inf(), se = 0.f, sx = 0.f;
  for (int k = threadIdx.x; k < c / N; k += THREADS) {
    float v[N];
    load_vec<T>(xr + k * N, v);
    float vm = v[0];
#pragma unroll
    for (int i = 1; i < N; ++i) vm = nan_max(vm, v[i]);
    const float mn = nan_max(m, vm);
    if (mn != neg_inf()) {
      float acc = m == neg_inf() ? 0.f : __fmul_rn(se, expf(__fsub_rn(m, mn)));
#pragma unroll
      for (int i = 0; i < N; ++i) acc = __fadd_rn(acc, expf(__fsub_rn(v[i], mn)));
      se = acc;
      m = mn;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) sx = __fadd_rn(sx, v[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, se, o);
    sx = __fadd_rn(sx, __shfl_xor_sync(0xffffffffu, sx, o));
    lse_merge(m, se, m2, s2);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sh_m[warp] = m;
    sh_s[warp] = se;
    sh_x[warp] = sx;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  m = sh_m[0];
  se = sh_s[0];
  sx = sh_x[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) {
    lse_merge(m, se, sh_m[w], sh_s[w]);
    sx = __fadd_rn(sx, sh_x[w]);
  }
  const long long t = labels[row];
  const float xt = (t >= 0 && t < c) ? to_f(xr[t]) : 0.f;
  const float lse = __fadd_rn(m, logf(se));
  float l = __fsub_rn(lse, __fmul_rn(one_minus_s, xt));
  l = __fsub_rn(l, __fmul_rn(s, __fdiv_rn(sx, static_cast<float>(c))));
  loss[row] = from_f<O>(l);
  lse_out[row] = lse;
}

template <typename T, typename O>
__global__ void __launch_bounds__(THREADS)
xent_bwd_kernel(const T* __restrict__ x, const long long* __restrict__ labels,
                const float* __restrict__ lse, const float* __restrict__ dy,
                O* __restrict__ dx, int c, float one_minus_s, float s_over_c) {
  constexpr int N = Vec<T>::N;
  const long long row = blockIdx.x;
  const float l = lse[row], g = dy[row];
  const long long t = labels[row];
  const int end = min(c, (static_cast<int>(blockIdx.y) + 1) * SLAB);
  for (int col = blockIdx.y * SLAB + threadIdx.x * N; col < end; col += THREADS * N) {
    float v[N];
    load_vec<T>(x + row * c + col, v);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float p = expf(__fsub_rn(v[i], l));
      if (col + i == t) p = __fsub_rn(p, one_minus_s);
      v[i] = __fmul_rn(__fsub_rn(p, s_over_c), g);
    }
    store_n<O, N>(dx + row * c + col, v);
  }
}

bool bad_geometry(long long rows, int c) {
  return rows <= 0 || rows >= (1LL << 31) || c <= 0 || c > MAX_C || c % 128 != 0;
}

template <typename T, typename O>
void launch_fwd(const void* x, const void* labels, void* loss, void* lse,
                long long rows, int c, float oms, float s, cudaStream_t st) {
  xent_fwd_kernel<T, O><<<static_cast<unsigned>(rows), THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const long long*>(labels),
      static_cast<O*>(loss), static_cast<float*>(lse), c, oms, s);
}

template <typename T, typename O>
void launch_bwd(const void* x, const void* labels, const void* lse,
                const void* dy, void* dx, long long rows, int c, float oms,
                float soc, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(rows), (c + SLAB - 1) / SLAB);
  xent_bwd_kernel<T, O><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const long long*>(labels),
      static_cast<const float*>(lse), static_cast<const float*>(dy),
      static_cast<O*>(dx), c, oms, soc);
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`,
// allocates nothing (the wrapper passes the outputs), and returns
// cudaGetLastError() after its launch (0 when it was accepted).  Dtype
// codes: 0 float32, 1 bfloat16, 2 float16; the output dtype is float32 or
// x's.  x is a contiguous (rows, c) array, 16-byte aligned; labels are
// int64 (rows,), lse and dy f32 (rows,).

// loss[r] and lse[r] of row r of x.
extern "C" int apex_xent_fwd(const void* x, int x_dtype, const void* labels,
                             void* loss, int loss_dtype, void* lse,
                             long long rows, int c, float one_minus_s,
                             float s, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_geometry(rows, c) || (loss_dtype != F32 && loss_dtype != x_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool f32_out = loss_dtype == F32;
  if (x_dtype == F32) {
    launch_fwd<float, float>(x, labels, loss, lse, rows, c, one_minus_s, s, st);
  } else if (x_dtype == BF16) {
    if (f32_out) launch_fwd<__nv_bfloat16, float>(x, labels, loss, lse, rows, c, one_minus_s, s, st);
    else launch_fwd<__nv_bfloat16, __nv_bfloat16>(x, labels, loss, lse, rows, c, one_minus_s, s, st);
  } else if (x_dtype == F16) {
    if (f32_out) launch_fwd<__half, float>(x, labels, loss, lse, rows, c, one_minus_s, s, st);
    else launch_fwd<__half, __half>(x, labels, loss, lse, rows, c, one_minus_s, s, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dx (rows, c) in dx_dtype from x, the labels, the saved lse and dy.
extern "C" int apex_xent_bwd(const void* x, int x_dtype, const void* labels,
                             const void* lse, const void* dy, void* dx,
                             int dx_dtype, long long rows, int c,
                             float one_minus_s, float s_over_c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_geometry(rows, c) || (dx_dtype != F32 && dx_dtype != x_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool f32_out = dx_dtype == F32;
  if (x_dtype == F32) {
    launch_bwd<float, float>(x, labels, lse, dy, dx, rows, c, one_minus_s, s_over_c, st);
  } else if (x_dtype == BF16) {
    if (f32_out) launch_bwd<__nv_bfloat16, float>(x, labels, lse, dy, dx, rows, c, one_minus_s, s_over_c, st);
    else launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, labels, lse, dy, dx, rows, c, one_minus_s, s_over_c, st);
  } else if (x_dtype == F16) {
    if (f32_out) launch_bwd<__half, float>(x, labels, lse, dy, dx, rows, c, one_minus_s, s_over_c, st);
    else launch_bwd<__half, __half>(x, labels, lse, dy, dx, rows, c, one_minus_s, s_over_c, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
