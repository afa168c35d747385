// Flat-buffer streaming kernels of the training path, for Hopper (sm_90a).
//
// Replace three TPU kernels of apex_tpu/ops/multi_tensor.py:
//   flat_accumulate   (:207, body _accumulate_kernel :190)
//   flat_unscale_norm (:270, body _unscale_norm_kernel :255)
//   flat_sgd          (:465, body _sgd_kernel :446)
// Each takes a whole flat bucket (ResNet-50 in amp O2 is one bucket of
// 25,557,032 elements) and touches every element once.
//
// What bounds them: bytes.  Each does a handful of f32 operations per
// 8-20 bytes it moves, against the card's ~20 f32 operations per byte of
// HBM bandwidth, so the least time is the bytes over 3.35 TB/s.  The
// design is the plain streaming shape: a fixed grid of 256-thread blocks
// walks the buffer in a grid-stride loop, four elements a thread a step
// through one vector load per operand (16 bytes for f32, 8 for bf16), and
// a scalar loop takes the ragged tail (n not a multiple of 4).  The TPU
// kernels' (rows, 128) tiles and zero padding exist for VMEM and are not
// carried over: the kernels guard with n.
//
// Arithmetic is f32 with every rounding explicit (__fmul_rn/__fadd_rn,
// no contraction into FMAs), in the order of the TPU kernel bodies, so
// the plain PyTorch twins (apex_tpu_torch/ops/multi_tensor.py) reproduce
// it up to the one place the twin divides where the kernel multiplies by
// the reciprocal (flat_sgd's grad scale, as in the reference).
//
// Scalars that live on the device (the unscale factor, the first-step
// select, the overflow flag) are read through device pointers, so no
// caller syncs the host to launch.  Non-finite means !(|x| < inf), the
// TPU kernels' _all_finite test.  The flag of a launch is an OR across
// blocks (atomicOr: order-free); the squared norm of flat_unscale_norm is
// summed per block and then over the blocks in a fixed order by a second
// one-block launch, never with float atomics, so a run is deterministic.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int COMBINE_THREADS = 1024;

enum Dtype { F32 = 0, BF16 = 1 };

struct F4 {
  float x, y, z, w;
};

__device__ __forceinline__ F4 load4(const float* p, int64_t i) {
  const float4 v = reinterpret_cast<const float4*>(p)[i];
  return {v.x, v.y, v.z, v.w};
}

__device__ __forceinline__ F4 load4(const __nv_bfloat16* p, int64_t i) {
  const uint2 u = reinterpret_cast<const uint2*>(p)[i];
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return {a.x, a.y, b.x, b.y};
}

__device__ __forceinline__ void store4(float* p, int64_t i, F4 v) {
  reinterpret_cast<float4*>(p)[i] = make_float4(v.x, v.y, v.z, v.w);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, int64_t i, F4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  reinterpret_cast<uint2*>(p)[i] = u;
}

__device__ __forceinline__ float load1(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store1(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ bool bad(float v) { return !(fabsf(v) < INFINITY); }

// Applies f to the four lanes of a vector.
template <typename Fn>
__device__ __forceinline__ F4 map4(F4 a, Fn f) {
  return {f(a.x, 0), f(a.y, 1), f(a.z, 2), f(a.w, 3)};
}

__device__ __forceinline__ float lane(const F4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Sum over the block in a fixed order (shuffle tree, then one warp over
// the warps' sums); the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane_id = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane_id == 0) warp_sums[warp] = v;
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  v = threadIdx.x < n_warps ? warp_sums[threadIdx.x] : 0.f;
  if (warp == 0) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

// ---------------------------------------------------------------------------
// flat_accumulate: acc += g * scale in place; flag the RESULT (so one
// non-finite microbatch latches through every later add).
// ---------------------------------------------------------------------------
template <typename G>
__global__ void __launch_bounds__(THREADS)
accumulate_kernel(float* __restrict__ acc, const G* __restrict__ g, float scale,
                  int* __restrict__ flag, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t n4 = n / 4;
  bool any_bad = false;
  for (int64_t i = tid; i < n4; i += stride) {
    const F4 a = load4(acc, i), x = load4(g, i);
    const F4 r = map4(a, [&](float av, int k) {
      return __fadd_rn(av, __fmul_rn(lane(x, k), scale));
    });
    store4(acc, i, r);
    any_bad |= bad(r.x) | bad(r.y) | bad(r.z) | bad(r.w);
  }
  for (int64_t i = n4 * 4 + tid; i < n; i += stride) {
    const float r = __fadd_rn(acc[i], __fmul_rn(load1(g, i), scale));
    acc[i] = r;
    any_bad |= bad(r);
  }
  if (__syncthreads_or(any_bad) && threadIdx.x == 0) atomicOr(flag, 1);
}

// ---------------------------------------------------------------------------
// flat_unscale_norm: out = x * inv_scale, plus the sum of squares of the
// unscaled f32 values (before out's rounding) and the non-finite flag,
// from one read of x.  Pass 1 leaves one partial per block; pass 2 (one
// block) sums them in a fixed order.
// ---------------------------------------------------------------------------
template <typename X>
__global__ void __launch_bounds__(THREADS)
unscale_norm_kernel(const X* __restrict__ x, X* __restrict__ out,
                    const float* __restrict__ inv_scale,
                    float* __restrict__ partial_sum,
                    int* __restrict__ partial_flag, int64_t n) {
  const float s = *inv_scale;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t n4 = n / 4;
  float sq = 0.f;
  bool any_bad = false;
  for (int64_t i = tid; i < n4; i += stride) {
    const F4 y = map4(load4(x, i), [&](float v, int) { return __fmul_rn(v, s); });
    store4(out, i, y);
    sq = __fadd_rn(sq, __fmul_rn(y.x, y.x));
    sq = __fadd_rn(sq, __fmul_rn(y.y, y.y));
    sq = __fadd_rn(sq, __fmul_rn(y.z, y.z));
    sq = __fadd_rn(sq, __fmul_rn(y.w, y.w));
    any_bad |= bad(y.x) | bad(y.y) | bad(y.z) | bad(y.w);
  }
  for (int64_t i = n4 * 4 + tid; i < n; i += stride) {
    const float y = __fmul_rn(load1(x, i), s);
    store1(out, i, y);
    sq = __fadd_rn(sq, __fmul_rn(y, y));
    any_bad |= bad(y);
  }
  const bool block_bad = __syncthreads_or(any_bad);
  const float total = block_sum(sq);
  if (threadIdx.x == 0) {
    partial_sum[blockIdx.x] = total;
    partial_flag[blockIdx.x] = block_bad ? 1 : 0;
  }
}

__global__ void __launch_bounds__(COMBINE_THREADS)
unscale_norm_combine(const float* __restrict__ partial_sum,
                     const int* __restrict__ partial_flag, int n_partials,
                     float* __restrict__ norm_sq, int* __restrict__ flag) {
  float s = 0.f;
  bool any_bad = false;
  for (int i = threadIdx.x; i < n_partials; i += COMBINE_THREADS) {
    s = __fadd_rn(s, partial_sum[i]);
    any_bad |= partial_flag[i] != 0;
  }
  const bool block_bad = __syncthreads_or(any_bad);
  const float total = block_sum(s);
  if (threadIdx.x == 0) {
    *norm_sq = total;
    *flag = block_bad ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// flat_sgd: torch.optim.SGD's update (weight decay, momentum, dampening,
// nesterov) in place on p and buf.  `first` selects buf = g (the first
// step).  When the overflow flag is set the kernel writes nothing: p and
// buf keep their old values, which is the reference's select-on-skip.
// ---------------------------------------------------------------------------
template <bool NESTEROV, bool MOMENTUM>
__device__ __forceinline__ float sgd_elem(float pf, float gv, float& b,
                                          float lr, float momentum,
                                          float keep, float wd, float inv,
                                          bool first) {
  const float g = __fadd_rn(__fmul_rn(gv, inv), __fmul_rn(wd, pf));
  float d = g;
  if (MOMENTUM) {
    b = first ? g : __fadd_rn(__fmul_rn(momentum, b), __fmul_rn(keep, g));
    d = NESTEROV ? __fadd_rn(g, __fmul_rn(momentum, b)) : b;
  }
  return __fsub_rn(pf, __fmul_rn(lr, d));
}

template <typename P, typename G, bool NESTEROV, bool MOMENTUM>
__global__ void __launch_bounds__(THREADS)
sgd_kernel(P* __restrict__ p, const G* __restrict__ g, float* __restrict__ buf,
           float lr, float momentum, float dampening, float wd,
           const float* __restrict__ inv_scale, const int* __restrict__ first_run,
           const int* __restrict__ found_inf, int64_t n) {
  if (found_inf != nullptr && *found_inf != 0) return;
  const float inv = *inv_scale;
  const bool first = *first_run != 0;
  const float keep = 1.f - dampening;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t n4 = n / 4;
  for (int64_t i = tid; i < n4; i += stride) {
    const F4 pv = load4(p, i), gv = load4(g, i);
    F4 bv = MOMENTUM ? load4(buf, i) : F4{0.f, 0.f, 0.f, 0.f};
    F4 out;
    out.x = sgd_elem<NESTEROV, MOMENTUM>(pv.x, gv.x, bv.x, lr, momentum, keep, wd, inv, first);
    out.y = sgd_elem<NESTEROV, MOMENTUM>(pv.y, gv.y, bv.y, lr, momentum, keep, wd, inv, first);
    out.z = sgd_elem<NESTEROV, MOMENTUM>(pv.z, gv.z, bv.z, lr, momentum, keep, wd, inv, first);
    out.w = sgd_elem<NESTEROV, MOMENTUM>(pv.w, gv.w, bv.w, lr, momentum, keep, wd, inv, first);
    store4(p, i, out);
    if (MOMENTUM) store4(buf, i, bv);
  }
  for (int64_t i = n4 * 4 + tid; i < n; i += stride) {
    float b = MOMENTUM ? buf[i] : 0.f;
    const float r = sgd_elem<NESTEROV, MOMENTUM>(load1(p, i), load1(g, i), b, lr,
                                                 momentum, keep, wd, inv, first);
    store1(p, i, r);
    if (MOMENTUM) buf[i] = b;
  }
}

template <typename P, typename G>
void launch_sgd(int blocks, cudaStream_t st, void* p, const void* g, float* buf,
                float lr, float momentum, float dampening, float wd,
                const float* inv, const int* first, const int* found_inf,
                int nesterov, int use_momentum, int64_t n) {
  P* pp = static_cast<P*>(p);
  const G* gg = static_cast<const G*>(g);
  if (!use_momentum) {
    sgd_kernel<P, G, false, false><<<blocks, THREADS, 0, st>>>(
        pp, gg, buf, lr, momentum, dampening, wd, inv, first, found_inf, n);
  } else if (nesterov) {
    sgd_kernel<P, G, true, true><<<blocks, THREADS, 0, st>>>(
        pp, gg, buf, lr, momentum, dampening, wd, inv, first, found_inf, n);
  } else {
    sgd_kernel<P, G, false, true><<<blocks, THREADS, 0, st>>>(
        pp, gg, buf, lr, momentum, dampening, wd, inv, first, found_inf, n);
  }
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`,
// allocates nothing (the wrapper passes outputs and scratch), and returns
// cudaGetLastError() after its launches (0 when they were accepted).
// Dtype codes: 0 float32, 1 bfloat16.  `blocks` is the grid the wrapper
// chose (the same for a given n on any card, so sums are reproducible).

extern "C" int apex_flat_accumulate(void* acc, const void* g, int g_dtype,
                                    float scale, void* flag, long long n,
                                    int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(acc);
  int* f = static_cast<int*>(flag);
  switch (g_dtype) {
    case F32:
      accumulate_kernel<float><<<blocks, THREADS, 0, st>>>(
          a, static_cast<const float*>(g), scale, f, n);
      break;
    case BF16:
      accumulate_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
          a, static_cast<const __nv_bfloat16*>(g), scale, f, n);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Two launches: the sweep (`blocks` partials) and the one-block combine.
extern "C" int apex_flat_unscale_norm(const void* x, void* out, int dtype,
                                      const void* inv_scale, void* norm_sq,
                                      void* flag, void* partial_sum,
                                      void* partial_flag, long long n,
                                      int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* inv = static_cast<const float*>(inv_scale);
  float* ps = static_cast<float*>(partial_sum);
  int* pf = static_cast<int*>(partial_flag);
  switch (dtype) {
    case F32:
      unscale_norm_kernel<float><<<blocks, THREADS, 0, st>>>(
          static_cast<const float*>(x), static_cast<float*>(out), inv, ps, pf, n);
      break;
    case BF16:
      unscale_norm_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
          inv, ps, pf, n);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  unscale_norm_combine<<<1, COMBINE_THREADS, 0, st>>>(
      ps, pf, blocks, static_cast<float*>(norm_sq), static_cast<int*>(flag));
  return static_cast<int>(cudaGetLastError());
}

// found_inf may be null (no gate).
extern "C" int apex_flat_sgd(void* p, int p_dtype, const void* g, int g_dtype,
                             void* buf, float lr, float momentum,
                             float dampening, float weight_decay,
                             const void* inv_scale, const void* first_run,
                             const void* found_inf, int nesterov,
                             int use_momentum, long long n, int blocks,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* b = static_cast<float*>(buf);
  const float* inv = static_cast<const float*>(inv_scale);
  const int* first = static_cast<const int*>(first_run);
  const int* fi = static_cast<const int*>(found_inf);
  if (p_dtype == F32 && g_dtype == F32) {
    launch_sgd<float, float>(blocks, st, p, g, b, lr, momentum, dampening,
                             weight_decay, inv, first, fi, nesterov,
                             use_momentum, n);
  } else if (p_dtype == F32 && g_dtype == BF16) {
    launch_sgd<float, __nv_bfloat16>(blocks, st, p, g, b, lr, momentum,
                                     dampening, weight_decay, inv, first, fi,
                                     nesterov, use_momentum, n);
  } else if (p_dtype == BF16 && g_dtype == BF16) {
    launch_sgd<__nv_bfloat16, __nv_bfloat16>(blocks, st, p, g, b, lr, momentum,
                                             dampening, weight_decay, inv,
                                             first, fi, nesterov, use_momentum, n);
  } else if (p_dtype == BF16 && g_dtype == F32) {
    launch_sgd<__nv_bfloat16, float>(blocks, st, p, g, b, lr, momentum,
                                     dampening, weight_decay, inv, first, fi,
                                     nesterov, use_momentum, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
