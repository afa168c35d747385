// Flat-buffer streaming kernels of the training path, for Hopper (sm_90a).
//
// Replace seven TPU kernels of apex_tpu/ops/multi_tensor.py:
//   flat_accumulate   (:207, body _accumulate_kernel :190)
//   flat_unscale_norm (:270, body _unscale_norm_kernel :255)
//   flat_l2norm       (:325, body _l2norm_kernel :314)
//   flat_adam         (:402, body _adam_kernel :351)
//   flat_sgd          (:465, body _sgd_kernel :446)
//   flat_lamb stage 1 (:878, body _lamb_moment_kernel :824)
//   flat_lamb stage 2 (:897, body _apply_update_kernel :838)
// Each takes a whole flat bucket (ResNet-50 in amp O2 is one bucket of
// 25,557,032 elements, BERT-Large one of 334,096,384, the GPT-2-small
// block stack one of 124,046,592) and touches every element once.
//
// What bounds them: bytes.  Each does a handful of f32 operations per
// 2-28 bytes it moves, against the card's ~20 f32 operations per byte of
// HBM bandwidth, so the least time is the bytes over 3.35 TB/s.  The
// design is the plain streaming shape: a fixed grid of 256-thread blocks
// walks the buffer in a grid-stride loop, four elements a thread a step
// through one vector load per operand (16 bytes for f32 and i32, 8 for
// bf16), and a scalar loop takes the ragged tail (n not a multiple of 4).
// The TPU kernels' (rows, 128) tiles and zero padding exist for VMEM and
// are not carried over: the kernels guard with n.
//
// Arithmetic is f32 with every rounding explicit (__fmul_rn/__fadd_rn/
// __fdiv_rn/__fsqrt_rn, no contraction into FMAs), in the order of the
// TPU kernel bodies, so the plain PyTorch twins
// (apex_tpu_torch/ops/multi_tensor.py) reproduce it up to the places
// the twin divides where the kernel multiplies by the reciprocal
// (the grad scale of flat_sgd and flat_adam, as in the reference: the
// same bits when the scale is a power of two).
//
// Scalars that live on the device (the unscale factor, the first-step
// select, the LAMB and Adam bias corrections, Adam's learning rate, the
// LAMB clip factor, the overflow flag) are read through device
// pointers, so no caller syncs the host to launch.  Non-finite means
// !(|x| < inf), the TPU kernels' _all_finite test.  The flag of a launch is an OR across blocks (atomicOr:
// order-free); a sum over the buffer (flat_unscale_norm, flat_l2norm) is
// summed per block and then over the blocks in a fixed order by a second
// one-block launch, never with float atomics, so a run is deterministic.
//
// The in-place kernels with an overflow gate (flat_sgd, flat_adam, both
// LAMB stages) return before writing anything when the flag is set: the
// reference selects the old values on a skipped step, which an in-place
// update would already have destroyed.

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

// The one-block second pass of every buffer-wide sum: the partials in a
// fixed order (then the root when `root`), and the OR of the partial
// flags when there are any.
__global__ void __launch_bounds__(COMBINE_THREADS)
sum_combine(const float* __restrict__ partial_sum,
            const int* __restrict__ partial_flag, int n_partials, bool root,
            float* __restrict__ out, int* __restrict__ flag) {
  float s = 0.f;
  bool any_bad = false;
  for (int i = threadIdx.x; i < n_partials; i += COMBINE_THREADS) {
    s = __fadd_rn(s, partial_sum[i]);
    if (partial_flag != nullptr) any_bad |= partial_flag[i] != 0;
  }
  const bool block_bad = __syncthreads_or(any_bad);
  const float total = block_sum(s);
  if (threadIdx.x == 0) {
    *out = root ? __fsqrt_rn(total) : total;
    if (flag != nullptr) *flag = block_bad ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// flat_l2norm: the square root of the f32 sum of squares of a flat buffer
// (the global-gradient-norm prologue of LAMB).  Pass 1 leaves one partial
// per block; the combine sums them in a fixed order and takes the root.
// ---------------------------------------------------------------------------
template <typename X>
__global__ void __launch_bounds__(THREADS)
sumsq_kernel(const X* __restrict__ x, float* __restrict__ partial_sum,
             int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t n4 = n / 4;
  float sq = 0.f;
  for (int64_t i = tid; i < n4; i += stride) {
    const F4 y = load4(x, i);
    sq = __fadd_rn(sq, __fmul_rn(y.x, y.x));
    sq = __fadd_rn(sq, __fmul_rn(y.y, y.y));
    sq = __fadd_rn(sq, __fmul_rn(y.z, y.z));
    sq = __fadd_rn(sq, __fmul_rn(y.w, y.w));
  }
  for (int64_t i = n4 * 4 + tid; i < n; i += stride) {
    const float y = load1(x, i);
    sq = __fadd_rn(sq, __fmul_rn(y, y));
  }
  const float total = block_sum(sq);
  if (threadIdx.x == 0) partial_sum[blockIdx.x] = total;
}

// ---------------------------------------------------------------------------
// flat_lamb stage 1: Adam moments in place on m and v, and the raw update
// m_hat / (sqrt(v_hat) + eps) + wd * p into `update`; g is scaled by
// gmul = clip / grad_scale.  c1r, c2r (the bias corrections) and gmul are
// device scalars.
// ---------------------------------------------------------------------------
struct LambHypers {
  float b1, omb1, b2, omb2, eps, wd;   // omb = 1 - b, rounded to f32 once
};

__device__ __forceinline__ float lamb_elem(float pv, float gv, float& m,
                                           float& v, const LambHypers& h,
                                           float c1r, float c2r,
                                           float gmul) {
  const float g = __fmul_rn(gv, gmul);
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float denom = __fadd_rn(__fsqrt_rn(__fmul_rn(v, c2r)), h.eps);
  return __fadd_rn(__fdiv_rn(__fmul_rn(m, c1r), denom), __fmul_rn(h.wd, pv));
}

template <typename P, typename G>
__global__ void __launch_bounds__(THREADS)
lamb_moment_kernel(const P* __restrict__ p, const G* __restrict__ g,
                   float* __restrict__ m, float* __restrict__ v,
                   float* __restrict__ update, LambHypers h,
                   const float* __restrict__ c1r_p,
                   const float* __restrict__ c2r_p,
                   const float* __restrict__ gmul_p,
                   const int* __restrict__ found_inf, int64_t n) {
  if (found_inf != nullptr && *found_inf != 0) return;
  const float c1r = *c1r_p, c2r = *c2r_p, gmul = *gmul_p;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t n4 = n / 4;
  for (int64_t i = tid; i < n4; i += stride) {
    const F4 pv = load4(p, i), gv = load4(g, i);
    F4 mv = load4(m, i), vv = load4(v, i);
    F4 u;
    u.x = lamb_elem(pv.x, gv.x, mv.x, vv.x, h, c1r, c2r, gmul);
    u.y = lamb_elem(pv.y, gv.y, mv.y, vv.y, h, c1r, c2r, gmul);
    u.z = lamb_elem(pv.z, gv.z, mv.z, vv.z, h, c1r, c2r, gmul);
    u.w = lamb_elem(pv.w, gv.w, mv.w, vv.w, h, c1r, c2r, gmul);
    store4(m, i, mv);
    store4(v, i, vv);
    store4(update, i, u);
  }
  for (int64_t i = n4 * 4 + tid; i < n; i += stride) {
    float mi = m[i], vi = v[i];
    update[i] = lamb_elem(load1(p, i), load1(g, i), mi, vi, h, c1r, c2r, gmul);
    m[i] = mi;
    v[i] = vi;
  }
}

// ---------------------------------------------------------------------------
// flat_lamb stage 2: p -= factor[seg[i]] * update in place, where factor
// is the per-segment lr * trust ratio.  The reference gathers the factor
// into a per-element buffer first ((lr * trust)[seg_ids]); reading it per
// segment here gives the same value with one (num_segments,) table in
// place of a 4-byte-per-element buffer.
// ---------------------------------------------------------------------------
template <typename P>
__global__ void __launch_bounds__(THREADS)
lamb_apply_kernel(P* __restrict__ p, const float* __restrict__ update,
                  const float* __restrict__ factor,
                  const int* __restrict__ seg_ids,
                  const int* __restrict__ found_inf, int64_t n) {
  if (found_inf != nullptr && *found_inf != 0) return;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t n4 = n / 4;
  for (int64_t i = tid; i < n4; i += stride) {
    const F4 pv = load4(p, i), uv = load4(update, i);
    const int4 s = reinterpret_cast<const int4*>(seg_ids)[i];
    F4 r;
    r.x = __fsub_rn(pv.x, __fmul_rn(factor[s.x], uv.x));
    r.y = __fsub_rn(pv.y, __fmul_rn(factor[s.y], uv.y));
    r.z = __fsub_rn(pv.z, __fmul_rn(factor[s.z], uv.z));
    r.w = __fsub_rn(pv.w, __fmul_rn(factor[s.w], uv.w));
    store4(p, i, r);
  }
  for (int64_t i = n4 * 4 + tid; i < n; i += stride) {
    store1(p, i, __fsub_rn(load1(p, i), __fmul_rn(factor[seg_ids[i]],
                                                  update[i])));
  }
}

template <typename P, typename G>
void launch_lamb_moments(int blocks, cudaStream_t st, const void* p,
                         const void* g, float* m, float* v, float* update,
                         const LambHypers& h, const float* c1r,
                         const float* c2r, const float* gmul,
                         const int* found_inf, int64_t n) {
  lamb_moment_kernel<P, G><<<blocks, THREADS, 0, st>>>(
      static_cast<const P*>(p), static_cast<const G*>(g), m, v, update, h,
      c1r, c2r, gmul, found_inf, n);
}

// ---------------------------------------------------------------------------
// flat_adam: one Adam (adam_w_mode 0: L2 decay folded into g) or AdamW
// (1: decoupled decay) step in place on p, m and v, in the order of the
// reference body:
//   g = g * inv_scale [+ wd * p];  m = b1*m + (1-b1)*g;
//   v = b2*v + ((1-b2)*g)*g;  u = (m*c1r) / (sqrt(v*c2r) + eps) [+ wd*p];
//   p = p - lr * u.
// lr, c1r, c2r (the bias corrections, 1 without them) and inv_scale are
// device scalars; when the overflow flag is set the kernel writes
// nothing, so p, m and v keep every bit.
// ---------------------------------------------------------------------------
struct AdamHypers {
  float b1, omb1, b2, omb2, eps, wd;   // omb = 1 - b, rounded to f32 once
};

template <bool ADAMW>
__device__ __forceinline__ float adam_elem(float pv, float gv, float& m,
                                           float& v, const AdamHypers& h,
                                           float lr, float c1r, float c2r,
                                           float inv) {
  float g = __fmul_rn(gv, inv);
  if (!ADAMW) g = __fadd_rn(g, __fmul_rn(h.wd, pv));
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float denom = __fadd_rn(__fsqrt_rn(__fmul_rn(v, c2r)), h.eps);
  float u = __fdiv_rn(__fmul_rn(m, c1r), denom);
  if (ADAMW) u = __fadd_rn(u, __fmul_rn(h.wd, pv));
  return __fsub_rn(pv, __fmul_rn(lr, u));
}

template <typename P, typename G, bool ADAMW>
__global__ void __launch_bounds__(THREADS)
adam_kernel(P* __restrict__ p, const G* __restrict__ g, float* __restrict__ m,
            float* __restrict__ v, AdamHypers h, const float* __restrict__ lr_p,
            const float* __restrict__ c1r_p, const float* __restrict__ c2r_p,
            const float* __restrict__ inv_p,
            const int* __restrict__ found_inf, int64_t n) {
  if (found_inf != nullptr && *found_inf != 0) return;
  const float lr = *lr_p, c1r = *c1r_p, c2r = *c2r_p, inv = *inv_p;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t n4 = n / 4;
  for (int64_t i = tid; i < n4; i += stride) {
    const F4 pv = load4(p, i), gv = load4(g, i);
    F4 mv = load4(m, i), vv = load4(v, i);
    F4 r;
    r.x = adam_elem<ADAMW>(pv.x, gv.x, mv.x, vv.x, h, lr, c1r, c2r, inv);
    r.y = adam_elem<ADAMW>(pv.y, gv.y, mv.y, vv.y, h, lr, c1r, c2r, inv);
    r.z = adam_elem<ADAMW>(pv.z, gv.z, mv.z, vv.z, h, lr, c1r, c2r, inv);
    r.w = adam_elem<ADAMW>(pv.w, gv.w, mv.w, vv.w, h, lr, c1r, c2r, inv);
    store4(p, i, r);
    store4(m, i, mv);
    store4(v, i, vv);
  }
  for (int64_t i = n4 * 4 + tid; i < n; i += stride) {
    float mi = m[i], vi = v[i];
    store1(p, i, adam_elem<ADAMW>(load1(p, i), load1(g, i), mi, vi, h, lr,
                                  c1r, c2r, inv));
    m[i] = mi;
    v[i] = vi;
  }
}

template <typename P, typename G>
void launch_adam(int blocks, cudaStream_t st, void* p, const void* g,
                 float* m, float* v, const AdamHypers& h, const float* lr,
                 const float* c1r, const float* c2r, const float* inv,
                 const int* found_inf, int adam_w_mode, int64_t n) {
  P* pp = static_cast<P*>(p);
  const G* gg = static_cast<const G*>(g);
  if (adam_w_mode) {
    adam_kernel<P, G, true><<<blocks, THREADS, 0, st>>>(
        pp, gg, m, v, h, lr, c1r, c2r, inv, found_inf, n);
  } else {
    adam_kernel<P, G, false><<<blocks, THREADS, 0, st>>>(
        pp, gg, m, v, h, lr, c1r, c2r, inv, found_inf, n);
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
  sum_combine<<<1, COMBINE_THREADS, 0, st>>>(
      ps, pf, blocks, false, static_cast<float*>(norm_sq),
      static_cast<int*>(flag));
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

// Two launches: the sweep (`blocks` partials) and the one-block combine,
// which writes the root of the total to `norm`.
extern "C" int apex_flat_l2norm(const void* x, int dtype, void* norm,
                                void* partial_sum, long long n, int blocks,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ps = static_cast<float*>(partial_sum);
  switch (dtype) {
    case F32:
      sumsq_kernel<float><<<blocks, THREADS, 0, st>>>(
          static_cast<const float*>(x), ps, n);
      break;
    case BF16:
      sumsq_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), ps, n);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_combine<<<1, COMBINE_THREADS, 0, st>>>(
      ps, nullptr, blocks, true, static_cast<float*>(norm), nullptr);
  return static_cast<int>(cudaGetLastError());
}

// Stage 1 of LAMB.  found_inf may be null (no gate).
extern "C" int apex_flat_lamb_moments(
    const void* p, int p_dtype, const void* g, int g_dtype, void* m, void* v,
    void* update, float beta1, float one_minus_beta1, float beta2,
    float one_minus_beta2, float eps, float weight_decay, const void* c1r,
    const void* c2r, const void* gmul, const void* found_inf, long long n,
    int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const LambHypers h{beta1, one_minus_beta1, beta2, one_minus_beta2, eps,
                     weight_decay};
  float* mm = static_cast<float*>(m);
  float* vv = static_cast<float*>(v);
  float* u = static_cast<float*>(update);
  const float* a = static_cast<const float*>(c1r);
  const float* b = static_cast<const float*>(c2r);
  const float* gm = static_cast<const float*>(gmul);
  const int* fi = static_cast<const int*>(found_inf);
  if (p_dtype == F32 && g_dtype == F32) {
    launch_lamb_moments<float, float>(blocks, st, p, g, mm, vv, u, h, a, b,
                                      gm, fi, n);
  } else if (p_dtype == F32 && g_dtype == BF16) {
    launch_lamb_moments<float, __nv_bfloat16>(blocks, st, p, g, mm, vv, u, h,
                                              a, b, gm, fi, n);
  } else if (p_dtype == BF16 && g_dtype == BF16) {
    launch_lamb_moments<__nv_bfloat16, __nv_bfloat16>(blocks, st, p, g, mm,
                                                      vv, u, h, a, b, gm, fi,
                                                      n);
  } else if (p_dtype == BF16 && g_dtype == F32) {
    launch_lamb_moments<__nv_bfloat16, float>(blocks, st, p, g, mm, vv, u, h,
                                              a, b, gm, fi, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Stage 2 of LAMB.  found_inf may be null (no gate).
extern "C" int apex_flat_lamb_apply(void* p, int p_dtype, const void* update,
                                    const void* factor, const void* seg_ids,
                                    const void* found_inf, long long n,
                                    int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* u = static_cast<const float*>(update);
  const float* f = static_cast<const float*>(factor);
  const int* seg = static_cast<const int*>(seg_ids);
  const int* fi = static_cast<const int*>(found_inf);
  switch (p_dtype) {
    case F32:
      lamb_apply_kernel<float><<<blocks, THREADS, 0, st>>>(
          static_cast<float*>(p), u, f, seg, fi, n);
      break;
    case BF16:
      lamb_apply_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
          static_cast<__nv_bfloat16*>(p), u, f, seg, fi, n);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// One Adam/AdamW step.  found_inf may be null (no gate).
extern "C" int apex_flat_adam(void* p, int p_dtype, const void* g, int g_dtype,
                              void* m, void* v, float beta1,
                              float one_minus_beta1, float beta2,
                              float one_minus_beta2, float eps,
                              float weight_decay, const void* lr,
                              const void* c1r, const void* c2r,
                              const void* inv_scale, const void* found_inf,
                              int adam_w_mode, long long n, int blocks,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AdamHypers h{beta1, one_minus_beta1, beta2, one_minus_beta2, eps,
                     weight_decay};
  float* mm = static_cast<float*>(m);
  float* vv = static_cast<float*>(v);
  const float* l = static_cast<const float*>(lr);
  const float* a = static_cast<const float*>(c1r);
  const float* b = static_cast<const float*>(c2r);
  const float* inv = static_cast<const float*>(inv_scale);
  const int* fi = static_cast<const int*>(found_inf);
  if (p_dtype == F32 && g_dtype == F32) {
    launch_adam<float, float>(blocks, st, p, g, mm, vv, h, l, a, b, inv, fi,
                              adam_w_mode, n);
  } else if (p_dtype == F32 && g_dtype == BF16) {
    launch_adam<float, __nv_bfloat16>(blocks, st, p, g, mm, vv, h, l, a, b,
                                      inv, fi, adam_w_mode, n);
  } else if (p_dtype == BF16 && g_dtype == BF16) {
    launch_adam<__nv_bfloat16, __nv_bfloat16>(blocks, st, p, g, mm, vv, h, l,
                                              a, b, inv, fi, adam_w_mode, n);
  } else if (p_dtype == BF16 && g_dtype == F32) {
    launch_adam<__nv_bfloat16, float>(blocks, st, p, g, mm, vv, h, l, a, b,
                                      inv, fi, adam_w_mode, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
