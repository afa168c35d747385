// Flat-buffer streaming kernels of the training path, for Hopper (sm_90a).
//
// Replace eleven TPU kernels of apex_tpu/ops/multi_tensor.py:
//   flat_scale        (:115, body _scale_kernel :90)
//   flat_axpby        (:162, body _axpby_kernel :141)
//   flat_accumulate   (:207, body _accumulate_kernel :190)
//   flat_unscale_norm (:270, body _unscale_norm_kernel :255)
//   flat_l2norm       (:325, body _l2norm_kernel :314)
//   flat_adam         (:402, body _adam_kernel :351)
//   flat_sgd          (:465, body _sgd_kernel :446)
//   flat_adagrad      (:554, body _adagrad_kernel :528)
//   flat_novograd     (:775, body _novograd_apply_kernel :715)
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
// LAMB stages, flat_adagrad, flat_novograd) return before writing
// anything when the flag is set: the
// reference selects the old values on a skipped step, which an in-place
// update would already have destroyed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int COMBINE_THREADS = 1024;

enum Dtype { F32 = 0, BF16 = 1, F16 = 2 };

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

__device__ __forceinline__ F4 load4(const __half* p, int64_t i) {
  const uint2 u = reinterpret_cast<const uint2*>(p)[i];
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
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

__device__ __forceinline__ void store4(__half* p, int64_t i, F4 v) {
  __half2 a = __floats2half2_rn(v.x, v.y);
  __half2 b = __floats2half2_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  reinterpret_cast<uint2*>(p)[i] = u;
}

__device__ __forceinline__ float load1(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load1(const __half* p, int64_t i) {
  return __half2float(p[i]);
}
__device__ __forceinline__ void store1(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store1(__half* p, int64_t i, float v) {
  p[i] = __float2half_rn(v);
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

// The segment holding element i, at or after `seg` (offs[seg] <= i).
__device__ __forceinline__ int seek_segment(const int64_t* __restrict__ offs,
                                            int seg, int64_t i) {
  while (i >= offs[seg + 1]) ++seg;
  return seg;
}

// The segment holding element i: the last start <= i, by bisection.
__device__ __forceinline__ int find_segment(const int64_t* __restrict__ offs,
                                            int num_segments, int64_t i) {
  int lo = 0, hi = num_segments - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (offs[mid] <= i) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// flat_lamb stage 2: p -= factor[segment] * update in place, where factor
// is the per-segment lr * trust ratio.  The reference gathers the factor
// into a per-element buffer first ((lr * trust)[seg_ids]); here no
// per-element segment id is read either: each CTA takes a contiguous
// range of `per_cta` 4-element vectors (its threads stride it by THREADS
// vectors, so a warp's loads stay contiguous), each thread finds the
// segment of its first element by bisection of the (num_segments + 1)
// table of segment starts (read through the read-only cache) and walks
// the boundaries forward as it goes, holding the segment's end and
// factor in registers.  So the kernel moves 12 bytes an element at f32
// p (p read and written, the f32 update read) and 8 at bf16 p.
// The last CTA also takes the n % 4 tail.  With the overflow flag set it
// writes nothing.
// ---------------------------------------------------------------------------
// The segment walk of one thread: the segment holding element e, at or
// after the one it holds (segments only grow along the thread's walk),
// with that segment's end and factor.
struct SegWalk {
  const int64_t* __restrict__ offs;
  const float* __restrict__ factor;
  int seg;
  int64_t end;
  float f;
  __device__ __forceinline__ void start(int num_segments, int64_t e) {
    seg = find_segment(offs, num_segments, e);
    end = __ldg(offs + seg + 1);
    f = __ldg(factor + seg);
  }
  __device__ __forceinline__ float at(int64_t e) {
    if (e >= end) {
      do {
        ++seg;
        end = __ldg(offs + seg + 1);
      } while (e >= end);
      f = __ldg(factor + seg);
    }
    return f;
  }
};

// Vectors a thread has in flight at once in stage 2 (its loads are all
// issued before the first store): with 12 bytes an element and nothing
// to compute, the bytes in flight set the rate.
constexpr int APPLY_UNROLL = 8;

template <typename P>
__global__ void __launch_bounds__(THREADS)
lamb_apply_kernel(P* __restrict__ p, const float* __restrict__ update,
                  const float* __restrict__ factor,
                  const int64_t* __restrict__ offs, int num_segments,
                  const int* __restrict__ found_inf, int64_t n,
                  int64_t per_cta) {
  if (found_inf != nullptr && *found_inf != 0) return;
  const int64_t n4 = n / 4;
  const int64_t v0 = (int64_t)blockIdx.x * per_cta;
  const int64_t v1 = v0 + per_cta < n4 ? v0 + per_cta : n4;
  SegWalk w{offs, factor, 0, 0, 0.f};
  int64_t i = v0 + threadIdx.x;
  if (i < v1) w.start(num_segments, 4 * i);
  for (; i < v1; i += APPLY_UNROLL * THREADS) {
    F4 pv[APPLY_UNROLL], uv[APPLY_UNROLL];
#pragma unroll
    for (int j = 0; j < APPLY_UNROLL; ++j) {
      const int64_t k = i + j * THREADS;
      if (k < v1) {
        pv[j] = load4(p, k);
        uv[j] = load4(update, k);
      }
    }
#pragma unroll
    for (int j = 0; j < APPLY_UNROLL; ++j) {
      const int64_t k = i + j * THREADS;
      if (k >= v1) break;
      const int64_t e = 4 * k;
      F4 r;
      if (e + 3 < w.end) {                   // the whole vector in one segment
        const float f = w.f;
        r.x = __fsub_rn(pv[j].x, __fmul_rn(f, uv[j].x));
        r.y = __fsub_rn(pv[j].y, __fmul_rn(f, uv[j].y));
        r.z = __fsub_rn(pv[j].z, __fmul_rn(f, uv[j].z));
        r.w = __fsub_rn(pv[j].w, __fmul_rn(f, uv[j].w));
      } else {
        r.x = __fsub_rn(pv[j].x, __fmul_rn(w.at(e), uv[j].x));
        r.y = __fsub_rn(pv[j].y, __fmul_rn(w.at(e + 1), uv[j].y));
        r.z = __fsub_rn(pv[j].z, __fmul_rn(w.at(e + 2), uv[j].z));
        r.w = __fsub_rn(pv[j].w, __fmul_rn(w.at(e + 3), uv[j].w));
      }
      store4(p, k, r);
    }
  }
  if (blockIdx.x == gridDim.x - 1) {         // the last n % 4 elements
    for (int64_t e = n4 * 4 + threadIdx.x; e < n; e += THREADS) {
      w.start(num_segments, e);
      store1(p, e, __fsub_rn(load1(p, e), __fmul_rn(w.f, update[e])));
    }
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


// ---------------------------------------------------------------------------
// Host-side dtype dispatch of the kernels below: calls fn(Tag<T>{}) with
// the storage type of a dtype code (f16 only where HALF is set); false
// for a code the kernel does not take.
// ---------------------------------------------------------------------------
template <typename T>
struct Tag {
  using type = T;
};

template <bool HALF, typename Fn>
bool with_dtype(int code, Fn&& fn) {
  switch (code) {
    case F32:
      fn(Tag<float>{});
      return true;
    case BF16:
      fn(Tag<__nv_bfloat16>{});
      return true;
    case F16:
      if constexpr (HALF) {
        fn(Tag<__half>{});
        return true;
      }
      return false;
    default:
      return false;
  }
}

// ---------------------------------------------------------------------------
// flat_scale: out = x * s in f32, stored in out's dtype; the flag is of
// the f32 product before the cast (a finite f32 that rounds to inf in
// bf16 or f16 does not flag, as in the reference).  s is a device scalar.
// Each element is read and written by one thread, so out may alias x
// when the dtypes agree (no __restrict__ between them).
// ---------------------------------------------------------------------------
template <typename X, typename O>
__global__ void __launch_bounds__(THREADS)
scale_kernel(const X* x, O* out, const float* __restrict__ s_p,
             int* __restrict__ flag, int64_t n) {
  const float s = *s_p;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t n4 = n / 4;
  bool any_bad = false;
  for (int64_t i = tid; i < n4; i += stride) {
    const F4 y = map4(load4(x, i), [&](float v, int) { return __fmul_rn(v, s); });
    store4(out, i, y);
    any_bad |= bad(y.x) | bad(y.y) | bad(y.z) | bad(y.w);
  }
  for (int64_t i = n4 * 4 + tid; i < n; i += stride) {
    const float y = __fmul_rn(load1(x, i), s);
    store1(out, i, y);
    any_bad |= bad(y);
  }
  if (__syncthreads_or(any_bad) && threadIdx.x == 0) atomicOr(flag, 1);
}

// ---------------------------------------------------------------------------
// flat_axpby: out = a*x + b*y in f32 (each product and the sum rounded
// once: no FMA contraction, so the twin's bits hold), stored in out's
// dtype; the flag is of the f32 result.  a and b are device scalars.
// ---------------------------------------------------------------------------
template <typename X, typename Y, typename O>
__global__ void __launch_bounds__(THREADS)
axpby_kernel(const X* x, const Y* y, O* out, const float* __restrict__ a_p,
             const float* __restrict__ b_p, int* __restrict__ flag,
             int64_t n) {
  const float a = *a_p, b = *b_p;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t n4 = n / 4;
  bool any_bad = false;
  for (int64_t i = tid; i < n4; i += stride) {
    const F4 xv = load4(x, i), yv = load4(y, i);
    const F4 r = map4(xv, [&](float xe, int k) {
      return __fadd_rn(__fmul_rn(a, xe), __fmul_rn(b, lane(yv, k)));
    });
    store4(out, i, r);
    any_bad |= bad(r.x) | bad(r.y) | bad(r.z) | bad(r.w);
  }
  for (int64_t i = n4 * 4 + tid; i < n; i += stride) {
    const float r = __fadd_rn(__fmul_rn(a, load1(x, i)), __fmul_rn(b, load1(y, i)));
    store1(out, i, r);
    any_bad |= bad(r);
  }
  if (__syncthreads_or(any_bad) && threadIdx.x == 0) atomicOr(flag, 1);
}

// ---------------------------------------------------------------------------
// flat_adagrad: one Adagrad step in place on p and h, in the order of the
// reference body:
//   g = g * inv_scale + wd * p;  h = h + g*g;  p = p - (lr*g) / (sqrt(h) + eps).
// lr and inv_scale are device scalars; with the overflow flag set the
// kernel writes nothing.  18 bytes an element at f32 p, bf16 g.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float adagrad_elem(float pv, float gv, float& h,
                                              float eps, float wd, float lr,
                                              float inv) {
  const float g = __fadd_rn(__fmul_rn(gv, inv), __fmul_rn(wd, pv));
  h = __fadd_rn(h, __fmul_rn(g, g));
  return __fsub_rn(pv, __fdiv_rn(__fmul_rn(lr, g),
                                 __fadd_rn(__fsqrt_rn(h), eps)));
}

template <typename P, typename G>
__global__ void __launch_bounds__(THREADS)
adagrad_kernel(P* __restrict__ p, const G* __restrict__ g, float* __restrict__ h,
               float eps, float wd, const float* __restrict__ lr_p,
               const float* __restrict__ inv_p,
               const int* __restrict__ found_inf, int64_t n) {
  if (found_inf != nullptr && *found_inf != 0) return;
  const float lr = *lr_p, inv = *inv_p;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t n4 = n / 4;
  for (int64_t i = tid; i < n4; i += stride) {
    const F4 pv = load4(p, i), gv = load4(g, i);
    F4 hv = load4(h, i);
    F4 r;
    r.x = adagrad_elem(pv.x, gv.x, hv.x, eps, wd, lr, inv);
    r.y = adagrad_elem(pv.y, gv.y, hv.y, eps, wd, lr, inv);
    r.z = adagrad_elem(pv.z, gv.z, hv.z, eps, wd, lr, inv);
    r.w = adagrad_elem(pv.w, gv.w, hv.w, eps, wd, lr, inv);
    store4(p, i, r);
    store4(h, i, hv);
  }
  for (int64_t i = n4 * 4 + tid; i < n; i += stride) {
    float hi = h[i];
    store1(p, i, adagrad_elem(load1(p, i), load1(g, i), hi, eps, wd, lr, inv));
    h[i] = hi;
  }
}

// ---------------------------------------------------------------------------
// flat_novograd (the apply step): in place on p and m, in the order of the
// reference body, with the per-segment normalizer denom = sqrt(v) + eps
// (computed before the launch) DIVIDING the unscaled gradient, as the
// plain twin does (the reference's kernel multiplies by a gathered
// 1/denom):
//   gn = (g * inv_scale) / denom[seg]  [+ wd * p  if REG_INSIDE];
//   m  = first ? gn : b1*m + (AVG ? (1-b1)*gn : gn);
//   p  = p - lr * (REG_INSIDE ? m : m + wd * p).
// The segment of an element comes from the (num_segments + 1) table of
// segment starts: each thread finds the segment of its first element by
// bisection, then walks the table forward as its grid-stride loop moves
// up the buffer.  So no per-element segment id is read, and the kernel
// moves 18 bytes an element at f32 p and m, bf16 g (the reference's
// gathered per-element 1/denom would be 4 more, a per-element i32 id
// the same).  lr, inv_scale and first are device scalars; with the
// overflow flag set the kernel writes nothing.
// ---------------------------------------------------------------------------
struct NovoHypers {
  float b1, omb1, wd;   // omb1 = 1 - b1, rounded to f32 once
};

template <bool AVG, bool REG_INSIDE>
__device__ __forceinline__ float novograd_elem(float pv, float gv, float& m,
                                               float denom,
                                               const NovoHypers& h, float lr,
                                               float inv, bool first) {
  float gn = __fdiv_rn(__fmul_rn(gv, inv), denom);
  if (REG_INSIDE) gn = __fadd_rn(gn, __fmul_rn(h.wd, pv));
  m = first ? gn : __fadd_rn(__fmul_rn(h.b1, m), AVG ? __fmul_rn(h.omb1, gn) : gn);
  const float u = REG_INSIDE ? m : __fadd_rn(m, __fmul_rn(h.wd, pv));
  return __fsub_rn(pv, __fmul_rn(lr, u));
}

template <typename P, typename G, bool AVG, bool REG_INSIDE>
__global__ void __launch_bounds__(THREADS)
novograd_kernel(P* __restrict__ p, const G* __restrict__ g, float* __restrict__ m,
                const float* __restrict__ denom,
                const int64_t* __restrict__ offs, int num_segments,
                NovoHypers h, const float* __restrict__ lr_p,
                const float* __restrict__ inv_p,
                const int* __restrict__ first_p,
                const int* __restrict__ found_inf, int64_t n) {
  if (found_inf != nullptr && *found_inf != 0) return;
  const float lr = *lr_p, inv = *inv_p;
  const bool first = *first_p != 0;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t n4 = n / 4;
  // the first element this thread touches; later ones only grow
  int seg = find_segment(offs, num_segments, tid < n4 ? 4 * tid : n4 * 4 + tid);
  for (int64_t i = tid; i < n4; i += stride) {
    const F4 pv = load4(p, i), gv = load4(g, i);
    F4 mv = load4(m, i);
    F4 r;
    seg = seek_segment(offs, seg, 4 * i);
    r.x = novograd_elem<AVG, REG_INSIDE>(pv.x, gv.x, mv.x, denom[seg], h, lr, inv, first);
    seg = seek_segment(offs, seg, 4 * i + 1);
    r.y = novograd_elem<AVG, REG_INSIDE>(pv.y, gv.y, mv.y, denom[seg], h, lr, inv, first);
    seg = seek_segment(offs, seg, 4 * i + 2);
    r.z = novograd_elem<AVG, REG_INSIDE>(pv.z, gv.z, mv.z, denom[seg], h, lr, inv, first);
    seg = seek_segment(offs, seg, 4 * i + 3);
    r.w = novograd_elem<AVG, REG_INSIDE>(pv.w, gv.w, mv.w, denom[seg], h, lr, inv, first);
    store4(p, i, r);
    store4(m, i, mv);
  }
  for (int64_t i = n4 * 4 + tid; i < n; i += stride) {
    seg = seek_segment(offs, seg, i);
    float mi = m[i];
    store1(p, i, novograd_elem<AVG, REG_INSIDE>(load1(p, i), load1(g, i), mi,
                                                denom[seg], h, lr, inv, first));
    m[i] = mi;
  }
}

template <typename P, typename G>
void launch_novograd(int blocks, cudaStream_t st, void* p, const void* g,
                     float* m, const float* denom, const int64_t* offs,
                     int num_segments, const NovoHypers& h, const float* lr,
                     const float* inv, const int* first, const int* found_inf,
                     int grad_averaging, int reg_inside, int64_t n) {
  P* pp = static_cast<P*>(p);
  const G* gg = static_cast<const G*>(g);
#define APEX_NOVOGRAD(AVG, RIM)                                           \
  novograd_kernel<P, G, AVG, RIM><<<blocks, THREADS, 0, st>>>(            \
      pp, gg, m, denom, offs, num_segments, h, lr, inv, first, found_inf, n)
  if (grad_averaging && reg_inside) {
    APEX_NOVOGRAD(true, true);
  } else if (grad_averaging) {
    APEX_NOVOGRAD(true, false);
  } else if (reg_inside) {
    APEX_NOVOGRAD(false, true);
  } else {
    APEX_NOVOGRAD(false, false);
  }
#undef APEX_NOVOGRAD
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

// Stage 2 of LAMB: factor the per-segment f32 lr * trust, seg_offsets
// the (num_segments + 1) i64 segment starts.  found_inf may be null (no
// gate).  The CTAs share the n / 4 vectors in equal contiguous ranges:
// one pass of a CTA's unrolled loads each, up to APPLY_MAX_BLOCKS (about
// 16 CTAs an SM of an H100).  The bits do not depend on the grid: each
// element is updated on its own.
constexpr int64_t APPLY_MAX_BLOCKS = 2048;

extern "C" int apex_flat_lamb_apply(void* p, int p_dtype, const void* update,
                                    const void* factor,
                                    const void* seg_offsets, int num_segments,
                                    const void* found_inf, long long n,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_segments < 1 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per_pass = static_cast<int64_t>(APPLY_UNROLL) * THREADS;
  const int64_t want = (n / 4 + per_pass - 1) / per_pass;
  const int blocks = static_cast<int>(
      want < 1 ? 1 : (want > APPLY_MAX_BLOCKS ? APPLY_MAX_BLOCKS : want));
  const float* u = static_cast<const float*>(update);
  const float* f = static_cast<const float*>(factor);
  const int64_t* offs = static_cast<const int64_t*>(seg_offsets);
  const int* fi = static_cast<const int*>(found_inf);
  const int64_t per_cta = (n / 4 + blocks - 1) / blocks;
  switch (p_dtype) {
    case F32:
      lamb_apply_kernel<float><<<blocks, THREADS, 0, st>>>(
          static_cast<float*>(p), u, f, offs, num_segments, fi, n, per_cta);
      break;
    case BF16:
      lamb_apply_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
          static_cast<__nv_bfloat16*>(p), u, f, offs, num_segments, fi, n,
          per_cta);
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

// out = x * scale (x and out each f32, bf16 or f16).  The wrapper zeroes
// the flag.
extern "C" int apex_flat_scale(const void* x, int x_dtype, void* out,
                               int out_dtype, const void* scale, void* flag,
                               long long n, int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  int* f = static_cast<int*>(flag);
  bool ok = false;
  with_dtype<true>(x_dtype, [&](auto xt) {
    using X = typename decltype(xt)::type;
    ok = with_dtype<true>(out_dtype, [&](auto ot) {
      using O = typename decltype(ot)::type;
      scale_kernel<X, O><<<blocks, THREADS, 0, st>>>(
          static_cast<const X*>(x), static_cast<O*>(out), s, f, n);
    });
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// out = a*x + b*y (x, y and out each f32, bf16 or f16).  The wrapper
// zeroes the flag.
extern "C" int apex_flat_axpby(const void* x, int x_dtype, const void* y,
                               int y_dtype, void* out, int out_dtype,
                               const void* a, const void* b, void* flag,
                               long long n, int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  int* f = static_cast<int*>(flag);
  bool ok = false;
  with_dtype<true>(x_dtype, [&](auto xt) {
    using X = typename decltype(xt)::type;
    with_dtype<true>(y_dtype, [&](auto yt) {
      using Y = typename decltype(yt)::type;
      ok = with_dtype<true>(out_dtype, [&](auto ot) {
        using O = typename decltype(ot)::type;
        axpby_kernel<X, Y, O><<<blocks, THREADS, 0, st>>>(
            static_cast<const X*>(x), static_cast<const Y*>(y),
            static_cast<O*>(out), ap, bp, f, n);
      });
    });
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// One Adagrad step (p and g each f32 or bf16, h f32).  found_inf may be
// null (no gate).
extern "C" int apex_flat_adagrad(void* p, int p_dtype, const void* g,
                                 int g_dtype, void* h, float eps,
                                 float weight_decay, const void* lr,
                                 const void* inv_scale, const void* found_inf,
                                 long long n, int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* hh = static_cast<float*>(h);
  const float* l = static_cast<const float*>(lr);
  const float* inv = static_cast<const float*>(inv_scale);
  const int* fi = static_cast<const int*>(found_inf);
  bool ok = false;
  with_dtype<false>(p_dtype, [&](auto pt) {
    using P = typename decltype(pt)::type;
    ok = with_dtype<false>(g_dtype, [&](auto gt) {
      using G = typename decltype(gt)::type;
      adagrad_kernel<P, G><<<blocks, THREADS, 0, st>>>(
          static_cast<P*>(p), static_cast<const G*>(g), hh, eps, weight_decay,
          l, inv, fi, n);
    });
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The NovoGrad apply step (p and g each f32 or bf16, m f32); denom is the
// per-segment sqrt(v) + eps, seg_offsets the (num_segments + 1) i64
// segment starts.  found_inf may be null (no gate).
extern "C" int apex_flat_novograd(
    void* p, int p_dtype, const void* g, int g_dtype, void* m,
    const void* denom, const void* seg_offsets, int num_segments, float beta1,
    float one_minus_beta1, float weight_decay, const void* lr,
    const void* inv_scale, const void* first_run, const void* found_inf,
    int grad_averaging, int reg_inside_moment, long long n, int blocks,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_segments < 1) return static_cast<int>(cudaErrorInvalidValue);
  const NovoHypers h{beta1, one_minus_beta1, weight_decay};
  float* mm = static_cast<float*>(m);
  const float* d = static_cast<const float*>(denom);
  const int64_t* offs = static_cast<const int64_t*>(seg_offsets);
  const float* l = static_cast<const float*>(lr);
  const float* inv = static_cast<const float*>(inv_scale);
  const int* first = static_cast<const int*>(first_run);
  const int* fi = static_cast<const int*>(found_inf);
  bool ok = false;
  with_dtype<false>(p_dtype, [&](auto pt) {
    using P = typename decltype(pt)::type;
    ok = with_dtype<false>(g_dtype, [&](auto gt) {
      using G = typename decltype(gt)::type;
      launch_novograd<P, G>(blocks, st, p, g, mm, d, offs, num_segments, h, l,
                            inv, first, fi, grad_averaging, reg_inside_moment,
                            n);
    });
  });
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
