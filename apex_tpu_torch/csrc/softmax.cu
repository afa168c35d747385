// Scaled, masked and causal row softmax, forward and backward, for Hopper
// (sm_90a).
//
// Replace three TPU kernels of apex_tpu/ops/softmax.py:
//   _rows_call   (:94, pallas_call :99, body _plain_fwd_kernel :75):
//                softmax(x * scale), unmasked or with the causal mask
//                col > row % sq                -> apex_softmax_fwd
//   _sms_fwd     (:143, pallas_call :166, body _masked_fwd_kernel :69):
//                the same with a (b, 1, sq, sk) mask, nonzero = masked
//                                              -> apex_softmax_masked_fwd
//   _softmax_vjp (:184, pallas_call :196, body _softmax_bwd_kernel :87):
//                dx = (dy - sum(y * dy)) * y * scale -> apex_softmax_bwd
// over a (rows, sk) view, sk a multiple of 128 up to 4096 (the reference's
// gate, _use_pallas); x, y, dy and dx in f32, bf16 or fp16, every sum in
// f32.  GPT-2 small's causal attention runs the forward at 96 x 1024 rows
// of 1024, BERT-Large's masked one at 128 x 512 rows of 512.
//
// What bounds them: bytes.  A row costs a handful of f32 operations an
// element (scale, max, exp, sum, divide) against 4-12 bytes moved, far
// below the card's ~20 operations per byte; the least time is reading x
// (dy and y) once and writing y (dx) once at 3.35 TB/s.  The causal
// forward reads only the lower triangle: for a row that is alive (its max
// above -5000) every masked entry is exp(-10000 - max) == 0 in f32, so
// skipping it changes no bit; the kernel still writes its zeros.
//
// Design.  The TPU kernel softmaxes a block of up to 256 rows in VMEM.
// Here a row lives in registers: one warp a row for sk <= 1024 (four rows
// a 128-thread block), one 128-thread block a row above that.  Each thread
// holds at most 32 elements, loaded and stored as 16-byte vectors
// (neighbouring threads, neighbouring vectors); since sk is a multiple of
// 128 a vector is either wholly in the row or wholly past it.  One pass
// over the row: load, scale and fill, max, exp, sum, divide, store.
// Sums and maxima go through a fixed shuffle tree (and, for a block, the
// warps' partials in warp order): no atomics, the same bits every run.
// The mask is read from its (b, sq, sk) bytes through the batch index of
// the row's head (head / np): never copied across heads.
//
// Arithmetic is the reference body's, in its order, with explicit
// roundings (no contraction into FMAs): f = x * scale, then f = -10000
// where masked, m = max(f) (NaN propagates, as jnp.max does), e =
// expf(f - m), s = sum(e), y = e / s (a division, not a product by
// 1 / s) where m > -5000, else exact zeros; dx = ((dy - inner) * y) *
// scale with inner = sum(y * dy).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;     // four warps a block
constexpr int MAX_SK = 4096;
constexpr int PER_THREAD = 32;   // elements a thread holds, at most
constexpr float NEG = -10000.f;  // the reference's mask fill (_NEG)
constexpr float ALIVE = -5000.f; // a row is alive when its max > NEG / 2

enum Dtype { F32 = 0, BF16 = 1, F16 = 2 };
enum Mode { PLAIN = 0, CAUSAL = 1, MASKED = 2 };

// 16 bytes of T to floats and back (round to nearest even).
template <typename T> struct Pack;

template <> struct Pack<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <> struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = __bfloat162float(h[i]);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 r;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&r);
#pragma unroll
    for (int i = 0; i < N; ++i) h[i] = __float2bfloat16_rn(v[i]);
    *reinterpret_cast<uint4*>(p) = r;
  }
};

template <> struct Pack<__half> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __half* p, float* v) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __half* h = reinterpret_cast<const __half*>(&r);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = __half2float(h[i]);
  }
  __device__ __forceinline__ static void store(__half* p, const float* v) {
    uint4 r;
    __half* h = reinterpret_cast<__half*>(&r);
#pragma unroll
    for (int i = 0; i < N; ++i) h[i] = __float2half_rn(v[i]);
    *reinterpret_cast<uint4*>(p) = r;
  }
};

// N mask bytes (N = 4 or 8, aligned to N) as flags: nonzero = masked.
template <int N>
__device__ __forceinline__ void load_flags(const uint8_t* p, bool* f) {
  if constexpr (N == 4) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = ((w >> (8 * i)) & 0xffu) != 0u;
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i] = ((w.x >> (8 * i)) & 0xffu) != 0u;
      f[4 + i] = ((w.y >> (8 * i)) & 0xffu) != 0u;
    }
  }
}

// max that propagates NaN, as jnp.max and torch.amax do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The max (MAX) or sum of `v` over the WPR warps of one row; every thread
// of the row gets the same bits.  `sh` holds 4 floats (WPR > 1 only: one
// row a block).
template <int WPR, bool MAX>
__device__ __forceinline__ float row_reduce(float v, float* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? nan_max(v, w) : __fadd_rn(v, w);
  }
  if (WPR == 1) return v;
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = sh[0];
#pragma unroll
  for (int w = 1; w < WPR; ++w) r = MAX ? nan_max(r, sh[w]) : __fadd_rn(r, sh[w]);
  __syncthreads();                 // sh is free again for the next reduce
  return r;
}

// One row of `sk` elements for each group of WPR warps.  Chunk c of
// thread t of the row covers columns [(c * 32 * WPR + t) * N, + N).
template <typename T, int MODE, int WPR>
__global__ void __launch_bounds__(THREADS)
softmax_fwd_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                   T* __restrict__ y, long long rows, int sk, int sq, int np,
                   float scale) {
  constexpr int N = Pack<T>::N;
  constexpr int NC = PER_THREAD / N;
  constexpr int TPR = 32 * WPR;
  __shared__ float sh[4];
  const int t = threadIdx.x % TPR;
  const long long row = static_cast<long long>(blockIdx.x) * (THREADS / TPR) +
                        threadIdx.x / TPR;
  if (row >= rows) return;         // a whole warp (WPR == 1) or block
  const long long off = row * sk;
  const int q = static_cast<int>(row % sq);   // causal: the last visible col
  const uint8_t* mr = nullptr;
  if (MODE == MASKED) {
    const long long batch = row / sq / np;
    mr = mask + (batch * sq + q) * static_cast<long long>(sk);
  }

  float v[NC][N];
  float m = -__int_as_float(0x7f800000);   // -inf
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = (c * TPR + t) * N;
    const bool in = col < sk && (MODE != CAUSAL || col <= q);
    if (in) {
      Pack<T>::load(x + off + col, v[c]);
      bool masked[N];
      if (MODE == MASKED) load_flags<N>(mr + col, masked);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float f = __fmul_rn(v[c][i], scale);
        if (MODE == CAUSAL && col + i > q) f = NEG;
        if (MODE == MASKED && masked[i]) f = NEG;
        v[c][i] = f;
        m = nan_max(m, f);
      }
    }
  }
  m = row_reduce<WPR, true>(m, sh);
  const bool alive = m > ALIVE;

  float s = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = (c * TPR + t) * N;
    if (col < sk && (MODE != CAUSAL || col <= q)) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        v[c][i] = expf(__fsub_rn(v[c][i], m));
        s = __fadd_rn(s, v[c][i]);
      }
    }
  }
  s = row_reduce<WPR, false>(s, sh);

#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = (c * TPR + t) * N;
    if (col < sk) {
      float o[N];
      const bool in = alive && (MODE != CAUSAL || col <= q);
#pragma unroll
      for (int i = 0; i < N; ++i) o[i] = in ? __fdiv_rn(v[c][i], s) : 0.f;
      Pack<T>::store(y + off + col, o);
    }
  }
}

template <typename T, int WPR>
__global__ void __launch_bounds__(THREADS)
softmax_bwd_kernel(const T* __restrict__ y, const T* __restrict__ dy,
                   T* __restrict__ dx, long long rows, int sk, float scale) {
  constexpr int N = Pack<T>::N;
  constexpr int NC = PER_THREAD / N;
  constexpr int TPR = 32 * WPR;
  __shared__ float sh[4];
  const int t = threadIdx.x % TPR;
  const long long row = static_cast<long long>(blockIdx.x) * (THREADS / TPR) +
                        threadIdx.x / TPR;
  if (row >= rows) return;
  const long long off = row * sk;

  float yv[NC][N], gv[NC][N];
  float inner = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = (c * TPR + t) * N;
    if (col < sk) {
      Pack<T>::load(y + off + col, yv[c]);
      Pack<T>::load(dy + off + col, gv[c]);
#pragma unroll
      for (int i = 0; i < N; ++i) inner = __fadd_rn(inner, __fmul_rn(yv[c][i], gv[c][i]));
    }
  }
  inner = row_reduce<WPR, false>(inner, sh);

#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = (c * TPR + t) * N;
    if (col < sk) {
      float o[N];
#pragma unroll
      for (int i = 0; i < N; ++i)
        o[i] = __fmul_rn(__fmul_rn(__fsub_rn(gv[c][i], inner), yv[c][i]), scale);
      Pack<T>::store(dx + off + col, o);
    }
  }
}

bool bad_geometry(long long rows, int sk) {
  return rows <= 0 || rows >= (1LL << 31) || sk <= 0 || sk > MAX_SK ||
         sk % 128 != 0;
}

// One warp a row up to 1024 columns (32 lanes x 32 elements), else one
// block a row (4 warps x 32 lanes x 32 elements = 4096).
template <typename T, int MODE>
void launch_fwd(const void* x, const void* mask, void* y, long long rows,
                int sk, int sq, int np, float scale, cudaStream_t st) {
  const T* xx = static_cast<const T*>(x);
  const uint8_t* mm = static_cast<const uint8_t*>(mask);
  T* yy = static_cast<T*>(y);
  if (sk <= 32 * PER_THREAD) {
    const unsigned grid = static_cast<unsigned>((rows + 3) / 4);
    softmax_fwd_kernel<T, MODE, 1><<<grid, THREADS, 0, st>>>(xx, mm, yy, rows, sk, sq, np, scale);
  } else {
    softmax_fwd_kernel<T, MODE, 4><<<static_cast<unsigned>(rows), THREADS, 0, st>>>(
        xx, mm, yy, rows, sk, sq, np, scale);
  }
}

template <int MODE>
int dispatch_fwd(const void* x, int dtype, const void* mask, void* y,
                 long long rows, int sk, int sq, int np, float scale,
                 cudaStream_t st) {
  if (bad_geometry(rows, sk) || sq <= 0 || np <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == F32) {
    launch_fwd<float, MODE>(x, mask, y, rows, sk, sq, np, scale, st);
  } else if (dtype == BF16) {
    launch_fwd<__nv_bfloat16, MODE>(x, mask, y, rows, sk, sq, np, scale, st);
  } else if (dtype == F16) {
    launch_fwd<__half, MODE>(x, mask, y, rows, sk, sq, np, scale, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
void launch_bwd(const void* y, const void* dy, void* dx, long long rows,
                int sk, float scale, cudaStream_t st) {
  const T* yy = static_cast<const T*>(y);
  const T* gg = static_cast<const T*>(dy);
  T* dd = static_cast<T*>(dx);
  if (sk <= 32 * PER_THREAD) {
    const unsigned grid = static_cast<unsigned>((rows + 3) / 4);
    softmax_bwd_kernel<T, 1><<<grid, THREADS, 0, st>>>(yy, gg, dd, rows, sk, scale);
  } else {
    softmax_bwd_kernel<T, 4><<<static_cast<unsigned>(rows), THREADS, 0, st>>>(
        yy, gg, dd, rows, sk, scale);
  }
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`,
// allocates nothing (the wrapper passes the output), and returns
// cudaGetLastError() after its launch (0 when it was accepted).  Dtype
// codes: 0 float32, 1 bfloat16, 2 float16.  Every pointer is 16-byte
// aligned and every array a contiguous (rows, sk) view; the wrapper
// checks.

// y = softmax(x * scale) per row; causal != 0 masks col > row % sq.
extern "C" int apex_softmax_fwd(const void* x, int dtype, void* y,
                                long long rows, int sk, int sq, int causal,
                                float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (causal) return dispatch_fwd<CAUSAL>(x, dtype, nullptr, y, rows, sk, sq, 1, scale, st);
  return dispatch_fwd<PLAIN>(x, dtype, nullptr, y, rows, sk, sq, 1, scale, st);
}

// x (b, np, sq, sk) as rows; mask (b, sq, sk) bytes, nonzero = masked; row
// r reads mask row ((r / sq) / np) * sq + r % sq.
extern "C" int apex_softmax_masked_fwd(const void* x, int dtype,
                                       const void* mask, void* y,
                                       long long rows, int sk, int sq, int np,
                                       float scale, void* stream) {
  return dispatch_fwd<MASKED>(x, dtype, mask, y, rows, sk, sq, np, scale,
                              static_cast<cudaStream_t>(stream));
}

// dx = (dy - sum(y * dy)) * y * scale per row, in y's dtype.
extern "C" int apex_softmax_bwd(const void* y, const void* dy, int dtype,
                                void* dx, long long rows, int sk, float scale,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_geometry(rows, sk)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == F32) {
    launch_bwd<float>(y, dy, dx, rows, sk, scale, st);
  } else if (dtype == BF16) {
    launch_bwd<__nv_bfloat16>(y, dy, dx, rows, sk, scale, st);
  } else if (dtype == F16) {
    launch_bwd<__half>(y, dy, dx, rows, sk, scale, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
