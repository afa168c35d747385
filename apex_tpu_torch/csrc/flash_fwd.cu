// Flash-attention forward for Hopper (sm_90a), on the CUDA cores.
//
// Replaces the TPU kernel apex_tpu/ops/attention.py::_fwd_pallas
// (_fwd_kernel and _fwd_kernel_1kv) without dropout.  Same semantics:
// q (B,H,Sq,D), k/v (B,HK,Sk,D) contiguous, f32 or bf16; query head h
// reads kv head h / (H/HK); the causal mask is the absolute col <= row;
// the optional segment mask keeps q_ids[b,row] == kv_ids[b,col]; a row
// that sees no key writes exact zeros.  When `lse` is given (training:
// the backward kernels recompute P from it) the kernel also writes the
// f32 logsumexp m + log(l) of every row, (B*H, Sq), -1e30 where l == 0
// (the reference's need_lse=True); the primal path passes null.
//
// bf16 follows the reference's arithmetic: operands convert to f32 on
// load (a product of two bf16 values is exact in f32, so f32 FMAs
// compute what the MXU's bf16 products with f32 accumulation do), the
// probabilities are rounded to bf16 before P.V (`p.astype(v.dtype)`),
// the row sum l takes them unrounded, and o is rounded to bf16 once.
//
// What bounds it: arithmetic.  The precision contract (docs/kernels.md)
// makes f32 operands true f32, so the tensor cores (TF32 at best) are out
// for them and the work runs on the FMA units, 67 TFLOP/s on an H100
// SXM; bf16 runs on the same units here (the simple first kernel).  A
// causal prefill does about S/8 operations per byte of q/k/v/o it must
// move (64 at S=512), against the card's 67e12/3.35e12 = 20 for f32
// outside the tensor cores, so bytes are not the limit.  The design
// keeps every operand of the inner loop on chip: one CTA owns BQ=64
// query rows of one (batch, head) and walks the key/value rows in tiles
// of BK=32 staged through shared memory as f32, with the flash-2 online
// softmax (running max m, running sum l, unnormalised accumulator) in
// registers.  Each query row is split over TPQ = D/32 threads (one
// thread for D <= 32), each owning 32 of its D columns as float4 chunks
// interleaved across the group, so a warp's shared-memory reads of one
// key row hit TPQ neighbouring 16-byte words (a broadcast, no bank
// conflict) and the partial dot products meet through log2(TPQ) warp
// shuffles.  Under the causal mask the key loop stops at the CTA's
// diagonal tile (the TPU kernel's clamped index map).  No wgmma, TMA or
// warp specialisation yet.
//
// Masked scores use the -1e30 sentinel of the TPU kernel and their
// probabilities are forced to 0 explicitly, so exp() never sees
// (-inf) - (-inf) and a fully masked row ends with l == 0 and acc == 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 32;          // key rows per shared-memory tile
constexpr float NEG = -1e30f;   // the TPU kernel's mask sentinel

enum Dtype { F32 = 0, BF16 = 1 };

template <int D>
struct Geo {
  static constexpr int DPT = D < 32 ? D : 32;   // columns per thread
  static constexpr int TPQ = D / DPT;           // threads per query row
  static constexpr int C4 = DPT / 4;            // float4 chunks per thread
  static constexpr int THREADS = BQ * TPQ;
};

// Four consecutive elements as f32 (index in units of four elements).
__device__ __forceinline__ float4 load4(const float* p, size_t i4) {
  return reinterpret_cast<const float4*>(p)[i4];
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, size_t i4) {
  const uint2 u = reinterpret_cast<const uint2*>(p)[i4];
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, size_t i4, float4 v) {
  reinterpret_cast<float4*>(p)[i4] = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, size_t i4, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  reinterpret_cast<uint2*>(p)[i4] = u;
}

// x as the P.V operand: unchanged in f32, rounded to bf16 for bf16.
template <typename T>
__device__ __forceinline__ float operand(float x) { return x; }
template <>
__device__ __forceinline__ float operand<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 axpy4(float p, float4 x, float4 y) {
  return make_float4(fmaf(p, x.x, y.x), fmaf(p, x.y, y.y),
                     fmaf(p, x.z, y.z), fmaf(p, x.w, y.w));
}

__device__ __forceinline__ float4 scale4(float4 x, float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}

template <typename T, int D>
__global__ void __launch_bounds__(Geo<D>::THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ q_ids,
                 const int* __restrict__ kv_ids, int H, int HK, int Sq,
                 int Sk, int causal, float scale) {
  using G = Geo<D>;
  constexpr int D4 = D / 4;
  __shared__ float4 ks[BK][D4];
  __shared__ float4 vs[BK][D4];
  __shared__ int kid[BK];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hk = (bh % H) / (H / HK);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int part = tid % G::TPQ;
  const int row = q0 + tid / G::TPQ;
  const bool row_ok = row < Sq;
  const bool seg = q_ids != nullptr;

  const size_t kvb = (size_t)(b * HK + hk) * Sk * D4;
  const size_t qoff = ((size_t)bh * Sq + (row_ok ? row : 0)) * D4;

  float4 qr[G::C4], acc[G::C4];
#pragma unroll
  for (int c = 0; c < G::C4; ++c) {
    qr[c] = row_ok ? load4(q, qoff + c * G::TPQ + part)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int qid = (seg && row_ok) ? q_ids[(size_t)b * Sq + row] : 0;
  float m = NEG, l = 0.f;

  // causal: no row of this CTA sees a key at or past q0 + BQ
  const int kend = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();   // every thread is done with the previous tile
    for (int i = tid; i < BK * D4; i += G::THREADS) {
      const int j = i / D4, c = i % D4, col = k0 + j;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      ks[j][c] = col < Sk ? load4(k, kvb + (size_t)col * D4 + c) : z;
      vs[j][c] = col < Sk ? load4(v, kvb + (size_t)col * D4 + c) : z;
    }
    if (seg) {
      for (int j = tid; j < BK; j += G::THREADS) {
        const int col = k0 + j;
        kid[j] = col < Sk ? kv_ids[(size_t)b * Sk + col] : 0;
      }
    }
    __syncthreads();

    float s[BK];
    unsigned vis = 0u;
    float mt = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < G::C4; ++c) dot = dot4(qr[c], ks[j][c * G::TPQ + part], dot);
#pragma unroll
      for (int off = G::TPQ / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int col = k0 + j;
      const bool ok = col < Sk && (!causal || col <= row) &&
                      (!seg || kid[j] == qid);
      s[j] = ok ? __fmul_rn(dot, scale) : NEG;
      vis |= (ok ? 1u : 0u) << j;
      mt = fmaxf(mt, s[j]);
    }
    const float alpha = expf(m - mt);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < G::C4; ++c) acc[c] = scale4(acc[c], alpha);
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = ((vis >> j) & 1u) ? expf(s[j] - mt) : 0.f;
      l += p;
      const float pv = operand<T>(p);
#pragma unroll
      for (int c = 0; c < G::C4; ++c)
        acc[c] = axpy4(pv, vs[j][c * G::TPQ + part], acc[c]);
    }
    m = mt;
  }

  if (row_ok) {
    const float linv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int c = 0; c < G::C4; ++c) store4(o, qoff + c * G::TPQ + part, scale4(acc[c], linv));
    if (lse != nullptr && part == 0)
      lse[(size_t)bh * Sq + row] = l > 0.f ? m + logf(l) : NEG;
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, float* lse,
            const int* q_ids, const int* kv_ids, int B, int H, int HK,
            int Sq, int Sk, int causal, float scale, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, Geo<D>::THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, q_ids, kv_ids, H,
      HK, Sq, Sk, causal, scale);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             const int* qi, const int* ki, int B, int H, int HK, int Sq,
             int Sk, int D, int causal, float scale, cudaStream_t st) {
  switch (D) {
    case 16: launch<T, 16>(q, k, v, o, lse, qi, ki, B, H, HK, Sq, Sk, causal, scale, st); break;
    case 32: launch<T, 32>(q, k, v, o, lse, qi, ki, B, H, HK, Sq, Sk, causal, scale, st); break;
    case 64: launch<T, 64>(q, k, v, o, lse, qi, ki, B, H, HK, Sq, Sk, causal, scale, st); break;
    case 128: launch<T, 128>(q, k, v, o, lse, qi, ki, B, H, HK, Sq, Sk, causal, scale, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype: 0 float32, 1
// bfloat16 (q, k, v and o alike).  lse may be null (no logsumexp
// output); q_ids/kv_ids are both null or both set.  Launches on
// `stream`, allocates nothing, and returns cudaGetLastError() after the
// launch (0 when it was accepted).
extern "C" int apex_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, const void* q_ids,
                              const void* kv_ids, int dtype, int B, int H,
                              int HK, int Sq, int Sk, int D, int causal,
                              float scale, void* stream) {
  float* lf = static_cast<float*>(lse);
  const int* qi = static_cast<const int*>(q_ids);
  const int* ki = static_cast<const int*>(kv_ids);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      return dispatch<float>(q, k, v, o, lf, qi, ki, B, H, HK, Sq, Sk, D, causal, scale, st);
    case BF16:
      return dispatch<__nv_bfloat16>(q, k, v, o, lf, qi, ki, B, H, HK, Sq, Sk, D, causal, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
