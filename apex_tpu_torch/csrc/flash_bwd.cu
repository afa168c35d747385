// Flash-attention backward for Hopper (sm_90a): two kernels, dq and
// dk/dv, that recompute the probabilities from the forward's logsumexp.
//
// Replaces the TPU kernels of apex_tpu/ops/attention.py::_bwd_pallas:
// the dq call (:670, body _dq_kernel :503) and the dk/dv call (:702,
// body _dkv_kernel :544).  Same semantics as the forward
// (csrc/flash_fwd.cu): q/dO (B,H,Sq,D), k/v (B,HK,Sk,D) contiguous, f32
// or bf16; lse and di = rowsum(dO * O) are f32 (B*H, Sq); the causal,
// segment and length masks of the forward; grouped-query heads (query
// head h reads kv head h / (H/HK), and dk/dv sum over the H/HK query
// heads of their group).
//
// The routes of both kernels, one rule (a dispatch on shape in
// `dispatch_dq` and `dispatch_dkv`, not a fallback: a failure raises):
//
// - tensor cores, flash_dq_kernel_tc and flash_dkv_kernel_tc: bf16 at D
//   64 and 128 (every path that trains through flash: GPT-2, BERT-Large,
//   Llama-class heads) and at D 256 (the Gemma-class heads of 129..256,
//   padded to 256).
// - CUDA cores, flash_dq_kernel and flash_dkv_kernel: f32 up to D 512 (the
//   precision contract of docs/kernels.md: f32 operands stay true f32,
//   no TF32) and bf16 at D 16 and 32.
// - wide tensor cores, flash_dq_kernel_tc_wide and
//   flash_dkv_kernel_tc_wide: bf16 at D 512 (and the heads of 257..511,
//   padded to it) and D >= 1024 (the powers of two to 8192, then the
//   multiples of 8192: the wrapper pads every wider head to one;
//   wide::tc_takes), D a runtime width, a CTA on a slice of the output's
//   columns (below).
// - wide CUDA cores, flash_dq_kernel_wide and flash_dkv_kernel_wide: f32
//   at those widths, register tiles on the CUDA cores with the column
//   slices of a row block in a thread-block cluster that shares S and dP
//   (below, before the entry points).
//
// Arithmetic, in the reference body's order: s = (q.k) * scale,
// p = exp(s - lse) SELECTED to 0 where masked (a row that sees no key
// has lse = -1e30, so exp overflows to inf there; a multiply by a 0/1
// mask would give NaN), dp = dO.v, ds = p * (dp - di) * scale.  bf16
// rounds where the reference's dtype casts do: p before dV += p^T dO,
// ds before dQ += ds K and dK += ds^T Q; every sum is f32 and each
// result rounds to the dtype once.  Products of bf16 values are exact in
// f32, so the CUDA-core bodies convert on load and run f32 FMAs; the
// tensor cores compute the same bf16-products-f32-sums function.  The
// tensor-core body computes exp as exp2 with log2(e) folded into the
// scale and into lse as it is staged (the result is the same function).
//
// The fused probability dropout (every body's DROP instantiation, taken
// when a seed pointer is given; rate 0 launches the DROP = false bodies)
// rebuilds the forward's mask from the counter hash (hopper_mma.cuh,
// namespace dropout) at the flat (b*H + h, q row, key): dp becomes
// keep * dp / (1 - rate) and ds = p * (dp - di) * scale keeps the
// undropped p; dV takes keep * p / (1 - rate).  di stays rowsum(dO * O).
// dk/dv walks a kv head's query heads, so it hashes at the flat q row
// b*H + hk*(H/HK) + head of the group (the reference's i_flatq).
//
// What bounds the tensor-core dk/dv: at GPT-2 small's (8, 12, 512, 64)
// causal shape a call does 6.46 GFLOP over 38.1 MB, 6.5 us at 989
// TFLOP/s against 11.4 us at 3.35 TB/s: bytes on paper, the latency of
// each CTA's chain of four dependent products in practice.  The design:
// one CTA (one warpgroup) owns 64 key rows of one (batch, kv head); its
// K and V tiles come once by TMA into 128-byte-swizzled shared memory
// and stay there.  It walks the group's query heads in order and, within
// each, the q tiles of BQT = 64 rows from the first that sees its block
// (causal), their q and dO tiles through a two-stage TMA ring with
// mbarrier completion (the next tile's load in flight during this
// one's products); lse, di and the q segment ids are staged beside them
// by the CTA's threads (their rows of Sq floats need not meet TMA's
// 16-byte stride rule).  Key rows are wgmma's M, so every product keeps
// the CTA's 64 rows: S^T = K.Q^T and dP^T = V.dO^T (m64n64k16, A and B
// K-major in shared memory), P^T and dS^T on the accumulator fragments,
// rounded to bf16 in registers as the A operands of dV += P^T.dO and
// dK += dS^T.Q (B MN-major through the transpose bit).  dK and dV stay
// in registers (two 64 x D f32 accumulators: 249 registers at D 128,
// no spills) and are written once.  Only the diagonal tiles, a ragged
// last q tile and tiles under segment ids evaluate the per-element
// mask.  Key blocks run heaviest first (the first key block sees most
// query rows under the causal mask; blockIdx.y counts them, the heads
// in blockIdx.x).  Key rows past Sk are zeros from TMA and never
// stored.
//
// At D 256 one warpgroup's dK and dV (two 64 x 256 f32 accumulators)
// would take 256 registers a thread, past the 255 a thread may hold.
// So the CTA there is two warpgroups over the same 64 key rows, and
// warpgroup w owns the columns [128w, 128w + 128) of both dK and dV:
// the D-128 body's 128 accumulator registers a thread.  Both
// warpgroups compute the whole of S^T and dP^T (over the full D) from
// the shared K, V, q and dO tiles, so nothing passes between them; that
// repeats those two products, 1.5 times the least tensor-core work of
// a tile.  Each pair's dropout hash is computed once in each warpgroup.
// K and V resident and two q/dO stages take 192 KB of shared memory (one
// CTA an SM).  A causal (8, 4, 512, 256) call does 8.6 GFLOP over 50.4
// MB: 8.7 us at 989 TFLOP/s against 15.0 us at 3.35 TB/s.
//
// The tensor-core dq has the forward's geometry: at GPT-2 small's shape
// a call does 4.84 GFLOP over 31.9 MB (4.9 us at 989 TFLOP/s against 9.5
// us at 3.35 TB/s), bound in practice, like dk/dv, by each CTA's chain
// of dependent products.  One CTA (one warpgroup) owns 64 query rows of
// one (batch, head); its Q and dO tiles come once by TMA into
// 128-byte-swizzled shared memory and stay there, and the K and V tiles
// of 64 keys stream through a two-stage TMA ring with mbarrier
// completion (key segment ids staged beside each stage by the CTA's
// threads).  Each thread's two rows keep lse (times log2 e), di and
// their query segment ids in registers.  S = Q.K^T and dP = dO.V^T are
// m64n64k16 products with A and B K-major in shared memory; dS, rounded
// to bf16 in registers, is the A operand of dQ += dS.K (B = the K tile,
// MN-major through the transpose bit: the forward's O += P.V with K in
// V's place).  dQ (D/64 panels of 32 f32 a thread) stays in registers
// and rounds to bf16 once.  The mask, the heaviest-first order of the q
// blocks under the causal mask and the key loop's stop at the diagonal
// tile are the forward's.
//
// At D 256 the same body holds dQ's 64 x 256 f32 (128 registers a
// thread, the D-256 forward's O) beside S and dP (32 each): one
// warpgroup, since the dS fragment replaces S and dP before dQ's
// products.  Q and dO resident (64 KB) and two K/V stages (128 KB) take
// 192 KB of shared memory, one CTA an SM.  A causal (8, 4, 512, 256)
// call does 6.45 GFLOP over 42.1 MB: 6.5 us at 989 TFLOP/s against 12.6
// us at 3.35 TB/s, bytes on paper, each CTA's chain of three dependent
// products in practice: 0.0334 ms there on an H100 at 700 W (193
// TFLOP/s), where the CUDA-core body took 0.4511.  Two warpgroups a CTA,
// each owning half of dQ's panels and both computing S and dP (10 D
// tensor-core FLOP a pair where one takes 6 D), were measured 4-23%
// slower at four causal D-256 shapes and not kept (PERF.md, row 2).
//
// The CUDA-core bodies up to D 512, simple first (about S/4 operations
// per byte moved against the card's 20 for f32 outside the tensor cores:
// bound by arithmetic):
//
// - dq: one CTA per (b*h, BQ query rows), the CUDA-core forward's
//   geometry (BQ 64 up to D 128, 8192/D past it; a row split over D/32
//   threads holding q, dO and the dq accumulator as float4 chunks); it
//   walks the key/value rows in tiles of 32 staged through shared memory
//   as f32, stops at the diagonal tile under the causal mask, and
//   writes dq once.
// - dk/dv: one CTA per (b*hk, BKV key rows: 64 up to D 128, 8192/D
//   past it), a key row split over D/16
//   threads holding k, v and the two accumulators (64 registers of
//   operands at any D); it walks the query group's
//   heads in order and, within each, the query rows from the first that
//   can see its block (causal) in tiles of 32 (q, dO, lse, di, ids
//   staged in shared memory), then writes dk and dv once.
//
// Every body puts B*H (dk/dv: B*HK) on the grid's x, up to 2^31 - 1, and
// the row blocks on y (dq heaviest first under the causal mask).
//
// No atomics: every output element is owned by one thread that sums in a
// fixed order, and the one sum across CTAs (the wide CUDA-core bodies'
// partial scores, over a cluster's distributed shared memory) runs in
// rank order, so a run gives the same bits every time (ROADMAP Queue 2
// idiom (a)).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

constexpr int BK = 32;          // dq: key rows per shared-memory tile
constexpr int BQT = 32;         // dk/dv: query rows per shared-memory tile

enum Dtype { F32 = 0, BF16 = 1 };

// Past D 128 both bodies keep their threads' share of a row (32 columns
// in dq, 16 in dk/dv) and their thread count (256 and 512) by owning
// fewer rows a CTA, as the reference shrinks its sequence blocks as the
// padded width grows; their tiles live in static shared memory while
// they fit its 48 KB (D <= 128: the compiler addresses them as constants)
// and in dynamic shared memory past it (64 KB at D 256, 128 KB at D 512).
template <int D>
struct GeoQ {                                   // dq: 32 columns a thread
  static constexpr int DPT = D < 32 ? D : 32;
  static constexpr int TPR = D / DPT;           // threads per query row
  static constexpr int C4 = DPT / 4;
  static constexpr int BQ = D <= 128 ? 64 : 8192 / D;   // query rows a CTA
  static constexpr int THREADS = BQ * TPR;
  static constexpr int SMEM = 2 * BK * D * 4 + BK * 4;  // K, V tiles, ids
  static constexpr bool DYN = SMEM > 48 * 1024;
};

template <int D>
struct GeoKV {                                  // dk/dv: 16 columns a thread
  static constexpr int DPT = 16;
  static constexpr int TPR = D / DPT;           // threads per key row
  static constexpr int C4 = DPT / 4;
  static constexpr int BKV = D <= 128 ? 64 : 8192 / D;  // key rows a CTA
  static constexpr int THREADS = BKV * TPR;
  // q and dO tiles, then lse, di and the q ids of the tile's rows
  static constexpr int SMEM = 2 * BQT * D * 4 + 3 * BQT * 4;
  static constexpr bool DYN = SMEM > 48 * 1024;
};

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

// x as a GEMM operand of the reference: unchanged in f32, rounded to
// bf16 for bf16 (its `.astype(dtype)` before the dot).
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

// Sum over the TPR neighbouring lanes that share a row.
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// p = exp(s*scale - lse) where visible, else exactly 0; and
// ds = p * (dp - di) * scale, each step rounded once (no contraction).
__device__ __forceinline__ float prob(bool ok, float dot, float scale,
                                      float lse) {
  return ok ? expf(__fsub_rn(__fmul_rn(dot, scale), lse)) : 0.f;
}

__device__ __forceinline__ float dscore(float p, float dp, float di,
                                        float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, di)), scale);
}

// ---------------------------------------------------------------------------
// dq: dq[row] = sum over visible cols of ds[row, col] * k[col]
// ---------------------------------------------------------------------------
template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(GeoQ<D>::THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ di,
                T* __restrict__ dq, const int* __restrict__ q_ids,
                const int* __restrict__ kv_ids, int H, int HK, int Sq,
                int Sk, int causal, float scale, dropout::Params drop) {
  using G = GeoQ<D>;
  constexpr int D4 = D / 4;
  constexpr bool DYN = G::DYN;
  __shared__ float4 ks_st[DYN ? 1 : BK][DYN ? 1 : D4];
  __shared__ float4 vs_st[DYN ? 1 : BK][DYN ? 1 : D4];
  __shared__ int kid_st[DYN ? 1 : BK];
  extern __shared__ float4 fma_smem[];
  float4 (*ks)[D4] = DYN ? reinterpret_cast<float4 (*)[D4]>(fma_smem)
                         : reinterpret_cast<float4 (*)[D4]>(ks_st);
  float4 (*vs)[D4] = DYN ? reinterpret_cast<float4 (*)[D4]>(fma_smem + BK * D4)
                         : reinterpret_cast<float4 (*)[D4]>(vs_st);
  int* kid = DYN ? reinterpret_cast<int*>(fma_smem + 2 * BK * D4) : kid_st;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int hk = (bh % H) / (H / HK);
  // heaviest first: under the causal mask the last q block sees most keys
  const int q0 = (gridDim.y - 1 - blockIdx.y) * G::BQ;
  const int tid = threadIdx.x;
  const int part = tid % G::TPR;
  const int row = q0 + tid / G::TPR;
  const bool row_ok = row < Sq;
  const bool seg = q_ids != nullptr;
  const uint32_t rkey =
      DROP ? dropout::row_key(dropout::head_key(*drop.seed, bh), row) : 0u;

  const size_t kvb = (size_t)(b * HK + hk) * Sk * D4;
  const size_t qrow = (size_t)bh * Sq + (row_ok ? row : 0);
  const size_t qoff = qrow * D4;

  float4 qr[G::C4], dr[G::C4], acc[G::C4];
#pragma unroll
  for (int c = 0; c < G::C4; ++c) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    qr[c] = row_ok ? load4(q, qoff + c * G::TPR + part) : z;
    dr[c] = row_ok ? load4(dout, qoff + c * G::TPR + part) : z;
    acc[c] = z;
  }
  const float lse_r = row_ok ? lse[qrow] : 0.f;
  const float di_r = row_ok ? di[qrow] : 0.f;
  const int qid = (seg && row_ok) ? q_ids[(size_t)b * Sq + row] : 0;

  const int kend = causal ? min(Sk, q0 + G::BQ) : Sk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
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

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float sd = 0.f, pd = 0.f;
#pragma unroll
      for (int c = 0; c < G::C4; ++c) {
        sd = dot4(qr[c], ks[j][c * G::TPR + part], sd);
        pd = dot4(dr[c], vs[j][c * G::TPR + part], pd);
      }
      sd = row_sum<G::TPR>(sd);
      pd = row_sum<G::TPR>(pd);
      const int col = k0 + j;
      const bool ok = row_ok && col < Sk && (!causal || col <= row) &&
                      (!seg || kid[j] == qid);
      const float p = prob(ok, sd, scale, lse_r);
      if (DROP) pd = dropout::apply(drop, dropout::col_key(rkey, col), pd);
      const float ds = operand<T>(dscore(p, pd, di_r, scale));
#pragma unroll
      for (int c = 0; c < G::C4; ++c)
        acc[c] = axpy4(ds, ks[j][c * G::TPR + part], acc[c]);
    }
  }

  if (row_ok) {
#pragma unroll
    for (int c = 0; c < G::C4; ++c) store4(dq, qoff + c * G::TPR + part, acc[c]);
  }
}

// ---------------------------------------------------------------------------
// dk/dv: for a key row col of kv head hk, over the query heads h of its
// group and their visible rows r (in a fixed order):
//   dv[col] += p[r, col] * dO[r];  dk[col] += ds[r, col] * q[r]
// ---------------------------------------------------------------------------
// CTAs an SM the register budget must allow: bf16 fits 128 registers,
// two CTAs at D <= 64; f32 takes one CTA rather than spill its float4
// operands (at D = 128 its 512 threads cap it at 128 all the same)
template <typename T, int D>
struct DkvMinBlocks {
  static constexpr int value =
      (sizeof(T) == 4 || GeoKV<D>::THREADS > 256) ? 1 : 2;
};

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(GeoKV<D>::THREADS, DkvMinBlocks<T, D>::value)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ di,
                 T* __restrict__ dk, T* __restrict__ dv,
                 const int* __restrict__ q_ids,
                 const int* __restrict__ kv_ids, int H, int HK, int Sq,
                 int Sk, int causal, float scale, dropout::Params drop) {
  using G = GeoKV<D>;
  constexpr int D4 = D / 4;
  constexpr bool DYN = G::DYN;
  __shared__ float4 qs_st[DYN ? 1 : BQT][DYN ? 1 : D4];
  __shared__ float4 dos_st[DYN ? 1 : BQT][DYN ? 1 : D4];
  __shared__ float lses_st[DYN ? 1 : BQT];
  __shared__ float dis_st[DYN ? 1 : BQT];
  __shared__ int qid_st[DYN ? 1 : BQT];
  extern __shared__ float4 fma_smem[];
  float* const dyn_rows = reinterpret_cast<float*>(fma_smem + 2 * BQT * D4);
  float4 (*qs)[D4] = DYN ? reinterpret_cast<float4 (*)[D4]>(fma_smem)
                         : reinterpret_cast<float4 (*)[D4]>(qs_st);
  float4 (*dos)[D4] = DYN ? reinterpret_cast<float4 (*)[D4]>(fma_smem + BQT * D4)
                          : reinterpret_cast<float4 (*)[D4]>(dos_st);
  float* lses = DYN ? dyn_rows : lses_st;
  float* dis = DYN ? dyn_rows + BQT : dis_st;
  int* qid = DYN ? reinterpret_cast<int*>(dyn_rows + 2 * BQT) : qid_st;

  const int bhk = blockIdx.x;
  const int b = bhk / HK;
  const int hk = bhk % HK;
  const int group = H / HK;
  // the first key block sees most query rows under the causal mask
  const int c0 = blockIdx.y * G::BKV;
  const int tid = threadIdx.x;
  const int part = tid % G::TPR;
  const int col = c0 + tid / G::TPR;
  const bool col_ok = col < Sk;
  const bool seg = q_ids != nullptr;

  const size_t kvoff = ((size_t)bhk * Sk + (col_ok ? col : 0)) * D4;
  float4 kr[G::C4], vr[G::C4], dka[G::C4], dva[G::C4];
#pragma unroll
  for (int c = 0; c < G::C4; ++c) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    kr[c] = col_ok ? load4(k, kvoff + c * G::TPR + part) : z;
    vr[c] = col_ok ? load4(v, kvoff + c * G::TPR + part) : z;
    dka[c] = z;
    dva[c] = z;
  }
  const int kid = (seg && col_ok) ? kv_ids[(size_t)b * Sk + col] : 0;

  // causal: rows before c0 see none of this block's keys
  const int rstart = causal ? (min(c0, Sq) / BQT) * BQT : 0;
  for (int hh = 0; hh < group; ++hh) {
    const int bh = b * H + hk * group + hh;   // the flat q row
    const size_t rowb = (size_t)bh * Sq;
    const uint32_t ckey =
        DROP ? dropout::col_key(dropout::head_key(*drop.seed, bh), col) : 0u;
    for (int r0 = rstart; r0 < Sq; r0 += BQT) {
      __syncthreads();
      for (int i = tid; i < BQT * D4; i += G::THREADS) {
        const int j = i / D4, c = i % D4, r = r0 + j;
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        qs[j][c] = r < Sq ? load4(q, (rowb + r) * D4 + c) : z;
        dos[j][c] = r < Sq ? load4(dout, (rowb + r) * D4 + c) : z;
      }
      for (int j = tid; j < BQT; j += G::THREADS) {
        const int r = r0 + j;
        lses[j] = r < Sq ? lse[rowb + r] : 0.f;
        dis[j] = r < Sq ? di[rowb + r] : 0.f;
        qid[j] = (seg && r < Sq) ? q_ids[(size_t)b * Sq + r] : 0;
      }
      __syncthreads();

#pragma unroll 2
      for (int i = 0; i < BQT; ++i) {
        float sd = 0.f, pd = 0.f;
#pragma unroll
        for (int c = 0; c < G::C4; ++c) {
          sd = dot4(kr[c], qs[i][c * G::TPR + part], sd);
          pd = dot4(vr[c], dos[i][c * G::TPR + part], pd);
        }
        sd = row_sum<G::TPR>(sd);
        pd = row_sum<G::TPR>(pd);
        const int r = r0 + i;
        const bool ok = col_ok && r < Sq && (!causal || col <= r) &&
                        (!seg || qid[i] == kid);
        const float p = prob(ok, sd, scale, lses[i]);
        float pd_p = p;   // the p of dV: keep * p / (1 - rate) under DROP
        if (DROP) {
          const bool keep = dropout::kept(drop, dropout::row_key(ckey, r));
          pd_p = dropout::scaled(drop, keep, p);
          pd = dropout::scaled(drop, keep, pd);
        }
        const float pv = operand<T>(pd_p);
        const float ds = operand<T>(dscore(p, pd, dis[i], scale));
#pragma unroll
        for (int c = 0; c < G::C4; ++c) {
          dva[c] = axpy4(pv, dos[i][c * G::TPR + part], dva[c]);
          dka[c] = axpy4(ds, qs[i][c * G::TPR + part], dka[c]);
        }
      }
    }
  }

  if (col_ok) {
#pragma unroll
    for (int c = 0; c < G::C4; ++c) {
      store4(dk, kvoff + c * G::TPR + part, dka[c]);
      store4(dv, kvoff + c * G::TPR + part, dva[c]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *di;
  const int *q_ids, *kv_ids;
  int B, H, HK, Sq, Sk, causal;
  float scale;
  dropout::Params drop;
  cudaStream_t st;
};

// B*H (B*HK) on x (2^31 - 1), the row blocks on y
template <typename T, int D, bool DROP>
void launch_dq(const Args& a, void* dq) {
  using G = GeoQ<D>;
  constexpr int dyn = G::DYN ? G::SMEM : 0;
  static const bool sized = hopper::allow_smem(flash_dq_kernel<T, D, DROP>, dyn);
  (void)sized;
  const dim3 grid(a.B * a.H, (a.Sq + G::BQ - 1) / G::BQ);
  flash_dq_kernel<T, D, DROP><<<grid, G::THREADS, dyn, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.di,
      static_cast<T*>(dq), a.q_ids, a.kv_ids, a.H, a.HK, a.Sq, a.Sk,
      a.causal, a.scale, a.drop);
}

template <typename T, int D, bool DROP>
void launch_dkv(const Args& a, void* dk, void* dv) {
  using G = GeoKV<D>;
  constexpr int dyn = G::DYN ? G::SMEM : 0;
  static const bool sized = hopper::allow_smem(flash_dkv_kernel<T, D, DROP>, dyn);
  (void)sized;
  const dim3 grid(a.B * a.HK, (a.Sk + G::BKV - 1) / G::BKV);
  flash_dkv_kernel<T, D, DROP><<<grid, G::THREADS, dyn, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.di,
      static_cast<T*>(dk), static_cast<T*>(dv), a.q_ids, a.kv_ids, a.H,
      a.HK, a.Sq, a.Sk, a.causal, a.scale, a.drop);
}

// ---------------------------------------------------------------------------
// dk/dv on the tensor cores: bf16, D 64, 128 and 256 (wgmma + TMA;
// hopper_mma.cuh).  Key rows are wgmma's M: S^T = K.Q^T, P^T, dV +=
// P^T.dO, dP^T = V.dO^T, dS^T, dK += dS^T.Q.
// ---------------------------------------------------------------------------

constexpr int TC_BKV = 64;                      // key rows a CTA
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct DkvTc {
  static constexpr int NP = D / 64;             // 64-column panels
  static constexpr int BQT = 64;                // query rows a ring stage
  // warpgroups a CTA, each owning NPW panels of dK and dV (two at D 256,
  // where one warpgroup could not hold both accumulators)
  static constexpr int WGS = D > 128 ? 2 : 1;
  static constexpr int NPW = NP / WGS;
  static constexpr int THREADS = 128 * WGS;
  static constexpr int KV_BYTES = TC_BKV * D * 2;   // K or V, resident
  static constexpr int QT_BYTES = BQT * D * 2;      // one q or dO tile
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;        // two stages each
  static constexpr int DO_OFF = Q_OFF + 2 * QT_BYTES;
  static constexpr int ROW_OFF = DO_OFF + 2 * QT_BYTES;   // lse2, di, q ids
  static constexpr int BAR_OFF = ROW_OFF + 3 * 2 * BQT * 4;
  static constexpr int SMEM = BAR_OFF + 3 * 8 + 1024;     // + alignment slack
};

// P^T and dS^T of one tile from S^T (in sT) and dP^T (in dpT), in place.
// Under DROP (every tile) the pair of q row r0 + c and key key_lo + 8h is
// hashed from that key's part ckey[h]: sT takes keep * p / (1 - rate)
// for dV, and dS^T the dropped dP^T with the undropped p.
template <bool MASK, bool DROP>
__device__ __forceinline__ void dkv_probs(
    float (&sT)[32], float (&dpT)[32], const float* lse2, const float* dis,
    const int* qid, int r0, int key_lo, int lane, int Sq, int causal,
    bool seg, int kid_lo, int kid_hi, float scale2, float scale,
    const uint32_t (&ckey)[2], const dropout::Params& drop) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);   // q row in tile
    const int h = (i >> 1) & 1;
    bool ok = true;
    if (MASK) {
      const int row = r0 + c;
      ok = row < Sq && (!causal || key_lo + 8 * h <= row) &&
           (!seg || qid[c] == (h ? kid_hi : kid_lo));
    }
    const float p =
        ok ? exp2f(__fsub_rn(__fmul_rn(sT[i], scale2), lse2[c])) : 0.f;
    float dp = dpT[i];
    if (DROP) {
      const bool keep = dropout::kept(drop, dropout::row_key(ckey[h], r0 + c));
      sT[i] = dropout::scaled(drop, keep, p);
      dp = dropout::scaled(drop, keep, dp);
    } else {
      sT[i] = p;
    }
    dpT[i] = dscore(p, dp, dis[c], scale);
  }
}

template <int D, bool DROP>
__global__ void __launch_bounds__(DkvTc<D>::THREADS)
flash_dkv_kernel_tc(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ di,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv,
                    const int* __restrict__ q_ids,
                    const int* __restrict__ kv_ids, int H, int HK, int Sq,
                    int Sk, int causal, float scale2, float scale,
                    dropout::Params drop) {
  using G = DkvTc<D>;
  constexpr int BQT = G::BQT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw +
                ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = sm;
  uint8_t* vs = sm + G::V_OFF;
  uint8_t* qs = sm + G::Q_OFF;
  uint8_t* dos = sm + G::DO_OFF;
  float* lse2s = reinterpret_cast<float*>(sm + G::ROW_OFF);   // [2][BQT]
  float* dis = lse2s + 2 * BQT;                                // [2][BQT]
  int* qids = reinterpret_cast<int*>(dis + 2 * BQT);           // [2][BQT]
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + G::BAR_OFF);

  const int bhk = blockIdx.x;
  const int b = bhk / HK;
  const int hk = bhk % HK;
  const int group = H / HK;
  // blockIdx.y counts key blocks from the first: under the causal mask the
  // first sees most query rows, so the heaviest CTAs start first
  const int c0 = blockIdx.y * TC_BKV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int p0 = (tid >> 7) * G::NPW;   // this warpgroup's first dK/dV panel
  // (every warpgroup's fragment covers the CTA's 64 key rows)
  const int key_lo = c0 + 16 * ((tid >> 5) & 3) + (lane >> 2);   // and +8
  const bool seg = q_ids != nullptr;
  const int kid_lo = (seg && key_lo < Sk) ? kv_ids[(size_t)b * Sk + key_lo] : 0;
  const int kid_hi =
      (seg && key_lo + 8 < Sk) ? kv_ids[(size_t)b * Sk + key_lo + 8] : 0;

  // causal: rows before c0 see none of this block's keys
  const int rstart = causal ? (min(c0, Sq) / BQT) * BQT : 0;
  const int nqt = (Sq - rstart + BQT - 1) / BQT;
  const int ntile = group * nqt;   // tile t: head t / nqt, q tile t % nqt

  if (tid == 0) {
    hopper::mbar_init(&bar[0], 1);
    hopper::mbar_init(&bar[1], 1);
    hopper::mbar_init(&bar[2], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(&bar[2], 2 * G::KV_BYTES);
#pragma unroll
    for (int p = 0; p < G::NP; ++p) {
      hopper::tma_load_3d(ks + p * TC_BKV * 128, &map_k, &bar[2], 64 * p, c0,
                          bhk);
      hopper::tma_load_3d(vs + p * TC_BKV * 128, &map_v, &bar[2], 64 * p, c0,
                          bhk);
    }
  }
  // the q-side tiles of tile t into stage stg: q and dO by TMA, the rows'
  // lse (times log2 e), di and segment ids by the CTA's threads
  auto load_tile = [&](int t, int stg) {
    const int bh = b * H + hk * group + t / nqt;
    const int r0 = rstart + (t % nqt) * BQT;
    if (tid == 0) {
      hopper::mbar_expect_tx(&bar[stg], 2 * G::QT_BYTES);
#pragma unroll
      for (int p = 0; p < G::NP; ++p) {
        hopper::tma_load_3d(qs + stg * G::QT_BYTES + p * BQT * 128, &map_q,
                            &bar[stg], 64 * p, r0, bh);
        hopper::tma_load_3d(dos + stg * G::QT_BYTES + p * BQT * 128,
                            &map_do, &bar[stg], 64 * p, r0, bh);
      }
    }
    for (int j = tid; j < BQT; j += G::THREADS) {
      const int r = r0 + j;
      const bool in = r < Sq;
      lse2s[stg * BQT + j] = in ? lse[(size_t)bh * Sq + r] * LOG2E : 0.f;
      dis[stg * BQT + j] = in ? di[(size_t)bh * Sq + r] : 0.f;
      qids[stg * BQT + j] = (seg && in) ? q_ids[(size_t)b * Sq + r] : 0;
    }
  };
  if (ntile > 0) load_tile(0, 0);

  float dka[G::NPW][32], dva[G::NPW][32];   // panels p0 .. p0 + NPW - 1
  float sT[32], dpT[32];                   // m64n64: BQT = 64 columns
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sT[i] = dpT[i] = 0.f;
#pragma unroll
    for (int p = 0; p < G::NPW; ++p) dka[p][i] = dva[p][i] = 0.f;
  }
  hopper::mbar_wait(&bar[2], 0);
  const uint32_t seed = DROP ? static_cast<uint32_t>(*drop.seed) : 0u;

  for (int t = 0; t < ntile; ++t) {
    const int st = t & 1;
    // every thread is done with tile t-1: its stage takes tile t+1
    __syncthreads();
    if (t + 1 < ntile) load_tile(t + 1, st ^ 1);
    hopper::mbar_wait(&bar[st], (t >> 1) & 1);
    const int r0 = rstart + (t % nqt) * BQT;
    // the dropout hash's part of this thread's two keys at the tile's
    // query head (the flat q row b*H + hk*group + head)
    uint32_t ckey[2] = {0u, 0u};
    if (DROP) {
      const uint32_t head =
          dropout::head_key(seed, b * H + hk * group + t / nqt);
      ckey[0] = dropout::col_key(head, key_lo);
      ckey[1] = dropout::col_key(head, key_lo + 8);
    }
    const uint8_t* qt = qs + st * G::QT_BYTES;
    const uint8_t* dot = dos + st * G::QT_BYTES;

    // S^T = K . Q^T and dP^T = V . dO^T (A = K / V, B = Q / dO, K-major)
    hopper::fence_acc(sT);
    hopper::fence_acc(dpT);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk / 4, off = (kk % 4) * 32;
      hopper::wgmma_ss_n64<0>(
          sT, hopper::desc_sw128(ks + p * TC_BKV * 128 + off, 16, 1024),
          hopper::desc_sw128(qt + p * BQT * 128 + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk / 4, off = (kk % 4) * 32;
      hopper::wgmma_ss_n64<0>(
          dpT, hopper::desc_sw128(vs + p * TC_BKV * 128 + off, 16, 1024),
          hopper::desc_sw128(dot + p * BQT * 128 + off, 16, 1024), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_acc(sT);
    hopper::fence_acc(dpT);

    const bool need = seg || r0 + BQT > Sq ||
                      (causal && r0 < c0 + TC_BKV - 1);
    const float* l2 = lse2s + st * BQT;
    const float* dd = dis + st * BQT;
    const int* qd = qids + st * BQT;
    if (need)
      dkv_probs<true, DROP>(sT, dpT, l2, dd, qd, r0, key_lo, lane, Sq, causal,
                            seg, kid_lo, kid_hi, scale2, scale, ckey, drop);
    else
      dkv_probs<false, DROP>(sT, dpT, l2, dd, qd, r0, key_lo, lane, Sq,
                             causal, seg, kid_lo, kid_hi, scale2, scale, ckey,
                             drop);

    // P^T and dS^T rounded to bf16 in registers: the A operands of
    // dV += P^T . dO and dK += dS^T . Q (B = dO / Q, MN-major; this
    // warpgroup's panels of them)
    uint32_t pa[BQT / 16][4], da[BQT / 16][4];
#pragma unroll
    for (int c = 0; c < BQT / 16; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[c][r] = hopper::pack_bf16(sT[8 * c + 2 * r], sT[8 * c + 2 * r + 1]);
        da[c][r] =
            hopper::pack_bf16(dpT[8 * c + 2 * r], dpT[8 * c + 2 * r + 1]);
      }
#pragma unroll
    for (int p = 0; p < G::NPW; ++p) {
      hopper::fence_acc(dva[p]);
      hopper::fence_acc(dka[p]);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < BQT / 16; ++c)
#pragma unroll
      for (int p = 0; p < G::NPW; ++p)
        hopper::wgmma_rs_n64<1>(
            dva[p], pa[c],
            hopper::desc_sw128(dot + (p0 + p) * BQT * 128 + c * 2048,
                               BQT * 128, 1024));
#pragma unroll
    for (int c = 0; c < BQT / 16; ++c)
#pragma unroll
      for (int p = 0; p < G::NPW; ++p)
        hopper::wgmma_rs_n64<1>(
            dka[p], da[c],
            hopper::desc_sw128(qt + (p0 + p) * BQT * 128 + c * 2048,
                               BQT * 128, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < G::NPW; ++p) {
      hopper::fence_acc(dva[p]);
      hopper::fence_acc(dka[p]);
    }
  }

  // epilogue: each key row's dk and dv, rounded to bf16 once
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key_lo + 8 * h;
    if (key >= Sk) continue;
    const size_t off = ((size_t)bhk * Sk + key) * D;
    uint32_t* krow = reinterpret_cast<uint32_t*>(dk + off);
    uint32_t* vrow = reinterpret_cast<uint32_t*>(dv + off);
#pragma unroll
    for (int p = 0; p < G::NPW; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int w = 32 * (p0 + p) + 4 * j + (lane & 3);
        krow[w] = hopper::pack_bf16(dka[p][4 * j + 2 * h],
                                    dka[p][4 * j + 2 * h + 1]);
        vrow[w] = hopper::pack_bf16(dva[p][4 * j + 2 * h],
                                    dva[p][4 * j + 2 * h + 1]);
      }
  }
}

template <int D, bool DROP>
int launch_dkv_tc(const Args& a, void* dk, void* dv) {
  using G = DkvTc<D>;
  CUtensorMap mq, mk, mv, mdo;
  int rc = hopper::make_map_bf16(&mq, a.q, D, a.Sq, a.B * a.H, G::BQT);
  if (rc == 0) rc = hopper::make_map_bf16(&mdo, a.dout, D, a.Sq, a.B * a.H, G::BQT);
  if (rc == 0) rc = hopper::make_map_bf16(&mk, a.k, D, a.Sk, a.B * a.HK, TC_BKV);
  if (rc == 0) rc = hopper::make_map_bf16(&mv, a.v, D, a.Sk, a.B * a.HK, TC_BKV);
  if (rc != 0) return rc;
  rc = static_cast<int>(cudaFuncSetAttribute(
      flash_dkv_kernel_tc<D, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM));
  if (rc != 0) return rc;
  const dim3 grid(a.B * a.HK, (a.Sk + TC_BKV - 1) / TC_BKV);
  flash_dkv_kernel_tc<D, DROP><<<grid, G::THREADS, G::SMEM, a.st>>>(
      mq, mk, mv, mdo, a.lse, a.di, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), a.q_ids, a.kv_ids, a.H, a.HK, a.Sq,
      a.Sk, a.causal, a.scale * LOG2E, a.scale, a.drop);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// dq on the tensor cores: bf16, D 64, 128 and 256 (wgmma + TMA;
// hopper_mma.cuh).  Query rows are wgmma's M: S = Q.K^T, dP = dO.V^T,
// dS, dQ += dS.K (the forward's geometry, K in V's place).  At D 256
// dQ's 64 x 256 f32 is the D-256 forward's O accumulator: 128 registers
// a thread beside S and dP (32 each), in one warpgroup.
// ---------------------------------------------------------------------------

template <int D>
struct DqTc {
  static constexpr int NP = D / 64;             // 64-column panels
  static constexpr int BQ = 64;                 // query rows a CTA
  static constexpr int BK = 64;                 // keys a ring stage
  static constexpr int THREADS = 128;           // one warpgroup
  static constexpr int Q_BYTES = BQ * D * 2;    // q or dO, resident
  static constexpr int KV_BYTES = BK * D * 2;   // one K or V tile
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;        // two stages each
  static constexpr int V_OFF = K_OFF + 2 * KV_BYTES;
  static constexpr int KID_OFF = V_OFF + 2 * KV_BYTES;
  static constexpr int BAR_OFF = KID_OFF + 2 * BK * 4;
  static constexpr int SMEM = BAR_OFF + 2 * 8 + 1024;   // + alignment slack
};

// dS of one tile from S (in s) and dP (in dp), into dp: p = exp2(s *
// scale2 - lse2) selected to 0 where MASK finds the pair hidden; under
// DROP (every tile) dp is first keep * dp / (1 - rate), each pair hashed
// from its row's key rkey.
template <bool MASK, bool DROP>
__device__ __forceinline__ void dq_scores(
    const float (&s)[32], float (&dp)[32], const float (&lse2)[2],
    const float (&dir)[2], int k0, int r_lo, int lane, int Sk, int causal,
    const int* kid, int qid_lo, int qid_hi, float scale2, float scale,
    const uint32_t (&rkey)[2], const dropout::Params& drop) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);   // key in tile
    const int h = (i >> 1) & 1;
    bool ok = true;
    if (MASK) {
      const int col = k0 + c;
      ok = col < Sk && (!causal || col <= r_lo + 8 * h) &&
           (kid == nullptr || kid[c] == (h ? qid_hi : qid_lo));
    }
    const float p =
        ok ? exp2f(__fsub_rn(__fmul_rn(s[i], scale2), lse2[h])) : 0.f;
    const float dpd =
        DROP ? dropout::apply(drop, dropout::col_key(rkey[h], k0 + c), dp[i])
             : dp[i];
    dp[i] = dscore(p, dpd, dir[h], scale);
  }
}

template <int D, bool DROP>
__global__ void __launch_bounds__(DqTc<D>::THREADS)
flash_dq_kernel_tc(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_do,
                   const float* __restrict__ lse,
                   const float* __restrict__ di,
                   __nv_bfloat16* __restrict__ dq,
                   const int* __restrict__ q_ids,
                   const int* __restrict__ kv_ids, int H, int HK, int Sq,
                   int Sk, int causal, float scale2, float scale,
                   dropout::Params drop) {
  using G = DqTc<D>;
  constexpr int BK = G::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw +
                ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = sm;
  uint8_t* dos = sm + G::DO_OFF;
  uint8_t* ks = sm + G::K_OFF;
  uint8_t* vs = sm + G::V_OFF;
  int* kid = reinterpret_cast<int*>(sm + G::KID_OFF);          // [2][BK]
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + G::BAR_OFF);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int bhk = b * HK + (bh % H) / (H / HK);
  // heaviest first: under the causal mask the last q block sees most keys
  const int q0 = (gridDim.y - 1 - blockIdx.y) * G::BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r_lo = q0 + 16 * (tid >> 5) + (lane >> 2);   // and r_lo + 8
  const bool seg = q_ids != nullptr;
  const int kend = causal ? min(Sk, q0 + G::BQ) : Sk;
  const int ntile = (kend + BK - 1) / BK;

  if (tid == 0) {
    hopper::mbar_init(&bar[0], 1);
    hopper::mbar_init(&bar[1], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(&bar[0], 2 * G::Q_BYTES + 2 * G::KV_BYTES);
#pragma unroll
    for (int p = 0; p < G::NP; ++p) {
      hopper::tma_load_3d(qs + p * G::BQ * 128, &map_q, &bar[0], 64 * p, q0,
                          bh);
      hopper::tma_load_3d(dos + p * G::BQ * 128, &map_do, &bar[0], 64 * p,
                          q0, bh);
      hopper::tma_load_3d(ks + p * BK * 128, &map_k, &bar[0], 64 * p, 0, bhk);
      hopper::tma_load_3d(vs + p * BK * 128, &map_v, &bar[0], 64 * p, 0, bhk);
    }
  }
  if (seg) {
    for (int j = tid; j < BK; j += G::THREADS)
      kid[j] = j < Sk ? kv_ids[(size_t)b * Sk + j] : 0;
  }
  // this thread's two rows never change: lse (times log2 e), di and the
  // query segment ids stay in registers (rows past Sq: zeros, never
  // stored)
  float lse2[2], dir[2];
  int qid[2];
  uint32_t rkey[2] = {0u, 0u};
  const uint32_t head = DROP ? dropout::head_key(*drop.seed, bh) : 0u;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r_lo + 8 * h;
    const bool in = row < Sq;
    lse2[h] = in ? lse[(size_t)bh * Sq + row] * LOG2E : 0.f;
    dir[h] = in ? di[(size_t)bh * Sq + row] : 0.f;
    qid[h] = (seg && in) ? q_ids[(size_t)b * Sq + row] : 0;
    if (DROP) rkey[h] = dropout::row_key(head, row);
  }

  float acc[G::NP][32];
  float s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = dp[i] = 0.f;
#pragma unroll
    for (int p = 0; p < G::NP; ++p) acc[p][i] = 0.f;
  }

  for (int t = 0; t < ntile; ++t) {
    const int k0 = t * BK;
    const int st = t & 1;
    // every thread is done with tile t-1: its stage takes tile t+1
    __syncthreads();
    if (t + 1 < ntile) {
      const int nst = st ^ 1;
      if (tid == 0) {
        hopper::mbar_expect_tx(&bar[nst], 2 * G::KV_BYTES);
#pragma unroll
        for (int p = 0; p < G::NP; ++p) {
          hopper::tma_load_3d(ks + nst * G::KV_BYTES + p * BK * 128, &map_k,
                              &bar[nst], 64 * p, k0 + BK, bhk);
          hopper::tma_load_3d(vs + nst * G::KV_BYTES + p * BK * 128, &map_v,
                              &bar[nst], 64 * p, k0 + BK, bhk);
        }
      }
      if (seg) {
        for (int j = tid; j < BK; j += G::THREADS) {
          const int col = k0 + BK + j;
          kid[nst * BK + j] = col < Sk ? kv_ids[(size_t)b * Sk + col] : 0;
        }
      }
    }
    hopper::mbar_wait(&bar[st], (t >> 1) & 1);
    const uint8_t* kt = ks + st * G::KV_BYTES;
    const uint8_t* vt = vs + st * G::KV_BYTES;

    // S = Q . K^T and dP = dO . V^T (A = Q / dO, B = K / V, K-major)
    hopper::fence_acc(s);
    hopper::fence_acc(dp);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk / 4, off = (kk % 4) * 32;
      hopper::wgmma_ss_n64<0>(
          s, hopper::desc_sw128(qs + p * G::BQ * 128 + off, 16, 1024),
          hopper::desc_sw128(kt + p * BK * 128 + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk / 4, off = (kk % 4) * 32;
      hopper::wgmma_ss_n64<0>(
          dp, hopper::desc_sw128(dos + p * G::BQ * 128 + off, 16, 1024),
          hopper::desc_sw128(vt + p * BK * 128 + off, 16, 1024), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_acc(s);
    hopper::fence_acc(dp);

    const bool need = seg || k0 + BK > Sk || (causal && k0 + BK - 1 > q0);
    if (need)
      dq_scores<true, DROP>(s, dp, lse2, dir, k0, r_lo, lane, Sk, causal,
                            seg ? kid + st * BK : nullptr, qid[0], qid[1],
                            scale2, scale, rkey, drop);
    else
      dq_scores<false, DROP>(s, dp, lse2, dir, k0, r_lo, lane, Sk, causal,
                             nullptr, 0, 0, scale2, scale, rkey, drop);

    // dS rounded to bf16 in registers: the A operand of dQ += dS . K
    // (B = the K tile, MN-major through the transpose bit)
    uint32_t a[BK / 16][4];
#pragma unroll
    for (int c = 0; c < BK / 16; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[c][r] = hopper::pack_bf16(dp[8 * c + 2 * r], dp[8 * c + 2 * r + 1]);
#pragma unroll
    for (int p = 0; p < G::NP; ++p) hopper::fence_acc(acc[p]);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < BK / 16; ++c)
#pragma unroll
      for (int p = 0; p < G::NP; ++p)
        hopper::wgmma_rs_n64<1>(
            acc[p], a[c],
            hopper::desc_sw128(kt + p * BK * 128 + c * 2048, BK * 128, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < G::NP; ++p) hopper::fence_acc(acc[p]);
  }

  // epilogue: each query row's dq, rounded to bf16 once
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r_lo + 8 * h;
    if (row >= Sq) continue;
    uint32_t* qrow =
        reinterpret_cast<uint32_t*>(dq + ((size_t)bh * Sq + row) * D);
#pragma unroll
    for (int p = 0; p < G::NP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        qrow[32 * p + 4 * j + (lane & 3)] =
            hopper::pack_bf16(acc[p][4 * j + 2 * h], acc[p][4 * j + 2 * h + 1]);
  }
}

template <int D, bool DROP>
int launch_dq_tc(const Args& a, void* dq) {
  using G = DqTc<D>;
  CUtensorMap mq, mk, mv, mdo;
  int rc = hopper::make_map_bf16(&mq, a.q, D, a.Sq, a.B * a.H, G::BQ);
  if (rc == 0) rc = hopper::make_map_bf16(&mdo, a.dout, D, a.Sq, a.B * a.H, G::BQ);
  if (rc == 0) rc = hopper::make_map_bf16(&mk, a.k, D, a.Sk, a.B * a.HK, G::BK);
  if (rc == 0) rc = hopper::make_map_bf16(&mv, a.v, D, a.Sk, a.B * a.HK, G::BK);
  if (rc != 0) return rc;
  rc = static_cast<int>(cudaFuncSetAttribute(
      flash_dq_kernel_tc<D, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM));
  if (rc != 0) return rc;
  const dim3 grid(a.B * a.H, (a.Sq + G::BQ - 1) / G::BQ);
  flash_dq_kernel_tc<D, DROP><<<grid, G::THREADS, G::SMEM, a.st>>>(
      mq, mk, mv, mdo, a.lse, a.di, static_cast<__nv_bfloat16*>(dq), a.q_ids,
      a.kv_ids, a.H, a.HK, a.Sq, a.Sk, a.causal, a.scale * LOG2E, a.scale,
      a.drop);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// wide tensor-core dq and dk/dv: bf16 at D 512 and D >= 1024
// (wide::tc_takes; wgmma + TMA; hopper_mma.cuh)
// ---------------------------------------------------------------------------
//
// Past D 256 neither output fits a CTA: a 64-row dQ at D 1024 is 64 x
// 1024 f32, 256 KB.  So a CTA of two warpgroups owns 64 rows (query rows
// in dq, key rows in dk/dv) and a slice of the output's columns on the
// grid's z, as the wide forward does, and recomputes the scores it needs
// over the whole D.  The two warpgroups split the two products a tile
// needs: warpgroup 0 takes X0 = A0.B0^T (S in dq, S^T in dk/dv),
// warpgroup 1 X1 = A1.B1^T (dP, dP^T), each over the whole D through one
// ring of STAGES stages of four 64-column panels (A0, B0, A1, B1) by TMA,
// one counter over every (tile, panel) load, so stage g % STAGES waits on
// the phase (g / STAGES) & 1, and a stage is loaded again once every
// thread has waited for the products that read it (wgmma_wait<1>, one
// barrier): the forward's ring.  The scores meet through shared memory
// (one fragment of 64 x 64 f32 a warpgroup, one barrier), and each
// warpgroup then owns 256 columns of one output, the D-256 bodies' 128
// accumulator registers a thread:
//
// - dq: warpgroup 0 turns S into p (the mask, the lse), warpgroup 1
//   drops dP (keep * dP / (1 - rate)); each reads the other's and both
//   compute the same dS, and warpgroup w owns dQ's columns [512z + 256w,
//   +256): dQ += dS.K over a 64 x 512 slice of the key tile.
// - dk/dv: warpgroup 0 turns S^T into P^T and owns dV's 256 columns (dV
//   += keep * P^T / (1 - rate) . dO over the q tile's dO slice);
//   warpgroup 1 reads the undropped p and owns dK's (dK += dS^T . Q over
//   its Q slice, dS^T from the dropped dP^T).
//
// Every slice CTA computes S and dP from the same products in the same
// order, so p, dS and the keep mask agree bit for bit across slices, and
// the arithmetic is the D-256 bodies' (DqTc, DkvTc): exp2 with log2(e)
// folded into the scale and lse, p and dS rounded to bf16 in registers as
// the A operands of the slice products (B MN-major through the transpose
// bit), a tile wholly visible skipping the per-element mask, a key
// block's (a q block's) heaviest-first order.  Shared memory: a 96 KB
// ring, the 64 KB slice tiles, 32 KB of score fragments: one CTA an SM.
//
// What it costs: the slices repeat S and dP.  A visible pair takes (D /
// 512)·4D + 2D tensor-core FLOP in dq where the function needs 6D (1.7x
// at D 1024, 11x at D 8192), and (D/256)·4D + 4D in dk/dv where it needs
// 8D (2.5x at D 1024, 16.5x at D 8192).  At (8, 2, 512, 1024) bf16 causal
// on an H100 at 700 W dq takes 0.1561 ms and dk/dv 0.3131 (138 and 137
// TFLOP/s executed, 83 and 55 useful), where the wide CUDA-core bodies
// took 2.1038 and 2.4785 in turns: 0.21x SDPA's backward for the pair.
// At D 8192's (1, 2, 512, 8192), the same bytes, 0.8959 and 1.5735 ms
// against 2.9115 and 3.0520.

struct BwdTcWide {
  static constexpr int ROWS = 64;               // a CTA's output rows
  static constexpr int TILE = 64;               // the other side's rows a step
  static constexpr int THREADS = 256;           // two warpgroups
  static constexpr int WG_COLS = 256;           // output columns a warpgroup
  static constexpr int WG_PANELS = WG_COLS / 64;
  static constexpr int STAGES = 3;              // the A0/B0/A1/B1 panel ring
  static constexpr int PANEL = 64 * 128;        // 64 rows of 64 bf16: 8 KB
  static constexpr int STAGE_BYTES = 4 * PANEL;
  static constexpr int SL_OFF = STAGES * STAGE_BYTES;
  static constexpr int SL_BYTES = 2 * WG_PANELS * PANEL;   // slice tiles
  static constexpr int X_OFF = SL_OFF + SL_BYTES;          // score fragments
  static constexpr int X_BYTES = 2 * 32 * 128 * 4;
  static constexpr int ROW_OFF = X_OFF + X_BYTES;          // a tile's rows
  static constexpr int BAR_OFF = ROW_OFF + 3 * TILE * 4;
  static constexpr int SMEM = BAR_OFF + (STAGES + 1) * 8 + 1024;   // + slack
};

// X_w = A_w . B_w^T over the whole D for one tile (warpgroup w = wg): the
// ring's next npan loads from counter g, a 64-column panel a stage; each
// stage, once every thread has waited for the products that read it,
// takes the ring's load g - 1 + STAGES (`load`, by thread 0).
template <typename Load>
__device__ __forceinline__ void wide_scores(float (&x)[32], const uint8_t* ring,
                                            uint64_t* full, int& g, int npan,
                                            int nload, int wg, Load& load) {
  using G = BwdTcWide;
  hopper::fence_acc(x);
  for (int p = 0; p < npan; ++p, ++g) {
    const int st = g % G::STAGES;
    hopper::mbar_wait(&full[st], (g / G::STAGES) & 1);
    const uint8_t* a = ring + st * G::STAGE_BYTES + 2 * wg * G::PANEL;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_ss_n64<0>(
          x, hopper::desc_sw128(a + kk * 32, 16, 1024),
          hopper::desc_sw128(a + G::PANEL + kk * 32, 16, 1024),
          p > 0 || kk > 0);
    hopper::wgmma_commit();
    if (p > 0) {
      // the previous panel's products are done in every warp: its stage
      // takes the ring's load g - 1 + STAGES
      hopper::wgmma_wait<1>();
      __syncthreads();
      if (threadIdx.x == 0 && g - 1 + G::STAGES < nload) load(g - 1 + G::STAGES);
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_acc(x);
  __syncthreads();
  if (threadIdx.x == 0 && g - 1 + G::STAGES < nload) load(g - 1 + G::STAGES);
}

// acc += Y . C: Y (x rounded to bf16 in registers) the A operand, C this
// warpgroup's WG_PANELS slice panels at `sl` (MN-major: the reduction
// runs down their TILE rows).
__device__ __forceinline__ void wide_slice_products(
    float (&acc)[BwdTcWide::WG_PANELS][32], const float (&x)[32],
    const uint8_t* sl) {
  using G = BwdTcWide;
  uint32_t a[G::TILE / 16][4];
#pragma unroll
  for (int c = 0; c < G::TILE / 16; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[c][r] = hopper::pack_bf16(x[8 * c + 2 * r], x[8 * c + 2 * r + 1]);
#pragma unroll
  for (int p = 0; p < G::WG_PANELS; ++p) hopper::fence_acc(acc[p]);
  hopper::wgmma_fence();
#pragma unroll
  for (int c = 0; c < G::TILE / 16; ++c)
#pragma unroll
    for (int p = 0; p < G::WG_PANELS; ++p)
      hopper::wgmma_rs_n64<1>(
          acc[p], a[c],
          hopper::desc_sw128(sl + p * G::PANEL + c * 2048, G::PANEL, 1024));
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int p = 0; p < G::WG_PANELS; ++p) hopper::fence_acc(acc[p]);
}

// One row of 256 output columns from the accumulator fragment: the
// fragment's row half h, rounded to bf16.
__device__ __forceinline__ void wide_store_row(
    __nv_bfloat16* out, const float (&acc)[BwdTcWide::WG_PANELS][32], int h,
    int lane) {
  uint32_t* row = reinterpret_cast<uint32_t*>(out);
#pragma unroll
  for (int p = 0; p < BwdTcWide::WG_PANELS; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      row[32 * p + 4 * j + (lane & 3)] =
          hopper::pack_bf16(acc[p][4 * j + 2 * h], acc[p][4 * j + 2 * h + 1]);
}

// dq's p of one tile from S, in place (key c of the tile, the thread's
// row r_lo + 8h): exp2(s * scale2 - lse2) where visible, else 0.
template <bool MASK>
__device__ __forceinline__ void dq_probs(float (&s)[32], const float (&lse2)[2],
                                         int k0, int r_lo, int lane, int Sk,
                                         int causal, const int* kid,
                                         const int (&qid)[2], float scale2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    const int h = (i >> 1) & 1;
    bool ok = true;
    if (MASK) {
      const int col = k0 + c;
      ok = col < Sk && (!causal || col <= r_lo + 8 * h) &&
           (kid == nullptr || kid[c] == qid[h]);
    }
    s[i] = ok ? exp2f(__fsub_rn(__fmul_rn(s[i], scale2), lse2[h])) : 0.f;
  }
}

template <bool DROP>
__global__ void __launch_bounds__(BwdTcWide::THREADS, 1)
flash_dq_kernel_tc_wide(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const float* __restrict__ lse,
                        const float* __restrict__ di,
                        __nv_bfloat16* __restrict__ dq,
                        const int* __restrict__ q_ids,
                        const int* __restrict__ kv_ids, int H, int HK, int Sq,
                        int Sk, int D, int causal, float scale2, float scale,
                        dropout::Params drop) {
  using G = BwdTcWide;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw +
                ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sl = sm + G::SL_OFF;
  float* xs = reinterpret_cast<float*>(sm + G::X_OFF);   // [2][32][128]
  int* kid = reinterpret_cast<int*>(sm + G::ROW_OFF);    // [TILE]
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + G::BAR_OFF);  // ring
  uint64_t* sbar = full + G::STAGES;                     // slice tiles

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int bhk = b * HK + (bh % H) / (H / HK);
  // heaviest first: under the causal mask the last q block sees most keys
  const int q0 = (gridDim.y - 1 - blockIdx.y) * G::ROWS;
  const int c0 = blockIdx.z * 2 * G::WG_COLS;   // this CTA's columns of dQ
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int t = tid & 127;
  const int lane = tid & 31;
  const int r_lo = q0 + 16 * (t >> 5) + (lane >> 2);     // and r_lo + 8
  const bool seg = q_ids != nullptr;
  const int kend = causal ? min(Sk, q0 + G::ROWS) : Sk;
  const int ntile = (kend + G::TILE - 1) / G::TILE;
  const int npan = D / 64;               // a tile's panels of each operand
  const int nload = ntile * npan;        // the ring's loads

  // this thread's two rows: lse (times log2 e), di, the query segment ids
  // and the dropout hash's row part (rows past Sq: zeros, never stored)
  float lse2[2], dir[2];
  int qid[2];
  uint32_t rkey[2] = {0u, 0u};
  const uint32_t head = DROP ? dropout::head_key(*drop.seed, bh) : 0u;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r_lo + 8 * h;
    const bool in = row < Sq;
    lse2[h] = in ? lse[(size_t)bh * Sq + row] * LOG2E : 0.f;
    dir[h] = in ? di[(size_t)bh * Sq + row] : 0.f;
    qid[h] = (seg && in) ? q_ids[(size_t)b * Sq + row] : 0;
    if (DROP) rkey[h] = dropout::row_key(head, row);
  }

  if (tid == 0) {
    for (int i = 0; i <= G::STAGES; ++i) hopper::mbar_init(&full[i], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // the ring's load j: panel j % npan of Q, K, dO and V at key tile j / npan
  auto load = [&](int j) {
    const int st = j % G::STAGES, p = j % npan, k0 = (j / npan) * G::TILE;
    uint8_t* dst = sm + st * G::STAGE_BYTES;
    hopper::mbar_expect_tx(&full[st], G::STAGE_BYTES);
    hopper::tma_load_3d(dst, &map_q, &full[st], 64 * p, q0, bh);
    hopper::tma_load_3d(dst + G::PANEL, &map_k, &full[st], 64 * p, k0, bhk);
    hopper::tma_load_3d(dst + 2 * G::PANEL, &map_do, &full[st], 64 * p, q0,
                        bh);
    hopper::tma_load_3d(dst + 3 * G::PANEL, &map_v, &full[st], 64 * p, k0,
                        bhk);
  };
  if (tid == 0) {
    for (int j = 0; j < G::STAGES && j < nload; ++j) load(j);
  }

  float acc[G::WG_PANELS][32];
  float x[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    x[i] = 0.f;
#pragma unroll
    for (int p = 0; p < G::WG_PANELS; ++p) acc[p][i] = 0.f;
  }

  int g = 0;                             // the ring's next load to consume
  for (int kt = 0; kt < ntile; ++kt) {
    const int k0 = kt * G::TILE;
    // every thread is done with tile kt-1's slice, key ids and fragments
    __syncthreads();
    if (tid == 0) {
      hopper::mbar_expect_tx(sbar, G::SL_BYTES);
#pragma unroll
      for (int p = 0; p < 2 * G::WG_PANELS; ++p)
        hopper::tma_load_3d(sl + p * G::PANEL, &map_k, sbar, c0 + 64 * p, k0,
                            bhk);
    }
    if (seg) {
      for (int j = tid; j < G::TILE; j += G::THREADS)
        kid[j] = k0 + j < Sk ? kv_ids[(size_t)b * Sk + k0 + j] : 0;
    }

    // warpgroup 0: S = Q . K^T; warpgroup 1: dP = dO . V^T
    wide_scores(x, sm, full, g, npan, nload, wg, load);

    if (wg == 0) {
      const bool need = seg || k0 + G::TILE > Sk ||
                        (causal && k0 + G::TILE - 1 > q0);
      if (need)
        dq_probs<true>(x, lse2, k0, r_lo, lane, Sk, causal,
                       seg ? kid : nullptr, qid, scale2);
      else
        dq_probs<false>(x, lse2, k0, r_lo, lane, Sk, causal, nullptr, qid,
                        scale2);
    } else if (DROP) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        x[i] = dropout::apply(drop, dropout::col_key(rkey[(i >> 1) & 1], k0 + c),
                              x[i]);
      }
    }
    // p (warpgroup 0) and the dropped dP (warpgroup 1) meet: both compute
    // the same dS
    float* mine = xs + wg * 32 * 128;
    const float* other = xs + (wg ^ 1) * 32 * 128;
#pragma unroll
    for (int i = 0; i < 32; ++i) mine[i * 128 + t] = x[i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float o = other[i * 128 + t];
      x[i] = dscore(wg == 0 ? x[i] : o, wg == 0 ? o : x[i],
                    dir[(i >> 1) & 1], scale);
    }

    // dQ[:, c0 + 256 wg ..] += dS . K[k0.., c0 + 256 wg ..]
    hopper::mbar_wait(sbar, kt & 1);
    wide_slice_products(acc, x, sl + wg * G::WG_PANELS * G::PANEL);
  }

  // epilogue: each query row's slice of dq, rounded to bf16 once
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r_lo + 8 * h;
    if (row < Sq)
      wide_store_row(dq + ((size_t)bh * Sq + row) * D + c0 + wg * G::WG_COLS,
                     acc, h, lane);
  }
}

template <bool DROP>
__global__ void __launch_bounds__(BwdTcWide::THREADS, 1)
flash_dkv_kernel_tc_wide(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ di,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv,
                         const int* __restrict__ q_ids,
                         const int* __restrict__ kv_ids, int H, int HK,
                         int Sq, int Sk, int D, int causal, float scale2,
                         float scale, dropout::Params drop) {
  using G = BwdTcWide;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw +
                ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sl = sm + G::SL_OFF;
  float* xs = reinterpret_cast<float*>(sm + G::X_OFF);   // [32][128]: p
  float* lse2s = reinterpret_cast<float*>(sm + G::ROW_OFF);   // [TILE]
  float* dis = lse2s + G::TILE;                                // [TILE]
  int* qids = reinterpret_cast<int*>(dis + G::TILE);           // [TILE]
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + G::BAR_OFF);
  uint64_t* sbar = full + G::STAGES;

  const int bhk = blockIdx.x;
  const int b = bhk / HK;
  const int hk = bhk % HK;
  const int group = H / HK;
  // blockIdx.y counts key blocks from the first: under the causal mask the
  // first sees most query rows, so the heaviest CTAs start first
  const int c0 = blockIdx.y * G::ROWS;
  const int cs = blockIdx.z * G::WG_COLS;   // this CTA's columns of dK, dV
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int t = tid & 127;
  const int lane = tid & 31;
  const int key_lo = c0 + 16 * (t >> 5) + (lane >> 2);   // and key_lo + 8
  const bool seg = q_ids != nullptr;
  const int kid[2] = {(seg && key_lo < Sk) ? kv_ids[(size_t)b * Sk + key_lo] : 0,
                      (seg && key_lo + 8 < Sk)
                          ? kv_ids[(size_t)b * Sk + key_lo + 8] : 0};

  // causal: rows before c0 see none of this block's keys
  const int rstart = causal ? (min(c0, Sq) / G::TILE) * G::TILE : 0;
  const int nqt = (Sq - rstart + G::TILE - 1) / G::TILE;
  const int ntile = group * nqt;   // tile i: head i / nqt, q tile i % nqt
  const int npan = D / 64;
  const int nload = ntile * npan;

  if (tid == 0) {
    for (int i = 0; i <= G::STAGES; ++i) hopper::mbar_init(&full[i], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // the ring's load j: panel j % npan of K, Q, V and dO at tile j / npan
  auto load = [&](int j) {
    const int st = j % G::STAGES, p = j % npan, i = j / npan;
    const int bh = b * H + hk * group + i / nqt;
    const int r0 = rstart + (i % nqt) * G::TILE;
    uint8_t* dst = sm + st * G::STAGE_BYTES;
    hopper::mbar_expect_tx(&full[st], G::STAGE_BYTES);
    hopper::tma_load_3d(dst, &map_k, &full[st], 64 * p, c0, bhk);
    hopper::tma_load_3d(dst + G::PANEL, &map_q, &full[st], 64 * p, r0, bh);
    hopper::tma_load_3d(dst + 2 * G::PANEL, &map_v, &full[st], 64 * p, c0,
                        bhk);
    hopper::tma_load_3d(dst + 3 * G::PANEL, &map_do, &full[st], 64 * p, r0,
                        bh);
  };
  if (tid == 0) {
    for (int j = 0; j < G::STAGES && j < nload; ++j) load(j);
  }

  float acc[G::WG_PANELS][32];   // dV (warpgroup 0) or dK (warpgroup 1)
  float x[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    x[i] = 0.f;
#pragma unroll
    for (int p = 0; p < G::WG_PANELS; ++p) acc[p][i] = 0.f;
  }
  const uint32_t seed = DROP ? static_cast<uint32_t>(*drop.seed) : 0u;

  int g = 0;                             // the ring's next load to consume
  for (int it = 0; it < ntile; ++it) {
    const int bh = b * H + hk * group + it / nqt;   // the flat q row
    const int r0 = rstart + (it % nqt) * G::TILE;
    // every thread is done with tile it-1's slices, rows and fragments
    __syncthreads();
    if (tid == 0) {
      hopper::mbar_expect_tx(sbar, G::SL_BYTES);
#pragma unroll
      for (int p = 0; p < G::WG_PANELS; ++p) {
        hopper::tma_load_3d(sl + p * G::PANEL, &map_do, sbar, cs + 64 * p, r0,
                            bh);
        hopper::tma_load_3d(sl + (G::WG_PANELS + p) * G::PANEL, &map_q, sbar,
                            cs + 64 * p, r0, bh);
      }
    }
    for (int j = tid; j < G::TILE; j += G::THREADS) {
      const int r = r0 + j;
      const bool in = r < Sq;
      lse2s[j] = in ? lse[(size_t)bh * Sq + r] * LOG2E : 0.f;
      dis[j] = in ? di[(size_t)bh * Sq + r] : 0.f;
      qids[j] = (seg && in) ? q_ids[(size_t)b * Sq + r] : 0;
    }
    // the dropout hash's part of this thread's two keys at the tile's
    // query head
    uint32_t ckey[2] = {0u, 0u};
    if (DROP) {
      const uint32_t head = dropout::head_key(seed, bh);
      ckey[0] = dropout::col_key(head, key_lo);
      ckey[1] = dropout::col_key(head, key_lo + 8);
    }

    // warpgroup 0: S^T = K . Q^T; warpgroup 1: dP^T = V . dO^T
    wide_scores(x, sm, full, g, npan, nload, wg, load);

    if (wg == 0) {
      // P^T, the undropped p to warpgroup 1, keep * p / (1 - rate) for dV
      const bool need = seg || r0 + G::TILE > Sq ||
                        (causal && r0 < c0 + G::ROWS - 1);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);   // q row
        const int h = (i >> 1) & 1;
        const int row = r0 + c;
        const bool ok = !need || (row < Sq && (!causal || key_lo + 8 * h <= row) &&
                                  (!seg || qids[c] == kid[h]));
        const float p =
            ok ? exp2f(__fsub_rn(__fmul_rn(x[i], scale2), lse2s[c])) : 0.f;
        xs[i * 128 + t] = p;
        x[i] = DROP ? dropout::apply(drop, dropout::row_key(ckey[h], row), p)
                    : p;
      }
    }
    __syncthreads();
    if (wg == 1) {
      // dS^T = p * (keep * dP^T / (1 - rate) - di) * scale
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const float dp =
            DROP ? dropout::apply(drop,
                                  dropout::row_key(ckey[(i >> 1) & 1], r0 + c),
                                  x[i])
                 : x[i];
        x[i] = dscore(xs[i * 128 + t], dp, dis[c], scale);
      }
    }

    // dV += P^T . dO[r0.., cs..] (warpgroup 0), dK += dS^T . Q (1)
    hopper::mbar_wait(sbar, it & 1);
    wide_slice_products(acc, x, sl + wg * G::WG_PANELS * G::PANEL);
  }

  // epilogue: each key row's slice of dv (warpgroup 0) or dk (1), rounded
  // to bf16 once
  __nv_bfloat16* out = wg == 0 ? dv : dk;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key_lo + 8 * h;
    if (key < Sk)
      wide_store_row(out + ((size_t)bhk * Sk + key) * D + cs, acc, h, lane);
  }
}

template <bool DROP>
int launch_dq_tc_wide(const Args& a, int D, void* dq) {
  using G = BwdTcWide;
  if (!wide::tc_takes(D) || D % (2 * G::WG_COLS) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv, mdo;
  int rc = hopper::make_map_bf16(&mq, a.q, D, a.Sq, a.B * a.H, G::ROWS);
  if (rc == 0) rc = hopper::make_map_bf16(&mdo, a.dout, D, a.Sq, a.B * a.H, G::ROWS);
  if (rc == 0) rc = hopper::make_map_bf16(&mk, a.k, D, a.Sk, a.B * a.HK, G::TILE);
  if (rc == 0) rc = hopper::make_map_bf16(&mv, a.v, D, a.Sk, a.B * a.HK, G::TILE);
  if (rc != 0) return rc;
  rc = static_cast<int>(cudaFuncSetAttribute(
      flash_dq_kernel_tc_wide<DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM));
  if (rc != 0) return rc;
  // B*H on x (2^31 - 1), the q blocks on y, the 512-column slices on z
  const dim3 grid(a.B * a.H, (a.Sq + G::ROWS - 1) / G::ROWS,
                  D / (2 * G::WG_COLS));
  flash_dq_kernel_tc_wide<DROP><<<grid, G::THREADS, G::SMEM, a.st>>>(
      mq, mk, mv, mdo, a.lse, a.di, static_cast<__nv_bfloat16*>(dq), a.q_ids,
      a.kv_ids, a.H, a.HK, a.Sq, a.Sk, D, a.causal, a.scale * LOG2E, a.scale,
      a.drop);
  return static_cast<int>(cudaGetLastError());
}

template <bool DROP>
int launch_dkv_tc_wide(const Args& a, int D, void* dk, void* dv) {
  using G = BwdTcWide;
  if (!wide::tc_takes(D) || D % G::WG_COLS != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv, mdo;
  int rc = hopper::make_map_bf16(&mq, a.q, D, a.Sq, a.B * a.H, G::TILE);
  if (rc == 0) rc = hopper::make_map_bf16(&mdo, a.dout, D, a.Sq, a.B * a.H, G::TILE);
  if (rc == 0) rc = hopper::make_map_bf16(&mk, a.k, D, a.Sk, a.B * a.HK, G::ROWS);
  if (rc == 0) rc = hopper::make_map_bf16(&mv, a.v, D, a.Sk, a.B * a.HK, G::ROWS);
  if (rc != 0) return rc;
  rc = static_cast<int>(cudaFuncSetAttribute(
      flash_dkv_kernel_tc_wide<DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM));
  if (rc != 0) return rc;
  // B*HK on x, the key blocks on y, the 256-column slices on z
  const dim3 grid(a.B * a.HK, (a.Sk + G::ROWS - 1) / G::ROWS, D / G::WG_COLS);
  flash_dkv_kernel_tc_wide<DROP><<<grid, G::THREADS, G::SMEM, a.st>>>(
      mq, mk, mv, mdo, a.lse, a.di, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), a.q_ids, a.kv_ids, a.H, a.HK, a.Sq,
      a.Sk, D, a.causal, a.scale * LOG2E, a.scale, a.drop);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// wide CUDA-core bodies: f32 at D >= 1024 (wide::takes), and bf16 there
// with no queries or no keys (bf16 otherwise takes the wide tensor-core
// bodies, above)
// ---------------------------------------------------------------------------
//
// Register tiles on the CUDA cores, f32 FMAs (no TF32: the precision
// contract of docs/kernels.md), after the f32 wide forward
// (csrc/flash_fwd.cu, flash_fwd_kernel_wide).  The two products over D
// that the backward needs, S = Q.K^T and dP = dO.V^T, are shared by the
// column slices of a row block: the slices are a thread-block cluster of
// NC CTAs (on the grid's z, at most 8), CTA r computes the partials of S
// and dP over the D/NC columns [r D/NC, (r+1) D/NC), and every CTA sums
// the cluster's partials in rank order through distributed shared
// memory, so every slice gets the same p and ds, bit for bit, the
// dropout keep included.  256 threads a CTA; one cp.async ring of five
// 32 KB stages carries every operand a tile reads (one counter over all
// its items, a stage loaded STAGES - 1 items ahead of its use, once the
// barrier that opens an item shows every thread done with the stage's
// last use); rows and keys past Sq and Sk arrive as zeros (cp.async's
// source size 0).  A tile takes three passes over the ring:
//
// - the partial S (S^T in dk/dv) over the CTA's D/NC columns, DC = 64
//   columns of 32 rows and of the tile's 64 a stage: a thread owns a 4 x
//   4 block of it over a part of each stage's columns, so every float4
//   it reads from shared memory feeds four FMAs; the parts go to shared
//   memory;
// - the partial dP (dP^T) the same way; then one cluster barrier, and p
//   and ds from the summed partials, in the reference's order, into
//   shared memory.  The CTA arrives at a second cluster barrier once it
//   has read the others' partials and waits on it only before it next
//   writes its own (hopper::cluster_arrive / cluster_wait), so one buffer
//   of each product serves every tile, and the wait comes a whole pass
//   after the others' reads;
// - the outputs' update over the slice's columns of the other operand.
//
// dq (DqWide): a CTA owns BQ = 32 query rows and W = 1024 of dQ's
// columns, NC = min(D/1024, 8); dQ's 32 x 1024 f32 sit in registers, 8
// rows x 16 columns a thread, as the forward's O.  Key tiles of 64, the
// causal stop at the CTA's last visible key, heaviest q blocks first.
// dQ += dS.K from stages of 8 keys x 1024 columns of K: every K word
// feeds 8 FMAs and every dS word 16.
//
// dk/dv (DkvWide<ROWS>): a CTA owns ROWS key rows and W = 16384/ROWS
// columns of both dK and dV (two accumulators of ROWS x W f32: 8 key
// rows x 8 columns of each a thread), NC = min(D/W, 8).  ROWS is 32 (W
// 512) while one cluster spans the row, D <= 4096, and 16 (W 1024) past
// it: 32 rows give each staged q and dO word twice the reuse in S^T and
// dP^T (7-18% faster on an H100 at D 1024..4096), but at D 8192 they
// would need two clusters, each computing S^T and dP^T whole (16 rows
// were 18% faster there: PERF.md, Findings).  A CTA walks the GQA
// group's query heads in order and, inside each, q tiles of 64 rows
// from the first row that sees its key block under the causal mask;
// lse, di and the q segment ids are staged beside each tile.  dV +=
// P^T.dO, then dK += dS^T.Q, from stages of 8 (ROWS 16: 4) query rows of
// dO and q over the slice's columns: every dO and q word feeds 8 FMAs.
//
// No FLOP repeats while one cluster spans the row, up to D 8192 (6D a
// visible pair in dq, 8D in dk/dv).  Past that a row block has D/8192
// clusters, each computing the whole of S and dP: the same partials in
// the same order, so all agree.  Every output element has one owner
// thread that sums in a fixed order, no atomics: the same bits every run.
// A last cluster wait keeps each CTA's shared memory alive until the
// others have read it.  bf16 reaches these bodies only with no keys (dq)
// or no queries (dk/dv): its instantiations write the zeros.

struct BwdWide {
  static constexpr int THREADS = 256;
  static constexpr int DC = 64;                 // S's and dP's columns a stage
  static constexpr int PAD = DC + 4;            // a staged row's floats
  static constexpr int STAGE = 8 * 1024;        // floats a stage (32 KB)
  static constexpr int STAGES = 5;
  static constexpr int MAX_NC = 8;              // a cluster's CTAs (portable)
  static constexpr int TILE = 64;               // keys (dq), q rows (dk/dv) a tile
  static constexpr int SROW = TILE + 8;         // a partial row (floats)
  static constexpr int SPART = 64 * SROW;       // a product's partials
  static constexpr int S_OFF = STAGES * STAGE;  // S's partials, then dP's
  static constexpr int DP_OFF = S_OFF + SPART;
  static constexpr int TILE_OFF = DP_OFF + SPART;
};

struct DqWide : BwdWide {
  static constexpr int BQ = 32;                 // query rows a CTA
  static constexpr int W = 1024;                // dQ's columns a CTA
  static constexpr int VK = STAGE / W;          // K's keys a dQ stage (8)
  static constexpr int DSROW = BQ + 4;          // dS's key row (floats)
  static constexpr int SMEM = (TILE_OFF + TILE * DSROW) * 4;
};
static_assert(DqWide::W / 4 == DqWide::THREADS,
              "a thread copies one float4 of each staged K row");

template <int ROWS_>
struct DkvWide : BwdWide {
  static constexpr int ROWS = ROWS_;            // key rows a CTA (32 or 16)
  static constexpr int W = 16384 / ROWS;        // dK's and dV's columns a CTA
  static constexpr int KS = 64 / ROWS;          // S^T: parts of a stage's columns
  static constexpr int RS = ROWS / 4;           // S^T: key rows rg + RS a
  static constexpr int TPR = THREADS / ROWS;    // p and dS: threads a key row
  static constexpr int CG = W / 8;              // dK, dV: threads a row group
  static constexpr int QK = STAGE / (2 * W);    // dO and Q rows a stage
  static constexpr int PROW = ROWS + 4;         // p's (dS's) query row (floats)
  static constexpr int P_OFF = TILE_OFF;
  static constexpr int DS_OFF = P_OFF + TILE * PROW;
  static constexpr int ROW_OFF = DS_OFF + TILE * PROW;   // lse, di, q ids
  static constexpr int SMEM = (ROW_OFF + 3 * TILE) * 4;
};
static_assert(DkvWide<32>::KS * DkvWide<32>::RS * 16 == BwdWide::THREADS &&
                  DkvWide<16>::KS * DkvWide<16>::RS * 16 == BwdWide::THREADS,
              "the S^T tiles cover the CTA's threads");
static_assert(DkvWide<32>::SMEM <= 227 * 1024 &&
                  DkvWide<16>::SMEM <= 227 * 1024 && DqWide::SMEM <= 227 * 1024,
              "one CTA an SM");

// acc[a][b] += the dot products of A's rows ra + RS a with B's rows rb +
// 16 b over NF float4 columns from c of a staged pair (PAD floats a row)
template <int RS, int NF>
__device__ __forceinline__ void stage_dots(float (&acc)[4][4], const float* A,
                                           const float* B, int ra, int rb,
                                           int c) {
#pragma unroll
  for (int f = 0; f < NF; ++f, c += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      av[a] = *reinterpret_cast<const float4*>(A + (ra + RS * a) * BwdWide::PAD + c);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      bv[b] = *reinterpret_cast<const float4*>(B + (rb + 16 * b) * BwdWide::PAD + c);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = dot4(av[a], bv[b], acc[a][b]);
  }
}

// A staged pair: NA rows of `a` from row a0 (of na; flat rows from
// abase), then TILE rows of `b` from row b0 (of nb; from bbase), DC
// columns from c of each; rows past the end arrive as zeros
template <int NA, typename T>
__device__ __forceinline__ void stage_pair(float* st, const T* a, size_t abase,
                                           int a0, int na, const T* b,
                                           size_t bbase, int b0, int nb,
                                           int D, int c) {
  constexpr int R4 = BwdWide::DC / 4;
  constexpr int RPX = BwdWide::THREADS / R4;   // rows a round of copies
  const int tid = threadIdx.x;
  const int c4 = 4 * (tid % R4);
#pragma unroll
  for (int x = 0; x < NA / RPX; ++x) {
    const int r = tid / R4 + x * RPX, row = a0 + r;
    hopper::cp_async16(st + r * BwdWide::PAD + c4,
                       a + (abase + (row < na ? row : 0)) * D + c + c4,
                       row < na);
  }
#pragma unroll
  for (int x = 0; x < BwdWide::TILE / RPX; ++x) {
    const int r = tid / R4 + x * RPX, row = b0 + r;
    hopper::cp_async16(st + (NA + r) * BwdWide::PAD + c4,
                       b + (bbase + (row < nb ? row : 0)) * D + c + c4,
                       row < nb);
  }
}

// A thread's 4 x 4 block of partials (rows r + RS a, columns cb + 16 b)
// into a partials buffer, and the block zeroed for the next pass
template <int RS>
__device__ __forceinline__ void part_store(float* pb, float (&acc)[4][4],
                                           int r, int cb) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      pb[(r + RS * a) * BwdWide::SROW + cb + 16 * b] = acc[a][b];
      acc[a][b] = 0.f;
    }
}

// The sum of a score's NP parts (at p, NR rows apart) over the cluster's
// nc CTAs, in rank order: every CTA of the cluster gets the same bits
template <int NP, int NR>
__device__ __forceinline__ float part_sum(const float* p, int nc) {
  float dot = 0.f;
  for (int r = 0; r < nc; ++r) {
    float x = nc == 1 ? p[0] : hopper::ld_cluster(p, r);
#pragma unroll
    for (int s = 1; s < NP; ++s) {
      const float* ps = p + s * NR * BwdWide::SROW;
      x += nc == 1 ? *ps : hopper::ld_cluster(ps, r);
    }
    dot = r == 0 ? x : dot + x;
  }
  return dot;
}

// acc[r][c] += w[x][r] * X[x][c] over N rows x: the 8 weights of row x
// at w + WS x (a broadcast), its C float4s at X + XS x + CS c
template <int N, int WS, int XS, int CS, int C>
__device__ __forceinline__ void rank_update(float4 (&acc)[8][C], const float* w,
                                            const float* X) {
#pragma unroll
  for (int x = 0; x < N; ++x) {
    const float4 w0 = *reinterpret_cast<const float4*>(w + WS * x);
    const float4 w1 = *reinterpret_cast<const float4*>(w + WS * x + 4);
    const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    float4 xv[C];
#pragma unroll
    for (int c = 0; c < C; ++c)
      xv[c] = *reinterpret_cast<const float4*>(X + XS * x + CS * c);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] = axpy4(wv[r], xv[c], acc[r][c]);
  }
}

template <typename T, bool DROP>
__global__ void __launch_bounds__(DqWide::THREADS, 1)
flash_dq_kernel_wide(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dq,
                     const int* __restrict__ q_ids,
                     const int* __restrict__ kv_ids, int H, int HK, int Sq,
                     int Sk, int D, int causal, float scale,
                     dropout::Params drop) {
  using G = DqWide;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * G::BQ;   // heaviest first
  const int c0 = blockIdx.z * G::W;      // this CTA's columns of dQ and K
  const int tid = threadIdx.x;
  if constexpr (sizeof(T) == 2) {
    // no keys: every row's dQ is zero
    for (int i = tid; i < G::BQ * G::W / 4; i += G::THREADS) {
      const int row = q0 + i / (G::W / 4);
      if (row < Sq)
        store4(dq, (((size_t)bh * Sq + row) * D + c0) / 4 + i % (G::W / 4),
               make_float4(0.f, 0.f, 0.f, 0.f));
    }
  } else {
    extern __shared__ float4 wide_smem[];
    float* sm = reinterpret_cast<float*>(wide_smem);
    float* ds_s = sm + G::TILE_OFF;      // [TILE][DSROW]: dS, key-major

    const int b = bh / H;
    const int bhk = b * HK + (bh % H) / (H / HK);
    const bool seg = q_ids != nullptr;
    const int kend = causal ? min(Sk, q0 + G::BQ) : Sk;
    const int ntile = (kend + G::TILE - 1) / G::TILE;
    const int nc = min(D / G::W, G::MAX_NC);   // the cluster's CTAs
    const int part = D / nc;             // S's and dP's columns this CTA sums
    const int cs0 = static_cast<int>(hopper::cluster_rank()) * part;
    const int nS = part / G::DC;         // S stages a tile, and dP stages
    const int ipt = 2 * nS + G::TILE / G::VK;   // ring items a tile
    const int total = ntile * ipt;

    // the ring's item j: S stage i < nS (Q's and K's columns cs0 +
    // DC*i..), dP stage i - nS (dO's and V's), or K stage i - 2 nS (keys
    // VK*(i - 2 nS).. of the tile, the slice's columns)
    auto load = [&](int j) {
      const int t = j / ipt, i = j - t * ipt, k0 = t * G::TILE;
      float* st = sm + (j % G::STAGES) * G::STAGE;
      if (i < 2 * nS) {
        const bool s = i < nS;
        stage_pair<G::BQ>(st, s ? q : dout, (size_t)bh * Sq, q0, Sq,
                          s ? k : v, (size_t)bhk * Sk, k0, Sk, D,
                          cs0 + G::DC * (s ? i : i - nS));
      } else {
#pragma unroll
        for (int x = 0; x < G::VK; ++x) {
          const int key = k0 + G::VK * (i - 2 * nS) + x;
          hopper::cp_async16(
              st + x * G::W + 4 * tid,
              k + ((size_t)bhk * Sk + (key < Sk ? key : 0)) * D + c0 + 4 * tid,
              key < Sk);
        }
      }
    };
#pragma unroll
    for (int j = 0; j < G::STAGES - 1; ++j) {
      if (j < total) load(j);
      hopper::cp_async_commit();
    }

    // S and dP: half sh of the CTA, rows rg + 8a, keys kg + 16b
    const int sh = tid >> 7, rg = (tid >> 4) & 7, kg = tid & 15;
    // p and dS: row sr, keys sp + 8x
    const int sr = tid >> 3, sp = tid & 7, srow = q0 + sr;
    const bool srow_ok = srow < Sq;
    const size_t qrow = (size_t)bh * Sq + (srow_ok ? srow : 0);
    const float lse_r = srow_ok ? lse[qrow] : 0.f;
    const float di_r = srow_ok ? di[qrow] : 0.f;
    const int qid = (seg && srow_ok) ? q_ids[(size_t)b * Sq + srow] : 0;
    const uint32_t rkey =
        DROP ? dropout::row_key(dropout::head_key(*drop.seed, bh), srow) : 0u;
    // dQ: rows 8 og.., columns 512 oc + 4 lane + 128 c of the slice
    const int og = tid >> 6, oc = (tid >> 5) & 1, lane = tid & 31;
    const int ocol = 512 * oc + 4 * lane;

    float4 acc[8][4];
    float pacc[4][4];   // the pass's partial S or dP
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) pacc[a][c] = 0.f;

    for (int j = 0, t = 0, i = 0; j < total; ++j) {
      hopper::cp_async_wait<G::STAGES - 2>();
      __syncthreads();   // item j landed; every thread is done with j - 1
      if (j + G::STAGES - 1 < total) load(j + G::STAGES - 1);
      hopper::cp_async_commit();
      const float* st = sm + (j % G::STAGES) * G::STAGE;
      if (i < 2 * nS) {
        stage_dots<8, G::DC / 8>(pacc, st, st + G::BQ * G::PAD, rg, kg,
                                 G::DC / 2 * sh);
        if (i == nS - 1 || i == 2 * nS - 1) {
          // the pass's partials to shared memory (S's once the others are
          // done reading the last tile's); after dP's the cluster's
          // partials meet and give the tile's dS
          const bool s = i == nS - 1;
          if (s && t > 0 && nc > 1) hopper::cluster_wait();
          part_store<8>(sm + (s ? G::S_OFF : G::DP_OFF), pacc,
                        sh * G::BQ + rg, kg);
          if (!s) {
            if (nc > 1)
              hopper::cluster_sync();
            else
              __syncthreads();
            const int k0 = t * G::TILE;
#pragma unroll
            for (int x = 0; x < 8; ++x) {
              const int key = sp + 8 * x, col = k0 + key;
              const int o = sr * G::SROW + key;
              const float dot = part_sum<2, G::BQ>(sm + G::S_OFF + o, nc);
              float dp = part_sum<2, G::BQ>(sm + G::DP_OFF + o, nc);
              const bool ok = srow_ok && col < Sk && (!causal || col <= srow) &&
                              (!seg || kv_ids[(size_t)b * Sk + col] == qid);
              const float p = prob(ok, dot, scale, lse_r);
              if (DROP)
                dp = dropout::apply(drop, dropout::col_key(rkey, col), dp);
              ds_s[key * G::DSROW + sr] = dscore(p, dp, di_r, scale);
            }
            if (nc > 1) hopper::cluster_arrive();
          }
        }
      } else {
        // dQ += dS.K over the stage's VK keys
        rank_update<G::VK, G::DSROW, G::W, 128>(
            acc, ds_s + G::VK * (i - 2 * nS) * G::DSROW + 8 * og, st + ocol);
      }
      if (++i == ipt) {
        i = 0;
        ++t;
      }
    }
    hopper::cp_async_wait<0>();
    // the other CTAs of the cluster are done reading this one's partials
    if (nc > 1 && total > 0) hopper::cluster_wait();

#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = q0 + 8 * og + r;
      if (row >= Sq) continue;
      const size_t base = (((size_t)bh * Sq + row) * D + c0 + ocol) / 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) store4(dq, base + 32 * c, acc[r][c]);
    }
  }
}

template <typename T, int ROWS, bool DROP>
__global__ void __launch_bounds__(BwdWide::THREADS, 1)
flash_dkv_kernel_wide(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ di, T* __restrict__ dk,
                      T* __restrict__ dv, const int* __restrict__ q_ids,
                      const int* __restrict__ kv_ids, int H, int HK, int Sq,
                      int Sk, int D, int causal, float scale,
                      dropout::Params drop) {
  using G = DkvWide<ROWS>;
  const int bhk = blockIdx.x;
  const int c0 = blockIdx.y * G::ROWS;   // the first key block sees most rows
  const int cw0 = blockIdx.z * G::W;     // this CTA's columns of dK and dV
  const int tid = threadIdx.x;
  if constexpr (sizeof(T) == 2) {
    // no queries: dK and dV are zero
    for (int i = tid; i < G::ROWS * G::W / 4; i += G::THREADS) {
      const int key = c0 + i / (G::W / 4);
      if (key < Sk) {
        const size_t o = (((size_t)bhk * Sk + key) * D + cw0) / 4 + i % (G::W / 4);
        store4(dk, o, make_float4(0.f, 0.f, 0.f, 0.f));
        store4(dv, o, make_float4(0.f, 0.f, 0.f, 0.f));
      }
    }
  } else {
    extern __shared__ float4 wide_smem[];
    float* sm = reinterpret_cast<float*>(wide_smem);
    float* p_s = sm + G::P_OFF;          // [TILE][PROW]: dV's p, q-row-major
    float* ds_s = sm + G::DS_OFF;        // [TILE][PROW]: dS
    float* lse_s = sm + G::ROW_OFF;      // [TILE]: the tile's rows' lse,
    float* di_s = lse_s + G::TILE;       // di
    int* qid_s = reinterpret_cast<int*>(di_s + G::TILE);   // and q ids

    const int b = bhk / HK;
    const int hk = bhk % HK;
    const int group = H / HK;
    const bool seg = q_ids != nullptr;
    // causal: rows before c0 see none of this block's keys
    const int rstart = causal ? min(c0, Sq) : 0;
    const int nqt = (Sq - rstart + G::TILE - 1) / G::TILE;   // q tiles a head
    const int nc = min(D / G::W, G::MAX_NC);   // the cluster's CTAs
    const int part = D / nc;             // S^T's and dP^T's columns this CTA sums
    const int cs0 = static_cast<int>(hopper::cluster_rank()) * part;
    const int nS = part / G::DC;         // S^T stages a tile, and dP^T stages
    const int ipt = 2 * nS + G::TILE / G::QK;   // ring items a tile
    const int total = group * nqt * ipt;

    // tile t: the group's query head t / nqt (flat q row bh), rows from r0
    auto tile_rows = [&](int t, int& bh, int& r0) {
      const int hh = t / nqt;
      bh = b * H + hk * group + hh;
      r0 = rstart + (t - hh * nqt) * G::TILE;
    };
    // the ring's item j: S^T stage i < nS (K's and q's columns cs0 +
    // DC*i..), dP^T stage i - nS (V's and dO's), or dV/dK stage i - 2 nS
    // (QK q rows of dO, then of q, the slice's columns)
    auto load = [&](int j) {
      const int t = j / ipt, i = j - t * ipt;
      int bh, r0;
      tile_rows(t, bh, r0);
      float* st = sm + (j % G::STAGES) * G::STAGE;
      if (i < 2 * nS) {
        const bool s = i < nS;
        stage_pair<G::ROWS>(st, s ? k : v, (size_t)bhk * Sk, c0, Sk,
                            s ? q : dout, (size_t)bh * Sq, r0, Sq, D,
                            cs0 + G::DC * (s ? i : i - nS));
      } else {
        constexpr int R4 = G::W / 4;
#pragma unroll
        for (int x = 0; x < G::STAGE / 4 / G::THREADS; ++x) {
          const int f = tid + x * G::THREADS;   // the stage's float4
          const int w = f % (2 * R4), row = r0 + G::QK * (i - 2 * nS) + f / (2 * R4);
          hopper::cp_async16(
              st + 4 * f,
              (w < R4 ? dout : q) + ((size_t)bh * Sq + (row < Sq ? row : 0)) * D +
                  cw0 + 4 * (w % R4),
              row < Sq);
        }
      }
    };
#pragma unroll
    for (int j = 0; j < G::STAGES - 1; ++j) {
      if (j < total) load(j);
      hopper::cp_async_commit();
    }

    // S^T and dP^T: part sh of the stage's columns, key rows rg + RS a,
    // q rows qg + 16 b
    const int sh = tid / (G::RS * 16), rg = (tid / 16) % G::RS, qg = tid % 16;
    // p and dS: key row sr, q rows sp + TPR x
    const int sr = tid / G::TPR, sp = tid % G::TPR, key = c0 + sr;
    const bool key_ok = key < Sk;
    const int kid = (seg && key_ok) ? kv_ids[(size_t)b * Sk + key] : 0;
    // dK and dV: key rows 8 og.., columns 4 cg + W/2 c of the slice
    const int og = tid / G::CG, ocol = 4 * (tid % G::CG);

    float4 dka[8][2], dva[8][2];
    float pacc[4][4];   // the pass's partial S^T or dP^T
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        dka[r][c] = dva[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) pacc[a][c] = 0.f;

    for (int j = 0, t = 0, i = 0; j < total; ++j) {
      hopper::cp_async_wait<G::STAGES - 2>();
      __syncthreads();   // item j landed; every thread is done with j - 1
      if (j + G::STAGES - 1 < total) load(j + G::STAGES - 1);
      hopper::cp_async_commit();
      const float* st = sm + (j % G::STAGES) * G::STAGE;
      if (i < 2 * nS) {
        int bh, r0;
        tile_rows(t, bh, r0);
        if (i == 0 && tid < G::TILE) {
          // the tile's lse, di and q ids (read past the barriers to come)
          const int row = r0 + tid;
          const bool ok = row < Sq;
          const size_t fr = (size_t)bh * Sq + (ok ? row : 0);
          lse_s[tid] = ok ? lse[fr] : 0.f;
          di_s[tid] = ok ? di[fr] : 0.f;
          qid_s[tid] = (seg && ok) ? q_ids[(size_t)b * Sq + row] : 0;
        }
        stage_dots<G::RS, G::DC / G::KS / 4>(pacc, st, st + G::ROWS * G::PAD,
                                             rg, qg, G::DC / G::KS * sh);
        if (i == nS - 1 || i == 2 * nS - 1) {
          // the pass's partials to shared memory (S^T's once the others
          // are done reading the last tile's); after dP^T's the
          // cluster's partials meet and give the tile's p and dS
          const bool s = i == nS - 1;
          if (s && t > 0 && nc > 1) hopper::cluster_wait();
          part_store<G::RS>(sm + (s ? G::S_OFF : G::DP_OFF), pacc,
                            sh * G::ROWS + rg, qg);
          if (!s) {
            if (nc > 1)
              hopper::cluster_sync();
            else
              __syncthreads();
            const uint32_t ckey =
                DROP ? dropout::col_key(dropout::head_key(*drop.seed, bh), key)
                     : 0u;
#pragma unroll
            for (int x = 0; x < G::TILE / G::TPR; ++x) {
              const int qr = sp + G::TPR * x, row = r0 + qr;
              const int o = sr * G::SROW + qr;
              const float dot = part_sum<G::KS, G::ROWS>(sm + G::S_OFF + o, nc);
              float dp = part_sum<G::KS, G::ROWS>(sm + G::DP_OFF + o, nc);
              const bool ok = key_ok && row < Sq && (!causal || key <= row) &&
                              (!seg || qid_s[qr] == kid);
              const float p = prob(ok, dot, scale, lse_s[qr]);
              float pv = p;   // dV's p: keep * p / (1 - rate) under DROP
              if (DROP) {
                const bool keep = dropout::kept(drop, dropout::row_key(ckey, row));
                pv = dropout::scaled(drop, keep, p);
                dp = dropout::scaled(drop, keep, dp);
              }
              p_s[qr * G::PROW + sr] = pv;
              ds_s[qr * G::PROW + sr] = dscore(p, dp, di_s[qr], scale);
            }
            if (nc > 1) hopper::cluster_arrive();
          }
        }
      } else {
        // dV += P^T.dO, then dK += dS^T.Q, over the stage's QK q rows
        const int qq0 = G::QK * (i - 2 * nS);
        rank_update<G::QK, G::PROW, 2 * G::W, G::W / 2>(
            dva, p_s + qq0 * G::PROW + 8 * og, st + ocol);
        rank_update<G::QK, G::PROW, 2 * G::W, G::W / 2>(
            dka, ds_s + qq0 * G::PROW + 8 * og, st + G::W + ocol);
      }
      if (++i == ipt) {
        i = 0;
        ++t;
      }
    }
    hopper::cp_async_wait<0>();
    // the other CTAs of the cluster are done reading this one's partials
    if (nc > 1 && total > 0) hopper::cluster_wait();

#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int kr = c0 + 8 * og + r;
      if (kr >= Sk) continue;
      const size_t base = (((size_t)bhk * Sk + kr) * D + cw0 + ocol) / 4;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        store4(dk, base + G::W / 8 * c, dka[r][c]);
        store4(dv, base + G::W / 8 * c, dva[r][c]);
      }
    }
  }
}

// B*H (B*HK) on x (2^31 - 1), the row blocks on y, the column slices on
// z, a cluster of up to 8 slices; bf16 (no keys or no queries) writes
// zeros and takes no shared memory
template <typename T, bool DROP>
int launch_dq_wide(const Args& a, int D, void* dq) {
  using G = DqWide;
  if (!wide::takes(D)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = sizeof(T) == 2 ? 0 : G::SMEM;
  static const bool sized =
      hopper::allow_smem(flash_dq_kernel_wide<T, DROP>, smem);
  if (!sized) return static_cast<int>(cudaErrorInvalidValue);
  return hopper::launch_clusters(
      flash_dq_kernel_wide<T, DROP>,
      dim3(a.B * a.H, (a.Sq + G::BQ - 1) / G::BQ, D / G::W), G::THREADS, smem,
      min(D / G::W, G::MAX_NC), a.st, static_cast<const T*>(a.q),
      static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.di, static_cast<T*>(dq),
      a.q_ids, a.kv_ids, a.H, a.HK, a.Sq, a.Sk, D, a.causal, a.scale, a.drop);
}

template <typename T, int ROWS, bool DROP>
int launch_dkv_wide_rows(const Args& a, int D, void* dk, void* dv) {
  using G = DkvWide<ROWS>;
  const int smem = sizeof(T) == 2 ? 0 : G::SMEM;
  static const bool sized =
      hopper::allow_smem(flash_dkv_kernel_wide<T, ROWS, DROP>, smem);
  if (!sized) return static_cast<int>(cudaErrorInvalidValue);
  return hopper::launch_clusters(
      flash_dkv_kernel_wide<T, ROWS, DROP>,
      dim3(a.B * a.HK, (a.Sk + G::ROWS - 1) / G::ROWS, D / G::W), G::THREADS,
      smem, min(D / G::W, G::MAX_NC), a.st, static_cast<const T*>(a.q),
      static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.di, static_cast<T*>(dk),
      static_cast<T*>(dv), a.q_ids, a.kv_ids, a.H, a.HK, a.Sq, a.Sk, D,
      a.causal, a.scale, a.drop);
}

// dk/dv takes 32 key rows x 512 columns a CTA while one cluster of 8
// spans the row (D <= 4096), and 16 x 1024 past it (above, DkvWide; bf16,
// which only writes zeros here, takes the first)
template <typename T, bool DROP>
int launch_dkv_wide(const Args& a, int D, void* dk, void* dv) {
  if (!wide::takes(D)) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (sizeof(T) == 2)
    return launch_dkv_wide_rows<T, 32, DROP>(a, D, dk, dv);
  else if (D <= BwdWide::MAX_NC * DkvWide<32>::W)
    return launch_dkv_wide_rows<T, 32, DROP>(a, D, dk, dv);
  else
    return launch_dkv_wide_rows<T, 16, DROP>(a, D, dk, dv);
}

// The route of both backward kernels: bf16 at D 64, 128 and 256 takes
// the tensor cores, and at D 512 and every wide width (D >= 1024,
// wide::tc_takes) the wide tensor-core bodies; f32 at the wide widths the
// wide CUDA-core bodies, everything else (f32 at every width up to 512,
// bf16 at 16 and 32) the CUDA-core bodies of their width; a seed takes
// each body's DROP instantiation.
template <typename T, bool DROP>
int route_dq(const Args& a, int D, void* dq) {
  if (sizeof(T) == 2 && a.Sq > 0 && a.Sk > 0) {
    if (D == 64) return launch_dq_tc<64, DROP>(a, dq);
    if (D == 128) return launch_dq_tc<128, DROP>(a, dq);
    if (D == 256) return launch_dq_tc<256, DROP>(a, dq);
    if (wide::tc_takes(D)) return launch_dq_tc_wide<DROP>(a, D, dq);
  }
  if (D >= wide::MIN_D) return launch_dq_wide<T, DROP>(a, D, dq);
  switch (D) {
    case 16: launch_dq<T, 16, DROP>(a, dq); break;
    case 32: launch_dq<T, 32, DROP>(a, dq); break;
    case 64: launch_dq<T, 64, DROP>(a, dq); break;
    case 128: launch_dq<T, 128, DROP>(a, dq); break;
    case 256: launch_dq<T, 256, DROP>(a, dq); break;
    case 512: launch_dq<T, 512, DROP>(a, dq); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool DROP>
int route_dkv(const Args& a, int D, void* dk, void* dv) {
  if (sizeof(T) == 2 && a.Sq > 0 && a.Sk > 0) {
    if (D == 64) return launch_dkv_tc<64, DROP>(a, dk, dv);
    if (D == 128) return launch_dkv_tc<128, DROP>(a, dk, dv);
    if (D == 256) return launch_dkv_tc<256, DROP>(a, dk, dv);
    if (wide::tc_takes(D)) return launch_dkv_tc_wide<DROP>(a, D, dk, dv);
  }
  if (D >= wide::MIN_D) return launch_dkv_wide<T, DROP>(a, D, dk, dv);
  switch (D) {
    case 16: launch_dkv<T, 16, DROP>(a, dk, dv); break;
    case 32: launch_dkv<T, 32, DROP>(a, dk, dv); break;
    case 64: launch_dkv<T, 64, DROP>(a, dk, dv); break;
    case 128: launch_dkv<T, 128, DROP>(a, dk, dv); break;
    case 256: launch_dkv<T, 256, DROP>(a, dk, dv); break;
    case 512: launch_dkv<T, 512, DROP>(a, dk, dv); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dq(const Args& a, int D, void* dq) {
  return a.drop.seed != nullptr ? route_dq<T, true>(a, D, dq)
                                : route_dq<T, false>(a, D, dq);
}

template <typename T>
int dispatch_dkv(const Args& a, int D, void* dk, void* dv) {
  return a.drop.seed != nullptr ? route_dkv<T, true>(a, D, dk, dv)
                                : route_dkv<T, false>(a, D, dk, dv);
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* di, const void* q_ids,
               const void* kv_ids, int B, int H, int HK, int Sq, int Sk,
               int causal, float scale, const void* seed, unsigned keep_below,
               float keep_scale, void* stream) {
  return Args{q, k, v, dout,
              static_cast<const float*>(lse), static_cast<const float*>(di),
              static_cast<const int*>(q_ids), static_cast<const int*>(kv_ids),
              B, H, HK, Sq, Sk, causal, scale,
              dropout::Params{static_cast<const int*>(seed), keep_below,
                              keep_scale},
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// Plain C entry points (bound with ctypes).  dtype: 0 float32, 1
// bfloat16 (q, k, v, dout and the gradients alike); lse and di f32
// (B*H, Sq); q_ids/kv_ids both null or both set; seed null (no dropout)
// or the forward's one int32 on the device, with keep_below the unsigned
// hash threshold and keep_scale 1 / (1 - rate).  Each launches on
// `stream`, allocates nothing, and returns cudaGetLastError() after the
// launch (0 when it was accepted).
extern "C" int apex_flash_dq(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* di,
                             void* dq, const void* q_ids, const void* kv_ids,
                             int dtype, int B, int H, int HK, int Sq, int Sk,
                             int D, int causal, float scale, const void* seed,
                             unsigned keep_below, float keep_scale,
                             void* stream) {
  const Args a = make_args(q, k, v, dout, lse, di, q_ids, kv_ids, B, H, HK,
                           Sq, Sk, causal, scale, seed, keep_below,
                           keep_scale, stream);
  switch (dtype) {
    case F32: return dispatch_dq<float>(a, D, dq);
    case BF16: return dispatch_dq<__nv_bfloat16>(a, D, dq);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int apex_flash_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* di, void* dk, void* dv,
                              const void* q_ids, const void* kv_ids,
                              int dtype, int B, int H, int HK, int Sq, int Sk,
                              int D, int causal, float scale,
                              const void* seed, unsigned keep_below,
                              float keep_scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, di, q_ids, kv_ids, B, H, HK,
                           Sq, Sk, causal, scale, seed, keep_below,
                           keep_scale, stream);
  switch (dtype) {
    case F32: return dispatch_dkv<float>(a, D, dk, dv);
    case BF16: return dispatch_dkv<__nv_bfloat16>(a, D, dk, dv);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The CUDA-core dq and dk/dv bodies at D 512, whatever the dtype (same
// arguments as above): bf16 there routes to the wide tensor-core bodies,
// and these let a measurement time the CUDA-core bodies beside them on
// the same inputs.  Any other width is refused (from D 1024 f32 routes
// to the wide CUDA-core bodies, and bf16 has no CUDA-core body there).
extern "C" int apex_flash_dq_cuda_cores(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dq, const void* q_ids,
    const void* kv_ids, int dtype, int B, int H, int HK, int Sq, int Sk, int D,
    int causal, float scale, const void* seed, unsigned keep_below,
    float keep_scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, di, q_ids, kv_ids, B, H, HK,
                           Sq, Sk, causal, scale, seed, keep_below,
                           keep_scale, stream);
  const bool drop = a.drop.seed != nullptr;
  if (D != 512) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == F32)
    return drop ? route_dq<float, true>(a, D, dq) : route_dq<float, false>(a, D, dq);
  if (dtype == BF16) {
    if (drop)
      launch_dq<__nv_bfloat16, 512, true>(a, dq);
    else
      launch_dq<__nv_bfloat16, 512, false>(a, dq);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int apex_flash_dkv_cuda_cores(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, void* dk, void* dv, const void* q_ids,
    const void* kv_ids, int dtype, int B, int H, int HK, int Sq, int Sk, int D,
    int causal, float scale, const void* seed, unsigned keep_below,
    float keep_scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, di, q_ids, kv_ids, B, H, HK,
                           Sq, Sk, causal, scale, seed, keep_below,
                           keep_scale, stream);
  const bool drop = a.drop.seed != nullptr;
  if (D != 512) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == F32)
    return drop ? route_dkv<float, true>(a, D, dk, dv)
                : route_dkv<float, false>(a, D, dk, dv);
  if (dtype == BF16) {
    if (drop)
      launch_dkv<__nv_bfloat16, 512, true>(a, dk, dv);
    else
      launch_dkv<__nv_bfloat16, 512, false>(a, dk, dv);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
