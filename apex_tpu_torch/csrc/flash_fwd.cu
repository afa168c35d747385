// Flash-attention forward for Hopper (sm_90a): four bodies, chosen by
// dtype and head width in the C dispatcher (`dispatch`, below).
//
// Replaces the TPU kernel apex_tpu/ops/attention.py::_fwd_pallas
// (_fwd_kernel and _fwd_kernel_1kv).  Same semantics: q (B,H,Sq,D), k/v
// (B,HK,Sk,D) contiguous, f32 or bf16; query head h reads kv head
// h / (H/HK); the causal mask is the absolute col <= row; the optional
// segment mask keeps q_ids[b,row] == kv_ids[b,col]; a row that sees no
// key writes exact zeros.  When `lse` is given (training: the backward
// kernels recompute P from it) the kernel also writes the f32 logsumexp
// m + log(l) of every row, (B*H, Sq), -1e30 where l == 0 (the
// reference's need_lse=True); the primal path passes null.
//
// The fused probability dropout (every body's DROP instantiation, taken
// when a seed pointer is given; rate 0 launches the DROP = false bodies):
// the reference's counter hash (hopper_mma.cuh, namespace dropout) of
// (seed, b*H + h, q row, key) decides each pair; l sums the undropped p,
// and only P.V sees keep * p / (1 - rate), rounded to v's dtype as p is.
//
// The routes (a dispatch on shape, not a fallback: a failure raises):
//
// - tensor cores, flash_fwd_kernel_tc: bf16 at D 64, 128 and 256 (every
//   path that trains through flash: GPT-2, BERT-Large, Llama-class heads,
//   and the Gemma-class heads of 129..256, padded to 256).
// - CUDA cores, flash_fwd_kernel: f32 up to D 512 (the serving path; the
//   precision contract of docs/kernels.md makes f32 operands true f32,
//   so no TF32), bf16 at D 16 and 32, and a call with no keys (Sk == 0)
//   up to D 512.
// - wide tensor cores, flash_fwd_kernel_tc_wide: bf16 at D 512 (and the
//   heads of 257..511, padded to it) and D >= 1024 (the powers of two to
//   8192, then the multiples of 8192: the wrapper pads every wider head
//   to one; wide::tc_takes), D a runtime width; a CTA owns 256 of O's
//   columns and computes S over the whole D (below, before the route).
// - wide CUDA cores, flash_fwd_kernel_wide: f32 at D >= 1024 (and bf16
//   there with no keys), with D a runtime width: register tiles of S and
//   O on the CUDA cores, a CTA on 32 query rows and 1024 of O's columns.
//
// All follow the reference's arithmetic: bf16 products with f32 sums
// (the tensor cores compute exactly that; the CUDA-core body converts
// bf16 to f32 on load, where a product of two bf16 values is exact),
// the probabilities rounded to bf16 before P.V (`p.astype(v.dtype)`),
// the row sum l of the unrounded p, o rounded to bf16 once.  Masked
// scores take the -1e30 sentinel and their probabilities are SELECTED
// to 0, so exp never sees (-inf) - (-inf) and a row that sees no key
// ends with l == 0 and acc == 0.  The tensor-core body computes exp as
// exp2 with log2(e) folded into the scale (scores, row max and the
// running sum live in base 2); lse is converted back to a natural log.
//
// What bounds the tensor-core body: at GPT-2 small's (8, 12, 512, 64)
// causal shape a call does 3.23 GFLOP over 25.4 MB, 3.3 us at 989
// TFLOP/s against 7.6 us at 3.35 TB/s: bytes bound it on paper, and in
// practice the latency of each CTA's chain (load, Q.K^T, softmax, P.V)
// does.  The design: one CTA, one warpgroup, owns 64 query rows of one
// (batch, head) (two warpgroups of 64 rows sharing each K/V tile were
// slower at GPT-2 small's shape on an H100).  Its Q tile comes once by
// TMA into 128-byte-swizzled shared memory (D/64 panels of 64 columns);
// K/V tiles of BK = 64 keys flow through a two-stage (one-stage at D
// 256, below) TMA ring with mbarrier completion, the next tile's load in
// flight while the current one's products run.  S = Q.K^T is one wgmma
// m64n64k16 per 16 columns of D (A = Q, B = K, both K-major in shared
// memory, f32 accumulators); the online softmax runs on the accumulator
// fragment (a row's four lanes meet through two shuffles); P, rounded
// to bf16 in registers, is the register A operand of O += P.V (B = the
// V tile, MN-major through wgmma's transpose bit).  Only the diagonal
// tile, the ragged last tile and tiles under segment ids evaluate the
// per-element mask; a tile wholly visible skips it.  Under the causal
// mask the key loop stops at the CTA's diagonal tile, and the q blocks
// run heaviest first (blockIdx.y counts them from the last, the heads
// in blockIdx.x), so the longest CTAs start first.  Ragged edges: TMA
// fills rows past Sq or Sk with zeros, keys past Sk are masked and rows
// past Sq are not stored.  No warp specialisation or persistent CTAs
// yet: one thread of the CTA starts the loads.
//
// At D 256 the same body holds a 64 x 256 f32 O accumulator (128
// registers a thread) beside S (32) and P's bf16 fragment (16), within
// one warpgroup's 255 (213 registers, 230 with dropout, no spills).  A
// causal (8, 4, 512, 256) call does 4.3 GFLOP over 33.6 MB: 4.3 us at
// 989 TFLOP/s against 10.0 us at 3.35 TB/s, bytes on paper; in practice
// each CTA's chain of dependent products, as at D 64.  So the ring
// there has one stage (FwdTc::STAGES): the Q tile and one K and one V
// tile take 96 KB, two CTAs share an SM and each runs while the other
// waits, K's next tile loading once S is computed and V's once P.V is.
// Against two stages (160 KB, one CTA an SM), on an H100 at 700 W
// (apex_tpu_torch/tools/flash_fwd_stages.py, the same bits): 0.0246 ms
// where two took 0.0282 at that shape, 27-29% less at (16, 8, 512),
// (4, 8, 1024) and (1, 8, 4096) x 256, but 11% more at (2, 4, 2048).
//
// What bounds the CUDA-core body: arithmetic.  A causal prefill does
// about S/8 operations per byte of q/k/v/o it must move (64 at S=512),
// against the card's 67e12/3.35e12 = 20 for f32 outside the tensor
// cores.  One CTA owns BQ query rows of one (batch, head) (64 up to D
// 128, 32 at D 256, 16 at D 512: 256 threads past D 128) and walks the
// key/value rows in tiles of BK=32 staged through shared memory as f32
// (dynamic past D 128: 64 KB at D 256), with the flash-2 online softmax
// (running max m, running sum l, unnormalised accumulator) in registers.
// Each query row is split over TPQ = D/32 threads (one thread for D <= 32), each owning 32 of its D
// columns as float4 chunks interleaved across the group, so a warp's
// shared-memory reads of one key row hit TPQ neighbouring 16-byte words
// (a broadcast, no bank conflict) and the partial dot products meet
// through log2(TPQ) warp shuffles.  Under the causal mask the key loop
// stops at the CTA's diagonal tile (the TPU kernel's clamped index map).
// As in the tensor-core body, B*H rides the grid's x (up to 2^31 - 1, so
// the flat row the dropout hash takes is never split over launches) and
// the q blocks its y, heaviest first.
//
// Every output element is owned by one CTA that sums in a fixed order:
// no atomics, the same bits every run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <chrono>

#include "hopper_mma.cuh"

namespace {

constexpr int BK = 32;          // key rows per shared-memory tile
constexpr float NEG = -1e30f;   // the TPU kernel's mask sentinel

enum Dtype { F32 = 0, BF16 = 1 };

template <int D>
struct Geo {
  static constexpr int DPT = D < 32 ? D : 32;   // columns per thread
  static constexpr int TPQ = D / DPT;           // threads per query row
  static constexpr int C4 = DPT / 4;            // float4 chunks per thread
  // query rows per CTA: 64 up to D 128; past it fewer, so that a CTA
  // keeps 256 threads of 32 columns each (the reference shrinks its
  // sequence blocks as the padded width grows the same way)
  static constexpr int BQ = D <= 128 ? 64 : 8192 / D;
  static constexpr int THREADS = BQ * TPQ;
  // the K and V tiles (f32) and the key ids: static shared memory while
  // they fit its 48 KB (D <= 128: the compiler addresses them as
  // constants), dynamic past it (64 KB at D 256, 128 KB at D 512)
  static constexpr int SMEM = 2 * BK * D * 4 + BK * 4;
  static constexpr bool DYN = SMEM > 48 * 1024;
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

template <typename T, int D, bool DROP>
__global__ void __launch_bounds__(Geo<D>::THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ q_ids,
                 const int* __restrict__ kv_ids, int H, int HK, int Sq,
                 int Sk, int causal, float scale, dropout::Params drop) {
  using G = Geo<D>;
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
  const int part = tid % G::TPQ;
  const int row = q0 + tid / G::TPQ;
  const bool row_ok = row < Sq;
  const bool seg = q_ids != nullptr;
  const uint32_t rkey =
      DROP ? dropout::row_key(dropout::head_key(*drop.seed, bh), row) : 0u;

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
  const int kend = causal ? min(Sk, q0 + G::BQ) : Sk;
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
      const float pv = operand<T>(
          DROP ? dropout::apply(drop, dropout::col_key(rkey, k0 + j), p) : p);
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

template <typename T, int D, bool DROP>
void launch(const void* q, const void* k, const void* v, void* o, float* lse,
            const int* q_ids, const int* kv_ids, int B, int H, int HK,
            int Sq, int Sk, int causal, float scale,
            const dropout::Params& drop, cudaStream_t stream) {
  using G = Geo<D>;
  constexpr int dyn = G::DYN ? G::SMEM : 0;
  static const bool sized = hopper::allow_smem(flash_fwd_kernel<T, D, DROP>, dyn);
  (void)sized;
  // B*H on x (2^31 - 1), the q blocks on y
  const dim3 grid(B * H, (Sq + G::BQ - 1) / G::BQ);
  flash_fwd_kernel<T, D, DROP><<<grid, G::THREADS, dyn, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, q_ids, kv_ids, H,
      HK, Sq, Sk, causal, scale, drop);
}

// ---------------------------------------------------------------------------
// wide body: f32 at D >= 1024 (wide::takes), and bf16 there with no keys
// (bf16 with keys takes flash_fwd_kernel_tc_wide)
// ---------------------------------------------------------------------------
//
// Register tiles on the CUDA cores, f32 FMAs (no TF32: the precision
// contract of docs/kernels.md).  A CTA of 256 threads owns BQ = 32 query
// rows and W = 1024 of O's columns (blockIdx.z counts the D/1024 column
// slices), O's 32 x 1024 f32 held in registers: each thread 8 rows x 16
// columns (128 registers).  The slices of a q block form a thread-block
// cluster of NC = min(D/1024, 8) CTAs (on the grid's z), and CTA r of the
// cluster computes S's partial dot products over the D/NC columns [r D/NC,
// (r+1) D/NC).  Each key tile of BK = 64 keys takes two passes over one
// ring of cp.async stages in shared memory:
//
// - the partial S = Q.K^T over the CTA's D/NC columns, DC = 64 columns of
//   Q's 32 rows and K's 64 keys a stage.  A thread owns a 4 x 4 block of
//   S (rows rg + 8a, keys kg + 16b) over half of each stage's columns
//   (two halves of the CTA split the columns), so every float4 it reads
//   from shared memory feeds four of its FMAs.  The halves go to shared
//   memory (two buffers, a tile's and the last one's), one cluster
//   barrier, and each score is the sum over the cluster's CTAs, in rank
//   order, of half 0 plus half 1, read through distributed shared
//   memory: every CTA of the cluster gets the same scores, bit for bit.
// - the online softmax: eight threads a row, eight keys each, the row's
//   max and sum over three shuffles; P (after the dropout keep, as the
//   reference applies it) and the rescale factor go to shared memory.
// - O += P.V over the slice's V columns, VK = 8 keys a stage: each thread
//   reads its 8 rows' p (a broadcast) and its 16 columns of each key row
//   (float4s that a warp reads contiguously), every V word feeding 8 FMAs
//   and every p word 16.
//
// One counter runs over every ring item ((D/NC)/64 S stages and 8 V
// stages a tile, 32 KB a stage, five stages); a stage is loaded STAGES -
// 1 items ahead of its use, once the barrier that opens an item shows
// every thread done with the stage's last use.  Rows past Sq and keys
// past Sk arrive as zeros (cp.async's source size 0).  (Stages of 32
// columns and 4 keys, twice the barriers, were slower on an H100.)  So the slices share S, and no FLOP
// repeats up to D 8192 (4D a pair); past it (F7) each cluster of 8
// computes the whole of S (D/8192 clusters: (D/8192)·2D + 2D a pair), the
// same partials in the same order, so every slice gets the same m, l and
// p, bit for bit, the dropout keep included, and slice 0 writes the lse.
// A cluster's CTAs see the same keys, so they meet at the same barriers;
// a last one keeps each CTA's shared memory alive until the others have
// read it.  Heaviest q blocks first, the key loop's stop at the CTA's
// last visible key, and no atomics (every sum in a fixed order: the same
// bits every run), as in the other bodies.  bf16 reaches this body only
// with no keys (Sk == 0): its instantiation writes the zero rows and the
// -1e30 lse.

struct FwdWide {
  static constexpr int THREADS = 256;
  static constexpr int BQ = 32;                 // query rows a CTA
  static constexpr int BK = 64;                 // keys a tile
  static constexpr int W = 1024;                // O's columns a CTA
  static constexpr int DC = 64;                 // S's columns a stage
  static constexpr int PAD = DC + 4;            // a staged row's floats
  static constexpr int VK = 8;                  // V's keys a stage
  static constexpr int STAGE = VK * W;          // floats a stage (Q+K fit)
  static constexpr int STAGES = 5;
  static constexpr int MAX_NC = 8;              // a cluster's CTAs (portable)
  static constexpr int SROW = BK + 8;           // partial S row (floats)
  static constexpr int PROW = BQ + 4;           // P's key row (floats)
  static constexpr int SPART_OFF = STAGES * STAGE;
  static constexpr int SPART = 2 * BQ * SROW;   // a tile's two halves
  static constexpr int P_OFF = SPART_OFF + 2 * SPART;
  static constexpr int ROW_OFF = P_OFF + BK * PROW;   // alpha, then l
  static constexpr int SMEM = (ROW_OFF + 2 * BQ) * 4;
};
static_assert(FwdWide::BQ * FwdWide::PAD + FwdWide::BK * FwdWide::PAD <=
                  FwdWide::STAGE, "an S stage fits a ring stage");
static_assert(FwdWide::BQ * FwdWide::DC / 4 % FwdWide::THREADS == 0,
              "every thread copies the same number of Q's float4s");

template <typename T, bool DROP>
__global__ void __launch_bounds__(FwdWide::THREADS, 1)
flash_fwd_kernel_wide(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, const int* __restrict__ q_ids,
                      const int* __restrict__ kv_ids, int H, int HK, int Sq,
                      int Sk, int D, int causal, float scale,
                      dropout::Params drop) {
  using G = FwdWide;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * G::BQ;   // heaviest first
  const int c0 = blockIdx.z * G::W;      // this CTA's columns of O and V
  const int tid = threadIdx.x;
  if constexpr (sizeof(T) == 2) {
    // no keys: every row sees none
    for (int i = tid; i < G::BQ * G::W / 4; i += G::THREADS) {
      const int row = q0 + i / (G::W / 4);
      if (row < Sq)
        store4(o, (((size_t)bh * Sq + row) * D + c0) / 4 + i % (G::W / 4),
               make_float4(0.f, 0.f, 0.f, 0.f));
    }
    if (lse != nullptr && blockIdx.z == 0 && tid < G::BQ && q0 + tid < Sq)
      lse[(size_t)bh * Sq + q0 + tid] = NEG;
  } else {
    extern __shared__ float4 wide_smem[];
    float* sm = reinterpret_cast<float*>(wide_smem);
    float* spart = sm + G::SPART_OFF;    // [2 tiles][2 halves][BQ][SROW]
    float* ps = sm + G::P_OFF;           // [BK][PROW]: p, key-major
    float* alpha_s = sm + G::ROW_OFF;    // [BQ]
    float* l_s = alpha_s + G::BQ;        // [BQ]

    const int b = bh / H;
    const int bhk = b * HK + (bh % H) / (H / HK);
    const bool seg = q_ids != nullptr;
    const int kend = causal ? min(Sk, q0 + G::BQ) : Sk;
    const int ntile = (kend + G::BK - 1) / G::BK;
    const int nc = min(D / G::W, G::MAX_NC);   // the cluster's CTAs
    const int part = D / nc;             // S's columns this CTA sums
    const int cs0 = static_cast<int>(hopper::cluster_rank()) * part;
    const int nS = part / G::DC;         // S stages a tile
    const int ipt = nS + G::BK / G::VK;  // ring items a tile
    const int total = ntile * ipt;

    // the ring's item j: S stage i < nS (Q's and K's columns cs0 + DC*i..)
    // or V stage i - nS (keys VK*(i - nS).. of the tile, the slice's
    // columns)
    auto load = [&](int j) {
      const int t = j / ipt, i = j - t * ipt, k0 = t * G::BK;
      float* st = sm + (j % G::STAGES) * G::STAGE;
      if (i < nS) {
        // Q's BQ rows, then K's BK rows, DC/4 float4s each
        constexpr int R4 = G::DC / 4;
        const int c4 = 4 * (tid % R4), c = cs0 + G::DC * i + c4;
#pragma unroll
        for (int x = 0; x < G::BQ * R4 / G::THREADS; ++x) {
          const int r = tid / R4 + x * (G::THREADS / R4), row = q0 + r;
          hopper::cp_async16(
              st + r * G::PAD + c4,
              q + ((size_t)bh * Sq + (row < Sq ? row : 0)) * D + c, row < Sq);
        }
#pragma unroll
        for (int x = 0; x < G::BK * R4 / G::THREADS; ++x) {
          const int r = tid / R4 + x * (G::THREADS / R4), key = k0 + r;
          hopper::cp_async16(
              st + (G::BQ + r) * G::PAD + c4,
              k + ((size_t)bhk * Sk + (key < Sk ? key : 0)) * D + c, key < Sk);
        }
      } else {
#pragma unroll
        for (int x = 0; x < G::VK; ++x) {
          const int key = k0 + G::VK * (i - nS) + x;
          hopper::cp_async16(
              st + x * G::W + 4 * tid,
              v + ((size_t)bhk * Sk + (key < Sk ? key : 0)) * D + c0 + 4 * tid,
              key < Sk);
        }
      }
    };
#pragma unroll
    for (int j = 0; j < G::STAGES - 1; ++j) {
      if (j < total) load(j);
      hopper::cp_async_commit();
    }

    // S: half sh of the CTA, rows rg + 8a, keys kg + 16b
    const int sh = tid >> 7, rg = (tid >> 4) & 7, kg = tid & 15;
    // softmax: row sr, keys sp + 8j
    const int sr = tid >> 3, sp = tid & 7, srow = q0 + sr;
    const int qid = (seg && srow < Sq) ? q_ids[(size_t)b * Sq + srow] : 0;
    const uint32_t rkey =
        DROP ? dropout::row_key(dropout::head_key(*drop.seed, bh), srow) : 0u;
    float m = NEG, l = 0.f;
    // O: rows 8 og.., columns 512 oc + 4 lane + 128 c of the slice
    const int og = tid >> 6, oc = (tid >> 5) & 1, lane = tid & 31;
    const int ocol = 512 * oc + 4 * lane;

    float4 acc[8][4];
    float sacc[4][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) sacc[a][c] = 0.f;

    for (int j = 0, t = 0, i = 0; j < total; ++j) {
      hopper::cp_async_wait<G::STAGES - 2>();
      __syncthreads();   // item j landed; every thread is done with j - 1
      if (j + G::STAGES - 1 < total) load(j + G::STAGES - 1);
      hopper::cp_async_commit();
      const float* st = sm + (j % G::STAGES) * G::STAGE;
      const int k0 = t * G::BK;
      if (i < nS) {
        const float* qs = st;
        const float* ks = st + G::BQ * G::PAD;
#pragma unroll
        for (int f = 0; f < G::DC / 8; ++f) {
          const int c = 4 * ((G::DC / 8) * sh + f);
          float4 qv[4], kv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            qv[a] = *reinterpret_cast<const float4*>(qs + (rg + 8 * a) * G::PAD + c);
#pragma unroll
          for (int c2 = 0; c2 < 4; ++c2)
            kv[c2] = *reinterpret_cast<const float4*>(ks + (kg + 16 * c2) * G::PAD + c);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c2 = 0; c2 < 4; ++c2) sacc[a][c2] = dot4(qv[a], kv[c2], sacc[a][c2]);
        }
        if (i == nS - 1) {
          // the cluster's partial scores meet; the online softmax of the
          // tile
          float* sb = spart + (t & 1) * G::SPART;
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c2 = 0; c2 < 4; ++c2) {
              sb[(sh * G::BQ + rg + 8 * a) * G::SROW + kg + 16 * c2] = sacc[a][c2];
              sacc[a][c2] = 0.f;
            }
          if (nc > 1)
            hopper::cluster_sync();
          else
            __syncthreads();
          float s[8];
          unsigned vis = 0u;
          float mt = m;
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const int key = sp + 8 * x, col = k0 + key;
            const float* h0 = sb + sr * G::SROW + key;
            const float* h1 = sb + (G::BQ + sr) * G::SROW + key;
            // in rank order: rank 0's halves first
            float dot = nc == 1 ? *h0 + *h1
                                : hopper::ld_cluster(h0, 0) + hopper::ld_cluster(h1, 0);
            for (int r = 1; r < nc; ++r)
              dot += hopper::ld_cluster(h0, r) + hopper::ld_cluster(h1, r);
            const bool ok = col < Sk && (!causal || col <= srow) &&
                            (!seg || kv_ids[(size_t)b * Sk + col] == qid);
            s[x] = ok ? __fmul_rn(dot, scale) : NEG;
            vis |= (ok ? 1u : 0u) << x;
            mt = fmaxf(mt, s[x]);
          }
#pragma unroll
          for (int off = 1; off < 8; off <<= 1)
            mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
          const float alpha = expf(m - mt);
          float sum = 0.f;
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const int key = sp + 8 * x;
            const float p = ((vis >> x) & 1u) ? expf(s[x] - mt) : 0.f;
            sum += p;
            ps[key * G::PROW + sr] =
                DROP ? dropout::apply(drop, dropout::col_key(rkey, k0 + key), p)
                     : p;
          }
#pragma unroll
          for (int off = 1; off < 8; off <<= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          l = l * alpha + sum;
          m = mt;
          if (sp == 0) alpha_s[sr] = alpha;
        }
      } else {
        const int kk0 = G::VK * (i - nS);   // the stage's first key
        if (kk0 == 0) {
          // the tile's rescale of O (the barrier above ordered alpha)
          const float4 a0 = *reinterpret_cast<const float4*>(alpha_s + 8 * og);
          const float4 a1 = *reinterpret_cast<const float4*>(alpha_s + 8 * og + 4);
          const float al[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = scale4(acc[r][c], al[r]);
        }
#pragma unroll
        for (int x = 0; x < G::VK; ++x) {
          const float* pr = ps + (kk0 + x) * G::PROW + 8 * og;
          const float4 p0 = *reinterpret_cast<const float4*>(pr);
          const float4 p1 = *reinterpret_cast<const float4*>(pr + 4);
          const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
          float4 vv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            vv[c] = *reinterpret_cast<const float4*>(st + x * G::W + ocol + 128 * c);
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = axpy4(pv[r], vv[c], acc[r][c]);
        }
      }
      if (++i == ipt) {
        i = 0;
        ++t;
      }
    }
    hopper::cp_async_wait<0>();
    // the other CTAs of the cluster are done reading this one's scores
    if (nc > 1) hopper::cluster_sync();

    // epilogue: each row's l to shared memory, o = acc / l, slice 0 the lse
    if (sp == 0) {
      l_s[sr] = l;
      if (lse != nullptr && blockIdx.z == 0 && srow < Sq)
        lse[(size_t)bh * Sq + srow] = l > 0.f ? m + logf(l) : NEG;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = q0 + 8 * og + r;
      if (row >= Sq) continue;
      const float lr = l_s[8 * og + r];
      const float linv = lr > 0.f ? 1.f / lr : 0.f;
      const size_t base = (((size_t)bh * Sq + row) * D + c0 + ocol) / 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) store4(o, base + 32 * c, scale4(acc[r][c], linv));
    }
  }
}

template <typename T, bool DROP>
int launch_wide(const void* q, const void* k, const void* v, void* o,
                float* lse, const int* q_ids, const int* kv_ids, int B, int H,
                int HK, int Sq, int Sk, int D, int causal, float scale,
                const dropout::Params& drop, cudaStream_t stream) {
  using G = FwdWide;
  // bf16 with keys runs the wide tensor-core body
  if (!wide::takes(D) || (sizeof(T) == 2 && Sk > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = sizeof(T) == 2 ? 0 : G::SMEM;
  static const bool sized =
      hopper::allow_smem(flash_fwd_kernel_wide<T, DROP>, smem);
  if (!sized) return static_cast<int>(cudaErrorInvalidValue);
  // B*H on x (2^31 - 1), the q blocks on y, the column slices on z, a
  // cluster of min(D/1024, 8) slices
  return hopper::launch_clusters(
      flash_fwd_kernel_wide<T, DROP>,
      dim3(B * H, (Sq + G::BQ - 1) / G::BQ, D / G::W), G::THREADS, smem,
      min(D / G::W, G::MAX_NC), stream, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o),
      lse, q_ids, kv_ids, H, HK, Sq, Sk, D, causal, scale, drop);
}

// ---------------------------------------------------------------------------
// tensor-core body: bf16, D 64, 128 and 256 (wgmma + TMA; hopper_mma.cuh)
// ---------------------------------------------------------------------------

constexpr int TC_BK = 64;                       // keys per ring stage
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct FwdTc {
  static constexpr int NP = D / 64;             // 64-column panels
  static constexpr int BQ = 64;                 // query rows a CTA
  static constexpr int THREADS = 128;           // one warpgroup
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = TC_BK * D * 2;   // one K or V tile
  // K/V ring stages: two up to D 128; one at D 256, so that two CTAs
  // (96 KB of tiles each) share an SM and overlap each other's chains
  static constexpr int STAGES = D > 128 ? 1 : 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int KID_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = KID_OFF + 2 * TC_BK * 4;
  static constexpr int SMEM = BAR_OFF + 2 * 8 + 1024;   // + alignment slack
};

// One tile of scores in the accumulator fragment (s, base 2 after this):
// scale, mask where MASK, fold into the running max m and sum l (this
// thread's share of its two rows), return the rescale factors and leave
// the probabilities in s; under DROP, after l has summed them, keep * p /
// (1 - rate), each pair hashed from its row's key rkey (every tile).
template <bool MASK, bool DROP>
__device__ __forceinline__ void softmax_tile(
    float (&s)[32], float (&m)[2], float (&l)[2], float (&alpha)[2],
    float scale2, int k0, int r_lo, int lane, int Sk, int causal,
    const int* kid, int qid_lo, int qid_hi, const uint32_t (&rkey)[2],
    const dropout::Params& drop) {
  unsigned vis = 0xffffffffu;
  if (MASK) {
    vis = 0u;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const int row = r_lo + 8 * ((i >> 1) & 1);
      const int col = k0 + c;
      const bool ok = col < Sk && (!causal || col <= row) &&
                      (kid == nullptr ||
                       kid[c] == (((i >> 1) & 1) ? qid_hi : qid_lo));
      vis |= (ok ? 1u : 0u) << i;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = (!MASK || ((vis >> i) & 1u)) ? s[i] * scale2 : NEG;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alpha[h] = exp2f(m[h] - mx[h]);
    l[h] *= alpha[h];
    m[h] = mx[h];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    const float p = (!MASK || ((vis >> i) & 1u)) ? exp2f(s[i] - mx[h]) : 0.f;
    l[h] += p;
    const int col = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    s[i] = DROP ? dropout::apply(drop, dropout::col_key(rkey[h], col), p) : p;
  }
}

template <int D, bool DROP>
__global__ void __launch_bounds__(FwdTc<D>::THREADS)
flash_fwd_kernel_tc(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    const int* __restrict__ q_ids,
                    const int* __restrict__ kv_ids, int H, int HK, int Sq,
                    int Sk, int causal, float scale2, dropout::Params drop) {
  using G = FwdTc<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw +
                ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = sm;
  uint8_t* ks = sm + G::K_OFF;
  uint8_t* vs = sm + G::V_OFF;
  int* kid = reinterpret_cast<int*>(sm + G::KID_OFF);
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
  const int ntile = (kend + TC_BK - 1) / TC_BK;
  uint32_t rkey[2] = {0u, 0u};
  if (DROP) {
    const uint32_t head = dropout::head_key(*drop.seed, bh);
    rkey[0] = dropout::row_key(head, r_lo);
    rkey[1] = dropout::row_key(head, r_lo + 8);
  }

  if (tid == 0) {
    hopper::mbar_init(&bar[0], 1);
    hopper::mbar_init(&bar[1], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // two stages: Q and tile 0's K and V on bar[0]; one stage: bar[0]
  // counts the K tiles (Q with the first), bar[1] the V tiles
  uint64_t* vbar = &bar[G::STAGES == 1 ? 1 : 0];
  if (tid == 0) {
    hopper::mbar_expect_tx(&bar[0], G::Q_BYTES + G::STAGES * G::KV_BYTES);
    if (G::STAGES == 1) hopper::mbar_expect_tx(vbar, G::KV_BYTES);
#pragma unroll
    for (int p = 0; p < G::NP; ++p) {
      hopper::tma_load_3d(qs + p * G::BQ * 128, &map_q, &bar[0], 64 * p, q0,
                          bh);
      hopper::tma_load_3d(ks + p * TC_BK * 128, &map_k, &bar[0], 64 * p, 0,
                          bhk);
      hopper::tma_load_3d(vs + p * TC_BK * 128, &map_v, vbar, 64 * p, 0,
                          bhk);
    }
  }
  if (seg) {
    for (int j = tid; j < TC_BK; j += G::THREADS)
      kid[j] = j < Sk ? kv_ids[(size_t)b * Sk + j] : 0;
  }
  const int qid_lo = (seg && r_lo < Sq) ? q_ids[(size_t)b * Sq + r_lo] : 0;
  const int qid_hi =
      (seg && r_lo + 8 < Sq) ? q_ids[(size_t)b * Sq + r_lo + 8] : 0;

  float acc[G::NP][32];
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = 0.f;
#pragma unroll
    for (int p = 0; p < G::NP; ++p) acc[p][i] = 0.f;
  }
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  for (int t = 0; t < ntile; ++t) {
    const int k0 = t * TC_BK;
    const int st = t & 1;
    // every thread is done with tile t-1: with two stages its stage
    // takes tile t+1; with one, the V stage takes tile t
    __syncthreads();
    if (G::STAGES == 2 && t + 1 < ntile && tid == 0) {
      const int nst = st ^ 1;
      hopper::mbar_expect_tx(&bar[nst], 2 * G::KV_BYTES);
#pragma unroll
      for (int p = 0; p < G::NP; ++p) {
        hopper::tma_load_3d(ks + nst * G::KV_BYTES + p * TC_BK * 128,
                            &map_k, &bar[nst], 64 * p, k0 + TC_BK, bhk);
        hopper::tma_load_3d(vs + nst * G::KV_BYTES + p * TC_BK * 128,
                            &map_v, &bar[nst], 64 * p, k0 + TC_BK, bhk);
      }
    }
    if (G::STAGES == 1 && t > 0 && tid == 0) {
      hopper::mbar_expect_tx(vbar, G::KV_BYTES);
#pragma unroll
      for (int p = 0; p < G::NP; ++p)
        hopper::tma_load_3d(vs + p * TC_BK * 128, &map_v, vbar, 64 * p, k0,
                            bhk);
    }
    if (seg && t + 1 < ntile) {
      for (int j = tid; j < TC_BK; j += G::THREADS) {
        const int col = k0 + TC_BK + j;
        kid[(st ^ 1) * TC_BK + j] = col < Sk ? kv_ids[(size_t)b * Sk + col] : 0;
      }
    }
    if (G::STAGES == 2)
      hopper::mbar_wait(&bar[st], (t >> 1) & 1);
    else
      hopper::mbar_wait(&bar[0], t & 1);

    // S = Q . K^T
    const uint8_t* kt = ks + (G::STAGES == 2 ? st : 0) * G::KV_BYTES;
    const uint8_t* vt = vs + (G::STAGES == 2 ? st : 0) * G::KV_BYTES;
    hopper::fence_acc(s);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk / 4, off = (kk % 4) * 32;
      hopper::wgmma_ss_n64<0>(
          s, hopper::desc_sw128(qs + p * G::BQ * 128 + off, 16, 1024),
          hopper::desc_sw128(kt + p * TC_BK * 128 + off, 16, 1024), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_acc(s);
    if (G::STAGES == 1) {
      // every warp's products have read K: the stage takes tile t+1
      __syncthreads();
      if (t + 1 < ntile && tid == 0) {
        hopper::mbar_expect_tx(&bar[0], G::KV_BYTES);
#pragma unroll
        for (int p = 0; p < G::NP; ++p)
          hopper::tma_load_3d(ks + p * TC_BK * 128, &map_k, &bar[0], 64 * p,
                              k0 + TC_BK, bhk);
      }
    }

    float alpha[2];
    const bool need = seg || k0 + TC_BK > Sk ||
                      (causal && k0 + TC_BK - 1 > q0);
    if (need)
      softmax_tile<true, DROP>(s, m, l, alpha, scale2, k0, r_lo, lane, Sk,
                               causal, seg ? kid + st * TC_BK : nullptr,
                               qid_lo, qid_hi, rkey, drop);
    else
      softmax_tile<false, DROP>(s, m, l, alpha, scale2, k0, r_lo, lane, Sk,
                                causal, nullptr, 0, 0, rkey, drop);

    // O = O * alpha + P . V, P rounded to bf16 in registers
    uint32_t a[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[c][r] = hopper::pack_bf16(s[8 * c + 2 * r], s[8 * c + 2 * r + 1]);
#pragma unroll
    for (int p = 0; p < G::NP; ++p) {
      hopper::fence_acc(acc[p]);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] *= alpha[(i >> 1) & 1];
      hopper::fence_acc(acc[p]);
    }
    if (G::STAGES == 1) hopper::mbar_wait(vbar, t & 1);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int p = 0; p < G::NP; ++p)
        hopper::wgmma_rs_n64<1>(
            acc[p], a[c],
            hopper::desc_sw128(vt + p * TC_BK * 128 + c * 2048, TC_BK * 128,
                               1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < G::NP; ++p) hopper::fence_acc(acc[p]);
  }

  // epilogue: the row sums meet over the row's four lanes; o = acc / l
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const float linv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f,
                         l[1] > 0.f ? 1.f / l[1] : 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r_lo + 8 * h;
    if (row >= Sq) continue;
    uint32_t* orow =
        reinterpret_cast<uint32_t*>(o + ((size_t)bh * Sq + row) * D);
#pragma unroll
    for (int p = 0; p < G::NP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        orow[(64 * p + 8 * j + 2 * (lane & 3)) / 2] =
            hopper::pack_bf16(acc[p][4 * j + 2 * h] * linv[h],
                              acc[p][4 * j + 2 * h + 1] * linv[h]);
    if (lse != nullptr && (lane & 3) == 0)
      lse[(size_t)bh * Sq + row] =
          l[h] > 0.f ? (m[h] + log2f(l[h])) * LN2 : NEG;
  }
}

template <int D, bool DROP>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, const int* q_ids, const int* kv_ids, int B, int H,
              int HK, int Sq, int Sk, int causal, float scale,
              const dropout::Params& drop, cudaStream_t stream) {
  using G = FwdTc<D>;
  CUtensorMap mq, mk, mv;
  int rc = hopper::make_map_bf16(&mq, q, D, Sq, B * H, G::BQ);
  if (rc == 0) rc = hopper::make_map_bf16(&mk, k, D, Sk, B * HK, TC_BK);
  if (rc == 0) rc = hopper::make_map_bf16(&mv, v, D, Sk, B * HK, TC_BK);
  if (rc != 0) return rc;
  rc = static_cast<int>(cudaFuncSetAttribute(
      flash_fwd_kernel_tc<D, DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM));
  if (rc != 0) return rc;
  const dim3 grid(B * H, (Sq + G::BQ - 1) / G::BQ);
  flash_fwd_kernel_tc<D, DROP><<<grid, G::THREADS, G::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, q_ids, kv_ids, H, HK,
      Sq, Sk, causal, scale * LOG2E, drop);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// wide tensor-core body: bf16 at D 512 and D >= 1024 (wide::tc_takes;
// wgmma + TMA; hopper_mma.cuh)
// ---------------------------------------------------------------------------
//
// A 64-row O accumulator at D 1024 is 64 x 1024 f32, 256 KB: an SM's
// whole register file and more than its shared memory.  So a CTA (one
// warpgroup) owns a slice of SLICE = 256 of O's columns for 64 query
// rows (blockIdx.z counts the D/256 slices): the D-256 forward's 128
// accumulator registers a thread.  Each slice needs P, so each computes
// the whole of S = Q.K^T: the 64-column panels of Q and of the key tile
// flow through a ring of STAGES stages by TMA (a Q panel and a K panel a
// stage, one mbarrier each; Q is read again from L2 for every key tile),
// one wgmma m64n64k16 per 16 columns of D.  One counter runs over every
// (key tile, panel) load of the ring, so stage g % STAGES waits on the
// phase (g / STAGES) & 1; a stage is loaded again once every thread has
// waited for the products that read it (wgmma_wait<1>, one barrier).
// The slice's V tile (64 keys x 256 columns, 32 KB) loads beside S's
// panels and meets P in O += P.V, P rounded to bf16 in registers.  The
// softmax is the D-64/128/256 body's (softmax_tile): every slice
// computes the same S from the same products in the same order, so each
// gets the same m, l and P, bit for bit, the dropout mask included;
// slice 0 writes the lse.  96 KB of tiles: two CTAs share an SM.
//
// What bounds it: at (8, 2, 512, 1024) bf16 causal a call does 8.6
// GFLOP of attention over 67.1 MB (8.7 us at 989 TFLOP/s against 20.0 us
// at 3.35 TB/s: bytes on paper), but the slices repeat S: (D/256)·2D +
// 2D tensor-core FLOP a pair where the function needs 4D, 2.5x at D 1024
// and 16.5x at D 8192, and each CTA reads its Q block and every key tile
// it sees from L2 once a key tile.  On an H100 at 700 W that shape takes
// 0.1169 ms (184 TFLOP/s executed, 74 useful; SDPA's forward 0.1334),
// where the wide CUDA-core body took 1.1546.  Sharing P across the
// slices (a CTA of several warpgroups, or a cluster over distributed
// shared memory) would remove the repetition.

struct FwdTcWide {
  static constexpr int BQ = 64;                 // query rows a CTA
  static constexpr int THREADS = 128;           // one warpgroup
  static constexpr int SLICE = 256;             // O (and V) columns a CTA
  static constexpr int SNP = SLICE / 64;        // their 64-column panels
  static constexpr int STAGES = 4;              // Q/K panel ring
  static constexpr int PANEL = 64 * 128;        // 64 rows of 64 bf16: 8 KB
  static constexpr int STAGE_BYTES = 2 * PANEL; // a Q and a K panel
  static constexpr int V_OFF = STAGES * STAGE_BYTES;
  static constexpr int V_BYTES = SNP * PANEL;   // the slice's V tile
  static constexpr int KID_OFF = V_OFF + V_BYTES;
  static constexpr int BAR_OFF = KID_OFF + TC_BK * 4;
  static constexpr int SMEM = BAR_OFF + (STAGES + 1) * 8 + 1024;   // + slack
};

template <bool DROP>
__global__ void __launch_bounds__(FwdTcWide::THREADS)
flash_fwd_kernel_tc_wide(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse,
                         const int* __restrict__ q_ids,
                         const int* __restrict__ kv_ids, int H, int HK,
                         int Sq, int Sk, int D, int causal, float scale2,
                         dropout::Params drop) {
  using G = FwdTcWide;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw +
                ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* vs = sm + G::V_OFF;
  int* kid = reinterpret_cast<int*>(sm + G::KID_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + G::BAR_OFF);  // ring
  uint64_t* vbar = full + G::STAGES;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int bhk = b * HK + (bh % H) / (H / HK);
  // heaviest first: under the causal mask the last q block sees most keys
  const int q0 = (gridDim.y - 1 - blockIdx.y) * G::BQ;
  const int c0 = blockIdx.z * G::SLICE;   // this CTA's columns of O and V
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r_lo = q0 + 16 * (tid >> 5) + (lane >> 2);   // and r_lo + 8
  const bool seg = q_ids != nullptr;
  const int kend = causal ? min(Sk, q0 + G::BQ) : Sk;
  const int ntile = (kend + TC_BK - 1) / TC_BK;
  const int npan = D / 64;               // S's panels a key tile
  const int nload = ntile * npan;        // the ring's loads
  uint32_t rkey[2] = {0u, 0u};
  if (DROP) {
    const uint32_t head = dropout::head_key(*drop.seed, bh);
    rkey[0] = dropout::row_key(head, r_lo);
    rkey[1] = dropout::row_key(head, r_lo + 8);
  }

  if (tid == 0) {
    for (int i = 0; i <= G::STAGES; ++i) hopper::mbar_init(&full[i], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // the ring's load j: panel j % npan of Q and of key tile j / npan
  auto load = [&](int j) {
    const int st = j % G::STAGES, p = j % npan;
    uint8_t* dst = sm + st * G::STAGE_BYTES;
    hopper::mbar_expect_tx(&full[st], G::STAGE_BYTES);
    hopper::tma_load_3d(dst, &map_q, &full[st], 64 * p, q0, bh);
    hopper::tma_load_3d(dst + G::PANEL, &map_k, &full[st], 64 * p,
                        (j / npan) * TC_BK, bhk);
  };
  if (tid == 0) {
    for (int j = 0; j < G::STAGES && j < nload; ++j) load(j);
  }
  const int qid_lo = (seg && r_lo < Sq) ? q_ids[(size_t)b * Sq + r_lo] : 0;
  const int qid_hi =
      (seg && r_lo + 8 < Sq) ? q_ids[(size_t)b * Sq + r_lo + 8] : 0;

  float acc[G::SNP][32];
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = 0.f;
#pragma unroll
    for (int p = 0; p < G::SNP; ++p) acc[p][i] = 0.f;
  }
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  int g = 0;                             // the ring's next load to consume
  for (int t = 0; t < ntile; ++t) {
    const int k0 = t * TC_BK;
    // every thread is done with tile t-1's V and key ids: they take tile t
    __syncthreads();
    if (tid == 0) {
      hopper::mbar_expect_tx(vbar, G::V_BYTES);
#pragma unroll
      for (int p = 0; p < G::SNP; ++p)
        hopper::tma_load_3d(vs + p * G::PANEL, &map_v, vbar, c0 + 64 * p, k0,
                            bhk);
    }
    if (seg) {
      for (int j = tid; j < TC_BK; j += G::THREADS)
        kid[j] = k0 + j < Sk ? kv_ids[(size_t)b * Sk + k0 + j] : 0;
    }

    // S = Q . K^T over the whole D, a 64-column panel a ring stage
    hopper::fence_acc(s);
    for (int p = 0; p < npan; ++p, ++g) {
      const int st = g % G::STAGES;
      hopper::mbar_wait(&full[st], (g / G::STAGES) & 1);
      const uint8_t* qp = sm + st * G::STAGE_BYTES;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_ss_n64<0>(
            s, hopper::desc_sw128(qp + kk * 32, 16, 1024),
            hopper::desc_sw128(qp + G::PANEL + kk * 32, 16, 1024),
            p > 0 || kk > 0);
      hopper::wgmma_commit();
      if (p > 0) {
        // the previous panel's products are done in every warp: its
        // stage takes the ring's load g - 1 + STAGES
        hopper::wgmma_wait<1>();
        __syncthreads();
        if (tid == 0 && g - 1 + G::STAGES < nload) load(g - 1 + G::STAGES);
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_acc(s);
    __syncthreads();
    if (tid == 0 && g - 1 + G::STAGES < nload) load(g - 1 + G::STAGES);

    float alpha[2];
    const bool need = seg || k0 + TC_BK > Sk ||
                      (causal && k0 + TC_BK - 1 > q0);
    if (need)
      softmax_tile<true, DROP>(s, m, l, alpha, scale2, k0, r_lo, lane, Sk,
                               causal, seg ? kid : nullptr, qid_lo, qid_hi,
                               rkey, drop);
    else
      softmax_tile<false, DROP>(s, m, l, alpha, scale2, k0, r_lo, lane, Sk,
                                causal, nullptr, 0, 0, rkey, drop);

    // O_slice = O_slice * alpha + P . V_slice, P rounded to bf16 in
    // registers
    uint32_t a[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[c][r] = hopper::pack_bf16(s[8 * c + 2 * r], s[8 * c + 2 * r + 1]);
#pragma unroll
    for (int p = 0; p < G::SNP; ++p) {
      hopper::fence_acc(acc[p]);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] *= alpha[(i >> 1) & 1];
      hopper::fence_acc(acc[p]);
    }
    hopper::mbar_wait(vbar, t & 1);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int p = 0; p < G::SNP; ++p)
        hopper::wgmma_rs_n64<1>(
            acc[p], a[c],
            hopper::desc_sw128(vs + p * G::PANEL + c * 2048, G::PANEL, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < G::SNP; ++p) hopper::fence_acc(acc[p]);
  }

  // epilogue: the row sums meet over the row's four lanes; the slice of
  // o = acc / l
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const float linv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f,
                         l[1] > 0.f ? 1.f / l[1] : 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r_lo + 8 * h;
    if (row >= Sq) continue;
    uint32_t* orow =
        reinterpret_cast<uint32_t*>(o + ((size_t)bh * Sq + row) * D + c0);
#pragma unroll
    for (int p = 0; p < G::SNP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        orow[(64 * p + 8 * j + 2 * (lane & 3)) / 2] =
            hopper::pack_bf16(acc[p][4 * j + 2 * h] * linv[h],
                              acc[p][4 * j + 2 * h + 1] * linv[h]);
    if (lse != nullptr && blockIdx.z == 0 && (lane & 3) == 0)
      lse[(size_t)bh * Sq + row] =
          l[h] > 0.f ? (m[h] + log2f(l[h])) * LN2 : NEG;
  }
}

template <bool DROP>
int launch_tc_wide(const void* q, const void* k, const void* v, void* o,
                   float* lse, const int* q_ids, const int* kv_ids, int B,
                   int H, int HK, int Sq, int Sk, int D, int causal,
                   float scale, const dropout::Params& drop,
                   cudaStream_t stream) {
  using G = FwdTcWide;
  if (!wide::tc_takes(D)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  int rc = hopper::make_map_bf16(&mq, q, D, Sq, B * H, G::BQ);
  if (rc == 0) rc = hopper::make_map_bf16(&mk, k, D, Sk, B * HK, TC_BK);
  if (rc == 0) rc = hopper::make_map_bf16(&mv, v, D, Sk, B * HK, TC_BK);
  if (rc != 0) return rc;
  rc = static_cast<int>(cudaFuncSetAttribute(
      flash_fwd_kernel_tc_wide<DROP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM));
  if (rc != 0) return rc;
  // B*H on x (2^31 - 1), the q blocks on y, the column slices on z
  const dim3 grid(B * H, (Sq + G::BQ - 1) / G::BQ, D / G::SLICE);
  flash_fwd_kernel_tc_wide<DROP><<<grid, G::THREADS, G::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, q_ids, kv_ids, H, HK,
      Sq, Sk, D, causal, scale * LOG2E, drop);
  return static_cast<int>(cudaGetLastError());
}

// The route: bf16 with keys to read takes the tensor cores, at D 64, 128
// and 256 and (the wide tensor-core body) at D 512 and every wide width,
// D >= 1024 (wide::tc_takes); the rest of the wide widths (f32, and bf16
// with no keys) the wide CUDA-core body, everything else (f32 up to 512,
// bf16 at 16 and 32 or with no keys) the CUDA-core bodies of their width;
// a seed takes each body's DROP instantiation.
template <typename T, bool DROP>
int route(const void* q, const void* k, const void* v, void* o, float* lse,
             const int* qi, const int* ki, int B, int H, int HK, int Sq,
             int Sk, int D, int causal, float scale,
             const dropout::Params& dr, cudaStream_t st) {
  if (sizeof(T) == 2 && Sk > 0) {
    if (D == 64)
      return launch_tc<64, DROP>(q, k, v, o, lse, qi, ki, B, H, HK, Sq, Sk, causal, scale, dr, st);
    if (D == 128)
      return launch_tc<128, DROP>(q, k, v, o, lse, qi, ki, B, H, HK, Sq, Sk, causal, scale, dr, st);
    if (D == 256)
      return launch_tc<256, DROP>(q, k, v, o, lse, qi, ki, B, H, HK, Sq, Sk, causal, scale, dr, st);
    if (wide::tc_takes(D))
      return launch_tc_wide<DROP>(q, k, v, o, lse, qi, ki, B, H, HK, Sq, Sk, D, causal, scale, dr, st);
  }
  if (D >= wide::MIN_D)
    return launch_wide<T, DROP>(q, k, v, o, lse, qi, ki, B, H, HK, Sq, Sk, D, causal, scale, dr, st);
  switch (D) {
    case 16: launch<T, 16, DROP>(q, k, v, o, lse, qi, ki, B, H, HK, Sq, Sk, causal, scale, dr, st); break;
    case 32: launch<T, 32, DROP>(q, k, v, o, lse, qi, ki, B, H, HK, Sq, Sk, causal, scale, dr, st); break;
    case 64: launch<T, 64, DROP>(q, k, v, o, lse, qi, ki, B, H, HK, Sq, Sk, causal, scale, dr, st); break;
    case 128: launch<T, 128, DROP>(q, k, v, o, lse, qi, ki, B, H, HK, Sq, Sk, causal, scale, dr, st); break;
    case 256: launch<T, 256, DROP>(q, k, v, o, lse, qi, ki, B, H, HK, Sq, Sk, causal, scale, dr, st); break;
    case 512: launch<T, 512, DROP>(q, k, v, o, lse, qi, ki, B, H, HK, Sq, Sk, causal, scale, dr, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             const int* qi, const int* ki, int B, int H, int HK, int Sq,
             int Sk, int D, int causal, float scale,
             const dropout::Params& dr, cudaStream_t st) {
  if (dr.seed != nullptr)
    return route<T, true>(q, k, v, o, lse, qi, ki, B, H, HK, Sq, Sk, D, causal, scale, dr, st);
  return route<T, false>(q, k, v, o, lse, qi, ki, B, H, HK, Sq, Sk, D, causal, scale, dr, st);
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype: 0 float32, 1
// bfloat16 (q, k, v and o alike).  lse may be null (no logsumexp
// output); q_ids/kv_ids are both null or both set.  seed: null (no
// dropout) or one int32 on the device, with keep_below the unsigned
// hash threshold and keep_scale 1 / (1 - rate).  Launches on `stream`,
// allocates nothing, and returns cudaGetLastError() after the launch (0
// when it was accepted).
extern "C" int apex_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, const void* q_ids,
                              const void* kv_ids, int dtype, int B, int H,
                              int HK, int Sq, int Sk, int D, int causal,
                              float scale, const void* seed,
                              unsigned keep_below, float keep_scale,
                              void* stream) {
  float* lf = static_cast<float*>(lse);
  const int* qi = static_cast<const int*>(q_ids);
  const int* ki = static_cast<const int*>(kv_ids);
  const dropout::Params dr{static_cast<const int*>(seed), keep_below,
                           keep_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      return dispatch<float>(q, k, v, o, lf, qi, ki, B, H, HK, Sq, Sk, D, causal, scale, dr, st);
    case BF16:
      return dispatch<__nv_bfloat16>(q, k, v, o, lf, qi, ki, B, H, HK, Sq, Sk, D, causal, scale, dr, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Host microseconds one TMA tensor map costs to encode (the tensor-core
// forward encodes three a call, the dk/dv kernel four): the mean over
// `reps` encodings of a GPT-2 small k map, (96, 512, 64) bf16, at
// `base`, a device buffer of at least that size.  Negative on failure.
extern "C" double apex_flash_map_encode_us(const void* base, int reps) {
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) {
    CUtensorMap map;
    if (hopper::make_map_bf16(&map, base, 64, 512, 96, TC_BK) != 0)
      return -1.0;
  }
  const std::chrono::duration<double, std::micro> dt =
      std::chrono::steady_clock::now() - t0;
  return dt.count() / (reps > 0 ? reps : 1);
}
