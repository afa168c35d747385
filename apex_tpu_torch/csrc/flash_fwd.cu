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
//   and the Gemma-class heads of 129..256, padded to 256), and at D 16
//   and 32 (the BERT example's default proxy, 4 heads of 32, and the
//   heads of 9..31, padded to them) at the head's own width.
// - CUDA cores, flash_fwd_kernel: f32 with no keys (Sk == 0) up to D
//   128, and bf16 with no keys up to D 512.
// - wide tensor cores, flash_fwd_kernel_tc_wide: bf16 at D 512 (and the
//   heads of 257..511, padded to it) and D >= 1024 (the powers of two to
//   8192, then the multiples of 8192: the wrapper pads every wider head
//   to one; wide::tc_takes), D a runtime width; a CTA owns 256 of O's
//   columns and computes S over the whole D (below, before the route).
// - wide CUDA cores, flash_fwd_kernel_wide: f32 at D 64 and 128 with keys
//   (the serving path's GPT-2 heads and Llama-class ones, and the heads
//   of 33..127, padded to them), at D 16 and 32 with keys (the BERT
//   example's proxy at --opt-level O0, and the heads of 9..31), at D 256
//   and 512 (and the heads of 129..511) and at D >= 1024 (and bf16 there
//   with no keys), with D a runtime width: register tiles of S and O on
//   the CUDA cores (the precision contract of docs/kernels.md makes f32
//   operands true f32, so no TF32), a CTA on 64 query rows and all of O's
//   columns from 16 to 512, on 32 rows and 1024 of them from 1024.
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
// At D 16 and 32 a row of the head is 32 or 64 bytes, narrower than the
// 128-byte swizzle's rows, and padding the head to 64 would move 2-4
// times the bytes.  So FwdTc<16/32> is one panel as wide as the head: the
// Q, K and V tiles come by TMA in boxes of D columns with the 32- or
// 64-byte swizzle (hopper::swizzle_of), the descriptors take that
// swizzle's layout type (8 rows of 2D bytes between 8-row groups; one or
// two k16 steps of 32 bytes in Q.K^T), and O += P.V is m64nDk16 (8 or 16
// f32 registers a thread).  What bounds it: a causal (8, 12, 512, 32)
// call does 1.6 GFLOP over 12.8 MB, 1.6 us at 989 TFLOP/s against 3.8 us
// at 3.35 TB/s; the products shrink with D but the softmax on S does not,
// so each CTA's chain is the softmax's.  The design keeps 64-key tiles
// and two ring stages: the tiles are 2-4 KB and a CTA takes 77-102
// registers, so several CTAs share an SM and hide each other's chains.
// On an H100 at 700 W (apex_tpu_torch/tools/flash_narrow_tc.py, in
// turns) one CTA an SM took twice as long; 128-key tiles (124-128
// registers) took 18-25% longer causal, where the diagonal tile's masked
// half and fewer CTAs an SM cost more than the halved tile count saves,
// and 13% less on the BERT proxy's unmasked (8, 4, 512, 32).
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
// the q blocks its y, heaviest first.  f32 with keys runs the
// register-tile body (below) at every width; the f32 instantiations here
// stay for calls with no keys and for apex_flash_fwd_cuda_cores, which
// times them beside it.
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

// N consecutive floats of shared memory into x, in the widest vectors N
// divides (p aligned to them: 16 bytes from N 4, 8 at N 2)
template <int N>
__device__ __forceinline__ void ld_rows(float (&x)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      x[4 * i] = f.x;
      x[4 * i + 1] = f.y;
      x[4 * i + 2] = f.z;
      x[4 * i + 3] = f.w;
    }
  } else if constexpr (N == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x;
    x[1] = f.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p[i];
  }
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
// register-tile body: f32 at D 16, 32, 64 and 128 (wide::narrow_takes)
// and 256 and 512 (wide::row_takes), where one
// CTA spans a row of O, and at D >=
// 1024 (wide::takes: a cluster of column slices), and bf16 at D >= 1024
// with no keys (bf16 with keys takes the tensor cores)
// ---------------------------------------------------------------------------
//
// Register tiles on the CUDA cores, f32 FMAs (no TF32: the precision
// contract of docs/kernels.md).  A CTA of 256 threads (128 at W 16 and
// 32, below) owns BQ query rows and W of O's columns (blockIdx.z counts
// the D/W column slices): from D
// 1024 BQ = 32 and W = 1024, from 64 to 512 BQ = 64 and W = D.  O's BQ x
// W f32 sit in registers, each thread OR = 8 rows x 4C columns (C = BQ W
// / 8192 float4s a row: 128 registers at 1024 and 512, 64 at 256, 32 at
// 128) and at W 64 OR = 4 rows x 4 columns (a half-warp on a row).  From D
// 1024 the slices of a q block form a thread-block cluster of NC =
// min(D/1024, 8) CTAs (on the grid's z), and CTA r of the cluster
// computes S's partial dot products over the D/NC columns [r D/NC, (r+1)
// D/NC); at 256 and 512 the one CTA of a q block computes S whole (NC =
// 1: no cluster barrier, no remote read).  Each key tile of BK = 64 keys
// takes two passes over one ring of cp.async stages in shared memory:
//
// - the partial S = Q.K^T over the CTA's D/NC columns, DC = 64 columns of
//   Q's BQ rows and K's 64 keys a stage.  A thread owns a 4 x 4 block of
//   S (rows rg + (BQ/4) a, keys kg + 16 b) over a part of each stage's
//   columns (at 32 rows two halves of the CTA split them; at 64 one
//   thread takes all 64), so every float4 it reads from shared memory
//   feeds four of its FMAs.  The parts go to shared memory (two buffers,
//   a tile's and the last one's), one barrier (a cluster barrier when NC
//   > 1), and each score is the sum over the cluster's CTAs, in rank
//   order, of its parts in order (read through distributed shared memory
//   when NC > 1): every CTA of the cluster gets the same scores, bit for
//   bit.  (At 64 and 128 one buffer of parts, above it two.)
// - the online softmax: 256/BQ threads a row (8 or 4), 64/(256/BQ) keys
//   each, the row's max and sum over their shuffles; P (after the
//   dropout keep, as the reference applies it) and the rescale factor go
//   to shared memory.
// - O += P.V over the slice's V columns, VK = 8192/W keys a stage (8, 16,
//   32 and 64; the tile's 64 at W 64): each thread reads its OR rows' p (a
//   broadcast) and its 4C columns of each key row (float4s that a warp
//   reads contiguously), every V word feeding OR FMAs and every p word 4C.
//
// One counter runs over every ring item ((D/NC)/64 S stages and 64/VK V
// stages a tile, 32 KB a stage (34 KB at 64 rows, for an S stage), five
// stages; two at 64 and 128, whose tile is three items (two at 64), so
// that two CTAs of 104 KB share an SM and each runs while the other
// waits on its barriers: 15% and 4% faster at 64 and 128 on an H100 than
// five stages and one CTA); a stage is loaded STAGES - 1 items ahead of
// its use, once the barrier that opens an item shows every thread done
// with the stage's last use.  Rows past Sq and keys past Sk arrive as
// zeros (cp.async's source size 0).  (Stages of 32 columns and 4 keys,
// twice the barriers, were slower on an H100; the rows a CTA at D 256
// and 512: PERF.md, Findings.)  So the slices share S, and no FLOP
// repeats up to D 8192 (4D
// a pair); past it (F7) each cluster of 8 computes the whole of S (D/8192
// clusters: (D/8192)·2D + 2D a pair), the same partials in the same
// order, so every slice gets the same m, l and p, bit for bit, the
// dropout keep included, and slice 0 writes the lse.  A cluster's CTAs
// see the same keys, so they meet at the same barriers; a last one keeps
// each CTA's shared memory alive until the others have read it.
// Heaviest q blocks first, the key loop's stop at the CTA's last visible
// key, and no atomics (every sum in a fixed order: the same bits every
// run), as in the other bodies.  bf16 reaches this body only with no keys
// (Sk == 0): its instantiation (W 1024) writes the zero rows and the
// -1e30 lse.
//
// At W 32 and 16 (f32 D 32 and 16 with keys, wide::narrow_takes; the
// CUDA-core body lost to SDPA's f32 forward at D 32) the same two passes
// run with a stage of S as wide as the head (DC =
// W) and 128 threads: a thread owns a 4 x 8 block of S (rows rg + 16 a,
// keys kg + 8 b), two threads a row in the softmax (32 keys each), and 4
// x 4 (at 16, 2 x 4) of O's 64 x W.  A causal (8, 12, 512, 32) call does
// 1.6 GFLOP, 24.1 us at the card's 67 TFLOP/s of f32 FMAs against 7.6
// us for its 25.4 MB: bound by the FMAs.  Two stages and 73 KB (W 32) a
// CTA, so three CTAs share an SM (168 registers at W 32, no spills).  On
// an H100 at 700 W (apex_tpu_torch/tools/flash_wide_f32.py, in turns)
// that shape took 0.0784-0.0801 ms, against 0.1440-0.1453 on the
// CUDA-core body and 0.0902-0.0904 with 256 threads (4 x 4 blocks of S,
// 2 rows of O: 80 registers and 52 bytes of spill under three CTAs an
// SM); at D 16 0.0514-0.0520, against 0.0895 and 0.0697.

template <int W_>
struct FwdWide {
  static constexpr int W = W_;                  // O's columns a CTA
  // 256 threads; 128 at W 16 and 32, where a thread's 4 x 8 block of S
  // reads a float4 of shared memory for every 10.7 FMAs (a 4 x 4 block:
  // 8) and, at W 32, each V row it reads feeds 4 rows of O (2 at 256)
  static constexpr int THREADS = W < 64 ? 128 : 256;
  // query rows a CTA: 32 over a cluster's 1024-column slices; 64 where
  // one CTA spans the row (a K and V tile read once for twice the rows:
  // 17% and 13% faster than 32 at D 256 and 512 on an H100)
  static constexpr int BQ = W >= wide::MIN_D ? 32 : 64;
  static constexpr int BK = 64;                 // keys a tile
  static constexpr int DC = W < 64 ? W : 64;    // S's columns a stage
  static constexpr int PAD = DC + 4;            // a staged row's floats
  static constexpr int KS = 64 / BQ;            // S: parts of a stage's columns
  static constexpr int RS = BQ / 4;             // S: rows rg + RS a
  // S: a thread's keys kg + KG b (b < SB): 4 x 4 blocks at 256 threads,
  // 4 x 8 at 128
  static constexpr int SB = BK * RS * KS / THREADS;
  static constexpr int KG = BK / SB;
  static constexpr int TPR = THREADS / BQ;      // softmax: threads a row
  static constexpr int NX = BK / TPR;           // softmax: keys a thread
  // O: a thread's float4s a row (C = BQ W / 8192, 1 at W 128 and below)
  // and rows (8, 4 at W 64 and 32, 2 at W 16)
  static constexpr int C = BQ * W >= 8192 ? BQ * W / 8192 : 1;
  static constexpr int OR = BQ * W / (4 * THREADS * C);
  static constexpr int CG = W / (4 * C);        // O: threads a row group
  // V's keys a stage (32 KB; the tile's 64 at W 64, 16 KB)
  static constexpr int VK = W >= 128 ? 8192 / W : BK;
  static constexpr int STAGE = (BQ + BK) * PAD > VK * W ? (BQ + BK) * PAD
                                                        : VK * W;
  // the narrow widths (64 and 128): a tile's few items fit a short ring,
  // and two CTAs share an SM
  static constexpr bool NARROW = W < 256;
  static constexpr int STAGES = NARROW ? 2 : 5;
  static constexpr int MAX_NC = 8;              // a cluster's CTAs (portable)
  // from 1024 the slices of a q block share S over a cluster; from 512
  // down one CTA spans the row
  static constexpr bool CLUSTER = W >= wide::MIN_D;
  static constexpr int SROW = BK + 8;           // partial S row (floats)
  static constexpr int PROW = BQ + 4;           // P's key row (floats)
  static constexpr int SPART_OFF = STAGES * STAGE;
  static constexpr int SPART = KS * BQ * SROW;  // a tile's parts
  // buffers of parts: a tile's and the last one's, which a cluster's
  // other CTAs may still read; one at the narrow widths, where the
  // barrier that opens the tile's V stage orders the reads before the next
  // tile's writes (256 and 512 keep two: one CTA an SM either way)
  static constexpr int NBUF = NARROW ? 1 : 2;
  static constexpr int P_OFF = SPART_OFF + NBUF * SPART;
  static constexpr int ROW_OFF = P_OFF + BK * PROW;   // alpha, then l
  static constexpr int SMEM = (ROW_OFF + 2 * BQ) * 4;
  // CTAs an SM its shared memory allows (the register budget follows)
  static constexpr int CTAS = 228 * 1024 / (SMEM + 1024);
  static_assert(KS * RS * KG == THREADS && NX <= 32,
                "the S tiles cover the CTA; a thread's keys fit its mask");
  static_assert(BQ * DC / 4 % THREADS == 0,
                "every thread copies the same number of Q's float4s");
  static_assert(CG % 32 == 0 || 32 % CG == 0,
                "a warp's O columns are contiguous, or it spans whole rows");
  static_assert(BQ / OR * CG == THREADS, "O's tiles cover the CTA");
  static_assert(BK % VK == 0, "V's stages cover a tile");
  static_assert(SMEM <= 227 * 1024, "one CTA an SM");
};

template <typename T, int W, bool DROP>
__global__ void __launch_bounds__(FwdWide<W>::THREADS, FwdWide<W>::CTAS)
flash_fwd_kernel_wide(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, const int* __restrict__ q_ids,
                      const int* __restrict__ kv_ids, int H, int HK, int Sq,
                      int Sk, int D, int causal, float scale,
                      dropout::Params drop) {
  using G = FwdWide<W>;
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
    float* spart = sm + G::SPART_OFF;    // [2 tiles][KS parts][BQ][SROW]
    float* ps = sm + G::P_OFF;           // [BK][PROW]: p, key-major
    float* alpha_s = sm + G::ROW_OFF;    // [BQ]
    float* l_s = alpha_s + G::BQ;        // [BQ]

    const int b = bh / H;
    const int bhk = b * HK + (bh % H) / (H / HK);
    const bool seg = q_ids != nullptr;
    const int kend = causal ? min(Sk, q0 + G::BQ) : Sk;
    const int ntile = (kend + G::BK - 1) / G::BK;
    // the cluster's CTAs
    const int nc = G::CLUSTER ? min(D / G::W, G::MAX_NC) : 1;
    const int part = D / nc;             // S's columns this CTA sums
    const int cs0 =
        G::CLUSTER ? static_cast<int>(hopper::cluster_rank()) * part : 0;
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
        // V's VK key rows of W columns, RPX rows a round of copies
        constexpr int R4 = G::W / 4, RPX = G::THREADS / R4;
        const int vr = tid / R4, vc = 4 * (tid % R4);
#pragma unroll
        for (int x = 0; x < G::VK / RPX; ++x) {
          const int r = vr + RPX * x, key = k0 + G::VK * (i - nS) + r;
          hopper::cp_async16(
              st + r * G::W + vc,
              v + ((size_t)bhk * Sk + (key < Sk ? key : 0)) * D + c0 + vc,
              key < Sk);
        }
      }
    };
#pragma unroll
    for (int j = 0; j < G::STAGES - 1; ++j) {
      if (j < total) load(j);
      hopper::cp_async_commit();
    }

    // S: part sh of the stage's columns, rows rg + RS a, keys kg + KG b
    const int sh = tid / (G::RS * G::KG), rg = (tid / G::KG) % G::RS,
              kg = tid % G::KG;
    // softmax: row sr, keys sp + TPR x
    const int sr = tid / G::TPR, sp = tid % G::TPR, srow = q0 + sr;
    const int qid = (seg && srow < Sq) ? q_ids[(size_t)b * Sq + srow] : 0;
    const uint32_t rkey =
        DROP ? dropout::row_key(dropout::head_key(*drop.seed, bh), srow) : 0u;
    float m = NEG, l = 0.f;
    // O: rows OR og.., columns ocol + 128 c of the slice (a warp's 32
    // lanes on 128 contiguous columns; at W 64 a half-warp on a row's 64)
    const int og = tid / G::CG;
    const int ocol = 128 * G::C * ((tid % G::CG) / 32) + 4 * (tid % G::CG % 32);

    float4 acc[G::OR][G::C];
    float sacc[4][G::SB];
#pragma unroll
    for (int r = 0; r < G::OR; ++r)
#pragma unroll
      for (int c = 0; c < G::C; ++c) acc[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < G::SB; ++c) sacc[a][c] = 0.f;

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
        constexpr int NF = G::DC / 4 / G::KS;   // a part's float4 columns
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const int c = 4 * (NF * sh + f);
          float4 qv[4], kv[G::SB];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            qv[a] = *reinterpret_cast<const float4*>(qs + (rg + G::RS * a) * G::PAD + c);
#pragma unroll
          for (int c2 = 0; c2 < G::SB; ++c2)
            kv[c2] = *reinterpret_cast<const float4*>(ks + (kg + G::KG * c2) * G::PAD + c);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c2 = 0; c2 < G::SB; ++c2) sacc[a][c2] = dot4(qv[a], kv[c2], sacc[a][c2]);
        }
        if (i == nS - 1) {
          // the cluster's partial scores meet; the online softmax of the
          // tile
          float* sb = spart + (t % G::NBUF) * G::SPART;
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c2 = 0; c2 < G::SB; ++c2) {
              sb[(sh * G::BQ + rg + G::RS * a) * G::SROW + kg + G::KG * c2] = sacc[a][c2];
              sacc[a][c2] = 0.f;
            }
          if (nc > 1)
            hopper::cluster_sync();
          else
            __syncthreads();
          float s[G::NX];
          unsigned vis = 0u;
          float mt = m;
#pragma unroll
          for (int x = 0; x < G::NX; ++x) {
            const int key = sp + G::TPR * x, col = k0 + key;
            // in rank order, each rank's parts in order
            const float dot = wide::part_sum<G::KS, G::BQ * G::SROW>(
                sb + sr * G::SROW + key, nc);
            const bool ok = col < Sk && (!causal || col <= srow) &&
                            (!seg || kv_ids[(size_t)b * Sk + col] == qid);
            s[x] = ok ? __fmul_rn(dot, scale) : NEG;
            vis |= (ok ? 1u : 0u) << x;
            mt = fmaxf(mt, s[x]);
          }
#pragma unroll
          for (int off = 1; off < G::TPR; off <<= 1)
            mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
          const float alpha = expf(m - mt);
          float sum = 0.f;
#pragma unroll
          for (int x = 0; x < G::NX; ++x) {
            const int key = sp + G::TPR * x;
            const float p = ((vis >> x) & 1u) ? expf(s[x] - mt) : 0.f;
            sum += p;
            ps[key * G::PROW + sr] =
                DROP ? dropout::apply(drop, dropout::col_key(rkey, k0 + key), p)
                     : p;
          }
#pragma unroll
          for (int off = 1; off < G::TPR; off <<= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          l = l * alpha + sum;
          m = mt;
          if (sp == 0) alpha_s[sr] = alpha;
        }
      } else {
        const int kk0 = G::VK * (i - nS);   // the stage's first key
        if (kk0 == 0) {
          // the tile's rescale of O (the barrier above ordered alpha)
          float al[G::OR];
          ld_rows(al, alpha_s + G::OR * og);
#pragma unroll
          for (int r = 0; r < G::OR; ++r)
#pragma unroll
            for (int c = 0; c < G::C; ++c) acc[r][c] = scale4(acc[r][c], al[r]);
        }
#pragma unroll
        for (int x = 0; x < G::VK; ++x) {
          float pv[G::OR];
          ld_rows(pv, ps + (kk0 + x) * G::PROW + G::OR * og);
          float4 vv[G::C];
#pragma unroll
          for (int c = 0; c < G::C; ++c)
            vv[c] = *reinterpret_cast<const float4*>(st + x * G::W + ocol + 128 * c);
#pragma unroll
          for (int r = 0; r < G::OR; ++r)
#pragma unroll
            for (int c = 0; c < G::C; ++c) acc[r][c] = axpy4(pv[r], vv[c], acc[r][c]);
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
    for (int r = 0; r < G::OR; ++r) {
      const int row = q0 + G::OR * og + r;
      if (row >= Sq) continue;
      const float lr = l_s[G::OR * og + r];
      const float linv = lr > 0.f ? 1.f / lr : 0.f;
      const size_t base = (((size_t)bh * Sq + row) * D + c0 + ocol) / 4;
#pragma unroll
      for (int c = 0; c < G::C; ++c) store4(o, base + 32 * c, scale4(acc[r][c], linv));
    }
  }
}

// B*H on x (2^31 - 1), the q blocks on y, the D/W column slices on z, a
// cluster of min(D/1024, 8) slices from W 1024 (1 from W 64 to 512); bf16
// (no keys) writes zeros and takes no shared memory
template <typename T, int W, bool DROP>
int launch_wide_w(const void* q, const void* k, const void* v, void* o,
                  float* lse, const int* q_ids, const int* kv_ids, int B,
                  int H, int HK, int Sq, int Sk, int D, int causal,
                  float scale, const dropout::Params& drop,
                  cudaStream_t stream) {
  using G = FwdWide<W>;
  const int smem = sizeof(T) == 2 ? 0 : G::SMEM;
  static const bool sized =
      hopper::allow_smem(flash_fwd_kernel_wide<T, W, DROP>, smem);
  if (!sized) return static_cast<int>(cudaErrorInvalidValue);
  return hopper::launch_clusters(
      flash_fwd_kernel_wide<T, W, DROP>,
      dim3(B * H, (Sq + G::BQ - 1) / G::BQ, D / G::W), G::THREADS, smem,
      G::CLUSTER ? min(D / G::W, G::MAX_NC) : 1, stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, q_ids, kv_ids, H,
      HK, Sq, Sk, D, causal, scale, drop);
}

// f32 at 16, 32, 64, 128, 256 and 512 (one CTA spans the row) and at the wide
// widths (1024 of O's columns a CTA); bf16 only at the wide widths with no
// keys (with keys it runs the wide tensor-core body)
template <typename T, bool DROP>
int launch_wide(const void* q, const void* k, const void* v, void* o,
                float* lse, const int* q_ids, const int* kv_ids, int B, int H,
                int HK, int Sq, int Sk, int D, int causal, float scale,
                const dropout::Params& drop, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4) {
    if (D == 16)
      return launch_wide_w<T, 16, DROP>(q, k, v, o, lse, q_ids, kv_ids, B, H, HK, Sq, Sk, D, causal, scale, drop, stream);
    if (D == 32)
      return launch_wide_w<T, 32, DROP>(q, k, v, o, lse, q_ids, kv_ids, B, H, HK, Sq, Sk, D, causal, scale, drop, stream);
    if (D == 64)
      return launch_wide_w<T, 64, DROP>(q, k, v, o, lse, q_ids, kv_ids, B, H, HK, Sq, Sk, D, causal, scale, drop, stream);
    if (D == 128)
      return launch_wide_w<T, 128, DROP>(q, k, v, o, lse, q_ids, kv_ids, B, H, HK, Sq, Sk, D, causal, scale, drop, stream);
    if (D == 256)
      return launch_wide_w<T, 256, DROP>(q, k, v, o, lse, q_ids, kv_ids, B, H, HK, Sq, Sk, D, causal, scale, drop, stream);
    if (D == 512)
      return launch_wide_w<T, 512, DROP>(q, k, v, o, lse, q_ids, kv_ids, B, H, HK, Sq, Sk, D, causal, scale, drop, stream);
  }
  if (!wide::takes(D) || (sizeof(T) == 2 && Sk > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_wide_w<T, 1024, DROP>(q, k, v, o, lse, q_ids, kv_ids, B, H, HK, Sq, Sk, D, causal, scale, drop, stream);
}

// ---------------------------------------------------------------------------
// tensor-core body: bf16, D 16, 32, 64, 128 and 256 (wgmma + TMA;
// hopper_mma.cuh)
// ---------------------------------------------------------------------------

constexpr int TC_BK = 64;                       // keys per ring stage
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct FwdTc {
  // A panel is PW columns of the head: 64 (rows of 128 bytes, the 128-byte
  // swizzle) from D 64; at D 16 and 32 one panel as wide as the head (rows
  // of 32 and 64 bytes, the swizzle of that width: hopper_mma.cuh)
  static constexpr int PW = D < 64 ? D : 64;
  static constexpr int SW = 2 * PW;             // a row's bytes, its swizzle
  static constexpr int NP = D / PW;             // panels
  static constexpr int NA = PW / 2;             // O's f32 registers a panel
  static constexpr int BK = TC_BK;              // keys a ring stage
  static constexpr int NS = BK / 2;             // S's f32 registers
  static constexpr int BQ = 64;                 // query rows a CTA
  static constexpr int THREADS = 128;           // one warpgroup
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;   // one K or V tile
  // K/V ring stages: two up to D 128; one at D 256, so that two CTAs
  // (96 KB of tiles each) share an SM and overlap each other's chains
  static constexpr int STAGES = D > 128 ? 1 : 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int KID_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = KID_OFF + 2 * BK * 4;
  static constexpr int SMEM = BAR_OFF + 2 * 8 + 1024;   // + alignment slack
};

// A bit a score of the tile: 32 bits hold a 64-key tile's share of a
// thread, 64 a 128-key tile's
template <int NS>
struct VisBits { using type = uint32_t; };
template <>
struct VisBits<64> { using type = uint64_t; };

// One tile of scores in the accumulator fragment (s, base 2 after this):
// scale, mask where MASK, fold into the running max m and sum l (this
// thread's share of its two rows), return the rescale factors and leave
// the probabilities in s; under DROP, after l has summed them, keep * p /
// (1 - rate), each pair hashed from its row's key rkey (every tile).
template <bool MASK, bool DROP, int NS>
__device__ __forceinline__ void softmax_tile(
    float (&s)[NS], float (&m)[2], float (&l)[2], float (&alpha)[2],
    float scale2, int k0, int r_lo, int lane, int Sk, int causal,
    const int* kid, int qid_lo, int qid_hi, const uint32_t (&rkey)[2],
    const dropout::Params& drop) {
  using V = typename VisBits<NS>::type;
  V vis = ~V(0);
  if (MASK) {
    vis = V(0);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int c = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const int row = r_lo + 8 * ((i >> 1) & 1);
      const int col = k0 + c;
      const bool ok = col < Sk && (!causal || col <= row) &&
                      (kid == nullptr ||
                       kid[c] == (((i >> 1) & 1) ? qid_hi : qid_lo));
      vis |= V(ok ? 1 : 0) << i;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    s[i] = (!MASK || ((vis >> i) & V(1))) ? s[i] * scale2 : NEG;
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
  for (int i = 0; i < NS; ++i) {
    const int h = (i >> 1) & 1;
    const float p = (!MASK || ((vis >> i) & V(1))) ? exp2f(s[i] - mx[h]) : 0.f;
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
  constexpr int BK = G::BK, SW = G::SW;
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
  const int ntile = (kend + BK - 1) / BK;
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
      hopper::tma_load_3d(qs + p * G::BQ * SW, &map_q, &bar[0], G::PW * p,
                          q0, bh);
      hopper::tma_load_3d(ks + p * BK * SW, &map_k, &bar[0], G::PW * p, 0,
                          bhk);
      hopper::tma_load_3d(vs + p * BK * SW, &map_v, vbar, G::PW * p, 0,
                          bhk);
    }
  }
  if (seg) {
    for (int j = tid; j < BK; j += G::THREADS)
      kid[j] = j < Sk ? kv_ids[(size_t)b * Sk + j] : 0;
  }
  const int qid_lo = (seg && r_lo < Sq) ? q_ids[(size_t)b * Sq + r_lo] : 0;
  const int qid_hi =
      (seg && r_lo + 8 < Sq) ? q_ids[(size_t)b * Sq + r_lo + 8] : 0;

  float acc[G::NP][G::NA];
  float s[G::NS];
#pragma unroll
  for (int i = 0; i < G::NS; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < G::NA; ++i)
#pragma unroll
    for (int p = 0; p < G::NP; ++p) acc[p][i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  for (int t = 0; t < ntile; ++t) {
    const int k0 = t * BK;
    const int st = t & 1;
    // every thread is done with tile t-1: with two stages its stage
    // takes tile t+1; with one, the V stage takes tile t
    __syncthreads();
    if (G::STAGES == 2 && t + 1 < ntile && tid == 0) {
      const int nst = st ^ 1;
      hopper::mbar_expect_tx(&bar[nst], 2 * G::KV_BYTES);
#pragma unroll
      for (int p = 0; p < G::NP; ++p) {
        hopper::tma_load_3d(ks + nst * G::KV_BYTES + p * BK * SW, &map_k,
                            &bar[nst], G::PW * p, k0 + BK, bhk);
        hopper::tma_load_3d(vs + nst * G::KV_BYTES + p * BK * SW, &map_v,
                            &bar[nst], G::PW * p, k0 + BK, bhk);
      }
    }
    if (G::STAGES == 1 && t > 0 && tid == 0) {
      hopper::mbar_expect_tx(vbar, G::KV_BYTES);
#pragma unroll
      for (int p = 0; p < G::NP; ++p)
        hopper::tma_load_3d(vs + p * BK * SW, &map_v, vbar, G::PW * p, k0,
                            bhk);
    }
    if (seg && t + 1 < ntile) {
      for (int j = tid; j < BK; j += G::THREADS) {
        const int col = k0 + BK + j;
        kid[(st ^ 1) * BK + j] = col < Sk ? kv_ids[(size_t)b * Sk + col] : 0;
      }
    }
    if (G::STAGES == 2)
      hopper::mbar_wait(&bar[st], (t >> 1) & 1);
    else
      hopper::mbar_wait(&bar[0], t & 1);

    // S = Q . K^T (K-major both; a k16 step is 32 bytes along a row)
    const uint8_t* kt = ks + (G::STAGES == 2 ? st : 0) * G::KV_BYTES;
    const uint8_t* vt = vs + (G::STAGES == 2 ? st : 0) * G::KV_BYTES;
    hopper::fence_acc(s);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk / (SW / 32), off = (kk % (SW / 32)) * 32;
      hopper::wgmma_ss<BK, 0>(
          s, hopper::desc_sw<SW>(qs + p * G::BQ * SW + off, 16, 8 * SW),
          hopper::desc_sw<SW>(kt + p * BK * SW + off, 16, 8 * SW), kk > 0);
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
          hopper::tma_load_3d(ks + p * BK * SW, &map_k, &bar[0], G::PW * p,
                              k0 + BK, bhk);
      }
    }

    float alpha[2];
    const bool need = seg || k0 + BK > Sk ||
                      (causal && k0 + BK - 1 > q0);
    if (need)
      softmax_tile<true, DROP>(s, m, l, alpha, scale2, k0, r_lo, lane, Sk,
                               causal, seg ? kid + st * BK : nullptr,
                               qid_lo, qid_hi, rkey, drop);
    else
      softmax_tile<false, DROP>(s, m, l, alpha, scale2, k0, r_lo, lane, Sk,
                                causal, nullptr, 0, 0, rkey, drop);

    // O = O * alpha + P . V, P rounded to bf16 in registers (V MN-major:
    // a k16 step is 16 key rows, 16 SW bytes)
    uint32_t a[BK / 16][4];
#pragma unroll
    for (int c = 0; c < BK / 16; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[c][r] = hopper::pack_bf16(s[8 * c + 2 * r], s[8 * c + 2 * r + 1]);
#pragma unroll
    for (int p = 0; p < G::NP; ++p) {
      hopper::fence_acc(acc[p]);
#pragma unroll
      for (int i = 0; i < G::NA; ++i) acc[p][i] *= alpha[(i >> 1) & 1];
      hopper::fence_acc(acc[p]);
    }
    if (G::STAGES == 1) hopper::mbar_wait(vbar, t & 1);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < BK / 16; ++c)
#pragma unroll
      for (int p = 0; p < G::NP; ++p)
        hopper::wgmma_rs<G::PW, 1>(
            acc[p], a[c],
            hopper::desc_sw<SW>(vt + p * BK * SW + c * 16 * SW, BK * SW,
                                8 * SW));
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
      for (int j = 0; j < G::NA / 4; ++j)
        orow[(G::PW * p + 8 * j + 2 * (lane & 3)) / 2] =
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
  const CUtensorMapSwizzle swz = hopper::swizzle_of(G::PW);
  CUtensorMap mq, mk, mv;
  int rc = hopper::make_map_bf16(&mq, q, D, Sq, B * H, G::BQ, G::PW, swz);
  if (rc == 0) rc = hopper::make_map_bf16(&mk, k, D, Sk, B * HK, G::BK, G::PW, swz);
  if (rc == 0) rc = hopper::make_map_bf16(&mv, v, D, Sk, B * HK, G::BK, G::PW, swz);
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

// One 64 x D x 64 product of each kind the tensor-core bodies run, on
// the card's own layouts, to hold the shared-memory descriptors of every
// panel width against a plain matrix product (chip_smoke.py's narrow-head
// phase): S = A.B^T (A 64 x D and B 64 x D K-major, as Q.K^T) and O =
// P.V (P 64 x 64 bf16 as the register fragment, V 64 x D MN-major, as
// P.V and dK += dS^T.Q), A, B and V by TMA with the swizzle of the
// body's panels, S and O written in f32.  Not a path of the port.
template <int D>
__global__ void __launch_bounds__(128)
wgmma_probe_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   const __grid_constant__ CUtensorMap map_v,
                   const __nv_bfloat16* __restrict__ pm,
                   float* __restrict__ s_out, float* __restrict__ o_out) {
  using G = FwdTc<D>;
  constexpr int SW = G::SW, TILE = 64 * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw +
                ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* as = sm;
  uint8_t* bs = sm + TILE;
  uint8_t* vs = sm + 2 * TILE;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + 3 * TILE);
  const int tid = threadIdx.x, lane = tid & 31;
  const int r_lo = 16 * (tid >> 5) + (lane >> 2);   // and r_lo + 8
  if (tid == 0) {
    hopper::mbar_init(bar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(bar, 3 * TILE);
#pragma unroll
    for (int p = 0; p < G::NP; ++p) {
      hopper::tma_load_3d(as + p * 64 * SW, &map_a, bar, G::PW * p, 0, 0);
      hopper::tma_load_3d(bs + p * 64 * SW, &map_b, bar, G::PW * p, 0, 0);
      hopper::tma_load_3d(vs + p * 64 * SW, &map_v, bar, G::PW * p, 0, 0);
    }
  }
  hopper::mbar_wait(bar, 0);
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  hopper::fence_acc(s);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int p = kk / (SW / 32), off = (kk % (SW / 32)) * 32;
    hopper::wgmma_ss<64, 0>(
        s, hopper::desc_sw<SW>(as + p * 64 * SW + off, 16, 8 * SW),
        hopper::desc_sw<SW>(bs + p * 64 * SW + off, 16, 8 * SW), kk > 0);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_acc(s);
  // P's k16 chunk c as the A fragment: register r holds row r_lo + 8 (r %
  // 2), columns 8 (2c + r / 2) + 2 (lane % 4) and the next
  uint32_t a[4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[c][r] = *reinterpret_cast<const uint32_t*>(
          pm + (r_lo + 8 * (r & 1)) * 64 + 8 * (2 * c + (r >> 1)) +
          2 * (lane & 3));
  float acc[G::NP][G::NA];
#pragma unroll
  for (int p = 0; p < G::NP; ++p)
#pragma unroll
    for (int i = 0; i < G::NA; ++i) acc[p][i] = 0.f;
#pragma unroll
  for (int p = 0; p < G::NP; ++p) hopper::fence_acc(acc[p]);
  hopper::wgmma_fence();
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int p = 0; p < G::NP; ++p)
      hopper::wgmma_rs<G::PW, 1>(
          acc[p], a[c],
          hopper::desc_sw<SW>(vs + p * 64 * SW + c * 16 * SW, 64 * SW,
                              8 * SW));
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int p = 0; p < G::NP; ++p) hopper::fence_acc(acc[p]);
#pragma unroll
  for (int i = 0; i < 32; ++i)
    s_out[(r_lo + 8 * ((i >> 1) & 1)) * 64 + 8 * (i >> 2) + 2 * (lane & 3) +
          (i & 1)] = s[i];
#pragma unroll
  for (int p = 0; p < G::NP; ++p)
#pragma unroll
    for (int i = 0; i < G::NA; ++i)
      o_out[(r_lo + 8 * ((i >> 1) & 1)) * D + G::PW * p + 8 * (i >> 2) +
            2 * (lane & 3) + (i & 1)] = acc[p][i];
}

template <int D>
int launch_probe(const void* a, const void* b, const void* v, const void* p,
                 float* s, float* o, cudaStream_t stream) {
  using G = FwdTc<D>;
  const CUtensorMapSwizzle swz = hopper::swizzle_of(G::PW);
  CUtensorMap ma, mb, mv;
  int rc = hopper::make_map_bf16(&ma, a, D, 64, 1, 64, G::PW, swz);
  if (rc == 0) rc = hopper::make_map_bf16(&mb, b, D, 64, 1, 64, G::PW, swz);
  if (rc == 0) rc = hopper::make_map_bf16(&mv, v, D, 64, 1, 64, G::PW, swz);
  if (rc != 0) return rc;
  const int smem = 3 * 64 * D * 2 + 8 + 1024;
  wgmma_probe_kernel<D><<<1, 128, smem, stream>>>(
      ma, mb, mv, static_cast<const __nv_bfloat16*>(p), s, o);
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
            s, hopper::desc_sw<128>(qp + kk * 32, 16, 1024),
            hopper::desc_sw<128>(qp + G::PANEL + kk * 32, 16, 1024),
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
            hopper::desc_sw<128>(vs + p * G::PANEL + c * 2048, G::PANEL, 1024));
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

// The CUDA-core body of width D
template <typename T, bool DROP>
int launch_cuda_cores(const void* q, const void* k, const void* v, void* o,
                      float* lse, const int* qi, const int* ki, int B, int H,
                      int HK, int Sq, int Sk, int D, int causal, float scale,
                      const dropout::Params& dr, cudaStream_t st) {
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

// The route: bf16 with keys to read takes the tensor cores, at D 16, 32,
// 64, 128 and 256 and (the wide tensor-core body) at D 512 and every wide
// width, D >= 1024 (wide::tc_takes); f32 at 256 and 512 (wide::row_takes),
// at 16, 32, 64 and 128 (wide::narrow_takes)
// with keys to read and the rest of the wide widths (f32, and bf16 with
// no keys) the register-tile body, everything else (f32 with no keys up to
// 128, bf16 with no keys up to 512) the CUDA-core bodies of their width;
// a seed takes each body's DROP instantiation.
template <typename T, bool DROP>
int route(const void* q, const void* k, const void* v, void* o, float* lse,
             const int* qi, const int* ki, int B, int H, int HK, int Sq,
             int Sk, int D, int causal, float scale,
             const dropout::Params& dr, cudaStream_t st) {
  if (sizeof(T) == 2 && Sk > 0) {
    if (D == 16)
      return launch_tc<16, DROP>(q, k, v, o, lse, qi, ki, B, H, HK, Sq, Sk, causal, scale, dr, st);
    if (D == 32)
      return launch_tc<32, DROP>(q, k, v, o, lse, qi, ki, B, H, HK, Sq, Sk, causal, scale, dr, st);
    if (D == 64)
      return launch_tc<64, DROP>(q, k, v, o, lse, qi, ki, B, H, HK, Sq, Sk, causal, scale, dr, st);
    if (D == 128)
      return launch_tc<128, DROP>(q, k, v, o, lse, qi, ki, B, H, HK, Sq, Sk, causal, scale, dr, st);
    if (D == 256)
      return launch_tc<256, DROP>(q, k, v, o, lse, qi, ki, B, H, HK, Sq, Sk, causal, scale, dr, st);
    if (wide::tc_takes(D))
      return launch_tc_wide<DROP>(q, k, v, o, lse, qi, ki, B, H, HK, Sq, Sk, D, causal, scale, dr, st);
  }
  if (sizeof(T) == 4 && wide::row_takes(D))
    return launch_wide<T, DROP>(q, k, v, o, lse, qi, ki, B, H, HK, Sq, Sk, D, causal, scale, dr, st);
  if (sizeof(T) == 4 && wide::narrow_takes(D) && Sk > 0)
    return launch_wide<T, DROP>(q, k, v, o, lse, qi, ki, B, H, HK, Sq, Sk, D, causal, scale, dr, st);
  if (D >= wide::MIN_D)
    return launch_wide<T, DROP>(q, k, v, o, lse, qi, ki, B, H, HK, Sq, Sk, D, causal, scale, dr, st);
  return launch_cuda_cores<T, DROP>(q, k, v, o, lse, qi, ki, B, H, HK, Sq, Sk, D, causal, scale, dr, st);
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

// The CUDA-core forward of every width it has (16..512), whatever the
// dtype (the arguments of apex_flash_fwd): f32 with keys routes to the
// register-tile body and bf16 with keys to the tensor cores, and
// this lets a measurement time the CUDA-core body beside them on the same
// inputs.  Any other width is refused.
extern "C" int apex_flash_fwd_cuda_cores(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* q_ids, const void* kv_ids, int dtype, int B, int H, int HK,
    int Sq, int Sk, int D, int causal, float scale, const void* seed,
    unsigned keep_below, float keep_scale, void* stream) {
  float* lf = static_cast<float*>(lse);
  const int* qi = static_cast<const int*>(q_ids);
  const int* ki = static_cast<const int*>(kv_ids);
  const dropout::Params dr{static_cast<const int*>(seed), keep_below,
                           keep_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool drop = seed != nullptr;
  switch (dtype) {
    case F32:
      return drop ? launch_cuda_cores<float, true>(q, k, v, o, lf, qi, ki, B, H, HK, Sq, Sk, D, causal, scale, dr, st)
                  : launch_cuda_cores<float, false>(q, k, v, o, lf, qi, ki, B, H, HK, Sq, Sk, D, causal, scale, dr, st);
    case BF16:
      return drop ? launch_cuda_cores<__nv_bfloat16, true>(q, k, v, o, lf, qi, ki, B, H, HK, Sq, Sk, D, causal, scale, dr, st)
                  : launch_cuda_cores<__nv_bfloat16, false>(q, k, v, o, lf, qi, ki, B, H, HK, Sq, Sk, D, causal, scale, dr, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The descriptor probe (wgmma_probe_kernel) at D 16, 32 or 64: a (64, D),
// b (64, D), v (64, D) and p (64, 64) bf16, contiguous and 16-byte
// aligned; s (64, 64) and o (64, D) f32.  Returns a CUDA error code.
extern "C" int apex_wgmma_probe(const void* a, const void* b, const void* v,
                                const void* p, void* s, void* o, int D,
                                void* stream) {
  float* sf = static_cast<float*>(s);
  float* of = static_cast<float*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_probe<16>(a, b, v, p, sf, of, st);
    case 32: return launch_probe<32>(a, b, v, p, sf, of, st);
    case 64: return launch_probe<64>(a, b, v, p, sf, of, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
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
