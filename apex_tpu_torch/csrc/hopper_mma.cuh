// Hopper (sm_90a) building blocks shared by the tensor-core bodies of
// csrc/flash_fwd.cu and csrc/flash_bwd.cu: warpgroup matrix multiplies
// (wgmma) with their fence / commit / wait, shared-memory matrix
// descriptors for the 32-, 64- and 128-byte swizzles, mbarrier helpers, the TMA tile
// load, and the host-side encoding of the TMA tensor maps; the cp.async
// copies, cluster launch, cluster barriers and distributed shared-memory
// reads of the CUDA-core wide bodies; the dropout hash and the wide
// bodies' widths.
//
// Conventions, after PTX ISA 8.x (wgmma.mma_async, cp.async.bulk.tensor,
// mbarrier) and CUTLASS's cute/arch/mma_sm90_desc.hpp and
// mma_sm90_gmma.hpp for the descriptor fields:
//
// - A tile in shared memory is what a TMA load with the 128-byte swizzle
//   writes: rows of 64 bf16 values (128 bytes), 8 rows to a 1024-byte
//   swizzle atom; a width of 128 is two such 64-column panels, one after
//   the other.  Every tile starts 1024-byte aligned.  A head of 16 or 32
//   columns is one panel as wide as the row: 32 or 64 bytes, written by a
//   TMA box of that width with the 32- or 64-byte swizzle (swizzle_of),
//   8 rows to a 256- or 512-byte atom.  Below, SW is a row's bytes (32,
//   64 or 128) and the swizzle's, desc_sw<SW> the descriptor of its
//   layout type; the 128-byte numbers are SW = 128's.
// - K-major operand (the reduction index runs along a row, as Q and K
//   are stored for Q.K^T): the descriptor's stride byte offset is the
//   8 SW (1024) bytes between 8-row groups, its leading byte offset
//   unused (16 bytes, CUTLASS's 1); a step of 16 along the reduction
//   index is 32 bytes added to the start address inside the panel (at
//   SW 64 the second of two; at SW 32 there is one step).
// - MN-major operand (the reduction index runs down the rows, as V is
//   stored for P.V; wgmma's transpose bit, which 16-bit types allow):
//   the stride byte offset is again the 8 SW (1024) bytes between 8-row
//   groups (now 8 steps of the reduction), the leading byte offset the
//   distance between 64-column panels (unused at SW 32 and 64: N = 16 or
//   32 is one atom wide); a step of 16 along the reduction index is 16
//   SW (2048) bytes.  The K-major and MN-major atoms of one swizzle are
//   the same 8 rows of SW bytes, so one TMA-written tile serves both
//   majors (the dk/dv body reads its q and dO tiles both ways) at every
//   width (CUTLASS's Layout_K_SW*_Atom and Layout_MN_SW*_Atom).
// - Products: S = Q.K^T is m64n64k16 (m64n128k16 for 128-key tiles),
//   SS; O += P.V, dV += P^T.dO and dK += dS^T.Q are m64nNk16, RS, with N
//   = 64 a panel from D 64 and N = D at 16 and 32 (wgmma_rs<N>: 8 or 16
//   accumulators a thread).
// - The f32 accumulator of an m64nNk16 product gives thread t of the
//   warpgroup (warp w = t / 32, lane l = t % 32) element i at row
//   16 w + l / 4 + 8 ((i / 2) % 2) and column 8 (i / 4) + 2 (l % 4) +
//   i % 2.  Its registers 8c .. 8c+7, packed in pairs to bf16, are the
//   A fragment of the k16 chunk c of a product that takes it as its left
//   operand from registers (acc_to_a): P.V and dS^T.Q never go through
//   shared memory.

#pragma once

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------------------
// shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the TMA unit (async proxy).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the barrier's phase `parity` has completed.  A phase that
// never completes (bytes announced but never delivered) traps after
// about 2^26 polls, so a fault ends the kernel with an error instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (polls > (1u << 26)) __trap();
  }
}

// TMA: the box at coordinates (c0, c1, c2) of `map` into shared memory at
// `dst`, completion (its bytes) reported to `bar`.  Rows past the
// tensor's end arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// cp.async (the CUDA-core bodies' staging): 16 bytes from `src` to shared
// memory at `dst`, or 16 zero bytes where `valid` is false (source size
// 0: nothing is read, but `src` must still be a device address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// thread-block clusters: distributed shared memory
// ---------------------------------------------------------------------------

// Every thread of every CTA of the cluster arrives, then waits for all:
// the shared-memory writes before it (release) are visible to the reads
// after it (acquire) in any CTA of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The two halves of cluster_sync, apart: a CTA arrives once it is done
// reading the others' shared memory and waits only before it next writes
// what they read, so the barrier's latency hides behind the work between.
// Every thread calls them in turn (arrive, wait, arrive, ...).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The float at `local` (an address in this CTA's shared memory) in the
// shared memory of the cluster's CTA `rank`.
__device__ __forceinline__ float ld_cluster(const float* local, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(local)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote));
  return v;
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor of a tile that a TMA load with the
// SW-byte swizzle wrote (rows of SW bytes, 8 rows to an atom of 8 SW
// bytes): start address, leading and stride byte offsets in 16-byte
// units, layout type 1 (128-byte), 2 (64-byte) or 3 (32-byte swizzle) in
// bits 62-63 (CUTLASS's GMMA::LayoutType); base offset 0 (every tile is
// 1024-byte aligned).
template <int SW>
__device__ __forceinline__ uint64_t desc_sw(const void* smem, uint32_t lbo,
                                            uint32_t sbo) {
  static_assert(SW == 32 || SW == 64 || SW == 128,
                "desc_sw: a swizzle of 32, 64 or 128 bytes");
  uint64_t d = static_cast<uint64_t>((smem_u32(smem) & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(SW == 128 ? 1 : SW == 64 ? 2 : 3) << 62;
  return d;
}

// Orders this warpgroup's register and shared-memory writes before the
// wgmma that follow (needed before a batch whose accumulators or A
// fragments ordinary instructions touched).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that own it (CUTLASS's warpgroup_fence_operand).
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Two f32 values as one register of two bf16 (lo in the low half),
// each rounded to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B in shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B in shared memory
// (the narrow forward's 128-key tiles).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                            uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
}

// D[64 x N] (+)= A[64 x 16] * B[16 x N], A and B in shared memory, N 64
// or 128 (N / 2 f32 accumulators a thread).
template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
  if constexpr (N == 64)
    wgmma_ss_n64<TRANS_B>(d, desc_a, desc_b, accumulate);
  else
    wgmma_ss_n128<TRANS_B>(d, desc_a, desc_b, accumulate);
}

// D[64 x 16] += A[64 x 16] * B[16 x 16], A in registers, B in shared
// memory (O += P.V, dV += P^T.dO and dK += dS^T.Q at D 16).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
        "n"(TRANS_B));
}

// D[64 x 32] += A[64 x 16] * B[16 x 32], A in registers, B in shared
// memory (the same products at D 32).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
        "n"(TRANS_B));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A in registers (the bf16
// fragment of acc_to_a), B in shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
        "n"(TRANS_B));
}

// D[64 x N] += A[64 x 16] * B[16 x N], A in registers, B in shared
// memory, N 16, 32 or 64 (N / 2 f32 accumulators a thread).
template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  static_assert(N == 16 || N == 32 || N == 64, "wgmma_rs: N is 16, 32 or 64");
  if constexpr (N == 64)
    wgmma_rs_n64<TRANS_B>(d, a, desc_b);
  else if constexpr (N == 32)
    wgmma_rs_n32<TRANS_B>(d, a, desc_b);
  else
    wgmma_rs_n16<TRANS_B>(d, a, desc_b);
}

// ---------------------------------------------------------------------------
// host: TMA tensor maps
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (CUDA 12.5 or later) so the libraries need no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The TMA swizzle of a box `box_cols` bf16 wide: its rows' bytes, 32, 64
// or 128 (the narrow bodies' heads of 16 and 32 columns, and every 64-column
// panel of the wider ones).
inline CUtensorMapSwizzle swizzle_of(int box_cols) {
  return box_cols == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
         : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_128B;
}

// The map of a contiguous bf16 tensor (mats, rows, cols) read in boxes of
// (1, box_rows, box_cols) with the swizzle `swz` of that row width
// (swizzle_of: 64 columns and the 128-byte swizzle by default, 32 and the
// 64-byte, 16 and the 32-byte); rows past `rows` read as zeros.  cols * 2
// must be a multiple of 16 bytes and `base` 16-byte aligned (TMA's
// rules).  Returns a CUDA error code (0 on success).
inline int make_map_bf16(CUtensorMap* map, const void* base, int cols, int rows,
                         int mats, int box_rows, int box_cols = 64,
                         CUtensorMapSwizzle swz = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || (cols * 2) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (swz != swizzle_of(box_cols))
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(mats)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(cols) * 2 * rows};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1u};
  const cuuint32_t estride[3] = {1u, 1u, 1u};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// `kernel` on `grid` (`threads` a CTA, `smem` bytes of dynamic shared
// memory) with the grid's z in clusters of nc CTAs: cudaLaunchKernelEx
// with the cluster-dimension attribute.  A refused launch returns its
// error.
template <typename Kern, typename... Ts>
int launch_clusters(Kern kernel, dim3 grid, int threads, int smem, int nc,
                    cudaStream_t st, Ts... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = nc;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...));
}

// A kernel may take more than 48 KB of dynamic shared memory only once it
// has asked for it; asked once per instantiation (the first launch).
template <typename Kern>
bool allow_smem(Kern kernel, int bytes) {
  return bytes <= 48 * 1024 ||
         cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes) == cudaSuccess;
}

}  // namespace hopper

// ---------------------------------------------------------------------------
// the fused probability dropout of the flash bodies
// ---------------------------------------------------------------------------
//
// The reference's counter hash (apex_tpu/ops/attention.py:_fmix32,
// _keep_mask): murmur3's fmix32 of the seed and the flat (batch * head)
// row, then of that plus the global query row and key column, each times
// an odd constant; a pair is kept when the hash, unsigned, is below
// `thresh` = min(int((1 - rate) * 2^32), 2^32 - 1), worked out on the
// host.  Unsigned arithmetic here is the reference's int32 wraparound
// with logical shifts, bit for bit.  No mask is stored: the forward, dq
// and dk/dv each rebuild it from the coordinates.  The seed is read
// through a pointer to one int32 on the device, so a captured graph
// replays with the seed the buffer holds then.
namespace dropout {

struct Params {
  const int* seed;    // null: no dropout (the bodies' DROP = false)
  uint32_t thresh;    // keep when the hash is below it
  float inv;          // 1 / (1 - rate), rounded to f32 on the host
};

constexpr uint32_t HEAD_MUL = 0x9e3779b9u;   // int32 -1640531527
constexpr uint32_t ROW_MUL = 0x9d62d51fu;    // int32 -1654467297
constexpr uint32_t COL_MUL = 0x78a76a79u;    // int32 2024237689

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// The per-(batch * head) part of every pair's hash; `seed` is the int32
// the Params point at, read once by the kernel.
__device__ __forceinline__ uint32_t head_key(uint32_t seed, int bh) {
  return fmix32(seed + static_cast<uint32_t>(bh) * HEAD_MUL);
}

// A pair's key is head + row * ROW_MUL + col * COL_MUL: a body hoists
// the part of the row (or of the key column) it keeps fixed and adds the
// other per pair.
__device__ __forceinline__ uint32_t row_key(uint32_t part, int row) {
  return part + static_cast<uint32_t>(row) * ROW_MUL;
}
__device__ __forceinline__ uint32_t col_key(uint32_t part, int col) {
  return part + static_cast<uint32_t>(col) * COL_MUL;
}

__device__ __forceinline__ bool kept(const Params& d, uint32_t key) {
  return fmix32(key) < d.thresh;
}

// keep * x / (1 - rate)
__device__ __forceinline__ float scaled(const Params& d, bool keep, float x) {
  return keep ? __fmul_rn(x, d.inv) : 0.f;
}

__device__ __forceinline__ float apply(const Params& d, uint32_t key, float x) {
  return scaled(d, kept(d, key), x);
}

}  // namespace dropout

// ---------------------------------------------------------------------------
// the wide flash bodies' widths (head dims from 512)
// ---------------------------------------------------------------------------
namespace wide {

constexpr int MIN_D = 1024;   // the narrowest wide width (the CUDA cores)
// The narrowest width of the wide tensor-core bodies: D 512 divides into
// their slices (256 columns of O, dK and dV, 512 of dQ), so bf16 at D 512
// (and 257..511, padded to it) runs them too (tc_takes).
constexpr int TC_MIN_D = 512;
// A head wider than SPLIT pads to a multiple of it, which every wide
// body's column slice divides (256, 512 and 1024 columns a CTA), and so
// does a cluster of 8 of the f32 bodies' 1024-column slices.  Where a
// row block has more than one cluster, each computes the scores over the
// whole D, in one order, so all get the same bits.
constexpr int SPLIT = 8192;

// The wide widths: the powers of two 1024..8192, then the multiples of
// 8192 (ops/attention.py:_kernel_width pads every head dim to one).
__host__ __device__ constexpr bool takes(int D) {
  return D >= MIN_D &&
         (D <= SPLIT ? (D & (D - 1)) == 0 : D % SPLIT == 0);
}

// The widths of the wide tensor-core bodies: 512 and every wide width.
__host__ __device__ constexpr bool tc_takes(int D) {
  return D == TC_MIN_D || takes(D);
}

// The row widths of the f32 register-tile forward, dq and dk/dv
// (the wide CUDA-core bodies, flash_{fwd,dq,dkv}_kernel_wide): at 256
// and 512 (and the heads of 129..511, padded to them) one CTA spans a row
// of O (of dQ, of dK and dV), so no cluster.
__host__ __device__ constexpr bool row_takes(int D) {
  return D == 256 || D == 512;
}

// The narrow widths of the f32 register-tile forward, dq and dk/dv: at
// 16, 32, 64 and 128 (and the heads of 9..127, padded to them) one CTA
// spans a row of O (of dQ, of dK and dV), as at row_takes; 128 threads a
// CTA at 16 and 32, 256 at 64 and 128.
__host__ __device__ constexpr bool narrow_takes(int D) {
  return D == 16 || D == 32 || D == 64 || D == 128;
}

// The sum of a score's NP parts (STRIDE floats apart, from p) over the
// cluster's nc CTAs, in rank order and each rank's parts in order: every
// CTA of the cluster gets the same bits (with nc 1, its own parts)
template <int NP, int STRIDE>
__device__ __forceinline__ float part_sum(const float* p, int nc) {
  float dot = 0.f;
  for (int r = 0; r < nc; ++r) {
    float x = nc == 1 ? p[0] : hopper::ld_cluster(p, r);
#pragma unroll
    for (int s = 1; s < NP; ++s)
      x += nc == 1 ? p[s * STRIDE] : hopper::ld_cluster(p + s * STRIDE, r);
    dot = r == 0 ? x : dot + x;
  }
  return dot;
}

}  // namespace wide
