// Welford batch statistics of an (N, C) array, reduced over N, for
// Hopper (sm_90a).
//
// Replaces one TPU kernel of apex_tpu/ops/welford.py:
//   welford_mean_var (:70, pallas_call :83, body _welford_kernel :43):
//     per column the count, mean and M2 of 256-row blocks, merged by
//     Chan's combine in a running accumulator across the grid
//                                            -> apex_welford_mean_var
// over x (N, C), C a multiple of 128 (the reference's gate); x in f32,
// bf16 or fp16, every statistic in f32.  Returns the mean, the biased
// variance M2 / max(n, 1) and the count.  ResNet-50's BatchNorm inputs
// at batch 128 and 224x224 are (401408, 256) down to (6272, 2048).
//
// What bounds it: bytes.  An element costs a few f32 operations against
// 2-4 bytes read; the least time is reading x once at 3.35 TB/s.
//
// Design.  The TPU kernel's accumulator lives across an in-order grid;
// on a GPU that would race.  So (idiom (a) of the port):
// 1. welford_partial_kernel: a 256-thread block owns 128 columns of a
//    chunk of rows (a multiple of 256, sized so that about 528 blocks,
//    four an SM, cover the array; the chunking depends on (N, C) alone).
//    It walks the chunk in 256-row sub-blocks, the reference's blocks:
//    first the sub-block's column sums and its mean, then a second read
//    (from L1/L2) for M2 = sum((x - mean)^2), never a sum and sum of
//    squares, which cancel at a large mean.  Every block works on x - k,
//    k the column's mean over the first 256 rows (the shifted-data form,
//    written by a first small launch, welford_shift_kernel): M2 does not
//    change, and the means that the combines merge are small, about the
//    spread / 16, whatever the mean; so their roundings stay far below
//    the spread at a mean of 300 and a spread of 0.05, and far below the
//    mean's tolerance at a mean of 0 and a spread of 1.  Each thread holds one
//    16-byte vector of columns and a stride of rows; the 256 threads'
//    sums meet in shared memory in a fixed order.  Rows past N are left
//    out of the sub-block (its count is the rows it holds).  A thread
//    loads four rows before it adds them, to keep loads in flight.  The
//    sub-blocks merge into the chunk's (n, mean, M2) by Chan's combine in
//    order, and the chunk writes them to a partials array.
// 2. welford_combine_kernel: one warp a column merges the chunks'
//    partials by the same combine, each lane a fixed stride of chunks in
//    order and then the lanes in a fixed tree, and writes mean (k plus
//    the merged mean), var and (once) the count.
// Three launches a call (shift, partials, combine).
// No atomics: the same input gives the same bits every run.  The count
// is exact while N < 2^24 (the reference's count is f32 too).
//
// Chan's combine is the reference's welford_combine (:29): n = na + nb,
// delta = mean_b - mean_a, mean = mean_a + delta * (nb / n), M2 = M2_a +
// M2_b + delta^2 * (na * nb / n), guarded for n == 0; explicit roundings,
// no contraction into FMAs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 128;        // columns of one block
constexpr int SUB = 256;         // rows of one sub-block (the reference's)
constexpr int U = 4;             // rows a thread loads before it adds
constexpr int COMBINE_WARPS = 4; // columns of one combine block

enum Dtype { F32 = 0, BF16 = 1, F16 = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const T* h = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) v[i] = to_f(h[i]);
}

// (n, mean, m2) <- Chan's combine of itself with (nb, mean_b, m2_b).
__device__ __forceinline__ void chan(float& n, float& mean, float& m2, float nb,
                                     float mean_b, float m2_b) {
  const float na = n;
  const float nn = __fadd_rn(na, nb);
  const float safe = nn > 0.f ? nn : 1.f;
  const float delta = __fsub_rn(mean_b, mean);
  mean = __fadd_rn(mean, __fmul_rn(delta, __fdiv_rn(nb, safe)));
  m2 = __fadd_rn(__fadd_rn(m2, m2_b),
                 __fmul_rn(__fmul_rn(delta, delta), __fdiv_rn(__fmul_rn(na, nb), safe)));
  n = nn;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
welford_partial_kernel(const T* __restrict__ x, long long rows, int c,
                       long long rows_per_chunk, float* __restrict__ part_mean,
                       float* __restrict__ part_m2, float* __restrict__ part_n,
                       const float* __restrict__ shift) {
  constexpr int N = Vec<T>::N;     // columns a thread holds
  constexpr int TX = TILE / N;     // threads across the tile
  constexpr int TY = THREADS / TX; // threads down the rows
  __shared__ float red[TY][TILE];
  __shared__ float col_mean[TILE];
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int col0 = blockIdx.y * TILE;
  const long long chunk = blockIdx.x;
  const long long r0 = chunk * rows_per_chunk;
  const long long r1 = min(rows, r0 + rows_per_chunk);
  const T* xc = x + col0 + tx * N;
  float k[N];                      // the shift of these columns
#pragma unroll
  for (int i = 0; i < N; ++i) k[i] = shift[col0 + tx * N + i];
  float n = 0.f, mean = 0.f, m2 = 0.f;   // column threadIdx.x (< TILE)
  for (long long s0 = r0; s0 < r1; s0 += SUB) {
    const long long s1 = min(r1, s0 + SUB);
    const float nb = static_cast<float>(s1 - s0);
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.f;
    for (long long r = s0 + ty; r < s1; r += U * TY) {
      float v[U][N];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (r + u * TY < s1) load_vec<T>(xc + (r + u * TY) * c, v[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r + u * TY >= s1) break;
#pragma unroll
        for (int i = 0; i < N; ++i) acc[i] = __fadd_rn(acc[i], __fsub_rn(v[u][i], k[i]));
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) red[ty][tx * N + i] = acc[i];
    __syncthreads();
    if (threadIdx.x < TILE) {
      float s = red[0][threadIdx.x];
#pragma unroll
      for (int y = 1; y < TY; ++y) s = __fadd_rn(s, red[y][threadIdx.x]);
      col_mean[threadIdx.x] = __fdiv_rn(s, nb);
    }
    __syncthreads();
    float mb[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      mb[i] = col_mean[tx * N + i];
      acc[i] = 0.f;
    }
    for (long long r = s0 + ty; r < s1; r += U * TY) {
      float v[U][N];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (r + u * TY < s1) load_vec<T>(xc + (r + u * TY) * c, v[u]);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r + u * TY >= s1) break;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float d = __fsub_rn(__fsub_rn(v[u][i], k[i]), mb[i]);
          acc[i] = __fadd_rn(acc[i], __fmul_rn(d, d));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) red[ty][tx * N + i] = acc[i];
    __syncthreads();
    if (threadIdx.x < TILE) {
      float s = red[0][threadIdx.x];
#pragma unroll
      for (int y = 1; y < TY; ++y) s = __fadd_rn(s, red[y][threadIdx.x]);
      chan(n, mean, m2, nb, col_mean[threadIdx.x], s);
    }
    __syncthreads();                 // red and col_mean are free again
  }
  if (threadIdx.x < TILE) {
    part_mean[chunk * c + col0 + threadIdx.x] = mean;
    part_m2[chunk * c + col0 + threadIdx.x] = m2;
    if (threadIdx.x == 0 && blockIdx.y == 0) part_n[chunk] = n;
  }
}

// shift[col] = the mean of the first min(rows, 256) rows of the column
// (rows > 0); one block a 128-column tile, the partial kernel's layout.
template <typename T>
__global__ void __launch_bounds__(THREADS)
welford_shift_kernel(const T* __restrict__ x, long long rows, int c,
                     float* __restrict__ shift) {
  constexpr int N = Vec<T>::N;
  constexpr int TX = TILE / N;
  constexpr int TY = THREADS / TX;
  __shared__ float red[TY][TILE];
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int col0 = blockIdx.x * TILE;
  const long long r1 = min(rows, static_cast<long long>(SUB));
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  for (long long r = ty; r < r1; r += TY) {
    float v[N];
    load_vec<T>(x + r * c + col0 + tx * N, v);
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = __fadd_rn(acc[i], v[i]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) red[ty][tx * N + i] = acc[i];
  __syncthreads();
  if (threadIdx.x < TILE) {
    float s = red[0][threadIdx.x];
#pragma unroll
    for (int y = 1; y < TY; ++y) s = __fadd_rn(s, red[y][threadIdx.x]);
    shift[col0 + threadIdx.x] = __fdiv_rn(s, static_cast<float>(r1));
  }
}

// One warp a column: lane l merges chunks l, l + 32, ... in order, then
// the lanes merge in a fixed tree (lane l takes lane l + o, o = 16 .. 1).
__global__ void __launch_bounds__(COMBINE_WARPS * 32)
welford_combine_kernel(const float* __restrict__ part_mean,
                       const float* __restrict__ part_m2,
                       const float* __restrict__ part_n,
                       const float* __restrict__ shift, int n_chunks, int c,
                       float* __restrict__ mean_out, float* __restrict__ var_out,
                       float* __restrict__ count_out) {
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * COMBINE_WARPS + (threadIdx.x >> 5);
  if (col >= c) return;            // the whole warp
  float n = 0.f, mean = 0.f, m2 = 0.f;
#pragma unroll 4
  for (int k = lane; k < n_chunks; k += 32)
    chan(n, mean, m2, part_n[k], part_mean[static_cast<long long>(k) * c + col],
         part_m2[static_cast<long long>(k) * c + col]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, n, o);
    const float mb = __shfl_down_sync(0xffffffffu, mean, o);
    const float m2b = __shfl_down_sync(0xffffffffu, m2, o);
    if (lane + o < 32) chan(n, mean, m2, nb, mb, m2b);
  }
  if (lane != 0) return;
  mean_out[col] = n_chunks > 0 ? __fadd_rn(shift[col], mean) : 0.f;
  var_out[col] = __fdiv_rn(m2, fmaxf(n, 1.f));
  if (col == 0) *count_out = n;
}

template <typename T>
void launch_partial(const void* x, long long rows, int c, int rows_per_chunk,
                    int n_chunks, float* pm, float* pv, float* pn, float* sh,
                    cudaStream_t st) {
  welford_shift_kernel<T><<<c / TILE, THREADS, 0, st>>>(
      static_cast<const T*>(x), rows, c, sh);
  const dim3 grid(static_cast<unsigned>(n_chunks), c / TILE);
  welford_partial_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(x), rows, c, rows_per_chunk, pm, pv, pn, sh);
}

}  // namespace

// Plain C entry point (bound with ctypes): the three launches of one call
// on `stream`, allocating nothing (the wrapper passes the (n_chunks, c)
// partials, the (n_chunks,) counts, the (c,) shifts and the outputs),
// returning cudaGetLastError() (0 when all were accepted).  Dtype codes: 0
// float32, 1 bfloat16, 2 float16.  x is a contiguous (rows, c) array,
// 16-byte aligned; rows_per_chunk is a multiple of 256 and n_chunks =
// ceil(rows / rows_per_chunk) (0 for rows == 0: zeros and a count of 0).
extern "C" int apex_welford_mean_var(const void* x, int dtype, long long rows,
                                     int c, int rows_per_chunk, int n_chunks,
                                     void* part_mean, void* part_m2,
                                     void* part_n, void* shift, void* mean,
                                     void* var, void* count, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype < F32 || dtype > F16 || rows < 0 || c <= 0 || c % TILE != 0 || c / TILE > 65535 ||
      rows_per_chunk <= 0 || rows_per_chunk % SUB != 0 || n_chunks < 0 ||
      static_cast<long long>(n_chunks) * rows_per_chunk < rows ||
      (n_chunks > 0 && static_cast<long long>(n_chunks - 1) * rows_per_chunk >= rows))
    return static_cast<int>(cudaErrorInvalidValue);
  float* pm = static_cast<float*>(part_mean);
  float* pv = static_cast<float*>(part_m2);
  float* pn = static_cast<float*>(part_n);
  float* sh = static_cast<float*>(shift);
  if (n_chunks > 0) {
    if (dtype == F32) {
      launch_partial<float>(x, rows, c, rows_per_chunk, n_chunks, pm, pv, pn, sh, st);
    } else if (dtype == BF16) {
      launch_partial<__nv_bfloat16>(x, rows, c, rows_per_chunk, n_chunks, pm, pv, pn, sh, st);
    } else {
      launch_partial<__half>(x, rows, c, rows_per_chunk, n_chunks, pm, pv, pn, sh, st);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  welford_combine_kernel<<<(c + COMBINE_WARPS - 1) / COMBINE_WARPS, COMBINE_WARPS * 32, 0, st>>>(
      pm, pv, pn, sh, n_chunks, c, static_cast<float*>(mean), static_cast<float*>(var),
      static_cast<float*>(count));
  return static_cast<int>(cudaGetLastError());
}
