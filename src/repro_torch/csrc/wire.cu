// Fused wire kernels of the federated round, hand-written for Hopper (sm_90a).
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes. Every
// entry launches on the caller's stream, allocates nothing (the Python
// wrapper allocates outputs and scratch with torch.empty) and returns
// cudaGetLastError().
//
// ---------------------------------------------------------------------------
// Kernel 1: the upload  (replaces src/repro/kernels/wire.py:91 _upload_kernel
//           / :137 fused_upload)
//
// Per silo row of the (J, P) wire matrix: delta from the broadcast reference
// -> L2 clip to C (max(norm, 1e-12) guard) -> + z*C*noise -> + reference ->
// participation-mask select (reference or zeros) -> optional symmetric int8
// quantization with ONE scale per row (max|y|/127 + 1e-12).
//
// What bounds it: bytes. Each element is read and written a few times and
// costs a handful of flops, far below the card's 295 flops/byte balance.
// The clip norm and the int8 scale are row-global reductions.
//
// Design: every row is split across blocks. The wrapper plans a grid of
// (C column chunks, J rows) (kernels/wire.py _upload_plan): chunks are a
// multiple of 4 floats, so chunk starts keep the row's alignment, and J * C
// fills the card's SMs several times over. Block (c, j) owns columns
// [c chunk, (c + 1) chunk) of row j. Without clip and int8 (SFVI, SFVI-Avg)
// it is one launch and one pass (upload_apply_kernel). With clip, a first
// launch (upload_norm_kernel) writes each chunk's sum((x - ref)^2) to an f32
// (J, C) scratch, and the apply launch sums its row's C partials in a fixed
// order (lane-strided sums, then a shuffle tree: no atomics, so runs repeat
// bit for bit) before applying the factor. With int8 the apply launch also
// writes each chunk's max|y| to a second (J, C) scratch, and a third launch
// (upload_quant_kernel) reduces the row's max partials the same way and
// writes the codes from the f32 y (4 MB at the main path, re-read from L2).
// Loads and stores are V floats wide: V = 4 when P % 4 == 0, V = 2 when
// P % 2 == 0 (the main path's P = 100,354), else 1, with every pointer
// aligned to 4 V bytes (the wrapper checks). The arithmetic follows the
// reference's order with __fmul_rn/__fadd_rn (no FMA contraction), rintf
// (round half to even, as jnp.round) and a true division by the scale.
// The DP noise is an input tensor (the reference draws threefry noise
// in-kernel from per-row keys; an in-kernel Philox draw is later work).
// Inactive rows skip the norm and ship the fallback directly.
//
// ---------------------------------------------------------------------------
// Kernel 2: combine_mean_kernel, combine_trim_kernel and
//           combine_trim_staged_kernel  (replace src/repro/kernels/wire.py:208
//           _combine_kernel / :242 fused_combine)
//
// Column-wise over the silo axis of the gathered (J, P) matrix: weighted mean
// (denominator guarded only at total == 0), or trimmed mean over rows with
// w > 0 (k = min(floor(tf*n), floor((n-1)/2)) dropped at each end, zeros when
// no row is active), with an optional in-kernel int8 dequantize (q * scale_j).
//
// What bounds it: bytes (each element read once, the (P,) row written once).
// At the path's sizes (at most 4 MB, one wave) the time is mostly latency,
// and with the inputs in L2 partly instructions issued: each thread makes
// one round trip of loads, and no load is predicated off.
// Design (the plan is kernels/wire.py combine_plan):
//   * The direct routes, the mean for any J and the trim for J <= 16: a
//     column a thread (a warp reads 128 contiguous bytes of f32 a row), the
//     kernel instantiated for J rows (the mean in passes of 16 past that),
//     so all of a thread's loads (its column's J values, the weights and
//     int8 scales as broadcast loads) are issued before any is used, and
//     none is predicated off. The mean sums Σw and w_j x_j in row order,
//     the reference's order. The trim sets inactive rows to +inf, sorts the
//     J values with an odd-even transposition network (sort_rows) and sums ranks
//     k .. n-k-1 in ascending order; equal values are interchangeable in
//     that sum, so it keeps the multiset that the Pallas kernel's sort
//     keeps, and that a rank count with ties broken by row index keeps. n
//     and k come from the J weights each thread holds: no barrier.
//   * The staged route, the trim for 16 < J <= 1024: a block takes a tile
//     of tile_cols columns (a multiple of 16, at most 256: a column a
//     thread) for all J rows in shared memory. Each row's segment is copied
//     in 16-byte cp.async pieces aligned on that row's own address, with
//     scalar head and tail elements around them; in shared memory a row
//     starts at its address's offset within 16 bytes, so both ends of every
//     piece are aligned, for every P and every offset of x, f32 or int8.
//     Warp 0 finds the active rows (a ballot), n and k once a block while
//     the copies are in flight. Then the rank count over the staged column:
//     rank = #{active i : x_i < x_j or (x_i == x_j and i < j)}, kept if
//     k <= rank < n-k, summed in row order. O(J^2) a column; the wrapper
//     refuses J > 1024.
//   * Tried on the card and dropped (PERF.md, kernel table): the mean's
//     tile staged in shared memory, and 4 columns a thread with 16-byte
//     loads on each row's alignment, each slower than a column a thread at
//     every path shape (fewer warps hide less of each thread's longer
//     chain); 16 rows unrolled and predicated for every J (the dead
//     instructions still issue).
//   * The grids are at most the card's resident blocks (SMs times the
//     blocks an SM holds); blocks stride over the columns. Each column is
//     one thread's sum in a fixed order: runs repeat bit for bit, no
//     atomics. The Pallas grid's sequential order (wire.py:279) has no
//     Hopper counterpart, and none is needed: columns are independent.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kUploadThreads = 256;
constexpr int kCombineThreads = 256;  // a block of the staged trim: a column of a tile a thread

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum (kMax = false) or max (kMax = true); every thread gets the
// result. `smem` holds 33 floats. Values are >= 0 for the max, so 0 is its
// identity.
template <bool kMax>
__device__ float block_reduce(float v, float* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    float w = lane < nwarps ? smem[lane] : 0.f;
    w = kMax ? warp_max(w) : warp_sum(w);
    if (lane == 0) smem[32] = w;
  }
  __syncthreads();
  const float out = smem[32];
  __syncthreads();  // smem is reused by the next reduction
  return out;
}

// Sum (kMax = false) or max (kMax = true) of a row's C partials, the same
// fixed order in every block: lane l of warp 0 takes partials l, l + 32, ...
// in turn, then a shuffle tree. Every thread gets the result; `smem` holds
// 33 floats.
template <bool kMax>
__device__ float row_reduce(const float* __restrict__ parts, int C, float* smem) {
  if (threadIdx.x < 32) {
    float v = 0.f;
    for (int i = threadIdx.x; i < C; i += 32) v = kMax ? fmaxf(v, parts[i]) : v + parts[i];
    v = kMax ? warp_max(v) : warp_sum(v);
    if (threadIdx.x == 0) smem[32] = v;
  }
  __syncthreads();
  const float out = smem[32];
  __syncthreads();
  return out;
}

template <int V> struct Vec;
template <> struct Vec<1> { using F = float; using Q = int8_t; };
template <> struct Vec<2> { using F = float2; using Q = char2; };
template <> struct Vec<4> { using F = float4; using Q = char4; };

template <int V>
__device__ __forceinline__ void load_v(const float* __restrict__ p, float (&v)[V]) {
  const typename Vec<V>::F t = *reinterpret_cast<const typename Vec<V>::F*>(p);
  const float* f = reinterpret_cast<const float*>(&t);
#pragma unroll
  for (int e = 0; e < V; ++e) v[e] = f[e];
}

template <int V>
__device__ __forceinline__ void store_v(float* __restrict__ p, const float (&v)[V]) {
  typename Vec<V>::F t;
  float* f = reinterpret_cast<float*>(&t);
#pragma unroll
  for (int e = 0; e < V; ++e) f[e] = v[e];
  *reinterpret_cast<typename Vec<V>::F*>(p) = t;
}

struct UploadArgs {
  const float* x;
  const float* mask;
  const float* noise;  // null when noise_std == 0
  const float* ref;    // null without a reference
  float* y;
  int8_t* q;
  float* scales;
  float* norm_parts;  // (J, C): sum((x - ref)^2) of each chunk (clip)
  float* max_parts;   // (J, C): max|y| of each chunk (quantize)
  int P, C, chunk, clip, quantize;
  float clip_norm, noise_std;
};

// Launch 1 (clip only): each chunk's sum((x - ref)^2).
template <int V>
__global__ void __launch_bounds__(kUploadThreads)
upload_norm_kernel(const UploadArgs a) {
  __shared__ float smem[33];
  const int c = blockIdx.x, j = blockIdx.y;
  if (!(a.mask[j] > 0.5f)) return;  // inactive rows need no norm
  const long long row = static_cast<long long>(j) * a.P;
  const int c0 = c * a.chunk, c1 = min(a.P, c0 + a.chunk);
  float ss = 0.f;
  for (int i = c0 + V * threadIdx.x; i < c1; i += V * kUploadThreads) {
    float xv[V], rv[V];
    load_v<V>(a.x + row + i, xv);
    if (a.ref) load_v<V>(a.ref + i, rv);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float d = a.ref ? __fsub_rn(xv[e], rv[e]) : xv[e];
      ss += d * d;
    }
  }
  const float total = block_reduce<false>(ss, smem);
  if (threadIdx.x == 0) a.norm_parts[static_cast<long long>(j) * a.C + c] = total;
}

// Launch 2: y (and each chunk's max|y| when quantizing).
template <int V>
__global__ void __launch_bounds__(kUploadThreads)
upload_apply_kernel(const UploadArgs a) {
  __shared__ float smem[33];
  const int c = blockIdx.x, j = blockIdx.y;
  const bool active = a.mask[j] > 0.5f;  // uniform across the block
  const long long row = static_cast<long long>(j) * a.P;
  const int c0 = c * a.chunk, c1 = min(a.P, c0 + a.chunk);
  float factor = 1.f;
  if (a.clip && active) {
    const float norm = sqrtf(row_reduce<false>(a.norm_parts + static_cast<long long>(j) * a.C,
                                               a.C, smem));
    factor = fminf(1.f, a.clip_norm / fmaxf(norm, 1e-12f));
  }
  float amax = 0.f;
  for (int i = c0 + V * threadIdx.x; i < c1; i += V * kUploadThreads) {
    float xv[V], rv[V], nv[V], yv[V];
    if (a.ref) load_v<V>(a.ref + i, rv);
    if (active) load_v<V>(a.x + row + i, xv);
    if (active && a.clip && a.noise) load_v<V>(a.noise + row + i, nv);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float v;
      if (!active) {
        v = a.ref ? rv[e] : 0.f;
      } else if (a.clip) {
        const float r = a.ref ? rv[e] : 0.f;
        float d = a.ref ? __fsub_rn(xv[e], r) : xv[e];
        d = __fmul_rn(d, factor);
        if (a.noise) d = __fadd_rn(d, __fmul_rn(a.noise_std, nv[e]));
        v = a.ref ? __fadd_rn(r, d) : d;
      } else {
        v = xv[e];
      }
      yv[e] = v;
      amax = fmaxf(amax, fabsf(v));
    }
    store_v<V>(a.y + row + i, yv);
  }
  if (!a.quantize) return;
  const float m = block_reduce<true>(amax, smem);
  if (threadIdx.x == 0) a.max_parts[static_cast<long long>(j) * a.C + c] = m;
}

// Launch 3 (quantize only): the row's scale from its max partials, then
// the int8 codes of the chunk.
template <int V>
__global__ void __launch_bounds__(kUploadThreads)
upload_quant_kernel(const UploadArgs a) {
  __shared__ float smem[33];
  const int c = blockIdx.x, j = blockIdx.y;
  const long long row = static_cast<long long>(j) * a.P;
  const int c0 = c * a.chunk, c1 = min(a.P, c0 + a.chunk);
  const float m = row_reduce<true>(a.max_parts + static_cast<long long>(j) * a.C, a.C, smem);
  const float scale = __fadd_rn(__fdiv_rn(m, 127.f), 1e-12f);
  if (c == 0 && threadIdx.x == 0) a.scales[j] = scale;
  for (int i = c0 + V * threadIdx.x; i < c1; i += V * kUploadThreads) {
    float yv[V];
    load_v<V>(a.y + row + i, yv);
    typename Vec<V>::Q t;
    int8_t* b = reinterpret_cast<int8_t*>(&t);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float r = rintf(__fdiv_rn(yv[e], scale));
      b[e] = static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
    }
    *reinterpret_cast<typename Vec<V>::Q*>(a.q + row + i) = t;
  }
}

template <int V>
int launch_upload(const UploadArgs& a, int J, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(a.C), static_cast<unsigned>(J));
  if (a.clip) {
    upload_norm_kernel<V><<<grid, kUploadThreads, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  upload_apply_kernel<V><<<grid, kUploadThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !a.quantize) return static_cast<int>(err);
  upload_quant_kernel<V><<<grid, kUploadThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct CombineArgs {
  const void* x;        // (J, P) f32, or int8 with scales
  const float* scales;  // (J,) or null
  const float* w;       // (J,)
  float* out;           // (P,)
  int J, P, tile_cols;
  float trim_frac;
};

// Row j of x (J, P) from column c, and how many bytes that address lies
// past a 16-byte boundary: each row's own alignment, which P and x's
// offset set (P = 100,354 puts every other f32 row 8 bytes off).
template <typename T>
__device__ __forceinline__ const T* row_at(const T* x, int j, int P, int c) {
  return x + static_cast<long long>(j) * P + c;
}

template <typename T>
__device__ __forceinline__ int misalign(const T* x, int j, int P, int c) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(row_at(x, j, P, c)) % 16);
}

// Row r's int8 scale: every route reads the scales here (a value an int8
// code is multiplied by, __fmul_rn, as the reference's q * scale).
__device__ __forceinline__ float row_scale(const float* scales, int r) {
  return scales[r];
}

__device__ __forceinline__ bool kept(int rank, int n, int k) { return rank >= k && rank < n - k; }

// k = min(floor(tf n), floor((n - 1) / 2)) for n >= 1 active rows.
__device__ __forceinline__ int trim_count(float trim_frac, int n) {
  const float nf = static_cast<float>(n);
  return n == 0 ? 0 : static_cast<int>(fminf(floorf(__fmul_rn(trim_frac, nf)),
                                              floorf((nf - 1.f) / 2.f)));
}

// ---- the direct routes: a column a thread, its J values in registers -----

constexpr int kDirectThreads = 256;  // a block of the direct routes: a column a thread
constexpr int kDirectRows = 16;      // the largest J of the direct routes (mean: a pass)
constexpr int kDirectBlocks = 4;     // blocks an SM the direct kernels' registers allow (<= 64 a thread)

// Odd-even transposition sort of v[0, J) ascending: J rounds, round r
// ordering the pairs (i, i + 1) with i of r's parity; J(J-1)/2
// comparators, every index known to the compiler (the loops unroll fully,
// so v stays in registers).
template <int J>
__device__ __forceinline__ void sort_rows(float (&v)[J]) {
#pragma unroll
  for (int r = 0; r < J; ++r) {
#pragma unroll
    for (int i = r & 1; i + 1 < J; i += 2) {
      const float a = v[i], b = v[i + 1];
      v[i] = fminf(a, b);
      v[i + 1] = fmaxf(a, b);
    }
  }
}

// The weighted mean: thread t of the grid takes column t (then strides by
// the grid), ROWS rows a pass (ROWS = J up to kDirectRows, so no load is
// predicated off), all of a pass's loads (x, w and the int8 scales; a
// row's weight and scale are broadcast loads for the warp) issued before
// any is used. Σw and w_j x_j are summed in row order, the reference's.
template <typename T, int ROWS>
__global__ void __launch_bounds__(kDirectThreads, kDirectBlocks)
combine_mean_kernel(const CombineArgs a) {
  constexpr bool kDequant = sizeof(T) == 1;
  const T* x = static_cast<const T*>(a.x);
  for (int c = blockIdx.x * kDirectThreads + threadIdx.x; c < a.P;
       c += gridDim.x * kDirectThreads) {
    float acc = 0.f, total = 0.f;
    for (int j0 = 0; j0 < a.J; j0 += ROWS) {
      float v[ROWS], wv[ROWS], sv[ROWS];
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        if (j0 + u < a.J) {
          wv[u] = a.w[j0 + u];
          if (kDequant) sv[u] = row_scale(a.scales, j0 + u);
          v[u] = static_cast<float>(*row_at(x, j0 + u, a.P, c));
        }
      }
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        if (j0 + u < a.J) {
          total = __fadd_rn(total, wv[u]);
          const float xv = kDequant ? __fmul_rn(v[u], sv[u]) : v[u];
          acc = __fadd_rn(acc, __fmul_rn(wv[u], xv));
        }
      }
    }
    a.out[c] = __fdiv_rn(acc, total > 0.f ? total : 1.f);
  }
}

// The trimmed mean for J <= kDirectRows: a thread loads its column's J
// values (and the weights and scales, broadcast) before it uses any, sets
// the inactive rows' to +inf, sorts them (sort_rows) and sums ranks
// k .. n-k-1 in ascending order. Equal values are interchangeable in that
// sum, so it keeps the multiset that the Pallas kernel's sort keeps, and
// that a rank count with ties broken by row index keeps. n and k come from
// the weights each thread holds (J compares): no barrier.
template <typename T, int J>
__global__ void __launch_bounds__(kDirectThreads, kDirectBlocks)
combine_trim_kernel(const CombineArgs a) {
  constexpr bool kDequant = sizeof(T) == 1;
  const T* x = static_cast<const T*>(a.x);
  for (int c = blockIdx.x * kDirectThreads + threadIdx.x; c < a.P;
       c += gridDim.x * kDirectThreads) {
    float v[J], wv[J], sv[J];
#pragma unroll
    for (int r = 0; r < J; ++r) {
      wv[r] = a.w[r];
      if (kDequant) sv[r] = row_scale(a.scales, r);
      v[r] = static_cast<float>(*row_at(x, r, a.P, c));
    }
    int n = 0;
#pragma unroll
    for (int r = 0; r < J; ++r) {
      const bool on = wv[r] > 0.f;
      n += on;
      v[r] = !on ? INFINITY : kDequant ? __fmul_rn(v[r], sv[r]) : v[r];
    }
    const int k = trim_count(a.trim_frac, n);
    sort_rows(v);
    float sum = 0.f;
#pragma unroll
    for (int rank = 0; rank < J; ++rank)
      if (kept(rank, n, k)) sum = __fadd_rn(sum, v[rank]);
    a.out[c] = n == 0 ? 0.f : __fdiv_rn(sum, static_cast<float>(n - 2 * k));
  }
}

// The mean and trim kernels whose ROWS or J is `rows` (1 .. R).
template <typename T, int R>
const void* mean_kernel_for(int rows) {
  if constexpr (R > 1) {
    if (rows < R) return mean_kernel_for<T, R - 1>(rows);
  }
  return reinterpret_cast<const void*>(combine_mean_kernel<T, R>);
}

template <typename T, int R>
const void* trim_kernel_for(int rows) {
  if constexpr (R > 1) {
    if (rows < R) return trim_kernel_for<T, R - 1>(rows);
  }
  return reinterpret_cast<const void*>(combine_trim_kernel<T, R>);
}

// ---- the trimmed mean for J > kDirectRows: the tile staged in shared memory

// The columns [c0, c0 + width) of every row of x (J, P).
template <typename T>
struct Tile {
  const T* x;
  int P, c0, width;

  __device__ const T* seg(int j) const { return row_at(x, j, P, c0); }
  // Row j's segment starts `lead` elements past a 16-byte boundary; its row
  // in shared memory starts there too.
  __device__ int lead(int j) const { return misalign(x, j, P, c0) / static_cast<int>(sizeof(T)); }
};

// Copy every row of the tile into s_rows (row j at j * stride elements,
// element i at lead + i): the 16-byte pieces by cp.async, the head before
// the row's first boundary and the tail after its last whole piece by
// plain loads, kScalarBatch a thread issued together before any is stored.
// Each element is copied once.
constexpr int kScalarBatch = 4;

template <typename T>
__device__ void stage_tile(const Tile<T>& t, T* s_rows, int stride, int J) {
  constexpr int V = 16 / sizeof(T);  // elements a piece
  const int per_row = t.width / V + 1;
  for (int p = threadIdx.x; p < J * per_row; p += kCombineThreads) {
    const int r = p / per_row, i = p % per_row;
    const int lead = t.lead(r);
    const int head = min((V - lead) % V, t.width);
    if (i < (t.width - head) / V)
      cp_async16(s_rows + r * stride + lead + head + i * V, t.seg(r) + head + i * V);
  }
  const int scalars = J * 2 * V;
  for (int p0 = threadIdx.x; p0 < scalars; p0 += kScalarBatch * kCombineThreads) {
    T v[kScalarBatch];
    int dst[kScalarBatch];
#pragma unroll
    for (int u = 0; u < kScalarBatch; ++u) {
      const int p = p0 + u * kCombineThreads;
      const int r = p / (2 * V), e = p % (2 * V);
      const int lead = t.lead(r);
      const int head = min((V - lead) % V, t.width);
      const int body = (t.width - head) / V * V;
      const int i = e < V ? e : head + body + e - V;
      dst[u] = -1;
      if (p < scalars && (e < V ? e < head : i < t.width)) {
        v[u] = t.seg(r)[i];
        dst[u] = r * stride + lead + i;
      }
    }
#pragma unroll
    for (int u = 0; u < kScalarBatch; ++u)
      if (dst[u] >= 0) s_rows[dst[u]] = v[u];
  }
}

// Shared memory of the staged trim: 16 bytes of n and k, the J scales, the
// active rows, 16-byte aligned; then the J staged rows of tile_cols +
// 16 / elt elements.
__host__ __device__ __forceinline__ long long trim_tile_offset(int J) {
  return (16 + 8LL * J + 15) / 16 * 16;
}

__host__ __device__ __forceinline__ long long trim_smem(int J, int tile_cols, int elt) {
  return trim_tile_offset(J) + static_cast<long long>(J) * (tile_cols + 16 / elt) * elt;
}

// Warp 0: the active rows in row order (a ballot a 32 rows), n and k; w0 is
// the lane's weight of rows 0..31, loaded before the tile's copies were
// issued.
__device__ __forceinline__ void trim_scalars(const CombineArgs& a, float w0, int* s_nk,
                                             int* s_act) {
  const int lane = threadIdx.x;
  int n = 0;
  for (int j0 = 0; j0 < a.J; j0 += 32) {
    const float wj = j0 == 0 ? w0 : j0 + lane < a.J ? a.w[j0 + lane] : 0.f;
    const unsigned on = __ballot_sync(0xffffffffu, wj > 0.f);
    if (wj > 0.f) s_act[n + __popc(on & ((1u << lane) - 1u))] = j0 + lane;
    n += __popc(on);
  }
  if (lane == 0) {
    s_nk[0] = n;
    s_nk[1] = trim_count(a.trim_frac, n);
  }
}

// Element i of staged row r in f32 (an int8 code times its row's scale).
template <bool kDequant, typename T>
__device__ __forceinline__ float staged(const T* s_rows, int stride, int lead, int r, int i,
                                       const float* s_scale) {
  const float v = static_cast<float>(s_rows[r * stride + lead + i]);
  return kDequant ? __fmul_rn(v, s_scale[r]) : v;
}

// A block stages its tile of every row, then thread i ranks column i's
// active values: rank = #{active q : x_q < x_p or (x_q == x_p and q < p)},
// the kept ones summed in row order. Every load is issued before anything
// waits on one: warp 0's weights and this thread's scale, then the tile.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
combine_trim_staged_kernel(const CombineArgs a) {
  constexpr bool kDequant = sizeof(T) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  int* const s_nk = reinterpret_cast<int*>(smem);
  float* const s_scale = reinterpret_cast<float*>(smem + 16);
  int* const s_act = reinterpret_cast<int*>(s_scale + a.J);
  T* const s_rows = reinterpret_cast<T*>(smem + trim_tile_offset(a.J));
  const int stride = a.tile_cols + 16 / static_cast<int>(sizeof(T));
  const int tiles = (a.P + a.tile_cols - 1) / a.tile_cols;
  const int i = threadIdx.x;  // this thread's column of the tile
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const bool first = tile == static_cast<int>(blockIdx.x);
    if (!first) __syncthreads();  // the previous tile is read
    const int c0 = tile * a.tile_cols;
    const Tile<T> t{static_cast<const T*>(a.x), a.P, c0, min(a.tile_cols, a.P - c0)};
    const float w0 = first && i < 32 && i < a.J ? a.w[i] : 0.f;
    const float si = first && kDequant && i < a.J ? row_scale(a.scales, i) : 0.f;
    stage_tile(t, s_rows, stride, a.J);
    if (first) {
      if (i < a.J) s_scale[i] = si;
      for (int r = i + kCombineThreads; kDequant && r < a.J; r += kCombineThreads)
        s_scale[r] = row_scale(a.scales, r);
      if (i < 32) trim_scalars(a, w0, s_nk, s_act);
    }
    cp_async_wait_all();
    __syncthreads();  // the tile has landed
    if (i < t.width) {
      const int n = s_nk[0], k = s_nk[1];
      float sum = 0.f;
      for (int p = 0; p < n; ++p) {
        const int rp = s_act[p];
        const float xp = staged<kDequant>(s_rows, stride, t.lead(rp), rp, i, s_scale);
        int rank = 0;
        for (int q = 0; q < n; ++q) {
          const int rq = s_act[q];
          const float xq = staged<kDequant>(s_rows, stride, t.lead(rq), rq, i, s_scale);
          rank += (xq < xp) || (xq == xp && q < p);
        }
        if (kept(rank, n, k)) sum = __fadd_rn(sum, xp);
      }
      a.out[c0 + i] = n == 0 ? 0.f : __fdiv_rn(sum, static_cast<float>(n - 2 * k));
    }
  }
}

constexpr int kMaxTrimRows = 1024;
constexpr long long kSmemLimit = 232448;  // a block of the H100, bytes

template <typename T>
int launch_combine(const CombineArgs& a, int trimmed, int grid, cudaStream_t s) {
  if (a.J < 1 || a.P < 1 || grid < 1 || (trimmed && a.J > kMaxTrimRows))
    return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {const_cast<CombineArgs*>(&a)};
  if (!trimmed || a.J <= kDirectRows) {
    if (a.tile_cols != kDirectThreads) return static_cast<int>(cudaErrorInvalidValue);
    const void* k = trimmed ? trim_kernel_for<T, kDirectRows>(a.J)
                            : mean_kernel_for<T, kDirectRows>(min(a.J, kDirectRows));
    const cudaError_t launch = cudaLaunchKernel(k, dim3(grid), dim3(kDirectThreads), args, 0, s);
    return static_cast<int>(launch != cudaSuccess ? launch : cudaGetLastError());
  }
  const long long bytes = trim_smem(a.J, a.tile_cols, sizeof(T));
  if (a.tile_cols < 16 || a.tile_cols > kCombineThreads || a.tile_cols % 16 ||
      bytes > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* k = reinterpret_cast<const void*>(combine_trim_staged_kernel<T>);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaError_t launch = cudaLaunchKernel(k, dim3(grid), dim3(kCombineThreads), args,
                                              static_cast<size_t>(bytes), s);
  return static_cast<int>(launch != cudaSuccess ? launch : cudaGetLastError());
}

}  // namespace

extern "C" {

// x, noise: (J, P) f32; mask: (J,) f32; ref: (P,) f32 or null; noise may be
// null when noise_std == 0. y: (J, P) f32 output (the scratch when
// quantize != 0); q: (J, P) int8 and scales: (J,) f32 when quantizing;
// norm_parts (clip) and max_parts (quantize): (J, C) f32 scratch. The plan:
// C chunks of `chunk` floats a row (chunk % 4 == 0, C chunk >= P), loads
// `vec` (1, 2 or 4) floats wide (P % vec == 0, pointers 4 vec-byte aligned).
int repro_fused_upload(const float* x, const float* mask, const float* noise,
                       const float* ref, float* y, int8_t* q, float* scales,
                       float* norm_parts, float* max_parts, int J, int P, int C,
                       int chunk, int vec, int clip, float clip_norm,
                       float noise_std, int quantize, void* stream) {
  if (J < 1 || J > 65535 || C < 1 || chunk % 4 != 0 ||
      static_cast<long long>(C) * chunk < P || (vec != 1 && vec != 2 && vec != 4) || P % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  const UploadArgs a{x, mask, noise, ref, y, q, scales, norm_parts, max_parts,
                     P, C, chunk, clip, quantize, clip_norm, noise_std};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec == 4 ? launch_upload<4>(a, J, s)
                  : vec == 2 ? launch_upload<2>(a, J, s) : launch_upload<1>(a, J, s);
}

// x: (J, P) f32; w: (J,) f32; out: (P,) f32, 16-byte aligned. The plan
// (kernels/wire.py combine_plan): the mean takes tile_cols = 512 columns a
// block step; the trim tiles of tile_cols columns (a multiple of 16,
// 16..256), J <= 1024. grid blocks stride over the tiles.
int repro_fused_combine_f32(const float* x, const float* w, float* out, int J, int P,
                            int trimmed, float trim_frac, int tile_cols, int grid,
                            void* stream) {
  const CombineArgs a{x, nullptr, w, out, J, P, tile_cols, trim_frac};
  return launch_combine<float>(a, trimmed, grid, static_cast<cudaStream_t>(stream));
}

// q: (J, P) int8 with per-row scales (J,) f32, dequantized in-kernel.
int repro_fused_combine_i8(const int8_t* q, const float* scales, const float* w, float* out,
                           int J, int P, int trimmed, float trim_frac, int tile_cols, int grid,
                           void* stream) {
  const CombineArgs a{q, scales, w, out, J, P, tile_cols, trim_frac};
  return launch_combine<int8_t>(a, trimmed, grid, static_cast<cudaStream_t>(stream));
}

// The trimmed combine's shared memory for J rows and a tile, in bytes
// (elt: 4 or 1).
long long repro_trim_smem_bytes(int J, int tile_cols, int elt) {
  return trim_smem(J, tile_cols, elt);
}

}  // extern "C"
