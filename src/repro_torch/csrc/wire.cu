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
// Kernel 2: combine_kernel  (replaces src/repro/kernels/wire.py:208
//           _combine_kernel / :242 fused_combine)
//
// Column-wise over the silo axis of the gathered (J, P) matrix: weighted mean
// (denominator guarded only at total == 0), or trimmed mean over rows with
// w > 0 (k = min(floor(tf*n), floor((n-1)/2)) dropped at each end, zeros when
// no row is active), with an optional in-kernel int8 dequantize (q * scale_j).
//
// What bounds it: bytes (J reads per column, one write). Design: one thread
// per column looping over j, so loads of a row are coalesced across the warp.
// The Pallas kernel sorts each column; here the trim is a rank count: for
// each active j, rank = #{active i : x_i < x_j or (x_i == x_j and i < j)},
// kept if k <= rank < n-k. Ties only swap places, so this equals
// sort-then-slice. It is O(J^2) per column; J <= 1024 is enforced by the
// wrapper. The Pallas grid's sequential order (wire.py:279) has no Hopper
// counterpart, and none is needed: columns are independent.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUploadThreads = 256;
constexpr int kCombineThreads = 256;

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

template <typename T>
__device__ __forceinline__ float load_row(const T* __restrict__ x,
                                          const float* __restrict__ scales,
                                          int j, long long c, int P) {
  const float v = static_cast<float>(x[static_cast<long long>(j) * P + c]);
  return scales ? __fmul_rn(v, scales[j]) : v;
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const T* __restrict__ x, const float* __restrict__ scales,
               const float* __restrict__ w, float* __restrict__ out, int J,
               int P, int trimmed, float trim_frac) {
  const long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= P) return;

  if (!trimmed) {
    float total = 0.f, acc = 0.f;
    for (int j = 0; j < J; ++j) {
      total = __fadd_rn(total, w[j]);
      acc = __fadd_rn(acc, __fmul_rn(w[j], load_row(x, scales, j, c, P)));
    }
    out[c] = acc / (total > 0.f ? total : 1.f);
    return;
  }

  int n = 0;
  for (int j = 0; j < J; ++j) n += w[j] > 0.f;
  if (n == 0) {
    out[c] = 0.f;
    return;
  }
  const float nf = static_cast<float>(n);
  const int k = static_cast<int>(
      fminf(floorf(__fmul_rn(trim_frac, nf)), floorf((nf - 1.f) / 2.f)));
  float sum = 0.f;
  int kept = 0;
  for (int j = 0; j < J; ++j) {
    if (!(w[j] > 0.f)) continue;
    const float xj = load_row(x, scales, j, c, P);
    int rank = 0;
    for (int i = 0; i < J; ++i) {
      if (!(w[i] > 0.f)) continue;
      const float xi = load_row(x, scales, i, c, P);
      rank += (xi < xj) || (xi == xj && i < j);
    }
    if (rank >= k && rank < n - k) {
      sum = __fadd_rn(sum, xj);
      ++kept;
    }
  }
  out[c] = sum / static_cast<float>(kept > 1 ? kept : 1);
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

// x: (J, P) f32; w: (J,) f32; out: (P,) f32.
int repro_fused_combine_f32(const float* x, const float* w, float* out, int J,
                            int P, int trimmed, float trim_frac, void* stream) {
  const int blocks = (P + kCombineThreads - 1) / kCombineThreads;
  combine_kernel<float><<<blocks, kCombineThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, nullptr, w, out, J, P, trimmed, trim_frac);
  return static_cast<int>(cudaGetLastError());
}

// q: (J, P) int8 with per-row scales (J,) f32, dequantized in-kernel.
int repro_fused_combine_i8(const int8_t* q, const float* scales, const float* w,
                           float* out, int J, int P, int trimmed,
                           float trim_frac, void* stream) {
  const int blocks = (P + kCombineThreads - 1) / kCombineThreads;
  combine_kernel<int8_t><<<blocks, kCombineThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      q, scales, w, out, J, P, trimmed, trim_frac);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
