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
// Kernel 1: upload_kernel  (replaces src/repro/kernels/wire.py:91 _upload_kernel
//           / :137 fused_upload)
//
// Per silo row of the (J, P) wire matrix: delta from the broadcast reference
// -> L2 clip to C (max(norm, 1e-12) guard) -> + z*C*noise -> + reference ->
// participation-mask select (reference or zeros) -> optional symmetric int8
// quantization with ONE scale per row (max|y|/127 + 1e-12).
//
// What bounds it: bytes. Each element is read and written a few times and
// costs a handful of flops, far below the card's 295 flops/byte balance.
// The clip norm and the int8 scale are row-global reductions, so a row needs
// two barriers' worth of block-wide reduction before its output is final.
//
// Design: one block per row (1024 threads, strided loop over P), three
// passes: (1) block-reduce sum((x-ref)^2) in f32 (warp shuffles, then shared
// memory); (2) compute y, write it (to the output, or to an f32 scratch the
// wrapper allocates when quantizing) and block-reduce max|y|; (3) re-read y
// and write the int8 codes. Each thread re-reads only elements it wrote
// itself, so pass 3 needs no extra barrier. The arithmetic follows the
// reference's order with __fmul_rn/__fadd_rn (no FMA contraction), rintf
// (round half to even, as jnp.round) and a true division by the scale.
// The DP noise is an input tensor (the reference draws threefry noise
// in-kernel from per-row keys; an in-kernel Philox draw is later work).
// Inactive rows skip the norm and ship the fallback directly.
// Known shortfall: only J blocks are busy (J = 10 on the main path, on 132
// SMs), so one SM streams each 400 KB row; splitting rows across blocks needs
// a cross-block reduction (a second pass or a cluster) and is later work.
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

constexpr int kUploadThreads = 1024;
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

__global__ void __launch_bounds__(kUploadThreads)
upload_kernel(const float* __restrict__ x, const float* __restrict__ mask,
              const float* __restrict__ noise, const float* __restrict__ ref,
              float* __restrict__ y, int8_t* __restrict__ q,
              float* __restrict__ scales, int P, int clip, float clip_norm,
              float noise_std, int quantize) {
  __shared__ float smem[33];
  const long long row = blockIdx.x;
  const float* xr = x + row * P;
  const float* nr = noise ? noise + row * P : nullptr;
  float* yr = y + row * P;
  const bool active = mask[row] > 0.5f;  // uniform across the block

  float factor = 1.f;
  if (clip && active) {
    float ss = 0.f;
    for (int c = threadIdx.x; c < P; c += blockDim.x) {
      const float d = ref ? __fsub_rn(xr[c], ref[c]) : xr[c];
      ss += d * d;
    }
    const float norm = sqrtf(block_reduce<false>(ss, smem));
    factor = fminf(1.f, clip_norm / fmaxf(norm, 1e-12f));
  }

  float amax = 0.f;
  for (int c = threadIdx.x; c < P; c += blockDim.x) {
    float v;
    if (!active) {
      v = ref ? ref[c] : 0.f;
    } else if (clip) {
      const float r = ref ? ref[c] : 0.f;
      float d = ref ? __fsub_rn(xr[c], r) : xr[c];
      d = __fmul_rn(d, factor);
      if (nr) d = __fadd_rn(d, __fmul_rn(noise_std, nr[c]));
      v = ref ? __fadd_rn(r, d) : d;
    } else {
      v = xr[c];
    }
    yr[c] = v;
    amax = fmaxf(amax, fabsf(v));
  }
  if (!quantize) return;

  const float m = block_reduce<true>(amax, smem);
  const float scale = __fadd_rn(__fdiv_rn(m, 127.f), 1e-12f);
  if (threadIdx.x == 0) scales[row] = scale;
  int8_t* qr = q + row * P;
  for (int c = threadIdx.x; c < P; c += blockDim.x) {
    const float t = rintf(__fdiv_rn(yr[c], scale));
    qr[c] = static_cast<int8_t>(fminf(fmaxf(t, -127.f), 127.f));
  }
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
// quantize != 0); q: (J, P) int8 and scales: (J,) f32 when quantizing.
int repro_fused_upload(const float* x, const float* mask, const float* noise,
                       const float* ref, float* y, int8_t* q, float* scales,
                       int J, int P, int clip, float clip_norm,
                       float noise_std, int quantize, void* stream) {
  upload_kernel<<<J, kUploadThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, mask, noise, ref, y, q, scales, P, clip, clip_norm, noise_std,
      quantize);
  return static_cast<int>(cudaGetLastError());
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
