// RMSNorm over the rows of a matrix, hand-written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/rmsnorm.py:23 rmsnorm_rows (body :17; wrapper
// src/repro/kernels/ops.py:91 rmsnorm):
//
//   out[r, :] = ((x32 * rsqrt(mean(x32 * x32) + eps)) * w32)  cast to x's type
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes. The
// entry launches on the caller's stream, allocates nothing and returns
// cudaGetLastError(). x and out are (rows, d) row-major of one type (f32 or
// bf16); w is (d,), f32 or bf16 independently of x.
//
// What bounds it: bytes. Each row is read, reduced and written once; the
// weight row stays in L1/L2. A few flops an element.
// Design: d >= 1024 (the backbone's d_model rows: 2,560, 3,584, and mamba2's
// gated 7,168) gets one 256-thread block per row; narrower rows (qk-norm's
// head_dim 128) get one warp per row, eight rows a block, so a block still
// moves a few KB. The sum of squares is f32, by warp shuffles (and, for the
// block kernel, a second warp over the warps' sums). The scale is
// 1 / sqrtf(sum / d + eps), both correctly rounded, and the output is
// (x32 * rms) * w32 rounded as the JAX expression rounds it (__fmul_rn: no
// contraction). The second pass rereads x, which the first pass left in L1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRowThreads = 256;  // one block per row
constexpr int kWarpRows = 8;      // rows per block in the warp-per-row kernel
constexpr int kWideRow = 1024;    // rows at least this wide take a block each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, typename W>
__device__ __forceinline__ void write_row(const T* __restrict__ xr, const W* __restrict__ w,
                                          T* __restrict__ orow, int d, float rms, int first,
                                          int stride) {
  for (int i = first; i < d; i += stride)
    orow[i] = from_f32<T>(__fmul_rn(__fmul_rn(to_f32(xr[i]), rms), to_f32(w[i])));
}

template <typename T, typename W>
__global__ void __launch_bounds__(kRowThreads)
rmsnorm_block_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
                     int d, float eps) {
  __shared__ float warp_sums[kRowThreads / 32];
  __shared__ float s_rms;
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float ss = 0.0f;
  for (int i = threadIdx.x; i < d; i += kRowThreads) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kRowThreads / 32 ? warp_sums[lane] : 0.0f;
    v = warp_sum(v);
    if (lane == 0) s_rms = 1.0f / sqrtf(v / static_cast<float>(d) + eps);
  }
  __syncthreads();
  write_row(xr, w, out + row * d, d, s_rms, threadIdx.x, kRowThreads);
}

template <typename T, typename W>
__global__ void __launch_bounds__(kWarpRows * 32)
rmsnorm_warp_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
                    long long rows, int d, float eps) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarpRows + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp leaves together
  const int lane = threadIdx.x % 32;
  const T* xr = x + row * d;
  float ss = 0.0f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  ss = warp_sum(ss);  // every lane holds the row's sum
  const float rms = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);
  write_row(xr, w, out + row * d, d, rms, lane, 32);
}

template <typename T, typename W>
int launch(const void* x, const void* w, void* out, long long rows, int d, float eps,
           cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  T* op = static_cast<T*>(out);
  if (d >= kWideRow) {
    rmsnorm_block_kernel<T, W><<<static_cast<unsigned>(rows), kRowThreads, 0, s>>>(
        xp, wp, op, d, eps);
  } else {
    const long long blocks = (rows + kWarpRows - 1) / kWarpRows;
    rmsnorm_warp_kernel<T, W><<<static_cast<unsigned>(blocks), kWarpRows * 32, 0, s>>>(
        xp, wp, op, rows, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, out: (rows, d) contiguous, bf16 when x_bf16 else f32; w: (d,), bf16 when
// w_bf16 else f32. rows >= 1 (at most 2^31 - 1 when d >= 1024), d >= 1.
int repro_rmsnorm(const void* x, const void* w, void* out, long long rows, int d, float eps,
                  int x_bf16, int w_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return w_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d, eps, s)
                  : launch<__nv_bfloat16, float>(x, w, out, rows, d, eps, s);
  }
  return w_bf16 ? launch<float, __nv_bfloat16>(x, w, out, rows, d, eps, s)
                : launch<float, float>(x, w, out, rows, d, eps, s);
}

}  // extern "C"
