// Fused Gaussian reparametrization + STL log q, forward and backward,
// hand-written for Hopper (sm_90a).
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes. Every
// entry launches on the caller's stream, allocates nothing (the Python
// wrapper allocates outputs and the partials with torch.empty) and returns
// cudaGetLastError() after each launch. Inputs are f32 or bf16 (all three of
// one type); the arithmetic is f32.
//
// ---------------------------------------------------------------------------
// Forward  (replaces src/repro/kernels/reparam.py:30 _reparam_kernel /
//           :57 reparam_stl)
//
//   z    = mu + exp(ls) * eps                              (mu's dtype)
//   logq = sum_i (-0.5 eps_i^2 - ls_i - 0.5 log 2 pi)      (f32 scalar)
//
// What bounds it: bytes (16 B an element in f32, 8 in bf16, a few flops).
// Design: launch 1 gives each block `block` consecutive elements (the JAX
// kernel's block, 4096 by default); its 256 threads stride over them,
// write z, and reduce their logq terms (warp shuffles, then shared memory)
// to ONE f32 partial per block. The tail block masks past N itself, so no
// padding is needed (the JAX kernel pads with eps = ls = 0 and corrects the
// pad's constant terms afterwards; the sum is the same). Launch 2 sums the
// partials in one block in a fixed order: deterministic, no atomicAdd.
//
// ---------------------------------------------------------------------------
// Backward  (replaces src/repro/kernels/reparam.py:39 _reparam_bwd_kernel /
//            :128 _reparam_bwd)
//
//   dmu = dz;  dls = dz * exp(ls) * eps - dlq;  deps = dz * exp(ls) - dlq * eps
//
// What bounds it: bytes (24 B an element in f32: 3 reads, 3 writes).
// Design: one grid-stride pass; dlq is read from device memory (a 0-d
// tensor), so the host never waits for the forward's result.
//
// z and the three gradients are rounded as the plain PyTorch version rounds
// them (__fmul_rn/__fadd_rn: nvcc contracts nothing into an FMA), so a bf16
// output equals the plain one instead of flipping a last bit.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSumThreads = 1024;
constexpr float kHalfLog2Pi = 0.91893853320467274178f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as jnp's astype
}

// Block-wide sum of one value a thread; the result is valid in thread 0.
template <int kBlock>
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kBlock / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0.0f;
  if (warp == 0) {
    v = lane < kBlock / 32 ? warp_sums[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
reparam_fwd_kernel(const T* __restrict__ mu, const T* __restrict__ ls,
                   const T* __restrict__ eps, T* __restrict__ z,
                   float* __restrict__ partials, long long n, int block) {
  const long long start = static_cast<long long>(blockIdx.x) * block;
  const long long stop = min(start + block, n);
  float lq = 0.0f;
  for (long long i = start + threadIdx.x; i < stop; i += kThreads) {
    const float m = to_f32(mu[i]), l = to_f32(ls[i]), e = to_f32(eps[i]);
    z[i] = from_f32<T>(__fadd_rn(m, __fmul_rn(expf(l), e)));
    lq += -0.5f * e * e - l - kHalfLog2Pi;
  }
  lq = block_sum<kThreads>(lq);
  if (threadIdx.x == 0) partials[blockIdx.x] = lq;
}

// One block: out[0] = sum of the n partials, in a fixed order.
__global__ void __launch_bounds__(kSumThreads)
sum_partials_kernel(const float* __restrict__ partials, float* __restrict__ out,
                    int n) {
  float v = 0.0f;
  for (int i = threadIdx.x; i < n; i += kSumThreads) v += partials[i];
  v = block_sum<kSumThreads>(v);
  if (threadIdx.x == 0) out[0] = v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
reparam_bwd_kernel(const T* __restrict__ ls, const T* __restrict__ eps,
                   const T* __restrict__ dz, const float* __restrict__ dlq_ptr,
                   T* __restrict__ dmu, T* __restrict__ dls, T* __restrict__ deps,
                   long long n) {
  const float dlq = dlq_ptr[0];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const float l = to_f32(ls[i]), e = to_f32(eps[i]), g = to_f32(dz[i]);
    const float sig = expf(l);
    dmu[i] = from_f32<T>(g);
    dls[i] = from_f32<T>(__fsub_rn(__fmul_rn(__fmul_rn(g, sig), e), dlq));
    deps[i] = from_f32<T>(__fsub_rn(__fmul_rn(g, sig), __fmul_rn(dlq, e)));
  }
}

template <typename T>
int launch_fwd(const void* mu, const void* ls, const void* eps, void* z,
               float* partials, float* logq, long long n, int block,
               cudaStream_t s) {
  const long long blocks = (n + block - 1) / block;
  reparam_fwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(mu), static_cast<const T*>(ls),
      static_cast<const T*>(eps), static_cast<T*>(z), partials, n, block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<1, kSumThreads, 0, s>>>(partials, logq,
                                                static_cast<int>(blocks));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* ls, const void* eps, const void* dz, const float* dlq,
               void* dmu, void* dls, void* deps, long long n, cudaStream_t s) {
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  reparam_bwd_kernel<T><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(ls), static_cast<const T*>(eps),
      static_cast<const T*>(dz), dlq, static_cast<T*>(dmu),
      static_cast<T*>(dls), static_cast<T*>(deps), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// mu, ls, eps, z: (n,) of one type (bf16 when is_bf16, else f32);
// partials: ceil(n / block) f32; logq: one f32. n >= 1, block >= 1.
int repro_reparam_fwd(const void* mu, const void* ls, const void* eps, void* z,
                      float* partials, float* logq, long long n, int block,
                      int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_fwd<__nv_bfloat16>(mu, ls, eps, z, partials, logq, n, block, s)
                 : launch_fwd<float>(mu, ls, eps, z, partials, logq, n, block, s);
}

// ls, eps, dz, dmu, dls, deps: (n,) of one type; dlq: one f32 on the device.
int repro_reparam_bwd(const void* ls, const void* eps, const void* dz,
                      const float* dlq, void* dmu, void* dls, void* deps,
                      long long n, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bwd<__nv_bfloat16>(ls, eps, dz, dlq, dmu, dls, deps, n, s)
                 : launch_bwd<float>(ls, eps, dz, dlq, dmu, dls, deps, n, s);
}

}  // extern "C"
