// Fused Gaussian reparametrization + STL log q, forward and backward,
// hand-written for Hopper (sm_90a).
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes. Every
// entry launches on the caller's stream, allocates nothing (the Python
// wrapper allocates the outputs, and keeps the forward's scratch) and returns
// cudaGetLastError() after its launch. Inputs are f32 or bf16 (all three of
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
// Design: ONE launch (the plan is kernels/reparam.py reparam_plan).
//   * Loads and stores are 16 bytes (float4, or 8 bf16 values) when all
//     four pointers are 16-byte aligned, with the N % V elements past the
//     last whole vector taken one a thread; else every element is scalar.
//   * The grid is sized to the card, not to a block of elements: one
//     vector a thread, capped at the SMs times the 256-thread blocks an SM
//     holds, and a grid-stride loop past that, so every SM has enough
//     warps to keep the bytes in flight.
//   * Each block reduces its logq terms (warp shuffles, then shared memory)
//     to one partial and writes it to the scratch. Thread 0 then takes a
//     ticket (an acquire-release add on the scratch's counter); the block
//     that draws the last ticket sums all partials in index order (each
//     thread's few at once, then the same block tree), writes logq and
//     sets the counter back to 0 for the next call. No atomic touches a
//     value, so a run repeats bit for bit for a given N and card.
//   * The scratch (the counter, then the partials) is the wrapper's, one
//     per (device, stream), zeroed once: calls on one stream run in turn,
//     calls on two streams never share a counter.
// The JAX kernel pads to its block with eps = ls = 0 and corrects the
// pad's constant terms afterwards; here nothing is padded, and the sum is
// the same.
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
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxParts = 8;  // the forward's grid is at most kMaxParts * kThreads blocks
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

// V elements of T at p as f32: one 16-byte load when V * sizeof(T) == 16.
template <typename T, int V>
__device__ __forceinline__ void load_f32(const T* __restrict__ p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = to_f32(*p);
  } else {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if constexpr (V == 4) {
        f[i] = __uint_as_float(w[i]);
      } else {  // bf16 pairs: the lower element in the low half
        f[i] = __uint_as_float((i & 1) ? (w[i >> 1] & 0xffff0000u) : (w[i >> 1] << 16));
      }
    }
  }
}

// V f32 values rounded to T (to nearest even) and stored at p.
template <typename T, int V>
__device__ __forceinline__ void store_f32(T* __restrict__ p, const float (&f)[V]) {
  if constexpr (V == 1) {
    *p = from_f32<T>(f[0]);
  } else {
    unsigned int w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (V == 4) {
        w[i] = __float_as_uint(f[i]);
      } else {
        const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
        w[i] = *reinterpret_cast<const unsigned int*>(&h);
      }
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// z = mu + e^ls eps of V elements at offset i; returns their logq terms.
template <typename T, int V>
__device__ __forceinline__ float fwd_elems(const T* __restrict__ mu, const T* __restrict__ ls,
                                           const T* __restrict__ eps, T* __restrict__ z,
                                           long long i) {
  float m[V], l[V], e[V], out[V];
  load_f32<T, V>(mu + i, m);
  load_f32<T, V>(ls + i, l);
  load_f32<T, V>(eps + i, e);
  float lq = 0.0f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    out[k] = __fadd_rn(m[k], __fmul_rn(expf(l[k]), e[k]));
    lq += -0.5f * e[k] * e[k] - l[k] - kHalfLog2Pi;
  }
  store_f32<T, V>(z + i, out);
  return lq;
}

// scratch[0]: the ticket counter (0 between calls); scratch[1 ..]: the
// blocks' partials (f32), one a block.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
reparam_fwd_kernel(const T* __restrict__ mu, const T* __restrict__ ls,
                   const T* __restrict__ eps, T* __restrict__ z,
                   unsigned int* scratch, float* __restrict__ logq, long long n) {
  float* const partials = reinterpret_cast<float*>(scratch + 1);
  const long long nvec = n / V;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  float lq = 0.0f;
  for (long long v = tid; v < nvec; v += stride) lq += fwd_elems<T, V>(mu, ls, eps, z, v * V);
  if (nvec * V + tid < n) lq += fwd_elems<T, 1>(mu, ls, eps, z, nvec * V + tid);  // the tail
  lq = block_sum<kThreads>(lq);

  __shared__ float own;
  __shared__ bool last;
  if (threadIdx.x == 0) {
    own = lq;
    partials[blockIdx.x] = lq;
    // The ticket, taken with release (this block's partial is visible
    // before it) and acquire (every partial whose ticket came before is
    // visible after it; the barrier below passes that on to the block).
    unsigned int ticket;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;"
                 : "=r"(ticket) : "l"(scratch) : "memory");
    last = ticket == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // Thread t sums partials t, t + kThreads, ... in turn; its loads are
  // issued together (at most kMaxParts a thread).
  float part[kMaxParts];
#pragma unroll
  for (int k = 0; k < kMaxParts; ++k) {
    const int b = threadIdx.x + k * kThreads;
    part[k] = b >= static_cast<int>(gridDim.x)        ? 0.0f
              : b == static_cast<int>(blockIdx.x) ? own
                                                  : __ldcg(partials + b);
  }
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxParts; ++k) sum += part[k];
  sum = block_sum<kThreads>(sum);
  if (threadIdx.x == 0) {
    *logq = sum;
    *scratch = 0u;  // the ticket counter, ready for the next call
  }
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

template <typename T, int V>
int launch_fwd(const void* mu, const void* ls, const void* eps, void* z, unsigned int* scratch,
               float* logq, long long n, int grid, cudaStream_t s) {
  reparam_fwd_kernel<T, V><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(mu), static_cast<const T*>(ls), static_cast<const T*>(eps),
      static_cast<T*>(z), scratch, logq, n);
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

// mu, ls, eps, z: (n,) of one type (bf16 when is_bf16, else f32); logq: one
// f32. scratch: 1 + capacity 32-bit words, word 0 zero (the ticket
// counter; the kernel leaves it zero). vec: 16 / element size (every
// pointer 16-byte aligned) or 1; grid: 1 .. capacity blocks. n >= 1.
int repro_reparam_fwd(const void* mu, const void* ls, const void* eps, void* z,
                      unsigned int* scratch, int capacity, float* logq, long long n, int vec,
                      int grid, int is_bf16, void* stream) {
  const int wide = is_bf16 ? 8 : 4;
  const bool aligned = (reinterpret_cast<uintptr_t>(mu) | reinterpret_cast<uintptr_t>(ls) |
                        reinterpret_cast<uintptr_t>(eps) | reinterpret_cast<uintptr_t>(z)) %
                           16 == 0;
  if (n < 1 || grid < 1 || grid > capacity || grid > kMaxParts * kThreads ||
      (vec != 1 && vec != wide) ||
      (vec == wide && !aligned))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return vec == 1 ? launch_fwd<__nv_bfloat16, 1>(mu, ls, eps, z, scratch, logq, n, grid, s)
                    : launch_fwd<__nv_bfloat16, 8>(mu, ls, eps, z, scratch, logq, n, grid, s);
  return vec == 1 ? launch_fwd<float, 1>(mu, ls, eps, z, scratch, logq, n, grid, s)
                  : launch_fwd<float, 4>(mu, ls, eps, z, scratch, logq, n, grid, s);
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
