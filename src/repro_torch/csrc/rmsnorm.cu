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
// What bounds it: bytes. Each row is read once and written once; a few
// flops an element.
//
// Design (the launch plan is computed by the Python wrapper,
// repro_torch/kernels/rmsnorm.py:_rmsnorm_plan, and passed in):
//   * Vector access: a "vector" is 16 bytes of x (8 bf16 or 4 f32) when d
//     and the base addresses allow it, else one element (the scalar
//     route). Lane l of a row owns vectors l, l + lanes, l + 2 lanes, ...
//   * One read of x: a lane issues all its loads of a row at once and holds
//     the vectors in registers, as raw 32-bit words (a bf16 vector is 4),
//     from the sum of squares to the write.
//   * Rows by lanes: 256-thread blocks; a row takes `lanes` lanes, a power
//     of two. lanes <= 32: a row inside one warp (qk-norm's d = 128 in bf16
//     is 16 vectors on 4 lanes, eight rows a warp), reduced by shuffles
//     alone. lanes > 32: a few warps a row, each warp's partial sum
//     exchanged through shared memory (double-buffered: one barrier a row
//     step, a named barrier of the row's warps alone, so the block's rows
//     do not wait on each other).
//   * Tried on the H100 and dropped: loading the next row while reducing
//     this one (twice the registers, fewer resident warps: slower), more
//     resident blocks by capping registers (spills: slower), one warp for
//     every row of up to 2,560 elements (slower at 2,560 and 128), and
//     evict-first cache hints (within 2 %, and they would push out of L2
//     the data the next kernel reads).
//   * Grid sized to the card: `grid` blocks (the SMs times the resident
//     blocks an SM, at most) stride over the rows, 256 / lanes rows a step.
//     A block copies the weight into shared memory once; each row reads its
//     vectors from there.
// Numerics: the sum of squares is f32 (fmaf, each lane's vectors in
// order, then an xor shuffle tree over the row's lanes, then the warps'
// partials in order); the scale is 1 / sqrtf(sum / d + eps), both
// correctly rounded, and the output (x32 * rms) * w32 rounded as the JAX
// expression rounds it (__fmul_rn: no contraction).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // every block; the plan's rows_per_block is kThreads / lanes
constexpr int kWarps = kThreads / 32;

// N elements of T as raw 32-bit words (a bf16 pair shares a word, the lower
// element in the low half), moved by one access: 16 bytes (LDG/STG.128)
// for a vector of x, 8 or 32 bytes for the weight's matching vector, one
// element on the scalar route.
template <typename T, int N>
struct Raw {
  static constexpr int kBytes = N * static_cast<int>(sizeof(T));
  static constexpr int kWords = kBytes < 4 ? 1 : kBytes / 4;
  unsigned int w[kWords];
};

template <typename T, int N>
__device__ __forceinline__ Raw<T, N> load_raw(const T* __restrict__ p) {
  Raw<T, N> r;
  constexpr int kBytes = Raw<T, N>::kBytes;
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[c];
      r.w[4 * c] = u.x;
      r.w[4 * c + 1] = u.y;
      r.w[4 * c + 2] = u.z;
      r.w[4 * c + 3] = u.w;
    }
  } else if constexpr (kBytes == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    r.w[0] = u.x;
    r.w[1] = u.y;
  } else if constexpr (kBytes == 4) {
    r.w[0] = *reinterpret_cast<const unsigned int*>(p);
  } else {
    r.w[0] = *reinterpret_cast<const unsigned short*>(p);
  }
  return r;
}

template <typename T, int N>
__device__ __forceinline__ void store_raw(T* __restrict__ p, const Raw<T, N>& r) {
  constexpr int kBytes = Raw<T, N>::kBytes;
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c)
      reinterpret_cast<uint4*>(p)[c] =
          make_uint4(r.w[4 * c], r.w[4 * c + 1], r.w[4 * c + 2], r.w[4 * c + 3]);
  } else if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(r.w[0], r.w[1]);
  } else if constexpr (kBytes == 4) {
    *reinterpret_cast<unsigned int*>(p) = r.w[0];
  } else {
    *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(r.w[0]);
  }
}

// The weight's vector at p in shared memory. The loads are volatile asm so
// that the compiler reads them at each row and does not hoist them (and the
// f32 values made from them) out of the row loop into registers.
template <typename W, int N>
__device__ __forceinline__ Raw<W, N> lds_raw(const W* p) {
  Raw<W, N> r;
  constexpr int kBytes = Raw<W, N>::kBytes;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c)
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(r.w[4 * c]), "=r"(r.w[4 * c + 1]), "=r"(r.w[4 * c + 2]),
                     "=r"(r.w[4 * c + 3])
                   : "r"(a + 16 * c));
  } else if constexpr (kBytes == 8) {
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];" : "=r"(r.w[0]), "=r"(r.w[1]) : "r"(a));
  } else if constexpr (kBytes == 4) {
    asm volatile("ld.shared.u32 %0, [%1];" : "=r"(r.w[0]) : "r"(a));
  } else {
    asm volatile("ld.shared.u16 %0, [%1];" : "=r"(r.w[0]) : "r"(a));
  }
  return r;
}

// Element e of a Raw as f32 (bf16 -> f32 is exact: the bits shifted up).
template <typename T, int N>
__device__ __forceinline__ float elem(const Raw<T, N>& r, int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(r.w[e]);
  } else {
    const unsigned int word = r.w[e >> 1];
    return __uint_as_float((e & 1) ? (word & 0xffff0000u) : (word << 16));
  }
}

// N f32 values rounded to T (round to nearest even, as astype).
template <typename T, int N>
__device__ __forceinline__ Raw<T, N> from_f32(const float (&v)[N]) {
  Raw<T, N> r;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < N; ++i) r.w[i] = __float_as_uint(v[i]);
  } else if constexpr (N == 1) {
    const __nv_bfloat16 h = __float2bfloat16(v[0]);
    r.w[0] = *reinterpret_cast<const unsigned short*>(&h);
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      r.w[i] = *reinterpret_cast<const unsigned int*>(&h);
    }
  }
  return r;
}

// Resident blocks the compiler should plan registers for: four while a
// lane's x slots take at most 32 registers, else three, else two.
template <typename T, int VEC, int VMAX>
constexpr int min_blocks() {
  constexpr int regs = VMAX * Raw<T, VEC>::kWords;
  return regs <= 32 ? 4 : regs <= 48 ? 3 : 2;
}

// One launch. VEC: elements of x a vector (16 / sizeof(T), or 1);
// VMAX: the register slots a lane holds (>= vpl, the vectors it owns).
// Dynamic shared memory: the weight, d * sizeof(W) bytes (16-byte rounded).
template <typename T, typename W, int VEC, int VMAX>
__global__ void __launch_bounds__(kThreads, (min_blocks<T, VEC, VMAX>()))
rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
               long long rows, int d, float eps, int lanes, int vpl) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float partial[2][kWarps];
  W* const wsm = reinterpret_cast<W*>(smem);
  const int tid = threadIdx.x;
  const int lane = tid & (lanes - 1);  // the lane within its row
  const int group = tid / lanes;       // the row within the block's step
  const int groups = kThreads / lanes;
  const int nvec = d / VEC;
  const int shuffle_width = lanes < 32 ? lanes : 32;

  for (int c = tid; c < nvec; c += kThreads)
    store_raw<W, VEC>(wsm + c * VEC, load_raw<W, VEC>(w + static_cast<long long>(c) * VEC));
  __syncthreads();

  int buf = 0;
  const long long step = static_cast<long long>(gridDim.x) * groups;
  // Every thread of the block runs the same number of steps (a row past
  // the end loads nothing and stores nothing), so each barrier is uniform.
  for (long long r0 = static_cast<long long>(blockIdx.x) * groups; r0 < rows; r0 += step) {
    const long long row = r0 + group;
    const bool live = row < rows;
    const T* xr = x + row * d;
    // All of the row's loads first (predicated, zeros elsewhere), then the
    // arithmetic: the loads are in flight together.
    Raw<T, VEC> xv[VMAX];
#pragma unroll
    for (int i = 0; i < VMAX; ++i) {
      const int c = lane + i * lanes;
      xv[i] = Raw<T, VEC>{};
      if (live && i < vpl && c < nvec)
        xv[i] = load_raw<T, VEC>(xr + static_cast<long long>(c) * VEC);
    }
    // Zero slots add +0 to a sum that is never -0: the order of the owned
    // vectors' terms is all that counts.
    float ss = 0.0f;
#pragma unroll
    for (int i = 0; i < VMAX; ++i) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float v = elem(xv[i], e);
        ss = fmaf(v, v, ss);
      }
    }
    for (int o = shuffle_width / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lanes > 32) {  // the row's warps meet at their own barrier (id 1 + group)
      const int warps = lanes / 32;
      if ((tid & 31) == 0) partial[buf][tid / 32] = ss;
      asm volatile("bar.sync %0, %1;" : : "r"(1 + group), "r"(lanes) : "memory");
      ss = 0.0f;
      for (int k = 0; k < warps; ++k) ss += partial[buf][group * warps + k];
      buf ^= 1;
    }
    const float rms = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);
    T* orow = out + row * d;
#pragma unroll
    for (int i = 0; i < VMAX; ++i) {
      const int c = lane + i * lanes;
      if (live && i < vpl && c < nvec) {
        const Raw<W, VEC> wv = lds_raw<W, VEC>(wsm + c * VEC);
        float o[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          o[e] = __fmul_rn(__fmul_rn(elem(xv[i], e), rms), elem(wv, e));
        store_raw<T, VEC>(orow + static_cast<long long>(c) * VEC, from_f32<T, VEC>(o));
      }
    }
  }
}

// The kernel for (T, W, VEC) whose VMAX is the smallest slot count >= vpl,
// or nullptr when vpl is over the route's cap (16 vectors, 32 scalars).
template <typename T, typename W, int VEC>
const void* pick(int vpl) {
  if (vpl <= 1) return reinterpret_cast<const void*>(rmsnorm_kernel<T, W, VEC, 1>);
  if (vpl <= 2) return reinterpret_cast<const void*>(rmsnorm_kernel<T, W, VEC, 2>);
  if (vpl <= 4) return reinterpret_cast<const void*>(rmsnorm_kernel<T, W, VEC, 4>);
  if (vpl <= 8) return reinterpret_cast<const void*>(rmsnorm_kernel<T, W, VEC, 8>);
  if (vpl <= 12) return reinterpret_cast<const void*>(rmsnorm_kernel<T, W, VEC, 12>);
  if (vpl <= 16) return reinterpret_cast<const void*>(rmsnorm_kernel<T, W, VEC, 16>);
  if constexpr (VEC == 1) {
    if (vpl <= 32) return reinterpret_cast<const void*>(rmsnorm_kernel<T, W, 1, 32>);
  }
  return nullptr;
}

template <typename T, typename W>
const void* pick_route(int vector, int vpl) {
  return vector ? pick<T, W, 16 / sizeof(T)>(vpl) : pick<T, W, 1>(vpl);
}

const void* kernel_for(int x_bf16, int w_bf16, int vector, int vpl) {
  if (x_bf16) {
    return w_bf16 ? pick_route<__nv_bfloat16, __nv_bfloat16>(vector, vpl)
                  : pick_route<__nv_bfloat16, float>(vector, vpl);
  }
  return w_bf16 ? pick_route<float, __nv_bfloat16>(vector, vpl)
                : pick_route<float, float>(vector, vpl);
}

// The weight's shared memory, and the opt-in above the 48 KB default.
int weight_smem(const void* kernel, int d, int w_bf16, size_t* bytes) {
  *bytes = (static_cast<size_t>(d) * (w_bf16 ? 2 : 4) + 15) / 16 * 16;
  if (*bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(*bytes)));
}

bool valid_lanes(int lanes) {
  return lanes >= 1 && lanes <= kThreads && (lanes & (lanes - 1)) == 0;
}

}  // namespace

extern "C" {

// Resident 256-thread blocks an SM for the kernel of this route, slot
// count and row width, written to *blocks (the plan sizes its grid with it).
int repro_rmsnorm_blocks_per_sm(int x_bf16, int w_bf16, int vector, int vpl, int d,
                                int* blocks) {
  const void* k = kernel_for(x_bf16, w_bf16, vector, vpl);
  if (k == nullptr || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  size_t bytes = 0;
  const int err = weight_smem(k, d, w_bf16, &bytes);
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, kThreads,
                                                                        bytes));
}

// x, out: (rows, d) contiguous, bf16 when x_bf16 else f32; w: (d,), bf16 when
// w_bf16 else f32. vector: 16-byte vectors (d a multiple of 16 / sizeof(x),
// x, w and out 16-byte aligned), else one element at a time. lanes (a power
// of two <= 256) own each row, vpl vectors each (lanes * vpl covers the row);
// grid blocks of 256 threads stride over the rows. rows >= 1, d >= 1.
int repro_rmsnorm(const void* x, const void* w, void* out, long long rows, int d, float eps,
                  int x_bf16, int w_bf16, int vector, int lanes, int vpl, int grid,
                  void* stream) {
  const int vec = vector ? (x_bf16 ? 8 : 4) : 1;
  const void* k = kernel_for(x_bf16, w_bf16, vector, vpl);
  if (k == nullptr || !valid_lanes(lanes) || grid < 1 || d < 1 || d % vec != 0 ||
      static_cast<long long>(lanes) * vpl * vec < d)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t bytes = 0;
  const int err = weight_smem(k, d, w_bf16, &bytes);
  if (err != 0) return err;
  // The kernels differ only in their pointers' element types: one argument
  // list serves them all.
  void* args[] = {&x, &w, &out, &rows, &d, &eps, &lanes, &vpl};
  const cudaError_t launch = cudaLaunchKernel(k, dim3(grid), dim3(kThreads), args, bytes,
                                              static_cast<cudaStream_t>(stream));
  return static_cast<int>(launch != cudaSuccess ? launch : cudaGetLastError());
}

}  // extern "C"
