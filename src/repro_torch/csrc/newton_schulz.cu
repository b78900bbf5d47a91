// Newton–Schulz step and square root of the full-covariance W2 barycenter,
// hand-written for Hopper (sm_90a).
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes. The
// entry launches on the caller's stream, allocates nothing (the Python
// wrapper allocates t and both outputs with torch.empty) and returns
// cudaGetLastError() after each launch.
//
// ---------------------------------------------------------------------------
// newton_schulz_step  (replaces src/repro/kernels/wire.py:296 _ns_step_kernel
//                      / :310 newton_schulz_step)
//
// For each b of a batch of B (d, d) f32 pairs (y_b, z_b):
//   t = 0.5 * (3I - z_b y_b);   y_b <- y_b t;   z_b <- t z_b.
// The Pallas kernel keeps t in VMEM between its three products; the JAX
// package vmaps it over the J silo covariances (a batch grid axis).
//
// What bounds it: operations at large d (3 * 2d^3 flops on 3 * 4d^2 bytes
// read and 2 * 4d^2 written), launch latency at the barycenter's own d = 5
// (its bound is below a nanosecond; two launches cost microseconds).
//
// Design: two launches per step, both the same shared-memory-tiled SIMT GEMM
// (32 x 32 output tiles, 16-deep k-slabs, 256 threads, 2 x 2 outputs a
// thread, FP32 FMA, any d: the ragged edge is masked with zeros).
//   launch 1, grid (tiles, tiles, B):  t_b = 0.5 * (3I - z_b y_b)  (fused
//             epilogue), written to a scratch the wrapper allocates;
//   launch 2, grid (tiles, tiles, 2B): block z < B computes y_b t_b, block
//             z >= B computes t_b z_b, from that t.
// The launch boundary is the grid-wide barrier between t and its two
// consumers: a tile of y t needs a whole row panel of t. No TF32 and no
// wgmma: the barycenter runs 4,000 steps a round and is held to f32 parity,
// which TF32's 10-bit mantissa would not keep. Known shortfalls (later
// work): two launches per step, SIMT FP32 instead of tensor cores, and at
// d = 5 one block of 256 threads of which 25 own an output. The barycenter
// takes its roots from the root kernel below; the step kernel serves the
// roots above that kernel's limit d (the wrapper dispatches by shape).
// ---------------------------------------------------------------------------
// sqrtm_newton_schulz  (replaces src/repro/kernels/wire.py:335
//                       sqrtm_newton_schulz_fused: a fori_loop of num_iters
//                       Pallas steps, which XLA compiles into one program)
//
// For each b of a batch of B (d, d) f32 matrices m_b, in one launch:
//   norm = sqrt(sum m_b^2) + 1e-12;  y = m_b / norm;  z = I;
//   num_iters times: t = 0.5 * (3I - z y);  y <- y t;  z <- t z;
//   out_b = y * sqrt(norm).
// What bounds it: launch latency and the steps' chain of block barriers at
// the barycenter's d = 5 (40 dependent steps; the bound on bytes and flops
// is below a microsecond); SIMT FP32 issue and shared-memory loads at
// d = 32 (3 * 2d^3 flops a step on one SM).
// Design: one block a matrix, d <= 32 (above, one SM a matrix loses on the
// card to the step kernel's multi-block launches: the wrapper sends d > 32
// there, wire.NS_ROOT_MAX_D). y, z, their next values and t stay in shared
// memory across all steps (ping-pong buffers, 5 d^2 floats + 32 for the
// norm's warp sums: at most 20,608 bytes). The grid-wide barrier between t
// and its two consumers, which split the step kernel into two launches, is
// a block barrier here: two barriers a step. The block is sized to d^2,
// one thread an output, its k loops unrolled.
// Each output is the same FP32 FMA chain as the step kernel's, k ascending
// from 0, with the same t epilogue, so from the same normalized y a root
// equals num_iters step launches bit for bit. No TF32.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;                 // output tile edge
constexpr int kSlab = 16;                 // k depth per shared-memory slab
constexpr int kThreads = 256;             // 16 x 16 threads, 2 x 2 outputs each
constexpr int kHalf = kTile / 2;
constexpr int kRootMaxD = 32;             // the root kernel's largest d (wire.NS_ROOT_MAX_D)
constexpr int kRootScratch = 32;          // floats: the norm's warp sums

// acc[i][j] = sum_k A[row0 + ty + 16 i, k] * B[k, col0 + tx + 16 j]
// for the block's 32 x 32 tile of C = A B, A and B row-major (d, d).
__device__ __forceinline__ void gemm_tile(const float* __restrict__ A,
                                          const float* __restrict__ B, int d,
                                          int row0, int col0, float acc[2][2]) {
  __shared__ float As[kTile][kSlab + 1];
  __shared__ float Bs[kSlab][kTile + 1];
  const int tid = threadIdx.x;
  const int tx = tid % kHalf;
  const int ty = tid / kHalf;
  acc[0][0] = acc[0][1] = acc[1][0] = acc[1][1] = 0.0f;
  for (int k0 = 0; k0 < d; k0 += kSlab) {
    // 512 elements of each slab, two a thread; zeros past the edge.
    for (int e = tid; e < kTile * kSlab; e += kThreads) {
      const int ar = e / kSlab, ac = e % kSlab;
      const int gr = row0 + ar, gc = k0 + ac;
      As[ar][ac] = (gr < d && gc < d) ? A[static_cast<long long>(gr) * d + gc] : 0.0f;
      const int br = e / kTile, bc = e % kTile;
      const int hr = k0 + br, hc = col0 + bc;
      Bs[br][bc] = (hr < d && hc < d) ? B[static_cast<long long>(hr) * d + hc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSlab; ++k) {
      const float a0 = As[ty][k], a1 = As[ty + kHalf][k];
      const float b0 = Bs[k][tx], b1 = Bs[k][tx + kHalf];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }
}

// t_b = 0.5 * (3I - z_b y_b), grid (tiles, tiles, B).
__global__ void __launch_bounds__(kThreads)
ns_t_kernel(const float* __restrict__ y, const float* __restrict__ z,
            float* __restrict__ t, int d) {
  const long long off = static_cast<long long>(blockIdx.z) * d * d;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  float acc[2][2];
  gemm_tile(z + off, y + off, d, row0, col0, acc);
  const int tx = threadIdx.x % kHalf, ty = threadIdx.x / kHalf;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = row0 + ty + kHalf * i, c = col0 + tx + kHalf * j;
      if (r < d && c < d) {
        const float eye3 = (r == c) ? 3.0f : 0.0f;
        t[off + static_cast<long long>(r) * d + c] = 0.5f * (eye3 - acc[i][j]);
      }
    }
  }
}

// yo_b = y_b t_b (blockIdx.z < B) and zo_b = t_b z_b (blockIdx.z >= B).
__global__ void __launch_bounds__(kThreads)
ns_update_kernel(const float* __restrict__ y, const float* __restrict__ z,
                 const float* __restrict__ t, float* __restrict__ yo,
                 float* __restrict__ zo, int d, int batch) {
  const bool first = static_cast<int>(blockIdx.z) < batch;
  const int b = first ? blockIdx.z : blockIdx.z - batch;
  const long long off = static_cast<long long>(b) * d * d;
  const float* A = first ? y + off : t + off;
  const float* B = first ? t + off : z + off;
  float* C = first ? yo + off : zo + off;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  float acc[2][2];
  gemm_tile(A, B, d, row0, col0, acc);
  const int tx = threadIdx.x % kHalf, ty = threadIdx.x / kHalf;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = row0 + ty + kHalf * i, c = col0 + tx + kHalf * j;
      if (r < d && c < d) C[static_cast<long long>(r) * d + c] = acc[i][j];
    }
  }
}

// The sum of v over the block, in every thread; red holds 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warps = (blockDim.x + 31) / 32;
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < warps; ++w) total += red[w];
  return total;
}

// The root's first phase: norm = sqrt(sum m^2) + 1e-12 (every thread gets
// it), y0 = m / norm, z0 = I, then a block barrier.
__device__ __forceinline__ float root_init(const float* __restrict__ m, float* y0, float* z0,
                                          float* red, int d) {
  const int n = d * d;
  float ss = 0.0f;
  for (int e = threadIdx.x; e < n; e += blockDim.x) ss = fmaf(m[e], m[e], ss);
  const float norm = sqrtf(block_sum(ss, red)) + 1e-12f;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    y0[e] = m[e] / norm;
    z0[e] = (e / d == e % d) ? 1.0f : 0.0f;
  }
  __syncthreads();
  return norm;
}

// d <= DMAX <= 32: one thread an output (d^2 of the block's threads own
// one). A thread loads the rows and columns of its products into registers
// 8 k at a time, zeros past d (fmaf(0, 0, acc) leaves acc as it is: it is
// never -0), then runs the FMA chain over k ascending. The ping-pong
// buffers are addressed by offset, so every access is a shared-memory one.
template <int DMAX>
__global__ void __launch_bounds__(DMAX * DMAX < 32 ? 32 : DMAX * DMAX)
ns_root_small_kernel(const float* __restrict__ mat, float* __restrict__ out, int d,
                     int num_iters) {
  constexpr int KC = DMAX < 8 ? DMAX : 8;  // k a load batch
  extern __shared__ float smem[];
  const int n = d * d;
  const long long off = static_cast<long long>(blockIdx.x) * n;
  float* const t = smem + 4 * n;
  const float norm = root_init(mat + off, smem, smem + 2 * n, smem + 5 * n, d);
  const int e = threadIdx.x;
  const bool owns = e < n;
  const int r = owns ? e / d : 0, c = owns ? e % d : 0;
  int cur = 0;  // y at smem + cur, z at smem + 2n + cur; the next ones at n - cur
  for (int it = 0; it < num_iters; ++it) {
    const float* y = smem + cur;
    const float* z = smem + 2 * n + cur;
    if (owns) {  // t = 0.5 (3I - z y)
      float acc = 0.0f;
#pragma unroll
      for (int k0 = 0; k0 < DMAX; k0 += KC) {
        float a[KC], b[KC];
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          a[k] = k0 + k < d ? z[r * d + k0 + k] : 0.0f;
          b[k] = k0 + k < d ? y[(k0 + k) * d + c] : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < KC; ++k) acc = fmaf(a[k], b[k], acc);
      }
      t[e] = 0.5f * ((r == c ? 3.0f : 0.0f) - acc);
    }
    __syncthreads();
    if (owns) {  // y t and t z
      float yt = 0.0f, tz = 0.0f;
#pragma unroll
      for (int k0 = 0; k0 < DMAX; k0 += KC) {
        float a[KC], b[KC], f[KC], g[KC];
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          const bool in = k0 + k < d;
          a[k] = in ? y[r * d + k0 + k] : 0.0f;
          b[k] = in ? t[(k0 + k) * d + c] : 0.0f;
          f[k] = in ? t[r * d + k0 + k] : 0.0f;
          g[k] = in ? z[(k0 + k) * d + c] : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          yt = fmaf(a[k], b[k], yt);
          tz = fmaf(f[k], g[k], tz);
        }
      }
      smem[n - cur + e] = yt;
      smem[3 * n - cur + e] = tz;
    }
    __syncthreads();
    cur = n - cur;
  }
  const float scale = sqrtf(norm);
  if (owns) out[off + e] = smem[cur + e] * scale;
}

// The kernel for d and its block size (d^2 rounded up to a warp), or
// nullptr past kRootMaxD: above it the step kernel serves (the wrapper
// dispatches by shape).
using RootKernel = void (*)(const float*, float*, int, int);
RootKernel root_kernel(int d, int* threads) {
  *threads = (d * d + 31) / 32 * 32;
  if (d <= 8) return ns_root_small_kernel<8>;
  if (d <= 16) return ns_root_small_kernel<16>;
  if (d <= kRootMaxD) return ns_root_small_kernel<kRootMaxD>;
  return nullptr;
}

long long root_smem_bytes(int d) {
  return static_cast<long long>(sizeof(float)) * (5LL * d * d + kRootScratch);
}

}  // namespace

extern "C" {

// The root kernel's dynamic shared memory at d, in bytes (the wrapper's
// plan, repro_torch/kernels/wire.py:ns_root_smem_bytes, must agree).
long long repro_ns_root_smem_bytes(int d) { return root_smem_bytes(d); }

// mat, out: (B, d, d) f32, out not aliasing mat; one launch of B blocks.
// num_iters >= 0; 1 <= d <= 32.
int repro_sqrtm_newton_schulz(const float* mat, float* out, int batch, int d, int num_iters,
                              void* stream) {
  int threads = 0;
  const RootKernel kernel = d >= 1 ? root_kernel(d, &threads) : nullptr;
  if (batch < 1 || kernel == nullptr || num_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // At most 20,608 bytes (d = 32): within the 48 KB default, no opt-in.
  const long long bytes = root_smem_bytes(d);
  kernel<<<batch, threads, static_cast<size_t>(bytes), static_cast<cudaStream_t>(stream)>>>(
      mat, out, d, num_iters);
  return static_cast<int>(cudaGetLastError());
}

// y, z: (B, d, d) f32 inputs; t: (B, d, d) f32 scratch; yo, zo: (B, d, d) f32
// outputs. No output aliases an input. B <= 32767 (grid z of launch 2).
int repro_newton_schulz_step(const float* y, const float* z, float* t,
                             float* yo, float* zo, int batch, int d,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (d + kTile - 1) / kTile;
  ns_t_kernel<<<dim3(tiles, tiles, batch), kThreads, 0, s>>>(y, z, t, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ns_update_kernel<<<dim3(tiles, tiles, 2 * batch), kThreads, 0, s>>>(
      y, z, t, yo, zo, d, batch);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
