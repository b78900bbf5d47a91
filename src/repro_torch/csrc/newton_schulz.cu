// Newton–Schulz step of the full-covariance W2 barycenter, hand-written for
// Hopper (sm_90a).
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
// d = 5 one block of 256 threads of which 25 own an output.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;                 // output tile edge
constexpr int kSlab = 16;                 // k depth per shared-memory slab
constexpr int kThreads = 256;             // 16 x 16 threads, 2 x 2 outputs each
constexpr int kHalf = kTile / 2;

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

}  // namespace

extern "C" {

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
