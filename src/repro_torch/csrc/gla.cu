// Chunkwise gated linear attention (Mamba2-SSD / mLSTM), hand-written for
// Hopper (sm_90a).
//
// Replaces src/repro/kernels/gla.py:73 gla_bhsd (body _gla_kernel :30;
// wrapper src/repro/kernels/ops.py:132 gla):
//
//   S_t = exp(a_t) S_{t-1} + k_t v_t^T        (S: dk x dv, f32)
//   y_t = q_t . S_t
//
// computed a chunk of C = 64 steps at a time: with L the in-chunk inclusive
// cumsum of a,
//   y      = (q k^T o D) v + (q * e^L) S_in,   D_ts = e^{L_t - L_s} for s <= t
//                                              (masked before the exp)
//   S_out  = e^{L_C} S_in + (k * e^{L_C - L})^T v
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes. The
// entry launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().
//
// What bounds it: operations at the backbone's prefill (per chunk and head
// 2 C^2 dk + 2 C^2 dv + 2 C dk dv + 2 C dk dv flops against C (2 dk + 2 dv)
// elements read and written), bytes for one-chunk prompts.
//
// Design (a simple, correct first kernel; tensor cores come later):
// - One block of 256 threads per (batch, head) walks the chunks in order,
//   the TPU grid's sequential chunk axis as a loop, with the state in f32
//   shared memory (16 KB at 64 x 64) for the whole walk.
// - Per chunk: q, k, v (f32 or bf16) and log_a (f32) are staged as f32;
//   one thread takes the in-chunk cumsum in order; a 16 x 16 thread grid
//   forms the C x C decay-weighted scores (D masked to s <= t before the
//   exp, so no inf appears), then y_intra = P v and y_inter = (q e^L) S_in
//   (summed apart and added, as the JAX expression does), then the state
//   update. q and k are rescaled in place between the two phases.
// - C = 64, not the Pallas kernel's 128: the C x C f32 score tile is 16 KB
//   instead of 64 KB, so two blocks fit an SM with the staged tiles and the
//   state; the chunked form is exact up to rounding for any C.
// - q, k, v, log_a are read through their (batch, seq, head) strides, so
//   mamba2's q and k, one (B, S, N) group broadcast over the heads, come in
//   with head stride 0 and are never copied 112 times. The ragged tail is
//   masked as identity steps (log_a 0, k = v = 0), with no padded copies.
// - dk <= 128 and dv <= 128 (zamba2: 64 / 64; the mLSTM's v_aug: 65).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kC = 64;         // chunk length
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = kC / 16;
constexpr int kMaxD = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* a;
  void* out;
  long long q_sb, q_ss, q_sh;  // strides (elements) of batch, seq, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long a_sb, a_ss, a_sh;
  int H, S, dk, dv;
};

__host__ __device__ __forceinline__ int odd_ld(int d) { return (d % 2 == 0) ? d + 1 : d; }

size_t smem_bytes(int dk, int dv) {
  const size_t ldk = odd_ld(dk), ldv = odd_ld(dv);
  return sizeof(float) * (2 * kC * ldk + kC * ldv + kC * (kC + 1) + dk * ldv + kC);
}

template <typename T>
__device__ __forceinline__ void load_chunk(float* __restrict__ dst, const T* __restrict__ src,
                                           long long ss, int t0, int S, int d, int ld) {
  for (int idx = threadIdx.x; idx < kC * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    const int t = t0 + r;
    dst[r * ld + c] = t < S ? to_f32(src[static_cast<long long>(t) * ss + c]) : 0.0f;
  }
}

// NK >= ceil(dk / 16), NV >= ceil(dv / 16) column groups a thread.
template <typename T, int NK, int NV>
__global__ void __launch_bounds__(kThreads)
gla_kernel(const Params p) {
  extern __shared__ float smem[];
  const int ldk = odd_ld(p.dk), ldv = odd_ld(p.dv);
  constexpr int ldp = kC + 1;
  float* qs = smem;               // kC x ldk (q, then q * e^L)
  float* ks = qs + kC * ldk;      // kC x ldk (k, then k * e^{L_C - L})
  float* vs = ks + kC * ldk;      // kC x ldv
  float* ps = vs + kC * ldv;      // kC x ldp decay-weighted scores
  float* st = ps + kC * ldp;      // dk x ldv state
  float* cum = st + p.dk * ldv;   // kC in-chunk cumsum of log_a

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* ap = p.a + b * p.a_sb + h * p.a_sh;
  T* op = static_cast<T*>(p.out);

  for (int idx = threadIdx.x; idx < p.dk * ldv; idx += kThreads) st[idx] = 0.0f;

  for (int t0 = 0; t0 < p.S; t0 += kC) {
    __syncthreads();  // the previous chunk is done with every buffer
    load_chunk(qs, qp, p.q_ss, t0, p.S, p.dk, ldk);
    load_chunk(ks, kp, p.k_ss, t0, p.S, p.dk, ldk);
    load_chunk(vs, vp, p.v_ss, t0, p.S, p.dv, ldv);
    if (threadIdx.x < kC) {
      const int t = t0 + threadIdx.x;
      cum[threadIdx.x] = t < p.S ? ap[static_cast<long long>(t) * p.a_ss] : 0.0f;
    }
    __syncthreads();
    if (threadIdx.x == 0) {  // in order, as a sequential cumsum
      float run = 0.0f;
      for (int t = 0; t < kC; ++t) {
        run += cum[t];
        cum[t] = run;
      }
    }
    __syncthreads();
    const float total = cum[kC - 1];

    // Scores: P[t][s] = (q_t . k_s) e^{L_t - L_s} for s <= t, else 0.
    float sc[kRows][kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kRows; ++j) sc[i][j] = 0.0f;
    for (int d = 0; d < p.dk; ++d) {
      float a[kRows], c[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = qs[(ty + 16 * i) * ldk + d];
#pragma unroll
      for (int j = 0; j < kRows; ++j) c[j] = ks[(tx + 16 * j) * ldk + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kRows; ++j) sc[i][j] += a[i] * c[j];
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int t = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int s = tx + 16 * j;
        ps[t * ldp + s] = s <= t ? sc[i][j] * expf(cum[t] - cum[s]) : 0.0f;
      }
    }
    __syncthreads();

    // q * e^L for the inter-chunk term, k * e^{L_C - L} for the state update.
    for (int idx = threadIdx.x; idx < kC * p.dk; idx += kThreads) {
      const int t = idx / p.dk, d = idx - t * p.dk;
      qs[t * ldk + d] *= expf(cum[t]);
      ks[t * ldk + d] *= expf(total - cum[t]);
    }
    __syncthreads();

    // y = P v + (q e^L) S_in
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int t = ty + 16 * i;
      float intra[NV], inter[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) intra[j] = inter[j] = 0.0f;
      for (int s = 0; s <= t; ++s) {
        const float w = ps[t * ldp + s];
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int c = tx + 16 * j;
          if (c < p.dv) intra[j] += w * vs[s * ldv + c];
        }
      }
      for (int d = 0; d < p.dk; ++d) {
        const float w = qs[t * ldk + d];
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int c = tx + 16 * j;
          if (c < p.dv) inter[j] += w * st[d * ldv + c];
        }
      }
      if (t0 + t < p.S) {
        T* orow = op + ((static_cast<long long>(b) * p.S + t0 + t) * p.H + h) * p.dv;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int c = tx + 16 * j;
          if (c < p.dv) orow[c] = from_f32<T>(intra[j] + inter[j]);
        }
      }
    }
    __syncthreads();  // S_in is read by every thread before it changes

    // S_out = e^{L_C} S_in + (k e^{L_C - L})^T v
    const float decay = expf(total);
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const int d = ty + 16 * i;
      if (d >= p.dk) continue;
      float acc[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) acc[j] = 0.0f;
      for (int s = 0; s < kC; ++s) {
        const float w = ks[s * ldk + d];
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int c = tx + 16 * j;
          if (c < p.dv) acc[j] += w * vs[s * ldv + c];
        }
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = tx + 16 * j;
        if (c < p.dv) st[d * ldv + c] = st[d * ldv + c] * decay + acc[j];
      }
    }
  }
}

template <typename T, int NK, int NV>
int launch(const Params& p, int B, cudaStream_t s) {
  const size_t bytes = smem_bytes(p.dk, p.dv);
  cudaError_t err = cudaFuncSetAttribute(gla_kernel<T, NK, NV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  gla_kernel<T, NK, NV><<<static_cast<unsigned>(B * p.H), kThreads, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, int B, cudaStream_t s) {
  if (p.dk <= 64 && p.dv <= 64) return launch<T, 4, 4>(p, B, s);
  return launch<T, 8, 8>(p, B, s);
}

}  // namespace

extern "C" {

// q, k: (B, S, H, dk); v: (B, S, H, dv); log_a: (B, S, H) f32; each with the
// given (batch, seq, head) strides in elements (a head stride may be 0) and
// a contiguous last axis; q, k, v bf16 when is_bf16 else f32. out:
// (B, S, H, dv) contiguous in q's type. 1 <= dk, dv <= 128; B * H < 2^31.
int repro_gla(const void* q, const void* k, const void* v, const float* log_a, void* out,
              int B, int S, int H, int dk, int dv,
              long long q_sb, long long q_ss, long long q_sh,
              long long k_sb, long long k_ss, long long k_sh,
              long long v_sb, long long v_ss, long long v_sh,
              long long a_sb, long long a_ss, long long a_sh,
              int is_bf16, void* stream) {
  if (dk < 1 || dk > kMaxD || dv < 1 || dv > kMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q, k, v, log_a, out, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           a_sb, a_ss, a_sh, H, S, dk, dv};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(p, B, s) : dispatch<float>(p, B, s);
}

}  // extern "C"
