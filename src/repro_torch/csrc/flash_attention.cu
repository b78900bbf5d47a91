// Flash attention (online softmax, GQA, causal / sliding-window masks),
// hand-written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/attention.py:98 flash_attention_bhsd (body
// _flash_kernel :28; wrapper src/repro/kernels/ops.py:41 flash_attention):
//
//   out[b, i, h, :] = sum_j softmax_j(mask(q_i . k_j * scale)) v_j
//   q (B, Sq, H, hd); k, v (B, Skv, KV, hd); query head h reads kv head
//   h / (H / KV); query i sits at position i + q_offset; key j is live when
//   j < Skv, (causal) j <= i + q_offset, (window w > 0) j > i + q_offset - w.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes. The
// entry launches on the caller's stream, allocates nothing (the wrapper
// allocates out) and returns cudaGetLastError().
//
// What bounds it: operations at the backbone's prefill shapes (4 hd flops
// per live (i, j) pair: 4.8e11 at B=4, S=4,096, H=32, hd=112, causal), bytes
// at decode (Sq = 1 reads the whole cache once).
//
// Design (a simple, correct first kernel; tensor cores come later):
// - One block of 256 threads per (q tile of 64 rows, head, batch). The block
//   walks the key tiles of 64 rows that hold a live key for some row of its
//   q tile: causal tiles past the tile's last query and window tiles before
//   its first query's window are never loaded (the dead-tile skip of the
//   Pallas kernel, as loop bounds).
// - Q, K, V tiles are staged in shared memory as f32 (inputs f32 or bf16),
//   rows padded to an odd stride so the 16 threads reading 16 K rows hit 16
//   banks. At hd = 112 a block holds 101 KB, at hd = 256 209 KB: above 48 KB,
//   so the launch raises the dynamic shared-memory limit first.
// - Threads form a 16 x 16 grid; thread (ty, tx) owns rows ty + 16 i
//   (i < 4) of the tile, score columns tx + 16 j (j < 4) and output columns
//   tx + 16 j (j < ceil(hd / 16)): hd need not be a power of two (112), the
//   last column group is masked.
// - Online softmax in f32, as in the Pallas kernel: masked scores are -1e30,
//   masked weights exactly 0, the running max m, normalizer l and
//   accumulator are f32 in registers, row max and row sum by shuffles over
//   the 16 threads of a row. A row with no live key ends at 0 (l clamped at
//   1e-30, accumulator 0), as attention.py:84 and :94 do.
// - The kernel reads q, k, v through their (batch, seq, head) strides (the
//   last axis contiguous) and masks the ragged ends of Sq and Skv itself,
//   so the model's (B, S, H, hd) layout needs no transpose and no padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 64;        // key rows a tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = kBQ / 16;
constexpr int kCols = kBK / 16;
constexpr int kMaxHd = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Reductions over the 16 threads of one tile row (lanes differing in bits 0-3).
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  long long q_sb, q_ss, q_sh;  // strides (elements) of batch, seq, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int H, KV, Sq, Skv, hd;
  int causal, window;  // window <= 0: none
  long long q_offset;
  float scale;
};

__host__ __device__ __forceinline__ int padded_ld(int hd) { return (hd % 2 == 0) ? hd + 1 : hd; }

size_t smem_bytes(int hd) {
  const int ld = padded_ld(hd);
  return sizeof(float) * (static_cast<size_t>(kBQ) * ld + 2 * static_cast<size_t>(kBK) * ld +
                          static_cast<size_t>(kBQ) * (kBK + 1));
}

// rows x hd tile starting at row0 of a (seq, hd) slice with row stride ss -> f32 smem.
template <typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const T* __restrict__ src,
                                          long long ss, int row0, int nrows, int limit,
                                          int hd, int ld) {
  for (int idx = threadIdx.x; idx < nrows * hd; idx += kThreads) {
    const int r = idx / hd, d = idx - r * hd;
    const int row = row0 + r;
    dst[r * ld + d] = row < limit ? to_f32(src[static_cast<long long>(row) * ss + d]) : 0.0f;
  }
}

// NJ = output column groups a thread (ceil(hd / 16) <= NJ).
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const Params p) {
  extern __shared__ float smem[];
  const int ld = padded_ld(p.hd);
  float* qs = smem;                 // kBQ x ld
  float* ks = qs + kBQ * ld;        // kBK x ld
  float* vs = ks + kBK * ld;        // kBK x ld
  float* ps = vs + kBK * ld;        // kBQ x (kBK + 1)
  constexpr int ldp = kBK + 1;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  load_tile(qs, qp + static_cast<long long>(q0) * p.q_ss, p.q_ss, 0, kBQ, p.Sq - q0, p.hd, ld);

  // Live key range of this q tile (dead tiles are never visited).
  const long long q_first = q0 + p.q_offset;
  const long long q_last = static_cast<long long>(min(q0 + kBQ, p.Sq)) - 1 + p.q_offset;
  long long kv_hi = p.Skv;
  if (p.causal) kv_hi = min(kv_hi, q_last + 1);
  long long kv_lo = 0;
  if (p.window > 0) kv_lo = max(kv_lo, q_first - p.window + 1);
  const int t_lo = static_cast<int>(kv_lo / kBK) * kBK;

  float m[kRows], l[kRows], acc[kRows][NJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  for (long long kv0 = t_lo; kv0 < kv_hi; kv0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile(ks, kp, p.k_ss, static_cast<int>(kv0), kBK, p.Skv, p.hd, ld);
    load_tile(vs, vp, p.v_ss, static_cast<int>(kv0), kBK, p.Skv, p.hd, ld);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < p.hd; ++d) {
      float a[kRows], c[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) c[j] = ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] += a[i] * c[j];
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long long qpos = q0 + ty + 16 * i + p.q_offset;
      bool live[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const long long col = kv0 + tx + 16 * j;
        live[j] = col < p.Skv && (!p.causal || col <= qpos) &&
                  (p.window <= 0 || col > qpos - p.window);
        s[i][j] = live[j] ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float pij = live[j] ? expf(s[i][j] - m_new) : 0.0f;
        sum += pij;
        ps[(ty + 16 * i) * ldp + tx + 16 * j] = pij;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // P complete

    for (int kk = 0; kk < kBK; ++kk) {
      float a[kRows], c[NJ];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = ps[(ty + 16 * i) * ldp + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        c[j] = d < p.hd ? vs[kk * ld + d] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] += a[i] * c[j];
    }
  }

  T* op = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Sq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    T* orow = op + ((static_cast<long long>(b) * p.Sq + row) * p.H + h) * p.hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < p.hd) orow[d] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T>
int dispatch(const Params& p, int B, cudaStream_t s) {
  const size_t bytes = smem_bytes(p.hd);
  const dim3 grid(static_cast<unsigned>((p.Sq + kBQ - 1) / kBQ), static_cast<unsigned>(p.H),
                  static_cast<unsigned>(B));
  cudaError_t err;
#define REPRO_FLASH_CASE(NJ)                                                              \
  err = cudaFuncSetAttribute(flash_kernel<T, NJ>,                                        \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,                \
                             static_cast<int>(bytes));                                   \
  if (err != cudaSuccess) return static_cast<int>(err);                                  \
  flash_kernel<T, NJ><<<grid, kThreads, bytes, s>>>(p);                                  \
  return static_cast<int>(cudaGetLastError());
  if (p.hd <= 32) { REPRO_FLASH_CASE(2) }
  if (p.hd <= 64) { REPRO_FLASH_CASE(4) }
  if (p.hd <= 128) { REPRO_FLASH_CASE(8) }
  REPRO_FLASH_CASE(16)
#undef REPRO_FLASH_CASE
}

}  // namespace

extern "C" {

// q: (B, Sq, H, hd) and k, v: (B, Skv, KV, hd), each with the given
// (batch, seq, head) strides in elements and a contiguous last axis, all
// bf16 when is_bf16 else f32; out: (B, Sq, H, hd) contiguous, same type.
// 1 <= hd <= 256, H % KV == 0, Sq >= 1, Skv >= 0, B and H <= 65535.
int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                          int B, int H, int KV, int Sq, int Skv, int hd,
                          long long q_sb, long long q_ss, long long q_sh,
                          long long k_sb, long long k_ss, long long k_sh,
                          long long v_sb, long long v_ss, long long v_sh,
                          int causal, int window, long long q_offset, float scale,
                          int is_bf16, void* stream) {
  if (hd < 1 || hd > kMaxHd || KV < 1 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, out, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           H, KV, Sq, Skv, hd, causal, window, q_offset, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(p, B, s) : dispatch<float>(p, B, s);
}

}  // extern "C"
