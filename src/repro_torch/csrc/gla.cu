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
//   y      = (q k^T o D) v + e^L (q S_in),     D_ts = e^{L_t - L_s} for s <= t
//                                              (masked before the exp)
//   S_out  = e^{L_C} S_in + (k * e^{L_C - L})^T v
// and, when asked, S after the last chunk written out (B, H, dk, dv) f32.
//
// Past dk = 128 (mLSTM's dk = 1,024) the state is split along dk as well as
// dv: grid axis z takes tiles of 128 rows of dk, and each block walks all
// chunks with its (dk tile) x (dv slice) piece of S. Both terms of y are
// sums over dk (q_i k_i^T o D) v + e^L (q_i S_in,i), so a block's y is a
// partial: each writes its f32 partial to a workspace (dk tiles, B, S, H,
// dv) that gla_reduce_kernel sums in tile order and casts once to q's
// type, as the TPU kernel casts its f32 y once. No atomics: the sum's order
// is fixed, so two runs give the same bits. Every block recomputes the
// cumsum and decays from log_a (they depend on (b, h, t) only) and writes
// its own piece of the final state. Up to dk = 128 there is one tile, no
// workspace and no second launch.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes. The
// entry launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().
//
// What bounds it: per chunk and head 2 C^2 dk + 2 C^2 dv + 4 C dk dv flops
// against C (2 dk + 2 dv) elements read and written; at mamba2's prefill
// (dk = dv = 64, q and k one group over 112 heads) bytes bound it on paper,
// but each (batch, head) is a walk of S / C dependent chunks, so the latency
// of one chunk times the walk's length is what the design has to cut.
//
// Two kernels, chosen by dtype:
//
// bf16: gla_tc_kernel, the serve path's route. A block of 4 warps walks the
//   chunks of one (batch, head) and one slice of NS = 64 columns of dv:
//   column j of S only meets column j of v and y, so slices need no
//   cross-block pass, and dv > 64 (the mLSTM's 65) takes ceil(dv / 64)
//   slices. On the card two 32-column slices of mamba2's dv = 64 lost to
//   one block of 64 (each slice repeats q k^T, P, the scan and the copies
//   of q and k, and 896 blocks at three an SM ran three rounds of the walk
//   where 448 at two an SM run two), so a slice is never narrower.
//   - The four products are mma.sync m16n8k16 bf16 with f32 accumulate:
//     q k^T (warp w: rows 16w..16w+15, keys s <= its last row only);
//     P v, with P = scores o D formed in f32 and fed from the score
//     registers as A fragments in two parts, bf16(P) and the bf16 of what
//     that rounding left (P - bf16(P)): the Pallas kernel keeps P in f32,
//     and a model's own rows can cancel in P v past what P rounded once
//     allows (zamba2's first launches at prompt 4,096 read twice the
//     element limit that way), as can the dk tiles' partial scores;
//     q S_in, scaled by e^{L_t} afterwards (so q enters exact);
//     (k e^{L_C - L})^T v, the state update.
//   - The f32 state stays in registers for the whole walk, as the TPU
//     kernel keeps it in VMEM scratch: warp w holds state rows
//     16w..16w+15 (and 64 + 16w.. for dk > 64) as the update's accumulator
//     fragments. The two products that touch f32 values take them as a
//     bf16 hi/lo pair (x = hi + lo, two products): S_in, copied to shared
//     memory after each update (double-buffered, so the next chunk's reads
//     need no second barrier), and k e^{L_C - L}. Their rounding is then
//     about 2^-17 of the value, far under P's, so the state carried over
//     64 chunks stays at f32 parity.
//   - The in-chunk cumsum of log_a is a warp scan (shuffles), each warp its
//     own copy, kept in that warp's slice of shared memory.
//   - The next chunk's q, k, v slice and log_a are cp.async copies (16
//     bytes a thread; 4 for log_a) into the second of two stages while the
//     current chunk computes, issued by warps 0 and 1, whose rows meet the
//     fewest keys: one block barrier a chunk. A one-chunk walk (S <= C)
//     asks for one stage of shared memory, so more blocks fit an SM. q and
//     k are read through their strides, so mamba2's one (B, S, N) group
//     with head stride 0 is never copied per head. Rows past S and columns
//     past dk or dv are zero-filled: identity steps, no padded copies.
//     Where a row is not 16-byte aligned (dk or dv % 8 != 0, odd strides)
//     the copies are plain element loads instead; up to dk = 128 all three
//     go one way, past it q and k are copied whatever v allows (mLSTM's
//     v rows of 1,025 take element loads).
//   - a dk tile <= 128 (padded to 64 or 128 in shared memory); dv slices of
//     64 with the last one masked (mLSTM's 1,025 = 16 x 64 + 1).
//
// f32: gla_kernel, the SIMT kernel of the first port, the f32 parity route
//   (as flash's f32 inputs take its SIMT kernel). One block of 256 threads
//   per (batch, head, dk tile, dv tile of up to 128 each) walks the chunks
//   in order with its piece of the state in f32 shared memory; a 16 x 16
//   thread grid forms the scores, P v + inter and the update, the cumsum on
//   one thread. C = 64: the C x C f32 score tile
//   is 16 KB, so two blocks fit an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;         // chunk length
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = kC / 16;
constexpr int kMaxD = 128;        // a dk tile (both kernels), a dv tile (SIMT)
constexpr int kMaxGridYZ = 65535;  // grid y and z: dv slices, dk tiles
constexpr int kReduceBlocks = 132 * 8;  // the reduction's grid: 8 blocks an SM at most

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
  float* state;  // (B, H, dk, dv) f32 after the last chunk, or nullptr
  float* ws;     // (dk tiles, B, S, H, dv) f32 partial y when dk is split, else nullptr
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

// The SIMT kernel's tile of dk and of dv: the whole of each up to kMaxD.
__host__ __device__ __forceinline__ int simt_tile(int d) { return d < kMaxD ? d : kMaxD; }

// Grid (B * H, dv tiles, dk tiles); NK >= ceil(tile dk / 16), NV >= ceil(tile
// dv / 16) column groups a thread. A block's live rows of dk are i0 .. i0 +
// dkt - 1 and its live columns of dv j0 .. j0 + dvt - 1.
template <typename T, int NK, int NV>
__global__ void __launch_bounds__(kThreads)
gla_kernel(const Params p) {
  extern __shared__ float smem[];
  const int tk = simt_tile(p.dk), tv = simt_tile(p.dv);
  const int ldk = odd_ld(tk), ldv = odd_ld(tv);
  constexpr int ldp = kC + 1;
  float* qs = smem;               // kC x ldk (q, then q * e^L)
  float* ks = qs + kC * ldk;      // kC x ldk (k, then k * e^{L_C - L})
  float* vs = ks + kC * ldk;      // kC x ldv
  float* ps = vs + kC * ldv;      // kC x ldp decay-weighted scores
  float* st = ps + kC * ldp;      // tk x ldv state
  float* cum = st + tk * ldv;     // kC in-chunk cumsum of log_a

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int i0 = blockIdx.z * tk, j0 = blockIdx.y * tv;
  const int dkt = min(tk, p.dk - i0), dvt = min(tv, p.dv - j0);
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + i0;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh + i0;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh + j0;
  const float* ap = p.a + b * p.a_sb + h * p.a_sh;
  T* op = static_cast<T*>(p.out);
  float* wp = p.ws == nullptr ? nullptr
                              : p.ws + static_cast<long long>(blockIdx.z) * gridDim.x * p.S * p.dv;

  for (int idx = threadIdx.x; idx < tk * ldv; idx += kThreads) st[idx] = 0.0f;

  for (int t0 = 0; t0 < p.S; t0 += kC) {
    __syncthreads();  // the previous chunk is done with every buffer
    load_chunk(qs, qp, p.q_ss, t0, p.S, dkt, ldk);
    load_chunk(ks, kp, p.k_ss, t0, p.S, dkt, ldk);
    load_chunk(vs, vp, p.v_ss, t0, p.S, dvt, ldv);
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
    for (int d = 0; d < dkt; ++d) {
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
    for (int idx = threadIdx.x; idx < kC * dkt; idx += kThreads) {
      const int t = idx / dkt, d = idx - t * dkt;
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
          if (c < dvt) intra[j] += w * vs[s * ldv + c];
        }
      }
      for (int d = 0; d < dkt; ++d) {
        const float w = qs[t * ldk + d];
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int c = tx + 16 * j;
          if (c < dvt) inter[j] += w * st[d * ldv + c];
        }
      }
      if (t0 + t < p.S) {
        const long long row = ((static_cast<long long>(b) * p.S + t0 + t) * p.H + h) * p.dv + j0;
        if (wp != nullptr) {  // this dk tile's f32 partial
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            const int c = tx + 16 * j;
            if (c < dvt) wp[row + c] = intra[j] + inter[j];
          }
        } else {
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            const int c = tx + 16 * j;
            if (c < dvt) op[row + c] = from_f32<T>(intra[j] + inter[j]);
          }
        }
      }
    }
    __syncthreads();  // S_in is read by every thread before it changes

    // S_out = e^{L_C} S_in + (k e^{L_C - L})^T v
    const float decay = expf(total);
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const int d = ty + 16 * i;
      if (d >= dkt) continue;
      float acc[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) acc[j] = 0.0f;
      for (int s = 0; s < kC; ++s) {
        const float w = ks[s * ldk + d];
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int c = tx + 16 * j;
          if (c < dvt) acc[j] += w * vs[s * ldv + c];
        }
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = tx + 16 * j;
        if (c < dvt) st[d * ldv + c] = st[d * ldv + c] * decay + acc[j];
      }
    }
  }
  if (p.state != nullptr) {
    __syncthreads();  // the last update is done
    float* sp = p.state + (static_cast<long long>(b) * p.H + h) * p.dk * p.dv;
    for (int idx = threadIdx.x; idx < dkt * dvt; idx += kThreads) {
      const int d = idx / dvt, c = idx - d * dvt;
      sp[static_cast<long long>(i0 + d) * p.dv + j0 + c] = st[d * ldv + c];
    }
  }
}

template <typename T, int NK, int NV>
int launch(const Params& p, int B, cudaStream_t s) {
  const int tk = simt_tile(p.dk), tv = simt_tile(p.dv);
  const size_t bytes = smem_bytes(tk, tv);
  cudaError_t err = cudaFuncSetAttribute(gla_kernel<T, NK, NV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B * p.H), static_cast<unsigned>((p.dv + tv - 1) / tv),
                  static_cast<unsigned>((p.dk + tk - 1) / tk));
  gla_kernel<T, NK, NV><<<grid, kThreads, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(const Params& p, int B, cudaStream_t s) {
  if (p.dk <= 64 && p.dv <= 64) return launch<float, 4, 4>(p, B, s);
  return launch<float, 8, 8>(p, B, s);
}

// y = the sum of the dk tiles' f32 partials, in tile order, cast once:
// ws (tiles, n) -> out (n). A grid-stride loop, one element a thread a step.
template <typename T>
__global__ void __launch_bounds__(256)
gla_reduce_kernel(const float* __restrict__ ws, T* __restrict__ out, long long n, int tiles) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float acc = ws[i];
    for (int z = 1; z < tiles; ++z) acc += ws[z * n + i];
    out[i] = from_f32<T>(acc);
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kWarps = 4;
constexpr int kThreadsTC = 32 * kWarps;
constexpr int NS = 64;  // columns of dv a block
// Warps 0 and 1 issue a stage's copies: their rows of the chunk meet fewer
// keys, so they finish their products first (warp w's scores and P v span
// keys 0 .. 16 w + 15).
constexpr int kLoadThreads = 64;
constexpr int kSmemLimit = 232448;

// Shared memory (bytes): log_a of two stages and each warp's cumsum (C f32
// each); two stages of q, k (C x (DKP + 8) bf16 each) and the v slice
// (C x (NS + 8)); two copies of S_in as bf16 hi and lo (DKP x (NS + 8)
// each). Rows are padded by 16 bytes so that ldmatrix's eight row
// addresses fall in distinct banks. A one-chunk walk (S <= C) touches only
// the first stage, so its launch asks for that prefix alone and more
// blocks fit an SM.
__host__ __device__ constexpr size_t smem_bytes(int dkp, bool one_chunk) {
  return (2 + kWarps) * kC * 4 +
         (one_chunk ? 1 : 2) * (2 * static_cast<size_t>(kC) * (dkp + 8) * 2 +
                                static_cast<size_t>(kC) * (NS + 8) * 2) +
         (one_chunk ? 0 : 2 * 2 * static_cast<size_t>(dkp) * (NS + 8) * 2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16 x 8 f32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}
// x = hi + lo with hi, lo bf16 pairs: (x0, x1) scaled by (w0, w1).
__device__ __forceinline__ void split_scaled(uint32_t x, float w0, float w1, uint32_t& hi,
                                             uint32_t& lo) {
  const float2 f = unpack_bf16(x);
  const float a = f.x * w0, b = f.y * w1;
  hi = pack_bf16(a, b);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(a - h.x, b - h.y);
}

// Shared memory, in smem_bytes' order: stage i's log_a; each warp's
// cumsum; stage i's q, k, v; S_in copy i's hi and lo planes. Offsets, not
// pointer arrays, so that picking a stage by the chunk's parity costs no
// local memory.
template <int DKP>
struct Layout {
  static constexpr int LDQ = DKP + 8, LDV = NS + 8;
  static constexpr int QE = kC * LDQ, VE = kC * LDV, STAGE = 2 * QE + VE;  // bf16 elements
  static constexpr int SE = DKP * LDV;
  unsigned char* base;
  __device__ __forceinline__ float* a(int i) const {
    return reinterpret_cast<float*>(base) + i * kC;
  }
  __device__ __forceinline__ float* cum(int warp) const { return a(2 + warp); }
  __device__ __forceinline__ __nv_bfloat16* q(int i) const {
    return reinterpret_cast<__nv_bfloat16*>(base + (2 + kWarps) * kC * 4) + i * STAGE;
  }
  __device__ __forceinline__ __nv_bfloat16* k(int i) const { return q(i) + QE; }
  __device__ __forceinline__ __nv_bfloat16* v(int i) const { return q(i) + 2 * QE; }
  __device__ __forceinline__ __nv_bfloat16* s_hi(int i) const { return q(2) + 2 * i * SE; }
  __device__ __forceinline__ __nv_bfloat16* s_lo(int i) const { return s_hi(i) + SE; }
};

// Copies chunk rows t0 .. t0 + C - 1 of q, k (all DKP columns of this
// block's dk tile, dk of them live), of v's columns j0 .. j0 + NS - 1 and of
// log_a into one stage; rows >= S and columns >= dk / dv are zero. VQK:
// q, k and log_a as cp.async copies (16 bytes; 4 for log_a) issued by the
// load threads (dk % 8 == 0 and 16-byte aligned rows), else plain element
// loads by every thread; VV the same for v (dv % 8 == 0). The mLSTM's
// v (dv = 1,025) takes element loads while its q and k are copied.
template <int DKP, bool VQK, bool VV>
__device__ __forceinline__ void load_stage(const Params& p, const __nv_bfloat16* qp,
                                           const __nv_bfloat16* kp, const __nv_bfloat16* vp,
                                           const float* ap, __nv_bfloat16* qs, __nv_bfloat16* ks,
                                           __nv_bfloat16* vs, float* as, int t0, int j0, int dk) {
  static_assert(VQK || !VV, "v copied asynchronously needs q and k copied so too");
  constexpr int LDQ = DKP + 8, LDV = NS + 8;
  constexpr int QP = DKP / 8, VP = NS / 8;  // 16-byte pieces a row
  const int tid = threadIdx.x;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  if (VQK) {
    if (tid < kLoadThreads) {
#pragma unroll
      for (int idx = tid; idx < kC * QP; idx += kLoadThreads) {
        const int r = idx / QP, c = (idx % QP) * 8, t = t0 + r;
        const bool live = t < p.S && c < dk;
        const long long off = static_cast<long long>(t) * p.q_ss + c;
        const long long koff = static_cast<long long>(t) * p.k_ss + c;
        cp_async16(smem_addr(qs + r * LDQ + c), live ? qp + off : qp, live ? 16 : 0);
        cp_async16(smem_addr(ks + r * LDQ + c), live ? kp + koff : kp, live ? 16 : 0);
      }
      if (VV) {
#pragma unroll
        for (int idx = tid; idx < kC * VP; idx += kLoadThreads) {
          const int r = idx / VP, c = (idx % VP) * 8, t = t0 + r;
          const bool live = t < p.S && j0 + c < p.dv;
          const long long off = static_cast<long long>(t) * p.v_ss + j0 + c;
          cp_async16(smem_addr(vs + r * LDV + c), live ? vp + off : vp, live ? 16 : 0);
        }
      }
      if (tid < kC) {
        const int t = t0 + tid;
        const bool live = t < p.S;
        cp_async4(smem_addr(as + tid), live ? ap + static_cast<long long>(t) * p.a_ss : ap,
                  live ? 4 : 0);
      }
    }
  } else {
    for (int idx = tid; idx < kC * DKP; idx += kThreadsTC) {
      const int r = idx / DKP, c = idx % DKP, t = t0 + r;
      const bool live = t < p.S && c < dk;
      qs[r * LDQ + c] = live ? qp[static_cast<long long>(t) * p.q_ss + c] : zero;
      ks[r * LDQ + c] = live ? kp[static_cast<long long>(t) * p.k_ss + c] : zero;
    }
    if (tid < kC) {
      const int t = t0 + tid;
      as[tid] = t < p.S ? ap[static_cast<long long>(t) * p.a_ss] : 0.0f;
    }
  }
  if (!VV) {
    for (int idx = tid; idx < kC * NS; idx += kThreadsTC) {
      const int r = idx / NS, c = idx % NS, t = t0 + r;
      const bool live = t < p.S && j0 + c < p.dv;
      vs[r * LDV + c] = live ? vp[static_cast<long long>(t) * p.v_ss + j0 + c] : zero;
    }
  }
}

// Grid (B * H, ceil(dv / NS), ceil(dk / 128)), 128 threads. DKP (64 or 128)
// >= the block's dk tile (rows i0 .. i0 + dkt - 1 of dk); NS columns of dv a
// block. SPLIT (dk > 128): y is this tile's f32 partial, written to ws.
// P enters P v as a bf16 hi + lo pair on every instantiation: rounded once
// it would err by 2^-9 of each term, and the terms of P v (or the tiles'
// partials) may cancel to far less than their sizes. Fragment names follow the PTX ISA's
// m16n8k16 layout: g = lane / 4 is a fragment row, c4 = lane % 4 picks its
// column pair.
template <int DKP, bool VQK, bool VV, bool SPLIT>
__global__ void __launch_bounds__(kThreadsTC)
gla_tc_kernel(const Params p) {
  constexpr int LDQ = DKP + 8, LDV = NS + 8;
  constexpr int KT = DKP / 16;        // k16 steps over dk
  constexpr int NT = NS / 8;          // n8 tiles of the slice
  constexpr int MT = DKP / 16 / kWarps;  // state row tiles a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c4 = lane % 4;
  const int mi = lane / 8, r8 = lane % 8;  // ldmatrix: matrix and row of this lane's address
  const Layout<DKP> m{smem_raw};

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int j0 = blockIdx.y * NS;
  const int i0 = blockIdx.z * kMaxD, dkt = min(DKP, p.dk - i0);
  const __nv_bfloat16* qp =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh + i0;
  const __nv_bfloat16* kp =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh + i0;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* ap = p.a + b * p.a_sb + h * p.a_sh;
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.out);
  float* wp = SPLIT ? p.ws + static_cast<long long>(blockIdx.z) * gridDim.x * p.S * p.dv : nullptr;

  // This warp's state rows d = 16 (warp + 4 mt) + {g, g + 8}, columns
  // j0 + 8 nt + 2 c4 + {0, 1}: the update's accumulator fragments.
  float st[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[mt][nt][e] = 0.0f;

  const int n_chunks = (p.S + kC - 1) / kC;
  load_stage<DKP, VQK, VV>(p, qp, kp, vp, ap, m.q(0), m.k(0), m.v(0), m.a(0), 0, j0, dkt);
  cp_commit();

  const int row0 = 16 * warp;  // this warp's 16 rows of the chunk
  for (int c = 0; c < n_chunks; ++c) {
    const int cur = c & 1, t0 = c * kC;
    cp_wait_all();
    __syncthreads();  // chunk c has landed; every warp is done with chunk c - 1
    if (c + 1 < n_chunks) {
      load_stage<DKP, VQK, VV>(p, qp, kp, vp, ap, m.q(cur ^ 1), m.k(cur ^ 1), m.v(cur ^ 1),
                                   m.a(cur ^ 1), t0 + kC, j0, dkt);
    }
    cp_commit();
    const __nv_bfloat16* qs = m.q(cur);
    const __nv_bfloat16* ks = m.k(cur);
    const __nv_bfloat16* vs = m.v(cur);

    // In-chunk inclusive cumsum L of log_a: a warp scan over lane pairs.
    {
      const float2 a2 = *reinterpret_cast<const float2*>(m.a(cur) + 2 * lane);
      const float pair = a2.x + a2.y;
      float incl = pair;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      *reinterpret_cast<float2*>(m.cum(warp) + 2 * lane) = make_float2(incl - pair + a2.x, incl);
      __syncwarp();
    }
    const float* L = m.cum(warp);
    const float l_last = L[kC - 1];
    const float lt0 = L[row0 + g], lt1 = L[row0 + g + 8];

    // q's A fragments for this warp's rows (scores and the inter term).
    uint32_t qa[KT][4];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
      ldsm_x4(qa[kk], smem_addr(qs + (row0 + (lane % 16)) * LDQ + kk * 16 + (lane / 16) * 8));

    // Scores q k^T for keys s <= this warp's last row: n8 tiles 0 .. 2 warp + 1.
    float sc[kC / 8][4];
#pragma unroll
    for (int nt = 0; nt < kC / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.0f;
#pragma unroll
    for (int np = 0; np < kC / 16; ++np) {
      if (np > warp) break;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t kb[4];
        ldsm_x4(kb, smem_addr(ks + (16 * np + (mi / 2) * 8 + r8) * LDQ + kk * 16 + (mi % 2) * 8));
        mma(sc[2 * np], qa[kk], kb[0], kb[1]);
        mma(sc[2 * np + 1], qa[kk], kb[2], kb[3]);
      }
    }
    // P = scores o D (s <= t, masked before the exp) as the A fragments of
    // P v: k16 step kk2 takes n8 tiles 2 kk2 and 2 kk2 + 1; bf16(P) in pa,
    // what the rounding left (P - bf16(P)) in pl.
    uint32_t pa[kC / 16][4];
    uint32_t pl[kC / 16][4];
#pragma unroll
    for (int kk2 = 0; kk2 < kC / 16; ++kk2) {
      if (kk2 > warp) break;
      float w[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * kk2 + half, s0 = 8 * nt + 2 * c4;
        const float2 ls = *reinterpret_cast<const float2*>(L + s0);
        const int t_a = row0 + g, t_b = row0 + g + 8;
        w[half][0] = s0 <= t_a ? sc[nt][0] * __expf(lt0 - ls.x) : 0.0f;
        w[half][1] = s0 + 1 <= t_a ? sc[nt][1] * __expf(lt0 - ls.y) : 0.0f;
        w[half][2] = s0 <= t_b ? sc[nt][2] * __expf(lt1 - ls.x) : 0.0f;
        w[half][3] = s0 + 1 <= t_b ? sc[nt][3] * __expf(lt1 - ls.y) : 0.0f;
      }
      pa[kk2][0] = pack_bf16(w[0][0], w[0][1]);
      pa[kk2][1] = pack_bf16(w[0][2], w[0][3]);
      pa[kk2][2] = pack_bf16(w[1][0], w[1][1]);
      pa[kk2][3] = pack_bf16(w[1][2], w[1][3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 h = unpack_bf16(pa[kk2][e]);
        pl[kk2][e] = pack_bf16(w[e / 2][2 * (e % 2)] - h.x, w[e / 2][2 * (e % 2) + 1] - h.y);
      }
    }

    // y = e^{L_t} (q S_in) + P v
    float y[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[nt][e] = 0.0f;
    if (c > 0) {
      const __nv_bfloat16* sh = m.s_hi(cur);
      const __nv_bfloat16* sl = m.s_lo(cur);
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const int off = (kk * 16 + (mi % 2) * 8 + r8) * LDV + np * 16 + (mi / 2) * 8;
          uint32_t bh[4], bl[4];
          ldsm_x4_t(bh, smem_addr(sh + off));
          ldsm_x4_t(bl, smem_addr(sl + off));
          mma(y[2 * np], qa[kk], bh[0], bh[1]);
          mma(y[2 * np + 1], qa[kk], bh[2], bh[3]);
          mma(y[2 * np], qa[kk], bl[0], bl[1]);
          mma(y[2 * np + 1], qa[kk], bl[2], bl[3]);
        }
      }
      const float e0 = __expf(lt0), e1 = __expf(lt1);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        y[nt][0] *= e0;
        y[nt][1] *= e0;
        y[nt][2] *= e1;
        y[nt][3] *= e1;
      }
    }
#pragma unroll
    for (int kk2 = 0; kk2 < kC / 16; ++kk2) {
      if (kk2 > warp) break;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t vb[4];
        ldsm_x4_t(vb, smem_addr(vs + (kk2 * 16 + (mi % 2) * 8 + r8) * LDV + np * 16 +
                                (mi / 2) * 8));
        mma(y[2 * np], pa[kk2], vb[0], vb[1]);
        mma(y[2 * np + 1], pa[kk2], vb[2], vb[3]);
        mma(y[2 * np], pl[kk2], vb[0], vb[1]);
        mma(y[2 * np + 1], pl[kk2], vb[2], vb[3]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = t0 + row0 + g + 8 * half;
      if (t >= p.S) continue;
      const long long row = ((static_cast<long long>(b) * p.S + t) * p.H + h) * p.dv;
      if constexpr (SPLIT) {  // this dk tile's f32 partial
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int j = j0 + 8 * nt + 2 * c4;
          if (j < p.dv) wp[row + j] = y[nt][2 * half];
          if (j + 1 < p.dv) wp[row + j + 1] = y[nt][2 * half + 1];
        }
        continue;
      }
      __nv_bfloat16* orow = op + row;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int j = j0 + 8 * nt + 2 * c4;
        const float y0 = y[nt][2 * half], y1 = y[nt][2 * half + 1];
        if (j + 1 < p.dv && (p.dv % 2) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(orow + j) = __floats2bfloat162_rn(y0, y1);
        } else {
          if (j < p.dv) orow[j] = __float2bfloat16(y0);
          if (j + 1 < p.dv) orow[j + 1] = __float2bfloat16(y1);
        }
      }
    }

    // S_out = e^{L_C} S_in + (k e^{L_C - L})^T v, k e^{L_C - L} as hi + lo.
    const float decay = __expf(l_last);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[mt][nt][e] *= decay;
#pragma unroll
    for (int kk2 = 0; kk2 < kC / 16; ++kk2) {
      const int s0 = kk2 * 16 + 2 * c4;
      const float2 la = *reinterpret_cast<const float2*>(L + s0);
      const float2 lb = *reinterpret_cast<const float2*>(L + s0 + 8);
      const float w0 = __expf(l_last - la.x), w1 = __expf(l_last - la.y);
      const float w2 = __expf(l_last - lb.x), w3 = __expf(l_last - lb.y);
      uint32_t vb[NT / 2][4];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np)
        ldsm_x4_t(vb[np], smem_addr(vs + (kk2 * 16 + (mi % 2) * 8 + r8) * LDV + np * 16 +
                                    (mi / 2) * 8));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int d0 = 16 * (warp + kWarps * mt);
        uint32_t ka[4], hi[4], lo[4];
        ldsm_x4_t(ka, smem_addr(ks + (kk2 * 16 + (mi / 2) * 8 + r8) * LDQ + d0 + (mi % 2) * 8));
        split_scaled(ka[0], w0, w1, hi[0], lo[0]);
        split_scaled(ka[1], w0, w1, hi[1], lo[1]);
        split_scaled(ka[2], w2, w3, hi[2], lo[2]);
        split_scaled(ka[3], w2, w3, hi[3], lo[3]);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          mma(st[mt][2 * np], hi, vb[np][0], vb[np][1]);
          mma(st[mt][2 * np + 1], hi, vb[np][2], vb[np][3]);
          mma(st[mt][2 * np], lo, vb[np][0], vb[np][1]);
          mma(st[mt][2 * np + 1], lo, vb[np][2], vb[np][3]);
        }
      }
    }
    // The next chunk's S_in as hi + lo, into the other copy (read by every
    // warp after the next barrier; the copy it replaces was last read in
    // chunk c - 1).
    if (c + 1 < n_chunks) {
      __nv_bfloat16* sh = m.s_hi(cur ^ 1);
      __nv_bfloat16* sl = m.s_lo(cur ^ 1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int d = 16 * (warp + kWarps * mt) + g;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int j = 8 * nt + 2 * c4;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float x0 = st[mt][nt][2 * half], x1 = st[mt][nt][2 * half + 1];
            const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
            const float2 hf = __bfloat1622float2(hi);
            const int off = (d + 8 * half) * LDV + j;
            *reinterpret_cast<__nv_bfloat162*>(sh + off) = hi;
            *reinterpret_cast<__nv_bfloat162*>(sl + off) =
                __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
          }
        }
      }
    }
  }

  if (p.state != nullptr) {
    float* sp = p.state + (static_cast<long long>(b) * p.H + h) * p.dk * p.dv;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = 16 * (warp + kWarps * mt) + g + 8 * half;
        if (d >= dkt) continue;
        const long long srow = static_cast<long long>(i0 + d) * p.dv;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int j = j0 + 8 * nt + 2 * c4;
          if (j < p.dv) sp[srow + j] = st[mt][nt][2 * half];
          if (j + 1 < p.dv) sp[srow + j + 1] = st[mt][nt][2 * half + 1];
        }
      }
    }
  }
}

template <int DKP, bool VQK, bool VV, bool SPLIT>
int launch(const Params& p, int B, cudaStream_t s) {
  constexpr size_t most = smem_bytes(DKP, false);
  static_assert(most <= kSmemLimit, "GLA tensor-core tiles exceed shared memory");
  cudaError_t err = cudaFuncSetAttribute(gla_tc_kernel<DKP, VQK, VV, SPLIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(most));
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = smem_bytes(DKP, p.S <= kC);
  const dim3 grid(static_cast<unsigned>(B * p.H), static_cast<unsigned>((p.dv + NS - 1) / NS),
                  static_cast<unsigned>((p.dk + kMaxD - 1) / kMaxD));
  gla_tc_kernel<DKP, VQK, VV, SPLIT><<<grid, kThreadsTC, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Up to dk = 128 the copies are all cp.async or all element loads; past it
// (the split) q and k are copied whenever they allow, whatever v allows.
template <int DKP>
int dispatch_vec(const Params& p, int B, int vec_qk, int vec_v, cudaStream_t s) {
  if (vec_qk && vec_v) return launch<DKP, true, true, false>(p, B, s);
  return launch<DKP, false, false, false>(p, B, s);
}

int dispatch_split(const Params& p, int B, int vec_qk, int vec_v, cudaStream_t s) {
  if (!vec_qk) return launch<128, false, false, true>(p, B, s);
  return vec_v ? launch<128, true, true, true>(p, B, s) : launch<128, true, false, true>(p, B, s);
}

constexpr int pad_dk(int dk) { return dk <= 64 ? 64 : 128; }

}  // namespace tc

}  // namespace

extern "C" {

// q, k: (B, S, H, dk); v: (B, S, H, dv); log_a: (B, S, H) f32; each with the
// given (batch, seq, head) strides in elements (a head stride may be 0) and
// a contiguous last axis; q, k, v bf16 when is_bf16 else f32. out:
// (B, S, H, dv) contiguous in q's type; state: (B, H, dk, dv) f32
// contiguous, or null; B * H < 2^31. bf16 takes the tensor-core kernel,
// ceil(dv / 64) blocks along dv and ceil(dk / 128) along dk, with 16-byte
// copies of q and k when vec_qk (dk % 8 == 0, rows 16-byte aligned) and of
// v when vec_v (the same for dv); f32 the SIMT kernel, tiles of 128 along
// each (vec_qk, vec_v unused). Past dk = 128 (more than
// one dk tile) the blocks write f32 partials to ws, (ceil(dk / 128), B, S,
// H, dv) contiguous, not out: repro_gla_reduce then sums them into out.
// Up to dk = 128, ws must be null.
int repro_gla(const void* q, const void* k, const void* v, const float* log_a, void* out,
              float* state, float* ws, int B, int S, int H, int dk, int dv,
              long long q_sb, long long q_ss, long long q_sh,
              long long k_sb, long long k_ss, long long k_sh,
              long long v_sb, long long v_ss, long long v_sh,
              long long a_sb, long long a_ss, long long a_sh,
              int is_bf16, int vec_qk, int vec_v, void* stream) {
  const int dk_tiles = (dk + kMaxD - 1) / kMaxD;
  if (dk < 1 || dv < 1 || dk_tiles > kMaxGridYZ || (dv + tc::NS - 1) / tc::NS > kMaxGridYZ ||
      (dk_tiles > 1) != (ws != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q, k, v, log_a, out, state, ws, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           a_sb, a_ss, a_sh, H, S, dk, dv};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return dispatch_f32(p, B, s);
  if (dk_tiles > 1) return tc::dispatch_split(p, B, vec_qk, vec_v, s);
  return tc::pad_dk(dk) == 64 ? tc::dispatch_vec<64>(p, B, vec_qk, vec_v, s)
                              : tc::dispatch_vec<128>(p, B, vec_qk, vec_v, s);
}

// out (n elements, bf16 when is_bf16 else f32) = the sum over the tiles of
// ws (tiles, n) f32, in tile order.
int repro_gla_reduce(const float* ws, void* out, long long n, int tiles, int is_bf16,
                     void* stream) {
  if (n < 1 || tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long want = (n + 255) / 256;
  const unsigned blocks = static_cast<unsigned>(want < kReduceBlocks ? want : kReduceBlocks);
  if (is_bf16) {
    gla_reduce_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        ws, static_cast<__nv_bfloat16*>(out), n, tiles);
  } else {
    gla_reduce_kernel<float><<<blocks, 256, 0, s>>>(ws, static_cast<float*>(out), n, tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of the tensor-core kernel for dk and S.
long long repro_gla_tc_smem_bytes(int dk, int S) {
  return static_cast<long long>(tc::smem_bytes(tc::pad_dk(dk), S <= kC));
}

}  // extern "C"
