// Flash attention (online softmax, GQA, causal / sliding-window masks),
// hand-written for Hopper (sm_90a): a tensor-core kernel for bf16 inputs
// and a SIMT kernel for f32 inputs, one source.
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
// entries launch on the caller's stream, allocate nothing (the wrapper
// allocates out) and return cudaGetLastError().
//
// What bounds it: operations at the backbone's prefill shapes (4 hd flops
// per live (i, j) pair: 4.8e11 at B=4, S=4,096, H=32, hd=112, causal, 0.49 ms
// on the bf16 tensor cores), bytes at decode (Sq = 1 reads the cache once).
//
// Both kernels share the function's rules: the block walks only the key
// tiles that hold a live key for some row of its q tile (the dead-tile skip
// of the Pallas kernel, as loop bounds); scores, running max m, normalizer
// l and accumulator are f32; masked scores are -1e30 and masked weights
// exactly 0, so a row with no live key ends at 0 (l clamped at 1e-30), as
// attention.py:84 and :94 do; q, k, v are read through their (batch, seq,
// head) strides (last axis contiguous) with the ragged ends of Sq and Skv
// masked here, so the model's (B, S, H, hd) layout needs no transpose and no
// padding.
//
// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16), flash_tc_kernel:
// - One block per (q tile of 64 x WG rows, head, batch), WG = 1 or 2
//   consumer warpgroups; warpgroup w owns q rows 64 w .. 64 w + 63. Q tiles
//   launch heaviest first (blockIdx.x reversed), so under the causal mask
//   the long rows do not run last; a head's q tiles run together and share
//   its K/V through L2.
// - S = Q K^T and O += P V are wgmma.mma_async m64nNk16 (bf16 in, f32
//   accumulators in registers). For Q K^T, K is the B operand, K-major as
//   stored (N = 64 keys); Q is the A operand from registers (loaded once
//   with ldmatrix) where HDP <= 128, else from shared memory: at the serve
//   shapes the A reads from shared memory cost as much as the products. For
//   P V, P comes from registers: the f32 S accumulator, rescaled and rounded
//   to bf16 pairs, has the A-fragment layout of m64k16; V is the B operand
//   with the transpose bit set (V is stored key-major). N = hd padded to a
//   multiple of 16 (HDP), issued as N = 64, 32, 16 pieces. P is rounded to
//   bf16 before P V (as every tensor-core flash kernel does); l sums the
//   f32 P.
// - Shared memory holds the Q tile and rings of K and V tiles of 64 keys,
//   all bf16 in wgmma's no-swizzle core-matrix layout: 8 rows x 16 bytes
//   (128 contiguous bytes) a core matrix, the HDP / 8 core matrices of an
//   8-row group side by side. A copy gives thread t row t % 8 of column
//   group (t / 8) % 16 (+ 16) of every (NT / 128)-th 8-row group: eight
//   neighbouring threads fill one core matrix (no bank conflict), a warp
//   reads 64 contiguous bytes of each of 8 rows, and the addresses step by
//   a constant.
// - Copies are cp.async of 16 bytes a thread, zero-filled past Sq / Skv and
//   past hd, so the strided (B, S, H, hd) rows need no TMA tensor map. They
//   run D = 2 key tiles ahead of the products where the rings fit (else 1):
//   tile t + D's copies are issued before tile t's products; one barrier a
//   tile. Where hd % 8 != 0 or a row start is not 16-byte aligned
//   (vec == 0), the same kernel stages element by element (synchronous
//   loads).
// - Iteration t issues S_t = Q K_t^T and O += P_{t-1} V_{t-1} together, runs
//   tile t's softmax while P_{t-1} V_{t-1} computes, then rescales O and
//   packs P_t (the intra-warpgroup overlap of FlashAttention-3). So V_{t-1}
//   is still read while tiles up to t + D land: D + 2 V stages, D + 1 K
//   stages. Every branch around a wgmma depends on the block alone: a branch
//   that depends on the thread makes ptxas serialize the products.
// - Online softmax in registers, f32, in base 2 (scores scaled by
//   scale * log2 e inside the exponent's FMA; the same function). A thread
//   holds 2 rows x 16 scores of a tile; row max and sum by shuffles over the
//   4 threads of a row. Key tiles wholly live for every row of the block
//   skip the mask arithmetic.
// - The output leaves through the warpgroup's rows of the Q tile, swizzled,
//   as 16-byte stores (vec), else as pairs straight from the registers.
// - Shared memory: 2 (64 WG + (2 D + 3) 64) HDP bytes, at most 229,376
//   (HDP = 256, WG = 2, D = 1; the 227 KB limit is 232,448); the launch
//   raises the dynamic limit first.
//
// SIMT kernel (f32), flash_kernel — the f32 parity route (TF32 would not hold
// the card to the CPU within 1e-3 at full width):
// - One block of 256 threads per (q tile of 64 rows, head, batch), key tiles
//   of 64 staged as f32 in shared memory with odd row strides; threads form
//   a 16 x 16 grid, thread (ty, tx) owning rows ty + 16 i (i < 4), score
//   columns tx + 16 j (j < 4) and output columns tx + 16 j (j < ceil(hd/16)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxHd = 256;
constexpr float kNegInf = -1e30f;

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

// Key range [lo, hi) holding a live key for some query of [q0, q1).
__device__ __forceinline__ void live_keys(const Params& p, int q0, int q1, long long* lo,
                                          long long* hi) {
  const long long q_first = q0 + p.q_offset;
  const long long q_last = static_cast<long long>(min(q1, p.Sq)) - 1 + p.q_offset;
  *hi = p.Skv;
  if (p.causal) *hi = min(*hi, q_last + 1);
  *lo = 0;
  if (p.window > 0) *lo = max(*lo, q_first - p.window + 1);
}

// ===========================================================================
// Tensor-core kernel (bf16)
// ===========================================================================

namespace tc {

constexpr int kBK = 64;  // key rows a tile
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int pad16(int hd) { return (hd + 15) / 16 * 16; }

constexpr size_t kSmemLimit = 232448;  // dynamic shared memory a block may use

// Copies run D tiles ahead of the products (the prefetch distance). Tile
// t's K is read by its own S = Q K^T and its V by the next iteration's P V,
// while tiles t + 1 .. t + D are in flight: D + 1 K stages and D + 2 V
// stages, beside the Q tile (64 WG x HDP), all bf16. D = 2 where that fits
// the block's shared memory, else 1.
__host__ __device__ constexpr size_t smem_for(int hdp, int wg, int d) {
  return 2 * (static_cast<size_t>(64 * wg) + static_cast<size_t>(2 * d + 3) * kBK) * hdp;
}
__host__ __device__ constexpr int prefetch(int hdp, int wg) {
  return smem_for(hdp, wg, 2) <= kSmemLimit ? 2 : 1;
}
__host__ __device__ constexpr size_t smem_bytes(int hdp, int wg) {
  return smem_for(hdp, wg, prefetch(hdp, wg));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor, no swizzle: start address, leading byte offset
// (LBO: between core matrices along K for K-major operands, along K too for
// the transposed (MN-major) V) and stride byte offset (SBO: between core
// matrices along M / N), all in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma uses across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

#define REPRO_F8(d, o)                                                                  \
  "+f"(d[(o) + 0]), "+f"(d[(o) + 1]), "+f"(d[(o) + 2]), "+f"(d[(o) + 3]),             \
      "+f"(d[(o) + 4]), "+f"(d[(o) + 5]), "+f"(d[(o) + 6]), "+f"(d[(o) + 7])

// S (64 x 64) = A (64 x 16, smem, K-major) . B (16 x 64, smem, K-major)
// (+ S when accumulate != 0).
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_F8(d, 0), REPRO_F8(d, 8), REPRO_F8(d, 16), REPRO_F8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// S (64 x 64) = A (64 x 16, registers) . B (16 x 64, smem, K-major)
// (+ S when accumulate != 0).
__device__ __forceinline__ void mma_rs_n64_kmajor(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : REPRO_F8(d, 0), REPRO_F8(d, 8), REPRO_F8(d, 16), REPRO_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// O[:, n0 : n0 + N] += P (64 x 16, registers) . V (16 x N, smem, transposed).
template <int O, int NO>
__device__ __forceinline__ void mma_rs_n64(float (&d)[NO], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_F8(d, O), REPRO_F8(d, O + 8), REPRO_F8(d, O + 16), REPRO_F8(d, O + 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <int O, int NO>
__device__ __forceinline__ void mma_rs_n32(float (&d)[NO], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : REPRO_F8(d, O), REPRO_F8(d, O + 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <int O, int NO>
__device__ __forceinline__ void mma_rs_n16(float (&d)[NO], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : REPRO_F8(d, O)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef REPRO_F8

// O (64 x HDP) += P (64 x 16) . V rows 16 kk .. 16 kk + 15, as N = 64, 32,
// 16 pieces; column group n0 / 8 of O is accumulator registers n0 / 2 ...
template <int HDP, int N0 = 0>
__device__ __forceinline__ void pv_step(float (&o)[HDP / 2], const uint32_t (&a)[4],
                                        uint32_t v_kk) {
  if constexpr (N0 < HDP) {
    // V (transposed): core matrices of 8 d-columns are 128 B apart (SBO),
    // of 8 keys (HDP / 8) * 128 B apart (LBO).
    const uint64_t db = desc(v_kk + (N0 / 8) * 128, HDP * 16, 128);
    if constexpr (HDP - N0 >= 64) {
      mma_rs_n64<N0 / 2>(o, a, db);
      pv_step<HDP, N0 + 64>(o, a, v_kk);
    } else if constexpr (HDP - N0 >= 32) {
      mma_rs_n32<N0 / 2>(o, a, db);
      pv_step<HDP, N0 + 32>(o, a, v_kk);
    } else {
      mma_rs_n16<N0 / 2>(o, a, db);
    }
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
// Waits until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Makes the generic-proxy writes to shared memory visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ROWS x HDP tile (rows row0 .. row0 + ROWS - 1 of a (seq, hd) slice with
// row stride ss; rows >= limit and columns >= hd are zero) -> the
// core-matrix layout at dst. Thread t copies row r8 = t % 8 of the 8-row
// groups rb = t / 128 (mod NT / 128) of column groups c8 = (t / 8) % 16
// (+ 16): a warp writes four whole core matrices and reads 64 contiguous
// bytes of each of 8 rows, and the addresses step by a constant.
template <int HDP, int NT, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
                                          long long ss, int row0, int limit, int hd, int vec) {
  constexpr int G = HDP / 8;  // 16-byte units a row
  constexpr int RS = NT / 128;
  constexpr int NB = ROWS / 8 / RS;  // 8-row groups a thread
  const int r8 = threadIdx.x & 7, cg = (threadIdx.x >> 3) & 15, rs = threadIdx.x >> 7;
  const int r_first = rs * 8 + r8;  // this thread's first row in the tile
  for (int c8 = cg; c8 < G; c8 += 16) {
    const bool col_live = c8 * 8 < hd;
    const __nv_bfloat16* s = src + (row0 + r_first) * ss + c8 * 8;
    uint32_t d = smem_addr(dst) + ((rs * G + c8) * 8 + r8) * 16;
    if (vec) {
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const bool live = col_live && row0 + r_first + i * RS * 8 < limit;
        cp_async16(d, live ? s : src, live ? 16 : 0);
        s += RS * 8 * ss;
        d += RS * G * 128;
      }
    } else {
      __nv_bfloat16* e = dst + ((rs * G + c8) * 8 + r8) * 8;
      for (int i = 0; i < NB; ++i) {
        const bool live = row0 + r_first + i * RS * 8 < limit;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          e[k] = (live && c8 * 8 + k < hd) ? s[k] : __float2bfloat16(0.0f);
        s += RS * 8 * ss;
        e += RS * G * 64;
      }
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// Online softmax of one tile's scores, in place: s[4 i + {0, 1}] is row r0,
// keys kv0 + 8 i + 2 (lane % 4) + {0, 1}; s[4 i + {2, 3}] the same keys of
// row r0 + 8; on return s holds P (f32). Updates the running max m (log2
// units) and this thread's share of the normalizer l, and returns the
// rescale factors of the two rows. A masked score is kNegInf and its weight
// exactly 0.
struct RowState {
  float m0, m1, l0, l1;
};

__device__ __forceinline__ void softmax_tile(float (&s)[32], const Params& p, bool full, int kv0,
                                             long long pos0, int lane, float sl2, RowState& st,
                                             float& alpha0, float& alpha1) {
  if (!full) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long key = kv0 + 8 * i + 2 * (lane % 4) + (e & 1);
        const long long pos = pos0 + ((e & 2) ? 8 : 0);
        const bool live = key < p.Skv && (!p.causal || key <= pos) &&
                          (p.window <= 0 || key > pos - p.window);
        if (!live) s[4 * i + e] = kNegInf;
      }
    }
  }
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
  }
  // A row with no live key so far keeps m at kNegInf.
  const float mn0 = mx0 > 0.5f * kNegInf ? fmaxf(st.m0, mx0 * sl2) : st.m0;
  const float mn1 = mx1 > 0.5f * kNegInf ? fmaxf(st.m1, mx1 * sl2) : st.m1;
  alpha0 = exp2f(st.m0 - mn0);
  alpha1 = exp2f(st.m1 - mn1);
  st.m0 = mn0;
  st.m1 = mn1;
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[4 * i + e];
      float pe = exp2f(fmaf(x, sl2, (e & 2) ? -mn1 : -mn0));
      if (!full) pe = x > 0.5f * kNegInf ? pe : 0.0f;
      s[4 * i + e] = pe;
      if (e & 2) sum1 += pe; else sum0 += pe;
    }
  }
  st.l0 = st.l0 * alpha0 + sum0;
  st.l1 = st.l1 * alpha1 + sum1;
}

// P (f32, the S accumulator layout) as bf16 A fragments of m64k16: keys
// 16 kk + {2 (lane % 4), +1} and + 8, rows r0 and r0 + 8.
__device__ __forceinline__ void pack_p(const float (&s)[32], uint32_t (&a)[kBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// S = Q K^T: Q and K K-major; core matrices 128 B apart along K (LBO),
// HDP / 8 * 128 B apart along M / N (SBO); a k16 step is 256 B. The first
// step overwrites S, so S needs no zeroing (a register write between
// wgmma.fence and the product would race with it).
template <int HDP>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t q_base, uint32_t k_base) {
#pragma unroll
  for (int ks = 0; ks < HDP / 16; ++ks)
    mma_ss_n64(s, desc(q_base + ks * 256, 128, HDP * 16), desc(k_base + ks * 256, 128, HDP * 16),
               ks > 0);
}
// The same product with Q's A fragments in registers.
template <int HDP>
__device__ __forceinline__ void issue_qk(float (&s)[32], const uint32_t (&qf)[HDP / 16][4],
                                         uint32_t k_base) {
#pragma unroll
  for (int ks = 0; ks < HDP / 16; ++ks)
    mma_rs_n64_kmajor(s, qf[ks], desc(k_base + ks * 256, 128, HDP * 16), ks > 0);
}

// This warp's 16 rows of the warpgroup's Q tile (core-matrix layout at
// q_base) as A fragments of m64k16, one ldmatrix.x4 a k16 step: lanes
// 8 m .. 8 m + 7 address row m % 2 * 8 + lane % 8 of column group
// 2 ks + m / 2, which is register m of the fragment.
template <int HDP>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[HDP / 16][4], uint32_t q_base) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32, m = lane / 8;
  const uint32_t row_group = 2 * warp + (m & 1);
#pragma unroll
  for (int ks = 0; ks < HDP / 16; ++ks) {
    const uint32_t addr =
        q_base + (row_group * (HDP / 8) + 2 * ks + (m >> 1)) * 128 + (lane % 8) * 16;
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(qf[ks][0]), "=r"(qf[ks][1]), "=r"(qf[ks][2]), "=r"(qf[ks][3])
                 : "r"(addr));
  }
}

template <int HDP>
__device__ __forceinline__ void issue_pv(float (&o)[HDP / 2], const uint32_t (&pp)[kBK / 16][4],
                                         uint32_t v_base) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) pv_step<HDP>(o, pp[kk], v_base + kk * 2 * HDP * 16);
}

template <int HDP, int WG>
__global__ void __launch_bounds__(128 * WG)
flash_tc_kernel(const Params p, int vec) {
  constexpr int NT = 128 * WG;
  constexpr int BQ = 64 * WG;
  constexpr int NO = HDP / 2;               // O accumulator floats a thread
  constexpr int TILE = kBK * HDP;           // elements of a K or V tile
  constexpr int D = prefetch(HDP, WG);      // tiles the copies run ahead
  constexpr int KS = D + 1, VS = D + 2;     // K and V stages
  // Q in registers (an RS product) halves the shared-memory reads of
  // S = Q K^T; at HDP > 128 its fragments would not fit beside O.
  constexpr bool QREG = HDP <= 128;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + BQ * HDP;        // KS K tiles
  __nv_bfloat16* sv = sk + KS * TILE;       // VS V tiles

  // Heaviest causal tiles first: blockIdx.x reversed.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  long long kv_lo, kv_hi;
  live_keys(p, q0, q0 + BQ, &kv_lo, &kv_hi);
  const int t_lo = static_cast<int>(kv_lo / kBK) * kBK;
  const int ntiles = kv_hi > t_lo ? static_cast<int>((kv_hi - t_lo + kBK - 1) / kBK) : 0;
  // Every branch around a wgmma depends on the block alone (warpgroup
  // uniform), so the compiler keeps the products asynchronous.
  const long long blk_first = q0 + p.q_offset, blk_last = blk_first + BQ - 1;

  // Copy group i holds tile i (group 0 also Q); every iteration commits one
  // group, empty past the last tile, so the count of pending groups is fixed.
  load_tile<HDP, NT, BQ>(sq, qp, p.q_ss, q0, p.Sq, p.hd, vec);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if (i < ntiles) {
      load_tile<HDP, NT, kBK>(sk + i * TILE, kp, p.k_ss, t_lo + i * kBK, p.Skv, p.hd, vec);
      load_tile<HDP, NT, kBK>(sv + i * TILE, vp, p.v_ss, t_lo + i * kBK, p.Skv, p.hd, vec);
    }
    cp_commit();
  }

  const int lane = threadIdx.x % 32;
  // This thread's first row within the block's tile, and its position.
  const int r0 = (threadIdx.x / 128) * 64 + ((threadIdx.x % 128) / 32) * 16 + lane / 4;
  const long long pos0 = q0 + r0 + p.q_offset;
  const float sl2 = p.scale * kLog2e;
  const uint32_t q_base = smem_addr(sq) + (threadIdx.x / 128) * 64 * HDP * 2;

  float o[NO], s[32];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.0f;
  RowState st{kNegInf, kNegInf, 0.0f, 0.0f};
  uint32_t pp[kBK / 16][4];  // P of the previous tile
  uint32_t qf[QREG ? HDP / 16 : 1][4];  // Q's A fragments (QREG)

  // Iteration t: S_t = Q K_t^T and O += P_{t-1} V_{t-1} are issued together;
  // tile t's softmax runs while P_{t-1} V_{t-1} computes; O is rescaled once
  // that product has landed. Tile 0 has no previous product.
  for (int t = 0; t < ntiles; ++t) {
    const int kv0 = t_lo + t * kBK;
    cp_wait<D - 1>();
    fence_async_smem();
    // Tile t landed; every warpgroup is done with iteration t - 1, so K
    // stage (t + D) % KS (last read by S_{t-1}) and V stage (t + D) % VS
    // (last read by P_{t-2} V_{t-2}) are free.
    __syncthreads();
    if (t + D < ntiles) {
      const int kvn = kv0 + D * kBK;
      load_tile<HDP, NT, kBK>(sk + ((t + D) % KS) * TILE, kp, p.k_ss, kvn, p.Skv, p.hd, vec);
      load_tile<HDP, NT, kBK>(sv + ((t + D) % VS) * TILE, vp, p.v_ss, kvn, p.Skv, p.hd, vec);
    }
    cp_commit();
    const bool full = kv0 + kBK <= p.Skv && (!p.causal || kv0 + kBK - 1 <= blk_first) &&
                      (p.window <= 0 || kv0 > blk_last - p.window);
    float alpha0, alpha1;
    fence_regs(o);
    fence_regs(s);
    // Q's fragments are written before the fence that orders register
    // writes ahead of the products reading them.
    if constexpr (QREG) {
      if (t == 0) load_q_frags<HDP>(qf, q_base);
    }
    wg_fence();
    if constexpr (QREG) {
      issue_qk<HDP>(s, qf, smem_addr(sk + (t % KS) * TILE));
    } else {
      issue_qk<HDP>(s, q_base, smem_addr(sk + (t % KS) * TILE));
    }
    wg_commit();
    if (t > 0) {
      issue_pv<HDP>(o, pp, smem_addr(sv + ((t - 1) % VS) * TILE));
      wg_commit();
      wg_wait<1>();
    } else {
      wg_wait<0>();
    }
    fence_regs(s);
    softmax_tile(s, p, full, kv0, pos0, lane, sl2, st, alpha0, alpha1);
    wg_wait<0>();
    fence_regs(o);
    fence_frags(pp);
    // Only now, with P_{t-1} V_{t-1} landed, are P_t's bf16 fragments written
    // over P_{t-1}'s: the compiler does not keep a wgmma's A registers from
    // being reused while the product is in flight.
#pragma unroll
    for (int i = 0; i < NO / 4; ++i) {
      o[4 * i] *= alpha0;
      o[4 * i + 1] *= alpha0;
      o[4 * i + 2] *= alpha1;
      o[4 * i + 3] *= alpha1;
    }
    pack_p(s, pp);
  }
  if (ntiles > 0) {  // the last tile's P V
    fence_regs(o);
    wg_fence();
    issue_pv<HDP>(o, pp, smem_addr(sv + ((ntiles - 1) % VS) * TILE));
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    fence_frags(pp);
  }
  cp_wait_all();

  // Row sums over the 4 threads of a row; rows with no live key end at 0.
  float l0 = st.l0, l1 = st.l1;
#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
  }
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f), inv1 = 1.0f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.out);
  if (vec) {
    // O leaves through this warpgroup's own rows of the Q tile (nothing
    // else reads them once its products are done), row-major with the
    // 16-byte chunks of each group of 8 XOR-swizzled by row % 8, so both the
    // fragment-order writes and the row-order reads are conflict-free and
    // each row goes out as 16-byte stores.
    constexpr int G = HDP / 8, GS = G & ~7;  // chunks a row; swizzled ones
    const int wg = threadIdx.x / 128;
    __nv_bfloat16* so = sq + wg * 64 * HDP;
    // Each thread copies Q rows of both warpgroups; without a tile, no
    // loop barrier has waited for the other warpgroup's copies yet.
    if (ntiles == 0) __syncthreads();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 - wg * 64 + 8 * half;
      const float inv = half ? inv1 : inv0;
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int c = i < GS ? i ^ (r & 7) : i;
        *reinterpret_cast<__nv_bfloat162*>(so + r * HDP + c * 8 + 2 * (lane % 4)) =
            __floats2bfloat162_rn(o[4 * i + 2 * half] * inv, o[4 * i + 2 * half + 1] * inv);
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");  // this warpgroup only
    for (int u = threadIdx.x % 128; u < 64 * G; u += 128) {
      const int r = u / G, i = u % G;
      const int row = q0 + wg * 64 + r;
      if (row >= p.Sq || i * 8 >= p.hd) continue;
      const int c = i < GS ? i ^ (r & 7) : i;
      *reinterpret_cast<int4*>(op + ((static_cast<long long>(b) * p.Sq + row) * p.H + h) * p.hd +
                               i * 8) = *reinterpret_cast<const int4*>(so + r * HDP + c * 8);
    }
    return;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + 8 * half;
    if (row >= p.Sq) continue;
    const float inv = half ? inv1 : inv0;
    __nv_bfloat16* orow = op + ((static_cast<long long>(b) * p.Sq + row) * p.H + h) * p.hd;
#pragma unroll
    for (int i = 0; i < HDP / 8; ++i) {
      const int c = 8 * i + 2 * (lane % 4);
      const float x0 = o[4 * i + 2 * half] * inv, x1 = o[4 * i + 2 * half + 1] * inv;
      if (c + 1 < p.hd && (p.hd % 2) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (c < p.hd) orow[c] = __float2bfloat16(x0);
        if (c + 1 < p.hd) orow[c + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int HDP, int WG>
int launch(const Params& p, int B, int vec, cudaStream_t s) {
  const size_t bytes = smem_bytes(HDP, WG);
  cudaError_t err = cudaFuncSetAttribute(flash_tc_kernel<HDP, WG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned nqt = static_cast<unsigned>((p.Sq + 64 * WG - 1) / (64 * WG));
  flash_tc_kernel<HDP, WG><<<dim3(nqt, p.H, B), 128 * WG, bytes, s>>>(p, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int WG>
int dispatch(const Params& p, int B, int vec, cudaStream_t s) {
  switch (pad16(p.hd)) {
    case 16: return launch<16, WG>(p, B, vec, s);
    case 32: return launch<32, WG>(p, B, vec, s);
    case 48: return launch<48, WG>(p, B, vec, s);
    case 64: return launch<64, WG>(p, B, vec, s);
    case 80: return launch<80, WG>(p, B, vec, s);
    case 96: return launch<96, WG>(p, B, vec, s);
    case 112: return launch<112, WG>(p, B, vec, s);
    case 128: return launch<128, WG>(p, B, vec, s);
    case 144: return launch<144, WG>(p, B, vec, s);
    case 160: return launch<160, WG>(p, B, vec, s);
    case 176: return launch<176, WG>(p, B, vec, s);
    case 192: return launch<192, WG>(p, B, vec, s);
    case 208: return launch<208, WG>(p, B, vec, s);
    case 224: return launch<224, WG>(p, B, vec, s);
    case 240: return launch<240, WG>(p, B, vec, s);
    default: return launch<256, WG>(p, B, vec, s);
  }
}

}  // namespace tc

// ===========================================================================
// SIMT kernel (f32)
// ===========================================================================

namespace simt {

constexpr int kBQ = 64;        // query rows a block
constexpr int kBK = 64;        // key rows a tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = kBQ / 16;
constexpr int kCols = kBK / 16;

// Reductions over the 16 threads of one tile row (lanes differing in bits 0-3).
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ __forceinline__ int padded_ld(int hd) { return (hd % 2 == 0) ? hd + 1 : hd; }

size_t smem_bytes(int hd) {
  const int ld = padded_ld(hd);
  return sizeof(float) * (static_cast<size_t>(kBQ) * ld + 2 * static_cast<size_t>(kBK) * ld +
                          static_cast<size_t>(kBQ) * (kBK + 1));
}

// rows x hd tile starting at row0 of a (seq, hd) slice with row stride ss -> smem.
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const float* __restrict__ src,
                                          long long ss, int row0, int nrows, int limit,
                                          int hd, int ld) {
  for (int idx = threadIdx.x; idx < nrows * hd; idx += kThreads) {
    const int r = idx / hd, d = idx - r * hd;
    const int row = row0 + r;
    dst[r * ld + d] = row < limit ? src[static_cast<long long>(row) * ss + d] : 0.0f;
  }
}

// NJ = output column groups a thread (ceil(hd / 16) <= NJ).
template <int NJ>
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
  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  load_tile(qs, qp + static_cast<long long>(q0) * p.q_ss, p.q_ss, 0, kBQ, p.Sq - q0, p.hd, ld);

  long long kv_lo, kv_hi;
  live_keys(p, q0, q0 + kBQ, &kv_lo, &kv_hi);
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

  float* op = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Sq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    float* orow = op + ((static_cast<long long>(b) * p.Sq + row) * p.H + h) * p.hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < p.hd) orow[d] = acc[i][j] * inv;
    }
  }
}

int dispatch(const Params& p, int B, cudaStream_t s) {
  const size_t bytes = smem_bytes(p.hd);
  const dim3 grid(static_cast<unsigned>((p.Sq + kBQ - 1) / kBQ), static_cast<unsigned>(p.H),
                  static_cast<unsigned>(B));
  cudaError_t err;
#define REPRO_FLASH_CASE(NJ)                                                              \
  err = cudaFuncSetAttribute(flash_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                             static_cast<int>(bytes));                                   \
  if (err != cudaSuccess) return static_cast<int>(err);                                  \
  flash_kernel<NJ><<<grid, kThreads, bytes, s>>>(p);                                     \
  return static_cast<int>(cudaGetLastError());
  if (p.hd <= 32) { REPRO_FLASH_CASE(2) }
  if (p.hd <= 64) { REPRO_FLASH_CASE(4) }
  if (p.hd <= 128) { REPRO_FLASH_CASE(8) }
  REPRO_FLASH_CASE(16)
#undef REPRO_FLASH_CASE
}

}  // namespace simt

}  // namespace

extern "C" {

// q: (B, Sq, H, hd) and k, v: (B, Skv, KV, hd), each with the given
// (batch, seq, head) strides in elements and a contiguous last axis, f32;
// out: (B, Sq, H, hd) contiguous f32. 1 <= hd <= 256, H % KV == 0, Sq >= 1,
// Skv >= 0, B and H <= 65535.
int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                          int B, int H, int KV, int Sq, int Skv, int hd,
                          long long q_sb, long long q_ss, long long q_sh,
                          long long k_sb, long long k_ss, long long k_sh,
                          long long v_sb, long long v_ss, long long v_sh,
                          int causal, int window, long long q_offset, float scale,
                          void* stream) {
  if (hd < 1 || hd > kMaxHd || KV < 1 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, out, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 H, KV, Sq, Skv, hd, causal, window, q_offset, scale};
  return simt::dispatch(p, B, static_cast<cudaStream_t>(stream));
}

// The tensor-core kernel: the same arguments, bf16 q, k, v and out; q_rows
// (64 or 128) the query rows a block; vec != 0 when hd % 8 == 0 and every
// row start of q, k and v is 16-byte aligned (16-byte cp.async copies),
// else the tiles are staged element by element.
int repro_flash_attention_tc(const void* q, const void* k, const void* v, void* out,
                             int B, int H, int KV, int Sq, int Skv, int hd,
                             long long q_sb, long long q_ss, long long q_sh,
                             long long k_sb, long long k_ss, long long k_sh,
                             long long v_sb, long long v_ss, long long v_sh,
                             int causal, int window, long long q_offset, float scale,
                             int q_rows, int vec, void* stream) {
  if (hd < 1 || hd > kMaxHd || KV < 1 || H % KV != 0 || (q_rows != 64 && q_rows != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, out, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 H, KV, Sq, Skv, hd, causal, window, q_offset, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return q_rows == 64 ? tc::dispatch<1>(p, B, vec, s) : tc::dispatch<2>(p, B, vec, s);
}

// Dynamic shared memory of the tensor-core kernel at head dim hd and q_rows.
long long repro_flash_tc_smem_bytes(int hd, int q_rows) {
  return static_cast<long long>(tc::smem_bytes(tc::pad16(hd), q_rows / 64));
}

}  // extern "C"
