// K1, K2 and K3 on bfloat16 inputs, on Hopper's tensor cores (sm_90a).
//
// Replaces, for bf16 q/k/v, the Pallas kernels of
// paddle_tpu/kernels/primitives/flash.py:
//   K1 `_fwd_kernel` (:78, launched by `_pallas_fwd` :221): O and lse of
//      softmax(q·kᵀ·scale + bias [+ causal mask])·v, online softmax;
//   K2 `_bwd_dq_kernel` (:130, launched by `_pallas_bwd` :253):
//      dQ = Σ_kv dS·K with P = exp(q·kᵀ·scale + bias - lse) and
//      dS = P·(dO·Vᵀ - delta)·scale;
//   K3 `_bwd_dkv_kernel` (:167, launched at :314): dV = Σ_q Pᵀ·dO,
//      dK = Σ_q dSᵀ·Q, dBias[k] = Σ_q dL with dL = P·(dP - delta).
// fp32 inputs take flash_tf32.cuh (K1-K3, split TF32);
// flash_attention.cu includes both headers, and its entry points send
// dtype code 1 (bf16) here.
//
// What bounds them on this card: at the BERT train step's shape
// (BH = 1536, S = 128, D = 64) K1 reads q, k, v and the bias rows and
// writes O and lse, 102.2 MB, 0.0305 ms at 3.35 TB/s, for 6.4 GFLOP
// (0.0065 ms at 989 TFLOP/s); K2 reads q, k, v, dO, the bias, lse and
// delta and writes dQ, 128.2 MB, 0.0383 ms, for 9.7 GFLOP; K3 moves
// 154.2 MB, 0.0460 ms, for 12.9 GFLOP.  About 64-77 flops a byte
// against the bf16 ridge of about 295: all three are bound by bytes.
// mma.sync gives several times the rate the byte bound needs, so no
// wgmma warpgroups.
//
// Design (FlashAttention-2's, for this card):
// - K1 and K2: one CTA of 4 warps per (bh, 64 query rows); each warp
//   owns 16 rows, which keeps a thread under 128 (K1) or 168 (K2)
//   registers, so four or three CTAs fit an SM.  At S = 128 the two
//   CTAs of a head start side by side, so the second read of its K and
//   V comes from L2.  K3: one CTA of 4 warps per (bh, 64 keys), each
//   warp owning 16 keys, looping over 64-query tiles (from the diagonal
//   tile when causal), so dK, dV and dBias need no atomics.  K2 loops
//   over 64-key tiles (up to the diagonal tile when causal), so dQ needs
//   none either.
// - Staging: operands stay bf16, unconverted, in shared tiles of 64 rows
//   padded to 72 elements (144 bytes: the eight 16-byte rows an
//   ldmatrix phase reads fall in eight different bank groups), filled by
//   16-byte cp.async.cg, zero-filled past S and past D (a zero source
//   size).  An operand whose base, (b, h, s) strides or D are not
//   multiples of 16 bytes is staged by scalar loads instead.  K1 keeps
//   two key and two value tiles: the copies of the first two key tiles
//   (four groups: Q with K(0), V(0), K(1), V(1)) are all in flight from
//   the start, and V(t) lands while S(t) is computed.  K3 stages its K
//   and V rows once through its second buffers into registers (A
//   fragments), then double-buffers the Q and dO tiles; K2, turned
//   round, does the same with its Q and dO rows and double-buffers the
//   K and V tiles, reading K once for both of its products (S = Q·Kᵀ
//   and dS·K).
// - Products: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, with
//   operands from ldmatrix (.trans where B is stored row-major: V in K1,
//   K in K2, dO and Q in K3).  S = Q·Kᵀ (K1, K2), dP = dO·Vᵀ (K2),
//   Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (K3) multiply bf16 operands and
//   accumulate in fp32, as the JAX kernel does after its exact upcast.
//   K2 takes a 64-key tile as two halves of 32 keys, which halves the
//   S and dP accumulators a thread holds beside its Q, dO and dQ
//   fragments.
// - Softmax in registers: the scale, the bias, the causal and j >= S
//   masks (-1e30, applied only in tiles that reach past S or the
//   diagonal) and the online max and sum stay in the mma accumulator
//   registers; a row's statistics are reduced over the quad of threads
//   that share it; exp is ex2.approx of (x - m)·log2(e).  A row whose l
//   is 0 gives O = 0, lse = m + log 1.  Causal rows whose keys are all
//   masked average the keys up to the end of their diagonal tile, as the
//   JAX kernel averages over its blocks.
// - P (K1), dS (K2), Pᵀ and dSᵀ (K3) go from the accumulators straight
//   into the A fragments of the second products and never touch shared
//   memory.  Rounding: P·V and Pᵀ·dO take P rounded to bf16 where the
//   JAX kernel keeps it fp32 (flash.py:114-115, 197): at most 2^-9
//   relative error a term, FlashAttention-2's standard choice.  Summed
//   over a key's S query rows that is up to 2^-8 of sum P·|dO|, which
//   outgrows dV's own bf16 rounding where dV cancels (a real key of a
//   short row: P ~ 1/n from every row); chip_smoke.py holds dK and dV to
//   that bound against the exact answer (flash.flash_bwd_dkv_bf16_bound),
//   not to 2e-2 of the plain version.  dS
//   is not bounded so: where every key of a row is masked, P is 1 for
//   every key (the JAX kernel's lse rounds to -1e30) and dS is of order
//   1, and its bf16 rounding alone would move dK and dQ by about
//   2^-9·sqrt(S) (0.013 at S = 128, outside the 2e-2 gate near 0).  So
//   dS·K (flash.py:160) and dSᵀ·Q (flash.py:201) are each two products,
//   dS rounded to bf16 and the remainder rounded to bf16, which hold dS
//   to about 2^-17: 16 more mma a 32-key half tile in K2, 8 more a
//   16-query chunk in K3, on kernels bound by bytes.  The row sum l, dL
//   and dBias stay fp32.
// - Outputs: O (K1), dQ (K2), dK and dV (K3) go from the accumulators
//   into shared memory (a warp's own rows), then out as whole rows, 16
//   bytes a lane, 8 lanes a 128-byte row.  Stored straight from the
//   accumulators, each 4-byte-a-lane store would touch eight rows 1,536
//   bytes apart (the [B, S, H, D] layout), half a 32-byte sector each.
// - Head dims: each kernel is instantiated at a head-dim capacity kD of
//   64 or 128 columns (D <= 64 takes 64, 64 < D <= 128 takes 128); the
//   tiles are zero-filled past D.  kD 64 is the design above, unchanged.
//   kD 128 doubles the d-chunks of every product and the O, dQ, dK, dV
//   accumulators (64 fp32 registers a thread each), so it runs under its
//   own launch bounds (2 CTAs an SM, at most 255 registers), and K2 and
//   K3 no longer hold their Q and dO (K2) or K and V rows (K3) as A
//   fragments (64 more registers): they stay in two more shared tiles,
//   read again by ldmatrix where a product needs them.
// - Shared memory: kD 64 static, under 48 KB: K1 46,592 bytes, K2
//   37,376, K3 37,888.  kD 128 (136-element rows) dynamic, set by
//   cudaFuncSetAttribute: K1 87,552, K2 104,960, K3 105,472.
// - ptxas (-Xptxas -v, sm_90a; chip_smoke.py phase 2 prints it with the
//   HMMA count of each kernel's SASS): K1 127 registers (launch bound:
//   4 CTAs an SM, at most 128), K3 168 (3 CTAs, at most 168), 0 bytes
//   spilled; 64 HMMA in K1's tile loop, 40 in K3's 16-query chunk.  K2
//   runs under the same bound as K3 (3 CTAs, at most 168): 168
//   registers, 0 bytes spilled, 128 HMMA in its tile loop (16 for S, 16
//   for dP and 32 for dQ in each half).  On the card K2 takes 0.0665 ms
//   at the train step's shape, 58% of its byte bound (the SIMT form took
//   0.495; SDPA's whole backward 0.195).  kD 128, under 2 CTAs an SM:
//   K1 168 (causal 174) registers, K2 224-226, K3 228, 0 bytes spilled;
//   128 HMMA in K1's tile loop, 256 in K2's, 80 in K3's chunk.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include "launch_count.cuh"

#include <cstdint>
#include <type_traits>

namespace flash_tc {

constexpr float kNegInf = -1e30f;  // the JAX kernel's mask constant

struct Strides {
  long long b, h, s;
};

template <typename T>
__device__ __forceinline__ T* head(T* p, Strides st, int bh, int H) {
  return p + (long long)(bh / H) * st.b + (long long)(bh % H) * st.h;
}

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;       // query rows (K1, K2) or keys (K3) of a CTA
constexpr int kStep = 64;       // keys (K1, K2) or queries (K3) of a stage
constexpr int kThreadsTc = 128; // 4 warps, 16 rows each
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStaticSmemMax = 48 * 1024;  // above it, dynamic only

// The tiles of a head-dim capacity kD (64 or 128 columns): rows padded
// by 8 elements (16 bytes), and each kernel's shared memory in bytes: a
// K1 CTA (Q, two K and two V tiles, two bias rows), a K2 CTA (two K and
// two V tiles, two bias rows) and a K3 CTA (two Q and two dO tiles, at
// kD 128 also a K and a V tile, two lse and two delta rows)
template <int kD>
struct Geo {
  static_assert(kD == 64 || kD == 128, "head-dim capacity 64 or 128");
  static constexpr int kLd = kD + 8;
  static constexpr int kElems = 64 * kLd;
  static constexpr int kChunkShift = kD == 64 ? 3 : 4;  // log2(kD / 8)
  // kD 64 keeps K2's Q and dO rows and K3's K and V rows in registers
  // (A fragments); kD 128 keeps them in shared tiles
  static constexpr bool kHoldRows = kD == 64;
  static constexpr int kFwdSmem = 5 * kElems * 2 + 2 * kStep * 4;
  static constexpr int kDqSmem =
      (kHoldRows ? 4 : 6) * kElems * 2 + 2 * kStep * 4;
  static constexpr int kDkvSmem =
      (kHoldRows ? 4 : 6) * kElems * 2 + 4 * kStep * 4;
  static constexpr bool kStatic = kD == 64;  // every kernel under 48 KB
};

// A kernel's shared memory: a static array where it fits under 48 KB
// (kD 64), else the dynamic allocation its launch sets up.  Declared in
// the kernel (a static array of 16 bytes where unused), so every
// address derived from it stays in the shared space.
#define FLASH_TC_SMEM(name, bytes)                                         \
  __shared__ __align__(16) unsigned char name##_static[G::kStatic ? (bytes) \
                                                                  : 16];   \
  extern __shared__ __align__(16) unsigned char flash_tc_dynamic[];        \
  unsigned char* name = G::kStatic ? name##_static : flash_tc_dynamic

// Before a launch: allow `bytes` of dynamic shared memory where they pass
// the static limit.  Returns the dynamic bytes the launch passes (0 for
// a static kernel) in *dyn.
template <typename Kernel>
inline cudaError_t smem_setup(Kernel kernel, int bytes, int* dyn) {
  *dyn = bytes <= kStaticSmemMax ? 0 : bytes;
  if (*dyn == 0) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` (0 or 16) of them read, the rest
// zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8m..8m+7 address the rows of matrix m
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16x8 fp32) += a (16x16 bf16, row) · b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// dS as two bf16 A-fragment pairs, hi = dS rounded and lo = the rest
// rounded, so hi + lo holds dS to about 2^-17 relative
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// 2^x on the special-function unit (flushes results below 2^-126 to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Stage rows [row0, row0 + 64) x [0, kD) of a [S, D] bf16 matrix (row
// stride ss) into dst (Geo<kD>::kLd stride).  Rows past S and columns
// past D are zeros.  vec: 16-byte cp.async (asynchronous, completes at a
// later wait); else scalar loads, done when the call returns.
template <int kD>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           long long ss, int row0, int S,
                                           int D, bool vec) {
  constexpr int kLd = Geo<kD>::kLd, kChunks = kD / 8;  // 16 bytes each
  constexpr int kShift = Geo<kD>::kChunkShift;
  if (vec) {
#pragma unroll
    for (int it = 0; it < 64 * kChunks / kThreadsTc; ++it) {
      const int c = threadIdx.x + it * kThreadsTc;
      const int r = c >> kShift, col = (c & (kChunks - 1)) << 3;
      const int row = row0 + r;
      const bool ok = row < S && col < D;
      cp_async16(dst + r * kLd + col, ok ? src + row * ss + col : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int it = 0; it < 64 * kD / kThreadsTc; ++it) {
      const int e = threadIdx.x + it * kThreadsTc;
      const int r = e >> (kShift + 3), col = e & (kD - 1), row = row0 + r;
      dst[r * kLd + col] = (row < S && col < D) ? src[row * ss + col]
                                                : __float2bfloat16(0.f);
    }
  }
}

// Stage the 64 fp32 entries [i0, i0 + 64) of a row vector (zeros past S).
__device__ __forceinline__ void stage_row(float* dst, const float* src,
                                          int i0, int S) {
  if (threadIdx.x < 64) {
    const int i = i0 + threadIdx.x;
    cp_async4(dst + threadIdx.x, i < S ? src + i : src, i < S ? 4 : 0);
  }
}

// ldmatrix row address of lane `lane` for the A operand (16 rows from
// r0, 16 columns from c0), or for two B n-blocks stored [n][k] (rows r0..
// r0+15 are n, columns c0.. are k): matrices (r0, c0), (r0+8, c0),
// (r0, c0+8), (r0+8, c0+8) for A; (r0, c0), (r0, c0+8), (r0+8, c0),
// (r0+8, c0+8) for B, whose registers are then b0, b1 of n-block r0
// and b0, b1 of n-block r0 + 8.  A B stored [k][n] (rows r0.. are k,
// columns c0..c0+15 two n-blocks) takes a_addr's addresses with
// ldmatrix .trans: b0, b1 of n-block c0, then of n-block c0 + 8.
template <int kD>
__device__ __forceinline__ const bf16* a_addr(const bf16* t, int r0, int c0,
                                              int lane) {
  return t + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * Geo<kD>::kLd + c0 +
         (lane >> 4) * 8;
}
template <int kD>
__device__ __forceinline__ const bf16* b_addr(const bf16* t, int r0, int c0,
                                              int lane) {
  return t + (r0 + (lane & 7) + (lane >> 4) * 8) * Geo<kD>::kLd + c0 +
         ((lane >> 3) & 1) * 8;
}

// A warp stores 16 rows (Geo<kD>::kLd stride in shared memory) as rows
// row0.. of a [S, D] bf16 matrix (row stride ss): 16 bytes a lane, kD/8
// lanes a row, where aligned (vec); else element by element.  Rows past
// S and columns past D are not written.
template <int kD>
__device__ __forceinline__ void store_rows(bf16* dst, long long ss,
                                           const bf16* src, int row0, int S,
                                           int D, int lane, bool vec) {
  constexpr int kChunks = kD / 8, kShift = Geo<kD>::kChunkShift;
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const int c = lane + it * 32, r = c >> kShift;
    const int col = (c & (kChunks - 1)) << 3;
    const int row = row0 + r;
    if (row >= S) continue;
    bf16* out = dst + row * ss + col;
    const bf16* in = src + r * Geo<kD>::kLd + col;
    if (vec) {  // D % 8 == 0
      if (col < D)
        *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(in);
    } else {
      for (int e = 0; e < 8 && col + e < D; ++e) out[e] = in[e];
    }
  }
}

// ---------------------------------------------------------------------------
// K1.  grid (query tiles of 64 rows, B*H), 128 threads.  Warp w owns
// rows 16w..16w + 15 of the tile; thread (lane 4g + t) holds
// rows g and g + 8: their scores of keys 8n + 2t, + 1 of each 8-key
// n-block, and their O of dims 8n + 2t, + 1.
// ---------------------------------------------------------------------------

// One key tile's online-softmax step for a row block: s (the raw
// products) becomes P; m, l and acc (kN 8-column blocks of O) are
// rescaled.  kMask: the tile holds keys past S or past the causal
// diagonal.
template <bool kCausal, bool kMask, int kN>
__device__ __forceinline__ void softmax_step(float (&s)[8][4],
                                             float (&acc)[kN][4],
                                             float (&m)[2], float (&l)[2],
                                             const float* bt, int k0, int S,
                                             int row0, int tig, float scale) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int jl = n * 8 + 2 * tig + (e & 1), j = k0 + jl;
      float x = fmaf(s[n][e], scale, bt[jl]);
      if (kMask && (j >= S || (kCausal && j > row0 + (e >> 1) * 8)))
        x = kNegInf;
      s[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    // m - m_new is exact when both are -1e30: alpha 1, no NaN
    alpha[r] = ex2((m[r] - m_new) * kLog2e);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2((s[n][e] - m[e >> 1]) * kLog2e);
      // a key past S adds nothing even while m is -1e30
      if (kMask && k0 + n * 8 + 2 * tig + (e & 1) >= S) p = 0.f;
      s[n][e] = p;
      l[e >> 1] += p;
      acc[n][e] *= alpha[e >> 1];
    }
#pragma unroll
  for (int n = 8; n < kN; ++n)  // the O columns past 64 (kD 128)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
}

template <bool kCausal, int kD>
__global__ void __launch_bounds__(kThreadsTc, kD == 64 ? 4 : 2)
    flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ bias,
                 bf16* __restrict__ o, float* __restrict__ lse, int H, int S,
                 int D, Strides sq, Strides sk, Strides sv, Strides so,
                 float scale, int vec) {
  using G = Geo<kD>;
  count_launch(0);
  FLASH_TC_SMEM(smem, G::kFwdSmem);
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // the query tile
  bf16* Ks = Qs + G::kElems;                 // two key tiles
  bf16* Vs = Ks + 2 * G::kElems;             // two value tiles
  float* Bs = reinterpret_cast<float*>(Vs + 2 * G::kElems);  // two bias rows
  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const bf16* kh = head(k, sk, bh, H);
  const bf16* vh = head(v, sv, bh, H);
  const float* brow = bias + (long long)bh * S;
  const bool vk = vec & 2, vv = vec & 4;

  const int kv_end = kCausal ? min(S, q0 + kRows) : S;
  const int n_tiles = (kv_end + kStep - 1) / kStep;
  // Four copy groups in flight from the start: Q with K(0), V(0), K(1),
  // V(1); each later tile's pair is started into the buffers the tile two
  // back has freed.  A group may be empty: the count stays fixed.
  auto prefetch = [&](int t) {
    const int buf = t & 1;
    if (t < n_tiles) {
      stage_tile<kD>(Ks + buf * G::kElems, kh, sk.s, t * kStep, S, D, vk);
      stage_row(Bs + buf * kStep, brow, t * kStep, S);
    }
    cp_async_commit();
    if (t < n_tiles)
      stage_tile<kD>(Vs + buf * G::kElems, vh, sv.s, t * kStep, S, D, vv);
    cp_async_commit();
  };
  stage_tile<kD>(Qs, head(q, sq, bh, H), sq.s, q0, S, D, vec & 1);
  prefetch(0);
  prefetch(1);

  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;  // and row0 + 8

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kStep;
    cp_async_wait<3>();  // K(t) and its bias are in
    __syncthreads();
    const bf16* Kt = Ks + (t & 1) * G::kElems;
    const bf16* Vt = Vs + (t & 1) * G::kElems;
    const float* bt = Bs + (t & 1) * kStep;

    // S = Q·Kᵀ: 16 rows x 64 keys a warp; Q's fragments are read again
    // each tile, which keeps them out of the registers
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kD / 16; ++kc) {
      unsigned qf[4];
      ldsm_x4(qf, a_addr<kD>(Qs, warp * 16, kc * 16, lane));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned b[4];
        ldsm_x4(b, b_addr<kD>(Kt, np * 16, kc * 16, lane));
        mma16816(s[2 * np], qf, b[0], b[1]);
        mma16816(s[2 * np + 1], qf, b[2], b[3]);
      }
    }
    if (k0 + kStep > S || (kCausal && k0 + kStep - 1 > q0))
      softmax_step<kCausal, true>(s, acc, m, l, bt, k0, S, row0, tig, scale);
    else
      softmax_step<kCausal, false>(s, acc, m, l, bt, k0, S, row0, tig,
                                   scale);

    cp_async_wait<2>();  // V(t) is in
    __syncthreads();
    // O += P·V: P from the accumulators as bf16 A fragments, 16 keys a
    // k-chunk; V [key][d] read transposed
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const unsigned a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        unsigned b[4];
        ldsm_x4_t(b, a_addr<kD>(Vt, kc * 16, dp * 16, lane));
        mma16816(acc[2 * dp], a, b[0], b[1]);
        mma16816(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
    if (t + 2 < n_tiles) __syncthreads();  // every warp is done with t
    prefetch(t + 2);
  }

  // O through shared memory: each warp writes its 16 rows into its own
  // rows of the Q tile (no other warp reads them), then stores them as
  // whole rows
  bf16* Ow = Qs + warp * 16 * G::kLd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_row = quad_sum(l[r]);
    const float l_safe = l_row == 0.f ? 1.f : l_row;
    const float inv = 1.f / l_safe;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      *reinterpret_cast<unsigned*>(Ow + (g + r * 8) * G::kLd + n * 8 +
                                   2 * tig) =
          pack_bf16(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    const int i = row0 + r * 8;
    if (tig == 0 && i < S) lse[(long long)bh * S + i] = m[r] + logf(l_safe);
  }
  __syncwarp();
  store_rows<kD>(head(o, so, bh, H), so.s, Ow, q0 + warp * 16, S, D, lane,
                 vec & 8);
}

// The A fragment of d-chunk kc of this warp's 16 rows (K2: queries, K3:
// keys): held in registers (kD 64) or read from its resident shared
// tile (kD 128)
template <int kD, int kN>
__device__ __forceinline__ void row_frag(unsigned (&a)[4],
                                         const unsigned (&held)[kN][4],
                                         const bf16* tile, int kc, int warp,
                                         int lane) {
  if constexpr (Geo<kD>::kHoldRows) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = held[kc][i];
  } else {
    ldsm_x4(a, a_addr<kD>(tile, warp * 16, kc * 16, lane));
  }
}

// ---------------------------------------------------------------------------
// K2.  grid (query tiles of 64 rows, B*H), 128 threads.  Warp w owns
// rows 16w..16w + 15 of the tile, as in K1; thread (lane 4g + t) holds
// rows g and g + 8: their scores and dS of keys 8n + 2t, + 1 of each
// 8-key n-block of a 32-key half tile, and their dQ of dims 8n + 2t, + 1.
// ---------------------------------------------------------------------------
template <bool kCausal, int kD>
__global__ void __launch_bounds__(kThreadsTc, kD == 64 ? 3 : 2)
    flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const float* __restrict__ bias,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int H, int S, int D, Strides sq, Strides sk, Strides sv,
                    Strides sdo, Strides sdq, float scale, int vec) {
  using G = Geo<kD>;
  constexpr bool kHold = G::kHoldRows;
  count_launch(1);
  FLASH_TC_SMEM(smem, G::kDqSmem);
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // two key tiles
  bf16* Vs = Ks + 2 * G::kElems;             // two value tiles
  // kD 128: the Q and dO tiles of this CTA's rows, resident
  bf16* QDs = Vs + 2 * G::kElems;
  // two bias rows
  float* Bs = reinterpret_cast<float*>(QDs + (kHold ? 0 : 2 * G::kElems));
  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const bf16* kh = head(k, sk, bh, H);
  const bf16* vh = head(v, sv, bh, H);
  const float* brow = bias + (long long)bh * S;
  const bool vk = vec & 2, vv = vec & 4;

  const int kv_end = kCausal ? min(S, q0 + kRows) : S;
  const int n_tiles = (kv_end + kStep - 1) / kStep;
  // Q and dO of this CTA's rows go through the second buffers once (kD
  // 64: into registers), or into their resident tiles (kD 128)
  bf16* Qres = kHold ? Ks + G::kElems : QDs;
  bf16* dOres = kHold ? Vs + G::kElems : QDs + G::kElems;
  stage_tile<kD>(Qres, head(q, sq, bh, H), sq.s, q0, S, D, vec & 1);
  stage_tile<kD>(dOres, head(dout, sdo, bh, H), sdo.s, q0, S, D, vec & 8);
  stage_tile<kD>(Ks, kh, sk.s, 0, S, D, vk);
  stage_tile<kD>(Vs, vh, sv.s, 0, S, D, vv);
  stage_row(Bs, brow, 0, S);
  cp_async_commit();
  const int row0 = q0 + warp * 16 + g;  // and row0 + 8
  float lse_r[2], delta_r[2];           // read once
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + r * 8;
    lse_r[r] = i < S ? lse[(long long)bh * S + i] : 0.f;
    delta_r[r] = i < S ? delta[(long long)bh * S + i] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  // this warp's 16 rows, kD/16 d-chunks (kD 64; one unused at kD 128)
  constexpr int kHeld = kHold ? kD / 16 : 1;
  unsigned qf[kHeld][4], dof[kHeld][4];
  if constexpr (kHold) {
#pragma unroll
    for (int kc = 0; kc < kHeld; ++kc) {
      ldsm_x4(qf[kc], a_addr<kD>(Qres, warp * 16, kc * 16, lane));
      ldsm_x4(dof[kc], a_addr<kD>(dOres, warp * 16, kc * 16, lane));
    }
    __syncthreads();  // the second buffers are free for tile 1
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t > 0) {
      cp_async_wait<0>();
      __syncthreads();  // tile t is in; every warp is done with t - 1
    }
    const int k0 = t * kStep;
    if (t + 1 < n_tiles) {
      const int nb = (t + 1) & 1, k1 = k0 + kStep;
      stage_tile<kD>(Ks + nb * G::kElems, kh, sk.s, k1, S, D, vk);
      stage_tile<kD>(Vs + nb * G::kElems, vh, sv.s, k1, S, D, vv);
      stage_row(Bs + nb * kStep, brow, k1, S);
      cp_async_commit();
    }
    const bf16* Kt = Ks + (t & 1) * G::kElems;
    const bf16* Vt = Vs + (t & 1) * G::kElems;
    const float* bt = Bs + (t & 1) * kStep;
    // the tile holds keys past S or crosses the diagonal
    const bool edge = k0 + kStep > S || (kCausal && k0 + kStep - 1 > q0);

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {  // 32 keys at a time
      const int j0 = hh * 32;
      // S = Q·Kᵀ and dP = dO·Vᵀ: 16 rows x 32 keys, 4 n-blocks
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kD / 16; ++kc) {
        unsigned qa[4], da[4];
        row_frag<kD>(qa, qf, Qres, kc, warp, lane);
        row_frag<kD>(da, dof, dOres, kc, warp, lane);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          unsigned b[4];
          ldsm_x4(b, b_addr<kD>(Kt, j0 + np * 16, kc * 16, lane));
          mma16816(s[2 * np], qa, b[0], b[1]);
          mma16816(s[2 * np + 1], qa, b[2], b[3]);
          ldsm_x4(b, b_addr<kD>(Vt, j0 + np * 16, kc * 16, lane));
          mma16816(dp[2 * np], da, b[0], b[1]);
          mma16816(dp[2 * np + 1], da, b[2], b[3]);
        }
      }
      // P = exp(S·scale + bias_j - lse_i), dS = P∘(dP - delta_i)·scale
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jl = j0 + n * 8 + 2 * tig + (e & 1), r = e >> 1;
          float p = ex2((fmaf(s[n][e], scale, bt[jl]) - lse_r[r]) * kLog2e);
          const int j = k0 + jl;
          if (edge && (j >= S || (kCausal && j > row0 + r * 8))) p = 0.f;
          s[n][e] = p * (dp[n][e] - delta_r[r]) * scale;
        }
      // dQ += dS·K (dS as hi + lo), 16 keys a k-chunk; K [key][d] read
      // transposed
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        unsigned sa[4], sl[4];
        split_bf16(s[2 * kc][0], s[2 * kc][1], sa[0], sl[0]);
        split_bf16(s[2 * kc][2], s[2 * kc][3], sa[1], sl[1]);
        split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], sa[2], sl[2]);
        split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], sa[3], sl[3]);
#pragma unroll
        for (int dp2 = 0; dp2 < kD / 16; ++dp2) {
          unsigned b[4];
          ldsm_x4_t(b, a_addr<kD>(Kt, j0 + kc * 16, dp2 * 16, lane));
          mma16816(acc[2 * dp2], sa, b[0], b[1]);
          mma16816(acc[2 * dp2 + 1], sa, b[2], b[3]);
          mma16816(acc[2 * dp2], sl, b[0], b[1]);
          mma16816(acc[2 * dp2 + 1], sl, b[2], b[3]);
        }
      }
    }
  }

  // dQ through shared memory (the key tiles are free once every warp is
  // done): each warp writes its 16 rows, then stores them as whole rows
  __syncthreads();
  bf16* Ow = Ks + warp * 16 * G::kLd;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      *reinterpret_cast<unsigned*>(Ow + (g + r * 8) * G::kLd + n * 8 +
                                   2 * tig) =
          pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  __syncwarp();
  store_rows<kD>(head(dq, sdq, bh, H), sdq.s, Ow, q0 + warp * 16, S, D,
                 lane, vec & 16);
}

// ---------------------------------------------------------------------------
// K3.  grid (key tiles, B*H), 128 threads.  Thread (warp w, lane 4g + t)
// holds keys k0 + 16w + g and + 8: their transposed scores of queries
// 8n + 2t, + 1 of each 8-query n-block, and their dK, dV of dims
// 8n + 2t, + 1.
// ---------------------------------------------------------------------------

template <bool kCausal, int kD>
__global__ void __launch_bounds__(kThreadsTc, kD == 64 ? 3 : 2)
    flash_bwd_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const float* __restrict__ bias,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, float* __restrict__ dbias, int H,
                     int S, int D, Strides sq, Strides sk, Strides sv,
                     Strides sdo, Strides sdk, Strides sdv, float scale,
                     int vec) {
  using G = Geo<kD>;
  constexpr bool kHold = G::kHoldRows;
  count_launch(2);
  FLASH_TC_SMEM(smem, G::kDkvSmem);
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // two query tiles
  bf16* dOs = Qs + 2 * G::kElems;            // two dO tiles
  // kD 128: the K and V tiles of this CTA's keys, resident
  bf16* KVs = dOs + 2 * G::kElems;
  float* Ls = reinterpret_cast<float*>(KVs + (kHold ? 0 : 2 * G::kElems));
  float* Dl = Ls + 2 * kStep;  // two lse rows, then two delta rows
  const int bh = blockIdx.y, k0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const bf16* qh = head(q, sq, bh, H);
  const bf16* doh = head(dout, sdo, bh, H);
  const float* lrow = lse + (long long)bh * S;
  const float* drow = delta + (long long)bh * S;
  const bool vq = vec & 1, vdo = vec & 8;

  const int q_begin = kCausal ? k0 : 0;
  const int n_tiles = (S - q_begin + kStep - 1) / kStep;
  // K and V of this CTA's keys go through the second buffers once (kD
  // 64: into registers), or into their resident tiles (kD 128)
  bf16* Kres = kHold ? Qs + G::kElems : KVs;
  bf16* Vres = kHold ? dOs + G::kElems : KVs + G::kElems;
  stage_tile<kD>(Kres, head(k, sk, bh, H), sk.s, k0, S, D, vec & 2);
  stage_tile<kD>(Vres, head(v, sv, bh, H), sv.s, k0, S, D, vec & 4);
  stage_tile<kD>(Qs, qh, sq.s, q_begin, S, D, vq);
  stage_tile<kD>(dOs, doh, sdo.s, q_begin, S, D, vdo);
  stage_row(Ls, lrow, q_begin, S);
  stage_row(Dl, drow, q_begin, S);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // this warp's 16 keys, kD/16 d-chunks (kD 64; one unused at kD 128)
  constexpr int kHeld = kHold ? kD / 16 : 1;
  unsigned kf[kHeld][4], vf[kHeld][4];
  if constexpr (kHold) {
#pragma unroll
    for (int kc = 0; kc < kHeld; ++kc) {
      ldsm_x4(kf[kc], a_addr<kD>(Kres, warp * 16, kc * 16, lane));
      ldsm_x4(vf[kc], a_addr<kD>(Vres, warp * 16, kc * 16, lane));
    }
    __syncthreads();  // the second buffers are free for tile 1
  }

  const int key_j[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const float* brow = bias + (long long)bh * S;
  float bj[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) bj[r] = key_j[r] < S ? brow[key_j[r]] : 0.f;
  float dk_acc[kD / 8][4], dv_acc[kD / 8][4], db[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t > 0) {
      cp_async_wait<0>();
      __syncthreads();  // tile t is in; every warp is done with t - 1
    }
    const int qt0 = q_begin + t * kStep;
    if (t + 1 < n_tiles) {
      const int nb = (t + 1) & 1, q1 = qt0 + kStep;
      stage_tile<kD>(Qs + nb * G::kElems, qh, sq.s, q1, S, D, vq);
      stage_tile<kD>(dOs + nb * G::kElems, doh, sdo.s, q1, S, D, vdo);
      stage_row(Ls + nb * kStep, lrow, q1, S);
      stage_row(Dl + nb * kStep, drow, q1, S);
      cp_async_commit();
    }
    const bf16* Qt = Qs + (t & 1) * G::kElems;
    const bf16* dOt = dOs + (t & 1) * G::kElems;
    const float* lt = Ls + (t & 1) * kStep;
    const float* dt = Dl + (t & 1) * kStep;
    // the tile holds queries or keys past S, or crosses the diagonal
    const bool edge = qt0 + kStep > S || k0 + kRows > S ||
                      (kCausal && qt0 < k0 + kRows - 1);

    for (int qc = 0; qc < kStep / 16; ++qc) {  // 16 queries at a time
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: 16 keys x 16 queries, 2 n-blocks
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kD / 16; ++kc) {
        unsigned a[4], b[4];
        row_frag<kD>(a, kf, Kres, kc, warp, lane);
        ldsm_x4(b, b_addr<kD>(Qt, qc * 16, kc * 16, lane));
        mma16816(st[0], a, b[0], b[1]);
        mma16816(st[1], a, b[2], b[3]);
        row_frag<kD>(a, vf, Vres, kc, warp, lane);
        ldsm_x4(b, b_addr<kD>(dOt, qc * 16, kc * 16, lane));
        mma16816(dpt[0], a, b[0], b[1]);
        mma16816(dpt[1], a, b[2], b[3]);
      }
      // Pᵀ = exp(Sᵀ·scale + bias_j - lse_i), dLᵀ = Pᵀ∘(dPᵀ - delta_i)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = qc * 16 + n * 8 + 2 * tig + (e & 1), i = qt0 + il;
          const int r = e >> 1, j = key_j[r];
          float p = ex2((fmaf(st[n][e], scale, bj[r]) - lt[il]) * kLog2e);
          if (edge && (i >= S || j >= S || (kCausal && j > i))) p = 0.f;
          const float dl = p * (dpt[n][e] - dt[il]);
          db[r] += dl;
          st[n][e] = p;
          dpt[n][e] = dl * scale;
        }
      // dV += Pᵀ·dO and dK += dSᵀ·Q (dS as hi + lo), dO and Q
      // [query][d] read transposed
      const unsigned pa[4] = {pack_bf16(st[0][0], st[0][1]),
                              pack_bf16(st[0][2], st[0][3]),
                              pack_bf16(st[1][0], st[1][1]),
                              pack_bf16(st[1][2], st[1][3])};
      unsigned sa[4], sl[4];
      split_bf16(dpt[0][0], dpt[0][1], sa[0], sl[0]);
      split_bf16(dpt[0][2], dpt[0][3], sa[1], sl[1]);
      split_bf16(dpt[1][0], dpt[1][1], sa[2], sl[2]);
      split_bf16(dpt[1][2], dpt[1][3], sa[3], sl[3]);
#pragma unroll
      for (int dp = 0; dp < kD / 16; ++dp) {
        unsigned b[4];
        ldsm_x4_t(b, a_addr<kD>(dOt, qc * 16, dp * 16, lane));
        mma16816(dv_acc[2 * dp], pa, b[0], b[1]);
        mma16816(dv_acc[2 * dp + 1], pa, b[2], b[3]);
        ldsm_x4_t(b, a_addr<kD>(Qt, qc * 16, dp * 16, lane));
        mma16816(dk_acc[2 * dp], sa, b[0], b[1]);
        mma16816(dk_acc[2 * dp + 1], sa, b[2], b[3]);
        mma16816(dk_acc[2 * dp], sl, b[0], b[1]);
        mma16816(dk_acc[2 * dp + 1], sl, b[2], b[3]);
      }
    }
  }

  // dK and dV through shared memory (the query tiles are free once every
  // warp is done): each warp writes its 16 keys' rows of dK, then of dV,
  // then stores them as whole rows
  __syncthreads();
  bf16* Ew = Qs + warp * 32 * G::kLd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float dbj = quad_sum(db[r]);
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int at = (g + r * 8) * G::kLd + n * 8 + 2 * tig;
      *reinterpret_cast<unsigned*>(Ew + at) =
          pack_bf16(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<unsigned*>(Ew + 16 * G::kLd + at) =
          pack_bf16(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
    const int j = key_j[r];
    if (tig == 0 && j < S) dbias[(long long)bh * S + j] = dbj;
  }
  __syncwarp();
  const int j0 = k0 + warp * 16;
  store_rows<kD>(head(dk, sdk, bh, H), sdk.s, Ew, j0, S, D, lane, vec & 16);
  store_rows<kD>(head(dv, sdv, bh, H), sdv.s, Ew + 16 * G::kLd, j0, S, D,
                 lane, vec & 32);
}

// 1 when an operand's base and (b, h, s) element strides, and D, allow
// 16-byte copies of its rows
inline int vec16(const void* p, const long long* st, int D) {
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && D % 8 == 0 &&
         st[0] % 8 == 0 && st[1] % 8 == 0 && st[2] % 8 == 0;
}

// Calls f(std::integral_constant<int, kD>{}) at D's head-dim capacity
// kD: 64 for D <= 64, else 128.  Every flash launcher (bf16 here, fp32
// split TF32 in flash_tf32.cuh) picks its instantiation through this;
// the entry points have refused D > 128.
template <typename F>
cudaError_t with_capacity(int D, F&& f) {
  if (D <= 64) return f(std::integral_constant<int, 64>{});
  return f(std::integral_constant<int, 128>{});
}

template <bool kCausal, int kD>
cudaError_t fwd_d(const void* q, const void* k, const void* v,
                  const float* bias, void* o, float* lse, int B, int H,
                  int S, int D, const long long* st, float scale,
                  cudaStream_t s) {
  const int vec = vec16(q, st, D) | vec16(k, st + 3, D) << 1 |
                  vec16(v, st + 6, D) << 2 | vec16(o, st + 9, D) << 3;
  auto kernel = flash_fwd_tc<kCausal, kD>;
  int dyn = 0;
  cudaError_t e = smem_setup(kernel, Geo<kD>::kFwdSmem, &dyn);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kRows - 1) / kRows, B * H);
  kernel<<<grid, kThreadsTc, dyn, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), bias, static_cast<bf16*>(o), lse, H, S, D,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, scale,
      vec);
  return cudaGetLastError();
}

template <bool kCausal>
cudaError_t fwd(const void* q, const void* k, const void* v,
                const float* bias, void* o, float* lse, int B, int H, int S,
                int D, const long long* st, float scale, cudaStream_t s) {
  return with_capacity(D, [&](auto kD) {
    return fwd_d<kCausal, decltype(kD)::value>(q, k, v, bias, o, lse, B, H,
                                               S, D, st, scale, s);
  });
}

template <bool kCausal, int kD>
cudaError_t bwd_dq_d(const void* q, const void* k, const void* v,
                     const float* bias, const void* dout, const float* lse,
                     const float* delta, void* dq, int B, int H, int S, int D,
                     const long long* st, float scale, cudaStream_t s) {
  const int vec = vec16(q, st, D) | vec16(k, st + 3, D) << 1 |
                  vec16(v, st + 6, D) << 2 | vec16(dout, st + 9, D) << 3 |
                  vec16(dq, st + 12, D) << 4;
  auto kernel = flash_bwd_dq_tc<kCausal, kD>;
  int dyn = 0;
  cudaError_t e = smem_setup(kernel, Geo<kD>::kDqSmem, &dyn);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kRows - 1) / kRows, B * H);
  kernel<<<grid, kThreadsTc, dyn, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), bias, static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dq), H, S, D, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]}, Strides{st[12], st[13], st[14]}, scale,
      vec);
  return cudaGetLastError();
}

template <bool kCausal>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const float* bias, const void* dout, const float* lse,
                   const float* delta, void* dq, int B, int H, int S, int D,
                   const long long* st, float scale, cudaStream_t s) {
  return with_capacity(D, [&](auto kD) {
    return bwd_dq_d<kCausal, decltype(kD)::value>(
        q, k, v, bias, dout, lse, delta, dq, B, H, S, D, st, scale, s);
  });
}

template <bool kCausal, int kD>
cudaError_t bwd_dkv_d(const void* q, const void* k, const void* v,
                      const float* bias, const void* dout, const float* lse,
                      const float* delta, void* dk, void* dv, float* dbias,
                      int B, int H, int S, int D, const long long* st,
                      float scale, cudaStream_t s) {
  const int vec = vec16(q, st, D) | vec16(k, st + 3, D) << 1 |
                  vec16(v, st + 6, D) << 2 | vec16(dout, st + 9, D) << 3 |
                  vec16(dk, st + 12, D) << 4 | vec16(dv, st + 15, D) << 5;
  auto kernel = flash_bwd_dkv_tc<kCausal, kD>;
  int dyn = 0;
  cudaError_t e = smem_setup(kernel, Geo<kD>::kDkvSmem, &dyn);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kRows - 1) / kRows, B * H);
  kernel<<<grid, kThreadsTc, dyn, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), bias, static_cast<const bf16*>(dout), lse,
      delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), dbias, H, S, D,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      Strides{st[12], st[13], st[14]}, Strides{st[15], st[16], st[17]},
      scale, vec);
  return cudaGetLastError();
}

template <bool kCausal>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const float* bias, const void* dout, const float* lse,
                    const float* delta, void* dk, void* dv, float* dbias,
                    int B, int H, int S, int D, const long long* st,
                    float scale, cudaStream_t s) {
  return with_capacity(D, [&](auto kD) {
    return bwd_dkv_d<kCausal, decltype(kD)::value>(
        q, k, v, bias, dout, lse, delta, dk, dv, dbias, B, H, S, D, st,
        scale, s);
  });
}

}  // namespace flash_tc
