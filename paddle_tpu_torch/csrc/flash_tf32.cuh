// K1, K2 and K3 on float32 inputs, on Hopper's tensor cores through
// split TF32 (sm_90a).
//
// Replaces, for fp32 q/k/v, the Pallas kernels of
// paddle_tpu/kernels/primitives/flash.py: K1 `_fwd_kernel` (:78,
// launched by `_pallas_fwd` :221), O and lse of softmax(q·kᵀ·scale +
// bias [+ causal mask])·v with an online softmax; K2 `_bwd_dq_kernel`
// (:130, launched by `_pallas_bwd` :253), dQ = Σ_kv dS·K with
// P = exp(s - lse) and dS = P·(dO·Vᵀ - delta)·scale; K3
// `_bwd_dkv_kernel` (:167, launched at :314), dV = Σ_q Pᵀ·dO,
// dK = Σ_q dSᵀ·Q, dBias[k] = Σ_q dL with dL = P·(dP - delta).  bf16
// inputs take flash_tc.cuh; flash_attention.cu includes this header and
// sends dtype code 0 (float32) of its three entry points here.
//
// What bounds them on this card: at the predictor's shape (BH = 96,
// S = 128, D = 64, fp32, a key bias) K1 reads q, k, v and the bias rows
// and writes O and lse, 12.68 MB, 0.0038 ms at 3.35 TB/s.  Its products
// (S = Q·Kᵀ and P·V, 2·2·BH·S²·D = 0.40 GFLOP) run as three TF32
// tensor-core products each, 1.21 GFLOP, 0.0024 ms at 494.7 TFLOP/s: the
// bound is set by bytes.  At the fp32 train step's [1536, 128, 64] K2
// moves 254 MB (0.0758 ms) for 3 x 9.7 GFLOP (0.0586 ms) and K3 305 MB
// (0.0911 ms) for 3 x 12.9 GFLOP (0.0781 ms): bytes first, operations
// close behind, so the fp32 SIMT pipe (67 TFLOP/s) cannot get near the
// bound and the tensor cores carry every product.  The SIMT kernels
// these replace took 0.032 ms (K1, predictor) and 0.478 / 0.99 ms (K2 /
// K3, train step), slower than SDPA in fp32.
//
// Design (flash_tc.cuh's FlashAttention-2 kernels, for fp32 operands):
// - Split TF32 ("3xTF32"): each fp32 operand x becomes hi = x rounded to
//   TF32 (10 explicit mantissa bits, ties away from zero: cvt.rna's
//   rounding of a finite x, done on the float's bits in two integer
//   operations) and lo = x - hi (exact in fp32) rounded to TF32, so
//   hi + lo holds x to about 2^-22.
//   A product a·b is taken as lo_a·hi_b + hi_a·lo_b + hi_a·hi_b
//   (lo_a·lo_b, about 2^-22 of a·b, is dropped) through
//   mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, with fp32
//   accumulation: about 2^-21 relative a product, inside the fp32 gate of
//   2e-5.  One TF32 product alone (2^-11) would not hold it.
// - Work split: one CTA of 4 warps per (bh, 64 rows), each warp owning
//   16: K1 and K2 own query rows and loop over 64-key tiles (up to the
//   diagonal tile when causal); K3 owns keys and loops over 64-query
//   tiles (from the diagonal tile when causal), so dK, dV and dBias need
//   no atomics.  A thread (lane 4g + t) holds rows g and g + 8: their
//   scores of columns 8n + 2t, + 1 of each 8-column n-block, and their
//   O, dQ, dK or dV of dims 8n + 2t, + 1.
// - Staging: operands stay fp32, untransposed, in rows padded to
//   kD + 4 floats, filled by 16-byte cp.async.cg and zero-filled past S
//   and past D (a zero source size); scalar loads where a base, a
//   (b, h, s) stride or D is not a multiple of 16 bytes.  Two tiles of
//   the streamed operands (K1: K, V; K2: K, V and the bias row; K3: Q,
//   dO and the lse and delta rows), so tile t + 1 lands while t is
//   computed; K2's Q and dO and K3's K and V stay resident.
// - Fragment reads: a lane reads its fp32 operands from shared memory
//   32 bits at a time and splits them there.  With a row stride of
//   kD + 4 floats (4 mod 32 banks) the 32 lanes of every read (rows g,
//   columns t; or rows 2t, 2t + 1, columns g) fall in 32 banks.
//   Splitting a streamed tile once a CTA into hi and lo planes (single
//   buffered, in the same shared memory) read no faster (PERF.md §6).
// - Softmax in registers: K1 takes flash_tc's softmax_step (the scale,
//   the bias, the causal and j >= S masks with -1e30, the online max and
//   sum over the quad of a row; exp as ex2.approx).  K2 and K3 take
//   P = ex2((s·scale + bias - lse)·log2 e), -1e30 past the diagonal and
//   0 past S.  A row whose l is 0 gives O = 0, lse = m + log 1; a row
//   whose keys all carry -1e30 gets uniform weights (O the mean of V)
//   and P = 1 for every key, as in the JAX kernel.
// - P·V, dS·K, Pᵀ·dO and dSᵀ·Q without shared memory: the m16n8k8 C
//   fragment holds columns 2t and 2t + 1 of a lane's rows, the A
//   fragment columns t and t + 4.  So P's (dS's) 8-column block enters
//   the second product with its columns in the order 0, 2, 4, 6, 1, 3,
//   5, 7: A's column t is column 2t and column t + 4 is 2t + 1, the
//   lane's own accumulators, and the B fragment reads the second
//   operand's rows 2t and 2t + 1 to match.  A sum does not depend on
//   its order; no register moves between lanes.
// - Accumulation (K2, K3): the tensor cores add a product's terms to C
//   truncated toward zero at the sum's magnitude.  Where a long sum
//   grows far above its result (dQ, dK of a row whose keys are all
//   masked, P 1 for every key), an ulp lost at each k-step exceeded the
//   2e-5 gate (7.6e-5 at [48, 128, 64]).  So each k-step (S, dP, Sᵀ,
//   dPᵀ) or each chunk's k-steps (dQ, dK, dV) are summed from zero and
//   added to the running sum in fp32, which rounds to nearest.
// - Chunks (K2, K3): a key tile (K2) or query tile (K3) is taken whole
//   at kD 64 and 16 columns at a time at kD 128, and each block of the
//   second product sums its chunk before the add: ptxas then holds K3's
//   dK and dV (64 registers a thread at kD 64, 128 at kD 128) with no
//   spill.  32-column chunks at kD 64 read 5-9% slower (PERF.md §6).
// - Outputs: O = acc / l (K1), dQ (K2), dK and dV (K3) from the
//   accumulators, 8 bytes a lane (rows of 32 bytes a quad: whole
//   sectors); lse (K1) and dBias (K3, summed over the quad) by the
//   quad's first lane.
// - Shared memory (dynamic, set by cudaFuncSetAttribute): K1 kD 64
//   87,552 bytes (2 CTAs an SM), kD 128 169,472 (1 CTA); K2 and K3 six
//   tiles, kD 64 104,960 and 105,472 (2 CTAs), kD 128 203,264 and
//   203,776 (1 CTA); launch bounds to match.  Every instantiation
//   spills 0 bytes (sm_90a; chip_smoke.py phase 2 prints each one's
//   registers and fails on a spill); PERF.md §6 keeps the readings.
// - Times on an H100 against their bounds, the plain versions and
//   SDPA: PERF.md §6 (chip_smoke.py phase 3).  In K1 every warp splits
//   all of K and V, so the conversions run four times a CTA.

#pragma once

#include "flash_tc.cuh"

namespace flash_tf32 {

using flash_tc::cp_async16;
using flash_tc::cp_async_commit;
using flash_tc::cp_async_wait;
using flash_tc::ex2;
using flash_tc::head;
using flash_tc::kLog2e;
using flash_tc::kNegInf;
using flash_tc::kRows;
using flash_tc::kStep;
using flash_tc::kThreadsTc;
using flash_tc::quad_sum;
using flash_tc::softmax_step;
using flash_tc::stage_row;
using flash_tc::Strides;

// The tiles of a head-dim capacity kD (64 or 128 columns) and a CTA's
// shared memory in bytes: Q, two K and two V tiles, two bias rows
template <int kD>
struct Geo {
  static_assert(kD == 64 || kD == 128, "head-dim capacity 64 or 128");
  static constexpr int kLd = kD + 4;  // floats
  static constexpr int kElems = 64 * kLd;
  static constexpr int kSmem = 5 * kElems * 4 + 2 * kStep * 4;
};

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x (10 explicit
// mantissa bits, ties away from zero): half of the 13 dropped bits added
// to the float's bits, then those bits cleared.  Two integer operations;
// cvt.rna compiles to a longer sequence (its NaN and infinity cases),
// and K1 rounds every operand it multiplies.
__device__ __forceinline__ unsigned to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as two TF32 values: hi = x rounded, lo = the rest (exact in fp32)
// rounded
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c (16x8 fp32) += a (16x8 tf32, row) · b (8x8 tf32, col)
__device__ __forceinline__ void mma1688(float (&c)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a·b in split TF32: the two small products, then hi·hi
__device__ __forceinline__ void mma_split(float (&c)[4],
                                          const unsigned (&ah)[4],
                                          const unsigned (&al)[4],
                                          const unsigned (&bh)[2],
                                          const unsigned (&bl)[2]) {
  mma1688(c, al, bh[0], bh[1]);
  mma1688(c, ah, bl[0], bl[1]);
  mma1688(c, ah, bh[0], bh[1]);
}

// Stage rows [row0, row0 + 64) x [0, kD) of a [S, D] fp32 matrix (row
// stride ss) into dst (Geo<kD>::kLd stride).  Rows past S and columns
// past D are zeros.  vec: 16-byte cp.async (asynchronous, completes at a
// later wait); else scalar loads, done when the call returns.
template <int kD>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           long long ss, int row0, int S,
                                           int D, bool vec) {
  constexpr int kLd = Geo<kD>::kLd, kChunks = kD / 4;  // 16 bytes each
  constexpr int kShift = kD == 64 ? 4 : 5;              // log2(kChunks)
  if (vec) {
#pragma unroll
    for (int it = 0; it < 64 * kChunks / kThreadsTc; ++it) {
      const int c = threadIdx.x + it * kThreadsTc;
      const int r = c >> kShift, col = (c & (kChunks - 1)) << 2;
      const int row = row0 + r;
      const bool ok = row < S && col < D;
      cp_async16(dst + r * kLd + col, ok ? src + row * ss + col : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int it = 0; it < 64 * kD / kThreadsTc; ++it) {
      const int e = threadIdx.x + it * kThreadsTc;
      const int r = e >> (kShift + 2), col = e & (kD - 1), row = row0 + r;
      dst[r * kLd + col] = (row < S && col < D) ? src[row * ss + col] : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// K1.  grid (query tiles of 64 rows, B*H), 128 threads; vec: bit 0 q,
// 1 k, 2 v, 3 o allow 16-byte rows.
// ---------------------------------------------------------------------------
template <bool kCausal, int kD>
__global__ void __launch_bounds__(kThreadsTc, kD == 64 ? 2 : 1)
    flash_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ bias, float* __restrict__ o,
                   float* __restrict__ lse, int H, int S, int D, Strides sq,
                   Strides sk, Strides sv, Strides so, float scale,
                   int vec) {
  using G = Geo<kD>;
  count_launch(0);
  extern __shared__ __align__(16) float flash_tf32_smem[];
  float* Qs = flash_tf32_smem;     // the query tile
  float* Ks = Qs + G::kElems;      // two key tiles
  float* Vs = Ks + 2 * G::kElems;  // two value tiles
  float* Bs = Vs + 2 * G::kElems;  // two bias rows
  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const float* kh = head(k, sk, bh, H);
  const float* vh = head(v, sv, bh, H);
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
  // this lane's A reads of Q: row g, column t (+ 8 rows, + 4 columns)
  const float* Qw = Qs + (warp * 16 + g) * G::kLd + tig;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kStep;
    cp_async_wait<3>();  // K(t) and its bias are in
    __syncthreads();
    const float* Kt = Ks + (t & 1) * G::kElems;
    const float* Vt = Vs + (t & 1) * G::kElems;
    const float* bt = Bs + (t & 1) * kStep;

    // S = Q·Kᵀ: 16 rows x 64 keys a warp, 8 dims a k-step; Q's fragments
    // are read and split again each tile
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kD / 8; ++kc) {
      unsigned qh[4], ql[4];
      split(Qw[kc * 8], qh[0], ql[0]);
      split(Qw[8 * G::kLd + kc * 8], qh[1], ql[1]);
      split(Qw[kc * 8 + 4], qh[2], ql[2]);
      split(Qw[8 * G::kLd + kc * 8 + 4], qh[3], ql[3]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        // B = Kᵀ: key n·8 + g, dims kc·8 + t and + 4
        const float* kr = Kt + (n * 8 + g) * G::kLd + kc * 8 + tig;
        unsigned bh2[2], bl2[2];
        split(kr[0], bh2[0], bl2[0]);
        split(kr[4], bh2[1], bl2[1]);
        mma_split(s[n], qh, ql, bh2, bl2);
      }
    }
    if (k0 + kStep > S || (kCausal && k0 + kStep - 1 > q0))
      softmax_step<kCausal, true>(s, acc, m, l, bt, k0, S, row0, tig, scale);
    else
      softmax_step<kCausal, false>(s, acc, m, l, bt, k0, S, row0, tig,
                                   scale);

    cp_async_wait<2>();  // V(t) is in
    __syncthreads();
    // O += P·V, 8 keys a k-step: A column t is key 2t and column t + 4
    // key 2t + 1 of the block (the lane's own P), so B reads V's rows
    // kc·8 + 2t and + 1, columns n·8 + g
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) {
      unsigned ph[4], pl[4];
      split(s[kc][0], ph[0], pl[0]);
      split(s[kc][2], ph[1], pl[1]);
      split(s[kc][1], ph[2], pl[2]);
      split(s[kc][3], ph[3], pl[3]);
      const float* vr = Vt + (kc * 8 + 2 * tig) * G::kLd + g;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        unsigned bh2[2], bl2[2];
        split(vr[n * 8], bh2[0], bl2[0]);
        split(vr[G::kLd + n * 8], bh2[1], bl2[1]);
        mma_split(acc[n], ph, pl, bh2, bl2);
      }
    }
    if (t + 2 < n_tiles) __syncthreads();  // every warp is done with t
    prefetch(t + 2);
  }

  float* oh = head(o, so, bh, H);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_row = quad_sum(l[r]);
    const float l_safe = l_row == 0.f ? 1.f : l_row;
    const float inv = 1.f / l_safe;
    const int i = row0 + r * 8;
    if (i >= S) continue;
    float* orow = oh + i * so.s;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int col = n * 8 + 2 * tig;
      const float x0 = acc[n][2 * r] * inv, x1 = acc[n][2 * r + 1] * inv;
      if (vec & 8) {  // D % 4 == 0: both columns in or both out
        if (col < D)
          *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
      } else {
        if (col < D) orow[col] = x0;
        if (col + 1 < D) orow[col + 1] = x1;
      }
    }
    if (tig == 0) lse[(long long)bh * S + i] = m[r] + logf(l_safe);
  }
}

// 1 when an operand's base and (b, h, s) element strides, and D, allow
// 16-byte copies of its fp32 rows
inline int vec16(const void* p, const long long* st, int D) {
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && D % 4 == 0 &&
         st[0] % 4 == 0 && st[1] % 4 == 0 && st[2] % 4 == 0;
}

template <bool kCausal, int kD>
cudaError_t fwd_d(const void* q, const void* k, const void* v,
                  const float* bias, void* o, float* lse, int B, int H,
                  int S, int D, const long long* st, float scale,
                  cudaStream_t s) {
  const int vec = vec16(q, st, D) | vec16(k, st + 3, D) << 1 |
                  vec16(v, st + 6, D) << 2 | vec16(o, st + 9, D) << 3;
  auto kernel = flash_fwd_tf32<kCausal, kD>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<kD>::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kRows - 1) / kRows, B * H);
  kernel<<<grid, kThreadsTc, Geo<kD>::kSmem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<float*>(o), lse, H, S,
      D, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, scale,
      vec);
  return cudaGetLastError();
}

template <bool kCausal>
cudaError_t fwd(const void* q, const void* k, const void* v,
                const float* bias, void* o, float* lse, int B, int H, int S,
                int D, const long long* st, float scale, cudaStream_t s) {
  return flash_tc::with_capacity(D, [&](auto kD) {
    return fwd_d<kCausal, decltype(kD)::value>(q, k, v, bias, o, lse, B, H,
                                               S, D, st, scale, s);
  });
}

// ---------------------------------------------------------------------------
// K2 and K3.  Each product runs over a warp's 16 rows in one of two
// forms; every operand is split into its TF32 parts as it is read.
// ---------------------------------------------------------------------------

// c += a·b in split TF32, the three products of one k-step summed from
// zero and then added to c in fp32, rounded to nearest (Accumulation,
// in the note above)
__device__ __forceinline__ void mma_split_add(float (&c)[4],
                                              const unsigned (&ah)[4],
                                              const unsigned (&al)[4],
                                              const unsigned (&bh)[2],
                                              const unsigned (&bl)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_split(t, ah, al, bh, bl);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

// c[n] (16 x 8 block n of a 16 x 8kN tile) += A·Bᵀ summed over kD
// columns: A's 16 rows at a and B's 8kN rows at b, both row-major at
// the Geo<kD>::kLd stride.  A lane reads A's rows g, g + 8 and B's rows
// 8n + g, at columns 8kc + t and + 4 (S = Q·Kᵀ and dP = dO·Vᵀ in K2,
// Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ in K3).
template <int kD, int kN>
__device__ __forceinline__ void mma_rows_rows(float (&c)[kN][4],
                                              const float* a,
                                              const float* b, int g,
                                              int tig) {
  constexpr int kLd = Geo<kD>::kLd;
  const float* aw = a + g * kLd + tig;
  const float* bw = b + g * kLd + tig;
#pragma unroll 2
  for (int kc = 0; kc < kD / 8; ++kc) {
    unsigned ah[4], al[4];
    split(aw[kc * 8], ah[0], al[0]);
    split(aw[8 * kLd + kc * 8], ah[1], al[1]);
    split(aw[kc * 8 + 4], ah[2], al[2]);
    split(aw[8 * kLd + kc * 8 + 4], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const float* br = bw + n * 8 * kLd + kc * 8;
      unsigned bh2[2], bl2[2];
      split(br[0], bh2[0], bl2[0]);
      split(br[4], bh2[1], bl2[1]);
      mma_split_add(c[n], ah, al, bh2, bl2);
    }
  }
}

// acc[n] (16 x kD, 8-column block n) += X·T: X the lane's accumulator
// tile x (16 rows x 8kX columns: rows g, g + 8 at columns 8kc + 2t,
// + 1), T 8kX rows x kD columns, row-major at t (Geo<kD>::kLd stride).
// X's block kc enters with its columns in the order 0, 2, 4, 6, 1, 3,
// 5, 7 (A column t is column 2t, column t + 4 is 2t + 1: the lane's own
// accumulators), and T's rows 8kc + 2t and + 1 are read to match (dQ +=
// dS·K in K2, dV += Pᵀ·dO and dK += dSᵀ·Q in K3).  X is split once;
// each block n sums its kX k-steps from zero and adds them to acc[n]
// (as mma_split_add does a k-step).
template <int kD, int kX>
__device__ __forceinline__ void mma_acc_rows(float (&acc)[kD / 8][4],
                                             const float (&x)[kX][4],
                                             const float* t, int g,
                                             int tig) {
  constexpr int kLd = Geo<kD>::kLd;
  unsigned xh[kX][4], xl[kX][4];
#pragma unroll
  for (int kc = 0; kc < kX; ++kc) {
    split(x[kc][0], xh[kc][0], xl[kc][0]);
    split(x[kc][2], xh[kc][1], xl[kc][1]);
    split(x[kc][1], xh[kc][2], xl[kc][2]);
    split(x[kc][3], xh[kc][3], xl[kc][3]);
  }
  const float* tr = t + 2 * tig * kLd + g;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kc = 0; kc < kX; ++kc) {
      unsigned bh2[2], bl2[2];
      split(tr[kc * 8 * kLd + n * 8], bh2[0], bl2[0]);
      split(tr[(kc * 8 + 1) * kLd + n * 8], bh2[1], bl2[1]);
      mma_split(sum, xh[kc], xl[kc], bh2, bl2);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += sum[e];
  }
}

// Rows r0 + g and r0 + g + 8 of a [S, D] fp32 output (row stride ss)
// from a lane's accumulators (dims 8n + 2t, + 1): 8 bytes a lane where
// D % 4 == 0 and the rows are 16-byte aligned (vec), else element by
// element.  Rows past S and columns past D are not written.
template <int kD>
__device__ __forceinline__ void store_acc(float* dst, long long ss,
                                          const float (&acc)[kD / 8][4],
                                          int r0, int S, int D, int tig,
                                          bool vec) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + r * 8;
    if (i >= S) continue;
    float* row = dst + i * ss;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int col = n * 8 + 2 * tig;
      const float x0 = acc[n][2 * r], x1 = acc[n][2 * r + 1];
      if (vec) {  // D % 4 == 0: both columns in or both out
        if (col < D)
          *reinterpret_cast<float2*>(row + col) = make_float2(x0, x1);
      } else {
        if (col < D) row[col] = x0;
        if (col + 1 < D) row[col + 1] = x1;
      }
    }
  }
}

// K2's and K3's shared memory in bytes: six tiles (K2: Q, dO, two K and
// two V tiles; K3: K, V, two Q and two dO tiles) and two bias rows (K2)
// or two lse and two delta rows (K3)
template <int kD>
struct BwdGeo {
  static constexpr int kDqSmem = 6 * Geo<kD>::kElems * 4 + 2 * kStep * 4;
  static constexpr int kDkvSmem = 6 * Geo<kD>::kElems * 4 + 4 * kStep * 4;
  // the keys (K2) or queries (K3) of a tile taken at a time: the whole
  // tile at kD 64; 16 at kD 128, where dQ holds 64 registers a thread and
  // dK and dV 128
  static constexpr int kChunk = kD == 64 ? kStep : 16;
};

// ---------------------------------------------------------------------------
// K2.  grid (query tiles of 64 rows, B*H), 128 threads.  Warp w owns
// rows 16w..16w + 15 of the tile; thread (lane 4g + t) holds rows g and
// g + 8: their S, dP and dS of keys 8n + 2t, + 1 of each 8-key n-block
// of a chunk of the key tile, and their dQ of dims 8n + 2t, + 1.  vec: bit 0 q, 1 k,
// 2 v, 3 dO, 4 dQ allow 16-byte rows.
// ---------------------------------------------------------------------------
template <bool kCausal, int kD>
__global__ void __launch_bounds__(kThreadsTc, kD == 64 ? 2 : 1)
    flash_bwd_dq_tf32(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ bias,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dq, int H, int S, int D,
                      Strides sq, Strides sk, Strides sv, Strides sdo,
                      Strides sdq, float scale, int vec) {
  using G = Geo<kD>;
  constexpr int kChunk = BwdGeo<kD>::kChunk, kN = kChunk / 8;
  count_launch(1);
  extern __shared__ __align__(16) float flash_tf32_smem[];
  float* Qs = flash_tf32_smem;     // this CTA's query rows
  float* dOs = Qs + G::kElems;     // and their dO
  float* Ks = dOs + G::kElems;     // two key tiles
  float* Vs = Ks + 2 * G::kElems;  // two value tiles
  float* Bs = Vs + 2 * G::kElems;  // two bias rows
  const int bh = blockIdx.y, q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const float* kh = head(k, sk, bh, H);
  const float* vh = head(v, sv, bh, H);
  const float* brow = bias + (long long)bh * S;
  const bool vk = vec & 2, vv = vec & 4;

  const int kv_end = kCausal ? min(S, q0 + kRows) : S;
  const int n_tiles = (kv_end + kStep - 1) / kStep;
  // one copy group a key tile (K, V and the bias row); two in flight
  // from the start (the first with Q and dO), each later one started
  // into the buffers the tile two back has freed.  A group may be
  // empty: the count stays fixed.
  auto prefetch = [&](int t) {
    const int buf = t & 1;
    if (t < n_tiles) {
      stage_tile<kD>(Ks + buf * G::kElems, kh, sk.s, t * kStep, S, D, vk);
      stage_tile<kD>(Vs + buf * G::kElems, vh, sv.s, t * kStep, S, D, vv);
      stage_row(Bs + buf * kStep, brow, t * kStep, S);
    }
    cp_async_commit();
  };
  stage_tile<kD>(Qs, head(q, sq, bh, H), sq.s, q0, S, D, vec & 1);
  stage_tile<kD>(dOs, head(dout, sdo, bh, H), sdo.s, q0, S, D, vec & 8);
  prefetch(0);
  prefetch(1);

  const int row0 = q0 + warp * 16 + g;  // and row0 + 8
  float lse_r[2], delta_r[2];           // read once
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + r * 8;
    lse_r[r] = i < S ? lse[(long long)bh * S + i] : 0.f;
    delta_r[r] = i < S ? delta[(long long)bh * S + i] : 0.f;
  }
  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float* Qw = Qs + warp * 16 * G::kLd;
  const float* dOw = dOs + warp * 16 * G::kLd;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kStep;
    cp_async_wait<1>();  // tile t (and Q, dO) are in
    __syncthreads();
    const float* Kt = Ks + (t & 1) * G::kElems;
    const float* Vt = Vs + (t & 1) * G::kElems;
    const float* bt = Bs + (t & 1) * kStep;

    // the tile holds keys past S or crosses the diagonal
    const bool edge = k0 + kStep > S || (kCausal && k0 + kStep - 1 > q0);
#pragma unroll 1
    for (int j0 = 0; j0 < kStep; j0 += kChunk) {
      const float* Kc = Kt + j0 * G::kLd;
      // S = Q·Kᵀ and dP = dO·Vᵀ: 16 rows x kChunk keys a warp
      float s[kN][4], dp[kN][4];
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      mma_rows_rows<kD, kN>(s, Qw, Kc, g, tig);
      mma_rows_rows<kD, kN>(dp, dOw, Vt + j0 * G::kLd, g, tig);
      // P = exp(S·scale + bias_j - lse_i) (-1e30 past the diagonal, 0
      // past S), dS = P∘(dP - delta_i)·scale
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jl = j0 + n * 8 + 2 * tig + (e & 1), j = k0 + jl;
          const int r = e >> 1;
          float x = fmaf(s[n][e], scale, bt[jl]);
          if (kCausal && edge && j > row0 + r * 8) x = kNegInf;
          float p = ex2((x - lse_r[r]) * kLog2e);
          if (edge && j >= S) p = 0.f;
          s[n][e] = p * (dp[n][e] - delta_r[r]) * scale;
        }
      // dQ += dS·K
      mma_acc_rows<kD, kN>(acc, s, Kc, g, tig);
    }
    if (t + 2 < n_tiles) __syncthreads();  // every warp is done with t
    prefetch(t + 2);
  }
  store_acc<kD>(head(dq, sdq, bh, H), sdq.s, acc, row0, S, D, tig,
                vec & 16);
}

// ---------------------------------------------------------------------------
// K3.  grid (key tiles of 64 keys, B*H), 128 threads.  Warp w owns keys
// 16w..16w + 15 of the tile; thread (lane 4g + t) holds keys g and
// g + 8: their Sᵀ, dPᵀ, Pᵀ and dSᵀ of queries 8n + 2t, + 1 of each
// 8-query n-block of a query chunk, their dK and dV of dims 8n + 2t,
// + 1, and their dBias.  vec: bit 0 q, 1 k, 2 v, 3 dO, 4 dK, 5 dV allow
// 16-byte rows.
// ---------------------------------------------------------------------------
template <bool kCausal, int kD>
__global__ void __launch_bounds__(kThreadsTc, kD == 64 ? 2 : 1)
    flash_bwd_dkv_tf32(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ bias,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv,
                       float* __restrict__ dbias, int H, int S, int D,
                       Strides sq, Strides sk, Strides sv, Strides sdo,
                       Strides sdk, Strides sdv, float scale, int vec) {
  using G = Geo<kD>;
  constexpr int kChunk = BwdGeo<kD>::kChunk, kN = kChunk / 8;
  count_launch(2);
  extern __shared__ __align__(16) float flash_tf32_smem[];
  float* Ks = flash_tf32_smem;      // this CTA's keys
  float* Vs = Ks + G::kElems;       // and their values
  float* Qs = Vs + G::kElems;       // two query tiles
  float* dOs = Qs + 2 * G::kElems;  // two dO tiles
  float* Ls = dOs + 2 * G::kElems;  // two lse rows
  float* Dl = Ls + 2 * kStep;       // two delta rows
  const int bh = blockIdx.y, k0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const float* qh = head(q, sq, bh, H);
  const float* doh = head(dout, sdo, bh, H);
  const float* lrow = lse + (long long)bh * S;
  const float* drow = delta + (long long)bh * S;
  const bool vq = vec & 1, vdo = vec & 8;

  const int q_begin = kCausal ? k0 : 0;
  const int n_tiles = (S - q_begin + kStep - 1) / kStep;
  // one copy group a query tile (Q, dO, the lse and delta rows), as K2
  auto prefetch = [&](int t) {
    const int buf = t & 1, i0 = q_begin + t * kStep;
    if (t < n_tiles) {
      stage_tile<kD>(Qs + buf * G::kElems, qh, sq.s, i0, S, D, vq);
      stage_tile<kD>(dOs + buf * G::kElems, doh, sdo.s, i0, S, D, vdo);
      stage_row(Ls + buf * kStep, lrow, i0, S);
      stage_row(Dl + buf * kStep, drow, i0, S);
    }
    cp_async_commit();
  };
  stage_tile<kD>(Ks, head(k, sk, bh, H), sk.s, k0, S, D, vec & 2);
  stage_tile<kD>(Vs, head(v, sv, bh, H), sv.s, k0, S, D, vec & 4);
  prefetch(0);
  prefetch(1);

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
  const float* Kw = Ks + warp * 16 * G::kLd;
  const float* Vw = Vs + warp * 16 * G::kLd;

  for (int t = 0; t < n_tiles; ++t) {
    const int qt0 = q_begin + t * kStep;
    cp_async_wait<1>();  // tile t (and K, V) are in
    __syncthreads();
    const float* Qt = Qs + (t & 1) * G::kElems;
    const float* dOt = dOs + (t & 1) * G::kElems;
    const float* lt = Ls + (t & 1) * kStep;
    const float* dt = Dl + (t & 1) * kStep;
    // the tile holds queries or keys past S, or crosses the diagonal
    const bool edge = qt0 + kStep > S || k0 + kRows > S ||
                      (kCausal && qt0 < k0 + kRows - 1);

#pragma unroll 1
    for (int c0 = 0; c0 < kStep; c0 += kChunk) {
      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: 16 keys x kChunk queries a warp
      float st[kN][4], dpt[kN][4];
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
      mma_rows_rows<kD, kN>(st, Kw, Qt + c0 * G::kLd, g, tig);
      mma_rows_rows<kD, kN>(dpt, Vw, dOt + c0 * G::kLd, g, tig);
      // Pᵀ = exp(Sᵀ·scale + bias_j - lse_i), dLᵀ = Pᵀ∘(dPᵀ - delta_i),
      // dSᵀ = dLᵀ·scale, dBias_j += Σ_i dL
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = c0 + n * 8 + 2 * tig + (e & 1), i = qt0 + il;
          const int r = e >> 1, j = key_j[r];
          float x = fmaf(st[n][e], scale, bj[r]);
          if (kCausal && edge && j > i) x = kNegInf;
          float p = ex2((x - lt[il]) * kLog2e);
          if (edge && (i >= S || j >= S)) p = 0.f;
          const float dl = p * (dpt[n][e] - dt[il]);
          db[r] += dl;
          st[n][e] = p;
          dpt[n][e] = dl * scale;
        }
      // dV += Pᵀ·dO and dK += dSᵀ·Q
      mma_acc_rows<kD, kN>(dv_acc, st, dOt + c0 * G::kLd, g, tig);
      mma_acc_rows<kD, kN>(dk_acc, dpt, Qt + c0 * G::kLd, g, tig);
    }
    if (t + 2 < n_tiles) __syncthreads();  // every warp is done with t
    prefetch(t + 2);
  }

  const int j0 = k0 + warp * 16 + g;
  store_acc<kD>(head(dk, sdk, bh, H), sdk.s, dk_acc, j0, S, D, tig,
                vec & 16);
  store_acc<kD>(head(dv, sdv, bh, H), sdv.s, dv_acc, j0, S, D, tig,
                vec & 32);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float dbj = quad_sum(db[r]);
    if (tig == 0 && key_j[r] < S) dbias[(long long)bh * S + key_j[r]] = dbj;
  }
}

template <bool kCausal, int kD>
cudaError_t bwd_dq_d(const void* q, const void* k, const void* v,
                     const float* bias, const void* dout, const float* lse,
                     const float* delta, void* dq, int B, int H, int S, int D,
                     const long long* st, float scale, cudaStream_t s) {
  const int vec = vec16(q, st, D) | vec16(k, st + 3, D) << 1 |
                  vec16(v, st + 6, D) << 2 | vec16(dout, st + 9, D) << 3 |
                  vec16(dq, st + 12, D) << 4;
  auto kernel = flash_bwd_dq_tf32<kCausal, kD>;
  constexpr int kSmem = BwdGeo<kD>::kDqSmem;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kRows - 1) / kRows, B * H);
  kernel<<<grid, kThreadsTc, kSmem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<const float*>(dout),
      lse, delta, static_cast<float*>(dq), H, S, D,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      Strides{st[12], st[13], st[14]}, scale, vec);
  return cudaGetLastError();
}

template <bool kCausal>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const float* bias, const void* dout, const float* lse,
                   const float* delta, void* dq, int B, int H, int S, int D,
                   const long long* st, float scale, cudaStream_t s) {
  return flash_tc::with_capacity(D, [&](auto kD) {
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
  auto kernel = flash_bwd_dkv_tf32<kCausal, kD>;
  constexpr int kSmem = BwdGeo<kD>::kDkvSmem;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kRows - 1) / kRows, B * H);
  kernel<<<grid, kThreadsTc, kSmem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<const float*>(dout),
      lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), dbias, H,
      S, D, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
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
  return flash_tc::with_capacity(D, [&](auto kD) {
    return bwd_dkv_d<kCausal, decltype(kD)::value>(
        q, k, v, bias, dout, lse, delta, dk, dv, dbias, B, H, S, D, st,
        scale, s);
  });
}

}  // namespace flash_tf32
