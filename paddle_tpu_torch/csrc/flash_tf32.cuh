// K1 on float32 inputs, on Hopper's tensor cores through split TF32
// (sm_90a).
//
// Replaces, for fp32 q/k/v, the Pallas kernel `_fwd_kernel` of
// paddle_tpu/kernels/primitives/flash.py (:78, launched by `_pallas_fwd`
// :221): O and lse of softmax(q·kᵀ·scale + bias [+ causal mask])·v with
// an online softmax.  bf16 inputs take flash_tc.cuh; fp32 K2 and K3 stay
// the SIMT kernels of flash_attention.cu, which includes this header and
// sends dtype code 0 (float32) of pt_flash_fwd here.
//
// What bounds it on this card: at the predictor's shape (BH = 96,
// S = 128, D = 64, fp32, a key bias) K1 reads q, k, v and the bias rows
// and writes O and lse, 12.68 MB, 0.0038 ms at 3.35 TB/s.  Its products
// (S = Q·Kᵀ and P·V, 2·2·BH·S²·D = 0.40 GFLOP) run as three TF32
// tensor-core products each, 1.21 GFLOP, 0.0024 ms at 494.7 TFLOP/s: the
// bound is set by bytes.  The SIMT kernel this replaces ran the products
// on the fp32 pipe (67 TFLOP/s, 0.0060 ms) from tiles staged by scalar,
// bank-conflicting transposed stores with no copy in flight, and took
// 0.032 ms, slower than SDPA in fp32 (0.029).
//
// Design (flash_tc.cuh's K1, for fp32 operands):
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
// - Work split: one CTA of 4 warps per (bh, 64 query rows), each warp
//   owning 16 rows; loops over 64-key tiles (up to the diagonal tile when
//   causal).  A thread (lane 4g + t) holds rows g and g + 8: their scores
//   of keys 8n + 2t, + 1 of each 8-key n-block, and their O of dims
//   8n + 2t, + 1.
// - Staging: q, k and v stay fp32, untransposed, in rows padded to
//   kD + 4 floats, filled by 16-byte cp.async.cg and zero-filled past S
//   and past D (a zero source size); scalar loads where a base, a
//   (b, h, s) stride or D is not a multiple of 16 bytes.  Two key and two
//   value tiles: the copies of Q with K(0), V(0), K(1) and V(1) are in
//   flight from the start, V(t) lands while S(t) is computed, and tile
//   t + 2 loads into the buffers tile t frees.
// - Fragment reads: a lane reads its fp32 operands from shared memory
//   32 bits at a time.  With a row stride of kD + 4 floats (4 mod 32
//   banks) the 32 lanes of every read (rows g, columns t; or V's key rows
//   2t, 2t + 1, columns g) fall in 32 different banks.
// - Softmax in registers: flash_tc's softmax_step (the scale, the bias,
//   the causal and j >= S masks with -1e30, the online max and sum over
//   the quad of a row; exp as ex2.approx).  A row whose l is 0 gives
//   O = 0, lse = m + log 1; a row whose keys all carry -1e30 gets uniform
//   weights (O the mean of V), as in the JAX kernel.
// - P·V without shared memory: the m16n8k8 C fragment holds columns 2t
//   and 2t + 1 of a lane's rows, the A fragment columns t and t + 4.  So
//   P's key block kc enters P·V with its keys in the order
//   0, 2, 4, 6, 1, 3, 5, 7: A's column t is key 2t and column t + 4 is key
//   2t + 1, which are the lane's own accumulators, and the B fragment
//   reads V's rows kc·8 + 2t and kc·8 + 2t + 1 to match.  A sum over keys
//   does not depend on their order; no register moves between lanes.
// - Outputs: O = acc / l from the accumulators, 8 bytes a lane (rows of
//   32 bytes a quad: whole sectors); lse by the quad's first lane.
// - Shared memory (dynamic, set by cudaFuncSetAttribute): kD 64 87,552
//   bytes (2 CTAs an SM), kD 128 169,472 (1 CTA); launch bounds to match.
//   ptxas (sm_90a, chip_smoke.py phase 2): kD 64 147 registers (causal
//   162), kD 128 185-186, 0 bytes spilled; 384 and 768 HMMA.
// - On an H100 80GB HBM3 at 700 W (chip_smoke.py phase 3): 0.0185 ms at
//   the predictor's shape, 20% of the byte bound, against SDPA in fp32
//   0.0294 and the SIMT form's 0.032.  The three TF32 products a product take about a
//   third of it (tools/torch_flash_ab.py: one product reads 0.0126
//   ms); every warp splits all of K and V, so the conversions run four
//   times a CTA.

#pragma once

#include "flash_tc.cuh"

namespace flash_tf32 {

using flash_tc::cp_async16;
using flash_tc::cp_async_commit;
using flash_tc::cp_async_wait;
using flash_tc::head;
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

}  // namespace flash_tf32
