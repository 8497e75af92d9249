// K1-K3: flash attention forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of paddle_tpu/kernels/primitives/flash.py:
//   K1 `_fwd_kernel` (:78, launched by `_pallas_fwd` :221): O and lse of
//      softmax(q·kᵀ·scale + bias [+ causal mask])·v, online softmax;
//   K2 `_bwd_dq_kernel` (:130, `_pallas_bwd` :253):
//      P = exp(s - lse); dS = P·(dO·Vᵀ - delta)·scale; dQ = Σ_kv dS·K;
//   K3 `_bwd_dkv_kernel` (:167, launched at :314):
//      dV = Σ_q Pᵀ·dO; dK = Σ_q dSᵀ·Q; dBias[k] = Σ_q dL, where
//      dL = P·(dP - delta) is the unscaled logit grad.
// q, k, v, dO and the outputs O, dQ, dK, dV are [B, H, S, D] views with
// any (b, h, s) strides and a contiguous D, in float32 or bfloat16 (one
// dtype per call): the kernels read the op's transpose2 views of
// [B, S, H, D] activations in place, so the wrapper makes no copy.
// bias [B*H, S], lse, delta [B*H, S] and dBias are contiguous float32.
// Scores, softmax and every accumulator are fp32; masked logits are
// -1e30 (the JAX constant); a row whose l is 0 gives O = 0 and
// lse = m + log(1).
//
// Three designs.  K1-K3 on bfloat16, the training path's dtype, run on
// the tensor cores: flash_tc.cuh, whose note gives their bound and
// design (K2 since it was taken off the SIMT units: 0.495 ms at the
// train step's [1536, 128, 64], 12.9x its byte bound and 2.5x SDPA's
// whole backward, on the card).  K1 on float32, the Fluid default dtype
// (the predictor path and every program without the bf16 policy), runs
// on the tensor cores through split TF32: flash_tf32.cuh (its SIMT form,
// the first design, was slower than SDPA in fp32).  float32 K2 and K3
// are the SIMT design below: the parity checks hold them to 2e-5.
//
// What bounds the SIMT design: at the training shape (S = 128, D = 64)
// K2 does some 77 flops a byte, below the bf16 tensor cores' ridge
// point (~295), so the least time is set by bytes; on the fp32 SIMT
// units (67 TFLOP/s, not the 989 of bf16 tensor cores) it is bound by
// those and by shared-memory bandwidth instead.
//
// SIMT design: one block of 256 threads per (bh, 64-row tile): K2 per
// query tile looping over key tiles, K3 per key tile looping over query
// tiles, so dK, dV and dBias need no atomics.  Tiles are staged in
// shared memory as fp32 64 x 64 halves of the head dim, transposed where
// a product reads them along D (row stride 68 floats keeps float4 reads
// aligned and spreads banks); a transposed operand's halves are stacked,
// so a product over D runs over 64 or 128 staged rows.  A thread owns a
// 4x4 piece of each 64x64 tile: the scores, and a 4x4 piece of dQ, dK
// and dV in each half of D.  A ragged last tile is masked in the kernel
// (rows or keys past S load as zeros and get P = 0), so S needs no
// padding; D is zero-padded to its capacity kD (64 or 128).  At kD 128
// K2 keeps both halves of dQ (a 4x8 piece a thread, 191,488 bytes of
// shared memory); K3 cannot stage both halves of its row-major Q and dO
// beside the transposed tiles (241 KB, over the 227 KB a block may
// have), so it takes dK and dV one half at a time, computing P and dS
// again for the second half (209,408 bytes).  Launch bounds follow the
// CTAs an SM the shared memory allows (K2 two at kD 64, else one), so
// ptxas may use up to 255 registers where one CTA fits.

#include <cuda_runtime.h>

#include "flash_tc.cuh"
#include "flash_tf32.cuh"

namespace {

using flash_tc::head;
using flash_tc::kNegInf;
using flash_tc::Strides;

constexpr int kTile = 64;     // rows of a query tile and of a key tile
constexpr int kHalf = 64;     // head-dim columns of a staged tile
constexpr int kLd = 68;       // padded row stride of a staged tile (floats)
constexpr int kThreads = 256; // 16 x 16 threads, a 4x4 piece each
constexpr int kTileFloats = kTile * kLd;

// Stage rows [row0, row0 + 64) x [col0, col0 + 64) of a [S, D] matrix
// (row stride ss): row-major dst[r * kLd + d], or transposed
// dst[d * kLd + r].  Rows past S and columns past D are zeros.
template <bool kTrans>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long ss, int row0, int S, int D,
                                      int col0) {
  for (int idx = threadIdx.x; idx < kTile * kHalf; idx += kThreads) {
    const int r = idx / kHalf, d = idx % kHalf;
    const int row = row0 + r, col = col0 + d;
    const float v = (row < S && col < D) ? src[row * ss + col] : 0.f;
    if (kTrans)
      dst[d * kLd + r] = v;
    else
      dst[r * kLd + d] = v;
  }
}

// Stage every half of the head dim: kD / 64 tiles from dst on
template <bool kTrans, int kD>
__device__ __forceinline__ void stage_all(float* dst, const float* src,
                                          long long ss, int row0, int S,
                                          int D) {
#pragma unroll
  for (int h = 0; h < kD / kHalf; ++h)
    stage<kTrans>(dst + h * kTileFloats, src, ss, row0, S, D, h * kHalf);
}

// acc[r][c] += Σ_k a[k][ra + r] · b[k][cb + c] over k < n, where a and b
// are staged tiles (kLd row stride) read four at a time.
__device__ __forceinline__ void mma_4x4(float (&acc)[4][4], const float* a,
                                        int ra, const float* b, int cb,
                                        int n) {
#pragma unroll 8
  for (int k = 0; k < n; ++k) {
    const float4 x = *reinterpret_cast<const float4*>(a + k * kLd + ra);
    const float4 y = *reinterpret_cast<const float4*>(b + k * kLd + cb);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] += xs[r] * ys[c];
  }
}

// reductions across the 16 threads (tx = 0..15) that share a tile row
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// K2: grid (query tiles, B*H).  Thread (ty, tx) holds scores of queries
// q0 + 4ty.. x keys k0 + 4tx.., and dQ of queries q0 + 4ty.. x dims
// h·64 + 4tx.. of each half h of the head dim.
// ---------------------------------------------------------------------------
template <bool kCausal, int kD>
__global__ void __launch_bounds__(kThreads, kD == 64 ? 2 : 1)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ bias,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int H, int S, int D,
                        Strides sq, Strides sk, Strides sv, Strides sdo,
                        Strides sdq, float scale) {
  constexpr int kH = kD / kHalf;  // halves of the head dim
  count_launch(1);
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                  // Qt[d][i], kH halves stacked
  float* dOt = Qt + kH * kTileFloats;   // dOt[d][i]
  float* Kt = dOt + kH * kTileFloats;   // Kt[d][j]
  float* Vt = Kt + kH * kTileFloats;    // Vt[d][j]
  float* Ks = Vt + kH * kTileFloats;    // Ks[j][d] of each half
  float* dSt = Ks + kH * kTileFloats;   // dSt[j][i] = dS[i][j]
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* kh = head(k, sk, bh, H);
  const float* vh = head(v, sv, bh, H);
  const float* brow = bias + (long long)bh * S;

  stage_all<true, kD>(Qt, head(q, sq, bh, H), sq.s, q0, S, D);
  stage_all<true, kD>(dOt, head(dout, sdo, bh, H), sdo.s, q0, S, D);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + 4 * ty + r;
    lse_r[r] = i < S ? lse[(long long)bh * S + i] : 0.f;
    delta_r[r] = i < S ? delta[(long long)bh * S + i] : 0.f;
  }
  float acc[kH][4][4] = {};

  const int kv_end = kCausal ? min(S, q0 + kTile) : S;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();
    stage_all<true, kD>(Kt, kh, sk.s, k0, S, D);
    stage_all<true, kD>(Vt, vh, sv.s, k0, S, D);
    stage_all<false, kD>(Ks, kh, sk.s, k0, S, D);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    mma_4x4(s, Qt, 4 * ty, Kt, 4 * tx, kD);
    mma_4x4(dp, dOt, 4 * ty, Vt, 4 * tx, kD);
    float ds[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = k0 + 4 * tx + c;
      const float bj = j < S ? brow[j] : 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = q0 + 4 * ty + r;
        const bool live = i < S && j < S && (!kCausal || j <= i);
        const float p = live ? expf(s[r][c] * scale + bj - lse_r[r]) : 0.f;
        ds[r][c] = p * (dp[r][c] - delta_r[r]) * scale;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(dSt + (4 * tx + c) * kLd + 4 * ty) =
          make_float4(ds[0][c], ds[1][c], ds[2][c], ds[3][c]);
    __syncthreads();
#pragma unroll
    for (int h = 0; h < kH; ++h)
      mma_4x4(acc[h], dSt, 4 * ty, Ks + h * kTileFloats, 4 * tx, kTile);
  }

  float* dqh = head(dq, sdq, bh, H);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + 4 * ty + r;
    if (i >= S) continue;
#pragma unroll
    for (int h = 0; h < kH; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = h * kHalf + 4 * tx + c;
        if (d < D) dqh[i * sdq.s + d] = acc[h][r][c];
      }
  }
}

// ---------------------------------------------------------------------------
// K3: grid (key tiles, B*H).  Thread (ty, tx) holds the transposed
// scores of keys k0 + 4ty.. x queries q0 + 4tx.., and dK, dV of keys
// k0 + 4ty.. x dims h·64 + 4tx.. of the half h it is computing.
// ---------------------------------------------------------------------------
template <bool kCausal, int kD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ bias,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         float* __restrict__ dbias, int H, int S, int D,
                         Strides sq, Strides sk, Strides sv, Strides sdo,
                         Strides sdk, Strides sdv, float scale) {
  constexpr int kH = kD / kHalf;  // halves of the head dim
  count_launch(2);
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;                     // Kt[d][j], kH halves stacked
  float* Vt = Kt + kH * kTileFloats;    // Vt[d][j]
  float* Qt = Vt + kH * kTileFloats;    // Qt[d][i]
  float* dOt = Qt + kH * kTileFloats;   // dOt[d][i]
  float* Qs = dOt + kH * kTileFloats;   // Qs[i][d] of the current half
  float* dOs = Qs + kTileFloats;        // dOs[i][d] of the current half
  float* Ps = dOs + kTileFloats;        // Ps[i][j]
  float* dSs = Ps + kTileFloats;        // dSs[i][j]
  float* lse_s = dSs + kTileFloats;
  float* delta_s = lse_s + kTile;
  const int bh = blockIdx.y, k0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* qh = head(q, sq, bh, H);
  const float* doh = head(dout, sdo, bh, H);
  const float* brow = bias + (long long)bh * S;
  float* dkh = head(dk, sdk, bh, H);
  float* dvh = head(dv, sdv, bh, H);

  stage_all<true, kD>(Kt, head(k, sk, bh, H), sk.s, k0, S, D);
  stage_all<true, kD>(Vt, head(v, sv, bh, H), sv.s, k0, S, D);
  float bj[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + 4 * ty + r;
    bj[r] = j < S ? brow[j] : 0.f;
  }
  float db[4] = {};

  for (int h = 0; h < kH; ++h) {  // one half of dK and dV at a time
    float dk_acc[4][4] = {}, dv_acc[4][4] = {};
    for (int q0 = kCausal ? k0 : 0; q0 < S; q0 += kTile) {
      __syncthreads();
      stage_all<true, kD>(Qt, qh, sq.s, q0, S, D);
      stage_all<true, kD>(dOt, doh, sdo.s, q0, S, D);
      stage<false>(Qs, qh, sq.s, q0, S, D, h * kHalf);
      stage<false>(dOs, doh, sdo.s, q0, S, D, h * kHalf);
      if (threadIdx.x < kTile) {
        const int i = q0 + threadIdx.x;
        lse_s[threadIdx.x] = i < S ? lse[(long long)bh * S + i] : 0.f;
        delta_s[threadIdx.x] = i < S ? delta[(long long)bh * S + i] : 0.f;
      }
      __syncthreads();
      float st[4][4] = {}, dpt[4][4] = {};
      mma_4x4(st, Kt, 4 * ty, Qt, 4 * tx, kD);
      mma_4x4(dpt, Vt, 4 * ty, dOt, 4 * tx, kD);
      float p[4][4], ds[4][4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int il = 4 * tx + c, i = q0 + il;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = k0 + 4 * ty + r;
          const bool live = i < S && j < S && (!kCausal || j <= i);
          p[r][c] = live ? expf(st[r][c] * scale + bj[r] - lse_s[il]) : 0.f;
          const float dl = p[r][c] * (dpt[r][c] - delta_s[il]);
          if (h == 0) db[r] += dl;
          ds[r][c] = dl * scale;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int il = 4 * tx + c;
        *reinterpret_cast<float4*>(Ps + il * kLd + 4 * ty) =
            make_float4(p[0][c], p[1][c], p[2][c], p[3][c]);
        *reinterpret_cast<float4*>(dSs + il * kLd + 4 * ty) =
            make_float4(ds[0][c], ds[1][c], ds[2][c], ds[3][c]);
      }
      __syncthreads();
      mma_4x4(dv_acc, Ps, 4 * ty, dOs, 4 * tx, kTile);
      mma_4x4(dk_acc, dSs, 4 * ty, Qs, 4 * tx, kTile);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = k0 + 4 * ty + r;
      if (j >= S) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = h * kHalf + 4 * tx + c;
        if (d < D) {
          dkh[j * sdk.s + d] = dk_acc[r][c];
          dvh[j * sdv.s + d] = dv_acc[r][c];
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + 4 * ty + r;
    const float dbj = row_sum(db[r]);
    if (j < S && tx == 0) dbias[(long long)bh * S + j] = dbj;
  }
}

// shared memory of the SIMT kernels at head-dim capacity kD
template <int kD>
constexpr size_t dq_smem() {
  return (5 * (kD / kHalf) + 1) * kTileFloats * sizeof(float);
}
template <int kD>
constexpr size_t dkv_smem() {
  return ((4 * (kD / kHalf) + 4) * kTileFloats + 2 * kTile) * sizeof(float);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

constexpr int kMaxDim = 128;  // the kernels' head-dim capacity

bool bad_shape(int B, int H, int S, int D) {
  return B < 1 || H < 1 || S < 1 || D < 1 || D > kMaxDim;
}

template <bool kCausal, int kD>
cudaError_t bwd_dq_d(const void* q, const void* k, const void* v,
                     const float* bias, const void* dout, const float* lse,
                     const float* delta, void* dq, int B, int H, int S, int D,
                     const long long* st, float scale, cudaStream_t s) {
  auto kernel = flash_bwd_dq_kernel<kCausal, kD>;
  cudaError_t e = allow_smem(kernel, dq_smem<kD>());
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  kernel<<<grid, kThreads, dq_smem<kD>(), s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<const float*>(dout),
      lse, delta, static_cast<float*>(dq), H, S, D,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      Strides{st[12], st[13], st[14]}, scale);
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
  auto kernel = flash_bwd_dkv_kernel<kCausal, kD>;
  cudaError_t e = allow_smem(kernel, dkv_smem<kD>());
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  kernel<<<grid, kThreads, dkv_smem<kD>(), s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<const float*>(dout),
      lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), dbias, H,
      S, D, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      Strides{st[12], st[13], st[14]}, Strides{st[15], st[16], st[17]},
      scale);
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

}  // namespace

// C entry points.  Each returns the cudaError_t of its launch (0 on
// success).  dtype: 0 = float32 (K1: the split-TF32 kernel of
// flash_tf32.cuh; K2, K3: the SIMT kernels above), 1 = bfloat16 (the
// tensor-core kernels of flash_tc.cuh).  D up to 128; a larger D, or
// another dtype, returns cudaErrorInvalidValue.  Every pointer is a device
// pointer; strides are element strides (b, h, s) of each [B, H, S, D]
// operand in argument order; stream is a cudaStream_t.

extern "C" int pt_flash_fwd(int dtype, const void* q, const void* k,
                            const void* v, const float* bias, void* o,
                            float* lse, int B, int H, int S, int D,
                            long long qb, long long qh, long long qs,
                            long long kb, long long kh, long long ks,
                            long long vb, long long vh, long long vs,
                            long long ob, long long oh, long long os,
                            float scale, int causal, void* stream) {
  if (bad_shape(B, H, S, D) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const long long st[12] = {qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(causal ? flash_tf32::fwd<true>(q, k, v, bias, o, lse, B, H,
                                                S, D, st, scale, s)
                        : flash_tf32::fwd<false>(q, k, v, bias, o, lse, B,
                                                 H, S, D, st, scale, s));
  return (int)(causal ? flash_tc::fwd<true>(q, k, v, bias, o, lse, B, H, S,
                                            D, st, scale, s)
                      : flash_tc::fwd<false>(q, k, v, bias, o, lse, B, H, S,
                                             D, st, scale, s));
}

extern "C" int pt_flash_bwd_dq(int dtype, const void* q, const void* k,
                               const void* v, const float* bias,
                               const void* dout, const float* lse,
                               const float* delta, void* dq, int B, int H,
                               int S, int D, long long qb, long long qh,
                               long long qs, long long kb, long long kh,
                               long long ks, long long vb, long long vh,
                               long long vs, long long db, long long dh,
                               long long ds, long long gb, long long gh,
                               long long gs, float scale, int causal,
                               void* stream) {
  if (bad_shape(B, H, S, D) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const long long st[15] = {qb, qh, qs, kb, kh, ks, vb, vh,
                            vs, db, dh, ds, gb, gh, gs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(causal ? bwd_dq<true>(q, k, v, bias, dout, lse, delta, dq,
                                       B, H, S, D, st, scale, s)
                        : bwd_dq<false>(q, k, v, bias, dout, lse, delta, dq,
                                        B, H, S, D, st, scale, s));
  return (int)(causal ? flash_tc::bwd_dq<true>(q, k, v, bias, dout, lse,
                                               delta, dq, B, H, S, D, st,
                                               scale, s)
                      : flash_tc::bwd_dq<false>(q, k, v, bias, dout, lse,
                                                delta, dq, B, H, S, D, st,
                                                scale, s));
}

extern "C" int pt_flash_bwd_dkv(
    int dtype, const void* q, const void* k, const void* v, const float* bias,
    const void* dout, const float* lse, const float* delta, void* dk,
    void* dv, float* dbias, int B, int H, int S, int D, long long qb,
    long long qh, long long qs, long long kb, long long kh, long long ks,
    long long vb, long long vh, long long vs, long long db, long long dh,
    long long ds, long long kgb, long long kgh, long long kgs, long long vgb,
    long long vgh, long long vgs, float scale, int causal, void* stream) {
  if (bad_shape(B, H, S, D) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const long long st[18] = {qb, qh, qs, kb,  kh,  ks,  vb,  vh,  vs,
                            db, dh, ds, kgb, kgh, kgs, vgb, vgh, vgs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(causal ? bwd_dkv<true>(q, k, v, bias, dout, lse, delta,
                                        dk, dv, dbias, B, H, S, D, st, scale,
                                        s)
                        : bwd_dkv<false>(q, k, v, bias, dout, lse, delta,
                                         dk, dv, dbias, B, H, S, D, st,
                                         scale, s));
  return (int)(causal ? flash_tc::bwd_dkv<true>(q, k, v, bias, dout, lse,
                                                delta, dk, dv, dbias, B, H,
                                                S, D, st, scale, s)
                      : flash_tc::bwd_dkv<false>(q, k, v, bias, dout, lse,
                                                 delta, dk, dv, dbias, B, H,
                                                 S, D, st, scale, s));
}
