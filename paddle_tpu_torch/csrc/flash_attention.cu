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
// Two designs.  K1-K3 on bfloat16, the training path's dtype, run on
// the tensor cores: flash_tc.cuh, whose note gives their bound and
// design (K2 since it was taken off the SIMT units: 0.495 ms at the
// train step's [1536, 128, 64], 12.9x its byte bound and 2.5x SDPA's
// whole backward, on the card).  float32 K1-K3 are the SIMT design
// below: the parity checks hold them to 2e-5, tighter than a TF32
// tensor core could.
//
// What bounds the SIMT design: at the training shape (S = 128, D = 64)
// K2 does some 77 flops a byte, below the bf16 tensor cores' ridge
// point (~295), so the least time is set by bytes; on the fp32 SIMT
// units (67 TFLOP/s, not the 989 of bf16 tensor cores) it is bound by
// those and by shared-memory bandwidth instead.
//
// SIMT design: one block of 256 threads per (bh, 64-row tile): K1 and K2
// per query tile looping over key tiles, K3 per key tile looping over
// query tiles, so dK, dV and dBias need no atomics.  Tiles are staged in
// shared memory as fp32, transposed where a product reads them along D
// (row stride 68 floats keeps float4 reads aligned and spreads banks).
// A thread owns a 4x4 piece of each 64x64 tile: the scores, the
// softmax statistics (reduced across the 16 threads of a row by warp
// shuffles) and the output accumulator.  A ragged last tile is masked in
// the kernel (rows or keys past S load as zeros and get P = 0), so S
// needs no padding; D up to 64 is zero-padded in shared memory.

#include <cuda_runtime.h>

#include "flash_tc.cuh"

namespace {

using flash_tc::head;
using flash_tc::kNegInf;
using flash_tc::Strides;

constexpr int kTile = 64;     // rows of a query tile and of a key tile
constexpr int kDim = 64;      // head-dim capacity (zero-padded)
constexpr int kLd = 68;       // padded row stride of a staged tile (floats)
constexpr int kThreads = 256; // 16 x 16 threads, a 4x4 piece each
constexpr int kTileFloats = kTile * kLd;

// Stage rows [row0, row0 + 64) x [0, 64) of a [S, D] matrix (row stride
// ss): row-major dst[r * kLd + d], or transposed dst[d * kLd + r].  Rows
// past S and columns past D are zeros.
template <bool kTrans>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long ss, int row0, int S, int D) {
  for (int idx = threadIdx.x; idx < kTile * kDim; idx += kThreads) {
    const int r = idx / kDim, d = idx % kDim;
    const int row = row0 + r;
    const float v = (row < S && d < D) ? src[row * ss + d] : 0.f;
    if (kTrans)
      dst[d * kLd + r] = v;
    else
      dst[r * kLd + d] = v;
  }
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
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// K1: grid (query tiles, B*H).  Thread (ty, tx) holds scores of queries
// q0 + 4ty.. x keys k0 + 4tx.., and O of queries q0 + 4ty.. x dims 4tx..
// ---------------------------------------------------------------------------
template <bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias, float* __restrict__ o,
                     float* __restrict__ lse, int H, int S, int D, Strides sq,
                     Strides sk, Strides sv, Strides so, float scale) {
  count_launch(0);
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;               // Qt[d][i]
  float* Kt = Qt + kTileFloats;   // Kt[d][j]
  float* Vs = Kt + kTileFloats;   // Vs[j][d]
  float* Pt = Vs + kTileFloats;   // Pt[j][i] = P[i][j]
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* qh = head(q, sq, bh, H);
  const float* kh = head(k, sk, bh, H);
  const float* vh = head(v, sv, bh, H);
  const float* brow = bias + (long long)bh * S;

  stage<true>(Qt, qh, sq.s, q0, S, D);
  float acc[4][4] = {}, m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) m[r] = kNegInf, l[r] = 0.f;

  const int kv_end = kCausal ? min(S, q0 + kTile) : S;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // the previous tile's Kt / Vs / Pt reads are done
    stage<true>(Kt, kh, sk.s, k0, S, D);
    stage<false>(Vs, vh, sv.s, k0, S, D);
    __syncthreads();
    float s[4][4] = {};
    mma_4x4(s, Qt, 4 * ty, Kt, 4 * tx, kDim);
    float bj[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = k0 + 4 * tx + c;
      bj[c] = j < S ? brow[j] : 0.f;
    }
    float p[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + 4 * ty + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + 4 * tx + c;
        const bool live = j < S && (!kCausal || j <= i);
        s[r][c] = live ? s[r][c] * scale + bj[c] : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      const float alpha = expf(m[r] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + 4 * tx + c;
        // a key past S must add nothing even while m_new is -1e30
        p[r][c] = j < S ? expf(s[r][c] - m_new) : 0.f;
        ps += p[r][c];
      }
      l[r] = l[r] * alpha + row_sum(ps);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(Pt + (4 * tx + c) * kLd + 4 * ty) =
          make_float4(p[0][c], p[1][c], p[2][c], p[3][c]);
    __syncthreads();
    mma_4x4(acc, Pt, 4 * ty, Vs, 4 * tx, kTile);
  }

  float* oh = head(o, so, bh, H);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + 4 * ty + r;
    if (i >= S) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 4 * tx + c;
      if (d < D) oh[i * so.s + d] = acc[r][c] / l_safe;
    }
    if (tx == 0) lse[(long long)bh * S + i] = m[r] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// K2: grid (query tiles, B*H).  Same thread layout as K1; dQ of queries
// q0 + 4ty.. x dims 4tx..
// ---------------------------------------------------------------------------
template <bool kCausal>
__global__ void __launch_bounds__(kThreads)
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
  count_launch(1);
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                // Qt[d][i]
  float* dOt = Qt + kTileFloats;   // dOt[d][i]
  float* Kt = dOt + kTileFloats;   // Kt[d][j]
  float* Vt = Kt + kTileFloats;    // Vt[d][j]
  float* Ks = Vt + kTileFloats;    // Ks[j][d]
  float* dSt = Ks + kTileFloats;   // dSt[j][i] = dS[i][j]
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* kh = head(k, sk, bh, H);
  const float* vh = head(v, sv, bh, H);
  const float* brow = bias + (long long)bh * S;

  stage<true>(Qt, head(q, sq, bh, H), sq.s, q0, S, D);
  stage<true>(dOt, head(dout, sdo, bh, H), sdo.s, q0, S, D);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + 4 * ty + r;
    lse_r[r] = i < S ? lse[(long long)bh * S + i] : 0.f;
    delta_r[r] = i < S ? delta[(long long)bh * S + i] : 0.f;
  }
  float acc[4][4] = {};

  const int kv_end = kCausal ? min(S, q0 + kTile) : S;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();
    stage<true>(Kt, kh, sk.s, k0, S, D);
    stage<true>(Vt, vh, sv.s, k0, S, D);
    stage<false>(Ks, kh, sk.s, k0, S, D);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    mma_4x4(s, Qt, 4 * ty, Kt, 4 * tx, kDim);
    mma_4x4(dp, dOt, 4 * ty, Vt, 4 * tx, kDim);
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
    mma_4x4(acc, dSt, 4 * ty, Ks, 4 * tx, kTile);
  }

  float* dqh = head(dq, sdq, bh, H);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + 4 * ty + r;
    if (i >= S) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 4 * tx + c;
      if (d < D) dqh[i * sdq.s + d] = acc[r][c];
    }
  }
}

// ---------------------------------------------------------------------------
// K3: grid (key tiles, B*H).  Thread (ty, tx) holds the transposed
// scores of keys k0 + 4ty.. x queries q0 + 4tx.., and dK, dV of keys
// k0 + 4ty.. x dims 4tx..
// ---------------------------------------------------------------------------
template <bool kCausal>
__global__ void __launch_bounds__(kThreads)
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
  count_launch(2);
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;                // Kt[d][j]
  float* Vt = Kt + kTileFloats;    // Vt[d][j]
  float* Qt = Vt + kTileFloats;    // Qt[d][i]
  float* dOt = Qt + kTileFloats;   // dOt[d][i]
  float* Qs = dOt + kTileFloats;   // Qs[i][d]
  float* dOs = Qs + kTileFloats;   // dOs[i][d]
  float* Ps = dOs + kTileFloats;   // Ps[i][j]
  float* dSs = Ps + kTileFloats;   // dSs[i][j]
  float* lse_s = dSs + kTileFloats;
  float* delta_s = lse_s + kTile;
  const int bh = blockIdx.y, k0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* qh = head(q, sq, bh, H);
  const float* doh = head(dout, sdo, bh, H);
  const float* brow = bias + (long long)bh * S;

  stage<true>(Kt, head(k, sk, bh, H), sk.s, k0, S, D);
  stage<true>(Vt, head(v, sv, bh, H), sv.s, k0, S, D);
  float bj[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + 4 * ty + r;
    bj[r] = j < S ? brow[j] : 0.f;
  }
  float dk_acc[4][4] = {}, dv_acc[4][4] = {}, db[4] = {};

  for (int q0 = kCausal ? k0 : 0; q0 < S; q0 += kTile) {
    __syncthreads();
    stage<true>(Qt, qh, sq.s, q0, S, D);
    stage<true>(dOt, doh, sdo.s, q0, S, D);
    stage<false>(Qs, qh, sq.s, q0, S, D);
    stage<false>(dOs, doh, sdo.s, q0, S, D);
    if (threadIdx.x < kTile) {
      const int i = q0 + threadIdx.x;
      lse_s[threadIdx.x] = i < S ? lse[(long long)bh * S + i] : 0.f;
      delta_s[threadIdx.x] = i < S ? delta[(long long)bh * S + i] : 0.f;
    }
    __syncthreads();
    float st[4][4] = {}, dpt[4][4] = {};
    mma_4x4(st, Kt, 4 * ty, Qt, 4 * tx, kDim);
    mma_4x4(dpt, Vt, 4 * ty, dOt, 4 * tx, kDim);
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
        db[r] += dl;
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

  float* dkh = head(dk, sdk, bh, H);
  float* dvh = head(dv, sdv, bh, H);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = k0 + 4 * ty + r;
    const float dbj = row_sum(db[r]);
    if (j >= S) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 4 * tx + c;
      if (d < D) {
        dkh[j * sdk.s + d] = dk_acc[r][c];
        dvh[j * sdv.s + d] = dv_acc[r][c];
      }
    }
    if (tx == 0) dbias[(long long)bh * S + j] = dbj;
  }
}

constexpr size_t kFwdSmem = 4 * kTileFloats * sizeof(float);
constexpr size_t kDqSmem = 6 * kTileFloats * sizeof(float);
constexpr size_t kDkvSmem = (8 * kTileFloats + 2 * kTile) * sizeof(float);

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

bool bad_shape(int B, int H, int S, int D) {
  return B < 1 || H < 1 || S < 1 || D < 1 || D > kDim;
}

template <bool kCausal>
cudaError_t fwd(const void* q, const void* k, const void* v,
                const float* bias, void* o, float* lse, int B, int H, int S,
                int D, const long long* st, float scale, cudaStream_t s) {
  auto kernel = flash_fwd_kernel<kCausal>;
  cudaError_t e = allow_smem(kernel, kFwdSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  kernel<<<grid, kThreads, kFwdSmem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<float*>(o), lse, H, S,
      D, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, scale);
  return cudaGetLastError();
}

template <bool kCausal>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const float* bias, const void* dout, const float* lse,
                   const float* delta, void* dq, int B, int H, int S, int D,
                   const long long* st, float scale, cudaStream_t s) {
  auto kernel = flash_bwd_dq_kernel<kCausal>;
  cudaError_t e = allow_smem(kernel, kDqSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  kernel<<<grid, kThreads, kDqSmem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<const float*>(dout),
      lse, delta, static_cast<float*>(dq), H, S, D,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      Strides{st[12], st[13], st[14]}, scale);
  return cudaGetLastError();
}

template <bool kCausal>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const float* bias, const void* dout, const float* lse,
                    const float* delta, void* dk, void* dv, float* dbias,
                    int B, int H, int S, int D, const long long* st,
                    float scale, cudaStream_t s) {
  auto kernel = flash_bwd_dkv_kernel<kCausal>;
  cudaError_t e = allow_smem(kernel, kDkvSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  kernel<<<grid, kThreads, kDkvSmem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<const float*>(dout),
      lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), dbias, H,
      S, D, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      Strides{st[12], st[13], st[14]}, Strides{st[15], st[16], st[17]},
      scale);
  return cudaGetLastError();
}

}  // namespace

// C entry points.  Each returns the cudaError_t of its launch (0 on
// success).  dtype: 0 = float32 (the SIMT kernels above), 1 = bfloat16
// (the tensor-core kernels of flash_tc.cuh).  Every pointer is a device
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
    return (int)(causal ? fwd<true>(q, k, v, bias, o, lse, B, H, S, D, st,
                                    scale, s)
                        : fwd<false>(q, k, v, bias, o, lse, B, H, S, D, st,
                                     scale, s));
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
