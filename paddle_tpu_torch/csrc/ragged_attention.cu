// K6: ragged (variable-length) attention, forward only, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel paddle_tpu/kernels/primitives/ragged.py
// `_ragged_kernel` (:74), launched by `_pallas_ragged` (:126, the call
// at :152).  Contract, kept exactly:
//   q, k, v, o  [B, H, S, D] f32 views with any (b, h, s) strides and a
//               contiguous D (the op's transpose2 views of [B, S, H, D]
//               activations are read in place; the wrapper copies
//               nothing).  A [BH, S, D] input is H = 1.
//   lengths     i32, one per batch row: row bh reads lengths[bh / H]
// Row b attends key positions j < lengths[b] (and j <= i when causal);
// masked logits are -1e30 (the JAX constant); m, l and acc are fp32; a
// row with l == 0 (length 0) writes zeros.  Rows at or past a row's
// length are computed under the same key mask, as the JAX kernel
// computes them.
//
// What bounds it on this card: at the serving path's shape (S = 128,
// D = 32, fp32, causal) one head moves 4·S·D·4 bytes (q, k, v, o) and
// does at most 2·S²·D multiply-adds — about 16 flops a byte under the
// causal mask, fewer with the length skips.  Against the fp32 rates
// without tensor cores (67 TFLOP/s, 3.35 TB/s: 20 flops a byte) that is
// just under the ridge point, so bytes bound it, with the fp32 units
// close behind.  This first version does its products on those units;
// mma.sync tiles in TF32 or bf16 are a later step.
//
// Design (K1's forward with a length vector in place of the key bias):
// one block of 256 threads per (bh, 64-query tile), looping over 64-key
// tiles; the loop stops at the row's length, and with causal also at
// the tile's last query, so a short row costs its own length in key
// tiles, not S.  Tiles are staged in shared memory as fp32, Q and K
// transposed (row stride 68 floats keeps float4 reads aligned and
// spreads banks).  A thread owns a 4x4 piece of the 64x64 score tile
// and of the output tile; the softmax statistics are reduced across the
// 16 threads of a row by warp shuffles.  Rows and keys past S are
// masked in the kernel, so S needs no padding; D up to 64 is zero-padded
// in shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;     // rows of a query tile and of a key tile
constexpr int kDim = 64;      // head-dim capacity (zero-padded)
constexpr int kLd = 68;       // padded row stride of a staged tile (floats)
constexpr int kThreads = 256; // 16 x 16 threads, a 4x4 piece each
constexpr int kTileFloats = kTile * kLd;
constexpr size_t kSmem = 4 * kTileFloats * sizeof(float);
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ const float* head(const float* p, Strides st,
                                             int bh, int H) {
  return p + (long long)(bh / H) * st.b + (long long)(bh % H) * st.h;
}

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

// Grid (query tiles, B*H).  Thread (ty, tx) holds scores of queries
// q0 + 4ty.. x keys k0 + 4tx.., and O of queries q0 + 4ty.. x dims 4tx..
template <bool kCausal>
__global__ void __launch_bounds__(kThreads)
    ragged_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const int* __restrict__ lengths, float* __restrict__ o,
                      int H, int S, int D, Strides sq, Strides sk, Strides sv,
                      Strides so, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;               // Qt[d][i]
  float* Kt = Qt + kTileFloats;   // Kt[d][j]
  float* Vs = Kt + kTileFloats;   // Vs[j][d]
  float* Pt = Vs + kTileFloats;   // Pt[j][i] = P[i][j]
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* kh = head(k, sk, bh, H);
  const float* vh = head(v, sv, bh, H);
  // keys a row may see: j < min(S, length); with causal, tiles past this
  // query tile's last row are skipped too
  const int n_keys = min(S, max(lengths[bh / H], 0));
  const int kv_end = kCausal ? min(n_keys, q0 + kTile) : n_keys;
  const int dp = (D + 3) & ~3;  // columns the score product sums

  stage<true>(Qt, head(q, sq, bh, H), sq.s, q0, S, D);
  float acc[4][4] = {}, m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) m[r] = kNegInf, l[r] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // the previous tile's Kt / Vs / Pt reads are done
    stage<true>(Kt, kh, sk.s, k0, S, D);
    stage<false>(Vs, vh, sv.s, k0, S, D);
    __syncthreads();
    float s[4][4] = {};
    mma_4x4(s, Qt, 4 * ty, Kt, 4 * tx, dp);
    float p[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + 4 * ty + r;
      float mx = kNegInf;
      bool live[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + 4 * tx + c;
        live[c] = j < n_keys && (!kCausal || j <= i);
        s[r][c] = live[c] ? s[r][c] * scale : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      const float alpha = expf(m[r] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // a masked key adds nothing, even while m_new is still -1e30
        p[r][c] = live[c] ? expf(s[r][c] - m_new) : 0.f;
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

  float* oh = o + (long long)(bh / H) * so.b + (long long)(bh % H) * so.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + 4 * ty + r;
    if (i >= S) continue;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];  // length 0: acc is 0
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 4 * tx + c;
      if (d < D) oh[i * so.s + d] = acc[r][c] / l_safe;
    }
  }
}

template <bool kCausal>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* lengths, float* o, int B, int H, int S, int D,
                   const long long* st, float scale, cudaStream_t s) {
  auto kernel = ragged_fwd_kernel<kCausal>;
  // above 48 KB a kernel must opt in to dynamic shared memory
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  kernel<<<grid, kThreads, kSmem, s>>>(
      q, k, v, lengths, o, H, S, D, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]}, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  Every pointer is
// a device pointer; strides are element strides (b, h, s) of q, k, v and
// o in that order; lengths holds B int32; stream is a cudaStream_t.
extern "C" int pt_ragged_attention_f32(
    const float* q, const float* k, const float* v, const int* lengths,
    float* o, int B, int H, int S, int D, long long qb, long long qh,
    long long qs, long long kb, long long kh, long long ks, long long vb,
    long long vh, long long vs, long long ob, long long oh, long long os,
    float scale, int causal, void* stream) {
  if (B < 1 || H < 1 || S < 1 || D < 1 || D > kDim)
    return (int)cudaErrorInvalidValue;
  const long long st[12] = {qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(causal ? launch<true>(q, k, v, lengths, o, B, H, S, D, st,
                                     scale, s)
                      : launch<false>(q, k, v, lengths, o, B, H, S, D, st,
                                      scale, s));
}
