// K4: fused bias + GeLU (+ dropout mask) forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel closure in
// paddle_tpu/kernels/fused_bias_act.py `_pallas_chain` (:96, kernel body
// :106):  out = gelu(x + bias) [* mask * scale], over x [R, H] f32,
// bias [H] f32 broadcast along the last dim, an optional uint8 mask
// [R, H] (drawn outside the kernel; scale = 1/(1-p)), out [R, H] f32.
// GeLU is the exact erfc form or the tanh form, spelled as jax.nn.gelu
// spells them.
//
// What bounds it on this card: one pass, 8 bytes read and written per
// element (9 with the mask) for some ten flops — bound by bytes, far
// below the ridge point.  Design: a grid-stride elementwise pass with
// 16-byte vector loads and stores (float4, and uchar4 for the mask)
// when H is a multiple of 4 and the pointers are aligned; otherwise a
// scalar pass, so any H works and the ragged tail needs no padding.
// The TPU kernel's rules (H % 128 == 0, rows padded to 32) were Mosaic
// tiling constraints and are not kept.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float gelu(float x, bool approximate) {
  if (approximate) {
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
    const float cdf = 0.5f * (1.0f + tanhf(k * (x + 0.044715f * (x * x * x))));
    return x * cdf;
  }
  const float sqrt_half = 0.7071067811865476f;
  return 0.5f * x * erfcf(-x * sqrt_half);
}

template <bool kMask, bool kApprox>
__global__ void bias_gelu_vec4(const float4* __restrict__ x,
                               const float* __restrict__ bias,
                               const uchar4* __restrict__ mask,
                               float4* __restrict__ out, long long n4, int H,
                               float scale) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    const int c = (int)((i * 4) % H);  // H % 4 == 0: one row per vector
    const float4 v = x[i];
    float4 y;
    y.x = gelu(v.x + bias[c], kApprox);
    y.y = gelu(v.y + bias[c + 1], kApprox);
    y.z = gelu(v.z + bias[c + 2], kApprox);
    y.w = gelu(v.w + bias[c + 3], kApprox);
    if (kMask) {
      const uchar4 mk = mask[i];
      y.x = y.x * (float)mk.x * scale;
      y.y = y.y * (float)mk.y * scale;
      y.z = y.z * (float)mk.z * scale;
      y.w = y.w * (float)mk.w * scale;
    }
    out[i] = y;
  }
}

template <bool kMask, bool kApprox>
__global__ void bias_gelu_scalar(const float* __restrict__ x,
                                 const float* __restrict__ bias,
                                 const unsigned char* __restrict__ mask,
                                 float* __restrict__ out, long long n, int H,
                                 float scale) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float y = gelu(x[i] + bias[i % H], kApprox);
    if (kMask) y = y * (float)mask[i] * scale;
    out[i] = y;
  }
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // SMs x resident blocks

int blocks_for(long long work) {
  const long long b = (work + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

template <bool kMask, bool kApprox>
cudaError_t launch(const float* x, const float* bias,
                   const unsigned char* mask, float* out, long long R, int H,
                   float scale, cudaStream_t stream) {
  const long long n = R * H;
  const bool vec = H % 4 == 0 &&
                   (reinterpret_cast<size_t>(x) & 15) == 0 &&
                   (reinterpret_cast<size_t>(out) & 15) == 0 &&
                   (!kMask || (reinterpret_cast<size_t>(mask) & 3) == 0);
  if (vec) {
    const long long n4 = n / 4;
    bias_gelu_vec4<kMask, kApprox><<<blocks_for(n4), kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(x), bias,
        reinterpret_cast<const uchar4*>(mask),
        reinterpret_cast<float4*>(out), n4, H, scale);
  } else {
    bias_gelu_scalar<kMask, kApprox><<<blocks_for(n), kThreads, 0, stream>>>(
        x, bias, mask, out, n, H, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  mask may be
// null (no dropout); every other pointer is a device pointer; stream is
// a cudaStream_t.
extern "C" int pt_fused_bias_gelu_f32(const float* x, const float* bias,
                                      const unsigned char* mask, float* out,
                                      long long R, int H, float scale,
                                      int approximate, void* stream) {
  if (H < 1 || R < 0) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask != nullptr)
    return (int)(approximate ? launch<true, true>(x, bias, mask, out, R, H,
                                                  scale, s)
                             : launch<true, false>(x, bias, mask, out, R, H,
                                                   scale, s));
  return (int)(approximate ? launch<false, true>(x, bias, mask, out, R, H,
                                                 scale, s)
                           : launch<false, false>(x, bias, mask, out, R, H,
                                                  scale, s));
}
