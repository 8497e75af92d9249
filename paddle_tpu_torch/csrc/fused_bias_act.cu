// K4: fused bias + GeLU (+ dropout mask) forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel closure in
// paddle_tpu/kernels/fused_bias_act.py `_pallas_chain` (:96, kernel body
// :106):  out = gelu(x + bias) [* mask * scale], over x [R, H], bias [H]
// broadcast along the last dim, an optional uint8 mask [R, H] (drawn
// outside the kernel; scale = 1/(1-p)), out [R, H] in x's dtype.  x and
// out are float32 or bfloat16, and so is bias (each its own template
// parameter); the arithmetic is fp32 either way, as in the JAX function.
// GeLU is the exact erfc form or the tanh form, spelled as jax.nn.gelu
// spells them.
//
// What bounds it on this card: one pass, 2 (bf16) or 4 (fp32) bytes read
// and written per element, plus one with the mask, for some ten flops —
// bound by bytes, far below the ridge point.  Design: a grid-stride
// elementwise pass with vector loads and stores of four elements (16
// bytes for fp32, 8 for bf16, uchar4 for the mask) when H is a multiple
// of 4 and the pointers are aligned; otherwise a scalar pass, so any H
// works and the ragged tail needs no padding.  The TPU kernel's rules
// (H % 128 == 0, rows padded to 32) were Mosaic tiling constraints and
// are not kept.

#include <cuda_bf16.h>
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

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// four consecutive elements, loaded and stored as one access
template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T v[4];
};

template <typename T, typename TB, bool kMask, bool kApprox>
__global__ void bias_gelu_vec4(const Vec4<T>* __restrict__ x,
                               const TB* __restrict__ bias,
                               const uchar4* __restrict__ mask,
                               Vec4<T>* __restrict__ out, long long n4, int H,
                               float scale) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    const int c = (int)((i * 4) % H);  // H % 4 == 0: one row per vector
    const Vec4<T> xv = x[i];
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      y[e] = gelu(to_f(xv.v[e]) + to_f(bias[c + e]), kApprox);
    if (kMask) {
      const uchar4 mk = mask[i];
      y[0] = y[0] * (float)mk.x * scale;
      y[1] = y[1] * (float)mk.y * scale;
      y[2] = y[2] * (float)mk.z * scale;
      y[3] = y[3] * (float)mk.w * scale;
    }
    Vec4<T> o;
#pragma unroll
    for (int e = 0; e < 4; ++e) o.v[e] = from_f<T>(y[e]);
    out[i] = o;
  }
}

template <typename T, typename TB, bool kMask, bool kApprox>
__global__ void bias_gelu_scalar(const T* __restrict__ x,
                                 const TB* __restrict__ bias,
                                 const unsigned char* __restrict__ mask,
                                 T* __restrict__ out, long long n, int H,
                                 float scale) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float y = gelu(to_f(x[i]) + to_f(bias[i % H]), kApprox);
    if (kMask) y = y * (float)mask[i] * scale;
    out[i] = from_f<T>(y);
  }
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // SMs x resident blocks

int blocks_for(long long work) {
  const long long b = (work + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

template <typename T, typename TB, bool kMask, bool kApprox>
cudaError_t launch(const void* xp, const void* bp, const unsigned char* mask,
                   void* op, long long R, int H, float scale,
                   cudaStream_t stream) {
  const T* x = static_cast<const T*>(xp);
  const TB* bias = static_cast<const TB*>(bp);
  T* out = static_cast<T*>(op);
  const long long n = R * H;
  const size_t align = sizeof(Vec4<T>);
  const bool vec = H % 4 == 0 &&
                   (reinterpret_cast<size_t>(x) % align) == 0 &&
                   (reinterpret_cast<size_t>(out) % align) == 0 &&
                   (!kMask || (reinterpret_cast<size_t>(mask) & 3) == 0);
  if (vec) {
    const long long n4 = n / 4;
    bias_gelu_vec4<T, TB, kMask, kApprox>
        <<<blocks_for(n4), kThreads, 0, stream>>>(
            reinterpret_cast<const Vec4<T>*>(x), bias,
            reinterpret_cast<const uchar4*>(mask),
            reinterpret_cast<Vec4<T>*>(out), n4, H, scale);
  } else {
    bias_gelu_scalar<T, TB, kMask, kApprox>
        <<<blocks_for(n), kThreads, 0, stream>>>(x, bias, mask, out, n, H,
                                                 scale);
  }
  return cudaGetLastError();
}

template <typename T, typename TB>
cudaError_t dispatch(const void* x, const void* bias,
                     const unsigned char* mask, void* out, long long R, int H,
                     float scale, int approximate, cudaStream_t s) {
  if (mask != nullptr)
    return approximate ? launch<T, TB, true, true>(x, bias, mask, out, R, H,
                                                   scale, s)
                       : launch<T, TB, true, false>(x, bias, mask, out, R, H,
                                                    scale, s);
  return approximate ? launch<T, TB, false, true>(x, bias, mask, out, R, H,
                                                  scale, s)
                     : launch<T, TB, false, false>(x, bias, mask, out, R, H,
                                                   scale, s);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  x_dtype and
// bias_dtype: 0 = float32, 1 = bfloat16 (out has x's dtype).  mask may
// be null (no dropout); every other pointer is a device pointer; stream
// is a cudaStream_t.
extern "C" int pt_fused_bias_gelu(int x_dtype, int bias_dtype, const void* x,
                                  const void* bias, const unsigned char* mask,
                                  void* out, long long R, int H, float scale,
                                  int approximate, void* stream) {
  if (H < 1 || R < 0 || x_dtype < 0 || x_dtype > 1 || bias_dtype < 0 ||
      bias_dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return (int)(bias_dtype == 0
                     ? dispatch<float, float>(x, bias, mask, out, R, H, scale,
                                              approximate, s)
                     : dispatch<float, __nv_bfloat16>(
                           x, bias, mask, out, R, H, scale, approximate, s));
  return (int)(bias_dtype == 0
                   ? dispatch<__nv_bfloat16, float>(x, bias, mask, out, R, H,
                                                    scale, approximate, s)
                   : dispatch<__nv_bfloat16, __nv_bfloat16>(
                         x, bias, mask, out, R, H, scale, approximate, s));
}
