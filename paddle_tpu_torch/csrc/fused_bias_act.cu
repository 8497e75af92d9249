// K4: fused bias + GeLU (+ dropout mask) forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel closure in
// paddle_tpu/kernels/fused_bias_act.py `_pallas_chain` (:96, kernel body
// :106):  out = gelu(x + bias) [* mask * scale], over x [R, H], bias [H]
// broadcast along the last dim, an optional uint8 mask [R, H] (drawn
// outside the kernel; scale = 1/(1-p)), out [R, H] in x's dtype.  x and
// out are float32, bfloat16 or float16, and so is bias (each its own
// template parameter); the arithmetic is fp32 either way, as in the JAX
// function.  A float16 result is rounded to nearest-even (__floats2half2_rn,
// __float2half_rn): a value past fp16's range becomes ±inf, as
// astype(float16) gives it in the JAX function (the AMP rewrite's fp16
// mode hands the FFN fp16 x and an fp32 bias).
// GeLU is the exact form, 0.5·x·erfc(−x/√2) as jax.nn.gelu spells it,
// or the tanh form.
//
// What bounds it on this card: one pass, 2 (bf16, fp16) or 4 (fp32) bytes read
// and written an element, plus one with the mask.  At 3.35 TB/s over 132
// SMs the bf16 pass streams about 3.2 elements an SM-cycle, which leaves
// about 40 thread-instructions an element at the full issue rate.  The
// first version spent 67.5 SASS instructions an element in its bf16 loop
// (a 64-bit modulo a vector, erfcf, a bias load an element, 8-byte
// accesses), so it was bound by issue, not bytes.
//
// Design, to cut the instructions an element:
// - A 2-D grid: blockIdx.x a tile of 128 column vectors, blockIdx.y a
//   set of row groups.  A thread owns V consecutive columns (16 bytes of
//   x: 8 bf16 or fp16, or 4 fp32), converts their bias to fp32 once, and walks
//   rows two at a time, the next two rows' loads issued before this
//   pair is computed (so a thread has four rows in flight).  No division
//   or modulo an element.
// - 16-byte loads and stores with streaming hints (__ldcs / __stcs): x
//   and out are each touched once.  The mask is loaded V bytes at once.
// - The exact GeLU without erfcf.  With u = |x|·√(log2(e)/2) (so that
//   2^(−u²) = exp(−x²/2)), 0.5·erfc(|x|/√2) = 2^(−u²)·P(q), where
//   q = (u − 3)/(u + 3) and P is a degree-8 polynomial fitted to
//   0.5·erfcx(u/√log2(e)) over u in [0, 11.41] (|x| <= 13.4; past it the
//   result is x or flushes to zero), largest relative error 9.8e-8.  Φ(x)
//   is 1 − h for x >= 0 and h below, so the tail never cancels.  One
//   rcp.approx, one ex2.approx, nine FMAs.  Worst error of the fp32
//   result over every bf16 value and a dense fp32 grid in [−12, 12]
//   (tests/test_torch_port_kernels.py, a float32 copy of the formula,
//   with the card's reciprocal and 2^y also taken 2 ulp off either way):
//   within 32 ulp for x >= −4 and 256 ulp on [−12, −4) of the exact GeLU
//   (float64), and within 32 and 320 ulp of jax.nn.gelu, which rounds
//   x² in its exponent alike.  The tail's error is that rounding of u²;
//   there the result is below 1.3e-4 (256 ulp is a relative 1.5e-5).  A
//   result under the smallest normal float (x < −13.2) flushes to zero;
//   past |x| = 13.4, u is clamped and the result is x or zero.  That is
//   far inside the gates: 1e-6 absolute + 1e-6 relative against the
//   plain version in fp32, one bf16 rounding step in bf16.
// - The tanh form keeps tanhf (it is not on a path of the port).
// - Any H and any alignment: where H is not a multiple of V, or a
//   pointer is not aligned to its vector, the same kernel runs with
//   V = 1 (a thread owns one column), so nothing is padded.
//
// The TPU kernel's rules (H % 128 == 0, rows padded to 32) were Mosaic
// tiling constraints and are not kept.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include "launch_count.cuh"

#include <cstring>

namespace {

constexpr int kThreads = 128;  // column vectors a CTA
constexpr int kRows = 2;       // rows a thread computes at once

// exp2 on the multi-function unit (one instruction; flushes denormals)
__device__ __forceinline__ float ex2_approx(float y) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y));
  return r;
}

// 1/y on the multi-function unit (y here is in [3, 15])
__device__ __forceinline__ float rcp_approx(float y) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y));
  return r;
}

// gelu(x) = x·Φ(x), Φ(x) = 0.5·erfc(−x/√2); see the note above
__device__ __forceinline__ float gelu_exact(float x) {
  const float u = fminf(fabsf(x) * 8.493218003e-01f, 1.141066288e+01f);
  const float q = (u - 3.0f) * rcp_approx(u + 3.0f);
  float p = 1.417925960e-04f;
  p = fmaf(p, q, 3.844848543e-04f);
  p = fmaf(p, q, -1.354722423e-03f);
  p = fmaf(p, q, -1.940678339e-03f);
  p = fmaf(p, q, 1.988566667e-02f);
  p = fmaf(p, q, -6.243826821e-02f);
  p = fmaf(p, q, 1.258567274e-01f);
  p = fmaf(p, q, -1.859859377e-01f);
  p = fmaf(p, q, 1.054900959e-01f);
  const float h = ex2_approx(-(u * u)) * p;  // 0.5·erfc(|x|/√2)
  return x * (x >= 0.f ? 1.f - h : h);
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  const float cdf = 0.5f * (1.0f + tanhf(k * (x + 0.044715f * (x * x * x))));
  return x * cdf;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

// the unsigned type of B bytes, which __ldcs / __stcs take
template <int B>
struct Bits;
template <>
struct Bits<16> {
  using type = uint4;
};
template <>
struct Bits<8> {
  using type = uint2;
};
template <>
struct Bits<4> {
  using type = unsigned int;
};
template <>
struct Bits<2> {
  using type = unsigned short;
};
template <>
struct Bits<1> {
  using type = unsigned char;
};

template <typename T, int N>
__device__ __forceinline__ typename Bits<N * sizeof(T)>::type load_cs(
    const T* p) {
  using B = typename Bits<N * sizeof(T)>::type;
  return __ldcs(reinterpret_cast<const B*>(p));
}

// V values of T, unpacked to fp32
template <typename T, int V>
__device__ __forceinline__ void unpack(
    const typename Bits<V * sizeof(T)>::type& raw, float (&f)[V]) {
  T v[V];
  memcpy(v, &raw, sizeof(v));
#pragma unroll
  for (int e = 0; e < V; ++e) f[e] = to_f(v[e]);
}

// V fp32 values rounded to nearest-even in T, stored with one access
template <int V>
__device__ __forceinline__ void store_cs(float* p, const float (&y)[V]) {
  typename Bits<V * 4>::type raw;
  memcpy(&raw, y, sizeof(raw));
  __stcs(reinterpret_cast<typename Bits<V * 4>::type*>(p), raw);
}
template <int V>
__device__ __forceinline__ void store_cs(__nv_bfloat16* p,
                                         const float (&y)[V]) {
  __nv_bfloat16 v[V];
  if constexpr (V % 2 == 0) {
#pragma unroll
    for (int e = 0; e < V; e += 2) {
      const __nv_bfloat162 two = __floats2bfloat162_rn(y[e], y[e + 1]);
      memcpy(v + e, &two, sizeof(two));
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = __float2bfloat16(y[e]);
  }
  typename Bits<V * 2>::type raw;
  memcpy(&raw, v, sizeof(raw));
  __stcs(reinterpret_cast<typename Bits<V * 2>::type*>(p), raw);
}
template <int V>
__device__ __forceinline__ void store_cs(__half* p, const float (&y)[V]) {
  __half v[V];
  if constexpr (V % 2 == 0) {
#pragma unroll
    for (int e = 0; e < V; e += 2) {
      const __half2 two = __floats2half2_rn(y[e], y[e + 1]);
      memcpy(v + e, &two, sizeof(two));
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = __float2half_rn(y[e]);
  }
  typename Bits<V * 2>::type raw;
  memcpy(&raw, v, sizeof(raw));
  __stcs(reinterpret_cast<typename Bits<V * 2>::type*>(p), raw);
}

// Grid (column tiles, row sets).  Thread t of CTA (bx, by) owns columns
// [c0, c0 + V), c0 = (bx·128 + t)·V, and rows by·kRows + k (k < kRows),
// then the same plus gridDim.y·kRows, and so on; each group's loads are
// issued while the group before it is computed.
template <typename T, typename TB, int V, bool kMask, bool kApprox>
__global__ void __launch_bounds__(kThreads, 8)
    bias_gelu_rows(const T* __restrict__ x, const TB* __restrict__ bias,
                   const unsigned char* __restrict__ mask,
                   T* __restrict__ out, long long R, int H, float scale) {
  count_launch(0);
  const int c0 = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (c0 >= H) return;
  float b[V];
#pragma unroll
  for (int e = 0; e < V; ++e) b[e] = to_f(bias[c0 + e]);
  using XBits = typename Bits<V * sizeof(T)>::type;
  using MBits = typename Bits<V>::type;
  const long long step = (long long)gridDim.y * kRows;
  XBits xr[kRows], xn[kRows];
  MBits mr[kRows], mn[kRows];
  auto fetch = [&](long long r0, XBits (&xs)[kRows], MBits (&ms)[kRows]) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (r0 + k < R) {
        const long long off = (r0 + k) * H + c0;
        xs[k] = load_cs<T, V>(x + off);
        if (kMask) ms[k] = load_cs<unsigned char, V>(mask + off);
      }
    }
  };
  long long r0 = (long long)blockIdx.y * kRows;
  if (r0 < R) fetch(r0, xr, mr);
  for (; r0 < R; r0 += step) {
    if (r0 + step < R) fetch(r0 + step, xn, mn);  // next group in flight
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (r0 + k >= R) break;
      float y[V];
      unpack<T, V>(xr[k], y);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float s = y[e] + b[e];
        y[e] = kApprox ? gelu_tanh(s) : gelu_exact(s);
      }
      if (kMask) {
        unsigned char m[V];
        memcpy(m, &mr[k], V);
#pragma unroll
        for (int e = 0; e < V; ++e) y[e] = y[e] * (float)m[e] * scale;
      }
      store_cs<V>(out + (r0 + k) * H + c0, y);
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      xr[k] = xn[k];
      mr[k] = mn[k];
    }
  }
}

// CTAs of `kernel` resident on the card
int resident_ctas(const void* kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return sms * (per_sm > 0 ? per_sm : 1);
}

template <typename T, typename TB, int V, bool kMask, bool kApprox>
cudaError_t launch_v(const T* x, const TB* bias, const unsigned char* mask,
                     T* out, long long R, int H, float scale,
                     cudaStream_t stream) {
  auto kernel = bias_gelu_rows<T, TB, V, kMask, kApprox>;
  const int tiles = (H / V + kThreads - 1) / kThreads;
  // one wave of resident CTAs, each walking the same number of row
  // groups (the last CTAs of a ragged R may walk one fewer)
  const long long groups = (R + kRows - 1) / kRows;
  static const int resident =
      resident_ctas(reinterpret_cast<const void*>(kernel));
  long long max_y = resident / tiles;
  if (max_y < 1) max_y = 1;
  const long long walks = (groups + max_y - 1) / max_y;
  const long long gy = (groups + walks - 1) / walks;
  kernel<<<dim3(tiles, (unsigned)gy), kThreads, 0, stream>>>(x, bias, mask,
                                                             out, R, H, scale);
  return cudaGetLastError();
}

template <typename T, typename TB, bool kMask, bool kApprox>
cudaError_t launch(const void* xp, const void* bp, const unsigned char* mask,
                   void* op, long long R, int H, float scale,
                   cudaStream_t stream) {
  const T* x = static_cast<const T*>(xp);
  const TB* bias = static_cast<const TB*>(bp);
  T* out = static_cast<T*>(op);
  constexpr int V = 16 / sizeof(T);
  const bool vec = H % V == 0 &&
                   (reinterpret_cast<size_t>(x) % 16) == 0 &&
                   (reinterpret_cast<size_t>(out) % 16) == 0 &&
                   (!kMask || (reinterpret_cast<size_t>(mask) % V) == 0);
  if (vec)
    return launch_v<T, TB, V, kMask, kApprox>(x, bias, mask, out, R, H,
                                              scale, stream);
  return launch_v<T, TB, 1, kMask, kApprox>(x, bias, mask, out, R, H, scale,
                                            stream);
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

template <typename T>
cudaError_t dispatch_bias(int bias_dtype, const void* x, const void* bias,
                          const unsigned char* mask, void* out, long long R,
                          int H, float scale, int approximate,
                          cudaStream_t s) {
  if (bias_dtype == 0)
    return dispatch<T, float>(x, bias, mask, out, R, H, scale, approximate, s);
  if (bias_dtype == 1)
    return dispatch<T, __nv_bfloat16>(x, bias, mask, out, R, H, scale,
                                      approximate, s);
  return dispatch<T, __half>(x, bias, mask, out, R, H, scale, approximate, s);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  x_dtype and
// bias_dtype: 0 = float32, 1 = bfloat16, 2 = float16 (out has x's
// dtype).  mask may be null (no dropout); every other pointer is a
// device pointer; stream is a cudaStream_t.
extern "C" int pt_fused_bias_gelu(int x_dtype, int bias_dtype, const void* x,
                                  const void* bias, const unsigned char* mask,
                                  void* out, long long R, int H, float scale,
                                  int approximate, void* stream) {
  if (H < 1 || R < 0 || x_dtype < 0 || x_dtype > 2 || bias_dtype < 0 ||
      bias_dtype > 2)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return (int)dispatch_bias<float>(bias_dtype, x, bias, mask, out, R, H,
                                     scale, approximate, s);
  if (x_dtype == 1)
    return (int)dispatch_bias<__nv_bfloat16>(bias_dtype, x, bias, mask, out,
                                             R, H, scale, approximate, s);
  return (int)dispatch_bias<__half>(bias_dtype, x, bias, mask, out, R, H,
                                    scale, approximate, s);
}
