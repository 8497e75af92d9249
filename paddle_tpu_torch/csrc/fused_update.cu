// K8: fused dequant -> optimizer update (-> requant), for Hopper (sm_90a).
//
// Replaces the Pallas kernel of paddle_tpu/kernels/fused_update.py: the
// body in `_pallas_fused` (:305, kernel :322), launched by `_pallas_call`
// (:272-298).  For one parameter of `numel` fp32 elements:
//   g   = hi * s + lo * (s / 254), s the scale of element i's block
//         offset_blocks + i / block_size of the kept bucket image
//         (lo absent for a single-int8 wire);
//   sgd:       p -= lr * g
//   momentum:  v = mu * v + g;  p -= lr * v, or (Nesterov)
//              p -= (g + mu * v) * lr
//   adam:      m1 = b1 * m1 + (1 - b1) * g;  m2 = b2 * m2 + (1 - b2) * g*g;
//              lr_t = lr * sqrt(1 - b2p) / (1 - b1p), b1p and b2p the
//              beta powers;
//              p -= lr_t * m1 / (sqrt(m2) + eps)
//   adamw:     adam, then p -= (lr * coeff) * p_before
// and writes p, m1, m2 back in place (fp32 form), or (requant form) the
// new p as dual int8 with one scale a block of block_size:
//   scale = max(amax / 127, 1e-30), hi = clip(rint(p / scale), +-127),
//   lo = clip(rint((p - hi * scale) * (254 / scale)), +-127),
// elements past numel in the last block counting as 0.  lr and the beta
// powers are read from device memory (no host sync); the caller advances
// the powers after the launch.
//
// Numerics: every operation is written in the plain version's order with
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn, so no fused
// multiply-add or approximate division changes a rounding the plain
// PyTorch version (kernels/fused_update.py) makes: the two agree bit for
// bit.  rintf rounds half to even, like torch.round and jnp.round.
//
// What bounds it on this card: one pass, bytes-bound far below the ridge.
// Adam reads p, m1, m2 (12 B) and hi, lo (2 B) and writes p, m1, m2
// (12 B): 26 B an element, plus 4 B of scale a block.  Design: a thread
// owns four consecutive elements of one parameter (one block, as long as
// block_size % 4 == 0), loaded as one float4 each for p, m1, m2 and one
// char4 each for hi and lo when the pointers allow, in a grid-stride loop
// over the parameter; the kept image is read in place at the member's
// block offset (no slice, no padding to a tile, no [rows, block] copy:
// those were Mosaic tiling rules).  The requant form needs each block's
// amax, so there one CTA owns one quantization block (block_size <= 1024
// threads) and reduces |p| with warp shuffles and shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Kind { kSgd = 0, kMomentum = 1, kAdam = 2, kAdamW = 3 };

struct Args {
  long long numel;
  int bs;
  long long off_blocks;
  float* p;
  float* m1;
  float* m2;
  const int8_t* hi;
  const int8_t* lo;
  const float* sc;
  const float* lr;
  const float* b1p;
  const float* b2p;
  // adam/adamw: beta1, 1 - beta1, beta2, 1 - beta2, epsilon, coeff;
  // momentum: mu, use_nesterov (0 or 1)
  float c[6];
  int8_t* q_hi;
  int8_t* q_lo;
  float* q_sc;
};

struct Step {
  float lr;    // the raw learning rate
  float lr_t;  // adam's bias-corrected step
};

template <int K>
__device__ __forceinline__ Step load_step(const Args& a) {
  Step s;
  s.lr = *a.lr;
  s.lr_t = 0.f;
  if (K == kAdam || K == kAdamW) {
    const float b1p = *a.b1p, b2p = *a.b2p;
    s.lr_t = __fdiv_rn(__fmul_rn(s.lr, __fsqrt_rn(__fsub_rn(1.f, b2p))),
                       __fsub_rn(1.f, b1p));
  }
  return s;
}

template <bool kDual>
__device__ __forceinline__ float dequant(int8_t h, int8_t l, float s) {
  float g = __fmul_rn((float)h, s);
  if (kDual) g = __fadd_rn(g, __fmul_rn((float)l, __fdiv_rn(s, 254.f)));
  return g;
}

// the update of one element: returns the new p; m1/m2 updated in place
template <int K>
__device__ __forceinline__ float update(float p, float g, float& m1,
                                        float& m2, const Step& st,
                                        const Args& a) {
  if (K == kSgd) return __fsub_rn(p, __fmul_rn(st.lr, g));
  if (K == kMomentum) {
    const float mu = a.c[0];
    const float v = __fadd_rn(__fmul_rn(mu, m1), g);
    m1 = v;
    if (a.c[1] != 0.f)
      return __fsub_rn(p, __fmul_rn(__fadd_rn(g, __fmul_rn(mu, v)), st.lr));
    return __fsub_rn(p, __fmul_rn(st.lr, v));
  }
  const float m1n = __fadd_rn(__fmul_rn(a.c[0], m1), __fmul_rn(a.c[1], g));
  const float m2n =
      __fadd_rn(__fmul_rn(a.c[2], m2), __fmul_rn(a.c[3], __fmul_rn(g, g)));
  m1 = m1n;
  m2 = m2n;
  float pn = __fsub_rn(
      p, __fdiv_rn(__fmul_rn(st.lr_t, m1n), __fadd_rn(__fsqrt_rn(m2n), a.c[4])));
  if (K == kAdamW) pn = __fsub_rn(pn, __fmul_rn(__fmul_rn(st.lr, a.c[5]), p));
  return pn;
}

template <int K>
__device__ __forceinline__ void one(const Args& a, const Step& st,
                                    long long i, float g) {
  float m1 = 0.f, m2 = 0.f;
  if (K != kSgd) m1 = a.m1[i];
  if (K == kAdam || K == kAdamW) m2 = a.m2[i];
  a.p[i] = update<K>(a.p[i], g, m1, m2, st, a);
  if (K != kSgd) a.m1[i] = m1;
  if (K == kAdam || K == kAdamW) a.m2[i] = m2;
}

// fp32 form: a thread owns groups of four consecutive elements
template <int K, bool kDual, bool kVec>
__global__ void fused_update_kernel(Args a) {
  const Step st = load_step<K>(a);
  const long long groups = (a.numel + 3) / 4;
  const long long base = a.off_blocks * a.bs;  // the member's first code
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long gi = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       gi < groups; gi += stride) {
    const long long i0 = gi * 4;
    if (kVec && i0 + 3 < a.numel) {
      // block_size % 4 == 0: the four share one block and one scale
      const float s = a.sc[a.off_blocks + i0 / a.bs];
      const char4 h = *reinterpret_cast<const char4*>(a.hi + base + i0);
      char4 l = make_char4(0, 0, 0, 0);
      if (kDual) l = *reinterpret_cast<const char4*>(a.lo + base + i0);
      const float g[4] = {dequant<kDual>(h.x, l.x, s), dequant<kDual>(h.y, l.y, s),
                          dequant<kDual>(h.z, l.z, s), dequant<kDual>(h.w, l.w, s)};
      float4 p = *reinterpret_cast<float4*>(a.p + i0);
      float4 m1 = make_float4(0.f, 0.f, 0.f, 0.f), m2 = m1;
      if (K != kSgd) m1 = *reinterpret_cast<float4*>(a.m1 + i0);
      if (K == kAdam || K == kAdamW) m2 = *reinterpret_cast<float4*>(a.m2 + i0);
      p.x = update<K>(p.x, g[0], m1.x, m2.x, st, a);
      p.y = update<K>(p.y, g[1], m1.y, m2.y, st, a);
      p.z = update<K>(p.z, g[2], m1.z, m2.z, st, a);
      p.w = update<K>(p.w, g[3], m1.w, m2.w, st, a);
      *reinterpret_cast<float4*>(a.p + i0) = p;
      if (K != kSgd) *reinterpret_cast<float4*>(a.m1 + i0) = m1;
      if (K == kAdam || K == kAdamW) *reinterpret_cast<float4*>(a.m2 + i0) = m2;
      continue;
    }
    for (long long i = i0; i < i0 + 4 && i < a.numel; ++i) {
      const float s = a.sc[a.off_blocks + i / a.bs];
      const int8_t l = kDual ? a.lo[base + i] : (int8_t)0;
      one<K>(a, st, i, dequant<kDual>(a.hi[base + i], l, s));
    }
  }
}

__device__ __forceinline__ float nan_max(float x, float y) {
  if (isnan(x)) return x;
  if (isnan(y)) return y;
  return fmaxf(x, y);
}

__device__ __forceinline__ float clip127(float x) {
  return fminf(fmaxf(x, -127.f), 127.f);
}

// requant form: one CTA a quantization block, one thread an element
template <int K, bool kDual>
__global__ void fused_update_requant_kernel(Args a) {
  __shared__ float warp_max[32];
  __shared__ float block_max;
  const Step st = load_step<K>(a);
  const long long blk = blockIdx.x;
  const int j = threadIdx.x;
  const long long i = blk * a.bs + j;
  const bool live = j < a.bs && i < a.numel;
  float pn = 0.f;
  if (live) {
    const long long code = a.off_blocks * a.bs + i;
    const int8_t l = kDual ? a.lo[code] : (int8_t)0;
    const float g = dequant<kDual>(a.hi[code], l, a.sc[a.off_blocks + blk]);
    float m1 = 0.f, m2 = 0.f;
    if (K != kSgd) m1 = a.m1[i];
    if (K == kAdam || K == kAdamW) m2 = a.m2[i];
    pn = update<K>(a.p[i], g, m1, m2, st, a);
    if (K != kSgd) a.m1[i] = m1;
    if (K == kAdam || K == kAdamW) a.m2[i] = m2;
  }
  float v = fabsf(pn);
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((j & 31) == 0) warp_max[j >> 5] = v;
  __syncthreads();
  if (j < 32) {
    v = j < (int)((blockDim.x + 31) >> 5) ? warp_max[j] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (j == 0) block_max = v;
  }
  __syncthreads();
  float scale = __fdiv_rn(block_max, 127.f);
  if (!isnan(scale)) scale = fmaxf(scale, 1e-30f);  // a NaN block keeps NaN
  if (j < a.bs) {
    const float qh = clip127(rintf(__fdiv_rn(pn, scale)));
    const float resid = __fsub_rn(pn, __fmul_rn(qh, scale));
    const float ql = clip127(rintf(__fmul_rn(resid, __fdiv_rn(254.f, scale))));
    a.q_hi[i] = (int8_t)qh;
    a.q_lo[i] = (int8_t)ql;
  }
  if (j == 0) a.q_sc[blk] = scale;
}

template <int K, bool kDual>
cudaError_t launch(const Args& a, bool requant, cudaStream_t stream) {
  if (requant) {
    const long long nb = (a.numel + a.bs - 1) / a.bs;
    const int threads = ((a.bs + 31) / 32) * 32;
    fused_update_requant_kernel<K, kDual><<<(unsigned)nb, threads, 0, stream>>>(a);
    return cudaGetLastError();
  }
  const long long groups = (a.numel + 3) / 4;
  const int threads = 256;
  long long blocks = (groups + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  const long long base = a.off_blocks * a.bs;
  const bool vec = a.bs % 4 == 0 && base % 4 == 0 &&
                   (uintptr_t)a.p % 16 == 0 &&
                   (a.m1 == nullptr || (uintptr_t)a.m1 % 16 == 0) &&
                   (a.m2 == nullptr || (uintptr_t)a.m2 % 16 == 0) &&
                   (uintptr_t)a.hi % 4 == 0 &&
                   (a.lo == nullptr || (uintptr_t)a.lo % 4 == 0);
  if (vec)
    fused_update_kernel<K, kDual, true><<<(unsigned)blocks, threads, 0, stream>>>(a);
  else
    fused_update_kernel<K, kDual, false><<<(unsigned)blocks, threads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_kind(const Args& a, bool requant, cudaStream_t stream) {
  return a.lo != nullptr ? launch<K, true>(a, requant, stream)
                         : launch<K, false>(a, requant, stream);
}

}  // namespace

extern "C" int pt_fused_update(int kind, int requant, long long numel, int bs,
                               long long off_blocks, void* p, void* m1,
                               void* m2, const void* hi, const void* lo,
                               const void* sc, const void* lr, const void* b1p,
                               const void* b2p, float c0, float c1, float c2,
                               float c3, float c4, float c5, void* q_hi,
                               void* q_lo, void* q_sc, void* stream) {
  if (bs < 1 || bs > 1024 || numel < 1) return (int)cudaErrorInvalidValue;
  Args a;
  a.numel = numel;
  a.bs = bs;
  a.off_blocks = off_blocks;
  a.p = static_cast<float*>(p);
  a.m1 = static_cast<float*>(m1);
  a.m2 = static_cast<float*>(m2);
  a.hi = static_cast<const int8_t*>(hi);
  a.lo = static_cast<const int8_t*>(lo);
  a.sc = static_cast<const float*>(sc);
  a.lr = static_cast<const float*>(lr);
  a.b1p = static_cast<const float*>(b1p);
  a.b2p = static_cast<const float*>(b2p);
  a.c[0] = c0; a.c[1] = c1; a.c[2] = c2; a.c[3] = c3; a.c[4] = c4; a.c[5] = c5;
  a.q_hi = static_cast<int8_t*>(q_hi);
  a.q_lo = static_cast<int8_t*>(q_lo);
  a.q_sc = static_cast<float*>(q_sc);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rq = requant != 0;
  switch (kind) {
    case kSgd: return (int)launch_kind<kSgd>(a, rq, s);
    case kMomentum: return (int)launch_kind<kMomentum>(a, rq, s);
    case kAdam: return (int)launch_kind<kAdam>(a, rq, s);
    case kAdamW: return (int)launch_kind<kAdamW>(a, rq, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
