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
//
// The group form (the data-parallel step's): one launch updates up to
// kGroupMax parameters of one kind, block size and wire.  On the TPU the
// JAX package's 206 Pallas calls a replica ran inside one XLA executable;
// here each launch costs about 6 us, the whole update of a bias, and
// some 127 of BERT-base's 206 parameters are biases and LayerNorm
// vectors.  A table of segments (each member's pointers, block offset,
// numel and chunk prefix) travels as a __grid_constant__ kernel
// parameter: no copy to the device and nothing to keep alive after the
// launch, so a CUDA graph could capture it.  CTAs take fixed chunks of
// kChunk elements and find their segment by a binary search of the
// prefix; the arithmetic is the per-parameter form's (update4), so the
// two agree bit for bit.  On an H100 (700 W; chip_smoke.py phase 3) the
// dp step's 824 members (206 parameters x 4 replicas) take 3 launches
// and 4.23 ms of device time against 6.31 ms as 824 single launches and
// a 3.42 ms byte bound; the word embedding alone reads 0.224 ms in the
// group form against 0.221 ms in its own launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Kind { kSgd = 0, kMomentum = 1, kAdam = 2, kAdamW = 3 };

// One parameter: its state, its blocks in the kept wire image, and the
// learning rate and beta powers it reads.
struct Member {
  float* p;
  float* m1;
  float* m2;
  const int8_t* hi;
  const int8_t* lo;
  const float* sc;
  const float* lr;
  const float* b1p;
  const float* b2p;
  long long off_blocks;  // the member's first block in the image
  long long numel;
};

// The per-parameter form's launch.
struct Args {
  Member m;
  int bs;
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
__device__ __forceinline__ Step load_step(const Member& m) {
  Step s;
  s.lr = *m.lr;
  s.lr_t = 0.f;
  if (K == kAdam || K == kAdamW) {
    const float b1p = *m.b1p, b2p = *m.b2p;
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
                                        const float* c) {
  if (K == kSgd) return __fsub_rn(p, __fmul_rn(st.lr, g));
  if (K == kMomentum) {
    const float mu = c[0];
    const float v = __fadd_rn(__fmul_rn(mu, m1), g);
    m1 = v;
    if (c[1] != 0.f)
      return __fsub_rn(p, __fmul_rn(__fadd_rn(g, __fmul_rn(mu, v)), st.lr));
    return __fsub_rn(p, __fmul_rn(st.lr, v));
  }
  const float m1n = __fadd_rn(__fmul_rn(c[0], m1), __fmul_rn(c[1], g));
  const float m2n =
      __fadd_rn(__fmul_rn(c[2], m2), __fmul_rn(c[3], __fmul_rn(g, g)));
  m1 = m1n;
  m2 = m2n;
  float pn = __fsub_rn(
      p, __fdiv_rn(__fmul_rn(st.lr_t, m1n), __fadd_rn(__fsqrt_rn(m2n), c[4])));
  if (K == kAdamW) pn = __fsub_rn(pn, __fmul_rn(__fmul_rn(st.lr, c[5]), p));
  return pn;
}

// Elements i0 .. i0 + 3 of member m (those below numel), in place.  With
// vec (block_size % 4 == 0 and every pointer aligned) a whole group of
// four shares one block and one scale and moves as one float4 of p, m1
// and m2 and one char4 of hi and lo.
template <int K, bool kDual>
__device__ __forceinline__ void update4(const Member& m, int bs,
                                        const Step& st, const float* c,
                                        long long i0, bool vec) {
  const long long base = m.off_blocks * bs;  // the member's first code
  if (vec && i0 + 3 < m.numel) {
    const float s = m.sc[m.off_blocks + i0 / bs];
    const char4 h = *reinterpret_cast<const char4*>(m.hi + base + i0);
    char4 l = make_char4(0, 0, 0, 0);
    if (kDual) l = *reinterpret_cast<const char4*>(m.lo + base + i0);
    const float g[4] = {dequant<kDual>(h.x, l.x, s), dequant<kDual>(h.y, l.y, s),
                        dequant<kDual>(h.z, l.z, s), dequant<kDual>(h.w, l.w, s)};
    float4 p = *reinterpret_cast<float4*>(m.p + i0);
    float4 m1 = make_float4(0.f, 0.f, 0.f, 0.f), m2 = m1;
    if (K != kSgd) m1 = *reinterpret_cast<float4*>(m.m1 + i0);
    if (K == kAdam || K == kAdamW) m2 = *reinterpret_cast<float4*>(m.m2 + i0);
    p.x = update<K>(p.x, g[0], m1.x, m2.x, st, c);
    p.y = update<K>(p.y, g[1], m1.y, m2.y, st, c);
    p.z = update<K>(p.z, g[2], m1.z, m2.z, st, c);
    p.w = update<K>(p.w, g[3], m1.w, m2.w, st, c);
    *reinterpret_cast<float4*>(m.p + i0) = p;
    if (K != kSgd) *reinterpret_cast<float4*>(m.m1 + i0) = m1;
    if (K == kAdam || K == kAdamW) *reinterpret_cast<float4*>(m.m2 + i0) = m2;
    return;
  }
  for (long long i = i0; i < i0 + 4 && i < m.numel; ++i) {
    const float s = m.sc[m.off_blocks + i / bs];
    const int8_t l = kDual ? m.lo[base + i] : (int8_t)0;
    const float g = dequant<kDual>(m.hi[base + i], l, s);
    float m1 = 0.f, m2 = 0.f;
    if (K != kSgd) m1 = m.m1[i];
    if (K == kAdam || K == kAdamW) m2 = m.m2[i];
    m.p[i] = update<K>(m.p[i], g, m1, m2, st, c);
    if (K != kSgd) m.m1[i] = m1;
    if (K == kAdam || K == kAdamW) m.m2[i] = m2;
  }
}

// Whether member m's groups of four may move as float4 / char4.
bool vec_ok(const Member& m, int bs) {
  return bs % 4 == 0 && (m.off_blocks * bs) % 4 == 0 &&
         (uintptr_t)m.p % 16 == 0 &&
         (m.m1 == nullptr || (uintptr_t)m.m1 % 16 == 0) &&
         (m.m2 == nullptr || (uintptr_t)m.m2 % 16 == 0) &&
         (uintptr_t)m.hi % 4 == 0 &&
         (m.lo == nullptr || (uintptr_t)m.lo % 4 == 0);
}

// fp32 form, one parameter: a thread owns groups of four consecutive
// elements
template <int K, bool kDual, bool kVec>
__global__ void fused_update_kernel(Args a) {
  const Step st = load_step<K>(a.m);
  const long long groups = (a.m.numel + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long gi = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       gi < groups; gi += stride)
    update4<K, kDual>(a.m, a.bs, st, a.c, gi * 4, kVec);
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
  const Step st = load_step<K>(a.m);
  const long long blk = blockIdx.x;
  const int j = threadIdx.x;
  const long long i = blk * a.bs + j;
  const bool live = j < a.bs && i < a.m.numel;
  float pn = 0.f;
  if (live) {
    const long long code = a.m.off_blocks * a.bs + i;
    const int8_t l = kDual ? a.m.lo[code] : (int8_t)0;
    const float g = dequant<kDual>(a.m.hi[code], l, a.m.sc[a.m.off_blocks + blk]);
    float m1 = 0.f, m2 = 0.f;
    if (K != kSgd) m1 = a.m.m1[i];
    if (K == kAdam || K == kAdamW) m2 = a.m.m2[i];
    pn = update<K>(a.m.p[i], g, m1, m2, st, a.c);
    if (K != kSgd) a.m.m1[i] = m1;
    if (K == kAdam || K == kAdamW) a.m.m2[i] = m2;
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

// ---------------------------------------------------------------------------
// The group form: one launch over many parameters
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // grid-stride beyond this
// A CTA takes kChunk elements of one segment at a time, one group of
// four a thread.
constexpr int kChunk = 4 * kThreads;
// Segments a launch: the table below must stay within the 32,764 bytes
// of kernel parameters that CUDA 12.1+ allows.
constexpr int kGroupMax = 320;

struct Seg {
  Member m;
  int chunk0;  // the segment's first chunk in the launch
  int vec;     // vec_ok(m, bs)
};

struct Group {
  int n;       // segments
  int chunks;  // chunks of all segments
  int bs;
  float c[6];
  Seg seg[kGroupMax];
};
static_assert(sizeof(Group) <= 32764, "the group table outgrows the kernel "
                                      "parameter space");

// A CTA walks the launch's chunks (grid-stride), finds each chunk's
// segment by a binary search of the chunk prefix (the table is a
// __grid_constant__ parameter: every thread of the CTA reads the same
// word, a constant-cache broadcast), and updates that chunk's elements
// with the per-parameter form's arithmetic.
template <int K, bool kDual>
__global__ void __launch_bounds__(kThreads)
fused_update_group_kernel(const __grid_constant__ Group g) {
  for (int chunk = blockIdx.x; chunk < g.chunks; chunk += gridDim.x) {
    int lo = 0, hi = g.n - 1;  // the last segment with chunk0 <= chunk
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (g.seg[mid].chunk0 <= chunk)
        lo = mid;
      else
        hi = mid - 1;
    }
    const Seg& s = g.seg[lo];
    const long long i0 =
        (long long)(chunk - s.chunk0) * kChunk + 4 * threadIdx.x;
    if (i0 < s.m.numel)
      update4<K, kDual>(s.m, g.bs, load_step<K>(s.m), g.c, i0, s.vec != 0);
  }
}

template <int K, bool kDual>
cudaError_t launch(const Args& a, bool requant, cudaStream_t stream) {
  if (requant) {
    const long long nb = (a.m.numel + a.bs - 1) / a.bs;
    const int threads = ((a.bs + 31) / 32) * 32;
    fused_update_requant_kernel<K, kDual><<<(unsigned)nb, threads, 0, stream>>>(a);
    return cudaGetLastError();
  }
  const long long groups = (a.m.numel + 3) / 4;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (vec_ok(a.m, a.bs))
    fused_update_kernel<K, kDual, true><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  else
    fused_update_kernel<K, kDual, false><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_kind(const Args& a, bool requant, cudaStream_t stream) {
  return a.m.lo != nullptr ? launch<K, true>(a, requant, stream)
                           : launch<K, false>(a, requant, stream);
}

template <int K>
cudaError_t launch_group(const Group& g, bool dual, cudaStream_t stream) {
  const unsigned blocks = (unsigned)(g.chunks < kMaxBlocks ? g.chunks
                                                           : kMaxBlocks);
  if (dual)
    fused_update_group_kernel<K, true><<<blocks, kThreads, 0, stream>>>(g);
  else
    fused_update_group_kernel<K, false><<<blocks, kThreads, 0, stream>>>(g);
  return cudaGetLastError();
}

Member member(void* p, void* m1, void* m2, const void* hi, const void* lo,
              const void* sc, const void* lr, const void* b1p,
              const void* b2p, long long off_blocks, long long numel) {
  Member m;
  m.p = static_cast<float*>(p);
  m.m1 = static_cast<float*>(m1);
  m.m2 = static_cast<float*>(m2);
  m.hi = static_cast<const int8_t*>(hi);
  m.lo = static_cast<const int8_t*>(lo);
  m.sc = static_cast<const float*>(sc);
  m.lr = static_cast<const float*>(lr);
  m.b1p = static_cast<const float*>(b1p);
  m.b2p = static_cast<const float*>(b2p);
  m.off_blocks = off_blocks;
  m.numel = numel;
  return m;
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
  a.m = member(p, m1, m2, hi, lo, sc, lr, b1p, b2p, off_blocks, numel);
  a.bs = bs;
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

// Segments one pt_fused_update_group call takes.
extern "C" int pt_fused_update_group_capacity() { return kGroupMax; }

// The fp32 form over n parameters of one kind, block size and wire (dual
// or single int8) in one launch.  rows is host memory, n rows of eleven
// int64: the device pointers p, m1, m2, hi, lo, scales, lr, b1p, b2p (0
// where the kind or the wire has none) and offset_blocks, numel.  It is
// copied into the launch's parameters, so the caller may free it on
// return.
extern "C" int pt_fused_update_group(int kind, int dual, int bs, int n,
                                     const long long* rows, float c0,
                                     float c1, float c2, float c3, float c4,
                                     float c5, void* stream) {
  if (bs < 1 || n < 1 || n > kGroupMax) return (int)cudaErrorInvalidValue;
  Group g;
  g.n = n;
  g.bs = bs;
  g.c[0] = c0; g.c[1] = c1; g.c[2] = c2; g.c[3] = c3; g.c[4] = c4; g.c[5] = c5;
  long long chunks = 0;
  for (int i = 0; i < n; ++i) {
    const long long* r = rows + 11 * (long long)i;
    auto ptr = [&](int k) { return reinterpret_cast<void*>(r[k]); };
    Seg& s = g.seg[i];
    s.m = member(ptr(0), ptr(1), ptr(2), ptr(3), ptr(4), ptr(5), ptr(6),
                 ptr(7), ptr(8), r[9], r[10]);
    if (s.m.numel < 1 || s.m.p == nullptr || s.m.hi == nullptr ||
        (dual != 0) != (s.m.lo != nullptr))
      return (int)cudaErrorInvalidValue;
    s.vec = vec_ok(s.m, bs);
    s.chunk0 = (int)chunks;
    chunks += (s.m.numel + kChunk - 1) / kChunk;
    if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  g.chunks = (int)chunks;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kSgd: return (int)launch_group<kSgd>(g, dual != 0, s);
    case kMomentum: return (int)launch_group<kMomentum>(g, dual != 0, s);
    case kAdam: return (int)launch_group<kAdam>(g, dual != 0, s);
    case kAdamW: return (int)launch_group<kAdamW>(g, dual != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
