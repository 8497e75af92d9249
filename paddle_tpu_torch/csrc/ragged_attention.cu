// K6: ragged (variable-length) attention, forward only, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel paddle_tpu/kernels/primitives/ragged.py
// `_ragged_kernel` (:74), launched by `_pallas_ragged` (:126, the call
// at :152).  Contract, kept exactly:
//   q, k, v, o  [B, H, S, D] views with any (b, h, s) strides and a
//               contiguous D (the op's transpose2 views of [B, S, H, D]
//               activations are read in place; the wrapper copies
//               nothing), all float32 or all bfloat16; o has q's dtype.
//               A [BH, S, D] input is H = 1.  D <= 128.
//   lengths     i32, one per batch row: row bh reads lengths[bh / H]
// Row b attends key positions j < lengths[b] (and j <= i when causal);
// masked logits are -1e30 (the JAX constant); the products, m, l and acc
// are fp32 (a bf16 input is widened, as the JAX kernel casts to fp32);
// a row with l == 0 (length 0) writes zeros.  Rows at or past a row's
// length are computed under the same key mask, as the JAX kernel
// computes them.
//
// What bounds it on this card: at the serving path's shape (S = 128,
// D = 32, fp32, causal, lengths 20-126) the call moves 3.3 MB and does
// 48 MFLOP over its live (query, key) pairs: 0.98 µs of bytes, 0.7 µs at
// the fp32 rate without tensor cores.  The first version
// took 23 µs: one 256-thread CTA per (head, 64-query tile), each a
// serial chain of element-by-element staging (a division and a modulo
// an element, 64 columns at D = 32, bank-conflicting transposed stores),
// three barriers a key tile, products over all 64 keys of a tile and no
// load in flight while it computed.  So it is bound by latency: a few
// dependent round trips to memory and too little work in flight an SM.
//
// Design:
// - One CTA of 4 warps per (bh, 16 query rows), 4 rows a warp: the
//   serving path's shape gives 512 CTAs, 2048 warps, over the 132 SMs,
//   and a warp's chain of dependent work a key tile is short (4 rows).
//   A causal tile stops at its own last row.  (A first form with one
//   warp of 16 rows a CTA took as long as the old kernel: each warp's
//   serial chain over 16 rows was the latency.)
// - Key tiles of 32 rows, one key a lane.  K and V tiles are staged by
//   16-byte cp.async sized to D (not to the capacity) in their input
//   dtype, double-buffered: the next tile's copies are in flight while
//   this one computes.  Q is staged once, widened to fp32.  Row strides
//   of K (D + 16 bytes) and Q (D + 4 floats) make the 16-byte reads of a
//   quarter-warp hit distinct banks.
// - S = Q·Kᵀ: a lane sums its key against the warp's queries (Q read as
//   broadcasts); the softmax keeps m per row (one warp max a row a tile)
//   and l per lane (one warp sum a row at the end).  P goes through
//   shared memory, and P·V runs over the tile's live keys only: a lane
//   owns D/32 output columns.  Causal and length masks are applied only
//   in a tile that needs them.
// - Exact fp32 products on the SIMT units: the fp32 gate is 2e-5 and the
//   JAX package's own interpret test 1e-6, which single-pass TF32 would
//   not hold.  A 3xTF32 form (mma.sync m16n8k8, one warp of 16 rows a
//   CTA, the split operands in shared memory) held the gate but was
//   slower at the serving shape: a tile is a chain of dependent MMAs and
//   operand splits in one warp, longer than four warps' SIMT chains.
//   What bounds the kernel now is that chain a key tile (its loads, the
//   warp max, the exp) times the tiles of a causal row's last query
//   tile, not bytes or flops.
// - Capacity: D up to 128 (templated at 32, 64 and 128 columns).  Where
//   a pointer, a stride or D is not a multiple of 16 bytes the tiles are
//   staged element by element instead, with the same arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>
#include <initializer_list>

namespace {

constexpr int kQ = 16;     // query rows a CTA
constexpr int kWarps = 4;  // warps a CTA
constexpr int kR = kQ / kWarps;  // query rows a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kK = 32;     // keys a tile: one a lane
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even
}

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

// N values of T from (shared or global) memory, widened to fp32
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* p, float (&f)[N]) {
  using B = typename Bits<N * sizeof(T)>::type;
  const B raw = *reinterpret_cast<const B*>(p);
  T v[N];
  memcpy(v, &raw, sizeof(v));
#pragma unroll
  for (int e = 0; e < N; ++e) f[e] = to_f(v[e]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// shared memory of one CTA for element type T and column capacity kD
template <typename T, int kD>
struct Layout {
  static constexpr int kLdQ = kD + 4;                 // floats
  static constexpr int kLdK = kD + 16 / sizeof(T);    // elements of T
  static constexpr size_t kQBytes = kQ * kLdQ * 4;
  static constexpr size_t kKBytes = kK * kLdK * sizeof(T);
  static constexpr size_t kVBytes = kK * kD * sizeof(T);
  static constexpr size_t kPBytes = kQ * kK * 4;
  static constexpr size_t kBytes = kQBytes + 2 * kKBytes + 2 * kVBytes +
                                   kPBytes;
};

// Stage keys [k0, k0 + n) of one head's K and V into a buffer: by
// 16-byte cp.async (vec: D is a whole number of chunks, and nothing past
// it is read), else element by element with zeros past D up to kD (the
// score product reads the last chunk whole).  Rows past n are left as
// they are (never read as live).
template <typename T, int kD>
__device__ __forceinline__ void stage_kv(T* ks, T* vs, const T* kh,
                                         const T* vh, long long kss,
                                         long long vss, int k0, int n, int D,
                                         bool vec) {
  using L = Layout<T, kD>;
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kW = 16 / sizeof(T);  // elements a chunk
    constexpr int kChunks = kD / kW;    // chunks a row at capacity
    const int chunks = D / kW;
    for (int idx = tid; idx < n * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = idx % kChunks;
      if (c >= chunks) continue;
      cp_async16(ks + r * L::kLdK + c * kW, kh + (k0 + r) * kss + c * kW);
      cp_async16(vs + r * kD + c * kW, vh + (k0 + r) * vss + c * kW);
    }
  } else {
    for (int idx = tid; idx < n * kD; idx += kThreads) {
      const int r = idx / kD, d = idx % kD;
      const bool in = d < D;
      ks[r * L::kLdK + d] = in ? kh[(k0 + r) * kss + d] : T(0.f);
      vs[r * kD + d] = in ? vh[(k0 + r) * vss + d] : T(0.f);
    }
  }
}

// Grid (B*H, query tiles).  The CTA holds queries q0 .. q0 + 15 of row
// bh and stages their key tiles; warp w holds queries qw = q0 + 4w ..
// qw + 3, lane j of a key tile key k0 + j's score against each, and
// output columns lane*kC .. lane*kC + kC - 1.
template <typename T, int kD, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    ragged_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const int* __restrict__ lengths, T* __restrict__ o,
                      int H, int S, int D, Strides sq, Strides sk, Strides sv,
                      Strides so, float scale, int vec) {
  using L = Layout<T, kD>;
  constexpr int kC = kD / 32;        // output columns a lane
  constexpr int kW = 16 / sizeof(T); // elements of a 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  // Q, then K buffers 0 and 1, V buffers 0 and 1, then P
  float* Qs = reinterpret_cast<float*>(smem);
  unsigned char* kbuf = smem + L::kQBytes;
  unsigned char* vbuf = kbuf + 2 * L::kKBytes;
  float* Ps = reinterpret_cast<float*>(vbuf + 2 * L::kVBytes);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int bh = blockIdx.x, b = bh / H, hh = bh % H;
  // the heaviest (last) query tiles of a causal row start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kQ;
  const int qw = q0 + warp * kR;  // this warp's first query
  float* Pw = Ps + warp * kR * kK;  // this warp's rows of P
  const T* kh = k + b * sk.b + hh * sk.h;
  const T* vh = v + b * sv.b + hh * sv.h;
  const int n_keys = min(S, max(lengths[b], 0));
  const int kv_end = kCausal ? min(n_keys, q0 + kQ) : n_keys;
  const int n_tiles = (kv_end + kK - 1) / kK;

  if (n_tiles > 0) {
    stage_kv<T, kD>(reinterpret_cast<T*>(kbuf), reinterpret_cast<T*>(vbuf),
                    kh, vh, sk.s, sv.s, 0, min(kK, kv_end), D, vec);
    cp_async_commit();
  }
  {  // Q, widened to fp32; rows past S and columns past D are zeros
    const T* qh = q + b * sq.b + hh * sq.h;
    for (int idx = threadIdx.x; idx < kQ * kD; idx += kThreads) {
      const int r = idx / kD, d = idx % kD;
      Qs[r * L::kLdQ + d] =
          (q0 + r < S && d < D) ? to_f(qh[(q0 + r) * sq.s + d]) : 0.f;
    }
  }
  const float qk_scale = scale * kLog2e;  // scores in log2 units
  const float* Qw = Qs + warp * kR * L::kLdQ;  // this warp's rows of Q
  float m[kR], l[kR], acc[kR][kC];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[r][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kK;
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      stage_kv<T, kD>(reinterpret_cast<T*>(kbuf + (buf ^ 1) * L::kKBytes),
                      reinterpret_cast<T*>(vbuf + (buf ^ 1) * L::kVBytes), kh,
                      vh, sk.s, sv.s, k0 + kK, min(kK, kv_end - k0 - kK), D,
                      vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of this tile (and Q) landed
    const T* kt = reinterpret_cast<const T*>(kbuf + buf * L::kKBytes);
    const T* vt = reinterpret_cast<const T*>(vbuf + buf * L::kVBytes);

    // s[r] = q_r · k_lane over the columns of D, in chunks of 16 bytes
    float s[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int d0 = 0; d0 < D; d0 += kW) {
      float kf[kW];
      load_f<T, kW>(kt + lane * L::kLdK + d0, kf);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
#pragma unroll
        for (int e = 0; e < kW; e += 4) {
          const float4 qv =
              *reinterpret_cast<const float4*>(Qw + r * L::kLdQ + d0 + e);
          s[r] = fmaf(qv.x, kf[e], s[r]);
          s[r] = fmaf(qv.y, kf[e + 1], s[r]);
          s[r] = fmaf(qv.z, kf[e + 2], s[r]);
          s[r] = fmaf(qv.w, kf[e + 3], s[r]);
        }
      }
    }

    // online softmax; masks only where the tile needs them
    const int j = k0 + lane;
    const bool full = k0 + kK <= n_keys && (!kCausal || k0 + kK - 1 <= qw);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const bool live = full || (j < n_keys && (!kCausal || j <= qw + r));
      const float sr = live ? s[r] * qk_scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float alpha = exp2f(m[r] - m_new);
      // a masked key adds nothing, even while m_new is still -1e30
      const float p = live ? exp2f(sr - m_new) : 0.f;
      l[r] = l[r] * alpha + p;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[r][c] *= alpha;
      Pw[r * kK + lane] = p;
    }
    __syncwarp();  // the warp's P rows are written

    // acc[r][:] += Σ_j P[r][j] · V[j][lane columns] over the live keys
    const int live_keys = min(kK, kv_end - k0);
#pragma unroll 2
    for (int j0 = 0; j0 < live_keys; j0 += 4) {
      float vf[4][kC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        load_f<T, kC>(vt + (j0 + jj) * kD + lane * kC, vf[jj]);
#pragma unroll
        for (int c = 0; c < kC; ++c)  // keys past the staged rows: 0
          vf[jj][c] = j0 + jj < live_keys ? vf[jj][c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(Pw + r * kK + j0);
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          acc[r][c] = fmaf(p.x, vf[0][c], acc[r][c]);
          acc[r][c] = fmaf(p.y, vf[1][c], acc[r][c]);
          acc[r][c] = fmaf(p.z, vf[2][c], acc[r][c]);
          acc[r][c] = fmaf(p.w, vf[3][c], acc[r][c]);
        }
      }
    }
    __syncthreads();  // this buffer and P are rewritten next
  }

  T* oh = o + b * so.b + hh * so.h;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const float lt = warp_sum(l[r]);
    const float l_safe = lt == 0.f ? 1.f : lt;  // length 0: acc is 0
    const int i = qw + r;
    if (i >= S) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int d = lane * kC + c;
      if (d < D) from_f(oh + i * so.s + d, acc[r][c] / l_safe);
    }
  }
}

template <typename T, int kD, bool kCausal>
cudaError_t launch(const T* q, const T* k, const T* v, const int* lengths,
                   T* o, int B, int H, int S, int D, const long long* st,
                   float scale, int vec, cudaStream_t s) {
  auto kernel = ragged_fwd_kernel<T, kD, kCausal>;
  constexpr size_t kSmem = Layout<T, kD>::kBytes;
  // above 48 KB a kernel must opt in to dynamic shared memory
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const dim3 grid(B * H, (S + kQ - 1) / kQ);
  kernel<<<grid, kThreads, kSmem, s>>>(
      q, k, v, lengths, o, H, S, D, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]}, scale, vec);
  return cudaGetLastError();
}

template <typename T, bool kCausal>
cudaError_t by_dim(const void* q, const void* k, const void* v,
                   const int* lengths, void* o, int B, int H, int S, int D,
                   const long long* st, float scale, cudaStream_t s) {
  // 16-byte staging: every base and (b, h, s) stride of q, k and v, and
  // D, a multiple of 16 bytes
  bool vec = (D * sizeof(T)) % 16 == 0;
  for (const void* p : {q, k, v})
    vec = vec && reinterpret_cast<size_t>(p) % 16 == 0;
  for (int i = 0; i < 9; ++i) vec = vec && (st[i] * sizeof(T)) % 16 == 0;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  if (D <= 32)
    return launch<T, 32, kCausal>(qt, kt, vt, lengths, ot, B, H, S, D, st,
                                  scale, vec, s);
  if (D <= 64)
    return launch<T, 64, kCausal>(qt, kt, vt, lengths, ot, B, H, S, D, st,
                                  scale, vec, s);
  return launch<T, 128, kCausal>(qt, kt, vt, lengths, ot, B, H, S, D, st,
                                 scale, vec, s);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* lengths, void* o, int B, int H, int S, int D,
                     const long long* st, float scale, int causal,
                     cudaStream_t s) {
  return causal ? by_dim<T, true>(q, k, v, lengths, o, B, H, S, D, st, scale,
                                  s)
                : by_dim<T, false>(q, k, v, lengths, o, B, H, S, D, st, scale,
                                   s);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  dtype: 0 =
// float32, 1 = bfloat16, for q, k, v and o alike.  Every pointer is a
// device pointer; strides are element strides (b, h, s) of q, k, v and
// o in that order; lengths holds B int32; stream is a cudaStream_t.
extern "C" int pt_ragged_attention_f32(
    int dtype, const void* q, const void* k, const void* v,
    const int* lengths, void* o, int B, int H, int S, int D, long long qb,
    long long qh, long long qs, long long kb, long long kh, long long ks,
    long long vb, long long vh, long long vs, long long ob, long long oh,
    long long os, float scale, int causal, void* stream) {
  if (B < 1 || H < 1 || S < 1 || D < 1 || D > 128 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const long long st[12] = {qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0
                   ? dispatch<float>(q, k, v, lengths, o, B, H, S, D, st,
                                     scale, causal, s)
                   : dispatch<__nv_bfloat16>(q, k, v, lengths, o, B, H, S, D,
                                             st, scale, causal, s));
}
