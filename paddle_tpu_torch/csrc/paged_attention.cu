// K5 and K7: paged attention over an fp32 KV pool (K5) and over a
// dual-int8 KV pool (K7), for Hopper (sm_90a).
//
// K5 replaces the Pallas kernel paddle_tpu/kernels/primitives/paged.py
// `_paged_kernel` (:121), launched by `_pallas_paged` (:197).  K7
// replaces `_paged_quant_kernel` (:241), launched by
// `_pallas_paged_quant` (:298, the call at :315).  Contract, kept exactly:
//   q          [B, n, T, d]  f32, contiguous
//   K5 pool    k/v pages [P, page, n, d] f32, contiguous
//   K7 pool    k/v hi, lo [P, page, n, d] int8 and k/v scale
//              [P, page, n, 1] f32, contiguous: a pool element is
//              (hi + lo / 254) * scale, dequantised in registers, so fp32
//              K/V never exist in device memory
//   page_table [B, max_pages] i32: physical page of each logical page
//   q_start    [B] i32: tokens already in the pool before this q block
//   out        [B, n, T, d]  f32
//   part       [B, n, T, splits, d + 2] f32 scratch of the split form
//              (below), allocated by the wrapper; null for one split
//   arrivals   [>= B * n * T] i32 arrival counters of the split form,
//              zero between calls (the kernel resets what it counts);
//              null for one split
// Query i of row b attends global key positions j <= q_start[b] + i.
// Masked scores are -1e9 (the JAX kernel's constant); the softmax is
// online, in fp32; a row whose softmax sum l is 0 returns 0.  Page 0 is
// the allocator's trash page: no row's mask ever exposes it.
//
// What bounds it on this card: at T = 1 (a decode step) the work is a
// matrix-vector product per (row, head) — about 4 flops per 8 bytes of
// fp32 K/V read (per 4.25 bytes of int8 K/V) — so it is bound by the
// bytes of the live pages, far below the ridge point; no tensor cores
// are needed.  At T = 32 (a prefill chunk) each staged page is reused by
// the block's queries.  K7 reads 2 bytes + 4/d of scale per element
// instead of 4, so its bound is about half of K5's.  At the decode
// lane's step (8 rows, 12 heads, d 64, page 16, rows up to 1,024 keys)
// K5's bound is 20.6 MB, 0.0062 ms at 3.35 TB/s.
//
// Design.  The TPU grid walks (b, h, every logical page) in order and
// carries the softmax state in VMEM scratch, skipping dead pages with
// pl.when.  Blocks here run in parallel and in no order, so:
//   - one block takes one (row b, head h) pair and a tile of QT queries;
//     it reads q_start[b] and its page-table row itself (there is no
//     scalar prefetch);
//   - its eight warps split the row's live logical pages (warp w takes
//     pages w, w+8, ...): only pages up to (q_start+last query)/page are
//     visited, never max_pages;
//   - each warp stages its physical page's K and V slice for head h in
//     its own shared memory as fp32 with coalesced row loads (rows of the
//     pool are n*d elements apart), rows padded to d+1 floats so the
//     per-key dot products read without bank conflicts.  K5 loads float4
//     (16 bytes); K7 loads 16 int8 of hi and of lo at a time and the
//     row's scale, and dequantises while it stores.  All loads of a page
//     are issued before any is stored, so a page costs one memory round
//     trip; a page that fits one chunk is prefetched into registers
//     while the warp's previous page scores;
//   - each warp keeps an online softmax (m, l, acc) per query in
//     registers, one lane per key for the scores (two lanes per key, each
//     summing half the columns, when a page holds <= 16 keys) and one
//     lane per output column for the weighted sum of V;
//   - the eight warps' partial states merge in shared memory at the end.
//
// Split form (flash-decoding), K5's and K7's alike.  With one CTA a
// (row, head), the decode step's grid is 96 CTAs on 132 SMs, and the two
// longest rows' 24 CTAs each chain eight pages a warp (load, stage,
// score, merge) while the short rows' CTAs finish at once: K5 read 0.058
// ms against its 0.0062 ms bound on the card, K7 0.035 against 0.0032.
// So the wrapper splits each row's logical pages into chunks of
// `pages_per_split` (one page a warp at a page of 16 keys) and the grid
// takes one CTA per (query tile, head, split, row), blockIdx.z = split *
// B + b: the split is the grid's slowest index, so every row's first
// split is dispatched before any later one, and the CTAs of splits past
// a row's end pass through the slots the live CTAs leave free.  The plan
// comes from shapes alone (max_pages, page size, kWarps, which the
// library exports), never from q_start or the page table: no host sync,
// and the same launch every step.  Each CTA counts its tile's live splits
// from q_start itself:
//   - a CTA past its row's last live page returns at once, writing
//     nothing;
//   - where only the first split is live (every short row: a prefill
//     chunk from q_start 0, a decode row under 129 keys) that CTA is
//     the one-split form and writes `out` directly;
//   - otherwise each live CTA writes its warps' merged (m, l, acc[d]) of
//     each query to `part`, fences, and takes a ticket from its tile's
//     arrival counter; the last to arrive resets the counter to 0 and
//     merges the tile's partials by log-sum-exp (a partial whose keys
//     are all masked for a query has m = -1e9 and weighs 0 beside the
//     first split's real scores).
// The merge is in the last-arriving CTA, not a second kernel: a second
// launch and the empty CTAs' writes cost about 5 us a call where only
// the first split is live, which is every prefill chunk from q_start 0
// and every decode row under 129 keys.  The counters are the wrapper's,
// one set a (device, stream), so two streams never share one.  One
// split (max_pages <= pages_per_split) is the form above.  The two pools
// share every line of the split form but the staging: K7's split form
// stages a page when its warp reaches it, two 16-byte vectors of hi and
// of lo (for K and V) a lane; with the one-split form's register double
// buffer and four it spilled 52-308 bytes under the two-CTA register
// cap.  K5 on an H100 (700 W; chip_smoke.py, against the one-split form
// in turns): the timed decode case 0.058 -> 0.026 ms, a prefill chunk at
// q_start 992 0.084 -> 0.050 ms, one at q_start 0 0.0133 -> 0.0153 ms
// (the empty CTAs still cost 2 us there); summed over a whole run of the
// decode lane (16 requests of 8-512 prompt tokens + 32 new), 59.0 ->
// 42.7 ms.  K7, the same comparison: decode 0.035 -> 0.026 ms, prefill
// at q_start 992 0.066 -> 0.048 ms, at q_start 0 0.0125 -> 0.0128 ms;
// a whole int8-lane run 45.0 -> 37.7 ms.

#include <cuda_runtime.h>
#include "launch_count.cuh"
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;
constexpr float kMaskValue = -1e9f;  // the JAX kernel's NEG_INF
constexpr float kInvResid = 1.0f / 254.0f;  // the codec's 1 / RESID_DIV

// The pool one launch reads: fp32 k/v (K5) or int8 hi/lo + fp32 scale
// (K7); the other set is null.
struct Pool {
  const float* k;
  const float* v;
  const signed char* khi;
  const signed char* klo;
  const float* ksc;
  const signed char* vhi;
  const signed char* vlo;
  const float* vsc;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int kChunk = 8;  // float4 loads in flight per lane, for K and V
constexpr int kChunkQ = 4;  // 16-byte int8 loads per lane, per hi/lo/K/V
// ... in K7's split form, held to 128 registers a thread: a page of 16
// keys at d 64 (64 vectors) still stages in one chunk
constexpr int kChunkQSplit = 2;

// First pool row of logical page lp of a row's page table.
__device__ __forceinline__ long long page_row0(const int* table, int lp,
                                               int page_size,
                                               int num_pages) {
  const int phys = min(max(table[lp], 0), num_pages - 1);  // gather: clamp
  return (long long)phys * page_size;
}

// ---------------------------------------------------------------------------
// K5 staging: fp32 pages, float4 at a time
// ---------------------------------------------------------------------------

// Load float4 number base + u*32 + lane (u < kChunk) of a page's K and V
// slice for head h: element e is row e / vrow, columns 4*(e % vrow)...
__device__ __forceinline__ void load_chunk(const float4* __restrict__ k4,
                                           const float4* __restrict__ v4,
                                           long long row0, int n, int h,
                                           int vrow, int nvec, int base,
                                           int lane, float4 (&kr)[kChunk],
                                           float4 (&vr)[kChunk]) {
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const int e = base + u * 32 + lane;
    if (e < nvec) {
      const int row = e / vrow, c4 = e - row * vrow;
      const long long g = ((row0 + row) * n + h) * vrow + c4;
      kr[u] = k4[g];
      vr[u] = v4[g];
    }
  }
}

__device__ __forceinline__ void store_chunk(float* sK, float* sV, int dp,
                                            int vrow, int nvec, int base,
                                            int lane,
                                            const float4 (&kr)[kChunk],
                                            const float4 (&vr)[kChunk]) {
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const int e = base + u * 32 + lane;
    if (e < nvec) {
      const int row = e / vrow, c = (e - row * vrow) * 4;
      float* k = sK + row * dp + c;
      float* v = sV + row * dp + c;
      k[0] = kr[u].x; k[1] = kr[u].y; k[2] = kr[u].z; k[3] = kr[u].w;
      v[0] = vr[u].x; v[1] = vr[u].y; v[2] = vr[u].z; v[3] = vr[u].w;
    }
  }
}

// ---------------------------------------------------------------------------
// K7 staging: int8 hi/lo pages, 16 codes at a time, plus the row's scale
// ---------------------------------------------------------------------------

template <int CQ>
struct QRegs {
  int4 khi[CQ], klo[CQ], vhi[CQ], vlo[CQ];
  float ksc[CQ], vsc[CQ];
};

// (hi + lo * (1/254)) * scale, rounded step by step as the plain version
// rounds it (no fused multiply-add)
__device__ __forceinline__ float dequant(int hi, int lo, float sc) {
  return __fmul_rn(__fadd_rn((float)hi, __fmul_rn((float)lo, kInvResid)),
                   sc);
}

// byte b (0..3) of a 32-bit word as a signed int8 value
__device__ __forceinline__ int sbyte(int w, int b) {
  return (int)((unsigned)w << (24 - 8 * b)) >> 24;
}

__device__ __forceinline__ void store16(float* dst, int4 hv, int4 lv,
                                        float sc) {
  const int hw[4] = {hv.x, hv.y, hv.z, hv.w};
  const int lw[4] = {lv.x, lv.y, lv.z, lv.w};
#pragma unroll
  for (int w = 0; w < 4; ++w)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      dst[4 * w + b] = dequant(sbyte(hw[w], b), sbyte(lw[w], b), sc);
}

// Load 16-byte vector number base + u*32 + lane (u < CQ) of a page's hi
// and lo codes for head h, K and V, with its row's scales: vector e is
// row e / vrow, columns 16*(e % vrow)...
template <int CQ>
__device__ __forceinline__ void load_chunk_q(const Pool& pool, long long row0,
                                             int n, int h, int vrow,
                                             int nvec, int base, int lane,
                                             QRegs<CQ>& r) {
  const int4* khi = reinterpret_cast<const int4*>(pool.khi);
  const int4* klo = reinterpret_cast<const int4*>(pool.klo);
  const int4* vhi = reinterpret_cast<const int4*>(pool.vhi);
  const int4* vlo = reinterpret_cast<const int4*>(pool.vlo);
#pragma unroll
  for (int u = 0; u < CQ; ++u) {
    const int e = base + u * 32 + lane;
    if (e < nvec) {
      const int row = e / vrow, c16 = e - row * vrow;
      const long long vec = (row0 + row) * n + h;  // this row's vector
      const long long g = vec * vrow + c16;
      r.khi[u] = khi[g];
      r.klo[u] = klo[g];
      r.vhi[u] = vhi[g];
      r.vlo[u] = vlo[g];
      r.ksc[u] = pool.ksc[vec];
      r.vsc[u] = pool.vsc[vec];
    }
  }
}

template <int CQ>
__device__ __forceinline__ void store_chunk_q(float* sK, float* sV, int dp,
                                              int vrow, int nvec, int base,
                                              int lane, const QRegs<CQ>& r) {
#pragma unroll
  for (int u = 0; u < CQ; ++u) {
    const int e = base + u * 32 + lane;
    if (e < nvec) {
      const int row = e / vrow, c = (e - row * vrow) * 16;
      store16(sK + row * dp + c, r.khi[u], r.klo[u], r.ksc[u]);
      store16(sV + row * dp + c, r.vhi[u], r.vlo[u], r.vsc[u]);
    }
  }
}

// QT: queries per block; R: output columns per lane (d <= 32 * R);
// kQuant: the int8 pool (K7) rather than the fp32 pool (K5); kSplit: the
// split form, with partials in `part` and tickets from `arrivals` (the
// file's note).  The body of the two kernels below.
template <int QT, int R, bool kQuant, bool kSplit>
__device__ __forceinline__ void
paged_attention_block(const float* __restrict__ q, const Pool pool,
                      const int* __restrict__ page_table,
                      const int* __restrict__ q_start,
                      float* __restrict__ out, float* __restrict__ part,
                      int* __restrict__ arrivals, int n, int T, int d,
                      int page_size, int max_pages, int num_pages,
                      int pages_per_split, int splits, float scale,
                      bool vec) {
  extern __shared__ float smem[];
  __shared__ bool s_last;
  const int B = kSplit ? gridDim.z / splits : gridDim.z;
  const int split = kSplit ? blockIdx.z / B : 0;
  const int b = kSplit ? blockIdx.z - split * B : blockIdx.z;
  const int t0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int dp = d + 1;  // padded row of a staged page

  float* sQ = smem;                                    // [QT, d]
  float* sK = sQ + QT * d + warp * 2 * page_size * dp;  // this warp's page
  float* sV = sK + page_size * dp;
  float* sMerge = sQ + QT * d + kWarps * 2 * page_size * dp;
  // sMerge: per (warp, query) m, l, then acc[d]

  const long long q_base = ((long long)b * n + h) * T;
  const int start = q_start[b];
  const int t_last = min(t0 + QT, T) - 1;
  const int last_key = start + t_last;
  const int n_live = last_key < 0 ? 0
                                  : min(max_pages, last_key / page_size + 1);
  // this block's logical pages: every live one, or its split's share
  const int live_splits =
      kSplit ? max(1, (n_live + pages_per_split - 1) / pages_per_split) : 1;
  if (split >= live_splits) return;  // past the row's last live page
  const int p_begin = kSplit ? split * pages_per_split : 0;
  const int p_end =
      kSplit ? min(n_live, p_begin + pages_per_split) : n_live;
  // the partial (m, l, acc[d]) of query t in split s
  auto slot_of = [&](int t, int s) {
    return part + ((q_base + t) * splits + s) * (d + 2);
  };

  for (int e = threadIdx.x; e < QT * d; e += blockDim.x) {
    const int qi = e / d, c = e - qi * d;
    const int t = t0 + qi;
    sQ[e] = t < T ? q[(q_base + t) * d + c] : 0.f;
  }
  __syncthreads();

  float m[QT], l[QT], acc[QT][R];
#pragma unroll
  for (int qi = 0; qi < QT; ++qi) {
    m[qi] = -CUDART_INF_F;
    l[qi] = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) acc[qi][r] = 0.f;
  }

  // Staging.  With vec (whole 16-byte vectors per row, 16-byte aligned
  // pool) each lane issues its chunk of loads of K and of V at once, so a
  // page costs one memory round trip, not one per element; when a page
  // fits one chunk, the warp's NEXT page is loaded into registers while
  // the current page is scored (a register double buffer).
  const float4* k4 = reinterpret_cast<const float4*>(pool.k);
  const float4* v4 = reinterpret_cast<const float4*>(pool.v);
  constexpr int CQ = kSplit ? kChunkQSplit : kChunkQ;
  const int vrow = kQuant ? d >> 4 : d >> 2;  // 16-byte vectors per row
  const int nvec = page_size * vrow;
  // The register double buffer keeps the next page's codes live across
  // the scores; under the split form's 128-register cap K7's spilled
  // (52-308 bytes, chip_smoke.py phase 2), so K7's split form stages
  // each page when its warp reaches it.  At a page of 16 keys a warp
  // holds one page of a split: there was nothing to prefetch.
  constexpr bool kPrefetch = !(kQuant && kSplit);
  const bool one_chunk =
      kPrefetch && vec && nvec <= 32 * (kQuant ? CQ : kChunk);
  const int* table = page_table + (long long)b * max_pages;
  float4 kr[kChunk], vr[kChunk];
  QRegs<CQ> qr;
  if (one_chunk && p_begin + warp < p_end) {
    const long long row0 =
        page_row0(table, p_begin + warp, page_size, num_pages);
    if constexpr (kQuant)
      load_chunk_q(pool, row0, n, h, vrow, nvec, 0, lane, qr);
    else
      load_chunk(k4, v4, row0, n, h, vrow, nvec, 0, lane, kr, vr);
  }

  // Scoring lanes: with pages of <= 16 keys, lanes l and l+16 share key
  // l, each summing half of the d columns, so no lane idles.
  const int kpl = page_size <= 16 ? 16 : 32;  // keys scored per pass
  const int half = kpl == 16 ? lane >> 4 : 0;
  const int c_lo = half ? d / 2 : 0;
  const int c_hi = (kpl == 16 && !half) ? d / 2 : d;
  const int jl = lane & (kpl - 1);

  for (int lp = p_begin + warp; lp < p_end; lp += kWarps) {
    if (one_chunk) {
      const bool more = lp + kWarps < p_end;
      const long long next =
          more ? page_row0(table, lp + kWarps, page_size, num_pages) : 0;
      if constexpr (kQuant) {
        store_chunk_q(sK, sV, dp, vrow, nvec, 0, lane, qr);
        if (more)  // prefetch: lands while this page scores
          load_chunk_q(pool, next, n, h, vrow, nvec, 0, lane, qr);
      } else {
        store_chunk(sK, sV, dp, vrow, nvec, 0, lane, kr, vr);
        if (more)
          load_chunk(k4, v4, next, n, h, vrow, nvec, 0, lane, kr, vr);
      }
    } else if (vec) {
      const long long row0 = page_row0(table, lp, page_size, num_pages);
      if constexpr (kQuant) {
        for (int base = 0; base < nvec; base += 32 * CQ) {
          load_chunk_q(pool, row0, n, h, vrow, nvec, base, lane, qr);
          store_chunk_q(sK, sV, dp, vrow, nvec, base, lane, qr);
        }
      } else {
        for (int base = 0; base < nvec; base += 32 * kChunk) {
          load_chunk(k4, v4, row0, n, h, vrow, nvec, base, lane, kr, vr);
          store_chunk(sK, sV, dp, vrow, nvec, base, lane, kr, vr);
        }
      }
    } else {
      const long long row0 = page_row0(table, lp, page_size, num_pages);
      for (int e = lane; e < page_size * d; e += 32) {
        const int row = e / d, c = e - row * d;
        const long long vecn = (row0 + row) * n + h;
        const long long g = vecn * d + c;
        if constexpr (kQuant) {
          sK[row * dp + c] = dequant(pool.khi[g], pool.klo[g], pool.ksc[vecn]);
          sV[row * dp + c] = dequant(pool.vhi[g], pool.vlo[g], pool.vsc[vecn]);
        } else {
          sK[row * dp + c] = pool.k[g];
          sV[row * dp + c] = pool.v[g];
        }
      }
    }
    __syncwarp();
    const int key0 = lp * page_size;
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) {
      const int t = t0 + qi;
      const int qpos = start + t;
      if (t >= T || key0 > qpos) continue;  // page wholly past this query
      const float* qv = sQ + qi * d;
      for (int j0 = 0; j0 < page_size; j0 += kpl) {
        const int j = j0 + jl;
        float dot = 0.f;
        if (j < page_size) {
          const float* krow = sK + j * dp;
#pragma unroll 8
          for (int c = c_lo; c < c_hi; ++c) dot = fmaf(qv[c], krow[c], dot);
        }
        if (kpl == 16) dot += __shfl_xor_sync(0xffffffffu, dot, 16);
        float s = -CUDART_INF_F;  // lanes past the page hold no key
        if (j < page_size) s = (key0 + j <= qpos) ? dot * scale : kMaskValue;
        const float m_new = fmaxf(m[qi], warp_max(s));
        const float alpha =
            m[qi] == -CUDART_INF_F ? 0.f : expf(m[qi] - m_new);
        const float p = j < page_size ? expf(s - m_new) : 0.f;
        // a key shared by two lanes is summed once
        l[qi] = l[qi] * alpha + warp_sum(half ? 0.f : p);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[qi][r] *= alpha;
        const int kc = min(kpl, page_size - j0);
#pragma unroll 4
        for (int jj = 0; jj < kc; ++jj) {
          const float pj = __shfl_sync(0xffffffffu, p, jj);
          const float* vrow_s = sV + (j0 + jj) * dp;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int c = lane + 32 * r;
            if (c < d) acc[qi][r] = fmaf(pj, vrow_s[c], acc[qi][r]);
          }
        }
        m[qi] = m_new;
      }
    }
    __syncwarp();  // the next page overwrites this warp's staging area
  }

  const int stride = d + 2;
#pragma unroll
  for (int qi = 0; qi < QT; ++qi) {
    float* slot = sMerge + (warp * QT + qi) * stride;
    if (lane == 0) {
      slot[0] = m[qi];
      slot[1] = l[qi];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = lane + 32 * r;
      if (c < d) slot[2 + c] = acc[qi][r];
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < QT * d; e += blockDim.x) {
    const int qi = e / d, c = e - qi * d;
    const int t = t0 + qi;
    if (t >= T) continue;
    float m_tot = -CUDART_INF_F;
    for (int w = 0; w < kWarps; ++w)
      m_tot = fmaxf(m_tot, sMerge[(w * QT + qi) * stride]);
    float l_tot = 0.f, a_tot = 0.f;
    if (m_tot != -CUDART_INF_F) {
      for (int w = 0; w < kWarps; ++w) {
        const float* slot = sMerge + (w * QT + qi) * stride;
        if (slot[0] == -CUDART_INF_F) continue;
        const float wgt = expf(slot[0] - m_tot);
        l_tot = fmaf(wgt, slot[1], l_tot);
        a_tot = fmaf(wgt, slot[2 + c], a_tot);
      }
    }
    if (live_splits > 1) {
      float* slot = slot_of(t, split);
      if (c == 0) {
        slot[0] = m_tot;
        slot[1] = l_tot;
      }
      slot[2 + c] = a_tot;
    } else {
      out[(q_base + t) * d + c] = l_tot == 0.f ? 0.f : a_tot / l_tot;
    }
  }
  if (!kSplit || live_splits == 1) return;

  // The split form: the last of the tile's live CTAs to arrive merges.
  __threadfence();  // this CTA's partials before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    int* ctr = arrivals + ((long long)b * n + h) * gridDim.x + blockIdx.x;
    s_last = atomicAdd(ctr, 1) == live_splits - 1;
    if (s_last) atomicExch(ctr, 0);  // every live CTA has arrived
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int e = threadIdx.x; e < QT * d; e += blockDim.x) {
    const int qi = e / d, c = e - qi * d;
    const int t = t0 + qi;
    if (t >= T) continue;
    float m_tot = -CUDART_INF_F;
    for (int s = 0; s < live_splits; ++s)
      m_tot = fmaxf(m_tot, __ldcg(slot_of(t, s)));
    float l_tot = 0.f, a_tot = 0.f;
    for (int s = 0; s < live_splits; ++s) {  // L2 reads: other CTAs wrote
      const float* slot = slot_of(t, s);
      const float ms = __ldcg(slot);
      if (ms == -CUDART_INF_F) continue;
      const float wgt = expf(ms - m_tot);
      l_tot = fmaf(wgt, __ldcg(slot + 1), l_tot);
      a_tot = fmaf(wgt, __ldcg(slot + 2 + c), a_tot);
    }
    out[(q_base + t) * d + c] = l_tot == 0.f ? 0.f : a_tot / l_tot;
  }
}

#define PAGED_KERNEL_PARAMS                                                 \
  const float* __restrict__ q, const Pool pool,                            \
      const int* __restrict__ page_table, const int* __restrict__ q_start, \
      float* __restrict__ out, float* __restrict__ part,                   \
      int* __restrict__ arrivals, int n, int T, int d, int page_size,      \
      int max_pages, int num_pages, int pages_per_split, int splits,       \
      float scale, bool vec
#define PAGED_KERNEL_ARGS                                                \
  q, pool, page_table, q_start, out, part, arrivals, n, T, d, page_size, \
      max_pages, num_pages, pages_per_split, splits, scale, vec

// One split: K5 and K7 where max_pages <= pages_per_split.
template <int QT, int R, bool kQuant>
__global__ void __launch_bounds__(32 * kWarps)
paged_attention_kernel(PAGED_KERNEL_PARAMS) {
  count_launch(kQuant ? 1 : 0);
  paged_attention_block<QT, R, kQuant, false>(PAGED_KERNEL_ARGS);
}

// The split form of K5 and K7, held to two CTAs an SM (128 registers a
// thread): with the merge's tail K5's compiles to 151-160 registers
// otherwise, one CTA an SM, and a prefill chunk at q_start 992 reads
// 0.072 ms instead of 0.050 on the card (chip_smoke.py phase 3).  The
// one-split form keeps its registers: it is its own __global__.
template <int QT, int R, bool kQuant>
__global__ void __launch_bounds__(32 * kWarps, 2)
paged_attention_split_kernel(PAGED_KERNEL_PARAMS) {
  count_launch(kQuant ? 1 : 0);
  paged_attention_block<QT, R, kQuant, true>(PAGED_KERNEL_ARGS);
}

template <int QT, int R, bool kQuant, bool kSplit>
cudaError_t launch(const float* q, const Pool& pool, const int* pt,
                   const int* qs, float* out, float* part, int* arrivals,
                   int B, int n, int T, int d, int page_size, int max_pages,
                   int num_pages, int pages_per_split, int splits,
                   float scale, bool vec, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)QT * d + (size_t)kWarps * 2 * page_size *
                       (d + 1) + (size_t)kWarps * QT * (d + 2));
  // above 48 KB a kernel must opt in to dynamic shared memory; raise the
  // limit once per instantiation, to the largest size seen
  static size_t opted_in = 48 * 1024;
  void (*kernel)(PAGED_KERNEL_PARAMS);
  if constexpr (kSplit)
    kernel = paged_attention_split_kernel<QT, R, kQuant>;
  else
    kernel = paged_attention_kernel<QT, R, kQuant>;
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  dim3 grid((T + QT - 1) / QT, n, B * splits);
  kernel<<<grid, 32 * kWarps, smem, stream>>>(q, pool, pt, qs, out, part,
                                              arrivals, n, T, d, page_size,
                                              max_pages, num_pages,
                                              pages_per_split, splits, scale,
                                              vec);
  return cudaGetLastError();
}

template <int QT, bool kQuant, bool kSplit>
cudaError_t dispatch_r(const float* q, const Pool& pool, const int* pt,
                       const int* qs, float* out, float* part, int* arrivals,
                       int B, int n, int T, int d, int page_size,
                       int max_pages, int num_pages, int pages_per_split,
                       int splits, float scale, bool vec,
                       cudaStream_t stream) {
  switch ((d + 31) / 32) {
    case 1: return launch<QT, 1, kQuant, kSplit>(
        q, pool, pt, qs, out, part, arrivals, B, n, T, d, page_size,
        max_pages,
        num_pages, pages_per_split, splits, scale, vec, stream);
    case 2: return launch<QT, 2, kQuant, kSplit>(
        q, pool, pt, qs, out, part, arrivals, B, n, T, d, page_size,
        max_pages,
        num_pages, pages_per_split, splits, scale, vec, stream);
    case 3: return launch<QT, 3, kQuant, kSplit>(
        q, pool, pt, qs, out, part, arrivals, B, n, T, d, page_size,
        max_pages,
        num_pages, pages_per_split, splits, scale, vec, stream);
    case 4: return launch<QT, 4, kQuant, kSplit>(
        q, pool, pt, qs, out, part, arrivals, B, n, T, d, page_size,
        max_pages,
        num_pages, pages_per_split, splits, scale, vec, stream);
    default: return cudaErrorInvalidValue;
  }
}

// One split (`part` and `arrivals` null, pages_per_split >= max_pages)
// or the split form.
template <bool kQuant, bool kSplit>
int dispatch(const float* q, const Pool& pool, const int* page_table,
             const int* q_start, float* out, float* part, int* arrivals,
             int B, int n, int T, int d, int page_size, int max_pages,
             int num_pages, int pages_per_split, int splits, float scale,
             bool vec, void* stream) {
  if (d < 1 || d > 128 || page_size < 1 || num_pages < 1 || max_pages < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || n == 0 || T == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T == 1)
    return (int)dispatch_r<1, kQuant, kSplit>(
        q, pool, page_table, q_start, out, part, arrivals, B, n, T, d,
        page_size, max_pages, num_pages, pages_per_split, splits, scale, vec,
        s);
  return (int)dispatch_r<4, kQuant, kSplit>(
      q, pool, page_table, q_start, out, part, arrivals, B, n, T, d,
      page_size, max_pages, num_pages, pages_per_split, splits, scale, vec,
      s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// Both take the split plan: `splits` chunks of `pages_per_split` logical
// pages must cover the page table; with more than one, `part` is the
// [B, n, T, splits, d + 2] fp32 scratch of the split form and `arrivals`
// its B * n * T zeroed i32 counters.
template <bool kQuant>
int dispatch_plan(const float* q, const Pool& pool, const int* page_table,
                  const int* q_start, float* out, float* part,
                  int* arrivals, int B, int n, int T, int d, int page_size,
                  int max_pages, int num_pages, int pages_per_split,
                  int splits, float scale, bool vec, void* stream) {
  if (splits < 1 || pages_per_split < 1 ||
      (long long)splits * pages_per_split < max_pages ||
      (splits > 1 && (part == nullptr || arrivals == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (splits > 1)
    return dispatch<kQuant, true>(q, pool, page_table, q_start, out, part,
                                  arrivals, B, n, T, d, page_size,
                                  max_pages, num_pages, pages_per_split,
                                  splits, scale, vec, stream);
  return dispatch<kQuant, false>(q, pool, page_table, q_start, out, nullptr,
                                 nullptr, B, n, T, d, page_size, max_pages,
                                 num_pages, max_pages, 1, scale, vec, stream);
}

}  // namespace

// Both return the cudaError_t of the launch (0 on success).  d must be in
// [1, 128]; every pointer is a device pointer; stream is a cudaStream_t.

// The warps of a K5/K7 CTA: the wrapper's split plan gives each warp
// about one page of a split.
extern "C" int pt_paged_warps() { return kWarps; }

// K5: the fp32 pool.
extern "C" int pt_paged_attention_f32(const float* q, const float* k_pages,
                                      const float* v_pages,
                                      const int* page_table,
                                      const int* q_start, float* out,
                                      float* part, int* arrivals, int B,
                                      int n, int T, int d, int page_size,
                                      int max_pages, int num_pages,
                                      int pages_per_split, int splits,
                                      float scale, void* stream) {
  Pool pool = {};
  pool.k = k_pages;
  pool.v = v_pages;
  const bool vec = d % 4 == 0 && aligned16(k_pages) && aligned16(v_pages);
  return dispatch_plan<false>(q, pool, page_table, q_start, out, part,
                              arrivals, B, n, T, d, page_size, max_pages,
                              num_pages, pages_per_split, splits, scale, vec,
                              stream);
}

// K7: the dual-int8 pool (hi, lo int8 and a per-vector fp32 scale).
extern "C" int pt_paged_attention_quant_f32(
    const float* q, const signed char* k_hi, const signed char* k_lo,
    const float* k_scale, const signed char* v_hi, const signed char* v_lo,
    const float* v_scale, const int* page_table, const int* q_start,
    float* out, float* part, int* arrivals, int B, int n, int T, int d,
    int page_size, int max_pages, int num_pages, int pages_per_split,
    int splits, float scale, void* stream) {
  Pool pool = {};
  pool.khi = k_hi;
  pool.klo = k_lo;
  pool.ksc = k_scale;
  pool.vhi = v_hi;
  pool.vlo = v_lo;
  pool.vsc = v_scale;
  const bool vec = d % 16 == 0 && aligned16(k_hi) && aligned16(k_lo) &&
                   aligned16(v_hi) && aligned16(v_lo);
  return dispatch_plan<true>(q, pool, page_table, q_start, out, part,
                             arrivals, B, n, T, d, page_size, max_pages,
                             num_pages, pages_per_split, splits, scale, vec,
                             stream);
}
