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
// Two designs, both on the tensor cores.  K1-K3 on bfloat16, the
// training path's dtype under the bf16 policy: flash_tc.cuh, whose note
// gives their bound and design.  K1-K3 on float32, the Fluid default
// dtype (the predictor path, and every program trained without the bf16
// policy): split TF32, flash_tf32.cuh (each product as three TF32
// tensor-core products of the operands' hi and lo parts, about 2^-21
// relative, inside the 2e-5 fp32 gate).  The fp32 kernels' first design
// ran the products on the SIMT units (67 TFLOP/s) from transposed,
// scalar-staged tiles and was slower than SDPA in fp32 for K1, K2 and
// K3 alike; none of it remains.  Both designs take D up to 128, each
// kernel instantiated at a head-dim capacity of 64 and of 128
// (flash_tc::with_capacity).

#include <cuda_runtime.h>

#include "flash_tc.cuh"
#include "flash_tf32.cuh"

namespace {

constexpr int kMaxDim = 128;  // the kernels' head-dim capacity

bool bad_shape(int B, int H, int S, int D) {
  return B < 1 || H < 1 || S < 1 || D < 1 || D > kMaxDim;
}

}  // namespace

// C entry points.  Each returns the cudaError_t of its launch (0 on
// success).  dtype: 0 = float32 (the split-TF32 kernels of
// flash_tf32.cuh), 1 = bfloat16 (the tensor-core kernels of
// flash_tc.cuh).  D up to 128; a larger D, or
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
    return (int)(causal ? flash_tf32::bwd_dq<true>(q, k, v, bias, dout, lse,
                                                   delta, dq, B, H, S, D, st,
                                                   scale, s)
                        : flash_tf32::bwd_dq<false>(q, k, v, bias, dout,
                                                    lse, delta, dq, B, H, S,
                                                    D, st, scale, s));
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
    return (int)(causal ? flash_tf32::bwd_dkv<true>(q, k, v, bias, dout,
                                                    lse, delta, dk, dv,
                                                    dbias, B, H, S, D, st,
                                                    scale, s)
                        : flash_tf32::bwd_dkv<false>(q, k, v, bias, dout,
                                                     lse, delta, dk, dv,
                                                     dbias, B, H, S, D, st,
                                                     scale, s));
  return (int)(causal ? flash_tc::bwd_dkv<true>(q, k, v, bias, dout, lse,
                                                delta, dk, dv, dbias, B, H,
                                                S, D, st, scale, s)
                      : flash_tc::bwd_dkv<false>(q, k, v, bias, dout, lse,
                                                 delta, dk, dv, dbias, B, H,
                                                 S, D, st, scale, s));
}
