"""K1-K3: flash attention, forward and backward.

Counterpart of ``paddle_tpu/kernels/primitives/flash.py``, whose Pallas
kernels this replaces with the hand-written CUDA kernels of
``csrc/flash_attention.cu`` (its source note says what bounds them on
the card and how the design answers that):

- K1 ``_fwd_kernel`` (:78, launched by ``_pallas_fwd`` :221): blockwise
  attention with an online softmax, an additive fp32 key bias and an
  optional causal mask; returns O and the logsumexp.
- K2 ``_bwd_dq_kernel`` (:130, ``_pallas_bwd`` :253):
  P = exp(s - lse); dS = P·(dO·Vᵀ - delta)·scale; dQ = Σ_kv dS·K.
- K3 ``_bwd_dkv_kernel`` (:167, launched at :314): dV = Σ_q Pᵀ·dO,
  dK = Σ_q dSᵀ·Q, dBias[k] = Σ_q dL (the unscaled logit grad).

The JAX package's custom VJP (``_flash`` :326-344) is
:class:`_FlashAttention`, a ``torch.autograd.Function``, which the
registry's grad derivation (autograd through the forward lowering)
differentiates through.  Its forward runs K1 and saves
(q, k, v, bias, O, lse); its backward computes delta = rowsum(dO·O) in
plain torch, outside the kernels as at ``flash.py:258``, then runs K2
and K3.

Numerics kept: fp32 scores, softmax and accumulators for bf16 or fp32
q/k/v; O and dQ/dK/dV in the input dtype, lse and dBias in fp32; the
-1e30 mask constant; a row with l == 0 returns 0 and
lse = m + log(l_safe); a row whose keys all carry -1e30 averages V.
Not kept: the Mosaic 128-blocks and padding S up to a block
(``_pad_to_block``); the kernels mask a ragged last tile themselves, so
any S gives the reference's result.  On bf16 inputs K1-K3 run on the
tensor cores (``csrc/flash_tc.cuh``) and round P to bf16 before P·V and
Pᵀ·dO, and carry dS as two bf16 parts into dS·K and dSᵀ·Q, where the
JAX kernel keeps both fp32.  On fp32 inputs K1, K2 and K3 run on the
tensor cores in split TF32 (``csrc/flash_tf32.cuh``: each product as
three TF32 products of the operands' rounded parts, about 2^-21
relative).

Head dims: the kernels take D up to :data:`MAX_HEAD_DIM` (128) in both
dtypes, each instantiated at a capacity of 64 or 128 columns and
zero-filled past D; the JAX kernel takes any D, so a larger D raises by
name here (no fallback to the plain version).

Inputs: the kernels take q, k, v, dO and their outputs as [B, H, S, D]
views with any strides whose last one is 1.  The flash op receives q,
k and v as ``transpose2`` views of [B, S, H, D] activations, and each
output is allocated with its input's layout (``empty_like``), so no
copy is made on either side of the op.

:func:`flash_fwd`, :func:`flash_bwd_dq` and :func:`flash_bwd_dkv`
launch their kernel for CUDA tensors and run their plain version
(``*_reference``) for CPU tensors (or ``meta`` tensors during shape
inference); ``force="reference"`` picks the plain version explicitly,
and nothing on the training path sets it.  Each counts its kernel
launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

NEG_INF = -1e30  # the JAX kernel's mask constant
MAX_HEAD_DIM = 128  # the kernels' head-dim capacity

__all__ = ["flash_attention", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_fwd_reference", "flash_bwd_dq_reference",
           "flash_bwd_dkv_reference", "NEG_INF"]

_LL, _P, _I = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
# (dtype, pointers..., B, H, S, D, strides (b, h, s) per [B,H,S,D]
# operand..., scale, causal, stream)
_SIGNATURES = {
    "pt_flash_fwd": [_I] + [_P] * 6 + [_I] * 4 + [_LL] * 12
    + [ctypes.c_float, _I, _P],
    "pt_flash_bwd_dq": [_I] + [_P] * 8 + [_I] * 4 + [_LL] * 15
    + [ctypes.c_float, _I, _P],
    "pt_flash_bwd_dkv": [_I] + [_P] * 10 + [_I] * 4 + [_LL] * 18
    + [ctypes.c_float, _I, _P],
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# plain versions: q, k, v [..., S, D] (any leading dims), bias of the
# leading dims' count x S, fp32 math
# ---------------------------------------------------------------------------


def _scores(q, k, bias, causal, scale):
    """fp32 logits s = q·kᵀ·scale + bias, -1e30 where causal masks."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s + bias.reshape(s.shape[:-2] + (1, s.shape[-1]))
    if causal:
        n = s.shape[-1]
        keep = torch.ones(n, n, dtype=torch.bool, device=s.device).tril()
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    return s


def flash_fwd_reference(q, k, v, bias, causal, scale):
    """(O in q's dtype, lse fp32 [..., S]).  P is the softmax, as the
    JAX kernel's acc / l: where every logit of a row is -1e30, lse rounds
    to -1e30 and exp(s - lse) would weigh each key 1, not 1/S."""
    s = _scores(q, k, bias, causal, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype), lse


def _rows(t, q):
    """A per-row [BH, S] (or [..., S]) tensor shaped like q's rows, with
    a trailing 1 to broadcast over the keys."""
    return t.reshape(q.shape[:-1])[..., None]


def _probs(q, k, bias, lse, causal, scale):
    return torch.exp(_scores(q, k, bias, causal, scale) - _rows(lse, q))


def flash_bwd_dq_reference(q, k, v, bias, do, lse, delta, causal, scale):
    p = _probs(q, k, bias, lse, causal, scale)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - _rows(delta, q)) * scale
    return torch.matmul(ds, k.float()).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, bias, do, lse, delta, causal, scale):
    """(dK, dV in k's/v's dtype, dBias fp32 shaped like ``bias``)."""
    p = _probs(q, k, bias, lse, causal, scale)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    dl = p * (dp - _rows(delta, q))
    dk = torch.matmul((dl * scale).transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype), dl.sum(dim=-2).reshape(bias.shape)


# unit roundoff of bf16 (8 significant bits) and of fp32 (24)
_U_BF16, _U_FP32 = 2.0 ** -8, 2.0 ** -24


def flash_bwd_dkv_truth(q, k, v, bias, do, lse, delta, causal, scale):
    """(dK, dV) of K3 exactly, as far as fp32 holds it: the plain
    version's arithmetic on the inputs widened to fp32, not rounded back
    to their dtype."""
    dk, dv, _ = flash_bwd_dkv_reference(q.float(), k.float(), v.float(),
                                        bias, do.float(), lse, delta,
                                        causal, scale)
    return dk, dv


def flash_bwd_dkv_bf16_bound(q, k, v, bias, do, lse, delta, causal, scale):
    """Elementwise bound on |K3 - exact| for bf16 q, k, v, dO: (dK bound,
    dV bound), fp32 and shaped like dK, dV.

    The bf16 kernel (``csrc/flash_tc.cuh``) takes P rounded to bf16 into
    Pᵀ·dO, carries dS as two bf16 parts (hi + lo) into dSᵀ·Q, sums the
    products in fp32 over the S query rows, and rounds dK and dV to
    bf16.  To first order, with u = 2^-8 (bf16) and e = 2^-24 (fp32):

    - P = exp(x), x = s + bias - lse, computed in fp32: the D-term dot
      product errs by at most D·e·scale·(|Q|·|K|ᵀ), each of at most 8
      more fp32 roundings by e·|x|, and ``ex2.approx`` by 2^-22, so P
      errs relatively by eps_P = D·e·scale·(|Q|·|K|ᵀ) + 8·e·|x| + 2^-22;
    - dV: bf16(P) errs by u·P, so Σ_q P·|dO| weighs u + eps_P, the
      fp32 sum adds S·e of the same sum, and the output rounding
      u·|dV|;
    - dK: dS = P·(dP - delta) errs by eps_P·|dS| and by P times dP's
      own D-term error D·e·(|dO|·|V|ᵀ); hi + lo hold dS to u²; the sum
      over the S rows adds S·e·Σ|dS|·|Q|, and the output rounding u·|dK|.

    A pad key (the NMT encoder's -1e9, as bf16 holds it: -999817216)
    has x near -1e9, where fp32 keeps no digit of s, and exp(x) is 0
    exactly, in the kernel and in the exact answer alike: its P, dS, dK
    and dV are 0 with no error, and it adds nothing to any other key's
    sums.  So the bound is set by the real keys of short rows: where a
    sentence has a few keys, each of its real keys takes P of order 1/n
    from every one of the S query rows, u·Σ_q P·|dO| grows as S/n while
    dV = Σ_q P·dO may cancel to near 0, and the P rounding alone can
    move dV by many of its own ulps (chip_smoke's 2e-2 against the
    plain bf16 version does not hold there)."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    d = q.shape[-1]
    n_rows = q.shape[-2]
    s = _scores(qf, kf, bias, causal, scale)
    p = torch.exp(s - _rows(lse, q))
    x = torch.where(p > 0, (s - _rows(lse, q)).abs(), torch.zeros_like(s))
    qk_abs = torch.matmul(qf.abs(), kf.abs().transpose(-1, -2)) * scale
    eps_p = d * _U_FP32 * qk_abs + 8 * _U_FP32 * x + 2.0 ** -22
    dv_abs = torch.matmul(p.transpose(-1, -2), dof.abs())
    dv_eps = torch.matmul((p * eps_p).transpose(-1, -2), dof.abs())
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    dl = p * (dp - _rows(delta, q))
    dp_err = d * _U_FP32 * torch.matmul(dof.abs(), vf.abs().transpose(-1, -2))
    ds_err = (dl.abs() * (eps_p + _U_BF16 ** 2 + n_rows * _U_FP32)
              + p * dp_err) * scale
    dk_err = torch.matmul(ds_err.transpose(-1, -2), qf.abs())
    dk = torch.matmul((dl * scale).transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dv_err = (_U_BF16 + n_rows * _U_FP32) * dv_abs + dv_eps
    return (_U_BF16 * (dk.abs() + dk_err) + dk_err,
            _U_BF16 * (dv.abs() + dv_err) + dv_err)


# ---------------------------------------------------------------------------
# the three launchers
# ---------------------------------------------------------------------------


def _as4(t):
    return t if t.dim() == 4 else t.unsqueeze(1)


def _strides(t):
    """Element strides (b, h, s) of a [B, H, S, D] view, D contiguous."""
    if t.stride(-1) != 1:
        raise ValueError("flash attention: the head dim must be "
                         f"contiguous, got strides {t.stride()}")
    return list(t.stride()[:3])


def _check(name, q, *tensors):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: q/k/v must be float32 or bfloat16, got "
                        f"{q.dtype}")
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {q.device} and "
                             f"{t.device}")


def _use_kernel(name, q, force):
    if force not in (None, "reference"):
        raise ValueError(f"{name}: force={force!r} (use None or "
                         f"'reference')")
    if force == "reference" or q.device.type in ("cpu", "meta"):
        return False
    if q.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {q.device}")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {q.shape[-1]} > "
                         f"{MAX_HEAD_DIM}, the kernel's capacity")
    return True


def _fp32_rows(name, t, n):
    if t.dtype != torch.float32 or not t.is_contiguous() or t.numel() != n:
        raise ValueError(f"{name}: expected a contiguous float32 [B*H, S] "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")


def flash_fwd(q, k, v, bias, causal=False, scale=1.0, force=None):
    """K1: (O, lse) for q, k, v [B, H, S, D] or [BH, S, D] (one dtype)
    and an fp32 key bias [BH, S]; O has q's layout and dtype."""
    _check("flash_fwd", q, k, v, bias)
    if not _use_kernel("flash_fwd", q, force):
        return flash_fwd_reference(q, k, v, bias, causal, scale)
    q4, k4, v4 = _as4(q), _as4(k), _as4(v)
    b, h, s, d = q4.shape
    _fp32_rows("flash_fwd bias", bias, b * h * s)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    o4 = _as4(o)
    lib = _build.load("flash_attention", _SIGNATURES)
    err = lib.pt_flash_fwd(
        _DTYPE_CODE[q.dtype], *map(_build.ptr, (q4, k4, v4, bias, o4, lse)),
        b, h, s, d, *(_strides(q4) + _strides(k4) + _strides(v4)
                      + _strides(o4)),
        float(scale), int(bool(causal)), _build.stream_of(q.device))
    flash_fwd.launches += 1
    _build.check("flash_fwd", err)
    return o, lse


def flash_bwd_dq(q, k, v, bias, do, lse, delta, causal=False, scale=1.0,
                 force=None):
    """K2: dQ (q's layout and dtype)."""
    _check("flash_bwd_dq", q, k, v, bias, do, lse, delta)
    if not _use_kernel("flash_bwd_dq", q, force):
        return flash_bwd_dq_reference(q, k, v, bias, do, lse, delta,
                                      causal, scale)
    q4, k4, v4, do4 = _as4(q), _as4(k), _as4(v), _as4(do)
    b, h, s, d = q4.shape
    for nm, t in (("bias", bias), ("lse", lse), ("delta", delta)):
        _fp32_rows(f"flash_bwd_dq {nm}", t, b * h * s)
    dq = torch.empty_like(q)
    dq4 = _as4(dq)
    lib = _build.load("flash_attention", _SIGNATURES)
    err = lib.pt_flash_bwd_dq(
        _DTYPE_CODE[q.dtype],
        *map(_build.ptr, (q4, k4, v4, bias, do4, lse, delta, dq4)),
        b, h, s, d, *(_strides(q4) + _strides(k4) + _strides(v4)
                      + _strides(do4) + _strides(dq4)),
        float(scale), int(bool(causal)), _build.stream_of(q.device))
    flash_bwd_dq.launches += 1
    _build.check("flash_bwd_dq", err)
    return dq


def flash_bwd_dkv(q, k, v, bias, do, lse, delta, causal=False, scale=1.0,
                  force=None):
    """K3: (dK, dV) in k's/v's layout and dtype, and dBias fp32 [BH, S]."""
    _check("flash_bwd_dkv", q, k, v, bias, do, lse, delta)
    if not _use_kernel("flash_bwd_dkv", q, force):
        return flash_bwd_dkv_reference(q, k, v, bias, do, lse, delta,
                                       causal, scale)
    q4, k4, v4, do4 = _as4(q), _as4(k), _as4(v), _as4(do)
    b, h, s, d = q4.shape
    for nm, t in (("bias", bias), ("lse", lse), ("delta", delta)):
        _fp32_rows(f"flash_bwd_dkv {nm}", t, b * h * s)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty_like(bias)
    dk4, dv4 = _as4(dk), _as4(dv)
    lib = _build.load("flash_attention", _SIGNATURES)
    err = lib.pt_flash_bwd_dkv(
        _DTYPE_CODE[q.dtype],
        *map(_build.ptr, (q4, k4, v4, bias, do4, lse, delta, dk4, dv4,
                          dbias)),
        b, h, s, d, *(_strides(q4) + _strides(k4) + _strides(v4)
                      + _strides(do4) + _strides(dk4) + _strides(dv4)),
        float(scale), int(bool(causal)), _build.stream_of(q.device))
    flash_bwd_dkv.launches += 1
    _build.check("flash_bwd_dkv", err)
    return dk, dv, dbias.reshape(bias.shape)


for _fn in (flash_fwd, flash_bwd_dq, flash_bwd_dkv):
    _fn.launches = 0


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """O = attention(q, k, v, bias); backward through K2 and K3."""

    @staticmethod
    def forward(q, k, v, bias, causal, scale, force):
        return flash_fwd(q, k, v, bias, causal, scale, force)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, bias, causal, scale, force = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.causal, ctx.scale, ctx.force = causal, scale, force
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, bias, o, lse = ctx.saved_tensors
        do = do.to(q.dtype)
        delta = (do.float() * o.float()).sum(dim=-1)
        if delta.dim() == 3:  # [B, H, S] -> the kernels' [B*H, S] rows
            delta = delta.reshape(-1, delta.shape[-1])
            lse_rows = lse.reshape(delta.shape)
        else:
            lse_rows = lse
        args = (q, k, v, bias, do, lse_rows, delta.contiguous(),
                ctx.causal, ctx.scale, ctx.force)
        dq = flash_bwd_dq(*args)
        dk, dv, dbias = flash_bwd_dkv(*args)
        return dq, dk, dv, dbias, None, None, None


def flash_attention(q, k, v, bias=None, causal=False, sm_scale=None,
                    force=None):
    """Attention over [B, H, S, D] (or [BH, S, D]) without an S x S score
    tensor in device memory.

    bias: optional additive key bias [B, 1, 1, S], [B, S] or [BH, S]
    (0 for real tokens, -1e4 for pads), cast to fp32.  force: None runs
    the kernels on a CUDA tensor and the plain versions on a CPU one;
    "reference" runs the plain versions.
    """
    if q.dim() not in (3, 4):
        raise ValueError(f"flash_attention: q must be [B, H, S, D] or "
                         f"[BH, S, D], got {tuple(q.shape)}")
    b, h = (q.shape[0], q.shape[1]) if q.dim() == 4 else (q.shape[0], 1)
    s, d = q.shape[-2:]
    if k.shape != q.shape or v.shape != q.shape or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} {q.dtype}, "
                         f"k {tuple(k.shape)} {k.dtype} and v "
                         f"{tuple(v.shape)} {v.dtype} must match")
    scale = float(sm_scale if sm_scale is not None else 1.0 / math.sqrt(d))
    if bias is None:
        rows = torch.zeros(b * h, s, dtype=torch.float32, device=q.device)
    elif q.dim() == 4 and bias.numel() == b * s:
        # at b 1 the reshape of the expanded view is a view with a zero
        # stride, which the kernels do not take
        rows = bias.float().reshape(b, 1, s).expand(b, h, s) \
            .reshape(b * h, s).contiguous()
    else:
        rows = bias.float().reshape(b * h, -1).expand(b * h, s) \
            .contiguous()
    return _FlashAttention.apply(q, k, v, rows, bool(causal), scale,
                                 force)[0]
