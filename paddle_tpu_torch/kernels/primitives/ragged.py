"""K6: ragged (variable-length) attention, forward only.

Counterpart of ``paddle_tpu/kernels/primitives/ragged.py``, whose
Pallas kernel (``_ragged_kernel`` :74, launched by ``_pallas_ragged``
:126) this replaces with the hand-written CUDA kernel
``csrc/ragged_attention.cu`` (its source note says what bounds it on
the card and how the design answers that).

A batch of sequences of different lengths attends in one launch, driven
by a per-row length vector instead of per-row padding masks: row b
attends key positions j < lengths[b] (and j <= i when causal); masked
logits are -1e30; a row of length 0 returns zeros.  Key tiles past a
row's length (and, with causal, past the query tile) are never visited.
Rows at i >= lengths[b] are computed under the same key mask and carry
no contract (the serving engine slices them off).

Shapes: ``[B, H, S, D]`` with lengths ``[B]`` broadcast over heads, or
``[BH, S, D]`` with lengths ``[BH]``.  The kernel takes (b, h, s)
strides with a contiguous D, so the op's ``transpose2`` views are read
in place; any S (rows and keys past S are masked, no padding to a
block) and D <= 128; q, k and v float32 or bfloat16 (one dtype; the
kernel computes in fp32 and returns q's dtype, as the JAX kernel does).

Not kept from the JAX function: the Mosaic block autotune and the
padding of S up to a block (``_select_block``, ``_ceil_to``).

:func:`ragged_attention` launches the kernel for CUDA tensors and runs
the plain version, :func:`ragged_attention_reference`, for CPU tensors
(or ``meta`` tensors during shape inference).  ``force="reference"``
picks the plain version explicitly; nothing on the serving path sets
it.  ``ragged_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

NEG_INF = -1e30  # flash's mask constant, as the JAX kernel uses it
MAX_HEAD_DIM = 128  # the kernel's head-dim capacity

__all__ = ["ragged_attention", "ragged_attention_reference", "NEG_INF"]

_SIGNATURES = {
    "pt_ragged_attention_f32": [ctypes.c_int] + [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 12
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def ragged_attention_reference(q, k, v, lengths, causal=False,
                               sm_scale=None):
    """The plain version over [BH, S, D] + lengths [BH]: keys past a
    row's length masked with -1e30, the standard softmax, and a row of
    length 0 zeroed — the JAX package's ``ragged_attention_reference``
    op for op."""
    d = q.shape[-1]
    scale = float(sm_scale if sm_scale is not None else 1.0 / math.sqrt(d))
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    n = s.shape[-1]
    lens = lengths.to(torch.int32).reshape(-1, 1, 1)
    ki = torch.arange(n, device=s.device).view(1, 1, n)
    s = torch.where(ki < lens, s, torch.full_like(s, NEG_INF))
    if causal:
        qi = torch.arange(n, device=s.device).view(1, n, 1)
        s = torch.where(qi >= ki, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    # a fully masked row (length 0) softmaxes to uniform garbage: zero it
    p = torch.where(lens > 0, p, torch.zeros_like(p))
    return torch.matmul(p, v.float()).to(q.dtype)


def _strides(t):
    """Element strides (b, h, s) of a [B, H, S, D] view, D contiguous."""
    if t.stride(-1) != 1:
        raise ValueError(f"ragged_attention: the head dim must be "
                         f"contiguous, got strides {t.stride()}")
    return list(t.stride()[:3])


def _use_kernel(q, force):
    """False for the plain version (``force="reference"``, a CPU or meta
    tensor); True for a CUDA tensor, which launches the kernel."""
    if force not in (None, "reference"):
        raise ValueError(f"ragged_attention: force={force!r} (use None or "
                         f"'reference')")
    if force == "reference" or q.device.type in ("cpu", "meta"):
        return False
    if q.device.type != "cuda":
        raise RuntimeError(f"ragged_attention: no kernel for {q.device}")
    return True


def ragged_attention(q, k, v, lengths, causal=False, sm_scale=None,
                     force=None):
    """Variable-length attention over [B, H, S, D] (lengths [B]) or
    [BH, S, D] (lengths [BH]); returns q's shape, layout and dtype."""
    if q.dim() not in (3, 4) or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"ragged_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"one [B, H, S, D] or [BH, S, D] shape")
    rows = q.shape[0]
    if lengths.numel() != rows:
        raise ValueError(f"ragged_attention: lengths {tuple(lengths.shape)} "
                         f"must hold one length per row ({rows})")
    for t in (k, v, lengths):
        if t.device != q.device:
            raise ValueError(f"ragged_attention: tensors on {q.device} and "
                             f"{t.device}")
    s, d = q.shape[-2:]
    scale = float(sm_scale if sm_scale is not None else 1.0 / math.sqrt(d))
    if not _use_kernel(q, force):
        if q.dim() == 3:
            return ragged_attention_reference(q, k, v, lengths, causal,
                                              scale)
        b, h = q.shape[:2]
        lens = lengths.reshape(b, 1).expand(b, h).reshape(b * h)
        out = ragged_attention_reference(
            q.reshape(b * h, s, d), k.reshape(b * h, s, d),
            v.reshape(b * h, s, d), lens, causal, scale)
        return out.reshape(b, h, s, d)
    if d > MAX_HEAD_DIM:
        raise ValueError(f"ragged_attention: head dim {d} > {MAX_HEAD_DIM}, "
                         f"the kernel's capacity")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"ragged_attention: q, k and v must be float32 or "
                        f"bfloat16 of one dtype, got {q.dtype}, {k.dtype} "
                        f"and {v.dtype}")
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise ValueError(f"ragged_attention: lengths must be contiguous "
                         f"int32, got {lengths.dtype}")
    q4, k4, v4 = (t if t.dim() == 4 else t.unsqueeze(1) for t in (q, k, v))
    b, h = q4.shape[:2]
    out = torch.empty_like(q)
    o4 = out if out.dim() == 4 else out.unsqueeze(1)
    lib = _build.load("ragged_attention", _SIGNATURES)
    err = lib.pt_ragged_attention_f32(
        _DTYPE_CODE[q.dtype], *map(_build.ptr, (q4, k4, v4, lengths, o4)),
        b, h, s, d,
        *(_strides(q4) + _strides(k4) + _strides(v4) + _strides(o4)),
        scale, int(bool(causal)), _build.stream_of(q.device))
    ragged_attention.launches += 1
    _build.check("ragged_attention", err)
    return out


ragged_attention.launches = 0
