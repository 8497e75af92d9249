"""K5 and K7: paged attention — K/V read through a per-sequence page
table, from an fp32 pool (K5) or a dual-int8 pool (K7).

Counterpart of ``paddle_tpu/kernels/primitives/paged.py``, whose Pallas
kernels (``_paged_kernel`` :121, launched by ``_pallas_paged`` :197;
``_paged_quant_kernel`` :241, launched by ``_pallas_paged_quant``
:298) this replaces with the hand-written CUDA kernels of
``csrc/paged_attention.cu`` (its source note says what bounds them on
the card and how the design answers that).

Shapes:
  q           [B, n_heads, T, d]   T = 1 (decode step) or the prefill
                                   chunk length
  k/v_pages   [num_pages, page_size, n_heads, d]
  page_table  [B, max_pages] int32 — physical page of each logical page
  q_start     [B] int32 — tokens already in the cache before this q
              block; query i of row b attends keys j <= q_start[b] + i

Page 0 of the pool is the allocator's trash page; no row's mask ever
exposes it.

The int8 pool (K7): hi/lo int8 ``[num_pages, page_size, n_heads, d]``
plus a per-vector fp32 scale ``[num_pages, page_size, n_heads, 1]``
(primitives/int8.py ``quantize_lastdim``); the kernel dequantises
(hi + lo/254)·scale in registers.

:func:`paged_attention` and :func:`paged_attention_quant` launch their
kernel for CUDA tensors and run their plain version
(:func:`paged_attention_reference`,
:func:`paged_attention_quant_reference`) for CPU tensors (or ``meta``
tensors during shape inference).  ``force="reference"`` selects the
plain version explicitly, as the JAX op's ``force`` attr does; nothing
on the decode path sets it.  Each wrapper's ``.launches`` counts its
kernel launches (one a call, whatever the kernel launches inside).

K5 and K7 split each row's logical pages across CTAs (flash-decoding):
:func:`split_plan` computes the split from shapes alone, and each
wrapper allocates the kernel's partials with ``torch.empty`` and takes
its arrival counters from one zeroed set a (device, stream), which the
kernel resets after each use.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .. import _build
from .int8 import dequantize_lastdim

NEG_INF = -1e9  # the JAX kernel's mask constant

__all__ = ["paged_attention", "paged_attention_reference",
           "paged_attention_quant", "paged_attention_quant_reference",
           "split_plan", "SplitPlan", "NEG_INF"]

_SIGNATURES = {
    "pt_paged_warps": [],
    "pt_paged_attention_f32": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
    + [ctypes.c_float, ctypes.c_void_p],
    "pt_paged_attention_quant_f32": [ctypes.c_void_p] * 12
    + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p],
}


# a split gives each of the CTA's warps about 16 keys (one page of 16 or
# more, several smaller pages)
_KEYS_PER_WARP = 16


class SplitPlan(NamedTuple):
    """The split of each row's logical pages: ``splits`` chunks of
    ``pages_per_split`` (the last may be shorter), one CTA per (query
    tile, chunk, head, row).  ``workspace`` is the shape of the fp32
    partials (m, l, acc[d]) of every (row, head, query, chunk) and
    ``arrivals`` the number of i32 arrival counters, or None and 0 for
    one chunk (the kernel then writes the output directly)."""

    pages_per_split: int
    splits: int
    workspace: tuple | None
    arrivals: int


def split_plan(b, n, t, d, max_pages, page_size, warps):
    """K5's and K7's split from shapes and the kernel's ``warps`` a CTA
    alone —
    never from ``q_start`` or ``page_table`` values, so planning reads
    nothing from the device and every decode step makes the same
    launch."""
    pages_per_split = warps * max(1, _KEYS_PER_WARP // page_size)
    splits = -(-max_pages // pages_per_split)
    if splits == 1:
        return SplitPlan(pages_per_split, 1, None, 0)
    return SplitPlan(pages_per_split, splits, (b, n, t, splits, d + 2),
                     b * n * t)


_arrivals = {}  # (device, stream) -> zeroed i32 counters of the split form


def _arrival_counters(device, stream, count):
    """At least ``count`` zeroed arrival counters for launches on
    ``stream``: the kernel leaves each at 0 after the call that counts
    on it, so launches in one stream reuse them."""
    key = (device, stream.value)
    have = _arrivals.get(key)
    if have is None or have.numel() < count:
        have = _arrivals[key] = torch.zeros(count, dtype=torch.int32,
                                            device=device)
    return have


def paged_attention_reference(q, k_pages, v_pages, page_table, q_start,
                              sm_scale=None):
    """The plain version: gather every page of the table, score, mask
    positions past each query with -1e9, softmax, weight V — the JAX
    package's ``paged_attention_reference`` op for op."""
    b, n, t, d = q.shape
    page_size = k_pages.shape[1]
    l_max = page_table.shape[1] * page_size
    scale = float(sm_scale if sm_scale is not None else 1.0 / math.sqrt(d))
    idx = page_table.long()

    def gathered(pages):
        g = pages[idx].reshape(b, l_max, n, d)     # [B, L, n, d]
        return g.permute(0, 2, 1, 3)               # [B, n, L, d]

    k = gathered(k_pages).float()
    v = gathered(v_pages).float()
    s = torch.matmul(q.float(), k.transpose(-1, -2)) * scale
    kpos = torch.arange(l_max, device=q.device).view(1, 1, 1, l_max)
    qpos = (q_start.long().view(b, 1, 1, 1)
            + torch.arange(t, device=q.device).view(1, 1, t, 1))
    s = torch.where(kpos <= qpos, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v).to(q.dtype)


def _check(q, k_pages, v_pages, page_table, q_start):
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} must be "
                         f"[B, n, T, d] and the pool {tuple(k_pages.shape)} "
                         f"[P, page, n, d]")
    b, n, _, d = q.shape
    if k_pages.shape != v_pages.shape or k_pages.shape[2:] != (n, d):
        raise ValueError(f"paged_attention: K pool {tuple(k_pages.shape)} / "
                         f"V pool {tuple(v_pages.shape)} do not match q "
                         f"heads {n} x dim {d}")
    if k_pages.dtype != v_pages.dtype:
        raise ValueError(f"paged_attention: K pool dtype {k_pages.dtype} != "
                         f"V pool dtype {v_pages.dtype} — the pool must be "
                         f"one dtype")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or tuple(q_start.shape) != (b,):
        raise ValueError(f"paged_attention: page_table "
                         f"{tuple(page_table.shape)} must be [B, max_pages] "
                         f"and q_start {tuple(q_start.shape)} [B], B = {b}")
    for t in (k_pages, v_pages, page_table, q_start):
        if t.device != q.device:
            raise ValueError(f"paged_attention: tensors on {q.device} and "
                             f"{t.device}")


def _use_kernel(name, q, force):
    """False for the plain version (``force="reference"``, a CPU or meta
    tensor); True for a CUDA tensor, which launches the kernel."""
    if force not in (None, "reference"):
        raise ValueError(f"{name}: force={force!r} (use None or "
                         f"'reference')")
    if force == "reference" or q.device.type in ("cpu", "meta"):
        return False
    if q.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {q.device}")
    if q.shape[-1] > 128:
        raise ValueError(f"{name}: head dim {q.shape[-1]} > 128")
    return True


def _require(name, tensors):
    """The kernel's operands: each (name, tensor, dtype) contiguous in
    that dtype, or raise."""
    for nm, x, dt in tensors:
        if x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous {dt}, got "
                             f"{x.dtype} (contiguous={x.is_contiguous()})")


def _scale(q, sm_scale):
    return float(sm_scale if sm_scale is not None
                 else 1.0 / math.sqrt(q.shape[-1]))


def _ptr_or_none(t):
    return None if t is None else _build.ptr(t)


def _plan_launch(lib, q, pool, page_table):
    """The split plan's launch arguments for q over ``pool`` (one of its
    [P, page, n, d] tensors): the partials and the arrival counters
    (None for one split; the caller keeps them alive past the launch),
    then (B, n, T, d, page size, max_pages, P, pages_per_split,
    splits)."""
    b, n, t, d = q.shape
    page_size, max_pages = pool.shape[1], page_table.shape[1]
    plan = split_plan(b, n, t, d, max_pages, page_size, lib.pt_paged_warps())
    part = arrivals = None
    if plan.splits > 1:
        part = torch.empty(plan.workspace, dtype=torch.float32,
                           device=q.device)
        arrivals = _arrival_counters(q.device, _build.stream_of(q.device),
                                     plan.arrivals)
    return part, arrivals, (b, n, t, d, page_size, max_pages, pool.shape[0],
                            plan.pages_per_split, plan.splits)


def paged_attention(q, k_pages, v_pages, page_table, q_start, *,
                    sm_scale=None, force=None):
    """K5: attention of q [B, n, T, d] against pool K/V read through
    ``page_table``; query i of row b attends key positions
    j <= q_start[b] + i."""
    _check(q, k_pages, v_pages, page_table, q_start)
    scale = _scale(q, sm_scale)
    if not _use_kernel("paged_attention", q, force):
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         q_start, sm_scale=scale)
    _require("paged_attention", (("q", q, torch.float32),
                                 ("k_pages", k_pages, torch.float32),
                                 ("v_pages", v_pages, torch.float32),
                                 ("page_table", page_table, torch.int32),
                                 ("q_start", q_start, torch.int32)))
    lib = _build.load("paged_attention", _SIGNATURES)
    out = torch.empty_like(q)
    part, arrivals, plan_args = _plan_launch(lib, q, k_pages, page_table)
    err = lib.pt_paged_attention_f32(
        _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
        _build.ptr(page_table), _build.ptr(q_start), _build.ptr(out),
        *map(_ptr_or_none, (part, arrivals)), *plan_args, scale,
        _build.stream_of(q.device))
    paged_attention.launches += 1
    _build.check("paged_attention", err)
    return out


paged_attention.launches = 0


# ---------------------------------------------------------------------------
# K7: the dual-int8 pool
# ---------------------------------------------------------------------------


def paged_attention_quant_reference(q, k_hi, k_lo, k_scale, v_hi, v_lo,
                                    v_scale, page_table, q_start,
                                    sm_scale=None):
    """The plain version: dequantise the whole pool, then the fp32
    plain version — the JAX package's
    ``paged_attention_quant_reference`` (the kernel never does this)."""
    return paged_attention_reference(
        q, dequantize_lastdim(k_hi, k_lo, k_scale),
        dequantize_lastdim(v_hi, v_lo, v_scale), page_table, q_start,
        sm_scale=sm_scale)


def paged_attention_quant(q, k_hi, k_lo, k_scale, v_hi, v_lo, v_scale,
                          page_table, q_start, *, sm_scale=None,
                          force=None):
    """K7: paged attention over a dual-int8 pool — hi/lo int8
    [P, page, n, d] and a per-vector fp32 scale [P, page, n, 1]."""
    for nm, arr in (("k_hi", k_hi), ("k_lo", k_lo), ("v_hi", v_hi),
                    ("v_lo", v_lo)):
        if arr.dtype != torch.int8:
            raise ValueError(
                f"paged_attention_quant: {nm} dtype {arr.dtype} != int8 "
                f"— the quant pool stores the dual-int8 format "
                f"(serving/kv_pool.py KVPool(dtype='int8'))")
    _check(q, k_hi, v_hi, page_table, q_start)
    sc_shape = tuple(k_hi.shape[:-1]) + (1,)
    if k_lo.shape != k_hi.shape or v_lo.shape != v_hi.shape \
            or tuple(k_scale.shape) != sc_shape \
            or tuple(v_scale.shape) != sc_shape:
        raise ValueError(
            f"paged_attention_quant: hi {tuple(k_hi.shape)} / lo "
            f"{tuple(k_lo.shape)}, {tuple(v_lo.shape)} / scale "
            f"{tuple(k_scale.shape)}, {tuple(v_scale.shape)} must be "
            f"[P, page, n, d] twice and [P, page, n, 1]")
    for t in (k_lo, k_scale, v_lo, v_scale):
        if t.device != q.device:
            raise ValueError(f"paged_attention_quant: tensors on "
                             f"{q.device} and {t.device}")
    scale = _scale(q, sm_scale)
    if not _use_kernel("paged_attention_quant", q, force):
        return paged_attention_quant_reference(
            q, k_hi, k_lo, k_scale, v_hi, v_lo, v_scale, page_table,
            q_start, sm_scale=scale)
    _require("paged_attention_quant", (
        ("q", q, torch.float32), ("k_hi", k_hi, torch.int8),
        ("k_lo", k_lo, torch.int8), ("k_scale", k_scale, torch.float32),
        ("v_hi", v_hi, torch.int8), ("v_lo", v_lo, torch.int8),
        ("v_scale", v_scale, torch.float32),
        ("page_table", page_table, torch.int32),
        ("q_start", q_start, torch.int32)))
    lib = _build.load("paged_attention", _SIGNATURES)
    out = torch.empty_like(q)
    part, arrivals, plan_args = _plan_launch(lib, q, k_hi, page_table)
    err = lib.pt_paged_attention_quant_f32(
        *map(_build.ptr, (q, k_hi, k_lo, k_scale, v_hi, v_lo, v_scale,
                          page_table, q_start, out)),
        *map(_ptr_or_none, (part, arrivals)), *plan_args, scale,
        _build.stream_of(q.device))
    paged_attention_quant.launches += 1
    _build.check("paged_attention_quant", err)
    return out


paged_attention_quant.launches = 0
