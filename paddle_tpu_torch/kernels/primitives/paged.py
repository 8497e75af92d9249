"""K5: paged attention — K/V read through a per-sequence page table.

Counterpart of ``paddle_tpu/kernels/primitives/paged.py``, whose Pallas
kernel (``_paged_kernel`` :121, launched by ``_pallas_paged`` :197) this
replaces with the hand-written CUDA kernel ``csrc/paged_attention.cu``
(its source note says what bounds it on the card and how the design
answers that).

Shapes:
  q           [B, n_heads, T, d]   T = 1 (decode step) or the prefill
                                   chunk length
  k/v_pages   [num_pages, page_size, n_heads, d]
  page_table  [B, max_pages] int32 — physical page of each logical page
  q_start     [B] int32 — tokens already in the cache before this q
              block; query i of row b attends keys j <= q_start[b] + i

Page 0 of the pool is the allocator's trash page; no row's mask ever
exposes it.

:func:`paged_attention` launches the kernel for CUDA tensors and runs
the plain version, :func:`paged_attention_reference`, for CPU tensors
(or ``meta`` tensors during shape inference).  ``force="reference"``
selects the plain version explicitly, as the JAX op's ``force`` attr
does; nothing on the decode path sets it.  ``paged_attention.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

NEG_INF = -1e9  # the JAX kernel's mask constant

__all__ = ["paged_attention", "paged_attention_reference", "NEG_INF"]

_SIGNATURES = {
    "pt_paged_attention_f32": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p],
}


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


def paged_attention(q, k_pages, v_pages, page_table, q_start, *,
                    sm_scale=None, force=None):
    """Attention of q [B, n, T, d] against pool K/V read through
    ``page_table``; query i of row b attends key positions
    j <= q_start[b] + i."""
    _check(q, k_pages, v_pages, page_table, q_start)
    if force not in (None, "reference"):
        raise ValueError(f"paged_attention: force={force!r} (use None or "
                         f"'reference')")
    b, n, t, d = q.shape
    scale = float(sm_scale if sm_scale is not None else 1.0 / math.sqrt(d))
    if force == "reference" or q.device.type in ("cpu", "meta"):
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         q_start, sm_scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"paged_attention: no kernel for {q.device}")
    for name, x, dt in (("q", q, torch.float32),
                        ("k_pages", k_pages, torch.float32),
                        ("v_pages", v_pages, torch.float32),
                        ("page_table", page_table, torch.int32),
                        ("q_start", q_start, torch.int32)):
        if x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous "
                             f"{dt}, got {x.dtype} (contiguous="
                             f"{x.is_contiguous()})")
    if d > 128:
        raise ValueError(f"paged_attention: head dim {d} > 128")
    lib = _build.load("paged_attention", _SIGNATURES)
    out = torch.empty_like(q)
    page_size, max_pages = k_pages.shape[1], page_table.shape[1]
    err = lib.pt_paged_attention_f32(
        _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
        _build.ptr(page_table), _build.ptr(q_start), _build.ptr(out),
        b, n, t, d, page_size, max_pages, k_pages.shape[0], scale,
        _build.stream_of(q.device))
    paged_attention.launches += 1
    _build.check("paged_attention", err)
    return out


paged_attention.launches = 0
