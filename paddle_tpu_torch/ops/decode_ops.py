"""Decode-lane ops: paged KV-cache writes + paged attention (counterpart
of ``paddle_tpu/ops/decode_ops.py``).

  kv_cache_write        scatter ONE new token's K or V rows into the
                        pool at per-slot (page, offset) coordinates
  kv_cache_write_pages  scatter a prefill chunk's K or V (whole pages)
                        into the pool
  paged_attention       read the pool through a per-sequence page table
                        (kernels/primitives/paged.py, K5)

and their int8-pool forms (``kv_cache_write_quant``,
``kv_cache_write_pages_quant``, ``paged_attention_quant``): the pool
rides as three vars per K/V — hi/lo int8 [P, page, n, d] and a
per-vector fp32 scale [P, page, n, 1] (primitives/int8.py
``quantize_lastdim``).  Quantization happens once, at append, in plain
PyTorch (the JAX package's writes are plain XLA too); the reader, K7,
dequantises inside the kernel.

Where the port differs from the JAX package: JAX arrays are immutable,
so there the writes return a new pool and XLA donates the old buffer.
Here the two writes update the scope's pool tensor IN PLACE
(``index_put_`` with ``accumulate=False``) and return that same tensor,
so a step never copies or reallocates the pool.

Dtype contract: the pool's dtype is stamped at creation and the writes
refuse a payload of another dtype, naming both.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.fluid.registry import simple_op
from paddle_tpu_torch.kernels.primitives import int8 as _int8
from paddle_tpu_torch.kernels.primitives import paged as _paged


def _check_pool_dtype(op, pages, new):
    if pages.dtype != new.dtype:
        raise ValueError(
            f"{op}: payload dtype {new.dtype} does not match the KV pool "
            f"dtype {pages.dtype} — cast the K/V to the pool dtype before "
            f"the write")


@simple_op("kv_cache_write", ["Pages", "New", "PageIdx", "Offset"],
           ["PagesOut"], grad=None, inplace={"PagesOut": "Pages"})
def _kv_cache_write(ctx, pages, new, page_idx, offset, attrs):
    """One decode step's write: new [B, n, d] lands at
    pages[page_idx[b], offset[b]] per slot b.  Inactive slots point at
    the pool's trash page (page 0); duplicate trash coordinates are
    benign — nothing ever attends them."""
    _check_pool_dtype("kv_cache_write", pages, new)
    pages.index_put_((page_idx.long(), offset.long()), new,
                     accumulate=False)
    return pages


@simple_op("kv_cache_write_pages", ["Pages", "New", "PageIdx"],
           ["PagesOut"], grad=None, inplace={"PagesOut": "Pages"})
def _kv_cache_write_pages(ctx, pages, new, page_idx, attrs):
    """One prefill chunk's write: new [C, n, d] (C a multiple of the page
    size) viewed as C/page_size whole pages, scattered to
    pages[page_idx].  Pages past the chunk's valid tail carry the trash
    page id."""
    _check_pool_dtype("kv_cache_write_pages", pages, new)
    blocks = _as_pages("kv_cache_write_pages", new, pages.shape[1])
    pages.index_put_((page_idx.long(),), blocks, accumulate=False)
    return pages


def _as_pages(op, new, page_size):
    """new [C, ...] viewed as C/page_size whole pages."""
    c = new.shape[0]
    if c % page_size:
        raise ValueError(
            f"{op}: chunk length {c} is not a multiple of the pool page "
            f"size {page_size} — the prefill chunk must cover whole pages")
    return new.reshape(c // page_size, page_size, *new.shape[1:])


@simple_op("paged_attention",
           ["Q", "KPages", "VPages", "PageTable", "QStart"], ["Out"],
           grad=None)
def _paged_attention(ctx, q, k_pages, v_pages, page_table, q_start,
                     attrs):
    """Attention of q [B, n, T, d] against the pool through the page
    table (K5; attrs["force"] = "reference" pins the plain version)."""
    return _paged.paged_attention(
        q.contiguous(), k_pages, v_pages, page_table.int().contiguous(),
        q_start.int().contiguous(), sm_scale=attrs.get("sm_scale"),
        force=attrs.get("force"))


# ---------------------------------------------------------------------------
# the int8 pool: quantize once at append, dequantise inside K7
# ---------------------------------------------------------------------------


def _quantize_payload(op, hi, new):
    if hi.dtype != torch.int8:
        raise ValueError(
            f"{op}: Hi pool dtype {hi.dtype} != int8 — the quant write ops "
            f"only serve an int8 pool (KVPool(dtype='int8'))")
    return _int8.quantize_lastdim(new.float())


@simple_op("kv_cache_write_quant",
           ["Hi", "Lo", "Scale", "New", "PageIdx", "Offset"],
           ["HiOut", "LoOut", "ScaleOut"], grad=None,
           inplace={"HiOut": "Hi", "LoOut": "Lo", "ScaleOut": "Scale"})
def _kv_cache_write_quant(ctx, hi, lo, scale, new, page_idx, offset,
                          attrs):
    """kv_cache_write for the int8 pool: quantize new [B, n, d] per
    (slot, head) vector and write hi/lo/scale at (page_idx[b],
    offset[b]), in place.  Same trash-page semantics as the fp write."""
    q_hi, q_lo, q_sc = _quantize_payload("kv_cache_write_quant", hi, new)
    idx = (page_idx.long(), offset.long())
    for pool, val in ((hi, q_hi), (lo, q_lo), (scale, q_sc)):
        pool.index_put_(idx, val, accumulate=False)
    return hi, lo, scale


@simple_op("kv_cache_write_pages_quant",
           ["Hi", "Lo", "Scale", "New", "PageIdx"],
           ["HiOut", "LoOut", "ScaleOut"], grad=None,
           inplace={"HiOut": "Hi", "LoOut": "Lo", "ScaleOut": "Scale"})
def _kv_cache_write_pages_quant(ctx, hi, lo, scale, new, page_idx, attrs):
    """kv_cache_write_pages for the int8 pool: quantize the chunk
    [C, n, d] per vector and write whole pages of hi/lo/scale, in
    place."""
    q_hi, q_lo, q_sc = _quantize_payload("kv_cache_write_pages_quant", hi,
                                         new)
    idx = (page_idx.long(),)
    page_size = hi.shape[1]
    for pool, val in ((hi, q_hi), (lo, q_lo), (scale, q_sc)):
        pool.index_put_(idx, _as_pages("kv_cache_write_pages_quant", val,
                                       page_size), accumulate=False)
    return hi, lo, scale


@simple_op("paged_attention_quant",
           ["Q", "KHi", "KLo", "KScale", "VHi", "VLo", "VScale",
            "PageTable", "QStart"], ["Out"], grad=None)
def _paged_attention_quant(ctx, q, k_hi, k_lo, k_scale, v_hi, v_lo,
                           v_scale, page_table, q_start, attrs):
    """paged_attention over the dual-int8 pool (K7; attrs["force"] =
    "reference" pins the plain version)."""
    return _paged.paged_attention_quant(
        q.contiguous(), k_hi, k_lo, k_scale, v_hi, v_lo, v_scale,
        page_table.int().contiguous(), q_start.int().contiguous(),
        sm_scale=attrs.get("sm_scale"), force=attrs.get("force"))
