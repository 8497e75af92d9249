"""Decode-lane ops: paged KV-cache writes + paged attention (counterpart
of ``paddle_tpu/ops/decode_ops.py``).

  kv_cache_write        scatter ONE new token's K or V rows into the
                        pool at per-slot (page, offset) coordinates
  kv_cache_write_pages  scatter a prefill chunk's K or V (whole pages)
                        into the pool
  paged_attention       read the pool through a per-sequence page table
                        (kernels/primitives/paged.py, K5)

Where the port differs from the JAX package: JAX arrays are immutable,
so there the writes return a new pool and XLA donates the old buffer.
Here the two writes update the scope's pool tensor IN PLACE
(``index_put_`` with ``accumulate=False``) and return that same tensor,
so a step never copies or reallocates the pool.

Dtype contract: the pool's dtype is stamped at creation and the writes
refuse a payload of another dtype, naming both.
"""

from __future__ import annotations

from paddle_tpu_torch.fluid.registry import simple_op
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
    page_size = pages.shape[1]
    c = new.shape[0]
    if c % page_size:
        raise ValueError(
            f"kv_cache_write_pages: chunk length {c} is not a multiple of "
            f"the pool page size {page_size} — the prefill chunk must cover "
            f"whole pages")
    blocks = new.reshape(c // page_size, page_size, *new.shape[1:])
    pages.index_put_((page_idx.long(),), blocks, accumulate=False)
    return pages


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
