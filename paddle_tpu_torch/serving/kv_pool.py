"""Paged KV-cache slot pool — the decode lane's memory allocator (a copy
of ``paddle_tpu/serving/kv_pool.py``, whose device arrays are torch
tensors here).

The pool is one persistable program var per (layer, K/V) shaped
``[num_pages, page_size, n_heads, head_dim]`` — or, with
``dtype="int8"``, three: hi/lo int8 of that shape and a per-vector fp32
scale ``[num_pages, page_size, n_heads, 1]`` (the dual-int8 format,
kernels/primitives/int8.py).  A sequence's cache is a LIST of page ids
(its page table), not a contiguous slab.  Admission,
growth and eviction move no cache memory — they edit host-side page
lists — and the decode step stays one fixed-shape program however
sequences come and go.

Page 0 is the TRASH page: never allocated, the write target of inactive
decode slots and padded prefill tails.  Readers cannot observe it —
paged attention masks every position past a row's own length.  Freed
pages are reused LIFO.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from .errors import PoolExhaustedError

__all__ = ["KVPool", "PoolExhaustedError", "TRASH_PAGE"]

TRASH_PAGE = 0


class KVPool:
    """Host-side page allocator + the device-resident pool vars.
    ``num_pages`` INCLUDES the trash page."""

    def __init__(self, num_layers, num_heads, head_dim, num_pages,
                 page_size, max_pages_per_seq, dtype="float32",
                 prefix=None):
        from paddle_tpu_torch.models.gpt import (KV_POOL_PREFIX,
                                                 kv_pool_quant_var_names,
                                                 kv_pool_var_names)

        if num_pages - 1 < max_pages_per_seq:
            raise ValueError(
                f"KV pool of {num_pages} pages (1 reserved for trash) "
                f"cannot hold one full sequence of {max_pages_per_seq} "
                f"pages — raise num_pages or lower max_len")
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_pages_per_seq = int(max_pages_per_seq)
        self.dtype = dtype
        self.prefix = KV_POOL_PREFIX if prefix is None else prefix
        self.var_names = kv_pool_var_names(self.num_layers, self.prefix)
        self.quant_var_names = (
            kv_pool_quant_var_names(self.num_layers, self.prefix)
            if dtype == "int8" else None)
        self._free = collections.deque(range(1, self.num_pages))
        self._tables = {}           # seq_id -> [page ids]
        self._ever_used = set()
        self.alloc_total = 0
        self.free_total = 0
        self.reused_allocs = 0

    # -- device tensors -----------------------------------------------------

    def _vars(self):
        """(name, shape, torch dtype) of every pool var."""
        shape = (self.num_pages, self.page_size, self.num_heads,
                 self.head_dim)
        if self.dtype == "int8":
            return [(nm, shp, dt)
                    for layer in self.quant_var_names
                    for hi, lo, sc in layer
                    for nm, shp, dt in ((hi, shape, torch.int8),
                                        (lo, shape, torch.int8),
                                        (sc, shape[:-1] + (1,),
                                         torch.float32))]
        dt = getattr(torch, self.dtype)
        return [(nm, shape, dt) for pair in self.var_names for nm in pair]

    def install(self, scope, device):
        """Put zero pool tensors on ``device`` into ``scope``; a pool
        already there with the same shape, dtype and device is kept (and
        one of another dtype replaced, or every later write would trip
        the dtype guard)."""
        device = torch.device(device)
        for name, shape, dt in self._vars():
            cur = scope.get(name)
            if (isinstance(cur, torch.Tensor) and tuple(cur.shape) == shape
                    and cur.dtype == dt and cur.device == device):
                continue
            scope.set(name, torch.zeros(shape, dtype=dt, device=device))

    # -- modeled bytes ------------------------------------------------------

    def modeled_bytes(self):
        """Device bytes of the resident pool across all layers and both
        K/V: dual-int8 accounting (a scale block per head_dim vector)
        when dtype == 'int8', dtype-width bytes otherwise."""
        n_elems = (self.num_pages * self.page_size * self.num_heads
                   * self.head_dim)
        if self.dtype == "int8":
            from paddle_tpu_torch.kernels.primitives import int8 as _int8

            per_var = _int8.dual_int8_bytes(n_elems, self.head_dim)
        else:
            per_var = n_elems * getattr(torch, self.dtype).itemsize
        return per_var * 2 * self.num_layers

    def modeled_bytes_fp32(self):
        """The same pool's bytes at fp32 — the denominator of the int8
        saving."""
        n_elems = (self.num_pages * self.page_size * self.num_heads
                   * self.head_dim)
        return n_elems * 4 * 2 * self.num_layers

    # -- allocation ---------------------------------------------------------

    def open_seq(self, seq_id):
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already open")
        self._tables[seq_id] = []

    def ensure_capacity(self, seq_id, n_tokens):
        """Grow ``seq_id``'s page table to cover ``n_tokens`` positions;
        raises PoolExhaustedError when the free list runs dry."""
        table = self._tables[seq_id]
        need = -(-int(n_tokens) // self.page_size)
        if need > self.max_pages_per_seq:
            raise ValueError(
                f"sequence {seq_id!r} needs {need} pages for {n_tokens} "
                f"tokens, above max_pages_per_seq={self.max_pages_per_seq}")
        while len(table) < need:
            if not self._free:
                raise PoolExhaustedError(
                    f"KV pool out of pages: sequence {seq_id!r} needs "
                    f"{need - len(table)} more (of {need}) but 0 of "
                    f"{self.num_pages - 1} allocatable pages are free — "
                    f"evict a sequence or grow the pool")
            page = self._free.pop()
            if page in self._ever_used:
                self.reused_allocs += 1
            self._ever_used.add(page)
            self.alloc_total += 1
            table.append(page)
        return table

    def free_seq(self, seq_id):
        """Return every page of ``seq_id`` to the free list (LIFO)."""
        pages = self._tables.pop(seq_id, [])
        for p in reversed(pages):
            self._free.append(p)
        self.free_total += len(pages)
        return len(pages)

    # -- views --------------------------------------------------------------

    def table(self, seq_id):
        return list(self._tables[seq_id])

    def pages_in_use(self):
        return (self.num_pages - 1) - len(self._free)

    def padded_table(self, seq_id=None):
        """One row of the decode feed: the sequence's page table padded
        with the trash page (all-trash when seq_id is None)."""
        row = np.full(self.max_pages_per_seq, TRASH_PAGE, np.int32)
        if seq_id is not None:
            pages = self._tables[seq_id]
            row[:len(pages)] = pages
        return row

    def stats(self):
        return {
            "pages_total": self.num_pages - 1,
            "pages_in_use": self.pages_in_use(),
            "page_size": self.page_size,
            "live_seqs": len(self._tables),
            "alloc_total": self.alloc_total,
            "free_total": self.free_total,
            "reused_allocs": self.reused_allocs,
        }
