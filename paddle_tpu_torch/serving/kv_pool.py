"""Paged KV-cache slot pool — the decode lane's memory allocator (a copy
of ``paddle_tpu/serving/kv_pool.py`` for the fp32 pool, whose device
arrays are torch tensors).

The pool is one persistable program var per (layer, K/V) shaped
``[num_pages, page_size, n_heads, head_dim]``; a sequence's cache is a
LIST of page ids (its page table), not a contiguous slab.  Admission,
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
                 page_size, max_pages_per_seq):
        from paddle_tpu_torch.models.gpt import kv_pool_var_names

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
        self.var_names = kv_pool_var_names(self.num_layers)
        self._free = collections.deque(range(1, self.num_pages))
        self._tables = {}           # seq_id -> [page ids]
        self._ever_used = set()
        self.alloc_total = 0
        self.free_total = 0
        self.reused_allocs = 0

    # -- device tensors -----------------------------------------------------

    def install(self, scope, device):
        """Put zero pool tensors on ``device`` into ``scope``; a pool
        already there with the same shape, dtype and device is kept."""
        shape = (self.num_pages, self.page_size, self.num_heads,
                 self.head_dim)
        device = torch.device(device)
        for kn, vn in self.var_names:
            for name in (kn, vn):
                cur = scope.get(name)
                if (isinstance(cur, torch.Tensor)
                        and tuple(cur.shape) == shape
                        and cur.dtype == torch.float32
                        and cur.device == device):
                    continue
                scope.set(name, torch.zeros(shape, dtype=torch.float32,
                                            device=device))

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
