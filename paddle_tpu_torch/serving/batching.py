"""Shape-bucketed continuous batching: the scheduler-side data plane
(a copy of ``paddle_tpu/serving/batching.py``).

Every formed batch is padded up to the smallest configured row bucket
(and, for feeds with a dynamic dim 1, the smallest sequence bucket), so
a small fixed set of shapes serves every request mix.  In the JAX
package each shape is one compiled executable; in the eager port a
fixed shape set keeps the kernels' launch shapes and the caching
allocator's block sizes fixed, and the engine's warm/cold bookkeeping
reads "cold" as the first run of a shape.

This module is the pure data plane: bucket selection, batch assembly
(concatenate + zero-pad), and output row-splitting.  Queueing, futures,
threads and metrics live in `engine`.
"""

from __future__ import annotations

import time

import numpy as np

__all__ = ["BucketPolicy", "Request", "assemble_batch", "split_outputs"]


def _norm_buckets(spec):
    """'1,2,4,8' (tolerates spaces) or an int iterable -> sorted unique
    positive ints; zero/negative sizes raise on BOTH input forms."""
    if isinstance(spec, str):
        vals = [int(tok) for tok in spec.split(",") if tok.strip()]
    else:
        vals = [int(v) for v in spec]
    for v in vals:
        if v <= 0:
            raise ValueError(f"bucket sizes must be positive, got {v}")
    return tuple(sorted(set(vals)))


class BucketPolicy:
    """The bucket set one engine serves: row (batch) buckets plus
    optional sequence-length buckets for dynamic dim-1 feeds.

    Defaults come from FLAGS_serving_batch_buckets /
    FLAGS_serving_seq_buckets at construction time (not import time, so
    `set_flags` before building an Engine behaves as expected)."""

    def __init__(self, batch_buckets=None, seq_buckets=None):
        from paddle_tpu_torch.fluid import flags as _flags

        if batch_buckets is None:
            batch_buckets = _flags.flag("serving_batch_buckets")
        if seq_buckets is None:
            seq_buckets = _flags.flag("serving_seq_buckets")
        self.batch_buckets = _norm_buckets(batch_buckets)
        if not self.batch_buckets:
            raise ValueError("serving needs at least one batch bucket")
        self.seq_buckets = _norm_buckets(seq_buckets)

    @property
    def max_rows(self):
        return self.batch_buckets[-1]

    def batch_bucket(self, rows):
        """Smallest row bucket >= rows; None when rows exceed the largest
        (the caller rejects — a request bigger than the largest bucket
        would mint a new executable per size, defeating the design)."""
        for b in self.batch_buckets:
            if rows <= b:
                return b
        return None

    def seq_bucket(self, length):
        """Smallest sequence bucket >= length.  Lengths beyond the
        largest bucket pass through unpadded (they compile on demand and
        the engine counts them as cold work — visible, not silently
        truncated)."""
        for b in self.seq_buckets:
            if length <= b:
                return b
        return int(length)

    def describe(self):
        return {"batch": list(self.batch_buckets),
                "seq": list(self.seq_buckets)}


class Request:
    """One caller's unit of work: a feed dict of numpy arrays sharing a
    leading row dim, a future the engine resolves, and the arrival time
    the latency metric is measured from."""

    __slots__ = ("feed", "rows", "tenant", "future", "t_arrival",
                 "shape_key", "seq_pad", "deadline")

    def __init__(self, feed, rows, tenant, future, shape_key,
                 seq_pad=None, deadline_s=0.0):
        self.feed = feed
        self.rows = rows
        self.tenant = tenant
        self.future = future
        self.t_arrival = time.monotonic()
        # absolute monotonic deadline (FLAGS_serving_deadline_ms): a
        # request older than this resolves ServingDeadlineError instead
        # of waiting forever, queued or in flight; None = no deadline
        self.deadline = (self.t_arrival + deadline_s
                         if deadline_s and deadline_s > 0 else None)
        # trailing-dims signature AFTER sequence padding: only requests
        # with equal keys can share a batch (concat needs it, and the
        # padded batch must land in one executable signature)
        self.shape_key = shape_key
        # {padded_len: orig_len} for the dim-1 sequence padding this
        # request's dynamic feeds received — the engine slices a
        # dynamic-dim-1 output whose length matches a padded_len back
        # to its orig_len so padding positions never reach the caller;
        # None when nothing was padded
        self.seq_pad = seq_pad


def _pad_axis0(arr, target_rows):
    rows = arr.shape[0]
    if rows == target_rows:
        return arr
    pad = np.zeros((target_rows - rows, *arr.shape[1:]), dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def pad_seq(arr, target_len):
    """Zero-pad dim-1 up to target_len (no-op when already there)."""
    if arr.ndim < 2 or arr.shape[1] == target_len:
        return arr
    if arr.shape[1] > target_len:
        raise ValueError(
            f"cannot pad dim-1 of {arr.shape} down to {target_len}")
    pad_shape = (arr.shape[0], target_len - arr.shape[1], *arr.shape[2:])
    return np.concatenate(
        [arr, np.zeros(pad_shape, dtype=arr.dtype)], axis=1)


def assemble_batch(requests, bucket_rows):
    """Concatenate same-shape-key requests along axis 0 and zero-pad up
    to `bucket_rows`.  Returns (feed, row_slices) where row_slices[i] is
    the (start, stop) of request i's rows in every batch array.

    Requests must already carry sequence-padded arrays (the engine pads
    per request at submit so the shape_key is settled before grouping).
    """
    if not requests:
        raise ValueError("empty batch")
    names = list(requests[0].feed)
    slices, start = [], 0
    for r in requests:
        slices.append((start, start + r.rows))
        start += r.rows
    if start > bucket_rows:
        raise ValueError(
            f"batch of {start} rows exceeds bucket {bucket_rows}")
    feed = {}
    for n in names:
        arr = (requests[0].feed[n] if len(requests) == 1
               else np.concatenate([r.feed[n] for r in requests], axis=0))
        feed[n] = _pad_axis0(np.asarray(arr), bucket_rows)
    return feed, slices


def split_outputs(outputs, slices, seq_pads=None, dyn_seq=()):
    """Slice each request's rows back out of the batch outputs.
    outputs: {name: array [bucket_rows, ...]}; returns a list (one dict
    per request) in `slices` order — padding rows never escape.  Rows
    are copied, not viewed: a caller retaining one small result must
    not pin the whole bucket-sized batch array.

    seq_pads: optional per-request ``{padded_len: orig_len}`` mappings
    (one entry per slice, None allowed).  Outputs named in `dyn_seq`
    whose dim-1 equals a padded length are sliced back to the original
    length in the SAME copy — one allocation at the final shape, never
    a padded-width copy followed by a second slice copy."""
    out = []
    for i, (start, stop) in enumerate(slices):
        pad = seq_pads[i] if seq_pads else None
        per = {}
        for n, v in outputs.items():
            base = np.asarray(v)
            a = base[start:stop]
            if pad and n in dyn_seq and a.ndim >= 2 and a.shape[1] in pad:
                a = a[:, :pad[a.shape[1]]]
            # the copy exists so a retained small result can't pin the
            # bucket-sized batch array — when the slice IS the whole
            # array it pins nothing and the memcpy is pure waste; copy
            # unless the view is already writable, so every result is
            # writable
            per[n] = a if (a.size == base.size
                           and a.flags.writeable) else a.copy()
        out.append(per)
    return out
