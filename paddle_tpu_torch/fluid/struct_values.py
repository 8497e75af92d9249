"""Structured run-time values: tensor arrays and LoD rank tables
(counterpart of ``paddle_tpu/fluid/struct_values.py``).

The reference keeps a LOD_TENSOR_ARRAY as a growable vector of tensors
and a LOD_RANK_TABLE as (index, length) items sorted by length,
descending.  Both packages keep static shapes instead, so a plan with
them can still be captured as one CUDA graph:

  TensorArrayVal — a fixed-capacity stacked buffer [cap, ...entry shape]
      and an int32 scalar tensor: one more than the highest index
      written (capped at the capacity).  Both stay on the device: an
      index is never read on the host.
  RankTableVal — dense [B] index and [B] lengths tensors (rows sorted by
      length, descending, stable).

Plain classes, not tuples: the executor treats a tuple a lowering
returns as one value an output slot, and the bf16 policy maps over
list and tuple inputs; both pass these values through untouched.
"""

from __future__ import annotations

import torch

__all__ = ["TensorArrayVal", "RankTableVal", "is_struct_value",
           "struct_select", "struct_clone"]


class TensorArrayVal:
    """Run-time value of a LOD_TENSOR_ARRAY variable."""

    __slots__ = ("buffer", "size")

    def __init__(self, buffer, size):
        self.buffer = buffer  # [cap, ...entry shape]
        self.size = size      # int32 scalar tensor

    @property
    def capacity(self):
        return self.buffer.shape[0]

    def __repr__(self):
        return (f"TensorArrayVal(cap={self.buffer.shape[0]}, "
                f"entry={tuple(self.buffer.shape[1:])}, "
                f"dtype={self.buffer.dtype})")


class RankTableVal:
    """Run-time value of a LOD_RANK_TABLE variable."""

    __slots__ = ("index", "lengths")

    def __init__(self, index, lengths):
        self.index = index      # [B] int32: original row of the j-th item
        self.lengths = lengths  # [B] int32, descending

    def __repr__(self):
        return f"RankTableVal(n={self.index.shape[0]})"


def is_struct_value(v):
    return isinstance(v, (TensorArrayVal, RankTableVal))


def _fields(v):
    return ("buffer", "size") if isinstance(v, TensorArrayVal) \
        else ("index", "lengths")


def struct_clone(v):
    """A copy of ``v`` (a tensor or a structured value) that shares no
    storage with it."""
    if is_struct_value(v):
        return type(v)(*(getattr(v, f).clone() for f in _fields(v)))
    return v.clone()


def struct_select(pred, new, old):
    """``new`` where the scalar bool tensor ``pred`` holds, else ``old``,
    field by field for a structured value; on the device, so a captured
    graph holds it."""
    if is_struct_value(new):
        return type(new)(*(struct_select(pred, getattr(new, f),
                                         getattr(old, f))
                           for f in _fields(new)))
    return torch.where(pred, new, old)
