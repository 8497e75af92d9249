"""Tensor-array and rank-table ops on the fixed-capacity dense encoding
(counterpart of ``paddle_tpu/ops/tensor_array_ops.py``; the values are
fluid/struct_values.py's).

An array is a [cap, ...] buffer and a size, a rank table dense index and
length vectors; a write makes a new buffer with the entry copied in
(``index_copy``), a read selects one (``index_select``).  Indices stay
on the device; a negative one counts from the end and then each is
clamped to [0, cap), as ``lax``'s dynamic index ops do (torch indexing
would raise): a write past the capacity lands on the last slot, and the
size never passes the capacity.  So a
plan of these ops is captured with the rest.

The JAX package's deviations from the reference hold here too
(PARITY.md): the entries of one array share a shape; a first
``write_to_array`` makes a buffer of ``capacity`` entries (attr, default
128), ``lod_tensor_to_array`` one of the input's T; the rank-table
pipeline keeps all B rows in each entry, and ``array_to_lod_tensor``
zeroes the positions past each row's length.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.fluid.registry import simple_op
from paddle_tpu_torch.fluid.struct_values import RankTableVal, TensorArrayVal

DEFAULT_CAPACITY = 128


def _slot(i, cap):
    """[1] int64 slot of index ``i``: a negative index counts from the
    end, then the index is clamped to [0, cap), as ``lax``'s dynamic
    index ops do."""
    i = i.reshape(1).long()
    return torch.where(i < 0, i + cap, i).clamp(0, cap - 1)


@simple_op("write_to_array", ["X", "I", "Array"], ["Out"],
           optional=("Array",), grad=None)
def _write_to_array(ctx, x, i, arr, attrs):
    """Out[i] = X.  ``Array`` is the array's value so far, absent at
    the first write, which makes the buffer."""
    if not isinstance(arr, TensorArrayVal):
        cap = int(attrs.get("capacity", 0)) or DEFAULT_CAPACITY
        arr = TensorArrayVal(
            torch.zeros((cap,) + tuple(x.shape), dtype=x.dtype,
                        device=x.device),
            torch.zeros((), dtype=torch.int32, device=x.device))
    cap = arr.buffer.shape[0]
    buf = arr.buffer.index_copy(0, _slot(i, cap),
                                x.to(arr.buffer.dtype).unsqueeze(0))
    end = i.reshape(()).to(torch.int32) + 1
    return TensorArrayVal(buf, torch.clamp(torch.maximum(arr.size, end),
                                           max=cap))


@simple_op("read_from_array", ["X", "I"], ["Out"], grad=None)
def _read_from_array(ctx, arr, i, attrs):
    return torch.index_select(arr.buffer, 0,
                              _slot(i, arr.buffer.shape[0])).squeeze(0)


@simple_op("lod_array_length", ["X"], ["Out"], grad=None)
def _lod_array_length(ctx, arr, attrs):
    return arr.size.reshape(1).to(torch.int64)


@simple_op("lod_rank_table", ["X", "Length"], ["Out"],
           optional=("Length",), grad=None)
def _lod_rank_table(ctx, x, length, attrs):
    """Rows sorted by length, descending and stable; the lengths come
    from ``Length`` (the dense ragged convention), else every row spans
    X's time axis."""
    b = x.shape[0]
    if length is None:
        t = x.shape[1] if x.dim() > 1 else 1
        lengths = torch.full((b,), t, dtype=torch.int32, device=x.device)
    else:
        lengths = length.reshape(-1).to(torch.int32)
    order = torch.argsort(-lengths, stable=True)
    return RankTableVal(order.to(torch.int32), lengths[order])


@simple_op("max_sequence_len", ["RankTable"], ["Out"], grad=None)
def _max_sequence_len(ctx, table, attrs):
    return table.lengths[:1].to(torch.int64)


@simple_op("lod_tensor_to_array", ["X", "RankTable"], ["Out"], grad=None)
def _lod_tensor_to_array(ctx, x, table, attrs):
    """[B, T, ...] -> an array of T entries; entry t holds every row at
    time t, in rank-table order.  Size: the longest length."""
    rows = torch.index_select(x, 0, table.index.long())
    return TensorArrayVal(rows.movedim(1, 0).contiguous(),
                          table.lengths[0].to(torch.int32))


@simple_op("array_to_lod_tensor", ["X", "RankTable"], ["Out"], grad=None)
def _array_to_lod_tensor(ctx, arr, table, attrs):
    """lod_tensor_to_array's inverse: [B, T, ...] in the original row
    order, zero at and past each row's length."""
    bt = arr.buffer.movedim(0, 1)                    # [B, T, ...] sorted
    b, t = bt.shape[0], bt.shape[1]
    idx = table.index.long()
    inv = torch.zeros(b, dtype=torch.long, device=bt.device).scatter(
        0, idx, torch.arange(b, device=bt.device))
    out = torch.index_select(bt, 0, inv)
    lengths = torch.zeros(b, dtype=torch.int32, device=bt.device).scatter(
        0, idx, table.lengths)
    mask = torch.arange(t, device=bt.device)[None, :] < lengths[:, None]
    mask = mask.reshape(mask.shape + (1,) * (out.dim() - 2))
    return torch.where(mask, out, torch.zeros_like(out))


@simple_op("shrink_rnn_memory", ["X", "I", "RankTable"], ["Out"], grad=None)
def _shrink_rnn_memory(ctx, x, i, table, attrs):
    """The identity: the dense encoding keeps every row (finished rows
    are masked at array_to_lod_tensor)."""
    return x


def _row_mask(mask, like):
    m = mask.reshape(-1).bool()
    return m.reshape((like.shape[0],) + (1,) * (like.dim() - 1))


@simple_op("split_lod_tensor", ["X", "Mask"], ["OutTrue", "OutFalse"],
           grad=None, no_grad_inputs=("Mask",))
def _split_lod_tensor(ctx, x, mask, attrs):
    """Both outputs keep X's shape, the other branch's rows zeroed."""
    m = _row_mask(mask, x)
    z = torch.zeros_like(x)
    return torch.where(m, x, z), torch.where(m, z, x)


@simple_op("merge_lod_tensor", ["X", "Mask", "InTrue", "InFalse"], ["Out"],
           grad=None, no_grad_inputs=("Mask", "X"), optional=("X",))
def _merge_lod_tensor(ctx, x, mask, in_true, in_false, attrs):
    return torch.where(_row_mask(mask, in_true), in_true, in_false)


@simple_op("tensor_array_to_tensor", ["X"], ["Out", "OutIndex"], grad=None)
def _tensor_array_to_tensor(ctx, arr, attrs):
    """Every entry (the whole capacity: entries past the size are zero)
    concatenated along ``axis``, or stacked with ``use_stack``; OutIndex
    holds each entry's extent along the axis."""
    axis = int(attrs.get("axis", 0))
    buf = arr.buffer
    cap = buf.shape[0]
    if attrs.get("use_stack", False):
        return (buf.movedim(0, axis),
                torch.ones(cap, dtype=torch.int32, device=buf.device))
    out = torch.cat(list(torch.unbind(buf, 0)), dim=axis)
    return out, torch.full((cap,), buf.shape[1:][axis], dtype=torch.int32,
                           device=buf.device)
