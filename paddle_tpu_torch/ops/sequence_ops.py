"""Sequence op lowerings (counterpart of ``paddle_tpu/ops/sequence_ops.py``).

The reference's sequence ops consume LoD tensors; here, as in the JAX
package, a sequence batch is padded dense [B, T, D] with an optional
``Length`` int tensor [B], and the ops mask the positions at or past a
row's length.  Every op is made of fixed-shape tensor ops (gathers and
``where``s over index tensors, no host reads of a length), so a program
of them captures as one CUDA graph.  Every grad is derived by the
registry; ``sequence_pool``'s MAX reduces with ``amax``, whose grad
splits a row's grad equally among tied maxima, as ``jnp.max``'s does.
"""

from __future__ import annotations

import math

import torch

from paddle_tpu_torch.fluid.registry import simple_op

from .common import length_mask, mxu_dot, np_dtype, rounded


def _time_mask(x, length):
    """[B, T] mask in ``x``'s dtype from lengths [B]; None → None."""
    if length is None:
        return None
    return length_mask(length, x.shape[1]).to(x.dtype)


def _trail(idx, x):
    """``idx`` [B, T] with a size-1 dim for each of ``x``'s dims past the
    second, expanded to ``x``'s trailing extents (a gather index)."""
    return idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        tuple(idx.shape) + tuple(x.shape[2:]))


def _seq_unfold(x, length, attrs):
    """Context-window im2col over time: [B, T, D] → [B, T, ctx_len*D].
    contextStart defaults to -(ctx_len-1)/2 (a centered window)."""
    ctx_len = int(attrs.get("contextLength", 3))
    ctx_start = int(attrs.get("contextStart", -((ctx_len - 1) // 2)))
    t = x.shape[1]
    if length is not None:
        x = x * _time_mask(x, length)[:, :, None]
    xp = torch.nn.functional.pad(
        x, (0, 0, -ctx_start, ctx_len - 1 + ctx_start))
    return torch.cat([xp[:, i:i + t, :] for i in range(ctx_len)], dim=-1)


@simple_op("sequence_conv", ["X", "Filter", "Length"], ["Out"],
           optional=("Length",), no_grad_inputs=("Length",))
def _sequence_conv(ctx, x, w, length, attrs):
    """Context-window conv over time.  x: [B, T, D]; Filter:
    [ctx_len * D, num_filters]."""
    return mxu_dot(_seq_unfold(x, length, attrs), w)


def _neg_fill(dtype):
    """The value masked steps take before a MAX pool (the JAX package's:
    -1e38, -3e38 in bf16)."""
    return -3e38 if dtype == torch.bfloat16 else -1e38


@simple_op("sequence_pool", ["X", "Length"], ["Out", "MaxIndex"],
           optional=("Length",), no_grad_inputs=("Length",))
def _sequence_pool(ctx, x, length, attrs):
    """Pool over the time axis: [B, T, D] → [B, D].  pooltype:
    AVERAGE/SUM/SQRT/MAX/LAST/FIRST.  ``MaxIndex`` is None, as in the
    JAX package."""
    ptype = attrs.get("pooltype", "AVERAGE").upper()
    mask = _time_mask(x, length)
    if mask is None:
        if ptype == "AVERAGE":
            return x.mean(dim=1), None
        if ptype == "SUM":
            return x.sum(dim=1), None
        if ptype == "SQRT":
            return x.sum(dim=1) / rounded(math.sqrt(x.shape[1]),
                                          x.dtype), None
        if ptype == "MAX":
            return x.amax(dim=1), None
        if ptype == "LAST":
            return x[:, -1, :], None
        if ptype == "FIRST":
            return x[:, 0, :], None
        raise ValueError(f"unknown pooltype {ptype}")
    m3 = mask[:, :, None]
    n = torch.clamp_min(mask.sum(dim=1, keepdim=True), 1.0)
    if ptype == "AVERAGE":
        return (x * m3).sum(dim=1) / n, None
    if ptype == "SUM":
        return (x * m3).sum(dim=1), None
    if ptype == "SQRT":
        return (x * m3).sum(dim=1) / torch.sqrt(n), None
    if ptype == "MAX":
        return torch.where(m3 > 0, x, _neg_fill(x.dtype)).amax(dim=1), None
    if ptype == "LAST":
        idx = torch.clamp_min(mask.sum(dim=1).long() - 1, 0)
        idx = idx[:, None, None].expand(-1, 1, x.shape[2])
        return x.gather(1, idx)[:, 0, :], None
    if ptype == "FIRST":
        return x[:, 0, :], None
    raise ValueError(f"unknown pooltype {ptype}")


@simple_op("sequence_softmax", ["X", "Length"], ["Out"],
           optional=("Length",), no_grad_inputs=("Length",))
def _sequence_softmax(ctx, x, length, attrs):
    """Softmax over time with padding masked out.  x: [B, T] or
    [B, T, 1]."""
    squeeze = x.dim() == 3
    v = x[..., 0] if squeeze else x
    if length is not None:
        m = length_mask(length, v.shape[1])
        v = torch.where(m, v, -1e38)
    out = torch.softmax(v, dim=-1)
    if length is not None:
        out = torch.where(m, out, 0.0)
    return out[..., None] if squeeze else out


@simple_op("sequence_expand", ["X", "Y"], ["Out"], no_grad_inputs=("Y",))
def _sequence_expand(ctx, x, y, attrs):
    """x tiled along a new time axis to y's time extent: [B, D] →
    [B, T, D]."""
    return x[:, None, :].expand(x.shape[0], y.shape[1], x.shape[1])


# In the dense representation sequence_expand_as and sequence_expand are
# the same tiling.
simple_op("sequence_expand_as", ["X", "Y"], ["Out"],
          no_grad_inputs=("Y",))(_sequence_expand)


def reverse_valid(x, length):
    """Each row's valid prefix reversed along time (padding stays at the
    tail): a gather, not a flip, where lengths are given."""
    if length is None:
        return torch.flip(x, dims=(1,))
    ar = torch.arange(x.shape[1], device=x.device)[None, :]
    ln = length.reshape(-1, 1).long()
    idx = torch.where(ar < ln, ln - 1 - ar, ar)
    return x.gather(1, _trail(idx, x))


@simple_op("sequence_reverse", ["X", "Length"], ["Out"],
           optional=("Length",), no_grad_inputs=("Length",))
def _sequence_reverse(ctx, x, length, attrs):
    return reverse_valid(x, length)


@simple_op("sequence_last_step", ["X", "Length"], ["Out"],
           optional=("Length",), no_grad_inputs=("Length",))
def _sequence_last_step(ctx, x, length, attrs):
    return _sequence_pool(ctx, x, length, {"pooltype": "LAST"})[0]


@simple_op("sequence_first_step", ["X", "Length"], ["Out"],
           optional=("Length",), no_grad_inputs=("Length",))
def _sequence_first_step(ctx, x, length, attrs):
    return _sequence_pool(ctx, x, length, {"pooltype": "FIRST"})[0]


@simple_op("sequence_mask", ["X"], ["Y"], grad=None)
def _sequence_mask(ctx, x, attrs):
    """lengths [B] → mask [B, maxlen] in ``out_dtype``."""
    return length_mask(x, int(attrs.get("maxlen", -1))).to(
        np_dtype(attrs.get("out_dtype", "float32")))


@simple_op("sequence_pad", ["X", "PadValue", "Length"], ["Out", "OutLength"],
           optional=("Length",), no_grad_inputs=("PadValue", "Length"))
def _sequence_pad(ctx, x, pad_value, length, attrs):
    """The identity in the padded-dense representation (data arrives
    padded), with the lengths beside it (T for every row without
    them)."""
    if length is None:
        length = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                            device=x.device)
    return x, length


@simple_op("sequence_unpad", ["X", "Length"], ["Out"],
           no_grad_inputs=("Length",))
def _sequence_unpad(ctx, x, length, attrs):
    """The padding tail zeroed, so later reductions see only valid
    positions (the dense layout keeps [B, T, ...])."""
    m = _time_mask(x, length)
    return x * m.reshape(tuple(m.shape) + (1,) * (x.dim() - 2))


@simple_op("sequence_concat", ["X*", "Length*"], ["Out", "OutLength"],
           optional=("Length",), no_grad_inputs=("Length",))
def _sequence_concat(ctx, xs, lengths, attrs):
    """Row-wise concat of valid prefixes: out row b = x1[b, :len1],
    x2[b, :len2], ... then padding.  Without lengths, a plain time-axis
    concat."""
    b = xs[0].shape[0]
    if not lengths:
        out = torch.cat(xs, dim=1)
        return out, torch.full((b,), out.shape[1], dtype=torch.int32,
                               device=out.device)
    t_out = sum(int(x.shape[1]) for x in xs)
    pos = torch.arange(t_out, device=xs[0].device)[None, :]
    out = torch.zeros((b, t_out) + tuple(xs[0].shape[2:]),
                      dtype=xs[0].dtype, device=xs[0].device)
    offset = torch.zeros((b, 1), dtype=torch.int32, device=xs[0].device)
    for x, ln in zip(xs, lengths):
        ln = ln.reshape(-1).to(torch.int32)
        rel = pos - offset
        valid = (rel >= 0) & (rel < ln[:, None])
        idx = torch.clamp(rel, 0, x.shape[1] - 1).long()
        gathered = x.gather(1, _trail(idx, x))
        v = valid.reshape(tuple(valid.shape) + (1,) * (x.dim() - 2))
        out = torch.where(v, gathered, out)
        offset = offset + ln[:, None]
    return out, offset[:, 0]


@simple_op("sequence_slice", ["X", "Offset", "Length"], ["Out"],
           no_grad_inputs=("Offset", "Length"))
def _sequence_slice(ctx, x, offset, length, attrs):
    """Per-row time window: row b keeps x[b, offset_b : offset_b +
    length_b] left-aligned, the rest zero (a window reaching past the
    time extent zero-fills)."""
    t = x.shape[1]
    off = offset.reshape(-1).long()
    ln = length.reshape(-1).long()
    pos = torch.arange(t, device=x.device)[None, :]
    src = torch.clamp(pos + off[:, None], 0, t - 1)
    valid = (pos < ln[:, None]) & (pos + off[:, None] < t)
    gathered = x.gather(1, _trail(src, x))
    v = valid.reshape(tuple(valid.shape) + (1,) * (x.dim() - 2))
    return torch.where(v, gathered, torch.zeros_like(gathered))


@simple_op("sequence_enumerate", ["X", "Length"], ["Out"],
           optional=("Length",), grad=None)
def _sequence_enumerate(ctx, x, length, attrs):
    """Sliding windows of ids: [B, T] int → [B, T, win] int64; positions
    past the valid length (or windows crossing it) hold ``pad_value``."""
    win = int(attrs.get("win_size", 2))
    pad = int(attrs.get("pad_value", 0))
    b, t = x.shape[0], x.shape[1]
    if length is None:
        ln = torch.full((b, 1), t, dtype=torch.int64, device=x.device)
    else:
        ln = length.reshape(-1, 1).long()
    pos = (torch.arange(t, device=x.device)[None, :, None]
           + torch.arange(win, device=x.device)[None, None, :])
    valid = pos < ln[:, :, None]
    idx = torch.clamp(pos, 0, t - 1).expand(b, t, win)
    gathered = x.long()[:, :, None].expand(b, t, win).gather(
        1, idx.reshape(b, t, win))
    return torch.where(valid, gathered, pad)
