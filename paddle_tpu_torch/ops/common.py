"""Shared helpers for op lowerings (counterpart of
``paddle_tpu/ops/common.py``)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.fluid.registry import torch_dtype


def np_dtype(name) -> torch.dtype:
    """The torch dtype an op's dtype attr names."""
    return torch_dtype(name)


def mxu_dot(a, b, mm=torch.matmul):
    """``mm(a, b)`` in the dtype of ``a``: one bf16 product when both are
    bf16, else accumulated in fp32 (the JAX package's ``mxu_dot``)."""
    if a.dtype == b.dtype:
        return mm(a, b)
    return mm(a.float(), b.float()).to(a.dtype)


def length_mask(length, t):
    """[B, T] bool mask of valid time positions from lengths [B]; None →
    None.  The one home of the dense-sequence masking convention (the
    sequence, recurrent and structured op families)."""
    if length is None:
        return None
    return (torch.arange(t, device=length.device)[None, :]
            < length.reshape(-1, 1))


_ACT_ENUM = {0: "identity", 1: "sigmoid", 2: "tanh", 3: "relu"}


def act_attr(val, default):
    """An activation attr that may be a string or the reference's int
    enum (gru_unit_op.cc ActType), as a canonical string name."""
    if val is None:
        return default
    if isinstance(val, str):
        return val
    return _ACT_ENUM.get(int(val), default)


def bcast_to(y, x, axis):
    """Fluid elementwise broadcast: Y's dims align with X's starting at
    `axis`; axis=-1 means right-aligned (numpy rules)."""
    xr, yr = x.dim(), y.dim()
    if axis is None or axis == -1 or yr == xr:
        return y
    # pad Y with trailing 1s so its dims sit at positions [axis, axis+yr)
    return y.reshape([1] * axis + list(y.shape) + [1] * (xr - axis - yr))


def flatten_to_2d(x, num_col_dims):
    """`mul` semantics: collapse the leading num_col_dims dims into rows,
    the rest into cols."""
    rows = cols = 1
    for s in x.shape[:num_col_dims]:
        rows *= s
    for s in x.shape[num_col_dims:]:
        cols *= s
    return x.reshape(rows, cols)


def op_generator(ctx, attrs):
    """The stream a random op draws from: with a nonzero ``seed`` attr,
    its own, keyed as the JAX package keys it (``op_rng_key``): the
    seed, the op's index (or its ``rng_op_index`` attr, which a fusion
    pass stamps on the op that absorbed it), the executor step and,
    inside a replica group, the replica index — so its mask changes
    every step, differs from another op's with the same seed, and
    differs between replicas.  Otherwise the run's stream, in program
    order (its seed already folds in the step and the replica).  Both
    are ``ctx.streams``' generators, seeded for the run before it
    starts (fluid/registry.py ``RandomStreams``)."""
    seed = int(attrs.get("seed", 0) or 0)
    if not seed:
        return ctx.generator
    idx = attrs.get("rng_op_index")
    if idx is None:
        idx = ctx.op_index
    what = ctx.cur_op.type if ctx.cur_op is not None else "random op"
    return ctx.streams.get((seed, int(idx)), what)


def rounded(v, dtype):
    """The Python number ``v`` rounded to ``dtype``, as
    ``jnp.asarray(v, x.dtype)`` rounds an op's scalar before the
    arithmetic (a bf16 tensor times 10000.0 multiplies by 9984.0).  A
    host float, so the op needs no host-to-device copy."""
    return torch.tensor(v, dtype=dtype).item()


def conv_pads(paddings, nd):
    """Paddle's conv paddings as ((before, after), ...) a spatial dim:
    one int a dim, or the flattened (before, after) pairs."""
    p = [int(v) for v in paddings]
    if len(p) == 2 * nd:
        return [(p[2 * i], p[2 * i + 1]) for i in range(nd)]
    return [(v, v) for v in p]


def pad_spatial(x, pads, value=0.0):
    """``x`` padded by ``pads`` (((before, after), ...) over its trailing
    spatial dims), or ``x`` itself when every pad is 0."""
    if not any(b or a for b, a in pads):
        return x
    flat = [v for b, a in reversed(pads) for v in (b, a)]
    return torch.nn.functional.pad(x, flat, value=value)


def conv_operands(x, w):
    """The dtypes a conv runs in: bf16 x bf16 natively (cuDNN
    accumulates in fp32), anything else in fp32 (the JAX package's
    ``mxu_conv_kwargs``; the executor turns TF32 off for cuDNN).  The
    result is cast back to ``x``'s dtype."""
    if x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16:
        return x, w
    return x.float(), w.float()


def conv_nd_raw(x, w, strides, paddings, dilations, groups, nd=2):
    """Paddle-convention n-D conv (NCHW / OIHW, or NCDHW / OIDHW): int
    paddings a spatial dim, or flattened (before, after) pairs; the one
    home of the geometry, as the JAX package's ``conv_nd_raw`` is.  A
    symmetric padding goes to the conv; an asymmetric one is padded
    explicitly first (the library's convs pad both sides alike).
    Returns the result in ``x``'s dtype."""
    pads = conv_pads(paddings, nd)
    sym = all(b == a for b, a in pads)
    xs, ws = conv_operands(x, w)
    conv = (torch.nn.functional.conv2d if nd == 2
            else torch.nn.functional.conv3d)
    out = conv(xs if sym else pad_spatial(xs, pads), ws, None,
               tuple(strides), [b for b, _ in pads] if sym else 0,
               tuple(dilations), groups)
    return out.to(x.dtype)


def conv_nd_grad(x, w, dout, strides, paddings, dilations, groups, nd,
                 want_x, want_w):
    """The grads of :func:`conv_nd_raw` w.r.t. ``x`` and ``w`` (None for
    one not wanted), in their dtypes: one ``convolution_backward``, the
    data grad and the filter grad of the same product, with no forward
    conv run again.  An asymmetric padding's grad is cropped from the
    padded input's."""
    pads = conv_pads(paddings, nd)
    sym = all(b == a for b, a in pads)
    xs, ws = conv_operands(x, w)
    xp = xs if sym else pad_spatial(xs, pads)
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dout.to(xs.dtype), xp, ws, None, list(strides),
        [b for b, _ in pads] if sym else [0] * nd, list(dilations), False,
        [0] * nd, groups, [want_x, want_w, False])
    if dx is not None:
        if not sym:
            dx = dx[(Ellipsis,) + tuple(
                slice(b, dx.shape[2 + i] - a) for i, (b, a) in
                enumerate(pads))]
        dx = dx.to(x.dtype)
    return dx, None if dw is None else dw.to(w.dtype)
