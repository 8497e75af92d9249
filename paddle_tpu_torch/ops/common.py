"""Shared helpers for op lowerings (counterpart of
``paddle_tpu/ops/common.py``)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.fluid.registry import torch_dtype


def np_dtype(name) -> torch.dtype:
    """The torch dtype an op's dtype attr names."""
    return torch_dtype(name)


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
    """The stream a random op draws from: its own, seeded from a nonzero
    ``seed`` attr, else the run's generator in program order."""
    seed = int(attrs.get("seed", 0) or 0)
    if not seed:
        return ctx.generator
    g = torch.Generator(device=ctx.device)
    g.manual_seed(seed)
    return g


def rounded(v, dtype):
    """The Python number ``v`` rounded to ``dtype``, as
    ``jnp.asarray(v, x.dtype)`` rounds an op's scalar before the
    arithmetic (a bf16 tensor times 10000.0 multiplies by 9984.0).  A
    host float, so the op needs no host-to-device copy."""
    return torch.tensor(v, dtype=dtype).item()
