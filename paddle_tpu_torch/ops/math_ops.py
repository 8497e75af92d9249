"""Elementwise / matmul / activation / softmax op lowerings (counterpart
of ``paddle_tpu/ops/math_ops.py``).  A plain matrix product stays
``torch.matmul``, as the JAX package left it to XLA."""

from __future__ import annotations

import torch

from paddle_tpu_torch.fluid.registry import simple_op
from paddle_tpu_torch.kernels.fused_bias_act import gelu_reference

from .common import bcast_to, flatten_to_2d


@simple_op("elementwise_add", ["X", "Y"], ["Out"])
def _elementwise_add(ctx, x, y, attrs):
    return x + bcast_to(y, x, attrs.get("axis", -1))


@simple_op("mul", ["X", "Y"], ["Out"])
def _mul(ctx, x, y, attrs):
    xd = attrs.get("x_num_col_dims", 1)
    yd = attrs.get("y_num_col_dims", 1)
    out = torch.matmul(flatten_to_2d(x, xd), flatten_to_2d(y, yd))
    return out.reshape(tuple(x.shape[:xd]) + tuple(y.shape[yd:]))


@simple_op("matmul", ["X", "Y"], ["Out"])
def _matmul(ctx, x, y, attrs):
    if x.dim() == 1:
        x = x[None, :]
    if y.dim() == 1:
        y = y[:, None]
    if attrs.get("transpose_X", False):
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False):
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return out


@simple_op("gelu", ["X"], ["Out"])
def _gelu(ctx, x, attrs):
    return gelu_reference(x, attrs.get("approximate", False))


@simple_op("log_softmax", ["X"], ["Out"])
def _log_softmax(ctx, x, attrs):
    return torch.log_softmax(x.float(), dim=attrs.get("axis", -1)).to(
        x.dtype)
