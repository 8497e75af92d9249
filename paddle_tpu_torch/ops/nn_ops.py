"""Normalization op lowerings (counterpart of
``paddle_tpu/ops/nn_ops.py``)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.fluid.registry import simple_op


@simple_op("layer_norm", ["X", "Scale", "Bias"], ["Y", "Mean", "Variance"],
           optional=("Scale", "Bias"))
def _layer_norm(ctx, x, scale, bias, attrs):
    """Normalize over dims [begin_norm_axis, rank) in fp32; Mean and
    Variance come back shaped x.shape[:begin_norm_axis]."""
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    norm_shape = tuple(x.shape[begin:])
    w = scale.float().reshape(norm_shape) if scale is not None else None
    b = bias.float().reshape(norm_shape) if bias is not None else None
    y, mean, rstd = torch.native_layer_norm(x.float(), norm_shape, w, b,
                                            eps)
    lead = tuple(x.shape[:begin])
    var = rstd.reshape(lead).pow(-2) - eps
    return y.to(x.dtype), mean.reshape(lead), var
