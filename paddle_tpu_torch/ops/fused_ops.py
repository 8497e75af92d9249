"""Fused op lowerings (counterpart of ``paddle_tpu/ops/fused_ops.py``).
Ported so far: the forward of ``fused_bias_act_dropout``, which the
``fuse_bias_act_dropout`` pass puts on every FFN ``fc(act="gelu")``.
Its grad op comes with the training slice."""

from __future__ import annotations

import torch

from paddle_tpu_torch.fluid.registry import simple_op
from paddle_tpu_torch.kernels import fused_bias_act as fba


@simple_op("fused_bias_act_dropout", ["X", "Bias"], ["Out", "Mask"])
def _fused_bias_act_dropout(ctx, x, bias, attrs):
    """gelu(x + bias) with optional upscaled dropout through the K4
    kernel.  The mask is drawn here, outside the kernel, from the run's
    generator, and returned as the Mask output (all ones in test mode,
    None when dropout_prob == 0), as in the JAX package."""
    act = attrs.get("act", "gelu")
    if act != "gelu":
        raise NotImplementedError(
            f"fused_bias_act_dropout supports act='gelu', got {act!r}")
    p = float(attrs.get("dropout_prob", 0.0) or 0.0)
    impl = attrs.get("dropout_implementation", "upscale_in_train")
    if p > 0.0 and impl != "upscale_in_train":
        raise NotImplementedError(
            "fused_bias_act_dropout supports "
            f"dropout_implementation='upscale_in_train', got {impl!r}")
    is_test = bool(attrs.get("is_test", False) or ctx.is_test)
    live = p > 0.0 and not is_test
    mask = None
    if live:
        if x.device.type == "meta":
            mask = torch.empty(x.shape, dtype=torch.uint8, device="meta")
        else:
            keep = torch.full(x.shape, 1.0 - p, device=x.device)
            mask = torch.bernoulli(keep, generator=ctx.generator).to(
                torch.uint8)
    out = fba.fused_bias_gelu(
        x.contiguous(), bias, mask=mask,
        scale=1.0 / max(1.0 - p, 1e-8) if live else 1.0,
        approximate=attrs.get("approximate", False),
        force=attrs.get("force"))
    out = out.to(x.dtype)
    if p <= 0.0:
        return out, None
    if mask is None:  # test mode: the identity mask dropout saves
        mask = torch.ones(x.shape, dtype=torch.uint8, device=x.device)
    return out, mask
