"""Fused op lowerings (counterpart of ``paddle_tpu/ops/fused_ops.py``).
Ported so far: ``fused_bias_act_dropout``, which the
``fuse_bias_act_dropout`` pass puts on every FFN ``fc(act="gelu")``,
and its grad op ``fused_bias_act_dropout_grad``, which replays the
saved mask (the pass emits it in training programs; the grad maker
emits it when the op is built directly)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.fluid.registry import simple_op
from paddle_tpu_torch.kernels import fused_bias_act as fba

from .common import op_generator


def _fused_bias_act_grad_maker(op, out_grads, wanted, uniq):
    outs, pairs = {}, []
    for slot in ("X", "Bias"):
        n = op.inputs.get(slot, [None])[0]
        if n is None or n not in wanted:
            continue
        g = uniq(n)
        outs[slot + "@GRAD"] = [g]
        pairs.append((n, g))
    if not outs:
        return [], []
    ins = {"X": list(op.inputs["X"]), "Bias": list(op.inputs["Bias"]),
           "Out@GRAD": [out_grads[op.outputs["Out"][0]]]}
    if op.outputs.get("Mask"):
        ins["Mask"] = list(op.outputs["Mask"])
    return [("fused_bias_act_dropout_grad", ins, outs, dict(op.attrs))], pairs


@simple_op("fused_bias_act_dropout", ["X", "Bias"], ["Out", "Mask"],
           grad="custom", grad_maker=_fused_bias_act_grad_maker)
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
            mask = torch.empty(x.shape, dtype=torch.uint8,
                               device=x.device).bernoulli_(
                1.0 - p, generator=op_generator(ctx, attrs))
    out = fba.fused_bias_gelu(
        x.contiguous(), bias, mask=mask,
        scale=1.0 / max(1.0 - p, 1e-8) if live else 1.0,
        approximate=attrs.get("approximate", False),
        force=attrs.get("force"))
    if p <= 0.0:
        return out, None
    if mask is None:  # test mode: the identity mask dropout saves
        mask = torch.ones(x.shape, dtype=torch.uint8, device=x.device)
    return out, mask


@simple_op("fused_bias_act_dropout_grad",
           ["X", "Bias", "Mask", "Out@GRAD"], ["X@GRAD", "Bias@GRAD"],
           grad=None, optional=("Mask",))
def _fused_bias_act_dropout_grad(ctx, x, bias, mask, dy, attrs):
    """Backward of the fused chain through the saved mask (plain
    PyTorch: the JAX package computes it in XLA, outside any kernel)."""
    return fba.fused_bias_gelu_dropout_grad(
        x, bias, mask, dy,
        dropout_prob=float(attrs.get("dropout_prob", 0.0) or 0.0),
        is_test=bool(attrs.get("is_test", False) or ctx.is_test),
        approximate=attrs.get("approximate", False))
