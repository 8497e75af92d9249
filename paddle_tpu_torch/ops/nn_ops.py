"""Normalization, dropout and attention op lowerings (counterpart of
``paddle_tpu/ops/nn_ops.py``).  ``layer_norm_grad``,
``flash_attention_grad`` and ``softmax_mask_fuse_upper_triangle_grad``
are derived by the registry; ``dropout`` has a grad maker that replays
its saved mask; ``ragged_attention`` is inference-only."""

from __future__ import annotations

import torch

from paddle_tpu_torch.fluid.registry import simple_op
from paddle_tpu_torch.kernels.primitives import flash as _flash
from paddle_tpu_torch.kernels.primitives import ragged as _ragged

from .common import op_generator, rounded


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


# ---------------------------------------------------------------------------
# dropout: the grad op multiplies by the saved mask, so forward and
# backward agree exactly
# ---------------------------------------------------------------------------


def _dropout_grad_maker(op, out_grads, wanted, uniq):
    x = op.inputs["X"][0]
    if x not in wanted:
        return [], []
    g = uniq(x)
    ins = {"Out@GRAD": [out_grads[op.outputs["Out"][0]]],
           "Mask": list(op.outputs["Mask"])}
    return [("dropout_grad", ins, {"X@GRAD": [g]}, dict(op.attrs))], [(x, g)]


def _upscale(attrs):
    return 1.0 / max(1.0 - attrs.get("dropout_prob", 0.5), 1e-8)


@simple_op("dropout", ["X"], ["Out", "Mask"], grad="custom",
           grad_maker=_dropout_grad_maker)
def _dropout(ctx, x, attrs):
    """The uint8 keep-mask is drawn from the run's generator (or the op's
    own, for a nonzero ``seed``) and returned as Mask."""
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if attrs.get("is_test", False) or ctx.is_test:
        ones = torch.ones(x.shape, dtype=torch.uint8, device=x.device)
        if impl == "upscale_in_train":
            return x, ones
        return x * rounded(1.0 - p, x.dtype), ones
    mask = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    if x.device.type != "meta":
        mask.bernoulli_(1.0 - p, generator=op_generator(ctx, attrs))
    out = x * mask.to(x.dtype)
    if impl == "upscale_in_train":
        out = out * rounded(_upscale(attrs), x.dtype)
    return out, mask


@simple_op("dropout_grad", ["Out@GRAD", "Mask"], ["X@GRAD"], grad=None)
def _dropout_grad(ctx, dy, mask, attrs):
    m = mask.to(dy.dtype)
    if attrs.get("dropout_implementation",
                 "downgrade_in_infer") == "upscale_in_train":
        m = m * rounded(_upscale(attrs), dy.dtype)
    return dy * m


@simple_op("softmax_mask_fuse_upper_triangle", ["X"], ["Out"])
def _causal_softmax(ctx, x, attrs):
    """Causal softmax over the last axis of [..., S, S] scores: the
    future positions (above the diagonal) are filled with -1e9, as the
    JAX op fills them, and the softmax runs in x's dtype."""
    s = x.shape[-1]
    keep = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    return torch.softmax(torch.where(keep, x, rounded(-1e9, x.dtype)),
                         dim=-1)


@simple_op("flash_attention", ["Q", "K", "V", "Bias"], ["Out"],
           optional=("Bias",))
def _flash_attention(ctx, q, k, v, bias, attrs):
    """Attention over [B, n_heads, S, d] through K1 (forward) and, when
    differentiated, K2/K3.  The JAX op's ring-attention branch
    (``sequence_parallel`` under an 'sp' mesh) is not ported: on one
    device the JAX op runs this same kernel."""
    return _flash.flash_attention(q, k, v, bias=bias,
                                  causal=attrs.get("causal", False),
                                  sm_scale=attrs.get("sm_scale"),
                                  force=attrs.get("force"))


@simple_op("ragged_attention", ["Q", "K", "V", "Lengths"], ["Out"],
           grad=None)
def _ragged_attention(ctx, q, k, v, lengths, attrs):
    """Variable-length attention driven by a per-row length vector (K6):
    row b attends keys j < lengths[b].  q, k and v arrive as the
    transpose2 views the serving model makes; the kernel reads them in
    place."""
    return _ragged.ragged_attention(
        q, k, v, lengths.int().contiguous(),
        causal=attrs.get("causal", False), sm_scale=attrs.get("sm_scale"),
        force=attrs.get("force"))
