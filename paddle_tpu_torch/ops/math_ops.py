"""Elementwise / matmul / activation / softmax / loss op lowerings
(counterpart of ``paddle_tpu/ops/math_ops.py``).

A plain matrix product stays ``torch.matmul``, as the JAX package left
it to XLA.  Under the bf16 policy both operands arrive bf16 and cuBLAS
accumulates in fp32 (the executor turns off reduced-precision
reduction), which is what the JAX package's ``mxu_dot`` asks of XLA.

The grads of ``mul`` and ``matmul`` are written by hand, as the two
products they are: the registry's autograd derivation would
run the forward product again on every step.  Every other grad op here
is derived by the registry.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.fluid.registry import (register_op, simple_op,
                                             wanted_grads)
from paddle_tpu_torch.kernels.fused_bias_act import gelu_reference

from .common import bcast_to, flatten_to_2d, mxu_dot, rounded


def _ew(name, fn):
    """An elementwise binary op: Y broadcast against X by the Fluid
    ``axis`` rule (ops/common.py ``bcast_to``); its grad is derived."""

    def lower(ctx, x, y, attrs):
        return fn(x, bcast_to(y, x, attrs.get("axis", -1)))

    register_op(name, ["X", "Y"], ["Out"], lower)


_ew("elementwise_add", torch.add)
_ew("elementwise_sub", torch.sub)
_ew("elementwise_mul", torch.mul)
_ew("elementwise_div", torch.true_divide)
_ew("elementwise_max", torch.maximum)
_ew("elementwise_min", torch.minimum)
_ew("elementwise_pow", torch.pow)
_ew("elementwise_mod", torch.remainder)         # the divisor's sign
_ew("elementwise_floordiv", torch.floor_divide)  # rounds toward -inf


def _cmp(name, fn):
    """A comparison (bool out, no grad): Y broadcast against X by the
    same ``axis`` rule."""

    def lower(ctx, x, y, attrs):
        return fn(x, bcast_to(y, x, attrs.get("axis", -1)))

    register_op(name, ["X", "Y"], ["Out"], lower, grad=None)


_cmp("equal", torch.eq)
_cmp("not_equal", torch.ne)
_cmp("less_than", torch.lt)
_cmp("less_equal", torch.le)
_cmp("greater_than", torch.gt)
_cmp("greater_equal", torch.ge)
_cmp("logical_and", torch.logical_and)
_cmp("logical_or", torch.logical_or)
_cmp("logical_xor", torch.logical_xor)
register_op("logical_not", ["X"], ["Out"],
            lambda ctx, x, attrs: torch.logical_not(x), grad=None)


@simple_op("mul", ["X", "Y"], ["Out"])
def _mul(ctx, x, y, attrs):
    xd = attrs.get("x_num_col_dims", 1)
    yd = attrs.get("y_num_col_dims", 1)
    out = mxu_dot(flatten_to_2d(x, xd), flatten_to_2d(y, yd))
    return out.reshape(tuple(x.shape[:xd]) + tuple(y.shape[yd:]))


@simple_op("mul_grad", ["X", "Y", "Out@GRAD"], ["X@GRAD", "Y@GRAD"],
           grad="lazy", optional=("X", "Y", "Out@GRAD"))
def _mul_grad(ctx, x, y, dout, attrs):
    """dX = dOut·Yᵀ and dY = Xᵀ·dOut over the 2-D views ``mul`` used;
    only the grads the op names are computed."""
    want = wanted_grads(ctx, "mul_grad", ["X@GRAD", "Y@GRAD"])
    xd = attrs.get("x_num_col_dims", 1)
    yd = attrs.get("y_num_col_dims", 1)
    x2, y2 = flatten_to_2d(x, xd), flatten_to_2d(y, yd)
    g = dout.reshape(x2.shape[0], y2.shape[1]).to(x.dtype)
    dx = dy = None
    if "X@GRAD" in want:
        dx = mxu_dot(g, y2.t()).to(x.dtype).reshape(x.shape)
    if "Y@GRAD" in want:
        dy = mxu_dot(x2.t(), g).to(y.dtype).reshape(y.shape)
    return dx, dy


@simple_op("fc", ["Input", "W", "Bias"], ["Out"], optional=("Bias",))
def _fc(ctx, x, w, bias, attrs):
    """The fused fully-connected op that ``fc_fuse_pass`` (fluid/ir.py)
    makes of mul + elementwise_add [+ relu]: one product, then the
    bias along the last axis and the activation."""
    xd = attrs.get("in_num_col_dims", 1)
    out = mxu_dot(flatten_to_2d(x, xd), w)
    out = out.reshape(tuple(x.shape[:xd]) + (w.shape[1],))
    if bias is not None:
        out = out + bias
    act = attrs.get("activation_type", "")
    if act == "relu":
        out = torch.relu(out)
    elif act:
        raise NotImplementedError(f"fc activation_type {act!r}")
    return out


def _matmul_operands(x, y, attrs):
    if x.dim() == 1:
        x = x[None, :]
    if y.dim() == 1:
        y = y[:, None]
    if attrs.get("transpose_X", False):
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False):
        y = y.transpose(-1, -2)
    return x, y


@simple_op("matmul", ["X", "Y"], ["Out"])
def _matmul(ctx, x, y, attrs):
    a, b = _matmul_operands(x, y, attrs)
    out = mxu_dot(a, b)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * rounded(alpha, out.dtype)
    return out


def _unbroadcast(g, shape):
    """Sum ``g`` down to ``shape`` over the batch dims a batched matmul
    broadcast."""
    lead = g.dim() - len(shape)
    if lead > 0:
        g = g.sum(dim=tuple(range(lead)))
    dims = tuple(i for i, s in enumerate(shape) if s == 1 and g.shape[i] != 1)
    return g.sum(dim=dims, keepdim=True) if dims else g


@simple_op("matmul_grad", ["X", "Y", "Out@GRAD"], ["X@GRAD", "Y@GRAD"],
           grad="lazy", optional=("X", "Y", "Out@GRAD"))
def _matmul_grad(ctx, x, y, dout, attrs):
    """With A = op(X), B = op(Y) as ``matmul`` formed them and
    G = alpha·dOut: dA = G·Bᵀ, dB = Aᵀ·G, taken back through the
    transposes, the 1-D promotions and any batch broadcast."""
    want = wanted_grads(ctx, "matmul_grad", ["X@GRAD", "Y@GRAD"])
    a, b = _matmul_operands(x, y, attrs)
    g = dout.to(a.dtype)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        g = g * rounded(alpha, g.dtype)
    g = g.reshape(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
                  + (a.shape[-2], b.shape[-1]))
    dx = dy = None
    if "X@GRAD" in want:
        da = _unbroadcast(mxu_dot(g, b.transpose(-1, -2)), a.shape)
        if attrs.get("transpose_X", False):
            da = da.transpose(-1, -2)
        dx = da.reshape(x.shape).to(x.dtype)
    if "Y@GRAD" in want:
        db = _unbroadcast(mxu_dot(a.transpose(-1, -2), g), b.shape)
        if attrs.get("transpose_Y", False):
            db = db.transpose(-1, -2)
        dy = db.reshape(y.shape).to(y.dtype)
    return dx, dy


@simple_op("scale", ["X", "ScaleTensor"], ["Out"], optional=("ScaleTensor",),
           no_grad_inputs=("ScaleTensor",))
def _scale(ctx, x, scale_t, attrs):
    s = scale_t.to(x.dtype) if scale_t is not None \
        else rounded(attrs.get("scale", 1.0), x.dtype)
    b = rounded(attrs.get("bias", 0.0), x.dtype)
    if attrs.get("bias_after_scale", True):
        return x * s + b
    return (x + b) * s


@simple_op("sum", ["X*"], ["Out"])
def _sum(ctx, xs, attrs):
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


@simple_op("tanh", ["X"], ["Out"])
def _tanh(ctx, x, attrs):
    return torch.tanh(x)


@simple_op("sqrt", ["X"], ["Out"])
def _sqrt(ctx, x, attrs):
    return torch.sqrt(x)


def _unary(name, fn):
    register_op(name, ["X"], ["Out"], lambda ctx, x, attrs: fn(x))


_unary("exp", torch.exp)
_unary("log", torch.log)
_unary("floor", torch.floor)
_unary("ceil", torch.ceil)
_unary("cos", torch.cos)


@simple_op("pow", ["X", "FactorTensor"], ["Out"], optional=("FactorTensor",),
           no_grad_inputs=("FactorTensor",))
def _pow(ctx, x, f, attrs):
    return torch.pow(x, f if f is not None else attrs.get("factor", 1.0))


@simple_op("relu", ["X"], ["Out"])
def _relu(ctx, x, attrs):
    return torch.relu(x)


@simple_op("sigmoid", ["X"], ["Out"])
def _sigmoid(ctx, x, attrs):
    return torch.sigmoid(x)


@simple_op("leaky_relu", ["X"], ["Out"])
def _leaky_relu(ctx, x, attrs):
    """x where x >= 0, else alpha·x (``jax.nn.leaky_relu``; alpha rounded
    to x's dtype first, as the JAX package's weakly typed scalar is)."""
    return torch.where(x >= 0, x, rounded(attrs.get("alpha", 0.02), x.dtype)
                       * x)


@simple_op("square", ["X"], ["Out"])
def _square(ctx, x, attrs):
    return torch.square(x)


@simple_op("gelu", ["X"], ["Out"])
def _gelu(ctx, x, attrs):
    return gelu_reference(x, attrs.get("approximate", False))


@simple_op("softmax", ["X"], ["Out"])
def _softmax(ctx, x, attrs):
    """Softmax in fp32, returned in the input dtype."""
    return torch.softmax(x.float(), dim=attrs.get("axis", -1)).to(x.dtype)


@simple_op("log_softmax", ["X"], ["Out"])
def _log_softmax(ctx, x, attrs):
    return torch.log_softmax(x.float(), dim=attrs.get("axis", -1)).to(
        x.dtype)


@simple_op("cross_entropy", ["X", "Label"], ["Y"], no_grad_inputs=("Label",))
def _cross_entropy(ctx, x, label, attrs):
    """-log of the probability ``x`` gives the label (``soft_label``: the
    label-weighted sum), clamped at 1e-8 as the JAX op clamps; rows
    labelled ``ignore_index`` lose 0."""
    eps = 1e-8
    if attrs.get("soft_label", False):
        return -(label * torch.log(torch.clamp_min(x, eps))).sum(
            dim=-1, keepdim=True)
    lbl = label.squeeze(-1) if label.dim() == x.dim() else label
    lbl = lbl.long()[..., None]
    # an ignored row's label may lie outside [0, C): gather a clamped
    # index, then zero the row, as the JAX op's fill-and-where does
    p = torch.gather(x, -1, lbl.clamp(0, x.shape[-1] - 1))
    loss = -torch.log(torch.clamp_min(p, eps))
    ignore = attrs.get("ignore_index", -100)
    return torch.where(lbl == ignore, torch.zeros_like(loss), loss)


@simple_op("fused_softmax_cross_entropy", ["X", "Label"], ["Out"],
           no_grad_inputs=("Label",))
def _fused_softmax_ce(ctx, x, label, attrs):
    """What the ``fuse_softmax_cross_entropy`` pass
    (passes/fuse_softmax_xent.py) writes for a softmax -> cross_entropy
    pair: the composition of the two lowerings above, the same
    functions in the same order, so a program gives the same bits with
    the pass on and off."""
    sm = _softmax(ctx, x, {"axis": attrs.get("axis", -1)})
    return _cross_entropy(
        ctx, sm, label,
        {"soft_label": attrs.get("soft_label", False),
         "ignore_index": attrs.get("ignore_index", -100)})


@simple_op("softmax_with_cross_entropy", ["Logits", "Label"],
           ["Softmax", "Loss"], no_grad_inputs=("Label",))
def _softmax_ce(ctx, logits, label, attrs):
    """Softmax (input dtype) and the cross entropy against hard or soft
    labels (fp32), computed in fp32; rows labelled ``ignore_index`` lose
    0."""
    axis = attrs.get("axis", -1)
    lf = logits.float()
    sm = torch.softmax(lf, dim=axis).to(logits.dtype)
    logp = torch.log_softmax(lf, dim=axis)
    if attrs.get("soft_label", False):
        return sm, -(label * logp).sum(dim=axis, keepdim=True)
    lbl = label.squeeze(axis) if label.dim() == logits.dim() else label
    lbl = lbl.long()[..., None]
    if lbl.shape[:-1] != logp.shape[:-1]:
        # torch.gather would take a smaller label silently
        raise ValueError(f"softmax_with_cross_entropy: label shape "
                         f"{tuple(label.shape)} does not match logits "
                         f"{tuple(logits.shape)}")
    loss = -torch.gather(logp, axis, lbl.clamp(0, logp.shape[axis] - 1))
    ignore = attrs.get("ignore_index", -100)
    return sm, torch.where(lbl == ignore, torch.zeros_like(loss), loss)


@simple_op("square_error_cost", ["X", "Y"], ["Out"])
def _square_error_cost(ctx, x, y, attrs):
    return torch.square(x - y)


@simple_op("mean", ["X"], ["Out"])
def _mean(ctx, x, attrs):
    return x.mean()


def _reduce(name, fn):
    """A reduction over ``dim`` (negative dims counted from the end;
    every dim with ``reduce_all``), keeping the reduced dims as 1 with
    ``keep_dim``; its grad is derived.  ``fn(x, dims, keepdim)``."""

    def lower(ctx, x, attrs):
        if attrs.get("reduce_all", False):
            dims = tuple(range(x.dim()))
        else:
            dims = attrs.get("dim", [0])
            dims = tuple(d % x.dim() for d in (dims if isinstance(
                dims, (list, tuple)) else [dims]))
        return fn(x, dims, attrs.get("keep_dim", False))

    register_op(name, ["X"], ["Out"], lower)


def _reduced_sum(x, dims, keepdim):
    """A sum that accumulates a bf16 or fp16 input in fp32 and rounds
    the result back, as ``jnp.sum`` does."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.sum(dim=dims, keepdim=keepdim, dtype=torch.float32).to(
            x.dtype)
    return x.sum(dim=dims, keepdim=keepdim)


_reduce("reduce_sum", _reduced_sum)
_reduce("reduce_mean", lambda x, d, k: x.mean(dim=d, keepdim=k))
_reduce("reduce_max", lambda x, d, k: x.amax(dim=d, keepdim=k))
_reduce("reduce_min", lambda x, d, k: x.amin(dim=d, keepdim=k))


def _sum_of_squares(x):
    """sum(x²) in the dtype of ``x``: the squares rounded to it, summed
    in fp32 (``jnp.sum`` upcasts a bf16 reduction) and rounded back."""
    return torch.square(x).float().sum().to(x.dtype)


@simple_op("squared_l2_norm", ["X"], ["Out"])
def _squared_l2_norm(ctx, x, attrs):
    """sum(x²) as a [1] tensor (the global-norm clip sums these)."""
    return _sum_of_squares(x).reshape(1)


@simple_op("clip", ["X", "Min", "Max"], ["Out"], optional=("Min", "Max"),
           no_grad_inputs=("Min", "Max"))
def _clip(ctx, x, mn, mx, attrs):
    """max(x, min) then min(·, max), the bounds the ``Min``/``Max``
    tensors where given, else the attrs (no bound: ±inf).  A tensor
    bound promotes as ``jnp.clip`` does and splits the grad at a tie."""
    if mn is None and mx is None:
        return torch.clamp(x, attrs.get("min", float("-inf")),
                           attrs.get("max", float("inf")))
    if mn is None:
        x = torch.clamp_min(x, attrs.get("min", float("-inf")))
    else:
        x = torch.maximum(mn, x)
    if mx is None:
        return torch.clamp_max(x, attrs.get("max", float("inf")))
    return torch.minimum(mx, x)


@simple_op("clip_by_norm", ["X"], ["Out"])
def _clip_by_norm(ctx, x, attrs):
    """x scaled to norm ``max_norm`` where its L2 norm exceeds it."""
    mn = rounded(attrs.get("max_norm", 1.0), x.dtype)
    norm = torch.sqrt(_sum_of_squares(x))
    # a true division (a Python number over a tensor would multiply by
    # the tensor's reciprocal)
    scaled = x * (torch.full_like(norm, mn)
                  / torch.clamp_min(norm, rounded(1e-12, x.dtype)))
    return torch.where(norm > mn, scaled, x)


@simple_op("dot", ["X", "Y"], ["Out"])
def _dot(ctx, x, y, attrs):
    """Row-wise inner product over the last axis, kept as a size-1 dim."""
    return (x * y).sum(dim=-1, keepdim=True)


@simple_op("l2_normalize", ["X"], ["Out", "Norm"])
def _l2_normalize(ctx, x, attrs):
    """x over its L2 norm along ``axis`` (the norm floored at
    ``epsilon``), and the norm."""
    norm = torch.sqrt(torch.square(x).sum(dim=attrs.get("axis", -1),
                                          keepdim=True))
    return x / torch.clamp_min(norm, attrs.get("epsilon", 1e-12)), norm


register_op("norm", ["X"], ["Out", "Norm"],
            lambda ctx, x, attrs: _l2_normalize(ctx, x, attrs))
