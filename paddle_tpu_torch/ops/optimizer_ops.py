"""Optimizer op lowerings (counterpart of
``paddle_tpu/ops/optimizer_ops.py``).  Ported so far: ``sgd``,
``momentum``, ``adam``, ``adamw`` and their fused data-parallel forms
``fused_{sgd,momentum,adam,adamw}_quant_grad``.

Where the JAX package donates the parameter and moment buffers and gets
new ones back, the ops here update the scope's tensors in place
(``inplace`` names the aliases), in fp32 on the fp32 masters.

The ``*_quant_grad`` ops take the gradient as a block-aligned member of
a reduced bucket kept in its wire format (``QHi``, ``QLo``, ``QScale``
from ``c_allreduce_quant_keep``; attrs ``offset_blocks``, ``numel``,
``block_size``) and run kernel K8 (kernels/fused_update.py) on it.
Each registers a group form (registry.GroupLowering): the executor runs
a run of consecutive fused ops of one kind and hyperparameters as one
``fused_update_group`` call, one K8 launch for up to a table-full of
parameters of every replica.
Not ported yet: the ``*_quant_gather`` ops of the ZeRO-1 lane, lamb,
dgc and the rest of the JAX package's optimizer ops.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.fluid.registry import GroupLowering, simple_op
from paddle_tpu_torch.kernels import fused_update as fu

_ADAM_SLOTS = dict(
    outputs=["ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
             "Beta2PowOut"],
    grad=None,
    inplace={"ParamOut": "Param", "Moment1Out": "Moment1",
             "Moment2Out": "Moment2", "Beta1PowOut": "Beta1Pow",
             "Beta2PowOut": "Beta2Pow"})


def _require_fp32(op_type, **tensors):
    for name, t in tensors.items():
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{op_type}: {name} must be float32, got "
                            f"{t.dtype}")


@simple_op("sgd", ["Param", "Grad", "LearningRate"], ["ParamOut"], grad=None,
           inplace={"ParamOut": "Param"})
def _sgd(ctx, p, g, lr, attrs):
    """p -= lr·g, in place."""
    _require_fp32("sgd", Param=p)
    p.copy_(fu.sgd_math(p, g, lr))
    return p


@simple_op("momentum", ["Param", "Grad", "Velocity", "LearningRate"],
           ["ParamOut", "VelocityOut"], grad=None,
           inplace={"ParamOut": "Param", "VelocityOut": "Velocity"})
def _momentum(ctx, p, g, v, lr, attrs):
    """v = mu·v + g; p -= lr·v (or, Nesterov, p -= (g + mu·v)·lr), in
    place."""
    _require_fp32("momentum", Param=p, Velocity=v)
    p_new, v_new = fu.momentum_math(p, g, v, lr, attrs.get("mu", 0.9),
                                    attrs.get("use_nesterov", False))
    p.copy_(p_new)
    v.copy_(v_new)
    return p, v


@simple_op(
    "adam",
    ["Param", "Grad", "Moment1", "Moment2", "LearningRate", "Beta1Pow",
     "Beta2Pow"],
    ["ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut", "Beta2PowOut"],
    grad=None,
    inplace={"ParamOut": "Param", "Moment1Out": "Moment1",
             "Moment2Out": "Moment2", "Beta1PowOut": "Beta1Pow",
             "Beta2PowOut": "Beta2Pow"},
)
def _adam(ctx, p, g, m1, m2, lr, b1p, b2p, attrs):
    """m1 = b1·m1 + (1-b1)·g; m2 = b2·m2 + (1-b2)·g²;
    p -= lr·sqrt(1-b2^t)/(1-b1^t) · m1/(sqrt(m2)+eps); the beta powers
    advance.  Every state tensor must be fp32 (the masters)."""
    _require_fp32("adam", Param=p, Moment1=m1, Moment2=m2, Beta1Pow=b1p,
                  Beta2Pow=b2p)
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    g = g.float()
    m1.mul_(b1).add_(g, alpha=1 - b1)
    m2.mul_(b2).addcmul_(g, g, value=1 - b2)
    lr_t = lr.float().reshape(()) * torch.sqrt(1 - b2p.reshape(())) \
        / (1 - b1p.reshape(()))
    p.sub_(lr_t * m1 / (torch.sqrt(m2) + eps))
    b1p.mul_(b1)
    b2p.mul_(b2)
    return p, m1, m2, b1p, b2p


@simple_op(
    "adamw",
    ["Param", "Grad", "Moment1", "Moment2", "LearningRate", "Beta1Pow",
     "Beta2Pow"], **_ADAM_SLOTS)
def _adamw(ctx, p, g, m1, m2, lr, b1p, b2p, attrs):
    """The adam step, then p -= lr·coeff·p on the parameter before it
    (the raw learning rate), in place."""
    _require_fp32("adamw", Param=p, Moment1=m1, Moment2=m2, Beta1Pow=b1p,
                  Beta2Pow=b2p)
    p_new, m1n, m2n, b1pn, b2pn = fu.adamw_math(
        p, g, m1, m2, lr, b1p, b2p, attrs.get("beta1", 0.9),
        attrs.get("beta2", 0.999), attrs.get("epsilon", 1e-8),
        attrs.get("coeff", 0.01))
    for dst, src in ((p, p_new), (m1, m1n), (m2, m2n), (b1p, b1pn),
                     (b2p, b2pn)):
        dst.copy_(src)
    return p, m1, m2, b1p, b2p


# ---------------------------------------------------------------------------
# the fused data-parallel forms (K8)
# ---------------------------------------------------------------------------

_QUANT_IN = ["QHi", "QLo", "QScale"]


def _wire(qh, ql, qsc, attrs):
    return (qh, ql, qsc, int(attrs["offset_blocks"]), int(attrs["numel"]))


def _hyper(kind, attrs):
    """The kind's constants from a fused op's attrs, at the defaults its
    lowering takes."""
    if kind == "momentum":
        return dict(mu=attrs.get("mu", 0.9),
                    use_nesterov=bool(attrs.get("use_nesterov", False)))
    if kind in ("adam", "adamw"):
        h = dict(beta1=attrs.get("beta1", 0.9),
                 beta2=attrs.get("beta2", 0.999),
                 epsilon=attrs.get("epsilon", 1e-8))
        if kind == "adamw":
            h["coeff"] = attrs.get("coeff", 0.01)
        return h
    return {}


def _grouped(kind):
    """The group form of ``fused_<kind>_quant_grad``: ops of one block
    size, wire (dual or single int8) and hyperparameters share a call."""

    def key(op):
        return (int(op.attrs.get("block_size", 256)),
                bool(op.inputs.get("QLo")),
                tuple(sorted(_hyper(kind, op.attrs).items())))

    def lower(calls):
        members, outs = [], []
        for _, (p, qh, ql, qsc, *state), attrs in calls:
            grad = _wire(qh, ql, qsc, attrs)
            if kind == "sgd":
                (lr,) = state
                members.append(fu.GroupMember(p, grad, lr))
                outs.append(p)
            elif kind == "momentum":
                v, lr = state
                members.append(fu.GroupMember(p, grad, lr, m1=v))
                outs.append((p, v))
            else:
                m1, m2, lr, b1p, b2p = state
                members.append(fu.GroupMember(p, grad, lr, m1, m2, b1p, b2p))
                outs.append((p, m1, m2, b1p, b2p))
        attrs = calls[0][2]
        fu.fused_update_group(kind, members, _hyper(kind, attrs),
                              attrs.get("block_size", 256))
        return outs

    return GroupLowering(key, lower)


@simple_op("fused_sgd_quant_grad",
           ["Param"] + _QUANT_IN + ["LearningRate"], ["ParamOut"],
           grad=None, optional=("QLo",), inplace={"ParamOut": "Param"},
           group=_grouped("sgd"))
def _fused_sgd_quant_grad(ctx, p, qh, ql, qsc, lr, attrs):
    return fu.fused_sgd_update(p, _wire(qh, ql, qsc, attrs), lr,
                               block_size=attrs.get("block_size", 256))


@simple_op("fused_momentum_quant_grad",
           ["Param"] + _QUANT_IN + ["Velocity", "LearningRate"],
           ["ParamOut", "VelocityOut"], grad=None, optional=("QLo",),
           inplace={"ParamOut": "Param", "VelocityOut": "Velocity"},
           group=_grouped("momentum"))
def _fused_momentum_quant_grad(ctx, p, qh, ql, qsc, v, lr, attrs):
    h = _hyper("momentum", attrs)
    return fu.fused_momentum_update(
        p, _wire(qh, ql, qsc, attrs), v, lr, **h,
        block_size=attrs.get("block_size", 256))


@simple_op("fused_adam_quant_grad",
           ["Param"] + _QUANT_IN + ["Moment1", "Moment2", "LearningRate",
                                    "Beta1Pow", "Beta2Pow"],
           optional=("QLo",), group=_grouped("adam"), **_ADAM_SLOTS)
def _fused_adam_quant_grad(ctx, p, qh, ql, qsc, m1, m2, lr, b1p, b2p,
                           attrs):
    return fu.fused_adam_update(
        p, _wire(qh, ql, qsc, attrs), m1, m2, lr, b1p, b2p,
        **_hyper("adam", attrs), block_size=attrs.get("block_size", 256))


@simple_op("fused_adamw_quant_grad",
           ["Param"] + _QUANT_IN + ["Moment1", "Moment2", "LearningRate",
                                    "Beta1Pow", "Beta2Pow"],
           optional=("QLo",), group=_grouped("adamw"), **_ADAM_SLOTS)
def _fused_adamw_quant_grad(ctx, p, qh, ql, qsc, m1, m2, lr, b1p, b2p,
                            attrs):
    return fu.fused_adamw_update(
        p, _wire(qh, ql, qsc, attrs), m1, m2, lr, b1p, b2p,
        **_hyper("adamw", attrs), block_size=attrs.get("block_size", 256))
