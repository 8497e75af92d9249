"""Optimizer op lowerings (counterpart of
``paddle_tpu/ops/optimizer_ops.py``).  Ported so far: ``sgd``,
``momentum``, ``adam``, ``adamw`` and their fused data-parallel forms
``fused_{sgd,momentum,adam,adamw}_quant_grad``; ``lars_momentum``,
``adagrad``, ``decayed_adagrad``, ``rmsprop``, ``adadelta``,
``adamax``, ``ftrl``, ``lamb`` and ``proximal_gd``.

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
Not ported yet: the ``*_quant_gather`` ops of the ZeRO-1 lane,
``dgc`` and ``dpsgd`` (whose noise the JAX package draws from
``jax.random``).
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
# the rest of the JAX package's optimizer ops: each computes the JAX
# lowering's fp32 formula, in its order, and writes the new state into
# the scope's tensors in place
# ---------------------------------------------------------------------------


def _lr(lr):
    return lr.float().reshape(())


def _store(*pairs):
    """Copy each new value into its state tensor; returns the tensors."""
    for dst, src in pairs:
        dst.copy_(src)
    return tuple(dst for dst, _ in pairs)


def _l2(x):
    return torch.sqrt(torch.sum(torch.square(x)))


@simple_op("lars_momentum", ["Param", "Grad", "Velocity", "LearningRate"],
           ["ParamOut", "VelocityOut"], grad=None,
           inplace={"ParamOut": "Param", "VelocityOut": "Velocity"})
def _lars_momentum(ctx, p, g, v, lr, attrs):
    """Momentum with a layer-wise rate lars_coeff·‖p‖ / (‖g‖ + wd·‖p‖
    + 1e-9) (1 where ‖p‖ = 0) on g + wd·p."""
    _require_fp32("lars_momentum", Param=p, Velocity=v)
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 0.001)
    wd = attrs.get("lars_weight_decay", 0.0005)
    g32 = g.float()
    pn, gn = _l2(p), _l2(g32)
    local_lr = torch.where(pn > 0, coeff * pn / (gn + wd * pn + 1e-9),
                           torch.ones_like(pn))
    v_new = mu * v + _lr(lr) * local_lr * (g32 + wd * p)
    return _store((p, p - v_new), (v, v_new))


@simple_op("adagrad", ["Param", "Grad", "Moment", "LearningRate"],
           ["ParamOut", "MomentOut"], grad=None,
           inplace={"ParamOut": "Param", "MomentOut": "Moment"})
def _adagrad(ctx, p, g, m, lr, attrs):
    """m += g²; p -= lr·g / (sqrt(m) + eps)."""
    _require_fp32("adagrad", Param=p, Moment=m)
    g32 = g.float()
    mn = m + torch.square(g32)
    pn = p - _lr(lr) * g32 / (torch.sqrt(mn) + attrs.get("epsilon", 1e-6))
    return _store((p, pn), (m, mn))


@simple_op("decayed_adagrad", ["Param", "Grad", "Moment", "LearningRate"],
           ["ParamOut", "MomentOut"], grad=None,
           inplace={"ParamOut": "Param", "MomentOut": "Moment"})
def _decayed_adagrad(ctx, p, g, m, lr, attrs):
    """m = decay·m + (1 - decay)·g²; p -= lr·g / (sqrt(m) + eps)."""
    _require_fp32("decayed_adagrad", Param=p, Moment=m)
    decay, eps = attrs.get("decay", 0.95), attrs.get("epsilon", 1e-6)
    g32 = g.float()
    mn = decay * m + (1 - decay) * torch.square(g32)
    pn = p - _lr(lr) * g32 / (torch.sqrt(mn) + eps)
    return _store((p, pn), (m, mn))


@simple_op("rmsprop", ["Param", "Grad", "Moment", "MeanSquare", "MeanGrad",
                       "LearningRate"],
           ["ParamOut", "MomentOut", "MeanSquareOut", "MeanGradOut"],
           grad=None, optional=("MeanGrad",),
           inplace={"ParamOut": "Param", "MomentOut": "Moment",
                    "MeanSquareOut": "MeanSquare",
                    "MeanGradOut": "MeanGrad"})
def _rmsprop(ctx, p, g, mom, ms, mg, lr, attrs):
    """ms = rho·ms + (1 - rho)·g²; centered, mg = rho·mg + (1 - rho)·g
    and the denominator sqrt(ms - mg² + eps), else sqrt(ms + eps);
    mom = mu·mom + lr·g / denominator; p -= mom."""
    _require_fp32("rmsprop", Param=p, Moment=mom, MeanSquare=ms,
                  MeanGrad=mg)
    rho, eps = attrs.get("decay", 0.95), attrs.get("epsilon", 1e-6)
    mu = attrs.get("momentum", 0.0)
    g32 = g.float()
    msn = rho * ms + (1 - rho) * torch.square(g32)
    if attrs.get("centered", False):
        mgn = rho * mg + (1 - rho) * g32
        denom = torch.sqrt(msn - torch.square(mgn) + eps)
    else:
        mgn = mg
        denom = torch.sqrt(msn + eps)
    momn = mu * mom + _lr(lr) * g32 / denom
    out = _store((p, p - momn), (mom, momn), (ms, msn))
    if mg is not None and mgn is not mg:
        mg.copy_(mgn)
    return out + (mg,)


@simple_op("adadelta", ["Param", "Grad", "AvgSquaredGrad",
                        "AvgSquaredUpdate"],
           ["ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut"],
           grad=None,
           inplace={"ParamOut": "Param", "AvgSquaredGradOut": "AvgSquaredGrad",
                    "AvgSquaredUpdateOut": "AvgSquaredUpdate"})
def _adadelta(ctx, p, g, asg, asu, attrs):
    """asg = rho·asg + (1 - rho)·g²; u = -sqrt((asu + eps) / (asg +
    eps))·g; asu = rho·asu + (1 - rho)·u²; p += u (no learning rate)."""
    _require_fp32("adadelta", Param=p, AvgSquaredGrad=asg,
                  AvgSquaredUpdate=asu)
    rho, eps = attrs.get("rho", 0.95), attrs.get("epsilon", 1e-6)
    g32 = g.float()
    asgn = rho * asg + (1 - rho) * torch.square(g32)
    upd = -torch.sqrt((asu + eps) / (asgn + eps)) * g32
    asun = rho * asu + (1 - rho) * torch.square(upd)
    return _store((p, p + upd), (asg, asgn), (asu, asun))


@simple_op("adamax", ["Param", "Grad", "Moment", "InfNorm", "LearningRate",
                      "Beta1Pow"],
           ["ParamOut", "MomentOut", "InfNormOut"], grad=None,
           inplace={"ParamOut": "Param", "MomentOut": "Moment",
                    "InfNormOut": "InfNorm"})
def _adamax(ctx, p, g, m, inf, lr, b1p, attrs):
    """m = b1·m + (1 - b1)·g; u = max(b2·u, |g|); p -= lr / (1 - b1^t) ·
    m / (u + eps).  The beta power advances in a separate ``scale`` op
    (the optimizer's ``_finish_update``)."""
    _require_fp32("adamax", Param=p, Moment=m, InfNorm=inf)
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    g32 = g.float()
    mn = b1 * m + (1 - b1) * g32
    infn = torch.maximum(b2 * inf, torch.abs(g32))
    lr_t = _lr(lr) / (1 - b1p.float().reshape(()))
    return _store((p, p - lr_t * mn / (infn + eps)), (m, mn), (inf, infn))


@simple_op("ftrl", ["Param", "SquaredAccumulator", "LinearAccumulator",
                    "Grad", "LearningRate"],
           ["ParamOut", "SquaredAccumOut", "LinearAccumOut"], grad=None,
           inplace={"ParamOut": "Param",
                    "SquaredAccumOut": "SquaredAccumulator",
                    "LinearAccumOut": "LinearAccumulator"})
def _ftrl(ctx, p, sq, lin, g, lr, attrs):
    """Follow-the-regularized-leader (McMahan et al.) with l1, l2 and
    the learning-rate power."""
    _require_fp32("ftrl", Param=p, SquaredAccumulator=sq,
                  LinearAccumulator=lin)
    l1, l2 = attrs.get("l1", 0.0), attrs.get("l2", 0.0)
    power = -attrs.get("lr_power", -0.5)
    g32, lr_ = g.float(), _lr(lr)
    new_sq = sq + torch.square(g32)
    sigma = (torch.pow(new_sq, power) - torch.pow(sq, power)) / lr_
    new_lin = lin + g32 - sigma * p
    x = torch.clamp(new_lin, -l1, l1) - new_lin
    y = torch.pow(new_sq, power) / lr_ + 2 * l2
    return _store((p, x / y), (sq, new_sq), (lin, new_lin))


@simple_op("lamb",
           ["Param", "Grad", "Moment1", "Moment2", "LearningRate",
            "Beta1Pow", "Beta2Pow"], **_ADAM_SLOTS)
def _lamb(ctx, p, g, m1, m2, lr, b1p, b2p, attrs):
    """Adam's bias-corrected moments make r = m̂ / (sqrt(v̂) + eps) +
    wd·p; p -= lr·(‖p‖ / ‖r‖)·r (trust 1 where either norm is 0); the
    beta powers advance."""
    _require_fp32("lamb", Param=p, Moment1=m1, Moment2=m2, Beta1Pow=b1p,
                  Beta2Pow=b2p)
    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    eps, wd = attrs.get("epsilon", 1e-6), attrs.get("weight_decay", 0.01)
    g32 = g.float()
    m1n = b1 * m1 + (1 - b1) * g32
    m2n = b2 * m2 + (1 - b2) * torch.square(g32)
    b1pf, b2pf = b1p.reshape(()), b2p.reshape(())
    r = (m1n / (1 - b1pf)) / (torch.sqrt(m2n / (1 - b2pf)) + eps) + wd * p
    pn, rn = _l2(p), _l2(r)
    trust = torch.where((pn > 0) & (rn > 0), pn / rn, torch.ones_like(pn))
    return _store((p, p - _lr(lr) * trust * r), (m1, m1n), (m2, m2n),
                  (b1p, b1p * b1), (b2p, b2p * b2))


@simple_op("proximal_gd", ["Param", "Grad", "LearningRate"], ["ParamOut"],
           grad=None, inplace={"ParamOut": "Param"})
def _proximal_gd(ctx, p, g, lr, attrs):
    """The gradient step, then the proximal operator of l1·|p| (a
    soft threshold, where l1 > 0) and l2."""
    _require_fp32("proximal_gd", Param=p)
    l1, l2 = attrs.get("l1", 0.0), attrs.get("l2", 0.0)
    lr_ = _lr(lr)
    prox = p - lr_ * g.float()
    if l1 > 0:
        prox = torch.sign(prox) * torch.clamp_min(
            torch.abs(prox) - lr_ * l1, 0.0)
    p.copy_(prox / (1.0 + lr_ * l2))
    return p


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
