"""Optimizer op lowerings (counterpart of
``paddle_tpu/ops/optimizer_ops.py``).  Ported so far: ``adam``.

Where the JAX package donates the parameter and moment buffers and gets
new ones back, ``adam`` here updates the scope's tensors in place
(``inplace`` names the aliases), in fp32 on the fp32 masters.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.fluid.registry import simple_op


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
    for name, t in (("Param", p), ("Moment1", m1), ("Moment2", m2),
                    ("Beta1Pow", b1p), ("Beta2Pow", b2p)):
        if t.dtype != torch.float32:
            raise TypeError(f"adam: {name} must be float32, got {t.dtype}")
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
