"""AMP support ops (counterpart of ``paddle_tpu/ops/amp_ops.py``):
``check_finite_and_unscale`` and ``update_loss_scaling``.

Both compute on the device and never read a value on the host: the
health sentinel (health/transpile.py) puts them inside a training step,
which a CUDA graph captures whole.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.fluid.registry import simple_op


@simple_op("check_finite_and_unscale", ["X*", "Scale"],
           ["Out*", "FoundInfinite"], grad=None)
def _check_finite_and_unscale(ctx, xs, scale, attrs):
    """Out_i = X_i / Scale, zeroed when any X is not finite;
    FoundInfinite a bool [1].  The sentinel's gate then keeps the bad
    step's state as it was (health/gating.py)."""
    from paddle_tpu_torch.health import detect

    inv = 1.0 / scale.reshape(()).float()
    found = ~detect.all_finite(xs, scale.device)
    gate = torch.where(found, 0.0, 1.0).to(torch.float32)
    outs = [(x.float() * inv * gate).to(x.dtype) for x in xs]
    return outs, found.reshape(1)


@simple_op("update_loss_scaling",
           ["PrevLossScaling", "FoundInfinite", "InGoodSteps", "InBadSteps"],
           ["LossScaling", "OutGoodSteps", "OutBadSteps"], grad=None,
           inplace={"LossScaling": "PrevLossScaling",
                    "OutGoodSteps": "InGoodSteps", "OutBadSteps": "InBadSteps"})
def _update_loss_scaling(ctx, scale, found_inf, good, bad, attrs):
    """The dynamic loss scale after a step: times decr_ratio (not below
    1) after decr_every_n_nan_or_inf bad steps in a row, times
    incr_ratio after incr_every_n_steps good ones, else unchanged; the
    good and bad counts restart on each change."""
    incr_n = attrs.get("incr_every_n_steps", 1000)
    decr_n = attrs.get("decr_every_n_nan_or_inf", 2)
    incr_ratio = attrs.get("incr_ratio", 2.0)
    decr_ratio = attrs.get("decr_ratio", 0.5)
    f = found_inf.reshape(()).bool()
    s = scale.reshape(()).float()
    g = good.reshape(()).to(torch.int32)
    b = bad.reshape(()).to(torch.int32)
    zero = torch.zeros_like(g)
    g_new = torch.where(f, zero, g + 1)
    b_new = torch.where(f, b + 1, zero)
    decr = b_new >= decr_n
    incr = g_new >= incr_n
    s_new = torch.where(decr, torch.clamp_min(s * decr_ratio, 1.0),
                        torch.where(incr, s * incr_ratio, s))
    g_new = torch.where(incr | decr, zero, g_new)
    b_new = torch.where(decr, zero, b_new)
    return (s_new.reshape(scale.shape).to(scale.dtype),
            g_new.reshape(good.shape).to(good.dtype),
            b_new.reshape(bad.shape).to(bad.dtype))
