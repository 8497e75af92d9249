"""Health-sentinel support ops (counterpart of
``paddle_tpu/ops/health_ops.py``): the small scalar ops
health/transpile.py puts around a program's optimizer ops.  The finite
check that unscales is ``check_finite_and_unscale`` (amp_ops.py); both
reduce through ``health.detect``.

Every op here computes on the device and reads nothing on the host (no
``.item()``, no branch on a value): a captured training step holds them.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.fluid.registry import simple_op


@simple_op("health_check", ["X*"], ["FoundInfinite"], grad=None)
def _health_check(ctx, xs, attrs):
    """The read-only finite check: one bool [1], True when any float X
    holds a NaN or an Inf; the gradients are left as they are.  The
    sentinel uses it when dynamic loss scaling is off, where
    ``check_finite_and_unscale`` would rewrite every gradient to divide
    it by 1."""
    from paddle_tpu_torch.health import detect

    return detect.found_inf(xs, ctx.device).bool()


@simple_op("health_accum", ["FoundInf", "CumIn"], ["CumOut"], grad=None,
           inplace={"CumOut": "CumIn"})
def _health_accum(ctx, found, cum, attrs):
    """The running count of bad steps: CumOut = CumIn + (found ? 1 : 0),
    a float32 [1].  It is health state, which the gate never reverts, so
    it counts the masked steps of a run_steps chain too."""
    f = (found.reshape(()).float() > 0).float()
    return (cum.reshape(()).float() + f).reshape(1)


@simple_op("health_fault_inject", ["X", "Counter"], ["Out", "CounterOut"],
           grad=None, inplace={"Out": "X", "CounterOut": "Counter"})
def _health_fault_inject(ctx, x, counter, attrs):
    """A planted numeric fault (FaultPlan ``nan:grad:step:N``,
    ``inf:loss:step:N``, ``spike:loss:step:N[:scale]``): the counter
    starts at N and counts down once a run of this program; X is
    corrupted on the run where it reads 1 (a NaN or an Inf added, or
    multiplied by the spike's scale), in float32, cast back to X's
    dtype.  The counter is health state, so the replay of a rolled-back
    step reads 0 and runs clean."""
    c = counter.reshape(()).float()
    fire = c == 1.0
    kind = attrs.get("kind", "nan")
    xf = x.float()
    if kind == "nan":
        bad = xf + torch.where(fire, float("nan"), 0.0)
    elif kind == "inf":
        bad = xf + torch.where(fire, float("inf"), 0.0)
    else:  # spike: a multiplicative blow-up that stays finite
        bad = xf * torch.where(fire, float(attrs.get("spike_scale", 1000.0)),
                               1.0)
    c_new = torch.clamp_min(c - 1.0, 0.0)
    return bad.to(x.dtype), c_new.reshape(1)
