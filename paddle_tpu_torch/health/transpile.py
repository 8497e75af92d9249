"""Fold the health sentinel into a Program (counterpart of
``paddle_tpu/health/transpile.py``; the same op sequence and the same
``@HEALTH@`` variables on the same program).

``insert_health_sentinel(program)`` rewrites the program in place,
after the graph passes and before the executor plans it:

1. **The check**: before the first optimizer op, one op over the
   gradients the optimizer ops read (their ``Grad`` inputs; a fused
   keep-quant op's ``QScale``) writes the bool ``@HEALTH@found_inf``:
   ``health_check`` (read only), or with dynamic loss scaling
   ``check_finite_and_unscale``, which also divides the gradients by
   the live scale.
2. **The response inside the step**: ``health_accum`` counts bad steps
   into ``@HEALTH@bad_steps_total`` (a run_steps chain's host reads only
   that); with FLAGS_health_loss_scaling ``update_loss_scaling`` halves
   ``@HEALTH@loss_scale`` on a bad step and doubles it after N good
   ones, and a ``scale`` op multiplies the backward seed by it.  The
   bad step's state writes are masked by the executor's gate
   (health/gating.py), so the step is skipped, moments included.
3. **Planted faults**: each numeric FaultPlan rule (``nan:grad:step:N``,
   ``inf:loss:step:N``, ``spike:loss:step:N``;
   distributed/fault_injection.py ``numeric_rules``) becomes a
   ``health_fault_inject`` op with its own countdown
   ``@HEALTH@fault_<i>``, which fires on the program's N-th run; a
   rollback replay of that run reads 0 and runs clean.

Idempotent through ``program._health_plan``; returns the plan, or None
for a program without optimizer ops to guard.
"""

from __future__ import annotations

import warnings

import numpy as np

__all__ = ["insert_health_sentinel", "FOUND_INF_VAR", "LOSS_SCALE_VAR",
           "BAD_TOTAL_VAR", "HEALTH_PREFIX"]

HEALTH_PREFIX = "@HEALTH@"
FOUND_INF_VAR = HEALTH_PREFIX + "found_inf"
LOSS_SCALE_VAR = HEALTH_PREFIX + "loss_scale"
BAD_TOTAL_VAR = HEALTH_PREFIX + "bad_steps_total"
GOOD_STEPS_VAR = HEALTH_PREFIX + "good_steps"
BAD_STEPS_VAR = HEALTH_PREFIX + "bad_steps"

_GRAD_SUFFIX = "@GRAD"

# DP fused keep-quant optimizer ops: the gradient never exists as an
# fp32 tensor — the wire-format QScale vector is the detection surface
_WIRE_FORMAT_OPT_OPS = frozenset({
    "fused_sgd_quant_grad", "fused_adam_quant_grad",
    "fused_adamw_quant_grad", "fused_momentum_quant_grad"})


def _optimizer_ops(ops):
    out = []
    for i, op in enumerate(ops):
        if op.attrs.get("op_role") != "optimize":
            continue
        if op.type in _WIRE_FORMAT_OPT_OPS or "Grad" in op.inputs:
            out.append((i, op))
    return out


def _check_inputs(opt_ops):
    """The distinct tensors the finite check covers, in first-use order:
    QScale for wire-format ops (shared per bucket — deduped), Grad for
    everything else."""
    seen, names = set(), []
    for _i, op in opt_ops:
        slot = "QScale" if op.type in _WIRE_FORMAT_OPT_OPS else "Grad"
        for n in op.inputs.get(slot, []):
            if n not in seen:
                seen.add(n)
                names.append(n)
    return names


def _raw_grads(program, opt_ops):
    raw = {g for _, g in getattr(program, "_params_grads", [])}
    if not raw:
        raw = {op.inputs["Grad"][0] for _, op in opt_ops
               if "Grad" in op.inputs}
    return raw


def _find_seed(ops, loss_name):
    """The backward seed: the fill_constant writing `<loss>@GRAD`.
    Returns (index, seed_var_name, loss_var_name) or (None, None, None).
    With loss_name unknown (hybrid/gspmd runners), the FIRST
    @GRAD-writing fill_constant is the seed — append_backward always
    emits it before any other backward op."""
    for i, op in enumerate(ops):
        if op.type != "fill_constant" or len(op.output_arg_names) != 1:
            continue
        out = op.output_arg_names[0]
        if not out.endswith(_GRAD_SUFFIX):
            continue
        loss = out[: -len(_GRAD_SUFFIX)]
        if loss_name is not None and loss != loss_name:
            continue
        return i, out, loss
    return None, None, None


def _last_producer(ops, name, before):
    idx = None
    for i, op in enumerate(ops[:before]):
        if name in op.output_arg_names:
            idx = i
    return idx


def insert_health_sentinel(program, loss_name=None, loss_scaling=None,
                           fault_plan=None):
    """Rewrite `program` in place for the health sentinel; idempotent.
    Returns the plan dict stored on ``program._health_plan`` (also the
    contract `gating.wrap_body` and `sentinel.HealthSentinel` read), or
    None when the program has no optimizer ops to guard."""
    existing = getattr(program, "_health_plan", None)
    if existing is not None:
        return existing

    from paddle_tpu_torch.fluid import flags as _flags
    from paddle_tpu_torch.fluid.framework import Operator

    if loss_scaling is None:
        loss_scaling = _flags.flag("health_loss_scaling")
    loss_scaling = bool(loss_scaling)

    block = program.global_block()
    ops = block.ops
    opt_ops = _optimizer_ops(ops)
    if not opt_ops:
        # warn only for programs that LOOK like training (a backward
        # exists but the optimizer does not — the PS-transpiled trainer
        # case); startup/inference programs pass silently
        if any(n.endswith(_GRAD_SUFFIX) for op in ops
               for n in op.output_arg_names):
            warnings.warn(
                "health sentinel: program has gradients but no local "
                "optimizer ops to guard (PS-transpiled trainer "
                "program?) — sentinel not inserted")
        return None
    check_names = _check_inputs(opt_ops)
    first_opt = opt_ops[0][0]
    seed_idx, seed_var, inferred_loss = _find_seed(ops, loss_name)
    loss_var = loss_name or inferred_loss

    state = {}

    def health_var(name, dtype, shape, default):
        block.create_var(name=name, dtype=dtype, shape=list(shape),
                         persistable=True)
        if default is not None:
            state[name] = np.asarray(default)

    scale_init = (float(_flags.flag("health_loss_scale_init"))
                  if loss_scaling else 1.0)
    health_var(FOUND_INF_VAR, "bool", [1], None)  # pure in-graph write
    health_var(LOSS_SCALE_VAR, "float32", [1],
               np.array([scale_init], np.float32))
    health_var(BAD_TOTAL_VAR, "float32", [1],
               np.array([0.0], np.float32))

    # -- the check + bookkeeping block, inserted before the first
    #    optimizer op (after every gradient collective: backward-role
    #    collectives precede optimize-role ops in program order).  With
    #    loss scaling ON the check IS the unscale
    #    (check_finite_and_unscale rewrites the gradients in place);
    #    with it OFF the read-only form saves a full-size
    #    divide-by-1.0 write-back pass over every gradient ------------
    if loss_scaling:
        check_op = Operator(
            block, "check_finite_and_unscale",
            inputs={"X": list(check_names), "Scale": [LOSS_SCALE_VAR]},
            outputs={"Out": list(check_names),
                     "FoundInfinite": [FOUND_INF_VAR]},
            attrs={"op_role": "optimize"})
    else:
        check_op = Operator(
            block, "health_check",
            inputs={"X": list(check_names)},
            outputs={"FoundInfinite": [FOUND_INF_VAR]},
            attrs={"op_role": "optimize"})
    sentinel_ops = [
        check_op,
        Operator(block, "health_accum",
                 inputs={"FoundInf": [FOUND_INF_VAR],
                         "CumIn": [BAD_TOTAL_VAR]},
                 outputs={"CumOut": [BAD_TOTAL_VAR]},
                 attrs={"op_role": "optimize"}),
    ]
    if loss_scaling:
        health_var(GOOD_STEPS_VAR, "int32", [1],
                   np.array([0], np.int32))
        health_var(BAD_STEPS_VAR, "int32", [1], np.array([0], np.int32))
        sentinel_ops.append(Operator(
            block, "update_loss_scaling",
            inputs={"PrevLossScaling": [LOSS_SCALE_VAR],
                    "FoundInfinite": [FOUND_INF_VAR],
                    "InGoodSteps": [GOOD_STEPS_VAR],
                    "InBadSteps": [BAD_STEPS_VAR]},
            outputs={"LossScaling": [LOSS_SCALE_VAR],
                     "OutGoodSteps": [GOOD_STEPS_VAR],
                     "OutBadSteps": [BAD_STEPS_VAR]},
            attrs={"op_role": "optimize",
                   "incr_every_n_steps":
                       int(_flags.flag("health_scale_growth_steps")),
                   # the issue contract: halve on EVERY bad step
                   "decr_every_n_nan_or_inf": 1,
                   "incr_ratio": 2.0, "decr_ratio": 0.5}))

    inserts = [(first_opt, sentinel_ops)]

    # -- loss-scale application: multiply the backward seed ------------
    if loss_scaling:
        if seed_idx is None:
            warnings.warn(
                "health sentinel: FLAGS_health_loss_scaling is on but "
                "no backward seed (fill_constant -> <loss>@GRAD) was "
                "found — gradients stay unscaled; the unscale divide "
                "by the live scale still applies")
        else:
            inserts.append((seed_idx + 1, [Operator(
                block, "scale",
                inputs={"X": [seed_var],
                        "ScaleTensor": [LOSS_SCALE_VAR]},
                outputs={"Out": [seed_var]},
                attrs={"op_role": "backward"})]))

    # -- deterministic numeric fault injection -------------------------
    if fault_plan is None:
        from paddle_tpu_torch.distributed import fault_injection

        fault_plan = fault_injection.active()
    rules = fault_plan.numeric_rules() if fault_plan is not None else []
    injected = []
    raw = _raw_grads(program, opt_ops)
    grad_site = None  # (insert-after index, grad name): first producer
    for i, op in enumerate(ops[:first_opt]):
        hit = raw.intersection(op.output_arg_names)
        if hit:
            grad_site = (i, sorted(hit)[0])
            break
    loss_site = (_last_producer(ops, loss_var, first_opt)
                 if loss_var else None)
    for k, rule in enumerate(rules):
        if rule["target"] == "grad":
            site = grad_site
        else:
            site = (loss_site, loss_var) if loss_site is not None else None
        if site is None:
            warnings.warn(
                f"health sentinel: no injection site for numeric fault "
                f"rule {rule['kind']}:{rule['target']} — skipped")
            continue
        at, target = site
        counter = f"{HEALTH_PREFIX}fault_{k}"
        health_var(counter, "float32", [1],
                   np.array([float(rule["step"])], np.float32))
        injected.append(dict(rule, target_var=target, counter=counter))
        inserts.append((at + 1, [Operator(
            block, "health_fault_inject",
            inputs={"X": [target], "Counter": [counter]},
            outputs={"Out": [target], "CounterOut": [counter]},
            attrs={"kind": rule["kind"],
                   "spike_scale": float(rule["scale"] or 1000.0)})]))

    # splice highest position first so earlier indices stay valid
    new_ops = list(ops)
    for pos, extra in sorted(inserts, key=lambda t: t[0], reverse=True):
        new_ops[pos:pos] = extra
    block.ops = new_ops

    plan = {
        "found_var": FOUND_INF_VAR,
        "scale_var": LOSS_SCALE_VAR,
        "bad_total_var": BAD_TOTAL_VAR,
        "loss_var": loss_var,
        "loss_scaling": loss_scaling,
        "check_inputs": check_names,
        "state": state,
        "injected": injected,
        "gate": True,
    }
    program._health_plan = plan
    program._bump_version()
    return plan
