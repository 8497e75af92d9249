"""Control-flow ops: while, conditional_block, static_rnn, recurrent
and print (counterpart of ``paddle_tpu/ops/control_flow_ops.py``).

Each op owns a sub-block of op descs.  The layers
(fluid/layers/control_flow.py) declare every value the sub-block reads
from an enclosing block as an op input, so a lowering builds the
sub-block's environment from its inputs alone:

  Carry*   — outer vars the sub-block writes (loop carries),
  Extra*   — float values it only reads (weights: append_backward
             differentiates them through the derived grad op),
  ExtraNG* — non-float values it only reads (ids, masks),

and the name lists ride in the attrs (``carry_names``,
``extra_names``, ``extra_ng_names``).  A lowering runs the sub-block
with ``executor.run_sub_block``, the counterpart of the JAX package's
``_trace_sub``.  Where the JAX package lowers to XLA's functional
control flow:

  while             a host loop that reads the [1] predicate after
                    each body (lax.while_loop); no grad.  A plan with
                    one runs eagerly (executor.HOST_OPS).
  conditional_block the body runs, then each carry is selected with
                    torch.where on the predicate, which stays on the
                    device (lax.cond), so the op is captured with its
                    plan.  Grad derived through the select.
  static_rnn        a Python loop over dim 0 of the step inputs
                    (lax.scan), unrolled into a captured graph; grad
                    derived through the loop.
  recurrent         the reference's exported StaticRNN op, the same
                    loop under the reference's names.
  print             prints from the host (jax.debug.print); a plan with
                    one runs eagerly.

``conditional_block_infer`` is the reference's inference-mode twin of
``conditional_block`` (``paddle_tpu/ops/interop_tail_ops.py:235``, an
alias there): the same lowering, no grad.  Programs in Fluid's protobuf
format name the reference signatures of ``while`` (X, Condition → Out,
StepScopes) and ``conditional_block`` (Input, Cond → Out, Scope);
``fluid/proto_compat.py`` rewrites them onto the slots above when it
reads the program.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.fluid.registry import simple_op
from paddle_tpu_torch.fluid.struct_values import (is_struct_value,
                                                  struct_clone,
                                                  struct_select)


def _run_sub(ctx, attrs, env):
    from paddle_tpu_torch.fluid.executor import run_sub_block

    sub = ctx.program.block(attrs["sub_block"])
    return run_sub_block(ctx, sub, env)


def _sub_env(attrs, carries, extras, extras_ng):
    env = dict(zip(attrs["extra_names"], extras or []))
    env.update(zip(attrs["extra_ng_names"], extras_ng or []))
    env.update(zip(attrs["carry_names"], carries or []))
    return env


def _as_pred(c):
    return c.reshape(()).bool()


def _match_carry(ref, val):
    """A body's value of a carry in the carry's dtype: under the bf16
    policy a body may give fp32 where the carry came in bf16 (an
    all-scalar tail), and the JAX package's loops require the carry's
    type."""
    if is_struct_value(val) or is_struct_value(ref):
        return val
    return val.to(ref.dtype) if val.dtype != ref.dtype else val


@simple_op("while", ["Condition", "Carry*", "Extra*", "ExtraNG*"], ["Out*"],
           grad=None)
def _while(ctx, cond, carries, extras, extras_ng, attrs):
    """Run the sub-block while the carried condition var holds.  The
    condition must be among the carries: the body computes it again,
    as in ``layers.less_than(i, n, cond=cond)`` at its end."""
    carry_names = attrs["carry_names"]
    cond_name = attrs["cond_name"]
    if cond_name not in carry_names:
        raise ValueError(
            f"while: condition var {cond_name!r} is never written in the "
            f"loop body (infinite loop); update it, e.g. "
            f"layers.less_than(i, n, cond=cond)")
    ci = carry_names.index(cond_name)
    base = _sub_env(attrs, [], extras, extras_ng)
    carry = list(carries)
    while bool(_as_pred(carry[ci])):  # the host reads the predicate
        env = dict(base)
        env.update(zip(carry_names, carry))
        _run_sub(ctx, attrs, env)
        carry = [_match_carry(ref, env[n])
                 for ref, n in zip(carry, carry_names)]
    return (carry,)


@simple_op("conditional_block", ["Cond", "Carry*", "Extra*", "ExtraNG*"],
           ["Out*"], no_grad_inputs=("Cond", "ExtraNG"))
def _conditional_block(ctx, cond, carries, extras, extras_ng, attrs):
    """Out_i = cond ? sub_block(...)[carry_i] : carry_i.

    The body always runs, on copies of the carries: an op of the body
    may update its input in place (``sgd``, ``adam``), and a false
    predicate must leave every carry as it was, bit for bit.  Then each
    carry is selected on the device."""
    carry_names = attrs["carry_names"]
    env = _sub_env(attrs, [struct_clone(c) for c in carries], extras,
                   extras_ng)
    _run_sub(ctx, attrs, env)
    pred = _as_pred(cond)
    return ([struct_select(pred, _match_carry(ref, env[n]), ref)
             for ref, n in zip(carries, carry_names)],)


simple_op("conditional_block_infer",
          ["Cond", "Carry*", "Extra*", "ExtraNG*"], ["Out*"],
          no_grad_inputs=("Cond", "ExtraNG"), grad=None)(_conditional_block)


@simple_op("static_rnn", ["StepIn*", "Init*", "Extra*", "ExtraNG*"],
           ["StackedOut*", "LastMem*"], no_grad_inputs=("ExtraNG",))
def _static_rnn(ctx, step_ins, inits, extras, extras_ng, attrs):
    """The sub-block once a step over dim 0 of the step inputs.

    attrs: sub_block, step_in_names (each step's slice, local names),
    mem_names (the carried memories, local names), update_map (memory
    -> the local name of its next value), out_names (each step's
    outputs).  Returns the step outputs stacked on dim 0 and the last
    memories."""
    step_in_names = attrs["step_in_names"]
    mem_names = attrs["mem_names"]
    update_map = attrs["update_map"]
    out_names = attrs["out_names"]
    if not step_ins:
        raise ValueError("static_rnn needs a step input")
    base = {}
    base.update(zip(attrs["extra_names"], extras or []))
    base.update(zip(attrs["extra_ng_names"], extras_ng or []))
    mems = list(inits or [])
    outs = [[] for _ in out_names]
    for t in range(step_ins[0].shape[0]):
        env = dict(base)
        env.update(zip(mem_names, mems))
        env.update(zip(step_in_names, [x[t] for x in step_ins]))
        _run_sub(ctx, attrs, env)
        mems = [_match_carry(ref, env[update_map[m]])
                for ref, m in zip(mems, mem_names)]
        for o, n in zip(outs, out_names):
            o.append(env[n])
    return [torch.stack(o) for o in outs], mems


@simple_op("print", ["X"], ["Out"])
def _print(ctx, x, attrs):
    """X unchanged, printed from the host as ``message: values``."""
    if ctx.device.type != "meta":
        msg = attrs.get("message") or "print"
        vals = x.detach()
        vals = (vals.float() if vals.is_floating_point() else vals).cpu()
        print(f"{msg}: {vals.numpy()}", flush=True)
    return x


@simple_op("recurrent", ["inputs*", "initial_states*", "parameters*"],
           ["outputs*", "step_scopes"])
def _recurrent(ctx, seq_ins, init_states, params, attrs):
    """The reference StaticRNN's exported op (recurrent_op.cc).

    The sub-block reads each sequence input and writes each stacked
    output under the outer var's own name; ``ex_states`` / ``states``
    name the previous and the updated memories, in ``initial_states``
    order.  Sequence inputs are time-major [T, ...]; ``reverse`` walks
    time backward (outputs flipped back, so out[t] is in[t]'s)."""
    op = ctx.cur_op
    if op is None or op.type != "recurrent":
        raise NotImplementedError(
            "recurrent: its names come from the op itself, so it runs "
            "forward only (its derived grad is not ported)")
    in_names = op.inputs.get("inputs", [])
    param_names = op.inputs.get("parameters", [])
    out_names = op.outputs.get("outputs", [])
    ex_states = attrs.get("ex_states", [])
    states = attrs.get("states", [])
    reverse = bool(attrs.get("reverse", False))
    base = dict(zip(param_names, params or []))
    xs = [torch.flip(v, dims=[0]) if reverse else v for v in seq_ins or []]
    mems = list(init_states or [])
    outs = [[] for _ in out_names]
    for t in range(xs[0].shape[0]):
        env = dict(base)
        env.update(zip(ex_states, mems))
        env.update(zip(in_names, [x[t] for x in xs]))
        _run_sub(ctx, attrs, env)
        mems = [_match_carry(ref, env[n]) for ref, n in zip(mems, states)]
        for o, n in zip(outs, out_names):
            o.append(env[n])
    stacked = [torch.stack(o) for o in outs]
    return ([torch.flip(o, dims=[0]) if reverse else o for o in stacked],
            None)
