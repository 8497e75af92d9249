"""append_backward: symbolic reverse-mode autodiff over the op graph
(counterpart of ``paddle_tpu/fluid/backward.py``).

A reverse walk over the forward ops appends one grad op desc per op:
the op's own grad maker where it has one (``dropout``,
``fused_bias_act_dropout`` replay their saved mask), else the generic
``<type>_grad`` desc whose lowering the registry derives with
autograd or a hand-written one replaces.  A var read by
several ops collects one partial grad per reader (``@GRAD@RENAME@<n>``)
and a ``sum`` op adds them.  Grad var names, attrs and op order are the
JAX package's, so both packages build the same training program.

:func:`gradients` (``fluid.gradients``) is a pass of its own over a
program that may already carry grad ops: its grad names never reuse an
earlier pass's, and the grad ops it differentiates get their
second-order grad ops from the registry (fluid/registry.py,
``grad="lazy"``).
"""

from __future__ import annotations

import collections

from . import registry
from .framework import Variable, grad_var_name

__all__ = ["append_backward", "gradients"]

_FLOAT_DTYPES = ("float16", "bfloat16", "float32", "float64")


def _differentiable(info):
    return info is not None and (info.grad is not None
                                 or info.grad_maker is not None)


def _requires_grad_vars(block, no_grad_set):
    """Forward sweep: the names that carry a gradient."""
    live = {name for name, v in block.vars.items()
            if not v.stop_gradient and name not in no_grad_set
            and v.dtype in _FLOAT_DTYPES}
    for op in block.ops:
        info = registry.get_op(op.type) if registry.has_op(op.type) else None
        if info is not None and not _differentiable(info):
            continue
        if any(n in live for n in op.input_arg_names):
            for n in op.output_arg_names:
                v = block._find_var_recursive(n)
                if n not in no_grad_set and v is not None \
                        and v.dtype in _FLOAT_DTYPES:
                    live.add(n)
    return live


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None, loss_grad_var=None):
    """Append grad ops for ``loss`` to its program; returns
    [(param, param_grad_var)] for the trainable parameters that receive
    a gradient.  ``loss_grad_var`` (a var or its name) seeds the pass in
    place of ones (``gradients``' ``target_gradients``).  ``callbacks``
    and ``checkpoints`` are accepted and unused, as in the JAX
    package."""
    program = loss.block.program
    block = program.global_block()
    no_grad_set = {v.name if isinstance(v, Variable) else v
                   for v in (no_grad_set or ())}

    loss_pos = None
    for i, op in enumerate(block.ops):
        if loss.name in op.output_arg_names:
            loss_pos = i
    if loss_pos is None:
        raise ValueError(f"loss var {loss.name} is not produced by any op")
    live = _requires_grad_vars(block, no_grad_set)
    if loss.name not in live:
        raise ValueError("loss does not depend on any trainable variable")

    uniq_counter = collections.defaultdict(int)
    # names present before this pass: a grad name never reuses one
    pre_existing = set(block.vars.keys())

    def uniq(var_name):
        while True:
            c = uniq_counter[var_name]
            uniq_counter[var_name] += 1
            g = (grad_var_name(var_name) if c == 0
                 else f"{grad_var_name(var_name)}@RENAME@{c}")
            if g not in pre_existing:
                return g

    def make_grad_var(name, like_name):
        src = block._find_var_recursive(like_name)
        if not block.has_var(name):
            block.create_var(name=name,
                             shape=src.shape if src is not None else None,
                             dtype=src.dtype if src is not None
                             else "float32",
                             stop_gradient=True)
        return name

    # seed: d loss / d loss = 1, or the caller's target gradient
    if loss_grad_var is not None:
        loss_grad = (loss_grad_var.name
                     if isinstance(loss_grad_var, Variable)
                     else loss_grad_var)
    else:
        loss_grad = grad_var_name(loss.name)
        if loss_grad in pre_existing:
            loss_grad = uniq(loss.name)
        make_grad_var(loss_grad, loss.name)
        if loss.shape is not None and all(d != -1 for d in loss.shape):
            block.append_op("fill_constant", outputs={"Out": [loss_grad]},
                            attrs={"shape": list(loss.shape),
                                   "dtype": loss.dtype, "value": 1.0,
                                   "op_role": "backward"})
        else:  # a target with a dynamic dim: ones of the run-time shape
            block.append_op("fill_any_like", inputs={"X": [loss]},
                            outputs={"Out": [loss_grad]},
                            attrs={"value": 1.0, "op_role": "backward"})

    # partials[var] = grad var names still to be added up
    partials: dict = collections.defaultdict(list)
    partials[loss.name].append(loss_grad)
    finalized: dict = {}

    def finalize_grad(var_name):
        """One grad var for ``var_name``: its only partial, or a ``sum``
        of its partials (fan-out)."""
        if var_name in finalized:
            return finalized[var_name]
        parts = partials.get(var_name)
        if not parts:
            return None
        if len(parts) == 1:
            g = parts[0]
        else:
            g = grad_var_name(var_name)
            if g in parts or g in pre_existing:
                g = f"{g}@ACC"
                while g in pre_existing:
                    g += "C"
            make_grad_var(g, var_name)
            block.append_op("sum", inputs={"X": list(parts)},
                            outputs={"Out": [g]},
                            attrs={"op_role": "backward"})
        finalized[var_name] = g
        return g

    for fwd_idx, op in reversed(list(enumerate(block.ops[:loss_pos + 1]))):
        if not registry.has_op(op.type):
            continue
        info = registry.get_op(op.type)
        if not _differentiable(info):
            continue
        out_grads = {}
        for n in op.output_arg_names:
            g = finalize_grad(n)
            if g is not None:
                out_grads[n] = g
        if not out_grads:
            continue
        wanted = {n for n in op.input_arg_names
                  if n in live and n not in no_grad_set}
        if not wanted:
            continue
        if info.grad_maker is not None:
            descs, pairs = info.grad_maker(op, out_grads, wanted, uniq)
        else:
            descs, pairs = _default_grad_descs(op, info, out_grads, wanted,
                                               uniq)
        for gtype, gins, gouts, gattrs in descs:
            gattrs = dict(gattrs)
            gattrs["op_role"] = "backward"
            # the forward op this grad op differentiates (the fusion
            # passes locate grad groups by it)
            gattrs["fwd_op_idx"] = fwd_idx
            for names in gouts.values():
                for n in names:
                    make_grad_var(n, n.split("@GRAD")[0])
            block.append_op(gtype, inputs=gins, outputs=gouts, attrs=gattrs)
        for var_name, g in pairs:
            partials[var_name].append(g)

    if parameter_list is not None:
        params = [block.var(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = [p for p in block.all_parameters() if p.trainable]
    result = []
    for p in params:
        g = finalize_grad(p.name)
        if g is None:
            continue
        gv = block.var(g)
        if gv.shape is None:
            gv.shape = p.shape
        result.append((p, gv))
    program._bump_version()
    return result


def _default_grad_descs(op, info, out_grads, wanted, uniq):
    """The generic ``<type>_grad`` desc: every forward input, one
    ``<Out>@GRAD`` per forward output that has a grad, one
    ``<In>@GRAD`` per wanted input.  A list-valued output slot needs a
    grad for each of its names, by position: one no reader
    differentiates gets a ``fill_zeros_like`` op (``<name>@GRAD@ZERO``)
    ahead of the grad op, as in the JAX package."""
    pre_descs = []
    gins = {}
    for slot in info.input_slots:
        cslot = slot.rstrip("*")
        if cslot in op.inputs:
            gins[cslot] = list(op.inputs[cslot])
    for slot in info.output_slots:
        cslot = slot.rstrip("*")
        names = op.outputs.get(cslot, [])
        if not names:
            continue
        if info.is_variadic(slot):
            if not any(n in out_grads for n in names):
                continue
            gnames = []
            for n in names:
                if n in out_grads:
                    gnames.append(out_grads[n])
                else:
                    z = grad_var_name(n) + "@ZERO"
                    pre_descs.append(("fill_zeros_like", {"X": [n]},
                                      {"Out": [z]}, {}))
                    gnames.append(z)
            gins[cslot + "@GRAD"] = gnames
        elif names[0] in out_grads:
            gins[cslot + "@GRAD"] = [out_grads[names[0]]]
    gouts = {}
    pairs = []
    for slot in info.input_slots:
        cslot = slot.rstrip("*")
        if cslot in info.no_grad_inputs:
            continue
        names = op.inputs.get(cslot, [])
        if not names:
            continue
        if info.is_variadic(slot):
            if not any(n in wanted for n in names):
                continue
            out_names = []
            for n in names:
                g = uniq(n)
                out_names.append(g)
                if n in wanted:
                    pairs.append((n, g))
            gouts[cslot + "@GRAD"] = out_names
        else:
            n = names[0]
            if n not in wanted:
                continue
            g = uniq(n)
            gouts[cslot + "@GRAD"] = [g]
            pairs.append((n, g))
    return pre_descs + [(info.type + "_grad", gins, gouts,
                         dict(op.attrs))], pairs


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """``fluid.gradients``: the grads of ``targets`` with respect to
    ``inputs``, one var (or None) an input.

    The inputs ride through ``parameter_list``, so each call returns
    its own pass's grad vars, never a stale ``<name>@GRAD`` of an
    earlier pass over the same program; every trainable parameter's
    grad is finalized in the same pass, as an optimizer stacked on a
    penalty loss expects.  ``target_gradients`` seeds the pass (ones by
    default)."""
    t = targets[0] if isinstance(targets, (list, tuple)) else targets
    tg = (target_gradients[0]
          if isinstance(target_gradients, (list, tuple))
          else target_gradients)
    names = [iv.name if isinstance(iv, Variable) else iv
             for iv in (inputs if isinstance(inputs, (list, tuple))
                        else [inputs])]
    block = t.block.program.global_block()
    wanted = list(dict.fromkeys(
        names + [p.name for p in block.all_parameters() if p.trainable]))
    pairs = append_backward(t, parameter_list=wanted,
                            no_grad_set=no_grad_set, loss_grad_var=tg)
    gmap = {p.name: g for p, g in pairs}
    return [gmap.get(name) for name in names]
