"""Executor: runs a Program block op by op on one torch device.

Counterpart of ``paddle_tpu/fluid/executor.py``.  The JAX package traces
the whole block once into one XLA computation (``trace_block``) and
caches the compiled executable.  Here the block runs eagerly: each op's
lowering is called on tensors that already live on the device, under
``torch.no_grad()``.  What is cached per (program version, feed names,
fetch names) is the plan — the pruned op list with its resolved
lowerings and the scope reads — so a steady-state step pays no graph
analysis.

Scope semantics follow the JAX package: a name → tensor map; persistable
vars (parameters, the KV pool) live in the scope across runs as device
tensors and are written back after each run.  Where the JAX package
donates a buffer and gets a new one back, an op here may update the
scope's tensor in place (the kv_cache_write ops and ``adam`` do; see
ops/decode_ops.py and ops/optimizer_ops.py).  Not ``inference_mode``:
a tensor one program makes (the startup program's parameters) is
updated in place by another (``adam``), which PyTorch forbids for
inference tensors.  Grad ops derived by autograd turn grad mode on for
their own call.

Each value leaves the run's environment after its last reader, so a
training step holds what the backward still needs and no more.  Under
the bf16 dtype policy (``program._dtype_policy == "bf16"``) each op's
inputs are cast at the lowering, as in the JAX package's
``trace_block`` (:func:`_apply_bf16_policy`).

:func:`run_plan` is the op loop; the data-parallel runner
(parallel/data_parallel.py) drives it over one environment a replica.
``run`` also accepts a ``CompiledProgram`` (fluid/compiler.py), as the
JAX executor does.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from . import framework, registry
from .framework import Variable

__all__ = ["Executor", "Scope", "global_scope", "scope_guard"]


# ---------------------------------------------------------------------------
# Scope
# ---------------------------------------------------------------------------


class Scope:
    """Name → tensor map."""

    def __init__(self):
        self._vars = {}

    def get(self, name):
        return self._vars.get(name)

    def set(self, name, value):
        self._vars[name] = value

    def keys(self):
        return self._vars.keys()


_default_scope = Scope()
_scope_tls = threading.local()


def global_scope() -> Scope:
    """The ambient scope: a thread-local override (scope_guard) falling
    back to one process-wide default."""
    return getattr(_scope_tls, "scope", None) or _default_scope


@contextlib.contextmanager
def scope_guard(scope):
    old = getattr(_scope_tls, "scope", None)
    _scope_tls.scope = scope
    try:
        yield
    finally:
        _scope_tls.scope = old


# ---------------------------------------------------------------------------
# bf16 dtype policy, applied per op at the lowering
# ---------------------------------------------------------------------------

# loss ops that compute in fp32 under the policy (inputs upcast; outputs
# stay fp32 and a bf16 consumer casts its own inputs down)
_BF16_FP32_OPS = frozenset({
    "cross_entropy", "cross_entropy2", "mean", "reduce_mean",
    "sigmoid_cross_entropy_with_logits",
})

# fp32-internal ops whose parameter inputs stay fp32 masters:
# {op type: input positions the policy leaves untouched}
_BF16_KEEP_FP32_INPUTS = {
    "layer_norm": (1, 2),             # Scale, Bias
    "layer_norm_grad": (1, 2),
    "batch_norm": (1, 2, 3, 4),       # Scale, Bias, Mean, Variance
    "batch_norm_grad": (1, 2, 3, 4),
}


def _map_floats(vals, fn):
    def one(v):
        if v is None:
            return None
        if isinstance(v, (list, tuple)):
            return [one(x) for x in v]
        return fn(v) if v.is_floating_point() else v
    return [one(v) for v in vals]


def _all_float_inputs_scalar(vals):
    """True when the op reads floats and every one is a scalar (a loss
    tail): such ops stay fp32, so the loss fetch stays fp32."""
    found = False
    stack = list(vals)
    while stack:
        v = stack.pop()
        if v is None:
            continue
        if isinstance(v, (list, tuple)):
            stack.extend(v)
            continue
        if v.is_floating_point():
            found = True
            if v.numel() > 1:
                return False
    return found


def _apply_bf16_policy(op, vals):
    """Counterpart of the JAX executor's ``_apply_bf16_policy``: compute
    runs in bf16; optimizer ops, the fp32 loss ops and scalar tails see
    fp32 (grads are upcast at the optimizer edge)."""
    if (op.attrs.get("op_role") == "optimize"
            or op.type in _BF16_FP32_OPS or _all_float_inputs_scalar(vals)):
        return _map_floats(vals, lambda v: v.float()
                           if v.dtype == torch.bfloat16 else v)
    out = _map_floats(vals, lambda v: v.to(torch.bfloat16)
                      if v.dtype == torch.float32 else v)
    for i in _BF16_KEEP_FP32_INPUTS.get(op.type, ()):
        if i < len(out):
            out[i] = vals[i]
    return out


# ---------------------------------------------------------------------------
# Plan: prune + scope-dataflow analysis, once per signature
# ---------------------------------------------------------------------------


def _prune_ops(block, fetch_names):
    """Dead-op elimination: keep ops that contribute to a fetch target or
    write a persistable var.  The kv_cache_write ops are never fetched;
    they stay because their output is the persistable pool."""
    needed = set(fetch_names)
    kept = []
    for op in reversed(block.ops):
        if op.type in ("feed", "fetch"):
            continue
        keep = False
        for n in op.output_arg_names:
            if n in needed:
                keep = True
            else:
                v = block._find_var_recursive(n)
                if v is not None and v.persistable:
                    keep = True
        if not op.output_arg_names:
            keep = True
        if keep:
            kept.append(op)
            needed.update(op.input_arg_names)
    return list(reversed(kept))


class _Plan:
    """One (program version, feed names, fetch names) signature: the
    pruned ops with their lowerings and slot bindings, the names read
    from the scope, the names written back to it, and after each step
    the names no later step, fetch or write-back reads."""

    def __init__(self, program, feed_names, fetch_names):
        block = program.global_block()
        ops = _prune_ops(block, fetch_names)
        position = {id(op): i for i, op in enumerate(block.ops)}
        self.steps = []
        # each op's index in its block, as the JAX executor numbers ops
        # for the random streams (ctx.op_index)
        self.op_index = []
        produced = set(feed_names)
        self.scope_reads, self.writes = [], []
        for op in ops:
            self.op_index.append((block.idx << 16) | position[id(op)])
            info = registry.get_op(op.type)
            ins = []
            for slot in info.input_slots:
                names = op.inputs.get(slot.rstrip("*"), [])
                if info.is_variadic(slot):
                    ins.append((True, list(names)))
                else:
                    ins.append((False, names[0] if names else None))
            outs = []
            for slot in info.output_slots:
                names = op.outputs.get(slot.rstrip("*"), [])
                outs.append((info.is_variadic(slot), list(names)))
            self.steps.append((op, info, ins, outs))
            for n in op.input_arg_names:
                if n not in produced and n not in self.scope_reads:
                    self.scope_reads.append(n)
            for n in op.output_arg_names:
                produced.add(n)
                v = block._find_var_recursive(n)
                if v is not None and v.persistable and n not in self.writes:
                    self.writes.append(n)
        bad = [n for n in fetch_names if n not in produced]
        if bad:
            raise ValueError(f"fetch target(s) {bad} are not produced by "
                             f"this program (not an op output or a feed)")
        keep = set(fetch_names) | set(self.writes)
        last = {}
        for i, (op, _, _, _) in enumerate(self.steps):
            for n in op.input_arg_names + op.output_arg_names:
                last[n] = i
        self.frees = [[] for _ in self.steps]
        for n, i in last.items():
            if n not in keep:
                self.frees[i].append(n)

    def check_scope(self, scope):
        missing = [n for n in self.scope_reads if scope.get(n) is None]
        if missing:
            raise RuntimeError(
                f"Variables {missing} must exist in scope before running "
                f"this program (did you run the startup program?)")


# ---------------------------------------------------------------------------
# The op loop, over one environment or a replica group's
# ---------------------------------------------------------------------------


def run_seed(program, step):
    """Seed of a run's random stream: the program's random_seed and the
    executor step."""
    return (int(program.random_seed or 0) or 0x5EED) * 1000003 + step


def run_plan(plan, envs, ctxs, bf16):
    """Run ``plan``'s ops over ``envs`` (name -> tensor, one per replica;
    one outside a replica group) with one LowerContext each, in
    lockstep: each op runs once a replica on that replica's values, in
    replica order, and a collective op runs once over the list of every
    replica's values.  Values leave each env after their last reader."""
    n_rep = len(envs)
    if bf16 and ctxs[0].device.type == "cuda":
        # bf16 products accumulate in fp32, as the JAX package's do
        torch.backends.cuda.matmul \
            .allow_bf16_reduced_precision_reduction = False
    with torch.no_grad():
        for (op, info, ins, outs), frees, idx in zip(plan.steps, plan.frees,
                                                     plan.op_index):
            per = []
            for env in envs:
                vals = [[env[n] for n in names] if variadic
                        else (env.get(names) if names is not None else None)
                        for variadic, names in ins]
                per.append(_apply_bf16_policy(op, vals) if bf16 else vals)
            for ctx in ctxs:
                ctx.cur_op, ctx.op_index = op, idx
            if info.collective:
                out = info.lower(ctxs[0], *[list(c) for c in zip(*per)],
                                 attrs=op.attrs)
                out = out if isinstance(out, tuple) else (out,)
                results = [tuple(o[r] if o is not None else None
                                 for o in out) for r in range(n_rep)]
            else:
                results = []
                for ctx, vals in zip(ctxs, per):
                    o = info.lower(ctx, *vals, attrs=op.attrs)
                    results.append(o if isinstance(o, tuple) else (o,))
            for env, out in zip(envs, results):
                for (variadic, names), val in zip(outs, out):
                    if val is None or not names:
                        continue
                    if variadic:
                        env.update(zip(names, val))
                    else:
                        env[names[0]] = val
                for name in frees:
                    env.pop(name, None)


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


class Executor:
    """Drop-in for fluid.Executor.  ``place=None`` resolves to
    CUDAPlace(0); without a GPU the caller must pass CPUPlace()."""

    def __init__(self, place=None):
        self.place = framework.resolve_place(place)
        self.device = self.place.torch_device()
        self._plans: dict = {}
        self._step = 0

    def _graph_passes(self, program, fetch_names):
        """Graph passes (FLAGS_graph_passes): applied once per program,
        before the plan is keyed — placed as in the JAX executor."""
        from paddle_tpu_torch import passes as _passes

        _passes.apply_graph_passes(program, lane="single",
                                   keep_vars=fetch_names)

    def _coerce_feed(self, program, feed, device=None):
        """Feeds become tensors on the device (the executor's unless
        ``device`` is given), in the var's dtype."""
        device = self.device if device is None else device
        out = {}
        block = program.global_block()
        for name, val in (feed or {}).items():
            var = block._find_var_recursive(name)
            if isinstance(val, torch.Tensor):
                t = val.to(device)
            else:
                t = torch.from_numpy(np.ascontiguousarray(val)).to(device)
            if var is not None and var.dtype is not None:
                want = registry.torch_dtype(var.dtype)
                if t.dtype != want:
                    t = t.to(want)
            out[name] = t
        return out

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        from .compiler import CompiledProgram

        if isinstance(program, CompiledProgram):
            return program._run(self, feed, fetch_list, scope, return_numpy)
        if program is None:
            program = framework.default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = [f.name if isinstance(f, Variable) else f
                       for f in (fetch_list or [])]
        self._graph_passes(program, fetch_names)  # before the plan key
        feeds = self._coerce_feed(program, feed)
        key = (id(program), program._version, tuple(sorted(feeds)),
               tuple(fetch_names))
        plan = self._plans.get(key)
        if plan is None:
            plan = _Plan(program, feeds.keys(), fetch_names)
            self._plans[key] = plan
            self._plans[(key, "pin")] = program  # keep id() unique
        plan.check_scope(scope)

        env = {n: scope.get(n) for n in plan.scope_reads}
        env.update(feeds)
        # the run's random stream: seeded from the program's random_seed
        # and the executor step, so runs are reproducible
        ctx = registry.LowerContext(self.device, seed=run_seed(program,
                                                               self._step),
                                    is_test=program._is_test,
                                    step=self._step)
        run_plan(plan, [env], [ctx], program._dtype_policy == "bf16")
        for n in plan.writes:
            scope.set(n, env[n])
        self._step += 1
        fetches = [env[n] for n in fetch_names]
        if return_numpy:
            return [f.detach().cpu().numpy() for f in fetches]
        return fetches
