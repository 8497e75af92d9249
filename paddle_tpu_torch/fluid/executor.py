"""Executor: runs a Program block on one torch device, op by op or as a
replayed CUDA graph.

Counterpart of ``paddle_tpu/fluid/executor.py``.  The JAX package traces
the whole block once into one XLA computation and caches the compiled
executable per signature (``_CompiledBlock``, keyed by ``_cache_key``).
Here a signature — (program, version, feed names, shapes and dtypes,
fetch names, place, and on a capturing executor the scope) — gets a
plan: the pruned op list with its resolved lowerings and the scope
reads (:class:`_Plan`).  Then:

- on a CPU place, or with FLAGS_cuda_graph_capture off when the
  executor is made (the counterpart of running the JAX package under
  ``jax.disable_jit()``), every run calls the lowerings one after
  another, eagerly, under ``torch.no_grad()`` (:func:`run_plan`);
- on a CUDA place (FLAGS_cuda_graph_capture on, the default), the
  signature's first run is an eager warm-up on a side stream — it
  builds and loads the kernels, sets up cuBLAS's workspace and every
  lazy allocation — and then the same op loop is captured once as a
  CUDA graph (:class:`CapturedGraph`); every later run copies its feeds
  into the graph's buffers and replays it.  A replay costs one
  ``cudaGraphLaunch`` where the loop paid a launch a kernel.  A plan
  with a ``while``, a ``print`` or a ``detection_map`` op (at any depth
  of sub-blocks: the loop reads its predicate on the host each
  iteration, print writes from the host, detection_map computes on it),
  or one that reads neither scope nor feed (a startup
  program), runs eagerly by rule; ``conditional_block`` and
  ``static_rnn`` keep fixed shapes and are captured with the rest.  A capture that fails raises,
  naming the op; nothing falls back.  A graph keeps a private memory
  pool of one run's intermediates while it is held: an executor holds
  the graphs of its ``MAX_GRAPHS`` (8) most recently run signatures and
  frees the least recently run one beyond that, so feeds of many
  shapes do not pile pools up.

Scope semantics follow the JAX package: a name → tensor map; persistable
vars (parameters, the KV pool) live in the scope across runs as device
tensors.  Where the JAX package donates a buffer and gets a new one
back, an op here may update the scope's tensor in place (the
kv_cache_write ops and ``adam`` do; see ops/decode_ops.py and
ops/optimizer_ops.py).  A captured graph reads the scope's tensors in
place; a persistable the plan writes as a new tensor is copied back
into its scope tensor at the end of the graph (one it only writes takes
the graph's output), so the scope keeps the same tensors from replay to
replay.  A scope tensor the user replaces between runs is copied into
the graph's storage (or the signature is captured again).  Fetches
come back as copies.  Not ``inference_mode``: a tensor one program
makes (the startup program's parameters) is updated in place by another
(``adam``), which PyTorch forbids for inference tensors.  Grad ops
derived by autograd turn grad mode on for their own call.

Random ops draw from generators kept per signature and reseeded from
the executor step before each run (fluid/registry.py
``RandomStreams``), registered with the graph, so a replay draws what
the eager run of the same step draws.

Each value leaves the run's environment after its last reader (a
sub-block's reads count as its op's), so a training step holds what
the backward still needs and no more.  A control-flow op's lowering
runs its sub-block's ops over an environment of its own
(:func:`run_sub_block`, the counterpart of the JAX package's
``_trace_sub``), with the run's place, random streams, ``is_test``
and dtype policy.  Under
the bf16 dtype policy (``program._dtype_policy == "bf16"``) each op's
inputs are cast at the lowering, as in the JAX package's
``trace_block`` (:func:`_apply_bf16_policy`).

``run_steps`` runs n steps as n ``run()`` calls would (the reference's
``_CompiledChain``): on the card, the signature's one graph replayed n
times.  Every run books the JAX executor's metrics
(``pt_compile_cache_total``, ``pt_compile_seconds_total``,
``pt_step_seconds``), its step phases (observability/profiling.py) and
its ``step`` event (observability/events.py).  The data-parallel runner
(parallel/data_parallel.py) keeps a :class:`_Signature` of its replica
group, one environment a replica, and is its scope binding.  ``run`` also
accepts a ``CompiledProgram`` (fluid/compiler.py), as the JAX executor
does.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
import typing

import numpy as np
import torch

from ..kernels import _build
from . import framework, registry
from .framework import Variable
from .struct_values import is_struct_value

__all__ = ["Executor", "Scope", "global_scope", "scope_guard",
           "CapturedGraph", "MAX_GRAPHS", "HOST_OPS", "run_sub_block"]

# graphs an executor holds (each with a private pool of one run's
# intermediates); beyond it the least recently run one is freed
MAX_GRAPHS = 8

# ops that need the host during a run: a plan holding one (at any depth
# of sub-blocks) runs the eager loop, never a captured graph
# (detection_map reads its inputs on the host, as the JAX package's
# host_run does)
HOST_OPS = frozenset({"while", "print", "detection_map"})


# ---------------------------------------------------------------------------
# telemetry: the JAX executor's compile and step metrics, shared by the
# single-device path, the run_steps chain and the data-parallel runner
# ---------------------------------------------------------------------------


def _m_cache():
    from paddle_tpu_torch.observability import metrics

    return metrics.counter(
        "pt_compile_cache_total",
        "Executable-cache lookups by execution path and result: miss "
        "builds a plan (and on a CUDA place captures a graph), hit "
        "reuses one, eager is a plan that runs the eager loop by rule",
        labels=("path", "result"))


def _m_compile_seconds():
    from paddle_tpu_torch.observability import metrics

    return metrics.counter(
        "pt_compile_seconds_total",
        "Seconds spent building executables: phase=passes is a "
        "program's graph passes, phase=trace the plan build, "
        "phase=aot_load the warm-start cache's lookup (and on a hit "
        "the plan from its entry), phase=aot_save a miss's entry "
        "written, "
        "phase=capture the CUDA graph capture, phase=first_run the "
        "signature's whole first run (its eager warm-up and capture "
        "included)", labels=("path", "phase"))


def _m_step_seconds():
    from paddle_tpu_torch.observability import metrics

    return metrics.histogram(
        "pt_step_seconds",
        "Wall time of one executed step (the first sample per signature "
        "includes its warm-up and capture)", labels=("path",))


def _record_step(path, seconds, first_run):
    """Book one step into the step and compile metrics, the step-phase
    layer (observability/profiling.py reads the breakdown the path's
    step_phases recorder left on this thread) and the event log."""
    from paddle_tpu_torch.observability import events, profiling

    _m_step_seconds().labels(path=path).observe(seconds)
    if first_run:
        _m_compile_seconds().labels(path=path,
                                    phase="first_run").inc(seconds)
    profiling.note_step(path, seconds, first_run=bool(first_run))
    if events.enabled():
        events.emit("step", path=path, seconds=round(seconds, 6),
                    first_run=bool(first_run))


def _feed_batch(feed):
    """Global batch of a feed dict: the largest leading dim."""
    return max((int(np.shape(v)[0]) for v in feed.values()
                if np.shape(v)), default=0)


def _report_examples(path, batch, seconds):
    """Examples counter and last-step throughput gauge."""
    if not batch:
        return
    from paddle_tpu_torch.observability import metrics

    metrics.counter("pt_examples_total",
                    "Examples consumed by executed steps",
                    labels=("path",)).labels(path=path).inc(batch)
    if seconds > 0:
        metrics.gauge("pt_examples_per_sec",
                      "Throughput of the most recent step",
                      labels=("path",)).labels(path=path).set(
            batch / seconds)


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
        if v is None or is_struct_value(v):
            # a tensor array or rank table passes through: the op that
            # made its buffer set the buffer's dtype
            return v
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
        if v is None or is_struct_value(v):
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


def _adopt_program(program, entry):
    """Give ``program`` the blocks and pass report of a warm-start cache
    entry (fluid/aot_cache.py): the pass-rewritten form, so the passes
    do not run again."""
    from .io import program_from_dict

    cached = program_from_dict(entry["program"])
    for b in cached.blocks:
        b.program = program
    program.blocks = cached.blocks
    program.current_block_idx = 0
    passes = entry["passes"]
    program._graph_passes_done = tuple(passes["done"])
    program._graph_passes_spec = passes["spec"]
    if passes["report"] is not None:
        program._pass_report = passes["report"]
    program._bump_version()


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


def _sub_block_ops(program, op):
    """Every op of ``op``'s sub-block and of the sub-blocks inside it."""
    if "sub_block" not in op.attrs:
        return
    for sop in program.block(op.attrs["sub_block"]).ops:
        yield sop
        yield from _sub_block_ops(program, sop)


def _bind(op, info):
    """(op, info, input bindings, output bindings): each slot's name, or
    its list of names for a variadic slot."""
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
    return op, info, ins, outs


def _optional_in_out(op, info, block):
    """The names ``op`` reads through an optional slot and also writes
    that are not persistable (write_to_array's Array at the first
    write): a value the op makes when it is absent, not a scope read."""
    out_names = set(op.output_arg_names)
    names = set()
    for slot in info.optional:
        for n in op.inputs.get(slot, []):
            v = block._find_var_recursive(n)
            if n in out_names and (v is None or not v.persistable):
                names.add(n)
    return names


class _Group(typing.NamedTuple):
    """A run of consecutive ops that run as one call of their lowering's
    group form (registry.GroupLowering): the ops and each one's input
    and output bindings."""

    ops: list
    info: object
    ins: list
    outs: list


def _merge_groups(steps, index):
    """Each maximal run of consecutive ops of one type whose lowering has
    a group form, with equal group keys and no member reading or
    writing a name an earlier member of the run writes (a shared
    ``Beta1Pow``, say, which op by op the second op reads advanced),
    becomes one :class:`_Group` step; so does a lone such op, since the
    group form is how it runs.  Returns the steps and each one's op
    index (a list for a group)."""
    out, out_index, i = [], [], 0
    while i < len(steps):
        op, info = steps[i][:2]
        if info.group is None:
            out.append(steps[i])
            out_index.append(index[i])
            i += 1
            continue
        key, written, j = info.group.key(op), set(), i
        while j < len(steps):
            opj = steps[j][0]
            if opj.type != op.type or info.group.key(opj) != key \
                    or not written.isdisjoint(opj.input_arg_names
                                              + opj.output_arg_names):
                break
            written.update(opj.output_arg_names)
            j += 1
        run = steps[i:j]
        out.append(_Group([s[0] for s in run], info, [s[2] for s in run],
                          [s[3] for s in run]))
        out_index.append(index[i:j])
        i = j
    return out, out_index


class _Plan:
    """One (program version, feeds, fetch names) signature: the
    pruned ops with their lowerings and slot bindings (runs of ops with
    a group form merged into one step each), the names read from the
    scope, the names written back to it, and after each step the names
    no later step, fetch or write-back reads.

    ``cached`` (a :meth:`to_cache` dict, from the warm-start cache,
    fluid/aot_cache.py) gives the pruned ops' positions, the scope
    reads and writes, the host ops and the frees: the pruning and the
    liveness analysis do not run, and only the lowerings are bound."""

    def __init__(self, program, feed_names, fetch_names, cached=None):
        block = program.global_block()
        if cached is not None:
            ops = [block.ops[i] for i in cached["ops"]]
        else:
            ops = _prune_ops(block, fetch_names)
        position = {id(op): i for i, op in enumerate(block.ops)}
        self.positions = [position[id(op)] for op in ops]
        steps = []
        # each op's index in its block, as the JAX executor numbers ops
        # for the random streams (ctx.op_index)
        op_index = []
        produced = set(feed_names)
        self.scope_reads, self.writes = [], []
        for op in ops:
            op_index.append((block.idx << 16) | position[id(op)])
            info = registry.get_op(op.type)
            steps.append(_bind(op, info))
            if cached is not None:
                continue
            made_here = _optional_in_out(op, info, block)
            for n in op.input_arg_names:
                if n not in produced and n not in self.scope_reads \
                        and n not in made_here:
                    self.scope_reads.append(n)
            for n in op.output_arg_names:
                produced.add(n)
                v = block._find_var_recursive(n)
                if v is not None and v.persistable and n not in self.writes:
                    self.writes.append(n)
        if cached is not None:
            self.scope_reads = list(cached["scope_reads"])
            self.writes = list(cached["writes"])
            self.host_ops = list(cached["host_ops"])
        else:
            # runs the eager loop by rule: a HOST_OPS op (a while loop
            # reads its predicate each iteration, print writes from the
            # host), which a CUDA graph cannot hold
            self.host_ops = sorted({o.type for op in ops
                                    for o in [op, *_sub_block_ops(program,
                                                                  op)]
                                    if o.type in HOST_OPS})
            # a persistable no op writes is fetched from the scope (an
            # evaluator's state program is vars and no ops)
            bad = []
            for n in fetch_names:
                if n in produced:
                    continue
                v = block._find_var_recursive(n)
                if v is not None and v.persistable:
                    if n not in self.scope_reads:
                        self.scope_reads.append(n)
                else:
                    bad.append(n)
            if bad:
                raise ValueError(f"fetch target(s) {bad} are not produced "
                                 f"by this program (not an op output or a "
                                 f"feed)")
        # and a plan that reads neither the scope nor a feed (a startup
        # program) makes the same values from nothing every run, so a
        # graph would only pin a second copy of them
        self.eager_only = bool(self.host_ops) or not ops \
            or not (self.scope_reads or feed_names)
        self.steps, self.op_index = _merge_groups(steps, op_index)
        # (op type, members) of each group step
        self.group_sizes = [(g.ops[0].type, len(g.ops)) for g in self.steps
                            if isinstance(g, _Group)]
        if cached is not None:
            if len(cached["frees"]) != len(self.steps):
                raise ValueError("the cached plan's steps do not match")
            self.frees = [list(f) for f in cached["frees"]]
            return
        keep = set(fetch_names) | set(self.writes)
        last = {}
        for i, step in enumerate(self.steps):
            for op in step.ops if isinstance(step, _Group) else step[:1]:
                for n in op.input_arg_names + op.output_arg_names:
                    last[n] = i
                # a name a sub-block reads lives as long as its op
                for sop in _sub_block_ops(program, op):
                    for n in sop.input_arg_names:
                        last[n] = i
        self.frees = [[] for _ in self.steps]
        for n, i in last.items():
            if n not in keep:
                self.frees[i].append(n)

    def to_cache(self):
        """What the warm-start cache keeps of this plan (JSON)."""
        return {"ops": self.positions, "scope_reads": self.scope_reads,
                "writes": self.writes, "host_ops": self.host_ops,
                "frees": self.frees}

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


def _inputs(env, ins):
    return [[env[n] for n in names] if variadic
            else (env.get(names) if names is not None else None)
            for variadic, names in ins]


def _write(env, outs, out):
    for (variadic, names), val in zip(outs, out):
        if val is None or not names:
            continue
        if variadic:
            env.update(zip(names, val))
        else:
            env[names[0]] = val


def _as_tuple(o):
    return o if isinstance(o, tuple) else (o,)


def _run_op(step, idx, envs, ctxs, bf16):
    """One op over every env: [[(output bindings, outputs)]] a env."""
    op, info, ins, outs = step
    per = []
    for env in envs:
        vals = _inputs(env, ins)
        per.append(_apply_bf16_policy(op, vals) if bf16 else vals)
    for ctx in ctxs:
        ctx.cur_op, ctx.op_index = op, idx
    if info.collective:
        out = _as_tuple(info.lower(ctxs[0], *[list(c) for c in zip(*per)],
                                   attrs=op.attrs))
        return [[(outs, tuple(o[r] if o is not None else None
                              for o in out))] for r in range(len(envs))]
    return [[(outs, _as_tuple(info.lower(ctx, *vals, attrs=op.attrs)))]
            for ctx, vals in zip(ctxs, per)]


def _run_group(step, idx, envs, ctxs, bf16):
    """A group step: one call of the group form over every member op on
    every env, in replica order."""
    calls = []
    for env, ctx in zip(envs, ctxs):
        ctx.cur_op, ctx.op_index = step.ops[0], idx[0]
        for op, ins in zip(step.ops, step.ins):
            vals = _inputs(env, ins)
            calls.append((ctx, _apply_bf16_policy(op, vals) if bf16
                          else vals, op.attrs))
    out = step.info.group.lower(calls)
    k = len(step.ops)
    return [list(zip(step.outs, map(_as_tuple, out[r * k:(r + 1) * k])))
            for r in range(len(envs))]


def _precision_policy(bf16, device):
    """The precision and determinism policy of the library's products,
    set before a run or a capture starts on the card.  fp32 matmuls run
    in full fp32, never TF32; under the bf16 policy, bf16 products
    accumulate in fp32, as the JAX package's do.  cuDNN's convs never
    run in TF32 (fp32 convs accumulate in fp32, as
    ``mxu_conv_kwargs`` asks of XLA), and pick deterministic algorithms
    by heuristics, not by timing (``benchmark`` off): a captured step
    and an eager one give the same bits."""
    if device.type != "cuda":
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    if bf16:
        torch.backends.cuda.matmul \
            .allow_bf16_reduced_precision_reduction = False
    cudnn = torch.backends.cudnn
    cudnn.allow_tf32 = False
    cudnn.deterministic = True
    cudnn.benchmark = False


def _step_name(step):
    if isinstance(step, _Group):
        return f"{step.ops[0].type} (a group of {len(step.ops)})"
    return step[0].type


def run_plan(plan, envs, ctxs, bf16):
    """Run ``plan``'s ops over ``envs`` (name -> tensor, one per replica;
    one outside a replica group) with one LowerContext each, in
    lockstep: each op runs once a replica on that replica's values, in
    replica order, a collective op runs once over the list of every
    replica's values, and a group step (a run of ops with a group form)
    runs once over every member op on every replica.  Values leave each
    env after their last reader.  An exception leaves with the failing
    op's type in its ``pt_op`` attribute."""
    _precision_policy(bf16, ctxs[0].device)
    for ctx in ctxs:
        ctx.bf16 = bf16  # the sub-blocks of control-flow ops read it
    step = None
    try:
        with torch.no_grad():
            for step, frees, idx in zip(plan.steps, plan.frees,
                                        plan.op_index):
                run = _run_group if isinstance(step, _Group) else _run_op
                for env, results in zip(envs, run(step, idx, envs, ctxs,
                                                  bf16)):
                    for outs, out in results:
                        _write(env, outs, out)
                    for name in frees:
                        env.pop(name, None)
    except Exception as e:
        if step is not None and not hasattr(e, "pt_op"):
            try:
                e.pt_op = _step_name(step)
            except AttributeError:  # an exception type without a dict
                pass
        raise


def _sub_steps(block):
    """The bound ops of a sub-block with their op indices, made once a
    program version."""
    version = block.program._version
    cached = getattr(block, "_pt_steps", None)
    if cached is None or cached[0] != version:
        steps = []
        for pos, op in enumerate(block.ops):
            info = registry.get_op(op.type)
            if info.collective:
                raise NotImplementedError(
                    f"{op.type} inside a sub-block: collectives under "
                    f"control flow are not ported")
            steps.append((_bind(op, info), (block.idx << 16) | pos))
        cached = block._pt_steps = (version, steps)
    return cached[1]


def run_sub_block(ctx, block, env):
    """Run ``block``'s ops in order over ``env`` (name -> value, updated
    in place and returned) with ``ctx``: the run's device, random
    streams, step, ``is_test`` and bf16 policy (``ctx.bf16``) carry into
    the sub-block.  Each op's index in its block keys a seeded random
    op's stream, as at the top level.  The context's current op is
    restored on the way out."""
    bf16 = getattr(ctx, "bf16", False)
    prev = ctx.cur_op, ctx.op_index
    try:
        for (op, info, ins, outs), idx in _sub_steps(block):
            vals = _inputs(env, ins)
            if bf16:
                vals = _apply_bf16_policy(op, vals)
            ctx.cur_op, ctx.op_index = op, idx
            if info.group is not None:
                out = info.group.lower([(ctx, vals, op.attrs)])[0]
            else:
                out = info.lower(ctx, *vals, attrs=op.attrs)
            _write(env, outs, _as_tuple(out))
    finally:
        ctx.cur_op, ctx.op_index = prev
    return env


# ---------------------------------------------------------------------------
# CUDA-graph capture (the counterpart of the JAX executor's whole-block
# jax.jit with donation)
# ---------------------------------------------------------------------------


def warm_up(stream, fn):
    """``fn()`` on the side ``stream``, ordered after the current
    stream's work and before its next: a signature's eager run ahead
    of its capture."""
    cur = torch.cuda.current_stream(stream.device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        out = fn()
    cur.wait_stream(stream)
    return out


def _same_storage_shape(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and a.device == b.device


class CapturedGraph:
    """A plan's op loop over a replica group's envs (one env outside a
    group) captured once as a CUDA graph.

    ``inputs`` ({name: tensor} a replica) are the scope tensors the plan
    reads; the graph reads and updates them in place.  ``feeds`` ({name:
    tensor} a replica) give each feed's shape and dtype: the graph gets
    a buffer of each, which :meth:`set_feeds` fills before a replay.  A
    persistable the plan writes as a new tensor is copied back into its
    input tensor at the end of the graph; one the plan writes but never
    reads is the graph's own output (``outputs``), as are the fetches.
    ``body`` is the op loop captured (``run_plan``, or the health
    sentinel's gate around it: health/gating.py).
    Every generator of ``ctxs``' streams is registered with the graph,
    so its draws advance from the seed it holds at each replay.  A
    kernel wrapper's launch counter counts the capture (where it
    launches its kernel into the graph) and never a replay, which runs
    no Python: the kernels' own device counters
    (``kernels.device_launch_counts``) count every run on the card."""

    def __init__(self, plan, inputs, feeds, ctxs, bf16, stream, label,
                 fetch_names, body):
        self.label = label
        self.inputs = inputs
        self.feeds = [{n: torch.empty_like(v) for n, v in f.items()}
                      for f in feeds]
        self.set_feeds(feeds)
        self.graph = torch.cuda.CUDAGraph()
        streams = [c.streams for c in ctxs]
        for st in streams:
            for g in st.generators():
                self.graph.register_generator_state(g)
            st.frozen = True
        _precision_policy(bf16, stream.device)
        envs = [dict(i, **f) for i, f in zip(inputs, self.feeds)]
        t0 = time.perf_counter()
        try:
            # the outer stream context restores the thread's stream even
            # when a failed capture leaves torch.cuda.graph's own set;
            # thread_local: another thread's CUDA work (the decode
            # scheduler, a serving thread) may go on meanwhile
            with torch.cuda.stream(stream), torch.cuda.graph(
                    self.graph, stream=stream,
                    capture_error_mode="thread_local"):
                body(plan, envs, ctxs, bf16)
                for env, inp in zip(envs, inputs):
                    for n in plan.writes:
                        if n in inp and env[n] is not inp[n]:
                            inp[n].copy_(env[n])
        except Exception as e:
            op = getattr(e, "pt_op", None) or getattr(e.__context__,
                                                      "pt_op", None)
            raise RuntimeError(f"CUDA graph capture of {label} failed at "
                               f"op {op}: {e}") from e
        finally:
            for st in streams:
                st.frozen = False
        self.capture_seconds = time.perf_counter() - t0
        keep = [n for n in plan.writes if n not in inputs[0]] \
            + list(fetch_names)
        self.outputs = [{n: env[n] for n in keep} for env in envs]
        self.write_only = [n for n in plan.writes if n not in inputs[0]]

    def set_feeds(self, feeds):
        """Copy each replica's feed values into the graph's buffers."""
        for bufs, vals in zip(self.feeds, feeds):
            for n, buf in bufs.items():
                buf.copy_(vals[n])

    def replay(self):
        """One run of the captured loop on the current stream."""
        self.graph.replay()


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


class _ScopeBinding:
    """How the single-device executor's one replica reads and leaves
    the scope: its values are the scope's own tensors.  The
    data-parallel runner (parallel/data_parallel.py) is the binding of
    a replica group."""

    @staticmethod
    def values(scope, names):
        """[{name: tensor}] of the one replica."""
        return [{n: scope.get(n) for n in names}]

    @staticmethod
    def adopt(scope, inputs):
        """Before a replay: a scope tensor replaced since the capture is
        copied into the graph's storage (``inputs``), which the scope
        takes back.  False when one no longer fits it (the signature is
        captured again)."""
        for n, have in inputs[0].items():
            t = scope.get(n)
            if t is have:
                continue
            if not _same_storage_shape(t, have):
                return False
            have.copy_(t)
            scope.set(n, have)
        return True

    @staticmethod
    def left(scope, names, values):
        """The scope takes the replica's ``names`` from ``values``.  A
        value of another dtype than the scope's tensor of that shape
        (an integer counter blended with a float gate) is cast to the
        scope's dtype, as a captured graph's copy into its input
        tensor casts it: both modes leave the var's dtype."""
        for n in names:
            v, have = values[0][n], scope.get(n)
            if isinstance(have, torch.Tensor) and isinstance(
                    v, torch.Tensor) and v.dtype != have.dtype \
                    and v.shape == have.shape:
                v = v.to(have.dtype)
            scope.set(n, v)


class _Signature:
    """One cache entry: a signature's plan over a replica group (one
    replica outside the data-parallel runner, whose ``group`` is None),
    a RandomStreams a replica and, once captured, its graph.  A
    capturing executor keys an entry by its scope as well, so a graph
    only ever reads and writes the tensors of the scope it was captured
    on.  Its op loop is ``run_plan``, with the health sentinel's in-step
    gate around it when the program carries a health plan
    (health/gating.py)."""

    def __init__(self, program, plan, devices, label, group=None):
        from paddle_tpu_torch.health import gating

        self.program = program
        self.plan = plan
        self.body = gating.wrap_body(program, run_plan)
        self.devices = list(devices)
        self.label = label
        self.group = group
        self.streams = [registry.RandomStreams(
            d, None if group is None else r) for r, d in enumerate(devices)]
        self.graph = None
        self.ran = False
        self.aot_hit = False  # its plan came from the warm-start cache

    def _reseed(self, step):
        """Seed the random streams for the run at ``step``: a replica's
        seed folds its index into the run's."""
        seed = run_seed(self.program, step)
        seeds = [seed if st.replica is None
                 else registry.fold_seed(seed, st.replica)
                 for st in self.streams]
        for st, s in zip(self.streams, seeds):
            st.reseed(s, step)
        return seeds

    def _contexts(self, step):
        return [registry.LowerContext(
            dev, seed=s, is_test=self.program._is_test, step=step,
            replica=st.replica, group=self.group, streams=st,
            program=self.program)
            for dev, st, s in zip(self.devices, self.streams,
                                  self._reseed(step))]

    def execute(self, exe, binding, scope, feeds, fetch_names, ph, capture):
        """One run at the executor's step over ``feeds`` (a dict a
        replica): eager (and, with ``capture``, the warm-up and capture
        of the graph) until the signature has a graph, then a replay.
        Returns each fetch's tensors (a list a replica: the graph's
        outputs on a replay, which the caller copies) and the capture
        seconds (0.0 without a capture)."""
        plan = self.plan
        plan.check_scope(scope)
        bf16 = self.program._dtype_policy == "bf16"
        step = exe._step
        g = self.graph
        if g is not None:
            with ph.phase("feed_prep"):
                if not binding.adopt(scope, g.inputs):
                    self.graph = g = None
        if g is None:
            with ph.phase("feed_prep"):
                envs = binding.values(scope, plan.scope_reads)
                for env, f in zip(envs, feeds):
                    env.update(f)
                ctxs = self._contexts(step)
            with ph.phase("dispatch"):
                if capture:
                    warm_up(exe._side_stream(),
                            lambda: self.body(plan, envs, ctxs, bf16))
                else:
                    self.body(plan, envs, ctxs, bf16)
            fetches = [[env[n] for env in envs] for n in fetch_names]
            with ph.phase("device_wait"):
                ph.wait(fetches)
            with ph.phase("fetch_sync"):
                binding.left(scope, plan.writes, envs)
            if not capture:
                return fetches, 0.0
            self.graph = CapturedGraph(
                plan, binding.values(scope, plan.scope_reads), feeds, ctxs,
                bf16, exe._side_stream(), self.label, fetch_names,
                self.body)
            # the capture's in-place calls moved version counters that
            # no value change goes with
            binding.left(scope, plan.scope_reads, self.graph.inputs)
            return fetches, self.graph.capture_seconds
        with ph.phase("feed_prep"):
            g.set_feeds(feeds)
            self._reseed(step)
        with ph.phase("dispatch"):
            g.replay()
        with ph.phase("device_wait"):
            ph.wait([list(o.values()) for o in g.outputs])
        with ph.phase("fetch_sync"):
            binding.left(scope, g.write_only, g.outputs)
        return [[o[n] for o in g.outputs] for n in fetch_names], 0.0


class _Chain:
    """A run_steps cache entry: n runs of one signature, whose plan and
    graph it shows once it has run."""

    def __init__(self, label, n_steps, stacked_feed):
        self.label = label
        self.n_steps = n_steps
        self.stacked_feed = stacked_feed
        self.plan = self.graph = None
        self.ran = False


def _fetch_copies(fetches, return_numpy):
    """Copies of the fetches: numpy arrays (a bf16 tensor as float32,
    which holds it exactly: numpy has no bfloat16), else tensors."""
    if return_numpy:
        return [(f.float() if f.dtype == torch.bfloat16 else f)
                .detach().cpu().numpy() for f in fetches]
    return [f.clone() for f in fetches]


class Executor:
    """Drop-in for fluid.Executor.  ``place=None`` resolves to
    CUDAPlace(0); without a GPU the caller must pass CPUPlace().  On a
    CUDA place it captures each signature as a CUDA graph when
    FLAGS_cuda_graph_capture (on by default) is on as it is made, and
    runs the eager op loop otherwise, as a CPU place always does.

    A graph keeps a private memory pool of one run's intermediates for
    as long as it is held (a BERT-base b128 train step's holds 9.33 GB
    on an H100, PERF.md section 5): an executor holds the graphs of its
    :data:`MAX_GRAPHS` most recently run signatures and frees the least
    recently run one's beyond that; its next run captures it again."""

    def __init__(self, place=None):
        from . import flags

        self.place = framework.resolve_place(place)
        self.device = self.place.torch_device()
        self.capture = (bool(flags.flag("cuda_graph_capture"))
                        and self.device.type == "cuda")
        self._cache: dict = {}
        self._pins: dict = {}  # key -> what keeps its ids unique
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._step = 0
        self._stream = None
        self._sentinels: dict = {}  # id(program) -> HealthSentinel | None
        # FLAGS_metrics_port: the process's exposition server (and the
        # flag-driven SLO evaluator) start with its first executor
        from paddle_tpu_torch.observability import exposition

        exposition.ensure_from_flags()

    def _side_stream(self):
        """The stream signatures warm up and capture on."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def close(self):
        """Drop every cached plan and graph (and the graphs' memory)."""
        self._cache.clear()
        self._pins.clear()
        self._graphs.clear()
        self._sentinels.clear()

    def compiled_for(self, program):
        """The cache entries of ``program`` (one a signature, and one a
        run_steps chain), each with its ``label`` and ``plan``, and its
        ``graph`` once captured."""
        return [e for key, e in self._cache.items() if key[0] == id(program)]

    def _cache_key(self, program, scope, feeds, fetch_names):
        """One entry per (program version, feed names, shapes and dtypes,
        fetch list, place), and on a capturing executor per scope: a
        graph replays only at the shapes it was captured at, on the
        tensors of the scope it was captured on."""
        feed_sig = tuple((k, tuple(v.shape), str(v.dtype))
                         for k, v in sorted(feeds.items()))
        return (id(program), program._version, feed_sig,
                tuple(fetch_names), self.place,
                id(scope) if self.capture else None)

    def _graph_passes(self, program, fetch_names):
        """Graph passes (FLAGS_graph_passes): applied once per program,
        before the plan is keyed — placed as in the JAX executor."""
        from paddle_tpu_torch import passes as _passes

        _passes.apply_graph_passes(program, lane="single",
                                   keep_vars=fetch_names)

    def health_sentinel(self, program):
        """The health sentinel this executor attached to ``program``,
        attaching it now if needed (FLAGS_health_sentinel is read once a
        program here): ``health.attach`` inserts it into the program,
        which moves its version before the plan is keyed, as the JAX
        executor attaches it; None when the flag is off or the program
        has nothing to guard."""
        key = id(program)
        if key not in self._sentinels:
            from paddle_tpu_torch import health

            self._sentinels[key] = health.attach(program, lane="single",
                                                 device=self.device)
            self._pins[("health", key)] = (program,)
        return self._sentinels[key]

    def _check_nan_inf(self, plan, label, scope, fetch_names, fetches):
        """FLAGS_check_nan_inf: the host scan (health/detect.py) of every
        persistable the run wrote and every fetch; raises naming the
        first that holds a NaN or an Inf."""
        from . import flags

        if not flags.flag("check_nan_inf"):
            return
        from paddle_tpu_torch.health import detect

        detect.host_scan([(n, scope.get(n)) for n in plan.writes]
                         + list(zip(fetch_names, fetches)), label)

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

    def _prepare(self, program, feed, fetch_list, scope):
        """The shared preamble of run() and run_steps(): the program
        (default main), the scope (the ambient one), the fetch names,
        the graph passes, the health sentinel and the coerced feeds."""
        program = program if program is not None \
            else framework.default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = [f.name if isinstance(f, Variable) else f
                       for f in (fetch_list or [])]
        feeds = self._coerce_feed(program, feed)
        self._aot_lookup(program, feeds, fetch_names)  # before the passes
        first = getattr(program, "_graph_passes_done", None) is None
        t0 = time.perf_counter()
        self._graph_passes(program, fetch_names)  # before the plan key
        if first:
            _m_compile_seconds().labels(path="single", phase="passes").inc(
                time.perf_counter() - t0)
        self._aot_note_passes(program)
        sent = self.health_sentinel(program)  # may insert it: before the key
        return program, scope, fetch_names, feeds, sent

    # -- the warm-start cache (FLAGS_aot_cache_dir, fluid/aot_cache.py) --
    @staticmethod
    def _aot_signature(feeds, fetch_names):
        return (tuple((k, tuple(v.shape), str(v.dtype))
                      for k, v in sorted(feeds.items())),
                tuple(fetch_names))

    def _aot_lookup(self, program, feeds, fetch_names):
        """Before a program's passes first run: look its first signature
        up in the warm-start cache.  On a hit the program takes the
        cached pass-rewritten form (its blocks and pass report), so the
        passes do not run; the plan is taken from the entry when the
        signature is built (:meth:`_signature`)."""
        from . import aot_cache

        if not aot_cache.enabled() or hasattr(program, "_aot") \
                or getattr(program, "_graph_passes_done", None) is not None:
            return
        t0 = time.perf_counter()
        key = aot_cache.entry_key(program, feeds, fetch_names, self.device)
        entry = aot_cache.load(key)
        if entry is not None:
            try:
                _adopt_program(program, entry)
            except (KeyError, TypeError, ValueError) as e:
                aot_cache.stale(key, f"does not rebuild its program "
                                     f"({e!r})", "adopt")
                entry = None
        program._aot = {"key": key, "entry": entry,
                        "sig": self._aot_signature(feeds, fetch_names),
                        "seconds": time.perf_counter() - t0}

    @staticmethod
    def _aot_note_passes(program):
        """On a miss: the pass-rewritten program as the entry will keep
        it (the health sentinel, attached next, inserts its ops again
        on a hit)."""
        aot = getattr(program, "_aot", None)
        if aot is None or aot["entry"] is not None or "program" in aot:
            return
        from .io import program_to_dict

        aot["program"] = program_to_dict(program)
        aot["passes"] = {
            "done": list(getattr(program, "_graph_passes_done", ()) or ()),
            "spec": getattr(program, "_graph_passes_spec", None),
            "report": getattr(program, "_pass_report", None)}

    def _aot_plan(self, program, feeds, fetch_names):
        """The plan of a warm-start cache hit for this signature, else
        None (and a stale entry warns and goes)."""
        from . import aot_cache

        aot = getattr(program, "_aot", None)
        if aot is None or aot["entry"] is None or aot.get("used") \
                or aot["sig"] != self._aot_signature(feeds, fetch_names):
            return None
        aot["used"] = True
        plan = aot["entry"]["plan"]
        try:
            if plan["fingerprint"] != aot_cache.program_fingerprint(
                    program):
                raise ValueError("the program differs from the cached one")
            kernels = aot["entry"].get("kernels")
            if kernels:  # their builds are there (or are made now)
                _build.build_all(kernels)
            return _Plan(program, feeds.keys(), fetch_names, cached=plan)
        except (KeyError, IndexError, TypeError, ValueError) as e:
            aot_cache.stale(aot["key"], f"is stale ({e})")
            # the plan is built from the cached program, and the entry
            # saved again with it after the first run
            aot.update(program=aot["entry"]["program"],
                       passes=aot["entry"]["passes"])
            return None

    def _aot_save(self, program, sig):
        """After a miss's first run: save the entry (the program, the
        pass report, the plan and the kernel libraries loaded)."""
        from . import aot_cache

        aot = getattr(program, "_aot", None)
        if aot is None or "program" not in aot or aot.get("saved"):
            return
        aot["saved"] = True
        t0 = time.perf_counter()
        aot_cache.save(aot["key"], {
            "program": aot["program"], "passes": aot["passes"],
            "plan": dict(sig.plan.to_cache(),
                         fingerprint=aot_cache.program_fingerprint(program)),
            "kernels": _build.loaded()})
        _m_compile_seconds().labels(path="single", phase="aot_save").inc(
            time.perf_counter() - t0)

    def _pin(self, key, entry, *owners):
        self._cache[key] = entry
        self._pins[key] = owners  # keep the ids in ``key`` unique

    def _signature(self, program, scope, feeds, fetch_names, path):
        """The cache entry of this signature and whether it is new (its
        plan build booked as ``trace`` under ``path``)."""
        key = self._cache_key(program, scope, feeds, fetch_names)
        sig = self._cache.get(key)
        if sig is not None:
            return sig, False
        t0 = time.perf_counter()
        plan = self._aot_plan(program, feeds, fetch_names)
        aot_hit = plan is not None
        if plan is None:
            plan = _Plan(program, feeds.keys(), fetch_names)
        sig = _Signature(program, plan, [self.device],
                         f"program@{id(program):x}/v{program._version}")
        sig.aot_hit = aot_hit
        self._pin(key, sig, program, scope)
        aot = getattr(program, "_aot", None)
        if aot_hit:  # the lookup and the plan from the entry
            _m_compile_seconds().labels(path=path, phase="aot_load").inc(
                time.perf_counter() - t0 + aot.pop("seconds"))
        else:
            _m_compile_seconds().labels(path=path, phase="trace").inc(
                time.perf_counter() - t0)
            if aot is not None and "seconds" in aot:  # a miss's lookup
                _m_compile_seconds().labels(path=path,
                                            phase="aot_load").inc(
                    aot.pop("seconds"))
        return sig, True

    def _captures(self, plan):
        """Whether a signature of ``plan`` runs as a captured graph:
        decided from the place and the plan, before anything is
        captured."""
        return self.capture and not plan.eager_only

    def _run_signature(self, sig, binding, scope, feeds, fetch_names, ph,
                       path, new, capture=None):
        """``sig.execute`` with its bookings under ``path``: the capture
        seconds, and unless ``new`` is None (a chain's own iterations)
        the cache result — eager for a plan a capturing executor runs
        eagerly by rule, miss for a new signature or a capture, else
        hit.  The run's graph becomes the most recently run one."""
        if capture is None:
            capture = self._captures(sig.plan)
        fetches, cap_s = sig.execute(self, binding, scope, feeds,
                                     fetch_names, ph, capture)
        if cap_s:
            _m_compile_seconds().labels(path=path,
                                        phase="capture").inc(cap_s)
        if new is not None:
            result = ("eager" if self.capture and not capture
                      else "aot_hit" if new and sig.aot_hit
                      else "miss" if new or cap_s else "hit")
            _m_cache().labels(path=path, result=result).inc()
        if not sig.ran:
            self._aot_save(sig.program, sig)
        self._hold(sig)
        return fetches

    def _hold(self, sig):
        """Keep ``sig``'s graph among the :data:`MAX_GRAPHS` most
        recently run; free the least recently run one beyond that."""
        if sig.graph is None:
            self._graphs.pop(id(sig), None)
            return
        self._graphs[id(sig)] = sig
        self._graphs.move_to_end(id(sig))
        while len(self._graphs) > MAX_GRAPHS:
            _, old = self._graphs.popitem(last=False)
            old.graph = None

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        from paddle_tpu_torch.observability import profiling

        from .compiler import CompiledProgram

        if isinstance(program, CompiledProgram):
            return program._run(self, feed, fetch_list, scope, return_numpy)
        from paddle_tpu_torch.health import run_guarded

        program, scope, fetch_names, feeds, sent = self._prepare(
            program, feed, fetch_list, scope)
        sig, new = self._signature(program, scope, feeds, fetch_names,
                                   "single")
        step0 = self._step

        def attempt():
            # the replay of a rolled-back attempt runs at the same step
            # (the same random draws); the step counts once, below
            nonlocal new
            first_run = not sig.ran
            t0 = time.perf_counter()
            with profiling.step_phases("single", sig.label) as ph:
                fetches = self._run_signature(sig, _ScopeBinding, scope,
                                              [feeds], fetch_names, ph,
                                              "single", new)
                with ph.phase("fetch_sync"):
                    fetches = [f[0] for f in fetches]
                    if sig.graph is not None or return_numpy:
                        fetches = _fetch_copies(fetches, return_numpy)
                    self._check_nan_inf(sig.plan, sig.label, scope,
                                        fetch_names, fetches)
            _record_step("single", time.perf_counter() - t0, first_run)
            sig.ran = True
            new = False
            return fetches

        fetches = run_guarded(sent, scope, fetch_names, attempt)
        self._step = step0 + 1
        return fetches

    def run_steps(self, program=None, feed=None, n_steps=1, fetch_list=None,
                  scope=None, return_numpy=True, stacked_feed=False):
        """Run ``n_steps`` iterations of ``program``, as ``n_steps``
        ``run()`` calls with the same feed would: scope writes thread
        into the next iteration's reads and the executor step (and with
        it every random stream) advances per iteration.  With
        ``stacked_feed`` every feed carries a leading [n_steps] axis and
        iteration i reads slice i.  Only the final step's fetches
        return.

        On a CUDA place the chain is the signature's one graph replayed
        n times, each iteration's feed slice copied into its buffers on
        the device: it shares the graph ``run()`` captures, keeps the
        memory of one step whatever n is, and captures in the time of
        one step, where one graph of n iterations would hold n steps'
        intermediates and capture n times the ops."""
        from paddle_tpu_torch.observability import profiling

        from .compiler import CompiledProgram

        if isinstance(program, CompiledProgram):
            raise ValueError(
                "run_steps does not support CompiledProgram (data-parallel "
                "programs split feeds in their own run path) — use run() "
                "per step")
        if isinstance(n_steps, bool) or int(n_steps) != n_steps:
            raise ValueError(f"n_steps must be an int, got {n_steps!r}")
        n = int(n_steps)
        if n < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        from paddle_tpu_torch.health import run_guarded

        program, scope, fetch_names, feeds, sent = self._prepare(
            program, feed, fetch_list, scope)
        if stacked_feed:
            bad = {k: tuple(v.shape) for k, v in feeds.items()
                   if v.dim() == 0 or v.shape[0] != n}
            if bad:
                raise ValueError(f"stacked_feed arrays need a leading "
                                 f"[{n}] axis; got {bad}")
        key = self._cache_key(program, scope, feeds, fetch_names) + (
            "chain", n, bool(stacked_feed))
        chain = self._cache.get(key)
        _m_cache().labels(path="chain",
                          result="miss" if chain is None else "hit").inc()
        if chain is None:
            chain = _Chain(f"program@{id(program):x}/v{program._version}"
                           f"/chain{n}", n, bool(stacked_feed))
            self._pin(key, chain, program, scope)
        step0 = self._step

        def attempt():
            # the sentinel acts on the whole chain: a bad step inside it
            # was masked in its own iteration; a rollback restores the
            # state before the chain and replays it from its first step
            self._step = step0
            first_run = not chain.ran
            t0 = time.perf_counter()
            with profiling.step_phases("chain", chain.label) as ph:
                for i in range(n):
                    with ph.phase("feed_prep"):
                        one = ({k: v[i] for k, v in feeds.items()}
                               if stacked_feed else feeds)
                        sig, _ = self._signature(program, scope, one,
                                                 fetch_names, "chain")
                    chain.plan = sig.plan
                    fetches = self._run_signature(sig, _ScopeBinding, scope,
                                                  [one], fetch_names, ph,
                                                  "chain", None)
                    sig.ran = True
                    if i < n - 1:
                        self._step += 1
                with ph.phase("fetch_sync"):
                    fetches = [f[0] for f in fetches]
                    if sig.graph is not None or return_numpy:
                        fetches = _fetch_copies(fetches, return_numpy)
                    # chain granularity: a NaN born mid-chain stays in
                    # the state the last iteration writes
                    self._check_nan_inf(sig.plan, chain.label, scope,
                                        fetch_names, fetches)
            _record_step("chain", time.perf_counter() - t0, first_run)
            chain.ran = True
            chain.graph = sig.graph
            return fetches

        fetches = run_guarded(sent, scope, fetch_names, attempt,
                              chain=n > 1)
        self._step = step0 + n
        return fetches
