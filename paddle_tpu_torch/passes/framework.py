"""Program-pass framework (counterpart of
``paddle_tpu/passes/framework.py``): passes run between program
construction and execution, their order is declared once
(``PASS_ORDER``), and every application records what it changed — the
op-inventory delta, the matched sites, the statically modeled bytes
saved — into ``program._pass_report``.

Passes rewrite the IR only, so the port's copy matches exactly what the
JAX package matches, and ``DEFAULT_PASSES`` is the JAX package's list.

Contracts every ``ProgramPass`` honours, as in the JAX package:
in-place rewrite returning ``{"changed": bool, "sites": int}``;
idempotence (a second apply is a no-op: ``PassManager.run(...,
selfcheck=True)``, or ``PT_PASS_SELFCHECK=1``, applies each pass that
changed the program a second time and raises if it changes it again);
off = identity.

Selection (``FLAGS_graph_passes``): ``"default"``/``"auto"`` = the
DEFAULT_PASSES pipeline; ``"none"``/``""`` = off; otherwise a
comma-separated ordered list of pass names, each optionally prefixed
with ``-`` to drop it from the default set.

Not ported: ``attribute_costs``, the JAX package's per-pass
``cost_analysis`` probe (an XLA compile of each pipeline prefix), and
the ``pt_pass_*`` counters.
"""

from __future__ import annotations

import collections
import os
import warnings

import numpy as np

__all__ = ["ProgramPass", "PassManager", "PassContext",
           "register_program_pass", "get_program_pass",
           "list_program_passes", "resolve_passes", "apply_graph_passes",
           "op_inventory", "DEFAULT_PASSES", "PASS_ORDER"]

# the default pipeline FLAGS_graph_passes="default" expands to
DEFAULT_PASSES = ["fuse_attention", "fuse_bias_act_dropout",
                  "fuse_softmax_cross_entropy"]

# the ordering contract: passes that both appear in a pipeline run in
# this relative order — fusion first (the data-parallel transpile must
# see the final forward graph), the int8 weight rewrite on the muls the
# fusions leave, the health sentinel last
PASS_ORDER = ["fuse_attention", "fuse_bias_act_dropout",
              "fuse_softmax_cross_entropy", "int8_weight_storage",
              "data_parallel_transpile", "health_sentinel"]


class PassContext:
    """What a pass application may know about its caller: the lane
    (``single``/``chain``/``dp``/``serving``), the var names that must
    keep a producer (fetch targets live outside the program) and the
    loss name where the lane knows it."""

    def __init__(self, lane="single", keep_vars=(), loss_name=None,
                 **extra):
        self.lane = lane
        self.keep_vars = frozenset(keep_vars or ())
        self.loss_name = loss_name
        self.extra = dict(extra)


class ProgramPass:
    """Base pass: subclasses set ``name`` and implement
    ``apply(program, ctx) -> report dict``."""

    name = "program_pass"

    def apply(self, program, ctx):
        raise NotImplementedError

    def validate(self, program, ctx):
        """Every op left in the program has a registered lowering."""
        from paddle_tpu_torch.fluid import registry

        for b in program.blocks:
            for op in b.ops:
                if op.type in ("feed", "fetch"):
                    continue
                if not registry.has_op(op.type):
                    raise AssertionError(f"pass {self.name!r} left "
                                         f"unregistered op {op.type!r} in "
                                         f"block {b.idx}")


_PASS_REGISTRY: dict = {}


def register_program_pass(cls):
    _PASS_REGISTRY[cls.name] = cls
    return cls


def list_program_passes():
    return sorted(_PASS_REGISTRY)


def get_program_pass(name):
    if name not in _PASS_REGISTRY:
        raise KeyError(f"unknown program pass {name!r}; registered: "
                       f"{sorted(_PASS_REGISTRY)}")
    return _PASS_REGISTRY[name]()


def resolve_passes(spec=None):
    """Expand a FLAGS_graph_passes selection string into an ordered pass
    name list."""
    if spec is None:
        from paddle_tpu_torch.fluid import flags as _flags

        spec = _flags.flag("graph_passes")
    spec = (spec or "").strip()
    if spec.lower() in ("", "none", "off", "0"):
        return []
    toks = [t.strip() for t in spec.split(",") if t.strip()]
    out, dropped = [], set()
    expand_default = False
    for t in toks:
        if t.lower() in ("default", "auto"):
            expand_default = True
        elif t.startswith("-"):
            dropped.add(t[1:].strip())
            expand_default = True
        else:
            out.append(t)
    if expand_default:
        out = [p for p in DEFAULT_PASSES if p not in dropped] + \
            [p for p in out if p not in DEFAULT_PASSES]
    unknown = sorted(dropped - set(_PASS_REGISTRY)) + \
        [p for p in out if p not in _PASS_REGISTRY]
    if unknown:
        raise KeyError(f"FLAGS_graph_passes names unknown pass(es) "
                       f"{unknown}; registered: {sorted(_PASS_REGISTRY)}")
    _check_order(out)
    return out


def _check_order(names):
    pos = {n: i for i, n in enumerate(PASS_ORDER)}
    ranked = [(n, pos[n]) for n in names if n in pos]
    for (a, ra), (b, rb) in zip(ranked, ranked[1:]):
        if ra > rb:
            raise ValueError(f"pass order violation: {a!r} must run after "
                             f"{b!r} (declared order: {PASS_ORDER})")


# ops whose stream is keyed on their program position: the manager pins
# each one's pre-pass identity before the first pass runs, so a fused
# program draws the streams the unfused one would
RANDOM_OP_TYPES = frozenset({
    "dropout", "uniform_random", "gaussian_random",
    "truncated_gaussian_random", "randint", "sampling_id",
    "uniform_random_batch_size_like", "gaussian_random_batch_size_like",
    "random_crop", "dpsgd", "sampled_softmax_with_cross_entropy",
    "sample_logits", "fused_bias_act_dropout",
})


def pin_random_streams(program):
    blk = program.global_block()
    for i, op in enumerate(blk.ops):
        if op.type in RANDOM_OP_TYPES and "rng_op_index" not in op.attrs:
            op.attrs["rng_op_index"] = (blk.idx << 16) | i


def op_inventory(program):
    inv = collections.Counter()
    for b in program.blocks:
        for op in b.ops:
            inv[op.type] += 1
    return dict(inv)


def _inventory_delta(before, after):
    out = {}
    for t in set(before) | set(after):
        d = after.get(t, 0) - before.get(t, 0)
        if d:
            out[t] = d
    return out


class PassManager:
    """Ordered pass pipeline over a Program: applies and validates each
    pass, records one report entry per application into
    ``program._pass_report``, and with ``selfcheck`` (default: the
    ``PT_PASS_SELFCHECK`` env) enforces idempotence."""

    def __init__(self, names):
        _check_order(list(names))
        self.names = list(names)

    def run(self, program, ctx=None, selfcheck=None):
        ctx = ctx or PassContext()
        if selfcheck is None:
            selfcheck = os.environ.get("PT_PASS_SELFCHECK", "") not in (
                "", "0")
        report = getattr(program, "_pass_report", None)
        if report is None:
            report = program._pass_report = []
        if self.names:
            pin_random_streams(program)
        for name in self.names:
            p = get_program_pass(name)
            before = op_inventory(program)
            entry = p.apply(program, ctx) or {}
            entry.setdefault("changed", False)
            entry.setdefault("sites", 0)
            entry["pass"] = name
            entry["lane"] = ctx.lane
            entry["op_delta"] = _inventory_delta(before,
                                                 op_inventory(program))
            p.validate(program, ctx)
            if selfcheck and entry["changed"]:
                second = p.apply(program, ctx) or {}
                if second.get("changed"):
                    raise AssertionError(
                        f"pass {name!r} violated the idempotence contract: "
                        f"second apply still reports changes ({second})")
            report.append(entry)
        if self.names and any(e["changed"]
                              for e in report[-len(self.names):]):
            program._bump_version()
        return report


def apply_graph_passes(program, lane="single", spec=None, keep_vars=(),
                       loss_name=None):
    """Resolve FLAGS_graph_passes and run the pipeline once per program;
    re-entry is a no-op (a changed selection warns and keeps the first
    rewrite).  Callers run it before any plan or graph of the program
    exists.  Returns the pass report, or None when passes are off."""
    raw = spec
    if raw is None:
        from paddle_tpu_torch.fluid import flags as _flags

        raw = _flags.flag("graph_passes")
    done = getattr(program, "_graph_passes_done", None)
    if done is not None:
        if raw == getattr(program, "_graph_passes_spec", None):
            return getattr(program, "_pass_report", None)
        names = resolve_passes(raw)
        if done != tuple(names):
            warnings.warn(
                "FLAGS_graph_passes changed after this program was already "
                f"rewritten (was {list(done)}, now {names}); keeping the "
                "original rewrite — build a fresh program to change pass "
                "selection")
        else:
            program._graph_passes_spec = raw
        return getattr(program, "_pass_report", None)
    names = resolve_passes(raw)
    program._graph_passes_spec = raw
    if not names:
        program._graph_passes_done = ()
        return None
    ctx = PassContext(lane=lane, keep_vars=keep_vars, loss_name=loss_name)
    report = PassManager(names).run(program, ctx)
    program._graph_passes_done = tuple(names)
    return report


# ---------------------------------------------------------------------------
# shared matcher plumbing for the fusion passes
# ---------------------------------------------------------------------------


def consumer_map(program):
    """var name -> list of ops reading it, across every block."""
    cons = collections.defaultdict(list)
    for b in program.blocks:
        for op in b.ops:
            for n in set(op.input_arg_names):
                cons[n].append(op)
    return cons


def is_backward(op):
    return op.attrs.get("op_role") in ("backward", "optimize")


def single_forward_consumer(cons, name, block=None):
    """The unique non-backward consumer of ``name`` (living in ``block``
    when given), or None."""
    fwd = [op for op in cons.get(name, []) if not is_backward(op)]
    if len(fwd) != 1:
        return None
    if block is not None and fwd[0].block is not block:
        return None
    return fwd[0]


def grad_groups(block):
    """fwd op index -> grad ops differentiating it (``fwd_op_idx``)."""
    groups = collections.defaultdict(list)
    for op in block.ops:
        idx = op.attrs.get("fwd_op_idx")
        if idx is not None and is_backward(op):
            groups[int(idx)].append(op)
    return groups


def static_numel(block, name):
    """Element count when the var's shape is fully static, else None."""
    v = block._find_var_recursive(name)
    if v is None or v.shape is None or any(
            d is None or d < 0 for d in v.shape):
        return None
    return int(np.prod(v.shape, dtype=np.int64)) if v.shape else 1


def rebuild_block(block, remove_ids, inserts):
    """Rebuild ``block.ops`` removing ops whose id() is in ``remove_ids``
    and inserting new ops at anchors (``inserts``: {anchor id:
    (new_ops, redirected old fwd idxs)}); renumbers every ``fwd_op_idx``
    to the new positions, as in the JAX package."""
    new_ops = []
    old_index_of = {id(op): i for i, op in enumerate(block.ops)}
    redirect_target = {}
    for ops_new, redirects in inserts.values():
        for old in redirects:
            redirect_target[old] = id(ops_new[0]) if ops_new else None
    for op in block.ops:
        ins = inserts.get(id(op))
        if ins is not None:
            new_ops.extend(ins[0])
        if id(op) not in remove_ids:
            new_ops.append(op)
    new_index_of = {id(op): i for i, op in enumerate(new_ops)}
    remap = {}
    for oid, old in old_index_of.items():
        if oid in new_index_of:
            remap[old] = new_index_of[oid]
    for old, target in redirect_target.items():
        if target is not None and target in new_index_of:
            remap[old] = new_index_of[target]
    for op in new_ops:
        idx = op.attrs.get("fwd_op_idx")
        if idx is not None and int(idx) in remap:
            op.attrs["fwd_op_idx"] = remap[int(idx)]
    block.ops = new_ops
    block.program._bump_version()
    return remap
