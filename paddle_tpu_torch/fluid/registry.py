"""Op registry: every op type maps to a lowering, a plain function on
torch tensors (counterpart of ``paddle_tpu/fluid/registry.py``).

The JAX package traces each lowering into one XLA computation per block.
Here the executor calls the lowerings one after another, eagerly, on the
executor's device; the registry itself is the same table of
(input slots, output slots, lowering, in-place map).

Graph-build-time shape inference runs the lowering on ``meta`` tensors —
the counterpart of ``jax.eval_shape`` — so layers that size parameters
from an input's shape (``fc``) see the same shapes they see in the JAX
package.

Grad ops are symbolic program nodes, as in the JAX package.  A
``<type>_grad`` op without a hand-written lowering gets one derived
from the forward lowering by reverse-mode autodiff
(:func:`_register_auto_grad`, the counterpart of the JAX registry's
``jax.vjp`` derivation).  It runs ``torch.autograd.grad`` over a fresh
call of the forward lowering, not ``torch.func.vjp``: under
``torch.func`` a ``torch.autograd.Function``'s backward sees functorch
wrapper tensors, which have no storage for a hand-written kernel to
read (flash attention's backward launches K2/K3 from there).  XLA's CSE
removes the forward that the JAX derivation traces again; eager
autograd runs it again, so the grads of the matrix products are written
by hand (ops/math_ops.py).

A derived grad op, and a hand-written one registered with
``grad="lazy"``, is itself differentiable: its own ``<type>_grad``
(``mul_grad_grad``, ``conv2d_grad_grad``, ...) is registered on first
demand (:func:`_materialize_lazy_grad`), derived from the grad
lowering the same way, so a ``gradients()`` pass over a program that
already carries grad ops (a gradient penalty) gets second-order grads.
Such a lowering must be differentiable by autograd: no ``.detach()``
of its inputs, no in-place writes on them, no host arrays.
"""

from __future__ import annotations

import dataclasses
import typing as _t

import torch

from .framework import GRAD_SUFFIX

__all__ = ["LowerContext", "RandomStreams", "OpInfo", "GroupLowering",
           "register_op", "simple_op", "has_op", "get_op",
           "infer_op_outputs", "wanted_grads", "fold_seed"]

_MASK64 = (1 << 64) - 1


def fold_seed(*parts):
    """One 64-bit seed from integers (splitmix64 over each in turn): the
    port's counterpart of folding values into a ``jax.random`` key."""
    h = 0x9E3779B97F4A7C15
    for x in parts:
        h = (h ^ (int(x) & _MASK64)) & _MASK64
        h = (h + 0x9E3779B97F4A7C15) & _MASK64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
    return h


class RandomStreams:
    """The generators the random ops of one program signature draw from
    on one replica, kept from run to run so a captured CUDA graph can
    draw from them (fluid/executor.py registers each with the graph).

    A stream is the run's (key None: random ops without a ``seed``
    attr, drawing in program order) or one op's (key ``(seed, op
    index)``).  ``reseed(run_seed, step)`` seeds every stream for the
    coming run before it starts, as the JAX package derives a key from
    the step inside its compiled program: the run's stream from
    ``run_seed``, an op's from ``fold_seed(seed, op index, step[,
    replica])``.  So eager runs and graph replays draw the same values
    at the same step, and another executor started from the same state
    draws them again.  A generator is made on first use, seeded at once;
    once ``frozen`` (while a graph is captured, which must know every
    generator beforehand) a first use raises."""

    def __init__(self, device, replica=None):
        self.device = torch.device(device)
        self.replica = replica
        self.frozen = False
        self._gens = {}
        self._run_seed = 0
        self._step = 0

    def _seed_of(self, key):
        if key is None:
            return self._run_seed
        parts = key + (self._step,)
        if self.replica is not None:
            parts += (self.replica,)
        return fold_seed(*parts)

    def reseed(self, run_seed, step):
        """Seed every stream for the run at ``step``."""
        self._run_seed, self._step = int(run_seed), int(step)
        for key, g in self._gens.items():
            g.manual_seed(self._seed_of(key))

    def get(self, key, what):
        """The generator of stream ``key``; ``what`` names the op for
        the error a first use under capture raises."""
        g = self._gens.get(key)
        if g is None:
            if self.frozen:
                raise RuntimeError(
                    f"{what}: random stream {key!r} is first drawn while a "
                    f"CUDA graph is captured; every stream must be drawn "
                    f"in the eager warm-up run first")
            g = torch.Generator(device=self.device)
            g.manual_seed(self._seed_of(key))
            self._gens[key] = g
        return g

    def generators(self):
        return list(self._gens.values())


class LowerContext:
    """Per-run context handed to op lowerings.

    Attributes:
      device: the torch.device the run targets.
      seed: seed of the run's random stream.
      is_test: program-level eval flag.
      step: the executor step (random ops fold it into their streams).
      replica: this replica's index inside a replica group, else None.
      group: the ReplicaGroup a collective lowering reduces over
        (parallel/mesh.py), else None: the single-device meaning.
      streams: the RandomStreams random ops draw from, seeded for this
        run (the executor keeps one a signature and replica; a context
        made without one gets its own).
      cur_op: the op being lowered and op_index its position in the
        block (set by the executor), so a grad lowering can skip the
        products of grads no op asked for and a seeded random op can key
        its own stream.
      program: the program the run belongs to (a control-flow op finds
        its sub-block there), else None.
      bf16: whether the run applies the bf16 dtype policy (set by the
        executor's op loop; the sub-blocks of control-flow ops apply it
        too).
    """

    def __init__(self, device, seed=0, is_test=False, step=0, replica=None,
                 group=None, streams=None, program=None):
        self.device = torch.device(device)
        self.seed = int(seed)
        self.is_test = is_test
        self.step = int(step)
        self.replica = replica
        self.group = group
        if streams is None:
            streams = RandomStreams(self.device, replica)
            streams.reseed(self.seed, self.step)
        self.streams = streams
        self.cur_op = None
        self.op_index = 0
        self.bf16 = False
        self.program = program

    @property
    def generator(self):
        """The run's stream (random ops without a seed attr draw from it
        in program order)."""
        what = self.cur_op.type if self.cur_op is not None else "run"
        return self.streams.get(None, what)


class GroupLowering(_t.NamedTuple):
    """How the executor may run a run of consecutive ops of one type as
    one call (fluid/executor.py ``_Plan``): ``key(op)`` says which ops
    may share a call (equal keys), and ``lower(calls)`` takes every
    member's ``(ctx, inputs, attrs)`` — every op of the run on every
    replica — and returns each member's outputs, in order, as the op's
    own lowering would."""

    key: _t.Callable
    lower: _t.Callable


@dataclasses.dataclass
class OpInfo:
    type: str
    input_slots: list  # trailing '*' marks a variadic (list-valued) slot
    output_slots: list
    lower: _t.Callable  # lower(ctx, *inputs, attrs) -> output or tuple
    optional: frozenset
    # None | "auto" | "custom" | "lazy": whether append_backward
    # differentiates the op (a "custom" op brings its grad_maker; a
    # "lazy" one's grad op is derived on first demand)
    grad: _t.Optional[str] = "auto"
    # slots whose grad never flows (int labels, indices, masks)
    no_grad_inputs: frozenset = frozenset()
    # fn(op, out_grads, wanted, uniq) -> (grad op descs, (var, grad) pairs)
    grad_maker: _t.Optional[_t.Callable] = None
    # outputs that alias an input in place (out_slot -> in_slot): the
    # kv_cache_write ops update the scope's pool tensor, adam the
    # parameter and its moments
    inplace: _t.Optional[dict] = None
    # a collective (ops/collective_ops.py): called once for a whole
    # replica group, each input the list of every replica's value, each
    # output the list of every replica's result (lists of one outside a
    # group)
    collective: bool = False
    # a GroupLowering: runs of these ops may run as one call (the fused
    # optimizer ops: one K8 launch a run)
    group: _t.Optional[GroupLowering] = None

    def is_variadic(self, slot):
        return slot.endswith("*")

    def validate(self, op):
        known = {s.rstrip("*") for s in self.input_slots}
        for slot in op.inputs:
            if slot not in known:
                raise ValueError(f"op {self.type}: unknown input slot "
                                 f"{slot!r} (has {known})")


_OP_REGISTRY: dict[str, OpInfo] = {}


def _materialize_lazy_grad(type_):
    """A lazily differentiable op's grad op (``grad="lazy"``: every
    derived grad op, and the hand-written ones that say so) is
    registered on first demand by deriving it from that op's lowering:
    grads of any order without an endless chain of registrations at
    import (the JAX registry's ``_materialize_lazy_grad``)."""
    if type_.endswith("_grad"):
        base = _OP_REGISTRY.get(type_[:-len("_grad")])
        if base is not None and base.grad == "lazy":
            return _register_auto_grad(base)
    return None


def has_op(type_):
    return type_ in _OP_REGISTRY or _materialize_lazy_grad(type_) is not None


def get_op(type_) -> OpInfo:
    info = _OP_REGISTRY.get(type_)
    if info is None:
        info = _materialize_lazy_grad(type_)
    if info is None:
        raise KeyError(f"op type {type_!r} has no registered lowering; "
                       f"registered: {sorted(_OP_REGISTRY)}")
    return info


def register_op(type, inputs, outputs, lower, grad="auto", optional=(),
                no_grad_inputs=(), grad_maker=None, inplace=None,
                collective=False, group=None):
    """Register an op lowering; ``grad="auto"`` also registers its
    ``<type>_grad`` op, derived by autograd (a hand-written grad op
    registered later under that name replaces it)."""
    info = OpInfo(type=type, input_slots=list(inputs),
                  output_slots=list(outputs), lower=lower, grad=grad,
                  optional=frozenset(optional),
                  no_grad_inputs=frozenset(no_grad_inputs),
                  grad_maker=grad_maker, inplace=inplace,
                  collective=collective, group=group)
    _OP_REGISTRY[type] = info
    if grad == "auto":
        _register_auto_grad(info)
    return info


def simple_op(type, inputs, outputs, **kw):
    """Decorator form of register_op."""

    def deco(fn):
        register_op(type, inputs, outputs, fn, **kw)
        return fn

    return deco


# ---------------------------------------------------------------------------
# Grad ops derived by autograd through the forward lowering.
# ---------------------------------------------------------------------------


def _is_float(t):
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def _grad_slot(slot):
    return slot.rstrip("*") + GRAD_SUFFIX + ("*" if slot.endswith("*")
                                             else "")


def wanted_grads(ctx, gtype, out_slots):
    """The grad output slots the op being lowered names, or all of
    ``out_slots`` when the lowering runs outside an executor."""
    op = getattr(ctx, "cur_op", None)
    if op is None or op.type != gtype:
        return {s.rstrip("*") for s in out_slots}
    return {s for s, names in op.outputs.items() if names}


def _register_auto_grad(fwd: OpInfo):
    """Register ``<type>_grad``, whose lowering runs the forward lowering
    again under autograd and returns ``torch.autograd.grad`` of its
    outputs.

    Signature (the JAX registry's): inputs are every forward input, then
    one ``<OutSlot>@GRAD`` per forward output; outputs are one
    ``<InSlot>@GRAD`` per forward input.  The differentiated inputs are
    the float ones outside ``no_grad_inputs`` whose grad the op names; a
    forward output with no incoming grad adds nothing (a zero
    cotangent), and an integer output (a mask, indices) has none.
    Random ops are never derived this way: they carry ``grad="custom"``
    and a grad maker that replays their saved mask.

    Called with autograd on and inputs that require grad (a derived
    ``<type>_grad_grad`` differentiating this lowering), the inputs are
    used as they are and the grads are taken with ``create_graph``, so
    the result stays differentiable with respect to them; otherwise
    each input is a detached leaf, as before.
    """
    gtype = fwd.type + "_grad"
    in_slots = list(fwd.input_slots) + [_grad_slot(s)
                                        for s in fwd.output_slots]
    out_slots = [_grad_slot(s) for s in fwd.input_slots]
    n_in = len(fwd.input_slots)

    def lower_grad(ctx, *vals, attrs):
        fwd_vals = list(vals[:n_in])
        out_grads = list(vals[n_in:])
        wanted = wanted_grads(ctx, gtype, out_slots)
        # differentiated itself: a derived grad of this grad op calls it
        # with autograd on and inputs that require grad
        outer = torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for v in vals for t in (v if isinstance(v, (list, tuple))
                                    else [v]))

        def leaf(x):
            return x if outer and x.requires_grad \
                else x.detach().requires_grad_()

        full = list(fwd_vals)
        leaves = {}  # input position -> its leaf tensor(s)
        for i, (slot, v) in enumerate(zip(fwd.input_slots, fwd_vals)):
            cslot = slot.rstrip("*")
            if cslot in fwd.no_grad_inputs or v is None \
                    or cslot + GRAD_SUFFIX not in wanted:
                continue
            if fwd.is_variadic(slot):
                if v and all(_is_float(x) for x in v):
                    full[i] = leaves[i] = [leaf(x) for x in v]
            elif _is_float(v):
                full[i] = leaves[i] = leaf(v)
        if not leaves:
            return (None,) * n_in
        flat = [t for i in leaves for t in
                (leaves[i] if isinstance(leaves[i], list) else [leaves[i]])]
        # the forward lowering sees its own op, not the grad op
        prev, ctx.cur_op = getattr(ctx, "cur_op", None), None
        try:
            with torch.enable_grad():
                out = fwd.lower(ctx, *full, attrs=attrs)
                out = out if isinstance(out, tuple) else (out,)
                outs, cots = [], []
                for k, (slot, o) in enumerate(zip(fwd.output_slots, out)):
                    g = out_grads[k]
                    if fwd.is_variadic(slot):
                        pairs = zip(o or [], list(g or []))
                    else:
                        pairs = [(o, g)]
                    for t, gt in pairs:
                        if gt is not None and _is_float(t) \
                                and t.requires_grad:
                            outs.append(t)
                            cots.append(gt.reshape(t.shape).to(t.dtype))
                grads = (torch.autograd.grad(outs, flat, cots,
                                             allow_unused=True,
                                             create_graph=outer)
                         if outs else [None] * len(flat))
        finally:
            ctx.cur_op = prev
        grads = iter(torch.zeros_like(t) if g is None else g
                     for t, g in zip(flat, grads))
        result = [None] * n_in
        for i, leaf in leaves.items():
            result[i] = ([next(grads) for _ in leaf]
                         if isinstance(leaf, list) else next(grads))
        return tuple(result)

    info = OpInfo(type=gtype, input_slots=in_slots, output_slots=out_slots,
                  lower=lower_grad, grad="lazy",
                  optional=frozenset(s.rstrip("*") for s in in_slots))
    _OP_REGISTRY[gtype] = info
    return info


# ---------------------------------------------------------------------------
# Graph-build-time shape inference on meta tensors.  Unknown (-1) dims are
# bound to a sentinel extent and mapped back afterwards, as in the JAX
# package's eval_shape path.
# ---------------------------------------------------------------------------

_DYN_SENTINEL = 191  # prime, unlikely to collide with a real static extent


def torch_dtype(name) -> torch.dtype:
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"unknown dtype {name!r}")
    return dt


# attrs that name an op's place in the program, not its arithmetic
_PLACE_ATTRS = frozenset(("op_role", "fwd_op_idx", "op_namescope",
                          "op_callstack", "rng_op_index"))
_INFER_CACHE: dict = {}
_INFER_CACHE_MAX = 1 << 16


def _attr_key(v):
    """A hashable form of an attr value, or raise TypeError for one that
    has none worth keying on (arrays, tensors, objects)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return tuple(_attr_key(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _attr_key(x)) for k, x in v.items()))
    raise TypeError(type(v).__name__)


def _infer_key(op, info, ins):
    """The key of an op's inferred outputs: its type, its attrs but the
    ones of :data:`_PLACE_ATTRS`, and its inputs' shapes and dtypes.
    None for an op whose lowering may read more (a sub-block, a
    collective) or whose attrs have no hashable form."""
    if info.collective or "sub_block" in op.attrs:
        return None
    try:
        attrs = tuple(sorted((k, _attr_key(v)) for k, v in op.attrs.items()
                             if k not in _PLACE_ATTRS))
    except TypeError:
        return None
    return op.type, attrs, ins


def infer_op_outputs(op, block):
    """Set shape/dtype on op's output Variables by running the lowering on
    meta tensors.  Best-effort: leaves vars untouched on failure.

    The result is kept a key (:func:`_infer_key`): a program that
    unrolls a loop appends the same op on the same shapes many times,
    and the meta run of a lowering costs far more than the lookup."""
    if not has_op(op.type):
        return
    info = get_op(op.type)

    def sig_of(name):
        v = block._find_var_recursive(name)
        if v is None or v.shape is None:
            return None
        return tuple(_DYN_SENTINEL if s == -1 else int(s)
                     for s in v.shape), v.dtype

    sigs = []
    for slot in info.input_slots:
        names = op.inputs.get(slot.rstrip("*"), [])
        if info.is_variadic(slot):
            got = tuple(sig_of(n) for n in names)
            if any(g is None for g in got):
                return
            sigs.append(got)
        elif not names:
            sigs.append(None)
        else:
            g = sig_of(names[0])
            if g is None:
                return
            sigs.append(g)
    key = _infer_key(op, info, tuple(sigs))
    outs = _INFER_CACHE.get(key) if key is not None else None
    if outs is None:
        outs = _infer_outputs(op, info, block, sigs)
        if key is not None:
            if len(_INFER_CACHE) >= _INFER_CACHE_MAX:
                _INFER_CACHE.clear()
            _INFER_CACHE[key] = outs
    for slot, vals in zip(info.output_slots, outs):
        names = op.outputs.get(slot.rstrip("*"), [])
        for n, sd in zip(names, vals):
            v = block._find_var_recursive(n) if sd is not None else None
            if v is None:
                continue
            v.shape, v.dtype = sd


def _infer_outputs(op, info, block, sigs):
    """The lowering on meta tensors of the inputs' shapes and dtypes
    ``sigs``: for each output slot, a (shape, dtype) or None a name (an
    empty tuple for each slot when the lowering raises)."""
    def meta(sd):
        return torch.empty(sd[0], dtype=torch_dtype(sd[1]), device="meta")

    args = [None if g is None else [meta(x) for x in g]
            if info.is_variadic(slot) else meta(g)
            for slot, g in zip(info.input_slots, sigs)]
    ctx = LowerContext(device="meta", program=block.program)
    try:
        if info.collective:
            out = info.lower(ctx, *[[a] for a in args], attrs=op.attrs)
            out = tuple(o[0] if o is not None else None for o in
                        (out if isinstance(out, tuple) else (out,)))
        else:
            out = info.lower(ctx, *args, attrs=op.attrs)
    except Exception:  # best-effort, like the JAX package's eval_shape
        return tuple(() for _ in info.output_slots)
    out = out if isinstance(out, tuple) else (out,)
    result = []
    for slot, val in zip(info.output_slots, out):
        vals = val if info.is_variadic(slot) else [val]
        result.append(tuple(
            (tuple(-1 if d == _DYN_SENTINEL else int(d) for d in t.shape),
             str(t.dtype).replace("torch.", ""))
            if isinstance(t, torch.Tensor) else None for t in vals or []))
    return tuple(result)
