"""Op registry: every op type maps to a lowering, a plain function on
torch tensors (counterpart of ``paddle_tpu/fluid/registry.py``).

The JAX package traces each lowering into one XLA computation per block.
Here the executor calls the lowerings one after another, eagerly, on the
executor's device; the registry itself is the same table of
(input slots, output slots, lowering, in-place map).

Graph-build-time shape inference runs the lowering on ``meta`` tensors —
the counterpart of ``jax.eval_shape`` — so layers that size parameters
from an input's shape (``fc``) see the same shapes they see in the JAX
package.  Grad ops (``torch.func.vjp`` of the forward lowering) come
with the training slice.
"""

from __future__ import annotations

import dataclasses
import typing as _t

import torch

__all__ = ["LowerContext", "OpInfo", "register_op", "simple_op", "has_op",
           "get_op", "infer_op_outputs"]


class LowerContext:
    """Per-run context handed to op lowerings.

    Attributes:
      device: the torch.device the run targets.
      seed: seed of the run's random stream.
      is_test: program-level eval flag.
    """

    def __init__(self, device, seed=0, is_test=False):
        self.device = torch.device(device)
        self.seed = int(seed)
        self.is_test = is_test
        self._generator = None

    @property
    def generator(self):
        """The run's torch.Generator on the run's device, made on first
        use (random ops draw from it in program order)."""
        if self._generator is None:
            self._generator = torch.Generator(device=self.device)
            self._generator.manual_seed(self.seed)
        return self._generator


@dataclasses.dataclass
class OpInfo:
    type: str
    input_slots: list  # trailing '*' marks a variadic (list-valued) slot
    output_slots: list
    lower: _t.Callable  # lower(ctx, *inputs, attrs) -> output or tuple
    optional: frozenset
    # outputs that alias an input in place (out_slot -> in_slot): the
    # kv_cache_write ops update the scope's pool tensor itself
    inplace: _t.Optional[dict] = None

    def is_variadic(self, slot):
        return slot.endswith("*")

    def validate(self, op):
        known = {s.rstrip("*") for s in self.input_slots}
        for slot in op.inputs:
            if slot not in known:
                raise ValueError(f"op {self.type}: unknown input slot "
                                 f"{slot!r} (has {known})")


_OP_REGISTRY: dict[str, OpInfo] = {}


def has_op(type_):
    return type_ in _OP_REGISTRY


def get_op(type_) -> OpInfo:
    info = _OP_REGISTRY.get(type_)
    if info is None:
        raise KeyError(f"op type {type_!r} has no registered lowering; "
                       f"registered: {sorted(_OP_REGISTRY)}")
    return info


def register_op(type, inputs, outputs, lower, optional=(), inplace=None):
    info = OpInfo(type=type, input_slots=list(inputs),
                  output_slots=list(outputs), lower=lower,
                  optional=frozenset(optional), inplace=inplace)
    _OP_REGISTRY[type] = info
    return info


def simple_op(type, inputs, outputs, **kw):
    """Decorator form of register_op."""

    def deco(fn):
        register_op(type, inputs, outputs, fn, **kw)
        return fn

    return deco


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


def infer_op_outputs(op, block):
    """Set shape/dtype on op's output Variables by running the lowering on
    meta tensors.  Best-effort: leaves vars untouched on failure."""
    if not has_op(op.type):
        return
    info = get_op(op.type)

    def meta_of(name):
        v = block._find_var_recursive(name)
        if v is None or v.shape is None:
            return None
        shape = tuple(_DYN_SENTINEL if s == -1 else int(s) for s in v.shape)
        return torch.empty(shape, dtype=torch_dtype(v.dtype), device="meta")

    args = []
    for slot in info.input_slots:
        names = op.inputs.get(slot.rstrip("*"), [])
        if info.is_variadic(slot):
            metas = [meta_of(n) for n in names]
            if any(m is None for m in metas):
                return
            args.append(metas)
        elif not names:
            args.append(None)
        else:
            m = meta_of(names[0])
            if m is None:
                return
            args.append(m)
    ctx = LowerContext(device="meta")
    try:
        out = info.lower(ctx, *args, attrs=op.attrs)
    except Exception:  # best-effort, like the JAX package's eval_shape
        return
    out = out if isinstance(out, tuple) else (out,)
    for slot, val in zip(info.output_slots, out):
        names = op.outputs.get(slot.rstrip("*"), [])
        vals = val if info.is_variadic(slot) else [val]
        for n, t in zip(names, vals or []):
            if not isinstance(t, torch.Tensor):
                continue
            v = block._find_var_recursive(n)
            if v is None:
                continue
            v.shape = tuple(-1 if d == _DYN_SENTINEL else int(d)
                            for d in t.shape)
            v.dtype = str(t.dtype).replace("torch.", "")
