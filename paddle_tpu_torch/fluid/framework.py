"""Graph-building core: Program / Block / Operator / Variable, the default
programs, unique names and the Places.

Counterpart of ``paddle_tpu/fluid/framework.py``.  The IR is the same
(a program is a list of blocks of op descs), so programs built here and
programs built by the JAX package list the same ops under the same
names.  What differs is where a Place points: here a Place names a
``torch.device``.  ``CUDAPlace`` is the real device and ``TPUPlace`` is
an alias of it, so scripts written for the TPU package run unchanged on
the GPU.
"""

from __future__ import annotations

import collections
import contextlib
import copy

import numpy as np
import torch

__all__ = [
    "Variable", "Parameter", "Operator", "Block", "Program",
    "default_main_program", "default_startup_program", "program_guard",
    "unique_name", "CPUPlace", "CUDAPlace", "TPUPlace", "resolve_place",
    "convert_np_dtype_to_dtype_", "grad_var_name", "GRAD_SUFFIX",
    "is_float_dtype",
]

GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


_DTYPE_ALIASES = {
    "fp16": "float16", "fp32": "float32", "fp64": "float64",
    "bf16": "bfloat16", "float": "float32", "double": "float64",
    "int": "int32", "long": "int64", "bool_": "bool",
}


def convert_np_dtype_to_dtype_(dtype) -> str:
    """Normalize any dtype spelling (str, numpy or torch dtype) to a
    canonical string."""
    if isinstance(dtype, str):
        return _DTYPE_ALIASES.get(dtype, dtype)
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def is_float_dtype(dtype) -> bool:
    return convert_np_dtype_to_dtype_(dtype) in (
        "float16", "bfloat16", "float32", "float64")


# ---------------------------------------------------------------------------
# Places.  A Place selects a torch device.  CUDAPlace is the real device;
# TPUPlace is kept as its alias so TPU-era scripts still run.
# ---------------------------------------------------------------------------


class Place:
    _device_type = "cpu"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.torch_device() == other.torch_device())

    def __hash__(self):
        return hash(str(self.torch_device()))

    def torch_device(self) -> torch.device:
        return torch.device(self._device_type, self.device_id)


class CPUPlace(Place):
    def __init__(self):
        super().__init__(0)

    def __repr__(self):
        return "CPUPlace"

    def torch_device(self):
        return torch.device("cpu")


class CUDAPlace(Place):
    _device_type = "cuda"


TPUPlace = CUDAPlace


def resolve_place(place):
    """The device an entry point runs on: the caller's place, else
    CUDAPlace(0).  Without a GPU the caller must ask for the CPU
    explicitly — nothing falls back to it silently."""
    if place is not None:
        if not isinstance(place, Place):
            raise TypeError(f"expected a Place, got {place!r}")
        if place.torch_device().type == "cuda" \
                and not torch.cuda.is_available():
            raise RuntimeError(
                f"{place!r} requested but torch.cuda.is_available() is "
                f"False; pass CPUPlace() to run on the CPU")
        return place
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available and no place was given: pass "
            "CPUPlace() explicitly to run on the CPU")
    return CUDAPlace(0)


# ---------------------------------------------------------------------------
# unique names
# ---------------------------------------------------------------------------


class _UniqueNameGenerator:
    def __init__(self):
        self.ids = collections.defaultdict(int)
        self.prefix = ""

    def __call__(self, key):
        tmp = self.ids[key]
        self.ids[key] += 1
        return self.prefix + "_".join([key, str(tmp)])


_name_generator = _UniqueNameGenerator()


class unique_name:
    """Namespace mirroring fluid.unique_name."""

    @staticmethod
    def generate(key):
        return _name_generator(key)

    @staticmethod
    @contextlib.contextmanager
    def guard(new_generator=None):
        global _name_generator
        old = _name_generator
        _name_generator = _UniqueNameGenerator()
        if isinstance(new_generator, str):
            _name_generator.prefix = new_generator
        try:
            yield
        finally:
            _name_generator = old


# ---------------------------------------------------------------------------
# Variable / Parameter
# ---------------------------------------------------------------------------


class Variable:
    """A named tensor slot in a Block.  Shape may hold -1 (bound when the
    program runs from the fed arrays)."""

    def __init__(self, block, name=None, shape=None, dtype="float32",
                 lod_level=0, persistable=False, stop_gradient=False,
                 is_data=False, initializer=None, trainable=True, type=None):
        self.block = block
        self.name = name if name is not None else unique_name.generate(
            "_generated_var")
        self.shape = (tuple(int(s) for s in shape)
                      if shape is not None else None)
        self.dtype = convert_np_dtype_to_dtype_(dtype)
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.initializer = initializer
        self.trainable = trainable
        self.type = type  # the saved-model var type field, kept as read
        self.op = None  # op that produced this var last

    def __repr__(self):
        return (f"Variable(name={self.name}, shape={self.shape}, "
                f"dtype={self.dtype}, persistable={self.persistable})")

    # arithmetic sugar: the JAX package's math_op_patch subset (``+``,
    # ``-``, ``*``, ``/``, ``@``, unary ``-`` and ``astype``), built as
    # the JAX package builds them (layers/nn.py _elementwise_binary_var)
    def _binary(self, other, op_type):
        from .layers import nn as _nn  # lazy: layers import framework

        return _nn._elementwise_binary_var(self, other, op_type)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __rsub__(self, other):
        from .layers import nn as _nn

        return _nn._elementwise_binary_var(other, self, "elementwise_sub")

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")

    def __rtruediv__(self, other):
        from .layers import nn as _nn

        return _nn._elementwise_binary_var(other, self, "elementwise_div")

    def __matmul__(self, other):
        from .layers import nn as _nn

        return _nn.matmul(self, other)

    def __neg__(self):
        from .layers import nn as _nn

        return _nn.scale(self, scale=-1.0)

    def astype(self, dtype):
        from .layers import nn as _nn

        return _nn.cast(self, dtype)


class Parameter(Variable):
    """Persistable, trainable variable."""

    def __init__(self, block, *, regularizer=None, **kw):
        kw.setdefault("persistable", True)
        super().__init__(block, **kw)
        self.regularizer = regularizer
        self.optimize_attr = {"learning_rate": 1.0}


# ---------------------------------------------------------------------------
# Operator
# ---------------------------------------------------------------------------


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


class Operator:
    """An op desc: type + named input/output var lists + attrs."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        from . import registry

        self.block = block
        self.type = type
        self.inputs = {}
        self.outputs = {}
        self.attrs = dict(attrs or {})
        for slot, vars_ in (inputs or {}).items():
            self.inputs[slot] = [v.name if isinstance(v, Variable) else v
                                 for v in _as_list(vars_)]
        for slot, vars_ in (outputs or {}).items():
            self.outputs[slot] = [v.name if isinstance(v, Variable) else v
                                  for v in _as_list(vars_)]
        if type is not None and registry.has_op(type):
            registry.get_op(type).validate(self)

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_arg_names(self):
        return [n for ns in self.outputs.values() for n in ns]

    def __repr__(self):
        ins = ", ".join(f"{k}={v}" for k, v in self.inputs.items())
        outs = ", ".join(f"{k}={v}" for k, v in self.outputs.items())
        return f"{{{self.type}: ({ins}) -> ({outs}) attrs={self.attrs}}}"


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------


class Block:
    """A straight-line list of ops + a var symbol table."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: dict[str, Variable] = collections.OrderedDict()
        self.ops: list[Operator] = []

    def var(self, name):
        v = self._find_var_recursive(name)
        if v is None:
            raise ValueError(
                f"Variable {name!r} not found in block {self.idx}")
        return v

    def has_var(self, name):
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name):
        if name in self.vars:
            return self.vars[name]
        if self.parent_idx >= 0:
            return self.program.block(
                self.parent_idx)._find_var_recursive(name)
        return None

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    def create_var(self, **kw):
        name = kw.get("name")
        if name is not None and name in self.vars:
            return self.vars[name]
        v = Variable(self, **kw)
        self.vars[v.name] = v
        return v

    def create_parameter(self, **kw):
        p = Parameter(self, **kw)
        # parameters always live in the global block
        self.program.global_block().vars[p.name] = p
        return p

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        from . import registry

        op = Operator(self, type, inputs=inputs, outputs=outputs,
                      attrs=attrs)
        self.ops.append(op)
        needs_shapes = False
        for names in op.outputs.values():
            for n in names:
                v = self._find_var_recursive(n)
                if v is not None:
                    v.op = op
                    if v.shape is None:
                        needs_shapes = True
        if needs_shapes:
            registry.infer_op_outputs(op, self)
        self.program._bump_version()
        return op

    def _insert_op(self, index, type, inputs=None, outputs=None,
                   attrs=None):
        op = Operator(self, type, inputs=inputs, outputs=outputs,
                      attrs=attrs)
        self.ops.insert(index, op)
        self.program._bump_version()
        return op

    def _remove_op(self, index):
        del self.ops[index]
        self.program._bump_version()

    def __repr__(self):
        lines = [f"Block[{self.idx}] parent={self.parent_idx}"]
        lines += ["  " + repr(v) for v in self.vars.values()]
        lines += ["  " + repr(op) for op in self.ops]
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------


class Program:
    """A list of blocks; block 0 is global.  ``_version`` increments on
    every mutation, so the executor's plan cache never serves a program
    a pass has since rewritten.  ``_dtype_policy`` is None or "bf16"
    (fluid/contrib/mixed_precision/bf16_policy.py)."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self._version = 0
        self.random_seed = 0
        self._is_test = False
        self._dtype_policy = None

    def global_block(self):
        return self.blocks[0]

    def block(self, idx):
        return self.blocks[idx]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def _create_block(self, parent_idx=None):
        """A new block whose parent is ``parent_idx`` (the current block
        by default); it becomes the current block, where layers append
        their ops until :meth:`_rollback`."""
        parent = self.current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self.current_block_idx = b.idx
        return b

    def _rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    def _bump_version(self):
        self._version += 1

    def all_parameters(self):
        return self.global_block().all_parameters()

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def clone(self, for_test=False):
        """A deep copy of the program.  ``for_test=True`` sets every
        ``is_test`` attr and drops the backward and optimizer ops, as
        the JAX package's clone does."""
        p = Program()
        p.random_seed = self.random_seed
        p._is_test = for_test
        p._dtype_policy = self._dtype_policy
        p.blocks = []
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            for name, v in b.vars.items():
                nv = copy.copy(v)
                nv.block = nb
                nb.vars[name] = nv
            for op in b.ops:
                if for_test and op.attrs.get("op_role", "forward") not in (
                        "forward", "loss"):
                    continue
                nop = Operator(nb, None)
                nop.type = op.type
                nop.inputs = {k: list(v) for k, v in op.inputs.items()}
                nop.outputs = {k: list(v) for k, v in op.outputs.items()}
                nop.attrs = copy.deepcopy(op.attrs)
                if for_test and "is_test" in nop.attrs:
                    nop.attrs["is_test"] = True
                nb.ops.append(nop)
            p.blocks.append(nb)
        return p

    def __repr__(self):
        return "\n".join(repr(b) for b in self.blocks)


_main_program_ = Program()
_startup_program_ = Program()


def default_main_program() -> Program:
    return _main_program_


def default_startup_program() -> Program:
    return _startup_program_


def switch_main_program(p):
    global _main_program_
    old, _main_program_ = _main_program_, p
    return old


def switch_startup_program(p):
    global _startup_program_
    old, _startup_program_ = _startup_program_, p
    return old


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    old_main = switch_main_program(main_program)
    old_start = None
    if startup_program is not None:
        old_start = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_start is not None:
            switch_startup_program(old_start)
