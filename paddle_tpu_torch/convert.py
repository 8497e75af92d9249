"""Carrying weights across: numpy arrays keyed by var name into the
port's scope, and checkpoint directories between the two packages.

Parameter names are the same in both packages
(``gpt_word_embedding``, ``decoder_layer_{i}_att_query_fc.w_0``, ...),
so the JAX package's scope, read out as numpy, loads here by name with
no renaming table.  A weight that the ``int8_weight_storage`` pass has
claimed may arrive as its dual-int8 storage triple instead (a scope the
JAX package's ``quantize_scope_weights`` converted).

:func:`load_checkpoint` reads a directory the JAX package's
``fluid.io.save_persistables`` wrote (its JSON layout: a ``.npy`` a var
or one ``.npz``; or Fluid's, ``reference_format=True``: a LoDTensor
stream a var or one combined file) into the port's scope, held to the
program as :func:`load_params` holds it; :func:`save_checkpoint` writes
the port's scope in either layout for the JAX package's
``load_persistables``.

Every persistable carries across by name, optimizer state included
(``GradientMergeOptimizer``'s ``_gm_acc``/``_gm_snap`` and step counter,
``ModelAverage``'s averages, the ``auc`` histograms); with a program
given, an int32 array of a var declared int64 (the JAX package's x64-off
form) loads as int64.
"""

from __future__ import annotations

import numpy as np
import torch

from .fluid.framework import resolve_place
from .fluid.registry import torch_dtype

__all__ = ["load_params", "load_checkpoint", "save_checkpoint"]

# (array dtype, declared dtype) pairs that load as the declared dtype: the
# JAX package runs with x64 off, so its int64 state (the auc op's
# histograms, say) is held and saved as int32
_X64_OFF = {("int32", "int64")}


def load_params(scope, arrays, place, program=None):
    """Put ``arrays`` ({var name: numpy array}) into ``scope`` as tensors
    on ``place``.

    With ``program`` given, every parameter of the program must be in
    ``arrays`` with the parameter's shape and dtype — or, for a weight
    the program stores dual-int8 (passes/int8_weights.py), its storage
    triple: hi and lo int8 of the weight's shape and a [rows, 1] fp32
    scale — and so must every other persistable that the startup
    program writes and a forward op reads: model state such as batch
    norm's moving mean and variance, which would otherwise keep its
    startup value silently (optimizer state, read by the update ops
    only, is not asked for).  A missing or mismatched one raises
    ValueError naming it, and nothing is loaded.  Returns the sorted
    list of names loaded."""
    from .passes.int8_weights import storage_var_names

    device = resolve_place(place).torch_device()
    arrays = {str(k): np.asarray(v) for k, v in arrays.items()}
    if program is not None:
        claimed = {op.output("Out")[0] for op in program.global_block().ops
                   if op.type == "dequantize_weight_storage"}
        problems = []

        def check(name, shape, dtype):
            a = arrays.get(name)
            if a is None:
                problems.append(f"{name}: missing")
            elif tuple(a.shape) != tuple(shape):
                problems.append(f"{name}: shape {tuple(a.shape)} != "
                                f"{tuple(shape)}")
            elif np.dtype(a.dtype).name != dtype \
                    and (np.dtype(a.dtype).name, dtype) not in _X64_OFF:
                problems.append(f"{name}: dtype {a.dtype} != {dtype}")

        for p in program.all_parameters():
            if p.name in claimed and p.name not in arrays:
                hi, lo, sc = storage_var_names(p.name)
                check(hi, p.shape, "int8")
                check(lo, p.shape, "int8")
                check(sc, (p.shape[0], 1), "float32")
            else:
                check(p.name, p.shape, p.dtype)
        for v in _model_state(program):
            check(v.name, v.shape, v.dtype)
        if problems:
            raise ValueError("load_params: parameters and model state do "
                             "not match the program: "
                             + "; ".join(problems))
    declared = ({v.name: v.dtype for v in _persistables(program)}
                if program is not None else {})
    for name, a in arrays.items():
        dtype = np.dtype(a.dtype).name
        if (dtype, declared.get(name)) in _X64_OFF:
            dtype = declared[name]
        # a copy: ops such as adam update the scope's tensors in place
        t = torch.from_numpy(np.ascontiguousarray(a))
        scope.set(name, t.to(device=device, dtype=torch_dtype(dtype),
                             copy=True))
    return sorted(arrays)


def _model_state(program):
    """The persistables besides parameters that the startup program
    initializes (``Variable.initializer``, set by
    ``LayerHelperBase.set_variable_initializer``) and a forward op
    reads."""
    block = program.global_block()
    read = {n for op in block.ops
            if op.attrs.get("op_role", "forward") in ("forward", "loss")
            for n in op.input_arg_names}
    params = {p.name for p in program.all_parameters()}
    return [v for n, v in sorted(block.vars.items())
            if v.persistable and n in read and n not in params
            and v.initializer is not None]


def _persistables(program):
    from .fluid.io import _is_persistable

    return [v for v in program.list_vars() if _is_persistable(v)]


def read_checkpoint(dirname, program, filename=None, reference_format=None):
    """{name: array} of ``program``'s persistables from a checkpoint
    directory.  ``reference_format`` None tells the layout from the
    files: ``.npy`` / ``.npz`` files are the JSON layout, anything else
    Fluid's LoDTensor streams.  A bfloat16 stream record comes back as
    its float32 value (exact), for :func:`load_params`."""
    import os

    from .fluid import io

    wanted = _persistables(program)
    if reference_format is None:
        if filename is not None:
            reference_format = not (filename.endswith(".npz") or
                                    os.path.exists(os.path.join(
                                        dirname, filename + ".npz")))
        else:
            reference_format = not any(
                os.path.exists(os.path.join(
                    dirname, v.name.replace("/", "__") + ".npy"))
                for v in wanted)
    out = {}
    if reference_format:
        def put(name, arr):
            if isinstance(arr, torch.Tensor):
                arr = arr.float().numpy()
            out[name] = arr

        io._read_streams(dirname, filename, wanted, put)
        return out
    if filename is not None:
        path = io._npz_path(dirname, filename)
        with np.load(path, allow_pickle=False) as data:
            for v in wanted:
                if v.name not in data:
                    raise ValueError(f"read_checkpoint: {v.name} not in "
                                     f"{path}")
                out[v.name] = data[v.name]
        return out
    for v in wanted:
        path = os.path.join(dirname, v.name.replace("/", "__") + ".npy")
        if not os.path.exists(path):
            raise ValueError(f"read_checkpoint: {path} not found")
        out[v.name] = np.load(path)
    return out


def load_checkpoint(scope, dirname, program, place, filename=None,
                    reference_format=None):
    """Load a checkpoint directory (:func:`read_checkpoint`) into
    ``scope`` on ``place``, every parameter and model state of
    ``program`` checked as :func:`load_params` checks them.  Returns the
    sorted names loaded."""
    arrays = read_checkpoint(dirname, program, filename, reference_format)
    return load_params(scope, arrays, place, program=program)


def save_checkpoint(scope, dirname, program, filename=None,
                    reference_format=False):
    """Write ``program``'s persistables from ``scope`` to ``dirname`` in
    the JAX package's JSON layout (or Fluid's, ``reference_format``),
    which its ``fluid.io.load_persistables`` reads.  Returns the sorted
    names written."""
    from .fluid import io

    return io.save_vars(None, dirname, program, vars=_persistables(program),
                        filename=filename, scope=scope,
                        reference_format=reference_format)
