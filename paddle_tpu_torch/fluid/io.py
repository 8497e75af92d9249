"""Model / checkpoint IO: save and load variables, programs and inference
models (counterpart of ``paddle_tpu/fluid/io.py``, JSON format only).

The on-disk layout is the JAX package's, so a model either package saved
loads in the other: ``__model__`` is the program as JSON (the
ProgramDesc equivalent, plus ``feed_names`` / ``fetch_names`` for an
inference model) and the variables are one ``.npy`` per var or one
combined ``.npz`` (``__params__.npz`` for an inference model).
Persistence is a host-side scope operation: values are pulled to the
host as numpy, and loaded values are put on the executor's device as
tensors.

Not ported: the reference-protobuf format (``model_format="protobuf"``,
``reference_format=True`` and the loader of a binary ``__model__``,
``paddle_tpu/fluid/proto_compat.py``); asking for it raises
NotImplementedError.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from . import framework
from .executor import global_scope
from .framework import Parameter, Program, Variable
from .registry import torch_dtype

__all__ = [
    "save_vars", "save_params", "save_persistables",
    "load_vars", "load_params", "load_persistables",
    "save_inference_model", "load_inference_model",
    "program_to_dict", "program_from_dict",
    "save_program", "load_program",
]

MODEL_FILENAME = "__model__"
PARAMS_FILENAME = "__params__.npz"
_PROTOBUF = ("the reference-protobuf model format is not ported to "
             "paddle_tpu_torch yet; save with the JSON format")


# ---------------------------------------------------------------------------
# Program (de)serialization
# ---------------------------------------------------------------------------


def _json_attr(v):
    """Op attr values made JSON-safe."""
    if isinstance(v, np.ndarray):
        return {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, (list, tuple)):
        return [_json_attr(x) for x in v]
    return v


def _unjson_attr(v):
    if isinstance(v, dict) and "__ndarray__" in v:
        return np.asarray(v["__ndarray__"], dtype=v["dtype"])
    if isinstance(v, list):
        return [_unjson_attr(x) for x in v]
    return v


def program_to_dict(program: Program) -> dict:
    blocks = []
    for b in program.blocks:
        vars_ = [{
            "name": v.name,
            "shape": list(v.shape) if v.shape is not None else None,
            "dtype": v.dtype,
            "lod_level": v.lod_level,
            "persistable": bool(v.persistable),
            "stop_gradient": bool(v.stop_gradient),
            "is_data": bool(v.is_data),
            "trainable": bool(getattr(v, "trainable", True)),
            "is_parameter": isinstance(v, Parameter),
            "type": v.type,
        } for v in b.vars.values()]
        ops = [{
            "type": op.type,
            "inputs": {k: list(vv) for k, vv in op.inputs.items()},
            "outputs": {k: list(vv) for k, vv in op.outputs.items()},
            "attrs": {k: _json_attr(vv) for k, vv in op.attrs.items()},
        } for op in b.ops]
        blocks.append({"idx": b.idx, "parent_idx": b.parent_idx,
                       "vars": vars_, "ops": ops})
    return {"version": 1, "blocks": blocks,
            "random_seed": program.random_seed,
            "is_test": bool(program._is_test)}


def program_from_dict(d: dict) -> Program:
    from .framework import Block, Operator

    p = Program()
    p.random_seed = d.get("random_seed", 0)
    p._is_test = d.get("is_test", False)
    p.blocks = []
    for bd in d["blocks"]:
        b = Block(p, bd["idx"], bd["parent_idx"])
        for vd in bd["vars"]:
            kw = dict(name=vd["name"], shape=vd["shape"], dtype=vd["dtype"],
                      lod_level=vd.get("lod_level", 0),
                      persistable=vd.get("persistable", False),
                      stop_gradient=vd.get("stop_gradient", False),
                      is_data=vd.get("is_data", False),
                      trainable=vd.get("trainable", True),
                      type=vd.get("type"))
            v = (Parameter(b, **kw) if vd.get("is_parameter")
                 else Variable(b, **kw))
            b.vars[v.name] = v
        for od in bd["ops"]:
            op = Operator(b, None)
            op.type = od["type"]
            op.inputs = {k: list(vv) for k, vv in od["inputs"].items()}
            op.outputs = {k: list(vv) for k, vv in od["outputs"].items()}
            op.attrs = {k: _unjson_attr(vv) for k, vv in od["attrs"].items()}
            b.ops.append(op)
        p.blocks.append(b)
    p.current_block_idx = 0
    p._bump_version()
    return p


def save_program(program: Program, path: str):
    with open(path, "w") as f:
        json.dump(program_to_dict(program), f)


def load_program(path: str) -> Program:
    with open(path) as f:
        return program_from_dict(json.load(f))


# ---------------------------------------------------------------------------
# Variable persistence
# ---------------------------------------------------------------------------


def _is_persistable(var):
    return var.persistable and not var.is_data and var.name not in (
        "feed", "fetch")


def _is_parameter(var):
    return isinstance(var, Parameter)


def _collect_vars(main_program, vars=None, predicate=None):
    main_program = main_program or framework.default_main_program()
    if vars is not None:
        return [v if isinstance(v, Variable)
                else main_program.global_block().var(v) for v in vars]
    pred = predicate or _is_persistable
    return [v for v in main_program.list_vars() if pred(v)]


def _npz_path(dirname, filename):
    """np.savez appends .npz when absent: the file that exists."""
    path = os.path.join(dirname, filename)
    if os.path.exists(path):
        return path
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        return path + ".npz"
    return path


def _to_numpy(val):
    if isinstance(val, torch.Tensor):
        return val.detach().cpu().numpy()
    return np.asarray(val)


def _to_device(arr, executor):
    """A loaded array as a tensor on the executor's device (a copy:
    ops such as adam update scope tensors in place)."""
    a = np.ascontiguousarray(arr)
    return torch.from_numpy(a).to(device=executor.device,
                                  dtype=torch_dtype(a.dtype.name),
                                  copy=True)


def _no_reference_format(reference_format):
    if reference_format:
        raise NotImplementedError(_PROTOBUF)


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None,
              reference_format=False):
    """Save selected vars from the scope: one .npy per var
    (filename=None) or one combined npz."""
    _no_reference_format(reference_format)
    scope = scope or global_scope()
    vars = _collect_vars(main_program, vars, predicate)
    os.makedirs(dirname, exist_ok=True)
    arrays = {}
    for v in vars:
        val = scope.get(v.name)
        if val is None:
            raise RuntimeError(f"variable {v.name} has no value in scope; "
                               f"run the startup program before saving")
        arrays[v.name] = _to_numpy(val)
    if filename is None:
        for name, arr in arrays.items():
            np.save(os.path.join(dirname, name.replace("/", "__") + ".npy"),
                    arr)
    else:
        np.savez(os.path.join(dirname, filename), **arrays)
    return sorted(arrays)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None,
              reference_format=False):
    """Load selected vars into the scope, on the executor's device."""
    _no_reference_format(reference_format)
    scope = scope or global_scope()
    vars = _collect_vars(main_program, vars, predicate)
    if filename is not None:
        path = _npz_path(dirname, filename)
        data = np.load(path, allow_pickle=False)
        for v in vars:
            if v.name not in data:
                raise RuntimeError(f"variable {v.name} not found in {path}")
            scope.set(v.name, _to_device(data[v.name], executor))
    else:
        for v in vars:
            path = os.path.join(dirname, v.name.replace("/", "__") + ".npy")
            if not os.path.exists(path):
                raise RuntimeError(f"variable file {path} not found")
            scope.set(v.name, _to_device(np.load(path), executor))
    return sorted(v.name for v in vars)


def save_params(executor, dirname, main_program=None, filename=None,
                scope=None, reference_format=False):
    return save_vars(executor, dirname, main_program,
                     predicate=_is_parameter, filename=filename, scope=scope,
                     reference_format=reference_format)


def load_params(executor, dirname, main_program=None, filename=None,
                scope=None, reference_format=False):
    return load_vars(executor, dirname, main_program,
                     predicate=_is_parameter, filename=filename, scope=scope,
                     reference_format=reference_format)


def save_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None, reference_format=False):
    """Save every persistable var (params, optimizer accumulators)."""
    return save_vars(executor, dirname, main_program,
                     predicate=_is_persistable, filename=filename,
                     scope=scope, reference_format=reference_format)


def load_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None, reference_format=False):
    return load_vars(executor, dirname, main_program,
                     predicate=_is_persistable, filename=filename,
                     scope=scope, reference_format=reference_format)


# ---------------------------------------------------------------------------
# Inference model
# ---------------------------------------------------------------------------


def _prune_for_inference(program, feed_names, target_names):
    """Clone for test and keep only the ops the targets need."""
    pruned = program.clone(for_test=True)
    block = pruned.global_block()
    needed = set(target_names)
    kept = []
    for op in reversed(block.ops):
        if any(n in needed for n in op.output_arg_names):
            kept.append(op)
            needed.update(op.input_arg_names)
    block.ops = list(reversed(kept))
    pruned._bump_version()
    return pruned


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, scope=None,
                         model_format="json"):
    """Prune to the inference subgraph and write ``__model__`` (JSON)
    and the parameters it reads (``__params__.npz``)."""
    if model_format != "json":
        raise NotImplementedError(_PROTOBUF)
    main_program = main_program or framework.default_main_program()
    feed_names = [v.name if isinstance(v, Variable) else v
                  for v in feeded_var_names]
    target_names = [v.name if isinstance(v, Variable) else v
                    for v in target_vars]
    pruned = _prune_for_inference(main_program, feed_names, target_names)
    os.makedirs(dirname, exist_ok=True)
    used = set()
    for op in pruned.global_block().ops:
        used.update(op.input_arg_names)
    params = [v for v in main_program.list_vars()
              if _is_persistable(v) and v.name in used]
    desc = program_to_dict(pruned)
    desc["feed_names"] = feed_names
    desc["fetch_names"] = target_names
    with open(os.path.join(dirname, model_filename or MODEL_FILENAME),
              "w") as f:
        json.dump(desc, f)
    save_vars(executor, dirname, main_program, vars=params,
              filename=params_filename or PARAMS_FILENAME, scope=scope)
    return target_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, scope=None):
    """Returns (program, feed_names, fetch_targets); the parameters go
    into the scope as tensors on the executor's device."""
    scope = scope or global_scope()
    model_path = os.path.join(dirname, model_filename or MODEL_FILENAME)
    with open(model_path, "rb") as f:
        raw = f.read()
    try:
        desc = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise NotImplementedError(
            f"{model_path} is not a JSON program ({_PROTOBUF})") from e
    program = program_from_dict(desc)
    params_path = _npz_path(dirname, params_filename or PARAMS_FILENAME)
    if not os.path.exists(params_path):
        raise RuntimeError(f"inference model params file {params_path} not "
                           f"found")
    data = np.load(params_path, allow_pickle=False)
    for name in data.files:
        scope.set(name, _to_device(data[name], executor))
    block = program.global_block()
    fetch_targets = [block.var(n) for n in desc.get("fetch_names", [])]
    return program, desc.get("feed_names", []), fetch_targets
