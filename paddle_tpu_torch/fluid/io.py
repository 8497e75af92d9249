"""Model / checkpoint IO: save and load variables, programs and inference
models (counterpart of ``paddle_tpu/fluid/io.py``).

The on-disk layouts are the JAX package's, so a model either package
saved loads in the other.  Two formats:

- JSON (the default): ``__model__`` is the program as JSON (the
  ProgramDesc equivalent, plus ``feed_names`` / ``fetch_names`` for an
  inference model) and the variables are one ``.npy`` per var or one
  combined ``.npz`` (``__params__.npz`` for an inference model);
- Fluid's own (``model_format="protobuf"``, ``reference_format=True``;
  ``fluid/proto_compat.py``): ``__model__`` is a binary ProgramDesc with
  Fluid's feed and fetch ops, and each variable a LoDTensor stream, in a
  file named by the var or all in one file in name order
  (``save_combine``).  ``load_inference_model`` tells the two
  ``__model__`` formats apart by their first byte.

Persistence is a host-side scope operation: values are pulled to the
host, and loaded values are put on the executor's device as tensors.
``load_vars`` with ``in_place=True`` copies each value into the scope's
tensor where one of the same shape, dtype and device is there, so a
captured CUDA graph, which reads the scope's tensors in place, reads
the loaded values on its next replay (``fluid/incubate/checkpoint``'s
resume uses it).
"""

from __future__ import annotations

import collections
import json
import os

import numpy as np
import torch

from . import framework, proto_compat
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
    """A loaded array (numpy, or a CPU tensor: a bfloat16 record of a
    LoDTensor stream) as a tensor on the executor's device (a copy: ops
    such as adam update scope tensors in place)."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device=executor.device, copy=True)
    a = np.ascontiguousarray(arr)
    return torch.from_numpy(a).to(device=executor.device,
                                  dtype=torch_dtype(a.dtype.name),
                                  copy=True)


def _put(scope, name, arr, executor, in_place):
    """Put a loaded value into the scope: copied into the scope's own
    tensor when ``in_place`` and it fits (same shape and dtype), else as
    a new tensor on the executor's device."""
    cur = scope.get(name) if in_place else None
    if isinstance(cur, torch.Tensor):
        src = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(arr))
        if tuple(src.shape) == tuple(cur.shape) and src.dtype == cur.dtype:
            with torch.no_grad():
                cur.copy_(src)
            return
    scope.set(name, _to_device(arr, executor))


def _value(scope, name):
    val = scope.get(name)
    if val is None:
        raise RuntimeError(f"variable {name} has no value in scope; run "
                           f"the startup program before saving")
    return val


def _write_streams(dirname, filename, values):
    """{name: value} as LoDTensor streams: a file a var (nested paths
    for names with '/', as Fluid writes them) or one combined file in
    name order."""
    if filename is None:
        for name, val in values.items():
            path = os.path.join(dirname, name)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as f:
                proto_compat.serialize_lod_tensor(f, val)
    else:
        with open(os.path.join(dirname, filename), "wb") as f:
            for name in sorted(values):
                proto_compat.serialize_lod_tensor(f, values[name])


def _read_streams(dirname, filename, vars, put):
    """Read LoDTensor streams of ``vars`` (``put(name, value)`` each).
    A combined file carries no names: each record's shape must match
    its var's, and the file must end with the last."""
    if filename is not None:
        with open(os.path.join(dirname, filename), "rb") as f:
            for v in sorted(vars, key=lambda v: v.name):
                arr, _lod = proto_compat.deserialize_lod_tensor(f)
                if v.shape is not None and -1 not in v.shape \
                        and tuple(arr.shape) != tuple(v.shape):
                    raise RuntimeError(
                        f"combined file record for {v.name!r} has shape "
                        f"{tuple(arr.shape)}, expected {tuple(v.shape)}: "
                        f"was it saved with another set of vars?")
                put(v.name, arr)
            if f.read(1):
                raise RuntimeError(
                    "combined file has more records than the vars asked "
                    "for: was it saved with another set of vars?")
        return
    for v in vars:
        path = os.path.join(dirname, v.name)
        if not os.path.exists(path):
            raise RuntimeError(f"var file {path} not found")
        with open(path, "rb") as f:
            arr, _lod = proto_compat.deserialize_lod_tensor(f)
        put(v.name, arr)


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None,
              reference_format=False):
    """Save selected vars from the scope: one .npy per var
    (filename=None) or one combined npz; with ``reference_format``,
    Fluid's LoDTensor streams instead (a file a var, named by the var,
    or one combined file in name order), which Fluid loads."""
    scope = scope or global_scope()
    vars = _collect_vars(main_program, vars, predicate)
    os.makedirs(dirname, exist_ok=True)
    if reference_format:
        values = {v.name: _value(scope, v.name) for v in vars}
        _write_streams(dirname, filename, values)
        return sorted(values)
    arrays = {v.name: _to_numpy(_value(scope, v.name)) for v in vars}
    if filename is None:
        for name, arr in arrays.items():
            np.save(os.path.join(dirname, name.replace("/", "__") + ".npy"),
                    arr)
    else:
        np.savez(os.path.join(dirname, filename), **arrays)
    return sorted(arrays)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None,
              reference_format=False, in_place=False):
    """Load selected vars into the scope, on the executor's device
    (``reference_format``: from Fluid's LoDTensor streams).  With
    ``in_place`` a value is copied into the scope's tensor where one of
    its shape and dtype is there (module docstring)."""
    scope = scope or global_scope()
    vars = _collect_vars(main_program, vars, predicate)

    def put(name, arr):
        _put(scope, name, arr, executor, in_place)

    if reference_format:
        _read_streams(dirname, filename, vars, put)
    elif filename is not None:
        path = _npz_path(dirname, filename)
        data = np.load(path, allow_pickle=False)
        for v in vars:
            if v.name not in data:
                raise RuntimeError(f"variable {v.name} not found in {path}")
            put(v.name, data[v.name])
    else:
        for v in vars:
            path = os.path.join(dirname, v.name.replace("/", "__") + ".npy")
            if not os.path.exists(path):
                raise RuntimeError(f"variable file {path} not found")
            put(v.name, np.load(path))
    return sorted(v.name for v in vars)


def save_params(executor, dirname, main_program=None, filename=None,
                scope=None, reference_format=False):
    return save_vars(executor, dirname, main_program,
                     predicate=_is_parameter, filename=filename, scope=scope,
                     reference_format=reference_format)


def load_params(executor, dirname, main_program=None, filename=None,
                scope=None, reference_format=False, in_place=False):
    return load_vars(executor, dirname, main_program,
                     predicate=_is_parameter, filename=filename, scope=scope,
                     reference_format=reference_format, in_place=in_place)


def save_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None, reference_format=False):
    """Save every persistable var (params, optimizer accumulators)."""
    return save_vars(executor, dirname, main_program,
                     predicate=_is_persistable, filename=filename,
                     scope=scope, reference_format=reference_format)


def load_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None, reference_format=False, in_place=False):
    return load_vars(executor, dirname, main_program,
                     predicate=_is_persistable, filename=filename,
                     scope=scope, reference_format=reference_format,
                     in_place=in_place)


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
    """Prune to the inference subgraph and write ``__model__`` and the
    parameters it reads: JSON and ``__params__.npz`` (the default), or
    with ``model_format="protobuf"`` Fluid's layout, a binary
    ProgramDesc with feed and fetch ops and the parameters as LoDTensor
    streams (a file a parameter, or all in ``params_filename``)."""
    if model_format not in ("json", "protobuf"):
        raise ValueError(f"model_format must be 'json' or 'protobuf', got "
                         f"{model_format!r}")
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
    model_path = os.path.join(dirname, model_filename or MODEL_FILENAME)
    if model_format == "protobuf":
        _add_feed_fetch_ops(pruned, feed_names, target_names)
        # vars no op references any more leave the program, as Fluid's
        # prune drops them (a stale learning rate would read as a
        # parameter on the other side)
        for blk in pruned.blocks:
            ref = set()
            for op in blk.ops:
                ref.update(op.input_arg_names)
                ref.update(op.output_arg_names)
            blk.vars = collections.OrderedDict(
                (n, v) for n, v in blk.vars.items() if n in ref)
        with open(model_path, "wb") as f:
            f.write(proto_compat.serialize_program(pruned))
        scope = scope or global_scope()
        _write_streams(dirname, params_filename,
                       {v.name: _value(scope, v.name) for v in params})
        return target_names
    desc = program_to_dict(pruned)
    desc["feed_names"] = feed_names
    desc["fetch_names"] = target_names
    with open(model_path, "w") as f:
        json.dump(desc, f)
    save_vars(executor, dirname, main_program, vars=params,
              filename=params_filename or PARAMS_FILENAME, scope=scope)
    return target_names


def _add_feed_fetch_ops(program, feed_names, fetch_names):
    """Fluid's deployment convention (python/paddle/fluid/io.py:887
    prepend_feed_ops, :908 append_fetch_ops): a ``feed`` op a feed and a
    ``fetch`` op a target, numbered by ``col``, which Fluid's
    load_inference_model reads the feed and fetch names from."""
    from .framework import Operator

    blk = program.global_block()
    feed_var = blk.create_var(name="feed", persistable=True)
    fetch_var = blk.create_var(name="fetch", persistable=True)
    for i, name in enumerate(feed_names):
        blk.ops.insert(i, Operator(blk, "feed", inputs={"X": [feed_var]},
                                   outputs={"Out": [blk.var(name)]},
                                   attrs={"col": i}))
    for i, name in enumerate(fetch_names):
        blk.ops.append(Operator(blk, "fetch", inputs={"X": [blk.var(name)]},
                                outputs={"Out": [fetch_var]},
                                attrs={"col": i}))
    program._bump_version()


def _load_protobuf_inference_model(dirname, data, params_filename, scope,
                                   executor):
    """A model in Fluid's layout: the binary ProgramDesc, the feed and
    fetch names from its feed and fetch ops, and the parameters the
    program reads from LoDTensor streams (a file each, or one combined
    file read in name order as ``load_combine`` reads it)."""
    program = proto_compat.parse_program_bytes(data)
    blk = program.global_block()
    feeds, fetches = [], []
    for op in blk.ops:
        if op.type == "feed":
            feeds.append((op.attrs.get("col", 0), op.output("Out")[0]))
        elif op.type == "fetch":
            fetches.append((op.attrs.get("col", 0), op.input("X")[0]))
    used = set()
    for b in program.blocks:
        for op in b.ops:
            if op.type not in ("feed", "fetch"):
                used.update(op.input_arg_names)
    params = [v for v in program.list_vars()
              if _is_persistable(v) and v.name in used]
    _read_streams(dirname, params_filename, params,
                  lambda n, a: scope.set(n, _to_device(a, executor)))
    return (program, [n for _, n in sorted(feeds)],
            [blk.var(n) for _, n in sorted(fetches)])


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, scope=None):
    """Returns (program, feed_names, fetch_targets); the parameters go
    into the scope as tensors on the executor's device.  ``__model__``
    may be JSON or Fluid's binary ProgramDesc
    (``proto_compat.is_program_proto``); for the latter,
    ``params_filename`` names the combined parameter file, if any."""
    scope = scope or global_scope()
    model_path = os.path.join(dirname, model_filename or MODEL_FILENAME)
    with open(model_path, "rb") as f:
        raw = f.read()
    if proto_compat.is_program_proto(raw):
        return _load_protobuf_inference_model(dirname, raw, params_filename,
                                              scope, executor)
    desc = json.loads(raw.decode("utf-8"))
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
