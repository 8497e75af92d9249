"""Fluid's protobuf model format: the binary ``__model__`` and the
LoDTensor parameter streams (counterpart of
``paddle_tpu/fluid/proto_compat.py``, whose wire codec and schema tables
this copies; the port keeps its own copy, built on its own
``framework``).

Fluid serializes a ProgramDesc as proto2
(paddle/fluid/framework/framework.proto:29 OpDesc, :121 VarDesc, :126
BlockDesc, :133 ProgramDesc): ``save_inference_model`` writes the binary
``__model__`` (python/paddle/fluid/io.py:925) and the parameters as
LoDTensor streams (framework/lod_tensor.cc:222 SerializeToStream,
framework/tensor_util.cc:379 TensorToStream).  The port's own program
format is JSON (``fluid/io.py program_to_dict``); this module is for
interop: a model Fluid (or the JAX package) saved in its format loads
here, and one saved here in that format loads there.

A minimal proto2 wire codec driven by schema tables transcribed from
framework.proto (field numbers cited inline): no generated code and no
protobuf runtime.  proto2 wire format:
docs.protobuf.dev/programming-guides/encoding.

What a round trip through this format changes, as in the JAX codec:

- a float attribute is a proto2 ``float``, 32 bits: a Python float (64
  bits) comes back rounded to the nearest float32 (an ``epsilon`` of
  1e-12 as 9.999999960041972e-13, a ``scale`` of 0.1 as
  0.10000000149011612);
- an attribute with no proto type (an ndarray, a dict, None, a mixed
  list) is dropped, as are the program's ``random_seed``, ``_is_test``
  and ``_dtype_policy`` and a var's ``stop_gradient``, ``is_data``,
  ``trainable`` and Parameter class: ProgramDesc has no field for them;
- a var with no dtype is written as a RAW var and read back with the
  framework's default dtype.

dtypes: ``VarType`` enum 22 is bfloat16 (the reference's later proto
revisions; Fluid 1.5 has none), as the JAX codec writes it.  A bfloat16
tensor (the bf16 policy's casts are not persistable; its master weights
are float32) is written as its raw 16-bit words under enum 22, never as
another dtype; numpy has no bfloat16, so such a record reads back as a
CPU ``torch.bfloat16`` tensor, every other record as a numpy array.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

__all__ = [
    "parse_program_bytes", "serialize_program", "is_program_proto",
    "deserialize_lod_tensor", "serialize_lod_tensor", "ProgramParseError",
]


class ProgramParseError(ValueError):
    """A byte stream that is not a well-formed ProgramDesc or LoDTensor
    stream.  The import path is a trust boundary (a model directory from
    elsewhere, reference-signature control flow): every malformation
    surfaces as this error, never as an IndexError or struct.error from
    the decoder, and never as a hang (tests/test_torch_port_proto.py)."""


# ---------------------------------------------------------------------------
# proto2 wire codec (schema-table driven)
# ---------------------------------------------------------------------------

_WT_VARINT, _WT_64BIT, _WT_LEN, _WT_32BIT = 0, 1, 2, 5


def _read_varint(buf, pos):
    result = shift = 0
    try:
        while True:
            b = buf[pos]
            pos += 1
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                # conformant proto2 wraps at 64 bits: a non-canonical
                # 10-byte varint must decode to the masked value, not a
                # silently-wrong 70-bit Python int
                return result & 0xFFFFFFFFFFFFFFFF, pos
            shift += 7
            if shift > 63:  # proto2 varints are <= 10 bytes; bound the
                raise ValueError("varint exceeds 64 bits")  # 0x80-spam loop
    except IndexError:
        raise ValueError(f"truncated varint at byte {pos}") from None


def _write_varint(out, value):
    if value < 0:  # two's complement 64-bit, per proto2 int32/int64
        value += 1 << 64
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _signed(v):
    return v - (1 << 64) if v >= (1 << 63) else v


def _decode(buf, schema):
    """Decode one message per `schema`: {field_no: (name, kind)} where kind
    is 'int' | 'bool' | 'float' | 'str' | 'bytes' | ('msg', sub_schema),
    with a '*' suffix on name marking repeated fields."""
    msg = {}
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        spec = schema.get(field)
        if spec is None:  # unknown field: skip per wire type
            if wt == _WT_VARINT:
                _, pos = _read_varint(buf, pos)
            elif wt == _WT_64BIT:
                pos += 8
            elif wt == _WT_32BIT:
                pos += 4
            elif wt == _WT_LEN:
                n, pos = _read_varint(buf, pos)
                pos += n
            else:
                raise ValueError(f"unsupported wire type {wt}")
            if pos > end:
                raise ValueError(
                    f"skipped field {field} overruns buffer by {pos - end}")
            continue
        name, kind = spec
        repeated = name.endswith("*")
        if repeated:
            name = name[:-1]
        vals = []
        if wt == _WT_LEN:
            n, pos = _read_varint(buf, pos)
            if pos + n > end:  # slicing would silently truncate
                raise ValueError(
                    f"length-delimited field {field} claims {n} bytes, "
                    f"only {end - pos} remain")
            chunk = bytes(buf[pos:pos + n])
            pos += n
            if kind == "str":
                vals.append(chunk.decode("utf-8"))
            elif kind == "bytes":
                vals.append(chunk)
            elif isinstance(kind, tuple):
                vals.append(_decode(chunk, kind[1]))
            elif kind == "float":  # packed
                vals.extend(struct.unpack(f"<{len(chunk) // 4}f", chunk))
            else:  # packed varints
                p = 0
                while p < len(chunk):
                    v, p = _read_varint(chunk, p)
                    vals.append(bool(v) if kind == "bool" else _signed(v))
        elif wt == _WT_VARINT:
            v, pos = _read_varint(buf, pos)
            vals.append(bool(v) if kind == "bool" else _signed(v))
        elif wt == _WT_32BIT:
            if pos + 4 > end:
                raise ValueError(f"truncated fixed32 field {field}")
            (v,) = struct.unpack_from("<f", buf, pos)
            pos += 4
            vals.append(v)
        elif wt == _WT_64BIT:
            if pos + 8 > end:
                raise ValueError(f"truncated fixed64 field {field}")
            (v,) = struct.unpack_from("<d", buf, pos)
            pos += 8
            vals.append(v)
        else:
            raise ValueError(f"unsupported wire type {wt}")
        if repeated:
            msg.setdefault(name, []).extend(vals)
        else:
            msg[name] = vals[-1]
    return msg


def _encode(msg, schema):
    """Inverse of _decode (unpacked repeated scalars, like the reference's
    proto2 LITE_RUNTIME output)."""
    out = bytearray()
    for field, (name, kind) in schema.items():
        repeated = name.endswith("*")
        key = name[:-1] if repeated else name
        if key not in msg:
            continue
        vals = msg[key] if repeated else [msg[key]]
        for v in vals:
            if kind in ("str", "bytes"):
                data = v.encode("utf-8") if kind == "str" else v
                _write_varint(out, (field << 3) | _WT_LEN)
                _write_varint(out, len(data))
                out.extend(data)
            elif isinstance(kind, tuple):
                data = _encode(v, kind[1])
                _write_varint(out, (field << 3) | _WT_LEN)
                _write_varint(out, len(data))
                out.extend(data)
            elif kind == "float":
                _write_varint(out, (field << 3) | _WT_32BIT)
                out.extend(struct.pack("<f", float(v)))
            else:  # int / bool varint
                _write_varint(out, (field << 3) | _WT_VARINT)
                _write_varint(out, int(v))
    return bytes(out)


# ---------------------------------------------------------------------------
# framework.proto schemas (field numbers cited from the reference file)
# ---------------------------------------------------------------------------

# OpDesc.Attr (framework.proto:30-45)
_ATTR = {
    1: ("name", "str"), 2: ("type", "int"), 3: ("i", "int"),
    4: ("f", "float"), 5: ("s", "str"), 6: ("ints*", "int"),
    7: ("floats*", "float"), 8: ("strings*", "str"), 10: ("b", "bool"),
    11: ("bools*", "bool"), 12: ("block_idx", "int"), 13: ("l", "int"),
    14: ("blocks_idx*", "int"), 15: ("longs*", "int"),
}
# OpDesc.Var (framework.proto:46-49)
_OPVAR = {1: ("parameter", "str"), 2: ("arguments*", "str")}
# OpDesc (framework.proto:29-55)
_OPDESC = {
    1: ("inputs*", ("msg", _OPVAR)), 2: ("outputs*", ("msg", _OPVAR)),
    3: ("type", "str"), 4: ("attrs*", ("msg", _ATTR)),
    5: ("is_target", "bool"),
}
# VarType.TensorDesc (framework.proto:101-104)
_TENSORDESC = {1: ("data_type", "int"), 2: ("dims*", "int")}
# VarType.LoDTensorDesc (framework.proto:106-109)
_LODDESC = {1: ("tensor", ("msg", _TENSORDESC)), 2: ("lod_level", "int")}
_READERDESC = {1: ("lod_tensor*", ("msg", _LODDESC))}
# VarType (framework.proto:76-120)
_VARTYPE = {
    1: ("type", "int"), 2: ("selected_rows", ("msg", _TENSORDESC)),
    3: ("lod_tensor", ("msg", _LODDESC)),
    4: ("tensor_array", ("msg", _LODDESC)),
    5: ("reader", ("msg", _READERDESC)),
}
# VarDesc (framework.proto:121-125)
_VARDESC = {1: ("name", "str"), 2: ("type", ("msg", _VARTYPE)),
            3: ("persistable", "bool")}
# BlockDesc (framework.proto:126-132)
_BLOCKDESC = {
    1: ("idx", "int"), 2: ("parent_idx", "int"),
    3: ("vars*", ("msg", _VARDESC)), 4: ("ops*", ("msg", _OPDESC)),
    5: ("forward_block_idx", "int"),
}
_VERSION = {1: ("version", "int")}
# ProgramDesc (framework.proto:133-136)
_PROGRAMDESC = {1: ("blocks*", ("msg", _BLOCKDESC)),
                2: ("version", ("msg", _VERSION))}

# AttrType enum (framework.proto:15-28)
(_AT_INT, _AT_FLOAT, _AT_STRING, _AT_INTS, _AT_FLOATS, _AT_STRINGS,
 _AT_BOOLEAN, _AT_BOOLEANS, _AT_BLOCK, _AT_LONG, _AT_BLOCKS,
 _AT_LONGS) = range(12)

# VarType.Type enum (framework.proto:77-99) — numeric dtypes only.  This is
# THE table; ops/common.np_dtype resolves enum-valued attrs through it (22 =
# BF16 in the reference's later proto revisions).
_DTYPE_BY_ENUM = {
    0: "bool", 1: "int16", 2: "int32", 3: "int64", 4: "float16",
    5: "float32", 6: "float64", 19: "uint64", 20: "uint8", 21: "int8",
    22: "bfloat16",
}
_ENUM_BY_DTYPE = {v: k for k, v in _DTYPE_BY_ENUM.items()}
_LOD_TENSOR, _SELECTED_ROWS, _FEED_MINIBATCH, _FETCH_LIST = 7, 8, 9, 10
_STEP_SCOPES, _LOD_TENSOR_ARRAY, _RAW = 11, 13, 17


# ---------------------------------------------------------------------------
# ProgramDesc <-> Program
# ---------------------------------------------------------------------------


def is_program_proto(data: bytes) -> bool:
    """A serialized ProgramDesc starts with its field-1 length-delimited
    tag, 0x0A; our native JSON starts with '{' (json.dump writes no
    leading whitespace).  0x0A is ALSO '\\n', so lstrip-then-check would
    misread a proto whose next byte happens to be 0x7B ('{') as JSON —
    the first byte must be inspected raw."""
    if data[:1] == b"\x0a":
        return True
    return False


def _attr_from_desc(a):
    t = a.get("type", _AT_INT)
    if t == _AT_INT:
        return int(a.get("i", 0))
    if t == _AT_FLOAT:
        return float(a.get("f", 0.0))
    if t == _AT_STRING:
        return a.get("s", "")
    if t == _AT_INTS:
        return [int(v) for v in a.get("ints", [])]
    if t == _AT_FLOATS:
        return [float(v) for v in a.get("floats", [])]
    if t == _AT_STRINGS:
        return list(a.get("strings", []))
    if t == _AT_BOOLEAN:
        return bool(a.get("b", False))
    if t == _AT_BOOLEANS:
        return [bool(v) for v in a.get("bools", [])]
    if t == _AT_BLOCK:
        return ("__block__", int(a.get("block_idx", 0)))
    if t == _AT_BLOCKS:
        return ("__blocks__", [int(v) for v in a.get("blocks_idx", [])])
    if t == _AT_LONG:
        return int(a.get("l", 0))
    if t == _AT_LONGS:
        return [int(v) for v in a.get("longs", [])]
    raise ValueError(f"unknown AttrType {t}")


def parse_program_bytes(data: bytes):
    """Binary ProgramDesc → the port's Program (reference __model__
    reader).  BLOCK/BLOCKS attrs become plain block INDICES — this
    framework's control-flow lowerings address sub-blocks by index
    (program.block(attrs["sub_block"])).  Malformed input raises
    ProgramParseError — the importer is a trust boundary and must fail
    by name, not leak decoder internals."""
    try:
        return _parse_program_impl(data)
    except ProgramParseError:
        raise
    except (ValueError, KeyError, TypeError, IndexError, struct.error,
            UnicodeDecodeError, OverflowError, RecursionError) as e:
        raise ProgramParseError(
            f"malformed ProgramDesc ({type(e).__name__}): {e}") from e


def _parse_program_impl(data: bytes):
    from .framework import Program

    desc = _decode(data, _PROGRAMDESC)
    prog = Program()
    blocks_desc = desc.get("blocks", [])
    n_blocks = max(len(blocks_desc), 1)

    def block_idx(v, what):
        """Negative or out-of-range indices must fail BY NAME — Python's
        negative indexing would otherwise silently address the wrong
        block (trust-boundary contract, tests/test_proto_fuzz.py)."""
        v = int(v)
        if not 0 <= v < n_blocks:
            raise ValueError(f"{what} {v} out of range [0, {n_blocks})")
        return v

    # materialize blocks first so sub-block attrs can link
    for bd in blocks_desc[1:]:
        prog._create_block(
            parent_idx=block_idx(bd.get("parent_idx", 0), "parent_idx"))
    prog.current_block_idx = 0
    for bd in blocks_desc:
        blk = prog.blocks[block_idx(bd.get("idx", 0), "block idx")]
        for vd in bd.get("vars", []):
            vt = vd.get("type", {})
            t = vt.get("type")
            shape = dtype = None
            lod_level = 0
            persistable = bool(vd.get("persistable", False))
            if t == _LOD_TENSOR and "lod_tensor" in vt:
                td = vt["lod_tensor"].get("tensor", {})
                shape = [int(d) for d in td.get("dims", [])]
                dtype = _DTYPE_BY_ENUM.get(td.get("data_type"))
                lod_level = int(vt["lod_tensor"].get("lod_level", 0))
            elif t == _SELECTED_ROWS and "selected_rows" in vt:
                td = vt["selected_rows"]
                shape = [int(d) for d in td.get("dims", [])]
                dtype = _DTYPE_BY_ENUM.get(td.get("data_type"))
            blk.create_var(name=vd["name"], shape=shape, dtype=dtype,
                           persistable=persistable, lod_level=lod_level)
        for od in bd.get("ops", []):
            ins = {v["parameter"]: list(v.get("arguments", []))
                   for v in od.get("inputs", [])}
            outs = {v["parameter"]: list(v.get("arguments", []))
                    for v in od.get("outputs", [])}
            attrs = {}
            for a in od.get("attrs", []):
                v = _attr_from_desc(a)
                # this framework's control-flow lowerings address
                # sub-blocks by INDEX (program.block(attrs["sub_block"]))
                if isinstance(v, tuple) and v[0] == "__block__":
                    v = block_idx(v[1], f"attr {a['name']!r} block ref")
                elif isinstance(v, tuple) and v[0] == "__blocks__":
                    v = [block_idx(b, f"attr {a['name']!r} block ref")
                         for b in v[1]]
                attrs[a["name"]] = v
            _append_op_raw(blk, od.get("type"), ins, outs, attrs)
    _normalize_reference_control_flow(prog)
    prog._bump_version()
    return prog


def _normalize_reference_control_flow(prog):
    """Rewrite reference-signature control-flow ops onto this framework's
    explicit-dataflow slots.

    The reference's while (controlflow/while_op.cc: X/Condition →
    Out/StepScopes) and conditional_block (Input/Cond → Out/Scope) let the
    sub-block read and write enclosing scope vars implicitly; the
    functional XLA lowerings need every capture declared
    (Carry/Extra/ExtraNG + name attrs).  The same capture analysis the
    Python layer runs at build time (_analyze_sub_block) reconstructs
    them from the imported sub-block."""
    from .layers.control_flow import _analyze_sub_block

    for blk in prog.blocks:
        for op in blk.ops:
            if op.attrs.get("carry_names") is not None:
                continue  # already our signature
            if op.type == "while":
                sub = prog.block(op.attrs["sub_block"])
                carries, extras, extras_ng = _analyze_sub_block(sub)
                cond = op.inputs.get("Condition", [None])[0]
                if cond not in carries:
                    # same guard While.block() enforces at build time: a
                    # body that never re-evaluates Condition would compile
                    # into an infinite lax.while with no diagnostic
                    raise ValueError(
                        f"imported while op: condition var {cond!r} is "
                        "never written in the sub-block (infinite loop)")
                op.inputs = {"Condition": [cond], "Carry": list(carries),
                             "Extra": extras, "ExtraNG": extras_ng}
                op.outputs = {"Out": list(carries)}
                op.attrs.update(carry_names=list(carries),
                                extra_names=extras,
                                extra_ng_names=extras_ng, cond_name=cond)
            elif op.type in ("conditional_block",
                             "conditional_block_infer"):
                sub = prog.block(op.attrs["sub_block"])
                cond_list = op.inputs.get("Cond", [])
                carries, extras, extras_ng = _analyze_sub_block(
                    sub, extra_exclude=set(cond_list))
                op.inputs = {"Cond": list(cond_list),
                             "Carry": list(carries), "Extra": extras,
                             "ExtraNG": extras_ng}
                op.outputs = {"Out": list(carries)}
                op.attrs.update(carry_names=list(carries),
                                extra_names=extras,
                                extra_ng_names=extras_ng)


def _append_op_raw(blk, type_, ins, outs, attrs):
    """Append an op by NAME references (vars may legitimately be declared
    in a parent block)."""
    from .framework import Operator

    # reference write_to_array lists the array only as Out (the C++
    # executor mutates it in scope); the functional lowering consumes the
    # previous buffer explicitly, so surface it as the Array input
    if type_ == "write_to_array" and "Array" not in ins:
        ins = dict(ins, Array=list(outs.get("Out", [])))

    def to_vars(d):
        return {slot: [blk._find_var_recursive(n) or _ghost(blk, n)
                       for n in names]
                for slot, names in d.items()}

    skip = (type_ in ("while", "conditional_block",
                      "conditional_block_infer")
            and attrs.get("carry_names") is None)
    if skip:
        # the reference signature: validated once normalized
        op = Operator(blk, None, attrs=attrs)
        op.type = type_
        for slot, vs in to_vars(ins).items():
            op.inputs[slot] = [v.name for v in vs]
        for slot, vs in to_vars(outs).items():
            op.outputs[slot] = [v.name for v in vs]
    else:
        op = Operator(blk, type_, inputs=to_vars(ins),
                      outputs=to_vars(outs), attrs=attrs)
    blk.ops.append(op)
    return op


def _ghost(blk, name):
    # feed/fetch targets etc. may be absent from vars lists in some
    # reference exports; declare a typeless var so name plumbing works
    return blk.create_var(name=name, shape=None, dtype=None)


# attr names that are block references in the reference schema: this
# framework stores them as plain ints, but actual Fluid's reader requires
# AttrType.BLOCK/BLOCKS for them
_BLOCK_ATTRS = frozenset({"sub_block", "block", "forward_block"})
_BLOCKS_ATTRS = frozenset({"blocks", "sub_blocks"})


def _attr_to_desc(name, v):
    a = {"name": name}
    from .framework import Block

    if isinstance(v, bool):
        a["type"], a["b"] = _AT_BOOLEAN, v
    elif isinstance(v, int):
        if name in _BLOCK_ATTRS:
            a["type"], a["block_idx"] = _AT_BLOCK, v
        elif -(1 << 31) <= v < (1 << 31):
            a["type"], a["i"] = _AT_INT, v
        else:
            a["type"], a["l"] = _AT_LONG, v
    elif isinstance(v, float):
        a["type"], a["f"] = _AT_FLOAT, v
    elif isinstance(v, str):
        a["type"], a["s"] = _AT_STRING, v
    elif isinstance(v, Block):
        a["type"], a["block_idx"] = _AT_BLOCK, v.idx
    elif isinstance(v, (list, tuple)):
        if v and all(isinstance(x, Block) for x in v):
            a["type"] = _AT_BLOCKS
            a["blocks_idx"] = [x.idx for x in v]
        elif (name in _BLOCKS_ATTRS and v
              and all(isinstance(x, int) for x in v)):
            a["type"], a["blocks_idx"] = _AT_BLOCKS, list(v)
        elif all(isinstance(x, bool) for x in v) and v:
            a["type"], a["bools"] = _AT_BOOLEANS, list(v)
        elif all(isinstance(x, int) for x in v):
            big = any(not -(1 << 31) <= x < (1 << 31) for x in v)
            if big:
                a["type"], a["longs"] = _AT_LONGS, list(v)
            else:
                a["type"], a["ints"] = _AT_INTS, list(v)
        elif all(isinstance(x, float) for x in v):
            a["type"], a["floats"] = _AT_FLOATS, list(v)
        elif all(isinstance(x, str) for x in v):
            a["type"], a["strings"] = _AT_STRINGS, list(v)
        else:
            return None  # unrepresentable (host-op python payloads)
    else:
        return None
    return a


def serialize_program(program) -> bytes:
    """The port's Program → binary ProgramDesc loadable by Fluid.
    Attrs with no proto representation (python payloads of host ops) are
    dropped — those ops are not portable to the reference anyway."""
    blocks = []
    for blk in program.blocks:
        vars_ = []
        for v in blk.vars.values():
            vt = {"type": _LOD_TENSOR}
            if v.dtype is not None and str(v.dtype) in _ENUM_BY_DTYPE:
                dims = [int(d) if d is not None else -1
                        for d in (v.shape or [])]
                vt["lod_tensor"] = {
                    "tensor": {"data_type": _ENUM_BY_DTYPE[str(v.dtype)],
                               "dims": dims},
                    "lod_level": int(getattr(v, "lod_level", 0) or 0)}
            else:
                vt = {"type": _RAW}
            vars_.append({"name": v.name, "type": vt,
                          "persistable": bool(v.persistable)})
        ops = []
        for op in blk.ops:
            od = {
                "type": op.type,
                "inputs": [{"parameter": s, "arguments": list(ns)}
                           for s, ns in op.inputs.items()],
                "outputs": [{"parameter": s, "arguments": list(ns)}
                            for s, ns in op.outputs.items()],
            }
            attrs = []
            for k, v in op.attrs.items():
                a = _attr_to_desc(k, v)
                if a is not None:
                    attrs.append(a)
            od["attrs"] = attrs
            ops.append(od)
        blocks.append({"idx": blk.idx, "parent_idx": blk.parent_idx,
                       "vars": vars_, "ops": ops})
    return _encode({"blocks": blocks, "version": {"version": 0}},
                   _PROGRAMDESC)


# ---------------------------------------------------------------------------
# LoDTensor stream format (lod_tensor.cc:222 / tensor_util.cc:379)
# ---------------------------------------------------------------------------


def deserialize_lod_tensor(stream):
    """Read one LoDTensor: u32 version | u64 lod_level {u64 nbytes, data}*
    | u32 tensor version | i32 desc_size | TensorDesc proto | raw data.
    Returns (np array, lod: list of lists).  Parameter files come from
    the same untrusted model directory as __model__, so malformation
    raises ProgramParseError under the same contract."""
    try:
        return _deserialize_lod_tensor_impl(stream)
    except ProgramParseError:
        raise
    except (ValueError, KeyError, TypeError, struct.error,
            OverflowError, MemoryError) as e:
        raise ProgramParseError(
            f"malformed LoDTensor stream ({type(e).__name__}): {e}") from e


def _read_exact(stream, n, what):
    data = stream.read(n)
    if len(data) != n:
        raise ValueError(f"truncated {what}: wanted {n} bytes, "
                         f"got {len(data)}")
    return data


def _deserialize_lod_tensor_impl(stream):
    (version,) = struct.unpack("<I", _read_exact(stream, 4, "version"))
    if version != 0:
        raise ValueError(f"unsupported LoDTensor version {version}")
    (lod_level,) = struct.unpack("<Q", _read_exact(stream, 8, "lod level"))
    if lod_level > 64:  # reference caps nesting far below this
        raise ValueError(f"implausible lod_level {lod_level}")
    lod = []
    for _ in range(lod_level):
        (nbytes,) = struct.unpack("<Q", _read_exact(stream, 8, "lod size"))
        lod.append(list(np.frombuffer(
            _read_exact(stream, nbytes, "lod data"), np.uint64)
            .astype(np.int64)))
    (tversion,) = struct.unpack("<I", _read_exact(stream, 4,
                                                  "tensor version"))
    if tversion != 0:
        raise ValueError(f"unsupported Tensor version {tversion}")
    (desc_size,) = struct.unpack("<i", _read_exact(stream, 4, "desc size"))
    if desc_size < 0:
        raise ValueError(f"negative TensorDesc size {desc_size}")
    desc = _decode(_read_exact(stream, desc_size, "TensorDesc"),
                   _TENSORDESC)
    enum = desc.get("data_type", 5)
    dtype = _DTYPE_BY_ENUM.get(enum)
    if dtype is None:
        raise ValueError(f"unknown tensor data_type enum {enum}")
    dims = [int(d) for d in desc.get("dims", [])]
    if any(d < 0 for d in dims):
        raise ValueError(f"negative tensor dim in {dims}")
    count = int(np.prod(dims)) if dims else 1
    if dtype == "bfloat16":  # raw 16-bit words; numpy has no bfloat16
        data = _read_exact(stream, count * 2, "tensor data")
        words = np.frombuffer(data, np.int16).reshape(dims).copy()
        return torch.from_numpy(words).view(torch.bfloat16), lod
    data = _read_exact(stream, count * np.dtype(dtype).itemsize,
                       "tensor data")
    arr = np.frombuffer(data, dtype).reshape(dims).copy()
    return arr, lod


def serialize_lod_tensor(stream, arr, lod=()):
    """Inverse of deserialize_lod_tensor: parameters saved here load in
    Fluid.  ``arr`` is a numpy array or a tensor (on any device; a
    bfloat16 one is written as its raw words under enum 22)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            _write_tensor(stream, t.view(torch.int16).numpy(), "bfloat16",
                          lod)
            return
        arr = t.numpy()
    arr = np.ascontiguousarray(arr)
    _write_tensor(stream, arr, str(arr.dtype), lod)


def _write_tensor(stream, arr, dtype, lod):
    stream.write(struct.pack("<I", 0))
    stream.write(struct.pack("<Q", len(lod)))
    for level in lod:
        level = np.asarray(level, np.uint64)
        stream.write(struct.pack("<Q", level.nbytes))
        stream.write(level.tobytes())
    stream.write(struct.pack("<I", 0))
    desc = _encode({"data_type": _ENUM_BY_DTYPE[dtype],
                    "dims": list(arr.shape)}, _TENSORDESC)
    stream.write(struct.pack("<i", len(desc)))
    stream.write(desc)
    stream.write(arr.tobytes())
