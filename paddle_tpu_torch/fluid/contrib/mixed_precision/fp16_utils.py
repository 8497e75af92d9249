"""The AMP program rewrite (counterpart of
``paddle_tpu/fluid/contrib/mixed_precision/fp16_utils.py``; the
reference's ``rewrite_program``): cast ops inserted so that white-listed
ops run in bf16 or fp16 and black-listed ops in fp32.  Parameters stay
fp32 (master weights): a white op reads ``<name>.cast_<dtype>``, made by
a ``cast`` op placed just before it.
"""

from __future__ import annotations

__all__ = ["rewrite_program", "cast_parameters_to_bf16"]

_FLOAT32 = "float32"
_FLOATS = (_FLOAT32, "float16", "bfloat16")


def _cast_name(name, dtype):
    return f"{name}.cast_{dtype}"


def _insert_cast(block, idx, src_name, dst_dtype):
    """A cast op of ``src_name`` to ``dst_dtype`` at position ``idx``,
    unless its output var exists already; returns (the cast's output
    name, ops inserted)."""
    dst_name = _cast_name(src_name, dst_dtype)
    if block.has_var(dst_name):
        return dst_name, 0
    src = block._find_var_recursive(src_name)
    block.create_var(name=dst_name,
                     shape=src.shape if src is not None else None,
                     dtype=dst_dtype, stop_gradient=True)
    block._insert_op(idx, "cast", inputs={"X": [src_name]},
                     outputs={"Out": [dst_name]},
                     attrs={"in_dtype": src.dtype if src is not None
                            else _FLOAT32,
                            "out_dtype": dst_dtype})
    return dst_name, 1


def rewrite_program(main_program, amp_lists, dest_dtype="bfloat16"):
    """Walk block 0: a white op's fp32 inputs are cast to ``dest_dtype``
    (unless named in ``amp_lists.black_varnames``) and its fp32 outputs
    retyped to it; a black op's low-precision inputs are cast back to
    fp32.  Gray ops are left alone."""
    block = main_program.global_block()
    i = 0
    while i < len(block.ops):
        op = block.ops[i]
        if op.type in amp_lists.white_list:
            target = dest_dtype
        elif op.type in amp_lists.black_list:
            target = _FLOAT32
        else:
            i += 1
            continue
        for slot, names in list(op.inputs.items()):
            new_names = []
            for n in names:
                v = block._find_var_recursive(n)
                # black_varnames vetoes the downcast only, never the
                # cast back to fp32 of a black op's input
                if (v is None or v.dtype not in _FLOATS or v.dtype == target
                        or (target == dest_dtype
                            and (n in amp_lists.black_varnames
                                 or v.dtype != _FLOAT32))):
                    new_names.append(n)
                    continue
                cast_n, inserted = _insert_cast(block, i, n, target)
                i += inserted
                new_names.append(cast_n)
            op.inputs[slot] = new_names
        if target == dest_dtype:
            for names in op.outputs.values():
                for n in names:
                    v = block._find_var_recursive(n)
                    if v is not None and v.dtype == _FLOAT32:
                        v.dtype = dest_dtype
        i += 1
    main_program._bump_version()
    return main_program


def cast_parameters_to_bf16(*a, **kw):
    raise NotImplementedError(
        "pure bf16 parameter casting is not supported: parameters stay "
        "fp32 master weights and the white-listed ops read bf16 casts")
