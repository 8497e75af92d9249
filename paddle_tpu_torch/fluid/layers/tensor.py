"""Tensor-creation layers (counterpart of
``paddle_tpu/fluid/layers/tensor.py``).  Ported so far:
``create_parameter`` (the BERT MLM head's output bias),
``fill_constant``, ``fill_constant_batch_size_like`` and ``assign``
(Transformer NMT: its pad bias and its greedy decode's buffer), and
``tensor_array_to_tensor`` (the machine-translation book's array
decode)."""

from __future__ import annotations

import numpy as np

from ..framework import convert_np_dtype_to_dtype_
from ..initializer import NumpyArrayInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["create_parameter", "fill_constant",
           "fill_constant_batch_size_like", "assign",
           "tensor_array_to_tensor", "sums", "ones_like"]


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter", name=name)
    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    dt = convert_np_dtype_to_dtype_(dtype)
    if out is None:
        out = helper.create_variable_for_type_inference(dt,
                                                        stop_gradient=True)
    helper.append_op("fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dt,
                            "value": float(value)})
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    """``shape`` filled with ``value``, its ``output_dim_idx`` dim taken
    at run time from ``input``'s ``input_dim_idx`` dim."""
    helper = LayerHelper("fill_constant_batch_size_like")
    dt = convert_np_dtype_to_dtype_(dtype)
    out = helper.create_variable_for_type_inference(dt, stop_gradient=True)
    helper.append_op("fill_constant_batch_size_like",
                     inputs={"Input": [input]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dt,
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    return out


def assign(input, output=None):
    """``output`` = ``input``: an ``assign`` op for a Variable, an
    ``assign_value`` op holding the values for a numpy array or a
    list."""
    helper = LayerHelper("assign")
    if isinstance(input, (np.ndarray, list, tuple)):
        arr = np.asarray(input)
        if output is None:
            output = helper.create_variable_for_type_inference(
                str(arr.dtype))
        NumpyArrayInitializer(arr)(output, helper.block)
        return output
    if output is None:
        output = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("assign", inputs={"X": [input]},
                     outputs={"Out": [output]})
    return output


def tensor_array_to_tensor(input, axis=1, name=None, use_stack=False):
    """Every entry of a tensor array (its whole capacity: entries past
    the written count are zero) concatenated along ``axis``, or stacked
    with ``use_stack``; the second return holds each entry's extent
    along ``axis``."""
    helper = LayerHelper("tensor_array_to_tensor", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    out_index = helper.create_variable_for_type_inference(
        "int32", stop_gradient=True)
    helper.append_op("tensor_array_to_tensor", inputs={"X": [input]},
                     outputs={"Out": [out], "OutIndex": [out_index]},
                     attrs={"axis": int(axis), "use_stack": bool(use_stack)})
    return out, out_index


def sums(input, out=None):
    """The sum of the vars of ``input`` (one ``sum`` op), into ``out``
    when given."""
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("sum", inputs={"X": list(input)}, outputs={"Out": [out]})
    return out


def ones_like(x, out=None):
    """Ones of ``x``'s run-time shape and dtype (``fill_any_like``)."""
    helper = LayerHelper("fill_any_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype,
                                                        stop_gradient=True)
    helper.append_op("fill_any_like", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"value": 1.0})
    return out
