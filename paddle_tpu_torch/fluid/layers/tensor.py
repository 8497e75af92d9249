"""Tensor-creation layers (counterpart of
``paddle_tpu/fluid/layers/tensor.py``).  Ported so far:
``create_parameter``, which the BERT MLM head's output bias uses."""

from __future__ import annotations

from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["create_parameter"]


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter", name=name)
    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)
