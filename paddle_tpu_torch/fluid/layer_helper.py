"""LayerHelper: per-layer-call sugar (op appending, bias, activation)
over LayerHelperBase (counterpart of
``paddle_tpu/fluid/layer_helper.py``)."""

from __future__ import annotations

from .framework import unique_name
from .layer_helper_base import LayerHelperBase

__all__ = ["LayerHelper"]


class LayerHelper(LayerHelperBase):
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        name = kwargs.get("name")
        if name is None:
            name = unique_name.generate(layer_type)
        super().__init__(name, layer_type)

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        return self.block.append_op(type, inputs=inputs, outputs=outputs,
                                    attrs=attrs)

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = dict(act)
        act_type = act.pop("type")
        out = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(act_type, inputs={"X": [input_var]},
                       outputs={"Out": [out]}, attrs=act)
        return out

    def append_bias_op(self, input_var, dim_start=1):
        bias_attr = self.kwargs.get("bias_attr")
        if bias_attr is False:
            return input_var
        size = self.kwargs.get("size")
        b = self.create_parameter(bias_attr, shape=[size],
                                  dtype=input_var.dtype, is_bias=True)
        if b is None:
            return input_var
        out = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op("elementwise_add", inputs={"X": [input_var], "Y": [b]},
                       outputs={"Out": [out]}, attrs={"axis": dim_start})
        return out
