"""LayerHelperBase: program access + variable/parameter creation
(counterpart of ``paddle_tpu/fluid/layer_helper_base.py``)."""

from __future__ import annotations

import copy

from . import framework
from .framework import unique_name
from .initializer import Constant, Xavier
from .param_attr import ParamAttr

__all__ = ["LayerHelperBase"]


class LayerHelperBase:
    def __init__(self, name, layer_type):
        self._layer_type = layer_type
        self._name = name

    @property
    def name(self):
        return self._name

    @property
    def main_program(self):
        return framework.default_main_program()

    @property
    def startup_program(self):
        return framework.default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    def create_parameter(self, attr, shape, dtype="float32", is_bias=False,
                         default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        suffix = "b" if is_bias else "w"
        if attr.name is None:
            # copy before naming: a caller may reuse one ParamAttr
            attr = copy.copy(attr)
            attr.name = unique_name.generate(".".join([self.name, suffix]))
        if default_initializer is None:
            default_initializer = Constant(0.0) if is_bias else Xavier()
        init = (attr.initializer if attr.initializer is not None
                else default_initializer)
        # declare in the main program (read by ops) ...
        p = self.main_program.global_block().create_parameter(
            name=attr.name, shape=shape, dtype=dtype,
            regularizer=attr.regularizer, trainable=attr.trainable,
            stop_gradient=not attr.trainable)
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.gradient_clip_attr = attr.gradient_clip
        # ... and create + initialize it in the startup program
        sb = self.startup_program.global_block()
        sp = sb.create_parameter(name=attr.name, shape=shape, dtype=dtype,
                                 trainable=attr.trainable)
        init(sp, sb)
        return p

    def create_variable_for_type_inference(self, dtype="float32",
                                           stop_gradient=False):
        return self.block.create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype, stop_gradient=stop_gradient)

    def create_variable(self, **kw):
        return self.block.create_var(**kw)

    def create_global_variable(self, persistable=False, **kw):
        return self.main_program.global_block().create_var(
            persistable=persistable, **kw)

    def create_or_get_global_variable(self, name, **kw):
        gb = self.main_program.global_block()
        if name in gb.vars:
            return gb.vars[name]
        return gb.create_var(name=name, **kw)

    def set_variable_initializer(self, var, initializer):
        """Declare ``var`` in the startup program and initialize it
        there; ``var.initializer`` records that the startup program
        writes it (``convert.load_params`` checks such model state)."""
        var.initializer = initializer
        sb = self.startup_program.global_block()
        sv = sb.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                           persistable=True)
        initializer(sv, sb)
