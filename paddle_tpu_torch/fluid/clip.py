"""Gradient clipping (counterpart of ``paddle_tpu/fluid/clip.py``).

Each clip appends ops between the backward (and the regularizers) and
the update, all with ``op_role="backward"``:

- ``GradientClipByValue``: ``clip`` of each gradient to [min, max];
- ``GradientClipByNorm``: ``clip_by_norm`` of each gradient;
- ``GradientClipByGlobalNorm``: ``squared_l2_norm`` of each gradient,
  their ``sum`` and its ``sqrt`` (the global norm), ``clip`` of that
  from below at clip_norm, and each gradient times clip_norm over it
  (a ``fill_constant``, an ``elementwise_div`` and an
  ``elementwise_mul`` a gradient).  No op reads a value on the host,
  so a step with clipping is captured whole.

A clip is the optimizer's ``grad_clip``, or a parameter's own
(``ParamAttr(gradient_clip=...)``), or the one ``set_gradient_clip``
sets for every parameter (``append_gradient_clip_ops``).
``ErrorClipByValue`` is accepted and clips nothing, as in the JAX
package.
"""

from __future__ import annotations

from .framework import default_main_program, unique_name

__all__ = [
    "ErrorClipByValue", "GradientClipByValue", "GradientClipByNorm",
    "GradientClipByGlobalNorm", "set_gradient_clip",
    "append_gradient_clip_ops",
]


class BaseGradientClipAttr:
    def _process(self, block, param, grad):
        return grad


class ErrorClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _process(self, block, param, grad):
        out = block.create_var(name=unique_name.generate(grad.name + "_clip"),
                               dtype=grad.dtype, stop_gradient=True)
        block.append_op("clip", inputs={"X": [grad]}, outputs={"Out": [out]},
                        attrs={"min": self.min, "max": self.max,
                               "op_role": "backward"})
        out.shape = param.shape
        return out


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _process(self, block, param, grad):
        out = block.create_var(name=unique_name.generate(grad.name + "_clip"),
                               dtype=grad.dtype, stop_gradient=True)
        block.append_op("clip_by_norm", inputs={"X": [grad]},
                        outputs={"Out": [out]},
                        attrs={"max_norm": self.clip_norm,
                               "op_role": "backward"})
        out.shape = param.shape
        return out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Scale every gradient of the group by clip_norm / max(global_norm,
    clip_norm)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _process_group(self, block, params_grads):
        sq_norms = []
        for _, g in params_grads:
            sq = block.create_var(name=unique_name.generate(g.name + "_sq"),
                                  dtype="float32", stop_gradient=True)
            block.append_op("squared_l2_norm", inputs={"X": [g]},
                            outputs={"Out": [sq]},
                            attrs={"op_role": "backward"})
            sq_norms.append(sq)
        total = block.create_var(name=unique_name.generate("global_norm_sq"),
                                 dtype="float32", stop_gradient=True)
        block.append_op("sum", inputs={"X": sq_norms},
                        outputs={"Out": [total]},
                        attrs={"op_role": "backward"})
        gnorm = block.create_var(name=unique_name.generate("global_norm"),
                                 dtype="float32", stop_gradient=True)
        block.append_op("sqrt", inputs={"X": [total]},
                        outputs={"Out": [gnorm]},
                        attrs={"op_role": "backward"})
        clipped = block.create_var(name=unique_name.generate("clip_denom"),
                                   dtype="float32", stop_gradient=True)
        block.append_op("clip", inputs={"X": [gnorm]},
                        outputs={"Out": [clipped]},
                        attrs={"min": self.clip_norm, "max": 3.4e38,
                               "op_role": "backward"})
        out = []
        for p, g in params_grads:
            ng = block.create_var(name=unique_name.generate(g.name + "_gclip"),
                                  dtype=g.dtype, stop_gradient=True)
            scalefac = block.create_var(
                name=unique_name.generate("gclip_scale"), dtype="float32",
                stop_gradient=True)
            block.append_op("elementwise_div",
                            inputs={"X": [_const(block, self.clip_norm)],
                                    "Y": [clipped]},
                            outputs={"Out": [scalefac]},
                            attrs={"op_role": "backward"})
            block.append_op("elementwise_mul",
                            inputs={"X": [g], "Y": [scalefac]},
                            outputs={"Out": [ng]},
                            attrs={"op_role": "backward"})
            ng.shape = p.shape
            out.append((p, ng))
        return out

    def __call__(self, params_grads):
        block = default_main_program().global_block()
        return self._process_group(block, params_grads)


def _const(block, value):
    v = block.create_var(name=unique_name.generate("clip_const"),
                         dtype="float32", stop_gradient=True)
    block.append_op("fill_constant", outputs={"Out": [v]},
                    attrs={"shape": [1], "dtype": "float32",
                           "value": float(value), "op_role": "backward"})
    return v


_global_clip = None


def set_gradient_clip(clip, param_list=None, program=None):
    """The clip of every parameter without one of its own; with
    ``param_list``, also set as each of those parameters' own."""
    global _global_clip
    _global_clip = clip
    if param_list:
        for p in param_list:
            p.gradient_clip_attr = clip


def append_gradient_clip_ops(params_grads):
    """Each parameter's own clip (``ParamAttr(gradient_clip=...)`` or
    ``set_gradient_clip``'s): by value and by norm a gradient at a time,
    the global-norm group after them."""
    block = default_main_program().global_block()
    global_norm_group = []
    out = []
    for p, g in params_grads:
        clip = getattr(p, "gradient_clip_attr", None) or _global_clip
        if clip is None or isinstance(clip, ErrorClipByValue):
            out.append((p, g))
        elif isinstance(clip, GradientClipByGlobalNorm):
            global_norm_group.append((p, g))
        else:
            out.append((p, clip._process(block, p, g)))
    if global_norm_group:
        clip = getattr(global_norm_group[0][0], "gradient_clip_attr",
                       None) or _global_clip
        out.extend(clip._process_group(block, global_norm_group))
    return out
