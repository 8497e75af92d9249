"""Weight-decay regularizers (counterpart of
``paddle_tpu/fluid/regularizer.py``).

A regularizer appends ops that add a decay term of the parameter to its
gradient, ahead of gradient clipping and the update (the optimizer's
``_append_regularization_ops``): ``L2Decay`` adds coeff·p (``scale``),
``L1Decay`` coeff·sign(p) (``sign``, ``scale``), each joined to the
gradient by a ``sum`` op.  The ops carry ``op_role="backward"``, as the
JAX package's do, so the bf16 dtype policy treats them as it treats the
backward.
"""

from __future__ import annotations

from .framework import unique_name

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer"]


class WeightDecayRegularizer:
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def _append_ops(self, block, param, grad):
        """grad + decay_term(param) as a new var, which it returns."""
        decay = block.create_var(
            name=unique_name.generate(param.name + "_decay"),
            dtype=param.dtype, stop_gradient=True)
        self._decay_op(block, param, decay)
        out = block.create_var(name=unique_name.generate(grad.name + "_reg"),
                               dtype=param.dtype, stop_gradient=True)
        block.append_op("sum", inputs={"X": [grad, decay]},
                        outputs={"Out": [out]},
                        attrs={"op_role": "backward"})
        out.shape = param.shape
        return out

    def _decay_op(self, block, param, decay):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def _decay_op(self, block, param, decay):
        block.append_op("scale", inputs={"X": [param]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._coeff, "op_role": "backward"})


class L1DecayRegularizer(WeightDecayRegularizer):
    def _decay_op(self, block, param, decay):
        sign = block.create_var(
            name=unique_name.generate(param.name + "_sign"),
            dtype=param.dtype, stop_gradient=True)
        block.append_op("sign", inputs={"X": [param]},
                        outputs={"Out": [sign]},
                        attrs={"op_role": "backward"})
        block.append_op("scale", inputs={"X": [sign]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._coeff, "op_role": "backward"})


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
