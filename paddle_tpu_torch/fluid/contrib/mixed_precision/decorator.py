"""The AMP optimizer decorator (counterpart of
``paddle_tpu/fluid/contrib/mixed_precision/decorator.py``; the
reference's decorator.py:194 ``decorate``): wraps an optimizer so that
``minimize()`` trains in mixed precision.

The defaults are the JAX package's: bf16 (fp32's exponent range), so a
static loss scale of 1.0.  fp16 wants ``init_loss_scaling=2**15`` and
``use_dynamic_loss_scaling=True``.  Parameters stay fp32 master
weights.  The loss is scaled by the ``loss_scaling`` var; the grads are
unscaled, and zeroed on a step with an inf or NaN, by
``check_finite_and_unscale`` before the optimizer ops; with dynamic
scaling ``update_loss_scaling`` then moves the scale on the device
(ops/amp_ops.py), so a captured step reads what the last replay wrote.
"""

from __future__ import annotations

from ... import framework
from ...framework import unique_name
from ...initializer import Constant
from ...layer_helper import LayerHelper
from .fp16_lists import AutoMixedPrecisionLists
from .fp16_utils import rewrite_program

__all__ = ["decorate", "OptimizerWithMixedPrecision"]


class OptimizerWithMixedPrecision:
    def __init__(self, optimizer, amp_lists, init_loss_scaling,
                 use_dynamic_loss_scaling, incr_every_n_steps,
                 decr_every_n_nan_or_inf, incr_ratio, decr_ratio, dest_dtype):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._init_loss_scaling = float(init_loss_scaling)
        self._use_dynamic = use_dynamic_loss_scaling
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._dest_dtype = dest_dtype
        self._loss_scaling = None
        self._startup_program = None

    def get_loss_scaling(self):
        """The persistable ``loss_scaling`` var (None before
        ``backward``)."""
        return self._loss_scaling

    def _create_scalar(self, name, value, dtype="float32"):
        helper = LayerHelper("amp")
        v = helper.create_global_variable(
            name=unique_name.generate(name), shape=[1], dtype=dtype,
            persistable=True, stop_gradient=True)
        helper.set_variable_initializer(v, Constant(value))
        return v

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """Rewrite the program (fp16_utils.rewrite_program), scale the
        loss by ``loss_scaling`` and append the backward of the scaled
        loss."""
        program = loss.block.program
        self._startup_program = startup_program
        with framework.program_guard(program, startup_program):
            rewrite_program(program, self._amp_lists, self._dest_dtype)
            self._loss_scaling = self._create_scalar(
                "loss_scaling", self._init_loss_scaling)
            block = loss.block
            scaled_loss = block.create_var(
                name=unique_name.generate(loss.name + ".scaled"),
                shape=loss.shape, dtype=loss.dtype, stop_gradient=False)
            block.append_op(
                "scale",
                inputs={"X": [loss.name],
                        "ScaleTensor": [self._loss_scaling.name]},
                outputs={"Out": [scaled_loss.name]})
            params_grads = self._optimizer.backward(
                scaled_loss, startup_program, parameter_list, no_grad_set)
        self._scaled_loss = scaled_loss
        return params_grads

    def apply_gradients(self, params_grads):
        if not params_grads:
            return self._optimizer.apply_gradients(params_grads)
        program = params_grads[0][0].block.program
        # the scalars and their initializers go to the program being
        # optimized and its startup, not the ambient defaults
        with framework.program_guard(program, self._startup_program):
            return self._apply_gradients_impl(program, params_grads)

    def _apply_gradients_impl(self, program, params_grads):
        block = program.global_block()
        grad_names = [g.name for _, g in params_grads]
        found_inf = block.create_var(
            name=unique_name.generate("find_infinite_scale"),
            shape=[1], dtype="bool", stop_gradient=True)
        block.append_op(
            "check_finite_and_unscale",
            inputs={"X": grad_names, "Scale": [self._loss_scaling.name]},
            outputs={"Out": grad_names, "FoundInfinite": [found_inf.name]},
            attrs={"op_role": "backward"})
        if self._use_dynamic:
            good = self._create_scalar("good_steps", 0, dtype="int32")
            bad = self._create_scalar("bad_steps", 0, dtype="int32")
            block.append_op(
                "update_loss_scaling",
                inputs={"PrevLossScaling": [self._loss_scaling.name],
                        "FoundInfinite": [found_inf.name],
                        "InGoodSteps": [good.name], "InBadSteps": [bad.name]},
                outputs={"LossScaling": [self._loss_scaling.name],
                         "OutGoodSteps": [good.name],
                         "OutBadSteps": [bad.name]},
                attrs={"incr_every_n_steps": self._incr_every_n_steps,
                       "decr_every_n_nan_or_inf":
                           self._decr_every_n_nan_or_inf,
                       "incr_ratio": self._incr_ratio,
                       "decr_ratio": self._decr_ratio,
                       "op_role": "backward"})
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads


def decorate(optimizer, amp_lists=None, init_loss_scaling=1.0,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8,
             use_dynamic_loss_scaling=False, dest_dtype="bfloat16"):
    """Wrap ``optimizer`` for AMP training: bf16 with a static scale of
    1.0 by default; for fp16, ``dest_dtype="float16"``,
    ``init_loss_scaling=2**15`` and ``use_dynamic_loss_scaling=True``."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
        incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
        dest_dtype)
