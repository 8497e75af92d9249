"""Optimizers (counterpart of ``paddle_tpu/fluid/optimizer.py``).

``minimize(loss)`` is ``append_backward`` plus one optimizer op per
parameter, appended to the program; the accumulators (moments, beta
powers) and the learning-rate var are persistable vars created and
initialized in the startup program.  The executor runs the update ops
like any other op; ``adam`` updates the parameter and its state in
place (ops/optimizer_ops.py), where the JAX package donates buffers.

Ported so far: the ``Optimizer`` base, ``SGD``, ``Momentum`` (with
``use_nesterov``), ``Adam`` and ``AdamW``.  ``apply_gradients`` records
``program._params_grads``, which the data-parallel transpiler reads.
Regularization and gradient clipping are not ported: ``minimize``
raises when either is asked for, rather than train without it.
"""

from __future__ import annotations

from . import framework
from .backward import append_backward
from .framework import unique_name
from .initializer import Constant
from .layer_helper import LayerHelper

__all__ = ["Optimizer", "SGD", "SGDOptimizer", "Momentum",
           "MomentumOptimizer", "Adam", "AdamOptimizer", "AdamW",
           "AdamWOptimizer"]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None,
                 grad_clip=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._grad_clip = grad_clip
        self._accumulators = {}  # acc name -> {param name: var}
        self._lr_var = None

    def _create_lr_var(self):
        if self._lr_var is not None:
            return
        helper = LayerHelper("learning_rate")
        lr = helper.create_global_variable(
            name=unique_name.generate("learning_rate"), shape=[1],
            dtype="float32", persistable=True, stop_gradient=True)
        helper.set_variable_initializer(lr,
                                        Constant(float(self._learning_rate)))
        self._lr_var = lr

    def _add_accumulator(self, name, param, fill_value=0.0, shape=None):
        if param.name in self._accumulators.get(name, {}):
            return self._accumulators[name][param.name]
        helper = LayerHelper(name)
        var = helper.create_global_variable(
            name=unique_name.generate(f"{param.name}_{name}"),
            shape=shape or list(param.shape), dtype="float32",
            persistable=True, stop_gradient=True)
        helper.set_variable_initializer(var, Constant(fill_value))
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def backward(self, loss, parameter_list=None, no_grad_set=None):
        return append_backward(loss, parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        if self.regularization is not None or self._grad_clip is not None \
                or any(getattr(p, "regularizer", None) is not None
                       for p, _ in params_grads):
            raise NotImplementedError(
                "regularization and gradient clipping are not ported to "
                "paddle_tpu_torch yet")
        program = (params_grads[0][0].block.program if params_grads
                   else framework.default_main_program())
        # the raw grads: the data-parallel transpiler all-reduces these
        program._params_grads = [(p.name, g.name) for p, g in params_grads]
        with framework.program_guard(program):
            block = program.global_block()
            self._create_lr_var()
            self._create_accumulators(block, [p for p, _ in params_grads])
            ops = []
            for pg in params_grads:
                op = self._append_optimize_op(block, pg)
                op.attrs["op_role"] = "optimize"
                ops.append(op)
        return ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        if startup_program is not None:
            raise NotImplementedError(
                "minimize(startup_program=...): the accumulators go to "
                "the default startup program")
        params_grads = self.backward(loss, parameter_list, no_grad_set)
        return self.apply_gradients(params_grads), params_grads


class SGDOptimizer(Optimizer):
    type = "sgd"

    def _append_optimize_op(self, block, pg):
        p, g = pg
        return block.append_op(
            "sgd", inputs={"Param": [p], "Grad": [g],
                           "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p]})


class MomentumOptimizer(Optimizer):
    type = "momentum"

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                    "LearningRate": [self._lr_var]},
            outputs={"ParamOut": [p], "VelocityOut": [v]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov})


class AdamOptimizer(Optimizer):
    type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p,
                                  fill_value=self._beta1, shape=[1])
            self._add_accumulator("beta2_pow_acc", p,
                                  fill_value=self._beta2, shape=[1])

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        b2p = self._get_accumulator("beta2_pow_acc", p)
        return block.append_op(
            self.type,
            inputs={"Param": [p], "Grad": [g], "Moment1": [m1],
                    "Moment2": [m2], "LearningRate": [self._lr_var],
                    "Beta1Pow": [b1p], "Beta2Pow": [b2p]},
            outputs={"ParamOut": [p], "Moment1Out": [m1],
                     "Moment2Out": [m2], "Beta1PowOut": [b1p],
                     "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, **self._extra_attrs()})

    def _extra_attrs(self):
        return {}


class AdamWOptimizer(AdamOptimizer):
    type = "adamw"

    def __init__(self, learning_rate=0.001, weight_decay=0.01, **kw):
        super().__init__(learning_rate, **kw)
        self._coeff = weight_decay

    def _extra_attrs(self):
        return {"coeff": self._coeff}


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
