"""Optimizers (counterpart of ``paddle_tpu/fluid/optimizer.py``).

``minimize(loss)`` is ``append_backward``, then, in the JAX package's
order (``apply_gradients``): the raw grads recorded in
``program._params_grads`` (the data-parallel transpiler all-reduces
these, so decay and clipping see the whole gradient), the
learning-rate var, the regularizers' ops (fluid/regularizer.py; a
parameter's own regularizer wins over the optimizer's), the optimizer's
``grad_clip`` or else each parameter's own clip (fluid/clip.py), the
accumulators, one update op a parameter and the optimizer's
``_finish_update`` ops.  The accumulators (moments, beta powers) and
the learning-rate var are persistable vars created and initialized in
the default startup program; ``minimize(startup_program=...)`` is
accepted and, as in the JAX package, changes nothing.  The executor
runs the update ops like any other op; they update the parameter and
its state in place (ops/optimizer_ops.py), where the JAX package
donates buffers.

Ported: the ``Optimizer`` base, ``SGD``, ``Momentum`` (with
``use_nesterov``), ``LarsMomentum``, ``Adagrad``, ``Adam``, ``AdamW``,
``Adamax``, ``DecayedAdagrad``, ``Adadelta``, ``RMSProp``, ``Ftrl``,
``Lamb``, ``ExponentialMovingAverage``, ``ModelAverage`` and
``GradientMergeOptimizer``.  Not ported: ``DGCMomentum`` (the ``dgc``
ops), ``PipelineOptimizer`` and the dygraph paths.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import clip, framework
from .backward import append_backward
from .framework import default_main_program, unique_name
from .initializer import Constant
from .layer_helper import LayerHelper

__all__ = [
    "Optimizer", "SGD", "Momentum", "Adagrad", "Adam", "Adamax", "AdamW",
    "DecayedAdagrad", "Adadelta", "RMSProp", "Ftrl", "Lamb", "LarsMomentum",
    "SGDOptimizer", "MomentumOptimizer", "AdagradOptimizer", "AdamOptimizer",
    "AdamaxOptimizer", "AdamWOptimizer", "DecayedAdagradOptimizer",
    "AdadeltaOptimizer", "RMSPropOptimizer", "FtrlOptimizer",
    "LambOptimizer", "LarsMomentumOptimizer", "ExponentialMovingAverage",
    "ModelAverage", "GradientMergeOptimizer",
]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None,
                 grad_clip=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._grad_clip = grad_clip
        self._accumulators = {}  # acc name -> {param name: var}
        self._lr_var = None

    def _create_lr_var(self):
        """The [1] learning-rate var the update ops read: the caller's
        Variable (a schedule, fluid/layers/learning_rate_scheduler.py),
        else a persistable var the startup program sets to the number."""
        if isinstance(self._learning_rate, framework.Variable):
            self._lr_var = self._learning_rate
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

    def _finish_update(self, block, params_grads):
        pass

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        return append_backward(loss, parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        """The JAX package's ``_apply_gradients_impl``, in the
        parameters' program (a caller may minimize after leaving its
        program_guard)."""
        program = (params_grads[0][0].block.program if params_grads
                   else default_main_program())
        # the raw grads, before decay and clipping: the data-parallel
        # transpiler all-reduces these
        program._params_grads = [(p.name, g.name) for p, g in params_grads]
        with framework.program_guard(program):
            block = program.global_block()
            self._create_lr_var()
            params_grads = self._append_regularization_ops(block,
                                                           params_grads)
            if self._grad_clip is not None:
                params_grads = self._grad_clip(params_grads)
            else:
                params_grads = clip.append_gradient_clip_ops(params_grads)
            self._create_accumulators(block, [p for p, _ in params_grads])
            ops = []
            for pg in params_grads:
                op = self._append_optimize_op(block, pg)
                op.attrs["op_role"] = "optimize"
                ops.append(op)
            self._finish_update(block, params_grads)
        return ops

    def _append_regularization_ops(self, block, params_grads):
        """grad + the decay term of the parameter's own regularizer, or
        else of the optimizer's ``regularization``."""
        out = []
        for p, g in params_grads:
            reg = getattr(p, "regularizer", None) or self.regularization
            out.append((p, g) if reg is None else
                       (p, reg._append_ops(block, p, g)))
        return out

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
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


class _ElementwiseOptimizer(Optimizer):
    """An optimizer whose op reads Param, Grad, its accumulators and
    (``_uses_lr``) LearningRate, and writes ParamOut and each
    accumulator's ``<slot>Out``: ``_slots`` maps the op's accumulator
    slots to (accumulator name, initial value)."""

    _slots = {}
    _uses_lr = True
    _out_slot = {}  # an accumulator slot whose output slot is not <slot>Out

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            for acc, fill in self._slots.values():
                self._add_accumulator(acc, p, fill_value=fill(self))

    def _attrs(self):
        return {}

    def _append_optimize_op(self, block, pg):
        p, g = pg
        inputs = {"Param": [p], "Grad": [g]}
        outputs = {"ParamOut": [p]}
        for slot, (acc, _) in self._slots.items():
            v = self._get_accumulator(acc, p)
            inputs[slot] = [v]
            outputs[self._out_slot.get(slot, slot + "Out")] = [v]
        if self._uses_lr:
            inputs["LearningRate"] = [self._lr_var]
        return block.append_op(self.type, inputs=inputs, outputs=outputs,
                               attrs=self._attrs())


def _zero(opt):
    return 0.0


class LarsMomentumOptimizer(_ElementwiseOptimizer):
    type = "lars_momentum"
    _slots = {"Velocity": ("velocity", _zero)}

    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _attrs(self):
        return {"mu": self._momentum, "lars_coeff": self._lars_coeff,
                "lars_weight_decay": self._lars_weight_decay}


class AdagradOptimizer(_ElementwiseOptimizer):
    type = "adagrad"
    _slots = {"Moment": ("moment", lambda o: o._init_acc)}

    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _attrs(self):
        return {"epsilon": self._epsilon}


class AdamaxOptimizer(Optimizer):
    """Adamax: the op reads the beta1 power and ``_finish_update``
    advances it with one ``scale`` op a parameter."""

    type = "adamax"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p,
                                  fill_value=self._beta1, shape=[1])

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m = self._get_accumulator("moment", p)
        inf = self._get_accumulator("inf_norm", p)
        return block.append_op(
            "adamax",
            inputs={"Param": [p], "Grad": [g], "Moment": [m],
                    "InfNorm": [inf], "LearningRate": [self._lr_var],
                    "Beta1Pow": [self._get_accumulator("beta1_pow_acc", p)]},
            outputs={"ParamOut": [p], "MomentOut": [m], "InfNormOut": [inf]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})

    def _finish_update(self, block, params_grads):
        for p, _ in params_grads:
            b1p = self._get_accumulator("beta1_pow_acc", p)
            block.append_op("scale", inputs={"X": [b1p]},
                            outputs={"Out": [b1p]},
                            attrs={"scale": self._beta1,
                                   "op_role": "optimize"})


class DecayedAdagradOptimizer(_ElementwiseOptimizer):
    type = "decayed_adagrad"
    _slots = {"Moment": ("moment", _zero)}

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay, self._epsilon = decay, epsilon

    def _attrs(self):
        return {"decay": self._decay, "epsilon": self._epsilon}


class AdadeltaOptimizer(_ElementwiseOptimizer):
    type = "adadelta"
    _slots = {"AvgSquaredGrad": ("__avg_squared_grad", _zero),
              "AvgSquaredUpdate": ("__avg_squared_update", _zero)}
    _uses_lr = False

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon, self._rho = epsilon, rho

    def _attrs(self):
        return {"epsilon": self._epsilon, "rho": self._rho}


class RMSPropOptimizer(_ElementwiseOptimizer):
    type = "rmsprop"
    _slots = {"Moment": ("momentum", _zero),
              "MeanSquare": ("mean_square", _zero),
              "MeanGrad": ("mean_grad", _zero)}

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _attrs(self):
        return {"decay": self._rho, "epsilon": self._epsilon,
                "momentum": self._momentum, "centered": self._centered}


class FtrlOptimizer(_ElementwiseOptimizer):
    type = "ftrl"
    _slots = {"SquaredAccumulator": ("squared", _zero),
              "LinearAccumulator": ("linear", _zero)}
    _out_slot = {"SquaredAccumulator": "SquaredAccumOut",
                 "LinearAccumulator": "LinearAccumOut"}

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _attrs(self):
        return {"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power}


class LambOptimizer(AdamOptimizer):
    type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, **kw):
        super().__init__(learning_rate, beta1=beta1, beta2=beta2,
                         epsilon=epsilon, **kw)
        self._weight_decay = lamb_weight_decay

    def _extra_attrs(self):
        return {"weight_decay": self._weight_decay}


class ExponentialMovingAverage:
    """An exponential moving average of every trainable parameter of the
    default main program: ``update()`` appends ema = decay·ema +
    (1 - decay)·p for each (``scale``, ``scale``, ``elementwise_add``,
    ``op_role="optimize"``); ``apply(executor)`` is a context in which
    the scope's parameters hold their averages, restored on exit unless
    ``need_restore`` is False.  The averages start at 0 and are not
    bias-corrected, as in the JAX package."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._name = name or "ema"
        self._ema_vars = {}
        self._params = []
        program = default_main_program()
        helper = LayerHelper(self._name)
        for p in program.all_parameters():
            if not p.trainable:
                continue
            ema = helper.create_global_variable(
                name=unique_name.generate(f"{p.name}_ema"),
                shape=list(p.shape), dtype=p.dtype, persistable=True,
                stop_gradient=True)
            helper.set_variable_initializer(ema, Constant(0.0))
            self._ema_vars[p.name] = ema
            self._params.append(p)

    def update(self):
        block = default_main_program().global_block()
        for p in self._params:
            ema = self._ema_vars[p.name]
            tmp = block.create_var(name=unique_name.generate("ema_tmp"),
                                   dtype=p.dtype, stop_gradient=True)
            block.append_op("scale", inputs={"X": [ema]},
                            outputs={"Out": [tmp]},
                            attrs={"scale": self._decay,
                                   "op_role": "optimize"})
            tmp2 = block.create_var(name=unique_name.generate("ema_tmp"),
                                    dtype=p.dtype, stop_gradient=True)
            block.append_op("scale", inputs={"X": [p]},
                            outputs={"Out": [tmp2]},
                            attrs={"scale": 1.0 - self._decay,
                                   "op_role": "optimize"})
            block.append_op("elementwise_add",
                            inputs={"X": [tmp], "Y": [tmp2]},
                            outputs={"Out": [ema]},
                            attrs={"op_role": "optimize"})

    def apply(self, executor, need_restore=True):
        from .executor import global_scope

        # The values are swapped in place: a captured graph's inputs are
        # the scope's own tensors, so the scope keeps its tensor objects
        # and only their contents change.
        @contextlib.contextmanager
        def guard():
            scope = global_scope()
            backup = {p.name: scope.get(p.name).clone() for p in self._params}
            for p in self._params:
                scope.get(p.name).copy_(
                    scope.get(self._ema_vars[p.name].name))
            try:
                yield
            finally:
                if need_restore:
                    for p in self._params:
                        scope.get(p.name).copy_(backup[p.name])

        return guard()

    def restore(self, executor):
        """A no-op: ``apply``'s context restores (the JAX package's
        contract)."""


class ModelAverage(ExponentialMovingAverage):
    """The JAX package's ``ModelAverage``: an exponential moving average
    of decay 0.999 (the window arguments are accepted and unused).  It
    maintains averages and is no training optimizer: ``minimize``,
    ``backward`` and ``apply_gradients`` raise."""

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, **kw):
        super().__init__(decay=0.999, **kw)

    def backward(self, *a, **kw):
        raise NotImplementedError("ModelAverage maintains averages; use a "
                                  "training optimizer for backward")

    apply_gradients = apply_optimize = minimize = backward

    def get_opti_var_name_list(self):
        return [v.name for v in self._ema_vars.values()]

    def load(self, stat_dict):
        """Copy the averages named in ``stat_dict`` into the global
        scope's own tensors."""
        from .executor import global_scope

        scope = global_scope()
        for name in self.get_opti_var_name_list():
            if name in stat_dict:
                have = scope.get(name)
                val = torch.as_tensor(np.asarray(stat_dict[name]))
                if have is None:
                    scope.set(name, val)
                else:
                    have.copy_(val.to(have.dtype))


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
LarsMomentum = LarsMomentumOptimizer


class GradientMergeOptimizer:
    """Gradient accumulation over ``k_steps`` micro-batches, the JAX
    package's program-rewrite form: the step stays one fixed-shape
    program and the boundary is chosen by arithmetic on the device, with
    no host read of the counter, so a captured graph replays it like
    any other step::

        acc   += grad                  every micro-step
        gate   = (step % k == 0)       1.0 on boundary steps
        <snapshot the parameters>
        <inner optimizer's update with the merged grad acc/k>
        state  = gate * updated + (1 - gate) * snapshot

    The snapshot and blend cover the parameters and every accumulator of
    the inner optimizer (Adam's moments and beta powers), each against a
    persistable ``_gm_snap`` that holds its value at the last boundary
    and that the startup program copies from the accumulator after the
    accumulator's own init (Adam's ``beta_pow`` starts at beta, not 0).
    ``@LR_DECAY_COUNTER@`` is reverted the same way, so a schedule
    advances once a boundary.  ``program._params_grads`` names the raw
    micro-batch grads.  The accumulation ops carry ``op_role=
    "backward"``, so under the bf16 policy the merged grad adds up in
    bf16, as in the JAX package; the blend and snapshot ops see fp32.
    ``k_steps=1`` is the inner optimizer."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        if int(k_steps) < 1:
            raise ValueError(f"k_steps must be >= 1, got {k_steps}")
        self.inner_optimizer = inner_optimizer
        self.k_steps = int(k_steps)
        self.avg = avg
        self.type = "gradient_merge"

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .layers import tensor as tensor_mod

        if self.k_steps == 1:
            return self.inner_optimizer.minimize(
                loss, startup_program, parameter_list, no_grad_set)
        program = loss.block.program
        with framework.program_guard(program, startup_program):
            params_grads = self.inner_optimizer.backward(
                loss, startup_program, parameter_list, no_grad_set)
            block = program.global_block()
            helper = LayerHelper("gradient_merge")
            counter = helper.create_global_variable(
                name=unique_name.generate("gm_step"), shape=[1],
                dtype="int32", persistable=True, stop_gradient=True)
            helper.set_variable_initializer(counter, Constant(0.0))
            block.append_op("increment", inputs={"X": [counter]},
                            outputs={"Out": [counter]},
                            attrs={"step": 1.0, "op_role": "backward"})
            modk = block.create_var(name=unique_name.generate("gm_mod"),
                                    dtype="int32", stop_gradient=True)
            block.append_op(
                "elementwise_mod",
                inputs={"X": [counter],
                        "Y": [tensor_mod.fill_constant([1], "int32",
                                                       self.k_steps)]},
                outputs={"Out": [modk]}, attrs={"op_role": "backward"})
            gate_b = block.create_var(name=unique_name.generate("gm_gate_b"),
                                      dtype="bool", stop_gradient=True)
            block.append_op(
                "equal",
                inputs={"X": [modk],
                        "Y": [tensor_mod.fill_constant([1], "int32", 0)]},
                outputs={"Out": [gate_b]}, attrs={"op_role": "backward"})
            gate = block.create_var(name=unique_name.generate("gm_gate"),
                                    dtype="float32", stop_gradient=True)
            block.append_op("cast", inputs={"X": [gate_b]},
                            outputs={"Out": [gate]},
                            attrs={"out_dtype": "float32",
                                   "op_role": "backward"})
            inv_gate = block.create_var(
                name=unique_name.generate("gm_inv_gate"), dtype="float32",
                stop_gradient=True)
            block.append_op("scale", inputs={"X": [gate]},
                            outputs={"Out": [inv_gate]},
                            attrs={"scale": -1.0, "bias": 1.0,
                                   "op_role": "backward"})

            merged, accs = [], []
            scale = 1.0 / self.k_steps if self.avg else 1.0
            for p, g in params_grads:
                acc = helper.create_global_variable(
                    name=unique_name.generate(p.name + "_gm_acc"),
                    shape=list(p.shape), dtype=p.dtype, persistable=True,
                    stop_gradient=True)
                acc.is_optimizer_state = True
                helper.set_variable_initializer(acc, Constant(0.0))
                accs.append(acc)
                block.append_op("elementwise_add",
                                inputs={"X": [acc], "Y": [g]},
                                outputs={"Out": [acc]},
                                attrs={"op_role": "backward"})
                eff = block.create_var(
                    name=unique_name.generate(g.name + "_gm_eff"),
                    dtype=p.dtype, stop_gradient=True)
                block.append_op("scale", inputs={"X": [acc]},
                                outputs={"Out": [eff]},
                                attrs={"scale": scale,
                                       "op_role": "backward"})
                merged.append((p, block.var(eff.name)))

            def snapshot(var):
                snap = block.create_var(
                    name=unique_name.generate(var.name + "_gm_snap"),
                    dtype=var.dtype, stop_gradient=True)
                block.append_op("assign", inputs={"X": [var]},
                                outputs={"Out": [snap]},
                                attrs={"op_role": "optimize"})
                return snap

            def select(var, snap):
                """var = gate·var + (1 − gate)·snap: a boundary keeps the
                update, a micro-step goes back to the snapshot."""
                keep = block.create_var(
                    name=unique_name.generate(var.name + "_gm_keep"),
                    dtype=var.dtype, stop_gradient=True)
                block.append_op("elementwise_mul",
                                inputs={"X": [var], "Y": [gate]},
                                outputs={"Out": [keep]},
                                attrs={"axis": -1, "op_role": "optimize"})
                old = block.create_var(
                    name=unique_name.generate(var.name + "_gm_old"),
                    dtype=var.dtype, stop_gradient=True)
                block.append_op("elementwise_mul",
                                inputs={"X": [snap], "Y": [inv_gate]},
                                outputs={"Out": [old]},
                                attrs={"axis": -1, "op_role": "optimize"})
                block.append_op("elementwise_add",
                                inputs={"X": [keep], "Y": [old]},
                                outputs={"Out": [var]},
                                attrs={"op_role": "optimize"})

            param_snaps = [(p, snapshot(p)) for p, _ in merged]
            optimize_ops = self.inner_optimizer.apply_gradients(merged)
            acc_vars = [v for accs_ in
                        self.inner_optimizer._accumulators.values()
                        for v in accs_.values()
                        if not isinstance(v, (int, float))]
            for p, snap in param_snaps:
                select(p, snap)
            lr_counter = block.vars.get("@LR_DECAY_COUNTER@")
            if lr_counter is not None:
                acc_vars.append(lr_counter)
            for acc_var in acc_vars:
                snap = helper.create_global_variable(
                    name=unique_name.generate(acc_var.name + "_gm_snap"),
                    shape=list(acc_var.shape) if acc_var.shape else None,
                    dtype=acc_var.dtype, persistable=True,
                    stop_gradient=True)
                snap.is_optimizer_state = True
                # after the accumulator's own init in the startup program
                sb = helper.startup_program.global_block()
                sb.create_var(name=snap.name, shape=snap.shape,
                              dtype=snap.dtype, persistable=True)
                sb.append_op("assign", inputs={"X": [acc_var.name]},
                             outputs={"Out": [snap.name]}, attrs={})
                select(acc_var, snap)
                block.append_op("assign", inputs={"X": [acc_var]},
                                outputs={"Out": [snap]},
                                attrs={"op_role": "optimize"})
            for acc in accs:  # the merged grad restarts after a boundary
                block.append_op("elementwise_mul",
                                inputs={"X": [acc], "Y": [inv_gate]},
                                outputs={"Out": [acc]},
                                attrs={"axis": -1, "op_role": "optimize"})
            program._params_grads = [(p.name, g.name)
                                     for p, g in params_grads]
        return optimize_ops, params_grads
