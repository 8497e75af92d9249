"""Learning-rate schedulers (counterpart of
``paddle_tpu/fluid/layers/learning_rate_scheduler.py``).

Each returns a Variable computed in the program from the global step
counter (``autoincreased_step_counter``), so the schedule runs inside the
training step: on the card, inside its captured graph.
``piecewise_decay`` and ``linear_lr_warmup`` pick their value with a
Switch (conditional_block ops).  ``inverse_time_decay`` divides a number
by a Variable, which the port's ``Variable`` supports (the JAX package's
raises a TypeError there).
"""

from __future__ import annotations

import math

from ..framework import Variable
from ..initializer import Constant
from ..layer_helper import LayerHelper
from . import nn, tensor
from .control_flow import Switch, autoincreased_step_counter

__all__ = [
    "exponential_decay", "natural_exp_decay", "inverse_time_decay",
    "polynomial_decay", "piecewise_decay", "noam_decay", "cosine_decay",
    "linear_lr_warmup",
]


def _step_f32():
    return nn.cast(autoincreased_step_counter(), "float32")


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    step = _step_f32()
    a = nn.pow(step, factor=-0.5)
    b = step * float(warmup_steps ** -1.5)
    return (float(learning_rate) * float(d_model ** -0.5)) \
        * nn.elementwise_min(a, b)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    div = _step_f32() / float(decay_steps)
    if staircase:
        div = nn.floor(div)
    # decay_rate ** div with a variable exponent: exp(div * ln(rate))
    return float(learning_rate) * nn.exp(
        nn.scale(div, scale=float(math.log(decay_rate))))


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    div = _step_f32() / float(decay_steps)
    if staircase:
        div = nn.floor(div)
    return float(learning_rate) * nn.exp(
        nn.scale(div, scale=-float(decay_rate)))


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    div = _step_f32() / float(decay_steps)
    if staircase:
        div = nn.floor(div)
    denom = nn.scale(div, scale=float(decay_rate), bias=1.0)
    return float(learning_rate) / denom


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    step = _step_f32()
    if cycle:
        ratio = nn.ceil(step / float(decay_steps))
        ratio = nn.elementwise_max(
            ratio, tensor.fill_constant([1], "float32", 1.0))
        decay = ratio * float(decay_steps)
    else:
        decay = tensor.fill_constant([1], "float32", float(decay_steps))
        step = nn.elementwise_min(step, decay)
    frac = nn.pow(nn.scale(step / decay, scale=-1.0, bias=1.0), factor=power)
    return (float(learning_rate) - float(end_learning_rate)) * frac \
        + float(end_learning_rate)


def _lr_var(name, value):
    """A persistable [1] float32 learning-rate var, ``value`` at start."""
    helper = LayerHelper(name)
    lr = helper.create_global_variable(
        name=helper.name + "_lr", shape=[1], dtype="float32",
        persistable=True, stop_gradient=True)
    helper.set_variable_initializer(lr, Constant(float(value)))
    return lr


def piecewise_decay(boundaries, values):
    """values[i] while the step is below boundaries[i], values[-1]
    after: a Switch of conditional_block ops."""
    if len(values) - len(boundaries) != 1:
        raise ValueError("len(values) must be len(boundaries) + 1")
    lr = _lr_var("piecewise_decay", values[0])
    step = _step_f32()
    with Switch() as switch:
        for b, v in zip(boundaries, values[:-1]):
            bound = tensor.fill_constant([1], "float32", float(b))
            with switch.case(nn.less_than(step, bound)):
                tensor.assign(tensor.fill_constant([1], "float32", float(v)),
                              output=lr)
        with switch.default():
            tensor.assign(
                tensor.fill_constant([1], "float32", float(values[-1])),
                output=lr)
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    epoch = nn.floor(_step_f32() / float(step_each_epoch))
    cos_term = nn.cos(nn.scale(epoch, scale=float(math.pi / epochs)))
    return 0.5 * float(learning_rate) * nn.scale(cos_term, bias=1.0)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """A linear ramp from start_lr to end_lr over warmup_steps, then
    ``learning_rate`` (a number or another schedule's Variable): a
    Switch of conditional_block ops."""
    lr = _lr_var("lr_warmup", start_lr)
    step = _step_f32()
    if not isinstance(learning_rate, Variable):
        learning_rate = tensor.fill_constant([1], "float32",
                                             float(learning_rate))
    with Switch() as switch:
        warm = tensor.fill_constant([1], "float32", float(warmup_steps))
        with switch.case(nn.less_than(step, warm)):
            ramp = (float(end_lr) - float(start_lr)) \
                * (step / float(warmup_steps))
            tensor.assign(nn.scale(ramp, bias=float(start_lr)), output=lr)
        with switch.default():
            tensor.assign(learning_rate, output=lr)
    return lr
