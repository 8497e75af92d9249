"""The optimizers this slice ports (paddle_tpu_torch/fluid/optimizer.py
and ops/optimizer_ops.py) against the JAX package, on the CPU:

- each new optimizer op (lars_momentum, adagrad, decayed_adagrad,
  rmsprop plain / centered with momentum, adadelta, adamax, ftrl, lamb,
  proximal_gd with and without l1) against the JAX registry's lowering
  on the same seeded arrays, 1e-6 relative (the same fp32 formula; the
  norms sum in another order), and updating the state in place;
- each new optimizer class over the two-fc classifier
  (tests/test_torch_port_clip_regularizer.py), 5 steps from the JAX
  package's initial parameters: the same op lists (Adamax's beta-power
  ``scale`` ops included), losses and final parameters within 1e-5;
- ``ExponentialMovingAverage``: ``update()``'s ops, the averages after
  3 steps, ``apply()`` swapping them into the scope's own tensors (a
  captured graph's inputs) and restoring the parameters on exit,
  ``restore()`` a no-op.
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid import registry as jreg

from paddle_tpu_torch import convert
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import registry as treg

from test_torch_port_clip_regularizer import (PKGS, _classifier, _data,
                                              op_list)

OP_RTOL = 1e-6
TRAIN_TOL = 1e-5


def _run_jax(op_type, inputs, attrs):
    ctx = jreg.LowerContext(step=0)
    ctx.op_index = 0
    vals = [None if a is None else jnp.asarray(a) for a in inputs]
    out = jreg.get_op(op_type).lower(ctx, *vals, attrs=dict(attrs))
    return out if isinstance(out, tuple) else (out,)


def _run_port(op_type, inputs, attrs):
    ctx = treg.LowerContext("cpu")
    vals = [None if a is None else torch.from_numpy(np.array(a))
            for a in inputs]
    out = treg.get_op(op_type).lower(ctx, *vals, attrs=dict(attrs))
    return vals, out if isinstance(out, tuple) else (out,)


r = np.random.RandomState(0)


def _f(*shape, scale=1.0, positive=False):
    a = r.randn(*shape) * scale
    return np.asarray(np.abs(a) if positive else a, np.float32)


_lr = np.array([0.05], np.float32)
_p, _g = _f(6, 5), _f(6, 5, scale=0.3)

# op -> (inputs, attrs): the JAX lowering's input order
OP_CASES = {
    "lars_momentum": ("lars_momentum", [_p, _g, _f(6, 5), _lr],
                      {"mu": 0.9, "lars_coeff": 0.001,
                       "lars_weight_decay": 0.0005}),
    "lars_momentum_zero_param": ("lars_momentum",
                                 [np.zeros((4,), np.float32), _f(4),
                                  _f(4), _lr], {}),
    "adagrad": ("adagrad", [_p, _g, _f(6, 5, positive=True), _lr],
                {"epsilon": 1e-6}),
    "decayed_adagrad": ("decayed_adagrad",
                        [_p, _g, _f(6, 5, positive=True), _lr],
                        {"decay": 0.9, "epsilon": 1e-6}),
    "rmsprop": ("rmsprop", [_p, _g, _f(6, 5), _f(6, 5, positive=True),
                            _f(6, 5, scale=0.1), _lr],
                {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.0,
                 "centered": False}),
    "rmsprop_centered_momentum": (
        "rmsprop", [_p, _g, _f(6, 5), _f(6, 5, positive=True) + 1,
                    _f(6, 5, scale=0.1), _lr],
        {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.5,
         "centered": True}),
    "adadelta": ("adadelta", [_p, _g, _f(6, 5, positive=True),
                              _f(6, 5, positive=True)],
                 {"rho": 0.95, "epsilon": 1e-6}),
    "adamax": ("adamax", [_p, _g, _f(6, 5), _f(6, 5, positive=True), _lr,
                          np.array([0.81], np.float32)],
               {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "ftrl": ("ftrl", [_p, _f(6, 5, positive=True), _f(6, 5), _g, _lr],
             {"l1": 0.01, "l2": 0.02, "lr_power": -0.5}),
    "ftrl_zero_state": ("ftrl", [_p, np.zeros((6, 5), np.float32),
                                 np.zeros((6, 5), np.float32), _g, _lr],
                        {}),
    "lamb": ("lamb", [_p, _g, _f(6, 5), _f(6, 5, positive=True), _lr,
                      np.array([0.81], np.float32),
                      np.array([0.998], np.float32)],
             {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
              "weight_decay": 0.01}),
    "proximal_gd": ("proximal_gd", [_p, _g, _lr], {"l1": 0.0, "l2": 0.1}),
    "proximal_gd_l1": ("proximal_gd", [_p, _g, _lr],
                       {"l1": 0.5, "l2": 0.1}),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_optimizer_op_matches_jax(case):
    op_type, inputs, attrs = OP_CASES[case]
    vals, got = _run_port(op_type, inputs, attrs)
    want = _run_jax(op_type, inputs, attrs)
    info = treg.get_op(op_type)
    assert len(got) == len(want) == len(info.output_slots)
    slots = [s.rstrip("*") for s in info.input_slots]
    for slot, g, w in zip(info.output_slots, got, want):
        if w is None:
            assert g is None, (case, slot)
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=OP_RTOL,
                                   atol=OP_RTOL, err_msg=f"{case} {slot}")
        # the state is updated in place: the output is the input tensor
        src = info.inplace.get(slot)
        if src is not None:
            assert g is vals[slots.index(src)], (case, slot)


OPTIMIZERS = {
    "LarsMomentum": lambda fl: fl.optimizer.LarsMomentum(
        0.1, momentum=0.9, lars_coeff=0.01),
    "Adagrad": lambda fl: fl.optimizer.Adagrad(
        0.1, initial_accumulator_value=0.1),
    "Adamax": lambda fl: fl.optimizer.Adamax(0.05),
    "DecayedAdagrad": lambda fl: fl.optimizer.DecayedAdagrad(0.05),
    "Adadelta": lambda fl: fl.optimizer.Adadelta(1.0, rho=0.9),
    "RMSProp": lambda fl: fl.optimizer.RMSProp(0.01, momentum=0.5),
    "RMSPropCentered": lambda fl: fl.optimizer.RMSProp(0.01, centered=True),
    "Ftrl": lambda fl: fl.optimizer.Ftrl(0.1, l1=0.001, l2=0.001),
    "Lamb": lambda fl: fl.optimizer.Lamb(0.01, lamb_weight_decay=0.01),
}


def _train(fl, main, startup, loss, init, feed, steps):
    scope = fl.Scope()
    exe = fl.Executor(fl.CPUPlace())
    with fl.scope_guard(scope):
        exe.run(startup, scope=scope)
        if init is None:
            init = {p.name: np.array(scope.get(p.name))
                    for p in main.all_parameters()}
        else:
            convert.load_params(scope, init, fl.CPUPlace(), program=main)
        losses = [float(np.asarray(exe.run(main, feed=feed,
                                           fetch_list=[loss],
                                           scope=scope)[0]))
                  for _ in range(steps)]
    return init, losses, scope


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_trains_classifier_as_jax(name):
    make = OPTIMIZERS[name]
    progs = {k: _classifier(fl, opt=lambda fl, reg, clip: make(fl))
             for k, fl in PKGS.items()}
    assert op_list(progs["torch"][0]) == op_list(progs["jax"][0])
    feed = _data()
    init, want, jscope = _train(jfluid, *progs["jax"], None, feed, 5)
    _, got, tscope = _train(tfluid, *progs["torch"], init, feed, 5)
    np.testing.assert_allclose(got, want, rtol=TRAIN_TOL)
    assert got[-1] < got[0]
    for n in init:
        np.testing.assert_allclose(tscope.get(n).numpy(),
                                   np.asarray(jscope.get(n)),
                                   rtol=TRAIN_TOL, atol=TRAIN_TOL,
                                   err_msg=n)


def test_adamax_advances_its_beta_power_by_scale_ops():
    main = _classifier(tfluid, opt=lambda fl, r, c: fl.optimizer.Adamax(
        0.05, beta1=0.8))[0]
    ops = main.global_block().ops
    scales = [op for op in ops if op.type == "scale"
              and op.attrs.get("op_role") == "optimize"]
    assert len(scales) == 4 and all(op.attrs["scale"] == 0.8
                                    for op in scales)
    assert all(op.inputs["X"] == op.outputs["Out"] for op in scales)
    assert ops.index(scales[0]) > max(i for i, op in enumerate(ops)
                                      if op.type == "adamax")


def test_exponential_moving_average_update_apply_restore():
    feed = _data()
    progs, emas = {}, {}
    for k, fl in PKGS.items():
        main, startup, loss = _classifier(fl)
        with fl.program_guard(main, startup), fl.unique_name.guard():
            ema = fl.optimizer.ExponentialMovingAverage(0.9)
            ema.update()
        progs[k], emas[k] = (main, startup, loss), ema
    assert op_list(progs["torch"][0]) == op_list(progs["jax"][0])
    init, want, jscope = _train(jfluid, *progs["jax"], None, feed, 3)
    _, got, tscope = _train(tfluid, *progs["torch"], init, feed, 3)
    np.testing.assert_allclose(got, want, rtol=TRAIN_TOL)
    names = [p.name for p in progs["torch"][0].all_parameters()]
    tema = {n: emas["torch"]._ema_vars[n].name for n in names}
    for n in names:
        np.testing.assert_allclose(
            tscope.get(tema[n]).numpy(),
            np.asarray(jscope.get(emas["jax"]._ema_vars[n].name)),
            rtol=TRAIN_TOL, atol=1e-7, err_msg=n)
    trained = {n: tscope.get(n).clone() for n in names}
    held = {n: tscope.get(n) for n in names}
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tscope):
        with emas["torch"].apply(exe):
            for n in names:
                assert tscope.get(n) is held[n]
                assert torch.equal(tscope.get(n), tscope.get(tema[n]))
        for n in names:
            assert tscope.get(n) is held[n]
            assert torch.equal(tscope.get(n), trained[n])
        with emas["torch"].apply(exe, need_restore=False):
            pass
        emas["torch"].restore(exe)
        for n in names:
            assert torch.equal(tscope.get(n), tscope.get(tema[n]))
