"""The image models in the PyTorch port against the JAX package, on the
CPU.

Child processes (tests/torch_port_cnn_oracle.py, three run at once)
build each case's training program with ``Momentum(1e-6, 0.9)`` in the
JAX package and dump its op list, initial parameters and moving
statistics, per-step losses, first gradients and final state.  The
port builds the same
program with its own front end, loads the initial state through
``convert.load_params`` (moving statistics included) on CPUPlace and
must give:

- the same op list (types, slots, attrs);
- ResNet-18 at 3x32x32, 10 classes, b4: 5 fp32 steps with losses
  within 1e-4 relative and every parameter and moving statistic within
  1e-4 of its norm, and the prediction of ``clone(for_test=True)``
  (batch norm on the moving statistics) within 1e-4; at b16, 3
  bf16-policy steps with losses within 2e-2 relative (bf16 rounds at
  other places in the two frameworks; the oracle says why the bf16
  case is larger);
- ResNet-50's stem and first stage (three bottleneck blocks at its
  widths) at 32x32, b2, and narrow forms of SE-ResNeXt, MobileNet,
  VGG, DenseNet, GoogLeNet (with its auxiliary heads) and the MNIST
  conv net: 2 fp32 steps each, losses within 1e-4 relative, state
  within 1e-4 of its norm;
- in every fp32 case, each parameter's first gradient (its Momentum
  velocity after the first step, from one state in both frameworks)
  within 5e-4 of its norm, floored at 1e-2 of the model's largest
  gradient RMS: the backward, which the state cannot show at a
  learning rate of 1e-6 (the parameters move less than their fp32
  rounding).  On the CPU every case reads under 1e-4, ResNet-18 the
  highest (its last batch norms see 4 values a channel).

A model's dropout ops get ``dropout_prob`` 0 after the op lists are
compared (two frameworks' generators cannot draw the same masks).
Also here: the program of ``build_resnet(depth=50)`` against the JAX
package's, and ``convert.load_params`` naming a missing moving
statistic.
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch import convert, fluid, models
from paddle_tpu_torch.fluid.contrib.mixed_precision import enable_bf16_policy

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_cnn_oracle as oracle_mod  # noqa: E402

ORACLE = oracle_mod.__file__
LOSS_RTOL, STATE_RTOL, PRED_ATOL = 1e-4, 1e-4, 1e-4
GRAD_RTOL, GRAD_FLOOR = 5e-4, 1e-2
BF16_LOSS_RTOL = 2e-2
# three children run at once, each a share of the cases
CHILDREN = (("resnet18", "resnet18_bf16"),
            ("googlenet", "vgg", "conv_net", "mobilenet"),
            ("se_resnext", "bottleneck_stack", "densenet"))
MODELS = [c for group in CHILDREN for c in group
          if not c.startswith("resnet18")]


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    out = tmp_path_factory.mktemp("cnn_oracle")
    root = os.path.dirname(os.path.dirname(ORACLE))
    procs = [subprocess.Popen([sys.executable, ORACLE, str(out), *group],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=root)
             for group in CHILDREN]
    for p in procs:
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0 and "TORCH_PORT_CNN_ORACLE_OK" in stdout, (
            f"JAX oracle child failed rc={p.returncode}\n{stderr[-3000:]}")
    res = {}
    for group in CHILDREN:
        for name in group:
            z = np.load(out / f"{name}.npz")
            res[name] = {k: z[k] for k in z.files}
    return res


def _prefixed(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def _op_list(program):
    return json.loads(oracle_mod.op_list(program))


def _build(name):
    builder = oracle_mod.cases(models)[name][0]
    return oracle_mod.build(fluid, builder)


def _train(name, want, steps, bf16=False):
    """``steps`` steps of the case from the oracle's initial state;
    returns (main, losses, scope, executor, prediction, feed, the
    first step's gradients by parameter: its Momentum velocities)."""
    main, startup, loss, pred = _build(name)
    oracle_mod.no_dropout(main)
    if bf16:
        enable_bf16_policy(main)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    convert.load_params(scope, _prefixed(want, "init:"), fluid.CPUPlace(),
                        program=main)
    feed = _prefixed(want, "feed:")
    losses, grads = [], {}
    for _ in range(steps):
        losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                    scope=scope)[0]))
        grads = grads or {p: scope.get(v).numpy().copy() for p, v in
                          oracle_mod.velocities(main).items()}
    return main, np.asarray(losses), scope, exe, pred, feed, grads


def _rel(got, want):
    """||got − want|| over ||want||, the norm floored at 1e-3·sqrt(size):
    a conv bias ahead of a batch norm gets a grad that is zero up to
    rounding and stays near its zero init in both frameworks."""
    return float(np.linalg.norm(got - want) / max(
        np.linalg.norm(want), 1e-3 * np.sqrt(want.size)))


def _check_state(scope, want, main, grads):
    final = _prefixed(want, "final:")
    assert set(final) == set(oracle_mod.state_names(main))
    worst = max(final, key=lambda n: _rel(scope.get(n).numpy(), final[n]))
    assert _rel(scope.get(worst).numpy(), final[worst]) <= STATE_RTOL, worst
    # the moving statistics moved, as the JAX package's did
    stats = [n for n in final if n.endswith(("_bn_mean", "_bn_variance",
                                             ".mean", ".var"))]
    init = _prefixed(want, "init:")
    assert all(not np.array_equal(final[n], init[n]) for n in stats)
    # the backward: at the oracle's LR the parameters move less than
    # their fp32 rounding, so each parameter's first gradient is held
    # to the JAX package's instead, its norm floored at GRAD_FLOOR of
    # the model's largest gradient RMS (a conv bias ahead of a batch
    # norm gets a gradient that is zero up to rounding)
    want_g = _prefixed(want, "grad:")
    assert set(grads) == set(want_g) == {p.name
                                         for p in main.all_parameters()}
    top = max(float(np.sqrt(np.mean(g ** 2))) for g in want_g.values())

    def err(p):
        g, w = grads[p], want_g[p]
        return float(np.linalg.norm(g - w) / max(
            np.linalg.norm(w), GRAD_FLOOR * top * np.sqrt(w.size)))

    worst = max(want_g, key=err)
    assert err(worst) <= GRAD_RTOL, (worst, err(worst))


@pytest.mark.parametrize("name", ["resnet18", "resnet18_bf16"] + MODELS)
def test_training_program_matches_jax_op_list(oracle, name):
    main, _, _, _ = _build(name)
    got, want = _op_list(main), json.loads(str(oracle[name]["ops"]))
    assert [op[0] for op in got] == [op[0] for op in want]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"op {i}: {g} != {w}"


def test_resnet18_fp32_training_matches_jax(oracle):
    want = oracle["resnet18"]
    main, losses, scope, exe, pred, feed, grads = _train(
        "resnet18", want, len(want["loss"]))
    np.testing.assert_allclose(losses, want["loss"], rtol=LOSS_RTOL)
    _check_state(scope, want, main, grads)
    # clone(for_test=True): batch norm on the moving statistics
    test_prog = main.clone(for_test=True)
    bn = [op for op in test_prog.global_block().ops
          if op.type == "batch_norm"]
    assert bn and all(op.attrs["is_test"] for op in bn)
    stats = {n: scope.get(n).clone() for op in bn
             for n in op.inputs["Mean"] + op.inputs["Variance"]}
    (got,) = exe.run(test_prog, feed=feed, fetch_list=[pred], scope=scope)
    np.testing.assert_allclose(got, want["test_pred"], rtol=0,
                               atol=PRED_ATOL)
    assert all(torch.equal(scope.get(n), t) for n, t in stats.items())


def test_resnet18_bf16_policy_training_matches_jax(oracle):
    want = oracle["resnet18_bf16"]
    main, losses, scope, _, _, _, _ = _train(
        "resnet18_bf16", want, len(want["bf16_loss"]), bf16=True)
    np.testing.assert_allclose(losses, want["bf16_loss"],
                               rtol=BF16_LOSS_RTOL)
    for p in main.all_parameters():
        assert scope.get(p.name).dtype == torch.float32  # fp32 masters


@pytest.mark.parametrize("name", MODELS)
def test_model_training_matches_jax(oracle, name):
    want = oracle[name]
    main, losses, scope, _, _, _, grads = _train(name, want,
                                                 len(want["loss"]))
    assert np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses, want["loss"], rtol=LOSS_RTOL)
    _check_state(scope, want, main, grads)


def test_resnet50_program_matches_jax():
    """``build_resnet(depth=50)`` with Momentum: the JAX package's op
    list (536 ops: 53 conv2d, 53 batch_norm, 49 relu, 2 pool2d, ...),
    parameter names and shapes (25.56 M parameters) and moving
    statistics."""
    from paddle_tpu import fluid as jfluid
    from paddle_tpu.models import resnet as jresnet

    progs = []
    for fl, mod in ((jfluid, jresnet), (fluid, models.resnet)):
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup), fl.unique_name.guard():
            _, _, loss, _ = mod.build_resnet(depth=50)
            fl.optimizer.Momentum(0.1, 0.9).minimize(loss)
        progs.append(main)
    got, want = (json.loads(oracle_mod.op_list(p)) for p in progs[::-1])
    assert len(got) == 536 and got == want
    shapes = [{p.name: tuple(p.shape) for p in m.all_parameters()}
              for m in progs]
    assert shapes[1] == shapes[0]
    assert sum(int(np.prod(s)) for s in shapes[1].values()) == 25_557_032
    types = [op[0] for op in got]
    assert (types.count("conv2d"), types.count("batch_norm"),
            types.count("relu"), types.count("pool2d")) == (53, 53, 49, 2)
    assert oracle_mod.state_names(progs[1]) == oracle_mod.state_names(
        progs[0])


def test_load_params_names_a_missing_moving_statistic(oracle):
    """The moving statistics are persistable but not parameters: with
    one left out of the arrays, load_params names it and loads nothing
    (it would otherwise keep its startup value silently)."""
    want = oracle["resnet18"]
    main, startup, _, _ = _build("resnet18")
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    arrays = _prefixed(want, "init:")
    missing = "res_conv1_bn_mean"
    del arrays[missing]
    before = scope.get("res2a_branch2a_weights").clone()
    with pytest.raises(ValueError, match=missing + ": missing"):
        convert.load_params(scope, arrays, fluid.CPUPlace(), program=main)
    assert torch.equal(scope.get("res2a_branch2a_weights"), before)
    # optimizer state (the velocities, the learning rate) is not asked for
    names = convert.load_params(scope, {**arrays, missing: np.zeros(
        64, np.float32)}, fluid.CPUPlace(), program=main)
    assert missing in names and not any("velocity" in n for n in names)
