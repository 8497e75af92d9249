"""``fluid.gradients`` and the lazy second-order grads of the PyTorch port
against the JAX package, on the CPU.

Each case builds one program with each package's own front end, checks
that both give the same op list, sets the same seeded parameters in both
scopes and runs it on the same feed:

- ``gradients()`` of a non-scalar target with a dynamic batch dim, with
  and without ``target_gradients``, and a second pass over the same
  program that returns its own grad vars (never the first pass's);
- the double-grad cases of tests/test_double_grad.py: mul + tanh, conv2d
  + sigmoid, and the elementwise and activation family (add, sub, mul,
  div, sigmoid, tanh, relu, exp, square, sqrt), each grad of a gradient
  norm with respect to the weights, whose ops (``mul_grad_grad``,
  ``conv2d_grad_grad``, ``tanh_grad_grad``, ...) the registry derives
  on first demand;
- three Adam steps of the WGAN-GP critic (test_double_grad.py's penalty).

Tolerances: 1e-5 relative and absolute for first and second-order grads
in fp32 (the same products summed in another order); 1e-5 relative on
the WGAN-GP losses and parameters after 3 steps.
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch.fluid import registry as treg

TOL = 1e-5


def _build(pkg, body):
    fl = pkg.fluid
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup), fl.unique_name.guard():
        fetch = body(fl, fl.layers)
    return main, startup, fetch


def _run_both(body, feed, steps=1, seed=0):
    """Each package's program on the same parameters (drawn from
    ``seed``) and feed: [(port fetches, JAX fetches)] a step."""
    runs = []
    for pkg in (paddle_tpu_torch, paddle_tpu):
        main, startup, fetch = _build(pkg, body)
        runs.append((pkg, main, startup, fetch))
    ops = [[op.type for op in m.global_block().ops] for _, m, _, _ in runs]
    assert ops[0] == ops[1]
    rng = np.random.RandomState(seed)
    params = {p.name: (rng.randn(*p.shape) * 0.5).astype(np.float32)
              for p in runs[1][1].all_parameters()}
    out = []
    for pkg, main, startup, fetch in runs:
        fl = pkg.fluid
        exe, scope = fl.Executor(fl.CPUPlace()), fl.Scope()
        exe.run(startup, scope=scope)
        for n, a in params.items():
            scope.set(n, torch.from_numpy(a.copy())
                      if pkg is paddle_tpu_torch else a.copy())
        out.append([[np.asarray(v, np.float64) for v in
                     exe.run(main, feed=feed, fetch_list=fetch,
                             scope=scope)] for _ in range(steps)])
    return list(zip(*out)), runs


def _assert_close(pairs, tol=TOL):
    for got, want in pairs:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def _mlp(fl, L, x):
    return L.fc(L.fc(x, size=5, act="tanh"), size=2)


def test_gradients_with_and_without_target_gradients():
    def body(fl, L):
        x = L.data(name="x", shape=[4], dtype="float32")
        x.stop_gradient = False
        tg = L.data(name="tg", shape=[2], dtype="float32")
        y = _mlp(fl, L, x)  # [-1, 2]: seeded with ones of its run shape
        (dx,) = fl.gradients(y, x)
        (dx_t,) = fl.gradients([y], [x], target_gradients=[tg])
        return [dx, dx_t]

    rng = np.random.RandomState(1)
    feed = {"x": rng.randn(3, 4).astype(np.float32),
            "tg": rng.randn(3, 2).astype(np.float32)}
    pairs, runs = _run_both(body, feed)
    _assert_close(pairs)
    got = pairs[0][0]
    assert not np.allclose(got[0], got[1])  # the seed was used


def test_second_gradients_pass_returns_its_own_vars():
    seen = {}

    def body(fl, L):
        x = L.data(name="x", shape=[4], dtype="float32")
        x.stop_gradient = False
        y = L.mean(_mlp(fl, L, x))
        (g1,) = fl.gradients(y, x)
        y2 = L.mean(L.square(_mlp(fl, L, x)))
        (g2,) = fl.gradients(y2, x)
        seen.setdefault("names", []).append((g1.name, g2.name))
        return [g1, g2]

    feed = {"x": np.random.RandomState(2).randn(3, 4).astype(np.float32)}
    pairs, _ = _run_both(body, feed)
    _assert_close(pairs)
    (p1, p2), (j1, j2) = seen["names"]
    assert (p1, p2) == (j1, j2) and p1 != p2
    assert not np.allclose(pairs[0][0][0], pairs[0][0][1])


def _double(inner):
    """z = mean((d inner(x, W) / dx)²); fetch z and dz/dW."""
    def body(fl, L):
        x = L.data(name="x", shape=inner.shape, dtype="float32")
        x.stop_gradient = False
        y, w = inner(fl, L, x)
        (dx,) = fl.gradients(y, x)
        z = L.mean(L.square(dx))
        (dw,) = fl.gradients(z, w)
        return [z, dw]
    return body


def _mul_tanh(fl, L, x):
    w = L.create_parameter([4, 2], "float32", name="W")
    return L.mean(L.tanh(L.mul(x, w))), w


_mul_tanh.shape = [4]


def _conv_sigmoid(fl, L, x):
    w = L.create_parameter([2, 1, 3, 3], "float32", name="Wc")
    blk = fl.default_main_program().current_block()
    conv = blk.create_var(name="convy", shape=None, dtype="float32")
    blk.append_op("conv2d", inputs={"Input": [x], "Filter": [w]},
                  outputs={"Output": [conv]},
                  attrs={"strides": [1, 1], "paddings": [1, 1],
                         "dilations": [1, 1], "groups": 1})
    return L.mean(L.sigmoid(conv)), w


_conv_sigmoid.shape = [1, 5, 5]


def _elementwise_family(fl, L, x):
    w = L.create_parameter([4, 3], "float32", name="We")
    h = L.mul(x, w)
    num = L.elementwise_mul(L.sigmoid(h), L.tanh(h))
    den = L.elementwise_add(L.exp(L.scale(h, scale=0.1)),
                            L.square(L.relu(h)))
    root = L.sqrt(L.elementwise_add(L.square(h), L.ones_like(h)))
    return L.mean(L.elementwise_sub(L.elementwise_div(num, den), root)), w


_elementwise_family.shape = [4]


@pytest.mark.parametrize("inner", [_mul_tanh, _conv_sigmoid,
                                   _elementwise_family],
                         ids=["mul_tanh", "conv2d", "elementwise"])
def test_double_grad_matches_jax(inner):
    rng = np.random.RandomState(3)
    feed = {"x": rng.randn(3, *inner.shape).astype(np.float32)}
    pairs, runs = _run_both(_double(inner), feed)
    _assert_close(pairs)
    types = {op.type for op in runs[0][1].global_block().ops}
    second = {t for t in types if t.endswith("_grad_grad")}
    assert second and all(treg.has_op(t) for t in second)


def test_wgan_gp_three_steps_match_jax():
    b, d = 8, 6

    def body(fl, L):
        real = L.data(name="real", shape=[d], dtype="float32")
        fake = L.data(name="fake", shape=[d], dtype="float32")
        alpha = L.data(name="alpha", shape=[1], dtype="float32")

        def critic(v):
            h = L.fc(v, size=16, act="relu", param_attr="c_w1",
                     bias_attr="c_b1")
            return L.fc(h, size=1, param_attr="c_w2", bias_attr="c_b2")

        inter = L.elementwise_add(
            L.elementwise_mul(real, alpha),
            L.elementwise_mul(fake, L.elementwise_sub(L.ones_like(alpha),
                                                      alpha)))
        inter.stop_gradient = False
        (grad_inter,) = fl.gradients(critic(inter), inter)
        norm = L.sqrt(L.reduce_sum(L.square(grad_inter), dim=1,
                                   keep_dim=False))
        gp = L.mean(L.square(norm - 1.0))
        loss = (L.mean(critic(fake)) - L.mean(critic(real)) + 10.0 * gp)
        fl.optimizer.Adam(learning_rate=1e-2).minimize(loss)
        return [loss, gp, "c_w1", "c_w2"]

    rng = np.random.RandomState(2)
    feed = {"real": rng.randn(b, d).astype(np.float32) + 2.0,
            "fake": rng.randn(b, d).astype(np.float32),
            "alpha": rng.uniform(size=(b, 1)).astype(np.float32)}
    pairs, _ = _run_both(body, feed, steps=3)
    _assert_close(pairs)
    losses = [p[0][0] for p in pairs]
    assert np.all(np.isfinite(losses)) and losses[0] != losses[-1]
