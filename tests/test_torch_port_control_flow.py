"""Fluid control flow through the PyTorch port, against the JAX package,
on the CPU: While, ConditionalBlock, Switch, StaticRNN, IfElse,
DynamicRNN, Print, the tensor arrays and rank tables, the eight
learning-rate schedulers, beam_search / beam_search_decode and the new
tensor and math ops.

Each program is built in both packages under one ``unique_name.guard()``
from the same seeded numpy feeds; the JAX startup program's values load
into the port's scope by name (``convert.load_params``), so both run
from one start.  Tolerances: values 1e-5 relative, ids, lengths and
counts exact, each scheduler's learning rate over 12 steps 1e-7
relative, training losses and grads 1e-5.
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import convert
from paddle_tpu_torch.fluid import executor as texecutor

RTOL = 1e-5
LR_RTOL = 1e-7
LR_STEPS = 12


def _build(pkg, build):
    fluid = pkg.fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        fetch = build(pkg)
    return main, startup, fetch


def _persistables(startup, scope):
    out = {}
    for op in startup.global_block().ops:
        for n in op.output_arg_names:
            v = startup.global_block().vars.get(n)
            if v is not None and v.persistable:
                out[n] = np.asarray(scope.get(n))
    return out


def run_both(build, feeds=({},), params=()):
    """``build(pkg)`` -> fetch vars, built and run in both packages from
    the JAX startup's values, one run a feed.  Returns ({"jax": [[numpy
    fetches] a run], "port": ...}, {"jax": {param: final}, "port": ...})
    for the names in ``params``."""
    jmain, jstart, jfetch = _build(jpaddle, build)
    tmain, tstart, tfetch = _build(tpaddle, build)
    jf, tf = jpaddle.fluid, tpaddle.fluid
    jscope, tscope = jf.Scope(), tf.Scope()
    jexe, texe = jf.Executor(jf.CPUPlace()), tf.Executor(tf.CPUPlace())
    jexe.run(jstart, scope=jscope)
    texe.run(tstart, scope=tscope)
    init = _persistables(jstart, jscope)
    if init:
        convert.load_params(tscope, init, tf.CPUPlace())
    outs = {"jax": [], "port": []}
    for feed in feeds:
        outs["jax"].append([np.asarray(v) for v in jexe.run(
            jmain, feed=feed, fetch_list=[v.name for v in jfetch],
            scope=jscope)])
        outs["port"].append([np.asarray(v) for v in texe.run(
            tmain, feed=feed, fetch_list=[v.name for v in tfetch],
            scope=tscope)])
    finals = {"jax": {p: np.asarray(jscope.get(p)) for p in params},
              "port": {p: tscope.get(p).numpy() for p in params}}
    return outs, finals


def _close(outs, rtol=RTOL, atol=0.0):
    for j_run, t_run in zip(outs["jax"], outs["port"]):
        for j, t in zip(j_run, t_run):
            if np.issubdtype(j.dtype, np.floating):
                np.testing.assert_allclose(t, j, rtol=rtol, atol=atol)
            else:
                np.testing.assert_array_equal(t.astype(np.int64),
                                              j.astype(np.int64))


# ---------------------------------------------------------------------------
# tests/test_control_flow.py, through both packages
# ---------------------------------------------------------------------------


def _while_sum(pkg):
    L = pkg.fluid.layers
    i = L.fill_constant([1], "int64", 0)
    limit = L.fill_constant([1], "int64", 10)
    acc = L.fill_constant([1], "float32", 0.0)
    cond = L.less_than(i, limit)
    w = L.While(cond)
    with w.block():
        L.assign(acc + L.cast(i, "float32"), output=acc)
        L.increment(i, value=1)
        L.less_than(i, limit, cond=cond)
    return [acc, i]


def test_while_loop_sum():
    outs, _ = run_both(_while_sum)
    _close(outs)
    assert float(outs["port"][0][0][0]) == sum(range(10))
    assert int(outs["port"][0][1][0]) == 10


def test_while_requires_condition_update():
    fluid = tpaddle.fluid
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        i = L.fill_constant([1], "int64", 0)
        limit = L.fill_constant([1], "int64", 10)
        cond = L.less_than(i, limit)
        w = L.While(cond)
        with pytest.raises(ValueError, match=cond.name):
            with w.block():
                L.increment(i, value=1)


def test_while_op_without_condition_carry_raises_by_name():
    """A while op whose attrs do not carry its condition (a hand-built
    or imported program) raises naming the var, not loop forever."""
    fluid = tpaddle.fluid
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        i = L.fill_constant([1], "int64", 0)
        limit = L.fill_constant([1], "int64", 3)
        cond = L.less_than(i, limit)
        sub = main._create_block()
        L.increment(i, value=1)
        main._rollback()
        main.global_block().append_op(
            "while", inputs={"Condition": [cond], "Carry": [i]},
            outputs={"Out": [i]},
            attrs={"sub_block": sub.idx, "carry_names": [i.name],
                   "extra_names": [], "extra_ng_names": [],
                   "cond_name": cond.name})
    exe = fluid.Executor(fluid.CPUPlace())
    with pytest.raises(ValueError, match=cond.name):
        exe.run(main, fetch_list=[i], scope=fluid.Scope())


def _lr_steps(make_lr):
    return run_both(lambda pkg: [make_lr(pkg.fluid.layers)],
                    feeds=[{}] * LR_STEPS)[0]


SCHEDULERS = {
    "piecewise_decay": lambda L: L.piecewise_decay(
        boundaries=[3, 6], values=[1.0, 0.5, 0.1]),
    "linear_lr_warmup": lambda L: L.linear_lr_warmup(
        0.1, warmup_steps=4, start_lr=0.0, end_lr=0.1),
    "linear_lr_warmup_over_polynomial": lambda L: L.linear_lr_warmup(
        L.polynomial_decay(0.1, 10, end_learning_rate=0.0, power=1.0),
        warmup_steps=4, start_lr=0.0, end_lr=0.1),
    "noam_decay": lambda L: L.noam_decay(64, 4),
    "exponential_decay": lambda L: L.exponential_decay(0.1, 3, 0.5,
                                                       staircase=True),
    "natural_exp_decay": lambda L: L.natural_exp_decay(0.1, 3, 0.5),
    "polynomial_decay_cycle": lambda L: L.polynomial_decay(
        0.1, 5, 0.001, power=2.0, cycle=True),
    "cosine_decay": lambda L: L.cosine_decay(0.1, 2, 5),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_lr_scheduler_matches_jax(name):
    """Each step's learning rate within 1e-7 relative, plus 1e-7 of the
    schedule's peak over the 12 steps: torch's float32 exp, cos and pow
    and XLA's may differ by one ulp (up to 1.2e-7 of the value), XLA
    divides by a constant as a multiply by its reciprocal (10 / 10 is
    1 + 1.5e-8 there), and 1 + cos cancels as cos nears -1 — so a value
    near zero is held to the schedule's scale, not its own."""
    outs = _lr_steps(SCHEDULERS[name])
    j = np.concatenate([r[0] for r in outs["jax"]])
    t = np.concatenate([r[0] for r in outs["port"]])
    assert t.dtype == np.float32 and t.shape == (LR_STEPS,)
    np.testing.assert_allclose(t, j, rtol=LR_RTOL,
                               atol=LR_RTOL * float(np.abs(j).max()))


def test_inverse_time_decay_closed_form():
    """The JAX package's inverse_time_decay divides a float by a
    Variable, which its Variable does not support (a TypeError); the
    port's schedule is held against the closed form instead."""
    fluid = tpaddle.fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        lr = fluid.layers.inverse_time_decay(0.1, 3, 0.5)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    got = [float(exe.run(main, fetch_list=[lr], scope=scope)[0][0])
           for _ in range(LR_STEPS)]
    # the program's float32 ops in order: step * (1/3) (scale), * 0.5
    # + 1 (scale), then 0.1 / that (elementwise_div)
    f = np.float32
    step = np.arange(1, LR_STEPS + 1, dtype=f)
    div = step * f(1.0 / 3.0)
    want = f(0.1) / (div * f(0.5) + f(1.0))
    np.testing.assert_allclose(got, want, rtol=LR_RTOL, atol=0)


def test_piecewise_and_warmup_values():
    outs = _lr_steps(SCHEDULERS["piecewise_decay"])
    np.testing.assert_allclose(
        np.concatenate([r[0] for r in outs["port"]])[:8],
        [1.0, 1.0, 0.5, 0.5, 0.5, 0.1, 0.1, 0.1], rtol=1e-6)
    outs = _lr_steps(SCHEDULERS["linear_lr_warmup"])
    np.testing.assert_allclose(
        np.concatenate([r[0] for r in outs["port"]])[:6],
        [0.025, 0.05, 0.075, 0.1, 0.1, 0.1], rtol=1e-6)


def _regression(pkg, lr_fn):
    fluid = pkg.fluid
    L = fluid.layers
    x = fluid.data("x", [-1, 4], False, dtype="float32")
    y = fluid.data("y", [-1, 1], False, dtype="float32")
    pred = L.fc(x, size=1, param_attr=fluid.ParamAttr(name="reg_w"),
                bias_attr=fluid.ParamAttr(name="reg_b"))
    loss = L.mean(L.square_error_cost(pred, y))
    lr = lr_fn(L)
    fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    return [lr, loss]


def test_exponential_decay_in_optimizer():
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.randn(2, 4).astype("float32"),
              "y": rng.randn(2, 1).astype("float32")} for _ in range(3)]
    outs, finals = run_both(
        lambda pkg: _regression(pkg, lambda L: L.exponential_decay(
            0.1, decay_steps=1, decay_rate=0.5)), feeds, params=["reg_w"])
    np.testing.assert_allclose(
        [float(r[0][0]) for r in outs["port"]], [0.05, 0.025, 0.0125],
        rtol=1e-6)
    _close(outs)
    np.testing.assert_allclose(finals["port"]["reg_w"],
                               finals["jax"]["reg_w"], rtol=RTOL)


def _static_rnn_net(pkg, T=5, B=3, H=4, train=False, second_out=False):
    fluid = pkg.fluid
    L = fluid.layers
    x = fluid.data("x", [T, B, H], False, dtype="float32")
    h0 = L.fill_constant([B, H], "float32", 0.0)
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        h_prev = rnn.memory(init=h0)
        proj = L.fc(x_t, size=H, bias_attr=False,
                    param_attr=fluid.ParamAttr(name="rnn_w"))
        h = L.tanh(proj + h_prev)
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
        if second_out:
            rnn.step_output(L.scale(h, scale=2.0))
    out = rnn()
    if second_out:
        out = out[0]  # the second output has no reader
    if not train:
        return [out]
    loss = L.mean(L.square(out))
    fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return [loss]


def test_static_rnn_forward_matches_numpy_and_jax():
    T, B, H = 5, 3, 4
    x_np = np.random.RandomState(0).randn(T, B, H).astype("float32")
    outs, finals = run_both(_static_rnn_net, [{"x": x_np}],
                            params=["rnn_w"])
    _close(outs)
    w = finals["port"]["rnn_w"]
    h = np.zeros((B, H), "float32")
    expect = []
    for t in range(T):
        h = np.tanh(x_np[t] @ w + h)
        expect.append(h)
    np.testing.assert_allclose(outs["port"][0][0], np.stack(expect),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("second_out", [False, True])
def test_static_rnn_trains_like_jax(second_out):
    """Per-step losses and the trained cell weight within 1e-5 of the
    JAX package's.  ``second_out``: a two-output static_rnn whose second
    output has no reader — its grad is a fill_zeros_like (the variadic
    zero-fill of append_backward, which raised NotImplementedError
    before)."""
    rng = np.random.RandomState(2)
    feeds = [{"x": rng.randn(4, 2, 3).astype("float32")}] * 10
    outs, finals = run_both(
        lambda pkg: _static_rnn_net(pkg, 4, 2, 3, train=True,
                                    second_out=second_out),
        feeds, params=["rnn_w"])
    _close(outs)
    losses = [float(r[0]) for r in outs["port"]]
    assert losses[-1] < losses[0] * 0.9, losses
    np.testing.assert_allclose(finals["port"]["rnn_w"],
                               finals["jax"]["rnn_w"], rtol=RTOL, atol=1e-7)


def test_variadic_grad_zero_fill_desc():
    main, _, _ = _build(tpaddle, lambda pkg: _static_rnn_net(
        pkg, 4, 2, 3, train=True, second_out=True))
    ops = main.global_block().ops
    (z,) = [op for op in ops if op.type == "fill_zeros_like"]
    (g,) = [op for op in ops if op.type == "static_rnn_grad"]
    zname = z.output("Out")[0]
    assert zname.endswith("@GRAD@ZERO")
    assert g.input("StackedOut@GRAD")[1] == zname
    assert ops.index(z) < ops.index(g)


def _cond_block_net(pkg):
    fluid = pkg.fluid
    L = fluid.layers
    x = fluid.data("x", [2, 4], False, dtype="float32")
    flag = fluid.data("flag", [1], False, dtype="bool")
    out = L.fill_constant([2, 1], "float32", 0.0)
    cb = L.ConditionalBlock([flag])
    with cb.block():
        y = L.fc(x, size=1, bias_attr=False,
                 param_attr=fluid.ParamAttr(name="w_cond"))
        L.assign(y, output=out)
    loss = L.mean(out)
    fluid.optimizer.SGD(learning_rate=1.0).minimize(loss)
    return [loss]


def test_conditional_block_grad_matches_jax():
    x = np.random.RandomState(3).randn(2, 4).astype("float32")
    feeds = [{"x": x, "flag": np.array([True])},
             {"x": x, "flag": np.array([False])},
             {"x": x, "flag": np.array([True])}]
    outs, finals = run_both(_cond_block_net, feeds, params=["w_cond"])
    _close(outs)
    np.testing.assert_allclose(finals["port"]["w_cond"],
                               finals["jax"]["w_cond"], rtol=RTOL)


def test_conditional_block_false_leaves_weight_unchanged():
    fluid = tpaddle.fluid
    main, startup, (loss,) = _build(tpaddle, _cond_block_net)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((2, 4), "float32"), "flag": np.array([True])}
    w0 = scope.get("w_cond").clone()
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    w1 = scope.get("w_cond").clone()
    assert not torch.equal(w0, w1)
    feed["flag"] = np.array([False])
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert torch.equal(scope.get("w_cond"), w1)


def test_switch_branch_sgd_leaves_param_bit_unchanged():
    """An sgd op inside a Switch case updates its parameter in place;
    with the case's predicate false the parameter (and every other
    carry) stays bit for bit as it was, and true updates it as JAX's."""

    def build(pkg):
        fluid = pkg.fluid
        L = fluid.layers
        flag = fluid.data("flag", [1], False, dtype="bool")
        grad = fluid.data("g", [3, 2], False, dtype="float32")
        w = L.create_parameter([3, 2], "float32", name="sw_w")
        lr = L.fill_constant([1], "float32", 0.25)
        with L.Switch() as switch:
            with switch.case(flag):
                w.block.program.current_block().append_op(
                    "sgd", inputs={"Param": [w], "Grad": [grad],
                                   "LearningRate": [lr]},
                    outputs={"ParamOut": [w]})
        return [L.scale(w, scale=1.0)]

    g = np.random.RandomState(4).randn(3, 2).astype("float32")
    feeds = [{"flag": np.array([f]), "g": g} for f in (False, True, False)]
    outs, finals = run_both(build, feeds, params=["sw_w"])
    _close(outs)
    # false, true, false: the last run's value is the true run's, bit
    # for bit
    p = outs["port"]
    np.testing.assert_array_equal(p[2][0].view(np.int32),
                                  p[1][0].view(np.int32))
    fluid = tpaddle.fluid
    main, startup, (out,) = _build(tpaddle, build)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    w0 = scope.get("sw_w").clone()
    exe.run(main, feed=feeds[0], fetch_list=[out], scope=scope)
    assert torch.equal(scope.get("sw_w"), w0)
    exe.run(main, feed=feeds[1], fetch_list=[out], scope=scope)
    w1 = scope.get("sw_w").clone()
    torch.testing.assert_close(w1, w0 - 0.25 * torch.from_numpy(g),
                               rtol=0, atol=0)
    exe.run(main, feed=feeds[2], fetch_list=[out], scope=scope)
    assert torch.equal(scope.get("sw_w"), w1)


# ---------------------------------------------------------------------------
# the executor's capture rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,eager", [("conditional_block", False),
                                        ("static_rnn", False),
                                        ("while", True), ("print", True)])
def test_plan_capture_rule(kind, eager):
    """Only while and print make a plan eager; a plan with
    conditional_block or static_rnn keeps fixed shapes and is captured
    as one CUDA graph on the card."""
    builds = {
        "conditional_block": lambda p: _cond_block_net(p),
        "static_rnn": lambda p: _static_rnn_net(p, train=True),
        "while": _while_sum,
        "print": lambda p: [p.fluid.layers.Print(
            p.fluid.data("px", [2], False, dtype="float32"))],
    }
    main, _, fetch = _build(tpaddle, builds[kind])
    feeds = [v.name for v in main.global_block().vars.values() if v.is_data]
    plan = texecutor._Plan(main, feeds, [v.name for v in fetch])
    assert plan.eager_only is eager
    assert plan.host_ops == ([kind] if eager else [])


def test_print_passes_through(capsys):
    fluid = tpaddle.fluid
    main, _, (out,) = _build(tpaddle, lambda p: [p.fluid.layers.Print(
        p.fluid.data("px", [2], False, dtype="float32"), message="px")])
    x = np.array([1.5, -2.0], "float32")
    (got,) = fluid.Executor(fluid.CPUPlace()).run(
        main, feed={"px": x}, fetch_list=[out], scope=fluid.Scope())
    np.testing.assert_array_equal(got, x)
    assert "px: [ 1.5 -2. ]" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# IfElse, DynamicRNN
# ---------------------------------------------------------------------------


def test_ifelse_matches_jax():
    def build(pkg):
        fluid = pkg.fluid
        L = fluid.layers
        x = fluid.data("x", [4, 3], False, dtype="float32")
        c = fluid.data("c", [4, 1], False, dtype="bool")
        ie = L.IfElse(c)
        with ie.true_block():
            ie.output(L.scale(ie.input(x), scale=2.0))
        with ie.false_block():
            ie.output(L.scale(ie.input(x), scale=-1.0, bias=1.0))
        return [ie()]

    rng = np.random.RandomState(5)
    outs, _ = run_both(build, [{"x": rng.randn(4, 3).astype("float32"),
                                "c": rng.rand(4, 1) > 0.5}])
    _close(outs)


def test_dynamic_rnn_matches_jax():
    def build(pkg):
        fluid = pkg.fluid
        L = fluid.layers
        x = fluid.data("x", [3, 5, 4], False, dtype="float32")
        ln = fluid.data("ln", [3], False, dtype="int64")
        h0 = L.fill_constant([3, 4], "float32", 0.0)
        drnn = L.DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(x, length=ln)
            h = drnn.memory(init=h0)
            nh = L.tanh(L.fc(x_t, size=4, param_attr=fluid.ParamAttr(
                name="drnn_w"), bias_attr=False) + h)
            drnn.update_memory(h, nh)
            drnn.output(nh)
        return [drnn()]

    rng = np.random.RandomState(6)
    outs, _ = run_both(build, [{"x": rng.randn(3, 5, 4).astype("float32"),
                                "ln": np.array([5, 2, 3], "int64")}])
    _close(outs)


# ---------------------------------------------------------------------------
# tensor arrays and rank tables (tests/test_tensor_array.py)
# ---------------------------------------------------------------------------


def test_array_write_read_in_while_loop():
    def build(pkg):
        L = pkg.fluid.layers
        x = L.data(name="x", shape=[3], dtype="float32")
        arr = L.create_array("float32", capacity=8)
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        arr = L.array_write(x, i, array=arr)
        n = L.fill_constant(shape=[1], dtype="int64", value=5)
        cond = L.less_than(i, n)
        w = L.While(cond)
        with w.block():
            prev = L.array_read(arr, i)
            i2 = L.increment(i, value=1, in_place=True)
            L.array_write(L.elementwise_add(prev, prev), i2, array=arr)
            L.less_than(i2, n, cond=cond)
        return [L.array_length(arr), L.array_read(arr, L.fill_constant(
            shape=[1], dtype="int64", value=5))]

    xb = np.random.RandomState(7).randn(2, 3).astype("float32")
    outs, _ = run_both(build, [{"x": xb}])
    _close(outs)
    assert int(outs["port"][0][0][0]) == 6
    np.testing.assert_allclose(outs["port"][0][1], xb * 32, rtol=1e-6)


def test_create_array_initialized_list_and_read():
    def build(pkg):
        L = pkg.fluid.layers
        a = L.data(name="a", shape=[2], dtype="float32")
        b = L.data(name="b", shape=[2], dtype="float32")
        arr = L.create_array("float32", initialized_list=[a, b])
        return [L.array_length(arr), L.array_read(arr, L.fill_constant(
            shape=[1], dtype="int64", value=1))]

    outs, _ = run_both(build, [{"a": np.array([[1, 2]], "float32"),
                                "b": np.array([[3, 4]], "float32")}])
    _close(outs)
    assert int(outs["port"][0][0][0]) == 2


def test_lod_rank_table_pipeline_roundtrip():
    def build(pkg):
        L = pkg.fluid.layers
        seq = L.data(name="seq", shape=[4, 2], dtype="float32")
        lens = L.data(name="lens", shape=[1], dtype="int64")
        table = L.lod_rank_table(seq, length=lens)
        arr = L.lod_tensor_to_array(seq, table)
        mem = L.data(name="mem", shape=[5], dtype="float32")
        i0 = L.fill_constant(shape=[1], dtype="int64", value=0)
        return [L.max_sequence_len(table), L.array_to_lod_tensor(arr, table),
                L.shrink_memory(mem, i0, table), L.array_length(arr)]

    sq = np.arange(24, dtype="float32").reshape(3, 4, 2)
    ls = np.array([2, 4, 3], dtype="int64")
    mm = np.random.RandomState(0).randn(3, 5).astype("float32")
    outs, _ = run_both(build, [{"seq": sq, "lens": ls, "mem": mm}])
    _close(outs)
    expect = sq.copy()
    for r, length in enumerate(ls):
        expect[r, length:] = 0
    np.testing.assert_array_equal(outs["port"][0][1], expect)
    assert int(outs["port"][0][0][0]) == 4


def test_split_merge_lod_tensor():
    def build(pkg):
        L = pkg.fluid.layers
        x = L.data(name="x", shape=[3], dtype="float32")
        mask = L.data(name="mask", shape=[1], dtype="bool")
        t, f = L.split_lod_tensor(x, mask)
        return [t, f, L.merge_lod_tensor(t, f, x, mask)]

    xv = np.arange(12, dtype="float32").reshape(4, 3)
    mv = np.array([[True], [False], [True], [False]])
    outs, _ = run_both(build, [{"x": xv, "mask": mv}])
    _close(outs)
    np.testing.assert_array_equal(outs["port"][0][2], xv)


def test_tensor_array_to_tensor_concat_and_stack():
    def build(pkg):
        L = pkg.fluid.layers
        a = L.data(name="a", shape=[2], dtype="float32")
        arr = L.create_array("float32", capacity=3)
        for idx in range(2):
            i = L.fill_constant(shape=[1], dtype="int64", value=idx)
            L.array_write(a if idx == 0 else L.scale(a, scale=2.0), i,
                          array=arr)
        cat, cat_idx = L.tensor_array_to_tensor(arr, axis=0)
        stk, _ = L.tensor_array_to_tensor(arr, axis=0, use_stack=True)
        return [cat, cat_idx, stk]

    outs, _ = run_both(build, [{"a": np.array([[1, 2]], "float32")}])
    _close(outs)
    assert outs["port"][0][2].shape == (3, 1, 2)


def test_array_write_past_capacity_clamps_length():
    """A write past the capacity lands on the last slot, a negative
    index counts from the end, and the length stops at the capacity, as
    lax's dynamic index ops do."""

    def build(pkg):
        L = pkg.fluid.layers
        x = L.data(name="x", shape=[2], dtype="float32")
        arr = L.create_array("float32", capacity=2)
        for idx in (0, 1, 2, -1):
            i = L.fill_constant(shape=[1], dtype="int64", value=idx)
            L.array_write(L.scale(x, scale=float(idx + 3)), i, array=arr)
        return [L.array_length(arr)] + [
            L.array_read(arr, L.fill_constant(shape=[1], dtype="int64",
                                              value=k)) for k in (0, 1, 7)]

    xv = np.array([[1, 1]], "float32")
    outs, _ = run_both(build, [{"x": xv}])
    _close(outs)
    length, first, last, past = outs["port"][0]
    assert int(length[0]) == 2
    np.testing.assert_array_equal(first, xv * 3)   # the 0 write
    np.testing.assert_array_equal(last, xv * 2)    # -1 counts from the end
    np.testing.assert_array_equal(past, last)      # a read past: slot 1


def _array_beam_decoder(pkg, beam=3, vocab=11, hidden=8, max_len=4,
                        end_id=10):
    """tests/test_tensor_array.py's decoder (reference
    test_machine_translation.py:87-158 on the dense beam)."""
    L = pkg.fluid.layers
    src = L.data(name="src", shape=[hidden], dtype="float32")
    init_ids = L.data(name="init_ids", shape=[beam], dtype="int64")
    init_scores = L.data(name="init_scores", shape=[beam], dtype="float32")
    init_state = L.tanh(L.fc(src, size=hidden, name="enc_proj"))
    counter = L.fill_constant(shape=[1], dtype="int64", value=0)
    array_len = L.fill_constant(shape=[1], dtype="int64", value=max_len)
    state_array = L.create_array("float32", capacity=max_len + 1)
    ids_array = L.create_array("int64", capacity=max_len + 1)
    scores_array = L.create_array("float32", capacity=max_len + 1)
    parents_array = L.create_array("int32", capacity=max_len + 1)
    L.array_write(init_state, counter, array=state_array)
    L.array_write(init_ids, counter, array=ids_array)
    L.array_write(init_scores, counter, array=scores_array)
    L.array_write(L.fill_constant_batch_size_like(
        input=init_ids, shape=[-1, beam], dtype="int32", value=0), counter,
        array=parents_array)
    cond = L.less_than(counter, array_len)
    w = L.While(cond)
    with w.block():
        pre_ids = L.array_read(ids_array, counter)
        pre_state = L.array_read(state_array, counter)
        pre_score = L.array_read(scores_array, counter)
        current_state = L.tanh(L.fc(pre_state, size=hidden,
                                    name="dec_cell"))
        logp = L.log(L.softmax(L.fc(current_state, size=vocab,
                                    name="dec_out")))
        scores3 = L.expand(L.unsqueeze(logp, axes=[1]),
                           expand_times=[1, beam, 1])
        sel_ids, sel_scores, parent = L.beam_search(
            pre_ids, pre_score, scores3, beam_size=beam, end_id=end_id)
        L.increment(counter, value=1, in_place=True)
        L.array_write(current_state, counter, array=state_array)
        L.array_write(sel_ids, counter, array=ids_array)
        L.array_write(sel_scores, counter, array=scores_array)
        L.array_write(parent, counter, array=parents_array)
        L.less_than(counter, array_len, cond=cond)
    ids_stacked, _ = L.tensor_array_to_tensor(ids_array, axis=0,
                                              use_stack=True)
    parents_stacked, _ = L.tensor_array_to_tensor(parents_array, axis=0,
                                                  use_stack=True)
    sentences = L.beam_search_decode(
        L.slice(ids_stacked, axes=[0], starts=[1], ends=[max_len + 1]),
        L.slice(parents_stacked, axes=[0], starts=[1], ends=[max_len + 1]),
        beam_size=beam, end_id=end_id)
    return [sentences, L.array_read(scores_array, array_len)]


def _decoder_feed(batch=2, beam=3, hidden=8, seed=7):
    rng = np.random.RandomState(seed)
    return {"src": rng.randn(batch, hidden).astype("float32"),
            "init_ids": np.ones((batch, beam), "int64"),
            "init_scores": np.zeros((batch, beam), "float32")}


def test_array_beam_decoder_matches_jax():
    outs, _ = run_both(_array_beam_decoder, [_decoder_feed()])
    _close(outs)
    sv, sc = outs["port"][0]
    assert sv.shape == (2, 3, 4)
    assert np.all(np.diff(sc, axis=1) <= 1e-6)


def test_array_beam_decoder_under_bf16_policy():
    fluid = tpaddle.fluid
    from paddle_tpu_torch.fluid.contrib import mixed_precision as mp

    main, startup, fetch = _build(tpaddle, _array_beam_decoder)
    mp.enable_bf16_policy(main)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    sv, sc = exe.run(main, feed=_decoder_feed(), fetch_list=fetch,
                     scope=scope)
    assert sv.shape == (2, 3, 4)
    assert np.all((sv >= 0) & (sv < 11))
    assert np.all(np.isfinite(sc.astype(np.float32)))


# ---------------------------------------------------------------------------
# beam_search, one_hot and the other new ops, op by op
# ---------------------------------------------------------------------------


def _lower_both(op_type, inputs, attrs):
    """The op's JAX lowering and the port's on the same numpy inputs."""
    import jax.numpy as jnp

    import paddle_tpu.ops  # noqa: F401
    from paddle_tpu.fluid import registry as jreg
    from paddle_tpu_torch.fluid import registry as treg

    def conv(v, f):
        if v is None:
            return None
        if isinstance(v, list):
            return [f(x) for x in v]
        return f(v)

    j = jreg.get_op(op_type).lower(
        jreg.LowerContext(step=0), *[conv(v, jnp.asarray) for v in inputs],
        attrs=attrs)
    t = treg.get_op(op_type).lower(
        treg.LowerContext("cpu"),
        *[conv(v, lambda a: torch.from_numpy(np.array(a))) for v in inputs],
        attrs=attrs)
    j = j if isinstance(j, tuple) else (j,)
    t = t if isinstance(t, tuple) else (t,)
    return j, t


def _assert_same(j, t, exact=False):
    for a, b in zip(j, t):
        if a is None:
            assert b is None
            continue
        if isinstance(a, (list, tuple)):
            _assert_same(a, b, exact)
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, (a.shape, b.shape)
        if exact or not np.issubdtype(a.dtype, np.floating):
            np.testing.assert_array_equal(b.astype(a.dtype), a)
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-7)


def test_beam_search_planted_ties_give_jax_ids_and_parents():
    """Ties by design: the -1e9 scores of the beams not alive at step 0,
    a finished beam's -1e30 candidates, and equal log-probs planted
    across beams and vocab.  The stable sort keeps the lower flat index
    first, as lax.top_k does."""
    b, k, v = 3, 4, 7
    rng = np.random.RandomState(8)
    scores = np.round(rng.randn(b, k, v), 1).astype("float32")
    scores[0] = scores[0, :1]           # every beam the same candidates
    scores[1, :, 2:5] = -0.5            # a plateau
    pre_scores = np.array([[0, -1e9, -1e9, -1e9],
                           [0.5, 0.5, -1.0, -1.0],
                           [-0.3, -0.3, -0.3, -0.3]], "float32")
    pre_ids = np.array([[1, 1, 1, 1], [2, 6, 3, 6], [6, 0, 6, 1]], "int64")
    j, t = _lower_both("beam_search", [pre_ids, pre_scores, scores],
                       {"beam_size": k, "end_id": 6})
    _assert_same(j, t, exact=True)


def test_beam_search_decode_matches_jax():
    rng = np.random.RandomState(9)
    ids = rng.randint(0, 9, (5, 2, 3)).astype("int64")
    parents = rng.randint(0, 3, (5, 2, 3)).astype("int32")
    j, t = _lower_both("beam_search_decode", [ids, parents], {})
    _assert_same(j, t, exact=True)
    j, t = _lower_both("beam_search_decode", [ids, None], {})
    _assert_same(j, t, exact=True)


@pytest.mark.parametrize("op_type,ids", [
    ("one_hot", np.array([[0], [3], [4], [-1]], "int64")),
    ("one_hot", np.array([[0, 5], [2, 1]], "int64")),
    ("one_hot_v2", np.array([[1], [7]], "int64"))])
def test_one_hot_out_of_range_gives_zero_row(op_type, ids):
    j, t = _lower_both(op_type, [ids], {"depth": 4})
    _assert_same(j, t, exact=True)
    flat = t[0].numpy().reshape(-1, 4)
    bad = (ids.reshape(-1) < 0) | (ids.reshape(-1) >= 4)
    assert np.all(flat[bad] == 0)


@pytest.mark.parametrize("op_type,inputs,attrs", [
    ("stack", [[np.float32([[1, 2]]), np.float32([[3, 4]])]], {"axis": 1}),
    ("unstack", [np.arange(6, dtype="float32").reshape(2, 3)], {"axis": 1}),
    ("increment", [np.array([3], "int64")], {"step": 2.0}),
    ("increment", [np.array([0.5], "float32")], {"step": 1.5}),
    ("fill_zeros_like", [np.ones((2, 3), "float32")], {}),
    ("pow", [np.float32([1.5, 4.0]), None], {"factor": -0.5}),
    ("floor", [np.float32([-1.5, 2.7])], {}),
    ("ceil", [np.float32([-1.5, 2.2])], {}),
    ("cos", [np.float32([0.3, 2.0])], {}),
    ("exp", [np.float32([0.3, -2.0])], {}),
    ("log", [np.float32([0.3, 2.0])], {}),
    ("logical_and", [np.array([True, False]), np.array([True, True])], {}),
    ("logical_or", [np.array([True, False]), np.array([False, False])], {}),
    ("logical_xor", [np.array([True, False]), np.array([True, True])], {}),
    ("logical_not", [np.array([True, False])], {}),
    ("where", [np.array([[True], [False]]), np.float32([[1, 2], [3, 4]]),
               np.float32([[5, 6], [7, 8]])], {}),
])
def test_new_ops_match_jax(op_type, inputs, attrs):
    j, t = _lower_both(op_type, inputs, attrs)
    _assert_same(j, t)


def test_stack_grad_matches_jax():
    """stack's grad is derived from its lowering; against jax.vjp."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu_torch.fluid import registry as treg

    rng = np.random.RandomState(10)
    xs = [rng.randn(2, 3).astype("float32") for _ in range(3)]
    dy = rng.randn(2, 3, 3).astype("float32")
    _, vjp = jax.vjp(lambda *a: jnp.stack(a, axis=1),
                     *[jnp.asarray(x) for x in xs])
    want = vjp(jnp.asarray(dy))
    got = treg.get_op("stack_grad").lower(
        treg.LowerContext("cpu"), [torch.from_numpy(x) for x in xs],
        torch.from_numpy(dy), attrs={"axis": 1})[0]
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=0)
