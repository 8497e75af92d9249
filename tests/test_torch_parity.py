"""Cross-framework numeric parity: our op lowerings vs torch (CPU) reference
implementations (the role CPU kernels play for CUDA in the reference's
OpTest: an independent implementation to cross-check against)."""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu import fluid


def _run(build, feeds):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        out = build()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    return np.asarray(exe.run(main, feed=feeds, fetch_list=[out.name])[0])


def _param_run(build_fn, set_params, feeds):
    mainp, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(mainp, startup):
        out = build_fn()
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        set_params(scope, mainp)
        res = exe.run(mainp, feed=feeds, fetch_list=[out.name])
    return np.asarray(res[0])


def test_conv2d_vs_torch():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 8, 8).astype("float32")
    w = rng.randn(4, 3, 3, 3).astype("float32") * 0.2

    def build():
        v = fluid.data("c2_x", [2, 3, 8, 8], False, dtype="float32")
        return fluid.layers.conv2d(v, 4, 3, stride=2, padding=1,
                                   bias_attr=False)

    def setp(scope, prog):
        scope.set(prog.all_parameters()[0].name, w)

    got = _param_run(build, setp, {"c2_x": x})
    want = torch.nn.functional.conv2d(
        torch.tensor(x), torch.tensor(w), stride=2, padding=1).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_conv3d_vs_torch():
    rng = np.random.RandomState(1)
    x = rng.randn(1, 2, 6, 6, 6).astype("float32")
    w = rng.randn(3, 2, 3, 3, 3).astype("float32") * 0.2

    def build():
        v = fluid.data("c3_x", [1, 2, 6, 6, 6], False, dtype="float32")
        return fluid.layers.conv3d(v, 3, 3, stride=1, padding=1,
                                   bias_attr=False)

    def setp(scope, prog):
        scope.set(prog.all_parameters()[0].name, w)

    got = _param_run(build, setp, {"c3_x": x})
    want = torch.nn.functional.conv3d(
        torch.tensor(x), torch.tensor(w), padding=1).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)


def test_conv2d_transpose_vs_torch():
    rng = np.random.RandomState(2)
    x = rng.randn(1, 3, 5, 5).astype("float32")
    w = rng.randn(3, 4, 3, 3).astype("float32") * 0.2  # (in, out, kh, kw)

    def build():
        v = fluid.data("ct_x", [1, 3, 5, 5], False, dtype="float32")
        return fluid.layers.conv2d_transpose(v, 4, filter_size=3, stride=2,
                                             padding=1, bias_attr=False)

    def setp(scope, prog):
        scope.set(prog.all_parameters()[0].name, w)

    got = _param_run(build, setp, {"ct_x": x})
    want = torch.nn.functional.conv_transpose2d(
        torch.tensor(x), torch.tensor(w), stride=2, padding=1).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)


def test_conv3d_transpose_vs_torch():
    rng = np.random.RandomState(3)
    x = rng.randn(1, 2, 4, 4, 4).astype("float32")
    w = rng.randn(2, 3, 2, 2, 2).astype("float32") * 0.3

    def build():
        v = fluid.data("ct3_x", [1, 2, 4, 4, 4], False, dtype="float32")
        return fluid.layers.conv3d_transpose(v, 3, filter_size=2, stride=2,
                                             bias_attr=False)

    def setp(scope, prog):
        scope.set(prog.all_parameters()[0].name, w)

    got = _param_run(build, setp, {"ct3_x": x})
    want = torch.nn.functional.conv_transpose3d(
        torch.tensor(x), torch.tensor(w), stride=2).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)


def test_grouped_conv2d_transpose_vs_torch():
    rng = np.random.RandomState(4)
    x = rng.randn(1, 4, 5, 5).astype("float32")
    w = rng.randn(4, 2, 3, 3).astype("float32") * 0.2  # groups=2 → out 4

    def build():
        v = fluid.data("gt_x", [1, 4, 5, 5], False, dtype="float32")
        return fluid.layers.conv2d_transpose(v, 4, filter_size=3, groups=2,
                                             bias_attr=False)

    def setp(scope, prog):
        scope.set(prog.all_parameters()[0].name, w)

    got = _param_run(build, setp, {"gt_x": x})
    want = torch.nn.functional.conv_transpose2d(
        torch.tensor(x), torch.tensor(w), groups=2).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)


def test_pool3d_vs_torch():
    rng = np.random.RandomState(5)
    x = rng.randn(1, 2, 6, 6, 6).astype("float32")

    def build():
        v = fluid.data("p3t_x", [1, 2, 6, 6, 6], False, dtype="float32")
        return fluid.layers.pool3d(v, 2, "max", 2)

    got = _run(build, {"p3t_x": x})
    want = torch.nn.functional.max_pool3d(torch.tensor(x), 2, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_lstm_vs_torch():
    """Single-layer unidirectional LSTM against torch.nn.LSTM with the same
    weights (gate order remapped: ours is c,i,f,o; torch is i,f,g,o)."""
    rng = np.random.RandomState(6)
    b, t, din, dh = 2, 5, 4, 3
    x = rng.randn(b, t, din).astype("float32")
    wx = rng.randn(din, 4 * dh).astype("float32") * 0.3   # [D, 4H] (c,i,f,o)
    wh = rng.randn(dh, 4 * dh).astype("float32") * 0.3

    def build():
        v = fluid.data("lt_x", [b, t, din], False, dtype="float32")
        proj = fluid.layers.matmul(
            v, fluid.layers.assign(wx))
        hidden = fluid.default_main_program().current_block().create_var(
            name="lt_h", dtype="float32")
        cell = fluid.default_main_program().current_block().create_var(
            name="lt_c", dtype="float32")
        fluid.default_main_program().current_block().append_op(
            "lstm", inputs={"Input": [proj],
                            "Weight": [fluid.layers.assign(wh)]},
            outputs={"Hidden": [hidden], "Cell": [cell]}, attrs={})
        return hidden

    got = _run(build, {"lt_x": x})

    lstm = torch.nn.LSTM(din, dh, batch_first=True, bias=False)
    # our gate blocks [c,i,f,o] → torch rows [i,f,g,o] (g = candidate = c)
    c_, i_, f_, o_ = np.split(wx, 4, axis=1)
    torch_wx = np.concatenate([i_, f_, c_, o_], axis=1).T  # [4H, D]
    c_, i_, f_, o_ = np.split(wh, 4, axis=1)
    torch_wh = np.concatenate([i_, f_, c_, o_], axis=1).T
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.tensor(torch_wx))
        lstm.weight_hh_l0.copy_(torch.tensor(torch_wh))
        want, _ = lstm(torch.tensor(x))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-4, atol=1e-5)


def test_gru_vs_torch_manual():
    """GRU against a hand-rolled torch-style reference step loop (torch's
    GRU uses a different reset-gate formulation than Paddle's; compare
    against the Paddle formulation computed in numpy instead)."""
    rng = np.random.RandomState(7)
    b, t, dh = 2, 4, 3
    x = rng.randn(b, t, 3 * dh).astype("float32")
    w = rng.randn(dh, 3 * dh).astype("float32") * 0.3

    def build():
        v = fluid.data("gt2_x", [b, t, 3 * dh], False, dtype="float32")
        hidden = fluid.default_main_program().current_block().create_var(
            name="gt2_h", dtype="float32")
        fluid.default_main_program().current_block().append_op(
            "gru", inputs={"Input": [v], "Weight": [fluid.layers.assign(w)]},
            outputs={"Hidden": [hidden]}, attrs={"origin_mode": True})
        return hidden

    got = _run(build, {"gt2_x": x})

    def sigmoid(a):
        return 1 / (1 + np.exp(-a))

    h = np.zeros((b, dh), "float32")
    want = np.zeros((b, t, dh), "float32")
    wu, wr = w[:, :dh], w[:, dh:2 * dh]
    wc = w[:, 2 * dh:]
    for step in range(t):
        xu, xr, xc = (x[:, step, :dh], x[:, step, dh:2 * dh],
                      x[:, step, 2 * dh:])
        u = sigmoid(xu + h @ wu)
        r = sigmoid(xr + h @ wr)
        c = np.tanh(xc + (r * h) @ wc)
        h = u * h + (1 - u) * c
        want[:, step] = h
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_layer_norm_vs_torch():
    rng = np.random.RandomState(8)
    x = rng.randn(3, 6).astype("float32")

    def build():
        v = fluid.data("ln_x", [3, 6], False, dtype="float32")
        return fluid.layers.layer_norm(v, scale=False, shift=False)

    got = _run(build, {"ln_x": x})
    want = torch.nn.functional.layer_norm(torch.tensor(x), (6,)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_log_softmax_ce_vs_torch():
    rng = np.random.RandomState(9)
    logits = rng.randn(5, 7).astype("float32")
    labels = rng.randint(0, 7, (5, 1)).astype("int64")

    def build():
        v = fluid.data("sc_x", [5, 7], False, dtype="float32")
        l = fluid.data("sc_y", [5, 1], False, dtype="int64")
        return fluid.layers.softmax_with_cross_entropy(v, l)

    got = _run(build, {"sc_x": logits, "sc_y": labels})
    want = torch.nn.functional.cross_entropy(
        torch.tensor(logits), torch.tensor(labels[:, 0]),
        reduction="none").numpy()[:, None]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
