"""The image models' op lowerings and grad ops of the PyTorch port
against the JAX package's: the same seeded numpy inputs and attrs
through both registries (``get_op(t).lower``), outputs compared by
value.

Covered: conv2d, depthwise_conv2d, conv3d and conv2d_transpose
(strides, dilations, groups, asymmetric pads) and their hand-written
grad ops against the JAX registry's ``jax.vjp``-derived ones; pool2d
(max and avg, exclusive, ceil_mode with and without padding, global and
adaptive) and its grad, a max-pool grad full of ties among them;
batch_norm (training and is_test, SavedVariance as the inverse std,
the running statistics written in place, the bf16 policy's fp32
islands) and batch_norm_grad against ``jax.vjp``; the other ops the
image models add (sigmoid, square, square_error_cost, concat, flatten2)
and the layers' parameter shapes, initializers and op switches.

Tolerances: fp32 forward within 1e-5 of the reference's largest
magnitude, grads within 1e-4 of it (sums in another order); data
movement exact.
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid import executor as jexe
from paddle_tpu.fluid import registry as jreg

import paddle_tpu_torch.ops  # noqa: F401  (registers the port's lowerings)
from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid import executor as texe
from paddle_tpu_torch.fluid import registry as treg

FWD_TOL, GRAD_TOL = 1e-5, 1e-4


def _f(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _run_jax(op_type, inputs, attrs, is_test=False):
    ctx = jreg.LowerContext(step=0, is_test=is_test)
    ctx.op_index = 0
    vals = [None if a is None else
            [jnp.asarray(x) for x in a] if isinstance(a, list) else
            jnp.asarray(a) for a in inputs]
    out = jreg.get_op(op_type).lower(ctx, *vals, attrs=dict(attrs))
    return _flat(out, lambda o: np.asarray(o.astype(jnp.float32)))


def _run_port(op_type, inputs, attrs, is_test=False):
    ctx = treg.LowerContext("cpu", is_test=is_test)
    vals = [None if a is None else
            [torch.from_numpy(np.array(x)) for x in a] if isinstance(a, list)
            else torch.from_numpy(np.array(a)) for a in inputs]
    out = treg.get_op(op_type).lower(ctx, *vals, attrs=dict(attrs))
    return _flat(out, lambda o: o.float().numpy())


def _flat(out, to_numpy):
    """An op's outputs as a flat list of numpy arrays (None kept): a
    variadic slot's list contributes each of its members."""
    flat = []
    for o in (out if isinstance(out, tuple) else (out,)):
        for m in (o if isinstance(o, (list, tuple)) else [o]):
            flat.append(None if m is None else to_numpy(m))
    return flat


def _close(got, want, tol, what):
    """Within ``tol`` of ``want``'s largest finite magnitude; a value of
    the reference that is not finite (a pool window wholly in the ceil
    padding: −inf for max, 0/0 for an exclusive average) must be the
    same in ``got``."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    odd = ~np.isfinite(want)
    np.testing.assert_array_equal(got[odd], want[odd], err_msg=what)
    got, want = got[~odd], want[~odd]
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * max(float(np.abs(want).max()), 1.0), (what, err)


def _compare(op_type, inputs, attrs, tol, is_test=False):
    got = _run_port(op_type, inputs, attrs, is_test)
    want = _run_jax(op_type, inputs, attrs, is_test)
    assert len(got) == len(want), op_type
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), (op_type, i)
        if g is not None:
            _close(g, w, tol, f"{op_type} output {i}")
    return got


def _grad_inputs(op_type, inputs, attrs, seed=9):
    """The forward inputs followed by a seeded cotangent of the output's
    shape (the forward's output taken from the JAX lowering)."""
    out = _run_jax(op_type, inputs, attrs)[0]
    return list(inputs) + [_f(*out.shape, seed=seed)]


# ---------------------------------------------------------------------------
# convolutions
# ---------------------------------------------------------------------------

CONV_CASES = {
    "conv2d_basic": ("conv2d", [_f(2, 3, 9, 9), _f(4, 3, 3, 3, seed=1),
                                None],
                     {"strides": [1, 1], "paddings": [1, 1],
                      "dilations": [1, 1], "groups": 1}),
    "conv2d_stride_dilation_groups": (
        "conv2d", [_f(2, 4, 11, 10), _f(6, 2, 3, 3, seed=1), None],
        {"strides": [2, 1], "paddings": [2, 1], "dilations": [2, 1],
         "groups": 2}),
    "conv2d_asymmetric_pads": (
        "conv2d", [_f(2, 3, 8, 9), _f(5, 3, 3, 2, seed=1), None],
        {"strides": [2, 2], "paddings": [0, 2, 1, 0], "dilations": [1, 1],
         "groups": 1}),
    "conv2d_bias": ("conv2d", [_f(1, 2, 6, 6), _f(3, 2, 1, 1, seed=1),
                               _f(3, seed=2)],
                    {"strides": [1, 1], "paddings": [0, 0],
                     "dilations": [1, 1], "groups": 1}),
    "conv2d_resnet_stem": ("conv2d", [_f(2, 3, 16, 16),
                                      _f(8, 3, 7, 7, seed=1), None],
                           {"strides": [2, 2], "paddings": [3, 3],
                            "dilations": [1, 1], "groups": 1}),
    "depthwise_conv2d": ("depthwise_conv2d",
                         [_f(2, 4, 8, 8), _f(4, 1, 3, 3, seed=1), None],
                         {"strides": [2, 2], "paddings": [1, 1],
                          "dilations": [1, 1], "groups": 1}),
    "depthwise_conv2d_multiplier": (
        "depthwise_conv2d", [_f(1, 3, 7, 7), _f(6, 1, 3, 3, seed=1), None],
        {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
         "groups": 3}),
    "conv3d": ("conv3d", [_f(1, 2, 5, 6, 5), _f(3, 2, 3, 3, 2, seed=1),
                          None],
               {"strides": [1, 2, 1], "paddings": [1, 1, 0],
                "dilations": [1, 1, 1], "groups": 1}),
    "conv3d_asymmetric_groups": (
        "conv3d", [_f(1, 4, 5, 5, 4), _f(4, 2, 2, 3, 3, seed=1), None],
        {"strides": [1, 1, 1], "paddings": [0, 1, 1, 0, 2, 1],
         "dilations": [1, 1, 1], "groups": 2}),
    "conv2d_transpose": ("conv2d_transpose",
                         [_f(2, 4, 5, 5), _f(4, 3, 3, 3, seed=1), None],
                         {"strides": [2, 2], "paddings": [1, 1],
                          "dilations": [1, 1], "groups": 1}),
    "conv2d_transpose_groups_dilation": (
        "conv2d_transpose", [_f(1, 4, 4, 6), _f(4, 3, 3, 2, seed=1),
                             _f(6, seed=2)],
        {"strides": [1, 2], "paddings": [0, 1], "dilations": [2, 1],
         "groups": 2}),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_matches_jax(case):
    op_type, inputs, attrs = CONV_CASES[case]
    _compare(op_type, inputs, attrs, FWD_TOL)


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_grad_matches_jax(case):
    """The hand-written grad op against the JAX registry's derived one
    (``jax.vjp`` through the forward)."""
    op_type, inputs, attrs = CONV_CASES[case]
    _compare(op_type + "_grad", _grad_inputs(op_type, inputs, attrs), attrs,
             GRAD_TOL)


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_grad_equals_derived_grad(case):
    """The hand-written grad against the registry's autograd derivation
    of the same forward lowering (which runs the forward again)."""
    op_type, inputs, attrs = CONV_CASES[case]
    args = [None if a is None else torch.from_numpy(a) for a in
            _grad_inputs(op_type, inputs, attrs)]
    hand = treg.get_op(op_type + "_grad")
    try:
        derived = treg._register_auto_grad(treg.get_op(op_type))
    finally:
        treg._OP_REGISTRY[op_type + "_grad"] = hand
    got = hand.lower(treg.LowerContext("cpu"), *args, attrs=dict(attrs))
    want = derived.lower(treg.LowerContext("cpu"), *args, attrs=dict(attrs))
    for h, a in zip(got, want):
        assert (h is None) == (a is None)
        if h is not None:
            _close(h.numpy(), a.numpy(), GRAD_TOL, op_type)


CONV_TYPES = ("conv2d", "depthwise_conv2d", "conv3d", "conv2d_transpose")


def test_conv_grad_runs_no_forward_conv(monkeypatch):
    """The conv grad op computes dX and dW by one convolution_backward
    and calls no forward convolution."""
    calls = []
    for name in ("conv2d", "conv3d", "conv_transpose2d"):
        real = getattr(torch.nn.functional, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(torch.nn.functional, name, spy)
    for op_type in CONV_TYPES:
        case = next(c for c in CONV_CASES.values() if c[0] == op_type)
        args = _grad_inputs(op_type, case[1], case[2])
        calls.clear()
        dx, dw, _ = _run_port(op_type + "_grad", args, case[2])
        assert dx is not None and dw is not None
        assert calls == [], (op_type, calls)


def test_conv_grad_computes_only_wanted_grads():
    """A grad op that names only Filter@GRAD (the first conv of a net,
    whose input is a feed) leaves Input@GRAD unset."""
    from types import SimpleNamespace

    op_type, inputs, attrs = CONV_CASES["conv2d_basic"]
    ctx = treg.LowerContext("cpu")
    ctx.cur_op = SimpleNamespace(type="conv2d_grad", outputs={
        "Filter@GRAD": ["w@GRAD"]})
    args = [None if a is None else torch.from_numpy(a)
            for a in _grad_inputs(op_type, inputs, attrs)]
    dx, dw, db = treg.get_op("conv2d_grad").lower(ctx, *args, attrs=attrs)
    assert dx is None and db is None and dw.shape == (4, 3, 3, 3)


def test_conv_bf16_stays_bf16_and_fp32_accumulates():
    """bf16 x bf16 runs natively and returns bf16; mixed inputs run in
    fp32 and return the input's dtype (the JAX package's
    mxu_conv_kwargs)."""
    op_type, inputs, attrs = CONV_CASES["conv2d_basic"]
    x, w = (torch.from_numpy(a) for a in inputs[:2])
    conv = treg.get_op("conv2d").lower
    ctx = treg.LowerContext("cpu")
    out = conv(ctx, x.bfloat16(), w.bfloat16(), None, attrs=attrs)
    assert out.dtype == torch.bfloat16
    want = _run_jax(op_type, [np.asarray(jnp.asarray(inputs[0],
                                                      jnp.bfloat16)),
                              np.asarray(jnp.asarray(inputs[1],
                                                     jnp.bfloat16)),
                              None], attrs)[0]
    # both round one fp32-accumulated sum to bf16: a bf16 ulp apart
    np.testing.assert_allclose(out.float().numpy(), want, rtol=1e-2,
                               atol=1e-2)
    mixed = conv(ctx, x, w.bfloat16(), None, attrs=attrs)
    assert mixed.dtype == torch.float32


# ---------------------------------------------------------------------------
# pool2d
# ---------------------------------------------------------------------------


def _pool(ptype, k, s, p, **kw):
    return dict({"pooling_type": ptype, "ksize": [k, k], "strides": [s, s],
                 "paddings": [p, p]}, **kw)


POOL_CASES = {
    "max_3x3_s2_p1": (_f(2, 3, 9, 9), _pool("max", 3, 2, 1)),
    "max_2x2": (_f(2, 3, 8, 8), _pool("max", 2, 2, 0)),
    "avg_2x2": (_f(2, 3, 8, 8), _pool("avg", 2, 2, 0)),
    "avg_exclusive_padded": (_f(2, 3, 7, 7), _pool("avg", 3, 2, 1)),
    "avg_not_exclusive_padded": (_f(2, 3, 7, 7),
                                 _pool("avg", 3, 2, 1, exclusive=False)),
    # ceil_mode with padding: the JAX lowering gives 4 rows at H 5, k 2,
    # s 2, p 1 (the library's ceil_mode drops the last window: 3)
    "max_ceil_padded_h5": (_f(1, 2, 5, 5), _pool("max", 2, 2, 1,
                                                ceil_mode=True)),
    "avg_ceil_padded_h5": (_f(1, 2, 5, 5), _pool("avg", 2, 2, 1,
                                                ceil_mode=True)),
    "max_ceil_googlenet": (_f(1, 2, 12, 11), _pool("max", 3, 2, 0,
                                                  ceil_mode=True)),
    # ceil_mode, no padding: divides by kh·kw, the ceil pad counted
    "avg_ceil_unpadded": (_f(1, 2, 6, 6), _pool("avg", 3, 2, 0,
                                               ceil_mode=True)),
    "avg_googlenet_aux": (_f(1, 2, 14, 14), _pool("avg", 5, 3, 0)),
    "global_avg": (_f(2, 4, 5, 6), _pool("avg", 1, 1, 0,
                                        global_pooling=True)),
    "global_max": (_f(2, 4, 5, 6), _pool("max", 1, 1, 0,
                                        global_pooling=True)),
    "adaptive_1x1_is_global": (_f(2, 4, 5, 6), _pool("avg", 1, 1, 0,
                                                    adaptive=True)),
    "adaptive_max_2x3": (_f(2, 4, 6, 6), dict(_pool("max", 1, 1, 0,
                                                    adaptive=True),
                                              ksize=[2, 3])),
    "adaptive_avg_3x2": (_f(2, 4, 6, 6), dict(_pool("avg", 1, 1, 0,
                                                    adaptive=True),
                                              ksize=[3, 2])),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool2d_matches_jax(case):
    x, attrs = POOL_CASES[case]
    _compare("pool2d", [x], attrs, FWD_TOL)


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool2d_grad_matches_jax(case):
    x, attrs = POOL_CASES[case]
    _compare("pool2d_grad", _grad_inputs("pool2d", [x], attrs), attrs,
             GRAD_TOL)


def test_pool2d_ceil_mode_keeps_the_jax_row_count():
    x, attrs = POOL_CASES["max_ceil_padded_h5"]
    (out,) = _run_port("pool2d", [x], attrs)
    assert out.shape == (1, 2, 4, 4)
    lib = torch.nn.functional.max_pool2d(torch.from_numpy(x), 2, 2, 1,
                                         ceil_mode=True)
    assert lib.shape[-1] == 3  # the library's ceil_mode: one row fewer


@pytest.mark.parametrize("ksize,stride,pad", [(3, 2, 1), (2, 2, 0),
                                              (3, 1, 1)])
def test_max_pool_grad_with_ties_lands_where_jax_puts_it(ksize, stride,
                                                         pad):
    """After a ReLU most windows hold only zeros: the grad of each
    window goes to the same element (the first maximum) as the JAX
    package's select-and-scatter with ``ge`` puts it."""
    x = np.maximum(_f(2, 3, 10, 10, seed=5), 0.0)
    x[:, :, :4, :] = 0.0  # whole windows of ties
    x[0, 0, 5, 5] = x[0, 0, 5, 6] = 2.0  # a tie between nonzero maxima
    attrs = _pool("max", ksize, stride, pad)
    args = _grad_inputs("pool2d", [x], attrs)
    got = _run_port("pool2d_grad", args, attrs)[0]
    want = _run_jax("pool2d_grad", args, attrs)[0]
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_adaptive_pool_needs_divisible_dims():
    x, attrs = POOL_CASES["adaptive_max_2x3"]
    with pytest.raises(ValueError, match="divisible"):
        _run_port("pool2d", [_f(1, 1, 5, 6)], attrs)


# ---------------------------------------------------------------------------
# batch_norm
# ---------------------------------------------------------------------------


def _bn_inputs(c=4, seed=0, shape=(3, 4, 5, 6)):
    return [_f(*shape, seed=seed, scale=2.0) + 1.5,
            _f(c, seed=seed + 1) + 1.0, _f(c, seed=seed + 2),
            _f(c, seed=seed + 3), np.abs(_f(c, seed=seed + 4)) + 0.5]


BN_ATTRS = {"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
            "data_layout": "NCHW"}


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_batch_norm_training_matches_jax(layout):
    shape = (3, 4, 5, 6) if layout == "NCHW" else (3, 5, 6, 4)
    inputs = _bn_inputs(shape=shape)
    attrs = dict(BN_ATTRS, data_layout=layout)
    y, mean_out, var_out, saved_mean, saved_var = _compare(
        "batch_norm", inputs, attrs, FWD_TOL)
    axes = tuple(i for i in range(4) if i != (1 if layout == "NCHW" else 3))
    x = inputs[0].astype(np.float64)
    bvar = x.var(axis=axes)  # biased
    np.testing.assert_allclose(saved_mean, x.mean(axis=axes), rtol=1e-5)
    # SavedVariance is the inverse standard deviation, not a variance
    np.testing.assert_allclose(saved_var, 1 / np.sqrt(bvar + 1e-5),
                               rtol=1e-4)
    np.testing.assert_allclose(var_out, 0.9 * inputs[4] + 0.1 * bvar,
                               rtol=1e-5)


def test_batch_norm_writes_running_statistics_in_place():
    inputs = [torch.tensor(a) for a in _bn_inputs()]
    mean, var = inputs[3], inputs[4]
    before = mean.clone()
    out = treg.get_op("batch_norm").lower(treg.LowerContext("cpu"),
                                          *inputs, attrs=dict(BN_ATTRS))
    assert out[1] is mean and out[2] is var
    assert not torch.equal(mean, before)
    assert treg.get_op("batch_norm").inplace == {"MeanOut": "Mean",
                                                 "VarianceOut": "Variance"}


@pytest.mark.parametrize("how", ["attr", "context"])
def test_batch_norm_is_test_uses_running_statistics(how):
    inputs = _bn_inputs()
    attrs = dict(BN_ATTRS, is_test=how == "attr")
    got = _compare("batch_norm", inputs, attrs, FWD_TOL,
                   is_test=how == "context")
    # the is_test form returns the running statistics unchanged
    np.testing.assert_array_equal(got[1], inputs[3])
    np.testing.assert_array_equal(got[4], inputs[4])
    x, s, b, m, v = (a.astype(np.float64) for a in inputs)
    rs = (1, -1, 1, 1)
    want = (x - m.reshape(rs)) / np.sqrt(v.reshape(rs) + 1e-5) \
        * s.reshape(rs) + b.reshape(rs)
    np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("is_test", [False, True])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_batch_norm_grad_matches_jax_vjp(is_test, layout):
    shape = (3, 4, 5, 6) if layout == "NCHW" else (3, 5, 6, 4)
    inputs = _bn_inputs(shape=shape, seed=3)
    attrs = dict(BN_ATTRS, is_test=is_test, data_layout=layout)
    dy = _f(*shape, seed=11)
    _compare("batch_norm_grad", inputs + [dy], attrs, GRAD_TOL)


def test_batch_norm_grad_maker_emits_one_grad_op():
    """The op list stays the JAX package's: batch_norm's grad is one
    batch_norm_grad with X, Scale, Bias, Mean, Variance and Y@GRAD."""
    progs = []
    for fl in (jfluid, fluid):
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup), fl.unique_name.guard():
            x = fl.data("x", [-1, 3, 4, 4], append_batch_size=False)
            y = fl.layers.batch_norm(fl.layers.conv2d(x, 4, 3), act="relu")
            fl.backward.append_backward(fl.layers.mean(y))
        progs.append([(op.type, sorted(op.inputs), sorted(op.outputs))
                      for op in main.global_block().ops])
    assert progs[1] == progs[0]
    bn = [o for o in progs[1] if o[0] == "batch_norm_grad"]
    assert bn == [("batch_norm_grad",
                   ["Bias", "Mean", "Scale", "Variance", "X", "Y@GRAD"],
                   ["Bias@GRAD", "Scale@GRAD", "X@GRAD"])]


def test_bf16_policy_keeps_batch_norm_statistics_fp32():
    """Under the bf16 policy batch_norm and its grad see bf16 X (and
    Y@GRAD) and fp32 Scale, Bias, Mean and Variance, as in the JAX
    executor (fluid/executor.py _BF16_KEEP_FP32_INPUTS)."""
    from types import SimpleNamespace

    for op_type, n in (("batch_norm", 5), ("batch_norm_grad", 6)):
        op = SimpleNamespace(type=op_type, attrs={})
        jv = [jnp.zeros((2, 3, 2, 2) if i in (0, 5) else (3,))
              for i in range(n)]
        tv = [torch.zeros((2, 3, 2, 2) if i in (0, 5) else (3,))
              for i in range(n)]
        want = [str(v.dtype) for v in jexe._apply_bf16_policy(op, jv)]
        got = [str(v.dtype).replace("torch.", "")
               for v in texe._apply_bf16_policy(op, tv)]
        assert got == want
        assert got[0] == "bfloat16" and set(got[1:5]) == {"float32"}


def test_batch_norm_bf16_input_keeps_fp32_statistics():
    inputs = _bn_inputs()
    args = [torch.tensor(inputs[0]).bfloat16()] + [
        torch.tensor(a) for a in inputs[1:]]
    y, mean, var, sm, sv = treg.get_op("batch_norm").lower(
        treg.LowerContext("cpu"), *args, attrs=dict(BN_ATTRS))
    assert y.dtype == torch.bfloat16
    assert {mean.dtype, var.dtype, sm.dtype, sv.dtype} == {torch.float32}
    want = _run_jax("batch_norm", [jnp.asarray(inputs[0], jnp.bfloat16)]
                    + inputs[1:], BN_ATTRS)
    np.testing.assert_allclose(y.float().numpy(), want[0], rtol=1e-2,
                               atol=1e-2)
    np.testing.assert_allclose(mean.numpy(), want[1], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the other ops the image models add
# ---------------------------------------------------------------------------

OTHER_CASES = {
    "sigmoid": ("sigmoid", [_f(4, 7, scale=3.0)], {}, 1e-6),
    "square": ("square", [_f(4, 7)], {}, 1e-6),
    "square_error_cost": ("square_error_cost", [_f(5, 1), _f(5, 1, seed=1)],
                          {}, 1e-6),
    "concat_axis1": ("concat", [[_f(2, 3, 4), _f(2, 5, 4, seed=1)], None],
                     {"axis": 1}, 0),
    "flatten2_axis1": ("flatten2", [_f(2, 3, 4, 5)], {"axis": 1}, 0),
    "flatten2_axis2": ("flatten2", [_f(2, 3, 4, 5)], {"axis": 2}, 0),
    "relu": ("relu", [_f(3, 8)], {}, 0),
}


@pytest.mark.parametrize("case", sorted(OTHER_CASES))
def test_other_op_matches_jax(case):
    op_type, inputs, attrs, tol = OTHER_CASES[case]
    _compare(op_type, inputs, attrs, tol)


@pytest.mark.parametrize("case", sorted(OTHER_CASES))
def test_other_op_grad_matches_jax(case):
    op_type, inputs, attrs, _ = OTHER_CASES[case]
    args = list(inputs) + [_f(*_run_jax(op_type, inputs, attrs)[0].shape,
                              seed=9)]
    if op_type == "flatten2":
        args.append(None)  # XShape@GRAD: no grad flows
    _compare(op_type + "_grad", args, attrs, GRAD_TOL)


# ---------------------------------------------------------------------------
# layers: parameters, initializers, op switches
# ---------------------------------------------------------------------------


def _layer_program(fl, build):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup), fl.unique_name.guard():
        build(fl)
    return main, startup


def _describe(main, startup):
    ops = [(op.type, {k: list(v) for k, v in op.inputs.items()},
            {k: list(v) for k, v in op.outputs.items()},
            sorted(k for k in op.attrs)) for op in main.global_block().ops]
    params = {p.name: tuple(p.shape) for p in main.all_parameters()}
    persist = sorted(n for n, v in main.global_block().vars.items()
                     if v.persistable)
    inits = [(op.type, op.outputs["Out"][0],
              {k: op.attrs[k] for k in ("mean", "std", "value")
               if k in op.attrs}) for op in startup.global_block().ops]
    return ops, params, persist, inits


LAYER_BUILDS = {
    "conv2d_bias_act": lambda fl: fl.layers.conv2d(
        fl.data("x", [-1, 3, 8, 8], append_batch_size=False), 6, 3,
        padding=1, act="relu"),
    "conv2d_depthwise_switch": lambda fl: fl.layers.conv2d(
        fl.data("x", [-1, 4, 8, 8], append_batch_size=False), 4, 3,
        groups=4, use_cudnn=False, bias_attr=False),
    "conv2d_grouped_keeps_conv2d": lambda fl: fl.layers.conv2d(
        fl.data("x", [-1, 4, 8, 8], append_batch_size=False), 4, 3,
        groups=4, bias_attr=False),
    "conv3d": lambda fl: fl.layers.conv3d(
        fl.data("x", [-1, 2, 4, 4, 4], append_batch_size=False), 3, 2),
    "conv2d_transpose": lambda fl: fl.layers.conv2d_transpose(
        fl.data("x", [-1, 4, 4, 4], append_batch_size=False), 6,
        filter_size=3, stride=2, groups=2),
    "pool2d": lambda fl: fl.layers.pool2d(
        fl.data("x", [-1, 4, 7, 7], append_batch_size=False), 3, "avg", 2,
        1, ceil_mode=True, exclusive=False),
    "adaptive_pool2d": lambda fl: fl.layers.adaptive_pool2d(
        fl.data("x", [-1, 4, 6, 6], append_batch_size=False), [2, 3]),
    "batch_norm_named": lambda fl: fl.layers.batch_norm(
        fl.data("x", [-1, 4, 3, 3], append_batch_size=False), act="relu",
        moving_mean_name="bn_m", moving_variance_name="bn_v"),
    "batch_norm_default_names": lambda fl: fl.layers.batch_norm(
        fl.data("x", [-1, 4, 3, 3], append_batch_size=False)),
    "square_error_cost": lambda fl: fl.layers.square_error_cost(
        fl.data("x", [-1, 1], append_batch_size=False),
        fl.data("y", [-1, 1], append_batch_size=False)),
    "flatten_concat_sigmoid": lambda fl: fl.layers.sigmoid(
        fl.layers.concat([fl.layers.flatten(fl.data(
            "x", [-1, 2, 3, 3], append_batch_size=False), axis=1),
            fl.data("y", [-1, 4], append_batch_size=False)], axis=1)),
    "variable_arithmetic": lambda fl: (lambda a, b: a + 0.3 * b + 1.0
                                       + b * a + 2 * a)(
        fl.data("x", [-1, 4], append_batch_size=False),
        fl.data("y", [-1, 4], append_batch_size=False)),
}


@pytest.mark.parametrize("case", sorted(LAYER_BUILDS))
def test_layer_builds_the_jax_program(case):
    """Op types, slots, attr names, parameter names and shapes,
    persistables and startup initializers (Normal(0, sqrt(2/fan_in))
    for conv filters, Constant(0)/(1) for BN's moving statistics)
    equal the JAX package's."""
    build = LAYER_BUILDS[case]
    want = _describe(*_layer_program(jfluid, build))
    got = _describe(*_layer_program(fluid, build))
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert len(got[3]) == len(want[3])
    for g, w in zip(got[3], want[3]):
        assert g[:2] == w[:2]
        assert g[2] == pytest.approx(w[2])


def test_nets_build_the_jax_programs():
    def build(fl):
        x = fl.data("x", [-1, 1, 12, 12], append_batch_size=False)
        y = fl.nets.simple_img_conv_pool(x, 4, 3, 2, 2, act="relu")
        fl.nets.img_conv_group(y, [4, 4], 2, conv_act="relu",
                               conv_with_batchnorm=[True, False],
                               conv_batchnorm_drop_rate=[0.3, 0.0],
                               pool_stride=2)

    want = _describe(*_layer_program(jfluid, build))
    got = _describe(*_layer_program(fluid, build))
    assert got[:3] == want[:3]


# ---------------------------------------------------------------------------
# aliases (compat_ops): sync_batch_norm and depthwise_conv2d_transpose
# ---------------------------------------------------------------------------

_DW_T_ATTRS = {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
               "groups": 4}
ALIAS_CASES = {
    "sync_batch_norm": ("batch_norm", _bn_inputs(seed=5), BN_ATTRS,
                        FWD_TOL),
    "sync_batch_norm_grad": (
        "batch_norm_grad", _bn_inputs(seed=6) + [_f(3, 4, 5, 6, seed=12)],
        BN_ATTRS, GRAD_TOL),
    "depthwise_conv2d_transpose": (
        "conv2d_transpose", [_f(2, 4, 5, 5), _f(4, 1, 3, 3, seed=1), None],
        _DW_T_ATTRS, FWD_TOL),
    "depthwise_conv2d_transpose_grad": (
        "conv2d_transpose_grad",
        [_f(2, 4, 5, 5), _f(4, 1, 3, 3, seed=1), None,
         _f(2, 4, 9, 9, seed=9)], _DW_T_ATTRS, GRAD_TOL),
}


@pytest.mark.parametrize("alias", sorted(ALIAS_CASES))
def test_alias_matches_jax_registry(alias):
    """Each alias registers the JAX package's slots and in-place
    outputs, takes its base op's grad kind, grad maker and optional
    slots, runs to the JAX registry's alias within the base op's
    tolerance, and is its own base op bit for bit."""
    base, inputs, attrs, tol = ALIAS_CASES[alias]
    got, want = treg.get_op(alias), jreg.get_op(alias)
    assert (list(got.input_slots), list(got.output_slots), got.inplace) \
        == (list(want.input_slots), list(want.output_slots), want.inplace)
    own = treg.get_op(base)
    assert (got.grad, got.grad_maker, got.optional, got.lower) == \
        (own.grad, own.grad_maker, own.optional, own.lower)
    outs = _compare(alias, inputs, attrs, tol)
    for o, b in zip(outs, _run_port(base, inputs, attrs)):
        assert (o is None) == (b is None)
        if o is not None:
            np.testing.assert_array_equal(o, b)
