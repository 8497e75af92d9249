"""The ops that weight decay and gradient clipping emit, in the PyTorch
port (paddle_tpu_torch/ops/math_ops.py, tensor_ops.py) against the JAX
package's lowerings, in tests/test_torch_port_ops.py's pattern: the same
seeded numpy inputs and attrs through both registries.

Covered: the elementwise binary family (sub, mul, div, max, min, pow,
mod, floordiv) with the Fluid ``axis`` broadcast and right-aligned,
their derived grads, ``sqrt``, ``squared_l2_norm``, ``clip`` with attr
bounds and with ``Min``/``Max`` tensors, ``clip_by_norm`` on both sides
of its bound, ``sign`` and the grads derived from them; and the bf16
forms the bf16 dtype policy runs (``squared_l2_norm`` and
``clip_by_norm`` of a bf16 gradient, ``elementwise_mul`` of a bf16
gradient by a [1] scale) against the JAX lowerings on bf16.

Tolerances: 0 for sign, mod and floordiv; 1e-6 for elementwise fp32
math; 1e-5 where a reduction sums in another order.
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.fluid import registry as jreg

import paddle_tpu_torch.ops  # noqa: F401  (registers the port's lowerings)
from paddle_tpu_torch.fluid import registry as treg

from test_torch_port_train_ops import _compare

r = np.random.RandomState(11)


def _f(*shape, scale=1.0, positive=False):
    a = r.randn(*shape) * scale
    return np.asarray(np.abs(a) + 0.5 if positive else a, np.float32)


_x, _y1, _y4 = _f(2, 3, 4), _f(3), _f(4)
_yp = _f(3, positive=True)
_xp = _f(2, 3, 4, positive=True)
_bound = np.array([0.3], np.float32)

# name: (op type, inputs, attrs, tolerance)
CASES = {
    "sub_axis1": ("elementwise_sub", [_x, _y1], {"axis": 1}, 1e-6),
    "mul_right": ("elementwise_mul", [_x, _y4], {"axis": -1}, 1e-6),
    "mul_scalar_scale": ("elementwise_mul", [_x, _f(1)], {"axis": -1},
                         1e-6),
    "div_axis1": ("elementwise_div", [_x, _yp], {"axis": 1}, 1e-6),
    "div_scalars": ("elementwise_div", [np.array([1.0], np.float32),
                                        np.array([3.0], np.float32)],
                    {"axis": -1}, 1e-6),
    "max_axis1": ("elementwise_max", [_x, _y1], {"axis": 1}, 1e-6),
    "min_right": ("elementwise_min", [_x, _y4], {"axis": -1}, 1e-6),
    "pow_axis1": ("elementwise_pow", [_xp, _f(3)], {"axis": 1}, 1e-6),
    "mod_axis1": ("elementwise_mod", [_x * 5, _yp], {"axis": 1}, 0),
    "mod_int": ("elementwise_mod", [np.array([-7, 7, -7, 7], np.int32),
                                    np.array([3, -3, -3, 3], np.int32)],
                {"axis": -1}, 0),
    "floordiv_axis1": ("elementwise_floordiv", [_x * 5, _yp], {"axis": 1},
                       0),
    "floordiv_int": ("elementwise_floordiv",
                     [np.array([-7, 7, -7, 7], np.int32),
                      np.array([2, -2, -2, 2], np.int32)], {"axis": -1}, 0),
    "sqrt": ("sqrt", [_xp], {}, 1e-6),
    "squared_l2_norm": ("squared_l2_norm", [_f(5, 7)], {}, 1e-5),
    "clip_attrs": ("clip", [_x, None, None], {"min": -0.5, "max": 0.4},
                   1e-6),
    "clip_global_norm_denominator": ("clip", [np.array([0.7], np.float32),
                                              None, None],
                                     {"min": 1.0, "max": 3.4e38}, 0),
    "clip_tensor_bounds": ("clip", [_x, -_bound, _bound], {}, 1e-6),
    "clip_tensor_min_attr_max": ("clip", [_x, -_bound, None],
                                 {"max": 0.2}, 1e-6),
    "clip_by_norm_clips": ("clip_by_norm", [_f(4, 5)], {"max_norm": 1.0},
                           1e-6),
    "clip_by_norm_passes": ("clip_by_norm", [_f(4, 5, scale=0.01)],
                            {"max_norm": 1.0}, 1e-6),
    "sign": ("sign", [np.array([-2.0, 0.0, 3.0, -0.0], np.float32)], {}, 0),
    # -- derived grads ---------------------------------------------------
    "sub_grad_axis1": ("elementwise_sub_grad", [_x, _y1, _f(2, 3, 4)],
                       {"axis": 1}, 1e-6),
    "mul_grad_right": ("elementwise_mul_grad", [_x, _y4, _f(2, 3, 4)],
                       {"axis": -1}, 1e-5),
    "mul_grad_scale": ("elementwise_mul_grad", [_x, _f(1), _f(2, 3, 4)],
                       {"axis": -1}, 1e-5),
    "div_grad_axis1": ("elementwise_div_grad", [_x, _yp, _f(2, 3, 4)],
                       {"axis": 1}, 1e-5),
    "max_grad": ("elementwise_max_grad", [_x, _y4, _f(2, 3, 4)],
                 {"axis": -1}, 1e-6),
    "min_grad_axis1": ("elementwise_min_grad", [_x, _y1, _f(2, 3, 4)],
                       {"axis": 1}, 1e-6),
    "pow_grad": ("elementwise_pow_grad", [_xp, _f(4), _f(2, 3, 4)],
                 {"axis": -1}, 1e-5),
    "sqrt_grad": ("sqrt_grad", [_xp, _f(2, 3, 4)], {}, 1e-6),
    "squared_l2_norm_grad": ("squared_l2_norm_grad", [_f(5, 7), _f(1)], {},
                             1e-6),
    "clip_grad": ("clip_grad", [_x, None, None, _f(2, 3, 4)],
                  {"min": -0.5, "max": 0.4}, 1e-6),
    "clip_grad_tensor_bounds": ("clip_grad", [_x, -_bound, _bound,
                                              _f(2, 3, 4)], {}, 1e-6),
    "clip_by_norm_grad": ("clip_by_norm_grad", [_f(4, 5), _f(4, 5)],
                          {"max_norm": 1.0}, 1e-5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_clip_family_lowering_matches_jax(case):
    op_type, inputs, attrs, tol = CASES[case]
    _compare(op_type, inputs, attrs, tol)


def test_sign_has_no_grad_and_the_family_registers_grads():
    assert not treg.has_op("sign_grad") and not jreg.has_op("sign_grad")
    for t in ("elementwise_sub", "elementwise_mul", "elementwise_div",
              "elementwise_max", "elementwise_min", "elementwise_pow",
              "elementwise_mod", "elementwise_floordiv", "sqrt",
              "squared_l2_norm", "clip", "clip_by_norm"):
        assert treg.has_op(t + "_grad") == jreg.has_op(t + "_grad"), t
        assert treg.get_op(t).input_slots == jreg.get_op(t).input_slots, t


def _bf16_pair(a):
    """``a`` rounded to bf16 in both frameworks (the same values)."""
    t = torch.from_numpy(a).bfloat16()
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


@pytest.mark.parametrize("op_type,attrs,scale_arg", [
    ("squared_l2_norm", {}, False),
    ("clip_by_norm", {"max_norm": 1.0}, False),
    ("elementwise_mul", {"axis": -1}, True),
])
def test_bf16_gradient_tail_matches_jax(op_type, attrs, scale_arg):
    """The clip ops as the bf16 policy runs them on a bf16 gradient: the
    squares rounded to bf16, summed in fp32 and rounded back (as
    ``jnp.sum`` upcasts), the result bf16; equal to the JAX lowering's
    bits or within one bf16 rounding of a sum taken in another order."""
    jx, tx = _bf16_pair(_f(64, 48))
    jin, tin = [jx], [tx]
    if scale_arg:
        js, ts = _bf16_pair(np.array([0.37], np.float32))
        jin.append(js)
        tin.append(ts)
    ctx = jreg.LowerContext(step=0)
    ctx.op_index = 0
    want = jreg.get_op(op_type).lower(ctx, *jin, attrs=dict(attrs))
    got = treg.get_op(op_type).lower(treg.LowerContext("cpu"), *tin,
                                     attrs=dict(attrs))
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=8e-3, atol=0)


def test_layer_wrappers_build_and_run_as_jax():
    """The layer functions of the family (``elementwise_*`` with an
    ``axis``, ``sqrt``, ``sign``, ``clip``, ``clip_by_norm``) append the
    JAX package's ops and give its values."""
    from paddle_tpu import fluid as jfluid
    from paddle_tpu_torch import fluid as tfluid

    from test_torch_port_clip_regularizer import op_list

    feed = {"x": _xp, "y": _yp}
    got = {}
    for k, fl in (("jax", jfluid), ("torch", tfluid)):
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup), fl.unique_name.guard():
            x = fl.layers.data("x", [2, 3, 4], False, dtype="float32")
            y = fl.layers.data("y", [3], False, dtype="float32")
            L = fl.layers
            outs = [getattr(L, "elementwise_" + op)(x, y, axis=1)
                    for op in ("add", "sub", "mul", "div", "max", "min",
                               "pow", "mod", "floordiv")]
            outs += [L.sqrt(x), L.sign(L.elementwise_sub(x, y, axis=1)),
                     L.clip(x, 0.6, 1.2), L.clip_by_norm(x, 2.0)]
        scope = fl.Scope()
        with fl.scope_guard(scope):
            vals = fl.Executor(fl.CPUPlace()).run(
                main, feed=feed, fetch_list=outs, scope=scope)
        got[k] = (op_list(main), [np.asarray(v) for v in vals])
    assert got["torch"][0] == got["jax"][0]
    for i, (g, w) in enumerate(zip(got["torch"][1], got["jax"][1])):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                   err_msg=str(i))
