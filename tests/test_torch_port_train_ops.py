"""The training slice's op lowerings and grad ops of the PyTorch port
against the JAX package's: the same seeded numpy inputs and attrs
through both registries (``get_op(t).lower``), outputs compared by
value (the JAX side runs with x64 off, so its int64s arrive as int32).

Covered: the forward ops BERT pretraining adds (softmax, tanh, scale,
sum, mean, softmax_with_cross_entropy, slice, top_k, accuracy, dropout
in test mode, flash_attention, fill_any_like), every grad op the
BERT-tiny training program runs (the hand-written mul_grad and
matmul_grad, the derived ones, dropout_grad and
fused_bias_act_dropout_grad with an injected mask), adam, and the bf16
dtype policy's casts.

Tolerances: 0 for data movement and integer ops; 1e-6 for elementwise
fp32 math; 1e-5 where a reduction or matmul sums in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.fluid import executor as jexe
from paddle_tpu.fluid import registry as jreg

import paddle_tpu_torch.ops  # noqa: F401  (registers the port's lowerings)
from paddle_tpu_torch.fluid import executor as texe
from paddle_tpu_torch.fluid import registry as treg


def _run_jax(op_type, inputs, attrs):
    ctx = jreg.LowerContext(step=0)
    ctx.op_index = 0
    vals = [None if a is None else
            [jnp.asarray(x) for x in a] if isinstance(a, list) else
            jnp.asarray(a) for a in inputs]
    out = jreg.get_op(op_type).lower(ctx, *vals, attrs=dict(attrs))
    return out if isinstance(out, tuple) else (out,)


def _run_port(op_type, inputs, attrs):
    ctx = treg.LowerContext("cpu")
    vals = [None if a is None else
            [torch.from_numpy(np.array(x)) for x in a] if isinstance(a, list)
            else torch.from_numpy(np.array(a)) for a in inputs]
    out = treg.get_op(op_type).lower(ctx, *vals, attrs=dict(attrs))
    return out if isinstance(out, tuple) else (out,)


def _compare(op_type, inputs, attrs, tol):
    got = _run_port(op_type, inputs, attrs)
    want = _run_jax(op_type, inputs, attrs)
    assert len(got) == len(want), op_type
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None or w is None:
            # an output one side leaves unset must be one the other
            # computes as zeros (a grad of a non-differentiated input)
            assert g is None and w is None or np.all(
                np.asarray((w if g is None else g)) == 0), (op_type, i)
            continue
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, (op_type, i, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                       err_msg=f"{op_type} output {i}")
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64))


r = np.random.RandomState(0)


def _f(*shape, scale=1.0):
    return np.asarray(r.randn(*shape) * scale, np.float32)


_labels = np.array([[3], [0], [-100], [9], [5]], np.int64)
_q = _f(2, 2, 12, 8)
_fb_x, _fb_b = _f(3, 4, 16, scale=2), _f(16)
_mask = (r.rand(3, 4, 16) > 0.3).astype(np.uint8)
_ln_x, _ln_s, _ln_b = _f(2, 3, 16), _f(16) + 1, _f(16)

# name: (op type, inputs, attrs, tolerance)
CASES = {
    # -- forward ops ----------------------------------------------------
    "softmax": ("softmax", [_f(3, 20, scale=3)], {"axis": -1}, 1e-6),
    "tanh": ("tanh", [_f(4, 7, scale=2)], {}, 1e-6),
    "scale_bias_before": ("scale", [_f(3, 5), None],
                          {"scale": 10000.0, "bias": -1.0,
                           "bias_after_scale": False}, 1e-6),
    "scale_bias_after": ("scale", [_f(3, 5), None],
                         {"scale": 0.5, "bias": 2.0}, 1e-6),
    "sum": ("sum", [[_f(3, 4), _f(3, 4), _f(3, 4)]], {}, 1e-6),
    "mean": ("mean", [_f(5, 1)], {}, 1e-6),
    "fill_any_like": ("fill_any_like", [_f(4, 1)], {"value": 1.0}, 0),
    "softmax_with_cross_entropy": (
        "softmax_with_cross_entropy", [_f(5, 10, scale=2), _labels],
        {"soft_label": False, "ignore_index": -100, "axis": -1}, 1e-6),
    "slice": ("slice", [_f(2, 6, 4)],
              {"axes": [1], "starts": [0], "ends": [1],
               "decrease_axis": []}, 0),
    "slice_negative": ("slice", [_f(2, 6, 4)],
                       {"axes": [1, 2], "starts": [-3, 1], "ends": [100, -1],
                        "decrease_axis": []}, 0),
    "top_k": ("top_k", [_f(6, 2), None], {"k": 1}, 0),
    "accuracy": ("accuracy", [_f(6, 1), np.array([[1], [0], [1], [1], [0],
                                                  [0]], np.int64),
                              np.array([[1], [1], [1], [0], [0], [0]],
                                       np.int64)], {}, 0),
    "dropout_test_upscale": ("dropout", [_f(4, 5)],
                             {"dropout_prob": 0.3, "is_test": True,
                              "dropout_implementation": "upscale_in_train"},
                             0),
    "dropout_test_downgrade": ("dropout", [_f(4, 5)],
                               {"dropout_prob": 0.3, "is_test": True}, 1e-6),
    "flash_attention": ("flash_attention", [_q, _f(2, 2, 12, 8),
                                            _f(2, 2, 12, 8),
                                            np.where(r.rand(2, 1, 1, 12) > .8,
                                                     -1e4, 0).astype(
                                                np.float32)],
                        {"causal": False, "sm_scale": 8 ** -0.5}, 1e-5),
    "adam": ("adam", [_f(4, 3), _f(4, 3), _f(4, 3, scale=.1),
                      np.abs(_f(4, 3, scale=.1)),
                      np.array([1e-3], np.float32),
                      np.array([0.9 ** 3], np.float32),
                      np.array([0.999 ** 3], np.float32)],
             {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}, 1e-6),
    # -- grad ops -------------------------------------------------------
    "mul_grad": ("mul_grad", [_f(2, 3, 8), _f(8, 5), _f(2, 3, 5)],
                 {"x_num_col_dims": 2, "y_num_col_dims": 1}, 1e-5),
    "mul_grad_flatten": ("mul_grad", [_f(4, 2, 3), _f(6, 5), _f(4, 5)],
                         {"x_num_col_dims": 1, "y_num_col_dims": 1}, 1e-5),
    "matmul_grad_transpose_y": ("matmul_grad", [_f(3, 8), _f(10, 8),
                                                _f(3, 10)],
                                {"transpose_X": False, "transpose_Y": True,
                                 "alpha": 1.0}, 1e-5),
    "matmul_grad_transpose_x_alpha": ("matmul_grad", [_f(8, 3), _f(8, 4),
                                                      _f(3, 4)],
                                      {"transpose_X": True,
                                       "transpose_Y": False,
                                       "alpha": 0.125}, 1e-5),
    "matmul_grad_batched": ("matmul_grad", [_f(2, 3, 4, 8), _f(2, 3, 8, 5),
                                            _f(2, 3, 4, 5)],
                            {"transpose_X": False, "transpose_Y": False,
                             "alpha": 1.0}, 1e-5),
    "matmul_grad_broadcast": ("matmul_grad", [_f(2, 3, 4, 8), _f(8, 5),
                                              _f(2, 3, 4, 5)],
                              {"transpose_X": False, "transpose_Y": False,
                               "alpha": 1.0}, 1e-5),
    "elementwise_add_grad_same": ("elementwise_add_grad",
                                  [_f(3, 4), _f(3, 4), _f(3, 4)],
                                  {"axis": -1}, 1e-6),
    "elementwise_add_grad_bias": ("elementwise_add_grad",
                                  [_f(2, 3, 4), _f(4), _f(2, 3, 4)],
                                  {"axis": 2}, 1e-6),
    "elementwise_add_grad_axis1": ("elementwise_add_grad",
                                   [_f(2, 3, 4), _f(3), _f(2, 3, 4)],
                                   {"axis": 1}, 1e-6),
    "elementwise_add_grad_scalars": ("elementwise_add_grad",
                                     [_f(), _f(), _f()], {"axis": -1}, 1e-6),
    "layer_norm_grad": ("layer_norm_grad", [_ln_x, _ln_s, _ln_b,
                                            _f(2, 3, 16), None, None],
                        {"epsilon": 1e-5, "begin_norm_axis": 2}, 1e-5),
    "lookup_table_grad": ("lookup_table_grad",
                          [_f(10, 6), r.randint(0, 10, (3, 4)).astype(
                              np.int64), _f(3, 4, 6)],
                          {"padding_idx": -1}, 1e-6),
    # 2,048 ids over 2 rows (the token-type table's repeats): the port
    # sums exactly (ops/tensor_ops.py index_add_exact), the JAX package
    # in float32, whose rounding over a sum of ~1,000 unit rows is ~1e-5
    "lookup_table_grad_repeated": ("lookup_table_grad",
                                   [_f(2, 6), r.randint(0, 2, (64, 32))
                                    .astype(np.int64), _f(64, 32, 6)],
                                   {"padding_idx": -1}, 1e-4),
    "gather_grad": ("gather_grad", [_f(7, 5), np.array([[4], [1], [4]],
                                                        np.int64),
                                    _f(3, 5)], {}, 1e-6),
    "reshape2_grad": ("reshape2_grad", [_f(2, 3, 8), None, [], _f(6, 8),
                                        None], {"shape": [-1, 8]}, 0),
    "transpose2_grad": ("transpose2_grad", [_f(2, 3, 4, 5), _f(2, 4, 3, 5),
                                            None],
                        {"axis": [0, 2, 1, 3]}, 0),
    "slice_grad": ("slice_grad", [_f(2, 6, 4), _f(2, 1, 4)],
                   {"axes": [1], "starts": [0], "ends": [1],
                    "decrease_axis": []}, 0),
    "tanh_grad": ("tanh_grad", [_f(4, 7), _f(4, 7)], {}, 1e-6),
    "scale_grad": ("scale_grad", [_f(3, 5), None, _f(3, 5)],
                   {"scale": 10000.0, "bias": -1.0,
                    "bias_after_scale": False}, 1e-6),
    "mean_grad": ("mean_grad", [_f(5, 1), _f()], {}, 1e-6),
    "softmax_with_cross_entropy_grad": (
        "softmax_with_cross_entropy_grad",
        [_f(5, 10, scale=2), _labels, None, _f(5, 1)],
        {"soft_label": False, "ignore_index": -100, "axis": -1}, 1e-6),
    "flash_attention_grad": ("flash_attention_grad",
                             [_q, _f(2, 2, 12, 8), _f(2, 2, 12, 8),
                              np.where(r.rand(2, 1, 1, 12) > .8, -1e4,
                                       0).astype(np.float32),
                              _f(2, 2, 12, 8)],
                             {"causal": False, "sm_scale": 8 ** -0.5}, 1e-5),
    "flash_attention_grad_causal": ("flash_attention_grad",
                                    [_q, _f(2, 2, 12, 8), _f(2, 2, 12, 8),
                                     None, _f(2, 2, 12, 8)],
                                    {"causal": True}, 1e-5),
    "dropout_grad_injected_mask": ("dropout_grad", [_f(3, 4, 16), _mask],
                                   {"dropout_prob": 0.3,
                                    "dropout_implementation":
                                        "upscale_in_train"}, 1e-6),
    "dropout_grad_downgrade": ("dropout_grad", [_f(3, 4, 16), _mask],
                               {"dropout_prob": 0.3}, 1e-6),
    "fused_bias_act_dropout_grad_mask": (
        "fused_bias_act_dropout_grad", [_fb_x, _fb_b, _mask, _f(3, 4, 16)],
        {"act": "gelu", "approximate": False, "dropout_prob": 0.3,
         "dropout_implementation": "upscale_in_train"}, 1e-5),
    "fused_bias_act_dropout_grad_tanh": (
        "fused_bias_act_dropout_grad", [_fb_x, _fb_b, _mask, _f(3, 4, 16)],
        {"act": "gelu", "approximate": True, "dropout_prob": 0.3,
         "dropout_implementation": "upscale_in_train"}, 1e-5),
    "fused_bias_act_dropout_grad_p0": (
        "fused_bias_act_dropout_grad", [_fb_x, _fb_b, None, _f(3, 4, 16)],
        {"act": "gelu", "approximate": False, "dropout_prob": 0.0,
         "dropout_implementation": "upscale_in_train"}, 1e-5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_training_lowering_matches_jax(case):
    op_type, inputs, attrs, tol = CASES[case]
    _compare(op_type, inputs, attrs, tol)


def test_adam_updates_state_in_place():
    """The port's adam writes the parameter, moments and beta powers into
    the tensors it was given (the JAX package donates and replaces)."""
    ctx = treg.LowerContext("cpu")
    state = [torch.zeros(3), torch.ones(3), torch.zeros(3), torch.zeros(3),
             torch.tensor([0.1]), torch.tensor([0.9]), torch.tensor([0.999])]
    out = treg.get_op("adam").lower(ctx, *state, attrs={})
    for o, i in zip(out, (0, 2, 3, 5, 6)):
        assert o is state[i]
    assert np.allclose(state[0].numpy(), -0.1, atol=1e-4)
    with pytest.raises(TypeError, match="float32"):
        treg.get_op("adam").lower(ctx, state[0].bfloat16(), *state[1:],
                                  attrs={})


def test_dropout_train_mode_draws_and_replays_its_mask():
    """Train-mode dropout keeps about 1 - p of the values, scales them by
    1/(1 - p) (upscale_in_train), returns the uint8 mask it drew, and
    dropout_grad through that mask is the same linear map; the same seed
    draws the same mask."""
    x = torch.from_numpy(_f(200, 50))
    attrs = {"dropout_prob": 0.3, "is_test": False,
             "dropout_implementation": "upscale_in_train"}
    out, mask = treg.get_op("dropout").lower(treg.LowerContext("cpu", 7), x,
                                             attrs=attrs)
    assert mask.dtype == torch.uint8
    assert abs(mask.float().mean().item() - 0.7) < 0.02
    torch.testing.assert_close(out, x * mask / 0.7)
    g = torch.from_numpy(_f(200, 50))
    dx = treg.get_op("dropout_grad").lower(treg.LowerContext("cpu"), g, mask,
                                           attrs=attrs)
    torch.testing.assert_close(dx, g * mask / 0.7)
    _, again = treg.get_op("dropout").lower(treg.LowerContext("cpu", 7), x,
                                            attrs=attrs)
    assert torch.equal(mask, again)


@pytest.mark.parametrize("op_type,arg_dtypes,attrs", [
    ("mul", ["float32", "float32"], {}),
    ("layer_norm", ["float32", "float32", "float32"], {}),
    ("mean", ["float32"], {}),
    ("elementwise_add", ["float32", "float32"], {}),  # two scalars
    ("adam", ["float32", "bfloat16", "float32", "float32", "float32",
              "float32", "float32"], {"op_role": "optimize"}),
    ("softmax_with_cross_entropy", ["float32", "int64"], {}),
])
def test_bf16_policy_casts_like_jax(op_type, arg_dtypes, attrs):
    """The per-op casts of the bf16 dtype policy: compute in bf16, fp32
    for optimizer ops, loss ops and scalar tails, fp32 norm parameters."""
    from types import SimpleNamespace

    op = SimpleNamespace(type=op_type, attrs=attrs)
    scalar = op_type == "elementwise_add"
    shapes = [() if scalar else (4, 3)] * len(arg_dtypes)
    jv = [jnp.zeros(s, dtype=jnp.bfloat16 if d == "bfloat16" else d)
          for s, d in zip(shapes, arg_dtypes)]
    tv = [torch.zeros(s, dtype=getattr(torch, d))
          for s, d in zip(shapes, arg_dtypes)]
    want = [str(v.dtype) for v in jexe._apply_bf16_policy(op, jv)]
    # x64 is off on the JAX side: its int64 labels are int32
    got = [str(v.dtype).replace("torch.", "").replace("int64", "int32")
           for v in texe._apply_bf16_policy(op, tv)]
    assert got == want


def _two_seeded_dropouts(fluid_mod):
    """x [4, 64] through two dropout(seed=7) ops; returns the program and
    the two Mask var names."""
    main, startup = fluid_mod.Program(), fluid_mod.Program()
    with fluid_mod.program_guard(main, startup), \
            fluid_mod.unique_name.guard():
        x = fluid_mod.layers.data("x", [4, 64], False, dtype="float32")
        for _ in range(2):
            fluid_mod.layers.dropout(x, 0.5, seed=7)
    masks = [op.outputs["Mask"][0] for op in main.global_block().ops
             if op.type == "dropout"]
    return main, masks


def _masks_of_two_steps(fluid_mod, place):
    main, masks = _two_seeded_dropouts(fluid_mod)
    exe = fluid_mod.Executor(place)
    scope = fluid_mod.Scope()
    feed = {"x": np.ones((4, 64), np.float32)}
    return [np.asarray(m).astype(np.uint8) for _ in range(2)
            for m in exe.run(main, feed=feed, fetch_list=masks,
                             scope=scope)]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_seeded_random_op_streams_follow_step_and_op(pkg):
    """A random op with a nonzero seed draws from a stream keyed by the
    seed, its op index and the executor step (paddle_tpu/ops/common.py
    op_rng_key): two dropout(seed=7) ops over two steps draw four
    different masks, and a second executor from the same start draws
    the same four.  The JAX package's masks show the same properties
    (they cannot match the port's bit for bit)."""
    if pkg == "jax":
        from paddle_tpu import fluid as fl
    else:
        from paddle_tpu_torch import fluid as fl
    first = _masks_of_two_steps(fl, fl.CPUPlace())
    assert len(first) == 4
    for i in range(4):
        assert 0.3 < first[i].mean() < 0.7
        for j in range(i):
            assert not np.array_equal(first[i], first[j]), (i, j)
    again = _masks_of_two_steps(fl, fl.CPUPlace())
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
