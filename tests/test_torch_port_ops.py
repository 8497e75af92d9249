"""Each op lowering of the PyTorch port (paddle_tpu_torch/ops) against the
JAX package's lowering of the same op: the same seeded numpy inputs and
attrs through both registries, outputs compared by value (the JAX side
runs with x64 off, so its int64s arrive as int32).

Tolerances: 0 for data movement and integer ops; 1e-6 for elementwise
fp32 math; 1e-5 where a reduction or matmul sums in another order.
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


def _rng(seed=0):
    return np.random.RandomState(seed)


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
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None), op_type
        if g is None:
            continue
        g = g.numpy()
        w = np.asarray(w)
        assert g.shape == w.shape, (op_type, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol)
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64))


r = _rng()
_x3 = r.randn(4, 1, 16).astype(np.float32)
_pages = r.randn(9, 4, 2, 8).astype(np.float32)

CASES = {
    "fill_constant": ([], {"shape": [3, 5], "dtype": "float32",
                           "value": 1.5}, 0),
    "fill_constant_int": ([], {"shape": [2], "dtype": "int64",
                               "value": 7}, 0),
    "cast_i64_i32": ([r.randint(0, 100, (4,)).astype(np.int64)],
                     {"out_dtype": "int32"}, 0),
    "cast_f32_i32": ([r.randn(6).astype(np.float32) * 10],
                     {"out_dtype": "int32"}, 0),
    "reshape2_copy_and_infer": ([r.randn(2, 3, 8).astype(np.float32), None,
                                 None], {"shape": [0, 0, 2, 4]}, 0),
    "reshape2_infer": ([r.randn(2, 3, 8).astype(np.float32), None, None],
                       {"shape": [-1, 8]}, 0),
    "transpose2": ([r.randn(2, 3, 4, 5).astype(np.float32)],
                   {"axis": [0, 2, 1, 3]}, 0),
    "lookup_table_trailing_1": ([r.randn(10, 6).astype(np.float32),
                                 r.randint(0, 10, (4, 1)).astype(np.int64)],
                                {"padding_idx": -1}, 0),
    "lookup_table_2d_ids": ([r.randn(10, 6).astype(np.float32),
                             r.randint(0, 10, (2, 3)).astype(np.int64)],
                            {"padding_idx": -1}, 0),
    "lookup_table_padding": ([r.randn(10, 6).astype(np.float32),
                              np.array([[1, 3, 3, 0]], np.int64)],
                             {"padding_idx": 3}, 0),
    "gather": ([r.randn(7, 5).astype(np.float32),
                np.array([4], np.int64)], {}, 0),
    "arg_max": ([r.randn(4, 11).astype(np.float32)], {"axis": -1}, 0),
    "elementwise_add_same": ([r.randn(3, 4).astype(np.float32),
                              r.randn(3, 4).astype(np.float32)],
                             {"axis": -1}, 1e-6),
    "elementwise_add_bias_axis2": ([r.randn(2, 3, 4).astype(np.float32),
                                    r.randn(4).astype(np.float32)],
                                   {"axis": 2}, 1e-6),
    "elementwise_add_axis1": ([r.randn(2, 3, 4).astype(np.float32),
                               r.randn(3).astype(np.float32)],
                              {"axis": 1}, 1e-6),
    "mul_num_col_dims_2": ([r.randn(2, 3, 8).astype(np.float32),
                            r.randn(8, 5).astype(np.float32)],
                           {"x_num_col_dims": 2, "y_num_col_dims": 1}, 1e-5),
    "mul_num_col_dims_1": ([r.randn(4, 2, 3).astype(np.float32),
                            r.randn(6, 5).astype(np.float32)],
                           {"x_num_col_dims": 1, "y_num_col_dims": 1}, 1e-5),
    "matmul_transpose_y": ([r.randn(3, 8).astype(np.float32),
                            r.randn(10, 8).astype(np.float32)],
                           {"transpose_X": False, "transpose_Y": True,
                            "alpha": 1.0}, 1e-5),
    "matmul_batched_alpha": ([r.randn(2, 3, 4, 8).astype(np.float32),
                              r.randn(2, 3, 8, 5).astype(np.float32)],
                             {"transpose_X": False, "transpose_Y": False,
                              "alpha": 0.125}, 1e-5),
    "log_softmax": ([r.randn(3, 50).astype(np.float32) * 4],
                    {"axis": -1}, 1e-5),
    "gelu_exact": ([r.randn(5, 7).astype(np.float32) * 3], {}, 1e-6),
    "gelu_tanh": ([r.randn(5, 7).astype(np.float32) * 3],
                  {"approximate": True}, 1e-6),
    "layer_norm": ([_x3, r.rand(16).astype(np.float32) + 0.5,
                    r.randn(16).astype(np.float32)],
                   {"epsilon": 1e-5, "begin_norm_axis": 2}, 1e-5),
    "fused_bias_act_dropout_p0": ([r.randn(3, 1, 16).astype(np.float32),
                                   r.randn(16).astype(np.float32)],
                                  {"act": "gelu", "approximate": False,
                                   "dropout_prob": 0.0,
                                   "dropout_implementation":
                                       "upscale_in_train"}, 1e-6),
    "kv_cache_write": ([_pages.copy(), r.randn(3, 2, 8).astype(np.float32),
                        np.array([2, 0, 5], np.int32),
                        np.array([1, 3, 0], np.int32)], {}, 0),
    "kv_cache_write_pages": ([_pages.copy(),
                              r.randn(8, 2, 8).astype(np.float32),
                              np.array([4, 7], np.int32)], {}, 0),
    "paged_attention_decode": ([r.randn(2, 2, 1, 8).astype(np.float32),
                                _pages, _pages[::-1].copy(),
                                np.array([[3, 1, 0], [5, 6, 2]], np.int32),
                                np.array([5, 11], np.int32)],
                               {"sm_scale": 8 ** -0.5}, 1e-5),
    "paged_attention_chunk": ([r.randn(1, 2, 4, 8).astype(np.float32),
                               _pages, _pages[::-1].copy(),
                               np.array([[3, 1, 8]], np.int32),
                               np.array([6], np.int32)],
                              {"sm_scale": 8 ** -0.5}, 1e-5),
}

_OP_OF = {k: k for k in CASES}
_OP_OF.update({
    "fill_constant_int": "fill_constant", "cast_i64_i32": "cast",
    "cast_f32_i32": "cast", "reshape2_copy_and_infer": "reshape2",
    "reshape2_infer": "reshape2", "lookup_table_trailing_1": "lookup_table",
    "lookup_table_2d_ids": "lookup_table",
    "lookup_table_padding": "lookup_table",
    "elementwise_add_same": "elementwise_add",
    "elementwise_add_bias_axis2": "elementwise_add",
    "elementwise_add_axis1": "elementwise_add",
    "mul_num_col_dims_2": "mul", "mul_num_col_dims_1": "mul",
    "matmul_transpose_y": "matmul", "matmul_batched_alpha": "matmul",
    "gelu_exact": "gelu", "gelu_tanh": "gelu",
    "fused_bias_act_dropout_p0": "fused_bias_act_dropout",
    "paged_attention_decode": "paged_attention",
    "paged_attention_chunk": "paged_attention",
})


@pytest.mark.parametrize("case", sorted(CASES))
def test_lowering_matches_jax(case):
    inputs, attrs, tol = CASES[case]
    _compare(_OP_OF[case], inputs, attrs, tol)


def test_kv_cache_write_updates_pool_in_place():
    """The port's writes update the scope's pool tensor itself (where
    the JAX package returns a new array and donates the old)."""
    pages = torch.zeros(4, 2, 1, 3)
    new = torch.ones(2, 1, 3)
    out = treg.get_op("kv_cache_write").lower(
        treg.LowerContext("cpu"), pages, new, torch.tensor([1, 0]),
        torch.tensor([1, 0]), attrs={})
    assert out is pages
    assert pages[1, 1].sum() == 3 and pages[0, 0].sum() == 3


def test_kv_cache_write_refuses_mixed_dtype():
    pages = torch.zeros(4, 2, 1, 3)
    with pytest.raises(ValueError, match="pool dtype"):
        treg.get_op("kv_cache_write").lower(
            treg.LowerContext("cpu"), pages,
            torch.ones(1, 1, 3, dtype=torch.float64), torch.tensor([1]),
            torch.tensor([0]), attrs={})


@pytest.mark.parametrize("op_type,attrs", [
    ("uniform_random", {"shape": [4000], "dtype": "float32", "min": -2.0,
                        "max": 3.0, "seed": 0}),
    ("gaussian_random", {"shape": [4000], "dtype": "float32", "mean": 1.0,
                         "std": 0.5, "seed": 0}),
])
def test_random_init_distribution_matches_jax(op_type, attrs):
    """Random streams differ between jax.random and torch.Generator, so
    the init ops are held to the same distribution (moments within
    5 standard errors at n = 4000) and to the same bounds, and the port
    must be reproducible from its seed."""
    got = _run_port(op_type, [], attrs)[0].numpy()
    want = np.asarray(_run_jax(op_type, [], attrs)[0])
    assert got.shape == want.shape and got.dtype == np.float32
    se = want.std() / np.sqrt(want.size)
    assert abs(got.mean() - want.mean()) < 5 * 1.4142 * se
    assert abs(got.std() - want.std()) < 0.05 * want.std()
    if op_type == "uniform_random":
        assert got.min() >= attrs["min"] and got.max() < attrs["max"]
    again = _run_port(op_type, [], attrs)[0].numpy()
    np.testing.assert_array_equal(got, again)


def test_shape_inference_matches_jax_program():
    """Build-time shape inference (meta tensors here, eval_shape there)
    gives every var of the decode-step program the same static shape."""
    from paddle_tpu import fluid as jfluid
    from paddle_tpu.models import gpt as jgpt

    from paddle_tpu_torch import fluid as tfluid
    from paddle_tpu_torch.models import gpt as tgpt

    shapes = []
    for fluid, gpt in ((jfluid, jgpt), (tfluid, tgpt)):
        cfg = gpt.GPTConfig.tiny(num_layers=1)
        main, start = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, start), fluid.unique_name.guard():
            gpt.build_gpt_decode_step(cfg, 3, 9, 4, 8)
        shapes.append({n: v.shape for n, v in main.global_block().vars.items()})
    assert shapes[0] == shapes[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("rows,n", [(2, 4096), (512, 4096), (3000, 700)],
                         ids=["2x4096", "512x4096", "3000x700"])
def test_index_add_exact_is_the_rounded_exact_sum(rows, n, dtype):
    """The lookup_table grad's index-add (ops/tensor_ops.py
    index_add_exact) gives each row's sum to within 2**-47 of its
    largest input, rounded to the output dtype — the float64 sum
    rounded, here — whatever the order of its inputs: a permutation
    gives the same bits."""
    from paddle_tpu_torch.ops.tensor_ops import index_add_exact

    g = torch.Generator().manual_seed(rows + n)
    idx = torch.randint(0, rows, (n,), generator=g)
    src = (torch.randn(n, 8, generator=g)
           * torch.rand(n, 1, generator=g) * 100).to(dtype)
    want = torch.zeros(rows, 8, dtype=torch.float64).index_add_(
        0, idx, src.double()).to(dtype)
    got = index_add_exact(rows, idx, src)
    assert got.dtype == dtype and torch.equal(got, want)
    perm = torch.randperm(n, generator=g)
    assert torch.equal(index_add_exact(rows, idx[perm], src[perm]), got)


def test_index_add_exact_non_finite_rows():
    """A row with an inf or a nan input reads nan; the other rows keep
    their sums."""
    from paddle_tpu_torch.ops.tensor_ops import index_add_exact

    idx = torch.tensor([0, 1, 2, 0, 1, 2])
    src = torch.ones(6, 3)
    src[3, 1], src[4, 0] = float("inf"), float("nan")
    got = index_add_exact(4, idx, src)
    assert torch.isnan(got[0]).all() and torch.isnan(got[1]).all()
    assert torch.equal(got[2], torch.full((3,), 2.0))
    assert torch.equal(got[3], torch.zeros(3))
