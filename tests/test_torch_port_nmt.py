"""Transformer NMT in the PyTorch port against the JAX package, on the
CPU.

Ops: every op the model adds, and each derived grad it runs, through
both registries (``get_op(t).lower``) on the same seeded numpy inputs,
compared by value (the JAX side runs with x64 off, so its int64s are
int32).  Tolerances, each stated with its case: 0 for integer, boolean
and data-movement ops; 1e-6 for fp32 elementwise math; 1e-5 for
reductions (the sums run in another order); one bf16 ulp of the JAX
value for a bf16 result (both round one fp32 value, computed in another
order).

Programs: at ``TransformerConfig.tiny()``, after the default graph
passes, the port's op lists and variable shapes equal the JAX
package's for the training program at dropout 0.1 (no flash site: the
attention dropout vetoes the rewrite) and 0.0 (4 sites: 2 encoder
self-attentions with the pad bias, 2 causal decoder ones) and for
``build_greedy_decode(max_out_len=4)`` (10 sites); ``Variable``'s
operators build the JAX package's ops.

Training: child processes (tests/torch_port_nmt_oracle.py, its three
routes at once, once a test run) train tiny with dropout 0 and Adam(1e-4) on a
padded ragged batch in the JAX package, by the flash route (the default
passes) and the composed one (FLAGS_graph_passes "none":
``softmax_mask_fuse_upper_triangle`` and the additive pad bias).  The
port loads its initial parameters through ``convert.load_params`` and
must give, by each route: 10 fp32 losses within 1e-4 relative and the
final parameters within 1e-5 absolute (the same fp32 math summed in
another order; an Adam step moves an element by up to lr = 1e-4), and
5 bf16-policy losses within 2e-2 relative (bf16 rounds at other places
in the two frameworks, and the loss's bf16 sums over the batch's 31
weighted targets resolve it to about 1/31).  At dropout 0.1 the port's
losses are finite and falling (two frameworks' generators cannot draw
the same masks).  ``build_greedy_decode``'s ids equal the JAX
package's with its weights copied across.
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import fcntl
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu import fluid as jfluid
from paddle_tpu import passes as jpasses
from paddle_tpu.fluid import registry as jreg
from paddle_tpu.models import transformer as jt

import paddle_tpu_torch.ops  # noqa: F401  (registers the port's lowerings)
from paddle_tpu_torch import convert, fluid, models, passes
from paddle_tpu_torch.fluid import registry as treg
from paddle_tpu_torch.fluid.contrib.mixed_precision import enable_bf16_policy
from paddle_tpu_torch.models import transformer as tt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_nmt_oracle as oracle_mod  # noqa: E402  (no jax import)

ORACLE = oracle_mod.__file__
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-5
BF16_LOSS_RTOL = 2e-2
ROUTES = ("flash", "composed")
BF16 = "bf16"  # one bf16 ulp of the JAX value


# ---------------------------------------------------------------------------
# ops against the JAX registry
# ---------------------------------------------------------------------------


class _B16:
    """An fp32 array handed to both registries as bfloat16."""

    def __init__(self, a):
        self.a = a


def _jax_in(a):
    if a is None:
        return None
    if isinstance(a, _B16):
        return jnp.asarray(a.a, jnp.bfloat16)
    return jnp.asarray(a)


def _port_in(a):
    if a is None:
        return None
    if isinstance(a, _B16):
        return torch.from_numpy(a.a).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _run(reg, ctx, to, op_type, inputs, attrs):
    out = reg.get_op(op_type).lower(ctx, *[to(a) for a in inputs],
                                    attrs=dict(attrs))
    return out if isinstance(out, tuple) else (out,)


def _jax_ctx():
    ctx = jreg.LowerContext(step=0)
    ctx.op_index = 0
    return ctx


def _as_np(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
    v = np.asarray(v)
    return v.astype(np.float32) if v.dtype.name == "bfloat16" else v


def _bf16_ulp(w):
    """The spacing of bfloat16 numbers (8 significant bits) at ``w``."""
    e = np.floor(np.log2(np.maximum(np.abs(w), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def _compare(op_type, inputs, attrs, tol):
    got = _run(treg, treg.LowerContext("cpu"), _port_in, op_type, inputs,
               attrs)
    want = _run(jreg, _jax_ctx(), _jax_in, op_type, inputs, attrs)
    assert len(got) == len(want), op_type
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None or w is None:
            # a grad one side leaves unset must be zeros on the other
            assert g is None and w is None or np.all(
                _as_np(w if g is None else g) == 0), (op_type, i)
            continue
        if isinstance(g, torch.Tensor) and isinstance(w, jnp.ndarray):
            assert (g.dtype == torch.bfloat16) == (w.dtype == jnp.bfloat16)
        g, w = _as_np(g), _as_np(w)
        assert g.shape == w.shape, (op_type, i, g.shape, w.shape)
        if tol == BF16:
            assert np.all(np.abs(g - w) <= _bf16_ulp(w)), (op_type, i)
        elif np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                       err_msg=f"{op_type} output {i}")
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64))


r = np.random.RandomState(0)


def _f(*shape, scale=1.0):
    return np.asarray(r.randn(*shape) * scale, np.float32)


_ids = r.randint(0, 3, (3, 7)).astype(np.int64)
_col = np.array([[0], [1], [2]], np.int64)
_x3 = _f(2, 3, 5)
_pe8, _pe7 = _f(2, 6, 8, scale=3), _f(2, 5, 7, scale=3)

# name: (op type, inputs, attrs, tolerance)
CASES = {
    # comparisons: int64 ids against a [B, 1] column (the pad bias's
    # broadcast), against the column placed by ``axis``, and floats
    "equal_int64_column": ("equal", [_ids, _col], {"axis": -1}, 0),
    "equal_int64_axis0": ("equal", [_ids, np.array([0, 1, 2], np.int64)],
                          {"axis": 0}, 0),
    "equal_float": ("equal", [np.array([[1., 2.], [3., 4.]], np.float32),
                              np.array([[1., 0.], [3., 4.]], np.float32)],
                    {}, 0),
    "not_equal_int64_column": ("not_equal", [_ids, _col], {}, 0),
    "less_than": ("less_than", [_f(3, 4), _f(4)], {}, 0),
    "less_equal_int64": ("less_equal", [_ids, _col], {}, 0),
    "greater_than": ("greater_than", [_f(3, 4), _f(3, 1)], {}, 0),
    "greater_equal_int64": ("greater_equal", [_ids, _col], {}, 0),
    # reductions (1e-5: the sums run in another order)
    "reduce_sum_dim": ("reduce_sum", [_x3], {"dim": [1]}, 1e-5),
    "reduce_sum_negative_dim_keep": ("reduce_sum", [_x3],
                                     {"dim": [-1], "keep_dim": True}, 1e-5),
    "reduce_sum_two_dims": ("reduce_sum", [_x3], {"dim": [0, -1]}, 1e-5),
    "reduce_sum_all": ("reduce_sum", [_x3],
                       {"dim": [0], "reduce_all": True}, 1e-5),
    "reduce_sum_all_keep": ("reduce_sum", [_x3],
                            {"dim": [0], "reduce_all": True,
                             "keep_dim": True}, 1e-5),
    "reduce_sum_column": ("reduce_sum", [_f(31, 1)],
                          {"dim": [0], "reduce_all": True}, 1e-5),
    "reduce_sum_bf16": ("reduce_sum", [_B16(_f(4, 33, scale=3))],
                        {"dim": [1]}, BF16),
    "reduce_sum_bf16_all": ("reduce_sum", [_B16(_f(31, 1, scale=3))],
                            {"dim": [0], "reduce_all": True}, BF16),
    "reduce_sum_int64": ("reduce_sum", [_ids], {"dim": [1]}, 0),
    "reduce_mean_dim": ("reduce_mean", [_x3], {"dim": [-2],
                                               "keep_dim": True}, 1e-5),
    "reduce_mean_all": ("reduce_mean", [_x3],
                        {"dim": [0], "reduce_all": True}, 1e-5),
    "reduce_max_dim": ("reduce_max", [_x3], {"dim": [2]}, 0),
    "reduce_min_all_keep": ("reduce_min", [_x3],
                            {"dim": [0], "reduce_all": True,
                             "keep_dim": True}, 0),
    "reduce_sum_grad": ("reduce_sum_grad", [_x3, _f(2, 5)], {"dim": [1]},
                        1e-6),
    "reduce_sum_grad_all_keep": ("reduce_sum_grad", [_x3, _f(1, 1, 1)],
                                 {"dim": [0], "reduce_all": True,
                                  "keep_dim": True}, 1e-6),
    "reduce_sum_grad_bf16": ("reduce_sum_grad",
                             [_B16(_f(4, 6)), _B16(np.array(2.5, np.float32))],
                             {"dim": [0], "reduce_all": True}, BF16),
    "reduce_mean_grad": ("reduce_mean_grad", [_x3, _f(2, 3)],
                         {"dim": [-1]}, 1e-6),
    # creation and data movement (0)
    "fill_constant_batch_size_like": (
        "fill_constant_batch_size_like", [_ids],
        {"shape": [-1, 1], "dtype": "int64", "value": 0.0}, 0),
    "fill_constant_batch_size_like_idx": (
        "fill_constant_batch_size_like", [_f(2, 9, 4)],
        {"shape": [3, 5, -1], "dtype": "float32", "value": 1.5,
         "input_dim_idx": 1, "output_dim_idx": 2}, 0),
    "assign_value_fp32": ("assign_value", [],
                          {"shape": [2, 3], "dtype": "float32",
                           "fp32_values": [0.5, -1.0, 2.0, 3.25, 0.0, 7.0]},
                          0),
    "assign_value_int32": ("assign_value", [],
                           {"shape": [3], "dtype": "int32",
                            "int32_values": [4, -2, 9]}, 0),
    "assign_value_int64": ("assign_value", [],
                           {"shape": [1, 5], "dtype": "int64",
                            "int64_values": [0, 0, 1, 0, 0]}, 0),
    "assign_value_inferred_dim": ("assign_value", [],
                                  {"shape": [-1, 2], "dtype": "int64",
                                   "int64_values": [1, 1, 0, 1]}, 0),
    # the chain's order: empty fp32_values falls through to int64_values
    "assign_value_empty_fp32": ("assign_value", [],
                                {"shape": [2], "dtype": "int64",
                                 "fp32_values": [],
                                 "int64_values": [3, 4]}, 0),
    "assign": ("assign", [_f(3, 4)], {}, 0),
    "assign_grad": ("assign_grad", [_f(3, 4), _f(3, 4)], {}, 0),
    "expand_as": ("expand_as", [np.eye(1, 5, 2, dtype=np.int64), _ids[:, :5]],
                  {}, 0),
    "expand_as_float_middle": ("expand_as", [_f(2, 1, 4), _f(2, 3, 4)], {},
                               0),
    # the target gets no grad; X's sums over the broadcast dims
    "expand_as_grad": ("expand_as_grad", [_f(1, 5), _f(3, 5), _f(3, 5)], {},
                       1e-5),
    "expand_as_grad_middle": ("expand_as_grad",
                              [_f(2, 1, 4), _f(2, 3, 4), _f(2, 3, 4)], {},
                              1e-5),
    # add_position_encoding (1e-6: the fp32 sin/cos table and one
    # multiply-add; bf16: one ulp)
    "add_position_encoding": ("add_position_encoding", [_pe8],
                              {"alpha": 1.0, "beta": 1.0}, 1e-6),
    "add_position_encoding_odd_d": ("add_position_encoding", [_pe7],
                                    {"alpha": 1.0, "beta": 1.0}, 1e-6),
    "add_position_encoding_alpha_beta": ("add_position_encoding", [_pe8],
                                         {"alpha": 0.5, "beta": 2.5}, 1e-6),
    "add_position_encoding_odd_alpha_beta": (
        "add_position_encoding", [_pe7], {"alpha": 1.7, "beta": -0.3}, 1e-6),
    "add_position_encoding_bf16": ("add_position_encoding", [_B16(_pe8)],
                                   {"alpha": 1.0, "beta": 1.0}, BF16),
    "add_position_encoding_bf16_odd_alpha_beta": (
        "add_position_encoding", [_B16(_pe7)], {"alpha": 0.5, "beta": 2.5},
        BF16),
    "add_position_encoding_grad": ("add_position_encoding_grad",
                                   [_pe7, _f(2, 5, 7)],
                                   {"alpha": 1.7, "beta": -0.3}, 1e-6),
    "add_position_encoding_grad_bf16": (
        "add_position_encoding_grad", [_B16(_pe8), _B16(_f(2, 6, 8))],
        {"alpha": 0.5, "beta": 2.5}, BF16),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_nmt_op_matches_jax(case):
    _compare(*CASES[case])


def test_position_encoding_layout():
    """Concatenated sines then cosines (not interleaved), frequencies
    10000^(-i/half), an odd D's last column 0."""
    from paddle_tpu_torch.ops.nn_extra_ops import position_encoding

    enc = position_encoding(5, 7, "cpu").numpy()
    half = 3
    freq = 10000.0 ** (-np.arange(half) / half)
    ang = np.arange(5)[:, None] * freq[None, :]
    np.testing.assert_allclose(enc[:, :half], np.sin(ang), atol=1e-6)
    np.testing.assert_allclose(enc[:, half:2 * half], np.cos(ang), atol=1e-6)
    assert (enc[:, -1] == 0).all()


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------


def _op_list(program):
    def attr(v):
        if isinstance(v, np.generic):
            return v.item()
        return list(v) if isinstance(v, tuple) else v

    return json.loads(json.dumps([
        [op.type, op.inputs, op.outputs,
         {k: attr(v) for k, v in sorted(op.attrs.items())}]
        for op in program.global_block().ops], default=str))


def _program(fl, t, kind, dropout):
    cfg = t.TransformerConfig.tiny(dropout=dropout)
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup), fl.unique_name.guard():
        if kind == "decode":
            t.build_greedy_decode(cfg, max_out_len=4)
        else:
            _, cost, _ = t.build_transformer_nmt(cfg)
            fl.optimizer.Adam(1e-4).minimize(cost)
    return main


# (kind, dropout, flash sites, of them with a key bias, causal)
PROGRAMS = [("train", 0.1, 0, 0, 0), ("train", 0.0, 4, 2, 2),
            ("decode", 0.0, 10, 2, 8)]


@pytest.mark.parametrize("kind,dropout,sites,bias,causal", PROGRAMS,
                         ids=[f"{k}-dropout{d}" for k, d, *_ in PROGRAMS])
def test_nmt_program_matches_jax(kind, dropout, sites, bias, causal):
    want = _program(jfluid, jt, kind, dropout)
    got = _program(fluid, tt, kind, dropout)
    jpasses.apply_graph_passes(want)
    passes.apply_graph_passes(got)
    a, b = _op_list(got), _op_list(want)
    assert [op[0] for op in a] == [op[0] for op in b]
    for i, (g, w) in enumerate(zip(a, b)):
        assert g == w, f"op {i}: {g} != {w}"
    flash = [op for op in a if op[0] == "flash_attention"]
    assert len(flash) == sites
    assert sum(bool(op[1].get("Bias")) for op in flash) == bias
    assert sum(op[3]["causal"] for op in flash) == causal
    assert {n: (v.shape, v.dtype.replace("int64", "int32"))
            for n, v in got.global_block().vars.items()} == {
        n: (v.shape, v.dtype.replace("int64", "int32"))
        for n, v in want.global_block().vars.items()}


def _expr_ops(fl, expr):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup), fl.unique_name.guard():
        x = fl.layers.data("x", [-1, 4], False)
        y = fl.layers.data("y", [4, 4], False)
        expr(fl.layers, x, y)
    return _op_list(main)


# each new operator of ``Variable``, and the NMT loss's tail
EXPRS = {
    "sub": lambda L, x, y: x - y,
    "sub_number": lambda L, x, y: x - 2.0,
    "rsub_number": lambda L, x, y: 3.0 - x,
    "rsub_int": lambda L, x, y: 1 - x,
    "truediv": lambda L, x, y: x / x,
    "truediv_number": lambda L, x, y: x / 4.0,
    "matmul": lambda L, x, y: x @ y,
    "neg": lambda L, x, y: -x,
    "astype": lambda L, x, y: x.astype("int64"),
    "nmt_loss_tail": lambda L, x, y: L.reduce_sum(x * x) / (
        L.reduce_sum(x) + 1e-6),
}


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_variable_operators_match_jax(name):
    got = _expr_ops(fluid, EXPRS[name])
    want = _expr_ops(jfluid, EXPRS[name])
    assert got == want
    assert got  # every expression builds at least one op


# ---------------------------------------------------------------------------
# training and decode against the JAX oracle
# ---------------------------------------------------------------------------


@pytest.fixture(scope="session")
def oracle(tmp_path_factory):
    """{route: the oracle's arrays} of its three routes, whose children
    run at once, once a test run: xdist's workers of one run share them
    through a lock file in their common temp root."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    out = (tmp_path_factory.getbasetemp().parent / f"nmt_oracle_{run}"
           if run else tmp_path_factory.mktemp("nmt_oracle"))
    out.mkdir(exist_ok=True)
    routes = ROUTES + ("decode",)
    with open(out / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (out / "done").exists():
            procs = {route: subprocess.Popen(
                [sys.executable, ORACLE, str(out / f"{route}.npz"), route],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=os.path.dirname(os.path.dirname(ORACLE)))
                for route in routes}
            for route, p in procs.items():
                stdout, stderr = p.communicate(timeout=600)
                assert p.returncode == 0 and \
                    "TORCH_PORT_NMT_ORACLE_OK" in stdout, (
                        f"JAX oracle child {route} failed rc={p.returncode}"
                        f"\n{stderr[-3000:]}")
            (out / "done").touch()
    res = {}
    for route in routes:
        z = np.load(out / f"{route}.npz")
        res[route] = {k: z[k] for k in z.files}
    return res


def _prefixed(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


@pytest.fixture
def graph_passes():
    old = fluid.get_flags("FLAGS_graph_passes")
    yield lambda spec: fluid.set_flags({"FLAGS_graph_passes": spec})
    fluid.set_flags(old)


def _train(init, feed, steps, bf16=False, dropout=0.0):
    cfg = oracle_mod.config(tt, dropout)
    main, startup, cost = oracle_mod.build(fluid, tt, cfg)
    if bf16:
        enable_bf16_policy(main)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    if init is not None:
        loaded = convert.load_params(scope, init, fluid.CPUPlace(),
                                     program=main)
        assert loaded == sorted(p.name for p in main.all_parameters())
    losses = [float(exe.run(main, feed=feed, fetch_list=[cost],
                            scope=scope)[0]) for _ in range(steps)]
    return main, np.asarray(losses), scope


@pytest.mark.parametrize("route", ROUTES)
def test_nmt_training_matches_jax(oracle, graph_passes, route):
    want = oracle[route]
    graph_passes("default" if route == "flash" else "none")
    init, feed = _prefixed(want, "init:"), _prefixed(want, "feed:")
    assert (feed["src_ids"] == 0).any() and (feed["label_weight"] == 0).any()
    main, losses, scope = _train(init, feed, len(want["loss"]))
    types = [op.type for op in main.global_block().ops]
    if route == "flash":
        assert types.count("flash_attention") == 4
        assert "softmax_mask_fuse_upper_triangle" not in types
    else:
        assert "flash_attention" not in types
        assert types.count("softmax_mask_fuse_upper_triangle") == 2
    np.testing.assert_allclose(losses, want["loss"], rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    final = _prefixed(want, "final:")
    assert set(final) == {p.name for p in main.all_parameters()}
    for name, w in final.items():
        np.testing.assert_allclose(scope.get(name).numpy(), w,
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)
    _, losses, scope = _train(init, feed, len(want["bf16_loss"]), bf16=True)
    np.testing.assert_allclose(losses, want["bf16_loss"],
                               rtol=BF16_LOSS_RTOL)
    assert all(scope.get(p).dtype == torch.float32 for p in init)


def test_nmt_training_with_dropout_falls():
    """dropout 0.1 (the bench's): the composed attention with its
    dropout; losses finite and falling over 8 steps."""
    cfg = oracle_mod.config(tt, 0.1)
    feed = oracle_mod.batch(tt, cfg)
    main, losses, _ = _train(None, feed, 8, dropout=0.1)
    assert "flash_attention" not in [op.type for op in
                                     main.global_block().ops]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_greedy_decode_matches_jax(oracle):
    want = oracle["decode"]
    cfg = oracle_mod.decode_config(tt)
    main, startup, out = oracle_mod.build_decode(fluid, tt, cfg)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    convert.load_params(scope, _prefixed(want, "init:"), fluid.CPUPlace(),
                        program=main)
    ids = exe.run(main, feed={"src_ids": want["feed:src_ids"]},
                  fetch_list=[out], scope=scope)[0]
    assert ids.dtype == np.int64 and ids.shape == (oracle_mod.BATCH,
                                                   oracle_mod.MAX_OUT_LEN + 1)
    np.testing.assert_array_equal(ids, want["greedy"])
    assert (ids[:, 0] == cfg.bos_id).all()
    assert len({tuple(row) for row in ids.tolist()}) > 1


def test_make_fake_batch_matches_jax():
    for kw in (dict(batch=3, src_len=17, trg_len=16, seed=5),
               dict(batch=256, src_len=32, trg_len=31, seed=17)):
        want = jt.make_fake_batch(jt.TransformerConfig.big(), **kw)
        got = tt.make_fake_batch(tt.TransformerConfig.big(), **kw)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype


def test_models_package_exports_the_nmt_builders():
    assert models.TransformerConfig is tt.TransformerConfig
    assert models.build_transformer_nmt is tt.build_transformer_nmt
    assert models.build_greedy_decode is tt.build_greedy_decode
    assert models.make_fake_batch is tt.make_fake_batch
    big = tt.TransformerConfig.big()
    assert (big.hidden_size, big.num_heads, big.ffn_size,
            big.num_encoder_layers, big.src_vocab) == (1024, 16, 4096, 6,
                                                       30000)


def test_assign_of_an_array_runs_as_assign_value():
    """``layers.assign`` of a numpy array appends an ``assign_value`` op
    (the array's shape inferred at build time), whose run gives the
    values; of a Variable, an ``assign`` op, whose output is a copy."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        out = fluid.layers.assign(np.eye(1, 5, 2, dtype="int64"))
        x = fluid.layers.data("x", [-1, 3], False)
        y = fluid.layers.assign(x)
    assert [op.type for op in main.global_block().ops] == ["assign_value",
                                                           "assign"]
    assert main.global_block().var(out.name).shape == (1, 5)
    exe = fluid.Executor(fluid.CPUPlace())
    xv = np.arange(6, dtype="float32").reshape(2, 3)
    a, b = exe.run(main, feed={"x": xv}, fetch_list=[out, y],
                   scope=fluid.Scope())
    np.testing.assert_array_equal(a, np.eye(1, 5, 2, dtype="int64"))
    np.testing.assert_array_equal(b, xv)


def test_assign_value_keeps_its_values_until_its_attrs_change():
    """``assign_value`` makes its tensor once a device and returns a copy
    each run (a caller may write into it); new attrs make it anew."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        out = fluid.layers.assign(np.array([[1.5, -2.0]], dtype="float32"))
    op = main.global_block().ops[0]
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    first = exe.run(main, fetch_list=[out], scope=scope,
                    return_numpy=False)[0]
    first.mul_(0)
    np.testing.assert_array_equal(
        exe.run(main, fetch_list=[out], scope=scope)[0], [[1.5, -2.0]])
    op.attrs["fp32_values"] = [4.0, 8.0]
    np.testing.assert_array_equal(
        exe.run(main, fetch_list=[out], scope=scope)[0], [[4.0, 8.0]])


# ---------------------------------------------------------------------------
# chip_smoke.py's NMT helpers (phases 24-26), on the CPU
# ---------------------------------------------------------------------------


def test_chip_smoke_nmt_batches_are_the_bench_batches():
    """chip_smoke.nmt_batches (the port's make_fake_batch) gives
    bench.py's ``ragged_batch`` batches (measure_nmt, bench.py:491-505,
    written out here over the JAX package's make_fake_batch) bit for
    bit, with the bench's effective-token count."""
    import chip_smoke

    got = chip_smoke.nmt_batches(tt.TransformerConfig.tiny(),
                                 buckets=(16, 32, 64), tokens=256)
    rng = np.random.RandomState(0)
    for (bucket, feed, eff), lo in zip(got, (0, 16, 32)):
        batch = max(256 // bucket, 1)
        lens = rng.randint(lo + 1, bucket + 1, batch)
        data = jt.make_fake_batch(jt.TransformerConfig.tiny(), batch=batch,
                                  src_len=bucket, trg_len=bucket - 1,
                                  seed=int(lens[0]))
        w = np.zeros_like(data["label_weight"])
        for i, ln in enumerate(lens):
            data["src_ids"][i, ln:] = 0
            w[i, :ln - 1] = 1.0
        data["label_weight"] = w
        assert set(feed) == set(data)
        for k in data:
            np.testing.assert_array_equal(feed[k], data[k])
            assert feed[k].dtype == data[k].dtype
        assert eff == int(lens.sum()) + int(w.sum())


@pytest.mark.parametrize("flash", [False, True], ids=["composed", "flash"])
def test_chip_smoke_forward_flops_counts_the_products(flash):
    """chip_smoke.forward_flops on tiny's training program against the
    products counted by hand: the projections and FFNs of both stacks,
    the attention products (a causal flash attention over its pairs at
    or below the diagonal, a composed one over all S x S) and the
    output projection, 2 FLOPs a multiply-add."""
    import chip_smoke

    cfg = tt.TransformerConfig.tiny(dropout=0.0)
    main, _, _ = oracle_mod.build(fluid, tt, cfg)
    if flash:
        passes.apply_graph_passes(main)
    b, s, t = 3, 10, 9
    feed = tt.make_fake_batch(cfg, batch=b, src_len=s, trg_len=t)
    h, f, v = cfg.hidden_size, cfg.ffn_size, cfg.trg_vocab
    ns, nt = b * s, b * t
    enc = 4 * ns * h * h + 2 * ns * h * f + 2 * b * s * s * h
    self_attn = b * t * (t + 1) * h if flash else 2 * b * t * t * h
    dec = (4 * nt * h * h + self_attn + 2 * nt * h * h + 2 * ns * h * h
           + 2 * b * t * s * h + 2 * nt * h * f)
    macs = (cfg.num_encoder_layers * enc + cfg.num_decoder_layers * dec
            + nt * h * v)
    assert chip_smoke.forward_flops(main, feed) == 2 * macs


def test_chip_smoke_decode_hold_against_the_cpu():
    """chip_smoke._nmt_decode_on_cpu (phase 26's hold) on two CPU runs of
    tiny's greedy decode: ids equal, every pass's logits fetched and
    equal; logits moved by 1e-2 on the "card" side fail it."""
    import chip_smoke

    cfg = tt.TransformerConfig.tiny(dropout=0.0)
    main, startup, out = chip_smoke._nmt_decode_program(cfg, 4)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    feed = chip_smoke.nmt_decode_feed(cfg, 6, 12, 3)
    got, ids = chip_smoke._nmt_decode_on_cpu("tiny", main, out, feed, exe,
                                             scope)
    assert got["ids_equal"] and got["mismatched_rows"] == []
    assert got["logits_max_abs_err"] == 0.0 and got["logits_max_abs"] > 0
    assert ids.shape == (6, 5) and (ids[:, 0] == 0).all()

    class Moved:
        def run(self, *a, **kw):
            res = exe.run(*a, **kw)
            return [res[0]] + [r + 1e-2 for r in res[1:]]

    with pytest.raises(AssertionError, match="logits max abs err"):
        chip_smoke._nmt_decode_on_cpu("tiny", main, out, feed, Moved(),
                                      scope)


def test_chip_smoke_planted_dq_fault_is_the_control_and_goes():
    """chip_smoke._planted_dq_fault (the NMT parity's control) adds eps
    x dQ rolled by one head-dim column to what the flash op's backward
    returns as dQ, leaves dK and dV, and puts K2's wrapper back."""
    import chip_smoke
    from paddle_tpu_torch.kernels.primitives import flash

    rng = np.random.RandomState(0)
    q, k, v = (torch.tensor(rng.randn(2, 3, 5, 8), dtype=torch.float32,
                            requires_grad=True) for _ in range(3))
    do = torch.tensor(rng.randn(2, 3, 5, 8), dtype=torch.float32)

    def grads():
        o = flash.flash_attention(q, k, v, causal=True)
        return torch.autograd.grad(o, (q, k, v), do)

    kernel = flash.flash_bwd_dq
    dq, dk, dv = grads()
    with chip_smoke._planted_dq_fault(0.1):
        pq, pk, pv = grads()
    assert flash.flash_bwd_dq is kernel
    torch.testing.assert_close(pq, dq + 0.1 * dq.roll(1, dims=-1))
    assert torch.equal(pk, dk) and torch.equal(pv, dv)
    assert torch.equal(grads()[0], dq)
