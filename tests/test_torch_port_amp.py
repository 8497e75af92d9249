"""AMP ``decorate`` in the PyTorch port against the JAX package, on the
CPU (``paddle_tpu_torch/fluid/contrib/mixed_precision``: ``fp16_lists``,
``fp16_utils.rewrite_program``, ``decorator``).

Both packages build the same program in-process and run it from one
state: the port's startup values, copied by name into the JAX
package's scope.

- The op lists: the default white and black lists, custom lists moving
  an op between them, and the conflicting-lists ValueError.
- The rewrite: the op list (types, slots, attrs) and every var's dtype
  equal to the JAX package's on the JAX test's MLP
  (tests/test_amp_metrics_profiler.py) and on BERT-tiny, in the bf16
  and the fp16 mode; ``custom_black_varnames`` vetoes a downcast only.
- The MLP trained 5 steps in each mode (the JAX test's SGD, and Adam):
  losses within 2^-8 relative in bf16 (one bf16 ulp: bf16 rounds at
  other places in the two frameworks) and 1e-5 in fp16, the JAX test's
  loss-scale trajectory (2^10 for four steps, 2^11 after the fourth),
  then a batch with an inf: the scale cut by 0.8 in both, and every
  persistable (parameters, Adam's moments and beta powers) left as the
  JAX package leaves it: the same NaN elements (its
  ``check_finite_and_unscale`` zeroes the grads by a multiply, so an
  inf grad element becomes NaN), the rest within the step's tolerance.
- K4's fp16 form (the fp16 mode hands ``fused_bias_act_dropout`` fp16 x
  and an fp32 bias): the plain version, which is the CPU path and the
  card's oracle, within one fp16 ulp of the JAX function
  (``paddle_tpu/kernels/fused_bias_act.py``) on the same inputs, with
  and without a dropout mask, at pre-activations around fp16's largest
  value: a result past 65504 (+ half an ulp) is +inf in both.
- BERT-base under ``decorate`` in the fp16 mode, built and passed
  through the default graph passes (not run): the two packages' pass
  reports equal, and equal to what ``chip_smoke.py`` phase 32 gates on
  the card (``chip_smoke.amp_pass_sites``: 13 ``fuse_bias_act_dropout``
  sites; BERT-tiny above holds the bf16 mode's report alike).
- BERT-tiny at one layer (flash attention, dropout 0) under
  ``decorate(Adam(1e-4))`` for 3 steps in each mode: the same
  graph-pass report (no ``fuse_attention`` site, two
  ``fuse_bias_act_dropout`` sites: the FFN and the MLM head; no
  ``fuse_softmax_cross_entropy``), the same op types after the passes,
  losses within 1e-3 relative (bf16) and 1e-5 (fp16), the loss scale
  equal, parameters within 2e-3 (bf16, as tests/test_torch_port_bert.py
  holds the bf16 policy's) and 2e-4 (fp16): an Adam step moves an
  element by about lr whatever its grad's size, so a near-zero grad
  rounded the other way moves it by up to 2·lr.
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import fluid as jfluid
from paddle_tpu.kernels import fused_bias_act as jfba
from paddle_tpu.fluid.contrib import mixed_precision as jmp
from paddle_tpu.models import bert as jbert

from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid.contrib import mixed_precision as tmp
from paddle_tpu_torch.kernels import fused_bias_act as tfba
from paddle_tpu_torch.models import bert

PKGS = {"jax": (jfluid, jmp, jbert), "port": (fluid, tmp, bert)}
MODES = {"bf16": {},
         "fp16": dict(init_loss_scaling=2.0 ** 10, dest_dtype="float16",
                      use_dynamic_loss_scaling=True, incr_every_n_steps=4,
                      decr_every_n_nan_or_inf=1)}
MLP_LOSS_RTOL = {"bf16": 2 ** -8, "fp16": 1e-5}
BERT_LOSS_RTOL = {"bf16": 1e-3, "fp16": 1e-5}
BERT_PARAM_ATOL = {"bf16": 2e-3, "fp16": 2e-4}
# the x64-off difference: the JAX package types an int64 var int32
X64 = {("int64", "int32")}


def _mlp(pkg, mode, opt="sgd", **kw):
    fl, mp, _ = PKGS[pkg]
    make = {"sgd": lambda: fl.optimizer.SGD(learning_rate=1e-2),
            "adam": lambda: fl.optimizer.Adam(learning_rate=5e-3)}[opt]
    dec = mp.decorate(make(), **{**MODES[mode], **kw})
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup), fl.unique_name.guard():
        x = fl.layers.data(name="x", shape=[16], dtype="float32")
        y = fl.layers.data(name="y", shape=[1], dtype="int64")
        h = fl.layers.fc(input=x, size=32, act="relu")
        logits = fl.layers.fc(input=h, size=4)
        loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(logits, y))
        dec.minimize(loss, startup_program=startup)
    return main, startup, loss, dec


def _bert(pkg, mode):
    fl, mp, bm = PKGS[pkg]
    kw = dict(MODES[mode])
    if mode == "fp16":
        kw["init_loss_scaling"] = 2.0 ** 15
    cfg = bm.BertConfig.tiny(use_flash_attention=True, attn_dropout=0.0,
                             hidden_dropout=0.0, num_layers=1)
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup), fl.unique_name.guard():
        _, loss, _, _ = bm.build_bert_pretrain(cfg)
        dec = mp.decorate(fl.optimizer.Adam(1e-4), **kw)
        dec.minimize(loss, startup_program=startup)
    return main, startup, loss, dec, cfg


def make_batch(i, n=64):
    """tests/test_amp_metrics_profiler.py's batch."""
    rng = np.random.RandomState(i)
    x = rng.uniform(-1, 1, (n, 16)).astype("float32")
    return {"x": x, "y": x[:, :4].argmax(axis=1).astype("int64")
            .reshape(n, 1)}


def _ops(program):
    return [(op.type, {k: list(v) for k, v in op.inputs.items()},
             {k: list(v) for k, v in op.outputs.items()},
             {k: (list(v) if isinstance(v, tuple) else v)
              for k, v in sorted(op.attrs.items())})
            for op in program.global_block().ops]


def _same_program(tmain, jmain):
    got, want = _ops(tmain), _ops(jmain)
    assert [o[0] for o in got] == [o[0] for o in want]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"op {i}: {g} != {w}"
    tv, jv = tmain.global_block().vars, jmain.global_block().vars
    assert list(tv) == list(jv)
    for n in tv:
        pair = (tv[n].dtype, jv[n].dtype)
        assert pair[0] == pair[1] or pair in X64, (n, pair)


def _persistables(program):
    return sorted(n for n, v in program.global_block().vars.items()
                  if v.persistable and v.dtype != "bool")


class _Pair:
    """The two packages' runs of one program from one state: the port's
    startup run, every persistable then copied into the JAX package's
    scope (its startup program need not compile)."""

    def __init__(self, build):
        import jax.numpy as jnp

        self.j = build("jax")
        self.t = build("port")
        self.tscope, self.texe = fluid.Scope(), fluid.Executor(
            fluid.CPUPlace())
        self.texe.run(self.t[1], scope=self.tscope)
        self.jscope, self.jexe = jfluid.Scope(), jfluid.Executor(
            jfluid.CPUPlace())
        for n in _persistables(self.j[0]):
            self.jscope.set(n, jnp.asarray(self.tscope.get(n).numpy()))

    def step(self, feed):
        with jfluid.scope_guard(self.jscope):
            (jl,) = self.jexe.run(self.j[0], feed=feed,
                                  fetch_list=[self.j[2].name])
        (tl,) = self.texe.run(self.t[0], feed=feed,
                              fetch_list=[self.t[2].name], scope=self.tscope)
        return float(np.asarray(tl)), float(np.asarray(jl))

    def value(self, name):
        return (self.tscope.get(name).float().numpy(),
                np.asarray(self.jscope.get(name)).astype(np.float32))

    def scale(self):
        name = self.j[3].get_loss_scaling().name
        t, j = self.value(name)
        return float(t.reshape(-1)[0]), float(j.reshape(-1)[0])


def test_lists_match_jax():
    for kw in ({}, {"custom_white_list": ["softmax", "gelu"],
                    "custom_black_list": ["mul"],
                    "custom_black_varnames": ["x"]}):
        got = tmp.AutoMixedPrecisionLists(**kw)
        want = jmp.AutoMixedPrecisionLists(**kw)
        assert (got.white_list, got.black_list, got.black_varnames) == \
            (want.white_list, want.black_list, want.black_varnames)
    msgs = []
    for mp in (tmp, jmp):
        with pytest.raises(ValueError, match="both custom white and black"
                           ) as e:
            mp.AutoMixedPrecisionLists(custom_white_list=["mul", "exp"],
                                       custom_black_list=["mul"])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("model", ["mlp", "bert_tiny"])
def test_rewrite_matches_jax(model, mode):
    """The decorated program before the passes: every op and every var's
    dtype, the casts at the JAX package's positions with its names."""
    build = (lambda pkg: _mlp(pkg, mode)) if model == "mlp" else (
        lambda pkg: _bert(pkg, mode))
    tmain, jmain = build("port")[0], build("jax")[0]
    _same_program(tmain, jmain)
    dest = "bfloat16" if mode == "bf16" else "float16"
    blk = tmain.global_block()
    casts = [op for op in blk.ops if op.type == "cast"]
    assert casts and all(op.outputs["Out"][0] == op.inputs["X"][0]
                         + ".cast_" + op.attrs["out_dtype"] for op in casts)
    for op in blk.ops:
        if op.type == "mul":
            assert {blk.var(n).dtype for n in op.input_arg_names
                    + op.output_arg_names} == {dest}, op


def test_black_varnames_veto_the_downcast_only():
    """A var named in ``custom_black_varnames`` reaches a white op
    uncast; a black op's input is still cast back to fp32."""
    progs = {}
    for pkg, (fl, mp, _) in PKGS.items():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup), fl.unique_name.guard():
            x = fl.layers.data(name="x", shape=[16], dtype="float32")
            h = fl.layers.fc(input=x, size=8, bias_attr=False)
            fl.layers.mean(fl.layers.softmax(h))
        lists = mp.AutoMixedPrecisionLists(custom_black_varnames=["x"])
        progs[pkg] = mp.rewrite_program(main, lists, "float16")
    _same_program(progs["port"], progs["jax"])
    ops = progs["port"].global_block().ops
    mul = [op for op in ops if op.type == "mul"][0]
    assert mul.inputs["X"] == ["x"]
    sm = [op for op in ops if op.type == "softmax"][0]
    assert sm.inputs["X"][0].endswith(".cast_float32")


def test_cast_parameters_to_bf16_raises():
    from paddle_tpu_torch.fluid.contrib.mixed_precision import fp16_utils

    with pytest.raises(NotImplementedError, match="master weights"):
        fp16_utils.cast_parameters_to_bf16()


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_mlp_trains_like_jax(mode, opt):
    """5 steps, then (fp16) a batch with an inf: the losses, the JAX
    test's scale trajectory and every persistable as the JAX package
    leaves it."""
    pair = _Pair(lambda pkg: _mlp(pkg, mode, opt))
    scales = []
    for i in range(5):
        got, want = pair.step(make_batch(i))
        np.testing.assert_allclose(got, want, rtol=MLP_LOSS_RTOL[mode])
        scales.append(pair.scale())
    if mode == "bf16":
        assert scales == [(1.0, 1.0)] * 5
        return
    assert scales == [(2.0 ** 10,) * 2] * 3 + [(2.0 ** 11,) * 2] * 2
    bad = make_batch(99)
    bad["x"][0, 0] = np.inf
    got, want = pair.step(bad)
    assert np.isnan(got) and np.isnan(want)
    assert pair.scale() == (np.float32(2.0 ** 11 * 0.8),) * 2
    names = _persistables(pair.t[0])
    assert any("moment" in n for n in names) == (opt == "adam")
    for n in names:
        t, j = pair.value(n)
        np.testing.assert_array_equal(np.isnan(t), np.isnan(j), err_msg=n)
        ok = ~np.isnan(j)
        np.testing.assert_allclose(t[ok], j[ok], rtol=1e-5, atol=1e-6,
                                   err_msg=n)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_bert_tiny_trains_like_jax(mode):
    pair = _Pair(lambda pkg: _bert(pkg, mode))
    feed = bert.make_fake_batch(pair.j[4], 4, 32)
    for _ in range(3):
        got, want = pair.step(feed)
        np.testing.assert_allclose(got, want, rtol=BERT_LOSS_RTOL[mode])
        assert np.isfinite(got)
    t, j = pair.scale()
    assert t == j == (1.0 if mode == "bf16" else 2.0 ** 15)
    tmain, jmain = pair.t[0], pair.j[0]
    assert tmain._pass_report == jmain._pass_report
    sites = {r["pass"]: r["sites"] for r in tmain._pass_report}
    assert sites == {"fuse_attention": 0, "fuse_bias_act_dropout": 2,
                     "fuse_softmax_cross_entropy": 0}
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    # fp16 (or bf16) x and an fp32 bias into K4, as in the JAX package
    blk = tmain.global_block()
    dest = "bfloat16" if mode == "bf16" else "float16"
    for op in blk.ops:
        if op.type == "fused_bias_act_dropout":
            assert blk.var(op.inputs["X"][0]).dtype == dest
            assert blk.var(op.inputs["Bias"][0]).dtype == "float32"
    for p in tmain.all_parameters():
        got_p, want_p = pair.value(p.name)
        assert pair.tscope.get(p.name).dtype == torch.float32
        np.testing.assert_allclose(got_p, want_p, rtol=0,
                                   atol=BERT_PARAM_ATOL[mode],
                                   err_msg=p.name)


def _fp16_k4_inputs():
    """fp16 x with an fp32 bias; the last rows put x + bias around
    fp16's largest value 65504 (65519 rounds down, 65520 up to inf)."""
    rng = np.random.RandomState(7)
    x = (rng.randn(6, 40) * 3).astype(np.float16)
    b = rng.randn(40).astype(np.float32)
    edge = np.array([65504, 65504, 65504, 65504, 65472, 60000, -65504,
                     -60000], np.float32)
    x[4, :8] = edge.astype(np.float16)
    b[:8] = [15.0, 15.99, 16.0, 200.0, 47.0, 5519.0, -16.0, 1.0]
    x[5] = np.float16(65504)
    return x, b


@pytest.mark.parametrize("with_mask", [False, True])
def test_bias_gelu_fp16_plain_matches_jax(with_mask):
    x, b = _fp16_k4_inputs()
    mask = (np.random.RandomState(8).rand(*x.shape) > 0.2).astype(np.uint8)
    kw = dict(mask=torch.from_numpy(mask), scale=1.25) if with_mask else {}
    got = tfba.fused_bias_gelu(torch.from_numpy(x), torch.from_numpy(b),
                               **kw)
    assert got.dtype == torch.float16
    pre = jnp.asarray(x, jnp.float32) + jnp.asarray(b)
    want = jfba._gelu(pre, False)
    if with_mask:
        want = want * jnp.asarray(mask, jnp.float32) * 1.25
    want = np.asarray(want.astype(jnp.float16)).astype(np.float32)
    jout, _ = jfba.fused_bias_gelu_dropout(jnp.asarray(x), jnp.asarray(b))
    assert str(jout.dtype) == "float16"
    if not with_mask:
        np.testing.assert_array_equal(
            np.asarray(jout.astype(jnp.float32)), want)
    g = got.float().numpy()
    inf = np.isinf(want)
    assert inf.sum() >= 4 and np.array_equal(np.isinf(g), inf)
    np.testing.assert_array_equal(g[inf], want[inf])
    # one fp16 ulp of each value, taken toward zero (65504's is 32)
    ulp = np.abs(np.spacing(-np.abs(want[~inf]).astype(np.float16))
                 ).astype(np.float32)
    assert (np.abs(g[~inf] - want[~inf]) <= ulp).all()


def test_bert_base_pass_report_matches_jax_and_the_card_gate(mode="fp16"):
    import chip_smoke
    from paddle_tpu import passes as jpasses

    from paddle_tpu_torch import passes as tpasses

    reports = {}
    for pkg, passes in (("jax", jpasses), ("port", tpasses)):
        fl, mp, bm = PKGS[pkg]
        cfg = bm.BertConfig.base(vocab_size=30528, attn_dropout=0.0)
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup), fl.unique_name.guard():
            _, loss, _, _ = bm.build_bert_pretrain(cfg)
            mp.decorate(fl.optimizer.Adam(1e-4), **MODES[mode]).minimize(
                loss, startup_program=startup)
        passes.apply_graph_passes(main)
        reports[pkg] = main._pass_report
    assert reports["port"] == reports["jax"]
    sites = {r["pass"]: r["sites"] for r in reports["port"]}
    assert sites == chip_smoke.amp_pass_sites(bert.BertConfig.base())
