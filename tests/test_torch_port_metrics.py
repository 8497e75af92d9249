"""The metric ops and their front end in the PyTorch port against the JAX
package, on the CPU.

- Each metric op against the JAX registry's lowering on the same seeded
  inputs: ``auc`` (ROC and PR, its stat buffers updated in place),
  ``precision_recall`` (with and without weights and states),
  ``edit_distance`` (normalized and not), ``warpctc`` (loss and the
  derived grad, variable lengths) and ``chunk_eval``.  Integers are
  compared by value (the JAX package runs with x64 off, so its int64
  buffers are int32); floats within 1e-6 relative (the same fp32 or
  fp64 formula summed in another order), the CTC loss and grad within
  1e-5 (a loop of logaddexps).
- ``fluid.metrics`` (every class), ``fluid.average.WeightedAverage`` and
  the ``evaluator`` classes (through programs built by both packages;
  the side programs memoized) against the JAX modules: equal values.
- ``split`` (and ``split_byref``), ``nets.glu``, ``sequence_conv_pool``
  and ``scaled_dot_product_attention``: programs built and serialized
  by the JAX package, run by the port from the JAX package's startup
  values, outputs and input grads within 1e-5; the port's own front
  end builds the same op list.
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid import registry as jreg

from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import registry as treg

RTOL = 1e-6
CTC_TOL = 1e-5
NET_TOL = 1e-5


def _jax(op_type, inputs, attrs):
    """The JAX lowering under one jit (compiling the block once is
    quicker than running its scans op by op)."""
    ctx = jreg.LowerContext(step=0)
    present = [i for i, a in enumerate(inputs) if a is not None]

    def fn(*vals):
        full = [None] * len(inputs)
        for i, v in zip(present, vals):
            full[i] = v
        out = jreg.get_op(op_type).lower(ctx, *full, attrs=dict(attrs))
        return out if isinstance(out, tuple) else (out,)

    return jax.jit(fn)(*[jnp.asarray(inputs[i]) for i in present])


def _port(op_type, inputs, attrs):
    ctx = treg.LowerContext("cpu")
    vals = [None if a is None else torch.from_numpy(np.array(a))
            for a in inputs]
    out = treg.get_op(op_type).lower(ctx, *vals, attrs=dict(attrs))
    return vals, out if isinstance(out, tuple) else (out,)


def _close(got, want, rtol=RTOL, atol=0.0):
    if got is None or want is None:
        assert got is None and want is None
        return
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    w = np.asarray(want).astype(g.dtype) if np.asarray(want).dtype.kind \
        in "iub" else np.asarray(want, np.float64)
    if g.dtype.kind in "iub":
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


r = np.random.RandomState(0)


def _probs(n):
    p = r.rand(n).astype(np.float32)
    return np.stack([1 - p, p], 1)


@pytest.mark.parametrize("curve", ["ROC", "PR"])
def test_auc_op_streams_in_place_as_jax(curve):
    attrs = {"curve": curve, "num_thresholds": 200}
    pos = np.zeros(201, np.int64)
    neg = np.zeros(201, np.int64)
    jpos, jneg = pos.astype(np.int32), neg.astype(np.int32)
    for _ in range(3):  # streaming: the buffers carry across batches
        pred, lbl = _probs(64), r.randint(0, 2, (64, 1)).astype(np.int64)
        vals, got = _port("auc", [pred, lbl, pos, neg], attrs)
        want = _jax("auc", [pred, lbl, jpos, jneg], attrs)
        assert got[1] is vals[2] and got[2] is vals[3]  # in place
        pos, neg = got[1].numpy(), got[2].numpy()
        jpos, jneg = np.asarray(want[1]), np.asarray(want[2])
        _close(got[1], jpos)
        _close(got[2], jneg)
        _close(got[0], want[0])


def test_precision_recall_op_matches_jax():
    c = 4
    idx = r.randint(0, c, (32, 1)).astype(np.int64)
    lbl = r.randint(0, c, (32, 1)).astype(np.int64)
    w = r.rand(32, 1).astype(np.float32)
    states = r.randint(0, 5, (c, 4)).astype(np.float32)
    for weights, st in ((None, None), (w, states)):
        inputs = [None, idx, lbl, weights, st]
        _, got = _port("precision_recall", inputs, {"class_number": c})
        want = _jax("precision_recall", inputs, {"class_number": c})
        for g, wv in zip(got, want):
            _close(g, wv, atol=1e-7)


@pytest.mark.parametrize("normalized", [False, True])
def test_edit_distance_op_matches_jax(normalized):
    hyps = r.randint(0, 5, (6, 7)).astype(np.int64)
    refs = r.randint(0, 5, (6, 5)).astype(np.int64)
    hl = np.array([7, 3, 0, 5, 6, 1], np.int64)
    rl = np.array([5, 5, 2, 0, 4, 3], np.int64)
    attrs = {"normalized": normalized}
    for lens in ((None, None), (hl, rl)):
        inputs = [hyps, refs, *lens]
        _, got = _port("edit_distance", inputs, attrs)
        want = _jax("edit_distance", inputs, attrs)
        _close(got[0], want[0])
        assert int(got[1]) == int(want[1])


def test_warpctc_loss_and_grad_match_jax_on_variable_lengths():
    b, t, c, l = 3, 9, 6, 4
    logits = r.randn(b, t, c).astype(np.float32)
    label = r.randint(1, c, (b, l)).astype(np.int32)
    label[1, 3] = label[1, 2]  # a repeat: the skip transition closes
    t_len = np.array([9, 7, 5], np.int64)
    l_len = np.array([4, 4, 2], np.int64)
    attrs = {"blank": 0, "norm_by_times": False}
    inputs = [logits, label, t_len, l_len]
    _, got = _port("warpctc", inputs, attrs)
    want = _jax("warpctc", inputs, attrs)
    assert got[0] is None and want[0] is None
    _close(got[1], want[1], rtol=CTC_TOL)
    dloss = r.rand(b, 1).astype(np.float32)
    _, gg = _port("warpctc_grad", inputs + [None, dloss], attrs)
    wg = _jax("warpctc_grad", inputs + [None, dloss], attrs)
    _close(gg[0], wg[0], rtol=CTC_TOL, atol=CTC_TOL)
    assert gg[1] is None and gg[2] is None


def test_chunk_eval_op_matches_jax_and_refuses_other_schemes():
    n_types = 3
    infer = r.randint(0, 2 * n_types + 1, (5, 12)).astype(np.int64)
    label = infer.copy()
    flip = r.rand(5, 12) < 0.3
    label[flip] = r.randint(0, 2 * n_types + 1, flip.sum())
    length = np.array([12, 9, 4, 12, 1], np.int64)
    attrs = {"chunk_scheme": "IOB", "num_chunk_types": n_types}
    for ln in (None, length):
        _, got = _port("chunk_eval", [infer, label, ln], attrs)
        want = _jax("chunk_eval", [infer, label, ln], attrs)
        for g, w in zip(got, want):
            _close(g, w)
    with pytest.raises(NotImplementedError, match="IOB only"):
        _port("chunk_eval", [infer, label, None],
              dict(attrs, chunk_scheme="IOE"))


def test_split_op_and_byref_match_jax():
    x = r.randn(4, 9).astype(np.float32)
    for op in ("split", "split_byref"):
        for attrs in ({"axis": 1, "num": 3, "sections": []},
                      {"axis": 1, "num": 0, "sections": [2, 3, 4]}):
            _, got = _port(op, [x], attrs)
            want = _jax(op, [x], attrs)
            assert len(got[0]) == len(want[0])
            for g, w in zip(got[0], want[0]):
                _close(g, w)
    assert treg.get_op("split_byref").grad is None


# ---------------------------------------------------------------------------
# fluid.metrics, average, evaluator
# ---------------------------------------------------------------------------

def _feed_metrics(m, rng):
    name = type(m).__name__
    for _ in range(3):
        if name == "Accuracy":
            m.update(value=rng.rand(), weight=rng.randint(1, 9))
        elif name in ("Precision", "Recall", "CompositeMetric"):
            m.update(rng.rand(16, 1), rng.randint(0, 2, (16, 1)))
        elif name == "Auc":
            p = rng.rand(32)
            m.update(np.stack([1 - p, p], 1), rng.randint(0, 2, (32, 1)))
        elif name == "EditDistance":
            d = rng.randint(0, 3, (8, 1)).astype(np.float32)
            m.update(d, 8)
        elif name == "ChunkEvaluator":
            m.update(*rng.randint(1, 9, 3))
        elif name == "DetectionMAP":
            gt = rng.rand(3, 4) * 0.5
            gt[:, 2:] += 0.5
            det = np.concatenate(
                [rng.randint(0, 2, (4, 1)), rng.rand(4, 1),
                 np.concatenate([gt, gt[:1] + 0.05])], 1)
            m.update(det, gt, rng.randint(0, 2, 3))


@pytest.mark.parametrize("name", ["Accuracy", "Precision", "Recall", "Auc",
                                  "EditDistance", "CompositeMetric",
                                  "ChunkEvaluator", "DetectionMAP"])
def test_fluid_metrics_match_jax(name):
    ms = []
    for pkg in (tfluid, jfluid):
        m = getattr(pkg.metrics, name)()
        if name == "CompositeMetric":
            m.add_metric(pkg.metrics.Precision())
            m.add_metric(pkg.metrics.Recall())
        _feed_metrics(m, np.random.RandomState(3))
        ms.append(m)
    got, want = (m.eval() for m in ms)
    np.testing.assert_equal(np.asarray(got, np.float64),
                            np.asarray(want, np.float64))
    if name == "DetectionMAP":
        assert got == ms[0].eval("integral")
        assert ms[0].eval("11point") == ms[1].eval("11point")


def test_weighted_average_matches_jax():
    avgs = [tfluid.average.WeightedAverage(),
            jfluid.average.WeightedAverage()]
    for a in avgs:
        with pytest.raises(ValueError):
            a.eval()
        a.add(3.0, 2)
        a.add(np.arange(4.0), 5)
    assert avgs[0].eval() == avgs[1].eval()


def _evaluators(pkg):
    L = pkg.fluid.layers
    main, startup = pkg.fluid.Program(), pkg.fluid.Program()
    with pkg.fluid.program_guard(main, startup), \
            pkg.fluid.unique_name.guard():
        inf = L.data(name="inf", shape=[10], dtype="int64")
        lbl = L.data(name="lbl", shape=[10], dtype="int64")
        ln = L.data(name="ln", shape=[1], dtype="int64")
        hyp = L.data(name="hyp", shape=[6], dtype="int64")
        ref = L.data(name="ref", shape=[5], dtype="int64")
        with pytest.warns(Warning, match="deprecated"):
            chunk = pkg.fluid.evaluator.ChunkEvaluator(
                inf, lbl, "IOB", 2, length=ln)
            ed = pkg.fluid.evaluator.EditDistance(hyp, ref)
    return main, startup, chunk, ed


def test_evaluators_match_jax_and_memoize_side_programs():
    import paddle_tpu
    import paddle_tpu_torch

    rng = np.random.RandomState(4)
    feeds = [{"inf": rng.randint(0, 5, (4, 10)),
              "lbl": rng.randint(0, 5, (4, 10)),
              "ln": rng.randint(1, 11, (4, 1)),
              "hyp": rng.randint(0, 4, (4, 6)),
              "ref": rng.randint(0, 4, (4, 5))} for _ in range(3)]
    results = []
    for pkg in (paddle_tpu_torch, paddle_tpu):
        main, startup, chunk, ed = _evaluators(pkg)
        exe = pkg.fluid.Executor(pkg.fluid.CPUPlace())
        scope = pkg.fluid.Scope()
        with pkg.fluid.scope_guard(scope):
            exe.run(startup)
            out = []
            for epoch in range(2):
                chunk.reset(exe)
                ed.reset(exe)
                for f in feeds[epoch:]:
                    exe.run(main, feed=f)
                out.append([np.asarray(v) for v in chunk.eval(exe)]
                           + [np.asarray(v) for v in ed.eval(exe)])
            # one reset and one eval program an evaluator, whatever the
            # number of calls
            progs = (chunk._reset_program, chunk._eval_program,
                     ed._reset_program, ed._eval_program)
            chunk.reset(exe)
            chunk.eval(exe)
            assert progs[:2] == (chunk._reset_program, chunk._eval_program)
        results.append(out)
    for got, want in zip(*results):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(NotImplementedError, match="DetectionMAP"):
        tfluid.evaluator.DetectionMAP()


# ---------------------------------------------------------------------------
# split / nets through programs serialized from the JAX package
# ---------------------------------------------------------------------------

NETS = {
    "split": ([8], lambda pkg, L, x: L.concat(
        [L.elementwise_mul(p, p) for p in L.split(x, [2, 3, 3], dim=-1)],
        axis=1)),
    "glu": ([8], lambda pkg, L, x: pkg.fluid.nets.glu(x, dim=-1)),
    "sequence_conv_pool": ([7, 6], lambda pkg, L, x:
                           pkg.fluid.nets.sequence_conv_pool(
                               x, num_filters=5, filter_size=3)),
    "scaled_dot_product_attention": (
        [5, 8], lambda pkg, L, x:
        pkg.fluid.nets.scaled_dot_product_attention(x, x, x, num_heads=2)),
}


def _build_net(pkg, name):
    shape, fn = NETS[name]
    fl = pkg.fluid
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup), fl.unique_name.guard():
        x = fl.layers.data(name="x", shape=shape, dtype="float32")
        x.stop_gradient = False
        out = fn(pkg, fl.layers, x)
        loss = fl.layers.mean(fl.layers.square(out))
        (dx,) = fl.gradients(loss, x)
    return main, startup, out, dx


@pytest.mark.parametrize("name", sorted(NETS))
def test_nets_from_jax_serialized_programs(name):
    import paddle_tpu
    import paddle_tpu_torch

    jmain, jstartup, jout, jdx = _build_net(paddle_tpu, name)
    tmain = _build_net(paddle_tpu_torch, name)[0]
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    shape = NETS[name][0]
    x = np.random.RandomState(5).randn(3, *shape).astype(np.float32)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jstartup, scope=jscope)
    want = jexe.run(jmain, feed={"x": x}, fetch_list=[jout, jdx],
                    scope=jscope)
    prog = tfluid.io.program_from_dict(jfluid.io.program_to_dict(jmain))
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    for p in jmain.all_parameters():
        tscope.set(p.name, torch.from_numpy(
            np.array(jscope.get(p.name), np.float32)))
    got = texe.run(prog, feed={"x": x}, fetch_list=[jout.name, jdx.name],
                   scope=tscope)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=NET_TOL,
                                   atol=NET_TOL)


def test_fetch_of_a_persistable_no_op_writes_reads_the_scope():
    """A program of vars and no ops fetches its persistables from the
    scope, as the JAX package's executor does: the evaluators' state
    program, not "fetch target(s) ... are not produced by this
    program" (ROADMAP §3)."""
    got = []
    for fl, wrap in ((tfluid, torch.from_numpy), (jfluid, np.asarray)):
        prog = fl.Program()
        prog.global_block().create_var(name="acc", shape=[2],
                                       dtype="float32", persistable=True)
        scope = fl.Scope()
        scope.set("acc", wrap(np.array([1.5, -2.0], np.float32)))
        got.append(fl.Executor(fl.CPUPlace()).run(
            prog, fetch_list=["acc"], scope=scope)[0])
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[0], [1.5, -2.0])
