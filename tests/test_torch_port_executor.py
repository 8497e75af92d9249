"""The port's executor against the JAX package's on the CPU: ``run_steps``
(the JAX ``_CompiledChain``), its validation, ``compiled_for``, the
cache key (feed shapes and dtypes) and the compile/step metrics.

Each case of tests/test_run_steps.py that the port's ops can run is
here, with the same program built through ``paddle_tpu`` and
``paddle_tpu_torch`` and the port's parameters copied by name from the
JAX package's.  The port has no ``relu`` or ``square_error_cost``, so
the network is fc(tanh) -> dropout -> fc -> softmax_with_cross_entropy
-> mean under Momentum.  The two packages draw different dropout masks
from the same seed, so a comparison across packages runs with dropout
off; one within the port (run_steps against run() calls) runs with it
on and is exact: the same lowerings on the same values.  The
FLAGS_check_nan_inf and host-op cases need modules the port lacks
(health/detect.py, the RPC ops; ROADMAP.md).

Tolerances across packages: 1e-6 on fp32 losses and parameters
(matmuls summed in another order), 1e-2 relative under the bf16 policy
(bf16 rounds at other places in the two frameworks).
"""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import observability as jobs
from paddle_tpu.fluid.contrib import mixed_precision as jmp

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid.contrib import mixed_precision as tmp
from paddle_tpu_torch.observability import metrics as tmetrics

FP32_TOL = dict(rtol=1e-6, atol=1e-6)
BF16_RTOL = 1e-2


def _build(fluid, with_dropout, seed=7):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(x, size=16, act="tanh")
        if with_dropout:
            h = fluid.layers.dropout(
                h, dropout_prob=0.3,
                dropout_implementation="upscale_in_train")
        logits = fluid.layers.fc(h, size=4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.Momentum(learning_rate=0.05,
                                 momentum=0.9).minimize(loss)
    return main, startup, loss


def _feed(rng, batch=16):
    return {"x": rng.rand(batch, 8).astype("float32"),
            "y": rng.randint(0, 4, (batch, 1)).astype("int64")}


def _persistables(main):
    return [v.name for v in main.global_block().vars.values()
            if getattr(v, "persistable", False)]


def _jax_state(main, startup):
    """A started JAX scope and executor, and its persistables as numpy."""
    scope = jfluid.executor.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup, scope=scope)
    init = {n: np.asarray(scope.get(n)) for n in _persistables(main)
            if scope.get(n) is not None}
    return exe, scope, init


def _port_state(main, startup, init):
    """A started port scope with ``init`` copied in by name (the
    startup runs on its own executor, so the returned one starts at
    step 0, like the JAX executor after its startup run: both at 1)."""
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    for n, v in init.items():
        have = scope.get(n)
        scope.set(n, torch.from_numpy(v.copy()).to(have.dtype))
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe._step = 1
    return exe, scope


def _values(scope, names):
    return {n: np.asarray(scope.get(n)) for n in names
            if scope.get(n) is not None}


def _both(with_dropout=False, bf16=False):
    """The same program in both packages from the same parameters."""
    jm, js, jl = _build(jfluid, with_dropout)
    tm, ts, tl = _build(tfluid, with_dropout)
    if bf16:
        jmp.enable_bf16_policy(jm)
        tmp.enable_bf16_policy(tm)
    jexe, jscope, init = _jax_state(jm, js)
    texe, tscope = _port_state(tm, ts, init)
    return (jm, jl, jexe, jscope), (tm, tl, texe, tscope), sorted(init)


def _port_seq_and_chain(with_dropout, n, bf16=False):
    """run() n times and run_steps(n) in the port from one start."""
    out = {}
    for tag in ("seq", "chain"):
        main, startup, loss = _build(tfluid, with_dropout)
        if bf16:
            tmp.enable_bf16_policy(main)
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        feed = _feed(np.random.RandomState(0))
        if tag == "seq":
            for _ in range(n):
                (last,) = exe.run(main, feed=feed, fetch_list=[loss],
                                  scope=scope)
        else:
            (last,) = exe.run_steps(main, feed=feed, n_steps=n,
                                    fetch_list=[loss], scope=scope)
        out[tag] = (float(last), _values(scope, _persistables(main)),
                    exe._step)
    return out


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_run_steps_matches_sequential_runs(bf16):
    """Four chained steps == four run() calls in the port, dropout on:
    the same final parameters and loss bit for bit, and the step counter
    at startup + 4 (the random streams follow it)."""
    res = _port_seq_and_chain(True, 4, bf16=bf16)
    seq, chain = res["seq"], res["chain"]
    assert chain[2] == seq[2] == 5
    assert seq[1].keys() == chain[1].keys() and seq[1]
    for name in seq[1]:
        np.testing.assert_array_equal(seq[1][name], chain[1][name],
                                      err_msg=name)
    assert chain[0] == seq[0]


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_run_steps_matches_jax_run_steps(bf16):
    """run_steps(4) in both packages from the same parameters, dropout
    off: the final loss and parameters within the fp32 tolerance (the
    bf16 loss within 1e-2)."""
    (jm, jl, jexe, jscope), (tm, tl, texe, tscope), names = _both(bf16=bf16)
    feed = _feed(np.random.RandomState(0))
    (jlast,) = jexe.run_steps(jm, feed=feed, n_steps=4, fetch_list=[jl],
                              scope=jscope)
    (tlast,) = texe.run_steps(tm, feed=feed, n_steps=4, fetch_list=[tl],
                              scope=tscope)
    assert jexe._step == texe._step == 5
    if bf16:
        np.testing.assert_allclose(float(tlast), float(jlast),
                                   rtol=BF16_RTOL)
        return
    np.testing.assert_allclose(float(tlast), float(jlast), **FP32_TOL)
    jv, tv = _values(jscope, names), _values(tscope, names)
    for n in names:
        np.testing.assert_allclose(tv[n], jv[n], err_msg=n, **FP32_TOL)


def test_run_steps_stacked_feed_matches_distinct_batches():
    """A stacked feed of three batches == three run() calls with them,
    in the port; and the same final loss and parameters as the JAX
    package's stacked run_steps."""
    rng = np.random.RandomState(1)
    batches = [_feed(rng) for _ in range(3)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    (jm, jl, jexe, jscope), (tm, tl, texe, tscope), names = _both()
    (jlast,) = jexe.run_steps(jm, feed=stacked, n_steps=3,
                              fetch_list=[jl], scope=jscope,
                              stacked_feed=True)
    (tlast,) = texe.run_steps(tm, feed=stacked, n_steps=3,
                              fetch_list=[tl], scope=tscope,
                              stacked_feed=True)
    np.testing.assert_allclose(float(tlast), float(jlast), **FP32_TOL)
    jv, tv = _values(jscope, names), _values(tscope, names)
    for n in names:
        np.testing.assert_allclose(tv[n], jv[n], err_msg=n, **FP32_TOL)

    _, (tm2, tl2, texe2, tscope2), _ = _both()
    for b in batches:
        (seq_last,) = texe2.run(tm2, feed=b, fetch_list=[tl2],
                                scope=tscope2)
    assert float(seq_last) == float(tlast)
    sv = _values(tscope2, names)
    for n in names:
        np.testing.assert_array_equal(sv[n], tv[n], err_msg=n)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_run_steps_validates_inputs(pkg):
    """Both packages raise the same errors: n_steps < 1, n_steps not an
    int, a stacked feed without the leading axis, a CompiledProgram;
    n_steps=1 is the degenerate chain."""
    fluid = jfluid if pkg == "jax" else tfluid
    main, startup, loss = _build(fluid, with_dropout=False)
    feed = _feed(np.random.RandomState(2))
    scope = fluid.executor.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    with pytest.raises(ValueError, match="n_steps"):
        exe.run_steps(main, feed=feed, n_steps=0, fetch_list=[loss],
                      scope=scope)
    with pytest.raises(ValueError, match="n_steps must be an int"):
        exe.run_steps(main, feed=feed, n_steps=2.5, fetch_list=[loss],
                      scope=scope)
    with pytest.raises(ValueError, match="n_steps must be an int"):
        exe.run_steps(main, feed=feed, n_steps=True, fetch_list=[loss],
                      scope=scope)
    with pytest.raises(ValueError, match="leading"):
        exe.run_steps(main, feed=feed, n_steps=3, fetch_list=[loss],
                      scope=scope, stacked_feed=True)
    with pytest.raises(ValueError, match="CompiledProgram"):
        exe.run_steps(fluid.CompiledProgram(main), feed=feed, n_steps=2,
                      fetch_list=[loss], scope=scope)
    (one,) = exe.run_steps(main, feed=feed, n_steps=1, fetch_list=[loss],
                           scope=scope)
    assert np.isfinite(float(one))


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_run_steps_visible_to_compiled_for(pkg):
    """compiled_for lists the chain's handle beside the run() ones."""
    fluid = jfluid if pkg == "jax" else tfluid
    main, startup, loss = _build(fluid, with_dropout=False)
    feed = _feed(np.random.RandomState(4))
    scope = fluid.executor.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    exe.run_steps(main, feed=feed, n_steps=3, fetch_list=[loss],
                  scope=scope)
    handles = exe.compiled_for(main)
    chains = [h for h in handles if "chain" in h.label]
    assert len(chains) == 1 and len(handles) == 2
    assert exe.compiled_for(startup) and all(
        "chain" not in h.label for h in exe.compiled_for(startup))


def _samples(snap, name):
    fam = snap.get(name)
    return dict(fam["samples"]) if fam else {}


def _bookings(snap_before, snap_after):
    """pt_compile_cache_total {(path, result): count} and
    pt_step_seconds {path: count} booked between two snapshots."""
    cache = {}
    a, b = (_samples(snap_before, "pt_compile_cache_total"),
            _samples(snap_after, "pt_compile_cache_total"))
    for k, v in b.items():
        if v - a.get(k, 0.0):
            cache[k] = v - a.get(k, 0.0)
    steps = {}
    a, b = (_samples(snap_before, "pt_step_seconds"),
            _samples(snap_after, "pt_step_seconds"))
    for k, v in b.items():
        n = v["count"] - (a[k]["count"] if k in a else 0)
        if n:
            steps[k] = n
    return cache, steps


def test_same_calls_book_the_same_cache_and_step_metrics():
    """One call sequence — startup, two runs, a run at another batch, a
    chain twice — books the same pt_compile_cache_total{path,result}
    and pt_step_seconds{path} counts in both packages, and the port's
    steps land in its step-phase stats."""
    from paddle_tpu_torch.observability import profiling

    booked = {}
    for pkg, fluid, snap in (("jax", jfluid, jobs.REGISTRY.snapshot),
                             ("torch", tfluid, tmetrics.snapshot)):
        main, startup, loss = _build(fluid, with_dropout=False)
        scope = fluid.executor.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        rng = np.random.RandomState(5)
        before = snap()
        exe.run(startup, scope=scope)
        for batch in (16, 16, 8):
            exe.run(main, feed=_feed(rng, batch), fetch_list=[loss],
                    scope=scope)
        for _ in range(2):
            exe.run_steps(main, feed=_feed(rng), n_steps=2,
                          fetch_list=[loss], scope=scope)
        booked[pkg] = _bookings(before, snap())
    assert booked["torch"] == booked["jax"]
    cache, steps = booked["torch"]
    assert cache == {("single", "miss"): 3, ("single", "hit"): 1,
                     ("chain", "miss"): 1, ("chain", "hit"): 1}
    assert steps == {("single",): 4, ("chain",): 2}
    stats = profiling.signature_stats()
    assert any(s["lane"] == "chain" for s in stats.values())


def test_feed_shape_change_misses_the_cache():
    """A new batch size is a new signature (a graph replays only at the
    shapes it was captured at): its own plan, and its loss as the JAX
    package computes it at that batch."""
    (jm, jl, jexe, jscope), (tm, tl, texe, tscope), _ = _both()
    rng = np.random.RandomState(6)
    for batch in (16, 8):
        feed = _feed(rng, batch)
        (jv,) = jexe.run(jm, feed=feed, fetch_list=[jl], scope=jscope)
        (tv,) = texe.run(tm, feed=feed, fetch_list=[tl], scope=tscope)
        np.testing.assert_allclose(float(tv), float(jv), **FP32_TOL)
    keys = [k for k in texe._cache if isinstance(k[0], int)]
    assert len(texe.compiled_for(tm)) == 2
    shapes = sorted(s for k in keys for n, s, _ in k[2] if n == "x")
    assert shapes == [(8, 8), (16, 8)]
    # a feed of another dtype that coerces to the var's dtype is the
    # same signature
    feed = _feed(rng, 8)
    feed["x"] = feed["x"].astype(np.float64)
    texe.run(tm, feed=feed, fetch_list=[tl], scope=tscope)
    assert len(texe.compiled_for(tm)) == 2


def test_cpu_executor_never_captures():
    """A CPU place runs the eager loop whatever the switch says: no
    entry holds a graph."""
    main, startup, loss = _build(tfluid, with_dropout=True)
    scope = tfluid.Scope()
    old = tfluid.get_flags("FLAGS_cuda_graph_capture")
    tfluid.set_flags({"FLAGS_cuda_graph_capture": True})
    try:
        exe = tfluid.Executor(tfluid.CPUPlace())
    finally:
        tfluid.set_flags(old)
    assert exe.capture is False
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(np.random.RandomState(7)), fetch_list=[loss],
            scope=scope)
    assert all(h.graph is None for h in exe.compiled_for(main))


def test_step_event_is_emitted(tmp_path):
    """With FLAGS_event_log_dir set, every run emits the reference's
    ``step`` event (path, seconds, first_run)."""
    from paddle_tpu_torch.observability import events

    tfluid.set_flags({"FLAGS_event_log_dir": str(tmp_path)})
    try:
        events.configure()
        main, startup, loss = _build(tfluid, with_dropout=False)
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        exe.run(main, feed=_feed(np.random.RandomState(8)),
                fetch_list=[loss], scope=scope)
        path = events.get_log().path
    finally:
        tfluid.set_flags({"FLAGS_event_log_dir": ""})
        events.configure()
    recs = [r for r in events.read_events(path) if r["event"] == "step"]
    assert [(r["path"], r["first_run"]) for r in recs] == [
        ("single", True), ("single", True)]
    assert all(r["seconds"] >= 0 and r["pid"] for r in recs)


def test_graph_cache_holds_the_most_recently_run(monkeypatch):
    """An executor holds the graphs of its MAX_GRAPHS most recently run
    signatures and drops the least recently run one's beyond that
    (stand-in graphs: a CPU place captures none)."""
    from paddle_tpu_torch.fluid import executor as ex

    class Sig:
        graph = None

    monkeypatch.setattr(ex, "MAX_GRAPHS", 3)
    exe = tfluid.Executor(tfluid.CPUPlace())
    sigs = [Sig() for _ in range(5)]
    for s in sigs:
        s.graph = object()
        exe._hold(s)
    assert [s.graph is not None for s in sigs] == [False, False, True,
                                                   True, True]
    exe._hold(sigs[2])      # run again: now the most recent
    sigs[0].graph = object()
    exe._hold(sigs[0])      # captured again: sigs[3] goes
    assert [s.graph is not None for s in sigs] == [True, False, True,
                                                   False, True]
    sigs[4].graph = None    # a signature that lost its graph
    exe._hold(sigs[4])
    assert list(exe._graphs.values()) == [sigs[2], sigs[0]]
