"""The port's serving fleet against the JAX package's: the FaultPlan
grammar and its hooks, RetryPolicy, the circuit breaker and the Router
over fake replicas (the JAX package's router scenarios, run through
both routers: the same results, exception types, breaker states and
``pt_serve_*`` metric deltas), the metric families both book, the HTTP
Frontend (error mapping, drain order, SIGTERM in a child), the drain
handler, the Engine's spans and phases, and the hedge drill.  No device
programs beyond tiny CPU engines."""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import concurrent.futures
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu.distributed.fault_injection as j_fault
import paddle_tpu.distributed.resilience as j_res
import paddle_tpu.observability as j_obs
import paddle_tpu.serving.errors as j_err
import paddle_tpu.serving.frontend as j_front
import paddle_tpu.serving.router as j_router
import paddle_tpu_torch.distributed.fault_injection as t_fault
import paddle_tpu_torch.distributed.resilience as t_res
import paddle_tpu_torch.observability as t_obs
import paddle_tpu_torch.serving.errors as t_err
import paddle_tpu_torch.serving.frontend as t_front
import paddle_tpu_torch.serving.router as t_router
from paddle_tpu_torch import fluid
from paddle_tpu_torch.distributed import elastic
from paddle_tpu_torch.serving import drill

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")


def _pkg(router, fault, res, err, obs, front):
    return types.SimpleNamespace(
        Router=router.Router, CircuitBreaker=router.CircuitBreaker,
        routerz=router.routerz_payload, fault=fault,
        RetryPolicy=res.RetryPolicy, Overload=err.ServingOverloadError,
        err=err, obs=obs, front=front)


PKGS = {"jax": _pkg(j_router, j_fault, j_res, j_err, j_obs, j_front),
        "torch": _pkg(t_router, t_fault, t_res, t_err, t_obs, t_front)}


@pytest.fixture(autouse=True)
def _no_fault_plan():
    yield
    j_fault.uninstall()
    t_fault.uninstall()


def _wait_for(pred, timeout=5.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.002)


def _outcome(fn, *a, **kw):
    try:
        return ("ok", fn(*a, **kw))
    except Exception as e:
        return (type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# fault grammar, RetryPolicy
# ---------------------------------------------------------------------------

SPECS = [
    "serve_error:m:req:2;serve_delay:n:req:1:5;replica_kill:step:3;"
    "replica_kill:r0:step:7",
    "serve_error:m:req:2", "serve_error:send_grad:req:1",
    "serve_error:a:req:1", "serve_error:r0:req:2", "replica_kill:r0:step:3",
    "drop:send_grad:3;delay:get_param:2:0.01;error:send_barrier:1;"
    "kill:round:5",
    "drop:*:1", "drop:get_param:2", "flaky:send_grad:0.3:7",
    "preempt:step:4;preempt:round:2;join:step:6;leave:round:3;kill:step:9",
    "preempt:step:2", "join:step:2;leave:step:3", "kill:step:1",
    "kill:round:4", "nan:grad:step:4;inf:loss:step:2;"
    "spike:loss:step:7:250;drop:send_grad:1",
    "nan:grad:step:2;spike:loss:step:5", "nan:grad:step:2",
    "drill:preempt+restore:step:4;drill:kill+restore:round:6:pserver0",
    " ; serve_error:*:req:1 ;", "",
    # invalid
    "serve_error:m:2", "replica_kill:banana", "explode:everything",
    "join:step", "kill:banana:3", "preempt:banana:1", "drop:x",
    "delay:x:1", "flaky:x:0.5", "nan:grad:4", "drill:boom:step:1",
    "serve_delay:m:req:1", "replica_kill:r0:round:2", "drop:x:notanint",
]


def _parse(fault, spec):
    p = fault.FaultPlan(spec)
    return ([(r.action, r.cmd, r.n, r.arg) for r in p.rules],
            p.drill_rules(), p.numeric_rules())


@pytest.mark.parametrize("spec", SPECS)
def test_fault_spec_parses_as_jax(spec):
    assert _outcome(_parse, t_fault, spec) == _outcome(_parse, j_fault, spec)


def _fire(fault, spec, calls):
    """Drive a plan through a call sequence; record each call's outcome
    (the raised type's name and its bases' names)."""
    plan = fault.FaultPlan(spec)
    hooks = []
    fault.set_membership_hooks(join=lambda k: hooks.append(("join", k)),
                               leave=lambda k: hooks.append(("leave", k)))
    out = []
    try:
        for hook, *args in calls:
            try:
                getattr(plan, hook)(*args)
                out.append("pass")
            except Exception as e:
                out.append((type(e).__name__,
                            sorted(c.__name__ for c in type(e).__mro__
                                   if c.__name__.startswith(("Inject",
                                                             "Fault",
                                                             "PS")))))
    finally:
        fault.set_membership_hooks()
    return out, hooks


FIRE_CASES = [
    ("serve_error:m:req:2", [("on_serve", "m")] * 3 + [("on_serve", "o")]),
    ("serve_error:*:req:1;serve_delay:m:req:2:1",
     [("on_serve", "m"), ("on_serve", "m"), ("on_serve", "n")]),
    ("replica_kill:r0:step:3", [("on_replica_step", "r0", 2),
                                ("on_replica_step", "r1", 3),
                                ("on_replica_step", "r0", 3)]),
    ("replica_kill:step:2", [("on_replica_step", "a", 1),
                             ("on_replica_step", "b", 2)]),
    ("serve_error:send_grad:req:1", [("on_rpc", "send_grad")]),
    ("drop:send_grad:3;delay:get_param:2:0.001;error:send_barrier:1",
     [("on_rpc", "send_grad")] * 4 + [("on_rpc", "get_param")] * 2
     + [("on_rpc", "send_barrier")] * 2),
    ("drop:*:1", [("on_rpc", "a"), ("on_rpc", "a"), ("on_rpc", "b")]),
    ("flaky:send_grad:0.4:11", [("on_rpc", "send_grad")] * 20),
    ("join:step:2;leave:round:3", [("on_step", 1), ("on_step", 2),
                                   ("on_round", 3), ("on_round", 4)]),
    ("nan:grad:step:2", [("on_step", 2), ("on_rpc", "x")]),
]


@pytest.mark.parametrize("spec,calls", FIRE_CASES,
                         ids=[c[0] for c in FIRE_CASES])
def test_fault_hooks_fire_as_jax(spec, calls):
    got = _fire(t_fault, spec, calls)
    assert got == _fire(j_fault, spec, calls)
    assert any(o != "pass" for o in got[0]) or got[1] or \
        spec.startswith(("serve_error:send", "nan", "flaky"))


def test_fault_module_hooks_match_jax():
    for fault in (j_fault, t_fault):
        fault.install("replica_kill:x:step:1")
        with pytest.raises(fault.InjectedReplicaDeath):
            fault.on_replica_step("x", 1)
        fault.on_serve("x")
        fault.uninstall()
        assert fault.active() is None
        fault.on_replica_step("x", 1)  # no plan: no-op
    assert issubclass(t_fault.InjectedServeError, t_fault.FaultInjected)
    assert issubclass(t_fault.FaultInjected, IOError)


@pytest.mark.parametrize("kw", [
    dict(times=3, backoff_ms=10, seed=1),
    dict(times=5, backoff_ms=100, multiplier=3.0, max_backoff_ms=700,
         jitter=0.5, seed=42),
    dict(times=0, backoff_ms=1, seed=0),
    dict(times=4, backoff_ms=1, jitter=0.0, seed=9)])
def test_retry_policy_delays_match_jax(kw):
    j, t = j_res.RetryPolicy(**kw), t_res.RetryPolicy(**kw)
    assert t.delays() == j.delays()
    assert [t.delay(a) for a in range(6)] == [j.delay(a) for a in range(6)]
    assert [t.should_retry(a) for a in range(7)] == \
        [j.should_retry(a) for a in range(7)]


def test_retry_policy_flag_defaults_match_jax():
    j, t = j_res.RetryPolicy(seed=3), t_res.RetryPolicy(seed=3)
    assert (t.times, t.backoff_ms, t.delays()) == \
        (j.times, j.backoff_ms, j.delays())


def test_resilience_stats_keys_match_jax():
    # other tests of this worker may have booked events of their own in
    # either package's process-wide counters: compare the keys every
    # snapshot carries, and a recorded event's count
    assert t_res._KNOWN == j_res._KNOWN
    t_res.record("router_probe_errors", 2)
    t, j = t_res.resilience_stats(), j_res.resilience_stats()
    assert set(j_res._KNOWN) <= set(t) and set(j_res._KNOWN) <= set(j)
    assert t["router_probe_errors"] >= 2


# ---------------------------------------------------------------------------
# fakes: duck-typed replicas raising the package's own typed errors
# ---------------------------------------------------------------------------


def _fake_decode(pkg, name, load=0):
    class FakeDecodeEngine:
        def __init__(self):
            self.name = name
            self._load = load
            self._healthy = True
            self.requests = []

        def healthy(self):
            return self._healthy

        def load(self):
            return self._load

        def kill(self):
            self._healthy = False
            for req in self.requests:
                if not req.future.done():
                    req.future.set_exception(pkg.Overload(
                        f"{self.name} scheduler died",
                        reason="scheduler_failed"))

        def submit_request(self, prompt, max_new_tokens, eos_id=None,
                           tenant="default", prefix=None):
            if not self._healthy:
                raise pkg.Overload(f"{self.name} scheduler died",
                                   reason="scheduler_failed")
            req = types.SimpleNamespace(
                prompt=list(prompt), max_new_tokens=max_new_tokens,
                prefix=list(prefix or []), generated=list(prefix or []),
                future=concurrent.futures.Future())
            self.requests.append(req)
            return req

    return FakeDecodeEngine()


def _fake_engine(name, load=0):
    class FakeEngine:
        def __init__(self):
            self.name = name
            self._load = load
            self._closed = False
            self.submits = []

        def submit(self, model, feed, tenant="default"):
            fut = concurrent.futures.Future()
            self.submits.append((model, fut))
            return fut

    return FakeEngine()


def _router(pkg, replicas, **kw):
    kw.setdefault("retry", pkg.RetryPolicy(times=2, backoff_ms=1,
                                           jitter=0.0, seed=0))
    kw.setdefault("hedge_ms", 0)
    kw.setdefault("auto_probe", False)
    return pkg.Router(replicas, **kw)


_ROUTER_FAMILIES = ("pt_serve_failovers_total", "pt_serve_recovery_seconds",
                    "pt_serve_hedges_total", "pt_serve_breaker_state",
                    "pt_serve_router_retries_total")


def _router_metrics(pkg, rname):
    """This router's series of the five router families: counter and
    gauge values, histogram counts."""
    out = {}
    snap = pkg.obs.snapshot()
    for fam in _ROUTER_FAMILIES:
        f = snap.get(fam)
        if not f:
            continue
        for key, v in f["samples"].items():
            if key[0] != rname:
                continue
            out[(fam,) + key] = v["count"] if isinstance(v, dict) else v
    return out


def _delta(before, after):
    return {k: v - before.get(k, 0) if not k[0].endswith("_state") else v
            for k, v in after.items() if v != before.get(k, 0)
            or k[0].endswith("_state")}


# ---------------------------------------------------------------------------
# the JAX package's router scenarios, each run through both routers
# ---------------------------------------------------------------------------


def sc_breaker_trip_halfopen_close(pkg, rec):
    t = [0.0]
    b = pkg.CircuitBreaker(failures=3, cooldown_ms=1000, clock=lambda: t[0])
    rec.append((b.state, b.allow()))
    for _ in range(3):
        b.record_failure()
        rec.append(b.state)
    for now in (0.9, 1.0):
        t[0] = now
        rec.append(b.allow())
    rec += [b.state, b.state_name(), b.allow()]
    b.record_success()
    rec += [b.state, b.allow()]


def sc_breaker_halfopen_probe_failure_reopens(pkg, rec):
    t = [0.0]
    b = pkg.CircuitBreaker(failures=1, cooldown_ms=500, clock=lambda: t[0])
    b.record_failure()
    rec.append(b.state)
    t[0] = 0.6
    rec.append(b.allow())
    b.record_failure()
    rec += [b.state, b.allow()]
    t[0] = 1.2
    rec.append(b.allow())
    b.trip()
    rec.append(b.state_name())


def sc_breaker_success_resets(pkg, rec):
    b = pkg.CircuitBreaker(failures=2, cooldown_ms=1000)
    b.record_failure()
    b.record_success()
    b.record_failure()
    rec.append(b.state)


def sc_least_loaded_pick_and_held(pkg, rec, rname):
    a, b = _fake_decode(pkg, "a", 3), _fake_decode(pkg, "b", 1)
    with _router(pkg, [a, b], name=rname) as router:
        fut = router.submit([1, 2], 4)
        rec.append((len(a.requests), len(b.requests)))
        router.set_held("b", True)
        fut2 = router.submit([1, 2], 4)
        rec.append((len(a.requests), len(b.requests)))
        router.set_held("b", False)
        rec.append(_outcome(router.set_held, "nope", True)[0])
        a.requests[0].future.set_result([7])
        b.requests[0].future.set_result([7])
        rec += [fut.result(5), fut2.result(5)]
        rec.append(router.stats())


def sc_duplicate_replica_name_rejected(pkg, rec, rname):
    with _router(pkg, [_fake_decode(pkg, "a")], name=rname) as router:
        rec.append(_outcome(router.add_replica, _fake_decode(pkg, "a")))


def sc_no_replicas_is_typed(pkg, rec, rname):
    with _router(pkg, [], name=rname) as router:
        rec.append(_outcome(router.submit, [1], 4))
        rec.append(_outcome(router.submit_feed, "m", {"x": 1}))


def sc_probe_trips_breaker_of_dead_replica(pkg, rec, rname):
    a, b = _fake_decode(pkg, "a"), _fake_decode(pkg, "b")
    with _router(pkg, [a, b], name=rname) as router:
        a._healthy = False
        router.probe_once()
        rec.append([(r.name, r.breaker.state) for r in router.replicas()])
        rec.append([r["name"] for r in pkg.routerz()["routers"][0][
            "replicas"]] if pkg.routerz()["routers"] else None)


def sc_decode_failover_resumes_from_prefix(pkg, rec, rname):
    a, b = _fake_decode(pkg, "a"), _fake_decode(pkg, "b", 5)
    with _router(pkg, [a, b], name=rname) as router:
        fut = router.submit([1, 2, 3], 8)
        (req,) = a.requests
        req.generated = [10, 11, 12]
        a.kill()
        _wait_for(lambda: b.requests, msg="failover re-dispatch")
        (resumed,) = b.requests
        rec.append((resumed.prompt, resumed.prefix, resumed.max_new_tokens))
        resumed.generated = [10, 11, 12, 13]
        resumed.future.set_result(list(resumed.generated))
        rec.append(fut.result(5))
        rec.append({k: v for k, v in router.stats().items()})


def sc_decode_failover_exhaustion(pkg, rec, rname):
    a, b = _fake_decode(pkg, "a"), _fake_decode(pkg, "b", 5)
    with _router(pkg, [a, b], name=rname) as router:
        fut = router.submit([1], 4)
        a.kill()
        _wait_for(lambda: b.requests, msg="first failover")
        b.kill()
        rec.append(_outcome(fut.result, 10)[0])
        rec.append(router.stats()["failovers"])


def sc_dispatch_edge_death_skips_to_survivor(pkg, rec, rname):
    a, b = _fake_decode(pkg, "a"), _fake_decode(pkg, "b", 5)

    def _raise(*args, **kw):
        raise pkg.Overload("a scheduler died", reason="scheduler_failed")

    a.submit_request = _raise
    with _router(pkg, [a, b], name=rname) as router:
        fut = router.submit([1], 4)
        (req,) = b.requests
        req.future.set_result([5])
        rec += [fut.result(5), router.stats()["retries"]]
        rec.append([(r.name, r.breaker.state) for r in router.replicas()])


def sc_retry_budget_exhaustion(pkg, rec, rname):
    eng = _fake_decode(pkg, "a")

    def _reject(*a, **kw):
        raise pkg.Overload("queue full", reason="overload")

    eng.submit_request = _reject
    with _router(pkg, [eng], name=rname) as router:
        fut = router.submit([1], 4)
        rec.append(_outcome(fut.result, 5))
        rec.append(router.stats()["retries"])


def sc_retry_succeeds_after_transient(pkg, rec, rname):
    eng = _fake_decode(pkg, "a")
    real, calls = eng.submit_request, []

    def _flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise pkg.Overload("queue full", reason="overload")
        return real(*a, **kw)

    eng.submit_request = _flaky
    with _router(pkg, [eng], name=rname,
                 retry=pkg.RetryPolicy(times=3, backoff_ms=1, jitter=0.0,
                                       seed=0)) as router:
        fut = router.submit([1], 4)
        _wait_for(lambda: eng.requests, msg="retry re-dispatch")
        eng.requests[0].future.set_result([9])
        rec += [fut.result(5), router.stats()["retries"]]


def sc_hedge_win_cancels_primary(pkg, rec, rname):
    slow, fast = _fake_engine("slow"), _fake_engine("fast", 5)
    with _router(pkg, [slow, fast], name=rname, hedge_ms=5) as router:
        fut = router.submit_feed("m", {"x": 1})
        (model, primary), = slow.submits
        _wait_for(lambda: fast.submits, msg="hedge fire")
        (_, hedge), = fast.submits
        hedge.set_result({"y": 2})
        rec.append(fut.result(5))
        _wait_for(primary.cancelled, msg="loser cancellation")
        rec += [model, router.hedge_stats()]


def sc_hedge_lose_cancels_hedge(pkg, rec, rname):
    slow, fast = _fake_engine("slow"), _fake_engine("fast", 5)
    with _router(pkg, [slow, fast], name=rname, hedge_ms=5) as router:
        fut = router.submit_feed("m", {"x": 1})
        (_, primary), = slow.submits
        _wait_for(lambda: fast.submits, msg="hedge fire")
        (_, hedge), = fast.submits
        primary.set_result({"y": 1})
        rec.append(fut.result(5))
        _wait_for(hedge.cancelled, msg="hedge cancellation")
        rec.append(router.hedge_stats())


def sc_no_hedge_without_second_replica(pkg, rec, rname):
    only = _fake_engine("only")
    with _router(pkg, [only], name=rname, hedge_ms=1) as router:
        fut = router.submit_feed("m", {"x": 1})
        time.sleep(0.05)
        (_, primary), = only.submits
        primary.set_result({"y": 3})
        rec += [fut.result(5), router.hedge_stats()]


def sc_hedge_adaptive_no_history(pkg, rec, rname):
    a, b = _fake_engine("a"), _fake_engine("b", 5)
    with _router(pkg, [a, b], name=rname, hedge_ms=-1) as router:
        fut = router.submit_feed("m", {"x": 1})
        time.sleep(0.05)
        rec.append(len(b.submits))
        a.submits[0][1].set_result({})
        rec += [fut.result(5), router.stats()["hedge_ms"]]


def sc_feed_error_propagates(pkg, rec, rname):
    a = _fake_engine("a")
    with _router(pkg, [a], name=rname) as router:
        fut = router.submit_feed("m", {"x": 1})
        a.submits[0][1].set_exception(pkg.err.FeedValidationError("bad"))
        rec.append(_outcome(fut.result, 5)[0])
        rec.append([(r.name, r.breaker.state) for r in router.replicas()])


def sc_routes_around_injected_dispatch_error(pkg, rec, rname):
    a, b = _fake_decode(pkg, "a"), _fake_decode(pkg, "b", 5)
    pkg.fault.install("serve_error:a:req:1")
    with _router(pkg, [a, b], name=rname) as router:
        fut = router.submit([1], 4)
        (req,) = b.requests
        req.future.set_result([4])
        rec += [fut.result(5), len(a.requests)]
        rec.append([(r.name, r.breaker.state) for r in router.replicas()])


SCENARIOS = {k[3:]: v for k, v in sorted(globals().items())
             if k.startswith("sc_")}
_BREAKER_ONLY = ("breaker_trip_halfopen_close",
                 "breaker_halfopen_probe_failure_reopens",
                 "breaker_success_resets")


def _run_scenario(pkg, name):
    rec = []
    rname = f"parity-{name}"
    before = _router_metrics(pkg, rname)
    if name in _BREAKER_ONLY:
        SCENARIOS[name](pkg, rec)
    else:
        SCENARIOS[name](pkg, rec, rname)
    rec.append(_delta(before, _router_metrics(pkg, rname)))
    pkg.fault.uninstall()
    return rec


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_router_scenario_matches_jax(name):
    got = _run_scenario(PKGS["torch"], name)
    assert got == _run_scenario(PKGS["jax"], name)


def test_router_scenarios_book_each_family():
    """The scenarios above move all five router families."""
    booked = set()
    for name in ("decode_failover_resumes_from_prefix",
                 "hedge_win_cancels_primary", "retry_budget_exhaustion",
                 "probe_trips_breaker_of_dead_replica"):
        booked |= {k[0] for k in _run_scenario(PKGS["torch"], name)[-1]}
    assert booked == set(_ROUTER_FAMILIES)


# ---------------------------------------------------------------------------
# metric families
# ---------------------------------------------------------------------------

_DECODE_FAMILIES = (
    "pt_decode_tokens_total", "pt_decode_step_seconds",
    "pt_decode_phase_seconds_total", "pt_decode_prefill_chunks_total",
    "pt_decode_slot_occupancy", "pt_decode_kv_pages_in_use",
    "pt_decode_evictions_total", "pt_decode_queue_depth",
    "pt_serve_request_latency_seconds", "pt_serve_requests_total",
    "pt_serve_rejected_total")


def _schema(obs, names):
    snap = obs.snapshot()
    return {n: (snap[n]["type"], tuple(snap[n]["label_names"]))
            for n in names if n in snap}


def test_metric_families_match_jax():
    from test_torch_port_reqtrace import _rest_engines

    for name in ("decode_failover_resumes_from_prefix",
                 "hedge_win_cancels_primary", "retry_budget_exhaustion",
                 "probe_trips_breaker_of_dead_replica"):
        for pkg in PKGS.values():
            _run_scenario(pkg, name)
    j, t = _rest_engines()
    try:
        for eng in (j, t):  # a typed rejection books the shared family
            eng.close()
            with pytest.raises(Exception):
                eng.submit([1], 1)
        names = _ROUTER_FAMILIES + _DECODE_FAMILIES
        ts, js = _schema(t_obs, names), _schema(j_obs, names)
        assert ts == js
        assert set(ts) == set(names)
    finally:
        j.close()
        t.close()


# ---------------------------------------------------------------------------
# frontend
# ---------------------------------------------------------------------------


def _fake_backend():
    class FakeBackend:
        def __init__(self):
            self.drained = []
            self.gate = None

        def submit(self, prompt, max_new_tokens, eos_id=None,
                   tenant="default"):
            if self.gate is not None:
                return self.gate
            fut = concurrent.futures.Future()
            fut.set_result([int(t) + 1 for t in prompt][:max_new_tokens])
            return fut

        def stats(self):
            return {"router": "fake", "replicas": []}

    return FakeBackend()


def _post(url, payload=None, timeout=10, raw=None):
    req = urllib.request.Request(
        url, data=raw if raw is not None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, timeout=10):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _typed_errors(err):
    return [err.ServingOverloadError("full", reason="overload"),
            err.ServingOverloadError("bye", reason="draining"),
            err.ServingOverloadError("shut", reason="closed"),
            err.ServingOverloadError("t", reason="tenant_quota"),
            err.ServingDeadlineError("late"),
            err.FeedValidationError("bad feed"),
            err.ModelNotLoadedError("no such model"),
            ValueError("bad"), RuntimeError("boom"),
            err.PoolExhaustedError("pool")]


def test_frontend_error_table_matches_jax():
    got = [(t_front._error_status(e), t_front._error_body(e))
           for e in _typed_errors(t_err)]
    want = [(j_front._error_status(e), j_front._error_body(e))
            for e in _typed_errors(j_err)]
    assert got == want
    assert [g[0] for g in got] == [429, 503, 503, 429, 504, 400, 404, 400,
                                   500, 500]


def _frontend_cases(pkg):
    """Status and body (less the per-request trace id and latency) of
    each request of the JAX package's frontend tests."""
    out = []

    def scrub(resp):
        code, body = resp
        return code, {k: v for k, v in body.items()
                      if k not in ("trace", "latency_s")}

    for exc in _typed_errors(pkg.err)[:9]:
        be = _fake_backend()

        def _raise(*a, exc=exc, **kw):
            raise exc

        be.submit = _raise
        with pkg.front.Frontend(be) as fe:
            out.append(scrub(_post(f"http://{fe.host}:{fe.port}/v1/generate",
                                   {"prompt": [1], "max_new_tokens": 1})))
    with pkg.front.Frontend(_fake_backend()) as fe:
        base = f"http://{fe.host}:{fe.port}"
        out.append(_get(f"{base}/healthz"))
        out.append(_get(f"{base}/routerz"))
        out.append(_get(f"{base}/nope"))
        out.append(scrub(_post(f"{base}/v1/generate",
                               {"prompt": [1, 2, 3], "max_new_tokens": 2})))
        out.append(scrub(_post(f"{base}/v1/generate", {"prompt": []})))
        out.append(scrub(_post(f"{base}/v1/infer", {"model": "m"})))
        out.append(scrub(_post(f"{base}/v1/infer", {"model": "m",
                                                    "feed": {"x": [1]}})))
        out.append(scrub(_post(f"{base}/nope", {})))
        out.append(scrub(_post(f"{base}/v1/generate", raw=b"not json{{")))
        out.append(scrub(_post(f"{base}/v1/generate", raw=b"[1, 2]")))
        code, body = _post(f"{base}/v1/generate",
                           {"prompt": [4], "max_new_tokens": 1})
        out.append((code, body["tokens"], isinstance(body["trace"], str)))
        out.append(fe.stats()["inflight"])
    return out


def test_frontend_requests_match_jax():
    got = _frontend_cases(PKGS["torch"])
    assert got == _frontend_cases(PKGS["jax"])
    assert got[12][1]["tokens"] == [2, 3]


def test_frontend_drain_finishes_inflight_then_closes():
    """Drain under an open connection: the in-flight request gets its
    200, new admissions a typed 503, and only then the listener
    closes."""
    backend = _fake_backend()
    backend.gate = concurrent.futures.Future()

    class DrainRecorder:
        name = "rec"

        def drain(self, timeout=None):
            backend.drained.append(time.monotonic())

    backend.replicas = lambda: [types.SimpleNamespace(
        engine=DrainRecorder())]
    fe = t_front.Frontend(backend)
    base = f"http://{fe.host}:{fe.port}"
    got, drained_ok = {}, {}
    t = threading.Thread(target=lambda: got.setdefault("resp", _post(
        f"{base}/v1/generate", {"prompt": [5], "max_new_tokens": 4})),
        daemon=True)
    t.start()
    _wait_for(lambda: fe.stats()["inflight"] == 1, msg="request in flight")
    dt = threading.Thread(target=lambda: drained_ok.setdefault(
        "ok", fe.drain(timeout=10)), daemon=True)
    dt.start()
    _wait_for(lambda: backend.drained, msg="engine drain call")
    code, body = _post(f"{base}/v1/generate",
                       {"prompt": [1], "max_new_tokens": 1})
    assert code == 503 and body["reason"] == "draining"
    code, body = _get(f"{base}/healthz")
    assert code == 503 and body["draining"] is True
    assert not fe.stats()["closed"]  # listener up for the response
    backend.gate.set_result([6, 7])
    t.join(timeout=10)
    dt.join(timeout=10)
    assert got["resp"][0] == 200 and got["resp"][1]["tokens"] == [6, 7]
    assert drained_ok["ok"] is True and fe.stats()["closed"]
    assert fe.drain(timeout=1) is True  # idempotent
    fe.close()


_SIGTERM_CHILD = r"""
import concurrent.futures, json, threading, time, urllib.request, os, signal
from paddle_tpu_torch.serving.frontend import Frontend

class Backend:
    def submit(self, prompt, max_new_tokens, eos_id=None, tenant="default"):
        fut = concurrent.futures.Future()
        # resolve AFTER the SIGTERM lands: the drain must wait for us
        threading.Timer(0.4, fut.set_result, args=([42],)).start()
        return fut

fe = Frontend(Backend())
fe.install_drain(timeout=10, poll_s=0.02)
out = {}
def client():
    req = urllib.request.Request(
        f"http://{fe.host}:{fe.port}/v1/generate",
        data=json.dumps({"prompt": [1], "max_new_tokens": 1}).encode())
    with urllib.request.urlopen(req, timeout=10) as resp:
        out["body"] = json.loads(resp.read())
t = threading.Thread(target=client)
t.start()
while fe.stats()["inflight"] < 1:
    time.sleep(0.005)
os.kill(os.getpid(), signal.SIGTERM)  # drain, not drop
t.join(timeout=10)
print("CHILD_RESULT " + json.dumps(out.get("body")), flush=True)
"""


def test_frontend_sigterm_drain_completes_inflight_subprocess():
    """SIGTERM during an open HTTP connection: the in-flight generation
    finishes and its response is written before the handler chain
    re-delivers the signal (the port's counterpart of the JAX package's
    test of the same name)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", _SIGTERM_CHILD], capture_output=True,
        text=True, timeout=120, env=env, cwd=REPO)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("CHILD_RESULT ")]
    assert lines, (proc.stdout, proc.stderr)
    body = json.loads(lines[0][len("CHILD_RESULT "):])
    assert body["tokens"] == [42]
    assert proc.returncode in (0, -signal.SIGTERM), proc.returncode


# ---------------------------------------------------------------------------
# drain handler
# ---------------------------------------------------------------------------


def test_drain_handler_chains_and_redelivers(monkeypatch, tmp_path):
    import paddle_tpu.distributed.elastic as j_elastic

    monkeypatch.setenv(elastic.DRAIN_MARKER_ENV, str(tmp_path))
    for mod in (j_elastic, elastic):
        seen = []
        prev = signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
        try:
            h = mod.DrainHandler(signals=(signal.SIGUSR1,)).install()
            os.kill(os.getpid(), signal.SIGUSR1)
            _wait_for(h.requested.is_set, msg="drain request")
            assert seen == []  # deferred, not chained inline
            h.finish()
            _wait_for(lambda: seen, msg="re-delivered signal")
            assert seen == [signal.SIGUSR1]
            assert (tmp_path / f"drained.{os.getpid()}").read_text() == \
                f"signum={int(signal.SIGUSR1)}\n"
            h.finish()  # once only
            assert seen == [signal.SIGUSR1]
        finally:
            signal.signal(signal.SIGUSR1, prev)
        os.remove(tmp_path / f"drained.{os.getpid()}")
    assert elastic.drain_requested() is (elastic.current_drain() is not None
                                         and elastic.current_drain()
                                         .requested.is_set())


# ---------------------------------------------------------------------------
# the Engine: spans, phases, /servez, process drain, /v1/infer
# ---------------------------------------------------------------------------


def _save_mlp(dirname, feature=8, classes=4):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[feature], dtype="float32")
        h = fluid.layers.fc(x, size=16, act="relu")
        pred = fluid.layers.fc(h, size=classes, act="softmax")
    startup.random_seed = 5
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(str(dirname), ["x"], [pred], exe,
                                  main_program=main, scope=scope)
    return str(dirname)


def _engine(model_dir, name, **kw):
    from paddle_tpu_torch import serving

    eng = serving.Engine({"m": model_dir}, batch_buckets=[1, 2, 4],
                         name=name, auto_start=False,
                         place=fluid.CPUPlace(), **kw)
    eng.warmup()
    return eng.start()


def test_engine_spans_phases_and_servez(tmp_path):
    from paddle_tpu_torch.observability import profiling, reqtrace
    from paddle_tpu_torch.serving import status

    eng = _engine(_save_mlp(tmp_path / "m"), "spans")
    try:
        assert eng in status.live_engines()
        # the serve lane books each batch under its model's name
        before = profiling.signature_stats().get("m", {}).get("steps", 0)
        root = reqtrace.start_request("infer")
        xb = np.ones((2, 8), np.float32)
        with reqtrace.attach(root):
            fut = eng.submit("m", {"x": xb})
        fut.result(30)
        root.finish("ok")
        (trace,) = [t for t in reqtrace.completed()
                    if t["trace_id"] == root.trace_id]
        kinds = {s["kind"]: s for s in trace["spans"]}
        assert kinds["serve"]["name"] == "serve:m"
        assert kinds["serve"]["parent_id"] == root.span_id
        assert kinds["serve"]["links"] == [kinds["batch"]["span_id"]]
        assert kinds["batch"]["attrs"]["rows"] == 2
        assert "queue_wait_s" in kinds["serve"]["attrs"]
        # a direct caller's request is a trace of its own
        eng.infer("m", {"x": xb[:1]}, timeout=30)
        assert reqtrace.completed(1)[0]["name"] == "serve:m"
        stats = profiling.signature_stats()["m"]
        assert stats["steps"] == before + 2 and stats["lane"] == "serve"
    finally:
        eng.close()
    assert eng not in status.live_engines()


def test_engine_lane_turns_process_drain_into_drain(tmp_path, monkeypatch):
    from paddle_tpu_torch.serving import ServingOverloadError

    eng = _engine(_save_mlp(tmp_path / "m"), "pdrain", max_wait_ms=2000)
    try:
        fut = eng.submit("m", {"x": np.ones((1, 8), np.float32)})
        monkeypatch.setattr(elastic, "drain_requested", lambda: True)
        with eng._lanes["m"]._cv:
            eng._lanes["m"]._cv.notify_all()
        with pytest.raises(ServingOverloadError) as e:
            fut.result(10)
        assert e.value.reason == "draining"
        with pytest.raises(ServingOverloadError) as e:
            eng.submit("m", {"x": np.ones((1, 8), np.float32)})
        assert e.value.reason == "draining"
    finally:
        eng.close()


def test_frontend_infer_and_generate_over_port_engines(tmp_path):
    """/v1/infer through a Router to a tiny port Engine equals a direct
    infer bit for bit; /v1/generate through the same Router to a tiny
    port DecodeEngine equals its direct generate."""
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import DecodeEngine, Frontend, Router

    eng = _engine(_save_mlp(tmp_path / "m"), "fe-infer")
    cfg = gpt.GPTConfig.tiny(num_layers=1)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        gpt.build_gpt_decode_step(cfg, 2, 9, 4, 8)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    dec = DecodeEngine(cfg, scope=scope, place=fluid.CPUPlace(),
                       pool_slots=2, page_size=4, prefill_chunk=4,
                       max_len=16, auto_start=False, name="fe-dec")
    dec.warmup()
    dec.start()
    router = Router([dec, eng], name="fe-router", hedge_ms=0)
    fe = Frontend(router)
    try:
        base = f"http://{fe.host}:{fe.port}"
        xb = np.random.RandomState(0).randn(3, 8).astype(np.float32)
        code, body = _post(f"{base}/v1/infer",
                           {"model": "m", "feed": {"x": xb.tolist()}})
        assert code == 200, body
        (name,) = body["outputs"]
        want = eng.infer("m", {"x": xb}, timeout=30)[name]
        got = np.asarray(body["outputs"][name], np.float32)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        prompts = [[5, 6, 7], [9, 1]]
        want = dec.generate(prompts, max_new_tokens=5, timeout=60)
        for p, w in zip(prompts, want):
            code, body = _post(f"{base}/v1/generate",
                               {"prompt": p, "max_new_tokens": 5})
            assert code == 200 and body["tokens"] == w
        code, body = _get(f"{base}/routerz")
        assert [r["name"] for r in body["replicas"]] == ["fe-dec", "fe-infer"]
    finally:
        fe.close()
        router.close()
        dec.close()
        eng.close()


def test_hedge_drill_on_cpu():
    r = drill.hedge_drill(n_requests=6, place=fluid.CPUPlace())
    assert r["ok"], r
    assert r["hedge_wins"] >= 1 and r["losers_cancelled"] == r["hedges_fired"]
