"""The port's serving observability against the JAX package's: request
traces (``observability/reqtrace.py``), span ids (``tracing.py``), the
/servez payload (``serving/status.py``), SLO burn-rate alerts
(``observability/slo.py``) and the text exposition with exemplars
(``observability/exposition.py``).

Every comparison drives both packages with the same script under one
stub clock and compares exactly: the clocks are patched, so even the
float durations are equal.
"""

import concurrent.futures
import itertools
import os
import types

import numpy as np
import pytest

from paddle_tpu.observability import exposition as j_expo
from paddle_tpu.observability import metrics as j_metrics
from paddle_tpu.observability import reqtrace as j_rt
from paddle_tpu.observability import slo as j_slo
from paddle_tpu.observability import tracing as j_tracing
from paddle_tpu_torch.observability import exposition as t_expo
from paddle_tpu_torch.observability import metrics as t_metrics
from paddle_tpu_torch.observability import reqtrace as t_rt
from paddle_tpu_torch.observability import slo as t_slo
from paddle_tpu_torch.observability import tracing as t_tracing

PKGS = {"jax": (j_rt, j_tracing), "torch": (t_rt, t_tracing)}


class StubClock:
    """``time`` stand-in: ``time()`` and ``perf_counter()`` move only
    when the test advances them."""

    def __init__(self):
        self.t = 1_700_000_000.0
        self.p = 100.0

    def advance(self, dt):
        self.t += dt
        self.p += dt

    def namespace(self):
        return types.SimpleNamespace(time=lambda: self.t,
                                     perf_counter=lambda: self.p,
                                     monotonic=lambda: self.p)


@pytest.fixture
def stubbed(monkeypatch):
    """Both reqtrace modules on one stub clock each (same start) and
    deterministic span ids (``7-1``, ``7-2``, ... in order of
    creation)."""
    clocks = {}
    for name, (rt, _) in PKGS.items():
        clock = clocks[name] = StubClock()
        monkeypatch.setattr(rt, "time", clock.namespace())
        counter = itertools.count(1)
        monkeypatch.setattr(rt._tracing, "new_span_id",
                            lambda c=counter: f"{7:x}-{next(c):x}")
        rt.reset()
    yield clocks
    for rt, _ in PKGS.values():
        rt.reset()


def _future(result=None, exc=None, cancel=False):
    f = concurrent.futures.Future()
    if cancel:
        f.cancel()
    elif exc is not None:
        f.set_exception(exc)
    else:
        f.set_result(result)
    return f


def _script(rt, clock):
    """A failed-over generate, a hedged infer with a cancelled loser,
    an errored request, and twelve plain ones of rising latency (so the
    ring has a live p99 and tail-keeps the slowest)."""
    root = rt.start_request("generate", attrs={"frontend": "fe"})
    clock.advance(0.001)
    with rt.attach(root):
        assert rt.current_span() is root
        att = rt.start_span("dispatch:r0", kind="attempt",
                            attrs={"replica": "r0", "attempt": 0})
        with rt.attach(att):
            serve = rt.start_span("serve:r0", kind="serve",
                                  attrs={"engine": "r0"})
    assert rt.current_span() is None
    b1 = rt.start_batch("decode_step:r0", attrs={"step": 1})
    clock.advance(0.002)
    serve.link(b1)
    serve.link(b1)  # a link is kept once
    b1.finish("ok")
    boom = RuntimeError("replica r0 killed at decode step 2")
    rt.finish_future(serve, _future(exc=boom))
    rt.finish_future(att, _future(exc=boom))
    att2 = rt.start_span("dispatch:r1", kind="attempt", parent=root,
                         attrs={"replica": "r1", "resumed": True})
    serve2 = rt.start_span("serve:r1", kind="serve", parent=att2)
    b2 = rt.start_batch("decode_step:r1")
    clock.advance(0.004)
    b2.finish("ok")
    serve2.link(b2).set_attr("tokens", 6).set_attr("ttft_s", 0.003)
    serve2.set_attr("tpot_s", 0.0005)
    rt.finish_future(serve2, _future([1, 2, 3]))
    rt.finish_future(att2, _future([1, 2, 3]))
    serve2.finish("error")  # the first finish wins
    root.finish("ok", http_status=200)

    inf = rt.start_request("infer", trace_id="upstream-7")
    prim = rt.start_span("dispatch:slow", kind="attempt", parent=inf)
    clock.advance(0.030)
    hedge = rt.start_span("dispatch:fast", kind="attempt", parent=inf,
                          attrs={"hedge": True})
    clock.advance(0.001)
    rt.finish_future(hedge, _future({"y": 1}))
    prim.finish("cancelled")
    rt.finish_future(prim, _future(cancel=True))
    inf.finish("ok")

    bad = rt.start_request("generate")
    clock.advance(0.0005)
    bad.finish("error", error=ValueError("bad prompt"), http_status=400)

    for i in range(12):
        r = rt.start_request("generate", attrs={"i": i})
        s = rt.start_span("serve:r1", kind="serve", parent=r)
        clock.advance(0.001 * (i + 1))
        s.set_attr("ttft_s", 0.0001 * (i + 1))
        s.finish("ok")
        r.finish("ok")
    live = rt.start_request("generate")
    return {
        "completed": rt.completed(),
        "last3": rt.completed(3),
        "get": rt.get_trace(root.trace_id),
        "get_live": rt.get_trace(live.trace_id),
        "get_none": rt.get_trace("nope"),
        "quantiles": rt.request_quantiles(),
        "quantiles_95": rt.request_quantiles((0.5, 0.95, 0.99)),
        "ring": rt.ring_stats(),
        # past the title line, which names each package's own docs
        "tracez": [x.split("\n", 1)[-1] for x in rt.tracez_payload()],
        "tracez_5": rt.tracez_payload(limit=5)[0].split("\n", 1)[-1],
    }


def test_reqtrace_script_matches_jax(stubbed):
    got = {name: _script(rt, stubbed[name])
           for name, (rt, _) in PKGS.items()}
    assert got["torch"] == got["jax"]
    # the script exercised what it claims
    j = got["jax"]
    assert j["ring"]["size"] == 15 and j["ring"]["live"] == 1
    assert j["ring"]["kept"] >= 2  # the error and the slowest
    first = j["completed"][0]
    assert [(s["name"], s["status"]) for s in first["spans"]][:5] == [
        ("generate", "ok"), ("dispatch:r0", "error"),
        ("serve:r0", "error"), ("dispatch:r1", "ok"), ("serve:r1", "ok")]
    assert first["ttft_s"] == 0.003 and first["tpot_s"] == 0.0005
    assert j["completed"][1]["trace_id"] == "upstream-7"
    assert {s["name"]: s["status"] for s in j["completed"][1]["spans"]}[
        "dispatch:slow"] == "cancelled"
    assert j["get_live"]["status"] == "live" and j["get_none"] is None
    assert "KEPT" in j["tracez"][0]
    assert j["tracez"][1] == "text/plain; charset=utf-8"


def test_reqtrace_disabled_returns_none(monkeypatch):
    from paddle_tpu.fluid import flags as j_flags
    from paddle_tpu_torch.fluid import flags as t_flags

    for flags, rt in ((j_flags, j_rt), (t_flags, t_rt)):
        old = flags.flag("reqtrace")
        flags.set_flags({"FLAGS_reqtrace": False})
        try:
            assert rt.start_request("x") is None
            assert rt.start_batch("b") is None
            with rt.attach(None):
                assert rt.start_span("y") is None
            rt.finish_future(None, _future(1))  # a None span is a no-op
        finally:
            flags.set_flags({"FLAGS_reqtrace": old})


def test_span_ids_match_jax():
    for mod in (j_tracing, t_tracing):
        a, b = mod.new_span_id(), mod.new_span_id()
        pid, n = a.split("-")
        assert int(pid, 16) == os.getpid()
        assert int(b.split("-")[1], 16) > int(n, 16)
    for wire in (0, 1, (0x1234 << 32) | 0xabcd, (1 << 64) - 1):
        assert t_tracing.format_wire_span(wire) == \
            j_tracing.format_wire_span(wire)
    w, s = t_tracing.new_wire_span()
    assert t_tracing.format_wire_span(w) == s
    assert j_tracing.format_wire_span(w) == s


# ---------------------------------------------------------------------------
# /servez
# ---------------------------------------------------------------------------


def _rest_engines():
    """A tiny DecodeEngine of each package, built and never run."""
    from paddle_tpu import fluid as j_fluid
    from paddle_tpu.models import gpt as j_gpt
    from paddle_tpu.serving import DecodeEngine as JEngine
    from paddle_tpu_torch import fluid as t_fluid
    from paddle_tpu_torch.models import gpt as t_gpt
    from paddle_tpu_torch.serving import DecodeEngine as TEngine

    kw = dict(pool_slots=2, page_size=4, prefill_chunk=4, max_len=16,
              auto_start=False, name="rest", tenant_quota=3)
    j = JEngine(j_gpt.GPTConfig.tiny(num_layers=1), scope=j_fluid.Scope(),
                **kw)
    t = TEngine(t_gpt.GPTConfig.tiny(num_layers=1), scope=t_fluid.Scope(),
                place=t_fluid.CPUPlace(), **kw)
    return j, t


def test_servez_payload_decode_section_matches_jax():
    from paddle_tpu.serving import status as j_status
    from paddle_tpu_torch.serving import status as t_status

    j_rt.reset()
    t_rt.reset()
    j, t = _rest_engines()
    try:
        jp, tp = j_status.servez_payload(), t_status.servez_payload()
        assert sorted(jp) == sorted(tp) == ["decode", "engines", "reqtrace"]
        assert tp["reqtrace"] == jp["reqtrace"]
        (jd,) = [d for d in jp["decode"] if d["engine"] == "rest"]
        (td,) = [d for d in tp["decode"] if d["engine"] == "rest"]
        # the JAX lane's keys and values; the port adds two of its own
        assert {k: td[k] for k in jd} == jd
        assert set(td) - set(jd) == {"prefill_chunks", "int8_weights"}
        assert j.healthy() and t.healthy() and j.load() == t.load() == 0
    finally:
        j.close()
        t.close()
    assert t not in t_status.live_decode_engines()


# ---------------------------------------------------------------------------
# SLOs
# ---------------------------------------------------------------------------

SPECS = [
    "avail|availability|bad=pt_serve_failovers_total{router=drill}"
    "|total=pt_serve_requests_total|objective=0.999",
    "lat|latency|hist=pt_serve_request_latency_seconds{model=m}"
    "|threshold=0.25|objective=0.99",
    "x|availability|bad=a|total=b",
    "q|availability|bad=a{k=\"v\", j=w}|total=b{}",
]
BAD_SPECS = [
    "a|availability|bad=x", "a|latency|hist=h", "a|nope|bad=x|total=y",
    "a|availability|bad=x|total=y|objective=1.5", "oops",
    "a|availability|bad=x|total=y|color=red", "a|availability|bad",
    "a|availability|bad=x{k}|total=y",
]


def _outcome(fn, *a):
    try:
        return ("ok", fn(*a))
    except Exception as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("spec", SPECS + BAD_SPECS)
def test_slo_parse_spec_matches_jax(spec):
    def parse(mod):
        return mod.parse_spec(spec).describe()

    assert _outcome(parse, t_slo) == _outcome(parse, j_slo)


def test_slo_parse_specs_matches_jax():
    text = ";".join(SPECS[:3]) + ";"
    assert [s.describe() for s in t_slo.parse_specs(text)] == \
        [s.describe() for s in j_slo.parse_specs(text)]


def _slo_run(metrics_mod, slo_mod):
    """One scripted series through a private registry: healthy traffic,
    a failover burst, recovery; a latency histogram beside it."""
    reg = metrics_mod.MetricsRegistry()
    bad = reg.counter("pt_serve_failovers_total", "f", labels=("router",))
    total = reg.counter("pt_serve_requests_total", "r",
                        labels=("model", "tenant"))
    lat = reg.histogram("pt_serve_request_latency_seconds", "l",
                        labels=("model",))
    specs = [slo_mod.parse_spec(SPECS[0]), slo_mod.parse_spec(SPECS[1])]
    eng = slo_mod.SLOEngine(
        specs, windows=(slo_mod.BurnWindow("page", 1.0, 4.0, 14.4),
                        slo_mod.BurnWindow("ticket", 2.0, 8.0, 6.0)),
        registry=reg, clock=lambda: 0.0)
    out = []
    rng = np.random.RandomState(0)
    for step in range(40):
        t = 0.25 * step
        total.labels(model="m", tenant="a").inc(10)
        if 8 <= step < 12:
            bad.labels(router="drill").inc(3)
            bad.labels(router="other").inc(5)  # filtered out
        for v in rng.exponential(0.1 if step < 20 else 0.6, 5):
            lat.labels(model="m").observe(float(v))
        out.append(eng.evaluate(now=t))
    out.append(eng.alert_state("avail", "page"))
    out.append(eng.alert_state("lat", "ticket"))
    payload = eng.payload()
    return out, payload


def test_slo_burn_alerts_match_jax():
    j_out, j_payload = _slo_run(j_metrics, j_slo)
    t_out, t_payload = _slo_run(t_metrics, t_slo)
    assert t_out == j_out
    assert t_payload == j_payload
    fired = [o["avail"]["page"]["active"] for o in j_out[:-2]]
    assert True in fired and not fired[-1]  # fired, then cleared
    assert any(o["lat"]["page"]["active"] for o in j_out[:-2])


def test_slo_scaled_windows_and_errors_match_jax():
    for mod in (j_slo, t_slo):
        with pytest.raises(ValueError):
            mod.SLOEngine([], window_scale=0)
        with pytest.raises(ValueError):
            mod.SLOSpec("a", "availability", 0.9)
    j = j_slo.SLOEngine([], window_scale=1 / 3600).payload()
    t = t_slo.SLOEngine([], window_scale=1 / 3600).payload()
    assert t == j


# ---------------------------------------------------------------------------
# exposition
# ---------------------------------------------------------------------------


def _fill(metrics_mod):
    reg = metrics_mod.MetricsRegistry()
    reg.counter("pt_serve_failovers_total", "Fail\\overs\nhere",
                labels=("router",)).labels(router='d"r').inc(3)
    g = reg.gauge("pt_serve_breaker_state", "b", labels=("router",
                                                          "replica"))
    g.labels(router="r", replica="a").set(2)
    h = reg.histogram("pt_serve_recovery_seconds", "r", labels=("router",),
                      buckets=(0.01, 0.1, 1.0))
    h.labels(router="r").observe(0.05, exemplar="trace-1")
    h.labels(router="r").observe(5.0, exemplar={"trace_id": "t2", "x": "y"})
    h.labels(router="r").observe(0.001)
    reg.counter("plain_total", "").inc(1.5)
    return reg


def test_exposition_text_and_parse_match_jax():
    jt = j_expo.render_text(_fill(j_metrics).snapshot())
    tt = t_expo.render_text(_fill(t_metrics).snapshot())
    assert tt == jt
    assert '# {trace_id="trace-1"} 0.05' in tt
    assert t_expo.parse_text(tt) == j_expo.parse_text(jt)
    assert t_expo.render_json(_fill(t_metrics).snapshot()) == \
        j_expo.render_json(_fill(j_metrics).snapshot())
    for bad in ("x{a=b} 1", "x 1 # {a=\"b\"", "# TYPE x nope"):
        with pytest.raises(ValueError):
            t_expo.parse_text(bad)


def test_exposition_server_pages():
    import json
    import urllib.request

    from paddle_tpu_torch.serving import status  # registers /servez

    assert status.servez_payload
    srv = t_expo.MetricsServer(port=0)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        for path in ("/metricsz", "/healthz", "/tracez", "/servez",
                     "/statusz", "/sloz"):
            with urllib.request.urlopen(base + path, timeout=10) as r:
                assert r.status == 200, path
                body = r.read().decode()
            if path == "/servez":
                assert sorted(json.loads(body)) == ["decode", "engines",
                                                    "reqtrace"]
            if path == "/statusz":
                assert "torch" in json.loads(body)
        with pytest.raises(ValueError):
            t_expo.register_page("/servez", lambda: {})
    finally:
        srv.stop()
