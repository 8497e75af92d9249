"""FaultPlan-driven serving drills (the port's counterpart of
``paddle_tpu/serving/drill.py``): each claim of the resilience layer is
measured, deterministically, with the FaultPlan grammar.

  failover_drill  a 2-replica decode group under load; a
                  ``replica_kill:`` rule kills one scheduler mid-decode;
                  the router fails the victim sequences over and every
                  stream must finish token-exact against the
                  uninterrupted one-replica baseline.  Books
                  pt_serve_failovers_total and pt_serve_recovery_seconds;
                  gates on zero executor-cache misses across the
                  failover (no new plan, no new capture) and on the
                  availability SLO's page alert firing during the kill
                  and clearing after recovery.
  hedge_drill     two ``serving.Engine`` replicas of one model, the first
                  built slow (a long batch wait); hedged requests beat
                  it to the fast replica, and each hedge's loser is
                  cancelled.

Each returns a plain report dict with ``ok``.  Called with no engines,
they build their own tiny models on ``place`` (CUDAPlace(0) when None;
pass CPUPlace() without a GPU).  ``failover_drill`` also takes a live
group, a router and a submit function, which is how ``chip_smoke.py``
runs it over full-width replicas behind the HTTP frontend.

Not ported yet: ``promotion_drill``, which needs ``serving/promote.py``.
"""

from __future__ import annotations

import threading
import time

import numpy as np

__all__ = ["failover_drill", "hedge_drill"]

_GPT_CFG = dict(num_layers=2, hidden_dropout=0.0, use_flash_attention=False)


def _compile_misses():
    """Executor-cache misses so far, every path (a miss builds a plan
    and, on a CUDA place, captures a graph): the zero-compile gates are
    deltas of this."""
    from paddle_tpu_torch import observability as obs

    fam = obs.snapshot().get("pt_compile_cache_total") or {}
    return sum(int(v) for k, v in fam.get("samples", {}).items()
               if k[-1] == "miss")


def _recovery_hist(router_name):
    from paddle_tpu_torch import observability as obs

    fam = obs.snapshot().get("pt_serve_recovery_seconds") or {}
    h = fam.get("samples", {}).get((router_name,))
    if not h:
        return {"count": 0, "sum": 0.0}
    return {"count": int(h["count"]), "sum": float(h["sum"])}


def _build_decode_group(n_replicas, place, *, pool_slots=2, seed=3):
    """One tiny random-init GPT; each replica gets its own scope holding
    a copy of the same parameters and its own DecodeEngine, warmed up
    and started."""
    from paddle_tpu_torch import fluid, serving
    from paddle_tpu_torch.models import gpt

    cfg = gpt.GPTConfig.tiny(**_GPT_CFG)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        gpt.build_gpt_lm(cfg)
    startup.random_seed = seed
    scope0 = fluid.Scope()
    fluid.Executor(place).run(startup, scope=scope0)
    names = [n for n in scope0.keys() if scope0.get(n) is not None]
    engines = []
    for i in range(n_replicas):
        s = fluid.Scope()
        for n in names:
            s.set(n, scope0.get(n).clone())
        engines.append(serving.DecodeEngine(
            cfg, scope=s, place=place, pool_slots=pool_slots, page_size=4,
            prefill_chunk=4, max_len=32, name=f"replica{i}",
            auto_start=False, drain_on_sigterm=False))
    # every replica warmed up before any starts
    for eng in engines:
        eng.warmup()
    for eng in engines:
        eng.start()
    return cfg, engines


def _prompts(cfg, n, plen=4, seed=11):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, cfg.vocab_size, plen).tolist() for _ in range(n)]


def _failed_over_trace(victim, survivor):
    """A completed trace holding a ``serve:<victim>`` span that ended in
    error and a ``serve:<survivor>`` span that finished ok, as
    {"trace_id", "root", "spans": [(kind, name, status)]}; None if no
    trace does."""
    from paddle_tpu_torch.observability import reqtrace as _reqtrace

    for t in reversed(_reqtrace.completed()):
        spans = [(s["kind"], s["name"], s["status"]) for s in t["spans"]]
        if (("serve", f"serve:{victim}", "error") in spans
                and ("serve", f"serve:{survivor}", "ok") in spans):
            return {"trace_id": t["trace_id"], "root": t["name"],
                    "status": t["status"], "spans": spans}
    return None


def failover_drill(engines=None, prompts=None, max_new_tokens=8,
                   kill_after=2, baseline=None, router=None, submit=None,
                   place=None, n_requests=6, timeout_s=300.0,
                   slo_clear_timeout_s=20.0):
    """``replica_kill`` mid-decode under load → router failover,
    token-exact resumed streams, recovery booked, zero cache misses, and
    the availability SLO's page alert fired during the kill and cleared
    after recovery.

    ``engines``: two started DecodeEngine replicas of equal weights, the
    first the victim (default: a tiny GPT group built on ``place``,
    closed at the end).  ``baseline``: the streams ``prompts`` give
    without a fault (default: the victim's own ``generate``).
    ``router``: a Router holding both (default: one built here);
    ``submit(prompt, max_new_tokens)`` → Future sends one request
    (default: ``router.submit``)."""
    from paddle_tpu_torch.distributed import fault_injection as _fault
    from paddle_tpu_torch.observability import reqtrace as _reqtrace
    from paddle_tpu_torch.observability import slo as _slo

    from .router import Router

    owned = engines is None
    if owned:
        from paddle_tpu_torch.fluid.framework import resolve_place

        cfg, engines = _build_decode_group(2, resolve_place(place))
        if prompts is None:
            prompts = _prompts(cfg, n_requests)
    r0, r1 = engines
    own_router = router is None
    # the production spec over the production families, with the page
    # window pair compressed to seconds: bad = failovers this router
    # booked, total = admitted serving requests
    rname = router.name if router is not None else "drill"
    spec = _slo.parse_spec(
        "drill_availability|availability"
        f"|bad=pt_serve_failovers_total{{router={rname}}}"
        "|total=pt_serve_requests_total"
        "|objective=0.999")
    slo_eng = _slo.SLOEngine(
        [spec], windows=(_slo.BurnWindow("page", 1.0, 4.0, 14.4),))
    marks = {"t_kill": None, "t_fired": None, "t_cleared": None}
    stop_poll = threading.Event()

    def _poll_slo():
        # evaluate first, wait after: a wait-first loop could take its
        # first sample with the failovers already booked, and a window
        # whose every sample is post-failure has zero delta
        while True:
            if marks["t_kill"] is None and not r0.healthy():
                marks["t_kill"] = time.monotonic()
            slo_eng.evaluate()
            st = slo_eng.alert_state("drill_availability", "page")
            if st["active"] and marks["t_fired"] is None:
                marks["t_fired"] = time.monotonic()
            if (not st["active"] and marks["t_fired"] is not None
                    and marks["t_cleared"] is None):
                marks["t_cleared"] = time.monotonic()
                return
            if stop_poll.wait(0.02):
                return

    try:
        if baseline is None:
            baseline = r0.generate(prompts, max_new_tokens,
                                   timeout=timeout_s)
        # the victim's step counter kept counting through the baseline
        kill_step = r0.stats()["steps"] + int(kill_after)
        _fault.install(f"replica_kill:{r0.name}:step:{kill_step}")
        misses_before = _compile_misses()
        if own_router:
            router = Router([r0, r1], name=rname, hedge_ms=0,
                            probe_interval_ms=20)
        if submit is None:
            submit = router.submit
        slo_eng.evaluate()  # the healthy base every window deltas from
        poller = threading.Thread(target=_poll_slo, daemon=True)
        poller.start()
        t0 = time.monotonic()
        futs = [submit(p, max_new_tokens) for p in prompts]
        outs = [f.result(timeout=timeout_s) for f in futs]
        wall_s = time.monotonic() - t0
        t_recovered = time.monotonic()
        # the counters stopped moving: the short window drains and the
        # alert must clear
        deadline = time.monotonic() + float(slo_clear_timeout_s)
        while marks["t_cleared"] is None and time.monotonic() < deadline:
            time.sleep(0.05)
        stop_poll.set()
        poller.join(timeout=5)
        misses_delta = _compile_misses() - misses_before
        token_exact = [list(o) for o in outs] == [list(b) for b in baseline]
        stats = router.stats()
        rec = _recovery_hist(rname)
        alert = slo_eng.alert_state("drill_availability", "page")
        slo_report = {
            "spec": spec.describe(),
            "alert_fired": marks["t_fired"] is not None,
            "alert_cleared": marks["t_cleared"] is not None,
            "fire_latency_s": (marks["t_fired"] - marks["t_kill"]
                               if marks["t_fired"] is not None
                               and marks["t_kill"] is not None else None),
            "clear_latency_s": (marks["t_cleared"] - t_recovered
                                if marks["t_cleared"] is not None
                                else None),
            "fired_total": alert["fired_total"],
        }
        trace = _failed_over_trace(r0.name, r1.name)
        report = {
            "requests": len(prompts),
            "max_new_tokens": max_new_tokens,
            "kill_step": kill_step,
            "replica0_died": not r0.healthy(),
            "token_exact": token_exact,
            "mismatched": [i for i, (o, b) in enumerate(zip(outs, baseline))
                           if list(o) != list(b)],
            "failovers": stats["failovers"],
            "recovery": rec,
            "mttr_s": rec["sum"] / rec["count"] if rec["count"] else None,
            "compile_miss_delta": misses_delta,
            "wall_s": wall_s,
            "slo": slo_report,
            "failed_over_trace": trace,
            "trace_quantiles": _reqtrace.request_quantiles(),
        }
        report["ok"] = (token_exact and report["replica0_died"]
                        and stats["failovers"] > 0
                        and rec["count"] > 0 and misses_delta == 0
                        and slo_report["alert_fired"]
                        and slo_report["alert_cleared"]
                        and trace is not None)
        return report
    finally:
        stop_poll.set()
        _fault.uninstall()
        if own_router and router is not None:
            router.close()
        if owned:
            for eng in engines:
                eng.close()


def hedge_drill(n_requests=12, hedge_ms=30, slow_wait_ms=300, place=None,
                timeout_s=120.0):
    """Two ``serving.Engine`` replicas serving one small model on
    ``place``; the first is built slow (its batcher waits
    ``slow_wait_ms``) so the hedge timer beats it to the fast replica.
    The report gives the hedge win rate and how many hedge losers were
    cancelled (their attempt spans finished ``cancelled``)."""
    import shutil
    import tempfile
    import warnings

    from paddle_tpu_torch import fluid, serving
    from paddle_tpu_torch.fluid.framework import resolve_place
    from paddle_tpu_torch.observability import reqtrace as _reqtrace

    from .router import Router

    place = resolve_place(place)
    feature, hidden, classes = 16, 32, 8
    model_dir = tempfile.mkdtemp(prefix="pt_serve_drill_")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[feature], dtype="float32")
        h = fluid.layers.fc(x, size=hidden, act="relu")
        pred = fluid.layers.fc(h, size=classes, act="softmax")
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(model_dir, ["x"], [pred], exe,
                                  main_program=main, scope=scope)
    engines, router = [], None
    try:
        with warnings.catch_warnings():
            # both replicas serve model name "m" on purpose (their
            # pt_serve_* series alias; the router is the one caller)
            warnings.simplefilter("ignore")
            for name, wait_ms in (("slow", slow_wait_ms), ("fast", 1)):
                eng = serving.Engine({"m": model_dir}, max_wait_ms=wait_ms,
                                     name=f"hedge-{name}", auto_start=False,
                                     place=place)
                engines.append(eng)
            for eng in engines:
                eng.warmup()
            for eng in engines:
                eng.start()
        router = Router(engines, name="hedge", hedge_ms=hedge_ms,
                        probe_interval_ms=50)
        xb = np.arange(feature, dtype=np.float32).reshape(1, feature)
        t0 = time.monotonic()
        outs = [router.infer("m", {"x": xb}, timeout=timeout_s)
                for _ in range(n_requests)]
        wall_s = time.monotonic() - t0
        hedges = router.hedge_stats()
        fired = hedges["win"] + hedges["lose"]
        names = {f"dispatch:{e.name}" for e in engines}
        cancelled = 0
        for t in _reqtrace.completed(n_requests):
            att = [s for s in t["spans"] if s["name"] in names]
            if len(att) == 2 and any(s["status"] == "cancelled"
                                     for s in att):
                cancelled += 1
        report = {
            "requests": n_requests,
            "completed": len(outs),
            "hedge_ms": hedge_ms,
            "hedges_fired": fired,
            "hedge_wins": hedges["win"],
            "hedge_win_rate": hedges["win"] / fired if fired else None,
            "losers_cancelled": cancelled,
            "wall_s": wall_s,
        }
        report["ok"] = (len(outs) == n_requests and fired > 0
                        and hedges["win"] > 0 and cancelled == fired)
        return report
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
        if router is not None:
            router.close()
        for eng in engines:
            eng.close()
