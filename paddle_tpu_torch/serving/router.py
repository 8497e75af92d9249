"""Multi-replica serving router (the port's copy of
``paddle_tpu/serving/router.py``).

A `Router` holds N replicas (any mix of `DecodeEngine` streams and
`Engine` stateless lanes) and gives the serving path its fault story:

  least-loaded dispatch   each request goes to the available replica
                          with the least live work (``load()``)
  liveness probes         a background thread trips a dead replica's
                          breaker even with no traffic
  circuit breaker         consecutive-failure open → cooldown →
                          half-open single probe → close
                          (``pt_serve_breaker_state{router,replica}``)
  bounded retry           typed admission rejections (overload,
                          tenant_quota, draining, closed) retry with
                          backoff on a `RetryPolicy`; budget exhaustion
                          re-raises the typed error
  hedged requests         a stateless call gets a second copy on another
                          replica after FLAGS_serving_hedge_ms (-1: the
                          rolling p99); the first result wins and the
                          loser is cancelled (``pt_serve_hedges_total``)
  decode failover         a replica death mid-stream re-prefills each
                          victim sequence on a survivor from its emitted
                          prefix (``submit_request(prefix=...)``),
                          token-exact under greedy decode, booked on
                          ``pt_serve_failovers_total`` and
                          ``pt_serve_recovery_seconds``

``fault_injection.on_serve(replica)`` fires at the dispatch edge
(``serve_error:`` / ``serve_delay:``) and the decode step calls
``on_replica_step`` (``replica_kill:``), so each behaviour above runs
deterministically in ``serving/drill.py``.  The router is duck-typed
over its replicas: anything with ``submit_request/healthy/load`` routes
as a decode stream, anything with ``submit(model, feed, tenant)`` as a
stateless engine.
"""

from __future__ import annotations

import collections
import concurrent.futures
import threading
import time
import weakref

from paddle_tpu_torch.observability import reqtrace as _reqtrace

from .errors import (ModelNotLoadedError, ServingDeadlineError,
                     ServingOverloadError)

__all__ = ["Router", "Replica", "CircuitBreaker",
           "BREAKER_CLOSED", "BREAKER_HALF_OPEN", "BREAKER_OPEN",
           "routerz_payload"]


# ---------------------------------------------------------------------------
# metrics (lazy idempotent registration — the observability contract)
# ---------------------------------------------------------------------------


def _m_failovers():
    from paddle_tpu_torch import observability as obs

    return obs.counter(
        "pt_serve_failovers_total",
        "Decode-sequence failovers: a victim sequence re-prefilled on a "
        "surviving replica from its already-emitted prefix after a "
        "replica death or breaker-open (one per recovered sequence)",
        labels=("router",))


def _m_recovery():
    from paddle_tpu_torch import observability as obs

    return obs.histogram(
        "pt_serve_recovery_seconds",
        "Serving failover recovery time: replica-death detection (the "
        "fanned exception) to the victim sequence re-admitted on a "
        "surviving replica — the serving-side MTTR the drill harness "
        "gates on", labels=("router",))


def _m_hedges():
    from paddle_tpu_torch import observability as obs

    return obs.counter(
        "pt_serve_hedges_total",
        "Hedged prefill-only requests by outcome: `win` (the hedge "
        "finished first and its result was used) vs `lose` (the "
        "primary finished first; the hedge was cancelled)",
        labels=("router", "outcome"))


def _m_breaker():
    from paddle_tpu_torch import observability as obs

    return obs.gauge(
        "pt_serve_breaker_state",
        "Per-replica circuit-breaker state: 0=closed, 1=half-open "
        "(single probe in flight), 2=open (out of rotation until "
        "FLAGS_serving_breaker_cooldown_ms elapses)",
        labels=("router", "replica"))


def _m_retries():
    from paddle_tpu_torch import observability as obs

    return obs.counter(
        "pt_serve_router_retries_total",
        "Router-level retries of typed admission rejections "
        "(RetryPolicy backoff; budget exhaustion re-raises the typed "
        "error)", labels=("router",))


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

BREAKER_CLOSED = 0
BREAKER_HALF_OPEN = 1
BREAKER_OPEN = 2

_STATE_NAMES = {BREAKER_CLOSED: "closed", BREAKER_HALF_OPEN: "half_open",
                BREAKER_OPEN: "open"}


class CircuitBreaker:
    """Consecutive-failure circuit breaker (per replica).

    closed --[`failures` consecutive failures]--> open
    open --[`cooldown_ms` elapsed, next allow()]--> half-open
    half-open: exactly ONE probe request passes; its success closes the
    breaker (counters reset), its failure re-opens it (cooldown re-arms).

    `clock` is injectable (monotonic seconds) so the state machine is
    unit-testable without sleeping."""

    def __init__(self, failures=None, cooldown_ms=None, clock=None):
        from paddle_tpu_torch.fluid import flags as _flags

        self.failures = int(_flags.flag("serving_breaker_failures")
                            if failures is None else failures)
        self.cooldown_s = float(
            _flags.flag("serving_breaker_cooldown_ms")
            if cooldown_ms is None else cooldown_ms) / 1000.0
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._state = BREAKER_CLOSED
        self._consecutive = 0
        self._opened_at = None
        self._probe_in_flight = False

    @property
    def state(self):
        with self._lock:
            self._maybe_half_open()
            return self._state

    def state_name(self):
        return _STATE_NAMES[self.state]

    def _maybe_half_open(self):
        # caller holds the lock
        if (self._state == BREAKER_OPEN
                and self._clock() - self._opened_at >= self.cooldown_s):
            self._state = BREAKER_HALF_OPEN
            self._probe_in_flight = False

    def allow(self):
        """May a request be dispatched through this breaker right now?
        In half-open state only the first caller gets True (the single
        probe); everyone else waits for its verdict."""
        with self._lock:
            self._maybe_half_open()
            if self._state == BREAKER_CLOSED:
                return True
            if self._state == BREAKER_HALF_OPEN \
                    and not self._probe_in_flight:
                self._probe_in_flight = True
                return True
            return False

    def record_success(self):
        with self._lock:
            self._state = BREAKER_CLOSED
            self._consecutive = 0
            self._opened_at = None
            self._probe_in_flight = False

    def record_failure(self):
        with self._lock:
            self._maybe_half_open()
            if self._state == BREAKER_HALF_OPEN:
                # the probe failed: straight back to open, cooldown re-arms
                self._trip_locked()
                return
            self._consecutive += 1
            if self._consecutive >= self.failures:
                self._trip_locked()

    def trip(self):
        """Force-open (the liveness probe's verdict on a dead replica —
        no point counting N failures against a corpse)."""
        with self._lock:
            self._trip_locked()

    def _trip_locked(self):
        self._state = BREAKER_OPEN
        self._consecutive = self.failures
        self._opened_at = self._clock()
        self._probe_in_flight = False


# ---------------------------------------------------------------------------
# replica wrapper
# ---------------------------------------------------------------------------


class Replica:
    """One engine in the rotation: the engine itself, its breaker, and
    the duck-typed kind (`decode` = streaming `submit_request` surface,
    `engine` = stateless `submit(model, feed)` surface)."""

    __slots__ = ("name", "engine", "breaker", "kind", "held")

    def __init__(self, engine, breaker):
        self.engine = engine
        self.name = getattr(engine, "name", repr(engine))
        self.breaker = breaker
        self.kind = ("decode" if hasattr(engine, "submit_request")
                     else "engine")
        # held = administratively out of rotation (canary promotion's
        # quiesce/swap window) — orthogonal to breaker state
        self.held = False

    def healthy(self):
        probe = getattr(self.engine, "healthy", None)
        if probe is not None:
            return bool(probe())
        # continuous-batch Engine: closed is the only dead state its
        # surface exposes (lane scheduler errors fail futures typed)
        return not getattr(self.engine, "_closed", False)

    def load(self):
        probe = getattr(self.engine, "load", None)
        if probe is not None:
            return int(probe())
        lanes = getattr(self.engine, "_lanes", None)
        if lanes:
            return sum(len(lane._queue) for lane in list(lanes.values()))
        return 0

    def available(self):
        return not self.held and self.healthy() and self.breaker.allow()


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

_live_routers = weakref.WeakSet()
_track_lock = threading.Lock()
_page_registered = False


def routerz_payload():
    """The /routerz page: every live router's replica table + counters."""
    with _track_lock:
        routers = list(_live_routers)
    return {"routers": [r.stats() for r in routers]}


def _track(router):
    global _page_registered
    with _track_lock:
        _live_routers.add(router)
        if not _page_registered:
            from paddle_tpu_torch.observability import exposition

            exposition.register_page("/routerz", routerz_payload)
            _page_registered = True


def _untrack(router):
    with _track_lock:
        _live_routers.discard(router)


class Router:
    """N-replica front for one model's serving group.

    ``replicas``: engines to enroll (more via `add_replica`).  The
    router does NOT own replica lifecycle — `close()` stops the probe
    thread and unregisters the router, the engines keep running (the
    drill harness / frontend own their shutdown ordering).

    ``retry``: a `distributed.resilience.RetryPolicy` for typed
    admission rejections (default: the FLAGS_rpc_retry_* policy).
    ``hedge_ms``/``breaker_*``: override the FLAGS_serving_* defaults.
    """

    # ServingOverloadError reasons worth retrying on another replica /
    # after backoff; everything else is either fatal to the request
    # (deadline, validation) or fatal to the replica (handled as death)
    _RETRYABLE = ("overload", "tenant_quota", "draining", "closed")
    _DEATH = ("scheduler_failed",)

    def __init__(self, replicas=(), *, name="router", retry=None,
                 hedge_ms=None, breaker_failures=None,
                 breaker_cooldown_ms=None, probe_interval_ms=100,
                 auto_probe=True):
        from paddle_tpu_torch.fluid import flags as _flags

        self.name = name
        self._breaker_failures = breaker_failures
        self._breaker_cooldown_ms = breaker_cooldown_ms
        if retry is None:
            from paddle_tpu_torch.distributed.resilience import RetryPolicy

            retry = RetryPolicy()
        self.retry = retry
        self._hedge_ms = int(_flags.flag("serving_hedge_ms")
                             if hedge_ms is None else hedge_ms)
        self._lock = threading.Lock()
        self._replicas = []
        self._latencies = collections.deque(maxlen=256)
        self._failovers = 0
        self._hedges = {"win": 0, "lose": 0}
        self._retries = 0
        self._closed = False
        self._bind_metrics()
        for eng in replicas:
            self.add_replica(eng)
        self._probe_interval_s = max(probe_interval_ms, 1) / 1000.0
        self._stop = threading.Event()
        self._probe_thread = None
        if auto_probe:
            self._probe_thread = threading.Thread(
                target=self._probe_loop, daemon=True,
                name=f"pt-router-probe-{name}")
            self._probe_thread.start()
        _track(self)

    # -- metrics ------------------------------------------------------------

    def _bind_metrics(self):
        from paddle_tpu_torch import observability as obs

        self._metrics_epoch = obs.REGISTRY.epoch
        r = self.name
        self._failover_ctr = _m_failovers().labels(router=r)
        self._recovery_hist = _m_recovery().labels(router=r)
        self._hedge_ctr = {o: _m_hedges().labels(router=r, outcome=o)
                           for o in ("win", "lose")}
        self._retry_ctr = _m_retries().labels(router=r)

    def _check_metrics_epoch(self):
        from paddle_tpu_torch import observability as obs

        if self._metrics_epoch != obs.REGISTRY.epoch:
            self._bind_metrics()

    # -- membership ---------------------------------------------------------

    def add_replica(self, engine, breaker=None):
        """Enroll one engine (DecodeEngine or Engine duck-alike) in the
        rotation.  Returns the `Replica` wrapper."""
        if breaker is None:
            breaker = CircuitBreaker(
                failures=self._breaker_failures,
                cooldown_ms=self._breaker_cooldown_ms)
        rep = Replica(engine, breaker)
        with self._lock:
            if any(r.name == rep.name for r in self._replicas):
                raise ValueError(
                    f"router {self.name!r}: replica name {rep.name!r} "
                    f"already enrolled (names key the breaker gauge and "
                    f"fault rules — keep them distinct)")
            self._replicas.append(rep)
        return rep

    def replicas(self, kind=None):
        with self._lock:
            reps = list(self._replicas)
        return [r for r in reps if kind is None or r.kind == kind]

    def set_held(self, name, held=True):
        """Administratively pull a replica from (or return it to) the
        rotation — the promotion quiesce/swap window.  Raises KeyError
        on an unknown name."""
        for rep in self.replicas():
            if rep.name == name:
                rep.held = bool(held)
                return rep
        raise KeyError(f"router {self.name!r}: no replica {name!r}")

    def close(self):
        """Stop the probe thread and unregister.  Replica engines are
        NOT closed — the caller owns their drain/close ordering
        (frontend.py does drain-then-close on SIGTERM)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5)
        _untrack(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- liveness probe -----------------------------------------------------

    def _probe_loop(self):
        while not self._stop.wait(self._probe_interval_s):
            try:
                self.probe_once()
            except Exception:
                # the probe is advisory: a scrape racing a replica
                # teardown must not kill the probe thread
                from paddle_tpu_torch.distributed import resilience

                resilience.record("router_probe_errors")

    def probe_once(self):
        """One liveness sweep: trip the breaker of every dead replica
        (so it leaves rotation even with no traffic) and publish the
        per-replica breaker-state gauge."""
        self._check_metrics_epoch()
        gauge = _m_breaker()
        for rep in self.replicas():
            if not rep.healthy() and rep.breaker.state != BREAKER_OPEN:
                rep.breaker.trip()
            gauge.labels(router=self.name,
                         replica=rep.name).set(rep.breaker.state)

    # -- selection ----------------------------------------------------------

    def _pick(self, kind, exclude=()):
        """Least-loaded available replica of `kind`, or None."""
        best = None
        best_load = None
        for rep in self.replicas(kind):
            if rep.name in exclude or not rep.available():
                continue
            load = rep.load()
            if best is None or load < best_load:
                best, best_load = rep, load
        return best

    def _no_replica(self, kind):
        reps = self.replicas(kind)
        if not reps:
            raise ModelNotLoadedError(
                f"router {self.name!r} has no {kind} replicas enrolled")
        return ServingOverloadError(
            f"router {self.name!r}: no available {kind} replica "
            f"({len(reps)} enrolled, all dead or breaker-open) — retry "
            f"with backoff", reason="overload")

    # -- decode lane (streaming, failover) ----------------------------------

    def submit(self, prompt, max_new_tokens, eos_id=None,
               tenant="default"):
        """Route one greedy generation to the least-loaded decode
        replica; returns a Future resolving to the generated ids.  On
        replica death mid-stream the sequence fails over: a surviving
        replica re-prefills prompt + emitted prefix and the stream
        resumes token-exact (greedy).  Typed admission rejections retry
        with backoff on the RetryPolicy; budget exhaustion re-raises
        the typed error."""
        outer = concurrent.futures.Future()
        tspan = self._root_span(outer, "generate")
        self._dispatch_decode(outer, list(prompt), int(max_new_tokens),
                              eos_id, tenant, prefix=[], attempt=0,
                              failovers=0, t_detect=None, tspan=tspan)
        return outer

    def _root_span(self, outer, name):
        """The request's trace root: the caller's current span (the
        Frontend attached one) — else mint a fresh trace here (direct
        Router callers) whose root finishes when `outer` resolves."""
        tspan = _reqtrace.current_span()
        if tspan is not None:
            return tspan
        tspan = _reqtrace.start_request(name,
                                        attrs={"router": self.name})
        if tspan is not None:
            outer.add_done_callback(
                lambda f, s=tspan: _reqtrace.finish_future(s, f))
        return tspan

    def generate(self, prompts, max_new_tokens, eos_id=None,
                 timeout=None):
        futs = [self.submit(p, max_new_tokens, eos_id=eos_id)
                for p in prompts]
        return [f.result(timeout=timeout) for f in futs]

    def _dispatch_decode(self, outer, prompt, max_new_tokens, eos_id,
                         tenant, prefix, attempt, failovers, t_detect,
                         tspan=None):
        from paddle_tpu_torch.distributed import fault_injection as _fault

        if outer.cancelled():
            return
        tried = set()  # replicas that failed THIS dispatch attempt
        while True:
            rep = self._pick("decode", exclude=tried)
            if rep is None:
                self._retry_or_fail(
                    outer, self._no_replica("decode"), attempt,
                    lambda a: self._dispatch_decode(
                        outer, prompt, max_new_tokens, eos_id, tenant,
                        prefix, a, failovers, t_detect, tspan=tspan))
                return
            # one attempt span per dispatch: retries/failovers each get
            # their own child, so the trace enumerates every replica the
            # request touched (the Dapper attempt story)
            att = _reqtrace.start_span(
                f"dispatch:{rep.name}", kind="attempt", parent=tspan,
                attrs={"replica": rep.name, "attempt": attempt,
                       "failovers": failovers,
                       "resumed": bool(prefix)})
            try:
                _fault.on_serve(rep.name)
                with _reqtrace.attach(att):
                    req = rep.engine.submit_request(
                        prompt, max_new_tokens, eos_id=eos_id,
                        tenant=tenant, prefix=prefix or None)
            except ServingOverloadError as e:
                if att is not None:
                    att.finish("error", error=e)
                if e.reason in self._DEATH:
                    rep.breaker.record_failure()
                    tried.add(rep.name)
                    continue  # dead replica: try another immediately
                self._retry_or_fail(
                    outer, e, attempt,
                    lambda a: self._dispatch_decode(
                        outer, prompt, max_new_tokens, eos_id, tenant,
                        prefix, a, failovers, t_detect, tspan=tspan))
                return
            except _fault.FaultInjected as e:
                if att is not None:
                    att.finish("error", error=e)
                rep.breaker.record_failure()
                tried.add(rep.name)
                continue  # injected dispatch-edge failure: next replica
            if t_detect is not None:
                # a failover just completed re-admission: book the
                # detection → resumed window
                self._recovery_hist.observe(
                    max(time.monotonic() - t_detect, 0.0))
                t_detect = None
            self._watch_decode(outer, rep, req, prompt, max_new_tokens,
                               eos_id, tenant, failovers, tspan=tspan,
                               att=att)
            return

    def _watch_decode(self, outer, rep, req, prompt, max_new_tokens,
                      eos_id, tenant, failovers, tspan=None, att=None):
        t_submit = time.monotonic()

        def _done(fut):
            _reqtrace.finish_future(att, fut)
            exc = fut.exception()
            if exc is None:
                rep.breaker.record_success()
                self._latencies.append(time.monotonic() - t_submit)
                if outer.set_running_or_notify_cancel():
                    outer.set_result(fut.result())
                return
            if isinstance(exc, ServingDeadlineError):
                # the request's own budget ran out — failing over would
                # just miss the deadline on another replica
                if outer.set_running_or_notify_cancel():
                    outer.set_exception(exc)
                return
            if isinstance(exc, ServingOverloadError) \
                    and exc.reason not in self._DEATH:
                # typed back-pressure surfaced after queueing (drain
                # flush, close): retry the whole request elsewhere —
                # nothing was emitted, so there is no prefix to carry
                self._retry_or_fail(
                    outer, exc, 0,
                    lambda a: self._dispatch_decode(
                        outer, prompt, max_new_tokens, eos_id, tenant,
                        list(req.generated), a, failovers, None,
                        tspan=tspan))
                return
            # death class: the scheduler fanned a fatal error to every
            # live future.  Fail this sequence over to a survivor,
            # resuming from the prefix already emitted.
            rep.breaker.record_failure()
            t_detect = time.monotonic()
            if failovers + 1 >= max(len(self.replicas("decode")), 1) + 1:
                if outer.set_running_or_notify_cancel():
                    outer.set_exception(exc)
                return
            self._failover_ctr.inc()
            with self._lock:
                self._failovers += 1
            self._dispatch_decode(
                outer, prompt, max_new_tokens, eos_id, tenant,
                list(req.generated), 0, failovers + 1, t_detect,
                tspan=tspan)

        req.future.add_done_callback(_done)

    # -- stateless lane (prefill-only, hedging) -----------------------------

    def submit_feed(self, model, feed, tenant="default"):
        """Route one stateless inference (the continuous-batch Engine
        lane) to the least-loaded engine replica, hedging to a second
        replica after the hedge delay (FLAGS_serving_hedge_ms; -1 arms
        from the rolling p99).  First result wins; the loser is
        cancelled.  Idempotent calls only — a hedged request may
        execute on BOTH replicas."""
        outer = concurrent.futures.Future()
        tspan = self._root_span(outer, "infer")
        self._dispatch_feed(outer, model, feed, tenant, attempt=0,
                            tspan=tspan)
        return outer

    def infer(self, model, feed, tenant="default", timeout=None):
        return self.submit_feed(model, feed, tenant=tenant).result(
            timeout=timeout)

    def _hedge_delay_s(self):
        if self._hedge_ms == 0:
            return None
        if self._hedge_ms > 0:
            return self._hedge_ms / 1000.0
        lat = sorted(self._latencies)
        if not lat:
            return None  # adaptive with no history yet: no hedge
        return max(lat[int(0.99 * (len(lat) - 1))], 0.001)

    def _dispatch_feed(self, outer, model, feed, tenant, attempt,
                       tspan=None):
        from paddle_tpu_torch.distributed import fault_injection as _fault

        if outer.cancelled():
            return
        tried = set()
        while True:
            primary = self._pick("engine", exclude=tried)
            if primary is None:
                self._retry_or_fail(
                    outer, self._no_replica("engine"), attempt,
                    lambda a: self._dispatch_feed(outer, model, feed,
                                                  tenant, a, tspan=tspan))
                return
            att = _reqtrace.start_span(
                f"dispatch:{primary.name}", kind="attempt", parent=tspan,
                attrs={"replica": primary.name, "attempt": attempt,
                       "hedge": False})
            try:
                _fault.on_serve(primary.name)
                with _reqtrace.attach(att):
                    fut = primary.engine.submit(model, feed,
                                                tenant=tenant)
            except ServingOverloadError as e:
                if att is not None:
                    att.finish("error", error=e)
                if e.reason in self._DEATH:
                    primary.breaker.record_failure()
                    tried.add(primary.name)
                    continue
                self._retry_or_fail(
                    outer, e, attempt,
                    lambda a: self._dispatch_feed(outer, model, feed,
                                                  tenant, a, tspan=tspan))
                return
            except _fault.FaultInjected as e:
                if att is not None:
                    att.finish("error", error=e)
                primary.breaker.record_failure()
                tried.add(primary.name)
                continue
            break
        t0 = time.monotonic()
        state = {"winner": None, "errors": [], "branches": 1,
                 "hedged": False, "timer": None,
                 "futs": {"primary": fut},
                 "spans": {"primary": att}}
        lock = threading.Lock()

        def _finish(which, rep, f):
            """First successful branch wins outer; a branch error waits
            for the other branch before propagating; cancellation (the
            hedge loser) just retires its branch."""
            _reqtrace.finish_future(state["spans"].get(which), f)
            with lock:
                if state["winner"] is not None:
                    return
                if f.cancelled():
                    state["branches"] -= 1
                    if state["branches"] > 0 or not state["errors"]:
                        return
                    last_rep, last_exc = state["errors"][-1]
                elif f.exception() is None:
                    state["winner"] = which
                    if state["timer"] is not None:
                        state["timer"].cancel()
                    if state["hedged"]:
                        outcome = "win" if which == "hedge" else "lose"
                        self._hedge_ctr[outcome].inc()
                        self._hedges[outcome] += 1
                    loser = ("hedge" if which == "primary" else "primary")
                    to_cancel = state["futs"].get(loser)
                    loser_span = state["spans"].get(loser)
                    last_exc = None
                else:
                    exc = f.exception()
                    state["errors"].append((rep, exc))
                    state["branches"] -= 1
                    if not isinstance(exc, ServingOverloadError) \
                            or exc.reason in self._DEATH:
                        rep.breaker.record_failure()
                    if state["branches"] > 0:
                        return
                    last_rep, last_exc = state["errors"][-1]
            if last_exc is None:
                rep.breaker.record_success()
                self._latencies.append(time.monotonic() - t0)
                if to_cancel is not None and not to_cancel.done():
                    to_cancel.cancel()
                if loser_span is not None:
                    # the loser loses even if the engine can no longer
                    # abort it: the trace records who was discarded
                    loser_span.finish("cancelled")
                if outer.set_running_or_notify_cancel():
                    outer.set_result(f.result())
                return
            # every branch failed: typed back-pressure retries with
            # backoff, anything else propagates
            if isinstance(last_exc, ServingOverloadError) \
                    and last_exc.reason not in self._DEATH:
                self._retry_or_fail(
                    outer, last_exc, 0,
                    lambda a: self._dispatch_feed(outer, model, feed,
                                                  tenant, a, tspan=tspan))
                return
            if outer.set_running_or_notify_cancel():
                outer.set_exception(last_exc)

        def _fire_hedge():
            with lock:
                if state["winner"] is not None:
                    return
            hedge_rep = self._pick("engine", exclude=(primary.name,))
            if hedge_rep is None:
                return
            hatt = _reqtrace.start_span(
                f"dispatch:{hedge_rep.name}", kind="attempt",
                parent=tspan,
                attrs={"replica": hedge_rep.name, "attempt": attempt,
                       "hedge": True})
            try:
                _fault.on_serve(hedge_rep.name)
                with _reqtrace.attach(hatt):
                    hfut = hedge_rep.engine.submit(model, feed,
                                                   tenant=tenant)
            except Exception as e:
                if hatt is not None:
                    hatt.finish("error", error=e)
                return  # the primary is still in flight; hedge is optional
            with lock:
                if state["winner"] is not None:
                    hfut.cancel()
                    if hatt is not None:
                        hatt.finish("cancelled")
                    return
                state["hedged"] = True
                state["branches"] += 1
                state["futs"]["hedge"] = hfut
                state["spans"]["hedge"] = hatt
            hfut.add_done_callback(
                lambda f: _finish("hedge", hedge_rep, f))

        delay = self._hedge_delay_s()
        if delay is not None and len(self.replicas("engine")) > 1:
            timer = threading.Timer(delay, _fire_hedge)
            timer.daemon = True
            with lock:
                state["timer"] = timer
            timer.start()
        fut.add_done_callback(lambda f: _finish("primary", primary, f))

    # -- retry machinery ----------------------------------------------------

    def _retry_or_fail(self, outer, exc, attempt, redispatch):
        """Typed-rejection path: schedule `redispatch(attempt+1)` after
        the RetryPolicy backoff, or fail `outer` with the typed error
        once the budget is spent."""
        if not self.retry.should_retry(attempt) or self._closed:
            if outer.set_running_or_notify_cancel():
                outer.set_exception(exc)
            return
        self._retry_ctr.inc()
        with self._lock:
            self._retries += 1
        timer = threading.Timer(self.retry.delay(attempt),
                                lambda: redispatch(attempt + 1))
        timer.daemon = True
        timer.start()

    # -- introspection ------------------------------------------------------

    def hedge_stats(self):
        with self._lock:
            return dict(self._hedges)

    def stats(self):
        """The /routerz payload row for this router."""
        reps = []
        for rep in self.replicas():
            reps.append({
                "name": rep.name,
                "kind": rep.kind,
                "healthy": rep.healthy(),
                "load": rep.load(),
                "breaker": rep.breaker.state_name(),
            })
        with self._lock:
            return {
                "router": self.name,
                "replicas": reps,
                "failovers": self._failovers,
                "hedges": dict(self._hedges),
                "retries": self._retries,
                "hedge_ms": self._hedge_ms,
                "retry_times": self.retry.times,
            }
