"""Declarative SLOs and multi-window multi-burn-rate alerts over the
metrics registry (the port's copy of ``paddle_tpu/observability/slo.py``).

An `SLOSpec` names an objective over families that already exist in the
registry:

  availability   bad / total counter selectors (label-filtered sums),
                 e.g. bad=pt_serve_failovers_total{router="drill"} over
                 total=pt_serve_requests_total
  latency        a histogram and a threshold: "bad" is every observation
                 above the smallest bucket bound >= the threshold,
                 "total" the observation count

`SLOEngine.evaluate()` snapshots the registry, appends (t, bad, total)
per spec to a sample ring, and computes the error ratio over each alert
window from the ring's deltas.  Burn rate = ratio / (1 - objective).  A
multi-window pair fires when both its short and its long window burn
above the pair's threshold, and an active alert clears when the short
window drops back below it:

  page    5 m /  1 h   burn > 14.4
  ticket  30 m /  6 h  burn >  6.0

``window_scale`` shrinks every window proportionally; the failover drill
(serving/drill.py) runs the same arithmetic at second scale and requires
its availability alert to fire during a replica kill and clear after
recovery.

Surfaces: the ``pt_slo_burn_rate{slo,window}`` and
``pt_slo_error_budget_remaining{slo}`` gauges, the
``pt_slo_alerts_total{slo,severity}`` counter, ``slo_alert`` events and
the ``/sloz`` page.  ``FLAGS_slo_specs`` (see `parse_spec`) and
``FLAGS_slo_eval_interval_s`` drive the flag-configured evaluator
(`ensure_from_flags`).  Standard library only; the clock is injectable.
"""

from __future__ import annotations

import math
import threading
import time

from . import events as _events
from . import metrics as _metrics

__all__ = ["SLOSpec", "SLOEngine", "BurnWindow", "parse_spec",
           "parse_specs", "DEFAULT_WINDOWS", "sloz_payload",
           "ensure_from_flags", "stop_flag_engine"]


class BurnWindow:
    """One multi-window alert rule: fire when burn(short) AND burn(long)
    exceed ``threshold``; clear when burn(short) falls below it."""

    __slots__ = ("severity", "short_s", "long_s", "threshold")

    def __init__(self, severity, short_s, long_s, threshold):
        self.severity = str(severity)
        self.short_s = float(short_s)
        self.long_s = float(long_s)
        self.threshold = float(threshold)

    def scaled(self, scale):
        return BurnWindow(self.severity, self.short_s * scale,
                          self.long_s * scale, self.threshold)


# the SRE-workbook pairs for a 30-day budget
DEFAULT_WINDOWS = (
    BurnWindow("page", 300.0, 3600.0, 14.4),
    BurnWindow("ticket", 1800.0, 21600.0, 6.0),
)


def _sum_matching(fam, filters):
    """Sum a family's counter samples whose labels satisfy ``filters``
    (a {label: value} subset match)."""
    if not fam:
        return 0.0
    names = tuple(fam.get("label_names", ()))
    total = 0.0
    for key, val in fam.get("samples", {}).items():
        labels = dict(zip(names, key))
        if all(labels.get(k) == v for k, v in filters.items()):
            total += float(val)
    return total


def _hist_bad_total(fam, filters, threshold_s):
    """(bad, total) for a latency objective: observations above the
    smallest bucket bound >= threshold vs all observations."""
    if not fam:
        return 0.0, 0.0
    names = tuple(fam.get("label_names", ()))
    bad = total = 0.0
    for key, sample in fam.get("samples", {}).items():
        labels = dict(zip(names, key))
        if not all(labels.get(k) == v for k, v in filters.items()):
            continue
        count = float(sample.get("count") or 0)
        total += count
        under = 0.0
        for le, cum in sample.get("buckets") or ():
            if le >= threshold_s and not math.isinf(le):
                under = float(cum)
                break
        else:
            under = count  # threshold beyond the last finite bound
        bad += max(count - under, 0.0)
    return bad, total


class SLOSpec:
    """One objective.  ``kind="availability"``: ``bad``/``total`` are
    ``(family_name, {label: value})`` counter selectors.
    ``kind="latency"``: ``hist`` is a histogram selector and
    ``threshold_s`` the latency bound; objective applies to the fraction
    under the bound."""

    def __init__(self, name, kind, objective, bad=None, total=None,
                 hist=None, threshold_s=None):
        if not 0.0 < float(objective) < 1.0:
            raise ValueError(
                f"slo {name!r}: objective must be in (0, 1), got "
                f"{objective}")
        self.name = str(name)
        self.kind = str(kind)
        self.objective = float(objective)
        if self.kind == "availability":
            if not bad or not total:
                raise ValueError(
                    f"slo {name!r}: availability needs bad= and total= "
                    f"counter selectors")
            self.bad = (str(bad[0]), dict(bad[1] or {}))
            self.total = (str(total[0]), dict(total[1] or {}))
            self.hist = None
            self.threshold_s = None
        elif self.kind == "latency":
            if not hist or threshold_s is None:
                raise ValueError(
                    f"slo {name!r}: latency needs hist= and threshold_s=")
            self.hist = (str(hist[0]), dict(hist[1] or {}))
            self.threshold_s = float(threshold_s)
            self.bad = self.total = None
        else:
            raise ValueError(
                f"slo {name!r}: kind must be 'availability' or "
                f"'latency', got {kind!r}")

    def counts(self, snapshot):
        """(bad, total) cumulative counts from a registry snapshot."""
        if self.kind == "availability":
            return (_sum_matching(snapshot.get(self.bad[0]), self.bad[1]),
                    _sum_matching(snapshot.get(self.total[0]),
                                  self.total[1]))
        return _hist_bad_total(snapshot.get(self.hist[0]), self.hist[1],
                               self.threshold_s)

    def describe(self):
        if self.kind == "availability":
            return {"name": self.name, "kind": self.kind,
                    "objective": self.objective,
                    "bad": [self.bad[0], self.bad[1]],
                    "total": [self.total[0], self.total[1]]}
        return {"name": self.name, "kind": self.kind,
                "objective": self.objective,
                "hist": [self.hist[0], self.hist[1]],
                "threshold_s": self.threshold_s}


# ---------------------------------------------------------------------------
# spec grammar (FLAGS_slo_specs)
# ---------------------------------------------------------------------------


def _parse_selector(text):
    """'family{label=value,label2=value2}' -> (family, {label: value})."""
    text = text.strip()
    if "{" not in text:
        return text, {}
    fam, _, rest = text.partition("{")
    body = rest.rstrip("}")
    filters = {}
    for pair in filter(None, (p.strip() for p in body.split(","))):
        k, sep, v = pair.partition("=")
        if not sep or not k.strip():
            raise ValueError(f"bad selector filter {pair!r} in {text!r}")
        filters[k.strip()] = v.strip().strip('"')
    return fam.strip(), filters


def parse_spec(text):
    """One spec from the FLAGS_slo_specs grammar — '|'-separated fields:

      name|availability|bad=<sel>|total=<sel>|objective=0.999
      name|latency|hist=<sel>|threshold=0.25|objective=0.99

    where <sel> is ``family`` or ``family{label=value,...}``."""
    parts = [p.strip() for p in text.split("|") if p.strip()]
    if len(parts) < 3:
        raise ValueError(f"slo spec needs name|kind|fields..., got "
                         f"{text!r}")
    name, kind = parts[0], parts[1]
    fields = {}
    for p in parts[2:]:
        k, sep, v = p.partition("=")
        if not sep:
            raise ValueError(f"bad slo spec field {p!r} in {text!r}")
        fields[k.strip()] = v.strip()
    objective = float(fields.pop("objective", 0.999))

    def _need(key):
        try:
            return fields.pop(key)
        except KeyError:
            raise ValueError(f"slo spec {name!r} ({kind}) is missing "
                             f"the {key}= field: {text!r}") from None

    if kind == "availability":
        spec = SLOSpec(name, kind, objective,
                       bad=_parse_selector(_need("bad")),
                       total=_parse_selector(_need("total")))
    elif kind == "latency":
        spec = SLOSpec(name, kind, objective,
                       hist=_parse_selector(_need("hist")),
                       threshold_s=float(_need("threshold")))
    else:
        raise ValueError(f"slo spec kind must be availability|latency, "
                         f"got {kind!r}")
    if fields:
        raise ValueError(f"unknown slo spec fields {sorted(fields)} in "
                         f"{text!r}")
    return spec


def parse_specs(text):
    """';'-separated multi-spec form of `parse_spec` (the flag value)."""
    return [parse_spec(chunk) for chunk in text.split(";")
            if chunk.strip()]


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


def _m_burn():
    return _metrics.gauge(
        "pt_slo_burn_rate",
        "Error-budget burn rate per SLO and alert window (1.0 spends "
        "the budget exactly at the objective)", labels=("slo", "window"))


def _m_budget():
    return _metrics.gauge(
        "pt_slo_error_budget_remaining",
        "Fraction of the SLO's error budget remaining over the longest "
        "alert window (1 = untouched, <=0 = spent)", labels=("slo",))


def _m_alerts():
    return _metrics.counter(
        "pt_slo_alerts_total",
        "Multi-window burn-rate alerts fired, by SLO and severity",
        labels=("slo", "severity"))


class SLOEngine:
    """Periodic evaluator over a set of SLOSpecs.  `evaluate()` may be
    driven by the built-in background thread (`start()`), by a caller's
    loop (the drill), or manually with an injected ``now`` (tests)."""

    _MAX_SAMPLES = 4096

    def __init__(self, specs=(), windows=DEFAULT_WINDOWS,
                 window_scale=1.0, registry=None, clock=None):
        scale = float(window_scale)
        if scale <= 0:
            raise ValueError(f"window_scale must be > 0, got {scale}")
        self.windows = tuple(w.scaled(scale) for w in windows)
        self.specs = list(specs)
        self._registry = registry or _metrics.REGISTRY
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        # per spec name: deque of (t, bad, total) cumulative samples
        self._samples = {s.name: [] for s in self.specs}
        # (spec, severity) -> alert state
        self._alerts = {
            (s.name, w.severity): {
                "active": False, "fired_total": 0,
                "t_fired": None, "t_cleared": None,
                "burn_short": 0.0, "burn_long": 0.0,
            }
            for s in self.specs for w in self.windows}
        self._thread = None
        self._stop = threading.Event()

    def add(self, spec):
        with self._lock:
            self.specs.append(spec)
            self._samples[spec.name] = []
            for w in self.windows:
                self._alerts[(spec.name, w.severity)] = {
                    "active": False, "fired_total": 0,
                    "t_fired": None, "t_cleared": None,
                    "burn_short": 0.0, "burn_long": 0.0,
                }
        return spec

    # -- arithmetic --------------------------------------------------------

    @staticmethod
    def _window_ratio(samples, now, window_s):
        """Error ratio over [now - window_s, now] from cumulative
        (t, bad, total) samples: delta bad / delta total, with an
        all-bad 1.0 when bad moved but total did not (a failure path
        that admits nothing still burns budget)."""
        if not samples:
            return 0.0
        cutoff = now - window_s
        base = samples[0]
        for s in samples:
            if s[0] <= cutoff:
                base = s
            else:
                break
        head = samples[-1]
        d_bad = max(head[1] - base[1], 0.0)
        d_total = max(head[2] - base[2], 0.0)
        if d_total <= 0.0:
            return 1.0 if d_bad > 0 else 0.0
        return min(d_bad / d_total, 1.0)

    def evaluate(self, now=None):
        """One evaluation pass: sample the registry, update burn gauges
        and alert state.  Returns {spec: {severity: alert_state}}."""
        now = self._clock() if now is None else float(now)
        snap = self._registry.snapshot()
        burn_g, budget_g, alerts_c = _m_burn(), _m_budget(), _m_alerts()
        out = {}
        with self._lock:
            specs = list(self.specs)
        for spec in specs:
            bad, total = spec.counts(snap)
            with self._lock:
                samples = self._samples[spec.name]
                samples.append((now, bad, total))
                del samples[:-self._MAX_SAMPLES]
                samples = list(samples)
            budget = 1.0 - spec.objective
            longest = max(w.long_s for w in self.windows)
            ratio_long = self._window_ratio(samples, now, longest)
            budget_g.labels(slo=spec.name).set(
                1.0 - ratio_long / budget)
            out[spec.name] = {}
            for w in self.windows:
                b_short = self._window_ratio(samples, now,
                                             w.short_s) / budget
                b_long = self._window_ratio(samples, now,
                                            w.long_s) / budget
                burn_g.labels(slo=spec.name,
                              window=f"{w.severity}_short").set(b_short)
                burn_g.labels(slo=spec.name,
                              window=f"{w.severity}_long").set(b_long)
                with self._lock:
                    st = self._alerts[(spec.name, w.severity)]
                    st["burn_short"], st["burn_long"] = b_short, b_long
                    fire = (not st["active"] and b_short > w.threshold
                            and b_long > w.threshold)
                    clear = st["active"] and b_short < w.threshold
                    if fire:
                        st["active"] = True
                        st["fired_total"] += 1
                        st["t_fired"] = now
                        st["t_cleared"] = None
                    elif clear:
                        st["active"] = False
                        st["t_cleared"] = now
                    state = dict(st)
                if fire:
                    alerts_c.labels(slo=spec.name,
                                    severity=w.severity).inc()
                    _events.emit("slo_alert", slo=spec.name,
                                 severity=w.severity, state="fired",
                                 burn_short=b_short, burn_long=b_long,
                                 threshold=w.threshold)
                elif clear:
                    _events.emit("slo_alert", slo=spec.name,
                                 severity=w.severity, state="cleared",
                                 burn_short=b_short, burn_long=b_long,
                                 threshold=w.threshold)
                out[spec.name][w.severity] = state
        return out

    def alert_state(self, slo, severity):
        with self._lock:
            return dict(self._alerts[(slo, severity)])

    # -- background thread -------------------------------------------------

    def start(self, interval_s=None):
        if interval_s is None:
            from paddle_tpu_torch.fluid import flags as _flags

            interval_s = float(_flags.flag("slo_eval_interval_s"))
        interval_s = max(float(interval_s), 0.01)
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()

            def _loop():
                while not self._stop.wait(timeout=interval_s):
                    try:
                        self.evaluate()
                    except Exception:
                        pass  # an eval hiccup must not kill the loop

            self._thread = threading.Thread(
                target=_loop, daemon=True, name="pt-slo-eval")
            self._thread.start()
        return self

    def stop(self):
        with self._lock:
            thread, self._thread = self._thread, None
        self._stop.set()
        if thread is not None:
            thread.join(timeout=5)

    def payload(self):
        """The /sloz JSON payload for this engine."""
        with self._lock:
            specs = [s.describe() for s in self.specs]
            alerts = {f"{name}/{sev}": dict(st)
                      for (name, sev), st in self._alerts.items()}
        return {
            "specs": specs,
            "windows": [{"severity": w.severity, "short_s": w.short_s,
                         "long_s": w.long_s, "threshold": w.threshold}
                        for w in self.windows],
            "alerts": alerts,
        }


# ---------------------------------------------------------------------------
# /sloz + flag wiring
# ---------------------------------------------------------------------------

# engines visible on /sloz (every constructed-and-registered engine; the
# flag-driven one registers itself)
_engines: list = []
_engines_lock = threading.Lock()
_flag_engine = None


def track(engine):
    with _engines_lock:
        if engine not in _engines:
            _engines.append(engine)
    return engine


def untrack(engine):
    with _engines_lock:
        if engine in _engines:
            _engines.remove(engine)


def sloz_payload():
    with _engines_lock:
        engines = list(_engines)
    return {"engines": [e.payload() for e in engines],
            "n_engines": len(engines)}


def ensure_from_flags():
    """Start the flag-configured SLO evaluator once per process when
    FLAGS_slo_specs is non-empty.  Never fatal: a bad spec warns and
    disables (a typo must not take the serving process down)."""
    global _flag_engine
    if _flag_engine is not None:
        return _flag_engine
    try:
        from paddle_tpu_torch.fluid import flags as _flags

        text = str(_flags.flag("slo_specs"))
    except Exception:
        return None
    if not text.strip():
        return None
    with _engines_lock:
        if _flag_engine is not None:
            return _flag_engine
        try:
            specs = parse_specs(text)
        except Exception as e:
            import warnings

            warnings.warn(f"FLAGS_slo_specs: {e}; SLO evaluator disabled")
            return None
        engine = SLOEngine(specs)
        _flag_engine = engine
        _engines.append(engine)
    _flag_engine.start()
    return _flag_engine


def stop_flag_engine():
    global _flag_engine
    with _engines_lock:
        engine, _flag_engine = _flag_engine, None
        if engine in _engines:
            _engines.remove(engine)
    if engine is not None:
        engine.stop()


try:
    from . import exposition as _exposition

    _exposition.register_page("/sloz", sloz_payload)
except Exception:
    pass
