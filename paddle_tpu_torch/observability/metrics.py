"""Metrics registry: Counter / Gauge / Histogram with labels (the port's
own copy of ``paddle_tpu/observability/metrics.py``, which is pure
Python; the port imports nothing of the JAX package).

  - Counter    monotonically increasing float (events, bytes, seconds)
  - Gauge      last-write-wins float (queue depth)
  - Histogram  cumulative fixed-bucket latency/size distribution

Each family has a name, help text and a tuple of label NAMES; children
are keyed by label VALUES (``family.labels(model="m")``).  Registering
the same (name, type, labels) twice returns the existing family, so
call sites create their instruments lazily and converge on one object;
a name re-registered with another type or label set raises.

Thread-safe: the registry and every family share one re-entrant lock,
so ``snapshot()`` is a consistent cut.  A histogram observation may
carry an OpenMetrics exemplar (a request's trace id, from
``observability/reqtrace.py``), kept per bucket and rendered by
``observability/exposition.py``.
"""

from __future__ import annotations

import math
import threading

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "counter", "gauge", "histogram", "snapshot", "reset",
    "hist_quantile", "DEFAULT_BUCKETS",
]

# Prometheus client_golang defaults: 5 ms .. 10 s; +Inf is implicit
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0)

_INF = float("inf")


class _Child:
    """One labeled time series of a family."""

    __slots__ = ("_family", "_value", "_bucket_counts", "_sum", "_count",
                 "_exemplars")

    def __init__(self, family):
        self._family = family
        self._value = 0.0
        if family.type == "histogram":
            self._bucket_counts = [0] * (len(family.buckets) + 1)  # +Inf
            self._sum = 0.0
            self._count = 0
            # last exemplar per bucket: None | (labels_dict, value)
            self._exemplars = [None] * (len(family.buckets) + 1)

    # -- counter / gauge -------------------------------------------------
    def inc(self, amount=1.0):
        if self._family.type == "counter" and amount < 0:
            raise ValueError(
                f"counter {self._family.name} cannot decrease "
                f"(inc({amount}))")
        with self._family._lock:
            self._value += float(amount)

    def dec(self, amount=1.0):
        if self._family.type != "gauge":
            raise TypeError(f"{self._family.type} has no dec()")
        with self._family._lock:
            self._value -= float(amount)

    def set(self, value):
        if self._family.type != "gauge":
            raise TypeError(f"{self._family.type} has no set()")
        with self._family._lock:
            self._value = float(value)

    @property
    def value(self):
        with self._family._lock:
            return self._value

    # -- histogram -------------------------------------------------------
    def observe(self, value, exemplar=None):
        """Record one observation.  ``exemplar`` (a trace-id string or a
        label dict) attaches to the bucket the observation lands in;
        the last writer per bucket wins."""
        if self._family.type != "histogram":
            raise TypeError(f"{self._family.type} has no observe()")
        v = float(value)
        if exemplar is not None and not isinstance(exemplar, dict):
            exemplar = {"trace_id": str(exemplar)}
        with self._family._lock:
            # first bucket whose upper bound contains v (le semantics);
            # falls through to the +Inf bucket
            idx = len(self._family.buckets)
            for i, ub in enumerate(self._family.buckets):
                if v <= ub:
                    idx = i
                    break
            self._bucket_counts[idx] += 1
            self._sum += v
            self._count += 1
            if exemplar is not None:
                self._exemplars[idx] = (dict(exemplar), v)

    def hist_data(self):
        """-> {"buckets": [(le, CUMULATIVE count)], "sum": s, "count": n}
        (Prometheus exposition semantics: the +Inf bucket equals
        count).  When a bucket carries an exemplar, ``"exemplars"`` maps
        its ``le`` to ``(labels_dict, observed_value)``; the key is
        absent otherwise."""
        with self._family._lock:
            cum, out, ex = 0, [], {}
            for ub, c, e in zip((*self._family.buckets, _INF),
                                self._bucket_counts, self._exemplars):
                cum += c
                out.append((ub, cum))
                if e is not None:
                    ex[ub] = (dict(e[0]), e[1])
            data = {"buckets": out, "sum": self._sum, "count": self._count}
            if ex:
                data["exemplars"] = ex
            return data


class _Family:
    """A named metric with a fixed label-name schema."""

    def __init__(self, registry, name, help_text, type_, label_names,
                 buckets=None):
        self.name = name
        self.help = help_text
        self.type = type_
        self.label_names = tuple(label_names)
        self.buckets = tuple(sorted(buckets)) if type_ == "histogram" else ()
        self._lock = registry._lock
        self._children: dict[tuple, _Child] = {}

    def labels(self, **label_values):
        if set(label_values) != set(self.label_names):
            raise ValueError(
                f"{self.name} expects labels {self.label_names}, "
                f"got {tuple(label_values)}")
        key = tuple(str(label_values[n]) for n in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _Child(self)
            return child

    def _default_child(self):
        if self.label_names:
            raise ValueError(
                f"{self.name} has labels {self.label_names}; "
                f"use .labels(...)")
        return self.labels()

    # label-free conveniences so `counter(...).inc()` reads naturally
    def inc(self, amount=1.0):
        self._default_child().inc(amount)

    def dec(self, amount=1.0):
        self._default_child().dec(amount)

    def set(self, value):
        self._default_child().set(value)

    def observe(self, value, exemplar=None):
        self._default_child().observe(value, exemplar=exemplar)

    @property
    def value(self):
        return self._default_child().value

    def clear(self):
        """Drop every child series."""
        with self._lock:
            self._children.clear()

    def _snapshot(self):
        with self._lock:
            samples = {}
            for key, child in self._children.items():
                if self.type == "histogram":
                    samples[key] = child.hist_data()
                else:
                    samples[key] = child._value
            return {"type": self.type, "help": self.help,
                    "label_names": self.label_names, "samples": samples}


class Counter(_Family):
    pass


class Gauge(_Family):
    pass


class Histogram(_Family):
    pass


_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Home of metric families; ``snapshot()`` is the read API."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: dict[str, _Family] = {}
        self._epoch = 0

    def _register(self, type_, name, help_text, labels, buckets=None):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.type != type_ or fam.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.type}{fam.label_names}; cannot re-register "
                        f"as {type_}{tuple(labels)}")
                if (type_ == "histogram" and buckets is not None
                        and fam.buckets != tuple(sorted(buckets))):
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {fam.buckets}")
                return fam
            fam = _TYPES[type_](self, name, help_text, type_, labels,
                                buckets=buckets if buckets is not None
                                else DEFAULT_BUCKETS)
            self._families[name] = fam
            return fam

    def counter(self, name, help_text="", labels=()):
        return self._register("counter", name, help_text, labels)

    def gauge(self, name, help_text="", labels=()):
        return self._register("gauge", name, help_text, labels)

    def histogram(self, name, help_text="", labels=(), buckets=None):
        return self._register("histogram", name, help_text, labels,
                              buckets=buckets)

    def get(self, name):
        with self._lock:
            return self._families.get(name)

    def snapshot(self):
        """{name: {type, help, label_names, samples}} — a consistent cut
        of every family.  Counter/gauge samples are floats keyed by the
        label-value tuple; histogram samples are
        {"buckets": [(le, cum)], "sum", "count"}."""
        with self._lock:
            return {name: fam._snapshot()
                    for name, fam in sorted(self._families.items())}

    def reset(self):
        """Drop every family (tests).  Call sites re-register lazily."""
        with self._lock:
            self._families.clear()
            self._epoch += 1

    @property
    def epoch(self):
        """Bumped on every reset(): a call site that caches resolved
        label children compares it to know when to rebind."""
        return self._epoch


# the process-wide default registry
REGISTRY = MetricsRegistry()


def counter(name, help_text="", labels=()):
    return REGISTRY.counter(name, help_text, labels)


def gauge(name, help_text="", labels=()):
    return REGISTRY.gauge(name, help_text, labels)


def histogram(name, help_text="", labels=(), buckets=None):
    return REGISTRY.histogram(name, help_text, labels, buckets=buckets)


def snapshot():
    return REGISTRY.snapshot()


def reset():
    REGISTRY.reset()


def hist_quantile(hist, q):
    """The q-quantile of a histogram sample (``hist_data()`` form) with
    PromQL ``histogram_quantile`` semantics: linear interpolation inside
    the winning bucket (lower bound 0 for the first); the +Inf bucket
    reports the largest finite ``le``.  None on an empty histogram."""
    if not 0.0 <= float(q) <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q!r}")
    buckets = list(hist.get("buckets") or ())
    count = hist.get("count") or 0
    if not count or not buckets:
        return None
    rank = float(q) * count
    prev_le, prev_cum = 0.0, 0
    for le, cum in buckets:
        if cum >= rank:
            if math.isinf(le):
                return prev_le  # observations beyond the last finite bound
            if cum == prev_cum:  # q=0 with an empty leading bucket
                return le
            frac = (rank - prev_cum) / (cum - prev_cum)
            return prev_le + (le - prev_le) * frac
        prev_le, prev_cum = le, cum
    return prev_le
