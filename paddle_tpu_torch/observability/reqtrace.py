"""Request-scoped serving traces with tail-based sampling (the port's
copy of ``paddle_tpu/observability/reqtrace.py``).  One request is one
trace:

  request  root span, minted at the Frontend (an ``x-pt-trace`` request
           header joins an upstream trace) or at the Router or engine
           admission edge for direct callers
  attempt  one Router dispatch (retry, hedge, failover); a hedge loser
           finishes ``status="cancelled"``, the winner ``"ok"``
  serve    the engine-side life of the request (admission to future
           resolution); carries TTFT/TPOT/token attrs on the decode lane
  batch    one shared batch execution or decode step; every request
           span that rode it LINKS to it (fan-in)

Spans are plain objects behind one module lock; with ``FLAGS_reqtrace``
off every constructor returns None.  A finished span exemplar-tags the
latency histograms and, while a ``torch.profiler`` session records,
lands in its trace as a ``span:<name>`` range carrying the trace and
span ids (``profiling.record_span``).

Tail-based sampling: every completed trace enters a bounded ring
(``FLAGS_reqtrace_ring``); traces that error or exceed the ring's live
p99 are marked kept and written to the JSONL event log.  ``/tracez``
renders the slowest recent traces with their span trees.

Propagation is a thread-local context: the Frontend and the Router
``attach()`` the active span around the synchronous engine-call edge,
and the engine reads ``current_span()`` at admission.

Standard library only, like the rest of the observability package.
"""

from __future__ import annotations

import collections
import concurrent.futures as _futures
import threading
import time

from . import events as _events
from . import profiling as _profiling
from . import tracing as _tracing

__all__ = [
    "Span", "enabled", "start_request", "start_span", "start_batch",
    "attach", "current_span", "current_trace_id", "finish_future",
    "get_trace", "completed", "request_quantiles", "tracez_payload",
    "ring_stats", "reset",
]

_lock = threading.RLock()
_tls = threading.local()

# trace_id -> {"trace_id", "name", "t_start", "spans": [Span, ...]}
_live: dict = {}
# completed trace dicts, oldest first; maxlen follows FLAGS_reqtrace_ring
_ring: collections.deque = collections.deque(maxlen=256)
_ring_maxlen = 256
# finished batch spans by span id (requests link to these across traces);
# sized past the trace ring so links in retained traces stay resolvable
_batch: "collections.OrderedDict[str, dict]" = collections.OrderedDict()
_BATCH_KEEP_FACTOR = 4

# below this many completed traces the live p99 is noise: only errors
# are tail-kept until the ring has history
_MIN_P99_HISTORY = 8

# sorting the full ring costs ~40us; the tail-keep threshold tolerates
# slack, so the sorted value is reused for this many completions
_P99_REFRESH = 32
_p99_cache = None
_p99_countdown = 0

_flags_mod = None


def _flag(name, default):
    global _flags_mod
    if _flags_mod is None:
        try:
            from paddle_tpu_torch.fluid import flags as _flags

            _flags_mod = _flags
        except Exception:
            return default
    try:
        return _flags_mod.flag(name)
    except Exception:
        return default


def enabled() -> bool:
    return bool(_flag("reqtrace", True))


def _ring_cap() -> int:
    global _ring, _ring_maxlen
    cap = max(int(_flag("reqtrace_ring", 256)), 1)
    if cap != _ring_maxlen:
        with _lock:
            if cap != _ring_maxlen:
                _ring = collections.deque(_ring, maxlen=cap)
                _ring_maxlen = cap
    return _ring_maxlen


class Span:
    """One span of a request trace.  Never constructed directly — use
    `start_request` / `start_span` / `start_batch`."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "kind",
                 "t_start", "_t0", "duration_s", "status", "attrs",
                 "links", "_root")

    def __init__(self, trace_id, name, kind, parent_id=None, attrs=None,
                 root=False):
        self.trace_id = trace_id
        self.span_id = _tracing.new_span_id()
        self.parent_id = parent_id
        self.name = str(name)
        self.kind = str(kind)
        self.t_start = time.time()
        self._t0 = time.perf_counter()
        self.duration_s = None   # None while open
        self.status = None       # "ok" | "error" | "cancelled"
        self.attrs = dict(attrs) if attrs else {}
        self.links = []          # span ids of shared batch spans
        self._root = bool(root)

    def set_attr(self, key, value):
        self.attrs[str(key)] = value
        return self

    def link(self, span_or_id):
        """Fan-in link to a shared batch span (by Span or span id)."""
        sid = getattr(span_or_id, "span_id", span_or_id)
        if sid not in self.links:
            self.links.append(sid)
        return self

    def finish(self, status="ok", error=None, **attrs):
        """Close the span (idempotent — the first finish wins: a hedge
        loser marked cancelled must not be flipped 'ok' by its own late
        future callback).  Only the status gate sits under the lock;
        the winner past the gate owns the span exclusively."""
        t_done = time.perf_counter()
        with _lock:
            if self.status is not None:
                return self
            self.status = str(status)
        self.duration_s = max(t_done - self._t0, 0.0)
        if error is not None:
            self.attrs["error"] = repr(error)
        if attrs:
            self.attrs.update(attrs)
        _emit_profiler_span(self)
        if self.kind == "batch":
            _retire_batch(self)
        elif self._root:
            _complete_trace(self)
        return self

    def as_dict(self):
        return {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "trace_id": self.trace_id,
            "name": self.name,
            "kind": self.kind,
            "t_start": self.t_start,
            "duration_s": self.duration_s,
            "status": self.status,
            "attrs": dict(self.attrs),
            "links": list(self.links),
        }


def _emit_profiler_span(span):
    """Land the span in a recording torch.profiler trace with the
    trace and span ids in its args.  A profiler hiccup never fails a
    request."""
    try:
        args = {"trace": span.trace_id, "span": span.span_id,
                "kind": span.kind, "duration_s": span.duration_s}
        if span.parent_id:
            args["parent"] = span.parent_id
        if span.links:
            args["links"] = list(span.links)
        _profiling.record_span(f"span:{span.name}", args)
    except Exception:
        pass


# ---------------------------------------------------------------------------
# span creation + thread-local propagation
# ---------------------------------------------------------------------------


def start_request(name, trace_id=None, attrs=None, kind="request"):
    """Mint a new trace rooted at one request span.  Returns None when
    FLAGS_reqtrace is off (every consumer handles the None span).
    ``trace_id`` joins an upstream trace (the `x-pt-trace` header)."""
    if not enabled():
        return None
    tid = str(trace_id) if trace_id else _tracing.new_span_id().replace(
        "-", "") + format(int(time.time() * 1e6) & 0xffffff, "x")
    span = Span(tid, name, kind, attrs=attrs, root=True)
    # dict store is atomic under the GIL — submit runs on every client
    # thread concurrently, so the hot path takes no lock here
    _live[tid] = {"trace_id": tid, "name": span.name,
                  "t_start": span.t_start, "spans": [span]}
    return span


def start_span(name, kind="span", parent=None, attrs=None):
    """Child span under ``parent`` (default: the thread's current span).
    Returns None when disabled or there is no parent trace to join."""
    if not enabled():
        return None
    parent = parent if parent is not None else current_span()
    if parent is None:
        return None
    span = Span(parent.trace_id, name, kind, parent_id=parent.span_id,
                attrs=attrs)
    rec = _live.get(parent.trace_id)  # get/append: atomic under the GIL
    if rec is not None:
        rec["spans"].append(span)
    return span


def start_batch(name, attrs=None):
    """A shared batch-execute/decode-step span.  It belongs to no single
    trace — participating request spans `link()` to it, and it is kept
    in a bounded side ring after finish so retained traces can resolve
    the fan-in."""
    if not enabled():
        return None
    return Span("", name, "batch", attrs=attrs)


def _retire_batch(span):
    with _lock:
        _batch[span.span_id] = span.as_dict()
        cap = _ring_cap() * _BATCH_KEEP_FACTOR
        while len(_batch) > cap:
            _batch.popitem(last=False)


class _Attach:
    __slots__ = ("_span",)

    def __init__(self, span):
        self._span = span

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self._span)
        return self._span

    def __exit__(self, *exc):
        _tls.stack.pop()
        return False


def attach(span):
    """Context manager making ``span`` the thread's current span across
    a synchronous call edge (Router → engine submit).  ``attach(None)``
    is a transparent no-op so call sites never branch on enablement."""
    return _Attach(span)


def current_span():
    stack = getattr(_tls, "stack", None)
    for span in reversed(stack or ()):
        if span is not None:
            return span
    return None


def current_trace_id():
    span = current_span()
    return span.trace_id if span is not None else None


def finish_future(span, fut, **attrs):
    """Finish ``span`` from a resolved future's state: cancelled /
    error / ok.  The standard done-callback hook for spans whose
    completion edge IS a future.  One state query: each Future accessor
    takes the future's condition lock, and this runs inside the
    engine's future-resolution loop."""
    if span is None:
        return
    try:
        exc = fut.exception()
    except _futures.CancelledError:
        span.finish("cancelled", **attrs)
        return
    if exc is not None:
        span.finish("error", error=exc, **attrs)
    else:
        span.finish("ok", **attrs)


# ---------------------------------------------------------------------------
# completion, tail-keep policy, export
# ---------------------------------------------------------------------------


def _live_p99():
    """Ring p99 with the sort amortised over ``_P99_REFRESH``
    completions (caller holds ``_lock``): the tail-keep threshold only
    needs to be *recent*, not exact-per-completion, and the full-ring
    sort is the single most expensive step on the request hot path."""
    global _p99_cache, _p99_countdown
    if _p99_cache is not None and _p99_countdown > 0:
        _p99_countdown -= 1
        return _p99_cache
    durs = sorted(t["latency_s"] for t in _ring
                  if t.get("latency_s") is not None)
    if len(durs) < _MIN_P99_HISTORY:
        return None
    _p99_cache = durs[min(int(0.99 * (len(durs) - 1)), len(durs) - 1)]
    _p99_countdown = _P99_REFRESH
    return _p99_cache


def _complete_trace(root):
    """Book the finished trace into the ring.  This runs once per
    served request (on the engine thread, inside the future-resolution
    loop), so it does the bare minimum: the live record ITSELF becomes
    the ring entry — Span objects and all — stamped with the outcome
    and the tail-keep verdict.  Readers materialise span dicts, the
    batch fan-in, and TTFT/TPOT lazily via `_public_trace`; reads are
    rare (/tracez, tests) while completions are the hot path."""
    _ring_cap()
    rec = _live.pop(root.trace_id, None)  # dict.pop: atomic, no lock
    if rec is None:
        return
    rec["latency_s"] = root.duration_s
    rec["status"] = root.status
    with _lock:
        p99 = _live_p99()
        # tail-keep: errors always; slow outliers once the ring has
        # enough history for a meaningful live p99
        kept = root.status != "ok" or (
            p99 is not None and root.duration_s is not None
            and root.duration_s > p99)
        rec["kept"] = bool(kept)
        _ring.append(rec)
        if kept:
            trace = _public_trace(rec)
    if kept:
        _events.emit("reqtrace", trace_id=trace["trace_id"],
                     name=trace["name"], status=trace["status"],
                     latency_s=trace["latency_s"],
                     ttft_s=trace["ttft_s"], tpot_s=trace["tpot_s"],
                     n_spans=trace["n_spans"], spans=trace["spans"])


def _public_trace(t):
    """The reader-facing trace dict: span dicts materialised, the batch
    fan-in resolved, TTFT/TPOT lifted from serve-span attrs.  Caller
    holds ``_lock``.  Batch spans are resolved at read: `_batch` keeps
    ``_BATCH_KEEP_FACTOR``× the trace ring, so a ring trace's linked
    batches are still present."""
    span_objs = t["spans"]
    spans = [s.as_dict() for s in span_objs]
    ttft = tpot = None
    linked = []
    for s in span_objs:
        ttft = s.attrs.get("ttft_s", ttft)
        tpot = s.attrs.get("tpot_s", tpot)
        for sid in s.links:
            if sid not in linked:
                linked.append(sid)
    for sid in linked:
        b = _batch.get(sid)
        if b is not None:
            spans.append(b)
    return {"trace_id": t["trace_id"], "name": t["name"],
            "t_start": t["t_start"], "latency_s": t.get("latency_s"),
            "status": t.get("status"), "ttft_s": ttft, "tpot_s": tpot,
            "n_spans": len(spans), "kept": t.get("kept", False),
            "spans": spans}


def get_trace(trace_id):
    """Completed (ring) or still-live trace by id; None if evicted."""
    with _lock:
        for t in reversed(_ring):
            if t["trace_id"] == trace_id:
                return _public_trace(t)
        rec = _live.get(trace_id)
        if rec is not None:
            return {"trace_id": trace_id, "name": rec["name"],
                    "t_start": rec["t_start"], "status": "live",
                    "latency_s": None, "kept": False,
                    "spans": [s.as_dict() for s in rec["spans"]]}
    return None


def completed(n=None):
    """The last ``n`` completed traces (ring order, oldest first)."""
    with _lock:
        traces = list(_ring)
        if n is not None:
            traces = traces[-int(n):]
        return [_public_trace(t) for t in traces]


def ring_stats():
    with _lock:
        kept = sum(1 for t in _ring if t.get("kept"))
        return {"size": len(_ring), "capacity": _ring_cap(),
                "kept": kept, "live": len(_live),
                "batch_spans": len(_batch)}


def _quantile(sorted_vals, q):
    if not sorted_vals:
        return None
    i = min(int(q * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
    return sorted_vals[i]


def request_quantiles(qs=(0.5, 0.99)):
    """Per-request latency / TTFT / TPOT quantiles computed from the
    COMPLETED-TRACE ring (the span tree, not the aggregate histogram)
    — what the bench rungs embed as trace-derived truth."""
    with _lock:
        snap = [(t.get("latency_s"), t["spans"]) for t in _ring
                if t.get("status") == "ok"]
    vals = {"latency_s": [], "ttft_s": [], "tpot_s": []}
    for latency, span_objs in snap:
        if latency is not None:
            vals["latency_s"].append(latency)
        ttft = tpot = None
        for s in span_objs:
            ttft = s.attrs.get("ttft_s", ttft)
            tpot = s.attrs.get("tpot_s", tpot)
        if ttft is not None:
            vals["ttft_s"].append(ttft)
        if tpot is not None:
            vals["tpot_s"].append(tpot)
    out = {"count": len(snap)}
    for key, vs in vals.items():
        vs.sort()
        out[key] = {f"p{int(q * 100)}": _quantile(vs, q) for q in qs} \
            if vs else None
    return out


def reset():
    """Drop all trace state (tests)."""
    global _p99_cache, _p99_countdown
    with _lock:
        _live.clear()
        _ring.clear()
        _batch.clear()
        _p99_cache = None
        _p99_countdown = 0
    _tls.stack = []


# ---------------------------------------------------------------------------
# /tracez
# ---------------------------------------------------------------------------


def _render_span_tree(spans, lines):
    by_parent: dict = {}
    by_id = {s["span_id"]: s for s in spans}
    roots = []
    for s in spans:
        pid = s.get("parent_id")
        if pid and pid in by_id:
            by_parent.setdefault(pid, []).append(s)
        else:
            roots.append(s)

    def walk(span, depth):
        dur = span.get("duration_s")
        dur_txt = f"{dur * 1e3:9.3f} ms" if dur is not None else "     open"
        links = ""
        if span.get("links"):
            links = "  links=" + ",".join(span["links"])
        attrs = span.get("attrs") or {}
        attr_txt = "".join(
            f" {k}={attrs[k]}" for k in sorted(attrs) if k != "error")
        if "error" in attrs:
            attr_txt += f" error={attrs['error']}"
        lines.append(f"    {'  ' * depth}{span['kind']}:{span['name']} "
                     f"[{span.get('status')}] {dur_txt}"
                     f"{attr_txt}{links}")
        for child in by_parent.get(span["span_id"], ()):
            walk(child, depth + 1)

    for r in roots:
        walk(r, 0)


def tracez_payload(limit=20):
    """Human-readable /tracez: ring stats then the slowest recent
    completed traces, each with its span tree."""
    stats = ring_stats()
    with _lock:
        traces = [_public_trace(t) for t in sorted(
            _ring, key=lambda t: (t.get("latency_s") or 0.0),
            reverse=True)[:int(limit)]]
    lines = [
        "reqtrace — request-scoped serving traces",
        f"ring: {stats['size']}/{stats['capacity']} completed, "
        f"{stats['kept']} tail-kept, {stats['live']} live, "
        f"{stats['batch_spans']} batch spans",
        f"enabled: {enabled()}",
        "",
        f"slowest {len(traces)} completed traces:",
    ]
    for t in traces:
        lat = t.get("latency_s")
        lat_txt = f"{lat * 1e3:.3f} ms" if lat is not None else "?"
        kept = " KEPT" if t.get("kept") else ""
        lines.append(f"  {t['trace_id']}  {t['name']}  "
                     f"[{t['status']}]  {lat_txt}{kept}")
        _render_span_tree(t.get("spans") or (), lines)
    return "\n".join(lines) + "\n", "text/plain; charset=utf-8"


def _tracez_page():
    return tracez_payload()


try:  # page registration is idempotent for the same renderer
    from . import exposition as _exposition

    _exposition.register_page("/tracez", _tracez_page)
except Exception:
    pass
