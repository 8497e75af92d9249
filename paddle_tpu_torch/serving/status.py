"""/servez — the serving lanes' status page (the port's copy of
``paddle_tpu/serving/status.py``).

Every ``serving.Engine`` and ``DecodeEngine`` registers itself here when
it is built and unregisters on ``close()``; the weak registration only
keeps a leaked engine off the page.  The page renders JSON: every live
engine's ``stats()`` (bucket policy, models, queue depths, cache hit
rates, tenants, latency quantiles), the decode lanes' section (slots,
KV pool, evictions) and the request-trace ring's health with its
trace-derived quantiles.  ``GET /servez`` works on any
``observability.MetricsServer`` of the process.
"""

from __future__ import annotations

import threading
import weakref

__all__ = ["servez_payload", "track_engine", "untrack_engine",
           "live_engines", "track_decode_engine",
           "untrack_decode_engine", "live_decode_engines"]

_engines = weakref.WeakSet()
_decode_engines = weakref.WeakSet()
_lock = threading.Lock()


def track_engine(engine):
    """Add an engine to the /servez page (called from Engine.__init__)
    and (re-)register the page with the exposition server.  No
    registered-once latch: register_page is an idempotent no-op for the
    same renderer, and a latch would go stale after an
    unregister_page("/servez") — every later engine would then skip
    registration and /servez would 404 for the rest of the process."""
    with _lock:
        _engines.add(engine)
        from paddle_tpu_torch.observability import exposition

        exposition.register_page("/servez", servez_payload)


def untrack_engine(engine):
    with _lock:
        _engines.discard(engine)


def track_decode_engine(engine):
    """Add a decode-lane engine (serving/decode.py DecodeEngine) to the
    /servez page's "decode" section — same registration contract as
    track_engine."""
    with _lock:
        _decode_engines.add(engine)
        from paddle_tpu_torch.observability import exposition

        exposition.register_page("/servez", servez_payload)


def untrack_decode_engine(engine):
    with _lock:
        _decode_engines.discard(engine)


def live_engines():
    """Snapshot of the engines currently tracked (strong refs)."""
    with _lock:
        return list(_engines)


def live_decode_engines():
    """Snapshot of the decode engines currently tracked."""
    with _lock:
        return list(_decode_engines)


def servez_payload():
    """JSON-serializable /servez body: one entry per live engine, plus
    the decode lane's section (slot occupancy, KV-pool figures,
    eviction counts) and the request-trace ring's health
    (completed/kept/live counts plus trace-derived request
    quantiles)."""
    from paddle_tpu_torch.observability import reqtrace

    return {"engines": [e.stats() for e in live_engines()],
            "decode": [e.stats() for e in live_decode_engines()],
            "reqtrace": {**reqtrace.ring_stats(),
                         **reqtrace.request_quantiles()}}
