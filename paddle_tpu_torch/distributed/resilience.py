"""Resilience primitives: the retry policy and the resilience counters
(the port's copy of ``paddle_tpu/distributed/resilience.py``).

The serving router retries typed admission rejections on a
`RetryPolicy` built from ``FLAGS_rpc_retry_times`` /
``FLAGS_rpc_retry_backoff_ms``, and every retry, injected fault or
probe error bumps one series of ``pt_resilience_events_total{event}``;
`resilience_stats()` is the plain dict view of them.  Standard library
only; flags are read lazily.
"""

from __future__ import annotations

import os
import random

__all__ = ["RetryPolicy", "resilience_stats", "reset_resilience_stats",
           "record"]

# every counter the layer can bump, so resilience_stats() always returns a
# complete dict (tests assert on keys before any event fired)
_KNOWN = (
    "rpc_retries",            # connection-error retries of a single RPC
    "rpc_timeout_retries",    # server liveness-deadline (status 2) retries
    "barrier_rewaits",        # barrier re-waits after a server deadline
    "reconnects",             # successful transparent reconnects
    "reconnect_failures",     # reconnect attempts that found no server
    "channel_evictions",      # broken channels dropped from the cache
    "injected_faults",        # faults fired by the FaultPlan harness
    "supervisor_restarts",    # child processes relaunched by ProcGroup
    "stop_errors",            # endpoints that failed during stop_pservers
    "close_errors",           # channels that failed to close in reset
)


def _family():
    """The shared registry family (lazy: observability registers
    idempotently, and a reset() mid-run only re-creates it)."""
    from paddle_tpu_torch import observability

    return observability.counter(
        "pt_resilience_events_total",
        "Fault-tolerance events (retries, reconnects, evictions, "
        "injected faults, supervisor restarts)", labels=("event",))


def record(event, n=1):
    """Bump a resilience counter (unknown names create a new series)."""
    _family().labels(event=str(event)).inc(int(n))


def resilience_stats():
    """Snapshot of all resilience counters as a plain dict — the exact
    pre-registry shape: every known key present (0 before any event),
    int values, plus any custom events recorded."""
    out = {k: 0 for k in _KNOWN}
    snap = _family()._snapshot()
    for (event,), value in snap["samples"].items():
        out[event] = int(value)
    return out


def reset_resilience_stats():
    _family().clear()


class RetryPolicy:
    """Exponential backoff with deterministic jitter.

    times=0 disables retries (fail fast on the first transport error —
    the reference behavior).  Delays grow `backoff_ms * multiplier**attempt`
    capped at `max_backoff_ms`, each scattered by ±`jitter` (fraction) from
    a seeded RNG.  The default seed is the PID so N trainer processes
    hammering one restarting pserver spread out instead of re-dialing in
    lockstep; pass an explicit seed for a reproducible schedule in tests.
    """

    def __init__(self, times=None, backoff_ms=None, multiplier=2.0,
                 max_backoff_ms=5000.0, jitter=0.25, seed=None):
        if times is None or backoff_ms is None:
            from paddle_tpu_torch.fluid import flags
            if times is None:
                times = flags.flag("rpc_retry_times")
            if backoff_ms is None:
                backoff_ms = flags.flag("rpc_retry_backoff_ms")
        self.times = max(0, int(times))
        self.backoff_ms = float(backoff_ms)
        self.multiplier = float(multiplier)
        self.max_backoff_ms = float(max_backoff_ms)
        self.jitter = float(jitter)
        self._seed = os.getpid() if seed is None else seed
        self._rng = random.Random(self._seed)

    def should_retry(self, attempt) -> bool:
        """attempt is 0-based: True while fewer than `times` retries ran."""
        return attempt < self.times

    def _delay_with(self, attempt, rng) -> float:
        base = min(self.backoff_ms * (self.multiplier ** attempt),
                   self.max_backoff_ms)
        spread = 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(0.0, base * spread) / 1000.0

    def delay(self, attempt) -> float:
        """Seconds to sleep before retry number `attempt` (0-based)."""
        return self._delay_with(attempt, self._rng)

    def delays(self):
        """The schedule a fresh retry run would see (tests/logging) —
        computed on a clone RNG so peeking never desynchronizes the live
        jitter sequence."""
        rng = random.Random(self._seed)
        return [self._delay_with(a, rng) for a in range(self.times)]
