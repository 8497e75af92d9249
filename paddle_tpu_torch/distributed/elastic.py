"""Preemption-aware drain: the drain half of
``paddle_tpu/distributed/elastic.py`` (its ``DrainHandler``,
``install_drain_handler``, ``current_drain`` and ``drain_requested``).

SIGTERM sets ``DrainHandler.requested`` instead of killing the process.
The serving lanes poll ``drain_requested()``: ``DecodeEngine`` stops
admission, fails its queued requests typed and lets the sequences in
its decode slots finish; ``serving.Engine``'s lanes fail their queues
typed.  ``Frontend.install_drain`` runs the whole order (admission off,
replicas drained, open responses written, listener closed) and then
``finish()``, which drops the supervisor's drain marker, restores the
previous handlers and re-delivers the signal.

Not ported (ROADMAP): the membership half — ``join_job`` /
``leave_job``, the lease heartbeat, epoch agreement and
``reinit_collective`` / ``rebuild_mesh`` — which needs the PS runtime
and a multi-process lane the port does not have yet.
"""

from __future__ import annotations

import os
import signal
import threading

__all__ = ["DrainHandler", "install_drain_handler", "drain_requested",
           "current_drain", "DRAIN_MARKER_ENV"]

# a supervisor exports this dir to its children; a drained child drops
# `drained.<pid>` there so its exit by signal reads as a clean leave
DRAIN_MARKER_ENV = "PT_DRAIN_NOTIFY_DIR"


class DrainHandler:
    """Preemption-aware graceful drain: SIGTERM sets `requested` instead
    of killing the process.  The serving lanes poll it
    (`drain_requested()`): a `DecodeEngine` built with
    `drain_on_sigterm` stops admission and finishes its slotted
    sequences, a `serving.Engine` fails its queues typed.
    `Frontend.install_drain` waits on `requested`, drains the frontend,
    the replicas and the listener in turn, and then calls `finish()`.

    The previous handlers are captured and chained: this handler defers
    the chain rather than invoking it inline, because the chain
    typically ENDS the process and the whole point is to finish the
    in-flight work first."""

    def __init__(self, signals=None):
        self.requested = threading.Event()
        self.signum = None
        self._signals = tuple(signals) if signals else (signal.SIGTERM,)
        self._prev = {}
        self._finished = False

    def install(self):
        for sig in self._signals:
            try:
                self._prev[sig] = signal.signal(sig, self._on_signal)
            except ValueError:  # non-main thread: cannot install
                break
        return self

    def _on_signal(self, signum, frame):
        # async-signal-safe on purpose: no locks, no IO — a real SIGTERM
        # can land while the main thread holds the event log's
        # non-reentrant lock, and an emit() here would deadlock the
        # process inside the handler.  The drain_requested event is
        # emitted from finish(), on a normal execution context.
        self.signum = signum
        self.requested.set()

    def marker_path(self):
        d = os.environ.get(DRAIN_MARKER_ENV, "")
        return os.path.join(d, f"drained.{os.getpid()}") if d else None

    def uninstall(self):
        """Restore the handlers active before install(); safe twice."""
        for sig in list(self._prev):
            prev = self._prev.pop(sig)
            try:
                # restoring, not registering a new hook: nothing to chain
                signal.signal(sig, prev if prev is not None  # resilience: allow
                              else signal.SIG_DFL)
            except ValueError:  # non-main thread: keep record for later
                self._prev[sig] = prev
                break

    def finish(self):
        """Complete the drain (`Frontend.install_drain` calls it once the
        frontend, the replicas and the listener are drained): the
        supervisor's marker, the handlers restored, and — when a signal
        actually arrived — the signal re-delivered so the previous chain
        (by default, termination) runs now that the in-flight work is
        done.  Without a received signal it simply returns and the
        caller exits normally."""
        import signal as _signal

        if self._finished:
            return
        self._finished = True
        marker = self.marker_path()
        if marker:
            try:
                os.makedirs(os.path.dirname(marker), exist_ok=True)
                with open(marker, "w") as f:
                    f.write(f"signum={self.signum}\n")
            except OSError:
                from paddle_tpu_torch.distributed import resilience
                resilience.record("drain_marker_failures")
        from paddle_tpu_torch.observability import events

        if self.signum is not None:
            events.emit("drain_requested", signum=int(self.signum))
        events.emit("drain_complete", signum=self.signum)
        self.uninstall()
        if self.signum is not None:
            _signal.raise_signal(self.signum)


_drain = None
_drain_lock = threading.Lock()


def install_drain_handler(signals=None):
    """Install (once) the process drain handler; returns it.  Idempotent:
    repeat calls return the existing handler."""
    global _drain
    with _drain_lock:
        if _drain is None:
            _drain = DrainHandler(signals=signals).install()
        return _drain


def current_drain():
    return _drain


def drain_requested() -> bool:
    return _drain is not None and _drain.requested.is_set()
