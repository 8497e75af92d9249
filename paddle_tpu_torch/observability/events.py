"""Structured JSONL event log (the port's copy of
``paddle_tpu/observability/events.py``): step and lifecycle events with
the JAX package's schema.

Each line is one JSON object:

    {"ts": <wall seconds>, "mono": <monotonic seconds>, "event": <name>,
     "run_id": ..., "trace_id": ..., "pid": ..., "role": ..., "rank": ...,
     ...caller fields}

Opt-in: nothing is written unless ``FLAGS_event_log_dir`` (or the
``PT_EVENT_LOG_DIR`` env var, which wins) names a directory.  Each
process appends to its own file (``events_<role><rank>_<pid>.jsonl``).
``emit()`` is safe on hot paths: disabled, it is one attribute check;
enabled, one ``json.dumps`` and a flushed write under a lock.  An IO
failure disables the log with a warning.
"""

from __future__ import annotations

import json
import os
import threading
import time
import warnings

from . import tracing

__all__ = ["EventLog", "emit", "enabled", "configure", "get_log",
           "read_events"]

_lock = threading.Lock()
_log = None          # active EventLog, None = disabled
_configured = False  # the env/flag probe ran


class EventLog:
    """One process's append-only JSONL event stream."""

    def __init__(self, path):
        self.path = str(path)
        self._lock = threading.Lock()
        self._fh = open(self.path, "a", encoding="utf-8")
        self._identity = tracing.process_identity()
        self._run_id = tracing.run_id()

    def emit(self, event, **fields):
        rec = {"ts": time.time(), "mono": time.monotonic(),
               "event": str(event), "run_id": self._run_id,
               **self._identity, **fields}
        line = json.dumps(rec, default=str)
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def _resolve_dir():
    """PT_EVENT_LOG_DIR wins; else FLAGS_event_log_dir."""
    d = os.environ.get("PT_EVENT_LOG_DIR")
    if d:
        return d
    from paddle_tpu_torch.fluid import flags

    return flags.flag("event_log_dir")


def configure(path=None):
    """(Re)configure the process event log.  ``path=None`` probes the
    env and the flag again; an empty resolution disables.  Returns the
    active log, or None."""
    global _log, _configured
    with _lock:
        _configured = True
        if _log is not None:
            _log.close()
            _log = None
        try:
            if path is None:
                d = _resolve_dir()
                if not d:
                    return None
                os.makedirs(d, exist_ok=True)
                ident = tracing.process_identity()
                path = os.path.join(
                    d, f"events_{ident['role']}{ident['rank']}_"
                       f"{ident['pid']}.jsonl")
            _log = EventLog(path)
        except OSError as e:
            # losing telemetry must never stop a run
            warnings.warn(f"event log disabled ({e})")
            _log = None
        return _log


def get_log():
    """The active EventLog, probing the env and flag on first call."""
    if not _configured:
        configure()
    return _log


def enabled() -> bool:
    return get_log() is not None


def emit(event, **fields):
    """Write one event if the log is enabled; never raises."""
    global _log
    log = get_log()
    if log is None:
        return
    try:
        log.emit(event, **fields)
    except (OSError, TypeError, ValueError) as e:
        warnings.warn(f"event log write failed, disabling ({e})")
        with _lock:
            _log = None


def read_events(path):
    """Parse one JSONL event file into a list of dicts."""
    out = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
