"""Process identity for telemetry records (the port's copy of the part
of ``paddle_tpu/observability/tracing.py`` the event log reads).

A job's trace id rides the ``PT_TRACE_ID`` environment variable: a
process that finds none mints one and writes it back, so children it
spawns join its trace.  ``run_id`` is the same unless the launcher
exports ``PT_RUN_ID`` per incarnation.  The role and rank come from
``PT_TRACE_ROLE`` / ``PT_TRACE_RANK`` or the ``PADDLE_*`` launcher
contract.  Span ids are pid-prefixed process-local counters (the
request traces of ``observability/reqtrace.py`` mint several a request);
``new_wire_span`` gives the same id as the u64 an RPC frame would carry,
so a wire id and its string form correlate.
"""

from __future__ import annotations

import itertools
import os
import uuid

__all__ = ["job_trace_id", "new_span_id", "new_wire_span",
           "format_wire_span", "run_id", "process_role", "process_rank",
           "process_identity"]

_TRACE_ENV = "PT_TRACE_ID"
_RUN_ENV = "PT_RUN_ID"
_ROLE_ENV = "PT_TRACE_ROLE"

# next() on itertools.count is one C call, atomic under the GIL: the
# serving path mints span ids on every client thread without a lock
_span_counter = itertools.count(1)


def job_trace_id() -> str:
    """The job-wide trace id (minted once, passed to children)."""
    tid = os.environ.get(_TRACE_ENV)
    if not tid:
        tid = uuid.uuid4().hex[:16]
        os.environ[_TRACE_ENV] = tid
    return tid


def run_id() -> str:
    """This run's id: ``PT_RUN_ID`` when the launcher set one, else the
    trace id."""
    rid = os.environ.get(_RUN_ENV)
    if not rid:
        rid = job_trace_id()
        os.environ[_RUN_ENV] = rid
    return rid


def new_span_id() -> str:
    """Process-unique span id: ``<pid hex>-<counter hex>``."""
    return f"{os.getpid():x}-{next(_span_counter):x}"


def new_wire_span():
    """One span id in both encodings: the u64 ``(pid << 32) | counter``
    and the ``pid-counter`` string.  Returns (wire_u64, span_str)."""
    n = next(_span_counter)
    pid = os.getpid()
    return ((pid & 0xffffffff) << 32) | (n & 0xffffffff), f"{pid:x}-{n:x}"


def format_wire_span(wire: int) -> str:
    """The ``pid-counter`` string form of a u64 wire span id."""
    return f"{(wire >> 32) & 0xffffffff:x}-{wire & 0xffffffff:x}"


def process_role() -> str:
    """``PT_TRACE_ROLE``, else "trainer" under the PADDLE_* launcher
    contract, else "proc"."""
    role = os.environ.get(_ROLE_ENV)
    if role:
        return role
    if os.environ.get("PADDLE_TRAINER_ID"):
        return "trainer"
    return "proc"


def process_rank() -> int:
    """``PT_TRACE_RANK``, else ``PADDLE_TRAINER_ID``, else 0."""
    for var in ("PT_TRACE_RANK", "PADDLE_TRAINER_ID"):
        v = os.environ.get(var)
        if v:
            try:
                return int(v)
            except ValueError:
                pass
    return 0


def process_identity() -> dict:
    """The tags every event record carries."""
    return {"pid": os.getpid(), "role": process_role(),
            "rank": process_rank(), "trace_id": job_trace_id(),
            "restart_count": int(
                os.environ.get("PADDLE_RESTART_COUNT", "0") or 0)}
