"""Process identity for telemetry records (the port's copy of the part
of ``paddle_tpu/observability/tracing.py`` the event log reads).

A job's trace id rides the ``PT_TRACE_ID`` environment variable: a
process that finds none mints one and writes it back, so children it
spawns join its trace.  ``run_id`` is the same unless the launcher
exports ``PT_RUN_ID`` per incarnation.  The role and rank come from
``PT_TRACE_ROLE`` / ``PT_TRACE_RANK`` or the ``PADDLE_*`` launcher
contract.  Span ids and the RPC wire encoding are not ported (the port
has no RPC lane).
"""

from __future__ import annotations

import os
import uuid

__all__ = ["job_trace_id", "run_id", "process_role", "process_rank",
           "process_identity"]

_TRACE_ENV = "PT_TRACE_ID"
_RUN_ENV = "PT_RUN_ID"
_ROLE_ENV = "PT_TRACE_ROLE"


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
