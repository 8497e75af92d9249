"""Typed serving-path errors (a copy of ``paddle_tpu/serving/errors.py``,
kept in the port so the port imports nothing of the JAX package).

Admission rejection is a load-shedding signal the client retries with
backoff; a feed error is a caller bug that must fail at the edge, never
inside a shared batch; pool exhaustion is internal to the decode
scheduler, which evicts and retries.
"""

from __future__ import annotations

__all__ = ["ServingError", "ServingOverloadError", "ModelNotLoadedError",
           "FeedValidationError", "ServingDeadlineError",
           "PoolExhaustedError"]


class ServingError(RuntimeError):
    """Base class of every serving-lane error."""


class ServingOverloadError(ServingError):
    """Admission control rejected the request: the queue is at
    FLAGS_serving_max_queue, a tenant is over its
    FLAGS_serving_tenant_quota, the engine is draining, or it is closed
    or its scheduler died.  ``reason`` classifies it (``overload`` /
    ``closed`` / ``tenant_quota`` / ``draining`` / ``scheduler_failed``)
    and matches the ``pt_serve_rejected_total{reason}`` label the
    rejection books."""

    def __init__(self, message, reason="overload"):
        super().__init__(message)
        self.reason = str(reason)


class ModelNotLoadedError(ServingError, KeyError):
    """Request named a model the engine does not serve."""

    def __str__(self):
        # KeyError.__str__ reprs the message; render it like any error
        return RuntimeError.__str__(self)


class FeedValidationError(ServingError, ValueError):
    """Request feed failed the edge validation (names, dtypes, shapes,
    row consistency) against the model's static program signature."""


class ServingDeadlineError(ServingError, TimeoutError):
    """The request outlived its per-request deadline
    (FLAGS_serving_deadline_ms / Engine(deadline_ms=...)) while queued or
    in flight; its future resolves with this instead of waiting forever.
    Booked as ``pt_serve_rejected_total{reason="deadline"}``."""


class PoolExhaustedError(ServingError, MemoryError):
    """The paged KV pool has no free page for an allocation.  The decode
    scheduler catches this, evicts a victim sequence and retries; it only
    escapes when the pool is sized below one full sequence, which the
    KVPool constructor rejects up front."""
