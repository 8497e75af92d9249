"""Typed serving-path errors (a copy of ``paddle_tpu/serving/errors.py``,
kept in the port so the port imports nothing of the JAX package).

Admission rejection is a load-shedding signal the client retries with
backoff; pool exhaustion is internal to the decode scheduler, which
evicts and retries.
"""

from __future__ import annotations

__all__ = ["ServingError", "ServingOverloadError", "PoolExhaustedError"]


class ServingError(RuntimeError):
    """Base class of every serving-lane error."""


class ServingOverloadError(ServingError):
    """Admission control rejected the request: the queue is at
    FLAGS_serving_max_queue, a tenant is over its
    FLAGS_serving_tenant_quota, or the engine is closed or its scheduler
    died.  ``reason`` classifies it (``overload`` / ``closed`` /
    ``tenant_quota`` / ``scheduler_failed``)."""

    def __init__(self, message, reason="overload"):
        super().__init__(message)
        self.reason = str(reason)


class PoolExhaustedError(ServingError, MemoryError):
    """The paged KV pool has no free page for an allocation.  The decode
    scheduler catches this, evicts a victim sequence and retries; it only
    escapes when the pool is sized below one full sequence, which the
    KVPool constructor rejects up front."""
