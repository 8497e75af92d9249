"""paddle_tpu_torch.observability — the port's counterpart of
``paddle_tpu/observability``.  Ported so far: ``metrics`` (the registry
the executor's, the serving engine's and the data-parallel lane's
families book on), ``events`` (the JSONL event log), ``tracing`` (the
process identity events carry) and the executor's part of
``profiling`` (step phases, per-signature stats, MFU and roofline
against the card's peaks).  Exposition, request traces, the flight
recorder, /profilez and SLOs are still to be ported."""

from . import events, metrics, profiling, tracing  # noqa: F401
from .metrics import (DEFAULT_BUCKETS, REGISTRY, Counter,  # noqa: F401
                      Gauge, Histogram, MetricsRegistry, counter, gauge,
                      hist_quantile, histogram, reset, snapshot)
