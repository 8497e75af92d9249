"""paddle_tpu_torch.observability — the metrics registry (counterpart of
``paddle_tpu/observability``).  Ported so far: ``metrics``, which the
serving engine's ``pt_serve_*`` families and the int8 saving counter
book on.  Exposition, events, tracing, request traces, profiling
phases and SLOs are still to be ported."""

from . import metrics  # noqa: F401
from .metrics import (DEFAULT_BUCKETS, REGISTRY, Counter,  # noqa: F401
                      Gauge, Histogram, MetricsRegistry, counter, gauge,
                      hist_quantile, histogram, reset, snapshot)
