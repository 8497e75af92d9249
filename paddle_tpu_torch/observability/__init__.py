"""paddle_tpu_torch.observability — the port's counterpart of
``paddle_tpu/observability``.  Ported: ``metrics`` (the registry every
lane books on), ``exposition`` (the text format, the parser and the
HTTP endpoint with /metricsz and the registered pages), ``events`` (the
JSONL event log), ``tracing`` (process identity and span ids),
``reqtrace`` (request traces, /tracez), ``slo`` (burn-rate alerts,
/sloz) and ``profiling`` (step phases, per-signature stats, MFU and
roofline against the card's peaks, the flight recorder and /profilez;
not its HLO inventory, which reads XLA's HLO text)."""

from . import events, exposition, metrics, profiling  # noqa: F401
from . import reqtrace, slo, tracing  # noqa: F401
from .exposition import (MetricsServer, ensure_from_flags,  # noqa: F401
                         parse_text, register_page, render_json,
                         render_text, unregister_page)
from .metrics import (DEFAULT_BUCKETS, REGISTRY, Counter,  # noqa: F401
                      Gauge, Histogram, MetricsRegistry, counter, gauge,
                      hist_quantile, histogram, reset, snapshot)
from .tracing import job_trace_id, new_span_id, process_identity  # noqa: F401
