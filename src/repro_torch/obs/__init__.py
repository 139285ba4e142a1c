# Observability (DESIGN.md §11): per-query tracing with Chrome-trace /
# Perfetto export, and a metrics registry with fixed-bucket latency
# histograms.  No dependencies; a None tracer keeps every hook site to
# one attribute check.
from .metrics import (LATENCY_BUCKETS_MS, SCHEMA_VERSION,  # noqa: F401
                      Counter, Gauge, Histogram, MetricsRegistry,
                      exp_buckets)
from .trace import Tracer, span_if, validate_chrome_trace  # noqa: F401
