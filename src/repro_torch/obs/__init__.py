# Metrics registry: counters, gauges and fixed-bucket latency histograms.
from .metrics import (LATENCY_BUCKETS_MS, REGISTRY,  # noqa: F401
                      SCHEMA_VERSION, Counter, Gauge, Histogram,
                      MetricsRegistry, exp_buckets)
