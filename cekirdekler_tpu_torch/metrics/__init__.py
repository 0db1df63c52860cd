"""``cekirdekler_tpu_torch.metrics`` — the always-on health registry, a
copy of the reference's ``cekirdekler_tpu/metrics/`` (the same ``ck_*``
names, buckets and exports).

Counters, gauges, and fixed-bucket histograms for every steady-state
number the runtime produces (balancer shares, driver-queue depth,
transfer bytes, fused engage/disengage, DCN exchange traffic), with
three exports: Prometheus text, a deterministic JSON snapshot (embedded
in bench artifacts), and Perfetto counter tracks merged into the
Chrome-trace span export.  See docs/OBSERVABILITY.md "Metrics &
aggregation".

Relationship to ``cekirdekler_tpu_torch.trace``: the tracer answers "where did
this window's time go" (scoped, ring-buffered, off by default); the
registry answers "is the system healthy right now" (process-global,
always on; the port measures its host cost per call on the card).
``trace.tracing(metrics=True)`` turns on registry sampling for the
window so both ride one timeline.

No torch imports — reading a counter costs no backend initialization.
"""

from .export import (
    chrome_counter_events,
    json_snapshot,
    parse_prometheus_text,
    prometheus_from_snapshot,
    prometheus_text,
)
from .registry import (
    DEFAULT_BUCKETS,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    series_name,
)

__all__ = [
    "Counter",
    "DEFAULT_BUCKETS",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "chrome_counter_events",
    "json_snapshot",
    "parse_prometheus_text",
    "prometheus_from_snapshot",
    "prometheus_text",
    "series_name",
]
