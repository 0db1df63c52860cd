"""``cekirdekler_tpu_torch.trace`` — span-based attribution.

- :mod:`.spans` — the process-global :data:`TRACER`, a copy of the
  reference's: a ring of typed spans (enqueue, split, rebalance, launch,
  fence, upload, download, pipeline-stage, fused, ...) recorded by the
  scheduler and its lanes; a no-op when disabled.  A GPU lane's spans
  are host-time spans of issue and fence, as the reference's are.
- :mod:`.attribution` — the per-compute-id fence split
  (:func:`split_fence_benches`) and :func:`union_ms`.
- :mod:`.ceiling` — the overlap ceiling from same-rep duplex probes.

The reference's window reports, exports, cluster aggregation and device
timelines are ROADMAP Queue A 5's second half.
"""

from .attribution import split_fence_benches, union_ms
from .ceiling import RepSample, ceiling_report, rep_ceiling
from .spans import SPAN_KINDS, TRACER, Span, Tracer, tracing

__all__ = [
    "RepSample",
    "SPAN_KINDS",
    "Span",
    "TRACER",
    "Tracer",
    "ceiling_report",
    "rep_ceiling",
    "split_fence_benches",
    "tracing",
    "union_ms",
]
