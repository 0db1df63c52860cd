"""``cekirdekler_tpu_torch.trace`` — span-based and device-timeline
attribution.

- :mod:`.spans` — the process-global :data:`TRACER`, a copy of the
  reference's: a ring of typed spans (enqueue, split, rebalance, launch,
  fence, upload, download, pipeline-stage, fused, ...) recorded by the
  scheduler and its lanes; a no-op when disabled.  A GPU lane's spans
  are host-time spans of issue and fence, as the reference's are.
- :mod:`.attribution` — per-window "where did the time go" reports
  (:func:`window_report`), the per-compute-id fence split
  (:func:`split_fence_benches`) and :func:`union_ms`.
- :mod:`.export` — Chrome-trace (Perfetto) JSON export and import and the
  plain-text table.
- :mod:`.ceiling` — the overlap ceiling from same-rep duplex probes.
- :mod:`.device` — device-timeline attribution on ``torch.profiler``:
  launch marks (``MARKS``), per-kernel device profiles from the CUDA
  kernel records reconciled against the host window, roofline rows, the
  unified host + device Perfetto export and the kernel-profile store
  (``CK_PROFILE_STORE``).

The reference's cluster aggregation (``trace/aggregate.py``) is ROADMAP
Queue A 5's third part.  Nothing here imports torch at module level.
"""

from .attribution import AttributionReport, split_fence_benches, union_ms, window_report
from .ceiling import RepSample, ceiling_report, rep_ceiling
from .device import (
    DEVICE_SPAN_KINDS,
    MARKS,
    STORE,
    DeviceCapture,
    DeviceWindowReport,
    ProfileStore,
    capture_device,
    profilez_payload,
    roofline_row,
    split_unified_trace,
    unified_chrome_trace,
)
from .export import from_chrome_trace, save_chrome_trace, text_table, to_chrome_trace
from .spans import SPAN_KINDS, TRACER, Span, Tracer, tracing

__all__ = [
    "AttributionReport",
    "DEVICE_SPAN_KINDS",
    "DeviceCapture",
    "DeviceWindowReport",
    "MARKS",
    "ProfileStore",
    "RepSample",
    "SPAN_KINDS",
    "STORE",
    "Span",
    "TRACER",
    "Tracer",
    "capture_device",
    "ceiling_report",
    "from_chrome_trace",
    "profilez_payload",
    "rep_ceiling",
    "roofline_row",
    "save_chrome_trace",
    "split_fence_benches",
    "split_unified_trace",
    "text_table",
    "to_chrome_trace",
    "tracing",
    "union_ms",
    "window_report",
]
