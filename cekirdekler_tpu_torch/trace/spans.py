"""Typed span recording: the host-side half of the attribution subsystem.

A copy of ``cekirdekler_tpu/trace/spans.py`` kept in the port (which never
imports the JAX package); the text below is the reference's.

The reference's only observability is host-side stopwatches scattered
through the runtime (SURVEY §5.1; Worker.cs:753-807, Cores.cs:994-1063)
and its planned timeline-overlap query is a ``NotImplementedException``
(ClPipeline.cs:2391-2399).  This module replaces ad-hoc stopwatches with
ONE process-global :class:`Tracer`: every runtime layer (worker phases,
both cores pipeline engines, device pipelines, pools, the DCN tier)
records typed :class:`Span` records into a fixed-capacity ring buffer,
tagged with compute id and lane, so a lost millisecond anywhere in the
stack has a name.

Design constraints, in order:

1. **Disabled is free.**  The tracer ships enabled on no hot path by
   default; instrumentation sites pay two attribute reads and a falsy
   check (<1 µs per would-be span, measured by
   ``tests/test_trace.py::test_disabled_tracer_overhead``).  The
   convention at hot sites is the ``t0()``/``record()`` pair::

       t0 = TRACER.t0()          # 0.0 when disabled — no clock read
       ...work...
       TRACER.record("launch", t0, cid=cid, lane=self.index)

2. **Lock-free-ish.**  Recording is one ``itertools.count`` increment
   (atomic under the GIL) plus one list-slot store — concurrent worker
   threads never contend on a lock to record.  The ring overwrites the
   oldest spans when full; ``total_recorded`` keeps the true count so a
   wrapped buffer is detectable, never silent.

3. **Monotonic clocks.**  All timestamps are ``time.perf_counter()``
   seconds, comparable across threads within the process (the exchange
   rate to device-side Xprof events is handled by
   ``trace/attribution.py``, which reconciles totals, not timestamps).

Span kinds used by the built-in instrumentation (callers may add more):
``enqueue`` (a compute() dispatch), ``split`` (first range table),
``rebalance`` (the balancer moved shares), ``launch`` (kernel dispatch),
``fence`` (retirement wait), ``upload`` (H2D), ``download`` (D2H),
``upload-chunk`` / ``download-chunk`` (one ladder-aligned chunk of a
STREAMED partition transfer — the chunked double-buffered H2D/D2H path,
``Cores._run_streamed``; the monolithic kinds above stay for whole-range
transfers so the two paths are distinguishable in every report),
``pipeline-stage`` (one pipeline engine/stage body), ``pool-task``
(device-pool task), ``dcn-exchange`` (cross-host collective), ``fused``
(fused-iteration window flush — spans tag ``xK`` for a K-iteration
ladder dispatch; zero-duration instants tag ``disengage:<reason>`` when
the fused path falls back to per-iteration dispatch, so a silent perf
regression to the slow path is attributable), ``driver-error`` (a
dispatch-driver closure failed — the instant is recorded at failure
time, before the error surfaces at the caller's sync point, so a
postmortem's span ring names the failing dispatch).
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager
from typing import Iterable, NamedTuple

__all__ = ["Span", "Tracer", "TRACER", "SPAN_KINDS", "tracing"]

SPAN_KINDS = (
    "enqueue", "split", "rebalance", "launch", "fence",
    "upload", "download", "upload-chunk", "download-chunk",
    "pipeline-stage", "pool-task", "dcn-exchange",
    "fused", "driver-error",
)


class Span(NamedTuple):
    """One timed event.  ``t0``/``t1`` are perf_counter seconds; ``cid``
    is the compute id (None where no compute id applies), ``lane`` the
    worker/consumer index, ``tag`` a short free-form annotation."""

    kind: str
    t0: float
    t1: float
    cid: int | None = None
    lane: int | None = None
    tag: str | None = None

    @property
    def dur_ms(self) -> float:
        return (self.t1 - self.t0) * 1000.0


class Tracer:
    """Process-global span recorder (one instance: :data:`TRACER`).

    ``enabled`` is a plain attribute on purpose: the disabled fast path
    must be an attribute read, not a property call."""

    def __init__(self, capacity: int = 65536):
        self.enabled = False
        self._cap = max(16, int(capacity))
        self._buf: list[Span | None] = [None] * self._cap
        self._count = itertools.count()
        self._total = 0
        self._lock = threading.Lock()  # enable/clear only — never record()
        # ring-wrap losses already exported to the metrics registry
        # (ck_trace_dropped_spans_total) — the delta tracking that keeps
        # the counter monotonic across snapshots within one ring epoch
        self._dropped_reported = 0

    # -- recording (hot path) ------------------------------------------------
    def t0(self) -> float:
        """Span-open timestamp, or 0.0 when disabled (no clock read)."""
        return time.perf_counter() if self.enabled else 0.0

    def record(
        self,
        kind: str,
        t0: float,
        cid: int | None = None,
        lane: int | None = None,
        tag: str | None = None,
        t1: float | None = None,
    ) -> None:
        """Close and store a span opened at ``t0``.  No-op when disabled
        or when ``t0`` is the disabled sentinel (0.0) — a site that
        opened its span while the tracer was off records nothing even if
        the tracer was enabled mid-span."""
        if not self.enabled or not t0:
            return
        i = next(self._count)  # GIL-atomic slot claim — no lock
        buf = self._buf
        # index by the captured buffer's OWN length, not self._cap: a
        # concurrent enable(capacity=...) swaps buffer and cap in two
        # steps, and mixing one thread's buffer with the other's modulus
        # would IndexError inside instrumented real work
        buf[i % len(buf)] = Span(
            kind, t0, t1 if t1 is not None else time.perf_counter(),
            cid, lane, tag,
        )
        self._total = i + 1  # approximate under races; reporting only

    def instant(
        self,
        kind: str,
        cid: int | None = None,
        lane: int | None = None,
        tag: str | None = None,
    ) -> None:
        """Zero-duration marker (e.g. a rebalance decision)."""
        if not self.enabled:
            return
        t = time.perf_counter()
        self.record(kind, t, cid=cid, lane=lane, tag=tag, t1=t)

    @contextmanager
    def span(
        self,
        kind: str,
        cid: int | None = None,
        lane: int | None = None,
        tag: str | None = None,
    ):
        """Context-manager convenience for non-hot sites; records even
        when the body raises (the failing span is usually the one you
        want to see)."""
        t0 = self.t0()
        try:
            yield
        finally:
            self.record(kind, t0, cid=cid, lane=lane, tag=tag)

    # -- control -------------------------------------------------------------
    def enable(self, capacity: int | None = None, clear: bool = True) -> None:
        pending_drops = 0
        with self._lock:
            # export wrap losses BEFORE any reset below zeroes the
            # baseline: "raise Tracer capacity" (the report's own
            # advice) must not silently eat the losses that motivated it
            pending_drops = self._drop_delta_locked()
            if capacity is not None and capacity != self._cap:
                # resizing rebuilds the ring; with clear=False the newest
                # existing spans migrate so keep=True keeps its promise,
                # and the counters restart so total_recorded/ring-wrap
                # reporting describes the NEW buffer, not the old one
                keep = [] if clear else self._snapshot_locked_free()
                self._cap = max(16, int(capacity))
                self._clear_locked()
                for s in keep[-self._cap:]:
                    i = next(self._count)
                    self._buf[i % self._cap] = s
                    self._total = i + 1
            elif clear:
                self._clear_locked()
            self.enabled = True
        self._inc_dropped(pending_drops)

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            pending_drops = self._drop_delta_locked()
            self._clear_locked()
        self._inc_dropped(pending_drops)

    def _clear_locked(self) -> None:
        self._buf = [None] * self._cap
        self._count = itertools.count()
        self._total = 0
        self._dropped_reported = 0

    # -- inspection ----------------------------------------------------------
    @property
    def total_recorded(self) -> int:
        """Spans recorded since the last clear — exceeds ``capacity``
        when the ring wrapped (older spans were overwritten)."""
        return self._total

    @property
    def dropped_spans(self) -> int:
        """Spans LOST to ring wrap since the last clear (oldest-first
        overwrites) — the count every coverage report must carry:
        attribution totals silently undercount by exactly these spans."""
        return max(0, self._total - self._cap)

    def _sync_dropped_metric(self) -> None:
        """Export ring-wrap losses to ``ck_trace_dropped_spans_total``.
        Called from snapshot() (a cold path) rather than record(): the
        recording path's lock-free contract must not pay a registry
        lock per span once the ring wraps.  Delta-based so the counter
        stays monotonic across repeated snapshots; a clear() resets the
        baseline with the ring.  The delta read-modify-write runs under
        the tracer lock — two concurrent snapshots (the debug server's
        /tracez thread + an in-process report) would otherwise both see
        the same baseline and double-count the loss."""
        with self._lock:
            delta = self._drop_delta_locked()
        self._inc_dropped(delta)

    def _drop_delta_locked(self) -> int:
        """Unreported ring-wrap loss; advances the baseline.  Caller
        holds the tracer lock."""
        d = self.dropped_spans
        delta = d - self._dropped_reported
        if delta <= 0:
            return 0
        self._dropped_reported = d
        return delta

    @staticmethod
    def _inc_dropped(delta: int) -> None:
        if delta <= 0:
            return
        from ..metrics.registry import REGISTRY

        REGISTRY.counter(
            "ck_trace_dropped_spans_total",
            "spans lost to tracer ring wrap (attribution undercounts)",
        ).inc(delta)

    @property
    def capacity(self) -> int:
        return self._cap

    def _snapshot_locked_free(self) -> list[Span]:
        """The span copy alone — no metric sync, no lock.  enable()'s
        keep-path calls this while HOLDING the tracer lock (snapshot()
        there would deadlock on the non-reentrant lock via
        _sync_dropped_metric)."""
        buf = list(self._buf)  # one slice: consistent-enough view
        spans = [s for s in buf if s is not None]
        spans.sort(key=lambda s: s.t0)
        return spans

    def snapshot(self) -> list[Span]:
        """Recorded spans, oldest first.  Concurrent recording during
        the snapshot may drop/duplicate a span at the wrap edge — the
        snapshot is for reporting, not for synchronization."""
        self._sync_dropped_metric()
        return self._snapshot_locked_free()

    def spans_between(self, t_lo: float, t_hi: float) -> list[Span]:
        """Spans that overlap the window [t_lo, t_hi]."""
        return [s for s in self.snapshot() if s.t1 >= t_lo and s.t0 <= t_hi]


#: The process-global tracer every built-in instrumentation site uses.
TRACER = Tracer()


@contextmanager
def tracing(capacity: int | None = None, keep: bool = False,
            metrics: bool = False):
    """Scoped enable of the global tracer::

        with trace.tracing() as tr:
            ...instrumented work...
        report = attribution.window_report(tr.snapshot(), t0, t1)

    Disables on exit; spans survive (``keep`` preserves pre-existing
    spans instead of clearing on entry).  ``metrics=True`` additionally
    turns on registry sampling for the window
    (``metrics.REGISTRY.enable_sampling``), so the counter time series
    for Perfetto counter tracks cover exactly the traced window::

        with trace.tracing(metrics=True) as tr:
            ...work...
        trace.save_chrome_trace(
            tr.snapshot(), path,
            counters=metrics.REGISTRY.counter_series())
    """
    TRACER.enable(capacity=capacity, clear=not keep)
    if metrics:
        from ..metrics.registry import REGISTRY as _REG

        _REG.enable_sampling()
    try:
        yield TRACER
    finally:
        TRACER.disable()
        if metrics:
            from ..metrics.registry import REGISTRY as _REG

            _REG.disable_sampling()


def spans_by_kind(spans: Iterable[Span]) -> dict[str, list[Span]]:
    out: dict[str, list[Span]] = {}
    for s in spans:
        out.setdefault(s.kind, []).append(s)
    return out
