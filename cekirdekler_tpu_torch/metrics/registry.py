"""Process-global metrics registry: always-on counters, gauges, and
fixed-bucket histograms for the runtime's steady-state health.

A copy of ``cekirdekler_tpu/metrics/registry.py`` kept in the port (which never
imports the JAX package); the text below is the reference's.

The tracer (``trace/spans.py``) answers "where did THIS window's time
go"; it is scoped, ring-buffered, and off by default.  Steady-state
counters — balancer shares, driver-queue occupancy, fused
engage/disengage, transfer bytes, DCN exchange traffic — used to live as
ad-hoc dicts (``Cores.fused_stats``, ``Worker.benchmarks``) with no
uniform export.  This registry gives every such number ONE home with
three exports (``metrics/export.py``): Prometheus text, a JSON snapshot
(embedded in bench artifacts), and Perfetto counter tracks merged into
the Chrome-trace export so metrics ride the same timeline as spans.

Design constraints, same discipline as the tracer:

1. **Disabled is one branch.**  ``REGISTRY.enabled = False`` turns every
   instrument site into an attribute read + falsy check; the marginal
   cost over an unavoidable Python method call is pinned < 100 ns by
   ``tests/test_metrics.py`` (the call itself is interpreter floor —
   ~120 ns on slow containers — which no registry design can remove).
2. **Enabled is a lock per update, and that is deliberate.**  Unlike the
   tracer's overwrite-tolerant ring, metric values are EXACT: N threads
   incrementing K times must snapshot to N·K (``x += n`` alone loses
   updates across bytecode boundaries).  An uncontended CPython lock is
   ~100 ns — fine for per-dispatch/per-transfer granularity; truly hot
   inner loops should aggregate locally and ``inc()`` once per batch.
3. **Snapshots are deterministic.**  ``snapshot()`` sorts series keys,
   so two snapshots of the same state serialize identically — the bench
   artifact diffing in ``tools/regress.py`` depends on it.

Label model: labels are fixed at metric creation
(``REGISTRY.counter("ck_upload_bytes_total", lane=0)``) and become part
of the series identity, Prometheus-style.  ``counter()`` / ``gauge()`` /
``histogram()`` are get-or-create: calling them again with the same
(name, labels) returns the SAME metric object, so instrument sites may
either cache the handle (static labels) or resolve per call (dynamic
labels like compute id — one dict lookup).
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Iterator

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "DEFAULT_BUCKETS",
    "series_name",
]

#: Default histogram upper bounds (seconds-flavored, Prometheus
#: convention): spans µs-scale dispatch costs through multi-second
#: fences.  The last implicit bucket is +Inf.
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def series_name(name: str, labels: tuple[tuple[str, str], ...]) -> str:
    """Prometheus-style series identity: ``name{k="v",...}`` with labels
    sorted — the deterministic snapshot/export key."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


class _Metric:
    """Shared identity/plumbing.  ``_series`` is the bounded
    (timestamp, value) sample ring feeding Perfetto counter tracks —
    populated only while ``REGISTRY.sampling`` is on (the tracing
    context enables both), so steady-state operation stores no
    history."""

    kind = "untyped"

    def __init__(self, reg: "MetricsRegistry", name: str,
                 labels: tuple[tuple[str, str], ...], help: str = ""):
        self._reg = reg
        self.name = name
        self.labels = labels
        self.help = help
        self._lock = threading.Lock()
        self._series: deque | None = None

    @property
    def series(self) -> str:
        return series_name(self.name, self.labels)

    def _sample(self, value: float) -> None:
        # callers invoke this INSIDE their update lock: appending after
        # release would let a preempted thread push a stale smaller
        # value behind a newer one, and the Perfetto counter track
        # would show a "monotonic" counter decreasing
        s = self._series
        if s is not None:
            s.append((time.perf_counter(), value))

    def samples(self) -> list[tuple[float, float]]:
        """Recorded (perf_counter, value) samples (sampling mode only).
        Copied under the metric lock: iterating a deque while an update
        thread appends raises RuntimeError."""
        with self._lock:
            s = self._series
            return list(s) if s is not None else []


class Counter(_Metric):
    """Monotonically increasing value (events, bytes)."""

    kind = "counter"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._value = 0

    def inc(self, amount: int | float = 1) -> None:
        if not self._reg.enabled:
            return
        with self._lock:
            self._value += amount
            if self._reg.sampling:
                self._sample(self._value)

    @property
    def value(self):
        return self._value


class Gauge(_Metric):
    """Point-in-time value (queue depth, share)."""

    kind = "gauge"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._value = 0.0

    def set(self, value: float) -> None:
        if not self._reg.enabled:
            return
        if self._reg.sampling:
            with self._lock:  # keeps the sample series in value order
                self._value = value
                self._sample(value)
        else:
            self._value = value  # single store: last-write-wins

    def inc(self, amount: float = 1) -> None:
        if not self._reg.enabled:
            return
        with self._lock:
            self._value += amount
            if self._reg.sampling:
                self._sample(self._value)

    def dec(self, amount: float = 1) -> None:
        self.inc(-amount)

    @property
    def value(self):
        return self._value


class Histogram(_Metric):
    """Fixed-bucket histogram.  ``buckets`` are ascending upper bounds;
    an implicit +Inf bucket catches the tail.  An observation lands in
    the FIRST bucket whose upper bound is >= the value (Prometheus
    ``le`` semantics: an observation exactly on a boundary belongs to
    that boundary's bucket — pinned by the bucket-boundary property test
    in tests/test_metrics.py)."""

    kind = "histogram"

    def __init__(self, reg, name, labels, help="",
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(reg, name, labels, help)
        b = tuple(float(x) for x in buckets)
        if list(b) != sorted(set(b)):
            raise ValueError(f"histogram buckets must be ascending: {b}")
        self.buckets = b
        self._counts = [0] * (len(b) + 1)  # + the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        if not self._reg.enabled:
            return
        i = bisect_left(self.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if self._reg.sampling:
                self._sample(value)

    @property
    def value(self) -> dict:
        with self._lock:
            return {
                "buckets": list(self.buckets),
                "counts": list(self._counts),
                "sum": self._sum,
                "count": self._count,
            }


class MetricsRegistry:
    """One process-global instance (:data:`REGISTRY`).

    ``enabled`` ships True — the registry is ALWAYS-ON by design (the
    whole point is noticing regressions nobody was watching for); the
    off switch exists for overhead-sensitive measurement windows (the
    marker-overhead bench) and the budget test.  ``sampling`` (off by
    default) additionally records bounded per-metric time series for
    Perfetto counter tracks."""

    def __init__(self, sample_capacity: int = 4096):
        self.enabled = True
        self.sampling = False
        self._sample_cap = int(sample_capacity)
        self._lock = threading.Lock()
        self._metrics: dict[tuple, _Metric] = {}

    # -- get-or-create -------------------------------------------------------
    def _get(self, cls, name: str, help: str, labels: dict, **kw) -> _Metric:
        lab = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        key = (name, lab)
        m = self._metrics.get(key)  # lock-free fast path (GIL-safe read)
        if m is not None:
            if type(m) is not cls:
                raise TypeError(
                    f"metric {series_name(name, lab)} already registered "
                    f"as {m.kind}, requested {cls.kind}"
                )
            return m
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(self, name, lab, help, **kw)
                if self.sampling:
                    m._series = deque(maxlen=self._sample_cap)
                self._metrics[key] = m
        return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        h = self._get(Histogram, name, help, labels, buckets=buckets)
        if h.buckets != tuple(float(x) for x in buckets):
            raise ValueError(
                f"metric {h.series} already registered with buckets "
                f"{h.buckets}, requested {buckets}"
            )
        return h

    # -- control -------------------------------------------------------------
    def enable_sampling(self, capacity: int | None = None) -> None:
        """Start recording per-metric (t, value) series for Perfetto
        counter tracks.  Existing metrics get fresh rings."""
        with self._lock:
            if capacity is not None:
                self._sample_cap = int(capacity)
            for m in self._metrics.values():
                m._series = deque(maxlen=self._sample_cap)
            self.sampling = True

    def disable_sampling(self, clear: bool = False) -> None:
        with self._lock:
            self.sampling = False
            if clear:
                for m in self._metrics.values():
                    m._series = None

    def reset(self) -> None:
        """Zero every registered metric IN PLACE (tests / process
        reuse).  The metric objects survive on purpose: instrument
        sites cache handles (Worker/Cores hold them for the hot paths),
        and dropping the dict would orphan those — they'd keep
        incrementing objects no future snapshot includes, while
        get-or-create sites re-register fresh ones, yielding an
        inconsistent health view with no error anywhere."""
        with self._lock:
            for m in self._metrics.values():
                with m._lock:
                    if isinstance(m, Histogram):
                        m._counts = [0] * (len(m.buckets) + 1)
                        m._sum = 0.0
                        m._count = 0
                    elif isinstance(m, Gauge):
                        m._value = 0.0
                    else:
                        m._value = 0
                    if m._series is not None:
                        m._series.clear()

    # -- inspection ----------------------------------------------------------
    def __iter__(self) -> Iterator[_Metric]:
        # copy under the lock: a scrape thread iterating while a worker
        # registers a first-ever series (new disengage reason, new lane)
        # must not hit "dictionary changed size during iteration"
        with self._lock:
            ms = list(self._metrics.values())
        return iter(sorted(ms, key=lambda m: m.series))

    def __len__(self) -> int:
        return len(self._metrics)

    def snapshot(self) -> dict:
        """Deterministic JSON-able state: series name → value, grouped by
        metric kind, keys sorted.  Two snapshots of identical state
        serialize identically (regress.py diffs depend on it)."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in self:
            if isinstance(m, Counter):
                out["counters"][m.series] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][m.series] = m.value
            elif isinstance(m, Histogram):
                out["histograms"][m.series] = m.value
        return out

    def counter_series(self) -> dict[str, list[tuple[float, float]]]:
        """Sampled time series per series name (sampling mode) — the
        input to the Perfetto counter-track export."""
        out: dict[str, list[tuple[float, float]]] = {}
        for m in self:
            s = m.samples()
            if s:
                out[m.series] = s
        return out


#: The process-global registry every built-in instrument site uses.
REGISTRY = MetricsRegistry()
