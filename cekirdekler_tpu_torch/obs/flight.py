"""Always-on flight recorder: the runtime's black box.

A copy of ``cekirdekler_tpu/obs/flight.py`` kept in the port (which never
imports the JAX package); the text below is the reference's, except that the
postmortem's versions block names torch, its CUDA and the card.

The tracer (``trace/spans.py``) is scoped and off by default; the
metrics registry (``metrics/registry.py``) is always on but keeps only
CURRENT values.  Neither can answer "what was the runtime *deciding*
in the seconds before this crash?" — the balancer's last jumps, the
fused window's engage/disengage sequence, the stream tuner's chunk
flips, the driver-queue failure that preceded the fence error.  This
module records exactly those **decision events** into a bounded ring
that is ALWAYS on (same discipline as the registry: the whole point is
evidence nobody planned to collect), plus throttled periodic metric
samples, and knows how to dump itself as a self-contained postmortem
JSON when a crash surfaces.

Design constraints, same order as the tracer's:

1. **Recording is cheap and lock-free-ish.**  ``event()`` is one
   ``deque.append`` (GIL-atomic on a ``maxlen`` deque — the ring
   evicts oldest-first with no lock) plus one clock read; disabled is
   one attribute read + falsy check, pinned by
   ``tests/test_obs.py::test_disabled_flight_event_overhead`` to the
   reference's budget (< 100 ns marginal over the call floor).  No decision
   event rides the fused DEFERRAL path (the enqueue hot path) — all
   instrument sites are window-granularity or colder.
2. **Wall-clock timestamps.**  Events carry ``time.time()`` epoch
   seconds, not ``perf_counter``: postmortems are read OFF-process,
   where a monotonic epoch is meaningless.  The dump also records the
   perf_counter↔epoch exchange rate so the span ring (perf_counter
   seconds) can be placed on the same axis.
3. **Dumps are opt-in by environment.**  ``dump_postmortem`` writes
   only when given a path or when :data:`POSTMORTEM_DIR_ENV`
   (``CK_POSTMORTEM_DIR``) is set — a test rig that injects failures
   on purpose must not litter the filesystem.  When armed, EVERY crash
   surfacing through the wired paths (``Cores.compute``/``barrier``
   error collection, the worker driver-queue drain, ``ClPipeline.push``)
   leaves a black box on disk; the dump itself can never mask the
   original exception (``record_crash`` swallows its own failures).

Event kinds recorded by the built-in instrumentation (callers may add
more): ``rebalance`` (range table moved), ``balance-freeze`` /
``balance-jump`` (balancer decisions, core/balance.py),
``fused-engage`` / ``fused-disengage`` / ``fused-window`` (the fused
dispatch path's lifecycle, with reasons), ``stream-choice`` (the
transfer autotuner's chunk count changed for a lane),
``stream-retune`` (observations dropped after a re-partition),
``barrier`` (sync point, with per-lane fence ms), ``driver-error``
(a dispatch-driver closure failed), ``metrics-sample`` (periodic
registry snapshot), ``crash`` (an exception surfaced at a wired
boundary), ``profiler-start`` / ``profiler-stop`` (a device-timeline
capture opened/closed — ``trace/device.DeviceCapture``; a postmortem
shows whether the crash happened under capture).
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback as _tb
from collections import deque
from typing import Any, NamedTuple

__all__ = [
    "FlightEvent",
    "FlightRecorder",
    "FLIGHT",
    "EVENT_KINDS",
    "POSTMORTEM_DIR_ENV",
    "dump_postmortem",
    "load_postmortem",
    "postmortem_spans",
    "record_crash",
]

POSTMORTEM_DIR_ENV = "CK_POSTMORTEM_DIR"

#: The declared event-kind vocabulary: every kind the built-in
#: instrumentation emits.  ``tools/ckcheck`` (pass 4) fails CI on an
#: emitted kind missing here, and ``tools/lint_obs.py`` cross-checks
#: this tuple against the flight-recorder kind table in
#: docs/OBSERVABILITY.md — so a new decision event is always declared
#: AND documented.  Callers outside the package may still record ad-hoc
#: kinds (the ring does not validate); this tuple is the contract for
#: in-tree emitters only.
EVENT_KINDS = (
    "rebalance", "balance-freeze", "balance-jump",
    "fused-engage", "fused-disengage", "fused-window",
    "stream-choice", "stream-retune", "block-retune",
    "barrier", "driver-error", "metrics-sample", "crash",
    "kernel-verify",
    "debug-server", "debug-port-skipped",
    "profiler-start", "profiler-stop",
    "fault-injected",
    "serve-contain", "breaker-flip", "brownout", "serve-crash",
    "drain-apply", "readmit", "drain-probe",
    "member-leave", "member-join",
    "checkpoint-restore", "checkpoint-fallback", "checkpoint-sweep",
    "fabric-divert", "fabric-reroute", "fabric-warm",
    "cache-warmup",
)

#: Postmortem JSON schema tag.  v2 (this revision) embeds the decision
#: ring (``obs/decisions.py``) next to the event/span rings so a crash
#: black box answers "what was the balancer DECIDING, from which
#: inputs" without a live rig; v1 files (no ``decisions`` key) still
#: load — ``load_postmortem`` backfills an empty list, and every other
#: key is unchanged (additive bump, round-trip pinned by test).
SCHEMA = "ck-postmortem-v2"


class FlightEvent(NamedTuple):
    """One recorded decision.  ``t`` is ``time.time()`` epoch seconds."""

    t: float
    kind: str
    fields: dict

    def to_row(self) -> dict:
        return {"t": self.t, "kind": self.kind, **self.fields}


class FlightRecorder:
    """Bounded always-on ring of decision events (one process-global
    instance: :data:`FLIGHT`).

    ``enabled`` is a plain attribute (the tracer convention: the
    disabled fast path must be an attribute read, not a property call).
    The ring is a ``maxlen`` deque — append evicts oldest-first
    atomically under the GIL, so concurrent recorders never contend on
    a lock and a reader's ``list(ring)`` sees a consistent-enough view
    (reporting, not synchronization — the tracer's snapshot contract).
    """

    def __init__(self, capacity: int = 4096,
                 sample_interval_s: float = 5.0):
        self.enabled = True
        self._cap = max(16, int(capacity))
        self._ring: deque[FlightEvent] = deque(maxlen=self._cap)
        self._total = 0
        self.sample_interval_s = float(sample_interval_s)
        self._last_sample_t = 0.0

    # -- recording (cold/warm paths only — never the fused deferral) ---------
    def event(self, kind: str, **fields: Any) -> None:
        if not self.enabled:
            return
        self._ring.append(FlightEvent(time.time(), kind, fields))
        self._total += 1  # GIL-racy undercount possible; reporting only

    def maybe_sample_metrics(self, now: float | None = None) -> bool:
        """Record a throttled ``metrics-sample`` event carrying the
        registry's counter/gauge values (histograms ride as count/sum —
        the buckets would dwarf the ring).  Call from sync points; at
        most one sample per :attr:`sample_interval_s`."""
        if not self.enabled:
            return False
        t = time.time() if now is None else now
        if t - self._last_sample_t < self.sample_interval_s:
            return False
        self._last_sample_t = t
        from ..metrics.registry import REGISTRY

        snap = REGISTRY.snapshot()
        compact = dict(snap["counters"])
        compact.update(snap["gauges"])
        for series, v in snap["histograms"].items():
            compact[series + "_count"] = v["count"]
            compact[series + "_sum"] = v["sum"]
        self.event("metrics-sample", values=compact)
        return True

    # -- inspection ----------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def total_recorded(self) -> int:
        """Events recorded since the last clear — exceeds ``capacity``
        when the ring wrapped (oldest events were evicted)."""
        return self._total

    def snapshot(self) -> list[FlightEvent]:
        """Recorded events, oldest first."""
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()
        self._total = 0
        self._last_sample_t = 0.0


#: The process-global recorder every built-in instrument site uses.
FLIGHT = FlightRecorder()


# -- postmortem dumps --------------------------------------------------------

def _versions() -> dict:
    """The versions block: Python, torch, its CUDA and the card's name
    (the reference reports jax here)."""
    out = {"python": sys.version.split()[0], "platform": sys.platform}
    try:  # torch may be broken at crash time — versions best-effort
        import torch

        out["torch"] = getattr(torch, "__version__", "?")
        out["cuda"] = torch.version.cuda
        out["device"] = (torch.cuda.get_device_name(0)
                         if torch.cuda.is_available() else None)
    except Exception:  # noqa: BLE001 - dump must survive anything
        out.setdefault("torch", None)
        out.setdefault("cuda", None)
        out.setdefault("device", None)
    try:
        from .. import __version__ as _v

        out["cekirdekler_tpu_torch"] = _v
    except Exception:  # noqa: BLE001
        out["cekirdekler_tpu_torch"] = None
    return out


def _exc_block(exc: BaseException | None) -> dict | None:
    if exc is None:
        return None
    return {
        "type": type(exc).__name__,
        "message": str(exc)[:2000],
        "traceback": "".join(
            _tb.format_exception(type(exc), exc, exc.__traceback__)
        )[-8000:],
    }


def dump_postmortem(
    path: str | None = None,
    exc: BaseException | None = None,
    lanes: dict | None = None,
    extra: dict | None = None,
    flight: FlightRecorder | None = None,
) -> str | None:
    """Write the black box: flight events, the tracer's span ring, a
    metrics snapshot, lane configuration, and versions, as one
    self-contained JSON.

    ``path`` may be a file or a directory; ``None`` falls back to the
    :data:`POSTMORTEM_DIR_ENV` directory and returns None (no dump)
    when that is unset — the arming contract.  Returns the written
    path.  The write is tmp+rename so a crash-during-dump never leaves
    a half-parseable black box."""
    if path is None:
        path = os.environ.get(POSTMORTEM_DIR_ENV)
        if not path:
            return None
        # the env var names a DIRECTORY by contract — create it so an
        # operator who armed it without mkdir still gets per-crash
        # files instead of successive crashes overwriting one path (or
        # a missing parent silently dumping nothing)
        os.makedirs(path, exist_ok=True)
    fr = flight if flight is not None else FLIGHT
    from ..metrics.registry import REGISTRY
    from ..trace.spans import TRACER
    from .decisions import DECISIONS

    spans = TRACER.snapshot()
    decisions = DECISIONS.snapshot()
    doc = {
        "schema": SCHEMA,
        "wrote_at": time.time(),
        "wrote_at_iso": time.strftime(
            "%Y-%m-%dT%H:%M:%S%z", time.localtime()
        ),
        # perf_counter↔epoch exchange rate at dump time: span t0/t1 are
        # perf_counter seconds; epoch ≈ t + (wrote_at − perf_at_dump)
        "perf_counter_at_dump": time.perf_counter(),
        "exc": _exc_block(exc),
        "events": [e.to_row() for e in fr.snapshot()],
        "events_total_recorded": fr.total_recorded,
        "events_capacity": fr.capacity,
        "spans": [
            {"kind": s.kind, "t0": s.t0, "t1": s.t1, "cid": s.cid,
             "lane": s.lane, "tag": s.tag}
            for s in spans
        ],
        "tracer": {
            "enabled": TRACER.enabled,
            "total_recorded": TRACER.total_recorded,
            "capacity": TRACER.capacity,
            "dropped_spans": TRACER.dropped_spans,
        },
        # v2: the decision ring — the event-sourced "what was every
        # controller deciding, from which inputs" record, replayable
        # offline via `python -m tools.ckreplay verify <dump>`
        "decisions": [r.to_row() for r in decisions],
        "decisions_total_recorded": DECISIONS.total_recorded,
        "decisions_capacity": DECISIONS.capacity,
        "metrics": REGISTRY.snapshot(),
        "lanes": lanes,
        "versions": _versions(),
    }
    if extra:
        doc.update(extra)
    if os.path.isdir(path):
        name = f"ck_postmortem_{os.getpid()}_{int(time.time() * 1000)}.json"
        path = os.path.join(path, name)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        # json_safe: callers may put arbitrary values in their own
        # flight events ("callers may add more") — one np.int64 or a
        # float('inf') must not suppress (or render unparseable) the
        # whole black box at exactly the moment it matters.  default=str
        # stays as the last-resort belt under allow_nan=False's braces.
        from ..utils.jsonsafe import json_safe

        json.dump(json_safe(doc), f, default=str, allow_nan=False)
    os.replace(tmp, path)
    return path


def load_postmortem(path: str) -> dict:
    """Read a dump back; ``"spans"`` come back as
    :class:`~cekirdekler_tpu.trace.spans.Span` records so the dump
    round-trips through the Chrome-trace exporter::

        pm = load_postmortem(p)
        trace.save_chrome_trace(pm["spans"], "crash.json")
    """
    from ..trace.spans import Span

    with open(path) as f:
        doc = json.load(f)
    doc["spans"] = [
        Span(r["kind"], r["t0"], r["t1"], r.get("cid"), r.get("lane"),
             r.get("tag"))
        for r in doc.get("spans", ())
    ]
    # v1 back-compat: files written before the decision ring existed
    # load with an explicitly-empty decision list (absence is visible
    # as [], never a KeyError in a consumer)
    doc["decisions"] = list(doc.get("decisions") or [])
    return doc


def postmortem_spans(path: str):
    """Just the span list of a dump (Perfetto-export convenience)."""
    return load_postmortem(path)["spans"]


def record_crash(
    where: str,
    exc: BaseException,
    lanes: dict | None = None,
    flight: FlightRecorder | None = None,
) -> str | None:
    """The one crash hook every wired boundary calls: a ``crash``
    flight event + a best-effort postmortem dump.  NEVER raises — the
    original exception always outranks the black box.  One exception,
    ONE dump: a failure propagating through nested wired boundaries
    (a multi-chip pipeline stage's ``Cores.compute`` re-raising into
    ``ClPipeline.push``) records a ``crash`` event per boundary — the
    propagation path is evidence — but the black box is written only
    at the innermost one (the exception object carries the marker)."""
    fr = flight if flight is not None else FLIGHT
    try:
        fr.event("crash", where=where, exc_type=type(exc).__name__,
                 exc=str(exc)[:500])
    except Exception:  # noqa: BLE001 - the hook must be harmless
        pass
    try:
        if getattr(exc, "_ck_postmortem_path", None) is not None:
            return None  # already dumped at an inner boundary
        path = dump_postmortem(exc=exc, lanes=lanes, flight=fr)
        if path is not None:
            try:
                exc._ck_postmortem_path = path
            except Exception:  # noqa: BLE001 - slots-only exceptions
                pass
        return path
    except Exception:  # noqa: BLE001
        return None
