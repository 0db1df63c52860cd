"""Export recorded spans: Chrome-trace JSON (``chrome://tracing`` /
Perfetto) and the plain-text "where did the time go" table.

A copy of ``cekirdekler_tpu/trace/export.py`` kept in the port (which
never imports the JAX package).  The Chrome trace event format is the
JSON array-of-events schema both viewers load directly: complete events
(``ph: "X"``) with microsecond ``ts``/``dur``, plus ``M`` metadata events
naming the process and one thread per lane.  ``from_chrome_trace`` reads
the same schema back into :class:`~.spans.Span` records — the round trip
is pinned by ``tests/test_torch_device_trace.py`` so the exporter cannot
silently drift off the schema the viewers parse.
"""

from __future__ import annotations

import json
from typing import Iterable, Sequence

from .attribution import window_report
from .spans import Span

__all__ = [
    "to_chrome_trace", "from_chrome_trace", "save_chrome_trace",
    "text_table",
]

_PID = 1  # single-process trace; lanes map to tids


def _tid(lane: int | None) -> int:
    # tid 0 = spans with no lane (host-global events); lanes are 1-based
    return 0 if lane is None else int(lane) + 1


def to_chrome_trace(
    spans: Sequence[Span],
    process_name: str = "cekirdekler_tpu_torch",
    counters: dict | None = None,
    pid: int = _PID,
    t_base: float | None = None,
) -> dict:
    """Spans → Chrome trace dict (``{"traceEvents": [...]}``).

    ``ts`` is microseconds relative to the earliest span so the viewer
    opens at t=0 instead of hours into a perf_counter epoch.

    ``counters`` (``metrics.REGISTRY.counter_series()`` output: series
    name → [(perf_counter, value), ...]) adds Perfetto **counter
    tracks** to the same timeline — balancer shares, driver-queue
    occupancy, transfer byte counters ride next to the spans that
    explain them.  ``pid``/``t_base`` exist for the cluster aggregator
    (``trace/aggregate.py``), which emits one process block per DCN
    process against one shared clock origin."""
    spans = list(spans)
    if t_base is None:
        # counter samples participate in the origin: with zero spans a
        # 0.0 base would place ph:C events at absolute perf_counter
        # microseconds (hours past t=0 in the viewer)
        candidates = [s.t0 for s in spans]
        for series in (counters or {}).values():
            if series:
                candidates.append(series[0][0])
        t_base = min(candidates, default=0.0)
    events: list[dict] = [
        {
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": process_name},
        },
        {
            "ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
            "args": {"name": "host"},
        },
    ]
    lanes = sorted({s.lane for s in spans if s.lane is not None})
    for lane in lanes:
        events.append({
            "ph": "M", "name": "thread_name", "pid": pid, "tid": _tid(lane),
            "args": {"name": f"lane {lane}"},
        })
    for s in spans:
        args: dict = {}
        if s.cid is not None:
            args["cid"] = s.cid
        if s.tag is not None:
            args["tag"] = s.tag
        events.append({
            "ph": "X",
            "name": s.kind,
            "cat": "ck",
            "pid": pid,
            "tid": _tid(s.lane),
            "ts": (s.t0 - t_base) * 1e6,
            "dur": (s.t1 - s.t0) * 1e6,
            "args": args,
        })
    if counters:
        from ..metrics.export import chrome_counter_events

        events.extend(chrome_counter_events(counters, t_base, pid=pid))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def from_chrome_trace(trace: dict) -> list[Span]:
    """Chrome trace dict → spans (the exporter's inverse; timestamps are
    relative seconds, not the original perf_counter epoch)."""
    out: list[Span] = []
    for e in trace.get("traceEvents", ()):
        if e.get("ph") != "X":
            continue
        t0 = float(e.get("ts", 0.0)) / 1e6
        dur = float(e.get("dur", 0.0)) / 1e6
        args = e.get("args", {}) or {}
        tid = int(e.get("tid", 0))
        out.append(Span(
            kind=str(e.get("name", "?")),
            t0=t0,
            t1=t0 + dur,
            cid=args.get("cid"),
            lane=None if tid == 0 else tid - 1,
            tag=args.get("tag"),
        ))
    out.sort(key=lambda s: s.t0)
    return out


def save_chrome_trace(
    spans: Sequence[Span], path: str, process_name: str = "cekirdekler_tpu_torch",
    counters: dict | None = None,
) -> str:
    """Write the Chrome trace JSON; returns ``path`` for chaining."""
    from ..utils.jsonsafe import json_safe

    # json_safe: Perfetto's strict JSON parser rejects a bare Infinity —
    # one inf counter sample must not make the whole trace unloadable
    with open(path, "w") as f:
        json.dump(
            json_safe(to_chrome_trace(spans, process_name, counters=counters)),
            f, allow_nan=False,
        )
    return path


def text_table(
    spans: Iterable[Span],
    t0: float | None = None,
    t1: float | None = None,
    device_busy_ms: float | None = None,
) -> str:
    """The plain-text "where did the time go" table over [t0, t1]
    (defaults to the spans' own extent)."""
    spans = list(spans)
    if not spans:
        return "(no spans recorded)"
    lo = t0 if t0 is not None else min(s.t0 for s in spans)
    hi = t1 if t1 is not None else max(s.t1 for s in spans)
    return window_report(spans, lo, hi, device_busy_ms=device_busy_ms).table()
