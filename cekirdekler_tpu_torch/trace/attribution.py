"""Attribution: reconcile host wall time against recorded spans and the
device timeline, and split shared fence cost per compute id.

A copy of ``cekirdekler_tpu/trace/attribution.py`` kept in the port
(which never imports the JAX package).  Two jobs:

1. **Window reports** (:func:`window_report`): given the spans recorded
   inside a host wall window and (optionally) the device-busy time from
   ``utils/timeline.py``'s ``torch.profiler`` reading, produce a "where
   did the time go" account: per-kind totals, per-compute-id totals, the
   host-covered union, and the unattributed gap.  The sum of span
   durations can legitimately exceed the wall (spans from concurrent
   lanes overlap) — the report therefore carries both the raw per-kind
   sums (cost accounting) and the union of intervals (wall coverage).

2. **Fence splitting** (:func:`split_fence_benches`): an enqueue-mode
   window would otherwise charge the ONE whole-window fence time to
   EVERY compute id dispatched in it.  Per-cid completion timestamps —
   measured by fencing each compute id's last launch in dispatch order
   (stream order makes each such fence retire exactly when that cid's
   final kernel retires) — become MARGINAL per-cid times: each cid is
   charged the time from the previous cid's completion to its own.  For
   batched windows (all of cid A, then all of cid B) the marginals are
   exact per-cid device costs; interleaved windows still charge a cid
   with any earlier-dispatched work of later-completing ids, the
   stream-order bound on what host-side fencing can attribute.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Sequence

from .spans import Span

__all__ = [
    "split_fence_benches", "window_report", "AttributionReport", "union_ms",
]


def split_fence_benches(
    completions: Sequence[tuple[int, float]], t_open: float
) -> dict[int, float]:
    """Per-cid marginal milliseconds from ordered completion timestamps.

    ``completions`` is [(cid, perf_counter_at_completion), ...] in the
    order the fences retired (== dispatch order of each cid's last
    launch); ``t_open`` is when the dispatch window opened.  Returns
    {cid: marginal_ms}.  Marginals are clamped at 0 (clock jitter on a
    same-instant retirement must not produce a negative bench, which the
    balancer would treat as infinite speed)."""
    out: dict[int, float] = {}
    prev = t_open
    for cid, t in completions:
        out[cid] = max(t - prev, 0.0) * 1000.0
        prev = max(prev, t)
    return out


def union_ms(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of (start, end) second-intervals, in ms —
    the wall-coverage reduction shared by the report below and external
    residue accounting (``workloads._nbody_attribution``)."""
    if not intervals:
        return 0.0
    intervals.sort()
    total = 0.0
    cs, ce = intervals[0]
    for s, e in intervals[1:]:
        if s > ce:
            total += ce - cs
            cs, ce = s, e
        else:
            ce = max(ce, e)
    return (total + (ce - cs)) * 1000.0


@dataclass
class AttributionReport:
    """One window's account.  All times in milliseconds."""

    wall_ms: float
    per_kind: dict = field(default_factory=dict)      # kind -> {ms, count}
    per_cid: dict = field(default_factory=dict)       # cid -> {kind: ms}
    # device kind -> {ms, count, lanes} (heterogeneous fleets): only
    # populated when the caller passes lane_kinds — the span ring
    # carries lane INDICES, the scheduler owns the index→kind map
    per_lane_kind: dict = field(default_factory=dict)
    covered_ms: float = 0.0    # union of span intervals (wall coverage)
    gap_ms: float = 0.0        # wall - covered: host time no span explains
    device_busy_ms: float | None = None   # from utils/timeline.py, if given
    device_busy_frac: float | None = None
    n_spans: int = 0
    ring_wrapped: bool = False
    dropped_spans: int = 0     # spans lost to ring wrap (totals undercount)

    def to_dict(self) -> dict:
        return {
            "wall_ms": round(self.wall_ms, 3),
            "covered_ms": round(self.covered_ms, 3),
            "gap_ms": round(self.gap_ms, 3),
            "gap_frac": round(self.gap_ms / self.wall_ms, 4)
            if self.wall_ms > 0 else None,
            "device_busy_ms": (
                round(self.device_busy_ms, 3)
                if self.device_busy_ms is not None else None
            ),
            "device_busy_frac": (
                round(self.device_busy_frac, 4)
                if self.device_busy_frac is not None else None
            ),
            "per_kind": {
                k: {"ms": round(v["ms"], 3), "count": v["count"]}
                for k, v in sorted(
                    self.per_kind.items(), key=lambda kv: -kv[1]["ms"]
                )
            },
            "per_cid": {
                str(cid): {k: round(ms, 3) for k, ms in kinds.items()}
                for cid, kinds in sorted(self.per_cid.items())
            },
            "per_lane_kind": {
                k: {"ms": round(v["ms"], 3), "count": v["count"],
                    "lanes": sorted(v["lanes"])}
                for k, v in sorted(
                    self.per_lane_kind.items(), key=lambda kv: -kv[1]["ms"]
                )
            },
            "n_spans": self.n_spans,
            "ring_wrapped": self.ring_wrapped,
            "dropped_spans": self.dropped_spans,
        }

    def table(self) -> str:
        """Plain-text "where did the time go" table."""
        lines = [
            f"wall {self.wall_ms:10.3f} ms   "
            f"span-covered {self.covered_ms:10.3f} ms   "
            f"gap {self.gap_ms:10.3f} ms"
        ]
        if self.device_busy_ms is not None:
            lines.append(
                f"device busy {self.device_busy_ms:10.3f} ms  "
                f"({100.0 * (self.device_busy_frac or 0.0):.1f}% of wall)"
            )
        lines.append(f"{'kind':>16} {'total ms':>12} {'count':>8} {'% wall':>8}")
        for kind, v in sorted(self.per_kind.items(), key=lambda kv: -kv[1]["ms"]):
            pct = 100.0 * v["ms"] / self.wall_ms if self.wall_ms > 0 else 0.0
            lines.append(
                f"{kind:>16} {v['ms']:12.3f} {v['count']:8d} {pct:8.1f}"
            )
        if self.per_lane_kind:
            lines.append(
                f"{'device kind':>16} {'total ms':>12} {'count':>8} "
                f"{'lanes':>8}")
            for kind, v in sorted(self.per_lane_kind.items(),
                                  key=lambda kv: -kv[1]["ms"]):
                lines.append(
                    f"{kind:>16} {v['ms']:12.3f} {v['count']:8d} "
                    f"{len(v['lanes']):8d}")
        if self.ring_wrapped:
            lines.append(
                f"(ring buffer wrapped: {self.dropped_spans} oldest spans "
                "overwritten — totals undercount; raise Tracer capacity)"
            )
        return "\n".join(lines)


def window_report(
    spans: Iterable[Span],
    t0: float,
    t1: float,
    device_busy_ms: float | None = None,
    ring_wrapped: bool = False,
    dropped_spans: int = 0,
    lane_kinds: dict | None = None,
) -> AttributionReport:
    """Account the host wall window [t0, t1] from recorded spans.

    Spans partially overlapping the window are clipped to it so a span
    straddling the boundary cannot inflate per-kind totals past the
    wall.  ``device_busy_ms`` (from ``timeline.analyze_trace_dir``)
    rides along for the host-vs-device reconciliation.
    ``dropped_spans`` (``Tracer.dropped_spans``) is how many spans the
    ring lost to wrap before this snapshot — when nonzero the report's
    totals/coverage undercount by exactly those spans, and the report
    says so instead of letting attribution coverage silently shrink.

    ``lane_kinds`` maps lane index → device kind (``Cores.lane_kinds``
    by position): when given, lane-tagged spans additionally roll up
    per DEVICE KIND — the heterogeneous-fleet account of which silicon
    the window's time went to (GPU vs host-CPU lanes in one Cores)."""
    wall_ms = max(t1 - t0, 0.0) * 1000.0
    per_kind: dict[str, dict] = {}
    per_cid: dict[int, dict] = {}
    per_lane_kind: dict[str, dict] = {}
    kind_of = {}
    if lane_kinds:
        kind_of = (dict(enumerate(lane_kinds))
                   if isinstance(lane_kinds, (list, tuple))
                   else dict(lane_kinds))
    intervals: list[tuple[float, float]] = []
    n = 0
    for s in spans:
        lo, hi = max(s.t0, t0), min(s.t1, t1)
        if hi < lo:
            continue
        n += 1
        ms = (hi - lo) * 1000.0
        k = per_kind.setdefault(s.kind, {"ms": 0.0, "count": 0})
        k["ms"] += ms
        k["count"] += 1
        if s.cid is not None:
            per_cid.setdefault(s.cid, {}).setdefault(s.kind, 0.0)
            per_cid[s.cid][s.kind] += ms
        if s.lane is not None and s.lane in kind_of:
            dk = per_lane_kind.setdefault(
                str(kind_of[s.lane]), {"ms": 0.0, "count": 0, "lanes": set()})
            dk["ms"] += ms
            dk["count"] += 1
            dk["lanes"].add(int(s.lane))
        if hi > lo:
            intervals.append((lo, hi))
    covered = union_ms(intervals)
    return AttributionReport(
        wall_ms=wall_ms,
        per_kind=per_kind,
        per_cid=per_cid,
        per_lane_kind=per_lane_kind,
        covered_ms=covered,
        gap_ms=max(wall_ms - covered, 0.0),
        device_busy_ms=device_busy_ms,
        device_busy_frac=(
            device_busy_ms / wall_ms
            if device_busy_ms is not None and wall_ms > 0 else None
        ),
        n_spans=n,
        ring_wrapped=ring_wrapped or dropped_spans > 0,
        dropped_spans=dropped_spans,
    )
