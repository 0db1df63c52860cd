"""Request-lifecycle tracing: tail-latency anatomy per request.

A copy of the reference's ``obs/reqtrace.py`` with its names, vocabulary
and arithmetic.  Nothing in the port produces request events yet: the
producers are the serving tier's frontend and fabric (ROADMAP Queue A
8).  Until then :data:`REQTRACE` stays empty unless a caller records
into it, and the pure functions below fold events from any source (a
reference run's events off the wire included).  The text below is the
reference's.

Every serving-tier request is stamped with a fabric-unique ``rid`` at
submit and records phase-transition events through its whole life into
:data:`REQTRACE`, an always-on bounded ring with the FLIGHT discipline
(obs/flight.py): plain-attribute ``enabled`` gate, GIL-atomic deque
append.

**The event vocabulary is the phase vocabulary.**  Events telescope: a
request's phase durations are the gaps between its consecutive events
(the later event NAMES the phase it closes), plus the explicit
``wait_s`` a chain's first event may carry (the admission wait the
frontend measures with ``perf_counter`` before any event exists to
telescope from).  Because every phase is a gap between recorded
stamps, per-request phase sums cover the measured request wall by
construction — the coverage :func:`tail_anatomy` reports.

Event timestamps are WALL-CLOCK (``time.time()``, the flight-recorder
rule): a rid's chain stays ordered when it hops processes.

Everything below the recorder is PURE: :func:`fold_phases` folds an
event list into per-request records, :func:`tail_anatomy` decomposes
p50/p95/p99 into per-phase milliseconds with the explicit coverage
fraction, :func:`phase_fracs` derives the queue and device fractions,
:func:`request_chrome_events` renders per-request Perfetto tracks
(merged into ``trace.device.unified_chrome_trace``), and
:func:`anatomy_table` renders the fixed-width table.  ``/reqz``
(obs/debugserver.py) serves :func:`reqz_payload`.
"""

from __future__ import annotations

import itertools
import os
import time
from collections import deque
from typing import NamedTuple

__all__ = [
    "REQ_EVENT_KINDS",
    "TERMINAL_KINDS",
    "QUEUE_PHASES",
    "ReqEvent",
    "ReqTrace",
    "REQTRACE",
    "fold_phases",
    "tail_anatomy",
    "phase_fracs",
    "tenant_percentiles",
    "slowest_requests",
    "request_chrome_events",
    "anatomy_table",
    "reqz_payload",
]

#: The request-lifecycle phase vocabulary — every ``REQTRACE.event``
#: kind must be one of these (the reference's, unchanged).
REQ_EVENT_KINDS = (
    "admitted",       # admission verdict landed (carries the gate wait)
    "queued",         # first planning cycle saw the request's group
    "coalesce-wait",  # the coalescer picked the group (batching delay)
    "warm-compile",   # compile-cache miss inside the dispatch window
    "dispatched",     # the request's batch left for the device queues
    "device",         # fused-window wall retired (barrier + flush)
    "contained",      # blast-radius containment handled its batch part
    "retry-backoff",  # a granted retry's backoff (inline or deferred)
    "diverted",       # routed off its ring owner by the health view
    "rerouted",       # re-submitted on a ring survivor after a kill
    "resolved",       # future resolved with a result
    "failed",         # future failed with the NAMED cause
)

#: Chain-terminal kinds: a request record is complete when its last
#: event is one of these (a mid-chain ``failed`` followed by a
#: ``rerouted`` hop is NOT terminal — the chain continues elsewhere).
TERMINAL_KINDS = ("resolved", "failed")

#: The phases that count as "time spent waiting to run" for the
#: regress-watched ``serve_p99_queue_frac`` (see :func:`phase_fracs`).
QUEUE_PHASES = ("admitted", "queued", "coalesce-wait")


class ReqEvent(NamedTuple):
    """One phase-transition stamp (wall-clock ``time.time()`` — the
    cross-process merge rule; see module docstring)."""

    t: float
    rid: str
    kind: str
    fields: dict


class ReqTrace:
    """The request-lifecycle recorder: a bounded ring of
    :class:`ReqEvent`, always on (the flight-recorder discipline —
    ``enabled`` is a PLAIN attribute read, the append is ONE GIL-atomic
    ``deque.append``, and a full ring evicts oldest-first instead of
    blocking or growing)."""

    def __init__(self, capacity: int = 65536):
        self.enabled = True  # plain attribute: the <100ns disabled read
        self._cap = max(16, int(capacity))
        self._ring: deque[ReqEvent] = deque(maxlen=self._cap)
        self._total = 0
        # rid minting: pid-stamped counter — unique across every fabric
        # process on the host without coordination (the `_fabric_worker`
        # wire carries rids verbatim, so collision-freedom is what keeps
        # a merged cluster chain ONE request's).  itertools.count: the
        # increment is ONE C-level next() — GIL-atomic, no lock on the
        # submit hot path
        self._seq = itertools.count(1)

    def mint(self) -> str:
        """A fabric-unique request id (``r<pid>-<seq>``)."""
        return f"r{os.getpid():x}-{next(self._seq):x}"

    def event(self, rid: str, kind: str, **fields) -> None:
        """Record one phase transition for ``rid``.  Hot-path safe:
        disabled is one attribute read; enabled is one tuple build +
        one deque append (computed fields at call sites stay behind
        ``REQTRACE.enabled``)."""
        if not self.enabled:
            return
        self._ring.append(ReqEvent(time.time(), rid, kind, fields))
        self._total += 1  # GIL-racy undercount possible; reporting only

    def snapshot(self) -> list[ReqEvent]:
        """Recorded events, oldest first (reporting-only consistency —
        the flight-recorder snapshot rule)."""
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()
        self._total = 0

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def total_recorded(self) -> int:
        return self._total


#: Process-wide recorder singleton (the FLIGHT pattern): the serving
#: tier records here; ``/reqz``, loadgen, and the cluster exchange read
#: here.
REQTRACE = ReqTrace()


# -- pure phase folding ------------------------------------------------------
def _row(ev):
    """Normalize one event (ReqEvent, 4-tuple/list off the wire, or an
    ``{"t", "rid", "kind", "fields"}`` dict) to ``(t, rid, kind,
    fields)``."""
    if isinstance(ev, dict):
        return (float(ev.get("t") or 0.0), str(ev.get("rid") or ""),
                str(ev.get("kind") or ""), dict(ev.get("fields") or {}))
    t, rid, kind, fields = ev
    return (float(t), str(rid), str(kind), dict(fields or {}))


def fold_phases(events) -> list[dict]:
    """PURE: fold an event list into one record per rid.

    Phases telescope (see module docstring): the later event of each
    consecutive pair names the phase that gap belongs to, and a chain's
    FIRST event contributes its explicit ``wait_s`` (the pre-event
    admission wait).  ``wall_s`` prefers the terminal event's measured
    ``latency_s`` (the frontend's own ``perf_counter`` wall) and falls
    back to the chain's stamp extent; ``coverage`` = phase sum /
    ``wall_s`` — the ≥0.95 contract's numerator and denominator, never
    hidden.  Records sort by completion time."""
    by: dict[str, list] = {}
    for ev in events:
        t, rid, kind, fields = _row(ev)
        if rid:
            by.setdefault(rid, []).append((t, kind, fields))
    records = []
    for rid, evs in by.items():
        evs.sort(key=lambda e: e[0])
        t0 = evs[0][0]
        lead = float(evs[0][2].get("wait_s") or 0.0)
        phases: dict[str, float] = {evs[0][1]: lead}
        prev = t0
        for t, kind, fields in evs[1:]:
            phases[kind] = phases.get(kind, 0.0) + max(0.0, t - prev)
            prev = t
        tenant = None
        outcome = None
        wall = None
        for _t, kind, fields in evs:
            if fields.get("tenant") is not None:
                tenant = str(fields["tenant"])
            if kind in TERMINAL_KINDS:
                outcome = kind
                if fields.get("latency_s") is not None:
                    wall = float(fields["latency_s"])
        if evs[-1][1] not in TERMINAL_KINDS:
            outcome = None  # chain continues (e.g. rerouted elsewhere)
            wall = None
        if wall is None:
            wall = (prev - t0) + lead
        total = sum(phases.values())
        records.append({
            "rid": rid,
            "tenant": tenant,
            "outcome": outcome,
            "t0": t0,
            "t1": prev,
            "wall_s": wall,
            "phases_s": phases,
            "coverage": (total / wall) if wall > 0 else 1.0,
            "kinds": [k for _t, k, _f in evs],
        })
    records.sort(key=lambda r: (r["t1"], r["rid"]))
    return records


def _nearest_rank(n: int, pct: float) -> int:
    """PURE: nearest-rank percentile index into a sorted length-n
    list."""
    if n <= 1:
        return 0
    k = int(round((float(pct) / 100.0) * (n - 1)))
    return min(max(k, 0), n - 1)


def tail_anatomy(records, pcts=(50, 95, 99)) -> dict:
    """PURE: decompose the latency percentiles into per-phase
    milliseconds.

    For each requested percentile the nearest-rank COMPLETED request is
    picked and its phase breakdown reported verbatim (a real request's
    anatomy — not an average that smears phases across requests), with
    its explicit ``coverage`` fraction.  A ``mean`` block aggregates
    the per-phase means over every completed request.  Returns
    ``{"count", "pcts": {"p50": {"rid", "wall_ms", "coverage",
    "phases_ms"}, ...}, "mean": {...}}``."""
    done = [r for r in records if r.get("outcome") in TERMINAL_KINDS]
    done.sort(key=lambda r: r["wall_s"])
    out: dict = {"count": len(done), "pcts": {}}
    if not done:
        return out
    for p in pcts:
        r = done[_nearest_rank(len(done), p)]
        out["pcts"][f"p{p:g}"] = {
            "rid": r["rid"],
            "wall_ms": r["wall_s"] * 1e3,
            "coverage": r["coverage"],
            "phases_ms": {k: v * 1e3
                          for k, v in sorted(r["phases_s"].items())},
        }
    mean: dict[str, float] = {}
    for r in done:
        for k, v in r["phases_s"].items():
            mean[k] = mean.get(k, 0.0) + v
    out["mean"] = {
        "wall_ms": sum(r["wall_s"] for r in done) / len(done) * 1e3,
        "phases_ms": {k: v / len(done) * 1e3
                      for k, v in sorted(mean.items())},
    }
    return out


def phase_fracs(record) -> dict:
    """PURE: one record's queue/device wall fractions — the
    regress-watched ``serve_p99_queue_frac`` /
    ``serve_p99_device_frac`` oracles (queue = the
    :data:`QUEUE_PHASES` sum; device = the ``device`` phase)."""
    rec = record or {}
    wall = float(rec.get("wall_s") or 0.0)
    ph = rec.get("phases_s") or {}
    if wall <= 0:
        return {"queue_frac": 0.0, "device_frac": 0.0}
    queue = sum(float(ph.get(k) or 0.0) for k in QUEUE_PHASES)
    return {"queue_frac": queue / wall,
            "device_frac": float(ph.get("device") or 0.0) / wall}


def tenant_percentiles(records, pcts=(50, 99)) -> dict:
    """PURE: per-tenant wall percentiles with the picked request's
    phase breakdown (the ``/reqz`` per-tenant view)."""
    by: dict[str, list] = {}
    for r in records:
        if r.get("outcome") in TERMINAL_KINDS:
            by.setdefault(str(r.get("tenant")), []).append(r)
    out = {}
    for tenant, rs in sorted(by.items()):
        rs.sort(key=lambda r: r["wall_s"])
        row = {"count": len(rs)}
        for p in pcts:
            r = rs[_nearest_rank(len(rs), p)]
            row[f"p{p:g}_ms"] = r["wall_s"] * 1e3
            row[f"p{p:g}_phases_ms"] = {
                k: v * 1e3 for k, v in sorted(r["phases_s"].items())}
        out[tenant] = row
    return out


def slowest_requests(records, n: int = 10) -> list[dict]:
    """PURE: the n slowest completed records, slowest first."""
    done = [r for r in records if r.get("outcome") in TERMINAL_KINDS]
    done.sort(key=lambda r: r["wall_s"], reverse=True)
    return done[: max(0, int(n))]


def request_chrome_events(events, t_base: float | None = None,
                          pid: int = 90,
                          process_name: str = "requests") -> list[dict]:
    """PURE: per-request Perfetto tracks — one thread per rid, one
    ``X`` slice per phase (cat ``ck-req``, so the round-trip importer
    in ``trace/device.split_unified_trace`` can tell request slices
    from host spans).  ``t_base`` defaults to the earliest stamp; the
    chain's leading explicit ``wait_s`` renders as a slice ENDING at
    the first stamp (the pre-event admission wait)."""
    rows = sorted((_row(e) for e in events), key=lambda r: (r[0], r[1]))
    rows = [r for r in rows if r[1]]
    if not rows:
        return []
    if t_base is None:
        t_base = rows[0][0] - float(rows[0][3].get("wait_s") or 0.0)
    out: list[dict] = [{
        "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
        "args": {"name": process_name},
    }]
    by: dict[str, list] = {}
    for r in rows:
        by.setdefault(r[1], []).append(r)
    for tid, rid in enumerate(sorted(by), start=1):
        evs = by[rid]
        out.append({"ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_name", "args": {"name": rid}})
        lead = float(evs[0][3].get("wait_s") or 0.0)
        if lead > 0:
            out.append({
                "ph": "X", "pid": pid, "tid": tid, "cat": "ck-req",
                "name": evs[0][2],
                "ts": (evs[0][0] - lead - t_base) * 1e6,
                "dur": lead * 1e6,
                "args": {"rid": rid},
            })
        prev = evs[0][0]
        for t, _rid, kind, fields in evs[1:]:
            out.append({
                "ph": "X", "pid": pid, "tid": tid, "cat": "ck-req",
                "name": kind,
                "ts": (prev - t_base) * 1e6,
                "dur": max(0.0, t - prev) * 1e6,
                "args": dict(fields, rid=rid),
            })
            prev = t
    return out


def anatomy_table(anatomy) -> str:
    """PURE: render one :func:`tail_anatomy` result as the fixed-width
    table the reference's ``tools/loadgen.py`` prints after every run."""
    doc = anatomy or {}
    pcts = doc.get("pcts") or {}
    if not pcts:
        return "tail anatomy: no completed requests recorded"
    kinds = sorted({k for row in pcts.values()
                    for k in (row.get("phases_ms") or {})})
    lines = ["tail anatomy (per-phase ms; coverage = phase sum / "
             "measured wall):"]
    head = f"  {'pct':>5} {'wall_ms':>9} {'cover':>6}"
    for k in kinds:
        head += f" {k:>13}"
    lines.append(head)
    for name, row in sorted(pcts.items()):
        line = (f"  {name:>5} {row.get('wall_ms', 0.0):>9.3f} "
                f"{row.get('coverage', 0.0):>6.3f}")
        ph = row.get("phases_ms") or {}
        for k in kinds:
            line += f" {ph.get(k, 0.0):>13.3f}"
        lines.append(line)
    return "\n".join(lines)


def reqz_payload(events=None, n_slow: int = 10, n_recent: int = 50,
                 pcts=(50, 95, 99)) -> dict:
    """The ``/reqz`` debug-endpoint body: recent requests, the
    slowest-N with their phase breakdowns, per-tenant phase
    percentiles, and the full tail anatomy — all folded from one
    recorder snapshot (snapshot-copy discipline)."""
    evs = REQTRACE.snapshot() if events is None else list(events)
    records = fold_phases(evs)

    def _brief(r):
        return {
            "rid": r["rid"], "tenant": r["tenant"],
            "outcome": r["outcome"],
            "wall_ms": r["wall_s"] * 1e3,
            "coverage": r["coverage"],
            "phases_ms": {k: v * 1e3
                          for k, v in sorted(r["phases_s"].items())},
            "kinds": r["kinds"],
        }

    return {
        "enabled": REQTRACE.enabled,
        "capacity": REQTRACE.capacity,
        "total_recorded": REQTRACE.total_recorded,
        "events": len(evs),
        "requests": len(records),
        "recent": [_brief(r) for r in records[-max(0, int(n_recent)):]],
        "slowest": [_brief(r)
                    for r in slowest_requests(records, n_slow)],
        "tenants": tenant_percentiles(records),
        "anatomy": tail_anatomy(records, pcts),
    }
