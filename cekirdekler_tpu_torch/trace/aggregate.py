"""Cluster-wide trace/metrics aggregation: N DCN processes, ONE timeline.

A copy of the reference's ``trace/aggregate.py`` kept in the port (which
never imports the JAX package); its transport is the port's
:meth:`~..cluster.dcn.DistributedAccelerator._allgather`, gloo on host
bytes.  The ``serving`` payload is shipped and merged as the reference's
is, and the port's ``serve.fabric.merge_shard_serving`` reads it.  The
text below is the reference's.

The tracer and the metrics registry are process-local; a
``DistributedAccelerator`` job runs N processes whose spans could never
be read on one timeline — each process's ``time.perf_counter`` has its
own arbitrary epoch.  This module closes that gap the way Dapper-style
aggregation pipelines do (PAPERS.md): worker processes ship their span
batches and metric snapshots to one logical collector, with per-process
**clock-offset estimation** so a collective that happened once appears
once, simultaneously, on every process's track of the merged Perfetto
trace.

Clock model (RTT-symmetric probe, the NTP midpoint argument):

- Every process wraps the SAME blocking collective (a tiny all-gather)
  in ``t_before``/``t_after`` local readings.  The collective completes
  at one global instant ``G``; each process's ``[t_before, t_after]``
  window contains ``G``, so the midpoint ``m_i = (t_before+t_after)/2``
  estimates ``G`` on clock *i* with error bounded by half that
  process's window width (the RTT-symmetry assumption — the same one
  NTP makes).
- A second all-gather ships the midpoints; ``offset_i = m_i - m_0``
  maps clock *i* onto process 0's clock: ``t_global = t_local -
  offset_i``.
- The probe repeats ``rounds`` times and takes the per-process MEDIAN
  offset — one garbage-collection pause during one round must not skew
  the alignment.

``skew_s`` on the probe/shipping entry points is a deterministic test
seam (same convention as ``DistributedAccelerator.timing_hook``): it
adds a constant to every LOCAL clock reading this module takes on this
process — simulating processes whose monotonic epochs genuinely differ,
which loopback test rigs (one machine, one CLOCK_MONOTONIC) cannot
produce naturally.  The estimator must recover and cancel exactly that
constant; ``tests/_torch_dcn_worker.py`` injects per-process skews of seconds
and asserts the merged trace stays collective-consistent to
milliseconds.
"""

from __future__ import annotations

import json
import time
from typing import Sequence

import numpy as np

from .spans import TRACER, Span

__all__ = [
    "estimate_clock_offsets",
    "gather_cluster",
    "merged_chrome_trace",
    "collective_consistency",
    "ClusterSnapshot",
]


def _now(skew_s: float) -> float:
    return time.perf_counter() + skew_s


def estimate_clock_offsets(
    acc, rounds: int = 5, skew_s: float = 0.0
) -> list[float]:
    """Per-process clock offsets onto process 0's clock (seconds).

    ``acc`` is a live :class:`~..cluster.dcn.
    DistributedAccelerator` (its ``_allgather`` is the probe transport —
    the measurement rides the same DCN path it will be used to align).
    SPMD: every process must call this at the same point; every process
    returns the SAME offset table.  ``offsets[i]`` subtracted from
    process *i*'s timestamps maps them onto process 0's timeline."""
    probe = np.zeros(1, np.float64)
    per_round: list[np.ndarray] = []
    for _ in range(max(1, rounds)):
        t_before = _now(skew_s)
        acc._allgather(probe)  # the shared global instant G
        t_after = _now(skew_s)
        mid = (t_before + t_after) / 2.0
        mids = acc._allgather(np.asarray([mid], np.float64)).reshape(-1)
        per_round.append(mids - mids[0])
    stacked = np.stack(per_round)  # [rounds, nproc]
    return [float(x) for x in np.median(stacked, axis=0)]


class ClusterSnapshot(dict):
    """The merged result of :func:`gather_cluster` — a dict with keys

    - ``offsets``: per-process clock offsets (seconds, process 0 = 0.0)
    - ``spans``: per-process span lists ALIGNED to process 0's clock
    - ``metrics``: per-process registry snapshots
    - ``health``: per-process lane-health reports
      (``Cores.health_report()`` shape; ``{}`` for a process that
      shipped none) — feed
      :func:`..obs.health.cluster_health_table` for the
      job-wide verdict table
    - ``serving``: per-process serving stats (``{}`` for a process
      that shipped none) — per-shard ``ServeFrontend.stats()`` docs
      keyed by member; feed
      the serving fabric's ``merge_shard_serving`` for the
      job-wide serving totals
    - ``reqtrace``: per-process request-lifecycle event rows
      (``[]`` for a process that shipped none) — ``obs.reqtrace``
      ``(t, rid, kind, fields)`` rows on WALL-clock stamps (epoch
      seconds, cross-process comparable on one host without the offset
      table); concatenate across processes and feed
      :func:`..obs.reqtrace.fold_phases` so a rid whose
      chain hopped shards reads as ONE record
    - ``nproc``

    (a dict subclass so it JSON-serializes untouched; spans are listed
    as plain dicts)."""


def _spans_to_rows(spans: Sequence[Span]) -> list[dict]:
    return [
        {"kind": s.kind, "t0": s.t0, "t1": s.t1, "cid": s.cid,
         "lane": s.lane, "tag": s.tag}
        for s in spans
    ]


def _rows_to_spans(rows: Sequence[dict], offset: float) -> list[Span]:
    return [
        Span(r["kind"], r["t0"] - offset, r["t1"] - offset,
             r.get("cid"), r.get("lane"), r.get("tag"))
        for r in rows
    ]


def gather_cluster(
    acc,
    spans: Sequence[Span] | None = None,
    metrics_snapshot: dict | None = None,
    rounds: int = 5,
    skew_s: float = 0.0,
    health: dict | None = None,
    serving: dict | None = None,
    reqtrace: Sequence | None = None,
) -> ClusterSnapshot:
    """Ship this process's spans + metrics + lane-health report to the
    cluster; return the merged, clock-aligned view (SPMD — every
    process receives the same merge; process 0 is the canonical
    collector that persists it).

    Payloads are JSON over the raw-byte all-gather (rectangularized by
    padding to the max length — the same shape rule the result exchange
    uses).  ``skew_s`` shifts this process's span timestamps AND its
    probe clock by the same constant, the deterministic end-to-end test
    of the estimator (see module docstring).  ``health`` defaults to
    the accelerator's own ``health_report()`` when it has one (the
    ``DistributedAccelerator`` passthrough to its local ``Cores``) —
    the DCN tier thereby sees every process's lane verdicts on one
    table (``obs.health.cluster_health_table``)."""
    from ..metrics.registry import REGISTRY

    if spans is None:
        spans = TRACER.snapshot()
    if metrics_snapshot is None:
        metrics_snapshot = REGISTRY.snapshot()
    if health is None:
        reporter = getattr(acc, "health_report", None)
        try:
            health = reporter() if callable(reporter) else {}
        except Exception:  # noqa: BLE001 - health must not sink the gather
            health = {}
    offsets = estimate_clock_offsets(acc, rounds=rounds, skew_s=skew_s)

    rows = _spans_to_rows(spans)
    if skew_s:
        for r in rows:
            r["t0"] += skew_s
            r["t1"] += skew_s
    from ..utils.jsonsafe import json_safe

    # json_safe: a numpy scalar in a caller-supplied metrics snapshot or
    # an inf ratio in a health report must not kill (or corrupt) the
    # whole cluster gather — every peer decodes this payload strictly
    # request-lifecycle rows ride as plain 4-lists; their stamps are
    # WALL clock (time.time) by the reqtrace contract, so — unlike the
    # spans — they need no per-process offset correction on one host
    req_rows = [
        [float(e[0]), str(e[1]), str(e[2]), dict(e[3] or {})]
        for e in (reqtrace or ())
    ]
    payload = json.dumps(
        json_safe(
            {"spans": rows, "metrics": metrics_snapshot, "health": health,
             "serving": serving or {}, "reqtrace": req_rows}
        ),
        allow_nan=False,
    ).encode()
    # rectangularize: exchange lengths first, pad to the max
    sizes = acc._allgather(np.asarray([len(payload)], np.int64)).reshape(-1)
    max_len = int(sizes.max())
    buf = np.zeros(max_len, np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, np.uint8)
    gathered = acc._allgather(buf)

    per_proc_spans: list[list[Span]] = []
    per_proc_metrics: list[dict] = []
    per_proc_health: list[dict] = []
    per_proc_serving: list[dict] = []
    per_proc_reqtrace: list[list] = []
    for p in range(len(sizes)):
        decoded = json.loads(
            gathered[p, : int(sizes[p])].tobytes().decode()
        )
        per_proc_spans.append(_rows_to_spans(decoded["spans"], offsets[p]))
        per_proc_metrics.append(decoded["metrics"])
        # .get: a peer running a pre-health build ships no key — its
        # absence stays visible as {} in the table, never an implied ok
        per_proc_health.append(decoded.get("health") or {})
        # same rule for serving stats (pre-fabric peers ship no key)
        per_proc_serving.append(decoded.get("serving") or {})
        # and for request-lifecycle rows (pre-reqtrace peers ship none)
        per_proc_reqtrace.append(decoded.get("reqtrace") or [])
    return ClusterSnapshot(
        offsets=offsets,
        spans=per_proc_spans,
        metrics=per_proc_metrics,
        health=per_proc_health,
        serving=per_proc_serving,
        reqtrace=per_proc_reqtrace,
        nproc=len(sizes),
    )


def merged_chrome_trace(snapshot: ClusterSnapshot) -> dict:
    """One Chrome-trace/Perfetto dict for the whole job: one process
    block per DCN process, every block against process 0's clock, so
    cross-process causality (a collective's simultaneous appearance on
    every track) is visible in the viewer.

    When the snapshot carries ``reqtrace`` rows, every process's rows
    are CONCATENATED and rendered as one ``requests`` process (one
    thread per rid) — a rid whose lifecycle hopped shards after a
    member kill therefore appears as a single continuous track, its
    diverted → rerouted chain visible across the kill."""
    from .export import to_chrome_trace

    all_spans = [s for spans in snapshot["spans"] for s in spans]
    t_base = min((s.t0 for s in all_spans), default=0.0)
    events: list[dict] = []
    for p, spans in enumerate(snapshot["spans"]):
        block = to_chrome_trace(
            spans, process_name=f"dcn process {p}", pid=p + 1,
            t_base=t_base,
        )
        events.extend(block["traceEvents"])
    req_rows = [r for rows in snapshot.get("reqtrace") or [] for r in rows]
    if req_rows:
        from ..obs.reqtrace import request_chrome_events

        # one call over the concatenation — the shared epoch base and
        # the per-rid thread map are what fuse cross-shard chains
        events.extend(request_chrome_events(req_rows))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def collective_consistency(
    snapshot: ClusterSnapshot, kind: str = "dcn-exchange"
) -> float:
    """Cross-process monotonic-consistency margin of the merged trace,
    in seconds (the acceptance gate's number).

    A blocking collective cannot COMPLETE on any process before every
    process has ENTERED it.  For the k-th span of ``kind`` on each
    process (the SPMD contract makes the k-th collective the same
    collective everywhere), the aligned timeline must therefore satisfy
    ``min_i(end_i_k) >= max_i(start_i_k)`` up to alignment error.
    Returns the WORST margin ``min_i(end) - max_i(start)`` across all k
    — positive means every collective's spans mutually overlap after
    alignment; a negative value beyond the probe's error bound means the
    clock alignment is wrong."""
    per_proc = [
        [s for s in spans if s.kind == kind] for spans in snapshot["spans"]
    ]
    counts = [len(x) for x in per_proc]
    n_collectives = min(counts) if counts else 0
    if n_collectives == 0:
        # a vacuous pass here would report "perfectly aligned" with zero
        # supporting evidence (e.g. one process's tracer never enabled,
        # or its ring wrapped past every exchange span) — loud, not inf
        raise ValueError(
            f"no {kind!r} spans present on every process — nothing to "
            "check alignment against (tracer off on some process, or its "
            "ring wrapped?)"
        )
    if len(set(counts)) > 1:
        # SPMD makes every process record the same collective sequence;
        # unequal counts mean some process LOST spans (ring wrap drops
        # oldest-first), so index-pairing would compare collective k
        # against collective k+M and report a false seconds-scale
        # negative margin — the clocks would look broken when only the
        # ring was too small
        raise ValueError(
            f"unequal {kind!r} span counts across processes {counts} — "
            "index pairing would misalign collectives (ring wrapped on "
            "the busiest process? raise Tracer capacity)"
        )
    worst = float("inf")
    for k in range(n_collectives):
        starts = [p[k].t0 for p in per_proc]
        ends = [p[k].t1 for p in per_proc]
        worst = min(worst, min(ends) - max(starts))
    return worst
