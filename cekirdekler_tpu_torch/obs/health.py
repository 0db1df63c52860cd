"""Lane health scoring: rolling per-lane baselines and a degradation
detector with hysteresis.

A copy of ``cekirdekler_tpu/obs/health.py`` kept in the port (which never
imports the JAX package); the text below is the reference's.

The drain actuator (:mod:`.drain`) needs an OBSERVATION half: something
that watches each lane's fence walls, transfer walls, and stream-queue
stalls, learns what "normal" looks like per lane (lanes are allowed to
be unequal — that is the whole reference premise; only a lane departing
from ITS OWN baseline is degradation), and produces machine-readable
verdicts.  This module is that half.  It is **advisory only**:
:meth:`HealthMonitor.suggest_drain` names lanes, it never drains one —
:class:`~.drain.DrainController` acts.

Detector math (pinned by ``tests/test_torch_health.py``):

- Samples stream in per (lane, signal) via :meth:`HealthMonitor.observe`
  (seconds).  Every ``window`` samples close one **window**; the window's
  MEDIAN is its value (a single GC pause or link hiccup inside a window
  must not flag it).
- The **baseline** is the rolling median of up to ``baseline_windows``
  previously closed, un-flagged window medians.  Flagged windows (ratio
  ≥ threshold) are excluded from the baseline on purpose: a persisting
  degradation must keep reading as degradation, not get absorbed into a
  "new normal" that silently re-greens the lane.
- ``ratio = current window median / baseline``.  A window with
  ``ratio ≥ threshold`` is a strike; ``confirm`` (default 3)
  consecutive strikes flip the (lane, signal) to **degraded** (a
  shorter strike streak reads **suspect** — enough windows to confirm
  have not elapsed).  So an injected N× degradation flips the lane
  within ``confirm`` windows of its onset (the acceptance bound: ≤ 3),
  while a 1-2 window contention blip only warns.
- **Hysteresis**: a degraded (lane, signal) recovers only when a closed
  window's ratio falls to ``release`` (default ``threshold/2``) — a
  lane oscillating around the threshold cannot flap ok/degraded each
  window.
- A lane's verdict is the WORST of its signals' states; the numeric
  score (0 ok / 1 suspect / 2 degraded) is exported as the
  ``ck_lane_health{lane}`` gauge on every window close.

Integration (core/cores.py): ``Cores`` owns one monitor; the barrier
feeds per-lane fence walls, ``_note_transfer``/``_finish_deferred`` feed
transfer walls, and the streamed path feeds stream-driver backpressure
stalls.  ``Cores.health_report()`` returns :meth:`HealthMonitor.report`; the
cluster tier ships each process's report so every process's lane
verdicts sit on one table (:func:`cluster_health_table`).
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from statistics import median

from ..metrics.registry import REGISTRY
from .decisions import DECISIONS

__all__ = [
    "HealthMonitor",
    "VERDICTS",
    "evaluate_window",
    "verdict_score",
    "score_verdict",
    "registry_health_summary",
    "cluster_health_table",
]

#: Verdict names in severity order — index IS the exported gauge value.
VERDICTS = ("ok", "suspect", "degraded")


def verdict_score(verdict: str) -> int:
    return VERDICTS.index(verdict)


def score_verdict(score: float) -> str:
    i = max(0, min(len(VERDICTS) - 1, int(round(score))))
    return VERDICTS[i]


def evaluate_window(
    med: float,
    baseline: float | None,
    streak: int,
    degraded: bool,
    threshold: float,
    confirm: int,
    release: float,
) -> dict:
    """The detector's PURE per-window state transition (see the module
    docstring for the math): one closed window's median against the
    rolling baseline → ``{"flagged", "ratio", "streak", "degraded"}``.

    Factored out of :meth:`HealthMonitor._close_window` so the decision
    is replay-verifiable: a ``health-verdict`` record carries exactly
    these arguments, and ``tools/ckreplay.py verify`` re-executes this
    function and asserts the identical transition.  ``ratio`` is None
    while the baseline is still learning AND in the zero-baseline
    strike case (never ``float('inf')`` — the RFC-8259 rule)."""
    flagged = False
    ratio: float | None = None
    if baseline is not None and baseline > 0.0:
        ratio = med / baseline
        if degraded:
            # hysteresis: only a clear return to baseline releases
            if ratio <= release:
                degraded = False
                streak = 0
            else:
                flagged = True
        elif ratio >= threshold:
            flagged = True
            streak += 1
            if streak >= confirm:
                degraded = True
        else:
            streak = 0
    elif baseline is not None and baseline == 0.0:
        # baseline of zero: any nonzero median is "infinitely" worse —
        # a material sample is a strike, zeros are normal
        ratio = None if med > 0.0 else 1.0
        if med > 0.0:
            flagged = True
            streak += 1
            if streak >= confirm:
                degraded = True
        else:
            streak = 0
            degraded = False
    # baseline None: still learning this signal's normal — no change
    return {"flagged": flagged, "ratio": ratio, "streak": streak,
            "degraded": degraded}


@dataclass
class _SignalState:
    """Rolling state of one (lane, signal)."""

    window: list = field(default_factory=list)
    history: deque = field(default_factory=deque)  # un-flagged medians
    last_median: float | None = None
    last_ratio: float | None = None
    windows_closed: int = 0
    streak: int = 0          # consecutive threshold strikes
    degraded: bool = False   # sticky until ratio <= release


class HealthMonitor:
    """Per-lane degradation detector (see module docstring).

    Thread-safe: ``observe`` may be called from worker/pool threads;
    verdict reads snapshot under the same lock (the debug server's
    lock-consistency contract — readers never block the hot path for
    longer than one small-state copy)."""

    def __init__(
        self,
        threshold: float = 3.0,
        window: int = 8,
        baseline_windows: int = 16,
        confirm: int = 3,
        release: float | None = None,
        min_history: int = 4,
    ):
        # defaults tuned on the 2-core CPU rig: confirm=3 still flips an
        # injected degradation within the 3-window acceptance bound, but
        # a 2-window contention blip (a scraper process landing on the
        # box) no longer does; min_history=4 keeps the baseline from
        # being judged off just two warm windows
        if threshold <= 1.0:
            raise ValueError(f"threshold must exceed 1.0: {threshold}")
        self.threshold = float(threshold)
        self.window = max(2, int(window))
        self.baseline_windows = max(2, int(baseline_windows))
        self.confirm = max(1, int(confirm))
        self.release = (
            float(release) if release is not None else self.threshold / 2.0
        )
        if not 1.0 <= self.release <= self.threshold:
            raise ValueError(
                f"release {self.release} must lie in [1.0, {self.threshold}]"
            )
        self.min_history = max(1, int(min_history))
        self._mu = threading.Lock()
        self._state: dict[tuple[int, str], _SignalState] = {}
        self._gauges: dict[int, object] = {}
        # last advisory recorded as a decision — suggest_drain dedups
        # on it (the health-verdict flip rule: a 1 Hz healthz/healthy()
        # poll during a sustained degradation must not fill the
        # decision ring with identical advisories)
        self._last_advisory: list[int] | None = None

    # -- inputs --------------------------------------------------------------
    def observe(self, lane: int, signal: str, seconds: float) -> None:
        """One sample of ``signal`` (``fence`` / ``transfer`` /
        ``stream_stall`` by convention) for ``lane``, in seconds.
        Negative/zero samples are recorded as 0 (a zero-cost window is a
        legitimate 'this lane did nothing expensive' observation)."""
        v = max(float(seconds), 0.0)
        with self._mu:
            st = self._state.setdefault((int(lane), signal), _SignalState())
            st.window.append(v)
            if len(st.window) >= self.window:
                self._close_window(int(lane), signal, st)

    def _close_window(self, lane: int, signal: str,
                      st: _SignalState) -> None:
        """Caller holds the lock.  Evaluate the closed window against
        the rolling baseline (:func:`evaluate_window` — the pure,
        replay-verifiable transition) and update the strike/hysteresis
        state.  A verdict FLIP records a ``health-verdict`` decision
        with the transition's complete inputs.

        (``last_ratio`` stays None for the zero-baseline strike — NOT
        ``float('inf')``: json.dumps serializes inf as the bare token
        `Infinity`, which is RFC-8259-invalid and would break every
        /healthz consumer and the DCN health payload.)"""
        med = median(st.window)
        st.window = []
        st.windows_closed += 1
        st.last_median = med
        baseline = (
            median(st.history) if len(st.history) >= self.min_history
            else None
        )
        before = self._signal_state_name(st)
        rec = None
        if DECISIONS.enabled:
            rec = {
                "lane": lane, "signal": signal,
                "median_s": med, "baseline_s": baseline,
                "streak": st.streak, "degraded": st.degraded,
                "threshold": self.threshold, "confirm": self.confirm,
                "release": self.release,
            }
        res = evaluate_window(
            med, baseline, streak=st.streak, degraded=st.degraded,
            threshold=self.threshold, confirm=self.confirm,
            release=self.release,
        )
        st.last_ratio = res["ratio"]
        st.streak = res["streak"]
        st.degraded = res["degraded"]
        if not res["flagged"]:
            st.history.append(med)
            while len(st.history) > self.baseline_windows:
                st.history.popleft()
        after = self._signal_state_name(st)
        if rec is not None and after != before:
            # the FLIP is the decision of record; steady windows are
            # recoverable from the metrics gauges and would swamp the
            # ring at scrape cadence
            DECISIONS.record("health-verdict", rec,
                             dict(res, state=after, state_before=before))
        self._export_gauge_locked(lane)

    def _export_gauge_locked(self, lane: int) -> None:
        pair = self._gauges.get(lane)
        if pair is None:
            pair = (
                REGISTRY.gauge(
                    "ck_lane_health",
                    "lane health verdict (0 ok / 1 suspect / 2 degraded)",
                    lane=lane,
                ),
                REGISTRY.gauge(
                    "ck_lane_health_peak",
                    "worst lane-health verdict seen this process "
                    "(monotone high-water)",
                    lane=lane,
                ),
            )
            self._gauges[lane] = pair
        g, peak = pair
        score = float(verdict_score(self._lane_verdict_locked(lane)[0]))
        g.set(score)
        # the high-water mark never decreases: later monitors (a fresh
        # Cores per bench section) must not erase an earlier section's
        # degradation from the process-wide artifact view
        if score > peak.value:
            peak.set(score)

    # -- verdicts ------------------------------------------------------------
    def _signal_state_name(self, st: _SignalState) -> str:
        if st.degraded:
            return "degraded"
        if st.streak > 0:
            return "suspect"
        return "ok"

    def _lane_verdict_locked(self, lane: int) -> tuple[str, dict]:
        worst = "ok"
        evidence: dict[str, dict] = {}
        for (ln, signal), st in self._state.items():
            if ln != lane:
                continue
            name = self._signal_state_name(st)
            if verdict_score(name) > verdict_score(worst):
                worst = name
            evidence[signal] = {
                "state": name,
                "windows": st.windows_closed,
                "baseline_ms": (
                    round(median(st.history) * 1000.0, 4)
                    if len(st.history) >= self.min_history else None
                ),
                "current_ms": (
                    round(st.last_median * 1000.0, 4)
                    if st.last_median is not None else None
                ),
                "ratio": (
                    round(st.last_ratio, 3)
                    if st.last_ratio is not None else None
                ),
                "streak": st.streak,
            }
        return worst, evidence

    def lanes(self) -> list[int]:
        with self._mu:
            return sorted({ln for (ln, _sig) in self._state})

    def verdict(self, lane: int) -> str:
        with self._mu:
            return self._lane_verdict_locked(int(lane))[0]

    def report(self) -> dict:
        """``{lane: {"verdict", "score", "evidence": {signal: {...}}}}``
        — the machine-readable health table (``/healthz``,
        ``Cores.health_report``, the DCN merge)."""
        with self._mu:
            out: dict = {}
            for lane in sorted({ln for (ln, _s) in self._state}):
                verdict, evidence = self._lane_verdict_locked(lane)
                out[lane] = {
                    "verdict": verdict,
                    "score": verdict_score(verdict),
                    "evidence": evidence,
                }
            return out

    def suggest_drain(self) -> list[int]:
        """Lanes currently DEGRADED — the advisory eviction candidate
        list.  Observation only: nothing in this module acts on it;
        :class:`~.drain.DrainController` is the consumer.

        A CHANGED advisory records a ``drain-advisory`` decision
        (inputs: every lane's verdict + per-signal ratios), so "why was
        this lane named" is answerable from the log alone.  Change-only, the health-verdict flip rule: a
        polling consumer (``healthy()`` at scrape cadence) during a
        sustained degradation must not evict the balancer/tuner
        provenance from the ring with identical advisories; the
        all-clear (a previously-advised list going empty) records too
        — recovery is a decision of record."""
        report = self.report()
        drain = [
            lane for lane, rec in report.items()
            if rec["verdict"] == "degraded"
        ]
        # compare-and-set under the monitor lock (report() released it
        # above — no nesting): the debug server's healthz thread and an
        # application poller race this path, and an unlocked RMW could
        # double-record a flip or overwrite the baseline the next real
        # change must compare against
        with self._mu:
            changed = drain != self._last_advisory and (
                drain or self._last_advisory)
            self._last_advisory = drain
        if changed and DECISIONS.enabled:
            DECISIONS.record("drain-advisory", {
                "lanes": {
                    str(lane): {
                        "verdict": rec["verdict"],
                        "ratios": {
                            sig: ev.get("ratio")
                            for sig, ev in rec["evidence"].items()
                        },
                    }
                    for lane, rec in report.items()
                },
            }, {"drain": list(drain)})
        return drain

    def healthy(self) -> bool:
        """True while no lane is degraded (the ``/healthz`` 200/503
        gate — ``suspect`` still answers 200: one strike is a warning,
        not an outage)."""
        return not self.suggest_drain()


# -- registry / cluster views ------------------------------------------------

def registry_health_summary(snapshot: dict | None = None) -> dict:
    """Per-lane verdicts recovered from the ``ck_lane_health`` (current)
    and ``ck_lane_health_peak`` (process-lifetime high-water) gauges in
    a registry snapshot (live registry when None) — the process-wide
    view that survives individual ``Cores`` disposal.  A benchmark
    artifact embeds this as its ``health`` block: ``worst``/``healthy``
    describe the run's END state, ``worst_seen`` whether ANY lane
    degraded at any point during the whole run (the peak gauge is
    monotone, so a later section's fresh monitor cannot erase it)."""
    if snapshot is None:
        snapshot = REGISTRY.snapshot()
    lanes: dict = {}
    for series, value in (snapshot.get("gauges") or {}).items():
        if not series.startswith("ck_lane_health"):
            continue
        is_peak = series.startswith("ck_lane_health_peak")
        lane = "?"
        if 'lane="' in series:
            lane = series.split('lane="', 1)[1].split('"', 1)[0]
        rec = lanes.setdefault(lane, {"score": 0.0, "verdict": "ok"})
        if is_peak:
            rec["peak"] = value
            rec["peak_verdict"] = score_verdict(value)
        else:
            rec["score"] = value
            rec["verdict"] = score_verdict(value)
    worst = max((v["score"] for v in lanes.values()), default=0.0)
    worst_seen = max(
        (v.get("peak", v["score"]) for v in lanes.values()), default=0.0)
    return {"lanes": lanes, "worst": score_verdict(worst),
            "worst_seen": score_verdict(worst_seen),
            "healthy": worst < 2}


def cluster_health_table(snapshot) -> dict:
    """Merge a cluster snapshot's (``{"health": [report, ...]}``)
    per-process health reports into one job-wide table::

        {"processes": [{"process": p, "lanes": {...}} ...],
         "degraded": [{"process": p, "lane": l, "evidence": {...}}],
         "worst": "ok|suspect|degraded"}

    Processes that shipped no health report (older peers, health off)
    appear with ``lanes: {}`` — absence is visible, never an implicit
    "ok"."""
    per_proc = snapshot.get("health") or []
    processes = []
    degraded = []
    worst = 0
    for p, rep in enumerate(per_proc):
        rep = rep or {}
        processes.append({"process": p, "lanes": rep})
        for lane, rec in rep.items():
            score = int(rec.get("score", verdict_score(rec.get("verdict", "ok"))))
            worst = max(worst, score)
            if rec.get("verdict") == "degraded":
                degraded.append({
                    "process": p, "lane": lane,
                    "evidence": rec.get("evidence"),
                })
    return {
        "processes": processes,
        "degraded": degraded,
        "worst": score_verdict(worst),
    }
