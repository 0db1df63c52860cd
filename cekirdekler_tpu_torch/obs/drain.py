"""DrainController: advisory drains become actions.

A copy of ``cekirdekler_tpu/obs/drain.py`` kept in the port (which never
imports the JAX package); the text below is the reference's.

The sensor (``HealthMonitor.suggest_drain()``) is explicitly advisory,
and the DecisionLog records every advisory.  This module is the
actuator: ``Cores`` owns one
controller, consults it at every barrier (the cold sync point — drains
happen at window boundaries, never mid-window), and masks the range
table through :func:`apply_quarantine` so a quarantined lane's share is
redistributed onto the surviving lanes via the normal re-split
machinery (the next compute sees a changed range table and takes the
existing sync-point-rebalance path: deferred records flushed, coverage
reset, host made current — nothing new to get wrong).

The per-lane state machine (:func:`drain_transition`, PURE and
replay-verified):

- **active** — verdict ``degraded`` → **drain**: the lane is
  quarantined (share → 0) for ``hold_barriers`` barriers.  The drain
  is a ``drain-apply`` decision record carrying every lane's verdict.
- **quarantined** — share 0.  A lane that runs nothing produces no
  health samples, so its verdict can never clear on its own; after
  ``hold_barriers`` barriers it enters **probation**.
- **probation** — the lane gets exactly ONE step-sized probe share
  (the smallest schedulable unit): its fence/transfer signals flow
  again.  Verdict ``degraded`` → back to quarantined (hold resets —
  no flapping); verdict ``ok`` for ``confirm_clear`` consecutive
  evaluations → **readmit** (a ``readmit`` decision record), and the
  balancer redistributes organically from the probe share.
- The controller never drains the LAST active lane: a fully-degraded
  rig limps, it does not halt (availability floor).

Hysteresis lives in two places on purpose: the HealthMonitor's
release threshold gates the VERDICT, and ``confirm_clear`` gates the
re-admission — a lane oscillating around the release boundary cannot
flap drained/active each barrier (pinned by tests/test_torch_drain.py).
"""

from __future__ import annotations

import threading

from ..metrics.registry import REGISTRY
from .decisions import DECISIONS
from .flight import FLIGHT

__all__ = [
    "DrainController",
    "drain_transition",
    "apply_quarantine",
    "LANE_ACTIVE",
    "LANE_QUARANTINED",
    "LANE_PROBATION",
    "MODEL_INVARIANTS",
]

LANE_ACTIVE = "active"
LANE_QUARANTINED = "quarantined"
LANE_PROBATION = "probation"

#: Machine-checked temporal invariants of the drain state machine
#: (``(id, kind, statement)`` — kind is ``safety`` or ``liveness``).
#: Declared NEXT to the machine they bind (the ``MODEL_INVARIANTS``
#: contract): the reference's model checker explores the product state
#: space of :func:`drain_transition` × :func:`apply_quarantine` under
#: small bounds and proves each of these over every reachable state
#: (probation↔quarantine flapping among them).
MODEL_INVARIANTS = (
    ("availability-floor", "safety",
     "the last active lane is never drained — every reachable state "
     "keeps at least one lane active"),
    ("share-conservation", "safety",
     "apply_quarantine preserves the range-table total exactly under "
     "every reachable drain/probation mask"),
    ("quarantine-masked", "safety",
     "a quarantined lane's masked share is 0; a probation lane's is "
     "exactly one step (the probe)"),
    ("action-visibility", "safety",
     "every lane whose state changed this barrier appears in "
     "drained/readmitted/probed — no silent transition (flapping is "
     "visible on every evidence stream)"),
    ("eventual-readmission", "liveness",
     "under sustained ok verdicts (fairness: the lane genuinely "
     "recovered) every non-active lane is readmitted within "
     "hold_barriers + confirm_clear + 1 barriers"),
    ("no-silent-flap", "liveness",
     "no all-ok barrier ever drains a lane: a quarantine↔probation "
     "cycle requires fresh degraded evidence at every relapse"),
)


def drain_transition(
    verdicts: dict,
    states: dict,
    hold: dict,
    clear_streak: dict,
    hold_barriers: int,
    confirm_clear: int,
    probe_grace: int = 2,
) -> dict:
    """The PURE per-barrier drain state transition (see the module
    docstring for the machine).  ``verdicts`` maps lane →
    ok/suspect/degraded (absent lane = no evidence = treated ``ok``);
    ``states``/``hold``/``clear_streak`` are the controller's carried
    state.  Returns the complete post-state plus the ``drained`` /
    ``readmitted`` / ``probed`` action lists — the decision records
    store exactly these arguments and outputs, so ``ckreplay verify``
    re-executes this function bit-identically.

    Keys arrive stringified when a record round-trips through JSON;
    everything here compares by normalized string key so a live
    transition and a disk-loaded replay run the same arithmetic."""
    verdicts = {str(k): v for k, v in verdicts.items()}
    states = {str(k): v for k, v in states.items()}
    hold = {str(k): int(v) for k, v in hold.items()}
    clear_streak = {str(k): int(v) for k, v in clear_streak.items()}
    lanes = sorted(states, key=lambda s: (len(s), s))
    drained: list[str] = []
    readmitted: list[str] = []
    probed: list[str] = []
    new_states = dict(states)
    new_hold = dict(hold)
    new_streak = dict(clear_streak)
    for lane in lanes:
        st = states.get(lane, LANE_ACTIVE)
        verdict = verdicts.get(lane, "ok")
        if st == LANE_ACTIVE:
            if verdict == "degraded":
                # availability floor: never drain the last active lane
                actives = [
                    ln for ln in lanes
                    if new_states.get(ln, LANE_ACTIVE) == LANE_ACTIVE
                ]
                if len(actives) <= 1:
                    continue
                new_states[lane] = LANE_QUARANTINED
                new_hold[lane] = int(hold_barriers)
                new_streak[lane] = 0
                drained.append(lane)
        elif st == LANE_QUARANTINED:
            h = new_hold.get(lane, 0) - 1
            new_hold[lane] = h
            if h <= 0:
                new_states[lane] = LANE_PROBATION
                new_streak[lane] = 0
                # `hold` doubles as the probation GRACE countdown: a
                # quarantined lane produced no health samples, so its
                # verdict is necessarily STALE-degraded when probation
                # begins — it takes the monitor a full window of probe
                # samples to re-judge, and relapsing on the stale
                # verdict would cycle probation↔quarantine forever
                # (reproduced by the chaos suite)
                new_hold[lane] = int(probe_grace)
                probed.append(lane)
        elif st == LANE_PROBATION:
            if verdict == "degraded":
                g = new_hold.get(lane, 0)
                if g > 0:
                    # stale-verdict grace: tolerate `probe_grace`
                    # degraded reads while fresh probe evidence closes
                    # a window (an `ok` — a genuinely released window —
                    # ends the grace early via the readmit path)
                    new_hold[lane] = g - 1
                    continue
                # a RE-quarantine is a drain action like any other: it
                # must land in `drained` so the decision record, the
                # flight event, and ck_drain_total all move — flapping
                # (probation↔quarantine oscillation) is visible on
                # every evidence stream, never silent
                new_states[lane] = LANE_QUARANTINED
                new_hold[lane] = int(hold_barriers)
                new_streak[lane] = 0
                drained.append(lane)
            elif verdict == "ok":
                s = new_streak.get(lane, 0) + 1
                new_streak[lane] = s
                if s >= int(confirm_clear):
                    new_states[lane] = LANE_ACTIVE
                    new_streak[lane] = 0
                    readmitted.append(lane)
            else:  # suspect: hold position, streak resets
                new_streak[lane] = 0
    return {
        "drained": drained,
        "readmitted": readmitted,
        "probed": probed,
        "states": new_states,
        "hold": new_hold,
        "clear_streak": new_streak,
    }


def apply_quarantine(
    ranges: list[int], step: int, drained: set, probation: set,
) -> list[int]:
    """Mask a range table with the drain state: quarantined lanes drop
    to 0, probation lanes to exactly one ``step`` (the probe), and the
    displaced share moves onto active lanes in step quanta, round-robin
    in lane order — deterministic, total-preserving, and IDEMPOTENT
    (``Cores._ranges_for`` applies it to cached tables every call).
    When no lane is active the table is returned unchanged (the
    availability floor — the transition never produces that state, but
    the masker must not divide by zero if handed it)."""
    n = len(ranges)
    active = [i for i in range(n)
              if i not in drained and i not in probation]
    if not active or (not drained and not probation):
        return list(ranges)
    out = list(ranges)
    freed = 0
    for i in range(n):
        if i in drained and out[i] > 0:
            freed += out[i]
            out[i] = 0
        elif i in probation and out[i] != step:
            # a probation lane holds exactly ONE probe step; the
            # difference lands in (or borrows from) the displaced pool
            freed += out[i] - step
            out[i] = step
    k = 0
    while freed >= step:
        out[active[k % len(active)]] += step
        freed -= step
        k += 1
    while freed <= -step:
        # borrow for the probe share from the largest active lane
        donor = max(active, key=lambda i: out[i])
        if out[donor] < step:
            break  # nothing left to borrow — leave the residue
        out[donor] -= step
        freed += step
    if freed > 0:
        out[active[0]] += freed  # sub-step residue to the first active
    return out


class DrainController:
    """The barrier-time drain actuator one :class:`~.core.cores.Cores`
    owns (see module docstring).  Thread-safe: ``evaluate`` runs at
    barriers; the share-mask readers (``drained_lanes`` /
    ``probe_lanes``) take one small-state snapshot."""

    def __init__(self, monitor, lanes: int, hold_barriers: int = 2,
                 confirm_clear: int = 2, probe_grace: int | None = None,
                 enabled: bool = True):
        self.monitor = monitor
        self.lanes = int(lanes)
        self.hold_barriers = max(1, int(hold_barriers))
        self.confirm_clear = max(1, int(confirm_clear))
        # default the stale-verdict grace to TWO monitor windows: one
        # for the detector to close a window of probe samples at all
        # (the verdict is necessarily stale-degraded until then), and
        # one because the FIRST probe window is polluted by the probe
        # transition itself — the range change resets upload coverage,
        # so that window carries a re-upload spike that re-flags the
        # lane against its steady baseline (the relapse loop the chaos
        # suite reproduced)
        self.probe_grace = max(1, int(
            probe_grace if probe_grace is not None
            else 2 * getattr(monitor, "window", 2)))
        self.enabled = bool(enabled)
        self._mu = threading.Lock()
        self._states: dict[str, str] = {
            str(i): LANE_ACTIVE for i in range(self.lanes)}
        self._hold: dict[str, int] = {}
        self._streak: dict[str, int] = {}
        self._drain_count = 0
        self._readmit_count = 0
        # cached gauge handles (evaluate is cold, but the per-lane set
        # is static — the cached-handle discipline)
        self._g_state = {
            i: REGISTRY.gauge(
                "ck_drain_state",
                "lane drain state (0 active / 1 probation / 2 quarantined)",
                lane=i)
            for i in range(self.lanes)
        }
        self._m_drains = REGISTRY.counter(
            "ck_drain_total", "lanes quarantined by the DrainController")
        self._m_readmits = REGISTRY.counter(
            "ck_drain_readmit_total",
            "lanes re-admitted after drain hysteresis cleared")

    # -- the barrier hook -----------------------------------------------------
    def evaluate(self) -> dict | None:
        """One barrier-time evaluation: read the monitor's verdicts,
        run the pure transition, apply it, and record ``drain-apply`` /
        ``readmit`` decisions for any action taken.  Returns the
        transition result (None when disabled)."""
        if not self.enabled:
            return None
        report = self.monitor.report()
        verdicts = {str(ln): rec["verdict"] for ln, rec in report.items()}
        with self._mu:
            inputs = None
            if DECISIONS.enabled:
                inputs = {
                    "verdicts": dict(verdicts),
                    "states": dict(self._states),
                    "hold": dict(self._hold),
                    "clear_streak": dict(self._streak),
                    "hold_barriers": self.hold_barriers,
                    "confirm_clear": self.confirm_clear,
                    "probe_grace": self.probe_grace,
                }
            res = drain_transition(
                verdicts, self._states, self._hold, self._streak,
                self.hold_barriers, self.confirm_clear,
                probe_grace=self.probe_grace)
            changed = res["states"] != self._states
            self._states = res["states"]
            self._hold = res["hold"]
            self._streak = res["clear_streak"]
            self._drain_count += len(res["drained"])
            self._readmit_count += len(res["readmitted"])
        if res["drained"]:
            self._m_drains.inc(len(res["drained"]))
            FLIGHT.event("drain-apply", lanes=list(res["drained"]))
            if inputs is not None:
                DECISIONS.record("drain-apply", inputs, res)
        if res["readmitted"]:
            self._m_readmits.inc(len(res["readmitted"]))
            FLIGHT.event("readmit", lanes=list(res["readmitted"]))
            if inputs is not None:
                DECISIONS.record("readmit", inputs, res)
        if res["probed"]:
            # the quarantine→probation tick is a state change too —
            # event-sourcing must see it (flight-level; the next
            # drain-apply/readmit record carries the full state)
            FLIGHT.event("drain-probe", lanes=list(res["probed"]))
        if changed:
            score = {LANE_ACTIVE: 0, LANE_PROBATION: 1,
                     LANE_QUARANTINED: 2}
            for i in range(self.lanes):
                g = self._g_state.get(i)
                if g is not None:
                    g.set(float(score.get(
                        res["states"].get(str(i), LANE_ACTIVE), 0)))
        res["changed"] = changed
        return res

    # -- share-mask readers (Cores._ranges_for) ------------------------------
    def drained_lanes(self) -> set[int]:
        with self._mu:
            return {int(ln) for ln, st in self._states.items()
                    if st == LANE_QUARANTINED}

    def probe_lanes(self) -> set[int]:
        with self._mu:
            return {int(ln) for ln, st in self._states.items()
                    if st == LANE_PROBATION}

    def lane_state(self, lane: int) -> str:
        with self._mu:
            return self._states.get(str(int(lane)), LANE_ACTIVE)

    def report(self) -> dict:
        with self._mu:
            return {
                "enabled": self.enabled,
                "states": dict(self._states),
                "hold": dict(self._hold),
                "clear_streak": dict(self._streak),
                "drains": self._drain_count,
                "readmits": self._readmit_count,
                "hold_barriers": self.hold_barriers,
                "confirm_clear": self.confirm_clear,
                "probe_grace": self.probe_grace,
            }

    def healthy_with_drains(self) -> bool:
        """True while every DEGRADED lane is already quarantined or on
        probation — the serving tier's admission gate: a drained lane
        means reduced capacity, not an outage, so requests re-dispatch
        onto the surviving lanes instead of being rejected (the raw
        ``HealthMonitor.healthy()`` would 503 the whole tier for the
        duration of every drain)."""
        report = self.monitor.report()
        with self._mu:
            for ln, rec in report.items():
                if rec["verdict"] != "degraded":
                    continue
                if self._states.get(str(ln), LANE_ACTIVE) == LANE_ACTIVE:
                    return False
        return True
