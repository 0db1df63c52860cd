"""ckmodel — bounded exhaustive model checking of the pure controller
state machines, against the invariants each machine declares.

A copy of the reference's ``analysis/model.py`` for the machines whose
controllers the port has: :class:`DrainMachine` drives the port's
``obs/drain.py`` (``drain_transition`` x ``apply_quarantine``),
:class:`ElasticMachine` the port's ``cluster/elastic.py``
(``Membership`` under every roster reconciliation),
:class:`BalanceMachine` the port's ``core/balance.py``
(``load_balance`` / ``prior_split``), the ``serve`` machines
(:class:`AdmissionMachine`, :class:`CoalesceMachine`) the port's
``serve/admission.py`` and ``serve/coalescer.py``, the ``resilience``
machines (:class:`BreakerMachine`, :class:`ShedMachine`,
:class:`RetryMachine`) its ``serve/resilience.py`` and
:class:`RouterMachine` a real ``serve/fabric.ShardRouter``, with the
reference's bounds, invariants, counterexample traces and reports.  The
``block`` machine name raises :class:`~..errors.NotPortedError` naming
the ROADMAP Queue A item that brings its controller (the block tuner,
A 9).  The reference's ``tools/ckmodel`` CLI and its purity lint are
Queue A 12.  The text below is the reference's.

Design rules:

1. **The real functions, no re-modeling.**  Each machine imports and
   drives the SAME pure controller functions ``ckreplay verify``
   re-executes.  A checker that re-models the transition relation
   drifts from the code it claims to verify; this one cannot.
2. **Properties live next to the machines.**  Each controller module
   declares its ``MODEL_INVARIANTS`` (``(id, kind, statement)`` rows);
   the machine classes here implement exactly that list (asserted at
   construction) — an invariant cannot be declared and silently
   unchecked, or checked and undeclared.
3. **Exhaustive under small bounds.**  Breadth-first search over the
   product state space with canonical state hashing; balancer
   trajectories (deterministic per rate/knob config) explore a
   quantized rate alphabet × knob grid to an exact fixpoint, limit
   cycle, or horizon.  Tier-1 bounds finish in seconds; the
   :data:`DEPTH_ENV` (``CK_MODEL_DEPTH``) knob deepens.
4. **Violations are decision-log traces.**  A counterexample is a
   minimal (BFS-shortest) sequence of records in the
   ``obs/decisions.py`` row schema — balance steps are the REAL records
   the live emission sites produced during exploration — so ``ckreplay
   explain`` renders it and ``ckreplay verify`` re-executes it.

Exploration runs with the decision log captured into a scratch ring
and the flight recorder disabled (the replay "quiesced" discipline):
like replay-verify, it re-executes emission sites that also touch
``ck_balance_*`` counters, so run it at sync points.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from collections import deque
from contextlib import contextmanager

from ..errors import NotPortedError
from ..obs.decisions import DECISIONS
from ..utils.jsonsafe import json_safe


__all__ = [
    "ModelViolation",
    "MachineBase",
    "DrainMachine",
    "ElasticMachine",
    "RouterMachine",
    "AdmissionMachine",
    "CoalesceMachine",
    "BalanceMachine",
    "BreakerMachine",
    "ShedMachine",
    "RetryMachine",
    "MACHINE_NAMES",
    "PORTED_MACHINES",
    "build_machines",
    "check_machine",
    "check_all",
    "tier1_check",
    "DEPTH_ENV",
]

#: CLI/bench machine vocabulary: ``serve`` groups the admission and
#: coalesce sub-machines (one serving tier, two pure planners);
#: ``resilience`` groups the breaker, brownout-shed and retry-budget
#: machines (``serve/resilience.py``); ``block`` explores the tile
#: autotuner's choice transition (``core/blocktuner.py``); ``router``
#: explores the serving fabric's consistent-hash placement
#: (``serve/fabric.py``).
MACHINE_NAMES = ("drain", "elastic", "serve", "balance", "resilience",
                 "block", "router")

#: The machines the port can drive; every other name of
#: :data:`MACHINE_NAMES` names the ROADMAP Queue A item that ports its
#: controllers.
PORTED_MACHINES = ("drain", "elastic", "serve", "balance", "resilience",
                   "router")
NOT_PORTED = {
    "block": "Queue A 9 (the attention stack: core/blocktuner.py)",
}

#: Deepen-on-the-bench-rig knob: a positive integer scales the bounds
#: (balancer horizon, starvation caps, rate alphabet) beyond tier-1.
DEPTH_ENV = "CK_MODEL_DEPTH"

#: Violation-detail caps (the scan never stops early; only the
#: retained counterexamples are bounded — the verify_records rule).
#: The per-invariant cap keeps one noisy invariant from evicting every
#: other invariant's counterexamples out of the report.
MAX_VIOLATIONS = 64
PER_INVARIANT_VIOLATIONS = 4


@contextmanager
def _captured():
    """Exploration harness: decisions into a scratch ring (so machines
    can harvest the REAL records the live sites emit), flight recorder
    off (thousands of synthetic barriers must not evict a live ring)."""
    from ..obs.flight import FLIGHT

    saved = FLIGHT.enabled
    FLIGHT.enabled = False
    try:
        with DECISIONS.capture():
            yield
    finally:
        FLIGHT.enabled = saved


def _last_seq() -> int:
    snap = DECISIONS.snapshot()
    return snap[-1].seq if snap else 0


def _harvest(mark: int) -> list[dict]:
    """Records emitted since ``mark`` (the scratch ring under
    :func:`_captured`), as plain rows."""
    return [r.to_row() for r in DECISIONS.snapshot() if r.seq > mark]


class ModelViolation:
    """One invariant violation with its minimal counterexample trace.

    Duck-typed to the reference's ratchet-baseline contract
    (``fingerprint`` / ``path`` / ``line`` / ``to_row`` / ``render``).  The
    fingerprint hashes (machine, invariant, terminal canonical state)
    — line-free and stable across exploration-order changes."""

    def __init__(self, machine: str, invariant: str, kind: str,
                 message: str, state_doc: dict, trace: list[dict]):
        self.machine = machine
        self.invariant = invariant
        self.kind = kind
        self.message = message
        self.state_doc = state_doc
        # minimal counterexample: rows in the DecisionRecord schema,
        # seq renumbered 1..n (order preserved — verify sorts by seq)
        self.trace = [
            dict(row, seq=i) for i, row in enumerate(trace, start=1)
        ]
        self.path = f"model:{machine}"
        self.line = 0
        payload = json.dumps(
            json_safe([machine, invariant, state_doc]),
            sort_keys=True, default=str, allow_nan=False)
        self.fingerprint = hashlib.sha1(
            payload.encode()).hexdigest()[:12]

    def to_row(self) -> dict:
        return {
            "fingerprint": self.fingerprint,
            "path": self.path,
            "line": self.line,
            "machine": self.machine,
            "invariant": self.invariant,
            "kind": self.kind,
            "message": self.message,
            "state": self.state_doc,
            "trace_len": len(self.trace),
        }

    def render(self) -> str:
        return (f"[{self.fingerprint}] {self.machine}: "
                f"{self.invariant} ({self.kind}) VIOLATED — "
                f"{self.message} (trace: {len(self.trace)} step(s))")


class MachineBase:
    """One bounded controller machine.

    Graph machines implement ``initial_states`` / ``actions`` /
    ``check_state`` / ``check_action`` (+ optional ``check_liveness``)
    over hashable canonical states; trajectory machines (the balancer)
    override :meth:`explore` wholesale.  ``invariants`` is the owning
    module's ``MODEL_INVARIANTS``; the constructor asserts the
    implemented check ids cover it exactly."""

    name = "?"
    invariants: tuple = ()
    #: invariant ids the implementation checks — must equal the
    #: declared list (asserted in __init__)
    checks: tuple = ()

    def __init__(self):
        declared = {row[0] for row in self.invariants}
        implemented = set(self.checks)
        assert declared == implemented, (
            f"{self.name}: declared MODEL_INVARIANTS "
            f"{sorted(declared)} != implemented checks "
            f"{sorted(implemented)}")
        self._exercised: dict[str, int] = {row[0]: 0 for row in
                                           self.invariants}

    # -- graph-machine protocol ----------------------------------------------
    def initial_states(self) -> list:
        raise NotImplementedError

    def actions(self, state) -> list:
        """``[(label, rows, next_state), ...]`` — rows are decision-
        record dicts for this edge (the counterexample vocabulary)."""
        raise NotImplementedError

    def canon(self, state):
        return state

    def state_doc(self, state) -> dict:
        return {"state": repr(state)}

    def check_state(self, state) -> list:
        """``[(invariant_id, message), ...]`` violated AT ``state``."""
        return []

    def check_action(self, state, label, rows, nxt) -> list:
        return []

    def check_liveness(self, state) -> list:
        """``[(invariant_id, message, extra_rows), ...]`` — bounded
        eventually-properties probed from ``state`` under a fair
        schedule; ``extra_rows`` extend the counterexample past the
        reachable prefix."""
        return []

    def _hit(self, inv_id: str) -> None:
        self._exercised[inv_id] += 1

    # -- the explorer ---------------------------------------------------------
    def explore(self, max_depth: int = 256,
                max_states: int = 500_000) -> dict:
        """Bounded exhaustive BFS with canonical state hashing.
        Returns the machine report (states/transitions/violations/
        exercised counts).  The scan is never cut short by violations;
        only retained counterexamples are capped."""
        violations: list[ModelViolation] = []
        seen: dict = {}
        parents: dict = {}  # canon -> (parent_canon, rows)
        depth_of: dict = {}
        queue: deque = deque()
        transitions = 0
        truncated = False

        def _trace(c) -> list[dict]:
            rows: list[dict] = []
            while c is not None:
                ent = parents.get(c)
                if ent is None:
                    break
                c, step_rows = ent
                rows[:0] = step_rows
            return rows

        vio_counts: dict[str, int] = {}

        def _violate(inv_id, msg, c, state, extra_rows=()):
            self._hit(inv_id)
            if len(violations) >= MAX_VIOLATIONS or \
                    vio_counts.get(inv_id, 0) >= PER_INVARIANT_VIOLATIONS:
                return
            vio_counts[inv_id] = vio_counts.get(inv_id, 0) + 1
            kind = next(k for i, k, _d in self.invariants if i == inv_id)
            violations.append(ModelViolation(
                self.name, inv_id, kind, msg, self.state_doc(state),
                _trace(c) + list(extra_rows)))

        with _captured():
            for s0 in self.initial_states():
                c0 = self.canon(s0)
                if c0 in seen:
                    continue
                seen[c0] = s0
                depth_of[c0] = 0
                queue.append(c0)
            while queue:
                c = queue.popleft()
                state = seen[c]
                for inv_id, msg in self.check_state(state):
                    _violate(inv_id, msg, c, state)
                for inv_id, msg, extra in self.check_liveness(state):
                    _violate(inv_id, msg, c, state, extra)
                if depth_of[c] >= max_depth:
                    truncated = True
                    continue
                for label, rows, nxt in self.actions(state):
                    transitions += 1
                    for inv_id, msg in self.check_action(
                            state, label, rows, nxt):
                        _violate(inv_id, msg, c, state, rows)
                    cn = self.canon(nxt)
                    if cn in seen:
                        continue
                    if len(seen) >= max_states:
                        truncated = True
                        continue
                    seen[cn] = nxt
                    parents[cn] = (c, rows)
                    depth_of[cn] = depth_of[c] + 1
                    queue.append(cn)
        return {
            "machine": self.name,
            "states_explored": len(seen),
            "transitions": transitions,
            "max_depth_reached": max(depth_of.values(), default=0),
            "truncated": truncated,
            "violations": violations,
            "invariants": {
                i: {"kind": k, "statement": d,
                    "exercised": self._exercised[i]}
                for i, k, d in self.invariants
            },
        }


# ---------------------------------------------------------------------------
# drain: verdict sequences × hold/grace/confirm knobs (obs/drain.py)
# ---------------------------------------------------------------------------

class DrainMachine(MachineBase):
    """Product of :func:`drain_transition` (per-lane state × every
    verdict assignment per barrier) and :func:`apply_quarantine` (the
    share mask checked at every reachable state).

    ``transition``/``masker`` are injectable seams so the test suite's
    deliberately-broken fixture machines produce counterexamples for
    every declared invariant."""

    name = "drain"
    checks = ("availability-floor", "share-conservation",
              "quarantine-masked", "action-visibility",
              "eventual-readmission", "no-silent-flap")

    VERDICTS = ("ok", "suspect", "degraded")

    def __init__(self, lanes: int = 3, hold_barriers: int = 2,
                 confirm_clear: int = 2, probe_grace: int = 2,
                 step: int = 4, transition=None, masker=None):
        from ..obs import drain as D

        self.invariants = D.MODEL_INVARIANTS
        super().__init__()
        self.D = D
        self.lanes = int(lanes)
        self.hold_barriers = int(hold_barriers)
        self.confirm_clear = int(confirm_clear)
        self.probe_grace = int(probe_grace)
        self.step = int(step)
        # a realistic raw table: step-quantized equal split (the shape
        # Cores._ranges_for masks — non-step tables are unreachable)
        self.raw = [2 * self.step] * self.lanes
        self.transition = transition or D.drain_transition
        self.masker = masker or D.apply_quarantine

    def initial_states(self):
        return [tuple((self.D.LANE_ACTIVE, 0, 0)
                      for _ in range(self.lanes))]

    def canon(self, state):
        # quotient dead variables: hold/streak are overwritten on every
        # entry into the states that read them, so an active lane's
        # residues cannot affect any future transition
        out = []
        for st, hold, streak in state:
            if st == self.D.LANE_ACTIVE:
                out.append((st, 0, 0))
            elif st == self.D.LANE_QUARANTINED:
                out.append((st, hold, 0))
            else:
                out.append((st, hold, streak))
        return tuple(out)

    def state_doc(self, state):
        return {
            "lanes": {
                str(i): {"state": st, "hold": hold, "streak": streak}
                for i, (st, hold, streak) in enumerate(state)
            },
        }

    # -- the transition -------------------------------------------------------
    def _dicts(self, state):
        states = {str(i): st for i, (st, _h, _s) in enumerate(state)}
        hold = {str(i): h for i, (_st, h, _s) in enumerate(state)}
        streak = {str(i): s for i, (_st, _h, s) in enumerate(state)}
        return states, hold, streak

    def _step(self, state, verdicts: dict):
        """One barrier under ``verdicts``: run the transition, build
        the decision rows the live ``DrainController.evaluate`` site
        records (same schema; a pure-tick barrier gets one row too so
        every counterexample edge replays)."""
        states, hold, streak = self._dicts(state)
        inputs = {
            "verdicts": dict(verdicts), "states": dict(states),
            "hold": dict(hold), "clear_streak": dict(streak),
            "hold_barriers": self.hold_barriers,
            "confirm_clear": self.confirm_clear,
            "probe_grace": self.probe_grace,
        }
        res = self.transition(
            verdicts, states, hold, streak, self.hold_barriers,
            self.confirm_clear, probe_grace=self.probe_grace)
        rows = []
        kinds = (["drain-apply"] if res["drained"] else []) + \
            (["readmit"] if res["readmitted"] else [])
        for kind in (kinds or ["drain-apply"]):
            rows.append({"kind": kind, "inputs": dict(inputs),
                         "outputs": res})
        nxt = tuple(
            (res["states"].get(str(i), self.D.LANE_ACTIVE),
             int(res["hold"].get(str(i), 0)),
             int(res["clear_streak"].get(str(i), 0)))
            for i in range(self.lanes))
        return res, rows, nxt

    def actions(self, state):
        out = []
        n = self.lanes
        combo = [0] * n
        while True:
            verdicts = {str(i): self.VERDICTS[combo[i]]
                        for i in range(n)}
            _res, rows, nxt = self._step(state, verdicts)
            out.append((f"verdicts={','.join(verdicts.values())}",
                        rows, nxt))
            i = 0
            while i < n:
                combo[i] += 1
                if combo[i] < len(self.VERDICTS):
                    break
                combo[i] = 0
                i += 1
            if i == n:
                return out

    # -- invariants -----------------------------------------------------------
    def _sets(self, state):
        drained = {i for i, (st, _h, _s) in enumerate(state)
                   if st == self.D.LANE_QUARANTINED}
        probation = {i for i, (st, _h, _s) in enumerate(state)
                     if st == self.D.LANE_PROBATION}
        return drained, probation

    def check_state(self, state):
        bad = []
        drained, probation = self._sets(state)
        self._hit("availability-floor")
        if len(drained) + len(probation) >= self.lanes:
            bad.append((
                "availability-floor",
                f"no active lane left: {len(drained)} quarantined + "
                f"{len(probation)} probation of {self.lanes}"))
        masked = self.masker(list(self.raw), self.step, drained,
                             probation)
        self._hit("share-conservation")
        if sum(masked) != sum(self.raw):
            bad.append((
                "share-conservation",
                f"masked table {masked} sums to {sum(masked)}, raw "
                f"total is {sum(self.raw)} (mask leaked share)"))
        # the mask contract only binds while an active lane exists (the
        # no-active state is itself an availability-floor violation)
        if len(drained) + len(probation) < self.lanes:
            self._hit("quarantine-masked")
            for i in drained:
                if masked[i] != 0:
                    bad.append((
                        "quarantine-masked",
                        f"quarantined lane {i} holds {masked[i]} "
                        "items, expected 0"))
            for i in probation:
                if masked[i] != self.step:
                    bad.append((
                        "quarantine-masked",
                        f"probation lane {i} holds {masked[i]} items, "
                        f"expected exactly one step ({self.step})"))
        return bad

    def check_action(self, state, label, rows, nxt):
        bad = []
        self._hit("action-visibility")
        res = rows[0]["outputs"]
        acted = set(res["drained"]) | set(res["readmitted"]) | \
            set(res["probed"])
        for i in range(self.lanes):
            if state[i][0] != nxt[i][0] and str(i) not in acted:
                bad.append((
                    "action-visibility",
                    f"lane {i} moved {state[i][0]} -> {nxt[i][0]} "
                    f"under {label} without appearing in any action "
                    "list (silent transition)"))
        return bad

    def check_liveness(self, state):
        """Fairness schedule: the lane genuinely recovered — drive
        all-ok verdicts and demand (a) full readmission within
        hold + confirm + 1 barriers, (b) zero drain actions on the
        way (an all-ok barrier that drains is silent flapping)."""
        if all(st == self.D.LANE_ACTIVE for st, _h, _s in state):
            return []
        bad = []
        # the probe runs EXACTLY the declared bound — any slack here
        # would let a regression that slips one extra barrier past the
        # MODEL_INVARIANTS statement go unflagged (worst reachable
        # chain today: hold + confirm barriers, strictly inside it)
        bound = self.hold_barriers + self.confirm_clear + 1
        ok = {str(i): "ok" for i in range(self.lanes)}
        cur = state
        extra: list[dict] = []
        drained_on_ok = None
        for _ in range(bound):
            res, rows, cur = self._step(cur, ok)
            extra.extend(rows)
            if res["drained"] and drained_on_ok is None:
                drained_on_ok = list(res["drained"])
            if all(st == self.D.LANE_ACTIVE for st, _h, _s in cur):
                break
        self._hit("no-silent-flap")
        if drained_on_ok is not None:
            bad.append((
                "no-silent-flap",
                f"lanes {drained_on_ok} were re-drained on an all-ok "
                "barrier (flap without degraded evidence)", extra))
        self._hit("eventual-readmission")
        stuck = [i for i, (st, _h, _s) in enumerate(cur)
                 if st != self.D.LANE_ACTIVE]
        if stuck:
            bad.append((
                "eventual-readmission",
                f"lanes {stuck} still not active after {bound} "
                f"all-ok barriers (the declared bound: hold "
                f"{self.hold_barriers} + confirm {self.confirm_clear} "
                "+ 1)", extra))
        return bad



# ---------------------------------------------------------------------------
# elastic: leave/join/timeout interleavings × epoch (cluster/elastic.py)
# ---------------------------------------------------------------------------

class ElasticMachine(MachineBase):
    """Every roster→roster reconciliation over a small member alphabet
    (ids chosen to exercise the length-then-lex order), driving a REAL
    :class:`~..cluster.elastic.Membership` under the decision log's
    scratch-ring capture — the checked rows are the records the live
    site emitted, not a re-model."""

    name = "elastic"
    checks = ("epoch-monotone", "resplit-conservation",
              "resplit-quantized", "sync-converges",
              "deterministic-order")

    def __init__(self, member_ids=("p0", "p2", "p10"),
                 steps=(2, 3), total: int = 12, membership_cls=None):
        from ..cluster import elastic as E

        self.invariants = E.MODEL_INVARIANTS
        super().__init__()
        self.E = E
        self.member_ids = tuple(member_ids)
        self.steps = tuple(int(s) for s in steps)
        self.total = int(total)
        self.membership_cls = membership_cls or E.Membership

    def _rosters(self):
        out = []

        def rec(i, cur):
            if i == len(self.member_ids):
                if cur:
                    out.append(tuple(sorted(cur.items())))
                return
            rec(i + 1, cur)
            for s in self.steps:
                nxt = dict(cur)
                nxt[self.member_ids[i]] = s
                rec(i + 1, nxt)

        rec(0, {})
        return out

    def initial_states(self):
        return self._rosters()

    def state_doc(self, state):
        return {"roster": {m: s for m, s in state}}

    def _drive(self, current: dict, target: dict):
        """establish(current) → sync(target): the captured rows and
        the post-sync snapshot."""
        m = self.membership_cls()
        m.establish(dict(current))
        mark = _last_seq()
        m.sync(dict(target), total=self.total)
        return _harvest(mark), m.snapshot()

    def actions(self, state):
        current = dict(state)
        out = []
        for target_t in self._rosters():
            target = dict(target_t)
            if target == current:
                continue
            rows, _snap = self._drive(current, target)
            out.append((f"sync->{target}", rows, target_t))
        return out

    def check_action(self, state, label, rows, nxt):
        bad = []
        current, target = dict(state), dict(nxt)
        # sync-converges: re-drive (BFS may have harvested rows from a
        # prior expansion) and compare the realized roster
        rows2, snap = self._drive(current, target)
        self._hit("sync-converges")
        if snap["members"] != target:
            bad.append((
                "sync-converges",
                f"sync({target}) from {current} left the roster at "
                f"{snap['members']}"))
        seen_join = False
        for r in rows:
            if r["kind"] == "member-join":
                seen_join = True
            elif r["kind"] == "member-leave" and seen_join:
                bad.append((
                    "sync-converges",
                    "a departure was recorded AFTER an arrival — the "
                    "leaves-then-joins order is the re-split safety "
                    "contract"))
                break
        # deterministic-order: the same diff replayed twice must
        # record the identical transition sequence
        self._hit("deterministic-order")
        sig = [(r["kind"], r["inputs"].get("member")) for r in rows]
        sig2 = [(r["kind"], r["inputs"].get("member")) for r in rows2]
        if sig != sig2:
            bad.append((
                "deterministic-order",
                f"two drives of the same diff recorded {sig} then "
                f"{sig2}"))
        # epoch-monotone: +1 per transition, chained
        self._hit("epoch-monotone")
        prev_after = None
        for r in rows:
            before = r["inputs"].get("epoch_before")
            after = r["outputs"].get("epoch_after")
            if after != (before or 0) + 1:
                bad.append((
                    "epoch-monotone",
                    f"{r['kind']}({r['inputs'].get('member')}) moved "
                    f"epoch {before} -> {after} (must bump by exactly "
                    "one)"))
            if prev_after is not None and before != prev_after:
                bad.append((
                    "epoch-monotone",
                    f"epoch chain broke: record started at {before} "
                    f"after the previous ended at {prev_after}"))
            prev_after = after
        # resplit conservation + quantization on every record that
        # carried a total
        self._hit("resplit-conservation")
        self._hit("resplit-quantized")
        for r in rows:
            ranges = r["outputs"].get("ranges")
            if ranges is None:
                continue
            lcm = int(r["outputs"].get("lcm", 1))
            if sum(ranges) != self.total:
                bad.append((
                    "resplit-conservation",
                    f"{r['kind']} re-split {ranges} sums to "
                    f"{sum(ranges)}, total is {self.total}"))
            for i, v in enumerate(ranges):
                if v < 0 or (i > 0 and v % lcm != 0):
                    bad.append((
                        "resplit-quantized",
                        f"{r['kind']} member {i} share {v} is not a "
                        f"non-negative LCM({lcm}) multiple"))
        return bad


# ---------------------------------------------------------------------------
# router: roster × health-view interleavings (serve/fabric.py)
# ---------------------------------------------------------------------------

class RouterMachine(MachineBase):
    """Every (roster subset × unhealthy subset) over a small member
    alphabet, driving a REAL :class:`~..serve.fabric.ShardRouter` over
    a real :class:`~..cluster.elastic.Membership` for a fixed key set
    at every transition — the checked rows are the ``route`` records
    the live site emitted, not a re-model.

    ``route`` is the injectable placement seam (the pure
    ``route_decision`` by default) so the test suite's deliberately-
    broken fixtures produce counterexamples for every declared
    invariant: a flip-flopping fn breaks placement-deterministic, a
    modulo (non-consistent) hash breaks minimal-reshuffle, a fixed
    off-roster target breaks routes-to-members, a silent diverter
    breaks diversion-named."""

    name = "router"
    checks = ("placement-deterministic", "minimal-reshuffle",
              "routes-to-members", "diversion-named")

    #: the fixed (tenant, key) probe set — few enough that every edge
    #: stays cheap, spread enough that a 3-member ring places them on
    #: more than one owner
    KEYS = (("tA", "k1"), ("tA", "k2"), ("tB", "k1"), ("tB", "k3"),
            ("tC", "k4"))

    def __init__(self, member_ids=("p0", "p2", "p10"), route=None,
                 keys=None):
        from ..serve import fabric as F

        self.invariants = F.MODEL_INVARIANTS
        super().__init__()
        self.F = F
        self.member_ids = tuple(member_ids)
        self.route_fn = route  # None = ShardRouter's real pure default
        if keys is not None:
            self.KEYS = tuple(keys)

    def initial_states(self):
        # every non-empty roster, all-healthy (empty rosters and sick
        # shards are reached through leave/mark edges)
        ids = self.member_ids
        out = []
        for mask in range(1, 1 << len(ids)):
            roster = tuple(
                ids[i] for i in range(len(ids)) if mask >> i & 1)
            out.append((roster, ()))
        return out

    def state_doc(self, state):
        return {"roster": list(state[0]), "unhealthy": list(state[1])}

    def _drive(self, roster, unhealthy):
        """Route every probe key through a real router at this
        roster/health view; returns ``(outs, rows)`` — the verdicts by
        key and the harvested ``route`` records."""
        from ..cluster.elastic import Membership

        m = Membership()
        m.establish({mm: 1 for mm in roster})
        router = self.F.ShardRouter(m, route=self.route_fn)
        for u in unhealthy:
            router.mark(u)
        mark = _last_seq()
        outs = {}
        for tenant, key in self.KEYS:
            outs[(tenant, key)] = router.route(tenant, key)
        return outs, _harvest(mark)

    def actions(self, state):
        roster, unhealthy = state
        rset, uset = set(roster), set(unhealthy)
        edges = []
        for m in self.member_ids:
            if m in rset:
                edges.append((
                    f"leave:{m}",
                    (tuple(x for x in roster if x != m),
                     tuple(x for x in unhealthy if x != m))))
                if m not in uset:
                    edges.append((
                        f"mark:{m}",
                        (roster, tuple(sorted(uset | {m})))))
            else:
                edges.append((f"join:{m}",
                              (tuple(sorted(rset | {m})), unhealthy)))
            if m in uset:
                edges.append((
                    f"clear:{m}",
                    (roster, tuple(x for x in unhealthy if x != m))))
        out = []
        for label, nxt in edges:
            _outs, rows = self._drive(*nxt)
            out.append((label, rows, nxt))
        return out

    def check_action(self, state, label, rows, nxt):
        bad = []
        F = self.F
        route_fn = self.route_fn or F.route_decision
        outs2, rows2 = self._drive(*nxt)
        # placement-deterministic: the same (roster, health view)
        # driven twice records bit-identical verdicts, and every
        # recorded output re-derives from its recorded inputs (the
        # ckreplay contract, checked in the explorer)
        self._hit("placement-deterministic")
        sig = [(r["inputs"]["tenant"], r["inputs"]["key"],
                r["outputs"]) for r in rows]
        sig2 = [(r["inputs"]["tenant"], r["inputs"]["key"],
                 r["outputs"]) for r in rows2]
        if sig != sig2:
            bad.append((
                "placement-deterministic",
                f"two drives of {nxt} recorded different placements"))
        for r in rows:
            inp, outp = r["inputs"], r["outputs"]
            re = route_fn(inp["tenant"], inp["key"],
                          list(inp["members"]),
                          tuple(inp["unhealthy"]),
                          int(inp["epoch"]))
            if dict(re) != dict(outp):
                bad.append((
                    "placement-deterministic",
                    f"route({inp['tenant']},{inp['key']}) recorded "
                    f"{outp} but re-derives to {re}"))
        # routes-to-members: never a non-member target; a refusal only
        # with no healthy member, and then with the named reason
        self._hit("routes-to-members")
        for r in rows:
            inp, o = r["inputs"], r["outputs"]
            members = set(inp["members"])
            healthy = members - set(inp["unhealthy"])
            shard = o.get("shard")
            if shard is None:
                if o.get("reason") != F.REJECT_SHARD:
                    bad.append((
                        "routes-to-members",
                        f"refusal without the named {F.REJECT_SHARD} "
                        f"reason (got {o.get('reason')!r})"))
                if healthy:
                    bad.append((
                        "routes-to-members",
                        f"refused while healthy members {sorted(healthy)} "
                        "existed"))
            elif shard not in members:
                bad.append((
                    "routes-to-members",
                    f"routed to {shard!r}, not in the epoch's roster "
                    f"{sorted(members)}"))
        # diversion-named: off-owner placement is flagged with hops,
        # and a healthy owner is never diverted away from
        self._hit("diversion-named")
        for r in rows:
            inp, o = r["inputs"], r["outputs"]
            if o.get("shard") is None:
                continue
            if o["shard"] != o.get("owner"):
                if not o.get("diverted") or int(o.get("hops") or 0) < 1:
                    bad.append((
                        "diversion-named",
                        f"route landed on {o['shard']} away from owner "
                        f"{o.get('owner')} without the diverted flag / "
                        "hop count — a silent diversion"))
                if o.get("owner") not in set(inp["unhealthy"]):
                    bad.append((
                        "diversion-named",
                        f"diverted away from HEALTHY owner "
                        f"{o.get('owner')}"))
            elif o.get("diverted"):
                bad.append((
                    "diversion-named",
                    "owner placement flagged as diverted"))
        # minimal-reshuffle on membership edges: a key's ring OWNER
        # (health-blind) may move only when the departed member owned
        # it (leave) or the joiner captured it (join)
        kind, _, member = label.partition(":")
        if kind in ("leave", "join"):
            self._hit("minimal-reshuffle")
            before, _r = self._drive(*state)
            for k in self.KEYS:
                ob = before[k].get("owner")
                oa = outs2[k].get("owner")
                if ob == oa:
                    continue
                if kind == "leave" and ob != member:
                    bad.append((
                        "minimal-reshuffle",
                        f"leave({member}) moved key {k} owned by "
                        f"{ob} (to {oa}) — only the departed member's "
                        "keys may move"))
                if kind == "join" and oa != member:
                    bad.append((
                        "minimal-reshuffle",
                        f"join({member}) moved key {k} from {ob} to "
                        f"{oa} — only keys the joiner captures may "
                        "move"))
        return bad


# ---------------------------------------------------------------------------
# serve: admission (tenants × queue × health) — serve/admission.py
# ---------------------------------------------------------------------------

class AdmissionMachine(MachineBase):
    """Product of per-tenant in-flight counts × queue depth × health /
    breaker / brownout flips, driving
    :func:`~..serve.admission.admit_decision` at every submit with the
    frontend's own accounting (admit → in-flight+1 and queue+1;
    dispatch → queue−1; complete → in-flight−1)."""

    name = "serve/admission"
    checks = ("quota-exact", "queue-bounded", "reject-order",
              "retry-hint", "admit-iff")

    EST_BATCH = (0.0, 0.1)  # 0.0 exercises the retry-after floor

    def __init__(self, tenants=("a", "b", "c"), quota: int = 3,
                 max_queue_depth: int = 4, decide=None):
        from ..serve import admission as A

        self.invariants = A.MODEL_INVARIANTS
        super().__init__()
        self.A = A
        self.tenants = tuple(tenants)
        self.quota = int(quota)
        self.shed_quota = A.brownout_share(quota)
        self.max_queue_depth = int(max_queue_depth)
        self.decide = decide or A.admit_decision

    def initial_states(self):
        return [(tuple(0 for _ in self.tenants), 0, True, False, False)]

    def state_doc(self, state):
        inflight, queue, healthy, breaker, brownout = state
        return {
            "inflight": {t: n for t, n in zip(self.tenants, inflight)},
            "queue_depth": queue,
            "healthy": healthy,
            "breaker_open": breaker,
            "brownout": brownout,
        }

    def _submit(self, state, ti: int, est: float, unsafe: bool):
        inflight, queue, healthy, breaker, brownout = state
        dec = self.decide(
            tenant_inflight=inflight[ti], quota=self.quota,
            queue_depth=queue, max_queue_depth=self.max_queue_depth,
            healthy=healthy, est_batch_s=est, kernel_unsafe=unsafe,
            kernel_finding="scatter-write" if unsafe else None,
            breaker_open=breaker, breaker_retry_after_s=0.25,
            brownout=brownout, shed_quota=self.shed_quota, priority=1)
        row = {"kind": "admission", "inputs": {
            "tenant": self.tenants[ti],
            "tenant_inflight": inflight[ti],
            "quota": self.quota,
            "queue_depth": queue,
            "max_queue_depth": self.max_queue_depth,
            "healthy": healthy,
            "est_batch_s": est,
            "kernel_unsafe": unsafe,
            "kernel_finding": "scatter-write" if unsafe else None,
            "breaker_open": breaker,
            "breaker_retry_after_s": 0.25,
            "brownout": brownout,
            "shed_quota": self.shed_quota,
            "priority": 1,
        }, "outputs": dict(dec)}
        if dec.get("admit"):
            inflight = tuple(
                n + 1 if i == ti else n for i, n in enumerate(inflight))
            queue += 1
        return dec, row, (inflight, queue, healthy, breaker, brownout)

    def actions(self, state):
        inflight, queue, healthy, breaker, brownout = state
        out = []
        for ti in range(len(self.tenants)):
            for est in self.EST_BATCH:
                dec, row, nxt = self._submit(state, ti, est, False)
                out.append((f"submit({self.tenants[ti]},est={est})",
                            [row], nxt))
        # a kernel-verifier-refuted job (strict gate at the frontend)
        dec, row, nxt = self._submit(state, 0, 0.1, True)
        out.append(("submit(a,unsafe)", [row], nxt))
        if queue > 0:
            out.append(("dispatch", [],
                        (inflight, queue - 1, healthy, breaker,
                         brownout)))
        for ti, n in enumerate(inflight):
            if n > 0:
                nf = tuple(v - 1 if i == ti else v
                           for i, v in enumerate(inflight))
                out.append((f"complete({self.tenants[ti]})", [],
                            (nf, queue, healthy, breaker, brownout)))
        out.append(("health-flip", [],
                    (inflight, queue, not healthy, breaker, brownout)))
        out.append(("breaker-flip", [],
                    (inflight, queue, healthy, not breaker, brownout)))
        out.append(("brownout-flip", [],
                    (inflight, queue, healthy, breaker, not brownout)))
        return out

    def check_state(self, state):
        inflight, queue, _healthy, _breaker, _brownout = state
        bad = []
        self._hit("quota-exact")
        for t, n in zip(self.tenants, inflight):
            if n > self.quota:
                bad.append((
                    "quota-exact",
                    f"tenant {t} reached {n} in-flight with quota "
                    f"{self.quota}"))
        self._hit("queue-bounded")
        if queue > self.max_queue_depth:
            bad.append((
                "queue-bounded",
                f"queue depth {queue} exceeds the bound "
                f"{self.max_queue_depth}"))
        return bad

    def check_action(self, state, label, rows, nxt):
        if not rows:
            return []
        bad = []
        inp, out = rows[0]["inputs"], rows[0]["outputs"]
        unsafe, healthy = inp["kernel_unsafe"], inp["healthy"]
        queue_full = inp["queue_depth"] >= inp["max_queue_depth"]
        over_quota = inp["tenant_inflight"] >= inp["quota"]
        shed = (inp["brownout"]
                and inp["tenant_inflight"] >= inp["shed_quota"])
        expected = (
            self.A.REJECT_KERNEL if unsafe else
            self.A.REJECT_HEALTH if not healthy else
            self.A.REJECT_BREAKER if inp["breaker_open"] else
            self.A.REJECT_QUEUE if queue_full else
            self.A.REJECT_BROWNOUT if shed else
            self.A.REJECT_QUOTA if over_quota else None)
        self._hit("admit-iff")
        if out.get("admit") != (expected is None):
            bad.append((
                "admit-iff",
                f"{label}: admit={out.get('admit')} but the gates say "
                f"{'admit' if expected is None else 'reject'}"))
        self._hit("reject-order")
        if out.get("reason") != expected:
            bad.append((
                "reject-order",
                f"{label}: reason {out.get('reason')!r}, first failing "
                f"gate is {expected!r}"))
        self._hit("retry-hint")
        retry = out.get("retry_after_s")
        if out.get("admit"):
            if retry is not None:
                bad.append(("retry-hint",
                            f"{label}: admitted with retry hint {retry}"))
        elif out.get("reason") == self.A.REJECT_KERNEL:
            if retry != 0.0:
                bad.append((
                    "retry-hint",
                    f"{label}: kernel-unsafe retry hint {retry}, must "
                    "be exactly 0.0"))
        elif retry is None or retry < self.A._RETRY_FLOOR_S:
            bad.append((
                "retry-hint",
                f"{label}: rejection carries retry hint {retry} below "
                f"the floor {self.A._RETRY_FLOOR_S}"))
        return bad


# ---------------------------------------------------------------------------
# serve: coalesce (groups × deadlines × starvation) — serve/coalescer.py
# ---------------------------------------------------------------------------

class CoalesceMachine(MachineBase):
    """Every arrival/desertion/deadline interleaving over a small
    group alphabet, with the dispatcher's own starvation bookkeeping
    (``ServeFrontend._dispatch_cycle``: picked → streak 0, unpicked
    pending → +1, empty group leaves the table), checked against the
    capacity-aware starvation bound."""

    name = "serve/coalesce"
    checks = ("promoted-are-starved", "plan-complete",
              "plan-deterministic", "bounded-starvation")

    #: fixed per-key ages/deadlines: the EDF and age tie-breaks are
    #: exercised without making time part of the state
    AGES = {"ga": 3.0, "gb": 2.0, "gc": 1.0}
    DEADLINES = {"ga": 2.5, "gb": 0.5, "gc": 1.5}

    def __init__(self, keys=("ga", "gb", "gc"), max_picks: int = 1,
                 starve_cap_extra: int = 2, plan=None):
        from ..serve import coalescer as C

        self.invariants = C.MODEL_INVARIANTS
        super().__init__()
        self.C = C
        self.keys = tuple(keys)
        self.max_picks = int(max_picks)
        self.plan = plan or C.plan_coalesce
        # one CLI machine runs several CoalesceMachine configs —
        # per-instance names keep their reports from colliding in
        # check_machine's sub_machines map
        self.name = f"serve/coalesce(mp={self.max_picks})"
        # the declared capacity-aware bound (see MODEL_INVARIANTS)
        g = len(self.keys)
        self.bound = (C.STARVE_ROUNDS if self.max_picks >= g - 1
                      else C.STARVE_ROUNDS + (g - 1))
        # explore a little past the bound so a broken planner shows a
        # growing streak instead of an unbounded frontier
        self.starve_cap = self.bound + int(starve_cap_extra)
        # round_idx only matters modulo the streak size; lcm(1..g)
        self.round_mod = 1
        for k in range(1, g + 1):
            self.round_mod = self.round_mod * k // math.gcd(
                self.round_mod, k)

    def initial_states(self):
        # (per-group starved or None when absent, round)
        return [(tuple(0 for _ in self.keys), 0)]

    def canon(self, state):
        starved, rnd = state
        return starved, rnd % self.round_mod

    def state_doc(self, state):
        starved, rnd = state
        return {
            "groups": {k: ("absent" if s is None else {"starved": s})
                       for k, s in zip(self.keys, starved)},
            "round": rnd % self.round_mod,
            "max_picks": self.max_picks,
        }

    def _summary(self, starved, deadlines: bool):
        rows = []
        for k, s in zip(self.keys, starved):
            if s is None:
                continue
            rows.append({
                "key": k, "pending": 1,
                "deadline_in_s": self.DEADLINES[k] if deadlines else None,
                "oldest_age_s": self.AGES[k],
                "starved_rounds": s,
            })
        rows.sort(key=lambda r: r["key"])
        return rows

    def actions(self, state):
        starved, rnd = state
        rnd = rnd % self.round_mod
        out = []
        n = len(self.keys)
        for mask in range(1, 1 << n):
            # presence pattern this cycle: arrivals start at streak 0,
            # deserters leave the table (streak forgotten — the
            # frontend's empty-group rule)
            present = tuple(
                (starved[i] if starved[i] is not None else 0)
                if mask & (1 << i) else None
                for i in range(n))
            for deadlines in (False, True):
                summary = self._summary(present, deadlines)
                plan = self.plan(summary, rnd, self.max_picks)
                row = {"kind": "coalesce", "inputs": {
                    "groups": summary, "round": rnd,
                    "max_picks": self.max_picks,
                }, "outputs": dict(plan)}
                picked = set(plan.get("picked") or ())
                nxt = tuple(
                    None if present[i] is None else
                    (0 if self.keys[i] in picked
                     else min(present[i] + 1, self.starve_cap + 1))
                    for i in range(n))
                out.append((
                    f"cycle(mask={mask:03b},edf={deadlines})",
                    [row], (nxt, (rnd + 1) % self.round_mod)))
        return out

    def check_state(self, state):
        starved, _rnd = state
        bad = []
        self._hit("bounded-starvation")
        for k, s in zip(self.keys, starved):
            if s is not None and s > self.bound:
                bad.append((
                    "bounded-starvation",
                    f"group {k} starved {s} consecutive cycles "
                    f"(bound {self.bound} at max_picks="
                    f"{self.max_picks} over {len(self.keys)} groups)"))
        return bad

    def check_action(self, state, label, rows, nxt):
        bad = []
        inp, out = rows[0]["inputs"], rows[0]["outputs"]
        pending_keys = {r["key"] for r in inp["groups"]}
        order = list(out.get("order") or ())
        picked = list(out.get("picked") or ())
        promoted = list(out.get("promoted") or ())
        self._hit("plan-complete")
        if sorted(order) != sorted(pending_keys):
            bad.append((
                "plan-complete",
                f"{label}: order {order} is not a permutation of the "
                f"pending groups {sorted(pending_keys)}"))
        want = order[:self.max_picks] if self.max_picks > 0 else order
        if picked != want:
            bad.append((
                "plan-complete",
                f"{label}: picked {picked} is not the max_picks prefix "
                f"{want}"))
        self._hit("promoted-are-starved")
        streak = {r["key"] for r in inp["groups"]
                  if r["starved_rounds"] >= self.C.STARVE_ROUNDS}
        extra = [k for k in promoted if k not in streak]
        if extra:
            bad.append((
                "promoted-are-starved",
                f"{label}: promoted {extra} without a "
                f"{self.C.STARVE_ROUNDS}-round starve streak"))
        self._hit("plan-deterministic")
        again = self.plan(
            [dict(r) for r in inp["groups"]], inp["round"],
            inp["max_picks"])
        if again != out:
            bad.append((
                "plan-deterministic",
                f"{label}: replanning the same snapshot changed the "
                "plan"))
        return bad



# ---------------------------------------------------------------------------
# balance: freeze/jump over rate-consistent trajectories (core/balance.py)
# ---------------------------------------------------------------------------

class BalanceMachine(MachineBase):
    """Deterministic :func:`~..core.balance.load_balance` trajectories
    over a quantized per-item rate alphabet × knob grid, each run to an
    exact fixpoint, a limit cycle (a "converges" violation — revisiting
    a non-fixpoint canonical state in a deterministic system is a
    proof of divergence), or the horizon.  Rate-consistent feedback is
    the whatif simulator's own model: ``bench_i = rate_i ·
    max(range_i, step)``.  Records are the REAL ``load-balance``
    decisions the live emission site produced under capture — a
    counterexample trace renders in ``ckreplay explain`` and replays
    in ``ckreplay verify`` with no translation.

    The ``prior`` knob seeds a trajectory's first split from
    ``prior_split`` with effective-rate-true priors (the transfer floor
    folded in, exactly the information the floor hands the balancer)
    instead of the equal split, and the rate alphabet carries a
    100x-skew kind pair — the TPU-vs-host-CPU shape.  The
    ``prior-seeded-jump-within-one-step`` invariant then demands every
    prior-seeded iteration stay within one quantization step of the
    rate-implied split: the seed is already right, so no re-shard
    churn is ever legal."""

    name = "balance"
    checks = ("range-conservation", "range-quantized", "jump-one-shot",
              "freeze-legal", "converges",
              "prior-seeded-jump-within-one-step")

    #: Consecutive no-move iterations that close a trajectory as
    #: converged — the observable-decision settle rule (the whatif
    #: simulator's SETTLE).  The hidden continuous state approaches
    #: its own fixpoint only asymptotically (cont/prev_delta shrink
    #: geometrically), so exact-state repetition is NOT the
    #: convergence criterion; stable ranges are.
    SETTLE = 6

    def __init__(self, rate_alphabet=(1.0, 2.0, 5.0, 8.0, 100.0),
                 lane_counts=(2, 3), total: int = 3072, step: int = 128,
                 horizon: int = 48, balance=None, seeder=None):
        from ..core import balance as B

        self.invariants = B.MODEL_INVARIANTS
        super().__init__()
        self.B = B
        self.rates = tuple(float(r) for r in rate_alphabet)
        self.lane_counts = tuple(int(n) for n in lane_counts)
        self.total = int(total)
        self.step = int(step)
        self.horizon = int(horizon)
        self.balance = balance or B.load_balance
        #: the prior-on first-split function (the broken-fixture seam:
        #: an equal-split seeder is "prior seeding filed off")
        self.seeder = seeder or B.prior_split
        # one CLI machine runs one BalanceMachine per lane-count band
        # at tier-1 — per-instance names keep their reports from
        # colliding in check_machine's sub_machines map
        self.name = "balance(lanes={})".format(
            ",".join(str(n) for n in self.lane_counts))

    def configs(self):
        out = []
        for n in self.lane_counts:
            combos = [[]]
            for _ in range(n):
                combos = [c + [r] for c in combos for r in self.rates]
            for rates in combos:
                for jump in (False, True):
                    for smooth in (False, True):
                        for floor in (False, True):
                            for prior in (False, True):
                                out.append({
                                    "rates": tuple(rates), "jump": jump,
                                    "smooth": smooth, "floor": floor,
                                    "prior": prior,
                                })
        return out

    def _densities(self, cfg):
        """Effective per-item cost densities: the transfer floor
        doubles lane 0's density (its link is 2x its compute in this
        model), so prior/implied math sees the same wall the balancer
        does."""
        return [cfg["rates"][i] * (2.0 if cfg["floor"] and i == 0
                                   else 1.0)
                for i in range(len(cfg["rates"]))]

    def _benches(self, cfg, ranges):
        return [cfg["rates"][i] * max(ranges[i], self.step)
                for i in range(len(ranges))]

    def _transfer(self, cfg, ranges):
        if not cfg["floor"]:
            return None
        # lane 0's link is 2x slower than its compute: the floor binds
        t = [0.0] * len(ranges)
        t[0] = 2.0 * cfg["rates"][0] * max(ranges[0], self.step)
        return t

    def _canon(self, cfg_idx, ranges, state, hist):
        return (
            cfg_idx, tuple(ranges), tuple(state.cont),
            tuple(state.prev_delta), tuple(state.damp),
            state.jumped, state.warm,
            tuple(tuple(r) for r in hist.rows) if hist else None,
        )

    def explore(self, max_depth: int = 256,
                max_states: int = 500_000) -> dict:
        B = self.B
        violations: list[ModelViolation] = []
        vio_counts: dict[str, int] = {}
        seen_total = 0
        transitions = 0
        truncated = False
        horizon = self.horizon

        def _violate(inv_id, msg, doc, trace):
            self._hit(inv_id)
            if len(violations) >= MAX_VIOLATIONS or \
                    vio_counts.get(inv_id, 0) >= PER_INVARIANT_VIOLATIONS:
                return
            vio_counts[inv_id] = vio_counts.get(inv_id, 0) + 1
            kind = next(k for i, k, _d in self.invariants
                        if i == inv_id)
            violations.append(ModelViolation(
                self.name, inv_id, kind, msg, doc, trace))

        with _captured():
            for cfg_idx, cfg in enumerate(self.configs()):
                n = len(cfg["rates"])
                trace: list[dict] = []
                dens = self._densities(cfg)
                inv_d = [1.0 / d for d in dens]
                implied = [self.total * inv_d[i] / sum(inv_d)
                           for i in range(n)]
                if cfg["prior"]:
                    mark = _last_seq()
                    ranges = self.seeder(self.total, self.step,
                                         list(inv_d), cid=cfg_idx)
                    trace.extend(_harvest(mark))
                else:
                    ranges = B.equal_split(self.total, n, self.step)
                state = B.BalanceState()
                state.reset(ranges, B.DAMPING)
                hist = (B.BalanceHistory(weighted=True)
                        if cfg["smooth"] else None)
                seen = {self._canon(cfg_idx, ranges, state, hist): 0}
                last_change = 0
                settled = False
                aborted = False
                jumps = 0
                doc = {"config": {k: (list(v) if isinstance(v, tuple)
                                      else v) for k, v in cfg.items()},
                       "total": self.total, "step": self.step}
                for it in range(1, horizon + 1):
                    transitions += 1
                    mark = _last_seq()
                    new = self.balance(
                        self._benches(cfg, ranges), list(ranges),
                        self.total, self.step, hist,
                        state=state,
                        transfer_ms=self._transfer(cfg, ranges),
                        jump_start=cfg["jump"], cid=cfg_idx,
                        rate_prior=(list(inv_d) if cfg["prior"]
                                    else None))
                    rows = _harvest(mark)
                    trace.extend(rows)
                    row = rows[-1] if rows else {"outputs": {}}
                    action = row["outputs"].get("action")
                    self._hit("range-conservation")
                    if sum(new) != self.total:
                        _violate(
                            "range-conservation",
                            f"iteration {it} ranges {new} sum to "
                            f"{sum(new)}, total is {self.total}",
                            dict(doc, ranges=list(new)), trace)
                        aborted = True
                        break
                    self._hit("range-quantized")
                    if any(r < 0 or r % self.step for r in new):
                        _violate(
                            "range-quantized",
                            f"iteration {it} ranges {new} are not "
                            f"non-negative step({self.step}) "
                            "multiples",
                            dict(doc, ranges=list(new)), trace)
                        aborted = True
                        break
                    self._hit("jump-one-shot")
                    if action == "jump":
                        jumps += 1
                    if jumps > 1 or (action == "jump" and it == 1):
                        _violate(
                            "jump-one-shot",
                            f"iteration {it} jumped "
                            + ("again after the one-shot was consumed"
                               if jumps > 1 else
                               "on first-window benches (the arming "
                               "iteration must run damped)"),
                            dict(doc, ranges=list(new)), trace)
                        aborted = True
                        break
                    self._hit("freeze-legal")
                    if action == "freeze" and (
                            list(new) != list(ranges)
                            or any(r % self.step for r in ranges)):
                        _violate(
                            "freeze-legal",
                            f"iteration {it} froze a moved or "
                            f"unaligned split {ranges} -> {new}",
                            dict(doc, ranges=list(new)), trace)
                        aborted = True
                        break
                    if cfg["prior"]:
                        self._hit("prior-seeded-jump-within-one-step")
                        off = [i for i in range(n)
                               if abs(new[i] - implied[i]) > self.step]
                        if off:
                            _violate(
                                "prior-seeded-jump-within-one-step",
                                f"iteration {it} moved lane(s) {off} "
                                f"beyond one step ({self.step}) of the "
                                f"rate-implied split "
                                f"{[round(x, 1) for x in implied]}: "
                                f"{new} (rates {cfg['rates']}, "
                                f"floor={cfg['floor']}) — the prior "
                                "seed was already right; this is the "
                                "re-shard churn it exists to prevent",
                                dict(doc, ranges=list(new)), trace)
                            aborted = True
                            break
                    if new != list(ranges):
                        last_change = it
                    ranges = new
                    c = self._canon(cfg_idx, ranges, state, hist)
                    self._hit("converges")
                    if c in seen:
                        # deterministic revisit: an exact cycle.  A
                        # cycle that moved ranges is a limit cycle —
                        # convergence is impossible; a stationary one
                        # is a (frozen) fixpoint.
                        if last_change > seen[c]:
                            _violate(
                                "converges",
                                f"limit cycle of period "
                                f"{it - seen[c]} entered at iteration "
                                f"{seen[c]} moves the split forever "
                                f"(rates {cfg['rates']})",
                                dict(doc, ranges=list(ranges)), trace)
                        settled = True
                        break
                    seen[c] = it
                    if it - last_change >= self.SETTLE:
                        settled = True  # observable decision stable
                        break
                if not settled and not aborted:
                    self._hit("converges")
                    _violate(
                        "converges",
                        f"split still moving at iteration {horizon} "
                        f"(last move: {last_change}; rates "
                        f"{cfg['rates']}, jump={cfg['jump']}, "
                        f"smooth={cfg['smooth']}, "
                        f"floor={cfg['floor']})",
                        dict(doc, ranges=list(ranges)), trace)
                    truncated = True
                seen_total += len(seen)
        return {
            "machine": self.name,
            "states_explored": seen_total,
            "transitions": transitions,
            "max_depth_reached": horizon,
            "truncated": truncated,
            "violations": violations,
            "invariants": {
                i: {"kind": k, "statement": d,
                    "exercised": self._exercised[i]}
                for i, k, d in self.invariants
            },
        }



# ---------------------------------------------------------------------------
# resilience: breaker × shed × retry (serve/resilience.py)
# ---------------------------------------------------------------------------

class BreakerMachine(MachineBase):
    """Every outcome/admit/tick interleaving of the circuit breaker
    (:func:`~..serve.resilience.breaker_transition` ×
    :func:`~..serve.resilience.breaker_admit`) over integer ticks
    (``now`` is an input to the pure functions, so the model clock is
    exact).  The model carries its own GROUND-TRUTH consecutive-failure
    counter, independent of the implementation's ``failures`` field —
    a broken transition cannot hide its own evidence."""

    name = "resilience/breaker"
    checks = ("breaker-half-open-one-probe", "breaker-opens-on-threshold",
              "breaker-honest-hint", "breaker-open-times-out",
              "breaker-recovers-on-ok")

    def __init__(self, threshold: int = 2, open_ticks: int = 3,
                 transition=None, admit=None):
        from ..serve import resilience as R

        self.invariants = R.BREAKER_INVARIANTS
        super().__init__()
        self.R = R
        self.threshold = int(threshold)
        self.open_ticks = int(open_ticks)
        self.transition = transition or R.breaker_transition
        self.admit = admit or R.breaker_admit

    def initial_states(self):
        # (real breaker state dict as a tuple, tick, ground consecutive
        # failures) — canon replaces the absolute clock with the age
        return [(self._freeze(self.R.breaker_init()), 0, 0)]

    @staticmethod
    def _freeze(st: dict) -> tuple:
        return (st["state"], int(st["failures"]),
                bool(st["probe_inflight"]),
                None if st["opened_t"] is None else float(st["opened_t"]))

    @staticmethod
    def _thaw(frozen: tuple) -> dict:
        return {"state": frozen[0], "failures": frozen[1],
                "probe_inflight": frozen[2], "opened_t": frozen[3]}

    def canon(self, state):
        frozen, tick, ground = state
        st, fails, probe, opened_t = frozen
        age = None
        if opened_t is not None:
            age = min(int(tick - opened_t), self.open_ticks + 1)
        return (st, min(fails, self.threshold), probe, age,
                min(ground, self.threshold))

    def state_doc(self, state):
        frozen, tick, ground = state
        return {"breaker": self._thaw(frozen), "tick": tick,
                "ground_consecutive_failures": ground,
                "threshold": self.threshold,
                "open_ticks": self.open_ticks}

    def _row(self, op: str, st: dict, out: dict, now: float,
             event: str | None = None) -> dict:
        inputs = {"key": "model", "state": dict(st), "now": float(now),
                  "threshold": self.threshold,
                  "open_s": float(self.open_ticks), "op": op}
        if event is not None:
            inputs["event"] = event
        outputs = {"state": dict(out["state"]),
                   "action": out.get("action")}
        if op == "admit":
            outputs.update({"allow": out["allow"], "probe": out["probe"],
                            "retry_after_s": out["retry_after_s"]})
        return {"kind": "breaker", "inputs": inputs, "outputs": outputs}

    def actions(self, state):
        frozen, tick, ground = state
        st = self._thaw(frozen)
        out = []
        for event in ("success", "failure"):
            res = self.transition(st, event, float(tick), self.threshold,
                                  float(self.open_ticks))
            if st["state"] == self.R.BREAKER_CLOSED:
                g2 = 0 if event == "success" else ground + 1
            elif st["state"] == self.R.BREAKER_HALF_OPEN:
                g2 = 0 if event == "success" else self.threshold
            else:
                g2 = ground  # stale outcome against an open breaker
            out.append((
                f"outcome-{event}",
                [self._row("transition", st, res, tick, event)],
                (self._freeze(res["state"]), tick + 1, g2)))
        adm = self.admit(st, float(tick), float(self.open_ticks))
        out.append((
            "admit",
            [self._row("admit", st, adm, tick)],
            (self._freeze(adm["state"]), tick + 1, ground)))
        return out

    def check_action(self, state, label, rows, nxt):
        frozen, tick, ground = state
        st = self._thaw(frozen)
        inp, out = rows[0]["inputs"], rows[0]["outputs"]
        bad = []
        if inp["op"] == "admit":
            self._hit("breaker-half-open-one-probe")
            if st["state"] == self.R.BREAKER_HALF_OPEN \
                    and st["probe_inflight"] and out["allow"]:
                bad.append((
                    "breaker-half-open-one-probe",
                    "half-open admitted a SECOND probe while one was "
                    "in flight"))
            self._hit("breaker-honest-hint")
            if not out["allow"]:
                hint = out["retry_after_s"]
                remaining = None
                if st["state"] == self.R.BREAKER_OPEN \
                        and st["opened_t"] is not None:
                    remaining = (float(self.open_ticks)
                                 - (tick - st["opened_t"]))
                if hint is None or hint <= 0.0 \
                        or hint > float(self.open_ticks):
                    bad.append((
                        "breaker-honest-hint",
                        f"refused admit carries hint {hint!r}, outside "
                        f"(0, open_s={self.open_ticks}]"))
                elif remaining is not None and remaining > 0.005 \
                        and abs(hint - remaining) > 1e-9:
                    bad.append((
                        "breaker-honest-hint",
                        f"open breaker hinted {hint}, the remaining "
                        f"window is {remaining}"))
        else:
            self._hit("breaker-opens-on-threshold")
            opened = out["action"] == "opened"
            if st["state"] == self.R.BREAKER_CLOSED:
                consec = (ground + 1 if inp["event"] == "failure" else 0)
                if opened and consec < self.threshold:
                    bad.append((
                        "breaker-opens-on-threshold",
                        f"opened after only {consec} consecutive "
                        f"failure(s) (threshold {self.threshold})"))
                if not opened and consec >= self.threshold:
                    bad.append((
                        "breaker-opens-on-threshold",
                        f"{consec} consecutive failures reached the "
                        f"threshold ({self.threshold}) but the breaker "
                        "stayed closed"))
        return bad

    def check_liveness(self, state):
        frozen, tick, ground = state
        st = self._thaw(frozen)
        bad = []
        if st["state"] == self.R.BREAKER_OPEN:
            # open-times-out: keep admitting; within open_ticks + 1
            # admits one must be granted as the probe
            self._hit("breaker-open-times-out")
            cur, t = dict(st), float(tick)
            extra, granted = [], False
            for _ in range(self.open_ticks + 1):
                adm = self.admit(cur, t, float(self.open_ticks))
                extra.append(self._row("admit", cur, adm, t))
                cur, t = dict(adm["state"]), t + 1
                if adm["allow"]:
                    granted = adm["probe"]
                    break
            if not granted:
                bad.append((
                    "breaker-open-times-out",
                    f"open breaker granted no probe within "
                    f"{self.open_ticks + 1} admits of opening", extra))
        if st["state"] != self.R.BREAKER_CLOSED:
            # recovers-on-ok, at EXACTLY the declared bound (slack here
            # would let a one-extra-step regression slip past the
            # MODEL_INVARIANTS statement — the drain-machine rule): an
            # all-success schedule delivers the in-flight probe's
            # success when one exists, else admits; worst reachable
            # chain = open_ticks denied admits + the probe admit + its
            # success = open_ticks + 2 steps, exactly the bound.
            self._hit("breaker-recovers-on-ok")
            bound = self.open_ticks + 2
            cur, t = dict(st), float(tick)
            extra = []
            for _ in range(bound):
                if cur["state"] == self.R.BREAKER_CLOSED:
                    break
                if cur["state"] == self.R.BREAKER_HALF_OPEN \
                        and cur["probe_inflight"]:
                    res = self.transition(
                        cur, "success", t, self.threshold,
                        float(self.open_ticks))
                    extra.append(self._row(
                        "transition", cur, res, t, "success"))
                    cur, t = dict(res["state"]), t + 1
                    continue
                adm = self.admit(cur, t, float(self.open_ticks))
                extra.append(self._row("admit", cur, adm, t))
                cur, t = dict(adm["state"]), t + 1
            if cur["state"] != self.R.BREAKER_CLOSED:
                bad.append((
                    "breaker-recovers-on-ok",
                    f"breaker still {cur['state']} after {bound} "
                    "all-success steps (the declared bound: open_s + "
                    "2; permanent open under all-ok inputs)", extra))
        return bad


class ShedMachine(MachineBase):
    """Every pressure-signal sequence through
    :func:`~..serve.resilience.brownout_transition` (queue depth ×
    open breakers × drained lanes per evaluation), plus the
    ``admit_decision`` brownout gate at every active state over
    in-flight × priority — the starvation floor is checked where the
    shed actually happens."""

    name = "resilience/shed"
    checks = ("shed-pressure-gated", "shed-quota-floor",
              "shed-named-hint", "shed-releases")

    QUEUE_LEVELS = (0, 2, 4)  # clear, at clear-mark, at watermark
    WATERMARK = 4
    CLEAR_MARK = 2

    def __init__(self, engage_streak: int = 2, quota: int = 2,
                 transition=None, decide=None):
        from ..serve import admission as A
        from ..serve import resilience as R

        self.invariants = R.SHED_INVARIANTS
        super().__init__()
        self.R, self.A = R, A
        self.engage_streak = int(engage_streak)
        self.quota = int(quota)
        self.transition = transition or R.brownout_transition
        self.decide = decide or A.admit_decision

    def initial_states(self):
        return [(False, 0)]

    def canon(self, state):
        active, streak = state
        return (bool(active), min(int(streak), self.engage_streak))

    def state_doc(self, state):
        return {"active": state[0], "streak": state[1],
                "engage_streak": self.engage_streak}

    def actions(self, state):
        active, streak = state
        out = []
        for qd in self.QUEUE_LEVELS:
            for ob in (0, 1):
                for dl in (0, 1):
                    res = self.transition(
                        {"active": active, "streak": streak}, qd,
                        self.WATERMARK, self.CLEAR_MARK, ob, dl,
                        engage_streak=self.engage_streak)
                    row = {"kind": "shed", "inputs": {
                        "state": {"active": active, "streak": streak},
                        "queue_depth": qd,
                        "watermark": self.WATERMARK,
                        "clear_mark": self.CLEAR_MARK,
                        "open_breakers": ob, "drained_lanes": dl,
                        "engage_streak": self.engage_streak,
                    }, "outputs": dict(res)}
                    out.append((
                        f"eval(qd={qd},ob={ob},dl={dl})", [row],
                        (bool(res["active"]), int(res["streak"]))))
        return out

    def check_action(self, state, label, rows, nxt):
        active, streak = state
        inp, out = rows[0]["inputs"], rows[0]["outputs"]
        bad = []
        self._hit("shed-pressure-gated")
        pressured = bool(
            inp["queue_depth"] >= inp["watermark"]
            or ((inp["open_breakers"] > 0 or inp["drained_lanes"] > 0)
                and inp["queue_depth"] >= inp["clear_mark"]))
        if out["changed"] and out["active"]:
            if not pressured or streak < self.engage_streak - 1:
                bad.append((
                    "shed-pressure-gated",
                    f"brownout engaged at streak {streak} under "
                    f"{'un' if not pressured else ''}pressured inputs "
                    f"({label}) — the {self.engage_streak}-evaluation "
                    "hysteresis was skipped"))
        return bad

    def check_state(self, state):
        active, streak = state
        bad = []
        if not active:
            return bad
        # the shed gate itself, at every active state: in-flight ×
        # priority over a clear-other-gates admit
        self._hit("shed-quota-floor")
        self._hit("shed-named-hint")
        shed_quota = self.A.brownout_share(self.quota)
        for inflight in (0, 1, self.quota):
            for priority in (0, 1):
                dec = self.decide(
                    tenant_inflight=inflight, quota=self.quota,
                    queue_depth=0, max_queue_depth=64, healthy=True,
                    est_batch_s=0.01, brownout=True,
                    shed_quota=shed_quota, priority=priority)
                if inflight == 0 and not dec["admit"]:
                    bad.append((
                        "shed-quota-floor",
                        f"brownout shed a tenant with ZERO requests in "
                        f"flight (priority {priority}) — the "
                        "starvation floor is broken"))
                if not dec["admit"]:
                    if dec["reason"] != self.A.REJECT_BROWNOUT:
                        bad.append((
                            "shed-named-hint",
                            f"brownout rejection named {dec['reason']!r}"
                            f", expected {self.A.REJECT_BROWNOUT!r}"))
                    if (dec["retry_after_s"] or 0.0) < 0.005:
                        bad.append((
                            "shed-named-hint",
                            f"brownout rejection hint "
                            f"{dec['retry_after_s']!r} is below the "
                            "anti-busy-loop floor"))
        return bad

    def check_liveness(self, state):
        active, streak = state
        if not active:
            return []
        self._hit("shed-releases")
        cur = {"active": True, "streak": int(streak)}
        extra = []
        for _ in range(self.engage_streak):
            res = self.transition(
                cur, 0, self.WATERMARK, self.CLEAR_MARK, 0, 0,
                engage_streak=self.engage_streak)
            extra.append({"kind": "shed", "inputs": {
                "state": dict(cur), "queue_depth": 0,
                "watermark": self.WATERMARK,
                "clear_mark": self.CLEAR_MARK,
                "open_breakers": 0, "drained_lanes": 0,
                "engage_streak": self.engage_streak,
            }, "outputs": dict(res)})
            cur = {"active": res["active"], "streak": res["streak"]}
            if not cur["active"]:
                return []
        return [(
            "shed-releases",
            f"brownout still active after {self.engage_streak} "
            "all-clear evaluations (sticky degraded mode)", extra)]


class RetryMachine(MachineBase):
    """Every (attempt × budget × deadline × jitter) point of
    :func:`~..serve.resilience.retry_decision`, with the budget's
    spend/refill accounting driven alongside — proves retries can
    never outrun the budget or the backoff bounds."""

    name = "resilience/retry"
    checks = ("retry-budget-bounded", "retry-backoff-bounded")

    JITTER = (0.0, 0.999)
    DEADLINES = (None, 0.001, 10.0)
    BASE_S = 0.01
    CAP_S = 0.04

    def __init__(self, max_attempts: int = 2, budget_cap: int = 2,
                 decide=None):
        from ..serve import resilience as R

        self.invariants = R.RETRY_INVARIANTS
        super().__init__()
        self.R = R
        self.max_attempts = int(max_attempts)
        self.budget_cap = int(budget_cap)
        self.decide = decide or R.retry_decision

    def initial_states(self):
        return [(0, self.budget_cap)]

    def state_doc(self, state):
        return {"attempt": state[0], "tokens": state[1],
                "max_attempts": self.max_attempts}

    def actions(self, state):
        attempt, tokens = state
        out = []
        for u in self.JITTER:
            for dl in self.DEADLINES:
                rd = self.decide(attempt, self.max_attempts,
                                 float(tokens), dl, self.BASE_S,
                                 self.CAP_S, u)
                row = {"kind": "retry", "inputs": {
                    "attempt": attempt,
                    "max_attempts": self.max_attempts,
                    "tokens": float(tokens),
                    "deadline_left_s": dl,
                    "base_s": self.BASE_S, "cap_s": self.CAP_S,
                    "jitter_u": u,
                }, "outputs": dict(rd)}
                nxt = ((min(attempt + 1, self.max_attempts + 1),
                        max(0, tokens - 1))
                       if rd["retry"] else (attempt, tokens))
                out.append((f"retry?(u={u},dl={dl})", [row], nxt))
        out.append(("refill", [],
                    (attempt, min(self.budget_cap, tokens + 1))))
        if attempt > 0:
            out.append(("fresh-request", [], (0, tokens)))
        return out

    def check_action(self, state, label, rows, nxt):
        if not rows:
            return []
        attempt, tokens = state
        inp, out = rows[0]["inputs"], rows[0]["outputs"]
        bad = []
        self._hit("retry-budget-bounded")
        if out["retry"]:
            if inp["tokens"] < 1.0:
                bad.append((
                    "retry-budget-bounded",
                    f"retry granted with {inp['tokens']} budget "
                    "tokens — the budget cannot bound a storm"))
            if inp["attempt"] >= inp["max_attempts"]:
                bad.append((
                    "retry-budget-bounded",
                    f"retry granted at attempt {inp['attempt']} with "
                    f"max_attempts {inp['max_attempts']}"))
        elif out.get("reason") not in (
                "attempts-exhausted", "budget-exhausted", "deadline"):
            bad.append((
                "retry-budget-bounded",
                f"refused retry names no reason ({out.get('reason')!r})"))
        self._hit("retry-backoff-bounded")
        if out["retry"]:
            delay = out["delay_s"]
            if delay is None or delay < 0.0 \
                    or delay > 1.5 * inp["cap_s"] + 1e-12:
                bad.append((
                    "retry-backoff-bounded",
                    f"granted delay {delay!r} outside "
                    f"[0, 1.5*cap={1.5 * inp['cap_s']}]"))
            dl = inp["deadline_left_s"]
            if dl is not None and delay is not None and delay >= dl:
                bad.append((
                    "retry-backoff-bounded",
                    f"granted delay {delay} overshoots the remaining "
                    f"deadline {dl}"))
        return bad



# ---------------------------------------------------------------------------
# assembly, reports, and the counterexample bridge
# ---------------------------------------------------------------------------

def _depth_scale() -> int:
    """``CK_MODEL_DEPTH``: 1 = tier-1 bounds; larger deepens."""
    try:
        return max(1, int(os.environ.get(DEPTH_ENV, "") or 1))
    except ValueError:
        return 1


def build_machines(name: str, quick: bool = False,
                   scale: int | None = None) -> list:
    """The sub-machine list for one machine name, at tier-1 bounds
    scaled by ``CK_MODEL_DEPTH`` (or ``scale``).  ``quick`` is the
    reference's bench-epilogue profile: the same machines under the
    smallest honest bounds, sub-second.  The reference's ``block``
    machine raises :class:`NotPortedError`."""
    scale = _depth_scale() if scale is None else max(1, int(scale))
    if name == "drain":
        if quick:
            return [DrainMachine(lanes=2, hold_barriers=1,
                                 confirm_clear=1, probe_grace=1)]
        return [DrainMachine(hold_barriers=2 + scale,
                             confirm_clear=2 + scale,
                             probe_grace=1 + 2 * scale)]
    if name == "elastic":
        if quick:
            return [ElasticMachine(member_ids=("p0", "p2"))]
        ids = ("p0", "p2", "p10") if scale == 1 else \
            ("p0", "p2", "p10", "p3")[:3 + min(scale - 1, 1)]
        return [ElasticMachine(member_ids=ids, steps=(2, 3, 4))]
    if name == "balance":
        if quick:
            return [BalanceMachine(rate_alphabet=(1.0, 5.0),
                                   lane_counts=(2,), horizon=32)]
        rates = (1.0, 1.5, 2.0, 5.0, 8.0, 100.0) if scale == 1 else \
            (1.0, 1.5, 2.0, 3.0, 5.0, 8.0, 100.0)
        # full pairwise alphabet on 2 lanes; the 3-lane machine keeps
        # the closest tie-band pair (1.0/1.5) and the 100x hetero skew
        # but drops the mid rates — the prior knob doubled the config
        # space and triple-lane combos dominate the wall otherwise
        tri = (1.0, 1.5, 2.0, 100.0) if scale == 1 else \
            (1.0, 1.5, 2.0, 8.0, 100.0)
        return [BalanceMachine(rate_alphabet=rates, lane_counts=(2,),
                               horizon=32 * scale),
                BalanceMachine(rate_alphabet=tri, lane_counts=(3,),
                               horizon=32 * scale)]
    if name == "serve":
        if quick:
            return [AdmissionMachine(tenants=("a", "b"), quota=2,
                                     max_queue_depth=2),
                    CoalesceMachine(keys=("ga", "gb"))]
        return [
            AdmissionMachine(quota=2 + scale,
                             max_queue_depth=4 + scale),
            CoalesceMachine(max_picks=1,
                            starve_cap_extra=1 + scale),
            CoalesceMachine(max_picks=2),
        ]
    if name == "resilience":
        if quick:
            return [BreakerMachine(threshold=2, open_ticks=2),
                    ShedMachine(engage_streak=1),
                    RetryMachine(max_attempts=1, budget_cap=1)]
        return [BreakerMachine(threshold=2 + (scale - 1),
                               open_ticks=2 + scale),
                ShedMachine(engage_streak=1 + scale),
                RetryMachine(max_attempts=1 + scale,
                             budget_cap=1 + scale)]
    if name == "router":
        if quick:
            return [RouterMachine(member_ids=("p0", "p2"))]
        ids = ("p0", "p2", "p10") if scale == 1 else \
            ("p0", "p2", "p10", "p3")[:3 + min(scale - 1, 1)]
        return [RouterMachine(member_ids=ids)]
    if name in NOT_PORTED:
        raise NotPortedError(
            f"model machine {name!r} drives controllers the port does not "
            f"have yet: ROADMAP {NOT_PORTED[name]}")
    raise ValueError(
        f"unknown machine {name!r}; machines: {MACHINE_NAMES}")


def check_machine(name: str, quick: bool = False,
                  scale: int | None = None,
                  machines: list | None = None) -> dict:
    """Explore one CLI machine (all its sub-machines) and merge."""
    subs = machines if machines is not None else build_machines(
        name, quick=quick, scale=scale)
    reports = [m.explore() for m in subs]
    return {
        "machine": name,
        "states_explored": sum(r["states_explored"] for r in reports),
        "transitions": sum(r["transitions"] for r in reports),
        "truncated": any(r["truncated"] for r in reports),
        "violations": [v for r in reports for v in r["violations"]],
        "sub_machines": {r["machine"]: {
            "states_explored": r["states_explored"],
            "transitions": r["transitions"],
            "invariants": r["invariants"],
        } for r in reports},
    }


def check_all(names=None, quick: bool = False,
              scale: int | None = None) -> dict:
    """The full report over every machine the port has (or ``names``):
    the reference's CLI gate's engine and bench ``model`` block."""
    names = tuple(names) if names else PORTED_MACHINES
    per = {n: check_machine(n, quick=quick, scale=scale) for n in names}
    violations = [v for r in per.values() for v in r["violations"]]
    return {
        "ok": not violations,
        "states_explored": sum(
            r["states_explored"] for r in per.values()),
        "transitions": sum(r["transitions"] for r in per.values()),
        "machines": per,
        "violations": violations,
    }


def tier1_check(quick: bool = True) -> dict:
    """The bench-epilogue view: jsonable, violation rows not objects."""
    rep = check_all(quick=quick)
    return {
        "ok": rep["ok"],
        "states_explored": rep["states_explored"],
        "machines": {
            n: {"states_explored": r["states_explored"],
                "violations": len(r["violations"])}
            for n, r in rep["machines"].items()
        },
        "violations": [v.to_row() for v in rep["violations"][:4]],
    }


