"""ckmodel — bounded exhaustive model checking of the pure controller
state machines, against the invariants each machine declares.

A copy of the reference's ``analysis/model.py`` for the machines whose
controllers the port has: :class:`DrainMachine` drives the port's
``obs/drain.py`` (``drain_transition`` x ``apply_quarantine``),
:class:`ElasticMachine` the port's ``cluster/elastic.py``
(``Membership`` under every roster reconciliation) and
:class:`BalanceMachine` the port's ``core/balance.py``
(``load_balance`` / ``prior_split``), with the reference's bounds,
invariants, counterexample traces and reports.  The other machine names
of :data:`MACHINE_NAMES` raise :class:`~..errors.NotPortedError` naming
the ROADMAP Queue A item that brings their controllers: ``serve``,
``resilience`` and ``router`` (serving tier, A 8), ``block`` (the block
tuner, A 9).  The reference's
``tools/ckmodel`` CLI and its purity lint come with A 8.  The text below
is the reference's.

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
    "BalanceMachine",
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
PORTED_MACHINES = ("drain", "elastic", "balance")
NOT_PORTED = {
    "router": "Queue A 8 (serving tier: serve/fabric.py)",
    "serve": "Queue A 8 (serving tier: serve/admission.py, serve/coalescer.py)",
    "resilience": "Queue A 8 (serving tier: serve/resilience.py)",
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
    smallest honest bounds, sub-second.  The reference's other machine
    names raise :class:`NotPortedError`."""
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


