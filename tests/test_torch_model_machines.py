"""The port's bounded model checker (``analysis/model.py``): the drain,
elastic, balance, serving (admission and coalesce), resilience (breaker,
shed and retry) and router machines, against the reference's.

At the ``quick`` bounds and at tier-1 bounds (``CK_MODEL_DEPTH=1``) both
packages' machines explore the same state and transition counts, exercise
every declared invariant the same number of times, and find no violation.
The reference's deliberately broken fixture seams (one per declared
invariant) give a counterexample in the port, and the counterexample
bridge replays it (``obs.replay``): a broken drain trace diverges, a real
balance trace replays clean.  The ``block`` machine raises
``NotPortedError`` naming its Queue A item.  No wall-clock pin (ROADMAP
Queue C, reference state 3).
"""

from __future__ import annotations

import json

import pytest

from cekirdekler_tpu.analysis import model as RM
from cekirdekler_tpu_torch.analysis import model as M
from cekirdekler_tpu_torch.cluster import elastic as E
from cekirdekler_tpu_torch.core import balance as B
from cekirdekler_tpu_torch.errors import NotPortedError
from cekirdekler_tpu_torch.obs import drain as D
from cekirdekler_tpu_torch.obs.decisions import DECISIONS
from cekirdekler_tpu_torch.obs.flight import FLIGHT
from cekirdekler_tpu_torch.obs.replay import save_counterexample, verify_counterexample
from cekirdekler_tpu_torch.serve import admission as A
from cekirdekler_tpu_torch.serve import coalescer as C
from cekirdekler_tpu_torch.serve import fabric as F
from cekirdekler_tpu_torch.serve import resilience as R
from tests.test_torch_metrics import restore_planes, save_planes


@pytest.fixture(autouse=True)
def _planes(monkeypatch):
    monkeypatch.setenv("CK_MODEL_DEPTH", "1")
    saved = save_planes()
    yield
    restore_planes(saved)


def _summary(rep: dict) -> dict:
    return {
        "states": rep["states_explored"], "transitions": rep["transitions"],
        "truncated": rep["truncated"], "violations": len(rep["violations"]),
        "subs": {name.replace("balance(", "b("): {
            "states": sub["states_explored"], "transitions": sub["transitions"],
            "exercised": {k: v["exercised"] for k, v in sub["invariants"].items()}}
            for name, sub in rep["sub_machines"].items()},
    }


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "tier1"])
@pytest.mark.parametrize("name", M.PORTED_MACHINES)
def test_machine_explores_as_the_reference_does(name, quick):
    mine = M.check_machine(name, quick=quick)
    ref = RM.check_machine(name, quick=quick)
    assert _summary(mine) == _summary(ref)
    assert mine["violations"] == [] and not mine["truncated"]
    for sub in mine["sub_machines"].values():
        assert all(v["exercised"] > 0 for v in sub["invariants"].values())


def test_check_all_and_tier1_check_cover_the_ported_machines():
    rep = M.check_all(quick=True)
    assert rep["ok"] and set(rep["machines"]) == set(M.PORTED_MACHINES)
    ref = RM.check_all(names=M.PORTED_MACHINES, quick=True)
    assert rep["states_explored"] == ref["states_explored"]
    assert rep["transitions"] == ref["transitions"]
    t1 = M.tier1_check()
    json.dumps(t1, allow_nan=False)
    assert t1["ok"] and t1["violations"] == []
    assert {n: r["states_explored"] for n, r in t1["machines"].items()} == \
        {n: r["states_explored"] for n, r in ref["machines"].items()}


def test_the_vocabulary_and_declared_invariants_are_the_reference_s():
    assert M.MACHINE_NAMES == RM.MACHINE_NAMES and M.DEPTH_ENV == RM.DEPTH_ENV
    from cekirdekler_tpu.core import balance as RB
    from cekirdekler_tpu.obs import drain as RD

    from cekirdekler_tpu.cluster import elastic as RE

    assert D.MODEL_INVARIANTS == RD.MODEL_INVARIANTS
    assert B.MODEL_INVARIANTS == RB.MODEL_INVARIANTS
    assert E.MODEL_INVARIANTS == RE.MODEL_INVARIANTS
    assert set(M.DrainMachine.checks) == {r[0] for r in D.MODEL_INVARIANTS}
    assert set(M.BalanceMachine.checks) == {r[0] for r in B.MODEL_INVARIANTS}
    assert set(M.ElasticMachine.checks) == {r[0] for r in E.MODEL_INVARIANTS}
    from cekirdekler_tpu.serve import admission as RA
    from cekirdekler_tpu.serve import coalescer as RC
    from cekirdekler_tpu.serve import fabric as RF
    from cekirdekler_tpu.serve import resilience as RR

    for mine, ref in ((A, RA), (C, RC), (R, RR), (F, RF)):
        assert mine.MODEL_INVARIANTS == ref.MODEL_INVARIANTS
    assert R.BREAKER_INVARIANTS == RR.BREAKER_INVARIANTS
    assert R.SHED_INVARIANTS == RR.SHED_INVARIANTS
    assert R.RETRY_INVARIANTS == RR.RETRY_INVARIANTS
    assert set(M.AdmissionMachine.checks) == {r[0] for r in A.MODEL_INVARIANTS}
    assert set(M.CoalesceMachine.checks) == {r[0] for r in C.MODEL_INVARIANTS}
    assert set(M.BreakerMachine.checks) == {r[0] for r in R.BREAKER_INVARIANTS}
    assert set(M.ShedMachine.checks) == {r[0] for r in R.SHED_INVARIANTS}
    assert set(M.RetryMachine.checks) == {r[0] for r in R.RETRY_INVARIANTS}
    assert set(M.RouterMachine.checks) == {r[0] for r in F.MODEL_INVARIANTS}


@pytest.mark.parametrize("name, item", [("block", "A 9")])
def test_other_machines_name_their_queue_item(name, item):
    with pytest.raises(NotPortedError, match=item):
        M.build_machines(name)
    with pytest.raises(ValueError, match="unknown machine"):
        M.build_machines("nope")


def test_exploration_leaves_the_live_planes_alone():
    FLIGHT.clear()
    DECISIONS.clear()
    FLIGHT.event("marker")
    M.check_machine("balance", quick=True)
    assert [e.kind for e in FLIGHT.snapshot()] == ["marker"]
    assert FLIGHT.enabled and DECISIONS.snapshot() == []


# -- the reference's broken fixture seams, one per declared invariant --------

def _no_floor(verdicts, states, hold, streak, hb, cc, probe_grace=2):
    res = D.drain_transition(verdicts, states, hold, streak, hb, cc, probe_grace=probe_grace)
    for lane, v in {str(k): v for k, v in verdicts.items()}.items():
        if v == "degraded" and res["states"].get(lane) == D.LANE_ACTIVE:
            res["states"][lane] = D.LANE_QUARANTINED
            res["hold"][lane] = hb
            res["drained"].append(lane)
    return res


def _leaky_masker(ranges, step, drained, probation):
    out = list(D.apply_quarantine(ranges, step, drained, probation))
    if drained or probation:
        out[-1] += step  # invented share
    return out


def _double_probe_masker(ranges, step, drained, probation):
    return D.apply_quarantine(ranges, 2 * step, drained, probation)


def _silent_drain(verdicts, states, hold, streak, hb, cc, probe_grace=2):
    res = D.drain_transition(verdicts, states, hold, streak, hb, cc, probe_grace=probe_grace)
    if res["drained"]:
        res = dict(res, drained=res["drained"][:-1])  # hide one
    return res


def _never_readmit(verdicts, states, hold, streak, hb, cc, probe_grace=2):
    res = D.drain_transition(verdicts, states, hold, streak, hb, cc, probe_grace=probe_grace)
    if res["readmitted"]:
        states_out = dict(res["states"])
        streak_out = dict(res["clear_streak"])
        for lane in res["readmitted"]:
            states_out[lane] = D.LANE_PROBATION
            streak_out[lane] = 0
        res = dict(res, states=states_out, clear_streak=streak_out, readmitted=[])
    return res


def _flappy(verdicts, states, hold, streak, hb, cc, probe_grace=2):
    res = D.drain_transition(verdicts, states, hold, streak, hb, cc, probe_grace=probe_grace)
    vmap = {str(k): v for k, v in verdicts.items()}
    for lane, st in {str(k): v for k, v in states.items()}.items():
        if st == D.LANE_PROBATION and vmap.get(lane, "ok") == "ok":
            res["states"][lane] = D.LANE_QUARANTINED
            res["hold"][lane] = hb
            res["clear_streak"][lane] = 0
            res["drained"].append(lane)
            if lane in res["readmitted"]:
                res["readmitted"].remove(lane)
    return res


def _drain_machine(**kw):
    return M.DrainMachine(lanes=2, hold_barriers=1, confirm_clear=1, probe_grace=1, **kw)


def _lossy_balance(bench, ranges, total, step, hist, **kw):
    out = list(B.load_balance(bench, ranges, total, step, hist, **kw))
    if out[0] >= step:
        out[0] -= step
    return out


def _unquantized_balance(bench, ranges, total, step, hist, **kw):
    out = list(B.load_balance(bench, ranges, total, step, hist, **kw))
    if len(out) > 1:
        out[0] += 1
        out[-1] -= 1
    return out


def _rejump_balance(bench, ranges, total, step, hist, state=None, **kw):
    out = B.load_balance(bench, ranges, total, step, hist, state=state, **kw)
    if state is not None and state.jumped:
        state.jumped = False  # the one-shot latch filed off
    return out


def _freeze_mover(bench, ranges, total, step, hist, **kw):
    src = list(ranges)
    out = list(B.load_balance(bench, ranges, total, step, hist, **kw))
    if out == src and len(out) > 1 and out[0] >= step:
        out[0] -= step
        out[1] += step
    return out


_osc_flip = [False]


def _oscillator(bench, ranges, total, step, hist, **kw):
    out = list(B.load_balance(bench, ranges, total, step, hist, **kw))
    _osc_flip[0] = not _osc_flip[0]
    if len(out) > 1:
        i, j = (0, 1) if _osc_flip[0] else (1, 0)
        if out[i] >= step:
            out[i] -= step
            out[j] += step
    return out


def _equal_seeder(total, step, priors, cid=None):
    return B.equal_split(int(total), len(priors), int(step))


def _balance_machine(alphabet=(1.0, 5.0), **kw):
    return M.BalanceMachine(rate_alphabet=alphabet, lane_counts=(2,), horizon=24, **kw)


class _DoubleEpoch(E.Membership):
    def _transition(self, kind, member, step, total):
        out = super()._transition(kind, member, step, total)
        with self._mu:
            self.epoch += 1  # a skipped number between records
        return out


class _NoJoins(E.Membership):
    def sync(self, present, total=None):
        return super().sync({k: v for k, v in present.items() if k in self.members}, total)


class _FlakyOrder(E.Membership):
    """Keeps the roster outcome and the leaves-before-joins order, but flips
    the order within each phase on alternate drives."""

    FLIP = [False]

    def sync(self, present, total=None):
        _FlakyOrder.FLIP[0] = not _FlakyOrder.FLIP[0]
        rev = _FlakyOrder.FLIP[0]
        with self._mu:
            current = dict(self.members)
        resized = sorted(m for m in present if m in current and present[m] != current[m])
        out = [self.leave(m, total)
               for m in sorted(set(current) - set(present), reverse=rev) + resized]
        return out + [self.join(m, present[m], total)
                      for m in sorted(set(present) - set(current), reverse=rev) + resized]


def _elastic_machine(**kw):
    return M.ElasticMachine(member_ids=("p0", "p2"), steps=(2, 3), **kw)


def _lossy_resplit(steps, total, real=E.member_resplit):
    out = real(steps, total)
    if len(out["ranges"]) >= 2 and out["ranges"][0] >= out["lcm"]:
        out = dict(out, ranges=[out["ranges"][0] - out["lcm"], *out["ranges"][1:]])
    return out


def _unquantized_resplit(steps, total, real=E.member_resplit):
    out = real(steps, total)
    if len(out["ranges"]) >= 2 and out["ranges"][0] >= 1:
        out = dict(out, ranges=[out["ranges"][0] - 1, *out["ranges"][1:-1],
                                out["ranges"][-1] + 1])
    return out


def _patched_resplit(fn):
    """A machine over the real Membership whose re-split is ``fn``."""
    def factory(monkeypatch):
        monkeypatch.setattr(E, "member_resplit", fn)
        return _elastic_machine()
    return factory


# -- the serving machines' seams (serve/admission.py, serve/coalescer.py,
# serve/resilience.py, serve/fabric.py), the reference's fixtures over the port

def _quota_off_by_one(**kw):
    if (not kw["kernel_unsafe"] and kw["healthy"]
            and kw["queue_depth"] < kw["max_queue_depth"]
            and kw["tenant_inflight"] == kw["quota"]):
        return {"admit": True, "reason": None, "retry_after_s": None}
    return A.admit_decision(**kw)


def _no_queue_gate(**kw):
    return A.admit_decision(**dict(kw, queue_depth=0))


def _wrong_order(**kw):
    dec = A.admit_decision(**kw)
    if not dec["admit"] and not kw["healthy"] \
            and kw["tenant_inflight"] >= kw["quota"]:
        return {"admit": False, "reason": A.REJECT_QUOTA,
                "retry_after_s": dec["retry_after_s"]}
    return dec


def _kernel_backoff(**kw):
    dec = A.admit_decision(**kw)
    if dec.get("reason") == A.REJECT_KERNEL:
        return dict(dec, retry_after_s=1.0)
    return dec


def _moody(**kw):
    dec = A.admit_decision(**kw)
    if dec["admit"] and kw["tenant_inflight"] == 1:
        return {"admit": False, "reason": A.REJECT_QUOTA,
                "retry_after_s": 0.1}
    return dec


def _admission_machine(**kw):
    return M.AdmissionMachine(tenants=("a", "b"), quota=2,
                              max_queue_depth=2, **kw)


def _overpromote(groups, rnd, mp):
    plan = C.plan_coalesce(groups, rnd, mp)
    keys = [str(g["key"]) for g in groups if int(g.get("pending", 0))]
    if keys and not plan["promoted"]:
        plan = dict(plan, promoted=[keys[0]])
    return plan


def _order_dropper(groups, rnd, mp):
    plan = C.plan_coalesce(groups, rnd, mp)
    if len(plan["order"]) > 1:
        order = plan["order"][:-1]
        plan = dict(plan, order=order,
                    picked=order[:mp] if mp > 0 else list(order))
    return plan


_jitter_seen: dict = {}


def _jitter(groups, rnd, mp):
    """Nondeterministic per SNAPSHOT: the first plan of a given
    snapshot is real, every replan of the same snapshot is tampered —
    exactly the replay-breaking drift plan-deterministic refuses."""
    plan = C.plan_coalesce(groups, rnd, mp)
    key = (rnd, tuple(sorted(
        (g["key"], g.get("starved_rounds", 0)) for g in groups)))
    n = _jitter_seen.get(key, 0)
    _jitter_seen[key] = n + 1
    if n > 0 and len(plan["order"]) > 1:
        order = list(plan["order"])
        order[0], order[-1] = order[-1], order[0]
        plan = dict(plan, order=order,
                    picked=order[:mp] if mp > 0 else list(order))
    return plan


def _no_fairness(groups, rnd, mp):
    """The strawman before fairness promotions: EDF/age only, no promotion — the youngest
    group starves unboundedly behind fixed older/deadlined peers."""
    rows = [g for g in groups if int(g.get("pending", 0)) > 0]
    order = [str(g["key"]) for g in sorted(rows, key=C._edf_key)]
    picked = order[:mp] if mp > 0 else list(order)
    return {"order": order, "picked": picked, "promoted": [],
            "max_picks": mp if mp > 0 else 0}


def _coalesce_machine(**kw):
    return M.CoalesceMachine(keys=("ga", "gb", "gc"), max_picks=1, **kw)


# -- resilience (serve/resilience.py) fixtures ------------------------------

def _double_probe_admit(state, now, open_s):
    """Half-open admits a SECOND probe while one is in flight."""
    out = R.breaker_admit(state, now, open_s)
    if state.get("state") == R.BREAKER_HALF_OPEN \
            and state.get("probe_inflight"):
        st = dict(out["state"])
        return dict(out, allow=True, probe=True, retry_after_s=None,
                    state=st)
    return out


def _eager_open(state, event, now, threshold, open_s):
    """Opens on the FIRST failure (threshold filed down to 1)."""
    out = R.breaker_transition(state, event, now, threshold, open_s)
    if state.get("state") == R.BREAKER_CLOSED and event == "failure" \
            and out["action"] is None:
        st = dict(out["state"], state=R.BREAKER_OPEN, opened_t=now)
        return {"state": st, "action": "opened"}
    return out


def _dishonest_hint(state, now, open_s):
    """Refusals carry a made-up hint instead of the remaining window."""
    out = R.breaker_admit(state, now, open_s)
    if not out["allow"]:
        return dict(out, retry_after_s=999.0)
    return out


def _never_half_open(state, now, open_s):
    """The open window never times out — admits are refused forever."""
    if state.get("state") == R.BREAKER_OPEN:
        return {"allow": False, "probe": False,
                "retry_after_s": float(open_s) / 2.0,
                "state": dict(state), "action": None}
    return R.breaker_admit(state, now, open_s)


def _probe_never_closes(state, event, now, threshold, open_s):
    """A successful probe re-opens instead of closing (permanent open
    under all-ok inputs)."""
    out = R.breaker_transition(state, event, now, threshold, open_s)
    if state.get("state") == R.BREAKER_HALF_OPEN and event == "success":
        st = dict(out["state"], state=R.BREAKER_OPEN, opened_t=now,
                  probe_inflight=False)
        return {"state": st, "action": "reopened"}
    return out


def _breaker_machine(**kw):
    return M.BreakerMachine(threshold=2, open_ticks=2, **kw)


def _hair_trigger_shed(state, qd, wm, cm, ob, dl, engage_streak=2):
    """Engages on the FIRST pressured evaluation — the hysteresis the
    pressure gate exists to enforce, filed off."""
    out = R.brownout_transition(state, qd, wm, cm, ob, dl,
                                engage_streak=engage_streak)
    if not state.get("active") and out["pressure"] and not out["active"]:
        return dict(out, active=True, streak=0, changed=True)
    return out


def _sticky_shed(state, qd, wm, cm, ob, dl, engage_streak=2):
    """Never releases: degraded mode is permanent."""
    out = R.brownout_transition(state, qd, wm, cm, ob, dl,
                                engage_streak=engage_streak)
    if state.get("active"):
        return dict(out, active=True, changed=False)
    return out


def _shed_everyone(**kw):
    """Sheds even a tenant with ZERO requests in flight."""
    dec = A.admit_decision(**kw)
    if kw.get("brownout") and dec["admit"]:
        return {"admit": False, "reason": A.REJECT_BROWNOUT,
                "retry_after_s": 0.1}
    return dec


def _anonymous_shed(**kw):
    """Brownout rejections renamed to the quota reason (and a
    busy-loop hint)."""
    dec = A.admit_decision(**kw)
    if dec.get("reason") == A.REJECT_BROWNOUT:
        return dict(dec, reason=A.REJECT_QUOTA, retry_after_s=0.0)
    return dec


def _shed_machine(**kw):
    return M.ShedMachine(engage_streak=2, **kw)


def _budgetless_retry(attempt, max_attempts, tokens, deadline_left_s,
                      base_s, cap_s, jitter_u):
    """Grants retries with an empty budget and past max_attempts —
    the retry storm the budget exists to prevent."""
    rd = R.retry_decision(attempt, max_attempts, tokens,
                          deadline_left_s, base_s, cap_s, jitter_u)
    if not rd["retry"] and rd["reason"] in ("budget-exhausted",
                                            "attempts-exhausted"):
        return {"retry": True, "delay_s": base_s, "reason": None}
    return rd


def _unbounded_backoff(attempt, max_attempts, tokens, deadline_left_s,
                       base_s, cap_s, jitter_u):
    """Backoff cap filed off: granted delays blow past 1.5×cap (and
    any deadline)."""
    rd = R.retry_decision(attempt, max_attempts, tokens,
                          deadline_left_s, base_s, cap_s, jitter_u)
    if rd["retry"]:
        return dict(rd, delay_s=10.0 * cap_s)
    return rd


def _retry_machine(**kw):
    return M.RetryMachine(max_attempts=2, budget_cap=2, **kw)


class _FlipRoute:
    """Alternate calls bounce the same key between members — the
    drive/re-drive comparison (and any replay) diverges."""

    def __init__(self):
        self.calls = 0

    def __call__(self, tenant, key, members, unhealthy=(), epoch=0):
        out = F.route_decision(tenant, key, members, unhealthy, epoch)
        self.calls += 1
        roster = sorted(set(str(m) for m in members),
                        key=lambda m: (len(m), m))
        if out["shard"] is not None and len(roster) > 1 and \
                self.calls % 2:
            alt = roster[(roster.index(out["shard"]) + 1) % len(roster)]
            return dict(out, shard=alt, owner=alt)
        return out


def _modulo_route(tenant, key, members, unhealthy=(), epoch=0):
    """Placement by hash MOD roster size — the NON-consistent hash
    minimal-reshuffle exists to forbid: one departure reshuffles keys
    between the survivors."""
    import hashlib as _hl

    roster = sorted(set(str(m) for m in members),
                    key=lambda m: (len(m), m))
    if not roster:
        return F.route_decision(tenant, key, members, unhealthy, epoch)
    h = int(_hl.sha256(f"{tenant}|{key}".encode()).hexdigest()[:16], 16)
    owner = roster[h % len(roster)]
    bad = set(str(m) for m in unhealthy)
    shard, hops = None, 0
    for i in range(len(roster)):
        m = roster[(h + i) % len(roster)]
        if m not in bad:
            shard = m
            break
        hops += 1
    if shard is None:
        return {"shard": None, "owner": owner, "diverted": True,
                "hops": hops, "reason": F.REJECT_SHARD,
                "epoch": int(epoch)}
    return {"shard": shard, "owner": owner, "diverted": shard != owner,
            "hops": hops, "reason": None, "epoch": int(epoch)}


def _offroster_route(tenant, key, members, unhealthy=(), epoch=0):
    """Names a shard that is not in the roster."""
    out = F.route_decision(tenant, key, members, unhealthy, epoch)
    if out["shard"] is not None:
        return dict(out, shard="zz", owner="zz")
    return out


def _silent_divert_route(tenant, key, members, unhealthy=(), epoch=0):
    """Diverts off a sick owner WITHOUT the diverted flag / hop count
    — the silent diversion the named-decision rule forbids."""
    out = F.route_decision(tenant, key, members, unhealthy, epoch)
    if out["shard"] is not None and out["diverted"]:
        return dict(out, diverted=False, hops=0)
    return out


def _router_machine(**kw):
    return M.RouterMachine(member_ids=("p0", "p2"), **kw)


BROKEN_FIXTURES = {
    "availability-floor": lambda: _drain_machine(transition=_no_floor),
    "share-conservation": lambda: _drain_machine(masker=_leaky_masker),
    "quarantine-masked": lambda: _drain_machine(masker=_double_probe_masker),
    "action-visibility": lambda: _drain_machine(transition=_silent_drain),
    "eventual-readmission": lambda: _drain_machine(transition=_never_readmit),
    "no-silent-flap": lambda: _drain_machine(transition=_flappy),
    "range-conservation": lambda: _balance_machine(balance=_lossy_balance),
    "range-quantized": lambda: _balance_machine(balance=_unquantized_balance),
    "jump-one-shot": lambda: _balance_machine(balance=_rejump_balance),
    "freeze-legal": lambda: _balance_machine(alphabet=(1.0,), balance=_freeze_mover),
    "converges": lambda: _balance_machine(balance=_oscillator),
    "prior-seeded-jump-within-one-step":
        lambda: _balance_machine(alphabet=(1.0, 100.0), seeder=_equal_seeder),
    "epoch-monotone": lambda: _elastic_machine(membership_cls=_DoubleEpoch),
    "sync-converges": lambda: _elastic_machine(membership_cls=_NoJoins),
    # needs two departures at once for the order within a phase to vary
    "deterministic-order": lambda: M.ElasticMachine(
        member_ids=("p0", "p2", "p10"), steps=(2, 3), membership_cls=_FlakyOrder),
    "quota-exact": lambda: _admission_machine(decide=_quota_off_by_one),
    "queue-bounded": lambda: _admission_machine(decide=_no_queue_gate),
    "reject-order": lambda: _admission_machine(decide=_wrong_order),
    "retry-hint": lambda: _admission_machine(decide=_kernel_backoff),
    "admit-iff": lambda: _admission_machine(decide=_moody),
    "promoted-are-starved": lambda: _coalesce_machine(plan=_overpromote),
    "plan-complete": lambda: _coalesce_machine(plan=_order_dropper),
    "plan-deterministic": lambda: _coalesce_machine(plan=_jitter),
    "bounded-starvation": lambda: _coalesce_machine(plan=_no_fairness),
    "breaker-half-open-one-probe": lambda: _breaker_machine(admit=_double_probe_admit),
    "breaker-opens-on-threshold": lambda: _breaker_machine(transition=_eager_open),
    "breaker-honest-hint": lambda: _breaker_machine(admit=_dishonest_hint),
    "breaker-open-times-out": lambda: _breaker_machine(admit=_never_half_open),
    "breaker-recovers-on-ok": lambda: _breaker_machine(transition=_probe_never_closes),
    "shed-pressure-gated": lambda: _shed_machine(transition=_hair_trigger_shed),
    "shed-quota-floor": lambda: _shed_machine(decide=_shed_everyone),
    "shed-named-hint": lambda: _shed_machine(decide=_anonymous_shed),
    "shed-releases": lambda: _shed_machine(transition=_sticky_shed),
    "retry-budget-bounded": lambda: _retry_machine(decide=_budgetless_retry),
    "retry-backoff-bounded": lambda: _retry_machine(decide=_unbounded_backoff),
    "placement-deterministic": lambda: _router_machine(route=_FlipRoute()),
    # mod-N reshuffling shows only between survivors: three members
    "minimal-reshuffle": lambda: M.RouterMachine(
        member_ids=("p0", "p2", "p10"), route=_modulo_route),
    "routes-to-members": lambda: _router_machine(route=_offroster_route),
    "diversion-named": lambda: _router_machine(route=_silent_divert_route),
}

#: the elastic invariants broken through the re-split, not the membership class
PATCHED_FIXTURES = {
    "resplit-conservation": _patched_resplit(_lossy_resplit),
    "resplit-quantized": _patched_resplit(_unquantized_resplit),
}


def test_fixture_table_covers_every_declared_invariant():
    declared = set()
    for mod in (D, B, E, A, C, R, F):
        declared |= {r[0] for r in mod.MODEL_INVARIANTS}
    assert set(BROKEN_FIXTURES) | set(PATCHED_FIXTURES) == declared


@pytest.mark.parametrize("inv_id", sorted(BROKEN_FIXTURES) + sorted(PATCHED_FIXTURES))
def test_broken_fixture_produces_counterexample(inv_id, monkeypatch):
    machine = BROKEN_FIXTURES[inv_id]() if inv_id in BROKEN_FIXTURES else \
        PATCHED_FIXTURES[inv_id](monkeypatch)
    report = machine.explore()
    hit = [v for v in report["violations"] if v.invariant == inv_id]
    assert hit, f"{inv_id}: no violation; got {[v.invariant for v in report['violations']]}"
    v = hit[0]
    assert v.fingerprint and v.kind in ("safety", "liveness") and v.trace
    assert all({"seq", "kind", "inputs", "outputs"} <= set(r) for r in v.trace)
    json.dumps(v.to_row(), allow_nan=False)
    assert inv_id in v.render()


def test_broken_drain_trace_diverges_under_replay():
    report = _drain_machine(transition=_no_floor).explore()
    v = next(x for x in report["violations"] if x.invariant == "availability-floor")
    verdict = verify_counterexample(v)
    assert verdict["ok"] is False and verdict["first_divergence"]["seq"] >= 1
    assert verdict["first_divergence"]["kind"] in ("drain-apply", "readmit")


def test_real_balance_trace_replays_clean(tmp_path):
    report = _balance_machine(balance=_oscillator).explore()
    v = next(x for x in report["violations"] if x.invariant == "converges")
    verdict = verify_counterexample(v)
    assert verdict["ok"] is True and verdict["replayed"] == len(v.trace)
    path = save_counterexample(str(tmp_path / "cx.jsonl"), v)
    from cekirdekler_tpu_torch.tools import ckreplay

    assert ckreplay.main(["verify", path]) == 0


def test_violation_fingerprints_match_the_reference_s():
    """The same broken seam gives the same counterexample fingerprints in
    both packages (machine, invariant and terminal state hash alike)."""
    from cekirdekler_tpu.obs import drain as RD

    def ref_no_floor(verdicts, states, hold, streak, hb, cc, probe_grace=2):
        res = RD.drain_transition(verdicts, states, hold, streak, hb, cc,
                                  probe_grace=probe_grace)
        for lane, v in {str(k): v for k, v in verdicts.items()}.items():
            if v == "degraded" and res["states"].get(lane) == RD.LANE_ACTIVE:
                res["states"][lane] = RD.LANE_QUARANTINED
                res["hold"][lane] = hb
                res["drained"].append(lane)
        return res

    mine = _drain_machine(transition=_no_floor).explore()
    ref = RM.DrainMachine(lanes=2, hold_barriers=1, confirm_clear=1, probe_grace=1,
                          transition=ref_no_floor).explore()
    assert [(v.invariant, v.fingerprint, len(v.trace)) for v in mine["violations"]] == \
        [(v.invariant, v.fingerprint, len(v.trace)) for v in ref["violations"]]


def test_a_broken_membership_is_caught_as_the_reference_catches_it():
    """The double-epoch membership gives the same counterexamples in both
    packages.  Each record of its trace is consistent alone (the skipped
    epoch falls between records), so both packages' replays pass it."""
    from cekirdekler_tpu.cluster import elastic as RE

    class RefDoubleEpoch(RE.Membership):
        def _transition(self, kind, member, step, total):
            out = super()._transition(kind, member, step, total)
            with self._mu:
                self.epoch += 1
            return out

    mine = _elastic_machine(membership_cls=_DoubleEpoch).explore()
    ref = RM.ElasticMachine(member_ids=("p0", "p2"), steps=(2, 3),
                            membership_cls=RefDoubleEpoch).explore()
    assert mine["violations"] and \
        [(v.invariant, v.fingerprint, len(v.trace)) for v in mine["violations"]] == \
        [(v.invariant, v.fingerprint, len(v.trace)) for v in ref["violations"]]
    assert (mine["states_explored"], mine["transitions"]) == \
        (ref["states_explored"], ref["transitions"])
    v = next(x for x in mine["violations"] if x.invariant == "epoch-monotone")
    from cekirdekler_tpu.obs.replay import verify_records as ref_verify_records

    verdict = verify_counterexample(v)
    assert verdict["ok"] is True and verdict["replayed"] == len(v.trace) > 0
    assert ref_verify_records(v.trace)["ok"] is True
