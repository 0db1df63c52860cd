"""The port's bounded model checker (``analysis/model.py``), drain,
elastic and balance machines, against the reference's.

At the ``quick`` bounds and at tier-1 bounds (``CK_MODEL_DEPTH=1``) both
packages' ``DrainMachine``, ``ElasticMachine`` and ``BalanceMachine``
explore the same state and transition counts, exercise every declared
invariant the same number of times, and find no violation.  The reference's deliberately broken
fixture seams (one per declared invariant) give a counterexample in the
port, and the counterexample bridge replays it (``obs.replay``): a broken
drain trace diverges, a real balance trace replays clean.  The other
machine names raise ``NotPortedError`` naming their Queue A item.  No
wall-clock pin (ROADMAP Queue C, reference state 3).
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


@pytest.mark.parametrize("name, item", [("serve", "A 8"), ("resilience", "A 8"),
                                        ("router", "A 8"), ("block", "A 9")])
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
}

#: the elastic invariants broken through the re-split, not the membership class
PATCHED_FIXTURES = {
    "resplit-conservation": _patched_resplit(_lossy_resplit),
    "resplit-quantized": _patched_resplit(_unquantized_resplit),
}


def test_fixture_table_covers_every_declared_invariant():
    declared = {r[0] for r in D.MODEL_INVARIANTS} | {r[0] for r in B.MODEL_INVARIANTS} | {
        r[0] for r in E.MODEL_INVARIANTS}
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
