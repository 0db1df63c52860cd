"""The port's bounded model checker (``analysis/model.py``), drain and
balance machines only, against the reference's.

At the ``quick`` bounds and at tier-1 bounds (``CK_MODEL_DEPTH=1``) both
packages' ``DrainMachine`` and ``BalanceMachine`` explore the same state
and transition counts, exercise every declared invariant the same number
of times, and find no violation.  The reference's deliberately broken
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

    assert D.MODEL_INVARIANTS == RD.MODEL_INVARIANTS
    assert B.MODEL_INVARIANTS == RB.MODEL_INVARIANTS
    assert set(M.DrainMachine.checks) == {r[0] for r in D.MODEL_INVARIANTS}
    assert set(M.BalanceMachine.checks) == {r[0] for r in B.MODEL_INVARIANTS}


@pytest.mark.parametrize("name, item", [("elastic", "A 7"), ("serve", "A 8"),
                                        ("resilience", "A 8"), ("router", "A 8"),
                                        ("block", "A 9")])
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
}


def test_fixture_table_covers_every_declared_invariant():
    declared = {r[0] for r in D.MODEL_INVARIANTS} | {r[0] for r in B.MODEL_INVARIANTS}
    assert set(BROKEN_FIXTURES) == declared


@pytest.mark.parametrize("inv_id", sorted(BROKEN_FIXTURES))
def test_broken_fixture_produces_counterexample(inv_id):
    report = BROKEN_FIXTURES[inv_id]().explore()
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
