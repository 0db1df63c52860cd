"""The port's serving resilience (``serve/resilience.py`` and the
frontend's containment, retry, breaker and brownout paths) against the
reference's, on host lanes.

- **The pure machines.**  Seeded sweeps of ``breaker_transition``,
  ``breaker_admit``, ``brownout_transition``, ``retry_decision`` and
  ``containment_plan`` through both packages give identical outputs; the
  reference's pinned cases hold in the port.
- **The controllers, step by step.**  ``BreakerBoard`` and
  ``RetryBudgets`` run the same event sequences in both packages: equal
  verdicts, equal snapshots, and ``breaker`` decision rows equal field for
  field (seq and clocks aside).
- **The frontend under seeded faults.**  The reference's
  ``tests/test_serve_resilience.py`` cases run through the port.  Where the
  outcome is deterministic (a seeded ``serve-dispatch`` or ``driver-submit``
  plan over the ``autostart=False`` seam) the same script runs through both
  packages: the same requests fail with the same named causes, the arrays
  are bit-equal, and the containment, retry and breaker rows are equal.
- **Replay across packages.**  ``breaker``, ``retry``, ``containment`` and
  ``shed`` rows verify green under both packages' ``verify_records``; a
  tampered row diverges at its seq in both.
- **The chaos drill** (``tools/loadgen.run_chaos``): zero hangs, named
  failures only, every array exact.  No wall-time floor: goodput is
  reported, never asserted (ROADMAP Queue C, reference state 3).
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import pytest

import cekirdekler_tpu
from cekirdekler_tpu.core import NumberCruncher as RefCruncher
from cekirdekler_tpu.errors import FusedBatchError as RefFusedBatchError
from cekirdekler_tpu.hardware import platforms as ref_platforms
from cekirdekler_tpu.obs.decisions import DECISIONS as REF_DECISIONS
from cekirdekler_tpu.obs.replay import verify_records as ref_verify_records
from cekirdekler_tpu.serve import resilience as ref_res
from cekirdekler_tpu.utils.faultinject import FAULTS as REF_FAULTS
import cekirdekler_tpu.serve as ref_serve
import cekirdekler_tpu_torch as ck
import cekirdekler_tpu_torch.serve as serve
from cekirdekler_tpu_torch.errors import CekirdeklerError, FusedBatchError, InjectedFaultError
from cekirdekler_tpu_torch.metrics.registry import REGISTRY
from cekirdekler_tpu_torch.obs.decisions import DECISIONS
from cekirdekler_tpu_torch.obs.flight import FLIGHT
from cekirdekler_tpu_torch.obs.replay import verify_records
from cekirdekler_tpu_torch.serve import (
    AdmissionController,
    BreakerBoard,
    ResilienceConfig,
    RetryBudgets,
    ServeFrontend,
    ServeJob,
    ServeRejected,
    TenantQuota,
    admit_decision,
    breaker_admit,
    breaker_transition,
    brownout_transition,
    containment_plan,
    retry_decision,
)
from cekirdekler_tpu_torch.serve import resilience as res
from cekirdekler_tpu_torch.serve.admission import (
    REJECT_BREAKER,
    REJECT_BROWNOUT,
    REJECT_HEALTH,
    REJECT_QUEUE,
    REJECT_QUOTA,
)
from cekirdekler_tpu_torch.serve.resilience import (
    BREAKER_CLOSED,
    BREAKER_HALF_OPEN,
    BREAKER_OPEN,
    breaker_init,
)
from cekirdekler_tpu_torch.utils.faultinject import FAULTS
from tests.test_torch_metrics import restore_planes, save_planes

INC = """
__kernel void inc(__global float* a) {
    int i = get_global_id(0);
    a[i] = a[i] + 1.0f;
}
"""


@pytest.fixture(autouse=True)
def _planes():
    saved = save_planes()
    FAULTS.disarm()
    REF_FAULTS.disarm()
    yield
    restore_planes(saved)


class Side:
    """One package's serving surface, so one script drives both."""

    def __init__(self, port: bool):
        self.port = port
        if port:
            self.serve, self.ClArray, self.DECISIONS, self.FAULTS = \
                serve, ck.ClArray, DECISIONS, FAULTS
            self.FusedBatchError, self.Injected = FusedBatchError, InjectedFaultError
        else:
            from cekirdekler_tpu.errors import InjectedFaultError as RefInjected

            self.serve, self.ClArray, self.DECISIONS, self.FAULTS = \
                ref_serve, cekirdekler_tpu.ClArray, REF_DECISIONS, REF_FAULTS
            self.FusedBatchError, self.Injected = RefFusedBatchError, RefInjected

    def cruncher(self, lanes: int = 2):
        if self.port:
            return ck.NumberCruncher(ck.all_devices().cpus(lanes), INC)
        return RefCruncher(ref_platforms().cpus().subset(lanes), INC)

    def mk(self, n: int = 1024, lanes: int = 2, **fe_kw):
        cr = self.cruncher(lanes)
        x = self.ClArray(np.zeros(n, np.float32), name="rx")
        x.partial_read = True
        job = self.serve.ServeJob(params=[x], kernels=["inc"], compute_id=800,
                                  global_range=n, local_range=64)
        rc = fe_kw.pop("rc", None)
        if rc is not None:
            fe_kw["resilience"] = self.serve.ResilienceConfig(**rc)
        fe = self.serve.ServeFrontend(cr, autostart=False, name="resil", **fe_kw)
        return cr, x, job, fe


SIDES = [Side(True), Side(False)]
BOTH = pytest.mark.parametrize("side", SIDES, ids=["port", "reference"])


def _mk(devs=None, n=1024, lanes=2, **fe_kw):
    return SIDES[0].mk(n, lanes, **fe_kw)


def _outcome(f) -> tuple:
    """A settled future as (ok, error type, error text without the
    package's module path)."""
    e = f.exception(timeout=30)
    if e is None:
        return ("ok", None)
    return ("failed", type(e).__name__, str(e))


def _rows(log, kinds) -> list:
    return [(r.kind, r.inputs, r.outputs) for r in log.snapshot() if r.kind in kinds]


# -- the contract and the pure machines ---------------------------------------


def test_the_module_s_contract_is_the_reference_s():
    assert res.__all__ == ref_res.__all__
    for name in ("BREAKER_INVARIANTS", "SHED_INVARIANTS", "RETRY_INVARIANTS",
                 "MODEL_INVARIANTS", "BREAKER_CLOSED", "BREAKER_OPEN", "BREAKER_HALF_OPEN",
                 "_HINT_FLOOR_S"):
        assert getattr(res, name) == getattr(ref_res, name), name
    assert ResilienceConfig().__dict__ == ref_res.ResilienceConfig().__dict__


def _breaker_state(rng) -> dict:
    st = str(rng.choice([BREAKER_CLOSED, BREAKER_OPEN, BREAKER_HALF_OPEN]))
    return {"state": st, "failures": int(rng.integers(0, 6)),
            "probe_inflight": bool(rng.random() < 0.5),
            "opened_t": (None if st == BREAKER_CLOSED and rng.random() < 0.7
                         else float(rng.uniform(0, 5)))}


@pytest.mark.parametrize("seed", range(4))
def test_the_breaker_equals_the_reference_s(seed):
    rng = np.random.default_rng(seed)
    actions = set()
    for _ in range(600):
        st = _breaker_state(rng)
        now = float(rng.uniform(0, 8))
        thr, open_s = int(rng.integers(1, 5)), float(rng.choice([0.05, 0.5, 1.0, 2.0]))
        ev = str(rng.choice(["success", "failure"]))
        mine = breaker_transition(st, ev, now, thr, open_s)
        assert mine == ref_res.breaker_transition(st, ev, now, thr, open_s)
        got = breaker_admit(st, now, open_s)
        assert got == ref_res.breaker_admit(st, now, open_s)
        actions |= {mine["action"], got["action"]}
    assert actions == {None, "opened", "closed", "reopened", "half-open"}


@pytest.mark.parametrize("seed", range(3))
def test_brownout_retry_and_containment_equal_the_reference_s(seed):
    rng = np.random.default_rng(10 + seed)
    refusals = set()
    for _ in range(600):
        st = {"active": bool(rng.random() < 0.5), "streak": int(rng.integers(0, 4))}
        args = (int(rng.integers(0, 12)), int(rng.integers(1, 10)), int(rng.integers(1, 8)),
                int(rng.integers(0, 3)), int(rng.integers(0, 3)))
        es = int(rng.integers(1, 4))
        assert brownout_transition(st, *args, engage_streak=es) == \
            ref_res.brownout_transition(st, *args, engage_streak=es)
        rargs = (int(rng.integers(0, 5)), int(rng.integers(0, 4)),
                 float(rng.choice([0.0, 0.5, 1.0, 3.5])),
                 (None if rng.random() < 0.5 else float(rng.uniform(0, 0.05))),
                 float(rng.choice([0.0, 0.005, 0.02, 0.05])),
                 float(rng.choice([0.0, 0.08, 0.1])),
                 float(rng.random()))
        rd = retry_decision(*rargs)
        assert rd == ref_res.retry_decision(*rargs)
        refusals.add(rd["reason"])
        k, leaf = int(rng.integers(-2, 70)), int(rng.integers(0, 6))
        assert containment_plan(k, leaf) == ref_res.containment_plan(k, leaf)
    assert refusals == {None, "attempts-exhausted", "budget-exhausted", "deadline"}


def test_breaker_lifecycle_pure():
    st = breaker_init()
    for k in range(4):
        r = breaker_transition(st, "failure", float(k), 5, 1.0)
        st = r["state"]
        assert st["state"] == BREAKER_CLOSED and r["action"] is None
    r = breaker_transition(st, "failure", 4.0, 5, 1.0)
    st = r["state"]
    assert st["state"] == BREAKER_OPEN and r["action"] == "opened"
    a = breaker_admit(st, 4.25, 1.0)
    assert a["allow"] is False and a["retry_after_s"] == pytest.approx(0.75)
    a = breaker_admit(st, 5.5, 1.0)
    assert a["allow"] is True and a["probe"] is True
    st = a["state"]
    assert st["state"] == BREAKER_HALF_OPEN
    assert breaker_admit(st, 5.6, 1.0)["allow"] is False
    r = breaker_transition(st, "success", 5.7, 5, 1.0)
    assert r["state"]["state"] == BREAKER_CLOSED and r["action"] == "closed"
    r = breaker_transition(st, "failure", 5.7, 5, 1.0)
    assert r["state"]["state"] == BREAKER_OPEN and r["action"] == "reopened"
    st = breaker_init()
    st = breaker_transition(st, "failure", 0.0, 2, 1.0)["state"]
    st = breaker_transition(st, "success", 0.1, 2, 1.0)["state"]
    st = breaker_transition(st, "failure", 0.2, 2, 1.0)["state"]
    assert st["state"] == BREAKER_CLOSED


def test_breaker_open_rearm_past_window_pure():
    st = breaker_init()
    for k in range(2):
        st = breaker_transition(st, "failure", float(k), 2, 1.0)["state"]
    assert st["state"] == BREAKER_OPEN and st["opened_t"] == 1.0
    r = breaker_transition(st, "failure", 1.5, 2, 1.0)
    assert r["action"] is None and r["state"]["opened_t"] == 1.0
    r = breaker_transition(st, "failure", 2.5, 2, 1.0)
    assert r["action"] == "reopened" and r["state"]["opened_t"] == 2.5


def test_brownout_hysteresis_pure():
    st = {"active": False, "streak": 0}
    r = brownout_transition(st, 10, 8, 4, 0, 0, engage_streak=2)
    assert r["active"] is False and r["streak"] == 1 and r["pressure"]
    r = brownout_transition(r, 10, 8, 4, 0, 0, engage_streak=2)
    assert r["active"] is True and r["changed"] is True
    assert brownout_transition({"active": False, "streak": 0}, 0, 8, 4, 3, 1,
                               engage_streak=2)["pressure"] is False
    assert brownout_transition({"active": False, "streak": 0}, 5, 8, 4, 1, 0,
                               engage_streak=2)["pressure"] is True
    r = brownout_transition(r, 0, 8, 4, 0, 0, engage_streak=2)
    assert r["active"] is True and r["streak"] == 1
    r = brownout_transition(r, 0, 8, 4, 0, 0, engage_streak=2)
    assert r["active"] is False and r["changed"] is True


def test_retry_decision_pure():
    a = retry_decision(0, 2, 5.0, None, 0.01, 0.08, 0.5)
    assert a == retry_decision(0, 2, 5.0, None, 0.01, 0.08, 0.5)
    assert a["retry"] is True and a["delay_s"] == pytest.approx(0.01)
    assert retry_decision(4, 9, 5.0, None, 0.01, 0.08, 0.999)["delay_s"] <= 1.5 * 0.08
    assert retry_decision(2, 2, 5.0, None, 0.01, 0.08, 0.0)["reason"] == "attempts-exhausted"
    assert retry_decision(0, 2, 0.5, None, 0.01, 0.08, 0.0)["reason"] == "budget-exhausted"
    assert retry_decision(0, 2, 5.0, 0.001, 0.01, 0.08, 0.0)["reason"] == "deadline"


def test_containment_plan_pure():
    assert containment_plan(8) == {"mode": "bisect", "parts": [4, 4]}
    assert containment_plan(7) == {"mode": "bisect", "parts": [4, 3]}
    assert containment_plan(1) == {"mode": "per-request", "parts": [1]}
    assert containment_plan(3, leaf=4) == {"mode": "per-request", "parts": [1, 1, 1]}
    for k in range(1, 40):
        assert sum(containment_plan(k)["parts"]) == k


def test_admit_decision_breaker_and_brownout_gates():
    kw = dict(tenant_inflight=0, quota=4, queue_depth=0, max_queue_depth=8, healthy=True,
              est_batch_s=0.02)
    d = admit_decision(**dict(kw, breaker_open=True, breaker_retry_after_s=0.7,
                              queue_depth=99, tenant_inflight=99, brownout=True))
    assert d["reason"] == REJECT_BREAKER and d["retry_after_s"] == pytest.approx(0.7)
    assert admit_decision(**dict(kw, breaker_open=True, healthy=False))["reason"] == \
        REJECT_HEALTH
    assert admit_decision(**dict(kw, queue_depth=8, brownout=True,
                                 tenant_inflight=2))["reason"] == REJECT_QUEUE
    d = admit_decision(**dict(kw, brownout=True, tenant_inflight=2))
    assert d["reason"] == REJECT_BROWNOUT and d["retry_after_s"] >= 0.005
    assert admit_decision(**dict(kw, brownout=True, tenant_inflight=0))["admit"] is True
    assert admit_decision(**dict(kw, brownout=True, tenant_inflight=1,
                                 priority=0))["reason"] == REJECT_BROWNOUT
    assert admit_decision(**dict(kw, brownout=True, tenant_inflight=0,
                                 priority=0))["admit"] is True
    assert admit_decision(**dict(kw, tenant_inflight=4))["reason"] == REJECT_QUOTA


# -- the stateful wrappers, step by step --------------------------------------


def _board_script(board_cls, log, seed: int) -> list:
    rng = np.random.default_rng(seed)
    board = board_cls(threshold=int(rng.integers(1, 4)),
                      open_s=float(rng.choice([0.2, 1.0])), name="steps")
    keys = [("tA", ("sig",), 1), ("tB", ("sig",), 2), ("lane", 0), ("lane", 1)]
    out = []
    log.clear()
    now = 0.0
    for _ in range(150):
        now += float(rng.choice([0.0, 0.05, 0.3]))
        key = keys[int(rng.integers(0, len(keys)))]
        op = rng.random()
        if op < 0.4:
            out.append(("admit", board.admit(key, now)))
        elif op < 0.85:
            out.append(("note", board.note(key, str(rng.choice(["success", "failure"])), now)))
        elif op < 0.9:
            board.release_probe(key)
        else:
            out.append(("open", board.open_count(now)))
        out.append(board.snapshot())
    return out


@pytest.mark.parametrize("seed", range(3))
def test_breaker_board_step_by_step_equals_the_reference_s(seed):
    mine = _board_script(BreakerBoard, DECISIONS, seed)
    p_rows = _rows(DECISIONS, ("breaker",))
    ref = _board_script(ref_res.BreakerBoard, REF_DECISIONS, seed)
    r_rows = _rows(REF_DECISIONS, ("breaker",))
    assert mine == ref
    assert p_rows == r_rows and p_rows
    assert verify_records([dict(seq=k + 1, kind=k_, inputs=i, outputs=o)
                           for k, (k_, i, o) in enumerate(p_rows)])["ok"]


def test_retry_budgets_step_by_step_equal_the_reference_s():
    rng = np.random.default_rng(5)
    mine, ref = RetryBudgets(cap=3.0, ratio=0.25), ref_res.RetryBudgets(cap=3.0, ratio=0.25)
    for _ in range(300):
        t = f"t{int(rng.integers(0, 3))}"
        op = rng.integers(0, 3)
        for b in (mine, ref):
            if op == 0:
                b.spend(t)
            elif op == 1:
                b.note_success(t)
        assert mine.tokens(t) == ref.tokens(t)
        assert mine.snapshot() == ref.snapshot()


# -- FusedBatchError: the structured per-window failure cause -----------------


def _clean_failure_script(side) -> list:
    cr = side.cruncher(2)
    x = side.ClArray(np.zeros(1024, np.float32), name="fb")
    x.partial_read = True
    out = []
    try:
        cr.enqueue_mode = True
        side.FAULTS.arm("driver-submit:times=1")
        with pytest.raises(side.FusedBatchError) as ei:
            cr.cores.compute_fused_batch(["inc"], [x], 800, 1024, 64, 8)
        e = ei.value
        out.append((e.clean, e.applied_iters, e.requested_iters, e.cause,
                    isinstance(e.original, side.Injected)))
        side.FAULTS.disarm()
        cr.cores.barrier()
        cr.cores.flush()
        out.append(np.asarray(x).copy().tobytes())
        side.FAULTS.arm("driver-submit:after=4,times=1")
        with pytest.raises(side.FusedBatchError) as ei:
            cr.cores.compute_fused_batch(["inc"], [x], 800, 1024, 64, 8)
        e = ei.value
        out.append((e.clean, e.applied_iters, e.requested_iters, e.cause))
        side.FAULTS.disarm()
        cr.cores.barrier()
        cr.cores.flush()
        out.append(np.asarray(x).copy().tobytes())
    finally:
        side.FAULTS.disarm()
        cr.dispose()
    return out


def test_compute_fused_batch_surfaces_clean_failure_as_the_reference_does():
    mine = _clean_failure_script(SIDES[0])
    assert mine[0] == (True, 0, 8, "injected:driver-submit", True)
    assert np.frombuffer(mine[1], np.float32)[0] == 0.0
    assert mine[2] == (True, 2, 8, "injected:driver-submit")
    assert np.all(np.frombuffer(mine[3], np.float32) == 2.0)
    assert mine == _clean_failure_script(SIDES[1])


# -- blast-radius containment, retries and breakers through the frontend ------


def _contain_script(side, plan: str, n_req: int, rc: dict | None = None,
                    tenant: str = "tA") -> dict:
    cr, x, job, fe = side.mk(rc=rc)
    side.DECISIONS.clear()
    try:
        futs = [fe.submit(tenant, job) for _ in range(n_req)]
        side.FAULTS.arm(plan)
        out = fe.step()
        fired = side.FAULTS.snapshot()["clauses"][0]["fired"]
        side.FAULTS.disarm()
        outcomes = [_outcome(f) for f in futs]
        return {"step": {k: out[k] for k in ("batches", "requests", "failed", "requeued")},
                "outcomes": outcomes, "fired": fired,
                "x": np.asarray(x).copy().tobytes(),
                "rows": [(k, {a: b for a, b in i.items() if a not in ("rid", "rids")}, o)
                         for k, i, o in _rows(side.DECISIONS,
                                              ("breaker", "retry", "containment", "shed"))],
                "row_dicts": [r.to_row() for r in side.DECISIONS.snapshot()
                              if r.kind in ("breaker", "retry", "containment", "shed")],
                "snap": fe.stats()["resilience"]["breakers"]}
    finally:
        side.FAULTS.disarm()
        fe.close()
        cr.dispose()


def _same_but_times(a: dict, b: dict) -> None:
    """The two runs agree on every outcome; the breaker rows' clock
    readings (``now``, ``opened_t``) are each run's own."""
    assert a["step"] == b["step"] and a["outcomes"] == b["outcomes"]
    assert a["fired"] == b["fired"] and a["x"] == b["x"]

    def clockless(rows):
        out = []
        for kind, inp, outp in rows:
            inp = {k: v for k, v in inp.items() if k not in ("now", "deadline_left_s")}
            inp.pop("state", None)
            outp = {k: v for k, v in outp.items() if k != "state"}
            out.append((kind, inp, outp))
        return out

    assert clockless(a["rows"]) == clockless(b["rows"])


def test_containment_recovers_transient_fault_bit_exact():
    mine = _contain_script(SIDES[0], "driver-submit:times=1", 8)
    assert mine["step"]["requests"] == 8 and mine["step"]["failed"] == 0
    assert all(o == ("ok", None) for o in mine["outcomes"])
    np.testing.assert_array_equal(np.frombuffer(mine["x"], np.float32), 8.0)
    evs = [e for e in FLIGHT.snapshot() if e.kind == "serve-contain"]
    assert any(e.fields.get("outcome") == "bisect" for e in evs)
    _same_but_times(mine, _contain_script(SIDES[1], "driver-submit:times=1", 8))


def test_containment_isolates_exactly_the_faulty_request():
    m0 = REGISTRY.counter("ck_serve_contained_total",
                          "fused-batch failures handled by blast-radius containment",
                          outcome="isolated").value
    mine = _contain_script(SIDES[0], "serve-dispatch:times=4", 8, rc={"retry_max_attempts": 0})
    assert mine["step"]["requests"] == 8 and mine["step"]["failed"] == 1
    failed = [o for o in mine["outcomes"] if o[0] == "failed"]
    assert len(failed) == 1 and failed[0][1] == "InjectedFaultError"
    assert "serve-dispatch" in failed[0][2]
    np.testing.assert_array_equal(np.frombuffer(mine["x"], np.float32), 7.0)
    assert REGISTRY.counter("ck_serve_contained_total",
                            "fused-batch failures handled by blast-radius containment",
                            outcome="isolated").value - m0 == 1
    _same_but_times(mine, _contain_script(SIDES[1], "serve-dispatch:times=4", 8,
                                          rc={"retry_max_attempts": 0}))


def test_retry_budget_contains_flaky_faults_p_mode():
    """A seeded probabilistic serve-dispatch fault: the retry budget
    re-dispatches isolated failures, the workload stays bit-exact, and the
    reference makes the same draws, retries and outcomes."""
    m_retries = REGISTRY.counter(
        "ck_serve_retries_total",
        "serve request re-dispatch attempts granted by the retry budget")
    r0 = m_retries.value
    plan = "seed=2;serve-dispatch:p=0.6,times=12"
    mine = _contain_script(SIDES[0], plan, 12)
    assert mine["fired"] > 0
    ok = sum(1 for o in mine["outcomes"] if o[0] == "ok")
    assert all(o[1] == "InjectedFaultError" for o in mine["outcomes"] if o[0] == "failed")
    np.testing.assert_array_equal(np.frombuffer(mine["x"], np.float32), float(ok))
    assert m_retries.value > r0
    _same_but_times(mine, _contain_script(SIDES[1], plan, 12))


@BOTH
def test_containment_decisions_replay_in_both_packages_and_tamper(side):
    out = _contain_script(side, "serve-dispatch:times=3", 4,
                          rc={"retry_max_attempts": 0, "breaker_threshold": 1,
                              "breaker_open_s": 0.05})
    assert sum(1 for o in out["outcomes"] if o[0] == "failed") == 1
    rows = json.loads(json.dumps(out["row_dicts"]))
    assert {"containment", "retry", "breaker"} <= {r["kind"] for r in rows}
    for verify in (verify_records, ref_verify_records):
        verdict = verify(rows)
        assert verdict["ok"] is True and verdict["replayed"] == len(rows), verdict
    for kind, field in (("breaker", ("state", "failures")), ("retry", ("reason",)),
                        ("containment", ("mode",))):
        bad = json.loads(json.dumps(next(r for r in rows if r["kind"] == kind)))
        tgt = bad["outputs"]
        for f in field[:-1]:
            tgt = tgt[f]
        tgt[field[-1]] = (tgt[field[-1]] + 1) if isinstance(tgt[field[-1]], int) else "tampered"
        for verify in (verify_records, ref_verify_records):
            v2 = verify([bad])
            assert v2["ok"] is False and v2["first_divergence"]["seq"] == bad["seq"]


def test_breaker_opens_rejects_probes_and_recovers():
    cr, x, job, fe = _mk(rc={"retry_max_attempts": 0, "breaker_threshold": 2,
                             "breaker_open_s": 0.2})
    try:
        futs = [fe.submit("tB", job) for _ in range(2)]
        FAULTS.arm("serve-dispatch:times=8")
        fe.step()
        FAULTS.disarm()
        assert all(isinstance(f.exception(timeout=30), InjectedFaultError) for f in futs)
        with pytest.raises(ServeRejected) as ei:
            fe.submit("tB", job)
        assert ei.value.reason == REJECT_BREAKER and 0.0 < ei.value.retry_after_s <= 0.2
        f_ok = fe.submit("tC", job)
        fe.step()
        assert f_ok.exception(timeout=30) is None
        time.sleep(0.25)
        f_probe = fe.submit("tB", job)
        fe.step()
        assert f_probe.exception(timeout=30) is None
        f2 = fe.submit("tB", job)
        fe.step()
        assert f2.exception(timeout=30) is None
        np.testing.assert_array_equal(np.asarray(x), 3.0)
    finally:
        FAULTS.disarm()
        fe.close()
        cr.dispose()


def _brownout_script(side) -> list:
    cr, x, job, fe = side.mk(
        admission=side.serve.AdmissionController(max_queue_depth=8, default_quota=4),
        rc={"brownout_engage_streak": 1})
    fe.admission.set_quota("low", side.serve.TenantQuota(max_inflight=4, priority=0))
    out = []
    side.DECISIONS.clear()

    def submit(t):
        try:
            return fe.submit(t, job)
        except side.serve.ServeRejected as e:
            out.append((t, e.reason, e.retry_after_s >= 0.005))
            return None

    try:
        futs = [submit(t) for t in ("tA", "tA", "tA", "tB", "tB", "tB")]
        out.append(fe._evaluate_brownout())
        submit("tA")
        futs.append(submit("tFresh"))
        fe.step()
        out.append([_outcome(f) for f in futs])
        out.append(fe._brownout_active)
        f_low = submit("low")
        submit("low")
        fe.step()
        out.append(_outcome(f_low))
        out.append(fe._evaluate_brownout())
        out.append(fe._brownout_active)
        fe.submit("tA", job)
        fe.step()
        out.append(np.asarray(x).copy().tobytes())
        out.append([(r.kind, r.inputs, r.outputs) for r in side.DECISIONS.snapshot()
                    if r.kind == "shed"])
        return out
    finally:
        fe.close()
        cr.dispose()


def test_brownout_sheds_over_quota_but_never_starves_as_the_reference_does():
    mine = _brownout_script(SIDES[0])
    assert mine[0]["active"] is True
    assert mine[1] == ("tA", REJECT_BROWNOUT, True)
    assert all(o == ("ok", None) for o in mine[2])
    assert mine[3] is True  # drained, still engaged until an all-clear evaluation
    assert mine[4] == ("low", REJECT_BROWNOUT, True) and mine[5] == ("ok", None)
    assert mine[6]["active"] is False and mine[7] is False
    np.testing.assert_array_equal(np.frombuffer(mine[8], np.float32), 9.0)
    assert len(mine[9]) == 2
    assert verify_records([dict(seq=k + 1, kind=a, inputs=b, outputs=c)
                           for k, (a, b, c) in enumerate(mine[9])])["ok"]
    assert mine == _brownout_script(SIDES[1])


def test_brownout_releases_while_idle():
    cr, x, job, fe = _mk(admission=AdmissionController(max_queue_depth=8, default_quota=4),
                         rc={"brownout_engage_streak": 1})
    try:
        futs = [fe.submit(t, job) for t in ("tA", "tA", "tA", "tB", "tB", "tB")]
        assert fe._evaluate_brownout()["active"] is True
        fe.step()
        for f in futs:
            assert f.exception(timeout=30) is None
        assert fe._brownout_active is True
        fe.start()  # the idle dispatcher runs the release evaluation itself
        deadline = time.perf_counter() + 10.0
        while fe._brownout_active and time.perf_counter() < deadline:
            time.sleep(0.02)
        assert fe._brownout_active is False
    finally:
        fe.close()
        cr.dispose()


@BOTH
def test_cancelled_future_cannot_kill_the_cycle(side):
    cr, x, job, fe = side.mk()
    try:
        futs = [fe.submit("tA", job) for _ in range(4)]
        assert futs[1].cancel() is True
        assert fe.step()["requests"] == 4
        for i, f in enumerate(futs):
            assert f.cancelled() if i == 1 else f.exception(timeout=30) is None
        np.testing.assert_array_equal(np.asarray(x), 4.0)
        assert fe.stats()["resilience"]["dead"] is None
    finally:
        fe.close()
        cr.dispose()


def _requeue_script(side) -> tuple:
    cr, x, job, fe = side.mk(rc={"retry_max_attempts": 4, "retry_base_s": 0.02,
                                 "retry_cap_s": 0.1, "retry_inline_budget_s": 0.0})
    try:
        futs = [fe.submit("tA", job) for _ in range(4)]
        side.FAULTS.arm("serve-dispatch:times=3")
        out = fe.step()
        side.FAULTS.disarm()
        pending = fe._pending
        out2 = fe.step()
        return (out["requeued"], pending, out2["requeued"], [_outcome(f) for f in futs],
                np.asarray(x).copy().tobytes())
    finally:
        side.FAULTS.disarm()
        fe.close()
        cr.dispose()


def test_retry_past_inline_budget_requeues_to_next_cycle_as_the_reference_does():
    mine = _requeue_script(SIDES[0])
    assert mine[0] >= 1 and mine[1] >= 1 and mine[2] == 0
    assert all(o == ("ok", None) for o in mine[3])
    np.testing.assert_array_equal(np.frombuffer(mine[4], np.float32), 4.0)
    assert mine == _requeue_script(SIDES[1])


def test_cycle_crash_settles_popped_requests_named():
    cr, x, job, fe = _mk()
    real_note_done = fe.tenants.note_done
    try:
        futs = [fe.submit("tA", job) for _ in range(3)]

        def boom(*a, **kw):
            raise RuntimeError("resolution boom")

        fe.tenants.note_done = boom
        with pytest.raises(RuntimeError, match="resolution boom"):
            fe.step()
        for f in futs:
            exc = f.exception(timeout=10)
            assert isinstance(exc, CekirdeklerError) and "dispatch cycle failed" in str(exc)
    finally:
        fe.tenants.note_done = real_note_done
        fe.close(drain=False)
        cr.dispose()


def test_dispatcher_crash_fails_futures_and_rejects_submits(tmp_path, monkeypatch):
    monkeypatch.setenv("CK_POSTMORTEM_DIR", str(tmp_path))
    cr = ck.NumberCruncher(ck.all_devices().cpus(2), INC)
    x = ck.ClArray(np.zeros(512, np.float32), name="cx")
    x.partial_read = True
    job = ServeJob(params=[x], kernels=["inc"], compute_id=801, global_range=512,
                   local_range=64)
    fe = ServeFrontend(cr, name="crash")
    m_crashes = REGISTRY.counter(
        "ck_serve_dispatcher_crashes_total",
        "serve dispatcher threads lost to an escaping exception "
        "(in-flight futures failed with the named error)")
    c0 = m_crashes.value
    try:
        fe.step = lambda: (_ for _ in ()).throw(RuntimeError("boom"))
        fut = fe.submit("tA", job)
        with pytest.raises(CekirdeklerError, match="dispatcher died"):
            fut.result(timeout=10)
        with pytest.raises(CekirdeklerError, match="dispatcher died"):
            fe.submit("tA", job)
        assert m_crashes.value == c0 + 1
        assert fe.stats()["resilience"]["dead"] is not None
        with pytest.raises(CekirdeklerError, match="create a new frontend"):
            fe.start()
        assert any(f.startswith("ck_postmortem") for f in os.listdir(tmp_path))
    finally:
        fe.close(drain=False)
        cr.dispose()


def test_close_races_inflight_retry_16_threads_no_dispatch_after_halt():
    cr, x, job, fe = _mk(rc={"retry_max_attempts": 2, "retry_base_s": 0.02,
                             "retry_cap_s": 0.08})
    dispatches = [0]
    last_dispatch_t = [0.0]
    real = cr.cores.compute_fused_batch

    def counting(*a, **kw):
        dispatches[0] += 1
        last_dispatch_t[0] = time.perf_counter()
        return real(*a, **kw)

    cr.cores.compute_fused_batch = counting
    futs = []
    mu = threading.Lock()

    def client():
        try:
            f = fe.submit("tA", job)
            with mu:
                futs.append(f)
        except CekirdeklerError:
            pass

    try:
        FAULTS.arm("serve-dispatch:times=1000")
        threads = [threading.Thread(target=client) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        stepper = threading.Thread(target=lambda: fe.step())
        stepper.start()
        time.sleep(0.05)
        fe.close(drain=False)
        halt_t = time.perf_counter()
        stepper.join(30)
        assert not stepper.is_alive()
        for f in futs:
            exc = f.exception(timeout=10)
            if exc is not None:
                assert isinstance(exc, CekirdeklerError), exc
        n_at_close = dispatches[0]
        time.sleep(0.2)
        assert dispatches[0] == n_at_close and last_dispatch_t[0] <= halt_t
    finally:
        FAULTS.disarm()
        cr.cores.compute_fused_batch = real
        fe.close(drain=False)
        cr.dispose()


# -- the chaos drill -----------------------------------------------------------


@pytest.mark.parametrize("plan", ["reference", "serve-dispatch"])
def test_chaos_drill_32_clients_no_hang_named_and_exact(plan):
    """The seeded chaos plans under a 32-client mixed-tenant coalesced
    workload: zero hung futures, named failures only, every array exact
    under faults and in the control run.  Goodput is reported, never
    asserted here (six test workers share this host)."""
    from cekirdekler_tpu_torch.tools import loadgen

    p = loadgen.CHAOS_PLAN if plan == "reference" else loadgen.SERVE_CHAOS_PLAN
    out = loadgen.run_chaos(ck.all_devices().cpus(2), clients=32, tenants=4, signatures=4,
                            requests_per_client=4, n=4096, plan=p, goodput_floor=0.0)
    brief = {k: v for k, v in out["chaos"].items() if k != "anatomy"}
    assert out["fired"] > 0, brief
    assert out["hangs"] == 0 and out["unnamed_failures"] == 0, brief
    assert out["chaos"]["checked"] is True and out["control"]["checked"] is True, brief
    assert out["control"]["completed"] == 128 and out["control"]["failed"] == 0
    assert out["chaos"]["completed"] + out["chaos"]["failed"] + \
        out["chaos"]["retries_exhausted"] == 128
    assert set(out["failure_causes"]) <= {"InjectedFaultError", "CekirdeklerError"}
    assert out["goodput_frac"] is not None and out["checked"] is True


def test_the_plans_fire_the_same_way_in_both_packages():
    """The seeded plan's draws are the reference's: the same sequence of
    fire decisions at the same point."""
    for plan in ("seed=2;serve-dispatch:p=0.6,times=12", "seed=7;serve-dispatch:p=0.3,times=24"):
        seqs = []
        for F, E in ((FAULTS, InjectedFaultError), (REF_FAULTS, Exception)):
            F.arm(plan)
            seq = []
            for _ in range(60):
                try:
                    F.raise_if_fired("serve-dispatch", where="x")
                    seq.append(0)
                except E:
                    seq.append(1)
            F.disarm()
            seqs.append(seq)
        assert seqs[0] == seqs[1] and sum(seqs[0]) > 0
