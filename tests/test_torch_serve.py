"""The port's serving tier (``cekirdekler_tpu_torch/serve/``) against the
reference's: admission, coalescing, tenants and the frontend, on host lanes.

- **The pure functions.**  Seeded sweeps of ``admit_decision``,
  ``brownout_share`` and ``plan_coalesce`` through both packages give
  identical outputs; the reference's pinned cases hold in the port.
- **The controllers, step by step.**  ``AdmissionController`` and
  ``TenantTable`` run the same event sequences in both packages; their
  verdicts, snapshots and decision records are equal field for field (the
  records' ``seq``, ``t`` and ``epoch`` aside).
- **The frontend.**  The reference's ``tests/test_serve.py`` cases run
  through the port's ``ServeFrontend`` over ``Cores.compute_fused_batch``
  on host lanes; where the outcome is deterministic (the ``autostart=False``
  seam, one ``step()`` a cycle) the same script runs through both packages
  and gives bit-equal arrays, equal result records, equal plans and equal
  rejections.
- **Replay across packages.**  ``admission`` and ``coalesce`` rows a
  frontend records in either package verify green under both packages'
  ``verify_records``, and a tampered row diverges at its seq in both.

The ``inc`` kernel adds exactly 1.0f, so every lost or duplicated request
shows as an integer-sized error.  No test asserts a time.
"""

from __future__ import annotations

import json
import threading
import urllib.request

import numpy as np
import pytest

import cekirdekler_tpu
from cekirdekler_tpu.core import NumberCruncher as RefCruncher
from cekirdekler_tpu.hardware import platforms as ref_platforms
from cekirdekler_tpu.obs.decisions import DECISIONS as REF_DECISIONS
from cekirdekler_tpu.obs.replay import verify_records as ref_verify_records
from cekirdekler_tpu.serve import admission as ref_admission
from cekirdekler_tpu.serve import coalescer as ref_coalescer
from cekirdekler_tpu.serve import tenants as ref_tenants
import cekirdekler_tpu.serve as ref_serve
import cekirdekler_tpu_torch as ck
import cekirdekler_tpu_torch.serve as serve
from cekirdekler_tpu_torch.errors import ComputeValidationError
from cekirdekler_tpu_torch.metrics.registry import REGISTRY
from cekirdekler_tpu_torch.obs.decisions import DECISIONS
from cekirdekler_tpu_torch.obs.replay import replay_record, verify_records
from cekirdekler_tpu_torch.serve import (
    AdmissionController,
    ServeFrontend,
    ServeJob,
    ServeRejected,
    TenantTable,
    admit_decision,
    plan_coalesce,
    servez_payload,
)
from cekirdekler_tpu_torch.serve import admission, coalescer, tenants
from cekirdekler_tpu_torch.serve.admission import (
    REJECT_HEALTH,
    REJECT_QUEUE,
    REJECT_QUOTA,
    brownout_share,
)
from tests.test_torch_metrics import restore_planes, save_planes

INC = """
__kernel void inc(__global float* a) {
    int i = get_global_id(0);
    a[i] = a[i] + 1.0f;
}
__kernel void dbl(__global float* a) {
    int i = get_global_id(0);
    a[i] = a[i] * 1.001f;
}
"""


@pytest.fixture(autouse=True)
def _planes():
    saved = save_planes()
    yield
    restore_planes(saved)


class Side:
    """One package's serving surface, so one script drives both."""

    def __init__(self, port: bool):
        self.port = port
        if port:
            self.serve, self.ClArray, self.DECISIONS = serve, ck.ClArray, DECISIONS
        else:
            self.serve, self.ClArray = ref_serve, cekirdekler_tpu.ClArray
            self.DECISIONS = REF_DECISIONS

    def cruncher(self, lanes: int = 2, src: str = INC):
        if self.port:
            return ck.NumberCruncher(ck.all_devices().cpus(lanes), src)
        return RefCruncher(ref_platforms().cpus().subset(lanes), src)

    def mk(self, n: int = 1024, sigs: int = 1, lanes: int = 2):
        cr = self.cruncher(lanes)
        arrays, jobs = [], []
        for s in range(sigs):
            a = self.ClArray(np.zeros(n, np.float32), name=f"s{s}")
            a.partial_read = True
            arrays.append(a)
            jobs.append(self.serve.ServeJob(params=[a], kernels=["inc"], compute_id=700 + s,
                                            global_range=n, local_range=64))
        return cr, arrays, jobs


SIDES = [Side(True), Side(False)]
BOTH = pytest.mark.parametrize("side", SIDES, ids=["port", "reference"])


def _mk(n=1024, sigs=1, lanes=2):
    return SIDES[0].mk(n, sigs, lanes)


def _rows(log, kinds) -> list[tuple]:
    """(kind, inputs, outputs) of a log's rows of ``kinds``: the record
    without its seq and clocks."""
    return [(r.kind, r.inputs, r.outputs) for r in log.snapshot() if r.kind in kinds]


# -- the contract and the pure functions -------------------------------------


def test_the_modules_contracts_are_the_reference_s():
    for mine, ref in ((admission, ref_admission), (coalescer, ref_coalescer),
                      (tenants, ref_tenants)):
        assert mine.__all__ == ref.__all__
    assert serve.__all__ == ref_serve.__all__
    assert admission.MODEL_INVARIANTS == ref_admission.MODEL_INVARIANTS
    assert coalescer.MODEL_INVARIANTS == ref_coalescer.MODEL_INVARIANTS
    assert coalescer.STARVE_ROUNDS == ref_coalescer.STARVE_ROUNDS
    for name in ("REJECT_HEALTH", "REJECT_QUEUE", "REJECT_QUOTA", "REJECT_KERNEL",
                 "REJECT_BREAKER", "REJECT_BROWNOUT", "_RETRY_FLOOR_S"):
        assert getattr(admission, name) == getattr(ref_admission, name), name
    assert issubclass(ServeRejected, ck.errors.CekirdeklerError)
    e = ServeRejected("tX", REJECT_QUOTA, 0.25)
    r = ref_admission.ServeRejected("tX", REJECT_QUOTA, 0.25)
    assert (str(e), e.tenant, e.reason, e.retry_after_s) == \
        (str(r), r.tenant, r.reason, r.retry_after_s)


def _admit_inputs(rng) -> dict:
    quota = int(rng.integers(1, 9))
    breaker_open = bool(rng.random() < 0.2)
    return dict(
        tenant_inflight=int(rng.integers(0, 12)), quota=quota,
        queue_depth=int(rng.integers(0, 12)), max_queue_depth=int(rng.integers(1, 10)),
        healthy=bool(rng.random() < 0.85),
        est_batch_s=float(rng.choice([0.0, 1e-4, 0.004, 0.02, float(rng.random())])),
        kernel_unsafe=bool(rng.random() < 0.1),
        kernel_finding=rng.choice([None, "partial-read-halo", "write-overlap"]),
        breaker_open=breaker_open,
        breaker_retry_after_s=(float(rng.random()) if breaker_open and rng.random() < 0.8
                               else None),
        brownout=bool(rng.random() < 0.3),
        shed_quota=(int(rng.integers(0, quota + 1)) if rng.random() < 0.7 else None),
        priority=int(rng.integers(-1, 3)),
    )


@pytest.mark.parametrize("seed", range(4))
def test_admit_decision_equals_the_reference_s(seed):
    rng = np.random.default_rng(seed)
    reasons = set()
    for _ in range(500):
        kw = _admit_inputs(rng)
        mine = admit_decision(**kw)
        assert mine == ref_admission.admit_decision(**kw), kw
        reasons.add(mine["reason"])
    assert reasons == {None, "kernel-unsafe", "unhealthy", "circuit-open", "queue-depth",
                       "brownout", "tenant-quota"}


def test_brownout_share_equals_the_reference_s():
    for quota in range(0, 40):
        for frac in (0.0, 0.1, 0.25, 0.5, 0.75, 1.0, 1.5):
            assert brownout_share(quota, frac) == ref_admission.brownout_share(quota, frac)


def test_admit_decision_check_order_and_retry_after():
    """health gates first, then queue depth, then quota; retry-after is
    deterministic and scales with the batch-wall estimate."""
    kw = dict(tenant_inflight=0, quota=4, queue_depth=0,
              max_queue_depth=8, healthy=True, est_batch_s=0.02)
    assert admit_decision(**kw) == {"admit": True, "reason": None, "retry_after_s": None}
    d = admit_decision(**dict(kw, healthy=False, queue_depth=99, tenant_inflight=99))
    assert d["reason"] == REJECT_HEALTH
    assert d["retry_after_s"] == pytest.approx(0.08)
    d = admit_decision(**dict(kw, queue_depth=8, tenant_inflight=99))
    assert d["reason"] == REJECT_QUEUE
    d = admit_decision(**dict(kw, tenant_inflight=4))
    assert d["reason"] == REJECT_QUOTA
    assert d["retry_after_s"] == pytest.approx(0.02)
    assert admit_decision(**dict(kw, tenant_inflight=4)) == d


def _group(key, pending=1, deadline=None, age=0.0, starved=0):
    return {"key": key, "pending": pending, "deadline_in_s": deadline,
            "oldest_age_s": age, "starved_rounds": starved}


@pytest.mark.parametrize("seed", range(4))
def test_plan_coalesce_equals_the_reference_s(seed):
    rng = np.random.default_rng(100 + seed)
    promoted_seen = 0
    for _ in range(300):
        groups = [_group(f"g{k}-cid{int(rng.integers(0, 4))}",
                         pending=int(rng.integers(0, 4)),
                         deadline=(float(rng.uniform(-0.1, 1.0)) if rng.random() < 0.4
                                   else None),
                         age=float(rng.choice([0.0, 0.1, 0.5, float(rng.random())])),
                         starved=int(rng.integers(0, 6)))
                  for k in range(int(rng.integers(0, 7)))]
        rnd, mp = int(rng.integers(0, 50)), int(rng.integers(-1, 4))
        mine = plan_coalesce(groups, rnd, mp)
        assert mine == ref_coalescer.plan_coalesce(groups, rnd, mp)
        promoted_seen += bool(mine["promoted"])
    assert promoted_seen > 0


def test_plan_edf_then_age_then_key():
    plan = plan_coalesce([
        _group("a", age=0.5),
        _group("b", deadline=0.2, age=0.1),
        _group("c", deadline=0.1, age=0.1),
        _group("d", age=0.9),
    ], round_idx=0)
    assert plan["order"] == ["c", "b", "d", "a"]
    assert plan["picked"] == plan["order"]
    assert plan["promoted"] == []


def test_plan_fairness_promotion_and_rotation():
    groups = [_group("urgent", deadline=0.01), _group("x", starved=2), _group("y", starved=3)]
    p0 = plan_coalesce(groups, round_idx=0, max_picks=1)
    p1 = plan_coalesce(groups, round_idx=1, max_picks=1)
    assert p0["promoted"] == ["y", "x"] and p1["promoted"] == ["y", "x"]
    assert p0["order"][-1] == "urgent"
    assert p0["picked"] == [p0["order"][0]]
    assert plan_coalesce(groups, 0, 1) == p0


def test_plan_equal_streak_ties_share_the_head_by_rotation():
    groups = [_group("x", starved=2), _group("y", starved=2)]
    assert plan_coalesce(groups, round_idx=0, max_picks=1)["promoted"] == ["x", "y"]
    assert plan_coalesce(groups, round_idx=1, max_picks=1)["promoted"] == ["y", "x"]
    groups.append(_group("z", starved=5))
    for rnd in range(4):
        p = plan_coalesce(groups, round_idx=rnd, max_picks=1)
        assert p["promoted"][0] == "z" and p["picked"] == ["z"]


def test_plan_zero_pending_groups_drop_out():
    assert plan_coalesce([_group("a", pending=0), _group("b")], 0)["order"] == ["b"]


# -- the controllers, step by step through both packages ---------------------


def _admission_script(ctrl_cls, quota_cls, log, seed: int) -> list:
    """A seeded event sequence through one package's AdmissionController;
    returns every verdict."""
    rng = np.random.default_rng(seed)
    healthy = [True]
    ctrl = ctrl_cls(max_queue_depth=int(rng.integers(1, 8)), default_quota=3,
                    health=lambda: healthy[0], health_ttl_s=0.0,
                    shed_frac=float(rng.choice([0.25, 0.5, 1.0])))
    out = []
    log.clear()
    for k in range(120):
        op = rng.random()
        tenant = f"t{int(rng.integers(0, 4))}"
        if op < 0.1:
            ctrl.set_quota(tenant, quota_cls(max_inflight=int(rng.integers(1, 6)),
                                             priority=int(rng.integers(0, 3))))
            continue
        if op < 0.15:
            ctrl.set_quota(tenant, int(rng.integers(1, 6)))
            continue
        if op < 0.2:
            healthy[0] = not healthy[0]
        brk = rng.random() < 0.15
        out.append(ctrl.check(
            tenant, int(rng.integers(0, 7)), int(rng.integers(0, 9)),
            float(rng.choice([0.001, 0.01, 0.2])),
            kernel_unsafe=bool(rng.random() < 0.05),
            kernel_finding=("write-overlap" if rng.random() < 0.5 else None),
            breaker_open=brk,
            breaker_retry_after_s=(float(rng.random()) if brk else None),
            brownout=bool(rng.random() < 0.3), rid=f"r{k}"))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_admission_controller_step_by_step_equals_the_reference_s(seed):
    mine = _admission_script(AdmissionController, serve.TenantQuota, DECISIONS, seed)
    p_rows = _rows(DECISIONS, ("admission",))
    ref = _admission_script(ref_serve.AdmissionController, ref_serve.TenantQuota,
                            REF_DECISIONS, seed)
    r_rows = _rows(REF_DECISIONS, ("admission",))
    assert mine == ref
    assert p_rows == r_rows and len(p_rows) == len(mine)


def _tenant_script(table, seed: int) -> list:
    rng = np.random.default_rng(seed)
    snaps = []
    states = {}
    for _ in range(200):
        t = f"t{int(rng.integers(0, 5))}"
        st = states.setdefault(t, table.state(t))
        op = rng.integers(0, 4)
        if op == 0:
            snaps.append(("inflight", table.note_request(st)))
        elif op == 1:
            table.note_admitted(st)
        elif op == 2:
            table.note_rejected(st, str(rng.choice(["tenant-quota", "queue-depth"])))
        else:
            table.note_done(st, float(rng.random()), failed=bool(rng.random() < 0.3),
                            deadline_missed=bool(rng.random() < 0.3))
        snaps.append(table.snapshot())
        snaps.append(table.inflight(t))
    return snaps


@pytest.mark.parametrize("seed", range(2))
def test_tenant_table_step_by_step_equals_the_reference_s(seed):
    assert _tenant_script(TenantTable(), seed) == _tenant_script(ref_tenants.TenantTable(), seed)


def test_admission_controller_records_replayable_decisions():
    ctrl = AdmissionController(max_queue_depth=2, default_quota=1)
    DECISIONS.clear()
    assert ctrl.check("a", 0, 0, 0.01)["admit"] is True
    assert ctrl.check("a", 1, 0, 0.01)["reason"] == REJECT_QUOTA
    assert ctrl.check("b", 0, 5, 0.01)["reason"] == REJECT_QUEUE
    recs = [r for r in DECISIONS.snapshot() if r.kind == "admission"]
    assert len(recs) == 3
    for r in recs:
        assert replay_record(r)["ok"] is True


def test_admission_health_gate_flips():
    healthy = [False]
    ctrl = AdmissionController(health=lambda: healthy[0], health_ttl_s=0.0)
    assert ctrl.check("a", 0, 0, 0.01)["reason"] == REJECT_HEALTH
    healthy[0] = True
    assert ctrl.check("a", 0, 0, 0.01)["admit"] is True


# -- Cores.compute_fused_batch, the batch entry -------------------------------


@BOTH
def test_compute_fused_batch_exact_and_one_ladder(side):
    cr, (x,), _ = side.mk()
    try:
        cr.enqueue_mode = True
        info = cr.cores.compute_fused_batch(["inc"], [x], 700, 1024, 64, 12)
        cr.cores.barrier()
        cr.cores.flush()
        np.testing.assert_array_equal(np.asarray(x), 12.0)
        assert info == {"iters": 12, "fused": True, "ladder_iters": 10, "per_call_iters": 2}
        info2 = cr.cores.compute_fused_batch(["inc"], [x], 700, 1024, 64, 12)
        cr.cores.barrier()
        cr.cores.flush()
        np.testing.assert_array_equal(np.asarray(x), 24.0)
        assert info2["per_call_iters"] == 1 and info2["ladder_iters"] == 11
    finally:
        cr.dispose()


@BOTH
def test_compute_fused_batch_requires_enqueue_and_falls_back(side):
    cr, (x,), _ = side.mk()
    try:
        with pytest.raises(Exception, match="enqueue_mode"):
            cr.cores.compute_fused_batch(["inc"], [x], 700, 1024, 64, 4)
        cr.fused_dispatch = False
        cr.enqueue_mode = True
        info = cr.cores.compute_fused_batch(["inc"], [x], 700, 1024, 64, 5)
        cr.cores.barrier()
        cr.cores.flush()
        assert info["fused"] is False and info["per_call_iters"] == 5
        np.testing.assert_array_equal(np.asarray(x), 5.0)
    finally:
        cr.dispose()


# -- the frontend ---------------------------------------------------------------


def _strip(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k != "latency_s"}


def _exact_script(side) -> tuple:
    cr, (x,), (job,) = side.mk()
    fe = side.serve.ServeFrontend(cr, autostart=False, name="exact")
    try:
        w0 = cr.cores.fused_stats["windows"]
        futs = [fe.submit("tA", job) for _ in range(16)]
        out = fe.step()
        recs = [_strip(f.result(timeout=30)) for f in futs]
        return (np.asarray(x).copy(), recs, out["batches"], out["requests"],
                cr.cores.fused_stats["windows"] - w0, fe.tenants.snapshot())
    finally:
        fe.close()
        cr.dispose()


def test_frontend_coalesces_and_resolves_exact_as_the_reference_does():
    mine, ref = _exact_script(SIDES[0]), _exact_script(SIDES[1])
    np.testing.assert_array_equal(mine[0], 16.0)
    assert mine[0].tobytes() == ref[0].tobytes()
    assert mine[1:] == ref[1:]
    assert mine[2:5] == (1, 16, 1)  # one batch, sixteen requests, ONE ladder
    assert all(r["batch_requests"] == 16 and r["fused"] for r in mine[1])


def test_frontend_rejects_a_job_with_unhashable_values():
    cr, (x,), _ = _mk()
    fe = ServeFrontend(cr, autostart=False, name="unhashable")
    try:
        with pytest.raises(ComputeValidationError, match="hashable"):
            fe.submit("tA", ServeJob(params=[x], kernels=["inc"], compute_id=700,
                                     global_range=1024, local_range=64,
                                     values={"inc": [np.zeros(2)]}))
    finally:
        fe.close()
        cr.dispose()


def _quota_script(side) -> tuple:
    cr, (x,), (job,) = side.mk()
    fe = side.serve.ServeFrontend(cr, autostart=False, name="quota")
    fe.admission.set_quota("tQ", 6)
    rejected, futs = [], []
    mu = threading.Lock()

    def client():
        try:
            f = fe.submit("tQ", job)
            with mu:
                futs.append(f)
        except side.serve.ServeRejected as e:
            with mu:
                rejected.append((e.reason, e.retry_after_s > 0))

    threads = [threading.Thread(target=client) for _ in range(32)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        snap = fe.tenants.snapshot()["tQ"]
        fe.step()
        for f in futs:
            f.result(timeout=30)
        return len(futs), sorted(set(rejected)), len(rejected), snap, np.asarray(x).copy()
    finally:
        fe.close()
        cr.dispose()


def test_frontend_quota_rejections_exact_under_contention():
    """32 threads, one tenant, quota 6, dispatcher paused: exactly quota
    admits in both packages, and the rest reject with retry-after."""
    m0 = REGISTRY.counter("ck_serve_rejected_total", "serve submits rejected",
                          tenant="tQ", reason=REJECT_QUOTA).value
    mine = _quota_script(SIDES[0])
    assert mine[:3] == (6, [(REJECT_QUOTA, True)], 26)
    assert mine[3]["admitted"] == 6 and mine[3]["rejected"] == 26
    assert REGISTRY.counter("ck_serve_rejected_total", "serve submits rejected",
                            tenant="tQ", reason=REJECT_QUOTA).value - m0 == 26
    ref = _quota_script(SIDES[1])
    assert mine[:4] == ref[:4]
    assert mine[4].tobytes() == ref[4].tobytes()
    np.testing.assert_array_equal(mine[4], 6.0)


def test_frontend_32_threads_mixed_signatures_coalesce():
    """32 concurrent clients x mixed signatures complete bit-exactly AND
    coalesce into fewer ladder launches than requests."""
    cr, arrays, jobs = _mk(sigs=4)
    fe = ServeFrontend(cr, gather_window_s=0.01, name="contention")
    n_clients, per_client = 32, 6
    m_windows = REGISTRY.counter("ck_fused_windows_total", "fused ladder dispatch batches")
    m_iters = REGISTRY.counter("ck_fused_iters_total",
                               "iterations dispatched via fused ladders")
    w0, i0 = m_windows.value, m_iters.value
    per_sig = [0] * len(jobs)
    mu = threading.Lock()

    def client(ci):
        for k in range(per_client):
            s = (ci + k) % len(jobs)
            fe.submit(f"t{ci % 4}", jobs[s]).result(timeout=60)
            with mu:
                per_sig[s] += 1

    threads = [threading.Thread(target=client, args=(ci,)) for ci in range(n_clients)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        requests = n_clients * per_client
        assert sum(per_sig) == requests
        for s, a in enumerate(arrays):
            np.testing.assert_array_equal(np.asarray(a), float(per_sig[s]))
        windows = m_windows.value - w0
        per_call = requests - (m_iters.value - i0)
        assert windows + per_call < requests
    finally:
        fe.close()
        cr.dispose()


def _deadline_script(side) -> tuple:
    cr, arrays, jobs = side.mk(sigs=2)
    fe = side.serve.ServeFrontend(cr, autostart=False, name="deadline")
    try:
        f_slow = fe.submit("tA", jobs[0])
        f_urgent = fe.submit("tB", jobs[1], deadline=5.0)
        plan = fe.step()["plan"]
        urgent = _strip(f_urgent.result(10))
        f_slow.result(10)
        f_late = fe.submit("tA", jobs[0], deadline=-0.001)
        fe.step()
        late = _strip(f_late.result(10))
        return (plan, urgent, late, fe.tenants.snapshot(),
                [np.asarray(a).copy().tobytes() for a in arrays])
    finally:
        fe.close()
        cr.dispose()


def test_frontend_deadline_ordering_and_miss_flag_as_the_reference_does():
    mine = _deadline_script(SIDES[0])
    plan, urgent, late, snap, _ = mine
    assert plan["order"][0].endswith("cid701")  # the deadlined group first
    assert urgent["deadline_missed"] is False
    assert late["deadline_missed"] is True and snap["tA"]["deadline_missed"] == 1
    assert mine == _deadline_script(SIDES[1])


def _reject_script(side) -> list:
    out = []
    cr, _arrays, (job,) = side.mk()
    healthy = [False]
    fe = side.serve.ServeFrontend(
        cr, admission=side.serve.AdmissionController(health=lambda: healthy[0],
                                                     health_ttl_s=0.0),
        autostart=False, name="health")
    try:
        with pytest.raises(side.serve.ServeRejected) as exc:
            fe.submit("tA", job)
        out.append((exc.value.reason, exc.value.retry_after_s))
        healthy[0] = True
        fe.submit("tA", job)
        fe.step()
    finally:
        fe.close()
    fe = side.serve.ServeFrontend(
        cr, admission=side.serve.AdmissionController(max_queue_depth=3, default_quota=100),
        autostart=False, name="backpressure")
    try:
        for _ in range(3):
            fe.submit("tA", job)
        with pytest.raises(side.serve.ServeRejected) as exc:
            fe.submit("tA", job)
        out.append((exc.value.reason, exc.value.retry_after_s))
        fe.step()  # drains; admission opens again
        fe.submit("tA", job)
        fe.step()
        out.append(np.asarray(job.params[0]).copy().tobytes())
    finally:
        fe.close()
        cr.dispose()
    return out


def test_frontend_health_gate_and_queue_backpressure_as_the_reference_does():
    mine = _reject_script(SIDES[0])
    assert mine[0][0] == REJECT_HEALTH and mine[0][1] > 0
    assert mine[1][0] == REJECT_QUEUE and mine[1][1] > 0
    assert np.frombuffer(mine[2], np.float32)[0] == 5.0
    assert mine == _reject_script(SIDES[1])


def _replay_script(side) -> list:
    cr, _arrays, (job,) = side.mk()
    fe = side.serve.ServeFrontend(cr, autostart=False, name="replay")
    side.DECISIONS.clear()
    try:
        for _ in range(8):
            fe.submit("tA", job)
        fe.step()
        fe.admission.set_quota("tB", 1)
        fe.submit("tB", job)
        with pytest.raises(side.serve.ServeRejected):
            fe.submit("tB", job)
        fe.step()
        return [r.to_row() for r in side.DECISIONS.snapshot()
                if r.kind in ("admission", "coalesce")]
    finally:
        fe.close()
        cr.dispose()


@BOTH
def test_serve_decisions_replay_green_in_both_packages_and_tamper_diverges(side):
    rows = json.loads(json.dumps(_replay_script(side)))
    assert len([r for r in rows if r["kind"] == "admission"]) == 10
    assert len([r for r in rows if r["kind"] == "coalesce"]) == 2
    for verify in (verify_records, ref_verify_records):
        verdict = verify(rows)
        assert verdict["ok"] is True, verdict
        assert verdict["replayed"] == len(rows)
    for k in (0, len(rows) - 1):
        bad = json.loads(json.dumps(rows[k]))
        if bad["kind"] == "admission":
            bad["outputs"]["admit"] = not bad["outputs"]["admit"]
        else:
            bad["outputs"]["order"] = list(reversed(bad["outputs"]["order"])) + ["gX"]
        for verify in (verify_records, ref_verify_records):
            v2 = verify([bad])
            assert v2["ok"] is False and v2["first_divergence"]["seq"] == bad["seq"]


def test_the_same_script_records_the_same_serving_rows_in_both_packages():
    strip = [({k: v for k, v in r["inputs"].items()
               if k not in ("rids", "rid", "est_batch_s", "groups")},
              r["kind"], {k: v for k, v in r["outputs"].items() if k != "retry_after_s"})
             for r in _replay_script(SIDES[0])]
    ref = [({k: v for k, v in r["inputs"].items()
             if k not in ("rids", "rid", "est_batch_s", "groups")},
            r["kind"], {k: v for k, v in r["outputs"].items() if k != "retry_after_s"})
           for r in _replay_script(SIDES[1])]
    assert strip == ref


@BOTH
def test_frontend_close_fails_leftovers_with_named_error(side):
    cr, _arrays, (job,) = side.mk()
    fe = side.serve.ServeFrontend(cr, autostart=False, name="shutdown")
    fut = fe.submit("tA", job)
    fe.close(drain=False)
    with pytest.raises(Exception, match="closed"):
        fut.result(timeout=5)
    with pytest.raises(Exception, match="closed"):
        fe.submit("tA", job)
    cr.dispose()


def test_servez_payload_and_endpoint():
    cr, _arrays, (job,) = _mk()
    fe = ServeFrontend(cr, gather_window_s=0.001, name="servez")
    try:
        for _ in range(6):
            fe.submit("tZ", job).result(timeout=30)
        doc = servez_payload()
        mine = [f for f in doc["frontends"] if f["name"] == "servez"]
        assert mine and mine[0]["requests_done"] == 6
        assert mine[0]["tenants"]["tZ"]["completed"] == 6
        assert mine[0]["dispatcher_alive"] is True and mine[0]["latency"]["count"] == 6
        srv = cr.serve_debug(port=0)
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/servez", timeout=10) as r:
            body = json.loads(r.read())
        assert any(f["name"] == "servez" for f in body["frontends"])
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/", timeout=10) as r:
            assert "/servez" in json.loads(r.read())["endpoints"]
    finally:
        fe.close()
        cr.dispose()


def test_stats_keys_are_the_reference_s():
    rows = []
    for side in SIDES:
        cr, _arrays, (job,) = side.mk()
        fe = side.serve.ServeFrontend(cr, autostart=False, name="keys")
        try:
            fe.submit("tK", job)
            doc = fe.stats()
            rows.append((sorted(doc), sorted(doc["admission"]), sorted(doc["resilience"]),
                         doc["groups"][0]["pending"], doc["tenants"]))
        finally:
            fe.close()
            cr.dispose()
    assert rows[0] == rows[1]


def test_requests_trace_their_lifecycle():
    from cekirdekler_tpu_torch.obs.reqtrace import REQTRACE, fold_phases

    REQTRACE.enabled = True
    REQTRACE.clear()
    cr, _arrays, (job,) = _mk()
    fe = ServeFrontend(cr, autostart=False, name="lifecycle")
    try:
        futs = [fe.submit("tL", job) for _ in range(3)]
        fe.step()
        for f in futs:
            f.result(timeout=30)
    finally:
        fe.close()
        cr.dispose()
    recs = fold_phases(REQTRACE.snapshot())
    assert len(recs) == 3 and all(r["outcome"] == "resolved" for r in recs)
    for r in recs:
        assert r["kinds"][:2] == ["admitted", "queued"] and r["kinds"][-1] == "resolved"
        assert "dispatched" in r["kinds"] and "device" in r["kinds"]


def test_loadgen_smoke_and_lg_inc_bit_equal_to_the_reference_s():
    from cekirdekler_tpu_torch.tools import loadgen

    out = loadgen.run_loadgen(ck.all_devices().cpus(2), clients=8, tenants=2, signatures=2,
                              requests_per_client=4, n=2048)
    assert out["completed"] == 32 and out["failed"] == 0 and out["hangs"] == 0
    assert out["checked"] is True and out["coalesced"] is True
    assert out["ladder_launches"] < out["completed"]
    assert out["p50_ms"] > 0 and out["p99_ms"] >= out["p50_ms"] and out["goodput_rps"] > 0
    assert loadgen.LOADGEN_SRC.split() == _ref_loadgen().LOADGEN_SRC.split()
    # the stepped script: the same requests through both packages' frontends
    got = []
    for side in SIDES:
        cr = side.cruncher(2, loadgen.LOADGEN_SRC)
        arrays = [side.ClArray(np.zeros(2048, np.float32), name=f"lg{s}") for s in range(3)]
        for a in arrays:
            a.partial_read = True
        jobs = [side.serve.ServeJob(params=[a], kernels=["lg_inc"], compute_id=9100 + s,
                                    global_range=2048, local_range=64)
                for s, a in enumerate(arrays)]
        fe = side.serve.ServeFrontend(cr, autostart=False, max_batch=5, name="lg-steps")
        try:
            recs = []
            for rnd in range(4):
                futs = [fe.submit(f"t{k % 3}", jobs[(k + rnd) % 3]) for k in range(7)]
                fe.step()
                fe.step()
                recs += [_strip(f.result(timeout=30)) for f in futs]
            got.append(([np.asarray(a).copy() for a in arrays], recs))
        finally:
            fe.close()
            cr.dispose()
    (mine, mine_recs), (ref, ref_recs) = got
    assert [a.tobytes() for a in mine] == [a.tobytes() for a in ref]
    assert sum(float(a[0]) for a in mine) == 28.0
    assert mine_recs == ref_recs


def _ref_loadgen():
    import importlib.util
    import os

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "ck_loadgen_torch_test", os.path.join(here, "tools", "loadgen.py"))
    lg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lg)
    return lg
