"""The port's fault plane against the reference's, and its sites in the
port's core.

- ``FAULT_POINTS`` and the plan grammar are the reference's: the same plan
  string and the same seeded sequence of ``fire()`` calls give the same
  fired sequence in both planes, ``p=`` draws included (exact), and the
  same plans are refused.
- The port's sites: ``driver-submit`` raises ``InjectedFaultError`` from a
  streamed call, from a fused window's dispatch and as a clean
  ``FusedBatchError`` from ``compute_fused_batch``; ``slow-link`` delays a
  lane's transfers; ``lane-stall`` delays a lane's barrier fence.  After
  disarming, results equal the reference's.
- Plans are armed in code, never through ``os.environ`` (both packages
  read ``CK_FAULTS``).
"""

from __future__ import annotations

import numpy as np
import pytest

import cekirdekler_tpu
import cekirdekler_tpu_torch as ck
from cekirdekler_tpu.core.cruncher import NumberCruncher as RefCruncher
from cekirdekler_tpu.hardware import platforms as ref_platforms
from cekirdekler_tpu.utils import faultinject as ref_fi
from cekirdekler_tpu_torch.errors import FusedBatchError, InjectedFaultError
from cekirdekler_tpu_torch.obs.flight import FLIGHT
from cekirdekler_tpu_torch.utils import faultinject as fi
from cekirdekler_tpu_torch.utils.faultinject import FAULTS
from tests.test_torch_metrics import INC, restore_planes, save_planes


@pytest.fixture(autouse=True)
def _planes():
    saved = save_planes()
    yield
    restore_planes(saved)


def test_the_points_and_env_name_are_the_reference_s():
    assert fi.FAULT_POINTS == ref_fi.FAULT_POINTS
    assert fi.FAULTS_ENV == ref_fi.FAULTS_ENV == "CK_FAULTS"


PLANS = [
    "seed=42;slow-link@lane1:factor=5,times=8;socket-drop@recv:after=2,times=1",
    "seed=7;driver-submit@lane0:p=0.5;lane-stall:delay_ms=3,p=0.3,after=1",
    "driver-submit:times=3;serve-dispatch@lane2:after=4,p=0.7;slow-link:delay_ms=1",
    "seed=3;lane-stall@lane1:p=0.25;lane-stall@lane0:times=2;driver-submit@h2d",
]


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("seed", [0, 1])
def test_the_same_plan_and_hits_fire_the_same_sequence(plan, seed):
    rng = np.random.default_rng(seed)
    hits = [(fi.FAULT_POINTS[int(rng.integers(0, len(fi.FAULT_POINTS)))],
             int(rng.integers(0, 3)), ["recv", "send", "h2d", "stream:lane1", None][
                 int(rng.integers(0, 5))]) for _ in range(200)]
    mine, ref = fi.FaultPlane(), ref_fi.FaultPlane()
    mine.arm(plan)
    ref.arm(plan)
    got = []
    for plane in (mine, ref):
        seq = []
        for point, lane, where in hits:
            c = plane.fire(point, lane=lane, where=where)
            seq.append(None if c is None else (c.point, c.selector, c.fired))
        got.append(seq)
    assert got[0] == got[1]
    assert any(x is not None for x in got[0])
    assert mine.snapshot() == ref.snapshot()
    assert (mine.delay_s("slow-link", lane=1, base_s=0.01)
            == ref.delay_s("slow-link", lane=1, base_s=0.01))


@pytest.mark.parametrize("plan", ["warp-drive", "slow-link:speed=2", "lane-stall:delay_ms"])
def test_the_same_plans_are_refused(plan):
    with pytest.raises(ValueError):
        ref_fi.parse_plan(plan)
    with pytest.raises(ValueError):
        fi.parse_plan(plan)


def _arrays(n=4096):
    return ck.ClArray(np.zeros(n, np.float32), name="a", partial_read=True)


def test_driver_submit_raises_from_a_streamed_call_then_the_call_is_exact():
    cr = ck.NumberCruncher(ck.all_devices().cpus(2), INC)
    try:
        cr.normalized_compute_powers_of_devices = [0.5, 0.5]
        cr.stream_chunks = 2
        a = _arrays()
        a.compute(cr, 1, "inc", 4096, 64)
        FAULTS.arm("driver-submit@lane1:times=1")
        with pytest.raises(InjectedFaultError) as ei:
            a.compute(cr, 1, "inc", 4096, 64)
        assert ei.value.point == "driver-submit" and ei.value.lane == 1
        assert [e.kind for e in FLIGHT.snapshot()][-2:] == ["fault-injected", "crash"]
        FAULTS.disarm()
        cr.reset_errors()
        a.compute(cr, 1, "inc", 4096, 64)
        host = a.host()
        # lane 0 ran the failed call; lane 1 raised before its first chunk
        np.testing.assert_array_equal(host[:2048], np.full(2048, 3.0, np.float32))
        np.testing.assert_array_equal(host[2048:], np.full(2048, 2.0, np.float32))
    finally:
        cr.dispose()


def test_driver_submit_poisons_a_fused_window_and_batches_fail_clean():
    cr = ck.NumberCruncher(ck.all_devices().cpus(2), INC)
    try:
        cr.normalized_compute_powers_of_devices = [0.5, 0.5]
        cr.enqueue_mode = True
        cr.fused_batch = 4
        a = _arrays()
        for _ in range(2):
            a.compute(cr, 1, "inc", 4096, 64)
        assert cr.cores._fused_run is not None
        FAULTS.arm("driver-submit@lane0:times=1")
        with pytest.raises(InjectedFaultError):
            for _ in range(4):
                a.compute(cr, 1, "inc", 4096, 64)
        assert cr.cores._fused_run is None
        cr.reset_errors()
        FAULTS.arm("driver-submit@lane1:times=1")
        with pytest.raises(FusedBatchError) as ei:
            cr.cores.compute_fused_batch(["inc"], [a], 1, 4096, 64, 3)
        assert ei.value.clean and ei.value.cause == "injected:driver-submit"
        assert ei.value.applied_iters == 0
        FAULTS.disarm()
        cr.barrier()
        cr.flush()
    finally:
        cr.dispose()


def test_slow_link_delays_a_lane_s_transfers():
    cr = ck.NumberCruncher(ck.all_devices().cpus(2), INC)
    try:
        cr.normalized_compute_powers_of_devices = [0.5, 0.5]
        cr.stream_chunks = 1
        a = _arrays()
        FAULTS.arm("slow-link@lane0:delay_ms=40")
        a.compute(cr, 1, "inc", 4096, 64)
        fired = FAULTS.snapshot()["clauses"][0]["fired"]
        assert fired == 2  # the lane's upload and its download
        # a sleep lasts at least its length: a lower bound, not a budget
        assert cr.cores.workers[0].benchmarks[1] >= 80.0
        assert {e.fields["where"] for e in FLIGHT.snapshot()
                if e.kind == "fault-injected"} == {"h2d", "d2h"}
    finally:
        cr.dispose()


def test_lane_stall_delays_a_lane_s_barrier_fence():
    cr = ck.NumberCruncher(ck.all_devices().cpus(2), INC)
    try:
        cr.normalized_compute_powers_of_devices = [0.5, 0.5]
        cr.enqueue_mode = True
        cr.fused_dispatch = False
        a = _arrays()
        FAULTS.arm("lane-stall@lane1:delay_ms=60")
        for _ in range(2):
            a.compute(cr, 1, "inc", 4096, 64)
        cr.barrier()
        assert FAULTS.snapshot()["clauses"][0]["fired"] == 1
        # two calls in the window: at least 30 ms per iteration on lane 1
        assert cr.cores.workers[1].benchmarks[1] >= 30.0
        barrier = [e for e in FLIGHT.snapshot() if e.kind == "barrier"][-1]
        assert barrier.fields["lanes"][1] >= 60.0
        FAULTS.disarm()
        cr.flush()
    finally:
        cr.dispose()


def test_after_disarming_the_results_are_the_reference_s():
    outs = []
    for cr, CA in ((ck.NumberCruncher(ck.all_devices().cpus(2), INC), ck.ClArray),
                   (RefCruncher(ref_platforms().cpus().subset(2), INC), cekirdekler_tpu.ClArray)):
        try:
            cr.normalized_compute_powers_of_devices = [0.5, 0.5]
            a = CA(np.arange(4096, dtype=np.float32), name="a", partial_read=True)
            if isinstance(cr, ck.NumberCruncher):
                FAULTS.arm("slow-link:delay_ms=1;lane-stall:delay_ms=1")
                a.compute(cr, 1, "inc", 4096, 64)
                FAULTS.disarm()
            else:
                a.compute(cr, 1, "inc", 4096, 64)
            a.compute(cr, 1, "inc", 4096, 64)
            outs.append(np.array(a.host()))
        finally:
            cr.dispose()
    np.testing.assert_array_equal(outs[0], outs[1])


def test_a_disarmed_plane_is_never_reached_through_compute(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a fault site was reached")

    FAULTS.disarm()
    for name in ("fire", "delay_s", "raise_if_fired"):
        monkeypatch.setattr(FAULTS, name, refuse)
    cr = ck.NumberCruncher(ck.all_devices().cpus(2), INC)
    try:
        cr.stream_chunks = 2
        a = _arrays()
        a.compute(cr, 1, "inc", 4096, 64)
        cr.enqueue_mode = True
        for _ in range(4):
            a.compute(cr, 1, "inc", 4096, 64)
        cr.cores.compute_fused_batch(["inc"], [a], 1, 4096, 64, 3)
        cr.barrier()
        cr.flush()
        np.testing.assert_array_equal(a.host(), np.full(4096, 8.0, np.float32))
    finally:
        cr.dispose()
