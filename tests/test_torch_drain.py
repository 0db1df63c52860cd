"""The drain actuator (``obs/drain.py``) of the port against the JAX
package's.

- Twins of the reference's ``tests/test_drain.py``: the pure transition,
  ``apply_quarantine`` and the controller, each run through both
  packages with the results compared, and seeded random inputs through
  both pure functions.
- The barrier scenario of ``test_cores_barrier_drains_and_workload_stays_exact``
  through both packages' ``NumberCruncher`` on two host lanes, with a
  ``lane-stall`` armed on lane 1 for a fixed number of barriers and a
  modelled clock in each ``cores`` module (:class:`StallClock`): a lane's
  fence reads its modelled lag plus the stall the fault plane asked for,
  so both monitors see the same samples.  Both must give the same range
  table at every call, the same ``health-verdict``, ``drain-apply`` and
  ``readmit`` rows, and an exact array after every window.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from cekirdekler_tpu.core import cores as ref_cores
from cekirdekler_tpu.metrics.registry import REGISTRY as REF_REGISTRY
from cekirdekler_tpu.obs import drain as ref_drain
from cekirdekler_tpu.obs import health as ref_health
from cekirdekler_tpu.obs import replay as ref_replay
from cekirdekler_tpu.obs.decisions import DECISIONS as REF_DECISIONS
from cekirdekler_tpu.utils.faultinject import FAULTS as REF_FAULTS
from cekirdekler_tpu_torch.core import cores as port_cores
from cekirdekler_tpu_torch.metrics.registry import REGISTRY
from cekirdekler_tpu_torch.obs import drain, health, replay
from cekirdekler_tpu_torch.obs.decisions import DECISIONS
from cekirdekler_tpu_torch.utils.faultinject import FAULTS
from tests.test_torch_enqueue import ModelClock, Pair
from tests.test_torch_metrics import INC, restore_planes, save_planes


@pytest.fixture(autouse=True)
def _planes():
    saved = save_planes()
    yield
    restore_planes(saved)


KINDS = ("health-verdict", "drain-apply", "readmit")


def _rows(log, kinds=KINDS) -> list[tuple]:
    return [(r.kind, json.dumps(r.inputs, sort_keys=True), json.dumps(r.outputs, sort_keys=True))
            for r in log.snapshot() if r.kind in kinds]


def _both(fn_name, *args, **kw):
    mine = getattr(drain, fn_name)(*args, **kw)
    ref = getattr(ref_drain, fn_name)(*args, **kw)
    assert mine == ref
    return mine


# ---------------------------------------------------------------------------
# the pure transition
# ---------------------------------------------------------------------------

def test_transition_drains_a_degraded_lane():
    r = _both("drain_transition", {"0": "ok", "1": "degraded"},
              {"0": "active", "1": "active"}, {}, {}, 2, 2)
    assert r["drained"] == ["1"] and r["states"]["1"] == "quarantined" and r["hold"]["1"] == 2


def test_transition_hold_then_probation_then_readmit():
    st, hold, streak = {"0": "active", "1": "quarantined"}, {"1": 2}, {}
    deg = {"0": "ok", "1": "degraded"}
    r = _both("drain_transition", deg, st, hold, streak, 2, 2)
    assert r["states"]["1"] == "quarantined" and r["hold"]["1"] == 1
    r = _both("drain_transition", deg, r["states"], r["hold"], r["clear_streak"], 2, 2)
    assert r["probed"] == ["1"] and r["states"]["1"] == "probation"
    ok = {"0": "ok", "1": "ok"}
    r = _both("drain_transition", ok, r["states"], r["hold"], r["clear_streak"], 2, 2)
    assert r["readmitted"] == [] and r["clear_streak"]["1"] == 1
    r = _both("drain_transition", ok, r["states"], r["hold"], r["clear_streak"], 2, 2)
    assert r["readmitted"] == ["1"] and r["states"]["1"] == "active"


def test_transition_probation_relapse_is_a_drain_not_a_flap():
    st = {"0": "active", "1": "probation"}
    r = _both("drain_transition", {"1": "degraded"}, st, {}, {"1": 1}, 3, 2)
    assert r["states"]["1"] == "quarantined" and r["hold"]["1"] == 3
    assert r["readmitted"] == [] and r["drained"] == ["1"]
    r = _both("drain_transition", {"1": "suspect"}, st, {}, {"1": 1}, 3, 2)
    assert r["states"]["1"] == "probation" and r["clear_streak"]["1"] == 0


def test_transition_never_drains_the_last_active_lane():
    r = _both("drain_transition", {"0": "degraded", "1": "degraded"},
              {"0": "active", "1": "active"}, {}, {}, 2, 2)
    assert r["drained"] == ["0"] and r["states"]["1"] == "active"
    r2 = _both("drain_transition", {"0": "degraded", "1": "degraded"},
               r["states"], r["hold"], r["clear_streak"], 2, 2)
    assert r2["drained"] == []


def test_transition_stringified_keys_replay_identically():
    a = _both("drain_transition", {1: "degraded", 0: "ok"}, {0: "active", 1: "active"},
              {}, {}, 2, 2)
    b = _both("drain_transition", {"1": "degraded", "0": "ok"},
              {"0": "active", "1": "active"}, {}, {}, 2, 2)
    assert a == b


@pytest.mark.parametrize("seed", range(10))
def test_transition_is_the_reference_s_on_seeded_states(seed):
    rng = np.random.default_rng(seed)
    verdicts = ("ok", "suspect", "degraded")
    states_v = (drain.LANE_ACTIVE, drain.LANE_QUARANTINED, drain.LANE_PROBATION)
    for _ in range(200):
        lanes = int(rng.integers(1, 6))
        states = {str(i): states_v[int(rng.integers(0, 3))] for i in range(lanes)}
        verd = {str(i): verdicts[int(rng.integers(0, 3))] for i in range(lanes)
                if rng.random() < 0.85}
        hold = {str(i): int(rng.integers(-1, 4)) for i in range(lanes) if rng.random() < 0.6}
        streak = {str(i): int(rng.integers(0, 3)) for i in range(lanes) if rng.random() < 0.6}
        _both("drain_transition", verd, states, hold, streak, int(rng.integers(1, 4)),
              int(rng.integers(1, 4)), probe_grace=int(rng.integers(1, 5)))


# ---------------------------------------------------------------------------
# range masking
# ---------------------------------------------------------------------------

def test_apply_quarantine_redistributes_and_keeps_the_total():
    assert _both("apply_quarantine", [512, 256, 256], 64, {1}, set()) == [640, 0, 384]


def test_apply_quarantine_probe_share_is_one_step_and_idempotent():
    out = _both("apply_quarantine", [1024, 0], 64, set(), {1})
    assert out == [960, 64]
    assert _both("apply_quarantine", out, 64, set(), {1}) == out


def test_apply_quarantine_with_no_active_lane_is_a_noop():
    assert _both("apply_quarantine", [512, 512], 64, {0, 1}, set()) == [512, 512]


def test_apply_quarantine_drain_and_probe_together():
    out = _both("apply_quarantine", [384, 384, 256], 64, {2}, {1})
    assert sum(out) == 1024 and out[2] == 0 and out[1] == 64


@pytest.mark.parametrize("seed", range(6))
def test_apply_quarantine_is_the_reference_s_on_seeded_tables(seed):
    rng = np.random.default_rng(50 + seed)
    for _ in range(300):
        n = int(rng.integers(1, 7))
        step = int(rng.choice([1, 16, 64, 256]))
        ranges = [int(rng.integers(0, 9)) * step for _ in range(n)]
        drained = {i for i in range(n) if rng.random() < 0.3}
        probing = {i for i in range(n) if i not in drained and rng.random() < 0.3}
        out = _both("apply_quarantine", ranges, step, drained, probing)
        assert sum(out) == sum(ranges)


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

def _feed(monitors, lane, value, windows=1):
    for m in monitors:
        for _ in range(windows * m.window):
            m.observe(lane, "fence", value)


def _degrade(monitors, lane, base=0.01):
    m = monitors[0]
    _feed(monitors, lane, base, windows=m.min_history)
    _feed(monitors, lane, base * 10.0, windows=m.confirm + 1)


def _controllers(mon_kw: dict, **dc_kw):
    mons = (health.HealthMonitor(**mon_kw), ref_health.HealthMonitor(**mon_kw))
    return mons, (drain.DrainController(mons[0], **dc_kw),
                  ref_drain.DrainController(mons[1], **dc_kw))


def _evaluate(dcs) -> dict:
    mine, ref = (dc.evaluate() for dc in dcs)
    assert mine == ref
    return mine


def test_controller_quarantines_and_readmits_with_hysteresis():
    mons, dcs = _controllers({"window": 2, "min_history": 2, "confirm": 2}, lanes=2,
                             hold_barriers=2, confirm_clear=2)
    before = (REGISTRY.counter("ck_drain_total").value,
              REGISTRY.counter("ck_drain_readmit_total").value)
    _feed(mons, 0, 0.01, windows=6)
    _degrade(mons, 1)
    assert _evaluate(dcs)["drained"] == ["1"]
    assert [dc.drained_lanes() for dc in dcs] == [{1}, {1}]
    _evaluate(dcs)
    assert _evaluate(dcs)["probed"] == ["1"]
    assert [dc.probe_lanes() for dc in dcs] == [{1}, {1}]
    _feed(mons, 1, 0.01, windows=2)
    assert [m.verdict(1) for m in mons] == ["ok", "ok"]
    _evaluate(dcs)
    assert _evaluate(dcs)["readmitted"] == ["1"]
    assert [dc.lane_state(1) for dc in dcs] == ["active", "active"]
    assert dcs[0].report() == dcs[1].report()
    assert dcs[0].report()["drains"] == 1 and dcs[0].report()["readmits"] == 1
    assert (REGISTRY.counter("ck_drain_total").value - before[0],
            REGISTRY.counter("ck_drain_readmit_total").value - before[1]) == (1, 1)
    assert REGISTRY.gauge("ck_drain_state", lane=1).value == 0.0
    assert _rows(DECISIONS) == _rows(REF_DECISIONS)


def test_controller_decisions_replay_in_both_packages_and_a_tamper_diverges():
    mons, dcs = _controllers({"window": 2, "min_history": 2, "confirm": 2}, lanes=2,
                             hold_barriers=1, confirm_clear=1)
    _feed(mons, 0, 0.01, windows=6)
    _degrade(mons, 1)
    _evaluate(dcs)
    _evaluate(dcs)
    _feed(mons, 1, 0.01, windows=2)
    _evaluate(dcs)
    recs = [r for r in DECISIONS.snapshot() if r.kind in KINDS]
    assert {r.kind for r in recs} == set(KINDS)
    rows = [r.to_row() for r in recs]
    for verify in (replay.verify_records, ref_replay.verify_records):
        v = verify(rows)
        assert v["ok"], v["first_divergence"]
        assert v["replayed"] == len(rows)
    assert replay.verify_records(rows)["not_ported"] == {}
    row = dict(rows[-1], outputs=dict(rows[-1]["outputs"], drained=["0"]))
    for rep in (replay.replay_record(row), ref_replay.replay_record(row)):
        assert rep["ok"] is False and "drained" in rep["mismatch"]


def test_controller_healthy_with_drains_gate():
    mons, dcs = _controllers({"window": 2, "min_history": 2, "confirm": 2}, lanes=2,
                             hold_barriers=1, confirm_clear=1)
    _feed(mons, 0, 0.01, windows=6)
    _degrade(mons, 1)
    assert [dc.healthy_with_drains() for dc in dcs] == [False, False]
    _evaluate(dcs)
    assert [dc.healthy_with_drains() for dc in dcs] == [True, True]


def test_a_disabled_controller_is_inert():
    mons, dcs = _controllers({"window": 2, "min_history": 2, "confirm": 2}, lanes=2,
                             enabled=False)
    _degrade(mons, 1)
    assert [dc.evaluate() for dc in dcs] == [None, None]
    assert [dc.drained_lanes() for dc in dcs] == [set(), set()]


def test_the_controller_s_defaults_are_the_reference_s():
    mine = drain.DrainController(health.HealthMonitor(), lanes=3)
    ref = ref_drain.DrainController(ref_health.HealthMonitor(), lanes=3)
    assert mine.report() == ref.report()
    assert drain.MODEL_INVARIANTS == ref_drain.MODEL_INVARIANTS


# ---------------------------------------------------------------------------
# the barrier scenario through both packages
# ---------------------------------------------------------------------------

class StallClock(ModelClock):
    """:class:`ModelClock` whose ``sleep`` (the barrier's ``lane-stall``)
    takes no wall time: it adds the stall to the lane's next fence
    reading instead."""

    def sleep(self, seconds: float) -> None:
        self._tls.stall = getattr(self._tls, "stall", 0.0) + seconds

    def attach(self, cruncher) -> None:
        for w in cruncher.cores.workers:
            orig = w.fence

            def fence(w=w, orig=orig):
                orig()
                self._tls.now = self.lags.get(w.index, 0.0) + getattr(self._tls, "stall", 0.0)
                self._tls.stall = 0.0

            w.fence = fence


SCENARIOS = {
    # the reference test's monitor and controller
    "reference": ({"window": 2, "min_history": 2, "confirm": 2},
                  {"hold_barriers": 1, "confirm_clear": 1}, 4, 4, 24),
    # the defaults every Cores makes
    "defaults": (None, None, 32, 24, 100),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_barrier_drains_and_readmits_alike_and_the_array_stays_exact(monkeypatch, name):
    mon_kw, dc_kw, after, stalls, windows = SCENARIOS[name]
    pair = Pair(INC, 2)
    for mod, cr in ((port_cores, pair.port), (ref_cores, pair.ref)):
        clock = StallClock()
        clock.lags = {0: 0.010, 1: 0.010}
        monkeypatch.setattr(mod, "time", clock)
        clock.attach(cr)
    plan = f"lane-stall@lane1:delay_ms=50,after={after},times={stalls}"
    FAULTS.arm(plan)
    REF_FAULTS.arm(plan)
    counters = [(reg.counter("ck_drain_total").value,
                 reg.counter("ck_drain_readmit_total").value) for reg in (REGISTRY, REF_REGISTRY)]
    try:
        tables, states = [], []
        for cr, CA in pair.both():
            if mon_kw is not None:
                cr.cores.health = type(cr.cores.health)(**mon_kw)
                cr.cores.drain = type(cr.cores.drain)(cr.cores.health, lanes=2, **dc_kw)
            x = CA(np.zeros(1024, np.float32), name="x")
            x.partial_read = True
            cr.enqueue_mode = True
            seen, st_seen = [], []
            for k in range(windows):
                x.compute(cr, 1, "inc", 1024, 64)
                seen.append(cr.ranges_of(1))
                cr.barrier()
                st = cr.cores.drain.lane_state(1)
                if not st_seen or st_seen[-1] != st:
                    st_seen.append(st)
                cr.flush()
                np.testing.assert_array_equal(np.asarray(x), float(k + 1))
            cr.enqueue_mode = False
            np.testing.assert_array_equal(np.asarray(x), float(windows))
            tables.append(seen)
            states.append(st_seen)
        assert tables[0] == tables[1]
        assert states[0] == states[1] == ["active", "quarantined", "probation", "active"]
        assert [1024, 0] in tables[0] and [960, 64] in tables[0]
        assert _rows(DECISIONS) == _rows(REF_DECISIONS)
        kinds = [r[0] for r in _rows(DECISIONS)]
        assert kinds.count("drain-apply") == 1 and kinds.count("readmit") == 1
        assert "health-verdict" in kinds
        after_counts = [(reg.counter("ck_drain_total").value,
                         reg.counter("ck_drain_readmit_total").value)
                        for reg in (REGISTRY, REF_REGISTRY)]
        assert [(a - b, c - d) for (a, c), (b, d) in zip(after_counts, counters)] == [(1, 1)] * 2
        assert pair.port.health_report() == pair.ref.health_report()
        rows = [r.to_row() for r in DECISIONS.snapshot() if r.kind in KINDS]
        v = replay.verify_records(rows)
        assert v["ok"] and v["not_ported"] == {} and v["replayed"] == len(rows)
    finally:
        FAULTS.disarm()
        REF_FAULTS.disarm()
        pair.dispose()
