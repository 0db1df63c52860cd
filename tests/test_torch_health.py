"""Lane health (``obs/health.py``) of the port against the JAX package's.

The same sample streams, made from numpy seeds, go through both
packages' :class:`HealthMonitor` (and through ``evaluate_window`` alone):
after every sample the verdicts, the reports and the drain advice must be
equal, and so must the ``health-verdict`` and ``drain-advisory`` decision
rows each monitor records.  The reference's own detector cases
(``tests/test_obs.py``) run as twins through both, and the registry and
cluster views read the same inputs alike.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from cekirdekler_tpu.metrics.registry import REGISTRY as REF_REGISTRY
from cekirdekler_tpu.obs import health as ref_health
from cekirdekler_tpu.obs.decisions import DECISIONS as REF_DECISIONS
from cekirdekler_tpu_torch.metrics.registry import REGISTRY
from cekirdekler_tpu_torch.obs import health
from cekirdekler_tpu_torch.obs.decisions import DECISIONS
from tests.test_torch_metrics import restore_planes, save_planes


@pytest.fixture(autouse=True)
def _planes():
    saved = save_planes()
    yield
    restore_planes(saved)


#: detector configurations: the defaults, and the shapes the reference's
#: tests and drain use
CONFIGS = [
    {},
    {"window": 4},
    {"window": 2, "min_history": 2, "confirm": 2},
    {"threshold": 3.0, "window": 4, "confirm": 2, "min_history": 2},
    {"threshold": 5.0, "window": 3, "confirm": 1, "release": 2.0, "min_history": 3,
     "baseline_windows": 4},
]


def _rows(log, kinds=("health-verdict", "drain-advisory")) -> list[tuple]:
    return [(r.kind, json.dumps(r.inputs, sort_keys=True), json.dumps(r.outputs, sort_keys=True))
            for r in log.snapshot() if r.kind in kinds]


def _stream(seed: int, lanes: int, windows: int, window: int) -> list[tuple[int, str, float]]:
    """(lane, signal, seconds) samples: each lane and signal a seeded base
    with jitter, some windows degraded 2-8x, some zero, a blip now and
    then."""
    rng = np.random.default_rng(seed)
    out = []
    signals = ("fence", "transfer", "stream_stall")
    bases = {(ln, s): float(rng.uniform(0.001, 0.05)) for ln in range(lanes) for s in signals}
    for _w in range(windows):
        for ln in range(lanes):
            for s in signals[: 1 + int(rng.integers(0, 3))]:
                shape = rng.random()
                factor = (float(rng.uniform(2.0, 8.0)) if shape < 0.25
                          else 0.0 if shape < 0.3 else 1.0)
                for _ in range(window):
                    jitter = float(rng.uniform(0.9, 1.1))
                    blip = 6.0 if rng.random() < 0.03 else 1.0
                    out.append((ln, s, bases[ln, s] * factor * jitter * blip))
    return out


def _pair(cfg: dict):
    return health.HealthMonitor(**cfg), ref_health.HealthMonitor(**cfg)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: ",".join(f"{k}={v}" for k, v in c.items())
                         or "defaults")
def test_monitors_agree_on_a_seeded_stream(seed, cfg):
    mine, ref = _pair(cfg)
    lanes = 1 + seed % 3
    stream = _stream(seed, lanes, windows=40, window=mine.window)
    for k, (ln, sig, v) in enumerate(stream):
        mine.observe(ln, sig, v)
        ref.observe(ln, sig, v)
        if k % mine.window == mine.window - 1:
            assert mine.report() == ref.report(), k
            assert mine.suggest_drain() == ref.suggest_drain()
            assert mine.healthy() == ref.healthy()
    assert mine.lanes() == ref.lanes()
    assert [mine.verdict(ln) for ln in range(lanes)] == [ref.verdict(ln) for ln in range(lanes)]
    rows = _rows(DECISIONS)
    assert rows == _rows(REF_DECISIONS)
    assert any(kind == "health-verdict" for kind, _i, _o in rows) or seed % 3 == 0


@pytest.mark.parametrize("seed", range(6))
def test_evaluate_window_is_the_reference_s(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(400):
        med = float(rng.choice([0.0, rng.uniform(0.0, 0.1)]))
        baseline = rng.choice([None, 0.0, float(rng.uniform(0.001, 0.05))])
        threshold = float(rng.uniform(1.5, 6.0))
        args = dict(streak=int(rng.integers(0, 5)), degraded=bool(rng.random() < 0.4),
                    threshold=threshold, confirm=int(rng.integers(1, 5)),
                    release=float(rng.uniform(1.0, threshold)))
        base = None if baseline is None else float(baseline)
        assert health.evaluate_window(med, base, **args) == \
            ref_health.evaluate_window(med, base, **args)


def test_verdict_scores_are_the_reference_s():
    assert health.VERDICTS == ref_health.VERDICTS
    for v in health.VERDICTS:
        assert health.verdict_score(v) == ref_health.verdict_score(v)
    for s in (-1.0, 0.0, 0.4, 0.6, 1.49, 1.5, 2.0, 7.0):
        assert health.score_verdict(s) == ref_health.score_verdict(s)


@pytest.mark.parametrize("kw", [{"threshold": 1.0}, {"threshold": 3.0, "release": 0.5},
                                {"threshold": 3.0, "release": 4.0}])
def test_bad_configurations_are_refused_alike(kw):
    with pytest.raises(ValueError):
        health.HealthMonitor(**kw)
    with pytest.raises(ValueError):
        ref_health.HealthMonitor(**kw)


def _feed_window(monitors, lane, values, signal="fence"):
    for v in values:
        for m in monitors:
            m.observe(lane, signal, v)


def test_detector_flags_only_the_degraded_lane_in_both():
    pair = _pair({"window": 4})
    steady = [0.010, 0.011, 0.0095, 0.0105]
    for _ in range(6):
        _feed_window(pair, 0, steady)
        _feed_window(pair, 1, steady)
        assert [m.verdict(0) for m in pair] == ["ok", "ok"]
    flips = []
    for wnd in range(3):
        _feed_window(pair, 0, steady)
        _feed_window(pair, 1, [v * 5.0 for v in steady])
        flips.append([m.verdict(1) for m in pair])
    assert flips[-1] == ["degraded", "degraded"] and flips[0][0] == flips[0][1]
    assert [m.suggest_drain() for m in pair] == [[1], [1]]
    assert REGISTRY.gauge("ck_lane_health", lane=1).value == 2.0
    assert REF_REGISTRY.gauge("ck_lane_health", lane=1).value == 2.0
    assert pair[0].report() == pair[1].report()
    _feed_window(pair, 1, steady)
    assert [m.verdict(1) for m in pair] == ["ok", "ok"]
    assert _rows(DECISIONS) == _rows(REF_DECISIONS)


def test_suspect_before_confirm_and_hysteresis_in_both():
    pair = _pair({"threshold": 3.0, "window": 2, "confirm": 2, "min_history": 2})
    for _ in range(4):
        _feed_window(pair, 0, [0.010, 0.010])
    _feed_window(pair, 0, [0.031, 0.031])
    assert [m.verdict(0) for m in pair] == ["suspect"] * 2
    assert [m.suggest_drain() for m in pair] == [[], []]
    _feed_window(pair, 0, [0.031, 0.031])
    assert [m.verdict(0) for m in pair] == ["degraded"] * 2
    _feed_window(pair, 0, [0.025, 0.025])  # above release: no flap
    assert [m.verdict(0) for m in pair] == ["degraded"] * 2
    _feed_window(pair, 0, [0.011, 0.011])
    assert [m.verdict(0) for m in pair] == ["ok"] * 2
    assert pair[0].report() == pair[1].report()
    assert _rows(DECISIONS) == _rows(REF_DECISIONS)


def test_suggest_drain_records_only_a_changed_advice_in_both():
    pair = _pair({"window": 2, "min_history": 2, "confirm": 2})
    for _ in range(3):
        _feed_window(pair, 0, [0.01, 0.01])
    for _ in range(3):
        _feed_window(pair, 0, [0.1, 0.1])
    for _ in range(4):  # a poller during a sustained degradation
        assert [m.suggest_drain() for m in pair] == [[0], [0]]
    for _ in range(2):
        _feed_window(pair, 0, [0.01, 0.01])
    assert [m.suggest_drain() for m in pair] == [[], []]
    advisories = [r for r in _rows(DECISIONS) if r[0] == "drain-advisory"]
    assert len(advisories) == 2  # the advice, then the all-clear
    assert advisories == [r for r in _rows(REF_DECISIONS) if r[0] == "drain-advisory"]


def test_zero_baseline_evidence_is_json_safe_in_both():
    pair = _pair({"window": 2, "min_history": 2, "confirm": 2})
    for _ in range(3):
        _feed_window(pair, 0, [0.0, 0.0])
    _feed_window(pair, 0, [0.1, 0.1])
    reps = [m.report() for m in pair]
    assert reps[0] == reps[1]
    assert "Infinity" not in json.dumps(reps[0])
    assert reps[0][0]["evidence"]["fence"]["ratio"] is None
    assert reps[0][0]["evidence"]["fence"]["state"] == "suspect"


def test_the_peak_gauge_survives_a_later_monitor_in_both():
    lane = 7
    first = _pair({"window": 2, "min_history": 2, "confirm": 2})
    for _ in range(4):
        _feed_window(first, lane, [0.010, 0.010])
    for _ in range(2):
        _feed_window(first, lane, [0.05, 0.05])
    second = _pair({"window": 2, "min_history": 2, "confirm": 2})
    for _ in range(4):
        _feed_window(second, lane, [0.010, 0.010])
    mine = health.registry_health_summary()["lanes"][str(lane)]
    ref = ref_health.registry_health_summary()["lanes"][str(lane)]
    assert mine == ref
    assert mine["verdict"] == "ok" and mine["peak_verdict"] == "degraded"


@pytest.mark.parametrize("seed", range(4))
def test_registry_health_summary_reads_a_snapshot_alike(seed):
    rng = np.random.default_rng(seed)
    gauges = {}
    for lane in range(int(rng.integers(0, 6))):
        gauges[f'ck_lane_health{{lane="{lane}"}}'] = float(rng.integers(0, 3))
        if rng.random() < 0.5:
            gauges[f'ck_lane_health_peak{{lane="{lane}"}}'] = float(rng.integers(0, 3))
    gauges['ck_stream_chunk_count{lane="0"}'] = 4.0
    snap = {"counters": {}, "histograms": {}, "gauges": gauges}
    assert health.registry_health_summary(snap) == ref_health.registry_health_summary(snap)


@pytest.mark.parametrize("seed", range(4))
def test_cluster_health_table_merges_alike(seed):
    rng = np.random.default_rng(10 + seed)
    procs = []
    for _p in range(int(rng.integers(1, 5))):
        rep = {}
        for lane in range(int(rng.integers(0, 4))):
            v = health.VERDICTS[int(rng.integers(0, 3))]
            rec = {"verdict": v, "evidence": {"fence": {"ratio": float(rng.uniform(0, 6))}}}
            if rng.random() < 0.7:
                rec["score"] = health.verdict_score(v)
            rep[str(lane)] = rec
        procs.append(rep if rep or rng.random() < 0.5 else None)
    snap = {"health": procs}
    assert health.cluster_health_table(snap) == ref_health.cluster_health_table(snap)
    assert health.cluster_health_table({}) == ref_health.cluster_health_table({})


def test_threads_observing_one_monitor_lose_no_sample():
    """``observe`` runs on lane threads: concurrent samples of several
    lanes all land, window by window."""
    import threading

    mon = health.HealthMonitor(window=4, min_history=2)
    per_lane = 400

    def feed(lane):
        for _ in range(per_lane):
            mon.observe(lane, "fence", 0.01)

    threads = [threading.Thread(target=feed, args=(ln,)) for ln in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rep = mon.report()
    assert sorted(rep) == [0, 1, 2, 3]
    assert all(r["evidence"]["fence"]["windows"] == per_lane // 4 for r in rep.values())
    assert all(r["verdict"] == "ok" for r in rep.values())
