"""The cruncher's balancer and report toggles, ``no_compute_mode``,
``benchrig.convergence_sim`` and ``workloads.nbody_e2e`` of the port
against the JAX package's, on host-CPU lanes.

Both packages get the same calls (``Pair`` of ``tests/test_torch_enqueue.py``)
or the same injected lane benches; ranges, results and ``fused_stats``
must be equal.  Range trajectories are driven through each package's own
``Cores._ranges_for`` with benches set on its workers, so no wall clock
enters them.
"""

from __future__ import annotations

import numpy as np
import pytest

import cekirdekler_tpu_torch as ck
from cekirdekler_tpu import benchrig as ref_benchrig
from cekirdekler_tpu.errors import CekirdeklerError as RefError
from cekirdekler_tpu_torch import benchrig
from cekirdekler_tpu_torch import workloads as wl
from cekirdekler_tpu_torch.errors import CekirdeklerError
from tests.test_torch_enqueue import Pair

VADD = """
__kernel void vadd(__global float* a, __global float* b, __global float* c) {
    int i = get_global_id(0);
    c[i] = a[i] + b[i];
}
"""
INC = """
__kernel void inc(__global float* a) {
    int i = get_global_id(0);
    a[i] = a[i] + 1.0f;
}
"""


def _abc(CA, n: int = 1024):
    a = CA(np.arange(n, dtype=np.float32), name="a")
    b = CA(np.ones(n, np.float32), name="b")
    c = CA(np.zeros(n, np.float32), name="c")
    return a, b, c


def test_fixed_compute_powers_pin_the_split():
    """The reference's ``test_fixed_compute_powers``: [3, 1] gives 768 and
    256 of 1024, in both packages, and the result is exact."""
    pair = Pair(VADD, 2)
    try:
        seen = []
        for cr, CA in pair.both():
            cr.normalized_compute_powers_of_devices = [3, 1]
            assert cr.normalized_compute_powers_of_devices == [0.75, 0.25]
            a, b, c = _abc(CA)
            for _ in range(3):  # pinned: no rebalance moves it
                a.next_param(b).next_param(c).compute(cr, 1, "vadd", 1024, 64)
                seen.append(cr.ranges_of(1))
            np.testing.assert_allclose(np.asarray(c), np.arange(1024) + 1)
            with pytest.raises((CekirdeklerError, RefError)):
                cr.normalized_compute_powers_of_devices = [1, 2, 3]
            cr.normalized_compute_powers_of_devices = None
            assert cr.normalized_compute_powers_of_devices is None
        assert seen == [[768, 256]] * 6
    finally:
        pair.dispose()


@pytest.mark.parametrize("powers", [[1, 1, 1, 5], [0.2, 0.3, 0.1, 0.4], [7, 0.01, 1, 1]])
@pytest.mark.parametrize("total, step", [(4096, 64), (1000, 8), (256, 64)])
def test_fixed_compute_powers_round_as_the_reference(powers, total, step):
    pair = Pair(VADD, 4)
    try:
        got = []
        for cr, _CA in pair.both():
            cr.normalized_compute_powers_of_devices = powers
            got.append(cr.cores._ranges_for(5, total, step, rebalance=True)[0])
        assert got[0] == got[1] and sum(got[0]) == total
    finally:
        pair.dispose()


def _bench(ranges: list[int], cost: list[float]) -> list[float]:
    """A lane's bench: the summed cost of its contiguous slice."""
    offs = np.concatenate([[0], np.cumsum(ranges)]).astype(int)
    cum = np.concatenate([[0.0], np.cumsum(cost)])
    return [float(cum[offs[i + 1]] - cum[offs[i]]) + 1e-3 for i in range(len(ranges))]


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("smooth", [True, False])
def test_balancer_toggles_give_the_reference_trajectory(adaptive, smooth):
    """The same benches into both packages' ``Cores`` (set on the workers,
    the balancer run through ``_ranges_for``) give equal range tables
    every iteration, for each setting of ``adaptive_load_balancer`` and
    ``smooth_load_balancer``; a skewed cost field makes the split move."""
    total, step = 8192, 64
    rng = np.random.default_rng(7)
    cost = np.abs(rng.standard_normal(total)) + np.linspace(0.0, 4.0, total)
    pair = Pair(VADD, 3)
    try:
        trajs = []
        for cr, _CA in pair.both():
            cr.adaptive_load_balancer = adaptive
            cr.smooth_load_balancer = smooth
            assert (cr.adaptive_load_balancer, cr.smooth_load_balancer) == (adaptive, smooth)
            cores = cr.cores
            ranges = cores._ranges_for(9, total, step, rebalance=True)[0]
            traj = [list(ranges)]
            for _ in range(30):
                for w, b in zip(cores.workers, _bench(ranges, cost)):
                    w.benchmarks[9] = b
                ranges = cores._ranges_for(9, total, step, rebalance=True)[0]
                traj.append(list(ranges))
            trajs.append(traj)
            assert (9 in cores.histories) == smooth
        assert trajs[0] == trajs[1]
        assert trajs[0][0] != trajs[0][-1]
    finally:
        pair.dispose()


def test_toggling_the_adaptive_balancer_clears_its_state():
    pair = Pair(VADD, 2)
    try:
        for cr, _CA in pair.both():
            cores = cr.cores
            cores._ranges_for(3, 1024, 64, rebalance=True)
            for w, b in zip(cores.workers, (2.0, 1.0)):
                w.benchmarks[3] = b
            cores._ranges_for(3, 1024, 64, rebalance=True)
            assert cores.histories and cores._balance_states
            cr.adaptive_load_balancer = True  # no change: state kept
            assert cores._balance_states
            cr.adaptive_load_balancer = False
            assert not cores.histories and not cores._balance_states
            cores._ranges_for(3, 1024, 64, rebalance=True)
            assert cores._cont_ranges and not cores._balance_states
            cr.adaptive_load_balancer = True
            assert not cores._cont_ranges
    finally:
        pair.dispose()


def test_performance_history_and_the_last_report():
    """The reference's ``test_performance_history_accumulates`` and
    ``test_facade_compat_toggles``: four calls leave four reports of the
    compute id, the last one covering every item, and the last report
    names the compute id and its work items."""
    src = "__kernel void f(__global float* a){ int i=get_global_id(0); a[i]+=1.0f; }"
    pair = Pair(src, 2)
    try:
        for cr, CA in pair.both():
            assert cr.last_compute_performance_report == "(no compute has run)"
            a = CA(np.zeros(256, np.float32))
            for _ in range(4):
                a.compute(cr, 7, "f", 256, 64)
            hist = cr.performance_history(7)
            assert len(hist) == 4
            assert all(p.compute_id == 7 for p in hist)
            assert sum(hist[-1].device_items) == 256
            assert cr.performance_history(8) == []
            rep = cr.last_compute_performance_report
            assert "compute id 7" in rep and "workitems" in rep
            np.testing.assert_array_equal(np.asarray(a), 4.0)
        assert len(pair.port.cores.perf_log[7].maxlen * [0]) == 64
    finally:
        pair.dispose()


@pytest.mark.parametrize("fused", [False, True])
def test_performance_feed_prints_each_call(capsys, fused):
    with ck.NumberCruncher(ck.all_devices().cpus(2), INC) as cr:
        cr.fused_dispatch = fused
        x = ck.ClArray(np.zeros(512, np.float32), name="x", partial_read=True)
        x.compute(cr, 3, "inc", 512, 64)
        assert capsys.readouterr().out == ""
        cr.performance_feed = True
        assert cr.performance_feed
        x.compute(cr, 3, "inc", 512, 64)
        printed = capsys.readouterr().out
        assert "compute id 3" in printed and printed.count("workitems") == 2
        cr.enqueue_mode = True
        for _ in range(4):
            x.compute(cr, 3, "inc", 512, 64)
        assert capsys.readouterr().out.count("compute id 3") >= 4
        cr.enqueue_mode = False
        np.testing.assert_array_equal(x.host(), 6.0)


def test_no_compute_mode_per_call_moves_data_and_launches_nothing():
    pair = Pair(INC, 2)
    try:
        for cr, CA in pair.both():
            x = CA(np.full(1024, 3.0, np.float32), name="x")
            x.partial_read = True
            x.compute(cr, 1, "inc", 1024, 64)
            cr.no_compute_mode = True
            assert cr.no_compute_mode
            for _ in range(3):
                x.compute(cr, 1, "inc", 1024, 64)
            np.testing.assert_array_equal(np.asarray(x), 4.0)
            cr.no_compute_mode = False
            x.compute(cr, 1, "inc", 1024, 64)
            np.testing.assert_array_equal(np.asarray(x), 5.0)
        for w in pair.port.cores.workers:
            assert w.transfers["h2d", "x"] == 5 and w.transfers["d2h", "x"] == 5
    finally:
        pair.dispose()


@pytest.mark.parametrize("fused", [False, True])
def test_no_compute_mode_in_enqueue_mode(fused):
    """Enqueued I/O-only calls: nothing launches, the flush reads the
    untouched data back, and with fused dispatch on the repeat is refused
    as ``no-compute``, in both packages alike."""
    pair = Pair(INC, 2, fused=fused)
    try:
        for cr, CA in pair.both():
            x = CA(np.zeros(512, np.float32), name="x")
            x.partial_read = True
            cr.no_compute_mode = True
            cr.enqueue_mode = True
            for _ in range(4):
                x.compute(cr, 2, "inc", 512, 64)
            cr.enqueue_mode = False
            np.testing.assert_array_equal(np.asarray(x), 0.0)
            cr.no_compute_mode = False
        assert pair.port.fused_stats == pair.ref.fused_stats
        assert pair.port.fused_stats["disengaged"].get("no-compute", 0) == (3 if fused else 0)
        for w in pair.port.cores.workers:
            assert w.transfers["h2d", "x"] == 1 and w.transfers["d2h", "x"] == 1
    finally:
        pair.dispose()


def test_no_compute_mode_mid_window_breaks_it():
    """The reference's ``test_disengage_mode_change_mid_window``: turning on
    ``repeat_count`` and then ``no_compute_mode`` inside an open window
    breaks it as ``mode-change``; the I/O-only call applies nothing
    (1 + 1 + 3 + 1 + 1 + 0 = 7)."""
    pair = Pair(INC, 2, fused=True)
    try:
        for cr, CA in pair.both():
            x = CA(np.zeros(512, np.float32), name="x")
            x.partial_read = True
            cr.enqueue_mode = True
            x.compute(cr, 66, "inc", 512, 64)
            x.compute(cr, 66, "inc", 512, 64)
            cr.repeat_count = 3
            x.compute(cr, 66, "inc", 512, 64)
            assert cr.fused_stats["disengaged"].get("mode-change", 0) == 1
            cr.repeat_count = 1
            x.compute(cr, 66, "inc", 512, 64)
            x.compute(cr, 66, "inc", 512, 64)
            cr.no_compute_mode = True
            x.compute(cr, 66, "inc", 512, 64)
            assert cr.fused_stats["disengaged"].get("mode-change", 0) == 2
            cr.no_compute_mode = False
            cr.enqueue_mode = False
            np.testing.assert_array_equal(np.asarray(x), 7.0)
        assert pair.port.fused_stats == pair.ref.fused_stats
    finally:
        pair.dispose()


def test_compute_fused_batch_refuses_a_no_compute_window():
    pair = Pair(INC, 2, fused=True)
    try:
        for cr, CA in pair.both():
            x = CA(np.zeros(256, np.float32), name="x")
            x.partial_read = True
            cr.enqueue_mode = True
            cr.cores.compute_fused_batch(["inc"], [x], 5, 256, 64, 6)
            cr.no_compute_mode = True
            out = cr.cores.compute_fused_batch(["inc"], [x], 5, 256, 64, 3)
            assert out["per_call_iters"] == 3 and not out["fused"]
            cr.no_compute_mode = False
            cr.enqueue_mode = False
            np.testing.assert_array_equal(np.asarray(x), 6.0)
        assert pair.port.fused_stats == pair.ref.fused_stats
    finally:
        pair.dispose()


@pytest.mark.parametrize("ndev, step", [(8, 256), (4, 128), (3, 512)])
def test_convergence_sim_equals_the_reference(ndev, step):
    assert benchrig.convergence_sim(ndev, step) == ref_benchrig.convergence_sim(ndev, step)


def test_nbody_e2e_on_host_lanes_is_within_the_host_check():
    """Two host lanes, a small n: the synchronous first step within 0.01
    of the host O(n^2) step, three windows of enqueued calls, the fused
    windows counted; one host lane is split into two partition lanes."""
    for devs in (ck.all_devices().cpus(2), ck.all_devices().cpus(1)):
        r = wl.nbody_e2e(devs, n=256, iters=6, window=3, local_range=64)
        assert r["checked"] and r["host_check_max_err"] <= 0.01
        assert r["lanes"] == 2 and r["iters"] == 6 and r["gpairs_per_sec"] >= 0
        assert sum(r["ranges_final"]) == 256
        assert r["fused"]["enabled"] and r["fused"]["deferred_iters"] > 0


@pytest.mark.parametrize("kw", [{"attribution": True}, {"device_timeline_dir": "x"},
                                {"attribution": True, "device_timeline_dir": "x"}])
def test_nbody_e2e_tracing_options_wait_for_the_tracer(kw, tmp_path):
    """The options that waited for the span tracer and the device
    timeline: ``attribution`` names the reference's factors, and
    ``device_timeline_dir`` (read only with ``attribution``, as in the
    reference) adds a kernel profile, a named absence on host lanes."""
    from cekirdekler_tpu.hardware import platforms as ref_platforms
    from cekirdekler_tpu.workloads import nbody_e2e as ref_nbody_e2e

    kw = {k: (str(tmp_path) if k == "device_timeline_dir" else v) for k, v in kw.items()}
    r = wl.nbody_e2e(ck.all_devices().cpus(1), n=256, iters=4, window=2, local_range=64,
                     probe_iters=2, **kw)
    ref = ref_nbody_e2e(ref_platforms().cpus().subset(1), n=256, iters=4, window=2,
                        local_range=64, probe_iters=2, **kw)
    assert r["checked"] and r["host_check_max_err"] <= 0.01
    assert set(r) == set(ref)
    if not kw.get("attribution"):
        assert "attribution" not in r
        return
    att, ref_att = r["attribution"], ref["attribution"]
    assert set(att) == set(ref_att)
    assert set(att["factors"]) == set(ref_att["factors"])
    assert att["factors"]["window_rtt"]["count"] == ref_att["factors"]["window_rtt"]["count"] == 2
    assert att["factors"]["ladder_launch"]["count"] > 0
    assert att["per_lane_kind_ms"].keys() == {"cpu"}
    assert set(att["lane_interference"]) == set(ref_att["lane_interference"])
    assert att["lane_interference"]["lanes"] == 2 and att["lane_interference"]["factor"] > 0
    if "device_timeline_dir" in kw:
        assert att["kernel_profile"] == {"absent": att["kernel_profile"]["absent"]}
        assert "no device op" in att["kernel_profile"]["absent"]
        assert att["device_events"] == 0 and att["device_busy_frac_of_wall"] is None
