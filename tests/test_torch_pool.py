"""The task and device pools of the port against the JAX package's, on
host-CPU lanes.

The scenarios of the reference's ``tests/test_pool.py`` run through both
packages' ``ClDevicePool`` on the same tasks; results and the counts the
scenario fixes (pinned lanes, a broadcast on every lane, tasks done) must be
equal.  ``DEVICE_ROUND_ROBIN`` is refused by both.  The storm runs with
the marker throttle (``fine_grained_queue_control``) in both packages.
Every pool is disposed inside its test, and its producer and consumer
threads must have ended.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import pytest

import cekirdekler_tpu
import cekirdekler_tpu_torch as ck
from cekirdekler_tpu.hardware import platforms as ref_platforms
from cekirdekler_tpu.pipeline import pool as ref_pool
from cekirdekler_tpu_torch.metrics.registry import REGISTRY
from cekirdekler_tpu_torch.pipeline import pool as port_pool

SRC = """
__kernel void addOne(__global float* a) {
    int i = get_global_id(0);
    a[i] = a[i] + 1.0f;
}
__kernel void scale2(__global float* a) {
    int i = get_global_id(0);
    a[i] = a[i] * 2.0f;
}
"""

PKGS = {"port": (port_pool, ck.ClArray), "ref": (ref_pool, cekirdekler_tpu.ClArray)}
BOTH = pytest.mark.parametrize("pkg", ["port", "ref"])


def _lanes(pkg: str, n: int):
    return ck.all_devices().cpus(n) if pkg == "port" else ref_platforms().cpus().subset(n)


def _task(pool_mod, arr, kernel, cid):
    return pool_mod.ClTask(params=[arr], kernel_names=[kernel], compute_id=cid,
                           global_range=arr.size, local_range=64)


def _ended(dp) -> None:
    """The pool's threads have ended (the port's ``dispose`` joins them)."""
    threads = list(dp._consumers) + [dp._producer]
    for t in threads:
        t.join(timeout=10.0)
        assert not t.is_alive(), t.name


def _run(pkg: str, lanes: int, pools, **kw):
    """Run the task pools on a new device pool of ``lanes`` lanes; returns
    the tasks done per lane."""
    mod, _ = PKGS[pkg]
    dp = mod.ClDevicePool(_lanes(pkg, lanes), SRC, **kw)
    try:
        for p in pools:
            dp.enqueue_task_pool(p)
        dp.finish()
        return dp.tasks_done_per_device()
    finally:
        dp.dispose()
        if pkg == "port":
            _ended(dp)


@BOTH
def test_pool_runs_all_tasks_greedily(pkg):
    mod, CA = PKGS[pkg]
    arrays = [CA(np.zeros(256, np.float32)) for _ in range(12)]
    pool = mod.ClTaskPool()
    for i, a in enumerate(arrays):
        pool.add(_task(mod, a, "addOne", 100 + i))
    assert sum(_run(pkg, 4, [pool])) == 12
    for a in arrays:
        np.testing.assert_array_equal(a.host(), np.ones(256, np.float32))


@BOTH
def test_device_select_pins_tasks(pkg):
    mod, CA = PKGS[pkg]
    pool = mod.ClTaskPool()
    pool.add(mod.ClTask.device_select_begin(1))
    arrays = [CA(np.zeros(128, np.float32)) for _ in range(4)]
    for i, a in enumerate(arrays):
        pool.add(_task(mod, a, "addOne", 200 + i))
    pool.add(mod.ClTask.device_select_end())
    assert _run(pkg, 3, [pool]) == [0, 4, 0]
    for a in arrays:
        np.testing.assert_array_equal(a.host(), np.ones(128, np.float32))


@BOTH
def test_global_synchronization_orders_phases(pkg):
    """addOne, a global synchronization, then scale2 on one array: (0+1)*2
    everywhere; without the barrier scale2 could run first."""
    mod, CA = PKGS[pkg]
    a = CA(np.zeros(128, np.float32))
    pool = mod.ClTaskPool()
    pool.add(_task(mod, a, "addOne", 300))
    pool.add(mod.ClTask.global_synchronization())
    pool.add(_task(mod, a, "scale2", 301))
    _run(pkg, 2, [pool])
    np.testing.assert_array_equal(a.host(), np.full(128, 2.0, np.float32))


@BOTH
def test_broadcast_runs_on_every_device(pkg):
    mod, CA = PKGS[pkg]
    a = CA(np.zeros(64, np.float32))
    counter = []
    t = _task(mod, a, "addOne", 400).as_broadcast()
    t.callback = lambda task: counter.append(1)
    assert _run(pkg, 3, [mod.ClTaskPool([t])]) == [1, 1, 1]
    assert len(counter) == 3


@BOTH
def test_serial_mode_executes_in_order(pkg):
    mod, CA = PKGS[pkg]
    a = CA(np.zeros(64, np.float32))
    order = []
    pool = mod.ClTaskPool()
    pool.add(mod.ClTask.serial_mode_begin())
    for i in range(6):
        t = _task(mod, a, "addOne" if i % 2 == 0 else "scale2", 500 + i)
        t.callback = lambda task, i=i: order.append(i)
        pool.add(t)
    pool.add(mod.ClTask.serial_mode_end())
    _run(pkg, 3, [pool])
    assert order == list(range(6))
    np.testing.assert_array_equal(a.host(), np.full(64, 14.0, np.float32))  # ((1*2+1)*2+1)*2


@BOTH
def test_hot_add_device(pkg):
    mod, CA = PKGS[pkg]
    arrays = [CA(np.zeros(128, np.float32)) for _ in range(8)]
    pool = mod.ClTaskPool()
    for i, a in enumerate(arrays):
        pool.add(_task(mod, a, "addOne", 600 + i))
    dp = mod.ClDevicePool(_lanes(pkg, 1), SRC)
    try:
        dp.add_device(ck.all_devices().cpus(1)[0] if pkg == "port"
                      else ref_platforms().cpus()[1])
        assert dp.num_devices == 2
        dp.enqueue_task_pool(pool)
        dp.finish()
        assert sum(dp.tasks_done_per_device()) == 8
    finally:
        dp.dispose()
    if pkg == "port":
        _ended(dp)
    for a in arrays:
        np.testing.assert_array_equal(a.host(), np.ones(128, np.float32))


@BOTH
def test_round_robin_rejected(pkg):
    mod, _ = PKGS[pkg]
    with pytest.raises(Exception, match="DEVICE_COMPUTE_AT_WILL"):
        mod.ClDevicePool(_lanes(pkg, 1), SRC, pool_type=mod.PoolType.DEVICE_ROUND_ROBIN)


@BOTH
def test_callbacks_and_errors_surface(pkg):
    """A task naming no kernel of the program fails at ``finish``; the lane
    runs the next pool's task all the same."""
    mod, CA = PKGS[pkg]
    bad = mod.ClTask(params=[CA(np.zeros(64, np.float32))], kernel_names=["nope"],
                     compute_id=700, global_range=64, local_range=64)
    good = CA(np.zeros(64, np.float32))
    dp = mod.ClDevicePool(_lanes(pkg, 1), SRC)
    try:
        dp.enqueue_task_pool(mod.ClTaskPool([bad]))
        with pytest.raises(Exception, match="nope"):
            dp.finish()
        dp.enqueue_task_pool(mod.ClTaskPool([_task(mod, good, "addOne", 701)]))
        dp.finish()
    finally:
        dp.dispose()
    if pkg == "port":
        _ended(dp)
    np.testing.assert_array_equal(good.host(), np.ones(64, np.float32))


@BOTH
def test_task_factory_from_array_and_group(pkg):
    _, CA = PKGS[pkg]
    a = CA(np.zeros(64, np.float32))
    t = a.task(800, "addOne", 64, 64)
    assert t.kernel_names == ["addOne"] and t.global_range == 64 and t.params == [a]
    b = CA(np.zeros(64, np.float32))
    g = a.next_param(b).task(801, "addOne scale2", 64, 32, global_offset=0)
    assert g.kernel_names == ["addOne", "scale2"] and g.local_range == 32
    assert len(g.params) == 2


def test_feed_tags_untagged_tasks_with_the_tenant():
    """``ClTaskPool.feed``: the fed pool's tasks are appended, the untagged
    ones tagged; a tenant's tasks count on its own series.  Feeding a pool
    into itself does not deadlock."""
    a = ck.ClArray(np.zeros(64, np.float32))
    src = port_pool.ClTaskPool([_task(port_pool, a, "addOne", 900)])
    tagged = _task(port_pool, a, "addOne", 901)
    tagged.tenant = "b"
    src.add(tagged)
    dst = port_pool.ClTaskPool()
    dst.feed(src, tenant="a")
    assert [t.tenant for t in dst.snapshot()] == ["a", "b"] and len(dst) == 2
    src.feed(src)
    assert len(src) == 4
    series = {t: REGISTRY.counter("ck_pool_tasks_total", "device-pool tasks completed",
                                  lane=0, tenant=t) for t in "ab"}
    before = {t: c.value for t, c in series.items()}
    _run("port", 1, [dst])
    np.testing.assert_array_equal(a.host(), np.full(64, 2.0, np.float32))
    assert {t: series[t].value - before[t] for t in "ab"} == {"a": 1, "b": 1}


@BOTH
def test_task_storm_bounded(pkg):
    """The reference's storm of 40 tasks on 2 lanes with its marker
    throttle (``fine_grained_queue_control``, ``queue_limit=4``), the
    pipe's backpressure bounding what is queued.  Each lane's marker depth
    stays within the limit plus one task's markers, the reference's ~3.  A
    port task adds one upload, one launch and one download marker, or one
    of each a chunk where the transfer tuner streams it in chunks; every
    marker a port lane added has reached."""
    mod, CA = PKGS[pkg]
    arrs = [CA(np.zeros(128, np.float32), name=f"s{i}") for i in range(40)]
    tp = mod.ClTaskPool()
    for i, a in enumerate(arrs):
        a.partial_read = True
        tp.add(_task(mod, a, "addOne", i + 1))
    dp = mod.ClDevicePool(_lanes(pkg, 2), SRC, fine_grained_queue_control=True, queue_limit=4,
                          max_queues_per_device=8, backpressure=4)
    try:
        dp.enqueue_task_pool(tp)
        dp.finish()
        done = dp.tasks_done_per_device()
        depth = dp.max_inflight_depth()
        if pkg == "port":
            for c in dp._consumers:
                w = c.cruncher.cores.workers[0]
                w.markers.drain(timeout=10.0)
                assert w.markers.remaining() == 0
                # each array is one task's: its chunk copies, or its one copy
                per_task = [w.chunk_transfers["h2d", a.name] or 1 for a in arrs
                            if w.transfers["h2d", a.name]]
                assert len(per_task) == c.tasks_done
                assert dict(w.markers_by_site) == (
                    {site: sum(per_task) for site in ("h2d", "launch", "d2h")}
                    if per_task else {})
    finally:
        dp.dispose()
        if pkg == "port":
            _ended(dp)
    assert sum(done) == 40
    assert 0 <= depth <= 4 + 3, depth
    for a in arrs:
        np.testing.assert_array_equal(a.host(), np.ones(128, np.float32))


@BOTH
def test_adaptive_queue_depth_spreads_tail(pkg):
    """Many tasks: no lane claims them all, and most lanes take some."""
    mod, CA = PKGS[pkg]
    arrs = [CA(np.zeros(128, np.float32), name=f"t{i}") for i in range(48)]
    tp = mod.ClTaskPool()
    for i, a in enumerate(arrs):
        a.partial_read = True
        tp.add(_task(mod, a, "addOne", i + 1))
    done = _run(pkg, 4, [tp], max_queues_per_device=16)
    assert sum(done) == 48 and max(done) < 40, done
    assert sum(1 for d in done if d > 0) >= 3, done


def test_a_storm_over_more_lanes_than_cores_loses_no_task():
    """Twelve host lanes, 240 tasks on 60 arrays (four each, in two pools
    and two pool feeds), a switch interval of 10 µs: every array ends at 4
    exactly, every task is counted once, and the pool stops its threads."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    arrays = [ck.ClArray(np.zeros(64, np.float32), name=f"z{i}") for i in range(60)]
    try:
        pools = []
        for rep in range(2):
            tp = port_pool.ClTaskPool()
            for i, a in enumerate(arrays):
                tp.add(_task(port_pool, a, "addOne", 1000 + 100 * rep + i))
            fed = port_pool.ClTaskPool()
            fed.feed(tp)
            pools += [tp, fed]
        t0 = time.perf_counter()
        # one task per array at a time: a global synchronization between pools
        done = []
        dp = port_pool.ClDevicePool(ck.all_devices().cpus(12), SRC, backpressure=8)
        try:
            for p in pools:
                dp.enqueue_task_pool(p)
                dp.enqueue_task_pool(port_pool.ClTaskPool(
                    [port_pool.ClTask.global_synchronization()]))
            dp.finish()
            done = dp.tasks_done_per_device()
        finally:
            dp.dispose()
        _ended(dp)
        assert time.perf_counter() - t0 < 120.0
    finally:
        sys.setswitchinterval(interval)
    assert sum(done) == 240
    for a in arrays:
        np.testing.assert_array_equal(a.host(), np.full(64, 4.0, np.float32))
