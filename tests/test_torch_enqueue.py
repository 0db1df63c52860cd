"""Enqueue mode of the port against the JAX package's, on host-CPU lanes.

The scenarios of the reference's own enqueue tests
(``tests/test_core.py``, ``tests/test_workloads.py``, ``tests/test_fused.py``)
run through both packages' ``NumberCruncher`` on the same inputs, with
``fused_dispatch`` set alike in both (:class:`Pair`; the fused windows
themselves are ``tests/test_torch_fused.py``'s, which uses this harness).
Where ranges are compared, neither balancer reads a wall clock: each
package's ``cores`` module gets a modelled ``time`` whose ``perf_counter``
reads 0 except right after a lane's fence, where it reads that lane's
modelled retire time (:class:`ModelClock`).  Both balancers then see the
same fence times, and every range table and every result must be
identical.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

import cekirdekler_tpu
import cekirdekler_tpu_torch as ck
from cekirdekler_tpu.core import cores as ref_cores
from cekirdekler_tpu.core.cruncher import NumberCruncher as RefCruncher
from cekirdekler_tpu.hardware import platforms as ref_platforms
from cekirdekler_tpu_torch import workloads as wl
from cekirdekler_tpu_torch.core import cores as port_cores

INC = """
__kernel void inc(__global float* a) {
    int i = get_global_id(0);
    a[i] = a[i] + 1.0f;
}
"""
FILLIDX = """
__kernel void fillidx(__global float* o) {
    int i = get_global_id(0);
    o[i] = (float)i;
}
"""


class ModelClock:
    """A ``time`` module for a ``cores`` module: ``perf_counter`` reads 0.0
    except in a thread whose lane fence has just returned, where it reads
    ``lags[lane]`` seconds; everything else is the real ``time``."""

    def __init__(self):
        self._tls = threading.local()
        self.lags: dict[int, float] = {}

    def perf_counter(self) -> float:
        return getattr(self._tls, "now", 0.0)

    def __getattr__(self, name):
        return getattr(time, name)

    def attach(self, cruncher) -> None:
        for w in cruncher.cores.workers:
            orig = w.fence

            def fence(w=w, orig=orig):
                orig()
                self._tls.now = self.lags.get(w.index, 0.0)

            w.fence = fence


class Pair:
    """The same cruncher in both packages, on ``lanes`` CPU lanes each, with
    fused dispatch set to ``fused`` in both."""

    def __init__(self, src, lanes: int, monkeypatch=None, ref_src=None, fused: bool = False):
        self.port = ck.NumberCruncher(ck.all_devices().cpus(lanes), src)
        self.ref = RefCruncher(ref_platforms().cpus().subset(lanes),
                               src if ref_src is None else ref_src)
        self.port.fused_dispatch = fused
        self.ref.fused_dispatch = fused
        self.clocks = None
        if monkeypatch is not None:
            self.clocks = (ModelClock(), ModelClock())
            monkeypatch.setattr(port_cores, "time", self.clocks[0])
            monkeypatch.setattr(ref_cores, "time", self.clocks[1])
            self.clocks[0].attach(self.port)
            self.clocks[1].attach(self.ref)

    def lag(self, **lags: float) -> None:
        for c in self.clocks:
            c.lags = {int(k[4:]): v for k, v in lags.items()}

    def both(self):
        return ((self.port, ck.ClArray), (self.ref, cekirdekler_tpu.ClArray))

    def dispose(self) -> None:
        self.port.dispose()
        self.ref.dispose()


FUSED = pytest.mark.parametrize("fused", [False, True])


@FUSED
def test_readback_is_deferred_until_leaving_enqueue_mode(fused):
    pair = Pair(INC, 2, fused=fused)
    try:
        for cr, CA in pair.both():
            x = CA(np.zeros(256, np.float32), name="x")
            x.partial_read = True
            cr.enqueue_mode = True
            for _ in range(5):
                x.compute(cr, 1, "inc", 256, 64)
            assert np.all(np.asarray(x) == 0.0)
            cr.enqueue_mode = False  # leaving enqueue mode flushes
            np.testing.assert_array_equal(np.asarray(x), 5.0)
        transfers = [dict(w.transfers) for w in pair.port.cores.workers]
        assert transfers == [{("h2d", "x"): 1, ("d2h", "x"): 1}] * 2
    finally:
        pair.dispose()


@FUSED
def test_a_slow_lane_loses_share_after_a_barrier_and_not_before(monkeypatch, fused):
    pair = Pair(INC, 2, monkeypatch, fused=fused)
    pair.lag(lane0=0.25, lane1=0.01)
    try:
        seen = []
        for cr, CA in pair.both():
            x = CA(np.zeros(4096, np.float32), name="x")
            x.partial_read = True
            cr.enqueue_mode = True
            ranges = []
            for _ in range(3):
                x.compute(cr, 9, "inc", 4096, 64)
                ranges.append(cr.ranges_of(9))
            cr.barrier()
            for _ in range(3):
                x.compute(cr, 9, "inc", 4096, 64)
                ranges.append(cr.ranges_of(9))
            cr.enqueue_mode = False
            np.testing.assert_array_equal(np.asarray(x), 6.0)
            seen.append(ranges)
        port, ref = seen
        assert port == ref
        assert port[0] == port[1] == port[2] == [2048, 2048]
        assert port[3][0] < 2048 and sum(port[3]) == 4096
        assert port[3] == port[4] == port[5]
    finally:
        pair.dispose()


@FUSED
def test_a_write_only_image_stays_exact_across_a_move(monkeypatch, fused):
    pair = Pair(FILLIDX, 2, monkeypatch, fused=fused)
    pair.lag(lane0=0.01, lane1=0.25)
    try:
        seen = []
        for cr, CA in pair.both():
            o = CA(4096, np.float32, name="o")
            o.write_only = True
            cr.enqueue_mode = True
            o.compute(cr, 11, "fillidx", 4096, 64)
            cr.barrier()
            o.compute(cr, 11, "fillidx", 4096, 64)
            seen.append(cr.ranges_of(11))
            cr.enqueue_mode = False
            np.testing.assert_array_equal(np.asarray(o), np.arange(4096, dtype=np.float32))
        assert seen[0] == seen[1] and seen[0][1] < 2048
    finally:
        pair.dispose()


@FUSED
def test_a_reacquired_range_is_not_stale(monkeypatch, fused):
    """Ranges oscillate across barriers (the slow lane alternates), so a
    lane re-acquires a region another lane updated in between: its upload
    coverage was reset at every move, and the values stay exact."""
    pair = Pair(INC, 2, monkeypatch, fused=fused)
    try:
        seen = []
        for cr, CA in pair.both():
            x = CA(np.zeros(4096, np.float32), name="x")
            x.partial_read = True
            cr.enqueue_mode = True
            ranges = []
            for ph in range(4):
                pair.lag(lane0=0.2 if ph % 2 == 0 else 0.01, lane1=0.01 if ph % 2 == 0 else 0.2)
                for _ in range(2):
                    x.compute(cr, 13, "inc", 4096, 64)
                    ranges.append(cr.ranges_of(13))
                cr.barrier()
            cr.enqueue_mode = False
            np.testing.assert_array_equal(np.asarray(x), 8.0)
            seen.append(ranges)
        assert seen[0] == seen[1]
        moves = sum(a != b for a, b in zip(seen[0], seen[0][1:]))
        assert moves >= 2, seen[0]
    finally:
        pair.dispose()


def test_write_all_is_read_back_by_a_single_owner():
    src = "__kernel void f(__global float* o){ int i=get_global_id(0); o[i]=o[i]+1.0f; }"
    pair = Pair(src, 4)
    try:
        for cr, CA in pair.both():
            out = CA(np.zeros(512, np.float32), read=False, write=True, write_all=True)
            cr.enqueue_mode = True
            out.compute(cr, 3, "f", 512, 64)
            assert len(cr.cores._enqueued) == 1
            cr.enqueue_mode = False
        d2h = [sum(v for (d, _), v in w.transfers.items() if d == "d2h")
               for w in pair.port.cores.workers]
        assert sorted(d2h) == [0, 0, 0, 1]
    finally:
        pair.dispose()


def test_two_compute_ids_splitting_one_array_lose_no_update():
    """Compute id 1 splits ``x`` over all 4096 items, id 2 over its first
    2048, in one enqueue window.  The port flushes and resets coverage at
    the re-split and ends exact; the reference applies that rule per
    compute id, re-uploads a stale host copy of [1024, 2048) on lane 1 and
    keeps only lane 1's newest readback, so it loses both updates there
    and in [2048, 4096) (ROADMAP Queue C 8)."""
    pair = Pair(INC, 2)
    try:
        got = []
        for cr, CA in pair.both():
            x = CA(np.zeros(4096, np.float32), name="x")
            x.partial_read = True
            cr.enqueue_mode = True
            x.compute(cr, 1, "inc", 4096, 64)
            x.compute(cr, 2, "inc", 2048, 64)
            cr.enqueue_mode = False
            got.append(np.asarray(x).copy())
        want = np.r_[np.full(2048, 2.0, np.float32), np.ones(2048, np.float32)]
        np.testing.assert_array_equal(got[0], want)
        assert np.all(got[1][1024:2048] == 1.0) and np.all(got[1][2048:] == 0.0)
    finally:
        pair.dispose()


@FUSED
def test_saxpy_kernel_path_matches_jax(monkeypatch, fused):
    """The ``@kernel`` saxpy over the elementwise op, in enqueue mode on two
    lanes with a barrier-armed move: the JAX package's Pallas saxpy in
    interpret mode (``static_values=True``) against the port's
    ``workloads.saxpy_kernel``.  Integer inputs and a = 0.5 keep every
    ``a*x + y`` exact, so XLA's FMA contraction cannot differ."""
    import jax.lax as lax

    from cekirdekler_tpu.kernel import kernel as ref_kernel
    from cekirdekler_tpu.ops import saxpy as ref_saxpy

    @ref_kernel(name="saxpy", static_values=True)
    def ref_saxpy_k(gid, x, y, a=0.0):
        chunk = gid.shape[0]
        xs = lax.dynamic_slice(x, (gid[0],), (chunk,))
        ys = lax.dynamic_slice(y, (gid[0],), (chunk,))
        return (x, lax.dynamic_update_slice(y, ref_saxpy(a, xs, ys, interpret=True), (gid[0],)))

    pair = Pair(wl.saxpy_kernel(), 2, monkeypatch, ref_src=ref_saxpy_k, fused=fused)
    pair.lag(lane0=0.3, lane1=0.02)
    n = 4096
    rng = np.random.default_rng(12)
    xh = rng.integers(-20, 20, n).astype(np.float32)
    yh = rng.integers(-20, 20, n).astype(np.float32)
    try:
        seen = []
        for cr, CA in pair.both():
            x = CA(xh.copy(), name="x")
            x.read_only = True
            y = CA(yh.copy(), name="y")
            y.partial_read = True
            cr.enqueue_mode = True
            ranges = []
            for k in range(8):
                x.next_param(y).compute(cr, 21, "saxpy", n, 256, values=(0.5,))
                ranges.append(cr.ranges_of(21))
                if k == 3:
                    cr.barrier()
            cr.enqueue_mode = False
            seen.append((ranges, np.asarray(y).copy()))
        (port_ranges, port_y), (ref_ranges, ref_y) = seen
        assert port_ranges == ref_ranges and port_ranges[4] != port_ranges[3]
        np.testing.assert_array_equal(port_y, ref_y)
        want = yh.copy()
        for _ in range(8):
            want = want + np.float32(0.5) * xh
        np.testing.assert_array_equal(port_y, want)
    finally:
        pair.dispose()


def test_the_transfer_floor_feeds_the_balancer_as_in_jax():
    """A lane's share of the flush drain (``transfer_benchmarks``) floors its
    cost in the next rebalance, the same in both packages."""
    pair = Pair(INC, 2)
    try:
        out = []
        for cr, _ in pair.both():
            cores = cr.cores
            cores._ranges_for(5, 8192, 64, rebalance=False)
            for w, bench, transfer in zip(cores.workers, (1.0, 1.2), (3.0, 0.1)):
                w.benchmarks[5] = bench
                w.transfer_benchmarks[5] = transfer
            out.append(cores._ranges_for(5, 8192, 64, rebalance=True)[0])
        assert out[0] == out[1]
        assert out[0][0] < out[0][1]
    finally:
        pair.dispose()


def test_enqueue_mode_does_not_fence_per_call(monkeypatch):
    fences = []
    cr = ck.NumberCruncher(ck.all_devices().cpus(2), INC)
    for w in cr.cores.workers:
        orig = w.fence
        monkeypatch.setattr(w, "fence", lambda orig=orig, w=w: (fences.append(w.index), orig()))
    x = ck.ClArray(np.zeros(1024, np.float32), name="x", partial_read=True)
    try:
        cr.enqueue_mode = True
        for _ in range(6):
            x.compute(cr, 2, "inc", 1024, 64)
        assert fences == []
        cr.barrier()
        assert sorted(fences) == [0, 1]
        cr.enqueue_mode = False
        np.testing.assert_array_equal(x.host(), 6.0)
    finally:
        cr.dispose()


@FUSED
def test_threaded_windows_lose_no_update(fused):
    """The reference's threaded-window regression, fused and not: one
    thread drives barriers whose fence lag alternates between the lanes (so
    its next call moves ranges and runs the atomic flush and coverage
    reset) while another thread enqueues a different compute id through the
    same cruncher.  Both arrays end exact."""
    cr = ck.NumberCruncher(ck.all_devices().cpus(2), INC)
    cr.fused_dispatch = fused
    n = 4096
    x = ck.ClArray(np.zeros(n, np.float32), name="x", partial_read=True)
    y = ck.ClArray(np.zeros(n, np.float32), name="y", partial_read=True)
    cr.enqueue_mode = True
    w0, w1 = cr.cores.workers
    f0, f1 = w0.fence, w1.fence
    phases, per_phase = 6, 2
    errors: list = []
    b_iters = 0
    stop = threading.Event()

    def laggy(orig):
        return lambda: (time.sleep(0.05), orig())[1]

    def thread_a():
        try:
            for ph in range(phases):
                if ph % 2 == 0:
                    w0.fence = laggy(f0)
                else:
                    w1.fence = laggy(f1)
                for _ in range(per_phase):
                    y.compute(cr, 71, "inc", n, 64)
                cr.barrier()
                w0.fence, w1.fence = f0, f1
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)
        finally:
            w0.fence, w1.fence = f0, f1
            stop.set()

    def thread_b():
        nonlocal b_iters
        try:
            while not stop.is_set() and b_iters < 400:
                x.compute(cr, 72, "inc", n, 64)
                b_iters += 1
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)

    ta, tb = threading.Thread(target=thread_a), threading.Thread(target=thread_b)
    try:
        ta.start()
        tb.start()
        ta.join(timeout=120.0)
        tb.join(timeout=120.0)
        assert not ta.is_alive() and not tb.is_alive()
        assert not errors, errors
        cr.enqueue_mode = False
        np.testing.assert_array_equal(x.host(), float(b_iters))
        np.testing.assert_array_equal(y.host(), float(phases * per_phase))
    finally:
        cr.dispose()


@pytest.mark.parametrize("lanes", [1, 2])
def test_run_mandelbrot_final_equals_every_and_the_host(lanes):
    devs = ck.all_devices().cpus(lanes)
    kw = dict(width=64, height=32, max_iter=24, iters=5, warmup=1, local_range=64,
              keep_image=True)
    final = wl.run_mandelbrot(devs, readback="final", sync_every=2, **kw)
    every = wl.run_mandelbrot(devs, **kw)
    host = wl.mandelbrot_host(64, 32, -2.0, -1.25, 2.5 / 64, 2.5 / 32, 24)
    np.testing.assert_array_equal(final.image.ravel(), host)
    np.testing.assert_array_equal(every.image, final.image)
    assert final.mpixels_per_sec > 0 and len(final.per_iter_ms) == 5


def test_run_mandelbrot_leaves_a_callers_cruncher_out_of_enqueue_mode():
    with ck.NumberCruncher(ck.all_devices().cpus(1), wl.MANDELBROT_SRC) as cr:
        res = wl.run_mandelbrot(width=32, height=32, max_iter=8, iters=2, warmup=1,
                                local_range=64, readback="final", cruncher=cr,
                                keep_image=True)
        assert not cr.enqueue_mode
        assert cr.cores.workers[0].transfers["d2h", "mandel_out"] == 1
        np.testing.assert_array_equal(
            res.image.ravel(), wl.mandelbrot_host(32, 32, -2.0, -1.25, 2.5 / 32, 2.5 / 32, 8))
        with pytest.raises(Exception):
            wl.run_mandelbrot(width=32, height=32, max_iter=8, iters=2, local_range=48,
                              readback="final", cruncher=cr)
        assert not cr.enqueue_mode
    with pytest.raises(ValueError, match="readback"):
        wl.run_mandelbrot(ck.all_devices().cpus(1), readback="sometimes")


def test_a_failed_host_lane_phase_surfaces_at_the_barrier():
    """A host lane runs enqueued work on its own thread, as a device stream:
    a failure there is raised at the next fence, and the window closes."""
    @ck.kernel(name="boom")
    def boom(gid, a):
        raise RuntimeError("boom")

    cr = ck.NumberCruncher(ck.all_devices().cpus(2), boom)
    x = ck.ClArray(np.zeros(256, np.float32), name="x", partial_read=True)
    try:
        cr.enqueue_mode = True
        x.compute(cr, 4, "boom", 256, 64)
        with pytest.raises(RuntimeError, match="boom"):
            cr.barrier()
        assert cr.cores._enqueue_t0 is None and not cr.cores._enqueue_cids
        cr.cores.enqueue_mode = False
    finally:
        cr.dispose()


@pytest.mark.parametrize("name, value", [
    pytest.param("fused_dispatch", True, id="fused_dispatch-True"),
    pytest.param("fused_batch", 8, id="fused_batch-8"),
    pytest.param("enqueue_mode_async_enable", False, id="enqueue_mode_async_enable-False"),
    pytest.param("fine_grained_queue_control", True, id="fine_grained_queue_control-True"),
])
def test_toggles_of_tiers_not_ported_refuse_another_value(name, value):
    """Every tier named here is ported now, queue markers
    (``fine_grained_queue_control``) included: each toggle reads its
    default, takes another value and reads it back, and takes the default
    again, as the JAX package's do."""
    ref = RefCruncher(ref_platforms().cpus().subset(1), INC)
    try:
        with ck.NumberCruncher(ck.all_devices().cpus(1), INC) as cr:
            setattr(cr, name, getattr(cr, name))  # the default is accepted
            default = getattr(cr, name)
            assert default == getattr(ref, name)
            for v in (value, default):
                setattr(cr, name, v)
                setattr(ref, name, v)
                assert getattr(cr, name) == getattr(ref, name) == v
    finally:
        ref.dispose()
