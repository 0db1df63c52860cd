"""Fused-iteration dispatch and ``repeat_count`` of the port against the JAX
package's, on host-CPU lanes.

The scenarios of the reference's ``tests/test_fused.py``, its repeat tests
(``tests/test_core.py``) and its ``compute_fused_batch`` tests
(``tests/test_serve.py``) run through both packages' ``NumberCruncher``
(``Pair`` of ``tests/test_torch_enqueue.py``) on the same call sequence: the results must be
equal, and so must ``fused_stats`` (windows, fused and deferred
iterations, and the disengages by reason).  ``inc`` adds exactly 1.0f, so
a lost or doubled iteration shows as an integer error.  A CPU lane runs a
window as a host loop; the CUDA graphs of a GPU lane are
``tests/test_torch_card.py``'s, and here only the launch tally they rest
on is pinned.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

import cekirdekler_tpu_torch as ck
from cekirdekler_tpu.workloads import NBODY_SRC as REF_NBODY_SRC
from cekirdekler_tpu_torch import workloads as wl
from cekirdekler_tpu_torch.core.worker import _DriverQueue
from cekirdekler_tpu_torch.kernel import build, registry
from tests.test_torch_enqueue import Pair

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


def _x(CA, n: int, value: float = 0.0, name: str = "x"):
    x = CA(np.full(n, value, np.float32), name=name)
    x.partial_read = True
    return x


def _same_stats(pair: Pair) -> dict:
    port, ref = pair.port.fused_stats, pair.ref.fused_stats
    assert port == ref, (port, ref)
    return port


# -- deferral and exactness ----------------------------------------------------

def test_a_window_defers_and_is_exact():
    """Call 1 seeds the candidate, call 2 engages, calls 3-12 defer; the
    host is untouched until the flush, which dispatches the residue."""
    pair = Pair(INC, 2, fused=True)
    try:
        for cr, CA in pair.both():
            x = _x(CA, 1024)
            cr.enqueue_mode = True
            for _ in range(12):
                x.compute(cr, 1, "inc", 1024, 64)
            assert cr.fused_stats["deferred_iters"] == 10
            assert np.all(np.asarray(x) == 0.0)
            cr.enqueue_mode = False
            np.testing.assert_array_equal(np.asarray(x), 12.0)
        assert _same_stats(pair) == {"windows": 1, "fused_iters": 10, "deferred_iters": 10,
                                     "disengaged": {}}
    finally:
        pair.dispose()


def test_batches_dispatch_eagerly():
    """Every ``fused_batch`` deferrals dispatch (mid-window), the residue at
    the barrier."""
    pair = Pair(INC, 2, fused=True)
    try:
        for cr, CA in pair.both():
            cr.fused_batch = 4
            x = _x(CA, 512)
            cr.enqueue_mode = True
            for _ in range(11):
                x.compute(cr, 1, "inc", 512, 64)
            assert (cr.fused_stats["windows"], cr.fused_stats["fused_iters"]) == (2, 8)
            cr.barrier()
            assert cr.fused_stats["fused_iters"] == 9
            cr.enqueue_mode = False
            np.testing.assert_array_equal(np.asarray(x), 11.0)
        _same_stats(pair)
    finally:
        pair.dispose()


def test_the_mandelbrot_image_is_bit_identical():
    """The fused image equals the per-call image, the JAX package's fused
    image and ``mandelbrot_host``, bit for bit."""
    w = h = 64
    n = w * h
    vals = (-2.0, -1.25, 2.5 / w, 2.5 / h, w, 48)
    images = []
    for fused in (False, True):
        pair = Pair(wl.MANDELBROT_SRC, 2, fused=fused)
        try:
            for cr, CA in pair.both():
                out = CA(n, np.float32, name="m", read=False, write=True)
                cr.enqueue_mode = True
                for _ in range(5):
                    out.compute(cr, 31, "mandelbrot", n, 64, values=vals)
                cr.enqueue_mode = False
                images.append(np.asarray(out).copy())
            stats = _same_stats(pair)
            assert stats["fused_iters"] == (3 if fused else 0)
        finally:
            pair.dispose()
    want = wl.mandelbrot_host(w, h, *vals[:4], vals[5])
    for img in images:
        np.testing.assert_array_equal(img, want)


def test_the_accumulating_nbody_is_bit_identical():
    """K fused iterations of the velocity integral equal K per-call ones bit
    for bit in the port, and the JAX package's within 1e-5 of the largest
    velocity (the two packages' lowerings may contract differently)."""
    n, iters, dt = 256, 8, 1e-4
    rng = np.random.default_rng(7)
    pos = ((rng.random((3, n), dtype=np.float32) - 0.5) * 2.0)
    results = {}
    for fused in (False, True):
        pair = Pair(wl.NBODY_SRC, 2, fused=fused, ref_src=REF_NBODY_SRC)
        try:
            for tag, (cr, CA) in zip(("port", "ref"), pair.both()):
                x, y, z = (CA(pos[k].copy(), name=f"p{k}", read_only=True) for k in range(3))
                vel = [CA(np.zeros(n, np.float32), name=f"v{c}", partial_read=True)
                       for c in "xyz"]
                g = x.next_param(y, z, *vel)
                cr.enqueue_mode = True
                for _ in range(iters):
                    g.compute(cr, 32, "nBody", n, 64, values=(n, dt))
                cr.enqueue_mode = False
                results[tag, fused] = [np.asarray(v).copy() for v in vel]
            _same_stats(pair)
        finally:
            pair.dispose()
    for a, b in zip(results["port", True], results["port", False]):
        np.testing.assert_array_equal(a, b)
    top = max(float(np.abs(v).max()) for v in results["ref", True])
    for a, b in zip(results["port", True], results["ref", True]):
        assert float(np.abs(a - b).max()) <= 1e-5 * top


def test_mixed_compute_ids_break_by_signature_and_stay_exact():
    pair = Pair(INC, 2, fused=True)
    try:
        got = []
        for cr, CA in pair.both():
            x, y = _x(CA, 512), _x(CA, 512, 1.0, "y")
            cr.enqueue_mode = True
            for _ in range(3):
                for _ in range(4):
                    x.compute(cr, 41, "inc", 512, 64)
                for _ in range(4):
                    y.compute(cr, 42, "dbl", 512, 64)
            cr.barrier()
            cr.enqueue_mode = False
            np.testing.assert_array_equal(np.asarray(x), 12.0)
            got.append(np.asarray(y).copy())
        stats = _same_stats(pair)
        assert stats["disengaged"].get("signature-change", 0) >= 5 and stats["fused_iters"] > 0
        np.testing.assert_array_equal(got[0], got[1])
        np.testing.assert_allclose(got[0], np.float32(1.001) ** 12, rtol=1e-5)
    finally:
        pair.dispose()


# -- the launcher cache -------------------------------------------------------------

@pytest.mark.parametrize("repeats", [1, 3])
def test_the_launcher_cache_survives_a_rebalance(monkeypatch, repeats):
    """A barrier-armed move builds no launcher (``compiled_count`` and
    ``fused_compiled_count`` stay flat: the fused ladder built every chunk
    of the range), and a new array shape builds exactly one fused ladder.
    With ``repeat_count`` > 1 no window opens and every call runs its
    repeats through the same kind of ladder, with the units at run time, so
    a new split builds nothing either (the reference's sequence launcher is
    keyed by the split; its cache is not held).  The ranges and results
    equal the JAX package's."""
    pair = Pair(INC, 2, monkeypatch, fused=True)
    try:
        seen = []
        for cr, CA in pair.both():
            port = cr is pair.port
            cr.repeat_count = repeats
            x = _x(CA, 4096)
            cr.enqueue_mode = True
            ranges = []
            for lag in ((0.01, 0.01), (0.3, 0.01), (0.01, 0.01)):
                pair.lag(lane0=lag[0], lane1=lag[1])
                for _ in range(3):
                    x.compute(cr, 51, "inc", 4096, 64)
                    ranges.append(cr.ranges_of(51))
                cr.barrier()
                if len(ranges) == 3:
                    prog = cr.cores.program
                    warm = (prog.fused_compiled_count, prog.compiled_count)
            assert ranges[6] != ranges[5]
            if port or repeats == 1:
                assert (prog.fused_compiled_count, prog.compiled_count) == warm
                assert warm[0] == 1
            y = _x(CA, 8192, name="y")
            for _ in range(3):
                y.compute(cr, 52, "inc", 8192, 64)
            cr.barrier()
            if port or repeats == 1:
                assert prog.fused_compiled_count == warm[0] + 1
            cr.enqueue_mode = False
            np.testing.assert_array_equal(np.asarray(x), 9.0 * repeats)
            np.testing.assert_array_equal(np.asarray(y), 3.0 * repeats)
            seen.append(ranges)
        assert seen[0] == seen[1]
        _same_stats(pair)
    finally:
        pair.dispose()


# -- disengages, each by its name --------------------------------------------------

def test_an_armed_rebalance_breaks_the_window_as_range_change():
    pair = Pair(INC, 2, fused=True)
    try:
        for cr, CA in pair.both():
            x = _x(CA, 4096)
            cr.enqueue_mode = True
            for _ in range(3):
                x.compute(cr, 61, "inc", 4096, 64)
            cr.barrier()
            x.compute(cr, 61, "inc", 4096, 64)  # the armed rebalance is consumed here
            x.compute(cr, 61, "inc", 4096, 64)  # defers
            cr.cores._enqueue_rebalance.add(61)  # as another thread's barrier would
            x.compute(cr, 61, "inc", 4096, 64)  # breaks
            assert cr.fused_stats["disengaged"] == {"range-change": 1}
            cr.enqueue_mode = False
            np.testing.assert_array_equal(np.asarray(x), 6.0)
        _same_stats(pair)
    finally:
        pair.dispose()


def test_a_coverage_reset_breaks_the_window_as_non_resident():
    pair = Pair(INC, 2, fused=True)
    try:
        for cr, CA in pair.both():
            x = _x(CA, 1024)
            cr.enqueue_mode = True
            for _ in range(3):
                x.compute(cr, 62, "inc", 1024, 64)
            assert cr.cores._fused_sig is not None
            for w in cr.cores.workers:
                w.coverage_epoch += 1  # what reset_coverage() does
            x.compute(cr, 62, "inc", 1024, 64)
            cr.enqueue_mode = False
            np.testing.assert_array_equal(np.asarray(x), 4.0)
        assert _same_stats(pair)["disengaged"] == {"non-resident": 1}
    finally:
        pair.dispose()


def test_repeat_mode_refuses_a_window():
    pair = Pair(INC, 2, fused=True)
    try:
        for cr, CA in pair.both():
            x = _x(CA, 2048)
            cr.enqueue_mode = True
            cr.repeat_count = 3
            for _ in range(3):
                x.compute(cr, 63, "inc", 2048, 64)
            cr.repeat_count = 1
            cr.enqueue_mode = False
            np.testing.assert_array_equal(np.asarray(x), 9.0)
        stats = _same_stats(pair)
        assert stats["disengaged"] == {"repeat-mode": 2} and stats["fused_iters"] == 0
    finally:
        pair.dispose()


def test_a_mode_change_mid_window_breaks_it():
    """``repeat_count`` and ``repeat_kernel_name`` are not in the signature:
    set mid-window, they break it ("mode-change") and the call runs as set
    (three repeats; the sync kernel between repeats, none with one)."""
    pair = Pair(INC, 2, fused=True)
    try:
        for cr, CA in pair.both():
            x = _x(CA, 512)
            cr.enqueue_mode = True
            x.compute(cr, 66, "inc", 512, 64)
            x.compute(cr, 66, "inc", 512, 64)  # engages
            x.compute(cr, 66, "inc", 512, 64)  # defers
            cr.repeat_count = 3
            x.compute(cr, 66, "inc", 512, 64)  # three repeats, not one deferral
            cr.repeat_count = 1
            x.compute(cr, 66, "inc", 512, 64)  # engages again
            x.compute(cr, 66, "inc", 512, 64)  # defers
            cr.repeat_kernel_name = "inc"
            x.compute(cr, 66, "inc", 512, 64)  # one repeat: no sync kernel runs
            cr.repeat_kernel_name = None
            cr.enqueue_mode = False
            np.testing.assert_array_equal(np.asarray(x), 9.0)
        assert _same_stats(pair)["disengaged"] == {"mode-change": 2}
    finally:
        pair.dispose()


def test_a_partly_uploaded_range_refuses_a_window():
    pair = Pair(INC, 2, fused=True)
    try:
        for cr, CA in pair.both():
            cores = cr.cores
            x = _x(CA, 1024)
            cr.enqueue_mode = True
            x.compute(cr, 64, "inc", 1024, 64)
            x.compute(cr, 64, "inc", 1024, 64)
            assert cores._fused_sig is not None
            cores._fused_close()
            w = cores.workers[0]
            with w.lock:
                off, _ = w._uploaded[id(x)]
                w._uploaded[id(x)] = (off, 1)
            ranges = cores.global_ranges[64]
            cores._fused_try_engage(["inc"], [x], 64, 1024, 64, 0, (), ranges,
                                    list(np.cumsum([0] + ranges[:-1])), 64)
            assert cores._fused_sig is None
            cr.enqueue_mode = False
            np.testing.assert_array_equal(np.asarray(x), 2.0)
        assert _same_stats(pair)["disengaged"] == {"partial-upload": 1}
    finally:
        pair.dispose()


def test_unhashable_values_refuse_a_window():
    src = """
    __kernel void axb(__global float* x, float aa) {
        int i = get_global_id(0);
        x[i] = x[i] + aa;
    }"""

    class UnhashableFloat(float):
        __hash__ = None

    pair = Pair(src, 2, fused=True)
    try:
        for cr, CA in pair.both():
            x = _x(CA, 256)
            cr.enqueue_mode = True
            for _ in range(3):
                x.compute(cr, 65, "axb", 256, 64, values=(UnhashableFloat(2.0),))
            cr.enqueue_mode = False
            np.testing.assert_array_equal(np.asarray(x), 6.0)
        stats = _same_stats(pair)
        assert stats["disengaged"] == {"unhashable-values": 2} and stats["fused_iters"] == 0
    finally:
        pair.dispose()


def test_threaded_windows_lose_no_update_with_fused_windows():
    """One thread's barriers move ranges (its fence lag alternates between
    the lanes) while another thread's fused windows run on the same
    cruncher: every re-split breaks the other thread's window, dispatches
    and drains it before the flush, and both arrays end exact."""
    cr = ck.NumberCruncher(ck.all_devices().cpus(2), INC)
    n = 4096
    x, y = _x(ck.ClArray, n), _x(ck.ClArray, n, name="y")
    cr.enqueue_mode = True
    w0, w1 = cr.cores.workers
    f0, f1 = w0.fence, w1.fence
    phases, per_phase, errors, b_iters = 6, 2, [], 0
    stop = threading.Event()

    def thread_a():
        try:
            for ph in range(phases):
                slow, orig = (w0, f0) if ph % 2 == 0 else (w1, f1)
                slow.fence = lambda orig=orig: (time.sleep(0.05), orig())[1]
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
        assert not ta.is_alive() and not tb.is_alive() and not errors, errors
        cr.enqueue_mode = False
        np.testing.assert_array_equal(x.host(), float(b_iters))
        np.testing.assert_array_equal(y.host(), float(phases * per_phase))
        assert cr.fused_stats["deferred_iters"] > 0
    finally:
        cr.dispose()


def test_a_failed_fused_dispatch_surfaces_at_the_barrier():
    """A host lane's fused closure that fails raises at the window's sync
    point, after every lane is fenced; the window and the enqueue window
    close."""
    calls = []

    @ck.kernel(name="flaky")
    def flaky(gid, a):
        calls.append(gid.start)
        if len(calls) > 4:
            raise RuntimeError("flaky")
        return (a,)

    cr = ck.NumberCruncher(ck.all_devices().cpus(2), flaky)
    x = _x(ck.ClArray, 256)
    try:
        cr.enqueue_mode = True
        for _ in range(5):
            x.compute(cr, 4, "flaky", 256, 64)
        with pytest.raises(RuntimeError, match="flaky"):
            cr.barrier()
        assert cr.cores._fused_sig is None and cr.cores._enqueue_t0 is None
        cr.cores.enqueue_mode = False
    finally:
        cr.dispose()


# -- repeat_count on the lane (reference tests/test_core.py) ----------------------

@pytest.mark.parametrize("lanes", [1, 2])
def test_repeat_count_runs_the_sequence_on_the_lane(lanes):
    pair = Pair(INC, lanes, fused=True)
    try:
        for cr, CA in pair.both():
            x = _x(CA, 256)
            cr.repeat_count = 10
            x.compute(cr, 1, "inc", 256, 64)
            np.testing.assert_array_equal(np.asarray(x), 10.0)
    finally:
        pair.dispose()


def test_repeat_with_a_sync_kernel_between_repeats():
    """Five repeats of ``inc`` with ``inc`` as the sync kernel between two
    repeats: 9, in both packages; ``dbl`` as the sync kernel gives the
    same bits in both."""
    pair = Pair(INC, 1, fused=True)
    try:
        got = []
        for cr, CA in pair.both():
            x, y = _x(CA, 128), _x(CA, 128, 1.0, "y")
            cr.repeat_count = 5
            cr.repeat_kernel_name = "inc"
            x.compute(cr, 1, "inc", 128, 64)
            np.testing.assert_array_equal(np.asarray(x), 9.0)
            cr.repeat_kernel_name = "dbl"
            y.compute(cr, 2, "inc", 128, 64)
            got.append(np.asarray(y).copy())
        np.testing.assert_array_equal(got[0], got[1])
    finally:
        pair.dispose()


# -- compute_fused_batch (reference tests/test_serve.py) ---------------------------

def test_compute_fused_batch_is_exact_and_one_dispatch():
    pair = Pair(INC, 2, fused=True)
    try:
        infos = []
        for cr, CA in pair.both():
            x = _x(CA, 1024)
            cr.enqueue_mode = True
            got = [cr.cores.compute_fused_batch(["inc"], [x], 700, 1024, 64, 12)]
            cr.cores.barrier()
            cr.cores.flush()
            np.testing.assert_array_equal(np.asarray(x), 12.0)
            got.append(cr.cores.compute_fused_batch(["inc"], [x], 700, 1024, 64, 12))
            cr.cores.barrier()
            cr.cores.flush()
            np.testing.assert_array_equal(np.asarray(x), 24.0)
            cr.enqueue_mode = False
            infos.append([{k: i[k] for k in ("iters", "fused", "ladder_iters", "per_call_iters")}
                          for i in got])
        assert infos[0] == infos[1]
        assert infos[0] == [
            {"iters": 12, "fused": True, "ladder_iters": 10, "per_call_iters": 2},
            {"iters": 12, "fused": True, "ladder_iters": 11, "per_call_iters": 1}]
        _same_stats(pair)
    finally:
        pair.dispose()


def test_compute_fused_batch_needs_enqueue_mode_and_runs_per_call_unfused():
    pair = Pair(INC, 2, fused=True)
    try:
        for cr, CA in pair.both():
            x = _x(CA, 1024)
            with pytest.raises(Exception, match="enqueue_mode"):
                cr.cores.compute_fused_batch(["inc"], [x], 700, 1024, 64, 4)
            cr.fused_dispatch = False
            cr.enqueue_mode = True
            info = cr.cores.compute_fused_batch(["inc"], [x], 700, 1024, 64, 5)
            cr.cores.barrier()
            cr.cores.flush()
            assert info["fused"] is False and info["per_call_iters"] == 5
            np.testing.assert_array_equal(np.asarray(x), 5.0)
            cr.enqueue_mode = False
        _same_stats(pair)
    finally:
        pair.dispose()


def test_compute_fused_batch_names_a_failure():
    """A failure inside the batch raises ``FusedBatchError`` with its cause
    and the iterations applied before it, as the JAX package's does."""
    pair = Pair(INC, 1, fused=True)
    try:
        seen = []
        for cr, CA in pair.both():
            x = _x(CA, 256)
            with pytest.raises(Exception, match="iters >= 1") as info:
                cr.cores.compute_fused_batch(["inc"], [x], 5, 256, 64, 0)
            assert type(info.value).__name__ == "ComputeValidationError"
            cr.enqueue_mode = True
            with pytest.raises(Exception) as info:
                cr.cores.compute_fused_batch(["nope"], [x], 5, 256, 64, 3)
            err = info.value
            seen.append((type(err).__name__, err.cause, err.applied_iters, err.requested_iters,
                         err.clean))
            cr.enqueue_mode = False
        assert seen[0] == seen[1] == ("FusedBatchError", "ComputeValidationError", 0, 3, False)
        assert isinstance(info.value.original, Exception)
    finally:
        pair.dispose()


# -- the dispatch driver and the launch tally ------------------------------------

def test_the_driver_runs_in_order_and_raises_a_failure_at_the_next_drain():
    q = _DriverQueue("test-driver")
    seen = []
    try:
        for k in range(6):
            q.submit(lambda k=k: seen.append(k), depth=2)
        q.drain()
        assert seen == list(range(6))
        q.submit(lambda: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            q.drain()
        q.submit(lambda: 1 / 0)
        time.sleep(0.05)
        with pytest.raises(ZeroDivisionError):
            q.submit(lambda: seen.append("never"))
        q.drain()
        assert "never" not in seen
    finally:
        q.close()


def test_a_capture_tally_counts_once_per_replay():
    """Launches counted while a thread captures go into the capture's tally,
    not the counts, and each replay adds the tally once; other threads
    count as before."""
    counter = build.LaunchCounter()
    registry.reset_launch_counts()
    with build.tally() as t:
        counter.add("k")
        counter.add()
        registry.launch_counts.add("cuda")
        other = threading.Thread(target=lambda: counter.add("other"))
        other.start()
        other.join()
    assert (counter.count, counter.by_key) == (1, {"other": 1})
    assert registry.launch_counts["cuda"] == 0
    for _ in range(3):
        build.add_tally(t)
    assert (counter.count, counter.by_key) == (7, {"other": 1, "k": 3})
    assert dict(registry.launch_counts) == {"cuda": 3, "torch": 0, "python": 0}
    registry.reset_launch_counts()


def test_a_host_lane_takes_no_graph():
    """Only a ladder of kernels written by hand that wrote its tensors in
    place on the card can be captured; a host lane has no graphs, and its
    repeats run as a host loop."""
    prog = ck.KernelProgram(INC)
    a = torch.zeros(8)
    assert not prog.capturable(("inc",), (a,), (a,))
    with ck.NumberCruncher(ck.all_devices().cpus(1), INC) as cr:
        x = _x(ck.ClArray, 256)
        cr.repeat_count = 4
        x.compute(cr, 1, "inc", 256, 64)
        assert cr.cores.workers[0].graphs is None
        np.testing.assert_array_equal(x.host(), 4.0)


# -- the dispatch floor sweep ----------------------------------------------------

def test_measure_rtt_times_a_round_trip_on_the_lane():
    rtt = wl.measure_rtt(reps=3, device="cpu")
    assert isinstance(rtt, float) and 0.0 < rtt < 1.0


def test_dispatch_floor_sweep_runs_on_a_host_lane():
    out = wl.dispatch_floor_sweep(ck.all_devices().cpus(1), ks=(1, 8), n=1024, reps=1)
    rows = {(r["fused"], r["K"]): r for r in out["rows"]}
    assert set(rows) == {(False, 1), (False, 8), (True, 1), (True, 8)}
    assert out["device"] == "cpu"
    # one chunk a call (1024 = 4 x 256)
    assert rows[False, 8]["fused_windows"] == 0 and rows[False, 8]["launches"] == 8
    # K=8: call 1 engages (its candidate is warm), calls 2-8 defer into one dispatch
    assert rows[True, 8]["fused_windows"] == 1 and rows[True, 8]["fused_iters"] == 7
    assert rows[True, 8]["launches"] == 8 and rows[True, 8]["graph_replays"] == 0
    assert all(r["per_dispatch_ms"] >= 0.0 for r in rows.values())
    assert "floor_collapse_at_kmax" in out and out["rtt_ms"] > 0.0
