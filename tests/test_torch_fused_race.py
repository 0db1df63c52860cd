"""Three races between host threads on one cruncher's fused windows (ROADMAP
Queue C 12), each pinned as the interleaving that lost updates, on a host
lane.

``tests/test_torch_fused.py::test_threaded_windows_lose_no_update_with_fused_windows``
runs two threads on one cruncher: one re-splits its array at barriers, the
other's calls defer into fused windows.  Under a loaded machine (beside a
parallel run of the suite, or with a 10 µs switch interval) it lost
updates in two ways:

- a call matched the open window's signature, another thread replaced the
  window before the call took the lock, and the call counted into the new
  window: its iteration ran on the other signature's arrays (``x`` one
  short, ``y`` one over);
- a call passed its candidate check and opened its window over one another
  thread had opened meanwhile, taking over that window's deferred
  iterations (the same shortfall and surplus);
- a window opened between a re-split flush's window close and its coverage
  reset: its iterations were in no record the flush read back, and the
  re-upload after the reset overwrote them.

Each test makes the other thread's steps happen at that point, on the same
thread, and both arrays must end exact.  The stress scenario runs last with
a 10 µs switch interval.
"""

from __future__ import annotations

import sys

import numpy as np

import cekirdekler_tpu_torch as ck
from cekirdekler_tpu_torch.core.cores import Cores
from tests.test_torch_fused import INC, _x


def test_a_call_never_defers_into_a_window_another_thread_opened(monkeypatch):
    """``x``'s window is open; ``x``'s third call matches it, and before it
    counts in, another thread's two ``y`` calls close it and open ``y``'s
    window.  The call runs per call instead; ``y`` gets nothing of it."""
    n = 256
    cr = ck.NumberCruncher(ck.all_devices().cpus(1), INC)
    x, y = _x(ck.ClArray, n), _x(ck.ClArray, n, name="y")
    defer = Cores._fused_defer
    armed = [False]

    def replaced_first(self, *args):
        if armed[0]:
            armed[0] = False
            for _ in range(2):
                y.compute(cr, 71, "inc", n, 64)
            assert self._fused_run is not None and self._fused_run.compute_id == 71
        return defer(self, *args)

    monkeypatch.setattr(Cores, "_fused_defer", replaced_first)
    try:
        cr.enqueue_mode = True
        for _ in range(2):
            x.compute(cr, 72, "inc", n, 64)  # seeds, then opens x's window
        armed[0] = True
        x.compute(cr, 72, "inc", n, 64)
        cr.enqueue_mode = False
        np.testing.assert_array_equal(x.host(), np.full(n, 3.0, np.float32))
        np.testing.assert_array_equal(y.host(), np.full(n, 2.0, np.float32))
    finally:
        cr.dispose()


def test_a_window_never_replaces_one_another_thread_opened():
    """``y``'s second call passed its candidate check and is opening ``y``'s
    window when another thread's three ``x`` calls open ``x``'s window and
    defer one iteration into it.  ``y``'s window is refused (the reason
    ``window-open``): replacing ``x``'s would run ``x``'s deferred iteration
    on ``y``."""
    n = 256
    cr = ck.NumberCruncher(ck.all_devices().cpus(1), INC)
    x, y = _x(ck.ClArray, n), _x(ck.ClArray, n, name="y")
    build = cr.program.fused_launcher
    armed = [False]

    def build_then_other_calls(*args, **kwargs):
        if armed[0]:
            armed[0] = False
            for _ in range(3):
                x.compute(cr, 72, "inc", n, 64)
            assert cr.cores._fused_run.compute_id == 72 and cr.cores._fused_pending == 1
        return build(*args, **kwargs)

    cr.program.fused_launcher = build_then_other_calls
    try:
        cr.enqueue_mode = True
        y.compute(cr, 71, "inc", n, 64)
        armed[0] = True
        y.compute(cr, 71, "inc", n, 64)  # its engage builds the ladder first
        assert not armed[0]
        cr.enqueue_mode = False
        np.testing.assert_array_equal(x.host(), np.full(n, 3.0, np.float32))
        np.testing.assert_array_equal(y.host(), np.full(n, 2.0, np.float32))
        assert cr.fused_stats["disengaged"].get("window-open") == 1
    finally:
        cr.dispose()


def test_no_window_opens_inside_another_thread_s_resplit_flush(monkeypatch):
    """``y``'s call re-splits ``y`` (another range), so its flush closes the
    windows, reads every record back and resets coverage.  Between the
    close and the reset another thread's three ``x`` calls would open a
    window and defer one iteration into it; that window is refused (the
    reason ``re-split``), and ``x`` ends exact."""
    n = 256
    cr = ck.NumberCruncher(ck.all_devices().cpus(1), INC)
    x, y = _x(ck.ClArray, n), _x(ck.ClArray, n, name="y")
    close, resplit = Cores._fused_close, Cores._flush_and_reset_coverage
    armed = [False]

    def flush_and_reset(self):
        armed[0] = True
        resplit(self)

    def close_then_other_calls(self):
        close(self)
        if armed[0]:
            armed[0] = False
            for _ in range(3):
                x.compute(cr, 72, "inc", n, 64)

    monkeypatch.setattr(Cores, "_flush_and_reset_coverage", flush_and_reset)
    monkeypatch.setattr(Cores, "_fused_close", close_then_other_calls)
    try:
        cr.enqueue_mode = True
        y.compute(cr, 71, "inc", n, 64)
        y.compute(cr, 71, "inc", n // 2, 64)  # y split otherwise: the re-split flush
        assert not armed[0]
        x.compute(cr, 72, "inc", n, 64)
        cr.enqueue_mode = False
        np.testing.assert_array_equal(x.host(), np.full(n, 4.0, np.float32))
        want_y = np.ones(n, np.float32)
        want_y[: n // 2] = 2.0
        np.testing.assert_array_equal(y.host(), want_y)
        assert cr.fused_stats["disengaged"].get("re-split", 0) >= 1
    finally:
        cr.dispose()


def test_threaded_windows_stay_exact_at_a_short_switch_interval():
    """The two-thread scenario of ``tests/test_torch_fused.py`` three times
    at a 10 µs switch interval, where the races showed in a few runs of
    twenty."""
    from tests.test_torch_fused import test_threaded_windows_lose_no_update_with_fused_windows

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for _ in range(3):
            test_threaded_windows_lose_no_update_with_fused_windows()
    finally:
        sys.setswitchinterval(interval)
