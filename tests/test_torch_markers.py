"""Queue markers, the dispatch gate and ``marker_overhead`` of the port
against the JAX package's, on host-CPU lanes.

``utils.markers.MarkerCounter`` runs one scripted sequence beside the
reference's, each module with a modelled ``time`` whose ``perf_counter``
reads the same script, so the counts and ``reach_speed`` must be equal.
The completion thread is held to its contract with futures: a failed
future retires its marker, ``close()`` behind 200 queued completions
returns within its own bound and the counts answer after it, two
producers' markers all retire.  ``fine_grained_queue_control`` runs the
reference's scenarios (``tests/test_utils.py::test_fine_grained_queue_control_counts_ops``,
``tests/test_core.py::test_markers_observe_real_retirement``) on two host
lanes through both packages (``Pair``) on every path of a call: the
results are equal, every marker reaches within a bounded wait, and each
port lane's markers equal its launcher calls and its transfers.  The
dispatch gate's scenarios (``tests/test_core.py::test_dispatch_gate_synchronized_start``,
``tests/test_fused.py::test_disengage_mode_change_mid_window``) run
through both packages too.  Thread stress stays light and every wait is
bounded; no timing threshold is a gate.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from cekirdekler_tpu import workloads as ref_workloads
from cekirdekler_tpu.utils import markers as ref_markers
from cekirdekler_tpu.utils.events import UserEvent as RefEvent
from cekirdekler_tpu_torch import workloads as wl
from cekirdekler_tpu_torch.core.worker import Worker, _Download, _ladder
from cekirdekler_tpu_torch.kernel import registry
from cekirdekler_tpu_torch.utils import markers as port_markers
from cekirdekler_tpu_torch.utils.events import UserEvent
from tests.test_torch_enqueue import Pair

INC = """
__kernel void inc(__global float* a) {
    int i = get_global_id(0);
    a[i] = a[i] + 1.0f;
}
"""


class ScriptClock:
    """A ``time`` module whose ``perf_counter`` reads 0.0, 0.25, 0.5, ...
    one step a call; everything else is the real ``time``."""

    def __init__(self, step: float = 0.25):
        self.step = step
        self.calls = 0

    def perf_counter(self) -> float:
        t = self.calls * self.step
        self.calls += 1
        return t

    def __getattr__(self, name):
        return getattr(time, name)


#: (operation, n): add / reach take n; the queries take none
SCRIPT = [("add", 3), ("remaining", None), ("reach", 1), ("reach_speed", None),
          ("reach", 2), ("reach_speed", None), ("added", None), ("reached", None),
          ("add", 5), ("reach", 4), ("reach", 1), ("reach", 1), ("reach_speed", None),
          ("reach", 2), ("reach_speed", None), ("remaining", None), ("reset", None),
          ("added", None), ("remaining", None), ("reach_speed", None), ("add", 2),
          ("reach", 2), ("reach", 3), ("reach_speed", None), ("remaining", None)]


def _play(m) -> list:
    out = []
    for op, n in SCRIPT:
        attr = getattr(m, op)
        if op in ("added", "reached"):
            out.append(attr)
        else:
            out.append(attr(n) if n is not None else attr())
    return out


def test_the_counter_answers_as_the_reference_under_a_modelled_clock(monkeypatch):
    """One script, both counters, window 4: the counts at every step and
    ``reach_speed`` (ops from the second sample on, over the window's
    span) are equal; a reset clears the samples."""
    monkeypatch.setattr(port_markers, "time", ScriptClock())
    monkeypatch.setattr(ref_markers, "time", ScriptClock())
    port, ref = port_markers.MarkerCounter(window=4), ref_markers.MarkerCounter(window=4)
    try:
        got, want = _play(port), _play(ref)
    finally:
        port.close()
        ref.close()
    assert got == want, (got, want)
    speeds = [v for (op, _), v in zip(SCRIPT, got) if op == "reach_speed"]
    assert speeds[0] == 0.0 and speeds[1] == pytest.approx(2 / 0.25)
    assert max(speeds) > 0.0


def _resolved_later(futs: list[Future], every_s: float) -> threading.Thread:
    """A thread that completes ``futs`` in order, one each ``every_s``."""
    def run():
        for f in futs:
            time.sleep(every_s)
            f.set_result(None)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def test_close_behind_200_queued_completions_returns_and_counts_answer():
    """200 completions queued behind futures that resolve over about a
    second: ``close()`` makes the thread skip the joins still owed, so it
    returns inside its own 5 s join bound with the thread ended, and the
    counts answer after it: every marker reached in one weighted batch or
    a few."""
    m = port_markers.MarkerCounter()
    futs = [Future() for _ in range(200)]
    m.add(200)
    for f in futs:
        m.reach_when_ready(f)
    feeder = _resolved_later(futs, 0.005)
    thread = m._completion_thread
    t0 = time.perf_counter()
    m.close()
    took = time.perf_counter() - t0
    assert took < 5.0 + 1.0, took
    assert not thread.is_alive()
    assert (m.added, m.reached, m.remaining()) == (200, 200, 0)
    m.add(1)
    assert m.remaining() == 1  # the counts keep answering after close
    feeder.join(timeout=10.0)


def test_a_failed_future_still_retires_its_marker():
    m = port_markers.MarkerCounter()
    try:
        bad, good = Future(), Future()
        m.add(3)
        m.reach_when_ready(bad)
        m.reach_when_ready(good, 2)
        bad.set_exception(RuntimeError("boom"))
        good.set_result(1)
        m.drain(timeout=10.0)
        assert (m.reached, m.remaining()) == (3, 0)
    finally:
        m.close()


def test_a_download_handle_retires_even_when_its_copy_failed():
    """A deferred download adds its marker when issued; ``finish_download``
    reaches it when the copy landed, and also when it raised.  A
    ``_Download`` is also a completion handle of ``reach_when_ready``."""
    m = port_markers.MarkerCounter()
    try:
        fut = Future()
        fut.set_exception(RuntimeError("copy failed"))
        h = _Download(None, fut=fut)
        h.markers = m
        m.add()
        with pytest.raises(RuntimeError, match="copy failed"):
            Worker.finish_download(h)
        assert (m.reached, m.remaining()) == (1, 0)
        ok = _Download(None, fut=Future())
        m.add()
        m.reach_when_ready(ok)
        assert m.remaining() == 1
        ok.fut.set_result(None)
        m.drain(timeout=10.0)
        assert (m.reached, m.remaining()) == (2, 0)
    finally:
        m.close()


@pytest.mark.parametrize("producers", [2, 8])
def test_producers_of_25_markers_each_all_retire(producers):
    """Producers add and queue markers while the completion thread joins
    them, the interpreter switching threads every 10 µs: no add or reach
    is lost (more producer threads than this host's cores at 8)."""
    import sys

    m = port_markers.MarkerCounter()
    futs: list[Future] = []
    mu = threading.Lock()
    interval = sys.getswitchinterval()

    def produce():
        for _ in range(25):
            f = Future()
            with mu:
                futs.append(f)
            m.add()
            m.reach_when_ready(f)

    threads = [threading.Thread(target=produce) for _ in range(producers)]
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10.0)
        assert not any(t.is_alive() for t in threads)
        with mu:
            for f in futs:
                f.set_result(None)
        m.drain(timeout=10.0)
    finally:
        sys.setswitchinterval(interval)
    try:
        want = 25 * producers
        assert (m.added, m.reached, m.remaining()) == (want, want, 0)
        assert m.reach_speed() >= 0.0
    finally:
        m.close()


# -- fine_grained_queue_control on two host lanes --------------------------------

PATHS = ["per-call", "enqueue", "fused", "streamed", "EVENT", "DRIVER"]


def _calls(path: str) -> int:
    return {"fused": 12, "enqueue": 5}.get(path, 3)


def _scenario(cr, CA, pkg: str, path: str) -> np.ndarray:
    """The path's calls of ``inc`` over 2048 items, markers on."""
    x = CA(np.zeros(2048, np.float32), name="x")
    x.partial_read = True
    cr.fine_grained_queue_control = True
    cr.stream_chunks = 4 if path == "streamed" else 1
    if path in ("enqueue", "fused"):
        cr.enqueue_mode = True
    pipe = {"EVENT": 1, "DRIVER": 2}.get(path)
    kw = dict(pipeline=True, pipeline_blobs=4, pipeline_type=pipe) if pipe else {}
    for _ in range(_calls(path)):
        x.compute(cr, 31, "inc", 2048, 64, **kw)
    cr.enqueue_mode = False
    return np.asarray(x).copy()


def _drained(cr) -> None:
    deadline = time.perf_counter() + 10.0
    while cr.count_markers_remaining() and time.perf_counter() < deadline:
        time.sleep(0.005)


@pytest.mark.parametrize("path", PATHS)
def test_markers_count_every_path_s_launches_and_transfers(path):
    """Each lane's launch markers are its launcher calls (a fused window's
    dispatch counts one, its iterations none), its transfer markers its
    copies (a streamed range's chunks each), every marker reaches, and
    the result equals the reference's."""
    pair = Pair(INC, 2, fused=path == "fused")
    try:
        out = {}
        for pkg, (cr, CA) in zip(("port", "ref"), pair.both()):
            before = sum(registry.launch_counts.values())
            out[pkg] = _scenario(cr, CA, pkg, path)
            if pkg == "port":
                launches = sum(registry.launch_counts.values()) - before
            _drained(cr)
            assert cr.count_markers_remaining() == 0
            assert cr.count_markers_reached() > 0
        np.testing.assert_array_equal(out["port"], out["ref"])
        np.testing.assert_array_equal(out["port"], np.full(2048, _calls(path), np.float32))
        cr = pair.port
        stats = cr.fused_stats
        ranges = cr.ranges_of(31)
        step = 64 * (4 if path in ("EVENT", "DRIVER") else 1)
        fused_launches = sum(len(_ladder(r, step)) for r in ranges if r) * stats["fused_iters"]
        windows = sum(1 for r in ranges if r) * stats["windows"]
        marked = 0
        for w in cr.cores.workers:
            sites = w.markers_by_site
            assert w.markers.added == w.markers.reached == sum(sites.values())
            for direction in ("h2d", "d2h"):
                want = sum(w.chunk_transfers.get(key, 0) or n
                           for key, n in w.transfers.items() if key[0] == direction)
                assert sites[direction] == want, (w.index, direction, dict(sites))
            marked += sites["launch"]
        assert marked == launches - fused_launches + windows > 0
        if path == "fused":
            assert stats["windows"] > 0
        if path == "streamed":
            assert any(w.chunk_transfers for w in cr.cores.workers)
        cr.fine_grained_queue_control = False
        assert not cr.fine_grained_queue_control
        assert all(w.markers is None for w in cr.cores.workers)
    finally:
        pair.dispose()


def test_repeat_count_marks_one_dispatch_not_each_repeat():
    """``repeat_count=100`` is one fused-launcher call on a lane: one
    launch marker (the reference's ``test_repeat_is_one_fused_dispatch``:
    an upload, one launch, a download)."""
    pair = Pair(INC, 1)
    try:
        for cr, CA in pair.both():
            cr.fine_grained_queue_control = True
            x = CA(np.zeros(256, np.float32), name="x")
            x.partial_read = True
            cr.repeat_count = 100
            x.compute(cr, 1, "inc", 256, 64)
            np.testing.assert_array_equal(np.asarray(x), 100.0)
            w = cr.cores.workers[0]
            w.markers.drain(timeout=10.0)
            assert w.markers.added <= 4, w.markers.added
        assert dict(pair.port.cores.workers[0].markers_by_site) == {"h2d": 1, "launch": 1, "d2h": 1}
    finally:
        pair.dispose()


# -- the dispatch gate -------------------------------------------------------------

def _gated(cr, CA, gate) -> dict:
    """The reference's synchronized start: a compute from a thread holds
    until ``gate`` fires, the lanes' locks stay free meanwhile, then the
    result is exact."""
    x = CA(np.zeros(512, np.float32), name="x")
    x.partial_read = True
    cr.dispatch_gate = gate
    done = threading.Event()
    t = threading.Thread(target=lambda: (x.compute(cr, 21, "inc", 512, 64), done.set()))
    t.start()
    try:
        time.sleep(0.15)
        held = not done.is_set() and bool(np.all(np.asarray(x) == 0.0))
        # the held lanes wait outside their locks: another caller can take them
        free = []
        for w in cr.cores.workers:
            got = w.lock.acquire(timeout=2.0)
            free.append(got)
            if got:
                w.lock.release()
        gate.trigger()
        t.join(timeout=10.0)
    finally:
        gate.trigger()
        t.join(timeout=10.0)
    cr.dispatch_gate = None
    return {"held": held, "free": free, "done": done.is_set(), "x": np.asarray(x).copy()}


def test_a_gated_compute_holds_until_the_trigger():
    pair = Pair(INC, 2)
    try:
        runs = {}
        for (cr, CA), gate, pkg in zip(pair.both(), (UserEvent(), RefEvent()), ("port", "ref")):
            runs[pkg] = _gated(cr, CA, gate)
            gate.close()
        for r in runs.values():
            assert r["held"] and r["done"] and r["free"] == [True, True]
            np.testing.assert_array_equal(r["x"], 1.0)
        assert pair.port.dispatch_gate is None
    finally:
        pair.dispose()


def test_a_set_gate_refuses_a_window_as_dispatch_gate():
    """In enqueue mode a set (fired) gate keeps a repeat off the fused
    windows: every engage attempt counts ``dispatch-gate``."""
    pair = Pair(INC, 2, fused=True)
    try:
        for (cr, CA), gate in zip(pair.both(), (UserEvent(), RefEvent())):
            gate.trigger()
            cr.dispatch_gate = gate
            x = CA(np.zeros(1024, np.float32), name="x")
            x.partial_read = True
            cr.enqueue_mode = True
            for _ in range(4):
                x.compute(cr, 62, "inc", 1024, 64)
            cr.enqueue_mode = False
            cr.dispatch_gate = None
            gate.close()
            np.testing.assert_array_equal(np.asarray(x), 4.0)
        assert pair.port.fused_stats == pair.ref.fused_stats
        assert pair.port.fused_stats["disengaged"] == {"dispatch-gate": 3}
        assert pair.port.fused_stats["windows"] == 0
    finally:
        pair.dispose()


def test_a_gate_set_mid_window_breaks_it_as_a_mode_change():
    """The reference's ``test_disengage_mode_change_mid_window`` with a
    gate: set mid-window it breaks the window ("mode-change"), and the
    gated call runs per call once the gate has fired."""
    pair = Pair(INC, 2, fused=True)
    try:
        for (cr, CA), gate in zip(pair.both(), (UserEvent(), RefEvent())):
            x = CA(np.zeros(512, np.float32), name="x")
            x.partial_read = True
            cr.enqueue_mode = True
            x.compute(cr, 66, "inc", 512, 64)
            x.compute(cr, 66, "inc", 512, 64)  # engages
            x.compute(cr, 66, "inc", 512, 64)  # defers
            gate.trigger()
            cr.dispatch_gate = gate
            x.compute(cr, 66, "inc", 512, 64)  # breaks the window, runs per call
            cr.dispatch_gate = None
            x.compute(cr, 66, "inc", 512, 64)  # engages again
            x.compute(cr, 66, "inc", 512, 64)  # defers
            cr.enqueue_mode = False
            gate.close()
            np.testing.assert_array_equal(np.asarray(x), 6.0)
        assert pair.port.fused_stats == pair.ref.fused_stats
        assert pair.port.fused_stats["disengaged"] == {"mode-change": 1}
    finally:
        pair.dispose()


# -- marker_overhead ---------------------------------------------------------------

def test_marker_overhead_on_a_host_lane_has_the_reference_s_keys():
    got = wl.marker_overhead(n=256, dispatches=10)
    want = ref_workloads.marker_overhead(n=256, dispatches=10)
    assert set(got) == set(want)
    assert got["dispatches"] == 10 and got["reference_claim_us"] == want["reference_claim_us"]
    for key in ("markers_off_us", "markers_on_us", "marker_cost_us"):
        assert np.isfinite(got[key]), key
    assert got["marker_cost_us"] == pytest.approx(got["markers_on_us"] - got["markers_off_us"],
                                                  abs=0.11)
