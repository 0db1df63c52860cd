"""The device timeline of the port (``trace/device.py``,
``trace/attribution.py``, ``trace/export.py``, ``utils/timeline.py``)
against the JAX package's.

- **Pure functions, same inputs.**  Seeded synthetic marks, kernel
  records and spans go through both packages' ``correlate``,
  ``roofline_row``, ``unified_chrome_trace`` / ``split_unified_trace``,
  ``window_report``, ``to_chrome_trace`` / ``from_chrome_trace``,
  ``parse_mark_name`` and ``_merged_busy``: equal results.  The reference
  parses an Xprof dump and the port a ``torch.profiler`` trace, so
  ``correlate`` is fed the reference's parse of a synthetic Xprof dump,
  and the port's parse of the same records written as a
  ``torch.profiler`` trace must give the same ops and marks.
- **Links.**  A hand-written ``torch.profiler`` trace of kernel records
  ties each record to the mark whose device-side range holds it, counted,
  and leaves the lead kernels' records out.
- **End to end on host lanes.**  ``capture_device`` around enqueued
  calls with ``trace_lanes`` on: every launch mark is recorded and found
  in the exported trace, the report names the absence of a device track,
  and the fused reason ``trace-lanes`` is counted as the reference
  counts it.
"""

from __future__ import annotations

import gzip
import json
import os
import time

import numpy as np
import pytest

import cekirdekler_tpu
import cekirdekler_tpu_torch as ck
from cekirdekler_tpu.trace import attribution as ref_attr
from cekirdekler_tpu.trace import device as ref_dv
from cekirdekler_tpu.trace import export as ref_export
from cekirdekler_tpu.trace.spans import Span as RefSpan
from cekirdekler_tpu.utils import timeline as ref_timeline
from cekirdekler_tpu_torch.errors import NotPortedError
from cekirdekler_tpu_torch.trace import attribution, export
from cekirdekler_tpu_torch.trace import device as dv
from cekirdekler_tpu_torch.trace.spans import Span
from cekirdekler_tpu_torch.utils import timeline
from tests.test_torch_enqueue import Pair
from tests.test_torch_metrics import INC, restore_planes, save_planes


@pytest.fixture(autouse=True)
def _planes():
    saved = save_planes()
    yield
    restore_planes(saved)
    dv.MARKS.disable()


# ---------------------------------------------------------------------------
# seeded synthetic inputs
# ---------------------------------------------------------------------------

KERNELS = ("nBody", "mandelbrot", "add", "add_fused", "inc")


def _synthetic(seed: int):
    """(marks, Xprof events, window) of a seeded window: marks of several
    kernels, lanes and cids, device ops after them (some named for their
    kernel, some carrying ``ck-seq``, some anonymous), a few ops outside
    the window, dump marks for some of the marks."""
    rng = np.random.default_rng(seed)
    t0 = 1000.0 + float(rng.uniform(0, 10))
    marks, events = [], [
        {"ph": "M", "name": "process_name", "pid": 7, "args": {"name": "/device:TPU:0"}},
        {"ph": "M", "name": "thread_name", "pid": 7, "tid": 2, "args": {"name": "XLA Ops"}},
        {"ph": "M", "name": "thread_name", "pid": 7, "tid": 3, "args": {"name": "XLA Ops"}},
    ]
    offset_s = t0 - 0.001  # perf_counter s = trace µs * 1e-6 + offset
    t = 0.002
    for seq in range(1, int(rng.integers(2, 12))):
        kernel = KERNELS[int(rng.integers(0, len(KERNELS)))]
        cid = None if rng.random() < 0.2 else int(rng.integers(1, 4))
        lane = None if rng.random() < 0.1 else int(rng.integers(0, 3))
        m0 = t0 + t
        marks.append(ref_dv.Mark(seq, kernel, cid, lane, m0, m0 + 0.00005))
        if rng.random() < 0.6:
            name = (f"ck|k={kernel}|c={'-' if cid is None else cid}"
                    f"|l={'-' if lane is None else lane}|s={seq}")
            events.append({"ph": "X", "pid": 1, "tid": 0, "ts": (m0 - offset_s) * 1e6,
                           "dur": 50.0, "name": name})
        for _ in range(int(rng.integers(0, 4))):
            ts = (m0 - offset_s) * 1e6 + float(rng.uniform(5, 400))
            shape = rng.random()
            name = (f"fusion.{kernel}.{seq}" if shape < 0.4
                    else f"op.{int(rng.integers(0, 99))}")
            args = {"ck-seq": seq} if 0.4 <= shape < 0.6 else {}
            events.append({"ph": "X", "pid": 7, "tid": int(rng.choice([2, 3])), "ts": ts,
                           "dur": float(rng.uniform(1, 300)), "name": name, "args": args})
        t += float(rng.uniform(0.0002, 0.002))
    # an op before the first mark, and one past the window
    events.append({"ph": "X", "pid": 7, "tid": 2, "ts": 10.0, "dur": 5.0, "name": "early"})
    window = (t0, t0 + t + 0.0005)
    events.append({"ph": "X", "pid": 7, "tid": 2, "ts": (window[1] - offset_s) * 1e6 + 50.0,
                   "dur": 20.0, "name": "late"})
    return marks, events, window, offset_s


def _write(dirpath, events, name="host.trace.json.gz"):
    os.makedirs(dirpath, exist_ok=True)
    path = os.path.join(dirpath, name)
    opener = gzip.open if name.endswith(".gz") else open
    with opener(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return path


def _as_torch_trace(events):
    """The same records as a ``torch.profiler`` chrome trace: the device
    ops as CUDA kernel records of device 0 (the stream as the tid), the
    marks as host ``user_annotation`` ranges."""
    out = [{"ph": "M", "name": "process_labels", "pid": 0, "tid": 0,
            "args": {"labels": "/device:TPU:0"}}]
    for e in events:
        if e.get("ph") != "X":
            continue
        if e["name"].startswith("ck|"):
            out.append(dict(e, pid=4242, tid=4242, cat="user_annotation"))
        else:
            out.append(dict(e, pid=0, cat="kernel"))
    return out


def _port_dump(ref_dump):
    """The reference's parsed dump as the port's ``TraceDump``."""
    return dv.TraceDump(path=ref_dump.path, ops=[dv.DeviceOp(*o) for o in ref_dump.ops],
                        dump_marks=dict(ref_dump.dump_marks), devices=list(ref_dump.devices),
                        n_events=ref_dump.n_events)


@pytest.mark.parametrize("seed", range(16))
def test_correlate_is_the_reference_s(seed, tmp_path):
    marks, events, window, offset_s = _synthetic(seed)
    _write(str(tmp_path / "x"), events)
    ref_dump = ref_dv.parse_trace_dump(str(tmp_path / "x"))
    pmarks = [dv.Mark(*m) for m in marks]
    for kw in ({}, {"window": window},
               {"window": window, "capture_anchor": (window[0], 1000.0)},
               {"capture_anchor": (window[0], 0.0)}):
        use = marks if kw.get("window") is not None or seed % 2 else marks[: len(marks) // 2]
        ref = ref_dv.correlate(ref_dump, use, **kw)
        mine = dv.correlate(_port_dump(ref_dump), pmarks[: len(use)], **kw)
        assert mine.to_dict() == ref.to_dict()
        assert [tuple(o) for o in mine.ops] == [tuple(o) for o in ref.ops]
        assert mine.table() == ref.table()


@pytest.mark.parametrize("seed", range(8))
def test_the_port_parses_a_torch_trace_as_the_reference_parses_xprof(seed, tmp_path):
    marks, events, _window, _off = _synthetic(seed)
    _write(str(tmp_path / "ref"), events)
    _write(str(tmp_path / "port"), _as_torch_trace(events), "ck.1.1.pt.trace.json")
    ref = ref_dv.parse_trace_dump(str(tmp_path / "ref"))
    mine = dv.parse_trace_dump(str(tmp_path / "port"))
    assert mine.dump_marks == ref.dump_marks
    strip = ("ck-seq",)
    assert [(o.name, o.ts, o.dur, o.tid, {k: v for k, v in o.args.items() if k in strip})
            for o in mine.ops] == \
        [(o.name, o.ts, o.dur, o.tid, {k: v for k, v in o.args.items() if k in strip})
         for o in ref.ops]
    assert mine.devices == ["/device:TPU:0"]


def test_empty_and_missing_dumps_are_named_absences(tmp_path):
    for d in (str(tmp_path / "none"), str(tmp_path)):
        mine = dv.correlate(dv.parse_trace_dump(d), [])
        ref = ref_dv.correlate(ref_dv.parse_trace_dump(d), [])
        assert mine.to_dict() == ref.to_dict() and mine.absent


@pytest.mark.parametrize("seed", range(6))
def test_unified_trace_and_its_split_are_the_reference_s(seed, tmp_path):
    marks, events, window, _off = _synthetic(seed)
    _write(str(tmp_path), events)
    ref_dump = ref_dv.parse_trace_dump(str(tmp_path))
    ref_rep = ref_dv.correlate(ref_dump, marks, window=window)
    mine_rep = dv.correlate(_port_dump(ref_dump), [dv.Mark(*m) for m in marks], window=window)
    rng = np.random.default_rng(seed)
    raw = []
    for _ in range(int(rng.integers(0, 8))):
        a = window[0] + float(rng.uniform(0, 0.003))
        raw.append(("launch" if rng.random() < 0.5 else "fence", a, a + float(rng.uniform(0, 1e-3)),
                    int(rng.integers(1, 4)), None if rng.random() < 0.3 else int(rng.integers(0, 3)),
                    "t"))
    spans = [Span(k, a, b, cid=c, lane=ln, tag=tg) for k, a, b, c, ln, tg in raw]
    ref_spans = [RefSpan(k, a, b, cid=c, lane=ln, tag=tg) for k, a, b, c, ln, tg in raw]
    counters = {"ck_x_total": [(window[0], 1.0), (window[0] + 0.001, 2.0)]} if seed % 2 else None
    mine = dv.unified_chrome_trace(spans, mine_rep, ops=mine_rep.ops,
                                   marks=[dv.Mark(*m) for m in marks], counters=counters,
                                   process_name="ck")
    ref = ref_dv.unified_chrome_trace(ref_spans, ref_rep, ops=ref_rep.ops, marks=marks,
                                      counters=counters, process_name="ck")
    assert mine == ref
    json.dumps(mine, allow_nan=False)
    m_spans, m_ops = dv.split_unified_trace(mine)
    r_spans, r_ops = ref_dv.split_unified_trace(ref)
    assert [tuple(s) if isinstance(s, tuple) else vars(s) for s in m_spans] == \
        [tuple(s) if isinstance(s, tuple) else vars(s) for s in r_spans]
    assert [tuple(o) for o in m_ops] == [tuple(o) for o in r_ops]
    # lossless: every span and every attributed op comes back
    assert len(m_spans) == len(spans) and len(m_ops) == len(mine_rep.ops)
    assert sorted(o.dur for o in m_ops) == sorted(o.dur for o in mine_rep.ops)
    assert sorted((o.kernel, o.seq) for o in m_ops) == \
        sorted((o.kernel, o.seq) for o in mine_rep.ops)


def test_unified_trace_refuses_request_tracks_until_reqtrace_is_ported():
    with pytest.raises(NotPortedError, match="A 5"):
        dv.unified_chrome_trace([], None, req_events=[{"rid": "r1"}])


@pytest.mark.parametrize("seed", range(6))
def test_roofline_row_is_the_reference_s(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        args = (float(rng.uniform(1e6, 1e14)), float(rng.uniform(1e3, 1e12)),
                float(rng.uniform(1e-3, 1e3)))
        kw = {"peak_tflops": float(rng.uniform(10, 1000)),
              "peak_gbps": float(rng.uniform(100, 4000))}
        if rng.random() < 0.5:
            kw["device_kind"] = "some card"
        assert dv.roofline_row(*args, **kw) == ref_dv.roofline_row(*args, **kw)
    # the port's own peaks: the card's table row
    row = dv.roofline_row(1e12, 1e9, 1.0, device_kind="NVIDIA H100 80GB HBM3")
    assert row["peak_kind"] == "NVIDIA H100 80GB HBM3" and row["bound"] == "compute"


def test_mark_names_parse_as_the_reference_s():
    rng = np.random.default_rng(3)
    names = ["not a mark", "ck|k=x", "ck|", "ck|k=a|s=x", "ck|s=4", "ck|k=a|c=-|l=-|s=9",
             "ck|k=a|c=1|l=2|s=3|extra", "ck|k=a=b|s=1", "ck|c=z|s=2"]
    for _ in range(200):
        k = KERNELS[int(rng.integers(0, len(KERNELS)))]
        c = None if rng.random() < 0.3 else int(rng.integers(-2, 99))
        ln = None if rng.random() < 0.3 else int(rng.integers(0, 8))
        names.append(dv._mark_name(k, c, ln, int(rng.integers(1, 10**6))))
    for name in names:
        assert dv.parse_mark_name(name) == ref_dv.parse_mark_name(name)
        assert dv._mark_name("k", 1, 2, 3) == ref_dv._mark_name("k", 1, 2, 3)


@pytest.mark.parametrize("seed", range(6))
def test_merged_busy_is_the_reference_s(seed):
    rng = np.random.default_rng(seed)
    for _ in range(100):
        iv = [(float(a), float(a + rng.uniform(0, 50)))
              for a in rng.uniform(0, 500, int(rng.integers(0, 20)))]
        assert timeline._merged_busy(list(iv)) == ref_timeline._merged_busy(list(iv))
        assert attribution.union_ms(list(iv)) == ref_attr.union_ms(list(iv))


def _spans(seed):
    rng = np.random.default_rng(seed)
    raw = []
    for _ in range(int(rng.integers(0, 30))):
        a = float(rng.uniform(0, 1.0))
        raw.append((str(rng.choice(["launch", "fence", "upload", "enqueue", "download"])), a,
                    a + float(rng.uniform(0, 0.2)),
                    None if rng.random() < 0.3 else int(rng.integers(1, 5)),
                    None if rng.random() < 0.3 else int(rng.integers(0, 4)),
                    None if rng.random() < 0.5 else "tag"))
    return ([Span(k, a, b, cid=c, lane=ln, tag=t) for k, a, b, c, ln, t in raw],
            [RefSpan(k, a, b, cid=c, lane=ln, tag=t) for k, a, b, c, ln, t in raw])


@pytest.mark.parametrize("seed", range(8))
def test_window_report_is_the_reference_s(seed):
    spans, ref_spans = _spans(seed)
    kinds = ["gpu", "cpu", "cpu", "gpu"] if seed % 2 else {0: "gpu", 2: "cpu"}
    for args, kw in (((0.1, 0.9), {}), ((0.0, 1.2), {"device_busy_ms": 42.0}),
                     ((0.2, 0.5), {"dropped_spans": 3, "lane_kinds": kinds}),
                     ((0.5, 0.4), {"ring_wrapped": True})):
        mine = attribution.window_report(spans, *args, **kw)
        ref = ref_attr.window_report(ref_spans, *args, **kw)
        assert mine.to_dict() == ref.to_dict()
        assert mine.table() == ref.table()
    assert export.text_table(spans) == ref_export.text_table(ref_spans)


@pytest.mark.parametrize("seed", range(6))
def test_chrome_export_and_import_are_the_reference_s(seed, tmp_path):
    spans, ref_spans = _spans(seed)
    counters = {"ck_a_total": [(0.5, 1.0), (0.7, float("inf"))]} if seed % 2 else None
    mine = export.to_chrome_trace(spans, "ck", counters=counters)
    ref = ref_export.to_chrome_trace(ref_spans, "ck", counters=counters)
    assert mine == ref
    assert [vars(s) if not isinstance(s, tuple) else tuple(s)
            for s in export.from_chrome_trace(mine)] == \
        [vars(s) if not isinstance(s, tuple) else tuple(s)
         for s in ref_export.from_chrome_trace(ref)]
    export.save_chrome_trace(spans, str(tmp_path / "a.json"), "ck", counters=counters)
    ref_export.save_chrome_trace(ref_spans, str(tmp_path / "b.json"), "ck", counters=counters)
    assert json.loads((tmp_path / "a.json").read_text()) == \
        json.loads((tmp_path / "b.json").read_text())
    assert len(export.from_chrome_trace(mine)) == len(spans)


# ---------------------------------------------------------------------------
# the links of a torch.profiler trace
# ---------------------------------------------------------------------------

def _links_trace():
    """A torch.profiler-shaped trace: on device 0, stream 7, three kernels
    inside the device-side mirrors of marks 1 and 2 (the second mirror
    nested in a wider one of mark 3), one kernel outside any mirror, one
    inside a mirror on another stream, and a lead kernel; each kernel
    launched by a cuda_runtime record."""
    host, lane = 100, 200
    ev = [{"ph": "M", "name": "process_labels", "pid": 0, "args": {"labels": "GPU 0"}}]
    ann = lambda seq, ts, dur=20.0: {"ph": "X", "cat": "user_annotation", "pid": host,
                                     "tid": lane, "ts": ts, "dur": dur,
                                     "name": dv._mark_name("k", 1, 0, seq)}
    mirror = lambda seq, ts, dur, tid=7: {"ph": "X", "cat": "gpu_user_annotation", "pid": 0,
                                          "tid": tid, "ts": ts, "dur": dur,
                                          "name": dv._mark_name("k", 1, 0, seq)}
    rt = lambda corr, ts: {"ph": "X", "cat": "cuda_runtime", "pid": host, "tid": lane,
                           "ts": ts, "dur": 3.0, "name": "cudaLaunchKernel",
                           "args": {"correlation": corr}}
    kern = lambda corr, ts, name="ck_kernel_escape": {
        "ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": ts, "dur": 40.0, "name": name,
        "args": {"correlation": corr, "stream": 7}}
    ev += [ann(1, 1000.0), rt(501, 1005.0), kern(501, 1100.0), mirror(1, 1100.0, 40.0),
           ann(3, 1900.0, 300.0), ann(2, 2000.0), rt(502, 2005.0), kern(502, 2100.0),
           rt(503, 2008.0), kern(503, 2150.0), mirror(3, 2050.0, 500.0),
           mirror(2, 2100.0, 90.0),
           rt(504, 5005.0), kern(504, 5100.0),
           mirror(4, 6000.0, 100.0, tid=9), rt(505, 5900.0), kern(505, 6010.0),
           kern(506, 50.0, name="void spin_kernel(long)")]
    return ev


def test_kernel_records_link_to_the_mark_whose_device_range_holds_them(tmp_path):
    _write(str(tmp_path), _links_trace(), "ck.1.1.pt.trace.json")
    dump = dv.parse_trace_dump(str(tmp_path), lead_kernel="spin_kernel")
    assert dump.lead_records == 1 and len(dump.ops) == 5
    # the innermost mirror wins; a mirror on another stream links nothing
    assert [o.args.get("ck-seq") for o in dump.ops] == [1, 2, 2, None, None]
    assert dump.links == {"device-range": 3, "none": 2}
    assert sorted(dump.dump_marks) == [1, 2, 3]
    marks = [dv.Mark(s, "k", 1, 0, 1.0 + s * 1e-3, 1.0 + s * 1e-3 + 2e-5) for s in (1, 2, 3)]
    rep = dv.correlate(dump, marks)
    # the unlinked records fall to the reference's kernel-name tier ("k")
    assert rep.matched_by == {"explicit": 3, "kernel-name": 2}
    assert rep.kernel("k").op_count == 5 and rep.coverage_frac == pytest.approx(1.0)


def test_a_trace_without_device_records_says_so(tmp_path):
    _write(str(tmp_path), [e for e in _links_trace() if e.get("cat") != "kernel"],
           "ck.1.1.pt.trace.json")
    tl = timeline.analyze_trace_dir(str(tmp_path))
    assert tl.compute_busy_ms == 0.0 and tl.absent and "no CUDA kernel" in tl.absent
    _write(str(tmp_path), _links_trace(), "ck.1.2.pt.trace.json")
    os.utime(tmp_path / "ck.1.2.pt.trace.json", (time.time() + 5, time.time() + 5))
    tl = timeline.analyze_trace_dir(str(tmp_path))
    # six kernel records (the lead's too), 40 µs each, none overlapping
    assert tl.absent is None and tl.n_events == 6 and tl.n_devices == 1
    assert tl.compute_busy_ms == pytest.approx(0.24)


def test_a_cpu_capture_holds_host_events_and_no_device_time(tmp_path):
    with timeline.capture(str(tmp_path)) as result:
        (np.ones(1000) + 1).sum()
        import torch

        torch.ones(1000).add_(1)
    tl = result()
    assert tl.trace_path and tl.trace_path.endswith(".pt.trace.json")
    assert tl.absent and tl.n_events == 0 and tl.compute_busy_fraction == 0.0


# ---------------------------------------------------------------------------
# marks and capture, end to end on host lanes
# ---------------------------------------------------------------------------

def test_disabled_marks_cost_an_attribute_read():
    m = dv.DeviceMarks()
    n = 50_000
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            tok = m.begin(("k",), 1, 0) if m.enabled else None
            if tok is not None:
                m.end(tok)
        best = min(best, (time.perf_counter() - t0) / n)
    assert m.total_recorded == 0 and best < 5e-6


@pytest.mark.parametrize("lanes", [1, 2])
def test_capture_device_records_every_launch_mark_and_finds_it_in_the_trace(lanes, tmp_path):
    pair = Pair(INC, lanes)
    try:
        cr = pair.port
        cr.cores.trace_lanes = True
        x = ck.ClArray(np.zeros(4096, np.float32), name="x", partial_read=True)
        cr.enqueue_mode = True
        x.compute(cr, 1, "inc", 4096, 64)  # outside the window
        cr.barrier()  # a host lane's enqueued launch runs on its own thread
        with dv.capture_device(str(tmp_path)) as cap:
            for _ in range(5):
                x.compute(cr, 1, "inc", 4096, 64)
            cr.barrier()
        cr.enqueue_mode = False
        np.testing.assert_array_equal(x.host(), 6.0)
        rep = cap.report
        marks = [m for m in dv.MARKS.snapshot() if m.t1 >= cap._t0]
        assert len(marks) == 5 * lanes and {m.kernel for m in marks} == {"inc"}
        assert {m.lane for m in marks} == set(range(lanes)) and {m.cid for m in marks} == {1}
        dump = dv.parse_trace_dump(str(tmp_path))
        assert {m.seq for m in marks} <= set(dump.dump_marks)
        assert rep.n_marks == rep.n_dump_marks == 5 * lanes
        assert rep.absent and "no device op" in rep.absent and rep.n_ops == 0
        assert dv.last_report() is rep
        payload = dv.profilez_payload()
        assert payload["last_capture"]["absent"] == rep.absent
        assert not dv.MARKS.enabled
        assert set(cr.cores.lane_trace[1]) and len(cr.cores.lane_trace[1]) == lanes
    finally:
        pair.dispose()


def test_trace_lanes_keeps_calls_off_the_fused_path_as_the_reference_does():
    pair = Pair(INC, 2, fused=True)
    try:
        stats = []
        for cr, CA in pair.both():
            cr.cores.trace_lanes = True
            x = CA(np.zeros(2048, np.float32), name="x")
            x.partial_read = True
            cr.enqueue_mode = True
            for _ in range(6):
                x.compute(cr, 3, "inc", 2048, 64)
            cr.barrier()
            cr.enqueue_mode = False
            np.testing.assert_array_equal(np.asarray(x), 6.0)
            trace = cr.cores.lane_trace[3]
            assert sorted(ln for ln, _d, _j in trace) == [0, 1]
            assert all(d <= j for _ln, d, j in trace)
            stats.append({k: cr.fused_stats[k] for k in ("windows", "fused_iters",
                                                         "deferred_iters", "disengaged")})
        assert stats[0] == stats[1]
        assert stats[0]["disengaged"].get("trace-lanes", 0) > 0 and stats[0]["windows"] == 0
    finally:
        pair.dispose()


def test_a_failed_window_and_a_missing_profiler_are_named_absences(monkeypatch, tmp_path):
    with pytest.raises(ValueError, match="inside"):
        with dv.capture_device(str(tmp_path)):
            raise ValueError("inside")
    assert "ValueError" in dv.last_report().absent
    monkeypatch.setattr(timeline, "start_profiler", lambda d: (None, "RuntimeError: none"))
    with dv.capture_device(str(tmp_path / "off")) as cap:
        pass
    assert "profiler unavailable" in cap.report.absent and cap.report.wall_ms > 0


def test_the_profile_store_is_the_reference_s(tmp_path):
    rows = [{"device_ms": 3.0}, {"device_ms": 1.5}, {"device_ms": 2.0}]
    mine, ref = dv.ProfileStore(str(tmp_path / "p")), ref_dv.ProfileStore(str(tmp_path / "r"))
    for r in rows:
        mine.put("nBody", (8192,), ("4096+4096", 256), r)
        ref.put("nBody", (8192,), ("4096+4096", 256), r)
    strip = lambda rs: [{k: v for k, v in r.items() if k != "wrote_at"} for r in rs]
    assert strip(mine.history("nBody", (8192,), ("4096+4096", 256))) == \
        strip(ref.history("nBody", (8192,), ("4096+4096", 256)))
    assert mine.keys() == ref.keys()
    assert strip([mine.best("nBody", (8192,), ("4096+4096", 256))]) == \
        strip([ref.best("nBody", (8192,), ("4096+4096", 256))])
    assert not dv.ProfileStore(None).enabled or os.environ.get(dv.PROFILE_STORE_ENV)


def test_the_reference_s_names_are_exported():
    assert set(ck.trace.__all__) - {"union_ms"} <= set(cekirdekler_tpu.trace.__all__)
    assert dv.DEVICE_SPAN_KINDS == ref_dv.DEVICE_SPAN_KINDS
    assert dv.MARK_PREFIX == ref_dv.MARK_PREFIX and dv.STORE_SCHEMA == ref_dv.STORE_SCHEMA
