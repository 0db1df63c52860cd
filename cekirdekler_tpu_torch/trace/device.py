"""Device-timeline attribution: per-kernel profiles from a
``torch.profiler`` trace unified with host spans, plus the roofline view
and a persistent kernel-profile store.

Counterpart of ``cekirdekler_tpu/trace/device.py``, which reads an Xprof
dump through ``jax.profiler``; here the capture seam is
``utils/timeline.py`` over ``torch.profiler`` and the device ops are the
CUDA kernel records of its chrome trace.  The pure functions
(:func:`parse_mark_name`, :func:`correlate`, :func:`roofline_row`,
:func:`unified_chrome_trace`, :func:`split_unified_trace`) are the
reference's.

1. **Marks.**  Every launch of ``Worker.launch`` / ``launch_fused`` is
   tagged with a ``torch.profiler.record_function`` range named
   ``ck|k=<kernel>|c=<cid>|l=<lane>|s=<seq>`` (:data:`MARKS`,
   :meth:`DeviceMarks.begin` / :meth:`DeviceMarks.end`, behind a plain
   ``.enabled`` check).  The same mark is recorded HOST-side with
   ``perf_counter`` timestamps and the launching thread, so every mark
   exists on both clocks.

2. **Capture.**  :class:`DeviceCapture` wraps a traced window: start the
   profiler on every thread (``timeline.start_profiler``; the lanes launch
   from pool threads), open the window with the lead kernels of
   ``tools/trace_window.py`` (a trace on the card drops the first records
   of a window; the leads' records are left out and counted), enable
   marks, run the window, stop, then parse the dump and correlate kernel
   records back to marks.  Without a CUDA device the trace holds no kernel
   record and the report is a NAMED absence (``report.absent``) — never a
   crash, never host ops passed off as device time.

3. **Links** (:func:`parse_trace_dump`).  The profiler mirrors each
   ``record_function`` range onto the device tracks as a
   ``gpu_user_annotation`` spanning the kernels launched inside it (it
   ties them by their correlation ids), so a kernel record that lies in a
   ``ck|`` mirror on its own stream carries that mark's ``ck-seq`` in its
   args and :func:`correlate` attributes it in its *explicit* tier.
   ``report.links`` counts the records linked so and those not; the rest
   fall to the reference's kernel-name and stream-order tiers.

4. **Outputs.**  A :class:`DeviceWindowReport` (per-kernel device wall,
   op counts, inter-op idle gaps, per-lane busy, reconciled against the
   host window), :func:`roofline_row` (arithmetic intensity against the
   card's roofline from ``hardware.device_peaks``),
   :func:`unified_chrome_trace` (kernel records as per-lane device
   tracks beside the host span tracks on ONE clock), and
   :class:`ProfileStore` (``CK_PROFILE_STORE``).

Nothing here imports torch at module level.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, NamedTuple, Sequence

from .spans import Span
# interval-union reduction shared with the busy/span analyzer — one
# implementation (utils/timeline.py), two consumers, no drift
from ..utils.timeline import KERNEL_CAT, device_pids
from ..utils.timeline import _merged_busy as _union_us

__all__ = [
    "DEVICE_SPAN_KINDS",
    "DeviceMarks",
    "MARKS",
    "Mark",
    "DeviceOp",
    "KernelDeviceProfile",
    "DeviceWindowReport",
    "DeviceCapture",
    "capture_device",
    "parse_trace_dump",
    "correlate",
    "roofline_row",
    "unified_chrome_trace",
    "split_unified_trace",
    "ProfileStore",
    "STORE",
    "profilez_payload",
    "last_report",
]

#: Event kinds the UNIFIED Perfetto export places on device tracks
#: (``cat: "ck-dev"``): ``device-op`` — one kernel record (name carries
#: the attributed kernel); ``device-mark`` — a launch mark replayed onto
#: the host lane track so the dispatch edge is visible next to the ops it
#: explains.
DEVICE_SPAN_KINDS = ("device-op", "device-mark")

#: Mark-name prefix in the trace.  Format:
#: ``ck|k=<kernel>|c=<cid>|l=<lane>|s=<seq>`` (``c=-`` when no cid).
MARK_PREFIX = "ck|"

#: Store schema tag — bump on incompatible row changes.
STORE_SCHEMA = "ck-kernel-profile-v1"

#: Environment variable naming the persistent profile-store directory.
PROFILE_STORE_ENV = "CK_PROFILE_STORE"


# ---------------------------------------------------------------------------
# marks: the launch-side half of the correlation
# ---------------------------------------------------------------------------

class Mark(NamedTuple):
    """One annotated launch, host-clock side.  ``t0``/``t1`` are
    ``perf_counter`` seconds (``t1`` 0.0 until :meth:`DeviceMarks.end`
    closes it)."""

    seq: int
    kernel: str
    cid: int | None
    lane: int | None
    t0: float
    t1: float = 0.0


def _mark_name(kernel: str, cid: int | None, lane: int | None,
               seq: int) -> str:
    return (f"{MARK_PREFIX}k={kernel}"
            f"|c={'-' if cid is None else cid}"
            f"|l={'-' if lane is None else lane}|s={seq}")


def parse_mark_name(name: str) -> dict | None:
    """``ck|k=...|c=...|l=...|s=...`` → field dict, or None when the
    name is not a mark."""
    if not name.startswith(MARK_PREFIX):
        return None
    out: dict = {"kernel": "?", "cid": None, "lane": None, "seq": None}
    for part in name[len(MARK_PREFIX):].split("|"):
        if "=" not in part:
            continue
        k, v = part.split("=", 1)
        if k == "k":
            out["kernel"] = v
        elif k in ("c", "l", "s") and v not in ("-", ""):
            try:
                out[{"c": "cid", "l": "lane", "s": "seq"}[k]] = int(v)
            except ValueError:
                pass
    return out if out["seq"] is not None else None


class DeviceMarks:
    """Process-global launch annotator (one instance: :data:`MARKS`).

    ``enabled`` is a plain attribute — the tracer convention: the
    disabled fast path at a launch site is one attribute read plus a
    falsy check, nothing allocated, no clock read.  Enabled, each
    ``begin``/``end`` pair opens/closes a ``torch.profiler.record_function``
    range around the dispatch AND records the host-clock :class:`Mark` —
    the same (seq, kernel, cid, lane) on both clocks is what anchors the
    unified timeline.  Recording
    is a GIL-atomic ``deque.append``; no lock is taken on the launch
    path."""

    def __init__(self, capacity: int = 65536):
        self.enabled = False
        self._ring: deque[Mark] = deque(maxlen=max(16, int(capacity)))
        self._seq = itertools.count(1)
        self._ann_cls = None  # torch.profiler.record_function, cached on enable

    # -- hot path ------------------------------------------------------------
    def begin(self, kernel_names, cid: int | None, lane: int | None):
        """Open a mark around a launch dispatch; returns an opaque token
        for :meth:`end`, or None when disabled (callers pass it back
        unconditionally — ``end(None)`` is a no-op)."""
        if not self.enabled:
            return None
        seq = next(self._seq)
        kernel = "+".join(kernel_names) if not isinstance(kernel_names, str) \
            else kernel_names
        ann = None
        if self._ann_cls is not None:
            try:
                ann = self._ann_cls(_mark_name(kernel, cid, lane, seq))
                ann.__enter__()
            except Exception:  # noqa: BLE001 - marking must never sink a launch
                ann = None
        return (ann, seq, kernel, cid, lane, time.perf_counter())

    def end(self, token) -> None:
        """Close a mark opened by :meth:`begin` (no-op on None)."""
        if token is None:
            return
        ann, seq, kernel, cid, lane, t0 = token
        t1 = time.perf_counter()
        if ann is not None:
            try:
                ann.__exit__(None, None, None)
            except Exception:  # noqa: BLE001
                pass
        self._ring.append(Mark(seq, kernel, cid, lane, t0, t1))

    # -- control / inspection (cold) -----------------------------------------
    def enable(self, clear: bool = True) -> None:
        if clear:
            self._ring.clear()
        if self._ann_cls is None:
            try:
                from torch.profiler import record_function

                self._ann_cls = record_function
            except Exception:  # noqa: BLE001 - host marks still work
                self._ann_cls = None
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def snapshot(self) -> list[Mark]:
        return sorted(self._ring, key=lambda m: m.seq)

    @property
    def total_recorded(self) -> int:
        return len(self._ring)


#: The process-global marker every launch site uses.
MARKS = DeviceMarks()


# ---------------------------------------------------------------------------
# dump parsing
# ---------------------------------------------------------------------------

class DeviceOp(NamedTuple):
    """One kernel record from the trace.  ``ts``/``dur`` are the dump's
    microseconds (trace clock); ``kernel``/``seq`` are filled by
    :func:`correlate` (``kernel`` is ``"?"`` while unattributed),
    ``matched_by`` names the tier that attributed it."""

    device: str
    pid: int
    tid: int
    name: str
    ts: float
    dur: float
    args: dict
    kernel: str = "?"
    seq: int | None = None
    cid: int | None = None
    lane: int | None = None
    matched_by: str | None = None


@dataclass
class TraceDump:
    """Parsed view of one trace dir: kernel records + the marks found in
    the dump (trace-clock side)."""

    path: str | None = None
    ops: list = field(default_factory=list)        # [DeviceOp]
    dump_marks: dict = field(default_factory=dict)  # seq -> {ts, dur, fields}
    devices: list = field(default_factory=list)
    n_events: int = 0
    #: kernel records linked to a mark by its device-side range, and not
    links: dict = field(default_factory=dict)
    #: records of the window's lead kernels, left out of ``ops``
    lead_records: int = 0


def _int(v, default: int = 0) -> int:
    try:
        return int(v)
    except (TypeError, ValueError):
        return default


def parse_trace_dump(trace_dir: str, lead_kernel: str | None = None) -> TraceDump:
    """Parse the newest ``torch.profiler`` chrome trace under
    ``trace_dir`` into kernel records and dump-side marks.  Device
    processes are those that carry device records
    (``utils.timeline.DEVICE_CATS``); their ``kernel`` records are the
    ops, one track per stream.  ``X`` events named ``ck|...`` on a host
    thread are the dump's marks; on a device track they are the
    profiler's mirror of a mark's range, and a kernel record inside one on
    its own stream carries that mark's ``ck-seq`` (counted in
    ``links``).  Records of ``lead_kernel`` are left out and counted
    (``lead_records``)."""
    from ..utils.timeline import load_trace_events

    path, events = load_trace_events(trace_dir)
    dump = TraceDump(path=path, n_events=len(events))
    if not events:
        return dump
    devs = device_pids(events)
    mirrors: dict = {}         # (pid, tid) -> [(lo, hi, seq)]
    kernels: list = []
    for e in events:
        if e.get("ph") != "X":
            continue
        name = str(e.get("name", ""))
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if name.startswith(MARK_PREFIX):
            fields = parse_mark_name(name)
            if fields is None:
                continue
            if e.get("pid") in devs:
                mirrors.setdefault((e.get("pid"), e.get("tid")), []).append(
                    (ts, ts + dur, fields["seq"]))
            else:
                dump.dump_marks[fields["seq"]] = {"ts": ts, "dur": dur, **fields}
        elif e.get("cat") == KERNEL_CAT and e.get("pid") in devs:
            if lead_kernel and lead_kernel in name:
                dump.lead_records += 1
            else:
                kernels.append(e)
    dump.links = {"device-range": 0, "none": 0}
    for e in kernels:
        args = dict(e.get("args", {}) or {})
        ts = float(e.get("ts", 0.0))
        # the innermost (latest-opening) mirror holding the record's start
        held = [(lo, seq) for lo, hi, seq in mirrors.get((e.get("pid"), e.get("tid")), ())
                if lo <= ts <= hi]
        if held:
            args["ck-seq"] = max(held)[1]
            dump.links["device-range"] += 1
        else:
            dump.links["none"] += 1
        dump.ops.append(DeviceOp(
            device=devs[e.get("pid")], pid=_int(e.get("pid")), tid=_int(e.get("tid")),
            name=str(e.get("name", "")), ts=ts, dur=float(e.get("dur", 0.0)), args=args,
        ))
    dump.ops.sort(key=lambda o: o.ts)
    dump.devices = sorted({o.device for o in dump.ops} | set(devs.values()))
    return dump


# ---------------------------------------------------------------------------
# correlation
# ---------------------------------------------------------------------------


@dataclass
class KernelDeviceProfile:
    """One kernel's device-side account inside a captured window.  All
    times in milliseconds of DEVICE wall (union of op intervals per
    device track, summed over tracks — concurrent lanes legitimately
    sum past the host wall; the per-track union never does)."""

    kernel: str
    device_ms: float = 0.0
    op_count: int = 0
    launches: int = 0            # distinct marks attributed to
    idle_ms: float = 0.0         # inter-op gaps inside this kernel's stream
    per_lane_ms: dict = field(default_factory=dict)   # lane -> busy ms
    cids: list = field(default_factory=list)
    matched_by: dict = field(default_factory=dict)    # tier -> op count

    def to_dict(self) -> dict:
        return {
            "kernel": self.kernel,
            "device_ms": round(self.device_ms, 3),
            "op_count": self.op_count,
            "launches": self.launches,
            "idle_ms": round(self.idle_ms, 3),
            "per_lane_ms": {
                str(k): round(v, 3) for k, v in sorted(
                    self.per_lane_ms.items(),
                    key=lambda kv: (kv[0] is None, kv[0]))
            },
            "cids": self.cids,
            "matched_by": dict(self.matched_by),
        }


@dataclass
class DeviceWindowReport:
    """The reconciled device-side account of one captured host window.

    The reconciliation contract (never silently partial): per-track
    device busy is a UNION (≤ the window wall per track), attribution
    is explicit (``coverage_frac`` = attributed / device busy, with the
    unattributed remainder carried as ``unattributed_ms``), and a
    report that could not be produced at all says why in ``absent``."""

    wall_ms: float = 0.0          # host window wall (0 when unknown)
    device_span_ms: float = 0.0   # first device event → last, on device
    device_busy_ms: float = 0.0   # union per track, summed over tracks
    attributed_ms: float = 0.0
    unattributed_ms: float = 0.0
    kernels: list = field(default_factory=list)   # [KernelDeviceProfile]
    per_lane_overlap: dict = field(default_factory=dict)  # lane -> busy/wall
    n_ops: int = 0
    n_marks: int = 0
    n_dump_marks: int = 0
    devices: list = field(default_factory=list)
    anchor: str | None = None     # "marks" | "capture-start" | None
    anchor_offset_s: float | None = None  # perf_counter s − trace ts s
    matched_by: dict = field(default_factory=dict)
    clipped_ops: int = 0
    trace_path: str | None = None
    absent: str | None = None     # the named-absence reason
    #: the window-clipped, attribution-tagged ops (NOT serialized by
    #: to_dict — the unified Perfetto export consumes them)
    ops: list = field(default_factory=list, repr=False)
    #: the dump's kernel records linked to a launch mark by the mark's
    #: device-side range (``device-range``), and not (``none``)
    links: dict = field(default_factory=dict)
    #: the capture's lead kernels (``tools/trace_window.py``): launched,
    #: and the records of them the trace kept (left out of ``ops``)
    leads: dict = field(default_factory=dict)

    @property
    def coverage_frac(self) -> float:
        """Fraction of device-busy time attributed to a kernel — the
        number that must be read BEFORE any per-kernel row (a low
        coverage means the rows undercount, and the report says by
        exactly how much via ``unattributed_ms``)."""
        return (self.attributed_ms / self.device_busy_ms
                if self.device_busy_ms > 0 else 0.0)

    def kernel(self, name: str) -> KernelDeviceProfile | None:
        for k in self.kernels:
            if k.kernel == name:
                return k
        return None

    def to_dict(self) -> dict:
        return {
            "absent": self.absent,
            "wall_ms": round(self.wall_ms, 3),
            "device_span_ms": round(self.device_span_ms, 3),
            "device_busy_ms": round(self.device_busy_ms, 3),
            "attributed_ms": round(self.attributed_ms, 3),
            "unattributed_ms": round(self.unattributed_ms, 3),
            "coverage_frac": round(self.coverage_frac, 4),
            "kernels": [k.to_dict() for k in sorted(
                self.kernels, key=lambda k: -k.device_ms)],
            "per_lane_overlap": {
                str(k): round(v, 4) for k, v in sorted(
                    self.per_lane_overlap.items(),
                    key=lambda kv: (kv[0] is None, kv[0]))
            },
            "n_ops": self.n_ops,
            "n_marks": self.n_marks,
            "n_dump_marks": self.n_dump_marks,
            "devices": self.devices,
            "anchor": self.anchor,
            "matched_by": dict(self.matched_by),
            "clipped_ops": self.clipped_ops,
            "trace_path": self.trace_path,
            **({"links": dict(self.links)} if self.links else {}),
            **({"leads": dict(self.leads)} if self.leads else {}),
        }

    def table(self) -> str:
        if self.absent:
            return f"(device profile absent: {self.absent})"
        lines = [
            f"host wall {self.wall_ms:10.3f} ms   device busy "
            f"{self.device_busy_ms:10.3f} ms   attributed "
            f"{self.attributed_ms:10.3f} ms "
            f"({100.0 * self.coverage_frac:.1f}% coverage)",
            f"{'kernel':>24} {'device ms':>12} {'ops':>6} {'launches':>9} "
            f"{'idle ms':>10} {'lanes':>6}",
        ]
        for k in sorted(self.kernels, key=lambda k: -k.device_ms):
            lines.append(
                f"{k.kernel:>24} {k.device_ms:12.3f} {k.op_count:6d} "
                f"{k.launches:9d} {k.idle_ms:10.3f} "
                f"{len(k.per_lane_ms):6d}"
            )
        if self.unattributed_ms > 0:
            lines.append(
                f"{'(unattributed)':>24} {self.unattributed_ms:12.3f}")
        return "\n".join(lines)


def _explicit_seq(op: DeviceOp) -> int | None:
    """Tier-1 evidence on the op itself: a ``ck-seq`` arg, or a mark
    string embedded in the op name or any string arg."""
    v = op.args.get("ck-seq")
    if v is not None:
        try:
            return int(v)
        except (TypeError, ValueError):
            pass
    for s in (op.name, *[a for a in op.args.values() if isinstance(a, str)]):
        i = s.find(MARK_PREFIX)
        if i >= 0:
            fields = parse_mark_name(s[i:].split()[0])
            if fields is not None:
                return fields["seq"]
    return None


def correlate(
    dump: TraceDump,
    marks: Sequence[Mark] = (),
    window: tuple[float, float] | None = None,
    capture_anchor: tuple[float, float] | None = None,
) -> DeviceWindowReport:
    """Attribute the dump's device ops to launch marks and reconcile
    against the host window.

    ``marks`` are the host-side :class:`Mark` records captured around
    the window; ``window`` is the host ``(perf_t0, perf_t1)`` wall;
    ``capture_anchor`` is ``(perf_counter_at_start, trace_ts_us_origin)``
    — the fallback clock anchor when no mark appears in the dump."""
    report = DeviceWindowReport(trace_path=dump.path)
    if window is not None:
        report.wall_ms = max(window[1] - window[0], 0.0) * 1000.0
    report.n_marks = len(marks)
    report.n_dump_marks = len(dump.dump_marks)
    report.devices = list(dump.devices)
    if not dump.ops:
        report.absent = (
            "no device op events in the dump (profiler off, or a "
            "CPU-only rig whose backend exposes no device tracks)"
            if dump.n_events else
            "no trace events captured (profiler unavailable)")
        return report

    # -- clock anchor: perf_counter seconds = trace µs * 1e-6 + offset
    by_seq = {m.seq: m for m in marks}
    pairs = [
        (m.t0, dump.dump_marks[m.seq]["ts"])
        for m in marks if m.seq in dump.dump_marks
    ]
    if pairs:
        report.anchor = "marks"
        report.anchor_offset_s = sum(
            t0 - ts * 1e-6 for t0, ts in pairs) / len(pairs)
    elif capture_anchor is not None:
        report.anchor = "capture-start"
        report.anchor_offset_s = (
            capture_anchor[0] - capture_anchor[1] * 1e-6)

    # -- clip ops to the host window (only meaningful with an anchor)
    ops = dump.ops
    if window is not None and report.anchor_offset_s is not None:
        lo_us = (window[0] - report.anchor_offset_s) * 1e6
        hi_us = (window[1] - report.anchor_offset_s) * 1e6
        clipped: list[DeviceOp] = []
        for o in ops:
            s, e = o.ts, o.ts + o.dur
            cs, ce = max(s, lo_us), min(e, hi_us)
            if ce <= cs:
                report.clipped_ops += 1
                continue
            if (cs, ce) != (s, e):
                report.clipped_ops += 1
                o = o._replace(ts=cs, dur=ce - cs)
            clipped.append(o)
        ops = clipped
    report.n_ops = len(ops)
    if not ops:
        report.absent = (
            "every device op fell outside the host window "
            "(clock anchor or window mismatch)")
        return report

    # -- mark timeline on the TRACE clock (dump marks preferred; host
    #    marks mapped through the anchor otherwise)
    mark_ts: list[tuple[float, Mark]] = []
    for m in marks:
        rec = dump.dump_marks.get(m.seq)
        if rec is not None:
            mark_ts.append((rec["ts"], m))
        elif report.anchor_offset_s is not None:
            mark_ts.append(((m.t0 - report.anchor_offset_s) * 1e6, m))
    for seq, rec in dump.dump_marks.items():  # dump-only marks still count
        if seq not in by_seq:
            m = Mark(seq, rec.get("kernel", "?"), rec.get("cid"),
                     rec.get("lane"), 0.0)
            by_seq[seq] = m
            mark_ts.append((rec["ts"], m))
    mark_ts.sort(key=lambda p: p[0])
    by_kernel_ts: dict[str, list[tuple[float, Mark]]] = {}
    for ts, m in mark_ts:
        by_kernel_ts.setdefault(m.kernel, []).append((ts, m))

    def latest_at_or_before(seq_list: list[tuple[float, Mark]],
                            ts: float,
                            fallback_first: bool = False) -> Mark | None:
        """The newest mark dispatched at or before ``ts``.  With
        ``fallback_first`` (the kernel-NAME tier, where the name already
        proved the match and time only picks among same-kernel marks)
        an op preceding every mark takes the first one; the stream-order
        tier must NOT fall back — an op before the first mark was
        dispatched by something unmarked and stays unattributed, or
        coverage_frac could never read below 1.0."""
        best = None
        for mts, m in seq_list:
            if mts <= ts:
                best = m
            else:
                break
        if best is None and fallback_first and seq_list:
            return seq_list[0][1]
        return best

    # -- attribution tiers
    attributed: list[DeviceOp] = []
    for o in ops:
        seq = _explicit_seq(o)
        if seq is not None and seq in by_seq:
            m = by_seq[seq]
            attributed.append(o._replace(
                kernel=m.kernel, seq=seq, cid=m.cid, lane=m.lane,
                matched_by="explicit"))
            continue
        low = o.name.lower()
        hit = None
        # longest kernel name first: an op named "fusion.add_fused.3"
        # must attach to "add_fused", never to a kernel "add" that
        # happened to be marked earlier (substring ambiguity)
        for kernel, seq_list in sorted(
                by_kernel_ts.items(), key=lambda kv: -len(kv[0])):
            if kernel != "?" and kernel.lower() in low:
                hit = latest_at_or_before(seq_list, o.ts,
                                          fallback_first=True)
                if hit is not None:
                    break
        if hit is not None:
            attributed.append(o._replace(
                kernel=hit.kernel, seq=hit.seq, cid=hit.cid,
                lane=hit.lane, matched_by="kernel-name"))
            continue
        m = latest_at_or_before(mark_ts, o.ts)
        if m is not None:
            attributed.append(o._replace(
                kernel=m.kernel, seq=m.seq, cid=m.cid, lane=m.lane,
                matched_by="stream-order"))
        else:
            attributed.append(o)  # unattributed: kernel stays "?"

    # -- reductions: per-track unions so busy never exceeds the wall
    #    per track; per-kernel and per-lane sums over tracks
    all_by_track: dict[tuple[int, int], list] = {}
    for o in attributed:
        all_by_track.setdefault((o.pid, o.tid), []).append(
            (o.ts, o.ts + o.dur))
    report.device_busy_ms = sum(
        _union_us(v) for v in all_by_track.values()) / 1000.0
    lo = min(o.ts for o in attributed)
    hi = max(o.ts + o.dur for o in attributed)
    report.device_span_ms = (hi - lo) / 1000.0

    profiles: dict[str, KernelDeviceProfile] = {}
    lane_tracks: dict[Any, dict[tuple[int, int], list]] = {}
    for o in attributed:
        if o.kernel == "?":
            continue
        p = profiles.setdefault(o.kernel, KernelDeviceProfile(o.kernel))
        p.op_count += 1
        p.matched_by[o.matched_by] = p.matched_by.get(o.matched_by, 0) + 1
        if o.cid is not None and o.cid not in p.cids:
            p.cids.append(o.cid)
        lane_tracks.setdefault(o.lane, {}).setdefault(
            (o.pid, o.tid), []).append((o.ts, o.ts + o.dur))
    # per-kernel busy/idle from per-(kernel, track) unions
    kt: dict[tuple[str, int, int], list] = {}
    for o in attributed:
        if o.kernel == "?":
            continue
        kt.setdefault((o.kernel, o.pid, o.tid), []).append(
            (o.ts, o.ts + o.dur))
    for (kernel, _pid, _tid), iv in kt.items():
        busy = _union_us(iv)
        span = max(e for _s, e in iv) - min(s for s, _e in iv)
        p = profiles[kernel]
        p.device_ms += busy / 1000.0
        p.idle_ms += max(span - busy, 0.0) / 1000.0
    for kernel, p in profiles.items():
        seqs = {o.seq for o in attributed
                if o.kernel == kernel and o.seq is not None}
        host_launches = sum(1 for m in marks if m.kernel == kernel)
        p.launches = len(seqs) or host_launches
    for lane, tr in lane_tracks.items():
        busy_ms = sum(_union_us(v) for v in tr.values()) / 1000.0
        # per-kernel per-lane busy: union per (kernel, lane, track)
        klt: dict[tuple[str, int, int], list] = {}
        for o in attributed:
            if o.lane == lane and o.kernel != "?":
                klt.setdefault((o.kernel, o.pid, o.tid), []).append(
                    (o.ts, o.ts + o.dur))
        for (kernel, _pid, _tid), iv in klt.items():
            profiles[kernel].per_lane_ms[lane] = \
                profiles[kernel].per_lane_ms.get(lane, 0.0) \
                + _union_us(iv) / 1000.0
        denom = report.wall_ms or report.device_span_ms
        report.per_lane_overlap[lane] = (
            busy_ms / denom if denom > 0 else 0.0)

    report.kernels = list(profiles.values())
    report.ops = attributed
    report.attributed_ms = sum(p.device_ms for p in profiles.values())
    report.unattributed_ms = max(
        report.device_busy_ms - report.attributed_ms, 0.0)
    for o in attributed:
        if o.matched_by:
            report.matched_by[o.matched_by] = \
                report.matched_by.get(o.matched_by, 0) + 1
    return report


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

def roofline_row(
    flops: float,
    bytes_moved: float,
    device_ms: float,
    peak_tflops: float | None = None,
    peak_gbps: float | None = None,
    device_kind: str | None = None,
) -> dict:
    """Place one kernel on the machine roofline (Williams et al., 2009).

    ``flops``/``bytes_moved`` are the workload's analytic counts (the
    same numbers the bench's MFU rows use), ``device_ms`` the measured
    device-busy time.  Peaks default from :func:`hardware.device_peaks`
    for the current rig's device kind (``device_kind`` names one
    explicitly; ``peak_tflops``/``peak_gbps`` override outright) — an
    MFU is never silently scaled to another card's peaks.
    Returns intensity (flop/byte), attained Tflop/s and GB/s, the roof
    at this intensity, MFU vs the compute peak, the fraction of the
    (possibly memory-slanted) roof attained, and which side of the
    ridge the kernel sits on."""
    peak_kind = device_kind
    if peak_tflops is None or peak_gbps is None:
        from ..hardware import device_peaks

        tf, gb, peak_kind = device_peaks(device_kind)
        peak_tflops = tf if peak_tflops is None else peak_tflops
        peak_gbps = gb if peak_gbps is None else peak_gbps
    device_s = max(device_ms, 1e-9) / 1e3
    intensity = flops / max(bytes_moved, 1e-9)
    attained_tflops = flops / device_s / 1e12
    attained_gbps = bytes_moved / device_s / 1e9
    ridge = peak_tflops * 1e12 / (peak_gbps * 1e9)  # flop/byte
    roof_tflops = min(peak_tflops, intensity * peak_gbps * 1e9 / 1e12)
    return {
        "peak_kind": peak_kind or "override",
        "flops": flops,
        "bytes": bytes_moved,
        "device_ms": round(device_ms, 3),
        "intensity_flop_per_byte": round(intensity, 3),
        "ridge_flop_per_byte": round(ridge, 3),
        "bound": "compute" if intensity >= ridge else "memory",
        "attained_tflops": round(attained_tflops, 3),
        "attained_gbps": round(attained_gbps, 3),
        "peak_tflops": peak_tflops,
        "peak_gbps": peak_gbps,
        "roof_tflops": round(roof_tflops, 3),
        "mfu": round(attained_tflops / peak_tflops, 4),
        "frac_of_roof": round(attained_tflops / max(roof_tflops, 1e-12), 4),
    }


# ---------------------------------------------------------------------------
# unified Perfetto export
# ---------------------------------------------------------------------------

#: pid of the first device process in the unified export (host spans
#: keep pid 1, the export.py convention).
_DEVICE_PID0 = 100


def unified_chrome_trace(
    spans: Sequence[Span],
    report: DeviceWindowReport | None,
    ops: Sequence[DeviceOp] | None = None,
    marks: Sequence[Mark] = (),
    counters: dict | None = None,
    process_name: str = "cekirdekler_tpu_torch",
    req_events: Sequence = (),
) -> dict:
    """Host spans + device ops on ONE timeline.

    Host spans ride the standard export (pid 1, one thread per lane);
    each device becomes its own process (``device:<name>``) whose
    threads are LANES (`lane N (device)`) so a lane's host track and
    its device track sit side by side.  Device ops map onto the host
    ``perf_counter`` axis through the report's clock anchor
    (mark pairs, else capture start); with no anchor the device ops are
    exported against their own origin and the trace says so
    (``args.anchor: null`` on the metadata).  Marks replay as
    zero-cost ``device-mark`` instants so the dispatch edge is visible
    beside the ops it explains.  ``req_events`` (``obs/reqtrace.py``
    events) merge as per-request tracks (cat ``ck-req``, one thread per
    rid), which ``split_unified_trace`` leaves out.  It reads the
    merged schema back — the round trip is pinned by test."""
    from .export import to_chrome_trace

    spans = list(spans)
    ops = list(ops if ops is not None else [])
    offset_s = report.anchor_offset_s if report is not None else None
    anchor = report.anchor if report is not None else None

    def op_t0_s(o: DeviceOp) -> float:
        return o.ts * 1e-6 + (offset_s or 0.0)

    candidates = [s.t0 for s in spans] + [m.t0 for m in marks if m.t0]
    if offset_s is not None:
        candidates += [op_t0_s(o) for o in ops]
    elif ops:
        candidates += [o.ts * 1e-6 for o in ops]
    for series in (counters or {}).values():
        if series:
            candidates.append(series[0][0])
    t_base = min(candidates, default=0.0)

    doc = to_chrome_trace(spans, process_name=process_name,
                          counters=counters, t_base=t_base)
    events = doc["traceEvents"]
    dev_pids: dict[str, int] = {}
    dev_tids: dict[tuple[int, Any], int] = {}
    for o in ops:
        pid = dev_pids.get(o.device)
        if pid is None:
            pid = _DEVICE_PID0 + len(dev_pids)
            dev_pids[o.device] = pid
            events.append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": f"device:{o.device}", "anchor": anchor},
            })
        tkey = (pid, o.lane)
        tid = dev_tids.get(tkey)
        if tid is None:
            tid = 0 if o.lane is None else int(o.lane) + 1
            dev_tids[tkey] = tid
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": (
                    f"lane {o.lane} (device)" if o.lane is not None
                    else "device (no lane)")},
            })
        args: dict = {"op": o.name, "kind": "device-op"}
        if o.kernel != "?":
            args["kernel"] = o.kernel
        if o.seq is not None:
            args["ck-seq"] = o.seq
        if o.cid is not None:
            args["cid"] = o.cid
        if o.matched_by:
            args["matched_by"] = o.matched_by
        events.append({
            "ph": "X",
            "name": o.kernel if o.kernel != "?" else o.name,
            "cat": "ck-dev",
            "pid": pid,
            "tid": tid,
            "ts": (o.ts * 1e-6 + (offset_s or 0.0) - t_base) * 1e6,
            "dur": o.dur,
            "args": args,
        })
    for m in marks:
        if not m.t0:
            continue
        events.append({
            "ph": "i", "s": "p",   # process-scoped instant
            "name": "device-mark", "cat": "ck-dev",
            "pid": 1, "tid": 0 if m.lane is None else int(m.lane) + 1,
            "ts": (m.t0 - t_base) * 1e6,
            "args": {"kernel": m.kernel, "ck-seq": m.seq, "cid": m.cid,
                     "kind": "device-mark"},
        })
    if req_events:
        from ..obs.reqtrace import request_chrome_events
        events.extend(request_chrome_events(req_events))
    return doc


def split_unified_trace(trace: dict) -> tuple[list[Span], list[DeviceOp]]:
    """Inverse of :func:`unified_chrome_trace`: recover the host spans
    and the device ops (both on the unified relative clock — seconds
    for spans, microseconds for op ``ts``, the native unit each side's
    consumers expect)."""
    from .export import from_chrome_trace

    dev_pids: dict[int, str] = {}
    for e in trace.get("traceEvents", ()):
        if e.get("ph") == "M" and e.get("name") == "process_name":
            name = e.get("args", {}).get("name", "")
            if name.startswith("device:") or "/device:" in name:
                dev_pids[e["pid"]] = name.split("device:", 1)[-1]
    host_events = [
        e for e in trace.get("traceEvents", ())
        if e.get("pid") not in dev_pids and e.get("ph") == "X"
        and e.get("cat") != "ck-req"   # request-lifecycle tracks are not spans
    ]
    spans = from_chrome_trace({"traceEvents": host_events})
    ops: list[DeviceOp] = []
    for e in trace.get("traceEvents", ()):
        if e.get("ph") != "X" or e.get("pid") not in dev_pids:
            continue
        args = e.get("args", {}) or {}
        tid = int(e.get("tid", 0))
        ops.append(DeviceOp(
            device=dev_pids[e["pid"]], pid=int(e["pid"]), tid=tid,
            name=str(args.get("op", e.get("name", "?"))),
            ts=float(e.get("ts", 0.0)), dur=float(e.get("dur", 0.0)),
            args=args,
            kernel=str(args.get("kernel", "?")),
            seq=args.get("ck-seq"),
            cid=args.get("cid"),
            lane=None if tid == 0 else tid - 1,
            matched_by=args.get("matched_by"),
        ))
    ops.sort(key=lambda o: o.ts)
    return spans, ops


# ---------------------------------------------------------------------------
# the capture wrapper
# ---------------------------------------------------------------------------

#: Most recent completed capture's report — what ``/profilez`` serves.
_LAST_REPORT: DeviceWindowReport | None = None
_LAST_LOCK = threading.Lock()


def last_report() -> DeviceWindowReport | None:
    with _LAST_LOCK:
        return _LAST_REPORT


def _set_last_report(rep: DeviceWindowReport) -> None:
    global _LAST_REPORT
    with _LAST_LOCK:
        _LAST_REPORT = rep


class DeviceCapture:
    """One traced window: profiler + marks around a region, parsed and
    correlated on exit.

    ::

        cap = DeviceCapture("/tmp/ck_dev_trace")
        with cap:
            ...launch-annotated framework work...
        print(cap.report.table())        # named absence without a card

    On a CUDA device the window opens with ``tools/trace_window``'s lead
    kernels (launched and waited for before the host window starts); their
    records are left out of the report and counted in ``report.leads``.
    Lifecycle events ride the flight recorder (``profiler-start`` /
    ``profiler-stop``) and the ``ck_profile_captures_total`` counter, so a
    postmortem shows whether a crash happened under capture.  A profiler
    that cannot start degrades the report to a named absence; the region
    always runs."""

    def __init__(self, trace_dir: str, marks: DeviceMarks | None = None):
        self.trace_dir = trace_dir
        self.marks = marks if marks is not None else MARKS
        self.report: DeviceWindowReport = DeviceWindowReport(
            absent="capture never ran")
        self.profiler_ok = False
        self._handle = None
        self._t0 = 0.0
        self._marks_were_enabled = False
        self._leads = 0

    def __enter__(self) -> "DeviceCapture":
        from ..metrics.registry import REGISTRY
        from ..obs.flight import FLIGHT

        from ..utils import timeline

        REGISTRY.counter(
            "ck_profile_captures_total",
            "device-timeline captures attempted").inc()
        self._marks_were_enabled = self.marks.enabled
        self.marks.enable(clear=not self._marks_were_enabled)
        self._handle, err = timeline.start_profiler(self.trace_dir)
        self.profiler_ok = self._handle is not None
        self._start_err = err
        if self.profiler_ok and self._handle.cuda:
            from ..tools.trace_window import LEADS, open_window

            open_window()
            self._leads = LEADS
        FLIGHT.event("profiler-start", dir=self.trace_dir,
                     ok=self.profiler_ok)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        from ..metrics.registry import REGISTRY
        from ..obs.flight import FLIGHT

        from ..tools.trace_window import LEAD_KERNEL
        from ..utils import timeline

        t1 = time.perf_counter()
        if self._handle is not None:
            timeline.stop_profiler(self._handle)
        FLIGHT.event("profiler-stop", dir=self.trace_dir,
                     wall_ms=round((t1 - self._t0) * 1e3, 3))
        window_marks = [m for m in self.marks.snapshot()
                        if m.t1 >= self._t0 and m.t0 <= t1]
        if not self._marks_were_enabled:
            self.marks.disable()
        if exc_type is not None:
            # the region failed — the caller's exception outranks the
            # analysis; leave a named absence instead of half a report
            self.report = DeviceWindowReport(
                absent=f"window raised {exc_type.__name__} — not analyzed")
            _set_last_report(self.report)
            return
        if not self.profiler_ok:
            self.report = DeviceWindowReport(
                wall_ms=(t1 - self._t0) * 1e3,
                absent=f"profiler unavailable: {self._start_err}")
            self.report.n_marks = len(window_marks)
            _set_last_report(self.report)
            return
        try:
            dump = parse_trace_dump(self.trace_dir, lead_kernel=LEAD_KERNEL)
            self.report = correlate(
                dump, window_marks, window=(self._t0, t1),
                capture_anchor=(
                    (self._t0, min((e.ts for e in dump.ops), default=0.0))
                    if dump.ops else None),
            )
            self.report.links = dict(dump.links)
            if self._leads:
                self.report.leads = {"launched": self._leads,
                                     "records": dump.lead_records}
        except Exception as e:  # noqa: BLE001 - analysis must not raise
            self.report = DeviceWindowReport(
                wall_ms=(t1 - self._t0) * 1e3,
                absent=f"trace analysis failed: {type(e).__name__}: {e}")
        REGISTRY.counter(
            "ck_profile_device_ops_total",
            "device ops parsed from capture dumps").inc(self.report.n_ops)
        _set_last_report(self.report)


@contextmanager
def capture_device(trace_dir: str):
    """Functional form of :class:`DeviceCapture`::

        with capture_device("/tmp/t") as cap:
            ...work...
        cap.report  # DeviceWindowReport (named absence without a card)
    """
    cap = DeviceCapture(trace_dir)
    with cap:
        yield cap


# ---------------------------------------------------------------------------
# the persistent kernel-profile store
# ---------------------------------------------------------------------------

class ProfileStore:
    """On-disk kernel-profile evidence base, keyed by
    ``(kernel signature, shape, blocks)``.

    One append-only ``.jsonl`` file per key under ``root`` (or the
    ``CK_PROFILE_STORE`` directory; with neither, the store is DISABLED
    and every write returns None — a bench on a scratch rig must not
    litter).  Rows are ``json_safe`` dicts tagged with the schema and a
    wall-clock timestamp; readers skip unparseable lines (a torn tail
    from a crashed writer loses one row, never the file).  This is the
    store a block-shape autotuner reads: ``best()``
    returns the lowest-``device_ms`` row for a key, ``history()`` the
    full trajectory."""

    def __init__(self, root: str | None = None):
        self.root = root if root is not None else \
            os.environ.get(PROFILE_STORE_ENV) or None
        self._mu = threading.Lock()

    @property
    def enabled(self) -> bool:
        return bool(self.root)

    @staticmethod
    def _slug(kernel_sig: str, shape, blocks) -> str:
        raw = f"{kernel_sig}|{shape}|{blocks}"
        safe = "".join(
            c if c.isalnum() or c in "._+-" else "_" for c in kernel_sig
        )[:48]
        return (f"{safe}__"
                f"{hashlib.sha256(raw.encode()).hexdigest()[:12]}.jsonl")

    def path_for(self, kernel_sig: str, shape, blocks) -> str | None:
        if not self.root:
            return None
        return os.path.join(self.root, self._slug(kernel_sig, shape, blocks))

    def put(self, kernel_sig: str, shape, blocks, row: dict) -> str | None:
        """Append one profile row; returns the path, or None when the
        store is disabled.  The append is a single ``write()`` of one
        line, serialized under the store lock within this process."""
        path = self.path_for(kernel_sig, shape, blocks)
        if path is None:
            return None
        from ..metrics.registry import REGISTRY
        from ..utils.jsonsafe import json_safe

        doc = {
            "schema": STORE_SCHEMA,
            "kernel_sig": kernel_sig,
            "shape": list(shape) if isinstance(shape, (tuple, list))
            else shape,
            "blocks": list(blocks) if isinstance(blocks, (tuple, list))
            else blocks,
            "wrote_at": time.time(),
            **row,
        }
        line = json.dumps(json_safe(doc), allow_nan=False) + "\n"
        with self._mu:
            os.makedirs(self.root, exist_ok=True)
            with open(path, "a") as f:
                f.write(line)
        REGISTRY.counter(
            "ck_profile_store_writes_total",
            "kernel-profile rows persisted").inc()
        return path

    @staticmethod
    def _read_rows(path: str | None) -> list[dict]:
        """Parsed rows of one key file, torn/blank lines skipped — the
        ONE jsonl reader (history by key, the CLI's read by filename)."""
        if path is None or not os.path.exists(path):
            return []
        rows: list[dict] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rows.append(json.loads(line))
                except json.JSONDecodeError:
                    continue  # torn tail line: skip, never raise
        return rows

    def history(self, kernel_sig: str, shape, blocks) -> list[dict]:
        return self._read_rows(self.path_for(kernel_sig, shape, blocks))

    def read_key(self, filename: str) -> list[dict]:
        """Rows of one key FILE (a ``keys()`` entry) — the store-wide
        enumeration path (``tools/kernel_profile.py --show-store``)."""
        if not self.root:
            return []
        return self._read_rows(os.path.join(self.root, filename))

    def get(self, kernel_sig: str, shape, blocks) -> dict | None:
        """The newest row for the key, or None."""
        rows = self.history(kernel_sig, shape, blocks)
        return rows[-1] if rows else None

    @staticmethod
    def best_row(rows: list[dict], metric: str = "device_ms") -> dict | None:
        """The lowest-``metric`` row (ties to newest), or None when no
        row carries a numeric ``metric``."""
        rows = [r for r in rows
                if isinstance(r.get(metric), (int, float))
                and not isinstance(r.get(metric), bool)]
        if not rows:
            return None
        return min(reversed(rows), key=lambda r: r[metric])

    def best(self, kernel_sig: str, shape, blocks,
             metric: str = "device_ms") -> dict | None:
        """The lowest-``metric`` row for the key (ties to newest)."""
        return self.best_row(self.history(kernel_sig, shape, blocks), metric)

    def keys(self) -> list[str]:
        """Key files present in the store (filenames, sorted)."""
        if not self.root or not os.path.isdir(self.root):
            return []
        return sorted(
            fn for fn in os.listdir(self.root) if fn.endswith(".jsonl"))

    def best_blocks(self, kernel_sig: str, shape,
                    metric: str = "device_ms") -> tuple[int, int] | None:
        """The block pair of the lowest-``metric`` row across ALL key
        files matching ``(kernel_sig, shape)`` — the autotuner's
        consumer API (``core/blocktuner.py`` seeds its warm start
        here).  Block keys are per-(sig, shape, blocks) files, so this
        scans every key file, filters by signature + shape, and
        returns the winning row's ``blocks`` as an int 2-tuple (None
        when no matching row has a usable pair)."""
        want_shape = list(shape) if isinstance(shape, (tuple, list)) \
            else shape
        rows: list[dict] = []
        for fn in self.keys():
            for r in self.read_key(fn):
                if r.get("kernel_sig") != kernel_sig:
                    break  # one key file == one (sig, shape, blocks)
                if r.get("shape") != want_shape:
                    break
                rows.append(r)
        best = self.best_row(rows, metric)
        if best is None:
            return None
        blocks = best.get("blocks")
        if not isinstance(blocks, (list, tuple)) or len(blocks) < 2:
            return None
        try:
            return int(blocks[0]), int(blocks[1])
        except (TypeError, ValueError):
            return None


#: The default store (``CK_PROFILE_STORE``-armed; disabled otherwise).
STORE = ProfileStore()


# ---------------------------------------------------------------------------
# /profilez
# ---------------------------------------------------------------------------

def profilez_payload(store: ProfileStore | None = None) -> dict:
    """What the debug server's ``/profilez`` endpoint serves: the last
    capture's reconciled report (or its named absence), mark-plane
    state, and the persistent store's index."""
    st = store if store is not None else STORE
    rep = last_report()
    return {
        "last_capture": rep.to_dict() if rep is not None else None,
        "marks": {
            "enabled": MARKS.enabled,
            "recorded": MARKS.total_recorded,
        },
        "store": {
            "enabled": st.enabled,
            "root": st.root,
            "keys": st.keys(),
        },
    }
