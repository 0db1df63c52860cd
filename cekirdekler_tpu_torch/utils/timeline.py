"""Device-timeline capture and analysis over ``torch.profiler``.

Counterpart of ``cekirdekler_tpu/utils/timeline.py``, which captures a
``jax.profiler`` trace directory and reads its "XLA Ops" tracks.  Here a
capture is a ``torch.profiler.profile`` window whose chrome trace is
exported as ``*.pt.trace.json`` into the capture's directory, and the
device track is the CUDA kernel records (``cat: "kernel"``) of each
device process, stream by stream.  Capture a region, then answer "how
busy was the card, and how much of the wall did its kernels cover?" from
the device-side records instead of host stopwatches.

On a machine without a CUDA device the trace holds host events only.
The timeline then says so (:attr:`DeviceTimeline.absent`); it never
counts host ops as device time.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field

__all__ = [
    "DeviceTimeline", "Tracer", "capture", "analyze_trace_dir",
    "load_trace_events", "start_profiler", "stop_profiler",
    "DEVICE_CATS", "device_pids",
]

#: Chrome-trace categories of device-side records in a ``torch.profiler``
#: export: kernels, copies and sets, and the device-side mirror of a
#: ``record_function`` range.  A process carrying any of them is a device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")

#: The compute track: a device process's kernel records.
KERNEL_CAT = "kernel"

_NO_DEVICE = ("no CUDA kernel records in the trace (a run without a CUDA "
              "device: the profiler has no device track)")


@dataclass
class DeviceTimeline:
    """Busy/span statistics of one captured region, from device events."""

    compute_busy_ms: float = 0.0      # union of kernel intervals per device
    span_ms: float = 0.0              # first kernel start → last kernel end
    n_events: int = 0
    n_devices: int = 0
    per_device_busy_ms: dict = field(default_factory=dict)
    trace_path: str | None = None
    #: why the timeline holds no device time (None when it does)
    absent: str | None = None

    @property
    def compute_busy_fraction(self) -> float:
        """Fraction of the device-event makespan covered by kernels — the
        timeline-derived overlap evidence (1.0 = transfers fully hidden
        behind compute; small = the card sat idle between kernels)."""
        return self.compute_busy_ms / self.span_ms if self.span_ms > 0 else 0.0


def _merged_busy(intervals: list[tuple[float, float]]) -> float:
    """Total length of the union of (start, end) intervals (µs)."""
    if not intervals:
        return 0.0
    intervals.sort()
    total = 0.0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s)


def load_trace_events(trace_dir: str) -> tuple[str | None, list]:
    """(path, traceEvents) of the newest trace-event dump under
    ``trace_dir``: the chrome trace a ``torch.profiler`` window exports
    (``*.pt.trace.json``), plain or gzipped (any ``*.trace.json`` or
    ``*.trace.json.gz``).  Returns ``(None, [])`` when the directory holds
    no dump or the newest one does not parse — callers degrade to an
    empty analysis, never raise."""
    files = glob.glob(
        os.path.join(trace_dir, "**", "*.trace.json.gz"), recursive=True
    ) + glob.glob(
        os.path.join(trace_dir, "**", "*.trace.json"), recursive=True
    )
    if not files:
        return None, []
    path = max(files, key=os.path.getmtime)
    try:
        if path.endswith(".gz"):
            with gzip.open(path, "rt") as f:
                trace = json.load(f)
        else:
            with open(path) as f:
                trace = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError, EOFError):
        return None, []
    if isinstance(trace, list):
        return path, trace
    return path, trace.get("traceEvents", [])


def device_pids(events: list) -> dict:
    """``{pid: device name}`` of the processes that carry device records
    (:data:`DEVICE_CATS`), named ``GPU <pid>`` unless the trace's metadata
    labels them."""
    pids = {e.get("pid") for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS}
    names = {}
    for e in events:
        if e.get("ph") == "M" and e.get("pid") in pids and e.get("name") == "process_labels":
            label = (e.get("args") or {}).get("labels")
            if label:
                names[e["pid"]] = str(label)
    return {pid: names.get(pid, f"GPU {pid}") for pid in pids}


def analyze_trace_dir(trace_dir: str) -> DeviceTimeline:
    """Parse the newest trace dump under ``trace_dir`` and reduce each
    device's kernel records to busy/span statistics."""
    path, events = load_trace_events(trace_dir)
    if path is None:
        return DeviceTimeline(absent="no trace dump in the directory")
    devs = device_pids(events)
    per_dev: dict[str, list[tuple[float, float]]] = {}
    lo, hi, count = float("inf"), float("-inf"), 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != KERNEL_CAT or e.get("pid") not in devs:
            continue
        s = float(e.get("ts", 0.0))
        d = float(e.get("dur", 0.0))
        per_dev.setdefault(devs[e["pid"]], []).append((s, s + d))
        lo, hi = min(lo, s), max(hi, s + d)
        count += 1
    busy = {k: _merged_busy(v) / 1000.0 for k, v in per_dev.items()}
    return DeviceTimeline(
        compute_busy_ms=sum(busy.values()),
        span_ms=(hi - lo) / 1000.0 if count else 0.0,
        n_events=count,
        n_devices=len(per_dev),
        per_device_busy_ms=busy,
        trace_path=path,
        absent=None if count else _NO_DEVICE,
    )


class _Capture:
    """A running ``torch.profiler`` window and the directory its chrome
    trace goes to.  The window records the host events of every thread
    (the lanes launch from their own threads); CUDA records are the whole
    process's."""

    _seq = 0
    _seq_mu = threading.Lock()

    def __init__(self, trace_dir: str):
        import torch
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        self.trace_dir = trace_dir
        self.cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts,
                            experimental_config=_ExperimentalConfig(profile_all_threads=True))
        self.prof.__enter__()

    def stop(self) -> str:
        """Wait for the card's queued work, close the window and export its
        trace; returns the trace's path."""
        import torch

        try:
            if self.cuda:
                torch.cuda.synchronize()
        finally:
            self.prof.__exit__(None, None, None)
        with _Capture._seq_mu:
            _Capture._seq += 1
            seq = _Capture._seq
        os.makedirs(self.trace_dir, exist_ok=True)
        path = os.path.join(self.trace_dir, f"ck.{os.getpid()}.{seq}.pt.trace.json")
        self.prof.export_chrome_trace(path)
        return path


def start_profiler(trace_dir: str):
    """Start a ``torch.profiler`` window whose trace goes to
    ``trace_dir`` — the capture seam ``trace/device.py`` builds on.
    Returns ``(handle, None)`` on success or ``(None, reason)`` when
    profiling is unavailable (the region should still run; degrade to a
    named absence)."""
    try:
        return _Capture(trace_dir), None
    except Exception as e:  # noqa: BLE001 - unavailability is a reason
        return None, f"{type(e).__name__}: {e}"


def stop_profiler(handle) -> None:
    """Stop a window started by :func:`start_profiler` and export its
    trace (best-effort: a teardown failure never masks the region's own
    outcome)."""
    if handle is None:
        return
    try:
        handle.stop()
    except Exception:  # noqa: BLE001
        pass


@contextmanager
def capture(trace_dir: str):
    """Capture a device timeline around a region::

        with timeline.capture("/tmp/trace") as result:
            ...work...
        print(result().compute_busy_fraction)

    Yields a zero-arg callable returning the :class:`DeviceTimeline`
    (analyzed lazily, after the region closes).  If profiling is
    unavailable, the region still runs and the analysis is empty.
    Exceptions raised INSIDE the region propagate unchanged (profiler
    stopped best-effort) — only profiler-start failures are swallowed."""
    state: dict = {}
    prof, err = start_profiler(trace_dir)
    if prof is None:
        yield lambda: state.setdefault(
            "tl", DeviceTimeline(absent=f"profiler unavailable: {err}"))
        return
    try:
        yield lambda: state.setdefault("tl", analyze_trace_dir(trace_dir))
    finally:
        stop_profiler(prof)


class Tracer:
    """Reusable tracer: each ``region(name)`` captures into its own subdir
    and records the analyzed :class:`DeviceTimeline` under that name."""

    def __init__(self, base_dir: str):
        self.base_dir = base_dir
        self.regions: dict[str, DeviceTimeline] = {}

    @contextmanager
    def region(self, name: str):
        sub = os.path.join(self.base_dir, name)
        with capture(sub) as result:
            yield
        self.regions[name] = result()

    def report(self) -> str:
        lines = []
        for name, tl in self.regions.items():
            if tl.absent:
                lines.append(f"{name}: no device time ({tl.absent})")
                continue
            lines.append(
                f"{name}: busy {tl.compute_busy_ms:.3f} ms / span {tl.span_ms:.3f} ms "
                f"({100.0 * tl.compute_busy_fraction:.1f}% busy, {tl.n_events} events)"
            )
        return "\n".join(lines) or "(no regions captured)"
