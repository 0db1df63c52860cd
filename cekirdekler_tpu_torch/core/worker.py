"""Worker — one dispatch lane: a CUDA device on its own stream, or a
host-CPU lane.

Counterpart of ``cekirdekler_tpu/core/worker.py``: the lane owns a
full-size device buffer per array keyed ``id(arr)``, uploads its range
slice (or the whole array) by ``non_blocking`` copies from host memory
(page-locked for ``fast`` arrays), launches the kernel sequence over the
binary chunk ladder, downloads its range slice, and keeps per-compute-id
benches that feed the load balancer: the phase's wall, or on a GPU lane's
plain path the device span of its stream (:meth:`end_issue`).  Every
device operation of a CUDA lane runs on the lane's own
``torch.cuda.Stream``.

Enqueue mode (``Cores.enqueue_mode``) adds residency and deferred
transfers: an upload records the element range it covered
(:meth:`upload_covers`, reset by :meth:`reset_coverage` when ranges move),
and a deferred download is :meth:`download_async`, waited for by
:meth:`finish_download`.  A host lane then runs its enqueued work in
order on a thread of its own (:meth:`issue`), as a device stream does, so
a barrier's fence measures when the lane's work retired; on the plain
path a host lane runs inline, as before.

Fused windows (``core/cores.py``) queue their dispatch closures on a
driver (:meth:`dispatch_async`, drained by :meth:`drain_dispatch`): a GPU
lane's own driver thread, or a host lane's queue, behind the work that
lane queued before.  :meth:`launch_fused` runs a window's iterations and
:meth:`launch` a call's ``repeat_count`` repeats as one call of
``KernelProgram.fused_launcher``: on a GPU lane through its CUDA graphs
(``kernel/graphs.py``), on a host lane as a host loop.

Streamed partition transfers (``Cores._run_streamed``) add the chunk
primitives: :meth:`stage_upload_chunk` / :meth:`commit_upload` and
:meth:`download_chunk_async`, dispatched chunk by chunk through
:meth:`stream_dispatch_async` (a host lane's stream driver, drained by
:meth:`drain_stream_dispatch`; a GPU lane issues them on the caller's
thread).  A GPU lane copies on two copy streams beside its compute
stream, one each way, ordered by CUDA events: a chunk's kernels wait for
its H2D, its D2H waits for its last kernel.  An array whose host memory
is page-locked (a ``fast`` array) is copied directly; a pageable one goes
through a ring of page-locked staging slots, each reused only after the
copy that last used it has completed, and a D2H reaches the host array
at :meth:`finish_download`.  A host lane runs the chunks in order on its
queue.  Every device buffer a copy stream touches is recorded on that
stream (``record_stream``).  ``transfers`` counts an array's range once
per transfer, chunked or not; ``chunk_transfers`` counts the chunk copies.

The pipelined engines (``Cores._run_pipelined``) use the same copies per
blob: :meth:`stage_upload` / :meth:`commit_upload` (the reference's, with
:meth:`buffer` and :meth:`set_buffer`) and :meth:`download_async` given a
stream.  The EVENT engine copies on the two copy streams, ordered by CUDA
events; the DRIVER engine runs each blob's H2D, kernels and D2H in order
on one of the lane's :data:`PIPE_QUEUES` streams (:meth:`pipe_streams`),
made once.  A staging slot is reused only after its copy has completed,
as above.

The ladder (``step * 2^k`` chunks) stays for parity with the reference's
chunking: every launch geometry the balancer can produce is one of
O(log(range/step)) cached launch functions.

The reference's hooks, at its sites: each lane caches its metric handles
at construction (upload and download bytes, fence waits and seconds, the
drivers' depths, H2D and D2H chunks, the chosen chunk count); uploads,
downloads, their chunks and launches record spans, host-time spans of
issue on a GPU lane; a driver closure's failure records a flight event, a
span and a counter; ``driver-submit`` fires at a driver's submit and
preflight (and at a GPU lane's inline chunk dispatch, its submit), and
``slow-link`` scales a transfer's issue time.  :meth:`fence_cid` is the
per-compute-id completion probe of ``Cores.fence_split``: a GPU lane waits
on a CUDA event recorded after the compute id's last launch, a host lane
for the compute id's queued work (:meth:`mark_cid`).

Queue markers (``NumberCruncher.fine_grained_queue_control``): while
:attr:`Worker.markers` holds a ``MarkerCounter``, every transfer and
launch adds markers, as the reference's sites do.  An upload, a staged
upload, a plain-path download and a launch add theirs once issued, and
reach them when the work retires: on a GPU lane at a CUDA event recorded
behind it on the stream that carried it, on a host lane at once (the
work ran on the calling thread).  A launch adds one marker per launcher
call (a fused ladder or a CUDA-graph replay is one); a fused window's
launch adds one.  A deferred download (:meth:`download_async`,
:meth:`download_chunk_async`) adds its marker when issued and its handle
reaches it when :meth:`finish_download` has landed it, a failed copy
included.  :attr:`markers_by_site` counts the markers by site.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import Counter
from concurrent.futures import Future, ThreadPoolExecutor
from contextlib import nullcontext
from typing import Any, Callable, Sequence

import torch

from ..arrays.clarray import ClArray
from ..kernel.graphs import LaneGraphs, buffers_key
from ..kernel.registry import KernelProgram
from ..metrics.registry import REGISTRY
from ..obs.flight import FLIGHT
from ..trace.device import MARKS
from ..trace.spans import TRACER
from ..utils.faultinject import FAULTS
from ..utils.markers import MarkerCounter

__all__ = ["PIPE_QUEUES", "Worker", "launch_ladder"]

#: the DRIVER engine's streams on a GPU lane: blob k runs on stream k mod 16
PIPE_QUEUES = 16


def _ladder(size: int, step: int) -> list[int]:
    """Decompose ``size`` (a multiple of ``step``) into descending
    ``step * 2^k`` chunks."""
    out: list[int] = []
    units = size // step
    bit = 1 << (units.bit_length() - 1) if units else 0
    while units:
        if bit <= units:
            out.append(bit * step)
            units -= bit
        bit >>= 1
    return out


def launch_ladder(size: int, step: int) -> list[int]:
    """The one decomposition every launch geometry's user shares: the
    per-call dispatch (:meth:`Worker.launch`), the launchers a phase builds
    before it is timed (``Cores._build_launchers``), the streamed chunk
    planner (``core/stream.chunk_plan``) and the compile cache's key and
    warmup (``core/compilecache``).  A second decomposition would warm keys
    the live path never asks for."""
    return _ladder(size, step)


def _host_tensor(arr: ClArray) -> torch.Tensor:
    """Zero-copy torch view of the array's host storage (page-locked when
    the array is a FastArr on a CUDA host)."""
    return torch.from_numpy(arr.host())


def _pinned(arr: ClArray) -> bool:
    """True when the array's host storage is page-locked (a ``fast`` array
    on a CUDA host): a copy from or to it needs no staging."""
    fast = getattr(arr, "_fast", None)
    return bool(fast is not None and getattr(fast, "pinned", False))


class _Slot:
    """One page-locked staging buffer of a lane's ring, with the event of
    the last copy that used it and, for a D2H, the handle whose host copy
    is still owed."""

    def __init__(self):
        self.buf: torch.Tensor | None = None
        self.event = None
        self.pending: "_Download | None" = None

    def view(self, nbytes: int) -> torch.Tensor:
        if self.buf is None or self.buf.numel() < nbytes:
            self.buf = torch.empty(max(nbytes, 1 << 16), dtype=torch.uint8, pin_memory=True)
        return self.buf[:nbytes]


class _Download:
    """A chunk's or a pipelined blob's D2H in flight: on a GPU lane its
    completion event and, when it went through a staging slot, the host
    copy :meth:`Worker.finish_download` still owes; on a host lane the
    future of the copy queued on the lane (None: it ran inline).  Its span
    (``kind``) covers the wait, as the reference's covers the
    materialization."""

    def __init__(self, event, slot: _Slot | None = None, src: torch.Tensor | None = None,
                 dst: torch.Tensor | None = None, lane: int | None = None,
                 tag: str | None = None, fut: Future | None = None,
                 kind: str = "download-chunk"):
        self.event = event
        self.kind = kind
        self.slot = slot
        self.src = src
        self.dst = dst
        self.lane = lane
        self.tag = tag
        self.fut = fut
        self.done = False
        # the lane's marker counter while its marker is owed (None after)
        self.markers: MarkerCounter | None = None

    def synchronize(self) -> None:
        """Wait until the device side of the copy has completed (no host
        copy): the handle's join as a marker completion."""
        if self.fut is not None:
            self.fut.exception()
        if self.event is not None:
            self.event.synchronize()

    def finish(self) -> None:
        if self.done:
            return
        _tt = TRACER.t0()
        try:
            if self.fut is not None:
                self.fut.result()
            if self.event is not None:
                self.event.synchronize()
            if self.slot is not None:
                self.dst.copy_(self.src)
                if self.slot.pending is self:
                    self.slot.pending = None
        finally:
            # landed, or failed: either way the copy has retired
            markers, self.markers = self.markers, None
            if markers is not None:
                markers.reach()
        self.done = True
        TRACER.record(self.kind, _tt, lane=self.lane, tag=self.tag)


class _Marked:
    """A :meth:`Worker.download_async` handle whose lane counts markers:
    :meth:`Worker.finish_download` finishes ``handle`` and then reaches
    the marker the download added."""

    __slots__ = ("handle", "markers")

    def __init__(self, handle, markers: MarkerCounter | None):
        self.handle = handle
        self.markers = markers


class _Ring:
    """A lane's page-locked staging slots for one direction, used in turn."""

    def __init__(self):
        self.slots: list[_Slot] = []
        self.turn = 0


_lane_thread = threading.local()


class _HostQueue:
    """A host lane's stream: work submitted here runs in order on one
    thread; :meth:`synchronize` waits for all of it and raises the first
    error, as a device fence surfaces a failed kernel."""

    def __init__(self, index: int):
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix=f"ck-host-lane-{index}")
        self._pending: list[Future] = []
        self._mu = threading.Lock()

    def submit(self, fn: Callable[[], Any]) -> Future:
        def run() -> Any:
            _lane_thread.queue = self
            return fn()

        with self._mu:
            fut = self._pool.submit(run)
            self._pending.append(fut)
        return fut

    def on_thread(self) -> bool:
        """True on this queue's own thread (inside work it runs)."""
        return getattr(_lane_thread, "queue", None) is self

    def synchronize(self) -> None:
        with self._mu:
            pending, self._pending = self._pending, []
        errors = [e for e in (f.exception() for f in pending) if e is not None]
        if errors:
            raise errors[0]

    def close(self) -> None:
        self._pool.shutdown(wait=True)


class _DriverQueue:
    """A lane's dispatch driver for fused windows (reference
    ``core/worker.py::_DriverQueue``): submitted closures run strictly in
    order, on a thread of its own (a GPU lane: one lane's host-side
    dispatch overlaps another lane's execution) or on a host lane's
    :class:`_HostQueue`, after the work queued there before.  ``depth``
    (given per :meth:`submit`) bounds the closures queued or running: a
    host that runs far ahead blocks in :meth:`submit`.  A closure's failure
    is held and raised at the next :meth:`preflight`, :meth:`submit` or
    :meth:`drain` (the window's sync point), and recorded when it happens
    (a ``driver-error`` flight event, span and counter).  An armed
    ``driver-submit`` fault fires at :meth:`preflight` and :meth:`submit`;
    an error from :meth:`preflight` carries ``_ck_clean_window`` (True for
    the injected fault: nothing was queued)."""

    def __init__(self, name: str, host_queue: _HostQueue | None = None,
                 lane: int | None = None, depth_gauge=None):
        self.name = name
        self.lane = lane
        self._depth_gauge = depth_gauge
        self._host_queue = host_queue
        self._cond = threading.Condition()
        self._errors: list[Exception] = []
        self._pending = 0
        self._thread: threading.Thread | None = None
        if host_queue is None:
            self._q: queue.Queue = queue.Queue()
            self._thread = threading.Thread(target=self._run, daemon=True, name=name)
            self._thread.start()

    def _raise_held(self) -> None:
        """Caller holds ``_cond``."""
        if self._errors:
            e = self._errors[0]
            self._errors.clear()
            raise e

    def preflight(self) -> None:
        """Fire the armed ``driver-submit`` fault and raise a held failure
        without queuing anything."""
        if FAULTS.enabled:
            try:
                FAULTS.raise_if_fired("driver-submit", lane=self.lane, where=self.name)
            except Exception as e:  # noqa: BLE001 - marker, re-raised
                e._ck_clean_window = True
                raise
        with self._cond:
            if self._errors:
                self._errors[0]._ck_clean_window = False
            self._raise_held()

    def _wait_below(self, n: int) -> None:
        """Caller holds ``_cond``: wait until fewer than ``n`` closures are
        pending (bounded waits: a dead driver thread raises, never hangs)."""
        while self._pending >= n:
            self._cond.wait(1.0)
            if (self._pending >= n and self._thread is not None
                    and not self._thread.is_alive()):
                raise RuntimeError(f"driver {self.name!r} thread died with "
                                   f"{self._pending} closure(s) pending")

    def submit(self, fn: Callable[[], None], depth: int = 2,
               preflighted: bool = False) -> None:
        if FAULTS.enabled and not preflighted:
            # a caller that ran preflight already fired the point once
            FAULTS.raise_if_fired("driver-submit", lane=self.lane, where=self.name)
        with self._cond:
            self._raise_held()
            self._wait_below(max(1, int(depth)))
            self._pending += 1
            if self._depth_gauge is not None:
                self._depth_gauge.set(self._pending)
        if self._host_queue is not None:
            self._host_queue.submit(lambda: self._execute(fn))
        else:
            self._q.put(fn)

    def _execute(self, fn: Callable[[], None]) -> None:
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - raised at the next drain
            with self._cond:
                self._errors.append(e)
            try:
                FLIGHT.event("driver-error", driver=self.name,
                             exc_type=type(e).__name__, exc=str(e)[:500])
                TRACER.instant("driver-error", tag=f"{self.name}: {e}")
                REGISTRY.counter("ck_driver_errors_total",
                                 "dispatch-driver closure failures").inc()
            except Exception:  # noqa: BLE001 - observing is optional
                pass
        finally:
            with self._cond:
                self._pending -= 1
                if self._depth_gauge is not None:
                    self._depth_gauge.set(self._pending)
                self._cond.notify_all()

    def _run(self) -> None:
        while True:
            fn = self._q.get()
            if fn is None:
                return
            self._execute(fn)

    def drain(self) -> None:
        """Block until every submitted closure has run, raising the first
        failure."""
        with self._cond:
            self._wait_below(1)
            self._raise_held()

    def close(self) -> None:
        if self._thread is not None:
            self._q.put(None)
            self._thread.join(timeout=5.0)


class Worker:
    """Per-lane execution engine."""

    def __init__(self, device: torch.device, index: int):
        self.device = device
        self.index = index
        # serializes whole lane phases of concurrent host threads
        self.lock = threading.RLock()
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        # the copy streams of streamed transfers, one each way (GPU lane)
        self.h2d_stream = torch.cuda.Stream(device) if self.stream is not None else None
        self.d2h_stream = torch.cuda.Stream(device) if self.stream is not None else None
        self._host_queue: _HostQueue | None = None
        self._driver: _DriverQueue | None = None
        self._stream_driver: _DriverQueue | None = None
        # page-locked staging rings for pageable arrays, one each way
        self._up_ring = _Ring()
        self._down_ring = _Ring()
        self._slot_mu = threading.Lock()
        self._pipe_streams: list | None = None
        self.graphs = LaneGraphs(device) if self.stream is not None else None
        self._buffers: dict[int, torch.Tensor] = {}
        self._buffer_owner: dict[int, ClArray] = {}  # strong refs, like the reference
        # array -> (offset, size) element range this lane has uploaded: enqueue
        # mode skips a re-upload only when the requested range is covered
        self._uploaded: dict[int, tuple[int, int]] = {}
        # bumped by every reset_coverage()
        self.coverage_epoch = 0
        self.benchmarks: dict[int, float] = {}
        self._bench_t0: dict[int, float] = {}
        # a GPU lane's device span of the open bench: start and end events
        self._bench_span: dict[int, list] = {}
        # set (by Cores, under the lane's lock) while host lanes of the
        # call wait for this GPU lane to issue its work
        self.issued: threading.Event | None = None
        # per-compute-id share of the enqueue flush's D2H drain, per
        # iteration (ms): the balancer's transfer floor
        self.transfer_benchmarks: dict[int, float] = {}
        # transfers issued, keyed ("h2d" | "d2h", array name): a range counts
        # once whether it moved whole or in chunks
        self.transfers: Counter = Counter()
        # the chunk copies of streamed transfers, keyed the same way
        self.chunk_transfers: Counter = Counter()
        # enqueued measuring runs of the transfer tuner on this GPU lane:
        # (timing events, key), read by Cores once the events complete
        self.pending_measures: list = []
        # the fence split's completion probes, recorded only while
        # Cores.fence_split is on: compute id -> a CUDA event after its
        # last launch (GPU lane), the future of a marker queued behind its
        # work (host lane), or True (its work ran inline)
        self.track_cid_outputs = False
        self._cid_last_out: dict[int, Any] = {}
        # queue markers (reference: ClCommandQueue.cs:99-115): None unless
        # the cruncher's fine_grained_queue_control set a counter, which it
        # toggles only under the lane's lock, with no phase in flight
        self.markers: MarkerCounter | None = None
        # markers added, by site ("h2d", "launch", "d2h"); a host lane's
        # queue thread and its caller add at once, so under _site_mu
        self.markers_by_site: Counter = Counter()
        self._site_mu = threading.Lock()
        # always-on metric handles, cached here: the lane label is static
        self._m_upload_bytes = REGISTRY.counter(
            "ck_upload_bytes_total", "H2D bytes uploaded", lane=index)
        self._m_download_bytes = REGISTRY.counter(
            "ck_download_bytes_total", "D2H bytes materialized", lane=index)
        self._m_fence_waits = REGISTRY.counter(
            "ck_fence_waits_total", "whole-lane retirement fences", lane=index)
        self._m_fence_seconds = REGISTRY.histogram(
            "ck_fence_seconds", "fence wait duration", lane=index)
        self._m_driver_depth = REGISTRY.gauge(
            "ck_driver_queue_depth", "fused-dispatch driver FIFO occupancy", lane=index)
        self._m_h2d_chunks = REGISTRY.counter(
            "ck_stream_chunks_total", "streamed transfer chunks", dir="h2d", lane=index)
        self._m_d2h_chunks = REGISTRY.counter(
            "ck_stream_chunks_total", "streamed transfer chunks", dir="d2h", lane=index)
        self._m_stream_depth = REGISTRY.gauge(
            "ck_stream_queue_depth", "streamed-transfer driver FIFO occupancy", lane=index)
        self.m_chunk_count = REGISTRY.gauge(
            "ck_stream_chunk_count", "autotuner-chosen chunk count", lane=index)

    def on_stream(self):
        """Context that makes this lane's stream current (no-op on host)."""
        return torch.cuda.stream(self.stream) if self.stream is not None else nullcontext()

    def _add_markers(self, site: str, n: int = 1) -> MarkerCounter | None:
        """Add ``n`` markers at ``site``; the lane's counter, or None when
        markers are off."""
        m = self.markers
        if m is not None:
            m.add(n)
            with self._site_mu:
                self.markers_by_site[site] += n
        return m

    def _mark(self, site: str, n: int = 1, stream=None, event=None) -> None:
        """Add ``n`` markers for work just issued and reach them when it
        retires: on a GPU lane at ``event`` (else one recorded now on
        ``stream``, the current stream when None), on a host lane at once."""
        m = self._add_markers(site, n)
        if m is None:
            return
        if self.stream is None:
            m.reach(n)
            return
        if event is None:
            event = torch.cuda.Event()
            event.record(stream if stream is not None else torch.cuda.current_stream(self.device))
        m.reach_when_ready(event, n)

    def _owe(self, handle: "_Download") -> "_Download":
        """Add one marker for a deferred download; ``handle`` reaches it."""
        handle.markers = self._add_markers("d2h")
        return handle

    def issue(self, fn: Callable[[], Any]) -> None:
        """Run ``fn`` on this lane's stream without waiting for its work:
        on a CUDA lane its launches queue on the lane's stream; a host lane
        queues ``fn`` itself on the lane's thread."""
        if self.stream is not None:
            with self.on_stream():
                fn()
            return
        self._queue().submit(fn)

    def _queue(self) -> _HostQueue:
        if self._host_queue is None:
            self._host_queue = _HostQueue(self.index)
        return self._host_queue

    # -- dispatch driver (fused windows) -------------------------------------
    def _driver_queue(self) -> _DriverQueue:
        if self._driver is None:
            self._driver = _DriverQueue(f"ck-driver-lane-{self.index}",
                                        None if self.stream is not None else self._queue(),
                                        lane=self.index, depth_gauge=self._m_driver_depth)
        return self._driver

    def dispatch_preflight(self) -> None:
        """Fire the armed ``driver-submit`` fault and raise a failure of an
        earlier dispatch closure, without queuing anything: a fused
        dispatch runs this on every lane before it queues a closure on
        any."""
        self._driver_queue().preflight()

    def dispatch_async(self, fn: Callable[[], None], depth: int = 2,
                       preflighted: bool = False) -> None:
        """Queue a dispatch closure on this lane's driver; a GPU lane runs
        it under the lane's lock, a host lane on its queue after the work
        queued there before.  At most ``depth`` closures are in flight."""
        if self.stream is not None:
            work = fn

            def fn() -> None:
                with self.lock:
                    work()

        self._driver_queue().submit(fn, depth, preflighted=preflighted)

    def drain_dispatch(self) -> None:
        """Wait until every queued dispatch closure has run, raising the
        first failure."""
        if self._driver is not None:
            self._driver.drain()

    # -- stream driver (streamed transfers) ----------------------------------
    def stream_preflight(self) -> None:
        """Fire the armed ``driver-submit`` fault and raise a failure of an
        earlier streamed-transfer closure without queuing anything (and
        without starting the driver)."""
        if self._stream_driver is not None:
            self._stream_driver.preflight()
            return
        if FAULTS.enabled:
            try:
                FAULTS.raise_if_fired("driver-submit", lane=self.index,
                                      where=f"stream:lane{self.index}")
            except Exception as e:  # noqa: BLE001 - marker, re-raised
                e._ck_clean_window = True
                raise

    def stream_dispatch_async(self, fn: Callable[[], None], depth: int = 2,
                              preflighted: bool = False) -> None:
        """Queue a streamed-transfer closure (commit + launch + D2H issue).
        A host lane queues it on its stream driver (a ``_DriverQueue`` on
        the lane's queue, after the work queued there before); ``depth``
        bounds how many chunks the caller may stage ahead of the dispatched
        one.  It is not the fused driver: these closures run while the
        submitter holds the lane's lock, so they never take it, and a fused
        closure queued ahead of them would deadlock the drain.  A GPU lane
        runs the closure here, with its compute stream current: what it
        issues is asynchronous on the lane's streams already, and a driver
        thread only adds a hand-off between two Python threads to every
        chunk (``tools/stream_chunks.py`` times both).  An armed
        ``driver-submit`` fault fires here on either lane, as at the
        reference's submit."""
        if self.stream is not None:
            if FAULTS.enabled and not preflighted:
                FAULTS.raise_if_fired("driver-submit", lane=self.index,
                                      where=f"stream:lane{self.index}")
            with self.on_stream():
                fn()
            return
        if self._stream_driver is None:
            self._stream_driver = _DriverQueue(f"ck-stream-lane-{self.index}", self._queue(),
                                               lane=self.index,
                                               depth_gauge=self._m_stream_depth)
        self._stream_driver.submit(fn, depth, preflighted=preflighted)

    def drain_stream_dispatch(self) -> None:
        """Wait until every streamed-transfer closure has run (host side;
        the device's completion is the fence's), raising the first
        failure."""
        if self._stream_driver is not None:
            self._stream_driver.drain()

    def begin_streamed(self) -> None:
        """Order the copy streams after the work already on the compute
        stream (a chunk's H2D must not overwrite a buffer an earlier kernel
        still reads)."""
        if self.stream is not None:
            self.h2d_stream.wait_stream(self.stream)
            self.d2h_stream.wait_stream(self.stream)

    def end_streamed(self) -> None:
        """Order the compute stream after every copy issued on the copy
        streams, so work queued on the lane later runs after them."""
        if self.stream is not None:
            self.stream.wait_stream(self.h2d_stream)
            self.stream.wait_stream(self.d2h_stream)

    #: staging slots a ring holds (``Cores`` sets its ``stream_queue_depth``)
    stream_depth = 2

    def _slot(self, ring: _Ring) -> _Slot:
        """The next slot of a staging ring (grown to ``stream_depth``
        slots), free for a new copy: the copy that last used it has
        completed, and a D2H's host copy has been made."""
        with self._slot_mu:
            k, ring.turn = ring.turn, ring.turn + 1
            if len(ring.slots) < max(1, self.stream_depth):
                ring.slots.append(_Slot())
                slot = ring.slots[-1]
            else:
                slot = ring.slots[k % len(ring.slots)]
        if slot.pending is not None:
            slot.pending.finish()
        if slot.event is not None:
            slot.event.synchronize()
        return slot

    def pipe_streams(self) -> list:
        """The DRIVER engine's in-order streams of a GPU lane (the
        reference's 16 command queues), made at the lane's first pipelined
        call and kept."""
        if self._pipe_streams is None:
            self._pipe_streams = [torch.cuda.Stream(self.device) for _ in range(PIPE_QUEUES)]
        return self._pipe_streams

    # -- benchmarks ----------------------------------------------------------
    def start_bench(self, compute_id: int) -> None:
        self._bench_t0[compute_id] = time.perf_counter()
        if self.stream is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(self.stream)
            self._bench_span[compute_id] = [start, None]

    def end_issue(self, compute_id: int) -> None:
        """The plain path has issued all of this call's work on the lane's
        stream: on a GPU lane, mark the end of its device span (the bench
        :meth:`end_bench` takes), then let the call's host lanes start."""
        span = self._bench_span.get(compute_id)
        if span is not None:
            span[1] = torch.cuda.Event(enable_timing=True)
            span[1].record(self.stream)
        self.release_host_lanes()

    def release_host_lanes(self) -> None:
        """Let the host lanes of the call start (:attr:`issued`)."""
        if self.issued is not None:
            self.issued.set()

    def end_bench(self, compute_id: int) -> None:
        """The bench of the phase: its wall, or, where :meth:`end_issue`
        marked one and it has completed, the device span from the phase's
        start to its last operation.  A GPU lane's thread returns from its
        fence only once it holds the interpreter lock again, which a host
        lane's lowered kernels hold between their torch calls, so its wall
        would hold that wait too."""
        t0 = self._bench_t0.pop(compute_id, None)
        span = self._bench_span.pop(compute_id, None)
        if t0 is None:
            return
        if span is not None and span[1] is not None and span[1].query():
            self.benchmarks[compute_id] = span[0].elapsed_time(span[1])
        else:
            self.benchmarks[compute_id] = (time.perf_counter() - t0) * 1000.0

    # -- buffers -------------------------------------------------------------
    def ensure_resident(self, arr: ClArray) -> torch.Tensor:
        """The lane's full-size buffer for ``arr``: the cached one, or zeros."""
        key = id(arr)
        host = _host_tensor(arr)
        buf = self._buffers.get(key)
        if buf is None or buf.shape[0] != host.numel() or buf.dtype != host.dtype:
            buf = torch.zeros(host.numel(), dtype=host.dtype, device=self.device)
            self._buffers[key] = buf
            self._buffer_owner[key] = arr
            self._uploaded.pop(key, None)
        return buf

    def buffer(self, arr: ClArray) -> torch.Tensor:
        """The lane's device buffer of ``arr``."""
        return self._buffers[id(arr)]

    def set_buffer(self, arr: ClArray, buf: torch.Tensor) -> None:
        """Make ``buf`` the lane's buffer of ``arr``."""
        self._buffers[id(arr)] = buf
        self._buffer_owner[id(arr)] = arr

    def upload_covers(self, arr: ClArray, offset_elems: int, size_elems: int) -> bool:
        """True iff this lane's resident data already covers the element
        range (the enqueue-mode residency test; range-aware, so a rebalance
        between syncs forces a fetch of the moved region)."""
        rec = self._uploaded.get(id(arr))
        return (rec is not None and id(arr) in self._buffers and rec[0] <= offset_elems
                and offset_elems + size_elems <= rec[0] + rec[1])

    def _record_upload(self, arr: ClArray, offset_elems: int, size_elems: int) -> None:
        key = id(arr)
        rec = self._uploaded.get(key)
        if rec is not None and not (offset_elems > rec[0] + rec[1]
                                    or rec[0] > offset_elems + size_elems):
            lo = min(rec[0], offset_elems)
            hi = max(rec[0] + rec[1], offset_elems + size_elems)
            self._uploaded[key] = (lo, hi - lo)
        else:
            self._uploaded[key] = (offset_elems, size_elems)

    def reset_coverage(self) -> None:
        """Forget what has been uploaded, keeping the buffers: the next
        enqueue-mode compute re-fetches its range from the host.  Called
        when a rebalance moves ranges."""
        self._uploaded.clear()
        self.coverage_epoch += 1

    def claim_upload(self, arr: ClArray, offset_elems: int, size_elems: int,
                     full: bool) -> None:
        """Record the element range an upload covers (the whole array when
        ``full``), before its copy runs: work queued on this lane later runs
        after it."""
        if full:
            self._uploaded[id(arr)] = (0, arr.size)
        else:
            self._record_upload(arr, offset_elems, size_elems)

    def _slow_link(self, where: str, t0: float) -> None:
        """An armed ``slow-link`` fault: sleep ``(factor-1)`` times the
        transfer's measured issue time, plus its ``delay_ms``."""
        d = FAULTS.delay_s("slow-link", lane=self.index, where=where,
                           base_s=time.perf_counter() - t0)
        if d > 0.0:
            time.sleep(d)

    def upload(self, arr: ClArray, offset_elems: int, size_elems: int, full: bool) -> None:
        """H2D of the whole array or only this lane's range slice."""
        _tt = TRACER.t0()
        t0 = time.perf_counter() if FAULTS.enabled else 0.0
        buf = self.ensure_resident(arr)
        host = _host_tensor(arr)
        if full:
            buf.copy_(host, non_blocking=True)
            nbytes = host.numel() * host.element_size()
        else:
            sl = slice(offset_elems, offset_elems + size_elems)
            buf[sl].copy_(host[sl], non_blocking=True)
            nbytes = size_elems * host.element_size()
        if t0:
            self._slow_link("h2d", t0)
        self._mark("h2d")
        self._m_upload_bytes.inc(nbytes)
        self.claim_upload(arr, offset_elems, size_elems, full)
        self.transfers["h2d", arr.name] += 1
        TRACER.record("upload", _tt, lane=self.index, tag=arr.name)

    def invalidate(self, arr: ClArray) -> None:
        """Drop the lane's buffer and coverage of ``arr``: the next call
        uploads it whole again."""
        self._buffers.pop(id(arr), None)
        self._buffer_owner.pop(id(arr), None)
        self._uploaded.pop(id(arr), None)

    def stage_upload(self, arr: ClArray, offset_elems: int, size_elems: int, stream=None):
        """Start the H2D of a range slice without making it visible to the
        lane's kernels (reference ``stage_upload``: the read stage of the
        pipelined engines); returns the handle :meth:`commit_upload` takes.
        A GPU lane copies on ``stream`` (its H2D stream when None); a host
        lane copies the slice aside.  Counts one transfer."""
        self.transfers["h2d", arr.name] += 1
        return self._stage(arr, offset_elems, size_elems, "upload", f"stage:{arr.name}",
                           stream)

    def stage_upload_chunk(self, arr: ClArray, offset_elems: int, size_elems: int):
        """Start the H2D of one chunk of a streamed partition upload on the
        caller's thread, before its kernels are dispatched (the chunk counts
        as a chunk copy; ``Cores._run_streamed`` counts the range once)."""
        self.chunk_transfers["h2d", arr.name] += 1
        self._m_h2d_chunks.inc()
        return self._stage(arr, offset_elems, size_elems, "upload-chunk",
                           f"{arr.name}@{offset_elems}+{size_elems}", None)

    def _stage(self, arr: ClArray, offset_elems: int, size_elems: int, kind: str, tag: str,
               stream):
        """A staged H2D: a GPU lane copies on ``stream`` into the lane's
        buffer (from the host array when it is page-locked, else through a
        staging slot) and records an event; a host lane copies the slice
        aside, to be written in order."""
        _tt = TRACER.t0()
        t0 = time.perf_counter() if FAULTS.enabled else 0.0
        sl = slice(offset_elems, offset_elems + size_elems)
        host = _host_tensor(arr)[sl]
        self._m_upload_bytes.inc(host.numel() * host.element_size())
        buf = self._buffers[id(arr)]
        if self.stream is None:
            staged = (arr, offset_elems, size_elems, host.clone(), buf)
            if t0:
                self._slow_link("h2d", t0)
            self._mark("h2d")
            TRACER.record(kind, _tt, lane=self.index, tag=tag)
            return staged
        stream = stream or self.h2d_stream
        src = host
        slot = None
        if not _pinned(arr):
            slot = self._slot(self._up_ring)
            src = slot.view(host.numel() * host.element_size()).view(host.dtype)
            src.copy_(host)
        with torch.cuda.stream(stream):
            buf[sl].copy_(src, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        buf.record_stream(stream)
        if slot is not None:
            slot.event = done
        if t0:
            self._slow_link("h2d", t0)
        self._mark("h2d", event=done)
        TRACER.record(kind, _tt, lane=self.index, tag=tag)
        return (arr, offset_elems, size_elems, done, buf)

    def commit_upload(self, staged) -> None:
        """Make a staged slice visible to the lane's next kernels: on a GPU
        lane the current stream (the lane's compute stream, or the DRIVER
        engine's stream of the blob) waits for the slice's H2D event; a host
        lane writes the slice.  Runs in the lane's order."""
        arr, off, n, data, target = staged
        sl = slice(off, off + n)
        buf = self._buffers[id(arr)]
        if self.stream is None:
            buf[sl].copy_(data)
        else:
            torch.cuda.current_stream(self.device).wait_event(data)
            if buf is not target:
                # a kernel gave the array a new buffer since the chunk was staged
                buf[sl].copy_(target[sl])
        self._record_upload(arr, off, n)

    def download_chunk_async(self, arr: ClArray, offset_elems: int, size_elems: int):
        """One chunk of a streamed partition download (or of the flush's
        chunked drain), ordered after the lane's work issued so far; a
        handle for :meth:`finish_download`.  A GPU lane copies on its D2H
        stream after an event on the compute stream, into the host array
        when it is page-locked, else into a staging slot whose host copy
        :meth:`finish_download` makes.  A host lane copies in the lane's
        order."""
        sl = slice(offset_elems, offset_elems + size_elems)
        self.chunk_transfers["d2h", arr.name] += 1
        self._m_d2h_chunks.inc()
        if self.stream is None:
            self._m_download_bytes.inc(size_elems * self._buffers[id(arr)].element_size())
            fut = None
            if self._host_queue is not None and not self._host_queue.on_thread():
                fut = self._host_queue.submit(lambda: self._copy_down(arr, sl))
            else:
                self._copy_down(arr, sl)
            return self._owe(_Download(None, lane=self.index, tag=arr.name, fut=fut))
        ready = torch.cuda.Event()
        ready.record(self.stream)
        return self._d2h(arr, sl, self.d2h_stream, ready, "download-chunk")

    def _d2h(self, arr: ClArray, sl: slice, stream, after, kind: str) -> "_Download":
        """A GPU lane's D2H of one slice on ``stream``, after the event
        ``after`` (None: in ``stream``'s own order), into the host array when
        it is page-locked, else into a staging slot whose host copy
        :meth:`finish_download` makes."""
        t0 = time.perf_counter() if FAULTS.enabled else 0.0
        buf = self._buffers[id(arr)]
        host = _host_tensor(arr)[sl]
        slot = None if _pinned(arr) else self._slot(self._down_ring)
        if after is not None:
            stream.wait_event(after)
        with torch.cuda.stream(stream):
            if slot is None:
                dst = host
            else:
                dst = slot.view(host.numel() * host.element_size()).view(host.dtype)
            dst.copy_(buf[sl], non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        buf.record_stream(stream)
        self._m_download_bytes.inc(host.numel() * host.element_size())
        if t0:
            self._slow_link("d2h", t0)
        if slot is None:
            return self._owe(_Download(done, lane=self.index, tag=arr.name, kind=kind))
        handle = _Download(done, slot, dst, host, lane=self.index, tag=arr.name, kind=kind)
        slot.event = done
        slot.pending = handle
        return self._owe(handle)

    def _copy_down(self, arr: ClArray, sl: slice) -> None:
        """A host lane's D2H of one slice, where the lane's work runs."""
        t0 = time.perf_counter() if FAULTS.enabled else 0.0
        _host_tensor(arr)[sl].copy_(self._buffers[id(arr)][sl])
        if t0:
            self._slow_link("d2h", t0)

    # -- launch --------------------------------------------------------------
    def _ladder_call(self, program: KernelProgram, kernel_names: tuple, launcher: Callable,
                     args: tuple, params: Sequence[ClArray], stream=None) -> None:
        """``launcher(*args, bufs)`` over the params' buffers: through the
        lane's CUDA graphs on a GPU lane (``LaneGraphs.run``, on ``stream``,
        the lane's stream when None), as a host loop on a host lane."""
        bufs = tuple(self._buffers[id(p)] for p in params)
        if self.graphs is None:
            bufs = launcher(*args, bufs)
        else:
            bufs = self.graphs.run((launcher, args, buffers_key(bufs)),
                                   lambda: launcher(*args, bufs), bufs, stream or self.stream,
                                   lambda out: program.capturable(kernel_names, bufs, out))
        for p, b in zip(params, bufs):
            self._buffers[id(p)] = b

    def launch(self, program: KernelProgram, kernel_names: Sequence[str],
               params: Sequence[ClArray], value_args, offset: int, size: int,
               local_range: int, global_size: int, step: int, repeats: int = 1,
               sync_kernel: str | None = None, compute_id: int | None = None,
               stream=None) -> None:
        """Run the kernel sequence over work items ``[offset, offset+size)``,
        ``repeats`` times with ``sync_kernel`` between two repeats (reference:
        computeRepeated / computeRepeatedWithSyncKernel).  The repeats are one
        call of ``KernelProgram.fused_launcher`` (:meth:`_ladder_call`); with
        unhashable values, every launch runs in turn.  ``compute_id`` tags
        the launch span.  Launches go on the current stream; ``stream`` is
        the one a GPU lane's graph replays on (the lane's stream when
        None).  With ``trace.device.MARKS`` on, a device-timeline mark
        (``ck|k=...|c=...|l=...|s=...``) covers the dispatch.  With markers
        on, a launch that succeeded adds one marker per launcher call, the
        repeats' fused ladder one, reached when the last of them retires."""
        _tt = TRACER.t0()
        names = tuple(kernel_names)
        platform = self.device.type
        _dm = MARKS.begin(names, compute_id, self.index) if MARKS.enabled else None
        try:
            if repeats > 1:
                fn = program.fused_launcher(names, step, global_size, local_range,
                                            global_size, value_args, platform, sync_kernel)
                if fn is not None:
                    self._ladder_call(program, names + ((sync_kernel,) if sync_kernel else ()),
                                      fn, (offset, size // step, repeats), params, stream)
                    self._mark("launch", 1, stream=stream or self.stream)
                    TRACER.record("launch", _tt, cid=compute_id, lane=self.index,
                                  tag=f"{'+'.join(names)} x1")
                    return
            plan = list(names)
            for _ in range(repeats - 1):
                plan += ([sync_kernel] if sync_kernel else []) + list(names)
            ladder = launch_ladder(size, step)
            bufs = tuple(self._buffers[id(p)] for p in params)
            for name in plan:
                va = tuple(value_args.get(name, ()) if isinstance(value_args, dict)
                           else value_args)
                n_arr = program.array_param_count(name)
                off = offset
                for chunk in ladder:
                    fn, _ = program.launcher(name, chunk, local_range, global_size,
                                             platform=platform)
                    out = fn(off, bufs[:n_arr], va)
                    bufs = tuple(out) + bufs[n_arr:]
                    off += chunk
            for p, b in zip(params, bufs):
                self._buffers[id(p)] = b
        finally:
            if _dm is not None:  # closed even on a failed dispatch
                MARKS.end(_dm)
        dispatched = len(plan) * len(ladder)
        self._mark("launch", dispatched)
        TRACER.record("launch", _tt, cid=compute_id, lane=self.index,
                      tag=f"{'+'.join(names)} x{dispatched}")

    def launch_fused(self, program: KernelProgram, kernel_names: Sequence[str],
                     params: Sequence[ClArray], value_args, offset: int, size: int,
                     local_range: int, global_size: int, step: int, iters: int,
                     compute_id: int | None = None) -> None:
        """``iters`` iterations of the kernel sequence over this lane's range
        as one call of ``KernelProgram.fused_launcher`` (the fused window's
        dispatch, ``core/cores.py``; :meth:`_ladder_call`).  A window opens
        only on hashable values, and its launcher was built when it opened.
        With markers on, one marker, added only once the dispatch
        succeeded."""
        _tt = TRACER.t0()
        names = tuple(kernel_names)
        fn = program.fused_launcher(names, step, global_size, local_range, global_size,
                                    value_args, platform=self.device.type)
        # the fused ladder is one dispatch: one mark covers its iterations
        _dm = MARKS.begin(names, compute_id, self.index) if MARKS.enabled else None
        try:
            self._ladder_call(program, names, fn, (offset, size // step, iters), params)
        finally:
            if _dm is not None:
                MARKS.end(_dm)
        self._mark("launch", 1, stream=self.stream)
        TRACER.record("launch", _tt, cid=compute_id, lane=self.index,
                      tag=f"fused:{'+'.join(names)} x{iters}")

    # -- readback ------------------------------------------------------------
    def download(self, arr: ClArray, offset_elems: int, size_elems: int,
                 full: bool) -> None:
        """D2H of this lane's range (or the whole array) into the host
        array, issued on the current stream; :meth:`fence` waits for it
        (the plain path fences once after its downloads).  Its marker
        reaches when the copy has completed."""
        self._download(arr, offset_elems, size_elems, full)
        self._mark("d2h")

    def _download(self, arr: ClArray, offset_elems: int, size_elems: int,
                  full: bool) -> None:
        """:meth:`download` without its marker."""
        _tt = TRACER.t0()
        t0 = time.perf_counter() if FAULTS.enabled else 0.0
        buf = self._buffers[id(arr)]
        host = _host_tensor(arr)
        if full:
            host.copy_(buf, non_blocking=True)
            nbytes = host.numel() * host.element_size()
        else:
            sl = slice(offset_elems, offset_elems + size_elems)
            host[sl].copy_(buf[sl], non_blocking=True)
            nbytes = size_elems * host.element_size()
        if t0:
            self._slow_link("d2h", t0)
        self._m_download_bytes.inc(nbytes)
        self.transfers["d2h", arr.name] += 1
        TRACER.record("download", _tt, lane=self.index, tag=arr.name)

    def download_async(self, arr: ClArray, offset_elems: int, size_elems: int,
                       full: bool, stream=None, after=None):
        """:meth:`download` ordered after the lane's work, with a handle for
        :meth:`finish_download`: a CUDA event on the lane's stream, a
        future on a host lane's queue, or None where it ran inline.  On a
        GPU lane, ``stream`` moves the copy onto that stream, after the
        event ``after`` (None: in the stream's own order), through a
        staging slot for a pageable array (the pipelined engines' write
        stage); a host lane has one order and ignores both.  With markers
        on, the download adds one marker and its handle owes it."""
        if self.stream is not None and stream is not None:
            self.transfers["d2h", arr.name] += 1
            sl = slice(0, arr.size) if full else slice(offset_elems, offset_elems + size_elems)
            return self._d2h(arr, sl, stream, after, "download")
        if self.stream is not None:
            with self.on_stream():
                self._download(arr, offset_elems, size_elems, full)
                handle = torch.cuda.Event()
                handle.record(self.stream)
        elif self._host_queue is not None:
            handle = self._host_queue.submit(
                lambda: self._download(arr, offset_elems, size_elems, full))
        else:
            self._download(arr, offset_elems, size_elems, full)
            handle = None
        m = self._add_markers("d2h")
        return handle if m is None else _Marked(handle, m)

    @staticmethod
    def finish_download(handle) -> None:
        """Block until a :meth:`download_async` or
        :meth:`download_chunk_async` has landed in host memory; a handle
        that owes a marker reaches it then, also when the copy failed."""
        if isinstance(handle, _Marked):
            try:
                Worker.finish_download(handle.handle)
            finally:
                markers, handle.markers = handle.markers, None  # reached once
                if markers is not None:
                    markers.reach()
        elif isinstance(handle, Future):
            handle.result()
        elif isinstance(handle, _Download):
            handle.finish()
        elif handle is not None:
            handle.synchronize()

    def fence(self) -> None:
        """Block until every operation issued on this lane has completed
        (a host lane: everything :meth:`issue` queued), raising a failure
        of queued work.  No span here: the barrier's ``fence`` span covers
        the wait (the per-cid probes, :meth:`fence_cid`, record theirs)."""
        if self.stream is None and self._host_queue is None:
            return  # a host lane that ran everything inline
        t0 = time.perf_counter()
        if self.stream is not None:
            self.stream.synchronize()
            self.h2d_stream.synchronize()
            self.d2h_stream.synchronize()
        else:
            self._host_queue.synchronize()
        self._m_fence_waits.inc()
        self._m_fence_seconds.observe(time.perf_counter() - t0)

    def mark_cid(self, compute_id: int) -> None:
        """Record the completion probe of this compute id's work issued so
        far on the lane (only while :attr:`track_cid_outputs`): a CUDA event
        on the lane's stream, a marker queued behind a host lane's work, or
        True where that work ran on this thread.  The 64 most recent ids
        are kept."""
        if self.stream is not None:
            probe: Any = torch.cuda.Event()
            probe.record(self.stream)
        elif self._host_queue is not None and not self._host_queue.on_thread():
            probe = self._host_queue.submit(lambda: None)
        else:
            probe = True
        self._cid_last_out.pop(compute_id, None)
        self._cid_last_out[compute_id] = probe
        if len(self._cid_last_out) > 64:
            self._cid_last_out.pop(next(iter(self._cid_last_out)))

    def fence_cid(self, compute_id: int) -> bool:
        """Block until this lane's work for ONE compute id has retired
        (its :meth:`mark_cid` probe; stream order: with everything issued
        before it).  False when the id left no probe here (it never ran on
        this lane, or the split was off)."""
        probe = self._cid_last_out.get(compute_id)
        if probe is None:
            return False
        _tt = TRACER.t0()
        if isinstance(probe, Future):
            probe.result()
        elif probe is not True:
            probe.synchronize()
        TRACER.record("fence", _tt, cid=compute_id, lane=self.index, tag="cid-split")
        return True

    def dispose(self) -> None:
        try:
            try:
                self.drain_dispatch()
                self.drain_stream_dispatch()
            finally:
                self.fence()
        finally:
            for q in (self._driver, self._stream_driver):
                if q is not None:
                    q.close()
            self._driver = self._stream_driver = None
            self._pipe_streams = None
            for slot in self._down_ring.slots:
                if slot.pending is not None:
                    slot.pending.finish()
            self._up_ring = _Ring()
            self._down_ring = _Ring()
            if self.graphs is not None:
                self.graphs.clear()
            if self._host_queue is not None:
                self._host_queue.close()
                self._host_queue = None
            self._buffers.clear()
            self._buffer_owner.clear()
            self._uploaded.clear()
            self.benchmarks.clear()
            self.transfer_benchmarks.clear()
            self._cid_last_out.clear()
            if self.markers is not None:
                self.markers.close()
                self.markers = None
