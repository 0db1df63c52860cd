"""Worker — one dispatch lane: a CUDA device on its own stream, or a
host-CPU lane.

Counterpart of ``cekirdekler_tpu/core/worker.py``: the lane owns a
full-size device buffer per array keyed ``id(arr)``, uploads its range
slice (or the whole array) by ``non_blocking`` copies from host memory
(page-locked for ``fast`` arrays), launches the kernel sequence over the
binary chunk ladder, downloads its range slice, and keeps per-compute-id
wall benches that feed the load balancer.  Every device operation of a
CUDA lane runs on the lane's own ``torch.cuda.Stream``.

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

The ladder (``step * 2^k`` chunks) stays for parity with the reference's
chunking: every launch geometry the balancer can produce is one of
O(log(range/step)) cached launch functions.
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

__all__ = ["Worker"]


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
    """A D2H in flight on a GPU lane: its completion event and, when it
    went through a staging slot, the host copy :meth:`Worker.finish_download`
    still owes."""

    def __init__(self, event, slot: _Slot | None = None, src: torch.Tensor | None = None,
                 dst: torch.Tensor | None = None):
        self.event = event
        self.slot = slot
        self.src = src
        self.dst = dst
        self.done = False

    def finish(self) -> None:
        if self.done:
            return
        self.event.synchronize()
        if self.slot is not None:
            self.dst.copy_(self.src)
            if self.slot.pending is self:
                self.slot.pending = None
        self.done = True


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
    :meth:`drain` (the window's sync point)."""

    def __init__(self, name: str, host_queue: _HostQueue | None = None):
        self.name = name
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
        """Raise a held failure without queuing anything."""
        with self._cond:
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

    def submit(self, fn: Callable[[], None], depth: int = 2) -> None:
        with self._cond:
            self._raise_held()
            self._wait_below(max(1, int(depth)))
            self._pending += 1
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
        finally:
            with self._cond:
                self._pending -= 1
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

    def on_stream(self):
        """Context that makes this lane's stream current (no-op on host)."""
        return torch.cuda.stream(self.stream) if self.stream is not None else nullcontext()

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
                                        None if self.stream is not None else self._queue())
        return self._driver

    def dispatch_preflight(self) -> None:
        """Raise a failure of an earlier dispatch closure without queuing
        anything: a fused dispatch runs this on every lane before it queues
        a closure on any."""
        if self._driver is not None:
            self._driver.preflight()

    def dispatch_async(self, fn: Callable[[], None], depth: int = 2) -> None:
        """Queue a dispatch closure on this lane's driver; a GPU lane runs
        it under the lane's lock, a host lane on its queue after the work
        queued there before.  At most ``depth`` closures are in flight."""
        if self.stream is not None:
            work = fn

            def fn() -> None:
                with self.lock:
                    work()

        self._driver_queue().submit(fn, depth)

    def drain_dispatch(self) -> None:
        """Wait until every queued dispatch closure has run, raising the
        first failure."""
        if self._driver is not None:
            self._driver.drain()

    # -- stream driver (streamed transfers) ----------------------------------
    def stream_preflight(self) -> None:
        """Raise a failure of an earlier streamed-transfer closure without
        queuing anything (and without starting the driver)."""
        if self._stream_driver is not None:
            self._stream_driver.preflight()

    def stream_dispatch_async(self, fn: Callable[[], None], depth: int = 2) -> None:
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
        chunk (``tools/stream_chunks.py`` times both)."""
        if self.stream is not None:
            with self.on_stream():
                fn()
            return
        if self._stream_driver is None:
            self._stream_driver = _DriverQueue(f"ck-stream-lane-{self.index}", self._queue())
        self._stream_driver.submit(fn, depth)

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

    # -- benchmarks ----------------------------------------------------------
    def start_bench(self, compute_id: int) -> None:
        self._bench_t0[compute_id] = time.perf_counter()

    def end_bench(self, compute_id: int) -> None:
        t0 = self._bench_t0.pop(compute_id, None)
        if t0 is not None:
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

    def upload(self, arr: ClArray, offset_elems: int, size_elems: int, full: bool) -> None:
        """H2D of the whole array or only this lane's range slice."""
        buf = self.ensure_resident(arr)
        host = _host_tensor(arr)
        if full:
            buf.copy_(host, non_blocking=True)
        else:
            sl = slice(offset_elems, offset_elems + size_elems)
            buf[sl].copy_(host[sl], non_blocking=True)
        self.claim_upload(arr, offset_elems, size_elems, full)
        self.transfers["h2d", arr.name] += 1

    def invalidate(self, arr: ClArray) -> None:
        """Drop the lane's buffer and coverage of ``arr``: the next call
        uploads it whole again."""
        self._buffers.pop(id(arr), None)
        self._buffer_owner.pop(id(arr), None)
        self._uploaded.pop(id(arr), None)

    def stage_upload_chunk(self, arr: ClArray, offset_elems: int, size_elems: int):
        """Start the H2D of one chunk of a streamed partition upload on the
        caller's thread, before its kernels are dispatched; returns the
        handle :meth:`commit_upload` takes.  A GPU lane copies on its H2D
        stream into the lane's buffer (from the host array when it is
        page-locked, else through a staging slot) and records an event; a
        host lane copies the slice aside, to be written in order."""
        sl = slice(offset_elems, offset_elems + size_elems)
        host = _host_tensor(arr)[sl]
        self.chunk_transfers["h2d", arr.name] += 1
        buf = self._buffers[id(arr)]
        if self.stream is None:
            return (arr, offset_elems, size_elems, host.clone(), buf)
        src = host
        slot = None
        if not _pinned(arr):
            slot = self._slot(self._up_ring)
            src = slot.view(host.numel() * host.element_size()).view(host.dtype)
            src.copy_(host)
        with torch.cuda.stream(self.h2d_stream):
            buf[sl].copy_(src, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.h2d_stream)
        buf.record_stream(self.h2d_stream)
        if slot is not None:
            slot.event = done
        return (arr, offset_elems, size_elems, done, buf)

    def commit_upload(self, staged) -> None:
        """Make a staged chunk visible to the lane's next kernels: a GPU
        lane's compute stream waits for the chunk's H2D event; a host lane
        writes the slice.  Runs in the lane's order (the stream driver)."""
        arr, off, n, data, target = staged
        sl = slice(off, off + n)
        buf = self._buffers[id(arr)]
        if self.stream is None:
            buf[sl].copy_(data)
        else:
            self.stream.wait_event(data)
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
        if self.stream is None:
            if self._host_queue is not None and not self._host_queue.on_thread():
                return self._host_queue.submit(lambda: self._copy_down(arr, sl))
            self._copy_down(arr, sl)
            return None
        buf = self._buffers[id(arr)]
        host = _host_tensor(arr)[sl]
        ready = torch.cuda.Event()
        ready.record(self.stream)
        slot = None if _pinned(arr) else self._slot(self._down_ring)
        self.d2h_stream.wait_event(ready)
        with torch.cuda.stream(self.d2h_stream):
            if slot is None:
                dst = host
            else:
                dst = slot.view(host.numel() * host.element_size()).view(host.dtype)
            dst.copy_(buf[sl], non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.d2h_stream)
        buf.record_stream(self.d2h_stream)
        if slot is None:
            return _Download(done)
        handle = _Download(done, slot, dst, host)
        slot.event = done
        slot.pending = handle
        return handle

    def _copy_down(self, arr: ClArray, sl: slice) -> None:
        _host_tensor(arr)[sl].copy_(self._buffers[id(arr)][sl])

    # -- launch --------------------------------------------------------------
    def _ladder_call(self, program: KernelProgram, kernel_names: tuple, launcher: Callable,
                     args: tuple, params: Sequence[ClArray]) -> None:
        """``launcher(*args, bufs)`` over the params' buffers: through the
        lane's CUDA graphs on a GPU lane (``LaneGraphs.run``), as a host loop
        on a host lane."""
        bufs = tuple(self._buffers[id(p)] for p in params)
        if self.graphs is None:
            bufs = launcher(*args, bufs)
        else:
            bufs = self.graphs.run((launcher, args, buffers_key(bufs)),
                                   lambda: launcher(*args, bufs), bufs, self.stream,
                                   lambda out: program.capturable(kernel_names, bufs, out))
        for p, b in zip(params, bufs):
            self._buffers[id(p)] = b

    def launch(self, program: KernelProgram, kernel_names: Sequence[str],
               params: Sequence[ClArray], value_args, offset: int, size: int,
               local_range: int, global_size: int, step: int, repeats: int = 1,
               sync_kernel: str | None = None) -> None:
        """Run the kernel sequence over work items ``[offset, offset+size)``,
        ``repeats`` times with ``sync_kernel`` between two repeats (reference:
        computeRepeated / computeRepeatedWithSyncKernel).  The repeats are one
        call of ``KernelProgram.fused_launcher`` (:meth:`_ladder_call`); with
        unhashable values, every launch runs in turn."""
        names = tuple(kernel_names)
        platform = self.device.type
        if repeats > 1:
            fn = program.fused_launcher(names, step, global_size, local_range, global_size,
                                        value_args, platform, sync_kernel)
            if fn is not None:
                self._ladder_call(program, names + ((sync_kernel,) if sync_kernel else ()),
                                  fn, (offset, size // step, repeats), params)
                return
        plan = list(names)
        for _ in range(repeats - 1):
            plan += ([sync_kernel] if sync_kernel else []) + list(names)
        ladder = _ladder(size, step)
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

    def launch_fused(self, program: KernelProgram, kernel_names: Sequence[str],
                     params: Sequence[ClArray], value_args, offset: int, size: int,
                     local_range: int, global_size: int, step: int, iters: int) -> None:
        """``iters`` iterations of the kernel sequence over this lane's range
        as one call of ``KernelProgram.fused_launcher`` (the fused window's
        dispatch, ``core/cores.py``; :meth:`_ladder_call`).  A window opens
        only on hashable values, and its launcher was built when it opened."""
        names = tuple(kernel_names)
        fn = program.fused_launcher(names, step, global_size, local_range, global_size,
                                    value_args, platform=self.device.type)
        self._ladder_call(program, names, fn, (offset, size // step, iters), params)

    # -- readback ------------------------------------------------------------
    def download(self, arr: ClArray, offset_elems: int, size_elems: int,
                 full: bool) -> None:
        """D2H of this lane's range (or the whole array) into the host
        array, issued on the current stream; :meth:`fence` waits for it
        (the plain path fences once after its downloads)."""
        buf = self._buffers[id(arr)]
        host = _host_tensor(arr)
        if full:
            host.copy_(buf, non_blocking=True)
        else:
            sl = slice(offset_elems, offset_elems + size_elems)
            host[sl].copy_(buf[sl], non_blocking=True)
        self.transfers["d2h", arr.name] += 1

    def download_async(self, arr: ClArray, offset_elems: int, size_elems: int,
                       full: bool):
        """:meth:`download` ordered after the lane's work, with a handle for
        :meth:`finish_download`: a CUDA event on the lane's stream, a
        future on a host lane's queue, or None where it ran inline."""
        if self.stream is not None:
            with self.on_stream():
                self.download(arr, offset_elems, size_elems, full)
                done = torch.cuda.Event()
                done.record(self.stream)
            return done
        if self._host_queue is not None:
            return self._host_queue.submit(
                lambda: self.download(arr, offset_elems, size_elems, full))
        self.download(arr, offset_elems, size_elems, full)
        return None

    @staticmethod
    def finish_download(handle) -> None:
        """Block until a :meth:`download_async` or
        :meth:`download_chunk_async` has landed in host memory."""
        if isinstance(handle, Future):
            handle.result()
        elif isinstance(handle, _Download):
            handle.finish()
        elif handle is not None:
            handle.synchronize()

    def fence(self) -> None:
        """Block until every operation issued on this lane has completed
        (a host lane: everything :meth:`issue` queued), raising a failure
        of queued work."""
        if self.stream is not None:
            self.stream.synchronize()
            self.h2d_stream.synchronize()
            self.d2h_stream.synchronize()
        elif self._host_queue is not None:
            self._host_queue.synchronize()

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
