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


class _HostQueue:
    """A host lane's stream: work submitted here runs in order on one
    thread; :meth:`synchronize` waits for all of it and raises the first
    error, as a device fence surfaces a failed kernel."""

    def __init__(self, index: int):
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix=f"ck-host-lane-{index}")
        self._pending: list[Future] = []
        self._mu = threading.Lock()

    def submit(self, fn: Callable[[], Any]) -> Future:
        with self._mu:
            fut = self._pool.submit(fn)
            self._pending.append(fut)
        return fut

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
        self._host_queue: _HostQueue | None = None
        self._driver: _DriverQueue | None = None
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
        # transfers issued, keyed ("h2d" | "d2h", array name)
        self.transfers: Counter = Counter()

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
        """Block until a :meth:`download_async` has landed in host memory."""
        if isinstance(handle, Future):
            handle.result()
        elif handle is not None:
            handle.synchronize()

    def fence(self) -> None:
        """Block until every operation issued on this lane has completed
        (a host lane: everything :meth:`issue` queued), raising a failure
        of queued work."""
        if self.stream is not None:
            self.stream.synchronize()
        elif self._host_queue is not None:
            self._host_queue.synchronize()

    def dispose(self) -> None:
        try:
            try:
                self.drain_dispatch()
            finally:
                self.fence()
        finally:
            if self._driver is not None:
                self._driver.close()
                self._driver = None
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
