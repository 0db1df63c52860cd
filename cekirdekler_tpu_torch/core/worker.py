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

The ladder (``step * 2^k`` chunks) stays for parity with the reference's
chunking: every launch geometry the balancer can produce is one of
O(log(range/step)) cached launch functions.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from concurrent.futures import Future, ThreadPoolExecutor
from contextlib import nullcontext
from typing import Any, Callable, Sequence

import torch

from ..arrays.clarray import ClArray
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


class Worker:
    """Per-lane execution engine."""

    def __init__(self, device: torch.device, index: int):
        self.device = device
        self.index = index
        # serializes whole lane phases of concurrent host threads
        self.lock = threading.RLock()
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._host_queue: _HostQueue | None = None
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
        if self._host_queue is None:
            self._host_queue = _HostQueue(self.index)
        self._host_queue.submit(fn)

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

    def upload(self, arr: ClArray, offset_elems: int, size_elems: int, full: bool) -> None:
        """H2D of the whole array or only this lane's range slice."""
        buf = self.ensure_resident(arr)
        host = _host_tensor(arr)
        if full:
            buf.copy_(host, non_blocking=True)
            self._uploaded[id(arr)] = (0, host.numel())
        else:
            sl = slice(offset_elems, offset_elems + size_elems)
            buf[sl].copy_(host[sl], non_blocking=True)
            self._record_upload(arr, offset_elems, size_elems)
        self.transfers["h2d", arr.name] += 1

    # -- launch --------------------------------------------------------------
    def launch(self, program: KernelProgram, kernel_names: Sequence[str],
               params: Sequence[ClArray], value_args, offset: int, size: int,
               local_range: int, global_size: int, step: int, repeats: int = 1) -> None:
        """Run the kernel sequence over work items ``[offset, offset+size)``,
        ``repeats`` times as a host loop (the on-device repeat of the
        reference waits for the fused-dispatch slice)."""
        bufs: tuple[Any, ...] = tuple(self._buffers[id(p)] for p in params)
        ladder = _ladder(size, step)
        for _ in range(repeats):
            for name in kernel_names:
                va = (value_args.get(name, ()) if isinstance(value_args, dict)
                      else tuple(value_args))
                n_arr = program.array_param_count(name)
                off = offset
                for chunk in ladder:
                    fn, _ = program.launcher(name, chunk, local_range, global_size,
                                             platform=self.device.type)
                    out = fn(off, bufs[:n_arr], tuple(va))
                    bufs = tuple(out) + bufs[n_arr:]
                    off += chunk
        for p, b in zip(params, bufs):
            self._buffers[id(p)] = b

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
            self.fence()
        finally:
            if self._host_queue is not None:
                self._host_queue.close()
                self._host_queue = None
            self._buffers.clear()
            self._buffer_owner.clear()
            self._uploaded.clear()
            self.benchmarks.clear()
            self.transfer_benchmarks.clear()
