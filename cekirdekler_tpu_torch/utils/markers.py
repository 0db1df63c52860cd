"""Progress markers: dispatched against retired operations per lane.

Counterpart of ``cekirdekler_tpu/utils/markers.py`` (reference queue
markers, ClCommandQueue.cs:99-115, ClNumberCruncher.cs:356-372,
ClPipeline.cs:4788-4827): a lane adds a marker when it issues an
operation and reaches it when the operation retires, which gives the
in-flight depth (:meth:`MarkerCounter.remaining`) and a smoothed retire
rate (:meth:`MarkerCounter.reach_speed`) that the device pool throttles
on.

:meth:`MarkerCounter.reach_when_ready` takes the port's completion
handles: a ``torch.cuda.Event`` recorded behind the operation on a GPU
lane's stream, joined by ``synchronize()`` (which releases the
interpreter lock while it waits); a ``concurrent.futures.Future`` of a
host lane's queue, joined by ``exception()``, so that a failed operation
retires and never raises here; a worker ``_Download``, joined by its
``synchronize()``; or None for work that already ran.  One daemon thread,
started at the first such call, joins them.  Pure Python: the reference's
native counter is not ported.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future

__all__ = ["MarkerCounter"]


def _join(handle) -> None:
    """Wait until ``handle`` has retired; a failed operation counts as
    retired."""
    if handle is None:
        return
    try:
        if isinstance(handle, Future):
            handle.exception()
        else:
            handle.synchronize()
    except Exception:  # noqa: BLE001 - a failed op still retires its marker
        pass


class MarkerCounter:
    """Dispatched/retired op counting and a smoothed retire rate.

    ``add()`` marks a dispatch; ``reach()`` marks completion now;
    ``reach_when_ready(h)`` marks completion when the handle ``h`` retires.
    The rate averages the last ``window`` retire observations (the
    reference's 15-sample markerReachSpeed, ClPipeline.cs:4788-4817).
    """

    def __init__(self, window: int = 15):
        self._lock = threading.Lock()
        # (retire-observation time, op count): a batched observation carries
        # its op count, so reach_speed() stays ops/second
        self._times: deque[tuple[float, int]] = deque(maxlen=window)
        self._completions: "queue.Queue" = queue.Queue()
        self._completion_thread: threading.Thread | None = None
        self._closed = False
        self._added = 0
        self._reached = 0

    def close(self) -> None:
        """Stop the completion thread (a bounded join of 5 s).  ``_closed``
        makes the thread skip the joins it still owes, so it ends even
        behind a burst of slow completions; every marker queued is counted
        as reached, and the counts keep answering."""
        self._closed = True
        t = self._completion_thread
        if t is not None:
            self._completions.put(None)
            t.join(timeout=5.0)
            self._completion_thread = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    # -- counting ------------------------------------------------------------
    def add(self, n: int = 1) -> None:
        with self._lock:
            self._added += n

    def reach(self, n: int = 1) -> None:
        now = time.perf_counter()
        with self._lock:
            self._reached += n
            self._times.append((now, n))

    def reach_when_ready(self, handle, n: int = 1) -> None:
        """Reach ``n`` markers when ``handle`` retires, joined on the
        completion thread, so the in-flight depth counts the device's work
        and not the host's issue."""
        if self._completion_thread is None:
            with self._lock:
                if self._completion_thread is None and not self._closed:
                    # daemon: a hung device must not block interpreter exit
                    self._completion_thread = threading.Thread(
                        target=self._drain_completions, name="marker-reach", daemon=True)
                    self._completion_thread.start()
        self._completions.put((handle, n))

    def _drain_completions(self) -> None:
        # Batched joins: every handle queued so far is joined, not only the
        # newest (a GPU lane's copy streams and compute stream retire out of
        # order), and the whole batch retires as ONE weighted rate sample;
        # per-item reach() calls would bunch the window into microseconds
        # and inflate reach_speed()
        while True:
            item = self._completions.get()
            if item is None:
                return
            batch = [item]
            while True:
                try:
                    nxt = self._completions.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:  # close() asked: finish the batch, then exit
                    item = None
                    break
                batch.append(nxt)
            for handle, _n in batch:
                if self._closed:  # close() asked: skip the joins still owed
                    break
                _join(handle)
            self.reach(sum(n for _h, n in batch))
            if item is None:
                return

    # -- queries -------------------------------------------------------------
    @property
    def added(self) -> int:
        with self._lock:
            return self._added

    @property
    def reached(self) -> int:
        with self._lock:
            return self._reached

    def remaining(self) -> int:
        """In-flight depth (reference: countMarkersRemaining)."""
        with self._lock:
            return self._added - self._reached

    def drain(self, timeout: float = 30.0) -> None:
        """Block until every added marker has reached (bounded)."""
        deadline = time.perf_counter() + timeout
        while self.remaining() > 0 and time.perf_counter() < deadline:
            time.sleep(0.0005)

    def reach_speed(self) -> float:
        """Retired ops/second over the smoothing window (0 below two
        samples): ops counted from the second observation on, over the
        window's span."""
        with self._lock:
            if len(self._times) < 2:
                return 0.0
            span = self._times[-1][0] - self._times[0][0]
            ops = sum(n for _t, n in list(self._times)[1:])
            return ops / span if span > 0 else 0.0

    def reset(self) -> None:
        with self._lock:
            self._added = 0
            self._reached = 0
            self._times.clear()
