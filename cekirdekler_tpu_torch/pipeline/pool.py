"""Task pools and the device pool: a greedy batch scheduler over lanes.

Counterpart of ``cekirdekler_tpu/pipeline/pool.py`` (the reference's
``Pool.*`` namespace, ClPipeline.cs:3241-5080): compute calls are frozen
into :class:`ClTask` objects and queued in a :class:`ClTaskPool`, and a
:class:`ClDevicePool` drains pools greedily: each lane has a consumer
thread with a single-lane cruncher of its own and takes the next task the
moment it is idle (the reference's DEVICE_COMPUTE_AT_WILL,
ClPipeline.cs:3792-3807).

Control tasks are the reference's private messages (ClPipeline.cs:3247-3321):

- ``DEVICE_SELECT_BEGIN(i)`` / ``DEVICE_SELECT_END``: the tasks between run
  on lane ``i``;
- ``GLOBAL_SYNCHRONIZATION``: everything before it completes before
  anything after it starts;
- ``BROADCAST``: the task runs once on every lane;
- ``SERIAL_MODE_BEGIN`` / ``SERIAL_MODE_END``: the tasks between run one at
  a time, in order.

Lanes can be added while pools run (reference: addDevice,
ClPipeline.cs:4333-4390).  ``fine_grained_queue_control`` turns on each
consumer's queue markers and throttles its claims on them: a consumer
claims no task while its markers remaining reach ``queue_limit`` (the
reference's ``markersRemaining() < queueLimit``, ClPipeline.cs:4899-4909).
A marker reaches when its work retires on the lane (``utils/markers.py``),
so the throttle bounds the device work in flight, not the host's issue.
"""

from __future__ import annotations

import enum
import itertools
import queue
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Sequence

from ..arrays.clarray import ClArray, ParameterGroup
from ..core.cruncher import NumberCruncher
from ..errors import CekirdeklerError
from ..hardware import Device, Devices
from ..metrics.registry import REGISTRY
from ..trace.spans import TRACER

__all__ = ["ClDevicePool", "ClTask", "ClTaskPool", "ClTaskType", "PoolType"]

_task_ids = itertools.count(1)


class ClTaskType(enum.Enum):
    COMPUTE = "compute"
    DEVICE_SELECT_BEGIN = "device_select_begin"
    DEVICE_SELECT_END = "device_select_end"
    GLOBAL_SYNCHRONIZATION = "global_synchronization"
    BROADCAST = "broadcast"
    SERIAL_MODE_BEGIN = "serial_mode_begin"
    SERIAL_MODE_END = "serial_mode_end"


class PoolType(enum.Enum):
    DEVICE_COMPUTE_AT_WILL = "at_will"  # greedy, the reference's default
    # named by the reference and implemented neither there nor here
    DEVICE_ROUND_ROBIN = "round_robin"


@dataclass
class ClTask:
    """A frozen compute call (reference: ClTask), made by
    ``array.task(...)`` / ``group.task(...)`` or directly; ``callback`` runs
    with the task once it has completed.  ``tenant`` tags the task's
    ``ck_pool_tasks_total`` series (None: untagged)."""

    params: Sequence[ClArray] = ()
    kernel_names: Sequence[str] = ()
    compute_id: int = 0
    global_range: int = 0
    local_range: int = 256
    global_offset: int = 0
    values: Sequence | dict = ()
    task_type: ClTaskType = ClTaskType.COMPUTE
    select_device: int | None = None
    callback: Callable[["ClTask"], None] | None = None
    tenant: str | None = None
    task_id: int = field(default_factory=lambda: next(_task_ids))

    def compute(self, cruncher: NumberCruncher) -> None:
        """Run the frozen call on ``cruncher`` (reference: ClTask.compute)."""
        ParameterGroup(list(self.params)).compute(
            cruncher, self.compute_id, list(self.kernel_names), self.global_range,
            self.local_range, global_offset=self.global_offset, values=self.values)

    @staticmethod
    def device_select_begin(device_index: int) -> "ClTask":
        return ClTask(task_type=ClTaskType.DEVICE_SELECT_BEGIN, select_device=device_index)

    @staticmethod
    def device_select_end() -> "ClTask":
        return ClTask(task_type=ClTaskType.DEVICE_SELECT_END)

    @staticmethod
    def global_synchronization() -> "ClTask":
        return ClTask(task_type=ClTaskType.GLOBAL_SYNCHRONIZATION)

    @staticmethod
    def serial_mode_begin() -> "ClTask":
        return ClTask(task_type=ClTaskType.SERIAL_MODE_BEGIN)

    @staticmethod
    def serial_mode_end() -> "ClTask":
        return ClTask(task_type=ClTaskType.SERIAL_MODE_END)

    def as_broadcast(self) -> "ClTask":
        """Run this task once on every lane (reference BROADCAST)."""
        self.task_type = ClTaskType.BROADCAST
        return self


class ClTaskPool:
    """A thread-safe ordered task list (reference: ClTaskPool)."""

    def __init__(self, tasks: Sequence[ClTask] = ()):  # noqa: D107
        self._tasks: list[ClTask] = list(tasks)
        self._lock = threading.Lock()

    def add(self, task: ClTask) -> "ClTaskPool":
        with self._lock:
            self._tasks.append(task)
        return self

    def feed(self, other: "ClTaskPool", tenant: str | None = None) -> None:
        """Append another pool's tasks (reference: feed); ``tenant`` tags
        those without a tag of their own.  The other pool is read before
        this one's lock is taken, so ``a.feed(b)`` beside ``b.feed(a)``
        (or ``a.feed(a)``) cannot deadlock."""
        tasks = other.snapshot()
        if tenant is not None:
            tasks = [t if t.tenant is not None else replace(t, tenant=str(tenant))
                     for t in tasks]
        with self._lock:
            self._tasks.extend(tasks)

    def snapshot(self) -> list[ClTask]:
        with self._lock:
            return list(self._tasks)

    def __len__(self) -> int:
        with self._lock:
            return len(self._tasks)


class _Consumer(threading.Thread):
    """One lane's consumer (reference: DevicePoolThread): a cruncher of its
    own, greedy claims from the shared pipe and a queue of tasks pinned to
    it (selected or broadcast).  With the pool's
    ``fine_grained_queue_control`` its cruncher counts markers, and
    :meth:`_throttle` runs before every claim and every task."""

    def __init__(self, pool: "ClDevicePool", device: Device, index: int):
        super().__init__(daemon=True, name=f"ck-devpool-{index}")
        self.pool = pool
        self.index = index
        self.pinned: "queue.Queue[ClTask]" = queue.Queue()
        self.cruncher = NumberCruncher(Devices([device]), pool.kernel_source)
        if pool.fine_grained_queue_control:
            self.cruncher.fine_grained_queue_control = True
        self.tasks_done = 0
        # the deepest marker-observed in-flight depth the throttle saw
        self.max_inflight_seen = 0
        self._halt = threading.Event()

    def _throttle(self) -> None:
        """Wait, in 0.5 ms steps, while this lane's markers remaining reach
        the pool's ``queue_limit``; ends on halt."""
        if not self.pool.fine_grained_queue_control:
            return
        while not self._halt.is_set():
            depth = self.cruncher.count_markers_remaining()
            self.max_inflight_seen = max(self.max_inflight_seen, depth)
            if depth < self.pool.queue_limit:
                return
            time.sleep(0.0005)

    def run(self) -> None:
        while not self._halt.is_set():
            self._throttle()
            # claim up to the adaptive depth a wake (the reference's
            # pool-progress rule keeps the tail spread over the lanes)
            batch: list[ClTask] = []
            try:
                batch.append(self.pinned.get_nowait())
            except queue.Empty:
                try:
                    batch.append(self.pool._pipe.get(timeout=0.05))
                except queue.Empty:
                    continue
            while len(batch) < self.pool._adaptive_depth():
                try:
                    batch.append(self.pool._pipe.get_nowait())
                except queue.Empty:
                    break
            for task in batch:
                try:
                    self._throttle()
                    self._execute(task)
                except Exception as e:  # noqa: BLE001 - surfaced by finish()
                    self.pool._fail(e)
                    # one bad task does not stop this lane's later tasks
                    self.cruncher.reset_errors()
                finally:
                    self.pool._done_one()

    def _execute(self, task: ClTask) -> None:
        _tt = TRACER.t0()
        task.compute(self.cruncher)
        TRACER.record("pool-task", _tt, cid=task.compute_id, lane=self.index,
                      tag=(f"task{task.task_id}" if task.tenant is None
                           else f"task{task.task_id}@{task.tenant}"))
        labels = {"lane": self.index}
        if task.tenant is not None:
            labels["tenant"] = task.tenant
        REGISTRY.counter("ck_pool_tasks_total", "device-pool tasks completed", **labels).inc()
        self.tasks_done += 1
        if task.callback is not None:
            task.callback(task)

    def stop(self) -> None:
        self._halt.set()


class ClDevicePool:
    """Greedy batch scheduler over lanes (reference: ClDevicePool): a
    consumer thread and a single-lane cruncher per lane, and a producer
    thread that walks the queued task pools, acts on the control tasks and
    hands compute tasks to the shared pipe.  ``backpressure`` bounds the
    pipe (0: 8 slots a lane), so a storm of tasks cannot queue without
    limit.  ``fine_grained_queue_control`` throttles each lane's claims on
    its queue markers, at ``queue_limit`` markers in flight (at least 1);
    :meth:`max_inflight_depth` is the deepest a lane was seen.  A context
    manager; :meth:`dispose` stops every thread."""

    def __init__(self, devices: Devices, kernel_source,
                 pool_type: PoolType = PoolType.DEVICE_COMPUTE_AT_WILL,
                 max_queues_per_device: int = 4, fine_grained_queue_control: bool = False,
                 queue_limit: int = 8, backpressure: int = 0):
        if pool_type is not PoolType.DEVICE_COMPUTE_AT_WILL:
            raise CekirdeklerError(
                "only DEVICE_COMPUTE_AT_WILL is implemented (the reference's ROUND_ROBIN is "
                "unimplemented there too, ClPipeline.cs:3792-3807)")
        self.kernel_source = kernel_source
        self.max_queues_per_device = max_queues_per_device
        self.fine_grained_queue_control = bool(fine_grained_queue_control)
        self.queue_limit = max(1, int(queue_limit))
        cap = backpressure if backpressure > 0 else 8 * max(1, len(devices))
        self._pipe: "queue.Queue[ClTask]" = queue.Queue(maxsize=cap)
        self._pools: "queue.Queue[ClTaskPool]" = queue.Queue()
        self._errors: list[Exception] = []
        self._inflight = 0
        self._inflight_lock = threading.Condition()
        # appended under _consumers_lock; a read that misses a lane added
        # meanwhile only sizes one claim on the old count
        self._consumers: list[_Consumer] = []
        self._consumers_lock = threading.Lock()
        self._running = threading.Event()
        self._running.set()
        try:
            for d in devices:
                self._add_consumer(d)
        except Exception:
            self.dispose()
            raise
        self._producer = threading.Thread(target=self._produce, daemon=True,
                                          name="ck-devpool-producer")
        self._producer.start()

    def _adaptive_depth(self) -> int:
        """A wake's claim depth from the pool's progress: deep while much
        work remains, one near the tail, so the last tasks spread over the
        lanes (the reference's rule, ClPipeline.cs:4188-4230)."""
        with self._inflight_lock:
            remaining = self._inflight
        n = max(1, len(self._consumers))
        return max(1, min(self.max_queues_per_device, remaining // (2 * n)))

    # -- lanes ---------------------------------------------------------------
    def _add_consumer(self, device: Device) -> None:
        c = _Consumer(self, device, len(self._consumers))
        self._consumers.append(c)
        c.start()

    def add_device(self, device: Device) -> None:
        """Add a lane while pools run (reference: addDevice)."""
        with self._consumers_lock:
            self._add_consumer(device)

    @property
    def num_devices(self) -> int:
        return len(self._consumers)

    def tasks_done_per_device(self) -> list[int]:
        return [c.tasks_done for c in self._consumers]

    def max_inflight_depth(self) -> int:
        """The deepest marker-observed in-flight depth any lane reached:
        with ``fine_grained_queue_control``, at most ``queue_limit`` plus
        one task's markers."""
        return max((c.max_inflight_seen for c in self._consumers), default=0)

    # -- accounting ----------------------------------------------------------
    def _dispatch_one(self) -> None:
        with self._inflight_lock:
            self._inflight += 1

    def _done_one(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1
            self._inflight_lock.notify_all()

    def _fail(self, e: Exception) -> None:
        with self._inflight_lock:
            self._errors.append(e)

    def _drain(self) -> None:
        with self._inflight_lock:
            while self._inflight > 0 and self._running.is_set():
                self._inflight_lock.wait(timeout=0.5)

    # -- producer ------------------------------------------------------------
    def _produce(self) -> None:
        while self._running.is_set():
            try:
                pool = self._pools.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                self._walk(pool)
            finally:
                self._pools.task_done()

    def _walk(self, pool: ClTaskPool) -> None:
        selected: int | None = None
        serial = False
        for task in pool.snapshot():
            tt = task.task_type
            if tt is ClTaskType.DEVICE_SELECT_BEGIN:
                selected = task.select_device
            elif tt is ClTaskType.DEVICE_SELECT_END:
                selected = None
            elif tt is ClTaskType.GLOBAL_SYNCHRONIZATION:
                self._drain()
            elif tt is ClTaskType.SERIAL_MODE_BEGIN:
                serial = True
            elif tt is ClTaskType.SERIAL_MODE_END:
                serial = False
            elif tt is ClTaskType.BROADCAST:
                with self._consumers_lock:
                    targets = list(self._consumers)
                for c in targets:
                    self._dispatch_one()
                    c.pinned.put(task)
                self._drain()
            elif selected is not None:
                with self._consumers_lock:
                    if 0 <= selected < len(self._consumers):
                        self._dispatch_one()
                        self._consumers[selected].pinned.put(task)
                    else:
                        self._fail(CekirdeklerError(
                            f"device_select index {selected} out of range"))
                        continue
                if serial:
                    self._drain()
            else:
                self._dispatch_one()
                while self._running.is_set():
                    try:
                        self._pipe.put(task, timeout=0.05)
                        break
                    except queue.Full:
                        continue
                else:
                    self._done_one()  # disposed while the pipe was full
                if serial:
                    self._drain()

    # -- public API ----------------------------------------------------------
    def enqueue_task_pool(self, pool: ClTaskPool) -> None:
        """Queue a pool to run (reference: enqueueTaskPool)."""
        self._pools.put(pool)

    def finish(self) -> None:
        """Wait until every queued pool has run, and raise the first task
        failure (reference: finish)."""
        self._pools.join()
        self._drain()
        with self._inflight_lock:
            errs, self._errors = self._errors, []
        if errs:
            raise errs[0]

    def dispose(self) -> None:
        """Stop the producer and every consumer (each ends after its task
        in hand), join them (at most 5 s each) and dispose the consumers'
        crunchers."""
        self._running.clear()
        with self._consumers_lock:
            consumers = list(self._consumers)
        for c in consumers:
            c.stop()
        producer = getattr(self, "_producer", None)
        for t in ([producer] if producer is not None else []) + consumers:
            t.join(timeout=5.0)
        for c in consumers:
            c.cruncher.dispose()

    def __enter__(self) -> "ClDevicePool":
        return self

    def __exit__(self, *exc) -> None:
        self.dispose()
