"""Cores — the multi-lane scheduler: split / compute / join with iterative
load balancing, per call or at enqueue-mode sync points.

Counterpart of ``cekirdekler_tpu/core/cores.py`` without its fused,
streamed and pipelined tiers: one :class:`Worker` per lane, per-compute-id
range tables, an equal (or, on a mixed fleet, rate-prior-seeded) first
split, and concurrent per-lane H2D -> ladder launch -> D2H from a thread
pool.  ``write_all`` ownership, ``repeat_count``, ``ranges_of``,
``benchmarks_of`` and the performance report are kept.

Two modes, as the reference's with ``fused_dispatch=False``:

- the plain path rebalances from measured per-lane walls on every call and
  reads every written range back before ``compute()`` returns;
- enqueue mode (``enqueue_mode = True``) dispatches without waiting: a lane
  skips uploads its resident data covers, readbacks are deferred to
  :meth:`flush`, and ranges hold still between syncs.  :meth:`barrier`
  fences every lane concurrently, times each fence from the window's first
  call, feeds those times to the balancer per iteration, and arms a
  one-shot rebalance for each compute id of the window.  When a call
  splits one of its arrays otherwise than that array's last call did (a
  rebalance moved its compute id's ranges, or another compute id splits
  it differently), every deferred readback lands and every lane's upload
  coverage resets first, as one atomic step
  (:meth:`_flush_and_reset_coverage`).  The reference applies that rule
  per compute id only, and loses updates when two ids split one array
  differently in a window (ROADMAP Queue C 8).

Not ported yet (queued in ROADMAP.md): fused windows, streamed transfers,
pipelines, drains, the barrier's health, drain, flight and decision hooks,
the fence split, the verify gate, and the metrics/trace/obs hooks.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack, nullcontext
from dataclasses import dataclass, field
from typing import Sequence

from ..arrays.clarray import ClArray
from ..errors import ComputeValidationError
from ..hardware import Devices, rate_prior
from ..kernel.registry import KernelProgram
from .balance import (
    BalanceHistory,
    BalanceState,
    equal_split,
    load_balance,
    per_iteration_benches,
    prior_split,
)
from .worker import Worker

__all__ = ["Cores", "ComputePerf"]


@dataclass
class ComputePerf:
    """Per-compute-id performance record (reference: performanceReport)."""

    compute_id: int
    device_ms: list[float] = field(default_factory=list)
    device_items: list[int] = field(default_factory=list)
    total_ms: float = 0.0

    def report(self, device_names: list[str]) -> str:
        lines = [f"compute id {self.compute_id}: total {self.total_ms:.3f} ms"]
        tot = sum(self.device_items) or 1
        for name, ms, it in zip(device_names, self.device_ms, self.device_items):
            lines.append(
                f"  {name}: {ms:8.3f} ms  {it:>10} workitems  load {100.0 * it / tot:5.1f}%")
        return "\n".join(lines)


class Cores:
    """Scheduler over the selected lanes."""

    def __init__(self, devices: Devices, program: KernelProgram):
        devices.require_nonempty("Cores device selection")
        self.devices = devices
        self.program = program
        self.workers = [Worker(d.torch_device, i) for i, d in enumerate(devices)]
        # each lane's kind and its table-derived rate prior: a mixed
        # GPU + host-CPU fleet seeds its first split from these
        self.lane_kinds: list[str] = [d.kind for d in devices]
        self.rate_priors: list[float] = [rate_prior(k) for k in self.lane_kinds]
        self.pool = ThreadPoolExecutor(max_workers=max(1, len(self.workers)))
        self.global_ranges: dict[int, list[int]] = {}
        self.histories: dict[int, BalanceHistory] = {}
        self._balance_states: dict[int, BalanceState] = {}
        self.perf: dict[int, ComputePerf] = {}
        self.repeat_count = 1
        self.last_compute_id: int | None = None
        self.enqueue_mode = False
        # guards the enqueue window state below; taken after a worker lock,
        # never before one
        self._lock = threading.Lock()
        # deferred readbacks: (seq, worker, array, offset, size, write_all, cid)
        self._enqueued: list[tuple] = []
        self._enqueue_seq = 0
        # per-cid calls since the last flush: the drain's per-iteration divisor
        self._flush_iters: dict[int, int] = {}
        # the window since the last barrier: its first call's time, its
        # compute ids, their call counts, and the ids a barrier armed to
        # rebalance on their next call
        self._enqueue_t0: float | None = None
        self._enqueue_cids: set[int] = set()
        self._enqueue_iters: dict[int, int] = {}
        self._enqueue_rebalance: set[int] = set()
        # id(array) -> (global offset, ranges) of the array's last call: where
        # its freshest data lives on the lanes
        self._splits: dict[int, tuple] = {}

    @property
    def num_devices(self) -> int:
        return len(self.workers)

    def device_names(self) -> list[str]:
        return [d.name for d in self.devices]

    # -- range tables --------------------------------------------------------
    def _skewed_priors(self) -> list[float] | None:
        """The lane rate priors, or None on a homogeneous fleet."""
        pr = self.rate_priors
        if pr and len(pr) == self.num_devices and len(set(float(p) for p in pr)) > 1:
            return [float(p) for p in pr]
        return None

    def _ranges_for(self, compute_id: int, total: int, step: int,
                    rebalance: bool) -> tuple[list[int], list[int]]:
        n = self.num_devices
        ranges = self.global_ranges.get(compute_id)
        if ranges is None or sum(ranges) != total or len(ranges) != n:
            priors = self._skewed_priors()
            if priors is not None and n > 1:
                ranges = prior_split(total, step, priors, cid=compute_id)
            else:
                ranges = equal_split(total, n, step)
        elif rebalance and n > 1:
            bench = [w.benchmarks.get(compute_id, 0.0) for w in self.workers]
            if all(b > 0 for b in bench):
                hist = self.histories.setdefault(compute_id, BalanceHistory(weighted=True))
                state = self._balance_states.setdefault(compute_id, BalanceState())
                # each lane's share of the enqueue flush's D2H drain floors
                # its cost; the plain path measures none (its H2D/D2H are
                # inside the bench)
                transfer = [w.transfer_benchmarks.get(compute_id, 0.0) for w in self.workers]
                ranges = load_balance(bench, ranges, total, step, hist, state=state,
                                      transfer_ms=transfer if any(transfer) else None,
                                      jump_start=True, cid=compute_id,
                                      rate_prior=self._skewed_priors())
        self.global_ranges[compute_id] = ranges
        refs, acc = [], 0
        for r in ranges:
            refs.append(acc)
            acc += r
        return ranges, refs

    # -- main entry (reference: Cores.compute) -------------------------------
    def compute(self, kernel_names: Sequence[str], params: Sequence[ClArray],
                compute_id: int, global_range: int, local_range: int,
                global_offset: int = 0, pipeline: bool = False,
                pipeline_blobs: int = 4, value_args: Sequence | dict = ()) -> None:
        for name in kernel_names:
            if name not in self.program:
                raise ComputeValidationError(
                    f"kernel {name!r} not in program; available: {self.program.kernel_names}")
            need = self.program.value_param_names(name)
            given = (len(value_args.get(name, ())) if isinstance(value_args, dict)
                     else len(tuple(value_args)))
            if need and given != len(need):
                raise ComputeValidationError(
                    f"kernel {name!r} takes {len(need)} scalar value argument(s) "
                    f"{need} but {given} given — pass values=(...) to compute()")
        if pipeline:
            raise ComputeValidationError(
                "pipelined compute is not ported yet (cekirdekler_tpu_torch runs "
                "the plain path; see ROADMAP.md)")
        step = local_range
        if global_range % step != 0:
            raise ComputeValidationError(
                f"global_range ({global_range}) must be divisible by step ({step})")
        t_start = time.perf_counter()
        if self.enqueue_mode:
            with self._lock:
                self._note_enqueue_call(compute_id, t_start)
        # enqueue mode cannot rebalance on per-call walls (they time the
        # dispatch only): ranges hold still between syncs and move on the
        # first call after a barrier, from its fence times
        ranges, refs = self._ranges_for(
            compute_id, global_range, step,
            rebalance=not self.enqueue_mode or compute_id in self._enqueue_rebalance)
        split = (global_offset, tuple(ranges))
        with self._lock:
            self._enqueue_rebalance.discard(compute_id)
            moved = any(self._splits.get(id(p), split) != split for p in params)
            self._splits.update((id(p), split) for p in params)
        if self.enqueue_mode and moved:
            # the freshest data of a re-split region is on its previous
            # owner: land every deferred readback and make every lane
            # re-fetch before any lane uploads its new range
            self._flush_and_reset_coverage()
        # a lane whose share was quantized to zero never re-runs its bench;
        # decay its stale measurement so one slow call cannot starve it
        for i, w in enumerate(self.workers):
            if ranges[i] > 0:
                continue
            with w.lock:
                if w.benchmarks.get(compute_id, 0.0) > 0.0:
                    w.benchmarks[compute_id] *= 0.5
                if w.transfer_benchmarks.get(compute_id, 0.0) > 0.0:
                    w.transfer_benchmarks[compute_id] *= 0.5
        # write_all owner: "device i writes array (i mod numDevices)", among
        # the lanes that actually run
        active = [i for i in range(self.num_devices) if ranges[i] > 0]
        write_all_owner = {idx: active[idx % len(active)]
                           for idx, p in enumerate(params) if p.flags.write_all and active}
        futures = [
            self.pool.submit(self._run_worker, w, kernel_names, params, compute_id,
                             global_offset + refs[i], ranges[i], local_range,
                             global_range, value_args, write_all_owner)
            for i, w in enumerate(self.workers) if ranges[i] > 0
        ]
        errs = []
        for f in futures:
            try:
                f.result()
            except Exception as e:  # surface the first lane error
                errs.append(e)
        if errs:
            raise errs[0]
        self._record_perf(compute_id, t_start, ranges)

    def _note_enqueue_call(self, compute_id: int, t_start: float) -> None:
        """Window bookkeeping of one enqueued call.  Caller holds ``_lock``."""
        if self._enqueue_t0 is None:
            self._enqueue_t0 = t_start
        self._enqueue_cids.add(compute_id)
        self._enqueue_iters[compute_id] = self._enqueue_iters.get(compute_id, 0) + 1
        self._flush_iters[compute_id] = self._flush_iters.get(compute_id, 0) + 1

    def _run_worker(self, w: Worker, kernel_names, params, compute_id, offset, size,
                    local_range, global_range, value_args, write_all_owner) -> None:
        with w.lock:
            w.start_bench(compute_id)
            try:
                if self.enqueue_mode:
                    self._enqueue_phase(w, kernel_names, params, compute_id, offset, size,
                                        local_range, global_range, value_args,
                                        write_all_owner)
                    return
                if w.stream is None:
                    w.fence()  # work a host lane queued in enqueue mode runs first
                with w.on_stream():
                    self._phase(w, kernel_names, params, offset, size, local_range,
                                global_range, value_args, write_all_owner)
            finally:
                w.end_bench(compute_id)

    def _phase(self, w: Worker, kernel_names, params, offset, size, local_range,
               global_range, value_args, write_all_owner) -> None:
        single = self.num_devices == 1
        for p in params:
            fl = p.flags
            if fl.read and not fl.write_only:
                epw = fl.elements_per_work_item
                w.upload(p, offset * epw, size * epw, single or not fl.partial_read)
            else:
                w.ensure_resident(p)
        w.launch(self.program, kernel_names, params, value_args, offset, size,
                 local_range, global_range, local_range, repeats=self.repeat_count)
        for idx, p in enumerate(params):
            fl = p.flags
            if not (fl.write and not fl.read_only):
                continue
            epw = fl.elements_per_work_item
            if fl.write_all:
                if w.index == write_all_owner.get(idx):
                    w.download(p, 0, p.size, True)
            else:
                covers = offset == 0 and size * epw == p.size
                full = single and not any(q.flags.partial_read for q in params) and covers
                w.download(p, offset * epw, size * epw, full)
        # the bench covers the whole phase
        w.fence()

    def _enqueue_phase(self, w: Worker, kernel_names, params, compute_id, offset, size,
                       local_range, global_range, value_args, write_all_owner) -> None:
        """Issue one lane's share of an enqueued call without waiting for it:
        uploads the lane's resident data does not cover, then the launches;
        its readbacks become deferred records for :meth:`flush`."""
        single = self.num_devices == 1
        repeats = self.repeat_count

        def work() -> None:
            for p in params:
                fl = p.flags
                if fl.read and not fl.write_only:
                    epw = fl.elements_per_work_item
                    full = single or not fl.partial_read
                    if not w.upload_covers(p, 0 if full else offset * epw,
                                           p.size if full else size * epw):
                        w.upload(p, offset * epw, size * epw, full)
                else:
                    w.ensure_resident(p)
            w.launch(self.program, kernel_names, params, value_args, offset, size,
                     local_range, global_range, local_range, repeats=repeats)

        w.issue(work)
        for idx, p in enumerate(params):
            fl = p.flags
            if not (fl.write and not fl.read_only):
                continue
            # write_all: only the owning lane defers a readback
            if not fl.write_all or w.index == write_all_owner.get(idx):
                with self._lock:
                    self._enqueue_seq += 1
                    self._enqueued.append((self._enqueue_seq, w, p, offset, size,
                                           fl.write_all, compute_id))

    def _record_perf(self, compute_id: int, t_start: float, ranges: list[int]) -> None:
        perf = ComputePerf(
            compute_id=compute_id,
            device_ms=[w.benchmarks.get(compute_id, 0.0) for w in self.workers],
            device_items=list(ranges),
            total_ms=(time.perf_counter() - t_start) * 1000.0,
        )
        self.perf[compute_id] = perf
        self.last_compute_id = compute_id

    # -- enqueue-mode sync (reference: flushLastUsedCommandQueue / finish) ----
    @staticmethod
    def _latest_records(pending) -> list[tuple]:
        """Most recent record per (worker, array), in chronological order
        (by sequence tag)."""
        latest: dict[tuple[int, int], tuple] = {}
        for rec in pending:
            key = (id(rec[1]), id(rec[2]))
            cur = latest.get(key)
            if cur is None or rec[0] > cur[0]:
                latest[key] = rec
        return sorted(latest.values(), key=lambda r: r[0])

    def _start_deferred_downloads(self, pending, lock_each: bool) -> list:
        """Start the D2H of the newest record per (worker, array), in
        chronological order.  Between two flushes an array keeps one split
        (a re-split flushes first), so the lanes' records of one array do
        not overlap.  ``lock_each`` takes each worker's lock per record
        (:meth:`flush`; the atomic rebalance flush already holds them
        all).  Returns ``(handle, worker, cid)`` entries."""
        handles = []
        for _, w, p, offset, size, write_all, cid in self._latest_records(pending):
            epw = p.flags.elements_per_work_item
            lo, n = (0, p.size) if write_all else (offset * epw, size * epw)
            with (w.lock if lock_each else nullcontext()):
                handles.append((w.download_async(p, lo, n, write_all), w, cid))
        return handles

    def _finish_deferred(self, entries, iters: dict[int, int]) -> None:
        """Wait for the flush's D2H copies in issue order, timing each
        (lane, cid)'s share of the drain, per iteration since the last
        flush, into ``Worker.transfer_benchmarks``: in steady enqueue state
        a lane's bench holds no transfer (uploads covered, downloads
        deferred), so a slow link shows only here."""
        acc: dict[tuple[Worker, int], float] = {}
        for h, w, cid in entries:
            t0 = time.perf_counter()
            Worker.finish_download(h)
            acc[(w, cid)] = acc.get((w, cid), 0.0) + (time.perf_counter() - t0)
        for (w, cid), s in acc.items():
            with w.lock:
                w.transfer_benchmarks[cid] = s / max(1, iters.get(cid, 1)) * 1000.0

    def flush(self) -> None:
        """Read back everything deferred by enqueue mode and wait for it."""
        with self._lock:
            pending, self._enqueued = self._enqueued, []
            flush_iters, self._flush_iters = self._flush_iters, {}
        self._finish_deferred(self._start_deferred_downloads(pending, lock_each=True),
                              flush_iters)

    def _flush_and_reset_coverage(self) -> None:
        """The re-split flush: read back every deferred record and reset
        every lane's upload coverage as one step under all worker locks.  Another host thread's enqueued call is then either before
        it (its record is collected here) or after it (it sees reset
        coverage and a host made current): a re-upload can never miss
        that thread's own updates.  Lock order: worker locks, then
        ``_lock``, as in :meth:`_enqueue_phase`."""
        with ExitStack() as stack:
            for w in self.workers:
                stack.enter_context(w.lock)
            with self._lock:
                pending, self._enqueued = self._enqueued, []
                flush_iters, self._flush_iters = self._flush_iters, {}
            self._finish_deferred(self._start_deferred_downloads(pending, lock_each=False),
                                  flush_iters)
            for w in self.workers:
                w.reset_coverage()

    def barrier(self) -> None:
        """Block until all dispatched work has retired, without reading
        results back (the enqueue-mode sync point; the reference's finish()
        on the used queues).

        The lanes are fenced concurrently.  In enqueue mode on more than one
        lane, each lane's fence-retire time since the window's first call
        becomes its bench, per iteration (``per_iteration_benches``), for
        every compute id it ran in the window, and those ids are armed to
        rebalance on their next call.  A fence failure is raised after every
        lane has been fenced; the window closes either way."""
        with self._lock:
            t0 = self._enqueue_t0
            window_cids = set(self._enqueue_cids)
            window_iters = dict(self._enqueue_iters)
        n = self.num_devices
        measure = self.enqueue_mode and t0 is not None and n > 1
        try:
            if n == 1:
                self.workers[0].fence()
                return
            done_at: dict[int, float] = {}

            def fence_timed(w: Worker) -> None:
                w.fence()
                done_at[w.index] = time.perf_counter()

            errs = []
            for f in [self.pool.submit(fence_timed, w) for w in self.workers]:
                try:
                    f.result()
                except Exception as e:
                    errs.append(e)
            if errs:
                raise errs[0]
            if measure:
                for w in self.workers:
                    bench = (done_at[w.index] - t0) * 1000.0
                    window_ms = {cid: bench for cid in window_cids
                                 if self.global_ranges.get(cid, [1] * n)[w.index] > 0}
                    with w.lock:
                        w.benchmarks.update(per_iteration_benches(window_ms, window_iters))
                with self._lock:
                    self._enqueue_rebalance |= window_cids
        finally:
            self._enqueue_window_closed()

    def _enqueue_window_closed(self) -> None:
        with self._lock:
            self._enqueue_cids.clear()
            self._enqueue_iters.clear()
            self._enqueue_t0 = None

    # -- reporting -----------------------------------------------------------
    def performance_report(self, compute_id: int | None = None) -> str:
        cid = compute_id if compute_id is not None else self.last_compute_id
        if cid is None or cid not in self.perf:
            return "(no compute has run)"
        return self.perf[cid].report(self.device_names())

    def benchmarks_of(self, compute_id: int) -> list[float]:
        return [w.benchmarks.get(compute_id, 0.0) for w in self.workers]

    def ranges_of(self, compute_id: int) -> list[int]:
        return list(self.global_ranges.get(compute_id, []))

    def dispose(self) -> None:
        """Dispose every lane, then raise the first failure a lane's last
        fence surfaced."""
        errs = []
        for w in self.workers:
            try:
                w.dispose()
            except Exception as e:  # every lane is released before raising
                errs.append(e)
        self.pool.shutdown(wait=False)
        if errs:
            raise errs[0]
