"""Cores — the multi-lane scheduler: split / compute / join with iterative
load balancing, per call or at enqueue-mode sync points.

Counterpart of ``cekirdekler_tpu/core/cores.py`` without its streamed and
pipelined tiers: one :class:`Worker` per lane, per-compute-id range
tables, an equal (or, on a mixed fleet, rate-prior-seeded) first split,
and concurrent per-lane H2D -> ladder launch -> D2H from a thread pool.
``write_all`` ownership, ``repeat_count`` (with ``repeat_sync_kernel``),
``ranges_of``, ``benchmarks_of`` and the performance report are kept.

Two modes, as the reference's:

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

Fused windows (``fused_dispatch``, on by default as in the reference): when
enqueue mode repeats one call (:func:`job_signature`) with its operands
resident and its ranges still, the second call opens a window and every
later one is deferred, a counter increment.  The deferred iterations are
dispatched ``fused_batch`` at a time, and the rest at the next sync point,
as one ``Worker.launch_fused`` per lane on the lane's driver: a CUDA-graph
replay on a GPU lane, a host loop on a host lane.  Results are those of
the per-call path bit for bit.  Every refusal and break of a window is
counted by its reason in ``fused_stats["disengaged"]``.  A call that
splits an array otherwise gets another signature, so the window is
dispatched and drained before the re-split flush runs.
:meth:`compute_fused_batch` defers a batch assembled by its caller in one
step.

Not ported yet (queued in ROADMAP.md): streamed transfers, pipelines,
drains, the barrier's health, drain, flight and decision hooks, the fence
split, the verify gate, ``no_compute_mode``, ``dispatch_gate``,
``trace_lanes``, and the metrics/trace/obs hooks.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack, nullcontext
from dataclasses import dataclass, field
from typing import Any, Sequence

from ..arrays.clarray import ClArray
from ..errors import ComputeValidationError, FusedBatchError
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

__all__ = ["Cores", "ComputePerf", "job_signature"]


def job_signature(kernel_names, params, compute_id, global_range, local_range,
                  global_offset, value_args) -> tuple:
    """Identity of one repeatable enqueue call, the fused window's key
    (reference ``job_signature``, shared there with the serving tier's
    request grouping).  Params enter by object identity: a lane's buffers
    are keyed by ``id(arr)``."""
    if isinstance(value_args, dict):
        vals: Any = tuple((k, tuple(v)) for k, v in sorted(value_args.items()))
    else:
        vals = tuple(value_args)
    return (compute_id, tuple(kernel_names), tuple(id(p) for p in params),
            global_range, local_range, global_offset, vals)


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


@dataclass
class _FusedRun:
    """An open fused window: the signature deferrals match, and what its
    dispatch needs."""

    sig: tuple
    compute_id: int
    kernel_names: tuple
    params: tuple
    value_args: Any
    local_range: int
    global_range: int
    step: int
    # per active lane: (worker, global offset, range size)
    rows: list = field(default_factory=list)
    # (worker, coverage epoch) at engage: a reset since breaks the window
    epochs: list = field(default_factory=list)


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
        self.repeat_sync_kernel: str | None = None
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
        # fused windows: the iterations one dispatch carries at most, and the
        # closures a lane's driver may hold
        self.fused_dispatch = True
        self.fused_batch = 16
        self.fused_queue_depth = 2
        # the open window: written under _lock, read without it by compute()'s
        # fast path and checked again under it by _fused_defer
        self._fused_sig: tuple | None = None
        self._fused_run: _FusedRun | None = None
        # the last per-call signature: a window opens on a consecutive repeat
        self._fused_candidate: tuple | None = None
        self._fused_pending = 0
        # serializes [take the pending count + submit to the drivers] against
        # a close, so no drain can slip between them
        self._fused_mu = threading.Lock()
        self.fused_stats: dict[str, Any] = {
            "windows": 0, "fused_iters": 0, "deferred_iters": 0, "disengaged": {}}

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
        t_start = time.perf_counter()
        # the fused fast path: a call matching the open window is a counter
        # increment (the engaging call validated the same signature)
        if self.enqueue_mode and self._fused_sig is not None and not pipeline:
            sig = job_signature(kernel_names, params, compute_id, global_range,
                                local_range, global_offset, value_args)
            if self._sig_equal(sig, self._fused_sig):
                run = self._fused_run
                # the mode toggles are cruncher state, not call identity
                if not self.fused_dispatch or self.repeat_count > 1 or self.repeat_sync_kernel:
                    with self._lock:
                        self._fused_candidate = None
                    self._fused_break("mode-change")
                elif compute_id in self._enqueue_rebalance:
                    self._fused_break("range-change")
                elif run is not None and any(w.coverage_epoch != ep for w, ep in run.epochs):
                    self._fused_break("non-resident")
                elif self._fused_defer(t_start):
                    return
            else:
                self._fused_break("signature-change")
        elif self._fused_sig is not None and not self.enqueue_mode:
            self._fused_break("enqueue-off")
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
        if self.enqueue_mode and self.fused_dispatch:
            self._fused_try_engage(kernel_names, params, compute_id, global_range,
                                   local_range, global_offset, value_args, ranges, refs, step)

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
                 local_range, global_range, local_range, repeats=self.repeat_count,
                 sync_kernel=self.repeat_sync_kernel)
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
        its readbacks become deferred records for :meth:`flush`.  The buffers
        and the upload coverage are settled here, before the work is queued
        (a host lane runs it later, in order), so the next call, and a fused
        window's engage check, see what this call uploads."""
        single = self.num_devices == 1
        repeats, sync = self.repeat_count, self.repeat_sync_kernel
        uploads = []
        with w.on_stream():
            for p in params:
                w.ensure_resident(p)
                fl = p.flags
                if fl.read and not fl.write_only:
                    epw = fl.elements_per_work_item
                    full = single or not fl.partial_read
                    if not w.upload_covers(p, 0 if full else offset * epw,
                                           p.size if full else size * epw):
                        uploads.append((p, offset * epw, size * epw, full))
                        w.claim_upload(p, offset * epw, size * epw, full)

        def work() -> None:
            for p, lo, n, full in uploads:
                w.upload(p, lo, n, full)
            w.launch(self.program, kernel_names, params, value_args, offset, size,
                     local_range, global_range, local_range, repeats=repeats,
                     sync_kernel=sync)

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

    # -- fused windows (reference: the enqueue dispatch-floor collapse) -----
    @staticmethod
    def _sig_equal(a: tuple | None, b: tuple | None) -> bool:
        """Signature equality where a comparison that raises (array-valued
        value args) is a mismatch."""
        if a is None or b is None:
            return False
        try:
            return bool(a == b)
        except Exception:  # noqa: BLE001 - a mismatch by definition
            return False

    def _fused_try_engage(self, kernel_names, params, compute_id, global_range, local_range,
                          global_offset, value_args, ranges, refs, step) -> None:
        """Open a window for this call's signature when it repeats the last
        per-call signature, or count by name why not."""
        sig = job_signature(kernel_names, params, compute_id, global_range, local_range,
                            global_offset, value_args)
        with self._lock:
            candidate, self._fused_candidate = self._fused_candidate, sig
        if not self._sig_equal(sig, candidate):
            return
        reason = None
        if self.repeat_count > 1 or self.repeat_sync_kernel:
            # each call runs its repeats as one dispatch already
            reason = "repeat-mode"
        else:
            try:
                hash(sig)
            except TypeError:
                reason = "unhashable-values"
        rows: list = []
        epochs: list = []
        if reason is None:
            single = self.num_devices == 1
            covered = True
            for i, w in enumerate(self.workers):
                if ranges[i] <= 0:
                    continue
                off = global_offset + refs[i]
                rows.append((w, off, ranges[i]))
                epochs.append((w, w.coverage_epoch))
                for p in params:
                    fl = p.flags
                    if fl.read and not fl.write_only:
                        epw = fl.elements_per_work_item
                        full = single or not fl.partial_read
                        covered &= w.upload_covers(p, 0 if full else off * epw,
                                                   p.size if full else ranges[i] * epw)
            if not covered:
                # a deferral must be a pure launch, with no upload to repeat
                reason = "partial-upload"
        if reason is not None:
            self._note_disengage(reason)
            return
        run = _FusedRun(sig=sig, compute_id=compute_id, kernel_names=tuple(kernel_names),
                        params=tuple(params), value_args=value_args, local_range=local_range,
                        global_range=global_range, step=step, rows=rows, epochs=epochs)
        # the fused ladder and every chunk's launcher are built here, once per
        # key, and not in the window's first dispatch
        for platform in {w.device.type for w, _off, _size in rows}:
            self.program.fused_launcher(run.kernel_names, step, global_range, local_range,
                                        global_range, value_args, platform=platform)
        with self._lock:
            self._fused_sig = sig
            self._fused_run = run

    def _fused_defer(self, t_start: float) -> bool:
        """Count this call into the open window; False when it closed
        meanwhile (the caller takes the per-call path)."""
        with self._lock:
            run = self._fused_run
            if run is None or self._fused_sig is None:
                return False
            self._note_enqueue_call(run.compute_id, t_start)
            self._fused_pending += 1
            pending = self._fused_pending
            self.fused_stats["deferred_iters"] += 1
        if pending >= max(1, int(self.fused_batch)):
            self._fused_flush()
        self.last_compute_id = run.compute_id
        return True

    def _dispatch_fused(self, run: _FusedRun, iters: int) -> None:
        """Queue one ``iters``-iteration dispatch per active lane on the
        lanes' drivers.  Every lane is checked for a held failure before any
        is given the batch; a failure poisons the window, so a caller that
        catches it cannot defer into it."""
        t0 = time.perf_counter()
        try:
            for w, _off, _size in run.rows:
                w.dispatch_preflight()
            for w, off, size in run.rows:
                w.dispatch_async(
                    lambda w=w, off=off, size=size: w.launch_fused(
                        self.program, run.kernel_names, run.params, run.value_args, off, size,
                        run.local_range, run.global_range, run.step, iters),
                    depth=self.fused_queue_depth)
        except Exception:
            with self._lock:
                self._fused_sig = None
                self._fused_run = None
                self._fused_candidate = None
            raise
        with self._lock:
            self.fused_stats["windows"] += 1
            self.fused_stats["fused_iters"] += iters
        self._record_perf(run.compute_id, t0, self.global_ranges.get(run.compute_id, []))

    def _fused_flush(self) -> None:
        """Dispatch the deferred iterations; the window stays open."""
        with self._fused_mu:
            with self._lock:
                run, k = self._fused_run, self._fused_pending
                self._fused_pending = 0
            if run is not None and k > 0:
                self._dispatch_fused(run, k)

    def _fused_close(self) -> None:
        """End the window at a sync point: dispatch the rest and drain every
        lane's driver (the dispatches are queued; the fence waits for them)."""
        with self._fused_mu:
            with self._lock:
                run, k = self._fused_run, self._fused_pending
                self._fused_pending = 0
                self._fused_sig = None
                self._fused_run = None
            if run is not None and k > 0:
                self._dispatch_fused(run, k)
        self._fused_drain()

    def _note_disengage(self, reason: str) -> None:
        with self._lock:
            d = self.fused_stats["disengaged"]
            d[reason] = d.get(reason, 0) + 1

    def _fused_break(self, reason: str) -> None:
        """Close the window and count why."""
        self._fused_close()
        self._note_disengage(reason)

    def _fused_drain(self) -> None:
        errs = []
        for w in self.workers:
            try:
                w.drain_dispatch()
            except Exception as e:  # noqa: BLE001 - raised after every lane
                errs.append(e)
        if errs:
            raise errs[0]

    def _batch_defer(self, sig: tuple, k: int, t_start: float) -> bool:
        """Count ``k`` iterations into the open window matching ``sig`` in one
        step and dispatch them; False when no such window is open or a
        deferral would break it."""
        with self._lock:
            run = self._fused_run
            if (run is None or not self._sig_equal(self._fused_sig, sig)
                    or not self.fused_dispatch or self.repeat_count > 1
                    or self.repeat_sync_kernel or run.compute_id in self._enqueue_rebalance
                    or any(w.coverage_epoch != ep for w, ep in run.epochs)):
                return False
            cid = run.compute_id
            self._note_enqueue_call(cid, t_start)
            self._enqueue_iters[cid] += k - 1
            self._flush_iters[cid] += k - 1
            self._fused_pending += k
            self.fused_stats["deferred_iters"] += k
        self._fused_flush()
        return True

    def compute_fused_batch(self, kernel_names: Sequence[str], params: Sequence[ClArray],
                            compute_id: int, global_range: int, local_range: int, iters: int,
                            global_offset: int = 0, value_args: Sequence | dict = ()) -> dict:
        """Dispatch ``iters`` identical enqueue iterations assembled by the
        caller (the serving tier's entry): the first one or two ride
        :meth:`compute` until a window is open, the rest go into it as one
        dispatch per lane.  Bit for bit ``iters`` per-call computes; where a
        window cannot open, every iteration is a per-call compute.  Needs
        :attr:`enqueue_mode`.  Returns ``{"iters", "fused", "ladder_iters",
        "per_call_iters"}``.  A failure raises :class:`FusedBatchError` with
        the iterations applied before it; its residue is never ``clean``
        here (the port has no fault injection, whose preflight refusals are
        the clean ones)."""
        iters = int(iters)
        if iters < 1:
            raise ComputeValidationError(f"compute_fused_batch needs iters >= 1, got {iters}")
        if not self.enqueue_mode:
            raise ComputeValidationError(
                "compute_fused_batch requires enqueue_mode (deferred readbacks are the "
                "batch contract)")
        sig = job_signature(kernel_names, params, compute_id, global_range, local_range,
                            global_offset, value_args)
        done = ladder = 0
        try:
            while done < iters:
                if self._batch_defer(sig, iters - done, time.perf_counter()):
                    ladder = iters - done
                    done = iters
                    break
                self.compute(kernel_names, params, compute_id, global_range, local_range,
                             global_offset=global_offset, value_args=value_args)
                done += 1
        except Exception as e:
            raise FusedBatchError(cause=type(e).__name__, applied_iters=done,
                                  requested_iters=iters, clean=False, original=e) from e
        return {"iters": iters, "fused": ladder > 0, "ladder_iters": ladder,
                "per_call_iters": iters - ladder}

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
        """Read back everything deferred by enqueue mode and wait for it; an
        open fused window is dispatched and drained first."""
        self._fused_close()
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
        ``_lock``, as in :meth:`_enqueue_phase`.  An open fused window is
        dispatched and drained first."""
        self._fused_close()
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
        rebalance on their next call.  An open fused window is dispatched and
        drained first, so the fences cover it.  A dispatch or fence failure
        is raised after every lane has been fenced; the window closes either
        way."""
        n = self.num_devices
        errs: list[Exception] = []
        try:
            try:
                self._fused_close()
            except Exception as e:  # noqa: BLE001 - the lanes are fenced all the same
                errs.append(e)
            with self._lock:
                t0 = self._enqueue_t0
                window_cids = set(self._enqueue_cids)
                window_iters = dict(self._enqueue_iters)
            measure = self.enqueue_mode and t0 is not None and n > 1
            done_at: dict[int, float] = {}

            def fence_timed(w: Worker) -> None:
                w.fence()
                done_at[w.index] = time.perf_counter()

            if n == 1:
                fences = [self.workers[0].fence]
            else:
                fences = [self.pool.submit(fence_timed, w).result for w in self.workers]
            for wait in fences:
                try:
                    wait()
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
