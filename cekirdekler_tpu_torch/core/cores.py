"""Cores — the multi-lane scheduler: split / compute / join with iterative
load balancing, per call or at enqueue-mode sync points.

Counterpart of ``cekirdekler_tpu/core/cores.py``: one :class:`Worker`
per lane, per-compute-id range tables, an equal (or, on a mixed fleet,
rate-prior-seeded) first split, and concurrent per-lane H2D -> ladder
launch -> D2H from a thread pool.  ``write_all``
ownership, ``repeat_count`` (with ``repeat_sync_kernel``), ``ranges_of``,
``benchmarks_of``, the performance report and its history
(:meth:`performance_history`, printed per call with ``performance_feed``)
are kept, and so are the balancer's toggles: ``fixed_compute_powers``
(the cruncher's ``normalized_compute_powers_of_devices``) pins the split,
``adaptive_load_balancer`` (default True; False is the reference's fixed
damping) and ``smooth_load_balancer`` (default True).  ``no_compute_mode``
makes a call move its data and launch nothing.

Two modes, as the reference's:

- the plain path rebalances from measured per-lane benches on every call
  and reads every written range back before ``compute()`` returns.  A
  lane's bench is its wall, except a GPU lane's on the monolithic path:
  there it is its stream's device span (``Worker.end_issue``), and in a
  call that also runs host lanes the GPU lanes issue their work before
  the host lanes start.  The reference times every lane by its wall;
  here a host lane's lowered kernels hold the interpreter lock between
  their torch calls, and a GPU lane issuing or returning from its fence
  beside one waits for it;
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

Streamed partition transfers (``streamed_transfers``, on by default as in
the reference; :meth:`_run_streamed`): a lane's range is cut into
``step * 2^k`` chunks (``core/stream.chunk_plan``), its partition uploads
are staged chunk by chunk ahead of the first kernel's chunk launches, and
its downloads issued behind the last kernel's, so a chunk's copies overlap
other chunks' kernels; the kernel sequence stays kernel-major, so results
are the monolithic path's bit for bit.  The chunk count is
``stream_chunks`` when pinned, else ``transfer_tuner``'s choice from the
lane's measured upload, compute and download times: a key's first call is
a monolithic measuring run that fences between the phases.  The enqueue
flush drains a large record in chunks too.  ``last_stream_chunks`` holds
each lane's last choice.

Pipelined compute (``compute(pipeline=True, pipeline_blobs=n,
pipeline_type=PIPELINE_EVENT | PIPELINE_DRIVER)``; :meth:`_run_pipelined`):
a lane's range is cut into ``n`` blobs whose copies overlap other blobs'
kernels, by the reference's two engines: EVENT stages blob ``j`` while
blob ``j - pipeline_lookahead`` computes and blob ``j -
pipeline_lookahead - 1`` is read back, on the lane's copy streams ordered
by CUDA events; DRIVER runs blob ``k``'s copies and kernels in order on
the lane's stream ``k mod 16``.  The balancer's step is then
``local_range * n``.  A pipelined call closes a fused window (the reason
``pipeline``) and never opens one.

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

The reference's hooks are at its sites: the lanes' rate-prior gauges; on a
range-table change a ``split``/``rebalance`` span, a ``rebalance`` flight
event and the balancer's counters and share gauges; an ``enqueue`` span
per call; ``record_crash`` when a call, a drain or a barrier fails (a
postmortem only under ``CK_POSTMORTEM_DIR``); the fused path's cached
counters (a deferral adds one increment), ``fused-engage`` /
``fused-disengage`` flight events and decision records and its spans; the
streamed phase's ``stream-choice`` event, chunk-count gauge and
``pipeline-stage`` span (the pipelined engines' too, with
``ck_pipeline_stages_total`` by engine and the lane's device type); and
the barrier's ``fence`` span, ``barrier`` flight event,
``ck_barrier_seconds`` histogram, the ``lane-stall`` fault site and the
decision log's spill.  With :attr:`fence_split` on, a barrier
fences each compute id of a mixed window in last-dispatch order
(``Worker.fence_cid``) and feeds the balancer marginal per-id times
(``trace/attribution.split_fence_benches``).

Lane health and the drain, as the reference's: a :class:`HealthMonitor`
(:attr:`health`, :meth:`health_report`) takes each lane's fence wall per
iteration at every multi-lane enqueue barrier (a quarantined lane's
left out), each plain-path phase's transfer wall, the enqueue flush's
per-iteration drain wall and the streamed phase's stall per submit; at
every barrier's end a :class:`DrainController` (:attr:`drain`, on by
default) moves its lanes' quarantine state, ``_ranges_for`` masks every
range table with it (``apply_quarantine``) and a move arms a re-split of
every compute id.  ``trace_lanes`` records each lane's dispatch and join
times of a per-call phase in ``lane_trace`` and keeps the call off the
fused (the reason ``trace-lanes``) and streamed paths.

The kernel verify gate, as the reference's: after the fused-window checks
and before any window bookkeeping, transfer or launch, a call's launch
shape (kernel sequence, each parameter's ``flag_row``, and whether it runs
in a window: enqueue mode or ``repeat_count > 1``) is verified once by
``KernelProgram.verify`` and looked up after that.  Under
``CK_KERNEL_VERIFY`` advisory (the default) an unsafe shape records one
``kernel-verify`` flight event per (kernel sequence, finding); ``strict``
raises :class:`KernelVerifyError` naming the finding; ``off`` skips the
gate.  A deferred fused call does not reach it: the window's engaging call
verified the same shape.  The debug server (``obs/debugserver.py``) starts
at :meth:`serve_debug`, or at the first ``Cores`` of a process when
``CK_DEBUG_PORT`` names a fixed port > 0 (a bad or busy port records a
``debug-port-skipped`` flight event), and closes at :meth:`dispose`.

The compile cache (``core/compilecache.py``), as the reference's:
:meth:`warmup` builds and runs a plan's whole ladders before traffic
(``warm_from_disk`` feeds it the specs kept on disk), a window's
engagement records its spec when ``CK_COMPILE_CACHE`` is set
(:meth:`_cache_record_engaged`), and :meth:`compute_fused_batch` then
reports the batch's cache hits and misses.

The dispatch gate, as the reference's (ClUserEvent.cs with
Worker.cs:487-557's synchronized start): while :attr:`dispatch_gate` holds
a ``utils.events.UserEvent``, every lane of a call waits for it at the top
of :meth:`_run_worker`, before it takes the lane's lock, so a held gate
holds no lock and ``trigger()`` starts the lanes together.  The GPU-first
issue order stays: the caller waits for the GPU lanes' ``issued`` and so
for the gate too, and submits the host lanes after it fires.  A compute
call is therefore issued from another thread than the one that triggers,
as the reference asks.  A set gate keeps enqueue-mode calls off the fused
windows: it breaks an open one (``mode-change``) and refuses to open one
(``dispatch-gate``).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack, nullcontext
from dataclasses import dataclass, field
from typing import Any, Sequence

import torch

from ..analysis import flag_row
from ..arrays.clarray import ClArray
from ..errors import (
    ComputeValidationError,
    FusedBatchError,
    InjectedFaultError,
    KernelVerifyError,
)
from ..hardware import Devices, rate_prior
from ..kernel.build import LaunchCounter
from ..kernel.registry import KernelProgram
from ..metrics.registry import REGISTRY
from ..obs.debugserver import DEBUG_PORT_ENV
from ..obs.decisions import DECISIONS
from ..obs.drain import DrainController, apply_quarantine
from ..obs.flight import FLIGHT, record_crash
from ..obs.health import HealthMonitor
from ..trace.attribution import split_fence_benches
from ..trace.spans import TRACER
from ..utils.faultinject import FAULTS
from .balance import (
    BalanceHistory,
    BalanceState,
    equal_split,
    load_balance,
    per_iteration_benches,
    prior_split,
)
from .compilecache import CACHE as COMPILE_CACHE
from .compilecache import WarmupSpec, probe_counts
from .stream import TransferTuner, chunk_plan
from .worker import PIPE_QUEUES, Worker, _pinned, launch_ladder

__all__ = ["Cores", "ComputePerf", "job_signature", "PIPELINE_DRIVER", "PIPELINE_EVENT",
           "STREAMED"]

PIPELINE_EVENT = 1   # the reference's event pipeline (Cores.cs:1236-1367)
PIPELINE_DRIVER = 2  # its driver pipeline of 16 in-order queues (Cores.cs:1371-1858)

#: streamed lane phases, keyed by their kernel sequence (``"a+b"``): the
#: evidence that a run went through the stream engine
STREAMED = LaunchCounter()


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
        # the compile cache armed at construction, so every library this
        # process builds lands in its library layer, the per-call launches
        # before a window engages included; nothing unless CK_COMPILE_CACHE
        if COMPILE_CACHE.enabled:
            COMPILE_CACHE.arm()
        self.workers = [Worker(d.torch_device, i) for i, d in enumerate(devices)]
        # each lane's kind and its table-derived rate prior: a mixed
        # GPU + host-CPU fleet seeds its first split from these
        self.lane_kinds: list[str] = [d.kind for d in devices]
        self.rate_priors: list[float] = [rate_prior(k) for k in self.lane_kinds]
        for i, kind in enumerate(self.lane_kinds):
            REGISTRY.gauge("ck_lane_rate_prior", "table-derived relative-rate prior per lane",
                           lane=i, ck_lane_kind=kind).set(self.rate_priors[i])
        self.pool = ThreadPoolExecutor(max_workers=max(1, len(self.workers)))
        self.global_ranges: dict[int, list[int]] = {}
        self.histories: dict[int, BalanceHistory] = {}
        self._balance_states: dict[int, BalanceState] = {}
        self._adaptive_load_balancer = True
        # the continuous ranges of the fixed-damping (parity) balancer
        self._cont_ranges: dict[int, list[float]] = {}
        self.perf: dict[int, ComputePerf] = {}
        # the last 64 reports per compute id
        self.perf_log: dict[int, deque] = {}
        self.performance_feed = False
        self.smooth_load_balancer = True
        # normalizedComputePowersOfDevices: shares summing to 1, or None
        self.fixed_compute_powers: list[float] | None = None
        self.repeat_count = 1
        self.repeat_sync_kernel: str | None = None
        # host-gated dispatch: a UserEvent every lane of a call waits for
        self.dispatch_gate = None
        self.last_compute_id: int | None = None
        self.enqueue_mode = False
        # I/O only: a call uploads and downloads and launches nothing
        self.no_compute_mode = False
        # streamed partition transfers: stream_chunks 0 lets the tuner
        # choose, n pins n chunks; stream_queue_depth bounds the chunks
        # staged ahead of the dispatched one (and the staging ring)
        self.streamed_transfers = True
        self.stream_chunks = 0
        self.stream_queue_depth = 2
        # the EVENT engine's read lookahead: blobs staged ahead of the one
        # computing (1 is the reference's three-queue wavefront)
        self.pipeline_lookahead = 2
        self.transfer_tuner = TransferTuner()
        # each lane's chunk count in its last streaming candidate phase
        self.last_stream_chunks: dict[int, int] = {}
        # (lane, tuner key) that ran once: the next first contact measures
        self._tuner_warm: set[tuple] = set()
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
        # the window's compute ids in last-dispatch order (the fence split)
        self._enqueue_cid_order: list[int] = []
        # per-cid fence split at barriers (off by default: one more probe
        # per compute id of a mixed window)
        self._fence_split = False
        # compute_fused_batch preflighted the lanes for this iteration: its
        # streamed submits skip their fault fire
        self._batch_preflighted = False
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
        # re-split flushes in progress (under _lock): no window opens between
        # a re-split's window close and its coverage reset
        self._resplits = 0
        # serializes [take the pending count + submit to the drivers] against
        # a close, so no drain can slip between them
        self._fused_mu = threading.Lock()
        self.fused_stats: dict[str, Any] = {
            "windows": 0, "fused_iters": 0, "deferred_iters": 0, "disengaged": {}}
        # cached metric handles: a deferral is one counter increment, and
        # the per-call and streamed paths do no registry get-or-create
        self._m_fused_deferred = REGISTRY.counter(
            "ck_fused_deferred_iters_total", "enqueue calls deferred into fused windows")
        self._m_fused_windows = REGISTRY.counter(
            "ck_fused_windows_total", "fused ladder dispatch batches")
        self._m_fused_iters = REGISTRY.counter(
            "ck_fused_iters_total", "iterations dispatched via fused ladders")
        self._m_barriers = REGISTRY.counter("ck_barriers_total", "enqueue-window sync points")
        self._m_stream_stages = REGISTRY.counter(
            "ck_pipeline_stages_total", "stage bodies executed", engine="STREAM")
        # the engines' phases by the lane's device type too: the evidence
        # that a run went through an engine on the card
        self._m_pipe_stages = {
            (engine, kind): REGISTRY.counter("ck_pipeline_stages_total", "stage bodies executed",
                                             engine=engine, device=kind)
            for engine in ("EVENT", "DRIVER") for kind in ("cuda", "cpu")}
        self._m_stream_retunes = REGISTRY.counter(
            "ck_stream_retune_total", "transfer-autotuner re-tunes forced by re-partitions")
        # lane tracing: with it on, each lane of a per-call phase records
        # (lane, dispatch-done time, join-done time) under its compute id,
        # for the call's lanes only; a traced call takes neither the fused
        # nor the streamed path
        self.trace_lanes = False
        self.lane_trace: dict[int, list[tuple[int, float, float]]] = {}
        # lane health (obs/health.py): rolling per-lane baselines over the
        # barrier's fence walls, the transfer walls and the stream
        # dispatch's stalls, fed at sync points and phase tails, never on
        # the deferral path
        self.health = HealthMonitor()
        # the drain actuator (obs/drain.py): at every barrier a degraded
        # lane is quarantined (its share masked to 0 in _ranges_for, the
        # rest moved to the other lanes), probed after a hold and readmitted
        # when its verdict clears
        self.drain = DrainController(self.health, lanes=len(self.workers))
        # (kernel sequence, finding fingerprint) pairs the advisory verify
        # gate has reported: one flight event each
        self._verify_notified: set[tuple] = set()
        # the debug server (obs/debugserver.py): started by serve_debug()
        # or, for the first Cores of the process, by CK_DEBUG_PORT (a busy
        # port is skipped: one debug plane per process, the first binder's)
        self._debug_server = None
        env_port = os.environ.get(DEBUG_PORT_ENV)
        if env_port:
            try:
                port = int(env_port)
                # a fixed port only: port 0 would bind a fresh ephemeral
                # server per Cores and give scrapers no stable address
                if port <= 0:
                    raise ValueError("CK_DEBUG_PORT must be a fixed port > 0")
                self.serve_debug(port)
            except (OSError, ValueError) as e:
                FLIGHT.event("debug-port-skipped", port=env_port,
                             reason=f"{type(e).__name__}: {e}")

    @property
    def adaptive_load_balancer(self) -> bool:
        """Adaptive per-lane damping (:class:`BalanceState`), the default;
        False is the reference's fixed 0.3 damping with a flat history.
        Toggling clears the balancer state of every compute id."""
        return self._adaptive_load_balancer

    @adaptive_load_balancer.setter
    def adaptive_load_balancer(self, v: bool) -> None:
        v = bool(v)
        if v != self._adaptive_load_balancer:
            self._adaptive_load_balancer = v
            self.histories.clear()
            self._balance_states.clear()
            self._cont_ranges.clear()

    @property
    def fence_split(self) -> bool:
        """Fence each compute id of a mixed enqueue window apart at the
        barrier and feed the balancer marginal per-id times (reference
        ``Cores.fence_split``).  Off releases the lanes' probes."""
        return self._fence_split

    @fence_split.setter
    def fence_split(self, v: bool) -> None:
        v = bool(v)
        self._fence_split = v
        for w in self.workers:
            w.track_cid_outputs = v
            if not v:
                with w.lock:
                    w._cid_last_out.clear()

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
        # a held table the step does not divide (a pipelined call's step is
        # local_range * blobs) is split afresh: a lane's ladder covers only
        # whole steps, and the rest of its range would never run (ROADMAP
        # Queue C 13)
        if (ranges is None or sum(ranges) != total or len(ranges) != n
                or any(r % step for r in ranges)):
            if self.fixed_compute_powers is not None:
                # user-pinned shares (normalizedComputePowersOfDevices)
                shares = self.fixed_compute_powers
                ranges = [max(0, int(total * sh / step + 0.5)) * step for sh in shares]
                diff = total - sum(ranges)
                while diff != 0:
                    i = max(range(n), key=lambda k: shares[k])
                    ranges[i] += step if diff > 0 else -step
                    diff = total - sum(ranges)
            else:
                priors = self._skewed_priors()
                if priors is not None and n > 1:
                    ranges = prior_split(total, step, priors, cid=compute_id)
                else:
                    ranges = equal_split(total, n, step)
        elif rebalance and n > 1 and self.fixed_compute_powers is None:
            bench = [w.benchmarks.get(compute_id, 0.0) for w in self.workers]
            if all(b > 0 for b in bench):
                hist = None
                if self.smooth_load_balancer:
                    hist = self.histories.setdefault(
                        compute_id, BalanceHistory(weighted=self.adaptive_load_balancer))
                # each lane's share of the enqueue flush's D2H drain floors
                # its cost; on the plain path the phase's transfers are
                # inside its bench, so the floor never binds there
                transfer = [w.transfer_benchmarks.get(compute_id, 0.0) for w in self.workers]
                if self.adaptive_load_balancer:
                    state = self._balance_states.setdefault(compute_id, BalanceState())
                    ranges = load_balance(bench, ranges, total, step, hist, state=state,
                                          transfer_ms=transfer if any(transfer) else None,
                                          jump_start=True, cid=compute_id,
                                          rate_prior=self._skewed_priors())
                else:
                    carry = self._cont_ranges.setdefault(compute_id, [])
                    ranges = load_balance(bench, ranges, total, step, hist, carry=carry,
                                          cid=compute_id, rate_prior=self._skewed_priors())
        # the drain mask (obs/drain.py): quarantined lanes hold 0, probation
        # lanes one probe step, the rest moves to the active lanes; applied
        # to held tables too (it is idempotent), so a barrier's drain takes
        # effect on the next call
        if self.drain.enabled:
            drained = self.drain.drained_lanes()
            probing = self.drain.probe_lanes()
            if drained or probing:
                ranges = apply_quarantine(ranges, step, drained, probing)
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
                pipeline_blobs: int = 4, pipeline_type: int = PIPELINE_EVENT,
                value_args: Sequence | dict = ()) -> None:
        t_start = time.perf_counter()
        # the fused fast path: a call matching the open window is a counter
        # increment (the engaging call validated the same signature).  The
        # window is read once: another thread may replace it meanwhile, and
        # a deferral counts only into the window whose signature matched
        run = self._fused_run
        if self.enqueue_mode and run is not None and not pipeline:
            sig = job_signature(kernel_names, params, compute_id, global_range,
                                local_range, global_offset, value_args)
            if self._sig_equal(sig, run.sig):
                # the mode toggles are cruncher state, not call identity
                if (not self.fused_dispatch or self.no_compute_mode or self.repeat_count > 1
                        or self.repeat_sync_kernel or self.dispatch_gate is not None
                        or self.trace_lanes):
                    with self._lock:
                        self._fused_candidate = None
                    self._fused_break("mode-change")
                elif compute_id in self._enqueue_rebalance:
                    self._fused_break("range-change")
                elif any(w.coverage_epoch != ep for w, ep in run.epochs):
                    self._fused_break("non-resident")
                elif self._fused_defer(run, t_start, kernel_names):
                    return
            else:
                self._fused_break("signature-change")
        elif run is not None and pipeline:
            self._fused_break("pipeline")
        elif run is not None and not self.enqueue_mode:
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
        step = local_range * (pipeline_blobs if pipeline else 1)
        if global_range % step != 0:
            raise ComputeValidationError(
                f"global_range ({global_range}) must be divisible by step ({step})")
        # the kernel partition-safety / flag-soundness gate (analysis/):
        # verdicts cache per launch shape in the program, so a steady call
        # pays one environment read and one dict lookup, and a strict
        # refusal comes before any window bookkeeping, transfer or launch
        verify_mode = os.environ.get("CK_KERNEL_VERIFY", "advisory")
        if verify_mode != "off":
            verdict = self.program.verify(
                tuple(kernel_names), tuple(flag_row(p.flags) for p in params),
                window=self.enqueue_mode or self.repeat_count > 1)
            if verdict.errors:
                if verify_mode == "strict":
                    raise KernelVerifyError(verdict.errors[0])
                self._note_kernel_verdict(verdict, kernel_names)
        if self.enqueue_mode:
            with self._lock:
                self._note_enqueue_call(compute_id, t_start)
        # enqueue mode cannot rebalance on per-call walls (they time the
        # dispatch only): ranges hold still between syncs and move on the
        # first call after a barrier, from its fence times
        old_ranges = list(self.global_ranges.get(compute_id, ()))
        ranges, refs = self._ranges_for(
            compute_id, global_range, step,
            rebalance=not self.enqueue_mode or compute_id in self._enqueue_rebalance)
        if ranges != old_ranges:
            self._note_range_change(compute_id, step, ranges, old_ranges)
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
        blobs = pipeline_blobs if pipeline else 1
        if self.trace_lanes:
            # the trace describes one call: no entry of an earlier one
            with self._lock:
                self.lane_trace.pop(compute_id, None)
        # GPU lanes issue their work before host lanes start: a host lane's
        # lowered kernels hold the interpreter lock between their torch
        # calls, and a GPU lane issuing beside one waits for it at every
        # call that releases the lock (its kernels then start late and its
        # bench holds the wait).  A held dispatch gate holds this caller
        # here too, before any host lane is submitted
        lanes = [i for i in range(self.num_devices) if ranges[i] > 0]
        gpu = [i for i in lanes if self.workers[i].stream is not None]
        host = [i for i in lanes if self.workers[i].stream is None]
        issued = {i: threading.Event() for i in gpu} if gpu and host else {}

        def submit(i: int):
            w = self.workers[i]
            return self.pool.submit(self._run_worker, w, kernel_names, params, compute_id,
                                    global_offset + refs[i], ranges[i], local_range,
                                    global_range, value_args, write_all_owner, blobs,
                                    pipeline_type, issued.get(i))

        futures = [submit(i) for i in gpu]
        for f, ev in zip(futures, issued.values()):
            f.add_done_callback(lambda _f, ev=ev: ev.set())  # a lane that never ran
            ev.wait()
        futures += [submit(i) for i in host]
        errs = []
        for f in futures:
            try:
                f.result()
            except Exception as e:  # surface the first lane error
                errs.append(e)
        if errs:
            # the black box before the raise (written only when
            # CK_POSTMORTEM_DIR is set)
            record_crash("cores.compute", errs[0], lanes=self._lane_config())
            raise errs[0]
        TRACER.record("enqueue", t_start, cid=compute_id, tag="+".join(kernel_names))
        self._record_perf(compute_id, t_start, ranges)
        if self.enqueue_mode and self.fused_dispatch and not pipeline:
            self._fused_try_engage(kernel_names, params, compute_id, global_range,
                                   local_range, global_offset, value_args, ranges, refs, step)

    def _note_range_change(self, compute_id: int, step: int, ranges: list[int],
                           old_ranges: list[int]) -> None:
        """A compute id's range table changed: its span, flight event and
        balancer metrics; a move of more than one step re-partitioned the
        bytes, so the transfer tuner's observations describe partitions
        that no longer exist (a one-step wiggle stays in its byte
        bucket)."""
        TRACER.instant("split" if not old_ranges else "rebalance", cid=compute_id,
                       tag=str(ranges))
        FLIGHT.event("rebalance", cid=compute_id, ranges=list(ranges), old=list(old_ranges))
        REGISTRY.counter("ck_rebalance_total", "range-table changes", cid=compute_id).inc()
        if old_ranges and len(old_ranges) == len(ranges):
            moved = sum(abs(a - b) for a, b in zip(ranges, old_ranges)) // 2
            REGISTRY.counter("ck_rebalance_moved_items_total",
                             "work items shifted between chips by rebalances").inc(moved)
        for i, r in enumerate(ranges):
            REGISTRY.gauge("ck_balance_share", "per-chip work-item share",
                           cid=compute_id, lane=i).set(r)
        if old_ranges and (len(old_ranges) != len(ranges)
                           or any(abs(a - b) > step for a, b in zip(ranges, old_ranges))):
            self.transfer_tuner.on_repartition()
            self._m_stream_retunes.inc()

    def _note_kernel_verdict(self, verdict, kernel_names) -> None:
        """Advisory-mode surfacing of an unsafe launch shape: one flight
        event per distinct (kernel sequence, finding), a value key that
        holds across racing verdict constructions."""
        f = verdict.errors[0]
        key = (tuple(kernel_names), f.fingerprint)
        with self._lock:
            if key in self._verify_notified:
                return
            self._verify_notified.add(key)
        FLIGHT.event("kernel-verify", kernels="+".join(kernel_names), finding=f.kind,
                     kernel=f.kernel, param=f.param, line=f.line,
                     errors=len(verdict.errors))

    def _note_enqueue_call(self, compute_id: int, t_start: float) -> None:
        """Window bookkeeping of one enqueued call.  Caller holds ``_lock``."""
        if self._enqueue_t0 is None:
            self._enqueue_t0 = t_start
        if compute_id in self._enqueue_cids:
            # last-dispatch order: a cid's fence probe waits on its last launch
            self._enqueue_cid_order.remove(compute_id)
        self._enqueue_cid_order.append(compute_id)
        self._enqueue_cids.add(compute_id)
        self._enqueue_iters[compute_id] = self._enqueue_iters.get(compute_id, 0) + 1
        self._flush_iters[compute_id] = self._flush_iters.get(compute_id, 0) + 1

    def _run_worker(self, w: Worker, kernel_names, params, compute_id, offset, size,
                    local_range, global_range, value_args, write_all_owner, blobs: int = 1,
                    pipeline_type: int = PIPELINE_EVENT,
                    issued: threading.Event | None = None) -> None:
        gate = self.dispatch_gate
        if gate is not None:
            # the synchronized start: held outside the lane's lock
            gate.wait()
        with w.lock:
            w.issued = issued
            w.start_bench(compute_id)
            try:
                if blobs > 1:
                    w.release_host_lanes()
                    self._run_pipelined(w, kernel_names, params, compute_id, offset, size,
                                        local_range, global_range, value_args,
                                        write_all_owner, blobs, pipeline_type)
                    handled, key_bytes = True, None
                else:
                    handled, key_bytes = self._run_streamed(
                        w, kernel_names, params, compute_id, offset, size, local_range,
                        global_range, value_args, self.num_devices == 1, write_all_owner)
                if not handled and self.enqueue_mode:
                    w.release_host_lanes()
                    self._enqueue_phase(w, kernel_names, params, compute_id, offset, size,
                                        local_range, global_range, value_args,
                                        write_all_owner, key_bytes)
                elif not handled:
                    if w.stream is None:
                        w.fence()  # work a host lane queued in enqueue mode runs first
                    with w.on_stream():
                        self._phase(w, kernel_names, params, compute_id, offset, size,
                                    local_range, global_range, value_args, write_all_owner,
                                    key_bytes)
                if w.track_cid_outputs:
                    w.mark_cid(compute_id)
            finally:
                w.release_host_lanes()
                w.issued = None
                w.end_bench(compute_id)

    def _build_launchers(self, w: Worker, kernel_names, chunks, local_range: int,
                         global_range: int) -> None:
        """Build the launchers of these chunk sizes before a timed phase, so
        the tuner's walls hold no launcher build (a new chunk size builds
        one, once)."""
        for name in kernel_names:
            for chunk in set(chunks):
                self.program.launcher(name, chunk, local_range, global_range,
                                      platform=w.device.type)

    def _measuring(self, w: Worker, tuner_key, key_bytes) -> tuple[bool, Any]:
        """``(measuring, tuner_key)`` of a monolithic phase.  The tuner's
        measuring run is a key's first contact, whose wall is split into
        honest upload, compute and download times (:meth:`_phase`,
        :meth:`_enqueue_phase`).  The key's first call on a lane comes
        before it: it carries
        one-off costs (the kernel's first launch on the card loads its
        module, 4-5 ms of a 0.6 ms call) that would land in the tuner's C
        and make chunks look cheap for good, so that call teaches the
        tuner nothing (the tuner key comes back None)."""
        if (tuner_key is None or self.no_compute_mode
                or self.transfer_tuner.has_obs(w.index, tuner_key, key_bytes)):
            return False, tuner_key
        if (w.index, tuner_key) not in self._tuner_warm:
            self._tuner_warm.add((w.index, tuner_key))
            return False, None
        return True, tuner_key

    def _phase(self, w: Worker, kernel_names, params, compute_id, offset, size, local_range,
               global_range, value_args, write_all_owner, key_bytes) -> None:
        """The monolithic plain path: upload, launch, download, fence.
        ``key_bytes`` is :meth:`_run_streamed`'s byte key when the phase
        was a streaming candidate (then the tuner measures or observes it),
        else None.  A measuring run splits its wall at marks between its
        phases (the partial-read uploads, the whole-array uploads, the
        launches, the downloads): on a GPU lane timing events on the lane's
        stream, read after the phase's own fence, so it waits no more than
        any other call; on a host lane, which runs inline, the host clock."""
        single = self.num_devices == 1
        tuner_key = self._tuner_kernel_key(kernel_names, value_args) if key_bytes else None
        measuring, tuner_key = self._measuring(w, tuner_key, key_bytes)
        if measuring:
            self._build_launchers(w, kernel_names, launch_ladder(size, local_range), local_range,
                                  global_range)
        on_card = measuring and w.stream is not None
        marks: list = []

        def mark() -> None:
            if on_card:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record(w.stream)
            else:
                marks.append(time.perf_counter())

        mark()
        # a copy from or to pageable memory blocks this thread until it
        # lands: the call's host lanes need not wait that long to start
        if w.issued is not None and any(not _pinned(p) for p in params):
            w.release_host_lanes()
        # the tuner's U holds only the partial-read uploads (those a
        # streamed phase chunks); whole-array uploads are serial there too
        for part in (True, False):
            for p in params:
                fl = p.flags
                if fl.read and not fl.write_only and fl.partial_read == part:
                    epw = fl.elements_per_work_item
                    w.upload(p, offset * epw, size * epw, single or not fl.partial_read)
            mark()
        for p in params:
            if not (p.flags.read and not p.flags.write_only):
                w.ensure_resident(p)
        if not self.no_compute_mode:
            w.launch(self.program, kernel_names, params, value_args, offset, size,
                     local_range, global_range, local_range, repeats=self.repeat_count,
                     sync_kernel=self.repeat_sync_kernel, compute_id=compute_id)
        t_dispatched = time.perf_counter() if self.trace_lanes else 0.0
        mark()
        downloads = 0
        for idx, p in enumerate(params):
            fl = p.flags
            if not (fl.write and not fl.read_only):
                continue
            epw = fl.elements_per_work_item
            if fl.write_all:
                if w.index == write_all_owner.get(idx):
                    w.download(p, 0, p.size, True)
                    downloads += 1
            else:
                covers = offset == 0 and size * epw == p.size
                full = single and not any(q.flags.partial_read for q in params) and covers
                w.download(p, offset * epw, size * epw, full)
                downloads += 1
        mark()
        w.end_issue(compute_id)
        # the bench covers the whole phase
        w.fence()
        end = time.perf_counter()
        if self.trace_lanes:
            self._trace_lane(compute_id, w, t_dispatched, end)
        if on_card:
            at = [0.0] + [marks[0].elapsed_time(m) / 1000.0 for m in marks[1:]]
        else:
            # unmeasured, the D2H window holds the launches' device time too
            at = [m - marks[0] for m in marks[:4]] + [end - marks[0]]
        self._note_transfer(w, tuner_key, compute_id, key_bytes or 0, at[2],
                            at[4] - at[3] if downloads else 0.0, at[4], fenced=measuring,
                            u_tune_s=at[1])

    def _enqueue_phase(self, w: Worker, kernel_names, params, compute_id, offset, size,
                       local_range, global_range, value_args, write_all_owner,
                       key_bytes=None) -> None:
        """Issue one lane's share of an enqueued call without waiting for it:
        uploads the lane's resident data does not cover, then the launches;
        its readbacks become deferred records for :meth:`flush`.  The buffers
        and the upload coverage are settled here, before the work is queued
        (a host lane runs it later, in order), so the next call, and a fused
        window's engage check, see what this call uploads.  A measuring run
        (``key_bytes``, :meth:`_measuring`) is timed where its work runs and
        waits for nothing."""
        single = self.num_devices == 1
        # the mode toggles as they are now: a host lane runs the work later
        repeats, sync = self.repeat_count, self.repeat_sync_kernel
        compute = not self.no_compute_mode
        tuner_key = self._tuner_kernel_key(kernel_names, value_args) if key_bytes else None
        self._settle_measures(w)
        measuring, tuner_key = self._measuring(w, tuner_key, key_bytes)
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

        def upload(ps) -> None:
            for p, lo, n, full in ps:
                w.upload(p, lo, n, full)

        def launch() -> None:
            if compute:
                w.launch(self.program, kernel_names, params, value_args, offset, size,
                         local_range, global_range, local_range, repeats=repeats,
                         sync_kernel=sync, compute_id=compute_id)

        if measuring:
            # timed where the work runs, so no enqueued call waits: a host
            # lane's thread times its own phases; a GPU lane's stream records
            # timing events, read once they have completed
            # (:meth:`_settle_measures`)
            partial = [u for u in uploads if u[0].flags.partial_read]
            whole = [u for u in uploads if not u[0].flags.partial_read]
            key = (tuner_key, key_bytes)
            if w.stream is None:
                def timed() -> None:
                    t = [time.perf_counter()]
                    for step in (lambda: upload(partial), lambda: upload(whole), launch):
                        step()
                        t.append(time.perf_counter())
                    self._observe_measure(w, key, t[1] - t[0], t[2] - t[0], t[3] - t[2])

                w.issue(timed)
            else:
                with w.on_stream():
                    marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                    marks[0].record()
                    for k, step in enumerate((lambda: upload(partial), lambda: upload(whole),
                                              launch)):
                        step()
                        marks[k + 1].record()
                w.pending_measures.append((marks, key))
        else:
            t0 = time.perf_counter()
            w.issue(lambda: (upload(uploads), launch()))
            t_up = time.perf_counter() - t0 if uploads else 0.0
            self._note_transfer(w, tuner_key, compute_id, key_bytes or 0, t_up, 0.0, t_up)
        t_dispatched = time.perf_counter() if self.trace_lanes else 0.0
        self._defer_readbacks(w, params, compute_id, offset, size, write_all_owner)
        if self.trace_lanes:
            # enqueued: the readbacks are deferred, so the lane joins here
            self._trace_lane(compute_id, w, t_dispatched, time.perf_counter())

    def _trace_lane(self, compute_id: int, w: Worker, t_dispatched: float,
                    t_joined: float) -> None:
        """One lane's ``(index, dispatch-done, join-done)`` of a traced
        call (:attr:`trace_lanes`)."""
        with self._lock:
            self.lane_trace.setdefault(compute_id, []).append((w.index, t_dispatched, t_joined))

    def _observe_measure(self, w: Worker, key, u_tune_s: float, u_s: float, c_s: float) -> None:
        """Feed an enqueued measuring run's phase times (seconds; no D2H:
        enqueue mode defers it) to the tuner as a fenced observation."""
        tuner_key, nbytes = key
        u_ms, tune_u_ms = u_s * 1000.0, u_tune_s * 1000.0
        if tune_u_ms > 0.0:
            self.transfer_tuner.observe(w.index, tuner_key, nbytes, tune_u_ms,
                                        c_s * 1000.0 + u_ms - tune_u_ms, 0.0,
                                        wall_ms=u_ms + c_s * 1000.0, fenced=True)

    def _settle_measures(self, w: Worker) -> None:
        """Read a GPU lane's enqueued measuring runs whose timing events
        have completed, in order."""
        while w.pending_measures and w.pending_measures[0][0][-1].query():
            marks, key = w.pending_measures.pop(0)
            ms = [marks[0].elapsed_time(m) / 1000.0 for m in marks[1:]]
            self._observe_measure(w, key, ms[0], ms[1], ms[2] - ms[1])

    def _defer_readbacks(self, w: Worker, params, compute_id, offset, size,
                         write_all_owner) -> None:
        """One deferred readback record per written array of this lane's
        share (write_all: only the owning lane's)."""
        for idx, p in enumerate(params):
            fl = p.flags
            if not (fl.write and not fl.read_only):
                continue
            if not fl.write_all or w.index == write_all_owner.get(idx):
                with self._lock:
                    self._enqueue_seq += 1
                    self._enqueued.append((self._enqueue_seq, w, p, offset, size,
                                           fl.write_all, compute_id))

    # -- streamed partition transfers (reference: the STREAM engine) -------
    def _stream_key_bytes(self, w: Worker, params, offset: int, size: int,
                          single: bool) -> int:
        """Partition-transfer bytes of one phase, the one formula the
        tuner's ``choose`` and ``observe`` keys share: uncovered
        partial-read uploads plus immediate ranged downloads.  Runs before
        the phase's uploads (they change coverage)."""
        nbytes = 0
        for p in params:
            fl = p.flags
            epw = fl.elements_per_work_item
            if fl.read and not fl.write_only and fl.partial_read:
                if not (self.enqueue_mode and w.upload_covers(
                        p, 0 if single else offset * epw, p.size if single else size * epw)):
                    nbytes += epw * size * p.host().dtype.itemsize
            if (not self.enqueue_mode and fl.write and not fl.read_only
                    and not fl.write_all):
                nbytes += epw * size * p.host().dtype.itemsize
        return nbytes

    @staticmethod
    def _tuner_kernel_key(kernel_names, value_args) -> tuple:
        """The tuner's kernel key: the kernel names and the values (a value
        changes the kernel's time); dict values key on their sorted items,
        unhashable values on the names alone."""
        try:
            if isinstance(value_args, dict):
                vkey = tuple(sorted(value_args.items()))
            else:
                vkey = tuple(value_args) if value_args else ()
            key = (tuple(kernel_names), vkey)
            hash(key)
            return key
        except TypeError:
            return (tuple(kernel_names), None)

    def _note_transfer(self, w: Worker, tuner_key, compute_id: int, nbytes: int,
                       u_s: float, d_s: float, wall_s: float, chunks: int = 1,
                       fenced: bool = False, u_tune_s: float | None = None) -> None:
        """Record one phase's transfer times: on the plain path the lane's
        transfer bench (a part of its wall, so the balancer's floor binds
        only at the enqueue flush's drain, :meth:`_finish_deferred`), and,
        for a streaming candidate that moved partition bytes, a tuner
        observation (a fenced monolithic run teaches U, C and D; an
        unfenced one only clamps; a chunked one teaches the lane's
        per-chunk overhead).  ``u_tune_s`` holds the tuner's U to the
        partial-read uploads."""
        u_ms, d_ms = u_s * 1000.0, d_s * 1000.0
        if u_s + d_s > 0.0 and not self.enqueue_mode:
            # lane health: phases that moved bytes, on the plain path only,
            # where a call is one iteration; in enqueue mode the flush's
            # drain owns the signal (an in-window phase serves a window)
            self.health.observe(w.index, "transfer", u_s + d_s)
        if not self.enqueue_mode:
            w.transfer_benchmarks[compute_id] = u_ms + d_ms
        tune_u_ms = u_ms if u_tune_s is None else u_tune_s * 1000.0
        if tuner_key is not None and nbytes > 0 and (tune_u_ms > 0.0 or d_ms > 0.0):
            c_ms = max(wall_s * 1000.0 - tune_u_ms - d_ms, 0.0)
            self.transfer_tuner.observe(w.index, tuner_key, nbytes, tune_u_ms, c_ms, d_ms,
                                        chunks=chunks, wall_ms=wall_s * 1000.0, fenced=fenced)

    def _run_streamed(self, w: Worker, kernel_names, params, compute_id, offset, size,
                      local_range, global_range, value_args, single,
                      write_all_owner) -> tuple[bool, int | None]:
        """The streamed phase of one lane.  Returns ``(handled, key_bytes)``:
        not handled means the caller runs the monolithic phase, with
        ``key_bytes`` the phase's :meth:`_stream_key_bytes` when it was a
        streaming candidate (the tuner chose one chunk) and None when
        streaming could not apply.

        The caller's thread stages each chunk's uploads (on a GPU lane: an
        H2D on the lane's H2D stream) and hands the chunk's commit, launch
        and D2H issue to the lane's stream driver, at most
        ``stream_queue_depth`` chunks ahead.  Kernel-major as
        ``Worker.launch``: uploads interleave with the first kernel's chunk
        launches and downloads with the last one's; kernels between run
        over the whole range.  Runs under the lane's lock."""
        if (not self.streamed_transfers or self.no_compute_mode or self.repeat_count > 1
                or self.repeat_sync_kernel or self.trace_lanes):
            return False, None
        self._settle_measures(w)
        step = local_range
        max_chunks = size // step if step > 0 else 0
        if max_chunks < 2:
            return False, None
        up_parts: list[ClArray] = []   # partial-read uploads, chunked
        up_full: list[ClArray] = []    # whole-array uploads, before any launch
        for p in params:
            fl = p.flags
            if fl.read and not fl.write_only:
                epw = fl.elements_per_work_item
                full = single or not fl.partial_read
                if self.enqueue_mode and w.upload_covers(
                        p, 0 if full else offset * epw, p.size if full else size * epw):
                    continue
                (up_parts if fl.partial_read else up_full).append(p)
        down_parts: list[ClArray] = []
        if not self.enqueue_mode:
            down_parts = [p for p in params if p.flags.write and not p.flags.read_only
                          and not p.flags.write_all]
        if not up_parts and not down_parts:
            return False, None
        nbytes = self._stream_key_bytes(w, params, offset, size, single)
        tuner_key = self._tuner_kernel_key(kernel_names, value_args)
        chunks = self.stream_chunks or self.transfer_tuner.choose(
            w.index, tuner_key, nbytes, max_chunks)
        chunks = min(max(int(chunks), 1), max_chunks)
        if self.last_stream_chunks.get(w.index) != chunks:
            # the decision, not the steady state: only a changed count
            FLIGHT.event("stream-choice", lane=w.index, chunks=chunks, nbytes=nbytes)
        self.last_stream_chunks[w.index] = chunks
        w.m_chunk_count.set(chunks)
        if chunks <= 1:
            return False, nbytes
        w.release_host_lanes()
        plan = chunk_plan(size, step, chunks)
        STREAMED.add("+".join(kernel_names))
        names = list(kernel_names)
        last = len(names) - 1
        chunked = [name for ki, name in enumerate(names)
                   if (up_parts and ki == 0) or (down_parts and ki == last)]
        self._build_launchers(w, chunked, [csz for _off, csz in plan], local_range,
                              global_range)
        self._build_launchers(w, [n for n in names if n not in chunked], launch_ladder(size, step),
                              local_range, global_range)
        _tt = TRACER.t0()
        t_phase0 = time.perf_counter()
        if w.stream is None and not self.enqueue_mode:
            w.fence()  # work a host lane queued in enqueue mode runs first
        # in enqueue mode a host lane's whole-range work queues behind its
        # earlier work; on the plain path it runs here
        run = w.issue if self.enqueue_mode else (lambda fn: fn())
        w.stream_depth = depth = max(1, int(self.stream_queue_depth))
        handles: list = []
        stage_s = 0.0
        # the time the caller spent in the stream dispatch's submits, and
        # how many: the stream_stall health signal, per submit
        stall_s, submits = 0.0, 0
        with w.on_stream():
            for p in params:
                w.ensure_resident(p)
            w.begin_streamed()
            for p in up_full:
                run(lambda p=p: w.upload(p, 0, p.size, True))
            for p in up_parts:
                w.transfers["h2d", p.name] += 1
            for p in down_parts:
                w.transfers["d2h", p.name] += 1
            try:
                for ki, name in enumerate(names):
                    do_up = bool(up_parts) and ki == 0
                    do_down = bool(down_parts) and ki == last
                    if not do_up and not do_down:
                        run(lambda name=name: w.launch(
                            self.program, [name], params, value_args, offset, size,
                            local_range, global_range, local_range, compute_id=compute_id))
                        continue
                    for coff, csz in plan:
                        boff = offset + coff
                        staged: list = []
                        if do_up:
                            t0 = time.perf_counter()
                            staged = [w.stage_upload_chunk(
                                p, boff * p.flags.elements_per_work_item,
                                csz * p.flags.elements_per_work_item) for p in up_parts]
                            stage_s += time.perf_counter() - t0

                        def run_chunk(name=name, boff=boff, csz=csz, staged=staged,
                                      do_down=do_down) -> None:
                            for st in staged:
                                w.commit_upload(st)
                            w.launch(self.program, [name], params, value_args, boff, csz,
                                     local_range, global_range, local_range,
                                     compute_id=compute_id)
                            if do_down:
                                for p in down_parts:
                                    epw = p.flags.elements_per_work_item
                                    handles.append(
                                        w.download_chunk_async(p, boff * epw, csz * epw))

                        t0q = time.perf_counter()
                        w.stream_dispatch_async(run_chunk, depth,
                                                preflighted=self._batch_preflighted)
                        stall_s += time.perf_counter() - t0q
                        submits += 1
                    w.drain_stream_dispatch()
            except BaseException:
                # no closure may outlive the lane lock the caller holds; the
                # first error outranks a drain's
                try:
                    w.drain_stream_dispatch()
                except Exception:  # noqa: BLE001 - the first error wins
                    pass
                raise
            finally:
                w.end_streamed()
            if self.enqueue_mode:
                self._defer_readbacks(w, params, compute_id, offset, size, write_all_owner)
            else:
                for idx, p in enumerate(params):
                    fl = p.flags
                    if (fl.write and not fl.read_only and fl.write_all
                            and w.index == write_all_owner.get(idx)):
                        handles.append(w.download_async(p, 0, p.size, True))
        t0d = time.perf_counter()
        for h in handles:
            Worker.finish_download(h)
        if not self.enqueue_mode:
            w.fence()  # the bench covers the whole phase
        t_down = time.perf_counter() - t0d if handles else 0.0
        self._note_transfer(w, tuner_key, compute_id, nbytes, stage_s, t_down,
                            time.perf_counter() - t_phase0, chunks=len(plan))
        # per submit: a retune to more chunks scales the phase's sum with
        # the same health per submit
        self.health.observe(w.index, "stream_stall", stall_s / max(1, submits))
        self._m_stream_stages.inc()
        TRACER.record("pipeline-stage", _tt, cid=compute_id, lane=w.index,
                      tag=f"STREAM x{len(plan)}")
        return True, nbytes

    # -- pipelined compute (reference: the EVENT and DRIVER engines) --------
    def _run_pipelined(self, w: Worker, kernel_names, params, compute_id, offset, size,
                       local_range, global_range, value_args, write_all_owner, blobs: int,
                       pipeline_type: int) -> None:
        """One lane's range cut into ``blobs`` equal blobs whose copies
        overlap other blobs' kernels.  Residency is judged once, before any
        upload (enqueue mode: a partial array counts as resident only where
        the lane's coverage holds its whole range, so a blob's upload never
        hides the rest of the call's); non-partial read arrays upload whole
        first.  Then the engine:

        - EVENT (:meth:`_event_blobs`): at step ``j`` stage blob ``j``'s
          uploads, commit and compute blob ``j - L`` and read back blob
          ``j - L - 1`` (``L`` = :attr:`pipeline_lookahead`);
        - DRIVER (:meth:`_driver_blobs`): blob ``k``'s uploads, kernels and
          readbacks in one order, blob after blob.

        On a GPU lane the EVENT engine copies on the lane's two copy
        streams and orders them by CUDA events (H2D before the blob's
        kernels, the blob's kernels before its D2H), and the DRIVER engine
        puts blob ``k`` on the lane's stream ``k mod 16``; a pageable array
        goes through the page-locked staging ring.  The host waits inside
        the loop only for a staging slot still in use.  A host lane runs
        the same order on its own thread.  In enqueue mode the writers'
        readbacks become one deferred record, else each blob is read back
        and the phase waits for them.  Runs under the lane's lock."""
        _tt = TRACER.t0()
        engine = "EVENT" if pipeline_type == PIPELINE_EVENT else "DRIVER"
        blob = size // blobs
        look = max(1, int(self.pipeline_lookahead))
        resident = set()
        if self.enqueue_mode:
            for p in params:
                epw = p.flags.elements_per_work_item
                if (w.upload_covers(p, offset * epw, size * epw) if p.flags.partial_read
                        else w.upload_covers(p, 0, p.size)):
                    resident.add(id(p))
        reads = [p for p in params if p.flags.read and not p.flags.write_only
                 and id(p) not in resident]
        whole = [p for p in reads if not p.flags.partial_read]
        partials = [p for p in reads if p.flags.partial_read]
        writers = [] if self.enqueue_mode else [
            p for p in params if p.flags.write and not p.flags.read_only
            and not p.flags.write_all]
        # the mode toggles as they are now: a host lane may run the work later
        repeats, sync = self.repeat_count, self.repeat_sync_kernel
        compute = not self.no_compute_mode
        # staging slots for every copy a blob in flight may hold
        in_flight = look + 2 if engine == "EVENT" else min(blobs, PIPE_QUEUES)
        w.stream_depth = max(int(self.stream_queue_depth),
                             in_flight * max(len(partials), len(writers), 1))
        handles: list = []

        def launch(k: int, stream=None) -> None:
            if compute:
                w.launch(self.program, kernel_names, params, value_args, offset + k * blob,
                         blob, local_range, global_range, local_range, repeats=repeats,
                         sync_kernel=sync, compute_id=compute_id, stream=stream)

        def body() -> None:
            for p in whole:
                w.upload(p, 0, 0, True)
            run = self._event_blobs if engine == "EVENT" else self._driver_blobs
            run(w, params, partials, writers, offset, blob, blobs, look, launch, handles)

        with w.on_stream():
            for p in params:
                w.ensure_resident(p)
            if w.stream is None and self.enqueue_mode:
                # the coverage this call's uploads give, claimed before its
                # work is queued: the next call sees it
                for p in whole:
                    w.claim_upload(p, 0, 0, True)
                for p in partials:
                    epw = p.flags.elements_per_work_item
                    w.claim_upload(p, offset * epw, size * epw, False)
                w.issue(body)
            else:
                if w.stream is None:
                    w.fence()  # work a host lane queued in enqueue mode runs first
                body()
            if self.enqueue_mode:
                self._defer_readbacks(w, params, compute_id, offset, size, write_all_owner)
            else:
                for idx, p in enumerate(params):
                    fl = p.flags
                    if (fl.write and not fl.read_only and fl.write_all
                            and w.index == write_all_owner.get(idx)):
                        handles.append(w.download_async(p, 0, p.size, True))
        for h in handles:
            Worker.finish_download(h)
        if not self.enqueue_mode:
            w.fence()  # the bench covers the whole phase
        self._m_pipe_stages[engine, w.device.type].inc()
        TRACER.record("pipeline-stage", _tt, cid=compute_id, lane=w.index,
                      tag=f"EVENT x{blobs} look{look}" if engine == "EVENT"
                      else f"DRIVER x{blobs}")

    @staticmethod
    def _event_blobs(w: Worker, params, partials, writers, offset: int, blob: int, blobs: int,
                     look: int, launch, handles: list) -> None:
        """The EVENT engine's wavefront (reference ``_run_pipelined_event``):
        at step ``j`` stage blob ``j``, commit and compute blob ``j - look``,
        read back blob ``j - look - 1``.  On a GPU lane the uploads go on the
        H2D stream, the kernels on the lane's stream after each upload's
        event, and the readbacks on the D2H stream after an event recorded
        behind the blob's own kernels."""
        gpu = w.stream is not None
        staged: dict[int, list] = {}
        done: dict[int, Any] = {}
        if gpu:
            w.begin_streamed()
        try:
            for j in range(blobs + look + 1):
                if j < blobs:
                    boff = offset + j * blob
                    staged[j] = [w.stage_upload(p, boff * p.flags.elements_per_work_item,
                                                blob * p.flags.elements_per_work_item)
                                 for p in partials]
                k = j - look
                if 0 <= k < blobs:
                    for st in staged.pop(k):
                        w.commit_upload(st)
                    launch(k)
                    if gpu and writers:
                        done[k] = torch.cuda.Event()
                        done[k].record(w.stream)
                m = j - look - 1
                if 0 <= m < blobs:
                    boff = offset + m * blob
                    after = done.pop(m, None)
                    for p in writers:
                        epw = p.flags.elements_per_work_item
                        handles.append(w.download_async(
                            p, boff * epw, blob * epw, False,
                            stream=w.d2h_stream if gpu else None, after=after))
        finally:
            if gpu:
                w.end_streamed()

    @staticmethod
    def _driver_blobs(w: Worker, params, partials, writers, offset: int, blob: int,
                      blobs: int, look: int, launch, handles: list) -> None:
        """The DRIVER engine (reference ``_run_pipelined_driver``): blob
        ``k``'s uploads, kernels and readbacks back to back with no wait
        between blobs.  On a GPU lane blob ``k`` runs on the lane's stream
        ``k mod 16`` in that stream's order; the streams start after the
        lane's stream and the lane's stream waits for all of them at the
        end, so work queued later on the lane runs after the blobs."""
        queues = w.pipe_streams()[:min(blobs, PIPE_QUEUES)] if w.stream is not None else []
        for q in queues:
            q.wait_stream(w.stream)
        try:
            for k in range(blobs):
                q = queues[k % len(queues)] if queues else None
                boff = offset + k * blob
                with torch.cuda.stream(q) if q is not None else nullcontext():
                    for st in [w.stage_upload(p, boff * p.flags.elements_per_work_item,
                                              blob * p.flags.elements_per_work_item, stream=q)
                               for p in partials]:
                        w.commit_upload(st)
                    launch(k, stream=q)
                    for p in writers:
                        epw = p.flags.elements_per_work_item
                        handles.append(w.download_async(p, boff * epw, blob * epw, False,
                                                        stream=q))
        finally:
            for q in queues:
                w.stream.wait_stream(q)
                for p in params:  # buffers the blobs' kernels used on q
                    w.buffer(p).record_stream(q)

    def _record_perf(self, compute_id: int, t_start: float, ranges: list[int]) -> None:
        perf = ComputePerf(
            compute_id=compute_id,
            device_ms=[w.benchmarks.get(compute_id, 0.0) for w in self.workers],
            device_items=list(ranges),
            total_ms=(time.perf_counter() - t_start) * 1000.0,
        )
        self.perf[compute_id] = perf
        self.perf_log.setdefault(compute_id, deque(maxlen=64)).append(perf)
        self.last_compute_id = compute_id
        if self.performance_feed:
            print(perf.report(self.device_names()))

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
        if self.no_compute_mode:
            reason = "no-compute"
        elif self.repeat_count > 1 or self.repeat_sync_kernel:
            # each call runs its repeats as one dispatch already
            reason = "repeat-mode"
        elif self.dispatch_gate is not None:
            reason = "dispatch-gate"
        elif self.trace_lanes:
            reason = "trace-lanes"
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
            self._note_disengage(reason, compute_id)
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
            # another thread's re-split flush has closed the windows and will
            # reset the coverage this check read: a window opened now would
            # lose its iterations at the reset.  A window another thread
            # opened since this call's candidate check holds that thread's
            # deferred iterations: replacing it would hand them to this
            # signature (ROADMAP Queue C 12)
            refused = ("re-split" if self._resplits > 0
                       else "window-open" if self._fused_run is not None else None)
            if refused is None:
                self._fused_sig = sig
                self._fused_run = run
        if refused is not None:
            self._note_disengage(refused, compute_id)
            return
        FLIGHT.event("fused-engage", cid=compute_id, rows=len(rows))
        # an engaged window's spec is what another process would warm: kept
        # here, once a key a process (engagement is cold, never a deferral)
        if COMPILE_CACHE.enabled:
            self._cache_record_engaged(run)
        if DECISIONS.enabled:
            # provenance, not replayable: the engage check reads live
            # residency
            DECISIONS.record("fused-engage", {
                "cid": compute_id,
                "kernels": list(kernel_names),
                "global_range": global_range,
                "local_range": local_range,
                "lanes": [w.index for w, _off, _size in rows],
            }, {"engaged": True, "rows": len(rows)})

    def _fused_defer(self, run: _FusedRun, t_start: float, kernel_names) -> bool:
        """Count this call into the window ``run``, the one whose signature
        it matched; False when that window closed meanwhile, whether or not
        another opened (the caller takes the per-call path).  Counting into
        whatever window is open would give this call's iteration to another
        signature's arrays (ROADMAP Queue C 12)."""
        with self._lock:
            if self._fused_run is not run:
                return False
            self._note_enqueue_call(run.compute_id, t_start)
            self._fused_pending += 1
            pending = self._fused_pending
            self.fused_stats["deferred_iters"] += 1
        self._m_fused_deferred.inc()
        if pending >= max(1, int(self.fused_batch)):
            self._fused_flush()
        if TRACER.enabled:
            # the whole call guarded: the tag alone allocates
            TRACER.record("enqueue", t_start, cid=run.compute_id,
                          tag="+".join(kernel_names) + " fused-defer")
        if self.performance_feed:
            # the feed prints a row per call; otherwise a deferral stays a
            # counter increment and the window's dispatch records one row
            self._record_perf(run.compute_id, t_start,
                              self.global_ranges.get(run.compute_id, []))
        else:
            self.last_compute_id = run.compute_id
        return True

    def _dispatch_fused(self, run: _FusedRun, iters: int) -> None:
        """Queue one ``iters``-iteration dispatch per active lane on the
        lanes' drivers.  Every lane is checked for a held failure before any
        is given the batch (an armed ``driver-submit`` fault fires there, once
        per lane); a failure poisons the window, so a caller that catches it
        cannot defer into it."""
        t0 = time.perf_counter()
        _tt = TRACER.t0()
        cid = run.compute_id

        def dispatch(w: Worker, off: int, size: int) -> None:
            w.launch_fused(self.program, run.kernel_names, run.params, run.value_args, off,
                           size, run.local_range, run.global_range, run.step, iters,
                           compute_id=cid)
            if w.track_cid_outputs:
                w.mark_cid(cid)

        try:
            for w, _off, _size in run.rows:
                w.dispatch_preflight()
            for w, off, size in run.rows:
                w.dispatch_async(lambda w=w, off=off, size=size: dispatch(w, off, size),
                                 depth=self.fused_queue_depth, preflighted=True)
        except Exception:
            with self._lock:
                # the poisoned window's deferrals go with it
                self._fused_sig = None
                self._fused_run = None
                self._fused_candidate = None
                self._fused_pending = 0
            raise
        with self._lock:
            self.fused_stats["windows"] += 1
            self.fused_stats["fused_iters"] += iters
        self._m_fused_windows.inc()
        self._m_fused_iters.inc(iters)
        self._record_perf(cid, t0, self.global_ranges.get(cid, []))
        FLIGHT.event("fused-window", cid=cid, iters=iters)
        TRACER.record("fused", _tt, cid=cid, tag=f"x{iters}")

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

    def _note_disengage(self, reason: str, cid: int | None) -> None:
        """The one disengage-accounting path: ``fused_stats``, the
        ``ck_fused_disengage_total`` counter by reason, a flight event, a
        decision record and a ``fused`` span."""
        with self._lock:
            d = self.fused_stats["disengaged"]
            d[reason] = d.get(reason, 0) + 1
        REGISTRY.counter("ck_fused_disengage_total",
                         "fused-window refusals/breaks by named reason", reason=reason).inc()
        FLIGHT.event("fused-disengage", reason=reason, cid=cid)
        if DECISIONS.enabled:
            DECISIONS.record("fused-disengage", {"cid": cid}, {"reason": reason})
        TRACER.instant("fused", cid=cid, tag=f"disengage:{reason}")

    def _fused_break(self, reason: str) -> None:
        """Close the window and count why."""
        with self._lock:
            run = self._fused_run
        cid = run.compute_id if run is not None else None
        self._fused_close()
        self._note_disengage(reason, cid)

    def _fused_drain(self) -> None:
        errs = []
        for w in self.workers:
            try:
                w.drain_dispatch()
            except Exception as e:  # noqa: BLE001 - raised after every lane
                errs.append(e)
        if errs:
            record_crash("cores.fused_drain", errs[0], lanes=self._lane_config())
            raise errs[0]

    def _batch_defer(self, sig: tuple, k: int, t_start: float) -> bool:
        """Count ``k`` iterations into the open window matching ``sig`` in one
        step and dispatch them; False when no such window is open or a
        deferral would break it."""
        with self._lock:
            run = self._fused_run
            if (run is None or not self._sig_equal(self._fused_sig, sig)
                    or not self.fused_dispatch or self.no_compute_mode or self.repeat_count > 1
                    or self.repeat_sync_kernel or self.dispatch_gate is not None
                    or self.trace_lanes
                    or run.compute_id in self._enqueue_rebalance
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
        the iterations applied before it; its residue is ``clean`` only when
        an injected fault refused it at a preflight, before anything of it
        was queued.  With the fault plane armed, each per-call iteration
        preflights every lane first.  With the compile cache armed, the
        result adds ``cache_hits`` and ``cache_misses``: the cache probes
        the batch made (a window that engaged on a missed key)."""
        iters = int(iters)
        if iters < 1:
            raise ComputeValidationError(f"compute_fused_batch needs iters >= 1, got {iters}")
        if not self.enqueue_mode:
            raise ComputeValidationError(
                "compute_fused_batch requires enqueue_mode (deferred readbacks are the "
                "batch contract)")
        sig = job_signature(kernel_names, params, compute_id, global_range, local_range,
                            global_offset, value_args)
        probe_cache = COMPILE_CACHE.enabled
        if probe_cache:
            hits0, misses0 = probe_counts()
        done = ladder = 0
        try:
            while done < iters:
                if self._batch_defer(sig, iters - done, time.perf_counter()):
                    ladder = iters - done
                    done = iters
                    break
                if FAULTS.enabled:
                    # an armed driver-submit fires here, before anything of
                    # this iteration reached a lane; its submits then skip it
                    for w in self.workers:
                        w.stream_preflight()
                self._batch_preflighted = True
                try:
                    self.compute(kernel_names, params, compute_id, global_range, local_range,
                                 global_offset=global_offset, value_args=value_args)
                finally:
                    self._batch_preflighted = False
                done += 1
        except Exception as e:
            cause = (f"injected:{e.point}" if isinstance(e, InjectedFaultError)
                     else type(e).__name__)
            raise FusedBatchError(cause=cause, applied_iters=done, requested_iters=iters,
                                  clean=bool(getattr(e, "_ck_clean_window", False)),
                                  original=e) from e
        out = {"iters": iters, "fused": ladder > 0, "ladder_iters": ladder,
               "per_call_iters": iters - ladder}
        if probe_cache:
            hits1, misses1 = probe_counts()
            out["cache_hits"] = hits1 - hits0
            out["cache_misses"] = misses1 - misses0
        return out

    # -- warmup and the compile cache (core/compilecache.py) ------------------
    def _warm_targets(self) -> list[tuple]:
        """The distinct ``(platform, device_kind, device)`` of the lanes:
        every launcher key variant the live path can ask for.  ``platform``
        is the lane's ``device.type``, exactly what ``Worker.launch_fused``
        and ``Worker.launch`` pass: a warmed key that differs from the live
        one in any part warms nothing.  Each device is its own target, as
        each loads its own modules."""
        seen: dict = {}
        for w, d in zip(self.workers, self.devices):
            seen.setdefault((w.device.type, d.kind, w.device), w)
        return [(p, k, dev) for (p, k, dev) in seen]

    @staticmethod
    def _torch_dtype(dtype: str) -> torch.dtype:
        """The torch dtype of a param's numpy dtype name (as a lane's
        buffer of that param has it)."""
        import numpy as np

        return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype

    def warmup(self, plan) -> dict:
        """Build and run a plan's whole predicated ladders before traffic
        arrives (reference ``Cores.warmup``).

        ``plan`` is an iterable of :class:`~.compilecache.WarmupSpec`, or
        of objects with the job surface (``kernels``, ``params``,
        ``global_range``, ``local_range``, ``values``; the params are read
        for size and dtype, never run on).  A duplicate is warmed once; a
        spec whose kernels the program lacks, whose range is no multiple
        of its local range or which has fewer params than a kernel's arrays
        is skipped.  For each spec and each lane target
        (:meth:`_warm_targets`) this builds, under the keys the live path
        asks for:

        - the fused ladder (``KernelProgram.fused_launcher`` with the live
          window's arguments), and
        - every per-chunk launcher ``step << k`` up to the global range
          (any split's ladder is a subset),

        and runs each once on zero-filled scratch tensors on the target's
        device (on the lane's stream, then synchronized).  The run matters
        on the card: it builds or loads each library and loads its CUDA
        module (the emitter's forms are separate ``__global__`` functions,
        loaded at their first launch, so every chunk runs), and the first
        live launch pays for neither.  A ``@kernel`` over ``csrc/``
        (``workloads.mandelbrot_cuda_kernel``) runs like any other
        launcher.  No CUDA graph is captured: a graph holds the live
        buffers' addresses, so a lane captures its own at a key's second
        live run (``kernel/graphs.py``).

        With ``CK_COMPILE_CACHE`` set, each spec's key is looked up
        (counted as a hit or a miss) and a missed one is recorded for
        other processes; unset, the disk is never touched and the results
        are the same bit for bit.  One ``cache-warmup`` flight event and
        one context decision record each plan.  Returns ``{"warmed",
        "hits", "misses", "skipped", "wall_s", "kinds"}``."""
        t0 = time.perf_counter()
        armed = COMPILE_CACHE.enabled
        if armed:
            COMPILE_CACHE.arm()
        specs: list[tuple[WarmupSpec, tuple]] = []
        seen_specs: set = set()
        skipped = 0
        for item in plan:
            if isinstance(item, WarmupSpec):
                spec = item
            else:
                try:
                    spec = WarmupSpec.from_job(
                        item.kernels, item.params, getattr(item, "compute_id", 0),
                        item.global_range, item.local_range, getattr(item, "global_offset", 0),
                        getattr(item, "values", ()))
                except Exception:  # noqa: BLE001 - an unwarmable job shape
                    skipped += 1
                    continue
            ident = (spec.kernels, spec.params, spec.global_range, spec.local_range,
                     spec.values)
            if ident in seen_specs:
                continue
            seen_specs.add(ident)
            if (spec.local_range <= 0 or spec.global_range % spec.local_range != 0
                    or not all(n in self.program for n in spec.kernels)
                    or any(self.program.array_param_count(n) > len(spec.params)
                           for n in spec.kernels)):
                skipped += 1
                continue
            try:
                dtypes = tuple(self._torch_dtype(d) for _n, d in spec.params)
            except Exception:  # noqa: BLE001 - a dtype no lane buffer has
                skipped += 1
                continue
            specs.append((spec, dtypes))

        hits = misses = 0
        keys: list[str] = []
        kinds: dict[str, int] = {}
        for spec, dtypes in specs:
            step = spec.local_range
            units = spec.global_range // step
            vals = spec.value_args()
            names = tuple(spec.kernels)
            for platform, device_kind, device in self._warm_targets():
                kinds[device_kind] = kinds.get(device_kind, 0) + 1
                key = None
                hit = False
                if armed:
                    key = COMPILE_CACHE.ladder_key(self.program, spec, platform, device_kind)
                    keys.append(key)
                    hit = COMPILE_CACHE.lookup(key)
                stream = next(w.stream for w in self.workers if w.device == device)
                with torch.cuda.stream(stream) if stream is not None else nullcontext():
                    bufs = tuple(torch.zeros(n, dtype=dt, device=device)
                                 for (n, _d), dt in zip(spec.params, dtypes))
                    # the fused ladder, under the live window's key
                    fn = self.program.fused_launcher(names, step, spec.global_range,
                                                     spec.local_range, spec.global_range, vals,
                                                     platform=platform)
                    if fn is not None:
                        bufs = tuple(fn(0, units, 1, bufs))
                    # every per-call chunk the binary ladder can launch
                    for name in dict.fromkeys(names):
                        n_arr = self.program.array_param_count(name)
                        va = tuple(vals.get(name, ()) if isinstance(vals, dict) else vals)
                        for k in range(max(1, units.bit_length())):
                            chunk = step << k
                            if chunk > spec.global_range:
                                break
                            f2, _info = self.program.launcher(
                                name, chunk, spec.local_range, spec.global_range, platform)
                            out = f2(0, bufs[:n_arr], va)
                            bufs = tuple(out) + bufs[n_arr:]
                if stream is not None:
                    stream.synchronize()
                if armed:
                    if hit:
                        hits += 1
                    else:
                        misses += 1
                        COMPILE_CACHE.record(key, spec, platform, device_kind)
        wall_s = time.perf_counter() - t0
        FLIGHT.event("cache-warmup", warmed=len(specs), hits=hits, misses=misses,
                     skipped=skipped, wall_ms=round(wall_s * 1e3, 3), cache=armed,
                     kinds=dict(kinds))
        if DECISIONS.enabled:
            # context, not replayable: it reads the cache on disk
            DECISIONS.record("cache-warmup", {
                "specs": [s.to_payload() for s, _dt in specs],
                "cache_enabled": armed,
                "cache_root": COMPILE_CACHE.root,
            }, {
                "warmed": len(specs), "hits": hits, "misses": misses,
                "skipped": skipped, "keys": keys,
                "wall_ms": round(wall_s * 1e3, 3), "kinds": dict(kinds),
            })
        return {"warmed": len(specs), "hits": hits, "misses": misses, "skipped": skipped,
                "wall_s": wall_s, "kinds": dict(kinds)}

    def _cache_record_engaged(self, run: _FusedRun) -> None:
        """Keep an engaged window's spec, so other processes can warm it
        from disk (the fleet's live signature mix is the cache's content).
        Cold: at most one disk probe a key a process (``_seen``); best
        effort, as every cache write."""
        try:
            spec = WarmupSpec.from_job(run.kernel_names, run.params, run.compute_id,
                                       run.global_range, run.local_range, 0, run.value_args)
            for platform, device_kind, _dev in self._warm_targets():
                key = COMPILE_CACHE.ladder_key(self.program, spec, platform, device_kind)
                if key in COMPILE_CACHE._seen:
                    continue
                if not COMPILE_CACHE.lookup(key, count=False):
                    COMPILE_CACHE.record(key, spec, platform, device_kind)
        except Exception:  # noqa: BLE001 - the cache is never load-bearing
            pass

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
        not overlap.  With streamed transfers a large record drains in
        chunks (``stream_chunks``, or the tuner's choice for the
        ``"flush-d2h"`` key), so one chunk's host copy overlaps the next
        chunks' D2H; finishing in issue order keeps the host writes in
        order.  ``lock_each`` takes each worker's lock per record
        (:meth:`flush`; the atomic rebalance flush already holds them
        all).  Returns ``(handle, worker, cid)`` entries."""
        handles = []
        for _, w, p, offset, size, write_all, cid in self._latest_records(pending):
            epw = p.flags.elements_per_work_item
            with (w.lock if lock_each else nullcontext()):
                if write_all:
                    handles.append((w.download_async(p, 0, p.size, True), w, cid))
                    continue
                chunks = 1
                if self.streamed_transfers and size > 1:
                    nbytes = size * epw * p.host().dtype.itemsize
                    chunks = self.stream_chunks or self.transfer_tuner.choose(
                        w.index, "flush-d2h", nbytes, size, has_compute=False)
                if chunks <= 1:
                    handles.append((w.download_async(p, offset * epw, size * epw, False),
                                    w, cid))
                    continue
                w.stream_depth = max(1, int(self.stream_queue_depth))
                w.transfers["d2h", p.name] += 1  # the record, once; its chunks apart
                for coff, csz in chunk_plan(size, 1, chunks):
                    handles.append((w.download_chunk_async(p, (offset + coff) * epw, csz * epw),
                                    w, cid))
                # later work on the lane waits for these copies
                w.end_streamed()
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
            per_iter_s = s / max(1, iters.get(cid, 1))
            with w.lock:
                w.transfer_benchmarks[cid] = per_iter_s * 1000.0
            # lane health on the balancer floor's per-iteration scale: a
            # window four times larger is not a link four times slower
            if per_iter_s > 0.0:
                self.health.observe(w.index, "transfer", per_iter_s)

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
        every lane's upload coverage as one step under all worker locks.
        Another host thread's enqueued call is then either before
        it (its record is collected here) or after it (it sees reset
        coverage and a host made current): a re-upload can never miss
        that thread's own updates.  Lock order: worker locks, then
        ``_lock``, as in :meth:`_enqueue_phase`.  An open fused window is
        dispatched and drained first, and no window opens until the reset
        is done: its iterations would be in no record read back here, and
        the re-upload after the reset would overwrite them."""
        with self._lock:
            self._resplits += 1
        try:
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
        finally:
            with self._lock:
                self._resplits -= 1

    def barrier(self) -> None:
        """Block until all dispatched work has retired, without reading
        results back (the enqueue-mode sync point; the reference's finish()
        on the used queues).

        The lanes are fenced concurrently.  In enqueue mode on more than one
        lane, each lane's fence-retire time since the window's first call
        becomes its bench, per iteration (``per_iteration_benches``), for
        every compute id it ran in the window, and those ids are armed to
        rebalance on their next call.  With :attr:`fence_split` on and more
        than one compute id in the window, each lane first fences each id's
        last launch in last-dispatch order (``Worker.fence_cid``) and an id's
        bench is its marginal time (``split_fence_benches``).  An open fused
        window is dispatched and drained first, so the fences cover it.  An
        armed ``lane-stall`` fault delays a lane's fence.  A dispatch or
        fence failure is raised after every lane has been fenced; the
        window closes either way."""
        n = self.num_devices
        errs: list[Exception] = []
        try:
            try:
                self._fused_close()
            except Exception as e:  # noqa: BLE001 - the lanes are fenced all the same
                errs.append(e)
            self._m_barriers.inc()
            _mt0 = time.perf_counter()
            t_b = TRACER.t0()
            with self._lock:
                t0 = self._enqueue_t0
                window_cids = set(self._enqueue_cids)
                window_cid_order = list(self._enqueue_cid_order)
                window_iters = dict(self._enqueue_iters)
            measure = self.enqueue_mode and t0 is not None and n > 1
            split_order = (window_cid_order
                           if self.fence_split and measure and len(window_cids) > 1 else [])
            done_at: dict[int, float] = {}
            comp_at: dict[int, list[tuple[int, float]]] = {}

            def fence_timed(w: Worker) -> None:
                if FAULTS.enabled:
                    d = FAULTS.delay_s("lane-stall", lane=w.index, where="barrier")
                    if d > 0.0:
                        time.sleep(d)
                comps: list[tuple[int, float]] = []
                for cid in split_order:
                    rng = self.global_ranges.get(cid)
                    if rng is not None and rng[w.index] <= 0:
                        continue  # this lane never ran the id
                    if w.fence_cid(cid):
                        comps.append((cid, time.perf_counter()))
                w.fence()
                done_at[w.index] = time.perf_counter()
                comp_at[w.index] = comps

            if n == 1:
                fences = [lambda: fence_timed(self.workers[0])]
            else:
                fences = [self.pool.submit(fence_timed, w).result for w in self.workers]
            for wait in fences:
                try:
                    wait()
                except Exception as e:
                    errs.append(e)
            if errs:
                record_crash("cores.barrier", errs[0], lanes=self._lane_config())
                raise errs[0]
            for w in self.workers:
                self._settle_measures(w)
            if measure:
                iters = max(1, sum(window_iters.values()))
                # lane health: each lane's fence wall of the window, per
                # iteration (a window four times longer is not a lane four
                # times slower).  A quarantined lane ran nothing: its fence
                # wall is no evidence, and in the baseline it would make
                # every later probe read degraded
                quarantined = self.drain.drained_lanes() if self.drain.enabled else set()
                for w in self.workers:
                    if w.index not in quarantined:
                        self.health.observe(w.index, "fence", (done_at[w.index] - t0) / iters)
                FLIGHT.event("barrier", lanes={
                    w.index: round((done_at[w.index] - t0) * 1000.0, 3) for w in self.workers
                }, iters=iters)
                for w in self.workers:
                    bench = (done_at[w.index] - t0) * 1000.0
                    splits = split_fence_benches(comp_at.get(w.index, ()), t0)
                    window_ms = {cid: splits.get(cid, bench) for cid in window_cids
                                 if self.global_ranges.get(cid, [1] * n)[w.index] > 0}
                    with w.lock:
                        w.benchmarks.update(per_iteration_benches(window_ms, window_iters))
                with self._lock:
                    self._enqueue_rebalance |= window_cids
            TRACER.record("fence", t_b, tag="barrier")
        finally:
            REGISTRY.histogram("ck_barrier_seconds", "barrier wall time").observe(
                time.perf_counter() - _mt0)
            # a throttled metric sample into the flight ring, and the
            # decision log's throttled spill (armed by CK_DECISION_LOG)
            FLIGHT.maybe_sample_metrics()
            DECISIONS.maybe_spill()
            # drain actuation: the barrier is the one place the quarantine
            # state moves; a move arms a re-split for every compute id, and
            # in enqueue mode the moved ranges take the flush-and-reset path
            self._drain_evaluate()
            self._enqueue_window_closed()

    def _drain_evaluate(self) -> None:
        """One :class:`DrainController` transition (the barrier's tail).  It
        runs in the barrier's ``finally``, so it must not raise over the
        fence error the barrier exists to surface."""
        try:
            res = self.drain.evaluate()
        except Exception as e:  # noqa: BLE001 - must not mask a fence error
            FLIGHT.event("drain-apply", error=f"{type(e).__name__}: {e}"[:200])
            return
        if res and (res["drained"] or res["readmitted"] or res["probed"]):
            with self._lock:
                self._enqueue_rebalance |= set(self.global_ranges)

    def _enqueue_window_closed(self) -> None:
        with self._lock:
            self._enqueue_cids.clear()
            self._enqueue_cid_order.clear()
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

    def performance_history(self, compute_id: int) -> list[ComputePerf]:
        """The last 64 reports of ``compute_id``, oldest first."""
        return list(self.perf_log.get(compute_id, ()))

    def ranges_of(self, compute_id: int) -> list[int]:
        return list(self.global_ranges.get(compute_id, []))

    def serve_debug(self, port: int = 0, host: str = "127.0.0.1"):
        """Start the live debug HTTP server (``obs/debugserver.py``) over
        this scheduler on a daemon thread.  ``port=0`` binds an ephemeral
        port: read it from the returned server's ``.port``.  Idempotent per
        Cores: a second call returns the running server."""
        if self._debug_server is None:
            from ..obs.debugserver import DebugServer

            self._debug_server = DebugServer(self, port=port, host=host)
            FLIGHT.event("debug-server", port=self._debug_server.port)
        return self._debug_server

    def health_report(self) -> dict:
        """Per-lane health verdicts (``obs/health.py``): ``{lane:
        {"verdict": ok|suspect|degraded, "score", "evidence"}}``.  The
        drain acts on them at barriers (:attr:`drain`)."""
        return self.health.report()

    def _lane_config(self) -> dict:
        """The lanes' configuration as the reference reports it: devices,
        range tables and the transfer toggles with each lane's last chunk
        count."""
        return {"devices": self.device_names(),
                "ranges": {str(cid): list(r) for cid, r in self.global_ranges.items()},
                "enqueue_mode": self.enqueue_mode, "fused_dispatch": self.fused_dispatch,
                "streamed_transfers": self.streamed_transfers,
                "stream_chunks": dict(self.last_stream_chunks)}

    def dispose(self) -> None:
        """Dispose every lane, then raise the first failure a lane's last
        fence surfaced.  The debug server closes and the decision log's
        tail is spilled first (under ``CK_DECISION_LOG``)."""
        if self._debug_server is not None:
            self._debug_server.close()
            self._debug_server = None
        DECISIONS.maybe_spill(force=True)
        errs = []
        for w in self.workers:
            try:
                w.dispose()
            except Exception as e:  # every lane is released before raising
                errs.append(e)
        self.pool.shutdown(wait=False)
        if errs:
            raise errs[0]
