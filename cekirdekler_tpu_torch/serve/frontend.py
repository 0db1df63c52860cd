"""ServeFrontend: N concurrent clients, one shared scheduler.

A copy of the reference's ``serve/frontend.py`` kept in the port (which
never imports the JAX package), over the port's ``Cores``: requests group
on the port's ``core.cores.job_signature`` and dispatch through
``Cores.compute_fused_batch``; on a GPU lane a batch runs the lane's
kernels on the lane's own streams (a dispatcher thread's current stream is
never used), and a failed build or launch fails its requests with the
named error, with nothing run on the host instead.  ``warmup`` routes to
``Cores.warmup``.  The text below is the reference's.

The thread-safe, in-process multi-tenant front-end over one shared
:class:`~cekirdekler_tpu_torch.core.cores.Cores`: clients call
:meth:`ServeFrontend.submit` (futures-based; :meth:`ServeFrontend.call`
is the blocking convenience) from any thread; admission
(``serve/admission.py``) enforces per-tenant quotas, queue-depth
backpressure, and the lane-health gate; and ONE dispatcher thread
drains the queues — the enqueue-window machinery is single-driver by
contract (core/cores.py KNOWN LIMIT), so the frontend IS that single
driver and every client rides it.

**Request coalescing is batching.**  Pending requests group by job
signature (kernels + param identity + ranges + values — the fused
window's own key); each dispatch cycle plans an order over the groups
(``serve/coalescer.py``: fairness promotions, then earliest deadline,
then oldest arrival) and dispatches each picked group as ONE fused
ladder per device via ``Cores.compute_fused_batch`` — a coalesced
batch of K same-signature requests costs one per-call iteration plus
one K−1-iteration ladder launch, not K dispatches, because the
shape-only executable cache makes every batch a compile hit.  The
cycle closes with one ``barrier()`` (balancer feedback) + ``flush()``
(host results), and every request's future resolves with its measured
latency.

Every admission decision and every coalescing plan lands in the
decision log (kinds ``admission`` / ``coalesce``) with complete
inputs, so ``ckreplay verify`` re-derives them offline — a tenant
disputing a rejection or a starvation is answered from the log.

``/servez`` (obs/debugserver.py) serves :func:`servez_payload`: every
live frontend's queue depths, group table, tenant accounting, and
admission configuration.
"""

from __future__ import annotations

import os
import random
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Sequence

from ..analysis import flag_row
from ..errors import (
    CekirdeklerError,
    ComputeValidationError,
    FusedBatchError,
    InjectedFaultError,
)
from ..metrics.registry import REGISTRY
from ..obs.decisions import DECISIONS
from ..obs.flight import FLIGHT, record_crash
from ..obs.reqtrace import REQTRACE
from ..utils.faultinject import FAULTS
from .admission import AdmissionController, ServeRejected
from .coalescer import plan_coalesce
from .resilience import (
    BreakerBoard,
    ResilienceConfig,
    RetryBudgets,
    brownout_transition,
    containment_plan,
    retry_decision,
)
from .tenants import TenantTable

__all__ = ["ServeFrontend", "ServeJob", "servez_payload"]

#: Requests-per-batch histogram buckets (count-flavored, not the
#: seconds-flavored defaults).
_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)

#: Windowed-latency ring size: the ``/servez`` row reports p50/p99
#: over the last N settled requests NEXT TO the lifetime-cumulative
#: tenant accounting — a live operator needs the CURRENT tail, and a
#: long-lived frontend's cumulative stats dilute a regime change into
#: invisibility (pinned by the two-regime test).
_LAT_WINDOW = 512


def _window_latency(values, window: int = _LAT_WINDOW) -> dict:
    """PURE: the windowed p50/p99 snapshot for the ``/servez`` row
    (nearest-rank over the last ``window`` settled-request walls)."""
    vals = sorted(float(v) for v in list(values)[-window:])
    if not vals:
        return {"window": window, "count": 0,
                "p50_ms": None, "p99_ms": None}
    n = len(vals)

    def _rank(p):
        return vals[min(max(int(round(p / 100.0 * (n - 1))), 0), n - 1)]

    return {"window": window, "count": n,
            "p50_ms": _rank(50.0) * 1e3, "p99_ms": _rank(99.0) * 1e3}


@dataclass(frozen=True)
class ServeJob:
    """A frozen, resubmittable kernel job (the serving tier's analogue
    of ``pipeline.pool.ClTask``).  Params enter the signature by OBJECT
    identity — the worker buffer caches key on ``id(arr)``, so equal
    shapes in different arrays are different dispatches (and different
    coalescing groups)."""

    params: Sequence = ()
    kernels: Sequence[str] = ()
    compute_id: int = 0
    global_range: int = 0
    local_range: int = 256
    global_offset: int = 0
    values: Sequence | dict = ()

    def signature(self) -> tuple:
        # the ONE shared construction (core/cores.job_signature): the
        # grouping key here and the fused window's key must be the
        # identical tuple, or batches silently stop matching open
        # windows and every dispatch falls back to per-call
        from ..core.cores import job_signature

        return job_signature(
            self.kernels, self.params, self.compute_id, self.global_range,
            self.local_range, self.global_offset, self.values,
        )


@dataclass
class _Request:
    job: ServeJob
    tenant: str
    future: Future
    t_submit: float
    deadline_t: float | None  # absolute perf_counter, None = no deadline
    rid: str = ""             # lifecycle id (obs/reqtrace.py)
    rt_queued: bool = False   # "queued" phase event already stamped


@dataclass
class _Group:
    key: str            # stable string id (plans/decisions/servez)
    sig: tuple          # the signature tuple (the dict key)
    reqs: list = field(default_factory=list)
    starved: int = 0    # consecutive planning rounds not picked


#: Sentinel outcome for a request deferred to the NEXT cycle by the
#: retry path (the inline-sleep budget ran out): not resolved, not
#: failed — re-queued into the group table, still in flight.
_REQUEUED = object()


# -- /servez registry ---------------------------------------------------------
_SERVEZ_MU = threading.Lock()
_FRONTENDS: list = []  # weakrefs, pruned on read


def _register_frontend(fe: "ServeFrontend") -> None:
    with _SERVEZ_MU:
        _FRONTENDS.append(weakref.ref(fe))


def servez_payload() -> dict:
    """The ``/servez`` debug-endpoint body: one row per live frontend
    (snapshot-copy discipline — nothing here blocks a submit for longer
    than the frontend's own small-state copy)."""
    # prune and snapshot under ONE lock hold: a rewrite from a stale
    # copy would permanently drop a frontend registered between the
    # copy and the rewrite (invisible to /servez for its whole life)
    with _SERVEZ_MU:
        _FRONTENDS[:] = [r for r in _FRONTENDS if r() is not None]
        fes = [r() for r in _FRONTENDS]
    fronts = [fe.stats() for fe in fes if fe is not None]
    return {"frontends": fronts, "count": len(fronts)}


class ServeFrontend:
    """The multi-tenant request front-end (see module docstring).

    ``cruncher`` is a :class:`~cekirdekler_tpu_torch.core.cruncher.NumberCruncher`
    the frontend takes over as the single enqueue driver — no other
    thread may drive computes through it while the frontend is open.
    ``autostart=False`` leaves the dispatcher thread unstarted
    (:meth:`step` runs one cycle synchronously — the deterministic
    test/bench seam); :meth:`start` spins it up later."""

    def __init__(
        self,
        cruncher,
        admission: AdmissionController | None = None,
        max_batch: int = 256,
        max_groups_per_cycle: int = 0,
        gather_window_s: float = 0.002,
        name: str = "serve",
        autostart: bool = True,
        resilience: ResilienceConfig | None = None,
    ):
        self.name = str(name)
        self.cruncher = cruncher
        self.cores = cruncher.cores
        # drain-aware health gate (obs/drain.py): a degraded lane that
        # the DrainController already quarantined means REDUCED CAPACITY,
        # not an outage — its share is redistributed and requests
        # re-dispatch onto the surviving lanes, so admission keeps
        # admitting (the raw HealthMonitor.healthy() would reject the
        # whole tier for the duration of every drain)
        rc0 = resilience or ResilienceConfig()
        self.admission = admission or AdmissionController(
            health=self.cores.drain.healthy_with_drains,
            shed_frac=rc0.shed_frac)
        self.tenants = TenantTable()
        self.max_batch = max(1, int(max_batch))
        self.max_groups_per_cycle = max(0, int(max_groups_per_cycle))
        self.gather_window_s = max(0.0, float(gather_window_s))
        # ONE lock/condition guards the whole admit→enqueue transition
        # and the group table: quota decisions are exact under
        # contention (the 32-thread test's contract), and the
        # dispatcher's pops can never interleave half an admit
        self._mu = threading.Condition()
        # serializes whole dispatch cycles: close(drain=True)'s final
        # step must never run concurrently with the dispatcher
        # thread's — two steppers would both drive the single-driver
        # Cores enqueue machinery (the contract the frontend exists
        # to enforce)
        self._step_mu = threading.Lock()
        self._groups: dict[tuple, _Group] = {}
        self._pending = 0
        self._round = 0
        self._batches = 0
        self._requests_done = 0
        self._group_seq = 0
        # recent dispatch-cycle wall (EMA) — the retry-after scale
        self._est_batch_s = 0.01
        self._halt = False
        self._dead: str | None = None  # dispatcher-crash cause (named)
        self._thread: threading.Thread | None = None
        # windowed settle latencies (seconds) — GIL-atomic appends from
        # the settle sites, snapshot-read by stats() (reporting only)
        # ckcheck: ok lock-free deque ring, list() copy on read, reporting-only tolerance
        self._lat_recent: deque = deque(maxlen=_LAT_WINDOW)
        # -- resilience layer (serve/resilience.py) --------------------------
        rc = self.resilience = rc0
        self.breakers = BreakerBoard(
            threshold=rc.breaker_threshold, open_s=rc.breaker_open_s,
            name=self.name)
        self.retry_budgets = RetryBudgets(
            cap=rc.retry_budget_cap, ratio=rc.retry_budget_ratio)
        self._retry_rng = random.Random(rc.retry_seed)
        self._brownout = {"active": False, "streak": 0}
        self._brownout_active = False  # lock-free submit-path read
        # cached handles (submit/resolve are the serving hot path)
        self._m_queue_depth = REGISTRY.gauge(
            "ck_serve_queue_depth", "pending (admitted, undispatched) "
            "serve requests")
        self._m_batches = REGISTRY.counter(
            "ck_serve_batches_total", "coalesced batches dispatched")
        self._m_batch_iters = REGISTRY.histogram(
            "ck_serve_batch_iters", "requests per coalesced batch",
            buckets=_BATCH_BUCKETS)
        self._m_retries = REGISTRY.counter(
            "ck_serve_retries_total",
            "serve request re-dispatch attempts granted by the retry "
            "budget")
        self._m_contained = {
            o: REGISTRY.counter(
                "ck_serve_contained_total",
                "fused-batch failures handled by blast-radius "
                "containment", outcome=o)
            for o in ("isolated", "retried", "aborted")
        }
        self._g_brownout = REGISTRY.gauge(
            "ck_serve_brownout", "brownout shedding active (0/1)")
        self._m_crashes = REGISTRY.counter(
            "ck_serve_dispatcher_crashes_total",
            "serve dispatcher threads lost to an escaping exception "
            "(in-flight futures failed with the named error)")
        self._m_warmups = REGISTRY.counter(
            "ck_serve_warmup_total",
            "job signatures precompiled by ServeFrontend.warmup (the "
            "cold-start ladder-set warm)")
        _register_frontend(self)
        if autostart:
            self.start()

    # -- client API ----------------------------------------------------------
    def submit(self, tenant: str, job: ServeJob,
               deadline: float | None = None,
               rid: str | None = None) -> Future:
        """Submit one job for ``tenant``; returns a
        :class:`~concurrent.futures.Future` resolving to the request
        record (``{"tenant", "latency_s", "batch_requests", "fused",
        "deadline_missed", ...}``) after the batch's flush — the job's
        host arrays are current at that point.  ``deadline`` is
        seconds-from-now (deadline-aware ordering; a late completion is
        flagged, never dropped).  Raises :class:`ServeRejected` (with
        ``retry_after_s``) when admission refuses.  ``rid`` is the
        request's lifecycle id (obs/reqtrace.py) — minted here when
        absent, passed through by :class:`~.fabric.ServeFabric` so a
        re-routed request keeps ONE rid across shards and
        processes."""
        if self._halt:
            raise CekirdeklerError(f"frontend {self.name!r} is closed")
        if self._dead is not None:
            # dispatcher-crash containment: a dead dispatcher must
            # reject immediately, never queue into a table nothing
            # will ever drain (a hang by another name)
            raise CekirdeklerError(
                f"frontend {self.name!r} dispatcher died: {self._dead}")
        t0 = time.perf_counter()
        rid = rid or REQTRACE.mint()
        jb = job if isinstance(job, ServeJob) else ServeJob(**job)
        sig = jb.signature()
        try:
            hash(sig)
        except TypeError:
            raise ComputeValidationError(
                "serve jobs need hashable values (array-valued value "
                "args cannot coalesce)")
        st = self.tenants.state(tenant)
        # kernel partition-safety gate (analysis/): under strict
        # verification an unsafe job is refused at the door with the
        # named verdict kind — the serving tier takes kernels from
        # untrusted tenants, and a mis-flagged kernel would corrupt
        # results for everyone sharing the coalesced window.  Verdicts
        # cache per launch shape in the program, so steady state is
        # one env read + one dict hit; computed OUTSIDE the frontend
        # lock (the admit transition must stay short).
        kernel_finding = None
        if jb.kernels and \
                os.environ.get("CK_KERNEL_VERIFY", "advisory") == "strict":
            v = self.cores.program.verify(
                tuple(jb.kernels),
                tuple(flag_row(p.flags) for p in jb.params),
                window=True)
            if v.errors:
                kernel_finding = v.errors[0]
        fut: Future = Future()
        with self._mu:
            if self._halt:
                # re-checked under the lock: a submit racing close()
                # past the unlocked pre-check must not enqueue into a
                # table close() already drained (its future would
                # never resolve — a silent drop by another name)
                raise CekirdeklerError(
                    f"frontend {self.name!r} is closed")
            if self._dead is not None:
                # same race against a dispatcher crash: the crash
                # handler drained the table; enqueuing after it means
                # a future nothing will ever resolve
                raise CekirdeklerError(
                    f"frontend {self.name!r} dispatcher died: "
                    f"{self._dead}")
            inflight = self.tenants.note_request(st)
            # circuit breaker for this (tenant, job-signature): open =
            # the job class is failing; the admit may CONSUME the
            # half-open probe slot, released below if a later gate
            # rejects (the probe never dispatched, so the slot must
            # reopen).  One dict miss for breakerless keys.
            bkey = (str(tenant), sig, jb.compute_id)
            brk = self.breakers.admit(bkey, time.perf_counter())
            dec = self.admission.check(
                tenant, inflight, self._pending, self._est_batch_s,
                kernel_unsafe=kernel_finding is not None,
                kernel_finding=(kernel_finding.kind
                                if kernel_finding else None),
                breaker_open=not brk["allow"],
                breaker_retry_after_s=brk["retry_after_s"],
                brownout=self._brownout_active, rid=rid)
            if brk["probe"] and not dec["admit"]:
                self.breakers.release_probe(bkey)
            if dec["admit"]:
                self.tenants.note_admitted(st)
                g = self._groups.get(sig)
                if g is None:
                    self._group_seq += 1
                    g = _Group(
                        key=f"g{self._group_seq}-cid{jb.compute_id}",
                        sig=sig)
                    self._groups[sig] = g
                g.reqs.append(_Request(
                    job=jb, tenant=str(tenant), future=fut, t_submit=t0,
                    deadline_t=(t0 + float(deadline)
                                if deadline is not None else None),
                    rid=rid,
                ))
                self._pending += 1
                self._m_queue_depth.set(self._pending)
                if REQTRACE.enabled:
                    # stamped INSIDE the lock: the dispatcher could pop
                    # this request the moment the lock releases, and a
                    # "queued" stamp landing before "admitted" would
                    # fold into a negative phase.  wait_s is the
                    # pre-event admission wait the chain's telescoping
                    # cannot see (no earlier stamp exists).
                    REQTRACE.event(
                        rid, "admitted", tenant=str(tenant),
                        group=g.key,
                        wait_s=time.perf_counter() - t0)
                self._mu.notify()
        if not dec["admit"]:
            self.tenants.note_rejected(st, dec["reason"])
            if REQTRACE.enabled:
                REQTRACE.event(
                    rid, "failed", name=str(dec["reason"]),
                    tenant=str(tenant),
                    latency_s=time.perf_counter() - t0)
            raise ServeRejected(
                str(tenant), dec["reason"], float(dec["retry_after_s"]))
        return fut

    def call(self, tenant: str, job: ServeJob,
             deadline: float | None = None, timeout: float | None = None,
             rid: str | None = None):
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(tenant, job, deadline=deadline,
                           rid=rid).result(timeout)

    # -- the dispatcher ------------------------------------------------------
    def start(self) -> None:
        if self._dead is not None:
            # a restarted loop would be a zombie: submit() keeps
            # rejecting on the _dead gate, so the thread could only
            # burn cycles while the frontend refuses all work
            raise CekirdeklerError(
                f"frontend {self.name!r} dispatcher died: {self._dead} "
                "— create a new frontend")
        if self._thread is None or not self._thread.is_alive():
            self._halt = False
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"ck-serve-{self.name}")
            self._thread.start()

    def _loop(self) -> None:
        try:
            while not self._halt:
                with self._mu:
                    while self._pending == 0 and not self._halt:
                        self._mu.wait(0.2)
                        if self._brownout_active:
                            break  # idle release evaluation below
                    if self._halt:
                        break
                    pending = self._pending
                if pending == 0:
                    # brownout release must not wait for traffic:
                    # cycles (and their evaluations) only run while
                    # requests are pending, so an engaged brownout
                    # over an idle tier would otherwise stay engaged
                    # forever and shed the FIRST burst after the idle
                    # period (sticky degraded mode by the back door)
                    self._evaluate_brownout()
                    continue
                if self.gather_window_s:
                    # the coalescing window: let a concurrent burst land
                    # in the groups before planning — this wait is what
                    # turns 32 near-simultaneous submits into one ladder
                    time.sleep(self.gather_window_s)
                self.step()
        except BaseException as e:  # noqa: BLE001 - crash containment:
            # an exception escaping the dispatcher loop used to kill
            # the thread SILENTLY — every in-flight and future submit()
            # then hung forever.  Now: in-flight futures fail with the
            # named error, a postmortem dumps, and submit() after
            # dispatcher death rejects immediately.
            self._dispatcher_crashed(e)

    def _dispatcher_crashed(self, exc: BaseException) -> None:
        """Dispatcher-crash containment (never raises): name the cause,
        fail everything in flight, dump the black box, refuse further
        submits."""
        self._dead = f"{type(exc).__name__}: {exc}"
        try:
            self._m_crashes.inc()
            FLIGHT.event(
                "serve-crash", frontend=self.name,
                exc_type=type(exc).__name__, exc=str(exc)[:500])
            record_crash(f"serve.{self.name}.dispatcher", exc)
        except Exception:  # noqa: BLE001 - observing is optional
            pass
        self._fail_leftovers(
            f"frontend {self.name!r} dispatcher died: {self._dead}")

    def _shutdown_error(self) -> CekirdeklerError:
        """The ONE shutdown-during-containment error: message and the
        ``_ck_shutdown`` marker (which gates the breaker feed — a
        shutdown-synthesized failure must never open a breaker) live
        here so the three halt paths cannot drift."""
        err = CekirdeklerError(
            f"frontend {self.name!r} closed during containment "
            "re-dispatch")
        err._ck_shutdown = True
        return err

    @staticmethod
    def _settle(fut: Future, value=None, exc: Exception | None = None
                ) -> None:
        """Resolve a future TOLERATING client-side cancellation: a
        queued future is legally cancellable, and a cancelled (or
        already-settled) one refuses set_result/set_exception with
        InvalidStateError — one tenant's fut.cancel() must never
        escape the dispatch cycle and take the whole frontend down."""
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(value)
        except InvalidStateError:
            pass  # the client already settled it (cancel)

    def _fail_leftovers(self, message: str) -> None:
        """Drain the group table and fail every queued request with the
        named error — the no-silent-drop rule applied to shutdown AND
        dispatcher death (the two callers)."""
        with self._mu:
            self._mu.notify_all()
            leftovers = []
            for g in self._groups.values():
                leftovers.extend(g.reqs)
                g.reqs = []
            self._groups.clear()
            self._pending = 0
            self._m_queue_depth.set(0)
        for r in leftovers:
            st = self.tenants.state(r.tenant)
            lat = time.perf_counter() - r.t_submit
            self.tenants.note_done(
                st, lat, failed=True, deadline_missed=False)
            if REQTRACE.enabled:
                # NOT chain-terminal when the fabric re-routes: the
                # outer future catches this named clean failure and the
                # same rid continues with `rerouted` on a survivor
                REQTRACE.event(r.rid, "failed", name="shutdown",
                               tenant=r.tenant, latency_s=lat)
            self._settle(r.future, exc=CekirdeklerError(message))

    def step(self) -> dict:
        """Run ONE dispatch cycle synchronously: plan → dispatch each
        picked group as a fused batch → barrier + flush → resolve
        futures.  The test/bench seam (``autostart=False``) and the
        dispatcher loop body.  Cycles are serialized (``_step_mu``):
        the Cores enqueue machinery is single-driver by contract, so a
        close-time drain and the dispatcher thread must take turns."""
        with self._step_mu:
            return self._step_locked()

    def _step_locked(self) -> dict:
        now = time.perf_counter()
        # brownout evaluation rides every cycle (cold — once per cycle,
        # before the pops, so the pressure reading is the honest
        # pre-dispatch queue depth)
        self._evaluate_brownout()
        with self._mu:
            summary = []
            for g in self._groups.values():
                if not g.reqs:
                    continue
                deadlines = []
                for r in g.reqs:
                    if r.deadline_t is not None:
                        deadlines.append(r.deadline_t)
                    if not r.rt_queued:
                        # "queued" stamps ONCE per request, at the
                        # first planning cycle that sees its group —
                        # the queued phase is submit → cycle entry,
                        # the coalesce-wait phase starts here
                        r.rt_queued = True
                        if REQTRACE.enabled:
                            REQTRACE.event(r.rid, "queued", group=g.key)
                summary.append({
                    "key": g.key,
                    "pending": len(g.reqs),
                    "deadline_in_s": (min(deadlines) - now
                                      if deadlines else None),
                    "oldest_age_s": now - g.reqs[0].t_submit,
                    "starved_rounds": g.starved,
                    # rids ride the coalesce record as an INPUT (the
                    # `ckreplay explain --rid` join key; the pure
                    # plan_coalesce ignores unknown keys) — built only
                    # when the log is on
                    "rids": ([r.rid for r in g.reqs]
                             if DECISIONS.enabled else []),
                })
            rnd = self._round
            self._round += 1
        if not summary:
            return {"batches": 0, "requests": 0}
        summary.sort(key=lambda r: r["key"])
        plan = plan_coalesce(summary, rnd, self.max_groups_per_cycle)
        if DECISIONS.enabled:
            DECISIONS.record("coalesce", {
                "groups": summary, "round": rnd,
                "max_picks": self.max_groups_per_cycle,
            }, dict(plan))
        picked = set(plan["picked"])
        batches: list[tuple[_Group, list[_Request]]] = []
        with self._mu:
            for g in list(self._groups.values()):
                if g.key in picked and g.reqs:
                    take = g.reqs[: self.max_batch]
                    del g.reqs[: len(take)]
                    self._pending -= len(take)
                    g.starved = 0
                    batches.append((g, take))
                    if REQTRACE.enabled:
                        # the coalescer picked this group: the
                        # batching delay (cycle entry → pick) closes
                        for r in take:
                            REQTRACE.event(
                                r.rid, "coalesce-wait", group=g.key,
                                round=rnd, batch=len(take))
                elif g.reqs:
                    g.starved += 1
                if not g.reqs:
                    # empty groups leave the table (their signature
                    # re-registers on the next submit; the fused
                    # window's candidate memory lives in Cores)
                    self._groups.pop(g.sig, None)
            self._m_queue_depth.set(self._pending)
        if not batches:
            return {"batches": 0, "requests": 0}
        popped = [r for _g, reqs in batches for r in reqs]
        try:
            return self._run_cycle(batches, plan, now)
        except BaseException as e:
            # crash containment for the POPPED requests: they are in
            # neither the group table (the pop removed them) nor a
            # resolved future — without this, a cycle crash would
            # leave their clients blocked forever while
            # _dispatcher_crashed drains only the table
            err = CekirdeklerError(
                f"frontend {self.name!r} dispatch cycle failed: "
                f"{type(e).__name__}: {e}")
            t_c = time.perf_counter()
            for r in popped:
                if r.future.done():
                    continue
                try:
                    self.tenants.note_done(
                        self.tenants.state(r.tenant), t_c - r.t_submit,
                        failed=True, deadline_missed=False)
                except Exception:  # noqa: BLE001 - settling outranks it
                    pass
                if REQTRACE.enabled:
                    REQTRACE.event(
                        r.rid, "failed", name="dispatch-cycle-crash",
                        tenant=r.tenant, latency_s=t_c - r.t_submit)
                self._settle(r.future, exc=err)
            raise

    def _run_cycle(self, batches, plan, now: float) -> dict:
        """The popped-requests half of one dispatch cycle (see
        :meth:`_step_locked`, which guarantees every popped request's
        future settles even if this crashes)."""
        if not self.cores.enqueue_mode:
            self.cores.enqueue_mode = True
        results: list[tuple[
            _Group, list[_Request],
            list[tuple[dict | None, Exception | None]]]] = []
        requeue: list[tuple[_Group, _Request]] = []
        for g, reqs in batches:
            results.append(
                (g, reqs, self._dispatch_group(g, reqs, requeue)))
        sync_err: Exception | None = None
        try:
            self.cores.barrier()   # balancer feedback for the window
            self.cores.flush()     # host results for the resolving futures
        except Exception as e:  # noqa: BLE001 - fails the cycle's futures
            sync_err = e
        t_done = time.perf_counter()
        with self._mu:
            self._est_batch_s = (
                0.5 * self._est_batch_s + 0.5 * max(t_done - now, 1e-4))
            self._batches += len(batches)
        n_requests = n_failed = 0
        for g, reqs, outcomes in results:
            self._m_batches.inc()
            self._m_batch_iters.observe(len(reqs))
            for r, (info, err) in zip(reqs, outcomes):
                if err is _REQUEUED:
                    continue  # re-dispatches next cycle, still in flight
                n_requests += 1
                # a sync failure voids even contained successes: their
                # flush never landed, the host arrays are not current
                err = err or sync_err
                st = self.tenants.state(r.tenant)
                lat = t_done - r.t_submit
                self._lat_recent.append(lat)
                if REQTRACE.enabled:
                    # the fused-window wall retired at t_done (barrier
                    # fence + flush): this stamp closes every batch
                    # rider's device phase; the window wall and batch
                    # size ride along for apportionment
                    REQTRACE.event(
                        r.rid, "device",
                        window_wall_s=t_done - now,
                        batch_requests=len(reqs),
                        fused=bool(info and info.get("fused")))
                bkey = (r.tenant, g.sig, r.job.compute_id)
                if err is not None:
                    n_failed += 1
                    self.tenants.note_done(
                        st, lat, failed=True, deadline_missed=False)
                    if not getattr(err, "_ck_shutdown", False):
                        # shutdown-synthesized failures are the
                        # frontend's doing, not the job class's: they
                        # must not open breakers (or pollute the
                        # breaker decision log) for work that was
                        # never allowed to dispatch
                        self.breakers.note(bkey, "failure", t_done)
                        lane = getattr(err, "lane", None)
                        if lane is not None:
                            # lane-attributed failure: the per-lane
                            # breaker feeds the brownout pressure
                            self.breakers.note(
                                ("lane", int(lane)), "failure", t_done)
                    if REQTRACE.enabled:
                        REQTRACE.event(
                            r.rid, "failed",
                            name=type(err).__name__, tenant=r.tenant,
                            latency_s=lat)
                    self._settle(r.future, exc=err)
                    continue
                missed = (r.deadline_t is not None
                          and t_done > r.deadline_t)
                self.tenants.note_done(
                    st, lat, failed=False, deadline_missed=missed)
                self.breakers.note(bkey, "success", t_done)
                self.retry_budgets.note_success(r.tenant)
                if REQTRACE.enabled:
                    REQTRACE.event(
                        r.rid, "resolved", tenant=r.tenant,
                        latency_s=lat, deadline_missed=missed)
                self._settle(r.future, value={
                    "tenant": r.tenant,
                    "latency_s": lat,
                    "batch_requests": len(reqs),
                    "fused": bool(info and info.get("fused")),
                    "ladder_iters": (info or {}).get("ladder_iters", 0),
                    "deadline_missed": missed,
                })
        if requeue:
            self._requeue(requeue)
        with self._mu:
            self._requests_done += n_requests
        return {"batches": len(batches), "requests": n_requests,
                "failed": n_failed, "requeued": len(requeue),
                "plan": plan}

    def _requeue(self, requeue: list) -> None:
        """Put budget-deferred retries back into the group table so the
        NEXT cycle re-dispatches them (the inline-sleep budget bounds
        how long one cycle may stall on backoff; the gather cadence
        provides the spacing instead).  Still-admitted, still in
        flight — unless the frontend is halting, in which case they
        fail with the named shutdown error."""
        with self._mu:
            if not self._halt and self._dead is None:
                for g, r in requeue:
                    grp = self._groups.setdefault(g.sig, g)
                    grp.reqs.append(r)
                    self._pending += 1
                self._m_queue_depth.set(self._pending)
                self._mu.notify()
                return
        err = self._shutdown_error()
        for _g, r in requeue:
            lat = time.perf_counter() - r.t_submit
            self.tenants.note_done(
                self.tenants.state(r.tenant), lat, failed=True,
                deadline_missed=False)
            if REQTRACE.enabled:
                REQTRACE.event(r.rid, "failed", name="shutdown",
                               tenant=r.tenant, latency_s=lat)
            self._settle(r.future, exc=err)

    # -- blast-radius containment (serve/resilience.py) ----------------------
    def _dispatch_group(
        self, g: _Group, reqs: list, requeue: list,
    ) -> list[tuple[dict | None, Exception | None]]:
        """Dispatch one coalesced group with blast-radius containment:
        the whole batch rides ONE ``compute_fused_batch`` on the happy
        path; a CLEAN failure (the residue never reached any lane —
        ``FusedBatchError.clean``) bisects down to the faulty request,
        which fails with its NAMED cause while every neighbor completes
        bit-identically; single-request failures consult the tenant's
        retry budget before becoming final.  Returns one
        ``(info, err)`` per request, in request order — every popped
        request gets exactly one outcome (never a silent drop): a
        result, a named error, or the ``_REQUEUED`` sentinel (backoff
        deferred to the next cycle once this cycle's inline-sleep
        budget is spent — one slow group must not stall every tenant's
        dispatch; attempts reset with the fresh cycle, the token
        budget is the cross-cycle bound)."""
        jb = reqs[0].job
        n = len(reqs)
        if REQTRACE.enabled:
            for r in reqs:
                REQTRACE.event(r.rid, "dispatched", group=g.key, batch=n)
        infos: list = [None] * n
        errs: list = [None] * n
        attempts = [0] * n
        sleep_left = [float(self.resilience.retry_inline_budget_s)]
        work: deque = deque([(0, n)])
        while work:
            if self._halt:
                # shutdown racing an in-flight retry/bisection: stop
                # dispatching IMMEDIATELY — anything not yet resolved
                # fails with the named shutdown error, and no dispatch
                # ever follows the halt (pinned by test)
                err = self._shutdown_error()
                for i in range(n):
                    if infos[i] is None and errs[i] is None:
                        errs[i] = err
                break
            start, count = work.popleft()
            try:
                if FAULTS.enabled:
                    # chaos point `serve-dispatch` (utils/faultinject):
                    # a serving-layer fault injectable without going
                    # through a driver queue — fires per dispatch
                    # attempt, before anything reaches the Cores
                    FAULTS.raise_if_fired(
                        "serve-dispatch", where=self.name)
                info = self.cores.compute_fused_batch(
                    list(jb.kernels), list(jb.params), jb.compute_id,
                    jb.global_range, jb.local_range, count,
                    global_offset=jb.global_offset,
                    value_args=jb.values,
                )
                if REQTRACE.enabled and info.get("cache_misses"):
                    # the window paid a compile-cache miss (the cores
                    # fused-batch hook samples core/compilecache's
                    # counters around the dispatch): the warm/compile
                    # phase splits off the device wall for this batch
                    for i in range(start, start + count):
                        REQTRACE.event(
                            reqs[i].rid, "warm-compile",
                            misses=info["cache_misses"],
                            hits=info.get("cache_hits", 0))
                for i in range(start, start + count):
                    infos[i] = info
            except Exception as e:  # noqa: BLE001 - contained below
                self._contain_failure(
                    g, reqs, e, start, count, infos, errs, attempts,
                    work, requeue, sleep_left)
        return list(zip(infos, errs))

    def _contain_failure(self, g: _Group, reqs: list,
                         exc: Exception, start: int, count: int,
                         infos: list, errs: list, attempts: list,
                         work, requeue: list, sleep_left: list) -> None:
        """One failed dispatch part → containment: mark the iterations
        that APPLIED as successes, bisect a clean multi-request
        residue, retry-or-fail a single request, abort (named) a dirty
        one."""
        rc = self.resilience
        if isinstance(exc, FusedBatchError):
            applied, clean = exc.applied_iters, exc.clean
            cause = exc.cause
            base_err: Exception = exc.original \
                if isinstance(exc.original, Exception) else exc
        elif isinstance(exc, InjectedFaultError):
            # the serve-dispatch point fires BEFORE anything reaches
            # the Cores: nothing applied, residue clean by construction
            applied, clean = 0, True
            cause, base_err = f"injected:{exc.point}", exc
        else:
            # an unexpected failure mid-batch: assume the worst
            applied, clean = 0, False
            cause, base_err = type(exc).__name__, exc
        if not clean:
            # DIRTY failure: lanes may hold diverged iteration counts —
            # the group's SHARED array may be torn by the half-applied
            # residue, which invalidates even this batch's
            # already-applied iterations (a "success" future promises
            # host arrays that are current and correct).  Fail the
            # WHOLE group with the NAMED `partial-window` error, stop
            # dispatching its parts, and pull back any of its
            # budget-deferred retries — never guesswork, never a torn
            # array handed out as success.
            err = CekirdeklerError(
                f"partial-window ({cause}): the group's device state "
                "may have diverged mid-window — all "
                f"{len(reqs)} coalesced request(s) failed, re-dispatch "
                "refused")
            err._ck_shutdown = getattr(base_err, "_ck_shutdown", False)
            for i in range(len(reqs)):
                infos[i] = None
                errs[i] = err
            work.clear()
            requeue[:] = [(gg, r) for gg, r in requeue if gg is not g]
            self._m_contained["aborted"].inc()
            FLIGHT.event("serve-contain", frontend=self.name,
                         group=g.key, cause=cause, outcome="aborted",
                         requests=len(reqs))
            if REQTRACE.enabled:
                for r in reqs:
                    REQTRACE.event(r.rid, "contained", group=g.key,
                                   cause=cause, outcome="aborted")
            return
        applied = max(0, min(int(applied), count))
        for i in range(start, start + applied):
            # these iterations completed dispatch before the failure —
            # their requests succeed exactly as in an unfaulted run
            infos[i] = {"iters": count, "fused": False,
                        "ladder_iters": 0, "per_call_iters": applied,
                        "contained": True}
        rest_start, rest = start + applied, count - applied
        if rest <= 0:
            return
        if not rc.containment:
            # containment disabled: the clean residue fails with its
            # named cause (no bisection, no retry — but no silent drop)
            for i in range(rest_start, rest_start + rest):
                errs[i] = base_err
            self._m_contained["aborted"].inc()
            FLIGHT.event("serve-contain", frontend=self.name,
                         group=g.key, cause=cause, outcome="aborted",
                         requests=rest)
            if REQTRACE.enabled:
                for i in range(rest_start, rest_start + rest):
                    REQTRACE.event(
                        reqs[i].rid, "contained", group=g.key,
                        cause=cause, outcome="aborted")
            return
        if rest > 1:
            plan = containment_plan(rest, rc.bisect_leaf)
            if DECISIONS.enabled:
                DECISIONS.record("containment", {
                    "k": rest, "leaf": rc.bisect_leaf,
                    "group": g.key, "cause": cause,
                    "rids": [reqs[i].rid
                             for i in range(rest_start,
                                            rest_start + rest)],
                }, dict(plan))
            FLIGHT.event("serve-contain", frontend=self.name,
                         group=g.key, cause=cause, outcome="bisect",
                         parts=list(plan["parts"]))
            if REQTRACE.enabled:
                for i in range(rest_start, rest_start + rest):
                    REQTRACE.event(
                        reqs[i].rid, "contained", group=g.key,
                        cause=cause, outcome="bisect",
                        parts=len(plan["parts"]))
            off = rest_start
            parts = []
            for p in plan["parts"]:
                parts.append((off, int(p)))
                off += int(p)
            work.extendleft(reversed(parts))
            return
        # a single isolated request: deadline-aware, budget-gated retry
        i = rest_start
        r = reqs[i]
        tokens = self.retry_budgets.tokens(r.tenant)
        deadline_left = (r.deadline_t - time.perf_counter()
                         if r.deadline_t is not None else None)
        u = self._retry_rng.random()
        rd = retry_decision(
            attempts[i], rc.retry_max_attempts, tokens, deadline_left,
            rc.retry_base_s, rc.retry_cap_s, u)
        if DECISIONS.enabled:
            DECISIONS.record("retry", {
                "attempt": attempts[i],
                "max_attempts": rc.retry_max_attempts,
                "tokens": tokens,
                "deadline_left_s": deadline_left,
                "base_s": rc.retry_base_s,
                "cap_s": rc.retry_cap_s,
                "jitter_u": u,
                "tenant": r.tenant,
                "cause": cause,
                "rid": r.rid,
            }, dict(rd))
        if rd["retry"] and self._halt:
            # a GRANTED retry suppressed by shutdown is a shutdown
            # outcome, not a retry-gate refusal: the named close error
            # (every other halt path's), never the raw dispatch error
            # with a null refusal reason
            errs[i] = self._shutdown_error()
            FLIGHT.event("serve-contain", frontend=self.name,
                         group=g.key, cause=cause, outcome="halted")
            return
        if rd["retry"]:
            self.retry_budgets.spend(r.tenant)
            self._m_retries.inc()
            self._m_contained["retried"].inc()
            delay = float(rd["delay_s"])
            if delay <= sleep_left[0]:
                # fast path: backoff fits this cycle's inline budget
                sleep_left[0] -= delay
                attempts[i] += 1
                time.sleep(delay)
                if REQTRACE.enabled:
                    REQTRACE.event(
                        r.rid, "retry-backoff", delay_s=delay,
                        attempt=attempts[i], deferred=False)
                work.appendleft((i, 1))
            else:
                # the cycle's inline-sleep budget is spent: a blocking
                # backoff here would stall EVERY group and tenant (and
                # close()) behind one request — defer to the next
                # cycle instead; the gather cadence is the spacing
                errs[i] = _REQUEUED
                requeue.append((g, r))
                if REQTRACE.enabled:
                    REQTRACE.event(
                        r.rid, "retry-backoff", delay_s=delay,
                        attempt=attempts[i], deferred=True)
            return
        errs[i] = base_err  # the NAMED cause, isolated to this request
        self._m_contained["isolated"].inc()
        FLIGHT.event("serve-contain", frontend=self.name, group=g.key,
                     cause=cause, outcome="isolated",
                     refusal=rd["reason"])
        if REQTRACE.enabled:
            REQTRACE.event(r.rid, "contained", group=g.key, cause=cause,
                           outcome="isolated", refusal=rd["reason"])

    def _evaluate_brownout(self) -> dict:
        """One per-cycle brownout evaluation (cold): sample the
        pressure signals, run the pure transition, publish the
        lock-free flag submit reads.  Engage/release records a
        replayable ``shed`` decision."""
        rc = self.resilience
        now = time.perf_counter()
        with self._mu:
            qd = self._pending
            state = dict(self._brownout)
        wm = max(1, int(self.admission.max_queue_depth
                        * rc.brownout_watermark_frac))
        cm = max(1, int(self.admission.max_queue_depth
                        * rc.brownout_clear_frac))
        ob = self.breakers.open_count(now)
        try:
            dl = len(self.cores.drain.drained_lanes())
        except Exception:  # noqa: BLE001 - drain plane is optional
            dl = 0
        out = brownout_transition(
            state, qd, wm, cm, ob, dl,
            engage_streak=rc.brownout_engage_streak)
        with self._mu:
            self._brownout = {"active": out["active"],
                              "streak": out["streak"]}
            self._brownout_active = out["active"]
        if out["changed"]:
            self._g_brownout.set(1.0 if out["active"] else 0.0)
            FLIGHT.event("brownout", frontend=self.name,
                         active=out["active"])
            if DECISIONS.enabled:
                DECISIONS.record("shed", {
                    "state": state, "queue_depth": qd,
                    "watermark": wm, "clear_mark": cm,
                    "open_breakers": ob, "drained_lanes": dl,
                    "engage_streak": rc.brownout_engage_streak,
                }, dict(out))
        return out

    def warmup(self, jobs) -> dict:
        """AOT-precompile the ladder set for a list of jobs (cold-start
        warmup): routes through ``Cores.warmup``, which builds and
        runs, on SCRATCH device buffers, the fused ladder under the
        EXACT key the live fused-window path requests (kernel sequence,
        step, range geometry, values, platform — a key mismatch would
        make warmup a silent no-op, pinned by test) plus every per-call
        chunk launcher the binary ladder can emit.  The given
        jobs are read for shapes/dtypes only and NEVER executed against
        — live params are safe to pass directly.  With
        ``CK_COMPILE_CACHE`` armed, warmed ladders persist to (and load
        from) the on-disk cross-process cache (core/compilecache.py).
        Counted via ``ck_serve_warmup_total`` per distinct warmed
        shape; returns ``{"warmed", "hits", "misses", "skipped",
        "wall_s"}``."""
        specs = []
        for job in jobs:
            jb = job if isinstance(job, ServeJob) else ServeJob(**job)
            specs.append(jb)
        out = self.cores.warmup(specs)
        warmed = int(out.get("warmed", 0))
        if warmed:
            self._m_warmups.inc(warmed)
        return out

    # -- views / lifecycle ---------------------------------------------------
    def stats(self) -> dict:
        """The ``/servez`` row for this frontend — snapshot copies
        only."""
        with self._mu:
            groups = [
                {"key": g.key, "pending": len(g.reqs), "starved": g.starved,
                 "cid": g.sig[0]}
                for g in self._groups.values() if g.reqs
            ]
            doc = {
                "name": self.name,
                "queue_depth": self._pending,
                "rounds": self._round,
                "batches": self._batches,
                "requests_done": self._requests_done,
                "est_batch_s": round(self._est_batch_s, 6),
                "max_batch": self.max_batch,
                "max_groups_per_cycle": self.max_groups_per_cycle,
                "dispatcher_alive": (self._thread is not None
                                     and self._thread.is_alive()),
                "groups": sorted(groups, key=lambda g: g["key"]),
                # the CURRENT tail (last-N window) next to the
                # lifetime-cumulative tenant accounting — a regime
                # change shows here while the cumulative stats still
                # dilute it (two-regime test)
                "latency": _window_latency(self._lat_recent),
            }
        doc["tenants"] = self.tenants.snapshot()
        doc["admission"] = {
            "max_queue_depth": self.admission.max_queue_depth,
            "default_quota": self.admission.default_quota.max_inflight,
            "healthy": self.admission.healthy(),
        }
        with self._mu:
            brownout = dict(self._brownout)
        doc["resilience"] = {
            "dead": self._dead,
            "brownout": brownout,
            "breakers": self.breakers.snapshot(),
            "breakers_open": self.breakers.open_count(
                time.perf_counter()),
            "retry_tokens": self.retry_budgets.snapshot(),
            "containment": self.resilience.containment,
        }
        return doc

    def close(self, drain: bool = True) -> None:
        """Stop the dispatcher.  With ``drain`` (default) pending work
        runs one final cycle first; anything still queued after that
        fails its future with a named shutdown error (never a silent
        drop — the admission contract applied to shutdown)."""
        if drain and self._pending:
            try:
                self.step()
            except Exception:  # noqa: BLE001 - shutdown must proceed
                pass
        self._halt = True
        self._fail_leftovers(
            f"frontend {self.name!r} closed with the request still queued")
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def __enter__(self) -> "ServeFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
