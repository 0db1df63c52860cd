"""Admission control: quotas, backpressure, and the health gate.

A copy of the reference's ``serve/admission.py`` kept in the port (which
never imports the JAX package): the same check order, hints and decision
records, field for field (``tests/test_torch_serve.py``).  The text below is
the reference's.

The serving tier's first decision about every request is made HERE,
before any queue is touched: is the tier healthy enough to take work,
is there room in the global queue, and is this tenant inside its
concurrency quota?  A refused request is **rejected with a retry-after
hint** (:class:`ServeRejected`), never silently dropped — the client
always learns what happened and when trying again is reasonable.

The decision itself is the PURE function :func:`admit_decision`:
every input it reads is snapshotted into an ``admission`` decision
record (``obs/decisions.py``), so ``ckreplay verify`` re-executes it
bit-identically offline — a tenant disputing a rejection is answered
from the log, not from a live rig (the tenant-starvation-dispute
story).

Check order (the contract, pinned by test):

0. **kernel soundness** — a job the kernel partition-safety verifier
   refuted (``analysis/``; ``CK_KERNEL_VERIFY=strict`` at the
   frontend) is structurally broken: rejected first, with
   ``retry_after_s=0.0`` — no backoff makes it admissible, the kernel
   or its flags must change.
1. **health** — the lane-health verdict gates the whole tier: with any
   lane degraded (``HealthMonitor.healthy()`` false — the same verdict
   ``/healthz`` serves as 503) nothing is admitted; retry-after backs
   off hardest.
2. **circuit breaker** — this (tenant, job-signature)'s breaker is
   open (``serve/resilience.py``): the job class is failing, and the
   hint is the HONEST remaining open window.
3. **queue depth** — the global pending-request bound; the tier sheds
   load before its latency collapses (backpressure, not buffering).
4. **brownout** — under sustained degradation the tier sheds
   over-quota / lowest-priority traffic (named, never silent; a tenant
   with nothing in flight is never shed).
5. **tenant quota** — per-tenant in-flight concurrency cap; one noisy
   tenant cannot starve the rest.

``retry_after_s`` is a deterministic function of the same inputs
(scaled by the frontend's recent batch wall estimate), so replay
verifies it too.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from ..errors import CekirdeklerError
from ..obs.decisions import DECISIONS

__all__ = [
    "AdmissionController",
    "ServeRejected",
    "TenantQuota",
    "admit_decision",
    "brownout_share",
    "MODEL_INVARIANTS",
    "REJECT_HEALTH",
    "REJECT_QUEUE",
    "REJECT_QUOTA",
    "REJECT_KERNEL",
    "REJECT_BREAKER",
    "REJECT_BROWNOUT",
]

#: Named rejection reasons (the ``ck_serve_rejected_total{reason}``
#: label vocabulary and the ``ServeRejected.reason`` values).
REJECT_HEALTH = "unhealthy"
REJECT_QUEUE = "queue-depth"
REJECT_QUOTA = "tenant-quota"
#: The kernel verifier (``analysis/``; CK_KERNEL_VERIFY=strict)
#: refuted the job's kernels/flags: a structurally unsafe job — no
#: retry hint helps, the kernel or its flags must change.
REJECT_KERNEL = "kernel-unsafe"
#: This (tenant, job-signature)'s circuit breaker is OPEN
#: (``serve/resilience.py``): the job class is failing, and the hint is
#: the remaining open window — honest, not exponential guesswork.
REJECT_BREAKER = "circuit-open"
#: Brownout shedding (``serve/resilience.py``): the tier is under
#: sustained degradation and this request is over the tenant's reduced
#: brownout share (or the tenant is lowest-priority) — shed with a
#: named reason instead of letting p99 collapse for everyone.
REJECT_BROWNOUT = "brownout"

#: Floor for retry-after hints: even an instant-drain tier should not
#: invite a reject/retry busy-loop.
_RETRY_FLOOR_S = 0.005

#: Machine-checked temporal invariants of the admission machine (the
#: ``MODEL_INVARIANTS`` contract — see ``obs/drain.py``):
#: ``analysis/model.py`` explores the product of per-tenant in-flight
#: counts × queue depth × health flips under small bounds, driving
#: :func:`admit_decision` at every submit exactly as the frontend
#: does, and proves each of these over every reachable state.
MODEL_INVARIANTS = (
    ("quota-exact", "safety",
     "admission never lets a tenant's in-flight count exceed its "
     "quota — the exact-under-contention contract, proved over every "
     "interleaving of submits and completions"),
    ("queue-bounded", "safety",
     "the global queue never exceeds max_queue_depth: backpressure "
     "sheds load before latency collapses"),
    ("reject-order", "safety",
     "rejection reasons follow the pinned check order — kernel "
     "soundness, then health, then the circuit breaker, then queue "
     "depth, then brownout shedding, then tenant quota; a reject "
     "names the FIRST failing gate"),
    ("retry-hint", "safety",
     "every backoff-able rejection carries retry_after_s >= the "
     "anti-busy-loop floor (the breaker's is its honest remaining "
     "open window); kernel-unsafe carries exactly 0.0 (no backoff "
     "makes a refuted kernel admissible)"),
    ("admit-iff", "safety",
     "admit is exactly the conjunction of the six gates: no hidden "
     "input changes the verdict, no gate is skipped"),
)


class ServeRejected(CekirdeklerError):
    """A submit refused by admission — carries the named ``reason``
    (:data:`REJECT_HEALTH` / :data:`REJECT_BREAKER` /
    :data:`REJECT_QUEUE` / :data:`REJECT_BROWNOUT` /
    :data:`REJECT_QUOTA` / :data:`REJECT_KERNEL`) and the
    ``retry_after_s`` hint.  Raised, never silently dropped: the
    client always learns why and when to come back."""

    def __init__(self, tenant: str, reason: str, retry_after_s: float):
        self.tenant = tenant
        self.reason = reason
        self.retry_after_s = retry_after_s
        super().__init__(
            f"request from tenant {tenant!r} rejected ({reason}); "
            f"retry after {retry_after_s:.3f}s"
        )


@dataclass(frozen=True)
class TenantQuota:
    """Per-tenant admission limits.  ``max_inflight`` bounds the
    tenant's admitted-but-not-completed requests (queued + dispatched);
    ``priority`` orders brownout shedding (``<= 0`` = lowest priority:
    under brownout the tenant keeps exactly one request in flight)."""

    max_inflight: int = 64
    priority: int = 1


def brownout_share(quota: int, frac: float = 0.5) -> int:
    """A tenant's effective quota under brownout: ``quota · frac``,
    floored at 1 (the starvation floor).  The ONE shed-quota formula —
    the controller, the pure gate's fallback, and the model-checker
    machines all call this, so the exhaustive proofs cover exactly
    what a non-default ``shed_frac`` deployment runs."""
    return max(1, int(int(quota) * float(frac)))


def admit_decision(
    tenant_inflight: int,
    quota: int,
    queue_depth: int,
    max_queue_depth: int,
    healthy: bool,
    est_batch_s: float,
    kernel_unsafe: bool = False,
    kernel_finding: str | None = None,
    breaker_open: bool = False,
    breaker_retry_after_s: float | None = None,
    brownout: bool = False,
    shed_quota: int | None = None,
    priority: int = 1,
) -> dict:
    """The PURE admission transition (replay-verified — see module
    docstring for the check order).  Returns ``{"admit", "reason",
    "retry_after_s"}``; ``reason``/``retry_after_s`` are None on
    admit.

    ``kernel_unsafe`` is checked FIRST: a job the kernel verifier
    refuted (``kernel_finding`` names the verdict kind) is structurally
    broken — no backoff makes it admissible, so ``retry_after_s`` is
    0.0 (do not retry as-is).

    ``breaker_open``/``breaker_retry_after_s`` come from the frontend's
    :class:`~.resilience.BreakerBoard` admit for this (tenant,
    job-signature); ``brownout``/``shed_quota``/``priority`` from its
    brownout controller — all recorded as decision INPUTS, so the new
    rejections replay bit-identically (defaults preserve pre-resilience
    logs).  The brownout gate never sheds a tenant with zero in-flight
    requests (``shed_quota`` floors at 1 — the starvation floor the
    model checker proves)."""
    base = max(float(est_batch_s), _RETRY_FLOOR_S)
    if kernel_unsafe:
        return {"admit": False, "reason": REJECT_KERNEL,
                "retry_after_s": 0.0}
    if not healthy:
        # tier-wide gate: back off hardest — a degraded lane needs
        # windows, not more traffic
        return {"admit": False, "reason": REJECT_HEALTH,
                "retry_after_s": base * 4.0}
    if breaker_open:
        # the breaker's hint is HONEST: the remaining open window, not
        # a generic backoff (floored against busy-loops)
        hint = (float(breaker_retry_after_s)
                if breaker_retry_after_s is not None else base * 4.0)
        return {"admit": False, "reason": REJECT_BREAKER,
                "retry_after_s": max(_RETRY_FLOOR_S, hint)}
    if queue_depth >= max_queue_depth:
        # the deeper past the bound the caller found the queue, the
        # longer the honest drain estimate
        overflow = queue_depth - max_queue_depth + 1
        frac = overflow / max(max_queue_depth, 1)
        return {"admit": False, "reason": REJECT_QUEUE,
                "retry_after_s": base * (1.0 + frac)}
    if brownout:
        sq = (max(1, int(shed_quota)) if shed_quota is not None
              else brownout_share(quota))
        if int(priority) <= 0:
            sq = 1  # lowest priority keeps exactly one in flight
        if tenant_inflight >= sq:
            return {"admit": False, "reason": REJECT_BROWNOUT,
                    "retry_after_s": base * 2.0}
    if tenant_inflight >= quota:
        # one batch cycle typically retires quota-bounded work
        return {"admit": False, "reason": REJECT_QUOTA,
                "retry_after_s": base}
    return {"admit": True, "reason": None, "retry_after_s": None}


class AdmissionController:
    """Quota table + queue bound + health gate over
    :func:`admit_decision`.

    Thread-safe; :meth:`check` is on the submit hot path, so the health
    verdict is TTL-cached (``health_ttl_s``) — the monitor lock is not
    taken per request — and the decision record is built only behind
    ``DECISIONS.enabled``."""

    def __init__(
        self,
        max_queue_depth: int = 1024,
        default_quota: TenantQuota | int | None = None,
        health=None,
        health_ttl_s: float = 0.05,
        shed_frac: float = 0.5,
    ):
        if isinstance(default_quota, int):
            default_quota = TenantQuota(max_inflight=default_quota)
        self.default_quota = default_quota or TenantQuota()
        self.max_queue_depth = max(1, int(max_queue_depth))
        self._health = health  # callable -> bool; None = always healthy
        self.health_ttl_s = float(health_ttl_s)
        # brownout: each tenant's effective quota drops to
        # ceil-ish(quota * shed_frac), floored at 1 (the starvation
        # floor) — a frontend-constructed controller inherits the
        # ResilienceConfig knob
        self.shed_frac = float(shed_frac)
        self._mu = threading.Lock()
        self._quotas: dict[str, TenantQuota] = {}
        self._health_cache: tuple[float, bool] = (-1e18, True)

    # -- configuration -------------------------------------------------------
    def set_quota(self, tenant: str, quota: TenantQuota | int) -> None:
        if isinstance(quota, int):
            quota = TenantQuota(max_inflight=quota)
        with self._mu:
            self._quotas[str(tenant)] = quota

    def quota_of(self, tenant: str) -> TenantQuota:
        with self._mu:
            return self._quotas.get(str(tenant), self.default_quota)

    # -- the gate ------------------------------------------------------------
    def healthy(self, now: float | None = None) -> bool:
        """The TTL-cached tier health verdict (True with no gate
        wired)."""
        if self._health is None:
            return True
        t = time.perf_counter() if now is None else now
        with self._mu:
            t_cached, v = self._health_cache
            if t - t_cached < self.health_ttl_s:
                return v
        v = bool(self._health())
        with self._mu:
            self._health_cache = (t, v)
        return v

    def check(
        self,
        tenant: str,
        tenant_inflight: int,
        queue_depth: int,
        est_batch_s: float,
        kernel_unsafe: bool = False,
        kernel_finding: str | None = None,
        breaker_open: bool = False,
        breaker_retry_after_s: float | None = None,
        brownout: bool = False,
        rid: str | None = None,
    ) -> dict:
        """One admission decision for ``tenant``, recorded with its
        complete inputs (kind ``admission``).  Returns the
        :func:`admit_decision` dict; the caller raises
        :class:`ServeRejected` / increments its own accounting.
        ``rid`` is the request's lifecycle id (obs/reqtrace.py) —
        recorded as a decision INPUT (``ckreplay explain --rid``
        filters on it; the pure oracle ignores it).

        ``kernel_unsafe``/``kernel_finding`` come from the caller's
        kernel-verifier gate (``ServeFrontend.submit`` under
        ``CK_KERNEL_VERIFY=strict``), ``breaker_open``/
        ``breaker_retry_after_s``/``brownout`` from the frontend's
        resilience layer (``serve/resilience.py``) — all enter the
        decision record as INPUTS, so every named rejection replays
        bit-identically offline: a tenant disputing one is answered
        from the log."""
        q = self.quota_of(tenant)
        quota, priority = q.max_inflight, q.priority
        shed_quota = brownout_share(quota, self.shed_frac)
        healthy = self.healthy()
        dec = admit_decision(
            tenant_inflight=int(tenant_inflight), quota=int(quota),
            queue_depth=int(queue_depth),
            max_queue_depth=self.max_queue_depth,
            healthy=healthy, est_batch_s=float(est_batch_s),
            kernel_unsafe=bool(kernel_unsafe),
            kernel_finding=kernel_finding,
            breaker_open=bool(breaker_open),
            breaker_retry_after_s=breaker_retry_after_s,
            brownout=bool(brownout), shed_quota=shed_quota,
            priority=int(priority),
        )
        if DECISIONS.enabled:
            # the complete replay inputs — a rejected tenant's dispute
            # is answerable from this record alone
            DECISIONS.record("admission", {
                "tenant": str(tenant),
                "tenant_inflight": int(tenant_inflight),
                "quota": int(quota),
                "queue_depth": int(queue_depth),
                "max_queue_depth": self.max_queue_depth,
                "healthy": healthy,
                "est_batch_s": float(est_batch_s),
                "kernel_unsafe": bool(kernel_unsafe),
                "kernel_finding": (None if kernel_finding is None
                                   else str(kernel_finding)),
                "breaker_open": bool(breaker_open),
                "breaker_retry_after_s": (
                    None if breaker_retry_after_s is None
                    else float(breaker_retry_after_s)),
                "brownout": bool(brownout),
                "shed_quota": int(shed_quota),
                "priority": int(priority),
                "rid": None if rid is None else str(rid),
            }, dict(dec))
        return dec
