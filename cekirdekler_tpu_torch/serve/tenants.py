"""Per-tenant accounting: in-flight counts, outcome counters, latency.

A copy of the reference's ``serve/tenants.py`` kept in the port (which never
imports the JAX package), over the port's metrics registry.  The text below
is the reference's.

One :class:`TenantTable` per frontend.  Metric handles are created at
FIRST SIGHT of a tenant (cold — tenant cardinality is caller-
controlled) and cached on the tenant record, so the submit/complete
hot paths pay one dict lookup and cached-handle updates only (the
fused-counter discipline).  Series:

- ``ck_serve_requests_total{tenant}`` — submits seen (admitted or not)
- ``ck_serve_admitted_total{tenant}`` / ``ck_serve_rejected_total{tenant,reason}``
- ``ck_serve_completed_total{tenant}`` / ``ck_serve_failed_total{tenant}``
- ``ck_serve_deadline_missed_total{tenant}`` — completed, but late
- ``ck_serve_inflight{tenant}`` — admitted-not-yet-completed gauge
- ``ck_serve_latency_seconds{tenant}`` — submit→result histogram
"""

from __future__ import annotations

import threading

from ..metrics.registry import REGISTRY

__all__ = ["TenantTable"]


class _Tenant:
    """One tenant's counters + cached metric handles."""

    __slots__ = (
        "name", "inflight", "requests", "admitted", "rejected", "completed",
        "failed", "deadline_missed", "m_requests", "m_admitted",
        "m_completed", "m_failed", "m_missed", "m_inflight", "m_latency",
    )

    def __init__(self, name: str):
        self.name = name
        self.inflight = 0
        self.requests = 0
        self.admitted = 0
        self.rejected = 0
        self.completed = 0
        self.failed = 0
        self.deadline_missed = 0
        self.m_requests = REGISTRY.counter(
            "ck_serve_requests_total", "serve submits seen", tenant=name)
        self.m_admitted = REGISTRY.counter(
            "ck_serve_admitted_total", "serve submits admitted", tenant=name)
        self.m_completed = REGISTRY.counter(
            "ck_serve_completed_total", "serve requests completed",
            tenant=name)
        self.m_failed = REGISTRY.counter(
            "ck_serve_failed_total", "serve requests failed", tenant=name)
        self.m_missed = REGISTRY.counter(
            "ck_serve_deadline_missed_total",
            "serve requests completed after their deadline", tenant=name)
        self.m_inflight = REGISTRY.gauge(
            "ck_serve_inflight", "admitted-not-yet-completed requests",
            tenant=name)
        self.m_latency = REGISTRY.histogram(
            "ck_serve_latency_seconds", "submit-to-result latency",
            tenant=name)


class TenantTable:
    """Thread-safe tenant registry (see module docstring)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._tenants: dict[str, _Tenant] = {}

    # ckcheck: cold — first sight of a tenant registers its handle set
    def _make(self, name: str) -> _Tenant:
        return _Tenant(name)

    def state(self, tenant: str) -> _Tenant:
        """Get-or-create the tenant record (creation is the cold
        registry-registration moment; every later call is one dict
        lookup under the table lock)."""
        name = str(tenant)
        with self._mu:
            st = self._tenants.get(name)
            if st is None:
                st = self._make(name)
                self._tenants[name] = st
            return st

    # -- transitions (all under the table lock: exact counts are the
    # quota test's contract) -------------------------------------------------
    def note_request(self, st: _Tenant) -> int:
        """A submit arrived; returns the tenant's CURRENT in-flight
        count (the admission decision's input, read under the same
        lock the admit transition will use — no double-admit race)."""
        with self._mu:
            st.requests += 1
            inflight = st.inflight
        st.m_requests.inc()
        return inflight

    def note_admitted(self, st: _Tenant) -> None:
        with self._mu:
            st.admitted += 1
            st.inflight += 1
            inflight = st.inflight
        st.m_admitted.inc()
        st.m_inflight.set(inflight)

    # ckcheck: cold — rejections are the backpressure edge, not steady state
    def note_rejected(self, st: _Tenant, reason: str) -> None:
        with self._mu:
            st.rejected += 1
        REGISTRY.counter(
            "ck_serve_rejected_total", "serve submits rejected",
            tenant=st.name, reason=reason,
        ).inc()

    def note_done(self, st: _Tenant, latency_s: float, failed: bool,
                  deadline_missed: bool) -> None:
        with self._mu:
            st.inflight = max(0, st.inflight - 1)
            inflight = st.inflight
            if failed:
                st.failed += 1
            else:
                st.completed += 1
                if deadline_missed:
                    st.deadline_missed += 1
        (st.m_failed if failed else st.m_completed).inc()
        if not failed and deadline_missed:
            st.m_missed.inc()
        st.m_inflight.set(inflight)
        st.m_latency.observe(latency_s)

    # -- views ---------------------------------------------------------------
    def inflight(self, tenant: str) -> int:
        with self._mu:
            st = self._tenants.get(str(tenant))
            return st.inflight if st is not None else 0

    def snapshot(self) -> dict:
        """``{tenant: {inflight, requests, admitted, rejected,
        completed, failed, deadline_missed}}`` — the ``/servez`` table."""
        with self._mu:
            return {
                name: {
                    "inflight": st.inflight,
                    "requests": st.requests,
                    "admitted": st.admitted,
                    "rejected": st.rejected,
                    "completed": st.completed,
                    "failed": st.failed,
                    "deadline_missed": st.deadline_missed,
                }
                for name, st in sorted(self._tenants.items())
            }
