"""Serving tier: the multi-tenant request front-end (the reference's
docs/SERVING.md).

The port's copy of the reference's ``serve/`` package, with its exports:
the pure decision functions are the reference's line for line, and the
frontend and the fabric run over the port's ``Cores``.  None of it imports
torch at module level.  The text below is the reference's.

The reference's only multi-caller story is the greedy task-pool/device-
pool tier (``pipeline/pool.py``) plus a prealpha single-session TCP
server — neither admits many concurrent clients against ONE shared
scheduler.  This package is the entry point a "millions of users" tier
needs: N concurrent clients submit kernel jobs
through :class:`ServeFrontend.submit`, an admission layer enforces
per-tenant quotas and queue-depth backpressure (reject-with-retry-after,
never a silent drop) and consults the lane-health verdicts, and a
coalescing scheduler groups same-signature requests into batches that
dispatch as fused windows — the shape-only executable cache makes a
coalesced batch ONE ladder launch, so request coalescing IS batching.

The resilience layer (``serve/resilience.py``, the reference's docs/RESILIENCE.md)
contains the blast radius of every failure: a poisoned fused batch is
bisected so exactly the faulty request fails with a named cause,
retries are deadline-aware and budget-gated, circuit breakers refuse a
failing (tenant, job-signature) with an honest retry hint, and
brownout shedding keeps p99 alive under sustained degradation.
"""

from .admission import (
    AdmissionController,
    ServeRejected,
    TenantQuota,
    admit_decision,
)
from .coalescer import STARVE_ROUNDS, plan_coalesce
from .fabric import (
    REJECT_SHARD,
    ServeFabric,
    ShardRouter,
    fabric_key,
    merge_shard_serving,
    route_decision,
    shard_health,
)
from .frontend import ServeFrontend, ServeJob, servez_payload
from .resilience import (
    BreakerBoard,
    ResilienceConfig,
    RetryBudgets,
    breaker_admit,
    breaker_transition,
    brownout_transition,
    containment_plan,
    retry_decision,
)
from .tenants import TenantTable

__all__ = [
    "AdmissionController",
    "BreakerBoard",
    "REJECT_SHARD",
    "ResilienceConfig",
    "RetryBudgets",
    "ServeFabric",
    "ServeFrontend",
    "ServeJob",
    "ServeRejected",
    "ShardRouter",
    "TenantQuota",
    "TenantTable",
    "STARVE_ROUNDS",
    "admit_decision",
    "breaker_admit",
    "breaker_transition",
    "brownout_transition",
    "containment_plan",
    "fabric_key",
    "merge_shard_serving",
    "plan_coalesce",
    "retry_decision",
    "route_decision",
    "servez_payload",
    "shard_health",
]
