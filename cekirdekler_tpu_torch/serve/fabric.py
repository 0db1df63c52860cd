"""Cluster serving fabric: N front-end shards over the elastic membership.

A copy of the reference's ``serve/fabric.py`` kept in the port (which never
imports the JAX package), over the port's ``cluster/elastic``,
``core/compilecache`` and frontend: the same ring, placement, health view,
re-route and ``route`` decision records (``tests/test_torch_fabric.py``).
Shards in one process may share one card: each shard's ``Cores`` has its own
lanes, streams and CUDA graphs.  The text below is the reference's.

The serving tier (``serve/frontend.py``) is one process over one
``Cores``.  This module is its cluster shape: one
:class:`ServeFrontend` shard per elastic :class:`Membership` member,
behind a :class:`ShardRouter` whose placement is the PURE, replayable
function :func:`route_decision` — a consistent hash of (tenant, job
key) over the live epoch's member ring — so same-signature traffic
keeps landing on ONE shard and keeps coalescing into that shard's
fused windows.  Every routing verdict is a replayable ``route``
decision (``obs/decisions.py``); ``ckreplay verify`` re-derives the
whole placement history offline, and ``analysis/model.py``'s
``RouterMachine`` proves the ring's invariants (deterministic
placement per epoch, minimal reshuffle on member change, never a
non-member target) over every small-roster interleaving.

**Placement.**  Each member owns :data:`VNODES` points on a 64-bit
hash ring (``sha256(member#v)``); a key (``sha256(tenant|job-key)``)
belongs to the first member point clockwise.  Consistent hashing gives
minimal reshuffle BY CONSTRUCTION: a departure moves exactly the keys
the departed member owned (to their ring successors), a join moves
exactly the keys the joiner captures — every other key's placement is
bit-identical across the epoch bump.

**Health-based diversion.**  The router holds a per-shard health view
built from each frontend's own ``stats()`` surface (the ``/servez`` +
``/healthz`` evidence: open breakers, engaged brownout, drain-degraded
admission, dead dispatcher — :func:`shard_health`, pure), refreshed
every fabric cycle.  A key whose owner is unhealthy diverts to the
next ring successor BEFORE requests queue behind the sick shard; every
diversion is flagged in the recorded ``route`` decision and a
``fabric-divert`` flight event.  With every member unhealthy the
router refuses with the named ``shard-unavailable`` reason — never an
invented target.

**Preemption re-route.**  A member kill (heartbeat timeout, seeded
``CK_FAULTS``, or an explicit :meth:`ServeFabric.remove_member`)
fails the dead shard's never-dispatched in-flight requests with the
frontend's named shutdown errors; the fabric's outer future catches
exactly those CLEAN failures and re-routes them through the existing
retry-budget machinery (``serve/resilience.retry_decision``, recorded)
onto ring survivors — resuming, when a ``checkpoint_root`` is wired,
from the last complete partition window (``cluster/elastic``).
Dirty failures (``partial-window``) are NEVER re-routed: a torn array
re-dispatched elsewhere would double-apply work and break the
bit-exactness contract the loadgen checks.
"""

from __future__ import annotations

import random
import threading
import time
from concurrent.futures import Future, InvalidStateError
from hashlib import sha256

from ..errors import CekirdeklerError
from ..metrics.registry import REGISTRY
from ..obs.decisions import DECISIONS
from ..obs.flight import FLIGHT
from ..obs.reqtrace import REQTRACE
from ..cluster.elastic import Membership, resume_window, save_window
from .admission import ServeRejected
from .frontend import ServeFrontend, ServeJob
from .resilience import RetryBudgets, retry_decision

__all__ = [
    "VNODES",
    "REJECT_SHARD",
    "MODEL_INVARIANTS",
    "fabric_key",
    "ring_points",
    "placement_key",
    "route_decision",
    "shard_health",
    "ShardRouter",
    "ServeFabric",
    "merge_shard_serving",
]

#: Virtual ring points per member: enough that a small roster spreads
#: keys near-evenly, small enough that ``ring_points`` over a test
#: alphabet stays trivially cheap (the ring is rebuilt per route — the
#: pure function takes the ROSTER, not a cached ring, so replay needs
#: no hidden state).
VNODES = 16

#: Named rejection reason for "no healthy shard owns this key": every
#: member is down/unhealthy, or the roster is empty.  Rides the same
#: ``ServeRejected`` type (and the same TCP answer path) as the
#: admission vocabulary in ``serve/admission.py``.
REJECT_SHARD = "shard-unavailable"

#: Retry-after hint for a ``shard-unavailable`` rejection: long enough
#: to cover a health-view refresh or a membership sync, short enough
#: that a recovering fabric is re-tried promptly.
_SHARD_RETRY_S = 0.05

#: Machine-checked temporal invariants of the shard router (the
#: ``MODEL_INVARIANTS`` contract — see ``obs/drain.py``):
#: ``analysis/model.py``'s ``RouterMachine`` drives a REAL
#: :class:`ShardRouter` over a real :class:`Membership` through every
#: leave/join/health-flip interleaving over a small roster alphabet
#: and checks every captured ``route`` record against these.
MODEL_INVARIANTS = (
    ("placement-deterministic", "safety",
     "the same (tenant, key, roster, health view) always routes to "
     "the same shard within an epoch — re-deriving every recorded "
     "route from its logged inputs is bit-identical (the ckreplay "
     "contract applied to placement)"),
    ("minimal-reshuffle", "safety",
     "a membership change moves only the keys the departed member "
     "owned (or the joiner captured): every other key's ring owner is "
     "bit-identical across the epoch bump — consistent hashing's "
     "promise, checked, not assumed"),
    ("routes-to-members", "safety",
     "a route never names a shard outside the live epoch's roster; "
     "with every member unhealthy it refuses with the named "
     "shard-unavailable reason instead of inventing a target"),
    ("diversion-named", "safety",
     "every route that lands away from its ring owner is flagged "
     "diverted with the skipped-member hop count — health-based "
     "diversion is never silent, and a healthy owner is never "
     "diverted away from"),
)


def _hash64(text: str) -> int:
    """First 8 bytes of sha256 as a big-endian int — the ring's 64-bit
    position space.  sha256 (not ``hash()``) on purpose: placement must
    be bit-identical across processes and runs (PYTHONHASHSEED would
    silently reshard a restarted fabric)."""
    return int.from_bytes(sha256(text.encode("utf-8")).digest()[:8], "big")


def _order(member: str):
    """Length-then-lex member order (the ``cluster/elastic`` rule) —
    rosters in decision inputs always serialize in ONE order."""
    return (len(member), member)


def ring_points(members) -> list:
    """PURE: the sorted (position, member) ring for a roster —
    :data:`VNODES` sha256 points per member."""
    pts = []
    for m in members:
        mm = str(m)
        for v in range(VNODES):
            pts.append((_hash64(mm + "#" + str(v)), mm))
    pts.sort()
    return pts


def placement_key(tenant: str, key: str) -> int:
    """PURE: a (tenant, job-key) pair's 64-bit ring position."""
    return _hash64(str(tenant) + "|" + str(key))


def route_decision(tenant: str, key: str, members, unhealthy=(),
                   epoch: int = 0) -> dict:
    """The PURE routing verdict (the replayable ``route`` decision's
    oracle): consistent-hash owner over the roster's ring, diverted to
    the next ring successor past unhealthy members.

    Returns ``{"shard", "owner", "diverted", "hops", "reason",
    "epoch"}`` — ``shard`` is None (with ``reason="shard-unavailable"``)
    when no healthy member exists; ``hops`` counts the DISTINCT
    unhealthy members skipped walking clockwise from the owner."""
    roster = sorted(set(str(m) for m in members), key=_order)
    epoch = int(epoch)
    if not roster:
        return {"shard": None, "owner": None, "diverted": False,
                "hops": 0, "reason": REJECT_SHARD, "epoch": epoch}
    pts = ring_points(roster)
    k = placement_key(tenant, key)
    n = len(pts)
    idx = 0
    while idx < n and pts[idx][0] <= k:
        idx += 1
    owner = pts[idx % n][1]
    bad = set(str(m) for m in unhealthy)
    shard = None
    hops = 0
    seen = []
    j = idx
    for _ in range(n):
        m = pts[j % n][1]
        j += 1
        if m in seen:
            continue  # the same member's other virtual points
        seen.append(m)
        if m not in bad:
            shard = m
            break
        hops += 1
    if shard is None:
        return {"shard": None, "owner": owner, "diverted": True,
                "hops": hops, "reason": REJECT_SHARD, "epoch": epoch}
    return {"shard": shard, "owner": owner, "diverted": shard != owner,
            "hops": hops, "reason": None, "epoch": epoch}


def shard_health(stats_doc: dict) -> dict:
    """PURE: one shard's health verdict from its own ``stats()`` doc
    (the ``/servez`` row — the same evidence ``/healthz`` and the
    breaker board serve).  Unhealthy reasons, in check order:
    ``dispatcher-dead`` (the shard cannot drain anything),
    ``circuit-open`` (any breaker inside an open window),
    ``brownout`` (shedding engaged), ``drain-degraded`` (the
    drain-aware admission health gate is refusing).  Returns
    ``{"healthy", "reasons"}``."""
    doc = stats_doc or {}
    res = doc.get("resilience") or {}
    adm = doc.get("admission") or {}
    reasons = []
    if res.get("dead"):
        reasons.append("dispatcher-dead")
    if int(res.get("breakers_open") or 0) > 0:
        reasons.append("circuit-open")
    if (res.get("brownout") or {}).get("active"):
        reasons.append("brownout")
    if adm.get("healthy") is False:
        reasons.append("drain-degraded")
    return {"healthy": not reasons, "reasons": reasons}


def fabric_key(job: ServeJob) -> str:
    """The routing key for a job: the signature's PORTABLE parts
    (kernels, compute id, ranges) — deliberately NOT the param object
    ids ``job_signature`` uses, so the same logical job routes to the
    same shard from every client process.  Coalescing inside the
    chosen shard still groups on the full identity-bearing signature."""
    return (f"cid{int(job.compute_id)}|{','.join(job.kernels)}|"
            f"{int(job.global_range)}x{int(job.local_range)}"
            f"+{int(job.global_offset)}")


class ShardRouter:
    """The fabric's placement plane: a thin recording wrapper over the
    pure :func:`route_decision` (injectable — the ``route=`` seam is
    how ckmodel's broken fixtures force each invariant to fail), plus
    the per-shard health view the diversion walk consults.

    Health rows are REPLACED wholesale each refresh
    (:meth:`refresh_health`) from the frontends' ``stats()`` docs, and
    individually settable (:meth:`mark` / :meth:`clear`) for the
    preemption path, which learns about a death before any stats
    refresh could."""

    def __init__(self, membership: Membership, route=None):
        self.membership = membership
        self._route = route or route_decision
        self._mu = threading.Lock()
        self._unhealthy: dict[str, list] = {}
        self._m_routed = REGISTRY.counter(
            "ck_serve_fabric_routed_total",
            "fabric route decisions that named a target shard")
        self._m_diverted = REGISTRY.counter(
            "ck_serve_fabric_diversions_total",
            "fabric routes diverted off their ring owner by the "
            "shard-health view")
        self._m_refused = REGISTRY.counter(
            "ck_serve_fabric_unroutable_total",
            "fabric routes refused with shard-unavailable (no healthy "
            "member)")

    # -- health view ---------------------------------------------------------
    def refresh_health(self, stats_by_member: dict) -> dict:
        """Rebuild the whole health view from per-member ``stats()``
        docs (one :func:`shard_health` verdict each).  Returns the
        unhealthy map ``{member: reasons}``."""
        bad = {}
        for m, doc in stats_by_member.items():
            h = shard_health(doc)
            if not h["healthy"]:
                bad[str(m)] = list(h["reasons"])
        with self._mu:
            self._unhealthy = bad
        return dict(bad)

    def mark(self, member: str, reasons=("shard-unavailable",)) -> None:
        """Mark one member unhealthy NOW (the preemption fast path)."""
        with self._mu:
            self._unhealthy[str(member)] = list(reasons)

    def clear(self, member: str) -> None:
        """Drop one member's unhealthy row (a rejoined shard starts
        clean)."""
        with self._mu:
            self._unhealthy.pop(str(member), None)

    def health_view(self) -> dict:
        with self._mu:
            return {m: list(r) for m, r in self._unhealthy.items()}

    # -- routing -------------------------------------------------------------
    def route(self, tenant: str, key: str, rid: str | None = None) -> dict:
        """Route one (tenant, key): snapshot the live epoch's roster
        and health view, run the pure function, record the replayable
        ``route`` decision with exactly the inputs it consumed.
        ``rid`` (the request-lifecycle id, obs/reqtrace.py) rides the
        record as an input — the ``ckreplay explain --rid`` join key;
        the pure oracle ignores it."""
        snap = self.membership.snapshot()
        roster = sorted(snap["members"], key=_order)
        with self._mu:
            unhealthy = sorted(self._unhealthy, key=_order)
            reasons = {m: list(r) for m, r in self._unhealthy.items()}
        out = self._route(str(tenant), str(key), roster,
                          tuple(unhealthy), snap["epoch"])
        if out["shard"] is None:
            self._m_refused.inc()
        else:
            self._m_routed.inc()
        if out["diverted"] and out["shard"] is not None:
            self._m_diverted.inc()
            if FLIGHT.enabled:
                FLIGHT.event(
                    "fabric-divert", tenant=str(tenant), key=str(key),
                    owner=out["owner"], shard=out["shard"],
                    hops=out["hops"],
                    reasons=reasons.get(out["owner"], []))
        if DECISIONS.enabled:
            DECISIONS.record("route", {
                "tenant": str(tenant),
                "key": str(key),
                "members": roster,
                "unhealthy": list(unhealthy),
                "epoch": snap["epoch"],
                "rid": None if rid is None else str(rid),
            }, dict(out))
        return out


def merge_shard_serving(shard_stats: dict) -> dict:
    """Merge per-shard serving stats docs (``ServeFrontend.stats()``
    shape) into one job-wide view — the ``serving`` payload
    ``trace/aggregate.gather_cluster`` exchanges so every process sees
    the fleet's serving totals next to its spans and health."""
    merged = {
        "shards": sorted((str(m) for m in shard_stats), key=_order),
        "queue_depth": 0, "batches": 0, "requests_done": 0,
        "rounds": 0, "breakers_open": 0, "brownouts_active": 0,
        "dead": [],
    }
    for m in merged["shards"]:
        doc = shard_stats.get(m) or {}
        merged["queue_depth"] += int(doc.get("queue_depth") or 0)
        merged["batches"] += int(doc.get("batches") or 0)
        merged["requests_done"] += int(doc.get("requests_done") or 0)
        merged["rounds"] += int(doc.get("rounds") or 0)
        res = doc.get("resilience") or {}
        merged["breakers_open"] += int(res.get("breakers_open") or 0)
        if (res.get("brownout") or {}).get("active"):
            merged["brownouts_active"] += 1
        if res.get("dead"):
            merged["dead"].append(m)
    return merged


def _settle(fut: Future, value=None, exc: Exception | None = None) -> None:
    """Resolve a fabric future tolerating client-side cancellation
    (the frontend's ``_settle`` contract, applied to the outer
    future)."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(value)
    except InvalidStateError:
        pass


def _reroutable(exc: BaseException) -> bool:
    """True iff a failed shard future is safe to re-dispatch
    elsewhere: ONLY failures that name never-dispatched work — the
    frontend's shutdown-synthesized errors (``_ck_shutdown``), a
    closed/dead frontend refusing at submit, or the drain/death
    leftovers message.  A ``partial-window`` (torn residue) or any
    genuine dispatch failure is NOT re-routable: re-running applied
    work elsewhere would double-apply and break bit-exactness."""
    if isinstance(exc, ServeRejected):
        return False
    if getattr(exc, "_ck_shutdown", False):
        return True
    if isinstance(exc, CekirdeklerError):
        msg = str(exc)
        return ("dispatcher died" in msg or "is closed" in msg
                or "closed with the request still queued" in msg)
    return False


class ServeFabric:
    """N :class:`ServeFrontend` shards — one per elastic member —
    behind a :class:`ShardRouter` (see module docstring).

    ``crunchers`` maps member id → ``NumberCruncher``; the fabric owns
    the frontends it builds over them.  ``autostart=False`` keeps
    every shard's dispatcher unstarted (:meth:`step` runs one fabric
    cycle synchronously — the deterministic test/bench seam).
    ``checkpoint_root`` wires the elastic partition-checkpoint plane:
    :meth:`save_checkpoint` / :meth:`resume_checkpoint` ride
    ``cluster/elastic.save_window`` / ``resume_window`` so a
    preempted-and-rerouted run resumes from the last complete window.
    """

    def __init__(self, crunchers: dict, membership: Membership | None = None,
                 steps: dict | None = None, autostart: bool = True,
                 checkpoint_root: str | None = None,
                 warm_on_join: bool = True,
                 health_refresh_s: float = 0.05,
                 reroute_max_attempts: int = 2,
                 name: str = "fabric", **frontend_kwargs):
        self.name = str(name)
        self.membership = membership or Membership()
        self.router = ShardRouter(self.membership)
        self.checkpoint_root = checkpoint_root
        self.warm_on_join = bool(warm_on_join)
        self.health_refresh_s = float(health_refresh_s)
        self.reroute_max_attempts = max(0, int(reroute_max_attempts))
        self._autostart = bool(autostart)
        self._frontend_kwargs = dict(frontend_kwargs)
        self._mu = threading.Lock()
        self._halt = False
        self._last_refresh = 0.0
        #: observed job table (fabric key → a representative job): the
        #: fleet's coalescer-group memory the warm-on-join path
        #: precompiles a joining shard from (scratch params — see
        #: :meth:`add_member`).
        self._observed: dict[str, ServeJob] = {}
        self.retry_budgets = RetryBudgets()
        self._rng = random.Random(20170)
        self.shards: dict[str, ServeFrontend] = {}
        steps = steps or {}
        roster = {}
        for m, cr in crunchers.items():
            mid = str(m)
            self.shards[mid] = ServeFrontend(
                cr, name=f"{self.name}-{mid}", autostart=self._autostart,
                **self._frontend_kwargs)
            roster[mid] = int(steps.get(m, 1))
        if self.membership.epoch == 0:
            self.membership.establish(roster)
        self._g_shards = REGISTRY.gauge(
            "ck_serve_fabric_shards", "live serving-fabric shards")
        self._m_reroutes = REGISTRY.counter(
            "ck_serve_fabric_reroutes_total",
            "in-flight requests re-routed onto ring survivors after a "
            "member preemption (budget-gated, clean failures only)")
        self._g_shards.set(float(len(self.shards)))

    # -- client API ----------------------------------------------------------
    def submit(self, tenant: str, job, deadline: float | None = None
               ) -> Future:
        """Route one job to its shard and submit it there; returns an
        OUTER future that survives the shard: a member preemption
        fails the inner future with a named clean-shutdown error, and
        the outer future re-routes through the retry budget onto a
        ring survivor instead of surfacing the death to the client.
        Raises :class:`ServeRejected` (reason ``shard-unavailable``)
        when no healthy shard owns the key, or the target shard's own
        admission rejection."""
        if self._halt:
            raise CekirdeklerError(f"fabric {self.name!r} is closed")
        jb = job if isinstance(job, ServeJob) else ServeJob(**job)
        # the fabric mints the lifecycle id (obs/reqtrace.py): the SAME
        # rid rides every hop — route, shard submit, preemption
        # re-route — so a killed member's request folds into ONE chain
        rid = REQTRACE.mint()
        key = fabric_key(jb)
        self._maybe_refresh()
        out = self.router.route(tenant, key, rid=rid)
        if out["shard"] is None:
            raise ServeRejected(str(tenant), REJECT_SHARD, _SHARD_RETRY_S)
        if out["diverted"] and REQTRACE.enabled:
            REQTRACE.event(rid, "diverted", tenant=str(tenant),
                           owner=out["owner"], shard=out["shard"],
                           hops=out["hops"])
        with self._mu:
            self._observed[key] = jb
            fe = self.shards.get(out["shard"])
        if fe is None:
            # the shard left between the route's roster snapshot and
            # this lookup — the named refusal, never a KeyError
            raise ServeRejected(str(tenant), REJECT_SHARD, _SHARD_RETRY_S)
        outer: Future = Future()
        try:
            inner = fe.submit(tenant, jb, deadline=deadline, rid=rid)
        except ServeRejected:
            raise
        except CekirdeklerError as e:
            if not _reroutable(e):
                raise
            # the shard died between route and submit: same re-route
            # path an in-flight preemption takes
            self._reroute(outer, str(tenant), jb, deadline,
                          out["shard"], e, attempt=0, rid=rid)
            return outer
        self._watch(outer, inner, str(tenant), jb, deadline,
                    out["shard"], attempt=0, rid=rid)
        return outer

    def call(self, tenant: str, job, deadline: float | None = None,
             timeout: float | None = None):
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(tenant, job, deadline=deadline).result(timeout)

    def _watch(self, outer: Future, inner: Future, tenant: str,
               jb: ServeJob, deadline, shard_id: str, attempt: int,
               rid: str | None = None) -> None:
        def _done(f: Future) -> None:
            if f.cancelled():
                outer.cancel()
                return
            exc = f.exception()
            if exc is None:
                _settle(outer, value=f.result())
            elif _reroutable(exc) and not self._halt:
                self._reroute(outer, tenant, jb, deadline, shard_id,
                              exc, attempt, rid=rid)
            else:
                _settle(outer, exc=exc)
        inner.add_done_callback(_done)

    def _reroute(self, outer: Future, tenant: str, jb: ServeJob,
                 deadline, from_shard: str, cause: BaseException,
                 attempt: int, rid: str | None = None) -> None:
        """One budget-gated preemption re-route: consult the SAME pure
        ``retry_decision`` the in-shard retry path uses (recorded, so
        replay verifies the re-route was granted from its logged
        inputs), divert the key off the dead member, and resubmit on
        the survivor."""
        tokens = self.retry_budgets.tokens(tenant)
        u = self._rng.random()
        rd = retry_decision(attempt, self.reroute_max_attempts, tokens,
                            None, 0.0, 0.0, u)
        if DECISIONS.enabled:
            DECISIONS.record("retry", {
                "attempt": attempt,
                "max_attempts": self.reroute_max_attempts,
                "tokens": tokens,
                "deadline_left_s": None,
                "base_s": 0.0, "cap_s": 0.0, "jitter_u": u,
                "tenant": tenant,
                "cause": f"shard-preempted:{from_shard}",
                "rid": None if rid is None else str(rid),
            }, dict(rd))
        if not rd["retry"]:
            _settle(outer, exc=cause)
            return
        self.retry_budgets.spend(tenant)
        self.router.mark(from_shard, ("shard-unavailable",))
        key = fabric_key(jb)
        out = self.router.route(tenant, key, rid=rid)
        with self._mu:
            fe = (self.shards.get(out["shard"])
                  if out["shard"] is not None else None)
        if fe is None or out["shard"] == from_shard:
            _settle(outer, exc=ServeRejected(
                tenant, REJECT_SHARD, _SHARD_RETRY_S))
            return
        self._m_reroutes.inc()
        if FLIGHT.enabled:
            FLIGHT.event(
                "fabric-reroute", tenant=tenant, key=key,
                from_shard=from_shard, to_shard=out["shard"],
                attempt=attempt, cause=str(cause)[:200])
        if rid is not None and REQTRACE.enabled:
            # the hop chain: the route off the dead owner stamps
            # `diverted`, the survivor re-submit stamps `rerouted` —
            # the SAME rid continues on the new shard (and, over the
            # `tools/fabric_worker` wire, in the new process)
            if out["diverted"]:
                REQTRACE.event(rid, "diverted", tenant=tenant,
                               owner=out["owner"], shard=out["shard"],
                               hops=out["hops"])
            REQTRACE.event(rid, "rerouted", tenant=tenant,
                           from_shard=from_shard, to_shard=out["shard"],
                           attempt=attempt)
        try:
            inner = fe.submit(tenant, jb, deadline=deadline, rid=rid)
        except Exception as e:  # noqa: BLE001 - judged below
            if _reroutable(e) and attempt + 1 < self.reroute_max_attempts \
                    and not self._halt:
                self._reroute(outer, tenant, jb, deadline, out["shard"],
                              e, attempt + 1, rid=rid)
            else:
                _settle(outer, exc=e)
            return
        self._watch(outer, inner, tenant, jb, deadline, out["shard"],
                    attempt + 1, rid=rid)

    # -- membership ----------------------------------------------------------
    def remove_member(self, member: str, total: int | None = None,
                      drain: bool = False) -> dict:
        """A member left (preemption, scale-down): divert its keys NOW
        (router mark — before any queueing behind the corpse), record
        the epoch-bumping ``member-leave``, then close its frontend —
        whose named clean-shutdown failures the outer futures catch
        and re-route onto survivors."""
        member = str(member)
        self.router.mark(member, ("shard-unavailable",))
        out = self.membership.leave(member, total)
        with self._mu:
            fe = self.shards.pop(member, None)
        self._g_shards.set(float(len(self.shards)))
        if fe is not None:
            fe.close(drain=drain)
        self.router.clear(member)  # non-member: the ring already skips it
        return out

    def add_member(self, member: str, cruncher, step: int = 1,
                   total: int | None = None, warm: bool | None = None
                   ) -> dict:
        """A member joined (rejoin, scale-up): build its frontend, WARM
        it from the fleet's observed group table via the AOT path
        (``ServeFrontend.warmup`` → ``Cores.warmup`` precompiles on
        scratch device buffers — live jobs are read for shapes only,
        never executed against), plus — when ``CK_COMPILE_CACHE`` is
        armed — from the on-disk cross-process cache, so a joining
        shard whose signature mix other processes already persisted
        performs ZERO fresh ladder compiles.  Only then record the
        ``member-join`` that makes it routable."""
        member = str(member)
        fe = ServeFrontend(
            cruncher, name=f"{self.name}-{member}",
            autostart=self._autostart, **self._frontend_kwargs)
        do_warm = self.warm_on_join if warm is None else bool(warm)
        if do_warm:
            with self._mu:
                jobs = list(self._observed.values())
            warmed = {"warmed": 0, "hits": 0, "misses": 0}
            if jobs:
                warmed = fe.warmup(jobs)
            # the persisted fleet mix may be wider than THIS process's
            # observed table (other processes' windows) — warm it too
            from ..core.compilecache import CACHE, warm_from_disk

            if CACHE.enabled:
                disk = warm_from_disk(fe.cores)
                warmed["hits"] = warmed.get("hits", 0) + disk["hits"]
                warmed["misses"] = warmed.get("misses", 0) + disk["misses"]
            FLIGHT.event("fabric-warm", member=member,
                         signatures=warmed["warmed"],
                         cache_hits=warmed.get("hits", 0),
                         cache_misses=warmed.get("misses", 0))
        with self._mu:
            self.shards[member] = fe
        self._g_shards.set(float(len(self.shards)))
        out = self.membership.join(member, step, total)
        self.router.clear(member)
        return out

    def sync_alive(self, root: str, timeout_s: float,
                   total: int | None = None) -> list:
        """Reconcile membership against the heartbeat directory
        (``cluster/elastic.alive_members``): departures divert first,
        then the recorded sync.  Frontends of departed members close
        (their in-flight work re-routes); arrivals WITHOUT a cruncher
        are not auto-built — callers add compute capacity via
        :meth:`add_member`."""
        from ..cluster.elastic import alive_members

        with self._mu:
            have = set(self.shards)
        alive = set(alive_members(root, timeout_s))
        dead = sorted(have - alive, key=_order)
        outs = []
        for m in dead:
            outs.append(self.remove_member(m, total))
        return outs

    # -- cycle / health ------------------------------------------------------
    def _maybe_refresh(self) -> None:
        now = time.perf_counter()
        with self._mu:
            due = now - self._last_refresh >= self.health_refresh_s
            if due:
                self._last_refresh = now
        if due:
            self.refresh_health()

    def refresh_health(self) -> dict:
        """Rebuild the router's shard-health view from every live
        frontend's ``stats()`` — the per-cycle diversion input."""
        with self._mu:
            shards = dict(self.shards)
        return self.router.refresh_health(
            {m: fe.stats() for m, fe in shards.items()})

    def step(self) -> dict:
        """One synchronous fabric cycle (``autostart=False`` seam):
        every shard runs one dispatch cycle, then the health view
        refreshes from the post-cycle stats."""
        with self._mu:
            shards = dict(self.shards)
        out = {}
        for m in sorted(shards, key=_order):
            fe = shards[m]
            if fe._dead is not None:
                continue  # a crashed shard has nothing to step
            out[m] = fe.step()
        out["health"] = self.refresh_health()
        return out

    # -- checkpoints ---------------------------------------------------------
    def save_checkpoint(self, window: int, arrays: dict) -> str | None:
        """Checkpoint one completed window's partition state under the
        fabric's root (no-op without one) — the elastic atomic
        tmp+rename path, stamped with the live member-step table."""
        if not self.checkpoint_root:
            return None
        snap = self.membership.snapshot()
        steps = [snap["members"][m]
                 for m in sorted(snap["members"], key=_order)]
        return save_window(self.checkpoint_root, int(window), arrays,
                           member_steps=steps)

    def resume_checkpoint(self) -> dict | None:
        """Load the newest complete window checkpoint (or None) — the
        resume point a preempted-and-rerouted run continues from."""
        if not self.checkpoint_root:
            return None
        return resume_window(self.checkpoint_root)

    # -- views / lifecycle ---------------------------------------------------
    def stats(self) -> dict:
        """Per-shard stats plus the merged job-wide view and the
        router's health map."""
        with self._mu:
            shards = dict(self.shards)
        per = {m: fe.stats() for m, fe in shards.items()}
        return {
            "name": self.name,
            "epoch": self.membership.snapshot()["epoch"],
            "shards": per,
            "merged": merge_shard_serving(per),
            "unhealthy": self.router.health_view(),
        }

    def close(self, drain: bool = True) -> None:
        self._halt = True
        with self._mu:
            shards = dict(self.shards)
            self.shards.clear()
        for m in sorted(shards, key=_order):
            shards[m].close(drain=drain)
        self._g_shards.set(0.0)

    def __enter__(self) -> "ServeFabric":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
