"""Deterministic, seeded fault injection: the chaos plane the recovery
tier is proved against.

A copy of ``cekirdekler_tpu/utils/faultinject.py`` kept in the port (which never
imports the JAX package); the text below is the reference's.

The drain/elastic machinery (obs/drain.py, cluster/elastic.py) exists
for failures that are rare and unreproducible in CI: a lane's link
silently degrading 5x, a driver submit failing mid-window, a cluster
socket dying mid-message.  This module makes those failures FIRST-CLASS
and REPRODUCIBLE: a fault plan is a seeded, named schedule of injection
points, armed by the :data:`FAULTS_ENV` environment variable
(``CK_FAULTS``) or programmatically, and the same plan string always
produces the same fault sequence — a chaos test that fails is re-run
bit-identically from its plan.

Plan grammar (documented in docs/RESILIENCE.md)::

    CK_FAULTS="seed=42;slow-link@lane1:factor=5,times=8;socket-drop@recv:after=2,times=1"

``;``-separated clauses; an optional leading ``seed=N`` seeds the
probabilistic draws.  Each fault clause is
``<point>[@<selector>][:<k>=<v>,...]``:

- **point** — one of :data:`FAULT_POINTS`:
  ``driver-submit`` (a dispatch-driver submit raises
  :class:`~cekirdekler_tpu.errors.InjectedFaultError`), ``lane-stall``
  (the barrier's per-lane fence sleeps ``delay_ms``), ``slow-link``
  (worker H2D/D2H transfers run ``factor``× slower — the injected
  delay is ``(factor-1) × measured wall + delay_ms``), ``socket-drop``
  (a cluster socket send/recv disconnects mid-message),
  ``serve-dispatch`` (a serving-tier dispatch part raises
  :class:`~cekirdekler_tpu.errors.InjectedFaultError` INSIDE the
  frontend's dispatch cycle, before anything reaches a driver queue —
  the blast-radius-containment/retry-budget chaos seam).
- **selector** — ``lane<N>`` matches only that lane's sites; any other
  token matches the site's ``where`` tag (``send``/``recv`` for
  sockets).  Absent = every matching site.
- **params** — ``after=K`` skip the first K matching hits, ``times=M``
  fire at most M times (default unlimited), ``p=0.5`` fire with
  probability p (drawn from a per-clause ``random.Random`` seeded by
  the plan seed — deterministic), ``delay_ms=X`` / ``factor=N`` the
  delay shape.

Design constraints (the flight-recorder family's):

1. **Disabled costs nothing.**  Every instrumented site guards with
   ``if FAULTS.enabled:`` — one attribute read + falsy check; the plane
   is disabled unless a plan is armed.  :meth:`FaultPlane.fire` is a
   declared ckcheck hot root (it is reached from the driver-queue
   submit path): per-point counter handles are cached at arm time and
   the one lock is only taken when an armed clause matches the point.
2. **Every injected fault is evidence.**  A fired clause records a
   ``fault-injected`` flight event and bumps
   ``ck_fault_injected_total{point}`` — postmortems and chaos tests
   read one stream; an unexplained failure can always be checked
   against what was injected.
3. **Determinism is the contract.**  Counting (``after``/``times``) is
   exact under the clause lock, and probabilistic draws come from
   per-clause seeded RNGs — the same plan + the same sequence of
   ``fire()`` calls yields the same fault sequence (pinned by
   tests/test_faultinject.py).
"""

from __future__ import annotations

import os
import random
import threading

from ..errors import InjectedFaultError

__all__ = [
    "FAULT_POINTS",
    "FAULTS_ENV",
    "FaultClause",
    "FaultPlane",
    "FAULTS",
    "parse_plan",
]

FAULTS_ENV = "CK_FAULTS"

#: The declared fault-point vocabulary — every instrumented site names
#: one of these (the EVENT_KINDS contract applied to fault points);
#: docs/RESILIENCE.md carries the table.
FAULT_POINTS = (
    "driver-submit",   # core/worker._DriverQueue.submit — submit raises
    "lane-stall",      # core/cores.Cores.barrier — per-lane fence sleeps
    "slow-link",       # core/worker transfers — Nx slowdown
    "socket-drop",     # cluster/netbuffer send/recv — disconnect mid-message
    "serve-dispatch",  # serve/frontend dispatch cycle — the part raises
)


class FaultClause:
    """One armed fault clause (see the module-docstring grammar)."""

    def __init__(self, point: str, selector: str | None = None,
                 after: int = 0, times: int | None = None, p: float = 1.0,
                 delay_ms: float = 0.0, factor: float = 1.0,
                 rng: random.Random | None = None):
        if point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {point!r}; points: {FAULT_POINTS}")
        self.point = point
        self.selector = selector
        self.lane: int | None = None
        if selector and selector.startswith("lane") \
                and selector[4:].isdigit():
            self.lane = int(selector[4:])
        self.after = max(0, int(after))
        self.times = None if times is None else max(0, int(times))
        self.p = float(p)
        self.delay_ms = float(delay_ms)
        self.factor = float(factor)
        self.rng = rng or random.Random(0)
        self.seen = 0    # matching hits observed (exact, under the lock)
        self.fired = 0   # faults actually injected

    def matches(self, lane, where) -> bool:
        if self.selector is None:
            return True
        if self.lane is not None:
            return lane == self.lane
        return where == self.selector

    def to_row(self) -> dict:
        return {
            "point": self.point, "selector": self.selector,
            "after": self.after, "times": self.times, "p": self.p,
            "delay_ms": self.delay_ms, "factor": self.factor,
            "seen": self.seen, "fired": self.fired,
        }


def parse_plan(plan: str, seed: int | None = None
               ) -> tuple[int, list[FaultClause]]:
    """Parse a plan string into ``(seed, clauses)``.  Raises
    ``ValueError`` with the offending clause on any grammar error — an
    armed-but-silently-ignored fault plan would be the worst failure
    mode a chaos rig can have."""
    clauses: list[FaultClause] = []
    plan_seed = 0 if seed is None else int(seed)
    parts = [p.strip() for p in plan.split(";") if p.strip()]
    for idx, part in enumerate(parts):
        if part.startswith("seed="):
            plan_seed = int(part[5:])
            continue
        head, _, params_str = part.partition(":")
        point, _, selector = head.partition("@")
        kw: dict = {}
        if params_str:
            for kv in params_str.split(","):
                k, eq, v = kv.partition("=")
                k = k.strip()
                if not eq or k not in (
                        "after", "times", "p", "delay_ms", "factor"):
                    raise ValueError(
                        f"bad fault param {kv!r} in clause {part!r}")
                kw[k] = int(v) if k in ("after", "times") else float(v)
        clauses.append(FaultClause(
            point.strip(), selector.strip() or None,
            rng=random.Random(plan_seed * 1000 + idx), **kw))
    return plan_seed, clauses


class FaultPlane:
    """The process-global fault injector (:data:`FAULTS`).

    ``enabled`` is a plain attribute (the tracer/flight convention) —
    every instrumented site's disabled fast path is one attribute read.
    """

    def __init__(self):
        self.enabled = False
        self.seed = 0
        self.plan: str | None = None
        self._mu = threading.Lock()
        self._by_point: dict[str, list[FaultClause]] = {}
        self._counters: dict[str, object] = {}
        self.arm_from_env()

    # -- arming ---------------------------------------------------------------
    def arm(self, plan: str, seed: int | None = None) -> None:
        """Arm the plane from a plan string (replaces any armed plan).
        Per-point metric handles are cached HERE so the fire path never
        pays a registry get-or-create (the hot-root discipline)."""
        plan_seed, clauses = parse_plan(plan, seed)
        from ..metrics.registry import REGISTRY

        by_point: dict[str, list[FaultClause]] = {}
        counters: dict[str, object] = {}
        for c in clauses:
            by_point.setdefault(c.point, []).append(c)
        for point in by_point:
            counters[point] = REGISTRY.counter(
                "ck_fault_injected_total",
                "deliberately injected faults (utils/faultinject.py)",
                point=point)
        with self._mu:
            self.seed = plan_seed
            self.plan = plan
            self._by_point = by_point
            self._counters = counters
        self.enabled = bool(by_point)

    def disarm(self) -> None:
        self.enabled = False
        with self._mu:
            self._by_point = {}
            self._counters = {}
            self.plan = None

    def arm_from_env(self) -> bool:
        """Arm from :data:`FAULTS_ENV` (unset/empty = disarmed).
        Returns True when a plan was armed."""
        plan = os.environ.get(FAULTS_ENV)
        if plan:
            self.arm(plan)
            return True
        return False

    # -- the injection sites' entry ------------------------------------------
    def fire(self, point: str, lane: int | None = None,
             where: str | None = None) -> FaultClause | None:
        """One site hit: returns the FIRST armed clause that fires for
        ``(point, lane, where)``, or None.  Counting is exact under the
        clause lock (determinism is the contract); the fired fault
        lands as a ``fault-injected`` flight event + metric."""
        if not self.enabled:
            return None
        clauses = self._by_point.get(point)
        if not clauses:
            return None
        hit: FaultClause | None = None
        with self._mu:
            for c in clauses:
                if not c.matches(lane, where):
                    continue
                c.seen += 1
                if c.seen <= c.after:
                    continue
                if c.times is not None and c.fired >= c.times:
                    continue
                if c.p < 1.0 and c.rng.random() >= c.p:
                    continue
                c.fired += 1
                hit = c
                break
        if hit is None:
            return None
        from ..obs.flight import FLIGHT

        FLIGHT.event(
            "fault-injected", point=point, lane=lane, where=where,
            selector=hit.selector, fired=hit.fired,
            delay_ms=hit.delay_ms, factor=hit.factor)
        counter = self._counters.get(point)
        if counter is not None:
            counter.inc()
        return hit

    def delay_s(self, point: str, lane: int | None = None,
                where: str | None = None, base_s: float = 0.0) -> float:
        """Seconds of injected delay for a delay-shaped point
        (``lane-stall``, ``slow-link``): ``(factor-1)×base_s +
        delay_ms`` when a clause fires, else 0.0."""
        hit = self.fire(point, lane=lane, where=where)
        if hit is None:
            return 0.0
        return max(0.0, (hit.factor - 1.0) * base_s) + hit.delay_ms / 1000.0

    def raise_if_fired(self, point: str, lane: int | None = None,
                       where: str | None = None) -> None:
        """Raise :class:`InjectedFaultError` when a clause fires for
        the point (``driver-submit`` shape)."""
        hit = self.fire(point, lane=lane, where=where)
        if hit is not None:
            raise InjectedFaultError(point, lane=lane, where=where)

    # -- observability --------------------------------------------------------
    def snapshot(self) -> dict:
        with self._mu:
            return {
                "enabled": self.enabled,
                "seed": self.seed,
                "plan": self.plan,
                "clauses": [
                    c.to_row()
                    for cs in self._by_point.values() for c in cs
                ],
            }


#: The process-global plane every instrumented site consults.
FAULTS = FaultPlane()
