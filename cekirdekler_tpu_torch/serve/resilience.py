"""Serving-tier resilience: blast-radius containment, retry budgets,
circuit breakers, and brownout shedding.

A copy of the reference's ``serve/resilience.py`` kept in the port (which
never imports the JAX package): the same pure machines and the same
decision records (``tests/test_torch_serve_resilience.py``).  The text
below is the reference's.

The serving tier inherited the runtime's all-or-nothing failure
semantics: one poisoned fused window failed every coalesced request
from every tenant in the batch, and the dispatcher had no retry,
hedging, or shedding story at all.  This module is the resilience
layer — four coordinated mechanisms, every one a PURE, replay-verified
decision function with a thin stateful wrapper (the drain-controller
pattern, ``obs/drain.py``):

1. **Blast-radius containment** (:func:`containment_plan` + the
   frontend's ``_dispatch_group``).  A fused batch that fails CLEANLY
   mid-window (``FusedBatchError.clean`` — the dispatch preflight
   refused before any lane's closure was queued, so device iteration
   counts never diverged) is bisected down to the faulty request:
   healthy halves re-dispatch bit-identically, the faulty request fails
   with its NAMED cause, and its coalesced neighbors complete exactly
   as they would have in an unfaulted run.  A dirty failure (lanes may
   have diverged) is never "repaired" by guesswork: the residue fails
   with a named ``partial-window`` error — honest containment over
   silent corruption, and never a silently dropped request.

2. **Retry budgets** (:func:`retry_decision` + :class:`RetryBudgets`).
   Per-request, deadline-aware retries with bounded exponential backoff
   and seeded jitter (the cluster client's reconnect idiom), gated by a
   per-tenant token budget: successes refill tokens at
   ``retry_budget_ratio`` per completion, each retry spends one — under
   overload the budget drains and retries stop, so retries can never
   amplify a failure storm (retry-storm protection).

3. **Circuit breakers** (:func:`breaker_transition` /
   :func:`breaker_admit` + :class:`BreakerBoard`).  A pure
   closed→open→half-open machine per (tenant, job-signature) and per
   lane, fed by dispatch failure/success outcomes.  Open refuses with
   an HONEST ``retry_after_s`` (the remaining open window); after
   ``open_s`` the next admit becomes the half-open PROBE — exactly one
   in flight, success closes, failure re-opens.  Wired into
   ``admit_decision`` as the named ``circuit-open`` rejection.

4. **Brownout shedding** (:func:`brownout_transition` + the frontend's
   per-cycle evaluation).  Under SUSTAINED degradation — queue growth
   past a watermark, or open breakers / drained lanes with a non-trivial
   queue — the frontend sheds over-quota and lowest-priority traffic
   with the named ``brownout`` rejection instead of letting p99 collapse
   for everyone.  Engage and release both carry hysteresis
   (``engage_streak`` consecutive pressured/clear evaluations), and a
   tenant with nothing in flight is NEVER shed (the starvation floor).

Every mechanism's decisions land in the decision log (kinds
``breaker`` / ``shed`` / ``retry`` / ``containment``) with complete
inputs and replay bit-identically through ``ckreplay verify``; the pure
functions declare :data:`MODEL_INVARIANTS` and are exhaustively checked
by the bounded model checker (``analysis/model.py``, machine
``resilience``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from ..metrics.registry import REGISTRY
from ..obs.decisions import DECISIONS
from ..obs.flight import FLIGHT

__all__ = [
    "BREAKER_CLOSED",
    "BREAKER_OPEN",
    "BREAKER_HALF_OPEN",
    "breaker_init",
    "breaker_transition",
    "breaker_admit",
    "brownout_transition",
    "retry_decision",
    "containment_plan",
    "BreakerBoard",
    "RetryBudgets",
    "ResilienceConfig",
    "BREAKER_INVARIANTS",
    "SHED_INVARIANTS",
    "RETRY_INVARIANTS",
    "MODEL_INVARIANTS",
]

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half-open"

#: Floor for retry/backoff hints (shared shape with admission's
#: ``_RETRY_FLOOR_S`` — no hint may invite a reject/retry busy-loop).
_HINT_FLOOR_S = 0.005

#: Machine-checked temporal invariants of the breaker machine
#: (``analysis/model.py`` drives :func:`breaker_transition` ×
#: :func:`breaker_admit` over every event/tick interleaving under
#: small bounds).
BREAKER_INVARIANTS = (
    ("breaker-half-open-one-probe", "safety",
     "half-open admits EXACTLY one probe: while the probe is in flight "
     "every further admit is refused"),
    ("breaker-opens-on-threshold", "safety",
     "the breaker is open exactly when the last `threshold` outcomes "
     "since a success were consecutive failures — no spurious open, no "
     "missed open"),
    ("breaker-honest-hint", "safety",
     "a refused admit carries retry_after_s equal to the remaining "
     "open window (0 < hint <= open_s) — the client is told the truth "
     "about when trying again can help"),
    ("breaker-open-times-out", "liveness",
     "an open breaker always reaches half-open: within open_s of "
     "opening the next admit is granted as the probe"),
    ("breaker-recovers-on-ok", "liveness",
     "under an all-success schedule (in-flight probe outcomes "
     "delivered, admits otherwise) the breaker reaches closed within "
     "open_s + 2 steps — no permanent open under all-ok inputs"),
)

#: Machine-checked invariants of the brownout shed machine
#: (:func:`brownout_transition` + the ``admit_decision`` brownout gate).
SHED_INVARIANTS = (
    ("shed-pressure-gated", "safety",
     "brownout never engages without `engage_streak` CONSECUTIVE "
     "pressured evaluations (queue past the watermark, or open "
     "breakers / drained lanes with the queue past the clear mark)"),
    ("shed-quota-floor", "safety",
     "shedding never starves a within-quota tenant: under brownout a "
     "tenant with zero requests in flight is always admitted "
     "(shed_quota >= 1)"),
    ("shed-named-hint", "safety",
     "every brownout rejection is NAMED (reason `brownout`) and "
     "carries retry_after_s >= the anti-busy-loop floor"),
    ("shed-releases", "liveness",
     "under sustained all-clear inputs brownout disengages within "
     "`engage_streak` evaluations — degraded mode is never sticky"),
)

#: Machine-checked invariants of the retry-budget machine
#: (:func:`retry_decision` + :class:`RetryBudgets`).
RETRY_INVARIANTS = (
    ("retry-budget-bounded", "safety",
     "a retry is granted only with a whole budget token available and "
     "attempt < max_attempts — retries cannot amplify an overload "
     "past the budget (retry-storm protection)"),
    ("retry-backoff-bounded", "safety",
     "every granted delay obeys bounded exponential backoff "
     "(delay <= 1.5 * cap_s) and never overshoots the request's "
     "remaining deadline"),
)

#: The module's full declared invariant surface — the ``resilience``
#: ckmodel machine checks exactly this list (BREAKER + SHED + RETRY).
MODEL_INVARIANTS = BREAKER_INVARIANTS + SHED_INVARIANTS + RETRY_INVARIANTS


# ---------------------------------------------------------------------------
# the pure functions (replay-verified; see obs/replay.py)
# ---------------------------------------------------------------------------

def breaker_init() -> dict:
    """A fresh (closed) breaker state."""
    return {"state": BREAKER_CLOSED, "failures": 0,
            "probe_inflight": False, "opened_t": None}


def breaker_transition(state: dict, event: str, now: float,
                       threshold: int, open_s: float) -> dict:
    """The PURE breaker outcome transition.  ``event`` is ``success``
    or ``failure`` (one completed request's outcome for this breaker's
    key); ``now`` is the caller's clock reading (an INPUT — purity).
    Returns ``{"state": <new state dict>, "action": opened | closed |
    reopened | None}``."""
    st = dict(state)
    action = None
    if st["state"] == BREAKER_CLOSED:
        if event == "failure":
            st["failures"] = int(st["failures"]) + 1
            if st["failures"] >= int(threshold):
                st["state"] = BREAKER_OPEN
                st["opened_t"] = float(now)
                st["probe_inflight"] = False
                action = "opened"
        else:
            st["failures"] = 0
    elif st["state"] == BREAKER_HALF_OPEN:
        if event == "failure":
            # the probe failed: back to open, a fresh open window
            st["state"] = BREAKER_OPEN
            st["opened_t"] = float(now)
            st["probe_inflight"] = False
            st["failures"] = int(threshold)
            action = "reopened"
        else:
            st["state"] = BREAKER_CLOSED
            st["failures"] = 0
            st["probe_inflight"] = False
            st["opened_t"] = None
            action = "closed"
    elif st["state"] == BREAKER_OPEN and event == "failure" \
            and st["opened_t"] is not None \
            and float(now) - float(st["opened_t"]) >= float(open_s):
        # a failure arriving AFTER the open window expired re-arms it:
        # lane breakers are fed outcomes but never admit-gated (the
        # only transition out of open), so without this a persistently
        # failing lane would read "timed-out open" forever and its
        # brownout pressure signal would die after one window
        st["opened_t"] = float(now)
        action = "reopened"
    # open, inside the window: outcomes still arriving are stale
    # (admits were refused) — the window runs to its timeout
    # regardless; extending it on stale evidence would break the
    # open-times-out liveness bound
    return {"state": st, "action": action}


def breaker_admit(state: dict, now: float, open_s: float) -> dict:
    """The PURE breaker admit gate.  Returns ``{"allow", "probe",
    "retry_after_s", "state", "action"}`` — ``state`` is the (possibly
    transitioned) post-admit state: an open breaker past its window
    flips to half-open HERE and the granted admit is the probe
    (``probe=True``, exactly one until its outcome arrives)."""
    st = dict(state)
    if st["state"] == BREAKER_CLOSED:
        return {"allow": True, "probe": False, "retry_after_s": None,
                "state": st, "action": None}
    if st["state"] == BREAKER_OPEN:
        age = float(now) - float(st["opened_t"] or 0.0)
        if age < float(open_s):
            remaining = float(open_s) - age
            return {"allow": False, "probe": False,
                    "retry_after_s": max(_HINT_FLOOR_S, remaining),
                    "state": st, "action": None}
        st["state"] = BREAKER_HALF_OPEN
        st["probe_inflight"] = True
        return {"allow": True, "probe": True, "retry_after_s": None,
                "state": st, "action": "half-open"}
    # half-open: exactly one probe in flight
    if st["probe_inflight"]:
        return {"allow": False, "probe": False,
                "retry_after_s": max(_HINT_FLOOR_S, float(open_s) / 2.0),
                "state": st, "action": None}
    st["probe_inflight"] = True
    return {"allow": True, "probe": True, "retry_after_s": None,
            "state": st, "action": None}


def brownout_transition(state: dict, queue_depth: int, watermark: int,
                        clear_mark: int, open_breakers: int,
                        drained_lanes: int, engage_streak: int = 2) -> dict:
    """The PURE brownout engage/release transition, evaluated once per
    dispatch cycle (cold).  ``state`` is ``{"active": bool, "streak":
    int}`` — ``streak`` counts consecutive pressured evaluations while
    inactive, consecutive CLEAR evaluations while active (hysteresis in
    both directions).  Pressure = queue past the watermark, or open
    breakers / drained lanes while the queue is past the clear mark
    (secondary signals alone cannot brown out an idle tier).  Returns
    ``{"active", "streak", "pressure", "changed"}``."""
    active = bool(state.get("active", False))
    streak = int(state.get("streak", 0))
    qd = int(queue_depth)
    pressure = bool(
        qd >= int(watermark)
        or ((int(open_breakers) > 0 or int(drained_lanes) > 0)
            and qd >= int(clear_mark))
    )
    changed = False
    if not active:
        streak = streak + 1 if pressure else 0
        if streak >= int(engage_streak):
            active, streak, changed = True, 0, True
    else:
        streak = streak + 1 if not pressure else 0
        if streak >= int(engage_streak):
            active, streak, changed = False, 0, True
    return {"active": active, "streak": streak, "pressure": pressure,
            "changed": changed}


def retry_decision(attempt: int, max_attempts: int, tokens: float,
                   deadline_left_s: float | None, base_s: float,
                   cap_s: float, jitter_u: float) -> dict:
    """The PURE per-request retry decision.  ``attempt`` is 0-based
    (the retry being considered), ``tokens`` the tenant's current
    budget, ``jitter_u`` a [0,1) draw from the caller's SEEDED rng
    (recorded as an input, so replay is exact — the cluster client's
    jitter idiom).  Returns ``{"retry", "delay_s", "reason"}`` —
    ``reason`` names why a retry was refused (``attempts-exhausted`` /
    ``budget-exhausted`` / ``deadline``)."""
    delay = min(float(cap_s), float(base_s) * (2.0 ** int(attempt)))
    delay = delay * (0.5 + float(jitter_u))  # jitter in [0.5, 1.5)·base
    if int(attempt) >= int(max_attempts):
        return {"retry": False, "delay_s": None,
                "reason": "attempts-exhausted"}
    if float(tokens) < 1.0:
        return {"retry": False, "delay_s": None,
                "reason": "budget-exhausted"}
    if deadline_left_s is not None and delay >= float(deadline_left_s):
        return {"retry": False, "delay_s": None, "reason": "deadline"}
    return {"retry": True, "delay_s": delay, "reason": None}


def containment_plan(k: int, leaf: int = 1) -> dict:
    """The PURE bisection plan for a cleanly-failed residue of ``k``
    coalesced requests: halves while ``k > leaf`` (a transient fault is
    localized in O(log k) re-dispatches), singles at the leaf (each
    surviving request completes bit-identically, the faulty one fails
    with its named cause).  Returns ``{"mode": bisect | per-request,
    "parts": [sizes]}`` — parts sum to exactly ``k``."""
    k = int(k)
    leaf = max(1, int(leaf))
    if k <= 0:
        return {"mode": "per-request", "parts": []}
    if k <= leaf:
        return {"mode": "per-request", "parts": [1] * k}
    return {"mode": "bisect", "parts": [(k + 1) // 2, k // 2]}


# ---------------------------------------------------------------------------
# stateful wrappers (the DrainController pattern)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ResilienceConfig:
    """The frontend's resilience knobs (the reference's docs/RESILIENCE.md, "Serving
    resilience")."""

    containment: bool = True
    bisect_leaf: int = 1
    retry_max_attempts: int = 2
    retry_base_s: float = 0.005
    retry_cap_s: float = 0.1
    #: Max TOTAL backoff sleep one dispatch cycle may pay inline per
    #: group; retries past it re-queue for the next cycle instead of
    #: stalling every tenant behind one request's backoff.
    retry_inline_budget_s: float = 0.05
    retry_budget_cap: float = 16.0
    retry_budget_ratio: float = 0.1
    retry_seed: int = 0
    breaker_threshold: int = 5
    breaker_open_s: float = 1.0
    brownout_watermark_frac: float = 0.75
    brownout_clear_frac: float = 0.5
    brownout_engage_streak: int = 2
    shed_frac: float = 0.5


class BreakerBoard:
    """Per-key circuit breakers over the pure machine (one board per
    frontend).  Keys are ``(tenant, signature)`` tuples for job-class
    breakers and ``("lane", index)`` for per-lane breakers (the latter
    feed the brownout pressure signal; they are never admit-gated, so
    :meth:`open_count` counts a lane breaker only while its open window
    is still running — a timed-out one is self-healing).

    ``admit``/``note`` take ``now`` from the caller so the pure
    functions stay pure; every state CHANGE records a replayable
    ``breaker`` decision (change-only — the drain-advisory lesson: a
    retry storm must not evict the ring's history) plus a
    ``breaker-flip`` flight event and cached-handle metrics."""

    def __init__(self, threshold: int = 5, open_s: float = 1.0,
                 name: str = "serve"):
        self.threshold = max(1, int(threshold))
        self.open_s = float(open_s)
        self.name = str(name)
        self._mu = threading.Lock()
        self._states: dict = {}
        # cached handles (admit rides the submit hot path)
        self._g_open = REGISTRY.gauge(
            "ck_serve_breakers_open",
            "circuit breakers currently inside an open window")
        self._m_flips = {
            to: REGISTRY.counter(
                "ck_serve_breaker_transitions_total",
                "circuit-breaker state transitions", to=to)
            for to in ("opened", "closed", "reopened", "half-open")
        }

    @staticmethod
    def _label(key) -> str:
        """The record/event label for a breaker key: lane keys are
        ``("lane", i)``; job-class keys are ``(tenant, sig, cid)`` —
        the signature tuple itself stays out of the label (it carries
        object identities), the compute id is its readable proxy."""
        if isinstance(key, tuple) and len(key) == 2 and key[0] == "lane":
            return f"lane{key[1]}"
        if isinstance(key, tuple) and len(key) == 3:
            return f"{key[0]}|cid{key[2]}"
        return str(key)[:80]

    # ckcheck: cold — runs only when a breaker CHANGED state (flips are failure-storm-edge events; the no-action fast path returns first)
    def _note_action(self, key, op: str, inputs: dict, out: dict) -> None:
        action = out.get("action")
        if not action:
            return
        m = self._m_flips.get(action)
        if m is not None:
            m.inc()
        FLIGHT.event("breaker-flip", key=self._label(key), to=action)
        if DECISIONS.enabled:
            DECISIONS.record("breaker", dict(inputs, op=op), {
                "state": dict(out["state"]),
                "action": action,
                **({"allow": out["allow"],
                    "probe": out["probe"],
                    "retry_after_s": out["retry_after_s"]}
                   if op == "admit" else {}),
            })
        # the WINDOWED count (a lane breaker past its open window no
        # longer counts — it is never admit-gated, so its entry would
        # otherwise read "open" forever and the gauge would disagree
        # with stats()/the pressure signal on a healthy tier)
        self._g_open.set(float(self.open_count(float(inputs["now"]))))

    def admit(self, key, now: float) -> dict:
        """The submit-path gate for ``key``: ``{"allow", "probe",
        "retry_after_s"}`` (see :func:`breaker_admit`).  A missing key
        is a closed breaker — one dict miss, no state created."""
        with self._mu:
            st = self._states.get(key)
            if st is None:
                return {"allow": True, "probe": False,
                        "retry_after_s": None}
            inputs = {"key": self._label(key), "state": dict(st),
                      "now": float(now), "open_s": self.open_s,
                      "threshold": self.threshold}
            out = breaker_admit(st, now, self.open_s)
            self._states[key] = out["state"]
        self._note_action(key, "admit", inputs, out)
        return {"allow": out["allow"], "probe": out["probe"],
                "retry_after_s": out["retry_after_s"]}

    # ckcheck: cold — probe bookkeeping on the admission REJECT edge
    def release_probe(self, key) -> None:
        """Un-consume a half-open probe admit that a LATER admission
        gate rejected: the probe never dispatched, so the slot must
        reopen (otherwise the breaker waits forever on an outcome that
        cannot arrive)."""
        with self._mu:
            st = self._states.get(key)
            if st is not None and st["state"] == BREAKER_HALF_OPEN:
                st = dict(st)
                st["probe_inflight"] = False
                self._states[key] = st

    # ckcheck: cold — outcome feed runs at dispatch-cycle resolution
    def note(self, key, event: str, now: float) -> dict | None:
        """Feed one outcome (``success``/``failure``) for ``key``.
        Creates the breaker on first failure (successes against an
        unknown key stay stateless)."""
        with self._mu:
            st = self._states.get(key)
            if st is None:
                if event != "failure":
                    return None
                st = breaker_init()
            inputs = {"key": self._label(key), "state": dict(st),
                      "event": str(event), "now": float(now),
                      "threshold": self.threshold, "open_s": self.open_s}
            out = breaker_transition(st, event, now, self.threshold,
                                     self.open_s)
            if out["state"]["state"] == BREAKER_CLOSED \
                    and out["state"]["failures"] == 0 \
                    and out["action"] is None:
                # fully-healthy breakers leave the table (bounded state)
                self._states.pop(key, None)
            else:
                self._states[key] = out["state"]
        self._note_action(key, "transition", inputs, out)
        return out

    def open_count(self, now: float) -> int:
        """Breakers still inside their open window (the brownout
        pressure input AND the ``ck_serve_breakers_open`` gauge's one
        source) — a timed-out open breaker no longer counts, so a
        never-readmitted lane breaker cannot pin pressure (or the
        gauge) forever.  Refreshes the gauge as a side effect: the
        per-cycle pressure evaluation keeps it current even between
        state flips."""
        with self._mu:
            n = 0
            for st in self._states.values():
                if st["state"] == BREAKER_OPEN and \
                        float(now) - float(st["opened_t"] or 0.0) \
                        < self.open_s:
                    n += 1
        self._g_open.set(float(n))
        return n

    def snapshot(self) -> dict:
        with self._mu:
            return {
                self._label(k): dict(st)
                for k, st in self._states.items()
            }


class RetryBudgets:
    """Per-tenant retry token buckets (one per frontend).  Tokens start
    at ``cap`` (a healthy tenant may retry immediately), refill at
    ``ratio`` per SUCCESSFUL completion, and each granted retry spends
    one — sustained failure drains the budget and retries stop
    (retry-storm protection; the pure gate is :func:`retry_decision`)."""

    def __init__(self, cap: float = 16.0, ratio: float = 0.1):
        self.cap = float(cap)
        self.ratio = float(ratio)
        self._mu = threading.Lock()
        self._tokens: dict[str, float] = {}

    def tokens(self, tenant: str) -> float:
        with self._mu:
            return self._tokens.get(str(tenant), self.cap)

    def note_success(self, tenant: str) -> None:
        with self._mu:
            t = self._tokens.get(str(tenant), self.cap)
            self._tokens[str(tenant)] = min(self.cap, t + self.ratio)

    def spend(self, tenant: str) -> None:
        with self._mu:
            t = self._tokens.get(str(tenant), self.cap)
            self._tokens[str(tenant)] = max(0.0, t - 1.0)

    def snapshot(self) -> dict:
        with self._mu:
            return dict(self._tokens)
