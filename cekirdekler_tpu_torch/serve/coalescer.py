"""Coalescing plan: which signature groups dispatch this cycle, in
what order.

A copy of the reference's ``serve/coalescer.py`` kept in the port (which
never imports the JAX package): the same plan for the same snapshot
(``tests/test_torch_serve.py``).  The text below is the reference's.

Requests coalesce by **job signature** (kernels + param identity +
ranges + values — the same identity the fused-dispatch window keys on,
``Cores._fused_signature``): a group of same-signature requests
dispatches as ONE fused ladder per device
(``Cores.compute_fused_batch``), so the coalescing plan is literally
the batching plan.

:func:`plan_coalesce` is a PURE function of its snapshot — every call
is recorded as a ``coalesce`` decision and re-executed bit-identically
by ``ckreplay verify``.  Ordering rules, pinned by test:

1. **Fairness promotions first.**  A group that lost the pick
   :data:`STARVE_ROUNDS` (2) consecutive planning rounds is promoted to
   the FRONT of the order — the SectionScheduler starvation rule
   (the reference bench's section scheduler) generalized from bench
   sections to request groups.
   Promotion order is LONGEST-starved first; only equal-streak ties
   share the head slot by round-count rotation.  (The earlier
   whole-list rotation anchored on ``round % len(streak)`` let
   arrivals resize the streak and re-aim the anchor past the same
   member repeatedly — the bounded model checker (``analysis/model.py``)
   falsified its bound at 4 groups; longest-first restores the
   provable capacity-aware bound in ``MODEL_INVARIANTS``.)
2. **Deadline-aware (EDF) next.**  Among unpromoted groups, the
   earliest deadline dispatches first; groups with no deadline sort
   after every deadlined group.
3. **Oldest arrival breaks ties**, then the group key (total
   determinism — the same snapshot always yields the same plan).

``max_picks`` bounds how many groups one cycle dispatches (0 = all);
starvation only arises under that bound, which is exactly when the
fairness rule matters.
"""

from __future__ import annotations

__all__ = ["plan_coalesce", "STARVE_ROUNDS", "MODEL_INVARIANTS"]

#: Consecutive lost rounds that promote a group to the front of the
#: plan (the SectionScheduler's "no section starves more than 2
#: consecutive rounds" guarantee, applied to request groups).
STARVE_ROUNDS = 2

#: Machine-checked temporal invariants of the coalescing plan (the
#: ``MODEL_INVARIANTS`` contract — see ``obs/drain.py``):
#: ``analysis/model.py`` explores every arrival/desertion/deadline
#: interleaving over a small group alphabet with the dispatcher's own
#: starvation bookkeeping (picked → 0, unpicked pending → +1, empty
#: group leaves the table) and proves each of these over every
#: reachable state.  The starvation bound is capacity-aware: with
#: ``max_picks`` ≥ the promotion streak size every promoted group
#: dispatches immediately (the SectionScheduler guarantee,
#: STARVE_ROUNDS consecutive losses at most); under a tighter
#: ``max_picks`` the rotation shares the head slot, so a group waits
#: at most the streak it shares — STARVE_ROUNDS + (groups − 1) total.
MODEL_INVARIANTS = (
    ("promoted-are-starved", "safety",
     "promoted ⊆ groups whose consecutive-loss streak reached "
     "STARVE_ROUNDS — promotion is earned, never spontaneous"),
    ("plan-complete", "safety",
     "order is a permutation of the pending groups and picked is "
     "exactly its max_picks prefix — no group vanishes from a plan"),
    ("plan-deterministic", "safety",
     "the same snapshot always yields the same plan (total order: "
     "promotion rotation, EDF, age, key)"),
    ("bounded-starvation", "liveness",
     "under fairness (the group stays pending) no group starves more "
     "than STARVE_ROUNDS + (groups − 1) consecutive cycles at "
     "max_picks=1, and no more than STARVE_ROUNDS when max_picks "
     "covers the promotion streak"),
)


def _edf_key(g: dict):
    dl = g.get("deadline_in_s")
    return (
        0 if dl is not None else 1,          # deadlined groups first
        float(dl) if dl is not None else 0.0,  # earliest deadline
        -float(g.get("oldest_age_s") or 0.0),  # then oldest arrival
        str(g.get("key")),                     # total determinism
    )


def plan_coalesce(groups: list, round_idx: int, max_picks: int = 0) -> dict:
    """The PURE coalescing plan (see module docstring).

    ``groups`` rows are ``{"key", "pending", "deadline_in_s",
    "oldest_age_s", "starved_rounds"}`` snapshots; ``round_idx`` is the
    dispatcher's monotone planning-round counter (the rotation anchor);
    ``max_picks`` bounds the cycle (0/negative = unbounded).

    Returns ``{"order": [keys], "picked": [keys], "promoted": [keys],
    "max_picks": n}`` — ``picked`` is the prefix this cycle dispatches;
    ``order`` is the full ranking (the starvation bookkeeping's
    reference)."""
    rows = [g for g in groups if int(g.get("pending", 0)) > 0]
    streak = sorted(
        ((int(g.get("starved_rounds", 0)), str(g["key"])) for g in rows
         if int(g.get("starved_rounds", 0)) >= STARVE_ROUNDS),
        key=lambda sk: (-sk[0], sk[1]),
    )
    promoted: list[str] = []
    if streak:
        # LONGEST-starved first — the bound's proof obligation: under
        # max_picks=1 every pick goes to a worst-streak member, so a
        # member waits at most its peers-with-≥-streak count, and no
        # later entrant (arriving at exactly STARVE_ROUNDS, below the
        # leader) can jump the queue.  The previous whole-list
        # rotation (anchor = round % len(streak)) broke exactly there:
        # arrivals resized the streak and re-aimed the anchor, and the
        # bounded model checker's G=4 probe starved one group 6+
        # rounds.  The round rotation survives only INSIDE the leading
        # tie class, where it still shares the head slot fairly.
        top = streak[0][0]
        ties = [k for s, k in streak if s == top]
        anchor = int(round_idx) % len(ties)
        promoted = (ties[anchor:] + ties[:anchor]
                    + [k for s, k in streak if s != top])
    rest = sorted(
        (g for g in rows if str(g["key"]) not in set(promoted)),
        key=_edf_key,
    )
    order = promoted + [str(g["key"]) for g in rest]
    n = int(max_picks)
    picked = order[:n] if n > 0 else list(order)
    return {
        "order": order,
        "picked": picked,
        "promoted": promoted,
        "max_picks": n if n > 0 else 0,
    }
