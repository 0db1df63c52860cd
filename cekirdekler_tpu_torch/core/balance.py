"""The iterative load balancer — re-partition the global range across lanes
from measured per-lane wall times.

A copy of ``cekirdekler_tpu/core/balance.py`` with its arithmetic unchanged
(the port never imports the JAX package), with the reference's hooks: the
``prior-split`` and ``load-balance`` decision records (their inputs a
snapshot of the carried state before the call changes it, so
``obs/replay.py`` and the reference's replayer re-execute them bit for
bit), the ``balance-freeze`` / ``balance-jump`` flight events and the
balancer's counters and gauge.  ``BalanceState.from_dict`` and
``BalanceHistory.from_dict`` are new: they carry a mid-run balancer state
across from plain numbers (e.g. ``dataclasses.asdict`` of the reference's
objects).

The reference's ``Functions.loadBalance``
(HelperFunctions.cs:190-280) with its history smoothing (:119-156):

1. throughput_i ∝ (Σbench / bench_i) · (range_i + 1)   — work per unit time
2. normalize throughputs to shares
3. optional smoothing: shares averaged over a sliding history window
   (depth 10, set at Cores.cs:1065) to damp noisy timings
4. damped move:  range_i ← range_i − (range_i − total·share_i) · 0.3
5. quantize each range to a multiple of ``step`` (round to nearest)
6. repair the sum: add/remove one ``step`` at a time on the
   largest-throughput (grow) / largest-range (shrink) element until
   Σranges == total

``step`` is the work-group granularity — ``local_range`` (or
``local_range × pipeline_blobs`` when pipelined, matching
Cores.cs:595-604).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..metrics.registry import REGISTRY
from ..obs.decisions import DECISIONS
from ..obs.flight import FLIGHT

__all__ = [
    "load_balance",
    "BalanceHistory",
    "BalanceState",
    "equal_split",
    "prior_split",
    "per_iteration_benches",
    "DAMPING",
    "HISTORY_DEPTH",
    "MODEL_INVARIANTS",
]

DAMPING = 0.3        # reference: HelperFunctions.cs:246
HISTORY_DEPTH = 10   # reference: Cores.cs:1065
DAMP_MIN = 0.05      # adaptive floor — keeps the balancer responsive
DAMP_MAX = 0.6       # adaptive ceiling — faster than reference warm-up
DAMP_MAX_SMOOTHED = 0.3  # ceiling when a lagging history smoother is in the loop
DAMP_DECAY = 0.5     # on sign flip (oscillation detected)
DAMP_GROW = 1.25     # on consistent direction
#: Quantization-floor freeze margin: hold the split when the busiest
#: chip's excess over the mean is below this fraction of one step's
#: work on that chip (named so replay-verify catches a retune — a
#: recorded log re-executed after someone edits this constant fails
#: naming the first divergent seq).
FREEZE_MARGIN = 0.6
#: Sum-repair tie band (relative): when granting a leftover step, all
#: chips whose share is within this fraction of the best are treated
#: as tied and the step goes to the INCUMBENT (largest current range).
#: Found by the reference's bounded model checker (tools/ckmodel): with
#: two equal-rate chips plus one slower chip, the ``(range_i + 1)``
#: term hands the currently-SMALLER chip an epsilon-higher share, so a
#: strict argmax flips the repair step between the pair every
#: iteration — a permanent ±1-step swap limit cycle (re-shard +
#: re-upload churn each window) that the quantization freeze cannot
#: catch because the slow chip drags the mean down.  The band must
#: cover the +1 distortion (≤ one part in range_items ≈ 8e-3 at the
#: 128-step/3072-total bound) and stay far below genuine rate
#: differences (the alphabet's closest pair differs ~30%); the
#: counterexample trace is pinned in tests/fixtures_decisions/.
REPAIR_TIE_BAND = 0.02

#: Temporal invariants of the balancer freeze/jump machine, as the
#: reference states them; ``analysis/model.BalanceMachine`` checks them.
MODEL_INVARIANTS = (
    ("range-conservation", "safety",
     "every iteration's ranges sum exactly to the total — the "
     "sum-repair loop never loses or invents work"),
    ("range-quantized", "safety",
     "every range is a non-negative multiple of step at every "
     "iteration"),
    ("jump-one-shot", "safety",
     "at most one undamped jump per BalanceState lifetime, and only "
     "after the arming iteration (never on first-window benches)"),
    ("freeze-legal", "safety",
     "a freeze only ever holds a step-aligned split (the pipeline "
     "mode-change rule: holding is illegal when step changed under "
     "the held table)"),
    ("converges", "liveness",
     "for every rate-consistent trajectory in the alphabet the split "
     "settles within the bound and stays — no limit cycle survives "
     "the adaptive damping + quantization freeze"),
    ("prior-seeded-jump-within-one-step", "safety",
     "a trajectory seeded from prior_split with rate-true priors "
     "keeps every lane within one quantization step of the "
     "rate-implied split from the very first rebalance on — the "
     "heterogeneous-fleet contract: a 100x-slower host lane seeded "
     "by its prior never drags multi-iteration re-shard churn"),
)


@dataclass
class BalanceHistory:
    """Sliding-window share smoothing (reference: HelperFunctions.cs:119-156).

    ``weighted=False`` is the reference-parity flat average (group delay
    ≈ (depth−1)/2 ≈ 4.5 iterations).  ``weighted=True`` applies triangular
    recency weights — same noise suppression class, ~2/3 the lag — which is
    what lets the adaptive damping converge fast *with* smoothing on.
    """

    depth: int = HISTORY_DEPTH
    rows: list[list[float]] = field(default_factory=list)
    weighted: bool = False

    def smooth(self, shares: list[float]) -> list[float]:
        if self.rows and len(self.rows[0]) != len(shares):
            self.rows.clear()  # device count changed
        self.rows.append(list(shares))
        if len(self.rows) > self.depth:
            self.rows.pop(0)
        n = len(shares)
        out = [0.0] * n
        tot_w = 0.0
        for k, row in enumerate(self.rows, start=1):
            w = float(k) if self.weighted else 1.0
            tot_w += w
            for i in range(n):
                out[i] += w * row[i]
        return [v / tot_w for v in out]

    @classmethod
    def from_dict(cls, d: dict) -> "BalanceHistory":
        """A history from plain numbers (``dataclasses.asdict`` of either
        package's object)."""
        return cls(depth=int(d["depth"]),
                   rows=[[float(v) for v in r] for r in d["rows"]],
                   weighted=bool(d["weighted"]))

@dataclass
class BalanceState:
    """Per-compute-id continuous balancer state with *adaptive* per-chip
    damping.

    The reference uses one fixed damping 0.3 (HelperFunctions.cs:246).
    Near the fixed point that constant gain limit-cycles: a one-step
    quantization error on a low-cost-density chip perturbs its measured
    bench, and the share formula ``(Σb/b_i)·(range_i+1)`` scales that
    perturbation by the chip's (large) range — a loop gain > 1 that keeps
    ranges hopping ±2-4 steps forever.  RPROP-style per-chip damping kills
    the cycle: when a chip's desired move flips sign its damping halves
    (oscillation), while consistent direction grows it up to ``DAMP_MAX``
    (faster warm-up than the reference's fixed 0.3).
    """

    cont: list[float] = field(default_factory=list)
    prev_delta: list[float] = field(default_factory=list)
    damp: list[float] = field(default_factory=list)
    # one-shot warm start consumed: the SECOND measured rebalance may
    # jump undamped to the rate-implied split (``jump_start``);
    # afterwards the damped loop takes over (measured per-item rates are
    # fully informative once — noise handling is the damped loop's job)
    jumped: bool = False
    # the jump is ARMED by the first measured rebalance but fires on the
    # second: first-window benches routinely carry one lane's jit
    # compile (the executable-cache miss lands on whichever lane
    # dispatched first) and the transfer tuner's measuring fence, and an
    # undamped jump onto a ~20x-inflated bench would near-starve that
    # lane in one step — the damped first iteration absorbs the
    # contamination instead
    warm: bool = False

    def reset(self, ranges: list[int], damping: float) -> None:
        self.cont = [float(r) for r in ranges]
        self.prev_delta = [0.0] * len(ranges)
        self.damp = [damping] * len(ranges)
        self.jumped = False
        self.warm = False

    @classmethod
    def from_dict(cls, d: dict) -> "BalanceState":
        """A state from plain numbers (``dataclasses.asdict`` of either
        package's object) — how a mid-run state crosses packages."""
        return cls(cont=[float(v) for v in d["cont"]],
                   prev_delta=[float(v) for v in d["prev_delta"]],
                   damp=[float(v) for v in d["damp"]],
                   jumped=bool(d["jumped"]), warm=bool(d["warm"]))

def per_iteration_benches(
    window_ms: dict[int, float], iters: dict[int, int]
) -> dict[int, float]:
    """Window-granularity balancer feedback (the fused-dispatch contract,
    core/cores.py): an enqueue window measures each compute id's cost
    over the WHOLE window — one fence-retire time, or a per-cid marginal
    when the fence split is on — while the window may contain many
    iterations of that id (and, with the fused path, those iterations are
    one dispatch).  Normalizing to per-iteration milliseconds keeps the
    bench scale comparable across windows of different sizes, so the
    balancer's quantization-freeze threshold and the adaptive damping see
    a consistent signal whether a window held 1 iteration or 128.

    Per-device share ratios are unaffected (every device divides by the
    same count), so this changes reporting consistency, not splits."""
    return {
        cid: ms / max(1, iters.get(cid, 1)) for cid, ms in window_ms.items()
    }


def equal_split(total: int, num: int, step: int) -> list[int]:
    """First-call equal distribution in step quanta (reference:
    Cores.cs:569-596)."""
    if step <= 0:
        raise ValueError("step must be positive")
    if total % step != 0:
        raise ValueError(f"total range {total} not divisible by step {step}")
    units = total // step
    base = units // num
    rem = units - base * num
    ranges = [(base + (1 if i < rem else 0)) * step for i in range(num)]
    return ranges


def prior_split(
    total: int,
    step: int,
    priors: list[float],
    cid: int | None = None,
) -> list[int]:
    """Prior-weighted first split in step quanta — the heterogeneous
    analogue of :func:`equal_split`.

    ``priors`` are relative THROUGHPUT weights, one per lane
    (``hardware.rate_prior`` per device kind: host CPU == 1.0, every
    accelerator some multiple).  Shares are ``prior_i / Σpriors``,
    quantized by largest remainder: each lane floors to a ``step``
    multiple and the leftover quanta go to the largest fractional
    remainders (ties broken by higher prior, then lower index), so
    EVERY lane lands strictly within one step of its continuous share
    — the bound the ``prior-seeded-jump-within-one-step`` model
    invariant builds on.  Equal priors reproduce :func:`equal_split`
    exactly (the homogeneous degenerate case is bit-identical, so a
    same-kind fleet's decision history does not change shape).

    Pure and replayable: one ``prior-split`` decision record with the
    complete inputs (``obs/replay.py`` re-executes it bit-identically;
    the recorded priors are what ``ckreplay whatif --set
    rate_prior=off`` removes to quantify the seeding win offline).
    """
    if step <= 0:
        raise ValueError("step must be positive")
    if total % step != 0:
        raise ValueError(f"total range {total} not divisible by step {step}")
    num = len(priors)
    if num == 0:
        raise ValueError("prior_split needs at least one lane prior")
    safe = [max(float(p), 1e-9) for p in priors]
    tot_p = sum(safe)
    shares = [p / tot_p for p in safe]
    units = total // step
    cont = [units * s for s in shares]
    base = [int(c) for c in cont]
    leftover = units - sum(base)
    # largest remainder; ties → higher prior, then lower lane index
    order = sorted(
        range(num), key=lambda i: (-(cont[i] - base[i]), -safe[i], i))
    for i in order[:leftover]:
        base[i] += 1
    ranges = [b * step for b in base]
    if DECISIONS.enabled:
        DECISIONS.record("prior-split", {
            "total": int(total), "step": int(step),
            "priors": [float(p) for p in priors],
            "cid": cid,
        }, {
            "ranges": [int(r) for r in ranges],
            "shares": list(shares),
        })
    return ranges


def load_balance(
    benchmarks: list[float],
    ranges: list[int],
    total: int,
    step: int,
    history: BalanceHistory | None = None,
    damping: float = DAMPING,
    carry: list[float] | None = None,
    state: BalanceState | None = None,
    transfer_ms: list[float] | None = None,
    jump_start: bool = False,
    cid: int | None = None,
    rate_prior: list[float] | None = None,
) -> list[int]:
    """One balancer iteration; returns new per-chip ranges summing to
    ``total``, each a multiple of ``step`` (≥ 0).

    ``carry`` — optional mutable list holding the *continuous* (unquantized)
    ranges across iterations.  The reference damps then quantizes in one
    array, so any damped move smaller than step/2 rounds back and the
    balancer stalls up to ~2 steps from the ideal split; carrying the
    continuous state lets sub-step moves accumulate and converge exactly.

    ``state`` — optional :class:`BalanceState` enabling *adaptive* per-chip
    damping (supersedes ``carry``; see the class docstring).  Passing
    neither, or only ``carry``, keeps the reference's fixed-damping
    behavior (HelperFunctions.cs:246) as the parity mode.

    ``transfer_ms`` — optional per-chip separately-measured transfer wall
    (H2D staging + D2H materialization) of the same window.  Each chip's
    effective time becomes ``max(bench_i, transfer_i)``: a lane cannot
    compute data its link has not delivered, so its measured link time is
    a FLOOR on its cost — a lane with a slow effective link stops being
    assigned shares its (overlapped, hence small-looking) compute bench
    alone would justify.  This is what makes the balancer correct on rigs
    with unequal per-device link bandwidth (the streamed-transfer path
    overlaps transfer with compute, so the plain wall bench no longer
    carries the transfer term by itself).

    ``jump_start`` — with ``state``, the SECOND measured rebalance jumps
    UNDAMPED to the rate-implied split (``range_i ← total · share_i``)
    instead of creeping there at damped speed from the equal split:
    clean benches measure per-item cost density exactly, so the damped
    crawl only slows convergence (the r5 rig took 17 iterations; the
    jump removes most of them).  The FIRST measured rebalance only arms
    the jump (``BalanceState.warm``) and runs damped — first-window
    benches routinely carry one lane's jit compile (the executable-cache
    miss lands on whichever lane dispatched first), and an undamped jump
    onto a compile-inflated bench would near-starve that lane in one
    step.  One-shot per state (``BalanceState.jumped``); every later
    iteration runs the normal damped adaptive loop.

    ``cid`` — provenance only: the compute id this iteration balances,
    carried into the decision record so replay/what-if can chain one
    id's sequence (the math never reads it).

    ``rate_prior`` — provenance only, like ``cid``: the per-lane
    throughput priors that seeded this chain's FIRST split
    (:func:`prior_split`; ``None`` for an equal-split chain).  The math
    never reads it — the prior's entire effect is the starting ranges —
    but recording it on every iteration lets ``ckreplay whatif --set
    rate_prior=off`` rebuild the counterfactual equal-split chain from
    the log alone, and keeps replay-verify bit-identical (a recorded
    input, not a behavior change).

    Every iteration records one ``load-balance`` decision into
    ``obs.decisions.DECISIONS`` with the COMPLETE inputs (benches,
    ranges, floors, damping, and the pre-call history/carry/state
    snapshots) and outputs (action, new ranges, shares, effective
    times, continuous state) — the event-sourced provenance
    ``tools/ckreplay.py`` replay-verifies bit-identically.
    """
    n = len(ranges)
    if n == 1:
        return [total]
    # provenance snapshot at ENTRY, before the sum-repair/reset paths
    # mutate anything: replay re-executes this call from exactly here
    rec = None
    if DECISIONS.enabled:
        rec = {
            "benchmarks": [float(b) for b in benchmarks],
            "ranges": [int(r) for r in ranges],
            "total": int(total), "step": int(step),
            "damping": float(damping),
            "transfer_ms": (None if transfer_ms is None
                            else [float(t) for t in transfer_ms]),
            "jump_start": bool(jump_start),
            "cid": cid,
            "rate_prior": (None if rate_prior is None
                           else [float(p) for p in rate_prior]),
            "history": None if history is None else {
                "depth": int(history.depth),
                "weighted": bool(history.weighted),
                "rows": [list(r) for r in history.rows],
            },
            "carry": None if carry is None else list(carry),
            "state": None if state is None else _state_snapshot(state),
        }
    if sum(ranges) != total:
        ranges = equal_split(total, n, step)
        if carry is not None:
            carry.clear()
        if state is not None:
            state.cont.clear()
    if state is not None and len(state.cont) != n:
        state.reset(ranges, damping)

    base: list[float]
    if state is not None:
        base = list(state.cont)
    elif carry:
        base = list(carry)
    else:
        base = [float(r) for r in ranges]

    # 1-2: normalized throughput shares (measured on the quantized ranges)
    safe = [max(b, 1e-9) for b in benchmarks]
    floor_bound = [False] * n
    if transfer_ms is not None and len(transfer_ms) == n:
        # transfer floor: effective time = max(compute bench, link time)
        floor_bound = [max(t, 0.0) > s for s, t in zip(safe, transfer_ms)]
        safe = [max(s, max(t, 0.0)) for s, t in zip(safe, transfer_ms)]
    tot_b = sum(safe)

    thr = [(tot_b / safe[i]) * (ranges[i] + 1.0) for i in range(n)]
    tot_t = sum(thr)
    shares = [t / tot_t for t in thr]

    # adaptive mode: quantization-floor freeze.  When the busiest chip's
    # excess over the mean is less than ~half the work one ``step`` of its
    # range represents, no step-quantized move can improve the balance —
    # further moves just churn (re-shard, re-upload) around a ±1-step limit
    # cycle.  Hold the split and re-anchor the continuous state.  The
    # history still receives this iteration's measured shares so the
    # smoothing window stays current — a workload shift that later
    # unfreezes the balancer must not be steered by pre-freeze rows.
    if (
        state is not None
        # holding is only legal when the held split is valid for the
        # caller's CURRENT step (pipeline mode changes step to
        # local_range·blobs mid-stream, Cores.cs:595-604)
        and all(r % step == 0 for r in ranges)
    ):
        mean_b = tot_b / n
        i_max = max(range(n), key=lambda k: safe[k])
        if ranges[i_max] > 0:
            one_step_work = safe[i_max] / ranges[i_max] * step
            if safe[i_max] - mean_b < FREEZE_MARGIN * one_step_work:
                if history is not None:
                    history.smooth(shares)
                state.cont = [float(r) for r in ranges]
                state.prev_delta = [0.0] * n
                REGISTRY.counter(
                    "ck_balance_freeze_total",
                    "quantization-floor freezes (split held, churn avoided)",
                ).inc()
                FLIGHT.event("balance-freeze", ranges=list(ranges))
                if rec is not None:
                    DECISIONS.record("load-balance", rec, {
                        "action": "freeze",
                        "ranges": [int(r) for r in ranges],
                        "shares": list(shares),
                        "effective_ms": list(safe),
                        "floor_bound": list(floor_bound),
                        "cont": [float(r) for r in ranges],
                        "freeze": {
                            "mean_ms": mean_b,
                            "one_step_work_ms": one_step_work,
                            "excess_ms": safe[i_max] - mean_b,
                            "lane": i_max,
                            # the margin IN EFFECT at decision time —
                            # explain must render the constant this
                            # freeze actually compared against, not
                            # whatever the code ships later
                            "margin": FREEZE_MARGIN,
                        },
                        "state_after": _state_snapshot(state),
                    })
                return list(ranges)

    # 3: optional smoothing
    if history is not None:
        shares = history.smooth(shares)
        s = sum(shares)
        shares = [v / s for v in shares]

    # 4: damped continuous update
    do_jump = (
        state is not None and jump_start and not state.jumped and state.warm
    )
    jump_armed = False
    if state is not None and jump_start and not state.jumped and not state.warm:
        jump_armed = True
        # arm only: first-window benches routinely carry one lane's jit
        # compile and the tuner's measuring fence — jumping undamped
        # onto a compile-inflated bench would near-starve that lane in
        # one step, so this iteration runs damped and the NEXT measured
        # rebalance jumps on clean benches
        state.warm = True
    action = "jump" if do_jump else ("damped" if state is not None else "fixed")
    if do_jump:
        # transfer-aware warm start: one undamped jump to the
        # rate-implied split (second-window benches carry per-item cost
        # density exactly — creeping there at damped speed from the
        # equal split is pure lost convergence)
        state.jumped = True
        cont = [total * v for v in shares]
        state.prev_delta = [cont[i] - base[i] for i in range(n)]
        state.cont = list(cont)
        REGISTRY.counter(
            "ck_balance_jump_total",
            "one-shot undamped warm-start jumps to the rate-implied split",
        ).inc()
        FLIGHT.event(
            "balance-jump",
            target=[round(total * v, 1) for v in shares],
        )
    elif state is not None:
        # a lagging smoother in the loop lowers the stable gain ceiling
        # (delay ~3 iters × gain must stay < 1): cap tighter when history on
        damp_max = DAMP_MAX if history is None else DAMP_MAX_SMOOTHED
        cont = []
        for i in range(n):
            delta = total * shares[i] - base[i]
            if delta * state.prev_delta[i] < 0.0:
                state.damp[i] = max(DAMP_MIN, state.damp[i] * DAMP_DECAY)
            elif delta * state.prev_delta[i] > 0.0:
                state.damp[i] = min(damp_max, state.damp[i] * DAMP_GROW)
            state.damp[i] = min(state.damp[i], damp_max)
            state.prev_delta[i] = delta
            cont.append(base[i] + delta * state.damp[i])
        # unequal per-chip damping breaks Σcont == total; renormalize so
        # drift can't accumulate across iterations
        s = sum(cont)
        if s > 0:
            cont = [c * (total / s) for c in cont]
        state.cont = list(cont)
        REGISTRY.gauge(
            "ck_balance_damp_mean",
            "mean adaptive per-chip damping (carry state health)",
        ).set(sum(state.damp) / n)
    else:
        cont = [base[i] - (base[i] - total * shares[i]) * damping for i in range(n)]
    if carry is not None:
        carry[:] = cont

    # 5: quantize to step, round to nearest
    quant = [max(0, int((c / step) + 0.5)) * step for c in cont]

    # 6: repair the sum one step at a time (reference: HelperFunctions.cs:271-279)
    diff = total - sum(quant)
    guard = 0
    while diff != 0 and guard < 1_000_000:
        guard += 1
        if diff > 0:
            # grant a step to the fastest (highest share) chip; chips
            # within REPAIR_TIE_BAND of the best are TIED and the step
            # stays with the incumbent (largest current range) — a
            # strict argmax limit-cycles on equal-rate chips (see the
            # REPAIR_TIE_BAND note; ckmodel counterexample)
            smax = max(shares)
            cands = [k for k in range(n)
                     if shares[k] >= smax * (1.0 - REPAIR_TIE_BAND)]
            i = max(cands, key=lambda k: (ranges[k], shares[k]))
            quant[i] += step
            diff -= step
        else:
            # take a step from the largest allocation that can give one
            candidates = [k for k in range(n) if quant[k] >= step]
            i = max(candidates, key=lambda k: quant[k])
            quant[i] -= step
            diff += step
    if rec is not None:
        DECISIONS.record("load-balance", rec, {
            "action": action,
            "jump_armed": jump_armed,
            "ranges": [int(x) for x in quant],
            "shares": list(shares),
            "effective_ms": list(safe),
            "floor_bound": list(floor_bound),
            "cont": list(cont),
            "state_after": _state_snapshot(state),
        })
    return quant


def _state_snapshot(state: BalanceState | None) -> dict | None:
    """The replay-sufficient view of a :class:`BalanceState` — every
    field the next iteration's math reads."""
    if state is None:
        return None
    return {
        "cont": list(state.cont),
        "prev_delta": list(state.prev_delta),
        "damp": list(state.damp),
        "jumped": state.jumped,
        "warm": state.warm,
    }
