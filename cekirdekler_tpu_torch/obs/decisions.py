"""Decision provenance: the event-sourced controller decision log.

A copy of ``cekirdekler_tpu/obs/decisions.py`` kept in the port (which never
imports the JAX package); the text below is the reference's.

The flight recorder (``obs/flight.py``) records *that* control
decisions happened — a ``rebalance`` event says the range table moved.
Nothing records **inputs sufficient to reproduce** the decision, so a
bad split on a production rig is undebuggable offline: you can see the
balancer chose ``[7936, 256]`` but not the benches, damping state,
transfer floors and history rows it chose it FROM.  This module is that
record.  Every controller decision in the runtime — ``load_balance``
(core/balance.py), ``TransferTuner.choose``/``observe``
(core/stream.py), fused-window engage/disengage (core/cores.py), lane
health verdict flips and drain advisories (obs/health.py), and the
bench's scheduler fairness rotation (bench.py) — appends one typed
:class:`DecisionRecord` carrying the decision's **complete inputs and
outputs**, a process-monotone ``seq``, and both clock stamps
(``perf_counter`` for ordering against the span ring, epoch for
off-process reads).

Three consumers ride on top (``obs/replay.py`` + ``tools/ckreplay.py``):

- **replay-verify** re-executes the pure decision functions from the
  recorded inputs and asserts bit-identical outputs — a recorded log is
  a golden test of the controllers, catching hidden nondeterminism and
  silent behavior drift when someone edits the balancer;
- **what-if** re-runs the *chained* decision sequence with modified
  knobs (``damping=…``, ``jump_start=off``, ``transfer_floor=off``),
  carrying balancer/tuner state forward, and reports the counterfactual
  convergence trajectory;
- **explain** renders the per-lane causality table of a split —
  raw bench, transfer floor (bound or slack), damped move, quantization
  residue, and which input bound the outcome — on the CLI and the
  ``/decisionz`` debug endpoint.

Design constraints, the flight recorder's exactly:

1. **Recording is cheap and lock-free.**  ``record()`` is two clock
   reads + one ``deque.append`` (GIL-atomic on a ``maxlen`` deque);
   disabled is one attribute read + falsy check, pinned by
   ``tests/test_decisions.py`` to the reference's budget (< 100 ns marginal).
   A FULL ring never blocks an append — ``maxlen`` eviction is the
   overflow policy, there is no lock to contend on.  No decision site
   rides the fused DEFERRAL path: every instrumented decision is
   window-granularity or colder (rebalances, tuner choices per streamed
   phase, health window closes).
2. **Records are self-contained.**  Each record's ``inputs`` snapshot
   everything the decision function read (including mutable carried
   state — ``BalanceState``, tuner observations — *before* the call
   mutated it), so any record can be replayed in isolation and a chain
   can be re-run from any starting seq.
3. **Spill is opt-in by environment.**  With :data:`DECISION_LOG_ENV`
   (``CK_DECISION_LOG``) naming a path, every record also lands in a
   bounded spill buffer and :meth:`DecisionLog.maybe_spill` (called
   from ``Cores.barrier``/``dispose`` — cold sync points) persists it:
   the file is CREATED whole via tmp+rename, then extended by
   incremental appends of only the rows written since the last spill
   (one ``write`` per spill — a sync point must not pay a rewrite of
   the whole history, and :func:`load_decision_log` skips a torn tail
   line by contract), so the on-disk log is a complete superset of the
   buffer — rows the :data:`SPILL_MAX` bound later evicts from memory
   are already on disk.  ``save_jsonl``/``spill`` with an explicit
   path stay full atomic tmp+rename dumps.  A path naming a DIRECTORY
   (or ending in a path separator) resolves to a per-process
   ``ck_decisions_<pid>.jsonl`` inside it — multi-process rigs (DCN
   jobs, bench's benchrig subprocess) must not last-writer-win one
   file.  Unarmed (unset OR empty), nothing touches disk.

The kind vocabulary is :data:`DECISION_KINDS`; ``tools/ckcheck``'s
invariant pass fails CI on an emitted kind missing here, and
``tools/lint_obs.py`` cross-checks the tuple against the decision table
in docs/OBSERVABILITY.md — a new decision kind is always declared AND
documented.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, NamedTuple

__all__ = [
    "DecisionRecord",
    "DecisionLog",
    "DECISIONS",
    "DECISION_KINDS",
    "REPLAYABLE_KINDS",
    "CONTEXT_KINDS",
    "DECISION_LOG_ENV",
    "load_decision_log",
]

DECISION_LOG_ENV = "CK_DECISION_LOG"

#: The declared decision-kind vocabulary (the ``EVENT_KINDS`` contract,
#: applied to decisions): every kind the built-in controllers emit.
DECISION_KINDS = (
    "load-balance",        # core/balance.load_balance — one balancer iteration
    "transfer-choose",     # core/stream.TransferTuner.choose — chunk count
    "transfer-observe",    # core/stream.TransferTuner.observe — model update
    "fused-engage",        # core/cores — a fused window opened
    "fused-disengage",     # core/cores — window refusal/break, named reason
    "health-verdict",      # obs/health — a (lane, signal) verdict flipped
    "drain-advisory",      # obs/health.suggest_drain — lanes named for eviction
    "scheduler-rotation",  # bench.SectionScheduler — fairness promotion
    "admission",           # serve/admission — one request admitted/rejected
    "coalesce",            # serve/coalescer — one dispatch cycle's batch plan
    "breaker",             # serve/resilience — a circuit breaker transitioned
    "shed",                # serve/resilience — brownout engaged/released
    "retry",               # serve/resilience — one budget-gated retry verdict
    "containment",         # serve/resilience — a failed batch's bisection plan
    "drain-apply",         # obs/drain — lanes quarantined (advice became action)
    "readmit",             # obs/drain — quarantined lanes re-admitted
    "member-leave",        # cluster/elastic — a member departed, re-split
    "member-join",         # cluster/elastic — a member arrived, re-split
    "checkpoint-restore",  # cluster/elastic — a run resumed from a window ckpt
    "block-retune",        # core/blocktuner — tile/block choice engaged/moved
    "route",               # serve/fabric — one shard-placement verdict
    "cache-warmup",        # core/cores.warmup — one AOT plan warmed (key set)
    "prior-split",         # core/balance.prior_split — prior-seeded first split
)

#: The subset replay-verify re-executes: decisions that are pure
#: functions of their recorded inputs.  The rest (fused engage/
#: disengage depend on live device residency; advisories and rotations
#: are derived views) are context records — provenance, not oracles.
REPLAYABLE_KINDS = (
    "load-balance", "transfer-choose", "transfer-observe", "health-verdict",
    "admission", "coalesce",
    "breaker", "shed", "retry", "containment",
    "drain-apply", "readmit", "member-leave", "member-join",
    "block-retune", "route", "prior-split",
)

#: The complement, DECLARED: every decision kind is placed in exactly
#: one bucket on purpose.  A kind in neither tuple would silently skip
#: ``ckreplay verify`` (an "unregistered kind" looks identical to a
#: deliberately context-only one) — ``tools/lint_obs.py`` fails CI
#: unless REPLAYABLE_KINDS ∪ CONTEXT_KINDS == DECISION_KINDS exactly,
#: and cross-checks the replayer registry in ``obs/replay.py`` against
#: REPLAYABLE_KINDS both ways.
CONTEXT_KINDS = (
    "fused-engage",        # depends on live device residency
    "fused-disengage",     # depends on live device residency
    "drain-advisory",      # derived view of the monitor's verdicts
    "scheduler-rotation",  # derived from on-disk artifact history
    "checkpoint-restore",  # reads the filesystem: provenance, not oracle
    "cache-warmup",        # reads the cache manifest: provenance, not oracle
)

#: Spill-buffer bound: the armed jsonl accumulation is capped so a
#: weeks-long process cannot grow host memory without bound; overflow
#: evicts oldest-first and is counted (``spill_dropped``).
SPILL_MAX = 200_000

#: jsonl spill format tag (first line of every spilled file).
SCHEMA = "ck-decision-log-v1"


class DecisionRecord(NamedTuple):
    """One recorded controller decision.

    ``seq`` is process-monotone across ALL kinds (``itertools.count`` —
    atomic under the GIL), so interleaved controllers order totally;
    ``t`` is ``perf_counter`` seconds (the span ring's clock), ``epoch``
    is ``time.time()`` (off-process readable)."""

    seq: int
    t: float
    epoch: float
    kind: str
    inputs: dict
    outputs: dict

    def to_row(self) -> dict:
        return {
            "seq": self.seq, "t": self.t, "epoch": self.epoch,
            "kind": self.kind, "inputs": self.inputs,
            "outputs": self.outputs,
        }

    @classmethod
    def from_row(cls, row: dict) -> "DecisionRecord":
        return cls(
            int(row["seq"]), float(row.get("t", 0.0)),
            float(row.get("epoch", 0.0)), str(row["kind"]),
            row.get("inputs") or {}, row.get("outputs") or {},
        )


class DecisionLog:
    """Bounded always-on ring of controller decisions (one
    process-global instance: :data:`DECISIONS`).

    ``enabled`` is a plain attribute (the tracer/flight convention: the
    disabled fast path must be an attribute read, not a property call).
    The ring is a ``maxlen`` deque — append evicts oldest-first
    atomically under the GIL; a full ring NEVER blocks an append, and
    readers take one-slice snapshots (reporting, not synchronization)."""

    def __init__(self, capacity: int = 4096, spill_interval_s: float = 5.0):
        self.enabled = True
        self._cap = max(16, int(capacity))
        self._ring: deque[DecisionRecord] = deque(maxlen=self._cap)
        # itertools.count.__next__ is GIL-atomic: concurrent recorders
        # get unique, strictly-increasing seqs with no lock
        self._seq = itertools.count(1)
        self._total = 0
        self._spill: deque[DecisionRecord] = deque(maxlen=SPILL_MAX)
        self._spill_seen = 0  # spill_dropped = seen - len(spill)
        self.spill_interval_s = float(spill_interval_s)
        self._last_spill_t = 0.0
        # incremental-append bookkeeping: the path the armed file was
        # created at and the highest seq already persisted there —
        # periodic spills append only newer rows
        self._spill_file: str | None = None
        self._spill_watermark = 0

    # -- recording (window-granularity sites only — never the deferral) ------
    def record(self, kind: str, inputs: dict | None = None,
               outputs: dict | None = None) -> int:
        """Append one decision; returns its ``seq`` (-1 when disabled).
        Callers build the (potentially large) inputs dict behind an
        ``if DECISIONS.enabled:`` guard — disabled must cost nothing."""
        if not self.enabled:
            return -1
        seq = next(self._seq)
        rec = DecisionRecord(
            seq, time.perf_counter(), time.time(), kind,
            inputs if inputs is not None else {},
            outputs if outputs is not None else {},
        )
        self._ring.append(rec)
        self._total += 1  # GIL-racy undercount possible; reporting only
        # ONE truthiness rule with spill_path()/maybe_spill(): a
        # set-but-empty CK_DECISION_LOG is "off" everywhere — arming
        # the buffer on mere presence would retain up to SPILL_MAX
        # full snapshots that no spill site would ever write
        if os.environ.get(DECISION_LOG_ENV):
            self._spill.append(rec)
            self._spill_seen += 1
        return seq

    # -- inspection ----------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def total_recorded(self) -> int:
        """Decisions recorded since the last clear — exceeds
        ``capacity`` when the ring wrapped (oldest were evicted)."""
        return self._total

    @property
    def spill_dropped(self) -> int:
        """Armed-spill rows evicted by the :data:`SPILL_MAX` bound."""
        return max(0, self._spill_seen - len(self._spill))

    def snapshot(self) -> list[DecisionRecord]:
        """Recorded decisions, oldest first (one-slice ring copy)."""
        return list(self._ring)

    @contextmanager
    def capture(self):
        """Route records into a scratch ring and yield it: the pure-
        function seam the bounded model checker
        (``cekirdekler_tpu/analysis/model.py``) needs — exploring a
        controller's state space re-executes its REAL emission sites
        thousands of times, and those records must neither evict the
        live ring's history nor land in an armed spill.  The live
        ring, spill buffer, watermark and ``total_recorded`` are saved
        and restored; ``seq`` keeps advancing globally (captured rows
        are renumbered by their consumer).  Process-global like
        :func:`~.replay._quiesced` — run captures at sync points
        (bench runs the model check in ``finalize_result``, after
        every section's workload has completed)."""
        saved = (self._ring, self._spill, self._spill_seen, self._total,
                 self.enabled)
        scratch: deque[DecisionRecord] = deque(maxlen=self._cap)
        self._ring = scratch
        self._spill = deque(maxlen=SPILL_MAX)
        self._spill_seen = 0
        self.enabled = True
        try:
            yield scratch
        finally:
            (self._ring, self._spill, self._spill_seen, self._total,
             self.enabled) = saved

    def clear(self) -> None:
        self._ring.clear()
        self._total = 0
        self._spill.clear()
        self._spill_seen = 0
        self._last_spill_t = 0.0
        self._spill_file = None
        self._spill_watermark = 0

    # -- jsonl spill ---------------------------------------------------------
    def spill_path(self) -> str | None:
        """The armed jsonl path (:data:`DECISION_LOG_ENV`; unset OR
        empty = unarmed).  A DIRECTORY (existing, or a value ending in
        a path separator) resolves to ``ck_decisions_<pid>.jsonl``
        inside it — the postmortem pattern: N processes sharing one
        armed environment (a DCN job, bench's benchrig subprocess)
        must each keep their own log, not last-writer-win one file."""
        path = os.environ.get(DECISION_LOG_ENV)
        if not path:
            return None
        if path.endswith(os.sep) or os.path.isdir(path):
            os.makedirs(path, exist_ok=True)
            return os.path.join(path, f"ck_decisions_{os.getpid()}.jsonl")
        return path

    def save_jsonl(self, path: str) -> str:
        """Write the retained decisions (the armed spill buffer when it
        holds more than the ring, else the ring) as one jsonl file via
        tmp+rename: a crash mid-write never leaves a half-replaced log.
        Line 1 is a schema header; each further line is one record."""
        rows = list(self._spill) if len(self._spill) > len(self._ring) \
            else list(self._ring)
        return _write_jsonl(path, rows, dropped=self.spill_dropped,
                            total=self._total)

    def spill(self, path: str | None = None) -> str | None:
        """Persist the spill buffer to the armed file.  The FIRST spill
        to a path (or any explicit ``path`` argument) is a full atomic
        tmp+rename dump; later armed spills APPEND only the rows newer
        than the persisted watermark — one bounded write per sync
        point instead of rewriting the whole history (the loader skips
        a torn tail line by contract), and rows :data:`SPILL_MAX` later
        evicts from memory stay on disk.  Returns the written path, or
        None when unarmed."""
        explicit = path is not None
        path = path or self.spill_path()
        if not path:
            return None
        self._last_spill_t = time.time()
        rows = list(self._spill)
        if explicit or path != self._spill_file \
                or not os.path.exists(path):
            out = _write_jsonl(path, rows, dropped=self.spill_dropped,
                               total=self._total)
        else:
            fresh = [r for r in rows if r.seq > self._spill_watermark]
            if fresh:
                from ..utils.jsonsafe import json_safe

                with open(path, "a") as f:
                    f.write("".join(
                        json.dumps(json_safe(r.to_row()),
                                   allow_nan=False) + "\n"
                        for r in fresh))
            out = path
        if not explicit:
            self._spill_file = path
            if rows:
                self._spill_watermark = max(
                    self._spill_watermark, rows[-1].seq)
        return out

    def maybe_spill(self, now: float | None = None,
                    force: bool = False) -> str | None:
        """Throttled spill for cold sync points (``Cores.barrier``): at
        most one write per :attr:`spill_interval_s` unless ``force``
        (dispose — the last chance to persist the tail)."""
        if not self.spill_path():
            return None
        t = time.time() if now is None else now
        if not force and t - self._last_spill_t < self.spill_interval_s:
            return None
        return self.spill()


def _write_jsonl(path: str, rows: list[DecisionRecord], dropped: int,
                 total: int) -> str:
    from ..utils.jsonsafe import json_safe

    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        header = {
            "schema": SCHEMA, "wrote_at": time.time(),
            "perf_counter_at_dump": time.perf_counter(),
            "rows": len(rows), "total_recorded": total,
            "spill_dropped": dropped,
        }
        f.write(json.dumps(json_safe(header), allow_nan=False) + "\n")
        for r in rows:
            f.write(json.dumps(json_safe(r.to_row()), allow_nan=False) + "\n")
    os.replace(tmp, path)
    return path


#: The process-global log every built-in controller records into.
DECISIONS = DecisionLog()


def load_decision_log(path: str) -> list[DecisionRecord]:
    """Read a jsonl spill (or postmortem-extracted rows) back as
    :class:`DecisionRecord` entries, seq-ordered.  The schema header
    line and torn trailing lines are skipped (the ProfileStore reader
    contract — a log written by a dying process must still replay)."""
    out: list[DecisionRecord] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail line
            if not isinstance(row, dict) or "kind" not in row \
                    or "seq" not in row:
                continue  # the schema header (or foreign junk)
            out.append(DecisionRecord.from_row(row))
    out.sort(key=lambda r: r.seq)
    return out
