"""Decision replay: verify, what-if, and explain over a recorded
decision log (``obs/decisions.py``).

A copy of ``cekirdekler_tpu/obs/replay.py`` kept in the port (which never
imports the JAX package); the text below is the reference's, except that
only the kinds of ported modules are replayed: a row of a replayable kind
whose module is not ported yet is counted apart, by kind, under
``not_ported``, and never as verified.

Three consumers of the same event-sourced record, all offline-capable
(a jsonl spill or a postmortem's decision ring is enough — no live
rig):

- :func:`verify_records` — **replay-verify**: re-execute the PURE
  decision functions (``core.balance.load_balance``,
  ``TransferTuner.choose``/``observe``, ``obs.health.evaluate_window``)
  from each record's inputs and assert **bit-identical** outputs.  A
  recorded log is thereby a golden test of the controllers: hidden
  nondeterminism (a clock or dict-order dependency that crept into the
  balancer) and silent behavior drift (someone retunes ``DAMP_GROW``)
  both surface as a divergence naming the first divergent ``seq``.
  Exact float equality is the contract — JSON round-trips Python floats
  losslessly (``repr`` shortest-round-trip), and the replayed math runs
  the same operations on the same bits.

- :func:`whatif` — **counterfactual runs**: re-run the CHAINED
  load-balance sequence with modified knobs (``damping=…``,
  ``jump_start=off``, ``transfer_floor=off``, ``smoothing=off``),
  carrying ``BalanceState``/history forward.  Because a counterfactual
  split changes the benches the next iteration would have measured, the
  chain runs on the log's implied **per-item rates** (``bench_i /
  range_i`` per recorded step — the balancer's own cost-density model):
  the factual simulation reproduces the recorded trajectory exactly
  while the log lasts, and both runs extend on the final step's rates
  (steady-state assumption) until the split settles or ``horizon``.
  Reported: iterations-to-converge, the final-split L1 distance, and
  chunk-choice deltas when a tuner knob was overridden.

- :func:`explain_balance` — the **causality table** of one split:
  per lane, the raw bench, the transfer floor (bound or slack, with
  margin), the damped move, the quantization residue, and which input
  bound the outcome.  Pure formatting of the record's own outputs (the
  emission site stores shares/effective/cont precisely so nothing here
  re-derives — re-derivation is replay-verify's job, and keeping the
  two separate means explain can never drift from what actually ran).
  ``/decisionz`` serves the same payload live
  (:func:`decisionz_payload`).

Replays run "quiesced": the global DECISIONS/FLIGHT recorders are
disabled around re-execution so replaying a log never re-records it
(and an in-process bench verify cannot pollute the artifact's rings).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

from .decisions import DECISIONS, REPLAYABLE_KINDS, DecisionRecord

__all__ = [
    "verify_records",
    "replay_record",
    "whatif",
    "simulate_balance",
    "explain_balance",
    "explain_latest",
    "explain_rid",
    "convergence_summary",
    "bench_decisions_summary",
    "decisionz_payload",
    "verify_counterexample",
    "save_counterexample",
    "WHATIF_KNOBS",
    "NOT_PORTED_KINDS",
]

#: The what-if knob vocabulary (``ckreplay whatif --set k=v,...``).
#: bool knobs accept on/off; the rest parse as floats.
WHATIF_KNOBS = {
    "damping": "initial/fixed damping (float; adaptive mode re-seeds "
               "per-chip damp at this value)",
    "jump_start": "one-shot undamped warm jump to the rate-implied "
                  "split (on/off)",
    "transfer_floor": "floor each lane's effective time at its "
                      "measured link wall (on/off)",
    "smoothing": "sliding-window share smoothing (on/off)",
    "overhead_ms": "transfer tuner per-chunk overhead (float; replays "
                   "every transfer-choose with this lane overhead)",
    "rate_prior": "prior-seeded first split (on/off; off restarts the "
                  "chain from the equal split, quantifying what the "
                  "device-kind priors saved)",
}

#: Consecutive no-change iterations that close a what-if simulation.
SETTLE = 3


def _rows(records) -> list[dict]:
    """Normalize DecisionRecord / raw-dict input to row dicts, seq
    order."""
    out = []
    for r in records:
        if isinstance(r, DecisionRecord):
            out.append(r.to_row())
        elif isinstance(r, dict) and "kind" in r:
            out.append(r)
    out.sort(key=lambda r: r.get("seq", 0))
    return out


def _retuple(x):
    """JSON round-trips tuples as lists; tuner kernel keys must come
    back hashable and self-consistent (the same canonical form is used
    for state insertion AND the replayed call, so an in-memory tuple
    and a disk-loaded list replay identically)."""
    if isinstance(x, (list, tuple)):
        return tuple(_retuple(v) for v in x)
    return x


_quiesce_mu = threading.Lock()
_quiesce_depth = 0
_quiesce_saved: tuple | None = None


@contextmanager
def _quiesced():
    """Disable the global recorders around a replay: re-executing
    recorded decisions must not re-record them (or emit flight events
    into a live ring mid-bench).

    Depth-counted under a lock so OVERLAPPING replays (two threads, or
    whatif nesting simulate_balance) restore the flags only at the
    outermost exit — an early restore would let the still-running
    inner replay re-record into the live ring.  The quiesce is still
    process-GLOBAL by design (the enabled flags are the hot-path
    attribute reads and must stay lock-free): decisions other live
    threads make DURING a replay window are not recorded, so run
    verify at sync points — bench runs it in ``finalize_result``,
    after every section's workload has completed."""
    global _quiesce_depth, _quiesce_saved
    from .flight import FLIGHT

    with _quiesce_mu:
        _quiesce_depth += 1
        if _quiesce_depth == 1:
            _quiesce_saved = (DECISIONS.enabled, FLIGHT.enabled)
            DECISIONS.enabled = False
            FLIGHT.enabled = False
    try:
        yield
    finally:
        with _quiesce_mu:
            _quiesce_depth -= 1
            if _quiesce_depth == 0 and _quiesce_saved is not None:
                DECISIONS.enabled, FLIGHT.enabled = _quiesce_saved
                _quiesce_saved = None


# ---------------------------------------------------------------------------
# replay-verify
# ---------------------------------------------------------------------------

def _mk_balance_parts(inp):
    """(history, carry, state) reconstructed from a load-balance
    record's entry snapshot — fresh objects, bit-equal state."""
    from ..core import balance as B

    hist = None
    hin = inp.get("history")
    if hin is not None:
        hist = B.BalanceHistory(
            depth=int(hin["depth"]), weighted=bool(hin["weighted"]))
        hist.rows = [[float(v) for v in row] for row in hin["rows"]]
    carry = list(inp["carry"]) if inp.get("carry") is not None else None
    st = None
    sin = inp.get("state")
    if sin is not None:
        st = B.BalanceState(
            cont=[float(x) for x in sin["cont"]],
            prev_delta=[float(x) for x in sin["prev_delta"]],
            damp=[float(x) for x in sin["damp"]],
            jumped=bool(sin["jumped"]), warm=bool(sin["warm"]),
        )
    return hist, carry, st


def _replay_load_balance(inp: dict, out: dict) -> dict:
    from ..core import balance as B

    hist, carry, st = _mk_balance_parts(inp)
    got = B.load_balance(
        [float(b) for b in inp["benchmarks"]],
        [int(r) for r in inp["ranges"]],
        int(inp["total"]), int(inp["step"]), hist,
        damping=float(inp["damping"]), carry=carry, state=st,
        transfer_ms=(None if inp.get("transfer_ms") is None
                     else [float(t) for t in inp["transfer_ms"]]),
        jump_start=bool(inp.get("jump_start", False)),
        cid=inp.get("cid"),
        rate_prior=(None if inp.get("rate_prior") is None
                    else [float(p) for p in inp["rate_prior"]]),
    )
    mism: dict = {}
    exp = [int(x) for x in out.get("ranges", ())]
    if got != exp:
        mism["ranges"] = {"expected": exp, "got": got}
    exp_state = out.get("state_after")
    if st is not None and exp_state is not None:
        got_state = {
            "cont": st.cont, "prev_delta": st.prev_delta, "damp": st.damp,
            "jumped": st.jumped, "warm": st.warm,
        }
        for k, v in got_state.items():
            ev = exp_state.get(k)
            ev = list(ev) if isinstance(ev, list) else ev
            gv = list(v) if isinstance(v, list) else v
            if gv != ev:
                mism[f"state_after.{k}"] = {"expected": ev, "got": gv}
    return mism


def _replay_prior_split(inp: dict, out: dict) -> dict:
    from ..core import balance as B

    got = B.prior_split(
        int(inp["total"]), int(inp["step"]),
        [float(p) for p in inp["priors"]],
        cid=inp.get("cid"),
    )
    exp = [int(x) for x in out.get("ranges", ())]
    if got != exp:
        return {"ranges": {"expected": exp, "got": got}}
    return {}


def _mk_tuner(inp):
    """A fresh TransferTuner carrying exactly the recorded pre-state
    for the record's (lane, key) point."""
    from ..core import stream as S

    t = S.TransferTuner(
        overhead_ms=float(inp.get("default_overhead_ms",
                                  S.PER_CHUNK_OVERHEAD_MS)),
        candidates=tuple(int(c) for c in inp.get(
            "candidates", S.CHUNK_CANDIDATES)),
        ema=float(inp.get("ema", 0.5)),
    )
    lane = int(inp["lane"])
    kk = _retuple(inp["kernel_key"])
    key = (lane, kk, int(inp["bucket"]))
    o = inp.get("obs")
    if o is not None:
        t._obs[key] = S._Obs(
            float(o["u_ms"]), float(o["c_ms"]), float(o["d_ms"]),
            count=int(o.get("count", 1)), stale=int(o.get("stale", 0)))
    s = inp.get("seed")
    if s is not None:
        t._seed[lane] = S._LinkSeed(
            float(s["h2d_ms_per_mib"]), float(s["d2h_ms_per_mib"]))
    t._overhead[lane] = float(inp["overhead_ms"])
    return t, lane, kk, key


def _obs_dict(o) -> dict | None:
    if o is None:
        return None
    return {"u_ms": o.u_ms, "c_ms": o.c_ms, "d_ms": o.d_ms,
            "count": o.count, "stale": o.stale}


def _replay_transfer_choose(inp: dict, out: dict) -> dict:
    t, lane, kk, _key = _mk_tuner(inp)
    got = t.choose(lane, kk, int(inp["nbytes"]), int(inp["max_chunks"]),
                   has_compute=bool(inp.get("has_compute", True)))
    exp = int(out.get("chunks", -1))
    if got != exp:
        return {"chunks": {"expected": exp, "got": got}}
    return {}


def _replay_transfer_observe(inp: dict, out: dict) -> dict:
    t, lane, kk, key = _mk_tuner(inp)
    t.observe(
        lane, kk, int(inp["nbytes"]),
        float(inp["u_ms"]), float(inp["c_ms"]), float(inp["d_ms"]),
        chunks=int(inp.get("chunks", 1)),
        wall_ms=(None if inp.get("wall_ms") is None
                 else float(inp["wall_ms"])),
        fenced=bool(inp.get("fenced", False)),
    )
    if inp.get("obs") is None and int(inp.get("chunks", 1)) > 1:
        got = {"stored": False}
    else:
        got = {
            "stored": True,
            "obs": _obs_dict(t._obs.get(key)),
            "overhead_ms": t._overhead.get(lane, t.overhead_ms),
        }
    mism: dict = {}
    for k, gv in got.items():
        ev = out.get(k)
        if gv != ev:
            mism[k] = {"expected": ev, "got": gv}
    return mism


def _replay_health_verdict(inp: dict, out: dict) -> dict:
    from .health import evaluate_window

    got = evaluate_window(
        float(inp["median_s"]),
        None if inp.get("baseline_s") is None else float(inp["baseline_s"]),
        streak=int(inp["streak"]), degraded=bool(inp["degraded"]),
        threshold=float(inp["threshold"]), confirm=int(inp["confirm"]),
        release=float(inp["release"]),
    )
    got["state"] = ("degraded" if got["degraded"]
                    else "suspect" if got["streak"] > 0 else "ok")
    mism: dict = {}
    for k in ("flagged", "ratio", "streak", "degraded", "state"):
        if got[k] != out.get(k):
            mism[k] = {"expected": out.get(k), "got": got[k]}
    return mism


def _replay_drain(inp: dict, out: dict) -> dict:
    from .drain import drain_transition

    got = drain_transition(
        inp.get("verdicts") or {}, inp.get("states") or {},
        inp.get("hold") or {}, inp.get("clear_streak") or {},
        int(inp.get("hold_barriers", 2)), int(inp.get("confirm_clear", 2)),
        probe_grace=int(inp.get("probe_grace", 2)),
    )
    mism: dict = {}
    for k in ("drained", "readmitted", "probed", "states", "hold",
              "clear_streak"):
        ev = out.get(k)
        ev = list(ev) if isinstance(ev, list) else ev
        gv = got[k]
        if gv != ev:
            mism[k] = {"expected": ev, "got": gv}
    return mism


def _replay_member(inp: dict, out: dict) -> dict:
    """member-leave / member-join: the recorded re-split over the
    post-change step table must re-execute bit-identically (when the
    record carried a total — membership transitions with no known
    workload record only the roster, nothing to re-derive)."""
    from ..cluster.elastic import member_resplit

    mism: dict = {}
    steps = inp.get("steps_after") or []
    total = inp.get("total")
    if total is not None and steps:
        got = member_resplit(steps, int(total))
        for k in ("ranges", "lcm"):
            ev = out.get(k)
            ev = list(ev) if isinstance(ev, list) else ev
            gv = got[k]
            gv = list(gv) if isinstance(gv, list) else gv
            if gv != ev:
                mism[k] = {"expected": ev, "got": gv}
    rec_epoch = out.get("epoch_after")
    got_epoch = int(inp.get("epoch_before", 0)) + 1
    if rec_epoch is not None and rec_epoch != got_epoch:
        # same label convention as ranges/lcm above: "expected" is the
        # RECORDED output, "got" the re-derived value
        mism["epoch_after"] = {"expected": rec_epoch, "got": got_epoch}
    return mism


def _replay_admission(inp: dict, out: dict) -> dict:
    from ..serve.admission import admit_decision

    got = admit_decision(
        tenant_inflight=int(inp["tenant_inflight"]),
        quota=int(inp["quota"]),
        queue_depth=int(inp["queue_depth"]),
        max_queue_depth=int(inp["max_queue_depth"]),
        healthy=bool(inp["healthy"]),
        est_batch_s=float(inp["est_batch_s"]),
        # kernel-verifier inputs arrived with the ckprove gate, the
        # breaker/brownout inputs with the resilience layer; older
        # logs lack them — replay with the pre-gate defaults
        kernel_unsafe=bool(inp.get("kernel_unsafe", False)),
        kernel_finding=inp.get("kernel_finding"),
        breaker_open=bool(inp.get("breaker_open", False)),
        breaker_retry_after_s=inp.get("breaker_retry_after_s"),
        brownout=bool(inp.get("brownout", False)),
        shed_quota=inp.get("shed_quota"),
        priority=int(inp.get("priority", 1)),
    )
    mism: dict = {}
    for k in ("admit", "reason", "retry_after_s"):
        if got.get(k) != out.get(k):
            mism[k] = {"expected": out.get(k), "got": got.get(k)}
    return mism


def _replay_coalesce(inp: dict, out: dict) -> dict:
    from ..serve.coalescer import plan_coalesce

    got = plan_coalesce(
        list(inp.get("groups") or ()), int(inp.get("round", 0)),
        int(inp.get("max_picks") or 0),
    )
    mism: dict = {}
    for k in ("order", "picked", "promoted"):
        gv, ev = list(got.get(k) or ()), list(out.get(k) or ())
        if gv != ev:
            mism[k] = {"expected": ev, "got": gv}
    return mism


def _replay_breaker(inp: dict, out: dict) -> dict:
    """breaker: one circuit-breaker transition or admit
    (serve/resilience.py) — both pure, dispatched on the recorded
    ``op``."""
    from ..serve.resilience import breaker_admit, breaker_transition

    if inp.get("op") == "admit":
        got = breaker_admit(
            inp.get("state") or {}, float(inp["now"]),
            float(inp["open_s"]))
        keys = ("state", "action", "allow", "probe", "retry_after_s")
    else:
        got = breaker_transition(
            inp.get("state") or {}, str(inp["event"]),
            float(inp["now"]), int(inp["threshold"]),
            float(inp["open_s"]))
        keys = ("state", "action")
    mism: dict = {}
    for k in keys:
        if got.get(k) != out.get(k):
            mism[k] = {"expected": out.get(k), "got": got.get(k)}
    return mism


def _replay_shed(inp: dict, out: dict) -> dict:
    from ..serve.resilience import brownout_transition

    got = brownout_transition(
        inp.get("state") or {}, int(inp["queue_depth"]),
        int(inp["watermark"]), int(inp["clear_mark"]),
        int(inp["open_breakers"]), int(inp["drained_lanes"]),
        engage_streak=int(inp.get("engage_streak", 2)))
    mism: dict = {}
    for k in ("active", "streak", "pressure", "changed"):
        if got.get(k) != out.get(k):
            mism[k] = {"expected": out.get(k), "got": got[k]}
    return mism


def _replay_retry(inp: dict, out: dict) -> dict:
    from ..serve.resilience import retry_decision

    got = retry_decision(
        int(inp["attempt"]), int(inp["max_attempts"]),
        float(inp["tokens"]),
        (None if inp.get("deadline_left_s") is None
         else float(inp["deadline_left_s"])),
        float(inp["base_s"]), float(inp["cap_s"]),
        float(inp["jitter_u"]))
    mism: dict = {}
    for k in ("retry", "delay_s", "reason"):
        if got.get(k) != out.get(k):
            mism[k] = {"expected": out.get(k), "got": got.get(k)}
    return mism


def _replay_containment(inp: dict, out: dict) -> dict:
    from ..serve.resilience import containment_plan

    got = containment_plan(int(inp["k"]), leaf=int(inp.get("leaf", 1)))
    mism: dict = {}
    for k in ("mode", "parts"):
        gv = got.get(k)
        ev = out.get(k)
        gv = list(gv) if isinstance(gv, (list, tuple)) else gv
        ev = list(ev) if isinstance(ev, (list, tuple)) else ev
        if gv != ev:
            mism[k] = {"expected": ev, "got": gv}
    return mism


def _replay_route(inp: dict, out: dict) -> dict:
    """route: one shard-placement verdict (serve/fabric.py) — the
    pure consistent-hash + diversion walk re-executed from the
    recorded roster, health view, and epoch."""
    from ..serve.fabric import route_decision

    got = route_decision(
        str(inp.get("tenant", "")), str(inp.get("key", "")),
        list(inp.get("members") or ()),
        tuple(inp.get("unhealthy") or ()),
        int(inp.get("epoch", 0)))
    mism: dict = {}
    for k in ("shard", "owner", "diverted", "hops", "reason", "epoch"):
        if got.get(k) != out.get(k):
            mism[k] = {"expected": out.get(k), "got": got.get(k)}
    return mism


_REPLAYERS = {
    "load-balance": _replay_load_balance,
    "transfer-choose": _replay_transfer_choose,
    "transfer-observe": _replay_transfer_observe,
    "health-verdict": _replay_health_verdict,
    "drain-apply": _replay_drain,
    "readmit": _replay_drain,
    "member-leave": _replay_member,
    "member-join": _replay_member,
    "prior-split": _replay_prior_split,
    "admission": _replay_admission,
    "coalesce": _replay_coalesce,
    "breaker": _replay_breaker,
    "shed": _replay_shed,
    "retry": _replay_retry,
    "containment": _replay_containment,
    "route": _replay_route,
}

#: Replayable kinds whose deciding module is not ported yet (the block
#: tuner's decisions): such a row is counted apart by kind, never
#: verified and never a context row.
NOT_PORTED_KINDS = tuple(k for k in REPLAYABLE_KINDS if k not in _REPLAYERS)
assert set(_REPLAYERS) | set(NOT_PORTED_KINDS) == set(REPLAYABLE_KINDS)


def replay_record(row) -> dict:
    """Re-execute one record.  Returns ``{"seq", "kind", "ok",
    "mismatch"}`` — ``mismatch`` maps field → expected/got on
    divergence; non-replayable kinds come back ``ok: None``
    (context records, skipped by contract); a replayable kind whose
    module is not ported comes back ``ok: False, not_ported: True``."""
    rows = _rows([row])
    if not rows:
        return {"seq": None, "kind": None, "ok": None, "mismatch": None}
    r = rows[0]
    if r["kind"] in NOT_PORTED_KINDS:
        return {"seq": r.get("seq"), "kind": r["kind"], "ok": False,
                "mismatch": None, "not_ported": True}
    fn = _REPLAYERS.get(r["kind"])
    if fn is None:
        return {"seq": r.get("seq"), "kind": r["kind"], "ok": None,
                "mismatch": None}
    with _quiesced():
        mism = fn(r.get("inputs") or {}, r.get("outputs") or {})
    return {"seq": r.get("seq"), "kind": r["kind"], "ok": not mism,
            "mismatch": mism or None}


def verify_records(records, max_divergences: int = 8) -> dict:
    """Replay-verify a whole log (the ``ckreplay verify`` engine and
    bench.py's in-process epilogue pass).

    Returns ``{"ok", "records", "replayed", "skipped", "not_ported",
    "per_kind", "first_divergence", "divergences"}``.  ``ok`` is True
    when every replayable record re-executed bit-identically and none
    was of a kind whose module is not ported (``not_ported`` counts
    those by kind); ``first_divergence`` names the earliest divergent
    seq — the contract the acceptance criterion pins ("an injected knob
    change must fail naming the first divergent seq")."""
    rows = _rows(records)
    per_kind: dict = {}
    not_ported: dict = {}
    divergences: list = []
    replayed = skipped = divergent = 0
    with _quiesced():
        for r in rows:
            kind = r["kind"]
            per_kind[kind] = per_kind.get(kind, 0) + 1
            if kind in NOT_PORTED_KINDS:
                not_ported[kind] = not_ported.get(kind, 0) + 1
                continue
            fn = _REPLAYERS.get(kind)
            if fn is None:
                skipped += 1
                continue
            replayed += 1
            try:
                mism = fn(r.get("inputs") or {}, r.get("outputs") or {})
            except Exception as e:  # noqa: BLE001 - a replay crash IS drift
                mism = {"replay-error": {"expected": "clean re-execution",
                                         "got": f"{type(e).__name__}: {e}"}}
            if mism:
                divergent += 1
                # cap the DETAIL, not the scan: counts cover the whole
                # log either way (a report saying records:500 but
                # replayed:8 would misread as 492 never attempted)
                if len(divergences) < max_divergences:
                    divergences.append({
                        "seq": r.get("seq"), "kind": kind,
                        "mismatch": mism})
    return {
        "ok": not divergent and not not_ported,
        "records": len(rows),
        "replayed": replayed,
        "skipped": skipped,
        "not_ported": not_ported,
        "divergent": divergent,
        "per_kind": per_kind,
        "first_divergence": divergences[0] if divergences else None,
        "divergences": divergences,
        "divergences_truncated": divergent > len(divergences),
    }


# ---------------------------------------------------------------------------
# the counterexample→replay bridge (tools/ckmodel)
# ---------------------------------------------------------------------------

def _counterexample_trace(violation) -> list[dict]:
    """Trace rows from a ckmodel violation (object, ``to_row()`` dict,
    or a bare row list)."""
    if isinstance(violation, (list, tuple)):
        return list(violation)
    trace = getattr(violation, "trace", None)
    if trace is None and isinstance(violation, dict):
        trace = violation.get("trace")
    return list(trace or ())


def verify_counterexample(violation) -> dict:
    """Replay a model-checker counterexample TRACE through the live
    code path — the bridge the bounded model checker
    (``cekirdekler_tpu/analysis/model.py``) emits its violations for.

    Traces are sequences of decision records in the standard row
    schema, so this is :func:`verify_records` with the violation
    unwrapped.  Two uses, both pinned by tests:

    - a counterexample from the REAL controllers (e.g. a true liveness
      violation found on HEAD) replays ``ok: True`` — the trace is a
      faithful execution, and committing it as a fixture pins the
      fixed behavior as a regression test;
    - a counterexample from a deliberately-broken fixture machine
      diverges naming the first seq where the broken outputs part
      from the real functions — the same drill ``ckreplay verify``
      runs on a tampered log."""
    return verify_records(_counterexample_trace(violation))


def save_counterexample(path: str, violation) -> str:
    """Spill one counterexample as a ``ck-decision-log-v1`` jsonl (the
    decision log's own format, tmp+rename): ``ckreplay verify <path>``
    re-executes it and ``ckreplay explain <path>`` renders the
    causality table of a balance trace — no ckmodel-specific reader
    anywhere downstream."""
    from .decisions import DecisionRecord, _write_jsonl

    rows = [DecisionRecord.from_row(r)
            for r in _counterexample_trace(violation)]
    return _write_jsonl(path, rows, dropped=0, total=len(rows))


# ---------------------------------------------------------------------------
# what-if: chained counterfactual runs
# ---------------------------------------------------------------------------

def _balance_rows(rows: list[dict], cid=None) -> list[dict]:
    recs = [r for r in rows if r["kind"] == "load-balance"]
    if cid is None and recs:
        cid = recs[0]["inputs"].get("cid")
    return [r for r in recs if r["inputs"].get("cid") == cid], cid


def simulate_balance(recs: list[dict], overrides: dict | None = None,
                     horizon: int = 200) -> dict:
    """Run the chained balancer sequence under ``overrides`` (empty =
    the factual run) on the log's implied per-item rates; see the
    module docstring for why rates, not raw benches, drive the chain.
    Pure and deterministic — the simulation itself records nothing."""
    from ..core import balance as B

    overrides = overrides or {}
    first = recs[0]["inputs"]
    n = len(first["ranges"])
    step = int(first["step"])
    total = int(first["total"])

    def rates_of(inp, values):
        if values is None:
            return None
        return [float(values[i]) / max(int(inp["ranges"][i]), step)
                for i in range(n)]

    rate_seq = [rates_of(r["inputs"], r["inputs"]["benchmarks"])
                for r in recs]
    trate_seq = [rates_of(r["inputs"], r["inputs"].get("transfer_ms"))
                 for r in recs]

    damping = float(overrides.get("damping", first["damping"]))
    jump = bool(overrides.get("jump_start", first.get("jump_start", False)))
    floor_on = bool(overrides.get("transfer_floor", True))
    smooth_on = bool(overrides.get(
        "smoothing", first.get("history") is not None))
    hist = None
    if smooth_on:
        hin = first.get("history") or {
            "depth": B.HISTORY_DEPTH, "weighted": True, "rows": []}
        hist = B.BalanceHistory(
            depth=int(hin["depth"]), weighted=bool(hin["weighted"]))
        hist.rows = [[float(v) for v in row] for row in hin["rows"]]
    state = carry = None
    sin = first.get("state")
    if sin is not None:
        state = B.BalanceState(
            cont=[float(x) for x in sin["cont"]],
            prev_delta=[float(x) for x in sin["prev_delta"]],
            damp=([damping] * n if "damping" in overrides
                  else [float(x) for x in sin["damp"]]),
            jumped=bool(sin["jumped"]), warm=bool(sin["warm"]),
        )
    elif first.get("carry") is not None:
        carry = list(first["carry"])

    # the prior's entire effect is the chain's STARTING ranges (the
    # recorded first split is the prior-seeded one when the log carries
    # a rate_prior input) — so the off-counterfactual restarts the
    # chain from the equal split with fresh continuous state, exactly
    # the equal-split first window
    prior_on = bool(overrides.get("rate_prior", True))
    if prior_on:
        ranges = [int(r) for r in first["ranges"]]
    else:
        ranges = B.equal_split(total, n, step)
        if state is not None:
            state.reset(ranges, damping)
        elif carry is not None:
            carry = None
    trajectory = [list(ranges)]
    last_change = 0
    it = 0
    # settle patience: a damped system behind a depth-N share smoother
    # can hold still for up to ~N iterations while the window absorbs a
    # rate-regime shift (the steady-tail extension IS such a shift when
    # the last recorded step's rates differ from the early ones) — a
    # bare SETTLE would declare "converged" mid-absorption and
    # understate iterations-to-converge for exactly the counterfactuals
    # this simulator exists for
    settle = SETTLE + (hist.depth if hist is not None else 0)
    with _quiesced():
        for it in range(1, max(int(horizon), len(recs)) + 1):
            k = min(it - 1, len(recs) - 1)
            bench = [rate_seq[k][i] * max(ranges[i], step)
                     for i in range(n)]
            tr = None
            if floor_on and trate_seq[k] is not None:
                tr = [trate_seq[k][i] * max(ranges[i], step)
                      for i in range(n)]
            new = B.load_balance(
                bench, list(ranges), total, step, hist,
                damping=damping, carry=carry, state=state,
                transfer_ms=tr, jump_start=jump, cid=first.get("cid"),
            )
            if new != ranges:
                last_change = it
            ranges = new
            trajectory.append(list(ranges))
            if it >= len(recs) and it - last_change >= settle:
                break
    return {
        "iterations_to_converge": last_change,
        "converged": it - last_change >= settle,
        "simulated_iterations": it,
        "final_ranges": list(ranges),
        "trajectory": trajectory,
    }


def whatif(records, overrides: dict, cid=None, horizon: int = 200) -> dict:
    """The counterfactual report (``ckreplay whatif --set k=v,...``):
    factual vs overridden chained runs for one compute id, plus
    chunk-choice deltas when ``overhead_ms`` was overridden."""
    rows = _rows(records)
    recs, cid = _balance_rows(rows, cid)
    out: dict = {"cid": cid, "overrides": dict(overrides),
                 "recorded_steps": len(recs)}
    unknown = set(overrides) - set(WHATIF_KNOBS)
    if unknown:
        raise ValueError(
            f"unknown what-if knob(s) {sorted(unknown)}; "
            f"knobs: {sorted(WHATIF_KNOBS)}")
    if recs:
        balance_overrides = {
            k: v for k, v in overrides.items()
            if k != "overhead_ms"}
        factual = simulate_balance(recs, {}, horizon)
        counter = simulate_balance(recs, balance_overrides, horizon)
        l1 = None
        if len(factual["final_ranges"]) == len(counter["final_ranges"]):
            l1 = sum(abs(a - b) for a, b in zip(
                factual["final_ranges"], counter["final_ranges"]))
        out.update({
            "factual": factual,
            "counterfactual": counter,
            "final_split_l1": l1,
        })
    if "overhead_ms" in overrides:
        choices = []
        ov = float(overrides["overhead_ms"])
        with _quiesced():
            for r in rows:
                if r["kind"] != "transfer-choose":
                    continue
                inp = r["inputs"]
                t, lane, kk, _key = _mk_tuner(inp)
                t._overhead[lane] = ov
                got = t.choose(
                    lane, kk, int(inp["nbytes"]), int(inp["max_chunks"]),
                    has_compute=bool(inp.get("has_compute", True)))
                choices.append({
                    "seq": r.get("seq"), "lane": lane,
                    "factual": r["outputs"].get("chunks"),
                    "counterfactual": got,
                })
        out["chunk_choices"] = choices
        out["chunk_choices_changed"] = sum(
            1 for c in choices if c["factual"] != c["counterfactual"])
    return out


# ---------------------------------------------------------------------------
# explain: the causality table
# ---------------------------------------------------------------------------

def explain_balance(row) -> dict:
    """Per-lane causality table of one recorded split — pure formatting
    of the record's stored outputs (nothing is re-derived; see module
    docstring)."""
    rows = _rows([row])
    if not rows or rows[0]["kind"] != "load-balance":
        raise ValueError("explain_balance wants a load-balance record")
    r = rows[0]
    inp, out = r["inputs"], r["outputs"]
    n = len(inp["ranges"])
    action = out.get("action", "?")
    sin = inp.get("state")
    if sin is not None and len(sin.get("cont") or ()) == n:
        base = [float(x) for x in sin["cont"]]
    elif inp.get("carry"):
        base = [float(x) for x in inp["carry"]]
    else:
        base = [float(x) for x in inp["ranges"]]
    transfer = inp.get("transfer_ms")
    shares = out.get("shares") or [None] * n
    eff = out.get("effective_ms") or [None] * n
    fb = out.get("floor_bound") or [False] * n
    cont = out.get("cont") or [None] * n
    damp = (out.get("state_after") or {}).get("damp") or [None] * n
    lanes = []
    for i in range(n):
        bench = float(inp["benchmarks"][i])
        tms = None if transfer is None else float(transfer[i])
        if action == "freeze":
            binding = "quantization floor (split held)"
        elif action == "jump":
            binding = "rate-implied target (undamped jump)"
        elif fb[i]:
            binding = "transfer floor (link-bound)"
        else:
            binding = "compute bench (damped)"
        lanes.append({
            "lane": i,
            "bench_ms": bench,
            "transfer_ms": tms,
            # + margin = the floor BINDS by this much; − = slack under
            # the compute bench
            "floor_margin_ms": None if tms is None else tms - bench,
            "floor_bound": bool(fb[i]),
            "effective_ms": eff[i],
            "share": shares[i],
            "target_items": (None if shares[i] is None
                             else inp["total"] * shares[i]),
            "base_items": base[i],
            "damp": damp[i],
            "damped_move_items": (None if cont[i] is None
                                  else cont[i] - base[i]),
            "cont_items": cont[i],
            "range_items": int(out["ranges"][i]),
            "quantization_residue_items": (
                None if cont[i] is None else cont[i] - out["ranges"][i]),
            "binding": binding,
        })
    doc = {
        "seq": r.get("seq"), "cid": inp.get("cid"), "action": action,
        "total": inp["total"], "step": inp["step"],
        "jump_start": inp.get("jump_start"),
        "jump_armed": out.get("jump_armed"),
        "lanes": lanes,
    }
    if out.get("freeze") is not None:
        doc["freeze"] = out["freeze"]
    return doc


def explain_latest(records, cid=None) -> dict | None:
    """The latest split's causality table (``ckreplay explain`` /
    ``/decisionz``), optionally filtered to one compute id."""
    rows = _rows(records)
    recs, _cid = _balance_rows(rows, cid)
    if not recs:
        return None
    return explain_balance(recs[-1])


def _mentions_rid(inp: dict, rid: str) -> bool:
    """Does a decision record's input snapshot name this request?  The
    rid rides three shapes: a scalar ``rid`` (admission, retry, route),
    a flat ``rids`` list (containment), and per-group ``rids`` inside a
    coalesce record's ``groups`` rows."""
    if inp.get("rid") == rid:
        return True
    if rid in (inp.get("rids") or ()):
        return True
    for g in inp.get("groups") or ():
        if isinstance(g, dict) and rid in (g.get("rids") or ()):
            return True
    return False


def explain_rid(records, rid: str) -> dict:
    """One request's decision history (``ckreplay explain --rid <id>``):
    every recorded controller decision whose INPUTS named this rid —
    the admission verdict, the coalesce wave(s) that grouped it, any
    containment/retry it rode, and the fabric route/re-route hops — in
    seq order.  Pure filtering of the records' own inputs/outputs
    (nothing re-derived; re-derivation is replay-verify's job).  The
    rid is a decision INPUT, so this is the causal complement of the
    reqtrace timeline: ``fold_phases`` says WHERE the milliseconds
    went, this says WHICH verdicts routed them there.  Decisions
    recorded while the log was disabled (or by a pre-rid build) carry
    no rid and simply do not appear."""
    rid = str(rid)
    steps: list = []
    kinds: dict = {}
    for r in _rows(records):
        inp = r.get("inputs") or {}
        if not _mentions_rid(inp, rid):
            continue
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
        steps.append({
            "seq": r.get("seq"), "t": r.get("t"), "kind": r["kind"],
            "inputs": inp, "outputs": r.get("outputs") or {},
        })
    return {"rid": rid, "decisions": len(steps), "kinds": kinds,
            "steps": steps}


# ---------------------------------------------------------------------------
# summaries (bench artifact + /decisionz)
# ---------------------------------------------------------------------------

def convergence_summary(records) -> dict:
    """Per-cid convergence view of the recorded rebalance sequences:
    how many iterations until the split last moved, and whether it
    ended settled (froze, or stopped changing)."""
    rows = _rows(records)
    per_cid: dict = {}
    for r in rows:
        if r["kind"] != "load-balance":
            continue
        per_cid.setdefault(r["inputs"].get("cid"), []).append(r)
    out: dict = {}
    for cid, recs in per_cid.items():
        changes = 0
        last_change = 0
        prev = None
        for i, r in enumerate(recs, start=1):
            ranges = list(r["outputs"].get("ranges", ()))
            if prev is not None and ranges != prev:
                changes += 1
                last_change = i
            prev = ranges
        last = recs[-1]["outputs"]
        out[str(cid)] = {
            "rebalances": len(recs),
            "moves": changes,
            "iterations_to_converge": last_change,
            "settled": (last.get("action") == "freeze"
                        or last_change < len(recs)),
            "jumped": any(r["outputs"].get("action") == "jump"
                          for r in recs),
            "final_ranges": list(last.get("ranges", ())),
        }
    return out


def bench_decisions_summary(records=None) -> dict:
    """The bench artifact's ``decisions`` block: per-kind counts, the
    per-cid convergence view, and the in-process replay-verify verdict
    (``replay_ok`` — ``tools/regress.py`` hard-fails an artifact that
    carries ``false``: behavior drift in the balancer becomes a
    sentinel failure, not a silent perf mystery)."""
    rows = _rows(records if records is not None else DECISIONS.snapshot())
    counts: dict = {}
    for r in rows:
        counts[r["kind"]] = counts.get(r["kind"], 0) + 1
    verdict = verify_records(rows)
    return {
        "counts": counts,
        "total_recorded": DECISIONS.total_recorded,
        "rebalances": counts.get("load-balance", 0),
        "convergence": convergence_summary(rows),
        "replay_ok": verdict["ok"],
        "replay": {
            "replayed": verdict["replayed"],
            "skipped": verdict["skipped"],
            "not_ported": verdict["not_ported"],
            "first_divergence": verdict["first_divergence"],
        },
    }


def decisionz_payload(recent: int = 64) -> dict:
    """The ``/decisionz`` debug-endpoint body: ring state, per-kind
    counts, the most recent records, and the latest split's causality
    table per compute id (the live ``explain`` plane)."""
    rows = [r.to_row() for r in DECISIONS.snapshot()]
    counts: dict = {}
    latest_lb: dict = {}
    for r in rows:
        counts[r["kind"]] = counts.get(r["kind"], 0) + 1
        if r["kind"] == "load-balance":
            latest_lb[r["inputs"].get("cid")] = r
    explain = {}
    for cid, r in latest_lb.items():
        try:
            explain[str(cid)] = explain_balance(r)
        except Exception as e:  # noqa: BLE001 - one bad record, not a 500
            explain[str(cid)] = {"error": f"{type(e).__name__}: {e}"}
    return {
        "enabled": DECISIONS.enabled,
        "capacity": DECISIONS.capacity,
        "total_recorded": DECISIONS.total_recorded,
        "spill_path": DECISIONS.spill_path(),
        "spill_dropped": DECISIONS.spill_dropped,
        "counts": counts,
        "recent": rows[-max(1, int(recent)):],
        "shown": min(len(rows), max(1, int(recent))),
        "explain": explain,
    }
