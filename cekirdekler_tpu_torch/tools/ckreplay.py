#!/usr/bin/env python
"""ckreplay: verify / what-if / explain over a recorded decision log.

The port's copy of the reference's ``tools/ckreplay.py``, over the port's
decision log and replay (``cekirdekler_tpu_torch/obs/``), with the
reference's exit codes.  A row of a replayable kind whose module is not
ported yet is listed by kind and never counted as verified: ``verify``
exits 0 only when every replayable row was replayed and matched.  The
``block_grid`` what-if knob comes with the block tuner.  The text below
is the reference's.

The runtime event-sources every controller decision
(``cekirdekler_tpu/obs/decisions.py``): one record per ``load_balance``
iteration, transfer-tuner choice/observation, fused engage/disengage,
health verdict flip — each with the COMPLETE inputs the decision was
made from.  This tool consumes a spilled jsonl log (``CK_DECISION_LOG``,
``DECISIONS.save_jsonl``) or a ``ck-postmortem-v2`` black box:

- ``verify`` re-executes the pure decision functions from the recorded
  inputs and asserts **bit-identical** outputs.  Exit 0: the log
  replays clean (recorded logs are golden tests of the controllers).
  Exit 1: drift — the report names the FIRST divergent seq, which is
  exactly what you want when someone edits the balancer and an old
  log stops reproducing.
- ``whatif --set damping=0.1,jump_start=off,transfer_floor=off``
  re-runs the CHAINED load-balance sequence with modified knobs,
  carrying balancer state forward on the log's implied per-item rates,
  and reports the counterfactual convergence trajectory
  (iterations-to-converge, final-split L1 distance; chunk-choice
  deltas when ``overhead_ms`` is overridden).  E.g. ``jump_start=off``
  on a jump-started log demonstrates the damped crawl returning.
- ``explain`` renders the latest split's per-lane causality table —
  raw bench, transfer floor (bound or slack, with margin), damped
  move, quantization residue, and which input bound the outcome.
  The live equivalent is the debug server's ``/decisionz``.
  ``explain --rid <id>`` pivots to ONE request: every recorded
  controller decision whose inputs named that rid (admission verdict,
  coalesce wave, containment/retry, fabric route/re-route hops) in
  seq order — the decision-side complement of the ``/reqz`` phase
  timeline for the same rid.
- ``demo --out log.jsonl`` records a synthetic multi-lane convergence
  (skewed lanes, a transfer-floor-bound lane, a jump-start) — the
  generator behind ``tests/fixtures_decisions/`` and the quickest way
  to try the three verbs without a rig.

Usage::

    python -m cekirdekler_tpu_torch.tools.ckreplay verify run.jsonl
    python -m cekirdekler_tpu_torch.tools.ckreplay whatif run.jsonl --set jump_start=off
    python -m cekirdekler_tpu_torch.tools.ckreplay explain run.jsonl [--cid 901] [--json]
    python -m cekirdekler_tpu_torch.tools.ckreplay explain run.jsonl --rid r3f2a-1c
    python -m cekirdekler_tpu_torch.tools.ckreplay demo --out demo.jsonl
"""

from __future__ import annotations

import argparse
import json
import sys

__all__ = ["main", "load_records", "parse_overrides", "demo_log"]


def load_records(path: str):
    """Rows from a jsonl spill or a postmortem JSON (the v2 black box
    carries its decision ring under ``"decisions"``; v1 yields [])."""
    from cekirdekler_tpu_torch.obs.decisions import (
        DecisionRecord,
        load_decision_log,
    )

    with open(path) as f:
        head = f.read(1)
        f.seek(0)
        if head == "{":
            try:
                doc = json.load(f)
            except json.JSONDecodeError:
                doc = None
            if isinstance(doc, dict) and "decisions" in doc:
                rows = [DecisionRecord.from_row(r)
                        for r in doc.get("decisions") or []
                        if isinstance(r, dict) and "kind" in r]
                rows.sort(key=lambda r: r.seq)
                return rows
    return load_decision_log(path)


#: Per-knob value types: coercion is by KNOB, not by value shape —
#: `overhead_ms=off` must be rejected, not silently become 0.0, and
#: `jump_start=0.3` must not float-parse into truthy-on.
_BOOL_KNOBS = frozenset(("jump_start", "transfer_floor", "smoothing",
                         "rate_prior"))
_FLOAT_KNOBS = frozenset(("damping", "overhead_ms"))

def parse_overrides(spec: str) -> dict:
    """``damping=0.1,jump_start=off,...`` → typed override dict."""
    from cekirdekler_tpu_torch.obs.replay import WHATIF_KNOBS

    out: dict = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise SystemExit(
                f"ckreplay: bad --set entry {part!r} (want k=v); "
                f"knobs: {', '.join(sorted(WHATIF_KNOBS))}")
        k, v = part.split("=", 1)
        k = k.strip()
        v = v.strip().lower()
        if k not in WHATIF_KNOBS:
            raise SystemExit(
                f"ckreplay: unknown knob {k!r}; "
                f"knobs: {', '.join(sorted(WHATIF_KNOBS))}")
        if k in _BOOL_KNOBS:
            if v in ("on", "true", "yes", "1"):
                out[k] = True
            elif v in ("off", "false", "no", "0"):
                out[k] = False
            else:
                raise SystemExit(
                    f"ckreplay: bad value {v!r} for on/off knob {k!r}")
        else:
            assert k in _FLOAT_KNOBS, k  # WHATIF_KNOBS is the union
            try:
                out[k] = float(v)
            except ValueError:
                raise SystemExit(
                    f"ckreplay: bad value {v!r} for knob {k!r}")
    return out


def demo_log(path: str, lanes: int = 3, steps: int = 12,
             total: int = 8192, step: int = 64) -> str:
    """Record a synthetic multi-lane convergence: unequal per-item
    rates, one lane whose LINK wall exceeds its compute bench (the
    transfer floor binds), adaptive damping + jump-start.  Every
    iteration runs the REAL ``load_balance``, so the resulting log
    replay-verifies by construction."""
    from cekirdekler_tpu_torch.core.balance import (
        BalanceHistory,
        BalanceState,
        equal_split,
        load_balance,
    )
    from cekirdekler_tpu_torch.obs.decisions import DecisionLog, DECISIONS
    import cekirdekler_tpu_torch.obs.decisions as _dmod

    # a fresh log so the demo file holds exactly this sequence
    log = DecisionLog()
    saved = DECISIONS
    _dmod.DECISIONS = log
    # the emitters imported DECISIONS by value — patch their refs too
    import cekirdekler_tpu_torch.core.balance as _bal

    bal_saved = _bal.DECISIONS
    _bal.DECISIONS = log
    try:
        # per-item compute rates (ms/item): lane 0 fast, lane 1 slow,
        # lane 2 fast compute but a link 3x its compute wall — the
        # transfer floor must bind there
        rates = [0.0010, 0.0040, 0.0008][:lanes]
        t_rates = [0.0002, 0.0002, 0.0030][:lanes]
        while len(rates) < lanes:
            rates.append(0.0015)
            t_rates.append(0.0002)

        def chain(cid, jump):
            ranges = equal_split(total, lanes, step)
            hist = BalanceHistory(weighted=True)
            state = BalanceState()
            for _ in range(steps):
                bench = [rates[i] * max(ranges[i], step)
                         for i in range(lanes)]
                transfer = [t_rates[i] * max(ranges[i], step)
                            for i in range(lanes)]
                ranges = load_balance(
                    bench, ranges, total, step, hist, state=state,
                    transfer_ms=transfer, jump_start=jump, cid=cid,
                )

        # cid 0: the jump-started fast path (converges in ~2, freezes);
        # cid 1: the damped crawl (jump off) — this chain EXERCISES the
        # adaptive-damping constants (DAMP_GROW/DECAY/...), so a log
        # from here diverges under replay when someone retunes them
        chain(0, jump=True)
        chain(1, jump=False)
        return log.save_jsonl(path)
    finally:
        _dmod.DECISIONS = saved
        _bal.DECISIONS = bal_saved


def demo_hetero_log(path: str, total: int = 8192, step: int = 64,
                    steps: int = 10, skew: float = 100.0) -> str:
    """Record a prior-seeded heterogeneous chain: 1 fast + 1 slow lane
    (``skew``x apart, the TPU-vs-host-CPU shape), first split from
    ``prior_split`` with rate-true priors, every iteration the REAL
    ``load_balance`` with the priors on the record.  This is the
    ``tests/fixtures_decisions/golden_hetero_prior.jsonl`` generator:
    the log replay-verifies by construction, and ``ckreplay whatif
    --set rate_prior=off`` on it quantifies what the seed saved."""
    from cekirdekler_tpu_torch.core.balance import (
        BalanceHistory,
        BalanceState,
        load_balance,
        prior_split,
    )
    from cekirdekler_tpu_torch.obs.decisions import DecisionLog
    import cekirdekler_tpu_torch.obs.decisions as _dmod
    import cekirdekler_tpu_torch.core.balance as _bal

    log = DecisionLog()
    saved = _dmod.DECISIONS
    _dmod.DECISIONS = log
    bal_saved = _bal.DECISIONS
    _bal.DECISIONS = log
    try:
        # per-item compute rates (ms/item): lane 1 is `skew`x slower —
        # the prior is rate-TRUE (throughput ∝ 1/rate), the ideal-seed
        # case the prior-seeded-jump-within-one-step invariant pins
        rates = [0.001, 0.001 * skew]
        priors = [1.0 / r for r in rates]
        ranges = prior_split(total, step, priors, cid=0)
        hist = BalanceHistory(weighted=True)
        state = BalanceState()
        for _ in range(steps):
            bench = [rates[i] * max(ranges[i], step)
                     for i in range(len(ranges))]
            ranges = load_balance(
                bench, ranges, total, step, hist, state=state,
                jump_start=True, cid=0, rate_prior=priors,
            )
        return log.save_jsonl(path)
    finally:
        _dmod.DECISIONS = saved
        _bal.DECISIONS = bal_saved


def _fmt(v, nd=3):
    if v is None:
        return "-"
    if isinstance(v, bool):
        return "yes" if v else "no"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def render_explain_rid(doc: dict) -> str:
    """One request's decision history as plain text (one line per
    recorded decision, most informative output fields per kind)."""
    kinds = ", ".join(f"{k}={n}" for k, n in sorted(doc["kinds"].items()))
    lines = [f"request {doc['rid']}: {doc['decisions']} recorded "
             f"decision(s){' (' + kinds + ')' if kinds else ''}"]
    for s in doc["steps"]:
        out, kind = s["outputs"], s["kind"]
        if kind == "admission":
            detail = (f"admit={_fmt(out.get('admit'))} "
                      f"reason={out.get('reason')}")
        elif kind == "coalesce":
            detail = (f"picked={out.get('picked')} "
                      f"promoted={out.get('promoted')}")
        elif kind == "route":
            detail = (f"shard={out.get('shard')} owner={out.get('owner')} "
                      f"diverted={_fmt(out.get('diverted'))} "
                      f"hops={out.get('hops')}")
        elif kind == "retry":
            detail = (f"retry={_fmt(out.get('retry'))} "
                      f"delay_s={_fmt(out.get('delay_s'))} "
                      f"reason={out.get('reason')} "
                      f"cause={s['inputs'].get('cause')}")
        elif kind == "containment":
            detail = (f"mode={out.get('mode')} "
                      f"cause={s['inputs'].get('cause')}")
        else:
            detail = " ".join(
                f"{k}={_fmt(v)}" for k, v in list(out.items())[:4])
        lines.append(f"  seq={s['seq']} {kind}: {detail}")
    return "\n".join(lines)


def render_explain(doc: dict) -> str:
    """The causality table as plain text (one row per lane)."""
    head = (f"split seq={doc.get('seq')} cid={doc.get('cid')} "
            f"action={doc.get('action')} total={doc.get('total')} "
            f"step={doc.get('step')}")
    cols = [
        ("lane", "lane"), ("bench_ms", "bench_ms"),
        ("transfer_ms", "xfer_ms"), ("floor_margin_ms", "floor_margin"),
        ("effective_ms", "eff_ms"), ("share", "share"),
        ("damp", "damp"), ("damped_move_items", "move"),
        ("cont_items", "cont"), ("range_items", "range"),
        ("quantization_residue_items", "residue"), ("binding", "binding"),
    ]
    rows = [[_fmt(lane.get(k)) for k, _h in cols]
            for lane in doc.get("lanes", ())]
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, (_k, h) in enumerate(cols)]
    lines = [head]
    if doc.get("freeze"):
        fz = doc["freeze"]
        # the margin as RECORDED (what this freeze compared against);
        # pre-margin logs fall back to naming the constant
        margin = fz.get("margin")
        margin_s = _fmt(margin, 2) if margin is not None else "FREEZE_MARGIN"
        lines.append(
            "  held: busiest lane "
            f"{fz.get('lane')} excess {_fmt(fz.get('excess_ms'))} ms < "
            f"{margin_s} x one-step work "
            f"{_fmt(fz.get('one_step_work_ms'))} ms")
    lines.append("  ".join(
        h.rjust(widths[i]) for i, (_k, h) in enumerate(cols)))
    for r in rows:
        lines.append("  ".join(c.rjust(widths[i]) for i, c in enumerate(r)))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cekirdekler_tpu_torch.tools.ckreplay",
        description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_v = sub.add_parser("verify", help="replay-verify a log bit-identically")
    p_v.add_argument("log", help="decision jsonl (or ck-postmortem-v2 JSON)")
    p_v.add_argument("--json", action="store_true")

    p_w = sub.add_parser("whatif", help="counterfactual chained re-run")
    p_w.add_argument("log")
    p_w.add_argument("--set", dest="overrides", required=True,
                     help="knobs, e.g. damping=0.1,jump_start=off,"
                          "transfer_floor=off,smoothing=off,overhead_ms=2")
    p_w.add_argument("--cid", type=int, default=None,
                     help="compute id to chain (default: the first logged)")
    p_w.add_argument("--horizon", type=int, default=200,
                     help="max simulated iterations (default 200)")
    p_w.add_argument("--json", action="store_true")

    p_e = sub.add_parser("explain", help="latest split's causality table "
                                         "(--rid: one request's history)")
    p_e.add_argument("log")
    p_e.add_argument("--cid", type=int, default=None)
    p_e.add_argument("--rid", default=None,
                     help="pivot to one request id: every decision whose "
                          "inputs named this rid, in seq order")
    p_e.add_argument("--json", action="store_true")

    p_d = sub.add_parser("demo", help="record a synthetic convergence log")
    p_d.add_argument("--out", required=True)
    p_d.add_argument("--lanes", type=int, default=3)
    p_d.add_argument("--steps", type=int, default=12)
    p_d.add_argument("--hetero", action="store_true",
                     help="prior-seeded 1 fast + 1 slow (100x) chain "
                          "instead (the golden_hetero_prior generator)")

    args = ap.parse_args(argv)

    if args.cmd == "demo":
        if args.hetero:
            path = demo_hetero_log(args.out, steps=args.steps)
        else:
            path = demo_log(args.out, lanes=args.lanes, steps=args.steps)
        print(f"ckreplay: demo log written to {path}")
        return 0

    records = load_records(args.log)
    if not records:
        print(f"ckreplay: no decision records in {args.log} — arm "
              "CK_DECISION_LOG on the run (or pass a ck-postmortem-v2 "
              "dump), or generate one with `python -m cekirdekler_tpu_torch.tools.ckreplay "
              "demo`", file=sys.stderr)
        return 1

    if args.cmd == "verify":
        from cekirdekler_tpu_torch.obs.replay import verify_records

        verdict = verify_records(records)
        if args.json:
            print(json.dumps(verdict, indent=2, allow_nan=False,
                             default=str))
            return 0 if verdict["ok"] else 1
        kinds = ", ".join(f"{k}={n}" for k, n in
                          sorted(verdict["per_kind"].items()))
        if verdict["not_ported"] and not verdict["divergent"]:
            missing = ", ".join(f"{k}={n}" for k, n in
                                sorted(verdict["not_ported"].items()))
            print(f"ckreplay verify NOT VERIFIED: {verdict['replayed']} "
                  f"replayed bit-identically, rows of kinds whose module "
                  f"is not ported yet: {missing} ({kinds})")
            return 1
        if verdict["ok"]:
            print(f"ckreplay verify OK: {verdict['replayed']} replayed "
                  f"bit-identically, {verdict['skipped']} context records "
                  f"skipped ({kinds})")
            return 0
        first = verdict["first_divergence"]
        print(f"ckreplay verify FAIL: first divergent seq="
              f"{first['seq']} kind={first['kind']}")
        for field, d in (first.get("mismatch") or {}).items():
            print(f"  {field}: expected {d.get('expected')!r} "
                  f"got {d.get('got')!r}")
        more = verdict["divergent"] - 1
        if more > 0:
            print(f"  (+{more} further divergent record(s) of "
                  f"{verdict['replayed']} replayed)")
        print("  a divergence means the decision code no longer "
              "reproduces this log: a knob/algorithm change, or hidden "
              "nondeterminism")
        if verdict["not_ported"]:
            print("  not ported (not verified): " + ", ".join(
                f"{k}={n}" for k, n in sorted(verdict["not_ported"].items())))
        return 1

    if args.cmd == "whatif":
        from cekirdekler_tpu_torch.obs.replay import whatif

        overrides = parse_overrides(args.overrides)
        if not overrides:
            raise SystemExit("ckreplay: --set parsed to no overrides")
        rep = whatif(records, overrides, cid=args.cid,
                     horizon=args.horizon)
        if args.json:
            print(json.dumps(rep, indent=2, allow_nan=False, default=str))
            return 0
        print(f"ckreplay whatif cid={rep.get('cid')} overrides="
              f"{rep.get('overrides')} "
              f"(chained over {rep.get('recorded_steps')} recorded steps)")
        f, c = rep.get("factual"), rep.get("counterfactual")
        if f and c:
            print(f"  factual:        converge@{f['iterations_to_converge']}"
                  f" (settled={f['converged']}) final={f['final_ranges']}")
            print(f"  counterfactual: converge@{c['iterations_to_converge']}"
                  f" (settled={c['converged']}) final={c['final_ranges']}")
            print(f"  final-split L1 distance: {rep.get('final_split_l1')} "
                  "items")
            d = (c["iterations_to_converge"] - f["iterations_to_converge"])
            if d > 0:
                print(f"  -> counterfactual converges {d} iteration(s) "
                      "LATER")
            elif d < 0:
                print(f"  -> counterfactual converges {-d} iteration(s) "
                      "EARLIER")
        if "chunk_choices" in rep:
            print(f"  chunk choices: {rep['chunk_choices_changed']} of "
                  f"{len(rep['chunk_choices'])} transfer-choose decisions "
                  "changed")
            for ch in rep["chunk_choices"]:
                if ch["factual"] != ch["counterfactual"]:
                    print(f"    seq={ch['seq']} lane={ch['lane']}: "
                          f"{ch['factual']} -> {ch['counterfactual']}")
        return 0

    if args.cmd == "explain":
        from cekirdekler_tpu_torch.obs.replay import explain_latest, explain_rid

        if args.rid is not None:
            doc = explain_rid(records, args.rid)
            if not doc["decisions"]:
                print(f"ckreplay: no decision in this log names rid "
                      f"{args.rid!r} (rid-bearing records need the "
                      "decision log armed while the request ran)",
                      file=sys.stderr)
                return 1
            if args.json:
                print(json.dumps(doc, indent=2, allow_nan=False,
                                 default=str))
            else:
                print(render_explain_rid(doc))
            return 0
        doc = explain_latest(records, cid=args.cid)
        if doc is None:
            print("ckreplay: no load-balance records "
                  f"{'for cid ' + str(args.cid) if args.cid is not None else ''}"
                  " in this log", file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(doc, indent=2, allow_nan=False, default=str))
        else:
            print(render_explain(doc))
        return 0

    return 2  # unreachable: subparsers are required


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # `ckreplay ... | head` is a legit use
        sys.exit(0)
