"""The port's decision log, replay and ``ckreplay`` against the reference's.

- **Cross-replay.**  A log the port records on 2-3 host lanes (the
  balancer from a prior-seeded split, streamed phases with the tuner's
  choices and pinned chunks, fused engage and disengage) verifies under the
  reference's ``verify_records``; a log the reference records on the same
  script verifies under the port's.  Exact: replay is bit-identical.
- **The same script, the same records.**  With the split pinned by
  ``normalized_compute_powers_of_devices`` and the chunks by
  ``stream_chunks``, both packages record the same (kind, compute id)
  sequence from the caller's thread, and the same multiset of (kind, lane)
  from the lanes' threads (whose order is the threads').
- **Golden fixtures.**  The port's ``verify_records`` gives the reference's
  verdict on each file of ``tests/fixtures_decisions/``, the first
  divergent seq included (two of them diverge on this interpreter in the
  reference too, ROADMAP Queue C reference state 1).  The block-tuner
  fixture's rows are of a kind whose module is not ported: counted under
  ``not_ported``, none verified.
- **``ckreplay``.**  The port's CLI gives the reference's exit codes, and
  exits 1 where a row was not replayed; on a recorded membership log
  (``member-leave``/``member-join``, a ``checkpoint-restore``) and on a
  tampered copy of it, it gives the reference's verdict.
- **Disabled is one branch.**  With the log disabled, a ``compute()``
  never reaches a recording call.
"""

from __future__ import annotations

import importlib.util
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

import cekirdekler_tpu
import cekirdekler_tpu_torch as ck
from cekirdekler_tpu.core.cruncher import NumberCruncher as RefCruncher
from cekirdekler_tpu.hardware import platforms as ref_platforms
from cekirdekler_tpu.obs import decisions as ref_decisions
from cekirdekler_tpu.obs import replay as ref_replay
from cekirdekler_tpu.obs.decisions import DECISIONS as REF_DECISIONS
from cekirdekler_tpu_torch.obs import decisions, replay
from cekirdekler_tpu_torch.obs.decisions import DECISIONS
from cekirdekler_tpu_torch.tools import ckreplay
from tests.test_torch_metrics import INC, restore_planes, save_planes

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = sorted((ROOT / "tests" / "fixtures_decisions").glob("*.jsonl"))


def _load_tool(name: str, relpath: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / relpath)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref_ckreplay = _load_tool("ck_replay_tool_ref", "tools/ckreplay.py")


@pytest.fixture(autouse=True)
def _planes():
    saved = save_planes()
    yield
    restore_planes(saved)


#: kinds the lanes' threads record, in the threads' order
LANE_KINDS = ("transfer-choose", "transfer-observe")


def script(cr, CA, lanes: int, pinned: bool) -> np.ndarray:
    """Plain calls (balanced, or pinned), streamed phases, an enqueue
    window that fuses, a changed call that breaks it, a barrier, a flush."""
    if pinned:
        cr.normalized_compute_powers_of_devices = [1.0 / lanes] * lanes
        cr.stream_chunks = 2
    else:
        # a skewed fleet: the first split is prior_split's
        cr.cores.rate_priors = [1.0 + i for i in range(lanes)]
    a = CA(np.zeros(8192, np.float32), name="a", partial_read=True)
    b = CA(np.zeros(8192, np.float32), name="b", partial_read=True)
    for _ in range(5):
        a.compute(cr, 1, "inc", 8192, 64)
    if not pinned:
        cr.stream_chunks = 2
        for _ in range(2):
            a.compute(cr, 1, "inc", 8192, 64)
        cr.stream_chunks = 0
    cr.enqueue_mode = True
    for _ in range(4):
        a.compute(cr, 1, "inc", 8192, 64)
    b.compute(cr, 2, "inc", 8192, 64)
    cr.barrier()
    cr.flush()
    cr.enqueue_mode = False
    return np.concatenate([a.host(), b.host()])


def recorded(log, cr, CA, lanes, pinned):
    log.clear()
    try:
        out = script(cr, CA, lanes, pinned)
    finally:
        cr.dispose()
    return [r.to_row() for r in log.snapshot()], out


def _port(lanes, pinned=False):
    return recorded(DECISIONS, ck.NumberCruncher(ck.all_devices().cpus(lanes), INC),
                    ck.ClArray, lanes, pinned)


def _ref(lanes, pinned=False):
    return recorded(REF_DECISIONS, RefCruncher(ref_platforms().cpus().subset(lanes), INC),
                    cekirdekler_tpu.ClArray, lanes, pinned)


def test_the_record_format_is_the_reference_s():
    assert decisions.DECISION_KINDS == ref_decisions.DECISION_KINDS
    assert decisions.REPLAYABLE_KINDS == ref_decisions.REPLAYABLE_KINDS
    assert decisions.DECISION_LOG_ENV == ref_decisions.DECISION_LOG_ENV
    assert decisions.DecisionRecord._fields == ref_decisions.DecisionRecord._fields
    assert set(replay.NOT_PORTED_KINDS) == set(ref_decisions.REPLAYABLE_KINDS) - {
        "load-balance", "prior-split", "transfer-choose", "transfer-observe",
        "health-verdict", "drain-apply", "readmit", "member-leave", "member-join",
        "admission", "coalesce", "breaker", "shed", "retry", "containment", "route"}
    assert replay.NOT_PORTED_KINDS == ("block-retune",)


@pytest.mark.parametrize("lanes", [2, 3])
def test_a_port_log_verifies_under_the_reference_s_replay(lanes):
    rows, out = _port(lanes)
    kinds = Counter(r["kind"] for r in rows)
    for k in ("prior-split", "load-balance", "transfer-choose", "transfer-observe",
              "fused-engage", "fused-disengage"):
        assert kinds[k] > 0, (k, kinds)
    np.testing.assert_array_equal(out[:8192], np.full(8192, 11.0, np.float32))
    verdict = ref_replay.verify_records(rows)
    assert verdict["ok"], verdict["first_divergence"]
    assert verdict["replayed"] == sum(kinds[k] for k in replay._REPLAYERS)
    mine = replay.verify_records(rows)
    assert mine["ok"] and mine["not_ported"] == {}
    assert mine["replayed"] == verdict["replayed"]


@pytest.mark.parametrize("lanes", [2, 3])
def test_a_reference_log_verifies_under_the_port_s_replay(lanes):
    rows, _ = _ref(lanes)
    assert Counter(r["kind"] for r in rows)["load-balance"] > 0
    verdict = replay.verify_records(rows)
    ref = ref_replay.verify_records(rows)
    assert verdict["ok"] and ref["ok"], verdict["first_divergence"]
    assert (verdict["replayed"], verdict["skipped"]) == (ref["replayed"], ref["skipped"])


def _caller_kinds(rows):
    return [(r["kind"], r["inputs"].get("cid")) for r in rows if r["kind"] not in LANE_KINDS]


def _lane_kinds(rows):
    return Counter((r["kind"], r["inputs"].get("lane")) for r in rows if r["kind"] in LANE_KINDS)


@pytest.mark.parametrize("lanes", [2, 3])
def test_the_same_pinned_script_records_the_same_sequence(lanes):
    p_rows, p_out = _port(lanes, pinned=True)
    r_rows, r_out = _ref(lanes, pinned=True)
    np.testing.assert_array_equal(p_out, r_out)
    assert _caller_kinds(p_rows) == _caller_kinds(r_rows)
    assert ("fused-engage", 1) in _caller_kinds(p_rows)
    assert _lane_kinds(p_rows) == _lane_kinds(r_rows)


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.name)
def test_the_golden_fixtures_give_the_reference_s_verdict(path):
    rows = [r.to_row() for r in ref_decisions.load_decision_log(str(path))]
    assert [r.to_row() for r in decisions.load_decision_log(str(path))] == rows
    mine, ref = replay.verify_records(rows), ref_replay.verify_records(rows)
    if path.name == "golden_block_retune.jsonl":
        assert mine["not_ported"] == {"block-retune": 6}
        assert mine["replayed"] == 0 and not mine["ok"] and mine["divergent"] == 0
        assert ref["per_kind"] == {"block-retune": 6}
        return
    assert mine["not_ported"] == {}
    for key in ("ok", "records", "replayed", "skipped", "divergent", "per_kind"):
        assert mine[key] == ref[key], key
    if ref["first_divergence"] is None:
        assert mine["first_divergence"] is None
    else:
        assert mine["first_divergence"]["seq"] == ref["first_divergence"]["seq"]
        assert mine["first_divergence"]["kind"] == ref["first_divergence"]["kind"]
        assert mine["divergences"] == json.loads(json.dumps(ref["divergences"]))


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: p.name)
def test_ckreplay_verify_gives_the_reference_s_exit_codes(path, capsys):
    mine = ckreplay.main(["verify", str(path)])
    ref = ref_ckreplay.main(["verify", str(path)])
    out = capsys.readouterr().out
    if path.name == "golden_block_retune.jsonl":
        assert (mine, ref) == (1, 0)
        assert "NOT VERIFIED" in out and "block-retune=6" in out
    else:
        assert mine == ref


def test_ckreplay_demo_whatif_explain_and_a_tampered_log(tmp_path, capsys):
    for cli in (ckreplay, ref_ckreplay):
        demo = tmp_path / f"{cli.__name__}.jsonl"
        assert cli.main(["demo", "--out", str(demo)]) == 0
        assert cli.main(["verify", str(demo)]) == 0
        assert cli.main(["whatif", str(demo), "--set", "jump_start=off"]) == 0
        assert cli.main(["explain", str(demo)]) == 0
        assert cli.main(["explain", str(demo), "--cid", "99"]) == 1
        rows = [json.loads(x) for x in demo.read_text().splitlines()]
        victim = next(r for r in rows if r.get("kind") == "load-balance")
        victim["outputs"]["ranges"][0] += victim["inputs"]["step"]
        tampered = tmp_path / f"{cli.__name__}-tampered.jsonl"
        tampered.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
        assert cli.main(["verify", str(tampered)]) == 1
        empty = tmp_path / "empty.jsonl"
        empty.write_text("")
        assert cli.main(["verify", str(empty)]) == 1
    capsys.readouterr()
    mine = json.loads(Path(tmp_path / f"{ckreplay.__name__}.jsonl").read_text().splitlines()[0])
    ref = json.loads(Path(tmp_path / f"{ref_ckreplay.__name__}.jsonl").read_text().splitlines()[0])
    assert mine.keys() == ref.keys()


def test_whatif_and_explain_equal_the_reference_s_on_a_fixture():
    path = str(ROOT / "tests" / "fixtures_decisions" / "golden_hetero_prior.jsonl")
    rows = [r.to_row() for r in ref_decisions.load_decision_log(path)]
    for over in ({"jump_start": False}, {"rate_prior": False}, {"damping": 0.1},
                 {"overhead_ms": 2.0}):
        assert replay.whatif(rows, over) == ref_replay.whatif(rows, over)
    assert replay.explain_latest(rows) == ref_replay.explain_latest(rows)
    assert replay.convergence_summary(rows) == ref_replay.convergence_summary(rows)
    assert ckreplay.parse_overrides("damping=0.1,jump_start=off") == \
        ref_ckreplay.parse_overrides("damping=0.1,jump_start=off")


def test_a_disabled_log_is_never_reached_through_compute(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a recording call was reached")

    monkeypatch.setattr(DECISIONS, "record", refuse)
    DECISIONS.enabled = False
    cr = ck.NumberCruncher(ck.all_devices().cpus(2), INC)
    try:
        out = script(cr, ck.ClArray, 2, pinned=False)
    finally:
        cr.dispose()
    np.testing.assert_array_equal(out[:8192], np.full(8192, 11.0, np.float32))


def test_records_snapshot_the_carried_state_before_the_call():
    """A load-balance record's ``state`` input is the state the call
    started from: replaying the log record by record from each snapshot
    reproduces every next snapshot."""
    rows, _ = _port(2)
    lb = [r for r in rows if r["kind"] == "load-balance" and r["inputs"]["state"]]
    assert len(lb) >= 3
    for prev, nxt in zip(lb, lb[1:]):
        if prev["inputs"]["cid"] == nxt["inputs"]["cid"]:
            assert nxt["inputs"]["state"] == prev["outputs"]["state_after"]


def _drained_log(monkeypatch, package: str) -> list[dict]:
    """A decision log of one package's cruncher on two host lanes whose
    lane 1 a ``lane-stall`` degrades under a modelled clock until the
    drain quarantines it, probes it and readmits it."""
    from cekirdekler_tpu.core import cores as ref_cores
    from cekirdekler_tpu.utils.faultinject import FAULTS as REF_FAULTS
    from cekirdekler_tpu_torch.core import cores as port_cores
    from cekirdekler_tpu_torch.utils.faultinject import FAULTS
    from tests.test_torch_drain import StallClock

    port = package == "port"
    cr = (ck.NumberCruncher(ck.all_devices().cpus(2), INC) if port
          else RefCruncher(ref_platforms().cpus().subset(2), INC))
    CA = ck.ClArray if port else cekirdekler_tpu.ClArray
    log, faults = (DECISIONS, FAULTS) if port else (REF_DECISIONS, REF_FAULTS)
    clock = StallClock()
    clock.lags = {0: 0.010, 1: 0.010}
    monkeypatch.setattr(port_cores if port else ref_cores, "time", clock)
    clock.attach(cr)
    cores = cr.cores
    cores.health = type(cores.health)(window=2, min_history=2, confirm=2)
    cores.drain = type(cores.drain)(cores.health, lanes=2, hold_barriers=1, confirm_clear=1)
    faults.arm("lane-stall@lane1:delay_ms=50,after=4,times=4")
    log.clear()
    try:
        x = CA(np.zeros(1024, np.float32), name="x")
        x.partial_read = True
        cr.enqueue_mode = True
        for _ in range(16):
            x.compute(cr, 1, "inc", 1024, 64)
            cr.barrier()
        cr.enqueue_mode = False
        np.testing.assert_array_equal(np.asarray(x), 16.0)
    finally:
        faults.disarm()
        cr.dispose()
    return [r.to_row() for r in log.snapshot()]


@pytest.mark.parametrize("package", ["port", "reference"])
def test_a_drained_log_verifies_under_both_replays(monkeypatch, package):
    """The health and drain kinds replay both ways: a log with
    ``health-verdict``, ``drain-apply`` and ``readmit`` rows verifies under
    the reference's replay and under the port's, none of them not ported."""
    rows = _drained_log(monkeypatch, package)
    kinds = Counter(r["kind"] for r in rows)
    assert kinds["health-verdict"] > 0 and kinds["drain-apply"] == 1 and kinds["readmit"] == 1
    mine, ref = replay.verify_records(rows), ref_replay.verify_records(rows)
    assert mine["ok"] and ref["ok"], (mine["first_divergence"], ref["first_divergence"])
    assert mine["not_ported"] == {}
    for key in ("records", "replayed", "skipped", "divergent", "per_kind"):
        assert mine[key] == ref[key], key
    for kind in ("health-verdict", "drain-apply", "readmit"):
        assert mine["per_kind"][kind] == kinds[kind]
    # a tampered drain row diverges under both, naming the field
    row = next(r for r in rows if r["kind"] == "drain-apply")
    bad = dict(row, outputs=dict(row["outputs"], states={"0": "quarantined", "1": "active"}))
    for verify in (replay.verify_records, ref_replay.verify_records):
        v = verify([bad])
        assert not v["ok"] and v["divergent"] == 1


def test_ckreplay_verifies_a_drained_log(monkeypatch, tmp_path, capsys):
    rows = _drained_log(monkeypatch, "port")
    path = tmp_path / "drained.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    assert ckreplay.main(["verify", str(path)]) == 0
    assert ref_ckreplay.main(["verify", str(path)]) == 0
    out = capsys.readouterr().out
    assert "NOT VERIFIED" not in out


def _membership_log(tmp_path) -> list[dict]:
    """A port job's membership log: a roster established, a member lost, a
    rejoin resized, and a window resumed."""
    from cekirdekler_tpu_torch.cluster.elastic import Membership, resume_window, save_window

    DECISIONS.clear()
    m = Membership()
    m.establish({"p0": 128, "p1": 128, "p2": 64})
    m.leave("p2", total=4096)
    m.sync({"p0": 128, "p1": 256, "p3": 64}, total=5000)
    m.join("p10", 64)  # no total: the roster alone is recorded
    save_window(str(tmp_path / "ckpt"), 2, {"y": np.ones(4, np.float32)}, member_steps=[128, 256])
    resume_window(str(tmp_path / "ckpt"))
    return [r.to_row() for r in DECISIONS.snapshot()]


def test_ckreplay_verify_gives_the_reference_s_verdict_on_a_membership_log(tmp_path, capsys):
    rows = _membership_log(tmp_path)
    kinds = Counter(r["kind"] for r in rows)
    assert kinds["member-leave"] == 2 and kinds["member-join"] == 3
    assert kinds["checkpoint-restore"] == 1
    tampered = [dict(r) for r in rows]
    i = next(k for k, r in enumerate(tampered) if r["kind"] == "member-join" and "ranges" in
             r["outputs"])
    tampered[i] = dict(tampered[i], outputs=dict(tampered[i]["outputs"], lcm=7))
    for name, log in (("members.jsonl", rows), ("tampered.jsonl", tampered)):
        path = tmp_path / name
        path.write_text("".join(json.dumps(r) + "\n" for r in log))
        mine, ref = replay.verify_records(log), ref_replay.verify_records(log)
        assert mine["not_ported"] == {}
        for key in ("ok", "records", "replayed", "skipped", "divergent", "per_kind"):
            assert mine[key] == ref[key], key
        assert mine["ok"] is (name == "members.jsonl")
        if not mine["ok"]:
            assert mine["first_divergence"]["seq"] == ref["first_divergence"]["seq"] == \
                tampered[i]["seq"]
        assert ckreplay.main(["verify", str(path)]) == ref_ckreplay.main(["verify", str(path)])
    assert "NOT VERIFIED" not in capsys.readouterr().out
