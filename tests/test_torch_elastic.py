"""The port's ``cluster/elastic.py`` against the reference's: epoch
membership, heartbeat liveness, the pure member re-split, per-window
checkpoints, and the replay of membership transitions.

The same transitions through both packages' ``Membership`` record equal
decision rows (kind, inputs and outputs) and equal flight events; a window
that one package saves, the other resumes, torn newest step included; the
port's ``ckreplay`` verify re-derives the member re-splits and agrees with
the reference's verdict on the same rows.  The reference's
``tests/test_elastic.py`` cases run on the port.
"""

from __future__ import annotations

import os
import time

import numpy as np
import pytest

from cekirdekler_tpu.cluster import elastic as ref_elastic
from cekirdekler_tpu.obs.decisions import DECISIONS as REF_DECISIONS
from cekirdekler_tpu.obs.flight import FLIGHT as REF_FLIGHT
from cekirdekler_tpu.obs.replay import verify_records as ref_verify_records
from cekirdekler_tpu_torch.cluster import elastic
from cekirdekler_tpu_torch.cluster.balancer import ClusterLoadBalancer
from cekirdekler_tpu_torch.cluster.elastic import (
    Heartbeat,
    Membership,
    alive_members,
    member_resplit,
    resume_window,
    save_window,
)
from cekirdekler_tpu_torch.metrics.registry import REGISTRY
from cekirdekler_tpu_torch.obs.decisions import DECISIONS
from cekirdekler_tpu_torch.obs.flight import FLIGHT
from cekirdekler_tpu_torch.obs.replay import replay_record, verify_records
from tests.test_torch_metrics import restore_planes, save_planes


@pytest.fixture(autouse=True)
def _planes():
    saved = save_planes()
    yield
    restore_planes(saved)


def test_the_module_s_contract_is_the_reference_s():
    assert elastic.MODEL_INVARIANTS == ref_elastic.MODEL_INVARIANTS
    assert elastic.META_PREFIX == ref_elastic.META_PREFIX
    assert elastic.__all__ == ref_elastic.__all__


@pytest.mark.parametrize("seed", range(4))
def test_member_resplit_equals_the_reference_s(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        steps = [int(s) for s in rng.choice([64, 128, 192, 256, 320, 512],
                                            size=int(rng.integers(1, 7)))]
        total = int(rng.integers(0, 1 << 16))
        assert member_resplit(steps, total) == ref_elastic.member_resplit(steps, total)


def _script(M, rng_seed: int) -> list:
    """A seeded sequence of establish/leave/join/sync transitions through a
    ``Membership`` class; returns every transition's outputs."""
    rng = np.random.default_rng(rng_seed)
    m = M()
    ids = [f"p{i}" for i in (0, 1, 2, 3, 10, 11)]
    outs = [m.establish({f"p{i}": 64 * (i + 1) for i in range(3)})]
    for _ in range(12):
        total = int(rng.choice([0, 1024, 4096, 5000])) if rng.random() < 0.8 else None
        op = rng.integers(3)
        if op == 0:
            outs.append(m.leave(str(rng.choice(ids)), total=total))
        elif op == 1:
            outs.append(m.join(str(rng.choice(ids)), int(rng.choice([64, 128, 256])),
                               total=total))
        else:
            present = {mid: int(rng.choice([64, 128])) for mid in ids if rng.random() < 0.5}
            outs.append(m.sync(present, total=total))
    outs.append(m.snapshot())
    return outs


def _rows(ring, kinds=("member-leave", "member-join", "checkpoint-restore")) -> list:
    return [(r.kind, r.inputs, r.outputs) for r in ring.snapshot() if r.kind in kinds]


@pytest.mark.parametrize("seed", range(3))
def test_membership_records_the_reference_s_rows(seed):
    DECISIONS.clear()
    REF_DECISIONS.clear()
    FLIGHT.clear()
    REF_FLIGHT.clear()
    assert _script(Membership, seed) == _script(ref_elastic.Membership, seed)
    mine = _rows(DECISIONS)
    assert mine and mine == _rows(REF_DECISIONS)
    member_events = lambda ring: [(e.kind, e.fields) for e in ring.snapshot()
                                  if e.kind.startswith("member-")]
    assert member_events(FLIGHT) == member_events(REF_FLIGHT)
    rows = [r.to_row() for r in DECISIONS.snapshot()]
    mine_v, ref_v = verify_records(rows), ref_verify_records(rows)
    assert mine_v["ok"] and ref_v["ok"], (mine_v, ref_v)
    assert mine_v["replayed"] == ref_v["replayed"] > 0 and mine_v["not_ported"] == {}


def test_member_resplit_matches_lcm_balancer():
    steps = [256, 128, 128]
    out = member_resplit(steps, 4096)
    bal = ClusterLoadBalancer(steps)
    shares, rem = bal.equal_split(4096)
    shares = list(shares)
    shares[0] += rem
    assert out["ranges"] == shares
    assert out["lcm"] == bal.lcm
    assert sum(out["ranges"]) == 4096


def test_membership_leave_join_bump_epoch_and_record():
    m = Membership()
    assert m.establish({"p0": 256, "p1": 128}) == 1
    out = m.leave("p1", total=2048)
    assert out["epoch_after"] == 2
    assert out["ranges"] == member_resplit([256], 2048)["ranges"]
    out = m.join("p2", 128, total=2048)
    assert out["epoch_after"] == 3
    assert m.snapshot()["members"] == {"p0": 256, "p2": 128}
    recs = [r for r in DECISIONS.snapshot()
            if r.kind in ("member-leave", "member-join")][-2:]
    assert [r.kind for r in recs] == ["member-leave", "member-join"]
    v = verify_records(recs)
    assert v["ok"], v["first_divergence"]
    assert REGISTRY.gauge("ck_member_epoch").value == 3.0
    assert REGISTRY.gauge("ck_member_count").value == 2.0


def test_membership_sync_diffs_and_resizes():
    m = Membership()
    m.establish({"p0": 256, "p1": 128, "p2": 128})
    out = m.sync({"p0": 256, "p1": 256, "p3": 64}, total=4096)
    snap = m.snapshot()
    assert snap["members"] == {"p0": 256, "p1": 256, "p3": 64}
    assert len(out) == 4  # p2 leave + p1 leave + p1 rejoin + p3 join
    assert snap["epoch"] == 5


def test_membership_steps_stay_in_process_order_past_ten_members():
    m = Membership()
    m.establish({f"p{i}": 64 * (i + 1) for i in range(11)})
    out = m.join("p11", 64, total=0)
    assert out["members_after"]["p11"] == 64
    rec = [r for r in DECISIONS.snapshot() if r.kind == "member-join"][-1]
    assert rec.inputs["steps_after"] == [64 * (i + 1) for i in range(11)] + [64]


def test_membership_tampered_resplit_diverges_on_replay():
    m = Membership()
    m.establish({"p0": 64, "p1": 64})
    m.leave("p1", total=1024)
    rec = [r for r in DECISIONS.snapshot() if r.kind == "member-leave"][-1]
    row = rec.to_row()
    assert replay_record(row)["ok"] is True
    row["outputs"] = dict(row["outputs"], ranges=[512])
    out = replay_record(row)
    assert out["ok"] is False and "ranges" in out["mismatch"]
    row["outputs"] = dict(rec.outputs, epoch_after=7)
    assert "epoch_after" in replay_record(row)["mismatch"]


# -- heartbeats --------------------------------------------------------------------

def test_heartbeat_liveness_and_stale_detection(tmp_path):
    root = str(tmp_path)
    hb0 = Heartbeat(root, "p0", interval_s=0.05)
    hb1 = Heartbeat(root, "p1", interval_s=0.05, start=False)
    try:
        assert alive_members(root, timeout_s=5.0) == ["p0", "p1"]
        assert ref_elastic.alive_members(root, timeout_s=5.0) == ["p0", "p1"]
        hb1.close()
        past = time.time() - 60.0
        os.utime(os.path.join(root, "hb_p1"), (past, past))
        assert alive_members(root, timeout_s=1.0) == ["p0"]
        hb0.close(remove=True)
        assert alive_members(root, timeout_s=1.0) == []
    finally:
        hb0.close()
        hb1.close()


def test_heartbeat_drives_membership_sync(tmp_path):
    root = str(tmp_path)
    m = Membership()
    m.establish({"p0": 64, "p1": 64})
    hb0 = Heartbeat(root, "p0", start=False)
    hb1 = Heartbeat(root, "p1", start=False)
    hb1.close()
    past = time.time() - 60.0
    os.utime(os.path.join(root, "hb_p1"), (past, past))
    present = {mid: 64 for mid in alive_members(root, timeout_s=1.0)}
    out = m.sync(present, total=1024)
    assert len(out) == 1
    assert m.snapshot()["members"] == {"p0": 64}
    assert out[0]["ranges"] == [1024]
    hb0.close()


# -- per-window checkpoints ------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_window_one_package_saves_the_other_resumes(tmp_path, writer):
    root = str(tmp_path)
    save, resume = (save_window, ref_elastic.resume_window) if writer == "port" else (
        ref_elastic.save_window, resume_window)
    rng = np.random.default_rng(3)
    arrays = {"y": rng.standard_normal(64).astype(np.float32),
              "ids": rng.integers(-(1 << 62), 1 << 62, 9, dtype=np.int64)}
    save(root, 3, arrays, member_steps=[128, 64])
    save(root, 4, {k: v * 2 for k, v in arrays.items()}, member_steps=[128, 64, 64])
    torn = os.path.join(root, f"step_{5:012d}")
    os.makedirs(torn)
    with open(os.path.join(torn, "arrays.npz"), "wb") as f:
        f.write(b"garbage")
    state = resume(root)
    assert state["window"] == 4 and state["member_steps"] == [128, 64, 64]
    assert sorted(state["arrays"]) == ["ids", "y"]
    for k, v in arrays.items():
        np.testing.assert_array_equal(state["arrays"][k], v * 2)
        assert state["arrays"][k].dtype == v.dtype


def test_save_resume_window_records_the_restore(tmp_path):
    root = str(tmp_path)
    y = np.arange(8, dtype=np.float32)
    save_window(root, 3, {"y": y}, member_steps=[128, 64])
    save_window(root, 4, {"y": y * 2}, member_steps=[128, 64])
    state = resume_window(root)
    assert state["window"] == 4
    np.testing.assert_array_equal(state["arrays"]["y"], y * 2)
    recs = [r for r in DECISIONS.snapshot() if r.kind == "checkpoint-restore"]
    assert recs and recs[-1].outputs == {"window": 4, "arrays": ["y"], "member_steps": [128, 64]}
    assert [e.kind for e in FLIGHT.snapshot()][-1] == "checkpoint-restore"


def test_resume_window_empty_root_is_fresh_start(tmp_path):
    assert resume_window(str(tmp_path / "nope")) is None
