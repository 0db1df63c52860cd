"""The port's serving fabric (``serve/fabric.py``) against the reference's,
on host lanes.

- **The pure placement.**  Seeded sweeps of ``route_decision`` (rosters,
  health views, epochs), ``ring_points``, ``placement_key``,
  ``shard_health``, ``merge_shard_serving`` and ``fabric_key`` through both
  packages give identical outputs; the reference's property tests
  (determinism, minimal reshuffle, member-only targets, named diversion)
  hold in the port.
- **The recording router.**  The same membership changes, marks and routes
  through both packages' ``ShardRouter`` give equal verdicts and equal
  ``route`` rows; the rows verify green under both packages'
  ``verify_records`` and a tampered one diverges in both.
- **The in-process fabric** over the ``autostart=False`` seam: routing
  and exactness as the reference computes them, a member kill whose queued
  requests re-route onto survivors bit for bit (its spilled log verifying
  through both packages' ``ckreplay``), warm-on-join, named refusals.
- **The TCP path.**  A rejection raised server-side re-raises client-side
  as the typed ``ServeRejected``, across packages too.
- **Three worker processes** (``tools/fabric_worker.py`` on host lanes): a
  seeded SIGKILL of one, exactly the unacked requests re-routed onto the
  ring survivors, every array bit-exact; and the killed requests' rid
  chains read whole in the merged cluster trace.  Every child is bounded
  and killed on every exit path.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import cekirdekler_tpu
from cekirdekler_tpu.cluster import CruncherClient as RefClient
from cekirdekler_tpu.cluster import CruncherServer as RefServer
from cekirdekler_tpu.cluster import elastic as ref_elastic
from cekirdekler_tpu.core import NumberCruncher as RefCruncher
from cekirdekler_tpu.hardware import platforms as ref_platforms
from cekirdekler_tpu.obs.decisions import DecisionLog as RefDecisionLog
from cekirdekler_tpu.obs.replay import verify_records as ref_verify_records
from cekirdekler_tpu.serve import fabric as ref_fabric
import cekirdekler_tpu.serve as ref_serve
import cekirdekler_tpu_torch as ck
from cekirdekler_tpu_torch.cluster import CruncherClient, CruncherServer
from cekirdekler_tpu_torch.cluster import elastic as elastic_mod
from cekirdekler_tpu_torch.cluster import server as server_mod
from cekirdekler_tpu_torch.cluster.elastic import Membership
from cekirdekler_tpu_torch.errors import CekirdeklerError
from cekirdekler_tpu_torch.metrics.registry import REGISTRY
from cekirdekler_tpu_torch.obs import replay as replay_mod
from cekirdekler_tpu_torch.obs.decisions import DecisionLog
from cekirdekler_tpu_torch.serve import ServeJob, ServeRejected
from cekirdekler_tpu_torch.serve import fabric as fabric_mod
from cekirdekler_tpu_torch.serve.fabric import (
    REJECT_SHARD,
    VNODES,
    ServeFabric,
    ShardRouter,
    fabric_key,
    merge_shard_serving,
    placement_key,
    ring_points,
    route_decision,
    shard_health,
)
from cekirdekler_tpu_torch.tools import ckreplay
from cekirdekler_tpu_torch.tools.loadgen import LOADGEN_SRC
from tests.test_torch_metrics import restore_planes, save_planes

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

INC = """
__kernel void inc(__global float* a) {
    int i = get_global_id(0);
    a[i] = a[i] + 1.0f;
}
"""


#: the crunchers a test's fabrics were built over, disposed after it
_MADE: list = []


@pytest.fixture(autouse=True)
def _planes():
    saved = save_planes()
    yield
    restore_planes(saved)
    while _MADE:
        _MADE.pop().dispose()


def _ref_tool(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"ck_ref_{name}_fabric",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _keys(count):
    return [(f"t{i % 5}", f"cid{9100 + i % 7}|inc|4096x64+0#{i}") for i in range(count)]


# -- the contract and the pure placement --------------------------------------


def test_the_module_s_contract_is_the_reference_s():
    assert fabric_mod.__all__ == ref_fabric.__all__
    for name in ("VNODES", "REJECT_SHARD", "MODEL_INVARIANTS", "_SHARD_RETRY_S"):
        assert getattr(fabric_mod, name) == getattr(ref_fabric, name), name


@pytest.mark.parametrize("seed", range(4))
def test_route_decision_equals_the_reference_s(seed):
    rng = random.Random(seed)
    seen = {"diverted": 0, "refused": 0}
    for _ in range(40):
        roster = [f"p{rng.randrange(12)}" for _ in range(rng.randrange(0, 6))]
        bad = tuple(m for m in set(roster) if rng.random() < 0.35)
        epoch = rng.randrange(0, 9)
        for tenant, key in _keys(10):
            mine = route_decision(tenant, key, roster, bad, epoch)
            assert mine == ref_fabric.route_decision(tenant, key, roster, bad, epoch)
            seen["diverted"] += bool(mine["diverted"] and mine["shard"])
            seen["refused"] += mine["shard"] is None
    assert seen["diverted"] > 0 and seen["refused"] > 0


def test_ring_placement_health_merge_and_keys_equal_the_reference_s():
    rng = random.Random(3)
    for _ in range(20):
        roster = [f"m{rng.randrange(30)}" for _ in range(rng.randrange(1, 6))]
        assert ring_points(roster) == ref_fabric.ring_points(roster)
    for tenant, key in _keys(50):
        assert placement_key(tenant, key) == ref_fabric.placement_key(tenant, key)
    docs = [{}, {"resilience": {"dead": "x"}}, {"resilience": {"breakers_open": 3}},
            {"resilience": {"brownout": {"active": True}}}, {"admission": {"healthy": False}},
            {"resilience": {"dead": None, "breakers_open": 0, "brownout": {"active": False}},
             "admission": {"healthy": True}}, None]
    for doc in docs:
        assert shard_health(doc) == ref_fabric.shard_health(doc)
    stats = {f"p{k}": {"queue_depth": k, "batches": 2 * k, "requests_done": 3 * k,
                       "rounds": k, "resilience": docs[k % 6].get("resilience", {})}
             for k in range(6)}
    assert merge_shard_serving(stats) == ref_fabric.merge_shard_serving(stats)
    for cid, kernels, g, lr, off in ((9100, ["inc"], 256, 64, 0),
                                     (7, ["a", "b"], 4096, 256, 128)):
        mine = ServeJob(params=[], kernels=kernels, compute_id=cid, global_range=g,
                        local_range=lr, global_offset=off)
        ref = ref_serve.ServeJob(params=[], kernels=kernels, compute_id=cid, global_range=g,
                                 local_range=lr, global_offset=off)
        assert fabric_key(mine) == ref_fabric.fabric_key(ref)


def test_route_decision_deterministic_over_random_rosters():
    rng = random.Random(2017)
    for _ in range(25):
        roster = [f"p{rng.randrange(40)}" for _ in range(rng.randrange(1, 7))]
        bad = tuple(m for m in set(roster) if rng.random() < 0.3)
        for tenant, key in _keys(8):
            a = route_decision(tenant, key, roster, bad, epoch=3)
            b = route_decision(tenant, key, list(reversed(roster)), tuple(reversed(bad)),
                               epoch=3)
            assert a == b
            if a["shard"] is not None:
                assert a["shard"] in set(roster) and a["shard"] not in set(bad)
                assert a["reason"] is None
            else:
                assert a["reason"] == REJECT_SHARD


def test_route_minimal_reshuffle_on_leave_and_join():
    rng = random.Random(7)
    for _ in range(10):
        roster = sorted({f"p{rng.randrange(30)}" for _ in range(rng.randrange(3, 7))})
        keys = _keys(60)
        before = {k: route_decision(t, k, roster)["shard"] for t, k in keys}
        gone = rng.choice(roster)
        survivors = [m for m in roster if m != gone]
        for t, k in keys:
            if before[k] != gone:
                assert route_decision(t, k, survivors)["shard"] == before[k]
        grown = roster + ["zz-new"]
        for t, k in keys:
            assert route_decision(t, k, grown)["shard"] in (before[k], "zz-new")


def test_route_unhealthy_diversion_is_named_and_lands_on_successor():
    roster = ["p0", "p1", "p2", "p3"]
    for tenant, key in _keys(24):
        owner = route_decision(tenant, key, roster)["owner"]
        d = route_decision(tenant, key, roster, (owner,))
        assert d["diverted"] and d["hops"] >= 1
        assert d["shard"] != owner and d["shard"] in roster and d["owner"] == owner
        refused = route_decision(tenant, key, roster, tuple(roster))
        assert refused["shard"] is None and refused["reason"] == REJECT_SHARD
    assert route_decision("t0", "k", [])["reason"] == REJECT_SHARD


def test_ring_points_and_fabric_key_are_portable():
    pts = ring_points(["b", "a"])
    assert pts == sorted(pts) and len(pts) == 2 * VNODES and pts == ring_points(("a", "b"))
    a1 = ck.ClArray(np.zeros(256, np.float32), name="one")
    a2 = ck.ClArray(np.zeros(256, np.float32), name="two")
    j1 = ServeJob(params=[a1], kernels=["inc"], compute_id=9100, global_range=256,
                  local_range=64)
    j2 = ServeJob(params=[a2], kernels=["inc"], compute_id=9100, global_range=256,
                  local_range=64)
    assert fabric_key(j1) == fabric_key(j2) == "cid9100|inc|256x64+0"
    assert j1.signature() != j2.signature()


def test_shard_health_reasons_in_check_order():
    assert shard_health({})["healthy"]
    doc = {"resilience": {"dead": True, "breakers_open": 2, "brownout": {"active": True}},
           "admission": {"healthy": False}}
    assert shard_health(doc)["reasons"] == [
        "dispatcher-dead", "circuit-open", "brownout", "drain-degraded"]
    assert not shard_health({"admission": {"healthy": False}})["healthy"]


def test_merge_shard_serving_sums_the_fleet():
    merged = merge_shard_serving({
        "p1": {"queue_depth": 3, "batches": 10, "requests_done": 40, "rounds": 10,
               "resilience": {"breakers_open": 1}},
        "p0": {"queue_depth": 1, "batches": 4, "requests_done": 16, "rounds": 4,
               "resilience": {"dead": True, "brownout": {"active": True}}},
    })
    assert merged["shards"] == ["p0", "p1"]
    assert merged["queue_depth"] == 4 and merged["requests_done"] == 56
    assert merged["breakers_open"] == 1
    assert merged["brownouts_active"] == 1 and merged["dead"] == ["p0"]


# -- the recording router ------------------------------------------------------


def _router_script(fab_mod, el_mod, log, monkeypatch) -> list:
    monkeypatch.setattr(fab_mod, "DECISIONS", log)
    monkeypatch.setattr(el_mod, "DECISIONS", log)
    ms = el_mod.Membership()
    ms.establish({"p0": 2, "p1": 2, "p2": 2})
    router = fab_mod.ShardRouter(ms)
    outs = []
    rng = random.Random(11)
    for step in range(40):
        op = rng.random()
        if op < 0.1:
            router.mark(rng.choice(["p0", "p1", "p2", "p3"]), ("circuit-open",))
        elif op < 0.15:
            router.clear(rng.choice(["p0", "p1", "p2"]))
        elif op < 0.2:
            outs.append(router.refresh_health(
                {"p0": {}, "p1": {"resilience": {"breakers_open": step % 2}}}))
        elif op < 0.25:
            ms.leave(rng.choice(["p0", "p1", "p2"]))
        elif op < 0.3:
            ms.join(rng.choice(["p0", "p1", "p2", "p3"]), 2)
        else:
            t, k = _keys(7)[step % 7]
            outs.append(router.route(t, k, rid=f"r{step}"))
        outs.append(router.health_view())
    return outs


def test_shard_router_step_by_step_equals_the_reference_s(monkeypatch):
    log, ref_log = DecisionLog(capacity=4096), RefDecisionLog(capacity=4096)
    mine = _router_script(fabric_mod, elastic_mod, log, monkeypatch)
    ref = _router_script(ref_fabric, ref_elastic, ref_log, monkeypatch)
    assert mine == ref
    rows = [r.to_row() for r in log.snapshot()]
    ref_rows = [r.to_row() for r in ref_log.snapshot()]
    strip = [(r["kind"], r["inputs"], r["outputs"]) for r in rows]
    assert strip == [(r["kind"], r["inputs"], r["outputs"]) for r in ref_rows]
    assert {"route", "member-leave", "member-join"} <= {r["kind"] for r in rows}
    rows = json.loads(json.dumps(rows))
    for verify in (replay_mod.verify_records, ref_verify_records):
        verdict = verify(rows)
        assert verdict["ok"] and verdict["replayed"] == len(rows), verdict
    bad = json.loads(json.dumps(next(r for r in rows if r["kind"] == "route"
                                     and r["outputs"]["shard"])))
    bad["outputs"]["shard"] = "p9"
    for verify in (replay_mod.verify_records, ref_verify_records):
        v2 = verify([bad])
        assert v2["ok"] is False and v2["first_divergence"]["seq"] == bad["seq"]


def test_shard_router_records_replayable_routes(monkeypatch):
    log = DecisionLog(capacity=512)
    monkeypatch.setattr(fabric_mod, "DECISIONS", log)
    ms = Membership()
    ms.establish({"p0": 2, "p1": 2, "p2": 2})
    router = ShardRouter(ms)
    router.mark("p1", ("circuit-open",))
    outs = [router.route(t, k) for t, k in _keys(12)]
    rows = [r for r in log.snapshot() if r.kind == "route"]
    assert len(rows) == 12
    for r, out in zip(rows, outs):
        assert r.outputs == out
        assert r.inputs["members"] == ["p0", "p1", "p2"]
        assert r.inputs["unhealthy"] == ["p1"] and r.inputs["epoch"] == 1
        assert replay_mod.replay_record(r)["ok"]
    verdict = replay_mod.verify_records(rows)
    assert verdict["ok"] and verdict["replayed"] == 12


def test_shard_router_health_refresh_replaces_wholesale():
    ms = Membership()
    ms.establish({"p0": 1, "p1": 1})
    router = ShardRouter(ms)
    router.mark("p0")
    assert "p0" in router.health_view()
    bad = router.refresh_health({"p0": {"resilience": {}},
                                 "p1": {"resilience": {"breakers_open": 1}}})
    assert bad == {"p1": ["circuit-open"]}
    assert router.health_view() == {"p1": ["circuit-open"]}
    router.clear("p1")
    assert router.health_view() == {}


# -- the in-process fabric -------------------------------------------------------


def _mk_fabric(members=("m0", "m1", "m2"), n=2048, port=True, **kw):
    if port:
        crunchers = {m: ck.NumberCruncher(ck.all_devices().cpus(1), INC) for m in members}
        fab = ServeFabric(crunchers, autostart=False, gather_window_s=0.0, max_batch=64, **kw)
        a = ck.ClArray(np.zeros(n, np.float32), name="fab")
        job_cls = ServeJob
    else:
        crunchers = {m: RefCruncher(ref_platforms().cpus().subset(1), INC) for m in members}
        fab = ref_fabric.ServeFabric(crunchers, autostart=False, gather_window_s=0.0,
                                     max_batch=64, **kw)
        a = cekirdekler_tpu.ClArray(np.zeros(n, np.float32), name="fab")
        job_cls = ref_serve.ServeJob
    _MADE.extend(crunchers.values())
    a.partial_read = True
    job = job_cls(params=[a], kernels=["inc"], compute_id=9100, global_range=n,
                  local_range=64)
    return fab, a, job


def _drain(fab, futs, steps=40):
    done = []
    for _ in range(steps):
        fab.step()
        done = [f for f in futs if f.done()]
        if len(done) == len(futs):
            break
    return done


def _routes_script(port: bool) -> tuple:
    fab, a, job = _mk_fabric(port=port)
    try:
        futs = [fab.submit(f"t{k % 3}", job) for k in range(6)]
        assert len(_drain(fab, futs)) == 6
        recs = [{k: v for k, v in f.result().items() if k != "latency_s"} for f in futs]
        st = fab.stats()
        return (np.asarray(a).copy().tobytes(), recs,
                {m: d["requests_done"] for m, d in st["shards"].items()},
                st["merged"]["requests_done"], st["epoch"])
    finally:
        fab.close()


def test_fabric_routes_submits_and_computes_as_the_reference_does():
    mine = _routes_script(True)
    np.testing.assert_array_equal(np.frombuffer(mine[0], np.float32), 6.0)
    assert mine[3] == 6 and sum(mine[2].values()) == 6
    owners = {route_decision(f"t{k % 3}", "cid9100|inc|2048x64+0", ["m0", "m1", "m2"])["shard"]
              for k in range(6)}
    assert {m for m, d in mine[2].items() if d} == owners
    assert mine == _routes_script(False)


def _preempt_script(port: bool, tmp_path, monkeypatch) -> tuple:
    log = DecisionLog(capacity=2048) if port else RefDecisionLog(capacity=2048)
    monkeypatch.setattr(fabric_mod if port else ref_fabric, "DECISIONS", log)
    monkeypatch.setattr(elastic_mod if port else ref_elastic, "DECISIONS", log)
    counter = REGISTRY if port else __import__(
        "cekirdekler_tpu.metrics.registry", fromlist=["REGISTRY"]).REGISTRY
    before = counter.counter("ck_serve_fabric_reroutes_total", "").value
    fab, a, job = _mk_fabric(port=port)
    try:
        victim = route_decision("t0", "cid9100|inc|2048x64+0", ["m0", "m1", "m2"])["shard"]
        futs = [fab.submit("t0", job) for _ in range(8)]
        fab.remove_member(victim, drain=False)
        assert victim not in fab.shards
        done = _drain(fab, futs)
        out = (len(done), [f.exception() is None for f in futs],
               np.asarray(a).copy().tobytes(),
               counter.counter("ck_serve_fabric_reroutes_total", "").value - before,
               fab.membership.snapshot()["epoch"])
    finally:
        fab.close()
    p = str(tmp_path / f"fabric_decisions_{'port' if port else 'ref'}.jsonl")
    log.save_jsonl(p)
    return out, p, {r.kind for r in log.snapshot()}


def test_fabric_preemption_reroutes_bit_exact_and_replays_in_both_packages(
        tmp_path, monkeypatch):
    mine, p_log, kinds = _preempt_script(True, tmp_path, monkeypatch)
    assert mine[0] == 8 and all(mine[1])
    np.testing.assert_array_equal(np.frombuffer(mine[2], np.float32), 8.0)
    assert mine[3] == 8 and mine[4] == 2
    assert {"route", "member-leave", "retry"} <= kinds
    ref, r_log, _ = _preempt_script(False, tmp_path, monkeypatch)
    assert mine == ref
    ref_ckreplay = _ref_tool("ckreplay")
    for path in (p_log, r_log):
        assert ckreplay.main(["verify", path]) == 0
        assert ref_ckreplay.main(["verify", path]) == 0
    rows = [json.loads(line) for line in open(p_log)]
    bad = next(r for r in rows if r.get("kind") == "retry")
    bad["outputs"]["retry"] = not bad["outputs"]["retry"]
    tampered = str(tmp_path / "tampered.jsonl")
    with open(tampered, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    assert ckreplay.main(["verify", tampered]) == 1
    assert ref_ckreplay.main(["verify", tampered]) == 1


def test_fabric_warm_on_join_precompiles_observed_signatures():
    fab, a, job = _mk_fabric(members=("m0", "m1"))
    try:
        futs = [fab.submit("t0", job) for _ in range(2)]
        _drain(fab, futs)
        before = REGISTRY.counter("ck_serve_warmup_total", "").value
        joiner = ck.NumberCruncher(ck.all_devices().cpus(1), INC)
        _MADE.append(joiner)
        fab.add_member("m2", joiner, step=1)
        assert REGISTRY.counter("ck_serve_warmup_total", "").value == before + 1
        assert "m2" in fab.shards and fab.membership.snapshot()["epoch"] == 2
        assert np.all(np.asarray(a) == 2.0)  # warmup ran on scratch buffers
        prog = joiner.cores.program
        built = (prog.fused_compiled_count, prog.compiled_count)
        assert built[0] >= 1
        futs = [fab.submit("t1", job) for _ in range(3)]
        assert len(_drain(fab, futs)) == 3
        assert np.all(np.asarray(a) == 5.0)
        if fab.shards["m2"].stats()["requests_done"]:
            assert (prog.fused_compiled_count, prog.compiled_count) == built
    finally:
        fab.close()


def test_fabric_no_members_and_closed_refuse_with_named_errors():
    fab, a, job = _mk_fabric(members=("m0",))
    try:
        fab.remove_member("m0")
        with pytest.raises(ServeRejected) as ei:
            fab.submit("t0", job)
        assert ei.value.reason == REJECT_SHARD and ei.value.retry_after_s > 0
    finally:
        fab.close()
    with pytest.raises(CekirdeklerError, match="is closed"):
        fab.submit("t0", job)


def test_fabric_checkpoint_resumes_through_elastic(tmp_path):
    fab, a, job = _mk_fabric(members=("m0", "m1"), checkpoint_root=str(tmp_path))
    try:
        futs = [fab.submit("t0", job) for _ in range(3)]
        _drain(fab, futs)
        assert fab.save_checkpoint(0, {"fab": np.asarray(a).copy()})
        got = fab.resume_checkpoint()
        assert got["window"] == 0 and got["member_steps"] == [1, 1]
        np.testing.assert_array_equal(got["arrays"]["fab"], 3.0)
        ref_got = ref_elastic.resume_window(str(tmp_path))
        np.testing.assert_array_equal(ref_got["arrays"]["fab"], got["arrays"]["fab"])
    finally:
        fab.close()


def test_loadgen_fabric_kill_reroutes_exactly_with_concurrent_shards():
    from cekirdekler_tpu_torch.tools import loadgen

    log: list = []
    out = loadgen.run_fabric(ck.all_devices().cpus(1), fabric=2, clients=16, tenants=4,
                             signatures=2, requests_per_client=4, n=2048, kill=True,
                             gather_window_s=0.02, cycle_log=log)
    assert out["hangs"] == 0 and out["unnamed_failures"] == 0 and out["checked"] is True
    assert out["completed"] + out["failed"] + out["retries_exhausted"] == 64
    assert out["killed"] in out["members"] and out["killed_at_completed"] is not None
    assert {m for m, _t0, _t1 in log} <= set(out["members"]) and log
    assert loadgen.overlapping_cycles([("a", 0.0, 2.0), ("b", 1.0, 3.0), ("a", 2.5, 4.0),
                                       ("a", 5.0, 6.0)]) == 2


# -- the TCP path ------------------------------------------------------------------


def _reject(*a, **kw):
    raise ServeRejected("tenant-9", REJECT_SHARD, 0.125)


def test_tcp_propagates_typed_serve_rejection(monkeypatch):
    monkeypatch.setattr(server_mod, "NumberCruncher", _reject)
    server = CruncherServer(devices=ck.all_devices().cpus(1))
    try:
        client = CruncherClient(server.host, server.port)
        try:
            with pytest.raises(ServeRejected) as ei:
                client.setup(INC)
            assert ei.value.reason == REJECT_SHARD and ei.value.tenant == "tenant-9"
            assert ei.value.retry_after_s == 0.125
        finally:
            client.close()
    finally:
        server.stop()


def test_tcp_plain_errors_stay_untyped(monkeypatch):
    def _boom(*a, **kw):
        raise RuntimeError("kaboom")

    monkeypatch.setattr(server_mod, "NumberCruncher", _boom)
    server = CruncherServer(devices=ck.all_devices().cpus(1))
    try:
        client = CruncherClient(server.host, server.port)
        try:
            with pytest.raises(CekirdeklerError, match="remote error") as ei:
                client.setup(INC)
            assert not isinstance(ei.value, ServeRejected)
        finally:
            client.close()
    finally:
        server.stop()


def test_tcp_typed_rejection_crosses_the_packages(monkeypatch):
    """A reference server's rejection re-raises as the port's typed
    error, and a port server's as the reference's."""
    from cekirdekler_tpu.cluster import server as ref_server_mod

    monkeypatch.setattr(ref_server_mod, "NumberCruncher", lambda *a, **kw: (_ for _ in ()).throw(
        ref_serve.ServeRejected("tenant-r", "circuit-open", 0.5)))
    server = RefServer(devices=ref_platforms().cpus().subset(1))
    try:
        client = CruncherClient(server.host, server.port)
        try:
            with pytest.raises(ServeRejected) as ei:
                client.setup(INC)
            assert (ei.value.tenant, ei.value.reason, ei.value.retry_after_s) == \
                ("tenant-r", "circuit-open", 0.5)
        finally:
            client.close()
    finally:
        server.stop()
    monkeypatch.setattr(server_mod, "NumberCruncher", _reject)
    server = CruncherServer(devices=ck.all_devices().cpus(1))
    try:
        client = RefClient(server.host, server.port)
        try:
            with pytest.raises(ref_serve.ServeRejected) as ei:
                client.setup(INC)
            assert (ei.value.tenant, ei.value.reason) == ("tenant-9", REJECT_SHARD)
        finally:
            client.close()
    finally:
        server.stop()


# -- three worker processes, a seeded kill ---------------------------------------


def _spawn_worker(member, n=2048, local_range=64):
    return subprocess.Popen(
        [sys.executable, "-m", "cekirdekler_tpu_torch.tools.fabric_worker", member, str(n),
         str(local_range), "0", "4.0", "--cpu"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        cwd=ROOT)


def _readline(proc, timeout_s: float) -> str | None:
    """One line of a worker's output within ``timeout_s``; None on EOF or
    past the bound (the worker is then killed)."""
    box: list = []
    t = threading.Thread(target=lambda: box.append(proc.stdout.readline()), daemon=True)
    t.start()
    t.join(timeout_s)
    if not box:
        proc.kill()
        return None
    return box[0] or None


def _await_ready(proc, member, timeout_s=120.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        line = _readline(proc, max(0.1, deadline - time.monotonic()))
        if line is None:
            raise RuntimeError(f"worker {member} died before READY")
        if line.startswith("FABRIC_READY"):
            return
    raise RuntimeError(f"worker {member} never became READY")


def _rpc(proc, cmd, timeout_s: float = 60.0):
    """One JSON round trip; None on EOF (the killed member's signal)."""
    try:
        proc.stdin.write(json.dumps(cmd) + "\n")
        proc.stdin.flush()
    except (BrokenPipeError, OSError):
        return None
    line = _readline(proc, timeout_s)
    return None if line is None else json.loads(line)


def _kill_drill(seed: int, trace: bool):
    """The seeded kill drill over three workers; returns (work, acked,
    unacked, survivors, procs' reqtrace rows)."""
    from cekirdekler_tpu_torch.obs.reqtrace import REQTRACE

    members = ["m0", "m1", "m2"]
    n, sigs, rids_per_sig = 2048, 3, 4
    procs = {m: _spawn_worker(m, n=n) for m in members}
    membership = Membership()
    membership.establish({m: 1 for m in members})
    try:
        ready = [threading.Thread(target=_await_ready, args=(procs[m], m)) for m in members]
        for t in ready:
            t.start()
        for t in ready:
            t.join(timeout=150.0)
        for m in members:
            assert procs[m].poll() is None, f"worker {m} did not start"
        work = []  # (rid, trace rid, tenant, si, shard)
        rid = 0
        for si in range(sigs):
            key = f"cid{9100 + si}|lg_inc|{n}x64+0"
            for j in range(rids_per_sig):
                tenant = f"t{j % 2}"
                shard = route_decision(tenant, key, members,
                                       epoch=membership.snapshot()["epoch"])["shard"]
                work.append((rid, f"rkill-{rid:x}", tenant, si, shard))
                rid += 1
        by_shard = {m: [w for w in work if w[4] == m] for m in members}
        victim = random.Random(seed).choice(sorted(m for m in members if len(by_shard[m]) >= 2))
        survivors = [m for m in members if m != victim]
        for m in members:
            got = _rpc(procs[m], {"op": "warm", "sigs": sorted({w[3] for w in by_shard[m]})
                                  or [0]})
            assert got["op"] == "warmed" and got["device"] == "cpu"
        acked: dict = {}
        unacked: list = []
        failures: list = []

        def feed(m):
            for w in by_shard[m]:
                i, trid, tenant, si, _ = w
                cmd = {"op": "run", "rid": i, "tenant": tenant, "sig": si, "iters": 1}
                if trace:
                    cmd["trace_rid"] = trid
                reply = _rpc(procs[m], cmd)
                if reply is None:
                    (unacked.append(w) if m == victim else failures.append((m, i, "eof")))
                    continue
                if reply.get("op") != "done":
                    failures.append((m, i, reply))
                    continue
                acked[i] = m
                if m == victim and sum(v == victim for v in acked.values()) == 1:
                    procs[m].kill()  # SIGKILL after the victim's first ack

        feeders = [threading.Thread(target=feed, args=(m,)) for m in members]
        for t in feeders:
            t.start()
        for t in feeders:
            t.join(timeout=180.0)
        assert not any(t.is_alive() for t in feeders), "hung worker rpc"
        assert failures == [] and unacked, (failures, unacked)
        membership.leave(victim)
        epoch = membership.snapshot()["epoch"]
        for i, trid, tenant, si, _ in unacked:
            d = route_decision(tenant, f"cid{9100 + si}|lg_inc|{n}x64+0", survivors,
                               epoch=epoch)
            assert d["shard"] in survivors
            if trace:
                REQTRACE.event(trid, "diverted", tenant=tenant, owner=victim,
                               shard=d["shard"], hops=1)
                REQTRACE.event(trid, "rerouted", tenant=tenant, from_shard=victim,
                               to_shard=d["shard"], attempt=1)
            cmd = {"op": "run", "rid": i, "tenant": tenant, "sig": si, "iters": 1}
            if trace:
                cmd["trace_rid"] = trid
            reply = _rpc(procs[d["shard"]], cmd)
            assert reply is not None and reply["op"] == "done", reply
            acked[i] = d["shard"]
        for i, _trid, _tenant, _si, shard in work:
            if shard != victim:
                assert acked[i] == shard  # minimal reshuffle, observed
        assert sorted(acked) == [w[0] for w in work], "lost/dup rids"
        for m in survivors:
            applied: dict = {}
            for i, _trid, _tenant, si, _ in work:
                if acked[i] == m:
                    applied[si] = applied.get(si, 0) + 1
            for si, count in applied.items():
                v = _rpc(procs[m], {"op": "value", "sig": si})
                assert v["uniform"] and v["value"] == float(count), (m, si, v, count)
        rows = []
        if trace:
            for m in survivors:
                r = _rpc(procs[m], {"op": "reqtrace"})
                assert r is not None and r["op"] == "reqtrace"
                rows.append(r["events"])
        for m in survivors:
            assert _rpc(procs[m], {"op": "exit"}) == {"op": "bye"}
        return work, acked, unacked, survivors, rows
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=30.0)


def test_three_process_seeded_kill_and_reroute():
    work, acked, unacked, survivors, _ = _kill_drill(2017, trace=False)
    assert set(acked.values()) <= set(survivors) | {w[4] for w in work}
    assert all(acked[w[0]] in survivors for w in unacked)


def test_member_kill_rid_chain_survives_in_merged_cluster_trace():
    from cekirdekler_tpu_torch.obs.reqtrace import REQTRACE, fold_phases
    from cekirdekler_tpu_torch.trace.aggregate import ClusterSnapshot, merged_chrome_trace

    REQTRACE.enabled = True
    t_wall0 = time.time()
    work, acked, unacked, survivors, worker_rows = _kill_drill(4099, trace=True)
    parent_rows = [[e.t, e.rid, e.kind, e.fields] for e in REQTRACE.snapshot()
                   if e.t >= t_wall0 and e.rid.startswith("rkill-")]
    per_proc = [parent_rows] + worker_rows
    snap = ClusterSnapshot(offsets=[0.0] * len(per_proc), spans=[[] for _ in per_proc],
                           metrics=[{} for _ in per_proc], health=[{} for _ in per_proc],
                           serving=[{} for _ in per_proc], reqtrace=per_proc,
                           nproc=len(per_proc))
    trace = merged_chrome_trace(snap)
    req_slices = [e for e in trace["traceEvents"]
                  if e.get("cat") == "ck-req" and e.get("ph") == "X"]
    assert req_slices
    records = {r["rid"]: r for r in fold_phases([r for rows in per_proc for r in rows])}
    for _i, trid, _tenant, _si, _ in unacked:
        rec = records.get(trid)
        assert rec is not None and rec["outcome"] == "resolved", (trid, rec)
        kinds = iter(rec["kinds"])
        assert all(any(k == want for k in kinds) for want in ("diverted", "rerouted",
                                                               "resolved"))
        tids = {e["tid"] for e in req_slices if (e.get("args") or {}).get("rid") == trid}
        assert len(tids) == 1, (trid, tids)


def test_loadgen_fabric_mp_over_worker_processes():
    from cekirdekler_tpu_torch.tools import loadgen

    out = loadgen.run_fabric_mp(ck.all_devices().cpus(2), fabric=2, clients=8, tenants=2,
                                signatures=2, requests_per_client=2, n=2048)
    assert out["completed"] == 16 and out["failed"] == 0 and out["hangs"] == 0
    assert out["checked"] is True and set(out["devices"].values()) == {"cpu"}
    want = {f"t{ti}/s{si}": route_decision(f"t{ti}", f"cid{9100 + si}|lg_inc|2048x64+0",
                                           ["m0", "m1"])["shard"]
            for ti in range(2) for si in range(2)}
    assert out["placements"] == want
    assert LOADGEN_SRC.split() == _ref_tool("loadgen").LOADGEN_SRC.split()
