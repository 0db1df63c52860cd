"""The port's request-lifecycle tracing (``obs/reqtrace.py``) against the
reference's, on the same seeded event streams.

The pure folds (``fold_phases``, ``tail_anatomy``, ``phase_fracs``,
``tenant_percentiles``, ``slowest_requests``, ``request_chrome_events``,
``anatomy_table``, ``reqz_payload``) must give equal results; the
recorder keeps the reference's ring discipline.  No timing pin: the
reference's 1 µs append pin is rig timing (ROADMAP Queue C, reference
state 3).
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from cekirdekler_tpu.obs import reqtrace as ref
from cekirdekler_tpu_torch import obs
from cekirdekler_tpu_torch.obs import reqtrace as rt

SEEDS = range(8)

# the chains a serving tier records: admission, queueing, batching, the
# device, and the terminal event; some hop (failed, rerouted) and continue
CHAINS = (
    ("admitted", "queued", "coalesce-wait", "dispatched", "device", "resolved"),
    ("admitted", "queued", "dispatched", "device", "resolved"),
    ("admitted", "queued", "coalesce-wait", "warm-compile", "dispatched", "device", "failed"),
    ("admitted", "queued", "dispatched", "contained", "retry-backoff", "dispatched", "device",
     "resolved"),
    ("admitted", "diverted", "queued", "dispatched", "failed", "rerouted", "queued",
     "dispatched", "device", "resolved"),
    ("admitted", "queued", "coalesce-wait"),   # still in flight
)


def events(seed: int, n: int = 40) -> list[tuple]:
    """A seeded stream of ``(t, rid, kind, fields)`` over ``n`` requests of
    three tenants, interleaved in time."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        chain = CHAINS[int(rng.integers(len(CHAINS)))]
        t = 1.7e9 + float(rng.uniform(0, 0.5))
        tenant = ("a", "b", "c")[int(rng.integers(3))]
        for j, kind in enumerate(chain):
            fields: dict = {}
            if j == 0:
                fields = {"tenant": tenant, "wait_s": float(rng.uniform(0, 2e-3))}
            if kind in ("resolved", "failed") and rng.random() < 0.7:
                fields["latency_s"] = float(rng.uniform(1e-3, 5e-2))
            out.append((t, f"r{seed:x}-{k:x}", kind, fields))
            t += float(rng.exponential(2e-3))
    order = rng.permutation(len(out))
    return [out[i] for i in order]


def as_dicts(evs) -> list[dict]:
    return [{"t": t, "rid": rid, "kind": kind, "fields": f} for t, rid, kind, f in evs]


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_phases_is_the_reference_s(seed):
    evs = events(seed)
    assert rt.fold_phases(evs) == ref.fold_phases(evs)
    # the wire forms fold alike: dicts and ReqEvent rows
    assert rt.fold_phases(as_dicts(evs)) == ref.fold_phases(as_dicts(evs))
    assert rt.fold_phases([rt.ReqEvent(*e) for e in evs]) == ref.fold_phases(evs)


@pytest.mark.parametrize("seed", SEEDS)
def test_tail_anatomy_and_phase_fracs_are_the_reference_s(seed):
    recs = rt.fold_phases(events(seed))
    for pcts in ((50, 95, 99), (50, 99.9), (10,)):
        assert rt.tail_anatomy(recs, pcts) == ref.tail_anatomy(recs, pcts)
    for r in recs:
        assert rt.phase_fracs(r) == ref.phase_fracs(r)
    assert rt.phase_fracs(None) == ref.phase_fracs(None) == {"queue_frac": 0.0,
                                                             "device_frac": 0.0}
    assert rt.tenant_percentiles(recs) == ref.tenant_percentiles(recs)
    assert rt.slowest_requests(recs, 5) == ref.slowest_requests(recs, 5)
    an = rt.tail_anatomy(recs)
    assert rt.anatomy_table(an) == ref.anatomy_table(an)


@pytest.mark.parametrize("seed", SEEDS)
def test_request_chrome_events_are_the_reference_s(seed):
    evs = events(seed)
    mine = rt.request_chrome_events(evs)
    assert mine == ref.request_chrome_events(evs)
    assert rt.request_chrome_events(evs, t_base=1.7e9, pid=7, process_name="x") == \
        ref.request_chrome_events(evs, t_base=1.7e9, pid=7, process_name="x")
    json.dumps(mine, allow_nan=False)
    assert all(e["cat"] == "ck-req" for e in mine if e["ph"] == "X")


@pytest.mark.parametrize("seed", SEEDS)
def test_reqz_payload_is_the_reference_s(seed):
    evs = events(seed)
    assert rt.reqz_payload(evs, n_slow=4, n_recent=7) == \
        ref.reqz_payload(evs, n_slow=4, n_recent=7)
    assert rt.reqz_payload([]) == ref.reqz_payload([])


def test_empty_inputs_match():
    assert rt.fold_phases([]) == ref.fold_phases([]) == []
    assert rt.tail_anatomy([]) == ref.tail_anatomy([])
    assert rt.request_chrome_events([]) == ref.request_chrome_events([]) == []
    assert rt.anatomy_table({}) == ref.anatomy_table({})


def test_vocabulary_is_the_reference_s():
    assert rt.REQ_EVENT_KINDS == ref.REQ_EVENT_KINDS
    assert rt.TERMINAL_KINDS == ref.TERMINAL_KINDS
    assert rt.QUEUE_PHASES == ref.QUEUE_PHASES
    assert obs.REQTRACE is rt.REQTRACE and obs.fold_phases is rt.fold_phases


def test_recorder_ring_evicts_oldest_and_gates_on_enabled():
    tr = rt.ReqTrace(capacity=16)
    for k in range(40):
        tr.event(f"r{k}", "admitted", tenant="a")
    snap = tr.snapshot()
    assert tr.capacity == 16 and len(snap) == 16 and tr.total_recorded == 40
    assert [e.rid for e in snap] == [f"r{k}" for k in range(24, 40)]
    tr.enabled = False
    tr.event("late", "queued")
    assert tr.total_recorded == 40 and tr.snapshot()[-1].rid == "r39"
    tr.clear()
    assert tr.snapshot() == [] and tr.total_recorded == 0
    assert rt.ReqTrace(capacity=1).capacity == 16     # the reference's floor


def test_mint_is_unique_and_pid_stamped():
    import os

    tr = rt.ReqTrace()
    ids = [tr.mint() for _ in range(100)]
    assert len(set(ids)) == 100
    assert all(i.startswith(f"r{os.getpid():x}-") for i in ids)


def test_recorded_chain_folds_through_both_packages():
    tr = rt.ReqTrace()
    rid = tr.mint()
    tr.event(rid, "admitted", tenant="t", wait_s=0.001)
    tr.event(rid, "queued")
    tr.event(rid, "device")
    tr.event(rid, "resolved", latency_s=0.5)
    snap = tr.snapshot()
    (rec,) = rt.fold_phases(snap)
    assert rt.fold_phases(snap) == ref.fold_phases([tuple(e) for e in snap])
    assert rec["outcome"] == "resolved" and rec["wall_s"] == 0.5 and rec["tenant"] == "t"
    assert rec["kinds"] == ["admitted", "queued", "device", "resolved"]
